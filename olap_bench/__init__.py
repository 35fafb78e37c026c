"""The benchmark of pinot_tpu_torch: OLAP deployments from public benchmarks
(TPC-H) served by one QueryEngine on one card, under closed-loop
dashboard traffic. `olap_bench/README.md` says how to run it and how to add a
configuration, a traffic mix, a metric or a cell."""
