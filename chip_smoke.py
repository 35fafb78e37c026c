#!/usr/bin/env python3
"""Card check of pinot_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py        # from the root of the repository

1. Card: prints the card's name and power limit, builds every CUDA kernel of
   the package from the sources in the checkout (nvcc, sm_90a, one process
   per source, all started together).
2. Kernels: holds each kernel against its plain torch version on the card,
   at the main path's shapes and at edge cases, and times kernel, plain
   version and the PyTorch library call beside the bound. Kernels:
   grouped_sum_count (exact int sums + counts), grouped_sum_count_2l (the
   same function for large group counts, two-level gid; timed beside
   grouped_sum_count's global-atomics branch, with its passes and L),
   grouped_extreme (MIN/MAX of f32, i32 and f64 values) and grouped_sum_f32
   (f32 sums / counts, and the DISTINCTCOUNT presence flags of one or many
   id columns a launch). Tolerance: exact equality (== , NaN equal to NaN)
   for everything but f32 sums, which add in a run-dependent order and are
   held to rtol 1e-4, atol 1e-2. Two choices of the wrappers are timed on
   both sides: `dispatch_band`, the flat against the two-level exact
   group-by where grouped_multi_sum switches between them, and
   `extreme_finish`, grouped_extreme's finish folded into its last block
   against a separate finish kernel.
3. New device steps: the torch steps of this slice's path that no
   hand-written kernel carries (DISTINCTCOUNTHLL's register update, scalar
   and grouped; SELECTION's first-k compaction; SELECTION ORDER BY's stable
   top-k), each at its main-path shape, held exactly against the same step
   on the CPU and timed beside its bytes bound and a one-call PyTorch
   alternative.
4. Main path: generates the SSB-flavoured lineorder (8M rows, seed 0, the
   generator of bench.py, then lo_custkey and lo_suppkey), builds 2 segments
   of 4M rows with the package's SegmentBuilder, stages them on the card and
   runs configs 1-9 and 11-13 (BASELINE 1-4, grouped MIN/MAX, grouped and
   scalar DISTINCTCOUNT, a 90k-group GROUP BY, a sparse customer x supplier
   GROUP BY, SELECTION ORDER BY, DISTINCT ORDER BY, SELECTION) through
   QueryEngine(..., device="cuda").execute; and config 10, BASELINE config 5
   (bench.py's `events` table, 2M rows in one segment with a star tree on
   (country, device): a star-tree GROUP BY and a DISTINCTCOUNTHLL, both
   submitted before either resolves). Every result row is held against a
   numpy oracle over the raw arrays, config 10's registers against
   np_hll_registers; the kernels' launch counters are reset just before
   that run and read just after, per config.
5. Host executor: configs 14-16 run queries the package answers on its host
   executor (numpy), where the reference does: 14, GROUP BY the raw metric
   lo_quantity; 15, PERCENTILE / MODE / STDDEV_POP, which have no device
   lowering; 16, a GROUP BY with DISTINCTCOUNT(lo_custkey) over the two
   4M-row segments plus a fifth, realtime-sized one of 10,000 rows: the
   large segments' presence matrix passes the device budget and they go to
   the host, the small one runs on the card (one grouped_sum_count and one
   presence launch), and one reduce merges both kinds of partial. Each is
   held against a numpy oracle; the engine's count of segments by executor
   is asserted (2 host for 14 and 15; 2 host and 1 device for 16).
6. Spec tags and null handling: configs 17-20 run over the same 8M rows
   through the same engine: 17, FILTER (WHERE) (four distinct masks a
   segment: four grouped_sum_count launches, one grouped_extreme launch);
   18, CASE, IN over a raw column, a column compare and SQRT; 19,
   PERCENTILEEST grouped (histograms of ng 256 x 4096 cells: the two-level
   kernel) and scalar (4096 cells: the flat one); 20, FUNNELCOUNT (one
   presence launch a step). Config 21 builds the same rows into 2 more
   segments with null vectors (lo_supplycost null on a seeded 3% of the rows
   and on every row of 1998) and runs a Kleene WHERE with null-handling
   SUM / COUNT / MIN / AVG by year (1998's SUM, MIN and AVG are NULL) and an
   IS NULL count, every segment on the device. Each is held against a numpy
   oracle, with its launches a segment asserted; `new_device_steps_tags`
   times the histogram binning, the IN probe, the CASE fold and YEAR over
   4M docs, each held exactly against the same step on the CPU; the
   two-level kernel is held against its plain version at the histogram
   shapes (k = 0, ng 2^20 and 2^22) before the main path relies on them.
7. Multi-value columns: configs 22-27 run over `mvt`, 8M rows (seed 22)
   in 8 segments of 1M rows that enter the package through
   segment_from_numpy: SV year, region, revenue; MV tags (0-4 values a doc,
   Zipf s = 1 over 1,000 strings) and nums (0-4 values a doc over [0,
   100)). 22, MV any-match: a tag search, an exclusion (NOT IN), and
   `nums > 95 AND nums < 3` (non-zero: the optimizer must not merge the two
   ranges of an MV column); 23, the *MV aggregations and DISTINCTCOUNTMV
   (one presence launch a segment); 24, the *MV aggregations by year (B1
   and B3 over nums' value space); 25, GROUP BY tags (groups_mv, doc-space
   values gathered to the values) and DISTINCT tags; 26, GROUP BY tags,
   nums (groups_mv2, ~8M pairs a segment, ng 100,096: the two-level
   kernel); 27, three shapes the reference also answers on its host (a
   ragged selection, DISTINCTCOUNTMV by year, SUMMV under an MV key), every
   segment on the host executor. Each is held against a numpy oracle over
   the raw flat arrays, with its launches a segment and its segments by
   executor asserted; `new_device_steps_mv` times mv_any's scatter-OR, the
   value-space gather and groups_mv2's pair expansion over one segment; B1
   and B2 are held against their plain versions at configs 25's and 26's
   value-space shapes (and B1 at 2^23 pairs) in the kernel phase.
8. The rest of the single-stage engine: configs 28-31 over the same 8M
   lineorder rows stably sorted by d_year, in 16 segments of 500,000 rows (time
   partitioned: d_year sorted in every segment). 28a-c, queries the
   min/max pruner decides (one year: 13 segments pruned; two years; a year
   with no data, with and without enableNullHandling); 29, GAPFILL over a
   yearly series (`<>`: nothing pruned); 30a-b, the same segments as an
   upsert table keyed by lo_custkey (the last row of each key valid,
   90,000 of 8M), run again after 1% of the valid flags move to earlier
   docs in place; 31, EXPLAIN PLAN FOR and EXPLAIN ANALYZE of 28a, then 8
   queries through FCFSScheduler and PriorityScheduler (2 runners, 4 client
   threads) beside the same 8 run serially. Rows against numpy oracles, the
   pruned counts against the numpy count from each segment's [min, max],
   the first query's staged segments against the unpruned ones, and, over
   configs 28-30, the kernel registry's calls against the launch counters
   (every roofline row at most 100% of the peak). `kernel_registry_cost`
   times 28a with the registry on and off; `kernel_obs` gives, per kernel,
   the registry's CUDA-event ms a call beside the kernel's device-alone time
   at the same operands.

9. The sharded table and executor (bench.py's timed path): the same 8M
   rows as one sharded table (build_sharded_table, rows_per_segment = n / 4
   as bench.py on one device: S = 4 stacked segments), bench.py's Q4,
   config 1's COUNT, Q2 and config 3's Q1 and configs 5-9 through
   execute_sharded_result, each against the oracle, with its launches a query
   (each kernel once over the flat 8M-doc vector: LAUNCHES_PER_SEGMENT's
   one-segment tuple; counts from 0 just before the path, read just after)
   and exactly one device->host copy and no read of a device scalar (counted
   op by op under a TorchDispatchMode). Per query: the wall
   p50 beside the per-segment engine's, the program's device time alone
   (CUDA events) and the idle share it leaves of the wall,
   the `exchange.sharded` CUDA-event span beside the bound of the true bytes
   (every read column over S x P docs). `sharded_kernels` holds B1-B4 against
   their plain versions at the operands of their first flat launch and times
   both there. The proto fallback: a GROUP BY over two MV keys on a 1M-row MV
   sharded table and config 9 with MAX_DENSE_GROUPS cut to 2^16 (the sparse
   slots overflow) both rerun on the proto, equal the oracle, with the
   proto's staged bytes; each rerun's launches are counted from 0 just
   before it and read just after (FALLBACK_LAUNCHES), and every kernel call
   it made is held against its plain version on the same operands.
   `sharded_scale_path` is bench.py's scale block at 16M rows where bench.py
   has 60M (seed 7, bench.py's six columns), S = 4, Q4 and Q2 against the
   oracle, with their launches counted from 0 just before and read just
   after (Q4's one flat launch over n = S x P docs, Q2's none), and each
   kernel call held against its plain version and timed there;
   `sharded_scale` gives its build seconds, staged bytes, p50 and rows per
   second.
10. The segment store, loader and indexes: the 2 lineorder segments written
   (default codec, lz4) and loaded back, configs 3-4 from the loaded segments
   equal to the in-memory engine's rows; configs 28-30's 16 segments with a
   bloom filter on lo_custkey and an inverted index on c_nation (the index
   SPI), a point lookup on the key held by the fewest segments against the
   oracle, its bloom-pruned count beside the min/max-pruned count; a
   200,000-row text / JSON table answering TEXT_MATCH and JSON_MATCH through
   the program's docmask operand on the card, against the numpy oracle.
11. The mesh of slots: the same 8M rows over make_mesh(("cuda:0",) * 4),
   D = 4 slots on the card, one segment each (S = 4, P = 2,000,896); phase
   9's configs through execute_sharded_result, each equal to the oracle and
   to the one-slot table's rows, with its launches (4x the one-slot count;
   counts from 0 just before the path, read just after), one device->host
   copy a query (config 9: one a slot) and no cross-card copy; its wall p50
   beside the one-slot table's in the same phase, the mesh program's device
   time and each slot's.
12. The hash exchange: mesh_equi_join over the 4 slots, 4,000,000 left keys
   from [1, 90,000] against the 90,000 right keys once each, the pairs
   equal to numpy's; the declines (a duplicate right key, the sentinel key);
   a forced overflow completed by the retry; hash_exchange delivering every
   row once to its key's slot; exchange_group_partials equal to the sum;
   the `exchange.join` event ms beside its bound.
13. The multistage engine: bench.py's config 6 (4M fact rows of its
   generator, seed 6; the 25-row nation_dim; its SQL) through
   MultistageEngine(..., device="cuda"), its ordered rows equal to the
   oracle, the exact group-by kernel launched at the leaf; then over the
   same rows a query each engaging the device join and sort, the device
   window, and the leaf's `mask` program (DEVICE_OP_STATS, a spy on the
   program kinds), each against its oracle; walls, link_profile(), the
   operators' host split and the numpy paths' host cost per row beside the
   economic gates' constants.
14. The cluster in process: the 8M rows in 16 segments of 500,000 uploaded
   through Controller.upload_segment (deep store, then each replica's
   server loads its own copy) to 4 Servers on the card with replication 2;
   configs 1-9 and bench.py config 6's multistage join through
   Broker(controller) with its defaults, each equal to the oracle, with its
   launches (LAUNCHES_PER_SEGMENT x 16: one replica answers each segment)
   and every kernel call held against its plain version; walls through the
   default broker (result-cache hits), an uncached broker (split into
   route, scatter and reduce) and one QueryEngine over the 16 segments.
15. The cluster over HTTP: the same servers behind ServerHTTPService, a
   second controller registering them as RemoteServerClients, its broker
   behind BrokerHTTPService queried by query_broker_http; configs 1-9 with
   the same checks (and the kernel registry's calls, what a server process
   serves at /debug/roofline, equal to the launch counters), the DataTable
   bytes received, the HTTP wall beside the in-process one, and config 13's
   plain SELECTION streamed with early stop.
16. bench.py `qps`: its fixture (2 servers, 4 segments, replication 2, its
   two queries) at 8M rows, 128 HTTP clients x 5 queries, once with the
   default result cache and once with it off: throughput, client and
   broker-histogram p50 / p99, error rate 0, wire-pool hits > 0, admission
   decisions and B1 launches (with the cache off, 4 a GROUP BY answer).
17. Distributed multistage stages: bench.py's config 6 at phase 13's size
   (4M rows, seed 6) in 4 segments on 4 Servers on the card, each behind
   its ServerHTTPService and registered as a RemoteServerClient, so the
   broker dispatches the stages to the servers and runs the root on its own
   device (the card), every stage-to-stage block crossing a socket through
   /mailbox; config 6, phase 13's lookup join + ORDER BY and a join whose
   80K-row ORDER BY runs in the root stage, each equal to the oracle, their
   launches (counts from 0 just before, read just after) equal to the
   in-process route's on the same segments (config 6: one B1 a segment in
   the servers' leaf workers), every leaf kernel call held against its plain
   version (max_abs_err 0), and the multistage device operators each route
   ran (sort, join, window) the same on both, all on the card; each route's
   wall p50, envelopes and bytes.
18. The cluster as OS processes (run after phase 15, on its deep store): a
   controller, 4 servers on the card and a broker, each a
   `python -m pinot_tpu_torch.tools.admin Start...` process spawned with
   subprocess.Popen; the 16 segments uploaded through the REST tarball path
   with replication 2, nation_dim as a dimension table; configs 1-9 and
   config 6's join (distributed stages in the server processes) through
   client.connect, each equal to the oracle with its launches summed from
   the servers' /debug/roofline calls (16x a segment's, config 6's leaf 16
   B1); a lookUp group-by (host executor, no launch), a Basic-auth broker's
   403 and 200, a /debug/pprof capture of the broker process; start-up
   seconds, upload seconds, walls beside phase 15's, each server's device
   memory. Every child is killed at the end of the phase.
19. Realtime ingestion (`realtime`, after the cluster phases freed their
   segments): one Controller, Servers on the card and an uncached Broker in
   process. lineorder_rt: 700,000 rows (seed 0) and an arrival ts produced into
   an InMemoryStream of 4 partitions (lo_custkey % 4), consumed at 100,000
   rows a segment (4 committed + 4 consuming); configs 1-7, each equal to
   the oracle with its launches (8x a segment's) and every kernel call
   held against its plain version; ingest rows/s, each commit's seal +
   build, upload and load seconds, walls. A live step: a producer at 50,000
   rows/s for 10 s while configs 1 and 4 loop, each answer between the
   oracles at the watermarks read around it; freshness p50 / p99, each
   consuming generation's snapshot ms and staged bytes, the allocator's
   bytes (replaced generations freed without a collector pass). The same
   rows as a FULL upsert table keyed by lo_custkey (1% late rows lose):
   COUNT 89,966 (its distinct keys), SUM by c_nation (B1 under the validity docmask), the latest
   revenue a key (B2); a restarted manager resumes at the committed offsets
   with the same validity and rows. Two replicas sharing a
   SegmentCompletionManager (exactly one committer a segment), and a dedup
   table.
20. The control plane (`control_plane`, last): bench.py `cluster`'s
   topology as `tools.admin` processes (two HA controllers on one store
   dir, each with the metrics aggregator and the integrity scrubber;
   servers on the card with local data dirs; two uncached brokers) over
   its table (5 segments of 200,000 rows, seed 12, replication 2). Under
   load from 8 clients: a bootstrap rebalance onto a third server; a split
   brain (the lease.renew fault freezes the lead, the standby takes over at
   a higher epoch, the frozen ex-leader's write is fenced with 503 / 270);
   the lead SIGKILLed mid-rebalance; a bit flipped in a local and a
   deep-store copy (both repaired, one quarantined); the lead's
   /debug/cluster (roofline against 3,350 GB/s) and /debug/alerts; a broker
   SIGKILLed under client Connections; every process SIGKILLed and the
   cluster restarted cold. No query dropped or untyped; quiesced answers
   equal the oracle with 5 B1 a GROUP BY and none a COUNT, from the server
   processes' registries. Then a seeded compatibility suite in process on
   the card, its kernel calls held against their plain versions.
21. Batch ingestion and a minion rollup (`batch_minion`): 2M rows of
   bench.py's lineorder (seed 17, its six columns) written as 8 files of
   250,000 rows (6 CSV, 2 JSON-lines) in two directories; one Controller
   behind a ControllerHTTPService with a PinotTaskManager, two Servers on
   the card and an uncached Broker in process. `admin ImportData` loads the
   first directory (the standalone runner, then REST tarball pushes),
   `admin LaunchDistributedDataIngestionJob` the second (2 worker processes
   that tar-push over REST; none may load torch). Configs 1-4 over the 8
   segments and a GROUP BY d_year, c_nation with SUM, MIN and MAX, each
   equal to the oracle with its launches (from the counters and the kernel
   registry) and every kernel call held against its plain version. Then a
   MergeRollupTask (ROLLUP: SUM lo_revenue, MIN lo_supplycost, MAX
   lo_quantity) scheduled with `admin ScheduleTasks` and run by a minion
   thread: one segment of 4,375 rows equal to the oracle's rollup in sorted
   order, the GROUP BY equal to its answer before the merge with one B1 and
   one B3, COUNT(*) 4,375. Last, `admin QuickStart` with its defaults: its
   sample query against numpy over its segments. Write and read rates a
   format, build and push seconds a segment, each job's seconds, the
   merge's seconds, wall p50s, the phase's seconds against its 60 s budget.
22. The time-series engine, the DataFrame connector and the native host
   library (`timeseries_connector`, last): a metrics table of 1,000 hosts
   (dc = host % 4) reporting a counter every 10 s for 6 h (2,160,000 rows,
   seed 18) written with connectors.write_table through a
   RemoteControllerClient into 4 segments of 90 minutes on two Servers on
   the card (each behind ServerHTTPService), then read back through the
   deep store (read_table: every row equal to the data; with a pushed-down
   `where` 3 of the 4 segments pruned and the rows equal to the numpy
   mask's) and through the servers over HTTP (read_table_via_servers: the
   same rows as a multiset). A GROUP BY dc with SUM, COUNT, MIN and MAX
   through a Basic-auth broker equals the oracle with one B1 and one B3 a
   segment, every kernel call held against its plain version. Six
   time-series queries (m3ql and PromQL) through POST
   /timeseries/api/v1/query_range, each body equal to the in-process
   TimeSeriesEngine over the same servers, three equal to a numpy oracle,
   every leaf segment on the servers' host executor with no kernel launch;
   a principal without the table gets 403. Every function of the native
   host library bit-equal to its numpy fallback over the table's arrays;
   the kernel wrappers' plan caches' meters (engine.kernelCache.*) against
   the lookups the phase made.

Every phase that fails raises, and the script exits non-zero. The last line
of standard output is {"ok": true, "device": {...}}; the line before it is a
JSON object with one entry per kernel.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

N_ROWS = 8_000_000
N_SEGMENTS = 2
#: timed runs behind each wall p50 (after its warm-ups)
WALL_RUNS = 3
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
L2_FLUSH_BYTES = 128 << 20  # > the 50 MB L2

NATIONS = [f"NATION_{i:02d}" for i in range(25)]
CATEGORIES = [f"MFGR#{i // 10 + 1}{i % 10 + 1}" for i in range(25)]

# BASELINE configs 1-4, the SQL texts of bench.py
CONFIGS = {
    "1_count_filter": "SELECT COUNT(*) FROM lineorder WHERE c_nation = 'NATION_07'",
    "2_filtered_agg": (
        "SELECT SUM(lo_revenue), MIN(lo_quantity), MAX(lo_revenue), AVG(lo_supplycost) "
        "FROM lineorder WHERE d_year BETWEEN 1994 AND 1996 AND c_nation = 'NATION_03'"
    ),
    "3_q1_groupby": (
        "SELECT d_year, SUM(lo_revenue) FROM lineorder "
        "WHERE (c_nation = 'NATION_01' OR c_nation = 'NATION_02') AND lo_quantity < 25 "
        "GROUP BY d_year ORDER BY d_year LIMIT 20"
    ),
    "4_q4_groupby_orderby": (
        "SELECT d_year, c_nation, p_category, SUM(lo_revenue - lo_supplycost) "
        "FROM lineorder WHERE lo_quantity > 5 AND d_year BETWEEN 1993 AND 1997 "
        "GROUP BY d_year, c_nation, p_category ORDER BY SUM(lo_revenue - lo_supplycost) DESC LIMIT 10"
    ),
}
CONFIGS.update(
    {
        "5_groupby_minmax": (
            "SELECT d_year, c_nation, COUNT(*), MIN(lo_quantity), MAX(lo_revenue), MINMAXRANGE(lo_supplycost), "
            "MAX(lo_revenue / lo_quantity) FROM lineorder WHERE lo_quantity > 5 AND d_year BETWEEN 1993 AND 1997 "
            "GROUP BY d_year, c_nation ORDER BY d_year, c_nation LIMIT 200"
        ),
        "6_groupby_distinct": (
            "SELECT d_year, p_category, COUNT(*), DISTINCTCOUNT(c_nation) FROM lineorder "
            "WHERE lo_quantity = 1 AND lo_revenue < 20000 "
            "GROUP BY d_year, p_category ORDER BY d_year, p_category LIMIT 200"
        ),
        "7_distinct": (
            "SELECT COUNT(DISTINCT c_nation), DISTINCTCOUNT(p_category), MIN(lo_revenue) FROM lineorder "
            "WHERE lo_quantity = 1 AND lo_revenue < 20000"
        ),
        # "top customers": 90,000 customers (ng 90,112), past the flat
        # kernel's shared counters
        "8_groupby_wide": (
            "SELECT lo_custkey, SUM(lo_revenue), COUNT(*) FROM lineorder WHERE d_year BETWEEN 1993 AND 1997 "
            "GROUP BY lo_custkey ORDER BY SUM(lo_revenue) DESC, lo_custkey LIMIT 10"
        ),
        # "top customer-supplier pairs": a key product of 5.4e8 > 2^20, the
        # sort-compaction path into U = 2^20 slots
        "9_groupby_sparse": (
            "SELECT lo_custkey, lo_suppkey, SUM(lo_revenue), COUNT(*) FROM lineorder "
            "WHERE d_year = 1997 AND lo_quantity <= 5 GROUP BY lo_custkey, lo_suppkey "
            "ORDER BY SUM(lo_revenue) DESC, lo_custkey, lo_suppkey LIMIT 10"
        ),
    }
)
CONFIGS.update(
    {
        # "top rows by revenue": ~2.3M rows pass, ~4 a revenue value, so the
        # top 20 tie across segments and within them
        "11_selection_orderby": (
            "SELECT lo_custkey, c_nation, lo_revenue FROM lineorder WHERE d_year = 1995 "
            "ORDER BY lo_revenue DESC LIMIT 20"
        ),
        "12_distinct_orderby": (
            "SELECT DISTINCT d_year, c_nation FROM lineorder WHERE lo_quantity < 3 "
            "ORDER BY d_year DESC, c_nation LIMIT 50"
        ),
        "13_selection": "SELECT d_year, p_category, lo_quantity FROM lineorder WHERE c_nation = 'NATION_07' LIMIT 10",
    }
)
#: BASELINE config 5 (bench.py's _bench_config5): its two queries, over the
#: `events` table
EVENTS_ROWS = 2_000_000
CONFIG_10 = {
    "10_star": "SELECT country, SUM(impressions) FROM events GROUP BY country ORDER BY SUM(impressions) DESC LIMIT 5",
    "10_hll": "SELECT DISTINCTCOUNTHLL(user_id) FROM events",
}
#: kernel launches per segment of each config: (grouped_sum_count,
#: grouped_extremes, presence, grouped_sum_count_2l)
LAUNCHES_PER_SEGMENT = {
    "1_count_filter": (0, 0, 0, 0),
    "2_filtered_agg": (0, 0, 0, 0),
    "3_q1_groupby": (1, 0, 0, 0),
    "4_q4_groupby_orderby": (1, 0, 0, 0),
    "5_groupby_minmax": (1, 1, 0, 0),  # MIN, MAX, MINMAXRANGE of int32 and MAX of float64: one launch
    "6_groupby_distinct": (1, 0, 1, 0),
    "7_distinct": (0, 0, 1, 0),  # both DISTINCTCOUNTs in one presence launch
    "8_groupby_wide": (0, 0, 0, 1),
    "9_groupby_sparse": (0, 0, 0, 1),
    # config 10's one segment: the star GROUP BY's counts over the star
    # table (its SUM is of a DOUBLE pre-agg column: index_add_); the HLL
    # update is torch
    "10_star_and_hll": (1, 0, 0, 0),
    "11_selection_orderby": (0, 0, 0, 0),  # top-k: torch
    "12_distinct_orderby": (1, 0, 0, 0),  # DISTINCT: a group-by's counts
    "13_selection": (0, 0, 0, 0),  # first-k: torch
}
#: configs the host executor answers, where the reference answers them on
#: its host: GROUP BY a raw metric, host-only aggregations, and a query whose
#: segments split between the host and the card
HOST_CONFIGS = {
    # "order-size mix": lo_quantity is a raw metric, so every segment groups
    # on the host (~2.3M rows pass)
    "14_groupby_raw_metric": (
        "SELECT lo_quantity, COUNT(*), SUM(lo_revenue), AVG(lo_supplycost) FROM lineorder WHERE d_year = 1995 "
        "GROUP BY lo_quantity ORDER BY lo_quantity LIMIT 50"
    ),
    # "yearly revenue percentiles": aggregations with no device lowering
    "15_host_aggregations": (
        "SELECT d_year, PERCENTILE(lo_revenue, 95), MODE(lo_quantity), STDDEV_POP(lo_supplycost), COUNT(*) "
        "FROM lineorder WHERE c_nation = 'NATION_03' GROUP BY d_year ORDER BY d_year LIMIT 10"
    ),
    # "distinct buyers per market, with a consuming segment": ng 768 x the
    # lo_custkey pad passes MAX_PRESENCE_CELLS in a 4M-row segment (pad
    # 131,072), not in the 10,000-row one (pad 16,384)
    "16_mixed_executors": (
        "SELECT c_nation, p_category, COUNT(*), DISTINCTCOUNT(lo_custkey) FROM lineorder WHERE d_year = 1997 "
        "GROUP BY c_nation, p_category ORDER BY DISTINCTCOUNT(lo_custkey) DESC, c_nation, p_category LIMIT 20"
    ),
}
#: config 16's fifth segment: a realtime table's small consuming segment
SMALL_ROWS = 10_000
#: launches of each host config in all, and its segments by executor
HOST_LAUNCHES = {
    "14_groupby_raw_metric": (0, 0, 0, 0),
    "15_host_aggregations": (0, 0, 0, 0),
    "16_mixed_executors": (1, 0, 1, 0),  # the small segment's COUNT and presence
}
HOST_MODES = {
    "14_groupby_raw_metric": {"host": N_SEGMENTS},
    "15_host_aggregations": {"host": N_SEGMENTS},
    "16_mixed_executors": {"host": N_SEGMENTS, "device": 1},
}
#: the single-value spec tags (configs 17-20, over the same 8M rows)
TAG_CONFIGS = {
    # "year-over-year revenue by nation": FILTER (WHERE), four distinct masks
    "17_filter_where": (
        "SELECT c_nation, SUM(lo_revenue) FILTER (WHERE d_year = 1997), SUM(lo_revenue) FILTER (WHERE d_year = 1996), "
        "COUNT(*) FILTER (WHERE lo_quantity > 40), MAX(lo_supplycost) FILTER (WHERE d_year = 1997), COUNT(*) "
        "FROM lineorder GROUP BY c_nation ORDER BY c_nation LIMIT 25"
    ),
    # "banded revenue": CASE, IN over a raw column, a column compare, a transform
    "18_case_in_cmp_fn": (
        "SELECT d_year, SUM(CASE WHEN lo_quantity <= 10 THEN lo_revenue WHEN lo_quantity <= 30 THEN lo_revenue / 2 "
        "ELSE 0 END), MAX(SQRT(lo_supplycost)), COUNT(*) FROM lineorder "
        "WHERE lo_quantity IN (1, 5, 10, 20, 30, 40, 50) AND lo_revenue > lo_supplycost * 3 "
        "GROUP BY d_year ORDER BY d_year LIMIT 10"
    ),
    # "revenue distribution by year": PERCENTILEEST, grouped (ng 256 x 4096
    # histogram cells: the two-level kernel) and scalar (4096: the flat one)
    "19_percentileest": (
        "SELECT d_year, PERCENTILEEST(lo_revenue, 90), PERCENTILEEST(lo_supplycost, 50) FROM lineorder "
        "WHERE c_nation = 'NATION_05' GROUP BY d_year ORDER BY d_year LIMIT 10"
    ),
    "19_percentileest_scalar": (
        "SELECT PERCENTILEEST(lo_revenue, 90), PERCENTILEEST(lo_supplycost, 50) FROM lineorder "
        "WHERE c_nation = 'NATION_05'"
    ),
    # "repeat buyers": FUNNELCOUNT, one presence launch a step
    "20_funnelcount": (
        "SELECT FUNNELCOUNT(STEPS(d_year = 1995, d_year = 1996, d_year = 1997), CORRELATE_BY(lo_custkey)) "
        "FROM lineorder WHERE c_nation = 'NATION_11'"
    ),
}
#: config 21, "cost completeness": the same rows in 2 more segments with
#: null vectors, lo_supplycost null on a seeded 3% of the rows and on every
#: row of 1998, queried under enableNullHandling
NULL_CONFIGS = {
    "21_null_kleene": (
        "SET enableNullHandling = true; SELECT d_year, SUM(lo_supplycost), COUNT(lo_supplycost), "
        "MIN(lo_supplycost), AVG(lo_supplycost), COUNT(*) FROM lineorder_n "
        "WHERE lo_supplycost > 90000 OR c_nation = 'NATION_03' GROUP BY d_year ORDER BY d_year"
    ),
    "21_null_docmask": (
        "SET enableNullHandling = true; SELECT COUNT(*) FROM lineorder_n WHERE lo_supplycost IS NULL AND d_year = 1995"
    ),
}
NULL_SHARE, NULL_SEED, NULL_YEAR = 0.03, 21, 1998
LAUNCHES_PER_SEGMENT.update(
    {
        "17_filter_where": (4, 1, 0, 0),  # masks: 1997, 1996, lo_quantity > 40, none
        "18_case_in_cmp_fn": (1, 1, 0, 0),  # the CASE sum is float64: index_add_
        "19_percentileest": (1, 0, 0, 2),  # counts (ng 256), two histograms (ng 2^20)
        "19_percentileest_scalar": (2, 0, 0, 0),  # two histograms (ng 4096)
        "20_funnelcount": (0, 0, 3, 0),
        "21_null_kleene": (2, 1, 0, 0),  # masks: the non-null one, none; MIN of int64 as float64
        "21_null_docmask": (0, 0, 0, 0),
    }
)
#: configs 22-27: the `mvt` table, MV_ROWS rows in MV_SEGMENTS segments: SV
#: year (1992-1998), region (5 values), revenue ([0, 10^6)); MV tags (0-4
#: values a doc, Zipf s = 1 over N_TAGS strings tag0000..tag0999) and nums
#: (0-4 values a doc, uniform over [0, 100))
MV_ROWS = 8_000_000
MV_SEGMENTS = 8
N_TAGS = 1000
MV_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
MV_CONFIGS = {
    # "tag search": MV any-match (mv_any), an exclusion, and a two-value
    # match the optimizer must not merge into an empty range
    "22_tag_search": "SELECT COUNT(*), SUM(revenue) FROM mvt WHERE tags = 'tag0042'",
    "22_tag_exclusion": (
        "SELECT COUNT(*), SUM(revenue) FROM mvt WHERE tags NOT IN ('tag0001', 'tag0007') AND year >= 1995"
    ),
    "22_two_values": "SELECT COUNT(*) FROM mvt WHERE nums > 95 AND nums < 3",
    # "MV totals": the *MV aggregations, DISTINCTCOUNTMV one presence launch
    "23_mv_totals": (
        "SELECT COUNTMV(nums), SUMMV(nums), MINMV(nums), MAXMV(nums), AVGMV(nums), DISTINCTCOUNTMV(tags) "
        "FROM mvt WHERE year = 1997"
    ),
    # "MV totals by year": B1 and B3 over the nums value space
    "24_mv_totals_by_year": (
        "SELECT year, COUNTMV(nums), SUMMV(nums), MINMV(nums), MAXMV(nums), AVGMV(nums) FROM mvt "
        "GROUP BY year ORDER BY year"
    ),
    # "top tags": GROUP BY one MV key (groups_mv), doc-space values gathered
    "25_top_tags": (
        "SELECT tags, COUNT(*), SUM(revenue), MAX(revenue) FROM mvt WHERE year >= 1995 GROUP BY tags "
        "ORDER BY COUNT(*) DESC, tags LIMIT 20"
    ),
    "25_distinct_tags": "SELECT DISTINCT tags FROM mvt WHERE year = 1998 ORDER BY tags LIMIT 50",
    # "tag x num pairs": two MV keys (groups_mv2), ng 100,096: the two-level
    # kernel over ~8M pairs a segment
    "26_tag_num_pairs": (
        "SELECT tags, nums, COUNT(*), SUM(year) FROM mvt GROUP BY tags, nums "
        "ORDER BY COUNT(*) DESC, tags, nums LIMIT 20"
    ),
}
#: config 27: shapes the reference also answers on its host
MV_HOST_CONFIGS = {
    "27_ragged_selection": "SELECT tags, nums, year FROM mvt WHERE tags = 'tag0042' AND year = 1996 LIMIT 10",
    "27_distinctcountmv_by_year": "SELECT year, DISTINCTCOUNTMV(tags) FROM mvt GROUP BY year ORDER BY year",
    "27_mv_agg_under_mv_key": "SELECT tags, SUMMV(nums) FROM mvt GROUP BY tags ORDER BY tags LIMIT 20",
}
LAUNCHES_PER_SEGMENT.update(
    {
        "22_tag_search": (0, 0, 0, 0),
        "22_tag_exclusion": (0, 0, 0, 0),
        "22_two_values": (0, 0, 0, 0),
        "23_mv_totals": (0, 0, 1, 0),  # the scalar *MV reductions are torch ops
        "24_mv_totals_by_year": (2, 1, 0, 0),  # doc-space counts; nums' value space: sums, then MIN and MAX
        "25_top_tags": (1, 1, 0, 0),
        "25_distinct_tags": (1, 0, 0, 0),
        "26_tag_num_pairs": (0, 0, 0, 1),
        "27_ragged_selection": (0, 0, 0, 0),
        "27_distinctcountmv_by_year": (0, 0, 0, 0),
        "27_mv_agg_under_mv_key": (0, 0, 0, 0),
    }
)
#: result columns held to rtol 1e-12 (AVG, STDDEV, PERCENTILE); every other
#: cell must be equal
APPROX_COLUMNS = {"2_filtered_agg": {3}, "14_groupby_raw_metric": {3}, "15_host_aggregations": {1, 3},
                  "23_mv_totals": {4}, "24_mv_totals_by_year": {5}}
#: SSB's customer and supplier key ranges at scale factor 3 (~16M x 6/16
#: lineorder rows)
N_CUSTOMERS = 90_000
N_SUPPLIERS = 6_000


#: the script's start: every phase line carries its seconds since then
T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - T_START, 3)}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters: int, warmup: int = 2, queued: bool = False) -> float:
    """Mean time of fn() in ms between CUDA events over `iters` runs, each
    after the L2 is flushed (the main path reads its columns from device
    memory). The span holds the host's enqueue of fn's work wherever the
    device waits for it; with `queued` the device first spins for ~1 ms, so
    the host has enqueued all of fn before the span starts and the span is
    device time alone."""
    return _timed(torch, fn, iters, warmup, queued)[0]


def device_and_host_ms(torch, fn, iters: int = 50) -> tuple[float, float]:
    """(device ms alone, host ms): time_ms(queued=True), and the mean wall
    time of the fn() calls themselves on the host clock. The device is
    spinning while fn runs, so that is the host's enqueue of fn's work."""
    return _timed(torch, fn, iters, 2, True)


def _timed(torch, fn, iters: int, warmup: int, queued: bool) -> tuple[float, float]:
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = host = 0.0
    for _ in range(iters):
        flush.zero_()
        if queued:
            torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host += time.perf_counter() - t0
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters, host / iters * 1e3


# ---------------------------------------------------------------------------
# phase 2: the exact group-by kernel against its plain version
# ---------------------------------------------------------------------------


def ssb_shapes(torch, n: int = 4_194_304, seed: int = 6):
    """Config 3-5's and 12's group ids, masks and value columns over one
    segment of SSB-like data (make_ssb_data's distributions): config 3 ng 256
    with 7 groups (d_year) and a 3.8% mask; configs 4 and 5 the 64% mask of
    lo_quantity > 5 AND d_year BETWEEN 1993 AND 1997, config 4 ng 4608 with
    4375 groups (d_year, c_nation, p_category), 3125 of them masked, config 5
    ng 256 with 175 groups (d_year, c_nation), 125 of them masked; config 12
    config 5's groups under the 4% mask of lo_quantity < 3."""
    rng = np.random.default_rng(seed)
    year, nation, cat = rng.integers(0, 7, n), rng.integers(0, 25, n), rng.integers(0, 25, n)
    qty, rev, cost = rng.integers(1, 51, n), rng.integers(100, 600_000, n), rng.integers(50, 100_000, n)
    i32, b = torch.int32, torch.bool
    m45 = _tensor(torch, (qty > 5) & (year >= 1) & (year <= 5), b)
    return {
        "year": _tensor(torch, year, i32),
        "m3": _tensor(torch, ((nation == 1) | (nation == 2)) & (qty < 25), b),
        "g4": _tensor(torch, year * 625 + nation * 25 + cat, i32),
        "g5": _tensor(torch, year * 25 + nation, i32),
        "m45": m45,
        "m12": _tensor(torch, qty < 3, b),
        "qty": _tensor(torch, qty, i32),
        "rev": _tensor(torch, rev, i32),
        "cost": _tensor(torch, cost, i32),
        "profit": _tensor(torch, rev - cost, i32),
        "ratio": _tensor(torch, rev / qty, torch.float64),
    }


def mv_shapes(torch, seed: int = 23) -> dict:
    """Configs 25's and 26's value-space shapes over one MV segment (1M docs
    of make_mv_data's distributions): 25, GROUP BY tags in tags' value space
    (ng 1024, k 1: revenue gathered to the values, the mask year >= 1995
    gathered and the padding off); 26, GROUP BY tags, nums in the pair space
    (tags' values x Lb 4, ng 100,096, k 1: year; a pair is on while its
    position is below its doc's nums length)."""
    from pinot_tpu_torch.segment.segment import padded_len

    d = make_mv_data(1_000_000, seed)
    n = len(d["year"])
    i32, b = torch.int32, torch.bool
    tag_doc = np.repeat(np.arange(n), d["tags_lens"])
    nv = len(tag_doc)
    va = padded_len(nv)

    def pad(a, fill=0):
        return np.concatenate([a, np.full(va - len(a), fill, dtype=a.dtype)])

    tag_ids = np.unique(d["tags"], return_inverse=True)[1]
    mask25 = pad(d["year"][tag_doc] >= 1995, False)
    n_off = mv_offsets(d, "nums")
    lb = 4
    j = np.arange(lb)
    on = j[None, :] < d["nums_lens"][tag_doc][:, None]
    pos = np.minimum(n_off[tag_doc][:, None] + j[None, :], len(d["nums"]) - 1)
    gid26 = tag_ids[:, None].astype(np.int64) * 100 + d["nums"][pos]
    return {
        "mv25": ([_tensor(torch, pad(d["revenue"][tag_doc]), i32)], _tensor(torch, pad(tag_ids), i32),
                 _tensor(torch, mask25, b), 1024),
        "mv26": ([_tensor(torch, np.repeat(pad(d["year"][tag_doc]), lb), i32)],
                 _tensor(torch, np.concatenate([gid26.reshape(-1), np.zeros((va - nv) * lb, np.int64)]), i32),
                 _tensor(torch, np.concatenate([on.reshape(-1), np.zeros((va - nv) * lb, bool)]), b), 100_096),
    }


def kernel_cases(torch, ssb):
    """(name, values, gid, mask, ng, expect_shared) at the main path's shapes
    and at the edges of the kernel's contract."""
    rng = np.random.default_rng(1)
    i32 = np.iinfo(np.int32)

    def t(a, dtype=torch.int32):
        return _tensor(torch, a, dtype)

    n = 4_194_304
    q4_gid = rng.integers(0, 4375, n)
    q4 = (
        "q4_shape",
        [t(rng.integers(-600_000, 600_001, n))],
        t(q4_gid),
        t(rng.random(n) < 0.7, torch.bool),
        4608,
        True,
    )
    main = [
        ("config3_shape", [ssb["rev"]], ssb["year"], ssb["m3"], 256, True),
        ("config4_shape", [ssb["profit"]], ssb["g4"], ssb["m45"], 4608, True),
        ("config5_shape_k0", [], ssb["g5"], ssb["m45"], 256, True),
        ("config12_shape_k0", [], ssb["g5"], ssb["m12"], 256, True),
        # config 10's star GROUP BY country: 90 star rows, one doc pad
        ("config10_star_shape_k0", [], t(np.arange(1024) // 3 % 30), t(np.arange(1024) < 90, torch.bool), 256, True),
        # config 25: GROUP BY tags in tags' value space (~2M values)
        ("config25_shape", *ssb["mv25"], True),
        # config 26's pair space (~8M pairs) at a small ng: the flat
        # kernel's plan past 2^23 docs
        ("config26_pairs_ng_256", ssb["mv26"][0], t(np.asarray(ssb["mv26"][1].cpu()) % 256), ssb["mv26"][2], 256, True),
    ]
    n2 = 1 << 20
    extremes = rng.choice(np.array([i32.min, i32.max, -1, 0, 1], dtype=np.int64), size=(3, n2))
    gid2 = rng.integers(-3, 259, n2)  # a few ids outside [0, 256): dropped
    ext = ("k3_int32_extremes", [t(extremes[j]) for j in range(3)], t(gid2), t(rng.random(n2) < 0.9, torch.bool), 256, True)
    empty = ("empty_mask", [t(rng.integers(-5, 6, n2))], t(rng.integers(0, 100, n2)), t(np.zeros(n2, bool), torch.bool), 256, True)
    wide = (
        "k9_two_launches",
        [t(rng.integers(-(1 << 20), 1 << 20, n2)) for _ in range(9)],
        t(rng.integers(0, 300, n2)),
        t(rng.random(n2) < 0.6, torch.bool),
        300,
        True,
    )
    big = (
        "ng_2^20_k2_global",
        [t(rng.integers(-1000, 1001, n)) for _ in range(2)],
        t(rng.integers(0, 1 << 20, n)),
        t(rng.random(n) < 0.5, torch.bool),
        1 << 20,
        False,
    )
    # contention: 7 present groups of ng 256 under a 90% mask
    hot = ("contention_7_groups_90pct", [ssb["rev"]], ssb["year"], t(rng.random(ssb["year"].numel()) < 0.9, torch.bool),
           256, True)
    # sums near +-2^31 a doc over ~2^18 docs a group: the high words carry
    # both ways, and one group's sum stays positive, one's negative
    near = np.array([i32.max, i32.max - 1, i32.min, i32.min + 1], dtype=np.int64)
    cgid = rng.integers(0, 6, n2)
    cval = rng.choice(near, n2)
    cval[cgid == 4] = i32.max
    cval[cgid == 5] = i32.min
    carry = ("sums_near_2^31_carry", [t(cval), t(-cval - 1)], t(cgid), t(rng.random(n2) < 0.95, torch.bool), 6, True)
    tail_v, tail_g, tail_m = t(rng.integers(-50, 50, n2 + 3)), t(rng.integers(0, 256, n2 + 3)), t(rng.random(n2 + 3) < 0.8, torch.bool)
    tails = [(f"tail_of_{r}_docs", [tail_v[: n2 + r]], tail_g[: n2 + r], tail_m[: n2 + r], 256, True) for r in (1, 2, 3)]
    # views from element 1: 4-byte aligned pointers, no 16-byte loads
    unaligned = ("unaligned_views", [tail_v[1 : n2 + 1]], tail_g[1 : n2 + 1], tail_m[1 : n2 + 1], 256, True)
    one = ("ng_1", [t(rng.integers(-(1 << 30), 1 << 30, n2))], t(rng.integers(-1, 2, n2)), t(rng.random(n2) < 0.7, torch.bool), 1, True)
    return [q4, *main, ext, empty, wide, big, hot, carry, *tails, unaligned, one]


def _b1_timing(torch, gb, values, gid, mask, ng) -> dict:
    """Device time alone, the host's enqueue and the span with it, the plain
    version's and index_add_'s times, and the bounds, for one shape."""
    k, n = len(values), gid.numel()
    fn = lambda: gb.grouped_multi_sum_kernel(values, gid, mask, ng)  # noqa: E731
    # the yardstick: ONE PyTorch call computing the same function on the
    # same inputs, prepared outside the timed region
    ok, idx = _in_range(torch, gid, mask, ng)
    src = torch.stack([torch.where(ok, v, 0).to(torch.int64) for v in values] + [ok.to(torch.int64)])
    dst = torch.zeros(k + 1, ng, dtype=torch.int64, device=gid.device)
    device_ms, host_ms = device_and_host_ms(torch, fn)
    out = {
        "shape": {"n": n, "k": k, "ng": ng, "mask_on": int(mask.sum().item()),
                  "groups": int(torch.unique(gid[mask]).numel())},
        "kernel_device_ms": device_ms,
        "kernel_host_ms": host_ms,
        "kernel_ms": time_ms(torch, fn, iters=50),
        "plain_ms": time_ms(torch, lambda: gb.grouped_multi_sum_plain(values, gid, mask, ng), iters=10),
        "library_ms": time_ms(torch, lambda: dst.index_add_(1, idx, src), iters=10),
    }
    # bytes over the HBM rate: every input once, the output once; and the
    # data-dependent form, where only docs with the mask on need their group
    # id and values read
    out_bytes = (k + 1) * ng * 8
    out["bound_ms"] = hbm_ms(n * (4 + 1 + 4 * k) + out_bytes)
    out["bound_data_ms"] = hbm_ms(n + out["shape"]["mask_on"] * (4 + 4 * k) + out_bytes)
    return out


def check_kernels(torch, gb, ssb) -> dict:
    results = []
    max_err = 0.0
    keep = {}
    for name, values, gid, mask, ng, expect_shared in kernel_cases(torch, ssb):
        shared = gb.uses_shared_counters(min(len(values), gb.MAX_COLS), ng, gid.device)
        if shared != expect_shared:
            raise AssertionError(f"{name}: shared-memory path {shared}, expected {expect_shared}")
        got = gb.grouped_multi_sum_kernel(values, gid, mask, ng)
        torch.cuda.synchronize()
        want = gb.grouped_multi_sum_plain(values, gid, mask, ng)
        equal = torch.equal(got, want)
        err = float((got - want).abs().max().item())
        max_err = max(max_err, err)
        results.append({"case": name, "k": len(values), "ng": ng, "n": gid.numel(), "shared_counters": shared, "equal": equal})
        if not equal:
            raise AssertionError(f"{name}: kernel != plain version (max abs err {err})")
        keep[name] = (values, gid, mask, ng)
    emit({"phase": "kernel_vs_plain", "kernel": "grouped_sum_count", "cases": results})

    # Q4's shape (continuity with earlier runs) and every shape the main path
    # launches the kernel at
    timings = {
        name: _b1_timing(torch, gb, *keep[name])
        for name in ("q4_shape", "config3_shape", "config4_shape", "config5_shape_k0", "config12_shape_k0",
                     "config10_star_shape_k0", "config25_shape")
    }
    emit({"phase": "kernel_timing", "kernel": "grouped_sum_count", "timings": timings, "card": card_line()})
    return {"max_abs_err": max_err, **timings["q4_shape"]}


def same(torch, got, want) -> bool:
    """Exact equality under == (so -0.0 == +0.0), NaN equal to NaN, and the
    same dtype and shape."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    eq = got == want
    if got.dtype.is_floating_point:
        eq |= got.isnan() & want.isnan()
    return bool(eq.all().item())


def abs_err(torch, got, want) -> float:
    """Largest |got - want| over the entries finite on both sides."""
    g, w = got.to(torch.float64), want.to(torch.float64)
    fin = torch.isfinite(g) & torch.isfinite(w)
    return float((g - w)[fin].abs().max().item()) if bool(fin.any().item()) else 0.0


def hbm_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _tensor(torch, a, dtype):
    return torch.as_tensor(np.ascontiguousarray(a)).to("cuda").to(dtype).contiguous()


def _in_range(torch, gid, mask, ng):
    ok = mask & (gid >= 0) & (gid < ng)
    return ok, torch.where(ok, gid, 0).to(torch.int64)


def _counts(torch, gid, mask, ng):
    ok, idx = _in_range(torch, gid, mask, ng)
    return torch.bincount(idx[ok], minlength=ng)


# ---------------------------------------------------------------------------
# phase 2a: the two-level exact group-by kernel against its plain version
# ---------------------------------------------------------------------------


def two_level_cases(torch, ssb):
    """(name, values, gid, mask, ng, L or None for the default, branches):
    configs 8 and 9's shapes, ng = 2^20 with a dense mask under four L, and
    the edges of the kernel's contract, each edge both where its buckets are
    dense (records and the reduce) and where they are sparse (the partition
    adds straight into the output). `branches` is the set of bucket branches
    the case's launches take on an H100 (132 SMs): check_two_level asserts
    it. Every case lies past the flat kernel's shared counters, where the
    engine takes the two-level kernel."""
    rng = np.random.default_rng(5)
    i32, b = torch.int32, torch.bool
    n, n2 = 4_194_304, 1 << 20
    D, S, DS = {"dense"}, {"sparse"}, {"dense", "sparse"}

    def rev(m):
        return _tensor(torch, rng.integers(100, 600_000, m), i32)

    cases = []
    # config 8: GROUP BY lo_custkey, 71% of the docs pass the filter
    cases.append(("config8_shape", [rev(n)], _tensor(torch, rng.integers(0, 90_000, n), i32),
                  _tensor(torch, rng.random(n) < 0.71, b), 90_112, None, D))
    # config 9: 1.4% of the docs pass; their slots are the first ~57k of
    # U = 2^20, the other docs' slots lie anywhere
    m9 = rng.random(n) < 0.0143
    g9 = rng.integers(0, 1 << 20, n)
    g9[m9] = rng.integers(0, 57_000, int(m9.sum()))
    cases.append(("config9_shape", [rev(n)], _tensor(torch, g9, i32), _tensor(torch, m9, b), 1 << 20, None, S))
    # config 26: GROUP BY tags, nums over ~8M pairs (Zipf tags: the first
    # hi buckets hold most pairs); its branches are reported, not asserted
    cases.append(("config26_shape", *ssb["mv26"], None, None))
    # ng = 2^20 with a dense mask; L must not change the answer: the default
    # (12), the widest L that fits (14), L = 9, and L = 4, whose 65,536
    # buckets pass the shared histogram (a global atomic per doc)
    dense = ([rev(n)], _tensor(torch, rng.integers(0, 1 << 20, n), i32), _tensor(torch, rng.random(n) < 0.9, b))
    cases.append(("ng_2^20_dense_mask", *dense, 1 << 20, None, D))
    cases.append(("ng_2^20_dense_mask_L14", *dense, 1 << 20, 14, S))
    cases.append(("ng_2^20_dense_mask_L9", *dense, 1 << 20, 9, D))
    cases.append(("ng_2^20_dense_mask_L4_global_hist", *dense, 1 << 20, 4, DS))
    # k = 8 at ng = 2^20: a 72 MB output, past the 50 MB L2
    cases.append(("ng_2^20_k8_past_L2", [rev(n) for _ in range(8)], *dense[1:], 1 << 20, None, D))
    gid2 = _tensor(torch, rng.integers(0, 100_003, n2), i32)
    mask2 = _tensor(torch, rng.random(n2) < 0.6, b)
    cases.append(("ng_100003_k2_not_a_multiple", [rev(n2), _tensor(torch, rng.integers(-10**6, 10**6, n2), i32)],
                  gid2, mask2, 100_003, None, S))
    # the first launch (k = 8, L = 11) is dense, the second (k = 1) sparse
    cases.append(("k9_two_launches", [_tensor(torch, rng.integers(-(1 << 20), 1 << 20, n2), i32) for _ in range(9)],
                  gid2, mask2, 100_003, None, DS))
    cases.append(("k0_counts_only", [], gid2, mask2, 100_003, None, S))
    cases.append(("k0_counts_only_dense", [], *dense[1:], 1 << 20, None, D))
    cases.append(("empty_mask", [rev(n2)], gid2, _tensor(torch, np.zeros(n2, bool), b), 100_003, None, set()))
    one = np.zeros(n2, bool)
    one[777_777] = True
    cases.append(("one_doc", [rev(n2)], gid2, _tensor(torch, one, b), 100_003, None, S))
    i32_info = np.iinfo(np.int32)

    def out_of_range(m, ng):
        g = rng.integers(-3, ng + 300, m)
        g[::101] = i32_info.max
        g[1::103] = i32_info.min
        return _tensor(torch, g, i32)

    cases.append(("out_of_range_gids_sparse", [rev(n2)], out_of_range(n2, 50_000), mask2, 50_000, None, S))
    cases.append(("out_of_range_gids_dense", [rev(n)], out_of_range(n, 1 << 20), dense[2], 1 << 20, None, D))
    pool = np.array([i32_info.min, i32_info.max, -1, 0, 1], dtype=np.int64)
    cases.append(("int32_extremes_k3_sparse", [_tensor(torch, rng.choice(pool, n2), i32) for _ in range(3)],
                  _tensor(torch, rng.integers(0, 40_000, n2), i32), _tensor(torch, rng.random(n2) < 0.9, b), 40_000,
                  None, S))
    cases.append(("int32_extremes_k3_dense", [_tensor(torch, rng.choice(pool, n), i32) for _ in range(3)],
                  *dense[1:], 1 << 20, None, D))
    # skew: every doc in one bucket (bucket 1 of L = 12)
    cases.append(("one_bucket", [rev(n)], _tensor(torch, rng.integers(1 << 12, 2 << 12, n), i32),
                  _tensor(torch, rng.random(n) < 0.9, b), 1 << 20, None, D))
    # n % 4 = 3: the last docs after the 4-doc steps; then group ids one
    # element past an aligned start, which rules out the 16-byte loads
    n3, n4 = n2 - 3, n - 3
    # grouped PERCENTILEEST's histograms: gid = group x 4096 + bin, k = 0, at
    # config 19's shape (7 years present of ng 256, 4% of the docs) and at
    # the planner's largest, ng 2^22 (1024 groups), a bucket a group
    bins = rng.integers(0, 4096, n)
    cases.append(("hist_ng_2^20", [], _tensor(torch, rng.integers(0, 7, n) * 4096 + bins, i32),
                  _tensor(torch, rng.random(n) < 0.04, b), 1 << 20, None, D))
    cases.append(("hist_ng_2^22_sparse", [], _tensor(torch, rng.integers(0, 1024, n) * 4096 + bins, i32),
                  _tensor(torch, rng.random(n) < 0.04, b), 1 << 22, None, S))
    cases.append(("hist_ng_2^22_dense", [], _tensor(torch, rng.integers(0, 300, n) * 4096 + bins, i32),
                  _tensor(torch, rng.random(n) < 0.9, b), 1 << 22, None, D))
    cases.append(("tail_of_3_docs_sparse", [rev(n3)], gid2[:n3].contiguous(), mask2[:n3].contiguous(), 100_003,
                  None, S))
    cases.append(("unaligned_gid_sparse", [rev(n3)], gid2[1 : n3 + 1], mask2[1 : n3 + 1], 100_003, None, S))
    cases.append(("tail_of_3_docs_dense", [rev(n4)], dense[1][:n4].contiguous(), dense[2][:n4].contiguous(),
                  1 << 20, None, D))
    cases.append(("unaligned_gid_dense", [rev(n4)], dense[1][1 : n4 + 1], dense[2][1 : n4 + 1], 1 << 20, None, D))
    return cases


def bucket_branches(torch, gb, k, gid, mask, ng, bits, limit) -> list[dict]:
    """For each launch of a two-level call (MAX_COLS columns at most a
    launch): its L, the kernel's own sparse limit, and how many hi buckets
    hold docs past it (dense: records and the reduce) and at most it
    (sparse: straight into the output; empty buckets not counted)."""
    ok, idx = _in_range(torch, gid, mask, ng)
    out = []
    for start in range(0, max(k, 1), gb.MAX_COLS):
        cols = min(gb.MAX_COLS, k - start) if k else 0
        L = gb.two_level_bits(cols, ng, limit) if bits is None else bits
        top = gb.sparse_max(cols, gid.numel(), ng, L, gid.device)
        totals = torch.bincount(idx[ok] >> L, minlength=(ng + (1 << L) - 1) >> L)
        out.append({"k": cols, "L": L, "sparse_max": top, "dense": int((totals > top).sum().item()),
                    "sparse": int(((totals > 0) & (totals <= top)).sum().item())})
    return out


def pass_times(torch, fn, calls: int = 5) -> dict:
    """Device ms per call of each kernel and memset that fn() launches,
    from torch.profiler over `calls` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {
        e.key[:60]: e.self_device_time_total / 1e3 / calls
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    }


def check_two_level(torch, gb, ssb) -> dict:
    results, keep, max_err = [], {}, 0.0
    limit = gb.shared_limit(torch.device("cuda"))
    for name, values, gid, mask, ng, bits, branches in two_level_cases(torch, ssb):
        k = len(values)
        if gb.uses_shared_counters(min(k, gb.MAX_COLS), ng, gid.device):
            raise AssertionError(f"{name}: (k={k}, ng={ng}) fits the flat kernel's shared counters")
        before = gb.grouped_multi_sum_2l.launches
        got = gb.grouped_multi_sum_2l_kernel(values, gid, mask, ng, bits)
        torch.cuda.synchronize()
        launches = gb.grouped_multi_sum_2l.launches - before
        used = gb.two_level_bits(min(k, gb.MAX_COLS), ng, limit) if bits is None else bits
        buckets = bucket_branches(torch, gb, k, gid, mask, ng, bits, limit)
        took = {b for b in ("dense", "sparse") if any(row[b] for row in buckets)}
        want = gb.grouped_multi_sum_plain(values, gid, mask, ng)
        equal = torch.equal(got, want)
        err = float((got - want).abs().max().item())
        max_err = max(max_err, err)
        results.append({"case": name, "k": k, "ng": ng, "n": gid.numel(), "L": used, "launches": launches,
                        "mask_on": int(mask.sum().item()), "buckets": buckets, "equal": equal})
        if not equal:
            raise AssertionError(f"{name}: grouped_sum_count_2l kernel != plain version (max abs err {err})")
        if launches != max(1, -(-k // gb.MAX_COLS)):
            raise AssertionError(f"{name}: {launches} launches for k={k}")
        if branches is not None and took != branches:
            raise AssertionError(f"{name}: buckets took {sorted(took)}, expected {sorted(branches)}: {buckets}")
        keep[name] = (values, gid, mask, ng, used)
    emit({"phase": "kernel_vs_plain", "kernel": "grouped_sum_count_2l", "shared_limit": limit, "cases": results})

    timings = {}
    for name in ("config8_shape", "config9_shape", "ng_2^20_k8_past_L2", "hist_ng_2^20", "hist_ng_2^22_sparse",
                 "config26_shape"):
        values, gid, mask, ng, bits = keep[name]
        k, n, masked = len(values), gid.numel(), int(mask.sum().item())
        ok, idx = _in_range(torch, gid, mask, ng)
        src = torch.stack([torch.where(ok, v, 0).to(torch.int64) for v in values] + [ok.to(torch.int64)])
        dst = torch.zeros(k + 1, ng, dtype=torch.int64, device=gid.device)
        out_bytes = (k + 1) * ng * 8
        fn = lambda: gb.grouped_multi_sum_2l_kernel(values, gid, mask, ng)  # noqa: E731
        device_ms, host_ms = device_and_host_ms(torch, fn)
        timings[name] = {
            "shape": {"n": n, "k": k, "ng": ng, "L": bits, "mask_on": masked},
            # device time alone (the output's zero fill included), the host's
            # enqueue meanwhile, and the span with it
            "kernel_device_ms": device_ms,
            "kernel_host_ms": host_ms,
            "kernel_ms": time_ms(torch, fn, 50),
            # the flat kernel's global-atomics branch at the same shape
            "flat_global_device_ms": time_ms(torch, lambda: gb.grouped_multi_sum_kernel(values, gid, mask, ng), 50,
                                             queued=True),
            "plain_ms": time_ms(torch, lambda: gb.grouped_multi_sum_plain(values, gid, mask, ng), 10),
            "library_ms": time_ms(torch, lambda: dst.index_add_(1, idx, src), 20),
            "bound_ms": hbm_ms(n * (4 + 1 + 4 * k) + out_bytes),
            "bound_data_ms": hbm_ms(n + masked * (4 + 4 * k) + out_bytes),
            # the L values around the default, and the device time of each pass
            "device_ms_by_L": {
                L: time_ms(torch, lambda L=L: gb.grouped_multi_sum_2l_kernel(values, gid, mask, ng, L), 20, queued=True)
                for L in range(max(6, bits - 2), gb.fit_bits(k, limit) + 1)
            },
            "pass_ms": pass_times(torch, fn),
        }
    emit({"phase": "kernel_timing", "kernel": "grouped_sum_count_2l", "timings": timings, "card": card_line()})
    emit({"phase": "dispatch_band", "timings": dispatch_band(torch, gb), "card": card_line()})
    return {"max_abs_err": max_err, **timings["config8_shape"]}


#: (k, ng) on both sides of where grouped_multi_sum leaves the flat kernel
#: on an H100 (232,448 B a block): the flat kernel's (2k+1) x ng 32-bit
#: counters fit up to ng 58,112 at k = 0 and 19,370 at k = 1
BAND = [(0, 57_344), (0, 61_440), (1, 18_432), (1, 22_528)]


def dispatch_band(torch, gb) -> dict:
    """Device time alone of the flat and the two-level kernel, each checked
    against the plain version, at the BAND shapes: one 4M-doc segment, ids
    uniform over ng, a 70% mask. Where grouped_multi_sum takes each is
    `engine_takes`."""
    rng = np.random.default_rng(9)
    n = 4_194_304
    mask = _tensor(torch, rng.random(n) < 0.7, torch.bool)
    value = _tensor(torch, rng.integers(100, 600_000, n), torch.int32)
    out = {}
    for k, ng in BAND:
        gid = _tensor(torch, rng.integers(0, ng, n), torch.int32)
        values = [value][:k]
        want = gb.grouped_multi_sum_plain(values, gid, mask, ng)
        runs = {
            "flat": lambda: gb.grouped_multi_sum_kernel(values, gid, mask, ng),
            "two_level": lambda: gb.grouped_multi_sum_2l_kernel(values, gid, mask, ng),
        }
        shared = gb.uses_shared_counters(k, ng, gid.device)
        row = {
            "flat_shared_counters": shared,
            "flat_blocks": gb._plan(gid.device.index, k, ng, n)[0],
            "engine_takes": "flat" if shared else "two_level",
        }
        for name, fn in runs.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"k={k} ng={ng}: the {name} kernel != plain version")
            row[f"{name}_device_ms"] = time_ms(torch, fn, 50, queued=True)
        out[f"k{k}_ng{ng}"] = row
    return out


# ---------------------------------------------------------------------------
# phase 2b: the extreme kernel (grouped MIN/MAX) against its plain version
# ---------------------------------------------------------------------------


def extreme_cases(torch):
    """(name, values, gid, mask, ng, is_min, counts, expect_shared): Q4's
    shape, the engine's shapes (config 5: 125 groups of ng = 256), and the
    edges of the kernel's contract."""
    rng = np.random.default_rng(2)
    f32, f64, i32, b = torch.float32, torch.float64, torch.int32, torch.bool
    cases = []

    def add(name, values, gid, mask, ng, is_min, shared):
        counts = _counts(torch, gid, mask, ng) if values.dtype == i32 else None
        cases.append((name, values, gid, mask, ng, is_min, counts, shared))

    n = 4_194_304
    gid = _tensor(torch, rng.integers(0, 4375, n), i32)
    mask = _tensor(torch, rng.random(n) < 0.7, b)
    for is_min in (True, False):
        tag = "min" if is_min else "max"
        add(f"q4_shape_f32_{tag}", _tensor(torch, rng.uniform(-1e6, 1e6, n), f32), gid, mask, 4608, is_min, True)
        add(f"q4_shape_i32_{tag}", _tensor(torch, rng.integers(-600_000, 600_001, n), i32), gid, mask, 4608, is_min, True)
        add(f"q4_shape_f64_{tag}", _tensor(torch, rng.normal(0, 1e6, n), f64), gid, mask, 4608, is_min, True)

    # config 5's shape: 125 present groups of ng = 256, heavy contention
    egid = _tensor(torch, rng.integers(0, 125, n), i32)
    emask = _tensor(torch, rng.random(n) < 0.65, b)
    qty = rng.integers(1, 51, n)
    rev = rng.integers(100, 600_000, n)
    add("engine_ng256_i32_min", _tensor(torch, qty, i32), egid, emask, 256, True, True)
    add("engine_ng256_i32_max", _tensor(torch, rev, i32), egid, emask, 256, False, True)
    add("engine_ng256_f64_max", _tensor(torch, rev / qty, f64), egid, emask, 256, False, True)

    n2 = 1 << 20
    gid2 = _tensor(torch, rng.integers(0, 256, n2), i32)
    none = _tensor(torch, np.zeros(n2, bool), b)
    add("empty_mask_f32_min", _tensor(torch, rng.normal(0, 1, n2), f32), gid2, none, 256, True, True)
    add("empty_mask_i32_max", _tensor(torch, rng.integers(-5, 6, n2), i32), gid2, none, 256, False, True)
    add("empty_mask_f64_min", _tensor(torch, rng.normal(0, 1, n2), f64), gid2, none, 256, True, True)

    ogid = _tensor(torch, rng.integers(-3, 300, n2), i32)  # ids outside [0, 256): dropped
    omask = _tensor(torch, rng.random(n2) < 0.8, b)
    add("out_of_range_f32_max", _tensor(torch, rng.normal(0, 1, n2), f32), ogid, omask, 256, False, True)
    add("out_of_range_i32_min", _tensor(torch, rng.integers(-9, 9, n2), i32), ogid, omask, 256, True, True)

    i32_info = np.iinfo(np.int32)
    pool = np.array([i32_info.min, i32_info.max, i32_info.min + 1, i32_info.max - 1, -1, 0, 1], dtype=np.int64)
    for is_min in (True, False):
        tag = "min" if is_min else "max"
        # sparse mask: some groups hold only INT32_MAX (or only INT32_MIN) docs
        add(f"int32_extremes_{tag}", _tensor(torch, rng.choice(pool, n2), i32), gid2,
            _tensor(torch, rng.random(n2) < 0.002, b), 256, is_min, True)
        specials = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5, -1.5])
        x = rng.choice(specials, n2, p=[0.0005, 0.3, 0.3, 0.001, 0.001, 0.1985, 0.199])
        add(f"nan_signed_zero_f32_{tag}", _tensor(torch, x, f32), gid2, omask, 256, is_min, True)
        add(f"nan_signed_zero_f64_{tag}", _tensor(torch, x, f64), gid2, omask, 256, is_min, True)

    big_gid = _tensor(torch, rng.integers(0, 1 << 20, n), i32)
    big_mask = _tensor(torch, rng.random(n) < 0.5, b)
    add("ng_2^20_global_f32_min", _tensor(torch, rng.normal(0, 1, n), f32), big_gid, big_mask, 1 << 20, True, False)
    add("ng_2^20_global_i32_max", _tensor(torch, rng.integers(-1000, 1001, n), i32), big_gid, big_mask, 1 << 20, False, False)
    add("ng_2^20_global_f64_min", _tensor(torch, rng.normal(0, 1, n), f64), big_gid, big_mask, 1 << 20, True, False)
    return cases


def multi_cases(torch, ssb):
    """(name, columns, outputs, gid, mask, ng, counts or None, expect_shared)
    for grouped_extremes: config 5's five outputs over one (gid, mask), and
    the edges of the multi-output contract."""
    rng = np.random.default_rng(8)
    f32, f64, i32, b = torch.float32, torch.float64, torch.int32, torch.bool
    cases = []

    def add(name, columns, outputs, gid, mask, ng, shared):
        counts = _counts(torch, gid, mask, ng) if any(c.dtype == i32 for c in columns) else None
        cases.append((name, columns, outputs, gid, mask, ng, counts, shared))

    # config 5: MIN(lo_quantity), MAX(lo_revenue), MINMAXRANGE(lo_supplycost),
    # MAX(lo_revenue / lo_quantity)
    five = [(0, True), (1, False), (2, True), (2, False), (3, False)]
    add("config5_five_outputs", [ssb["qty"], ssb["rev"], ssb["cost"], ssb["ratio"]], five, ssb["g5"], ssb["m45"], 256, True)
    n2 = 1 << 20
    gid2 = _tensor(torch, rng.integers(0, 256, n2), i32)
    mask2 = _tensor(torch, rng.random(n2) < 0.7, b)
    i32c = _tensor(torch, rng.integers(-(1 << 31), 1 << 31, n2), i32)
    f64c = _tensor(torch, rng.normal(0, 1e6, n2), f64)
    add("same_column_min_and_max", [f64c, i32c], [(0, True), (0, False), (1, False), (1, True)], gid2, mask2, 256, True)
    add("repeated_outputs", [i32c], [(0, True), (0, True), (0, False)], gid2, mask2, 256, True)
    specials = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5, -1.5])
    x = rng.choice(specials, n2, p=[0.0005, 0.3, 0.3, 0.001, 0.001, 0.1985, 0.199])
    y = rng.choice(specials, n2, p=[0.0002, 0.35, 0.35, 0.0004, 0.0004, 0.149, 0.15])
    add("nan_signed_zero_across_outputs", [_tensor(torch, x, f32), _tensor(torch, y, f64), i32c],
        [(0, True), (0, False), (1, True), (1, False), (2, False)], gid2, mask2, 256, True)
    none = _tensor(torch, np.zeros(n2, bool), b)
    add("all_off_mask", [_tensor(torch, x, f32), i32c, f64c], [(0, True), (1, False), (2, True), (2, False)],
        gid2, none, 256, True)
    ogid = _tensor(torch, rng.integers(-3, 300, n2), i32)  # ids outside [0, 256): dropped
    add("ids_out_of_range", [i32c, f64c, _tensor(torch, x, f32)], [(0, True), (1, False), (2, True), (2, False)],
        ogid, mask2, 256, True)
    cols9 = [_tensor(torch, rng.normal(0, 1, n2), f32), i32c, _tensor(torch, rng.integers(-9, 9, n2), i32), f64c,
             _tensor(torch, rng.uniform(-1, 1, n2), f64)]
    nine = [(0, True), (0, False), (1, True), (1, False), (2, True), (2, False), (3, True), (3, False), (4, False)]
    add("nine_outputs_two_launches", cols9, nine, gid2, mask2, 256, True)
    # ng past a block's shared memory: keys in global memory, finish kernel
    n = 4_194_304
    bgid = _tensor(torch, rng.integers(0, 1 << 16, n), i32)
    bmask = _tensor(torch, rng.random(n) < 0.5, b)
    add("ng_2^16_past_shared", [_tensor(torch, rng.normal(0, 1, n), f64), _tensor(torch, rng.integers(-1000, 1001, n), i32)],
        [(0, True), (0, False), (1, True), (1, False)], bgid, bmask, 1 << 16, False)
    # views from element 1: no 16-byte loads
    add("unaligned_views", [i32c[1:], f64c[1:]], [(0, True), (1, False)], gid2[1:], mask2[1:], 256, True)
    return cases


def check_extreme(torch, ext, ssb) -> dict:
    results, max_err, keep = [], 0.0, {}
    for name, values, gid, mask, ng, is_min, counts, expect_shared in extreme_cases(torch):
        shared = ext.uses_shared_keys([values.dtype], ng, gid.device)
        if shared != expect_shared:
            raise AssertionError(f"{name}: shared-memory path {shared}, expected {expect_shared}")
        got = ext.grouped_extreme_kernel(values, gid, mask, ng, is_min, counts)
        torch.cuda.synchronize()
        want = ext.grouped_extreme_plain(values, gid, mask, ng, is_min, counts)
        equal = same(torch, got, want)
        err = abs_err(torch, got, want)
        max_err = max(max_err, err)
        results.append(
            {"case": name, "dtype": str(values.dtype), "ng": ng, "n": gid.numel(), "shared_keys": shared,
             "nan_groups": int(got.isnan().sum().item()), "equal": equal}
        )
        if not equal:
            raise AssertionError(f"{name}: grouped_extreme kernel != plain version (max abs err {err})")
        keep[name] = (values, gid, mask, ng, is_min, counts)
    for name, columns, outputs, gid, mask, ng, counts, expect_shared in multi_cases(torch, ssb):
        distinct = list(dict.fromkeys(outputs))
        shared = ext.uses_shared_keys([columns[c].dtype for c, _ in distinct[: ext.MAX_OUTPUTS]], ng, gid.device)
        if shared != expect_shared:
            raise AssertionError(f"{name}: shared-memory path {shared}, expected {expect_shared}")
        before = ext.grouped_extremes.launches
        got = ext.grouped_extremes_kernel(columns, outputs, gid, mask, ng, counts)
        torch.cuda.synchronize()
        launches = ext.grouped_extremes.launches - before
        if launches != -(-len(distinct) // ext.MAX_OUTPUTS):
            raise AssertionError(f"{name}: {launches} launches for {len(distinct)} distinct outputs")
        want = ext.grouped_extremes_plain(columns, outputs, gid, mask, ng, counts)
        equal = all(same(torch, g, w) for g, w in zip(got, want))
        err = max(abs_err(torch, g, w) for g, w in zip(got, want))
        max_err = max(max_err, err)
        results.append(
            {"case": name, "outputs": len(outputs), "dtypes": [str(columns[c].dtype) for c, _ in outputs], "ng": ng,
             "n": gid.numel(), "shared_keys": shared, "launches": launches,
             "nan_groups": sum(int(g.isnan().sum().item()) for g in got), "equal": equal}
        )
        if not equal:
            raise AssertionError(f"{name}: grouped_extremes kernel != plain version (max abs err {err})")
        keep[name] = (columns, outputs, gid, mask, ng, counts)
    emit({"phase": "kernel_vs_plain", "kernel": "grouped_extreme", "cases": results})

    timings = {}
    for name in ("q4_shape_i32_min", "q4_shape_f32_min", "q4_shape_f64_max", "engine_ng256_i32_min", "engine_ng256_f64_max"):
        values, gid, mask, ng, is_min, counts = keep[name]
        timings[name] = _b3_timing(torch, ext, [values], [(0, is_min)], gid, mask, ng, counts)
    # the main path's one shape: config 5's five outputs in one launch; the
    # library time is one scatter_reduce_ per output, summed (no single
    # PyTorch call computes all five)
    timings["config5_five_outputs"] = _b3_timing(torch, ext, *keep["config5_five_outputs"])
    emit({"phase": "kernel_timing", "kernel": "grouped_extreme", "timings": timings, "card": card_line()})
    emit({"phase": "extreme_finish", "timings": finish_timings(torch, ext, ssb), "card": card_line()})
    return {"max_abs_err": max_err, **timings["config5_five_outputs"]}


@contextlib.contextmanager
def _finish_in(ext, fold: bool):
    """grouped_extremes launches planned meanwhile finish in their pass's
    last block (fold) or in a separate finish kernel, whatever the plan
    says."""
    real = ext._plan

    def plan(index, widths, ng, n):
        blocks, smem, finish, scratch = real(index, widths, ng, n)
        # the finish kernel strides over the cells, so any grid is right;
        # this is the plan's own (256 threads a block)
        return blocks, smem, 0 if fold else -(-len(widths) * ng // 256), scratch

    ext._spec.cache_clear()
    ext._plan = plan
    try:
        yield
    finally:
        ext._plan = real
        ext._spec.cache_clear()


def finish_timings(torch, ext, ssb) -> dict:
    """The extreme kernel's finish folded into its last block against a
    separate finish kernel, each checked against the plain version: device
    time alone and the host's enqueue, at config 5's five outputs (1280
    cells) and at four outputs (MIN and MAX of an int32 and a float64
    column) over ng 256-4096 (1024-16384 cells), one 4M-doc segment."""
    rng = np.random.default_rng(10)
    n = 4_194_304
    mask = _tensor(torch, rng.random(n) < 0.65, torch.bool)
    cols = [ssb["rev"], ssb["ratio"]]
    four = [(0, True), (0, False), (1, True), (1, False)]
    shapes = {"config5_five_outputs": ([ssb["qty"], ssb["rev"], ssb["cost"], ssb["ratio"]],
                                       [(0, True), (1, False), (2, True), (2, False), (3, False)], ssb["g5"], ssb["m45"], 256)}
    for ng in (256, 512, 1024, 2048, 4096):
        shapes[f"four_outputs_ng{ng}"] = (cols, four, _tensor(torch, rng.integers(0, ng, n), torch.int32), mask, ng)
    out = {}
    for name, (columns, outputs, gid, m, ng) in shapes.items():
        counts = _counts(torch, gid, m, ng)
        want = ext.grouped_extremes_plain(columns, outputs, gid, m, ng, counts)
        fn = lambda: ext.grouped_extremes_kernel(columns, outputs, gid, m, ng, counts)  # noqa: E731
        widths = tuple(ext._DTYPES[columns[c].dtype][1] for c, _ in outputs)
        row = {"cells": len(outputs) * ng, "plan_folds": ext._plan(gid.device.index, widths, ng, n)[2] == 0}
        if name == "config5_five_outputs" and not row["plan_folds"]:
            raise AssertionError("config 5's outputs take a separate finish kernel: two kernels a group-by")
        for how, fold in (("fold", True), ("finish_kernel", False)):
            with _finish_in(ext, fold):
                if not all(same(torch, g, w) for g, w in zip(fn(), want)):
                    raise AssertionError(f"{name}: grouped_extremes ({how}) != plain version")
                row[f"{how}_device_ms"], row[f"{how}_host_ms"] = device_and_host_ms(torch, fn)
        out[name] = row
    return out


def _b3_timing(torch, ext, columns, outputs, gid, mask, ng, counts) -> dict:
    n, masked = gid.numel(), int(mask.sum().item())
    ok, idx = _in_range(torch, gid, mask, ng)
    scatter = []
    for c, is_min in outputs:
        values = columns[c]
        fill = (np.iinfo(np.int32).max if is_min else np.iinfo(np.int32).min) if values.dtype == torch.int32 else (
            math.inf if is_min else -math.inf
        )
        src = torch.where(ok, values, fill)
        dst = torch.full((ng,), fill, dtype=values.dtype, device=gid.device)
        scatter.append((dst, src, "amin" if is_min else "amax"))

    def library():
        for dst, src, how in scatter:
            dst.scatter_reduce_(0, idx, src, reduce=how, include_self=True)

    fn = lambda: ext.grouped_extremes_kernel(columns, outputs, gid, mask, ng, counts)  # noqa: E731
    # each distinct column read once; outputs written once (f32 for f32
    # values, f64 otherwise); the int32 form reads the per-group counts
    col_bytes = sum(columns[c].element_size() for c in dict.fromkeys(c for c, _ in outputs))
    out_bytes = sum(ng * (4 if columns[c].dtype == torch.float32 else 8) for c, _ in outputs)
    out_bytes += ng * 8 if counts is not None else 0
    device_ms, host_ms = device_and_host_ms(torch, fn)
    return {
        "shape": {"n": n, "ng": ng, "mask_on": masked,
                  "outputs": [[str(columns[c].dtype), "min" if is_min else "max"] for c, is_min in outputs]},
        "kernel_device_ms": device_ms,
        "kernel_host_ms": host_ms,
        "kernel_ms": time_ms(torch, fn, 50),
        "plain_ms": time_ms(torch, lambda: ext.grouped_extremes_plain(columns, outputs, gid, mask, ng, counts), 10),
        "library_ms": time_ms(torch, library, 10),
        "bound_ms": hbm_ms(n * (4 + 1 + col_bytes) + out_bytes),
        "bound_data_ms": hbm_ms(n + masked * (4 + col_bytes) + out_bytes),
    }


# ---------------------------------------------------------------------------
# phase 2c: the f32 sum / presence kernel against its plain versions
# ---------------------------------------------------------------------------


def sum_f32_cases(torch):
    """(name, values or None, gid, mask, ng, expect_shared)."""
    rng = np.random.default_rng(3)
    f32, i32, b = torch.float32, torch.int32, torch.bool
    n, n2 = 4_194_304, 1 << 20
    gid = _tensor(torch, rng.integers(0, 4375, n), i32)
    mask = _tensor(torch, rng.random(n) < 0.7, b)
    vals = _tensor(torch, rng.uniform(-100, 100, n), f32)
    gid2 = _tensor(torch, rng.integers(0, 256, n2), i32)
    ogid = _tensor(torch, rng.integers(-3, 300, n2), i32)
    mask2 = _tensor(torch, rng.random(n2) < 0.8, b)
    none = _tensor(torch, np.zeros(n2, bool), b)
    x = rng.uniform(-100, 100, n2)
    x[rng.random(n2) < 0.0001] = np.nan  # a non-finite value stays in its own group
    x[rng.random(n2) < 0.0001] = np.inf
    big_gid = _tensor(torch, rng.integers(0, 1 << 20, n), i32)
    return [
        ("q4_shape_sum", vals, gid, mask, 4608, True),
        ("q4_shape_count", None, gid, mask, 4608, True),
        ("engine_ng256_sum", _tensor(torch, rng.uniform(-100, 100, n2), f32), gid2, mask2, 256, True),
        ("empty_mask_sum", _tensor(torch, x, f32), gid2, none, 256, True),
        ("empty_mask_count", None, gid2, none, 256, True),
        ("out_of_range_sum", _tensor(torch, rng.uniform(-100, 100, n2), f32), ogid, mask2, 256, True),
        ("out_of_range_count", None, ogid, mask2, 256, True),
        ("non_finite_sum", _tensor(torch, x, f32), gid2, mask2, 256, True),
        ("ng_2^20_global_sum", vals, big_gid, mask, 1 << 20, False),
        ("ng_2^20_global_count", None, big_gid, mask, 1 << 20, False),
    ]


def presence_cases(torch):
    """(name, id columns, pads, mask, gid or None, ng, expect_shared): the
    main path's shapes at configs 6-7's real mask (0.066% of the docs:
    config 6 grouped, ng 256, pad 32; config 7 two scalar columns of pad 32
    in one call, and one of them alone, the parent's one call), Q4's shape,
    the same shapes at an off-path 70% mask, and the edges."""
    rng = np.random.default_rng(4)
    i32, b = torch.int32, torch.bool
    n = 4_194_304
    ids = _tensor(torch, rng.integers(0, 25, n), i32)
    ids2 = _tensor(torch, rng.integers(0, 25, n), i32)
    mask = _tensor(torch, rng.random(n) < 0.7, b)
    sparse = _tensor(torch, rng.random(n) < 0.00066, b)
    q4_gid = _tensor(torch, rng.integers(0, 4375, n), i32)
    egid = _tensor(torch, rng.integers(0, 175, n), i32)
    none = _tensor(torch, np.zeros(n, bool), b)
    oids = _tensor(torch, rng.integers(-2, 40, n), i32)  # ids outside [0, 32): dropped
    ogid = rng.integers(-3, 300, n)
    ogid[::97] = np.iinfo(np.int32).max
    ogid = _tensor(torch, ogid, i32)
    big_ids = _tensor(torch, rng.integers(0, 1000, n), i32)
    big_gid = _tensor(torch, rng.integers(0, 1 << 14, n), i32)
    ids33 = _tensor(torch, rng.integers(-1, 35, n), i32)  # pad 33: two flag words a group
    nine = [_tensor(torch, rng.integers(0, 1 << (j + 1), n), i32) for j in range(9)]
    n3 = n - 3  # n % 4 = 1: a one-doc tail
    return [
        ("config6_shape", [ids], [32], sparse, egid, 256, True),
        ("config7_shape", [ids, ids2], [32, 32], sparse, None, 1, True),
        ("config7_one_column", [ids], [32], sparse, None, 1, True),
        ("q4_shape_grouped_pad32", [ids], [32], mask, q4_gid, 4608, True),
        ("q4_shape_scalar_pad32", [ids], [32], mask, None, 1, True),
        ("off_path_ng256_pad32_70pct", [ids], [32], mask, egid, 256, True),
        ("off_path_scalar_two_columns_70pct", [ids, ids2], [32, 32], mask, None, 1, True),
        ("empty_mask_grouped", [ids], [32], none, egid, 256, True),
        ("empty_mask_scalar_two_columns", [ids, ids2], [32, 32], none, None, 1, True),
        ("out_of_range_grouped", [oids, ids33], [32, 33], mask, ogid, 256, True),
        ("out_of_range_scalar", [oids, ids], [32, 16], mask, None, 1, True),
        ("pad33_and_pad8_grouped", [ids33, ids], [33, 8], sparse, egid, 256, True),
        ("nine_columns_two_launches", nine, [1 << (j + 1) for j in range(9)], mask, egid, 256, True),
        ("cells_2^24_global", [big_ids], [1024], mask, big_gid, 1 << 14, False),
        ("global_pad1024_and_pad32", [big_ids, ids], [1024, 32], mask, big_gid, 1 << 14, False),
        ("tail_of_1_doc", [ids[:n3], ids2[:n3]], [32, 32], mask[:n3], egid[:n3], 256, True),
        ("unaligned_views", [ids[1:], ids2[1:]], [32, 32], mask[1:], egid[1:], 256, True),
    ]


def check_sum_f32(torch, gs) -> dict:
    results, max_err, keep = [], 0.0, {}
    for name, values, gid, mask, ng, expect_shared in sum_f32_cases(torch):
        shared = gs.uses_shared(ng * 4, gid.device)
        if shared != expect_shared:
            raise AssertionError(f"{name}: shared-memory path {shared}, expected {expect_shared}")
        got = gs.grouped_sum_kernel(values, gid, mask, ng)
        torch.cuda.synchronize()
        want = gs.grouped_sum_plain(values, gid, mask, ng)
        if values is None:  # counts: exact
            ok = same(torch, got, want)
        else:
            ok = bool(torch.allclose(got, want, rtol=1e-4, atol=1e-2, equal_nan=True))
            ok &= bool(torch.equal(got.isnan(), want.isnan()))
        err = abs_err(torch, got, want)
        max_err = max(max_err, err)
        results.append({"case": name, "ng": ng, "n": gid.numel(), "shared": shared, "max_abs_err": err, "ok": ok})
        if not ok:
            raise AssertionError(f"{name}: grouped_sum_f32 kernel != plain version (max abs err {err})")
        keep[name] = (values, gid, mask, ng)
    for name, columns, pads, mask, gid, ng, expect_shared in presence_cases(torch):
        grouped = gid is not None
        shared = gs.uses_shared_flags(pads[: gs.MAX_COLS], ng, mask.device, grouped)
        if shared != expect_shared:
            raise AssertionError(f"{name}: shared flags {shared}, expected {expect_shared}")
        before = gs.presence.launches
        got = gs.presences_kernel(columns, pads, mask, gid, ng)
        torch.cuda.synchronize()
        launches = gs.presence.launches - before
        if launches != -(-len(columns) // gs.MAX_COLS):
            raise AssertionError(f"{name}: {launches} presence launches for {len(columns)} columns")
        want = gs.presences_plain(columns, pads, mask, gid, ng)
        equal = all(same(torch, g, w) for g, w in zip(got, want)) and len(got) == len(want)
        results.append(
            {"case": name, "pads": pads, "ng": ng, "n": mask.numel(), "shared": shared, "launches": launches,
             "present": [int(g.sum().item()) for g in got], "equal": equal}
        )
        if not equal:
            raise AssertionError(f"{name}: presence kernel != plain version")
        keep[name] = (columns, pads, mask, gid, ng)
    emit({"phase": "kernel_vs_plain", "kernel": "grouped_sum_f32", "cases": results})

    timings = {}
    values, gid, mask, ng = keep["q4_shape_sum"]
    n, masked = gid.numel(), int(mask.sum().item())
    ok, idx = _in_range(torch, gid, mask, ng)
    src = torch.where(ok, values, 0.0)
    dst = torch.zeros(ng, dtype=torch.float32, device=gid.device)
    fn = lambda: gs.grouped_sum_kernel(values, gid, mask, ng)  # noqa: E731
    device_ms, host_ms = device_and_host_ms(torch, fn)
    timings["q4_shape_sum"] = {
        "shape": {"n": n, "ng": ng},
        "kernel_device_ms": device_ms,
        "kernel_host_ms": host_ms,
        "kernel_ms": time_ms(torch, fn, 50),
        "plain_ms": time_ms(torch, lambda: gs.grouped_sum_plain(values, gid, mask, ng), 20),
        "library_ms": time_ms(torch, lambda: dst.index_add_(0, idx, src), 20),
        "bound_ms": hbm_ms(n * (4 + 1 + 4) + 4 * ng),
        "bound_data_ms": hbm_ms(n + masked * (4 + 4) + 4 * ng),
    }
    # the main path's shapes (configs 6 and 7 at their real mask; config 7's
    # two columns in one launch, and one column alone), then off the path:
    # Q4's grouped shape and a 70% mask
    for name in ("config6_shape", "config7_shape", "config7_one_column", "q4_shape_grouped_pad32",
                 "off_path_ng256_pad32_70pct", "off_path_scalar_two_columns_70pct"):
        timings[name] = _b4_timing(torch, gs, *keep[name])
    emit({"phase": "kernel_timing", "kernel": "grouped_sum_f32", "timings": timings, "card": card_line()})
    return {"max_abs_err": max_err, **timings["config6_shape"]}


def _b4_timing(torch, gs, columns, pads, mask, gid, ng) -> dict:
    """Device time alone, the host's enqueue and the span of one presences
    call, the plain version's time, the library's (one scatter_reduce_ amax
    a column, summed) and the bounds."""
    n, masked = mask.numel(), int(mask.sum().item())
    scatter = []
    for ids, pad in zip(columns, pads):
        ok = mask & (ids >= 0) & (ids < pad)
        cell = ids.to(torch.int64)
        if gid is not None:
            ok &= (gid >= 0) & (gid < ng)
            cell = gid.to(torch.int64) * pad + cell
        scatter.append((torch.zeros(ng * pad, dtype=torch.uint8, device=mask.device), torch.where(ok, cell, 0),
                        ok.to(torch.uint8)))

    def library():
        for dst, idx, src in scatter:
            dst.scatter_reduce_(0, idx, src, reduce="amax")

    # each doc's mask byte; a masked doc's ids (and group id); the flags once
    per_doc = 4 * len(columns) + (4 if gid is not None else 0)
    out_bytes = ng * sum(pads)
    fn = lambda: gs.presences_kernel(columns, pads, mask, gid, ng)  # noqa: E731
    device_ms, host_ms = device_and_host_ms(torch, fn)
    return {
        "shape": {"n": n, "ng": ng, "pads": pads, "mask_on": masked},
        "kernel_device_ms": device_ms,
        "kernel_host_ms": host_ms,
        "kernel_ms": time_ms(torch, fn, 50),
        "plain_ms": time_ms(torch, lambda: gs.presences_plain(columns, pads, mask, gid, ng), 20),
        "library_ms": time_ms(torch, library, 20),
        "bound_ms": hbm_ms(n * (per_doc + 1) + out_bytes),
        "bound_data_ms": hbm_ms(n + masked * per_doc + out_bytes),
    }


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def make_ssb_data(n: int, seed: int = 0):
    """bench.py's SSB-flavoured lineorder generator (same draws, same order),
    then the customer and supplier keys drawn after them, so configs 1-7 see
    bench.py's data; also returns the dictionary codes the oracle groups by."""
    rng = np.random.default_rng(seed)
    year = rng.integers(1992, 1999, n).astype(np.int32)
    nation = rng.integers(0, 25, n)
    category = rng.integers(0, 25, n)
    data = {
        "d_year": year,
        "c_nation": np.array(NATIONS, dtype=object)[nation],
        "p_category": np.array(CATEGORIES, dtype=object)[category],
        "lo_revenue": rng.integers(100, 600_000, n).astype(np.int64),
        "lo_supplycost": rng.integers(50, 100_000, n).astype(np.int64),
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
    }
    data["lo_custkey"] = rng.integers(1, N_CUSTOMERS + 1, n).astype(np.int32)
    data["lo_suppkey"] = rng.integers(1, N_SUPPLIERS + 1, n).astype(np.int32)
    return data, nation, category


def q2_rows(data, nation) -> list:
    """bench.py's Q2 (config 2): filtered SUM / MIN / MAX / AVG."""
    year, qty, rev, cost = data["d_year"], data["lo_quantity"], data["lo_revenue"], data["lo_supplycost"]
    m = (year >= 1994) & (year <= 1996) & (nation == 3)
    return [[float(rev[m].sum()), float(qty[m].min()), float(rev[m].max()), float(cost[m].sum()) / int(m.sum())]]


def q4_rows(data, nation, category) -> list:
    """bench.py's Q4 (config 4): the top 10 (year, nation, category) groups
    by profit."""
    year, qty, rev, cost = data["d_year"], data["lo_quantity"], data["lo_revenue"], data["lo_supplycost"]
    m = (qty > 5) & (year >= 1993) & (year <= 1997)
    key = (year[m].astype(np.int64) - 1992) * 625 + nation[m] * 25 + category[m]
    sums = np.bincount(key, weights=(rev[m] - cost[m]).astype(np.float64), minlength=7 * 625)
    cnt = np.bincount(key, minlength=7 * 625)
    present = np.flatnonzero(cnt)
    top = present[np.argsort(-sums[present], kind="stable")][:10]
    return [[1992 + int(g // 625), NATIONS[int(g // 25 % 25)], CATEGORIES[int(g % 25)], float(sums[g])] for g in top]


def oracle(data, nation, category) -> tuple[dict, dict]:
    """(rows of each config, groups in all of configs 8 and 9)."""
    year, qty = data["d_year"], data["lo_quantity"]
    rev, cost = data["lo_revenue"], data["lo_supplycost"]
    out = {"1_count_filter": [[int((nation == 7).sum())]]}

    out["2_filtered_agg"] = q2_rows(data, nation)

    m = ((nation == 1) | (nation == 2)) & (qty < 25)
    yi = year[m] - 1992
    sums = np.bincount(yi, weights=rev[m], minlength=7)  # exact: integer partials < 2^53
    cnt = np.bincount(yi, minlength=7)
    out["3_q1_groupby"] = [[1992 + y, float(sums[y])] for y in range(7) if cnt[y]][:20]

    out["4_q4_groupby_orderby"] = q4_rows(data, nation, category)

    m = (qty > 5) & (year >= 1993) & (year <= 1997)
    key = (year[m].astype(np.int64) - 1992) * 25 + nation[m]  # (d_year, c_nation): NATION_xx sort by index
    order = np.argsort(key, kind="stable")
    k = key[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])

    def per_group(v, ufunc):
        return ufunc.reduceat(v[m][order], starts)

    cost = data["lo_supplycost"]
    ratio = rev.astype(np.float64) / qty.astype(np.float64)  # IEEE division, as on the card
    counts = np.diff(np.r_[starts, len(k)])
    mins_q = per_group(qty, np.minimum)
    maxs_r = per_group(rev, np.maximum)
    range_c = per_group(cost, np.maximum) - per_group(cost, np.minimum)
    maxs_ratio = per_group(ratio, np.maximum)
    out["5_groupby_minmax"] = [
        [1992 + int(g // 25), NATIONS[int(g % 25)], int(c), float(a), float(b), float(r), float(x)]
        for g, c, a, b, r, x in zip(k[starts], counts, mins_q, maxs_r, range_c, maxs_ratio)
    ][:200]

    m = (qty == 1) & (rev < 20000)
    key = (year[m].astype(np.int64) - 1992) * 25 + category[m]
    cnt = np.bincount(key, minlength=7 * 25)
    distinct = np.bincount(np.unique(key * 25 + nation[m]) // 25, minlength=7 * 25)
    present = sorted(np.flatnonzero(cnt), key=lambda g: (g // 25, CATEGORIES[g % 25]))  # ORDER BY the strings
    out["6_groupby_distinct"] = [
        [1992 + int(g // 25), CATEGORIES[int(g % 25)], int(cnt[g]), int(distinct[g])] for g in present
    ][:200]
    out["7_distinct"] = [[len(np.unique(nation[m])), len(np.unique(category[m])), float(rev[m].min())]]

    cust, supp = data["lo_custkey"], data["lo_suppkey"]
    m = (year >= 1993) & (year <= 1997)
    sums = np.bincount(cust[m], weights=rev[m], minlength=N_CUSTOMERS + 1)  # exact: integer partials < 2^53
    cnt = np.bincount(cust[m], minlength=N_CUSTOMERS + 1)
    present = np.flatnonzero(cnt)
    top = present[np.lexsort((present, -sums[present]))][:10]
    out["8_groupby_wide"] = [[int(c), float(sums[c]), int(cnt[c])] for c in top]

    m = (year == 1997) & (qty <= 5)
    pairs, inv = np.unique(cust[m].astype(np.int64) * (N_SUPPLIERS + 1) + supp[m], return_inverse=True)
    sums = np.bincount(inv, weights=rev[m])
    cnt = np.bincount(inv)
    c_of, s_of = pairs // (N_SUPPLIERS + 1), pairs % (N_SUPPLIERS + 1)
    top = np.lexsort((s_of, c_of, -sums))[:10]
    out["9_groupby_sparse"] = [[int(c_of[g]), int(s_of[g]), float(sums[g]), int(cnt[g])] for g in top]

    # ties by revenue go by segment, then by doc: by global doc order
    docs = np.flatnonzero(year == 1995)
    top = docs[np.lexsort((docs, -rev[docs]))][:20]
    out["11_selection_orderby"] = [[int(cust[i]), NATIONS[nation[i]], int(rev[i])] for i in top]
    m = qty < 3
    yn = np.unique((year[m].astype(np.int64) - 1992) * 25 + nation[m])
    yn = yn[np.lexsort((yn % 25, -(yn // 25)))][:50]  # d_year DESC, c_nation
    out["12_distinct_orderby"] = [[1992 + int(g // 25), NATIONS[int(g % 25)]] for g in yn]
    first = np.flatnonzero(nation == 7)[:10]
    out["13_selection"] = [[int(year[i]), CATEGORIES[category[i]], int(qty[i])] for i in first]
    return out, {"8_groupby_wide": len(present), "9_groupby_sparse": len(pairs), "11_matched": len(docs)}


def host_oracle(data, nation, category, small) -> dict:
    """Rows of configs 14-16; `small` is config 16's fifth segment's data."""
    year, qty = data["d_year"], data["lo_quantity"]
    rev, cost = data["lo_revenue"], data["lo_supplycost"]
    out = {}
    m = year == 1995
    cnt = np.bincount(qty[m], minlength=51)
    rsum = np.bincount(qty[m], weights=rev[m], minlength=51)  # exact: integer partials < 2^53
    csum = np.bincount(qty[m], weights=cost[m], minlength=51)
    out["14_groupby_raw_metric"] = [
        [int(q), int(cnt[q]), float(rsum[q]), float(csum[q]) / int(cnt[q])] for q in np.flatnonzero(cnt)
    ][:50]

    rows = []
    for y in range(1992, 1999):
        g = (nation == 3) & (year == y)
        if not g.any():
            continue
        r = np.sort(rev[g].astype(np.float64))
        vals, counts = np.unique(qty[g], return_counts=True)
        rows.append(
            [
                y,
                float(r[int((len(r) - 1) * 95 / 100.0)]),  # exact_percentile: the value at (n-1)*pct/100
                float(vals[np.flatnonzero(counts == counts.max())[0]]),  # MODE ties go to the smallest value
                float(np.std(cost[g].astype(np.float64))),
                int(g.sum()),
            ]
        )
    out["15_host_aggregations"] = rows[:10]

    keys, custs = [], []
    for d, n_, c_ in ((data, nation, category), small):
        m = d["d_year"] == 1997
        keys.append(n_[m].astype(np.int64) * 25 + c_[m])
        custs.append(d["lo_custkey"][m].astype(np.int64))
    key, cust = np.concatenate(keys), np.concatenate(custs)
    cnt = np.bincount(key, minlength=625)
    distinct = np.bincount(np.unique(key * (N_CUSTOMERS + 1) + cust) // (N_CUSTOMERS + 1), minlength=625)
    present = sorted(np.flatnonzero(cnt), key=lambda g: (-distinct[g], NATIONS[g // 25], CATEGORIES[g % 25]))
    out["16_mixed_executors"] = [
        [NATIONS[int(g // 25)], CATEGORIES[int(g % 25)], int(cnt[g]), int(distinct[g])] for g in present
    ][:20]
    return out


def null_mask(year: np.ndarray) -> np.ndarray:
    """Config 21's nulls of lo_supplycost: a seeded NULL_SHARE of the rows and
    every row of NULL_YEAR."""
    return (year == NULL_YEAR) | (np.random.default_rng(NULL_SEED).random(len(year)) < NULL_SHARE)


def _est(v: np.ndarray, lo: float, hi: float, pct: float) -> float:
    """PERCENTILEEST of `v` over the global bounds [lo, hi]: 4096 fixed bins,
    the bin holding rank (n-1)*pct/100, its midpoint."""
    if len(v) == 0:
        return float("-inf")
    b = np.clip(np.floor((v.astype(np.float64) - lo) * (4096 / (hi - lo))), 0, 4095).astype(np.int64)
    cum = np.cumsum(np.bincount(b, minlength=4096))
    return float(lo + (int(np.searchsorted(cum, int((len(v) - 1) * pct / 100.0) + 1)) + 0.5) * ((hi - lo) / 4096))


def tag_oracle(data, nation) -> dict:
    """Rows of configs 17-21."""
    year, qty = data["d_year"], data["lo_quantity"]
    rev, cost, cust = data["lo_revenue"], data["lo_supplycost"], data["lo_custkey"]
    out = {}
    rows = []
    for k in range(25):
        m = nation == k
        r97, r96, c97 = rev[m & (year == 1997)], rev[m & (year == 1996)], cost[m & (year == 1997)]
        rows.append([NATIONS[k], float(r97.sum()), float(r96.sum()), int((m & (qty > 40)).sum()),
                     float(c97.max()) if len(c97) else float("-inf"), int(m.sum())])
    out["17_filter_where"] = rows

    m = np.isin(qty, [1, 5, 10, 20, 30, 40, 50]) & (rev > cost * 3)
    band = np.where(qty <= 10, rev.astype(np.float64), np.where(qty <= 30, rev / 2.0, 0.0))
    out["18_case_in_cmp_fn"] = [
        [y, float(band[m & (year == y)].sum()), float(np.sqrt(cost[m & (year == y)].astype(np.float64)).max()),
         int((m & (year == y)).sum())]
        for y in range(1992, 1999) if (m & (year == y)).any()
    ]  # the sums are of halves below 2^52: exact in any order

    m = nation == 5
    bounds = [(float(v.min()), float(v.max())) for v in (rev, cost)]  # the engine's global bounds

    def est(sel):
        return [_est(v[sel], lo, hi, pct) for v, (lo, hi), pct in zip((rev, cost), bounds, (90, 50))]

    out["19_percentileest"] = [[y] + est(m & (year == y)) for y in range(1992, 1999) if (m & (year == y)).any()]
    out["19_percentileest_scalar"] = [est(m)]

    m = nation == 11
    steps = [set(np.unique(cust[m & (year == y)]).tolist()) for y in (1995, 1996, 1997)]
    out["20_funnelcount"] = [[[len(steps[0]), len(steps[0] & steps[1]), len(steps[0] & steps[1] & steps[2])]]]

    null = null_mask(year)
    passed = (~null & (cost > 90000)) | (nation == 3)  # Kleene: a null cost is unknown, not false
    rows = []
    for y in range(1992, 1999):
        g = passed & (year == y)
        if not g.any():
            continue
        v = cost[g & ~null]
        rows.append([y, float(v.sum()) if len(v) else None, len(v), float(v.min()) if len(v) else None,
                     float(v.sum()) / len(v) if len(v) else None, int(g.sum())])
    out["21_null_kleene"] = rows
    out["21_null_docmask"] = [[int((null & (year == 1995)).sum())]]
    return out


# ---------------------------------------------------------------------------
# configs 22-27: multi-value columns
# ---------------------------------------------------------------------------


def make_mv_data(n: int, seed: int = 22) -> dict:
    """The `mvt` table as codes: SV year, region (index into MV_REGIONS),
    revenue; each MV column as its per-doc value counts (`*_lens`) and flat
    values (tag index, num), drawn vectorised."""
    rng = np.random.default_rng(seed)
    data = {
        "year": rng.integers(1992, 1999, n).astype(np.int32),
        "region": rng.integers(0, len(MV_REGIONS), n).astype(np.int32),
        "revenue": rng.integers(0, 1_000_000, n).astype(np.int32),
        "tags_lens": rng.integers(0, 5, n).astype(np.int32),
        "nums_lens": rng.integers(0, 5, n).astype(np.int32),
    }
    zipf = np.cumsum(1.0 / np.arange(1, N_TAGS + 1))
    u = rng.random(int(data["tags_lens"].sum())) * zipf[-1]
    data["tags"] = np.minimum(np.searchsorted(zipf, u, side="right"), N_TAGS - 1).astype(np.int32)
    data["nums"] = rng.integers(0, 100, int(data["nums_lens"].sum())).astype(np.int32)
    return data


def mv_schema():
    from pinot_tpu_torch.common import DataType, FieldSpec, Schema

    schema = Schema.build("mvt", dimensions=[("year", DataType.INT), ("region", DataType.STRING)],
                          metrics=[("revenue", DataType.INT)])
    schema.add(FieldSpec("tags", DataType.STRING, single_value=False))
    schema.add(FieldSpec("nums", DataType.INT, single_value=False))
    return schema


def mv_segment(data: dict, offsets: dict, name: str, lo: int, hi: int):
    """Docs [lo, hi) of the table as a segment, through segment_from_numpy:
    dictionaries over the present codes, the MV columns flat with lens
    (`offsets`: each MV column's mv_offsets)."""
    from pinot_tpu_torch.common import DataType
    from pinot_tpu_torch.segment import segment_from_numpy
    from pinot_tpu_torch.segment.dictionary import Dictionary
    from pinot_tpu_torch.segment.stats import ColumnStats

    schema = mv_schema()
    cols = {}

    def dict_column(col, dt, codes, values, lens=None):
        # codes index the sorted `values`: the present ones, renumbered
        seen = np.bincount(codes, minlength=len(values)) > 0
        ids = (np.cumsum(seen, dtype=np.int32) - 1)[codes]
        vals = values[seen]
        stats = ColumnStats.from_dictionary(col, dt, ids, Dictionary(dt, vals))
        cols[col] = {"forward": ids, "dictionary": vals, "stats": stats.to_dict()}
        if lens is not None:
            cols[col]["lens"] = lens

    dict_column("year", DataType.INT, data["year"][lo:hi] - 1992, np.arange(1992, 1999, dtype=np.int32))
    dict_column("region", DataType.STRING, data["region"][lo:hi], np.array(MV_REGIONS, dtype=object))
    rev = data["revenue"][lo:hi]
    stats = ColumnStats.collect("revenue", DataType.INT, rev, len(np.unique(rev)))
    cols["revenue"] = {"forward": rev, "dictionary": None, "stats": stats.to_dict()}
    for col, values, dt in (("tags", np.array([f"tag{i:04d}" for i in range(N_TAGS)], dtype=object), DataType.STRING),
                            ("nums", np.arange(100, dtype=np.int32), DataType.INT)):
        off = offsets[col]
        dict_column(col, dt, data[col][off[lo] : off[hi]], values, data[f"{col}_lens"][lo:hi])
    return segment_from_numpy({"name": name, "schema": schema.to_json(), "n_docs": hi - lo, "columns": cols})


def mv_offsets(data: dict, col: str) -> np.ndarray:
    off = np.zeros(len(data[f"{col}_lens"]) + 1, dtype=np.int64)
    np.cumsum(data[f"{col}_lens"], out=off[1:])
    return off


def mv_engine(data: dict):
    """MV_SEGMENTS segments of the `mvt` table and a QueryEngine over them
    on the card, and the seconds the build took."""
    from pinot_tpu_torch.query import QueryEngine

    t0 = time.perf_counter()
    n = len(data["year"])
    per = n // MV_SEGMENTS
    offsets = {c: mv_offsets(data, c) for c in ("tags", "nums")}
    segments = in_threads(
        lambda i: mv_segment(data, offsets, f"mvt_{i}", i * per, (i + 1) * per if i < MV_SEGMENTS - 1 else n),
        range(MV_SEGMENTS),
    )
    return QueryEngine(segments, device="cuda"), segments, time.perf_counter() - t0


def mv_oracle(data: dict) -> dict:
    """Rows of configs 22-27 from the raw flat arrays: each flat value
    position counts once (a value twice in one doc counts twice)."""
    year, rev, tags, nums = data["year"], data["revenue"], data["tags"], data["nums"]
    n = len(year)
    tag_doc = np.repeat(np.arange(n, dtype=np.int32), data["tags_lens"])
    num_doc = np.repeat(np.arange(n, dtype=np.int32), data["nums_lens"])
    names = [f"tag{i:04d}" for i in range(N_TAGS)]

    def any_doc(doc_of, flat_mask):
        return np.bincount(doc_of[flat_mask], minlength=n) > 0

    out = {}
    has42 = any_doc(tag_doc, tags == 42)
    out["22_tag_search"] = [[int(has42.sum()), float(rev[has42].sum(dtype=np.int64))]]
    m = ~any_doc(tag_doc, (tags == 1) | (tags == 7)) & (year >= 1995)
    out["22_tag_exclusion"] = [[int(m.sum()), float(rev[m].sum(dtype=np.int64))]]
    two = any_doc(num_doc, nums > 95) & any_doc(num_doc, nums < 3)
    out["22_two_values"] = [[int(two.sum())]]
    if not two.any():
        raise AssertionError("22_two_values: the oracle's count is 0")

    def totals(v):
        s = int(v.sum(dtype=np.int64))
        return [len(v), float(s), float(v.min()), float(v.max()), s / len(v)]

    in97 = (year == 1997)
    out["23_mv_totals"] = [totals(nums[in97[num_doc]]) + [len(np.unique(tags[in97[tag_doc]]))]]
    out["24_mv_totals_by_year"] = [[y] + totals(nums[year[num_doc] == y]) for y in range(1992, 1999)]

    sel = year[tag_doc] >= 1995
    t, r = tags[sel], rev[tag_doc[sel]]
    count = np.bincount(t, minlength=N_TAGS)
    total = np.bincount(t, weights=r, minlength=N_TAGS)
    top = np.full(N_TAGS, -1, dtype=np.int64)
    np.maximum.at(top, t, r)
    order = sorted(np.flatnonzero(count), key=lambda i: (-count[i], i))[:20]
    out["25_top_tags"] = [[names[i], int(count[i]), float(total[i]), float(top[i])] for i in order]
    out["25_distinct_tags"] = [[names[i]] for i in np.unique(tags[year[tag_doc] == 1998])[:50]]

    # every doc's (tag, num) pairs, a slice of docs at a time
    pairs = np.zeros(N_TAGS * 100, dtype=np.int64)
    pair_years = np.zeros(N_TAGS * 100, dtype=np.int64)
    t_off, n_off = mv_offsets(data, "tags"), mv_offsets(data, "nums")
    for lo in range(0, n, 1 << 20):
        hi = min(n, lo + (1 << 20))
        pos = np.arange(t_off[lo], t_off[hi])
        doc = tag_doc[pos]
        ln = data["nums_lens"][doc].astype(np.int64)
        rep = np.repeat(np.arange(len(pos)), ln)
        within = np.arange(len(rep)) - np.repeat(np.cumsum(ln) - ln, ln)
        key = tags[pos][rep].astype(np.int64) * 100 + nums[n_off[doc][rep] + within]
        pairs += np.bincount(key, minlength=N_TAGS * 100)
        pair_years += np.bincount(key, weights=year[doc][rep], minlength=N_TAGS * 100).astype(np.int64)
    order = sorted(np.flatnonzero(pairs), key=lambda k: (-pairs[k], k))[:20]
    out["26_tag_num_pairs"] = [[names[k // 100], int(k % 100), int(pairs[k]), float(pair_years[k])] for k in order]

    docs = np.flatnonzero(has42 & (year == 1996))[:10].tolist()
    out["27_ragged_selection"] = [
        [[names[i] for i in tags[t_off[d] : t_off[d + 1]]], nums[n_off[d] : n_off[d + 1]].tolist(), int(year[d])]
        for d in docs
    ]
    tag_year = year[tag_doc]
    out["27_distinctcountmv_by_year"] = [[y, len(np.unique(tags[tag_year == y]))] for y in range(1992, 1999)]
    doc_sum = np.bincount(num_doc, weights=nums, minlength=n)
    per_tag = np.bincount(tags, weights=doc_sum[tag_doc], minlength=N_TAGS)
    present = np.flatnonzero(np.bincount(tags, minlength=N_TAGS))[:20]
    out["27_mv_agg_under_mv_key"] = [[names[i], float(per_tag[i])] for i in present]
    return out


def rows_match(name: str, got: list, want: list) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} rows, oracle {len(want)}")
    approx = APPROX_COLUMNS.get(name, ())
    for r, (g, w) in enumerate(zip(got, want)):
        for c, (a, b) in enumerate(zip(g, w)):
            # float quotients and moments: 1e-12 relative; everything else
            # exact (MIN/MAX of the float64 quotient too: both sides divide
            # with IEEE rounding)
            same = math.isclose(a, b, rel_tol=1e-12) if c in approx else a == b
            if not same or type(a) is not type(b):
                raise AssertionError(f"{name} row {r} col {c}: got {a!r}, oracle {b!r}")


def ssb_schema(name: str = "lineorder", keys: bool = True, ts: bool = False, primary_key=()):
    """The lineorder schema: bench.py's six columns, and with `keys` the
    customer and supplier keys; with `ts` a LONG time column `ts` (the
    realtime tables' arrival index) and the given primary-key columns."""
    from pinot_tpu_torch.common import DataType, Schema

    dims = [("d_year", DataType.INT), ("c_nation", DataType.STRING), ("p_category", DataType.STRING)]
    if keys:
        dims += [("lo_custkey", DataType.INT), ("lo_suppkey", DataType.INT)]
    return Schema.build(
        name,
        dimensions=dims,
        metrics=[("lo_revenue", DataType.LONG), ("lo_supplycost", DataType.LONG), ("lo_quantity", DataType.INT)],
        date_times=[("ts", DataType.LONG)] if ts else (),
        primary_key_columns=list(primary_key),
    )


def ssb_builder(name: str = "lineorder", null_handling: bool = False):
    """The package's SegmentBuilder for the lineorder schema (with null
    vectors kept, under `null_handling`)."""
    from pinot_tpu_torch.common import IndexingConfig, TableConfig
    from pinot_tpu_torch.segment import SegmentBuilder

    return SegmentBuilder(ssb_schema(name), TableConfig(name, IndexingConfig(null_handling=null_handling)))


def in_threads(fn, items) -> list:
    """fn(item) for each item on 4 threads, the results in order: the
    segment builds' numpy sorts release the GIL, and each build's inputs are
    its own."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:
        return list(pool.map(fn, items))


def ssb_engine(data: dict):
    """N_SEGMENTS segments of `data` and a QueryEngine over them on the card,
    from the pinot_tpu_torch first on the path, and the seconds the build
    took."""
    from pinot_tpu_torch.query import QueryEngine

    t0 = time.perf_counter()
    segments = build_segments(ssb_builder(), data, N_SEGMENTS, "lineorder")
    return QueryEngine(segments, device="cuda"), segments, time.perf_counter() - t0


def null_engine_of(data: dict):
    """Config 21's table: N_SEGMENTS segments of `data` named lineorder_n,
    lo_supplycost None where null_mask says, built with null vectors; a
    QueryEngine over them on the card, and the seconds the build took."""
    from pinot_tpu_torch.query import QueryEngine

    t0 = time.perf_counter()
    per = N_ROWS // N_SEGMENTS
    null = null_mask(data["d_year"])
    builder = ssb_builder("lineorder_n", null_handling=True)

    def one(i):
        part = {c: v[i * per : (i + 1) * per] for c, v in data.items()}
        cost = part["lo_supplycost"].astype(object)
        cost[null[i * per : (i + 1) * per]] = None
        part["lo_supplycost"] = cost
        return builder.build(part, f"lineorder_n_{i}")

    segments = in_threads(one, range(N_SEGMENTS))
    return QueryEngine(segments, device="cuda"), segments, time.perf_counter() - t0


def wall_p50(engine, sql: str, warm: int = 2, runs: int = WALL_RUNS) -> dict:
    """Host-clock ms of `runs` executes of `sql` after `warm` warm-ups, each
    ending in the device->host copies, and their median."""
    return wall_p50_of(lambda: engine.execute(sql), warm, runs)


def wall_p50_of(fn, warm: int = 2, runs: int = WALL_RUNS) -> dict:
    for _ in range(warm):
        fn()
    ms = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"p50_ms": float(np.median(ms)), "runs_ms": ms}


# ---------------------------------------------------------------------------
# config 10: BASELINE config 5, a star tree and DISTINCTCOUNTHLL
# ---------------------------------------------------------------------------


def make_events(n: int, seed: int = 0) -> dict:
    """bench.py's `events` table: _bench_config5's draws, in its column order."""
    rng = np.random.default_rng(seed)
    return {
        "country": np.array([f"C{i:02d}" for i in range(30)], dtype=object)[rng.integers(0, 30, n)],
        "device": np.array(["phone", "desktop", "tablet"], dtype=object)[rng.integers(0, 3, n)],
        "user_id": rng.integers(0, 5_000_000, n).astype(np.int64),
        "impressions": rng.integers(1, 1000, n).astype(np.int64),
    }


def events_segment(data: dict):
    """One segment of `data` with bench.py's star tree on (country, device),
    that star-tree config, and the seconds the build took."""
    from pinot_tpu_torch.common import DataType, IndexingConfig, Schema, StarTreeIndexConfig, TableConfig
    from pinot_tpu_torch.segment import SegmentBuilder

    schema = Schema.build(
        "events",
        dimensions=[("country", DataType.STRING), ("device", DataType.STRING), ("user_id", DataType.LONG)],
        metrics=[("impressions", DataType.LONG)],
    )
    star = StarTreeIndexConfig(["country", "device"], ["SUM__impressions", "COUNT__*"])
    t0 = time.perf_counter()
    seg = SegmentBuilder(schema, TableConfig("events", IndexingConfig(star_tree_configs=[star]))).build(data, "s0")
    return seg, star, time.perf_counter() - t0


def events_oracle(data: dict) -> dict:
    """Config 10's answers: the star query's rows (exact integer sums), the
    star table's rows (distinct (country, device) pairs), the exact distinct
    count of user_id and its HLL registers from np_hll_registers."""
    from pinot_tpu_torch.query.sketches import np_hll_registers

    names, country = np.unique(data["country"].astype(str), return_inverse=True)
    _, device = np.unique(data["device"].astype(str), return_inverse=True)
    sums = np.bincount(country, weights=data["impressions"])  # exact: integer partials < 2^53
    top = np.argsort(-sums, kind="stable")[:5]
    return {
        "10_star": [[str(names[c]), float(sums[c])] for c in top],
        "star_rows": len(np.unique(country * 3 + device)),
        "distinct_users": len(np.unique(data["user_id"])),
        "registers": np_hll_registers(data["user_id"]),
    }


def drive_config10(engine):
    """bench.py's dev(): both queries submitted before either resolves."""
    r_star, r_hll = engine.submit(CONFIG_10["10_star"]), engine.submit(CONFIG_10["10_hll"])
    return r_star(), r_hll()


def check_config10(engine, seg, want: dict) -> dict:
    """Config 10 against its oracle: the star query's rows exactly, its
    numDocsScanned the star table's rows (the swap ran), the HLL estimate
    within 10% of the exact distinct count (bench.py's check), and the
    registers of the segment's program bit for bit np_hll_registers'."""
    from pinot_tpu_torch.query.kernels import dispatch_plan_packed
    from pinot_tpu_torch.query.plan import plan_segment

    star, hll = drive_config10(engine)
    rows_match("10_star", star.rows, want["10_star"])
    if star.num_docs_scanned != want["star_rows"]:
        raise AssertionError(f"10_star: docsScanned {star.num_docs_scanned}, star table rows {want['star_rows']}")
    est, exact = hll.rows[0][0], want["distinct_users"]
    if type(est) is not int or abs(est - exact) / exact >= 0.1:
        raise AssertionError(f"10_hll: estimate {est!r}, exact distinct count {exact}")
    _, (regs,) = dispatch_plan_packed(plan_segment(seg, engine.make_context(CONFIG_10["10_hll"])),
                                      seg.to_device_cached("cuda"))()
    if regs.dtype != np.int32 or not np.array_equal(regs, want["registers"]):
        cells = int((regs != want["registers"]).sum())
        raise AssertionError(f"10_hll: registers differ from np_hll_registers in {cells} cells")
    return {"star_docs_scanned": star.num_docs_scanned, "hll_estimate": est, "distinct_users": exact,
            "relative_error": (est - exact) / exact, "hll_docs_scanned": hll.num_docs_scanned}


def config10_first_query(torch, engine, seg, star_cfg) -> dict:
    """The costs config 10 pays once, apart from the walls: the star table's
    build (repeated here alone; the segment build made the one in use), the
    hash table of user_id's dictionary (hash_any over its values, as
    Dictionary.hll_hash_pad makes it), and the first submit-and-resolve of
    both queries, which builds and stages the star segment and the hash
    table."""
    from pinot_tpu_torch.query.sketches import hash_any
    from pinot_tpu_torch.segment.startree import build_star_table

    t0 = time.perf_counter()
    st = build_star_table(seg, star_cfg)
    t_star = time.perf_counter() - t0
    t0 = time.perf_counter()
    hashes = hash_any(seg.columns["user_id"].dictionary.values)
    t_hash = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive_config10(engine)
    t_first = time.perf_counter() - t0
    return {"star_table_build_s": t_star, "star_rows": st.n_rows, "hash_table_s": t_hash,
            "hash_table_values": len(hashes), "first_submit_resolve_ms": t_first * 1e3}


# ---------------------------------------------------------------------------
# the new device steps: torch steps of the slice's path, no hand kernel
# ---------------------------------------------------------------------------


def _step_timing(torch, fn, cpu_fn, nbytes: int, library=None) -> dict:
    """The step on the card against the same step on CPU copies (exact),
    device time alone (L2 flushed) and the host's enqueue, the CPU step's
    wall time, one PyTorch call's time and the bytes bound."""
    got = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = cpu_fn()
    cpu_ms = (time.perf_counter() - t0) * 1e3
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        raise AssertionError("the step on the card differs from the same step on the CPU")
    device_ms, host_ms = device_and_host_ms(torch, fn)
    return {
        "equal": True,
        "device_ms": device_ms,
        "host_ms": host_ms,
        "ms": time_ms(torch, fn, 20),
        "plain_cpu_ms": cpu_ms,
        "library_ms": None if library is None else time_ms(torch, library, 20),
        "bound_ms": hbm_ms(nbytes),
        "bound_by": "bytes",
    }


def check_new_steps(torch, ev_seg, ssb_seg) -> dict:
    """The HLL register update at config 10's shape (2M docs, user_id's
    2^21-entry hash table), the grouped update at ng 256 (GROUP BY country,
    device: 90 groups), select's first-k compaction at config 13's shape
    (4M docs, 4% on, k = 10) and select_ob's stable top-k at config 11's
    (4M docs, 14% on, k = 20), over staged segment columns."""
    from pinot_tpu_torch.query import kernels as K
    from pinot_tpu_torch.query.sketches import HLL_M, hll_ranks, hll_update, hll_update_grouped

    def cpu(t):
        return t.cpu() if isinstance(t, torch.Tensor) else t

    out = {}
    ev = ev_seg.to_device_cached("cuda")
    ids, n = ev.arrays["user_id"], ev.padded
    valid = torch.arange(n, device="cuda") < ev.n_docs
    table = K.stage_operand(ev_seg.columns["user_id"].dictionary.hll_hash_pad(), "cuda")
    gid = ev.arrays["country"] * 3 + ev.arrays["device"]

    def hashes(ids, table):
        return K._gather(table, ids).to(torch.int64) & 0xFFFFFFFF

    idx, rank = hll_ranks(hashes(ids, table), valid)
    flat = gid.to(torch.int64) * HLL_M + idx
    regs = torch.zeros(HLL_M, dtype=torch.int32, device="cuda")
    grid = torch.zeros(256 * HLL_M, dtype=torch.int32, device="cuda")
    args = [cpu(t) for t in (ids, table, valid, gid)]
    out["hll_update"] = {
        "shape": {"n": n, "table": table.numel(), "registers": HLL_M},
        # ids and the mask once, the hash table once, the registers once
        **_step_timing(torch, lambda: hll_update(hashes(ids, table), valid),
                       lambda: hll_update(hashes(args[0], args[1]), args[2]),
                       n * 5 + table.numel() * 4 + HLL_M * 4,
                       lambda: regs.scatter_reduce_(0, idx, rank, "amax")),
    }
    out["hll_update_grouped"] = {
        "shape": {"n": n, "ng": 256, "groups": 90, "registers": HLL_M},
        **_step_timing(torch, lambda: hll_update_grouped(hashes(ids, table), valid, gid, 256),
                       lambda: hll_update_grouped(hashes(args[0], args[1]), args[2], args[3], 256),
                       n * 9 + table.numel() * 4 + 256 * HLL_M * 4,
                       lambda: grid.scatter_reduce_(0, flat, rank, "amax")),
    }

    seg = ssb_seg.to_device_cached("cuda")
    n = seg.padded
    valid = torch.arange(n, device="cuda") < seg.n_docs
    nation = ssb_seg.columns["c_nation"].dictionary.index_of("NATION_07")
    mask = valid & (seg.arrays["c_nation"] == nation)
    mask_cpu = mask.cpu()
    out["select_first_k"] = {
        "shape": {"n": n, "mask_on": int(mask.sum().item()), "k": 10},
        **_step_timing(torch, lambda: K.first_k(mask, 10), lambda: K.first_k(mask_cpu, 10), n + 10 * 8,
                       lambda: torch.nonzero(mask)),
    }
    year = ssb_seg.columns["d_year"].dictionary.index_of(1995)
    on = valid & (seg.arrays["d_year"] == year)
    sort_key = torch.where(on, seg.arrays["lo_revenue"].to(torch.float64), float("-inf"))
    key_cpu = sort_key.cpu()
    out["select_ob_top_k"] = {
        "shape": {"n": n, "mask_on": int(on.sum().item()), "k": 20, "key": "float64 sort key"},
        **_step_timing(torch, lambda: K.top_k_stable(K.total_order_key(sort_key), 20),
                       lambda: K.top_k_stable(K.total_order_key(key_cpu), 20), n * 8 + 20 * 8,
                       lambda: torch.topk(sort_key, 20)),
    }
    emit({"phase": "new_device_steps", "steps": out, "card": card_line()})
    return out


def check_tag_steps(torch, engine, seg) -> dict:
    """The torch steps of configs 18-19 that no hand-written kernel carries,
    at their main-path shapes over one 4M-row segment, each held exactly
    against the same step on the CPU: PERCENTILEEST's binning (config 19's
    lo_revenue), the IN probe of a sorted list (config 18's lo_quantity), the
    CASE fold (config 18's), and one transform, YEAR over a 4M-doc epoch-ms
    column (seeded on the card)."""
    from pinot_tpu_torch.query import kernels as K
    from pinot_tpu_torch.query import torch_ns
    from pinot_tpu_torch.query.plan import plan_segment
    from pinot_tpu_torch.query.transforms import DEVICE_FUNCS

    def staged(sql, device):
        plan = plan_segment(seg, engine.make_context(sql))
        return (plan, *K.plan_inputs(plan, seg.to_device_cached(device)))

    out = {}
    n = seg.to_device_cached("cuda").padded
    plan, cols, ops = staged(TAG_CONFIGS["19_percentileest"], "cuda")
    _, ccols, cops = staged(TAG_CONFIGS["19_percentileest"], "cpu")
    hist = plan.spec[3][0]
    v = cols["lo_revenue"].to(torch.float64)
    lo, inv_w = float(ops[hist[2]]), float(ops[hist[3]])
    edges = lo + torch.arange(1, 4096, dtype=torch.float64, device="cuda") / inv_w
    out["hist_bins"] = {
        "shape": {"n": n, "bins": 4096, "column": "lo_revenue (int32)"},
        # lo_revenue once (int32), the int32 bins once
        **_step_timing(torch, lambda: K._bins(hist, cols, ops, n), lambda: K._bins(hist, ccols, cops, n), n * 8,
                       lambda: torch.bucketize(v, edges, right=True)),
    }
    plan, cols, ops = staged(TAG_CONFIGS["18_case_in_cmp_fn"], "cuda")
    _, ccols, cops = staged(TAG_CONFIGS["18_case_in_cmp_fn"], "cpu")
    probe = plan.spec[1][1][0]
    assert probe[0] == "in_sorted", probe
    dev = cols["lo_quantity"].device
    out["in_sorted_probe"] = {
        "shape": {"n": n, "list": int(ops[probe[2]].numel()), "column": "lo_quantity (int32)"},
        **_step_timing(torch, lambda: K._filter(probe, cols, ops, n, dev), lambda: K._filter(probe, ccols, cops, n, torch.device("cpu")),
                       n * 5, lambda: torch.isin(cols["lo_quantity"], ops[probe[2]])),
    }
    case = plan.spec[3][0][1]
    assert case[0] == "case", case
    out["case_fold"] = {
        "shape": {"n": n, "whens": len(case[1]), "reads": "lo_quantity, lo_revenue (int32)"},
        **_step_timing(torch, lambda: K._value(case, cols, ops, n), lambda: K._value(case, ccols, cops, n), n * 16),
    }
    gen = torch.Generator(device="cuda").manual_seed(19)
    ts = torch.randint(-(1 << 41), 1 << 41, (n,), generator=gen, device="cuda", dtype=torch.int64)
    ts_cpu = ts.cpu()
    year = DEVICE_FUNCS["year"][1]
    out["transform_year"] = {
        "shape": {"n": n, "column": "epoch ms (int64)"},
        **_step_timing(torch, lambda: torch_ns.apply(year, [ts]), lambda: torch_ns.apply(year, [ts_cpu]), n * 16),
    }
    emit({"phase": "new_device_steps_tags", "steps": out, "card": card_line()})
    return out


def check_mv_steps(torch, engine, seg) -> dict:
    """The torch steps of configs 22-26 that no hand-written kernel carries,
    at their main-path shapes over one MV segment (1M docs), each held
    exactly against the same step on the CPU: mv_any's scatter-OR of a flat
    predicate into doc space (config 22's tag = 'tag0042'), the value-space
    gather of a doc mask (config 23's year = 1997 to nums' values) and
    groups_mv2's pair expansion (config 26's tag x num pairs)."""
    from pinot_tpu_torch.query import kernels as K
    from pinot_tpu_torch.query.plan import plan_segment

    def staged(sql, device):
        plan = plan_segment(seg, engine.make_context(sql))
        return (plan, *K.plan_inputs(plan, seg.to_device_cached(device)))

    out = {}
    dev = seg.to_device_cached("cuda")
    n = dev.padded
    cpu = torch.device("cpu")
    plan, cols, ops = staged(MV_CONFIGS["22_tag_search"], "cuda")
    _, ccols, cops = staged(MV_CONFIGS["22_tag_search"], "cpu")
    any_spec = plan.spec[1]
    assert any_spec[0] == "mv_any", any_spec
    vpad = cols["tags"].numel()
    pred = K._filter(any_spec[2], cols, ops, vpad, cols["tags"].device)
    pred &= torch.arange(vpad, device="cuda") < ops[any_spec[3]]
    docs64 = cols["tags!docs"].to(torch.int64)
    hits = torch.zeros(n + 1, dtype=torch.uint8, device="cuda")
    out["mv_any_scatter_or"] = {
        "shape": {"n_docs": n, "n_values": vpad, "hits": int(pred.sum().item())},
        # the flat ids and owning docs once, the doc mask once
        **_step_timing(torch, lambda: K._filter(any_spec, cols, ops, n, cols["tags"].device),
                       lambda: K._filter(any_spec, ccols, cops, n, cpu), vpad * 8 + n,
                       lambda: hits.scatter_reduce_(0, docs64, pred.to(torch.uint8), "amax")),
    }
    plan, cols, ops = staged(MV_CONFIGS["23_mv_totals"], "cuda")
    _, ccols, cops = staged(MV_CONFIGS["23_mv_totals"], "cpu")
    agg = plan.spec[3][0]
    assert agg[0] == "mv_count", agg
    mask = K._filter(plan.spec[1], cols, ops, n, cols["nums"].device) & (torch.arange(n, device="cuda") < seg.n_docs)
    cmask = mask.cpu()
    vpad = cols["nums"].numel()
    docs = K._owner_docs("nums", cols, n)
    out["value_space_gather"] = {
        "shape": {"n_docs": n, "n_values": vpad, "mask_on": int(mask.sum().item())},
        # the owning docs and the doc mask once, the value mask once
        **_step_timing(torch, lambda: K._mv_vmask("nums", agg[2], cols, ops, mask),
                       lambda: K._mv_vmask("nums", agg[2], ccols, cops, cmask), vpad * 5 + n,
                       lambda: torch.index_select(mask, 0, docs)),
    }
    plan, cols, ops = staged(MV_CONFIGS["26_tag_num_pairs"], "cuda")
    _, ccols, cops = staged(MV_CONFIGS["26_tag_num_pairs"], "cpu")
    gspec = plan.spec[2]
    assert gspec[0] == "groups_mv2", gspec
    mask = torch.arange(n, device="cuda") < seg.n_docs
    cmask = mask.cpu()
    va, lb = cols[gspec[4]].numel(), gspec[9]
    nb = cols[gspec[6]].numel()
    out["mv2_pair_expansion"] = {
        "shape": {"n_docs": n, "base": gspec[4], "base_values": va, "lb": lb, "pairs": va * lb, "ng": gspec[2]},
        # the doc mask, the base's ids and owning docs, the offset and length
        # tables and the other column's ids once; the pair mask, gid and
        # owning doc once
        **_step_timing(torch, lambda: K.mv2_pairs(gspec, cols, ops, mask), lambda: K.mv2_pairs(gspec, ccols, cops, cmask),
                       n + va * 8 + (n + 1) * 8 + nb * 4 + va * lb * 9),
    }
    emit({"phase": "new_device_steps_mv", "steps": out, "card": card_line()})
    return out


# ---------------------------------------------------------------------------
# configs 28-31: pruning, GAPFILL, upsert validity, EXPLAIN, the schedulers
# ---------------------------------------------------------------------------

#: configs 28-30's table: the lineorder rows stably sorted by d_year (time
#: partitioned, as ingestion by time lays segments out), in TP_SEGMENTS
#: segments of N_ROWS / TP_SEGMENTS rows; d_year is sorted in every segment
TP_SEGMENTS = 16
TP_CONFIGS = {
    # a dashboard over one year: ~13 of 16 segments pruned by value
    "28a_pruned_dashboard": (
        "SELECT c_nation, p_category, SUM(lo_revenue), COUNT(*), MIN(lo_supplycost), MAX(lo_supplycost) "
        "FROM lineorder WHERE d_year = 1997 GROUP BY c_nation, p_category ORDER BY SUM(lo_revenue) DESC LIMIT 1000"
    ),
    # top customers of the last two years: config 8's ng on the unpruned
    # segments, the two-level kernel
    "28b_pruned_top_customers": (
        "SELECT lo_custkey, SUM(lo_revenue) FROM lineorder WHERE d_year BETWEEN 1997 AND 1998 "
        "GROUP BY lo_custkey ORDER BY SUM(lo_revenue) DESC LIMIT 100"
    ),
    # a window with no data: every segment pruned; 0 against NULL
    "28c_empty_window": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE d_year = 2005",
    "28c_empty_window_nulls": (
        "SET enableNullHandling = true; SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE d_year = 2005"
    ),
    # a yearly series with missing buckets (<> never prunes: all 16 run)
    "29_gapfill": (
        "SELECT GAPFILL(d_year, 1990, 2002, 1, FILL(r, 'FILL_PREVIOUS_VALUE')), SUM(lo_revenue) AS r "
        "FROM lineorder WHERE d_year <> 1995 GROUP BY d_year ORDER BY d_year LIMIT 100"
    ),
}
#: the same table as an upsert table keyed by lo_custkey, the last-ingested
#: row of each key valid
UPSERT_CONFIGS = {
    "30a_upsert_by_nation": (
        "SELECT c_nation, COUNT(*), SUM(lo_revenue) FROM lineorder GROUP BY c_nation ORDER BY c_nation LIMIT 25"
    ),
    "30b_upsert_distinct": "SELECT DISTINCTCOUNT(lo_custkey) FROM lineorder",
}
#: launches per segment that runs (a pruned one launches nothing)
TP_LAUNCHES = {
    "28a_pruned_dashboard": (1, 1, 0, 0),  # SUM + COUNT in one flat launch; MIN and MAX in one extreme launch
    "28b_pruned_top_customers": (0, 0, 0, 1),  # ng 90,112: past the flat kernel's shared counters
    "28c_empty_window": (0, 0, 0, 0),
    "28c_empty_window_nulls": (0, 0, 0, 0),
    "29_gapfill": (1, 0, 0, 0),
    "30a_upsert_by_nation": (1, 0, 0, 0),
    "30b_upsert_distinct": (0, 0, 1, 0),
}
#: share of the valid flags config 30's second run moves to earlier docs of
#: the same keys
UPSERT_MOVED = 0.01
SCHEDULED = ("3_q1_groupby", "28a_pruned_dashboard", "29_gapfill", "30a_upsert_by_nation")


def tp_order(year: np.ndarray) -> np.ndarray:
    return np.argsort(year, kind="stable")


def tp_bounds(n: int) -> list[tuple[int, int]]:
    per = n // TP_SEGMENTS
    return [(i * per, (i + 1) * per if i < TP_SEGMENTS - 1 else n) for i in range(TP_SEGMENTS)]


def tp_engine_of(data: dict):
    """Configs 28-29's table: `data` sorted by d_year, TP_SEGMENTS segments
    through the package's SegmentBuilder, and a QueryEngine over them on the
    card (nothing staged yet), with the seconds the build took."""
    from pinot_tpu_torch.query import QueryEngine

    t0 = time.perf_counter()
    order = tp_order(data["d_year"])
    builder = ssb_builder()

    def one(i_bounds):
        i, (lo, hi) = i_bounds
        rows = order[lo:hi]
        return builder.build({c: v[rows] for c, v in data.items()}, f"lineorder_tp_{i}")

    segments = in_threads(one, enumerate(tp_bounds(len(order))))
    return QueryEngine(segments, device=DEVICE), segments, time.perf_counter() - t0


def upsert_valid(cust: np.ndarray) -> np.ndarray:
    """The last occurrence of each key, in ingestion (doc) order: one numpy
    pass."""
    n = len(cust)
    live = np.zeros(n, dtype=bool)
    _, first_of_reversed = np.unique(cust[::-1], return_index=True)
    live[n - 1 - first_of_reversed] = True
    return live


def move_valid(live: np.ndarray, cust: np.ndarray, share: float, seed: int = 30) -> int:
    """In place: a seeded `share` of the keys get their valid flag moved from
    their last doc to an earlier doc of the same key. Returns the moves."""
    n = len(cust)
    order = np.lexsort((np.arange(n), cust))
    k = cust[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    ends = np.r_[starts[1:], n]
    rng = np.random.default_rng(seed)
    groups = rng.choice(len(starts), size=int(len(starts) * share), replace=False)
    groups = groups[ends[groups] - starts[groups] > 1]
    pick = starts[groups] + (rng.random(len(groups)) * (ends[groups] - 1 - starts[groups])).astype(np.int64)
    live[order[ends[groups] - 1]] = False
    live[order[pick]] = True
    return len(groups)


def upsert_engine_of(segments: list, live: np.ndarray):
    """Config 30's table: the time-partitioned segments (their columns and
    staged copies shared) with a validity reading `live`, a view a segment,
    so moving flags in place shows in the next query."""
    import dataclasses

    from pinot_tpu_torch.query import QueryEngine

    out = []
    for seg, (lo, hi) in zip(segments, tp_bounds(len(live))):
        view = live[lo:hi]
        out.append(dataclasses.replace(seg, extras={**seg.extras, "valid_docs": lambda nd, a=view: a[:nd]}))
    return QueryEngine(out, device=DEVICE)


def tp_oracle(year, nation, category, rev, cost, cust) -> dict:
    """Rows of configs 28-29 over the raw arrays, and each config's pruned
    segments: those whose [min, max] of d_year (sorted chunks) excludes the
    predicate."""
    out = {}
    m = year == 1997
    key = nation[m].astype(np.int64) * 25 + category[m]
    sums = np.bincount(key, weights=rev[m], minlength=625)  # exact: integer partials < 2^53
    cnt = np.bincount(key, minlength=625)
    mins = np.full(625, np.iinfo(np.int64).max)
    maxs = np.full(625, np.iinfo(np.int64).min)
    np.minimum.at(mins, key, cost[m])
    np.maximum.at(maxs, key, cost[m])
    present = np.flatnonzero(cnt)
    top = present[np.argsort(-sums[present], kind="stable")][:1000]
    out["28a_pruned_dashboard"] = [
        [NATIONS[g // 25], CATEGORIES[g % 25], float(sums[g]), int(cnt[g]), float(mins[g]), float(maxs[g])] for g in top
    ]
    m = (year >= 1997) & (year <= 1998)
    sums = np.bincount(cust[m], weights=rev[m], minlength=N_CUSTOMERS + 1)
    present = np.flatnonzero(np.bincount(cust[m], minlength=N_CUSTOMERS + 1))
    top = present[np.argsort(-sums[present], kind="stable")][:100]
    out["28b_pruned_top_customers"] = [[int(c), float(sums[c])] for c in top]
    out["28c_empty_window"] = [[0, 0.0]]
    out["28c_empty_window_nulls"] = [[0, None]]
    m = year != 1995
    sums = np.bincount(year[m] - 1992, weights=rev[m], minlength=7)
    rows, prev = [], None
    for y in range(1990, 2002):
        if 1992 <= y <= 1998 and y != 1995:
            prev = float(sums[y - 1992])
            rows.append([y, prev])
        else:
            rows.append([y, prev])
    out["29_gapfill"] = rows
    sorted_year = np.sort(year)
    spans = [(int(sorted_year[lo]), int(sorted_year[hi - 1])) for lo, hi in tp_bounds(len(year))]
    tests = {
        "28a_pruned_dashboard": lambda a, b: a <= 1997 <= b,
        "28b_pruned_top_customers": lambda a, b: not (b < 1997 or a > 1998),
        "28c_empty_window": lambda a, b: a <= 2005 <= b,
        "28c_empty_window_nulls": lambda a, b: a <= 2005 <= b,
        "29_gapfill": lambda a, b: True,
    }
    pruned = {name: sum(1 for a, b in spans if not t(a, b)) for name, t in tests.items()}
    docs = {"28a_pruned_dashboard": int((year == 1997).sum())}
    return {"rows": out, "pruned": pruned, "docs": docs, "spans": spans}


def upsert_oracle(live, nation, rev, cust) -> dict:
    cnt = np.bincount(nation[live], minlength=25)
    sums = np.bincount(nation[live], weights=rev[live], minlength=25)
    return {
        "30a_upsert_by_nation": [[NATIONS[i], int(cnt[i]), float(sums[i])] for i in range(25) if cnt[i]],
        "30b_upsert_distinct": [[int(len(np.unique(cust[live])))]],
    }


def check_explain(engine, want_docs: int, want_pruned: int) -> dict:
    """Config 31's EXPLAIN PLAN FOR and EXPLAIN ANALYZE of 28a: the expected
    operators, and the measured docsScanned and segmentsPruned against the
    oracle's."""
    import re

    sql = TP_CONFIGS["28a_pruned_dashboard"]
    plan = engine.execute("EXPLAIN PLAN FOR " + sql).rows
    ops = [r[0] for r in plan]
    need = ["BROKER_REDUCE(GROUP_BY)", "AGGREGATE_SUM", "AGGREGATE_COUNT", "AGGREGATE_MIN", "AGGREGATE_MAX",
            "FILTER_SORTED_INDEX(d_year)"]
    missing = [o for o in need if o not in ops]
    if missing or not any(o.startswith("DEVICE_FUSED_PROGRAM(segment=") for o in ops) or not any(
        o.startswith("GROUP_BY(keys=['c_nation', 'p_category'], ng=") for o in ops
    ):
        raise AssertionError(f"31 EXPLAIN: operators {ops}, missing {missing}")
    analyze = engine.execute("EXPLAIN ANALYZE " + sql).rows
    root = analyze[0][0]
    docs = int(re.search(r"docsScanned=(\d+)", root).group(1))
    pruned = int(re.search(r"segmentsPruned=(\d+)", root).group(1))
    if (docs, pruned) != (want_docs, want_pruned):
        raise AssertionError(f"31 EXPLAIN ANALYZE: docsScanned {docs}, segmentsPruned {pruned}; oracle {want_docs}, {want_pruned}")
    return {"plan": plan, "analyze": analyze}


def run_scheduled(kind: str, jobs: list, want: dict) -> dict:
    """`jobs` ((name, engine, sql), ...) through a scheduler of `kind` with 2
    runners, sent by 4 client threads; every result held against its
    oracle. Returns the wall and the queries per second."""
    import threading

    from pinot_tpu_torch.query.scheduler import make_scheduler

    sched = make_scheduler(kind, num_runners=2)
    sched.start()
    results: list = [None] * len(jobs)
    errors: list = []

    def client(i):
        try:
            for j in range(i, len(jobs), 4):
                name, eng, sql = jobs[j]
                results[j] = sched.submit(eng.execute, sql, table=name.split("_")[0]).result(timeout=600)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sched.stop()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    for (name, _, _), res in zip(jobs, results):
        rows_match(f"31 {kind} {name}", res.rows, want[name])
    return {"wall_ms": wall * 1e3, "qps": len(jobs) / wall}


def kernel_obs_phase(torch, tp_engine, up_engine) -> dict:
    """Per kernel: the registry's device ms per call at one config (its CUDA
    events, read at resolve) beside the kernel's device-alone time at the
    same shape (the operands of its first call in that config, timed as
    kernel_timing times), and the roofline rows of that run."""
    from pinot_tpu_torch.common.kernel_obs import KERNELS
    from pinot_tpu_torch.ops import extreme as ext
    from pinot_tpu_torch.ops import groupby as gb
    from pinot_tpu_torch.ops import grouped_sum_f32 as gs
    from pinot_tpu_torch.query import kernels as qk

    cases = [
        ("28a_pruned_dashboard", tp_engine, "grouped_multi_sum", "ops.grouped_planes", gb.grouped_multi_sum_kernel),
        ("28a_pruned_dashboard", tp_engine, "grouped_extremes", "ops.grouped_extreme", ext.grouped_extremes_kernel),
        ("28b_pruned_top_customers", tp_engine, "grouped_multi_sum", "ops.grouped_planes2", gb.grouped_multi_sum_2l_kernel),
        ("30b_upsert_distinct", up_engine, "presences", "ops.grouped_sum", gs.presences_kernel),
    ]
    sqls = {**TP_CONFIGS, **UPSERT_CONFIGS}
    out = {}
    for cfg, eng, fn_name, kname, kernel in cases:
        real = getattr(qk, fn_name)
        first = []

        def spy(*a, real=real, first=first, **k):
            if not first:
                first.append((a, k))
            return real(*a, **k)

        setattr(qk, fn_name, spy)
        try:
            KERNELS.reset_stats()
            eng.execute(sqls[cfg])
            snap = KERNELS.stats_snapshot()
            roof = KERNELS.roofline()["kernels"]
        finally:
            setattr(qk, fn_name, real)
        rows = [v for (k, _), v in snap.items() if k == kname]
        calls = sum(v["calls"] for v in rows)
        args, kwargs = first[0]
        KERNELS.configure(enabled=False)
        try:
            device_ms, host_ms = device_and_host_ms(torch, lambda: kernel(*args, **kwargs))
        finally:
            KERNELS.configure(enabled=True)
        out[f"{cfg}:{kname}"] = {
            "registry_calls": calls,
            "registry_device_ms_per_call": sum(v["deviceMs"] for v in rows) / calls,
            "registry_bytes_per_call": sum(v["bytesMoved"] for v in rows) / calls,
            "kernel_device_ms_first_call_shape": device_ms,
            "kernel_host_ms": host_ms,
            "roofline": [r for r in roof if r["kernel"] == kname],
        }
    return out


def run_slice8_main(torch, counted, counters, want, tp_want, engine, tp_eng, tp_segments, up_eng, upsert) -> dict:
    """Configs 28-31 on the main path: each config's rows against its oracle,
    its launches against the segments it runs, its pruned count against the
    numpy count; the first query stages only the unpruned segments; config
    30 again after UPSERT_MOVED of the valid flags moved; config 31's EXPLAIN
    and scheduled runs; and, over configs 28-30, the kernel registry's calls
    against the launch counters."""
    from pinot_tpu_torch.common.kernel_obs import KERNELS

    live, nation_tp, rev_tp, cust_tp = upsert
    out: dict = {"pruned": {}}
    KERNELS.reset_stats()
    before = {k: fn.launches for k, fn in counters.items()}

    def runs(name):
        return TP_SEGMENTS - tp_want["pruned"].get(name, 0)

    for name, sql in TP_CONFIGS.items():
        tp_eng.segment_modes.clear()
        t0 = time.perf_counter()
        res = counted(name, [runs(name) * c for c in TP_LAUNCHES[name]], lambda: tp_eng.execute(sql))
        if name == "28a_pruned_dashboard":
            staged = [s for s in tp_segments if s._device_cache]
            live_names = [s.name for s, (a, b) in zip(tp_segments, tp_want["spans"]) if a <= 1997 <= b]
            if [s.name for s in staged] != live_names:
                raise AssertionError(f"28a staged {[s.name for s in staged]}, unpruned {live_names}")
            out["first_query"] = {
                "ms": (time.perf_counter() - t0) * 1e3,
                "staged_segments": live_names,
                "staged_bytes": sum(t.numel() * t.element_size() for s in staged for t in s.to_device_cached(DEVICE).arrays.values()),
            }
        rows_match(name, res.rows, want[name])
        pruned = tp_want["pruned"][name]
        got = (res.num_segments_pruned, res.num_segments_pruned_by_value, tp_eng.segment_modes["pruned"])
        if got != (pruned, pruned, pruned) or res.num_segments_queried != TP_SEGMENTS:
            raise AssertionError(f"{name}: pruned (total, by value, modes) {got}, numpy count {pruned}")
        out["pruned"][name] = pruned
    for name, sql in UPSERT_CONFIGS.items():
        res = counted(name, [TP_SEGMENTS * c for c in TP_LAUNCHES[name]], lambda: up_eng.execute(sql))
        rows_match(name, res.rows, want[name])
    moved = move_valid(live, cust_tp, UPSERT_MOVED)
    moved_want = upsert_oracle(live, nation_tp, rev_tp, cust_tp)
    name = "30a_upsert_by_nation"
    if moved_want[name] == want[name] or moved_want["30b_upsert_distinct"] != want["30b_upsert_distinct"]:
        raise AssertionError("30: moving the valid flags left the oracle's rows unchanged")
    res = counted(name + "_moved", [TP_SEGMENTS * c for c in TP_LAUNCHES[name]], lambda: up_eng.execute(UPSERT_CONFIGS[name]))
    rows_match(name + "_moved", res.rows, moved_want[name])
    want[name] = moved_want[name]
    out["upsert"] = {"valid_docs": int(live.sum()), "moved": moved}

    # the registry against the launch counters over configs 28-30
    snap = KERNELS.stats_snapshot()
    calls = {}
    for (kname, _), v in snap.items():
        calls[kname] = calls.get(kname, 0) + v["calls"]
    delta = {k: fn.launches - before[k] for k, fn in counters.items()}
    by_kernel = {"ops.grouped_planes": delta["grouped_sum_count"], "ops.grouped_extreme": delta["grouped_extreme"],
                 "ops.grouped_sum": delta["presence"], "ops.grouped_planes2": delta["grouped_sum_count_2l"]}
    if {k: calls.get(k, 0) for k in by_kernel} != by_kernel:
        raise AssertionError(f"28-30: registry calls {calls}, launch counters {by_kernel}")
    roof = KERNELS.roofline()["kernels"]
    over = [r for r in roof if r["pctOfPeak"] > 100]
    if over:
        raise AssertionError(f"28-30: roofline rows above the peak: {over}")
    out["registry"] = {"calls": calls, "launch_counters": by_kernel, "roofline": roof, "hbm": KERNELS.hbm_snapshot()}

    # config 31: EXPLAIN of 28a, then 8 queries through two schedulers
    n28a = runs("28a_pruned_dashboard")
    out["explain"] = counted("31_explain", [n28a * c for c in TP_LAUNCHES["28a_pruned_dashboard"]],
                             lambda: check_explain(tp_eng, tp_want["docs"]["28a_pruned_dashboard"],
                                                   tp_want["pruned"]["28a_pruned_dashboard"]))
    engines = {"3_q1_groupby": engine, "28a_pruned_dashboard": tp_eng, "29_gapfill": tp_eng, "30a_upsert_by_nation": up_eng}
    sqls = {**CONFIGS, **TP_CONFIGS, **UPSERT_CONFIGS}
    jobs = [(name, engines[name], sqls[name]) for name in SCHEDULED] * 2
    per_round = [N_SEGMENTS * a + n28a * b + TP_SEGMENTS * (c + d) for a, b, c, d in zip(
        LAUNCHES_PER_SEGMENT["3_q1_groupby"], TP_LAUNCHES["28a_pruned_dashboard"], TP_LAUNCHES["29_gapfill"],
        TP_LAUNCHES["30a_upsert_by_nation"])]
    expect = [2 * c for c in per_round]  # each query twice

    def serial():
        ms = []
        for name, eng, sql in jobs:
            t0 = time.perf_counter()
            res = eng.execute(sql)
            ms.append((time.perf_counter() - t0) * 1e3)
            rows_match(f"31 serial {name}", res.rows, want[name])
        return {"sum_ms": sum(ms), "runs_ms": ms, "qps": len(jobs) / (sum(ms) / 1e3)}

    sched = {"serial": counted("31_serial", expect, serial)}
    for kind in ("fcfs", "priority"):
        sched[kind] = counted(f"31_{kind}", expect, lambda: run_scheduled(kind, jobs, want))
    out["scheduled"] = sched
    return out


def registry_cost(engine) -> dict:
    """Config 28a's wall p50 with the kernel registry enabled and disabled,
    in turns (on, off, on, off)."""
    from pinot_tpu_torch.common.kernel_obs import KERNELS

    sql = TP_CONFIGS["28a_pruned_dashboard"]
    turns = []
    try:
        for enabled in (True, False, True, False):
            KERNELS.configure(enabled=enabled)
            turns.append({"enabled": enabled, **wall_p50(engine, sql, warm=1, runs=7)})
    finally:
        KERNELS.configure(enabled=True)
    return {"config": "28a_pruned_dashboard", "turns": turns}


def run_main_path(torch, counters: dict) -> dict:
    from pinot_tpu_torch.query import QueryEngine

    t0 = time.perf_counter()
    data, nation, category = make_ssb_data(N_ROWS)
    small, small_nation, small_category = make_ssb_data(SMALL_ROWS, seed=1)
    want, groups = oracle(data, nation, category)
    want.update(host_oracle(data, nation, category, (small, small_nation, small_category)))
    want.update(tag_oracle(data, nation))
    t_gen = time.perf_counter() - t0

    engine, segments, t_build = ssb_engine(data)
    null_engine, null_segments, t_null_build = null_engine_of(data)
    # configs 28-31's table: the same rows sorted by d_year, 16 segments
    tp_eng, tp_segments, t_tp_build = tp_engine_of(data)
    t0 = time.perf_counter()
    order = tp_order(data["d_year"])
    year_tp, nation_tp, category_tp = data["d_year"][order], nation[order], category[order]
    rev_tp, cost_tp, cust_tp = data["lo_revenue"][order], data["lo_supplycost"][order], data["lo_custkey"][order]
    tp_want = tp_oracle(year_tp, nation_tp, category_tp, rev_tp, cost_tp, cust_tp)
    want.update(tp_want["rows"])
    live = upsert_valid(cust_tp)
    want.update(upsert_oracle(live, nation_tp, rev_tp, cust_tp))
    up_eng = upsert_engine_of(tp_segments, live)
    del order, year_tp, category_tp, cost_tp
    emit(
        {
            "phase": "tp_setup",
            "rows": N_ROWS,
            "segments": TP_SEGMENTS,
            "build_s": t_tp_build,
            "oracle_s": time.perf_counter() - t0,
            "year_spans": tp_want["spans"],
            "pruned_expected": tp_want["pruned"],
            "valid_docs": int(live.sum()),
            "d_year_sorted_in_every_segment": all(s.columns["d_year"].stats.is_sorted for s in tp_segments),
        }
    )
    small_seg = ssb_builder().build(small, "lineorder_consuming")
    mixed_engine = QueryEngine(segments + [small_seg], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    staged = [seg.to_device_cached("cuda") for seg in segments]
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    staged_bytes = sum(t.numel() * t.element_size() for s in staged for t in s.arrays.values())
    emit(
        {
            "phase": "slice_setup",
            "rows": N_ROWS,
            "segments": N_SEGMENTS,
            "generate_s": t_gen,
            "build_s": t_build,
            "stage_s": t_stage,
            "staged_bytes": staged_bytes,
            "oracle_groups": groups,
            # config 21's four segments with null vectors, built from the
            # same rows (their staging is paid in config 21's first query)
            "null_build_s": t_null_build,
            "null_rows": {seg.name: int(seg.null_mask({"lo_supplycost"}).sum()) for seg in null_segments},
        }
    )

    t0 = time.perf_counter()
    events = make_events(EVENTS_ROWS)
    want_10 = events_oracle(events)
    t_gen = time.perf_counter() - t0
    ev_seg, star_cfg, t_build = events_segment(events)
    del events
    ev_engine = QueryEngine([ev_seg], device="cuda")
    t0 = time.perf_counter()
    ev_staged = ev_seg.to_device_cached("cuda")
    torch.cuda.synchronize()
    emit(
        {
            "phase": "config10_setup",
            "rows": EVENTS_ROWS,
            "generate_s": t_gen,
            "build_s_with_star_tree": t_build,
            "stage_s": time.perf_counter() - t0,
            "staged_bytes": sum(t.numel() * t.element_size() for t in ev_staged.arrays.values()),
            "user_id_cardinality": ev_seg.columns["user_id"].cardinality,
            "star_rows": want_10["star_rows"],
        }
    )
    # paid once, not part of the walls
    emit({"phase": "config10_first_query", **config10_first_query(torch, ev_engine, ev_seg, star_cfg)})
    new_steps = check_new_steps(torch, ev_seg, segments[0])
    new_steps.update(check_tag_steps(torch, engine, segments[0]))
    # config 21's staging and its null masks' one copy each, paid once
    t0 = time.perf_counter()
    null_engine.execute(NULL_CONFIGS["21_null_kleene"])
    torch.cuda.synchronize()
    emit({"phase": "config21_first_query", "ms": (time.perf_counter() - t0) * 1e3})

    # configs 22-27's table
    t0 = time.perf_counter()
    mv_data = make_mv_data(MV_ROWS)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    want.update(mv_oracle(mv_data))
    t_oracle = time.perf_counter() - t0
    mv_eng, mv_segments, t_build = mv_engine(mv_data)
    n_values = {c: int(mv_data[c].size) for c in ("tags", "nums")}
    del mv_data
    t0 = time.perf_counter()
    mv_staged = [seg.to_device_cached("cuda") for seg in mv_segments]
    torch.cuda.synchronize()
    emit(
        {
            "phase": "mv_setup",
            "rows": MV_ROWS,
            "segments": MV_SEGMENTS,
            "flat_values": n_values,
            "generate_s": t_gen,
            "oracle_s": t_oracle,
            "build_s": t_build,
            "stage_s": time.perf_counter() - t0,
            "staged_bytes": sum(t.numel() * t.element_size() for s in mv_staged for t in s.arrays.values()),
            "staged_bytes_by_column": {
                c: sum(s.arrays[c].numel() * s.arrays[c].element_size() for s in mv_staged)
                for c in mv_staged[0].arrays
            },
            "cardinality_seg0": {c: ci.cardinality for c, ci in mv_segments[0].columns.items()},
        }
    )
    new_steps.update(check_mv_steps(torch, mv_eng, mv_segments[0]))

    # the main path: every count from 0, one execute per config, counts read
    # after each config and at the end
    from pinot_tpu_torch.common.kernel_obs import KERNELS

    KERNELS.configure(enabled=True)
    for fn in counters.values():
        fn.launches = 0
    launches = {}

    def counted(name, expect_launches, run):
        before = [fn.launches for fn in counters.values()]
        out = run()
        launches[name] = {k: fn.launches - b for (k, fn), b in zip(counters.items(), before)}
        expect = dict(zip(counters, expect_launches))
        if launches[name] != expect:
            raise AssertionError(f"{name}: launches {launches[name]}, expected {expect}")
        return out

    def per_segment(name, n_segments):
        return [n_segments * c for c in LAUNCHES_PER_SEGMENT[name]]

    for name, sql in CONFIGS.items():
        res = counted(name, per_segment(name, N_SEGMENTS), lambda: engine.execute(sql))
        rows_match(name, res.rows, want[name])
        if res.num_docs_scanned <= 0 or res.total_docs != N_ROWS:
            raise AssertionError(f"{name}: docsScanned {res.num_docs_scanned}, totalDocs {res.total_docs}")
    config10 = counted("10_star_and_hll", per_segment("10_star_and_hll", 1), lambda: check_config10(ev_engine, ev_seg, want_10))
    modes = {}
    for name, sql in HOST_CONFIGS.items():
        eng = mixed_engine if name == "16_mixed_executors" else engine
        eng.segment_modes.clear()
        res = counted(name, HOST_LAUNCHES[name], lambda: eng.execute(sql))
        rows_match(name, res.rows, want[name])
        modes[name] = dict(eng.segment_modes)
        if modes[name] != HOST_MODES[name]:
            raise AssertionError(f"{name}: segments by executor {modes[name]}, expected {HOST_MODES[name]}")
    for name, sql in TAG_CONFIGS.items():
        res = counted(name, per_segment(name, N_SEGMENTS), lambda: engine.execute(sql))
        rows_match(name, res.rows, want[name])
    for name, sql in NULL_CONFIGS.items():
        null_engine.segment_modes.clear()
        res = counted(name, per_segment(name, N_SEGMENTS), lambda: null_engine.execute(sql))
        rows_match(name, res.rows, want[name])
        modes[name] = dict(null_engine.segment_modes)
        if modes[name] != {"device": N_SEGMENTS}:
            raise AssertionError(f"{name}: segments by executor {modes[name]}, expected all {N_SEGMENTS} on the device")
    if not any(r[1] is None and r[3] is None and r[4] is None for r in want["21_null_kleene"] if r[0] == NULL_YEAR):
        raise AssertionError("21_null_kleene: the all-null year is not NULL")
    for name, sql in {**MV_CONFIGS, **MV_HOST_CONFIGS}.items():
        mv_eng.segment_modes.clear()
        res = counted(name, per_segment(name, MV_SEGMENTS), lambda: mv_eng.execute(sql))
        rows_match(name, res.rows, want[name])
        modes[name] = dict(mv_eng.segment_modes)
        expect = {"host" if name in MV_HOST_CONFIGS else "device": MV_SEGMENTS}
        if modes[name] != expect:
            raise AssertionError(f"{name}: segments by executor {modes[name]}, expected {expect}")
        if res.total_docs != MV_ROWS:
            raise AssertionError(f"{name}: totalDocs {res.total_docs}")
    slice8 = run_slice8_main(torch, counted, counters, want, tp_want, engine, tp_eng, tp_segments, up_eng,
                             (live, nation_tp, rev_tp, cust_tp))
    main_launches = {k: fn.launches for k, fn in counters.items()}
    for k, v in main_launches.items():
        if v == 0:
            raise AssertionError(f"the main path never launched {k}")
    emit({"phase": "main_path", "results_match_oracle": True, "config10": config10,
          "launches_per_config": launches, "launches": main_launches, "segments_by_executor": modes,
          "configs_28_31": slice8})

    # every config ran once on the main path already: configs 1-21 take one
    # more warm-up, configs 22-26 two; the host configs (14-16, 27) take
    # seconds a query: no more warm-up and 3 runs
    walls = {name: wall_p50(engine, sql, warm=1) for name, sql in CONFIGS.items()}
    walls.update({name: wall_p50(ev_engine, sql, warm=1) for name, sql in CONFIG_10.items()})
    walls["10_both_submitted"] = wall_p50_of(lambda: drive_config10(ev_engine), warm=1)
    host_engines = {name: mixed_engine if name == "16_mixed_executors" else engine for name in HOST_CONFIGS}
    walls.update({name: wall_p50(host_engines[name], sql, warm=0, runs=3) for name, sql in HOST_CONFIGS.items()})
    walls.update({name: wall_p50(engine, sql, warm=1) for name, sql in TAG_CONFIGS.items()})
    walls.update({name: wall_p50(null_engine, sql, warm=1) for name, sql in NULL_CONFIGS.items()})
    walls.update({name: wall_p50(mv_eng, sql) for name, sql in MV_CONFIGS.items()})
    walls.update({name: wall_p50(mv_eng, sql, warm=0, runs=3) for name, sql in MV_HOST_CONFIGS.items()})
    walls.update({name: wall_p50(tp_eng, sql, warm=1) for name, sql in TP_CONFIGS.items()})
    walls.update({name: wall_p50(up_eng, sql, warm=1) for name, sql in UPSERT_CONFIGS.items()})
    walls["31_serial_sum_of_scheduled"] = slice8["scheduled"]["serial"]
    emit(
        {
            "phase": "main_path_timing",
            "wall": walls,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "card": card_line(),
        }
    )
    split = {name: breakdown(torch, engine, sql) for name, sql in CONFIGS.items()}
    split.update({name: breakdown(torch, ev_engine, sql) for name, sql in CONFIG_10.items()})
    split.update({name: breakdown(torch, host_engines[name], sql) for name, sql in HOST_CONFIGS.items()})
    split.update({name: breakdown(torch, engine, sql) for name, sql in TAG_CONFIGS.items()})
    split.update({name: breakdown(torch, null_engine, sql) for name, sql in NULL_CONFIGS.items()})
    split.update({name: breakdown(torch, mv_eng, sql) for name, sql in {**MV_CONFIGS, **MV_HOST_CONFIGS}.items()})
    split.update({name: breakdown(torch, tp_eng, sql) for name, sql in TP_CONFIGS.items()})
    split.update({name: breakdown(torch, up_eng, sql) for name, sql in UPSERT_CONFIGS.items()})
    emit({"phase": "where_the_time_goes", "configs": split})
    emit({"phase": "kernel_registry_cost", **registry_cost(tp_eng), "card": card_line()})
    emit({"phase": "kernel_obs", "kernels": kernel_obs_phase(torch, tp_eng, up_eng), "card": card_line()})
    return {"launches": main_launches, "new_steps": new_steps, "engine": engine, "segments": segments,
            "tp_segments": tp_segments, "data": data, "want": want, "nation": nation}


# ---------------------------------------------------------------------------
# phase 9: the sharded table and executor (bench.py's timed path)
# ---------------------------------------------------------------------------

#: bench.py's configs (Q4, 1, Q2, Q1) and configs 5-9 through
#: execute_sharded_result over the same 8M rows: each kernel launches over
#: the flat vector of every segment, so a query's launches are those of ONE
#: segment in LAUNCHES_PER_SEGMENT
SHARDED_CONFIGS = (
    "4_q4_groupby_orderby",
    "1_count_filter",
    "2_filtered_agg",
    "3_q1_groupby",
    "5_groupby_minmax",
    "6_groupby_distinct",
    "7_distinct",
    "8_groupby_wide",
    "9_groupby_sparse",
)
#: bench.py's rows_per_segment on one device: n // max(4, devices)
SHARDED_SEGMENTS = 4
#: bench.py's scale block under seed 7, at 16M rows (twice the main path's)
#: where bench.py has 60M: its 60M-row build took 121.7 s of a 1,103 s run on
#: an H100 80GB HBM3 at 700 W, its 32M-row build 62.8 s of a 1,018 s one,
#: and the script must stay well inside its time
SCALE_ROWS, SCALE_SEED = 16_000_000, 7
SCALE_CONFIGS = ("4_q4_groupby_orderby", "2_filtered_agg")
#: the proto fallback's MV table (config 26's GROUP BY over two MV keys)
MV_FALLBACK_ROWS = 1_000_000
#: MAX_DENSE_GROUPS for the forced sparse overflow: config 9's ~228k present
#: pairs pass U = 2^16 slots
OVERFLOW_SLOTS = 1 << 16
#: each proto rerun's launches (counters' order): config 26 raises before
#: the flat program runs, so only the proto's two-level launch; config 9
#: launches the two-level kernel over the flat vector, overflows, and again
#: on the proto
FALLBACK_LAUNCHES = {"26_tag_num_pairs": (0, 0, 0, 1), "9_groupby_sparse_overflow": (0, 0, 0, 2)}
#: (config, wrapper in query.kernels, kernel): the first call of each wrapper
#: in that config's sharded run is held against its plain version
FLAT_CHECKS = (
    ("4_q4_groupby_orderby", "grouped_multi_sum", "grouped_sum_count"),
    ("5_groupby_minmax", "grouped_extremes", "grouped_extreme"),
    ("6_groupby_distinct", "presences", "grouped_sum_f32"),
    ("8_groupby_wide", "grouped_multi_sum", "grouped_sum_count_2l"),
)


def table_bytes(table) -> int:
    """Bytes staged for a sharded table, over every slot."""
    arrays = sum(t.numel() * t.element_size() for slots in table.arrays.values() for t in slots)
    return arrays + sum(t.numel() for t in table.n_docs) * 4


def seg_staged_bytes(seg) -> int:
    """Bytes of every staged copy of a segment (the proto, once a rerun has
    staged it)."""
    return sum(t.numel() * t.element_size() for ds in seg._device_cache.values() for t in ds.arrays.values())


def host_transfers(torch, fn) -> dict:
    """The device->host copies and the implicit host syncs of one fn(),
    counted op by op under a TorchDispatchMode: a copy_ or a to() whose
    source lies on the card and whose result lies on the host, and an
    item() of a card tensor (a program that branched on a device value);
    and the copies between two cards (a mesh slot's partial or bucket moving
    to another card; none where the slots share one card, whose `.to()` of
    its own device copies nothing)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.copies, self.items, self.peer = 0, 0, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten.copy_.default and args[0].device.type == "cpu" and args[1].device.type == "cuda":
                self.copies += 1
            elif func is aten._to_copy.default and args[0].device.type == "cuda" and out.device.type == "cpu":
                self.copies += 1
            elif func is aten._local_scalar_dense.default and args[0].device.type == "cuda":
                self.items += 1
            elif func in (aten.copy_.default, aten._to_copy.default):
                src, dst = (args[1], args[0]) if func is aten.copy_.default else (args[0], out)
                if src.device.type == dst.device.type == "cuda" and src.device != dst.device:
                    self.peer += 1
            return out

    with Count() as c:
        fn()
    return {"dtoh_copies": c.copies, "device_scalar_reads": c.items, "cross_card_copies": c.peer}


def program_device_ms(torch, table, sql, iters: int = 5) -> float:
    """Device time alone of the sharded program (the query planned and its
    operands staged once, outside): CUDA events around program() after the
    L2 is flushed and the device has spun ~10 ms, long enough for the host
    to enqueue every launch before the start event runs, so the span holds
    no idle gap. The packed copy is not in it."""
    from pinot_tpu_torch.common.kernel_obs import KERNELS
    from pinot_tpu_torch.parallel import mesh as mesh_mod

    _, _, program = mesh_mod._prepare(table, sql)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    total = 0.0
    KERNELS.configure(enabled=False)  # the kernels alone, no event pairs
    try:
        program()
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(20_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            program()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
    finally:
        KERNELS.configure(enabled=True)
    return total / iters


def sharded_bound(table, sql) -> dict:
    """The least time the sharded program and its copy could take on the
    card's memory: every column it reads, read once over all S x P docs
    (the registry's model, the reference's, counts one segment's P), the
    docs' counts, and the packed vector written once, over 3.35 TB/s."""
    from pinot_tpu_torch.parallel import mesh as mesh_mod

    _, plan, program = mesh_mod._prepare(table, sql)
    vecs, _ = program()
    cols = [c for c in plan.columns]
    read = sum(t.numel() * t.element_size() for c in cols for t in table.arrays[c]) + sum(
        t.numel() for t in table.n_docs
    ) * 4
    packed = sum(v.numel() for v in vecs) * 8
    return {
        "columns": cols,
        "bytes": read + packed,
        "bound_ms": hbm_ms(read + packed),
        "packed_bytes": packed,
        "registry_rows": table.padded,
    }


def exchange_event_ms(table, sql) -> dict:
    """One execute's "exchange.sharded" record: the CUDA event pair around
    the program and its copy, and the registry's bytes (one segment's rows)."""
    from pinot_tpu_torch.common.kernel_obs import KERNELS
    from pinot_tpu_torch.parallel.mesh import execute_sharded_result

    KERNELS.reset_stats()
    execute_sharded_result(table, sql)
    rows = [v for (k, _), v in KERNELS.stats_snapshot().items() if k == "exchange.sharded"]
    return {
        "calls": sum(v["calls"] for v in rows),
        "event_ms": sum(v["deviceMs"] for v in rows),
        "registry_bytes": sum(v["bytesMoved"] for v in rows),
    }


#: the query.kernels wrappers every kernel launch of a query goes through
SPIED_WRAPPERS = ("grouped_multi_sum", "grouped_extremes", "presences")


def spy_calls(run) -> dict:
    """run() with every call of the SPIED_WRAPPERS recorded, in call order:
    {wrapper: [(args, kwargs, result), ...]}. The calls run as they would;
    the spy only keeps their operands."""
    from pinot_tpu_torch.query import kernels as qk

    calls = {n: [] for n in SPIED_WRAPPERS}
    reals = {n: getattr(qk, n) for n in SPIED_WRAPPERS}

    def spy(name, real):
        def call(*a, **k):
            got = real(*a, **k)
            calls[name].append((a, k, got))
            return got

        return call

    for n, real in reals.items():
        setattr(qk, n, spy(n, real))
    try:
        run()
    finally:
        for n, real in reals.items():
            setattr(qk, n, real)
    return calls


def hold_call(torch, fn_name, call, gb, ext, gs) -> dict:
    """One recorded wrapper call held against its plain version on the same
    operands (every output equal): the kernel it launched, its shape, and
    the kernel and plain callables for timing. Raises on a mismatch."""
    a, k, got = call
    if fn_name == "grouped_multi_sum":
        values, gid, mask, ng = a
        flat = gb.uses_shared_counters(min(len(values), gb.MAX_COLS), ng, gid.device)
        kname = "grouped_sum_count" if flat else "grouped_sum_count_2l"
        kernel = (lambda: gb.grouped_multi_sum_kernel(values, gid, mask, ng)) if flat else (
            lambda: gb.grouped_multi_sum_2l_kernel(values, gid, mask, ng))
        plain = lambda: gb.grouped_multi_sum_plain(values, gid, mask, ng)  # noqa: E731
        got = torch.stack([*(s.to(torch.int64) for s in got[0]), got[1]])
        pairs = [(got, plain())]
        shape = {"n": gid.numel(), "k": len(values), "ng": ng}
    elif fn_name == "grouped_extremes":
        columns, outputs, gid, mask, ng, counts = a
        kname = "grouped_extreme"
        kernel = lambda: ext.grouped_extremes_kernel(columns, outputs, gid, mask, ng, counts)  # noqa: E731
        plain = lambda: ext.grouped_extremes_plain(columns, outputs, gid, mask, ng, counts)  # noqa: E731
        pairs = list(zip(got, plain()))
        shape = {"n": gid.numel(), "outputs": len(outputs), "ng": ng}
    else:
        columns, pads, mask = a
        gid, ng = k.get("gid"), k.get("ng", 1)
        kname = "grouped_sum_f32"
        kernel = lambda: gs.presences_kernel(columns, pads, mask, gid=gid, ng=ng)  # noqa: E731
        plain = lambda: gs.presences_plain(columns, pads, mask, gid=gid, ng=ng)  # noqa: E731
        pairs = list(zip(got, plain()))
        shape = {"n": mask.numel(), "columns": len(columns), "ng": ng, "pads": list(pads)}
    for g, w in pairs:
        if not same(torch, g, w):
            raise AssertionError(f"{kname} at {shape} disagrees with its plain version")
    return {
        "kernel": kname,
        **shape,
        "max_abs_err": max(abs_err(torch, g, w) for g, w in pairs),
        "run_kernel": kernel,
        "run_plain": plain,
    }


def timed_hold(torch, held: dict) -> dict:
    """A held call's kernel and plain version timed on its operands: device
    time alone, registry off."""
    from pinot_tpu_torch.common.kernel_obs import KERNELS

    kernel, plain = held.pop("run_kernel"), held.pop("run_plain")
    KERNELS.configure(enabled=False)
    try:
        device_ms, host_ms = device_and_host_ms(torch, kernel, iters=10)
        plain_ms = time_ms(torch, plain, iters=3, warmup=1)
    finally:
        KERNELS.configure(enabled=True)
    return {**held, "kernel_device_ms": device_ms, "kernel_host_ms": host_ms, "plain_ms": plain_ms}


def hold_all(torch, calls: dict, gb, ext, gs) -> list:
    """Every recorded call held against its plain version, untimed."""
    out = []
    for fn_name, recorded in calls.items():
        for call in recorded:
            held = hold_call(torch, fn_name, call, gb, ext, gs)
            del held["run_kernel"], held["run_plain"]
            out.append(held)
    return out


def check_launches(label: str, counters: dict, got: dict, calls: dict, expect: tuple) -> None:
    """A path's launches equal `expect` (in the counters' order), and each
    kernel that launched was reached through a recorded wrapper call."""
    want = dict(zip(counters, expect))
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    if any(got.values()) and not any(calls.values()):
        raise AssertionError(f"{label}: kernels launched through no spied wrapper")


def check_flat_kernels(torch, table, gb, ext, gs) -> dict:
    """Each kernel held against its plain version at the operands of its
    first launch over the flat vector (FLAT_CHECKS), and both timed there."""
    from pinot_tpu_torch.parallel.mesh import execute_sharded_result

    out = {}
    for cfg, fn_name, kname in FLAT_CHECKS:
        calls = spy_calls(lambda: execute_sharded_result(table, CONFIGS[cfg]))
        held = hold_call(torch, fn_name, calls[fn_name][0], gb, ext, gs)
        del calls
        if held["kernel"] != kname:
            raise AssertionError(f"{cfg}: {fn_name} took {held['kernel']}, not {kname}")
        out[kname] = {"config": cfg, **timed_hold(torch, held)}
    return out


def mv_fallback_table(mesh):
    """A MV_FALLBACK_ROWS-row `mvt` (make_mv_data, seed 26) as a sharded
    table of SHARDED_SEGMENTS segments, and config 26's oracle rows over it."""
    from pinot_tpu_torch.parallel import build_sharded_table

    data = make_mv_data(MV_FALLBACK_ROWS, seed=26)
    want = mv_oracle(data)["26_tag_num_pairs"]
    names = np.array([f"tag{i:04d}" for i in range(N_TAGS)], dtype=object)
    cols = {
        "year": data["year"],
        "region": np.array(MV_REGIONS, dtype=object)[data["region"]],
        "revenue": data["revenue"],
    }
    for c, values in (("tags", names), ("nums", None)):
        off = mv_offsets(data, c)
        flat = data[c] if values is None else values[data[c]]
        cells = np.empty(MV_FALLBACK_ROWS, dtype=object)
        for i, cell in enumerate(np.split(flat, off[1:-1])):
            cells[i] = cell
        cols[c] = cells
    table = build_sharded_table(mv_schema(), cols, mesh, rows_per_segment=MV_FALLBACK_ROWS // SHARDED_SEGMENTS)
    return table, want


def run_sharded(torch, counters: dict, data: dict, want: dict, engine) -> dict:
    """Phase 9: the 8M lineorder rows as one sharded table, bench.py's
    configs and configs 5-9 through execute_sharded_result, each against the
    oracle, with its launches (counts from 0 just before, read just after)
    and one device->host copy a query; then the walls beside the per-segment
    engine's, the flat kernels against their plain versions, and the proto
    fallback. Returns the path's launches by kernel and the one-slot
    table."""
    from pinot_tpu_torch.ops import extreme as ext
    from pinot_tpu_torch.ops import groupby as gb
    from pinot_tpu_torch.ops import grouped_sum_f32 as gs
    from pinot_tpu_torch.parallel import build_sharded_table, make_mesh
    from pinot_tpu_torch.parallel import mesh as mesh_mod
    from pinot_tpu_torch.query import plan as plan_mod

    mesh = make_mesh()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    table = build_sharded_table(ssb_schema(), data, mesh, rows_per_segment=N_ROWS // SHARDED_SEGMENTS)
    torch.cuda.synchronize()
    emit(
        {
            "phase": "sharded_setup",
            "rows": N_ROWS,
            "segments": table.n_segments,
            "padded": table.padded,
            "flat_docs": table.n_segments * table.padded,
            "build_s": time.perf_counter() - t0,
            "staged_bytes": table_bytes(table),
            "dtypes": {c: str(t[0].dtype) for c, t in table.arrays.items()},
        }
    )

    fired = []
    real_rerun = mesh_mod._run_on_proto

    def rerun(t, sql):
        fired.append(sql)
        return real_rerun(t, sql)

    mesh_mod._run_on_proto = rerun
    try:
        for fn in counters.values():
            fn.launches = 0
        launches = {}
        for name in SHARDED_CONFIGS:
            before = [fn.launches for fn in counters.values()]
            res = mesh_mod.execute_sharded_result(table, CONFIGS[name])
            launches[name] = {k: fn.launches - b for (k, fn), b in zip(counters.items(), before)}
            expect = dict(zip(counters, LAUNCHES_PER_SEGMENT[name]))
            if launches[name] != expect:
                raise AssertionError(f"sharded {name}: launches {launches[name]}, expected {expect}")
            rows_match(f"sharded {name}", res.rows, want[name])
            if res.total_docs != N_ROWS or res.num_segments_queried != table.n_segments or res.num_docs_scanned <= 0:
                raise AssertionError(f"sharded {name}: totalDocs {res.total_docs}, segments {res.num_segments_queried}")
        path_launches = {k: fn.launches for k, fn in counters.items()}
        for k, v in path_launches.items():
            if v == 0:
                raise AssertionError(f"the sharded path never launched {k}")
        if fired:
            raise AssertionError(f"the sharded path reran {fired} on the proto")
        emit({"phase": "sharded_path", "results_match_oracle": True, "launches_per_config": launches,
              "launches": path_launches})

        per_query = {}
        for name in SHARDED_CONFIGS:
            sql = CONFIGS[name]
            sharded = wall_p50_of(lambda: mesh_mod.execute_sharded_result(table, sql), warm=1)
            per_segment = wall_p50(engine, sql, warm=1)
            moves = host_transfers(torch, lambda: mesh_mod.execute_sharded_result(table, sql))
            if moves != {"dtoh_copies": 1, "device_scalar_reads": 0, "cross_card_copies": 0}:
                raise AssertionError(f"sharded {name}: {moves}, expected one device->host copy and no scalar read")
            busy = program_device_ms(torch, table, sql)
            per_query[name] = {
                "sharded_p50_ms": sharded["p50_ms"],
                "sharded_runs_ms": sharded["runs_ms"],
                "per_segment_p50_ms": per_segment["p50_ms"],
                "per_segment_runs_ms": per_segment["runs_ms"],
                "launches": launches[name],
                "program_device_ms": busy,
                "device_idle_share": 1.0 - busy / sharded["p50_ms"],
                **moves,
                "per_segment": host_transfers(torch, lambda: engine.execute(sql)),
                "exchange": exchange_event_ms(table, sql),
                "bound": sharded_bound(table, sql),
            }
        emit({"phase": "sharded", "queries": per_query, "card": card_line()})
        emit({"phase": "sharded_kernels", "kernels": check_flat_kernels(torch, table, gb, ext, gs),
              "card": card_line()})

        # the proto fallback: two MV keys, then a sparse group-by whose
        # present groups pass its slots (U cut by MAX_DENSE_GROUPS); each
        # rerun's launches counted from 0 just before its first run and read
        # just after, and each kernel call of that run held against its plain
        # version on the same operands
        t0 = time.perf_counter()
        mv_table, mv_want = mv_fallback_table(mesh)
        t_mv = time.perf_counter() - t0
        fallback = {}
        fallback_launches = dict.fromkeys(counters, 0)
        for label, tbl, sql, want_rows in (
            ("26_tag_num_pairs", mv_table, MV_CONFIGS["26_tag_num_pairs"], mv_want),
            ("9_groupby_sparse_overflow", table, CONFIGS["9_groupby_sparse"], want["9_groupby_sparse"]),
        ):
            saved = plan_mod.MAX_DENSE_GROUPS
            if label.endswith("overflow"):
                plan_mod.MAX_DENSE_GROUPS = OVERFLOW_SLOTS
            n_fired = len(fired)
            got = []
            try:
                for fn in counters.values():
                    fn.launches = 0
                t0 = time.perf_counter()
                calls = spy_calls(lambda: got.append(mesh_mod.execute_sharded_result(tbl, sql)))
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t0) * 1e3
                run_launches = {k: fn.launches for k, fn in counters.items()}
                check_launches(f"proto fallback {label}", counters, run_launches, calls, FALLBACK_LAUNCHES[label])
                rows_match(f"proto fallback {label}", got[0].rows, want_rows)
                held = hold_all(torch, calls, gb, ext, gs)
                del calls, got
                again = wall_p50_of(lambda: mesh_mod.execute_sharded_result(tbl, sql), warm=0, runs=3)
            finally:
                plan_mod.MAX_DENSE_GROUPS = saved
            if len(fired) - n_fired != 4:
                raise AssertionError(f"proto fallback {label}: {len(fired) - n_fired} reruns, expected 4")
            for k, v in run_launches.items():
                fallback_launches[k] += v
            fallback[label] = {
                "first_ms": first_ms,
                "p50_ms": again["p50_ms"],
                "runs_ms": again["runs_ms"],
                "launches": run_launches,
                "kernels_vs_plain": held,
                "table_staged_bytes": table_bytes(tbl),
                "proto_staged_bytes": seg_staged_bytes(tbl.proto),
            }
        emit({"phase": "proto_fallback", "results_match_oracle": True, "mv_table_build_s": t_mv,
              "mv_rows": MV_FALLBACK_ROWS, "fired": len(fired), "queries": fallback,
              "launches": fallback_launches,
              "max_memory_allocated": torch.cuda.max_memory_allocated(), "card": card_line()})
    finally:
        mesh_mod._run_on_proto = real_rerun
    return {k: path_launches[k] + fallback_launches[k] for k in counters}, table


def run_sharded_scale(torch, counters: dict) -> dict:
    """bench.py's scale block: SCALE_ROWS rows of its generator (seed 7) as a
    sharded table of SHARDED_SEGMENTS segments; Q4 and Q2 against the
    oracle, with their launches (counts from 0 just before the path, read
    just after), each kernel call of the path held against its plain version
    on the same operands and timed there, then build seconds, staged bytes,
    p50 and rows per second. Returns the path's launches by kernel."""
    from pinot_tpu_torch.ops import extreme as ext
    from pinot_tpu_torch.ops import groupby as gb
    from pinot_tpu_torch.ops import grouped_sum_f32 as gs
    from pinot_tpu_torch.parallel import build_sharded_table, make_mesh
    from pinot_tpu_torch.parallel.mesh import execute_sharded_result

    t0 = time.perf_counter()
    data, nation, category = make_ssb_data(SCALE_ROWS, seed=SCALE_SEED)
    del data["lo_custkey"], data["lo_suppkey"]  # bench.py's six columns
    want = {"4_q4_groupby_orderby": q4_rows(data, nation, category), "2_filtered_agg": q2_rows(data, nation)}
    del nation, category
    t_gen = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    table = build_sharded_table(ssb_schema(keys=False), data, make_mesh(), rows_per_segment=SCALE_ROWS // SHARDED_SEGMENTS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del data

    for fn in counters.values():
        fn.launches = 0
    launches, recorded = {}, {}
    for name in SCALE_CONFIGS:
        before = [fn.launches for fn in counters.values()]
        got = []
        recorded[name] = spy_calls(lambda: got.append(execute_sharded_result(table, CONFIGS[name])))
        launches[name] = {k: fn.launches - b for (k, fn), b in zip(counters.items(), before)}
        check_launches(f"scale {name}", counters, launches[name], recorded[name], LAUNCHES_PER_SEGMENT[name])
        rows_match(f"scale {name}", got[0].rows, want[name])
    path_launches = {k: fn.launches for k, fn in counters.items()}
    held = {}
    for name, calls in recorded.items():
        held[name] = [
            timed_hold(torch, hold_call(torch, fn_name, call, gb, ext, gs))
            for fn_name, rec in calls.items()
            for call in rec
        ]
    del recorded
    emit({"phase": "sharded_scale_path", "results_match_oracle": True, "launches_per_config": launches,
          "launches": path_launches, "kernels_vs_plain": held, "card": card_line()})

    queries = {}
    for name in SCALE_CONFIGS:
        sql = CONFIGS[name]
        w = wall_p50_of(lambda: execute_sharded_result(table, sql), warm=1, runs=WALL_RUNS)
        busy = program_device_ms(torch, table, sql)
        queries[name] = {**w, "rows_per_s": SCALE_ROWS / (w["p50_ms"] / 1e3),
                         "program_device_ms": busy, "device_idle_share": 1.0 - busy / w["p50_ms"],
                         **host_transfers(torch, lambda: execute_sharded_result(table, sql)),
                         "bound": sharded_bound(table, sql)}
    emit(
        {
            "phase": "sharded_scale",
            "rows": SCALE_ROWS,
            "segments": table.n_segments,
            "padded": table.padded,
            "generate_and_oracle_s": t_gen,
            "build_s": build_s,
            "staged_bytes": table_bytes(table),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "results_match_oracle": True,
            "queries": queries,
            "card": card_line(),
        }
    )
    return path_launches


# ---------------------------------------------------------------------------
# phase 11: the mesh of slots (bench.py's sharded path over D slots)
# ---------------------------------------------------------------------------

#: the mesh's slots: four programs a query, all on the one card
MESH_SLOTS = 4


def slot_program_ms(torch, table, sql, iters: int = 5) -> list:
    """Each slot's program alone (its flat program over its S/D segments,
    no merge, no copy): device ms between CUDA events after an L2 flush and
    a spin, as program_device_ms times the whole mesh's."""
    from pinot_tpu_torch.common.kernel_obs import KERNELS
    from pinot_tpu_torch.parallel import mesh as mesh_mod
    from pinot_tpu_torch.query.kernels import stage_operands

    _, plan, _ = mesh_mod._prepare(table, sql)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out = []
    KERNELS.configure(enabled=False)
    try:
        for d, dev in enumerate(table.mesh.devices):
            kernel = mesh_mod._sharded_kernel(plan.spec, table.padded, (dev,))
            cols = [{c: table.arrays[c][d] for c in plan.columns}]
            ops = [stage_operands(list(plan.operands), dev)]
            nd = [table.n_docs[d]]
            kernel(cols, ops, nd)
            total = 0.0
            for _ in range(iters):
                flush.zero_()
                torch.cuda._sleep(20_000_000)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                kernel(cols, ops, nd)
                end.record()
                end.synchronize()
                total += start.elapsed_time(end)
            out.append(total / iters)
    finally:
        KERNELS.configure(enabled=True)
    return out


def run_mesh(torch, counters: dict, data: dict, want: dict, one_slot) -> dict:
    """Phase 11: the same 8M rows over make_mesh(("cuda:0",) * 4): D = 4
    slots, one segment each (S = 4, P = 2,000,896), the phase-9 configs
    through execute_sharded_result, each equal to the oracle and to the
    one-slot table's rows, with its launches (counts from 0 just before the
    path, read just after; D times the one-slot count) and every kernel call
    held against its plain version on the same operands, its device->host
    and cross-card copies, its wall p50 beside the one-slot table's in this
    call, the mesh program's device time and each slot's. Returns the
    path's launches by kernel."""
    from pinot_tpu_torch.ops import extreme as ext
    from pinot_tpu_torch.ops import groupby as gb
    from pinot_tpu_torch.ops import grouped_sum_f32 as gs
    from pinot_tpu_torch.parallel import build_sharded_table, make_mesh
    from pinot_tpu_torch.parallel import mesh as mesh_mod
    from pinot_tpu_torch.segment.segment import padded_len

    mesh = make_mesh(("cuda:0",) * MESH_SLOTS)
    t0 = time.perf_counter()
    table = build_sharded_table(ssb_schema(), data, mesh)
    torch.cuda.synchronize()
    emit(
        {
            "phase": "mesh_setup",
            "slots": [str(d) for d in mesh.devices],
            "segments": table.n_segments,
            "padded": table.padded,
            "build_s": time.perf_counter() - t0,
            "staged_bytes": table_bytes(table),
        }
    )
    if (table.n_segments, table.padded) != (MESH_SLOTS, padded_len(N_ROWS // MESH_SLOTS)):
        raise AssertionError(f"mesh: S {table.n_segments}, P {table.padded}")
    # the one-slot answers, before the counted window
    one_rows = {name: mesh_mod.execute_sharded_result(one_slot, CONFIGS[name]).rows for name in SHARDED_CONFIGS}
    for fn in counters.values():
        fn.launches = 0
    launches, held = {}, {}
    for name in SHARDED_CONFIGS:
        before = [fn.launches for fn in counters.values()]
        got = []
        calls = spy_calls(lambda: got.append(mesh_mod.execute_sharded_result(table, CONFIGS[name])))
        launches[name] = {k: fn.launches - b for (k, fn), b in zip(counters.items(), before)}
        expect = tuple(MESH_SLOTS * v for v in LAUNCHES_PER_SEGMENT[name])
        check_launches(f"mesh {name}", counters, launches[name], calls, expect)
        rows_match(f"mesh {name}", got[0].rows, want[name])
        rows_match(f"mesh {name} against one slot", got[0].rows, one_rows[name])
        # each slot's kernel calls against their plain versions on the same
        # card operands (the plain versions launch no kernel)
        held[name] = hold_all(torch, calls, gb, ext, gs)
        del calls, got
    path_launches = {k: sum(v[k] for v in launches.values()) for k in counters}
    if path_launches != {k: fn.launches for k, fn in counters.items()}:
        raise AssertionError(f"mesh: launches outside the configs' runs: {path_launches}")
    emit({"phase": "mesh_path", "results_match_oracle": True, "launches_per_config": launches,
          "launches": path_launches, "kernels_vs_plain": held})

    per_query = {}
    for name in SHARDED_CONFIGS:
        sql = CONFIGS[name]
        sparse = name == "9_groupby_sparse"
        mesh_w = wall_p50_of(lambda: mesh_mod.execute_sharded_result(table, sql), warm=1)
        one_w = wall_p50_of(lambda: mesh_mod.execute_sharded_result(one_slot, sql), warm=1)
        moves = host_transfers(torch, lambda: mesh_mod.execute_sharded_result(table, sql))
        want_moves = {"dtoh_copies": MESH_SLOTS if sparse else 1, "device_scalar_reads": 0, "cross_card_copies": 0}
        if moves != want_moves:
            raise AssertionError(f"mesh {name}: {moves}, expected {want_moves}")
        busy = program_device_ms(torch, table, sql)
        per_query[name] = {
            "mesh_p50_ms": mesh_w["p50_ms"],
            "mesh_runs_ms": mesh_w["runs_ms"],
            "one_slot_p50_ms": one_w["p50_ms"],
            "one_slot_runs_ms": one_w["runs_ms"],
            "launches": launches[name],
            **moves,
            "mesh_program_device_ms": busy,
            "one_slot_program_device_ms": program_device_ms(torch, one_slot, sql),
            "slot_program_device_ms": slot_program_ms(torch, table, sql),
            "device_idle_share": 1.0 - busy / mesh_w["p50_ms"],
            "exchange": exchange_event_ms(table, sql),
        }
    emit({"phase": "mesh", "slots": MESH_SLOTS, "queries": per_query, "card": card_line()})
    return path_launches


# ---------------------------------------------------------------------------
# phase 12: the hash exchange across slots
# ---------------------------------------------------------------------------

#: config 6's fact side: lo_custkey's range on the left, every key once on
#: the right
SHUFFLE_LEFT, SHUFFLE_RIGHT = 4_000_000, N_CUSTOMERS


def join_bound_ms(n_left: int, n_right: int, pairs: int) -> float:
    """The least time of the join on the card's memory: each side's int64
    keys and int32 row ids read once, the pairs' two int32 ids written once."""
    return hbm_ms((n_left + n_right) * 12 + pairs * 8)


def run_shuffle(torch) -> dict:
    """Phase 12: mesh_equi_join over four slots on the card: 4,000,000 left
    keys drawn from [1, 90,000] and the 90,000 right keys once each, the
    pairs equal to the numpy join's as sets; the declines (a duplicate right
    key, the sentinel key); a forced overflow (every left key equal) that the
    retry at the safe capacity completes; hash_exchange delivering every row
    once, to the slot of its key's hash; exchange_group_partials equal to a
    plain sum. The `exchange.join` event ms beside its bound."""
    from pinot_tpu_torch.common.kernel_obs import KERNELS
    from pinot_tpu_torch.parallel import make_mesh, shuffle
    from pinot_tpu_torch.query.sketches import hash_any

    mesh = make_mesh(("cuda:0",) * MESH_SLOTS)
    rng = np.random.default_rng(12)
    lk = rng.integers(1, N_CUSTOMERS + 1, SHUFFLE_LEFT).astype(np.int64)
    rk = rng.permutation(np.arange(1, SHUFFLE_RIGHT + 1, dtype=np.int64))
    row_of = np.empty(SHUFFLE_RIGHT + 1, dtype=np.int64)
    row_of[rk] = np.arange(SHUFFLE_RIGHT)

    shuffle.mesh_equi_join(lk, rk, mesh)  # warm
    KERNELS.reset_stats()
    t0 = time.perf_counter()
    out = shuffle.mesh_equi_join(lk, rk, mesh)
    first_ms = (time.perf_counter() - t0) * 1e3
    rows = [v for (k, _), v in KERNELS.stats_snapshot().items() if k == "exchange.join"]
    if out is None:
        raise AssertionError("shuffle: mesh_equi_join declined the FK->PK join")
    li, ri = out
    order = np.argsort(li, kind="stable")
    if not (np.array_equal(li[order], np.arange(SHUFFLE_LEFT)) and np.array_equal(ri[order], row_of[lk])):
        raise AssertionError("shuffle: the pairs differ from the numpy join's")
    wall = wall_p50_of(lambda: shuffle.mesh_equi_join(lk, rk, mesh), warm=0, runs=WALL_RUNS)

    dup = rk.copy()
    dup[1] = dup[0]
    sentinel = rk.copy()
    sentinel[0] = np.iinfo(np.int64).max
    declines = {
        "duplicate_right_key": shuffle.mesh_equi_join(lk, dup, mesh) is None,
        "sentinel_right_key": shuffle.mesh_equi_join(lk, sentinel, mesh) is None,
    }
    if not all(declines.values()):
        raise AssertionError(f"shuffle: declines {declines}")

    capacities = []
    real = shuffle._join_kernel
    shuffle._join_kernel = lambda dev, cap, dt: capacities.append(cap) or real(dev, cap, dt)
    try:
        skew = np.full(SHUFFLE_LEFT, 7, dtype=np.int64)
        got = shuffle.mesh_equi_join(skew, rk, mesh)
    finally:
        shuffle._join_kernel = real
    if got is None or len(got[0]) != SHUFFLE_LEFT or not np.all(rk[got[1]] == 7) or len(capacities) != 2:
        raise AssertionError(f"shuffle: the overflow retry ({capacities}) did not complete the join")

    n_local = SHUFFLE_LEFT // MESH_SLOTS
    keys = [torch.from_numpy(lk[d * n_local : (d + 1) * n_local]).to(dev) for d, dev in enumerate(mesh.devices)]
    ids = [torch.arange(d * n_local, (d + 1) * n_local, device=dev) for d, dev in enumerate(mesh.devices)]
    cols, valid, dropped = shuffle.hash_exchange(
        [(k, i) for k, i in zip(keys, ids)], keys, [torch.ones_like(k, dtype=torch.bool) for k in keys],
        mesh.devices, n_local,
    )
    dest = (hash_any(lk) % np.uint32(MESH_SLOTS)).astype(np.int64)
    got_ids = [c[1][v].cpu().numpy() for c, v in zip(cols, valid)]
    if int(dropped) or not np.array_equal(np.sort(np.concatenate(got_ids)), np.arange(SHUFFLE_LEFT)):
        raise AssertionError("shuffle: hash_exchange lost or repeated rows")
    if any(not np.all(dest[g] == d) for d, g in enumerate(got_ids)):
        raise AssertionError("shuffle: a row reached another slot than its key's hash")

    parts = np.random.default_rng(9).integers(-1000, 1000, (MESH_SLOTS, 1 << 16)).astype(np.int64)
    merged = shuffle.exchange_group_partials([torch.from_numpy(p).to(d) for p, d in zip(parts, mesh.devices)], mesh.devices)
    if any(not np.array_equal(m.cpu().numpy(), parts.sum(axis=0)) for m in merged):
        raise AssertionError("shuffle: exchange_group_partials differs from the sum")

    emit(
        {
            "phase": "shuffle",
            "slots": MESH_SLOTS,
            "left_rows": SHUFFLE_LEFT,
            "right_rows": SHUFFLE_RIGHT,
            "pairs": int(len(li)),
            "pairs_match_numpy": True,
            "declines": declines,
            "overflow_capacities": capacities,
            "hash_exchange_rows": int(sum(len(g) for g in got_ids)),
            "first_ms": first_ms,
            "p50_ms": wall["p50_ms"],
            "runs_ms": wall["runs_ms"],
            "exchange_join": {
                "calls": sum(v["calls"] for v in rows),
                "event_ms": sum(v["deviceMs"] for v in rows),
                "registry_bytes": sum(v["bytesMoved"] for v in rows),
            },
            "bound_ms": join_bound_ms(SHUFFLE_LEFT, SHUFFLE_RIGHT, len(li)),
            "card": card_line(),
        }
    )
    return {"p50_ms": wall["p50_ms"]}


# ---------------------------------------------------------------------------
# phase 10: the segment store, loader and indexes
# ---------------------------------------------------------------------------

#: bench.py's configs read back from the written segments
STORE_CONFIGS = ("3_q1_groupby", "4_q4_groupby_orderby")
#: configs 28-30's segments with a bloom filter on lo_custkey and an inverted
#: index on c_nation
TP_INDEXES = (("bloom_filter", "lo_custkey"), ("inverted_index", "c_nation"))
#: the small text / JSON table of TEXT_MATCH and JSON_MATCH
DOCS_ROWS = 200_000
DOC_WORDS = ["espresso", "latte", "tea", "juice", "bagel", "muffin"]
DOC_COLORS = ["red", "green", "blue"]
DOCS_CONFIGS = {
    "text_match": "SELECT COUNT(*), SUM(v) FROM docs WHERE TEXT_MATCH(descr, 'latte AND tea')",
    "json_match": "SELECT COUNT(*), SUM(v) FROM docs WHERE JSON_MATCH(attrs, '\"$.color\"=''red''') AND v > 500",
}


def docs_table(seed: int = 31):
    """DOCS_ROWS rows of three distinct words (`descr`, a text index), a
    JSON attribute document (`attrs`, a JSON index) and a LONG `v`; the
    numpy oracle of DOCS_CONFIGS."""
    rng = np.random.default_rng(seed)
    pick = np.argsort(rng.random((DOCS_ROWS, len(DOC_WORDS))), axis=1)[:, :3]
    color = rng.integers(0, len(DOC_COLORS), DOCS_ROWS)
    size = rng.integers(0, 5, DOCS_ROWS)
    v = rng.integers(0, 1000, DOCS_ROWS).astype(np.int64)
    data = {
        "descr": np.array([" ".join(DOC_WORDS[i] for i in row) for row in pick.tolist()], dtype=object),
        "attrs": np.array(
            [f'{{"color": "{DOC_COLORS[c]}", "size": {s}}}' for c, s in zip(color.tolist(), size.tolist())], dtype=object
        ),
        "v": v,
    }
    has = (pick == DOC_WORDS.index("latte")).any(axis=1) & (pick == DOC_WORDS.index("tea")).any(axis=1)
    red = (color == 0) & (v > 500)
    want = {
        "text_match": [[int(has.sum()), float(v[has].sum())]],
        "json_match": [[int(red.sum()), float(v[red].sum())]],
    }
    return data, want


def run_store(torch, engine, segments, tp_segments, data) -> None:
    """Phase 10: the 2 lineorder segments written with the default codec and
    loaded back (configs 3-4 from the loaded segments equal to the in-memory
    engine's rows); configs 28-30's segments with a bloom filter and an
    inverted index (a lo_custkey point lookup against the oracle, its bloom-
    pruned count beside the min/max-pruned count); TEXT_MATCH and JSON_MATCH
    over a text / JSON table through the program's docmask operand on the
    card, against the numpy oracle."""
    import tempfile

    from pinot_tpu_torch.common import DataType, IndexingConfig, Schema, TableConfig
    from pinot_tpu_torch.query import QueryEngine
    from pinot_tpu_torch.query.plan import plan_segment
    from pinot_tpu_torch.segment import SegmentBuilder, index_spi, load_segment, store, write_segment

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as tmp:
        t0 = time.perf_counter()
        dirs = [write_segment(seg, tmp) for seg in segments]
        write_s = time.perf_counter() - t0
        files = [d / store.SEGMENT_FILE for d in dirs]
        t0 = time.perf_counter()
        loaded = [load_segment(d) for d in dirs]
        load_s = time.perf_counter() - t0
        codecs = {}
        for f in files:
            for e in store.SegmentFileReader(f, verify=False).entries.values():
                codecs[e["codec"]] = codecs.get(e["codec"], 0) + 1
        loaded_engine = QueryEngine(loaded, device="cuda")
        queries = {}
        for name in STORE_CONFIGS:
            sql = CONFIGS[name]
            t0 = time.perf_counter()
            got = loaded_engine.execute(sql)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            want = engine.execute(sql)
            rows_match(f"store {name}", got.rows, want.rows)
            queries[name] = {
                "first_query_ms": first_ms,
                "loaded_p50_ms": wall_p50(loaded_engine, sql, warm=1)["p50_ms"],
                "in_memory_p50_ms": wall_p50(engine, sql, warm=1)["p50_ms"],
            }
        out["lineorder"] = {
            "segments": len(files),
            "write_s": write_s,
            "load_s": load_s,
            "file_bytes": [f.stat().st_size for f in files],
            "entries_by_codec": codecs,
            "file_crc": [store.segment_file_crc(f) for f in files],
            "queries": queries,
        }
        del loaded, loaded_engine

    # configs 28-30's segments, indexed through the index SPI
    t0 = time.perf_counter()
    for seg in tp_segments:
        for kind, col in TP_INDEXES:
            spec = index_spi.get_index_type(kind)
            seg.extras.setdefault(spec.target_key, {})[col] = spec.build(seg, col, None)
    index_s = time.perf_counter() - t0
    tp = QueryEngine(tp_segments, device="cuda")
    holders = {}
    for seg in tp_segments:
        for k in seg.columns["lo_custkey"].dictionary.values.tolist():
            holders[k] = holders.get(k, 0) + 1
    key = min(holders, key=lambda k: (holders[k], k))
    cust = data["lo_custkey"]
    m = cust == key
    sql = f"SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE lo_custkey = {key}"
    res = tp.execute(sql)
    rows_match("store bloom lookup", res.rows, [[int(m.sum()), float(data["lo_revenue"][m].sum())]])
    if res.num_segments_pruned_by_bloom > TP_SEGMENTS - holders[key]:
        raise AssertionError(f"bloom pruned {res.num_segments_pruned_by_bloom} segments, {holders[key]} hold {key}")
    inv = tp.execute(CONFIGS["1_count_filter"])
    rows_match("store inverted", inv.rows, [[int((data["c_nation"] == "NATION_07").sum())]])
    if "c_nation:INVERTED_INDEX" not in inv.scan_profile["predicates"]:
        raise AssertionError(f"no INVERTED_INDEX in {inv.scan_profile['predicates']}")
    out["tp_indexes"] = {
        "index_build_s": index_s,
        "key": int(key),
        "segments_holding_key": holders[key],
        "pruned_by_bloom": res.num_segments_pruned_by_bloom,
        "pruned_by_value": res.num_segments_pruned_by_value,
        "lookup_p50_ms": wall_p50(tp, sql, warm=1)["p50_ms"],
        "inverted_scan_profile": inv.scan_profile["predicates"],
    }

    # TEXT_MATCH / JSON_MATCH through the program's docmask operand
    t0 = time.perf_counter()
    docs, want = docs_table()
    schema = Schema.build("docs", dimensions=[("descr", DataType.STRING), ("attrs", DataType.JSON)],
                          metrics=[("v", DataType.LONG)])
    cfg = TableConfig("docs", IndexingConfig(text_index_columns=["descr"], json_index_columns=["attrs"]))
    seg = SegmentBuilder(schema, cfg).build(docs, "docs_0")
    build_s = time.perf_counter() - t0
    eng = QueryEngine([seg], device="cuda")
    probes = {}
    for name, sql in DOCS_CONFIGS.items():
        if "docmask" not in repr(plan_segment(seg, eng.make_context(sql)).spec):
            raise AssertionError(f"{name}: no docmask operand in the plan")
        eng.segment_modes.clear()
        got = eng.execute(sql)
        rows_match(f"store {name}", got.rows, want[name])
        if dict(eng.segment_modes) != {"device": 1}:
            raise AssertionError(f"{name}: segments by executor {dict(eng.segment_modes)}")
        probes[name] = {"p50_ms": wall_p50(eng, sql, warm=1)["p50_ms"], "scan_profile": got.scan_profile["predicates"]}
    out["docs"] = {"rows": DOCS_ROWS, "build_s_with_indexes": build_s, "queries": probes}
    emit({"phase": "store", "results_match": True, **out, "card": card_line()})


# ---------------------------------------------------------------------------
# phase 13: the multistage engine (bench.py's config 6)
# ---------------------------------------------------------------------------

#: bench.py's config 6: JOIN_ROWS fact rows of its generator under seed 6
JOIN_ROWS, JOIN_SEED = 4_000_000, 6
JOIN_NATIONS = [f"NATION_{i:02d}" for i in range(25)]
JOIN_REGIONS = [f"REGION_{i % 5}" for i in range(25)]
CONFIG6_SQL = (
    "SELECT d.region, SUM(l.lo_revenue) FROM lineorder l "
    "JOIN nation_dim d ON l.c_nation = d.nation "
    "GROUP BY d.region ORDER BY SUM(l.lo_revenue) DESC"
)
#: over the same fact rows: the device join and sort (a lookup join on an
#: integer key, 4M rows ordered), the device window (its sort and running
#: sum over 4M rows), and a leaf Scan filter as the `mask` program
MULTISTAGE_QUERIES = {
    "device_join_sort": (
        "SELECT q.qty, q.band, l.lo_revenue FROM lineorder l JOIN qty_dim q ON l.lo_quantity = q.qty "
        "ORDER BY l.lo_revenue DESC, q.qty LIMIT 40"
    ),
    "device_window": (
        "SELECT l.d_year, l.lo_revenue, SUM(l.lo_quantity) OVER (PARTITION BY l.d_year ORDER BY l.lo_revenue DESC) "
        "FROM lineorder l ORDER BY l.lo_revenue DESC, l.d_year LIMIT 20"
    ),
    "leaf_mask": (
        "SELECT d.region, l.lo_revenue FROM lineorder l JOIN nation_dim d ON l.c_nation = d.nation "
        "WHERE l.lo_quantity = 1 AND l.lo_revenue > 590000"
    ),
}
#: the device operators each query must engage (DEVICE_OP_STATS)
MULTISTAGE_OPS = {"device_join_sort": ("join", "sort"), "device_window": ("sort", "window"), "leaf_mask": ()}


def join_fact_data(n: int, seed: int = JOIN_SEED) -> dict:
    """bench.py's `_make_ssb_data` draws, in its column order."""
    rng = np.random.default_rng(seed)
    return {
        "d_year": rng.integers(1992, 1999, n).astype(np.int32),
        "c_nation": np.array(JOIN_NATIONS, dtype=object)[rng.integers(0, 25, n)],
        "p_category": np.array(CATEGORIES, dtype=object)[rng.integers(0, 25, n)],
        "lo_revenue": rng.integers(100, 600_000, n).astype(np.int64),
        "lo_supplycost": rng.integers(50, 100_000, n).astype(np.int64),
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
    }


def multistage_dims() -> list:
    """config 6's dimension tables as (schema, segment): the 25-row
    nation_dim and the 50-row qty_dim of the device-join query."""
    from pinot_tpu_torch.common import DataType, Schema
    from pinot_tpu_torch.segment import SegmentBuilder

    nd_schema = Schema.build("nation_dim", dimensions=[("nation", DataType.STRING), ("region", DataType.STRING)], metrics=[])
    nation_dim = SegmentBuilder(nd_schema).build(
        {"nation": np.array(JOIN_NATIONS, dtype=object), "region": np.array(JOIN_REGIONS, dtype=object)}, "join_dim"
    )
    qty = np.arange(1, 51, dtype=np.int32)
    qd_schema = Schema.build("qty_dim", dimensions=[("qty", DataType.INT), ("band", DataType.STRING)], metrics=[])
    qty_dim = SegmentBuilder(qd_schema).build(
        {"qty": qty, "band": np.array([f"B{q // 10}" for q in qty], dtype=object)}, "qty_dim"
    )
    return [(nd_schema, nation_dim), (qd_schema, qty_dim)]


def multistage_catalog(data: dict) -> dict:
    """config 6's tables: the fact segment and multistage_dims()."""
    from pinot_tpu_torch.segment import SegmentBuilder

    fact = SegmentBuilder(ssb_schema(keys=False)).build(data, "join_fact")
    return {"lineorder": [fact], **{sch.name: [seg] for sch, seg in multistage_dims()}}


def multistage_oracle(data: dict) -> dict:
    """Each query's rows from the raw arrays (numpy, stable sorts where the
    engine's sorts are stable)."""
    rev, qty, year = data["lo_revenue"], data["lo_quantity"], data["d_year"]
    nation = np.searchsorted(np.array(JOIN_NATIONS), data["c_nation"].astype(str))
    region = np.array([i % 5 for i in range(25)])[nation]
    sums = np.bincount(region, weights=rev, minlength=5)
    out = {"config6": [[f"REGION_{r}", float(sums[r])] for r in np.argsort(-sums, kind="stable")]}
    top = np.lexsort((qty, -rev))[:40]
    out["device_join_sort"] = [[int(qty[i]), f"B{qty[i] // 10}", int(rev[i])] for i in top]
    order = np.lexsort((-rev, year))  # the window's partition and order, ties by scan order
    rs = np.empty(len(rev), dtype=np.int64)
    ys = year[order]
    starts = np.r_[0, np.flatnonzero(ys[1:] != ys[:-1]) + 1, len(ys)]
    for a, b in zip(starts[:-1], starts[1:]):
        rs[order[a:b]] = np.cumsum(qty[order[a:b]].astype(np.int64))
    top = np.lexsort((year, -rev))[:20]
    out["device_window"] = [[int(year[i]), int(rev[i]), int(rs[i])] for i in top]
    m = (qty == 1) & (rev > 590000)
    out["leaf_mask"] = sorted([f"REGION_{r}", int(v)] for r, v in zip(region[m], rev[m]))
    out["root_sort"] = [[int(v), "B0"] for v in np.sort(rev[qty == 1])[::-1]]
    return out


def host_costs(data: dict) -> dict:
    """The host cost per row of the numpy paths the economic gates weigh
    the device against (the reference's constants: mergesort 150 ns a row a
    key, groupby-cumsum 80 ns a row, hash join 70 ns an input row), at this
    phase's 4M rows, beside the device op on the same inputs."""
    from pinot_tpu_torch.common.sorting import sort_nulls_largest
    from pinot_tpu_torch.multistage import runtime as rt

    n = len(data["lo_revenue"])
    rev, qty = data["lo_revenue"], data["lo_quantity"]
    gk = np.sort(data["d_year"]).astype(np.int64)
    keys = qty.astype(np.float64)
    dim = np.arange(1, 51, dtype=np.float64)

    def best(fn, runs=3):
        ms = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        return min(ms)

    sort_host = best(lambda: sort_nulls_largest([rev, qty], [False, True]))
    sort_dev = best(lambda: rt._device_sort_perm([rev, qty], [True, False], "cuda"))
    win_host = best(lambda: rt._cum_in_groups("sum", gk, qty))
    win_dev = best(lambda: rt._device_window_cum("sum", gk, qty, n, "cuda"))
    join_host = best(lambda: rt.merge_inner([keys], [dim]))
    join_dev = best(lambda: rt._device_equi_join(keys, dim, force=True, device="cuda"))
    return {
        "rows": n,
        "sort": {"host_ms": sort_host, "host_ns_per_row_key": sort_host * 1e6 / (2 * n), "device_ms": sort_dev,
                 "constant_ns": 150},
        "window": {"host_ms": win_host, "host_ns_per_row": win_host * 1e6 / n, "device_ms": win_dev, "constant_ns": 80},
        "join": {"host_ms": join_host, "host_ns_per_input_row": join_host * 1e6 / (n + 50), "device_ms": join_dev,
                 "constant_ns": 70},
    }


def run_multistage(torch, counters: dict) -> dict:
    """Phase 13: bench.py's config 6 at its own shape (4M fact rows of its
    generator, seed 6; the 25-row nation_dim; its SQL) through
    MultistageEngine(..., device="cuda"): the ordered rows equal the oracle,
    and the leaf's partial aggregate launches the exact group-by kernel
    (counts from 0 just before, read just after), each of its kernel calls
    held against its plain version on the same operands. Then, over the same fact
    rows, a query each whose DEVICE_OP_STATS show the device join and sort,
    and the device window, and one whose leaf Scan filter runs the `mask`
    program, each against its oracle. Reports wall p50s, link_profile(),
    the stage operators' host split (trace=true) and the host cost per row
    of the numpy paths beside the economic gates' constants. Returns the
    phase's launches by kernel."""
    from pinot_tpu_torch.common.devlink import link_profile
    from pinot_tpu_torch.multistage import MultistageEngine
    from pinot_tpu_torch.ops import extreme as ext
    from pinot_tpu_torch.ops import groupby as gb
    from pinot_tpu_torch.ops import grouped_sum_f32 as gs
    from pinot_tpu_torch.multistage import runtime as rt
    from pinot_tpu_torch.query import kernels as qk

    t0 = time.perf_counter()
    data = join_fact_data(JOIN_ROWS)
    want = multistage_oracle(data)
    catalog = multistage_catalog(data)
    catalog["lineorder"][0].to_device_cached("cuda")  # staged once, from the main thread
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    engine = MultistageEngine(catalog, device="cuda")

    for fn in counters.values():
        fn.launches = 0
    got = []
    calls = spy_calls(lambda: got.append(engine.execute(CONFIG6_SQL)))
    launches = {k: fn.launches for k, fn in counters.items()}
    rows_match("config6", got[0].rows, want["config6"])
    if launches["grouped_sum_count"] < 1:
        raise AssertionError(f"config 6: the leaf launched no exact group-by kernel: {launches}")
    check_launches("config 6", counters, launches, calls, tuple(launches.values()))
    # the leaf's kernel calls against their plain versions on the same card
    # operands (the plain versions launch no kernel)
    held = {"config6": hold_all(torch, calls, gb, ext, gs)}
    del calls, got
    wall = wall_p50_of(lambda: engine.execute(CONFIG6_SQL), warm=1, runs=WALL_RUNS)
    traced = engine.execute("SET trace = true; " + CONFIG6_SQL)
    config6 = {
        "rows": JOIN_ROWS,
        "setup_s": setup_s,
        "launches": launches,
        "kernels_vs_plain": held["config6"],
        "p50_ms": wall["p50_ms"],
        "runs_ms": wall["runs_ms"],
        "stage_stats": traced.stage_stats,
    }

    queries = {}
    for name, sql in MULTISTAGE_QUERIES.items():
        kinds = []
        real = qk.build_fn

        def spy(spec, real=real):
            kinds.append(spec[0])
            return real(spec)

        for fn in counters.values():
            fn.launches = 0
        before = dict(rt.DEVICE_OP_STATS)
        qk.build_fn = spy
        out = []
        try:
            calls = spy_calls(lambda: out.append(engine.execute(sql).rows))
        finally:
            qk.build_fn = real
        got = out[0]
        engaged = {k: rt.DEVICE_OP_STATS.get(k, 0) - before.get(k, 0) for k in ("sort", "join", "window", "mesh_join")}
        for op in MULTISTAGE_OPS[name]:
            if engaged[op] < 1:
                raise AssertionError(f"multistage {name}: the device {op} did not engage: {engaged}")
        if name == "leaf_mask":
            if "mask" not in kinds:
                raise AssertionError(f"multistage {name}: no mask program ran ({kinds})")
            got = sorted(got)
        rows_match(f"multistage {name}", got, want[name])
        run_launches = {k: fn.launches for k, fn in counters.items()}
        check_launches(f"multistage {name}", counters, run_launches, calls, tuple(run_launches.values()))
        held[name] = hold_all(torch, calls, gb, ext, gs)
        del calls
        for k, v in run_launches.items():
            launches[k] += v
        w = wall_p50_of(lambda: engine.execute(sql), warm=0, runs=3)
        queries[name] = {"engaged": engaged, "programs": sorted(set(kinds)), "p50_ms": w["p50_ms"],
                         "runs_ms": w["runs_ms"], "rows": len(got), "launches": run_launches,
                         "kernels_vs_plain": held[name]}
    emit(
        {
            "phase": "multistage",
            "results_match_oracle": True,
            "config6": config6,
            "queries": queries,
            "link_profile": {"rtt_s": link_profile("cuda")[0], "bytes_per_s": link_profile("cuda")[1]},
            "gates": {"DEVICE_SORT_MIN": rt.DEVICE_SORT_MIN, "DEVICE_JOIN_MIN": rt.DEVICE_JOIN_MIN},
            "host_costs": host_costs(data),
            "launches": launches,
            "card": card_line(),
        }
    )
    return launches


def breakdown(torch, engine, sql: str) -> dict:
    """One execute split at the engine's own seams (host clock, each seam
    synchronised; the walls ran the query warm just before), then one
    execute under torch.profiler for the device's busy time and its largest
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = [time.perf_counter()]
    ctx = engine.make_context(sql)
    t_parse = time.perf_counter()
    pend, dispatch_ms = [], []
    for seg in engine.segments:
        t0 = time.perf_counter()
        pend += engine._dispatch_all(ctx, [seg])[0]  # the pruner first, as execute
        dispatch_ms.append((time.perf_counter() - t0) * 1e3)
    t.append(time.perf_counter())
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    finished = [
        (disp[1], 0, "pruned") if disp[0] == "pruned" else engine._finish_segment(seg, ctx, disp)
        for seg, disp, _ in pend
    ]
    t.append(time.perf_counter())
    engine.reduce(ctx, [f[0] for f in finished])
    t.append(time.perf_counter())
    seams = ["parse_plan_enqueue_ms", "device_drain_ms", "copy_convert_ms", "reduce_ms"]
    out = {k: (t[i + 1] - t[i]) * 1e3 for i, k in enumerate(seams)}
    # a host segment's dispatch is its planning attempt and its host_exec run
    out["parse_ms"] = (t_parse - t[0]) * 1e3
    out["segments"] = [{"mode": f[2], "dispatch_ms": ms} for f, ms in zip(finished, dispatch_ms)]

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.execute(sql)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): the CPU ops that
    # launched them carry the same time again
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3 if ops else None
    ops.sort(key=lambda e: -e.self_device_time_total)
    out.update(
        {
            "profiled_wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
            # host->device copies (config 30's validity masks, 1 MB a segment)
            "htod_ms": sum(e.self_device_time_total for e in ops if "HtoD" in e.key) / 1e3,
            "top_device_ops": [
                {"name": e.key[:80], "calls": e.count, "ms": e.self_device_time_total / 1e3} for e in ops[:8]
            ],
        }
    )
    return out


# ---------------------------------------------------------------------------
# phases 14-16: the cluster (controller, servers, broker) on the card
# ---------------------------------------------------------------------------

#: the cluster phases' table: the main path's 8M lineorder rows in 16
#: segments of 500,000, uploaded to 4 servers with replication 2 (8 replicas a
#: server, 32 in all)
CLUSTER_SEGMENTS, CLUSTER_SERVERS, CLUSTER_REPLICATION = 16, 4, 2
CLUSTER_CONFIGS = tuple(f"{i}_{n}" for i, n in (
    (1, "count_filter"), (2, "filtered_agg"), (3, "q1_groupby"), (4, "q4_groupby_orderby"), (5, "groupby_minmax"),
    (6, "groupby_distinct"), (7, "distinct"), (8, "groupby_wide"), (9, "groupby_sparse"),
))
#: bench.py `qps`'s fixture (`_build_qps_cluster`: rng seed 8, 4 segments, 2
#: servers, replication 2, its two queries) at 8M rows instead of 120,000,
#: driven as `qps_main` drives it with 128 HTTP clients, 5 queries each
#: where it has 10 (to keep the script well inside its time)
QPS_ROWS, QPS_SEGMENTS, QPS_SERVERS, QPS_CLIENTS, QPS_PER_CLIENT = 8_000_000, 4, 2, 128, 5
QPS_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE"]
QPS_QUERIES = [
    "SELECT COUNT(*) FROM lineorder WHERE year > 1994",
    "SELECT region, SUM(revenue) FROM lineorder GROUP BY region ORDER BY SUM(revenue) DESC LIMIT 4",
]


def build_segments(builder, data: dict, n: int, prefix: str) -> list:
    """`n` equal segments of `data`, built on 4 threads (each build is the
    builder's own; the slices do not overlap)."""
    per = len(next(iter(data.values()))) // n
    return in_threads(
        lambda i: builder.build({c: v[i * per : (i + 1) * per] for c, v in data.items()}, f"{prefix}_{i}"), range(n)
    )


def cluster_of(schema, segments: list, deep: str, n_servers: int, replication: int, extra_tables=()):
    """A Controller on an in-memory PropertyStore and a deep store under
    `deep`, `n_servers` Servers on DEVICE, the table of `segments` uploaded
    with `replication` (each replica loads its own copy from the deep
    store), and `extra_tables` as (schema, [segments]) with replication 1."""
    from pinot_tpu_torch.cluster import Controller, PropertyStore, Server
    from pinot_tpu_torch.common import TableConfig

    controller = Controller(PropertyStore(), deep)
    servers = {f"server_{i}": Server(f"server_{i}", device=DEVICE) for i in range(n_servers)}
    for sid, s in servers.items():
        controller.register_server(sid, s)
    for sch, segs, rep in ((schema, segments, replication), *((s, g, 1) for s, g in extra_tables)):
        controller.add_schema(sch)
        controller.add_table(TableConfig(sch.name, replication=rep))
        for seg in segs:
            controller.upload_segment(sch.name, seg)
    return controller, servers


def deep_store_bytes(deep: str) -> int:
    from pathlib import Path

    return sum(p.stat().st_size for p in Path(deep).rglob("*") if p.is_file())


def server_staged_bytes(servers: dict) -> int:
    """Bytes staged on the device by every segment copy the servers host."""
    return sum(
        seg_staged_bytes(seg) for s in servers.values() for segs in s._tables.values() for seg in segs.values()
    )


def cluster_config6_oracle(data: dict, nation) -> list:
    """bench.py config 6's SQL over the cluster's lineorder and nation_dim:
    SUM(lo_revenue) by region (nation % 5), by sum descending."""
    sums = np.bincount(np.asarray(nation) % 5, weights=data["lo_revenue"], minlength=5)
    return [[f"REGION_{r}", float(sums[r])] for r in np.argsort(-sums, kind="stable")]


def nation_dim_segment():
    from pinot_tpu_torch.common import DataType, Schema
    from pinot_tpu_torch.segment import SegmentBuilder

    schema = Schema.build("nation_dim", dimensions=[("nation", DataType.STRING), ("region", DataType.STRING)], metrics=[])
    seg = SegmentBuilder(schema).build(
        {"nation": np.array(JOIN_NATIONS, dtype=object), "region": np.array(JOIN_REGIONS, dtype=object)}, "nation_dim_0"
    )
    return schema, seg


def timed_split(broker):
    """Wrap a broker's routing and scatter seams with host-clock timers; the
    reduce is the broker's own `brokerReduce` phase timer. Returns a reader
    of {route_ms, scatter_ms, reduce_ms} summed since the last read."""
    from pinot_tpu_torch.common.metrics import broker_metrics

    acc = {"route_ms": 0.0, "scatter_ms": 0.0}

    def wrap(key, real):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                acc[key] += (time.perf_counter() - t0) * 1e3

        return call

    broker._route_leg = wrap("route_ms", broker._route_leg)
    broker._scatter_plan = wrap("scatter_ms", broker._scatter_plan)
    reduce_timer = broker_metrics().timer("broker.phase.brokerReduceMs")
    state = {"reduce": reduce_timer.total_ms}

    def read(runs: int) -> dict:
        out = {k: v / runs for k, v in acc.items()}
        out["reduce_ms"] = (reduce_timer.total_ms - state["reduce"]) / runs
        acc.update(route_ms=0.0, scatter_ms=0.0)
        state["reduce"] = reduce_timer.total_ms
        return out

    return read


#: the kernel registry's names (common/kernel_obs.py) for the launch counters
KERNEL_OF_REGISTRY = {
    "ops.grouped_planes": "grouped_sum_count",
    "ops.grouped_extreme": "grouped_extreme",
    "ops.grouped_sum": "presence",
    "ops.grouped_planes2": "grouped_sum_count_2l",
}


def calls_by_kernel(roofline: dict) -> dict:
    """Launches by counter name from a `KERNELS.roofline()` document (the
    body of a server's GET /debug/roofline), summed over shape buckets; the
    registry's other entries (the sharded path's `exchange.*` programs) are
    not kernel launches."""
    out = {k: 0 for k in KERNEL_OF_REGISTRY.values()}
    for row in roofline["kernels"]:
        if row["kernel"] in KERNEL_OF_REGISTRY:
            out[KERNEL_OF_REGISTRY[row["kernel"]]] += row["calls"]
    return out


def registry_calls() -> dict:
    from pinot_tpu_torch.common.kernel_obs import KERNELS

    return calls_by_kernel(KERNELS.roofline(top=0))


def counted_run(counters: dict, fn) -> tuple:
    """fn() once with every spied wrapper call recorded: (result, launches
    made during it by kernel, calls)."""
    before = [f.launches for f in counters.values()]
    got = []
    calls = spy_calls(lambda: got.append(fn()))
    launches = {k: f.launches - b for (k, f), b in zip(counters.items(), before)}
    return got[0], launches, calls


def run_cluster(torch, counters: dict, data: dict, want: dict, nation) -> dict:
    """Phase 14: the cluster in process. The main path's 8M rows in 16
    segments of 500,000 go through Controller.upload_segment (deep store, then
    each replica's server loads its copy) to 4 Servers on the card with
    replication 2; configs 1-9's SQL and bench.py config 6's multistage join
    (the broker's in-process multistage route over the same lineorder and a
    25-row nation_dim) run through Broker(controller) with its defaults.
    Each config's rows equal the oracle; its launches, counted from 0 just
    before its one run and read just after, are LAUNCHES_PER_SEGMENT x 16
    (each segment answered by exactly one replica); every kernel call is
    held against its plain version on the same card operands. Walls: p50 of
    5 after one warm-up through the default broker (result-cache hits),
    through a broker with CacheConfig(enabled=False), and through one
    QueryEngine over the same 16 segments; the uncached broker's split into
    route, scatter and reduce. Returns the path's launches and the cluster
    for the HTTP phase."""
    import tempfile

    from pinot_tpu_torch.cluster import Broker
    from pinot_tpu_torch.common.config import CacheConfig
    from pinot_tpu_torch.ops import extreme as ext
    from pinot_tpu_torch.ops import groupby as gb
    from pinot_tpu_torch.ops import grouped_sum_f32 as gs
    from pinot_tpu_torch.query import QueryEngine

    t0 = time.perf_counter()
    segments = build_segments(ssb_builder(), data, CLUSTER_SEGMENTS, "lineorder")
    t_build = time.perf_counter() - t0
    deep = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    t0 = time.perf_counter()
    nd_schema, nd_segment = nation_dim_segment()
    controller, servers = cluster_of(
        ssb_schema(), segments, deep, CLUSTER_SERVERS, CLUSTER_REPLICATION, extra_tables=[(nd_schema, [nd_segment])]
    )
    t_upload = time.perf_counter() - t0
    ideal = controller.ideal_state("lineorder")
    hosted = {sid: len(s.segments_of("lineorder")) for sid, s in servers.items()}
    if len(ideal) != CLUSTER_SEGMENTS or any(len(r) != CLUSTER_REPLICATION for r in ideal.values()):
        raise AssertionError(f"cluster: ideal state {ideal}")
    if set(hosted.values()) != {CLUSTER_SEGMENTS * CLUSTER_REPLICATION // CLUSTER_SERVERS}:
        raise AssertionError(f"cluster: replicas a server {hosted}")
    broker = Broker(controller)
    uncached = Broker(controller, cache_config=CacheConfig(enabled=False))
    engine = QueryEngine(segments, device=DEVICE)
    want6 = cluster_config6_oracle(data, nation)

    for fn in counters.values():
        fn.launches = 0
    launches, held = {}, {}
    for name in CLUSTER_CONFIGS:
        res, launches[name], calls = counted_run(counters, lambda: broker.execute(CONFIGS[name]))
        expect = tuple(CLUSTER_SEGMENTS * v for v in LAUNCHES_PER_SEGMENT[name])
        check_launches(f"cluster {name}", counters, launches[name], calls, expect)
        rows_match(f"cluster {name}", res.rows, want[name])
        held[name] = hold_all(torch, calls, gb, ext, gs)
        del calls
    res, launches["config6_multistage"], calls = counted_run(counters, lambda: broker.execute(CONFIG6_SQL))
    rows_match("cluster config6_multistage", res.rows, want6)
    # the join's leaf: one exact group-by a lineorder segment, nothing else
    check_launches("cluster config6_multistage", counters, launches["config6_multistage"], calls,
                   (CLUSTER_SEGMENTS, 0, 0, 0))
    held["config6_multistage"] = hold_all(torch, calls, gb, ext, gs)
    del calls
    path_launches = {k: sum(v[k] for v in launches.values()) for k in counters}
    if path_launches != {k: fn.launches for k, fn in counters.items()}:
        raise AssertionError(f"cluster: launches outside the configs' runs: {path_launches}")
    torch.cuda.synchronize()
    emit(
        {
            "phase": "cluster_path",
            "results_match_oracle": True,
            "segments": CLUSTER_SEGMENTS,
            "servers": CLUSTER_SERVERS,
            "replication": CLUSTER_REPLICATION,
            "replicas_a_server": hosted,
            "build_s": t_build,
            "upload_s": t_upload,
            "deep_store_bytes": deep_store_bytes(deep),
            "staged_bytes_by_servers": server_staged_bytes(servers),
            "launches_per_config": launches,
            "launches": path_launches,
            "kernels_vs_plain": held,
        }
    )

    split = timed_split(uncached)
    per_query = {}
    for name in (*CLUSTER_CONFIGS, "config6_multistage"):
        sql = CONFIG6_SQL if name == "config6_multistage" else CONFIGS[name]
        hits0 = broker.cache_snapshot()["result"]["hits"]
        cached = wall_p50_of(lambda: broker.execute(sql), warm=1, runs=WALL_RUNS)
        hits = broker.cache_snapshot()["result"]["hits"] - hits0
        uncached.execute(sql)  # the warm-up, outside the split
        split(1)
        plain = wall_p50_of(lambda: uncached.execute(sql), warm=0, runs=WALL_RUNS)
        parts = split(5)
        eng = None if name == "config6_multistage" else wall_p50(engine, sql, warm=1)
        per_query[name] = {
            "broker_p50_ms": cached["p50_ms"],
            "broker_runs_ms": cached["runs_ms"],
            "result_cache_hits": hits,
            "uncached_p50_ms": plain["p50_ms"],
            "uncached_runs_ms": plain["runs_ms"],
            "uncached_split_ms": parts,
            "engine_p50_ms": None if eng is None else eng["p50_ms"],
            "engine_runs_ms": None if eng is None else eng["runs_ms"],
            "launches": launches[name],
        }
    emit(
        {
            "phase": "cluster",
            "queries": per_query,
            "cache": broker.cache_snapshot()["result"],
            "admission": broker.admission_snapshot()["counters"],
            "staged_bytes_by_servers": server_staged_bytes(servers),
            "staged_bytes_by_engine": sum(seg_staged_bytes(s) for s in segments),
            "card": card_line(),
        }
    )
    uncached.shutdown()
    return path_launches, {
        "controller": controller, "servers": servers, "broker": broker, "deep": deep, "engine": engine,
        "segments": segments, "want6": want6,
    }


def run_cluster_http(torch, counters: dict, cl: dict, want: dict, data: dict, nation) -> dict:
    """Phase 15: the same 4 servers, each behind a ServerHTTPService; a
    second Controller on the same store registers them as
    RemoteServerClients; its Broker sits behind a BrokerHTTPService and is
    queried by query_broker_http. Configs 1-9: rows equal to the oracle,
    launches LAUNCHES_PER_SEGMENT x 16 (counted from 0 just before each
    query, read just after), every kernel call held against its plain
    version; the DataTable bytes the broker received, the wall p50 beside
    the in-process broker's (both uncached). Then config 13's plain
    SELECTION through the streamed path (/query/stream frames, early stop).
    Returns the path's launches."""
    from pinot_tpu_torch.cluster import Broker, Controller
    from pinot_tpu_torch.cluster.http import BrokerHTTPService, RemoteServerClient, ServerHTTPService, query_broker_http
    from pinot_tpu_torch.common import datatable
    from pinot_tpu_torch.common.config import CacheConfig
    from pinot_tpu_torch.common.wire import get_pool
    from pinot_tpu_torch.ops import extreme as ext
    from pinot_tpu_torch.ops import groupby as gb
    from pinot_tpu_torch.ops import grouped_sum_f32 as gs

    svcs = {sid: ServerHTTPService(s) for sid, s in cl["servers"].items()}
    remote = Controller(cl["controller"].store, cl["deep"])
    for sid, svc in svcs.items():
        remote.register_server(sid, RemoteServerClient(f"http://127.0.0.1:{svc.port}"))
    broker = Broker(remote, cache_config=CacheConfig(enabled=False))
    in_process = Broker(cl["controller"], cache_config=CacheConfig(enabled=False))
    bsvc = BrokerHTTPService(broker)
    url = f"http://127.0.0.1:{bsvc.port}"
    received = [0]
    real_decode = datatable.decode

    def counting_decode(payload):
        received[0] += len(payload)
        return real_decode(payload)

    datatable.decode = counting_decode
    try:
        for fn in counters.values():
            fn.launches = 0
        launches, held, per_query = {}, {}, {}
        for name in CLUSTER_CONFIGS:
            received[0] = 0
            reg0 = registry_calls()
            resp, launches[name], calls = counted_run(counters, lambda: query_broker_http(url, CONFIGS[name]))
            reg = {k: v - reg0[k] for k, v in registry_calls().items()}
            nbytes = received[0]
            if resp.get("exceptions"):
                raise AssertionError(f"cluster_http {name}: {resp['exceptions']}")
            expect = tuple(CLUSTER_SEGMENTS * v for v in LAUNCHES_PER_SEGMENT[name])
            check_launches(f"cluster_http {name}", counters, launches[name], calls, expect)
            # the kernel registry's calls (what a server process's
            # /debug/roofline serves) count the same launches as the counters
            if reg != launches[name]:
                raise AssertionError(f"cluster_http {name}: registry calls {reg}, counters {launches[name]}")
            rows_match(f"cluster_http {name}", resp["resultTable"]["rows"], want[name])
            held[name] = hold_all(torch, calls, gb, ext, gs)
            del calls
            per_query[name] = {"datatable_bytes_received": nbytes, "launches": launches[name]}
        path_launches = {k: sum(v[k] for v in launches.values()) for k in counters}
        if path_launches != {k: fn.launches for k, fn in counters.items()}:
            raise AssertionError(f"cluster_http: launches outside the configs' runs: {path_launches}")
        for name in CLUSTER_CONFIGS:
            w = wall_p50_of(lambda: query_broker_http(url, CONFIGS[name]), warm=1, runs=WALL_RUNS)
            local = wall_p50_of(lambda: in_process.execute(CONFIGS[name]), warm=1, runs=WALL_RUNS)
            per_query[name].update(
                http_p50_ms=w["p50_ms"], http_runs_ms=w["runs_ms"],
                in_process_p50_ms=local["p50_ms"], in_process_runs_ms=local["runs_ms"],
            )

        # the streamed path: a plain SELECTION's frames stop at the LIMIT
        sel = CONFIGS["13_selection"]
        year, qty = data["d_year"], data["lo_quantity"]
        match = np.flatnonzero(np.asarray(nation) == 7)
        allowed = set(zip(year[match].tolist(), data["p_category"][match].tolist(), qty[match].tolist()))
        received[0] = 0
        streamed = broker.execute(sel)
        stream_bytes = received[0]
        resp = query_broker_http(url, sel)
        for rows in (streamed.rows, resp["resultTable"]["rows"]):
            if len(rows) != 10 or any(tuple(r) not in allowed for r in rows):
                raise AssertionError(f"cluster_http 13_selection: rows {rows} are not 10 matching rows")
        if not 1 <= streamed.num_stream_frames < CLUSTER_SEGMENTS:
            raise AssertionError(f"cluster_http 13_selection: {streamed.num_stream_frames} frames, no early stop")
        if streamed.num_docs_scanned >= streamed.total_docs:
            raise AssertionError("cluster_http 13_selection: the stream scanned every doc")
        emit(
            {
                "phase": "cluster_http",
                "results_match_oracle": True,
                "queries": per_query,
                "launches": path_launches,
                "registry_calls_equal_counters": True,
                "kernels_vs_plain": held,
                "stream": {
                    "config": "13_selection",
                    "frames": streamed.num_stream_frames,
                    "docs_scanned": streamed.num_docs_scanned,
                    "total_docs": streamed.total_docs,
                    "datatable_bytes_received": stream_bytes,
                    "rows": len(streamed.rows),
                },
                "wire_pool": get_pool().stats(),
                "card": card_line(),
            }
        )
    finally:
        datatable.decode = real_decode
        bsvc.stop()
        for svc in svcs.values():
            svc.stop()
        broker.shutdown()
        in_process.shutdown()
    return path_launches, {name: q["http_p50_ms"] for name, q in per_query.items()}


def qps_data(n_rows: int = QPS_ROWS, seed: int = 8) -> list:
    """`_build_qps_cluster`'s draws, segment by segment (region, year,
    revenue), at n_rows / 4 rows a segment."""
    rng = np.random.default_rng(seed)
    per = n_rows // QPS_SEGMENTS
    out = []
    for _ in range(QPS_SEGMENTS):
        out.append(
            {
                "region": np.array(QPS_REGIONS, dtype=object)[rng.integers(0, 4, per)],
                "year": rng.integers(1992, 1999, per).astype(np.int32),
                "revenue": rng.integers(100, 600_000, per).astype(np.int64),
            }
        )
    return out


def qps_oracle(parts: list) -> list:
    count = sum(int((p["year"] > 1994).sum()) for p in parts)
    sums = np.zeros(4)
    for p in parts:
        codes = np.searchsorted(np.array(QPS_REGIONS), p["region"].astype(str))
        sums += np.bincount(codes, weights=p["revenue"], minlength=4)
    order = np.argsort(-sums, kind="stable")
    return [[[count]], [[QPS_REGIONS[i], float(sums[i])] for i in order]]


def qps_pass(url: str, broker, counters: dict) -> dict:
    """`qps_main`'s drive: QPS_CLIENTS HTTP clients x QPS_PER_CLIENT queries
    (alternating bench.py's two) released together; the broker histogram
    reset just before. Throughput, client and broker-histogram p50 / p99,
    error rate, the wire pool's hits in the pass, the admission decisions
    and the B1 launches."""
    import threading

    from pinot_tpu_torch.cluster.http import query_broker_http
    from pinot_tpu_torch.common.metrics import broker_metrics, reset_registries
    from pinot_tpu_torch.common.wire import get_pool

    reset_registries()
    for fn in counters.values():
        fn.launches = 0
    adm0 = dict(broker.admission_snapshot()["counters"])
    pool0 = get_pool().stats()
    lat_ms, errors = [], []
    lock = threading.Lock()
    barrier = threading.Barrier(QPS_CLIENTS + 1)

    def client(idx: int) -> None:
        mine, bad = [], 0
        barrier.wait(timeout=60)
        for j in range(QPS_PER_CLIENT):
            q = QPS_QUERIES[(idx + j) % len(QPS_QUERIES)]
            t0 = time.perf_counter()
            try:
                if query_broker_http(url, q).get("exceptions"):
                    bad += 1
            except Exception:  # noqa: BLE001 - counted as an error, as qps_main counts it
                bad += 1
            mine.append((time.perf_counter() - t0) * 1e3)
        with lock:
            lat_ms.extend(mine)
            errors.append(bad)

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(QPS_CLIENTS)]
    for t in threads:
        t.start()
    barrier.wait(timeout=60)
    t_run = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall_s = time.perf_counter() - t_run
    pool = get_pool().stats()
    total = QPS_CLIENTS * QPS_PER_CLIENT
    timer = broker_metrics().timer("broker.queryTotalMs")
    client_p99 = float(np.percentile(lat_ms, 99))
    adm = broker.admission_snapshot()["counters"]
    return {
        "clients": QPS_CLIENTS,
        "queries": total,
        "answered": len(lat_ms),
        "wall_s": wall_s,
        "throughput_qps": total / wall_s,
        "client_p50_ms": float(np.percentile(lat_ms, 50)),
        "client_p99_ms": client_p99,
        "broker_p50_ms": timer.quantile_ms(0.5),
        "broker_p99_ms": timer.quantile_ms(0.99),
        "broker_count": timer.count,
        "p99_ratio_broker_over_client": timer.quantile_ms(0.99) / client_p99 if client_p99 else None,
        "error_rate": sum(errors) / total,
        "wire_pool_hits": pool["hits"] - pool0["hits"],
        "wire_pool": pool,
        "admission": {k: v - adm0.get(k, 0) if isinstance(v, (int, float)) else v for k, v in adm.items()},
        "b1_launches": counters["grouped_sum_count"].launches,
        "launches": {k: fn.launches for k, fn in counters.items()},
    }


def run_cluster_qps(torch, counters: dict) -> dict:
    """Phase 16: bench.py's `qps` fixture at its shapes (the
    `_build_qps_cluster` schema region / year / revenue, rng seed 8, 4
    segments, 2 Servers on the card, replication 2, its two queries) with
    8M rows instead of 120,000 (2M a segment), the broker behind a
    BrokerHTTPService, driven by 128 HTTP clients x 5 queries as
    `qps_main` drives it: one pass with the default CacheConfig (bench.py's
    setting), one with CacheConfig(enabled=False) so the servers' engines
    do the work. The first answer of each query equals its oracle, and in
    each pass the first answers launch one B1 a segment in all, every call
    of which is held against its plain version (max_abs_err 0); error
    rate 0 and wire-pool hits > 0 in both passes; with the cache off every
    GROUP BY answer launches B1 once a segment. Returns the phase's
    launches."""
    import shutil
    import tempfile

    from pinot_tpu_torch.cluster import Broker
    from pinot_tpu_torch.cluster.http import BrokerHTTPService, query_broker_http
    from pinot_tpu_torch.common import DataType, Schema
    from pinot_tpu_torch.common.config import CacheConfig
    from pinot_tpu_torch.ops import extreme as ext
    from pinot_tpu_torch.ops import groupby as gb
    from pinot_tpu_torch.ops import grouped_sum_f32 as gs
    from pinot_tpu_torch.segment import SegmentBuilder

    t0 = time.perf_counter()
    parts = qps_data()
    want = qps_oracle(parts)
    schema = Schema.build(
        "lineorder", dimensions=[("region", DataType.STRING), ("year", DataType.INT)], metrics=[("revenue", DataType.LONG)]
    )
    builder = SegmentBuilder(schema)
    segments = in_threads(lambda i: builder.build(parts[i], f"lineorder_{i}"), range(QPS_SEGMENTS))
    del parts
    t_build = time.perf_counter() - t0
    deep = tempfile.mkdtemp(prefix="chip_smoke_qps_")
    controller, servers = cluster_of(schema, segments, deep, QPS_SERVERS, 2)
    del segments
    setup_s = time.perf_counter() - t0
    passes, launches = {}, {k: 0 for k in counters}
    try:
        for label, cache in (("default_cache", CacheConfig()), ("cache_off", CacheConfig(enabled=False))):
            broker = Broker(controller, cache_config=cache)
            bsvc = BrokerHTTPService(broker)
            url = f"http://127.0.0.1:{bsvc.port}"
            try:
                first_launches, spied, held = {k: 0 for k in counters}, {}, []
                for q, rows in zip(QPS_QUERIES, want):
                    first, got, calls = counted_run(counters, lambda: query_broker_http(url, q))
                    rows_match(f"cluster_qps {label} {q[:40]}", first["resultTable"]["rows"], rows)
                    held += hold_all(torch, calls, gb, ext, gs)
                    first_launches = {k: first_launches[k] + got[k] for k in counters}
                    spied = {n: spied.get(n, 0) + len(c) for n, c in calls.items()}
                    del calls
                # the GROUP BY answers with one B1 a segment, the COUNT(*) with none
                check_launches(f"cluster_qps {label} first answers", counters, first_launches, spied,
                               (QPS_SEGMENTS, 0, 0, 0))
                if any(h["max_abs_err"] != 0 for h in held):
                    raise AssertionError(f"cluster_qps {label}: a kernel differs from its plain version: {held}")
                out = qps_pass(url, broker, counters)
            finally:
                bsvc.stop()
                broker.shutdown()
            out["first_answers_launches"] = first_launches
            out["kernels_vs_plain"] = held
            if out["error_rate"] != 0 or out["answered"] != out["queries"]:
                raise AssertionError(f"cluster_qps {label}: error rate {out['error_rate']}, {out['answered']} answered")
            if out["wire_pool_hits"] <= 0:
                raise AssertionError(f"cluster_qps {label}: the wire pool reused no connection: {out['wire_pool']}")
            group_bys = QPS_CLIENTS * QPS_PER_CLIENT // 2
            if label == "cache_off" and out["b1_launches"] != QPS_SEGMENTS * group_bys:
                raise AssertionError(f"cluster_qps cache_off: {out['b1_launches']} B1 launches, "
                                     f"expected {QPS_SEGMENTS * group_bys}")
            for k in launches:
                launches[k] += out["launches"][k] + first_launches[k]
            passes[label] = out
        emit(
            {
                "phase": "cluster_qps",
                "rows": QPS_ROWS,
                "segments": QPS_SEGMENTS,
                "servers": QPS_SERVERS,
                "build_s": t_build,
                "setup_s": setup_s,
                "deep_store_bytes": deep_store_bytes(deep),
                "staged_bytes_by_servers": server_staged_bytes(servers),
                "first_answers_match_oracle": True,
                "passes": passes,
                "launches": launches,
                "card": card_line(),
            }
        )
    finally:
        shutil.rmtree(deep, ignore_errors=True)
    return launches


#: phase 17: bench.py's config 6 at the multistage phase's size (JOIN_ROWS
#: rows, seed 6) in MSD_SEGMENTS segments over MSD_SERVERS servers on the
#: card, replication 1, and the multistage phase's lookup join + ORDER BY
MSD_SEGMENTS, MSD_SERVERS = 4, 4
MSD_QUERIES = {
    "config6": CONFIG6_SQL,
    "device_join_sort": MULTISTAGE_QUERIES["device_join_sort"],
    # ~80K joined rows (1 in 50 has quantity 1) reach the root stage
    # unsorted: its ORDER BY is above DEVICE_SORT_MIN, a device sort there
    "root_sort": (
        "SELECT l.lo_revenue, q.band FROM lineorder l JOIN qty_dim q ON l.lo_quantity = q.qty "
        "WHERE l.lo_quantity = 1 ORDER BY l.lo_revenue DESC"
    ),
}
#: the multistage runtime's device operators, by their DEVICE_OP_STATS keys
DEVICE_OPS = {"_device_sort_perm": "sort", "_device_window_cum": "window", "_device_equi_join": "join"}


@contextlib.contextmanager
def device_ops_spied():
    """Yields a dict "op@device type" -> calls, filled while the block runs
    by every call of the multistage runtime's device operators that ran
    (returned a result), from any thread: the root stage's, the servers'
    workers' and the in-process engine's."""
    import inspect
    import threading

    import torch

    from pinot_tpu_torch.multistage import runtime as rt

    seen: dict = {}
    lock = threading.Lock()
    real = {name: getattr(rt, name) for name in DEVICE_OPS}

    def spy(name):
        fn, sig = real[name], inspect.signature(real[name])

        def wrapped(*a, **k):
            out = fn(*a, **k)
            if out is not None:
                bound = sig.bind(*a, **k)
                bound.apply_defaults()
                key = f"{DEVICE_OPS[name]}@{torch.device(bound.arguments['device']).type}"
                with lock:
                    seen[key] = seen.get(key, 0) + 1
            return out

        return wrapped

    for name in DEVICE_OPS:
        setattr(rt, name, spy(name))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(rt, name, fn)


def run_multistage_distributed(torch, counters: dict) -> dict:
    """Phase 17: the multistage engine as distributed stages. Four Servers on
    the card, each behind its own ServerHTTPService, registered with a
    second controller as RemoteServerClients (the reference test's
    topology): the broker dispatches each stage to the servers and runs the
    root stage on its own device, the card, and every stage-to-stage block
    crosses a socket through /mailbox. bench.py's config 6, the multistage
    phase's lookup join + ORDER BY and a join whose ORDER BY sorts 80K rows
    in the root stage, over the same 4M rows in 4 segments: rows equal the
    oracle; the launches, counted from 0 just before the distributed runs
    and read just after each, equal the in-process multistage route's on the
    same segments (config 6: one B1 a segment at the leaf, in the servers'
    stage workers), and every kernel call of the leaf is held against its
    plain version, max_abs_err 0. The multistage device operators (sort,
    join, window) that ran are the same on both routes and all ran on the
    card; root_sort's root sort among them. Reports each route's wall p50,
    device operators, and the mailbox envelopes and bytes a query. Returns
    the path's launches."""
    import tempfile

    from pinot_tpu_torch.cluster import Broker, Controller
    from pinot_tpu_torch.cluster.http import RemoteServerClient, ServerHTTPService
    from pinot_tpu_torch.common.config import CacheConfig
    from pinot_tpu_torch.multistage import transport
    from pinot_tpu_torch.ops import extreme as ext
    from pinot_tpu_torch.ops import groupby as gb
    from pinot_tpu_torch.ops import grouped_sum_f32 as gs
    from pinot_tpu_torch.segment import SegmentBuilder

    t0 = time.perf_counter()
    data = join_fact_data(JOIN_ROWS)
    want = multistage_oracle(data)
    segments = build_segments(SegmentBuilder(ssb_schema(keys=False)), data, MSD_SEGMENTS, "lineorder")
    del data
    deep = tempfile.mkdtemp(prefix="chip_smoke_msd_")
    controller, servers = cluster_of(
        ssb_schema(keys=False), segments, deep, MSD_SERVERS, 1, extra_tables=[(sch, [seg]) for sch, seg in multistage_dims()]
    )
    del segments
    hosted = {sid: s.segments_of("lineorder") for sid, s in servers.items()}
    if sorted(len(v) for v in hosted.values()) != [1] * MSD_SERVERS:
        raise AssertionError(f"multistage_distributed: lineorder segments a server {hosted}")
    svcs = {sid: ServerHTTPService(s) for sid, s in servers.items()}
    remote = Controller(controller.store, deep)
    for sid, svc in svcs.items():
        remote.register_server(sid, RemoteServerClient(f"http://127.0.0.1:{svc.port}"))
    in_process = Broker(controller, cache_config=CacheConfig(enabled=False))
    distributed = Broker(remote, cache_config=CacheConfig(enabled=False), device=DEVICE)
    setup_s = time.perf_counter() - t0
    envelopes = {"count": 0, "bytes": 0}
    real_encode = transport.encode_envelope_segments

    def counting_encode(*a, **k):
        segs = real_encode(*a, **k)
        envelopes["count"] += 1
        envelopes["bytes"] += sum(len(x) for x in segs)
        return segs

    try:
        # the in-process route first: what the distributed runs must launch
        expect, ops = {}, {"in_process": {}, "distributed": {}}
        for name, sql in MSD_QUERIES.items():
            with device_ops_spied() as ops["in_process"][name]:
                res, expect[name], calls = counted_run(counters, lambda: in_process.execute(sql))
            rows_match(f"multistage_distributed in-process {name}", res.rows, want[name])
            del calls
        if expect["config6"]["grouped_sum_count"] != MSD_SEGMENTS:
            raise AssertionError(f"multistage_distributed: config 6's in-process leaf launched {expect['config6']}")
        for fn in counters.values():
            fn.launches = 0
        launches, held, per_query = {}, {}, {}
        transport.encode_envelope_segments = counting_encode
        try:
            for name, sql in MSD_QUERIES.items():
                envelopes.update(count=0, bytes=0)
                with device_ops_spied() as ops["distributed"][name]:
                    res, launches[name], calls = counted_run(counters, lambda: distributed.execute(sql))
                rows_match(f"multistage_distributed {name}", res.rows, want[name])
                check_launches(f"multistage_distributed {name}", counters, launches[name], calls,
                               tuple(expect[name].values()))
                held[name] = hold_all(torch, calls, gb, ext, gs)
                if any(h["max_abs_err"] != 0 for h in held[name]):
                    raise AssertionError(f"multistage_distributed {name}: a kernel differs from its plain version")
                del calls
                per_query[name] = {"launches": launches[name], "envelopes": envelopes["count"],
                                   "envelope_bytes": envelopes["bytes"]}
        finally:
            transport.encode_envelope_segments = real_encode
        path_launches = {k: sum(v[k] for v in launches.values()) for k in counters}
        if path_launches != {k: fn.launches for k, fn in counters.items()}:
            raise AssertionError(f"multistage_distributed: launches outside the queries' runs: {path_launches}")
        if distributed._dispatcher is None:
            raise AssertionError("multistage_distributed: the distributed dispatcher did not run")
        on = f"@{torch.device(DEVICE).type}"
        for name in MSD_QUERIES:
            a, b = ops["in_process"][name], ops["distributed"][name]
            if set(a) != set(b) or any(not k.endswith(on) for k in (*a, *b)):
                raise AssertionError(f"multistage_distributed {name}: device operators in process {a}, distributed {b}")
        if f"sort{on}" not in ops["distributed"]["root_sort"]:
            raise AssertionError(f"multistage_distributed root_sort: no device sort {ops['distributed']['root_sort']}")
        for name, sql in MSD_QUERIES.items():
            d = wall_p50_of(lambda: distributed.execute(sql), warm=1, runs=WALL_RUNS)
            p = wall_p50_of(lambda: in_process.execute(sql), warm=1, runs=WALL_RUNS)
            per_query[name].update(distributed_p50_ms=d["p50_ms"], distributed_runs_ms=d["runs_ms"],
                                   in_process_p50_ms=p["p50_ms"], in_process_runs_ms=p["runs_ms"])
        torch.cuda.synchronize()
        emit(
            {
                "phase": "multistage_distributed",
                "results_match_oracle": True,
                "rows": JOIN_ROWS,
                "segments": MSD_SEGMENTS,
                "servers": MSD_SERVERS,
                "setup_s": setup_s,
                "queries": per_query,
                "launches_equal_in_process": True,
                "device_ops": ops,
                "launches": path_launches,
                "kernels_vs_plain": held,
                "card": card_line(),
            }
        )
    finally:
        for svc in svcs.values():
            svc.stop()
        distributed.shutdown()
        in_process.shutdown()
        shutil.rmtree(deep, ignore_errors=True)
    return path_launches


#: phase 18: the roles as OS processes, each started as
#: `python -m pinot_tpu_torch.tools.admin Start...` (spawned, never forked)
PROC_SERVERS, PROC_START_TIMEOUT_S = 4, 300
LOOKUP_SQL = (
    "SELECT LOOKUP('nation_dim', 'region', 'nation', c_nation), SUM(lo_revenue) FROM lineorder "
    "GROUP BY LOOKUP('nation_dim', 'region', 'nation', c_nation) ORDER BY SUM(lo_revenue) DESC"
)


class Role:
    """One admin role in a process of its own: its output is drained on a
    thread, and `wait()` returns the URL of its `listening on` line."""

    def __init__(self, name: str, args: list):
        import os
        import threading

        self.name, self.url, self.start_s, self.lines = name, None, None, []
        self._t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "pinot_tpu_torch.tools.admin", *args],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        self._ready = threading.Event()
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self) -> None:
        import re

        for line in self.proc.stdout:
            self.lines.append(line)
            m = re.search(r"listening on (http://\S+)", line)
            if m and self.url is None:
                self.start_s = time.perf_counter() - self._t0
                self.url = m.group(1)
                self._ready.set()
        self._ready.set()

    def wait(self) -> str:
        self._ready.wait(PROC_START_TIMEOUT_S)
        if self.url is None:
            raise AssertionError(f"{self.name} did not start in {PROC_START_TIMEOUT_S}s: {''.join(self.lines[-30:])}")
        return self.url

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait(timeout=60)


def http_json(url: str, timeout: float = 120.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def processes_calls(urls: list) -> dict:
    """Launches by kernel, summed over the server processes' registries
    (GET /debug/roofline)."""
    out = {k: 0 for k in KERNEL_OF_REGISTRY.values()}
    for url in urls:
        for k, v in calls_by_kernel(http_json(f"{url}/debug/roofline?top=0")).items():
            out[k] += v
    return out


def card_memory_used() -> str:
    """The card's used memory as nvidia-smi reads it (every process's)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable: {e}"


def auth_post(url: str, sql: str, user=None, password=None) -> tuple:
    import base64
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"{url}/query/sql", data=json.dumps({"sql": sql}).encode(), method="POST")
    if user is not None:
        req.add_header("Authorization", "Basic " + base64.b64encode(f"{user}:{password}".encode()).decode())
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def run_processes(torch, deep_in: str, want: dict, want6: list, http_p50: dict) -> dict:
    """Phase 18: the cluster as OS processes. A controller, four servers on
    the card and a broker (result cache off), each started with
    subprocess.Popen([sys.executable, "-m", "pinot_tpu_torch.tools.admin",
    "Start..."]) and never forked from this CUDA process; the cluster
    phase's 16 lineorder segment dirs uploaded through
    RemoteControllerClient.upload_segment_dir (the REST tarball path) with
    replication 2, and nation_dim as a dimension table (primary key
    nation). Configs 1-9 and config 6's join (distributed stages in the
    server processes, blocks crossing processes through /mailbox) through
    client.connect: rows equal the oracle, and the launches, summed from the
    server processes' /debug/roofline calls just before and just after each
    query, are the cluster phase's: 16x a segment's, config 6's leaf 16 B1.
    Then a lookUp group-by against nation_dim (the host executor in the
    servers, no launch; its rows are config 6's), one query refused and one
    admitted by a BasicAuthAccessControl broker over a RemoteControllerClient,
    and a /debug/pprof capture of the broker process during a query.
    Reports the start-up seconds of each process, the upload, each query's
    wall p50 beside cluster_http's, and each server's device memory. Every
    child is killed at the end. Returns the path's launches."""
    import shutil as _shutil
    import tempfile
    import threading
    from pathlib import Path

    from pinot_tpu_torch.client import connect
    from pinot_tpu_torch.cluster import Broker
    from pinot_tpu_torch.cluster.access import BasicAuthAccessControl, Principal
    from pinot_tpu_torch.cluster.http import BrokerHTTPService, RemoteControllerClient
    from pinot_tpu_torch.common import DataType, Schema, TableConfig
    from pinot_tpu_torch.common.config import CacheConfig
    from pinot_tpu_torch.segment import SegmentBuilder

    root = tempfile.mkdtemp(prefix="chip_smoke_procs_")
    roles, auth_broker, auth_svc = [], None, None
    card_before = card_memory_used()
    try:
        t0 = time.perf_counter()
        ctl = Role("controller", ["StartController", "--store-dir", f"{root}/store", "--deep-store", f"{root}/deep"])
        roles.append(ctl)
        c_url = ctl.wait()
        servers = [
            Role(f"server_{i}", ["StartServer", "--controller-url", c_url, "--server-id", f"server_{i}", "--device", DEVICE])
            for i in range(PROC_SERVERS)
        ]
        roles += servers
        brk = Role("broker", ["StartBroker", "--controller-url", c_url, "--cache-json", '{"enabled": false}', "--device", DEVICE])
        roles.append(brk)
        s_urls = [s.wait() for s in servers]
        b_url = brk.wait()
        cluster_up_s = time.perf_counter() - t0

        rc = RemoteControllerClient(c_url, timeout=600)
        rc.add_schema(ssb_schema())
        rc.add_table(TableConfig("lineorder", replication=CLUSTER_REPLICATION))
        nd = Schema.build(
            "nation_dim", dimensions=[("nation", DataType.STRING), ("region", DataType.STRING)], metrics=[],
            primary_key_columns=["nation"],
        )
        rc.add_schema(nd)
        rc.add_table(TableConfig("nation_dim", extra={"isDimTable": True}))
        t0 = time.perf_counter()
        seg_dirs = sorted((Path(deep_in) / "lineorder").iterdir(), key=lambda p: int(p.name.rsplit("_", 1)[1]))
        if len(seg_dirs) != CLUSTER_SEGMENTS:
            raise AssertionError(f"processes: {len(seg_dirs)} segment dirs in the cluster phase's deep store")
        for d in seg_dirs:
            out = rc.upload_segment_dir("lineorder", d)
            if len(out["servers"]) != CLUSTER_REPLICATION:
                raise AssertionError(f"processes: {d.name} assigned to {out['servers']}")
        rc.upload_segment(
            "nation_dim",
            SegmentBuilder(nd).build(
                {"nation": np.array(JOIN_NATIONS, dtype=object), "region": np.array(JOIN_REGIONS, dtype=object)},
                "nation_dim_0",
            ),
        )
        upload_s = time.perf_counter() - t0
        ideal = rc.ideal_state("lineorder")
        if len(ideal) != CLUSTER_SEGMENTS or any(len(r) != CLUSTER_REPLICATION for r in ideal.values()):
            raise AssertionError(f"processes: ideal state {ideal}")
        hosted = {u: len(http_json(f"{u}/segments/lineorder")) for u in s_urls}
        if set(hosted.values()) != {CLUSTER_SEGMENTS * CLUSTER_REPLICATION // PROC_SERVERS}:
            raise AssertionError(f"processes: replicas a server {hosted}")

        conn = connect(b_url)
        queries = {**{name: CONFIGS[name] for name in CLUSTER_CONFIGS}, "config6_multistage": CONFIG6_SQL}
        launches, per_query = {}, {}
        first_s = {}
        for name, sql in queries.items():
            before = processes_calls(s_urls)
            t1 = time.perf_counter()
            rows = conn.execute(sql).rows
            first_s[name] = time.perf_counter() - t1
            launches[name] = {k: v - before[k] for k, v in processes_calls(s_urls).items()}
            rows_match(f"processes {name}", rows, want6 if name == "config6_multistage" else want[name])
            per_seg = (1, 0, 0, 0) if name == "config6_multistage" else LAUNCHES_PER_SEGMENT[name]
            expect = dict(zip(KERNEL_OF_REGISTRY.values(), (CLUSTER_SEGMENTS * v for v in per_seg)))
            if launches[name] != expect:
                raise AssertionError(f"processes {name}: launches {launches[name]}, expected {expect}")
        path_launches = {k: sum(v[k] for v in launches.values()) for k in KERNEL_OF_REGISTRY.values()}
        for name, sql in queries.items():
            w = wall_p50_of(lambda: conn.execute(sql), warm=1, runs=WALL_RUNS)
            per_query[name] = {"p50_ms": w["p50_ms"], "runs_ms": w["runs_ms"], "first_s": first_s[name],
                               "cluster_http_p50_ms": http_p50.get(name), "launches": launches[name]}

        # lookUp: nation_dim's PK map in each server process, the host executor
        before = processes_calls(s_urls)
        t1 = time.perf_counter()
        rows = conn.execute(LOOKUP_SQL).rows
        lookup_s = time.perf_counter() - t1
        rows_match("processes lookUp", rows, want6)
        lookup_launches = {k: v - before[k] for k, v in processes_calls(s_urls).items()}
        if any(lookup_launches.values()):
            raise AssertionError(f"processes lookUp: launched {lookup_launches}")

        # access control: a Basic-auth broker over the controller's REST client
        ac = BasicAuthAccessControl(principals=[Principal("reader", "r", tables=("lineorder",), permissions=("READ",))])
        auth_broker = Broker(RemoteControllerClient(c_url), access_control=ac, cache_config=CacheConfig(enabled=False))
        auth_svc = BrokerHTTPService(auth_broker)
        a_url = f"http://127.0.0.1:{auth_svc.port}"
        sql1 = CONFIGS["1_count_filter"]
        refused, refused_doc = auth_post(a_url, sql1)
        wrong, _ = auth_post(a_url, sql1, "reader", "wrong")
        admitted, doc = auth_post(a_url, sql1, "reader", "r")
        if refused != 403 or wrong != 403 or admitted != 200:
            raise AssertionError(f"processes access: statuses {refused} / {wrong} / {admitted}: {refused_doc}")
        rows_match("processes access", doc["resultTable"]["rows"], want["1_count_filter"])

        # /debug/pprof of the broker process while a query runs
        busy = threading.Thread(target=lambda: conn.execute(CONFIGS["4_q4_groupby_orderby"]))
        busy.start()
        import urllib.request

        with urllib.request.urlopen(f"{b_url}/debug/pprof?seconds=1", timeout=60) as r:
            folded = r.read().decode()
        busy.join(timeout=120)
        stacks = [ln for ln in folded.splitlines() if ln.strip()]
        if not stacks or not all(ln.rsplit(" ", 1)[1].isdigit() and ";" in ln for ln in stacks):
            raise AssertionError(f"processes pprof: no folded stacks: {folded[:500]!r}")

        memory = {}
        for s, u in zip(servers, s_urls):
            hbm = http_json(f"{u}/debug/roofline?top=0")["hbm"]
            memory[s.name] = {"pid": s.proc.pid, "live_bytes": hbm["liveBytes"], "peak_bytes": hbm["peakBytes"],
                              "source": hbm["source"]}
        emit(
            {
                "phase": "processes",
                "results_match_oracle": True,
                "segments": CLUSTER_SEGMENTS,
                "servers": PROC_SERVERS,
                "replication": CLUSTER_REPLICATION,
                "start_s": {r.name: r.start_s for r in roles},
                "cluster_up_s": cluster_up_s,
                "upload_s": upload_s,
                "queries": per_query,
                "launches": path_launches,
                "lookup": {"s": lookup_s, "launches": lookup_launches},
                "access": {"anonymous": refused, "wrong_password": wrong, "reader": admitted},
                "pprof": {"stacks": len(stacks), "samples": sum(int(ln.rsplit(" ", 1)[1]) for ln in stacks)},
                "device_memory": memory,
                "card_memory_used": {"before": card_before, "with_the_processes": card_memory_used()},
                "card": card_line(),
            }
        )
    finally:
        if auth_svc is not None:
            auth_svc.stop()
        if auth_broker is not None:
            auth_broker.shutdown()
        for r in roles:
            r.kill()
        _shutil.rmtree(root, ignore_errors=True)
    return path_launches


# ---------------------------------------------------------------------------
# phase 19: realtime ingestion (streams, consuming segments, commits, upsert)
# ---------------------------------------------------------------------------

#: the realtime phase's tables: rows, stream partitions, rows a segment.
#: Cut from 2.4M rows at 250,000 a segment (the phase took 216 s there on an
#: H100 80GB HBM3 at 700 W), then from 1.1M (all 90,000 customer keys; the
#: phase 125-150 s of a 1,018 s and an 812 s script) to keep the script well
#: inside its time: 700,000 rows hold 89,966 keys, one committed segment and
#: a consuming one a partition; each consuming segment keeps the ~75,000 rows
#: (~21,700 keys: past the flat kernel's shared counters, so
#: up_latest_revenue's group-by stays on the two-level kernel) it had at 1.1M
RT_ROWS, RT_PARTITIONS, RT_FLUSH = 700_000, 4, 100_000
RT_CONFIGS = ("1_count_filter", "2_filtered_agg", "3_q1_groupby", "4_q4_groupby_orderby", "5_groupby_minmax",
              "6_groupby_distinct", "7_distinct")
#: the live step: rows a second the producer adds, for about this long
RT_LIVE_RATE, RT_LIVE_S = 50_000, 10.0
#: share of the upsert table's rows that arrive with a ts older than their
#: key's latest (they must lose)
RT_LATE, RT_LATE_SEED = 0.01, 40
RT_REP_ROWS, RT_REP_FLUSH = 300_000, 100_000
RT_DEDUP_ROWS, RT_DEDUP_REPEAT = 200_000, 0.10
UPSERT_RT_CONFIGS = {
    "up_count": "SELECT COUNT(*) FROM lineorder_up",
    "up_by_nation": "SELECT c_nation, SUM(lo_revenue) FROM lineorder_up GROUP BY c_nation ORDER BY c_nation LIMIT 25",
    # each partition holds a quarter of the keys (partition = lo_custkey % 4):
    # ng ~22k a segment, past the flat kernel's shared counters
    "up_latest_revenue": (
        "SELECT lo_custkey, SUM(lo_revenue) FROM lineorder_up GROUP BY lo_custkey "
        "ORDER BY SUM(lo_revenue) DESC, lo_custkey LIMIT 100"
    ),
}
UPSERT_RT_LAUNCHES = {"up_count": (0, 0, 0, 0), "up_by_nation": (1, 0, 0, 0), "up_latest_revenue": (0, 0, 0, 1)}


def rt_sql(sql: str, table: str) -> str:
    """A lineorder config's SQL over another table."""
    return sql.replace("FROM lineorder ", f"FROM {table} ")


def rt_messages(data: dict, ts: np.ndarray) -> list:
    """One row dict a message: `data`'s columns and `ts`, in row order."""
    cols = list(data)
    lists = [data[c].tolist() for c in cols] + [ts.tolist()]
    keys = cols + ["ts"]
    return [dict(zip(keys, r)) for r in zip(*lists)]


def rt_produce(stream, rows: list, parts: np.ndarray) -> None:
    for p, row in zip(parts.tolist(), rows):
        stream.produce(p, row)


def rt_cluster(name: str, deep: str, config_kw: dict, pk=(), servers=("rt",)):
    """A Controller, Servers on DEVICE and a REALTIME lineorder-shaped table
    `name` with a LONG ts time column."""
    from pinot_tpu_torch.cluster import Controller, PropertyStore, Server
    from pinot_tpu_torch.common import TableConfig, TableType

    controller = Controller(PropertyStore(), deep)
    srv = [Server(sid, device=DEVICE) for sid in servers]
    for s in srv:
        controller.register_server(s.server_id, s)
    schema = ssb_schema(name, ts=True, primary_key=pk)
    controller.add_schema(schema)
    config = TableConfig(name, table_type=TableType.REALTIME, time_column="ts", replication=len(srv), **config_kw)
    controller.add_table(config)
    return controller, srv, schema, config


def committed_of(controller, table: str) -> dict:
    return {n: m for n, m in controller.all_segment_metadata(table).items() if "endOffset" in m}


def wait_for(pred, timeout: float, what: str) -> float:
    """Seconds until pred() holds; raises after `timeout`."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"realtime: timed out waiting for {what}")
        time.sleep(0.01)
    return time.perf_counter() - t0


class CommitTimes:
    """Per committed segment: seal + build, upload (deep-store write and
    metadata) and the load on the server, from wrappers around
    MutableSegment.seal, Controller.upload_segment and Server.add_segment."""

    def __init__(self, controller, servers):
        from pinot_tpu_torch.realtime.mutable import MutableSegment

        self.by_segment: dict[str, dict] = {}
        self._cls, self._seal = MutableSegment, MutableSegment.seal
        times = self.by_segment

        def seal(ms, *a, **k):
            t0 = time.perf_counter()
            out = self._seal(ms, *a, **k)
            times.setdefault(out.name, {})["seal_build_s"] = time.perf_counter() - t0
            return out

        MutableSegment.seal = seal
        for s in servers:
            real_add = s.add_segment

            def add(table, name, seg_dir, _real=real_add):
                t0 = time.perf_counter()
                _real(table, name, seg_dir)
                times.setdefault(name, {}).setdefault("load_s", []).append(time.perf_counter() - t0)

            s.add_segment = add
        real_upload = controller.upload_segment

        def upload(table, segment):
            t0 = time.perf_counter()
            out = real_upload(table, segment)
            e = times.setdefault(segment.name, {})
            e["upload_s"] = time.perf_counter() - t0 - sum(e.get("load_s", []))
            return out

        controller.upload_segment = upload

    def close(self) -> None:
        self._cls.seal = self._seal


class Generations:
    """Every consuming snapshot built (its partition's name, docs and build
    ms) and every staging of one (bytes, ms), from wrappers around
    MutableSegment.snapshot and ImmutableSegment.to_device."""

    def __init__(self):
        from pinot_tpu_torch.realtime.mutable import MutableSegment
        from pinot_tpu_torch.segment.segment import ImmutableSegment

        self.built: list[dict] = []
        self.staged: list[dict] = []
        self._ids: dict[int, dict] = {}
        self._snap, self._stage = MutableSegment.snapshot, ImmutableSegment.to_device
        gens = self

        def snapshot(ms):
            before = ms._snapshot
            t0 = time.perf_counter()
            snap = gens._snap(ms)
            if snap is not before:
                entry = {"segment": snap.name, "docs": snap.n_docs, "build_ms": (time.perf_counter() - t0) * 1e3}
                gens.built.append(entry)
                gens._ids[id(snap)] = entry
            return snap

        def to_device(seg, *a, **k):
            t0 = time.perf_counter()
            ds = gens._stage(seg, *a, **k)
            entry = gens._ids.get(id(seg))
            if entry is not None and entry["segment"] == seg.name:
                entry["staged_bytes"] = sum(t.numel() * t.element_size() for t in ds.arrays.values())
                entry["stage_ms"] = (time.perf_counter() - t0) * 1e3
            return ds

        MutableSegment.snapshot, ImmutableSegment.to_device = snapshot, to_device

    def close(self) -> None:
        from pinot_tpu_torch.realtime.mutable import MutableSegment
        from pinot_tpu_torch.segment.segment import ImmutableSegment

        MutableSegment.snapshot, ImmutableSegment.to_device = self._snap, self._stage

    def summary(self, since: int = 0) -> dict:
        got = self.built[since:]
        ms = [g["build_ms"] for g in got]
        staged = [g["staged_bytes"] for g in got if "staged_bytes" in g]
        return {
            "generations": len(got),
            "staged_generations": len(staged),
            "build_ms_p50": float(np.median(ms)) if ms else None,
            "build_ms_max": max(ms) if ms else None,
            "staged_bytes_p50": float(np.median(staged)) if staged else None,
            "staged_bytes_max": max(staged) if staged else None,
            "each": got,
        }


def hist_quantiles(hist, before: list, qs=(0.5, 0.99)) -> dict:
    """Quantiles (bucket upper bounds, ms) of the samples a histogram took
    since its bucket counts were `before`."""
    from pinot_tpu_torch.common.metrics import _HIST_BOUNDS

    d = [a - b for a, b in zip(hist.counts, before)]
    total = sum(d)
    out = {"samples": total}
    for q in qs:
        target, seen = max(1, math.ceil(q * total)), 0
        for i, c in enumerate(d):
            seen += c
            if seen >= target:
                out[f"p{round(q * 100)}_ms"] = _HIST_BOUNDS[i] if i < len(_HIST_BOUNDS) else hist.max_ms
                break
    return out


def rt_watermark(mgr) -> list:
    """Rows each partition has made visible to queries: its committed and
    pending rows (the current segment's start offset) and its consuming
    segment's docs, read under the consumer's lock."""
    out = []
    for c in mgr.consumers:
        with c._lock:
            out.append(c._segment_start_offset + c._mutable.n_docs)
    return out


def rt_count_at(cum: list, w: list) -> int:
    return int(sum(c[x] for c, x in zip(cum, w)))


def q4_bounds(parts_idx: list, key, val, w0: list, w1: list):
    """Per (year, nation, category) group of config 4: the least and the
    most its SUM can be at any watermark between w0 and w1 (each
    partition's rows in between either counted or not, as a prefix)."""
    base = np.zeros(7 * 625)
    lo, hi = np.zeros(7 * 625), np.zeros(7 * 625)
    for idx, a, b in zip(parts_idx, w0, w1):
        head, win = idx[:a], idx[a:b]
        base += np.bincount(key[head], weights=val[head], minlength=7 * 625)
        lo += np.bincount(key[win], weights=np.minimum(val[win], 0), minlength=7 * 625)
        hi += np.bincount(key[win], weights=np.maximum(val[win], 0), minlength=7 * 625)
    return base + lo, base + hi


def run_realtime(torch, counters: dict) -> dict:
    """Phase 19: realtime ingestion on the card. One Controller, Servers on
    the card and an uncached Broker, all in process.
    1. lineorder_rt: RT_ROWS rows of make_ssb_data (seed 0) and an arrival
       ts, produced into an InMemoryStream of RT_PARTITIONS partitions
       (partition = lo_custkey % 4), consumed by a RealtimeTableManager at
       RT_FLUSH rows a segment: 1 committed segment and a consuming one a
       partition. Ingest rows/s; each commit's seal + build, upload and load
       seconds; configs 1-7 through the broker, each equal to the oracle,
       its launches (counted from 0 just before, read just after) equal to
       LAUNCHES_PER_SEGMENT x the 8 segments routed, every kernel call held
       against its plain version; their wall p50.
    2. Live consumption: a producer thread adds RT_LIVE_RATE rows a second
       (make_ssb_data seed 1) for RT_LIVE_S s while configs 1 and 4 run in a
       loop. COUNT never goes down; each answer lies between the oracles at
       the watermarks read just before and just after it (config 4's sums
       inside their groups' bounds), and equals the oracle once the
       producer stops. Freshness p50 / p99 (producer stamp -> indexed), each
       consuming generation's snapshot build ms and staged bytes, the
       allocator's live and peak bytes after the first and the last loop;
       old generations must be freed (one live staged copy a segment, and
       live bytes within what the hosted and consuming segments stage).
    3. lineorder_up: the same rows as a FULL upsert table keyed by
       lo_custkey (comparison column ts); a seeded RT_LATE of the rows carry
       a ts older than their key's latest and lose. COUNT(*) (the distinct
       keys: 89,966), SUM(lo_revenue) by c_nation (B1 under the validity
       docmask) and the latest revenue a key (B2), against the oracle "the
       row with the largest ts a key, later arrival on ties", launches and
       kernel calls as in 1. Then a new manager over the same controller and
       server: it resumes at the committed end offsets, replays the
       committed segments' keys, and answers the same rows; its masks equal
       the first manager's upsert snapshot files restored.
    4. lineorder_rep: 1 partition, RT_REP_ROWS rows at RT_REP_FLUSH, two
       servers on the card sharing one SegmentCompletionManager: each
       segment has exactly one committer, the other replica KEEPs or
       downloads; each replica's segments answer config 4 equal to the
       oracle, and the broker does over the empty consuming segment and
       again over a one-row one.
    5. A dedup table (host-side logic): RT_DEDUP_ROWS rows, RT_DEDUP_REPEAT
       of them repeating an earlier key; COUNT(*) equals the distinct keys.
    Returns the phase's launches."""
    import tempfile

    from pinot_tpu_torch.cluster import Broker
    from pinot_tpu_torch.common import UpsertConfig
    from pinot_tpu_torch.common.config import CacheConfig, DedupConfig
    from pinot_tpu_torch.common.leakcheck import staging_tracker
    from pinot_tpu_torch.common.metrics import ServerHistogram, server_metrics
    from pinot_tpu_torch.ops import extreme as ext
    from pinot_tpu_torch.ops import groupby as gb
    from pinot_tpu_torch.ops import grouped_sum_f32 as gs
    from pinot_tpu_torch.query import QueryEngine
    from pinot_tpu_torch.realtime import InMemoryStream, RealtimeTableManager
    from pinot_tpu_torch.realtime.completion import SegmentCompletionManager
    from pinot_tpu_torch.upsert import PartitionUpsertMetadataManager

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    deep = tempfile.mkdtemp(prefix="chip_smoke_realtime_")
    gens = Generations()
    out, launches, held = {}, {}, {}
    for fn in counters.values():
        fn.launches = 0

    def counted(label, sql, expect):
        res, launches[label], calls = counted_run(counters, lambda: broker.execute(sql))
        check_launches(f"realtime {label}", counters, launches[label], calls, expect)
        held[label] = hold_all(torch, calls, gb, ext, gs)
        return res

    def match(label, got, want, approx_as=None):
        try:
            rows_match(approx_as or label, got, want)
        except AssertionError as e:
            raise AssertionError(f"realtime {label}: {e}") from None

    # -- 1. the append-only table ---------------------------------------------
    t0 = time.perf_counter()
    data, nation, category = make_ssb_data(RT_ROWS, seed=0)
    parts = (data["lo_custkey"] % RT_PARTITIONS).astype(np.int64)
    stream = InMemoryStream(RT_PARTITIONS)
    rt_produce(stream, rt_messages(data, np.arange(RT_ROWS)), parts)
    produce_s = time.perf_counter() - t0
    controller, (server,), schema, config = rt_cluster("lineorder_rt", f"{deep}/rt", {})
    commits = CommitTimes(controller, [server])
    mgr = RealtimeTableManager(controller, server, schema, config, stream, max_rows_per_segment=RT_FLUSH)
    per_part = np.bincount(parts, minlength=RT_PARTITIONS)
    n_committed = int(sum(c // RT_FLUSH for c in per_part))
    t0 = time.perf_counter()
    mgr.start()
    wait_for(lambda: mgr.wait_until_caught_up(per_part.tolist(), timeout=0.5), 600, "lineorder_rt caught up")
    wait_for(lambda: len(committed_of(controller, "lineorder_rt")) == n_committed, 120, "lineorder_rt commits")
    ingest_s = time.perf_counter() - t0
    n_segments = n_committed + RT_PARTITIONS
    if len(controller.ideal_state("lineorder_rt")) != n_segments:
        raise AssertionError(f"realtime: ideal state {sorted(controller.ideal_state('lineorder_rt'))}")
    want, _ = oracle(data, nation, category)
    broker = Broker(controller, cache_config=CacheConfig(enabled=False))
    for name in RT_CONFIGS:
        sql = rt_sql(CONFIGS[name], "lineorder_rt")
        res = counted(name, sql, tuple(n_segments * v for v in LAUNCHES_PER_SEGMENT[name]))
        match(name, res.rows, want[name])
    walls = {name: wall_p50_of(lambda: broker.execute(rt_sql(CONFIGS[name], "lineorder_rt")), warm=1, runs=WALL_RUNS)
             for name in RT_CONFIGS}
    torch.cuda.synchronize()
    out["append_only"] = {
        "rows": RT_ROWS,
        "partitions": RT_PARTITIONS,
        "rows_a_segment": RT_FLUSH,
        "segments_committed": n_committed,
        "segments_routed": n_segments,
        "produce_s": produce_s,
        "ingest_s": ingest_s,
        "ingest_rows_per_s": RT_ROWS / ingest_s,
        "commits": dict(sorted(commits.by_segment.items())),
        "snapshots": gens.summary(),
        "wall_p50_ms": {k: v["p50_ms"] for k, v in walls.items()},
        "walls_ms": {k: v["runs_ms"] for k, v in walls.items()},
        "results_match_oracle": True,
    }

    # -- 2. live consumption -------------------------------------------------------
    live_n = int(RT_LIVE_RATE * RT_LIVE_S)
    live, live_nation, live_category = make_ssb_data(live_n, seed=1)
    live_parts = (live["lo_custkey"] % RT_PARTITIONS).astype(np.int64)
    live_rows = rt_messages(live, np.arange(RT_ROWS, RT_ROWS + live_n))
    allc = {c: np.concatenate([data[c], live[c]]) for c in ("d_year", "lo_quantity", "lo_revenue", "lo_supplycost")}
    all_nation = np.concatenate([nation, live_nation])
    all_category = np.concatenate([category, live_category])
    all_parts = np.concatenate([parts, live_parts])
    parts_idx = [np.flatnonzero(all_parts == p) for p in range(RT_PARTITIONS)]
    cum1 = [np.r_[0, np.cumsum(all_nation[idx] == 7)] for idx in parts_idx]
    m4 = (allc["lo_quantity"] > 5) & (allc["d_year"] >= 1993) & (allc["d_year"] <= 1997)
    key4 = (allc["d_year"].astype(np.int64) - 1992) * 625 + all_nation * 25 + all_category
    val4 = np.where(m4, allc["lo_revenue"] - allc["lo_supplycost"], 0).astype(np.float64)
    fresh = server_metrics().histogram(ServerHistogram.FRESHNESS, table="lineorder_rt")
    fresh_before = list(fresh.counts)
    gen0 = len(gens.built)
    stop = threading.Event()

    def producer():
        step = max(1, RT_LIVE_RATE // 50)  # a batch every 20 ms
        t_start = time.perf_counter()
        for i in range(0, live_n, step):
            if stop.is_set():
                return
            delay = t_start + i / RT_LIVE_RATE - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            rt_produce(stream, live_rows[i : i + step], live_parts[i : i + step])

    q1, q4 = rt_sql(CONFIGS["1_count_filter"], "lineorder_rt"), rt_sql(CONFIGS["4_q4_groupby_orderby"], "lineorder_rt")
    prod = threading.Thread(target=producer, daemon=True)
    loops, last_count, memory = [], -1, {}
    t_live = time.perf_counter()
    prod.start()
    try:
        while prod.is_alive() or not loops:
            w0 = rt_watermark(mgr)
            t0 = time.perf_counter()
            r1 = broker.execute(q1)
            t1 = time.perf_counter()
            w1 = rt_watermark(mgr)
            count = int(r1.rows[0][0])
            lo_c, hi_c = rt_count_at(cum1, w0), rt_count_at(cum1, w1)
            if not lo_c <= count <= hi_c or count < last_count:
                raise AssertionError(f"realtime live: COUNT {count} outside [{lo_c}, {hi_c}] or below {last_count}")
            last_count = count
            w2 = rt_watermark(mgr)
            t2 = time.perf_counter()
            r4 = broker.execute(q4)
            t3 = time.perf_counter()
            w3 = rt_watermark(mgr)
            lo4, hi4 = q4_bounds(parts_idx, key4, val4, w2, w3)
            sums = [row[3] for row in r4.rows]
            if len(r4.rows) != 10 or sums != sorted(sums, reverse=True):
                raise AssertionError(f"realtime live: config 4 rows {r4.rows}")
            for y, nat, cat, v in r4.rows:
                g = (y - 1992) * 625 + NATIONS.index(nat) * 25 + CATEGORIES.index(cat)
                if not lo4[g] <= v <= hi4[g]:
                    raise AssertionError(f"realtime live: config 4 group {y, nat, cat} sum {v} outside "
                                         f"[{lo4[g]}, {hi4[g]}]")
            loops.append({"watermark": sum(w1), "q1_ms": (t1 - t0) * 1e3, "q4_ms": (t3 - t2) * 1e3})
            if len(loops) == 1:
                torch.cuda.synchronize()
                memory["after_first_loop"] = {"live": torch.cuda.memory_allocated() - base_bytes,
                                              "peak": torch.cuda.max_memory_allocated()}
    finally:
        stop.set()
        prod.join()
    live_s = time.perf_counter() - t_live
    torch.cuda.synchronize()

    def staged_now() -> int:
        """Bytes the hosted segments and each partition's current (and
        pending sealed) snapshots stage: what may be live on the card."""
        segs = [server.get_segment_object("lineorder_rt", n) for n in server.segments_of("lineorder_rt")]
        for c in mgr.consumers:
            with c._lock:
                segs += [c._mutable._snapshot, *c._pending_sealed.values()]
        return sum(seg_staged_bytes(s) for s in segs if s is not None)

    # without a collector pass: a replaced generation's staging must already
    # be gone, however many generations the loop made
    memory["after_last_loop"] = {"live": torch.cuda.memory_allocated() - base_bytes,
                                 "peak": torch.cuda.max_memory_allocated(), "staged_by_segments": staged_now()}
    if memory["after_last_loop"]["live"] > memory["after_last_loop"]["staged_by_segments"] + (64 << 20):
        raise AssertionError(f"realtime live: old generations hold card memory: {memory}")
    # quiesce: the producer stopped; every row consumed and each full segment
    # committed; then the answers equal the oracle exactly
    per_part_all = np.bincount(all_parts, minlength=RT_PARTITIONS)
    catchup_s = wait_for(lambda: mgr.wait_until_caught_up(per_part_all.tolist(), timeout=0.5), 600, "live rows")
    n_committed = int(sum(c // RT_FLUSH for c in per_part_all))
    wait_for(lambda: len(committed_of(controller, "lineorder_rt")) == n_committed, 120, "live commits")
    final = {c: np.concatenate([data[c], live[c]]) for c in data}
    want_all, _ = oracle(final, all_nation, all_category)
    for name, sql in (("1_count_filter", q1), ("4_q4_groupby_orderby", q4)):
        match(f"live {name}", broker.execute(sql).rows, want_all[name], approx_as=name)
    gc.collect()
    torch.cuda.synchronize()
    live_copies = {n: c for n, c in staging_tracker.live().items() if n.startswith("lineorder_rt__")}
    expect_bytes = staged_now()
    live_bytes = torch.cuda.memory_allocated() - base_bytes
    memory["quiesced"] = {"live": live_bytes, "staged_by_segments": expect_bytes}
    if max(live_copies.values()) != 1:
        raise AssertionError(f"realtime live: old generations still staged {live_copies}")
    if live_bytes > expect_bytes + (64 << 20):
        raise AssertionError(f"realtime live: {live_bytes} B live on the card, segments stage {expect_bytes} B")
    out["live"] = {
        "rows_a_second": RT_LIVE_RATE,
        "rows": live_n,
        "seconds": live_s,
        "loops": len(loops),
        "loop_q1_ms_p50": float(np.median([x["q1_ms"] for x in loops])),
        "loop_q4_ms_p50": float(np.median([x["q4_ms"] for x in loops])),
        "catchup_after_producer_s": catchup_s,
        "segments_committed": n_committed,
        "freshness": hist_quantiles(fresh, fresh_before),
        "snapshots": gens.summary(gen0),
        "allocator_bytes": memory,
        "staged_copies_a_segment": max(live_copies.values()),
        "answers_between_watermark_oracles": True,
    }
    mgr.stop()
    broker.shutdown()
    commits.close()
    out["append_only"]["commits_live"] = {k: v for k, v in commits.by_segment.items()
                                          if k not in out["append_only"]["commits"]}
    del mgr, broker, server, controller, stream, live_rows, allc, final
    gc.collect()

    # -- 3. the upsert table -------------------------------------------------------
    cust = data["lo_custkey"]
    order = np.lexsort((np.arange(RT_ROWS), cust))
    same = np.r_[False, cust[order][1:] == cust[order][:-1]]
    prev = np.full(RT_ROWS, -1, dtype=np.int64)
    prev[order[same]] = order[np.flatnonzero(same) - 1]
    rng = np.random.default_rng(RT_LATE_SEED)
    late = np.flatnonzero((rng.random(RT_ROWS) < RT_LATE) & (prev >= 0))
    ts = np.arange(RT_ROWS, dtype=np.int64)
    for i in late.tolist():  # arrival order: a late row's predecessor is final
        ts[i] = ts[prev[i]] - 1
    win = np.lexsort((np.arange(RT_ROWS), ts, cust))
    lastk = np.r_[cust[win][1:] != cust[win][:-1], True]
    live_mask = np.zeros(RT_ROWS, dtype=bool)
    live_mask[win[lastk]] = True
    rev = data["lo_revenue"]
    sums = np.bincount(nation[live_mask], weights=rev[live_mask], minlength=25)
    cnt = np.bincount(nation[live_mask], minlength=25)
    keys = cust[live_mask]
    top = np.lexsort((keys, -rev[live_mask]))[:100]
    want_up = {
        "up_count": [[int(live_mask.sum())]],
        "up_by_nation": [[NATIONS[i], float(sums[i])] for i in range(25) if cnt[i]],
        "up_latest_revenue": [[int(keys[i]), float(rev[live_mask][i])] for i in top],
    }
    t0 = time.perf_counter()
    stream = InMemoryStream(RT_PARTITIONS)
    rt_produce(stream, rt_messages(data, ts), parts)
    up_produce_s = time.perf_counter() - t0
    controller, (server,), schema, config = rt_cluster(
        "lineorder_up", f"{deep}/up", {"upsert": UpsertConfig(mode="FULL", comparison_column="ts")}, pk=("lo_custkey",)
    )
    commits = CommitTimes(controller, [server])
    mgr = RealtimeTableManager(controller, server, schema, config, stream, max_rows_per_segment=RT_FLUSH)
    n_committed = int(sum(c // RT_FLUSH for c in per_part))
    t0 = time.perf_counter()
    mgr.start()
    wait_for(lambda: mgr.wait_until_caught_up(per_part.tolist(), timeout=0.5), 900, "lineorder_up caught up")
    wait_for(lambda: len(committed_of(controller, "lineorder_up")) == n_committed, 120, "lineorder_up commits")
    up_ingest_s = time.perf_counter() - t0
    broker = Broker(controller, cache_config=CacheConfig(enabled=False))

    def upsert_queries(tag):
        rows, walls = {}, {}
        for name, sql in UPSERT_RT_CONFIGS.items():
            res = counted(f"{tag}{name}", sql, tuple(n_segments * v for v in UPSERT_RT_LAUNCHES[name]))
            match(f"{tag}{name}", res.rows, want_up[name])
            rows[name] = res.rows
            walls[name] = wall_p50_of(lambda: broker.execute(sql), warm=0, runs=3)["p50_ms"]
        return rows, walls

    up_rows, up_walls = upsert_queries("")
    masks = {p: {s: vd.mask(vd.n).copy() for s, vd in u._valid.items()} for p, u in mgr.upsert_managers.items()}
    mgr.stop()
    snap_files, t0 = {}, time.perf_counter()
    for p, u in mgr.upsert_managers.items():
        snap_files[p] = f"{deep}/up_snapshot_{p}.json"
        u.snapshot(snap_files[p])
    snapshot_s = time.perf_counter() - t0
    committed_ends = {}
    for n, m in committed_of(controller, "lineorder_up").items():
        committed_ends[m["partition"]] = max(committed_ends.get(m["partition"], 0), m["endOffset"])
    t0 = time.perf_counter()
    mgr2 = RealtimeTableManager(controller, server, schema, config, stream, max_rows_per_segment=RT_FLUSH)
    bootstrap_s = time.perf_counter() - t0
    resumed = [c.current_offset for c in mgr2.consumers]
    if resumed != [committed_ends[p] for p in range(RT_PARTITIONS)]:
        raise AssertionError(f"realtime upsert restart: resumed at {resumed}, committed ends {committed_ends}")
    t0 = time.perf_counter()
    mgr2.start()
    wait_for(lambda: mgr2.wait_until_caught_up(per_part.tolist(), timeout=0.5), 900, "lineorder_up after restart")
    reconsume_s = time.perf_counter() - t0
    masks2 = {p: {s: vd.mask(vd.n).copy() for s, vd in u._valid.items()} for p, u in mgr2.upsert_managers.items()}
    for p, f in snap_files.items():
        restored = PartitionUpsertMetadataManager(["lo_custkey"], comparison_column="ts")
        restored.restore(f)
        got = {s: vd.mask(vd.n) for s, vd in restored._valid.items()}
        for m in (masks[p], masks2[p]):
            if sorted(got) != sorted(m) or any(not np.array_equal(got[s], m[s]) for s in got):
                raise AssertionError(f"realtime upsert restart: partition {p}'s validity differs from its snapshot")
    up_rows2, up_walls2 = upsert_queries("restart_")
    if up_rows2 != up_rows:
        raise AssertionError("realtime upsert restart: rows differ")
    mgr2.stop()
    broker.shutdown()
    commits.close()
    out["upsert"] = {
        "rows": RT_ROWS,
        "late_rows": int(len(late)),
        "live_rows": int(live_mask.sum()),
        "produce_s": up_produce_s,
        "ingest_s": up_ingest_s,
        "ingest_rows_per_s": RT_ROWS / up_ingest_s,
        "commits": dict(sorted(commits.by_segment.items())),
        "query_wall_p50_ms": up_walls,
        "restart": {"snapshot_s": snapshot_s, "bootstrap_s": bootstrap_s, "reconsume_s": reconsume_s,
                    "resumed_offsets": resumed, "query_wall_p50_ms": up_walls2},
        "count": up_rows["up_count"][0][0],
        "results_match_oracle": True,
    }
    del mgr, mgr2, broker, server, controller, stream, masks, masks2
    gc.collect()

    # -- 4. replicas and the completion protocol -------------------------------------
    rep = {c: v[:RT_REP_ROWS] for c, v in data.items()}
    rep_nation, rep_category = nation[:RT_REP_ROWS], category[:RT_REP_ROWS]
    stream = InMemoryStream(1)
    rt_produce(stream, rt_messages(rep, np.arange(RT_REP_ROWS)), np.zeros(RT_REP_ROWS, dtype=np.int64))
    controller, servers, schema, config = rt_cluster("lineorder_rep", f"{deep}/rep", {}, servers=("rep_0", "rep_1"))
    completion = SegmentCompletionManager(commit_timeout_s=60.0)
    mgrs = [RealtimeTableManager(controller, s, schema, config, stream, max_rows_per_segment=RT_REP_FLUSH,
                                 completion=completion) for s in servers]
    n_rep = RT_REP_ROWS // RT_REP_FLUSH
    names = [f"lineorder_rep__0__{i}" for i in range(n_rep)]
    t0 = time.perf_counter()
    for m in mgrs:
        m.start()
    wait_for(lambda: all(completion.phase(n) == "COMMITTED" for n in names), 300, "lineorder_rep commits")
    wait_for(lambda: all(set(names) <= set(s.segments_of("lineorder_rep")) for s in servers), 120, "both replicas")

    def decided(n):
        who = {}
        for s, m in zip(servers, mgrs):
            log = [e for e in list(m.consumers[0].commit_log) if e[0] == n]
            won = any(e[1] == "COMMIT_END" and e[2] for e in log)
            kept = any(e[1] == "KEPT" for e in log)
            got = any(e[1] == "DOWNLOADED" for e in log)
            who[s.server_id] = "commit" if won else "keep" if kept else "download" if got else "none"
        return who

    wait_for(lambda: all("none" not in decided(n).values() for n in names), 120, "every replica's decision")
    rep_s = time.perf_counter() - t0
    decisions = {n: decided(n) for n in names}
    for n, who in decisions.items():
        if list(who.values()).count("commit") != 1:
            raise AssertionError(f"realtime replicas: segment {n}: {who}")
    rep_want, _ = oracle(rep, rep_nation, rep_category)
    q4 = rt_sql(CONFIGS["4_q4_groupby_orderby"], "lineorder_rep")
    for s in servers:
        segs = [s.get_segment_object("lineorder_rep", n) for n in names]
        res, launches[f"replica_{s.server_id}"], calls = counted_run(
            counters, lambda: QueryEngine(segs, device=DEVICE).execute(q4)
        )
        check_launches(f"realtime replica {s.server_id}", counters, launches[f"replica_{s.server_id}"], calls,
                       (n_rep, 0, 0, 0))
        held[f"replica_{s.server_id}"] = hold_all(torch, calls, gb, ext, gs)
        match(f"replica {s.server_id}", res.rows, rep_want["4_q4_groupby_orderby"], approx_as="4_q4_groupby_orderby")
    broker = Broker(controller, cache_config=CacheConfig(enabled=False))
    # the consuming segment right after the last rollover: 0 docs (pruned),
    # then 1 (padded to the doc pad, one more B1 launch)
    res = counted("replica_broker_empty_consuming", q4, (n_rep, 0, 0, 0))
    match("replica broker", res.rows, rep_want["4_q4_groupby_orderby"], approx_as="4_q4_groupby_orderby")
    one = {c: v[RT_REP_ROWS : RT_REP_ROWS + 1] for c, v in data.items()}
    rt_produce(stream, rt_messages(one, np.arange(RT_REP_ROWS, RT_REP_ROWS + 1)), np.zeros(1, dtype=np.int64))
    wait_for(lambda: all(m.consumers[0].current_offset == RT_REP_ROWS + 1 for m in mgrs), 60, "the one-row segment")
    want1, _ = oracle({c: v[: RT_REP_ROWS + 1] for c, v in data.items()}, nation[: RT_REP_ROWS + 1],
                      category[: RT_REP_ROWS + 1])
    res = counted("replica_broker_one_doc_consuming", q4, (n_rep + 1, 0, 0, 0))
    match("replica broker one-doc", res.rows, want1["4_q4_groupby_orderby"], approx_as="4_q4_groupby_orderby")
    for m in mgrs:
        m.stop()
    broker.shutdown()
    out["replicas"] = {
        "rows": RT_REP_ROWS,
        "segments": n_rep,
        "seconds": rep_s,
        "decisions": decisions,
        "kept": sum(v == "keep" for d in decisions.values() for v in d.values()),
        "downloaded": sum(v == "download" for d in decisions.values() for v in d.values()),
        "results_match_oracle": True,
    }
    del mgrs, broker, servers, controller, stream
    gc.collect()

    # -- 5. dedup ------------------------------------------------------------------
    rng = np.random.default_rng(41)
    keys = np.arange(RT_DEDUP_ROWS, dtype=np.int64)
    repeats = np.sort(rng.choice(np.arange(1, RT_DEDUP_ROWS), int(RT_DEDUP_ROWS * RT_DEDUP_REPEAT), replace=False))
    for i in repeats.tolist():  # an earlier row's key
        keys[i] = keys[int(rng.integers(0, i))]
    dd, dd_nation, _ = make_ssb_data(RT_DEDUP_ROWS, seed=2)
    dd["lo_custkey"] = keys.astype(np.int32)
    stream = InMemoryStream(RT_PARTITIONS)
    rt_produce(stream, rt_messages(dd, np.arange(RT_DEDUP_ROWS)), keys % RT_PARTITIONS)
    controller, (server,), schema, config = rt_cluster("lineorder_dd", f"{deep}/dd", {"dedup": DedupConfig()},
                                                       pk=("lo_custkey",))
    mgr = RealtimeTableManager(controller, server, schema, config, stream, max_rows_per_segment=RT_FLUSH)
    t0 = time.perf_counter()
    mgr.start()
    dd_parts = np.bincount(keys % RT_PARTITIONS, minlength=RT_PARTITIONS)
    wait_for(lambda: mgr.wait_until_caught_up(dd_parts.tolist(), timeout=0.5), 300, "lineorder_dd caught up")
    dd_s = time.perf_counter() - t0
    _, first = np.unique(keys, return_index=True)
    want_dd = [[len(first), float(dd["lo_revenue"][first].sum())]]
    broker = Broker(controller, cache_config=CacheConfig(enabled=False))
    res = counted("dedup", "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder_dd", (0, 0, 0, 0))
    match("dedup", res.rows, want_dd)
    mgr.stop()
    broker.shutdown()
    out["dedup"] = {"rows": RT_DEDUP_ROWS, "distinct_keys": len(first), "ingest_s": dd_s,
                    "ingest_rows_per_s": RT_DEDUP_ROWS / dd_s, "results_match_oracle": True}
    del mgr, broker, server, controller, stream
    gens.close()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(deep, ignore_errors=True)

    path_launches = {k: sum(v[k] for v in launches.values()) for k in counters}
    emit(
        {
            "phase": "realtime",
            **out,
            "launches_per_query": launches,
            "launches": path_launches,
            "kernels_vs_plain": held,
            "seconds": time.perf_counter() - t_phase,
            "card": card_line(),
        }
    )
    return path_launches


# ---------------------------------------------------------------------------
# phase 20: the control plane (controller HA, periodic tasks, rebalance)
# ---------------------------------------------------------------------------

#: bench.py `cluster`'s table (its schema, its 5 segments and seed 12,
#: replication 2) at 200,000 rows a segment where bench.py has 96,000 rows
#: in all; its load of 12 clients for 5 s a leg cut to 8 clients for 2 s
CP_TABLE, CP_SEGMENTS, CP_SEG_ROWS, CP_SEED = "lineorder_ha", 5, 200_000, 12
CP_CLIENTS, CP_PHASE_S = 8, 2.0
CP_REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE")
CP_QUERIES = (
    f"SELECT COUNT(*) FROM {CP_TABLE} WHERE year > 1994",
    f"SELECT region, SUM(revenue) FROM {CP_TABLE} GROUP BY region ORDER BY region",
)
#: B1 launches a quiesced answer: none for the COUNT, one a segment for the
#: GROUP BY (each segment answered by exactly one replica)
CP_B1 = (0, CP_SEGMENTS)
#: bench.py's controller flags: HA (`_cluster_ha_phases`) and the periodic
#: tasks (`cluster` mode), both on each of the two controllers
CP_CONTROLLER_ARGS = ["--ha", "--lease-ttl", "1.0", "--renew-every", "0.2",
                      "--with-periodics", "--metrics-interval", "2", "--scrub-interval", "1"]
#: the in-process compatibility suite: rows a batch, batches
CP_COMPAT_ROWS, CP_COMPAT_BATCHES = 20_000, 3


def cp_data() -> list:
    """bench.py `cluster`'s segments at CP_SEG_ROWS: region, year, revenue."""
    rng = np.random.default_rng(CP_SEED)
    return [
        {
            "region": np.array(CP_REGIONS, dtype=object)[rng.integers(0, 4, CP_SEG_ROWS)],
            "year": rng.integers(1992, 1999, CP_SEG_ROWS).astype(np.int32),
            "revenue": rng.integers(100, 600_000, CP_SEG_ROWS).astype(np.int64),
        }
        for _ in range(CP_SEGMENTS)
    ]


def cp_oracle(parts: list) -> list:
    """numpy rows of CP_QUERIES over the parts."""
    region = np.concatenate([p["region"] for p in parts])
    year = np.concatenate([p["year"] for p in parts])
    revenue = np.concatenate([p["revenue"] for p in parts])
    return [
        [[int((year > 1994).sum())]],
        [[r, float(revenue[region == r].sum())] for r in sorted(set(region.tolist()))],
    ]


def cp_classify(stats: dict, lock, res=None, exc=None) -> None:
    """bench.py's outcome classes: ok, typed (timeout 250 / 503, or a typed
    admission rejection), dropped (no ONLINE replica), untyped."""
    from pinot_tpu_torch.common.errors import QueryErrorCode

    kind, detail = "ok", None
    if exc is not None:
        name = type(exc).__name__
        if name in ("SchedulerRejectedError", "QuotaExceededError"):
            kind = "typed_shed"
        elif "no ONLINE replica" in str(exc):
            kind, detail = "dropped", str(exc)[:300]
        else:
            kind, detail = "untyped", f"{name}: {exc}"[:300]
    else:
        excs = res.get("exceptions") or []
        codes = {e.get("errorCode") for e in excs}
        msgs = " | ".join(str(e.get("message", "")) for e in excs)
        if not excs:
            kind = "ok"
        elif "no ONLINE replica" in msgs:
            kind, detail = "dropped", msgs[:300]
        elif codes <= {int(QueryErrorCode.EXECUTION_TIMEOUT), 503}:
            kind = "typed_timeout"
        else:
            kind, detail = "untyped", f"codes={sorted(codes, key=str)}: {msgs}"[:300]
    with lock:
        stats[kind] += 1
        if detail and len(stats["samples"]) < 8:
            stats["samples"].append(detail)


def cp_drive(urls: list, n_clients: int, duration_s: float, conn: bool = False) -> dict:
    """bench.py's closed-loop load: `n_clients` threads issue CP_QUERIES
    round-robin for `duration_s`, over the brokers' HTTP endpoints in turn
    (`_cluster_drive`) or, with `conn`, each through a client Connection
    over all of them, which fails over to the next broker itself
    (`_cluster_drive_conn`). Outcome counts and client latency p50 / p99."""
    from pinot_tpu_torch.client import Connection, PinotClientError
    from pinot_tpu_torch.cluster.http import query_broker_http

    stats = {"ok": 0, "typed_timeout": 0, "typed_shed": 0, "dropped": 0, "untyped": 0, "samples": []}
    lat_ms: list = []
    lock = threading.Lock()
    stop_at = time.perf_counter() + duration_s
    barrier = threading.Barrier(n_clients + 1)

    def client(idx: int) -> None:
        mine, j = [], 0
        c = Connection(broker_urls=list(urls)) if conn else None
        barrier.wait(timeout=60)
        while time.perf_counter() < stop_at:
            q = CP_QUERIES[(idx + j) % len(CP_QUERIES)]
            url = urls[(idx + j) % len(urls)]
            j += 1
            t0 = time.perf_counter()
            try:
                if conn:
                    rs = c.execute(q)
                    cp_classify(stats, lock, res={"exceptions": rs.exceptions})
                else:
                    cp_classify(stats, lock, res=query_broker_http(url, q))
            except PinotClientError as e:
                cp_classify(stats, lock, exc=e)
            except Exception as e:  # noqa: BLE001 - every failure is an outcome the leg reports
                cp_classify(stats, lock, exc=e)
            mine.append((time.perf_counter() - t0) * 1e3)
        with lock:
            lat_ms.extend(mine)

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(n_clients)]
    for t in threads:
        t.start()
    barrier.wait(timeout=60)
    t_run = time.perf_counter()
    for t in threads:
        t.join(timeout=duration_s + 120)
    wall_s = time.perf_counter() - t_run
    outcomes = {k: stats[k] for k in ("ok", "typed_timeout", "typed_shed", "dropped", "untyped")}
    return {
        "queries": sum(outcomes.values()),
        "wall_s": wall_s,
        "outcomes": outcomes,
        "error_samples": stats["samples"],
        "p50_ms": float(np.percentile(lat_ms, 50)) if lat_ms else None,
        "p99_ms": float(np.percentile(lat_ms, 99)) if lat_ms else None,
    }


class CpLoad:
    """cp_drive on a thread of its own: `join()` returns its report, and
    raises if the leg dropped or left untyped any query, or served none."""

    def __init__(self, label: str, urls: list, n_clients: int, duration_s: float, conn: bool = False):
        self.label, self.out = label, {}
        self._t = threading.Thread(
            target=lambda: self.out.update(cp_drive(urls, n_clients, duration_s, conn)), daemon=True
        )
        self._t.start()
        self._timeout = duration_s + 180

    def join(self) -> dict:
        self._t.join(timeout=self._timeout)
        o = self.out.get("outcomes")
        if self._t.is_alive() or o is None:
            raise AssertionError(f"control_plane {self.label}: the load did not finish")
        if o["dropped"] or o["untyped"] or not o["ok"]:
            raise AssertionError(f"control_plane {self.label}: {self.out}")
        return self.out


def cp_leader(url: str, want: bool = True, timeout_s: float = 20.0) -> dict:
    """GET {url}/leader until its isLeader is `want`."""
    deadline = time.perf_counter() + timeout_s
    status: dict = {}
    while time.perf_counter() < deadline:
        try:
            status = http_json(f"{url}/leader", timeout=10)
            if bool(status.get("isLeader")) == want:
                return status
        except OSError:
            pass
        time.sleep(0.05)
    raise AssertionError(f"control_plane: the controller at {url} never reached isLeader={want}: {status}")


def cp_lead_of(urls: list, timeout_s: float = 30.0) -> int:
    """Index of the controller in `urls` that holds the lease."""
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        for i, u in enumerate(urls):
            try:
                if http_json(f"{u}/leader", timeout=10).get("isLeader"):
                    return i
            except OSError:
                pass
        time.sleep(0.05)
    raise AssertionError(f"control_plane: no controller of {urls} took the lease")


def cp_wait_count(b_url: str, expect: int, timeout_s: float) -> float:
    """Seconds until the cluster serves again: COUNT(*) answers `expect`,
    and then both queries answer with no exception 4 times in a row (the
    broker alternates the replicas, and a replica the reconciler has not
    loaded yet fails its part)."""
    from pinot_tpu_torch.cluster.http import query_broker_http

    t0 = time.perf_counter()
    last, clean = None, 0
    while time.perf_counter() - t0 < timeout_s:
        try:
            if last != expect:
                res = query_broker_http(b_url, f"SELECT COUNT(*) FROM {CP_TABLE}")
                if not res.get("exceptions"):
                    last = res["resultTable"]["rows"][0][0]
            else:
                res = query_broker_http(b_url, CP_QUERIES[clean % 2])
                clean = 0 if res.get("exceptions") else clean + 1
                if clean == 4:
                    return time.perf_counter() - t0
        except (OSError, RuntimeError) as e:
            last, clean = f"{type(e).__name__}: {e}"[:200], 0
        if clean == 0:
            time.sleep(0.1)
    raise AssertionError(f"control_plane: the cluster never served {expect} rows cleanly (last {last})")


def cp_log(msg: str, t0: float) -> None:
    """A progress line on standard error, seconds since the phase began."""
    print(f"control_plane {time.perf_counter() - t0:8.2f} s: {msg}", file=sys.stderr, flush=True)


def cp_quiesced(label: str, b_url: str, s_urls: list, want: list, walls: dict) -> dict:
    """Both queries with no load: rows equal the oracle, and the B1 launches
    summed from the server processes' registries just before and just after
    are CP_B1 (no other kernel launches)."""
    from pinot_tpu_torch.cluster.http import query_broker_http

    out = {}
    for i, (sql, rows_want, b1) in enumerate(zip(CP_QUERIES, want, CP_B1)):
        before = processes_calls(s_urls)
        t0 = time.perf_counter()
        res = query_broker_http(b_url, sql)
        walls.setdefault(i, []).append((time.perf_counter() - t0) * 1e3)
        launches = {k: v - before[k] for k, v in processes_calls(s_urls).items()}
        if res.get("exceptions"):
            raise AssertionError(f"control_plane {label} q{i}: {res['exceptions']}")
        rows_match(f"control_plane {label} q{i}", res["resultTable"]["rows"], rows_want)
        expect = {k: (b1 if k == "grouped_sum_count" else 0) for k in launches}
        if launches != expect:
            raise AssertionError(f"control_plane {label} q{i}: launches {launches}, expected {expect}")
        out[f"q{i}"] = launches["grouped_sum_count"]
    return out


def cp_flip_bit(path: str) -> None:
    """bench.py's corruption: one bit in the middle of a file."""
    import os

    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x20]))


def cp_post(url: str, doc) -> tuple:
    """POST a JSON body (or raw bytes); (status, decoded body)."""
    import urllib.error
    import urllib.request

    data = doc if isinstance(doc, bytes) else json.dumps(doc).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def cp_compat_suite() -> tuple:
    """A seeded compatibility suite over bench.py's schema (create, ingest
    3 batches, query with expected rows, delete a segment, reload,
    rebalance, query again) and the B1 launches its GROUP BYs make."""
    rng = np.random.default_rng(CP_SEED + 1)
    batches = []
    for _ in range(CP_COMPAT_BATCHES):
        region = np.array(CP_REGIONS)[rng.integers(0, 4, CP_COMPAT_ROWS)]
        year = rng.integers(1992, 1999, CP_COMPAT_ROWS)
        revenue = rng.integers(100, 600_000, CP_COMPAT_ROWS)
        batches.append([{"region": str(r), "year": int(y), "revenue": int(v)} for r, y, v in zip(region, year, revenue)])

    def grouped(rows):
        return [[r, float(sum(x["revenue"] for x in rows if x["region"] == r))] for r in CP_REGIONS]

    every = [x for b in batches for x in b]
    kept = [x for b in batches[1:] for x in b]
    sql = "SELECT region, SUM(revenue) FROM compat GROUP BY region ORDER BY region"
    suite = {"operations": [
        {"op": "createTable", "schema": {
            "schemaName": "compat",
            "fields": [{"name": "region", "dataType": "STRING", "fieldType": "DIMENSION"},
                       {"name": "year", "dataType": "INT", "fieldType": "DIMENSION"},
                       {"name": "revenue", "dataType": "LONG", "fieldType": "METRIC"}],
            "primaryKeyColumns": []},
         "config": {"tableName": "compat", "replication": 1}},
        *({"op": "ingestRows", "table": "compat", "rows": b} for b in batches),
        {"op": "query", "sql": "SELECT COUNT(*) FROM compat WHERE year > 1994",
         "expectedRows": [[sum(x["year"] > 1994 for x in every)]]},
        {"op": "query", "sql": sql, "expectedRows": grouped(every)},
        {"op": "deleteSegment", "table": "compat", "segment": "compat_compat_0"},
        {"op": "reloadSegments", "table": "compat"},
        {"op": "rebalance", "table": "compat"},
        {"op": "query", "sql": sql, "expectedRows": grouped(kept)},
    ]}
    return suite, CP_COMPAT_BATCHES + (CP_COMPAT_BATCHES - 1)


def run_compat(torch, counters: dict) -> dict:
    """The compatibility verifier's seeded suite in this process, its
    cluster's server and broker on the card: every op passes, the GROUP BYs
    launch B1 once a segment, and every kernel call is held against its
    plain version."""
    from pinot_tpu_torch.ops import extreme as ext
    from pinot_tpu_torch.ops import groupby as gb
    from pinot_tpu_torch.ops import grouped_sum_f32 as gs
    from pinot_tpu_torch.tools.compat_verifier import CompatVerifier

    suite, b1 = cp_compat_suite()
    v = CompatVerifier(device=DEVICE)
    try:
        t0 = time.perf_counter()
        results, launches, calls = counted_run(counters, lambda: v.run_suite(suite))
        seconds = time.perf_counter() - t0
    finally:
        v.close()
    if [r["status"] for r in results] != ["PASSED"] * len(suite["operations"]):
        raise AssertionError(f"control_plane compat: {results}")
    check_launches("control_plane compat", counters, launches, calls, (b1, 0, 0, 0))
    held = hold_all(torch, calls, gb, ext, gs)
    if any(h["max_abs_err"] != 0 for h in held):
        raise AssertionError(f"control_plane compat: a kernel disagrees with its plain version: {held}")
    return {"operations": len(results), "seconds": seconds, "launches": launches,
            "max_abs_err": max(h["max_abs_err"] for h in held), "held": len(held)}


def run_control_plane(torch, counters: dict) -> dict:
    """Phase 20: the control plane, bench.py `cluster`'s phases 2 and 7 and
    its HA legs (`_cluster_ha_phases`) on bench.py's topology: two HA
    controllers on one store dir (each with the periodic tasks: the metrics
    aggregator and the integrity scrubber run on whoever leads), servers on
    the card with local data dirs, two uncached brokers, every role a
    `tools.admin` process started with Role. The table: CP_SEGMENTS
    segments of CP_SEG_ROWS, replication 2, uploaded over REST. Legs under
    load (CP_CLIENTS clients for about CP_PHASE_S s each): a bootstrap
    rebalance onto a third server; a split brain (the lead's lease renewal
    frozen by the lease.renew fault: the standby takes over at a higher
    epoch, the frozen ex-leader's write is fenced with 503 / 270, and it
    steps down after the thaw); the lead SIGKILLed about 1 s into a
    rebalance onto a fourth server (the survivor leads at a higher epoch
    and COUNT(*) comes back); a bit flipped in one replica's local copy and
    in another segment's deep-store copy (both scrubbers repair, nothing is
    unrepairable, a .quarantined file is left); the lead's /debug/cluster
    and /debug/alerts; a broker SIGKILLed under client load; every process
    SIGKILLed and the cluster restarted cold. No leg may drop a query or
    leave one untyped. Quiesced answers before the legs and after the
    rebalance, the kill, the corruption and the restart equal the oracle,
    with their B1 launches exact (cp_quiesced). Then the compatibility
    suite in this process (run_compat). Returns the phase's launches: every
    B1 the server processes launched (their registries, read before each is
    killed) and the suite's."""
    import os
    import shutil as _shutil
    import tempfile

    from pinot_tpu_torch.cluster.http import RemoteControllerClient, query_broker_http
    from pinot_tpu_torch.common import DataType, Schema, TableConfig
    from pinot_tpu_torch.segment import SegmentBuilder, write_segment

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_cp_")
    store, deep = os.path.join(root, "store"), os.path.join(root, "deep")
    roles: dict = {}
    walls: dict = {}
    legs: dict = {}
    served = {k: 0 for k in KERNEL_OF_REGISTRY.values()}

    def controller(name: str, cold: bool = False) -> Role:
        args = ["StartController", "--store-dir", store, "--deep-store", deep, "--controller-id", name,
                *CP_CONTROLLER_ARGS, *(["--cold-start"] if cold else [])]
        roles[name] = Role(name, args)
        return roles[name]

    def server(sid: str, controllers: str) -> Role:
        roles[sid] = Role(sid, ["StartServer", "--controller-url", controllers, "--server-id", sid,
                                "--device", DEVICE, "--data-dir", os.path.join(root, "data", sid)])
        return roles[sid]

    def broker(bid: str, controllers: str) -> Role:
        roles[bid] = Role(bid, ["StartBroker", "--controller-url", controllers, "--broker-id", bid,
                                "--cache-json", '{"enabled": false}', "--device", DEVICE,
                                "--scatter-threads", "16"])
        return roles[bid]

    def server_urls() -> list:
        return [r.url for n, r in sorted(roles.items())
                if n.startswith("ha_s") and r.url is not None and r.proc.poll() is None]

    try:
        # -- wave 1: both controllers; whichever takes the lease first leads
        t0 = time.perf_counter()
        ctl = [controller("ha_c1"), controller("ha_c2")]
        c_urls = [c.wait() for c in ctl]
        lead_i = cp_lead_of(c_urls)
        lead0 = http_json(f"{c_urls[lead_i]}/leader")
        controllers = ",".join(c_urls)
        wave1_s = time.perf_counter() - t0
        cp_log(f"controllers up, {['ha_c1', 'ha_c2'][lead_i]} leads", t_phase)

        # -- wave 2: servers and brokers; the segments build meanwhile
        t0 = time.perf_counter()
        for sid in ("ha_s0", "ha_s1"):
            server(sid, controllers)
        for bid in ("ha_b0", "ha_b1"):
            broker(bid, controllers)
        parts = cp_data()
        want = cp_oracle(parts)
        total_rows = CP_SEGMENTS * CP_SEG_ROWS
        schema = Schema.build(CP_TABLE, dimensions=[("region", DataType.STRING), ("year", DataType.INT)],
                              metrics=[("revenue", DataType.LONG)])
        builder = SegmentBuilder(schema)
        seg_dirs = [write_segment(builder.build(p, f"{CP_TABLE}_{i}"), os.path.join(root, "built"))
                    for i, p in enumerate(parts)]
        del parts
        for n in ("ha_s0", "ha_s1", "ha_b0", "ha_b1"):
            roles[n].wait()
        wave2_s = time.perf_counter() - t0
        cp_log("servers and brokers up", t_phase)
        b_urls = [roles["ha_b0"].url, roles["ha_b1"].url]

        t0 = time.perf_counter()
        rc = RemoteControllerClient(controllers, timeout=600)
        rc.add_schema(schema)
        rc.add_table(TableConfig(CP_TABLE, replication=2))
        for d in seg_dirs:
            rc.upload_segment_dir(CP_TABLE, d)
        upload_s = time.perf_counter() - t0
        cp_log("uploaded", t_phase)
        ideal = rc.ideal_state(CP_TABLE)
        if len(ideal) != CP_SEGMENTS or any(len(r) != 2 for r in ideal.values()):
            raise AssertionError(f"control_plane: ideal state {ideal}")

        # ha_s2 starts while the first answers warm the servers up
        server("ha_s2", controllers)
        for _ in range(2):
            for url in b_urls:
                for q in CP_QUERIES:
                    query_broker_http(url, q)
        checks = {"before": cp_quiesced("before", b_urls[0], server_urls(), want, walls)}
        roles["ha_s2"].wait()
        cp_log("quiesced check before the legs; ha_s2 up", t_phase)

        # -- leg 1: a bootstrap rebalance onto ha_s2 under live load
        load = CpLoad("rebalance", b_urls, max(4, CP_CLIENTS // 2), CP_PHASE_S + 2.0)
        time.sleep(0.5)
        lead_i = cp_lead_of(c_urls)  # the lease may have moved under the upload's load
        t0 = time.perf_counter()
        reb = RemoteControllerClient(c_urls[lead_i]).rebalance_table(CP_TABLE, drain_grace_sec=0.15, bootstrap=True)
        reb_s = time.perf_counter() - t0
        server("ha_s3", controllers)  # leg 3's new server starts while the legs run
        legs["rebalance"] = {"status": reb["status"], "adds": len(reb["adds"]), "drops": len(reb["drops"]),
                             "seconds": reb_s, "driven": load.join()}
        if reb["status"] != "DONE" or not reb["adds"]:
            raise AssertionError(f"control_plane rebalance: {reb}")
        cp_log(f"leg 1: rebalance {reb['status']}, {len(reb['adds'])} adds", t_phase)
        checks["rebalance"] = cp_quiesced("rebalance", b_urls[0], server_urls(), want, walls)

        # -- leg 2: split brain
        lead_i = cp_lead_of(c_urls)
        lead_url, std_url = c_urls[lead_i], c_urls[1 - lead_i]
        before_freeze = http_json(f"{lead_url}/leader")
        load = CpLoad("split_brain", b_urls, max(4, CP_CLIENTS // 2), CP_PHASE_S + 2.0)
        status, _ = cp_post(f"{lead_url}/debug/faults",
                            {"points": {"lease.renew": {"mode": "error", "prob": 1.0}}, "seed": CP_SEED})
        if status != 200:
            raise AssertionError(f"control_plane split_brain: arming lease.renew answered {status}")
        t0 = time.perf_counter()
        takeover = cp_leader(std_url)
        takeover_s = time.perf_counter() - t0
        ghost = Schema.build("ghost", dimensions=[("g", DataType.STRING)], metrics=[])
        fenced_code, fenced_body = cp_post(f"{lead_url}/schemas", ghost.to_json().encode())
        ex_leader = http_json(f"{lead_url}/leader")
        cp_post(f"{lead_url}/debug/faults", {"points": {}})  # thaw
        t0 = time.perf_counter()
        demoted = cp_leader(lead_url, want=False)
        stepdown_s = time.perf_counter() - t0
        legs["split_brain"] = {
            "frozen": ["ha_c1", "ha_c2"][lead_i], "epoch_at_start": lead0["leaseEpoch"],
            "epoch_before": before_freeze["leaseEpoch"], "epoch_after": takeover["leaseEpoch"], "takeover_s": takeover_s,
            "fenced": [fenced_code, fenced_body.get("errorCode")], "fencedWrites": ex_leader.get("fencedWrites"),
            "stepdown_s": stepdown_s, "ex_leader_after_thaw": demoted["isLeader"], "driven": load.join(),
        }
        if fenced_code != 503 or fenced_body.get("errorCode") != 270:
            raise AssertionError(f"control_plane split_brain: the frozen ex-leader's write got {fenced_code} {fenced_body}")
        if not ex_leader.get("fencedWrites", 0) >= 1 or takeover["leaseEpoch"] <= before_freeze["leaseEpoch"]:
            raise AssertionError(f"control_plane split_brain: {legs['split_brain']}")

        cp_log("leg 2: split brain", t_phase)
        # -- leg 3: SIGKILL the lead (now the ex-standby) mid-rebalance onto ha_s3
        roles["ha_s3"].wait()
        killed = "ha_c1" if std_url == c_urls[0] else "ha_c2"
        load = CpLoad("controller_kill", b_urls, CP_CLIENTS, CP_PHASE_S + 4.0)
        time.sleep(0.5)
        reb_out: list = []

        def fire():
            try:
                RemoteControllerClient(std_url, max_attempts=1).rebalance_table(
                    CP_TABLE, drain_grace_sec=0.8, bootstrap=True)
                reb_out.append("completed before the kill")
            except Exception as e:  # noqa: BLE001 - the lead dies mid-call: the expected outcome
                reb_out.append(f"{type(e).__name__}: {e}"[:300])

        t_reb = threading.Thread(target=fire, daemon=True)
        t_reb.start()
        time.sleep(1.0)
        roles[killed].kill()
        t_kill = time.perf_counter()
        survivor = cp_leader(lead_url)
        failover_s = time.perf_counter() - t_kill
        t_reb.join(timeout=60)
        driven = load.join()
        recovery_s = cp_wait_count(b_urls[0], total_rows, 60.0)
        legs["controller_kill"] = {
            "victim": killed, "rebalance_call": reb_out[0] if reb_out else None, "survivor_epoch": survivor["leaseEpoch"],
            "takeovers": survivor["takeovers"], "takeover_s": failover_s, "recovery_to_full_count_s": recovery_s,
            "driven": driven,
        }
        if not survivor["isLeader"] or survivor["takeovers"] < 1 or survivor["leaseEpoch"] <= takeover["leaseEpoch"]:
            raise AssertionError(f"control_plane controller_kill: {legs['controller_kill']}")
        c_live = lead_url
        cp_log("leg 3: controller kill, recovered", t_phase)
        checks["controller_kill"] = cp_quiesced("controller_kill", b_urls[0], server_urls(), want, walls)

        # -- leg 4: a bit flipped in a local copy and in a deep-store copy
        ideal = rc.ideal_state(CP_TABLE)
        live = sorted(n for n in roles if n.startswith("ha_s"))
        hosts = {sid: sorted(s for s, reps in ideal.items() if sid in reps) for sid in live}
        corrupt_sid = next(sid for sid in live if hosts[sid])
        corrupt_seg = hosts[corrupt_sid][0]
        deep_seg = next(s for s in sorted(ideal) if s != corrupt_seg)
        local_file = os.path.join(root, "data", corrupt_sid, CP_TABLE, corrupt_seg, "segment.ptseg")
        deep_file = os.path.join(deep, CP_TABLE, deep_seg, "segment.ptseg")
        load = CpLoad("corruption", b_urls, CP_CLIENTS, CP_PHASE_S + 2.0)
        time.sleep(0.3)
        cp_flip_bit(local_file)
        cp_flip_bit(deep_file)
        t0 = time.perf_counter()
        heal: dict = {}
        while time.perf_counter() - t0 < 30.0:
            smetrics = http_json(f"{roles[corrupt_sid].url}/metrics?format=json")
            cmetrics = http_json(f"{c_live}/metrics?format=json")
            heal = {
                "serverRepaired": smetrics.get("storage.scrub.repaired", {}).get("count", 0),
                "deepRepaired": cmetrics.get("storage.scrub.repaired", {}).get("count", 0),
                "deepVerified": cmetrics.get("storage.scrub.verified", {}).get("count", 0),
                "unrepairable": cmetrics.get("storage.scrub.unrepairable", {}).get("count", 0)
                + smetrics.get("storage.scrub.unrepairable", {}).get("count", 0),
                "quarantined": http_json(f"{roles[corrupt_sid].url}/debug/storage")["quarantined"],
            }
            if heal["serverRepaired"] >= 1 and heal["deepRepaired"] >= 1:
                break
            time.sleep(0.2)
        heal_s = time.perf_counter() - t0
        legs["corruption"] = {"local": f"{corrupt_sid}:{corrupt_seg}", "deep_store": deep_seg, "heal": heal,
                              "heal_s": heal_s, "driven": load.join()}
        deep_quarantined = os.path.exists(deep_file + ".quarantined")
        if (heal["serverRepaired"] < 1 or heal["deepRepaired"] < 1 or heal["unrepairable"] != 0
                or not heal["quarantined"] or not deep_quarantined):
            raise AssertionError(f"control_plane corruption: {legs['corruption']}, deep quarantined {deep_quarantined}")
        cp_log("leg 4: corruption healed", t_phase)
        checks["corruption"] = cp_quiesced("corruption", b_urls[0], server_urls(), want, walls)

        # -- leg 5: the lead's /debug/cluster and /debug/alerts
        t0 = time.perf_counter()
        nodes_want = set(live) | {"ha_b0", "ha_b1"}
        while True:
            doc = http_json(f"{c_live}/debug/cluster")
            nodes = doc.get("nodes", {})
            if set(nodes) >= nodes_want and all(nodes[n]["healthy"] and not nodes[n]["stale"] for n in nodes_want):
                break
            if time.perf_counter() - t0 > 20.0:
                raise AssertionError(f"control_plane debug_cluster: nodes {nodes}")
            time.sleep(0.2)
        alerts = http_json(f"{c_live}/debug/alerts")
        roof = doc["cluster"]["roofline"]
        rebalance_doc = doc.get("rebalance", {}).get(CP_TABLE, {})
        legs["debug_cluster"] = {
            "nodes": {n: {"role": v["role"], "healthy": v["healthy"], "stale": v["stale"]} for n, v in nodes.items()},
            "rebalance": rebalance_doc, "controllerHa": doc.get("controllerHa"),
            "hbmPeakGBps": roof["hbmPeakGBps"],
            "roofline": [{k: r[k] for k in ("kernel", "shape", "calls", "deviceMs", "achievedGBps", "pctOfPeak")}
                         for r in roof["kernels"]],
            "alerts": alerts.get("alerts"), "slo_firing": (alerts.get("slo") or {}).get("firing"),
            "seconds": time.perf_counter() - t0,
        }
        if roof["hbmPeakGBps"] != 3350.0 or any(r["pctOfPeak"] > 100 for r in roof["kernels"]):
            raise AssertionError(f"control_plane debug_cluster roofline: {roof}")
        if rebalance_doc.get("status") != "DONE" or any(a.get("slo") == "scrubUnrepairable" for a in alerts.get("alerts") or []):
            raise AssertionError(f"control_plane debug_cluster: {legs['debug_cluster']}")

        cp_log("leg 5: /debug/cluster", t_phase)
        # -- leg 6: SIGKILL a broker under load through client Connections
        load = CpLoad("broker_kill", b_urls, CP_CLIENTS, CP_PHASE_S + 2.0, conn=True)
        time.sleep(max(0.5, CP_PHASE_S / 3))
        roles["ha_b1"].kill()
        legs["broker_kill"] = {"victim": "ha_b1", "driven": load.join()}

        cp_log("leg 6: broker kill", t_phase)
        # -- leg 7: SIGKILL every process, then a cold restart
        got_before = query_broker_http(b_urls[0], CP_QUERIES[1])["resultTable"]["rows"]
        epoch_before = http_json(f"{c_live}/leader")["leaseEpoch"]
        for k, v in processes_calls(server_urls()).items():
            served[k] += v
        start_first = {n: r.start_s for n, r in roles.items()}
        for r in roles.values():
            if r.proc.poll() is None:
                r.kill()
        t_restart = time.perf_counter()
        ctl = [controller("ha_c1", cold=True), controller("ha_c2")]
        c_urls = [c.wait() for c in ctl]
        controllers = ",".join(c_urls)
        wave3a_s = time.perf_counter() - t_restart
        cp_log("leg 7: every process killed; controllers up again", t_phase)
        for sid in live:
            server(sid, controllers)
        for bid in ("ha_b0", "ha_b1"):
            broker(bid, controllers)
        for n in live + ["ha_b0", "ha_b1"]:
            roles[n].wait()
        wave3b_s = time.perf_counter() - t_restart - wave3a_s
        cp_log("leg 7: servers and brokers up again", t_phase)
        lead_i = cp_lead_of(c_urls)
        new_lead = http_json(f"{c_urls[lead_i]}/leader")
        b_urls = [roles["ha_b0"].url, roles["ha_b1"].url]
        restart_recovery_s = cp_wait_count(b_urls[0], total_rows, 120.0)
        cp_log("leg 7: cluster serves again", t_phase)
        got_after = query_broker_http(b_urls[0], CP_QUERIES[1])["resultTable"]["rows"]
        legs["cold_restart"] = {
            "wave_controllers_s": wave3a_s, "wave_servers_brokers_s": wave3b_s,
            "recovery_to_full_count_s": restart_recovery_s, "to_full_count_s": time.perf_counter() - t_restart,
            "rows_identical": got_after == got_before, "epoch_before": epoch_before,
            "epoch_after": new_lead["leaseEpoch"], "lead": ["ha_c1", "ha_c2"][lead_i],
        }
        if got_after != got_before or new_lead["leaseEpoch"] <= epoch_before:
            raise AssertionError(f"control_plane cold_restart: {legs['cold_restart']}: {got_after} != {got_before}")
        checks["cold_restart"] = cp_quiesced("cold_restart", b_urls[0], server_urls(), want, walls)
        for k, v in processes_calls(server_urls()).items():
            served[k] += v
        start_s = {"first": start_first, "restart": {n: r.start_s for n, r in roles.items()}}
    finally:
        for r in roles.values():
            if r.proc.poll() is None:
                r.kill()
        _shutil.rmtree(root, ignore_errors=True)

    processes_s = time.perf_counter() - t_phase
    for fn in counters.values():
        fn.launches = 0
    compat = run_compat(torch, counters)
    cp_log("compatibility suite", t_phase)
    launches = {k: served[k] + compat["launches"][k] for k in served}
    emit(
        {
            "phase": "control_plane",
            "results_match_oracle": True,
            "table": {"segments": CP_SEGMENTS, "rows_a_segment": CP_SEG_ROWS, "replication": 2, "seed": CP_SEED},
            "load": {"clients": CP_CLIENTS, "phase_s": CP_PHASE_S},
            "start_s": start_s,
            "waves_s": {"controllers": wave1_s, "servers_brokers": wave2_s},
            "upload_s": upload_s,
            "legs": legs,
            "quiesced_b1": checks,
            "quiesced_p50_ms": {CP_QUERIES[i]: float(np.percentile(w, 50)) for i, w in walls.items()},
            "compat": compat,
            "launches": launches,
            "processes_s": processes_s,
            "seconds": time.perf_counter() - t_phase,
            "card": card_line(),
        }
    )
    return launches


# ---------------------------------------------------------------------------
# phase 21: batch ingestion and a minion rollup
# ---------------------------------------------------------------------------

#: bench.py's lineorder (make_ssb_data, its own seed) without the key
#: columns, in BM_FILES input files of BM_ROWS // BM_FILES rows: one segment
#: a file, as Pinot's batch jobs build them; users' segments hold 0.5-5M
#: rows, cut to 250,000 by the Python readers' rate and the phase's budget
BM_TABLE, BM_ROWS, BM_FILES, BM_SEED, BM_BUDGET_S = "lineorder_batch", 2_000_000, 8, 17, 60.0
BM_COLUMNS = ("d_year", "c_nation", "p_category", "lo_revenue", "lo_supplycost", "lo_quantity")
#: the files of each directory, by index: the standalone runner's 4 CSV, the
#: distributed runner's 2 CSV and 2 JSON-lines
BM_DIRS = {"standalone": ("csv", "csv", "csv", "csv"), "distributed": ("csv", "csv", "jsonl", "jsonl")}
BM_CONFIGS = ("1_count_filter", "2_filtered_agg", "3_q1_groupby", "4_q4_groupby_orderby")
BM_MERGE = {"minNumSegments": 2, "mergeType": "ROLLUP",
            "aggregates": {"lo_revenue": "SUM", "lo_supplycost": "MIN", "lo_quantity": "MAX"}}
BM_ROLLUP_SQL = (f"SELECT d_year, c_nation, SUM(lo_revenue), MIN(lo_supplycost), MAX(lo_quantity) FROM {BM_TABLE} "
                 "GROUP BY d_year, c_nation ORDER BY d_year, c_nation LIMIT 200")


def bm_write(data: dict, root: str) -> tuple[dict, dict]:
    """The input files under root/{standalone,distributed}: ({dir: path},
    {format: {"s", "rows"}})."""
    import os

    per = BM_ROWS // BM_FILES
    dirs, written, i = {}, {"csv": {"s": 0.0, "rows": 0}, "jsonl": {"s": 0.0, "rows": 0}}, 0
    for name, formats in BM_DIRS.items():
        dirs[name] = f"{root}/{name}"
        os.makedirs(dirs[name])
        for fmt in formats:
            t0 = time.perf_counter()
            rows = zip(*(data[c][i * per : (i + 1) * per].tolist() for c in BM_COLUMNS))
            if fmt == "csv":
                text = ",".join(BM_COLUMNS) + "\n" + "\n".join(",".join(map(str, r)) for r in rows) + "\n"
            else:
                text = "\n".join(json.dumps(dict(zip(BM_COLUMNS, r))) for r in rows) + "\n"
            with open(f"{dirs[name]}/part_{i}.{fmt}", "w") as f:
                f.write(text)
            written[fmt]["s"] += time.perf_counter() - t0
            written[fmt]["rows"] += per
            i += 1
    return dirs, written


def bm_rollup_oracle(data: dict) -> tuple[dict, list]:
    """The merged segment's columns (one row a (d_year, c_nation,
    p_category), in sorted order of the tuples: the strings sort as
    strings) and BM_ROLLUP_SQL's rows, from the raw arrays."""
    year, rev, cost, qty = data["d_year"], data["lo_revenue"], data["lo_supplycost"], data["lo_quantity"]
    nation = np.searchsorted(np.array(sorted(NATIONS)), data["c_nation"].astype(str))
    cats = np.array(sorted(CATEGORIES))
    cat = np.searchsorted(cats, data["p_category"].astype(str))
    key = (year.astype(np.int64) - 1992) * 625 + nation * 25 + cat
    order = np.argsort(key, kind="stable")
    k = key[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    g = k[starts]
    cols = {
        "d_year": (1992 + g // 625).astype(np.int32),
        "c_nation": np.array(sorted(NATIONS))[g // 25 % 25],
        "p_category": cats[g % 25],
        "lo_revenue": np.add.reduceat(rev[order], starts),
        "lo_supplycost": np.minimum.reduceat(cost[order], starts),
        "lo_quantity": np.maximum.reduceat(qty[order], starts),
    }
    yn = key // 25
    order = np.argsort(yn, kind="stable")
    k = yn[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    rows = [[1992 + int(y // 25), sorted(NATIONS)[int(y % 25)], float(s), float(c), float(q)]
            for y, s, c, q in zip(k[starts], np.add.reduceat(rev[order], starts),
                                  np.minimum.reduceat(cost[order], starts), np.maximum.reduceat(qty[order], starts))]
    return cols, rows


def bm_wait_task(url: str, task_type: str, timeout: float, tm) -> dict:
    """Poll GET /tasks until the task of `task_type` reads COMPLETED; raises
    if it FAILED or the time runs out."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        tasks = [t for t in http_json(f"{url}/tasks") if t["type"] == task_type]
        if tasks and tasks[-1]["state"] == "COMPLETED":
            return tasks[-1]
        if tasks and tasks[-1]["state"] == "FAILED":
            errors = [t.error for t in tm.tasks() if t.task_id == tasks[-1]["taskId"]]
            raise AssertionError(f"batch_minion: {task_type} failed: {errors}")
        time.sleep(0.05)
    raise AssertionError(f"batch_minion: {task_type} not COMPLETED after {timeout} s")


def run_batch_minion(torch, counters: dict) -> dict:
    """Phase 21: batch ingestion and a minion rollup on the card. BM_ROWS
    rows of make_ssb_data (seed BM_SEED, the six columns of
    ssb_schema(keys=False)) written as BM_FILES files (6 CSV, 2 JSON-lines)
    in two directories; one Controller behind a ControllerHTTPService with a
    PinotTaskManager, two Servers on the card and an uncached Broker.
    1. `admin ImportData` (the standalone runner, then the REST tarball
       push) loads the first directory, `admin
       LaunchDistributedDataIngestionJob` the second with 2 worker processes
       that tar-push over REST (none may load torch).
    2. Configs 1-4 over the 8 segments through the broker, each equal to the
       oracle, with its launches (8x a segment's, from the counters and the
       kernel registry) and every kernel call held against its plain
       version; BM_ROLLUP_SQL likewise (one B1 and one B3 a segment).
    3. The table's mergeRollup set to BM_MERGE, a minion from
       make_minion_with_builtins on a thread, `admin ScheduleTasks`, GET
       /tasks polled until the MergeRollupTask reads COMPLETED. The table
       then holds one segment of 7 x 25 x 25 = 4,375 rows whose columns
       equal the oracle's rollup in sorted order; BM_ROLLUP_SQL answers as
       before the merge with one B1 and one B3; COUNT(*) reads 4,375.
    4. `admin QuickStart` (its defaults, --dir in a temporary directory):
       its sample query equals numpy over its segments' columns.
    Returns the phase's launches (its counted queries')."""
    import os
    import tempfile

    from pinot_tpu_torch.cluster import Broker, Controller, PropertyStore, Server
    from pinot_tpu_torch.cluster.http import ControllerHTTPService
    from pinot_tpu_torch.common import TableConfig
    from pinot_tpu_torch.common.config import CacheConfig
    from pinot_tpu_torch.minion import PinotTaskManager
    from pinot_tpu_torch.minion.tasks import make_minion_with_builtins
    from pinot_tpu_torch.ops import extreme as ext
    from pinot_tpu_torch.ops import groupby as gb
    from pinot_tpu_torch.ops import grouped_sum_f32 as gs
    from pinot_tpu_torch.tools import admin

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_batch_")
    launches, held, walls = {}, {}, {}

    def counted(label, sql, expect):
        before = registry_calls()
        res, launches[label], calls = counted_run(counters, lambda: broker.execute(sql))
        check_launches(f"batch_minion {label}", counters, launches[label], calls, expect)
        registry = {k: v - before[k] for k, v in registry_calls().items()}
        if registry != launches[label]:
            raise AssertionError(f"batch_minion {label}: registry {registry} != counters {launches[label]}")
        held[label] = hold_all(torch, calls, gb, ext, gs)
        if any(h["max_abs_err"] != 0 for h in held[label]):
            raise AssertionError(f"batch_minion {label}: a kernel disagrees with its plain version: {held[label]}")
        return res

    def match(label, got, want):
        try:
            rows_match(label, got, want)
        except AssertionError as e:
            raise AssertionError(f"batch_minion {label}: {e}") from None

    data, nation, category = make_ssb_data(BM_ROWS, seed=BM_SEED)
    want, _ = oracle(data, nation, category)
    want_cols, want_rollup = bm_rollup_oracle(data)
    dirs, written = bm_write(data, root)

    controller = Controller(PropertyStore(), f"{root}/deep")
    servers = [Server(f"bm_s{i}", device=DEVICE) for i in range(2)]
    for s in servers:
        controller.register_server(s.server_id, s)
    controller.add_schema(ssb_schema(BM_TABLE, keys=False))
    controller.add_table(TableConfig(BM_TABLE))
    tm = PinotTaskManager(controller)
    svc = ControllerHTTPService(controller, task_manager=tm)
    url = f"http://127.0.0.1:{svc.port}"
    broker = Broker(controller, cache_config=CacheConfig(enabled=False), device=DEVICE)
    minion = None
    try:
        # -- 1. the two runners ----------------------------------------------
        jobs = {}
        for name, argv in (
            ("standalone", ["ImportData", "--segment-prefix", "bm_a"]),
            ("distributed", ["LaunchDistributedDataIngestionJob", "--segment-prefix", "bm_b", "--workers", "2"]),
        ):
            # the command's function, as admin.main runs it, for its per-file report
            args = admin.build_parser().parse_args(
                [*argv, "--controller-url", url, "--table", BM_TABLE, "--input-dir", dirs[name]])
            t0 = time.perf_counter()
            files = args.fn(args)["files"]
            job_s = time.perf_counter() - t0
            if [f["rows"] for f in files] != [BM_ROWS // BM_FILES] * 4:
                raise AssertionError(f"batch_minion {name}: files {files}")
            jobs[name] = {"job_s": job_s, "files": files}
        workers = jobs["distributed"]["files"]
        if any(f["torch"] for f in workers) or os.getpid() in {f["pid"] for f in workers}:
            raise AssertionError(f"batch_minion: a worker loaded torch or ran in this process: {workers}")
        segments = sorted(controller.ideal_state(BM_TABLE))
        if segments != [f"bm_{d}_{i}" for d in "ab" for i in range(4)]:
            raise AssertionError(f"batch_minion: segments {segments}")
        files = [f for j in jobs.values() for f in j["files"]]
        read = {fmt: sum(f["rows"] for f in files if f["file"].endswith(fmt)) /
                sum(f["read_s"] for f in files if f["file"].endswith(fmt)) for fmt in ("csv", "jsonl")}

        # -- 2. the queries over the batch-built segments --------------------
        for name in BM_CONFIGS:
            sql = rt_sql(CONFIGS[name], BM_TABLE)
            res = counted(name, sql, tuple(len(segments) * v for v in LAUNCHES_PER_SEGMENT[name]))
            match(name, res.rows, want[name])
            walls[name] = wall_p50_of(lambda: broker.execute(sql), warm=1, runs=WALL_RUNS)
        pre = counted("rollup_before_merge", BM_ROLLUP_SQL, (len(segments), len(segments), 0, 0))
        match("rollup_before_merge", pre.rows, want_rollup)

        # -- 3. the minion's merge and rollup --------------------------------
        tc = controller.get_table(BM_TABLE)
        tc.extra = {**(tc.extra or {}), "mergeRollup": BM_MERGE}
        controller.add_table(tc)
        minion = make_minion_with_builtins("bm_minion", tm, controller)
        minion.start(poll_interval=0.05)
        t0 = time.perf_counter()
        if admin.main(["ScheduleTasks", "--controller-url", url]) != 0:
            raise AssertionError("batch_minion: ScheduleTasks failed")
        task = bm_wait_task(url, "MergeRollupTask", 300.0, tm)
        merge_s = time.perf_counter() - t0
        [merged] = sorted(controller.ideal_state(BM_TABLE))
        seg = next(s.get_segment_object(BM_TABLE, merged) for s in servers if s.get_segment_object(BM_TABLE, merged))
        # a loaded segment's strings are objects; the numbers keep their dtype
        got = {c: seg.columns[c].materialize() for c in BM_COLUMNS}
        got.update({c: got[c].astype(str) for c in ("c_nation", "p_category")})
        wrong = [c for c in BM_COLUMNS if got[c].dtype != want_cols[c].dtype or not np.array_equal(got[c], want_cols[c])]
        if seg.n_docs != 7 * 25 * 25 or wrong:
            raise AssertionError(f"batch_minion: merged segment {merged} ({seg.n_docs} rows) differs from the oracle "
                                 f"in {[(c, got[c][:4], want_cols[c][:4]) for c in wrong]}")
        post = counted("rollup_after_merge", BM_ROLLUP_SQL, (1, 1, 0, 0))
        match("rollup_after_merge", post.rows, pre.rows)
        count = counted("count_after_merge", f"SELECT COUNT(*) FROM {BM_TABLE}", (0, 0, 0, 0))
        match("count_after_merge", count.rows, [[7 * 25 * 25]])
        walls["rollup_after_merge"] = wall_p50_of(lambda: broker.execute(BM_ROLLUP_SQL), warm=1, runs=WALL_RUNS)
    finally:
        if minion is not None:
            minion.stop()
        svc.stop()
        broker.shutdown()

    # -- 4. QuickStart ------------------------------------------------------
    t0 = time.perf_counter()
    argv = ["QuickStart", "--dir", f"{root}/quickstart", "--exit"] + ([] if DEVICE == "cuda" else ["--device", DEVICE])
    args = admin.build_parser().parse_args(argv)
    h = args.fn(args)
    try:
        league, runs = [], []
        for s in h["servers"].values():
            for name in s.segments_of("baseballStats"):
                qs_seg = s.get_segment_object("baseballStats", name)
                league.append(qs_seg.columns["league"].materialize())
                runs.append(qs_seg.columns["runs"].materialize())
        league, runs = np.concatenate(league), np.concatenate(runs)
        qs_want = sorted(([str(x), float(runs[league == x].sum())] for x in np.unique(league)), key=lambda r: -r[1])
        match("quickstart_sample", h["sample"].rows, qs_want)
    finally:
        for svc_ in h["services"]:
            svc_.stop()
        h["minion"].stop()
        h["broker"].shutdown()
    quickstart_s = time.perf_counter() - t0

    del controller, servers, broker, h
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    path_launches = {k: sum(v[k] for v in launches.values()) for k in counters}
    seconds = time.perf_counter() - t_phase
    emit(
        {
            "phase": "batch_minion",
            "results_match_oracle": True,
            "table": {"rows": BM_ROWS, "files": BM_FILES, "rows_a_file": BM_ROWS // BM_FILES, "seed": BM_SEED},
            "write_s": {fmt: w["s"] for fmt, w in written.items()},
            "write_rows_per_s": {fmt: w["rows"] / w["s"] for fmt, w in written.items()},
            "read_rows_per_s": read,
            "build_s_a_segment": {n: [f["build_s"] for f in j["files"]] for n, j in jobs.items()},
            "push_s_a_segment": {n: [f["push_s"] for f in j["files"]] for n, j in jobs.items()},
            "job_s": {n: j["job_s"] for n, j in jobs.items()},
            "workers": sorted({(f["pid"], f["torch"]) for f in workers}),
            "merge": {"s": merge_s, "task": task["taskId"], "segment": merged, "rows_in": BM_ROWS,
                      "rows_out": 7 * 25 * 25},
            "walls_p50_ms": {k: w["p50_ms"] for k, w in walls.items()},
            "quickstart_s": quickstart_s,
            "launches_per_query": launches,
            "launches": path_launches,
            "kernels_vs_plain": {k: len(v) for k, v in held.items()},
            "seconds": seconds,
            "budget_s": BM_BUDGET_S,
            "within_budget": seconds <= BM_BUDGET_S,
            "card": card_line(),
        }
    )
    return path_launches


# ---------------------------------------------------------------------------
# phase 22: the time-series engine, the DataFrame connector, the native host
# library and the kernel-cache observer
# ---------------------------------------------------------------------------

#: a dashboard's metrics table: TS_HOSTS hosts (dc = host % 4) reporting a
#: counter every TS_STEP_S seconds for TS_HOURS hours, in time order; a day
#: (8.64M rows) is cut to 6 h (2.16M) for the phase's budget. Segments of
#: TS_SEG_ROWS rows hold 90 minutes each
TS_TABLE, TS_HOSTS, TS_STEP_S, TS_HOURS, TS_SEED, TS_BUDGET_S = "metrics", 1000, 10, 6, 18, 60.0
TS_START = 1_750_003_200  # epoch seconds, on a whole hour
TS_POINTS = TS_HOURS * 3600 // TS_STEP_S
TS_SEG_POINTS = 540
#: the phase's GROUP BY over the connector-written segments: B1 (SUM, COUNT)
#: and B3 (MIN, MAX) once a segment, as config 5 plans; counters' order
TS_GROUPBY_SQL = f"SELECT dc, SUM(value), COUNT(*), MIN(value), MAX(value) FROM {TS_TABLE} GROUP BY dc"
TS_GROUPBY_LAUNCHES_PER_SEGMENT = (1, 1, 0, 0)
TS_USERS = {"reader": ("ops", "o"), "denied": ("guest", "g")}
#: the kernel wrappers' launch-plan caches with their observers:
#: (module, cached function, observer)
TS_OBSERVED = (("groupby", "_plan", "_PLAN_CACHE"), ("groupby", "_scratch_bytes", "_SCRATCH_CACHE"),
               ("extreme", "_plan", "_PLAN_CACHE"), ("extreme", "_spec", "_SPEC_CACHE"),
               ("grouped_sum_f32", "_plan", "_PLAN_CACHE"), ("grouped_sum_f32", "_spec", "_SPEC_CACHE"))


def ts_queries() -> dict:
    """The six time-series requests (shapes of the reference's own test
    corpus): name -> (language, query, start, end, step)."""
    end = TS_START + TS_HOURS * 3600
    m = f"fetch table={TS_TABLE} value=value time=ts"
    return {
        "1_sum_by_dc": ("m3ql", f"{m} agg=sum groupBy=dc", TS_START, end, 60),
        "2_regroup_rate": ("m3ql", f"{m} agg=sum groupBy=host,dc | groupBy dc | rate", TS_START, end, 300),
        "3_topk_last_hour": ("m3ql", f"{m} agg=max groupBy=host filter=\"dc = 'dc1'\" | topk 5", end - 3600, end, 60),
        "4_integral": ("m3ql", f"{m} agg=sum | sum | transformNull 0 | integral", TS_START, end, 300),
        "5_promql_sum_by_dc": ("promql", f"sum by (dc) ({TS_TABLE}:value)", TS_START, end, 60),
        "6_promql_delta": ("promql", f'clamp_min(delta(sum({TS_TABLE}:value{{dc="dc1"}})), 0)', TS_START, end, 300),
    }


def ts_data(hosts: int = TS_HOSTS, seed: int = TS_SEED) -> dict:
    """The metrics table in time order: row t * hosts + h is host h's point
    at TS_START + t * TS_STEP_S; each host's value is a running sum of
    integer increments 0-1,000 (under 2^31 over 6 h)."""
    rng = np.random.default_rng(seed)
    h = np.tile(np.arange(hosts), TS_POINTS)
    names = np.array([f"h{i:04d}" for i in range(hosts)], dtype=object)
    return {
        "host": names[h],
        "dc": np.array([f"dc{i}" for i in range(4)], dtype=object)[h % 4],
        "value": np.cumsum(rng.integers(0, 1001, (TS_POINTS, hosts)), axis=0).reshape(-1).astype(np.int64),
        "ts": TS_START + np.repeat(np.arange(TS_POINTS, dtype=np.int64) * TS_STEP_S, hosts),
        "_host_id": h,
    }


def ts_schema():
    from pinot_tpu_torch.common import DataType, Schema

    return Schema.build(TS_TABLE, dimensions=[("host", DataType.STRING), ("dc", DataType.STRING)],
                        metrics=[("value", DataType.LONG)], date_times=[("ts", DataType.LONG)])


def ts_bucket_sums(data: dict, mask, start: int, end: int, step: int, by=None):
    """{tag: float64 sums a bucket, NaN where no row} over rows of `mask`
    in [start, end): the leaf's SUM, exact (every sum is under 2^53)."""
    n = -(-(end - start) // step)
    keep = mask & (data["ts"] >= start) & (data["ts"] < end)
    b = (data["ts"][keep] - start) // step
    tags = np.zeros(int(keep.sum()), dtype=np.int64) if by is None else by[keep]
    out = {}
    vals = data["value"][keep]
    for t in np.unique(tags):
        sel = tags == t
        sums = np.zeros(n, dtype=np.int64)
        np.add.at(sums, b[sel], vals[sel])
        out[int(t)] = np.where(np.bincount(b[sel], minlength=n) > 0, sums.astype(np.float64), np.nan)
    return out


def ts_body(start: int, end: int, step: int, tag_names: list, series: dict) -> dict:
    """The JSON body TimeSeriesBlock.to_dict gives for these series."""
    n = max(1, -(-(end - start) // step))
    return {
        "timeBuckets": (start + step * np.arange(n, dtype=np.float64)).tolist(),
        "tagNames": tag_names,
        "series": [{"tags": dict(zip(tag_names, k)), "values": [None if np.isnan(v) else float(v) for v in vals]}
                   for k, vals in sorted(series.items())],
    }


def ts_oracle(data: dict, queries: dict) -> dict:
    """Bodies of queries 1, 5 and 6 from the raw arrays."""
    out = {}
    dc = data["_host_id"] % 4
    everything = np.ones(len(dc), dtype=bool)
    for name in ("1_sum_by_dc", "5_promql_sum_by_dc"):
        _, _, start, end, step = queries[name]
        sums = ts_bucket_sums(data, everything, start, end, step, by=dc)
        out[name] = ts_body(start, end, step, ["dc"], {(f"dc{k}",): v for k, v in sums.items()})
    _, _, start, end, step = queries["6_promql_delta"]
    [v] = ts_bucket_sums(data, dc == 1, start, end, step).values()
    # delta is rate (diff / step) scaled back by the step, then clamp_min 0
    v = np.maximum(np.concatenate(([np.nan], np.diff(v) / float(step))) * float(step), 0.0)
    out["6_promql_delta"] = ts_body(start, end, step, [], {(): v})
    return out


def ts_post(url: str, body: dict, user=None) -> tuple:
    """POST /timeseries/api/v1/query_range with Basic auth: (status, raw
    body)."""
    import base64
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"{url}/timeseries/api/v1/query_range", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    if user is not None:
        req.add_header("Authorization", "Basic " + base64.b64encode(":".join(user).encode()).decode())
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class LookupCounter:
    """Stands in for a cached function's module name while the phase runs:
    counts its lookups, the distinct argument tuples and those whose lookup
    missed (a lock makes each lookup's miss its own)."""

    def __init__(self, fn):
        self.fn, self.lookups, self.keys, self.missed = fn, 0, set(), set()
        self.lock = threading.Lock()

    def __call__(self, *args):
        with self.lock:
            before = self.fn.cache_info().misses
            out = self.fn(*args)
            self.lookups += 1
            self.keys.add(args)
            if self.fn.cache_info().misses > before:
                self.missed.add(args)
        return out


def cache_meters(label: str) -> dict:
    from pinot_tpu_torch.common.metrics import server_metrics

    reg = server_metrics()
    out = {k: reg.meter(f"engine.kernelCache.{k}", cache=label).count for k in ("hits", "misses", "evictions")}
    out["size"] = reg.gauge("engine.kernelCache.size", cache=label).value
    return out


def ts_native(data: dict) -> dict:
    """Each function of the native host library on this table's arrays,
    its result held bit for bit against the module's numpy fallback (taken
    by setting `_STATE` to no library); ms of each."""
    from pinot_tpu_torch import native

    if not native.available():
        raise AssertionError("timeseries_connector: the native library did not build (g++)")
    n = len(data["ts"])
    a = data["_host_id"] % 4 == 1
    b = data["ts"] >= TS_START + (TS_POINTS * 3 // 4) * TS_STEP_S
    hid = data["_host_id"].astype(np.int64)
    names = [f"h{i:04d}".encode() for i in range(int(hid.max()) + 1)]
    blob = b"".join(names)
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in names])]).astype(np.int64)
    bucket = ((data["ts"] - TS_START) // 60).astype(np.uint64)
    v = data["value"].astype(np.float64)
    ngh = len(names)

    def hll():
        # dc1's registers merged into the last 90 minutes', then the estimate
        regs, acc = np.zeros(1 << 12, dtype=np.uint8), np.zeros(1 << 12, dtype=np.uint8)
        native.hll_update(state["h64"], a, 12, regs)
        native.hll_update(state["h64"], b, 12, acc)
        native.hll_merge(regs, acc)
        return regs, acc, native.hll_estimate(acc, 12)

    state = {}
    steps = {
        "bm_from_bool": lambda: (native.bm_from_bool(a), native.bm_from_bool(b)),
        "bm_and_or_andnot_not": lambda: (native.bm_and(state["ab"][0], state["ab"][1]),
                                         native.bm_or(state["ab"][0], state["ab"][1]),
                                         native.bm_andnot(state["ab"][0], state["ab"][1]), native.bm_not(state["ab"][0])),
        "bm_cardinality": lambda: native.bm_cardinality(state["ab"][0]),
        "bm_extract": lambda: native.bm_extract(state["ab"][0]),
        "bm_from_indices": lambda: native.bm_from_indices(np.flatnonzero(b).astype(np.int32), n),
        "bm_to_bool": lambda: native.bm_to_bool(state["ab"][1], n),
        "hash64": lambda: native.hash64(hid),
        "hash_bytes": lambda: native.hash_bytes(blob, offsets),
        "hash_group_ids": lambda: native.hash_group_ids(native.hash64((state["hb"][hid] ^ bucket).view(np.int64))),
        "hll_update_merge_estimate": hll,
        "masked_stats": lambda: native.masked_stats(v, a),
        "group_sum": lambda: native.group_sum(v, hid, a, ngh),
        "group_count": lambda: native.group_count(hid, a, ngh),
        "group_min": lambda: native.group_min(v, hid, a, ngh),
        "group_max": lambda: native.group_max(v, hid, a, ngh),
    }
    out = {}
    lib_state = native._STATE
    for name, fn in steps.items():
        t0 = time.perf_counter()
        got = fn()
        lib_ms = (time.perf_counter() - t0) * 1e3
        native._STATE = [None, True]
        try:
            t0 = time.perf_counter()
            want = fn()
            fallback_ms = (time.perf_counter() - t0) * 1e3
        finally:
            native._STATE = lib_state
        if not ts_same(got, want):
            raise AssertionError(f"timeseries_connector: native {name} differs from its numpy fallback")
        if name == "bm_from_bool":
            state["ab"] = got
        elif name == "hash64":
            state["h64"] = got
        elif name == "hash_bytes":
            state["hb"] = got
        out[name] = {"ms": lib_ms, "fallback_ms": fallback_ms}
    gid, ng = steps["hash_group_ids"]()
    if ng != ngh * -(-TS_POINTS * TS_STEP_S // 60) or native.bm_cardinality(state["ab"][0]) != int(a.sum()):
        raise AssertionError(f"timeseries_connector: hash_group_ids found {ng} groups")
    return out


def ts_same(a, b) -> bool:
    """Bit-equal results: arrays by dtype and bytes, floats by bits."""
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(ts_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float):
        return isinstance(b, float) and np.float64(a).tobytes() == np.float64(b).tobytes()
    return type(a) is type(b) and a == b


def run_timeseries_connector(torch, counters: dict) -> dict:
    """Phase 22: the time-series engine, the DataFrame connector, the native
    host library and the kernel-cache observer on the card. The metrics
    table (ts_data: TS_HOSTS hosts x 6 h at 10 s, seed 18) written by
    connectors.write_table through a RemoteControllerClient into an
    in-process Controller behind ControllerHTTPService, with two Servers on
    the card behind ServerHTTPService and a Basic-auth Broker behind
    BrokerHTTPService (one principal reads `metrics`, one may not).
    1. The connector: write_table makes 4 segments of 90 minutes;
       read_table (the deep store) returns every row equal to the generated
       arrays; with `where` (dc1, the last 90 minutes) it filters 1 of the 4
       segments (3 pruned) and equals the numpy mask's rows;
       read_table_via_servers (HTTP, on the card) the same rows as a
       multiset.
    2. TS_GROUPBY_SQL through the broker: rows equal to the oracle, one B1
       and one B3 a segment (counters and registry), every kernel call held
       against its plain version.
    3. The six ts_queries through POST /timeseries/api/v1/query_range: each
       body equal to the in-process TimeSeriesEngine(Broker) over the same
       servers, 1, 5 and 6 equal to the numpy oracle; every leaf segment on
       the servers' host executor and no kernel launch; the denied
       principal's query 1 answers 403.
    4. The native host library: available, every function bit-equal to its
       fallback on the table's arrays.
    5. The kernel-cache observer: over the phase, each observed cache's
       misses are its distinct shapes newly planned, its hits + misses its
       lookups, its size at most 256.
    Returns the phase's launches."""
    import tempfile

    from pinot_tpu_torch import connectors
    from pinot_tpu_torch.cluster import Broker, Controller, PropertyStore, Server
    from pinot_tpu_torch.cluster.access import BasicAuthAccessControl, Principal
    from pinot_tpu_torch.cluster.http import (BrokerHTTPService, ControllerHTTPService, RemoteControllerClient,
                                              ServerHTTPService)
    from pinot_tpu_torch.common import TableConfig
    from pinot_tpu_torch.common.config import CacheConfig
    from pinot_tpu_torch.ops import extreme as ext
    from pinot_tpu_torch.ops import groupby as gb
    from pinot_tpu_torch.ops import grouped_sum_f32 as gs
    from pinot_tpu_torch.query import host_exec
    from pinot_tpu_torch.timeseries import RangeTimeSeriesRequest, TimeSeriesEngine

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_ts_")
    hosts = TS_HOSTS
    seg_rows = hosts * TS_SEG_POINTS
    n_segments = TS_POINTS // TS_SEG_POINTS
    data = ts_data(hosts)
    columns = {c: data[c] for c in ("host", "dc", "value", "ts")}
    n_rows = len(data["ts"])
    queries = ts_queries()

    # the kernel-cache observer: fold what earlier phases left, then count
    # every lookup of the phase
    mods = {"groupby": gb, "extreme": ext, "grouped_sum_f32": gs}
    observed = {}
    for mod, fn_name, obs_name in TS_OBSERVED:
        m, obs = mods[mod], getattr(mods[mod], obs_name)
        obs.observe()
        real = getattr(m, fn_name)
        observed[obs._label] = {"module": m, "name": fn_name, "real": real, "obs": obs, "before": cache_meters(obs._label),
                                "info": real.cache_info(), "counter": LookupCounter(real)}
        setattr(m, fn_name, observed[obs._label]["counter"])

    controller = Controller(PropertyStore(), f"{root}/deep")
    servers, svcs = [], []
    for i in range(2):
        s = Server(f"ts_s{i}", device=DEVICE)
        svc = ServerHTTPService(s)
        controller.register_server(s.server_id, s, host="127.0.0.1", port=svc.port)
        servers.append(s)
        svcs.append(svc)
    controller.add_schema(ts_schema())
    controller.add_table(TableConfig(TS_TABLE))
    csvc = ControllerHTTPService(controller)
    rc = RemoteControllerClient(f"http://127.0.0.1:{csvc.port}")
    ac = BasicAuthAccessControl(principals=[Principal(*TS_USERS["reader"], tables=(TS_TABLE,), permissions=("READ",)),
                                            Principal(*TS_USERS["denied"], tables=("other",), permissions=("READ",))])
    broker = Broker(controller, access_control=ac, cache_config=CacheConfig(enabled=False), device=DEVICE)
    plain_broker = Broker(controller, cache_config=CacheConfig(enabled=False), device=DEVICE)
    bsvc = BrokerHTTPService(broker)
    url = f"http://127.0.0.1:{bsvc.port}"
    launches, held = {}, {}
    try:
        # -- 1. the connector ------------------------------------------------
        uploads = []
        real_upload = rc.upload_segment

        def timed_upload(table, seg):
            t0 = time.perf_counter()
            out = real_upload(table, seg)
            uploads.append(time.perf_counter() - t0)
            return out

        rc.upload_segment = timed_upload
        t0 = time.perf_counter()
        names = connectors.write_table(rc, TS_TABLE, columns, rows_per_segment=seg_rows)
        write_s = time.perf_counter() - t0
        if names != [f"{TS_TABLE}_df_{i}" for i in range(n_segments)] or sorted(controller.ideal_state(TS_TABLE)) != names:
            raise AssertionError(f"timeseries_connector: write_table pushed {names}")
        t0 = time.perf_counter()
        got = connectors.read_table(rc, TS_TABLE)
        read_s = time.perf_counter() - t0
        bad = [c for c in columns if list(got) != list(columns) or got[c].dtype.kind != columns[c].dtype.kind
               or not np.array_equal(got[c], columns[c])]
        if bad:
            raise AssertionError(f"timeseries_connector: read_table differs from the data in {bad}")
        del got
        cut = TS_START + (TS_POINTS * 3 // 4) * TS_STEP_S
        where = f"dc = 'dc1' AND ts >= {cut}"
        want_mask = (data["_host_id"] % 4 == 1) & (data["ts"] >= cut)
        scanned = []
        real_mask = host_exec.filter_mask

        def counted_mask(seg, f):
            scanned.append(seg.name)
            return real_mask(seg, f)

        host_exec.filter_mask = counted_mask
        try:
            t0 = time.perf_counter()
            got = connectors.read_table(rc, TS_TABLE, where=where)
            pushdown_s = time.perf_counter() - t0
        finally:
            host_exec.filter_mask = real_mask
        # filter_mask recurses into the AND's children: count segments
        scanned = sorted(set(scanned))
        if scanned != [names[-1]] or any(not np.array_equal(got[c], columns[c][want_mask]) for c in columns):
            raise AssertionError(f"timeseries_connector: pushdown scanned {scanned}, rows {len(got['ts'])}")
        modes0 = [dict(s._engine(TS_TABLE).segment_modes) for s in servers]
        t0 = time.perf_counter()
        got = connectors.read_table_via_servers(rc, TS_TABLE, columns=["host", "ts", "value"], where=where)
        servers_s = time.perf_counter() - t0
        # the streamed path counts the segments it executes (a pruned one
        # yields nothing): each server's engine modes other than "pruned"
        server_run = sum(v - m.get(k, 0) for s, m in zip(servers, modes0)
                         for k, v in s._engine(TS_TABLE).segment_modes.items() if k != "pruned")
        key = np.array(got["host"].tolist(), dtype=object).astype(str), np.array(got["ts"].tolist(), dtype=np.int64)
        order = np.lexsort((key[1], key[0]))
        w_order = np.lexsort((columns["ts"][want_mask], columns["host"][want_mask].astype(str)))
        if (len(order) != int(want_mask.sum())
                or not np.array_equal(key[0][order], columns["host"][want_mask].astype(str)[w_order])
                or not np.array_equal(key[1][order], columns["ts"][want_mask][w_order])
                or not np.array_equal(np.array(got["value"].tolist(), dtype=np.int64)[order],
                                      columns["value"][want_mask][w_order])
                or server_run != 1):
            raise AssertionError(f"timeseries_connector: read_table_via_servers rows differ from the mask's "
                                 f"({len(order)} rows, {server_run} segments run)")
        del got, key
        connector = {
            "write_s": write_s, "write_rows_per_s": n_rows / write_s, "upload_s_a_segment": uploads,
            "read_s": read_s, "read_rows_per_s": n_rows / read_s,
            "pushdown": {"where": where, "s": pushdown_s, "rows": int(want_mask.sum()),
                         "rows_per_s": int(want_mask.sum()) / pushdown_s,
                         "segments_scanned": len(scanned), "segments_pruned": n_segments - len(scanned)},
            "via_servers": {"s": servers_s, "rows_per_s": int(want_mask.sum()) / servers_s,
                            "segments_run_on_servers": server_run, "segments_pruned_on_servers": n_segments - server_run},
        }

        # -- 2. the kernels over the written segments ------------------------
        for fn in counters.values():
            fn.launches = 0
        before = registry_calls()
        (status, resp), launches["groupby_dc"], calls = counted_run(
            counters, lambda: auth_post(url, TS_GROUPBY_SQL, *TS_USERS["reader"]))
        check_launches("timeseries_connector groupby_dc", counters, launches["groupby_dc"], calls,
                       tuple(n_segments * v for v in TS_GROUPBY_LAUNCHES_PER_SEGMENT))
        registry = {k: v - before[k] for k, v in registry_calls().items()}
        if registry != launches["groupby_dc"]:
            raise AssertionError(f"timeseries_connector: registry {registry} != counters {launches['groupby_dc']}")
        held["groupby_dc"] = hold_all(torch, calls, gb, ext, gs)
        del calls
        if any(h["max_abs_err"] != 0 for h in held["groupby_dc"]):
            raise AssertionError(f"timeseries_connector: a kernel disagrees with its plain version: {held}")
        dc = data["_host_id"] % 4
        want_rows = [[f"dc{k}", float(columns["value"][dc == k].sum()), int((dc == k).sum()),
                      float(columns["value"][dc == k].min()), float(columns["value"][dc == k].max())] for k in range(4)]
        if status != 200 or resp.get("exceptions"):
            raise AssertionError(f"timeseries_connector groupby_dc: {status} {resp}")
        rows_match("timeseries_connector groupby_dc", sorted(resp["resultTable"]["rows"]), want_rows)
        groupby_wall = wall_p50_of(lambda: auth_post(url, TS_GROUPBY_SQL, *TS_USERS["reader"]), warm=0)

        # -- 3. the time-series endpoint -------------------------------------
        oracle_bodies = ts_oracle(data, queries)
        leaves = []

        class LeafSpy:
            def execute(self, sql):
                res = plain_broker.execute(sql)
                leaves.append({"sql": sql, "rows": len(res.rows), "segments_queried": res.num_segments_queried,
                               "segments_pruned": res.num_segments_pruned})
                return res

        per_query = {}
        for name, (lang, q, start, end, step) in queries.items():
            body = {"query": q, "start": start, "end": end, "step": step, "language": lang}
            modes0 = [dict(s._engine(TS_TABLE).segment_modes) for s in servers]
            counts0 = {k: fn.launches for k, fn in counters.items()}
            leaves.clear()
            want = TimeSeriesEngine(LeafSpy()).execute_dict(RangeTimeSeriesRequest(q, start, end, step, lang))
            statuses, walls_ms, raw = [], [], None
            for _ in range(WALL_RUNS):
                t0 = time.perf_counter()
                st, raw = ts_post(url, body, TS_USERS["reader"])
                walls_ms.append((time.perf_counter() - t0) * 1e3)
                statuses.append(st)
            got = json.loads(raw)
            d_modes = {}
            for s, m in zip(servers, modes0):
                for k, v in s._engine(TS_TABLE).segment_modes.items():
                    d_modes[k] = d_modes.get(k, 0) + v - m.get(k, 0)
            d_launch = {k: fn.launches - counts0[k] for k, fn in counters.items()}
            [leaf] = leaves
            runs = WALL_RUNS + 1
            if statuses != [200] * WALL_RUNS or got != want:
                raise AssertionError(f"timeseries_connector {name}: {statuses}, body differs from the in-process engine")
            if name in oracle_bodies and got != oracle_bodies[name]:
                raise AssertionError(f"timeseries_connector {name}: body differs from the numpy oracle")
            if (any(d_launch.values()) or d_modes.get("device", 0) != 0
                    or d_modes.get("host", 0) != runs * leaf["segments_queried"] or leaf["segments_queried"] < 1):
                raise AssertionError(f"timeseries_connector {name}: leaf launches {d_launch}, servers' executors "
                                     f"{d_modes} for {runs} runs of {leaf}")
            n_series, n_buckets = len(got["series"]), len(got["timeBuckets"])
            if n_series * n_buckets > 1_000_000 or not n_series:
                raise AssertionError(f"timeseries_connector {name}: {n_series} series x {n_buckets} buckets")
            per_query[name] = {"language": lang, "step": step, "series": n_series, "buckets": n_buckets,
                               "leaf_rows": leaf["rows"], "leaf_segments": leaf["segments_queried"],
                               "segments_pruned": leaf["segments_pruned"], "servers_executors": d_modes,
                               "launches": d_launch, "p50_ms": float(np.median(walls_ms)), "runs_ms": walls_ms,
                               "matches_oracle": name in oracle_bodies}
        if per_query["3_topk_last_hour"]["leaf_segments"] != 1:
            raise AssertionError(f"timeseries_connector: the last hour read {per_query['3_topk_last_hour']}")
        _, q1, start, end, step = queries["1_sum_by_dc"]
        denied_status, denied_raw = ts_post(url, {"query": q1, "start": start, "end": end, "step": step},
                                            TS_USERS["denied"])
        if denied_status != 403 or "denied" not in json.loads(denied_raw)["exceptions"][0]["message"]:
            raise AssertionError(f"timeseries_connector: the denied principal got {denied_status} {denied_raw[:200]}")
    finally:
        for label, o in observed.items():
            setattr(o["module"], o["name"], o["real"])
        for svc in (bsvc, csvc, *svcs):
            svc.stop()
        broker.shutdown()
        plain_broker.shutdown()

    # -- 4. the native host library -------------------------------------------
    native_ms = ts_native(data)

    # -- 5. the kernel-cache observer -----------------------------------------
    cache = {}
    for label, o in observed.items():
        o["obs"].observe()
        after, info, counter = cache_meters(label), o["real"].cache_info(), o["counter"]
        d = {k: after[k] - o["before"][k] for k in ("hits", "misses", "evictions")}
        cache[label] = {"lookups": counter.lookups, "distinct_shapes": len(counter.keys),
                        "new_shapes": len(counter.missed), **d, "size": after["size"], "maxsize": info.maxsize}
        if (d["misses"] != len(counter.missed) or d["misses"] != info.misses - o["info"].misses
                or d["hits"] + d["misses"] != counter.lookups or after["size"] != info.currsize
                or info.currsize > 256):
            raise AssertionError(f"timeseries_connector: cache observer {label}: {cache[label]}, {info}")
    if not cache["grouped_sum_count._plan"]["lookups"] or not cache["grouped_extreme._spec"]["lookups"]:
        raise AssertionError(f"timeseries_connector: the GROUP BY made no plan lookup: {cache}")

    del controller, servers, broker, plain_broker, data, columns
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    path_launches = {k: sum(v[k] for v in launches.values()) for k in counters}
    seconds = time.perf_counter() - t_phase
    emit(
        {
            "phase": "timeseries_connector",
            "results_match_oracle": True,
            "table": {"rows": n_rows, "hosts": hosts, "step_s": TS_STEP_S, "hours": TS_HOURS, "seed": TS_SEED,
                      "segments": n_segments, "rows_a_segment": seg_rows},
            "connector": connector,
            "groupby": {"sql": TS_GROUPBY_SQL, "launches": launches["groupby_dc"], "kernels_vs_plain": held["groupby_dc"],
                        "p50_ms": groupby_wall["p50_ms"], "runs_ms": groupby_wall["runs_ms"]},
            "timeseries": per_query,
            "denied": {"status": denied_status},
            "native": native_ms,
            "kernel_cache": cache,
            "launches": path_launches,
            "seconds": seconds,
            "budget_s": TS_BUDGET_S,
            "within_budget": seconds <= TS_BUDGET_S,
            "card": card_line(),
        }
    )
    return path_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from pinot_tpu_torch.common.kernel_obs import KERNELS
    from pinot_tpu_torch.ops import build
    from pinot_tpu_torch.ops import extreme as ext
    from pinot_tpu_torch.ops import groupby as gb
    from pinot_tpu_torch.ops import grouped_sum_f32 as gs

    card = card_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    emit(
        {
            "phase": "card",
            "name": name,
            "count": torch.cuda.device_count(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
        }
    )
    report = build.build(list(build.KERNEL_SOURCES))
    emit({"phase": "build", "nvcc": build.nvcc_path(), "flags": list(build.NVCC_FLAGS), "report": report})

    ssb = {**ssb_shapes(torch), **mv_shapes(torch)}
    # the kernel phases time the kernels alone, without the registry's events
    # and mask counts; it records from the main path on (run_main_path)
    KERNELS.configure(enabled=False)
    timing = {
        "grouped_sum_count": check_kernels(torch, gb, ssb),
        "grouped_sum_count_2l": check_two_level(torch, gb, ssb),
        "grouped_extreme": check_extreme(torch, ext, ssb),
        "grouped_sum_f32": check_sum_f32(torch, gs),
    }
    counters = {
        "grouped_sum_count": gb.grouped_multi_sum,
        "grouped_extreme": ext.grouped_extremes,
        "presence": gs.presence,
        "grouped_sum_count_2l": gb.grouped_multi_sum_2l,
    }
    main = run_main_path(torch, counters)
    data, engine, want, nation = main.pop("data"), main.pop("engine"), main.pop("want"), main.pop("nation")
    sharded_launches, one_slot = run_sharded(torch, counters, data, want, engine)
    mesh_launches = run_mesh(torch, counters, data, want, one_slot)
    del one_slot
    run_store(torch, engine, main.pop("segments"), main.pop("tp_segments"), data)
    del engine
    cluster_launches, cluster = run_cluster(torch, counters, data, want, nation)
    http_launches, http_p50 = run_cluster_http(torch, counters, cluster, want, data, nation)
    cluster["broker"].shutdown()
    deep, want6 = cluster["deep"], cluster["want6"]
    del cluster, data, nation
    # the roles' five CUDA contexts share the card with this process: free
    # the in-process cluster's staged segments first
    gc.collect()
    torch.cuda.empty_cache()
    process_launches = run_processes(torch, deep, want, want6, http_p50)
    shutil.rmtree(deep, ignore_errors=True)
    del want
    qps_launches = run_cluster_qps(torch, counters)
    scale_launches = run_sharded_scale(torch, counters)
    run_shuffle(torch)
    multistage_launches = run_multistage(torch, counters)
    distributed_launches = run_multistage_distributed(torch, counters)
    realtime_launches = run_realtime(torch, counters)
    control_plane_launches = run_control_plane(torch, counters)
    batch_minion_launches = run_batch_minion(torch, counters)
    timeseries_launches = run_timeseries_connector(torch, counters)
    # each path's counts, read just after it: the main path's, the sharded
    # path's (its proto reruns included), the mesh's, the scale path's, the
    # multistage engine's, the three cluster phases', the distributed
    # stages', the server processes' (from their registries), the
    # realtime tables', the control plane's (its server processes' and
    # its compatibility suite's), the batch-built table's and the
    # connector-written metrics table's launches. The
    # sum entry of grouped_sum_f32 is on none: the kernel's launches are its
    # presence entry's
    paths = (main["launches"], sharded_launches, mesh_launches, scale_launches, multistage_launches,
             cluster_launches, http_launches, qps_launches, distributed_launches, process_launches,
             realtime_launches, control_plane_launches, batch_minion_launches, timeseries_launches)
    launches = {k: sum(p[k] for p in paths) for k in main["launches"]}
    launches["grouped_sum_f32"] = launches["presence"]

    print(card_line(), flush=True)
    kernels = []
    for kname, replaces in (
        ("grouped_sum_count", "pinot_tpu/ops/groupby_pallas.py:318"),
        ("grouped_sum_count_2l", "pinot_tpu/ops/groupby_pallas.py:396"),
        ("grouped_extreme", "pinot_tpu/ops/groupby_pallas.py:232"),
        ("grouped_sum_f32", "pinot_tpu/ops/groupby_pallas.py:152"),
    ):
        t = timing[kname]
        kernels.append(
            {
                "name": kname,
                "route": "cuda",
                "source": f"pinot_tpu_torch/ops/csrc/{kname}.cu",
                "replaces": replaces,
                "launches": launches[kname],
                "max_abs_err": t["max_abs_err"],
                "ms": t["kernel_ms"],
                "device_ms": t["kernel_device_ms"],
                "host_ms": t.get("kernel_host_ms"),
                "shape": t["shape"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_data_ms"],
                "bound_by": "bytes",
                "library_ms": t["library_ms"],
            }
        )
    emit({"phase": "run", "seconds": time.perf_counter() - T_START, "card": card_line()})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
