"""pinot_tpu_torch — the PyTorch + CUDA port of pinot_tpu for NVIDIA Hopper.

The same real-time OLAP engine as `pinot_tpu`, with segments staged as torch
tensors on one device and the per-segment query program (filter mask ->
projection -> dense group id -> aggregate) run as eager torch ops around
kernels written by hand for Hopper (CUDA C++ for sm_90a under `ops/csrc/`).
The JAX package stays the reference; this package imports nothing of it.

Entry points run on the card: `QueryEngine(segments)` uses device "cuda"
and raises where there is none; pass device="cpu" to run the plain torch
versions of the kernels on the CPU.

Layer map (mirrors pinot_tpu's):
  common/   - schema, types, config subset, error codes; metrics, trace,
              accounting, faults, segment heat, the kernel registry,
              crash-consistent writes
  segment/  - dictionaries, stats, builder, device staging, carry-over; the
              segment file store and loader, the auxiliary indexes
  query/    - SQL parser, context, pruner, planner, per-segment program,
              reduce, engine, scan stats, schedulers
  parallel/ - the sharded table and its one-program-a-query executor (one
              device)
  native/   - the segment files' codecs (C++ built with g++ at first use)
  ops/      - hand-written CUDA kernels, their plain versions, their build
"""
