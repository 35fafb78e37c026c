"""CUDA graphs of the compiled programs, and the table that keeps them.

The JAX package compiles each per-segment plan spec into one XLA executable
(`jax.jit`: one per spec and input signature, built at the first call and
replayed with new operands). On a card the port's counterpart is a
`torch.cuda.CUDAGraph`: the eager program runs once as a warm-up (it builds
and loads the kernels), is captured once, and every later call copies its
operands into the graph's static buffers and replays it in one launch. The
hand-written kernels B1-B4 launch inside it as they are: their ctypes
entries take the capturing stream.

`query/kernels.py` (the per-segment programs behind `get_kernel` /
`get_packed_kernel`) and `parallel/mesh.py` (the sharded slot programs)
capture with `capture_graph` and keep each `Graph` in `GRAPHS`, keyed by what
the capture baked in: the spec, the owner's tensors (a `DeviceSegment`, a
`ShardedTable`), the operands' dtypes, shapes and sharing, the doc counts.
The owner is held by weakref: when a segment generation is replaced, its
graphs go at the next lookup.

Every graph a table captures on one card shares ONE memory pool, the
table's `Pool` for that card: the card then holds one program's peak of
intermediates, not the sum of every graph's. Sharing is safe because no
graph's outputs are read after another graph's replay: every use of a pool
(operands in, the replay, the outputs copied out) runs under the pool's lock
and, on the card, after the pool's last use (`Pool.begin` / `Pool.end`).
What a graph holds on its own is its outputs and its operand slab
(`Graph.nbytes`); the table is an LRU bounded by those bytes, against a
share of the card's free memory (`graph_budget`). A capture runs under the
staging lock, in the "thread_local" error mode, on the device's own capture
stream, so another thread's allocations and launches do not enter it. A
program whose capture fails raises: there is no eager fallback on a card.

The table's counts go to the server registry where they change, as
`stats()` reads them: `engine.graphs.{lookups,hits,captures,evictions}`
meters and `engine.graphs.{bytes,peakBytes}` gauges.
"""

from __future__ import annotations

import sys
import threading
import weakref
from collections import OrderedDict
from contextlib import contextmanager

from pinot_tpu_torch.common.kernel_obs import CapturedLaunches, capturing
from pinot_tpu_torch.common.metrics import server_metrics
from pinot_tpu_torch.segment.segment import _STAGE_LOCK

#: the share of a card's free memory, read when a table first captures
#: there, that its graphs' outputs and operand slabs may hold (the shared
#: pool is apart: one program's peak). The staged segments and the eager
#: work keep the rest, and a server process that starts on a card other
#: processes already fill gets a share of what they left.
GRAPH_MEMORY_SHARE = 1 / 16

#: one capture at a time, and none while a segment stages: a capture and its
#: capture stream are then the only ones in flight (the staging lock of
#: segment/segment.py, which query threads already share)
CAPTURE_LOCK = _STAGE_LOCK

# device index -> the stream captures run on (never the legacy default
# stream, which cannot capture)
_CAPTURE_STREAMS: dict[int, object] = {}


def graph_budget(device) -> int:
    """The bytes a table's graphs may hold on `device`: GRAPH_MEMORY_SHARE of
    the card's free memory now."""
    import torch

    free, _total = torch.cuda.mem_get_info(device)
    return int(free * GRAPH_MEMORY_SHARE)


def _device_index(device) -> int:
    import torch

    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


class Pool:
    """One card's graph memory pool and the order of its uses: each use
    (with `lock` held) waits on the card for the last one to end (`begin`)
    and marks its own end (`end`). `bytes` is what the pool's captures
    added to the card's reserved memory. Made under CAPTURE_LOCK: it
    captures `_anchor`, a one-launch graph that keeps the pool open while
    the Pool lives (torch's allocators refuse a capture into a pool whose
    graphs have all gone, as a table's do when their segments go)."""

    def __init__(self, device):
        import torch

        self.device = device
        self.handle = torch.cuda.graph_pool_handle()
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()
        self.used = False
        self.bytes = 0
        self._anchor = torch.cuda.CUDAGraph()
        stream = _capture_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            self._anchor.capture_begin(pool=self.handle, capture_error_mode="thread_local")
            self._anchor_out = torch.zeros(1, device=device)
            self._anchor.capture_end()
        torch.cuda.current_stream(device).wait_stream(stream)

    def begin(self) -> None:
        """Order this use after the last one (call with `lock` held)."""
        import torch

        if self.used:
            torch.cuda.current_stream(self.device).wait_event(self.done)

    def end(self) -> None:
        """Mark this use enqueued (call with `lock` held)."""
        import torch

        self.done.record(torch.cuda.current_stream(self.device))
        self.used = True


class Graph:
    """One captured program: the CUDA graph, its card's pool, the launches
    its capture saw, its static operand buffer (`slab`, with `ops` the
    operands' views of it and the stable operands' own tensors, held here
    because the graph reads them: a stable operand's device copy outlives
    its cache entry so), its outputs (static: the next use of the pool
    overwrites them) and `nbytes`, what it holds on its own."""

    def __init__(self, pool: Pool, slab, ops):
        import torch

        self.pool = pool
        self.device = pool.device
        self.graph = torch.cuda.CUDAGraph()
        self.captured = CapturedLaunches()
        self.slab = slab
        self.ops = ops
        self.outputs: tuple = ()
        self.info: dict = {}
        self.nbytes = 0


def held_bytes(tensors) -> int:
    """The bytes of the distinct storages under `tensors`."""
    storages = {}
    for t in tensors:
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
    return sum(storages.values())


def _capture_stream(device):
    import torch

    index = _device_index(device)
    stream = _CAPTURE_STREAMS.get(index)
    if stream is None:
        stream = _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return stream


def reserved_bytes(device) -> int:
    """The caching allocator's reserved bytes on `device` (read from its
    nested stats: `torch.cuda.memory_stats` flattens them all, a cost at
    every capture)."""
    import torch

    return int(torch.cuda.memory.memory_stats_as_nested_dict(device)["reserved_bytes"]["all"]["current"])


def _abandon(graph, pool: Pool) -> None:
    """End a capture whose block raised. A capture that is still valid just
    ends (the graph gives its hold on the pool back when it goes). An
    invalidated one's end raises before the allocator stops routing the
    capture stream's allocations to the pool, so that is ended here too,
    and the capture's hold on the pool released. The allocator still
    refuses the pool another capture after that ("already recording"), so
    the table retires it (`GraphTable.retire`). The block's own error is the
    one raised."""
    import torch

    try:
        graph.capture_end()
        return
    except RuntimeError:  # pinotlint: disable=deadline-swallow — an invalidated capture cannot end; its pool is let go below
        pass
    index = _device_index(pool.device)
    for end in (lambda: torch._C._cuda_endAllocateToPool(index, pool.handle),
                lambda: torch._C._cuda_releasePool(index, pool.handle)):
        try:
            end()
        except RuntimeError:  # pinotlint: disable=deadline-swallow — the capture's end may already have done it; the block's error is raised
            pass


@contextmanager
def capture_graph(graph, captured: CapturedLaunches, pool: Pool):
    """Capture the block's device work into `graph` (a CUDAGraph) in
    `pool`, on its card's capture stream, in the "thread_local" error mode;
    the block's kernel launches go to `captured`. Call it with CAPTURE_LOCK
    held. A failed capture ends the capture and raises."""
    import torch

    device = pool.device
    stream = _capture_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream), capturing(captured):
        graph.capture_begin(pool=pool.handle, capture_error_mode="thread_local")
        try:
            yield
        except BaseException:
            _abandon(graph, pool)
            raise
        graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(stream)


class GraphTable:
    """The captured graphs by key, least recently used first, bounded by
    the bytes they hold on their own (`budget`: fixed, or None for
    `graph_budget` of the first card the table captures on); each graph's
    owner is held by weakref and its graphs dropped at the next lookup once
    it is gone. One `Pool` a card."""

    def __init__(self, budget: int | None = None):
        self.budget = None if budget is None else int(budget)
        self._lock = threading.Lock()
        self._graphs: OrderedDict[tuple, Graph] = OrderedDict()
        self._pools: dict[int, Pool] = {}
        self._owner_keys: dict[int, set] = {}
        self._owner_refs: dict[int, weakref.ref] = {}
        # owners collected since the last lookup (a weakref callback may run
        # on any thread, inside any lock: it only appends here)
        self._dead: list[int] = []
        self.bytes = 0
        self.peak_bytes = 0
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self.evictions = 0

    def pool(self, device) -> Pool:
        """The pool of `device`'s card (made at its first capture, which
        also sets an unset budget; call with CAPTURE_LOCK held)."""
        index = _device_index(device)
        with self._lock:
            pool = self._pools.get(index)
            if pool is None:
                if self.budget is None:
                    self.budget = graph_budget(device)
                pool = self._pools[index] = Pool(device)
            return pool

    def retire(self, pool: Pool) -> None:
        """Capture no more into `pool` (a capture into it failed): the next
        capture on its card makes a new one. Its graphs keep it, and replay
        as before."""
        with self._lock:
            for index, p in list(self._pools.items()):
                if p is pool:
                    del self._pools[index]

    def _drop_locked(self, key) -> None:
        g = self._graphs.pop(key, None)
        if g is not None:
            self.bytes -= g.nbytes

    def purge(self) -> None:
        """Drop the graphs of owners collected since the last lookup now
        (their outputs go back to the pool)."""
        with self._lock:
            self._purge_locked()
        self._export()

    def _export(self, evicted: int = 0) -> None:
        """The byte gauges (and the evictions just made) to the server
        registry."""
        reg = server_metrics()
        reg.gauge("engine.graphs.bytes").set(self.bytes)
        reg.gauge("engine.graphs.peakBytes").set(self.peak_bytes)
        if evicted:
            reg.meter("engine.graphs.evictions").mark(evicted)

    def _purge_locked(self) -> None:
        while self._dead:
            oid = self._dead.pop()
            self._owner_refs.pop(oid, None)
            for key in self._owner_keys.pop(oid, ()):
                self._drop_locked(key)

    def get(self, key) -> Graph | None:
        with self._lock:
            self._purge_locked()
            g = self._graphs.get(key)
            if g is not None:
                self._graphs.move_to_end(key)
                self.replays += 1
        reg = server_metrics()
        reg.meter("engine.graphs.lookups").mark()
        if g is not None:
            reg.meter("engine.graphs.hits").mark()
        return g

    def put(self, key, owner, graph: Graph, seconds: float = 0.0) -> None:
        """Keep `graph` under `key` for as long as `owner` lives, then evict
        the least recently used graphs past the budget (never the new one).
        `seconds`: what its warm-up and capture took."""
        oid = id(owner)
        with self._lock:
            evicted = self.evictions
            self.capture_seconds += seconds
            self._purge_locked()
            if oid not in self._owner_refs:
                self._owner_refs[oid] = weakref.ref(owner, lambda _r, oid=oid: self._dead.append(oid))
            self._owner_keys.setdefault(oid, set()).add(key)
            self._drop_locked(key)
            self._graphs[key] = graph
            self.bytes += graph.nbytes
            self.peak_bytes = max(self.peak_bytes, self.bytes)
            self.captures += 1
            self.replays += 1
            while self.budget is not None and self.bytes > self.budget and len(self._graphs) > 1:
                old, _ = next(iter(self._graphs.items()))
                self._drop_locked(old)
                self.evictions += 1
                for keys in self._owner_keys.values():
                    keys.discard(old)
            evicted = self.evictions - evicted
        server_metrics().meter("engine.graphs.captures").mark()
        self._export(evicted)

    def clear(self) -> None:
        """Drop every graph and pool and give the card back the pools'
        memory (the next call of each program captures again into a new
        pool). A pool's memory otherwise stays reserved until the allocator
        runs short."""
        with self._lock:
            self._graphs.clear()
            self._pools.clear()
            self._owner_keys.clear()
            self._owner_refs.clear()
            self._dead.clear()
            self.bytes = 0
        self._export()
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.empty_cache()

    def stats(self) -> dict:
        self.purge()
        with self._lock:
            return {
                "graphs": len(self._graphs),
                "bytes": self.bytes,
                "peakBytes": self.peak_bytes,
                "poolBytes": sum(p.bytes for p in self._pools.values()),
                "budget": self.budget,
                "captures": self.captures,
                "captureSeconds": self.capture_seconds,
                "replays": self.replays,
                "evictions": self.evictions,
            }


#: the process's graphs, every program's
GRAPHS = GraphTable()
