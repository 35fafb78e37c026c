"""The readers of the program's span log on a synthetic run: two queries
across a 10 s slice, their spans clipped to it and each query counted by
the share of its life inside it; nothing read where the log is empty or the
program has none, and no card metric off a card."""

from __future__ import annotations

import pytest

from olap_bench.harness import Run, load_module
from olap_bench.loop import QueryRecord
from olap_bench.profile import Slice
from olap_bench.tests.test_olap_bench_harness import HERE, small_cell
from pinot_tpu_torch.common import trace

READERS = ["queue_wait_ms", "plan_ms", "enqueue_ms", "sync_wait_ms", "host_reduce_ms", "card_ms", "idle_front_pct"]
F = 0.5 + 0.8  # the two queries' shares of their lives inside the slice


def spans_of(thread: int, wait, submit, enqueue, resolve, seg_resolve, sync, card_ms: float) -> list:
    named = [
        ("scheduler.wait", wait, {}),
        ("engine.submit", submit, {}),
        ("segment.enqueue", enqueue, {"graph": "hit"}),
        ("engine.resolve", resolve, {}),
        ("segment.resolve", seg_resolve, {"segment": "s0", "card_ms": card_ms}),
        ("segment.sync", sync, {}),
    ]
    return [trace.SpanRecord(n, a, b, thread, thread, i, None, attrs) for i, (n, (a, b), attrs) in enumerate(named)]


@pytest.fixture
def run(monkeypatch):
    log = trace.SpanLog()
    for rec in spans_of(1, (5, 8), (8, 9), (8.5, 8.8), (9, 15), (9.1, 14.5), (9.2, 14.0), 3000.0) + spans_of(
        2, (12, 16), (16, 17), (16.2, 16.7), (17, 22), (17.4, 21.2), (17.5, 21.0), 2000.0
    ):
        log.add(rec)
    monkeypatch.setattr(trace, "SPANS", log)
    r = Run(small_cell("tpch_q1_c8"))
    r.records = [QueryRecord(0, "q", "sql", 5.0, 8.0, 9.0, 15.0, 15.0), QueryRecord(1, "q", "sql", 12.0, 16.0, 17.0, 22.0, 22.0)]
    r.slice = Slice(10.0, 20.0, ops=[("k", 16.0, 16.5, "kernel"), ("k", 18.0, 19.5, "kernel")], cuda=True)
    return r


def read(name: str, run):
    return load_module(HERE / "metrics" / f"{name}.py").read(run)


def test_readers_clip_to_the_slice_and_count_queries_fractionally(run):
    got = {name: read(name, run) for name in READERS}
    want = {
        "queue_wait_ms": 4000 / F,  # q2's wait from 12 to 16; q1's ended before the slice
        "plan_ms": 500 / F,  # q2's submit, 1 s, less its enqueue's 0.5 s
        "enqueue_ms": 500 / F,
        "sync_wait_ms": 6500 / F,  # q1's from 10 to 14, q2's from 17.5 to 20
        "host_reduce_ms": 1500 / F,  # the resolves' 5 + 3 s less their syncs
        "card_ms": 4000 / F,  # q1's 3 s before its sync ended at 14, q2's 2 s before 21, to 20
        "idle_front_pct": 5.0,  # q2's submit from 16 to 17, the card busy to 16.5
    }
    assert got == pytest.approx(want)


def test_nothing_read_without_spans_or_off_a_card(run, monkeypatch):
    run.slice.cuda = False
    got = {name: read(name, run) for name in READERS}
    assert got["card_ms"] is None and got["idle_front_pct"] is None and got["plan_ms"] == pytest.approx(500 / F)
    monkeypatch.setattr(trace, "SPANS", trace.SpanLog())
    assert {name: read(name, run) for name in READERS} == dict.fromkeys(READERS)
    monkeypatch.delattr(trace, "SPANS")  # a program without the log
    assert {name: read(name, run) for name in READERS} == dict.fromkeys(READERS)


def test_a_traced_cpu_run_reads_the_host_spans():
    """On the CPU the profiled slice fills the program's log: the five host
    readings appear; the card's two do not."""
    import time

    from olap_bench.harness import run_cell
    from olap_bench.tests.test_olap_bench_harness import SEED, quiet

    result = run_cell(small_cell("tpch_q1_c8"), SEED, 3.0, True, "cpu", time.perf_counter(), log=quiet)
    assert result["correct"]
    assert {"queue_wait_ms", "plan_ms", "enqueue_ms", "sync_wait_ms", "host_reduce_ms"} <= set(result["metrics"])
    assert not {"card_ms", "idle_front_pct"} & set(result["metrics"])
