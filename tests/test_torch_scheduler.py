"""The port's query schedulers (query/scheduler.py) beside the JAX
package's: the cases of tests/test_scheduler.py that need no server process,
each run against both packages' schedulers, and the port's engine driven
through FCFSScheduler and PriorityScheduler (2 runners, 4 client threads):
every scheduled result equals the reference's, and an error in a runner
reaches the caller through its future."""

import threading
import time

import pytest

from pinot_tpu.query import scheduler as jscheduler
from pinot_tpu_torch.common.accounting import QueryKilledError, default_accountant
from pinot_tpu_torch.common.errors import QueryErrorCode
from pinot_tpu_torch.query import scheduler
from test_torch_pruner import assert_same_result, pair, time_columns, time_partitioned

BOTH = pytest.mark.parametrize("mod", [scheduler, jscheduler], ids=["port", "reference"])


@BOTH
def test_fcfs_runs_and_returns(mod):
    s = mod.FCFSScheduler(num_runners=2)
    s.start()
    try:
        futs = [s.submit(lambda i=i: i * i) for i in range(10)]
        assert [f.result(timeout=5) for f in futs] == [i * i for i in range(10)]
    finally:
        s.stop()


@BOTH
def test_fcfs_propagates_exceptions(mod):
    s = mod.FCFSScheduler(num_runners=1)
    s.start()
    try:
        with pytest.raises(ZeroDivisionError):
            s.submit(lambda: 1 / 0).result(timeout=5)
    finally:
        s.stop()


@BOTH
def test_fcfs_preserves_arrival_order_single_runner(mod):
    s = mod.FCFSScheduler(num_runners=1)
    order = []
    gate = threading.Event()
    s.start()
    try:
        first = s.submit(lambda: gate.wait(5))
        futs = [s.submit(lambda i=i: order.append(i)) for i in range(5)]
        gate.set()
        first.result(timeout=5)
        for f in futs:
            f.result(timeout=5)
        assert order == list(range(5))
    finally:
        s.stop()


@BOTH
def test_submit_after_stop_rejects(mod):
    s = mod.FCFSScheduler(num_runners=1)
    s.start()
    s.stop()
    with pytest.raises(mod.SchedulerRejectedError):
        s.submit(lambda: 1)


@BOTH
def test_priority_group_queue_overflow_rejects(mod):
    s = mod.PriorityScheduler(num_runners=1, max_pending_per_group=2)
    gate = threading.Event()
    s.start()
    try:
        blocker = s.submit(lambda: gate.wait(5), table="a")
        time.sleep(0.05)
        s.submit(lambda: 1, table="a")
        s.submit(lambda: 2, table="a")
        with pytest.raises(mod.SchedulerRejectedError):
            s.submit(lambda: 3, table="a")
        s.submit(lambda: 4, table="b").cancel()  # another group still admits
        gate.set()
        blocker.result(timeout=5)
    finally:
        s.stop()


@BOTH
def test_priority_tokens_throttle_heavy_group(mod):
    s = mod.PriorityScheduler(num_runners=1, tokens_per_sec=0.0, token_burst_sec=1.0)
    s.start()
    try:
        s.submit(lambda: time.sleep(0.2), table="heavy").result(timeout=5)
        order = []
        gate = threading.Event()
        blocker = s.submit(lambda: gate.wait(5), table="other")
        time.sleep(0.05)
        futs = [s.submit(lambda: order.append("heavy"), table="heavy"), s.submit(lambda: order.append("light"), table="light")]
        gate.set()
        blocker.result(timeout=5)
        for f in futs:
            f.result(timeout=5)
        assert order[0] == "light"
        tokens = s.group_tokens()
        assert tokens["heavy"] < tokens["light"]
    finally:
        s.stop()


@BOTH
def test_binary_workload_secondary_capped(mod):
    s = mod.BinaryWorkloadScheduler(num_runners=4, secondary_runners=1)
    running, peak = [0], [0]
    lock = threading.Lock()

    def job():
        with lock:
            running[0] += 1
            peak[0] = max(peak[0], running[0])
        time.sleep(0.05)
        with lock:
            running[0] -= 1

    s.start()
    try:
        futs = [s.submit(job, workload="SECONDARY") for _ in range(4)]
        for f in futs:
            f.result(timeout=5)
        assert peak[0] == 1
    finally:
        s.stop()


@BOTH
def test_binary_workload_secondary_queue_overflow(mod):
    s = mod.BinaryWorkloadScheduler(num_runners=1, secondary_runners=1, max_secondary_pending=1)
    gate = threading.Event()
    s.start()
    try:
        blocker = s.submit(lambda: gate.wait(5), workload="SECONDARY")
        time.sleep(0.05)
        s.submit(lambda: 1, workload="SECONDARY")
        with pytest.raises(mod.SchedulerRejectedError):
            s.submit(lambda: 2, workload="SECONDARY")
        gate.set()
        blocker.result(timeout=5)
    finally:
        s.stop()


@BOTH
def test_stop_unblocks_pending_futures(mod):
    s = mod.FCFSScheduler(num_runners=1)
    gate = threading.Event()
    s.start()
    blocker = s.submit(lambda: gate.wait(5))
    time.sleep(0.05)
    pending = [s.submit(lambda: 1) for _ in range(3)]
    stopper = threading.Thread(target=s.stop)
    stopper.start()
    gate.set()
    stopper.join(timeout=10)
    blocker.result(timeout=5)
    for f in pending:
        assert f.cancelled() or f.done()


@BOTH
def test_in_flight_and_stats_accounting(mod):
    s = mod.PriorityScheduler(num_runners=2)
    gate = threading.Event()
    s.start()
    try:
        futs = [s.submit(lambda: gate.wait(5), table="t") for _ in range(2)]
        deadline = time.monotonic() + 5
        while s.in_flight() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        st = s.stats()
        assert st["kind"] == "priority" and st["inFlight"] == 2 and st["pending"] == 0
        gate.set()
        for f in futs:
            f.result(timeout=5)
    finally:
        s.stop()
    assert s.pending() == 0 and s.in_flight() == 0


@BOTH
def test_queue_depths_per_kind(mod):
    assert mod.FCFSScheduler(1).queue_depths() == {"": 0}
    assert mod.BinaryWorkloadScheduler(1).queue_depths() == {"PRIMARY": 0, "SECONDARY": 0}
    assert mod.PriorityScheduler(1).queue_depths() == {}


@BOTH
def test_make_scheduler_factory(mod):
    assert isinstance(mod.make_scheduler("fcfs"), mod.FCFSScheduler)
    assert isinstance(mod.make_scheduler("priority", tokens_per_sec=2.0), mod.PriorityScheduler)
    assert isinstance(mod.make_scheduler("binary_workload"), mod.BinaryWorkloadScheduler)
    assert isinstance(mod.make_scheduler("BinaryWorkload"), mod.BinaryWorkloadScheduler)
    with pytest.raises(ValueError):
        mod.make_scheduler("nope")


def test_rejected_error_carries_code_and_retry_after():
    e = scheduler.SchedulerRejectedError("full", retry_after_s=1.5)
    assert e.error_code == QueryErrorCode.SERVER_OUT_OF_CAPACITY == jscheduler.SchedulerRejectedError.error_code
    assert e.retry_after_s == 1.5


# -- the engine through a scheduler ------------------------------------------------


@pytest.fixture(scope="module")
def tp():
    return pair("t", time_columns, time_partitioned())


ENGINE_QUERIES = [
    "SELECT region, city, SUM(revenue), COUNT(*), MIN(qty), MAX(qty) FROM t WHERE year = 1997 GROUP BY region, city "
    "ORDER BY SUM(revenue) DESC LIMIT 1000",
    "SELECT GAPFILL(year, 1990, 2002, 1, FILL(r, 'FILL_PREVIOUS_VALUE')), SUM(revenue) AS r FROM t "
    "WHERE year <> 1995 GROUP BY year ORDER BY year LIMIT 100",
    "SELECT region, COUNT(*), SUM(revenue) FROM t GROUP BY region ORDER BY region",
    "SELECT DISTINCTCOUNT(custkey) FROM t WHERE year >= 1996",
]


@pytest.mark.parametrize("kind", ["fcfs", "priority"])
def test_engine_queries_through_scheduler(tp, kind):
    """4 client threads, each sending the 4 queries in its own rotation,
    through 2 runners: every result the reference's."""
    ref, ports = tp
    eng = ports["built"]
    want = {sql: ref.execute(sql) for sql in ENGINE_QUERIES}
    s = scheduler.make_scheduler(kind, num_runners=2)
    s.start()
    results, errors = [], []

    def client(i):
        try:
            for j in range(len(ENGINE_QUERIES)):
                sql = ENGINE_QUERIES[(i + j) % len(ENGINE_QUERIES)]
                results.append((sql, s.submit(eng.execute, sql, table="t").result(timeout=60)))
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        s.stop()
    assert not errors
    assert len(results) == 16
    for sql, got in results:
        assert_same_result(got, want[sql], sql)


def test_killed_query_reaches_the_caller_through_its_future(tp):
    """A QueryKilledError raised at the engine's per-segment checkpoint on a
    runner thread surfaces from the future."""
    _, ports = tp
    eng = ports["built"]
    s = scheduler.FCFSScheduler(num_runners=2)
    s.start()

    def killed_query():
        with default_accountant.scope("sched-kill-1", table="t"):
            default_accountant.kill("sched-kill-1", "test kill")
            return eng.execute("SELECT COUNT(*) FROM t")

    try:
        with pytest.raises(QueryKilledError, match="test kill"):
            s.submit(killed_query).result(timeout=30)
        assert s.submit(eng.execute, "SELECT COUNT(*) FROM t").result(timeout=30).rows == [[6000]]
    finally:
        s.stop()
