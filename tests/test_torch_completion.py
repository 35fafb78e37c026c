"""The port's segment completion protocol against the JAX package's.

The cases are the reference's `tests/test_completion.py`, each run through
both packages: exactly one committer (the other replica KEEPs), a committer
killed mid-commit and the re-election, peer download when the deep store is
down (DISCARD_AND_DOWNLOAD), pauseless consumption during a commit, the
sealed segment queryable while its commit runs, and CATCHUP past the row
budget. The threads of two replicas race, so those cases compare each
package's outcomes (who committed, who kept or downloaded, the committed
metadata and rows), not their interleaving. The FSM itself is driven
deterministically: the same seeded script of segmentConsumed / heartbeat /
commitEnd calls on a controlled clock must give the same decisions in
both packages, call for call.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import pinot_tpu.cluster as r_cluster
import pinot_tpu.common as r_common
import pinot_tpu.realtime as r_realtime
import pinot_tpu.realtime.completion as r_completion
import pinot_tpu_torch.cluster as p_cluster
import pinot_tpu_torch.common as p_common
import pinot_tpu_torch.realtime as p_realtime
import pinot_tpu_torch.realtime.completion as p_completion

REF = SimpleNamespace(name="ref", cluster=r_cluster, common=r_common, realtime=r_realtime, completion=r_completion,
                      server=lambda sid: r_cluster.Server(sid))
PORT = SimpleNamespace(name="port", cluster=p_cluster, common=p_common, realtime=p_realtime, completion=p_completion,
                       server=lambda sid: p_cluster.Server(sid, device="cpu"))
PKGS = (REF, PORT)

ROWS_PER_SEG = 40


def _schema(pkg):
    dt = pkg.common.DataType
    return pkg.common.Schema.build("ev", dimensions=[("kind", dt.STRING)], metrics=[("value", dt.LONG)])


def _config(pkg):
    return pkg.common.TableConfig("ev", table_type=pkg.common.TableType.REALTIME, replication=2)


def _cluster(pkg, root, commit_timeout=2.0, max_rows=(ROWS_PER_SEG, ROWS_PER_SEG)):
    ctrl = pkg.cluster.Controller(pkg.cluster.PropertyStore(), root / "deep")
    ctrl.add_schema(_schema(pkg))
    ctrl.add_table(_config(pkg))
    stream = pkg.realtime.InMemoryStream(partitions=1)
    completion = pkg.completion.SegmentCompletionManager(commit_timeout_s=commit_timeout)
    servers, managers = [], []
    for i in range(2):
        srv = pkg.server(f"server_{i}")
        ctrl.register_server(srv.server_id, handle=srv)
        managers.append(pkg.realtime.RealtimeTableManager(
            ctrl, srv, _schema(pkg), _config(pkg), stream, max_rows_per_segment=max_rows[i], completion=completion
        ))
        servers.append(srv)
    return ctrl, stream, completion, servers, managers


def _produce(stream, n, start=0):
    for i in range(start, start + n):
        stream.produce(0, {"kind": f"k{i % 3}", "value": i})


def _wait(pred, timeout=15.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.03)
    raise AssertionError(f"timed out waiting for {msg}")


def _outcome(mgr) -> str:
    log = list(mgr.consumers[0].commit_log)
    if any(e[1] == "COMMIT_END" and e[2] for e in log):
        return "commit"
    if any(e[1] == "KEPT" for e in log):
        return "keep"
    if any(e[1] == "DOWNLOADED" for e in log):
        return "download"
    return "none"


def _meta(ctrl, seg):
    m = ctrl.segment_metadata("ev", seg) or {}
    return {k: m.get(k) for k in ("startOffset", "endOffset", "numDocs", "partition")}


def _seg_rows(server, seg):
    s = server.get_segment_object("ev", seg)
    return None if s is None else sorted(int(v) for v in s.columns["value"].materialize())


def _exactly_one_committer(pkg, root):
    ctrl, stream, completion, servers, managers = _cluster(pkg, root)
    _produce(stream, ROWS_PER_SEG + 5)
    for m in managers:
        m.start()
    try:
        seg0 = "ev__0__0"
        _wait(lambda: completion.phase(seg0) == "COMMITTED", msg="segment committed")
        _wait(lambda: all(seg0 in s.segments_of("ev") for s in servers), msg="both replicas hold the segment")
        _wait(lambda: sorted(_outcome(m) for m in managers) == ["commit", "keep"], msg="outcomes")
        assert all(m.consumers[0]._segment_start_offset == ROWS_PER_SEG for m in managers)
        # HOLD polls repeat as long as the other replica takes: not compared
        decisions = sorted(tuple(e[1] for e in m.consumers[0].commit_log if e[1] != "HOLD") for m in managers)
        return {"meta": _meta(ctrl, seg0), "rows": [_seg_rows(s, seg0) for s in servers], "decisions": decisions}
    finally:
        for m in managers:
            m.stop()


def test_exactly_one_committer_other_keeps(tmp_path):
    """Equal-offset replicas: one commits, the other gets KEEP and serves its
    own build; the committed metadata, each replica's rows and the decision
    sequences (COMMIT, COMMIT_END / KEEP, KEPT) equal the reference's."""
    out = {pkg.name: _exactly_one_committer(pkg, tmp_path / pkg.name) for pkg in PKGS}
    assert out["port"] == out["ref"]
    assert out["port"]["meta"]["endOffset"] == ROWS_PER_SEG
    assert out["port"]["decisions"] == [("COMMIT", "COMMIT_END"), ("KEEP", "KEPT")]


def _killed_committer(pkg, root):
    ctrl, stream, completion, servers, managers = _cluster(pkg, root, commit_timeout=0.7)
    hang = threading.Event()

    def dying_commit(seg, start, end):
        hang.set()
        time.sleep(3600)  # never returns: the replica is dead mid-commit

    managers[0].consumers[0].commit_fn = dying_commit
    _produce(stream, ROWS_PER_SEG + 5)
    managers[0].start()
    _wait(hang.wait, msg="committer entered its commit")
    managers[1].start()
    try:
        seg0 = "ev__0__0"
        _wait(lambda: completion.phase(seg0) == "COMMITTED", timeout=20.0, msg="re-elected replica committed")
        assert seg0 in servers[1].segments_of("ev")
        log1 = managers[1].consumers[0].commit_log
        assert any(e[1] == "COMMIT_END" and e[2] for e in log1), log1
        return {"meta": _meta(ctrl, seg0), "rows": _seg_rows(servers[1], seg0),
                "survivor": [e[1] for e in log1 if e[0] == seg0][-1]}
    finally:
        for m in managers:
            for c in m.consumers:
                c.stop(timeout=0.3)  # the dead committer thread never joins


def test_committer_killed_mid_commit_reelection(tmp_path):
    """The elected committer dies between winning the claim and uploading:
    the FSM times its claim out and promotes the holding replica."""
    out = {pkg.name: _killed_committer(pkg, tmp_path / pkg.name) for pkg in PKGS}
    assert out["port"] == out["ref"]
    assert out["port"]["meta"]["endOffset"] == ROWS_PER_SEG and out["port"]["survivor"] == "COMMIT_END"


def _peer_download(pkg, root):
    ctrl, stream, completion, servers, managers = _cluster(pkg, root, max_rows=(ROWS_PER_SEG, ROWS_PER_SEG + 20))

    def broken_upload(table, segment):
        raise OSError("deep store unavailable")

    ctrl.upload_segment = broken_upload
    _produce(stream, ROWS_PER_SEG + 30)
    for m in managers:
        m.start()
    try:
        seg0 = "ev__0__0"
        _wait(lambda: completion.phase(seg0) == "COMMITTED", msg="peer commit")
        meta = ctrl.segment_metadata("ev", seg0)
        assert meta is not None and meta.get("peerDownload") in ("server_0", "server_1")
        _wait(lambda: all(s.get_segment_object("ev", seg0) is not None for s in servers), msg="peer download")
        downloaders = [m for m in managers if any(e[1] == "DOWNLOADED" for e in m.consumers[0].commit_log)]
        assert len(downloaders) == 1
        return {"meta": _meta(ctrl, seg0), "rows": sorted(_seg_rows(s, seg0) for s in servers),
                "outcomes": sorted(_outcome(m) for m in managers)}
    finally:
        for m in managers:
            m.stop()


def test_peer_download_when_deep_store_unavailable(tmp_path):
    """Deep-store writes fail: the committer registers its build for peer
    download, and the replica whose offset diverged (a larger row budget)
    discards and downloads it from the peer."""
    out = {pkg.name: _peer_download(pkg, tmp_path / pkg.name) for pkg in PKGS}
    assert out["port"] == out["ref"]
    assert out["port"]["outcomes"] == ["commit", "download"]


def _held_commit(pkg, root, extra_rows):
    ctrl, stream, completion, servers, managers = _cluster(pkg, root, commit_timeout=30.0)
    mgr = managers[0]  # a single replica is enough here
    committing, release = threading.Event(), threading.Event()
    orig = mgr.consumers[0].commit_fn

    def slow_commit(seg, start, end):
        committing.set()
        assert release.wait(20.0)
        orig(seg, start, end)

    mgr.consumers[0].commit_fn = slow_commit
    _produce(stream, ROWS_PER_SEG + extra_rows)
    mgr.start()
    return ctrl, completion, servers, mgr, committing, release


def test_pauseless_consumption_continues_during_commit(tmp_path):
    """Pauseless: the next consuming segment opens and ingests while the
    previous segment's commit is still in flight."""
    out = {}
    for pkg in PKGS:
        ctrl, completion, servers, mgr, committing, release = _held_commit(pkg, tmp_path / pkg.name, 20)
        try:
            _wait(committing.wait, msg="commit started")
            _wait(lambda: mgr.consumers[0]._mutable.n_docs > 0 and mgr.consumers[0]._seg_name() == "ev__0__1",
                  msg="next segment consuming during the commit")
            phase = completion.phase("ev__0__0")
            release.set()
            _wait(lambda: completion.phase("ev__0__0") == "COMMITTED", msg="commit finished")
            assert mgr.wait_until_caught_up([ROWS_PER_SEG + 20])
            out[pkg.name] = {"phase_during": phase, "meta": _meta(ctrl, "ev__0__0"),
                             "consuming": mgr.consumers[0]._mutable.n_docs}
        finally:
            release.set()
            mgr.stop()
    assert out["port"] == out["ref"]
    assert out["port"]["phase_during"] == "COMMITTING"


def test_pauseless_sealed_segment_stays_queryable(tmp_path):
    """During the async build and upload the sealed rows stay queryable on
    this server through the pending-sealed registry, then the hosted copy
    takes over."""
    out = {}
    for pkg in PKGS:
        ctrl, completion, servers, mgr, committing, release = _held_commit(pkg, tmp_path / pkg.name, 10)
        try:
            _wait(committing.wait, msg="commit started")
            seg0 = "ev__0__0"
            during = [s.n_docs for s in servers[0]._resolve_segments("ev", [seg0])]
            release.set()
            _wait(lambda: completion.phase(seg0) == "COMMITTED", msg="commit finished")
            _wait(lambda: mgr.consumers[0].pending_sealed(seg0) is None, msg="pending cleared")
            after = [s.n_docs for s in servers[0]._resolve_segments("ev", [seg0])]
            out[pkg.name] = (during, after)
        finally:
            release.set()
            mgr.stop()
    assert out["port"] == out["ref"] == ([ROWS_PER_SEG], [ROWS_PER_SEG])


def test_catchup_directive_reaches_winning_offset(tmp_path):
    """A straggler that reaches its end criteria at a lower offset gets
    CATCHUP, and the consume loop really reaches the winning offset past
    its row budget."""
    out = {}
    for pkg in PKGS:
        C = pkg.completion
        completion = C.SegmentCompletionManager(commit_timeout_s=5.0)
        decisions = [completion.segment_consumed("s__0__0", "B", 40), completion.segment_consumed("s__0__0", "A", 35)]
        assert decisions == [(C.COMMIT, 40), (C.HOLD, 40)]
        ctrl, stream, _c, servers, managers = _cluster(pkg, tmp_path / pkg.name)
        c = managers[0].consumers[0]
        _produce(stream, ROWS_PER_SEG + 10)
        while c._mutable.n_docs < ROWS_PER_SEG:
            c._consume_batch()
        assert c._consume_batch() == 0  # budget exhausted: a normal fetch stalls
        c._consume_to(ROWS_PER_SEG + 5)
        assert c.offset >= ROWS_PER_SEG + 5  # the ignore-budget path made progress
        out[pkg.name] = (decisions, c.offset, c._mutable.n_docs)
    assert out["port"] == out["ref"]


class _Clock:
    """A controlled `time` module for the FSM: time() returns `now`."""

    def __init__(self):
        self.now = 1_000.0

    def time(self):
        return self.now


def _script(seed: int, n: int = 300):
    """A seeded sequence of FSM calls over 3 replicas and 4 segments, with
    clock advances that cross the commit timeout and the max commit time."""
    rng = np.random.default_rng(seed)
    calls = []
    offsets = {}
    for _ in range(n):
        seg = f"t__0__{int(rng.integers(0, 4))}"
        sid = f"s{int(rng.integers(0, 3))}"
        kind = rng.choice(["consumed", "consumed", "heartbeat", "end_ok", "end_fail", "advance", "phase"])
        if kind == "consumed":
            offsets[(seg, sid)] = offsets.get((seg, sid), 0) + int(rng.integers(0, 30))
            calls.append(("consumed", seg, sid, offsets[(seg, sid)]))
        elif kind in ("end_ok", "end_fail"):
            calls.append((kind, seg, sid, offsets.get((seg, sid), 0), None if rng.random() < 0.5 else sid))
        elif kind == "advance":
            calls.append(("advance", float(rng.choice([0.1, 1.0, 2.5, 6.0]))))
        else:
            calls.append((kind, seg, sid))
    return calls


def _drive(module, calls):
    clock = _Clock()
    real = module.time
    module.time = clock
    try:
        fsm = module.SegmentCompletionManager(commit_timeout_s=2.0, max_commit_factor=3.0)
        out = []
        for call in calls:
            kind = call[0]
            if kind == "consumed":
                out.append(fsm.segment_consumed(call[1], call[2], call[3]))
            elif kind == "heartbeat":
                out.append(fsm.commit_heartbeat(call[1], call[2]))
            elif kind in ("end_ok", "end_fail"):
                out.append(fsm.commit_end(call[1], call[2], call[3], kind == "end_ok", call[4]))
            elif kind == "advance":
                clock.now += call[1]
                out.append(None)
            else:
                out.append((fsm.phase(call[1]), fsm.download_source(call[1])))
        return out
    finally:
        module.time = real


@pytest.mark.parametrize("seed", range(6))
def test_completion_fsm_decisions_match_call_for_call(seed):
    """COMMIT / HOLD / CATCHUP / KEEP / DISCARD_AND_DOWNLOAD, heartbeat
    renewals and losses, commitEnd acceptance and re-election on a failed
    commit or a timed-out claim: the same decision for every call."""
    calls = _script(seed)
    want, got = _drive(r_completion, calls), _drive(p_completion, calls)
    assert got == want
    decided = {d[0] for d in got if isinstance(d, tuple) and isinstance(d[0], str) and d[0].isupper()}
    assert {"COMMIT", "HOLD"} <= decided
