"""The port's pinotlint (pinot_tpu_torch.devtools.lint) against the JAX
package's, on the reference's golden fixtures, plus the port's own fixtures
and mutations of the port's real files.

- Parity: on every file of tests/lint_fixtures/ (and the cross-module pairs)
  both linters give the same findings for every check but the three whose
  scope is the package itself (jit-purity, kernel-registry,
  fault-span-event), messages compared with the package name swapped.
- The port's fixtures (tests/lint_fixtures_torch/) pin jit-purity over
  torch.compile / torch.jit.script / Triton / CUDA graph roots, and
  kernel-registry's registered-launch and launched-entry rules.
- Mutations of copies of the port's files in tmp_path show each
  path-scoped check reaching `pinot_tpu_torch/` files.
- The whole package lints clean, in process and through the command line.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from pinot_tpu.devtools.lint import ALL_CHECKERS as REF_CHECKERS
from pinot_tpu.devtools.lint import lint_paths as ref_lint_paths
from pinot_tpu_torch.devtools.lint import ALL_CHECKERS, launch_inventory, lint_paths, make_checkers
from pinot_tpu_torch.devtools.lint.callgraph import module_name
from pinot_tpu_torch.devtools.lint.kernel_registry import cuda_launch_entries

REPO = Path(__file__).resolve().parents[1]
REF_FIXTURES = REPO / "tests" / "lint_fixtures"
FIXTURES = REPO / "tests" / "lint_fixtures_torch"
PACKAGE = REPO / "pinot_tpu_torch"
LAUNCH_FIXTURE = FIXTURES / "pinot_tpu_torch" / "ops" / "launch_fixture.py"
ROOTS_FIXTURE = FIXTURES / "pinot_tpu_torch" / "query" / "kernel_roots_fixture.py"
LAUNCH_CU = FIXTURES / "pinot_tpu_torch" / "ops" / "csrc" / "launch_fixture.cu"

#: the checks whose scope is the package's own paths or compilers: held by
#: the port's fixtures below instead of by parity
PACKAGE_SCOPED = ("jit-purity", "kernel-registry", "fault-span-event")
PARITY_CHECKERS = [c for c in ALL_CHECKERS if c not in PACKAGE_SCOPED]

#: the port's five CUDA launch entries and the names they launch under
INVENTORY = {
    "grouped_extremes": "ops.grouped_extreme",
    "grouped_sum_count": "ops.grouped_planes",
    "grouped_sum_count_2l": "ops.grouped_planes2",
    "grouped_sum_f32": "ops.grouped_sum",
    "presences": "ops.grouped_sum",
}


def lines_of(findings, check: str) -> list[int]:
    return sorted(f.line for f in findings if f.check == check)


def _swap(message: str) -> str:
    return message.replace("pinot_tpu.", "pinot_tpu_torch.").replace("pinot_tpu/", "pinot_tpu_torch/")


# ---------------------------------------------------------------------------
# parity with the reference on its own fixtures
# ---------------------------------------------------------------------------


PARITY_SETS = [[p.name] for p in sorted(REF_FIXTURES.glob("*.py"))] + [
    ["lockorder_mod_a.py", "lockorder_mod_b.py"],
    ["race_mod_base.py", "race_mod_sub.py"],
    ["fence_mod_a.py", "fence_mod_b.py"],
    ["."],
]


def test_same_checkers_as_reference():
    assert list(ALL_CHECKERS) == list(REF_CHECKERS)
    assert len(ALL_CHECKERS) == 15


@pytest.mark.parametrize("names", PARITY_SETS, ids=["+".join(s) for s in PARITY_SETS])
def test_parity_with_reference_on_its_fixtures(names):
    paths = [str(REF_FIXTURES / n) for n in names]
    ref = ref_lint_paths(paths, checks=PARITY_CHECKERS, require_reason=True)
    port = lint_paths(paths, checks=PARITY_CHECKERS, require_reason=True)
    assert [(f.check, f.path, f.line) for f in port] == [(f.check, f.path, f.line) for f in ref]
    assert [f.message for f in port] == [_swap(f.message) for f in ref]


def test_parity_covers_every_check_but_the_package_scoped_ones():
    """The whole fixture directory fires each parity check at least once."""
    fs = lint_paths([str(REF_FIXTURES)], checks=PARITY_CHECKERS)
    fired = {f.check for f in fs}
    assert fired >= set(PARITY_CHECKERS) | {"deadline-swallow"}


def test_span_fixture_parity_under_the_port(tmp_path):
    original = REF_FIXTURES / "pinot_tpu" / "query" / "span_fixture.py"
    copy = tmp_path / "pinot_tpu_torch" / "query" / "span_fixture.py"
    copy.parent.mkdir(parents=True)
    shutil.copy(original, copy)
    ref = ref_lint_paths([str(original)], checks=["fault-span-event"])
    port = lint_paths([str(copy)], checks=["fault-span-event"])
    assert lines_of(port, "fault-span-event") == lines_of(ref, "fault-span-event") == [12, 27]
    assert [f.message for f in port] == [f.message for f in ref]
    # the reference's own path is out of the port's scope
    assert lint_paths([str(original)], checks=["fault-span-event"]) == []


# ---------------------------------------------------------------------------
# the port's compiled roots: jit-purity
# ---------------------------------------------------------------------------


def test_jit_fixture_findings():
    fs = lint_paths([str(FIXTURES / "jit_fixture.py")], checks=["jit-purity"])
    assert lines_of(fs, "jit-purity") == [15, 28, 42, 54, 61]
    by_line = {f.line: f.message for f in fs}
    assert "time.perf_counter" in by_line[15]
    assert "'y'" in by_line[28]  # branch on a non-static parameter
    assert "_cache" in by_line[42]  # closed-over mutation
    assert "print" in by_line[54]  # torch.compile(run) of a nested def
    assert "time.sleep" in by_line[61]  # transitively reached helper


def test_jit_fixture_lines_match_the_reference_fixture():
    ref = ref_lint_paths([str(REF_FIXTURES / "jit_fixture.py")], checks=["jit-purity"])
    port = lint_paths([str(FIXTURES / "jit_fixture.py")], checks=["jit-purity"])
    assert lines_of(port, "jit-purity") == lines_of(ref, "jit-purity")


def test_jit_capture_fixture_findings():
    fs = lint_paths([str(FIXTURES / "jit_capture_fixture.py")], checks=["jit-purity"])
    assert lines_of(fs, "jit-purity") == [17, 26, 30, 37, 52, 53, 57]
    by_line = {f.line: f.message for f in fs}
    assert "logging.info" in by_line[17]  # torch.jit.script
    assert "'n'" in by_line[26]  # Triton: only tl.constexpr is static
    assert "print" in by_line[30]  # torch.compile of a lambda
    assert "'flag'" in by_line[37]  # .device is static, flag is not
    assert "_graphs" in by_line[52]  # module state stored at capture
    assert "'n'" in by_line[53]  # branch decided once, at capture
    assert "logging.debug" in by_line[57]


@pytest.mark.parametrize(
    "name, line",
    [("jit_fixture.py", 48), ("jit_capture_fixture.py", 64)],
)
def test_jit_suppressions(name, line):
    fs = lint_paths([str(FIXTURES / name)], checks=["jit-purity"])
    assert line not in {f.line for f in fs}
    src = (FIXTURES / name).read_text().splitlines()[line - 1]
    assert "pinotlint: disable=jit-purity" in src


def test_jax_jit_is_no_root_of_the_port():
    """The reference's fixture compiles with jax.jit: the port's checker
    matches its own compilers by name and sees no root there."""
    assert lint_paths([str(REF_FIXTURES / "jit_fixture.py")], checks=["jit-purity"]) == []


# ---------------------------------------------------------------------------
# the port's launch sites: kernel-registry
# ---------------------------------------------------------------------------


def test_launch_fixture_findings():
    fs = lint_paths([str(LAUNCH_FIXTURE)], checks=["kernel-registry"])
    py = [f for f in fs if f.path.endswith(".py")]
    assert [f.line for f in py] == [21, 26, 31, 38]
    assert all(f.message.startswith("registered-launch: ") for f in py)
    by_line = {f.line: f.message for f in py}
    assert "'fx_unwrapped'" in by_line[21] and "outside KERNELS.launch" in by_line[21]
    assert "'fx.unknown'" in by_line[26] and "KERNELS.register" in by_line[26]
    assert "not a string literal" in by_line[31]
    assert "'fx_by_reference'" in by_line[38]  # a def handed by name is not lexically inside
    # the host query, the attribute store and the suppressed warm-up stay quiet
    assert not any(e in f.message for f in fs for e in ("fx_plan", "fx_registered"))


def test_launched_entry_fixture_finding():
    fs = lint_paths([str(LAUNCH_FIXTURE)], checks=["kernel-registry"])
    cu = [f for f in fs if f.path.endswith(".cu")]
    assert [(Path(f.path).name, f.line) for f in cu] == [("launch_fixture.cu", 22)]
    assert cu[0].message.startswith("launched-entry: ") and "'fx_dead'" in cu[0].message


def test_cuda_launch_entries_of_fixture():
    """Stream-taking definitions only: no host query, no commented-out or
    declared-only entry."""
    entries = cuda_launch_entries(LAUNCH_CU.parent)
    assert sorted(entries) == sorted(
        ["fx_registered", "fx_unwrapped", "fx_unregistered", "fx_dynamic_name", "fx_by_reference", "fx_dead"]
    )
    assert entries["fx_dead"][1] == 22


def test_kernel_roots_fixture_findings():
    fs = lint_paths([str(ROOTS_FIXTURE)], checks=["kernel-registry"])
    assert [f.line for f in fs] == [39, 48, 52, 56, 68, 72, 110]
    by_line = {f.line: f.message for f in fs}
    assert "'_orphan'" in by_line[39] and "never launched" in by_line[39]
    assert "'_bare'" in by_line[48]  # kernel[grid](...) outside a launch
    assert "'_fused'" in by_line[52]
    assert "'fx.compiled'" in by_line[56]  # torch.compile(f) alias under an unregistered name
    assert "g2" in by_line[68]  # replay outside a launch
    assert "g3" in by_line[72]  # captured, never replayed here
    # a replay in a program record under an unregistered name
    assert "g7" in by_line[110] and "'fx.unregistered'" in by_line[110]
    # the registered Triton launch, the root named by a register call, the
    # replay under a registered name, the suppressed capture and the replays
    # inside a registered program record (KERNELS.program's body,
    # KERNELS.timed_sync's arguments) of the port's capture stay quiet
    for clean in ("_add_one", "_registered_elsewhere", "graph graph", "g4", "g5", "g6"):
        assert not any(clean in f.message for f in fs)


def test_kernel_registry_ignores_off_kernel_path(tmp_path):
    copy = tmp_path / "pinot_tpu_torch" / "cluster" / "launch_fixture.py"
    copy.parent.mkdir(parents=True)
    shutil.copy(LAUNCH_FIXTURE, copy)
    assert lint_paths([str(copy)], checks=["kernel-registry"]) == []
    # and outside any pinot_tpu_torch directory
    assert lint_paths([str(FIXTURES / "jit_fixture.py")], checks=["kernel-registry"]) == []


def test_launch_inventory_of_the_package():
    assert launch_inventory([str(PACKAGE)]) == INVENTORY


def test_launch_entries_of_the_package():
    entries = cuda_launch_entries(PACKAGE / "ops" / "csrc")
    got = {e: (Path(p).name, line) for e, (p, line) in entries.items()}
    assert got == {
        "grouped_sum_count": ("grouped_sum_count.cu", 169),
        "grouped_sum_count_2l": ("grouped_sum_count_2l.cu", 460),
        "grouped_extremes": ("grouped_extreme.cu", 303),
        "grouped_sum_f32": ("grouped_sum_f32.cu", 194),
        "presences": ("grouped_sum_f32.cu", 247),
    }


# ---------------------------------------------------------------------------
# mutations: the checks reach the port's real files
# ---------------------------------------------------------------------------


def _copy_ops(tmp_path) -> Path:
    ops = tmp_path / "pinot_tpu_torch" / "ops"
    shutil.copytree(PACKAGE / "ops", ops, ignore=shutil.ignore_patterns("__pycache__"))
    return ops


def _mutate(path: Path, old: str, new: str) -> int:
    """Replace the one `old` in `path`; returns the line it started on."""
    src = path.read_text()
    assert src.count(old) == 1, old
    path.write_text(src.replace(old, new))
    return src[: src.index(old)].count("\n") + 1


def test_unregistered_launch_in_a_copy_of_ops(tmp_path):
    ops = _copy_ops(tmp_path)
    assert lint_paths([str(ops)], checks=["kernel-registry"]) == []
    groupby = ops / "groupby.py"
    src = groupby.read_text()
    start = src.index('KERNELS.register(\n    "ops.grouped_planes",\n')
    groupby.write_text(src[:start] + src[src.index("\n)\n", start) + 3 :])  # the registration removed
    fs = lint_paths([str(ops)], checks=["kernel-registry"])
    assert fs and all(Path(f.path).name == "groupby.py" for f in fs), fs
    assert any("'grouped_sum_count'" in f.message and "'ops.grouped_planes'" in f.message for f in fs)


def test_unlaunched_entry_in_a_copy_of_ops(tmp_path):
    ops = _copy_ops(tmp_path)
    cu = ops / "csrc" / "grouped_sum_f32.cu"
    src = cu.read_text()
    cu.write_text(src + '\nextern "C" int grouped_sum_f32_spare(const void* values, long long n, void* stream) {\n'
                  "  return 0;\n}\n")
    fs = lint_paths([str(ops)], checks=["kernel-registry"])
    assert [(Path(f.path).name, f.line) for f in fs] == [("grouped_sum_f32.cu", src.count("\n") + 2)]
    assert fs[0].message.startswith("launched-entry: ") and "grouped_sum_f32_spare" in fs[0].message
    assert launch_inventory([str(ops)]) == INVENTORY


def test_launch_outside_the_registry_in_a_copy_of_ops(tmp_path):
    ops = _copy_ops(tmp_path)
    line = _mutate(ops / "extreme.py", 'err = KERNELS.launch("ops.grouped_extreme", lambda: lib.grouped_extremes(',
                   'err = _unobserved("ops.grouped_extreme", lambda: lib.grouped_extremes(')
    fs = lint_paths([str(ops)], checks=["kernel-registry"])
    assert [(Path(f.path).name, f.line) for f in fs] == [("extreme.py", line)]
    assert "outside KERNELS.launch" in fs[0].message


def test_dropped_suppression_in_a_copy_of_runtime(tmp_path):
    runtime = tmp_path / "pinot_tpu_torch" / "multistage" / "runtime.py"
    runtime.parent.mkdir(parents=True)
    shutil.copy(PACKAGE / "multistage" / "runtime.py", runtime)
    assert lint_paths([str(runtime)], checks=["deadline-coverage"]) == []
    line = _mutate(runtime, "except Exception:  # pinotlint: disable=deadline-swallow — best-effort marker forwarding",
                   "except Exception:  # best-effort marker forwarding")
    fs = lint_paths([str(runtime)], checks=["deadline-coverage"])
    assert [(f.check, f.line) for f in fs] == [("deadline-swallow", line)]


def test_span_event_dropped_in_a_copy_of_the_engine(tmp_path):
    engine = tmp_path / "pinot_tpu_torch" / "query" / "engine.py"
    engine.parent.mkdir(parents=True)
    shutil.copy(PACKAGE / "query" / "engine.py", engine)
    assert lint_paths([str(engine)], checks=["fault-span-event"]) == []
    src = engine.read_text()
    event = 'trace_event("fault.injected", point="segment.execute", segment=seg.name)'
    engine.write_text(src.replace(event, "pass", 1))
    fs = lint_paths([str(engine)], checks=["fault-span-event"])
    assert len(fs) == 1 and "_dispatch_all" in fs[0].message
    assert "maybe_fail" in engine.read_text().splitlines()[fs[0].line - 1]


def test_bump_moved_out_of_update_ideal_in_a_copy_of_the_controller(tmp_path):
    controller = tmp_path / "pinot_tpu_torch" / "cluster" / "controller.py"
    controller.parent.mkdir(parents=True)
    shutil.copy(PACKAGE / "cluster" / "controller.py", controller)
    assert lint_paths([str(controller)], checks=["cache-invalidation"]) == []
    line = _mutate(controller, '        self.store.update(f"/tables/{table}/idealstate", edit, fence=self.lease_fence())\n'
                   "        self.bump_routing_version(table)\n",
                   '        self.store.update(f"/tables/{table}/idealstate", edit, fence=self.lease_fence())\n')
    fs = lint_paths([str(controller)], checks=["cache-invalidation"])
    assert [(f.line, "_update_ideal" in f.message) for f in fs] == [(line, True)]


def test_module_names_root_at_the_port():
    assert module_name("/x/pinot_tpu_torch/query/plan.py") == "pinot_tpu_torch.query.plan"
    assert module_name("pinot_tpu_torch/cluster/__init__.py") == "pinot_tpu_torch.cluster"
    assert module_name(str(PACKAGE / "multistage" / "plan.py")) == "pinot_tpu_torch.multistage.plan"
    # a fixture outside any package keeps its bare stem
    assert module_name(str(REF_FIXTURES / "race_fixture.py")) == "race_fixture"


@pytest.mark.parametrize(
    "pair, check, want",
    [
        (("lockorder_mod_a.py", "lockorder_mod_b.py"), "lock-order",
         [("lockorder_mod_a.py", 10), ("lockorder_mod_b.py", 17)]),
        (("race_mod_base.py", "race_mod_sub.py"), "race-discipline", [("race_mod_base.py", 15)]),
        (("fence_mod_a.py", "fence_mod_b.py"), "fence-discipline", [("fence_mod_a.py", 25)]),
    ],
    ids=["lock-order", "race-discipline", "fence-discipline"],
)
def test_cross_module_analyses_under_a_port_path(tmp_path, pair, check, want):
    """The reference's cross-module pairs moved into a pinot_tpu_torch
    package, their imports rewritten to the package's dotted names: the
    edges only join when module names are rooted at the port."""
    pkg = tmp_path / "pinot_tpu_torch" / "cluster"
    pkg.mkdir(parents=True)
    stems = [Path(n).stem for n in pair]
    for name in pair:
        src = (REF_FIXTURES / name).read_text()
        for stem in stems:
            src = src.replace(f"from {stem} import", f"from pinot_tpu_torch.cluster.{stem} import")
        (pkg / name).write_text(src)
    fs = lint_paths([str(pkg / n) for n in pair], checks=[check])
    assert sorted((Path(f.path).name, f.line) for f in fs) == want
    # relative imports join the same edges
    for name in pair:
        src = (pkg / name).read_text().replace("from pinot_tpu_torch.cluster.", "from .")
        (pkg / name).write_text(src)
    fs = lint_paths([str(pkg / n) for n in pair], checks=[check])
    assert sorted((Path(f.path).name, f.line) for f in fs) == want


# ---------------------------------------------------------------------------
# framework behavior and the command line, against the port's module
# ---------------------------------------------------------------------------


def _cli(*args: str):
    return subprocess.run(
        [sys.executable, "-m", "pinot_tpu_torch.devtools.lint", *args],
        capture_output=True,
        text=True,
        cwd=REPO,
        timeout=120,
    )


def test_require_reason_flags_bare_suppressions(tmp_path):
    bare = tmp_path / "bare.py"
    bare.write_text("x = {'errorCode': 1}  # pinotlint: disable=error-code-registry\n")
    fs = lint_paths([str(bare)], require_reason=True)
    assert [(f.check, f.line) for f in fs] == [("suppression-reason", 1)]


def test_suppression_only_covers_named_check():
    fs = lint_paths([str(REF_FIXTURES / "deadline_fixture.py")], checks=["deadline-coverage"])
    assert 33 in {f.line for f in fs}
    assert 70 not in {f.line for f in fs}


def test_parse_error_becomes_finding(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    assert [f.check for f in lint_paths([str(bad)])] == ["parse-error"]


def test_unknown_checker_rejected():
    with pytest.raises(KeyError):
        make_checkers(["no-such-check"])


def test_findings_sorted_and_stringify():
    fs = lint_paths([str(REF_FIXTURES / "errcode_fixture.py")], checks=["error-code-registry"])
    assert fs == sorted(fs, key=lambda f: (f.path, f.line, f.check, f.message))
    assert str(fs[0]).endswith(f":{fs[0].line}: [error-code-registry] {fs[0].message}")


@pytest.mark.parametrize(
    "path",
    [
        REF_FIXTURES / "race_fixture.py",
        REF_FIXTURES / "deadline_fixture.py",
        REF_FIXTURES / "errcode_fixture.py",
        REF_FIXTURES / "fault_fixture.py",
        FIXTURES / "jit_fixture.py",
        LAUNCH_FIXTURE,
    ],
    ids=lambda p: p.name,
)
def test_cli_nonzero_on_fixture(path):
    proc = _cli(str(path))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert path.name in proc.stdout


def test_cli_list_checkers():
    proc = _cli("--list")
    assert proc.returncode == 0
    listed = [line.split(":", 1)[0] for line in proc.stdout.splitlines()]
    assert listed == list(ALL_CHECKERS)


def test_cli_usage_errors(tmp_path):
    assert _cli("--check", "bogus", str(REF_FIXTURES / "errcode_fixture.py")).returncode == 2
    assert _cli().returncode == 2  # no paths
    assert _cli("--update-baseline", str(REF_FIXTURES / "resleak_fixture.py")).returncode == 2
    assert _cli(str(tmp_path / "missing.txt")).returncode == 2


def test_cli_json_output():
    proc = _cli("--json", "--check", "resource-leak", str(REF_FIXTURES / "resleak_fixture.py"))
    assert proc.returncode == 1
    findings = json.loads(proc.stdout)
    assert sorted(f["line"] for f in findings) == [15, 20, 22, 27]
    assert all(set(f) == {"check", "path", "line", "message"} for f in findings)


def test_baseline_roundtrip_and_new_finding(tmp_path):
    base = tmp_path / "baseline.json"
    fixture = str(REF_FIXTURES / "resleak_fixture.py")
    proc = _cli("--check", "resource-leak", "--baseline", str(base), "--update-baseline", fixture)
    assert proc.returncode == 0, proc.stderr
    proc = _cli("--check", "resource-leak", "--baseline", str(base), fixture)
    assert proc.returncode == 0 and "clean" in proc.stderr, proc.stdout + proc.stderr
    doc = json.loads(base.read_text())
    assert len(doc["findings"]) == 4
    doc["findings"] = doc["findings"][1:]
    base.write_text(json.dumps(doc))
    proc = _cli("--check", "resource-leak", "--baseline", str(base), fixture)
    assert proc.returncode == 1 and "1 new finding" in proc.stderr


def test_baseline_keys_ignore_line_drift(tmp_path):
    base = tmp_path / "baseline.json"
    shifted = tmp_path / "resleak_fixture.py"
    original = (REF_FIXTURES / "resleak_fixture.py").read_text()
    shifted.write_text(original)
    _cli("--check", "resource-leak", "--baseline", str(base), "--update-baseline", str(shifted))
    shifted.write_text("# drift\n# drift\n" + original)
    proc = _cli("--check", "resource-leak", "--baseline", str(base), str(shifted))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_checked_in_baseline_is_empty():
    doc = json.loads((PACKAGE / "devtools" / "lint" / "baseline.json").read_text())
    assert doc == {"version": 1, "findings": []}


def _git(cwd, *args: str):
    return subprocess.run(["git", "-C", str(cwd), *args], capture_output=True, text=True, timeout=60)


def _diff_repo(tmp_path) -> Path:
    repo = tmp_path / "repo"
    repo.mkdir()
    _git(repo, "init", "-q")
    _git(repo, "config", "user.email", "lint@test")
    _git(repo, "config", "user.name", "lint test")
    return repo


def test_cli_diff_reports_only_changed_lines(tmp_path):
    repo = _diff_repo(tmp_path)
    target = repo / "errcode_fixture.py"
    original = (REF_FIXTURES / "errcode_fixture.py").read_text()
    target.write_text(original)
    _git(repo, "add", ".")
    _git(repo, "commit", "-qm", "seed")
    proc = _cli("--check", "error-code-registry", "--diff", "HEAD", str(target))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    mutated = original + "\n\ndef added():\n    return {'errorCode': 250}\n"
    target.write_text(mutated)
    proc = _cli("--check", "error-code-registry", "--diff", "HEAD", str(target))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    lines = [line for line in proc.stdout.splitlines() if "[error-code-registry]" in line]
    assert len(lines) == 1 and f":{len(mutated.splitlines())}:" in lines[0]


def test_cli_diff_untracked_file_reports_full(tmp_path):
    repo = _diff_repo(tmp_path)
    (repo / "seed.py").write_text("x = 1\n")
    _git(repo, "add", ".")
    _git(repo, "commit", "-qm", "seed")
    target = repo / "errcode_fixture.py"
    target.write_text((REF_FIXTURES / "errcode_fixture.py").read_text())
    proc = _cli("--check", "error-code-registry", "--diff", "HEAD", str(target))
    assert proc.returncode == 1
    assert len([line for line in proc.stdout.splitlines() if "[error-code-registry]" in line]) == 4


def test_cli_diff_reads_changed_cuda_lines(tmp_path):
    """A launched-entry finding lands in a .cu file: --diff reports it when
    that line changed, and not before."""
    repo = _diff_repo(tmp_path)
    ops = repo / "pinot_tpu_torch" / "ops"
    shutil.copytree(PACKAGE / "ops", ops, ignore=shutil.ignore_patterns("__pycache__"))
    _git(repo, "add", ".")
    _git(repo, "commit", "-qm", "seed")
    proc = _cli("--check", "kernel-registry", "--diff", "HEAD", str(ops))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    cu = ops / "csrc" / "grouped_extreme.cu"
    cu.write_text(cu.read_text() + '\nextern "C" int grouped_extremes_spare(void* stream) { return 0; }\n')
    proc = _cli("--check", "kernel-registry", "--diff", "HEAD", str(ops))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "grouped_extremes_spare" in proc.stdout and "grouped_extreme.cu:" in proc.stdout


def test_cli_diff_bad_ref_is_usage_error():
    proc = _cli("--check", "error-code-registry", "--diff", "no-such-ref", str(REF_FIXTURES / "errcode_fixture.py"))
    assert proc.returncode == 2 and "no-such-ref" in proc.stderr


def test_linter_imports_nothing_heavy():
    """The linter runs on a machine with no torch: importing it and linting
    a file loads no torch, numpy, jax, pandas or JAX-package module."""
    code = (
        "import sys\n"
        "from pinot_tpu_torch.devtools.lint.__main__ import main\n"
        f"rc = main(['--check', 'kernel-registry', {str(LAUNCH_FIXTURE)!r}])\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'jaxlib', 'pandas', 'pinot_tpu'))\n"
        "print(rc, heavy)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "1 []"


# ---------------------------------------------------------------------------
# the port lints clean
# ---------------------------------------------------------------------------


def test_package_lints_clean():
    fs = lint_paths([str(PACKAGE)], require_reason=True)
    assert fs == [], "\n".join(str(f) for f in fs)


def test_cli_clean_on_package():
    proc = _cli("--require-reason", "--json", os.path.relpath(PACKAGE, REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout) == []
    assert "clean" in proc.stderr
