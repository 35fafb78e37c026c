"""pinotlint: project-invariant static analyzer for pinot_tpu_torch.

Fifteen AST checkers (emitting sixteen checks) enforce the conventions the
engine's correctness actually rests on — race discipline, jit purity,
deadline/cancellation coverage, the error-code registry, the fault-point
registry, fault-point span-event coverage on the query path, lock-order
cycles, blocking calls made while a lock is held, resource leaks, atomic
writes to durable artifacts, kernel-registry coverage of the CUDA launch
sites and compiled roots on the kernel path (and a wrapper for every CUDA
launch entry), routing-version bumps on segment-set mutations (query-cache
invalidation), fencing-epoch flow into every lead-path PropertyStore
mutation (fence-discipline), registered QueryErrorCodes on every exception
that can escape an HTTP handler (typed-error-boundary), and the asyncio
readiness pack (event-loop-safety). The whole-program family shares one
call-graph + lock-summary + dataflow build per run
(`core.AnalysisSession` -> `callgraph.ProgramIndex` -> `dataflow`). See
README.md in this directory and the module docstrings for exact rules.

Usage (CLI):   python -m pinot_tpu_torch.devtools.lint pinot_tpu_torch/
Usage (code):  from pinot_tpu_torch.devtools.lint import lint_paths

The port's copy of the JAX package's pinotlint: the same checks, names,
suppression marker and command line, aimed at `pinot_tpu_torch/` paths, with
the port's compiled roots (torch.compile, torch.jit.script, @triton.jit,
CUDA graph capture) and its CUDA launch sites. README.md lists what differs.
"""

from __future__ import annotations

from pinot_tpu_torch.devtools.lint.atomic_write import AtomicWriteChecker
from pinot_tpu_torch.devtools.lint.cache_invalidation import CacheInvalidationChecker
from pinot_tpu_torch.devtools.lint.concurrency import BlockingUnderLockChecker, LockOrderChecker
from pinot_tpu_torch.devtools.lint.core import Checker, Finding, run
from pinot_tpu_torch.devtools.lint.deadlines import DeadlineChecker
from pinot_tpu_torch.devtools.lint.error_codes import ErrorCodeChecker
from pinot_tpu_torch.devtools.lint.event_loop import EventLoopSafetyChecker
from pinot_tpu_torch.devtools.lint.fault_points import FaultPointChecker, FaultSpanEventChecker
from pinot_tpu_torch.devtools.lint.fence import FenceDisciplineChecker
from pinot_tpu_torch.devtools.lint.jit_purity import JitPurityChecker
from pinot_tpu_torch.devtools.lint.kernel_registry import KernelRegistryChecker, launch_inventory
from pinot_tpu_torch.devtools.lint.races import RaceChecker
from pinot_tpu_torch.devtools.lint.resources import ResourceLeakChecker
from pinot_tpu_torch.devtools.lint.typed_errors import TypedErrorBoundaryChecker

#: checker-id -> class, in reporting order. Checker instances hold run state
#: (whole-program accumulation), so callers construct fresh ones per run.
ALL_CHECKERS: dict[str, type[Checker]] = {
    "race-discipline": RaceChecker,
    "jit-purity": JitPurityChecker,
    "deadline-coverage": DeadlineChecker,  # also emits deadline-swallow
    "error-code-registry": ErrorCodeChecker,
    "fault-point-registry": FaultPointChecker,
    "fault-span-event": FaultSpanEventChecker,
    "lock-order": LockOrderChecker,
    "blocking-under-lock": BlockingUnderLockChecker,
    "resource-leak": ResourceLeakChecker,
    "atomic-write": AtomicWriteChecker,
    "kernel-registry": KernelRegistryChecker,
    "cache-invalidation": CacheInvalidationChecker,
    "fence-discipline": FenceDisciplineChecker,
    "typed-error-boundary": TypedErrorBoundaryChecker,
    "event-loop-safety": EventLoopSafetyChecker,
}


def make_checkers(names: list[str] | None = None) -> list[Checker]:
    names = names or list(ALL_CHECKERS)
    unknown = [n for n in names if n not in ALL_CHECKERS]
    if unknown:
        raise KeyError(f"unknown checker(s): {unknown}; known: {sorted(ALL_CHECKERS)}")
    return [ALL_CHECKERS[n]() for n in names]


def lint_paths(
    paths: list[str], checks: list[str] | None = None, require_reason: bool = False
) -> list[Finding]:
    """Run the analyzer over `paths`; returns unsuppressed findings."""
    return run(paths, make_checkers(checks), require_reason=require_reason)


__all__ = ["ALL_CHECKERS", "Checker", "Finding", "launch_inventory", "lint_paths", "make_checkers", "run"]
