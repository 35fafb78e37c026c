"""fault-point-registry: every `FAULTS.maybe_fail("<point>")` call site must
name a point declared in a `FAULT_POINTS` registry, and every declared point
must have at least one call site.

Without this, a chaos test can configure a rule for a point the production
code no longer calls through — the test silently stops injecting anything
and keeps passing. The registry lives in `pinot_tpu_torch/common/faults.py`
(`FAULT_POINTS = frozenset({...})`); the checker discovers it syntactically
in the analyzed file set, so golden fixtures can declare their own.

fault-span-event: inside the query path (pinot_tpu_torch/query|multistage|cluster),
every function that calls `maybe_fail(...)` must also emit a trace span event
(a `trace_event(...)` or `.add_event(...)` call) in the same lexical scope —
an injected fault that leaves no mark in the assembled distributed trace is
invisible to whoever debugs the resulting failure. Suppress with a reasoned
`# pinotlint: disable=fault-span-event — <why>` when the site genuinely has
no trace to write to.
"""

from __future__ import annotations

import ast

from pinot_tpu_torch.devtools.lint.core import Checker, Finding, ModuleInfo, in_package_dirs, walk_scope


class FaultPointChecker(Checker):
    name = "fault-point-registry"

    def __init__(self):
        # point -> list of (path, line) call sites
        self._sites: dict[str, list[tuple[str, int]]] = {}
        self._non_literal: list[tuple[str, int]] = []
        # declared point -> (path, line of the registry literal)
        self._registry: dict[str, tuple[str, int]] = {}
        self._registry_seen = False

    def check_module(self, module: ModuleInfo) -> list[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute) and fn.attr == "maybe_fail":
                    if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                        self._sites.setdefault(node.args[0].value, []).append((module.path, node.lineno))
                    else:
                        self._non_literal.append((module.path, node.lineno))
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id == "FAULT_POINTS":
                        self._registry_seen = True
                        for c in ast.walk(node.value):
                            if isinstance(c, ast.Constant) and isinstance(c.value, str):
                                self._registry.setdefault(c.value, (module.path, c.lineno))
        return []

    def finalize(self, modules) -> list[Finding]:
        out: list[Finding] = []
        for path, line in self._non_literal:
            out.append(
                Finding(self.name, path, line, "maybe_fail() point must be a string literal so the registry can be checked")
            )
        if not self._registry_seen:
            if self._sites:
                path, line = next(iter(self._sites.values()))[0]
                out.append(Finding(self.name, path, line, "no FAULT_POINTS registry declared in the analyzed files"))
            return out
        for point, sites in sorted(self._sites.items()):
            if point not in self._registry:
                for path, line in sites:
                    out.append(Finding(self.name, path, line, f"fault point {point!r} is not declared in FAULT_POINTS"))
        for point, (path, line) in sorted(self._registry.items()):
            if point not in self._sites:
                out.append(
                    Finding(self.name, path, line, f"declared fault point {point!r} has no maybe_fail() call site (dead point)")
                )
        return out


#: directories whose fault points sit on the query path and therefore must be
#: visible in the assembled distributed trace
_QUERY_PATH_DIRS = ("query", "multistage", "cluster")


def _on_query_path(path: str) -> bool:
    return in_package_dirs(path, _QUERY_PATH_DIRS)


class FaultSpanEventChecker(Checker):
    """Per-file pass: each function in a query-path module that crosses a
    fault point must also record a span event in the same lexical scope."""

    name = "fault-span-event"

    def check_module(self, module: ModuleInfo) -> list[Finding]:
        if not _on_query_path(module.path):
            return []
        out: list[Finding] = []
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            fail_lines: list[int] = []
            emits_event = False
            for node in walk_scope(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "maybe_fail":
                    fail_lines.append(node.lineno)
                elif isinstance(f, ast.Name) and f.id == "trace_event":
                    emits_event = True
                elif isinstance(f, ast.Attribute) and f.attr == "add_event":
                    emits_event = True
            if fail_lines and not emits_event:
                for line in fail_lines:
                    out.append(
                        Finding(
                            self.name,
                            module.path,
                            line,
                            f"query-path fault point in {fn.name}() emits no trace span event "
                            "(call trace_event(...) so injected faults show in the assembled trace)",
                        )
                    )
        return out
