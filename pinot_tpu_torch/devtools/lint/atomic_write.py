"""atomic-write: durable artifacts must go through common/durability.py.

A bare `write_text`/`write_bytes`/`open(..., "w")`/`json.dump`/`np.savez`
aimed at a crash-consistency-critical file — a PropertyStore document
(`*.doc.json`), a segment file (`*.ptseg`), or a segment `metadata.json` —
can be torn by a crash mid-write: the old bytes are gone and the new ones
are incomplete, and every reader downstream sees garbage. The durability
helper (tmp file in the same dir -> fsync -> rename -> fsync dir) makes the
swap atomic, so ALL writes to those paths must route through it.

Detection is syntactic: a write-shaped call whose expression tree (receiver
included) carries a string constant containing one of the durable markers.
Paths assembled in a separate statement escape the net — the checker is a
tripwire for the common inline idiom, not a dataflow analysis. Suppress a
true non-durable hit (e.g. a test fixture deliberately writing a torn file)
with a reasoned `# pinotlint: disable=atomic-write — <why>`.
"""

from __future__ import annotations

import ast

from pinot_tpu_torch.devtools.lint.core import Checker, Finding, ModuleInfo

#: substrings that mark a path expression as a durable artifact
_DURABLE_MARKERS = (".doc.json", ".ptseg", "metadata.json")

#: attribute/function names that perform a direct (non-atomic) write
_WRITE_ATTRS = frozenset({"write_text", "write_bytes"})


def _durable_marker_in(node: ast.AST) -> str | None:
    for c in ast.walk(node):
        if isinstance(c, ast.Constant) and isinstance(c.value, str):
            for m in _DURABLE_MARKERS:
                if m in c.value:
                    return m
    return None


def _open_mode(node: ast.Call) -> str | None:
    if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
        return str(node.args[1].value)
    for kw in node.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            return str(kw.value.value)
    return None


class AtomicWriteChecker(Checker):
    name = "atomic-write"

    def check_module(self, module: ModuleInfo) -> list[Finding]:
        p = module.path.replace("\\", "/")
        if p.endswith("common/durability.py"):
            return []  # the one sanctioned writer
        out: list[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _WRITE_ATTRS:
                marker = _durable_marker_in(node)
                if marker:
                    out.append(self._finding(module, node, f.attr, marker))
            elif isinstance(f, ast.Attribute) and f.attr in ("dump", "savez", "savez_compressed"):
                marker = _durable_marker_in(node)
                if marker:
                    out.append(self._finding(module, node, f.attr, marker))
            elif isinstance(f, ast.Name) and f.id == "open":
                mode = _open_mode(node)
                if mode and ("w" in mode or "a" in mode or "x" in mode):
                    marker = _durable_marker_in(node)
                    if marker:
                        out.append(self._finding(module, node, "open", marker))
        return out

    def _finding(self, module: ModuleInfo, node: ast.Call, op: str, marker: str) -> Finding:
        return Finding(
            self.name,
            module.path,
            node.lineno,
            f"direct {op}() to a durable artifact ({marker!r} path) can tear on "
            "crash; route it through pinot_tpu_torch.common.durability.atomic_write_*",
        )
