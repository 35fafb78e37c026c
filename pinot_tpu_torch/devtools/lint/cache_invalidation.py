"""cache-invalidation: segment-set mutations must bump the routing version.

The broker's result and plan caches (cluster/result_cache.py) key on each
table's routing version vector instead of an explicit flush protocol: any
code path that mutates a table's segment set — upload, delete, refresh,
rebalance move, realtime commit, deep-store repair — must call
`bump_routing_version(table)` or a cached response computed against the old
segment set keeps being served forever. That is a silent-staleness bug: no
error, no metric, just wrong rows.

Rule: a function whose body issues a PropertyStore segment-set write — a
`*.store.set(...)` / `*.store.update(...)` call whose argument tree carries a
string constant containing `idealstate` or `/segments/` — must also contain a
`bump_routing_version(...)` call (any receiver). Detection is syntactic, in
the atomic-write mold: path strings assembled in a separate statement escape
the net, and a bump behind a helper called from the same function must be
suppressed with a reasoned `# pinotlint: disable=cache-invalidation — <why>`.

Exempt: cluster/metadata.py (the store itself) and the function that IS the
bump (writes the `/routingversion` doc through the same store API).
"""

from __future__ import annotations

import ast

from pinot_tpu_torch.devtools.lint.core import Checker, Finding, ModuleInfo

#: path substrings that mark a store write as a segment-set mutation
_MUTATION_MARKERS = ("idealstate", "/segments/")


def _mutation_marker_in(node: ast.AST) -> str | None:
    for c in ast.walk(node):
        if isinstance(c, ast.Constant) and isinstance(c.value, str):
            for m in _MUTATION_MARKERS:
                if m in c.value:
                    return m
    return None


def _is_store_write(node: ast.Call) -> bool:
    """`<expr>.store.set(...)`/`.update(...)` or a bare `store.set(...)` —
    receiver must END in `store` so e.g. `self.caches.result.set` never
    matches."""
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr in ("set", "update")):
        return False
    recv = f.value
    if isinstance(recv, ast.Attribute):
        return recv.attr == "store" or recv.attr.endswith("_store")
    if isinstance(recv, ast.Name):
        return recv.id == "store" or recv.id.endswith("_store")
    return False


def _calls_bump(fn: ast.AST) -> bool:
    for c in ast.walk(fn):
        if isinstance(c, ast.Call):
            f = c.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None
            )
            if name == "bump_routing_version":
                return True
    return False


class CacheInvalidationChecker(Checker):
    name = "cache-invalidation"

    def check_module(self, module: ModuleInfo) -> list[Finding]:
        p = module.path.replace("\\", "/")
        if p.endswith("cluster/metadata.py"):
            return []  # the PropertyStore itself
        out: list[Finding] = []
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "bump_routing_version":
                continue  # the sanctioned version writer
            writes = []
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and _is_store_write(node):
                    marker = _mutation_marker_in(node)
                    if marker:
                        writes.append((node, marker))
            if writes and not _calls_bump(fn):
                for node, marker in writes:
                    out.append(
                        Finding(
                            self.name,
                            module.path,
                            node.lineno,
                            f"segment-set mutation ({marker!r} store write) in "
                            f"{fn.name}() without a bump_routing_version() call: "
                            "the broker result/plan caches key on the routing "
                            "version and will serve stale responses forever",
                        )
                    )
        return out
