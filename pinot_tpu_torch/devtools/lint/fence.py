"""fence-discipline: every lead-path PropertyStore mutation carries a fence
that dataflows from the lease epoch.

The controller's fencing protocol makes split-brain writes impossible ONLY if every
mutating `PropertyStore` call (`set`/`cas`/`delete`/`update`) on a path a
deposed leader can still be executing carries `fence=<epoch observed when
leadership was won>`. This checker closes the loop in CI:

1. **Entry points** (the lead path): methods of `Controller` /
   `TransitionManager` subclasses, `run_once`/`process_table` of
   `ControllerPeriodicTask` subclasses (periodic tasks incl. the scrubber),
   top-level `rebalance*` functions, callbacks passed as `on_gain=` /
   `on_lose=` to `LeaderElection(...)`, and mutating HTTP handlers
   (`do_POST`/`do_PUT`/`do_DELETE`).
2. **Reachability**: BFS over resolved calls from every entry, keeping a
   witness chain for the message.
3. **Sinks**: calls whose receiver is a `PropertyStore` (resolved type, or a
   receiver spelled `...store.<mutator>` / `..._store.<mutator>`) with a
   mutator method name.
4. **Dataflow**: the `fence=` argument must carry the lease-epoch taint
   (`<election>.epoch` reads, `lease_fence()`-style wrappers, values routed
   through locals/attributes/returns). A fence that is a bare parameter of
   the enclosing function moves the obligation to every lead-path CALLER —
   the k-limited interprocedural hop.

Designed exemptions: `cluster/metadata.py` (the store's own internals; the
election CAS closure inside `update()` IS the arbiter) and writes to the
lease path itself (`LEASE_PATH` writes are unfenced by design — fencing the
lease write would deadlock elections).

Known false-positive / false-negative shapes:
- a fence fetched through a container or computed arithmetic keeps taint
  (union semantics) — a fence deliberately REPLACED by junk inside such an
  expression still looks tainted (FP suppressed by design choice);
- store handles reached through dynamic dispatch (e.g. a controller object
  handed to realtime/minion code as an untyped attribute) resolve to no
  edges, so those writes are invisible here (FN) — they are covered by the
  runtime fence check itself;
- entry-point discovery is name-based: a lead-path entry spelled outside
  the recognized shapes is not traversed (FN).
"""

from __future__ import annotations

import ast

from pinot_tpu_torch.devtools.lint.core import Checker, Finding, dotted_name
from pinot_tpu_torch.devtools.lint.callgraph import FuncInfo, ProgramIndex
from pinot_tpu_torch.devtools.lint.dataflow import (
    SRC,
    TaintSpec,
    arg_expr_for_param,
)

_MUTATORS = {"set", "cas", "delete", "update"}
_HANDLER_ENTRIES = {"do_POST", "do_PUT", "do_DELETE"}
_ENTRY_CLASSES = {"Controller", "TransitionManager"}
_PERIODIC_BASE = "ControllerPeriodicTask"
_PERIODIC_ENTRIES = {"run_once", "process_table"}


class EpochTaintSpec(TaintSpec):
    """Source = a read of the lease epoch: `.epoch`/`._epoch` on a receiver
    that is a `LeaderElection` (resolved type) or election/lease-ish by
    name. Name fallback matters: `self.election` is often assigned from an
    untyped parameter."""

    name = "lease-epoch"

    def is_source(self, idx: ProgramIndex, fi: FuncInfo, expr: ast.AST) -> bool:
        if not (isinstance(expr, ast.Attribute) and expr.attr in ("epoch", "_epoch")):
            return False
        recv = dotted_name(expr.value)
        if not recv:
            return False
        ci = idx._type_of_expr(fi, recv)
        if ci is not None and any(c.name == "LeaderElection" for c in idx.mro(ci)):
            return True
        leaf = recv.rsplit(".", 1)[-1].lower()
        return "election" in leaf or "lease" in leaf


def _is_exempt_module(path: str) -> bool:
    return path.replace("\\", "/").endswith("cluster/metadata.py")


def _is_lease_path_write(call: ast.Call) -> bool:
    if not call.args:
        return False
    first = call.args[0]
    if isinstance(first, ast.Constant) and isinstance(first.value, str):
        return "lease" in first.value.lower()
    d = dotted_name(first)
    return d.rsplit(".", 1)[-1] == "LEASE_PATH"


class FenceDisciplineChecker(Checker):
    name = "fence-discipline"

    def finalize(self, modules) -> list[Finding]:
        idx = self.session.index
        taint = idx.taint(EpochTaintSpec())
        reach = self._lead_reachable(idx)
        out: list[Finding] = []
        #: (qname, param) -> entry short whose obligation moved to callers
        reqs: dict[tuple[str, str], str] = {}

        for q, entry in reach.items():
            fi = idx.functions[q]
            if _is_exempt_module(fi.module.path):
                continue
            for call in fi.calls:
                if not self._is_store_mutation(idx, fi, call):
                    continue
                if _is_lease_path_write(call.node):
                    continue
                meth = call.dotted.rsplit(".", 1)[-1]
                fence = next((kw.value for kw in call.node.keywords if kw.arg == "fence"), None)
                if fence is None:
                    out.append(self._finding(fi, call.line, meth, entry, "omits fence="))
                    continue
                toks = taint.expr_tokens(fi, fence)
                if SRC in toks:
                    continue
                params = [t.split(":", 1)[1] for t in toks if t.startswith("param:")]
                if params:
                    for p in params:
                        reqs.setdefault((q, p), entry)
                    continue
                out.append(
                    self._finding(
                        fi, call.line, meth, entry, "passes a fence that does not flow from the lease epoch"
                    )
                )

        out.extend(self._propagate_requirements(idx, taint, reach, reqs))
        return out

    # -- entry points + reachability ----------------------------------------

    def _lead_reachable(self, idx: ProgramIndex) -> dict[str, str]:
        """qname -> entry description for every function on the lead path."""
        entries: dict[str, str] = {}
        for ci in idx.classes.values():
            names = {c.name for c in idx.mro(ci)}
            if names & _ENTRY_CLASSES:
                for m in ci.methods.values():
                    entries.setdefault(m.qname, f"{ci.name}.{m.short}")
            if _PERIODIC_BASE in names and ci.name != _PERIODIC_BASE:
                for mname in _PERIODIC_ENTRIES:
                    m = ci.methods.get(mname)
                    if m is not None:
                        entries.setdefault(m.qname, f"{ci.name}.{mname}")
        for fi in idx.functions.values():
            if fi.cls is None and fi.parent is None and fi.short.startswith("rebalance"):
                entries.setdefault(fi.qname, f"{fi.short}()")
            if fi.short in _HANDLER_ENTRIES:
                entries.setdefault(fi.qname, f"HTTP {fi.short}")
            for call in fi.calls:
                if call.dotted.rsplit(".", 1)[-1] != "LeaderElection":
                    continue
                for kw in call.node.keywords:
                    if kw.arg in ("on_gain", "on_lose"):
                        cb = self._resolve_func_ref(idx, fi, kw.value)
                        if cb is not None:
                            entries.setdefault(cb, f"LeaderElection {kw.arg} callback")
        # BFS over resolved calls
        reach = dict(entries)
        work = list(entries)
        while work:
            q = work.pop()
            fi = idx.functions.get(q)
            if fi is None:
                continue
            for call in fi.calls:
                if call.callee is not None and call.callee not in reach:
                    reach[call.callee] = reach[q]
                    work.append(call.callee)
        return reach

    @staticmethod
    def _resolve_func_ref(idx: ProgramIndex, fi: FuncInfo, expr: ast.AST) -> str | None:
        """Resolve a function REFERENCE (not a call): `on_gain=self._won`,
        `on_gain=local_fn`, `on_gain=mod.fn`."""
        d = dotted_name(expr)
        if not d:
            return None
        fake = ast.Call(func=expr, args=[], keywords=[])
        return idx.resolve_call(fi, fake)

    # -- sinks ---------------------------------------------------------------

    @staticmethod
    def _is_store_mutation(idx: ProgramIndex, fi: FuncInfo, call) -> bool:
        d = call.dotted
        if "." not in d:
            return False
        recv, _, meth = d.rpartition(".")
        if meth not in _MUTATORS:
            return False
        ci = idx._type_of_expr(fi, recv)
        if ci is not None:
            return any(c.name == "PropertyStore" for c in idx.mro(ci))
        leaf = recv.rsplit(".", 1)[-1]
        return leaf == "store" or leaf.endswith("_store")

    # -- interprocedural fence obligations ----------------------------------

    def _propagate_requirements(self, idx, taint, reach, reqs) -> list[Finding]:
        """A sink whose fence is a bare parameter obligates every lead-path
        caller to supply an epoch-tainted argument; obligations hop further
        up when a caller forwards its own parameter."""
        out: list[Finding] = []
        flagged: set[tuple] = set()
        changed = True
        while changed:
            changed = False
            for q, fi in idx.functions.items():
                if q not in reach or _is_exempt_module(fi.module.path):
                    continue
                for call in fi.calls:
                    if call.callee is None:
                        continue
                    callee = idx.functions[call.callee]
                    for (cq, p), entry in list(reqs.items()):
                        if cq != call.callee:
                            continue
                        arg = arg_expr_for_param(call.node, callee, p)
                        if arg is None:
                            key = (fi.module.path, call.line, cq, p)
                            if key not in flagged:
                                flagged.add(key)
                                out.append(
                                    self._finding(
                                        fi,
                                        call.line,
                                        callee.short,
                                        entry,
                                        f"leaves {callee.short}()'s fence parameter '{p}' at its default (unfenced write)",
                                    )
                                )
                            continue
                        toks = taint.expr_tokens(fi, arg)
                        if SRC in toks:
                            continue
                        params = [t.split(":", 1)[1] for t in toks if t.startswith("param:")]
                        if params:
                            for pp in params:
                                if (q, pp) not in reqs:
                                    reqs[(q, pp)] = entry
                                    changed = True
                            continue
                        key = (fi.module.path, call.line, cq, p)
                        if key not in flagged:
                            flagged.add(key)
                            out.append(
                                self._finding(
                                    fi,
                                    call.line,
                                    callee.short,
                                    entry,
                                    f"feeds {callee.short}()'s fence parameter '{p}' a value that does not flow from the lease epoch",
                                )
                            )
        return out

    def _finding(self, fi: FuncInfo, line: int, what: str, entry: str, why: str) -> Finding:
        return Finding(
            check=self.name,
            path=fi.module.path,
            line=line,
            message=(
                f"PropertyStore .{what}() on the lead path (reachable from {entry}) {why}"
                f" — a deposed leader can still corrupt metadata; pass fence=<lease epoch>"
            )
            if what in _MUTATORS
            else (
                f"lead-path call (reachable from {entry}) {why}"
                f" — a deposed leader can still corrupt metadata; pass fence=<lease epoch>"
            ),
        )
