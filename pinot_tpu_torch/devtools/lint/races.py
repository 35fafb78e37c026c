"""race-discipline: cross-thread mutation of instance state without the
instance lock — whole-program.

Motivating bug: two receiver threads shared one pandas `Index`
object whose lazily-built hash engine is not thread-safe — a transient
KeyError in groupby under concurrency. The general pattern this checker
polices: an instance attribute that is REBOUND (assign / augassign / del)
from a method that other threads enter — a `threading.Thread` target, an
executor `submit`/`map` callee, an HTTP `do_GET`/`do_POST`/... handler, or
`run` — without holding `with self.<lock>`, while some OTHER method also
touches the same attribute outside the lock. Either side alone is fine
(thread-confined state, or consistently locked state); the combination is
a data race.

The checker rides the shared call graph (`AnalysisSession.index`):

- classes are merged across their MRO, so a base class in one module and
  the subclass that spawns the thread in another are analyzed as ONE class
  — the per-file pass used to be blind to exactly that split;
- the thread entry's effects are **transitive**: a write inside a helper
  method reached from the entry (`self._step()` from `run()`) counts as an
  entry write, and it counts as LOCKED when the call site held the lock
  even though the helper body is lexically lock-free — the locked-helper
  pattern (`_enqueue`/`_dequeue` called under the scheduler lock) no longer
  needs suppressions, and an unlocked helper write is no longer invisible.

`__init__` is exempt on both sides: construction happens-before the thread
start. Attributes whose every access is under the lock never fire. The
checker does not chase aliasing through containers or non-self receivers,
so it remains a discipline check, not a proof; suppress with a reason for
intentional patterns (single-writer state machines, monotonic counters
read for monitoring, ...).
"""

from __future__ import annotations

import ast

from pinot_tpu_torch.devtools.lint.core import Checker, Finding, dotted_name

_HANDLER_NAMES = {"run", "do_GET", "do_POST", "do_PUT", "do_DELETE", "do_HEAD"}
_SPAWN_ATTRS = {"submit", "map"}


def _is_lock_ctx(item: ast.withitem) -> bool:
    """`with self._lock:` / `with self._foo_lock:` (optionally `.acquire()`-less
    plain attribute, or a local alias whose name mentions lock)."""
    expr = item.context_expr
    name = dotted_name(expr)
    return "lock" in name.lower() or "mutex" in name.lower()


class _MethodScan(ast.NodeVisitor):
    """Collect self-attribute accesses within ONE method, tagging each with
    whether a `with <lock>` block encloses it, plus same-instance method
    calls (`self.m()`) with their lock state for the transitive pass."""

    def __init__(self, self_name: str):
        self.self_name = self_name
        self.lock_depth = 0
        self.writes: dict[str, list[tuple[int, bool]]] = {}  # attr -> [(line, locked)]
        self.reads: dict[str, list[tuple[int, bool]]] = {}
        self.spawn_targets: set[str] = set()  # method names handed to threads
        self.self_calls: list[tuple[str, int, bool]] = []  # (method, line, locked)

    def visit_With(self, node: ast.With):
        locky = any(_is_lock_ctx(i) for i in node.items)
        if locky:
            self.lock_depth += 1
        self.generic_visit(node)
        if locky:
            self.lock_depth -= 1

    def _self_attr(self, node: ast.AST) -> str | None:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == self.self_name
        ):
            return node.attr
        return None

    def _collect_target(self, t: ast.AST) -> None:
        attr = self._self_attr(t)
        if attr is not None:
            self.writes.setdefault(attr, []).append((t.lineno, self.lock_depth > 0))
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._collect_target(e)
        elif isinstance(t, ast.Starred):
            self._collect_target(t.value)
        else:
            self.visit(t)  # complex target (self.d[k] = ..): inner loads count as reads

    def visit_Assign(self, node: ast.Assign):
        for tgt in node.targets:
            self._collect_target(tgt)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign):
        attr = self._self_attr(node.target)
        if attr:
            self.writes.setdefault(attr, []).append((node.lineno, self.lock_depth > 0))
        self.visit(node.value)

    def visit_Delete(self, node: ast.Delete):
        for t in node.targets:
            attr = self._self_attr(t)
            if attr:
                self.writes.setdefault(attr, []).append((t.lineno, self.lock_depth > 0))

    def visit_Attribute(self, node: ast.Attribute):
        attr = self._self_attr(node)
        if attr and isinstance(node.ctx, ast.Load):
            self.reads.setdefault(attr, []).append((node.lineno, self.lock_depth > 0))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        # threading.Thread(target=self.m) / pool.submit(self.m) / pool.map(self.m)
        fn = node.func
        fn_name = dotted_name(fn)
        if fn_name.endswith("Thread") or fn_name.endswith("Timer"):
            for kw in node.keywords:
                if kw.arg == "target":
                    attr = self._self_attr(kw.value)
                    if attr:
                        self.spawn_targets.add(attr)
        if isinstance(fn, ast.Attribute) and fn.attr in _SPAWN_ATTRS and node.args:
            attr = self._self_attr(node.args[0])
            if attr:
                self.spawn_targets.add(attr)
        if (
            isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Name)
            and fn.value.id == self.self_name
        ):
            self.self_calls.append((fn.attr, node.lineno, self.lock_depth > 0))
        self.generic_visit(node)

    # do not descend into nested defs: their bodies execute in unknown
    # thread contexts; conservatively out of scope
    def visit_FunctionDef(self, node: ast.FunctionDef):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda):
        pass


class RaceChecker(Checker):
    name = "race-discipline"

    def finalize(self, modules) -> list[Finding]:
        idx = self.session.index
        scans: dict[str, _MethodScan] = {}  # FuncInfo qname -> scan

        def scan_of(fi) -> _MethodScan:
            s = scans.get(fi.qname)
            if s is None:
                args = fi.node.args.args
                s = _MethodScan(args[0].arg if args else "self")
                for stmt in fi.node.body:
                    s.visit(stmt)
                scans[fi.qname] = s
            return s

        out: list[Finding] = []
        seen_lines: set[tuple[str, int, str]] = set()
        for ci in idx.classes.values():
            # merged view across the MRO: most-derived definition wins, so a
            # base-class helper and the subclass entry analyze as one class
            merged: dict[str, object] = {}
            for c in idx.mro(ci):
                for name, fi in c.methods.items():
                    merged.setdefault(name, fi)
            if not merged:
                continue
            spawned: set[str] = set()
            for fi in merged.values():
                spawned |= scan_of(fi).spawn_targets
            entries = sorted(
                name for name in merged if name in _HANDLER_NAMES or name in spawned
            )
            for entry in entries:
                if entry == "__init__":
                    continue
                eff_writes = self._entry_effects(idx, ci, merged, entry, scan_of)
                for attr, writes in eff_writes.items():
                    unlocked = [(ln, path, holder) for ln, locked, path, holder in writes if not locked]
                    if not unlocked:
                        continue
                    first_line, first_path, holder = unlocked[0]
                    for other_name, other_fi in merged.items():
                        if other_name in (entry, "__init__", holder):
                            continue
                        other = scan_of(other_fi)
                        other_hits = [
                            ln
                            for ln, locked in other.writes.get(attr, []) + other.reads.get(attr, [])
                            if not locked
                        ]
                        if other_hits:
                            key = (first_path, first_line, attr)
                            if key in seen_lines:
                                break
                            seen_lines.add(key)
                            via = "" if holder == entry else f" (via {holder}())"
                            out.append(
                                Finding(
                                    self.name,
                                    first_path,
                                    first_line,
                                    f"self.{attr} is mutated in thread-entry method "
                                    f"{ci.name}.{entry}(){via} without holding the lock, and "
                                    f"accessed in {other_name}() (line {other_hits[0]}) also unlocked",
                                )
                            )
                            break  # one finding per (entry, attr)
        return out

    @staticmethod
    def _entry_effects(idx, ci, merged, entry: str, scan_of):
        """attr -> [(line, locked, path, holder_method)] for every self-attr
        rebind reachable from `entry` through same-instance calls. A write is
        locked when its own site is, or ANY call on the chain held the lock;
        a method reached both locked and unlocked is re-visited so the
        weaker (unlocked) state wins — conservative toward reporting."""
        effects: dict[str, list[tuple[int, bool, str, str]]] = {}
        visited: dict[str, bool] = {}  # qname -> inherited_locked it was walked with
        stack = [(merged[entry], False)]
        while stack:
            fi, inherited = stack.pop()
            prev = visited.get(fi.qname)
            # re-walk only to DOWNGRADE: walked locked before, reached
            # unlocked now (two states, so this terminates)
            if prev is not None and not (prev and not inherited):
                continue
            visited[fi.qname] = inherited
            scan = scan_of(fi)
            holder = fi.qname.rsplit(".", 1)[-1]
            for attr, ws in scan.writes.items():
                for line, locked in ws:
                    effects.setdefault(attr, []).append(
                        (line, locked or inherited, fi.module.path, holder)
                    )
            for m, _line, call_locked in scan.self_calls:
                target = idx.find_method(ci, m)
                if target is None or m == entry:
                    continue
                stack.append((target, inherited or call_locked))
        # entry's own writes first, then transitive, each in source order
        for attr in effects:
            effects[attr].sort(key=lambda w: (w[3] != entry, w[0]))
        return effects
