"""Whole-program call graph + lock model for pinotlint.

`ProgramIndex.build(modules)` turns one parsed file set into:

- a **function registry**: every `def` (methods, module functions, nested
  closures) under a stable qualified name, e.g.
  `pinot_tpu_torch.query.scheduler.QueryScheduler.stop` or
  `pinot_tpu_torch.cluster.broker.Broker._drain_streams.<locals>.pump`;
- a **class index** with best-effort MRO (bases resolved across modules),
  per-class lock attributes (`self._lock = threading.Lock()`), Condition ->
  bound-lock bindings (`threading.Condition(self._lock)`), and attribute
  types inferred from `self.x = SomeKnownClass(...)`;
- per-function **summaries**: which locks the body acquires (`with` blocks),
  every call site with the set of locks held at it, and every direct
  blocking operation (see `concurrency.py` for the classification);
- **transitive closures** over the call graph: `trans_acquires(fn)` (locks a
  call may take, directly or through callees) and `block_witness(fn)` (a
  representative blocking operation reachable from the function), both
  computed by fixpoint so call cycles terminate;
- lazy entry points into the **dataflow layer** (`devtools/lint/dataflow.py`):
  `taint(spec)` builds a k-limited taint analysis for a checker-supplied
  source predicate, `escapes()` the exception-escape summaries — both cached
  on the index so every checker shares one fixpoint.

Resolution is lexical and deliberately conservative: a call resolves through
(1) enclosing-scope nested defs, (2) same-module top-level functions,
(3) `self.method` through the MRO, (4) `self.attr.method` /
`localvar.method` through inferred attribute/local types — including
parameter annotations (`def __init__(self, broker: Broker)`), `alias = self`
bindings, and closure variables looked up through the enclosing-function
chain, with dotted receiver chains (`svc.controller.add_table`) resolved one
attribute hop at a time — (5) import aliases (`from pkg.mod import fn`,
`import pkg.mod as m`). Anything else — dynamic dispatch, callables in
containers, `getattr` — stays unresolved and simply contributes no edges, so
the checkers built on top under-approximate rather than hallucinate.
Explicit `.acquire()`/`.release()` pairs are NOT modeled (the codebase
convention is `with lock:`); a checker relying on this index sees only
context-manager acquisitions.

Lock identity unifies inheritance: `with self._lock:` inside
`FCFSScheduler` resolves to `QueryScheduler._lock` (the class whose
`__init__` created it), so acquisition edges from different subclasses meet
in one node. Acquiring a Condition acquires its bound lock.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from pinot_tpu_torch.devtools.lint.core import ModuleInfo, dotted_name, package_parts

_LOCK_CTORS = {"Lock", "RLock", "Semaphore", "BoundedSemaphore"}
_COND_CTORS = {"Condition"}


def module_name(path: str) -> str:
    """Dotted module name for a path: rooted at the `pinot_tpu_torch`
    package when the path lies inside it, else the bare stem (golden
    fixtures that sit outside any package)."""
    parts = package_parts(path) or path.replace("\\", "/").split("/")[-1:]
    stem = parts[-1][:-3] if parts[-1].endswith(".py") else parts[-1]
    if len(parts) > 1:
        dotted = ".".join(parts[:-1])
        return dotted if stem == "__init__" else f"{dotted}.{stem}"
    return stem


def _import_source(path: str, mname: str, stmt: ast.ImportFrom) -> str:
    """The absolute module a `from ... import` reads: a relative import
    (`from ..common.faults import FAULTS`) resolves against the importing
    module's package when the module sits in one."""
    is_package = path.replace("\\", "/").endswith("/__init__.py")
    if not stmt.level or ("." not in mname and not is_package):
        return stmt.module or ""
    package = mname if is_package else mname.rsplit(".", 1)[0]
    parts = package.split(".")
    base = parts[: len(parts) - (stmt.level - 1)]
    return ".".join(base + ([stmt.module] if stmt.module else []))


def _is_lockish_name(name: str) -> bool:
    low = name.lower()
    return "lock" in low or "mutex" in low


def _annotation_name(ann: ast.AST | None) -> str:
    """Dotted class name from a parameter annotation: plain names, string
    annotations ('Controller'), `X | None` unions, and `Optional[X]`."""
    if ann is None:
        return ""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        for side in (ann.left, ann.right):
            name = _annotation_name(side)
            if name and name != "None":
                return name
        return ""
    if isinstance(ann, ast.Subscript) and dotted_name(ann.value).endswith("Optional"):
        return _annotation_name(ann.slice)
    name = dotted_name(ann)
    return "" if name == "None" else name


@dataclass
class ClassInfo:
    qname: str
    name: str
    module: ModuleInfo
    node: ast.ClassDef
    base_names: list[str] = field(default_factory=list)  # raw dotted names
    methods: dict[str, "FuncInfo"] = field(default_factory=dict)
    #: self.<attr> -> class qname, from `self.attr = KnownClass(...)`
    attr_types: dict[str, str] = field(default_factory=dict)
    #: self.<attr> assigned threading.Lock/RLock/Semaphore in a method body
    lock_attrs: set[str] = field(default_factory=set)
    #: self.<attr> assigned asyncio.Lock/Condition/... — NOT thread locks;
    #: tracked separately so `async with self._alock:` is never misread as a
    #: threading acquisition (and so event-loop-safety can tell them apart)
    async_lock_attrs: set[str] = field(default_factory=set)
    #: condition attr -> the lock ATTR NAME it wraps (None = own internal lock)
    cond_binding: dict[str, str | None] = field(default_factory=dict)


@dataclass
class CallSite:
    node: ast.Call
    line: int
    dotted: str  # source text of the callee, "" when not a name chain
    callee: str | None  # resolved function qname, or None
    held: frozenset  # lock ids held at the call site


@dataclass
class Acquire:
    lock_id: str
    line: int
    held_before: frozenset  # lock ids already held when this one is taken


@dataclass
class BlockOp:
    line: int
    desc: str  # human label, e.g. "time.sleep()"
    held: frozenset
    #: for `<cond>.wait()`: the id of the lock the Condition releases while
    #: waiting (holding exactly that lock is legal); None otherwise
    releases: str | None = None
    #: True for ops that only matter on an event loop (subprocess, flock,
    #: socket connect/sendall, pooled wire calls): event-loop-safety counts
    #: them, blocking-under-lock keeps its original narrower set
    loop_only: bool = False


@dataclass
class FuncInfo:
    qname: str
    module: ModuleInfo
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    cls: ClassInfo | None = None
    self_name: str | None = None
    parent: "FuncInfo | None" = None  # enclosing function for nested defs
    acquires: list[Acquire] = field(default_factory=list)
    calls: list[CallSite] = field(default_factory=list)
    blocking: list[BlockOp] = field(default_factory=list)
    #: local var -> class qname for `x = KnownClass(...)` and alias bindings
    local_types: dict[str, str] = field(default_factory=dict)
    #: param name -> raw annotation dotted name (`broker: Broker`)
    param_types: dict[str, str] = field(default_factory=dict)
    #: (line, locks held) for every `await` expression in the body
    awaits: list[tuple[int, frozenset]] = field(default_factory=list)

    @property
    def is_async(self) -> bool:
        return isinstance(self.node, ast.AsyncFunctionDef)

    @property
    def short(self) -> str:
        return self.qname.rsplit(".", 1)[-1]


class ProgramIndex:
    """The shared whole-program analysis: built once per lint session and
    reused by every call-graph-based checker (AST parse -> summaries happen
    exactly once regardless of how many checkers consume them)."""

    def __init__(self):
        self.functions: dict[str, FuncInfo] = {}
        self.classes: dict[str, ClassInfo] = {}  # qname -> info
        self._classes_by_name: dict[str, list[ClassInfo]] = {}
        self.module_funcs: dict[str, dict[str, FuncInfo]] = {}  # mod -> name -> fn
        self.imports: dict[str, dict[str, str]] = {}  # mod -> alias -> target
        self.module_locks: dict[str, set[str]] = {}  # mod -> module-level lock names
        self._mro_cache: dict[str, list[ClassInfo]] = {}
        self._trans_acq: dict[str, frozenset] | None = None
        self._block_wit: dict[str, tuple] | None = None
        self._loop_block_wit: dict[str, tuple] | None = None
        self._taints: dict[str, object] = {}  # TaintSpec.name -> TaintAnalysis
        self._escapes: object | None = None  # EscapeAnalysis

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, modules: list[ModuleInfo]) -> "ProgramIndex":
        idx = cls()
        for mod in modules:
            idx._index_module(mod)
        for fn in list(idx.functions.values()):
            _Summarizer(idx, fn).run()
        return idx

    def _index_module(self, mod: ModuleInfo) -> None:
        mname = module_name(mod.path)
        self.module_funcs.setdefault(mname, {})
        self.imports.setdefault(mname, {})
        self.module_locks.setdefault(mname, set())
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Import):
                for a in stmt.names:
                    self.imports[mname][a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(stmt, ast.ImportFrom) and (stmt.module or stmt.level):
                source = _import_source(mod.path, mname, stmt)
                for a in stmt.names:
                    self.imports[mname][a.asname or a.name] = f"{source}.{a.name}"
            elif isinstance(stmt, ast.Assign):
                ctor = stmt.value.func if isinstance(stmt.value, ast.Call) else None
                ctor_leaf = dotted_name(ctor).rsplit(".", 1)[-1] if ctor is not None else ""
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name) and (
                        ctor_leaf in _LOCK_CTORS or _is_lockish_name(tgt.id)
                    ):
                        self.module_locks[mname].add(tgt.id)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_function(mod, mname, stmt, cls=None, parent=None)
            elif isinstance(stmt, ast.ClassDef):
                self._index_class(mod, mname, stmt)

    def _index_class(self, mod: ModuleInfo, mname: str, node: ast.ClassDef) -> None:
        ci = ClassInfo(
            qname=f"{mname}.{node.name}",
            name=node.name,
            module=mod,
            node=node,
            base_names=[dotted_name(b) for b in node.bases if dotted_name(b)],
        )
        self.classes[ci.qname] = ci
        self._classes_by_name.setdefault(node.name, []).append(ci)
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = self._add_function(mod, mname, stmt, cls=ci, parent=None)
                ci.methods[stmt.name] = fi
        for m in ci.methods.values():
            self._scan_self_assigns(ci, m)

    def _scan_self_assigns(self, ci: ClassInfo, fi: FuncInfo) -> None:
        """Record `self.x = threading.Lock()` / `threading.Condition(l)` /
        `KnownClass(...)` attribute bindings (any method, not just __init__)."""
        self_name = fi.self_name
        if self_name is None:
            return
        for n in ast.walk(fi.node):
            if not isinstance(n, ast.Assign):
                continue
            if isinstance(n.value, ast.Name):
                # `self.x = param` keeps the param's annotated type
                t = fi.param_types.get(n.value.id)
                if t is not None:
                    for tgt in n.targets:
                        if (
                            isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == self_name
                        ):
                            ci.attr_types.setdefault(tgt.attr, t)
                continue
            if not isinstance(n.value, ast.Call):
                continue
            ctor = dotted_name(n.value.func)
            leaf = ctor.rsplit(".", 1)[-1]
            is_asyncio = ctor.startswith("asyncio.")
            for tgt in n.targets:
                if not (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == self_name
                ):
                    continue
                if is_asyncio and leaf in (_LOCK_CTORS | _COND_CTORS):
                    ci.async_lock_attrs.add(tgt.attr)
                elif leaf in _LOCK_CTORS:
                    ci.lock_attrs.add(tgt.attr)
                elif leaf in _COND_CTORS:
                    bound = None
                    if n.value.args:
                        d = dotted_name(n.value.args[0])
                        if d.startswith(self_name + "."):
                            bound = d[len(self_name) + 1 :]
                    ci.cond_binding[tgt.attr] = bound
                else:
                    ci.attr_types[tgt.attr] = ctor  # resolved lazily

    def _add_function(self, mod, mname, node, cls, parent) -> FuncInfo:
        if cls is not None:
            qname = f"{cls.qname}.{node.name}"
        elif parent is not None:
            qname = f"{parent.qname}.<locals>.{node.name}"
        else:
            qname = f"{mname}.{node.name}"
        self_name = None
        if cls is not None and node.args.args and not any(
            isinstance(d, ast.Name) and d.id == "staticmethod" for d in node.decorator_list
        ):
            self_name = node.args.args[0].arg
        fi = FuncInfo(qname=qname, module=mod, node=node, cls=cls, self_name=self_name, parent=parent)
        for a in [*node.args.posonlyargs, *node.args.args, *node.args.kwonlyargs]:
            t = _annotation_name(a.annotation)
            if t:
                fi.param_types[a.arg] = t
        self.functions[qname] = fi
        if cls is None and parent is None:
            self.module_funcs[mname][node.name] = fi
        # nested defs become their own FuncInfos (thread bodies, closures)
        for inner in ast.walk(node):
            if inner is node:
                continue
            if isinstance(inner, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if self._immediate_parent_def(node, inner) is node:
                    self._add_function(mod, mname, inner, cls=None, parent=fi)
        return fi

    @staticmethod
    def _immediate_parent_def(outer: ast.AST, target: ast.AST) -> ast.AST | None:
        """The nearest enclosing def of `target` within `outer` (so nesting is
        registered once, by its direct parent)."""
        stack = [(outer, outer)]
        while stack:
            node, owner = stack.pop()
            for child in ast.iter_child_nodes(node):
                if child is target:
                    return owner
                next_owner = (
                    child
                    if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                    else owner
                )
                stack.append((child, next_owner))
        return None

    # -- class resolution ----------------------------------------------------

    def resolve_class(self, name: str, from_module: str) -> ClassInfo | None:
        """Resolve a (possibly dotted or imported) class name seen in
        `from_module` to a ClassInfo."""
        if not name:
            return None
        leaf = name.rsplit(".", 1)[-1]
        # same module first
        ci = self.classes.get(f"{from_module}.{leaf}")
        if ci is not None and (name == leaf or ci.qname.endswith(name)):
            return ci
        # import alias: `from pkg.mod import Cls` / `import pkg.mod as m; m.Cls`
        target = self._resolve_alias(name, from_module)
        if target is not None:
            ci = self.classes.get(target)
            if ci is not None:
                return ci
        # unique global name match (fixtures, unaliased cross-module refs)
        cands = self._classes_by_name.get(leaf, [])
        if len(cands) == 1:
            return cands[0]
        return None

    def _resolve_alias(self, dotted: str, from_module: str) -> str | None:
        """Map `alias.rest` through the module's import table to a program
        qname ('pkg.mod.Thing' or 'pkg.mod.Thing.attr')."""
        imports = self.imports.get(from_module, {})
        head, _, rest = dotted.partition(".")
        target = imports.get(head)
        if target is None:
            return None
        return f"{target}.{rest}" if rest else target

    def mro(self, ci: ClassInfo) -> list[ClassInfo]:
        """Naive left-to-right depth-first linearization (cycle-safe)."""
        cached = self._mro_cache.get(ci.qname)
        if cached is not None:
            return cached
        out: list[ClassInfo] = []
        seen: set[str] = set()

        def visit(c: ClassInfo):
            if c.qname in seen:
                return
            seen.add(c.qname)
            out.append(c)
            for b in c.base_names:
                bc = self.resolve_class(b, module_name(c.module.path))
                if bc is not None:
                    visit(bc)

        visit(ci)
        self._mro_cache[ci.qname] = out
        return out

    def find_method(self, ci: ClassInfo, name: str) -> FuncInfo | None:
        for c in self.mro(ci):
            m = c.methods.get(name)
            if m is not None:
                return m
        return None

    # -- lock identity -------------------------------------------------------

    def lock_id_for_attr(self, ci: ClassInfo, attr: str) -> str:
        """Canonical id for `self.<attr>` as a lock: named after the class in
        the MRO that CREATED the attribute, so subclass acquisitions unify."""
        for c in self.mro(ci):
            if attr in c.lock_attrs or attr in c.cond_binding:
                bound = c.cond_binding.get(attr)
                if bound is not None:
                    return self.lock_id_for_attr(c, bound)
                return f"{c.qname}.{attr}"
        return f"{ci.qname}.{attr}"

    def classify_with_item(self, fi: FuncInfo, expr: ast.AST) -> str | None:
        """Lock id when `with <expr>:` acquires a lock, else None."""
        d = dotted_name(expr)
        if not d:
            return None
        mname = module_name(fi.module.path)
        sn = fi.self_name
        if sn is not None and d.startswith(sn + ".") and d.count(".") == 1:
            attr = d.split(".", 1)[1]
            ci = fi.cls or (fi.parent.cls if fi.parent else None)
            if ci is not None and self._attr_is_async_lock(ci, attr):
                return None  # asyncio primitive: not a thread lock
            if ci is not None and self._attr_is_lock(ci, attr):
                return self.lock_id_for_attr(ci, attr)
            if _is_lockish_name(attr):
                return f"{ci.qname}.{attr}" if ci is not None else f"{mname}.{attr}"
            return None
        if "." not in d:
            if d in self.module_locks.get(mname, set()):
                return f"{mname}.{d}"
            # `from other_mod import SOME_LOCK`: unify with the DEFINING
            # module's id, or cross-module edges never meet in one node
            target = self._resolve_alias(d, mname)
            if target is not None:
                tmod, _, tname = target.rpartition(".")
                if tname in self.module_locks.get(tmod, set()) or _is_lockish_name(tname):
                    return target
            if _is_lockish_name(d):
                return f"{fi.qname}.<local>.{d}"
            return None
        # obj.attr where obj has a known local/attr type
        head, _, attr = d.rpartition(".")
        owner = self._type_of_expr(fi, head)
        if owner is not None and "." not in attr:
            if self._attr_is_async_lock(owner, attr):
                return None
            if self._attr_is_lock(owner, attr) or _is_lockish_name(attr):
                return self.lock_id_for_attr(owner, attr)
            return None
        if _is_lockish_name(d):
            resolved = self._resolve_alias(d, mname)
            return resolved or f"{mname}.{d}"
        return None

    def _attr_is_lock(self, ci: ClassInfo, attr: str) -> bool:
        return any(attr in c.lock_attrs or attr in c.cond_binding for c in self.mro(ci))

    def _attr_is_async_lock(self, ci: ClassInfo, attr: str) -> bool:
        return any(attr in c.async_lock_attrs for c in self.mro(ci))

    def cond_released_lock(self, fi: FuncInfo, recv_dotted: str) -> str | None:
        """For `<recv>.wait()`: the lock id a Condition receiver releases
        while waiting, or None when the receiver is not a known Condition."""
        sn = fi.self_name
        ci = fi.cls or (fi.parent.cls if fi.parent else None)
        if sn is not None and ci is not None and recv_dotted.startswith(sn + "."):
            attr = recv_dotted[len(sn) + 1 :]
            for c in self.mro(ci):
                if attr in c.cond_binding:
                    return self.lock_id_for_attr(c, attr)
        return None

    # -- type inference helpers ---------------------------------------------

    def _type_of_expr(self, fi: FuncInfo, dotted: str) -> ClassInfo | None:
        """ClassInfo of a dotted receiver chain. The HEAD resolves through
        `self`, locals, annotated params, then the enclosing-closure chain
        (so `svc` inside a handler method finds `svc = self` in the service
        `__init__` that defines it); each further hop resolves through the
        owning class's inferred attribute types."""
        if not dotted:
            return None
        head, *rest = dotted.split(".")
        ci = self._type_of_head(fi, head)
        for attr in rest:
            if ci is None:
                return None
            ci = self._attr_type(ci, attr)
        return ci

    def _type_of_head(self, fi: FuncInfo, name: str) -> ClassInfo | None:
        scope: FuncInfo | None = fi
        while scope is not None:
            if scope.self_name is not None and name == scope.self_name:
                return scope.cls
            smod = module_name(scope.module.path)
            t = scope.local_types.get(name) or scope.param_types.get(name)
            if t is not None:
                return self.resolve_class(t, smod)
            scope = scope.parent
        return None

    def _attr_type(self, ci: ClassInfo, attr: str) -> ClassInfo | None:
        for c in self.mro(ci):
            t = c.attr_types.get(attr)
            if t is not None:
                return self.resolve_class(t, module_name(c.module.path))
        return None

    # -- call resolution -----------------------------------------------------

    def resolve_call(self, fi: FuncInfo, call: ast.Call) -> str | None:
        """Qname of the called function, or None when not lexically
        resolvable. See the module docstring for the resolution order."""
        d = dotted_name(call.func)
        if not d:
            return None
        mname = module_name(fi.module.path)
        if "." not in d:
            # enclosing nested defs, innermost first
            scope = fi
            while scope is not None:
                cand = self.functions.get(f"{scope.qname}.<locals>.{d}")
                if cand is not None:
                    return cand.qname
                scope = scope.parent
            local = self.module_funcs.get(mname, {}).get(d)
            if local is not None:
                return local.qname
            target = self._resolve_alias(d, mname)
            if target is not None and target in self.functions:
                return target
            ci = self.resolve_class(d, mname)
            if ci is not None and "__init__" in ci.methods:
                return ci.methods["__init__"].qname
            return None
        head, _, meth = d.rpartition(".")
        sn = fi.self_name
        ci = fi.cls or (fi.parent.cls if fi.parent else None)
        if sn is not None and ci is not None and head == sn:
            m = self.find_method(ci, meth)
            return m.qname if m is not None else None
        owner = self._type_of_expr(fi, head)
        if owner is not None:
            m = self.find_method(owner, meth)
            return m.qname if m is not None else None
        # module alias / `ClassName.method` in the same module
        target = self._resolve_alias(d, mname)
        if target is not None and target in self.functions:
            return target
        same_mod = f"{mname}.{d}"
        if same_mod in self.functions:
            return same_mod
        return None

    # -- transitive closures -------------------------------------------------

    def trans_acquires(self, qname: str) -> frozenset:
        """Lock ids `qname` may acquire, directly or through resolved calls."""
        if self._trans_acq is None:
            self._trans_acq = self._fixpoint_acquires()
        return self._trans_acq.get(qname, frozenset())

    def _fixpoint_acquires(self) -> dict[str, frozenset]:
        acq = {
            q: frozenset(a.lock_id for a in f.acquires) for q, f in self.functions.items()
        }
        changed = True
        while changed:
            changed = False
            for q, f in self.functions.items():
                cur = acq[q]
                add = frozenset(
                    lid
                    for c in f.calls
                    if c.callee is not None
                    for lid in acq.get(c.callee, frozenset())
                )
                if not add <= cur:
                    acq[q] = cur | add
                    changed = True
        return acq

    def block_witness(self, qname: str):
        """(path, line, desc, chain) of a blocking operation reachable from
        `qname`, or None. `chain` is the call path (function shorts) from the
        function to the operation — evidence for the finding message."""
        if self._block_wit is None:
            self._block_wit = self._fixpoint_blocking(loop=False)
        return self._block_wit.get(qname)

    def loop_block_witness(self, qname: str):
        """Like `block_witness` but for the event-loop-safety checker: also
        counts loop-only ops (subprocess, flock, socket connect/sendall,
        pooled wire calls) and never traverses INTO an `async def` callee —
        an async function's own blocking ops are reported at that function,
        not re-attributed to every async caller."""
        if self._loop_block_wit is None:
            self._loop_block_wit = self._fixpoint_blocking(loop=True)
        return self._loop_block_wit.get(qname)

    def _fixpoint_blocking(self, loop: bool) -> dict[str, tuple]:
        wit: dict[str, tuple] = {}
        for q, f in self.functions.items():
            for op in f.blocking:
                if op.loop_only and not loop:
                    continue
                wit[q] = (f.module.path, op.line, op.desc, (f.short,))
                break
        changed = True
        while changed:
            changed = False
            for q, f in self.functions.items():
                if q in wit:
                    continue
                for c in f.calls:
                    if c.callee is None or c.callee not in wit:
                        continue
                    if loop and self.functions[c.callee].is_async:
                        continue
                    path, line, desc, chain = wit[c.callee]
                    if len(chain) < 6:  # keep messages readable
                        wit[q] = (path, line, desc, (f.short, *chain))
                        changed = True
                        break
        return wit

    # -- dataflow layer (lazy; see devtools/lint/dataflow.py) ----------------

    def taint(self, spec):
        """The (cached) taint analysis for `spec` — a
        `dataflow.TaintSpec` naming the source predicate. Built to fixpoint
        on first use; every checker asking for the same spec name shares it."""
        cached = self._taints.get(spec.name)
        if cached is None:
            from pinot_tpu_torch.devtools.lint.dataflow import TaintAnalysis

            cached = self._taints[spec.name] = TaintAnalysis(self, spec)
        return cached

    def escapes(self):
        """The (cached) exception-escape analysis: per-function summaries of
        which project exception classes a call may let propagate."""
        if self._escapes is None:
            from pinot_tpu_torch.devtools.lint.dataflow import EscapeAnalysis

            self._escapes = EscapeAnalysis(self)
        return self._escapes


class _Summarizer(ast.NodeVisitor):
    """One pass over ONE function's body (nested defs excluded — they have
    their own FuncInfos): records acquisitions, call sites with held-lock
    sets, blocking operations, and local constructor type bindings."""

    def __init__(self, idx: ProgramIndex, fi: FuncInfo):
        self.idx = idx
        self.fi = fi
        self.held: list[str] = []  # stack of lock ids, outermost first

    def run(self) -> None:
        for stmt in self.fi.node.body:
            self.visit(stmt)

    # nested defs are separate functions; do not descend
    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass

    def visit_With(self, node: ast.With):
        taken: list[str] = []
        for item in node.items:
            lid = self.idx.classify_with_item(self.fi, item.context_expr)
            # `with lock:` is also a call-free acquisition even when aliased
            if lid is not None:
                self.fi.acquires.append(
                    Acquire(lock_id=lid, line=item.context_expr.lineno, held_before=frozenset(self.held))
                )
                self.held.append(lid)
                taken.append(lid)
            else:
                self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        for _ in taken:
            self.held.pop()

    visit_AsyncWith = visit_With

    def visit_Assign(self, node: ast.Assign):
        ci = None
        if isinstance(node.value, ast.Call):
            ctor = dotted_name(node.value.func)
            mname = module_name(self.fi.module.path)
            ci = self.idx.resolve_class(ctor, mname) if ctor else None
        elif isinstance(node.value, (ast.Name, ast.Attribute)):
            # aliases: `svc = self`, `c = svc.controller` — the target keeps
            # the resolved type so later `c.method()` calls find their edge
            d = dotted_name(node.value)
            ci = self.idx._type_of_expr(self.fi, d) if d else None
        if ci is not None:
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self.fi.local_types[tgt.id] = ci.qname
        self.generic_visit(node)

    def visit_Await(self, node: ast.Await):
        self.fi.awaits.append((node.lineno, frozenset(self.held)))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        from pinot_tpu_torch.devtools.lint.concurrency import (
            classify_blocking,
            classify_loop_blocking,
        )

        dotted = dotted_name(node.func)
        callee = self.idx.resolve_call(self.fi, node)
        self.fi.calls.append(
            CallSite(node=node, line=node.lineno, dotted=dotted, callee=callee, held=frozenset(self.held))
        )
        blocked = classify_blocking(node, dotted)
        loop_only = False
        if blocked is None:
            blocked = classify_loop_blocking(node, dotted)
            loop_only = blocked is not None
        if blocked is not None:
            releases = None
            if isinstance(node.func, ast.Attribute) and node.func.attr == "wait":
                recv = dotted_name(node.func.value)
                if recv:
                    releases = self.idx.cond_released_lock(self.fi, recv)
            self.fi.blocking.append(
                BlockOp(
                    line=node.lineno,
                    desc=blocked,
                    held=frozenset(self.held),
                    releases=releases,
                    loop_only=loop_only,
                )
            )
        self.generic_visit(node)
