"""Interprocedural dataflow for pinotlint: taint + exception escapes.

Two analyses, both built lazily through `ProgramIndex.taint(spec)` /
`ProgramIndex.escapes()` and cached on the index so every checker in a
session shares one fixpoint.

Taint (`TaintAnalysis`)
    A practical k-limited taint lattice over the existing call graph — no
    heap cloning, no path sensitivity. Tokens are `"src"` (the value
    observably derives from a checker-defined source expression) and
    `"param:<name>"` (the value derives from the function's own parameter,
    so the verdict belongs to the CALLER). Flow is tracked through:

    - locals (`e = self._election.epoch; store.set(p, d, fence=e)`),
    - attributes on `self` (source-taint only: `self._fence_val = epoch`
      taints `(class, attr)` globally — k-limited, write anywhere in the
      class taints reads everywhere in its MRO),
    - return values of RESOLVED calls, with the callee's `param:` tokens
      substituted by the argument expressions at the call site,
    - containers/conditionals structurally (IfExp, BoolOp, BinOp, tuples,
      subscripts) by unioning operand tokens.

    UNRESOLVED calls propagate the union of their argument taints — the
    optimistic choice: a wrapper we cannot see keeps taint alive instead of
    laundering it, which biases the checkers toward fewer false findings.

    Per-function summaries (final local environment + return token set) are
    recomputed until a global fixpoint, capped at `TaintSpec.max_rounds`.

Exception escapes (`EscapeAnalysis`)
    For every function: which project exception classes a call to it may
    let propagate, with the ORIGIN raise site as witness. `raise` sites are
    resolved to classes the same conservative way calls are; enclosing
    `try` blocks are modeled structurally (a raise inside an `except`
    handler is protected only by OUTER tries; `else:` bodies are NOT
    covered by their own try's handlers). Catch matching unions the raised
    class's project MRO names with a small builtin base table, so `except
    OSError:` catches a `ConnectionError` subclass. Propagation through
    the call graph runs to fixpoint; any catch (specific or generic) stops
    propagation mid-graph, while boundary checkers can re-test a call with
    `generic_absolves=False` to ask "does this escape reach the generic
    backstop" — the typed-error-boundary question.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from pinot_tpu_torch.devtools.lint.core import dotted_name
from pinot_tpu_torch.devtools.lint.callgraph import FuncInfo, ProgramIndex, module_name

SRC = "src"


def param_token(name: str) -> str:
    return f"param:{name}"


class TaintSpec:
    """A checker-supplied source definition. `name` keys the cache on the
    ProgramIndex; `is_source(idx, fi, expr)` decides whether an expression
    IS the tainted value (e.g. a lease-epoch read)."""

    name = "taint"
    max_rounds = 8

    def is_source(self, idx: ProgramIndex, fi: FuncInfo, expr: ast.AST) -> bool:
        raise NotImplementedError


def positional_params(fi: FuncInfo) -> list[str]:
    a = fi.node.args
    return [p.arg for p in (*a.posonlyargs, *a.args)]


def arg_expr_for_param(call: ast.Call, callee: FuncInfo, pname: str) -> ast.AST | None:
    """The argument expression bound to `pname` at `call`, or None when the
    parameter takes its default. Bound-method calls (`obj.m(...)`) skip the
    `self` slot when mapping positionals."""
    for kw in call.keywords:
        if kw.arg == pname:
            return kw.value
    params = positional_params(callee)
    offset = 1 if callee.self_name is not None and isinstance(call.func, ast.Attribute) else 0
    try:
        i = params.index(pname) - offset
    except ValueError:
        return None
    if 0 <= i < len(call.args):
        arg = call.args[i]
        return None if isinstance(arg, ast.Starred) else arg
    return None


class TaintAnalysis:
    def __init__(self, idx: ProgramIndex, spec: TaintSpec):
        self.idx = idx
        self.spec = spec
        #: qname -> token set its return value carries
        self.returns: dict[str, frozenset] = {}
        #: (class qname, attr) -> {SRC} for source-tainted self attributes
        self.attr_taint: dict[tuple[str, str], frozenset] = {}
        #: qname -> final local environment (name -> tokens)
        self.envs: dict[str, dict[str, frozenset]] = {}
        self._stmts: dict[str, tuple[list, list]] = {}
        self._params: dict[str, frozenset] = {}
        #: id(node) -> is_source verdict (AST is stable across rounds)
        self._src_cache: dict[int, bool] = {}
        self._run()

    # -- fixpoint ------------------------------------------------------------

    def _run(self) -> None:
        fns = self.idx.functions
        for q, fi in fns.items():
            self._stmts[q] = self._collect_stmts(fi)
            self.returns[q] = frozenset()
            self.envs[q] = {}
            a = fi.node.args
            self._params[q] = frozenset(
                p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs) if p.arg != fi.self_name
            )
        for _ in range(self.spec.max_rounds):
            changed = False
            for q, fi in fns.items():
                ret = self._summarize(fi)
                if ret != self.returns[q]:
                    self.returns[q] = ret
                    changed = True
            if not changed:
                break

    @staticmethod
    def _collect_stmts(fi: FuncInfo) -> tuple[list, list]:
        """(assignments, returns) in this function's own scope — walked once
        so fixpoint rounds never re-traverse the AST."""
        assigns: list[tuple[list, ast.AST]] = []
        returns: list[ast.AST] = []
        from pinot_tpu_torch.devtools.lint.core import walk_scope

        for n in walk_scope(fi.node):
            if isinstance(n, ast.Assign):
                assigns.append((n.targets, n.value))
            elif isinstance(n, (ast.AnnAssign, ast.AugAssign)) and n.value is not None:
                assigns.append(([n.target], n.value))
            elif isinstance(n, ast.Return) and n.value is not None:
                returns.append(n.value)
        return assigns, returns

    def _summarize(self, fi: FuncInfo) -> frozenset:
        assigns, rets = self._stmts[fi.qname]
        if not assigns and not rets:
            return frozenset()
        env = self.envs[fi.qname]
        # two local passes so a loop-carried flow (use above its def) lands
        for _ in (0, 1):
            for targets, value in assigns:
                toks = self.eval(fi, value, env)
                if not toks:
                    continue
                for tgt in targets:
                    self._assign(fi, tgt, toks, env)
        out = frozenset()
        for value in rets:
            out |= self.eval(fi, value, env)
        return out

    def _assign(self, fi: FuncInfo, tgt: ast.AST, toks: frozenset, env) -> None:
        if isinstance(tgt, ast.Name):
            env[tgt.id] = env.get(tgt.id, frozenset()) | toks
        elif isinstance(tgt, ast.Tuple):
            for el in tgt.elts:
                self._assign(fi, el, toks, env)
        elif (
            isinstance(tgt, ast.Attribute)
            and isinstance(tgt.value, ast.Name)
            and fi.self_name == tgt.value.id
            and SRC in toks
        ):
            ci = fi.cls or (fi.parent.cls if fi.parent else None)
            if ci is not None:
                key = (ci.qname, tgt.attr)
                self.attr_taint[key] = self.attr_taint.get(key, frozenset()) | {SRC}

    # -- expression evaluation ----------------------------------------------

    def expr_tokens(self, fi: FuncInfo, expr: ast.AST) -> frozenset:
        """Taint tokens of `expr` inside `fi`, against the fixpoint state.
        This is the checker-facing query for call-site arguments."""
        return self.eval(fi, expr, self.envs.get(fi.qname, {}))

    def eval(self, fi: FuncInfo, expr: ast.AST, env) -> frozenset:
        key = id(expr)
        src = self._src_cache.get(key)
        if src is None:
            src = self._src_cache[key] = self.spec.is_source(self.idx, fi, expr)
        if src:
            return frozenset({SRC})
        if isinstance(expr, ast.Name):
            out = env.get(expr.id, frozenset())
            if expr.id in self._params.get(fi.qname, frozenset()):
                out = out | {param_token(expr.id)}
            if not out:
                # closure read: the enclosing function's fixpoint env
                scope = fi.parent
                while scope is not None and not out:
                    out = self.envs.get(scope.qname, {}).get(expr.id, frozenset())
                    scope = scope.parent
            return out
        if isinstance(expr, ast.Attribute):
            recv = dotted_name(expr.value)
            if recv and fi.self_name is not None and recv == fi.self_name:
                ci = fi.cls or (fi.parent.cls if fi.parent else None)
                if ci is not None:
                    out = frozenset()
                    for c in self.idx.mro(ci):
                        out |= self.attr_taint.get((c.qname, expr.attr), frozenset())
                    return out
            return frozenset()
        if isinstance(expr, ast.Call):
            callee_q = self.idx.resolve_call(fi, expr)
            if callee_q is not None:
                return self._call_tokens(fi, expr, callee_q, env)
            out = frozenset()
            for a in expr.args:
                out |= self.eval(fi, a.value if isinstance(a, ast.Starred) else a, env)
            for kw in expr.keywords:
                out |= self.eval(fi, kw.value, env)
            return out
        if isinstance(expr, ast.Await):
            return self.eval(fi, expr.value, env)
        if isinstance(expr, ast.IfExp):
            return self.eval(fi, expr.body, env) | self.eval(fi, expr.orelse, env)
        if isinstance(expr, ast.BoolOp):
            out = frozenset()
            for v in expr.values:
                out |= self.eval(fi, v, env)
            return out
        if isinstance(expr, ast.BinOp):
            return self.eval(fi, expr.left, env) | self.eval(fi, expr.right, env)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            out = frozenset()
            for el in expr.elts:
                out |= self.eval(fi, el.value if isinstance(el, ast.Starred) else el, env)
            return out
        if isinstance(expr, ast.Subscript):
            return self.eval(fi, expr.value, env)
        if isinstance(expr, ast.NamedExpr):
            toks = self.eval(fi, expr.value, env)
            if toks and isinstance(expr.target, ast.Name):
                env[expr.target.id] = env.get(expr.target.id, frozenset()) | toks
            return toks
        if isinstance(expr, ast.Starred):
            return self.eval(fi, expr.value, env)
        return frozenset()

    def _call_tokens(self, fi: FuncInfo, call: ast.Call, callee_q: str, env) -> frozenset:
        """Substitute a resolved callee's return summary: SRC survives,
        `param:p` becomes the taint of the argument bound to p here."""
        callee = self.idx.functions[callee_q]
        out = frozenset()
        for tok in self.returns.get(callee_q, frozenset()):
            if tok == SRC:
                out |= {SRC}
                continue
            pname = tok.split(":", 1)[1]
            arg = arg_expr_for_param(call, callee, pname)
            if arg is not None:
                out |= self.eval(fi, arg, env)
        return out


# -- exception escapes -------------------------------------------------------

#: transitive builtin exception bases (enough for catch matching in this
#: codebase; anything unknown chains straight to Exception)
_BUILTIN_BASES = {
    "ConnectionError": "OSError",
    "BrokenPipeError": "ConnectionError",
    "ConnectionResetError": "ConnectionError",
    "ConnectionRefusedError": "ConnectionError",
    "ConnectionAbortedError": "ConnectionError",
    "TimeoutError": "OSError",
    "PermissionError": "OSError",
    "FileNotFoundError": "OSError",
    "FileExistsError": "OSError",
    "InterruptedError": "OSError",
    "IsADirectoryError": "OSError",
    "IOError": "OSError",
    "OSError": "Exception",
    "KeyError": "LookupError",
    "IndexError": "LookupError",
    "LookupError": "Exception",
    "ZeroDivisionError": "ArithmeticError",
    "OverflowError": "ArithmeticError",
    "ArithmeticError": "Exception",
    "NotImplementedError": "RuntimeError",
    "RecursionError": "RuntimeError",
    "RuntimeError": "Exception",
    "UnicodeDecodeError": "ValueError",
    "ValueError": "Exception",
    "TypeError": "Exception",
    "AttributeError": "Exception",
    "AssertionError": "Exception",
    "StopIteration": "Exception",
    "StopAsyncIteration": "Exception",
    "MemoryError": "Exception",
    "BufferError": "Exception",
    "EOFError": "Exception",
}

_GENERIC = frozenset({"Exception", "BaseException"})
_MAX_ESCAPES_PER_FN = 25  # k-limit: keep summaries (and fixpoint) bounded


def builtin_chain(name: str) -> frozenset:
    out = {name}
    while name in _BUILTIN_BASES:
        name = _BUILTIN_BASES[name]
        out.add(name)
    out.add("Exception")
    out.add("BaseException")
    return frozenset(out)


@dataclass
class Escape:
    key: str  # project class qname, or builtin class name
    names: frozenset  # leaf names of the class + all bases, for catch matching
    path: str  # ORIGIN raise site (witness)
    line: int
    via: tuple  # function shorts from origin outward (origin first)


class EscapeAnalysis:
    def __init__(self, idx: ProgramIndex):
        self.idx = idx
        #: qname -> [(Escape, guards)] for raises IN the function body
        self.raises: dict[str, list[tuple[Escape, tuple]]] = {}
        #: qname -> {id(call node): guards} for try-nesting at call sites
        self._call_guards: dict[str, dict[int, tuple]] = {}
        #: qname -> {key: Escape} — what a call to the function may raise
        self.escapes: dict[str, dict[str, Escape]] = {}
        self._run()

    # -- per-function structure ---------------------------------------------

    def _run(self) -> None:
        fns = self.idx.functions
        for q, fi in fns.items():
            self.raises[q], self._call_guards[q] = self._scan(fi)
            esc: dict[str, Escape] = {}
            for e, guards in self.raises[q]:
                if not self._caught(e.names, guards, generic_absolves=True):
                    esc.setdefault(e.key, e)
            self.escapes[q] = esc
        changed = True
        while changed:
            changed = False
            for q, fi in fns.items():
                esc = self.escapes[q]
                if len(esc) >= _MAX_ESCAPES_PER_FN:
                    continue
                for call in fi.calls:
                    if call.callee is None:
                        continue
                    guards = self._call_guards[q].get(id(call.node), ())
                    for key, e in self.escapes.get(call.callee, {}).items():
                        if key in esc or len(esc) >= _MAX_ESCAPES_PER_FN:
                            continue
                        if self._caught(e.names, guards, generic_absolves=True):
                            continue
                        via = e.via if len(e.via) >= 6 else (*e.via, fi.short)
                        esc[key] = Escape(e.key, e.names, e.path, e.line, via)
                        changed = True
        return

    def _scan(self, fi: FuncInfo):
        raises: list[tuple[Escape, tuple]] = []
        call_guards: dict[int, tuple] = {}

        def walk(node: ast.AST, guards: tuple):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return  # separate FuncInfos
            if isinstance(node, ast.Try):
                level = tuple(self._handler_names(h) for h in node.handlers)
                for stmt in node.body:
                    walk(stmt, guards + (level,) if level else guards)
                # handler bodies and else/finally are NOT protected by this
                # try's own handlers — only by outer ones
                for h in node.handlers:
                    for stmt in h.body:
                        walk(stmt, guards)
                for stmt in node.orelse:
                    walk(stmt, guards)
                for stmt in node.finalbody:
                    walk(stmt, guards)
                return
            if isinstance(node, ast.Raise) and node.exc is not None:
                e = self._escape_of(fi, node)
                if e is not None:
                    raises.append((e, guards))
            if isinstance(node, ast.Call):
                call_guards[id(node)] = guards
            for child in ast.iter_child_nodes(node):
                walk(child, guards)

        for stmt in fi.node.body:
            walk(stmt, ())
        return raises, call_guards

    @staticmethod
    def _handler_names(h: ast.ExceptHandler) -> frozenset | None:
        """Leaf class names a handler catches; None = bare `except:`."""
        if h.type is None:
            return None
        types = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
        names = set()
        for t in types:
            d = dotted_name(t)
            if d:
                names.add(d.rsplit(".", 1)[-1])
        return frozenset(names)

    def _escape_of(self, fi: FuncInfo, node: ast.Raise) -> Escape | None:
        exc = node.exc
        d = dotted_name(exc.func) if isinstance(exc, ast.Call) else dotted_name(exc)
        if not d:
            return None
        ci = self.idx.resolve_class(d, module_name(fi.module.path))
        if ci is not None:
            names = set()
            for c in self.idx.mro(ci):
                names.add(c.name)
                for b in c.base_names:
                    leaf = b.rsplit(".", 1)[-1]
                    if leaf in _BUILTIN_BASES or leaf in _GENERIC:
                        names |= builtin_chain(leaf)
            names |= _GENERIC
            return Escape(ci.qname, frozenset(names), fi.module.path, node.lineno, (fi.short,))
        leaf = d.rsplit(".", 1)[-1]
        if leaf in _BUILTIN_BASES or leaf in _GENERIC:
            return Escape(leaf, builtin_chain(leaf), fi.module.path, node.lineno, (fi.short,))
        return None  # unresolved (re-raise of a bound name, dynamic class)

    # -- catch matching ------------------------------------------------------

    @staticmethod
    def _caught(names: frozenset, guards: tuple, generic_absolves: bool) -> bool:
        """Does any enclosing handler catch a class whose name-set is
        `names`? With `generic_absolves=False`, `except Exception:`/bare
        handlers do not count — the boundary-checker question 'does this
        land in the generic backstop'."""
        specific = names - _GENERIC
        for level in guards:
            for hset in level:
                if hset is None or (hset & _GENERIC):
                    if generic_absolves:
                        return True
                    continue
                if hset & specific:
                    return True
        return False

    # -- checker-facing queries ----------------------------------------------

    def call_escapes(self, fi: FuncInfo, call, generic_absolves: bool) -> list[Escape]:
        """Escapes a resolved call site may let through its OWN enclosing
        try blocks inside `fi`."""
        if call.callee is None:
            return []
        guards = self._call_guards.get(fi.qname, {}).get(id(call.node), ())
        out = []
        for e in self.escapes.get(call.callee, {}).values():
            if not self._caught(e.names, guards, generic_absolves):
                out.append(e)
        return out

    def direct_raises(self, fi: FuncInfo, generic_absolves: bool) -> list[Escape]:
        """Raises in `fi`'s own body surviving their enclosing tries."""
        out = []
        for e, guards in self.raises.get(fi.qname, []):
            if not self._caught(e.names, guards, generic_absolves):
                out.append(e)
        return out
