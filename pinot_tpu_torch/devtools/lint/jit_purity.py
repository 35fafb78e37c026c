"""jit-purity: functions the port compiles or captures — `torch.compile`,
`torch.jit.script`, `@triton.jit` kernels and the body of a
`with torch.cuda.graph(...)` or `with capture_graph(...)` block (the port's
capture, query/graphs.py) — (and the same-module functions they call) must
be trace-pure.

Inside a compiled function the Python body runs at trace time, not once per
call; a captured CUDA graph runs its host code once, at capture, and each
replay repeats the device work alone. A host side effect there silently runs
once instead of per call, and a branch on a tensor's value is decided once,
at trace or capture, for every later call. Three rules:

host-call
    No calls into host-effect namespaces: `time.*`, `logging.*`,
    `random.*`, `np.random.*` / `numpy.random.*`, the metrics registries
    (`server_metrics`/`broker_metrics`), or `print`/`open`/`input`.
    Applies to the compiled function and every same-module function it
    (transitively) calls by name.

nonlocal-mutation
    No `global`/`nonlocal` declarations and no item/attribute stores whose
    base is a free (closed-over) variable — trace-time mutation of host
    state. (`ref[...] = ...` on a parameter is fine: output buffers are
    parameters.) Deliberate trace-time capture must carry a suppression
    with its reason.

non-static-branch
    In the compiled function itself, an `if`/`while` test may not reference
    a parameter unless that parameter is annotated `tl.constexpr` (Triton's
    compile-time constant, what `static_argnames` is to `jax.jit`), or the
    test only consults trace-static facets (`.shape`/`.ndim`/`.dtype`/
    `.size`/`.device`/`len(...)`/`is None`). A captured body's parameters
    are those of the function its `with` block sits in. Callees are exempt —
    their argument staticness is unknowable lexically.

Compiled-root discovery is lexical, per module, and names each root form:
`@torch.compile` / `@torch.jit.script` / `@triton.jit` (bare, called with
options, or through `functools.partial(torch.compile, ...)`), the call forms
`torch.compile(f)` / `torch.jit.script(f)` with `f` resolved through
enclosing scopes (a lambda argument is its own root), and the body of
`with torch.cuda.graph(...)` / `with capture_graph(...)`. Any other `*.jit`
is not a root: the port has no `jax.jit`, and a name is matched only where
it is one of these.
"""

from __future__ import annotations

import ast

from pinot_tpu_torch.devtools.lint.core import Checker, Finding, ModuleInfo, dotted_name

_HOST_ROOTS = {"time", "logging", "random"}
_HOST_BUILTINS = {"print", "open", "input"}
_METRICS = {"server_metrics", "broker_metrics"}
_STATIC_FACETS = {"shape", "ndim", "dtype", "size", "device"}
#: the compilers whose decorated or wrapped function is a root
_COMPILERS = {"torch.compile", "torch.jit.script", "triton.jit"}
#: the context managers whose body is captured into a CUDA graph: torch's,
#: and the port's own (query/graphs.py), matched by its last name
_GRAPH_CAPTURE = "torch.cuda.graph"
_PORT_CAPTURE = "capture_graph"


def is_graph_capture(node: ast.AST) -> bool:
    """`torch.cuda.graph` / `capture_graph` (bare or qualified)."""
    name = dotted_name(node)
    return name == _GRAPH_CAPTURE or name.split(".")[-1] == _PORT_CAPTURE


def is_compiler(node: ast.AST) -> bool:
    """`torch.compile` / `torch.jit.script` / `triton.jit`, spelled out."""
    return dotted_name(node) in _COMPILERS


def _is_compile_decorator(dec: ast.AST) -> bool:
    if is_compiler(dec):
        return True
    if isinstance(dec, ast.Call):
        if is_compiler(dec.func):
            return True
        return dotted_name(dec.func).endswith("partial") and bool(dec.args) and is_compiler(dec.args[0])
    return False


def _constexpr_params(fn: ast.AST) -> set[str]:
    """Parameters annotated `tl.constexpr`: static, like static_argnames."""
    args = getattr(fn, "args", None)
    if not isinstance(args, ast.arguments):
        return set()
    return {
        a.arg
        for a in args.posonlyargs + args.args + args.kwonlyargs
        if a.annotation is not None and dotted_name(a.annotation).endswith("constexpr")
    }


class CapturedBody:
    """The body of one `with torch.cuda.graph(...)` (or `capture_graph`)
    block as a root: its statements, the parameters of the function it sits
    in, and its line."""

    def __init__(self, node: ast.With, enclosing: ast.AST | None):
        self.node = node
        self.body = node.body
        self.lineno = node.lineno
        graph = next(
            (dotted_name(i.context_expr.args[0]) for i in node.items
             if isinstance(i.context_expr, ast.Call) and i.context_expr.args),
            "",
        )
        #: the graph object's source (`g`, `self._graph`): its `.replay()` launches the capture
        self.graph = graph
        self.name = f"<captured graph {graph}>" if graph else "<captured graph>"
        self.args = enclosing.args if enclosing is not None else ast.arguments(
            posonlyargs=[], args=[], vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None, defaults=[]
        )


class _ScopedDefs(ast.NodeVisitor):
    """Map every FunctionDef to its enclosing-scope chain so
    `torch.compile(run)` resolves `run` to the nearest lexically enclosing
    definition; also records the function each `with` block sits in."""

    def __init__(self):
        self.scope_stack: list[dict[str, ast.AST]] = [{}]
        self.fn_stack: list[ast.AST] = []
        self.scope_of_call: dict[ast.Call, list[dict]] = {}
        self.fn_of_with: dict[ast.With, ast.AST | None] = {}

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self.scope_stack[-1][node.name] = node
        self.scope_stack.append({})
        self.fn_stack.append(node)
        self.generic_visit(node)
        self.fn_stack.pop()
        self.scope_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_With(self, node: ast.With):
        self.fn_of_with[node] = self.fn_stack[-1] if self.fn_stack else None
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        self.scope_of_call[node] = [dict(s) for s in self.scope_stack]
        self.generic_visit(node)

    def resolve(self, call: ast.Call, name: str):
        for scope in reversed(self.scope_of_call.get(call, [])):
            if name in scope:
                return scope[name]
        return None


def compiled_roots(tree: ast.Module, defs: _ScopedDefs) -> dict[object, set[str]]:
    """Every compiled root of a module -> its static parameter names. A root
    is a FunctionDef, a Lambda, or a CapturedBody."""
    roots: dict[object, set[str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            if any(_is_compile_decorator(dec) for dec in node.decorator_list):
                roots.setdefault(node, set()).update(_constexpr_params(node))
        elif isinstance(node, ast.Call) and is_compiler(node.func) and node.args:
            arg = node.args[0]
            wrapped = defs.resolve(node, arg.id) if isinstance(arg, ast.Name) else arg
            if isinstance(wrapped, (ast.FunctionDef, ast.Lambda)):
                roots.setdefault(wrapped, set()).update(_constexpr_params(wrapped))
        elif isinstance(node, ast.With) and any(
            isinstance(item.context_expr, ast.Call) and is_graph_capture(item.context_expr.func)
            for item in node.items
        ):
            enclosing = defs.fn_of_with.get(node)
            roots[CapturedBody(node, enclosing)] = set()
    return roots


def _params(fn) -> set[str]:
    args = fn.args
    return {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}


class JitPurityChecker(Checker):
    name = "jit-purity"

    def check_module(self, module: ModuleInfo) -> list[Finding]:
        defs = _ScopedDefs()
        defs.visit(module.tree)
        out: list[Finding] = []
        visited: set[ast.AST] = set()
        for fn, static in compiled_roots(module.tree, defs).items():
            out.extend(self._check_fn(module, fn, static, defs, visited, is_root=True))
        return out

    # ------------------------------------------------------------------

    def _check_fn(self, module, fn, static, defs, visited, is_root) -> list[Finding]:
        if fn in visited:
            return []
        visited.add(fn)
        out: list[Finding] = []
        params = _params(fn)
        local_names = set(params)
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        if isinstance(fn, CapturedBody):
            # the enclosing function's own locals are the capture's locals
            scope = defs.fn_of_with.get(fn.node)
            scope_nodes = [n for stmt in (scope.body if scope is not None else body) for n in ast.walk(stmt)]
        else:
            scope_nodes = None
        body_nodes = [n for stmt in body for n in ast.walk(stmt)]
        for n in scope_nodes if scope_nodes is not None else body_nodes:
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                local_names.add(n.id)
            elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                local_names.add(n.name)
            elif isinstance(n, ast.arg):  # nested defs' params
                local_names.add(n.arg)

        callees: list[ast.Call] = []
        for n in body_nodes:
            if isinstance(n, (ast.Global, ast.Nonlocal)):
                out.append(
                    Finding(
                        self.name, module.path, n.lineno,
                        f"compiled function mutates {'global' if isinstance(n, ast.Global) else 'nonlocal'} "
                        f"state ({', '.join(n.names)}): trace-time side effect",
                    )
                )
            elif isinstance(n, (ast.Assign, ast.AugAssign)):
                targets = n.targets if isinstance(n, ast.Assign) else [n.target]
                for t in targets:
                    base = t
                    while isinstance(base, (ast.Subscript, ast.Attribute)):
                        base = base.value
                    if (
                        isinstance(base, ast.Name)
                        and base is not t  # plain Name store is a local binding
                        and base.id not in local_names
                    ):
                        out.append(
                            Finding(
                                self.name, module.path, n.lineno,
                                f"compiled function stores into closed-over {base.id!r}: "
                                "trace-time mutation of host state (runs once, not per call)",
                            )
                        )
            elif isinstance(n, ast.Call):
                callees.append(n)
                out.extend(self._check_host_call(module, n))
            elif is_root and isinstance(n, (ast.If, ast.While)):
                bad = self._nonstatic_param_in_test(n.test, params - static)
                if bad:
                    out.append(
                        Finding(
                            self.name, module.path, n.lineno,
                            f"branch on non-static parameter {bad!r} inside a compiled function "
                            "(annotate it tl.constexpr or use torch.where / tl.where)",
                        )
                    )

        # transitive: same-module functions called by name
        for call in callees:
            if isinstance(call.func, ast.Name):
                target = defs.resolve(call, call.func.id)
                if target is not None and isinstance(target, ast.FunctionDef):
                    sub = self._check_fn(module, target, set(), defs, visited, is_root=False)
                    out.extend(sub)
        return out

    def _check_host_call(self, module, call: ast.Call) -> list[Finding]:
        name = dotted_name(call.func)
        root = name.split(".")[0]
        leaf = name.split(".")[-1]
        bad = (
            name in _HOST_BUILTINS
            or root in _HOST_ROOTS
            or name.startswith(("np.random.", "numpy.random."))
            or leaf in _METRICS
        )
        if bad:
            return [
                Finding(
                    self.name, module.path, call.lineno,
                    f"host side effect {name}() reachable from a compiled function "
                    "(runs at trace time only, or breaks tracing)",
                )
            ]
        return []

    @staticmethod
    def _nonstatic_param_in_test(test: ast.AST, nonstatic: set[str]) -> str | None:
        """Name of a non-static param the test depends on for its VALUE, or
        None. References through the static facets, len(param) and
        `param is None` checks are trace-static and allowed."""
        for n in ast.walk(test):
            if not (isinstance(n, ast.Name) and n.id in nonstatic and isinstance(n.ctx, ast.Load)):
                continue
            if not _used_statically(test, n):
                return n.id
        return None


def _used_statically(test: ast.AST, name_node: ast.Name) -> bool:
    parents: dict[ast.AST, ast.AST] = {}
    for p in ast.walk(test):
        for c in ast.iter_child_nodes(p):
            parents[c] = p
    p = parents.get(name_node)
    if isinstance(p, ast.Attribute) and p.attr in _STATIC_FACETS:
        return True
    if isinstance(p, ast.Call) and dotted_name(p.func) == "len":
        return True
    if isinstance(p, ast.Compare) and any(
        isinstance(c, ast.Constant) and c.value is None for c in p.comparators
    ) and all(isinstance(op, (ast.Is, ast.IsNot)) for op in p.ops):
        return True
    return False
