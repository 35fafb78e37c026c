"""resource-leak: sockets, threads, executors, and file handles created as
function locals must be closed/joined/shut down on all paths, escape to a
longer-lived owner, or be daemonized (threads).

This is the STATIC complement to the runtime harness in
`common/leakcheck.py`: leakcheck catches what actually leaked in a test run;
this checker catches the shapes that leak only on the path the test didn't
take. Tracked constructors -> required disposal:

    threading.Thread(...) / threading.Timer(...)   .join()   (daemon= exempt)
    ThreadPoolExecutor / ProcessPoolExecutor       .shutdown()
    socket.socket / socket.create_connection       .close() / .detach()
    open(...)                                      .close()

A resource **escapes** (and is therefore the receiver's problem, not this
function's) when it is returned or yielded, passed as a call argument,
stored into an attribute/subscript/container, aliased to another name, or
referenced from a nested def. `with resource:` counts as a guaranteed
close. A disposal that only happens under an `if` or inside an `except`
handler is a conditional close: the path where the condition is false still
leaks, and the finding says so. Disposal inside a `finally` block is always
unconditional.

Known false-positive shapes (suppress with a reason):
- disposal via a helper the resource is NOT passed to (e.g. a bound method
  stored elsewhere) is invisible — the checker only sees direct
  `var.close()`-style calls and escapes;
- a `for`/`while` body is treated as executing (a close inside a loop body
  counts as unconditional);
- code between creation and a `try/finally` disposal can raise before the
  `finally` exists — that narrow window is not modeled.
"""

from __future__ import annotations

import ast

from pinot_tpu_torch.devtools.lint.core import Checker, Finding, ModuleInfo, dotted_name

#: constructor (dotted suffix) -> (resource kind, disposal verbs)
_RESOURCE_CTORS = {
    "threading.Thread": ("thread", {"join"}),
    "threading.Timer": ("timer thread", {"join", "cancel"}),
    "ThreadPoolExecutor": ("executor", {"shutdown"}),
    "ProcessPoolExecutor": ("executor", {"shutdown"}),
    "socket.socket": ("socket", {"close", "detach"}),
    "socket.create_connection": ("socket", {"close", "detach"}),
    "open": ("file handle", {"close"}),
}

#: Name-load parents that hand the resource to a longer-lived owner
_ESCAPE_PARENTS = (
    ast.Return,
    ast.Yield,
    ast.YieldFrom,
    ast.Tuple,
    ast.List,
    ast.Set,
    ast.Dict,
    ast.Starred,
    ast.keyword,
)


def _classify_ctor(call: ast.Call) -> tuple[str, set[str]] | None:
    d = dotted_name(call.func)
    if not d:
        return None
    for suffix, spec in _RESOURCE_CTORS.items():
        if d == suffix or d.endswith("." + suffix) or d.rsplit(".", 1)[-1] == suffix:
            return spec
    return None


def _is_daemon_thread(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant) and kw.value.value:
            return True
    return False


class _FnResources:
    """Track one function's locally-created resources through a lexical walk
    with parent links (no CFG: conditionality is judged from If/except
    ancestry of the disposal statement)."""

    def __init__(self, module: ModuleInfo, fn: ast.AST):
        self.module = module
        self.fn = fn
        self.parents: dict[ast.AST, ast.AST] = {}
        stack = [fn]
        while stack:
            node = stack.pop()
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
                stack.append(child)

    def _enclosing(self, node: ast.AST):
        """Ancestors of `node` up to (excluding) the function def."""
        cur = self.parents.get(node)
        while cur is not None and cur is not self.fn:
            yield cur
            cur = self.parents.get(cur)

    def _in_nested_def(self, node: ast.AST) -> bool:
        return any(
            isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            for a in self._enclosing(node)
        )

    def _disposal_conditional(self, call: ast.Call) -> bool:
        """A close under an `if` / `except` only runs on that path; a close
        in a `finally` is unconditional even under deeper nesting."""
        node = call
        for anc in self._enclosing(call):
            if isinstance(anc, ast.Try) and any(
                node is s or self._descends(s, node) for s in anc.finalbody
            ):
                return False
            if isinstance(anc, (ast.If, ast.ExceptHandler)):
                return True
            node = anc
        return False

    def _descends(self, root: ast.AST, target: ast.AST) -> bool:
        cur = target
        while cur is not None:
            if cur is root:
                return True
            cur = self.parents.get(cur)
        return False

    def findings(self, checker_name: str) -> list[Finding]:
        creations: list[tuple[str, ast.Call, str, set[str]]] = []  # var, call, kind, verbs
        for node in ast.walk(self.fn):
            if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
                continue
            if self._in_nested_def(node):
                continue  # the nested def owns it; analyzed as its own function
            spec = _classify_ctor(node.value)
            if spec is None:
                continue
            kind, verbs = spec
            if kind in ("thread", "timer thread") and _is_daemon_thread(node.value):
                continue
            if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
                creations.append((node.targets[0].id, node.value, kind, set(verbs)))

        out: list[Finding] = []
        for var, ctor_call, kind, verbs in creations:
            escaped = False
            disposals: list[ast.Call] = []
            daemonized = False
            for node in ast.walk(self.fn):
                if not (isinstance(node, ast.Name) and node.id == var):
                    continue
                if node.lineno < ctor_call.lineno:
                    continue
                parent = self.parents.get(node)
                if isinstance(parent, ast.Attribute):
                    gp = self.parents.get(parent)
                    if isinstance(gp, ast.Call) and gp.func is parent and parent.attr in verbs:
                        disposals.append(gp)
                    elif (
                        # t.daemon = True after construction also daemonizes
                        parent.attr == "daemon"
                        and isinstance(parent.ctx, ast.Store)
                        and isinstance(gp, ast.Assign)
                        and isinstance(gp.value, ast.Constant)
                        and gp.value.value
                    ):
                        daemonized = True
                    continue  # other receiver use (start/put/send): neutral
                if isinstance(parent, ast.Call) and node in parent.args:
                    escaped = True
                elif isinstance(parent, _ESCAPE_PARENTS):
                    escaped = True
                elif isinstance(parent, ast.Assign) and node is parent.value:
                    escaped = True  # aliased/stored; owner may dispose it
                elif isinstance(parent, ast.withitem) and node is parent.context_expr:
                    disposals.append(ctor_call)  # `with var:` guarantees close
                elif isinstance(node.ctx, ast.Load) and self._in_nested_def(node):
                    escaped = True  # closure capture outlives this frame
            if escaped or daemonized:
                continue
            if not disposals:
                verbs_s = "/".join(sorted(f".{v}()" for v in verbs))
                out.append(
                    Finding(
                        checker_name,
                        self.module.path,
                        ctor_call.lineno,
                        f"{kind} {var!r} is never disposed ({verbs_s}) and never "
                        "escapes this function — leaked on every path",
                    )
                )
            elif all(
                d is not ctor_call and self._disposal_conditional(d) for d in disposals
            ):
                first = disposals[0]
                out.append(
                    Finding(
                        checker_name,
                        self.module.path,
                        ctor_call.lineno,
                        f"{kind} {var!r} is only disposed on a conditional path "
                        f"(line {first.lineno}) — leaked when that branch is not taken",
                    )
                )
        return out


class ResourceLeakChecker(Checker):
    name = "resource-leak"

    def check_module(self, module: ModuleInfo) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(_FnResources(module, node).findings(self.name))
        return out
