"""Deadline/cancellation discipline (two checks in one module).

deadline-coverage
    Any `for`/`while` loop that contains a fault-injection point
    (`FAULTS.maybe_fail(...)`) is by construction a distributed
    block-processing loop — per-segment execution, stream consumption,
    mailbox retry. Such a loop must also observe the query deadline inside
    the loop body: either call `<something deadline-ish>.check(...)` or
    consult `.remaining()` / `.expired` / `.cancelled` on a deadline-ish
    expression ("deadline-ish" = the dotted source mentions `deadline` or
    `dl`). A loop that injects chaos but never looks at the clock is exactly
    the loop that keeps burning CPU after the query died.

deadline-swallow
    No broad handler (`except Exception`, `except BaseException`, bare
    `except:`) may swallow deadline (code 250) / cancellation (code 503)
    errors. A handler is compliant when any of these hold:

      1. its body contains a bare `raise` (the error continues);
      2. a PRECEDING except clause of the same `try` already catches
         `QueryTimeoutError` / `QueryCancelledError` (so the broad clause
         never sees them);
      3. its body maps the exception to a wire code — calls `code_of(e)`,
         `getattr(e, "error_code", ...)`, or reads `.error_code` — the
         sanctioned response-boundary pattern (the code, hence the class,
         survives in the payload);
      4. its body hands the exception onward via `fut.set_exception(e)` —
         futures are a propagation channel, not a swallow.

    Everything else is a finding: re-raise the typed errors first, or
    suppress with a reason comment if the swallow is provably benign.

    Scope: deadline errors only exist on the query path, so the swallow rule
    applies to modules under `multistage/`, `cluster/`, `query/`, plus
    `client.py` — and to any module that names the deadline classes
    (which is how golden fixtures opt in).
"""

from __future__ import annotations

import ast

from pinot_tpu_torch.devtools.lint.core import Checker, Finding, ModuleInfo, dotted_name, walk_scope

_TYPED_DEADLINE_ERRORS = {"QueryTimeoutError", "QueryCancelledError"}
_BROAD = {"Exception", "BaseException"}
_SWALLOW_SCOPE = ("multistage/", "cluster/", "query/", "client.py")
_PLANE_NAMES = _TYPED_DEADLINE_ERRORS | {"Deadline"}


def _exc_names(type_node: ast.AST | None) -> set[str]:
    """Exception class names a handler catches (last attribute segment)."""
    if type_node is None:
        return {"<bare>"}
    elts = type_node.elts if isinstance(type_node, ast.Tuple) else [type_node]
    out = set()
    for e in elts:
        if isinstance(e, ast.Name):
            out.add(e.id)
        elif isinstance(e, ast.Attribute):
            out.add(e.attr)
    return out


def _deadline_ish(node: ast.AST) -> bool:
    name = dotted_name(node).lower()
    return "deadline" in name or name.split(".")[-1] in ("dl", "dl_") or name == "dl"


class DeadlineChecker(Checker):
    name = "deadline-coverage"  # swallow findings carry their own check id

    def check_module(self, module: ModuleInfo) -> list[Finding]:
        out: list[Finding] = []
        swallow_in_scope = self._swallow_scope(module)
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.For, ast.While)):
                out.extend(self._check_loop(module, node))
            elif isinstance(node, ast.Try) and swallow_in_scope:
                out.extend(self._check_try(module, node))
        return out

    @staticmethod
    def _swallow_scope(module: ModuleInfo) -> bool:
        path = module.path.replace("\\", "/")
        if any(s in path for s in _SWALLOW_SCOPE):
            return True
        for n in ast.walk(module.tree):
            if isinstance(n, ast.Name) and n.id in _PLANE_NAMES:
                return True
            if isinstance(n, ast.ImportFrom) and any(a.name in _PLANE_NAMES for a in n.names):
                return True
        return False

    # -- deadline-coverage ---------------------------------------------------

    def _check_loop(self, module: ModuleInfo, loop) -> list[Finding]:
        body_nodes = [n for stmt in loop.body for n in ast.walk(stmt)]
        inject_line = None
        observes_deadline = False
        for n in body_nodes:
            if isinstance(n, ast.Call):
                fn = n.func
                if isinstance(fn, ast.Attribute):
                    if fn.attr == "maybe_fail" and inject_line is None:
                        inject_line = n.lineno
                    elif fn.attr in ("check", "remaining") and _deadline_ish(fn.value):
                        observes_deadline = True
            elif isinstance(n, ast.Attribute):
                if n.attr in ("expired", "cancelled") and _deadline_ish(n.value):
                    observes_deadline = True
        if inject_line is not None and not observes_deadline:
            return [
                Finding(
                    self.name,
                    module.path,
                    inject_line,
                    "loop contains a fault-injection point but never observes the query deadline "
                    "(call deadline.check(...) or consult remaining()/expired/cancelled in the loop body)",
                )
            ]
        return []

    # -- deadline-swallow ----------------------------------------------------

    def _check_try(self, module: ModuleInfo, node: ast.Try) -> list[Finding]:
        out: list[Finding] = []
        typed_handled = False
        for handler in node.handlers:
            caught = _exc_names(handler.type)
            if caught & _TYPED_DEADLINE_ERRORS:
                typed_handled = True
                # a typed clause that itself swallows defeats the point
                if not (self._reraises(handler) or self._maps_error_code(handler)):
                    out.append(
                        Finding(
                            "deadline-swallow",
                            module.path,
                            handler.lineno,
                            "handler catches a deadline/cancellation error but neither re-raises "
                            "nor maps its error code",
                        )
                    )
                continue
            if not (caught & _BROAD or "<bare>" in caught):
                continue
            if typed_handled or self._reraises(handler) or self._maps_error_code(handler):
                continue
            out.append(
                Finding(
                    "deadline-swallow",
                    module.path,
                    handler.lineno,
                    f"broad handler may swallow QueryTimeoutError/QueryCancelledError "
                    f"({module.src(handler)!r}): re-raise typed deadline errors before generic handling",
                )
            )
        return out

    @staticmethod
    def _reraises(handler: ast.ExceptHandler) -> bool:
        return any(
            isinstance(n, ast.Raise) and n.exc is None for stmt in handler.body for n in walk_scope(stmt)
        ) or any(isinstance(stmt, ast.Raise) and stmt.exc is None for stmt in handler.body)

    @staticmethod
    def _maps_error_code(handler: ast.ExceptHandler) -> bool:
        for stmt in handler.body:
            for n in [stmt, *walk_scope(stmt)]:
                if isinstance(n, ast.Attribute) and n.attr == "error_code":
                    return True
                if isinstance(n, ast.Call):
                    fn = n.func
                    if isinstance(fn, ast.Name) and fn.id == "code_of":
                        return True
                    if isinstance(fn, ast.Attribute) and fn.attr in ("code_of", "set_exception"):
                        return True
                    if (
                        isinstance(fn, ast.Name)
                        and fn.id == "getattr"
                        and len(n.args) >= 2
                        and isinstance(n.args[1], ast.Constant)
                        and n.args[1].value == "error_code"
                    ):
                        return True
        return False
