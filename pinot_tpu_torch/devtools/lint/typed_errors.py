"""typed-error-boundary: no untyped 500 can ship.

Every HTTP handler in this codebase ends in the same shape: specific
`except SomeError:` clauses produce typed responses, and a generic
`except Exception as e:` backstop serializes `code_of(e)` into the
`errorCode` field. `code_of` reads the exception's `error_code` attribute
and silently defaults when there isn't one — so a project exception class
with NO registered `QueryErrorCode` that reaches the backstop becomes an
anonymous 500 the client cannot triage. PRs 4/11/18 audited this by hand,
per hop; this checker does it whole-program:

1. Build exception-escape summaries for every function (see
   `dataflow.EscapeAnalysis`): which project exception classes a call may
   let propagate, with the ORIGIN raise site as witness.
2. At every HTTP handler (`do_GET`/`do_POST`/`do_PUT`/`do_DELETE`/...),
   test each call site and direct raise with `generic_absolves=False`:
   exceptions caught by a SPECIFIC except clause have their own typed
   response path and are absolved; anything that falls through to the
   generic backstop must map to a registered `QueryErrorCode`.
3. A class is registered when its MRO carries an `error_code` class
   attribute (or a method assigns `self.error_code`) whose value is a
   `QueryErrorCode.<member>` or an integer present in the registry.

The registry is discovered structurally — any `class QueryErrorCode` with
integer members in the linted file set (so golden fixtures can carry their
own). No registry in the file set = checker stays silent. Findings land at
the ORIGIN raise site (that is where the fix goes), naming the handler and
the propagation chain.

Known false-positive / false-negative shapes:
- `raise exc_var` (a bound name) and dynamically constructed classes are
  unresolvable — invisible (FN);
- path-insensitive: a raise on a branch the handler can never trigger
  still counts (FP — suppress with a reason at the raise site);
- builtin exceptions (ValueError, KeyError, ...) are not flagged: they are
  legitimately mapped to the default code at the boundary.
"""

from __future__ import annotations

import ast

from pinot_tpu_torch.devtools.lint.core import Checker, Finding, dotted_name
from pinot_tpu_torch.devtools.lint.callgraph import ClassInfo, ProgramIndex

_HANDLERS = {"do_GET", "do_POST", "do_PUT", "do_DELETE", "do_PATCH", "do_HEAD"}
_REGISTRY_CLASS = "QueryErrorCode"


class TypedErrorBoundaryChecker(Checker):
    name = "typed-error-boundary"

    def finalize(self, modules) -> list[Finding]:
        idx = self.session.index
        members, values = self._registry(modules)
        if not members:
            return []
        esc = idx.escapes()
        out: list[Finding] = []
        seen: set[tuple] = set()
        registered: dict[str, bool] = {}  # class qname -> verdict cache
        for fi in idx.functions.values():
            if fi.short not in _HANDLERS:
                continue
            candidates = list(esc.direct_raises(fi, generic_absolves=False))
            for call in fi.calls:
                candidates.extend(esc.call_escapes(fi, call, generic_absolves=False))
            for e in candidates:
                ci = idx.classes.get(e.key)
                if ci is None:
                    continue  # builtin: boundary maps it to the default code
                reg = registered.get(e.key)
                if reg is None:
                    reg = registered[e.key] = self._is_registered(idx, ci, members, values)
                if reg:
                    continue
                key = (e.path, e.line, e.key)
                if key in seen:
                    continue
                seen.add(key)
                chain = " -> ".join(reversed(e.via))
                out.append(
                    Finding(
                        check=self.name,
                        path=e.path,
                        line=e.line,
                        message=(
                            f"raise {ci.name} can escape into HTTP handler {fi.short}()"
                            f" (via {chain}) but {ci.name} has no registered"
                            f" {_REGISTRY_CLASS} — clients get an untyped 500;"
                            f" set error_code = {_REGISTRY_CLASS}.<member>"
                        ),
                    )
                )
        return out

    # -- registry discovery --------------------------------------------------

    @staticmethod
    def _registry(modules) -> tuple[set[str], set[int]]:
        """Member names and integer values of any `class QueryErrorCode`
        in the linted file set."""
        members: set[str] = set()
        values: set[int] = set()
        for mod in modules:
            for node in ast.walk(mod.tree):
                if not (isinstance(node, ast.ClassDef) and node.name == _REGISTRY_CLASS):
                    continue
                for stmt in node.body:
                    if (
                        isinstance(stmt, ast.Assign)
                        and isinstance(stmt.value, ast.Constant)
                        and isinstance(stmt.value.value, int)
                    ):
                        for tgt in stmt.targets:
                            if isinstance(tgt, ast.Name):
                                members.add(tgt.id)
                                values.add(stmt.value.value)
        return members, values

    # -- registration test ---------------------------------------------------

    def _is_registered(self, idx: ProgramIndex, ci: ClassInfo, members, values) -> bool:
        for c in idx.mro(ci):
            for stmt in c.node.body:
                if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "error_code" for t in stmt.targets
                ):
                    if self._value_registered(stmt.value, members, values):
                        return True
            # instance-level: some classes set self.error_code in __init__
            for m in c.methods.values():
                for n in ast.walk(m.node):
                    if (
                        isinstance(n, ast.Assign)
                        and any(
                            isinstance(t, ast.Attribute)
                            and t.attr == "error_code"
                            and isinstance(t.value, ast.Name)
                            and t.value.id == m.self_name
                            for t in n.targets
                        )
                        and self._value_registered(n.value, members, values)
                    ):
                        return True
        return False

    @staticmethod
    def _value_registered(value: ast.AST, members, values) -> bool:
        d = dotted_name(value)
        if d.startswith(_REGISTRY_CLASS + "."):
            return d.rsplit(".", 1)[-1] in members
        if isinstance(value, ast.Constant) and isinstance(value.value, int):
            return value.value in values
        # a reference we cannot evaluate (alias, computed) — trust it
        return bool(d)
