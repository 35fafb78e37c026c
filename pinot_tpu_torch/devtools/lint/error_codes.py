"""error-code-registry: numeric query error codes must come from the
`QueryErrorCode` registry (`pinot_tpu_torch/common/errors.py`), never be re-typed
as magic literals at call sites.

The checker first discovers the registry — a `class QueryErrorCode` whose
body assigns names to int literals — anywhere in the analyzed file set
(so fixtures can carry their own), then flags any of those registered
numbers appearing as a bare int literal in an error-code POSITION outside
the registry module:

  * assignment to a target named `error_code` (incl. class attributes)
  * keyword argument `error_code=<n>` / default value of an `error_code` param
  * dict literal entry `"errorCode": <n>`
  * `getattr(x, "error_code", <n>)`
  * comparison against an `.error_code` attribute

Positional precision is the point: `send_response(200)` or `range(250)` are
never error codes and are never flagged.
"""

from __future__ import annotations

import ast

from pinot_tpu_torch.devtools.lint.core import Checker, Finding, ModuleInfo

_REGISTRY_CLASS = "QueryErrorCode"


def _int_literal(node: ast.AST) -> int | None:
    if isinstance(node, ast.Constant) and type(node.value) is int:
        return node.value
    return None


class ErrorCodeChecker(Checker):
    name = "error-code-registry"

    def __init__(self):
        self._codes: set[int] = set()
        # registry class body spans: (path, first line, last line)
        self._registry_spans: list[tuple[str, int, int]] = []
        # (path, line, code) candidates, filtered against the registry in finalize
        self._hits: list[tuple[str, int, int]] = []

    def check_module(self, module: ModuleInfo) -> list[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef) and node.name == _REGISTRY_CLASS:
                self._registry_spans.append((module.path, node.lineno, node.end_lineno or node.lineno))
                for stmt in node.body:
                    if isinstance(stmt, ast.Assign):
                        v = _int_literal(stmt.value)
                        if v is not None:
                            self._codes.add(v)
        for path, line, code in self._collect(module):
            self._hits.append((path, line, code))
        return []

    def _collect(self, module: ModuleInfo):
        def hit(node, code):
            if code is not None:
                yield (module.path, getattr(node, "lineno", 1), code)

        for node in ast.walk(module.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                names = {t.id for t in targets if isinstance(t, ast.Name)}
                names |= {t.attr for t in targets if isinstance(t, ast.Attribute)}
                if any(n == "error_code" or n.endswith("_error_code") for n in names):
                    yield from hit(node.value, _int_literal(node.value))
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "error_code":
                        yield from hit(kw.value, _int_literal(kw.value))
                fn = node.func
                if (
                    isinstance(fn, ast.Name)
                    and fn.id == "getattr"
                    and len(node.args) == 3
                    and isinstance(node.args[1], ast.Constant)
                    and node.args[1].value == "error_code"
                ):
                    yield from hit(node.args[2], _int_literal(node.args[2]))
            elif isinstance(node, ast.FunctionDef):
                # default value of an `error_code` parameter
                for a, d in zip(reversed(node.args.args), reversed(node.args.defaults)):
                    if a.arg == "error_code":
                        yield from hit(d, _int_literal(d))
                for a, d in zip(node.args.kwonlyargs, node.args.kw_defaults):
                    if a.arg == "error_code" and d is not None:
                        yield from hit(d, _int_literal(d))
            elif isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if isinstance(k, ast.Constant) and k.value == "errorCode":
                        yield from hit(v, _int_literal(v))
            elif isinstance(node, ast.Compare):
                sides = [node.left] + list(node.comparators)
                if any(isinstance(s, ast.Attribute) and s.attr == "error_code" for s in sides):
                    for s in sides:
                        yield from hit(s, _int_literal(s))

    def finalize(self, modules) -> list[Finding]:
        out: list[Finding] = []
        if not self._codes:
            return out  # no registry in scope: nothing to enforce against
        for path, line, code in self._hits:
            if any(p == path and lo <= line <= hi for p, lo, hi in self._registry_spans):
                continue  # the registry's own definitions
            if code in self._codes:
                out.append(
                    Finding(
                        self.name,
                        path,
                        line,
                        f"magic error code {code}: import it from the QueryErrorCode registry (common/errors.py)",
                    )
                )
        return sorted(out, key=lambda f: (f.path, f.line))
    # NOTE: unregistered ints in error-code positions are allowed on purpose —
    # tests and callers may invent codes; the invariant is that REGISTERED
    # codes have exactly one definition site.
