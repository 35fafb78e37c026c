"""kernel-registry: every launch of a hand-written kernel under `query/` +
`ops/` goes through the KernelRegistry (common/kernel_obs.py), and every
CUDA launch entry has a wrapper that launches it.

The kernel & memory observability plane only sees what runs inside
`KERNELS.launch(name, fn, ...)`: a kernel launched around it executes
invisibly — no launch count, no device-time attribution, no bytes-moved cost
model, a hole in `/debug/roofline`. The port's compiled work is a ctypes
call of an `extern "C"` entry of `ops/csrc/*.cu`; a *launch entry* is one
whose parameters include a `stream` (a `cudaStream_t` or a parameter so
named). The `*_plan`, `*_scratch`, `*_shared_limit`, `*_sparse_max` and
`*_uses_shared` entries take none: they are host queries. Two rules:

registered-launch
    In `pinot_tpu_torch/` files under a `query/` or `ops/` directory, every
    call `<lib>.<launch entry>(...)` must sit inside the arguments of a
    `KERNELS.launch("<name>", ...)` call (a lambda argument counts), and
    `<name>` must be a string literal that a `KERNELS.register("<name>",
    ...)` in the same module registers. A compiled root (jit_purity's:
    `torch.compile`, `torch.jit.script`, `@triton.jit`, a captured CUDA
    graph) is held to the same rule at each of its calls — `f(...)`,
    `kernel[grid](...)`, `graph.replay()`; a root the module never calls
    must be named by a register call, or carry a disable-with-reason. A
    graph's `replay()` may also sit in a registered program record: the
    body of `with KERNELS.program("<name>", ...)` (a compiled per-segment
    program's event pair) or the arguments of `KERNELS.timed_sync("<name>",
    ...)`, whose event pair spans the replay.

launched-entry
    Every launch entry in the `ops/csrc/*.cu` beside an analyzed `ops/`
    module is called (`<lib>.<entry>(...)`) from at least one analyzed
    module of the same package: a CUDA kernel that no wrapper launches is a
    finding at its `.cu` line. A `.cu` line takes no suppression comment:
    delete the entry or write its wrapper.

The launch entries are read from the `.cu` sources of the package the
module sits in (`<pinot_tpu_torch>/ops/csrc/*.cu`), so a run over `query/`
alone still knows them. `launch_inventory(paths)` maps each launch entry to
the registered name it launches under.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from pinot_tpu_torch.devtools.lint.core import (
    Checker,
    Finding,
    ModuleInfo,
    collect_files,
    dotted_name,
    in_package_dirs,
    package_root,
    parse_module,
)
from pinot_tpu_torch.devtools.lint.jit_purity import CapturedBody, _ScopedDefs, compiled_roots, is_compiler

_KERNEL_PATH_DIRS = ("query", "ops")
_MESSAGE_TAIL = "invisible to the kernel observability plane (/debug/roofline, engine.kernel.* metrics)"

#: `extern "C" <type> name(params) {`: a definition, not a declaration
_EXTERN_RE = re.compile(r'extern\s+"C"\s+[^;{()]*?\b(\w+)\s*\(([^)]*)\)\s*\{')
_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


def _on_kernel_path(path: str) -> bool:
    return in_package_dirs(path, _KERNEL_PATH_DIRS)


def _blank_comments(text: str) -> str:
    """Comments replaced by their newlines, so offsets keep their lines."""
    return _COMMENT_RE.sub(lambda m: "\n" * m.group(0).count("\n"), text)


def _takes_stream(params: str) -> bool:
    for param in params.split(","):
        words = re.findall(r"\w+", param)
        if words and (words[-1] == "stream" or "cudaStream_t" in words):
            return True
    return False


def cuda_launch_entries(csrc: Path) -> dict[str, tuple[str, int]]:
    """Launch entries of every `*.cu` in `csrc` -> (source path, line of
    its `extern "C"`)."""
    out: dict[str, tuple[str, int]] = {}
    for cu in sorted(csrc.glob("*.cu")):
        text = _blank_comments(cu.read_text(encoding="utf-8"))
        for m in _EXTERN_RE.finditer(text):
            if _takes_stream(m.group(2)):
                out.setdefault(m.group(1), (str(cu), text.count("\n", 0, m.start()) + 1))
    return out


def _csrc_of(path: str) -> Path | None:
    root = package_root(path)
    return Path(root) / "ops" / "csrc" if root is not None else None


def _is_registry_call(call: ast.Call, method: str) -> bool:
    name = dotted_name(call.func)
    return name == f"KERNELS.{method}" or name.endswith(f".KERNELS.{method}")


def _parents(tree: ast.Module) -> dict[ast.AST, ast.AST]:
    out: dict[ast.AST, ast.AST] = {}
    for p in ast.walk(tree):
        for c in ast.iter_child_nodes(p):
            out[c] = p
    return out


#: the registry records a graph's replay may sit in, beside a launch
_PROGRAM_RECORDS = ("launch", "program", "timed_sync")


def _enclosing_launch(node: ast.AST, parents: dict[ast.AST, ast.AST], records=("launch",)) -> ast.Call | None:
    """The registry call among `records` (`KERNELS.launch(...)` by default)
    whose arguments hold `node`, or the `with KERNELS.program(...)` whose
    body does (when "program" is among them), crossing lambdas and `with`
    blocks but no function definition."""
    child, cur = node, parents.get(node)
    while cur is not None and not isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        if isinstance(cur, ast.Call) and child is not cur.func and any(_is_registry_call(cur, m) for m in records):
            return cur
        if isinstance(cur, ast.With) and "program" in records and child in cur.body:
            for item in cur.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call) and _is_registry_call(expr, "program"):
                    return expr
        child, cur = cur, parents.get(cur)
    return None


def _is_replay(call: ast.Call) -> bool:
    return isinstance(call.func, ast.Attribute) and call.func.attr == "replay"


def _launch_name(call: ast.Call) -> str | None:
    """The kernel name a `KERNELS.launch` call passes, when a literal."""
    arg = call.args[0] if call.args else next((kw.value for kw in call.keywords if kw.arg == "name"), None)
    return arg.value if isinstance(arg, ast.Constant) and isinstance(arg.value, str) else None


def _registered(tree: ast.Module) -> set[str]:
    """Names and string literals handed to `*.register(...)` /
    `register_kernel(...)` in the module."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or dotted_name(node.func).split(".")[-1] not in ("register", "register_kernel"):
            continue
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(a, ast.Name):
                out.add(a.id)
            elif isinstance(a, ast.Constant) and isinstance(a.value, str):
                out.add(a.value)
    return out


def _entry_calls(tree: ast.Module, entries) -> list[tuple[str, ast.Call]]:
    """Every `<lib>.<launch entry>(...)` call of the module."""
    return [
        (node.func.attr, node)
        for node in ast.walk(tree)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr in entries
    ]


def _root_calls(tree: ast.Module, defs: _ScopedDefs) -> dict[object, tuple[str, list[ast.Call]]]:
    """Every compiled root of the module -> (its name, its calls): `f(...)`
    and `f[grid](...)` for a def and for a name bound to `torch.compile(...)`,
    `g.replay()` for a captured graph `g`."""
    roots = compiled_roots(tree, defs)
    labels = {root: getattr(root, "name", "<lambda>") for root in roots}
    names = {root.name: root for root in roots if isinstance(root, ast.FunctionDef)}
    graphs = {root.graph: root for root in roots if isinstance(root, CapturedBody) and root.graph}
    for node in ast.walk(tree):
        # `f = torch.compile(g)`: calls of f are calls of the root
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Call)
            and is_compiler(node.value.func)
            and node.value.args
        ):
            arg = node.value.args[0]
            wrapped = defs.resolve(node.value, arg.id) if isinstance(arg, ast.Name) else arg
            if wrapped in roots:
                names[node.targets[0].id] = wrapped
                if isinstance(wrapped, ast.Lambda):
                    labels[wrapped] = node.targets[0].id
    calls: dict[object, list[ast.Call]] = {root: [] for root in roots}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func.value if isinstance(node.func, ast.Subscript) else node.func
        if isinstance(fn, ast.Name) and fn.id in names:
            calls[names[fn.id]].append(node)
        elif isinstance(fn, ast.Attribute) and fn.attr == "replay" and dotted_name(fn.value) in graphs:
            calls[graphs[dotted_name(fn.value)]].append(node)
    return {root: (labels[root], calls[root]) for root in roots}


class KernelRegistryChecker(Checker):
    name = "kernel-registry"

    def __init__(self):
        self._entries: dict[Path, dict[str, tuple[str, int]]] = {}
        #: package csrc directories whose ops/ modules are in the run
        self._ops_csrc: set[Path] = set()
        #: csrc directory -> launch entries some analyzed module calls
        self._called: dict[Path, set[str]] = {}

    def _entries_of(self, csrc: Path | None) -> dict[str, tuple[str, int]]:
        if csrc is None:
            return {}
        if csrc not in self._entries:
            self._entries[csrc] = cuda_launch_entries(csrc) if csrc.is_dir() else {}
        return self._entries[csrc]

    def check_module(self, module: ModuleInfo) -> list[Finding]:
        csrc = _csrc_of(module.path)
        entries = self._entries_of(csrc)
        calls = _entry_calls(module.tree, entries)
        if csrc is not None:
            self._called.setdefault(csrc, set()).update(e for e, _ in calls)
            if in_package_dirs(module.path, ("ops",)):
                self._ops_csrc.add(csrc)
        if not _on_kernel_path(module.path):
            return []
        parents = _parents(module.tree)
        registered = _registered(module.tree)
        out: list[Finding] = []
        for entry, call in calls:
            out.extend(self._check_launch(module, call, f"CUDA launch entry {entry!r}", parents, registered))
        defs = _ScopedDefs()
        defs.visit(module.tree)
        for root, (name, root_calls) in _root_calls(module.tree, defs).items():
            for call in root_calls:
                records = _PROGRAM_RECORDS if _is_replay(call) else ("launch",)
                out.extend(self._check_launch(module, call, f"compiled root {name!r}", parents, registered, records))
            if not root_calls and name not in registered:
                out.append(
                    Finding(
                        self.name, module.path, root.lineno,
                        f"registered-launch: compiled kernel root {name!r} is never launched through "
                        f"KERNELS.launch(...) in this module and no KERNELS.register names it: it runs "
                        f"{_MESSAGE_TAIL}",
                    )
                )
        return sorted(out, key=lambda f: (f.line, f.message))

    def _check_launch(self, module, call, what, parents, registered, records=("launch",)) -> list[Finding]:
        launch = _enclosing_launch(call, parents, records)
        if launch is None:
            why = "is called outside KERNELS.launch(...)" + (
                " and outside a program record (KERNELS.program / KERNELS.timed_sync)" if len(records) > 1 else ""
            )
        else:
            name = _launch_name(launch)
            if name is None:
                why = "is launched under a KERNELS.launch(...) whose kernel name is not a string literal"
            elif name not in registered:
                why = f"is launched as {name!r}, which no KERNELS.register({name!r}, ...) in this module registers"
            else:
                return []
        return [Finding(self.name, module.path, call.lineno, f"registered-launch: {what} {why}: it runs {_MESSAGE_TAIL}")]

    def finalize(self, modules) -> list[Finding]:
        out: list[Finding] = []
        for csrc in sorted(self._ops_csrc):
            called = self._called.get(csrc, set())
            for entry, (path, line) in sorted(self._entries_of(csrc).items()):
                if entry not in called:
                    out.append(
                        Finding(
                            self.name, path, line,
                            f"launched-entry: CUDA launch entry {entry!r} is called from no wrapper: "
                            "a kernel no module launches is dead code (delete it, or launch it through "
                            "KERNELS.launch in its ops/ module)",
                        )
                    )
        return out


def launch_inventory(paths: list[str]) -> dict[str, str]:
    """Launch entry -> the registered name it launches under, from every
    `<lib>.<entry>(...)` call inside a `KERNELS.launch("<name>", ...)` of
    the `query/` and `ops/` modules under `paths` (the first such call, in
    path and line order, where an entry has several)."""
    out: dict[str, str] = {}
    for path in collect_files(paths):
        if not _on_kernel_path(str(path)):
            continue
        module = parse_module(path)
        entries = cuda_launch_entries(_csrc_of(module.path))
        parents = _parents(module.tree)
        for entry, call in sorted(_entry_calls(module.tree, entries), key=lambda ec: ec[1].lineno):
            launch = _enclosing_launch(call, parents)
            name = _launch_name(launch) if launch is not None else None
            if name is not None:
                out.setdefault(entry, name)
    return dict(sorted(out.items()))
