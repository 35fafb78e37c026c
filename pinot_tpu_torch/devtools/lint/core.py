"""pinotlint core: file collection, AST parsing, suppression handling, and
the checker runner.

The framework is deliberately tiny: a checker is a class with a `name`, an
optional per-file pass (`check_module`) and an optional whole-program pass
(`finalize`) that runs after every module has been visited — whole-program
checkers (fault-point registry, error-code registry) accumulate state in
`check_module` and cross-reference it in `finalize`.

Findings are structured (check id, path, line, message) so tests can assert
exact locations. A finding is suppressed by a trailing comment on its line:

    something_flagged()  # pinotlint: disable=<check>[,<check>...] — reason

The reason text after the check list is free-form but conventionally present;
`--require-reason` (the CI default via __main__) makes a bare suppression
itself a finding, so every silenced site documents why.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path


@dataclass(frozen=True)
class Finding:
    check: str  # checker id, e.g. "race-discipline"
    path: str  # path as given/collected (repo-relative when possible)
    line: int  # 1-indexed
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.check}] {self.message}"


@dataclass
class ModuleInfo:
    """One parsed source file handed to per-file passes."""

    path: str
    tree: ast.Module
    lines: list[str]  # raw source lines, 0-indexed

    def src(self, node: ast.AST) -> str:
        """Source text of a node's first line (for messages)."""
        try:
            return self.lines[node.lineno - 1].strip()
        except (AttributeError, IndexError):
            return ""


_SUPPRESS_RE = re.compile(r"#\s*pinotlint:\s*disable=([\w,\-]+)(.*)")


@dataclass
class Suppressions:
    """Per-file map of line -> set of suppressed check names. `all` entries
    come from `disable=all`."""

    by_line: dict[int, set[str]] = field(default_factory=dict)
    #: lines whose suppression comment carries no reason text (CI policy)
    bare_lines: list[int] = field(default_factory=list)

    @classmethod
    def parse(cls, lines: list[str]) -> "Suppressions":
        out = cls()
        for i, line in enumerate(lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m is None:
                continue
            out.by_line[i] = {c.strip() for c in m.group(1).split(",") if c.strip()}
            if not m.group(2).strip(" \t—-:·"):
                out.bare_lines.append(i)
        return out

    def covers(self, finding: Finding) -> bool:
        checks = self.by_line.get(finding.line)
        return checks is not None and (finding.check in checks or "all" in checks)


class AnalysisSession:
    """One lint run's shared analysis state: every checker sees the same
    parsed modules, and the whole-program `ProgramIndex` (call graph + lock
    summaries, see callgraph.py) is built lazily ONCE and reused by every
    checker that needs it — race-discipline, lock-order and
    blocking-under-lock all pay for one build, which is what keeps the
    whole-package run inside the `lint_runtime` budget."""

    def __init__(self, modules: list[ModuleInfo]):
        self.modules = modules
        self._index = None

    @property
    def index(self):
        if self._index is None:
            from pinot_tpu_torch.devtools.lint.callgraph import ProgramIndex

            self._index = ProgramIndex.build(self.modules)
        return self._index


class Checker:
    """Base class. Subclasses set `name` and override one or both passes.
    The runner assigns `self.session` (an AnalysisSession) before the first
    pass; whole-program checkers read `self.session.index`."""

    name: str = ""
    session: AnalysisSession | None = None

    def check_module(self, module: ModuleInfo) -> list[Finding]:
        return []

    def finalize(self, modules: list[ModuleInfo]) -> list[Finding]:
        """Whole-program pass, called once after every check_module call."""
        return []


def collect_files(paths: list[str]) -> list[Path]:
    """Expand files/directories into a sorted list of .py files. Hidden
    directories and __pycache__ are skipped."""
    out: set[Path] = set()
    for p in paths:
        pp = Path(p)
        if pp.is_dir():
            for f in pp.rglob("*.py"):
                if any(part.startswith(".") or part == "__pycache__" for part in f.parts):
                    continue
                out.add(f)
        elif pp.suffix == ".py":
            out.add(pp)
        else:
            raise FileNotFoundError(f"not a python file or directory: {p}")
    return sorted(out)


def parse_module(path: Path) -> ModuleInfo:
    text = path.read_text(encoding="utf-8")
    return ModuleInfo(path=str(path), tree=ast.parse(text, filename=str(path)), lines=text.splitlines())


def run(
    paths: list[str],
    checkers: list[Checker],
    require_reason: bool = False,
) -> list[Finding]:
    """Run `checkers` over every .py file under `paths`; returns surviving
    (unsuppressed) findings sorted by location. A file that fails to parse
    yields a single `parse-error` finding instead of aborting the run."""
    modules: list[ModuleInfo] = []
    findings: list[Finding] = []
    suppressions: dict[str, Suppressions] = {}
    for path in collect_files(paths):
        try:
            mod = parse_module(path)
        except SyntaxError as e:
            findings.append(Finding("parse-error", str(path), e.lineno or 1, str(e.msg)))
            continue
        modules.append(mod)
        sup = Suppressions.parse(mod.lines)
        suppressions[mod.path] = sup
        if require_reason:
            for ln in sup.bare_lines:
                findings.append(
                    Finding("suppression-reason", mod.path, ln, "suppression comment has no reason text")
                )
    session = AnalysisSession(modules)
    for checker in checkers:
        checker.session = session
    for mod in modules:
        for checker in checkers:
            findings.extend(checker.check_module(mod))
    for checker in checkers:
        findings.extend(checker.finalize(modules))
    survivors = {
        f
        for f in findings
        if f.check == "suppression-reason" or not suppressions.get(f.path, Suppressions()).covers(f)
    }
    return sorted(survivors, key=lambda f: (f.path, f.line, f.check, f.message))


# --- path scoping -------------------------------------------------------------

#: the package whose files the path-scoped rules (module names, the query
#: path, the kernel path) apply to
PACKAGE = "pinot_tpu_torch"


def _split_at_package(path: str) -> tuple[list[str], int] | None:
    parts = path.replace("\\", "/").split("/")
    roots = [i for i, part in enumerate(parts[:-1]) if part == PACKAGE]
    return (parts, roots[-1]) if roots else None


def package_parts(path: str) -> list[str] | None:
    """Parts of `path` from its innermost `pinot_tpu_torch` directory down to
    the file name (`[PACKAGE, "query", "plan.py"]`), or None when no
    directory of the path is that package."""
    split = _split_at_package(path)
    return split[0][split[1]:] if split else None


def package_root(path: str) -> str | None:
    """The innermost `pinot_tpu_torch` directory of `path`, spelled as in
    `path`, or None."""
    split = _split_at_package(path)
    return "/".join(split[0][: split[1] + 1]) if split else None


def in_package_dirs(path: str, dirs: tuple[str, ...]) -> bool:
    """Whether `path` lies under one of `dirs` inside the package."""
    parts = package_parts(path)
    return parts is not None and any(d in parts[1:-1] for d in dirs)


# --- small AST helpers shared by checkers -----------------------------------


def dotted_name(node: ast.AST) -> str:
    """Best-effort dotted source of a Name/Attribute chain ('' otherwise):
    `ctx.mailbox.deadline` -> "ctx.mailbox.deadline"."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def walk_scope(node: ast.AST):
    """Yield nodes of `node`'s body WITHOUT descending into nested function
    or class definitions (lexical-scope walk)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))
