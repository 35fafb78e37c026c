"""CLI: `python -m pinot_tpu_torch.devtools.lint [options] path [path ...]`.

Exit status is the CI contract: 0 when no findings survive suppression (and
baseline, when one is given), 1 when any do, 2 on usage errors. Imports
nothing heavy (no torch/jax/pandas): the analyzer is pure-stdlib `ast`, so the
lint step is cheap and runs on a machine with no card.

Baseline workflow: CI runs with `--baseline devtools/lint/baseline.json`,
which tolerates exactly the recorded findings and fails on anything NEW —
so a checker can land before the last legacy finding is fixed without
freezing the tree. Entries are keyed (check, path, message), deliberately
NOT line: unrelated edits above a known finding must not break CI. Refresh
the file with `--update-baseline` after fixing or accepting findings; the
diff then shows exactly which debts were paid or incurred.

Diff mode: `--diff REF` still analyzes the WHOLE given tree (the dataflow
and call-graph checkers need every module to resolve cross-module edges)
but reports only findings that land on lines changed versus the git REF —
the pre-commit shape: full-fidelity analysis, your-diff-only noise. New
(untracked) files report in full. Applied after --baseline, so a run can
combine both.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

from pinot_tpu_torch.devtools.lint import ALL_CHECKERS, Finding, lint_paths

#: messages may cite other source locations ("(line 29)", "at foo.py:111");
#: those drift with unrelated edits just like the finding's own line, so the
#: baseline key normalizes them away
_LINE_REF_RE = re.compile(r"(line |:)\d+")


def _norm_message(message: str) -> str:
    return _LINE_REF_RE.sub(r"\1N", message)


def _baseline_key(f: Finding) -> tuple[str, str, str]:
    return (f.check, f.path, _norm_message(f.message))


def load_baseline(path: str) -> Counter:
    """Baseline file -> multiset of tolerated (check, path, message) keys."""
    doc = json.loads(Path(path).read_text(encoding="utf-8"))
    entries = doc["findings"] if isinstance(doc, dict) else doc
    return Counter((e["check"], e["path"], _norm_message(e["message"])) for e in entries)


def apply_baseline(findings: list[Finding], budget: Counter) -> list[Finding]:
    """Findings not covered by the baseline multiset (each entry tolerates
    one occurrence, so a DUPLICATED known finding still fails)."""
    budget = Counter(budget)  # caller's copy stays intact
    fresh: list[Finding] = []
    for f in findings:
        k = _baseline_key(f)
        if budget[k] > 0:
            budget[k] -= 1
        else:
            fresh.append(f)
    return fresh


def write_baseline(path: str, findings: list[Finding]) -> None:
    entries = [
        {"check": c, "path": p, "message": m}
        for c, p, m in sorted(_baseline_key(f) for f in findings)
    ]
    doc = {"version": 1, "findings": entries}
    Path(path).write_text(json.dumps(doc, indent=2) + "\n", encoding="utf-8")


#: sources a finding can land in: the modules, and the CUDA sources whose
#: launch entries kernel-registry checks
_DIFF_GLOBS = ("*.py", "*.cu")

#: unified-diff hunk header: `@@ -old[,n] +start[,count] @@ ...`
_HUNK_RE = re.compile(r"@@ -\d+(?:,\d+)? \+(\d+)(?:,(\d+))? @@")


def changed_lines(ref: str, anchor: str) -> dict[str, set[int] | None]:
    """Absolute path -> set of line numbers added/modified versus git `ref`
    (value None = untracked file: every line counts as changed). `anchor`
    is any path inside the repository. Raises ValueError on a bad ref or a
    non-git tree."""

    def run(cwd: str, *a: str):
        return subprocess.run(["git", "-C", cwd, *a], capture_output=True, text=True)

    top = run(anchor, "rev-parse", "--show-toplevel")
    if top.returncode != 0:
        raise ValueError(top.stderr.strip() or "not a git repository")
    root = top.stdout.strip()
    # run from the root so every path (diff headers AND ls-files output)
    # comes back root-relative, whatever subdirectory anchored us
    diff = run(root, "diff", "-U0", ref, "--", *_DIFF_GLOBS)
    if diff.returncode != 0:
        raise ValueError(diff.stderr.strip() or f"bad ref {ref!r}")
    out: dict[str, set[int] | None] = {}
    cur: str | None = None
    for line in diff.stdout.splitlines():
        if line.startswith("+++ "):
            name = line[4:].strip()
            if name == "/dev/null":  # deletion: nothing to report on
                cur = None
            else:
                cur = os.path.join(root, name[2:] if name.startswith("b/") else name)
        elif line.startswith("@@") and cur is not None:
            m = _HUNK_RE.match(line)
            if m:
                start, count = int(m.group(1)), int(m.group(2) or "1")
                if count:
                    bucket = out.setdefault(cur, set())
                    if bucket is not None:
                        bucket.update(range(start, start + count))
    unt = run(root, "ls-files", "--others", "--exclude-standard", "--", *_DIFF_GLOBS)
    if unt.returncode == 0:
        for name in unt.stdout.splitlines():
            if name.strip():
                out[os.path.join(root, name.strip())] = None
    return out


def apply_diff_filter(
    findings: list[Finding], changed: dict[str, set[int] | None]
) -> list[Finding]:
    """Findings on changed lines (or anywhere in an untracked file)."""
    fresh: list[Finding] = []
    for f in findings:
        p = os.path.abspath(f.path)
        if p not in changed:
            continue
        lines = changed[p]
        if lines is None or f.line in lines:
            fresh.append(f)
    return fresh


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pinot_tpu_torch.devtools.lint",
        description="pinotlint: project-invariant static analyzer",
    )
    ap.add_argument("paths", nargs="*", help=".py files or directories to analyze")
    ap.add_argument(
        "--check",
        action="append",
        metavar="NAME",
        help=f"run only this checker (repeatable); known: {', '.join(ALL_CHECKERS)}",
    )
    ap.add_argument("--list", action="store_true", help="list checkers and exit")
    ap.add_argument(
        "--require-reason",
        action="store_true",
        help="flag suppression comments that carry no reason text",
    )
    ap.add_argument(
        "--json",
        action="store_true",
        help="emit findings as a JSON array on stdout (machine-readable)",
    )
    ap.add_argument(
        "--baseline",
        metavar="FILE",
        help="tolerate the findings recorded in FILE; only NEW findings fail",
    )
    ap.add_argument(
        "--diff",
        metavar="REF",
        help=(
            "analyze the whole tree but report only findings on lines changed"
            " versus git REF (untracked files report in full)"
        ),
    )
    ap.add_argument(
        "--update-baseline",
        action="store_true",
        help="rewrite the --baseline FILE from the current findings and exit 0",
    )
    args = ap.parse_args(argv)
    if args.list:
        for name, cls in ALL_CHECKERS.items():
            doc = (cls.__module__ and sys.modules[cls.__module__].__doc__) or ""
            print(f"{name}: {doc.strip().splitlines()[0] if doc else ''}")
        return 0
    if not args.paths:
        ap.print_usage(sys.stderr)
        return 2
    if args.update_baseline and not args.baseline:
        print("pinotlint: error: --update-baseline requires --baseline FILE", file=sys.stderr)
        return 2
    try:
        findings = lint_paths(args.paths, checks=args.check, require_reason=args.require_reason)
    except (FileNotFoundError, KeyError) as e:
        print(f"pinotlint: error: {e}", file=sys.stderr)
        return 2
    if args.update_baseline:
        write_baseline(args.baseline, findings)
        print(
            f"pinotlint: baseline updated with {len(findings)} finding"
            f"{'s' if len(findings) != 1 else ''}: {args.baseline}",
            file=sys.stderr,
        )
        return 0
    if args.baseline:
        try:
            budget = load_baseline(args.baseline)
        except (OSError, ValueError, KeyError, TypeError) as e:
            print(f"pinotlint: error: bad baseline {args.baseline}: {e}", file=sys.stderr)
            return 2
        findings = apply_baseline(findings, budget)
    if args.diff:
        anchor = os.path.abspath(args.paths[0])
        if not os.path.isdir(anchor):
            anchor = os.path.dirname(anchor) or "."
        try:
            changed = changed_lines(args.diff, anchor)
        except ValueError as e:
            print(f"pinotlint: error: --diff {args.diff}: {e}", file=sys.stderr)
            return 2
        findings = apply_diff_filter(findings, changed)
    if args.json:
        print(
            json.dumps(
                [
                    {"check": f.check, "path": f.path, "line": f.line, "message": f.message}
                    for f in findings
                ],
                indent=2,
            )
        )
    else:
        for f in findings:
            print(f)
    n = len(findings)
    label = "new finding" if args.baseline else "finding"
    print(f"pinotlint: {n} {label}{'s' if n != 1 else ''}" if n else "pinotlint: clean", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
