"""What the benchmark may import and read: no module whose top-level name is
jax's or the JAX package's, anywhere under olap_bench/; nothing of the
program in the reference; none of the repo's older benchmark scripts."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "pinot_tpu"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module",
            "__import__",
        ):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    names.add(arg.value.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    assert SOURCES
    for path in SOURCES:
        # whole top-level names: pinot_tpu_torch is the program, pinot_tpu is not
        assert not top_level_imports(path) & BANNED, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "pinot_tpu_torch" not in top_level_imports(path), path


def test_no_file_reads_the_older_benchmark_scripts():
    names = ("benchmarks/", "bench" + ".py", "chip_smoke", "chip_ab", "BENCH_")
    this = Path(__file__).resolve()
    for path in HERE.rglob("*"):
        if path.is_file() and path.resolve() != this and "__pycache__" not in path.parts:
            text = path.read_text(errors="replace")
            assert not any(n in text for n in names), path


def test_importing_every_module_loads_no_jax():
    modules = [
        ".".join(p.relative_to(HERE.parent).with_suffix("").parts)
        for p in SOURCES
        if p.name != "__init__.py" and "tests" not in p.parts
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"print(sorted({{m.split('.')[0] for m in sys.modules}} & set({sorted(BANNED)!r})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
