"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: the program's name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cachedembedding_tpu"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


def _top_names(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_in_the_benchmark(path):
    assert not _top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert not _top_names(path) & (FORBIDDEN | {"cachedembedding_tpu_torch", "perfbench"})


def test_a_run_loads_no_jax():
    code = ("import sys; import perfbench.run, perfbench.calibrate, perfbench.spread, perfbench.faults; "
            f"print(sorted({{m.split('.')[0] for m in sys.modules}} & set({sorted(FORBIDDEN)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
