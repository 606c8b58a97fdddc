"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level module names; the references import nothing of the program."""

import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.run import forbidden_modules  # noqa: E402

HARNESS = sorted(p for p in (ROOT / "perfbench").rglob("*.py")
                 if "tests" not in p.parts)


def _roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_top_level_names_are_compared_whole():
    loaded = {"repro_torch": 1, "repro_torch.models": 1, "jaxtyping": 1,
              "flaxen.x": 1, "reproduce": 1, "torch": 1}
    assert forbidden_modules(loaded) == []
    loaded.update({"repro": 1, "repro.core.batched": 1, "jax.numpy": 1,
                   "jaxlib": 1, "flax.linen": 1})
    assert forbidden_modules(loaded) == ["flax.linen", "jax.numpy", "jaxlib",
                                         "repro", "repro.core.batched"]


@pytest.mark.parametrize("path", HARNESS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_harness_imports_no_jax(path):
    assert not _roots(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench" / "reference")
                                        .glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _roots(path) <= {"__future__", "math", "torch"}


def test_a_run_loads_no_jax():
    import os
    import subprocess

    code = ("import sys; sys.argv = ['run']; import perfbench.run as r; "
            "r._fixed_caches(); import perfbench.kinds.decode_pool, "
            "perfbench.lib.judge, perfbench.lib.trace; "
            "import perfbench.reference.moe, perfbench.reference.hybrid; "
            "import repro_torch.models, repro_torch.serve.step; "
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ,
                                  PYTHONPATH=f"{ROOT}:{ROOT / 'src'}"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
