"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere under benchmark/, and nothing of the program in the references
(top-level module names compared whole: cloudy_tpu_torch begins with
cloudy_tpu)."""

import ast

import pytest

from benchmark.tests.support import ROOT

BENCH = ROOT / "benchmark"
NEVER = {"jax", "jaxlib", "flax", "cloudy_tpu"}


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_jax(path):
    assert not _top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "cloudy_tpu_torch" not in _top_level_imports(path)


def test_the_check_compares_whole_names(tmp_path):
    """A prefix test would take the port for the JAX package."""
    p = tmp_path / "m.py"
    p.write_text("import cloudy_tpu_torch.ops\nfrom cloudy_tpu_torch import harness\n")
    assert not _top_level_imports(p) & NEVER
    p.write_text("import jax.numpy as jnp\nfrom cloudy_tpu.ops import special\n")
    assert _top_level_imports(p) & NEVER == {"jax", "cloudy_tpu"}
