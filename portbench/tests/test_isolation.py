"""What the benchmark may import: nothing of JAX or the JAX package
anywhere under ``portbench/``, and nothing of the program under
``portbench/reference/``; top-level module names compared whole."""

import ast
import os

from conftest import HOME

JAX = {"jax", "jaxlib", "flax", "osmosis_tpu"}
PROGRAM = {"osmosis_tpu_torch", "harness", "metrics", "run", "calibrate"}


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(HOME, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_anywhere():
    bad = {p: sorted(set(imported(p)) & JAX) for p in sources()}
    assert not {p: m for p, m in bad.items() if m}


def test_reference_imports_nothing_of_the_program():
    bad = {p: sorted(set(imported(p)) & PROGRAM) for p in sources("reference")}
    assert not {p: m for p, m in bad.items() if m}
    assert "osmosis_tpu_torch" not in "".join(open(p).read() for p in sources("reference"))


def test_whole_names():
    """``osmosis_tpu_torch`` begins with ``osmosis_tpu`` and is not refused."""
    import sys

    import osmosis_tpu_torch  # noqa: F401
    import run
    assert "osmosis_tpu_torch" in sys.modules and run.forbidden_modules() == []
