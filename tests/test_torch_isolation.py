"""The port stands alone: importing every module of ``osmosis_tpu_torch``
loads neither JAX, Flax nor the JAX package, and no source of the port or
``chip_smoke.py`` imports them, or Triton: the kernels are CUDA C++."""

import os
import pkgutil
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "osmosis_tpu_torch")


def _modules():
    names = ["osmosis_tpu_torch"]
    for info in pkgutil.walk_packages([PKG], prefix="osmosis_tpu_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = _modules()
    assert len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'osmosis_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _importers(names):
    alt = "|".join(names)
    statement = re.compile(rf"^\s*(import|from)\s+({alt})(\.|\s|$)", re.M)
    dynamic = re.compile(rf"(import_module|__import__)\(\s*[\"']({alt})[\"'.]")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(PKG):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            src = f.read()
        if statement.search(src) or dynamic.search(src):
            offenders.append(os.path.relpath(path, ROOT))
    return offenders


def test_no_source_imports_jax_or_the_jax_package():
    offenders = _importers(["jax", "flax", "osmosis_tpu"])
    assert not offenders, offenders


def test_no_source_imports_triton():
    offenders = _importers(["triton"])
    assert not offenders, offenders
