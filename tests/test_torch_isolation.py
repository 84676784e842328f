"""The port stands alone: importing every module of ``osmosis_tpu_torch``
loads neither JAX, Flax, ml_dtypes nor the JAX package, and no source of the
port or ``chip_smoke.py`` imports them, or Triton: the kernels are CUDA C++.
Nor do they import the repo's ``tools/`` scripts (which import JAX), or the
``msgpack``, ``optax``, ``orbax``, ``tensorstore`` and ``zstandard`` packages,
which the card's machine lacks: the port reads and writes checkpoints with its
own codecs (msgpack, and OCDBT, zarr and zstd for orbax directories)."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'ml_dtypes', 'osmosis_tpu', 'tools', 'msgpack', 'optax', 'orbax', 'tensorstore', 'zstandard'))\n"
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
    offenders = _importers(["jax", "flax", "ml_dtypes", "osmosis_tpu"])
    assert not offenders, offenders


def test_no_source_imports_triton():
    offenders = _importers(["triton"])
    assert not offenders, offenders


def test_no_source_imports_the_tools_scripts_or_checkpoint_packages():
    offenders = _importers(["tools", "msgpack", "optax", "orbax", "tensorstore", "zstandard"])
    assert not offenders, offenders


STANDALONE = {
    # module: code run after importing it as ``m``
    "osmosis_tpu_torch.tools.real_weights_runbook":
        "assert all(m.tool_cmd(t)[2] == 'osmosis_tpu_torch.tools.' + t\n"
        "           for t in ('validate_checkpoint', 'simulate_degraded', 'evaluate'))",
    "osmosis_tpu_torch.tools.seed_replicate":
        "assert m.cell_command('r128_s50_x0', 1)[2] == 'osmosis_tpu_torch.tools.validate_toy_e2e'\n"
        "assert m.GRID.endswith('_torch.jsonl') and m.SUMMARY.endswith('_torch.json')",
    "osmosis_tpu_torch.tools.cudnn_determinism": "assert callable(m.main)",
    "osmosis_tpu_torch.utils.native":
        "import os\n"
        "m.available()\n"
        "pkg = os.path.join(os.getcwd(), 'osmosis_tpu_torch')\n"
        "assert m.SRC.startswith(pkg + os.sep) and m.lib_path().startswith(pkg + os.sep)",
    "osmosis_tpu_torch.utils.profiling": "m.enable_nan_debugging()",
    "osmosis_tpu_torch.perf": "assert m.configure_from_dict(None).values",
    "osmosis_tpu_torch.parallel.mesh": "assert m.make_mesh().shape == {'dp': 1, 'tp': 1}",
    "osmosis_tpu_torch.parallel.tp": "assert callable(m.parallelize)",
    "osmosis_tpu_torch.tools.mesh_check": "assert callable(m.launch)",
    "osmosis_tpu_torch.utils.zstd":
        "assert m.decompress_py(bytes.fromhex('28b52ffd2003190000') + b'abc') == b'abc'\n"
        "assert m.decompress(m.compress(b'abc')) == m.decompress_py(m.compress(b'abc')) == b'abc'",
    "osmosis_tpu_torch.utils.ocdbt":
        "import tempfile, numpy as np\n"
        "assert m.crc32c(b'123456789') == m.crc32c_py(b'123456789') == 0xE3069283\n"
        "d = tempfile.mkdtemp()\n"
        "with m.Writer(d) as w:\n"
        "    m.write_array(w, 'a', np.arange(5.0), '<f8')\n"
        "assert m.read_array(m.Database(d), 'a')[0].tolist() == [0, 1, 2, 3, 4]",
    "osmosis_tpu_torch.models.convert":
        "import os, tempfile\n"
        "t = m.load_params_orbax(os.path.join('tests', 'data', 'orbax_tiny_unet'))\n"
        "assert 'out_conv' in t['params']\n"
        "d = os.path.join(tempfile.mkdtemp(), 'ck')\n"
        "m.save_params_orbax(t, d)\n"
        "assert m.load_params_orbax(d)['params'].keys() == t['params'].keys()",
    "osmosis_tpu_torch.diffusion.guided":
        "from osmosis_tpu_torch.parallel.mesh import dp_sum\n"
        "assert callable(m.guided_sample_loop) and callable(dp_sum)",
}


@pytest.mark.parametrize("module", sorted(STANDALONE))
def test_the_runbook_and_host_modules_stand_alone(module):
    """The runbook, seed_replicate, the determinism tool, the native host ops
    (built from the port's own source into the port's build dir), profiling,
    perf, the mesh and its tensor-parallel layers, the mesh check, the guided
    loop with its dp reductions, the zstd codec, the OCDBT reader and writer
    and the orbax paths of ``models/convert``: each
    imported and used alone loads nothing of JAX, the JAX package, the repo's
    tools, tensorstore or zstandard, and the tools drive only the port's
    tools."""
    code = (
        "import importlib, sys\n"
        f"m = importlib.import_module({module!r})\n"
        f"{STANDALONE[module]}\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'ml_dtypes', 'osmosis_tpu', 'tools', 'msgpack', 'optax', 'orbax', 'tensorstore', 'zstandard'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
