"""The port's native host ops (``osmosis_tpu_torch.utils.native``, its own
copy of ``host_ops.cc``) on the CPU: preprocessing gives exactly the port's
numpy path and the JAX package's native result (max difference 0.0), the
percentile norm and the colormap match them to 1e-6, the PNG writer writes
the JAX native writer's bytes, which decode to PIL's pixels, and
``OSMOSIS_TPU_NO_NATIVE`` selects the numpy path. Each test needs the
library built here (g++ and zlib, as this machine has)."""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from osmosis_tpu_torch.data import postprocess as P
from osmosis_tpu_torch.data import transforms as T
from osmosis_tpu_torch.utils import native as N

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from osmosis_tpu.utils import native as JN  # noqa: E402

SHAPES = [(256, 256), (300, 400), (480, 640), (1000, 333), (257, 255)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def numpy_path():
    """``with numpy_path():`` runs its block with OSMOSIS_TPU_NO_NATIVE set."""
    @contextlib.contextmanager
    def switch():
        os.environ[N.NO_NATIVE_ENV] = "1"
        try:
            yield
        finally:
            del os.environ[N.NO_NATIVE_ENV]
    return switch


def test_the_library_builds_and_is_the_ports_own():
    assert N.available(), N.build_error()
    assert N.status().startswith("native (libhost_ops-")
    assert os.path.dirname(N.SRC).endswith(os.path.join("osmosis_tpu_torch", "utils", "csrc"))
    assert os.path.commonpath([N.lib_path(), os.path.dirname(os.path.dirname(N.SRC))])


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_preprocess_is_exactly_the_numpy_path_and_jax_native(shape, numpy_path):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    got = N.preprocess_rgb_u8(img, 256)
    assert got.shape == (256, 256, 3) and got.dtype == np.float32
    assert np.array_equal(T.preprocess_image(Image.fromarray(img), 256), got)
    with numpy_path():
        want = T.preprocess_image(Image.fromarray(img), 256)
    assert np.abs(got - want).max() == 0.0
    assert np.abs(got - JN.preprocess_rgb_u8(img, 256)).max() == 0.0


@pytest.mark.parametrize("lo,hi", [(0.03, 0.99), (0.05, 0.99), (0.0, 1.0)])
def test_percentile_norm_and_colormap_match_numpy_and_jax(lo, hi, numpy_path):
    rng = np.random.default_rng(3)
    depth = (rng.standard_normal((64, 48)) * 2 + 1).astype(np.float32)
    got = P.min_max_norm_range_percentile(depth, percent_low=lo, percent_high=hi)
    color = P.depth_to_color(got)
    with numpy_path():
        want = P.min_max_norm_range_percentile(depth, percent_low=lo, percent_high=hi)
        want_color = P.depth_to_color(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, JN.percentile_minmax_norm(depth, lo, hi), rtol=0, atol=1e-6)
    np.testing.assert_allclose(color, want_color, rtol=0, atol=1e-6)
    np.testing.assert_allclose(color, JN.depth_to_color(got), rtol=0, atol=1e-6)
    # NaN and values outside [0, 1] take the ends of the table, as in numpy
    edge = np.array([[np.nan, -0.5, 0.0], [0.5, 1.0, 2.0]], np.float32)
    with numpy_path():
        want_edge = P.depth_to_color(edge)
    np.testing.assert_allclose(N.depth_to_color(edge), want_edge, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(40, 48), (256, 256), (1, 3)])
def test_png_writer_writes_the_jax_writers_bytes(tmp_path, shape):
    rng = np.random.default_rng(shape[0])
    rgb = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    assert N.png_write_rgb8(a, rgb) and JN.png_write_rgb8(b, rgb)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert np.array_equal(np.asarray(Image.open(a)), rgb)
    # save_png writes RGB through the native writer and gray through PIL
    P.save_png(rgb / 255.0, str(tmp_path / "saved.png"))
    with open(a, "rb") as fa, open(tmp_path / "saved.png", "rb") as fs:
        assert fa.read() == fs.read()
    P.save_png(rgb[..., 0] / 255.0, str(tmp_path / "gray.png"))
    assert np.array_equal(np.asarray(Image.open(tmp_path / "gray.png")), rgb[..., 0])


def test_no_native_selects_numpy(tmp_path, numpy_path):
    rgb = np.random.default_rng(0).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    with numpy_path():
        assert not N.available()
        assert N.status() == f"numpy ({N.NO_NATIVE_ENV} is set)"
        assert N.preprocess_rgb_u8(rgb, 8) is None
        assert N.percentile_minmax_norm(rgb.astype(np.float32), 0.0, 1.0) is None
        assert N.depth_to_color(np.zeros((2, 2), np.float32)) is None
        assert N.png_write_rgb8(str(tmp_path / "x.png"), rgb) is False
        P.save_png(rgb / 255.0, str(tmp_path / "pil.png"))  # PIL writes it
    assert N.available()
    assert np.array_equal(np.asarray(Image.open(tmp_path / "pil.png")), rgb)


def test_a_failed_build_is_reported_not_raised(monkeypatch):
    """Where the library cannot build, the callers take the numpy path and
    ``status()`` carries the compiler's error."""
    monkeypatch.setattr(N, "_state", {"tried": False, "lib": None, "path": None, "error": None})
    monkeypatch.setattr(N, "build", lambda: (_ for _ in ()).throw(
        RuntimeError("g++ failed to build host_ops.cc (exit 1):\nzlib.h: No such file")))
    assert not N.available()
    assert "zlib.h: No such file" in N.status() and "zlib.h" in N.build_error()
    assert N.preprocess_rgb_u8(np.zeros((4, 4, 3), np.uint8), 4) is None


def test_a_compiler_that_fails_gives_way_to_the_next(monkeypatch, tmp_path):
    """A $CXX that cannot build the library (one without OpenMP's spec file,
    say) gives way to the next compiler, g++ on PATH or the system's."""
    broken = tmp_path / "g++"
    broken.write_text("#!/bin/sh\necho 'fatal error: cannot read spec file libgomp.spec' >&2\n"
                      "exit 1\n")
    broken.chmod(0o755)
    monkeypatch.setenv("CXX", str(broken))
    monkeypatch.setattr(N, "_state", {"tried": False, "lib": None, "path": None, "error": None})
    assert N.compilers()[0] == str(broken) and len(N.compilers()) > 1
    assert N.available(), N.build_error()
    assert N._state["path"] != N.lib_path(str(broken))
    img = np.random.default_rng(1).integers(0, 256, (40, 48, 3), dtype=np.uint8)
    assert np.array_equal(N.preprocess_rgb_u8(img, 32), JN.preprocess_rgb_u8(img, 32))
