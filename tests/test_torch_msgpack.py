"""The port's msgpack codec (``osmosis_tpu_torch/utils/msgpack.py``) against
flax's ``msgpack_serialize`` / ``msgpack_restore``, which the JAX package's
checkpoints go through (``osmosis_tpu/models/convert.py:148-159``).

The writer must give flax's bytes exactly, and each side must read the
other's files exactly: fp32, fp16, int and bf16 leaves, numpy scalars,
Python scalars, and flax's chunked form (MAX_CHUNK_SIZE set small here).
"""

import flax.serialization as FS
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osmosis_tpu_torch.utils import msgpack as M


def _tree(rng):
    return {
        "params": {
            "conv": {"kernel": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
                     "bias": np.zeros(8, np.float32)},
            "norm": {"scale": rng.standard_normal(40).astype(np.float16),
                     "bias": rng.standard_normal(40).astype(np.float64)},
            "Dense_10": {"kernel": rng.standard_normal((20, 300)).astype(np.float32)},
            "Dense_2": {"kernel": np.arange(70000, dtype=np.int32).reshape(700, 100)},
        },
        "counts": {"u8": np.arange(17, dtype=np.uint8), "i64": np.arange(-5, 5, dtype=np.int64),
                   "u32": np.array([0, 2 ** 32 - 1], np.uint32), "flag": np.array([True, False])},
        "scalars": {"np_f32": np.float32(2.5), "np_i8": np.int8(-3), "zero_d": np.array(1.25)},
        "python": {"int": 3, "neg": -200, "big": 70000, "huge": 2 ** 40, "float": 1.5,
                   "str": "osmosis", "none": None, "yes": True, "no": False, "bytes": b"\x00\x01",
                   "list": [1, 2.0, "x", None], "long_str": "s" * 300},
        "empty": np.zeros((0, 3), np.float32),
        "strided": np.arange(24, dtype=np.float32).reshape(4, 6)[:, ::2],
    }


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (list(a), list(b))
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        bt = torch.from_numpy(np.asarray(b, dtype=np.float32)) if not isinstance(
            b, torch.Tensor) else b.float()
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == tuple(bt.shape)
        assert torch.equal(a.float(), bt)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def test_writer_gives_flax_bytes_and_reads_them_back():
    tree = _tree(np.random.default_rng(0))
    ours = M.packb(tree)
    assert ours == FS.msgpack_serialize(tree)
    _assert_trees_equal(M.unpackb(ours), FS.msgpack_restore(ours))


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16", "int32", "uint8"])
def test_each_package_reads_the_others_leaves_exactly(dtype):
    rng = np.random.default_rng(1)
    base = rng.standard_normal((5, 7)) * 100
    if dtype == "bfloat16":
        jax_leaf = np.asarray(jnp.asarray(base, dtype=jnp.bfloat16))
        bits = torch.from_numpy(jax_leaf.view(np.int16).copy())
        our_leaf = bits.view(torch.bfloat16)
    else:
        jax_leaf = our_leaf = base.astype(dtype)
    flax_bytes = FS.msgpack_serialize({"w": jax_leaf, "s": jax_leaf[0, 0]})
    assert M.packb({"w": our_leaf, "s": jax_leaf[0, 0]}) == flax_bytes
    back = M.unpackb(flax_bytes)
    restored = FS.msgpack_restore(M.packb({"w": our_leaf}))["w"]
    if dtype == "bfloat16":
        assert back["w"].dtype == torch.bfloat16
        assert torch.equal(back["w"].view(torch.int16), bits)
        assert restored.dtype == jnp.bfloat16
        assert np.array_equal(restored.view(np.int16), jax_leaf.view(np.int16))
    else:
        assert back["w"].dtype == np.dtype(dtype) and np.array_equal(back["w"], jax_leaf)
        assert restored.dtype == np.dtype(dtype) and np.array_equal(restored, jax_leaf)


@pytest.mark.parametrize("leaf_dtype", ["float32", "bfloat16"])
def test_chunked_arrays_round_trip_both_ways(monkeypatch, leaf_dtype):
    monkeypatch.setattr(FS, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(M, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((11, 7)).astype(np.float32)
    if leaf_dtype == "bfloat16":
        jax_x = np.asarray(jnp.asarray(x, dtype=jnp.bfloat16))
        our_x = torch.from_numpy(jax_x.view(np.int16).copy()).view(torch.bfloat16)
    else:
        jax_x = our_x = x
    small = rng.standard_normal(3).astype(np.float32)
    flax_bytes = FS.msgpack_serialize({"b": {"x": jax_x}, "a": small})
    ours = M.packb({"b": {"x": our_x}, "a": small})
    assert ours == flax_bytes
    assert b"__msgpack_chunked_array__" in ours
    back = M.unpackb(flax_bytes)
    if leaf_dtype == "bfloat16":
        assert torch.equal(back["b"]["x"], our_x)
    else:
        assert np.array_equal(back["b"]["x"], x)
    restored = FS.msgpack_restore(ours)
    assert np.array_equal(np.asarray(restored["b"]["x"], np.float32),
                          np.asarray(jax_x, np.float32))
    assert np.array_equal(back["a"], small)


def test_dump_streams_the_same_bytes_to_a_file(tmp_path):
    tree = _tree(np.random.default_rng(3))
    path = tmp_path / "t.msgpack"
    with open(path, "wb") as f:
        M.dump(tree, f.write)
    assert path.read_bytes() == FS.msgpack_serialize(tree)


def test_cuda_or_cpu_tensors_write_as_their_numpy_arrays():
    x = np.random.default_rng(4).standard_normal((3, 5)).astype(np.float32)
    assert M.packb({"x": torch.from_numpy(x)}) == FS.msgpack_serialize({"x": x})


def test_bad_input_raises():
    good = M.packb({"x": np.ones(4, np.float32)})
    with pytest.raises(ValueError):
        M.unpackb(good[:-3])
    with pytest.raises(ValueError):
        M.unpackb(good + b"\xc0")
    with pytest.raises(ValueError):
        M.unpackb(b"\xc1")
    with pytest.raises(TypeError):
        M.packb({"t": (1, 2)})  # flax refuses tuples too (strict types)
    with pytest.raises(ValueError):
        M.packb({"o": np.array([object()])})
