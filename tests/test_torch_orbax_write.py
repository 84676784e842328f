"""The port's orbax writer (``models/convert.save_params_orbax``,
``utils/ocdbt.Writer`` and ``write_array``, the raw-block zstd encoder of
``utils/zstd``, CRC-32C) against orbax, tensorstore and zstandard.

* Trees written by the port read bit for bit as they were by JAX's
  ``load_params_orbax`` (orbax and tensorstore) and by the port's: fp32,
  fp16, int32 and scalar leaves, bf16 leaves given as tensors and as JAX
  arrays, arrays over several zarr chunks with padded edge chunks, and a tree
  large enough for several B+tree leaves under an interior node, with values
  inline and in the data file.
* The tiny UNet's tree through ``load_unet``: its forward equals the one of
  the ``.msgpack`` of the same weights, bit for bit.
* Raw-block zstd frames (``utils/zstd.compress``) read by ``zstandard`` and
  by both of the port's decoders.
* The native CRC-32C equals the Python twin, and both equal the checksum of
  every manifest and node of ``tests/data/orbax_tiny_unet``.
* A damaged write (a node's byte, the manifest's byte, a truncated data
  file, a missing manifest) raises; a failed save leaves the directory it
  would replace as it was; a save over a checkpoint, or over a file, leaves
  only the new checkpoint, and one whose last rename fails the old one.
"""

import json
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard

from osmosis_tpu.models import convert as JC
from osmosis_tpu_torch.models import convert as C
from osmosis_tpu_torch.models.unet import UNetConfig
from osmosis_tpu_torch.utils import native, ocdbt
from osmosis_tpu_torch.utils import zstd as Z
from tests.test_torch_orbax import FIXTURE, TINY_KW, _jax_tree, _same


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bits(leaf) -> np.ndarray:
    """A leaf's bytes (bf16 tensors and arrays as their bits)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.view(torch.int16) if leaf.dtype == torch.bfloat16 else leaf
        leaf = leaf.contiguous().numpy()
    return np.ascontiguousarray(np.asarray(leaf)).reshape(-1).view(np.uint8)


def _as_written(tree, got):
    """Every leaf of ``got`` holds the bytes, shape and dtype width of the
    leaf of ``tree`` written."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _as_written(v, got[k])
        else:
            assert tuple(np.shape(got[k])) == tuple(np.shape(v)), k
            np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)


def _written_and_read(tree, path):
    """Write ``tree`` with the port, read it with JAX and with the port;
    both give its bits, and agree leaf for leaf."""
    C.save_params_orbax(tree, path)
    jax_tree, port_tree = JC.load_params_orbax(path), C.load_params_orbax(path)
    _same(port_tree, jax_tree)
    _as_written(tree, port_tree)
    return port_tree


def test_every_leaf_kind_reads_bit_for_bit_in_jax(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"params": {
        "a": {"kernel": rng.standard_normal((3, 3, 5, 8)).astype(np.float32),
              "bias": rng.standard_normal(8).astype(np.float32)},
        "b": torch.from_numpy(rng.standard_normal((7, 12)).astype(np.float32)).bfloat16(),
        "c": np.float32(2.5) * np.ones((), np.float32),
        "half": rng.standard_normal(33).astype(np.float16),
        "jax_bf16": np.asarray(jnp.asarray(rng.standard_normal((5, 6)), jnp.bfloat16)),
        "steps": np.arange(10, dtype=np.int32)}}
    path = str(tmp_path / "ck.orbax")
    got = _written_and_read(tree, path)
    assert got["params"]["b"].dtype == got["params"]["jax_bf16"].dtype == torch.bfloat16
    tree["params"]["a"]["bias"] = -tree["params"]["a"]["bias"]  # force=True: written over
    _written_and_read(tree, path)


def test_arrays_over_several_chunks(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    tree = {"params": {"w": rng.standard_normal((64, 33, 7)).astype(np.float32),
                       "h": torch.from_numpy(rng.standard_normal(3000).astype(
                           np.float32)).bfloat16(),
                       "k": rng.standard_normal((3, 3, 40, 48)).astype(np.float32)}}
    path = str(tmp_path / "split.orbax")
    monkeypatch.setattr(ocdbt, "CHUNK_BYTES", 3000)
    _written_and_read(tree, path)
    db = ocdbt.Database(path)
    # the last chunk along w's axis 0 and along k's axis 2 is padded
    for name, chunks in (("w", [3, 33, 7]), ("h", [1500]), ("k", [1, 1, 15, 48])):
        meta = json.loads(db.read(f"params.{name}/.zarray"))
        assert meta["chunks"] == chunks
        n = len([k for k in db.keys() if k.startswith(f"params.{name}/".encode())]) - 1
        assert n == np.prod([-(-s // c) for s, c in zip(meta["shape"], chunks)]) > 1


def _manifest_root(path):
    """(height, statistics) of the newest version's root."""
    with open(os.path.join(path, "manifest.ocdbt"), "rb") as f:
        cur = ocdbt._Cursor(ocdbt._unframe(f.read(), ocdbt.MANIFEST_MAGIC, "manifest"))
    cur.take(16)
    cur.varints(3)
    cur.byte()
    assert cur.varint() == 1  # zstd, as orbax configures it
    cur.take(4)
    ocdbt._data_file_table(cur)
    assert cur.varint() == 1  # one version
    gen, height = cur.varint(), cur.byte()
    assert gen == 1
    cur.varints(3)
    return height, cur.varints(3)


def test_a_large_tree_has_interior_nodes_and_indirect_values(tmp_path):
    rng = np.random.default_rng(2)
    tree = {"params": {f"layer_{i:04d}": {
        "kernel": rng.standard_normal((3, 100) if i % 3 else (2, 4)).astype(np.float32),
        "bias": rng.standard_normal(4).astype(np.float32)} for i in range(400)}}
    path = str(tmp_path / "large.orbax")
    _written_and_read(tree, path)
    height, (n_keys, tree_bytes, indirect) = _manifest_root(path)
    db = ocdbt.Database(path)
    assert height >= 1 and n_keys == len(db.keys()) == 4 * 400
    # the kernels of 1200 bytes lie in the data file, the rest inline
    assert indirect == sum(v[2] for v in db.entries.values() if isinstance(v, tuple)) > 0
    (data_file,) = os.listdir(os.path.join(path, "d"))  # its values, then every node
    assert tree_bytes == os.path.getsize(os.path.join(path, "d", data_file)) - indirect


def test_tiny_unet_tree_through_load_unet(tmp_path):
    _, params = _jax_tree(TINY_KW)
    path = str(tmp_path / "tiny.orbax")
    _written_and_read(params, path)
    mp = str(tmp_path / "tiny.msgpack")
    JC.save_params_msgpack(params, mp)
    cfg = UNetConfig(**TINY_KW)
    a, b = C.load_unet(path, cfg, "cpu"), C.load_unet(mp, cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 32, 32, 4)).astype(
        np.float32))
    t = torch.tensor([500.0])
    assert torch.equal(a(x, t), b(x, t))


@pytest.mark.parametrize("n", [0, 1, 1000, Z.RAW_BLOCK - 1, Z.RAW_BLOCK, Z.RAW_BLOCK + 1,
                               3 * Z.RAW_BLOCK + 77])
def test_raw_block_frames_read_everywhere(n):
    native.build()
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    frame = Z.compress(data)
    assert Z.compress(np.frombuffer(data, np.uint8)) == frame  # an array's buffer
    assert len(frame) == 10 + 3 * max(1, -(-n // Z.RAW_BLOCK)) + n
    assert zstandard.get_frame_parameters(frame).content_size == n
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert Z.decompress_py(frame) == native.zstd_decompress(frame) == data


def _fixture_frames():
    """Every manifest and B-tree node of the committed fixture, as read."""
    blobs = []
    real = ocdbt._unframe

    def record(blob, magic, what):
        blobs.append(bytes(blob))
        return real(blob, magic, what)

    ocdbt._unframe = record
    try:
        ocdbt.Database(FIXTURE)
        ocdbt.Database(os.path.join(FIXTURE, "ocdbt.process_0"))
    finally:
        ocdbt._unframe = real
    return blobs


def test_native_crc32c_equals_the_twin_and_the_fixtures_checksums():
    native.build()
    assert native.crc32c(b"123456789") == ocdbt.crc32c_py(b"123456789") == 0xE3069283
    rng = np.random.default_rng(3)
    for n in list(range(0, 40)) + [1000, 4097, 100_003]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for start in (0, 1, 3):  # unaligned views too
            view = memoryview(data)[start:]
            assert native.crc32c(view) == ocdbt.crc32c_py(bytes(view)) == ocdbt.crc32c(view)
    blobs = _fixture_frames()
    assert len(blobs) >= 4
    for blob in blobs:
        stored = struct.unpack_from("<I", blob, len(blob) - 4)[0]
        assert native.crc32c(blob[:-4]) == ocdbt.crc32c_py(blob[:-4]) == stored


@pytest.mark.parametrize("damage", ["node_byte", "manifest_byte", "data_file_truncated",
                                    "manifest_missing"])
def test_a_damaged_write_raises(tmp_path, damage):
    rng = np.random.default_rng(5)
    tree = {"params": {"w": rng.standard_normal((40, 50)).astype(np.float32),
                       "b": rng.standard_normal(7).astype(np.float32)}}
    path = str(tmp_path / "ck.orbax")
    _written_and_read(tree, path)  # intact, it reads, every checksum holding
    (name,) = os.listdir(os.path.join(path, "d"))
    data_file, manifest = os.path.join(path, "d", name), os.path.join(path, "manifest.ocdbt")
    if damage == "manifest_missing":
        os.remove(manifest)
    else:
        target = manifest if damage == "manifest_byte" else data_file
        blob = bytearray(open(target, "rb").read())
        if damage == "data_file_truncated":
            blob = blob[:len(blob) // 2]
        else:  # the node is the data file's tail, after the 8000-byte value
            blob[len(blob) - 20] ^= 1
        open(target, "wb").write(bytes(blob))
    with pytest.raises((ocdbt.OcdbtError, FileNotFoundError)):
        C.load_params_orbax(path)
    with pytest.raises((ocdbt.OcdbtError, FileNotFoundError)):
        C.load_unet(path, UNetConfig(**TINY_KW), "cpu")


def test_a_failed_save_leaves_the_old_checkpoint(tmp_path):
    path = str(tmp_path / "ck.orbax")
    good = {"params": {"w": np.arange(6, dtype=np.float32)}}
    C.save_params_orbax(good, path)
    with pytest.raises(ValueError):
        C.save_params_orbax({"params": {"w": np.array([object()])}}, path)
    _as_written(good, C.load_params_orbax(path))
    assert os.listdir(tmp_path) == ["ck.orbax"]  # nothing of the failed save is left


@pytest.mark.parametrize("old", ["checkpoint", "file"])
def test_a_save_replaces_what_was_there(tmp_path, monkeypatch, old):
    path = str(tmp_path / "ck.orbax")
    first = {"params": {"w": np.arange(6, dtype=np.float32)}}
    if old == "checkpoint":
        C.save_params_orbax(first, path)
    else:
        with open(path, "w") as f:
            f.write("not a checkpoint")
    second = {"params": {"w": np.arange(4, dtype=np.float32) * 2, "b": np.ones(3, np.float32)}}
    _written_and_read(second, path)
    assert os.listdir(tmp_path) == ["ck.orbax"]
    # the new directory's rename onto the path fails: the old one is back
    real = os.replace
    monkeypatch.setattr(C.os, "replace", lambda a, b: (_ for _ in ()).throw(OSError("disk"))
                        if ".orbax-tmp-" in a else real(a, b))
    with pytest.raises(OSError, match="disk"):
        C.save_params_orbax(first, path)
    _as_written(second, C.load_params_orbax(path))
    assert os.listdir(tmp_path) == ["ck.orbax"]
