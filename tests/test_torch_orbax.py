"""The port's orbax reader (``models/convert.load_params_orbax``,
``utils/ocdbt``, ``utils/zstd``) against orbax, tensorstore and zstandard.

* Both zstd decoders (the native one in ``utils/csrc/host_ops.cc`` and the
  plain Python one) against ``zstandard``: hypothesis-drawn buffers at levels
  1, 3 and 19 with and without checksum and content size, empty frames,
  RLE-only data, several frames in a row; a truncated or corrupt frame raises.
* OCDBT against tensorstore: databases with interior B-tree nodes, indirect
  values and many versions read key for key as tensorstore reads them.
* ``load_params_orbax`` on directories that the JAX package's
  ``save_params_orbax`` wrote: bit for bit JAX's ``load_params_orbax``, fp32
  and bf16 leaves, the tiny UNet's tree, arrays split over several chunks and
  data files; ``load_unet`` on an orbax directory gives the forward of the
  ``.msgpack`` of the same weights, bit for bit; a damaged node, a truncated
  or missing data file raises.
* The committed fixture ``tests/data/orbax_tiny_unet`` (written by
  :func:`write_fixture`, ``python -m tests.test_torch_orbax``) reads as JAX
  reads it, and its recorded forward is JAX's; chip_smoke runs it on the
  card.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from osmosis_tpu.models import UNetConfig as JaxUNetConfig
from osmosis_tpu.models import UNetModel as JaxUNet
from osmosis_tpu.models import convert as JC
from osmosis_tpu_torch.models import convert as C
from osmosis_tpu_torch.models.unet import UNetConfig
from osmosis_tpu_torch.utils import native, ocdbt
from osmosis_tpu_torch.utils import zstd as Z

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "orbax_tiny_unet")
FIXTURE_FORWARD = os.path.join(HERE, "data", "orbax_tiny_unet_forward.npz")
# a one-level UNet small enough that its bf16 tree stays under 512 KB
FIXTURE_KW = dict(image_size=16, in_channels=4, out_channels=8, model_channels=32,
                  num_res_blocks=1, attention_resolutions=(1,), channel_mult=(1,),
                  num_head_channels=16, use_scale_shift_norm=True, resblock_updown=True)
TINY_KW = dict(image_size=32, in_channels=4, out_channels=8, model_channels=32, num_res_blocks=1,
               attention_resolutions=(4,), channel_mult=(1, 2), num_head_channels=16,
               use_scale_shift_norm=True, resblock_updown=True)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny models run fastest on one thread when test workers share the
    cores; the previous setting is restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


DECODERS = {"python": Z.decompress_py, "native": native.zstd_decompress}


@pytest.fixture(params=sorted(DECODERS))
def decoder(request):
    if request.param == "native":
        native.build()  # a machine that cannot build it fails here, not silently
    return DECODERS[request.param]


_BUFFERS = st.one_of(
    st.binary(max_size=3000),
    st.builds(lambda b, n: b * n, st.binary(min_size=1, max_size=40), st.integers(1, 400)),
    st.builds(lambda seed, n, k: np.random.default_rng(seed).integers(
        0, k, n, dtype=np.uint8).tobytes(), st.integers(0, 2 ** 32 - 1),
        st.integers(0, 200_000), st.sampled_from([2, 16, 256])),
    st.builds(lambda seed, n: np.random.default_rng(seed).standard_normal(n).astype(
        np.float32).tobytes(), st.integers(0, 2 ** 32 - 1), st.integers(0, 40_000)),
)


@settings(max_examples=40, deadline=None)
@given(data=_BUFFERS, level=st.sampled_from([1, 3, 19]), checksum=st.booleans(),
       content_size=st.booleans())
def test_both_decoders_equal_zstandard(data, level, checksum, content_size):
    native.build()
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                     write_content_size=content_size).compress(data)
    assert Z.decompress_py(frame) == data
    assert native.zstd_decompress(frame) == data
    assert Z.decompress(frame) == data


def test_special_frames(decoder):
    empty = zstandard.ZstdCompressor().compress(b"")
    assert decoder(empty) == b""
    rle = b"\x07" * 300_000  # RLE blocks
    assert decoder(zstandard.ZstdCompressor(level=3).compress(rle)) == rle
    two = zstandard.ZstdCompressor().compress(b"one") + zstandard.ZstdCompressor().compress(b"two")
    assert decoder(two) == b"onetwo"
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    assert decoder(skippable + empty) == b""


def test_streamed_frames_without_content_size(decoder):
    data = np.random.default_rng(3).standard_normal(300_000).astype(np.float32).tobytes()
    cobj = zstandard.ZstdCompressor(level=1, write_checksum=True).compressobj()
    frame = b"".join(cobj.compress(data[i:i + 70_000]) for i in range(0, len(data), 70_000))
    frame += cobj.flush()
    assert Z.frame_content_size(frame) is None
    assert decoder(frame) == data


@pytest.mark.parametrize("damage", ["truncate", "checksum", "magic", "literals"])
def test_a_damaged_frame_raises(decoder, damage):
    data = np.random.default_rng(4).integers(0, 16, 50_000, dtype=np.uint8).tobytes()
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data))
    if damage == "truncate":
        frame = frame[:len(frame) // 2]
    elif damage == "checksum":
        frame[-1] ^= 0xFF
    elif damage == "magic":
        frame[0] ^= 0xFF
    else:
        frame[len(frame) // 2] ^= 0x5A
    with pytest.raises(Z.ZstdError):
        decoder(bytes(frame))


def test_xxh64_matches_zstandards_frame_checksums():
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 1000):
        data = bytes(range(256)) * 4
        frame = zstandard.ZstdCompressor(write_checksum=True).compress(data[:n])
        assert int.from_bytes(frame[-4:], "little") == Z.xxh64(data[:n]) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# OCDBT against tensorstore
# ---------------------------------------------------------------------------

def _tensorstore_db(path, config=None):
    spec = {"driver": "ocdbt", "base": f"file://{path}/"}
    if config:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def test_ocdbt_reads_interior_nodes_indirect_values_and_versions(tmp_path):
    path = str(tmp_path / "db")
    kv = _tensorstore_db(path, {"max_decoded_node_bytes": 600, "max_inline_value_bytes": 16})
    txn = ts.Transaction()
    for i in range(300):
        kv.with_transaction(txn).write(f"key/{i:05d}", (b"v%d" % i) * (1 + i % 9)).result()
    txn.commit_async().result()
    for i in range(40):  # more versions than the manifest holds inline
        kv.write(f"key/{i:05d}", b"w" * i).result()
    db = ocdbt.Database(path)
    keys = kv.list().result()
    assert len(keys) == 300 and sorted(db.keys()) == sorted(keys)
    for k in keys:
        assert db.read(k) == kv.read(k).result().value, k
    assert db.read("key/00007") == b"w" * 7 and db.read("absent") is None


# ---------------------------------------------------------------------------
# load_params_orbax against the JAX package
# ---------------------------------------------------------------------------

def _jax_tree(cfg_kw, seed=0):
    model = JaxUNet(JaxUNetConfig(**cfg_kw))
    hw = cfg_kw["image_size"]
    params = jax.jit(model.init)(jax.random.key(seed), jnp.zeros((1, hw, hw, 4)), jnp.zeros((1,)))
    rng = np.random.default_rng(seed + 7)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) if np.asarray(a).any()
        else (0.02 * rng.standard_normal(np.shape(a))).astype(np.float32), params)
    return model, params


def _same(port, ref):
    """Two trees of the same keys and the same bits (bf16 as its bits)."""
    assert isinstance(port, dict) == isinstance(ref, dict)
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
        for k in ref:
            _same(port[k], ref[k])
        return
    ref = np.asarray(ref)
    if ref.dtype == jnp.bfloat16:
        assert isinstance(port, torch.Tensor) and port.dtype == torch.bfloat16
        np.testing.assert_array_equal(port.view(torch.int16).numpy(), ref.view(np.int16))
    else:
        assert port.dtype == ref.dtype and port.shape == ref.shape
        np.testing.assert_array_equal(port, ref)


def test_fp32_and_bf16_leaves_read_as_jax_reads_them(tmp_path):
    rng = np.random.default_rng(0)
    params = {"params": {
        "a": {"kernel": rng.standard_normal((3, 3, 5, 8)).astype(np.float32),
              "bias": rng.standard_normal(8).astype(np.float32)},
        "b": jnp.asarray(rng.standard_normal((7, 12)), jnp.bfloat16),
        "c": np.float32(2.5) * np.ones((), np.float32),
        "half": rng.standard_normal(33).astype(np.float16)}}
    path = str(tmp_path / "ck.orbax")
    JC.save_params_orbax(params, path)
    _same(C.load_params_orbax(path), JC.load_params_orbax(path))


def test_arrays_over_several_chunks_and_data_files(tmp_path):
    rng = np.random.default_rng(1)
    params = {"params": {"w": rng.standard_normal((64, 33, 7)).astype(np.float32),
                         "h": jnp.asarray(rng.standard_normal(3000), jnp.bfloat16)}}
    path = str(tmp_path / "split.orbax")
    ocp.PyTreeCheckpointer().save(path, args=ocp.args.PyTreeSave(
        params, ocdbt_target_data_file_size=8192))
    db = ocdbt.Database(path)
    assert len([k for k in db.keys() if k.startswith(b"params.w/")]) > 4  # several chunks
    files = {v[0] for v in db.entries.values() if isinstance(v, tuple)}
    assert len(files) > 2  # several data files
    _same(C.load_params_orbax(path), JC.load_params_orbax(path))


class _ZarrOnly:
    """A database holding one zarr v2 array's ``.zarray`` and no chunk."""

    def __init__(self, meta):
        self.meta = json.dumps(meta).encode()

    def read(self, key):
        return self.meta if key.endswith("/.zarray") else None


def test_absent_chunks_hold_the_fill_value(tmp_path):
    rng = np.random.default_rng(4)
    sparse = np.zeros((64, 33, 7), np.float32)
    sparse[:8] = rng.standard_normal((8, 33, 7))
    params = {"params": {"z": np.zeros((40, 50), np.float32), "s": sparse,
                         "zb": jnp.zeros((3000,), jnp.bfloat16)}}
    path = str(tmp_path / "zeros.orbax")
    ocp.PyTreeCheckpointer().save(path, args=ocp.args.PyTreeSave(
        params, ocdbt_target_data_file_size=8192))
    _same(C.load_params_orbax(path), JC.load_params_orbax(path))
    for dtype, fill, want in (("<f4", "NaN", np.float32("nan")), ("<f2", -2.5, np.float16(-2.5)),
                              ("bfloat16", 3.14159, 3.140625), ("bfloat16", "-Infinity", -np.inf)):
        meta = dict(zarr_format=2, shape=[5, 3], chunks=[2, 2], dtype=dtype, fill_value=fill,
                    order="C", filters=None, compressor={"id": "zstd", "level": 1})
        arr, bf16 = ocdbt.read_array(_ZarrOnly(meta), "a")
        got = torch.from_numpy(arr).view(torch.bfloat16).float().numpy() if bf16 else arr
        assert bf16 == (dtype == "bfloat16") and got.shape == (5, 3)
        np.testing.assert_array_equal(got, np.full((5, 3), want, got.dtype))


def test_tiny_unet_tree_and_load_unet_against_msgpack(tmp_path):
    _, params = _jax_tree(TINY_KW)
    path = str(tmp_path / "tiny.orbax")
    JC.save_params_orbax(params, path)
    tree = C.load_params_orbax(path)
    _same(tree, JC.load_params_orbax(path))
    mp = str(tmp_path / "tiny.msgpack")
    JC.save_params_msgpack(params, mp)
    cfg = UNetConfig(**TINY_KW)
    a, b = C.load_unet(path, cfg, "cpu"), C.load_unet(mp, cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 32, 32, 4)).astype(
        np.float32))
    t = torch.tensor([500.0])
    assert torch.equal(a(x, t), b(x, t))


def test_load_unet_names_the_zstd_decoder(tmp_path, capsys):
    _, params = _jax_tree(TINY_KW)
    path = str(tmp_path / "tiny.orbax")
    JC.save_params_orbax(params, path)
    C.load_unet(path, UNetConfig(**TINY_KW), "cpu")
    assert f"zstd decoder: {Z.decoder()}" in capsys.readouterr().out


def _saved(tmp_path):
    rng = np.random.default_rng(5)
    params = {"params": {"w": rng.standard_normal((40, 50)).astype(np.float32)}}
    path = str(tmp_path / "ck.orbax")
    JC.save_params_orbax(params, path)
    return path


def _node_file(path):
    """The root database's B-tree node file (under d/)."""
    (name,) = os.listdir(os.path.join(path, "d"))
    return os.path.join(path, "d", name)


@pytest.mark.parametrize("damage", ["node_byte", "node_truncated", "data_file_missing",
                                    "data_file_truncated", "manifest_byte"])
def test_a_damaged_checkpoint_raises(tmp_path, damage):
    path = _saved(tmp_path)
    C.load_params_orbax(path)  # intact, it reads
    data_dir = os.path.join(path, "ocdbt.process_0", "d")
    values = max((os.path.join(data_dir, f) for f in os.listdir(data_dir)), key=os.path.getsize)
    if damage.startswith("node"):
        node = _node_file(path)
        blob = bytearray(open(node, "rb").read())
        blob = blob[:-7] if damage == "node_truncated" else blob
        if damage == "node_byte":
            blob[len(blob) // 2] ^= 1
        open(node, "wb").write(bytes(blob))
    elif damage == "data_file_missing":
        os.remove(values)
    elif damage == "data_file_truncated":
        blob = open(values, "rb").read()
        open(values, "wb").write(blob[:len(blob) // 2])
    else:
        manifest = os.path.join(path, "manifest.ocdbt")
        blob = bytearray(open(manifest, "rb").read())
        blob[20] ^= 1
        open(manifest, "wb").write(bytes(blob))
    with pytest.raises(ocdbt.OcdbtError):
        C.load_params_orbax(path)
    with pytest.raises(ocdbt.OcdbtError):
        C.load_unet(path, UNetConfig(**TINY_KW), "cpu")


# ---------------------------------------------------------------------------
# the committed fixture
# ---------------------------------------------------------------------------

def _fixture_forward(params):
    """JAX's fp32 forward of ``params`` (bf16 leaves upcast) on the fixture's
    seeded input."""
    model = JaxUNet(JaxUNetConfig(**FIXTURE_KW))
    p32 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), params)
    x = np.random.default_rng(11).standard_normal((1, 16, 16, 4)).astype(np.float32)
    t = np.array([321.0], np.float32)
    return x, t, np.asarray(model.apply(p32, jnp.asarray(x), jnp.asarray(t)))


def write_fixture(path=FIXTURE, forward=FIXTURE_FORWARD):
    """The fixture: the one-level UNet's tree (zero-initialized leaves drawn
    at 0.02, every leaf but the GroupNorm affines in bf16, as
    ``cast_params_half`` stores a torso) saved by the JAX package's
    ``save_params_orbax``, and JAX's forward of it on a seeded input."""
    _, params = _jax_tree(FIXTURE_KW, seed=3)
    params = JC.cast_params_half(params)
    if os.path.exists(path):
        shutil.rmtree(path)
    JC.save_params_orbax(params, path)
    x, t, out = _fixture_forward(params)
    np.savez(forward, x=x, t=t, out=out, config=json.dumps(FIXTURE_KW))


def test_the_committed_fixture_reads_as_jax_reads_it():
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(FIXTURE) for f in fs)
    assert size <= 512 * 1024, size
    ref = JC.load_params_orbax(FIXTURE)
    _same(C.load_params_orbax(FIXTURE), ref)
    rec = np.load(FIXTURE_FORWARD)
    assert json.loads(str(rec["config"])) == json.loads(json.dumps(FIXTURE_KW))
    x, t, out = _fixture_forward(ref)
    np.testing.assert_array_equal(rec["x"], x)
    np.testing.assert_allclose(rec["out"], out, rtol=1e-5, atol=1e-6)
    # and the port's CPU forward of what it reads is within the UNet parity bar
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in json.loads(str(rec["config"])).items()}
    model = C.load_unet(FIXTURE, UNetConfig(**kw), "cpu")
    got = model(torch.from_numpy(rec["x"]), torch.from_numpy(rec["t"])).detach().numpy()
    np.testing.assert_allclose(got, rec["out"], rtol=1e-3, atol=5e-4)


def write_full_width(path):
    """The preset's 552.8M-parameter tree in fp32 (each leaf seeded by a CRC
    of its path: N(0, 1/fan_in), GroupNorm scales 1, biases 0), saved by the
    JAX package's ``save_params_orbax``: the input of
    ``python -m osmosis_tpu_torch.tools.orbax_read_bench``."""
    import zlib

    from tests.test_torch_mesh import FULL_KW

    kw = dict(FULL_KW, image_size=256)
    shapes = jax.eval_shape(JaxUNet(JaxUNetConfig(**kw)).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 4)), jnp.zeros((1,)))

    def fill(p, sds):
        name = "/".join(str(k.key) for k in p)
        if name.endswith("bias"):
            return np.zeros(sds.shape, np.float32)
        if "norm" in name:
            return np.ones(sds.shape, np.float32)
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        fan_in = int(np.prod(sds.shape[:-1])) or 1
        return (rng.standard_normal(sds.shape) / np.sqrt(fan_in)).astype(np.float32)

    JC.save_params_orbax(jax.tree_util.tree_map_with_path(fill, shapes), path)


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--full-width"]:
        write_full_width(sys.argv[2])
    else:
        write_fixture()
