"""Checkpoints of the port's UNet in both packages' formats, and remat.

* ``params_from_state_dict`` against the JAX package's ``convert_state_dict``,
  exactly, and its round trip with ``state_dict_from_jax``;
* ``load_unet`` on a ``.msgpack`` that the JAX package wrote: the port's
  forward against JAX's at the UNet parity bar, rtol 1e-3 / atol 5e-4;
* an orbax directory that the JAX package wrote loads the weights of its
  ``.msgpack``; a missing or damaged orbax directory raises; a missing or
  unreadable file falls back to random init with the reference's message; a
  tree that does not fit the config raises;
* the restore CLI with ``--cpu`` and ``model_path: *.msgpack`` loads it;
* ``remat`` (``use_checkpoint``) gives the same outputs, x-gradients and
  weight gradients, bit for bit, with the K3 forward run again in the backward.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osmosis_tpu.models import UNetConfig as JaxUNetConfig
from osmosis_tpu.models import UNetModel as JaxUNet
from osmosis_tpu.models import convert as JC
from osmosis_tpu_torch.models import convert as C
from osmosis_tpu_torch.models.unet import UNetConfig, UNetModel, unet_config_from_yaml
from osmosis_tpu_torch.ops import group_norm as G

TINY_KW = dict(image_size=32, in_channels=4, model_channels=32, out_channels=8,
               num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2), num_heads=4,
               num_head_channels=16, use_scale_shift_norm=True, resblock_updown=True,
               use_new_attention_order=False)
VARIANTS = [dict(), dict(use_new_attention_order=True), dict(resblock_updown=False)]
VARIANT_IDS = ["legacy_attention", "new_attention_order", "conv_resample"]

@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny models run fastest on one thread when test workers share the
    cores; the previous setting is restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)



def _random_state_dict(cfg, seed):
    """A port state_dict with every leaf random (zero inits included)."""
    model = C.init_unet(cfg, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    return {k: v + 0.02 * torch.randn(v.shape, generator=gen) for k, v in
            model.state_dict().items()}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_params_from_state_dict_equals_jax_convert_state_dict(variant):
    kw = dict(TINY_KW, **variant)
    sd = _random_state_dict(UNetConfig(**kw), seed=len(variant))
    ours = C.params_from_state_dict(sd, UNetConfig(**kw))
    theirs = JC.convert_state_dict({k: v.numpy() for k, v in sd.items()}, JaxUNetConfig(**kw))
    a, b = _leaves(ours), _leaves(theirs)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == np.float32 and a[k].flags.c_contiguous, k
        assert np.array_equal(a[k], b[k]), k
    back = C.state_dict_from_jax(ours, UNetConfig(**kw))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_state_dict_from_jax_then_back_is_the_jax_tree():
    cfg = UNetConfig(**TINY_KW)
    tree = C.params_from_state_dict(_random_state_dict(cfg, 5), cfg)
    again = C.params_from_state_dict(C.state_dict_from_jax(tree, cfg), cfg)
    for k, v in _leaves(tree).items():
        assert np.array_equal(_leaves(again)[k], v), k


def _jax_params(cfg, seed=0):
    params = JaxUNet(cfg).init(jax.random.key(seed), jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)))
    rng = np.random.default_rng(seed + 100)

    def randomize(leaf):
        a = np.asarray(leaf)
        return (0.02 * rng.standard_normal(a.shape)).astype(np.float32) if not a.any() else a

    return jax.tree_util.tree_map(randomize, params)


def test_load_unet_reads_a_jax_msgpack_and_matches_the_jax_forward(tmp_path):
    jcfg = JaxUNetConfig(**TINY_KW)
    params = _jax_params(jcfg)
    path = str(tmp_path / "jax.msgpack")
    JC.save_params_msgpack(params, path)
    model = C.load_unet(path, UNetConfig(**TINY_KW), "cpu")
    assert not any(p.requires_grad for p in model.parameters())

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    ts = np.array([17.0, 433.0], np.float32)
    want = np.asarray(jax.jit(JaxUNet(jcfg).apply)(params, jnp.asarray(x), jnp.asarray(ts)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-4)

    trainable = C.unet_from_msgpack(path, UNetConfig(**TINY_KW))
    assert all(p.requires_grad for p in trainable.parameters())
    # and the JAX package reads the port's save of the same weights exactly
    ours = str(tmp_path / "port.msgpack")
    C.save_params_msgpack(C.params_from_state_dict(model.state_dict(), model.cfg), ours)
    with open(ours, "rb") as f, open(path, "rb") as g:
        assert f.read() == g.read()


def test_load_unet_reads_pt_as_before(tmp_path):
    cfg = UNetConfig(**TINY_KW)
    sd = _random_state_dict(cfg, 7)
    path = str(tmp_path / "ref.pt")
    torch.save(sd, path)
    model = C.load_unet(path, cfg, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_orbax_checkpoints_raise(tmp_path):
    """A real orbax directory loads; a missing or damaged one raises (no
    random-init fallback)."""
    cfg = UNetConfig(**TINY_KW)
    sd = _random_state_dict(cfg, 7)
    saved = str(tmp_path / "real.orbax")
    JC.save_params_orbax(C.params_from_state_dict(sd, cfg), saved)
    model = C.load_unet(saved, cfg, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "_CHECKPOINT_METADATA").write_text("{}")
    for path in (str(d), str(tmp_path / "missing.orbax")):
        with pytest.raises(FileNotFoundError):
            C.load_unet(path, cfg, "cpu")
    os.remove(os.path.join(saved, "manifest.ocdbt"))
    with pytest.raises(FileNotFoundError):
        C.load_unet(saved, cfg, "cpu")
    assert C.is_orbax_checkpoint(str(d)) and not C.is_orbax_checkpoint(str(tmp_path))


@pytest.mark.parametrize("name,content", [
    ("missing.msgpack", None), ("corrupt.msgpack", b"\x81\xa1k"), ("missing.pt", None),
    ("corrupt.pt", b"not a pickle")])
def test_unreadable_files_fall_back_to_random_init(tmp_path, capsys, name, content):
    cfg = UNetConfig(**TINY_KW)
    path = tmp_path / name
    if content is not None:
        path.write_bytes(content)
    model = C.load_unet(str(path), cfg, "cpu", seed=3)
    assert "Randomly initialize" in capsys.readouterr().out
    ref = C.init_unet(cfg, 3)
    for (k, v), w in zip(model.state_dict().items(), ref.state_dict().values()):
        assert torch.equal(v, w), k


def test_a_msgpack_of_another_model_raises(tmp_path):
    small = UNetConfig(**TINY_KW)
    path = str(tmp_path / "other.msgpack")
    C.save_params_msgpack(C.params_from_state_dict(C.init_unet(small).state_dict(), small), path)
    for other in (dict(channel_mult=(1, 2, 2)), dict(model_channels=64)):
        with pytest.raises(C.CheckpointMismatch):
            C.load_unet(path, UNetConfig(**dict(TINY_KW, **other)), "cpu")


def test_restore_cli_loads_a_msgpack_checkpoint(tmp_path, capsys):
    from test_torch_pipeline import TINY_UNET, _config

    from PIL import Image

    from osmosis_tpu_torch.sample import main

    images = tmp_path / "images"
    images.mkdir()
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (40, 48, 3), dtype=np.uint8)).save(
        images / "img_0.png")
    ucfg = unet_config_from_yaml(TINY_UNET)
    ckpt = str(tmp_path / "toy.msgpack")
    C.save_params_msgpack(C.params_from_state_dict(_random_state_dict(ucfg, 11), ucfg), ckpt)
    cfg = _config(tmp_path, str(images), unet_model=dict(TINY_UNET, model_path=ckpt),
                  sample_pattern=dict(pattern="pcgs", update_start=0.7, update_end=0,
                                      global_N=1, local_M=1, s_start=1, s_end=0, n_iter=2,
                                      start_guidance=1, stop_guidance=0),
                  diffusion=dict(sampler="ddpm", steps=1000, noise_schedule="linear",
                                 model_mean_type="epsilon", model_var_type="learned_range",
                                 dynamic_threshold=False, clip_denoised=True,
                                 min_max_denoised=False, rescale_timesteps=False,
                                 timestep_respacing=3))
    loaded = []
    orig = C.load_unet

    def spy(*a, **kw):
        loaded.append(orig(*a, **kw))
        return loaded[-1]

    import osmosis_tpu_torch.models.preset as R  # the preset's loader, which restore calls

    R.load_unet, saved = spy, R.load_unet
    try:
        out = main(["-c", cfg, "--cpu"])
    finally:
        R.load_unet = saved
    assert "Randomly initialize" not in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "single_images", "rgb", "img_0.png"))
    want = C.state_dict_from_jax(C.load_params_msgpack(ckpt), ucfg)
    for k, v in loaded[0].state_dict().items():
        assert torch.equal(v, want[k]), k


def test_use_checkpoint_turns_on_remat():
    from test_torch_pipeline import TINY_UNET

    assert not unet_config_from_yaml(TINY_UNET).remat
    assert unet_config_from_yaml(dict(TINY_UNET, use_checkpoint=True)).remat


def test_remat_gives_identical_outputs_and_gradients():
    cfg = UNetConfig(**TINY_KW)
    sd = _random_state_dict(cfg, 13)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 4)).astype(np.float32))
    ts = torch.tensor([17.0, 433.0])
    g = torch.from_numpy(rng.standard_normal((2, 32, 32, 8)).astype(np.float32))
    results = {}
    for remat in (False, True):
        model = UNetModel(UNetConfig(**dict(TINY_KW, remat=remat)))
        model.load_state_dict(sd)
        model = model.to(memory_format=torch.channels_last)
        xd = x.clone().requires_grad_(True)
        y = model(xd, ts)
        y.backward(g)
        results[remat] = (y.detach(), xd.grad, {n: p.grad for n, p in model.named_parameters()})
    y0, dx0, gw0 = results[False]
    y1, dx1, gw1 = results[True]
    assert torch.equal(y0, y1) and torch.equal(dx0, dx1)
    for n in gw0:
        assert torch.equal(gw0[n], gw1[n]), n


def test_remat_recomputes_the_norms_in_the_backward(monkeypatch):
    """The K3 forward is called once per site in the forward and once more per
    site inside a ResBlock or AttentionBlock during the backward; K4 once per
    site either way."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = G.group_norm_forward, G.group_norm_backward

    def count_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(G, "group_norm_forward", count_fwd)
    monkeypatch.setattr(G, "group_norm_backward", count_bwd)
    sd = _random_state_dict(UNetConfig(**TINY_KW), 17)
    counts = {}
    for remat in (False, True):
        model = UNetModel(UNetConfig(**dict(TINY_KW, remat=remat)))
        model.load_state_dict(sd)
        calls.update(fwd=0, bwd=0)
        model(torch.zeros(1, 32, 32, 4), torch.tensor([5.0])).sum().backward()
        counts[remat] = dict(calls)
    sites = counts[False]["fwd"]
    assert counts[False]["bwd"] == sites and counts[True]["bwd"] == sites
    assert counts[True]["fwd"] == 2 * sites - 1  # all but the output norm again
    with torch.no_grad():  # no recompute and no checkpoint without a graph
        calls.update(fwd=0)
        model(torch.zeros(1, 32, 32, 4), torch.tensor([5.0]))
    assert calls["fwd"] == sites
