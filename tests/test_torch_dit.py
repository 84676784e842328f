"""The port's DiT (``models/dit``) and the preset's model dispatch
(``models/preset``) on the CPU, at a tiny size (image 32, patch 4, hidden
64, depth 2, 4 heads, 64 frequencies):

* the forward and the x-only pullback against the benchmark's plain fp32
  reference (``portbench/reference/dit.py``, loaded by its path), on seeded
  weights filled into both models by name;
* a state dict in DiT's names, without ``y_embedder.*``, loads strictly;
* the spans and the counter: one ``dit.forward`` and ``depth``
  ``dit.attention`` spans a call, ``dit.calls`` counting calls;
* ``run_restoration``, ``pipelines/prior`` and ``tools/serve`` build the DiT
  from a ``dit_model`` preset and run it;
* every ``unet_model`` preset of ``configs/`` builds the UNet it built
  before; a DiT under tensor parallelism (tp > 1) is refused.
"""

import argparse
import importlib.util
import os
import sys
from os.path import join as pjoin

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from osmosis_tpu_torch import config as C
from osmosis_tpu_torch.models import preset as MP
from osmosis_tpu_torch.models.convert import CheckpointMismatch
from osmosis_tpu_torch.models.dit import DiTConfig, DiTModel, load_dit
from osmosis_tpu_torch.utils import profiling as PR

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TINY = dict(image_size=32, patch_size=4, hidden_size=64, depth=2, num_heads=4,
            frequency_embedding_size=64)
TINY_DIT = dict(TINY, mlp_ratio=4.0, in_channels=4, learn_sigma=True, use_fp16=False,
                model_path="")


def _reference_module():
    path = pjoin(REPO, "portbench", "reference", "dit.py")
    spec = importlib.util.spec_from_file_location("portbench_reference_dit", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # for its dataclass
    spec.loader.exec_module(mod)
    return mod


REF = _reference_module()


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _seeded_pair(seed=0):
    """The port's fp32 DiT and the reference, filled with the same seeded
    weights by name."""
    port = DiTModel(DiTConfig(**TINY))
    ref = REF.DiT(REF.Sizes(**TINY), remat=False)
    gen = torch.Generator().manual_seed(seed)
    state = {n: torch.randn(p.shape, generator=gen) * 0.1
             for n, p in sorted(ref.named_parameters())}
    for m in (port, ref):
        m.load_state_dict(dict(state, pos_embed=m.pos_embed), strict=True)
        m.requires_grad_(False)
    return port, ref


def _close(a, b, rtol):
    return float((a - b).abs().max()) <= rtol * float(b.abs().max())


def test_position_table_is_dits():
    port, ref = _seeded_pair()
    assert port.pos_embed.shape == ref.pos_embed.shape == (1, 64, 64)
    assert torch.allclose(port.pos_embed, ref.pos_embed, rtol=0, atol=1e-7)


def test_forward_and_pullback_match_the_reference():
    port, ref = _seeded_pair(1)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 32, 32, 4, generator=gen)
    t = torch.tensor([700.0, 13.0])
    u = torch.randn(2, 32, 32, 8, generator=gen)
    got = []
    for m in (port, ref):
        xg = x.clone().requires_grad_(True)
        out = m(xg, t)
        got.append((out.detach(), torch.autograd.grad(out, xg, u)[0]))
    (po, pg), (ro, rg) = got
    assert po.shape == (2, 32, 32, 8) and ro.abs().max() > 0.1 and rg.abs().max() > 0
    assert _close(po, ro, 1e-5) and _close(pg, rg, 1e-5)
    # the reference's checkpointed blocks give the same pullback
    ref.remat = True
    xg = x.clone().requires_grad_(True)
    assert _close(torch.autograd.grad(ref(xg, t), xg, u)[0], rg, 1e-6)


def test_bf16_torso_keeps_fp32_norms_and_output():
    port, _ = _seeded_pair(3)
    half = load_dit("", DiTConfig(**TINY), "cpu", dtype=torch.bfloat16)
    half.load_state_dict(port.state_dict())
    assert {p.dtype for p in half.parameters()} == {torch.bfloat16}
    x, t = torch.randn(1, 32, 32, 4), torch.tensor([400.0])
    out = half(x, t)
    assert out.dtype == torch.float32 and _close(out, port(x, t), 0.05)


def test_dit_state_dict_loads_strictly(tmp_path):
    port, _ = _seeded_pair(4)
    state = port.state_dict()
    names = set(state)
    for want in ("x_embedder.proj.weight", "t_embedder.mlp.0.weight", "t_embedder.mlp.2.bias",
                 "blocks.1.attn.qkv.weight", "blocks.1.attn.proj.bias", "blocks.0.mlp.fc1.weight",
                 "blocks.0.mlp.fc2.bias", "blocks.1.adaLN_modulation.1.weight",
                 "final_layer.adaLN_modulation.1.bias", "final_layer.linear.weight", "pos_embed"):
        assert want in names, want
    assert not any(n.startswith("y_embedder") for n in names)
    path = str(tmp_path / "dit.pt")
    torch.save(state, path)
    loaded = load_dit(path, DiTConfig(**TINY), "cpu")
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in state.items())
    assert not any(p.requires_grad for p in loaded.parameters())
    torch.save(dict(state, **{"y_embedder.embedding_table.weight": torch.zeros(1001, 64)}), path)
    with pytest.raises(CheckpointMismatch, match="y_embedder"):
        load_dit(path, DiTConfig(**TINY), "cpu")


def test_spans_and_counter():
    port, _ = _seeded_pair(5)
    x, t = torch.randn(1, 32, 32, 4), torch.tensor([50.0])
    PR.take_spans()
    before = PR.counters()["dit.calls"]
    port(x, t)
    assert PR.take_spans() == []  # tracing off: no spans
    with PR.tracing():
        port(x, t)
        port(x, t)
    spans = PR.take_spans()
    assert PR.counters()["dit.calls"] - before == 3
    fwd = [s for s in spans if s.name == "dit.forward"]
    att = [s for s in spans if s.name == "dit.attention"]
    assert len(fwd) == 2 and all(s.attrs == {"batch": 1} for s in fwd)
    assert len(att) == 2 * TINY["depth"] and {s.parent for s in att} == {s.id for s in fwd}


def _restore_config(tmp_path, images):
    from tests.test_torch_pipeline import _config
    path = _config(tmp_path, images, sample_pattern=dict(
        pattern="pcgs", update_start=0.7, update_end=0, global_N=1, local_M=1, s_start=1,
        s_end=0, n_iter=2, start_guidance=1, stop_guidance=0))
    cfg = C.load_yaml(path)
    del cfg["unet_model"]
    cfg["dit_model"] = TINY_DIT
    cfg["conditioning"]["params"]["x_prev_every"] = 2
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    return path


def test_restore_prior_and_serve_run_the_dit(tmp_path):
    from osmosis_tpu_torch.pipelines.prior import run_prior_sampling
    from osmosis_tpu_torch.pipelines.restore import run_restoration
    from osmosis_tpu_torch.tools import serve

    images = str(tmp_path / "images")
    os.makedirs(images)
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (40, 48, 3), np.uint8)).save(
        pjoin(images, "img_0.png"))
    path = _restore_config(tmp_path, images)
    out = run_restoration(path, device="cpu")
    rgb = np.asarray(Image.open(pjoin(out, "single_images", "rgb", "img_0.png")))
    assert rgb.shape == (32, 32, 3)
    log = open(pjoin(out, "log.txt")).read()
    assert "Results values" in log and "pretrained model file: " in log

    cfg = C.load_yaml(path)
    prior_cfg = dict(save_dir=cfg["save_dir"], number_of_images=1, manual_seed=1,
                     save_singles=True, save_grids=False, record_process=False, record_every=4,
                     dit_model=dict(TINY_DIT, use_fp16=True),
                     diffusion=dict(cfg["diffusion"], timestep_respacing=3))
    prior_path = str(tmp_path / "prior.yaml")
    with open(prior_path, "w") as f:
        yaml.dump(prior_cfg, f)
    out = run_prior_sampling(prior_path, device="cpu")
    assert os.path.exists(pjoin(out, "single_images", "rgb", "image_0.png"))
    assert "bf16 torso, fp32 LayerNorm statistics" in open(pjoin(out, "log.txt")).read()

    restorer = serve.Restorer(path, device="cpu", warmup=False)
    assert isinstance(restorer.model, DiTModel) and restorer.image_size == 32
    buf = pjoin(images, "img_0.png")
    res = restorer.restore(open(buf, "rb").read(), seed=3)
    assert np.isfinite(res["final_loss"])


UNET_PRESETS = sorted(f for f in os.listdir(pjoin(REPO, "configs")) if f.endswith(".yaml"))
TINY_UNET_SIZES = dict(image_size=32, num_channels=32, num_res_blocks=1, channel_mult="1,2",
                       attention_resolutions="8", num_head_channels=16)


@pytest.mark.parametrize("name", UNET_PRESETS)
def test_unet_presets_build_the_unet_they_built(tmp_path, name):
    """Each preset's ``unet_model`` (its sizes cut to the tiny UNet) through
    the dispatch against what the entry points built before it: the same
    class, dtype and bits."""
    from osmosis_tpu_torch.models.convert import load_unet
    from osmosis_tpu_torch.models.unet import UNetModel, unet_config_from_yaml
    from osmosis_tpu_torch.pipelines.restore import torso_dtype

    args = C.arguments_from_file(pjoin(REPO, "configs", name))
    args.unet_model = dict(args.unet_model, **TINY_UNET_SIZES,
                           model_path=str(tmp_path / "absent.pt"))
    dtype = torso_dtype(args)
    assert dtype == (torch.bfloat16 if args.unet_model.get("use_fp16") else torch.float32)
    assert MP.model_settings(args) is args.unet_model
    got = MP.load_model(args, "cpu", dtype)
    want = load_unet(args.unet_model["model_path"], unet_config_from_yaml(args.unet_model),
                     "cpu", dtype=dtype)
    assert type(got) is UNetModel and got.cfg == want.cfg
    sg, sw = got.state_dict(), want.state_dict()
    assert list(sg) == list(sw)
    assert all(sg[k].dtype == sw[k].dtype and torch.equal(sg[k], sw[k]) for k in sw)


def test_a_preset_needs_one_model_section():
    ns = argparse.Namespace(unet_model={}, dit_model={})
    with pytest.raises(ValueError, match="exactly one model section"):
        MP.model_section(ns)
    with pytest.raises(ValueError, match="exactly one model section"):
        MP.model_section(argparse.Namespace())


def test_tensor_parallelism_refuses_the_dit():
    from osmosis_tpu_torch.parallel import mesh as M

    model = load_dit("", DiTConfig(**TINY), "cpu")
    with pytest.raises(NotImplementedError, match="tp = 1"):
        M.shard_params(model, M.Mesh(dp=1, tp=2))
    assert M.shard_params(model, M.Mesh(dp=2, tp=1)) is model
