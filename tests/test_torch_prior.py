"""The port's unconditional sampler and RGBD prior pipeline.

* ``sample_loop`` against ``osmosis_tpu.diffusion.sampler.sample_loop`` with
  the JAX draws ``normal(fold_in(key, t))`` fed through ``noise_fn``: the
  timestep offset, the last-N window, both samplers and the x_t / x0-hat
  snapshots. The fake model at rtol 1e-4 / atol 1e-5, the bar of the fake
  guided chains; x0-hat = sqrt(1/ᾱ_t)·x − sqrt(1/ᾱ_t − 1)·eps turns a one-ulp
  difference of x_t into 150 ulps near t = 999, so a snapshot of x0-hat
  takes atol 1e-5 · max(1, sqrt(1/ᾱ_t − 1)). The tiny UNet at rtol 1e-3 /
  atol 1e-4, the repo's UNet-chain bar (test_torch_guided.py).
* ``run_prior_sampling`` and ``python -m osmosis_tpu_torch.prior_sample --cpu``
  on a tiny random-init UNet write the JAX package's run-dir layout; without
  a card the entry points raise rather than fall back to the CPU.
"""

import json
import os
from os.path import join as pjoin

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from osmosis_tpu.diffusion import make_schedule as jax_make_schedule
from osmosis_tpu.diffusion.sampler import SamplerConfig as JaxSamplerConfig
from osmosis_tpu.diffusion.sampler import sample_loop as jax_sample_loop
from osmosis_tpu_torch.diffusion.sampler import SamplerConfig, sample_loop
from osmosis_tpu_torch.diffusion.schedules import make_schedule
from osmosis_tpu_torch.pipelines.prior import run_prior_sampling
from tests.test_torch_guided import _fake_model_jax, _fake_model_torch
from tests.test_torch_pipeline import TINY_UNET


def _noise_fn(key):
    def noise_fn(t, shape):
        k = jax.random.fold_in(key, t)
        return torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))

    return noise_fn


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", [
    dict(),
    dict(var_type="fixed_small", offset=1.0, respacing="", start_t=1000, num_steps=12,
         record_steps=(999, 995, 991, 0)),
    dict(var_type="fixed_small", offset=1.0, respacing="", start_t=20, num_steps=20,
         record_steps=(19, 9, 0)),
    dict(sampler="ddim", eta=0.5, respacing="ddim10", record_every=3),
    dict(var_type="fixed_large", start_t=15, num_steps=7, record_every=4),
], ids=["ddpm", "prior_window_head", "prior_window_tail", "ddim", "fixed_large_window"])
def test_sample_loop_matches_jax(case):
    respacing = case.get("respacing", "20")
    kw = dict(timestep_offset=case.get("offset", 0.0), start_t=case.get("start_t"),
              num_steps=case.get("num_steps"), record_every=case.get("record_every"),
              record_steps=case.get("record_steps"))
    cfg = dict(sampler=case.get("sampler", "ddpm"), model_var_type=case.get("var_type",
                                                                             "learned_range"),
               ddim_eta=case.get("eta", 0.0), clip_denoised=True)
    x = np.random.default_rng(0).standard_normal((1, 8, 8, 4)).astype(np.float32)
    key = jax.random.key(3)
    jx, jsnaps = jax_sample_loop(_fake_model_jax, jax_make_schedule("linear", 1000, respacing),
                                 jnp.asarray(x), key, JaxSamplerConfig(**cfg), **kw)
    tx, snaps = sample_loop(_fake_model_torch, make_schedule("linear", 1000, respacing),
                            torch.from_numpy(x), SamplerConfig(**cfg), noise_fn=_noise_fn(key),
                            **kw)
    _close(tx, jx, 1e-4, 1e-5)
    assert (snaps is None) == (jsnaps is None)
    if snaps is not None:
        assert snaps["steps"] == jsnaps["steps"]
        _close(snaps["x_t"], jsnaps["x_t"], 1e-4, 1e-5)
        srm1 = make_schedule("linear", 1000, respacing).sqrt_recipm1_alphas_cumprod
        for k, t in enumerate(snaps["steps"]):
            _close(snaps["x0_hat"][k], jsnaps["x0_hat"][k], 1e-4, 1e-5 * max(1.0, srm1[t]))


def test_tiny_unet_prior_chain_matches_jax():
    """The prior's settings (fixed_small, +1 offset, the last 6 of 1000 steps)
    through the tiny UNet, forwards only."""
    from osmosis_tpu.models import UNetConfig as JaxUNetConfig
    from tests.test_torch_unet import TINY_KW, _jax_params, _port_model

    jmodel, params = _jax_params(JaxUNetConfig(**TINY_KW), seed=4)
    from osmosis_tpu_torch.models.unet import UNetConfig

    tmodel = _port_model(params, UNetConfig(**TINY_KW))
    x = np.random.default_rng(1).standard_normal((1, 32, 32, 4)).astype(np.float32)
    key = jax.random.key(9)
    kw = dict(timestep_offset=1.0, start_t=1000, num_steps=6, record_steps=(999, 996, 0))
    jx, jsnaps = jax.jit(lambda p, xx: jax_sample_loop(
        lambda a, t: jmodel.apply(p, a, t), jax_make_schedule("linear", 1000), xx, key,
        JaxSamplerConfig(model_var_type="fixed_small"), **kw))(params, jnp.asarray(x))
    tx, snaps = sample_loop(tmodel, make_schedule("linear", 1000), torch.from_numpy(x),
                            SamplerConfig(model_var_type="fixed_small"), noise_fn=_noise_fn(key),
                            **kw)
    _close(tx, jx, 1e-3, 1e-4)
    _close(snaps["x0_hat"], jsnaps["x0_hat"], 1e-3, 1e-4)


def test_sample_loop_needs_noise_and_is_reproducible():
    sch = make_schedule("linear", 1000, "5")
    x = torch.zeros(1, 4, 4, 4)
    with pytest.raises(ValueError):
        sample_loop(_fake_model_torch, sch, x)
    runs = [sample_loop(_fake_model_torch, sch, x, generator=torch.Generator().manual_seed(1))[0]
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and torch.isfinite(runs[0]).all()


def _prior_config(tmp_path, **overrides):
    cfg = dict(
        save_dir=str(tmp_path / "results"), number_of_images=2, manual_seed=4321,
        save_singles=True, save_grids=True, record_process=True, record_every=4,
        change_input_output_channels=True, input_channels=4, output_channels=8,
        unet_model=TINY_UNET,
        diffusion=dict(sampler="ddpm", steps=1000, noise_schedule="linear",
                       model_mean_type="epsilon", model_var_type="learned_range",
                       dynamic_threshold=False, clip_denoised=False, min_max_denoised=False,
                       rescale_timesteps=False, timestep_respacing=6),
    )
    cfg.update(overrides)
    path = str(tmp_path / "prior.yaml")
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    return path


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _check_prior_run_dir(out, n_images):
    assert os.path.basename(os.path.dirname(os.path.dirname(out))) == "RGBD_prior"
    assert os.path.exists(pjoin(out, "configurations.txt"))
    for i in range(n_images):
        for sub in ("rgb", "depth_color"):
            img = np.asarray(Image.open(pjoin(out, "single_images", sub, f"image_{i}.png")))
            assert img.shape[:2] == (32, 32), sub
        for name in (f"image_{i}.png", f"image_{i}_process.png"):
            assert os.path.exists(pjoin(out, "grid_results", name)), name
    assert not os.path.exists(pjoin(out, "single_images", "input"))
    with open(pjoin(out, "progress.json")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    assert [r["image"] for r in rows] == list(range(n_images))
    assert all(r["sample_finite"] for r in rows)
    log = open(pjoin(out, "log.txt")).read()
    assert "Inference image 1/2" in log and "Run time" in log


@pytest.mark.parametrize("use_fp16", [False, True], ids=["fp32", "bf16"])
def test_prior_sampling_on_cpu_writes_the_run_dir(tmp_path, use_fp16):
    cfg = _prior_config(tmp_path, unet_model=dict(TINY_UNET, use_fp16=use_fp16))
    out = run_prior_sampling(cfg, device="cpu")
    _check_prior_run_dir(out, 2)
    log = open(pjoin(out, "log.txt")).read()
    assert ("bf16 torso, fp32 GroupNorm statistics" in log) == use_fp16


def test_prior_cli_on_cpu(tmp_path):
    from osmosis_tpu_torch.prior_sample import main

    out = main(["-c", _prior_config(tmp_path, number_of_images=2), "--cpu"])
    _check_prior_run_dir(out, 2)


def test_prior_entry_points_refuse_to_fall_back_to_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from osmosis_tpu_torch.prior_sample import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_prior_sampling(_prior_config(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-c", _prior_config(tmp_path), "-d", "0"])
