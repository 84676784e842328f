"""Every guidance mode of the port's guided chain against
``osmosis_tpu.diffusion.guided``.

(a) The fake-model harness of tests/test_torch_guided.py (8x8, pcgs, clipped
    x0-hat) with each step's noise drawn on the JAX side as
    ``normal(fold_in(fold_in(key, t), i))`` and fed to the port through
    ``noise_fn``: every output and trace at rtol 1e-4 / atol 1e-5. Chains
    are 20 steps, and 10 in the x0-gradient mode: its unclipped guidance
    turns a one-ulp change of x_init into 1.6e-4 over 20 steps in the JAX
    loop alone. The ltsp eps history is compared times sqrt(1/ᾱ_t − 1) of
    the step that made it (the x-scale quantity sqrt(1/ᾱ_t)·x − x0-hat):
    eps itself divides that by 0.01 at t = 0.
(b) The tiny UNet over 10 steps in the x0-gradient and hybrid modes, at the
    repo's guided-chain bar, rtol 1e-3 / atol 1e-4 (as test_torch_guided.py).
(c) The JAX loop's refusals, raised by the port too.
(d) The poisson noiser: its draws come from a ``torch.Generator``, so it is
    held to JAX's in distribution: per level, the mean and variance over
    65536 draws within five standard errors of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osmosis_tpu.diffusion import make_schedule as jax_make_schedule
from osmosis_tpu.diffusion.guided import GuidanceConfig as JaxGuidanceConfig
from osmosis_tpu.diffusion.guided import guided_sample_loop as jax_guided_sample_loop
from osmosis_tpu.diffusion.sampler import SamplerConfig as JaxSamplerConfig
from osmosis_tpu.guidance.operators import get_operator as jax_get_operator
from osmosis_tpu_torch.diffusion.guided import GuidanceConfig, guided_sample_loop
from osmosis_tpu_torch.diffusion.sampler import SamplerConfig
from osmosis_tpu_torch.diffusion.schedules import make_schedule
from osmosis_tpu_torch.guidance.operators import get_operator
from tests.test_torch_guided import AUX, COND_PARAMS, HW, OP_KW, PATTERN, _fake_model_jax
from tests.test_torch_guided import _fake_model_torch

PS_PARAMS = dict(scale="0.3", gradient_x_prev=True)


def _noise_fn(key):
    def noise_fn(t, shape, i=0):
        k = jax.random.fold_in(jax.random.fold_in(key, t), i)
        return torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))

    return noise_fn


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(a.detach().cpu().numpy(), np.asarray(b), rtol=rtol, atol=atol)


def _assert_same(res, jres, rtol, atol, steps):
    for name in ("sample", "pred_xstart", "sep_loss", "x0_std_trace", "x0_snapshots"):
        _close(getattr(res, name), getattr(jres, name), rtol, atol)
    assert res.snapshot_steps == jres.snapshot_steps
    assert set(res.phi) == set(jres.phi) and set(res.aux_trace) == set(jres.aux_trace)
    for k in res.phi:
        _close(res.phi[k], jres.phi[k], rtol, atol)
        _close(res.phi_trace[k], jres.phi_trace[k], rtol, atol)
    for k in res.aux_trace:
        _close(res.aux_trace[k], jres.aux_trace[k], rtol, atol)
    assert (res.eps_hist is None) == (jres.eps_hist is None)
    _close_eps_hist(res.eps_hist or (), jres.eps_hist or (), steps, rtol, atol)


def _close_eps_hist(hist, jhist, steps, rtol, atol):
    """The final eps history holds eps_t for t = 0, 1, 2, most recent first."""
    srm1 = make_schedule("linear", 1000, str(steps)).sqrt_recipm1_alphas_cumprod
    for t, (a, b) in enumerate(zip(hist, jhist)):
        _close(a * float(srm1[t]), np.asarray(b) * np.float32(srm1[t]), rtol, atol)


def _run_fake(method="osmosis", params=None, pattern=None, steps=20, sampler="ddpm",
              ddim_eta=0.0, noiser="gaussian", seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((1, HW, HW, 4)).astype(np.float32)
    if method == "ps":
        op_name, op_kw = "rgb_guidance", {}
        params = dict(PS_PARAMS, **(params or {}))
        aux = None
        # the poisson loss runs over the full x0-hat, so its y has 4 channels
        y = rng.uniform(0.2, 1, (1, HW, HW, 4 if noiser == "poisson" else 3))
    else:
        op_name, op_kw = "underwater_physical_revised", OP_KW
        params = dict(COND_PARAMS, **(params or {}))
        aux = AUX
        y = rng.uniform(-1, 1, (1, HW, HW, 3))
    y = y.astype(np.float32)
    pattern = dict(PATTERN, **(pattern or {}))
    key = jax.random.key(seed + 11)
    jres = jax_guided_sample_loop(
        _fake_model_jax, jax_make_schedule("linear", 1000, str(steps)), jnp.asarray(x0),
        jnp.asarray(y), key, jax_get_operator(op_name, batch_size=1, **op_kw),
        JaxGuidanceConfig.from_config(method, params, pattern, aux, noiser_name=noiser),
        JaxSamplerConfig(sampler=sampler, clip_denoised=True, ddim_eta=ddim_eta),
        sample_pattern=pattern, record_every=4,
    )
    res = guided_sample_loop(
        _fake_model_torch, make_schedule("linear", 1000, str(steps)), torch.from_numpy(x0),
        torch.from_numpy(y), get_operator(op_name, batch_size=1, **op_kw),
        GuidanceConfig.from_config(method, params, pattern, aux, noiser_name=noiser),
        SamplerConfig(sampler=sampler, clip_denoised=True, ddim_eta=ddim_eta),
        sample_pattern=pattern, record_every=4, noise_fn=_noise_fn(key),
    )
    return res, jres


@pytest.mark.parametrize("case", [
    dict(params=dict(gradient_x_prev=False), steps=10),
    dict(params=dict(x_prev_every=2), steps=10),
    dict(params=dict(x_prev_every=3), steps=10),
    dict(params=dict(x_prev_every=4), steps=10),
    dict(pattern=dict(start_guidance=0.5, stop_guidance=0.1)),
    dict(pattern=dict(local_M=2, s_start=0.5, s_end=0.1)),
    dict(pattern=dict(phi_warmup_iters=3)),
    dict(pattern=dict(n_iter=34, update_start=1.0), steps=6),
    dict(sampler="ddim"),
    dict(sampler="ltsp"),
    dict(sampler="ltsp", params=dict(x_prev_every=2)),
    dict(method="ps"),
    dict(method="ps", noiser="poisson"),
    dict(method="ps", sampler="ddim", ddim_eta=0.5),
    dict(method="ps", params=dict(x_prev_every=3), steps=10),
    dict(method="ps", pattern=dict(local_M=2, s_start=0.5, s_end=0.1)),
], ids=["x0", "hybrid_k2", "hybrid_k3", "hybrid_k4", "plain_window", "local_M2",
        "phi_warmup", "n_iter_34", "osmosis_ddim", "ltsp", "ltsp_hybrid", "ps_gaussian",
        "ps_poisson", "ps_ddim", "ps_hybrid", "ps_local_M2"])
def test_fake_model_mode_matches_jax(case):
    res, jres = _run_fake(**case)
    assert res.sep_loss.shape == jres.sep_loss.shape
    _assert_same(res, jres, rtol=1e-4, atol=1e-5, steps=case.get("steps", 20))


def test_ltsp_eps_history_carries_in():
    """A chain started with another chain's eps history (``eps_hist_init``)
    matches the JAX loop given the same history."""
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((1, HW, HW, 4)).astype(np.float32)
    y = rng.uniform(-1, 1, (1, HW, HW, 3)).astype(np.float32)
    hist = [rng.standard_normal((1, HW, HW, 4)).astype(np.float32) for _ in range(3)]
    key = jax.random.key(2)
    jres = jax_guided_sample_loop(
        _fake_model_jax, jax_make_schedule("linear", 1000, "20"), jnp.asarray(x0), jnp.asarray(y),
        key, jax_get_operator("underwater_physical_revised", batch_size=1, **OP_KW),
        JaxGuidanceConfig.from_config("osmosis", COND_PARAMS, PATTERN, AUX),
        JaxSamplerConfig(sampler="ltsp", clip_denoised=True), sample_pattern=PATTERN,
        eps_hist_init=tuple(jnp.asarray(h) for h in hist),
    )
    res = guided_sample_loop(
        _fake_model_torch, make_schedule("linear", 1000, "20"), torch.from_numpy(x0),
        torch.from_numpy(y), get_operator("underwater_physical_revised", batch_size=1, **OP_KW),
        GuidanceConfig.from_config("osmosis", COND_PARAMS, PATTERN, AUX),
        SamplerConfig(sampler="ltsp", clip_denoised=True), sample_pattern=PATTERN,
        eps_hist_init=tuple(torch.from_numpy(h) for h in hist), noise_fn=_noise_fn(key),
    )
    _close(res.sample, jres.sample, 1e-4, 1e-5)
    _close_eps_hist(res.eps_hist, jres.eps_hist, 20, 1e-4, 1e-5)


class _CountingModel(torch.nn.Module):
    """The fake model, counting forwards made with autograd on and off."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def forward(self, x, t):
        self.calls.append(torch.is_grad_enabled())
        return _fake_model_torch(x, t)


@pytest.mark.parametrize("k,steps", [(3, 10), (4, 10), (1, 6)])
def test_x_prev_steps_sit_at_block_starts_and_x0_steps_build_no_graph(k, steps):
    """The x_prev (pullback) steps are chain positions 0, k, 2k, ... (the
    remainder block starts with one too); the x0 steps run the model with
    autograd off, so they keep no activations."""
    model = _CountingModel()
    params = dict(COND_PARAMS, x_prev_every=k)
    guided_sample_loop(
        model, make_schedule("linear", 1000, str(steps)), torch.zeros(1, HW, HW, 4),
        torch.zeros(1, HW, HW, 3), get_operator("underwater_physical_revised", batch_size=1,
                                                **OP_KW),
        GuidanceConfig.from_config("osmosis", params, PATTERN, AUX),
        SamplerConfig(clip_denoised=True), sample_pattern=PATTERN, deterministic=True,
    )
    assert model.calls == [s % k == 0 for s in range(steps)]


@pytest.mark.parametrize("bad,exc", [
    (dict(params=dict(gradient_x_prev=False, x_prev_every=2)), ValueError),
    (dict(params=dict(x_prev_every=10)), ValueError),
    (dict(method="ps", noiser="clean"), NotImplementedError),
    (dict(method="ps", sampler="ltsp"), NotImplementedError),
    (dict(sampler="ltsp", pattern=dict(local_M=2, s_start=0.5, s_end=0.1)),
     NotImplementedError),
], ids=["x_prev_every_without_x_prev", "x_prev_every_not_below_T", "ps_clean_noiser",
        "ltsp_ps", "ltsp_local_M2"])
def test_refusals_match_jax(bad, exc):
    method = bad.get("method", "osmosis")
    params = dict(PS_PARAMS if method == "ps" else COND_PARAMS, **bad.get("params", {}))
    pattern = dict(PATTERN, **bad.get("pattern", {}))
    noiser = bad.get("noiser", "gaussian")
    op = "rgb_guidance" if method == "ps" else "underwater_physical_revised"
    kw = {} if method == "ps" else OP_KW
    sampler = bad.get("sampler", "ddpm")
    with pytest.raises(exc):
        jax_guided_sample_loop(
            _fake_model_jax, jax_make_schedule("linear", 1000, "10"), jnp.zeros((1, HW, HW, 4)),
            jnp.zeros((1, HW, HW, 3)), jax.random.key(0), jax_get_operator(op, batch_size=1, **kw),
            JaxGuidanceConfig.from_config(method, params, pattern, AUX, noiser_name=noiser),
            JaxSamplerConfig(sampler=sampler), sample_pattern=pattern, deterministic=True)
    with pytest.raises(exc):
        guided_sample_loop(
            _fake_model_torch, make_schedule("linear", 1000, "10"), torch.zeros(1, HW, HW, 4),
            torch.zeros(1, HW, HW, 3), get_operator(op, batch_size=1, **kw),
            GuidanceConfig.from_config(method, params, pattern, AUX, noiser_name=noiser),
            SamplerConfig(sampler=sampler), sample_pattern=pattern, deterministic=True)


@pytest.mark.parametrize("params", [dict(gradient_x_prev=False), dict(x_prev_every=3)],
                         ids=["x0", "hybrid_k3"])
def test_tiny_unet_mode_chain_with_jax_noise_matches_jax(params):
    from osmosis_tpu.models import UNetConfig as JaxUNetConfig
    from osmosis_tpu.models import UNetModel as JaxUNet
    from osmosis_tpu_torch.models.convert import state_dict_from_jax
    from osmosis_tpu_torch.models.unet import UNetConfig, UNetModel
    from tests.test_torch_unet import TINY_KW

    steps = 10
    params_cond = dict(COND_PARAMS, scale="2,2,2,0.5", **params)
    jmodel = JaxUNet(JaxUNetConfig(**TINY_KW))
    jparams = jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)))
    prng = np.random.default_rng(7)
    jparams = jax.tree_util.tree_map(
        lambda a: np.asarray(a) if np.asarray(a).any()
        else (0.02 * prng.standard_normal(np.shape(a))).astype(np.float32), jparams)
    cfg = UNetConfig(**TINY_KW)
    tmodel = UNetModel(cfg)
    tmodel.load_state_dict(state_dict_from_jax(jparams, cfg))
    tmodel.requires_grad_(False).to(memory_format=torch.channels_last)

    rng = np.random.default_rng(3)
    x_init = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    y = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(5)
    jres = jax.jit(lambda p, x, y_: jax_guided_sample_loop(
        lambda xx, t: jmodel.apply(p, xx, t), jax_make_schedule("linear", 1000, str(steps)),
        x, y_, key, jax_get_operator("underwater_physical_revised", batch_size=1, **OP_KW),
        JaxGuidanceConfig.from_config("osmosis", params_cond, PATTERN, AUX),
        JaxSamplerConfig(), sample_pattern=PATTERN,
    ))(jparams, jnp.asarray(x_init), jnp.asarray(y))
    res = guided_sample_loop(
        tmodel, make_schedule("linear", 1000, str(steps)), torch.from_numpy(x_init),
        torch.from_numpy(y), get_operator("underwater_physical_revised", batch_size=1, **OP_KW),
        GuidanceConfig.from_config("osmosis", params_cond, PATTERN, AUX),
        SamplerConfig(), sample_pattern=PATTERN, noise_fn=_noise_fn(key),
    )
    for name in ("sample", "pred_xstart", "sep_loss", "x0_std_trace"):
        _close(getattr(res, name), getattr(jres, name), 1e-3, 1e-4)
    for k in res.phi:
        _close(res.phi_trace[k], jres.phi_trace[k], 1e-3, 1e-4)


@pytest.mark.parametrize("rate", [1.0, 0.3])
def test_poisson_noiser_matches_jax_in_distribution(rate):
    from osmosis_tpu.guidance.noise import get_noiser as jax_get_noiser
    from osmosis_tpu_torch.guidance.noise import get_noiser

    levels = np.array([-0.9, -0.4, 0.0, 0.5], np.float32)  # one per channel
    data = np.broadcast_to(levels, (1, 256, 256, 4)).copy()
    got = get_noiser("poisson", rate=rate)(
        torch.from_numpy(data), generator=torch.Generator().manual_seed(0)).numpy()
    ref = np.asarray(jax_get_noiser("poisson", rate=rate)(jnp.asarray(data), key=jax.random.key(0)))
    assert got.dtype == np.float32 and got.shape == data.shape
    assert got.min() >= -1 and got.max() <= 1
    n = data[..., 0].size
    for c in range(4):
        a, b = got[..., c].ravel(), ref[..., c].ravel()
        var = b.var()
        assert abs(a.mean() - b.mean()) <= 5 * np.sqrt(2 * var / n), c
        # the sample variance's standard error, from the fourth central moment
        se_var = np.sqrt((np.mean((b - b.mean()) ** 4) - var ** 2) / n)
        assert abs(a.var() - var) <= 5 * np.sqrt(2) * se_var, c
