"""The port's guided chain against ``osmosis_tpu.diffusion.guided``.

(a) The fake-model harness of tests/test_guided_loop.py (T=50, 8x8, pcgs,
    n_iter 3, no noise): every output and trace at rtol 1e-4 / atol 1e-5.
(b) The tiny UNet over 10 steps at scale 2,2,2,0.5 with noise drawn on the
    JAX side as ``normal(fold_in(fold_in(key, t), 0))`` and fed to the port
    through ``noise_fn``: the UNet adds float32 summation-order differences
    (1e-6 relative) that ten guided steps amplify, so the bar is rtol 1e-3 /
    atol 1e-4, the repo's guided-chain bar (test_guided_loop.py).
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

T_STEPS = 50
HW = 8

PATTERN = dict(
    pattern="pcgs", update_start=0.7, update_end=0, global_N=1, local_M=1,
    s_start=1, s_end=0, n_iter=3, start_guidance=1, stop_guidance=0,
)
COND_PARAMS = dict(
    loss_function="norm", loss_weight="depth", weight_function="gamma,1.4,1.4,1",
    scale="7,7,7,0.9", gradient_x_prev=True, gradient_clip="True,0.005",
)
OP_KW = dict(
    optimizer="sgd", depth_type="gamma", value="1.4,1.4,1",
    phi_a="1.1,0.95,0.95", phi_a_eta=1e-4, phi_a_learn_flag=True,
    phi_b="0.95, 0.8, 0.8", phi_b_eta=1e-4, phi_b_learn_flag=True,
    phi_inf="0.14, 0.29, 0.49", phi_inf_eta=1e-4, phi_inf_learn_flag=True,
)
AUX = {"aux_loss": {"avrg_loss": 0.5, "val_loss": 20.0}}


def _fake_model_jax(x, t):
    tb = t.astype(jnp.float32).reshape(-1, 1, 1, 1)
    return jnp.concatenate([0.3 * x + 0.001 * tb, 0.1 * x], axis=-1)


def _fake_model_torch(x, t):
    tb = t.float().reshape(-1, 1, 1, 1)
    return torch.cat([0.3 * x + 0.001 * tb, 0.1 * x], dim=-1)


def _assert_result_close(res, jres, rtol, atol):
    close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        a.detach().cpu().numpy(), np.asarray(b), rtol=rtol, atol=atol)
    close(res.sample, jres.sample)
    close(res.pred_xstart, jres.pred_xstart)
    close(res.sep_loss, jres.sep_loss)
    close(res.x0_std_trace, jres.x0_std_trace)
    for k in ("phi_a", "phi_b", "phi_inf"):
        close(res.phi[k], jres.phi[k])
        close(res.phi_trace[k], jres.phi_trace[k])
    for k in ("avrg_loss", "val_loss"):
        close(res.aux_trace[k], jres.aux_trace[k])


def test_fake_model_chain_matches_jax():
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((1, HW, HW, 4)).astype(np.float32)
    y = rng.uniform(-1, 1, (1, HW, HW, 3)).astype(np.float32)

    jres = jax_guided_sample_loop(
        _fake_model_jax, jax_make_schedule("linear", T_STEPS), jnp.asarray(x0), jnp.asarray(y),
        jax.random.key(0), jax_get_operator("underwater_physical_revised", batch_size=1, **OP_KW),
        JaxGuidanceConfig.from_config("osmosis", COND_PARAMS, PATTERN, AUX),
        JaxSamplerConfig(clip_denoised=True), sample_pattern=PATTERN, deterministic=True,
        record_every=10,
    )
    res = guided_sample_loop(
        _fake_model_torch, make_schedule("linear", T_STEPS), torch.from_numpy(x0),
        torch.from_numpy(y), get_operator("underwater_physical_revised", batch_size=1, **OP_KW),
        GuidanceConfig.from_config("osmosis", COND_PARAMS, PATTERN, AUX),
        SamplerConfig(clip_denoised=True), sample_pattern=PATTERN, deterministic=True,
        record_every=10,
    )
    assert res.sep_loss.shape == (T_STEPS, 1)
    _assert_result_close(res, jres, rtol=1e-4, atol=1e-5)
    assert res.snapshot_steps == jres.snapshot_steps
    np.testing.assert_allclose(res.x0_snapshots.numpy(), np.asarray(jres.x0_snapshots),
                               rtol=1e-4, atol=1e-5)


def test_tiny_unet_chain_with_jax_noise_matches_jax():
    from osmosis_tpu.models import UNetConfig as JaxUNetConfig
    from osmosis_tpu.models import UNetModel as JaxUNet
    from osmosis_tpu_torch.models.convert import state_dict_from_jax
    from osmosis_tpu_torch.models.unet import UNetConfig, UNetModel
    from tests.test_torch_unet import TINY_KW

    steps = 10
    params_cond = dict(COND_PARAMS, scale="2,2,2,0.5")
    jmodel = JaxUNet(JaxUNetConfig(**TINY_KW))
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)))
    prng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) if np.asarray(a).any()
        else (0.02 * prng.standard_normal(np.shape(a))).astype(np.float32), params)
    cfg = UNetConfig(**TINY_KW)
    tmodel = UNetModel(cfg)
    tmodel.load_state_dict(state_dict_from_jax(params, cfg))
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
    ))(params, jnp.asarray(x_init), jnp.asarray(y))

    def noise_fn(t, shape):
        k = jax.random.fold_in(jax.random.fold_in(key, t), 0)
        return torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))

    res = guided_sample_loop(
        tmodel, make_schedule("linear", 1000, str(steps)), torch.from_numpy(x_init),
        torch.from_numpy(y), get_operator("underwater_physical_revised", batch_size=1, **OP_KW),
        GuidanceConfig.from_config("osmosis", params_cond, PATTERN, AUX),
        SamplerConfig(), sample_pattern=PATTERN, noise_fn=noise_fn,
    )
    _assert_result_close(res, jres, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("change", [
    dict(params=dict(gradient_x_prev=False)),
    dict(params=dict(x_prev_every=2)),
    dict(method="ps"),
    dict(sampler="ddim"),
    dict(pattern=dict(local_M=2, s_start=0.5, s_end=0.1)),
    dict(pattern=dict(phi_warmup_iters=3)),
    dict(pattern=dict(start_guidance=0.5)),
])
def test_configurations_outside_the_slice_raise(change):
    params = dict(COND_PARAMS, **change.get("params", {}))
    pattern = dict(PATTERN, **change.get("pattern", {}))
    gcfg = GuidanceConfig.from_config(change.get("method", "osmosis"), params, pattern, AUX)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        guided_sample_loop(
            _fake_model_torch, make_schedule("linear", 1000, "10"), torch.zeros(1, HW, HW, 4),
            torch.zeros(1, HW, HW, 3),
            get_operator("underwater_physical_revised", batch_size=1, **OP_KW), gcfg,
            SamplerConfig(sampler=change.get("sampler", "ddpm")), sample_pattern=pattern,
            deterministic=True,
        )


def test_stochastic_chain_needs_a_generator_and_is_reproducible():
    op = get_operator("underwater_physical_revised", batch_size=1, **OP_KW)
    gcfg = GuidanceConfig.from_config("osmosis", COND_PARAMS, PATTERN, AUX)
    sch = make_schedule("linear", T_STEPS)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, HW, HW, 4)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-1, 1, (1, HW, HW, 3)).astype(np.float32))
    scfg = SamplerConfig(clip_denoised=True)
    with pytest.raises(ValueError):
        guided_sample_loop(_fake_model_torch, sch, x, y, op, gcfg, scfg, sample_pattern=PATTERN)
    runs = [
        guided_sample_loop(_fake_model_torch, sch, x, y, op, gcfg, scfg, sample_pattern=PATTERN,
                           generator=torch.Generator().manual_seed(4)).sample
        for _ in range(2)
    ]
    assert torch.equal(runs[0], runs[1]) and torch.isfinite(runs[0]).all()
