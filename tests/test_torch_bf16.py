"""The port's bf16 torso against the JAX package's (``UNetConfig(dtype=bfloat16)``
with ``cast_params_half``), at the tiny parity config.

* The cast: every leaf of the port's cast model equals the JAX cast's,
  bit for bit, bf16 except the GroupNorm affines, which stay fp32.
* Forward and x-VJP: the two torsos round the same values to bf16 after
  convolutions whose fp32 sums run in another order (oneDNN here, XLA there),
  so single roundings differ by one bf16 ulp and compound over the layers.
  Measured on this config, relative to the output's largest magnitude: max
  |port - JAX| 1.2e-2 (forward) and 1.4e-2 (x-VJP), mean 1.7e-3 and 2.3e-3,
  1.1-1.3 times the JAX model's own bf16-vs-fp32 differences (max 0.9e-2,
  1.1e-2; mean 1.5e-3, 2.0e-3). The bars: max 3e-2 (about four bf16 ulps at
  that magnitude) and mean 5e-3.
* A 3-step bf16 guided chain (x0-hat clipped, so that random weights keep it
  finite) with the JAX draws fed through ``noise_fn``: the loss, x0-hat
  amplitude and phi traces at the same bars (measured max 2.2e-4). The
  sample and x0-hat at a mean of 1e-2 of their magnitude (measured 2.6e-3)
  and no elementwise bar: at t = 999 x0-hat is 157·x − 157·eps, so a one-ulp
  difference of eps moves an unclipped element of x0-hat by 0.6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osmosis_tpu.models import UNetConfig as JaxUNetConfig
from osmosis_tpu.models import UNetModel as JaxUNet
from osmosis_tpu.models.convert import cast_params_half as jax_cast_params_half
from osmosis_tpu_torch.models.convert import cast_params_half, state_dict_from_jax
from osmosis_tpu_torch.models.nn import GroupNorm32
from osmosis_tpu_torch.models.unet import UNetConfig, UNetModel
from tests.test_torch_unet import TINY_KW, _jax_params

MAX_REL, MEAN_REL = 3e-2, 5e-3
CHAIN_MEAN_REL = 1e-2


def _assert_bf16_close(what, got, ref, max_rel=MAX_REL, mean_rel=MEAN_REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), what
    scale = float(np.abs(ref).max())
    err = np.abs(got - ref)
    assert err.max() <= max_rel * scale, f"{what}: max err {err.max():.3e} over {scale:.3e}"
    assert err.mean() <= mean_rel * scale, f"{what}: mean err {err.mean():.3e} over {scale:.3e}"


def _bf16_models(seed=0):
    jmodel, params = _jax_params(JaxUNetConfig(**TINY_KW), seed=seed)
    cfg = UNetConfig(**TINY_KW, dtype=torch.bfloat16)
    tmodel = UNetModel(cfg)
    tmodel.load_state_dict(state_dict_from_jax(params, cfg))
    cast_params_half(tmodel).requires_grad_(False).to(memory_format=torch.channels_last)
    jmodel16 = JaxUNet(JaxUNetConfig(**TINY_KW, dtype=jnp.bfloat16))
    return jmodel16, jax_cast_params_half(params), tmodel, params


def test_cast_params_half_matches_jax_leaf_by_leaf():
    _, jparams16, tmodel, params = _bf16_models()
    cfg = tmodel.cfg
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams16), cfg)
    got = tmodel.state_dict()
    assert set(got) == set(want)
    norms = {f"{name}.{p}" for name, m in tmodel.named_modules() if isinstance(m, GroupNorm32)
             for p in ("weight", "bias")}
    assert "out.0.weight" in norms and "out.2.weight" not in norms
    for k, v in got.items():
        assert v.dtype == (torch.float32 if k in norms else torch.bfloat16), k
        assert torch.equal(v.float(), want[k]), k  # bit-exact: both round to nearest even
    fp32 = state_dict_from_jax(params, cfg)
    for k in norms:
        assert torch.equal(got[k], fp32[k]), k


def test_bf16_forward_and_x_vjp_match_jax():
    jmodel16, jparams16, tmodel, _ = _bf16_models()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    ts = np.array([17.0, 433.0], dtype=np.float32)
    g = rng.standard_normal((2, 32, 32, 8)).astype(np.float32)

    @jax.jit
    def jax_forward_and_vjp(p, xx, tt, gg):
        y, pull = jax.vjp(lambda a: jmodel16.apply(p, a, tt), xx)
        return y, pull(gg)[0]

    jy, jdx = jax_forward_and_vjp(jparams16, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    ty = tmodel(xt, torch.from_numpy(ts))
    (tdx,) = torch.autograd.grad(ty, xt, torch.from_numpy(g))
    assert ty.dtype == torch.float32 and tdx.dtype == torch.float32
    assert jy.dtype == jnp.float32
    _assert_bf16_close("forward", ty.detach().numpy(), jy)
    _assert_bf16_close("x-VJP", tdx.numpy(), jdx)


@pytest.mark.parametrize("params", [dict(), dict(x_prev_every=2)], ids=["x_prev", "hybrid_k2"])
def test_bf16_guided_chain_matches_jax(params):
    from osmosis_tpu.diffusion import make_schedule as jax_make_schedule
    from osmosis_tpu.diffusion.guided import GuidanceConfig as JaxGuidanceConfig
    from osmosis_tpu.diffusion.guided import guided_sample_loop as jax_guided_sample_loop
    from osmosis_tpu.diffusion.sampler import SamplerConfig as JaxSamplerConfig
    from osmosis_tpu.guidance.operators import get_operator as jax_get_operator
    from osmosis_tpu_torch.diffusion.guided import GuidanceConfig, guided_sample_loop
    from osmosis_tpu_torch.diffusion.sampler import SamplerConfig
    from osmosis_tpu_torch.diffusion.schedules import make_schedule
    from osmosis_tpu_torch.guidance.operators import get_operator
    from tests.test_torch_guided import AUX, COND_PARAMS, OP_KW, PATTERN
    from tests.test_torch_guided_modes import _noise_fn

    steps = 3
    cond = dict(COND_PARAMS, scale="2,2,2,0.5", **params)
    jmodel16, jparams16, tmodel, _ = _bf16_models(seed=2)
    rng = np.random.default_rng(3)
    x_init = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    y = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(5)
    jres = jax.jit(lambda p, x, y_: jax_guided_sample_loop(
        lambda xx, t: jmodel16.apply(p, xx, t), jax_make_schedule("linear", 1000, str(steps)),
        x, y_, key, jax_get_operator("underwater_physical_revised", batch_size=1, **OP_KW),
        JaxGuidanceConfig.from_config("osmosis", cond, PATTERN, AUX),
        JaxSamplerConfig(clip_denoised=True), sample_pattern=PATTERN,
    ))(jparams16, jnp.asarray(x_init), jnp.asarray(y))
    res = guided_sample_loop(
        tmodel, make_schedule("linear", 1000, str(steps)), torch.from_numpy(x_init),
        torch.from_numpy(y), get_operator("underwater_physical_revised", batch_size=1, **OP_KW),
        GuidanceConfig.from_config("osmosis", cond, PATTERN, AUX),
        SamplerConfig(clip_denoised=True), sample_pattern=PATTERN, noise_fn=_noise_fn(key),
    )
    assert res.sample.dtype == torch.float32
    for name in ("sample", "pred_xstart"):
        _assert_bf16_close(name, getattr(res, name).numpy(), getattr(jres, name),
                           max_rel=np.inf, mean_rel=CHAIN_MEAN_REL)
    for name in ("sep_loss", "x0_std_trace"):
        _assert_bf16_close(name, getattr(res, name).numpy(), getattr(jres, name))
    for k in res.phi:
        _assert_bf16_close(k, res.phi_trace[k].numpy(), jres.phi_trace[k])
