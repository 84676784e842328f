"""The plain versions of the port's kernels against the JAX package.

* K1/K2's ops (``upsample_nearest_2x``, ``avg_pool_2x``), forward and VJP,
  against ``osmosis_tpu.models.nn`` and against the Pallas kernel itself, run
  in TPU interpret mode: exact. (The 2x2 sum is taken as XLA's CPU reduce
  takes it at these widths, pairs along W first; at C=32 XLA sums in row
  order instead, so the widths here are the UNet's, C >= 64.)
* The fused GroupNorm op (K3/K4's plain versions) against the JAX custom-VJP
  functions ``group_norm``, ``norm_silu`` and ``norm_film_silu``: forward and
  the VJP with respect to x, gamma, beta, s and t, at rtol 1e-5 / atol 1e-6.

On a CPU tensor every wrapper takes its plain version; the kernels themselves
run only on the card (chip_smoke.py and tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osmosis_tpu.models import nn as jnn
from osmosis_tpu_torch.ops import group_norm as gn
from osmosis_tpu_torch.ops import upsample as up


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(1, 8, 8, 128), (2, 4, 8, 64)])
def test_upsample_and_pool_match_jax_exactly(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    b, h, w, c = shape
    g_up = rng.standard_normal((b, 2 * h, 2 * w, c)).astype(np.float32)
    g_pool = rng.standard_normal((b, h // 2, w // 2, c)).astype(np.float32)

    jy, pull = jax.vjp(jnn.upsample_nearest_2x, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    ty = up.upsample_nearest_2x(xt)
    (tdx,) = torch.autograd.grad(ty, xt, _t(g_up))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tdx.numpy(), np.asarray(pull(jnp.asarray(g_up))[0]))

    jy, pull = jax.vjp(jnn.avg_pool_2x, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    ty = up.avg_pool_2x(xt)
    (tdx,) = torch.autograd.grad(ty, xt, _t(g_pool))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tdx.numpy(), np.asarray(pull(jnp.asarray(g_pool))[0]))


def test_upsample_matches_the_pallas_kernel_in_interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    from osmosis_tpu.ops.upsample import upsample_nearest_2x_pallas

    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 8, 8, 128)).astype(np.float32)
    g = rng.standard_normal((1, 16, 16, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jy, pull = jax.vjp(upsample_nearest_2x_pallas, jnp.asarray(x))
        (jdx,) = pull(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    ty = up.upsample_nearest_2x(xt)
    (tdx,) = torch.autograd.grad(ty, xt, _t(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tdx.numpy(), np.asarray(jdx))


def test_box_sum_scale_and_bf16_plain():
    x = torch.arange(2 * 4 * 4 * 8, dtype=torch.float32).reshape(2, 4, 4, 8)
    s = up.box_sum_2x_plain(x, 0.25)
    ref = x.reshape(2, 2, 2, 2, 2, 8).mean(dim=(2, 4))
    assert torch.equal(s, ref)
    u = up.upsample_nearest_2x_plain(x.bfloat16(), 0.25)
    assert u.dtype == torch.bfloat16 and u.shape == (2, 8, 8, 8)
    assert torch.equal(u[:, ::2, ::2].float(), (x.bfloat16().float() * 0.25).bfloat16().float())


def _gn_case(c, film, silu, seed):
    rng = np.random.default_rng(seed)
    b, h, w = 2, 6, 5
    x = (1.5 * rng.standard_normal((b, h, w, c)) + 0.3).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    fs = (0.2 * rng.standard_normal((b, c))).astype(np.float32)
    ft = (0.2 * rng.standard_normal((b, c))).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)

    if film:
        def jf(x_, ga, be, s_, t_):
            return jnn.norm_film_silu(x_, ga, be, s_[:, None, None, :], t_[:, None, None, :],
                                      32, 1e-5)
        args = (x, gamma, beta, fs, ft)
    elif silu:
        def jf(x_, ga, be):
            return jnn.norm_silu(x_, ga, be, 32, 1e-5)
        args = (x, gamma, beta)
    else:
        def jf(x_, ga, be):
            return jnn.group_norm(x_, ga, be, 32, 1e-5)
        args = (x, gamma, beta)
    jy, pull = jax.vjp(jf, *[jnp.asarray(a) for a in args])
    jgrads = pull(jnp.asarray(g))

    xt = _t(x.transpose(0, 3, 1, 2)).requires_grad_(True)
    targs = [xt] + [_t(a).requires_grad_(True) for a in args[1:]]
    film_t = (targs[3], targs[4]) if film else None
    ty = gn.group_norm_act(targs[0], targs[1], targs[2], film=film_t,
                           act="silu" if silu else None)
    tgrads = torch.autograd.grad(ty, targs, _t(g.transpose(0, 3, 1, 2)))

    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ty.detach().numpy().transpose(0, 2, 3, 1), np.asarray(jy), **tol)
    np.testing.assert_allclose(tgrads[0].numpy().transpose(0, 2, 3, 1), np.asarray(jgrads[0]),
                               **tol)
    for tg, jg in zip(tgrads[1:], jgrads[1:]):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg).reshape(tg.shape), **tol)


@pytest.mark.parametrize("c", [64, 96])
@pytest.mark.parametrize("film,silu", [(False, False), (False, True), (True, True)],
                         ids=["group_norm", "norm_silu", "norm_film_silu"])
def test_group_norm_ops_match_jax(c, film, silu):
    _gn_case(c, film, silu, seed=c + 2 * film + silu)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    x = torch.randn(1, 4, 4, 32)
    before = (up.upsample_nearest_2x_kernel.launches, up.box_sum_2x_kernel.launches,
              gn.group_norm_forward.launches, gn.group_norm_backward.launches)
    assert torch.equal(up.upsample_nearest_2x_kernel(x), up.upsample_nearest_2x_plain(x))
    assert torch.equal(up.box_sum_2x_kernel(x, 0.25), up.box_sum_2x_plain(x, 0.25))
    xn = x.permute(0, 3, 1, 2)
    w, b = torch.ones(32), torch.zeros(32)
    y, m, i = gn.group_norm_forward(xn, w, b, silu=True)
    yp, mp, ip = gn.group_norm_forward_plain(xn, w, b, silu=True)
    assert torch.equal(y, yp) and torch.equal(m, mp) and torch.equal(i, ip)
    after = (up.upsample_nearest_2x_kernel.launches, up.box_sum_2x_kernel.launches,
             gn.group_norm_forward.launches, gn.group_norm_backward.launches)
    assert before == after  # a count moves only where a kernel launches
    with pytest.raises(RuntimeError, match="no kernel"):
        up.upsample_nearest_2x_kernel(torch.empty(1, 2, 2, 32, device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        gn.group_norm_forward(torch.empty(1, 32, 2, 2, device="meta"), w, b)


def test_group_norm_rejects_bad_shapes_and_options():
    w, b = torch.ones(48), torch.zeros(48)
    with pytest.raises(ValueError):
        gn.group_norm_act(torch.randn(1, 48, 4, 4), w, b)  # 48 not divisible by 32
    w, b = torch.ones(32), torch.zeros(32)
    x = torch.randn(1, 32, 4, 4)
    with pytest.raises(ValueError):
        gn.group_norm_act(x, w, b, act="relu")
    with pytest.raises(ValueError):
        gn.group_norm_act(x, w, b, film=(torch.zeros(1, 32), torch.zeros(1, 32)))
