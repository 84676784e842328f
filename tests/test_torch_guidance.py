"""The port's guidance pieces against ``osmosis_tpu.guidance``: depth
conversion, the four operators, the auxiliary losses (values and gradients),
the three phi optimizers and the pcgs schedule masks. fp32 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osmosis_tpu.guidance import losses as JL
from osmosis_tpu.guidance import operators as JO
from osmosis_tpu.guidance import phi_optim as JP
from osmosis_tpu.guidance import schedule_masks as JM
from osmosis_tpu_torch.guidance import losses as TL
from osmosis_tpu_torch.guidance import operators as TO
from osmosis_tpu_torch.guidance import phi_optim as TP
from osmosis_tpu_torch.guidance import schedule_masks as TM

TOL = dict(rtol=1e-6, atol=1e-7)
OP_KW = dict(
    optimizer="sgd", depth_type="gamma", value="1.4,1.4,1",
    phi_a="1.1,0.95,0.95", phi_a_eta=1e-4, phi_a_learn_flag=True,
    phi_b="0.95, 0.8, 0.8", phi_b_eta=1e-4, phi_b_learn_flag=False,
    phi_inf="0.14, 0.29, 0.49", phi_inf_eta="1e-4,2e-4,3e-4", phi_inf_learn_flag=True,
    phi_ab="0.6,0.5,0.4", phi_ab_eta=1e-4,
)


def _rgbd(seed=0, shape=(2, 5, 7, 4)):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("depth_type,value", [
    ("gamma", np.array([1.4, 1.4, 1.0])), ("gamma", np.array([1.2, 0.9, 1.3])),
    ("original", None), (None, None), ("move", 0.5),
])
def test_convert_depth_matches_jax(depth_type, value):
    d = _rgbd()[..., 3:4]
    np.testing.assert_allclose(
        TO.convert_depth(torch.from_numpy(d), depth_type, value).numpy(),
        np.asarray(JO.convert_depth(jnp.asarray(d), depth_type, value)), **TOL)


@pytest.mark.parametrize("name", ["noise", "rgb_guidance", "underwater_physical_revised",
                                  "underwater_physical", "haze_physical"])
def test_operators_match_jax(name):
    ours = TO.get_operator(name, batch_size=2, **OP_KW)
    theirs = JO.get_operator(name, batch_size=2, **OP_KW)
    phi0 = theirs.phi_init()
    assert set(ours.phi_init()) == set(phi0)
    for k in phi0:
        np.testing.assert_array_equal(ours.phi_init()[k], phi0[k])
    for k, v in theirs.etas().items():
        np.testing.assert_array_equal(np.asarray(ours.etas()[k]), np.asarray(v))
    x = _rgbd(1)
    phi = {k: v + 0.01 * np.arange(v.size, dtype=np.float32).reshape(v.shape)
           for k, v in phi0.items()}
    np.testing.assert_allclose(
        ours.forward({k: torch.from_numpy(v) for k, v in phi.items()}, torch.from_numpy(x)).numpy(),
        np.asarray(theirs.forward({k: jnp.asarray(v) for k, v in phi.items()}, jnp.asarray(x))),
        **TOL)


def _loss_and_grad_pair(name, x):
    jv, jg = jax.value_and_grad(JL.LOSSES.get(name))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tv = TL.LOSSES.get(name)(xt)
    (tg,) = torch.autograd.grad(tv, xt)
    return (tv.detach().numpy(), np.asarray(jv)), (tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("name", ["avrg_loss", "val_loss"])
def test_aux_losses_and_gradients_match_jax(name):
    x = 1.3 * _rgbd(2)
    # one channel whose spatial mean is exactly 0: sign() subgradient 0
    x[0, ..., 1] = np.repeat([0.5, -0.5, 0.0], [17, 17, 1]).reshape(5, 7)
    assert x[0, ..., 1].mean() == 0.0
    for ours, theirs in _loss_and_grad_pair(name, x):
        np.testing.assert_allclose(ours, theirs, **TOL)


def test_aux_loss_container_matches_jax():
    cfg = {"avrg_loss": 0.5, "val_loss": 20.0}
    x = _rgbd(3)
    jt, jper = JL.make_aux_loss_fn(cfg)(jnp.asarray(x))
    tt, tper = TL.make_aux_loss_fn(cfg)(torch.from_numpy(x))
    np.testing.assert_allclose(float(tt), float(jt), **TOL)
    for k in cfg:
        np.testing.assert_allclose(float(tper[k]), float(jper[k]), **TOL)
    assert TL.make_aux_loss_fn({}) is None and JL.make_aux_loss_fn({}) is None


@pytest.mark.parametrize("opt", ["sgd", "adam", "rmsprop"])
def test_phi_optimizers_match_jax(opt):
    etas = {"phi_a": 1e-2, "phi_inf": np.asarray([1e-2, 2e-2, 3e-2], np.float32)}
    rng = np.random.default_rng(4)
    phi = {k: rng.uniform(0.1, 1.0, (1, 3)).astype(np.float32) for k in etas}
    jopt, topt = JP.make_phi_optimizer(opt, etas), TP.make_phi_optimizer(opt, etas)
    jphi = {k: jnp.asarray(v) for k, v in phi.items()}
    tphi = {k: torch.from_numpy(v) for k, v in phi.items()}
    jst, tst = jopt.init(jphi), topt.init(tphi)
    for step in range(4):
        g = {k: rng.standard_normal((1, 3)).astype(np.float32) for k in etas}
        jphi, jst = jopt.update(jphi, {k: jnp.asarray(v) for k, v in g.items()}, jst)
        tphi, tst = topt.update(tphi, {k: torch.from_numpy(v) for k, v in g.items()}, tst)
        for k in etas:
            np.testing.assert_allclose(tphi[k].numpy(), np.asarray(jphi[k]), rtol=1e-6,
                                       err_msg=f"{opt} step {step} {k}")


@pytest.mark.parametrize("pattern", [
    None,
    dict(pattern="original"),
    dict(pattern="pcgs", update_start=0.7, update_end=0, global_N=1, local_M=1, s_start=1,
         s_end=0, n_iter=20, start_guidance=1, stop_guidance=0),
    dict(pattern="pcgs", update_start=0.8, update_end=0.1, global_N=1, local_M=3, s_start=0.6,
         s_end=0.2, n_iter=5, start_guidance=0.9, stop_guidance=0.05, phi_warmup_iters=7),
])
def test_schedule_masks_equal_jax(pattern):
    ours, theirs = TM.pattern_masks(pattern, 100), JM.pattern_masks(pattern, 100)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
