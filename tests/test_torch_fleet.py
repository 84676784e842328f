"""The guided loop's segment and scale arguments and the fleet runner
against the JAX package, and each fleet lane against its batch-1 run.

(a) ``eta_scale`` and ``ts`` + ``x0_buf_init`` segments against the JAX
    ``guided_sample_loop`` on the fake-model harness of test_torch_guided.py
    (8x8, pcgs, clipped x0-hat), each step's noise drawn on the JAX side as
    ``normal(fold_in(fold_in(key, t), i))`` and fed through ``noise_fn``:
    rtol 1e-4 / atol 1e-5, the harness's bar.
(b) The fleet runner at N = 2 against JAX's ``make_batched_guided_runner``
    on a tiny UNet over 4 steps, each lane with its own key: rtol 1e-3 / atol 1e-4, the
    repo's guided-chain bar (a UNet's float32 summation order differs).
(c) Fleet lane j against the port's own batch-1 chain of image j, with
    avrg_loss and val_loss on (the case a joint loss over the batch gets
    wrong): rtol 1e-5 / atol 1e-6, float32 reductions over one image in
    another grouping. At B > 1 the loop's default stays JAX's joint loss.
(d) Segmented chains equal the single call bit for bit.
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
from osmosis_tpu_torch.parallel.runner import (
    lane,
    make_batched_guided_runner,
    make_batched_segment_runner,
)
from tests.test_torch_guided import AUX, COND_PARAMS, HW, OP_KW, PATTERN, _fake_model_jax
from tests.test_torch_guided import _fake_model_torch
from tests.test_torch_guided_modes import _assert_same, _noise_fn

STEPS = 8
OP = "underwater_physical_revised"
# scale low enough that the tiny UNet's chains stay in range (test_guided_loop.py)
LOW_SCALE = dict(COND_PARAMS, scale="2,2,2,0.5")


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed, n=1, hw=HW):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, hw, hw, 4)).astype(np.float32)
    y = rng.uniform(-1, 1, (n, hw, hw, 3)).astype(np.float32)
    return x, y


def _jax_fake(x, y, key, params=COND_PARAMS, pattern=PATTERN, sampler="ddpm", **kw):
    return jax_guided_sample_loop(
        _fake_model_jax, jax_make_schedule("linear", 1000, str(STEPS)), jnp.asarray(x),
        jnp.asarray(y), key, jax_get_operator(OP, batch_size=1, **OP_KW),
        JaxGuidanceConfig.from_config("osmosis", params, pattern, AUX),
        JaxSamplerConfig(sampler=sampler, clip_denoised=True), sample_pattern=pattern,
        record_every=2, **kw)


def _port_fake(x, y, params=COND_PARAMS, pattern=PATTERN, sampler="ddpm", **kw):
    return guided_sample_loop(
        _fake_model_torch, make_schedule("linear", 1000, str(STEPS)), torch.as_tensor(x),
        torch.as_tensor(y), get_operator(OP, batch_size=1, **OP_KW),
        GuidanceConfig.from_config("osmosis", params, pattern, AUX),
        SamplerConfig(sampler=sampler, clip_denoised=True), sample_pattern=pattern,
        record_every=2, **kw)


@pytest.mark.parametrize("eta_scale", [0.5, 0.0])
def test_eta_scale_matches_jax(eta_scale):
    x, y = _inputs(0)
    pattern = dict(PATTERN, update_start=1.0)
    key = jax.random.key(1)
    jres = _jax_fake(x, y, key, pattern=pattern, eta_scale=jnp.float32(eta_scale))
    res = _port_fake(x, y, pattern=pattern, eta_scale=eta_scale, noise_fn=_noise_fn(key))
    _assert_same(res, jres, 1e-4, 1e-5, STEPS)
    if eta_scale == 0.0:  # 0 freezes phi at its init
        init = get_operator(OP, batch_size=1, **OP_KW).phi_init()
        for k, v in res.phi_trace.items():
            assert torch.equal(v, torch.from_numpy(init[k]).expand_as(v))


@pytest.mark.parametrize("case", [
    dict(),
    dict(params=dict(LOW_SCALE, x_prev_every=2)),
    dict(sampler="ltsp"),
])
def test_segments_match_jax_segments(case):
    """Two segments (6 + 2 steps, aligned to the hybrid width) against the
    JAX loop's own. Both second segments start from the JAX first segment's
    state (x_t, phi, optimizer state, snapshots, eps history): an 8-step
    ltsp chain alone amplifies float32 ordering to 2.4e-5 at values near
    1e-3 by its last step (ROADMAP queue 3), which is the harness, not the
    segment."""
    x, y = _inputs(2)
    params, sampler = case.get("params", COND_PARAMS), case.get("sampler", "ddpm")
    key = jax.random.key(3)
    ts = np.arange(STEPS - 1, -1, -1)
    kw = dict(params=params, sampler=sampler)
    j1 = _jax_fake(x, y, key, ts=jnp.asarray(ts[:6]), **kw)
    p1 = _port_fake(x, y, ts=ts[:6], noise_fn=_noise_fn(key), **kw)
    _assert_same(p1, j1, 1e-4, 1e-5, STEPS)
    j2 = _jax_fake(j1.sample, y, key, ts=jnp.asarray(ts[6:]), phi_init=j1.phi,
                   opt_state_init=j1.opt_state, x0_buf_init=j1.x0_snapshots,
                   eps_hist_init=j1.eps_hist, **kw)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    p2 = _port_fake(t(j1.sample), y, ts=ts[6:], noise_fn=_noise_fn(key),
                    phi_init={k: t(v) for k, v in j1.phi.items()}, opt_state_init={},
                    x0_buf_init=t(j1.x0_snapshots),
                    eps_hist_init=None if j1.eps_hist is None else tuple(map(t, j1.eps_hist)),
                    **kw)
    assert p2.sep_loss.shape[0] == 2
    _assert_same(p2, j2, 1e-4, 1e-5, STEPS)


@pytest.mark.parametrize("case", [
    dict(),
    dict(params=dict(COND_PARAMS, x_prev_every=4)),
    dict(sampler="ltsp"),
    dict(pattern=dict(PATTERN, local_M=2, s_start=0.5, s_end=0.1)),
])
def test_segmented_chain_equals_one_call_bitwise(case):
    x, y = _inputs(4)
    kw = dict(params=case.get("params", COND_PARAMS), pattern=case.get("pattern", PATTERN),
              sampler=case.get("sampler", "ddpm"), seed=11, eta_scale=0.5)
    whole = _port_fake(x, y, **kw)
    ts = np.arange(STEPS - 1, -1, -1)
    res, pieces = None, []
    for seg in (ts[:4], ts[4:]):
        res = _port_fake(x if res is None else res.sample, y, ts=seg, **kw, **(
            {} if res is None else dict(phi_init=res.phi, opt_state_init=res.opt_state,
                                        x0_buf_init=res.x0_snapshots,
                                        eps_hist_init=res.eps_hist)))
        pieces.append(res)
    for name in ("sample", "pred_xstart", "x0_snapshots"):
        assert torch.equal(getattr(res, name), getattr(whole, name)), name
    assert torch.equal(torch.cat([p.sep_loss for p in pieces]), whole.sep_loss)
    for k in whole.phi:
        assert torch.equal(res.phi[k], whole.phi[k])
        assert torch.equal(torch.cat([p.phi_trace[k] for p in pieces]), whole.phi_trace[k])


def test_joint_loss_stays_the_default_at_batch_two():
    """At B > 1 the loop without ``lane_separable`` keeps the JAX loop's
    joint loss (one norm over the batch)."""
    x, y = _inputs(5, n=2)
    key = jax.random.key(6)
    jres = _jax_fake(x, y, key)
    res = _port_fake(x, y, noise_fn=_noise_fn(key))
    _assert_same(res, jres, 1e-4, 1e-5, STEPS)


def _tiny_models():
    from osmosis_tpu.models import UNetConfig as JaxUNetConfig
    from osmosis_tpu.models import UNetModel as JaxUNet
    from osmosis_tpu_torch.models.convert import state_dict_from_jax
    from osmosis_tpu_torch.models.unet import UNetConfig, UNetModel
    from tests.test_torch_unet import TINY_KW

    jmodel = JaxUNet(JaxUNetConfig(**TINY_KW))
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)))
    prng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) if np.asarray(a).any()
        else (0.02 * prng.standard_normal(np.shape(a))).astype(np.float32), params)
    cfg = UNetConfig(**TINY_KW)
    tmodel = UNetModel(cfg)
    tmodel.load_state_dict(state_dict_from_jax(params, cfg))
    tmodel.requires_grad_(False).to(memory_format=torch.channels_last)
    return jmodel, params, tmodel


def _stacked_noise(keys):
    """Per-lane JAX draws stacked into one [N, ...] draw for the port."""
    def noise_fn(t, shape, i=0):
        one = (1,) + tuple(shape[1:])
        return torch.cat([torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(jax.random.fold_in(k, t), i), one, jnp.float32))) for k in keys])

    return noise_fn


def test_fleet_runner_matches_jax_runner_on_a_tiny_unet():
    from osmosis_tpu.parallel.runner import make_batched_guided_runner as jax_runner

    jmodel, params, tmodel = _tiny_models()
    n, steps = 2, 4
    xs, ys = _inputs(8, n=n, hw=32)
    keys = jax.random.split(jax.random.key(9), n)
    pattern = dict(PATTERN, n_iter=2)
    jgcfg = JaxGuidanceConfig.from_config("osmosis", LOW_SCALE, pattern, AUX)
    jop = jax_get_operator(OP, batch_size=1, **OP_KW)
    jsch = jax_make_schedule("linear", 1000, str(steps))
    jrun = jax_runner(jmodel.apply, jsch, jop, jgcfg, JaxSamplerConfig(), sample_pattern=pattern,
                      record_every=2)
    first = jrun(params, jnp.asarray(xs), jnp.asarray(ys), keys)
    # the global_opt_reset path: a warm phi with cold optimizer state
    second = jrun(params, jnp.asarray(xs), jnp.asarray(ys), keys, phi0s=first.phi, opt0s=None)

    run = make_batched_guided_runner(
        tmodel, make_schedule("linear", 1000, str(steps)), get_operator(OP, batch_size=1, **OP_KW),
        GuidanceConfig.from_config("osmosis", LOW_SCALE, pattern, AUX), SamplerConfig(),
        sample_pattern=pattern, record_every=2)
    noise = _stacked_noise(keys)
    tfirst = run(torch.from_numpy(xs), torch.from_numpy(ys), noise_fn=noise)
    tsecond = run(torch.from_numpy(xs), torch.from_numpy(ys), phi0s=tfirst.phi, opt0s=None,
                  noise_fn=noise)
    assert tfirst.sample.shape == (n, 32, 32, 4) and tfirst.sep_loss.shape == (steps, n)
    for tres, jres in ((tfirst, first), (tsecond, second)):
        for j in range(n):
            _assert_same(lane(tres, j), jax.tree_util.tree_map(lambda a: a[j], jres),
                         1e-3, 1e-4, steps)


@pytest.mark.parametrize("case", [
    dict(params=COND_PARAMS),
    dict(params=dict(COND_PARAMS, loss_function="mse", x_prev_every=2)),
    dict(params=dict(COND_PARAMS, gradient_x_prev=False), sampler="ltsp"),
])
def test_each_fleet_lane_is_its_batch_one_chain(case):
    n = 3
    xs, ys = _inputs(12, n=n)
    # one x_start for every lane, as the pipeline draws it
    xs = np.broadcast_to(xs[:1], xs.shape).copy()
    pattern = dict(PATTERN, update_start=1.0)
    gcfg = GuidanceConfig.from_config("osmosis", case["params"], pattern, AUX)
    scfg = SamplerConfig(sampler=case.get("sampler", "ddpm"), clip_denoised=True)
    sch = make_schedule("linear", 1000, str(STEPS))
    op = get_operator(OP, batch_size=1, **OP_KW)
    kw = dict(sample_pattern=pattern, record_every=2)
    run = make_batched_guided_runner(_fake_model_torch, sch, op, gcfg, scfg, **kw)
    fleet = run(torch.from_numpy(xs), torch.from_numpy(ys), seed=21, eta_scale=0.5)
    segs = make_batched_segment_runner(_fake_model_torch, sch, op, gcfg, scfg, **kw)
    ts = np.arange(STEPS - 1, -1, -1)
    part = segs(torch.from_numpy(xs), torch.from_numpy(ys), 21, None, None, 0.5, ts[:4])
    part = segs(part.sample, torch.from_numpy(ys), 21, part.phi, part.opt_state, 0.5, ts[4:],
                part.x0_snapshots, part.eps_hist)
    assert torch.equal(part.sample, fleet.sample)
    for j in range(n):
        single = guided_sample_loop(
            _fake_model_torch, sch, torch.from_numpy(xs[j:j + 1]),
            torch.from_numpy(ys[j:j + 1]), op, gcfg, scfg, seed=21, eta_scale=0.5, **kw)
        _assert_same(lane(fleet, j), single, 1e-5, 1e-6, STEPS)
        assert lane(fleet, j).aux_trace["val_loss"].shape == (STEPS,)


def test_lanes_of_the_rgb_guidance_chain_are_their_batch_one_chains():
    """'ps' (rgb_guidance) in the fleet: each lane's DPS loss and gradient."""
    n = 2
    rng = np.random.default_rng(14)
    x = np.broadcast_to(rng.standard_normal((1, HW, HW, 4)), (n, HW, HW, 4)).astype(np.float32)
    for noiser, c in (("gaussian", 3), ("poisson", 4)):
        ys = rng.uniform(0.2, 1, (n, HW, HW, c)).astype(np.float32)
        gcfg = GuidanceConfig.from_config("ps", dict(scale="0.3", gradient_x_prev=True),
                                          PATTERN, None, noiser_name=noiser)
        sch, scfg = make_schedule("linear", 1000, str(STEPS)), SamplerConfig(clip_denoised=True)
        op = get_operator("rgb_guidance")
        fleet = make_batched_guided_runner(_fake_model_torch, sch, op, gcfg, scfg,
                                           sample_pattern=PATTERN, record_every=2)(
            torch.from_numpy(x), torch.from_numpy(ys), seed=3)
        for j in range(n):
            single = guided_sample_loop(_fake_model_torch, sch, torch.from_numpy(x[j:j + 1]),
                                        torch.from_numpy(ys[j:j + 1]), op, gcfg, scfg,
                                        sample_pattern=PATTERN, record_every=2, seed=3)
            _assert_same(lane(fleet, j), single, 1e-5, 1e-6, STEPS)
