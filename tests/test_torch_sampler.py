"""The port's schedule and sampler arithmetic against ``osmosis_tpu``, fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osmosis_tpu.diffusion import sampler as J
from osmosis_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from osmosis_tpu_torch.diffusion import sampler as S
from osmosis_tpu_torch.diffusion.schedules import make_schedule

TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("respacing", ["", "50", "ddim20"])
def test_schedule_constants_equal_jax(respacing):
    ours = make_schedule("linear", 1000, respacing).device_constants()
    theirs = jax_make_schedule("linear", 1000, respacing).device_constants()
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    sch = make_schedule("linear", 1000, "50")
    consts_np = sch.device_constants()
    x = rng.standard_normal((2, 6, 6, 4)).astype(np.float32)
    out = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    t = np.array([3, 41], dtype=np.int32)
    jc = {k: jnp.asarray(v) for k, v in consts_np.items()}
    tc = S.device_constants(sch, "cpu")
    return x, out, t, jc, tc


@pytest.mark.parametrize("var_type", ["learned_range", "learned", "fixed_small", "fixed_large"])
@pytest.mark.parametrize("mean_type", ["epsilon", "start_x", "previous_x"])
def test_step_arithmetic_matches_jax(var_type, mean_type):
    x, out, t, jc, tc = _inputs()
    jcfg = J.SamplerConfig(model_mean_type=mean_type, model_var_type=var_type,
                           clip_denoised=True)
    tcfg = S.SamplerConfig(model_mean_type=mean_type, model_var_type=var_type,
                           clip_denoised=True)
    jeps, jv = J.split_model_output(jnp.asarray(out), 4)
    teps, tv = S.split_model_output(torch.from_numpy(out), 4)
    np.testing.assert_array_equal(teps.numpy(), np.asarray(jeps))
    jt, tt = jnp.asarray(t), torch.from_numpy(t).long()
    jx0 = J.process_xstart(J.predict_xstart(jnp.asarray(x), jt, jeps, jc, jcfg), jcfg)
    tx0 = S.process_xstart(S.predict_xstart(torch.from_numpy(x), tt, teps, tc, tcfg), tcfg)
    np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), **TOL)
    np.testing.assert_allclose(
        S.posterior_mean(tx0, torch.from_numpy(x), tt, tc).numpy(),
        np.asarray(J.posterior_mean(jx0, jnp.asarray(x), jt, jc)), **TOL)
    np.testing.assert_allclose(
        S.model_log_variance(tv, tt, tc, tcfg).numpy(),
        np.asarray(J.model_log_variance(jv, jt, jc, jcfg)), **TOL)


def test_dynamic_threshold_is_bug_compatible():
    x, _, _, _, _ = _inputs(1)
    jcfg = J.SamplerConfig(dynamic_threshold=True)
    tcfg = S.SamplerConfig(dynamic_threshold=True)
    np.testing.assert_allclose(
        S.process_xstart(torch.from_numpy(x), tcfg).numpy(),
        np.asarray(J.process_xstart(jnp.asarray(x), jcfg)), **TOL)


def test_snapshot_recording_matches_jax():
    steps = S.record_steps_for(50, 20, extra=(49, 999))
    assert steps == J.record_steps_for(50, 20, extra=(49, 999))
    slot = S.make_slot_map(50, steps)
    np.testing.assert_array_equal(slot, J.make_slot_map(50, steps))
    buf = torch.zeros(len(steps), 1, 2, 2, 4)
    v = torch.ones(1, 2, 2, 4)
    S.record_update(buf, v, int(slot[40]))
    S.record_update(buf, 2 * v, int(slot[49]))
    jbuf = jnp.zeros(buf.shape)
    jbuf = J.record_update(jbuf, jnp.ones((1, 2, 2, 4)), jnp.int32(slot[40]))
    jbuf = J.record_update(jbuf, 2 * jnp.ones((1, 2, 2, 4)), jnp.int32(slot[49]))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))


def test_registries_name_the_jax_packages_components():
    """Samplers, conditioning methods, noise models and operators register
    under the JAX package's names."""
    import osmosis_tpu.diffusion.guided  # noqa: F401  (registers the conditioners)
    import osmosis_tpu.guidance.noise  # noqa: F401
    import osmosis_tpu.guidance.operators  # noqa: F401
    import osmosis_tpu_torch.diffusion.guided  # noqa: F401
    import osmosis_tpu_torch.guidance.noise  # noqa: F401
    import osmosis_tpu_torch.guidance.operators  # noqa: F401
    from osmosis_tpu import registry as JR
    from osmosis_tpu_torch import registry as TR

    for name in ("SAMPLERS", "CONDITIONERS", "NOISES", "OPERATORS"):
        assert getattr(TR, name).names() == getattr(JR, name).names(), name
    assert TR.SAMPLERS.names() == ["ddim", "ddpm", "ltsp"]
