"""K5 (``ops/phi_fit``) on the CPU: the closed-form phi gradient that the
kernel computes, its launch geometry, and which path a guided chain takes.

(a) ``grads_plain``, the closed form in plain PyTorch, against
    ``torch.autograd.grad`` of the eager guidance loss (``loss_terms`` of
    ``diffusion/guided``, per image) for each physics operator, the norm and
    the mse, the depth weight and none, three-entry and one-entry phi: fp32
    autograd against fp64 sums, so rtol 1e-4 of the largest gradient.
(b) ``guided._k5_route``, the one place that picks K5 or the eager loop:
    the configurations K5 takes and those the eager loop keeps (the CPU,
    another optimizer or operator, a dp mesh, the joint norm over a batch,
    bf16 tensors).
(c) A guided chain counts ``guided.phi_fits`` at every step with phi-only
    iterations and ``guided.phi_fits_k5`` where K5 ran them: never on the
    CPU; with the route's device test lifted (``_k5_route`` as ``_k5_fit``)
    and the plain version standing in for the launch, at every such step of
    an SGD chain at batch 1, a fleet and a joint mse, whose phi trace then
    follows the eager one's, and at none of Adam's, RMSprop's or the joint
    norm's at batch 2.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from osmosis_tpu_torch.diffusion import guided as G
from osmosis_tpu_torch.diffusion.guided import GuidanceConfig, guided_sample_loop
from osmosis_tpu_torch.diffusion.sampler import SamplerConfig
from osmosis_tpu_torch.diffusion.schedules import make_schedule
from osmosis_tpu_torch.guidance.operators import get_operator
from osmosis_tpu_torch.guidance.schedule_masks import pattern_masks
from osmosis_tpu_torch.ops import phi_fit as K5
from osmosis_tpu_torch.utils import profiling
from tests.test_torch_guided import AUX, COND_PARAMS, OP_KW, PATTERN, _fake_model_torch

AB_KW = dict(optimizer="sgd", depth_type="gamma", value="1.4,1.4,1",
             phi_ab="0.9,0.7,0.6", phi_ab_eta=1e-4, phi_ab_learn_flag=True,
             phi_inf="0.14, 0.29, 0.49", phi_inf_eta=1e-4, phi_inf_learn_flag=True)
HAZE_KW = dict(optimizer="sgd", depth_type="original", phi_ab=0.8, phi_ab_eta=1e-4,
               phi_ab_learn_flag=True, phi_inf=0.6, phi_inf_eta=1e-4, phi_inf_learn_flag=True)
OPERATORS = {"underwater_physical_revised": OP_KW, "underwater_physical": AB_KW,
             "haze_physical": HAZE_KW}
STEPS = 8
CHAIN_PATTERN = dict(PATTERN, phi_warmup_iters=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _operator(name, batch=1, **kw):
    return get_operator(name, batch_size=batch, **dict(OPERATORS[name], **kw))


def _gcfg(loss="norm", weight="depth", **params):
    return GuidanceConfig.from_config(
        "osmosis", dict(COND_PARAMS, loss_function=loss, loss_weight=weight, **params),
        CHAIN_PATTERN, AUX)


def _data(b, hw=12, seed=0):
    g = torch.Generator().manual_seed(seed)
    x0 = torch.rand(b, hw, hw + 2, 4, generator=g) * 2 - 1
    y = torch.rand(b, hw, hw + 2, 3, generator=g) * 2 - 1
    return x0, y


def _phi(op, b, seed=1):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.as_tensor(v) * (1 + 0.1 * torch.rand(v.shape, generator=g))
            for k, v in op.phi_init().items()}


def _cpu_fit(op, phi, x0, y, gcfg, eta_scale=None, lane_separable=True, mesh=None):
    """The route's Fit without its device test: what K5 would run on the card."""
    return G._k5_fit(op, phi, x0, y, gcfg, eta_scale, lane_separable, mesh)


def _eager_loss(op, gcfg, x0, y, phi):
    """``loss_terms`` of ``guided_sample_loop`` with ``lane_separable``,
    without the aux losses (x0-hat alone: no phi gradient)."""
    degraded = 2.0 * op.forward(phi, x0) - 1.0
    diff = ((y - degraded) * G._make_weight_fn(gcfg)(x0)).float()
    if gcfg.loss_function == "norm":
        return torch.sqrt(torch.sum(diff ** 2, dim=(1, 2, 3))).sum()
    return torch.mean(diff ** 2, dim=(1, 2, 3)).sum()


@pytest.mark.parametrize("weight", ["depth", "none"])
@pytest.mark.parametrize("loss", ["norm", "mse"])
@pytest.mark.parametrize("name", list(OPERATORS))
def test_closed_form_gradient_matches_autograd(name, loss, weight):
    op, gcfg = _operator(name, batch=2), _gcfg(loss, weight)
    x0, y = _data(2)
    phi = _phi(op, 2)
    fit = _cpu_fit(op, phi, x0, y, gcfg)
    assert fit is not None and fit.shared == (name != "underwater_physical_revised")
    leaves = {k: v.clone().requires_grad_(True) for k, v in phi.items()}
    want = dict(zip(leaves, torch.autograd.grad(_eager_loss(op, gcfg, x0, y, leaves),
                                                list(leaves.values()))))
    got = K5.grads_plain(x0, y, phi, fit)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape == phi[k].shape, k
        scale = want[k].abs().max().item()
        assert scale > 0
        err = (got[k] - want[k]).abs().max().item()
        assert err <= 1e-4 * scale, (k, err, scale)


def test_geometry():
    assert K5.plan(256 * 256) == K5.Geometry(16, 4096, 4096)
    assert K5.plan(256 * 256, max_cluster=8) == K5.Geometry(8, 8192, 6400)
    assert K5.plan(32 * 32) == K5.Geometry(1, 1024, 1024)
    assert K5.plan(64 * 64 + 1) == K5.Geometry(3, 1366, 1366)
    for hw in (1, 100, 4097, 65536, 512 * 512):
        g = K5.plan(hw)
        assert g.cluster * g.px >= hw > (g.cluster - 1) * g.px
        assert g.cached * K5.FIELDS * 4 <= K5.SMEM_BYTES


def test_fit_for_takes_what_the_kernel_computes():
    op = _operator("underwater_physical_revised")
    x0, y = _data(1)
    phi = _phi(op, 1)
    gcfg = _gcfg()
    assert G._k5_route(op, phi, x0, y, gcfg, None, False, None) is None  # the CPU is not K5's
    fit = _cpu_fit(op, phi, x0, y, gcfg, eta_scale=0.5)
    assert fit.names == ("phi_a", "phi_b", "phi_inf")
    assert fit.etas == ((float(np.float32(1e-4)),) * 3,) * 3
    assert fit.depth == fit.weight == (1, 1.4, 1.4, 1.0)
    assert fit.eta_scale == 0.5 and not fit.mse
    assert _cpu_fit(op, phi, x0, y, _gcfg(weight="none")).weight == K5.ONE
    haze = _operator("haze_physical")
    fit = _cpu_fit(haze, _phi(haze, 1), x0, y, gcfg)
    assert fit.names == ("phi_ab", "phi_inf") and fit.depth == (0, 0.0, 0.0, 0.0)
    refused = {
        "adam": (_operator("underwater_physical_revised", optimizer="adam"), phi, x0, y),
        "rmsprop": (_operator("underwater_physical_revised", optimizer="rmsprop"), phi, x0, y),
        "noise": (get_operator("noise"), {}, x0, y),
        "bf16 x0-hat": (op, phi, x0.bfloat16(), y),
        "bf16 y": (op, phi, x0, y.bfloat16()),
        "two-entry phi": (op, dict(phi, phi_a=phi["phi_a"][:, :2]), x0, y),
    }
    for what, (o, p, xx, yy) in refused.items():
        assert _cpu_fit(o, p, xx, yy, gcfg) is None, what
    cube = _operator("underwater_physical_revised", depth_type="cube")
    assert _cpu_fit(cube, phi, x0, y, gcfg) is None


def test_per_image_loss():
    """The route takes a loss whose phi gradient is each image's own: one
    image, ``lane_separable``, or the mse; never the joint norm over a batch,
    nor a loss reduced over a dp group."""
    op = _operator("underwater_physical_revised", batch=4)
    norm, mse = _gcfg("norm"), _gcfg("mse")
    x1, y1 = _data(1)
    x4, y4 = _data(4)
    phi1, phi4 = _phi(op, 1), _phi(op, 4)
    takes = lambda gcfg, b, sep, mesh: _cpu_fit(  # noqa: E731
        op, *((phi1, x1, y1) if b == 1 else (phi4, x4, y4)), gcfg, None, sep, mesh) is not None
    assert takes(norm, 1, False, None)
    assert takes(norm, 4, True, None)
    assert takes(mse, 4, False, None)
    assert not takes(norm, 4, False, None)  # the joint norm couples the images
    one, two = SimpleNamespace(dp=1), SimpleNamespace(dp=2)
    assert takes(norm, 1, False, one)
    for gcfg, b, sep in ((norm, 1, False), (norm, 4, True), (mse, 4, False)):
        assert not takes(gcfg, b, sep, two)  # reduced over the dp group


def test_the_wrapper_rejects_what_the_kernel_does_not_take():
    op = _operator("underwater_physical_revised")
    x0, y = _data(1)
    phi = _phi(op, 1)
    fit = K5.Fit(("phi_a", "phi_b", "phi_inf"), ((1e-4,) * 3,) * 3, (1, 1.4, 1.4, 1.0),
                 K5.ONE, False, None)
    with pytest.raises(TypeError):
        K5.phi_fit(x0.bfloat16(), y, phi, fit, 2)
    with pytest.raises(ValueError):
        K5.phi_fit(x0.transpose(1, 2), y.transpose(1, 2), phi, fit, 2)
    with pytest.raises(ValueError):
        K5.phi_fit(x0[..., :3], y, phi, fit, 2)
    with pytest.raises(ValueError):
        K5.phi_fit(x0, y, phi, fit, 0)
    with pytest.raises(RuntimeError):  # the kernel runs on the card alone
        K5.phi_fit(x0, y, phi, fit, 2)


def _chain(op, gcfg, b=1, lane_separable=False, eta_scale=None):
    x0, y = _data(b, hw=8, seed=4)
    return guided_sample_loop(
        _fake_model_torch, make_schedule("linear", 1000, str(STEPS)), x0, y, op, gcfg,
        SamplerConfig(clip_denoised=True), sample_pattern=CHAIN_PATTERN, deterministic=True,
        lane_separable=lane_separable, eta_scale=eta_scale)


def _counted(fn):
    before = profiling.counters()
    res = fn()
    after = profiling.counters()
    return res, {k: after[k] - before[k] for k in ("guided.phi_fits", "guided.phi_fits_k5",
                                                   "phi_fit.launches")}


# (operator, its overrides, loss, batch, lane_separable, eta_scale, K5 runs)
CHAINS = {
    "sgd": ("underwater_physical_revised", {}, "norm", 1, False, None, True),
    "sgd_scaled": ("underwater_physical_revised", {}, "norm", 1, False, 0.5, True),
    "haze": ("haze_physical", {}, "norm", 1, False, None, True),
    "fleet": ("underwater_physical", {}, "norm", 2, True, None, True),
    "joint_mse": ("underwater_physical_revised", {}, "mse", 2, False, None, True),
    "adam": ("underwater_physical_revised", dict(optimizer="adam"), "norm", 1, False, None,
             False),
    "rmsprop": ("underwater_physical_revised", dict(optimizer="rmsprop"), "norm", 1, False, None,
                False),
    "joint_norm": ("underwater_physical_revised", {}, "norm", 2, False, None, False),
}


@pytest.mark.parametrize("case", list(CHAINS))
def test_a_chain_counts_its_phi_fits_and_takes_k5_where_it_may(monkeypatch, case):
    name, kw, loss, b, sep, eta_scale, k5 = CHAINS[case]
    op, gcfg = _operator(name, batch=b, **kw), _gcfg(loss)
    masks = pattern_masks(CHAIN_PATTERN, STEPS)
    fits = sum(int(masks["phi_warmup"][t]) + (0 if masks["freeze_phi"][t] else gcfg.n_iter - 1)
               > 0 for t in range(STEPS))
    eager, counts = _counted(lambda: _chain(op, gcfg, b, sep, eta_scale))
    assert counts == {"guided.phi_fits": fits, "guided.phi_fits_k5": 0, "phi_fit.launches": 0}
    monkeypatch.setattr(G, "_k5_route", G._k5_fit)
    monkeypatch.setattr(K5, "phi_fit", K5.phi_fit_plain)
    res, counts = _counted(lambda: _chain(op, gcfg, b, sep, eta_scale))
    assert counts["guided.phi_fits"] == fits
    assert counts["guided.phi_fits_k5"] == (fits if k5 else 0)
    assert counts["phi_fit.launches"] == 0  # the plain version stood in for the launch
    for k in eager.phi:
        start = torch.as_tensor(op.phi_init()[k])
        step = (eager.phi_trace[k] - start).abs().max().item()
        assert step > 0, k
        err = (res.phi_trace[k] - eager.phi_trace[k]).abs().max().item()
        if k5:
            assert err <= 1e-4 * step, (k, err, step)
        else:
            assert err == 0, k
