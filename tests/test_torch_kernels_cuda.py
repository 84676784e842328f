"""The port's hand-written kernels (K1-K5) against their plain versions, on a
CUDA card. Every test here needs the card (marker ``cuda``) and skips without
one. On the machine with the card, where JAX is absent, run:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances: K1/K2 exact (a copy, or an fp32 sum in the plain version's order);
K3/K4 fp32 1e-4 relative to the largest value (order of summation), bf16 3e-2.
K3/K4 run in both their geometries (``MAX_CLUSTER = 0`` forces the two-launch
one) and must give the same bits on a second call. K5 (the phi fit) against
the eager autograd loop it replaces: phi within 1e-5 of the largest step that
loop took, or one fp32 spacing of phi (the gradient's sums in another order
and precision can turn an update's last rounding), the same bits on a second
call.
"""

import pytest
import torch

from osmosis_tpu_torch.ops import group_norm as G
from osmosis_tpu_torch.ops import upsample as U
from osmosis_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _close(a, b, rtol):
    err = (a.float() - b.float()).abs().max().item()
    return err <= rtol * max(1.0, b.float().abs().max().item()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 8, 8, 1024), (1, 128, 128, 256), (2, 6, 10, 64)])
def test_resample_kernels_are_exact(cuda, dtype, shape):
    x = torch.randn(shape, device=cuda).to(dtype)
    c = profiling.counters()
    n1, n2 = c["upsample_nearest_2x.launches"], c["box_sum_2x.launches"]
    for scale in (1.0, 0.25):
        assert torch.equal(U.upsample_nearest_2x_kernel(x, scale),
                           U.upsample_nearest_2x_plain(x, scale))
        assert torch.equal(U.box_sum_2x_kernel(x, scale), U.box_sum_2x_plain(x, scale))
    torch.cuda.synchronize()
    c = profiling.counters()
    assert c["upsample_nearest_2x.launches"] == n1 + 2
    assert c["box_sum_2x.launches"] == n2 + 2


def test_resample_kernels_reject_what_they_do_not_take(cuda):
    with pytest.raises(ValueError):
        U.upsample_nearest_2x_kernel(torch.randn(1, 4, 4, 6, device=cuda))  # 24 bytes a pixel
    with pytest.raises(ValueError):
        U.box_sum_2x_kernel(torch.randn(1, 4, 8, 4, device=cuda).transpose(1, 2))
    with pytest.raises(TypeError):
        U.upsample_nearest_2x_kernel(torch.randn(1, 4, 4, 8, device=cuda).half())


def _gn_inputs(dev, dtype, b, c, h, w, mode, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (1.5 * torch.randn(b, c, h, w, device=dev, generator=g) + 0.3).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    wt = 1 + 0.1 * torch.randn(c, device=dev, generator=g)
    bias = 0.1 * torch.randn(c, device=dev, generator=g)
    fs = ft = None
    if mode == "film":
        fs = (0.2 * torch.randn(b, c, device=dev, generator=g)).to(dtype)
        ft = (0.2 * torch.randn(b, c, device=dev, generator=g)).to(dtype)
    gy = torch.randn(b, c, h, w, device=dev, generator=g).to(dtype)
    return x, wt, bias, fs, ft, mode != "none", gy.contiguous(memory_format=torch.channels_last)


# every group width of the main path (C = 32 x 8 ... 32 x 64), and 3 channels
# a group (C = 96), at a ragged HW, B = 2, in both geometries
@pytest.mark.parametrize("geometry", ["resident", "split"])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("c,h,w", [(256, 12, 10), (512, 9, 7), (768, 8, 8), (1024, 6, 5),
                                   (1536, 4, 4), (2048, 3, 5), (96, 5, 5)])
@pytest.mark.parametrize("mode", ["none", "silu", "film"])
def test_group_norm_kernels_match_plain(cuda, monkeypatch, geometry, dtype, rtol, c, h, w,
                                        mode):
    if geometry == "split":
        monkeypatch.setattr(G, "MAX_CLUSTER", 0)
    x, wt, bias, fs, ft, silu, gy = _gn_inputs(cuda, dtype, 2, c, h, w, mode, c + h)
    c = profiling.counters()
    k0 = (c["group_norm_forward.kernel_launches"], c["group_norm_backward.kernel_launches"])
    y, m, i = G.group_norm_forward(x, wt, bias, fs, ft, silu)
    got = G.group_norm_backward(gy, x, wt, bias, fs, ft, silu, m, i)
    per_call = 1 if geometry == "resident" else 2
    c = profiling.counters()
    assert c["group_norm_forward.kernel_launches"] == k0[0] + per_call
    assert c["group_norm_backward.kernel_launches"] == k0[1] + per_call
    yp, mp, ip = G.group_norm_forward_plain(x, wt, bias, fs, ft, silu)
    ref = G.group_norm_backward_plain(gy, x, wt, bias, fs, ft, silu, mp, ip)
    torch.cuda.synchronize()
    for name, a, r in [("y", y, yp), ("mean", m, mp), ("inv", i, ip)] + [
            (n, a, r) for n, a, r in zip(("dx", "dw", "db", "ds", "dt"), got, ref)
            if a is not None or r is not None]:
        ok, err = _close(a, r, rtol if name not in ("mean", "inv") else 1e-4)
        assert ok, f"{name}: max abs err {err}"
    # a second call gives the same bits, and so does the x-only backward
    y2, m2, i2 = G.group_norm_forward(x, wt, bias, fs, ft, silu)
    again = G.group_norm_backward(gy, x, wt, bias, fs, ft, silu, m, i)
    dx_only = G.group_norm_backward(gy, x, wt, bias, fs, ft, silu, m, i, param_grads=False)
    assert dx_only[1:] == (None, None, None, None)
    assert torch.equal(y, y2) and torch.equal(m, m2) and torch.equal(i, i2)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(dx_only[0], got[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_cluster,tile_budget", [(8, None), (16, 200 * 1024)])
def test_group_norm_at_main_path_widths(cuda, monkeypatch, dtype, max_cluster, tile_budget):
    """128x128 and C=768 (24 channels a group) as the main path plans them,
    and with clusters of 16 and tiles up to 196 KB, which the kernels take
    but the plan does not choose by default."""
    monkeypatch.setattr(G, "MAX_CLUSTER", max_cluster)
    if tile_budget is not None:
        monkeypatch.setattr(G, "TILE_BUDGET", tile_budget)
    G._device_plan.cache_clear()
    try:
        x, wt, bias, fs, ft, silu, gy = _gn_inputs(cuda, dtype, 1, 768, 128, 128, "silu", 7)
        y, m, i = G.group_norm_forward(x, wt, bias, fs, ft, silu)
        dx = G.group_norm_backward(gy, x, wt, bias, fs, ft, silu, m, i, param_grads=False)[0]
        yp, mp, ip = G.group_norm_forward_plain(x, wt, bias, fs, ft, silu)
        dxp = G.group_norm_backward_plain(gy, x, wt, bias, fs, ft, silu, mp, ip)[0]
        torch.cuda.synchronize()
    finally:
        G._device_plan.cache_clear()
    rtol = 1e-4 if dtype == torch.float32 else 3e-2
    for a, r in ((y, yp), (dx, dxp)):
        ok, err = _close(a, r, rtol)
        assert ok, err


def test_group_norm_rejects_what_it_does_not_take(cuda):
    x, wt, bias, _, _, _, gy = _gn_inputs(cuda, torch.float32, 1, 64, 4, 4, "none", 0)
    with pytest.raises(ValueError, match="channels_last"):
        G.group_norm_forward(x.contiguous(), wt, bias)
    y, m, i = G.group_norm_forward(x, wt, bias)
    with pytest.raises(ValueError, match="channels_last"):
        G.group_norm_backward(gy.contiguous(), x, wt, bias, None, None, False, m, i)
    with pytest.raises(TypeError):
        G.group_norm_forward(x.half(), wt, bias)


def test_autograd_through_the_kernels_matches_the_cpu(cuda):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 64, 16, 16, generator=g).contiguous(memory_format=torch.channels_last)
    w, b = 1 + 0.1 * torch.randn(64, generator=g), 0.1 * torch.randn(64, generator=g)
    s, t = 0.1 * torch.randn(1, 64, generator=g), 0.1 * torch.randn(1, 64, generator=g)
    gy = torch.randn(1, 64, 8, 8, generator=g)
    outs = []
    for dev in ("cpu", cuda):
        xd = x.to(dev).requires_grad_(True)
        h = G.group_norm_act(xd, w.to(dev), b.to(dev), film=(s.to(dev), t.to(dev)), act="silu")
        h = U.upsample_nearest_2x(h.permute(0, 2, 3, 1))
        h = U.avg_pool_2x(U.avg_pool_2x(h)).permute(0, 3, 1, 2)
        (dx,) = torch.autograd.grad(h, xd, gy.to(dev))
        outs.append((h.detach().cpu(), dx.cpu()))
    assert torch.allclose(outs[0][0], outs[1][0], rtol=1e-4, atol=1e-5)
    assert torch.allclose(outs[0][1], outs[1][1], rtol=1e-4, atol=1e-5)


def _plain_on_the_card(monkeypatch):
    """Route the autograd Functions of K1-K4 to the plain versions, on
    whatever device their tensors are."""
    monkeypatch.setattr(U, "upsample_nearest_2x_kernel", U.upsample_nearest_2x_plain)
    monkeypatch.setattr(U, "box_sum_2x_kernel", U.box_sum_2x_plain)
    monkeypatch.setattr(G, "group_norm_forward", G.group_norm_forward_plain)
    monkeypatch.setattr(G, "group_norm_backward",
                        lambda *a, param_grads=True: G.group_norm_backward_plain(*a))


def test_bf16_tiny_unet_through_the_kernels_matches_the_plain_versions(cuda, monkeypatch):
    """The bf16 torso's forward and x-VJP on the card, through K1-K4 and through
    their plain versions (also on the card): the same bars as the bf16 torso
    against JAX (tests/test_torch_bf16.py), max 3e-2 and mean 5e-3 of the
    output's largest magnitude. The kernels round the bf16 epilogue where the
    plain versions do; what is left is the order of the fp32 sums behind the
    statistics, which moves a bf16 rounding here and there."""
    from osmosis_tpu_torch.models.convert import cast_params_half, init_unet
    from osmosis_tpu_torch.models.unet import UNetConfig

    cfg = UNetConfig(image_size=32, model_channels=64, num_res_blocks=1,
                     attention_resolutions=(4,), channel_mult=(1, 2, 2), num_heads=4,
                     num_head_channels=16, dtype=torch.bfloat16)
    model = init_unet(cfg, seed=1)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():  # the zero-initialized output convs carry signal too
        for p in model.parameters():
            if not p.any():
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
    model = cast_params_half(model).requires_grad_(False).to(
        device=cuda, memory_format=torch.channels_last)
    x = torch.randn(2, 32, 32, 4, generator=gen).to(cuda)
    t = torch.tensor([17.0, 433.0], device=cuda)
    g = torch.randn(2, 32, 32, 8, generator=gen).to(cuda)

    def run():
        xd = x.clone().requires_grad_(True)
        y = model(xd, t)
        (dx,) = torch.autograd.grad(y, xd, g)
        return y.detach(), dx

    c = profiling.counters()
    counts = (c["upsample_nearest_2x.launches"], c["group_norm_backward.launches"])
    got = run()
    c = profiling.counters()
    assert c["upsample_nearest_2x.launches"] > counts[0]
    assert c["group_norm_backward.launches"] > counts[1]
    with monkeypatch.context() as m:
        _plain_on_the_card(m)
        ref = run()
    for what, a, r in (("forward", got[0], ref[0]), ("x-VJP", got[1], ref[1])):
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), what
        scale = r.abs().max().item()
        err = (a - r).abs()
        print(f"bf16 tiny UNet, {what}: max err {err.max().item():.4g} (bar "
              f"{3e-2 * scale:.4g}), mean {err.mean().item():.3g} (bar {5e-3 * scale:.3g})")
        assert err.max().item() <= 3e-2 * scale, f"{what}: max err {err.max().item()}"
        assert err.mean().item() <= 5e-3 * scale, f"{what}: mean err {err.mean().item()}"


def test_tiny_train_step_through_the_kernels_matches_the_cpu(cuda):
    """One toy-prior train step (loss and every weight gradient, K4 with its
    parameter sums) on the card against the same step on the CPU (plain
    versions), TF32 off. Bars: the loss within 1e-4 relative; each gradient
    within 1e-3 of its leaf's largest magnitude plus 1e-5 of the largest
    gradient anywhere (convolutions and sums in another order)."""
    from osmosis_tpu_torch.models.convert import init_unet
    from osmosis_tpu_torch.tools import train_toy_prior as P

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = P.toy_unet_config(32, 64, "toy")
    model = init_unet(cfg, seed=1)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():  # the zero-initialized output convs carry signal too
        for p in model.parameters():
            if not p.any():
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
    batch = P.draw_batch(gen, P.build_parser().parse_args(["--batch", "4", "--size", "32"]),
                         "cpu")
    from osmosis_tpu_torch.diffusion.schedules import make_schedule

    consts = make_schedule("linear", 1000).device_constants()
    out = {}
    k4 = profiling.counters()["group_norm_backward.launches"]
    for dev in ("cpu", cuda):
        m = init_unet(cfg, seed=1)
        m.load_state_dict(model.state_dict())
        m = m.to(device=dev, memory_format=torch.channels_last)
        loss = P.diffusion_loss(m, P.Batch(*(v.to(dev) for v in batch)),
                                torch.as_tensor(consts["sqrt_alphas_cumprod"], device=dev),
                                torch.as_tensor(consts["sqrt_one_minus_alphas_cumprod"],
                                                device=dev))
        loss.backward()
        out[str(dev)] = (loss.item(), {n: p.grad.cpu() for n, p in m.named_parameters()})
    assert profiling.counters()["group_norm_backward.launches"] > k4
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out[str(cuda)]
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    top = max(g.abs().max().item() for g in g_cpu.values())
    for n, g in g_cpu.items():
        err = (g_gpu[n] - g).abs().max().item()
        assert err <= 1e-3 * g.abs().max().item() + 1e-5 * top, (n, err)


# ---------------------------------------------------------------------------
# K5: the phi-only fit of a guided step (ops/phi_fit)
# ---------------------------------------------------------------------------

K5_ETA = 5e-5  # the hybrid preset's learning rate
K5_OPERATORS = {
    "underwater_physical_revised": dict(
        depth_type="gamma", value="1.4,1.4,1", phi_a="1.1,0.95,0.95", phi_b="0.95,0.8,0.8",
        phi_inf="0.14,0.29,0.49"),
    "underwater_physical": dict(depth_type="original", phi_ab="1.1,0.95,0.95",
                                phi_inf="0.2,0.4,0.7"),
    "haze_physical": dict(depth_type="gamma", value="1.4,1.4,1", phi_ab=1.0,
                          phi_inf="0.14,0.29,0.49"),
}


def _k5_operator(name, batch):
    from osmosis_tpu_torch.guidance.operators import get_operator

    kw = dict(K5_OPERATORS[name], optimizer="sgd")
    for k in [k for k in kw if k.startswith("phi_")]:
        kw[f"{k}_eta"], kw[f"{k}_learn_flag"] = K5_ETA, True
    return get_operator(name, batch_size=batch, **kw)


def _k5_gcfg(loss, weight, n_iter=20, warm=0):
    from osmosis_tpu_torch.diffusion.guided import GuidanceConfig

    params = dict(loss_function=loss, loss_weight=weight, weight_function="gamma,1.4,1.4,1",
                  scale="0.3", gradient_x_prev=False)
    pattern = dict(pattern="pcgs", update_start=0.7, update_end=0, global_N=1, local_M=1,
                   s_start=1, s_end=0, n_iter=n_iter, start_guidance=1, stop_guidance=0,
                   phi_warmup_iters=warm)
    return GuidanceConfig.from_config("osmosis", params, pattern, None), pattern


def _k5_data(dev, b, hw=256, seed=0, w=None):
    """x0-hat in [-1, 1] with a smooth depth channel, and y a degraded copy
    plus noise, so that phi has somewhere to go."""
    w = hw if w is None else w
    g = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.rand(b, hw, w, 4, device=dev, generator=g) * 2 - 1
    ramp = torch.linspace(-1, 1, hw, device=dev)
    x0[..., 3] = 0.7 * ramp[None, :, None] + 0.2 * x0[..., 3]
    y = 0.6 * x0[..., :3] + 0.1 * torch.randn(b, hw, w, 3, device=dev, generator=g) - 0.2
    return x0.contiguous(), y.clamp(-1, 1).contiguous()


def _eager_phi_fit(op, gcfg, x0, y, phi, n, eta_scale):
    """The eager loop K5 replaces (``osmosis_guided``'s phi-only iterations):
    ``torch.autograd.grad`` of the per-image guidance loss, then the SGD
    update (scaled as ``guided_sample_loop`` scales it)."""
    from osmosis_tpu_torch.diffusion.guided import _make_weight_fn
    from osmosis_tpu_torch.guidance.phi_optim import make_phi_optimizer

    opt = make_phi_optimizer(op.optimizer, op.etas())
    weight = _make_weight_fn(gcfg)
    for _ in range(n):
        leaves = {k: v.detach().requires_grad_(True) for k, v in phi.items()}
        with torch.enable_grad():
            diff = ((y - (2.0 * op.forward(leaves, x0) - 1.0)) * weight(x0)).float()
            if gcfg.loss_function == "norm":
                loss = torch.sqrt(torch.sum(diff ** 2, dim=(1, 2, 3))).sum()
            else:
                loss = torch.mean(diff ** 2, dim=(1, 2, 3)).sum()
            gs = torch.autograd.grad(loss, list(leaves.values()))
        new, _ = opt.update(phi, dict(zip(leaves, gs)), {})
        if eta_scale is not None:
            s = torch.tensor(float(eta_scale), dtype=torch.float32, device=x0.device)
            new = {k: phi[k] + s * (new[k] - phi[k]) for k in phi}
        phi = new
    return phi


def _k5_close(got, want, start, what):
    """Each name's phi within 1e-5 of the largest step the eager loop took,
    or one fp32 spacing of phi (an update whose last rounding went the other
    way); exact where the loop took no step."""
    for k in want:
        step = (want[k] - start[k]).abs().max().item()
        err = (got[k] - want[k]).abs().max().item()
        spacing = torch.finfo(torch.float32).eps * want[k].abs().max().item() if step else 0.0
        print(f"K5 {what} {k}: step {step:.4g}, max err {err:.3g}")
        assert got[k].shape == want[k].shape and torch.isfinite(got[k]).all(), (what, k)
        assert err <= max(1e-5 * step, spacing), (what, k, err, step)


def _k5_fit(op, phi, x0, y, gcfg, eta_scale):
    """The guided loop's route for these inputs, lane-separable: K5's Fit."""
    from osmosis_tpu_torch.diffusion.guided import _k5_route

    fit = _k5_route(op, phi, x0, y, gcfg, eta_scale, True, None)
    assert fit is not None
    return fit


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("weight", ["depth", "none"])
@pytest.mark.parametrize("loss", ["norm", "mse"])
@pytest.mark.parametrize("name", list(K5_OPERATORS))
def test_phi_fit_kernel_matches_the_eager_loop(cuda, name, loss, weight, b):
    from osmosis_tpu_torch.ops import phi_fit as K5

    op, (gcfg, _) = _k5_operator(name, b), _k5_gcfg(loss, weight)
    x0, y = _k5_data(cuda, b, seed=b)
    phi = {k: torch.as_tensor(v, device=cuda) for k, v in op.phi_init().items()}
    fit = _k5_fit(op, phi, x0, y, gcfg, None)
    n0 = profiling.counters()["phi_fit.launches"]
    got = K5.phi_fit(x0, y, phi, fit, 19)
    assert profiling.counters()["phi_fit.launches"] == n0 + 1
    want = _eager_phi_fit(op, gcfg, x0, y, phi, 19, None)
    _k5_close(got, want, phi, f"{name} {loss} {weight} B={b}")
    again = K5.phi_fit(x0, y, phi, fit, 19)
    assert all(torch.equal(again[k], got[k]) for k in got)  # no atomics: the same bits


@pytest.mark.parametrize("n", [1, 19])
@pytest.mark.parametrize("eta_scale", [None, 0.5, 0.0])
def test_phi_fit_kernel_under_eta_scale(cuda, eta_scale, n):
    from osmosis_tpu_torch.ops import phi_fit as K5

    name = "underwater_physical_revised"
    op, (gcfg, _) = _k5_operator(name, 1), _k5_gcfg("norm", "depth")
    x0, y = _k5_data(cuda, 1, seed=7)
    phi = {k: torch.as_tensor(v, device=cuda) for k, v in op.phi_init().items()}
    inputs = {k: v.clone() for k, v in phi.items()}
    got = K5.phi_fit(x0, y, phi, _k5_fit(op, phi, x0, y, gcfg, eta_scale), n)
    want = _eager_phi_fit(op, gcfg, x0, y, phi, n, eta_scale)
    _k5_close(got, want, phi, f"eta_scale {eta_scale} n {n}")
    assert all(torch.equal(phi[k], inputs[k]) for k in phi)  # the inputs are not written
    if eta_scale == 0.0:
        assert all(torch.equal(got[k], phi[k]) for k in phi)


# ragged sizes (clusters of 1 and 4 CTAs, one pixel a row), and 256x256
# with clusters of 8 and shared memory for part of each CTA's pixels only
@pytest.mark.parametrize("b,h,w,max_cluster,smem", [
    (1, 40, 48, 16, None), (2, 100, 70, 16, None), (1, 33, 1, 16, None),
    (1, 256, 256, 8, 64 * 1024), (2, 256, 256, 16, 48 * 1024)])
def test_phi_fit_kernel_at_other_geometries(cuda, monkeypatch, b, h, w, max_cluster, smem):
    from osmosis_tpu_torch.ops import phi_fit as K5

    monkeypatch.setattr(K5, "MAX_CLUSTER", max_cluster)
    if smem is not None:
        monkeypatch.setattr(K5, "SMEM_BYTES", smem)
    K5._device_plan.cache_clear()
    try:
        op, (gcfg, _) = _k5_operator("underwater_physical_revised", b), _k5_gcfg("norm", "depth")
        x0, y = _k5_data(cuda, b, hw=h, w=w, seed=h + w)
        phi = {k: torch.as_tensor(v, device=cuda) for k, v in op.phi_init().items()}
        got = K5.phi_fit(x0, y, phi, _k5_fit(op, phi, x0, y, gcfg, None), 19)
        torch.cuda.synchronize()
        g = K5._device_plan(x0.device.index or 0, h * w, False, max_cluster)
    finally:
        K5._device_plan.cache_clear()
    assert g.cluster <= max_cluster and (smem is None or g.cached < g.px)
    want = _eager_phi_fit(op, gcfg, x0, y, phi, 19, None)
    _k5_close(got, want, phi, f"{b}x{h}x{w} cluster {g.cluster} cached {g.cached}/{g.px}")


@pytest.mark.parametrize("b", [1, 4])
def test_guided_chain_through_k5_matches_the_eager_twin(cuda, monkeypatch, b):
    """A guided chain at 256x256 whose phi unfreezes with a warm phase (10
    extra passes: 29 at that step, 19 after), at batch 1 and as the fleet's
    lane-separable batch 4: K5 at every step with phi-only passes, and the
    phi trace of the eager twin (K5 barred) within 1e-5 of its step."""
    from osmosis_tpu_torch.diffusion import guided as G
    from osmosis_tpu_torch.diffusion.sampler import SamplerConfig
    from osmosis_tpu_torch.diffusion.schedules import make_schedule

    op = _k5_operator("underwater_physical_revised", b)
    gcfg, pattern = _k5_gcfg("norm", "depth", warm=10)
    x, y = _k5_data(cuda, b, seed=3)
    sch = make_schedule("linear", 1000, "6")

    def model(xt, t):
        return torch.cat([0.3 * xt + 1e-4 * t.float().reshape(-1, 1, 1, 1), 0.1 * xt], dim=-1)

    def chain():
        before = profiling.counters()
        res = G.guided_sample_loop(model, sch, x, y, op, gcfg, SamplerConfig(clip_denoised=True),
                                 sample_pattern=pattern, deterministic=True,
                                 lane_separable=b > 1)
        after = profiling.counters()
        return res, {k: after[k] - before[k] for k in
                     ("guided.phi_fits", "guided.phi_fits_k5", "phi_fit.launches")}

    res, counts = chain()
    assert counts["guided.phi_fits"] > 0
    assert counts["guided.phi_fits_k5"] == counts["phi_fit.launches"] == counts["guided.phi_fits"]
    monkeypatch.setattr(G, "_k5_route", lambda *a: None)
    twin, counts = chain()
    assert counts["guided.phi_fits_k5"] == counts["phi_fit.launches"] == 0
    start = {k: torch.as_tensor(v, device=cuda) for k, v in op.phi_init().items()}
    _k5_close({k: v[-1] for k, v in res.phi_trace.items()},
              {k: v[-1] for k, v in twin.phi_trace.items()}, start, f"chain B={b}")


def test_phi_fit_kernel_rejects_what_it_does_not_take(cuda):
    from osmosis_tpu_torch.ops import phi_fit as K5

    op, (gcfg, _) = _k5_operator("underwater_physical_revised", 1), _k5_gcfg("norm", "depth")
    x0, y = _k5_data(cuda, 1, hw=32)
    phi = {k: torch.as_tensor(v, device=cuda) for k, v in op.phi_init().items()}
    fit = _k5_fit(op, phi, x0, y, gcfg, None)
    with pytest.raises(TypeError):
        K5.phi_fit(x0.bfloat16(), y, phi, fit, 2)
    with pytest.raises(ValueError):
        K5.phi_fit(x0.transpose(1, 2), y, phi, fit, 2)
    with pytest.raises(ValueError):
        K5.phi_fit(x0[..., :3].contiguous(), y, phi, fit, 2)
    with pytest.raises(ValueError):
        K5.phi_fit(x0, torch.cat([y, y[..., :1]], dim=-1), phi, fit, 2)
