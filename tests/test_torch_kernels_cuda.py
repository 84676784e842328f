"""The port's hand-written kernels (K1-K4) against their plain versions, on a
CUDA card. Every test here needs the card (marker ``cuda``) and skips without
one. On the machine with the card, where JAX is absent, run:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances: K1/K2 exact (a copy, or an fp32 sum in the plain version's order);
K3/K4 fp32 1e-4 relative to the largest value (order of summation), bf16 3e-2.
K3/K4 run in both their geometries (``MAX_CLUSTER = 0`` forces the two-launch
one) and must give the same bits on a second call.
"""

import pytest
import torch

from osmosis_tpu_torch.ops import group_norm as G
from osmosis_tpu_torch.ops import upsample as U

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
    n1, n2 = U.upsample_nearest_2x_kernel.launches, U.box_sum_2x_kernel.launches
    for scale in (1.0, 0.25):
        assert torch.equal(U.upsample_nearest_2x_kernel(x, scale),
                           U.upsample_nearest_2x_plain(x, scale))
        assert torch.equal(U.box_sum_2x_kernel(x, scale), U.box_sum_2x_plain(x, scale))
    torch.cuda.synchronize()
    assert U.upsample_nearest_2x_kernel.launches == n1 + 2
    assert U.box_sum_2x_kernel.launches == n2 + 2


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
    k0 = (G.group_norm_forward.kernel_launches, G.group_norm_backward.kernel_launches)
    y, m, i = G.group_norm_forward(x, wt, bias, fs, ft, silu)
    got = G.group_norm_backward(gy, x, wt, bias, fs, ft, silu, m, i)
    per_call = 1 if geometry == "resident" else 2
    assert G.group_norm_forward.kernel_launches == k0[0] + per_call
    assert G.group_norm_backward.kernel_launches == k0[1] + per_call
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

    counts = (U.upsample_nearest_2x_kernel.launches, G.group_norm_backward.launches)
    got = run()
    assert U.upsample_nearest_2x_kernel.launches > counts[0]
    assert G.group_norm_backward.launches > counts[1]
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
    k4 = G.group_norm_backward.launches
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
    assert G.group_norm_backward.launches > k4
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out[str(cuda)]
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    top = max(g.abs().max().item() for g in g_cpu.values())
    for n, g in g_cpu.items():
        err = (g_gpu[n] - g).abs().max().item()
        assert err <= 1e-3 * g.abs().max().item() + 1e-5 * top, (n, err)
