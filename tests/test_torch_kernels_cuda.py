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
