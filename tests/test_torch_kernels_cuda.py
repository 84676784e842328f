"""The port's hand-written kernels (K1-K4) against their plain versions, on a
CUDA card. Every test here needs the card (marker ``cuda``) and skips without
one. On the machine with the card, where JAX is absent, run:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances: K1/K2 exact (a copy, or an fp32 sum in the plain version's order);
K3/K4 fp32 1e-4 relative to the largest value (order of summation), bf16 3e-2.
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


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("c,hw,mode", [(256, 64, "silu"), (768, 32, "film"), (1024, 8, "none"),
                                       (96, 5, "film")])
def test_group_norm_kernels_match_plain(cuda, dtype, rtol, c, hw, mode):
    g = torch.Generator(device=cuda).manual_seed(c + hw)
    x = (1.5 * torch.randn(2, c, hw, hw, device=cuda, generator=g) + 0.3).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    w = 1 + 0.1 * torch.randn(c, device=cuda, generator=g)
    b = 0.1 * torch.randn(c, device=cuda, generator=g)
    fs = ft = None
    if mode == "film":
        fs = (0.2 * torch.randn(2, c, device=cuda, generator=g)).to(dtype)
        ft = (0.2 * torch.randn(2, c, device=cuda, generator=g)).to(dtype)
    silu = mode != "none"
    gy = torch.randn(2, c, hw, hw, device=cuda, generator=g).to(dtype)
    gy = gy.contiguous(memory_format=torch.channels_last)
    y, m, i = G.group_norm_forward(x, w, b, fs, ft, silu)
    yp, mp, ip = G.group_norm_forward_plain(x, w, b, fs, ft, silu)
    got = G.group_norm_backward(gy, x, w, b, fs, ft, silu, m, i)
    ref = G.group_norm_backward_plain(gy, x, w, b, fs, ft, silu, mp, ip)
    torch.cuda.synchronize()
    for name, a, r in [("y", y, yp), ("mean", m, mp), ("inv", i, ip)] + [
            (n, a, r) for n, a, r in zip(("dx", "dw", "db", "ds", "dt"), got, ref)
            if a is not None]:
        ok, err = _close(a, r, rtol if name not in ("mean", "inv") else 1e-4)
        assert ok, f"{name}: max abs err {err}"


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
