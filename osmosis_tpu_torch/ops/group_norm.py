"""Fused GroupNorm(32) -> (FiLM) -> (SiLU), forward and backward.

The port of the JAX package's hand-written GroupNorm ops
(``osmosis_tpu/models/nn.py``): ``group_norm`` (custom VJP, :72-132),
``norm_silu`` (:178-202) and ``norm_film_silu`` (:205-240). One op covers all
three: ``y = silu?( GN(x)·(1+s)+t ?)``, statistics in fp32 with the JAX
formula ``var = E[x²] − mean²``, ``inv = rsqrt(var + eps)``, the norm output
rounded to x's dtype before the epilogue. The backward saves only x and the
[B, C] statistics and recomputes the epilogue, as ``_ns_bwd``/``_nfs_bwd`` do.

* K3 ``group_norm_forward`` (Triton, ``group_norm_triton.py``): a stats pass of
  partial per-channel sums over chunks of HW, the [B, C] → [B, 32] collapse in
  torch, then one elementwise apply pass.
* K4 ``group_norm_backward`` (Triton): a reduction pass of per-channel
  r1 = Σdgn, r2 = Σdgn·x̂ (plus Σdfilm·gn and Σdfilm with FiLM), the collapse to
  groups in torch, then one elementwise pass dx = inv·(dgn·γ − h1 − x̂·h2).

Bound on the H100: bytes. The op does a few dozen flops per element, far
below the card's 295 flops a byte, so the least time is one read of x and
one write of y (K3), or two reads (x, dy) and one write (dx) for K4, at
3.35 TB/s. K3 reads x twice (stats, apply) and K4 reads x and dy twice
(reduce, apply): recomputing the epilogue costs less traffic than storing
it. The HW axis is split so that B=1 launches about four programs per SM.

Tensors are NCHW in ``channels_last`` memory, so ``x.permute(0, 2, 3, 1)`` is
the contiguous [B, H, W, C] that the kernels read. A wrapper runs the plain
PyTorch version only for a tensor on the CPU; for a CUDA tensor it launches
its kernels or raises. Each call that launches adds one to ``launches``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

NUM_GROUPS = 32
EPS = 1e-5

_BLOCK_HW = 16
_BLOCK_C = 128
_APPLY_BLOCK_HW = 32
_PROGRAMS_PER_SM = 4


# ---------------------------------------------------------------------------
# statistics shared by both versions: the [B, C] -> [B, G] collapse
# ---------------------------------------------------------------------------

def _collapse_stats(s1: torch.Tensor, s2: torch.Tensor, n: int, groups: int, eps: float):
    """Per-channel Σx, Σx² [B, C] -> per-channel (mean, inv) of their group."""
    b, c = s1.shape
    cpg = c // groups
    mean = s1.view(b, groups, cpg).sum(-1) / n
    var = s2.view(b, groups, cpg).sum(-1) / n - mean * mean
    inv = torch.rsqrt(var + eps)
    return mean.repeat_interleave(cpg, dim=1), inv.repeat_interleave(cpg, dim=1)


def _collapse_grads(r1: torch.Tensor, r2: torch.Tensor, weight: torch.Tensor, n: int,
                    groups: int):
    """Group means of h = dgn·γ and h·x̂ from per-channel sums, per channel."""
    b, c = r1.shape
    cpg = c // groups
    h1 = (r1 * weight).view(b, groups, cpg).sum(-1) / n
    h2 = (r2 * weight).view(b, groups, cpg).sum(-1) / n
    return h1.repeat_interleave(cpg, dim=1), h2.repeat_interleave(cpg, dim=1)


def _bc(v: torch.Tensor) -> torch.Tensor:
    """[B, C] -> [B, C, 1, 1]."""
    return v[:, :, None, None]


def _check_groups(x: torch.Tensor, groups: int) -> None:
    if x.dim() != 4 or x.shape[1] % groups:
        raise ValueError(
            f"group norm: expected NCHW with C divisible by {groups}, got {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# plain versions (any device, any layout)
# ---------------------------------------------------------------------------

def group_norm_forward_plain(x, weight, bias, fs=None, ft=None, silu=False,
                             groups=NUM_GROUPS, eps=EPS):
    """Plain K3: returns ``(y, mean_c, inv_c)``; fs/ft are [B, C] in x's dtype."""
    _check_groups(x, groups)
    x32 = x.float()
    n = x.shape[2] * x.shape[3] * (x.shape[1] // groups)
    mean_c, inv_c = _collapse_stats(x32.sum((2, 3)), (x32 * x32).sum((2, 3)), n, groups, eps)
    h = ((x32 - _bc(mean_c)) * _bc(inv_c * weight) + _bc(bias[None])).to(x.dtype)
    if fs is not None:
        h = h * (1 + _bc(fs)) + _bc(ft)
    if silu:
        h = h * torch.sigmoid(h)
    return h, mean_c, inv_c


def group_norm_backward_plain(gy, x, weight, bias, fs, ft, silu, mean_c, inv_c,
                              groups=NUM_GROUPS):
    """Plain K4: returns ``(dx, dweight, dbias, dfs, dft)`` (dfs/dft None
    without FiLM), the arithmetic of ``_nfs_bwd``/``_ns_bwd``/``_gn_bwd``."""
    x32 = x.float()
    n = x.shape[2] * x.shape[3] * (x.shape[1] // groups)
    gn = ((x32 - _bc(mean_c)) * _bc(inv_c * weight) + _bc(bias[None])).to(x.dtype)
    dfs = dft = None
    if fs is not None:
        film = gn * (1 + _bc(fs)) + _bc(ft)
        s = torch.sigmoid(film)
        dfilm = gy * (s * (1 + film * (1 - s)))
        dfs = (dfilm * gn).sum((2, 3)).to(fs.dtype)
        dft = dfilm.sum((2, 3)).to(ft.dtype)
        dgn = dfilm * (1 + _bc(fs))
    elif silu:
        s = torch.sigmoid(gn)
        dgn = gy * (s * (1 + gn * (1 - s)))
    else:
        dgn = gy
    g32 = dgn.float()
    xhat = (x32 - _bc(mean_c)) * _bc(inv_c)
    r1 = g32.sum((2, 3))
    r2 = (g32 * xhat).sum((2, 3))
    h1, h2 = _collapse_grads(r1, r2, weight, n, groups)
    dx = _bc(inv_c) * (g32 * _bc(weight[None]) - _bc(h1) - xhat * _bc(h2))
    return dx.to(x.dtype), r2.sum(0), r1.sum(0), dfs, dft


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _nhwc_view(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {x.dtype} is not supported (float32, bfloat16)")
    v = x.permute(0, 2, 3, 1)
    if not v.is_contiguous():
        raise ValueError(f"{what}: x must be NCHW in channels_last memory format")
    return v


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _chunking(device: torch.device, b: int, hw: int, n_cblk: int) -> Tuple[int, int]:
    """(rows per program, programs along HW) for the reduction passes."""
    sms = _sm_count(device.index if device.index is not None else torch.cuda.current_device())
    want = max(1, (_PROGRAMS_PER_SM * sms) // max(1, b * n_cblk))
    chunks = max(1, min(want, _cdiv(hw, _BLOCK_HW)))
    rows = _cdiv(_cdiv(hw, chunks), _BLOCK_HW) * _BLOCK_HW
    return rows, _cdiv(hw, rows)


def _film_args(fs, ft, dummy):
    if fs is None:
        return dummy, dummy
    return fs.contiguous(), ft.contiguous()


def group_norm_forward(x, weight, bias, fs=None, ft=None, silu=False,
                       groups=NUM_GROUPS, eps=EPS):
    """K3. Returns ``(y, mean_c, inv_c)``; y keeps x's dtype and layout."""
    if x.device.type == "cpu":
        return group_norm_forward_plain(x, weight, bias, fs, ft, silu, groups, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm: no kernel for device {x.device}")
    _check_groups(x, groups)
    from . import group_norm_triton as K

    xv = _nhwc_view(x, "group_norm")
    b, h, w, c = xv.shape
    hw = h * w
    n_cblk = _cdiv(c, _BLOCK_C)
    rows, chunks = _chunking(x.device, b, hw, n_cblk)
    s1 = torch.empty((b, chunks, c), dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(s1)
    K.gn_stats_kernel[(chunks, n_cblk, b)](
        xv, s1, s2, hw, c, rows, BLOCK_HW=_BLOCK_HW, BLOCK_C=_BLOCK_C, num_warps=4)
    mean_c, inv_c = _collapse_stats(s1.sum(1), s2.sum(1), hw * (c // groups), groups, eps)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    fs_, ft_ = _film_args(fs, ft, mean_c)
    K.gn_apply_kernel[(_cdiv(hw, _APPLY_BLOCK_HW), n_cblk, b)](
        xv, y.permute(0, 2, 3, 1), mean_c, inv_c, weight.float().contiguous(),
        bias.float().contiguous(), fs_, ft_, hw, c,
        FILM=fs is not None, SILU=bool(silu),
        BLOCK_HW=_APPLY_BLOCK_HW, BLOCK_C=_BLOCK_C, num_warps=4)
    group_norm_forward.launches += 1
    return y, mean_c, inv_c


group_norm_forward.launches = 0


def group_norm_backward(gy, x, weight, bias, fs, ft, silu, mean_c, inv_c,
                        groups=NUM_GROUPS):
    """K4. Returns ``(dx, dweight, dbias, dfs, dft)`` like the plain version."""
    if x.device.type == "cpu":
        return group_norm_backward_plain(gy, x, weight, bias, fs, ft, silu, mean_c, inv_c, groups)
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm backward: no kernel for device {x.device}")
    from . import group_norm_triton as K

    xv = _nhwc_view(x, "group_norm backward")
    gv = _nhwc_view(gy, "group_norm backward (dy)")
    b, h, w, c = xv.shape
    hw = h * w
    n = hw * (c // groups)
    n_cblk = _cdiv(c, _BLOCK_C)
    rows, chunks = _chunking(x.device, b, hw, n_cblk)
    film = fs is not None
    parts = torch.empty((4 if film else 2, b, chunks, c), dtype=torch.float32, device=x.device)
    w32 = weight.float().contiguous()
    b32 = bias.float().contiguous()
    fs_, ft_ = _film_args(fs, ft, mean_c)
    K.gn_bwd_reduce_kernel[(chunks, n_cblk, b)](
        xv, gv, mean_c, inv_c, w32, b32, fs_, ft_,
        parts[0], parts[1], parts[2 if film else 0], parts[3 if film else 1],
        hw, c, rows, FILM=film, SILU=bool(silu),
        BLOCK_HW=_BLOCK_HW, BLOCK_C=_BLOCK_C, num_warps=4)
    sums = parts.sum(2)
    r1, r2 = sums[0], sums[1]
    h1, h2 = _collapse_grads(r1, r2, w32, n, groups)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    K.gn_bwd_apply_kernel[(_cdiv(hw, _APPLY_BLOCK_HW), n_cblk, b)](
        xv, gv, dx.permute(0, 2, 3, 1), mean_c, inv_c, w32, b32, fs_, ft_,
        h1.contiguous(), h2.contiguous(), hw, c, FILM=film, SILU=bool(silu),
        BLOCK_HW=_APPLY_BLOCK_HW, BLOCK_C=_BLOCK_C, num_warps=4)
    group_norm_backward.launches += 1
    dfs = sums[2].to(fs.dtype) if film else None
    dft = sums[3].to(ft.dtype) if film else None
    return dx, r2.sum(0), r1.sum(0), dfs, dft


group_norm_backward.launches = 0


class _GroupNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, fs, ft, silu):
        y, mean_c, inv_c = group_norm_forward(x, weight, bias, fs, ft, silu)
        ctx.silu = silu
        ctx.save_for_backward(x, weight, bias, fs, ft, mean_c, inv_c)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, weight, bias, fs, ft, mean_c, inv_c = ctx.saved_tensors
        if gy.dim() == 4:
            gy = gy.contiguous(memory_format=torch.channels_last)
        dx, dw, db, dfs, dft = group_norm_backward(
            gy, x, weight, bias, fs, ft, ctx.silu, mean_c, inv_c)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dw if need[1] else None, db if need[2] else None,
                dfs if need[3] else None, dft if need[4] else None, None)


def group_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm(32) of an NCHW tensor, then ``·(1+s)+t`` if ``film=(s, t)``
    ([B, C] each), then SiLU if ``act == "silu"``; differentiable in all inputs."""
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    if film is not None and act != "silu":
        raise ValueError("the FiLM epilogue is fused with SiLU only, as in the JAX package")
    x = x.contiguous(memory_format=torch.channels_last)
    fs, ft = (None, None) if film is None else (film[0].to(x.dtype), film[1].to(x.dtype))
    return _GroupNormAct.apply(x, weight, bias, fs, ft, act == "silu")
