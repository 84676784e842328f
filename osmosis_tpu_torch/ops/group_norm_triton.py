"""Triton kernels K3 (fused GroupNorm forward) and K4 (its backward).

They replace the JAX package's hand-written GroupNorm ops
(``osmosis_tpu/models/nn.py``: ``group_norm``, ``norm_silu``,
``norm_film_silu`` and their custom VJPs). Both are bound by bytes on the
H100; :mod:`osmosis_tpu_torch.ops.group_norm` states the bound and wraps them.

This module imports ``triton`` at its top, so it is imported only by the
launching functions in :mod:`osmosis_tpu_torch.ops.group_norm`, on a CUDA
tensor. Every kernel sees the activation as ``[B, HW, C]`` with C contiguous
(an NCHW tensor in ``channels_last`` memory), and works on tiles of
``BLOCK_HW`` pixels by ``BLOCK_C`` channels, so that each warp reads whole
runs of neighbouring channels.

Statistics are kept per CHANNEL (sums over HW), not per group. That keeps the
channel block a power of two whatever C/32 is (24 and 48 channels a group in
the output blocks) and needs only a mask at the edge of C; the [B, C] sums are
collapsed to the 32 groups in plain torch, as ``osmosis_tpu.models.nn``
collapses them. The HW axis is split over many programs, each writing its
partial per-channel sums to a [B, chunks, C] scratch that torch sums (the
"second reduction step"), so that B=1 still fills the card's SMs.
"""

import triton
import triton.language as tl


@triton.jit
def gn_stats_kernel(x_ptr, s1_ptr, s2_ptr, HW, C, rows_per_prog,
                    BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr):
    """Partial per-channel sums of x and x*x over one chunk of HW rows."""
    chunk = tl.program_id(0)
    cb = tl.program_id(1)
    b = tl.program_id(2)
    n_chunks = tl.num_programs(0)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    base = x_ptr + b.to(tl.int64) * HW * C
    row0 = chunk * rows_per_prog
    acc1 = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
    for r in range(0, rows_per_prog, BLOCK_HW):
        rows = row0 + r + tl.arange(0, BLOCK_HW)
        m = (rows < HW)[:, None] & cmask[None, :]
        v = tl.load(base + rows[:, None] * C + cols[None, :], mask=m, other=0.0).to(tl.float32)
        acc1 += v
        acc2 += v * v
    out = (b * n_chunks + chunk) * C + cols
    tl.store(s1_ptr + out, tl.sum(acc1, axis=0), mask=cmask)
    tl.store(s2_ptr + out, tl.sum(acc2, axis=0), mask=cmask)


@triton.jit
def _load_channel_params(mean_ptr, inv_ptr, w_ptr, b_ptr, fs_ptr, ft_ptr, b, C, cols, cmask,
                         FILM: tl.constexpr):
    mean = tl.load(mean_ptr + b * C + cols, mask=cmask, other=0.0)
    inv = tl.load(inv_ptr + b * C + cols, mask=cmask, other=0.0)
    w = tl.load(w_ptr + cols, mask=cmask, other=0.0)
    bb = tl.load(b_ptr + cols, mask=cmask, other=0.0)
    if FILM:
        fs = tl.load(fs_ptr + b * C + cols, mask=cmask, other=0.0).to(tl.float32)
        ft = tl.load(ft_ptr + b * C + cols, mask=cmask, other=0.0).to(tl.float32)
    else:
        fs = mean
        ft = mean
    return mean, inv, w, bb, fs, ft


@triton.jit
def _grad_into_norm(gn, g, fs, ft, FILM: tl.constexpr, SILU: tl.constexpr):
    """Cotangent of the norm output (dgn) and of the FiLM output (dfilm),
    recomputed from the norm output gn: the backward of silu(gn*(1+s)+t)."""
    if FILM:
        f = gn * (1.0 + fs[None, :]) + ft[None, :]
        s = tl.sigmoid(f)
        dfilm = g * (s * (1.0 + f * (1.0 - s)))
        dgn = dfilm * (1.0 + fs[None, :])
    elif SILU:
        s = tl.sigmoid(gn)
        dfilm = g
        dgn = g * (s * (1.0 + gn * (1.0 - s)))
    else:
        dfilm = g
        dgn = g
    return dgn, dfilm


@triton.jit
def gn_apply_kernel(x_ptr, y_ptr, mean_ptr, inv_ptr, w_ptr, b_ptr, fs_ptr, ft_ptr, HW, C,
                    FILM: tl.constexpr, SILU: tl.constexpr,
                    BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr):
    """y = silu((x - mean) * inv * w + b) * (1 + s) + t), each stage optional."""
    hb = tl.program_id(0)
    cb = tl.program_id(1)
    b = tl.program_id(2)
    rows = hb * BLOCK_HW + tl.arange(0, BLOCK_HW)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    m = (rows < HW)[:, None] & cmask[None, :]
    off = b.to(tl.int64) * HW * C + rows[:, None] * C + cols[None, :]
    mean, inv, w, bb, fs, ft = _load_channel_params(
        mean_ptr, inv_ptr, w_ptr, b_ptr, fs_ptr, ft_ptr, b, C, cols, cmask, FILM)
    x = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
    # the norm output is rounded to x's dtype before the epilogue, as in the
    # JAX package (group_norm casts its result back, nn.py:94-95)
    h = ((x - mean[None, :]) * (inv * w)[None, :] + bb[None, :]).to(y_ptr.dtype.element_ty)
    h = h.to(tl.float32)
    if FILM:
        h = h * (1.0 + fs[None, :]) + ft[None, :]
    if SILU:
        h = h * tl.sigmoid(h)
    tl.store(y_ptr + off, h.to(y_ptr.dtype.element_ty), mask=m)


@triton.jit
def gn_bwd_reduce_kernel(x_ptr, g_ptr, mean_ptr, inv_ptr, w_ptr, b_ptr, fs_ptr, ft_ptr,
                         r1_ptr, r2_ptr, ds_ptr, dt_ptr, HW, C, rows_per_prog,
                         FILM: tl.constexpr, SILU: tl.constexpr,
                         BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr):
    """Partial per-channel sums r1 = sum(dgn), r2 = sum(dgn * xhat) and, with
    FiLM, ds = sum(dfilm * gn), dt = sum(dfilm) over one chunk of HW rows."""
    chunk = tl.program_id(0)
    cb = tl.program_id(1)
    b = tl.program_id(2)
    n_chunks = tl.num_programs(0)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    mean, inv, w, bb, fs, ft = _load_channel_params(
        mean_ptr, inv_ptr, w_ptr, b_ptr, fs_ptr, ft_ptr, b, C, cols, cmask, FILM)
    base = b.to(tl.int64) * HW * C
    row0 = chunk * rows_per_prog
    acc1 = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
    accs = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
    acct = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
    for r in range(0, rows_per_prog, BLOCK_HW):
        rows = row0 + r + tl.arange(0, BLOCK_HW)
        m = (rows < HW)[:, None] & cmask[None, :]
        off = base + rows[:, None] * C + cols[None, :]
        x = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
        g = tl.load(g_ptr + off, mask=m, other=0.0).to(tl.float32)
        xhat = (x - mean[None, :]) * inv[None, :]
        gn = ((x - mean[None, :]) * (inv * w)[None, :] + bb[None, :]).to(x_ptr.dtype.element_ty)
        gn = gn.to(tl.float32)
        dgn, dfilm = _grad_into_norm(gn, g, fs, ft, FILM, SILU)
        acc1 += dgn
        acc2 += dgn * xhat
        if FILM:
            accs += dfilm * gn
            acct += dfilm
    out = (b * n_chunks + chunk) * C + cols
    tl.store(r1_ptr + out, tl.sum(acc1, axis=0), mask=cmask)
    tl.store(r2_ptr + out, tl.sum(acc2, axis=0), mask=cmask)
    if FILM:
        tl.store(ds_ptr + out, tl.sum(accs, axis=0), mask=cmask)
        tl.store(dt_ptr + out, tl.sum(acct, axis=0), mask=cmask)


@triton.jit
def gn_bwd_apply_kernel(x_ptr, g_ptr, dx_ptr, mean_ptr, inv_ptr, w_ptr, b_ptr, fs_ptr, ft_ptr,
                        h1_ptr, h2_ptr, HW, C,
                        FILM: tl.constexpr, SILU: tl.constexpr,
                        BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr):
    """dx = inv * (dgn * w - h1 - xhat * h2), dgn recomputed from x and g."""
    hb = tl.program_id(0)
    cb = tl.program_id(1)
    b = tl.program_id(2)
    rows = hb * BLOCK_HW + tl.arange(0, BLOCK_HW)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    m = (rows < HW)[:, None] & cmask[None, :]
    off = b.to(tl.int64) * HW * C + rows[:, None] * C + cols[None, :]
    mean, inv, w, bb, fs, ft = _load_channel_params(
        mean_ptr, inv_ptr, w_ptr, b_ptr, fs_ptr, ft_ptr, b, C, cols, cmask, FILM)
    h1 = tl.load(h1_ptr + b * C + cols, mask=cmask, other=0.0)
    h2 = tl.load(h2_ptr + b * C + cols, mask=cmask, other=0.0)
    x = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
    g = tl.load(g_ptr + off, mask=m, other=0.0).to(tl.float32)
    xhat = (x - mean[None, :]) * inv[None, :]
    gn = ((x - mean[None, :]) * (inv * w)[None, :] + bb[None, :]).to(x_ptr.dtype.element_ty)
    gn = gn.to(tl.float32)
    dgn, dfilm = _grad_into_norm(gn, g, fs, ft, FILM, SILU)
    dx = inv[None, :] * (dgn * w[None, :] - h1[None, :] - xhat * h2[None, :])
    tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=m)
