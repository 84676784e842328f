"""Fused GroupNorm(32) -> (FiLM) -> (SiLU), forward and backward.

The port of the JAX package's hand-written GroupNorm ops
(``osmosis_tpu/models/nn.py``): ``group_norm`` (custom VJP, :72-132),
``norm_silu`` (:178-202) and ``norm_film_silu`` (:205-240). One op covers all
three: ``y = silu?( GN(x)·(1+s)+t ?)``, statistics in fp32 with the JAX
formula ``var = E[x²] − mean²``, ``inv = rsqrt(var + eps)``. The backward
saves only x and the [B, C] statistics and recomputes the epilogue, as
``_ns_bwd``/``_nfs_bwd`` do. In bf16 the epilogue and its derivative are bf16
tensors, as in JAX: the plain versions round after every PyTorch op (the norm
output, the FiLM, the sigmoid, dfilm, dgn, ...) and the kernels round at the
same points, while every sum stays fp32.

* K3 ``group_norm_forward`` and K4 ``group_norm_backward`` are CUDA C++
  (``csrc/group_norm.cu``, built by ``_build``). Each call is one launch, or
  two where a tile does not fit on chip, and reduces each group's statistics
  on the device; ``plan`` picks the geometry from the shapes alone:

  - ``resident``: one thread-block cluster per (batch item, channel block of
    whole groups). Its CTAs split HW, hold their tile of x (and dy) in shared
    memory, exchange per-channel partial sums over distributed shared memory
    and write the output from the tile: x is read once.
  - ``split``: launch 1 writes per-channel partial sums to a
    ``[sums, B, chunks, C]`` fp32 scratch; launch 2 sums them, collapses them
    to group statistics itself and applies. x (and dy) are read twice.

Bound on the H100: bytes. The op does a few dozen flops per element, so the
least time is one read of x and one write of y (K3), or reads of x and dy and
one write of dx (K4), at 3.35 TB/s.

Tensors are NCHW in ``channels_last`` memory, so ``x.permute(0, 2, 3, 1)`` is
the contiguous [B, H, W, C] that the kernels read. A wrapper runs the plain
PyTorch version only for a tensor on the CPU; for a CUDA tensor it launches
its kernels or raises. Each call that launches adds one to the counter
``<wrapper>.launches`` (``utils/profiling.counters``; the wrappers are
``group_norm_forward`` and ``group_norm_backward``) and the number of device
kernels it launched to ``<wrapper>.kernel_launches``; K4 also counts its
launches that computed the parameter sums (``group_norm_backward.
param_sum_launches``) and, of those, the ones with the FiLM sums
(``group_norm_backward.film_sum_launches``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import profiling
from . import _build

NUM_GROUPS = 32
EPS = 1e-5

SMEM_MAX = 232448  # 227 KB: the most dynamic shared memory a CTA takes on sm_90
TILE_BUDGET = 64 * 1024  # the resident tile: three CTAs an SM
MAX_THREADS = 128  # of a resident CTA; csrc/group_norm.cu takes up to 256
SPLIT_THREADS = 256
SPLIT_ROW_BYTES = 128  # the channel block of the two-launch geometry, bytes of a row
# the largest cluster the wrappers plan (the kernels take up to 16, the H100's
# non-portable size; clusters of 16 measured slower); 0 makes every call take
# the two-launch geometry
MAX_CLUSTER = 8
RESIDENT_ROW_BYTES = 64  # the least of a pixel's row a resident block holds
SPLIT_CTAS_PER_SM = 2  # the two-launch geometry's grid: one wave of this many an SM

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"none": 0, "silu": 1, "film": 2}


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
# launch geometry (shapes only, so the CPU tests reach it)
# ---------------------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Plan(NamedTuple):
    geometry: str  # "resident" (one launch) or "split" (two)
    cblk: int      # channels per block: whole groups, a multiple of 16 bytes
    n_cblk: int    # channel blocks: C / cblk
    cluster: int   # CTAs per cluster (resident; 1 for split)
    chunks: int    # CTAs along HW per (batch item, channel block)
    px: int        # pixels per CTA
    threads: int   # threads per CTA: a multiple of the vectors per pixel
    smem: int      # dynamic shared memory per CTA, bytes
    tile: int      # the resident tile of x (and dy), bytes (0 for split)
    scratch: int   # fp32 partial sums, elements (0 for resident)

    @property
    def kernels(self) -> int:
        """Device kernels launched per call."""
        return 1 if self.geometry == "resident" else 2


def smem_bytes(geometry: str, tensors: int, cblk: int, lanes: int, threads: int, px: int,
               sums: int) -> int:
    """Dynamic shared memory per CTA, as ``csrc/group_norm.cu`` lays it out:
    the tile (resident only), the reduction rows, the channel totals and the
    two per-channel group results."""
    tile = px * (cblk // lanes) * 16 * tensors if geometry == "resident" else 0
    return tile + 4 * (sums * threads * lanes + sums * cblk + 2 * cblk)


def plan(b: int, c: int, h: int, w: int, itemsize: int, sm_count: int, tensors: int = 1,
         sums: int = 2, max_cluster: int = MAX_CLUSTER) -> Plan:
    """The launch geometry of one call: ``tensors`` is 1 for K3 (x) and 2 for
    K4 (x, dy); ``sums`` the per-channel sums (2, or 4 for K4 with the FiLM
    parameter gradients).

    Resident when the tile fits: the narrowest channel block of whole groups
    that is at least ``RESIDENT_ROW_BYTES`` of a pixel's row, the smallest
    cluster (1 to ``max_cluster``, powers of two) whose tile fits
    ``TILE_BUDGET`` and whose CTAs fill the ``sm_count`` SMs, and no more
    threads than the tile has pixel rows. Otherwise split: blocks of at least
    ``SPLIT_ROW_BYTES`` of a row, in whole 128-byte lines where whole groups
    allow, and ``SPLIT_CTAS_PER_SM`` CTAs per SM along HW in one wave, so that each
    CTA of launch 2 reads few partial sums. The constants are the best of the
    H100 sweeps in PERF.md (``osmosis_tpu_torch.tools.gn_bench --set``)."""
    if c % NUM_GROUPS or (c * itemsize) % 16:
        raise ValueError(f"group norm kernel: C={c} must be a multiple of {NUM_GROUPS} and "
                         f"C * itemsize a multiple of 16 bytes")
    cpg = c // NUM_GROUPS
    lanes = 16 // itemsize
    hw = h * w
    ks = [k for k in (1, 2, 4, 8, 16, 32) if (k * cpg * itemsize) % 16 == 0]
    k = next((k for k in ks if k * cpg * itemsize >= RESIDENT_ROW_BYTES), ks[-1])
    cblk = k * cpg
    n_cblk = c // cblk
    cv = cblk // lanes

    def no_empty_cta(cs):
        return (cs - 1) * _cdiv(hw, cs) < hw

    cs = 1
    while cs <= max_cluster:
        px = _cdiv(hw, cs)
        threads = cv * min(MAX_THREADS // cv, px)
        tile = px * cv * 16 * tensors
        smem = smem_bytes("resident", tensors, cblk, lanes, threads, px, sums)
        if tile <= TILE_BUDGET and smem <= SMEM_MAX and (
                b * n_cblk * cs >= sm_count or 2 * cs > max_cluster
                or not no_empty_cta(2 * cs)):
            return Plan("resident", cblk, n_cblk, cs, cs, px, threads, smem, tile, 0)
        cs *= 2

    # at least SPLIT_ROW_BYTES of a row, whole 128-byte lines where a k gives them
    wide = [j for j in ks if j >= k and j * cpg * itemsize >= SPLIT_ROW_BYTES] or [ks[-1]]
    k = next((j for j in wide if (j * cpg * itemsize) % 128 == 0), wide[0])
    cblk = k * cpg
    n_cblk = c // cblk
    cv = cblk // lanes
    threads = SPLIT_THREADS // cv * cv
    if cblk > threads:
        raise ValueError(f"group norm kernel: a channel block of {cblk} channels is wider "
                         f"than a CTA's {threads} threads")
    rows = threads // cv
    want = max(1, (SPLIT_CTAS_PER_SM * sm_count) // (b * n_cblk))
    px = _cdiv(_cdiv(hw, want), rows) * rows
    chunks = _cdiv(hw, px)
    smem = smem_bytes("split", tensors, cblk, lanes, threads, px, sums)
    return Plan("split", cblk, n_cblk, 1, chunks, px, threads, smem, 0, sums * b * chunks * c)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _nhwc_view(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} is not supported (float32, bfloat16)")
    v = x.permute(0, 2, 3, 1)
    if not v.is_contiguous():
        raise ValueError(f"{what}: x must be NCHW in channels_last memory format")
    if v.data_ptr() % 16:
        raise ValueError(f"{what}: the data must be 16-byte aligned")
    return v


def _fp32_vector(v: torch.Tensor, c: int, what: str) -> torch.Tensor:
    v = v.float().contiguous()
    if v.shape != (c,):
        raise ValueError(f"{what}: expected [{c}], got {tuple(v.shape)}")
    return v


def _film_args(fs, ft, x, b, c):
    """(fs, ft, row stride): [B, C] rows in x's dtype with unit channel stride."""
    if fs is None:
        return None, None, 0
    for t, name in ((fs, "fs"), (ft, "ft")):
        if t.shape != (b, c) or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"group norm: FiLM {name} must be [{b}, {c}] {x.dtype} on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype}")
    if fs.stride(1) != 1 or ft.stride() != fs.stride():
        fs, ft = fs.contiguous(), ft.contiguous()
    return fs, ft, fs.stride(0)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = _build.load("group_norm")
    if lib.osm_gn_forward.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.osm_gn_forward.argtypes = [p] * 8 + [ll, p] + [ll] * 3 + [i] * 9 + [
            ctypes.c_float, p]
        lib.osm_gn_forward.restype = i
        lib.osm_gn_backward.argtypes = [p] * 9 + [ll, p, p] + [ll] * 3 + [i] * 10 + [p]
        lib.osm_gn_backward.restype = i
        lib.osm_gn_max_active_clusters.argtypes = [i] * 8 + [ctypes.POINTER(ctypes.c_int)]
        lib.osm_gn_max_active_clusters.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _device_plan(device_index: int, b: int, c: int, h: int, w: int, dtype_code: int,
                 mode: int, bwd: bool, sums: int, max_cluster: int) -> Plan:
    """``plan`` for this card, halving the cluster while the card cannot hold
    one of it (cudaOccupancyMaxActiveClusters is 0), down to the split."""
    itemsize = 4 if dtype_code == 0 else 2
    lib = _lib()
    while True:
        p = plan(b, c, h, w, itemsize, _sm_count(device_index), 2 if bwd else 1, sums,
                 max_cluster)
        if p.geometry == "split":
            return p
        out = ctypes.c_int(0)
        with torch.cuda.device(device_index):
            code = lib.osm_gn_max_active_clusters(int(bwd), dtype_code, mode, p.cluster,
                                                  p.threads, p.cblk, p.px, sums,
                                                  ctypes.byref(out))
        _build.check(lib, code, "group_norm occupancy query")
        if out.value > 0:
            return p
        max_cluster = p.cluster // 2


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _mode(fs, silu) -> int:
    return _MODES["film" if fs is not None else "silu" if silu else "none"]


def group_norm_forward(x, weight, bias, fs=None, ft=None, silu=False,
                       groups=NUM_GROUPS, eps=EPS):
    """K3. Returns ``(y, mean_c, inv_c)``; y keeps x's dtype and layout."""
    if x.device.type == "cpu":
        return group_norm_forward_plain(x, weight, bias, fs, ft, silu, groups, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm: no kernel for device {x.device}")
    _check_groups(x, groups)
    if groups != NUM_GROUPS:
        raise ValueError(f"group_norm kernel: {NUM_GROUPS} groups only, got {groups}")
    xv = _nhwc_view(x, "group_norm")
    b, h, w, c = xv.shape
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    mode = _mode(fs, silu)
    p = _device_plan(dev, b, c, h, w, _DTYPE_CODES[x.dtype], mode, False, 2, MAX_CLUSTER)
    w32, b32 = _fp32_vector(weight, c, "group_norm weight"), _fp32_vector(bias, c, "group_norm bias")
    fs, ft, ld = _film_args(fs, ft, x, b, c)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    mean_c = torch.empty((b, c), dtype=torch.float32, device=x.device)
    inv_c = torch.empty_like(mean_c)
    scratch = torch.empty(p.scratch, dtype=torch.float32, device=x.device) if p.scratch else None
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.osm_gn_forward(
            xv.data_ptr(), y.data_ptr(), mean_c.data_ptr(), inv_c.data_ptr(), w32.data_ptr(),
            b32.data_ptr(), _ptr(fs), _ptr(ft), ld, _ptr(scratch), b, h * w, c,
            c // NUM_GROUPS, p.cblk, p.px, p.chunks, p.threads, p.cluster,
            int(p.geometry == "split"), mode, _DTYPE_CODES[x.dtype], float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "group_norm forward")
    profiling.count("group_norm_forward.launches")
    profiling.count("group_norm_forward.kernel_launches", p.kernels)
    return y, mean_c, inv_c


def group_norm_backward(gy, x, weight, bias, fs, ft, silu, mean_c, inv_c,
                        groups=NUM_GROUPS, param_grads=True):
    """K4. Returns ``(dx, dweight, dbias, dfs, dft)`` like the plain version.
    With ``param_grads=False`` the kernel skips the parameter-gradient sums
    and the last four are None (on a CUDA tensor)."""
    if x.device.type == "cpu":
        return group_norm_backward_plain(gy, x, weight, bias, fs, ft, silu, mean_c, inv_c, groups)
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm backward: no kernel for device {x.device}")
    _check_groups(x, groups)
    if groups != NUM_GROUPS:
        raise ValueError(f"group_norm kernel: {NUM_GROUPS} groups only, got {groups}")
    xv = _nhwc_view(x, "group_norm backward")
    gv = _nhwc_view(gy, "group_norm backward (dy)")
    if gv.shape != xv.shape or gy.dtype != x.dtype:
        raise ValueError(f"group_norm backward: dy {tuple(gy.shape)} {gy.dtype} does not "
                         f"match x {tuple(x.shape)} {x.dtype}")
    b, h, w, c = xv.shape
    for t in (mean_c, inv_c):
        if t.shape != (b, c) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("group_norm backward: mean_c/inv_c must be contiguous fp32 [B, C]")
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    mode = _mode(fs, silu)
    sums = 4 if (fs is not None and param_grads) else 2
    p = _device_plan(dev, b, c, h, w, _DTYPE_CODES[x.dtype], mode, True, sums, MAX_CLUSTER)
    w32, b32 = _fp32_vector(weight, c, "group_norm weight"), _fp32_vector(bias, c, "group_norm bias")
    fs, ft, ld = _film_args(fs, ft, x, b, c)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    pg = torch.empty((4, b, c), dtype=torch.float32, device=x.device) if param_grads else None
    scratch = torch.empty(p.scratch, dtype=torch.float32, device=x.device) if p.scratch else None
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.osm_gn_backward(
            xv.data_ptr(), gv.data_ptr(), dx.data_ptr(), mean_c.data_ptr(), inv_c.data_ptr(),
            w32.data_ptr(), b32.data_ptr(), _ptr(fs), _ptr(ft), ld, _ptr(pg), _ptr(scratch),
            b, h * w, c, c // NUM_GROUPS, p.cblk, p.px, p.chunks, p.threads, p.cluster,
            int(p.geometry == "split"), mode, _DTYPE_CODES[x.dtype], sums,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "group_norm backward")
    profiling.count("group_norm_backward.launches")
    profiling.count("group_norm_backward.kernel_launches", p.kernels)
    if param_grads:  # the launches that computed dγ, dβ (training) ...
        profiling.count("group_norm_backward.param_sum_launches")
    if sums == 4:  # ... and the FiLM dfs, dft
        profiling.count("group_norm_backward.film_sum_launches")
    if not param_grads:
        return dx, None, None, None, None
    # per-batch sums [B, C] -> [C]; at B = 1 a view, no device op
    dweight = pg[1, 0] if b == 1 else pg[1].sum(0)
    dbias = pg[0, 0] if b == 1 else pg[0].sum(0)
    dfs = pg[2].to(fs.dtype) if fs is not None else None
    dft = pg[3].to(ft.dtype) if fs is not None else None
    return dx, dweight, dbias, dfs, dft


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
        need = ctx.needs_input_grad
        dx, dw, db, dfs, dft = group_norm_backward(
            gy, x, weight, bias, fs, ft, ctx.silu, mean_c, inv_c, param_grads=any(need[1:5]))
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
