"""Nearest-neighbour 2x upsample and 2x2 average pool on NHWC tensors.

Kernels K1 and K2 (CUDA C++, ``csrc/upsample.cu``) replace the package's one
Pallas TPU kernel, ``osmosis_tpu/ops/upsample.py`` ``upsample_nearest_2x_pallas``
(``_up_kernel``; its backward ``_up_bwd`` and the mirror ``_down_kernel``):

* K1 ``upsample_nearest_2x_kernel(x, scale)``: ``[B,H,W,C] -> [B,2H,2W,C]``,
  every input vector stored at its four outputs, times ``scale``.
* K2 ``box_sum_2x_kernel(x, scale)``: ``[B,2H,2W,C] -> [B,H,W,C]``, the 2x2
  sum in fp32 times ``scale``.

Both are bound by bytes on the H100 (3.35 TB/s): see the note in the CUDA
source. Two ``autograd.Function``s serve four directions with them:
``upsample_nearest_2x`` (forward K1 at scale 1, backward K2 at scale 1) and
``avg_pool_2x`` (forward K2 at scale 0.25, backward K1 at scale 0.25).

A wrapper runs the kernel's plain PyTorch version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises. Each kernel launch
adds one to the counter ``<wrapper>.launches`` (``utils/profiling.counters``:
``upsample_nearest_2x.launches``, ``box_sum_2x.launches``).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def upsample_nearest_2x_plain(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Plain version of K1: ``[B,H,W,C] -> [B,2H,2W,C]``, times ``scale`` in fp32."""
    b, h, w, c = x.shape
    y = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
    if scale != 1.0:
        y = (y.float() * scale).to(x.dtype)
    return y.contiguous()


def box_sum_2x_plain(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Plain version of K2: the 2x2 sum in fp32, in the kernel's order (and
    XLA's): pairs along W first, then the two rows."""
    x32 = x.float()
    s = (x32[:, 0::2, 0::2] + x32[:, 0::2, 1::2]) + (x32[:, 1::2, 0::2] + x32[:, 1::2, 1::2])
    return (s * scale).to(x.dtype).contiguous()


def _check_cuda_input(x: torch.Tensor, what: str) -> int:
    if x.dim() != 4:
        raise ValueError(f"{what}: expected an NHWC tensor, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} is not supported (float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous NHWC (channels_last NCHW)")
    if (x.shape[-1] * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError(
            f"{what}: C * itemsize must be a multiple of 16 bytes and the data "
            f"16-byte aligned (C={x.shape[-1]}, {x.dtype})"
        )
    return _DTYPE_CODES[x.dtype]


def _launch(fn_name: str, x: torch.Tensor, y: torch.Tensor, dims, dtype_code: int, scale: float):
    lib = _build.load("upsample")
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), y.data_ptr(), *dims, dtype_code, float(scale), stream)
    _build.check(lib, code, fn_name)


def upsample_nearest_2x_kernel(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """K1. NHWC ``[B,H,W,C] -> [B,2H,2W,C]``."""
    if x.device.type == "cpu":
        return upsample_nearest_2x_plain(x, scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"upsample_nearest_2x: no kernel for device {x.device}")
    code = _check_cuda_input(x, "upsample_nearest_2x")
    b, h, w, c = x.shape
    y = torch.empty((b, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    _launch("osm_upsample_nearest_2x", x, y, (b, h, w, c), code, scale)
    profiling.count("upsample_nearest_2x.launches")
    return y


def box_sum_2x_kernel(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """K2. NHWC ``[B,2H,2W,C] -> [B,H,W,C]``."""
    if x.device.type == "cpu":
        return box_sum_2x_plain(x, scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"box_sum_2x: no kernel for device {x.device}")
    code = _check_cuda_input(x, "box_sum_2x")
    b, h2, w2, c = x.shape
    if h2 % 2 or w2 % 2:
        raise ValueError(f"box_sum_2x: H and W must be even, got {h2}x{w2}")
    y = torch.empty((b, h2 // 2, w2 // 2, c), dtype=x.dtype, device=x.device)
    _launch("osm_box_sum_2x", x, y, (b, h2 // 2, w2 // 2, c), code, scale)
    profiling.count("box_sum_2x.launches")
    return y


class _UpsampleNearest2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return upsample_nearest_2x_kernel(x, 1.0)

    @staticmethod
    def backward(ctx, g):
        return box_sum_2x_kernel(g.contiguous(), 1.0)


class _AvgPool2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return box_sum_2x_kernel(x, 0.25)

    @staticmethod
    def backward(ctx, g):
        return upsample_nearest_2x_kernel(g.contiguous(), 0.25)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NHWC (``osmosis_tpu.models.nn.upsample_nearest_2x``)."""
    return _UpsampleNearest2x.apply(x)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, NHWC (``osmosis_tpu.models.nn.avg_pool_2x``)."""
    return _AvgPool2x.apply(x)
