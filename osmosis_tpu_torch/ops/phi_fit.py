"""The phi-only fit of a guided osmosis step in one launch: kernel K5 (CUDA
C++, ``csrc/phi_fit.cu``).

Before its joint gradient, an osmosis step (``diffusion/guided.py``,
``osmosis_guided``) fits the water parameters phi to a detached x0-hat: the
warm phase's extra passes and ``n_iter - 1`` phi-only updates, each one SGD
step along the guidance loss's gradient with respect to phi alone. Eagerly a
pass is the operator's forward, the loss and ``torch.autograd.grad``, some
fifty small kernels. The gradient has a closed form (the note in the CUDA
source), so K5 runs all the passes of a step in one launch: one thread-block
cluster per image, which keeps the image's pixels in shared memory, reduces
the gradient's ten sums across the cluster at each pass and updates its own
copy of phi.

* :class:`Fit` is what one pass computes, in numbers: phi's names, their
  learning rates, the depth conversions as codes, the loss and
  ``eta_scale``. The guided loop (``diffusion/guided._k5_route``) decides
  which chains K5 runs and builds their Fit; the eager loop stays K5's twin
  everywhere else.
* :func:`phi_fit` runs ``n`` passes on the card and returns the fitted phi
  in new tensors; it writes no input. :func:`phi_fit_plain` is the same
  closed form in plain PyTorch.

Bound on the H100: the data are read once (x0-hat and y, 28 bytes a pixel),
and the passes are serial, each ending in a reduction across the cluster.
Each launch adds one to the counter ``phi_fit.launches``
(``utils/profiling.counters``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from ..utils import profiling
from . import _build

THREADS = 512  # a CTA's threads, csrc/phi_fit.cu's kThreads
FIELDS = 8  # floats a pixel keeps in shared memory
SMEM_BYTES = 200 * 1024  # the most shared memory a CTA's pixels take
PIXELS_PER_CTA = 2048  # the fewest pixels worth a CTA of their own
MAX_CLUSTER = 16  # the H100's non-portable cluster size, the most the kernel takes
# ``convert_depth``'s kinds as the kernel codes them; code 3 is the unit
# weight of ``loss_weight: none``
CONVERSIONS = {"original": 0, "gamma": 1, "move": 2}
ONE = (3, 0.0, 0.0, 0.0)

Conv = Tuple[int, float, float, float]


@dataclasses.dataclass(frozen=True)
class Fit:
    """What one pass computes, as K5 takes it: the phi names in the kernel's
    order (a, b, inf, or ab, inf where one ``phi_ab`` feeds both
    exponentials), each name's learning rates by entry, the operator's depth
    conversion and the loss weight's as (kind, v0, v1, v2), the loss, and
    ``eta_scale`` (None: the update unscaled)."""
    names: Tuple[str, ...]
    etas: Tuple[Tuple[float, ...], ...]
    depth: Conv
    weight: Conv
    mse: bool
    eta_scale: Optional[float]

    @property
    def shared(self) -> bool:
        return len(self.names) == 2


# ---------------------------------------------------------------------------
# the plain version: the closed form in PyTorch
# ---------------------------------------------------------------------------

def _convert_plain(d: torch.Tensor, conv: Conv) -> torch.Tensor:
    kind, v0, v1, v2 = conv
    if kind == 1:
        return torch.pow((d + v0) * v1, v2)
    if kind == 2:
        return d + v0
    if kind == 3:
        return torch.ones_like(d)
    return 0.5 * (d + 1.0)


def grads_plain(x0: torch.Tensor, y: torch.Tensor, phi: Dict[str, torch.Tensor],
                fit: Fit) -> Dict[str, torch.Tensor]:
    """The guidance loss's gradient with respect to phi, each image's own
    ([B, n] for each name), in the closed form K5 computes: d formed in fp32
    as the eager loss forms it, the sums in fp64."""
    r = 0.5 * (x0[..., 0:3] + 1.0)
    z = _convert_plain(x0[..., 3:4], fit.depth)
    w = _convert_plain(x0[..., 3:4], fit.weight)
    bc = lambda name: phi[name][:, None, None, :]  # noqa: E731
    a = bc(fit.names[0])
    b = a if fit.shared else bc(fit.names[1])
    inf = bc(fit.names[-1])
    ea = torch.exp(-a * z)
    eb = ea if fit.shared else torch.exp(-b * z)
    bsc = 1.0 - eb
    d = (y - (2.0 * (r * ea + inf * bsc) - 1.0)) * w
    dw = d.double() * w.double()
    total = lambda v: v.sum(dim=(1, 2))  # noqa: E731  [B, 3]
    ta = total(dw * r.double() * z.double() * ea.double())
    ub = total(dw * z.double() * eb.double())
    ti = total(dw * bsc.double())
    s = (d.double() ** 2).sum(dim=(1, 2, 3))[:, None]
    hw = x0.shape[1] * x0.shape[2]
    k = 4.0 / (3.0 * hw) if fit.mse else 2.0 / torch.sqrt(s)
    ga = k * ta
    gb = -k * inf[:, 0, 0, :].double() * ub
    g = {fit.names[-1]: -k * ti}
    if fit.shared:
        g[fit.names[0]] = ga + gb
    else:
        g[fit.names[0]], g[fit.names[1]] = ga, gb
    return {name: (v.sum(dim=1, keepdim=True) if phi[name].shape[1] == 1 else v).float()
            for name, v in g.items()}


def _sgd_update(phi: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor],
               fit: Fit) -> Dict[str, torch.Tensor]:
    """``p - eta g``, then ``p + s (p' - p)`` under ``eta_scale``: the eager
    optimizer's operations in its order."""
    out = {}
    for name, eta in zip(fit.names, fit.etas):
        p = phi[name]
        e = eta[0] if len(set(eta)) == 1 else torch.tensor(eta, dtype=p.dtype, device=p.device)
        nxt = p - e * g[name]
        if fit.eta_scale is not None:
            nxt = p + torch.tensor(fit.eta_scale, dtype=p.dtype, device=p.device) * (nxt - p)
        out[name] = nxt
    return out


def phi_fit_plain(x0: torch.Tensor, y: torch.Tensor, phi: Dict[str, torch.Tensor], fit: Fit,
                  n: int) -> Dict[str, torch.Tensor]:
    """The plain version of K5: ``n`` closed-form passes."""
    for _ in range(n):
        phi = _sgd_update(phi, grads_plain(x0, y, phi, fit), fit)
    return dict(phi)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Geometry:
    """A launch: ``cluster`` CTAs an image, each owning ``px`` pixels, the
    first ``cached`` of them held in shared memory."""
    cluster: int
    px: int
    cached: int


def plan(hw: int, max_cluster: int = MAX_CLUSTER) -> Geometry:
    """The launch for an image of ``hw`` pixels: a CTA for every
    ``PIXELS_PER_CTA`` pixels, up to ``max_cluster``; as many of a CTA's
    pixels in shared memory as ``SMEM_BYTES`` holds."""
    cluster = max(1, min(max_cluster, -(-hw // PIXELS_PER_CTA)))
    px = -(-hw // cluster)
    return Geometry(cluster, px, min(px, SMEM_BYTES // (4 * FIELDS)))


def _lib() -> ctypes.CDLL:
    lib = _build.load("phi_fit")
    if lib.osm_phi_fit.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.osm_phi_fit.argtypes = [p] * 12 + [f, i, ll, ll] + [i] * 6 + [p]
        lib.osm_phi_fit.restype = i
        lib.osm_phi_fit_max_active_clusters.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.osm_phi_fit_max_active_clusters.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _device_plan(device_index: int, hw: int, shared: bool, max_cluster: int) -> Geometry:
    """``plan`` for this card, halving the cluster while the card cannot hold
    one of it (cudaOccupancyMaxActiveClusters is 0)."""
    lib = _lib()
    while True:
        g = plan(hw, max_cluster)
        out = ctypes.c_int(0)
        with torch.cuda.device(device_index):
            code = lib.osm_phi_fit_max_active_clusters(int(shared), g.cluster, g.cached,
                                                        ctypes.byref(out))
        _build.check(lib, code, "phi_fit occupancy query")
        if out.value > 0 or g.cluster == 1:
            return g
        max_cluster = g.cluster // 2


def _check_inputs(x0: torch.Tensor, y: torch.Tensor):
    for t, c, what in ((x0, 4, "x0-hat"), (y, 3, "y")):
        if t.dim() != 4 or t.shape[-1] != c:
            raise ValueError(f"phi_fit: {what} must be [B, H, W, {c}], got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"phi_fit: {what} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"phi_fit: {what} must be contiguous")
    if x0.shape[:3] != y.shape[:3] or x0.device != y.device:
        raise ValueError(f"phi_fit: x0-hat {tuple(x0.shape)} on {x0.device} and y "
                         f"{tuple(y.shape)} on {y.device} do not match")


def phi_fit(x0: torch.Tensor, y: torch.Tensor, phi: Dict[str, torch.Tensor], fit: Fit,
            n: int) -> Dict[str, torch.Tensor]:
    """K5: ``n`` phi-only SGD passes of the guidance loss against x0-hat
    ``[B, H, W, 4]`` and the measurement y ``[B, H, W, 3]`` (fp32,
    contiguous). Returns the fitted phi, ``[B, n_k]`` fp32 by name, in new
    tensors."""
    _check_inputs(x0, y)
    if n < 1:
        raise ValueError(f"phi_fit: needs at least one pass, got {n}")
    if x0.device.type != "cuda":
        raise RuntimeError(f"phi_fit: no kernel for device {x0.device}")
    B, H, W, _ = x0.shape
    ins = [phi[name].contiguous() for name in fit.names]
    if any(p.shape != (B, p.shape[1]) or p.shape[1] not in (1, 3) or p.device != x0.device
           or p.dtype != torch.float32 for p in ins):
        raise ValueError(f"phi_fit: phi must be float32 [B, 1] or [B, 3] on {x0.device}, got "
                         f"{[(tuple(p.shape), p.dtype) for p in ins]}")
    outs = [torch.empty_like(p) for p in ins]
    if fit.shared:  # the kernel's b slot: unused
        ins.insert(1, ins[0])
        outs.insert(1, outs[0])
    n_entries = [p.shape[1] for p in ins]
    etas = list(fit.etas)
    if fit.shared:
        etas.insert(1, etas[0])
    eta = [e for row in etas for e in (tuple(row) + (0.0,) * (3 - len(row)))]
    g = _device_plan(x0.device.index or 0, H * W, fit.shared, MAX_CLUSTER)
    lib = _lib()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        code = lib.osm_phi_fit(
            x0.data_ptr(), y.data_ptr(), *(p.data_ptr() for p in ins),
            *(o.data_ptr() for o in outs), (ctypes.c_int * 3)(*n_entries),
            (ctypes.c_float * 9)(*eta), (ctypes.c_int * 2)(fit.depth[0], fit.weight[0]),
            (ctypes.c_float * 6)(*fit.depth[1:], *fit.weight[1:]),
            0.0 if fit.eta_scale is None else fit.eta_scale, int(fit.eta_scale is not None),
            B, H * W, g.cluster, g.px, g.cached, int(n), int(fit.shared), int(fit.mse), stream)
    _build.check(lib, code, "phi_fit")
    profiling.count("phi_fit.launches")
    if fit.shared:
        outs.pop(1)
    return dict(zip(fit.names, outs))
