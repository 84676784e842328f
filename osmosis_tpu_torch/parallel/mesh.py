"""The (dp, tp) device mesh over ``torch.distributed`` processes (port of
``osmosis_tpu/parallel/mesh.py``).

  * **dp** (data parallel): images shard over the batch axis
    (:func:`shard_batch`); ``guided_sample_loop(mesh=)`` runs each dp rank's
    images and gathers every image on every rank (:func:`gather_batch`).
    Where the guidance loss couples the images (the serial chain's joint
    norm, the aux losses' batch sums and means), its batch-wide reductions
    go through :func:`dp_sum` / :func:`dp_mean`; the fleet's lanes
    (``parallel/runner.py``) need none.
  * **tp** (tensor parallel): the UNet's output features shard over 'tp'
    (:func:`shard_params`): conv kernels, Linear and 1x1 Conv1d weights and
    every 1-D bias and GroupNorm affine whose JAX leaf has a trailing axis
    divisible by 4 and at least 8, as JAX's ``_param_spec`` decides, when tp
    divides it. The port's output-feature axis is dim 0 of every such
    parameter. The execution that makes a sharded UNet compute what the
    unsharded one computes is ``parallel/tp.py``.

A process is a rank of the mesh: one card a rank with NCCL, or ranks that
share a card over gloo (``multihost.initialize(backend=...)``). ``make_mesh``
lays the ranks out as JAX lays out devices: rank = dp_index * tp + tp_index.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from . import multihost


def mesh_shape(n: int, dp: Optional[int] = None, tp: Optional[int] = None) -> Tuple[int, int]:
    """(dp, tp) for ``n`` devices, JAX's defaults: tp the largest of 4, 2, 1
    that divides n, dp the rest."""
    if dp is None or tp is None:
        tp = tp or max(d for d in (4, 2, 1) if n % d == 0)
        dp = dp or n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != devices({n})")
    return dp, tp


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, tp) mesh: ``shape`` as JAX gives it, ``device_mesh`` the
    ``DeviceMesh`` with ``mesh_dim_names=("dp", "tp")`` (None for the one
    process without a process group, whose mesh is 1 x 1)."""

    dp: int
    tp: int
    device_mesh: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    def group(self, axis: str):
        """The process group of this rank's ``axis`` (None on the 1 x 1 mesh)."""
        return None if self.device_mesh is None else self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(axis)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None) -> Mesh:
    """A (dp, tp) mesh over the processes of the group that
    ``multihost.initialize`` joined (every process calls it, with the same
    arguments). ``n_devices`` defaults to the group's size and must equal it;
    without a group it is the trivial 1 x 1 mesh. Raises where NCCL ranks
    share a card."""
    n = multihost.process_count()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices over a group of {n} processes")
    dp, tp = mesh_shape(n, dp, tp)
    if not dist.is_initialized():
        return Mesh(dp, tp)
    multihost.check_devices()
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    grid = torch.arange(n).reshape(dp, tp)
    return Mesh(dp, tp, DeviceMesh(device_type, grid, mesh_dim_names=("dp", "tp")))


def _param_spec(jax_shape) -> Optional[str]:
    """JAX's partition rule on a leaf's JAX shape: "tp" (shard the trailing,
    output-feature axis) when it is divisible by 4 and at least 8, else
    None (replicate)."""
    if len(jax_shape) >= 1 and jax_shape[-1] % 4 == 0 and jax_shape[-1] >= 8:
        return "tp"
    return None


def layout(model: nn.Module, tp: int) -> Dict[str, bool]:
    """{parameter name: sharded over tp?} for the port's UNet: the rule on
    each parameter's JAX leaf (``models.convert.leaf_map``), which JAX's
    ``shard_params`` then replicates where tp does not divide the axis."""
    from ..models.convert import jax_leaf_shape, leaf_map

    leaves = leaf_map(model.cfg)
    out = {}
    for name, p in model.named_parameters():
        _, kind, _ = leaves[name]
        shape = jax_leaf_shape(kind, p.shape)
        out[name] = _param_spec(shape) == "tp" and shape[-1] % tp == 0
    return out


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Place the UNet's parameters on the mesh, in place: each becomes a
    ``DTensor`` that is ``Replicate()`` over dp and ``Shard(0)`` or
    ``Replicate()`` over tp (:func:`layout`), this rank keeping its slice;
    then the model computes under the mesh (``tp.parallelize``). Every rank
    must hold the same full weights before. On the 1 x 1 mesh, and for a
    model other than the UNet at tp = 1, the model is returned as it is; such
    a model at tp > 1 raises (``tp.shardable``)."""
    from .tp import shardable

    if not shardable(model, mesh.tp) or mesh.device_mesh is None:
        return model
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ..models.nn import GroupNorm32
    from .tp import parallelize

    rank, size = mesh.index("tp"), mesh.tp
    sharded = layout(model, size)
    full_affines = {}
    for name, p in list(model.named_parameters()):
        module_name, _, leaf = name.rpartition(".")
        module = model.get_submodule(module_name)
        data = p.detach()
        if sharded[name]:
            if isinstance(module, GroupNorm32):
                full_affines[(module_name, leaf)] = data  # the replicated copy for compute
            step = data.shape[0] // size
            local = data.narrow(0, rank * step, step).clone()
            placement = Shard(0)
        else:
            local, placement = data, Replicate()
        dt = DTensor.from_local(local, mesh.device_mesh, [Replicate(), placement], run_check=False,
                                shape=data.shape, stride=data.stride())
        module._parameters[leaf] = nn.Parameter(dt, requires_grad=p.requires_grad)
    parallelize(model, mesh, full_affines)
    return model


def local_parameter_bytes(model: nn.Module) -> int:
    """Bytes of the parameters this rank holds (DTensors: its local shard)."""
    total = 0
    for p in model.parameters():
        local = p.to_local() if hasattr(p, "to_local") else p
        total += local.numel() * local.element_size()
    return total


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This dp rank's slice of the leading (batch) axis; the same on every
    tp rank. Raises where dp does not divide it, as JAX's ``device_put``
    does."""
    n = x.shape[0]
    if n % mesh.dp:
        raise ValueError(f"a batch of {n} does not split over dp={mesh.dp}")
    step = n // mesh.dp
    return x[mesh.index("dp") * step:(mesh.index("dp") + 1) * step]


class _DpSum(torch.autograd.Function):
    """Megatron's g for a reduced loss term: the sum over the dp group
    forward, the identity backward. Every dp rank then holds the same total
    and differentiates its own copy, so the gradient of its local partial
    sum is the gradient of the total; an all-reduce in the backward (as
    ``torch.distributed.nn.functional.all_reduce`` has) would make every
    gradient dp times too large."""

    @staticmethod
    def forward(ctx, t, group):
        total = t.clone()
        dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _reduces(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.dp > 1


def dp_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``t`` summed over the mesh's dp ranks (autograd goes through it, see
    :class:`_DpSum`); the tp ranks of one dp index hold the same slice and
    are not summed. ``t`` itself on the 1 x 1 mesh and with ``mesh=None``.
    Its downstream use must be the same on every dp rank (a replicated
    loss), which is what makes the identity backward right."""
    return _DpSum.apply(t, mesh.group("dp")) if _reduces(mesh) else t


def dp_mean(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean of ``t`` over every dp rank's elements: the local sum
    reduced by :func:`dp_sum` over the global element count (the ranks hold
    equal slices). ``t.mean()`` without dp."""
    return dp_sum(t.sum(), mesh) / (t.numel() * mesh.dp) if _reduces(mesh) else t.mean()


def gather_batch(t: torch.Tensor, mesh: Optional[Mesh], dim: int = 0) -> torch.Tensor:
    """Every dp rank's slice of ``t`` along ``dim``, concatenated in rank
    (and so image) order on every rank: the inverse of :func:`shard_batch`.
    ``t`` itself without dp."""
    if not _reduces(mesh):
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.dp)]
    dist.all_gather(parts, t, group=mesh.group("dp"))
    return torch.cat(parts, dim=dim)


def batch_sharding(mesh: Mesh):
    """The placements of a batch: ``Shard(0)`` over dp, ``Replicate()`` over
    tp."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0), Replicate()]


def replicated(mesh: Mesh):
    """The placements of a replicated value."""
    from torch.distributed.tensor import Replicate

    return [Replicate(), Replicate()]
