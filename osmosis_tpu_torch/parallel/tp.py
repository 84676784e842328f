"""Tensor-parallel execution of the UNet over a mesh's tp axis, by hand.

``mesh.shard_params`` leaves each parameter a ``DTensor``, ``Shard(0)``
(this rank's slice of the output features) or ``Replicate()`` over tp. A
layer whose weight is sharded (a conv, a Linear, a 1x1 Conv1d) computes its
own output-channel slice from the whole input with its local weights, and an
all-gather along channels makes the output whole again before anything else
reads it; everything else (K3/K4 at every GroupNorm site with the whole
affine, K1/K2, attention's head views, the FiLM split of the embedding
projection) then runs on whole tensors on every tp rank. So each rank runs
every kernel site, and a sharded model computes what the unsharded one does
up to the order of the convolutions' sums.

Megatron's pair of operators, written as autograd functions over
``all_gather`` and ``all_reduce`` only (gloo has both, on CUDA tensors too):

  * :class:`Gather` (g): all-gather forward; this rank's slice of the
    gradient backward;
  * :class:`Enter` (f): identity forward; all-reduce (sum) over tp backward,
    on the replicated input of a sharded layer, whose pullback on each rank
    holds only its slice's part of the input's gradient.

DTensor's own sharding propagation is not used: its convolution with a
``Shard(0)`` weight and a replicated input raises (torch 2.13 on the CPU:
the bias's size against the local output's). The layers are not replaced: forward hooks
put the local weights (or, for a GroupNorm, the whole affine) in place of
the DTensors for the call and restore them after, so module names, the
state_dict and the placements stay readable. A model under tp is not for
concurrent calls from several threads.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch import nn

from ..models.unet import TokenConv1d, UNetModel


def _channels_last_view(t: torch.Tensor) -> torch.Tensor:
    """A 4-D NCHW tensor as NHWC, contiguous (free for channels_last memory);
    any other tensor contiguous. Channels are then the last axis."""
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).contiguous()


def _back(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t.permute(0, 3, 1, 2) if dim == 4 else t


class Gather(torch.autograd.Function):
    """g: the output channels of every tp rank, concatenated in rank order
    (channels are dim 1 of a 4-D NCHW tensor, else the last dim)."""

    @staticmethod
    def forward(ctx, y, group, rank, size):
        ctx.rank, ctx.dim = rank, y.dim()
        local = _channels_last_view(y)
        ctx.width = local.shape[-1]
        parts = [torch.empty_like(local) for _ in range(size)]
        dist.all_gather(parts, local, group=group)
        return _back(torch.cat(parts, dim=-1), ctx.dim)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.width
        return grad.narrow(1 if ctx.dim == 4 else -1, lo, ctx.width), None, None, None


class Enter(torch.autograd.Function):
    """f: the input of a sharded layer as it is; its gradient summed over
    the tp ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        dim = grad.dim()
        total = _channels_last_view(grad).clone()
        dist.all_reduce(total, group=ctx.group)
        return _back(total, dim), None


SHARDABLE = (nn.Conv2d, nn.Linear, TokenConv1d)


def shardable(model: nn.Module, size: int) -> bool:
    """Does ``mesh.shard_params`` place ``model`` on the mesh? The ADM UNet,
    yes. Any other model (a DiT preset's) is left whole on every rank at
    tp = 1 and refused at tp > 1: tp shards the UNet alone."""
    if isinstance(model, UNetModel):
        return True
    if size > 1:
        raise NotImplementedError(
            f"tensor parallelism (tp = {size}) shards the ADM UNet only, not a "
            f"{type(model).__name__}: run this preset with tp = 1")
    return False


def _pre(module, args, kwargs, *, compute, tp):
    module._tp_saved = dict(module._parameters)
    module._parameters.update(compute)
    if tp is not None:
        args = (Enter.apply(args[0], tp[0]),) + tuple(args[1:])
    return args, kwargs


def _post(module, args, kwargs, output, *, tp):
    module._parameters.update(module._tp_saved)
    del module._tp_saved
    if tp is not None and output is not None:  # None: the forward raised
        return Gather.apply(output, *tp)
    return output


def parallelize(model: nn.Module, mesh, full_affines: dict) -> None:
    """Hooks on every module that holds parameters of ``model`` (already
    placed by ``mesh.shard_params``): its local tensors for the call, the
    whole affines of sharded GroupNorms from ``full_affines`` ({(module
    name, "weight"|"bias"): tensor}), and f/g around a sharded layer."""
    group, rank, size = mesh.group("tp"), mesh.index("tp"), mesh.tp
    for name, module in model.named_modules():
        params = dict(module.named_parameters(recurse=False))
        if not params:
            continue
        compute = {leaf: full_affines.get((name, leaf), p.to_local()) for leaf, p in params.items()}
        sharded = (isinstance(module, SHARDABLE) and size > 1
                   and module.weight.placements[1].is_shard())
        tp = (group, rank, size) if sharded else None
        module.register_forward_pre_hook(functools.partial(_pre, compute=compute, tp=tp),
                                         with_kwargs=True)
        module.register_forward_hook(functools.partial(_post, tp=tp), with_kwargs=True,
                                     always_call=True)
