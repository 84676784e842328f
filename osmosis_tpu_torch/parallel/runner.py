"""The batched fleet runner (port of ``osmosis_tpu/parallel/runner.py``).

The JAX package ``vmap``s the batch-1 guided loop over a stack of images. The
port's loop already runs a batch, so the runner calls it once on all N
images with ``lane_separable=True``: the loss is the sum of per-image
losses, so each image ("lane") gets its batch-1 gradients, phi and optimizer
state, while the UNet runs one batch of N. Results keep the port's layout:
the sample, x0-hat and phi are [N, ...], the traces [T, N, ...];
:func:`lane` takes one image's batch-1 result out of them.

With ``mesh=`` (``parallel/mesh.make_mesh``) the N lanes shard over the
mesh's dp axis, as ``guided_sample_loop(mesh=)`` shards any batch: each dp
rank runs its ``shard_batch`` slice of them, and the result holds all N
lanes, in lane order, on every rank. Chain noise is drawn for all N lanes
and sliced, so a lane sees the noise it sees unsharded; the lanes' losses
are their own, so nothing is reduced over dp.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..diffusion.guided import (
    GuidanceConfig,
    GuidedResult,
    guided_sample_loop,
    keyed_noise_fn,
    map_tensors,
)
from ..diffusion.sampler import ModelFn, SamplerConfig
from ..diffusion.schedules import DiffusionSchedule
from ..guidance.operators import Operator
from ..guidance.phi_optim import make_phi_optimizer
from ..utils import profiling


def _broadcast_cold_start(operator: Operator, n: int, device):
    """The operator's cold phi init and optimizer state for each of ``n``
    lanes ([1, C] rows repeated to [n, C])."""
    phi1 = {k: torch.as_tensor(v, device=device) for k, v in operator.phi_init().items()}
    opt1 = make_phi_optimizer(operator.optimizer, operator.etas()).init(phi1)
    rep = lambda a: a.expand((n,) + tuple(a.shape[1:])).clone()  # noqa: E731
    return map_tensors(rep, phi1), map_tensors(rep, opt1)


def lane(res: GuidedResult, j: int) -> GuidedResult:
    """Image j's result out of a fleet result, with its batch-1 dim kept:
    sample, x0-hat, phi, optimizer state and eps history [1, ...], the loss
    and phi traces [T, 1, ...], the aux traces [T] (batch 1 has one aux value
    per step), the snapshots [K, 1, ...]."""
    row = lambda a: a[j:j + 1]  # noqa: E731
    col = lambda a: a[:, j:j + 1]  # noqa: E731
    return dataclasses.replace(
        res,
        sample=row(res.sample),
        pred_xstart=row(res.pred_xstart),
        phi=map_tensors(row, res.phi),
        sep_loss=col(res.sep_loss),
        phi_trace=map_tensors(col, res.phi_trace),
        aux_trace=map_tensors(lambda a: a[:, j], res.aux_trace),
        x0_std_trace=col(res.x0_std_trace),
        opt_state=map_tensors(row, res.opt_state),
        x0_snapshots=None if res.x0_snapshots is None else col(res.x0_snapshots),
        eps_hist=None if res.eps_hist is None else map_tensors(row, res.eps_hist),
    )


def make_batched_segment_runner(
    model_fn: ModelFn,
    schedule: DiffusionSchedule,
    operator: Operator,
    gcfg: GuidanceConfig,
    scfg: SamplerConfig = SamplerConfig(),
    sample_pattern: Optional[dict] = None,
    record_every: Optional[int] = None,
    progress_every: Optional[int] = None,
    mesh=None,
):
    """Returns ``run(xs, ys, seed=None, phi0s=None, opt0s=None,
    eta_scale=None, ts=None, buf0s=None, eps0s=None, noise_fn=None)``: the
    chain for N images, xs [N, H, W, 4] and ys [N, H, W, 3], ``operator`` at
    batch 1. Chain noise is keyed on ``seed`` and shared by the lanes, or
    ``noise_fn(t, shape, i)`` draws it for all lanes at once; with neither
    the chain is deterministic. ``phi0s``/``opt0s`` are per-lane warm starts
    ([N, C] rows: the previous global iteration's ``res.phi``/
    ``res.opt_state``); None starts cold. ``ts`` runs only those descending
    timesteps, from each lane's incoming x_t, snapshot buffer ``buf0s`` and
    ltsp eps history ``eps0s`` (None on the first segment); chaining segments
    reproduces the whole chain bit for bit (``progress_segments``,
    ``chain_checkpoint``). ``progress_every`` prints lane 0's loss and phi.
    ``mesh`` shards the lanes over dp (the module's docstring); every rank
    passes all N lanes and gets all N back. A call is a ``runner.segment``
    span under ``utils/profiling.tracing()``."""

    def run(xs, ys, seed=None, phi0s=None, opt0s=None, eta_scale=None,
            ts: Optional[Sequence[int]] = None, buf0s=None, eps0s=None, noise_fn=None):
        with profiling.span("runner.segment", lanes=xs.shape[0]):
            if noise_fn is None and seed is not None:
                # one draw broadcast to every lane: lane j sees image j's batch-1 noise
                noise_fn = keyed_noise_fn(seed, xs.device, xs.dtype, shared_lanes=True)
            cold_phi, cold_opt = _broadcast_cold_start(operator, xs.shape[0], xs.device)
            return guided_sample_loop(
                model_fn, schedule, xs, ys, operator, gcfg, scfg,
                sample_pattern=sample_pattern, record_every=record_every,
                deterministic=noise_fn is None,
                phi_init=cold_phi if phi0s is None else phi0s,
                # None is also the global_opt_reset path: a warm phi, cold moments
                opt_state_init=cold_opt if opt0s is None else opt0s,
                noise_fn=noise_fn, eta_scale=eta_scale, ts=ts, x0_buf_init=buf0s,
                eps_hist_init=eps0s, lane_separable=True, progress_every=progress_every,
                mesh=mesh,
            )

    return run


def make_batched_guided_runner(
    model_fn: ModelFn,
    schedule: DiffusionSchedule,
    operator: Operator,
    gcfg: GuidanceConfig,
    scfg: SamplerConfig = SamplerConfig(),
    sample_pattern: Optional[dict] = None,
    record_every: Optional[int] = None,
    mesh=None,
):
    """The whole chain for N images: :func:`make_batched_segment_runner`'s
    ``run`` without a segment, ``run(xs, ys, seed=None, phi0s=None,
    opt0s=None, eta_scale=None, noise_fn=None)``; ``mesh`` as there."""
    seg = make_batched_segment_runner(model_fn, schedule, operator, gcfg, scfg,
                                      sample_pattern, record_every, mesh=mesh)

    def run(xs, ys, seed=None, phi0s=None, opt0s=None, eta_scale=None, noise_fn=None):
        return seg(xs, ys, seed, phi0s, opt0s, eta_scale, noise_fn=noise_fn)

    return run
