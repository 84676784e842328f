"""Guided (osmosis / DPS) sampling: the reverse chain with physics guidance
(port of ``osmosis_tpu/diffusion/guided.py``; reference
gaussian_diffusion.py:179-340 and condition_methods.py:35-251).

An osmosis step (``osmosis_guided``, guided.py:372-448) runs:
  1. the UNet forward on x, giving x0-hat and the learned variance; with
     autograd on (weights frozen) only where the step takes the x_prev
     gradient;
  2. the phi warm phase's extra phi-only steps where the pattern has one,
     then ``n_iter - 1`` phi-only optimizer steps against a detached x0-hat,
     skipped where the pcgs pattern freezes phi;
  3. the joint gradient of the guidance loss with respect to (x0-hat, phi)
     and the phi update (again only where phi is not frozen). An x_prev step
     pulls the x0-hat cotangent back through the UNet to x ONCE and clips it
     to ±``gradient_clip_value``; an x0 step guides with the x0-hat gradient
     itself, never clipped;
  4. ``x_{t-1} = mean - scale·grad``, then noise after guidance,
     ``x + [t>0]·exp(½·logvar)·z``. The ``ltsp`` sampler replaces this with
     a PLMS4 / DDIM(eta=0) diffusion substep on eps, then the guidance.

Steps outside the guidance window run the plain posterior update. A 'ps'
(DPS) step draws its noise first (DDPM or DDIM), then guides with the
gradient of ``‖y − x0-hat‖`` (gaussian) or its poisson form. The hybrid
schedule (``x_prev_every = k``) takes the x_prev gradient at chain positions
0, k, 2k, ... and the x0 gradient between. With ``local_M > 1`` a step
repeats ``alternate_len[t]`` times at the same t.

The pcgs masks are numpy arrays read on the host, so no step waits on the
device for a branch. Traces (per-step loss, phi, aux losses, x0-hat std)
stay on the device until the chain ends.

A chain runs as one call or as segments (``ts``): each segment takes the
previous one's sample, phi, optimizer state, snapshot buffer and eps
history, and noise keyed on (seed, t, i) (:func:`keyed_noise_fn`) gives
every step the same draw wherever the chain was cut, so segments, and a
chain resumed from a saved boundary, reproduce the single call bit for bit.
At batch B > 1 the guidance loss couples the images (one norm over the
batch, as the JAX loop computes it); ``lane_separable=True`` sums per-image
losses instead, so each image gets the gradients it has at batch 1: the
fleet (``osmosis_tpu_torch.parallel.runner``) runs that way.

With ``mesh=`` (``parallel/mesh.make_mesh``) the batch shards over the
mesh's dp axis, as GSPMD shards the JAX loop's: each dp rank runs its
``shard_batch`` slice of the images (and of phi, the optimizer state and the
carried buffers), draws chain noise for the whole batch and keeps its
slice, and reduces every batch-wide term of the joint loss over the dp
group (``dp_sum`` / ``dp_mean``: the norm's sum of squares, the mse and aux
sums, the means over the global element count). The per-image results are
all-gathered in image order at the end, so every rank returns what one
process returns for the whole batch, up to the order of the reductions' sums.
A tensor-parallel model (``mesh.shard_params``) runs under it as it is.

Under ``utils/profiling.tracing()`` a call is a ``guided.segment`` span,
each step a ``guided.step`` span holding the UNet's ``unet.forward`` and
the step's ``guided.phi_fit`` (the warm phase and the phi-only iterations),
``guided.joint_grad`` and, on x_prev steps, ``guided.pullback``. The
counters ``guided.steps``, ``guided.x_prev_steps`` (steps that pulled back
through the UNet), ``guided.phi_iters`` (every phi update),
``guided.phi_fits`` (steps with phi-only iterations) and
``guided.phi_fits_k5`` (those that K5 ran) always count.

A step's phi-only iterations run as one launch of kernel K5
(``ops/phi_fit``) wherever it computes what the eager loop computes: CUDA
fp32 tensors, a physics operator under SGD, and a loss whose phi gradient is
each image's own (:func:`_k5_route` decides). Everywhere else (the CPU, Adam
and RMSprop, a dp mesh, the joint norm over a batch) the eager loop runs
them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import parse_gradient_clip, parse_scale, parse_weight_function
from ..guidance.losses import make_aux_loss_fn
from ..guidance.operators import Operator, convert_depth
from ..guidance.phi_optim import make_phi_optimizer
from ..guidance.schedule_masks import pattern_masks
from ..ops import phi_fit as k5
from ..parallel.mesh import dp_mean, dp_sum, gather_batch, shard_batch
from ..registry import CONDITIONERS
from ..utils import profiling
from .sampler import (
    ModelFn,
    SamplerConfig,
    ddim_step,
    ddpm_noise_step,
    device_constants,
    make_slot_map,
    model_log_variance,
    p_mean_variance,
    posterior_mean,
    predict_xstart,
    process_xstart,
    record_steps_for,
    record_update,
    split_model_output,
)
from .schedules import DiffusionSchedule

# (t, shape) -> z, or (t, shape, i) -> z for the i-th repeat (i > 0) of a
# step under local_M > 1 alternation
NoiseFn = Callable[..., torch.Tensor]

_U64 = (1 << 64) - 1


def map_tensors(fn, tree):
    """``fn`` on every tensor of a tree of dicts, tuples and lists; other
    leaves (the Adam step count) pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def draw_seed(seed: int, *path: int) -> int:
    """A 63-bit generator seed derived from ``seed`` and a path of integers,
    the port's counterpart of ``fold_in(key, ...)``: distinct paths give
    independent streams."""
    words = np.random.SeedSequence([int(seed) & _U64, *path]).generate_state(2, np.uint32)
    return ((int(words[0]) << 32) | int(words[1])) >> 1


def keyed_noise_fn(seed: int, device, dtype=torch.float32, shared_lanes: bool = False) -> NoiseFn:
    """Chain noise keyed on (seed, t, i): the draw at step t (repeat i) is a
    standard normal from a generator seeded by ``draw_seed(seed, 1, t, i)``,
    whatever steps ran before it. With ``shared_lanes`` one lane is drawn and
    broadcast to every lane of the batch (the fleet: lane j then sees the
    noise of image j's batch-1 chain)."""

    def noise_fn(t, shape, i=0):
        gen = torch.Generator(device=device).manual_seed(draw_seed(seed, 1, int(t), int(i)))
        one = (1,) + tuple(shape[1:]) if shared_lanes else tuple(shape)
        z = torch.randn(one, generator=gen, device=device, dtype=dtype)
        return z.expand(tuple(shape)) if shared_lanes else z

    return noise_fn

CONDITIONERS.register("osmosis")("osmosis")
CONDITIONERS.register("ps")("ps")


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """conditioning.params + sample_pattern surface (condition_methods.py:63-107)."""

    method: str = "osmosis"
    scale: Tuple[float, ...] = (1.0,)
    gradient_x_prev: bool = False
    x_prev_every: int = 1
    noiser_name: str = "gaussian"
    gradient_clip: bool = False
    gradient_clip_value: float = 0.0
    loss_function: str = "norm"  # 'norm' | 'mse'
    loss_weight: Optional[str] = None  # 'depth' | 'none'
    weight_function: Optional[str] = None  # e.g. "gamma,1.4,1.4,1"
    n_iter: int = 1
    aux_loss: Tuple[Tuple[str, float], ...] = ()

    @classmethod
    def from_config(cls, method: str, params: dict, sample_pattern: dict,
                    aux_loss_cfg: Optional[dict],
                    noiser_name: str = "gaussian") -> "GuidanceConfig":
        clip_on, clip_val = parse_gradient_clip(params.get("gradient_clip", "False"))
        aux = ()
        if aux_loss_cfg:
            inner = aux_loss_cfg.get("aux_loss") if "aux_loss" in aux_loss_cfg else aux_loss_cfg
            if inner:
                aux = tuple((k, float(v)) for k, v in inner.items())
        CONDITIONERS.get(method)  # unknown names fail fast, like the reference
        return cls(
            method=method,
            scale=tuple(float(s) for s in parse_scale(params.get("scale", 1.0))),
            gradient_x_prev=bool(params.get("gradient_x_prev", False)),
            x_prev_every=int(params.get("x_prev_every", 1)),
            gradient_clip=clip_on,
            gradient_clip_value=clip_val,
            loss_function=params.get("loss_function", "norm"),
            loss_weight=params.get("loss_weight"),
            weight_function=params.get("weight_function"),
            n_iter=int((sample_pattern or {}).get("n_iter", 1)),
            aux_loss=aux,
            noiser_name=noiser_name,
        )


@dataclasses.dataclass
class GuidedResult:
    sample: torch.Tensor            # final x (the chain's output after noise)
    pred_xstart: torch.Tensor       # x0-hat at the final step: what gets saved
    phi: Dict[str, torch.Tensor]    # final water parameters [B, C]
    sep_loss: torch.Tensor          # [T, B] per-image guidance loss
    phi_trace: Dict[str, torch.Tensor]  # [T, B, C]
    aux_trace: Dict[str, torch.Tensor]  # [T]
    x0_std_trace: torch.Tensor      # [T, B] x0-hat amplitude
    opt_state: dict                 # final phi-optimizer state (global_N warm starts)
    x0_snapshots: Optional[torch.Tensor] = None  # [K, B, H, W, 4]
    # ltsp only: the final PLMS eps history, most recent first
    eps_hist: Optional[Tuple[torch.Tensor, ...]] = None
    snapshot_steps: Tuple[int, ...] = ()

    @property
    def snapshots(self) -> Optional[dict]:
        if self.x0_snapshots is None:
            return None
        return {"steps": self.snapshot_steps, "x0_hat": self.x0_snapshots}


def _check_config(gcfg: GuidanceConfig, scfg: SamplerConfig, T: int, never_alternates: bool):
    """The JAX loop's refusals (guided.py:248-259, :345-350, :666-671)."""
    if gcfg.x_prev_every > 1 and not gcfg.gradient_x_prev and gcfg.method != "ps":
        raise ValueError(
            "x_prev_every > 1 requires gradient_x_prev: True — with "
            "gradient_x_prev: False every step already uses the x0 gradient")
    if _hybrid(gcfg) and gcfg.x_prev_every >= T:
        raise ValueError(
            f"x_prev_every={gcfg.x_prev_every} must be < the chain length ({T} steps)")
    if scfg.sampler == "ltsp":
        if gcfg.method != "osmosis":
            raise NotImplementedError("ltsp splitting implements the 'osmosis' path")
        if not never_alternates:
            raise NotImplementedError("ltsp requires local_M == 1 patterns")
    if gcfg.method == "ps" and gcfg.noiser_name not in ("gaussian", "poisson"):
        # 'clean' etc. raise in the reference too (condition_methods.py:50)
        raise NotImplementedError(
            f"'ps' conditioning does not support noiser '{gcfg.noiser_name}'")
    if gcfg.loss_function not in ("norm", "mse"):
        raise NotImplementedError(gcfg.loss_function)


def _hybrid(gcfg: GuidanceConfig) -> bool:
    return gcfg.x_prev_every > 1 and (gcfg.gradient_x_prev or gcfg.method == "ps")


def _plms_coeffs(T: int) -> np.ndarray:
    """Adams-Bashforth coefficients on eps, by timestep: AB1..AB3 warm-up,
    then AB4 (guided.py:351-361)."""
    ab = np.zeros((T, 4), np.float32)
    for t in range(T):
        j = T - 1 - t  # step index along the reverse chain
        ab[t] = ([1.0, 0.0, 0.0, 0.0] if j == 0 else [1.5, -0.5, 0.0, 0.0] if j == 1
                 else [23 / 12, -16 / 12, 5 / 12, 0.0] if j == 2
                 else [55 / 24, -59 / 24, 37 / 24, -9 / 24])
    return ab


# the operators K5 takes, and their phi names in its order: a, b, inf, or
# ab, inf where one ``phi_ab`` feeds both exponentials
_K5_PHI = {"underwater_physical_revised": ("phi_a", "phi_b", "phi_inf"),
           "underwater_physical": ("phi_ab", "phi_inf"),
           "haze_physical": ("phi_ab", "phi_inf")}


def _k5_conversion(kind, value) -> Optional[k5.Conv]:
    """``convert_depth(d, kind, value)`` as K5's (code, v0, v1, v2), or None
    for a conversion it lacks."""
    if kind is not None and kind not in k5.CONVERSIONS:
        return None
    code = k5.CONVERSIONS.get(kind, 0)
    if code == 0:
        return (0, 0.0, 0.0, 0.0)
    v = np.asarray(value, dtype=np.float64).reshape(-1)
    if v.size != (3 if code == 1 else 1):
        return None
    return (code, *(float(x) for x in v), *(0.0,) * (3 - v.size))


def _k5_route(operator: Operator, phi: Dict[str, torch.Tensor], x0: torch.Tensor,
              y: torch.Tensor, gcfg: GuidanceConfig, eta_scale: Optional[float],
              lane_separable: bool, mesh) -> Optional[k5.Fit]:
    """The route of a step's phi-only iterations: the :class:`~ops.phi_fit.Fit`
    that K5 runs them with on the card, or None where the eager loop runs
    them. The CPU, where the JAX parity tests run, keeps the eager loop."""
    if x0.device.type != "cuda":
        return None
    return _k5_fit(operator, phi, x0, y, gcfg, eta_scale, lane_separable, mesh)


def _k5_fit(operator: Operator, phi: Dict[str, torch.Tensor], x0: torch.Tensor,
            y: torch.Tensor, gcfg: GuidanceConfig, eta_scale: Optional[float],
            lane_separable: bool, mesh) -> Optional[k5.Fit]:
    """:func:`_k5_route` on any device: the Fit where K5 computes what the
    eager loop computes, else None. It takes fp32 tensors, a physics
    operator under SGD, a depth conversion and a loss weight it knows, phi of
    1 or 3 entries an image, and a loss whose phi gradient is each image's
    own: one image, a sum of per-image losses (``lane_separable``, or the
    mse, a sum of per-image means), and no dp group to reduce over."""
    names = _K5_PHI.get(getattr(operator, "name", None))
    per_image = (mesh is None or mesh.dp == 1) and (
        lane_separable or x0.shape[0] == 1 or gcfg.loss_function == "mse")
    if (names is None or not per_image or (operator.optimizer or "sgd").lower() not in ("sgd", "gd")
            or x0.dtype != torch.float32 or y.dtype != torch.float32 or y.device != x0.device
            or gcfg.loss_function not in ("norm", "mse") or sorted(phi) != sorted(names)):
        return None
    depth = _k5_conversion(operator.depth_type, operator.depth_value)
    if gcfg.loss_weight in (None, "none"):
        weight = k5.ONE
    elif gcfg.loss_weight == "depth":
        weight = _k5_conversion(*parse_weight_function(gcfg.weight_function))
    else:
        weight = None
    if depth is None or weight is None:
        return None
    etas = []
    all_etas = operator.etas()
    for name in names:
        p = phi[name]
        if (p.dim() != 2 or p.shape[1] not in (1, 3) or p.dtype != torch.float32
                or p.device != x0.device):
            return None
        eta = np.asarray(all_etas[name], dtype=np.float32).reshape(-1)
        if eta.size not in (1, p.shape[1]):
            return None
        etas.append(tuple(float(e) for e in np.broadcast_to(eta, (p.shape[1],))))
    return k5.Fit(names, tuple(etas), depth, weight, gcfg.loss_function == "mse",
                  None if eta_scale is None else float(eta_scale))


def _make_weight_fn(gcfg: GuidanceConfig):
    """set_loss_weight (utils.py:674-700): depth-derived weights on the
    guidance difference, always from a detached x0-hat."""
    if gcfg.loss_weight in (None, "none"):
        return lambda x0: 1.0
    if gcfg.loss_weight == "depth":
        fn_str, value = parse_weight_function(gcfg.weight_function)
        return lambda x0: convert_depth(x0[..., 3:4].detach(), fn_str, value)
    raise NotImplementedError(gcfg.loss_weight)


def guided_sample_loop(
    model_fn: ModelFn,
    schedule: DiffusionSchedule,
    x_init: torch.Tensor,
    measurement: torch.Tensor,
    operator: Operator,
    gcfg: GuidanceConfig,
    scfg: SamplerConfig = SamplerConfig(),
    sample_pattern: Optional[dict] = None,
    record_every: Optional[int] = None,
    deterministic: bool = False,
    phi_init: Optional[Dict[str, torch.Tensor]] = None,
    opt_state_init: Optional[dict] = None,
    noise_fn: Optional[NoiseFn] = None,
    eps_hist_init: Optional[Tuple[torch.Tensor, ...]] = None,
    seed: Optional[int] = None,
    eta_scale: Optional[float] = None,
    ts: Optional[Sequence[int]] = None,
    x0_buf_init: Optional[torch.Tensor] = None,
    lane_separable: bool = False,
    progress_every: Optional[int] = None,
    mesh=None,
) -> GuidedResult:
    """Run the guided reverse process (or a segment of it). Tensors NHWC.

    ``deterministic=True`` adds no noise (the chain follows posterior means).
    Otherwise each step's noise is ``noise_fn(t, shape)`` when given (tests
    feed the JAX package's ``normal(fold_in(fold_in(key, t), i))`` draws
    through it; the i-th repeat of a step under local_M > 1 alternation calls
    ``noise_fn(t, shape, i)`` for i > 0), else a draw keyed on (``seed``, t,
    i) (:func:`keyed_noise_fn`).
    ``phi_init``/``opt_state_init`` warm-start phi and its optimizer state
    (global_N > 1 restarts); ``eps_hist_init`` the ltsp sampler's eps
    history.

    ``eta_scale`` multiplies every phi step (``global_eta_scale``; 0 freezes
    phi). ``ts`` runs only that descending slice of the chain's timesteps,
    from ``x_init`` as the incoming x_t and ``x0_buf_init`` as the incoming
    snapshot buffer; the hybrid schedule places its x_prev steps by position
    within the slice, so callers cut non-final segments at multiples of
    ``x_prev_every``. ``lane_separable`` makes the loss the sum of per-image
    losses (aux terms included; aux traces then [T, B]). ``progress_every``
    prints the loss and phi of the first image at every timestep divisible
    by it (a host sync each time). ``mesh`` shards the batch over its dp
    axis (the module's docstring): every rank passes the whole batch and
    its whole-batch arguments, and gets the whole result back.
    """
    T = schedule.num_timesteps
    steps = range(T - 1, -1, -1) if ts is None else [int(t) for t in ts]
    with profiling.span("guided.segment", steps=len(steps), lanes=x_init.shape[0],
                        t_first=steps[0], t_last=steps[-1]):
        device = x_init.device
        n = x_init.shape[0]
        sharded = mesh is not None and mesh.dp > 1
        if sharded:
            x_init, measurement = shard_batch(x_init, mesh), shard_batch(measurement, mesh)
        B = x_init.shape[0]
        rows = lambda a, dim=0: a.narrow(dim, mesh.index("dp") * B, B)  # noqa: E731
        masks = pattern_masks(sample_pattern, T)
        always_guided = bool(masks["guidance"].all())
        never_alternates = bool((masks["alternate_len"] == 1).all())
        _check_config(gcfg, scfg, T, never_alternates)
        ps = gcfg.method == "ps"
        ltsp = scfg.sampler == "ltsp"
        if not deterministic and noise_fn is None:
            if seed is None:
                raise ValueError("a stochastic chain needs a seed or a noise_fn")
            noise_fn = keyed_noise_fn(seed, device, x_init.dtype)
        if sharded and noise_fn is not None:
            # drawn for the whole batch: an image's noise is its own
            whole = noise_fn
            noise_fn = lambda t, shape, *i: rows(  # noqa: E731
                whole(t, (n,) + tuple(shape[1:]), *i))

        def draw(t, shape, i):
            return noise_fn(t, shape) if i == 0 else noise_fn(t, shape, i)

        consts = device_constants(schedule, device)
        aux_fn = make_aux_loss_fn(dict(gcfg.aux_loss))
        aux_names = [k for k, _ in gcfg.aux_loss]
        zero_aux = {k: torch.zeros((B,) if lane_separable else (), device=device)
                    for k in aux_names}
        weight_fn = _make_weight_fn(gcfg)
        scale = torch.tensor(gcfg.scale, dtype=torch.float32, device=device)
        scale = scale[0] if scale.numel() == 1 else scale.reshape(1, 1, 1, -1)

        src = phi_init if phi_init is not None else operator.phi_init()
        phi = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in src.items()}
        if sharded:
            phi, opt_state_init, eps_hist_init = (
                None if v is None else map_tensors(rows, v)
                for v in (phi, opt_state_init, eps_hist_init))
            x0_buf_init = None if x0_buf_init is None else rows(torch.as_tensor(x0_buf_init), 1)
        opt = make_phi_optimizer(operator.optimizer, operator.etas())
        opt_state = opt_state_init if opt_state_init is not None else opt.init(phi)
        if eta_scale is not None:
            # every phi step times a scalar: p + s·(p' − p), as the JAX loop does
            # (guided.py:288-305); the optimizer state evolves as without it
            s_eta = torch.tensor(float(eta_scale), dtype=torch.float32, device=device)
            base_update = opt.update

            def scaled_update(phi_, g_, st_):
                new, st2 = base_update(phi_, g_, st_)
                return {k: phi_[k] + s_eta * (new[k] - phi_[k]) for k in phi_}, st2

            opt = dataclasses.replace(opt, update=scaled_update)
        y = measurement
        # the batch-wide reductions of the joint loss span every dp rank's images
        red = (lambda t: t) if lane_separable else (lambda t: dp_sum(t, mesh))  # noqa: E731

        def loss_terms(x0, phi_):
            degraded = 2.0 * operator.forward(phi_, x0) - 1.0
            diff = ((y - degraded) * weight_fn(x0)).float()
            if gcfg.loss_function == "norm":
                sep = torch.sqrt(torch.sum(diff ** 2, dim=(1, 2, 3)))
                loss = torch.sum(sep) if lane_separable else torch.sqrt(red(torch.sum(diff ** 2)))
            else:
                sep = torch.mean(diff ** 2, dim=(1, 2, 3))
                loss = red(torch.sum(sep))
            aux = {}
            if aux_fn is not None:
                aux_total, aux = aux_fn(x0, per_lane=lane_separable, mesh=mesh)
                loss = loss + aux_total
            return loss, sep, aux

        def grads(x0, phi_, wrt_x0: bool):
            """Gradient of the guidance loss w.r.t. phi (and x0-hat), at leaves."""
            leaves = {k: v.detach().requires_grad_(True) for k, v in phi_.items()}
            x0_leaf = x0.detach().requires_grad_(wrt_x0)
            with torch.enable_grad():
                total, sep, aux = loss_terms(x0_leaf, leaves)
                wrt = ([x0_leaf] if wrt_x0 else []) + list(leaves.values())
                gs = torch.autograd.grad(total, wrt) if wrt else ()
            g_x0 = gs[0] if wrt_x0 else None
            g_phi = dict(zip(leaves, gs[1:] if wrt_x0 else gs))
            return g_x0, g_phi, sep.detach(), {k: aux[k].detach() for k in aux_names}

        def ps_loss_grad(x0):
            """condition_methods.py:35-53: the loss ([B] per image with
            ``lane_separable``, else one value for the batch) and the x0-hat
            gradient of its sum."""
            x0_leaf = x0.detach().requires_grad_(True)
            dims = (1, 2, 3)
            with torch.enable_grad():
                if gcfg.noiser_name == "gaussian":  # ‖y − A(x0[..., :3])‖
                    diff = (y - operator.forward({}, x0_leaf[..., 0:3])).float()
                    loss = (torch.sqrt(torch.sum(diff ** 2, dim=dims)) if lane_separable
                            else torch.sqrt(red(torch.sum(diff ** 2))))
                else:  # poisson: over the FULL x0, no RGB slice (condition_methods.py:43-48)
                    diff = (y - operator.forward({}, x0_leaf)).float()
                    if lane_separable:
                        norm = torch.sqrt(torch.sum(diff ** 2, dim=dims)).reshape(-1, 1, 1, 1)
                        loss = torch.mean(norm / torch.abs(y.float()), dim=dims)
                    else:  # mean(norm / |y|) as norm * mean(1 / |y|): every rank then uses
                        # the reduced norm alike, which dp_sum's identity backward needs
                        norm = torch.sqrt(red(torch.sum(diff ** 2)))
                        loss = norm * dp_mean(1.0 / torch.abs(y.float()), mesh)
                (g_x0,) = torch.autograd.grad(loss.sum(), x0_leaf)
            return loss.detach(), g_x0

        def unet_x0(x, tb, use_x_prev):
            """x0-hat and the variance channels; with ``use_x_prev`` also the
            autograd leaf x and the graph of x0-hat over it (the pullback)."""
            xg = x.detach().requires_grad_(use_x_prev)
            with torch.set_grad_enabled(use_x_prev):
                eps, v = split_model_output(model_fn(xg, consts["model_timesteps"][tb]),
                                            x.shape[-1])
                x0_graph = process_xstart(predict_xstart(xg, tb, eps, consts, scfg), scfg)
            return xg, x0_graph, v.detach()

        def pullback(xg, x0_graph, g_x0):
            """The one pullback through the UNet: the cotangent of x0-hat alone,
            i.e. a zero cotangent for the variance channels."""
            (g_x,) = torch.autograd.grad(x0_graph, xg, g_x0)
            return g_x

        def osmosis_guided(x, phi_, st, t, tb, use_x_prev):
            xg, x0_graph, v = unet_x0(x, tb, use_x_prev)
            x0 = x0_graph.detach()
            logvar = model_log_variance(v, tb, consts, scfg)
            mean = posterior_mean(x0, x, tb, consts)
            freeze = bool(masks["freeze_phi"][t])
            # the phi warm phase, then the inner phi-only iterations
            # (condition_methods.py:193-194)
            n_inner = int(masks["phi_warmup"][t]) + (0 if freeze else gcfg.n_iter - 1)
            with profiling.span("guided.phi_fit", iterations=n_inner):
                fit = None
                if n_inner:
                    profiling.count("guided.phi_fits")
                    fit = _k5_route(operator, phi_, x0, y, gcfg, eta_scale, lane_separable, mesh)
                if fit is not None:
                    phi_ = k5.phi_fit(x0.contiguous(), y.contiguous(), phi_, fit, n_inner)
                    profiling.count("guided.phi_fits_k5")
                else:
                    for _ in range(n_inner):
                        _, g_phi, _, _ = grads(x0, phi_, wrt_x0=False)
                        phi_, st = opt.update(phi_, g_phi, st)
            with profiling.span("guided.joint_grad"):
                g_x0, g_phi, sep, aux_vec = grads(x0, phi_, wrt_x0=True)
                if not freeze:
                    phi_, st = opt.update(phi_, g_phi, st)
            profiling.count("guided.phi_iters", n_inner + (not freeze))
            if use_x_prev:
                with profiling.span("guided.pullback"):
                    g_used = pullback(xg, x0_graph, g_x0)
                    if gcfg.gradient_clip:
                        g_used = torch.clamp(g_used, -gcfg.gradient_clip_value,
                                             gcfg.gradient_clip_value)
            else:  # the x0-hat gradient, never clipped (condition_methods.py:227-229)
                g_used = g_x0
            guidance = scale * g_used
            return mean - guidance, logvar, x0, guidance, phi_, st, sep, aux_vec

        def plain_update(x, phi_, st, t, tb):
            with torch.no_grad():
                out = p_mean_variance(model_fn, x, tb, consts, scfg)
            return (out["mean"], out["log_variance"], out["pred_xstart"], torch.zeros_like(x),
                    phi_, st, torch.zeros((B,), device=device), zero_aux)

        def ps_step(x, t, tb, i, use_x_prev):
            xg, x0_graph, v = unet_x0(x, tb, use_x_prev)
            x0 = x0_graph.detach()
            out = {"mean": posterior_mean(x0, x, tb, consts),
                   "log_variance": model_log_variance(v, tb, consts, scfg), "pred_xstart": x0}
            # noise FIRST (p_sample, gaussian_diffusion.py:232-233,494-502)
            if deterministic:
                sample = out["mean"]
            elif scfg.sampler == "ddim":
                sample = ddim_step(x, out, tb, draw(t, tuple(x.shape), i), consts, scfg.ddim_eta)
            else:
                sample = ddpm_noise_step(out, tb, draw(t, tuple(x.shape), i))
            with profiling.span("guided.joint_grad"):
                loss, g_x0 = ps_loss_grad(x0)
            g_used = g_x0
            if use_x_prev:
                with profiling.span("guided.pullback"):
                    g_used = pullback(xg, x0_graph, g_x0)
            return sample - scale * g_used, x0, loss.expand(B) if loss.dim() == 0 else loss

        if ltsp:
            plms = torch.from_numpy(_plms_coeffs(T)).to(device)
            if eps_hist_init is not None:
                eps_hist = tuple(torch.as_tensor(e, device=device) for e in eps_hist_init)
            else:
                eps_hist = tuple(torch.zeros_like(x_init) for _ in range(3))

        def one_iteration(x, phi_, st, t, tb, i, use_x_prev):
            """One update at t: (x_next, phi, opt state, x0-hat, sep, aux, eps_t)."""
            if ps:
                x_next, x0, sep = ps_step(x, t, tb, i, use_x_prev)
                return x_next, phi_, st, x0, sep, zero_aux, None
            if always_guided or masks["guidance"][t]:
                upd = osmosis_guided(x, phi_, st, t, tb, use_x_prev)
            else:
                upd = plain_update(x, phi_, st, t, tb)
            x_t, logvar, x0, guidance, phi_, st, sep, aux_vec = upd
            if ltsp:
                # Lie-Trotter split: (a) the PLMS / DDIM(eta=0) diffusion substep
                # on eps, (b) the first-order guidance substep
                sra = consts["sqrt_recip_alphas_cumprod"][tb].reshape(-1, 1, 1, 1)
                srm1 = consts["sqrt_recipm1_alphas_cumprod"][tb].reshape(-1, 1, 1, 1)
                ab_prev = consts["alphas_cumprod_prev"][tb].reshape(-1, 1, 1, 1)
                eps_t = (sra * x - x0) / srm1
                eps_eff = torch.tensordot(plms[t], torch.stack((eps_t,) + eps_hist), dims=1)
                x0_eff = sra * x - srm1 * eps_eff
                x_diff = torch.sqrt(ab_prev) * x0_eff + torch.sqrt(1.0 - ab_prev) * eps_eff
                return x_diff - guidance, phi_, st, x0, sep, aux_vec, eps_t
            # noise AFTER guidance (gaussian_diffusion.py:266-268)
            if not (deterministic or t == 0):
                x_t = x_t + torch.exp(0.5 * logvar) * draw(t, tuple(x_t.shape), i)
            return x_t, phi_, st, x0, sep, aux_vec, None

        if record_every is not None:
            rec_steps = record_steps_for(T, record_every, extra=(T - 1, 999))
            slot_map = make_slot_map(T, rec_steps)
            if x0_buf_init is not None:  # a segment: earlier segments' snapshots carry on
                buf_x0 = torch.as_tensor(x0_buf_init, device=device).clone()
            else:
                buf_x0 = torch.zeros((len(rec_steps),) + tuple(x_init.shape), dtype=x_init.dtype,
                                     device=device)
        else:
            rec_steps, slot_map, buf_x0 = (), None, None

        # 'ps' always takes the x_prev gradient (condition_methods.py:40); the
        # hybrid schedule takes it at chain positions 0, k, 2k, ... only: the JAX
        # loop's [T // k, k] blocks, each starting with the full step, and the
        # remainder block too
        full_grad = ps or gcfg.gradient_x_prev
        every = gcfg.x_prev_every if _hybrid(gcfg) else 1
        seps, phis, auxs, stds = [], [], [], []
        x = x_init.detach()
        x0 = torch.zeros_like(x)
        for s, t in enumerate(steps):
            use_x_prev = full_grad and s % every == 0
            with profiling.span("guided.step", t=t, x_prev=use_x_prev):
                tb = torch.full((B,), t, dtype=torch.long, device=device)
                sep, aux_vec = torch.zeros((B,), device=device), zero_aux
                for i in range(1 if never_alternates else int(masks["alternate_len"][t])):
                    x, phi, opt_state, x0, sep, aux_vec, eps_t = one_iteration(
                        x, phi, opt_state, t, tb, i, use_x_prev)
                    if ltsp:
                        eps_hist = (eps_t, eps_hist[0], eps_hist[1])
                x = x.detach()
                if slot_map is not None:
                    record_update(buf_x0, x0, int(slot_map[t]))
                seps.append(sep)
                phis.append(phi)
                auxs.append(aux_vec)
                stds.append(x0.float().reshape(B, -1).std(dim=1, unbiased=False))
            profiling.count("guided.steps")
            if use_x_prev and (ps or always_guided or masks["guidance"][t]):  # a pullback ran
                profiling.count("guided.x_prev_steps")
            if progress_every and t % progress_every == 0:
                vals = {k: np.round(v[0].detach().cpu().numpy(), 3).tolist()
                        for k, v in phi.items()}
                print(f"  t={t:4d} loss={float(sep[0]):.3f} {vals}", flush=True)

        res = GuidedResult(
            sample=x,
            pred_xstart=x0,
            phi=phi,
            sep_loss=torch.stack(seps),
            phi_trace={k: torch.stack([p[k] for p in phis]) for k in phi},
            aux_trace={k: torch.stack([a[k] for a in auxs]) for k in aux_names},
            x0_std_trace=torch.stack(stds),
            opt_state=opt_state,
            x0_snapshots=buf_x0,
            eps_hist=eps_hist if ltsp else None,
            snapshot_steps=tuple(rec_steps),
        )
        return _gather_images(res, mesh, lane_separable) if sharded else res


_ROWS = ("sample", "pred_xstart", "phi", "opt_state", "eps_hist")  # images on axis 0
_COLUMNS = ("sep_loss", "phi_trace", "x0_std_trace", "x0_snapshots")  # axis 1


def _gather_images(res: GuidedResult, mesh, lane_separable: bool) -> GuidedResult:
    """Every dp rank's images of a result, concatenated in rank (and so
    image) order on every rank. The joint loss's aux traces ([T]) are batch
    values, reduced already and the same on every rank; the fleet's are per
    lane ([T, B])."""
    columns = _COLUMNS + (("aux_trace",) if lane_separable else ())
    gather = lambda dim: lambda t: gather_batch(t, mesh, dim)  # noqa: E731
    return dataclasses.replace(res, **{f: map_tensors(gather(0), getattr(res, f)) for f in _ROWS},
                               **{f: map_tensors(gather(1), getattr(res, f)) for f in columns})
