"""One run of one cell: set-up, warm-up, the measured window, and the check
of what the window produced against the plain reference.

A cell is a configuration (``configs/<name>.json``: the preset as it is run,
its arithmetic, its limits) under a traffic mix (``traffic/<name>.json``),
paired by an entry of ``BENCHMARK.json``'s ``workloads``.

What the harness knows of the model is its family's, ``families/<family>.py``
in the run's home, named by the configuration's ``family`` key (absent:
``adm_unet``). A family module gives:

  * ``sizes(config, overrides)``: the model's sizes from the configuration,
    with the tests' smaller ``overrides``; they have ``image_size``, and the
    readers get them as ``ctx.arch``;
  * ``torso_dtype(config)``: the dtype the program's model computes in;
  * ``program(config, sizes, overrides, seed, device)``: the program's model,
    built through the port's own constructors, filled with the seeded
    weights (``harness/weights.py`` under the family's rule) and cast and
    laid out as the port's restore path does: ``model(x, t)`` takes x_t
    [B, H, W, 4] and gives eps and the variance channels [B, H, W, 8];
  * ``reference(sizes, seed, device)``: the plain fp32 model with the same
    bits and the same call, whose ``set_quant(q)`` rounds its products'
    operands (the control);
  * ``flop(sizes, batch)``: the (forward, x-only pullback) FLOP of one call.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import time
from functools import partial
from typing import Callable, Dict, List, Optional

import torch

from reference.diffusion import Preset, check_step

from . import host, load, program, trace as tr, traffic as tf

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Tap:
    """The model as the chain calls it. At a recorded window step it keeps the
    step's input x_t and output, and on an x_prev step the gradients that the
    step's pullback passes at the model's output (the cotangent) and at x_t
    (the pullback before its clip); at the step after, its input (x_{t-1}).
    References only: nothing is copied and nothing waits for the device.

    The recorded steps are the ``fixed`` ones and ``k`` more, a uniform
    sample of the window's other steps kept as a reservoir (``rng`` draws
    it), so that a run holds and checks as many steps whatever its length."""

    def __init__(self, model_fn):
        self.model_fn = model_fn
        self.arm()
        self.stop()

    def arm(self, fixed=(), k: int = 0, rng=None):
        """Record from the next call on."""
        self.step, self.kept, self.on = 0, {}, True
        self.fixed, self.k, self.rng = set(fixed), k, rng
        self.pool: List[int] = []
        self.seen = 0

    def stop(self):
        """Record nothing more; keep what was recorded."""
        self.on = False

    def recorded(self, s: int) -> bool:
        return s in self.fixed or s in self.pool

    def _take(self, s: int) -> bool:
        if s in self.fixed:
            return True
        self.seen += 1
        if not self.k:
            return False
        if len(self.pool) < self.k:
            self.pool.append(s)
            return True
        j = int(self.rng.integers(self.seen))
        if j >= self.k:
            return False
        old, self.pool[j] = self.pool[j], s
        self._forget(old)
        return True

    def _forget(self, old: int):
        """Drop what only the step ``old``, no longer recorded, needed."""
        if old in self.kept:
            if self.recorded(old - 1):  # its x is a recorded step's x_{t-1}
                for key in ("out", "u", "gx"):
                    self.kept[old].pop(key, None)
            else:
                del self.kept[old]
        if old + 1 in self.kept and not self.recorded(old + 1):
            del self.kept[old + 1]

    def __call__(self, x, t):
        s = self.step
        self.step += 1
        take = self.on and self._take(s)
        if take or (self.on and self.recorded(s - 1)):
            self.kept.setdefault(s, {})["x"] = x.detach()
        out = self.model_fn(x, t)
        if take:
            rec = self.kept[s]
            rec["out"] = out.detach()
            if x.requires_grad:
                x.register_hook(partial(rec.__setitem__, "gx"))
                out.register_hook(partial(rec.__setitem__, "u"))
        return out


class Driver:
    """The traffic's segments one after another, each image's x, phi,
    optimizer state and snapshot buffer carried from segment to segment as
    ``run_restoration``'s chain carries them. ``next()`` runs one segment
    and returns what the check needs of it."""

    def __init__(self, segment, traffic, cold, x_prev_every: int):
        self.segment, self.traffic, self.cold, self.k = segment, traffic, cold, x_prev_every
        self.segments = traffic.segments()

    def next(self) -> dict:
        seg, tfc = next(self.segments), self.traffic
        if seg.first:
            self.x, self.y = tfc.x_start(seg.image), tfc.measurement(seg.image)
            self.cs, self.phi, self.opt, self.buf = tfc.chain_seed(seg.image), self.cold, None, None
        phi_in = self.phi
        res = self.segment(self.x, self.y, self.cs, self.phi, self.opt, seg.ts, self.buf)
        self.x, self.phi, self.opt, self.buf = res.sample, res.phi, res.opt_state, res.x0_snapshots
        return dict(image=seg.image, ts=seg.ts, first=seg.first, y=self.y, cs=self.cs,
                    phi_in=phi_in, sample=res.sample, x0=res.pred_xstart, sep=res.sep_loss,
                    phi_trace=res.phi_trace, x0_std=res.x0_std_trace,
                    x_prev=sum(1 for i in range(len(seg.ts)) if self.k and i % self.k == 0))


@dataclasses.dataclass
class Outcome:
    steps: int                  # guided steps in the window
    x_prev_steps: int
    lanes: int
    window_s: float
    setup_s: float
    setup_peak: int             # bytes, set-up and warm-up
    window_peak: int            # bytes, the window
    attempted: int
    failed: int                 # image-steps whose loss is not finite
    gaps: Dict[str, float]
    limits: Dict[str, float]
    checked_steps: int
    clip_share: Optional[float]
    trace: Optional[tr.Trace]
    trace_steps: int            # guided steps in the traced segments
    trace_x_prev: int
    facts: Dict[str, object]
    segments: List[tuple]

    @property
    def correct(self) -> bool:
        """No non-finite loss, and every compared quantity within its limit."""
        return self.failed == 0 and self.checked_steps > 0 and all(
            k in self.gaps and self.gaps[k] <= v for k, v in self.limits.items())


class Cell:
    def __init__(self, name: str, bench: dict, device, overrides: Optional[dict] = None,
                 home: str = HERE):
        entry = {w["name"]: w for w in bench["workloads"]}[name]
        self.name, self.entry = name, entry
        self.config = load_json(home, "configs", entry["config"] + ".json")
        self.mix = load_json(home, "traffic", entry["traffic"] + ".json")
        self.preset = self.config["preset"]
        self.P = Preset.from_dict(self.preset)
        self.family = load(home, "families", self.config.get("family", "adm_unet"))
        self.overrides = dict(overrides or {})
        self.arch = self.family.sizes(self.config, self.overrides)
        self.dtype = self.family.torso_dtype(self.config)
        self.device = torch.device(device)
        self.lanes = int(self.mix["lanes"])

    def program(self, seed: int) -> torch.nn.Module:
        """The program's model, filled from ``seed``."""
        return self.family.program(self.config, self.arch, self.overrides, seed, self.device)

    def reference(self, seed: int) -> torch.nn.Module:
        """The plain reference model, filled with the program's bits."""
        return self.family.reference(self.arch, seed, self.device)

    def run(self, seed: int, seconds: float, trace: bool = False, t_start: Optional[float] = None,
            swap_model: Optional[Callable] = None, swap_segment: Optional[Callable] = None,
            tf32: bool = False) -> Outcome:
        """Set up, warm up, measure for ``seconds`` (to the next segment
        boundary), with ``trace`` trace the segments that follow, then check
        the window's recorded steps. ``swap_model(model)`` and
        ``swap_segment(segment, model)`` put something else in the program's
        place (the control, a planted fault); ``tf32`` runs the program with
        TF32 on."""
        t_start = time.perf_counter() if t_start is None else t_start
        dev, cuda = self.device, self.device.type == "cuda"
        st = program.settings(self.dtype, dev)
        if cuda:
            program.set_tf32(tf32)
        model = self.program(seed)
        tap = Tap(swap_model(model) if swap_model else model)
        segment = program.build_chain(self.preset, tap, self.lanes)
        if swap_segment:
            segment = swap_segment(segment, tap)
        traffic = tf.Traffic(self.mix, self.P, self.arch.image_size, seed, dev)
        cold = program.cold_phi(self.preset, self.lanes, dev)
        k = traffic.x_prev_every if self.P.gradient_x_prev else 0
        trace_out, traced = None, []
        with program.cudnn_algorithms(st.deterministic):
            # warm-up: the first segment of image 0; the window starts it over
            Driver(segment, traffic, cold, k).next()
            sync(dev)
            setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            tap.arm(*traffic.record_plan())
            drive = Driver(segment, traffic, cold, k)
            # what set-up left is old: no collection in the window walks it again
            gc.collect()
            gc.freeze()
            setup_s = time.perf_counter() - t_start
            log: List[dict] = []
            mhz, load = [host.cpu_mhz()], [host.load_1min()]
            cpu = host.Sampler()
            t0 = time.perf_counter()
            done = 0
            while True:
                log.append(drive.next())
                done += len(log[-1]["ts"])
                if not tap.recorded(done - 1):  # its last step's output is not needed
                    log[-1]["sample"] = log[-1]["x0"] = None
                sync(dev)
                log[-1]["end"] = time.perf_counter() - t0
                cpu.mark()
                if log[-1]["end"] >= seconds:
                    break
            window_s = log[-1]["end"]
            mhz.append(host.cpu_mhz())
            load.append(host.load_1min())
            window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
            if trace:  # the segments after the window, under the profiler
                tap.stop()
                prof = start_profiler(cuda)
                with torch.profiler.record_function(tr.MARKER):
                    for _ in range(int(self.mix.get("trace_segments", 2))):
                        traced.append(drive.next())
                        sync(dev)
                prof.__exit__(None, None, None)
                trace_out = tr.reduce(prof)
                del prof
            gc.unfreeze()
        if cuda:
            program.set_tf32(False)
        steps = sum(len(s["ts"]) for s in log)
        failed = sum(int((~torch.isfinite(s["sep"])).sum()) for s in log)
        records = self._records(tap.kept, log)
        clip_share = None
        gx = [r["gx"] for r in records if "gx" in r]
        if gx and self.P.clip:
            flat = torch.cat([g.reshape(-1) for g in gx])
            clip_share = float((flat.abs() > self.P.clip).float().mean())
        del model, tap, segment, drive
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        gaps = self._check(seed, records)
        starts = [0.0] + [s["end"] for s in log[:-1]]
        facts = dict(precision=st.precision, algorithms=st.algorithms,
                     departures=self.config.get("assumed", {}),
                     slice=f"t = {traffic.slice[0]}..{traffic.slice[-1]}, "
                           f"{len(traffic.slice)} steps an image, segments of "
                           f"{[len(s) for s in traffic.segments_per_image]}",
                     segment_s=[round(s["end"] - a, 4) for a, s in zip(starts, log)],
                     segment_host=cpu.rows(), cpu_mhz=mhz, load=load)
        return Outcome(steps=steps, x_prev_steps=sum(s["x_prev"] for s in log), lanes=self.lanes,
                       window_s=window_s, setup_s=setup_s, setup_peak=setup_peak,
                       window_peak=window_peak, attempted=steps * self.lanes, failed=failed,
                       gaps=gaps, limits=self.config["limits"], checked_steps=len(records),
                       clip_share=clip_share, trace=trace_out,
                       trace_steps=sum(len(s["ts"]) for s in traced),
                       trace_x_prev=sum(s["x_prev"] for s in traced), facts=facts,
                       segments=[(s["image"], s["ts"][0], s["ts"][-1]) for s in log])

    def _records(self, kept, log) -> List[dict]:
        """The recorded steps with the program's values around each."""
        out, s0 = [], 0
        for seg in log:
            n = len(seg["ts"])
            for i in range(n):
                s = s0 + i
                if s not in kept or "out" not in kept[s]:
                    continue
                rec = dict(kept[s], t=seg["ts"][i], y=seg["y"], cs=seg["cs"],
                           sep=seg["sep"][i], x0_std=seg["x0_std"][i],
                           phi_after={k: v[i] for k, v in seg["phi_trace"].items()})
                if i == 0 and seg["first"]:  # an image's start: the reference's own cold phi
                    rec["phi_before"] = {k: torch.tensor(v, dtype=torch.float32, device=self.device)
                                         .expand(self.lanes, -1) for k, v in self.P.phi_cold.items()}
                elif i == 0:
                    rec["phi_before"] = seg["phi_in"]
                else:
                    rec["phi_before"] = {k: v[i - 1] for k, v in seg["phi_trace"].items()}
                if i == n - 1:
                    rec["x_next"], rec["x0"] = seg["sample"], seg["x0"]
                else:
                    rec["x_next"] = kept[s + 1]["x"]
                out.append(rec)
            s0 += n
        return out

    def _check(self, seed: int, records: List[dict]) -> Dict[str, float]:
        """The largest gap of each compared quantity over the recorded steps."""
        if self.device.type == "cuda":
            program.set_tf32(False)
        ref = self.reference(seed)
        worst: Dict[str, float] = {}
        for rec in records:
            for k, v in check_step(self.P, ref, rec, rec["y"], rec["cs"]).items():
                worst[k] = max(worst.get(k, 0.0), v if not math.isnan(v) else math.inf)
        return worst


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def start_profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.__enter__()
    return prof

