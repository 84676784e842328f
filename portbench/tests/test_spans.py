"""The readers of the program's spans and counters (``harness/spans.py``):
each on a synthetic span set and trace, as ``test_yardstick`` reads
``step_mfu_pct``; pass C's reduction of a profiler's events (a launch from
another thread credited to the span that holds it, an idle gap outside
every span); a program without spans, which every reader reads as nothing;
and a traced run on the CPU at a tiny UNet, whose pass A runs with the
spans off."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import TINY

NS = 1_000_000  # a millisecond


def record(name, id_, parent, start_ms, end_ms, root=1):
    return SimpleNamespace(name=name, id=id_, parent=parent, root=root, start_ns=start_ms * NS,
                           end_ns=end_ms * NS, duration_ns=(end_ms - start_ms) * NS)


def host_pass():
    """Two steps of 100 ms in a 210 ms segment: unet.forward 30 + 20 ms,
    guided.phi_fit 40 + 40 ms, one pullback of 25 ms."""
    from harness.spans import HostPass
    spans = [record("guided.segment", 1, 0, 0, 205),
             record("guided.step", 2, 1, 0, 100), record("unet.forward", 3, 2, 0, 30),
             record("guided.phi_fit", 4, 2, 30, 70), record("guided.pullback", 5, 2, 70, 95),
             record("guided.step", 6, 1, 100, 200), record("unet.forward", 7, 6, 100, 120),
             record("guided.phi_fit", 8, 6, 120, 160)]
    counts = {"guided.steps": 2, "guided.x_prev_steps": 1, "guided.phi_iters": 40,
              "unet.calls": 2}
    return HostPass([0.210], spans, counts)


def span_trace():
    """Pass C over [0, 100] ms: spans unet.forward [10, 40], guided.pullback
    [50, 80] inside guided.step [0, 90]; device operations launched at 12,
    20 (the UNet's), 55 (the pullback's) and 85 (the step's own), and one
    whose launch was not found; busy [12, 30], [25, 40], [55, 70],
    [85, 88], [95, 96]."""
    from harness import trace as tr
    from harness.spans import SpanTrace
    dev = [("conv_a", 12, 30, 12), ("conv_b", 25, 40, 20), ("dgrad", 55, 70, 55),
           ("add", 85, 88, 85), ("copy", 95, 96, -1)]
    trace = tr.Trace(0, 100 * NS, [d[0] for d in dev], np.array([d[1] for d in dev]) * NS,
                     np.array([d[2] for d in dev]) * NS, 4, [], np.zeros(0, np.int64),
                     np.zeros(0, np.int64))
    spans = [("guided.step", 0, 90 * NS), ("unet.forward", 10 * NS, 40 * NS),
             ("guided.pullback", 50 * NS, 80 * NS)]
    launch = np.array([d[3] * NS if d[3] >= 0 else -1 for d in dev], np.int64)
    counts = {"guided.steps": 2, "guided.x_prev_steps": 1, "guided.phi_iters": 40,
              "unet.calls": 2}
    return SpanTrace.build(trace, spans, launch, counts)


def ctx_with(peaks=None, torso="bf16", lanes=1):
    from harness.spans import Passes
    from reference.unet import Arch
    outcome = SimpleNamespace(lanes=lanes, steps=10, window_s=1.0, trace_steps=4, trace_x_prev=1)
    ctx = SimpleNamespace(outcome=outcome, trace=object(), arch=Arch(), peaks=peaks, torso=torso)
    ctx.span_passes = Passes(host_pass(), span_trace())
    return ctx


def read(name, ctx):
    import run
    return run.reader(run.HERE, name)(ctx)


def test_host_readers_divide_span_time_by_the_counters():
    ctx = ctx_with()
    assert read("phi_fit_ms_per_step", ctx) == pytest.approx(80 / 2)
    assert read("unet_host_ms_per_step", ctx) == pytest.approx(50 / 2)
    assert read("pullback_ms_per_xprev", ctx) == pytest.approx(25 / 1)


def test_step_idle_is_pass_c_busy_over_pass_b_wall():
    """Busy in pass C: 28 + 15 + 3 + 1 = 47 ms over 2 steps; pass B's wall
    210 ms over 2 steps."""
    ctx = ctx_with()
    assert ctx.span_passes.device.busy_s() == pytest.approx(47e-3)
    assert read("step_idle_pct", ctx) == pytest.approx(100 * (1 - 23.5 / 105))


@pytest.mark.parametrize("torso, peak_key", [("fp32", "fp32_flops"), ("bf16", "bf16_flops")])
def test_unet_mfu_counts_only_the_unets_operations(torso, peak_key):
    """The UNet's operations (launched inside unet.forward or
    guided.pullback) cover [12, 40] and [55, 70]: 43 ms; the step's own
    operation and the unmatched copy are left out. No card: nothing."""
    from yardstick.unet_cost import flop
    peaks = {"fp32_flops": 67e12, "bf16_flops": 989e12}
    ctx = ctx_with(peaks, torso, lanes=4)
    fwd, pull = flop(ctx.arch, 4)
    want = 100 * (2 * fwd + 1 * pull) / (43e-3 * peaks[peak_key])
    assert read("unet_mfu_pct", ctx) == pytest.approx(want)
    assert read("unet_mfu_pct", ctx_with(None, torso)) is None


def test_breakdown_credits_operations_and_gaps_to_the_innermost_span():
    from harness.spans import OUTSIDE
    st = span_trace()
    assert st.dev_span == ["unet.forward", "unet.forward", "guided.pullback", "guided.step",
                           OUTSIDE]
    assert st.unmatched == 1 and list(st.dev_unet) == [True, True, True, False, False]
    b = st.breakdown()
    idle = dict((n, v) for n, v in b["idle_by_span"])
    # gaps [0, 12] and [40, 55] in guided.step (midpoints 6, 47.5), [70, 85]
    # in guided.step (77.5 lies in the pullback), [88, 95] and [96, 100] outside
    assert idle == pytest.approx({"guided.step": 27e-3, "guided.pullback": 15e-3,
                                  OUTSIDE: 11e-3})
    assert b["device_by_span"][0][:2] == ["unet.forward", "conv_a"]
    assert dict(b["device_s_by_span"]) == pytest.approx(
        {"unet.forward": 33e-3, "guided.pullback": 15e-3, "guided.step": 3e-3, OUTSIDE: 1e-3})


class Event:
    def __init__(self, name, start, dur, device="cpu", kind="cpu_op", corr=0, thread=1):
        self._v = dict(name=name, start_ns=start, duration_ns=dur, corr=corr, thread=thread,
                       device=device, kind=kind)

    def name(self):
        return self._v["name"]

    def start_ns(self):
        return self._v["start_ns"]

    def duration_ns(self):
        return self._v["duration_ns"]

    def device_type(self):
        return "DeviceType.CUDA" if self._v["device"] == "cuda" else "DeviceType.CPU"

    def activity_type(self):
        if self._v["kind"] is None:
            raise AttributeError("activity_type")
        return self._v["kind"]

    def correlation_id(self):
        return self._v["corr"]

    def start_thread_id(self):
        return self._v["thread"]


@pytest.mark.parametrize("kinds", [True, False], ids=["with_kinds", "without_kinds"])
def test_reduce_credits_a_launch_from_another_thread_to_the_span_holding_it(kinds):
    """The pullback's kernel is launched from the autograd engine's thread
    (2) while the caller's thread (1) sits in guided.pullback; a copy
    launched after every span closed is outside them, and so is the idle
    gap around it. Annotations of other names, or of another thread, are
    not the program's spans, and the device's copies of the annotations are
    no operations, whether or not the events carry their activity kind."""
    from harness.spans import MARKER, OUTSIDE, reduce
    ev = [Event(MARKER, 0, 100), Event(MARKER, 1, 99, device="cuda", kind="gpu_user_annotation"),
          Event("guided.step", 5, 70, kind="user_annotation"),
          Event("guided.pullback", 20, 40, kind="user_annotation"),
          Event("guided.pullback", 21, 10, kind="user_annotation", thread=2),
          Event("other", 0, 100, kind="user_annotation"),
          Event("cudaLaunchKernel", 30, 2, kind="cuda_runtime", corr=7, thread=2),
          Event("dgrad_engine", 35, 20, device="cuda", kind="kernel", corr=7),
          Event("cudaMemcpyAsync", 80, 1, kind="cuda_runtime", corr=8),
          Event("Memcpy DtoH", 82, 4, device="cuda", kind="gpu_memcpy", corr=8),
          Event("guided.pullback", 20, 1, device="cuda", kind="gpu_user_annotation"),
          Event("before", -50, 10, kind="cuda_runtime", corr=9),
          Event("aten::mm", 30, 3, corr=8)]
    if not kinds:
        for e in ev:
            e._v["kind"] = None
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    st = reduce(prof, {"guided.step", "guided.pullback"}, {"guided.steps": 1})
    assert st.trace.dev_name == ["dgrad_engine", "Memcpy DtoH"] and st.trace.launches == 1
    assert st.dev_span == ["guided.pullback", OUTSIDE] and list(st.dev_unet) == [True, False]
    assert st.span_name == ["guided.step", "guided.pullback"]
    idle = dict((n, v) for n, v in st.breakdown()["idle_by_span"])
    assert idle == pytest.approx({"guided.step": 35e-9 + 27e-9, OUTSIDE: 14e-9})


def test_a_program_without_spans_reads_as_nothing(monkeypatch):
    """The parent of the spans: every reader gives None and no pass runs."""
    from harness import spans
    monkeypatch.setattr(spans, "_profiling", lambda: None)
    monkeypatch.setattr(spans, "run_passes", lambda *a: pytest.fail("a pass ran"))
    ctx = ctx_with({"fp32_flops": 67e12, "bf16_flops": 989e12})
    del ctx.span_passes
    for name in ("phi_fit_ms_per_step", "unet_host_ms_per_step", "pullback_ms_per_xprev",
                 "step_idle_pct", "unet_mfu_pct"):
        assert read(name, ctx) is None


def test_traced_run_reads_the_spans_after_pass_a(bench, capsys, monkeypatch):
    """A traced run on the CPU prints the four span readers that need no
    card and the ``span_breakdown`` line; pass A (the window and its
    traced segments) recorded no span, and passes B and C each ran two
    segments of 20 steps."""
    import run
    from harness.cell import Cell
    from osmosis_tpu_torch.utils import profiling

    window = Cell.run
    during_a = []

    def run_a(self, *a, **kw):
        profiling.take_spans()
        out = window(self, *a, **kw)
        during_a.extend(profiling.take_spans())
        return out

    monkeypatch.setattr(Cell, "run", run_a)
    result = run.run_cell(bench, "hybrid_bf16_fleet4", 2 ** 31 + 4321, 1.0, True, "cpu",
                          overrides=TINY)
    out = capsys.readouterr().out
    assert during_a == [] and result["correct"]
    assert {"phi_fit_ms_per_step", "unet_host_ms_per_step", "pullback_ms_per_xprev",
            "step_idle_pct"} <= set(result["metrics"])
    assert "unet_mfu_pct" not in result["metrics"]  # no card
    line = [x for x in out.splitlines() if x.startswith("span_breakdown: ")]
    assert len(line) == 1
    b = json.loads(line[0][len("span_breakdown: "):])
    assert {"idle_by_span", "device_by_span", "host_s_by_span"} <= set(b)
    for side in ("pass_b", "pass_c"):
        assert b["counts"][side]["guided.steps"] == 40
        assert b["counts"][side]["unet.calls"] == 40
        assert b["counts"][side]["guided.x_prev_steps"] == 10
    assert len(b["segment_wall_s"]) == len(b["segment_step_spans_s"]) == 2
    for wall, steps in zip(b["segment_wall_s"], b["segment_step_spans_s"]):
        assert 0 < steps <= wall
