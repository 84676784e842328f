"""The port's spans and counters (``utils/profiling``) on the CPU, on the
tiny UNet of ``test_torch_unet``: off, a span is one shared null context and
records nothing; on, an osmosis chain gives a ``guided.step`` per step
holding the UNet's forward, the phi fit and the joint gradient, with the
pullback on x_prev steps only, and the chain's bits do not move; the
counters follow the configuration; a fleet is one ``runner.segment``; under
``torch.profiler`` every span is a user annotation on the same clock; and
``phase`` still feeds ``TIMERS``."""

import contextlib
import threading

import pytest
import torch

from osmosis_tpu_torch.diffusion.guided import GuidanceConfig, guided_sample_loop
from osmosis_tpu_torch.diffusion.sampler import SamplerConfig
from osmosis_tpu_torch.diffusion.schedules import make_schedule
from osmosis_tpu_torch.guidance.operators import get_operator
from osmosis_tpu_torch.guidance.schedule_masks import pattern_masks
from osmosis_tpu_torch.models.convert import init_unet
from osmosis_tpu_torch.models.unet import UNetConfig
from osmosis_tpu_torch.parallel.runner import make_batched_segment_runner
from osmosis_tpu_torch.utils import profiling as PR
from tests.test_torch_guided import AUX, COND_PARAMS, OP_KW, PATTERN
from tests.test_torch_unet import TINY_KW

STEPS = 6
OP = "underwater_physical_revised"
# phi frozen on the chain's first steps (update_start 0.7), a warm phase where
# it unfreezes, 3 phi iterations a step, the pullback on every second step
SPAN_PATTERN = dict(PATTERN, phi_warmup_iters=2)
SPAN_PARAMS = dict(COND_PARAMS, scale="2,2,2,0.5", x_prev_every=2)
CHILDREN = {"unet.forward", "guided.phi_fit", "guided.joint_grad"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    PR.take_spans()
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def unet():
    return init_unet(UNetConfig(**TINY_KW), seed=3).requires_grad_(False).to(
        memory_format=torch.channels_last)


def _inputs(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 32, 32, 4, generator=g), torch.rand(n, 32, 32, 3, generator=g) * 2 - 1


def _chain(model, n=1, **kw):
    x, y = _inputs(n)
    return guided_sample_loop(
        model, make_schedule("linear", 1000, str(STEPS)), x, y,
        get_operator(OP, batch_size=1, **OP_KW),
        GuidanceConfig.from_config("osmosis", SPAN_PARAMS, SPAN_PATTERN, AUX),
        SamplerConfig(sampler="ddpm", clip_denoised=True), sample_pattern=SPAN_PATTERN,
        seed=5, **kw)


def _traced(fn):
    with PR.tracing():
        out = fn()
    return out, PR.take_spans()


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_span_off_is_one_shared_null_context(monkeypatch):
    """Tracing off: every span is the same null context, and using it reads
    no clock and opens no profiler annotation; nothing is recorded."""
    a, b = PR.span("guided.step", t=3, x_prev=True), PR.span("unet.forward")
    assert a is b and isinstance(a, contextlib.nullcontext)

    def fail(*_args, **_kw):
        raise AssertionError("a span with tracing off touched the clock or the profiler")

    monkeypatch.setattr(PR.time, "time_ns", fail)
    monkeypatch.setattr(torch.profiler, "record_function", fail)
    with a, PR.span("outer", k=1):
        with b:
            pass
    assert PR.take_spans() == []


def test_chain_spans_nest_as_the_steps_run(unet):
    """One ``guided.segment`` over the call; a ``guided.step`` a step, each
    holding the UNet's forward, the phi fit and the joint gradient, with the
    pullback on x_prev steps (chain positions 0, 2, 4) only; parent ids are
    the open span's, every child lies inside its parent, and all share the
    segment's root."""
    _, spans = _traced(lambda: _chain(unet))
    ids = {s.id: s for s in spans}
    (seg,) = _by_name(spans, "guided.segment")
    assert seg.parent == 0 and seg.attrs == dict(steps=STEPS, lanes=1, t_first=STEPS - 1,
                                                 t_last=0)
    steps = sorted(_by_name(spans, "guided.step"), key=lambda s: s.start_ns)
    assert [s.attrs["t"] for s in steps] == list(range(STEPS - 1, -1, -1))
    assert all(s.parent == seg.id for s in steps)
    for pos, step in enumerate(steps):
        kids = [s for s in spans if s.parent == step.id]
        names = sorted(s.name for s in kids)
        x_prev = pos % 2 == 0
        assert step.attrs["x_prev"] == x_prev
        assert names == sorted(CHILDREN | ({"guided.pullback"} if x_prev else set()))
    for s in spans:
        assert s.root == seg.id and s.thread == seg.thread
        if s.parent:
            p = ids[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert [s.attrs["batch"] for s in _by_name(spans, "unet.forward")] == [1] * STEPS


def test_counters_follow_the_configuration(unet):
    """``guided.phi_iters`` gains the warm phase's iterations at each step
    plus n_iter where phi is not frozen; ``guided.x_prev_steps`` the steps
    that pulled back; ``guided.steps`` and ``unet.calls`` one a step."""
    masks = pattern_masks(SPAN_PATTERN, STEPS)
    ts = range(STEPS - 1, -1, -1)
    want_phi = sum(int(masks["phi_warmup"][t]) + (0 if masks["freeze_phi"][t] else 3) for t in ts)
    assert masks["phi_warmup"].sum() == 2 and masks["freeze_phi"].any()
    before = PR.counters()
    _chain(unet)
    after = PR.counters()
    got = {k: after[k] - before[k] for k in ("guided.steps", "guided.x_prev_steps",
                                             "guided.phi_iters", "unet.calls")}
    assert got == {"guided.steps": STEPS, "guided.x_prev_steps": 3,
                   "guided.phi_iters": want_phi, "unet.calls": STEPS}


def test_a_traced_chain_is_the_untraced_chain_bit_for_bit(unet):
    plain = _chain(unet)
    traced, spans = _traced(lambda: _chain(unet))
    assert spans
    for name in ("sample", "pred_xstart", "sep_loss", "x0_std_trace"):
        assert torch.equal(getattr(traced, name), getattr(plain, name)), name
    for k in plain.phi:
        assert torch.equal(traced.phi[k], plain.phi[k]) and torch.equal(
            traced.phi_trace[k], plain.phi_trace[k]), k
    for k in plain.aux_trace:
        assert torch.equal(traced.aux_trace[k], plain.aux_trace[k]), k


def test_a_fleet_is_one_runner_segment(unet):
    """Three lanes: one ``runner.segment`` (lanes=3) holding one
    ``guided.segment``, one ``guided.step`` a step, not a lane, and the
    UNet called on the batch of 3."""
    run = make_batched_segment_runner(
        unet, make_schedule("linear", 1000, str(STEPS)), get_operator(OP, batch_size=1, **OP_KW),
        GuidanceConfig.from_config("osmosis", SPAN_PARAMS, SPAN_PATTERN, AUX),
        SamplerConfig(sampler="ddpm", clip_denoised=True), SPAN_PATTERN)
    x, y = _inputs(3)
    res, spans = _traced(lambda: run(x, y, seed=5, ts=[5, 4, 3, 2]))
    assert res.sample.shape[0] == 3
    (runner,) = _by_name(spans, "runner.segment")
    (seg,) = _by_name(spans, "guided.segment")
    assert runner.attrs == {"lanes": 3} and seg.parent == runner.id and seg.root == runner.id
    assert seg.attrs == dict(steps=4, lanes=3, t_first=5, t_last=2)
    assert len(_by_name(spans, "guided.step")) == 4
    assert [s.attrs["batch"] for s in _by_name(spans, "unet.forward")] == [3] * 4


def test_spans_are_user_annotations_on_the_profilers_clock(unet):
    """Under ``torch.profiler`` every span is a user annotation of its name,
    whose start and duration agree with its record within 1 ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with PR.tracing():
            with PR.span("warm-up"):  # the first annotation of a process is slow to open
                pass
            _chain(unet, ts=[5, 4, 3])
    spans = [s for s in PR.take_spans() if s.name != "warm-up"]
    names = {s.name for s in spans}
    assert names == {"guided.segment", "guided.step", "guided.pullback"} | CHILDREN
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in names and "cpu" in str(e.device_type()).lower()]
    for name in names:
        recs = sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)
        evs = sorted((e for e in events if e.name() == name), key=lambda e: e.start_ns())
        assert len(evs) == len(recs), name
        for r, e in zip(recs, evs):
            assert abs(e.start_ns() - r.start_ns) <= 1_000_000, name
            assert abs(e.duration_ns() - r.duration_ns) <= 1_000_000, name


def test_phase_feeds_timers_and_opens_a_span_while_tracing():
    timers = PR.TIMERS
    n0 = timers.counts["spans_test_phase"]
    with PR.phase("spans_test_phase"):
        pass
    assert timers.counts["spans_test_phase"] == n0 + 1 and PR.take_spans() == []
    with PR.tracing():
        with PR.phase("spans_test_phase"):
            with PR.span("inner"):
                pass
    spans = PR.take_spans()
    outer, inner = _by_name(spans, "spans_test_phase"), _by_name(spans, "inner")
    assert len(outer) == 1 and inner[0].parent == outer[0].id
    assert timers.counts["spans_test_phase"] == n0 + 2
    assert "  spans_test_phase " in timers.summary()


def test_each_thread_keeps_its_own_stack_and_counters_add_up():
    """A span opened on another thread while one is open here has no
    parent; counters incremented from several threads lose no count, and
    ``reset_counters`` sets a named one to 0."""
    done = threading.Event()
    before = PR.counters()["spans_test.count"]

    def work():
        with PR.span("worker"):
            for _ in range(2000):
                PR.count("spans_test.count")
        done.set()

    with PR.tracing():
        with PR.span("main"):
            threads = [threading.Thread(target=work) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads) and done.is_set()
    spans = PR.take_spans()
    (main,) = _by_name(spans, "main")
    workers = _by_name(spans, "worker")
    assert len(workers) == 4 and all(w.parent == 0 and w.root == w.id for w in workers)
    assert all(w.thread != main.thread for w in workers)
    assert PR.counters()["spans_test.count"] == before + 8000
    PR.reset_counters("spans_test.count")
    assert PR.counters()["spans_test.count"] == 0
