"""The route of the port's UNet to its CUDA graphs (``models/unet.py``), on
the CPU: the eager call off a card, the pure decision ``takes_graph`` for a
call on a card and what the model observes for it, the cache dropped by a
cast, a move or a state-dict load, and the pullback of a stale forward, which recomputes
instead of reading the newest replay's activations (through a stand-in for
the graphs). The graphs themselves run only on a card:
``portbench/tests/test_unet_graph.py`` (marker ``cuda``)."""

import contextlib

import pytest
import torch

from osmosis_tpu_torch.models import unet as U
from osmosis_tpu_torch.utils import profiling

TINY = U.UNetConfig(image_size=32, model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
                    channel_mult=(1, 2), num_head_channels=16)
ROUTE = dict(hooked=False, remat=False, other_grads=False, capturing=False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny models run fastest on one thread when test workers share the
    cores; the previous setting is restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiny(seed=0, **kw):
    torch.manual_seed(seed)
    model = U.UNetModel(U.dataclasses.replace(TINY, **kw))
    for p in model.parameters():  # the zero-initialized output convs too
        p.data.add_(0.05 * torch.randn(p.shape))
    return model.requires_grad_(False).to(memory_format=torch.channels_last)


def inputs(seed=1, batch=2):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(batch, 32, 32, 4, generator=gen), torch.tensor([3.0, 700.0][:batch])


def test_a_cpu_call_runs_eagerly_and_counts_no_replay():
    model = tiny()
    x, t = inputs()
    before = profiling.counters()
    x = x.requires_grad_(True)
    out = model(x, t)
    (gx,) = torch.autograd.grad(out, x, torch.ones_like(out))
    counted = profiling.counters() - before
    assert model._graphs == {}
    assert counted["unet.calls"] == 1
    assert not any(counted[k] for k in ("unet.graph_replays", "unet.graph_pullbacks",
                                        "unet.graph_captures"))
    xe = x.detach().requires_grad_(True)
    eager = model._forward(xe, t)
    assert torch.equal(out, eager)
    assert torch.equal(gx, torch.autograd.grad(eager, xe, torch.ones_like(eager))[0])


def test_the_route_takes_the_graph_with_nothing_in_its_way():
    assert U.takes_graph(**ROUTE)


@pytest.mark.parametrize("refusal", ["hooked", "remat", "other_grads", "capturing"])
def test_the_route_refuses(refusal):
    assert not U.takes_graph(**dict(ROUTE, **{refusal: True}))


def test_the_model_observes_nothing_in_the_way_of_a_frozen_model():
    model = tiny()
    assert model._observe(inputs()[1]) == dict(hooked=False, remat=False, other_grads=False)


@pytest.mark.parametrize("kind", ["forward", "forward_pre", "module_global", "full_backward",
                                  "flop_counter"])
def test_the_model_observes_hooks_until_they_are_removed(kind):
    model = tiny()
    t = inputs()[1]
    assert not model._observe(t)["hooked"]  # the hook tables are gathered before the hook
    site = model.input_blocks[1][0].in_layers[2]
    noop = lambda *a: None  # noqa: E731
    with contextlib.ExitStack() as hooks:
        if kind == "forward":
            hooks.callback(site.register_forward_hook(noop).remove)
        elif kind == "forward_pre":
            hooks.callback(site.register_forward_pre_hook(noop).remove)
        elif kind == "module_global":
            hooks.callback(torch.nn.modules.module.register_module_forward_hook(noop).remove)
        elif kind == "full_backward":
            hooks.callback(site.register_full_backward_hook(noop).remove)
        else:  # tools/unet_profile counts a call's FLOP: eagerly, FlopCounterMode's hooks set
            from torch.utils.flop_counter import FlopCounterMode
            hooks.enter_context(FlopCounterMode(display=False))
        assert model._observe(t)["hooked"]
    assert not model._observe(t)["hooked"]


def test_the_model_observes_remat_trained_parameters_and_grad_timesteps():
    t = inputs()[1]
    assert tiny(remat=True)._observe(t)["remat"]
    model = tiny()
    model.out[2].weight.requires_grad_(True)
    assert model._observe(t)["other_grads"]
    model.out[2].weight.requires_grad_(False)
    assert not model._observe(t)["other_grads"]
    assert model._observe(t.clone().requires_grad_(True))["other_grads"]


@pytest.mark.parametrize("drop", ["cast", "move", "memory_format", "load_state_dict"])
def test_a_cast_a_move_or_a_load_drops_the_graphs(drop):
    model = tiny()
    model._observe(inputs()[1])
    model._graphs[("a key",)] = object()
    assert model._graphs and model._watched is not None
    if drop == "cast":
        model.float()
    elif drop == "move":
        model.to("cpu")
    elif drop == "memory_format":
        model.to(memory_format=torch.channels_last)
    else:
        model.load_state_dict(tiny(seed=5).state_dict())
    assert model._graphs == {} and model._watched is None


def test_the_key_holds_layout_and_algorithm_settings():
    x, t = inputs()
    key = U._graph_key(x, t)
    assert U._graph_key(x.clone(), t.clone()) == key
    assert U._graph_key(x[:1], t[:1]) != key
    assert U._graph_key(x.permute(0, 2, 1, 3), t) != key  # same shape, another layout
    assert U._graph_key(x.double(), t) != key
    saved = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = not saved
        assert U._graph_key(x, t) != key
    finally:
        torch.backends.cudnn.deterministic = saved


def test_count_all_adds_and_takes_away():
    profiling.reset_counters("t.a", "t.b")
    profiling.count_all({"t.a": 3, "t.b": 2})
    profiling.count_all({"t.a": -1})
    c = profiling.counters()
    assert (c["t.a"], c["t.b"]) == (2, 2)


class FakeGraphs:
    """The graphs' contract on the CPU: one set of 'activations', the newest
    forward's input, which a pullback reads as the backward graph reads the
    activations of the newest replay."""

    def __init__(self, fn):
        self.fn, self.generation, self.x, self.pullbacks = fn, 0, None, 0

    def forward(self, x, t):
        self.x, self.t = x.detach().clone(), t
        self.generation += 1
        with torch.no_grad():
            return self.fn(self.x, self.t)

    def backward(self, g):
        self.pullbacks += 1
        with torch.enable_grad():
            xr = self.x.requires_grad_(True)
            return torch.autograd.grad(self.fn(xr, self.t), xr, g)[0]


@pytest.mark.parametrize("between", ["two_forwards", "a_grad_free_forward"])
def test_a_stale_pullback_recomputes_its_own_forward(between):
    model = tiny()
    graphs = FakeGraphs(model._forward)
    (xa, t), (xb, _) = inputs(1), inputs(2)
    g = torch.randn(2, 32, 32, 8, generator=torch.Generator().manual_seed(3))

    def eager_grad(x):
        xe = x.clone().requires_grad_(True)
        return torch.autograd.grad(model._forward(xe, t), xe, g)[0]

    a = xa.clone().requires_grad_(True)
    out_a = U._Replay.apply(graphs, model._forward, a, t)
    assert torch.equal(out_a, model._forward(xa, t))
    if between == "two_forwards":
        b = xb.clone().requires_grad_(True)
        out_b = U._Replay.apply(graphs, model._forward, b, t)
    else:
        with torch.no_grad():
            U._Replay.apply(graphs, model._forward, xb, t)
    (ga,) = torch.autograd.grad(out_a, a, g)  # stale: recomputed, not replayed
    assert graphs.pullbacks == 0
    assert torch.equal(ga, eager_grad(xa))
    if between == "two_forwards":
        (gb,) = torch.autograd.grad(out_b, b, g)  # the newest: replayed
        assert graphs.pullbacks == 1
        assert torch.equal(gb, eager_grad(xb))
