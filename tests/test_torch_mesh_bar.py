"""The mesh check's bar (``tools/mesh_check.compare``): it excuses a chain's
sample values that a clamp flip explains, bounded by one-process runs with
the UNet's output moved by the mesh's own difference, and nothing else.

(a) Three faults planted in the ranks (gloo ranks of this file's own worker,
    ``python -m tests.test_torch_mesh_bar <fault> <mesh_check rank args>``,
    on the tiny UNet), each of which the bar must refuse: a ``Gather`` that
    concatenates in the wrong rank order, a ``dp_sum`` whose backward
    all-reduces (dp times the gradient, the trap of
    tests/test_torch_joint_chain.py), and a relative bias of 1e-3 on one
    rank's UNet output.
(b) Constructed pairs of results: one clamp flip at the last step excuses
    its own element and not the one beside it; a flip at an earlier step
    excuses its whole image and not another.
(c) The excuse's bounds: more flips or misses than the perturbed runs, a
    value past twice their largest difference, or a UNet past the cap, each
    raises.
(d) ``peak_sites`` replays an allocator history to its peak.

No JAX here: the bar is the port's own. Every subprocess runs under its
test's time limit.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from osmosis_tpu_torch.tools import mesh_check as MC

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TINY_KW = dict(image_size=32, in_channels=4, out_channels=8, model_channels=32, num_res_blocks=1,
               attention_resolutions=(4,), channel_mult=(1, 2), num_head_channels=16,
               use_scale_shift_norm=True, resblock_updown=True)


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# (a) planted faults
# ---------------------------------------------------------------------------

def _plant(fault: str) -> None:
    """Break this rank's port the way ``fault`` names, before it runs."""
    from osmosis_tpu_torch.parallel import mesh as M
    from osmosis_tpu_torch.parallel import tp

    if fault == "gather_order":
        import torch.distributed as dist

        real = tp.Gather.forward

        def forward(ctx, y, group, *rest):
            whole = real(ctx, y, group, *rest)
            dim = 1 if whole.dim() == 4 else -1
            return torch.cat(whole.chunk(dist.get_world_size(group), dim)[::-1], dim)

        tp.Gather.forward = staticmethod(forward)
    elif fault == "dp_sum_reduces_backward":
        import torch.distributed as dist

        def backward(ctx, grad):
            grad = grad.clone()
            dist.all_reduce(grad)  # the dp x trap: every rank's gradient summed again
            return grad, None

        M._DpSum.backward = staticmethod(backward)
    elif fault == "rank1_bias":
        real_load = MC._load

        def biased(args, device):
            model = real_load(args, device)
            if args.rank == 1:
                model.register_forward_hook(lambda m, a, out: out * (1 + 1e-3))
            return model

        MC._load = biased
    else:
        raise ValueError(fault)


FAULTS = {  # fault: (mesh, what the bar must say)
    "gather_order": ("1x2", "unet out"),
    "dp_sum_reduces_backward": ("2x1", "joint phi_trace"),
    "rank1_bias": ("2x1", "past the cap"),
}


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    from osmosis_tpu_torch.models.unet import UNetConfig
    from osmosis_tpu_torch.tools.runbook_rehearsal import seeded_checkpoint

    path = str(tmp_path_factory.mktemp("bar") / "tiny.pt")
    seeded_checkpoint(path, UNetConfig(**TINY_KW))
    return path


def _args(ckpt, out, meshes, lanes=2):
    return MC.parse(["--checkpoint", ckpt, "--out", str(out), "--cpu", "--unet",
                     json.dumps(TINY_KW), "--size", "32", "--ranks", "2", "--meshes", meshes,
                     "--lanes", str(lanes)])


@pytest.mark.parametrize("fault", list(FAULTS))
def test_the_bar_refuses_a_planted_fault(tiny_ckpt, tmp_path, fault):
    mesh, says = FAULTS[fault]
    t0 = time.time()
    with pytest.raises(AssertionError) as err:
        MC.launch(_args(tiny_ckpt, tmp_path / "run", mesh), timeout=100,
                  rank_cmd=[sys.executable, "-m", "tests.test_torch_mesh_bar", fault])
    assert time.time() - t0 < 100
    assert says in str(err.value), str(err.value)[:2000]
    with open(tmp_path / "run" / "summary.json") as f:
        summary = json.load(f)
    assert summary["failures"]
    if fault == "rank1_bias":  # 1e-3 of rank 1's images, over the largest value of the batch
        measured = summary["bar"][mesh]["joint"]["measured_by_rank"]
        assert all(1e-4 < m <= 1e-3 * (1 + 1e-5) for m in measured), measured


def test_the_unbroken_tiny_meshes_pass_with_nothing_excused(tiny_ckpt, tmp_path):
    summary = MC.launch(_args(tiny_ckpt, tmp_path / "run", "1x2,2x1"), timeout=100)
    assert summary["failures"] == []
    for mesh, checks in summary["bar"].items():
        for check, bar in checks.items():
            # nothing to excuse, so the perturbed runs are not made
            assert bar["eps"] == MC.EPS_FLOOR and bar["perturbed"] is None
            assert all(r["excused"] == 0 for r in bar["ranks"].values()), (mesh, check)
    assert set(summary["bar"]) == {"1x2", "2x1"}
    assert set(summary["bar"]["1x2"]) == {"chain"} and set(summary["bar"]["2x1"]) == {"joint",
                                                                                    "fleet"}
    # the fleet's one-process reference runs each rank's lanes as a group of its own
    assert set(summary["reference"]) == {"unet", "chain", "joint", "fleet", "joint/2", "fleet/2"}


# ---------------------------------------------------------------------------
# (b), (c) constructed results
# ---------------------------------------------------------------------------

def _pair(steps=2, seed=0):
    """A reference chain's arrays, x0-hat inside the clamp everywhere, and
    an identical copy."""
    rng = np.random.default_rng(seed)
    ref = {"sample": rng.uniform(-1, 1, (2, 8, 8, 4)).astype(np.float32),
           "pred_xstart": rng.uniform(-1, 1, (2, 8, 8, 4)).astype(np.float32),
           "sep_loss": rng.uniform(0, 1, (steps, 2)).astype(np.float32),
           "phi_trace.phi_a": rng.uniform(0, 1, (steps, 2, 3)).astype(np.float32),
           MC.TRACE + "x0_pre": rng.uniform(-0.9, 0.9, (steps, 2, 8, 8, 4)).astype(np.float32),
           MC.TRACE + "out0": rng.standard_normal((2, 8, 8, 8)).astype(np.float32),
           MC.TRACE + "guidance": np.zeros((2, 8, 8, 4), np.float32)}
    return ref, {k: v.copy() for k, v in ref.items()}


def _flip(ref, got, step, idx):
    ref[MC.TRACE + "x0_pre"][(step,) + idx] = 0.9999999
    got[MC.TRACE + "x0_pre"][(step,) + idx] = 1.0000001


def _bar(flips=1, misses=1, largest=3e-3, measured=0.0):
    moved = dict(clamp_flips=flips, sample_misses=misses, sample_max_abs=largest, x0_misses=0,
                 x0_max_abs=0.0)
    return dict(measured=measured, eps=MC.EPS_FLOOR, perturbed=[moved] * len(MC.BAR_SEEDS))


def test_a_flip_at_the_last_step_excuses_its_element_and_not_its_neighbour():
    ref, got = _pair()
    _flip(ref, got, 1, (1, 3, 5, 2))
    got["sample"][1, 3, 5, 2] += 2e-3
    verdict = MC.compare(ref, got, "constructed", bar=_bar())
    assert [e["index"] for e in verdict["excused"]] == [[1, 3, 5, 2]]
    e = verdict["excused"][0]
    assert e["flip_step"] == 1 and e["flip"] == [1, 3, 5, 2]
    assert e["x0_pre"] == [pytest.approx(0.9999999), pytest.approx(1.0000001)]
    assert e["sample"] == [float(ref["sample"][1, 3, 5, 2]), float(got["sample"][1, 3, 5, 2])]
    assert verdict["clamp_flips"] == 1 and verdict["sample_misses"] == 1
    got["sample"][1, 3, 6, 2] += 2e-3  # beside it: no flip there, and none earlier in the image
    with pytest.raises(AssertionError, match=r"sample: 1 of 512 values .* no clamp flip explains"):
        MC.compare(ref, got, "constructed", bar=_bar(misses=2))


def test_a_flip_at_an_earlier_step_excuses_its_image_and_not_another():
    ref, got = _pair(steps=3)
    _flip(ref, got, 0, (0, 7, 7, 0))
    got["sample"][0, 0, 0, 3] -= 4e-3  # far from the flip, in its image
    verdict = MC.compare(ref, got, "constructed", bar=_bar(misses=1, largest=4e-3))
    assert verdict["excused"][0]["flip_step"] == 0 and verdict["excused"][0]["flip"] == [0, 7, 7, 0]
    got["sample"][1, 0, 0, 3] -= 4e-3  # the other image has no flip
    with pytest.raises(AssertionError, match="no clamp flip explains"):
        MC.compare(ref, got, "constructed", bar=_bar(misses=2, largest=4e-3))


def test_without_a_bar_nothing_is_excused_and_other_outputs_never_are():
    ref, got = _pair()
    _flip(ref, got, 1, (1, 3, 5, 2))
    got["sample"][1, 3, 5, 2] += 2e-3
    with pytest.raises(AssertionError, match="sample"):
        MC.compare(ref, got, "unet-like")  # no bar: the strict 5e-4
    ref, got = _pair()
    _flip(ref, got, 0, (1, 3, 5, 2))
    got["pred_xstart"][1, 3, 5, 2] += 2e-3  # x0-hat after the clamp: never excused
    got["pred_xstart"][0, 3, 5, 2] += 2e-3
    with pytest.raises(AssertionError, match="pred_xstart"):
        MC.compare(ref, got, "constructed", bar=_bar())
    verdict, faults = MC.judge(ref, got, "constructed", bar=_bar())
    assert verdict["x0_misses_after_a_flip"] == 1 and verdict["x0_misses"] == 2  # image 1's
    assert len(faults) == 1 and "pred_xstart: 2 of 512" in faults[0]
    ref, got = _pair()
    got["sep_loss"][1, 0] += 2e-3 * (1 + abs(ref["sep_loss"][1, 0]))  # the loss trace: 1e-3
    with pytest.raises(AssertionError, match="sep_loss"):
        MC.compare(ref, got, "constructed", bar=_bar())


def test_the_perturbed_runs_are_made_only_to_excuse_a_value():
    made = []

    def runs():
        made.append(1)
        return _bar()["perturbed"]

    ref, got = _pair()
    got["sample"][1, 3, 5, 2] += 1e-4  # within 5e-4
    assert MC.compare(ref, got, "constructed", bar=dict(_bar(), perturbed=runs))["excused"] == []
    assert made == []
    _flip(ref, got, 1, (1, 3, 5, 2))
    got["sample"][1, 3, 5, 2] += 2e-3
    verdict = MC.compare(ref, got, "constructed", bar=dict(_bar(), perturbed=runs))
    assert len(verdict["excused"]) == 1
    assert made == [1]


def test_the_bars_noise_is_as_large_as_the_measured_difference():
    """``perturbed(relative=True)`` moves the output the way
    ``unet_difference`` measures a mesh: its largest change over the
    output's largest value is EPS; without it EPS is the noise's standard
    deviation (``--perturb``)."""
    out = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16, 16, 8)).astype(
        np.float32)) * 2.5
    model = lambda x, t: out  # noqa: E731
    eps = 3e-6
    moved = MC.perturbed(model, eps, torch.device("cpu"), seed=0, relative=True)(None, None)
    ref = {MC.TRACE + "out0": out.numpy()}
    assert MC.unet_difference(ref, {MC.TRACE + "out0": moved.numpy()}) == pytest.approx(
        eps, rel=0.05)  # within fp32 rounding of the sum
    moved = MC.perturbed(model, eps, torch.device("cpu"), seed=0)(None, None) - out
    assert float(moved.std()) == pytest.approx(eps, rel=0.1)


@pytest.mark.parametrize("bar,says", [
    (_bar(flips=0), "clamp flips, more than the 0"),
    (_bar(misses=0), "sample misses, more than the 0"),
    (_bar(largest=0.9e-3), "past 2 x the perturbed runs' largest difference"),
    (_bar(measured=3e-5), "past the cap"),
], ids=["flips", "misses", "magnitude", "cap"])
def test_the_excuse_is_bounded_by_the_perturbed_runs(bar, says):
    ref, got = _pair()
    _flip(ref, got, 1, (1, 3, 5, 2))
    got["sample"][1, 3, 5, 2] += 2e-3
    MC.compare(ref, got, "constructed", bar=_bar())  # within every bound
    with pytest.raises(AssertionError, match=says.replace("(", r"\(").replace(")", r"\)")):
        MC.compare(ref, got, "constructed", bar=bar)


def test_movement_counts_flips_misses_and_the_largest_difference():
    ref, got = _pair()
    _flip(ref, got, 0, (0, 1, 1, 1))
    _flip(ref, got, 1, (1, 2, 2, 2))
    got["sample"][0, 4, 4, 0] += 1e-2
    got["sample"][1, 4, 4, 0] += 1e-5  # within the bar
    got["pred_xstart"][1, 0, 0, 0] += 2e-3
    assert MC.movement(ref, got) == dict(
        clamp_flips=2, sample_misses=1, sample_max_abs=pytest.approx(1e-2, rel=1e-4),
        x0_misses=1, x0_max_abs=pytest.approx(2e-3, rel=1e-3))
    got[MC.TRACE + "out0"] *= 1 + 1e-6  # in fp32: within an ulp of the largest value (1.2e-7)
    assert MC.unet_difference(ref, got) == pytest.approx(1e-6, abs=1.2e-7)


# ---------------------------------------------------------------------------
# (d) the allocator history's peak
# ---------------------------------------------------------------------------

def test_peak_sites_replays_the_history_to_its_peak():
    here = os.path.join(REPO, "osmosis_tpu_torch", "parallel", "tp.py")
    f = lambda line: [{"filename": here, "line": line, "name": "forward"},  # noqa: E731
                      {"filename": "/elsewhere/torch/nn/modules/module.py", "line": 1,
                       "name": "_call_impl"}]
    events = [
        dict(action="alloc", addr=1, size=100, frames=f(10)),
        dict(action="alloc", addr=2, size=50, frames=f(20)),
        dict(action="free_requested", addr=0, size=30, frames=[]),  # held before the start
        dict(action="free_completed", addr=0, size=30, frames=[]),
        dict(action="free_requested", addr=2, size=50, frames=f(20)),  # waits for a stream
        dict(action="alloc", addr=3, size=200, frames=[]),  # the autograd engine's
        dict(action="alloc", addr=4, size=10, frames=f(10)),  # the peak: 40 + 100 + 200 + 10
        dict(action="free_completed", addr=2, size=50, frames=f(20)),
        dict(action="free_requested", addr=3, size=200, frames=[]),
        dict(action="free_completed", addr=3, size=200, frames=[]),
        dict(action="alloc", addr=5, size=60, frames=f(30)),
    ]
    rep = MC.peak_sites(events, start=70)
    assert rep["peak_bytes"] == 70 - 30 + 100 + 200 + 10
    assert rep["live_since_start_bytes"] == 310 and rep["pending_free_bytes"] == 50
    assert rep["sites"] == [
        dict(site="autograd engine (no Python frame)", bytes=200, blocks=1),
        dict(site="osmosis_tpu_torch/parallel/tp.py:10 (forward)", bytes=110, blocks=2)]
    # a history that records only the completed frees counts them there
    only = [e for e in events if e["action"] != "free_requested"]
    assert MC.peak_sites(only, start=70)["peak_bytes"] == 70 + 100 + 50 - 30 + 200 + 10


# ---------------------------------------------------------------------------
# the ranks' worker
# ---------------------------------------------------------------------------

if __name__ == "__main__":
    _plant(sys.argv[1])
    sys.exit(MC.main(sys.argv[2:]))
