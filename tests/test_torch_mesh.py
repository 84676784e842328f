"""The port's (dp, tp) mesh (``parallel/mesh``, ``parallel/tp``, the fleet
runner's ``mesh=``) against ``osmosis_tpu/parallel/mesh.py`` and against one
process, on the CPU over gloo.

* ``make_mesh``'s shapes and defaults, as tests/test_parallel.py reads them.
* The layout: for every leaf of the tiny tree and of the 552.8M tree (JAX's
  from ``jax.eval_shape``, the port's UNet on the ``meta`` device), the port
  shards what JAX's ``_param_spec`` and ``shard_params`` shard, with the same
  local sizes at tp=2 and tp=4 and the same rank-local parameter count.
* Ranks as subprocesses (``tools/mesh_check``, each under the test's time
  limit) on the dryrun's tiny config (``__graft_entry__._tiny_unet`` with its
  zero-initialized leaves drawn at 0.02, ``_guided_chain_parts``):
  - tp=2: the UNet forward and x-pullback and the batch-1 chain against the
    unsharded port (rtol/atol 5e-4, 1e-3 on the loss trace), and the chain
    against the JAX chain (``__graft_entry__.run_guided_chain``) with its
    noise fed through ``noise_fn`` at the tiny-chain bar, rtol 1e-3 / atol
    1e-4; the placements and the bytes each rank holds;
  - dp=2 and dp=2 x tp=2: the fleet runner at N=2 and N=4 against the
    unsharded fleet at 5e-4, and the joint-loss chain at the same batch
    against one process at the whole batch (its UNet called on each rank's
    share) at 5e-4 (tests/test_torch_joint_chain.py holds it against JAX).
  mesh_check's clamp-flip excuse finds nothing to excuse on any of these.
* ``shard_batch`` raises where dp does not divide the batch; NCCL ranks on
  one card raise.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from osmosis_tpu_torch.parallel import mesh as M
from osmosis_tpu_torch.parallel import multihost as MH

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TINY_KW = dict(image_size=32, in_channels=4, out_channels=8, model_channels=32, num_res_blocks=1,
               attention_resolutions=(4,), channel_mult=(1, 2), num_head_channels=16,
               use_scale_shift_norm=True, resblock_updown=True)
FULL_KW = dict(image_size=64, in_channels=4, out_channels=8, model_channels=256,
               num_res_blocks=2, attention_resolutions=(8, 16, 32),
               channel_mult=(1, 1, 2, 2, 4, 4), num_head_channels=64,
               use_scale_shift_norm=True, resblock_updown=True)
STEPS, N_ITER = 4, 2  # _guided_chain_parts' defaults


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_make_mesh_shapes():
    from osmosis_tpu.parallel import mesh as JM

    assert M.mesh_shape(8) == (2, 4)
    assert M.mesh_shape(8, dp=8, tp=1) == (8, 1)
    assert M.mesh_shape(4, dp=2, tp=2) == (2, 2)
    for n in range(1, 9):  # JAX's defaults, device count by device count
        jm = JM.make_mesh(n)
        assert M.mesh_shape(n) == (jm.shape["dp"], jm.shape["tp"])
    with pytest.raises(ValueError):
        M.mesh_shape(8, dp=3, tp=2)
    one = M.make_mesh()  # one process, no group: the trivial mesh
    assert one.shape == {"dp": 1, "tp": 1} and one.device_mesh is None
    assert one.index("dp") == one.index("tp") == 0
    with pytest.raises(ValueError):
        M.make_mesh(2)


def test_shard_batch_needs_dp_to_divide_the_batch():
    mesh = M.Mesh(dp=2, tp=1)
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(M.shard_batch(x, mesh), x[:2])
    with pytest.raises(ValueError, match="does not split"):
        M.shard_batch(x[:3], mesh)
    from torch.distributed.tensor import Replicate, Shard

    assert M.batch_sharding(mesh) == [Shard(0), Replicate()]
    assert M.replicated(mesh) == [Replicate(), Replicate()]


def test_nccl_ranks_on_one_card_raise():
    MH._check_devices("gloo", ["h/cuda:0", "h/cuda:0"])  # gloo ranks may share a card
    MH._check_devices("nccl", ["h/cuda:0", "h/cuda:1", "g/cuda:0"])
    for backend in ("nccl", "cpu:gloo,cuda:nccl"):
        with pytest.raises(RuntimeError, match="one card a rank"):
            MH._check_devices(backend, ["h/cuda:0", "h/cuda:1", "h/cuda:0"])
    with pytest.raises(ValueError, match="backend"):
        MH.initialize("127.0.0.1:1", 1, 0, backend="mpi")


def _jax_layout(kw):
    """{JAX path: (JAX shape, sharded by JAX's rule at tp=2, at tp=4)}."""
    import jax
    import jax.numpy as jnp

    from osmosis_tpu.models import UNetConfig as JaxUNetConfig
    from osmosis_tpu.models import UNetModel as JaxUNet
    from osmosis_tpu.parallel.mesh import _param_spec

    hw = kw["image_size"]
    shapes = jax.eval_shape(JaxUNet(JaxUNetConfig(**kw)).init, jax.random.key(0),
                            jnp.zeros((1, hw, hw, 4)), jnp.zeros((1,)))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = tuple(p.key for p in path)[1:]  # under "params"
        spec = _param_spec(path, leaf)
        out[keys] = (tuple(leaf.shape), {tp: "tp" in spec and leaf.shape[-1] % tp == 0
                                         for tp in (2, 4)})
    return out


@pytest.mark.parametrize("kw", [TINY_KW, FULL_KW], ids=["tiny", "552.8M"])
def test_layout_matches_jax_param_spec(kw):
    from osmosis_tpu_torch.models.convert import leaf_map
    from osmosis_tpu_torch.models.unet import UNetConfig, UNetModel

    jax_layout = _jax_layout(kw)
    cfg = UNetConfig(**kw)
    with torch.device("meta"):
        model = UNetModel(cfg)
    leaves = leaf_map(cfg)
    assert sorted(leaves[n][0] for n, _ in model.named_parameters()) == sorted(jax_layout)
    total = sum(p.numel() for p in model.parameters())
    if kw is FULL_KW:
        assert total > 550_000_000
    for tp in (2, 4):
        port = M.layout(model, tp)
        local_port = local_jax = 0
        for name, p in model.named_parameters():
            shape, jax_sharded = jax_layout[leaves[name][0]]
            assert port[name] == jax_sharded[tp], (name, shape, tp)
            assert p.numel() == int(np.prod(shape))
            local_port += p.numel() // tp if port[name] else p.numel()
            local_jax += int(np.prod(shape)) // tp if jax_sharded[tp] else int(np.prod(shape))
        assert local_port == local_jax
        # the output conv (8 channels) and the 2C FiLM projections are sharded, as in JAX
        assert port["out.2.weight"]
        assert port["input_blocks.1.0.emb_layers.1.weight"]


# ---------------------------------------------------------------------------
# ranks as subprocesses
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The dryrun's tiny UNet (zero-initialized leaves drawn at 0.02) as a
    .msgpack, its JAX model and params, and inputs with JAX-drawn chain
    noise (at batch 1, and at each batch of lanes as the JAX chain draws it
    for the whole batch)."""
    import jax
    import jax.numpy as jnp

    from osmosis_tpu.models import UNetConfig as JaxUNetConfig
    from osmosis_tpu.models import UNetModel as JaxUNet
    from osmosis_tpu.models.convert import save_params_msgpack

    tmp = tmp_path_factory.mktemp("tiny")
    model = JaxUNet(JaxUNetConfig(**TINY_KW))  # __graft_entry__._tiny_unet's, jitted
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) if np.asarray(a).any()
        else (0.02 * rng.standard_normal(np.shape(a))).astype(np.float32), params)
    ckpt = str(tmp / "tiny.msgpack")
    save_params_msgpack(params, ckpt)
    key = jax.random.key(3)
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(1, 32, 32, 4)
    y = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    def jax_noise(batch):
        return np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(jax.random.fold_in(key, t), 0), (batch, 32, 32, 4), jnp.float32))
            for t in range(STEPS)])

    noise = jax_noise(1)
    inputs = {}
    for lanes in (2, 4):
        inputs[lanes] = str(tmp / f"inputs{lanes}.npz")
        np.savez(inputs[lanes], x=x, y=y, cot=f(1, 32, 32, 8), noise=noise, xs=f(lanes, 32, 32, 4),
                 ys=rng.uniform(-1, 1, (lanes, 32, 32, 3)).astype(np.float32),
                 noises=jax_noise(lanes))
    return dict(ckpt=ckpt, model=model, params=params, key=key, x=x, y=y, inputs=inputs)


def _launch(tiny, tmp_path, ranks, meshes, lanes, budget, chain=(STEPS, N_ITER, 0.7), extra=()):
    from osmosis_tpu_torch.tools import mesh_check

    args = mesh_check.parse([
        "--checkpoint", tiny["ckpt"], "--out", str(tmp_path / "run"), "--cpu",
        "--unet", json.dumps(TINY_KW), "--size", "32", "--ranks", str(ranks), "--meshes", meshes,
        "--steps", str(chain[0]), "--n-iter", str(chain[1]), "--update-start", str(chain[2]),
        "--lanes", str(lanes), "--inputs", tiny["inputs"][lanes], *extra])
    t0 = time.time()
    summary = mesh_check.launch(args, timeout=budget)  # raises on what the bar does not excuse
    assert time.time() - t0 < budget
    # and these tiny meshes hold 5e-4 outright: the bar excuses nothing here
    assert set(summary["bar"]) == set(meshes.split(","))
    for mesh, checks in summary["bar"].items():
        assert set(checks) == set(mesh_check.checks_of(mesh)) - {"unet"}, (mesh, checks)
        for check, bar in checks.items():
            assert len(bar["ranks"]) == ranks, (mesh, check, bar)
            assert all(r["excused"] == 0 for r in bar["ranks"].values()), (mesh, check, bar)
            assert bar["perturbed"] is None, (mesh, check, bar)  # run only to excuse a value
    for mesh, reps in summary["meshes"].items():
        for r in reps:
            assert all(v["excused"] == [] for v in r["bar"].values()), (mesh, r["rank"])
    return summary


def test_tp2_unet_and_chain_match_one_process_and_jax(tiny, tmp_path):
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as G

    summary = _launch(tiny, tmp_path, 2, "1x2,2x1", 2, budget=150)
    for r in summary["meshes"]["1x2"]:
        assert set(r["differences"]) == {"unet", "chain"}
        # a rank holds the replicated parameters and its half of the sharded ones
        assert r["local_parameter_bytes"] == (r["full_parameter_bytes"]
                                              - r["sharded_parameter_bytes"] // 2)
    with open(tmp_path / "run" / "1x2_rank1.json") as f:
        placements = json.load(f)["placements"]
    from osmosis_tpu_torch.models.convert import init_unet
    from osmosis_tpu_torch.models.unet import UNetConfig

    want = M.layout(init_unet(UNetConfig(**TINY_KW)), 2)
    assert {n: p == "shard" for n, p in placements.items()} == want
    # the tp=2 chain against the JAX chain, its noise fed through noise_fn
    jres = G.run_guided_chain(tiny["model"], tiny["params"], jnp.asarray(tiny["x"]),
                              jnp.asarray(tiny["y"]), tiny["key"], batch_size=1, steps=STEPS,
                              n_iter=N_ITER)
    for k in range(2):
        got = dict(np.load(tmp_path / "run" / f"1x2_chain_rank{k}.npz"))
        np.testing.assert_allclose(got["sample"], np.asarray(jres.sample), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(got["pred_xstart"], np.asarray(jres.pred_xstart), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(got["sep_loss"], np.asarray(jres.sep_loss), rtol=1e-3,
                                   atol=1e-4)
        for name in ("phi_a", "phi_b", "phi_inf"):
            np.testing.assert_allclose(got[f"phi_trace.{name}"], np.asarray(jres.phi_trace[name]),
                                       rtol=1e-3, atol=1e-4)
        assert np.isfinite(got["sample"]).all()


# the fleets run the dryrun's production-width chain (2 steps, n_iter 1,
# update_start 1), as chip_smoke does: the 4-step chain is ill-conditioned on
# one lane of these draws (test_four_step_chain_conditioning)
FLEET_CHAIN = (2, 1, 1.0)


@pytest.mark.parametrize("ranks,meshes,lanes", [(2, "2x1", 4), (4, "2x2", 2), (4, "2x2", 4)],
                         ids=["dp2-N4", "dp2xtp2-N2", "dp2xtp2-N4"])
def test_sharded_fleets_match_one_process(tiny, tmp_path, ranks, meshes, lanes):
    summary = _launch(tiny, tmp_path, ranks, meshes, lanes, budget=150, chain=FLEET_CHAIN)
    rows = summary["meshes"][meshes]
    assert [(r["dp_index"], r["tp_index"]) for r in rows] == [
        (k // int(meshes[-1]), k % int(meshes[-1])) for k in range(ranks)]
    for r in rows:
        assert set(r["differences"]) == {"joint", "fleet"}
        # and against the whole batch in one call, which mesh_check reports
        # beside its bar: within the bar too at the 2-step chain
        for check in ("joint", "fleet"):
            for k, d in r[f"whole_batch_{check}_differences"].items():
                assert d["max_abs"] < 5e-4, (check, k, d)
            got = np.load(tmp_path / "run" / f"{meshes}_{check}_rank{r['rank']}.npz")
            assert got["sample"].shape == (lanes, 32, 32, 4)  # every image, on every rank
    # the joint chain's worst value, traced over every dp rank's images
    edge = summary["edges"][meshes]
    assert edge["max_abs"] == rows[0]["differences"]["joint"]["sample"]["max_abs"]
    assert len(edge["index"]) == 4 and len(edge["steps"]) == FLEET_CHAIN[0]
    assert all(abs(g) <= edge["gradient_clip"] * (1 + 1e-5) for g in edge["gradient"])


def test_a_failed_mesh_raises_after_every_mesh_is_reported(tiny, tmp_path, monkeypatch):
    """A mesh past the bar (forced here) raises, but only once every mesh is
    compared and summary.json holds them all; ``--perturb`` reports how far
    each one-process check moves when the UNet's output moves by 1e-7."""
    from osmosis_tpu_torch.tools import mesh_check

    real = mesh_check.judge

    def strict(ref, got, what, bar=None):
        verdict, faults = real(ref, got, what, bar)
        return verdict, faults + [f"{what}: forced"] * what.startswith("mesh 2x1 ")

    monkeypatch.setattr(mesh_check, "judge", strict)
    with pytest.raises(AssertionError, match="forced"):
        _launch(tiny, tmp_path, 2, "2x1,1x2", 2, budget=150, chain=FLEET_CHAIN,
                extra=("--perturb", "1e-7"))
    with open(tmp_path / "run" / "summary.json") as f:
        summary = json.load(f)
    # two ranks of 2x1, each failing its joint chain and its fleet
    assert len(summary["failures"]) == 4 and set(summary["meshes"]) == {"2x1", "1x2"}
    assert all(set(r["differences"]) == {"unet", "chain"} for r in summary["meshes"]["1x2"])
    assert all(set(r["differences"]) == {"joint", "fleet"} for r in summary["meshes"]["2x1"])
    cond = summary["conditioning"]
    assert set(cond) == {"unet", "chain", "joint", "joint/2", "fleet", "fleet/2"}
    assert 0 < cond["unet"]["out"]["max_abs"] < 1e-6
    assert max(d["max_abs"] for c in ("chain", "joint", "joint/2", "fleet", "fleet/2")
               for d in cond[c].values()) < 5e-5


def test_edge_report_finds_the_clamp_flip_near_the_worst_value():
    from osmosis_tpu_torch.tools.mesh_check import TRACE, chain_parts, edge_report

    rng = np.random.default_rng(0)
    ref = {"sample": rng.uniform(-1, 1, (2, 8, 8, 4)).astype(np.float32),
           TRACE + "x0_pre": rng.uniform(-0.9, 0.9, (2, 2, 8, 8, 4)).astype(np.float32),
           TRACE + "guidance": np.full((2, 8, 8, 4), 0.035, np.float32)}
    got = {k: v.copy() for k, v in ref.items()}
    got["sample"][1, 3, 5, 2] += 2e-3
    got[TRACE + "guidance"][1, 3, 5, 2] -= 2e-3
    # at the last step the clamp takes one element in one run and not the
    # other: one pixel from the worst value, and one in the other image
    for b, y, x in ((1, 3, 6), (0, 7, 7)):
        ref[TRACE + "x0_pre"][1, b, y, x, 2] = 0.9999999
        got[TRACE + "x0_pre"][1, b, y, x, 2] = 1.0000001
    rep = edge_report(ref, got, chain_parts()[3])  # scale 7,7,7,0.9, gradient clip 0.005
    assert rep["index"] == [1, 3, 5, 2]
    assert rep["max_abs"] == pytest.approx(2e-3, rel=1e-3)
    assert rep["gradient"] == pytest.approx([0.005, 0.033 / 7], rel=1e-5)
    assert [s["clamp_flips"] for s in rep["steps"]] == [0, 2]
    assert rep["steps"][0]["nearest_flip"] is None
    assert rep["steps"][1]["nearest_flip"] == [1, 3, 6, 2]
    assert rep["steps"][1]["nearest_flip_pixels"] == 1
    assert rep["steps"][1]["x0_pre"] == [float(ref[TRACE + "x0_pre"][1, 1, 3, 5, 2])] * 2


def test_four_step_chain_conditioning(tiny):
    """Why the fleets are held at the 2-step chain: with clip_denoised, the
    4-step chain (scale 7, n_iter 2) moves lane 1 of the N=2 draw by more
    than the 5e-4 bar when the UNet's output moves by 1e-7 (x0-hat at the
    clamp's edge, where the pullback's gradient jumps), in one process and
    with no mesh; the 2-step chain moves every lane by less than a tenth of
    the bar."""
    from osmosis_tpu_torch.diffusion.guided import guided_sample_loop, keyed_noise_fn
    from osmosis_tpu_torch.diffusion.sampler import SamplerConfig
    from osmosis_tpu_torch.models.convert import load_unet
    from osmosis_tpu_torch.models.unet import UNetConfig
    from osmosis_tpu_torch.tools.mesh_check import chain_parts

    model = load_unet(tiny["ckpt"], UNetConfig(**TINY_KW), "cpu")
    worst = {}
    for lanes in (2, 4):
        inp = np.load(tiny["inputs"][lanes])
        for j in range(lanes):
            x, y = torch.from_numpy(inp["xs"][j:j + 1]), torch.from_numpy(inp["ys"][j:j + 1])
            for chain in ((STEPS, N_ITER, 0.7), FLEET_CHAIN):
                schedule, op, pattern, gcfg = chain_parts(1, *chain)
                samples = []
                for eps in (0.0, 1e-7):
                    gen = torch.Generator().manual_seed(0)

                    def moved(xx, tt, eps=eps, gen=gen):
                        out = model(xx, tt)
                        return out + eps * torch.randn(out.shape, generator=gen)

                    samples.append(guided_sample_loop(
                        moved, schedule, x, y, op, gcfg, SamplerConfig(clip_denoised=True),
                        sample_pattern=pattern,
                        noise_fn=keyed_noise_fn(5, "cpu", shared_lanes=True),
                        lane_separable=True).sample)
                worst[lanes, j, chain] = float((samples[0] - samples[1]).abs().max())
    assert worst[2, 1, (STEPS, N_ITER, 0.7)] > 5e-4
    assert max(v for (_, _, c), v in worst.items() if c == FLEET_CHAIN) < 5e-5
