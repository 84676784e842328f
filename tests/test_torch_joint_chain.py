"""The joint-loss guided chain on a dp mesh (``guided_sample_loop(mesh=)``
with ``parallel/mesh.dp_sum`` / ``dp_mean`` / ``gather_batch``) against one
process and against the JAX chain, on the CPU over gloo.

(a) On a 2 x 2 mesh (four ranks, the worker entry at the end of this file):
    ``dp_sum`` sums over dp only (the tp ranks of one dp index hold the same
    slice), and its backward is the identity, so each rank's gradient is the
    one-process gradient of the total with respect to its slice;
    ``torch.distributed.nn.functional.all_reduce`` gives dp times that (the
    trap the identity backward avoids). ``dp_mean`` divides by the global
    element count; ``gather_batch`` undoes ``shard_batch``.
(b) The same ranks run the fake-model chains of tests/test_torch_guided.py
    (8x8, 20 steps, JAX-drawn noise through ``noise_fn``) at batch 4, two
    images a dp rank: 'ps' with the gaussian and the poisson losses, and
    'osmosis' with the mse loss, adam and x0-hat snapshots. Every rank's
    result (sample, x0-hat, the loss, phi, aux and std traces, snapshots,
    adam's moments) against JAX's ``guided_sample_loop`` at the whole batch,
    at the harness's bar, rtol 1e-4 / atol 1e-5, and against the port in
    one process.
(c) The tiny UNet's joint chain through ``tools/mesh_check`` with the
    dryrun's ``run_guided_chain`` settings (the aux losses avrg 0.5 and val
    20) at batch 2: 2x1 on its phase-1 chain (4 steps, n_iter 2), also with
    the hybrid schedule (x_prev_every 3), and 2x2 on its production-width
    chain (2 steps, n_iter 1, update_start 1; mesh_check also runs the
    fleet there, which the 4-step chain amplifies past the bar under tp,
    tests/test_torch_mesh.py::test_four_step_chain_conditioning). Each rank
    is held by mesh_check against one process at the whole batch with the
    UNet called on each rank's share (rtol/atol 5e-4, 1e-3 on the loss
    trace, with nothing excused), and here against JAX's
    ``__graft_entry__.run_guided_chain(batch_size=2)`` at the tiny-chain
    bar, rtol 1e-3 / atol 1e-4.

Every subprocess runs under its test's time limit.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osmosis_tpu.diffusion import make_schedule as jax_make_schedule
from osmosis_tpu.diffusion.guided import GuidanceConfig as JaxGuidanceConfig
from osmosis_tpu.diffusion.guided import guided_sample_loop as jax_guided_sample_loop
from osmosis_tpu.diffusion.sampler import SamplerConfig as JaxSamplerConfig
from osmosis_tpu.guidance.operators import get_operator as jax_get_operator
from osmosis_tpu_torch.diffusion.guided import GuidanceConfig, guided_sample_loop
from osmosis_tpu_torch.diffusion.sampler import SamplerConfig
from osmosis_tpu_torch.diffusion.schedules import make_schedule
from osmosis_tpu_torch.guidance.operators import get_operator
from tests.test_torch_guided import AUX, COND_PARAMS, HW, OP_KW, PATTERN, _fake_model_jax
from tests.test_torch_guided import _fake_model_torch
from tests.test_torch_mesh import FLEET_CHAIN, N_ITER, STEPS, _launch, tiny  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
B, FAKE_STEPS, RECORD_EVERY = 4, 20, 4
# name: (method, noiser, conditioning params over the harness's, operator keywords over OP_KW)
FAKE_CASES = {
    "ps_gaussian": ("ps", "gaussian", dict(scale="0.3", gradient_x_prev=True), None),
    "ps_poisson": ("ps", "poisson", dict(scale="0.3", gradient_x_prev=True), None),
    "osmosis_mse_adam": ("osmosis", "gaussian", dict(loss_function="mse"),
                         dict(optimizer="adam")),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fake_parts(case, jax_side):
    """Schedule, operator, guidance config and sampler config of a fake
    chain at batch B, from either package."""
    method, noiser, params, op_kw = FAKE_CASES[case]
    if method == "ps":
        op_name, kw, aux, params = "rgb_guidance", {}, None, params
    else:
        op_name, kw, aux = "underwater_physical_revised", dict(OP_KW, **op_kw), AUX
        params = dict(COND_PARAMS, **params)
    mods = ((jax_make_schedule, jax_get_operator, JaxGuidanceConfig, JaxSamplerConfig) if jax_side
            else (make_schedule, get_operator, GuidanceConfig, SamplerConfig))
    return (mods[0]("linear", 1000, str(FAKE_STEPS)), mods[1](op_name, batch_size=B, **kw),
            mods[2].from_config(method, params, PATTERN, aux, noiser_name=noiser),
            mods[3](clip_denoised=True))


def _fake_inputs(case, seed=0):
    """x_init, the measurement (4 channels for the poisson loss, over the
    full x0-hat) and JAX's noise for every step at batch B."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, HW, HW, 4)).astype(np.float32)
    if FAKE_CASES[case][0] == "ps":
        y = rng.uniform(0.2, 1, (B, HW, HW, 4 if FAKE_CASES[case][1] == "poisson" else 3))
    else:
        y = rng.uniform(-1, 1, (B, HW, HW, 3))
    key = jax.random.key(seed + 11)
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.fold_in(key, t), 0), (B, HW, HW, 4), jnp.float32))
        for t in range(FAKE_STEPS)])
    return x, y.astype(np.float32), key, noise


def _flat(res) -> dict:
    """A result's arrays by name (adam's moments under opt_state.m/v.*)."""
    out = {"sample": res.sample, "pred_xstart": res.pred_xstart, "sep_loss": res.sep_loss,
           "x0_std_trace": res.x0_std_trace, "x0_snapshots": res.x0_snapshots}
    for name in ("phi", "phi_trace", "aux_trace"):
        out.update({f"{name}.{k}": v for k, v in getattr(res, name).items()})
    for part in ("m", "v"):
        if isinstance(res.opt_state, dict) and part in res.opt_state:
            out.update({f"opt_state.{part}.{k}": v for k, v in res.opt_state[part].items()})
    return {k: np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items() if v is not None}


def run_fake(case, mesh=None, inputs=None):
    """The port's fake chain at batch B (on ``mesh``), as arrays."""
    x, y, _, noise = inputs if inputs is not None else _fake_inputs(case)
    schedule, op, gcfg, scfg = _fake_parts(case, jax_side=False)
    nz = torch.from_numpy(noise)
    res = guided_sample_loop(_fake_model_torch, schedule, torch.from_numpy(x), torch.from_numpy(y),
                             op, gcfg, scfg, sample_pattern=PATTERN, record_every=RECORD_EVERY,
                             noise_fn=lambda t, shape, *i: nz[int(t)], mesh=mesh)
    return _flat(res)


def _dp_ops(mesh, dp_index):
    """dp_sum / dp_mean / gather_batch on this rank's slice of a [dp, 5]
    draw, and the gradient each backward gives."""
    import torch.distributed.nn.functional as DF

    from osmosis_tpu_torch.parallel.mesh import dp_mean, dp_sum, gather_batch

    data = np.random.default_rng(0).standard_normal((mesh.dp, 5)).astype(np.float32)
    local = torch.from_numpy(data[dp_index]).requires_grad_(True)
    total = dp_sum((local ** 2).sum(), mesh)
    (grad,) = torch.autograd.grad(3.0 * total, local)
    trap = DF.all_reduce((local ** 2).sum(), group=mesh.group("dp"))
    (trap_grad,) = torch.autograd.grad(3.0 * trap, local)
    return dict(total=total.detach().numpy(), grad=grad.numpy(), trap_grad=trap_grad.numpy(),
                mean=dp_mean(local.detach(), mesh).numpy(),
                gathered=gather_batch(local.detach()[None], mesh).numpy(), data=data)


def _worker(argv):
    """A rank: ``<coordinator> <ranks> <rank> <dp> <tp> <inputs dir> <out.npz>``."""
    coordinator, ranks, rank, dp, tp, inputs_dir, out = argv
    torch.set_num_threads(1)
    from osmosis_tpu_torch.parallel import mesh as M
    from osmosis_tpu_torch.parallel import multihost as MH

    MH.initialize(coordinator, int(ranks), int(rank))
    mesh = M.make_mesh(dp=int(dp), tp=int(tp))
    arrays = {f"ops.{k}": v for k, v in _dp_ops(mesh, mesh.index("dp")).items()}
    for case in FAKE_CASES:
        inp = np.load(os.path.join(inputs_dir, f"{case}.npz"))
        got = run_fake(case, mesh, (inp["x"], inp["y"], None, inp["noise"]))
        arrays.update({f"{case}/{k}": v for k, v in got.items()})
    np.savez(out, **arrays)
    MH.barrier("joint_chain_worker_done")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The worker's results from four ranks on a 2 x 2 mesh, and each
    case's inputs."""
    from osmosis_tpu_torch.tools.mesh_check import _free_port

    tmp = tmp_path_factory.mktemp("joint")
    inputs = {}
    for case in FAKE_CASES:
        inputs[case] = _fake_inputs(case)
        x, y, _, noise = inputs[case]
        np.savez(tmp / f"{case}.npz", x=x, y=y, noise=noise)
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_joint_chain", coordinator, "4", str(k), "2", "2",
         str(tmp), str(tmp / f"rank{k}.npz")], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO, JAX_PLATFORMS="cpu"))
        for k in range(4)]
    deadline = time.time() + 120
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, p in enumerate(procs):
        assert p.returncode == 0, f"rank {k} exited {p.returncode}:\n{logs[k][-4000:]}"
    ranks = [dict(np.load(tmp / f"rank{k}.npz")) for k in range(4)]
    return ranks, inputs


def test_dp_sum_reduces_over_dp_with_an_identity_backward(four_ranks):
    ranks, _ = four_ranks
    data = ranks[0]["ops.data"]
    for k, r in enumerate(ranks):
        local = data[k // 2]  # rank k = dp_index * tp + tp_index
        # the tp ranks of a dp index are not summed: twice the total would show it
        np.testing.assert_allclose(r["ops.total"], (data ** 2).sum(), rtol=1e-6)
        # one process: d(3 * sum over the batch of x^2) / d(this rank's slice)
        np.testing.assert_allclose(r["ops.grad"], 6.0 * local, rtol=1e-6)
        np.testing.assert_allclose(r["ops.trap_grad"], 2 * 6.0 * local, rtol=1e-6)  # dp = 2
        np.testing.assert_allclose(r["ops.mean"], data.mean(), rtol=1e-6)
        np.testing.assert_array_equal(r["ops.gathered"], data)


@pytest.mark.parametrize("case", list(FAKE_CASES))
def test_fake_joint_chain_on_a_mesh_matches_jax_and_one_process(four_ranks, case):
    ranks, inputs = four_ranks
    x, y, key, noise = inputs[case]
    one = run_fake(case, inputs=inputs[case])
    schedule, op, gcfg, scfg = _fake_parts(case, jax_side=True)
    jres = jax_guided_sample_loop(_fake_model_jax, schedule, jnp.asarray(x), jnp.asarray(y), key,
                                  op, gcfg, scfg, sample_pattern=PATTERN,
                                  record_every=RECORD_EVERY)
    jflat = _flat(jres)
    assert set(jflat) == set(one), (sorted(jflat), sorted(one))
    assert one["sample"].shape == (B, HW, HW, 4) and one["sep_loss"].shape == (FAKE_STEPS, B)
    for k, r in enumerate(ranks):
        got = {n[len(case) + 1:]: v for n, v in r.items() if n.startswith(case + "/")}
        assert set(got) == set(one)
        for name, ref in jflat.items():
            assert got[name].shape == ref.shape, (k, name)
            np.testing.assert_allclose(got[name], ref, rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {k} {case} {name} against JAX")
            np.testing.assert_allclose(got[name], one[name], rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {k} {case} {name} against one process")


@pytest.mark.parametrize("ranks,mesh,chain,x_prev_every", [
    (2, "2x1", (STEPS, N_ITER, 0.7), 1), (4, "2x2", FLEET_CHAIN, 1),
    (2, "2x1", (STEPS, N_ITER, 0.7), 3)], ids=["2x1", "2x2", "2x1-hybrid3"])
def test_tiny_unet_joint_chain_matches_one_process_and_jax(tiny, tmp_path, ranks, mesh,  # noqa: F811
                                                           chain, x_prev_every):
    import __graft_entry__ as G

    summary = _launch(tiny, tmp_path, ranks, mesh, 2, budget=100, chain=chain,
                      extra=("--x-prev-every", str(x_prev_every)))  # 5e-4, nothing excused
    inp = np.load(tiny["inputs"][2])  # its noise is JAX's draw for the whole batch
    jres = G.run_guided_chain(tiny["model"], tiny["params"], jnp.asarray(inp["xs"]),
                              jnp.asarray(inp["ys"]), tiny["key"], batch_size=2, steps=chain[0],
                              n_iter=chain[1], update_start=chain[2], x_prev_every=x_prev_every)
    for r in summary["meshes"][mesh]:
        assert set(r["differences"]) == {"joint", "fleet"}
        assert r["checks"]["joint"]["launches"] is not None
        got = dict(np.load(tmp_path / "run" / f"{mesh}_joint_rank{r['rank']}.npz"))
        assert got["sample"].shape == (2, 32, 32, 4) and np.isfinite(got["sample"]).all()
        for name, ref in (("sample", jres.sample), ("pred_xstart", jres.pred_xstart),
                          ("sep_loss", jres.sep_loss),
                          *((f"phi_trace.{k}", v) for k, v in jres.phi_trace.items())):
            np.testing.assert_allclose(got[name], np.asarray(ref), rtol=1e-3, atol=1e-4,
                                       err_msg=f"{mesh} rank {r['rank']} {name}")
    with open(tmp_path / "run" / "summary.json") as f:
        assert json.load(f)["failures"] == []


if __name__ == "__main__":
    _worker(sys.argv[1:])
