"""The port's toy-prior trainer and prior-health tools against the JAX
package's (``tools/train_toy_prior.py``, ``tools/check_prior_stats.py``).

Tolerances, each with its reason:
* scenes from JAX-drawn lattices: 5e-7 absolute (values in [-1, 1]; the
  bilinear upsample sums in another order; edge pixels included);
* one train step from the same weights and inputs: the loss within 1e-5
  relative; every parameter's gradient within 2e-4 of its leaf's largest
  magnitude plus 1e-7 (float32 sums over the batch and the pixels in
  another order; the biases of convs that feed a GroupNorm have a gradient
  of zero up to rounding, ~1e-9);
* three Adam + EMA steps: each element within 1e-6 plus, for each step,
  lr·min(2, 2·dg/(sqrt(nu_hat) + eps)): what Adam's update makes of dg, the
  difference between the two packages' gradients. That is about lr·steps·2
  where a gradient is zero up to rounding (the biases of convs that feed a
  GroupNorm, whose update is then ±lr a step on noise) or near Adam's eps,
  and under 1e-7 more elsewhere. The EMA within 1e-6 plus (1 - decay) of it.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from osmosis_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from osmosis_tpu.models import UNetModel as JaxUNet
from osmosis_tpu.models import convert as JC
from osmosis_tpu_torch.models import convert as C
from osmosis_tpu_torch.tools import check_prior_stats as PS
from osmosis_tpu_torch.tools import train_toy_prior as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny models run fastest on one thread when test workers share the
    cores; the previous setting is restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)



def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _load_tool("train_toy_prior")
SIZE, CH, B, T, LR = 16, 32, 4, 100, 1e-3


def _jax_lattices(key, batch):
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)

    def u(k, shape, lo=-1.0, hi=1.0):
        return np.array(jax.random.uniform(k, shape, minval=lo, maxval=hi))

    return {"rgb4": u(k1, (batch, 4, 4, 3)), "rgb8": u(k2, (batch, 8, 8, 3)),
            "gain": u(k3, (batch, 1, 1, 3), 0.6, 1.0),
            "depth4": u(k4, (batch, 4, 4, 1)), "depth8": u(k5, (batch, 8, 8, 1))}


@pytest.mark.parametrize("size", [16, 32, 128])
def test_compose_scenes_matches_jax_synth_scene_batch(size):
    key = jax.random.key(size)
    want = np.asarray(J.synth_scene_batch(key, 3, size))
    got = P.compose_scenes({k: torch.from_numpy(v) for k, v in _jax_lattices(key, 3).items()},
                           size).numpy()
    assert got.shape == want.shape == (3, size, size, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
    edge = np.zeros((size, size), bool)
    edge[[0, -1], :] = edge[:, [0, -1]] = True
    np.testing.assert_allclose(got[:, edge], want[:, edge], rtol=0, atol=5e-7)


def test_scene_draws_have_the_jax_ranges():
    d = P.scene_draws(torch.Generator().manual_seed(0), 64)
    assert d["rgb4"].shape == (64, 4, 4, 3) and d["depth8"].shape == (64, 8, 8, 1)
    assert -1.0 <= d["rgb8"].min() and d["rgb8"].max() < 1.0
    assert 0.6 <= d["gain"].min() and d["gain"].max() < 1.0
    x = P.compose_scenes(d, 32)
    assert x.min() >= -1.0 and x.max() <= 1.0


def test_toy_configs_match_jax():
    for arch in ("toy", "production"):
        ours, theirs = P.toy_unet_config(64, 64, arch), J.toy_unet_config(64, 64, arch)
        for f in ("image_size", "in_channels", "out_channels", "model_channels", "channel_mult",
                  "attention_resolutions", "num_head_channels", "num_res_blocks",
                  "use_scale_shift_norm", "resblock_updown", "use_new_attention_order"):
            assert getattr(ours, f) == getattr(theirs, f), (arch, f)


# ---------------------------------------------------------------------------
# one step and three Adam steps against JAX
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def setup():
    """JAX params with the zero inits randomized (else the zero output conv
    zeroes every earlier gradient), the same weights in the port, and the
    schedule constants of both."""
    jcfg = J.toy_unet_config(SIZE, CH, "toy")
    params = jax.jit(JaxUNet(jcfg).init)(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 4)),
                                         jnp.zeros((1,)))
    rng = np.random.default_rng(100)
    params = jax.tree_util.tree_map(
        lambda a: (0.02 * rng.standard_normal(a.shape)).astype(np.float32)
        if not np.asarray(a).any() else np.asarray(a), params)
    consts = jax_make_schedule("linear", T).device_constants()
    sab = jnp.asarray(consts["sqrt_alphas_cumprod"])
    s1m = jnp.asarray(consts["sqrt_one_minus_alphas_cumprod"])

    def jax_loss(p, x0, t, eps):  # tools/train_toy_prior.py:206-233 with the draws given
        xt = sab[t][:, None, None, None] * x0 + s1m[t][:, None, None, None] * eps
        out = JaxUNet(jcfg).apply(p, xt, t.astype(jnp.float32))
        return jnp.mean((out[..., :4] - eps) ** 2)

    pcfg = P.toy_unet_config(SIZE, CH, "toy")
    port_consts = (torch.from_numpy(consts["sqrt_alphas_cumprod"]),
                   torch.from_numpy(consts["sqrt_one_minus_alphas_cumprod"]))
    return dict(params=params, jax_loss=jax_loss, pcfg=pcfg, consts=port_consts)


def _port_model(setup):
    model = C.init_unet(setup["pcfg"])
    model.load_state_dict(C.state_dict_from_jax(setup["params"], setup["pcfg"]))
    return model.to(memory_format=torch.channels_last)


def _batch(seed):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(J.synth_scene_batch(jax.random.key(seed), B, SIZE))
    return x0, rng.integers(0, T, B), rng.standard_normal(x0.shape).astype(np.float32)


def _port_batch(x0, t, eps):
    x0, eps = torch.tensor(x0), torch.tensor(eps)
    return P.Batch(x0, torch.tensor(t), eps, eps)


def test_one_train_step_matches_jax_value_and_grad(setup):
    x0, t, eps = _batch(1)
    jl, jg = jax.jit(jax.value_and_grad(setup["jax_loss"]))(setup["params"], x0, t, eps)
    model = _port_model(setup)
    loss = P.diffusion_loss(model, _port_batch(x0, t, eps), *setup["consts"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    got = _leaves(C.params_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()}, setup["pcfg"]))
    want = _leaves(jg)
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= 2e-4 * np.abs(w).max() + 1e-7, (k, err, np.abs(w).max())


def test_three_adam_and_ema_steps_match_optax(setup):
    tx = optax.adam(LR)
    decay, steps, adam_eps = 0.999, 3, 1e-8

    @jax.jit
    def jax_step(p, s, e, x0, t, eps):  # tools/train_toy_prior.py:235-244
        _, g = jax.value_and_grad(setup["jax_loss"])(p, x0, t, eps)
        u, s = tx.update(g, s, p)
        p = optax.apply_updates(p, u)
        e = jax.tree_util.tree_map(lambda a, b: decay * a + (1 - decay) * b, e, p)
        return p, s, e, g

    jp, st, je = setup["params"], tx.init(setup["params"]), setup["params"]
    model = _port_model(setup)
    opt = P.make_optimizer(model, LR)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    ema = [p.detach().clone() for p in params]
    # each element's limit: 1e-6 (a few float32 ulps of the largest weight,
    # 1.0) plus, for each step, lr * min(2, 2 * dg / (sqrt(nu_hat) + eps)),
    # what Adam's update can make of dg, the largest difference so far
    # between the two packages' gradients of that element, with nu_hat the
    # reference's bias-corrected second moment
    delta, moved = {}, {}
    for i in range(steps):
        x0, t, eps = _batch(10 + i)
        jp, st, je, jg = jax_step(jp, st, je, x0, t, eps)
        loss = P.diffusion_loss(model, _port_batch(x0, t, eps), *setup["consts"])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        ours = _leaves(C.params_from_state_dict(
            {n: p.grad for n, p in model.named_parameters()}, setup["pcfg"]))
        nu = _leaves(st[0].nu)
        for k, g in _leaves(jg).items():
            delta[k] = np.maximum(delta.get(k, 0.0), np.abs(ours[k] - g))
            s = np.sqrt(nu[k] / (1 - 0.999 ** (i + 1)))
            moved[k] = moved.get(k, 0.0) + LR * np.minimum(2.0, 2 * delta[k] / (s + adam_eps))
        opt.step()
        P.update_ema(ema, params, decay)
    for what, ours, theirs, scale in (("params", params, jp, 1.0),
                                      ("ema", ema, je, 1 - decay)):
        got = _leaves(C.params_from_state_dict(
            {n: v.detach() for n, v in zip(names, ours)}, setup["pcfg"]))
        want = _leaves(theirs)
        assert set(got) == set(want)
        for k in want:
            err = np.abs(got[k] - want[k])
            limit = 1e-6 + scale * moved[k]
            assert (err <= limit).all(), (what, k, err.max(), (err - limit).max())
    # the loose limits are where a gradient is zero up to rounding (the biases
    # of convs that feed a GroupNorm, whole) or near Adam's eps at some step
    loose = sum((1e-6 + moved[k] > 2e-6).sum() for k in moved)
    assert 0 < loose < 0.01 * sum(m.size for m in moved.values())


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _args(*extra):
    return P.build_parser().parse_args(
        ["--cpu", "--size", str(SIZE), "--channels", str(CH), "--T", str(T), *extra])


def test_thirty_steps_reduce_the_loss():
    """As tests/test_toy_prior.py:42-86: the mean of the last 5 losses under
    0.8 of the first 5."""
    tr = P.ToyTrainer(_args("--batch", "16", "--lr", "1e-3", "--seed", "1"), "cpu")
    losses = [tr.step().item() for _ in range(30)]
    assert np.isfinite(losses).all()
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < 0.8 * first, f"no learning: {first:.3f} -> {last:.3f}"
    # the EMA moved from the initial weights, by far less than the weights
    init = C.init_unet(tr.cfg, 0)
    moved = [(e - p0).abs().max().item() for e, p0 in zip(tr.ema, init.parameters())]
    assert max(moved) > 0


def test_cli_warm_start_and_jax_reads_both_files(tmp_path, capsys):
    """As tests/test_toy_prior.py:173-187: a short run saves the EMA and the
    raw weights, the JAX package's load_params_msgpack reads both into its
    UNet's tree, and --init-from warm-starts from the raw file."""
    out = str(tmp_path / "p.msgpack")
    base = ["--cpu", "--steps", "2", "--chunk", "1", "--size", str(SIZE), "--channels", str(CH),
            "--batch", "2", "--T", str(T), "--health-check", "0", "--out", out]
    report = P.main(base)
    raw = out.replace(".msgpack", "_raw.msgpack")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert report["ema"] == out and report["raw"] == raw and report["steps"] == 2
    jcfg = J.toy_unet_config(SIZE, CH, "toy")
    ref = jax.jit(JaxUNet(jcfg).init)(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 4)),
                                      jnp.zeros((1,)))
    apply = jax.jit(JaxUNet(jcfg).apply)
    trees = {}
    for path in (out, raw):
        tree = JC.load_params_msgpack(path)
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(ref)
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(ref)):
            assert a.shape == b.shape and a.dtype == b.dtype
        y = apply(tree, jnp.ones((1, SIZE, SIZE, 4)), jnp.ones((1,)))
        assert np.isfinite(np.asarray(y)).all()
        trees[path] = tree
    assert any(not np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(trees[out]), jax.tree_util.tree_leaves(trees[raw])))

    warm = P.ToyTrainer(_args("--init-from", raw, "--seed", "9", "--batch", "2"), "cpu")
    want = C.state_dict_from_jax(trees[raw], warm.cfg)
    for n, p in warm.model.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
    assert "warm-start from" in capsys.readouterr().err
    P.main(base + ["--init-from", raw, "--seed", "9"])  # loads, trains, saves again
    assert os.path.exists(out) and os.path.exists(raw)


def test_save_every_fires_on_each_boundary_crossed(tmp_path, capsys):
    out = str(tmp_path / "s.msgpack")
    P.main(["--cpu", "--steps", "6", "--chunk", "2", "--save-every", "3", "--size", str(SIZE),
            "--channels", str(CH), "--batch", "2", "--T", str(T), "--health-check", "0",
            "--out", out])
    err = capsys.readouterr().err
    assert "checkpointed at step 4" in err and "checkpointed at step 2" not in err
    assert "step      6  loss" in err
    assert not os.path.exists(out + ".tmp")


def test_offset_noise_and_input_perturbation_draw_in_the_jax_order():
    gen = torch.Generator().manual_seed(3)
    args = _args("--batch", "2", "--offset-noise", "0.1", "--input-perturb", "0.2")
    b = P.draw_batch(gen, args, "cpu")
    ref = torch.Generator().manual_seed(3)
    x0 = P.synth_scene_batch(ref, 2, SIZE)
    t = torch.randint(0, T, (2,), generator=ref)
    eps = torch.randn(x0.shape, generator=ref)
    eps = eps + 0.1 * torch.randn((2, 1, 1, 4), generator=ref)
    eps_in = eps + 0.2 * torch.randn(x0.shape, generator=ref)
    for a, r in zip(b, (x0, t, eps, eps_in)):
        assert torch.equal(a, r)
    plain = P.draw_batch(torch.Generator().manual_seed(3), _args("--batch", "2"), "cpu")
    assert plain.eps is plain.eps_input and torch.equal(plain.x0, x0)


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.main(["--steps", "1", "--chunk", "1", "--out", str(tmp_path / "x.msgpack")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.main(["--checkpoint", str(tmp_path / "x.msgpack")])


# ---------------------------------------------------------------------------
# the prior-health tools
# ---------------------------------------------------------------------------

def test_stats_match_jax():
    S = _load_tool("check_prior_stats")
    rng = np.random.default_rng(0)
    rgb = rng.uniform(-0.5, 0.5, (2, 16, 16, 3)).astype(np.float32)
    lum = rgb.mean(axis=-1, keepdims=True)
    for x in (np.concatenate([rgb, lum], -1), np.concatenate([rgb, -lum], -1),
              np.zeros((1, 8, 8, 4), np.float32),
              rng.uniform(-1, 1, (3, 12, 10, 4)).astype(np.float32)):
        assert PS.stats(x) == S.stats(x)


@pytest.fixture()
def tiny_prior():
    return C.init_unet(P.toy_unet_config(SIZE, CH, "toy"), 0).requires_grad_(False).eval()


def test_prior_health_reports_both_stats(tiny_prior):
    for mode in ("noise", "q_sample"):
        h = PS.prior_health(tiny_prior, size=SIZE, n=2, steps=3, seed=1, init_mode=mode)
        assert set(h) == {"prior_samples", "train_scenes"}
        assert set(h["prior_samples"]) == {"lum_depth_corr", "rgb_std", "depth_std", "tv",
                                           "rgb_range"}
        assert np.isfinite(h["prior_samples"]["rgb_std"])


def test_eps_bias_table_tiny(tiny_prior):
    """As tests/test_toy_prior.py:116-143 on a random-init prior (its output
    conv is zero, so eps_hat is 0: proj 0 and rel 1)."""
    rows = PS.eps_bias_table(tiny_prior, size=SIZE, batch=2, ts=(100, 900))
    assert [r["t"] for r in rows] == [100, 900]
    for r in rows:
        for k in ("proj", "rel", "x0hat_rgb_std", "x0hat_depth_std", "eps_mean_bias_rgb",
                  "eps_mean_bias_depth"):
            assert np.isfinite(r[k]), (k, r)
    assert abs(rows[0]["proj"]) < 0.5 and 0.5 < rows[0]["rel"] < 2.0


def test_trajectory_table_tiny(tiny_prior):
    rows = PS.trajectory_table(tiny_prior, size=SIZE, n=1, ts=(999, 500, 0))
    assert [r["t"] for r in rows] == [999, 500, 0]
    assert 0.8 < rows[0]["xt_std"] < 1.2


def test_check_prior_stats_cli_reads_a_port_checkpoint(tmp_path, capsys, tiny_prior):
    path = str(tmp_path / "prior.msgpack")
    cfg = P.toy_unet_config(SIZE, CH, "toy")
    C.save_params_msgpack(C.params_from_state_dict(tiny_prior.state_dict(), cfg), path)
    common = ["--checkpoint", path, "--size", str(SIZE), "--channels", str(CH), "--arch", "toy",
              "--cpu", "--n", "1"]
    PS.main(common + ["--eps-bias"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["t"] for r in rows] == [25, 100, 300, 500, 700, 850, 950, 999]
    PS.main(common + ["--steps", "2"])
    assert set(json.loads(capsys.readouterr().out)) == {"prior_samples", "train_scenes"}


def test_convert_checkpoint_writes_what_the_jax_converter_writes(tmp_path):
    """A .pt state_dict of the preset plan at width 64 and 64² (34.5M
    parameters): the port's tool and the JAX converter give the same bytes."""
    from osmosis_tpu.models import UNetConfig as JaxUNetConfig
    from osmosis_tpu_torch.models.unet import UNetConfig
    from osmosis_tpu_torch.tools.convert_checkpoint import main

    cfg = UNetConfig(image_size=64, model_channels=64)
    pt = str(tmp_path / "m.pt")
    torch.save(C.init_unet(cfg, 4).state_dict(), pt)
    out = main([pt, "--image-size", "64", "--model-channels", "64"])
    assert out == str(tmp_path / "m.msgpack")
    want = str(tmp_path / "jax.msgpack")
    JC.save_params_msgpack(JC.convert_state_dict(JC.load_torch_state_dict(pt),
                                                 JaxUNetConfig(image_size=64, model_channels=64)),
                           want)
    with open(out, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
