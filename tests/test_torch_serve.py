"""The port's warm-model server (``osmosis_tpu_torch.tools.serve``) on the CPU,
against the JAX package's ``tools/serve.py``: the routes and their codes
(healthz 503 before the warmup and 200 after it, a round trip, 400 for a bad
payload or seed, 404 for an unknown route, 500 for a fault of the model),
and one request with the JAX server's own random-init weights, x_init and
chain noise, whose phi and final loss agree within rtol 1e-4 and whose RGB
PNG is within one uint8 level. The config is ``tests/test_serve.py``'s."""

import base64
import importlib.util
import io
import json
import os
import socket
import threading
import urllib.error
import urllib.request
from http.server import HTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from osmosis_tpu_torch.models.convert import state_dict_from_jax
from osmosis_tpu_torch.models.unet import unet_config_from_yaml
from osmosis_tpu_torch.tools import serve
from tests.test_pipelines_e2e import DIFFUSION, PATTERN, TINY_UNET

_spec = importlib.util.spec_from_file_location(
    "jax_serve", os.path.join(os.path.dirname(__file__), "..", "tools", "serve.py"))
jax_serve = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_serve)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny UNet runs fastest on one thread when test workers share the
    cores; the previous setting is restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _write_config(tmp):
    cfg = dict(
        save_dir=str(tmp), degamma_input=False, manual_seed=0, rgb_guidance=False,
        save_singles=False, save_grids=False, record_process=False, record_every=20,
        sample_pattern=PATTERN, unet_model=TINY_UNET,
        diffusion=dict(DIFFUSION, timestep_respacing=10),
        conditioning=dict(method="osmosis", params=dict(
            loss_function="norm", loss_weight="depth", weight_function="gamma,1.4,1.4,1",
            scale="7,7,7,0.9", gradient_x_prev=True, gradient_clip="True,0.005")),
        aux_loss=dict(aux_loss=dict(avrg_loss=0.5, val_loss=20)),
        data=dict(batch_size=1, name="serve", root="unused", stop_after=-1,
                  ground_truth=False),
        measurement=dict(
            operator=dict(
                name="underwater_physical_revised", optimizer="sgd", depth_type="gamma",
                value="1.4,1.4,1", phi_a="1.1,0.95,0.95", phi_a_eta=1e-5,
                phi_a_learn_flag=True, phi_b="0.95, 0.8, 0.8", phi_b_eta=1e-5,
                phi_b_learn_flag=True, phi_inf="0.14, 0.29, 0.49", phi_inf_eta=1e-5,
                phi_inf_learn_flag=True),
            noise=dict(name="clean")),
    )
    path = str(tmp / "cfg.yaml")
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    return path


def _png(seed=0, shape=(40, 48, 3)):
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def _decode(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """A port server on a free local port; the healthz codes seen before
    and after the warmup."""
    restorer = serve.Restorer(_write_config(tmp_path_factory.mktemp("serve")), device="cpu",
                              warmup=False)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    httpd = HTTPServer(("127.0.0.1", port), serve.make_handler(restorer))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{port}"
    codes = []
    for warm_up in (True, False):
        try:
            with urllib.request.urlopen(f"{url}/healthz") as r:
                codes.append((r.status, json.loads(r.read())["warm"]))
        except urllib.error.HTTPError as e:
            codes.append((e.code, json.loads(e.read())["warm"]))
        if warm_up:
            restorer.warmup()
    yield url, restorer, codes
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)


def _post(url, data, query=""):
    req = urllib.request.Request(f"{url}/restore{query}", data=data, method="POST",
                                 headers={"Content-Type": "application/octet-stream"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz_answers_503_then_200_after_the_warmup(server):
    _, _, codes = server
    assert codes == [(503, False), (200, True)]


def test_restore_roundtrip_and_the_same_bytes_for_the_same_seed(server):
    url = server[0]
    code, out = _post(url, _png(), "?seed=7")
    assert code == 200
    assert _decode(out["rgb_png"]).shape == (32, 32, 3)
    assert _decode(out["depth_png"]).shape == (32, 32, 3)
    assert set(out["phi"]) == {"phi_a", "phi_b", "phi_inf"}
    assert np.isfinite(out["final_loss"]) and out["ms"] > 0
    again = _post(url, _png(), "?seed=7")[1]
    other = _post(url, _png(), "?seed=8")[1]
    assert again["rgb_png"] == out["rgb_png"] and again["phi"] == out["phi"]
    assert other["rgb_png"] != out["rgb_png"]


@pytest.mark.parametrize("data,query,code", [
    (b"not an image", "", 400),
    (_png()[:40], "", 400),  # a truncated PNG
    (_png(), "?seed=x", 400),
], ids=["not-an-image", "truncated", "bad-seed"])
def test_bad_requests_get_400(server, data, query, code):
    got, body = _post(server[0], data, query)
    assert got == code and "error" in body


def test_unknown_routes_get_404(server):
    url = server[0]
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{url}/nope")
    assert e.value.code == 404
    req = urllib.request.Request(f"{url}/nope", data=b"x", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 404


def test_a_fault_of_the_model_gets_500_not_400(server, monkeypatch):
    url, restorer, _ = server

    def broken(x, t):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(restorer, "model", broken)
    code, body = _post(url, _png(), "?seed=1")
    assert code == 500 and "RuntimeError" in body["error"]


def test_restore_matches_the_jax_restorer(tmp_path):
    """The JAX server's random-init weights (its zero-initialized leaves set
    to 0.02·N(0, 1), so that the output convs carry signal) in both servers,
    and its draws (x_init from fold_in(key(seed), 0), the chain noise from
    fold_in(fold_in(fold_in(key(seed), 1), t), i)) fed to the port."""
    path = _write_config(tmp_path)
    jr = jax_serve.Restorer(path, warmup=False)
    prng = np.random.default_rng(7)
    jr.params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) if np.asarray(a).any()
        else (0.02 * prng.standard_normal(np.shape(a))).astype(np.float32),
        jax.device_get(jr.params))
    seed, img = 7, _png(3)
    want = jr.restore(img, seed=seed)

    pr = serve.Restorer(path, device="cpu", warmup=False)
    pr.model.load_state_dict(state_dict_from_jax(
        jr.params, unet_config_from_yaml(pr.args.unet_model)))
    key = jax.random.key(seed)
    x_init = np.array(jax.random.normal(jax.random.fold_in(key, 0), (1, 32, 32, 4)))
    chain_key = jax.random.fold_in(key, 1)

    def noise_fn(t, shape, i=0):
        k = jax.random.fold_in(jax.random.fold_in(chain_key, t), i)
        return torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))

    got = pr.restore(img, seed=seed, x_init=torch.from_numpy(x_init), noise_fn=noise_fn)
    assert np.isfinite(want["final_loss"])
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-4)
    for k, v in want["phi"].items():
        np.testing.assert_allclose(got["phi"][k], v, rtol=1e-4)
    diff = np.abs(_decode(got["rgb_png"]).astype(int) - _decode(want["rgb_png"]).astype(int))
    assert diff.max() <= 1, diff.max()
