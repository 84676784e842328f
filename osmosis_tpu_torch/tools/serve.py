"""Serving: a warm-model HTTP endpoint for guided restoration (the port of the
JAX package's ``tools/serve.py``).

    python -m osmosis_tpu_torch.tools.serve [-c configs/osmosis_sample_fast_config.yaml] \\
        [--port 8200] [--host 127.0.0.1] [-d <cuda idx> | --cpu]

The server loads the preset's model once (``models/preset``: the UNet or the
DiT, bf16 torso where the preset sets ``use_fp16``, on the device), runs one
whole restore of a zeros image (which builds the CUDA kernels and warms
cuDNN), then serves:

    POST /restore[?seed=N]   body: PNG/JPEG bytes -> JSON
                             {"rgb_png": <b64>, "depth_png": <b64>, "phi": {...},
                              "final_loss": x, "ms": N}
    GET  /healthz            200 once warm, 503 before

One request at a time (``HTTPServer``): one card runs one chain at a time;
run one server per card behind a load balancer. The answer is 400 for a bad
``Content-Length`` or seed and for a payload that does not decode as an
image, 404 for an unknown route, and 500, with the traceback logged, for any
other failure: a device or kernel fault is not a bad request. Without a card
and without ``--cpu`` it raises.

A request's randomness is its seed's: the measurement noise from a
generator seeded by ``seed + 1``, x_init from one seeded by ``seed``, the
chain noise keyed on (seed, t, i) (``keyed_noise_fn``), all on the device,
so one seed gives the same bytes twice; their bits differ from the JAX
server's ``jax.random`` draws.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import sys
import time
import traceback
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Optional

import numpy as np
import torch
from PIL import Image

from .. import config as C
from ..data import postprocess as P
from ..data.transforms import degamma, preprocess_image
from ..diffusion.guided import GuidanceConfig, NoiseFn, guided_sample_loop
from ..diffusion.sampler import SamplerConfig
from ..diffusion.schedules import make_schedule
from ..guidance.noise import get_noiser
from ..guidance.operators import get_operator
from ..models.preset import load_model, model_settings
from ..pipelines.restore import resolve_device, torso_dtype

MAX_BODY = 64 * 1024 * 1024


class BadImage(ValueError):
    """A request body that does not decode as an image."""


def _png_b64(a01: np.ndarray) -> str:
    buf = io.BytesIO()
    Image.fromarray((np.clip(a01, 0, 1) * 255).astype(np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


class Restorer:
    """The warm model and the guided chain of one preset, with the pre- and
    post-processing of a request."""

    def __init__(self, config_file: str, device="cuda:0", warmup: bool = True):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        args = C.arguments_from_file(config_file)
        self.args = args
        self.image_size = model_settings(args)["image_size"]
        self.dtype = torso_dtype(args)
        self.model = load_model(args, self.device, self.dtype)

        mc = args.measurement
        op_kwargs = {k: v for k, v in mc["operator"].items() if k != "name"}
        self.operator = get_operator(mc["operator"]["name"], batch_size=1, **op_kwargs)
        self.noiser = get_noiser(**mc["noise"])
        self.gcfg = GuidanceConfig.from_config(
            args.conditioning["method"], args.conditioning["params"], args.sample_pattern,
            args.aux_loss, noiser_name=mc["noise"]["name"])
        d = args.diffusion
        self.schedule = make_schedule(
            noise_schedule=d["noise_schedule"], steps=d["steps"],
            timestep_respacing=d.get("timestep_respacing", ""),
            rescale_timesteps=d.get("rescale_timesteps", False))
        self.scfg = SamplerConfig(
            sampler=d["sampler"], model_mean_type=d["model_mean_type"],
            model_var_type=d["model_var_type"],
            dynamic_threshold=d.get("dynamic_threshold", False),
            clip_denoised=d.get("clip_denoised", False))
        # each request starts from the cold phi and a fresh phi optimizer
        self.phi0 = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.operator.phi_init().items()}
        self.warm = False
        if warmup:
            self.warmup()

    def warmup(self) -> None:
        """One whole restore of a zeros image: builds the kernels and warms
        cuDNN; /healthz answers 200 from then on."""
        buf = io.BytesIO()
        Image.fromarray(np.zeros((self.image_size, self.image_size, 3), np.uint8)).save(
            buf, format="PNG")
        t0 = time.perf_counter()
        self.restore(buf.getvalue())
        print(f"[serve] warm in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
        self.warm = True

    def restore(self, img_bytes: bytes, seed: int = 0, x_init: Optional[torch.Tensor] = None,
                noise_fn: Optional[NoiseFn] = None) -> dict:
        """Restore one image. ``x_init`` and ``noise_fn`` replace the seed's
        draws (tests feed another package's draws through them). Raises
        :class:`BadImage` for bytes that do not decode as an image."""
        t0 = time.perf_counter()
        try:
            with Image.open(io.BytesIO(img_bytes)) as im:
                img = im.convert("RGB")
        except (OSError, ValueError, Image.DecompressionBombError) as e:
            raise BadImage(f"the payload does not decode as an image: {e}") from e
        dev = self.device
        ref = torch.from_numpy(preprocess_image(img, self.image_size)[None]).to(dev)
        y = self.noiser(ref, generator=torch.Generator(device=dev).manual_seed(seed + 1))
        if getattr(self.args, "degamma_input", False):
            y = degamma(y)  # noise, then degamma: the CLI's order
        if x_init is None:
            x_init = torch.randn(tuple(ref.shape[:3]) + (4,), device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(seed))
        res = guided_sample_loop(
            self.model, self.schedule, x_init.to(dev), y, self.operator, self.gcfg, self.scfg,
            sample_pattern=self.args.sample_pattern, phi_init=self.phi0, noise_fn=noise_fn,
            seed=seed)

        x0 = res.pred_xstart[0].float().cpu().numpy()
        rgb01 = P.clip01(P.to_01(x0[..., 0:3]))
        depth = P.min_max_norm_range_percentile(x0[..., 3], percent_low=0.03, percent_high=0.99)
        return {
            "rgb_png": _png_b64(rgb01),
            "depth_png": _png_b64(P.depth_to_color(depth)),
            "phi": {k: v[0].tolist() for k, v in res.phi.items()},
            "final_loss": float(res.sep_loss[-1].mean()),
            "ms": round((time.perf_counter() - t0) * 1e3, 1),
        }


def make_handler(restorer: Restorer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):
            print("[serve]", fmt % a, file=sys.stderr)

        def _send(self, code, payload: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _error(self, code, msg):
            self._send(code, json.dumps({"error": msg}).encode())

        def do_GET(self):
            if self.path == "/healthz":
                body = json.dumps({"warm": restorer.warm}).encode()
                self._send(200 if restorer.warm else 503, body)
            else:
                self._error(404, "not found")

        def do_POST(self):
            if self.path.split("?")[0] != "/restore":
                self._error(404, "not found")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                n = -1
            if n <= 0 or n > MAX_BODY:
                self._error(400, "bad content length")
                return
            body = self.rfile.read(n)
            seed = 0
            if "seed=" in self.path:
                try:
                    seed = int(self.path.split("seed=")[1].split("&")[0])
                except ValueError:
                    self._error(400, "bad seed")
                    return
            try:
                out = restorer.restore(body, seed=seed)
            except BadImage as e:
                self._error(400, str(e))
                return
            except Exception as e:  # a fault of the server or the device: logged, 500
                traceback.print_exc(file=sys.stderr)
                self._error(500, f"internal error: {type(e).__name__}: {e}")
                return
            self._send(200, json.dumps(out).encode())

    return Handler


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", "--config_file", default="configs/osmosis_sample_fast_config.yaml")
    ap.add_argument("--port", type=int, default=8200)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("-d", "--device", type=int, default=0, help="CUDA device index")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    restorer = Restorer(args.config_file, device="cpu" if args.cpu else f"cuda:{args.device}")
    srv = HTTPServer((args.host, args.port), make_handler(restorer))
    print(f"[serve] listening on {args.host}:{args.port}", file=sys.stderr)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
