"""Config system: YAML files → attribute namespaces + the string mini-DSLs.

A copy of ``osmosis_tpu/config.py`` (the port imports nothing of the JAX
package), so both packages read ``configs/*.yaml`` identically.

The five shipped YAML configs are the public capability surface; their exact
string formats must keep parsing identically to the reference:
  * YAML → argparse.Namespace with nested dicts left as dicts
    (osmosis_utils/utils.py:357-476)
  * per-channel guidance scale "7,7,7,0.9" (condition_methods.py:65-73)
  * "gradient_clip: True,0.005" (condition_methods.py:99-107)
  * "weight_function: gamma,1.4,1.4,1" (utils.py:674-685)
  * phi inits "1.1,0.95,0.95" via np.fromstring (measurements.py:225-231)
  * "attention_resolutions: 32, 16, 8" → downsample-rate set (unet.py:61-68)
  * timestep_respacing int | "ddimN" (gaussian_diffusion.py:392-403)
    (+ the beyond-reference "powN@gamma" non-uniform spacing,
    diffusion/schedules.py power_timesteps)
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np
import yaml


# ---------------------------------------------------------------------------
# YAML → namespace
# ---------------------------------------------------------------------------

def load_yaml(file_path: str) -> dict:
    with open(file_path) as f:
        return yaml.load(f, Loader=yaml.FullLoader)


def add_dict_to_namespace(namespace: argparse.Namespace, args_dict: Dict[str, Any]):
    for key, value in args_dict.items():
        setattr(namespace, key, value)


def arguments_from_file(config_file_path: str) -> argparse.Namespace:
    """YAML config → Namespace; nested dicts stay dicts (utils.py:466-476)."""
    args = argparse.Namespace()
    add_dict_to_namespace(args, load_yaml(config_file_path))
    return args


def config_snapshot(config_file_path: str, txt_file_path: str):
    """Write the parsed config back out as the run's configurations.txt
    (utils.py:365-375)."""
    data = load_yaml(config_file_path)
    with open(txt_file_path, "w") as f:
        f.write(yaml.dump(data, default_flow_style=False))


# ---------------------------------------------------------------------------
# string mini-DSL parsers
# ---------------------------------------------------------------------------

def str2bool(v: Union[str, bool]) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError(f"boolean value expected, got {v!r}")


def parse_scale(scale: Union[str, float, int]) -> np.ndarray:
    """Guidance scale: scalar or per-channel CSV (condition_methods.py:65-73)."""
    try:
        return np.array([float(scale)], dtype=np.float32)
    except (ValueError, TypeError):
        return np.array(
            [float(s.strip()) for s in str(scale).split(",")], dtype=np.float32
        )


def parse_gradient_clip(spec: Union[str, bool]) -> Tuple[bool, float]:
    """"True,0.005" → (True, 0.005); "False" / False → (False, 0.0)
    (condition_methods.py:99-107)."""
    if isinstance(spec, bool):
        return spec, 0.0
    parts = [p.strip() for p in str(spec).split(",")]
    enabled = str2bool(parts[0])
    value = float(parts[1]) if enabled else 0.0
    return enabled, value


def parse_weight_function(weight_function: Union[str, None]) -> Tuple[str, Any]:
    """"gamma,1.4,1.4,1" → ("gamma", array([1.4,1.4,1.])) (utils.py:676-685)."""
    if not isinstance(weight_function, str):
        return "none", None
    parts = weight_function.split(",")
    function_str = parts[0]
    value = None
    if len(parts) > 1:
        value = np.asarray(parts[1:]).astype(float)
        value = value.item() if value.shape[0] == 1 else value
    return function_str, value


def get_depth_value(value_raw: Any) -> Any:
    """Depth-conversion 'value' field parser (utils.py:529-541)."""
    if isinstance(value_raw, float):
        return value_raw
    if isinstance(value_raw, int):
        return float(value_raw)
    if isinstance(value_raw, str):
        return np.fromstring(value_raw, dtype=float, sep=",")
    if isinstance(value_raw, (np.ndarray, np.generic)):
        return value_raw
    raise NotImplementedError(f"unsupported depth value: {value_raw!r}")


def parse_phi(phi: Union[str, float, int], batch_size: int = 1) -> np.ndarray:
    """Phi init "1.1,0.95,0.95" → float32 [B, C] (measurements.py:225-232).

    A scalar spec (haze phi_ab, measurements.py:119-120) yields [B, 1].
    """
    if isinstance(phi, (float, int)):
        vec = np.array([float(phi)], dtype=np.float32)
    else:
        vec = np.fromstring(str(phi), dtype=float, sep=",").astype(np.float32)
    return np.tile(vec[None, :], (batch_size, 1))


def parse_attention_resolutions(
    attention_resolutions: Union[str, int, Sequence[int]], image_size: int
) -> Tuple[int, ...]:
    """"32, 16, 8" at 256px → downsample rates (8, 16, 32) (unet.py:61-68)."""
    if isinstance(attention_resolutions, int):
        res_list = [attention_resolutions]
    elif isinstance(attention_resolutions, str):
        res_list = [int(r) for r in attention_resolutions.split(",")]
    else:
        res_list = [int(r) for r in attention_resolutions]
    return tuple(image_size // r for r in res_list)


def parse_channel_mult(channel_mult: Union[str, Sequence[int]], image_size: int) -> Tuple[int, ...]:
    """Empty string → per-image-size default table (unet.py:47-59)."""
    if channel_mult in ("", None):
        table = {
            512: (0.5, 1, 1, 2, 2, 4, 4),
            256: (1, 1, 2, 2, 4, 4),
            128: (1, 1, 2, 3, 4),
            64: (1, 2, 3, 4),
        }
        if image_size not in table:
            raise ValueError(f"unsupported image size: {image_size}")
        return table[image_size]
    if isinstance(channel_mult, str):
        return tuple(int(m) for m in channel_mult.split(","))
    return tuple(channel_mult)
