"""pcgs / PGDiff sampling-pattern schedules as precomputed per-timestep masks.

The reference evaluates freeze/alternate/guidance decisions with Python
branching per step (osmosis_utils/utils.py:571-630, gaussian_diffusion.py:
219-225). Here they are precomputed boolean/int arrays indexed by timestep —
identical truth tables. A numpy copy of
``osmosis_tpu/guidance/schedule_masks.py``; the port's guided loop reads them
on the host, so no step waits on the device for a branch.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _guidance_flag(sample_pattern: Optional[dict], t: int, T: int) -> bool:
    """gaussian_diffusion.py:219-222."""
    if sample_pattern is None or sample_pattern.get("pattern") in (None, "original"):
        return True
    return (
        sample_pattern["start_guidance"] * T >= t >= sample_pattern["stop_guidance"] * T
    )


def _is_freeze_phi(sample_pattern: Optional[dict], t: int, T: int) -> bool:
    """utils.py:571-590."""
    if sample_pattern is None or sample_pattern.get("pattern") == "original":
        return False
    if t > sample_pattern["start_guidance"] * T or t < sample_pattern["stop_guidance"] * T:
        return True
    if t > sample_pattern["update_start"] * T or t < sample_pattern["update_end"] * T:
        return True
    return False


def _alternate_length(sample_pattern: Optional[dict], t: int, T: int) -> int:
    """utils.py:595-630."""
    if sample_pattern is not None and sample_pattern.get("pattern") != "original":
        assert sample_pattern["update_start"] > sample_pattern["update_end"]
        assert sample_pattern["s_start"] > sample_pattern["s_end"]
        if sample_pattern["local_M"] > 1:
            assert sample_pattern["update_start"] >= sample_pattern["s_start"]
            assert sample_pattern["s_end"] >= sample_pattern["update_end"]
    if sample_pattern is None or sample_pattern.get("pattern") == "original":
        return 1
    if t > sample_pattern["start_guidance"] * T or t < sample_pattern["stop_guidance"] * T:
        return 1
    if t > sample_pattern["update_start"] * T or t < sample_pattern["update_end"] * T:
        return 1
    if t > sample_pattern["s_start"] * T or t < sample_pattern["s_end"] * T:
        return 1
    return int(sample_pattern["local_M"])


def pattern_masks(sample_pattern: Optional[dict], num_timesteps: int) -> Dict[str, np.ndarray]:
    """Per-timestep arrays: guidance[t] (bool), freeze_phi[t] (bool),
    alternate_len[t] (int32), phi_warmup[t] (int32)."""
    T = num_timesteps
    guidance = np.array([_guidance_flag(sample_pattern, t, T) for t in range(T)])
    freeze = np.array([_is_freeze_phi(sample_pattern, t, T) for t in range(T)])
    alt = np.array(
        [_alternate_length(sample_pattern, t, T) for t in range(T)], dtype=np.int32
    )
    # phi warm phase (extension beyond the reference; default 0 == exact
    # reference semantics): `phi_warmup_iters` EXTRA phi-only iterations at
    # the FIRST step of the reverse chain where phi unfreezes. Rationale
    # (VALIDATION.md 3b): with phi frozen above update_start*T, the chain
    # fits the measurement by bending J before phi ever moves; a burst of
    # physics-only descent against the current x0-hat at the unfreeze
    # boundary re-anchors phi before the joint descent resumes.
    warm = np.zeros(T, dtype=np.int32)
    n_warm = int((sample_pattern or {}).get("phi_warmup_iters", 0) or 0)
    if n_warm > 0:
        for t in range(T - 1, -1, -1):  # reverse-chain order
            if not freeze[t]:
                warm[t] = n_warm
                break
    return {
        "guidance": guidance,
        "freeze_phi": freeze,
        "alternate_len": alt,
        "phi_warmup": warm,
    }
