"""The ``perf:`` section of a run's config (port of ``osmosis_tpu/perf.py``).

Every knob name the JAX package accepts is accepted, so a config written for
it runs here too. In the port only ``async_save`` acts: an image's PNG work
overlaps the next chain. The rest tune the TPU program's layout and are
written into the run's ``configurations.txt`` as having no effect. Each run
builds its knobs from its own config over the defaults, so no run inherits
another's.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

# the JAX package's knobs and their defaults
DEFAULTS = {
    "strip_conv": True, "strip_count": 16, "strip_min_tokens": 1024, "strip_bwd": "rot",
    "fused_norm_silu": True, "scan_unroll": 2, "gn_affine_bf16": False,
    "hybrid_scan_unroll": 1, "async_save": False, "pallas_upsample": False,
}
ACTIVE = ("async_save",)  # the knobs the port acts on


@dataclasses.dataclass(frozen=True)
class PerfConfig:
    """One run's knobs: every name of ``DEFAULTS`` with its value."""

    values: Mapping[str, object]

    @property
    def async_save(self) -> bool:
        return bool(self.values["async_save"])


def configure_from_dict(d: Optional[Mapping]) -> PerfConfig:
    """A run's knobs from its config's optional ``perf:`` section, over the
    defaults; unknown names raise."""
    d = dict(d or {})
    unknown = sorted(set(d) - set(DEFAULTS))
    if unknown:
        raise KeyError(f"unknown perf knob(s): {unknown}")
    return PerfConfig({**DEFAULTS, **d})


def snapshot_text(cfg: PerfConfig) -> str:
    """A run's knobs, for its configurations.txt."""
    lines = ["", "# perf knobs (osmosis_tpu_torch.perf)"]
    for k, v in cfg.values.items():
        lines.append(f"perf.{k}: {v}" + ("" if k in ACTIVE else "  # no effect in the port"))
    return "\n".join(lines) + "\n"
