"""The ``perf:`` section of a run's config (port of ``osmosis_tpu/perf.py``).

Every knob name the JAX package accepts is accepted, so a config written for
it runs here too. In the port only ``async_save`` acts: an image's PNG work
overlaps the next chain. The rest tune the TPU program's layout and are
written into the run's ``configurations.txt`` as having no effect. Each run
builds its knobs from its own config over the defaults, so no run inherits
another's; the JAX package's ``OSMOSIS_TPU_*`` environment variables
override both, as a debugging aid, and ``configurations.txt`` holds the
values after them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

# the JAX package's knobs and their defaults
DEFAULTS = {
    "strip_conv": True, "strip_count": 16, "strip_min_tokens": 1024, "strip_bwd": "rot",
    "fused_norm_silu": True, "scan_unroll": 2, "gn_affine_bf16": False,
    "hybrid_scan_unroll": 1, "async_save": False, "pallas_upsample": False,
}
ACTIVE = ("async_save",)  # the knobs the port acts on
# each knob's environment override, as the JAX package names it
ENV = {name: "OSMOSIS_TPU_" + name.upper() for name in DEFAULTS}
# the legacy alias: OSMOSIS_TPU_STRIP_BWD_FLAT=1 is OSMOSIS_TPU_STRIP_BWD=flat
BWD_FLAT_ENV = "OSMOSIS_TPU_STRIP_BWD_FLAT"


def _coerce(default, raw: str):
    """An environment value as the type of the knob's default."""
    if isinstance(default, bool):
        return raw not in ("0", "false", "False", "")
    if isinstance(default, int):
        return int(raw)
    return raw


def env_overrides() -> dict:
    """The knobs that ``OSMOSIS_TPU_*`` variables set now (an empty value
    sets nothing)."""
    out = {name: _coerce(DEFAULTS[name], os.environ[var])
           for name, var in ENV.items() if os.environ.get(var)}
    if os.environ.get(BWD_FLAT_ENV) == "1":
        out["strip_bwd"] = "flat"
    return out


@dataclasses.dataclass(frozen=True)
class PerfConfig:
    """One run's knobs: every name of ``DEFAULTS`` with its value."""

    values: Mapping[str, object]

    @property
    def async_save(self) -> bool:
        return bool(self.values["async_save"])


def configure_from_dict(d: Optional[Mapping]) -> PerfConfig:
    """A run's knobs: the defaults, then its config's optional ``perf:``
    section, then the environment's overrides; unknown names raise."""
    d = dict(d or {})
    unknown = sorted(set(d) - set(DEFAULTS))
    if unknown:
        raise KeyError(f"unknown perf knob(s): {unknown}")
    return PerfConfig({**DEFAULTS, **d, **env_overrides()})


def snapshot_text(cfg: PerfConfig) -> str:
    """A run's knobs, for its configurations.txt."""
    lines = ["", "# perf knobs, effective (osmosis_tpu_torch.perf; env overrides applied)"]
    for k, v in cfg.values.items():
        lines.append(f"perf.{k}: {v}" + ("" if k in ACTIVE else "  # no effect in the port"))
    return "\n".join(lines) + "\n"
