"""String-keyed component registries.

The reference wires every pluggable component (samplers, operators,
conditioning methods, noise models, aux losses) through ``@register_*``
decorators + ``get_*`` factories (reference: guided_diffusion/
gaussian_diffusion.py:19-35, measurements.py:16-38,441-459,
condition_methods.py:8-24, osmosis_utils/losses.py:8-24). The registry name
strings are part of the YAML config surface, so we keep the exact same
pattern with one generic implementation. A copy of ``osmosis_tpu/registry.py``
with registries of its own, filled by the port's modules.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, TypeVar

T = TypeVar("T")


class Registry:
    """A named string → object registry with decorator registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Any] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def wrapper(obj: T) -> T:
            if name in self._items:
                raise NameError(f"{self.kind} name '{name}' is already registered!")
            self._items[name] = obj
            return obj

        return wrapper

    def get(self, name: str) -> Any:
        if name not in self._items:
            raise NameError(
                f"{self.kind} name '{name}' is not defined! "
                f"known: {sorted(self._items)}"
            )
        return self._items[name]

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def names(self):
        return sorted(self._items)


SAMPLERS = Registry("sampler")
OPERATORS = Registry("operator")
CONDITIONERS = Registry("conditioning method")
NOISES = Registry("noise")
LOSSES = Registry("loss")
