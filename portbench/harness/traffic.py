"""The one traffic generator: a traffic mix's parameters (a JSON file under
``portbench/traffic/``) and a preset give the images and the segments a run
drives, all drawn from ``--seed``.

Parameters of a mix:
  * ``lanes``: images restored together (1: the batch-1 chain; N > 1: a
    fleet of N through the batched runner);
  * ``segment_steps``: the steps of one call, a multiple of
    ``x_prev_every``; the slice is cut as ``progress_segments`` cuts a
    chain (the last segment takes the remainder);
  * ``checked_steps``: how many of the window's steps, drawn uniformly from
    the seed, are recorded and checked besides the window's first step and
    its first segment's last;
  * ``trace_segments``: the segments a traced run traces after its window.

Every mix runs the phi-update slice: the steps where the preset's pcgs
pattern updates phi, from the first chain position (counted from the
chain's first step) that is a multiple of ``x_prev_every`` down to t = 0.
Its measurement y is uniform in [-1, 1], 3 channels at the preset's image
size. When the slice ends, the next image starts at its first step with a
fresh x_t ~ N(0, 1), a fresh y and a cold phi. Image k draws its x_t, y and
chain seed from generators seeded by (seed, k); every image and every lane
of one run has the same sizes, so seeds change values, not work.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from reference.diffusion import Preset, draw_seed


@dataclasses.dataclass
class Segment:
    image: int
    ts: List[int]
    first: bool   # the image's first segment


def phi_update_slice(P: Preset) -> List[int]:
    """Descending timesteps of the phi-update slice."""
    k = P.x_prev_every if P.x_prev_every > 1 and P.gradient_x_prev else 1
    open_ = [p for p in range(P.T) if not P.frozen(P.T - 1 - p)]
    start = -(-open_[0] // k) * k
    ts = [P.T - 1 - p for p in range(start, P.T)]
    if any(P.frozen(t) for t in ts):
        raise ValueError("the phi-update window is not one run of steps down to t = 0")
    return ts


def cut(ts: List[int], base: int) -> List[List[int]]:
    """Segments of ``base`` steps, the last one taking the remainder."""
    out, done = [], 0
    while done < len(ts):
        n = base if len(ts) - done >= 2 * base else len(ts) - done
        out.append(ts[done:done + n])
        done += n
    return out


class Traffic:
    def __init__(self, mix: dict, P: Preset, image_size: int, seed: int, device):
        self.mix, self.lanes, self.size = mix, int(mix["lanes"]), image_size
        self.seed, self.device = int(seed), device
        self.slice = phi_update_slice(P)
        k = P.x_prev_every if P.gradient_x_prev else 1
        if int(mix["segment_steps"]) % k:
            raise ValueError("segment_steps must be a multiple of x_prev_every")
        self.segments_per_image = cut(self.slice, int(mix["segment_steps"]))
        self.x_prev_every = k

    def segments(self):
        """The run's segments, image after image, without end."""
        image = 0
        while True:
            for i, ts in enumerate(self.segments_per_image):
                yield Segment(image, ts, i == 0)
            image += 1

    def _gen(self, image: int, what: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(draw_seed(self.seed, 7, image, what))

    def x_start(self, image: int) -> torch.Tensor:
        return torch.randn((self.lanes, self.size, self.size, 4), generator=self._gen(image, 0),
                           device=self.device)

    def measurement(self, image: int) -> torch.Tensor:
        y = torch.empty((self.lanes, self.size, self.size, 3), device=self.device)
        return y.uniform_(-1.0, 1.0, generator=self._gen(image, 1))

    def chain_seed(self, image: int) -> int:
        """The seed the program keys image ``image``'s chain noise on (one
        for all lanes of a fleet, as a run of the fleet passes one)."""
        return draw_seed(self.seed, 7, image, 2) & 0x7FFFFFFF

    def record_plan(self):
        """``Tap.arm``'s arguments: the window's first step and its first
        segment's last step (a boundary the next segment carries on from),
        and ``checked_steps`` more drawn from the window's other steps."""
        rng = np.random.default_rng(draw_seed(self.seed, 7, 1 << 20))
        return {0, len(self.segments_per_image[0]) - 1}, int(self.mix["checked_steps"]), rng
