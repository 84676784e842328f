"""Run-directory contract (reference README.md:434-448):

    <save_dir>/<operator>/<dataset>/<d-m-yy>/run<N>/
        configurations.txt
        log.txt
        single_images/{input, rgb, depth_color, depth_raw}/
        grid_results/

runN auto-increments on collision (osmosis_utils/utils.py:418-435).
A copy of ``osmosis_tpu/utils/rundir.py``.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Dict, Optional


def update_save_dir_date(base_dir: str, resume: bool = False) -> str:
    """Allocate <base>/<d-m-yy>/runN. With ``resume=True``, re-enter today's
    most recent existing runN instead of allocating a fresh one, so the
    per-image skip logic can actually find previous outputs."""
    today = datetime.date.today()
    stamp = f"{today.day}-{today.month}-{today.year % 2000}"
    save_dir = os.path.join(base_dir, stamp, "run1")
    last = None
    while os.path.exists(save_dir):
        last = save_dir
        digits = re.findall(r"\d+$", save_dir)[0]
        save_dir = f"{save_dir[: -len(digits)]}{int(digits) + 1}"
    if resume and last is not None:
        return last
    os.makedirs(save_dir, exist_ok=True)
    return save_dir


def make_output_dirs(
    out_path: str, save_singles: bool, save_grids: bool,
    singles_subdirs=("input", "rgb", "depth_color", "depth_raw"),
) -> Dict[str, Optional[str]]:
    """osmosis_sampling.py:84-105 layout."""
    paths: Dict[str, Optional[str]] = {"out": out_path}
    if save_singles:
        singles = os.path.join(out_path, "single_images")
        for sub in singles_subdirs:
            p = os.path.join(singles, sub)
            os.makedirs(p, exist_ok=True)
            paths[sub] = p
        paths["singles"] = singles
    else:
        paths["singles"] = None
    if save_grids:
        grids = os.path.join(out_path, "grid_results")
        os.makedirs(grids, exist_ok=True)
        paths["grids"] = grids
    else:
        paths["grids"] = None
    return paths
