"""The card's published peaks (``peaks.json``), which the shares of a peak
and of a roofline are taken against."""

from __future__ import annotations

import json
import os

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks(kind: str) -> dict:
    """The published peaks of the card named ``kind`` (``peaks.json``)."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    for key, row in table.items():
        if key in kind:
            return row
    raise KeyError(f"no peaks for {kind!r} in {PEAKS_FILE}")
