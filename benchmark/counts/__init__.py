"""Frozen work counts: the products (matmuls, convolutions, attention) of
each configuration's step from its widths and the inputs' own sizes, the
bytes and products of a kernel's calls, and the card's peaks. They count
the same work whatever implements it, so a change to the program moves the
time against them and never the count."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional


def peaks(card: str) -> Optional[Dict[str, float]]:
    """The peak rates of the card named `card` (``torch.cuda.get_device_name``),
    or None for a card the table lacks."""
    with open(Path(__file__).with_name("peaks.json")) as f:
        return json.load(f)["cards"].get(card)
