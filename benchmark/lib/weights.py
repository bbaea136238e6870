"""Seeded weights, made on the device in one draw.

A configuration's plain reference lists its tensors as ``(name, shape, lo,
hi)`` (``weight_layout``); ``state_dict`` fills one flat float32 buffer with
a single uniform draw from a ``torch.Generator`` on `device` seeded from the
run's seed, and hands out each tensor as a view of it (each starting at a
multiple of 256 bytes, as the kernels want their operands aligned), mapped
onto [lo, hi).
The same seed gives the same dict on one device, so the program and the
reference get equal weights without either one deriving them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Layout = List[Tuple[str, Sequence[int], float, float]]
ALIGN = 64          # float32 elements: 256 bytes


def state_dict(layout: Layout, seed: int, device) -> Dict[str, torch.Tensor]:
    sizes = [math.prod(shape) for _, shape, _, _ in layout]
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + -(-n // ALIGN) * ALIGN)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.rand(starts[-1], generator=g, device=device)
    out = {}
    for (name, shape, lo, hi), n, at in zip(layout, sizes, starts):
        t = flat[at: at + n].view(*shape)
        t.mul_(hi - lo).add_(lo)
        out[name] = t
    return out

