"""Seeds derived from a run's ``--seed`` (any non-negative integer, also
past 32 bits): one independent stream per use, named by a word."""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, *words) -> int:
    """A 63-bit seed for the use named by `words` (strings or ints)."""
    key = [int(seed)] + [zlib.crc32(w.encode()) if isinstance(w, str) else int(w) for w in words]
    hi, lo = np.random.SeedSequence(key).generate_state(2)
    return ((int(hi) << 32) | int(lo)) >> 1


def rng(seed: int, *words) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *words))
