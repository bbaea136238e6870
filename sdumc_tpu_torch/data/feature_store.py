"""Feature stores: where per-clip [T, D] arrays come from.

The contract: a directory per feature type holding ``{clip}.npy``, read
lazily. ``SyntheticSource`` stands in for it where no dataset is on disk.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, List, Sequence

import numpy as np


def stable_seed(*parts) -> int:
    """A 32-bit seed from the parts' text that is the same in every
    process. (``hash()`` of a str is salted per process, so seeds built on
    it differ between processes and hosts.)"""
    return zlib.crc32("\0".join(str(p) for p in parts).encode())


class NpyDirSource:
    """Reads ``{root}/{feature_name}/{clip}.npy`` -> float32 [T, D].

    Utterance-level [D] files are promoted to [1, D].
    """

    def __init__(self, feature_root: str, feature_name: str):
        self.root = os.path.join(feature_root, feature_name)
        self.name = feature_name

    def get(self, clip: str) -> np.ndarray:
        arr = np.asarray(np.load(os.path.join(self.root, clip + ".npy")),
                         dtype=np.float32)
        if arr.ndim == 1:
            arr = arr[None, :]
        return arr

    @property
    def dim(self) -> int:
        for fn in os.listdir(self.root):
            if fn.endswith(".npy"):
                return self.get(fn[:-4]).shape[-1]
        raise FileNotFoundError(f"no .npy files under {self.root}")


class SyntheticSource:
    """Deterministic synthetic [T, D] features keyed by clip name.

    Lengths and values are a pure function of (clip, feature_name, seed),
    through ``stable_seed``, so every process and host generates identical
    data.
    """

    def __init__(self, feature_name: str, dim: int, min_len: int = 8,
                 max_len: int = 400, seed: int = 0):
        self.name = feature_name
        self._dim = dim
        self.min_len = min_len
        self.max_len = max_len
        self.seed = seed
        self._cache: Dict[str, np.ndarray] = {}

    def get(self, clip: str) -> np.ndarray:
        if clip not in self._cache:
            rng = np.random.default_rng(stable_seed(clip, self.name, self.seed))
            t = int(rng.integers(self.min_len, self.max_len + 1))
            self._cache[clip] = rng.normal(size=(t, self._dim)).astype(np.float32)
        return self._cache[clip]

    @property
    def dim(self) -> int:
        return self._dim


def check_feature_completeness(source, names: Sequence[str]) -> List[str]:
    """The clips of `names` whose features `source` cannot give: its
    ``get`` raises, or the array is empty or holds a non-finite value."""
    bad = []
    for n in names:
        try:
            arr = source.get(n)
            if arr.size == 0 or not np.isfinite(arr).all():
                bad.append(n)
        except Exception:
            bad.append(n)
    return bad
