"""Feature stores: where per-clip [T, D] arrays come from.

The contract: a directory per feature type holding ``{clip}.npy``, read
lazily, or preloaded into memory by a thread pool. The batch fill of
data/native.py reads the files itself, by ``path_for``, and the lengths
from their headers (``length_of``). ``SyntheticSource`` stands in for the
store where no dataset is on disk.
"""

from __future__ import annotations

import ast
import concurrent.futures as futures
import os
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np


def stable_seed(*parts) -> int:
    """A 32-bit seed from the parts' text that is the same in every
    process. (``hash()`` of a str is salted per process, so seeds built on
    it differ between processes and hosts.)"""
    return zlib.crc32("\0".join(str(p) for p in parts).encode())


class NpyDirSource:
    """Reads ``{root}/{feature_name}/{clip}.npy`` -> float32 [T, D].

    Utterance-level [D] files are promoted to [1, D]. ``preload_names``
    reads those clips into memory at once (``preload``); ``get`` and
    ``dim`` read the cache first.
    """

    def __init__(self, feature_root: str, feature_name: str,
                 preload_names: Optional[Sequence[str]] = None):
        self.root = os.path.join(feature_root, feature_name)
        self.name = feature_name
        self._cache: Dict[str, np.ndarray] = {}
        if preload_names is not None:
            self.preload(preload_names)

    def _read(self, clip: str) -> np.ndarray:
        arr = np.asarray(np.load(self.path_for(clip)), dtype=np.float32)
        if arr.ndim == 1:
            arr = arr[None, :]
        return arr

    def preload(self, names: Sequence[str], workers: int = 12) -> None:
        """Read `names` into the cache on a pool of `workers` threads."""
        with futures.ThreadPoolExecutor(max_workers=workers) as pool:
            for clip, arr in zip(names, pool.map(self._read, names)):
                self._cache[clip] = arr

    def get(self, clip: str) -> np.ndarray:
        arr = self._cache.get(clip)
        return self._read(clip) if arr is None else arr

    def path_for(self, clip: str) -> str:
        return os.path.join(self.root, clip + ".npy")

    def length_of(self, clip: str) -> int:
        """The clip's frame count, from the file's header alone (1 for an
        utterance-level [D] file)."""
        shape = npy_header_shape(self.path_for(clip))
        return shape[0] if len(shape) > 1 else 1

    @property
    def dim(self) -> int:
        if self._cache:
            return next(iter(self._cache.values())).shape[-1]
        for fn in os.listdir(self.root):
            if fn.endswith(".npy"):
                return npy_header_shape(os.path.join(self.root, fn))[-1]
        raise FileNotFoundError(f"no .npy files under {self.root}")


def npy_header_shape(path: str) -> tuple:
    """The array shape in a .npy file's header (format 1 or 2), without
    reading the payload."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic[:6] != b"\x93NUMPY":
            raise ValueError(f"{path} is not a .npy file")
        size = 2 if magic[6] == 1 else 4
        hlen = int.from_bytes(f.read(size), "little")
        header = ast.literal_eval(f.read(hlen).decode("latin1"))
    return tuple(header["shape"])


class SyntheticSource:
    """Deterministic synthetic [T, D] features keyed by clip name.

    Lengths and values are a pure function of (clip, feature_name, seed),
    through ``stable_seed``, so every process and host generates identical
    data.
    """

    def __init__(self, feature_name: str, dim: int, min_len: int = 8,
                 max_len: int = 400, seed: int = 0, cache: bool = True):
        """``cache=False`` generates a clip anew at every ``get`` (the same
        values), holding none in memory."""
        self.name = feature_name
        self._dim = dim
        self.min_len = min_len
        self.max_len = max_len
        self.seed = seed
        self._cache: Optional[Dict[str, np.ndarray]] = {} if cache else None

    def get(self, clip: str) -> np.ndarray:
        if self._cache is not None and clip in self._cache:
            return self._cache[clip]
        rng = np.random.default_rng(stable_seed(clip, self.name, self.seed))
        t = int(rng.integers(self.min_len, self.max_len + 1))
        arr = rng.normal(size=(t, self._dim)).astype(np.float32)
        if self._cache is not None:
            self._cache[clip] = arr
        return arr

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
