"""The one generator of the cells' traffic, driven by a cell's parameters.

Lengths are drawn so that every seed gets the same multiset of sizes in
another order: n values of a range [lo, hi] are its n stratified quantiles
(the midpoints of n equal slices), shuffled by the seed. So the work of a
run does not move with the seed, only the order and the content.

Frame features (the fusion cells): each stream's clips are windows of a
pool of random frames, made on the device from the seed; a clip is (start
frame, length) into its stream's pool, with starts drawn from the seed, so
every clip's frames differ while the pool, and the store written from it,
stays small. Waves (the extraction cells): each wave is a window of one
long random signal in the same way.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.lib import seeds

MODALITIES = ("audio", "text", "video", "feat4")


def stratified(n: int, lo: float, hi: float, rng: np.random.Generator, integer: bool):
    """n stratified quantiles of [lo, hi] (of the integers lo..hi when
    `integer`), in an order drawn from `rng`."""
    mids = (np.arange(n) + 0.5) / n
    vals = (lo + np.floor(mids * (hi - lo + 1))).astype(np.int64) if integer else lo + mids * (hi - lo)
    return vals[rng.permutation(n)]


def fusion_clips(params: Dict, seed: int, n_clips: int) -> Dict:
    """The clips of a fusion cell: per stream their lengths and pool
    starts, the pool's size in frames, and the labels."""
    out = {"lengths": {}, "starts": {}, "pool_frames": {}}
    pool_clips = params["pool_clips"]
    for m in MODALITIES:
        lo, hi = params["lengths"][m]
        lens = stratified(n_clips, lo, hi, seeds.rng(seed, "lengths", m), integer=True)
        frames = int(pool_clips * (lo + hi) / 2)
        frames = max(frames, hi)
        starts = seeds.rng(seed, "starts", m).integers(0, frames - lens + 1)
        out["lengths"][m], out["starts"][m], out["pool_frames"][m] = lens, starts, frames
    lo, hi = params["labels"]
    out["vals"] = np.round(stratified(n_clips, lo, hi, seeds.rng(seed, "labels"), False), 2)
    return out


def random_frames(n: int, seed: int, device, chunk: int = 1 << 26) -> np.ndarray:
    """n standard-normal float32 values drawn on `device` from `seed`, on
    the host, in a few large draws."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out = np.empty(n, np.float32)
    for at in range(0, n, chunk):
        m = min(chunk, n - at)
        out[at: at + m] = torch.randn(m, generator=g, device=device).cpu().numpy()
    return out


def write_store(directory: str, dims: Dict[str, int], clips: Dict, seed: int, device):
    """One packed store per stream in `directory` (``<stream>.bin`` with its
    ``<stream>.json`` index: the program's packed-store format, f32), each
    clip named ``c<i>`` a window of the stream's pool. Returns {stream:
    (the blob as a read-only memory map, {clip: (offset, rows, cols)})},
    the raw bytes the reference reads."""
    out = {}
    for m in MODALITIES:
        dim = dims[m]
        pool = random_frames(clips["pool_frames"][m] * dim, seeds.derive(seed, "pool", m), device)
        prefix = os.path.join(directory, m)
        pool.tofile(prefix + ".bin")
        index = {f"c{i}": [int(s) * dim, int(n), dim]
                 for i, (s, n) in enumerate(zip(clips["starts"][m], clips["lengths"][m]))}
        with open(prefix + ".json", "w") as f:
            json.dump({"dtype": "float32", "index": index}, f)
        out[m] = (np.memmap(prefix + ".bin", dtype=np.float32, mode="r"),
                  {k: tuple(v) for k, v in index.items()})
    return out


def wave_requests(params: Dict, seed: int, n_requests: int) -> List[List[tuple]]:
    """Per request, its waves as (start sample, length) in the signal pool:
    ``waves_per_request`` durations stratified over ``seconds``, in an order
    drawn per request, starts drawn from the seed."""
    rate = params["sample_rate"]
    lo, hi = params["seconds"]
    n = params["waves_per_request"]
    pool = int(params["pool_seconds"] * rate)
    out = []
    for r in range(n_requests):
        g = seeds.rng(seed, "request", r)
        lens = (stratified(n, lo, hi, g, integer=False) * rate).astype(np.int64)
        starts = g.integers(0, pool - lens + 1)
        out.append(list(zip(starts.tolist(), lens.tolist())))
    return out


def wave_pool(params: Dict, seed: int, device) -> np.ndarray:
    """The signal every wave is a window of: a random 16-bit-scale signal."""
    n = int(params["pool_seconds"] * params["sample_rate"])
    return 0.1 * random_frames(n, seeds.derive(seed, "waves"), device)


def waves_of(pool: np.ndarray, request: Sequence[tuple]) -> List[np.ndarray]:
    return [pool[s: s + n] for s, n in request]
