"""Audio noise injection at a target SNR (MUSAN-style data-level robustness).

Reference (toolkit/utils/functions.py:368-432): per wav, pick a random noise
file (looping until it covers the clip), slice a random window, scale it so
that SNR(clean, noise) hits the target, mix, clip-guard to int16, write —
fanned out over an 8-process pool. Rebuilt on stdlib wave + numpy with a
thread pool (the work is IO + vector math).
"""

from __future__ import annotations

import concurrent.futures as futures
import glob
import os
import wave
from typing import Sequence

import numpy as np


def read_pcm16(path: str):
    with wave.open(path, "rb") as f:
        params = f.getparams()
        data = np.frombuffer(f.readframes(f.getnframes()), dtype="<i2")
    return data.astype(np.float64), params


def write_pcm16(path: str, params, amp: np.ndarray) -> None:
    with wave.open(path, "wb") as f:
        f.setparams(params)
        f.writeframes(amp.astype("<i2").tobytes())


def rms(x: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(x))))


def adjusted_noise_rms(clean_rms: float, snr_db: float) -> float:
    """noise_rms such that 20*log10(clean/noise) = snr."""
    return clean_rms / (10 ** (snr_db / 20.0))


def add_noise_to_audio(
    clean_path: str,
    noise_paths: Sequence[str],
    snr_db: float,
    save_path: str,
    rng: np.random.Generator,
) -> None:
    clean, params = read_pcm16(clean_path)
    noise = np.zeros(0)
    while len(noise) <= len(clean):
        npath = noise_paths[int(rng.integers(0, len(noise_paths)))]
        chunk, _ = read_pcm16(npath)
        noise = np.concatenate([noise, chunk])
    start = int(rng.integers(0, len(noise) - len(clean) + 1))
    noise = noise[start : start + len(clean)]

    scaled = noise * (adjusted_noise_rms(rms(clean), snr_db) / max(rms(noise), 1e-12))
    mixed = clean + scaled

    # clip-guard (reference :394-402)
    imax, imin = np.iinfo(np.int16).max, np.iinfo(np.int16).min
    if mixed.max() > imax or mixed.min() < imin:
        if mixed.max() >= abs(mixed.min()):
            mixed = mixed * (imax / mixed.max())
        else:
            mixed = mixed * (imin / mixed.min())
    write_pcm16(save_path, params, mixed)


def add_noise_dir(
    audio_root: str,
    noise_root: str,
    choice_snrs: Sequence[float],
    workers: int = 8,
    seed: int = 0,
) -> str:
    """Noise over a directory (reference add_noise_multiprocess :409-432):
    save dir '{root}_snr{X}' for one SNR or '{root}_snrmix' for several."""
    audio_paths = sorted(glob.glob(os.path.join(audio_root, "*")))
    noise_paths = sorted(glob.glob(os.path.join(noise_root, "*")))
    assert noise_paths, f"no noise files under {noise_root}"
    suffix = f"_snr{choice_snrs[0]}" if len(choice_snrs) == 1 else "_snrmix"
    save_root = audio_root + suffix
    os.makedirs(save_root, exist_ok=True)

    rng = np.random.default_rng(seed)
    jobs = []
    for path in audio_paths:
        snr = float(choice_snrs[int(rng.integers(0, len(choice_snrs)))])
        jobs.append((path, snr, os.path.join(save_root, os.path.basename(path)),
                     np.random.default_rng(rng.integers(2**31))))
    with futures.ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(
            lambda j: add_noise_to_audio(j[0], noise_paths, j[1], j[2], j[3]),
            jobs,
        ))
    return save_root
