"""OpenFace artifact readers (.hog binaries and per-frame .csv tables).

The port's own copy of ``sdumc_tpu/extract/openface.py`` (reference
feature_extraction/visual/util.py:10-78); OpenFace itself stays an external
binary, and the contract is its files. ``read_csv`` uses the ``csv`` module
and numpy instead of pandas, which the card's machine does not have.

.hog layout (per frame): i32 num_cols, i32 num_rows, i32 num_channels,
f32 is_valid, then rows*cols*channels f32 features in row-major order.
OpenFace emits 12*12*31 = 4464 features per frame.
"""

from __future__ import annotations

import csv
import struct
from typing import Tuple

import numpy as np


def read_hog(filename: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read an OpenFace .hog file: (is_valid [num_frames], features
    [num_frames, num_features]). Every frame record has the same 3-int
    header, so the whole file maps onto one [n_frames, 4 + n_feat] view."""
    with open(filename, "rb") as f:
        header = f.read(12)
        if len(header) < 12:
            return np.zeros((0,)), np.zeros((0, 0))
        num_cols, num_rows, num_channels = struct.unpack("3i", header)
        num_feat = num_rows * num_cols * num_channels
        body = np.fromfile(f, dtype="<f4")
    rec = 1 + num_feat  # is_valid + features; header ints re-appear per frame
    # frame 0's header was consumed above; subsequent frames repeat it
    first = body[:rec]
    rest = body[rec:]
    n_rest = len(rest) // (3 + rec)
    rest = rest[: n_rest * (3 + rec)].reshape(n_rest, 3 + rec)[:, 3:]
    all_rows = np.concatenate([first[None, :], rest], axis=0) if len(first) == rec \
        else rest
    return all_rows[:, 0].copy(), all_rows[:, 1:].copy()


def _is_int(text: str) -> bool:
    try:
        int(text)
    except ValueError:
        return False
    return True


def read_csv(filename: str, start_idx: int) -> np.ndarray:
    """Read an OpenFace per-frame csv (a header row, then numbers), keeping
    the columns from ``start_idx``: [num_frames, num_kept_columns], int64
    where every kept value is an integer, else float64 (empty cells NaN),
    as ``pandas.read_csv(...).iloc[:, start_idx:].to_numpy()`` gives."""
    with open(filename, newline="") as f:
        header, *body = list(csv.reader(f))
    rows = [r[start_idx:] for r in body if r]
    if not rows:
        return np.zeros((0, len(header[start_idx:])))
    cells = [v.strip() for r in rows for v in r]
    if cells and all(_is_int(v) for v in cells):
        return np.array([[int(v) for v in r] for r in rows], dtype=np.int64)
    return np.array([[float(v) if v.strip() else np.nan for v in r] for r in rows],
                    dtype=np.float64)
