"""Length remapping and batch assembly.

Reference semantics: a shorter feature is zero-padded at the end; a longer
one is left-padded with zeros to a multiple of the target length, reshaped,
and averaged over adjacent frames. Batches are padded up to a length bucket
and carry the dynamic batch max as ``t_max``, so the model's softmax masks
reproduce the reference's batch-max padding (see ops/masking.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Sequence, Tuple

import numpy as np


def mapping_feature(feature: np.ndarray, dst_len: int) -> np.ndarray:
    """Map a [T, D] feature to [dst_len, D] (pad, or left-pad and mean-pool)."""
    featlen, featdim = feature.shape
    if featlen == dst_len:
        return feature
    if featlen < dst_len:
        pad = np.zeros((dst_len - featlen, featdim), dtype=feature.dtype)
        return np.concatenate([feature, pad], axis=0)
    if featlen % dst_len == 0:
        pad_len = 0
        pool = featlen // dst_len
    else:
        pad_len = dst_len - featlen % dst_len
        pool = featlen // dst_len + 1
    pad = np.zeros((pad_len, featdim), dtype=feature.dtype)
    feature = np.concatenate([pad, feature]).reshape(dst_len, pool, featdim)
    return feature.mean(axis=1)


def scale_compress(feature: np.ndarray, scale: int) -> np.ndarray:
    """--feat_scale pre-compression: [T, D] -> [ceil(T / scale), D]."""
    if scale <= 1:
        return feature
    return mapping_feature(feature, math.ceil(len(feature) / scale))


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length; the largest bucket is a hard cap (longer
    features are mean-pool-compressed into it instead of being dropped)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class Batch:
    """One host batch, every array padded to its bucket."""

    audio: np.ndarray   # [B, Ta_bucket, Da]
    text: np.ndarray    # [B, Tt_bucket, Dt]
    video: np.ndarray   # [B, Tv_bucket, Dv]
    feat4: np.ndarray   # [B, Tf_bucket, Df]
    t_max: Tuple[int, int, int, int]   # dynamic batch max per modality
    lengths: np.ndarray  # [4, B] true sequence lengths
    emos: np.ndarray     # [B]
    vals: np.ndarray     # [B]
    names: List[str]

    @property
    def size(self) -> int:
        return self.audio.shape[0]


def _pad_stack(feats: List[np.ndarray], bucket: int, alloc) -> np.ndarray:
    out = alloc((len(feats), bucket, feats[0].shape[-1]))
    for i, f in enumerate(feats):
        if len(f) > bucket:  # cap overflow: mean-pool into the largest bucket
            f = mapping_feature(f, bucket)
        out[i, : len(f)] = f
    return out


def make_batch(
    audios: List[np.ndarray],
    texts: List[np.ndarray],
    videos: List[np.ndarray],
    feat4s: List[np.ndarray],
    emos: np.ndarray,
    vals: np.ndarray,
    names: List[str],
    buckets: Sequence[int] = (64, 128, 256, 512, 1024, 2048, 4096),
    alloc: Callable[[tuple], np.ndarray] = lambda shape: np.zeros(shape, np.float32),
) -> Batch:
    """Collate one batch with bucketed shapes and the reference t_max.

    ``alloc(shape)`` returns the zeroed float32 buffer of one padded
    modality, e.g. a view of page-locked memory for fast copies to a card.
    """
    groups = (audios, texts, videos, feat4s)
    lengths = np.array([[len(f) for f in g] for g in groups], dtype=np.int32)
    t_max = tuple(int(min(lengths[i].max(), buckets[-1])) for i in range(4))
    padded = [
        _pad_stack(list(g), bucket_for(t_max[i], buckets), alloc)
        for i, g in enumerate(groups)
    ]
    return Batch(
        audio=padded[0],
        text=padded[1],
        video=padded[2],
        feat4=padded[3],
        t_max=t_max,
        lengths=np.minimum(lengths, buckets[-1]),
        emos=np.asarray(emos, dtype=np.float32),
        vals=np.asarray(vals, dtype=np.float32),
        names=list(names),
    )
