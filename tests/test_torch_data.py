"""The port's host-side copies (collate, pipeline, labels, metrics) against
the JAX package's originals, and the process-stable synthetic store.

These modules are numpy-only on both sides, so results must be equal, not
merely close.
"""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sdumc_tpu.core.metrics import eval_mosei_metric as jax_metric
from sdumc_tpu.data import collate as jax_collate
from sdumc_tpu.data.labels import read_names_labels as jax_read_labels
from sdumc_tpu.data.labels import write_label_npz
from sdumc_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from sdumc_tpu.data.pipeline import MoseiDataset as JaxMoseiDataset
from sdumc_tpu_torch.core.metrics import eval_mosei_metric
from sdumc_tpu_torch.data import collate
from sdumc_tpu_torch.data.labels import read_names_labels
from sdumc_tpu_torch.data.pipeline import BatchIterator, MoseiDataset

REPO = Path(__file__).resolve().parent.parent


class ArraySource:
    def __init__(self, arrays):
        self.arrays = arrays

    def get(self, clip):
        return self.arrays[clip]

    @property
    def dim(self):
        return next(iter(self.arrays.values())).shape[-1]


def _ragged(rng, n, lo, hi, dim):
    return [rng.normal(size=(int(rng.integers(lo, hi + 1)), dim)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("length,dst", [(10, 10), (7, 12), (12, 4), (13, 4), (100, 7)])
def test_mapping_and_scale_compress_match_jax(length, dst):
    f = np.random.default_rng(length).normal(size=(length, 5)).astype(np.float32)
    np.testing.assert_array_equal(collate.mapping_feature(f, dst), jax_collate.mapping_feature(f, dst))
    np.testing.assert_array_equal(collate.scale_compress(f, 3), jax_collate.scale_compress(f, 3))
    assert collate.bucket_for(length, (8, 16)) == jax_collate.bucket_for(length, (8, 16))


def test_make_batch_matches_jax():
    rng = np.random.default_rng(0)
    groups = [_ragged(rng, 5, 1, 40, d) for d in (4, 6, 4, 6)]
    emos, vals = np.zeros(5), rng.uniform(-3, 3, 5)
    names = [f"c{i}" for i in range(5)]
    buckets = (8, 16, 32)            # 40 > 32 exercises the mean-pool cap
    got = collate.make_batch(*groups, emos, vals, names, buckets=buckets)
    ref = jax_collate.make_batch(*groups, emos, vals, names, buckets=buckets)
    for key in ("audio", "text", "video", "feat4", "lengths", "emos", "vals"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key), err_msg=key)
    assert got.t_max == ref.t_max and got.names == ref.names


@pytest.mark.parametrize("shuffle,feat_scale", [(False, 1), (True, 1), (True, 2)])
def test_batch_iterator_matches_jax(shuffle, feat_scale):
    rng = np.random.default_rng(1)
    names = [f"clip{i}" for i in range(11)]
    sources = {k: ArraySource(dict(zip(names, _ragged(rng, 11, 2, 50, d))))
               for k, d in (("audio", 4), ("text", 6), ("video", 4), ("feat4", 6))}
    labels = [{"emo": 0.0, "val": float(v)} for v in rng.uniform(-3, 3, 11)]
    kw = dict(shuffle=shuffle, seed=5, epoch=2, buckets=(8, 16, 32, 64))
    got = list(BatchIterator(MoseiDataset(names, labels, sources, feat_scale), 3, **kw))
    ref = list(JaxBatchIterator(JaxMoseiDataset(names, labels, sources, feat_scale), 3, **kw))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.names == r.names and g.t_max == r.t_max
        for key in ("audio", "text", "video", "feat4", "lengths", "vals"):
            np.testing.assert_array_equal(getattr(g, key), getattr(r, key), err_msg=key)


@pytest.mark.parametrize("split,drop", [("train", True), ("train", False), ("test", False)])
def test_read_names_labels_matches_jax(tmp_path, split, drop):
    corpus = {n: {"emo": 0.0, "val": float(i)} for i, n in enumerate(["a_1", "125344_0", "b_2"])}
    path = str(tmp_path / "labels.npz")
    write_label_npz(path, corpus, corpus, corpus)
    assert read_names_labels(path, split, drop_too_long=drop) == \
        jax_read_labels(path, split, drop_too_long=drop)


def test_eval_mosei_metric_matches_jax():
    rng = np.random.default_rng(2)
    preds, labels = rng.uniform(-3, 3, 50), np.round(rng.uniform(-3, 3, 50))
    assert eval_mosei_metric(preds, labels) == jax_metric(preds, labels)


_PROBE = """
import hashlib, sys
sys.path.insert(0, {repo!r})
from sdumc_tpu_torch.core.config import DataConfig, PathsConfig
from sdumc_tpu_torch.data.feature_store import SyntheticSource
from sdumc_tpu_torch.data.pipeline import build_loaders
clip = SyntheticSource("wavlm", 16, 4, 40).get("test_0")
_, _, test = build_loaders(DataConfig(), PathsConfig(), synthetic=True, synthetic_sizes=(2, 2, 4))
print(hashlib.sha1(clip.tobytes()).hexdigest(), [l["val"] for l in test.labels])
"""


def test_synthetic_store_is_the_same_in_every_process():
    """Str hashes are salted per process (PYTHONHASHSEED); the synthetic
    store's seeds must not depend on them."""
    outs = []
    for hash_seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hash_seed)
        run = subprocess.run([sys.executable, "-c", _PROBE.format(repo=str(REPO))],
                             env=env, capture_output=True, text=True, timeout=120)
        assert run.returncode == 0, run.stderr
        outs.append(run.stdout)
    assert outs[0] == outs[1]
    from sdumc_tpu_torch.data.feature_store import SyntheticSource

    clip = SyntheticSource("wavlm", 16, 4, 40).get("test_0")
    assert outs[0].split()[0] == hashlib.sha1(clip.tobytes()).hexdigest()
