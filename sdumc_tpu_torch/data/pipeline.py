"""Host input pipeline: dataset assembly, batching, background prefetch.

One pipeline that reads lazily (npy or synthetic), shuffles per epoch with
a seeded RNG, emits bucketed ``Batch``es (collate.py) and prefetches them
on a background thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np

from sdumc_tpu_torch.core.config import DataConfig, PathsConfig
from sdumc_tpu_torch.core.registry import DATASETS
from sdumc_tpu_torch.data.collate import Batch, make_batch, scale_compress
from sdumc_tpu_torch.data.feature_store import NpyDirSource, SyntheticSource, stable_seed
from sdumc_tpu_torch.data.labels import read_names_labels


def _pinned_zeros(shape) -> np.ndarray:
    import torch

    return torch.zeros(shape, dtype=torch.float32, pin_memory=True).numpy()


class MoseiDataset:
    """Four feature streams + labels for one split."""

    def __init__(self, names: List[str], labels: List[dict],
                 sources: Dict[str, object], feat_scale: int = 1):
        self.names = names
        self.labels = labels
        self.sources = sources  # keys: audio, text, video, feat4
        self.feat_scale = feat_scale

    def __len__(self):
        return len(self.names)

    def input_dims(self):
        return tuple(self.sources[k].dim for k in ("audio", "text", "video", "feat4"))

    def example(self, idx: int):
        name = self.names[idx]
        feats = {k: s.get(name) for k, s in self.sources.items()}
        if self.feat_scale > 1:
            feats = {k: scale_compress(v, self.feat_scale) for k, v in feats.items()}
        lab = self.labels[idx]
        return feats, float(lab.get("emo", 0.0)), float(lab.get("val", 0.0)), name


class BatchIterator:
    """Iterates one epoch of Batches with optional shuffling and background
    prefetch."""

    def __init__(
        self,
        dataset: MoseiDataset,
        batch_size: int,
        *,
        shuffle: bool,
        seed: int = 100,
        epoch: int = 0,
        buckets: Sequence[int] = (64, 128, 256, 512, 1024, 2048, 4096),
        prefetch: int = 4,
        pin_memory: bool = False,
    ):
        """``pin_memory`` collates the padded features into page-locked
        memory, so copies to a card run asynchronously (needs CUDA)."""
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = epoch
        self.buckets = tuple(buckets)
        self.prefetch = prefetch
        self.pin_memory = pin_memory

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        return idx

    def _batches(self) -> Iterator[Batch]:
        idx = self._order()
        for s in range(0, len(idx), self.bs):
            chunk = idx[s : s + self.bs]
            feats, emos, vals, names = [], [], [], []
            for i in chunk:
                f, e, v, n = self.ds.example(int(i))
                feats.append(f)
                emos.append(e)
                vals.append(v)
                names.append(n)
            yield make_batch(
                [f["audio"] for f in feats],
                [f["text"] for f in feats],
                [f["video"] for f in feats],
                [f["feat4"] for f in feats],
                np.array(emos),
                np.array(vals),
                names,
                buckets=self.buckets,
                **({"alloc": _pinned_zeros} if self.pin_memory else {}),
            )

    def __iter__(self) -> Iterator[Batch]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: List[BaseException] = []

        def worker():
            try:
                for b in self._batches():
                    q.put(b)
            except BaseException as e:  # re-raised in the consumer below
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item


def build_sources(cfg: DataConfig, paths: PathsConfig, synthetic: bool = False,
                  synth_dims=(1024, 4096, 1024, 4096)):
    names = {
        "audio": cfg.audio_feature,
        "text": cfg.text_feature,
        "video": cfg.video_feature,
        "feat4": cfg.feat4_feature,
    }
    if synthetic:
        regimes = {  # (dim, min_len, max_len) per modality, MOSEI-like
            "audio": (synth_dims[0], 50, 1200),
            "text": (synth_dims[1], 4, 96),
            "video": (synth_dims[2], 8, 300),
            "feat4": (synth_dims[3], 4, 64),
        }
        return {
            k: SyntheticSource(v, regimes[k][0], regimes[k][1], regimes[k][2])
            for k, v in names.items()
        }
    return {k: NpyDirSource(paths.features_dir, v) for k, v in names.items()}


def build_loaders(cfg: DataConfig, paths: PathsConfig, *, synthetic: bool = False,
                  synthetic_sizes=(256, 64, 64)):
    """Returns (train_ds, val_ds, test_ds) MoseiDatasets: train drops the
    too-long list (config switch), --debug truncates every split to 100."""
    sources = build_sources(cfg, paths, synthetic=synthetic)
    datasets = []
    for split, size in zip(("train", "val", "test"), synthetic_sizes):
        if synthetic:
            rng = np.random.default_rng((stable_seed(split), 7))
            names = [f"{split}_{i}" for i in range(size)]
            labels = [
                {"emo": 0.0, "val": float(np.round(rng.uniform(-3, 3), 2))}
                for _ in names
            ]
        else:
            names, labels = read_names_labels(
                paths.label_path,
                split,
                debug=cfg.debug,
                drop_too_long=(split == "train" and cfg.drop_too_long_train_clips),
            )
        datasets.append(MoseiDataset(names, labels, sources, cfg.feat_scale))
    return tuple(datasets)


def build_cross(cfg: DataConfig, paths: PathsConfig, *, test_paths=None,
                synthetic: bool = False, synthetic_sizes=(256, 64, 64)):
    """Cross-corpus loaders: train/val from the train corpus (``paths``),
    test from the test corpus (``test_paths``, from ``cfg.test_dataset``
    through the env layout when omitted)."""
    if test_paths is None:
        test_paths = PathsConfig.from_env(cfg.test_dataset or cfg.dataset)
    train, val, _ = build_loaders(
        cfg, paths, synthetic=synthetic, synthetic_sizes=synthetic_sizes)
    _, _, test = build_loaders(
        cfg, test_paths, synthetic=synthetic, synthetic_sizes=synthetic_sizes)
    return train, val, test


DATASETS.register("CMU-MOSEI", build_loaders)
DATASETS.register("CMU-MOSI", build_loaders)
DATASETS.register("CROSSDIM", build_cross)
DATASETS.register("CROSSDIS", build_cross)

# corpus families: cross-corpus transfer is defined only within one
DIM_DATASETS = ("CMU-MOSI", "CMUMOSI", "CMU-MOSEI", "SIMS", "SIMSv2")
DIS_DATASETS = ("IEMOCAPFour", "IEMOCAPSix", "MER2023", "MELD")


def get_loaders(dataset: str, cfg: DataConfig, paths: PathsConfig, **kw):
    """Name-dispatched loader construction; setting ``cfg.train_dataset``
    switches to the CROSSDIM/CROSSDIS loaders by corpus family."""
    if cfg.train_dataset:
        tr = cfg.train_dataset
        te = cfg.test_dataset or cfg.dataset
        family = ("CROSSDIM" if tr in DIM_DATASETS
                  else "CROSSDIS" if tr in DIS_DATASETS else None)
        members = DIM_DATASETS if family == "CROSSDIM" else DIS_DATASETS
        if family is None or te not in members:
            raise ValueError(f"cross-corpus transfer must stay within one "
                             f"corpus family: {tr} -> {te}")
        return DATASETS.get(family)(cfg, paths, **kw)
    return DATASETS.get(dataset)(cfg, paths, **kw)
