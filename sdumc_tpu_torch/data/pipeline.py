"""Host input pipeline: dataset assembly, batching, background prefetch.

One pipeline that reads lazily (a packed store, npy or synthetic),
shuffles per epoch with a seeded RNG, emits bucketed ``Batch``es
(collate.py) and prefetches them on a background thread. When every source
is a packed store (data/packed.py) and ``--feat_scale`` is 1, batches come
straight from the blobs in the store's dtype, lengths from the index.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np

from sdumc_tpu_torch.core.config import DataConfig, PathsConfig
from sdumc_tpu_torch.core.registry import DATASETS
from sdumc_tpu_torch.data.collate import Batch, bucket_for, make_batch, scale_compress
from sdumc_tpu_torch.data.feature_store import NpyDirSource, SyntheticSource, stable_seed
from sdumc_tpu_torch.data.labels import read_names_labels
from sdumc_tpu_torch.data.packed import PackedSource, batch_scales, fill_batch_from_packed

MODALITIES = ("audio", "text", "video", "feat4")


def _pinned_alloc(owners: list):
    """alloc(shape, dtype) of zeroed page-locked buffers; each owning torch
    tensor is appended to `owners`, so that a copy to a card reads memory
    that torch's host allocator tracks (a numpy view seen through
    torch.from_numpy is not tracked, and could be handed out again while
    the copy still reads it). uint16 (bf16 bit patterns) is owned by a bf16
    tensor."""
    import torch

    def alloc(shape, dtype=np.float32):
        dtype = np.dtype(dtype)
        if dtype == np.uint16:
            owners.append(torch.zeros(shape, dtype=torch.bfloat16, pin_memory=True))
            return owners[-1].view(torch.int16).numpy().view(np.uint16)
        owners.append(torch.zeros(shape, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype,
                                  pin_memory=True))
        return owners[-1].numpy()

    return alloc


def _make_pinned_batch(*args, **kw) -> Batch:
    """make_batch into page-locked buffers that the Batch keeps."""
    owners = []
    batch = make_batch(*args, alloc=_pinned_alloc(owners), **kw)
    batch.pinned = tuple(owners)
    return batch


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
        drop_remainder: bool = False,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        """``pin_memory`` collates the padded features into page-locked
        memory, so copies to a card run asynchronously (needs CUDA);
        ``drop_remainder`` drops a last batch smaller than `batch_size`
        (the train passes). ``shard_index`` / ``shard_count`` keep the
        epoch's order positions ``shard_index::shard_count`` (after the
        shuffle, as the JAX package slices it): with a `batch_size` of
        B / shard_count, the shards' k-th batches together hold the rows of
        the unsharded k-th batch of B, in its order interleaved (row g of
        it is row g // shard_count of shard g % shard_count)."""
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = epoch
        self.buckets = tuple(buckets)
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.drop_remainder = drop_remainder
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard {shard_index} of {shard_count}")
        self.shard_index = shard_index
        self.shard_count = shard_count

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        return idx[self.shard_index::self.shard_count]

    def _packed_usable(self) -> bool:
        return self.ds.feat_scale <= 1 and all(
            isinstance(s, PackedSource) for s in self.ds.sources.values())

    def _packed_batch(self, chunk) -> Batch:
        """A batch straight out of the packed blobs, in the store's dtype:
        lengths from the index, t_max = min(batch max, last bucket), and the
        per-clip scales of an int8 store."""
        names = [self.ds.names[int(i)] for i in chunk]
        owners = []
        alloc = _pinned_alloc(owners) if self.pin_memory else None
        mats, t_max, lengths, scales = {}, [], [], {}
        for key in MODALITIES:
            src = self.ds.sources[key]
            lens = src.lengths_for(names)
            tm = int(min(lens.max(), self.buckets[-1]))
            mats[key], _ = fill_batch_from_packed(src, names, bucket_for(tm, self.buckets),
                                                  src.dim, alloc=alloc)
            if src.dtype_name == "int8":
                scales[key] = batch_scales(src, names, src.dim)
            t_max.append(tm)
            lengths.append(np.minimum(lens, self.buckets[-1]))
        labels = [self.ds.labels[int(i)] for i in chunk]
        return Batch(
            audio=mats["audio"], text=mats["text"], video=mats["video"],
            feat4=mats["feat4"], t_max=tuple(t_max),
            lengths=np.array(lengths, np.int32),
            emos=np.array([lab.get("emo", 0.0) for lab in labels], np.float32),
            vals=np.array([lab.get("val", 0.0) for lab in labels], np.float32),
            names=names, pinned=tuple(owners), scales=scales or None,
        )

    def _batches(self) -> Iterator[Batch]:
        idx = self._order()
        use_packed = self._packed_usable()
        for s in range(0, len(idx), self.bs):
            chunk = idx[s : s + self.bs]
            if self.drop_remainder and len(chunk) < self.bs:
                return
            if use_packed:
                yield self._packed_batch(chunk)
                continue
            feats, emos, vals, names = [], [], [], []
            for i in chunk:
                f, e, v, n = self.ds.example(int(i))
                feats.append(f)
                emos.append(e)
                vals.append(v)
                names.append(n)
            yield (_make_pinned_batch if self.pin_memory else make_batch)(
                [f["audio"] for f in feats],
                [f["text"] for f in feats],
                [f["video"] for f in feats],
                [f["feat4"] for f in feats],
                np.array(emos),
                np.array(vals),
                names,
                buckets=self.buckets,
            )

    def __iter__(self) -> Iterator[Batch]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: List[BaseException] = []
        stop = threading.Event()

        def worker():
            try:
                for b in self._batches():
                    if stop.is_set():
                        return
                    q.put(b)
            except BaseException as e:  # re-raised in the consumer below
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # a consumer that stops early (a preemption, a sharded epoch cut
            # to the common step count) lets the producer finish and free
            # its batches
            stop.set()
            while item is not sentinel:
                item = q.get()


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

    def source(feature_name: str):
        # a packed store ({name}.bin + {name}.json, cli.extract pack) wins
        # over the .npy directory of the same name
        prefix = os.path.join(paths.features_dir, feature_name)
        if os.path.exists(prefix + ".bin") and os.path.exists(prefix + ".json"):
            return PackedSource(prefix, feature_name)
        return NpyDirSource(paths.features_dir, feature_name)

    return {k: source(v) for k, v in names.items()}


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
