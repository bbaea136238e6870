"""Host input pipeline: dataset assembly, batching, background prefetch.

One pipeline that reads lazily (a packed store, npy or synthetic),
shuffles per epoch with a seeded RNG (optionally sorting clips of similar
length together inside windows of a few batches), emits bucketed
``Batch``es (collate.py) and prefetches them on a background thread. With
``--feat_scale`` 1, the C++ fill of data/native.py assembles the batches:
from the blobs in the store's dtype when every source is a packed store
(data/packed.py; lengths from the index), else from the ``.npy`` files when
every source has them (lengths from the headers). Other sources, and
``plain=True``, collate in numpy (collate.make_batch, or the packed
store's plain fill).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from sdumc_tpu_torch.core.config import DataConfig, PathsConfig
from sdumc_tpu_torch.core.registry import DATASETS
from sdumc_tpu_torch.data import native
from sdumc_tpu_torch.data.collate import Batch, bucket_for, make_batch, scale_compress
from sdumc_tpu_torch.data.feature_store import NpyDirSource, SyntheticSource, stable_seed
from sdumc_tpu_torch.data.labels import read_names_labels
from sdumc_tpu_torch.data.packed import (PackedSource, batch_scales, fill_batch_from_packed,
                                         fill_batch_from_packed_plain)

MODALITIES = ("audio", "text", "video", "feat4")


def _page_locked(shape, dtype, zeroed: bool = True):
    """(owner, array): a page-locked torch tensor and the numpy array that
    views it. A copy to a card then reads memory that torch's host
    allocator tracks (a numpy view seen through torch.from_numpy is not
    tracked, and could be handed out again while the copy still reads it).
    uint16 (bf16 bit patterns) is owned by a bf16 tensor. ``zeroed=False``
    leaves the memory as it comes, for a fill that writes every byte."""
    dtype = np.dtype(dtype)
    torch_dtype = (torch.bfloat16 if dtype == np.uint16
                   else torch.from_numpy(np.zeros(0, dtype)).dtype)
    owner = (torch.zeros if zeroed else torch.empty)(shape, dtype=torch_dtype, pin_memory=True)
    view = owner.view(torch.int16) if dtype == np.uint16 else owner
    return owner, view.numpy().view(dtype)


def _pinned_alloc(owners: list):
    """alloc(shape, dtype) of zeroed page-locked buffers (``_page_locked``);
    each owning torch tensor is appended to `owners`."""

    def alloc(shape, dtype=np.float32):
        owner, array = _page_locked(shape, dtype)
        owners.append(owner)
        return array

    return alloc


def _make_pinned_batch(*args, **kw) -> Batch:
    """make_batch into page-locked buffers that the Batch keeps."""
    owners = []
    batch = make_batch(*args, alloc=_pinned_alloc(owners), **kw)
    batch.pinned = tuple(owners)
    return batch


@dataclasses.dataclass
class _Slot:
    """One buffer of a ring: the array a batch fills (with its page-locked
    owner on a card), the lengths of its last fill, and the event that the
    copy of its last batch to the card records (``Batch.copied``)."""

    array: np.ndarray
    owner: Optional[torch.Tensor] = None
    lengths: Optional[np.ndarray] = None
    copied: Optional[object] = None


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
    """Iterates one epoch of Batches with optional shuffling, length pooling
    and background prefetch."""

    def __init__(
        self,
        dataset: MoseiDataset,
        batch_size: int,
        *,
        shuffle: bool,
        seed: int = 100,
        epoch: int = 0,
        buckets: Sequence[int] = (64, 128, 256, 512, 1024, 2048, 4096),
        length_pool: int = 0,
        prefetch: int = 4,
        pin_memory: bool = False,
        drop_remainder: bool = False,
        shard_index: int = 0,
        shard_count: int = 1,
        reuse_buffers: int = 0,
        plain: bool = False,
    ):
        """``length_pool`` > 1 (with ``shuffle``) sorts the shuffled order by
        audio length inside windows of ``length_pool`` batches, so that a
        batch's clips are of similar length while the epoch stays shuffled.
        ``pin_memory`` fills the padded features into page-locked memory,
        so copies to a card run asynchronously (needs CUDA);
        ``drop_remainder`` drops a last batch smaller than `batch_size`
        (the train passes). ``shard_index`` / ``shard_count`` keep the
        epoch's order positions ``shard_index::shard_count`` (after the
        shuffle, as the JAX package slices it): with a `batch_size` of
        B / shard_count, the shards' k-th batches together hold the rows of
        the unsharded k-th batch of B, in its order interleaved (row g of
        it is row g // shard_count of shard g % shard_count).

        ``reuse_buffers`` > 0 refills a ring of that many buffers per
        modality and bucket on a packed store, in place of fresh ones: a
        refill skips fresh pages and writes only the pad rows the previous
        occupant dirtied. A batch's arrays are overwritten once
        ``reuse_buffers`` newer batches have been produced, so the depth must
        cover the prefetch queue, the batch the consumer holds and the one
        being filled (at least ``prefetch + 2``), and a consumer on the CPU
        copies a batch before it asks for the next. With ``pin_memory`` the
        buffers are page-locked, and a refill first waits for the
        asynchronous copy of the slot's previous batch to the card
        (``Batch.copied``, which ``train.step.batch_to_device_dict``
        records). ``plain`` fills every batch in numpy (the plain version of
        the C++ fill, for the tests)."""
        if reuse_buffers and reuse_buffers < prefetch + 2:
            raise ValueError(f"a ring of {reuse_buffers} buffers does not cover the prefetch "
                             f"queue ({prefetch}), the batch the consumer holds and the one "
                             f"being filled: it needs at least {prefetch + 2}")
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard {shard_index} of {shard_count}")
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = epoch
        self.buckets = tuple(buckets)
        self.length_pool = length_pool
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.drop_remainder = drop_remainder
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.reuse_buffers = reuse_buffers
        self.plain = plain
        self._rings: Dict[tuple, list] = {}

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
            if self.length_pool > 1:
                src = self.ds.sources["audio"]
                length_of = getattr(src, "length_of", None) or (lambda name: len(src.get(name)))
                lens = np.array([length_of(self.ds.names[i]) for i in idx])
                window = self.bs * self.length_pool
                idx = np.concatenate([
                    idx[s:s + window][np.argsort(lens[s:s + window], kind="stable")]
                    for s in range(0, len(idx), window)] or [idx])
        return idx[self.shard_index::self.shard_count]

    def _packed_usable(self) -> bool:
        return self.ds.feat_scale <= 1 and all(
            isinstance(s, PackedSource) for s in self.ds.sources.values())

    def _native_usable(self) -> bool:
        return (not self.plain and self.ds.feat_scale <= 1
                and all(hasattr(s, "path_for") for s in self.ds.sources.values()))

    def _fresh(self, shape, dtype, owners: list) -> Optional[np.ndarray]:
        """An uninitialised page-locked buffer for the C++ fill (its owner
        appended to `owners`), or None for the fill's own numpy array."""
        if not self.pin_memory:
            return None
        owner, array = _page_locked(shape, dtype, zeroed=False)
        owners.append(owner)
        return array

    def _ring_slot(self, key: str, shape: tuple, dtype) -> _Slot:
        """The next slot of the ring of (key, shape), its buffer allocated
        at first use."""
        ring = self._rings.setdefault((key, shape), [0])   # [turn, slots...]
        turn = ring[0] % self.reuse_buffers
        ring[0] += 1
        if len(ring) <= turn + 1:
            if self.pin_memory:
                owner, array = _page_locked(shape, dtype, zeroed=False)
                ring.append(_Slot(array, owner))
            else:
                ring.append(_Slot(np.empty(shape, dtype)))
        return ring[turn + 1]

    def _batch(self, chunk, mats, t_max, lengths, owners, scales=None, copied=None) -> Batch:
        labels = [self.ds.labels[int(i)] for i in chunk]
        return Batch(
            audio=mats["audio"], text=mats["text"], video=mats["video"],
            feat4=mats["feat4"], t_max=tuple(t_max),
            lengths=np.array(lengths, np.int32),
            emos=np.array([lab.get("emo", 0.0) for lab in labels], np.float32),
            vals=np.array([lab.get("val", 0.0) for lab in labels], np.float32),
            names=[self.ds.names[int(i)] for i in chunk], pinned=tuple(owners),
            scales=scales or None, copied=copied,
        )

    def _packed_batch(self, chunk) -> Batch:
        """A batch straight out of the packed blobs, in the store's dtype:
        lengths from the index, t_max = min(batch max, last bucket), and the
        per-clip scales of an int8 store."""
        names = [self.ds.names[int(i)] for i in chunk]
        ring = self.reuse_buffers and not self.plain
        copied = torch.cuda.Event() if ring and self.pin_memory else None
        owners = []
        mats, t_max, lengths, scales = {}, [], [], {}
        for key in MODALITIES:
            src = self.ds.sources[key]
            lens = src.lengths_for(names)
            tm = int(min(lens.max(), self.buckets[-1]))
            shape = (len(names), bucket_for(tm, self.buckets), src.dim)
            if self.plain:
                alloc = _pinned_alloc(owners) if self.pin_memory else None
                mats[key], _ = fill_batch_from_packed_plain(src, names, shape[1], shape[2],
                                                            alloc=alloc)
            elif ring:
                slot = self._ring_slot(key, shape, src.payload_dtype)
                if slot.copied is not None:
                    slot.copied.synchronize()     # the card has read the slot's last batch
                mats[key], slot.lengths = fill_batch_from_packed(
                    src, names, shape[1], shape[2], out=slot.array, prev_lengths=slot.lengths)
                slot.copied = copied
                if slot.owner is not None:
                    owners.append(slot.owner)
            else:
                mats[key], _ = fill_batch_from_packed(
                    src, names, shape[1], shape[2],
                    out=self._fresh(shape, src.payload_dtype, owners))
            if src.dtype_name == "int8":
                scales[key] = batch_scales(src, names, src.dim)
            t_max.append(tm)
            lengths.append(np.minimum(lens, self.buckets[-1]))
        return self._batch(chunk, mats, t_max, lengths, owners, scales, copied)

    def _native_batch(self, chunk) -> Batch:
        """A batch read from the ``.npy`` files by the C++ fill: lengths from
        the files' headers, t_max = min(batch max, last bucket)."""
        names = [self.ds.names[int(i)] for i in chunk]
        owners = []
        mats, t_max, lengths = {}, [], []
        for key in MODALITIES:
            src = self.ds.sources[key]
            lens = [src.length_of(n) for n in names]
            tm = min(max(lens), self.buckets[-1])
            shape = (len(names), bucket_for(tm, self.buckets), src.dim)
            mats[key], _ = native.fill_batch([src.path_for(n) for n in names], shape[1],
                                             shape[2], out=self._fresh(shape, np.float32, owners))
            t_max.append(tm)
            lengths.append(np.minimum(lens, self.buckets[-1]))
        return self._batch(chunk, mats, t_max, lengths, owners)

    def _batches(self) -> Iterator[Batch]:
        idx = self._order()
        use_packed = self._packed_usable()
        use_native = not use_packed and self._native_usable()
        for s in range(0, len(idx), self.bs):
            chunk = idx[s : s + self.bs]
            if self.drop_remainder and len(chunk) < self.bs:
                return
            if use_packed:
                yield self._packed_batch(chunk)
                continue
            if use_native:
                yield self._native_batch(chunk)
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
