"""Raw-transcript dataset variant: tokenize in the collate.

The port of ``sdumc_tpu/data/raw_text.py``. Reference:
``Data_Feat_Vicuna_MOSEI_EmoVal_4F`` (toolkit/data/feat_data.py:263-365),
three pre-extracted feature streams plus raw English transcripts read from
a CSV, tokenized per batch with the Vicuna tokenizer, for end-to-end LLM
paths where the text tower runs inside the train step.

As in JAX:

* token ids are padded on the **left** to a static bucket boundary, so the
  last token of every row sits at a fixed position; a row longer than the
  largest bucket keeps its **tail**;
* the tokenizer is pluggable: ``hf_tokenizer(model_dir)`` reads a model
  directory's own tokenizer files (``convert/vocab_tokenizers.
  load_tokenizer``, where JAX calls ``AutoTokenizer(use_fast=False)``),
  ``WhitespaceTokenizer`` is the hermetic stand-in for tests and smoke
  runs (md5-hashed word ids, BOS first);
* masks follow the HF convention (1 = valid).

The feature side is the port's ``data/collate.make_batch``.
"""

from __future__ import annotations

import csv
import dataclasses
import hashlib
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from sdumc_tpu_torch.data.collate import Batch, bucket_for, make_batch


def read_transcripts(csv_path: str, name_col: str = "name",
                     text_col: str = "english") -> Dict[str, str]:
    """name -> transcript from the transcription CSV (the file the
    preprocessing writes)."""
    out = {}
    with open(csv_path, encoding="utf-8") as f:
        for row in csv.DictReader(f):
            out[row[name_col]] = row[text_col]
    return out


class WhitespaceTokenizer:
    """Deterministic hermetic tokenizer: each lower-cased whitespace word's
    id is 2 + (the first 4 bytes of its md5, little-endian) mod
    (vocab_size - 2), BOS prepended."""

    def __init__(self, vocab_size: int = 32000, bos_id: int = 1):
        self.vocab_size = vocab_size
        self.bos_id = bos_id

    def __call__(self, texts: Sequence[str]) -> List[List[int]]:
        out = []
        for t in texts:
            ids = [self.bos_id]
            for w in t.split():
                h = int.from_bytes(hashlib.md5(w.lower().encode()).digest()[:4], "little")
                ids.append(2 + h % (self.vocab_size - 2))
            out.append(ids)
        return out


def hf_tokenizer(model_dir: str) -> Callable[[Sequence[str]], List[List[int]]]:
    """A model directory's tokenizer (e.g. vicuna-7b-v1.5) under the
    ragged-ids contract; padding happens in the collate, not here."""
    from sdumc_tpu_torch.convert.vocab_tokenizers import load_tokenizer

    tok = load_tokenizer(model_dir)

    def run(texts: Sequence[str]) -> List[List[int]]:
        return [tok(t)["input_ids"] for t in texts]

    return run


def tokenize_left_pad(
    texts: Sequence[str],
    tokenizer: Callable[[Sequence[str]], List[List[int]]],
    buckets: Sequence[int] = (16, 32, 64, 128, 256),
    pad_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """-> (ids [B, T_bucket] int32, mask [B, T_bucket] int32 1 = valid,
    t_max): left padding into a static bucket; a row longer than the
    largest bucket keeps its tail."""
    ragged = tokenizer(texts)
    t_max = min(max(len(r) for r in ragged), buckets[-1])
    T = bucket_for(t_max, buckets)
    ids = np.full((len(ragged), T), pad_id, np.int32)
    mask = np.zeros((len(ragged), T), np.int32)
    for i, r in enumerate(ragged):
        r = r[-T:]
        ids[i, T - len(r):] = r
        mask[i, T - len(r):] = 1
    return ids, mask, t_max


@dataclasses.dataclass
class TokenizedBatch:
    """A feature Batch plus the raw transcripts' token ids for in-graph text
    towers."""

    features: Batch
    text_ids: np.ndarray    # [B, T_bucket] int32, left-padded
    text_mask: np.ndarray   # [B, T_bucket] int32, 1 = valid
    text_t_max: int

    @property
    def size(self) -> int:
        return self.features.size


class VicunaRawTextDataset:
    """Three feature streams + raw transcripts, tokenized in the collate.

    Wraps a MoseiDataset (its feat4 stream unused by this path) and a
    transcript dict; the feature widths come from the sources.
    """

    def __init__(self, dataset, transcripts: Dict[str, str], tokenizer,
                 token_buckets: Sequence[int] = (16, 32, 64, 128, 256), pad_id: int = 0):
        self.ds = dataset
        self.transcripts = transcripts
        self.tokenizer = tokenizer
        self.token_buckets = tuple(token_buckets)
        self.pad_id = pad_id

    def __len__(self):
        return len(self.ds)

    def collate(self, indices: Sequence[int],
                buckets: Sequence[int] = (64, 128, 256, 512, 1024, 2048, 4096)
                ) -> TokenizedBatch:
        feats, emos, vals, names = [], [], [], []
        for i in indices:
            f, e, v, n = self.ds.example(int(i))
            feats.append(f)
            emos.append(e)
            vals.append(v)
            names.append(n)
        batch = make_batch(
            [f["audio"] for f in feats], [f["text"] for f in feats],
            [f["video"] for f in feats], [f["feat4"] for f in feats],
            np.array(emos), np.array(vals), names, buckets=buckets)
        ids, mask, t_max = tokenize_left_pad(
            [self.transcripts[n] for n in names], self.tokenizer, self.token_buckets,
            self.pad_id)
        return TokenizedBatch(batch, ids, mask, t_max)

    def batches(self, batch_size: int, *, shuffle: bool = False, seed: int = 100,
                epoch: int = 0):
        idx = np.arange(len(self.ds))
        if shuffle:
            np.random.default_rng((seed, epoch)).shuffle(idx)
        for s in range(0, len(idx), batch_size):
            yield self.collate(idx[s: s + batch_size])
