"""The port's tokenize-in-collate dataset variant (``data/raw_text.py``)
against the JAX package's on the CPU: tests/test_raw_text.py's cases, each
held to JAX's module on the same inputs (ids and masks equal exactly), and
``hf_tokenizer`` on hand-written BERT / RoBERTa directories against JAX's
(``AutoTokenizer(use_fast=False)``: the slow pure-Python tokenizers)."""

import numpy as np
import pytest
import torch

from sdumc_tpu.core.config import DataConfig as JDataConfig
from sdumc_tpu.core.config import PathsConfig as JPathsConfig
from sdumc_tpu.data import raw_text as jraw
from sdumc_tpu.data.pipeline import build_loaders as jbuild_loaders
from sdumc_tpu_torch.core.config import DataConfig, PathsConfig
from sdumc_tpu_torch.data import raw_text as praw
from sdumc_tpu_torch.data.pipeline import build_loaders

torch.set_num_threads(1)

TEXTS = ["a b c", "a", "The Movie was REALLY good", "", " ".join(f"w{i}" for i in range(20))]


def _transcripts(names):
    words = ["the", "movie", "was", "really", "good", "bad", "so", "boring"]
    rng = np.random.default_rng(0)
    return {n: " ".join(rng.choice(words, size=rng.integers(1, 12))) for n in names}


def test_csv_roundtrip(tmp_path):
    p = tmp_path / "transcription.csv"
    p.write_text("name,english,sentence\nclip_a,hello there,x\nclip_b,\"one, two\",y\n")
    for kw in ({}, {"text_col": "sentence"}):
        assert praw.read_transcripts(str(p), **kw) == jraw.read_transcripts(str(p), **kw)
    assert praw.read_transcripts(str(p)) == {"clip_a": "hello there", "clip_b": "one, two"}


@pytest.mark.parametrize("vocab_size,bos", [(32000, 1), (512, 7)])
def test_whitespace_tokenizer_ids_equal_jax(vocab_size, bos):
    """md5-hashed word ids, lower-cased, BOS first."""
    assert (praw.WhitespaceTokenizer(vocab_size, bos)(TEXTS)
            == jraw.WhitespaceTokenizer(vocab_size, bos)(TEXTS))


@pytest.mark.parametrize("buckets", [(8,), (4, 8), (64,), (16, 32, 64, 128, 256)])
@pytest.mark.parametrize("pad_id", [0, 3])
def test_left_pad_equals_jax(buckets, pad_id):
    """Left padding into the static bucket, tails kept on overflow: ids,
    mask and t_max equal JAX's."""
    got = praw.tokenize_left_pad(TEXTS, praw.WhitespaceTokenizer(), buckets, pad_id)
    want = jraw.tokenize_left_pad(TEXTS, jraw.WhitespaceTokenizer(), buckets, pad_id)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]


def test_left_pad_layout():
    tok = praw.WhitespaceTokenizer()
    ids, mask, t_max = praw.tokenize_left_pad(["a b c", "a"], tok, buckets=(8,))
    assert mask[0].tolist() == [0, 0, 0, 0, 1, 1, 1, 1]
    assert mask[1].tolist() == [0, 0, 0, 0, 0, 0, 1, 1]
    assert t_max == 4 and ids[0, 4] == tok.bos_id and ids[0, 5] == ids[1, 7]


def test_overflow_keeps_tail():
    tok = praw.WhitespaceTokenizer()
    long = " ".join(f"w{i}" for i in range(20))
    ids_small, mask_small, _ = praw.tokenize_left_pad([long], tok, buckets=(8,))
    ids_big, _, _ = praw.tokenize_left_pad([long], tok, buckets=(64,))
    assert mask_small.sum() == 8
    np.testing.assert_array_equal(ids_small[0], ids_big[0, -8:])


def test_pad_invariance_under_bucket_choice():
    tok = praw.WhitespaceTokenizer(vocab_size=512)
    emb = np.random.default_rng(1).normal(size=(512, 16)).astype(np.float32)

    def pooled(buckets):
        ids, mask, _ = praw.tokenize_left_pad(["a b c d", "a b"], tok, buckets=buckets)
        return (emb[ids] * mask[..., None]).sum(1) / mask.sum(1, keepdims=True)

    np.testing.assert_allclose(pooled((8,)), pooled((32,)), rtol=1e-6)


def test_dataset_collate_matches_jax():
    """Both packages' datasets over their synthetic stores (the same clip
    names; the features themselves are seeded differently, ROADMAP §3):
    the token side equal batch for batch, shuffled or not; the feature side
    keeps the 4F Batch contract."""
    train, _, _ = build_loaders(DataConfig(), PathsConfig(), synthetic=True,
                                synthetic_sizes=(12, 4, 4))
    jtrain, _, _ = jbuild_loaders(JDataConfig(), JPathsConfig(), synthetic=True,
                                  synthetic_sizes=(12, 4, 4))
    assert train.names == jtrain.names
    trans = _transcripts(train.names)
    ds = praw.VicunaRawTextDataset(train, trans, praw.WhitespaceTokenizer())
    jds = jraw.VicunaRawTextDataset(jtrain, trans, jraw.WhitespaceTokenizer())
    for shuffle in (False, True):
        got = list(ds.batches(5, shuffle=shuffle, epoch=2))
        want = list(jds.batches(5, shuffle=shuffle, epoch=2))
        assert [b.size for b in got] == [b.size for b in want] == [5, 5, 2]
        for g, w in zip(got, want):
            assert g.features.names == w.features.names
            np.testing.assert_array_equal(g.text_ids, w.text_ids)
            np.testing.assert_array_equal(g.text_mask, w.text_mask)
            assert g.text_t_max == w.text_t_max
            assert g.features.audio.ndim == 3 and g.features.t_max[0] >= 1
            lens = [min(1 + len(trans[n].split()), 256) for n in g.features.names]
            assert g.text_mask.sum(1).tolist() == lens


@pytest.mark.parametrize("family", ["bert", "roberta"])
def test_hf_tokenizer_matches_jax(tmp_path, family):
    """``hf_tokenizer(model_dir)`` reads the directory's own files; JAX's
    ``hf_tokenizer`` (AutoTokenizer, use_fast=False) runs transformers'
    slow BertTokenizer / RobertaTokenizer on them: the same ids."""
    import tests.test_torch_tokenizers as T

    if family == "bert":
        T.write_bert_vocab(tmp_path, T.BERT_CONFIGS["uncased"])
    else:
        T.write_byte_bpe(tmp_path, "roberta")
    texts = [t for t in T.TEXTS if t.strip()]
    assert praw.hf_tokenizer(str(tmp_path))(texts) == jraw.hf_tokenizer(str(tmp_path))(texts)
    got = praw.tokenize_left_pad(texts, praw.hf_tokenizer(str(tmp_path)), (8, 16, 32))
    want = jraw.tokenize_left_pad(texts, jraw.hf_tokenizer(str(tmp_path)), (8, 16, 32))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
