"""sdumc_tpu_torch's text stage (the tokenizer's decoder, the special-token
probe, ``extract_text_features`` and ``cli.extract text``) against the
``tokenizers`` package, transformers' AutoTokenizer and the JAX package on
the CPU, at tiny sizes, the same inputs on both sides.

Tolerances: decoded text and token spans equal; features at f32 rtol/atol
2e-5 (XLA and torch sum in other orders); at bf16, 4 bf16 ulps of the
largest |feature| (both round every layer's output to bf16, at other
places); the tap sum equal to the bit to the model-dtype sum of the
returned hidden states.
"""

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sdumc_tpu.extract import text as jtext
from sdumc_tpu.models import llama as jl
from sdumc_tpu_torch.convert import llama_state_dict_from_flax
from sdumc_tpu_torch.convert.hf_llama import config_from_hf
from sdumc_tpu_torch.convert.llama_tokenizer import SPACE, LlamaTokenizer
from sdumc_tpu_torch.extract import text as ptext
from sdumc_tpu_torch.models.llama import LlamaModel
from tests.test_torch_feat4 import write_tokenizer_json, write_tokenizer_model
from tests.test_torch_llama import hf_model, jax_from_hf

# several test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_ULPS = 4
WORDS = ("today is a good day i think the movie was really not bad at all and "
         "we liked how it ended but acting felt slow so overall okay").split()
SENTENCES = [
    "today is a good day", "i think the movie was really not bad", "", "okay",
    "we liked how it ended but the acting felt slow so overall it was okay and "
    "i think we liked it",                                    # overlong for buckets (4, 8, 16)
    "the café was good", "not bad", "so slow", float("nan"), "a good movie",
    "we think it was good",
]
BUCKETS = (4, 8, 16)
LLAMA_DECODER = {"type": "Sequence", "decoders": [
    {"type": "Replace", "pattern": {"String": SPACE}, "content": " "},
    {"type": "ByteFallback"}, {"type": "Fuse"},
    {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}


def write_text_tokenizer(path, words=WORDS, decoder=LLAMA_DECODER):
    """tokenizer.json (LLaMA's layout: specials, the 256 byte tokens, BPE
    with byte fallback, the Prepend / Replace normalizer and ``decoder``)
    whose vocabulary covers ``words`` (each word's prefixes merged left to
    right; any other character falls back to bytes), and
    tokenizer_config.json. Returns the vocabulary."""
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    vocab.update({f"<0x{b:02X}>": 3 + b for b in range(256)})
    pieces = [SPACE + w for w in words]
    for ch in sorted(set("".join(pieces))):
        vocab.setdefault(ch, len(vocab))
    merges = []
    for w in pieces:
        for n in range(2, len(w) + 1):
            if w[:n] not in vocab:
                vocab[w[:n]] = len(vocab)
                merges.append(f"{w[:n - 1]} {w[n - 1]}")
    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": i, "content": t, "single_word": False, "lstrip": False,
                              "rstrip": False, "normalized": False, "special": True}
                             for t, i in (("<unk>", 0), ("<s>", 1), ("</s>", 2))],
            "normalizer": {"type": "Sequence", "normalizers": [
                {"type": "Prepend", "prepend": SPACE},
                {"type": "Replace", "pattern": {"String": " "}, "content": SPACE}]},
            "pre_tokenizer": None, "post_processor": None, "decoder": decoder,
            "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": True, "byte_fallback": True, "vocab": vocab,
                      "merges": merges}}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "LlamaTokenizerFast", "add_bos_token": True,
                   "add_eos_token": False, "bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>", "legacy": True}, f)
    return vocab


def write_text_model_dir(path, seed=0):
    """A tiny HF LLaMA directory (3 layers, width 64, pytorch_model.bin)
    with the tokenizer above; returns (HF config, HF model)."""
    vocab = write_text_tokenizer(path)
    hf_cfg, hf = hf_model(seed=seed, vocab_size=len(vocab), max_position_embeddings=64)
    hf.save_pretrained(str(path), safe_serialization=False)
    write_text_tokenizer(path)          # save_pretrained leaves the tokenizer files alone
    return hf_cfg, hf


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    """The tiny directory, both tokenizers, and the model as JAX params, a
    JAX LlamaModel and the port's trunk, at f32 and at bf16."""
    from transformers import AutoTokenizer

    path = tmp_path_factory.mktemp("llama")
    hf_cfg, hf = write_text_model_dir(path)
    models = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        jcfg, params = jax_from_hf(hf, hf_cfg, dtype=jdt)
        sd = llama_state_dict_from_flax(params)
        trunk = LlamaModel(config_from_hf(hf_cfg.to_dict(), tdt))
        trunk.load_state_dict({k[len("model."):]: v.to(torch.float32 if k.endswith("norm.weight")
                                                          else tdt)
                               for k, v in sd.items() if k.startswith("model.")}, strict=True)
        models[name] = (jl.LlamaModel(jcfg), params["model"], trunk.eval())
    return path, AutoTokenizer.from_pretrained(str(path)), LlamaTokenizer.from_dir(str(path)), models


# ---------------------------------------------------------------- tokenizer decode

@pytest.mark.parametrize("decoder", ["llama", None])
def test_decode_matches_tokenizers(tmp_path, decoder):
    """Special tokens as their content, byte runs joined into UTF-8 (one
    U+FFFD per byte of an invalid run), '▁' as a space, one leading space
    stripped; with no decoder, the tokens joined by spaces."""
    from tokenizers import Tokenizer

    vocab = write_text_tokenizer(tmp_path, decoder=LLAMA_DECODER if decoder else None)
    ours = LlamaTokenizer.from_dir(str(tmp_path))
    ref = Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    b = lambda x: vocab[f"<0x{x:02X}>"]  # noqa: E731
    cases = [ours(s)["input_ids"] + [2] for s in ("today is a good café day", "  okay  é", "")]
    cases += [[1, b(0xC3), vocab["▁a"], b(0xFF), b(0xC3), b(0xA9)],     # invalid, then valid
              [vocab[SPACE], vocab[SPACE], vocab["▁today"], 1, 1],
              [b(0xE2), b(0x82), b(0xAC)]]                              # a 3-byte character
    for ids in cases:
        assert ours.decode(ids) == ref.decode(ids, skip_special_tokens=False), ids
    assert ours.convert_ids_to_tokens([1, vocab["▁today"]]) == ["<s>", "▁today"]
    with pytest.raises(KeyError, match="not in the vocabulary"):
        ours.decode([len(vocab) + 5])


def test_sentencepiece_decode_matches_tokenizer_json(tmp_path):
    """A tokenizer.model decodes as SentencePiece does, which is what the
    LLaMA decoder of a tokenizer.json of the same vocabulary gives."""
    from tokenizers import Tokenizer

    write_tokenizer_model(tmp_path / "sp")
    write_tokenizer_json(tmp_path / "json")
    spec_path = tmp_path / "json" / "tokenizer.json"
    spec = json.loads(spec_path.read_text(encoding="utf-8"))
    spec["decoder"] = LLAMA_DECODER
    spec_path.write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    ours = LlamaTokenizer.from_dir(str(tmp_path / "sp"))
    ref = Tokenizer.from_file(str(spec_path))
    for text in ("Transcribe speech to text. ", "speech to é", " to  text"):
        ids = ours(text)["input_ids"] + [2]
        assert ours.decode(ids) == ref.decode(ids, skip_special_tokens=False), text


def test_unknown_decoder_raises(tmp_path):
    write_text_tokenizer(tmp_path, decoder={"type": "CTC", "pad_token": "<pad>"})
    tok = LlamaTokenizer.from_dir(str(tmp_path))
    assert tok("today")["input_ids"][0] == 1            # encoding still works
    with pytest.raises(NotImplementedError, match="decoder 'CTC'"):
        tok.decode([1, 5])


def test_find_token_span_matches_jax_with_auto_tokenizer(stage):
    _, auto, ours, _ = stage
    assert ptext.find_token_span(ours) == jtext.find_token_span(auto) == (1, 0)
    for probe in ("a good movie", "the café"):
        assert ptext.find_token_span(ours, probe) == jtext.find_token_span(auto, probe)


# ---------------------------------------------------------------- features

def _both(stage, dtype, layer_ids, level):
    _, auto, ours, models = stage
    jmodel, jparams, trunk = models[dtype]
    kw = dict(layer_ids=layer_ids, feature_level=level, buckets=BUCKETS, batch_size=3)
    want = jtext.extract_text_features(jmodel, jparams, auto, SENTENCES, **kw)
    got = ptext.extract_text_features(trunk, ours, SENTENCES, **kw)
    return got, want


@pytest.mark.parametrize("layer_ids", [(-3,), (-4, -3, -2, -1)])
@pytest.mark.parametrize("level", ["FRAME", "UTTERANCE"])
def test_features_match_jax_at_f32(stage, layer_ids, level):
    """Length buckets 4/8/16 with an overlong row, batches of 3 (short last
    chunks), an empty and a NaN transcript (zeros), BOS stripped."""
    got, want = _both(stage, "f32", layer_ids, level)
    assert len(got) == len(want) == len(SENTENCES)
    for g, w, s in zip(got, want, SENTENCES):
        assert g.dtype == np.float32 and g.shape == w.shape, s
        np.testing.assert_allclose(g, w, **F32_TOL, err_msg=str(s))
    zeros = (1, 64) if level == "FRAME" else (64,)
    assert got[2].shape == got[8].shape == zeros and not got[2].any() and not got[8].any()
    if level == "FRAME":                 # the overlong row ran at its exact length
        assert got[4].shape[0] >= max(BUCKETS)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("layer_ids", [(-3,), (-4, -3, -2, -1)])
def test_frame_features_match_jax_at_bf16(stage, layer_ids):
    got, want = _both(stage, "bf16", layer_ids, "FRAME")
    top = max(float(np.abs(w).max()) for w in want)
    for g, w, s in zip(got, want, SENTENCES):
        assert g.shape == w.shape, s
        assert np.abs(g - w).max() <= BF16_ULPS * _bf16_ulp(top), s


def test_utterance_is_the_f32_mean_of_the_bf16_frames(stage):
    """UTTERANCE is the f32 mean of the FRAME span (JAX takes it in bf16);
    against JAX's FRAME span, averaged in f32, within the bf16 tolerance."""
    utt, _ = _both(stage, "bf16", (-4, -3, -2, -1), "UTTERANCE")
    frames, jframes = _both(stage, "bf16", (-4, -3, -2, -1), "FRAME")
    top = max(float(np.abs(w).max()) for w in jframes)
    for u, f, jf in zip(utt, frames, jframes):
        if f.shape[0] == 1 and not f.any():
            assert u.shape == (64,) and not u.any()
            continue
        np.testing.assert_array_equal(u, f.mean(axis=0))
        assert np.abs(u - jf.mean(axis=0)).max() <= BF16_ULPS * _bf16_ulp(top)


def test_jax_bf16_mean_differs_from_the_f32_mean():
    """The JAX stage's UTTERANCE is ``span.mean(axis=0)`` of a bf16 numpy
    span: numpy accumulates it in bf16 (ml_dtypes), which drifts from the
    mean of the same bf16 values in f32 by far more than one bf16 rounding."""
    span = (np.random.default_rng(0).normal(size=(300, 64)) * 3).astype(ml_dtypes.bfloat16)
    bf16_mean = span.mean(axis=0).astype(np.float32)
    f32_mean = span.astype(np.float32).mean(axis=0)
    rounded = f32_mean.astype(ml_dtypes.bfloat16).astype(np.float32)
    assert np.abs(bf16_mean - f32_mean).max() > 4 * np.abs(rounded - f32_mean).max()


def test_tap_sum_is_the_model_dtype_sum_in_sorted_order(stage):
    """run_batch's tap sum is bf16 and equals, to the bit, the bf16 sum of
    the returned hidden states in sorted index order (as JAX sums them),
    not feat4's f32 tap sum."""
    _, _, ours, models = stage
    trunk = models["bf16"][2]
    ids = torch.tensor([ours("today is a good day")["input_ids"] + [0, 0]])
    lengths = torch.tensor([ids.shape[1] - 2])
    with torch.inference_mode():
        got = ptext.run_batch(trunk, ids, lengths, (-1, -4, -2))
        causal = torch.ones(ids.shape[1], ids.shape[1], dtype=torch.bool).tril()
        valid = torch.arange(ids.shape[1])[None, :] < lengths[:, None]
        mask = torch.where(causal[None] & valid[:, None, :], 0.0, -1e30)[:, None]
        hs = trunk(input_ids=ids, attn_mask=mask, output_hidden_states=True)["hidden_states"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (hs[0] + hs[2]) + hs[3])
    assert ptext.tap_indices(4, (-1, -4, -2, 7, -9)) == [0, 2, 3]


# ---------------------------------------------------------------- the CLI

def _write_csv(path, rows):
    import csv

    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["name", "sentence"])
        w.writerows(rows)


def test_cli_extract_text_matches_jax_main(tmp_path, monkeypatch):
    """``cli.extract text --device cpu --layer_ids -3`` (bf16, as JAX loads
    it) writes JAX main's files; --tp 2 with a family other than llama
    raises; without --device cpu and no card, it raises. (The other families run
    in tests/test_torch_text_families.py.)"""
    from sdumc_tpu_torch.cli import extract

    write_text_model_dir(tmp_path / "llm", seed=3)
    rows = [(f"clip_{i}", s if isinstance(s, str) else "") for i, s in enumerate(SENTENCES)]
    _write_csv(tmp_path / "trans.csv", rows)
    common = ["--model_dir", str(tmp_path / "llm"), "--trans_path", str(tmp_path / "trans.csv"),
              "--layer_ids", "-3"]
    jtext.main(common + ["--save_dir", str(tmp_path / "jax")])
    out = extract.main(["text"] + common + ["--save_dir", str(tmp_path / "port"),
                                            "--device", "cpu"])
    assert out["rows"] == len(rows)
    top = max(float(np.abs(np.load(tmp_path / "jax" / f"{n}.npy")).max()) for n, _ in rows)
    for name, sent in rows:
        got, want = (np.load(tmp_path / d / f"{name}.npy") for d in ("port", "jax"))
        assert got.dtype == np.float32 and got.shape == want.shape, name
        assert np.abs(got - want).max() <= BF16_ULPS * _bf16_ulp(top), name
    with pytest.raises(ValueError, match="llama family only"):
        extract.main(["text"] + common + ["--save_dir", "x", "--tp", "2", "--family", "bert"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract.main(["text"] + common + ["--save_dir", str(tmp_path / "card")])
