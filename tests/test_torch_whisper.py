"""sdumc_tpu_torch's ASR stage (Whisper) vs the JAX package and HF on the
CPU, at tiny sizes (tests/test_whisper.py's config), with the same numpy
inputs on both sides; and the port's safetensors reader.

Tolerances:
- the log-mel against HF's WhisperFeatureExtractor atol 1e-5 (JAX's test's:
  the same math, another FFT) and against JAX's atol 1e-5 (f32 FFTs);
- the encoder 2e-4 and the teacher-forced logits 3e-4 against HF and JAX,
  the cached decode against the uncached 1e-4 (JAX's test's tolerances:
  f32 through a few layers in another summation order);
- greedy tokens, ``energy_vad`` spans, the tokenizer's text and the csv are
  equal, exactly;
- the safetensors reader equal to ``safetensors.torch.load_file``, exactly.
"""

import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.convert.hf_whisper import hf_whisper_to_params
from sdumc_tpu.extract.asr import energy_vad as jax_vad
from sdumc_tpu.extract.asr import transcribe_dir as jax_transcribe_dir
from sdumc_tpu.models.whisper import WhisperModel as JaxWhisper
from sdumc_tpu.models.whisper import greedy_transcribe as jax_greedy
from sdumc_tpu.ops.mel import log_mel_spectrogram as jax_mel
from sdumc_tpu_torch.convert import safetensors_io, whisper_state_dict_from_flax
from sdumc_tpu_torch.convert.hf_whisper import config_from_hf, generation_meta, state_dict_from_hf
from sdumc_tpu_torch.convert.whisper_tokenizer import WhisperTokenizer, bytes_to_unicode
from sdumc_tpu_torch.extract.asr import energy_vad
from sdumc_tpu_torch.models.whisper import WhisperModel, greedy_transcribe, init_self_caches
from sdumc_tpu_torch.ops.mel import log_mel_spectrogram

# several test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

HF_KW = dict(vocab_size=100, num_mel_bins=8, encoder_layers=2, encoder_attention_heads=2,
             decoder_layers=2, decoder_attention_heads=2, d_model=16, encoder_ffn_dim=32,
             decoder_ffn_dim=32, max_source_positions=50, max_target_positions=40,
             pad_token_id=0, bos_token_id=1, decoder_start_token_id=2, eos_token_id=3,
             begin_suppress_tokens=[7, 3], suppress_tokens=[9])
RULES = dict(start_id=2, eos_id=3, suppress_ids=(9,), begin_suppress_ids=(7, 3))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _hf_model(seed=0, **overrides):
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    hf_cfg = HFConfig(**{**HF_KW, **overrides})
    torch.manual_seed(seed)
    return hf_cfg, WhisperForConditionalGeneration(hf_cfg).eval()


@pytest.fixture(scope="module")
def setup():
    hf_cfg, hf = _hf_model()
    params = hf_whisper_to_params(hf.state_dict())
    cfg = config_from_hf(hf_cfg.to_dict())
    model = WhisperModel(cfg).eval()
    model.load_state_dict(state_dict_from_hf(hf.state_dict()), strict=True)
    mel = np.random.default_rng(0).normal(size=(2, 8, 100)).astype(np.float32)
    return hf, cfg, model, params, mel


def _jax_apply(params, cfg_kw=None):
    from sdumc_tpu.models.whisper import WhisperConfig as JaxConfig

    jcfg = JaxConfig.tiny(**(cfg_kw or {}))
    jm = JaxWhisper(jcfg)

    def apply_fn(method, *a, **kw):
        return jm.apply({"params": params}, *a, method=getattr(JaxWhisper, method), **kw)

    return jcfg, jm, apply_fn


def test_state_dict_from_flax_is_hf_state_dict(setup):
    """whisper_state_dict_from_flax(JAX params) is HF's state dict as the port
    loads it, key for key and to the bit."""
    hf, _, model, params, _ = setup
    got = whisper_state_dict_from_flax(params)
    want = model.state_dict()
    assert set(got) == set(want)
    for key, val in want.items():
        assert torch.equal(got[key], val), key


def test_log_mel_matches_jax_and_hf():
    from transformers import WhisperFeatureExtractor

    rng = np.random.default_rng(0)
    wav = (rng.normal(size=(2, 16000 * 5)) * 0.1).astype(np.float32)
    ref = WhisperFeatureExtractor(feature_size=80)(
        list(wav), sampling_rate=16000, return_tensors="np").input_features
    got = _np(log_mel_spectrogram(wav))
    assert got.shape == ref.shape == (2, 80, 3000) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_mel(wav)), atol=1e-5)
    long = (rng.normal(size=(16000 * 35,)) * 0.1).astype(np.float32)      # trimmed to 30 s
    np.testing.assert_allclose(_np(log_mel_spectrogram(long, n_mels=8)),
                               np.asarray(jax_mel(long, n_mels=8)), atol=1e-5)


def test_encoder_and_logits_match_jax_and_hf(setup):
    hf, cfg, model, params, mel = setup
    _, jm, _ = _jax_apply(params)
    ids = np.array([[2, 5, 11, 12], [2, 5, 30, 31]], np.int64)
    with torch.inference_mode():
        enc = model.encoder(torch.from_numpy(mel))
        logits = model(torch.from_numpy(mel), torch.from_numpy(ids))
        hf_enc = hf.model.encoder(torch.from_numpy(mel)).last_hidden_state
        hf_logits = hf(input_features=torch.from_numpy(mel),
                       decoder_input_ids=torch.from_numpy(ids)).logits
    j_enc = jm.apply({"params": params}, jnp.asarray(mel), method=JaxWhisper.encode)
    j_logits = jm.apply({"params": params}, jnp.asarray(mel), jnp.asarray(ids, jnp.int32))["logits"]
    for want in (hf_enc, j_enc):
        np.testing.assert_allclose(_np(enc), _np(want), rtol=2e-4, atol=2e-4)
    for want in (hf_logits, j_logits):
        np.testing.assert_allclose(_np(logits), _np(want), rtol=3e-4, atol=3e-4)


def test_cached_decode_matches_uncached_and_jax(setup):
    _, cfg, model, params, mel = setup
    _, jm, _ = _jax_apply(params)
    ids = torch.tensor([[2, 5, 11, 12]])
    with torch.inference_mode():
        full = model(torch.from_numpy(mel[:1]), ids)
        xkvs = model.decoder.cross_kv(model.encoder(torch.from_numpy(mel[:1])))
        caches = init_self_caches(cfg, 1, 8)
        steps = [model.decoder(ids[:, t:t + 1], xkvs, start=t, caches=caches)[:, 0]
                 for t in range(ids.shape[1])]
    np.testing.assert_allclose(_np(torch.stack(steps, 1)), _np(full), rtol=1e-4, atol=1e-4)
    want = jm.apply({"params": params}, jnp.asarray(mel[:1]), jnp.asarray(_np(ids), jnp.int32))
    np.testing.assert_allclose(_np(full), np.asarray(want["logits"]), rtol=3e-4, atol=3e-4)


def _hf_free_tokens(row, eos):
    out = []
    for t in row:
        if t == eos:
            break
        out.append(int(t))
    return out


@pytest.mark.parametrize("check_every", [1, 3, 8])
def test_greedy_transcribe_matches_jax_and_hf(setup, check_every):
    """Forced position 1, suppress and begin-suppress lists: the tokens
    equal JAX's greedy_transcribe's and HF generate's (the forced prefix as
    explicit decoder ids, as JAX's test feeds it); any check_every gives
    the same tokens."""
    hf, cfg, model, params, mel = setup
    max_new = 12
    with torch.no_grad():
        ref = hf.generate(input_features=torch.from_numpy(mel),
                          decoder_input_ids=torch.tensor([[2, 5]] * 2),
                          suppress_tokens=[9], begin_suppress_tokens=[7, 3],
                          max_new_tokens=max_new - 1, do_sample=False, num_beams=1).numpy()
    jcfg, _, apply_fn = _jax_apply(params)
    want = jax.jit(lambda m: jax_greedy(apply_fn, m, jcfg, max_new_tokens=max_new,
                                        forced_ids=((1, 5),), **RULES))(jnp.asarray(mel))
    with torch.inference_mode():
        got = greedy_transcribe(model, torch.from_numpy(mel), max_new_tokens=max_new,
                                forced_ids=((1, 5),), check_every=check_every, **RULES)
    np.testing.assert_array_equal(_np(got["tokens"]), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(_np(got["n_tokens"]), np.asarray(want["n_tokens"]))
    for b in range(2):
        core = _hf_free_tokens(ref[b], 3)
        assert _np(got["tokens"])[b, 0] == 5
        assert _np(got["tokens"])[b, 1:1 + len(core)].tolist() == core


def test_asr_pipeline_tokens_match_hf_and_jax(setup):
    """wav -> the port's mel -> encoder -> greedy loop against HF's
    extractor + generate and JAX's pipeline (the tiny model's window is
    2 x max_source_positions = 100 frames: every side trims alike)."""
    from transformers import WhisperFeatureExtractor

    hf, cfg, model, params, _ = setup
    wav = (np.random.default_rng(7).normal(size=(2, 16000 * 3)) * 0.05).astype(np.float32)
    mel_hf = WhisperFeatureExtractor(feature_size=8)(
        list(wav), sampling_rate=16000, return_tensors="np").input_features[:, :, :100]
    with torch.no_grad():
        ref = hf.generate(input_features=torch.from_numpy(mel_hf), suppress_tokens=[9],
                          begin_suppress_tokens=[7, 3], max_new_tokens=10, do_sample=False,
                          num_beams=1).numpy()
    jcfg, _, apply_fn = _jax_apply(params)
    jmel = jax_mel(wav, n_mels=8)[:, :, :100]
    want = jax.jit(lambda m: jax_greedy(apply_fn, m, jcfg, max_new_tokens=10, **RULES))(jmel)
    with torch.inference_mode():
        mel = log_mel_spectrogram(wav, n_mels=8)[:, :, :100]
        got = _np(greedy_transcribe(model, mel, max_new_tokens=10, **RULES)["tokens"])
    np.testing.assert_array_equal(got, np.asarray(want["tokens"]))
    for b in range(2):
        core = _hf_free_tokens(ref[b][1:], 3)
        assert got[b, :len(core)].tolist() == core


def test_energy_vad_matches_jax():
    """Bursts over a noise floor (two segments, a merged pair, a dropped
    micro-burst), pure silence, a clip shorter than a frame, random speech."""
    sr = 16000
    rng = np.random.default_rng(0)
    wav = rng.normal(size=sr * 8).astype(np.float32) * 1e-4
    t1 = np.arange(sr)
    wav[sr:2 * sr] += 0.3 * np.sin(2 * np.pi * 220 * t1 / sr)
    wav[4 * sr:5 * sr] += 0.3 * np.sin(2 * np.pi * 330 * t1 / sr)
    wav[5 * sr + 3000:6 * sr] += 0.3 * np.sin(2 * np.pi * 330 * t1[:13000] / sr)
    wav[7 * sr:7 * sr + 1600] += 0.3                             # 100 ms: dropped
    cases = [wav, rng.normal(size=sr).astype(np.float32) * 1e-5, np.zeros(100, np.float32),
             (rng.normal(size=sr * 3) * np.repeat(rng.uniform(0, 1, 30), 1600)).astype(np.float32)]
    for case in cases:
        assert energy_vad(case, sr=sr) == jax_vad(case, sr=sr)
    assert len(energy_vad(wav, sr=sr)) == 2


# ---------------------------------------------------------------- the tokenizer and the stage

SPECIALS = ("<|endoftext|>", "<|startoftranscript|>", "<|en|>", "<|transcribe|>",
            "<|startofprev|>", "<|notimestamps|>")
STAMPS = ("<|0.00|>", "<|0.02|>", "<|1.50|>")
WORDS = ("Ġthe", "Ġcat", "Ġsat", "Ġ.", "Ġ,", "Ġn't", "Ġ's", "Ġ'", "Ġ?", "he", "llo", "Ġhello")


def write_tokenizer(path, n_ids: int = 100, clean_up: bool = False) -> dict:
    """A byte-level BPE tokenizer.json over ids 0 .. n_ids - 1 in Whisper's
    layout: the BPE vocabulary first (byte pieces, a few words, pieces of
    multi-byte characters, so that a cut sequence is invalid UTF-8), then
    the added tokens, specials (<|endoftext|>, <|startofprev|> ...) and
    timestamps (not special). Returns {added token: id}."""
    b2u = bytes_to_unicode()
    pieces = [b2u[b] for b in range(32, 127)] + list(WORDS)
    for s in ("é", "日本", "€"):
        raw = s.encode()
        pieces += ["".join(b2u[b] for b in raw), b2u[raw[0]], "".join(b2u[b] for b in raw[1:])]
    n_pieces = n_ids - len(SPECIALS) - len(STAMPS)
    vocab = {p: i for i, p in enumerate(list(dict.fromkeys(pieces))[:n_pieces])}
    ids = {c: n_pieces + i for i, c in enumerate(SPECIALS + STAMPS)}
    added = [{"id": i, "content": c, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": c in SPECIALS} for c, i in ids.items()]
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": None,
            "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                              "trim_offsets": True, "use_regex": True},
            "post_processor": None,
            "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                        "use_regex": True},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": []}}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"clean_up_tokenization_spaces": clean_up,
                   "tokenizer_class": "WhisperTokenizer"}, f)
    return ids


@pytest.mark.parametrize("clean_up", [False, True])
def test_tokenizer_decode_matches_hf(tmp_path, clean_up):
    """Random id sequences (specials, timestamps, prompts, cut multi-byte
    characters, punctuation after spaces) decode as
    WhisperTokenizerFast.decode(ids, skip_special_tokens=True) does."""
    from transformers import WhisperTokenizerFast

    added = write_tokenizer(tmp_path, clean_up=clean_up)
    hf = WhisperTokenizerFast.from_pretrained(str(tmp_path))
    mine = WhisperTokenizer.from_dir(str(tmp_path))
    assert hf.convert_tokens_to_ids("<|startofprev|>") == added["<|startofprev|>"]
    rng = np.random.default_rng(1)
    for trial in range(1500):
        ids = rng.integers(0, 100, size=rng.integers(0, 14)).tolist()
        if trial % 4 == 0:
            ids = [added["<|startofprev|>"]] + ids               # a prompt
        assert mine.decode(ids) == hf.decode(ids, skip_special_tokens=True), ids


def _write_wav(path, samples):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes())


def _asr_dir(path):
    """A tiny HF Whisper directory JAX's transcribe_dir can read:
    save_pretrained's config.json and model.safetensors (max_source_positions
    1500: the full 30-s window), generation_config.json with a forced
    position 1 and the suppress lists, and write_tokenizer's files."""
    hf_cfg, hf = _hf_model(seed=3, max_source_positions=1500)
    hf.save_pretrained(path, safe_serialization=True)
    rules = dict(forced_decoder_ids=[[1, 5]], suppress_tokens=[9], begin_suppress_tokens=[7, 3])
    # both files carry the rules, as base.en's do (this transformers drops a
    # generation_config's forced_decoder_ids, and JAX's loader falls back to
    # config.json's)
    for name in ("generation_config.json", "config.json"):
        with open(os.path.join(path, name)) as f:
            spec = json.load(f)
        spec.update(rules, decoder_start_token_id=2, eos_token_id=3)
        with open(os.path.join(path, name), "w") as f:
            json.dump(spec, f)
    write_tokenizer(path)
    return hf


@pytest.mark.parametrize("vad", [False, True])
def test_cli_asr_writes_jax_csv(tmp_path, vad):
    """cli.extract asr --device cpu writes the csv JAX's transcribe_dir
    writes, byte for byte: 5 clips (one of 31 s, split over the window; one
    of bursts that --vad cuts into segments), batch 2, so the last batch is
    short."""
    from sdumc_tpu_torch.cli import extract

    _asr_dir(tmp_path / "model")
    audio = tmp_path / "wavs"
    audio.mkdir()
    rng = np.random.default_rng(5)
    sr = 16000
    bursts = rng.normal(size=sr * 6) * 1e-3
    bursts[sr:2 * sr] += 0.3 * np.sin(2 * np.pi * 220 * np.arange(sr) / sr)
    bursts[4 * sr:5 * sr] += 0.3 * np.sin(2 * np.pi * 330 * np.arange(sr) / sr)
    for name, samples in (("c0", 0.2 * rng.normal(size=sr * 2)), ("c1", bursts),
                          ("c2", 0.1 * rng.normal(size=int(sr * 31))),
                          ("c3", 0.3 * rng.normal(size=sr)), ("c4", 0.05 * rng.normal(size=sr * 4))):
        _write_wav(audio / f"{name}.wav", samples)
    args = ["--model_dir", str(tmp_path / "model"), "--audio_dir", str(audio),
            "--batch", "2", "--max_new_tokens", "8"] + (["--vad"] if vad else [])
    out = extract.main(["asr", "--device", "cpu", "--save_csv", str(tmp_path / "port.csv"), *args])
    jax_transcribe_dir(str(tmp_path / "model"), str(audio), str(tmp_path / "jax.csv"),
                       batch=2, max_new_tokens=8, vad=vad)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert out["clips"] == 5 and out["pieces"] >= 6 and [r[0] for r in out["rows"]] == [
        "c0", "c1", "c2", "c3", "c4"]
    from sdumc_tpu_torch.extract.text import read_transcripts

    assert read_transcripts(str(tmp_path / "port.csv")) == [(n, t) for n, t in out["rows"]]


def test_asr_refuses_without_a_card_and_reads_generation_fallbacks(tmp_path, monkeypatch):
    from sdumc_tpu_torch.cli import extract

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract.main(["asr", "--model_dir", str(tmp_path), "--audio_dir", str(tmp_path),
                      "--save_csv", str(tmp_path / "t.csv")])
    config = {"decoder_start_token_id": 2, "eos_token_id": 3, "forced_decoder_ids": [[1, 5]],
              "suppress_tokens": [9], "begin_suppress_tokens": None}
    meta = generation_meta(config, {"forced_decoder_ids": None, "suppress_tokens": [1, 2]})
    assert meta == {"decoder_start_token_id": 2, "eos_token_id": 3,
                    "forced_decoder_ids": [[1, 5]], "suppress_tokens": [1, 2],
                    "begin_suppress_tokens": []}


@pytest.mark.parametrize("sharded", [False, True])
def test_safetensors_reader_matches_the_package(tmp_path, sharded):
    """f32 / f16 / bf16 / int64 tensors (and an empty one) written by the
    safetensors package read back equal by the port's reader, one file or
    shards behind an index; the port's writer round-trips through the
    package."""
    from safetensors.torch import load_file, save_file

    gen = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(3, 5, generator=gen),
               "b.half": torch.randn(7, generator=gen).half(),
               "c.bf16": torch.randn(2, 2, 4, generator=gen).bfloat16(),
               "d.ids": torch.arange(6).reshape(2, 3), "e.empty": torch.zeros(0, 4)}
    if sharded:
        names = sorted(tensors)
        shards = {"model-00001-of-00002.safetensors": names[:2],
                  "model-00002-of-00002.safetensors": names[2:]}
        for shard, keys in shards.items():
            save_file({k: tensors[k] for k in keys}, str(tmp_path / shard))
        with open(tmp_path / "model.safetensors.index.json", "w") as f:
            json.dump({"weight_map": {k: s for s, keys in shards.items() for k in keys}}, f)
        want = {k: v for s in shards for k, v in load_file(str(tmp_path / s)).items()}
    else:
        save_file(tensors, str(tmp_path / "model.safetensors"), metadata={"format": "pt"})
        want = load_file(str(tmp_path / "model.safetensors"))
    got = safetensors_io.load_hf_weights(str(tmp_path))
    assert set(got) == set(want)
    for key, val in want.items():
        assert got[key].dtype == val.dtype and torch.equal(got[key], val), key
    safetensors_io.save_file(tensors, str(tmp_path / "mine.safetensors"))
    back = load_file(str(tmp_path / "mine.safetensors"))
    assert all(torch.equal(back[k], v) and back[k].dtype == v.dtype for k, v in tensors.items())
