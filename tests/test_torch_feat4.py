"""sdumc_tpu_torch's feat4 stage (beam/greedy decode with hidden-state taps,
the projector, the tokenizer, Feat4Extractor and ``cli.extract feat4``)
against HF and the JAX package on the CPU, at tiny sizes, the same numpy
inputs on both sides.

Tolerances: tokens equal everywhere; taps rtol/atol 3e-4 against HF (the
JAX package's own tolerance for its taps against HF) and 1e-5 against JAX
(f32, other summation orders); runs of the port against itself (bucketed
against exact length, a chunk against solo runs, ``check_every``) 1e-5 or
exact; the projector 1e-5.
"""

import ast
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.extract.llm4wav import Feat4Extractor as JaxFeat4
from sdumc_tpu.extract.projector import EncoderProjectorConcat as JaxProjector
from sdumc_tpu.models import generation as jg
from sdumc_tpu.models import llama as jl
from sdumc_tpu.ops.quant import quantize_params as jax_quantize_params
from sdumc_tpu_torch.convert import llama_state_dict_from_flax
from sdumc_tpu_torch.convert.llama_tokenizer import SPACE, LlamaTokenizer
from sdumc_tpu_torch.extract.llm4wav import DEFAULT_PROMPT, Feat4Extractor
from sdumc_tpu_torch.extract.projector import (EncoderProjectorConcat,
                                               projector_state_dict_from_flax)
from sdumc_tpu_torch.models.generation import (beam_generate, beam_generate_batched,
                                               greedy_generate)
from sdumc_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from tests.test_torch_llama import hf_model, jax_from_hf, port_from_hf

# several test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

HF_TOL = dict(rtol=3e-4, atol=3e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
REPO = Path(__file__).resolve().parent.parent


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _make_setup(lm_head_scale=1.0):
    """The tiny HF LLaMA of tests/test_generation.py (vocab 96, width 48,
    2 layers; lm_head scaled by ``lm_head_scale``), the port's copy and
    JAX's copy with a jitted decode."""
    hf_cfg, hf = hf_model(seed=1, vocab_size=96, hidden_size=48, intermediate_size=96,
                          num_hidden_layers=2, max_position_embeddings=256,
                          eos_token_id=2, bos_token_id=1, pad_token_id=0)
    with torch.no_grad():
        hf.lm_head.weight.mul_(lm_head_scale)
    cfg, port = port_from_hf(hf, hf_cfg)
    jcfg, params = jax_from_hf(hf, hf_cfg)
    model = jl.LlamaForCausalLM(jcfg)
    emb = jnp.asarray(params["model"]["embed_tokens"]["embedding"])

    def apply_fn(**kw):
        return model.apply({"params": params}, **kw)

    def jax_beam(pe, lens, max_new, eos=2):
        return jax.jit(lambda pe, lens: jg.beam_generate_batched(
            apply_fn, pe, jcfg, embed_fn=lambda t: emb[t], prompt_len=lens, num_beams=4,
            max_new_tokens=max_new, eos_id=eos))(jnp.asarray(pe), jnp.asarray(lens, jnp.int32))

    return hf, cfg, port, jcfg, apply_fn, emb, jax_beam


@pytest.fixture(scope="module")
def setup():
    return _make_setup()


@pytest.fixture(scope="module")
def sharp():
    """The same model with logits 30x sharper: with EOS_EARLY as EOS, the
    clips of ``_chunk`` end at different steps (a random model at init
    scale is too flat for HF's done rule ever to fire)."""
    return _make_setup(30.0)


EOS_EARLY = 79


def _prompt(seed, P, D, C=1):
    return (np.random.default_rng(seed).normal(size=(C, P, D)) * 0.5).astype(np.float32)


def _port_beam(port, cfg, pe, lens, max_new, eos=2, **kw):
    with torch.inference_mode():
        out = beam_generate_batched(port, torch.from_numpy(pe), cfg,
                                    embed_fn=port.model.embed_tokens, prompt_len=lens,
                                    num_beams=4, max_new_tokens=max_new, eos_id=eos, **kw)
    return {k: v.numpy() for k, v in out.items()}


def test_greedy_matches_hf_and_jax(setup):
    hf, cfg, port, jcfg, apply_fn, emb, _ = setup
    prompt = _prompt(0, 5, cfg.hidden_size)
    with torch.no_grad():
        want = hf.generate(inputs_embeds=torch.tensor(prompt), max_new_tokens=12,
                           do_sample=False, num_beams=1)[0].numpy()
    with torch.inference_mode():
        got = greedy_generate(port, torch.tensor(prompt), cfg,
                              embed_fn=port.model.embed_tokens, max_new_tokens=12)
    jx = jg.greedy_generate(apply_fn, jnp.asarray(prompt), jcfg, embed_fn=lambda t: emb[t],
                            max_new_tokens=12)
    np.testing.assert_array_equal(got["tokens"].numpy()[:len(want)], want)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(jx["tokens"]))
    assert int(got["n_steps"]) == int(jx["n_steps"])
    np.testing.assert_allclose(_np(got["taps"]), np.asarray(jx["taps"]), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam4_tokens_and_taps_match_hf_and_jax(setup, seed):
    """The reference's feat4 harvest (extract_wavlm_vicuna.py:245-264):
    beam-4 generate from prompt embeddings, per-step last-4-layer hidden
    states of the leading beam, summed."""
    hf, cfg, port, _, _, _, jax_beam = setup
    prompt = _prompt(seed, 6, cfg.hidden_size)
    with torch.no_grad():
        out = hf.generate(inputs_embeds=torch.tensor(prompt), max_new_tokens=16, num_beams=4,
                          do_sample=False, min_length=1, top_p=1.0, repetition_penalty=1.0,
                          length_penalty=1.0, temperature=1.0, output_hidden_states=True,
                          return_dict_in_generate=True)
    hf_ids = out.sequences[0].numpy()
    hf_taps = np.stack([torch.stack(s[-4:])[:, 0, 0, :].sum(dim=0).numpy()
                        for s in out.hidden_states[1:]])
    got = _port_beam(port, cfg, prompt, [6], 16)
    jx = {k: np.asarray(v) for k, v in jax_beam(prompt, [6], 16).items()}
    n_tok = int(got["n_tokens"][0])
    hf_core = hf_ids[:-1] if hf_ids[-1] == 2 and len(hf_ids) > n_tok else hf_ids
    np.testing.assert_array_equal(got["tokens"][0, :len(hf_core)], hf_core)
    n = min(int(got["n_steps"][0]), len(hf_taps))
    np.testing.assert_allclose(got["taps"][0, :n], hf_taps[:n], **HF_TOL)
    for key in ("tokens", "n_tokens", "n_steps"):
        np.testing.assert_array_equal(got[key], jx[key])
    np.testing.assert_allclose(got["taps"], jx["taps"], **TOL)
    np.testing.assert_allclose(got["score"], jx["score"], **TOL)


@pytest.mark.parametrize("seed,bucket", [(0, 16), (1, 32), (2, 16)])
def test_bucketed_prompt_matches_exact_length(setup, seed, bucket):
    """A prompt left-padded to its bucket (pad slots masked, their rope
    positions clamped to 0) decodes as the exact-length prompt does
    (beam_generate, the single-clip engine, with and without prompt_len)."""
    _, cfg, port, *_ = setup
    P = 6 + seed
    prompt = _prompt(seed, P, cfg.hidden_size)
    padded = np.zeros((1, bucket, cfg.hidden_size), np.float32)
    padded[:, bucket - P:] = prompt
    kw = dict(embed_fn=port.model.embed_tokens, num_beams=4, max_new_tokens=12, eos_id=2)
    with torch.inference_mode():
        exact = beam_generate(port, torch.from_numpy(prompt), cfg, **kw)
        bucketed = beam_generate(port, torch.from_numpy(padded), cfg, prompt_len=P, **kw)
    for key in ("tokens", "n_tokens", "n_steps"):
        assert torch.equal(exact[key], bucketed[key]), key
    np.testing.assert_allclose(_np(exact["taps"]), _np(bucketed["taps"]), **TOL)


def _chunk(cfg, lens=(6, 9, 11), bucket=16, seed=10):
    """Clips of the given lengths, left-padded into one bucket, and each
    clip's exact-length prompt."""
    padded = np.zeros((len(lens), bucket, cfg.hidden_size), np.float32)
    solo = []
    for i, P in enumerate(lens):
        solo.append(_prompt(seed + i, P, cfg.hidden_size))
        padded[i, bucket - P:] = solo[-1][0]
    return padded, solo, list(lens)


def test_batched_chunk_matches_solo_runs_and_jax(sharp):
    """A chunk of 3 clips of different lengths in one bucket, ending at
    different steps: each clip's tokens and taps equal its solo run, and the
    chunk equals JAX's batched decode."""
    _, cfg, port, _, _, _, jax_beam = sharp
    padded, solo_prompts, lens = _chunk(cfg)
    batched = _port_beam(port, cfg, padded, lens, 16, eos=EOS_EARLY)
    assert len(set(batched["n_steps"].tolist())) > 1, batched["n_steps"]
    for i, P in enumerate(lens):
        solo = _port_beam(port, cfg, solo_prompts[i], [P], 16, eos=EOS_EARLY)
        for key in ("tokens", "n_tokens", "n_steps"):
            np.testing.assert_array_equal(batched[key][i], solo[key][0], err_msg=f"clip {i}")
        np.testing.assert_allclose(batched["taps"][i], solo["taps"][0], **TOL)
    jx = {k: np.asarray(v) for k, v in jax_beam(padded, lens, 16, EOS_EARLY).items()}
    for key in ("tokens", "n_tokens", "n_steps"):
        np.testing.assert_array_equal(batched[key], jx[key])
    np.testing.assert_allclose(batched["taps"], jx["taps"], **TOL)


@pytest.mark.parametrize("every", [3, 8])
def test_done_checked_every_n_steps_matches_every_step(sharp, every):
    """Reading ``done`` on the host every N steps gives exactly the results
    of reading it every step, with clips that end early and late."""
    _, cfg, port, *_ = sharp
    padded, _, lens = _chunk(cfg)
    ref = _port_beam(port, cfg, padded, lens, 16, eos=EOS_EARLY, check_every=1)
    got = _port_beam(port, cfg, padded, lens, 16, eos=EOS_EARLY, check_every=every)
    assert ref["n_steps"].min() < 16
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_projector_matches_jax():
    """k = 5 frames stacked (remainder dropped), Linear-ReLU-Linear."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 23, 16)).astype(np.float32)
    jp = JaxProjector(k=5, encoder_dim=16, hidden_dim=32, llm_dim=24)
    params = jp.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    proj = EncoderProjectorConcat(5, 16, 32, 24).eval()
    proj.load_state_dict(projector_state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = proj(torch.from_numpy(x))
    want = jp.apply({"params": params}, jnp.asarray(x))
    assert got.shape == (2, 4, 24)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------- tokenizer

PIECES_TEXT = DEFAULT_PROMPT + "speech to é"


def _vocab():
    """A small LLaMA-style vocabulary covering PIECES_TEXT: specials, byte
    pieces for 'é', every character, and each word's prefixes built left to
    right (merge ranks in that order)."""
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, "<0xC3>": 3, "<0xA9>": 4}
    words = (SPACE + PIECES_TEXT.replace(" ", SPACE)).replace("é", "").split(SPACE)
    for ch in sorted(set("".join(words) + SPACE)):
        vocab.setdefault(ch, len(vocab))
    merges = []
    for w in [SPACE + w for w in words if w]:
        for n in range(2, min(len(w), 5) + 1):
            if w[:n] not in vocab:
                vocab[w[:n]] = len(vocab)
                merges.append((w[:n - 1], w[n - 1]))
    return vocab, merges


def write_tokenizer_json(path, style="legacy"):
    """tokenizer.json (HF fast format, BPE with byte fallback) and
    tokenizer_config.json in ``path``: "legacy" = the Prepend / Replace
    normalizer of LLaMA's original files, "metaspace" = the Metaspace
    pre-tokenizer of newer ones."""
    vocab, merges = _vocab()
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for t, i in (("<unk>", 0), ("<s>", 1), ("</s>", 2))],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": SPACE},
            {"type": "Replace", "pattern": {"String": " "}, "content": SPACE}]},
        "pre_tokenizer": None,
        "post_processor": None, "decoder": None,
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]},
    }
    if style == "metaspace":
        spec["normalizer"] = None
        spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": SPACE,
                                 "prepend_scheme": "first", "split": False}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "LlamaTokenizerFast", "add_bos_token": True,
                   "add_eos_token": False, "bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>", "legacy": style == "legacy"}, f)
    return vocab


def write_tokenizer_model(path):
    """tokenizer.model (SentencePiece BPE, LLaMA's normalizer flags) of the
    same vocabulary, scores falling with the merge rank, written with
    transformers' bundled sentencepiece_model_pb2."""
    from transformers.utils import sentencepiece_model_pb2_new as pb

    vocab, merges = _vocab()
    rank = {a + b: r for r, (a, b) in enumerate(merges)}
    m = pb.ModelProto()
    for piece, i in sorted(vocab.items(), key=lambda kv: kv[1]):
        p = m.pieces.add()
        p.piece = piece
        p.score = -float(rank.get(piece, 1000 + i))
        p.type = (2 if piece == "<unk>" else 3 if piece in ("<s>", "</s>")
                  else 6 if piece.startswith("<0x") else 1)
    m.trainer_spec.model_type = 2
    m.trainer_spec.byte_fallback = True
    m.trainer_spec.unk_id, m.trainer_spec.bos_id, m.trainer_spec.eos_id = 0, 1, 2
    m.trainer_spec.pad_id = -1
    m.normalizer_spec.name = "identity"
    m.normalizer_spec.add_dummy_prefix = True
    m.normalizer_spec.remove_extra_whitespaces = False
    m.normalizer_spec.escape_whitespaces = True
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.model"), "wb") as f:
        f.write(m.SerializeToString())
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"add_bos_token": True, "bos_token": "<s>", "eos_token": "</s>"}, f)


TEXTS = [DEFAULT_PROMPT, PIECES_TEXT, "to text", "speech  to", " Transcribe"]


@pytest.mark.parametrize("style", ["legacy", "metaspace"])
def test_tokenizer_json_matches_tokenizers_and_auto_tokenizer(tmp_path, style):
    """BOS first, the prompt's trailing space as a trailing '▁', byte
    fallback for 'é': the ids of the tokenizers package and of the
    AutoTokenizer call the JAX package makes."""
    from tokenizers import Tokenizer
    from transformers import AutoTokenizer

    write_tokenizer_json(tmp_path, style)
    ours = LlamaTokenizer.from_dir(str(tmp_path))
    ref = Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    auto = AutoTokenizer.from_pretrained(str(tmp_path))
    for text in TEXTS:
        assert ours.encode(text) == ref.encode(text, add_special_tokens=False).ids, text
        assert ours(text)["input_ids"] == auto(text)["input_ids"], text
    ids = ours(DEFAULT_PROMPT)["input_ids"]
    assert ids[0] == ours.bos_token_id == 1 and ours.eos_token_id == 2
    assert ref.id_to_token(ids[-1]) == SPACE


def test_tokenizer_model_matches_tokenizer_json(tmp_path):
    """A SentencePiece tokenizer.model of the same vocabulary (read by the
    port's protobuf reader) gives the same ids as tokenizer.json."""
    write_tokenizer_json(tmp_path / "json")
    write_tokenizer_model(tmp_path / "sp")
    a = LlamaTokenizer.from_dir(str(tmp_path / "json"))
    b = LlamaTokenizer.from_dir(str(tmp_path / "sp"))
    assert (b.bos_token_id, b.eos_token_id) == (1, 2)
    for text in TEXTS[:3]:
        assert b(text) == a(text), text


def test_port_imports_no_tokenizer_package():
    """The port reads the tokenizer files itself: no source of it imports
    sentencepiece, tokenizers or protobuf."""
    bad = []
    for path in sorted((REPO / "sdumc_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [f"{path.name}: {m}" for m in mods
                    if m.split(".")[0] in ("sentencepiece", "tokenizers", "google")]
    assert bad == []


# ---------------------------------------------------------------- extractor

@pytest.fixture(scope="module")
def jax_stage(tmp_path_factory):
    """A tiny JAX model (scan layout, as the JAX CLI runs it), its projector,
    a tokenizer and 4 clips of WavLM-like features of 3 prompt buckets."""
    tok_dir = tmp_path_factory.mktemp("tok")
    write_tokenizer_json(tok_dir)
    tok = LlamaTokenizer.from_dir(str(tok_dir))
    jcfg = jl.LlamaConfig.tiny(num_layers=2, vocab_size=96, hidden_size=48, intermediate_size=96)
    ids = jnp.zeros((1, 4), jnp.int32)
    params = jl.LlamaForCausalLM(jcfg).init(jax.random.PRNGKey(0), input_ids=ids)["params"]
    rng = np.random.default_rng(6)
    feats = [rng.normal(size=(t, 16)).astype(np.float32) for t in (23, 60, 71, 330)]
    pp = JaxProjector(encoder_dim=16, hidden_dim=2048, llm_dim=48).init(
        jax.random.PRNGKey(1), jnp.asarray(feats[0][None]))["params"]
    return tok, jcfg, params, pp, feats


def _port_extractor(params, pp, tok, cfg, **kw):
    model = LlamaForCausalLM(cfg).eval()
    model.load_state_dict(llama_state_dict_from_flax(params), strict=True)
    proj = EncoderProjectorConcat(5, 16, 2048, 48).eval()
    proj.load_state_dict(projector_state_dict_from_flax(pp))
    return Feat4Extractor(model, proj, tok, **kw)


def test_feat4_extractor_matches_jax_both_layouts(jax_stage):
    """JAX's Feat4Extractor (scan layout, gen_batch 2, buckets 16/32 so one
    clip is over-bucket) against the port's from both param layouts."""
    from sdumc_tpu.convert.hf_llama import stack_scan_layers

    tok, jcfg, params, pp, feats = jax_stage
    kw = dict(num_beams=4, max_new_tokens=8, prompt_buckets=(16, 32), gen_batch=2)
    scfg = jl.LlamaConfig(**{**jcfg.__dict__, "scan_layers": True})
    want = JaxFeat4(None, stack_scan_layers(params), scfg, pp, tok, **kw).extract_many(feats)
    cfg = LlamaConfig.tiny(num_layers=2, vocab_size=96, hidden_size=48, intermediate_size=96)
    for tree in (params, stack_scan_layers(params)):
        got = _port_extractor(tree, pp, tok, cfg, **kw).extract_many(feats)
        for g, w in zip(got, want):
            assert g["taps"].shape == w["taps"].shape and g["n_tokens"] == w["n_tokens"]
            np.testing.assert_array_equal(g["tokens"], w["tokens"])
            np.testing.assert_allclose(g["taps"], w["taps"], **TOL)


@pytest.mark.parametrize("quant,kv_quant", [("int8", None), ("w8a8", None), (None, "int8")])
def test_quantized_decode_matches_jax(jax_stage, quant, kv_quant):
    """int8 / w8a8 weights (JAX's quantize_params tree carried across) and
    the int8 KV cache: tokens equal, taps to 1e-5 of JAX's quantized decode
    (the integer products are exact on both sides)."""
    _, jcfg, params, _, _ = jax_stage
    rng = np.random.default_rng(7)
    pe = (rng.normal(size=(2, 10, jcfg.hidden_size)) * 0.3).astype(np.float32)
    lens = [10, 7]
    qcfg = jl.LlamaConfig(**{**jcfg.__dict__, "quant": quant, "kv_quant": kv_quant})
    qparams = jax_quantize_params(params, mode=quant) if quant else params
    model = jl.LlamaForCausalLM(qcfg)
    emb = qparams["model"]["embed_tokens"]["embedding"]
    want = jax.jit(lambda pe: jg.beam_generate_batched(
        lambda **kw: model.apply({"params": qparams}, **kw), pe, qcfg,
        embed_fn=lambda t: emb[t], prompt_len=jnp.asarray(lens), num_beams=4,
        max_new_tokens=8, eos_id=-1))(jnp.asarray(pe))
    cfg = LlamaConfig.tiny(num_layers=2, vocab_size=96, hidden_size=48, intermediate_size=96,
                           quant=quant, kv_quant=kv_quant)
    port = LlamaForCausalLM(cfg).eval()
    port.load_state_dict(llama_state_dict_from_flax(qparams), strict=True)
    got = _port_beam(port, cfg, pe, lens, 8, eos=-1)
    for key in ("tokens", "n_tokens", "n_steps"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    np.testing.assert_allclose(got["taps"], np.asarray(want["taps"]), **TOL)


def _write_stage_dir(tmp_path, n_clips=3):
    """A tiny HF Vicuna directory (config.json, pytorch_model.bin,
    tokenizer.json, tokenizer_config.json), a projector .pt with the
    released key prefix, and a directory of WavLM-like feature files."""
    hf_cfg, hf = hf_model(seed=11, vocab_size=96, hidden_size=48, intermediate_size=96,
                          num_hidden_layers=2)
    llm = tmp_path / "llm"
    hf.save_pretrained(str(llm), safe_serialization=False)
    write_tokenizer_json(llm)
    torch.manual_seed(12)
    proj = EncoderProjectorConcat(5, 16, 32, 48)
    torch.save({"encoder_projector." + k: v for k, v in proj.state_dict().items()},
               str(tmp_path / "proj.pt"))
    feats = tmp_path / "wavlm"
    feats.mkdir()
    rng = np.random.default_rng(13)
    for i, t in enumerate((31, 80, 400)[:n_clips]):
        np.save(feats / f"clip_{i}.npy", rng.normal(size=(t, 16)).astype(np.float32))
    return llm, tmp_path / "proj.pt", feats


def test_cli_extract_feat4_on_cpu(tmp_path):
    """``cli.extract feat4 --device cpu`` writes [n_steps, D] f32 taps per
    clip, equal to Feat4Extractor on the loaded parts; a second run skips
    every saved clip; --quant w8a8 --kv_quant int8 runs; without --device
    cpu (no card here) it raises, and --tp 2 with --quant is a usage error."""
    from sdumc_tpu_torch.cli import extract
    from sdumc_tpu_torch.convert.hf_llama import load_hf_llama
    from sdumc_tpu_torch.extract.projector import load_projector

    llm, proj, feats = _write_stage_dir(tmp_path)
    out = tmp_path / "out"
    argv = ["feat4", "--llm_dir", str(llm), "--projector_path", str(proj), "--wavlm_dir",
            str(feats), "--save_dir", str(out), "--max_new_tokens", "6", "--device", "cpu"]
    summary = extract.main(argv)
    assert summary["clips"] == 3
    _, model = load_hf_llama(str(llm))
    ex = Feat4Extractor(model, load_projector(str(proj)), LlamaTokenizer.from_dir(str(llm)),
                        max_new_tokens=6, gen_batch=4)
    for i in range(3):
        got = np.load(out / f"clip_{i}.npy")
        want = ex(np.load(feats / f"clip_{i}.npy"))["taps"]
        assert got.dtype == np.float32 and got.shape == want.shape and got.shape[1] == 48
        assert 1 <= got.shape[0] <= 6 and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
    assert extract.main(argv)["clips"] == 0
    quant = extract.main(argv[:-2] + ["--device", "cpu", "--save_dir", str(tmp_path / "q"),
                                      "--quant", "w8a8", "--kv_quant", "int8"])
    assert quant["clips"] == 3
    for i in range(3):
        got = np.load(tmp_path / "q" / f"clip_{i}.npy")
        assert got.shape[1] == 48 and np.isfinite(got).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            extract.main(argv[:-2])
    with pytest.raises(SystemExit):
        extract.main(argv + ["--tp", "2", "--quant", "int8"])
