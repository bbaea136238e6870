"""The port's other text families (BERT / RoBERTa, ALBERT, DeBERTa v1,
BLOOM, GLM in both lineages) against the JAX package on the CPU, at tiny
f32 configs, the same weights on both sides.

Each family's weights come from a tiny random HF model (transformers, as
JAX's own tests build them, every tensor perturbed so that no LayerNorm
sits at 1 / 0); JAX's converter makes its params, and
``{family}_state_dict_from_flax`` carries those into the port. Then:

* models: every hidden state of a batch whose rows have lengths equal to
  the bucket, below it and 0 (a padded tail row), all positions compared;
* loaders: the port's ``load_hf_*`` on the saved directory gives, tensor
  for tensor, what JAX's loader gives (exactly), and the same features;
  the chatglm2 raw ``pytorch_model.bin`` directory, an HF-native GLM
  directory, a published-style BERT checkpoint (``bert.`` prefix, TF-era
  ``LayerNorm.gamma`` / ``beta``, an MLM head) and a DeBERTa-v2 directory
  (JAX loads it with random attention weights; the port refuses it).

Tolerance: rtol 1e-4, atol 1e-5 (JAX's own family tests'); XLA and torch
sum in other orders. JAX runs eagerly under
``jax.default_matmul_precision("highest")``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.convert import hf_albert as j_albert
from sdumc_tpu.convert import hf_bert as j_bert
from sdumc_tpu.convert import hf_bloom as j_bloom
from sdumc_tpu.convert import hf_deberta as j_deberta
from sdumc_tpu.convert import hf_glm as j_glm
from sdumc_tpu.models import albert as jm_albert
from sdumc_tpu.models import bert as jm_bert
from sdumc_tpu.models import bloom as jm_bloom
from sdumc_tpu.models import deberta as jm_deberta
from sdumc_tpu.models import glm as jm_glm
from sdumc_tpu_torch.convert import from_flax
from sdumc_tpu_torch.convert import hf_albert, hf_bert, hf_bloom, hf_deberta, hf_glm
from sdumc_tpu_torch.models import albert, bert, bloom, deberta, glm

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
LENGTHS = (8, 5, 1, 0)           # equal to the bucket, below it, one token, a padded tail row


def _perturb(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return model.eval()


def _hf(kind, seed=0, **kw):
    """A tiny random HF model of ``kind`` and its config."""
    import transformers as tf

    if kind in ("bert", "roberta"):
        cls_cfg, cls = ((tf.BertConfig, tf.BertModel) if kind == "bert"
                        else (tf.RobertaConfig, tf.RobertaModel))
        base = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=64, max_position_embeddings=66)
        if kind == "roberta":
            base["pad_token_id"] = 1
    elif kind == "albert":
        cls_cfg, cls = tf.AlbertConfig, tf.AlbertModel
        base = dict(vocab_size=99, embedding_size=16, hidden_size=32, num_hidden_layers=3,
                    num_attention_heads=4, intermediate_size=64, max_position_embeddings=64)
    elif kind == "deberta":
        cls_cfg, cls = tf.DebertaConfig, tf.DebertaModel
        base = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=64, max_position_embeddings=32, relative_attention=True,
                    max_relative_positions=8, position_biased_input=False,
                    pos_att_type=["c2p", "p2c"], type_vocab_size=0)
    elif kind == "bloom":
        cls_cfg, cls = tf.BloomConfig, tf.BloomModel
        base = dict(vocab_size=96, hidden_size=32, n_layer=2, n_head=4)
    elif kind == "glm":
        cls_cfg, cls = tf.GlmConfig, tf.GlmModel
        base = dict(vocab_size=97, hidden_size=48, intermediate_size=80, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2, head_dim=12,
                    partial_rotary_factor=0.5, pad_token_id=0)
    else:
        raise ValueError(kind)
    base.update(kw)
    hf_cfg = cls_cfg(attn_implementation="eager", **base)
    torch.manual_seed(seed)
    return _perturb(cls(hf_cfg), seed), hf_cfg


# family -> (JAX converter module, JAX model class, port model class, from_flax name)
FAMILIES = {
    "bert": (j_bert, jm_bert.BertModel, bert.BertModel, "bert"),
    "roberta": (j_bert, jm_bert.BertModel, bert.BertModel, "bert"),
    "albert": (j_albert, jm_albert.AlbertModel, albert.AlbertModel, "albert"),
    "deberta": (j_deberta, jm_deberta.DebertaModel, deberta.DebertaModel, "deberta"),
    "bloom": (j_bloom, jm_bloom.BloomModel, bloom.BloomModel, "bloom"),
    "glm": (j_glm, jm_glm.GlmModel, glm.GlmModel, "glm"),
}
PORT_CONFIG = {"bert": hf_bert.config_from_hf, "roberta": hf_bert.config_from_hf,
               "albert": hf_albert.config_from_hf, "deberta": hf_deberta.config_from_hf,
               "bloom": hf_bloom.config_from_hf, "glm": hf_glm.config_from_hf}
PORT_LOADER = {"bert": hf_bert.load_hf_bert, "roberta": hf_bert.load_hf_bert,
               "albert": hf_albert.load_hf_albert, "deberta": hf_deberta.load_hf_deberta,
               "bloom": hf_bloom.load_hf_bloom, "glm": hf_glm.load_hf_glm}
JAX_LOADER = {"bert": j_bert.load_hf_bert, "roberta": j_bert.load_hf_bert,
              "albert": j_albert.load_hf_albert, "deberta": j_deberta.load_hf_deberta,
              "bloom": j_bloom.load_hf_bloom, "glm": j_glm.load_hf_glm}

# (case id, family, HF overrides, sequence length)
CASES = [
    ("bert", "bert", {}, 8),
    ("roberta", "roberta", {}, 8),                        # position offset pad_token_id + 1
    ("albert", "albert", {}, 8),
    ("deberta", "deberta", {}, 12),                       # the released layout; span 8 < T
    ("deberta_biased", "deberta", dict(position_biased_input=True, type_vocab_size=2), 12),
    ("bloom", "bloom", {}, 8),
    ("bloom_6_heads", "bloom", dict(hidden_size=36, n_head=6), 8),   # ALiBi, 6 not a power of 2
    ("glm", "glm", {}, 8),                                # GQA: 4 query heads, 2 kv heads
]


def jax_side(family, hf, hf_cfg):
    conv, jcls = FAMILIES[family][:2]
    cfg = conv.config_from_hf(hf_cfg)
    sd = hf.state_dict()
    params = conv.hf_glm_to_params(sd, cfg) if family == "glm" else getattr(
        conv, f"hf_{FAMILIES[family][3]}_to_params")(sd)
    return jcls(cfg), params


def port_from_flax(family, hf_cfg, params):
    model = FAMILIES[family][2](PORT_CONFIG[family](hf_cfg.to_dict()))
    model.load_state_dict(from_flax.text_state_dict_from_flax(FAMILIES[family][3], params),
                          strict=True)
    return model.eval()


def batch(vocab, T, lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), T), np.int64)
    for j, n in enumerate(lengths):
        ids[j, :min(n, T)] = rng.integers(3, vocab, size=min(n, T))
    mask = np.arange(T)[None, :] < np.minimum(np.array(lengths), T)[:, None]
    return ids, mask


def jax_hidden(jmodel, params, ids, mask):
    with jax.default_matmul_precision("highest"):
        out = jmodel.apply({"params": params}, jnp.asarray(ids), pad_mask=jnp.asarray(mask),
                           output_hidden_states=True)
    return [np.asarray(h) for h in out["hidden_states"]]


def port_hidden(model, ids, mask):
    with torch.no_grad():
        out = model(torch.from_numpy(ids), pad_mask=torch.from_numpy(mask),
                    output_hidden_states=True)
    return [h.numpy() for h in out["hidden_states"]]


def assert_hidden(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"hidden state {i}")


@pytest.mark.parametrize("case,family,overrides,T", CASES, ids=[c[0] for c in CASES])
def test_family_matches_jax(case, family, overrides, T):
    hf, hf_cfg = _hf(family, seed=len(case), **overrides)
    jmodel, params = jax_side(family, hf, hf_cfg)
    model = port_from_flax(family, hf_cfg, params)
    ids, mask = batch(hf_cfg.vocab_size, T)
    ids[1, 4] = 1                                   # a pad-like id inside a row
    assert_hidden(port_hidden(model, ids, mask), jax_hidden(jmodel, params, ids, mask))


def test_roberta_offsets_positions_by_pad_plus_one():
    _, hf_cfg = _hf("roberta")
    assert hf_bert.config_from_hf(hf_cfg.to_dict()).position_offset == 2
    assert hf_bert.config_from_hf({"model_type": "bert"}).position_offset == 0


def test_alibi_slopes_equal_jax():
    for heads in (4, 6, 12, 32, 112):
        np.testing.assert_array_equal(bloom.alibi_slopes(heads).numpy(),
                                      np.asarray(jm_bloom.alibi_slopes(heads)))
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0]], bool)
    np.testing.assert_array_equal(bloom.build_alibi(torch.from_numpy(mask), 6).numpy(),
                                  np.asarray(jm_bloom.build_alibi(jnp.asarray(mask), 6)))


def test_albert_holds_its_shared_layer_once():
    hf, hf_cfg = _hf("albert")
    model = hf_albert.config_from_hf(hf_cfg.to_dict())
    sd = albert.AlbertModel(model).state_dict()
    layer_keys = [k for k in sd if ".albert_layers." in k]
    assert len(layer_keys) == 16                    # one layer's tensors for 3 applications
    _, params = jax_side("albert", hf, hf_cfg)
    assert len(jax.tree_util.tree_leaves(params["layer"])) == len(layer_keys)
    with pytest.raises(NotImplementedError, match="num_hidden_groups"):
        hf_albert.config_from_hf({**hf_cfg.to_dict(), "num_hidden_groups": 2})


# ---------------------------------------------------------------- loaders

def _save(hf, path, **kw):
    hf.save_pretrained(str(path), safe_serialization=kw.get("safe", False))
    return str(path)


def _assert_same_tensors(port_sd, want_sd):
    assert sorted(port_sd) == sorted(want_sd)
    for k in want_sd:
        assert port_sd[k].dtype == torch.float32, k
        assert torch.equal(port_sd[k], want_sd[k]), k


@pytest.mark.parametrize("case,family,overrides,T", CASES, ids=[c[0] for c in CASES])
def test_loader_matches_jax_loader(tmp_path, case, family, overrides, T):
    """The port's loader and JAX's load the same directory to the same
    tensors; bf16 weights (as the published LLMs ship) are widened to f32
    by both. Safetensors for the BERT family, torch .bin otherwise."""
    hf, hf_cfg = _hf(family, seed=len(case) + 7, **overrides)
    if family in ("bloom", "glm"):
        hf = hf.to(torch.bfloat16)
    path = _save(hf, tmp_path / case, safe=family in ("bert", "roberta"))
    cfg, model = PORT_LOADER[family](path)
    jcfg, params = JAX_LOADER[family](path)
    _assert_same_tensors(model.state_dict(),
                         from_flax.text_state_dict_from_flax(FAMILIES[family][3], params))
    assert cfg.num_layers == jcfg.num_layers and cfg.hidden_size == jcfg.hidden_size
    ids, mask = batch(cfg.vocab_size, T, seed=1)
    assert_hidden(port_hidden(model, ids, mask),
                  jax_hidden(FAMILIES[family][1](jcfg), params, ids, mask))


def test_published_bert_layout_loads(tmp_path):
    """A checkpoint as bert-base-uncased ships it: the encoder under
    ``bert.``, TF-era ``LayerNorm.gamma`` / ``beta``, a position-id buffer,
    the pooler and an MLM head; the port keeps the encoder's tensors."""
    hf, hf_cfg = _hf("bert", seed=3)
    sd = {}
    for k, v in hf.state_dict().items():
        if k.endswith("LayerNorm.weight"):
            k = k[:-len("weight")] + "gamma"
        elif k.endswith("LayerNorm.bias"):
            k = k[:-len("bias")] + "beta"
        sd["bert." + k] = v
    sd["bert.embeddings.position_ids"] = torch.arange(66)[None]
    sd["cls.predictions.bias"] = torch.zeros(99)
    tmp_path.joinpath("config.json").write_text(json.dumps(hf_cfg.to_dict()))
    torch.save(sd, tmp_path / "pytorch_model.bin")
    _, model = hf_bert.load_hf_bert(str(tmp_path))
    want = {k: v for k, v in hf.state_dict().items() if not k.startswith("pooler.")
            and not k.endswith(("position_ids", "token_type_ids"))}
    _assert_same_tensors(model.state_dict(), want)


def chatglm_dir(path, seed=5, H=48, NH=4, KV=2, HD=12, FFN=80, L=2, V=97, dtype=torch.float32):
    """A THUDM chatglm2-layout directory (config.json with model_type
    chatglm, a raw pytorch_model.bin with fused QKV and gate|up, the lm
    head and a rotary buffer), as JAX's test writes one."""
    raw_cfg = {"model_type": "chatglm", "hidden_size": H, "ffn_hidden_size": FFN,
               "num_layers": L, "num_attention_heads": NH, "kv_channels": HD,
               "multi_query_attention": True, "multi_query_group_num": KV,
               "padded_vocab_size": V, "layernorm_epsilon": 1e-5, "add_qkv_bias": True,
               "rope_ratio": 1.0}
    gen = torch.Generator().manual_seed(seed)
    q_sz, kv_sz = NH * HD, KV * HD

    def r(*shape, scale=0.1):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype)

    sd = {"transformer.embedding.word_embeddings.weight": r(V, H, scale=1.0),
          "transformer.encoder.final_layernorm.weight": 1 + r(H),
          "transformer.output_layer.weight": r(V, H),
          "transformer.rotary_pos_emb.inv_freq": r(HD // 4)}
    for i in range(L):
        pre = f"transformer.encoder.layers.{i}."
        sd[pre + "self_attention.query_key_value.weight"] = r(q_sz + 2 * kv_sz, H)
        sd[pre + "self_attention.query_key_value.bias"] = r(q_sz + 2 * kv_sz)
        sd[pre + "self_attention.dense.weight"] = r(H, q_sz)
        sd[pre + "mlp.dense_h_to_4h.weight"] = r(2 * FFN, H)
        sd[pre + "mlp.dense_4h_to_h.weight"] = r(H, FFN)
        sd[pre + "input_layernorm.weight"] = 1 + r(H)
        sd[pre + "post_attention_layernorm.weight"] = 1 + r(H)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(raw_cfg))
    torch.save(sd, str(path / "pytorch_model.bin"))
    return str(path)


def test_chatglm2_raw_directory_matches_jax(tmp_path):
    """The chatglm2 branch: config from chatglm's fields, the fused QKV and
    gate|up split as JAX splits them, lm head and buffers dropped."""
    path = chatglm_dir(tmp_path / "chatglm2-6b")
    cfg, model = hf_glm.load_hf_glm(path)
    jcfg, params = j_glm.load_hf_glm(path)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.intermediate_size,
            cfg.vocab_size) == (4, 2, 12, 80, 97)
    assert dataclass_fields(cfg) == {k: getattr(jcfg, k) for k in dataclass_fields(cfg)}
    _assert_same_tensors(model.state_dict(), from_flax.glm_state_dict_from_flax(params))
    ids, mask = batch(cfg.vocab_size, 8, seed=2)
    assert_hidden(port_hidden(model, ids, mask),
                  jax_hidden(jm_glm.GlmModel(jcfg), params, ids, mask))


def dataclass_fields(cfg):
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_hf_native_glm_safetensors_directory(tmp_path):
    """An HF-native GlmForCausalLM directory in safetensors: ``model.``
    stripped, ``lm_head`` dropped, the same tensors as JAX's loader."""
    import transformers as tf

    _, hf_cfg = _hf("glm", seed=9)
    torch.manual_seed(9)
    lm = _perturb(tf.GlmForCausalLM(hf_cfg), 9)
    path = _save(lm, tmp_path / "glm", safe=True)
    cfg, model = hf_glm.load_hf_glm(path)
    jcfg, params = j_glm.load_hf_glm(path)
    assert cfg.rotary_dim == jcfg.rotary_dim == 6
    _assert_same_tensors(model.state_dict(), from_flax.glm_state_dict_from_flax(params))


def test_deberta_v2_directory_jax_loads_with_missing_keys_port_refuses(tmp_path):
    """A tiny DeBERTa-v2 directory (model_type deberta-v2, the architecture
    of microsoft/deberta-v3-large): JAX's loader (transformers.DebertaModel,
    v1) loads it, reporting missing and unexpected keys but no error, so
    its attention weights are random; the port's loader raises. (With
    v3's relative-position buckets the table's size differs from v1's and
    transformers raises instead.)"""
    import transformers as tf

    base = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, max_position_embeddings=32, relative_attention=True,
                max_relative_positions=8, pos_att_type=["p2c", "c2p"],
                norm_rel_ebd="layer_norm", position_biased_input=False)
    torch.manual_seed(0)
    path = _save(tf.DebertaV2Model(tf.DebertaV2Config(**base)), tmp_path / "v2")
    _, info = tf.DebertaModel.from_pretrained(path, output_loading_info=True)
    assert any("in_proj" in k for k in info["missing_keys"])
    assert any("query_proj" in k for k in info["unexpected_keys"])
    jcfg, params = j_deberta.load_hf_deberta(path)         # no error
    assert "in_proj" in params["layers_0"]["self_attn"]
    with pytest.raises(ValueError, match="deberta-v2"):
        hf_deberta.load_hf_deberta(path)
    bucketed = _save(tf.DebertaV2Model(tf.DebertaV2Config(position_buckets=4, **base)),
                     tmp_path / "v3")
    with pytest.raises(RuntimeError, match="size mismatch"):
        j_deberta.load_hf_deberta(bucketed)
    with pytest.raises(ValueError, match="deberta-v2"):
        hf_deberta.load_hf_deberta(bucketed)


def test_deberta_pos_att_type_string():
    assert hf_deberta.config_from_hf({"pos_att_type": "c2p|p2c"}).pos_att_type == ("c2p", "p2c")
    cfg = hf_deberta.config_from_hf({"max_relative_positions": -1,
                                     "max_position_embeddings": 512})
    assert cfg.max_relative_positions == 512


# ---------------------------------------------------------------- the text stage

SENTENCES = ["today is a good day", "the movie was really not bad", "", "a",
             "The café was très bon, wasn't it?", "i paid for tickets and it was good",
             "today the movie was really not bad and it was a good day for tickets and emoji "
             "here so the full width words were fine",          # overlong for buckets (4, 8, 16)
             "naïve façade", "日本語と中文", "we're mixed case words", float("nan"), "fine"]
BUCKETS = (4, 8, 16)
FEAT_TOL = dict(rtol=1e-4, atol=2e-5)


def _tok_size(path):
    from sdumc_tpu_torch.convert.vocab_tokenizers import load_tokenizer

    return 1 + max(load_tokenizer(str(path)).tokens)


def stage_dir(tmp, name):
    """A tiny model directory of family ``name`` with its tokenizer files
    (tests/test_torch_tokenizers.py's writers); returns (path, --family)."""
    import tests.test_torch_tokenizers as T

    path = tmp / name
    if name == "chatglm2":
        n = T.write_chatglm_model(path)
        chatglm_dir(path, V=n + 5)               # ids up to eop, n + 4
        return str(path), "glm"
    writers = {"bert": lambda p: T.write_bert_vocab(p, T.BERT_CONFIGS["uncased"]),
               "roberta": lambda p: T.write_byte_bpe(p, "roberta"),
               "deberta": lambda p: T.write_byte_bpe(p, "deberta"),
               "bloom": T.write_bloom_json, "glm4": T.write_glm4_json}
    if name == "albert":
        T.write_albert_spiece(tmp / "albert_sp")
        T._as_json_dir(T.albert_oracle(str(tmp / "albert_sp")), path)
        T._write(path, "tokenizer_config.json", {"tokenizer_class": "AlbertTokenizerFast"})
    else:
        writers[name](path)
    tok_files = {f: (path / f).read_bytes() for f in os.listdir(path)}
    vocab = _tok_size(path)
    kind = {"glm4": "glm"}.get(name, name)
    extra = dict(max_position_embeddings=130) if kind in ("bert", "roberta", "albert") else {}
    hf, _ = _hf(kind, seed=11, vocab_size=vocab, **extra)
    if kind == "glm":
        import transformers as tf

        torch.manual_seed(11)
        hf = _perturb(tf.GlmForCausalLM(hf.config), 11)
    hf.save_pretrained(str(path), safe_serialization=kind in ("bert", "glm"))
    for f, data in tok_files.items():
        if f != "config.json":
            (path / f).write_bytes(data)
    return str(path), {"roberta": "bert", "glm4": "glm"}.get(kind, kind)


STAGE_DIRS = ("bert", "roberta", "albert", "deberta", "bloom", "glm4", "chatglm2")


@pytest.fixture(scope="module")
def stage_dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stage")
    return {name: stage_dir(tmp, name) for name in STAGE_DIRS}


def _write_csv(path, sentences):
    import csv

    rows = [(f"clip_{i}", s if isinstance(s, str) else "") for i, s in enumerate(sentences)]
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["name", "sentence"])
        w.writerows(rows)
    return rows


@pytest.mark.parametrize("name", STAGE_DIRS)
def test_cli_extract_text_matches_jax(stage_dirs, tmp_path, name):
    """``cli.extract text --family F --device cpu`` with its defaults (FRAME,
    taps -4..-1, batch 16) writes what JAX's ``main`` writes for the same
    directory and transcripts. chatglm2: JAX's main cannot load its
    tokenizer (AutoTokenizer needs trust_remote_code), so JAX's
    ``extract_text_features`` runs its own model on the port's tokenizer."""
    from sdumc_tpu.extract import text as jtext
    from sdumc_tpu_torch.cli import extract
    from sdumc_tpu_torch.convert.vocab_tokenizers import load_tokenizer

    path, family = stage_dirs[name]
    rows = _write_csv(tmp_path / "trans.csv", SENTENCES)
    common = ["--model_dir", path, "--trans_path", str(tmp_path / "trans.csv"),
              "--family", family]
    out = extract.main(["text"] + common + ["--save_dir", str(tmp_path / "port"),
                                            "--device", "cpu"])
    assert out["rows"] == len(rows)
    if name == "chatglm2":
        jcfg, params = j_glm.load_hf_glm(path)
        want = jtext.extract_text_features(jm_glm.GlmModel(jcfg), params, load_tokenizer(path),
                                           [s for _, s in rows])
        os.makedirs(tmp_path / "jax")
        for (n, _), feat in zip(rows, want):
            np.save(tmp_path / "jax" / f"{n}.npy", feat)
    else:
        jtext.main(common + ["--save_dir", str(tmp_path / "jax")])
    for n, s in rows:
        got, ref = (np.load(tmp_path / d / f"{n}.npy") for d in ("port", "jax"))
        assert got.dtype == np.float32 and got.shape == ref.shape, (n, s)
        np.testing.assert_allclose(got, ref, **FEAT_TOL, err_msg=f"{name} {n} {s!r}")
        if not s.strip():
            assert got.shape == (1, ref.shape[1]) and not got.any()


@pytest.mark.parametrize("name", STAGE_DIRS)
def test_extract_text_features_matches_jax(stage_dirs, name):
    """extract_text_features at UTTERANCE and FRAME with buckets 4 / 8 / 16
    (an overlong row at its exact length), batches of 3 (dummy rows of
    length 0 in short chunks), taps (-2, -1), an empty and a NaN
    transcript; the probe's span equal to JAX's (chatglm2: the spec's
    (2, 0), on the port's tokenizer)."""
    from transformers import AutoTokenizer

    from sdumc_tpu.extract import text as jtext
    from sdumc_tpu_torch.convert.vocab_tokenizers import load_tokenizer
    from sdumc_tpu_torch.extract import text as ptext

    path, family = stage_dirs[name]
    ours = load_tokenizer(path)
    auto = ours if name == "chatglm2" else AutoTokenizer.from_pretrained(path)
    assert ptext.find_token_span(ours) == jtext.find_token_span(auto)
    _, model = PORT_LOADER[family](path)
    jcfg, params = JAX_LOADER[family](path)
    jmodel = FAMILIES[family][1](jcfg)
    for level in ("UTTERANCE", "FRAME"):
        kw = dict(layer_ids=(-2, -1), feature_level=level, buckets=BUCKETS, batch_size=3)
        got = ptext.extract_text_features(model, ours, SENTENCES, **kw)
        want = jtext.extract_text_features(jmodel, params, auto, SENTENCES, **kw)
        for g, w, s in zip(got, want, SENTENCES):
            assert g.shape == w.shape, (level, s)
            np.testing.assert_allclose(g, w, **FEAT_TOL, err_msg=f"{name} {level} {s!r}")
