"""The port's tokenizer readers (``convert/hf_tokenizer.py``,
``convert/vocab_tokenizers.py``) against ``tokenizers`` and transformers
on hand-written files, on the CPU.

Each family's files are written here from one word list: BERT's
``vocab.txt`` (cased, uncased, Chinese), byte-level BPE ``vocab.json`` +
``merges.txt`` (RoBERTa, DeBERTa v1), ALBERT's ``spiece.model``
(SentencePiece Unigram with a small ``precompiled_charsmap``), BLOOM's and
GLM-4's ``tokenizer.json``, chatglm2's ``tokenizer.model``. The oracles:
``AutoTokenizer`` on the directory (what JAX's text stage calls), the
``tokenizers`` package on the ``tokenizer.json`` the converter makes, and
for ALBERT (no ``sentencepiece`` here) transformers' ``AlbertConverter``
run on the file. Ids must be equal, ``decode`` equal to ``tokenizers``'
(special tokens kept), and ``find_token_span`` equal to JAX's probe.
chatglm2's reader is held to its spec (THUDM's ``tokenization_chatglm.py``
for chatglm2-6b): ``[gMASK]``, ``sop`` numbered after the pieces and
prefixed.

The regex translation is held to ``tokenizers``' Oniguruma by
``hypothesis`` over assigned code points of chosen blocks (Latin with
combining marks, CJK, kana, Arabic, Devanagari, digits such as ² and Ⅻ,
emoji, and whitespace runs including ``\\x1c`` and U+3000); outside the
emoji, code points whose category Unicode 3.2 already gave them, since
``tokenizers``' BERT punctuation tables predate Python's Unicode 15.0.
"""

import json
import os
import unicodedata

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from sdumc_tpu.extract import text as jtext
from sdumc_tpu_torch.convert import hf_tokenizer as H
from sdumc_tpu_torch.convert import vocab_tokenizers as V
from sdumc_tpu_torch.convert.llama_tokenizer import SPACE, LlamaTokenizer
from sdumc_tpu_torch.extract import text as ptext

torch.set_num_threads(1)

TEXTS = [
    "today is a good day", "The café was très bon, wasn't it?", "I paid $12.50 for 2 tickets!!",
    "日本語と中文的文本。", "emoji 👍🏽 and ❤️ here", "tabs\tand\nnewlines  and   runs",
    "naïve façade Ångström", "² Ⅻ ½ digits ٣ १२", "  leading and trailing  ",
    "MIXED Case Words", "don't can't we're", "ｆｕｌｌ－ｗｉｄｔｈ and ﬁne…", "a",
]
WORDS = ("today is a good day the cafe café was tres très bon wasn't it i paid for tickets "
         "digits and emoji here tabs newlines runs naive façade angstrom leading trailing "
         "mixed case words don't can't we're full width fine movie really not bad").split()
BLOOM_SPLIT = " ?[^(\\s|[.,!?…。，、।۔،])]+"
GLM4_SPLIT = ("(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}{1,3}| ?[^\\s\\p{L}"
              "\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+")


def _write(path, name, content, mode="w"):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, name), mode, **({} if "b" in mode else {"encoding": "utf-8"})) as f:
        if name.endswith(".json") and not isinstance(content, str):
            json.dump(content, f, ensure_ascii=False)
        else:
            f.write(content)


# ---------------------------------------------------------------- file writers

def write_bert_vocab(path, config, words=WORDS):
    """vocab.txt: the specials, each word (as given and lower-cased), each
    character and its ``##`` continuation, a few suffix pieces."""
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = sorted(set("".join(words) + "".join(TEXTS) + "abcdefghijklmnopqrstuvwxyz"))
    pieces = list(dict.fromkeys(words + [w.lower() for w in words] + [c for c in chars if c.strip()]
                                + ["##" + c for c in chars if c.strip()]
                                + ["##s", "##ing", "##day", "##ed", "to", "##e"]))
    _write(path, "vocab.txt", "\n".join(vocab + pieces) + "\n")
    _write(path, "tokenizer_config.json", {"tokenizer_class": "BertTokenizer", **config})
    _write(path, "config.json", {"model_type": "bert"})


def byte_bpe(words=WORDS, specials=()):
    """A byte-level BPE vocabulary (specials, the 256 byte characters, each
    word and ``Ġ`` + word built up left to right) and its merges."""
    vocab = {t: i for i, t in enumerate(specials)}
    for c in H.BYTE_CHARS.values():
        vocab.setdefault(c, len(vocab))
    merges = []
    for w in dict.fromkeys(words):
        for variant in (w, " " + w):
            b = H._byte_level(variant)
            for n in range(2, len(b) + 1):
                if b[:n] not in vocab:
                    vocab[b[:n]] = len(vocab)
                    merges.append((b[:n - 1], b[n - 1]))
    return vocab, merges


def write_byte_bpe(path, family, config=None):
    """vocab.json + merges.txt (GPT-2's layout) for RoBERTa or DeBERTa v1."""
    specials = (("<s>", "<pad>", "</s>", "<unk>", "<mask>") if family == "roberta"
                else ("[PAD]", "[CLS]", "[SEP]", "[UNK]", "[MASK]"))
    vocab, merges = byte_bpe(specials=specials)
    _write(path, "vocab.json", vocab)
    _write(path, "merges.txt", "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    cls = "RobertaTokenizer" if family == "roberta" else "DebertaTokenizer"
    _write(path, "tokenizer_config.json", {"tokenizer_class": cls, **(config or {})})
    _write(path, "config.json", {"model_type": family})


def write_bloom_json(path):
    """BLOOM's tokenizer.json layout: its Split regex then ByteLevel
    without the regex, byte-level BPE, the ByteLevel post-processor (no
    special tokens) and decoder."""
    specials = ("<unk>", "<s>", "</s>", "<pad>")
    vocab, merges = byte_bpe(specials=specials)
    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": i, "content": t, "single_word": False, "lstrip": False,
                              "rstrip": False, "normalized": False, "special": True}
                             for i, t in enumerate(specials)],
            "normalizer": None,
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": BLOOM_SPLIT}, "behavior": "Isolated",
                 "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                 "use_regex": False}]},
            "post_processor": {"type": "ByteLevel", "add_prefix_space": True,
                               "trim_offsets": False, "use_regex": False},
            "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                        "use_regex": True},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": [[a, b] for a, b in merges]}}
    _write(path, "tokenizer.json", spec)
    _write(path, "tokenizer_config.json", {"tokenizer_class": "BloomTokenizerFast"})
    _write(path, "config.json", {"model_type": "bloom"})


def write_glm4_json(path):
    """GLM-4's tokenizer.json layout (HF-native GLM): its Split regex, then
    ByteLevel without the regex, BPE with ignore_merges, and the
    ``[gMASK] <sop> $A`` template."""
    specials = ("<|endoftext|>", "[MASK]", "[gMASK]", "[sMASK]", "<sop>", "<eop>")
    vocab, merges = byte_bpe()
    n = len(vocab)
    ids = {t: n + i for i, t in enumerate(specials)}
    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": i, "content": t, "single_word": False, "lstrip": False,
                              "rstrip": False, "normalized": False, "special": True}
                             for t, i in ids.items()],
            "normalizer": None,
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": GLM4_SPLIT}, "behavior": "Isolated",
                 "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                 "use_regex": False}]},
            "post_processor": {"type": "TemplateProcessing",
                               "single": [{"SpecialToken": {"id": "[gMASK]", "type_id": 0}},
                                          {"SpecialToken": {"id": "<sop>", "type_id": 0}},
                                          {"Sequence": {"id": "A", "type_id": 0}}],
                               "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                                        {"Sequence": {"id": "B", "type_id": 1}}],
                               "special_tokens": {t: {"id": t, "ids": [ids[t]], "tokens": [t]}
                                                  for t in ("[gMASK]", "<sop>")}},
            "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                        "use_regex": True},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                      "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]}}
    _write(path, "tokenizer.json", spec)
    _write(path, "tokenizer_config.json", {"tokenizer_class": "PreTrainedTokenizerFast"})
    _write(path, "config.json", {"model_type": "glm"})


CHARSMAP = {"ｆ": "f", "ｕ": "u", "ｌ": "l", "－": "-", "ｗ": "w", "ｉ": "i", "ｄ": "d", "ｔ": "t",
            "ｈ": "h", "ﬁ": "fi", "…": "...", "　": " ", "ｅ": "e", "ｅ́": "é",
            " ": " ", "™": "TM"}


def albert_pieces(words=WORDS):
    """ALBERT's pieces (piece, score, type): the specials, '▁', each word
    with '▁', a few digit-comma pieces and every character."""
    pieces = [("<pad>", 0.0, 3), ("<unk>", 0.0, 2), ("[CLS]", 0.0, 3), ("[SEP]", 0.0, 3),
              ("[MASK]", 0.0, 4), (SPACE, -2.0, 1)]
    seen = {p for p, _, _ in pieces}
    score = -3.0
    for w in words + ["12", "12,", "2,", "50", "$", "fine", "..."]:
        for p in (SPACE + w.lower(), w.lower()):
            if p not in seen:
                seen.add(p)
                pieces.append((p, score, 1))
                score -= 0.25
    for c in sorted(set("".join(TEXTS).lower() + "abcdefghijklmnopqrstuvwxyz0123456789")):
        if c.strip() and c not in seen:
            seen.add(c)
            pieces.append((c, score - 5.0, 1))
    return pieces


def write_albert_spiece(path, config=None):
    """spiece.model (SentencePiece Unigram, a precompiled charsmap),
    written with transformers' bundled protobuf module."""
    from transformers.utils import sentencepiece_model_pb2_new as pb

    m = pb.ModelProto()
    for piece, score, kind in albert_pieces():
        p = m.pieces.add()
        p.piece, p.score, p.type = piece, score, kind
    m.trainer_spec.model_type = 1
    m.trainer_spec.unk_id = 1
    m.normalizer_spec.name = "nmt_nfkc"
    m.normalizer_spec.precompiled_charsmap = H.build_precompiled_charsmap(CHARSMAP)
    _write(path, "spiece.model", m.SerializeToString(), "wb")
    _write(path, "tokenizer_config.json", {"tokenizer_class": "AlbertTokenizer", **(config or {})})
    _write(path, "config.json", {"model_type": "albert"})


def albert_oracle(path, config=None):
    """transformers' AlbertConverter run on the spiece.model (what
    AutoTokenizer converts it to where sentencepiece is installed)."""
    from transformers.convert_slow_tokenizer import AlbertConverter

    config = config or {}
    pieces = {p: i for i, (p, _, _) in enumerate(albert_pieces())}

    class Slow:
        vocab_file = os.path.join(path, "spiece.model")
        keep_accents = config.get("keep_accents", False)
        do_lower_case = config.get("do_lower_case", True)

        def convert_tokens_to_ids(self, tok):
            return pieces[tok]

    return AlbertConverter(Slow()).converted()


def write_chatglm_model(path, words=WORDS):
    """chatglm2's tokenizer.model (SentencePiece BPE with byte fallback,
    identity normalizer) and the auto_map its tokenizer_config carries."""
    from transformers.utils import sentencepiece_model_pb2_new as pb

    m = pb.ModelProto()
    specials = [("<unk>", 2), ("<s>", 3), ("</s>", 3)]
    for piece, kind in specials:
        p = m.pieces.add()
        p.piece, p.score, p.type = piece, 0.0, kind
    for b in range(256):
        p = m.pieces.add()
        p.piece, p.score, p.type = f"<0x{b:02X}>", 0.0, 6
    seen, rank = set(), 0
    pieces = [SPACE + w for w in dict.fromkeys(words)]
    for c in sorted(set("".join(pieces))):
        seen.add(c)
        p = m.pieces.add()
        p.piece, p.score, p.type = c, -1000.0, 1
    for w in pieces:
        for n in range(2, len(w) + 1):
            if w[:n] not in seen:
                seen.add(w[:n])
                p = m.pieces.add()
                p.piece, p.score, p.type = w[:n], -float(rank), 1
                rank += 1
    m.trainer_spec.model_type = 2
    m.trainer_spec.byte_fallback = True
    m.trainer_spec.unk_id, m.trainer_spec.bos_id, m.trainer_spec.eos_id = 0, 1, 2
    m.normalizer_spec.name = "identity"
    m.normalizer_spec.add_dummy_prefix = True
    m.normalizer_spec.remove_extra_whitespaces = False
    _write(path, "tokenizer.model", m.SerializeToString(), "wb")
    _write(path, "tokenizer_config.json", {
        "tokenizer_class": "ChatGLMTokenizer",
        "auto_map": {"AutoTokenizer": ["tokenization_chatglm.ChatGLMTokenizer", None]}})
    _write(path, "config.json", {"model_type": "chatglm"})
    return len(m.pieces)


# ---------------------------------------------------------------- families vs the oracles

BERT_CONFIGS = {"uncased": {"do_lower_case": True},
                "cased": {"do_lower_case": False},
                "chinese": {"do_lower_case": True, "tokenize_chinese_chars": True,
                            "strip_accents": False},
                "no_chinese_split": {"do_lower_case": True, "tokenize_chinese_chars": False}}


def _auto(path):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(str(path))


def _check_ids_and_decode(ours, ref_ids, ref_decode, texts=TEXTS):
    for text in texts:
        ids = ours(text)["input_ids"]
        assert ids == ref_ids(text), text
        assert ours.decode(ids) == ref_decode(ids), text


def _as_json_dir(backend, path):
    """The fast tokenizer's tokenizer.json alone in ``path``."""
    _write(path, "tokenizer.json", backend.to_str())
    return str(path)


@pytest.mark.parametrize("name", sorted(BERT_CONFIGS))
def test_bert_vocab_txt_matches_auto_tokenizer(tmp_path, name):
    """vocab.txt through BertTokenizer's settings; then the tokenizer.json
    the converter makes, read by the json path, against ``tokenizers``."""
    write_bert_vocab(tmp_path / "v", BERT_CONFIGS[name])
    auto = _auto(tmp_path / "v")
    ours = V.load_tokenizer(str(tmp_path / "v"))
    backend = auto.backend_tokenizer
    _check_ids_and_decode(ours, lambda t: auto(t)["input_ids"],
                          lambda ids: backend.decode(ids, skip_special_tokens=False))
    json_tok = H.read_tokenizer_json(_as_json_dir(backend, tmp_path / "j"))
    _check_ids_and_decode(json_tok, lambda t: backend.encode(t).ids,
                          lambda ids: backend.decode(ids, skip_special_tokens=False))


def test_bert_tokenizer_json_follows_the_config(tmp_path):
    """BertTokenizerFast resets a tokenizer.json's BertNormalizer to the
    config's do_lower_case; load_tokenizer does the same."""
    write_bert_vocab(tmp_path / "v", {"do_lower_case": True})
    backend = _auto(tmp_path / "v").backend_tokenizer
    path = _as_json_dir(backend, tmp_path / "cased")
    _write(path, "tokenizer_config.json", {"tokenizer_class": "BertTokenizerFast",
                                           "do_lower_case": False})
    auto, ours = _auto(path), V.load_tokenizer(path)
    for text in TEXTS:
        assert ours(text)["input_ids"] == auto(text)["input_ids"], text


@pytest.mark.parametrize("family,config", [("roberta", {}), ("roberta", {"add_prefix_space": True}),
                                          ("deberta", {})])
def test_byte_level_bpe_files_match_auto_tokenizer(tmp_path, family, config):
    """vocab.json + merges.txt as RobertaTokenizer / DebertaTokenizer read
    them (GPT-2's split, the byte map, BPE, <s>/</s> or [CLS]/[SEP])."""
    write_byte_bpe(tmp_path / "v", family, config)
    auto = _auto(tmp_path / "v")
    ours = V.load_tokenizer(str(tmp_path / "v"))
    backend = auto.backend_tokenizer
    _check_ids_and_decode(ours, lambda t: auto(t)["input_ids"],
                          lambda ids: backend.decode(ids, skip_special_tokens=False))
    json_tok = H.read_tokenizer_json(_as_json_dir(backend, tmp_path / "j"))
    _check_ids_and_decode(json_tok, lambda t: backend.encode(t).ids,
                          lambda ids: backend.decode(ids, skip_special_tokens=False))


@pytest.mark.parametrize("writer", [write_bloom_json, write_glm4_json])
def test_tokenizer_json_layouts_match_tokenizers(tmp_path, writer):
    """BLOOM's and GLM-4's tokenizer.json (Split regexes with nested classes
    and \\p{L} / \\p{N}, ByteLevel, BPE, their post-processors)."""
    from tokenizers import Tokenizer

    writer(tmp_path)
    ref = Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    ours = V.load_tokenizer(str(tmp_path))
    _check_ids_and_decode(ours, lambda t: ref.encode(t).ids,
                          lambda ids: ref.decode(ids, skip_special_tokens=False))
    auto = _auto(tmp_path)
    for text in TEXTS:
        assert ours(text)["input_ids"] == auto(text)["input_ids"], text


@pytest.mark.parametrize("config", [{}, {"keep_accents": True}, {"do_lower_case": False}])
def test_albert_spiece_matches_albert_converter(tmp_path, config):
    """spiece.model (Unigram, precompiled charsmap, the digit-comma score
    penalty) against AlbertConverter's tokenizer; its tokenizer.json
    through the json path too."""
    write_albert_spiece(tmp_path / "sp", config)
    ref = albert_oracle(str(tmp_path / "sp"), config)
    ours = V.load_tokenizer(str(tmp_path / "sp"))
    texts = TEXTS + ["it was 12, then 2, or 12,5", "``quoted'' text", "tm™ and nbsp"]
    _check_ids_and_decode(ours, lambda t: ref.encode(t).ids,
                          lambda ids: ref.decode(ids, skip_special_tokens=False), texts)
    json_tok = H.read_tokenizer_json(_as_json_dir(ref, tmp_path / "j"))
    _check_ids_and_decode(json_tok, lambda t: ref.encode(t).ids,
                          lambda ids: ref.decode(ids, skip_special_tokens=False), texts)


def test_chatglm2_tokenizer_model_follows_its_spec(tmp_path):
    """[gMASK] and sop take ids n + 1 and n + 3 (n pieces) and lead every
    call; the rest is the SentencePiece BPE encoding (the LLaMA reader of
    the same file, without BOS); decode writes the specials' names, so the
    probe's span is (2, 0). The pieces decode as SentencePiece decodes them
    (the LLaMA reader's decode, whose one leading space the specials
    keep)."""
    n = write_chatglm_model(tmp_path)
    tok = V.load_tokenizer(str(tmp_path))
    assert isinstance(tok, V.ChatGLMTokenizer)
    sp = LlamaTokenizer.from_dir(str(tmp_path))
    for text in TEXTS:
        ids = tok(text)["input_ids"]
        assert ids[:2] == [n + 1, n + 3] and ids[2:] == sp.encode(text), text
        # the dummy prefix's space stays: text came before it (SentencePiece drops it only first)
        assert tok.decode(ids) == "[gMASK]sop " + sp.decode(sp.encode(text)), text
    assert tok.special_ids == {"[MASK]": n, "[gMASK]": n + 1, "[sMASK]": n + 2, "sop": n + 3,
                               "eop": n + 4}
    assert tok.decode([1, 2, 0]) == ""                       # BOS, EOS, pad (unk): nothing
    assert ptext.find_token_span(tok) == (2, 0)


def test_jax_auto_tokenizer_refuses_a_chatglm2_directory(tmp_path):
    """JAX's text stage calls AutoTokenizer without trust_remote_code: on a
    chatglm2 directory (its tokenizer_config's auto_map names remote code)
    that call raises before any extraction; the port reads the files."""
    write_chatglm_model(tmp_path)
    with pytest.raises(ValueError, match="trust_remote_code"):
        _auto(tmp_path)
    assert V.load_tokenizer(str(tmp_path))("today")["input_ids"]


def _span_dirs(tmp_path):
    write_bert_vocab(tmp_path / "bert", BERT_CONFIGS["uncased"])
    write_byte_bpe(tmp_path / "roberta", "roberta")
    write_byte_bpe(tmp_path / "deberta", "deberta")
    write_bloom_json(tmp_path / "bloom")
    write_glm4_json(tmp_path / "glm4")
    write_albert_spiece(tmp_path / "albert_sp")
    path = _as_json_dir(albert_oracle(str(tmp_path / "albert_sp")), tmp_path / "albert")
    _write(path, "tokenizer_config.json", {"tokenizer_class": "AlbertTokenizerFast"})
    return {"bert": (1, -1), "roberta": (1, -1), "deberta": (1, -1), "bloom": (0, 0),
            "glm4": (2, 0), "albert": (1, -1)}


def test_find_token_span_matches_jax_probe(tmp_path):
    """The probe's span from the port's reader equals JAX's from
    AutoTokenizer on the same files, for every family AutoTokenizer can
    load here (ALBERT through its tokenizer.json: its spiece.model needs
    sentencepiece)."""
    for name, want in _span_dirs(tmp_path).items():
        ours = V.load_tokenizer(str(tmp_path / name))
        auto = _auto(tmp_path / name)
        for probe in ("today is a good day", "the movie was really not bad"):
            assert ptext.find_token_span(ours, probe) == jtext.find_token_span(auto, probe), name
        assert ptext.find_token_span(ours) == want, name


def test_load_tokenizer_dispatch(tmp_path):
    """tokenizer_class first, then config.json's model_type, then the
    files; LLaMA keeps its own reader; nothing readable raises."""
    from tests.test_torch_feat4 import write_tokenizer_json

    write_tokenizer_json(tmp_path / "llama")
    assert isinstance(V.load_tokenizer(str(tmp_path / "llama")), LlamaTokenizer)
    write_bert_vocab(tmp_path / "bert", {})
    os.remove(tmp_path / "bert" / "tokenizer_config.json")
    assert V.load_tokenizer(str(tmp_path / "bert"))("today")["input_ids"][0] == 2   # [CLS]
    os.remove(tmp_path / "bert" / "config.json")
    assert V.load_tokenizer(str(tmp_path / "bert"))("today")["input_ids"][0] == 2   # by files
    _write(tmp_path / "none", "config.json", {"model_type": "t5"})
    with pytest.raises(NotImplementedError, match="no reader"):
        V.load_tokenizer(str(tmp_path / "none"))
    _write(tmp_path / "missing", "tokenizer_config.json", {"tokenizer_class": "AlbertTokenizer"})
    with pytest.raises(FileNotFoundError, match="spiece.model"):
        V.load_tokenizer(str(tmp_path / "missing"))


@pytest.mark.parametrize("spec", [
    {"normalizer": {"type": "Nmt"}}, {"pre_tokenizer": {"type": "Digits"}},
    {"post_processor": {"type": "Unknown"}}, {"decoder": {"type": "CTC"}},
    {"model": {"type": "WordLevel", "vocab": {}}},
    {"model": {"type": "BPE", "vocab": {}, "merges": [], "dropout": 0.1}}])
def test_unknown_components_raise_naming_them(spec):
    """At load, or for a decoder at the first decode."""
    base = {"model": {"type": "WordPiece", "vocab": {"[UNK]": 0}}}
    with pytest.raises(NotImplementedError) as err:
        H.HFTokenizer({**base, **spec}).decode([0])
    kind = next(iter(spec.values()))["type"]
    assert kind in str(err.value) or "dropout" in str(err.value)


# ---------------------------------------------------------------- components

def test_precompiled_matches_tokenizers():
    """The charsmap's double array read back as ``tokenizers`` reads it:
    per grapheme cluster under 6 bytes the shortest matching prefix
    replaces the whole cluster ('ｅ' + U+0301 gives 'e', where
    SentencePiece's longest match would give 'é'), else per character."""
    from tokenizers import normalizers

    blob = H.build_precompiled_charsmap({**CHARSMAP, "ab": "X", "a": "Y", "ba": "Z"})
    ref, ours = normalizers.Precompiled(blob), H.Precompiled(blob)
    texts = TEXTS + ["abc a ab ba b", "ｅ́ ｅ́́", "\r\nab", "한국어 각",
                     "👍🏽ab 👨‍👩‍👧 🇯🇵🇫🇷", "é̂x", "ｆ️ａ"]
    for text in texts:
        assert ours(text) == ref.normalize_str(text), text
    assert ours("ｅ́") == "e"


def _assigned(lo, hi, since_3_2=True):
    """The code points of [lo, hi) assigned in Unicode 15.0 (Python 3.12's
    tables) and, with ``since_3_2``, already in 3.2 with the same category:
    ``tokenizers``' BERT punctuation test reads older tables than Python's
    (U+061D, added in 14.0, is punctuation here and not there)."""
    old = unicodedata.ucd_3_2_0
    return [chr(c) for c in range(lo, hi) if unicodedata.category(chr(c)) != "Cn"
            and (not since_3_2 or old.category(chr(c)) == unicodedata.category(chr(c)))]


ALPHABET = (_assigned(0x20, 0x7F) + _assigned(0xA0, 0x180) + _assigned(0x300, 0x370)
            + _assigned(0x4E00, 0x4E40) + _assigned(0x3040, 0x30A0) + _assigned(0x600, 0x700)
            + _assigned(0x900, 0x980) + list("²³¹Ⅻⅻ½٣३０１") + _assigned(0x1F600, 0x1F650, False)
            + _assigned(0x1F3FB, 0x1F400, False) + list("‍\t\n\r\x0b\x0c\x1c\x85　  "))
TEXT = st.text(alphabet=st.sampled_from(ALPHABET), max_size=40)
FUZZ = settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.too_slow])


@FUZZ
@given(TEXT)
def test_regex_splits_match_oniguruma(text):
    """GPT-2's, BLOOM's and GLM-4's split patterns, translated, cut text as
    ``tokenizers`` cuts it."""
    from tokenizers import Regex, pre_tokenizers

    for pattern in (H.GPT2_SPLIT, BLOOM_SPLIT, GLM4_SPLIT):
        want = [p for p, _ in pre_tokenizers.Split(Regex(pattern), "isolated").pre_tokenize_str(text)]
        got = [t for _, t in H.pre_tokenizer({"type": "Split", "pattern": {"Regex": pattern},
                                               "behavior": "Isolated"})([(0, text)])]
        assert got == want, pattern


@FUZZ
@given(TEXT)
def test_pre_tokenizers_match_tokenizers(text):
    from tokenizers import pre_tokenizers as P

    cases = [(P.ByteLevel(add_prefix_space=False), {"type": "ByteLevel", "add_prefix_space": False}),
             (P.ByteLevel(add_prefix_space=True), {"type": "ByteLevel", "add_prefix_space": True}),
             (P.BertPreTokenizer(), {"type": "BertPreTokenizer"}),
             (P.Whitespace(), {"type": "Whitespace"}),
             (P.WhitespaceSplit(), {"type": "WhitespaceSplit"}),
             (P.Metaspace(prepend_scheme="always"), {"type": "Metaspace", "prepend_scheme": "always"}),
             (P.Metaspace(prepend_scheme="never", split=False),
              {"type": "Metaspace", "prepend_scheme": "never", "split": False})]
    for ref, spec in cases:
        want = [p for p, _ in ref.pre_tokenize_str(text)] if text else []
        got = [t for _, t in H.pre_tokenizer(spec)([(0, text)])] if text else []
        assert got == want, spec


@FUZZ
@given(TEXT)
def test_normalizers_match_tokenizers(text):
    from tokenizers import normalizers as N

    cases = [(N.BertNormalizer(), {"type": "BertNormalizer"}),
             (N.BertNormalizer(lowercase=False, strip_accents=True, handle_chinese_chars=False),
              {"type": "BertNormalizer", "lowercase": False, "strip_accents": True,
               "handle_chinese_chars": False}),
             (N.NFKD(), {"type": "NFKD"}), (N.NFC(), {"type": "NFC"}),
             (N.Lowercase(), {"type": "Lowercase"}), (N.StripAccents(), {"type": "StripAccents"}),
             (N.Strip(), {"type": "Strip", "strip_left": True, "strip_right": True})]
    for ref, spec in cases:
        assert H.normalizer(spec)(text) == ref.normalize_str(text), spec


@pytest.mark.parametrize("spec", [
    {"type": "WordPiece", "prefix": "##", "cleanup": True},
    {"type": "Metaspace", "replacement": SPACE, "prepend_scheme": "always", "split": True},
    {"type": "Metaspace", "replacement": SPACE, "prepend_scheme": "never", "split": True},
    {"type": "BPEDecoder", "suffix": "</w>"},
    {"type": "ByteLevel"}])
def test_decoders_match_tokenizers(spec):
    from tokenizers import decoders as D

    ref = {"WordPiece": lambda: D.WordPiece(prefix="##", cleanup=True),
           "Metaspace": lambda: D.Metaspace(prepend_scheme=spec.get("prepend_scheme")),
           "BPEDecoder": lambda: D.BPEDecoder(suffix="</w>"),
           "ByteLevel": D.ByteLevel}[spec["type"]]()
    cases = [["[CLS]", "today", "##s", "is", ",", "don", "'", "t", "."],
             [SPACE + "to", "day", SPACE, SPACE + SPACE + "is"], ["a</w>", "b", "c</w>"],
             [H._byte_level(" café"), H._byte_level("👍")[:2], "<s>"], []]
    for tokens in cases:
        assert "".join(H.decoder(spec)(tokens)) == ref.decode(tokens), tokens


def test_unigram_ties_unknowns_and_byte_fallback():
    """Unigram's Viterbi (ties keep the first path found), unknown runs
    fused into one unk, byte fallback for a string with no piece."""
    from tokenizers import Tokenizer, models

    vocab = [["<unk>", 0.0], ["ab", -1.0], ["a", -0.5], ["b", -0.5], ["c", -2.0], ["abc", -3.0],
             ["<0xC3>", -9.0], ["<0xA9>", -9.0]]
    for fallback in (False, True):
        ref = Tokenizer(models.Unigram([tuple(v) for v in vocab], unk_id=0,
                                       byte_fallback=fallback))
        ours = H.Unigram({"vocab": vocab, "unk_id": 0, "byte_fallback": fallback})
        for text in ("ab", "abc", "abxyc", "xyz", "aé", "cab", "bbbb"):
            assert ours.encode(text) == ref.encode(text).ids, (text, fallback)


@pytest.mark.parametrize("name", ["bert-base-uncased", "roberta-large", "albert-base-v2",
                                  "deberta-large", "bloom-7b1", "chatglm2-6b"])
def test_chip_smoke_family_files_read_as_transformers_reads_them(tmp_path, name):
    """The tokenizer files chip_smoke.py's phase 25 writes by hand (no
    transformers on the card's machine) give the port's reader the ids
    AutoTokenizer gives on phase 13's transcripts (chatglm2: the spec, on
    the LLaMA reader of the same tokenizer.model)."""
    import chip_smoke

    chip_smoke.write_family_tokenizer(str(tmp_path), name)
    _write(tmp_path, "config.json", {"model_type": {"bert-base-uncased": "bert",
                                                    "roberta-large": "roberta",
                                                    "albert-base-v2": "albert",
                                                    "deberta-large": "deberta",
                                                    "bloom-7b1": "bloom",
                                                    "chatglm2-6b": "chatglm"}[name]})
    ours = V.load_tokenizer(str(tmp_path))
    texts = [s for _, s in chip_smoke.transcripts() if s.strip()]
    if name == "chatglm2-6b":
        sp = LlamaTokenizer.from_dir(str(tmp_path))
        n = len(sp.model.pieces)
        for text in texts:
            assert ours(text)["input_ids"] == [n + 1, n + 3] + sp.encode(text)
        return
    if name == "albert-base-v2":                      # AlbertTokenizerFast reads tokenizer.json
        _write(tmp_path, "tokenizer_config.json", {"tokenizer_class": "AlbertTokenizerFast"})
    auto = _auto(tmp_path)
    for text in texts:
        assert ours(text)["input_ids"] == auto(text)["input_ids"], text
    assert ptext.find_token_span(ours) == jtext.find_token_span(auto) \
        == chip_smoke.TEXT_FAMILY_SPANS[name]
