"""The text families' tokenizers from the older file layouts that published
directories ship without a ``tokenizer.json``, and ``load_tokenizer``,
which picks a reader for a model directory as ``AutoTokenizer`` would.

Each legacy layout is turned into the ``tokenizer.json`` spec that
transformers' ``convert_slow_tokenizer`` builds from it (what
``AutoTokenizer`` runs in JAX's text stage), then read by
``convert/hf_tokenizer.py``:

* ``vocab.txt`` (``BertTokenizer``: bert-base-chinese, MacBERT, SimBERT,
  the Chinese ALBERTs): BERT's normalizer with ``do_lower_case``,
  ``tokenize_chinese_chars`` and ``strip_accents`` from
  ``tokenizer_config.json``, BERT's pre-tokenizer, WordPiece, and
  ``[CLS] $A [SEP]``;
* ``vocab.json`` + ``merges.txt`` (GPT-2's byte-level BPE): RoBERTa with
  ``<s> $A </s>``, DeBERTa v1 with ``[CLS] $A [SEP]``, GPT-2 with none;
* ``spiece.model`` (ALBERT, SentencePiece Unigram, read with
  ``llama_tokenizer``'s protobuf reader): ALBERT's normalizers (quotes,
  NFKD and accents stripped unless ``keep_accents``, lowercase, the
  model's ``precompiled_charsmap``, runs of spaces to one), Metaspace, the
  pieces' scores (a piece ending in a digit and a comma 100 lower), and
  ``[CLS] $A [SEP]``.

chatglm2's ``tokenizer.model`` (SentencePiece BPE, ``llama_tokenizer``'s
reader) is read as THUDM's ``tokenization_chatglm.py`` for chatglm2-6b
specifies: the special tokens ``[MASK]``, ``[gMASK]``, ``[sMASK]``,
``sop`` and ``eop`` take the ids after the model's pieces, and every call
starts with ``[gMASK]``, ``sop``. ``decode`` writes those specials as their
names (so the text stage's probe strips the two-token prefix, span (2, 0))
and BOS, EOS and the pad (unk) id as nothing.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from sdumc_tpu_torch.convert.hf_tokenizer import HFTokenizer, read_tokenizer_json
from sdumc_tpu_torch.convert.llama_tokenizer import (SPACE, LlamaTokenizer, _int32,
                                                     _SentencePieceBPE, _token_content,
                                                     sentencepiece_proto)

def _read_json(model_dir: str, name: str) -> dict:
    path = os.path.join(model_dir, name)
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _token(cfg: dict, key: str, default: str) -> str:
    return _token_content(cfg.get(key)) or default


def _template(vocab: Dict[str, int], cls: str, sep: str, unk: Optional[str] = None) -> dict:
    ids = {t: vocab.get(t, vocab.get(unk)) for t in (cls, sep)}
    return {"type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": cls, "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": sep, "type_id": 0}}],
            "special_tokens": {t: {"id": t, "ids": [i], "tokens": [t]} for t, i in ids.items()}}


def bert_normalizer(cfg: dict) -> dict:
    """BertTokenizer(Fast)'s normalizer settings from its config (no basic
    tokenizer: none of them)."""
    basic = cfg.get("do_basic_tokenize", True)
    return {"type": "BertNormalizer", "clean_text": True,
            "handle_chinese_chars": basic and cfg.get("tokenize_chinese_chars", True),
            "strip_accents": cfg.get("strip_accents") if basic else False,
            "lowercase": basic and cfg.get("do_lower_case", True)}


def bert_spec(vocab_path: str, cfg: dict) -> dict:
    """``vocab.txt`` + tokenizer_config -> the spec of ``BertConverter``."""
    vocab: Dict[str, int] = {}
    with open(vocab_path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line.rstrip("\n")] = i
    unk = _token(cfg, "unk_token", "[UNK]")
    return {"normalizer": bert_normalizer(cfg), "pre_tokenizer": {"type": "BertPreTokenizer"},
            "model": {"type": "WordPiece", "vocab": vocab, "unk_token": unk,
                      "continuing_subword_prefix": "##", "max_input_chars_per_word": 100},
            "post_processor": _template(vocab, _token(cfg, "cls_token", "[CLS]"),
                                        _token(cfg, "sep_token", "[SEP]"), unk),
            "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True}}


# the special tokens of the byte-level BPE families: (cls, sep) or None
BPE_FAMILIES = {"RobertaTokenizer": ("<s>", "</s>"), "DebertaTokenizer": ("[CLS]", "[SEP]"),
                "GPT2Tokenizer": None}


def bpe_spec(vocab_path: str, merges_path: str, cfg: dict, family: str) -> dict:
    """``vocab.json`` + ``merges.txt`` -> the spec of ``RobertaConverter``,
    ``DebertaConverter`` or ``GPT2Converter``. merges.txt is read as GPT-2's
    tokenizer reads it: its first line (the version) and its last (empty)
    line dropped."""
    with open(vocab_path, encoding="utf-8") as f:
        vocab = json.load(f)
    with open(merges_path, encoding="utf-8") as f:
        merges = [tuple(line.split()) for line in f.read().split("\n")[1:-1]]
    prefix_space = bool(cfg.get("add_prefix_space", False))
    specials = BPE_FAMILIES[family]
    if specials is None:
        post = {"type": "ByteLevel", "add_prefix_space": prefix_space, "trim_offsets": True}
    elif family == "RobertaTokenizer":
        cls, sep = _token(cfg, "cls_token", specials[0]), _token(cfg, "sep_token", specials[1])
        post = {"type": "RobertaProcessing", "cls": [cls, vocab.get(cls)],
                "sep": [sep, vocab.get(sep)]}
    else:
        post = _template(vocab, *specials, _token(cfg, "unk_token", "[UNK]"))
    return {"pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": prefix_space,
                              "trim_offsets": True, "use_regex": True},
            "model": {"type": "BPE", "vocab": vocab, "merges": [list(m) for m in merges],
                      "continuing_subword_prefix": "", "end_of_word_suffix": "",
                      "fuse_unk": False},
            "post_processor": post, "decoder": {"type": "ByteLevel"}}


def _number_comma(piece: str) -> bool:
    return len(piece) >= 2 and piece[-1] == "," and piece[-2].isdigit()


def albert_spec(blob: bytes, cfg: dict) -> dict:
    """``spiece.model`` + tokenizer_config -> the spec of
    ``AlbertConverter``."""
    pieces, trainer, norm = sentencepiece_proto(blob)
    if trainer.get(3, 1) != 1:
        raise NotImplementedError(f"spiece.model model_type {trainer.get(3, 1)}; ALBERT's "
                                  "reader reads Unigram (1)")
    steps = [{"type": "Replace", "pattern": {"String": "``"}, "content": '"'},
             {"type": "Replace", "pattern": {"String": "''"}, "content": '"'}]
    if not cfg.get("keep_accents", False):
        steps += [{"type": "NFKD"}, {"type": "StripAccents"}]
    if cfg.get("do_lower_case", True):
        steps.append({"type": "Lowercase"})
    if norm.get(2):
        steps.append({"type": "Precompiled", "precompiled_charsmap": bytes(norm[2])})
    steps.append({"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "})
    vocab = {p: i for i, (p, _, _) in enumerate(pieces)}
    return {"normalizer": {"type": "Sequence", "normalizers": steps},
            "pre_tokenizer": {"type": "Metaspace", "replacement": SPACE,
                              "prepend_scheme": "always", "split": True},
            "model": {"type": "Unigram", "unk_id": _int32(trainer.get(40, 0)),
                      "byte_fallback": False,
                      "vocab": [[p, s - 100 if _number_comma(p) else s] for p, s, _ in pieces]},
            "post_processor": _template(vocab, "[CLS]", "[SEP]", "<unk>"),
            "decoder": {"type": "Metaspace", "replacement": SPACE, "prepend_scheme": "always",
                        "split": True},
            "added_tokens": [{"id": i, "content": p, "special": k == 3}
                             for i, (p, _, k) in enumerate(pieces) if k in (3, 4)]}


class ChatGLMTokenizer:
    """chatglm2's ``tokenizer.model``: ``tok(text)["input_ids"]`` is
    ``[gMASK], sop`` and the SentencePiece ids; ``tok.decode(ids)``."""

    SPECIALS = ("[MASK]", "[gMASK]", "[sMASK]", "sop", "eop")

    def __init__(self, sp: _SentencePieceBPE):
        self.sp = sp
        n = len(sp.pieces)
        self.special_ids = {t: n + i for i, t in enumerate(self.SPECIALS)}
        self.special_names = {i: t for t, i in self.special_ids.items()}
        self.prefix = [self.special_ids["[gMASK]"], self.special_ids["sop"]]
        self.silent = {sp.bos_id, sp.eos_id, sp.unk_id}

    @classmethod
    def from_dir(cls, model_dir: str) -> "ChatGLMTokenizer":
        with open(os.path.join(model_dir, "tokenizer.model"), "rb") as f:
            return cls(_SentencePieceBPE(f.read()))

    def __call__(self, text: str) -> Dict[str, List[int]]:
        return {"input_ids": self.prefix + self.sp.encode(text)}

    def decode(self, ids) -> str:
        tokens = []
        for i in map(int, ids):
            if i in self.special_names:
                tokens.append(self.special_names[i])
            elif i not in self.silent and i in self.sp.tokens:
                tokens.append(self.sp.tokens[i])
        return self.sp.decode_tokens(tokens)


def _bert_overrides(tok: HFTokenizer, spec: dict, cfg: dict) -> HFTokenizer:
    """BertTokenizerFast resets a ``tokenizer.json``'s BertNormalizer to
    the config's do_lower_case / strip_accents / tokenize_chinese_chars
    (their defaults where the config leaves them out)."""
    norm = spec.get("normalizer") or {}
    if norm.get("type") != "BertNormalizer":
        return tok
    want = {"lowercase": cfg.get("do_lower_case", True), "strip_accents": cfg.get("strip_accents"),
            "handle_chinese_chars": cfg.get("tokenize_chinese_chars", True)}
    if all(norm.get(k) == v for k, v in want.items()):
        return tok
    return HFTokenizer({**spec, "normalizer": {**norm, **want}})


# AutoTokenizer's class for a config.json model_type, where no tokenizer_class is named
BY_MODEL_TYPE = {"llama": "LlamaTokenizer", "chatglm": "ChatGLMTokenizer",
                 "bert": "BertTokenizer", "roberta": "RobertaTokenizer",
                 "xlm-roberta": "XLMRobertaTokenizer", "albert": "AlbertTokenizer",
                 "deberta": "DebertaTokenizer", "gpt2": "GPT2Tokenizer"}


def load_tokenizer(model_dir: str):
    """The tokenizer of a model directory: LlamaTokenizer (LLaMA, Vicuna)
    or ChatGLMTokenizer (chatglm2) where ``tokenizer_config.json``'s
    ``tokenizer_class`` or ``config.json``'s ``model_type`` names them;
    else ``tokenizer.json``; else the legacy files of the class so named,
    or (with neither) the ones found in the directory. Raises when it
    finds nothing it can read."""
    cfg = _read_json(model_dir, "tokenizer_config.json")
    model_type = _read_json(model_dir, "config.json").get("model_type")
    named = str(cfg.get("tokenizer_class") or "").removesuffix("Fast")
    cls = named or BY_MODEL_TYPE.get(model_type, "")
    if cls == "LlamaTokenizer":
        return LlamaTokenizer.from_dir(model_dir)
    if cls == "ChatGLMTokenizer":
        return ChatGLMTokenizer.from_dir(model_dir)

    def has(name):
        return os.path.exists(os.path.join(model_dir, name))

    if has("tokenizer.json"):
        tok = read_tokenizer_json(model_dir)
        if cls == "BertTokenizer":
            with open(os.path.join(model_dir, "tokenizer.json"), encoding="utf-8") as f:
                tok = _bert_overrides(tok, json.load(f), cfg)
        return tok
    if not cls:
        cls = ("AlbertTokenizer" if has("spiece.model") else "BertTokenizer" if has("vocab.txt")
               else "GPT2Tokenizer" if has("vocab.json") and has("merges.txt") else "")
    files = {"BertTokenizer": ("vocab.txt",), "AlbertTokenizer": ("spiece.model",),
             **{k: ("vocab.json", "merges.txt") for k in BPE_FAMILIES}}.get(cls)
    if files is None:
        raise NotImplementedError(f"{model_dir}: no tokenizer.json and no reader for tokenizer "
                                  f"class {cls or 'unknown'!r}")
    missing = [f for f in files if not has(f)]
    if missing:
        raise FileNotFoundError(f"{model_dir}: {cls} needs {missing}")
    paths = [os.path.join(model_dir, f) for f in files]
    if cls == "BertTokenizer":
        return HFTokenizer(bert_spec(paths[0], cfg))
    if cls == "AlbertTokenizer":
        with open(paths[0], "rb") as f:
            return HFTokenizer(albert_spec(f.read(), cfg))
    return HFTokenizer(bpe_spec(*paths, cfg, cls))
