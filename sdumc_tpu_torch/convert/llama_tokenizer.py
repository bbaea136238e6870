"""The LLaMA tokenizer, read from the files of an HF model directory: the
encoder for the feat4 stage's ASR prompt and the text stage's transcripts,
and the decoder that the text stage's special-token probe reads.

The port's stand-in for ``transformers.AutoTokenizer`` (the JAX package,
``sdumc_tpu/extract/llm4wav.py:286``): neither ``transformers`` nor
``sentencepiece`` is a dependency of the port. It reads, in this order:

* ``tokenizer.json`` (HF's fast format), through ``convert/hf_tokenizer.py``:
  a BPE model with byte fallback, merges applied lowest rank first
  (leftmost on a tie), the normalizer (``Prepend`` / ``Replace`` in a
  ``Sequence``) or the ``Metaspace`` pre-tokenizer of LLaMA's files; its
  post-processor is not applied (BOS and EOS follow
  ``tokenizer_config.json``, as ``LlamaTokenizerFast`` resets them);
* else ``tokenizer.model`` (SentencePiece BPE, as the public
  Vicuna-7B-v1.5 directory ships it): the pieces (piece, score, type) and
  the normalizer flags are read with a minimal protobuf wire-format reader;
  the highest-scoring merge of two adjacent symbols into a piece comes
  first (leftmost on a tie), as SentencePiece's BPE does.

Like ``tokenizer(prompt)["input_ids"]``, a call starts with BOS when
``tokenizer_config.json`` says ``add_bos_token`` (the default) and ends with
EOS when it says ``add_eos_token``. Text is encoded as plain text: special
tokens written inside it are not recognised.

``decode(ids)`` is ``tokenizer.decode(ids)`` with special tokens kept (the
default, which the text stage's probe relies on): each id becomes its token,
a special token its content. A ``tokenizer.json`` decodes as its
``decoder`` says (``hf_tokenizer``: none joins the tokens with a space, as
the ``tokenizers`` package does; LLaMA's ``Sequence`` of
``Replace("▁" -> " ")``, ``ByteFallback``, ``Fuse`` and ``Strip`` is
applied step by step; a decoder it does not read raises at the first
decode). A ``tokenizer.model`` decodes as SentencePiece does: the
pieces joined, ``▁`` turned into a space, runs of byte pieces joined into
UTF-8, one leading space dropped.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Callable, Dict, List, Optional, Tuple

from sdumc_tpu_torch.convert.hf_tokenizer import (SPACE, HFTokenizer, _byte_fallback, _merge_loop,
                                                  _strip)

_SP_NORMAL, _SP_UNKNOWN, _SP_CONTROL, _SP_USER, _SP_UNUSED, _SP_BYTE = 1, 2, 3, 4, 5, 6
_SP_BPE = 2


def _byte_pieces(text: str, vocab: Dict[str, int]) -> Optional[List[int]]:
    ids = [vocab.get(f"<0x{b:02X}>") for b in text.encode("utf-8")]
    return None if None in ids else ids


def _sentencepiece_text(tokens: List[str]) -> str:
    """LLaMA's decoder: ``▁`` -> space, byte runs -> UTF-8, joined, one
    leading space dropped."""
    return _strip("".join(_byte_fallback([t.replace(SPACE, " ") for t in tokens])), " ", 1, 0)


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message: varints as
    ints, fixed32 as raw 4 bytes, length-delimited as bytes."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"protobuf wire type {wire} is not supported")
        yield field, wire, value


def _int32(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def sentencepiece_proto(blob: bytes) -> Tuple[List[Tuple[str, float, int]], dict, dict]:
    """(pieces as (piece, score, type), trainer_spec fields, normalizer_spec
    fields) of a SentencePiece ModelProto."""
    pieces, trainer, norm = [], {}, {}
    for field, _, value in _fields(blob):
        if field == 1:
            piece, score, kind = "", 0.0, _SP_NORMAL
            for f, _, v in _fields(value):
                if f == 1:
                    piece = v.decode("utf-8")
                elif f == 2:
                    score = struct.unpack("<f", v)[0]
                elif f == 3:
                    kind = v
            pieces.append((piece, score, kind))
        elif field == 2:
            trainer.update({f: v for f, w, v in _fields(value) if w == 0})
        elif field == 3:
            norm.update({f: v for f, _, v in _fields(value)})
    return pieces, trainer, norm


class _SentencePieceBPE:
    """A SentencePiece BPE ``tokenizer.model`` (ModelProto: pieces = 1,
    trainer_spec = 2, normalizer_spec = 3)."""

    def __init__(self, blob: bytes):
        pieces, trainer, norm = sentencepiece_proto(blob)
        self.pieces: Dict[str, Tuple[int, float, int]] = {
            p: (i, score, kind) for i, (p, score, kind) in enumerate(pieces)}
        if trainer.get(3, 1) != _SP_BPE:
            raise NotImplementedError(f"SentencePiece model_type {trainer.get(3, 1)}; only BPE (2)")
        if norm.get(2):
            raise NotImplementedError("tokenizer.model has a precompiled normalizer; only the "
                                      "identity normalizer of LLaMA's files is supported")
        self.byte_fallback = bool(trainer.get(35, 0))
        self.unk_id = _int32(trainer.get(40, 0))
        self.bos_id = _int32(trainer.get(41, 1))
        self.eos_id = _int32(trainer.get(42, 2))
        self.add_dummy_prefix = bool(norm.get(3, 1))
        self.remove_extra_whitespaces = bool(norm.get(4, 1))
        self.escape_whitespaces = bool(norm.get(5, 1))
        self.vocab = {p: i for p, (i, _, _) in self.pieces.items()}
        self.tokens = {i: p for p, i in self.vocab.items()}

    @staticmethod
    def decode_tokens(tokens: List[str]) -> str:
        return _sentencepiece_text(tokens)

    def _normalize(self, text: str) -> str:
        if self.remove_extra_whitespaces:
            text = " ".join(text.split())
        if self.add_dummy_prefix and text:
            text = " " + text
        return text.replace(" ", SPACE) if self.escape_whitespaces else text

    def _score(self, a: str, b: str):
        hit = self.pieces.get(a + b)
        if hit is None or hit[2] not in (_SP_NORMAL, _SP_USER):
            return None
        return (-hit[1],)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for p in _merge_loop(list(self._normalize(text)), self._score):
            hit = self.pieces.get(p)
            if hit is not None and hit[2] in (_SP_NORMAL, _SP_USER):
                ids.append(hit[0])
                continue
            fallback = _byte_pieces(p, self.vocab) if self.byte_fallback else None
            ids.extend(fallback if fallback is not None else [self.unk_id])
        return ids


def _token_content(tok) -> Optional[str]:
    return tok.get("content") if isinstance(tok, dict) else tok


class LlamaTokenizer:
    """``tok(text)["input_ids"]`` and ``tok.decode(ids)``, with
    ``bos_token_id`` / ``eos_token_id``."""

    def __init__(self, model, bos_token_id: Optional[int], eos_token_id: Optional[int],
                 add_bos: bool = True, add_eos: bool = False):
        self.model = model
        self.bos_token_id, self.eos_token_id = bos_token_id, eos_token_id
        self.add_bos, self.add_eos = add_bos, add_eos

    @classmethod
    def from_dir(cls, model_dir: str) -> "LlamaTokenizer":
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        cfg = {}
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
        json_path = os.path.join(model_dir, "tokenizer.json")
        sp_path = os.path.join(model_dir, "tokenizer.model")
        if os.path.exists(json_path):
            with open(json_path, encoding="utf-8") as f:
                model = HFTokenizer(json.load(f))
            bos, eos = model.vocab.get("<s>"), model.vocab.get("</s>")
        elif os.path.exists(sp_path):
            with open(sp_path, "rb") as f:
                model = _SentencePieceBPE(f.read())
            bos, eos = model.bos_id, model.eos_id
        else:
            raise FileNotFoundError(f"{model_dir} holds neither tokenizer.json nor "
                                    "tokenizer.model")
        for key in ("bos_token", "eos_token"):
            content = _token_content(cfg.get(key))
            if content is not None and content in model.vocab:
                if key == "bos_token":
                    bos = model.vocab[content]
                else:
                    eos = model.vocab[content]
        return cls(model, bos, eos, bool(cfg.get("add_bos_token", True)),
                   bool(cfg.get("add_eos_token", False)))

    def encode(self, text: str) -> List[int]:
        """The ids of ``text`` without BOS / EOS."""
        return self.model.encode(text)

    def __call__(self, text: str) -> Dict[str, List[int]]:
        ids = self.encode(text)
        if self.add_bos and self.bos_token_id is not None:
            ids = [self.bos_token_id] + ids
        if self.add_eos and self.eos_token_id is not None:
            ids = ids + [self.eos_token_id]
        return {"input_ids": ids}

    def convert_ids_to_tokens(self, ids: List[int]) -> List[str]:
        """Each id's token (a special token's content); raises on an id
        outside the vocabulary."""
        try:
            return [self.model.tokens[int(i)] for i in ids]
        except KeyError as e:
            raise KeyError(f"token id {e.args[0]} is not in the vocabulary") from None

    def decode(self, ids: List[int]) -> str:
        """The text of ``ids``, special tokens kept."""
        return self.model.decode_tokens(self.convert_ids_to_tokens(ids))
