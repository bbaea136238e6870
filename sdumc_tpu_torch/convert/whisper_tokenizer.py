"""Decode-only reader of Whisper's ``tokenizer.json`` (byte-level BPE).

It gives what ``WhisperTokenizerFast.decode(ids, skip_special_tokens=True)``
gives, without ``transformers`` or ``tokenizers``:

1. a prompt (``<|startofprev|>`` ... up to ``<|startoftranscript|>``) is
   dropped, as ``_strip_prompt`` does (all of it if no start follows);
2. added tokens marked ``special`` are skipped; every other added token
   (Whisper's timestamps ``<|0.00|>`` ... ``<|30.00|>``) is written as its
   text, and the byte-level pieces between them are decoded run by run:
   each character maps back to its byte (GPT-2's ``bytes_to_unicode``
   table; a piece holding a character outside it gives its own UTF-8
   bytes), and each run's bytes are read as UTF-8 with invalid sequences
   replaced by U+FFFD;
3. ``clean_up_tokenization_spaces`` (from ``tokenizer_config.json``, off if
   absent) removes the spaces before punctuation and contractions;
4. timestamp texts ``<|d.d|>`` are removed from the result.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, List

TIMESTAMP = re.compile(r"<\|(\d+\.\d+)\|>")
CLEANUPS = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
            (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re"))


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table of byte-level BPE."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


CHAR_BYTES = {c: b for b, c in bytes_to_unicode().items()}


def _piece_bytes(token: str) -> bytes:
    try:
        return bytes(CHAR_BYTES[c] for c in token)
    except KeyError:
        return token.encode("utf-8")


class WhisperTokenizer:
    """``decode`` of a Whisper ``tokenizer.json`` (BPE model, ByteLevel
    decoder)."""

    def __init__(self, spec: dict, clean_up_tokenization_spaces: bool = False):
        decoder = spec.get("decoder") or {}
        if decoder.get("type") != "ByteLevel":
            raise NotImplementedError(f"tokenizer.json decoder {decoder.get('type')!r}; "
                                      "only ByteLevel (Whisper's)")
        if spec["model"].get("type") != "BPE":
            raise NotImplementedError(f"tokenizer.json model {spec['model'].get('type')!r}; "
                                      "only BPE")
        self.pieces: Dict[int, str] = {i: t for t, i in spec["model"]["vocab"].items()}
        self.added: Dict[int, str] = {}
        self.special = set()
        for tok in spec.get("added_tokens", []):
            self.added[tok["id"]] = tok["content"]
            if tok.get("special"):
                self.special.add(tok["id"])
        ids = {t: i for i, t in self.added.items()}
        self.prompt_id = ids.get("<|startofprev|>")
        self.start_id = ids.get("<|startoftranscript|>")
        self.clean_up = clean_up_tokenization_spaces

    @classmethod
    def from_dir(cls, model_dir: str) -> "WhisperTokenizer":
        with open(os.path.join(model_dir, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        clean = False
        config = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(config):
            with open(config, encoding="utf-8") as f:
                clean = bool(json.load(f).get("clean_up_tokenization_spaces", False))
        return cls(spec, clean)

    def _strip_prompt(self, ids: List[int]) -> List[int]:
        if ids and ids[0] == self.prompt_id:
            return ids[ids.index(self.start_id):] if self.start_id in ids else []
        return ids

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in ids]
        if skip_special_tokens:
            ids = self._strip_prompt(ids)
        text: List[str] = []
        run = bytearray()
        for i in ids:
            if i in self.added:
                if skip_special_tokens and i in self.special:
                    continue
                text.append(run.decode("utf-8", errors="replace"))
                run.clear()
                text.append(self.added[i])
            elif i in self.pieces:
                run += _piece_bytes(self.pieces[i])
        text.append(run.decode("utf-8", errors="replace"))
        out = "".join(text)
        if self.clean_up:
            for old, new in CLEANUPS:
                out = out.replace(old, new)
        return TIMESTAMP.sub("", out)
