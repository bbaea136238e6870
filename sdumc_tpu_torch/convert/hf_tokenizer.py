"""A reader of HF's ``tokenizer.json`` (the ``tokenizers`` package's
format) without ``tokenizers``, ``transformers`` or ``regex``: the
tokenizer of the BERT, RoBERTa, ALBERT, DeBERTa, BLOOM and GLM text
families (``convert/vocab_tokenizers.py`` builds the same pipeline from
the older file layouts).

``HFTokenizer(spec)(text)["input_ids"]`` is what ``tokenizer(text)
["input_ids"]`` gives: normalizer, pre-tokenizer, model, post-processor,
each read from the spec. These components are read:

* normalizers: ``BertNormalizer``, ``NFC`` / ``NFD`` / ``NFKC`` / ``NFKD``
  (``unicodedata``), ``Lowercase``, ``StripAccents``, ``Replace``,
  ``Prepend``, ``Strip``, ``Precompiled`` (SentencePiece's
  ``precompiled_charsmap``) and ``Sequence``;
* pre-tokenizers: ``BertPreTokenizer``, ``ByteLevel`` (GPT-2's split and
  byte-to-unicode map), ``Split``, ``Metaspace``, ``Whitespace``,
  ``WhitespaceSplit`` and ``Sequence``;
* models: ``WordPiece`` (greedy longest match), ``BPE`` (merges lowest
  rank first, leftmost on a tie; ``continuing_subword_prefix``,
  ``end_of_word_suffix``, ``fuse_unk``, ``byte_fallback``,
  ``ignore_merges``) and ``Unigram`` (Viterbi over the pieces' log
  probabilities, unknown runs fused);
* post-processors: ``TemplateProcessing``, ``BertProcessing``,
  ``RobertaProcessing``, ``ByteLevel`` and ``Sequence``;
* decoders: ``WordPiece``, ``ByteLevel``, ``Metaspace``, ``BPEDecoder``,
  ``Sequence`` and LLaMA's ``Replace`` / ``ByteFallback`` / ``Fuse`` /
  ``Strip``.

Any other component (or a BPE with dropout) raises, naming it (a
decoder at the first decode). Text is
encoded as plain text: added tokens written inside it are not split out.
``decode(ids)`` keeps special tokens, as ``tokenizer.decode`` does; an id
outside the vocabulary is skipped, as ``tokenizers`` skips it.

Regular expressions (``Split``, ``Replace``) are Oniguruma's; they are
translated to Python's ``re``: ``\\p{L}`` / ``\\p{N}`` (and the other
one-letter categories), ``\\s`` and ``\\w`` become explicit classes built
from ``unicodedata`` (``\\s`` is White_Space, ``\\w`` letters, marks,
numbers and connector punctuation, as Oniguruma defines them for
Unicode), and a class nested in a class is flattened into it.

``Precompiled`` follows ``tokenizers``: the darts-clone double-array trie of
the charsmap is searched from each grapheme cluster of fewer than 6 bytes,
the shortest matching prefix replacing the whole cluster, else from each of
its characters. Grapheme clusters are approximated from ``unicodedata``:
a character with its combining marks (Mn, Me, Mc), joiners and variation
selectors, emoji modifiers, ZWJ sequences, CR LF, Hangul jamo sequences
and regional-indicator pairs (``tokenizers`` applies UAX #29 in full).
"""

from __future__ import annotations

import base64
import functools
import json
import os
import re
import struct
import sys
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from sdumc_tpu_torch.convert.whisper_tokenizer import CHAR_BYTES, bytes_to_unicode

SPACE = "▁"      # "▁", SentencePiece's whitespace mark
# Unicode's White_Space property (Rust's char::is_whitespace, Oniguruma's \s)
WHITE_SPACE = frozenset([*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
                         0x2028, 0x2029, 0x202F, 0x205F, 0x3000])
BYTE_CHARS = bytes_to_unicode()
Piece = Tuple[int, str]          # (offset in the normalized text, text)


def is_whitespace(c: str) -> bool:
    return ord(c) in WHITE_SPACE


def _byte_of(token: str) -> Optional[int]:
    """The byte of a ``<0xNN>`` byte-fallback token, else None."""
    if len(token) == 6 and token.startswith("<0x") and token.endswith(">"):
        try:
            return int(token[3:5], 16)
        except ValueError:
            return None
    return None


def _byte_fallback(tokens: List[str]) -> List[str]:
    """Each run of byte tokens as the UTF-8 text of its bytes; a run that
    is not valid UTF-8 as one U+FFFD per byte (``tokenizers``' ByteFallback)."""
    out: List[str] = []
    run = bytearray()

    def flush():
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" * len(run))
            run.clear()

    for tok in tokens:
        byte = _byte_of(tok)
        if byte is None:
            flush()
            out.append(tok)
        else:
            run.append(byte)
    flush()
    return out


def _strip(text: str, content: str, start: int, stop: int) -> str:
    """Up to ``start`` leading and ``stop`` trailing ``content`` characters
    removed (``tokenizers``' Strip decoder)."""
    lo = 0
    while lo < min(start, len(text)) and text[lo] == content:
        lo += 1
    hi = len(text)
    while len(text) - hi < stop and hi > lo and text[hi - 1] == content:
        hi -= 1
    return text[lo:hi]


def _merge_loop(symbols: List[str], best: Callable[[str, str], Optional[Tuple]],
                join: Callable[[str, str], str] = str.__add__) -> List[str]:
    """Merge adjacent symbols while any pair is mergeable: each round takes
    the pair with the smallest ``best`` key (its first element the priority,
    the left position breaking ties) and joins it with ``join``."""
    while len(symbols) > 1:
        cands = [(key, i) for i in range(len(symbols) - 1)
                 if (key := best(symbols[i], symbols[i + 1])) is not None]
        if not cands:
            break
        _, i = min(cands)
        symbols[i:i + 2] = [join(symbols[i], symbols[i + 1])]
    return symbols


# ---------------------------------------------------------------- regular expressions

@functools.lru_cache(maxsize=None)
def _class_body(name: str) -> str:
    """The body of a character class holding every code point of ``name``:
    a general category (``L``, ``Lu``, ``N``, ...), ``s`` (White_Space),
    ``w`` (Oniguruma's Unicode word characters: letters, marks, numbers,
    connector punctuation) or ``rust_w`` (the Rust regex crate's, which
    ``tokenizers``' Whitespace pre-tokenizer uses: Alphabetic, marks,
    decimal digits, connector punctuation, the joiners; Alphabetic taken as
    letters, letter numbers and the circled and squared Latin letters)."""
    if name == "s":
        members = sorted(WHITE_SPACE)
    else:
        if name == "w":
            def test(cp, cat):
                return cat[0] in "LMN" or cat == "Pc"
        elif name == "rust_w":
            def test(cp, cat):
                return (cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or cp in (0x200C, 0x200D)
                        or 0x24B6 <= cp <= 0x24E9 or 0x1F130 <= cp <= 0x1F149
                        or 0x1F150 <= cp <= 0x1F169 or 0x1F170 <= cp <= 0x1F189)
        else:
            def test(cp, cat):
                return cat.startswith(name)
        members = [cp for cp in range(sys.maxunicode + 1)
                   if test(cp, unicodedata.category(chr(cp)))]
    ranges, start, prev = [], None, None
    for cp in members:
        if start is None:
            start = prev = cp
        elif cp == prev + 1:
            prev = cp
        else:
            ranges.append((start, prev))
            start = prev = cp
    if start is not None:
        ranges.append((start, prev))

    def esc(cp):
        return f"\\U{cp:08x}"
    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}" for a, b in ranges)


_PROPERTY = re.compile(r"\{\^?([A-Za-z_]+)\}")
_CATEGORY_NAMES = {"Letter": "L", "Number": "N", "Mark": "M", "Punctuation": "P",
                   "Symbol": "S", "Separator": "Z", "Other": "C"}


def _escape_class(pattern: str, i: int) -> Tuple[str, int, bool]:
    """The class body of the escape at pattern[i] (just after the
    backslash) when it names a class, its end, and whether it is
    negated; ('', i, False) otherwise."""
    c = pattern[i]
    if c in "pP":
        m = _PROPERTY.match(pattern, i + 1)
        if not m:
            raise NotImplementedError(f"regex property at {pattern[i - 1:i + 8]!r}")
        name = _CATEGORY_NAMES.get(m.group(1), m.group(1))
        if not (len(name) in (1, 2) and name[0] in "LMNPSZC"):
            raise NotImplementedError(f"regex property \\{c}{{{m.group(1)}}}; only general "
                                      "categories")
        negated = (c == "P") != pattern[i + 2:i + 3].startswith("^")
        return _class_body(name), m.end(), negated
    if c in "sSwW":
        return _class_body(c.lower()), i + 1, c.isupper()
    return "", i, False


def _parse_class(pattern: str, i: int) -> Tuple[str, bool, int]:
    """Parse the class opening at pattern[i] ('['): (body, negated, end)."""
    i += 1
    negated = pattern[i:i + 1] == "^"
    i += negated
    body, first = [], True
    while i < len(pattern):
        c = pattern[i]
        if c == "]" and not first:
            return "".join(body), negated, i + 1
        first = False
        if c == "\\":
            cls, end, neg = _escape_class(pattern, i + 1)
            if end != i + 1:
                if neg:
                    raise NotImplementedError(f"negated class escape inside a class in {pattern!r}")
                body.append(cls)
                i = end
                continue
            body.append(pattern[i:i + 2])
            i += 2
        elif c == "[":
            inner, inner_neg, i = _parse_class(pattern, i)
            if inner_neg:
                raise NotImplementedError(f"negated class nested in a class in {pattern!r}")
            body.append(inner)
        else:
            body.append("\\" + c if c.isascii() and not c.isalnum() and c != "-" else c)
            i += 1
    raise ValueError(f"unterminated character class in {pattern!r}")


@functools.lru_cache(maxsize=None)
def translate_regex(pattern: str) -> "re.Pattern":
    """An Oniguruma pattern (as ``tokenizers`` compiles it) as a compiled
    Python ``re`` pattern."""
    out, i = [], 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            cls, end, neg = _escape_class(pattern, i + 1)
            if end != i + 1:
                out.append(f"[{'^' if neg else ''}{cls}]")
                i = end
                continue
            out.append(pattern[i:i + 2])
            i += 2
        elif c == "[":
            body, neg, i = _parse_class(pattern, i)
            out.append(f"[{'^' if neg else ''}{body}]")
        else:
            out.append(c)
            i += 1
    return re.compile("".join(out))


def _pattern(spec: dict) -> "re.Pattern":
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    if "Regex" in spec:
        return translate_regex(spec["Regex"])
    raise NotImplementedError(f"pattern {spec!r}; only String and Regex")


# ---------------------------------------------------------------- grapheme clusters

def _hangul(cp: int) -> Optional[str]:
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    return None


def _is_extend(c: str) -> bool:
    cp = ord(c)
    return (unicodedata.category(c) in ("Mn", "Me", "Mc") or cp in (0x200C, 0x200D)
            or 0xFE00 <= cp <= 0xFE0F or 0x1F3FB <= cp <= 0x1F3FF or 0xE0020 <= cp <= 0xE007F)


def _is_control(c: str) -> bool:
    return (unicodedata.category(c) in ("Cc", "Zl", "Zp", "Cs")
            or (unicodedata.category(c) == "Cf" and ord(c) not in (0x200C, 0x200D)))


def _is_pictographic(c: str) -> bool:
    cp = ord(c)
    return (0x1F000 <= cp <= 0x1FAFF or 0x2600 <= cp <= 0x27BF or 0x2190 <= cp <= 0x21FF
            or 0x2300 <= cp <= 0x23FF or 0x2B00 <= cp <= 0x2BFF or cp in (0xA9, 0xAE, 0x203C,
                                                                          0x2049, 0x2122))


def graphemes(text: str) -> List[str]:
    """``text`` cut into (approximate) extended grapheme clusters."""
    out: List[str] = []
    for c in text:
        if out:
            prev = out[-1][-1]
            joined = (
                (prev == "\r" and c == "\n")
                or (not _is_control(prev) and c not in "\r\n" and not _is_control(c)
                    and (_is_extend(c)
                         or (prev == "\u200d" and _is_pictographic(c))
                         or (_hangul(ord(prev)) in ("L",) and _hangul(ord(c)) in ("L", "V", "LV", "LVT"))
                         or (_hangul(ord(prev)) in ("LV", "V") and _hangul(ord(c)) in ("V", "T"))
                         or (_hangul(ord(prev)) in ("LVT", "T") and _hangul(ord(c)) == "T")
                         or (0x1F1E6 <= ord(prev) <= 0x1F1FF and 0x1F1E6 <= ord(c) <= 0x1F1FF
                             and sum(0x1F1E6 <= ord(x) <= 0x1F1FF for x in out[-1]) % 2 == 1))))
            if joined:
                out[-1] += c
                continue
        out.append(c)
    return out


# ---------------------------------------------------------------- Precompiled

class Precompiled:
    """SentencePiece's ``precompiled_charsmap``: a uint32 trie size, the
    darts-clone double array (uint32 units), then the NUL-terminated
    replacement strings."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob, 0)
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.pool = blob[4 + size:]

    def _prefix_values(self, key: bytes) -> List[int]:
        units = self.units
        pos = (units[0] >> 10) << ((units[0] & (1 << 9)) >> 6)
        out = []
        for c in key:
            pos ^= c
            if pos >= len(units):
                break
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                break
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                out.append(units[pos] & ((1 << 31) - 1))
        return out

    def transform(self, chunk: str) -> Optional[str]:
        """The replacement of ``chunk``'s shortest prefix in the trie (which
        replaces all of ``chunk``), or None."""
        hits = self._prefix_values(chunk.encode("utf-8"))
        if not hits:
            return None
        end = self.pool.find(b"\0", hits[0])
        return self.pool[hits[0]:end if end >= 0 else len(self.pool)].decode("utf-8")

    def __call__(self, text: str) -> str:
        out = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for c in g:
                norm = self.transform(c)
                out.append(c if norm is None else norm)
        return "".join(out)


def build_precompiled_charsmap(mapping: Dict[str, str]) -> bytes:
    """A ``precompiled_charsmap`` blob for ``mapping`` (source string ->
    replacement), built as a darts-clone double array: for writing small
    tokenizer files (tests, seeded model directories)."""
    pool, offsets = bytearray(), {}
    for key in sorted(mapping):
        offsets[key] = len(pool)
        pool += mapping[key].encode("utf-8") + b"\0"
    trie: dict = {}
    for key in mapping:
        node = trie
        for b in key.encode("utf-8"):
            node = node.setdefault(b, {})
        node[None] = offsets[key]
    units = [0]
    used, bases = {0}, set()          # positions taken; bases taken (one node each)

    def place(node, pos):
        labels = sorted(k for k in node if k is not None)
        if None in node:
            labels = [0] + labels
        base = 1
        while base in bases or any(base ^ c in used for c in labels):
            base += 1
        bases.add(base)
        offset = pos ^ base
        assert offset < 1 << 21
        units[pos] = (units[pos] & ((1 << 31) | (1 << 8) | 0xFF)) | (offset << 10)
        need = max(base ^ c for c in labels) + 1
        units.extend([0] * (need - len(units)))
        for c in labels:
            used.add(base ^ c)
        if None in node:
            units[base] = node[None] | (1 << 31)
        for c in labels:
            if c == 0 and None in node:
                continue
            child = base ^ c
            units[child] = c | ((1 << 8) if None in node[c] else 0)
            place(node[c], child)

    place(trie, 0)
    units.extend([0] * (-len(units) % 256))      # whole blocks: a lookup XORs within one
    blob = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(blob)) + blob + bytes(pool)


# ---------------------------------------------------------------- normalizers

def _bert_normalizer(spec: dict) -> Callable[[str], str]:
    clean, chinese = spec.get("clean_text", True), spec.get("handle_chinese_chars", True)
    lower = spec.get("lowercase", True)
    strip = spec.get("strip_accents")
    strip = lower if strip is None else strip

    def run(text: str) -> str:
        if clean:
            text = "".join(" " if is_whitespace(c) else c for c in text
                           if not (c in "\0\ufffd" or (c not in "\t\n\r"
                                                       and unicodedata.category(c)[0] == "C")))
        if chinese:
            text = "".join(f" {c} " if is_chinese_char(c) else c for c in text)
        if strip:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        return _lower(text) if lower else text
    return run


def is_chinese_char(c: str) -> bool:
    cp = ord(c)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B920 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _lower(text: str) -> str:
    return "".join(c.lower() for c in text)          # per character, as tokenizers lowercases


def _strip_ws(text: str, left: bool, right: bool) -> str:
    lo, hi = 0, len(text)
    while left and lo < hi and is_whitespace(text[lo]):
        lo += 1
    while right and hi > lo and is_whitespace(text[hi - 1]):
        hi -= 1
    return text[lo:hi]


def normalizer(spec: Optional[dict]) -> Callable[[str], str]:
    if spec is None:
        return lambda text: text
    kind = spec["type"]
    if kind == "Sequence":
        steps = [normalizer(s) for s in spec["normalizers"]]

        def run(text):
            for step in steps:
                text = step(text)
            return text
        return run
    if kind == "BertNormalizer":
        return _bert_normalizer(spec)
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return functools.partial(unicodedata.normalize, kind)
    if kind == "Lowercase":
        return _lower
    if kind == "StripAccents":          # every combining mark (Mn, Mc, Me)
        return lambda text: "".join(c for c in text if unicodedata.category(c)[0] != "M")
    if kind == "Replace":
        pat = _pattern(spec["pattern"])
        return lambda text: pat.sub(lambda _: spec["content"], text)
    if kind == "Prepend":
        return lambda text: spec["prepend"] + text if text else text
    if kind == "Strip":
        return lambda text: _strip_ws(text, spec.get("strip_left", True),
                                      spec.get("strip_right", True))
    if kind == "Precompiled":
        blob = spec["precompiled_charsmap"]
        if isinstance(blob, str):
            blob = base64.b64decode(blob)
        return Precompiled(bytes(blob)) if blob else (lambda text: text)
    raise NotImplementedError(f"tokenizer normalizer {kind!r} is not supported")


# ---------------------------------------------------------------- pre-tokenizers

def _split_spans(text: str, matches: Sequence[Tuple[int, int]], behavior: str,
                 invert: bool = False) -> List[Tuple[int, int]]:
    """``tokenizers``' NormalizedString.split: the spans [start, end) that
    remain of ``text`` cut at ``matches`` by ``behavior``."""
    spans, prev = [], 0
    for s, e in matches:
        if s == e:
            continue
        if prev != s:
            spans.append(((prev, s), False))
        spans.append(((s, e), True))
        prev = e
    if prev != len(text):
        spans.append(((prev, len(text)), False))
    if invert:
        spans = [(o, not m) for o, m in spans]
    out: List[List] = []
    if behavior == "Removed":
        return [o for o, m in spans if not m]
    if behavior == "Isolated":
        return [o for o, _ in spans]
    if behavior == "Contiguous":
        prev_match = False
        for (s, e), m in spans:
            if m == prev_match and out:
                out[-1][1] = e
            else:
                out.append([s, e])
            prev_match = m
    elif behavior == "MergedWithPrevious":
        prev_match = False
        for (s, e), m in spans:
            if m and not prev_match and out:
                out[-1][1] = e
            else:
                out.append([s, e])
            prev_match = m
    elif behavior == "MergedWithNext":
        prev_match = False
        for (s, e), m in reversed(spans):
            if m and not prev_match and out:
                out[-1][0] = s
            else:
                out.append([s, e])
            prev_match = m
        out.reverse()
    else:
        raise NotImplementedError(f"split behavior {behavior!r}")
    return [tuple(o) for o in out]


def _split_pieces(pieces: List[Piece], find: Callable[[str], List[Tuple[int, int]]],
                  behavior: str, invert: bool = False) -> List[Piece]:
    out = []
    for off, text in pieces:
        for s, e in _split_spans(text, find(text), behavior, invert):
            if e > s:
                out.append((off + s, text[s:e]))
    return out


def _char_matches(pred: Callable[[str], bool]) -> Callable[[str], List[Tuple[int, int]]]:
    return lambda text: [(i, i + 1) for i, c in enumerate(text) if pred(c)]


def _regex_matches(pat: "re.Pattern") -> Callable[[str], List[Tuple[int, int]]]:
    return lambda text: [m.span() for m in pat.finditer(text)]


GPT2_SPLIT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def is_bert_punctuation(c: str) -> bool:
    return (c.isascii() and not c.isalnum() and c.isprintable() and not c.isspace()) \
        or unicodedata.category(c).startswith("P")


def _byte_level(text: str) -> str:
    return "".join(BYTE_CHARS[b] for b in text.encode("utf-8"))


def _prepend_scheme(spec: dict) -> str:
    if "prepend_scheme" in spec:
        return spec["prepend_scheme"]
    return "always" if spec.get("add_prefix_space", True) else "never"


def pre_tokenizer(spec: Optional[dict]) -> Callable[[List[Piece]], List[Piece]]:
    if spec is None:
        return lambda pieces: pieces
    kind = spec["type"]
    if kind == "Sequence":
        steps = [pre_tokenizer(s) for s in spec["pretokenizers"]]

        def run(pieces):
            for step in steps:
                pieces = step(pieces)
            return pieces
        return run
    if kind == "BertPreTokenizer":
        return lambda pieces: _split_pieces(
            _split_pieces(pieces, _char_matches(is_whitespace), "Removed"),
            _char_matches(is_bert_punctuation), "Isolated")
    if kind == "WhitespaceSplit":
        return lambda pieces: _split_pieces(pieces, _char_matches(is_whitespace), "Removed")
    if kind == "Whitespace":
        w, ws = _class_body("rust_w"), _class_body("s")
        find = _regex_matches(re.compile(f"[{w}]+|[^{w}{ws}]+"))
        return lambda pieces: _split_pieces(pieces, find, "Removed", invert=True)
    if kind == "Split":
        find = _regex_matches(_pattern(spec["pattern"]))
        return lambda pieces: _split_pieces(pieces, find, spec["behavior"],
                                            spec.get("invert", False))
    if kind == "ByteLevel":
        prefix, use_regex = spec.get("add_prefix_space", True), spec.get("use_regex", True)
        find = _regex_matches(translate_regex(GPT2_SPLIT))

        def run(pieces):
            if prefix:
                pieces = [(o, t if t.startswith(" ") else " " + t) for o, t in pieces]
            if use_regex:
                pieces = _split_pieces(pieces, find, "Isolated")
            return [(o, _byte_level(t)) for o, t in pieces]
        return run
    if kind == "Metaspace":
        rep, scheme, split = spec.get("replacement", SPACE), _prepend_scheme(spec), \
            spec.get("split", True)

        def run(pieces):
            out = []
            for off, text in pieces:
                text = text.replace(" ", rep)
                if (scheme == "always" or (scheme == "first" and off == 0)) \
                        and not text.startswith(rep):
                    text = rep + text
                if split:
                    out += _split_pieces([(off, text)], _char_matches(lambda c: c == rep),
                                         "MergedWithNext")
                elif text:
                    out.append((off, text))
            return out
        return run
    raise NotImplementedError(f"tokenizer pre_tokenizer {kind!r} is not supported")


# ---------------------------------------------------------------- models

class WordPiece:
    def __init__(self, spec: dict):
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.unk = spec.get("unk_token", "[UNK]")
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = spec.get("max_input_chars_per_word", 100)

    def encode(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self.vocab[self.unk]]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                sub = word[start:end] if start == 0 else self.prefix + word[start:end]
                if sub in self.vocab:
                    ids.append(self.vocab[sub])
                    break
                end -= 1
            if end == start:
                return [self.vocab[self.unk]]
            start = end
        return ids


class BPE:
    def __init__(self, spec: dict):
        if spec.get("dropout"):
            raise NotImplementedError("tokenizer BPE dropout is not supported")
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in spec["merges"]]
        self.ranks = {pair: r for r, pair in enumerate(merges)}
        self.unk = spec.get("unk_token")
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        self.fuse_unk = spec.get("fuse_unk", False)
        self.byte_fallback = spec.get("byte_fallback", False)
        self.ignore_merges = spec.get("ignore_merges", False)

    def _merged(self, a: str, b: str) -> str:
        return a + (b[len(self.prefix):] if self.prefix and b.startswith(self.prefix) else b)

    def encode(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        symbols: List[str] = []
        unk_last = False                       # the last symbol is an unknown character's
        for i, c in enumerate(word):
            s = (c if i == 0 else self.prefix + c) + (self.suffix if i == len(word) - 1 else "")
            known = s in self.vocab
            if known:
                symbols.append(s)
            elif self.byte_fallback and all(f"<0x{b:02X}>" in self.vocab for b in s.encode()):
                symbols += [f"<0x{b:02X}>" for b in s.encode()]
                known = True
            elif self.unk is None:
                continue                       # dropped, as tokenizers drops it
            elif not (self.fuse_unk and unk_last):
                symbols.append(self.unk)
            unk_last = not known
        symbols = _merge_loop(symbols, lambda a, b: (
            (self.ranks[(a, b)],) if (a, b) in self.ranks else None), self._merged)
        return [self.vocab[s] for s in symbols]


class Unigram:
    UNK_PENALTY = 10.0

    def __init__(self, spec: dict):
        self.pieces = [(p, float(s)) for p, s in spec["vocab"]]
        self.vocab = {p: i for i, (p, _) in enumerate(self.pieces)}
        self.unk_id = spec.get("unk_id")
        self.byte_fallback = spec.get("byte_fallback", False)
        self.min_score = min(s for _, s in self.pieces)
        self.max_len = max(len(p) for p, _ in self.pieces)

    def _strings(self, text: str) -> List[str]:
        """The best segmentation of ``text``, runs of unknown characters
        fused (``tokenizers``' encode_optimized)."""
        n = len(text)
        best: List[Optional[Tuple[float, int, int]]] = [None] * (n + 1)   # (score, start, id)
        best[0] = (0.0, 0, -1)
        unk_score = self.min_score - self.UNK_PENALTY
        for start in range(n):
            here = best[start][0]
            single = False
            for end in range(start + 1, min(n, start + self.max_len) + 1):
                pid = self.vocab.get(text[start:end])
                if pid is None:
                    continue
                cand = here + self.pieces[pid][1]
                if best[end] is None or cand > best[end][0]:
                    best[end] = (cand, start, pid)
                single = single or end == start + 1
            if not single:
                if self.unk_id is None:
                    raise KeyError(f"{text[start]!r} has no piece and the Unigram model no unk_id")
                cand = here + unk_score
                if best[start + 1] is None or cand > best[start + 1][0]:
                    best[start + 1] = (cand, start, self.unk_id)
        out, unk_run, end = [], [], n
        while end > 0:
            _, start, pid = best[end]
            if pid == self.unk_id:
                unk_run.append(text[start:end])
            else:
                if unk_run:
                    out.append("".join(reversed(unk_run)))
                    unk_run = []
                out.append(text[start:end])
            end = start
        if unk_run:
            out.append("".join(reversed(unk_run)))
        return out[::-1]

    def encode(self, word: str) -> List[int]:
        ids = []
        for s in self._strings(word):
            if s in self.vocab:
                ids.append(self.vocab[s])
            elif self.byte_fallback and all(f"<0x{b:02X}>" in self.vocab for b in s.encode()):
                ids += [self.vocab[f"<0x{b:02X}>"] for b in s.encode()]
            else:
                ids.append(self.unk_id)
        return ids


def model(spec: dict):
    kind = spec.get("type")
    if kind == "WordPiece":
        return WordPiece(spec)
    if kind == "BPE":
        return BPE(spec)
    if kind == "Unigram":
        return Unigram(spec)
    raise NotImplementedError(f"tokenizer model {kind!r} is not supported")


# ---------------------------------------------------------------- post-processors

def post_processor(spec: Optional[dict]) -> Callable[[List[int]], List[int]]:
    if spec is None:
        return lambda ids: ids
    kind = spec["type"]
    if kind == "Sequence":
        steps = [post_processor(s) for s in spec["processors"]]

        def run(ids):
            for step in steps:
                ids = step(ids)
            return ids
        return run
    if kind == "ByteLevel":
        return lambda ids: ids
    if kind in ("BertProcessing", "RobertaProcessing"):
        cls, sep = spec["cls"][1], spec["sep"][1]
        return lambda ids: [cls] + ids + [sep]
    if kind == "TemplateProcessing":
        specials = {name: tok["ids"] for name, tok in spec["special_tokens"].items()}
        parts = []
        for item in spec["single"]:
            if "SpecialToken" in item:
                parts.append(specials[item["SpecialToken"]["id"]])
            elif item["Sequence"]["id"] == "A":
                parts.append(None)
            else:
                raise NotImplementedError(f"template piece {item!r} in a single sequence")
        return lambda ids: [i for p in parts for i in (ids if p is None else p)]
    raise NotImplementedError(f"tokenizer post_processor {kind!r} is not supported")


# ---------------------------------------------------------------- decoders

_CLEANUPS = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
             (" 'm", "'m"), (" do not", " don't"), (" 's", "'s"), (" 've", "'ve"),
             (" 're", "'re"))


def _cleanup(text: str) -> str:
    for a, b in _CLEANUPS:
        text = text.replace(a, b)
    return text


def _byte_level_decode(tokens: List[str]) -> List[str]:
    raw = bytearray()
    for t in tokens:
        try:
            raw += bytes(CHAR_BYTES[c] for c in t)
        except KeyError:
            raw += t.encode("utf-8")
    return [raw.decode("utf-8", errors="replace")]


def decoder(spec: Optional[dict]) -> Callable[[List[str]], List[str]]:
    """A decode chain step: token strings -> strings (joined at the end)."""
    if spec is None:
        return lambda tokens: [" ".join(tokens)]
    kind = spec["type"]
    if kind == "Sequence":
        steps = [decoder(s) for s in spec["decoders"]]

        def run(tokens):
            for step in steps:
                tokens = step(tokens)
            return tokens
        return run
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "WordPiece":
        prefix, cleanup = spec.get("prefix", "##"), spec.get("cleanup", True)

        def run(tokens):
            out = []
            for i, t in enumerate(tokens):
                if i:
                    t = t.replace(prefix, "", 1) if t.startswith(prefix) else " " + t
                out.append(_cleanup(t) if cleanup else t)
            return out
        return run
    if kind == "Metaspace":
        rep, scheme = spec.get("replacement", SPACE), _prepend_scheme(spec)
        return lambda tokens: [
            t.replace(rep, "") if i == 0 and scheme != "never" else t.replace(rep, " ")
            for i, t in enumerate(tokens)]
    if kind == "BPEDecoder":
        suffix = spec.get("suffix", "</w>")
        return lambda tokens: [t.replace(suffix, "" if i == len(tokens) - 1 else " ")
                               for i, t in enumerate(tokens)]
    if kind == "Replace" and "String" in spec["pattern"]:
        return lambda tokens: [t.replace(spec["pattern"]["String"], spec["content"])
                               for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        return lambda tokens: [_strip(t, spec["content"], spec["start"], spec["stop"])
                               for t in tokens]
    raise NotImplementedError(f"tokenizer decoder {kind!r} is not supported")


# ---------------------------------------------------------------- the tokenizer

class HFTokenizer:
    """``tok(text)["input_ids"]`` and ``tok.decode(ids)`` of a
    ``tokenizer.json`` spec (a dict)."""

    def __init__(self, spec: dict):
        self.normalize = normalizer(spec.get("normalizer"))
        self.pre_tokenize = pre_tokenizer(spec.get("pre_tokenizer"))
        self.model = model(spec["model"])
        self.post_process = post_processor(spec.get("post_processor"))
        self.decoder_spec, self.decode_chain = spec.get("decoder"), None
        self.tokens = {i: t for t, i in self.model.vocab.items()}
        for tok in spec.get("added_tokens") or []:
            self.tokens[tok["id"]] = tok["content"]
        self.vocab = {t: i for i, t in self.tokens.items()}

    @classmethod
    def from_file(cls, path: str) -> "HFTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    def encode(self, text: str) -> List[int]:
        """The ids of ``text`` without the post-processor's special tokens."""
        pieces = self.pre_tokenize([(0, self.normalize(text))])
        return [i for _, piece in pieces for i in self.model.encode(piece)]

    def __call__(self, text: str) -> Dict[str, List[int]]:
        return {"input_ids": self.post_process(self.encode(text))}

    def convert_ids_to_tokens(self, ids) -> List[str]:
        return [self.tokens[int(i)] for i in ids if int(i) in self.tokens]

    def decode_tokens(self, tokens: List[str]) -> str:
        """The decoder's text of token strings (the decoder is read at the
        first call, so a file whose decoder is not read still encodes)."""
        if self.decode_chain is None:
            self.decode_chain = decoder(self.decoder_spec)
        return "".join(self.decode_chain(tokens))

    def decode(self, ids) -> str:
        """The text of ``ids``, special tokens kept."""
        return self.decode_tokens(self.convert_ids_to_tokens(ids))


def read_tokenizer_json(model_dir: str) -> HFTokenizer:
    return HFTokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))
