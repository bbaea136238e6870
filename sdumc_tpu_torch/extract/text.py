"""Text (ground-truth transcript) features from an LLM: the teacher view's
text stream.

The port of ``sdumc_tpu/extract/text.py`` for the LLaMA family (Vicuna,
LLaMA-2, Alpaca). Reference (feature_extraction/text/
extract_text_embedding_huggingface.py): per row, tokenizer -> LLM forward,
hidden states [-4..-1] summed, the special-token span stripped by a
tokenizer probe, fp16 LLMs. The default text stream of the fusion net,
``vicuna-7b-v1.5-FRA-wavlm2vicuna-half-gt``, is Vicuna-7B over the
transcript tapped at layer -3 (``--layer_ids -3``).

As in JAX: every sentence is tokenized first, rows are grouped into length
buckets (16/32/64/128/256; a longer row runs at its exact length), each
bucket runs in fixed batches of ``batch_size`` rows (the last chunk padded
with dummy rows), with positions ``arange(L)`` and a causal plus
key-padding mask, additive at -1e30. The tap sum is taken in the model
dtype (bf16 for Vicuna), over the returned hidden states in sorted index
order, as JAX sums them. An empty or NaN transcript gives zeros ([1, D] for
FRAME, [D] for UTTERANCE). UTTERANCE is the mean of the span in f32 (JAX
takes it in bf16, which numpy accumulates in bf16: ROADMAP §3).

The other families (BERT, ALBERT, DeBERTa, BLOOM, GLM) and ``--tp > 1``
raise, naming their ROADMAP items.

    python -m sdumc_tpu_torch.cli.extract text --model_dir DIR --trans_path CSV \\
        --save_dir OUT [--layer_ids -3] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sdumc_tpu_torch.models.llama import NEG_MASK, tap_indices

BUCKETS = (16, 32, 64, 128, 256)


def find_token_span(tokenizer, probe: str = "today is a good day") -> Tuple[int, int]:
    """Probe the tokenizer for special-token offsets (reference
    find_start_end_pos): returns (start, end) such that ids[start:end or
    None] decodes back to the sentence."""
    ids = tokenizer(probe)["input_ids"]
    target = probe.replace(" ", "")
    for start in range(0, 3):
        if tokenizer.decode(ids[start:]).replace(" ", "") == target:
            return start, 0
        if tokenizer.decode(ids[start:]).replace(" ", "").startswith(target):
            break
    for end in range(-1, -3, -1):
        if tokenizer.decode(ids[start:end]).replace(" ", "") == target:
            return start, end
    raise ValueError("could not locate meaningful token span")


def read_transcripts(csv_path: str, language: str = "english") -> List[Tuple[str, str]]:
    """transcription csv: name + {sentence|english|chinese} columns; the
    column is picked by ``language`` as the reference extractor does."""
    preferred = {"english": ("english", "sentence", "text"),
                 "chinese": ("chinese", "sentence", "text")}[language]
    rows = []
    with open(csv_path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            name = row.get("name") or row.get("video_id") or list(row.values())[0]
            sent = next((row[c] for c in preferred if row.get(c)), None)
            if sent is None:
                sent = list(row.values())[-1]
            rows.append((str(name), str(sent)))
    return rows


def run_batch(model, ids: torch.Tensor, lengths: torch.Tensor,
              layer_ids: Sequence[int]) -> torch.Tensor:
    """(ids [B, L], lengths [B]) -> the tap sum [B, L, D] in the model
    dtype: causal plus key-padding mask [B, 1, L, L], positions arange(L),
    the selected hidden states summed in sorted order."""
    B, L = ids.shape
    dev = ids.device
    positions = torch.arange(L, device=dev)[None].expand(B, L)
    causal = torch.ones(L, L, dtype=torch.bool, device=dev).tril()
    key_valid = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    mask = torch.where(causal[None] & key_valid[:, None, :], 0.0, NEG_MASK)[:, None]
    hs = model(input_ids=ids, positions=positions, attn_mask=mask,
               output_hidden_states=True)["hidden_states"]
    return sum(hs[i] for i in tap_indices(len(hs), layer_ids))


def _is_empty(s) -> bool:
    return s is None or (isinstance(s, float) and np.isnan(s)) or not str(s).strip()


def extract_text_features(
    model,
    tokenizer,
    sentences: List[str],
    *,
    layer_ids: Sequence[int] = (-4, -3, -2, -1),
    feature_level: str = "FRAME",
    buckets: Sequence[int] = BUCKETS,
    batch_size: int = 16,
) -> List[np.ndarray]:
    """One f32 array per sentence: the token span [T, D] (FRAME) or its
    mean [D] (UTTERANCE). ``model`` is a LlamaModel on the device it runs
    on."""
    start, end = find_token_span(tokenizer)
    dim = model.cfg.hidden_size
    dev = model.norm.weight.device
    results: List[Optional[np.ndarray]] = [None] * len(sentences)
    all_ids: List[List[int]] = []
    by_bucket = {}
    for row, s in enumerate(sentences):
        if _is_empty(s):
            results[row] = (np.zeros((1, dim), np.float32) if feature_level == "FRAME"
                            else np.zeros((dim,), np.float32))
            all_ids.append([])
            continue
        ids = tokenizer(str(s))["input_ids"]
        all_ids.append(ids)
        bucket = next((b for b in buckets if len(ids) <= b), len(ids))
        by_bucket.setdefault(bucket, []).append(row)
    with torch.inference_mode():
        for bucket in sorted(by_bucket):
            rows = by_bucket[bucket]
            for ofs in range(0, len(rows), batch_size):
                chunk = rows[ofs:ofs + batch_size]
                ids_np = np.zeros((batch_size, bucket), np.int64)
                len_np = np.zeros((batch_size,), np.int64)
                for j, row in enumerate(chunk):
                    ids_np[j, :len(all_ids[row])] = all_ids[row]
                    len_np[j] = len(all_ids[row])
                feats = run_batch(model, torch.from_numpy(ids_np).to(dev),
                                  torch.from_numpy(len_np).to(dev), layer_ids)
                feats = feats.float().cpu().numpy()
                for j, row in enumerate(chunk):
                    n = len(all_ids[row])
                    span = feats[j, start: n + end if end else n]
                    results[row] = (span.mean(axis=0) if feature_level == "UTTERANCE"
                                    else span.copy())
    return results  # type: ignore[return-value]


def main(argv=None) -> dict:
    """Parse the flags, load the trunk and the tokenizer, extract every row
    of the transcript csv to ``save_dir/{name}.npy``. Returns the counts and
    the host-clock seconds of the extraction (weights loaded before it)."""
    from sdumc_tpu_torch.cli.common import resolve_device, set_matmul_precision
    from sdumc_tpu_torch.convert.hf_llama import load_hf_llama_trunk
    from sdumc_tpu_torch.convert.llama_tokenizer import LlamaTokenizer

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_dir", type=str, required=True,
                        help="HF-format LLaMA directory: config.json, the weights and "
                             "tokenizer.json or tokenizer.model")
    parser.add_argument("--trans_path", type=str, required=True,
                        help="transcription csv (name,sentence)")
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--model_name", type=str, default="vicuna-7b-v1.5",
                        help="parsed for recipe parity and not read (as in JAX)")
    parser.add_argument("--family", type=str, default="llama",
                        choices=["llama", "bert", "albert", "deberta", "bloom", "glm"],
                        help="llama covers vicuna/llama2/alpaca; only llama is ported")
    parser.add_argument("--language", type=str, default="english",
                        choices=["english", "chinese"])
    parser.add_argument("--feature_level", type=str, default="FRAME")
    parser.add_argument("--layer_ids", type=str, default="-4,-3,-2,-1")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree; only 1 is ported")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (the default) raises when no card is present")
    args = parser.parse_args(argv)
    if args.family != "llama":
        raise NotImplementedError(f"--family {args.family} is not ported yet: ROADMAP queue 1, "
                                  "the other text families")
    if args.tp > 1:
        raise NotImplementedError("--tp > 1 is not ported yet: ROADMAP queue 1, multi-device")

    device = resolve_device(args.device)
    set_matmul_precision("highest")
    _, model = load_hf_llama_trunk(args.model_dir, device=device)
    tokenizer = LlamaTokenizer.from_dir(args.model_dir)
    rows = read_transcripts(args.trans_path, language=args.language)
    os.makedirs(args.save_dir, exist_ok=True)
    t0 = time.perf_counter()
    feats = extract_text_features(
        model, tokenizer, [s for _, s in rows],
        layer_ids=tuple(int(x) for x in args.layer_ids.split(",")),
        feature_level=args.feature_level, batch_size=args.batch_size)
    for (name, _), feat in zip(rows, feats):
        np.save(os.path.join(args.save_dir, f"{name}.npy"), feat)
    seconds = time.perf_counter() - t0
    print(f"extracted {len(rows)} transcripts in {seconds:.1f}s")
    return {"rows": len(rows), "seconds": seconds, "save_dir": args.save_dir}
