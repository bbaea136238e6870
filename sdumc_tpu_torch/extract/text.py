"""Text (ground-truth transcript) features from a language model: the
teacher view's text stream.

The port of ``sdumc_tpu/extract/text.py``. Reference (feature_extraction/
text/extract_text_embedding_huggingface.py): per row, tokenizer -> model
forward, hidden states [-4..-1] summed, the special-token span stripped by
a tokenizer probe, fp16 LLMs. The default text stream of the fusion net,
``vicuna-7b-v1.5-FRA-wavlm2vicuna-half-gt``, is Vicuna-7B over the
transcript tapped at layer -3 (``--layer_ids -3``).

``--family`` picks the model, as in JAX: ``llama`` (Vicuna, LLaMA-2,
Alpaca; bf16), ``bert`` (BERT, RoBERTa, MacBERT, SimBERT), ``albert``,
``deberta`` (v1), ``bloom`` and ``glm`` (THUDM chatglm2 and HF-native
GLM), the last five at f32 with TF32 off, as JAX's loaders widen them.
The tokenizer is read from the directory's own files
(``convert/vocab_tokenizers.load_tokenizer``: ``tokenizer.json``,
``vocab.txt``, ``vocab.json`` + ``merges.txt``, ``spiece.model`` or
``tokenizer.model``), where JAX calls ``AutoTokenizer``.

As in JAX: every sentence is tokenized first, rows are grouped into length
buckets (16/32/64/128/256; a longer row runs at its exact length), each
bucket runs in fixed batches of ``batch_size`` rows (the last chunk padded
with dummy rows of length 0). LLaMA runs with positions ``arange(L)`` and a
causal plus key-padding mask, additive at -1e30; the other families take
the key-padding mask ``arange(L) < lengths`` (BLOOM and GLM build their
causal mask from it). Every mask is finite, so a dummy row's softmax is
uniform, not NaN. The tap sum is taken in the model dtype over the
returned hidden states in sorted index order, as JAX sums them. An empty
or NaN transcript gives zeros ([1, D] for FRAME, [D] for UTTERANCE).
UTTERANCE is the mean of the span in f32 (JAX takes it in the model dtype:
for bf16 numpy accumulates in bf16, ROADMAP §3).

``--tp N`` (the llama family; JAX ignores it for the others, the port
raises) splits the trunk over N local ranks (``parallel/sharding.py``):
the command starts N processes (``multihost.run_local_ranks``), over NCCL
when each has a card of its own, over gloo when they share one or run on
the CPU; every rank runs every batch, rank 0 alone writes the files, and
the command returns what ``--tp 1`` returns.

    python -m sdumc_tpu_torch.cli.extract text --model_dir DIR --trans_path CSV \\
        --save_dir OUT [--family bert] [--layer_ids -3] [--tp 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sdumc_tpu_torch.convert import hf_albert, hf_bert, hf_bloom, hf_deberta, hf_glm
from sdumc_tpu_torch.models.llama import NEG_MASK, LlamaModel, tap_indices

BUCKETS = (16, 32, 64, 128, 256)
# --family -> its loader (model_dir, device) -> (config, model), the pad-mask families
LOADERS = {"bert": hf_bert.load_hf_bert, "albert": hf_albert.load_hf_albert,
           "deberta": hf_deberta.load_hf_deberta, "bloom": hf_bloom.load_hf_bloom,
           "glm": hf_glm.load_hf_glm}
FAMILIES = ("llama",) + tuple(LOADERS)


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
    dtype, the selected hidden states summed in sorted order: JAX's two
    runners. A LlamaModel takes a causal plus key-padding mask [B, 1, L, L]
    and positions arange(L); every other family the key-padding mask
    ``arange(L) < lengths``."""
    B, L = ids.shape
    dev = ids.device
    key_valid = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    if isinstance(model, LlamaModel):
        positions = torch.arange(L, device=dev)[None].expand(B, L)
        causal = torch.ones(L, L, dtype=torch.bool, device=dev).tril()
        mask = torch.where(causal[None] & key_valid[:, None, :], 0.0, NEG_MASK)[:, None]
        hs = model(input_ids=ids, positions=positions, attn_mask=mask,
                   output_hidden_states=True)["hidden_states"]
    else:
        hs = model(ids, pad_mask=key_valid, output_hidden_states=True)["hidden_states"]
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
    mean [D] (UTTERANCE). ``model`` is a trunk of one of the families
    (LlamaModel, BertModel, AlbertModel, DebertaModel, BloomModel,
    GlmModel) on the device it runs on."""
    start, end = find_token_span(tokenizer)
    dim = model.cfg.hidden_size
    dev = next(model.parameters()).device
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
    the host-clock seconds of the extraction (weights loaded before it).
    With ``--tp N > 1`` it starts the N ranks and returns rank 0's result."""
    from sdumc_tpu_torch.cli.common import resolve_device, set_matmul_precision
    from sdumc_tpu_torch.convert.hf_llama import load_hf_llama_trunk
    from sdumc_tpu_torch.convert.vocab_tokenizers import load_tokenizer
    from sdumc_tpu_torch.parallel import ModelAxis, multihost

    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_dir", type=str, required=True,
                        help="HF-format model directory of the family: config.json, the "
                             "weights and the tokenizer's files")
    parser.add_argument("--trans_path", type=str, required=True,
                        help="transcription csv (name,sentence)")
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--model_name", type=str, default="vicuna-7b-v1.5",
                        help="parsed for recipe parity and not read (as in JAX)")
    parser.add_argument("--family", type=str, default="llama", choices=list(FAMILIES),
                        help="llama covers vicuna/llama2/alpaca; bert covers "
                             "bert/roberta/macbert/simbert; glm covers chatglm2-6b/glm-4")
    parser.add_argument("--language", type=str, default="english",
                        choices=["english", "chinese"])
    parser.add_argument("--feature_level", type=str, default="FRAME")
    parser.add_argument("--layer_ids", type=str, default="-4,-3,-2,-1")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree of the llama trunk: N local processes, "
                             "one rank each (NCCL with a card per rank, else gloo)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (the default) raises when no card is present")
    parser.add_argument("--tp_worker", type=str, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.tp < 1:
        parser.error(f"--tp {args.tp}: a degree of 1 or more")
    if args.tp > 1 and args.family != "llama":
        raise ValueError(f"--tp {args.tp} splits the llama family only (--family "
                         f"{args.family} runs on one device)")
    if args.tp > 1 and args.tp_worker is None:
        resolve_device(args.device)                     # no card: raise before any rank starts
        return multihost.run_local_ranks(["text"] + argv, args.tp)

    axis = (multihost.join_model_axis(args.tp, args.device) if args.tp > 1
            else ModelAxis(device=resolve_device(args.device)))
    device = axis.device
    set_matmul_precision("highest")
    if args.family == "llama":
        _, model = load_hf_llama_trunk(args.model_dir, device=device, axis=axis)
    else:
        _, model = LOADERS[args.family](args.model_dir, device=device)
    tokenizer = load_tokenizer(args.model_dir)
    rows = read_transcripts(args.trans_path, language=args.language)
    if axis.rank == 0:
        os.makedirs(args.save_dir, exist_ok=True)
    t0 = time.perf_counter()
    feats = extract_text_features(
        model, tokenizer, [s for _, s in rows],
        layer_ids=tuple(int(x) for x in args.layer_ids.split(",")),
        feature_level=args.feature_level, batch_size=args.batch_size)
    result = {"rows": len(rows), "seconds": 0.0, "save_dir": args.save_dir}
    if axis.rank == 0:
        for (name, _), feat in zip(rows, feats):
            np.save(os.path.join(args.save_dir, f"{name}.npy"), feat)
        result["seconds"] = time.perf_counter() - t0
        print(f"extracted {len(rows)} transcripts in {result['seconds']:.1f}s")
    if args.tp_worker is not None:
        multihost.finish_rank(args.tp_worker, axis, result)
    return result
