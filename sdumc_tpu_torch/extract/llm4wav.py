"""The llm4wav bridge: audio-derived pseudo-text (feat4) extraction.

The port of ``sdumc_tpu/extract/llm4wav.py``. Reference
(feature_extraction/llm4wav/extract_wavlm_vicuna.py): per clip, WavLM
features [T, 1024] -> frozen EncoderProjectorConcat (k=5 -> 4096) -> concat
with the tokenized ASR prompt -> frozen Vicuna ``generate`` (beam 4, <=200
new tokens) -> per-step last-4-layer hidden states of the leading beam =
feat4 [n_steps, 4096], saved as ``{clip}.npy`` (:245-264,335-343).

Prompt lengths are grouped into buckets (64, 128, 256, 512; a longer prompt
is its own bucket, as the 60-s clip's 599 projector rows need), prompts are
left-padded to their bucket and ``--gen_batch`` clips of one bucket decode in
lockstep (models/generation.py); a short tail chunk is filled by repeating a
row, whose result is dropped. The projection runs at each clip's exact
length (JAX pads it to a length bucket and slices the same rows back).

``--tp N`` splits Vicuna over N local ranks (``parallel/sharding.py``; the
command starts them, over NCCL when each has a card of its own, over gloo
when they share one or run on the CPU): every rank runs the same beam
bookkeeping on the same gathered logits, the ranks' tokens are checked
equal at the end of each chunk, and rank 0 alone writes the files.
``--quant`` does not combine with it (as in JAX); ``--kv_quant`` does.

    python -m sdumc_tpu_torch.cli.extract feat4 --llm_dir DIR --projector_path P.pt \\
        --wavlm_dir FEATS --save_dir OUT [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

DEFAULT_PROMPT = "Transcribe speech to text. "
PROMPT_BUCKETS = (64, 128, 256, 512)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    return next((b for b in buckets if n <= b), n)


class Feat4Extractor:
    """WavLM features -> projector -> prompt concat -> beam generate -> taps.
    Runs on the device the model's weights are on."""

    def __init__(self, model, projector, tokenizer, *, num_beams: int = 4,
                 max_new_tokens: int = 200, tap_layers=(-4, -3, -2, -1),
                 prompt_buckets: Sequence[int] = PROMPT_BUCKETS, gen_batch: int = 1,
                 axis=None):
        """``axis``: the model axis of a tensor-parallel ``model``, whose
        ranks' tokens are checked equal after each chunk."""
        self.model, self.projector, self.tokenizer = model, projector, tokenizer
        self.axis = axis
        self.cfg = model.cfg
        self.device = model.model.norm.weight.device
        self.num_beams, self.max_new_tokens = num_beams, max_new_tokens
        self.tap_layers = tuple(tap_layers)
        self.prompt_buckets = tuple(prompt_buckets)
        self.gen_batch = max(1, gen_batch)
        self.proj_k = projector.k
        self.eos_id = (getattr(tokenizer, "eos_token_id", 2) or 2) if tokenizer else 2
        ids = tokenizer(DEFAULT_PROMPT)["input_ids"] if tokenizer else []
        embed = model.model.embed_tokens          # a module call: a split embedding gathers
        with torch.no_grad():
            self._prompt_embeds = (embed(torch.as_tensor(ids, dtype=torch.long,
                                                         device=self.device)).float()
                                   if len(ids) else
                                   torch.zeros(0, self.cfg.hidden_size, device=self.device))
        self.n_prompt_tokens = len(ids)

    def prompt_len_for(self, n_frames: int) -> int:
        """Real prompt length of a [T, 1024] clip (projector rows + prompt
        tokens), known from the npy header alone."""
        return n_frames // self.proj_k + self.n_prompt_tokens

    def _padded_prompt(self, feats: np.ndarray, bucket: int) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(feats, np.float32))[None].to(self.device)
        full = torch.cat([self.projector(x)[0], self._prompt_embeds], dim=0)
        out = torch.zeros(bucket, full.shape[1], device=self.device)
        out[bucket - len(full):] = full          # LEFT pad (masked out of keys)
        return out

    def extract_many(self, feats_list: List[np.ndarray]) -> List[dict]:
        """Clips grouped by prompt bucket and decoded ``gen_batch`` at a time;
        one dict per clip: taps [n_steps, D] f32, tokens, n_tokens."""
        from sdumc_tpu_torch.models.generation import beam_generate_batched

        results: List[Optional[dict]] = [None] * len(feats_list)
        by_bucket: Dict[int, List[int]] = {}
        for i, feats in enumerate(feats_list):
            n_real = self.prompt_len_for(len(feats))
            by_bucket.setdefault(_bucket(n_real, self.prompt_buckets), []).append(i)
        embed = self.model.model.embed_tokens
        C = self.gen_batch
        with torch.inference_mode():
            for bucket, rows in sorted(by_bucket.items()):
                for ofs in range(0, len(rows), C):
                    chunk = rows[ofs:ofs + C]
                    picks = [chunk[min(j, len(chunk) - 1)] for j in range(C)]  # tail: repeat
                    prompts = torch.stack([self._padded_prompt(feats_list[i], bucket)
                                           for i in picks])
                    lens = [self.prompt_len_for(len(feats_list[i])) for i in picks]
                    out = beam_generate_batched(
                        self.model, prompts, self.cfg, embed_fn=embed, prompt_len=lens,
                        num_beams=self.num_beams, max_new_tokens=self.max_new_tokens,
                        eos_id=self.eos_id, tap_layers=self.tap_layers, axis=self.axis)
                    taps, tokens = out["taps"].cpu().numpy(), out["tokens"].cpu().numpy()
                    n_steps, n_tokens = out["n_steps"].tolist(), out["n_tokens"].tolist()
                    for j, i in enumerate(chunk):
                        results[i] = {"taps": taps[j, :n_steps[j]], "tokens": tokens[j],
                                      "n_tokens": n_tokens[j]}
        return results  # type: ignore[return-value]

    def __call__(self, wavlm_feats: np.ndarray) -> dict:
        """[T, 1024] -> dict(taps [n_steps, D], tokens, n_tokens)."""
        return self.extract_many([wavlm_feats])[0]


def extract_feat4_dir(extractor: Feat4Extractor, wavlm_dir: str, save_dir: str,
                      write: bool = True) -> dict:
    """Every ``*.npy`` of ``wavlm_dir`` to ``save_dir/{clip}.npy`` (taps
    [n_steps, D] f32): clips already saved are skipped (the reference's
    resumability, extract_wavlm_vicuna.py:349), the rest grouped by prompt
    bucket (npy headers only) and decoded ``gen_batch`` per chunk. Returns
    the counts and the host-clock seconds. ``write`` False (a
    tensor-parallel rank but 0) decodes the same clips and saves nothing:
    every rank lists the directory before its first chunk, whose
    collectives rank 0 cannot pass before the others reach them, so every
    rank sees what rank 0 saw."""
    os.makedirs(save_dir, exist_ok=True)
    files = sorted(glob.glob(os.path.join(wavlm_dir, "*.npy")))
    t0 = time.perf_counter()
    pending = []
    for path in files:
        clip = os.path.basename(path)[:-4]
        if os.path.exists(os.path.join(save_dir, clip + ".npy")):
            continue
        n_frames = np.load(path, mmap_mode="r").shape[0]
        pending.append((clip, path, extractor.prompt_len_for(n_frames)))
    # bucket-major order keeps the chunks of one bucket full
    pending.sort(key=lambda x: (_bucket(x[2], extractor.prompt_buckets), x[0]))
    steps = 0
    for ofs in range(0, len(pending), extractor.gen_batch):
        group = pending[ofs:ofs + extractor.gen_batch]
        feats = [np.load(p).astype(np.float32) for _, p, _ in group]
        for (clip, _, _), result in zip(group, extractor.extract_many(feats)):
            if write:
                np.save(os.path.join(save_dir, clip + ".npy"), result["taps"].astype(np.float32))
            steps += len(result["taps"])
    seconds = time.perf_counter() - t0
    if write:
        print(f"extracted {len(pending)}/{len(files)} clips in {seconds:.1f}s")
    return {"clips": len(pending), "files": len(files), "steps": steps, "seconds": seconds}


def main(argv=None) -> dict:
    """Parse the flags, load the model, tokenizer and projector, extract a
    directory. Returns ``extract_feat4_dir``'s summary and the save dir.
    With ``--tp N > 1`` it starts the N ranks and returns rank 0's result."""
    from sdumc_tpu_torch.cli.common import resolve_device, set_matmul_precision
    from sdumc_tpu_torch.convert.hf_llama import load_hf_llama
    from sdumc_tpu_torch.convert.llama_tokenizer import LlamaTokenizer
    from sdumc_tpu_torch.extract.projector import load_projector
    from sdumc_tpu_torch.parallel import ModelAxis, multihost

    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--llm_dir", type=str, required=True,
                        help="HF-format Vicuna directory: config.json, the weights "
                             "(pytorch_model*.bin or model*.safetensors) and "
                             "tokenizer.json or tokenizer.model")
    parser.add_argument("--projector_path", type=str, required=True)
    parser.add_argument("--wavlm_dir", type=str, required=True)
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--num_beams", type=int, default=4)
    parser.add_argument("--max_new_tokens", type=int, default=200)
    parser.add_argument("--tap_layers", type=str, default="-4,-3,-2,-1")
    parser.add_argument("--gen_batch", type=int, default=4,
                        help="clips decoded in lockstep per chunk")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree: N local processes, one rank each "
                             "(NCCL with a card per rank, else gloo)")
    parser.add_argument("--scan_layers", action=argparse.BooleanOptionalAction, default=True,
                        help="parsed for recipe parity and not read (an XLA compile-size "
                             "option; PyTorch runs the layers eagerly)")
    parser.add_argument("--quant", type=str, default=None, choices=("int8", "w8a8"),
                        help="int8 = weight-only int8 weights; w8a8 = int8 activations "
                             "too, with int8 x int8 -> int32 products; not with --tp > 1")
    parser.add_argument("--kv_quant", type=str, default=None, choices=("int8",),
                        help="int8 KV cache with per-(token, head) scales")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (the default) raises when no card is present")
    parser.add_argument("--tp_worker", type=str, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.tp < 1:
        parser.error(f"--tp {args.tp}: a degree of 1 or more")
    if args.quant and args.tp > 1:
        parser.error("--quant cannot be combined with --tp>1")
    if args.tp > 1 and args.tp_worker is None:
        resolve_device(args.device)                     # no card: raise before any rank starts
        return multihost.run_local_ranks(["feat4"] + argv, args.tp)

    axis = (multihost.join_model_axis(args.tp, args.device) if args.tp > 1
            else ModelAxis(device=resolve_device(args.device)))
    device = axis.device
    set_matmul_precision("highest")
    _, model = load_hf_llama(args.llm_dir, device=device, quant=args.quant,
                             kv_quant=args.kv_quant, axis=axis)
    extractor = Feat4Extractor(
        model, load_projector(args.projector_path, device=device),
        LlamaTokenizer.from_dir(args.llm_dir), num_beams=args.num_beams,
        max_new_tokens=args.max_new_tokens,
        tap_layers=tuple(int(x) for x in args.tap_layers.split(",")),
        gen_batch=args.gen_batch, axis=axis)
    summary = extract_feat4_dir(extractor, args.wavlm_dir, args.save_dir,
                                write=axis.rank == 0)
    result = {**summary, "save_dir": args.save_dir}
    if args.tp_worker is not None:
        multihost.finish_rank(args.tp_worker, axis, result)
    return result
