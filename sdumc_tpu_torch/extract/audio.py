"""Audio feature extraction: raw wav -> WavLM layer-tap features.

The port of ``sdumc_tpu/extract/audio.py``. Reference
(feature_extraction/audio/extract_transformers_embedding.py): one wav at a
time through HF, ``hidden_states`` summed over ``layer_ids=[-5]`` (:125),
FRAME keeps [T, 1024], UTTERANCE mean-pools (:100-108), output directory
``{model}-FRA_-5`` (:137-138).

Wavs are normalised per clip (zero mean, unit variance, as
Wav2Vec2FeatureExtractor does), grouped by length under a frame budget,
zero-padded to a sample bucket and run as batches with a frame mask, which
gives the per-clip outputs. On the card every attention layer runs the
hand-written kernel (``attention_impl="auto"``). ``--dtype bfloat16`` casts
the weights and the waves to bf16, as JAX's extractor does: the attention
then runs the kernel's bf16 instance (its plain version on the CPU), cuBLAS
reduces the bf16 products in f32, and the taps are summed in f32.

    python -m sdumc_tpu_torch.cli.extract audio --model_dir DIR --audio_dir WAVS \
        --save_dir OUT [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import time
import wave
from typing import List, Sequence

import numpy as np
import torch

SAMPLE_RATE = 16000      # WavLM's input rate
BUCKETS = (40000, 80000, 160000, 320000, 640000)


def read_wav(path: str) -> np.ndarray:
    """Minimal 16- or 32-bit PCM wav reader (stdlib ``wave``)."""
    with wave.open(path, "rb") as f:
        n = f.getnframes()
        width = f.getsampwidth()
        raw = f.readframes(n)
    if width == 2:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if width == 4:
        return np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    raise ValueError(f"unsupported sample width {width} in {path}")


def zero_mean_unit_var(x: np.ndarray) -> np.ndarray:
    """Wav2Vec2FeatureExtractor's do_normalize (the reference's processor
    call at extract_transformers_embedding.py:76-82)."""
    return (x - x.mean()) / np.sqrt(x.var() + 1e-7)


def plan_batches(cfg, lengths: Sequence[int], batch_size: int,
                 buckets: Sequence[int] = BUCKETS) -> List[List[int]]:
    """Clip indices per batch: clips in order of length, at most
    ``batch_size`` per batch and at most the frames of ``batch_size`` clips of
    the second bucket (a clip longer than that runs alone)."""
    frame_budget = batch_size * cfg.output_length(buckets[1])
    chunks: List[List[int]] = []
    cur: List[int] = []
    for i in np.argsort(lengths, kind="stable"):
        t = cfg.output_length(lengths[i])
        cap = max(1, frame_budget // max(t, 1))
        if cur and len(cur) >= max(1, min(batch_size, cap)):
            chunks.append(cur)
            cur = []
        cur.append(int(i))
    if cur:
        chunks.append(cur)
    return chunks


def extract_audio_features(
    model,
    cfg,
    wavs: List[np.ndarray],
    *,
    layer_ids: Sequence[int] = (-5,),
    feature_level: str = "FRAME",
    batch_size: int = 8,
    buckets: Sequence[int] = BUCKETS,
    dtype: str = "float32",
    device=None,
) -> List[np.ndarray]:
    """One [T_i, D] (or [D] for UTTERANCE) f32 array per input wav. The
    model is moved to ``device`` (default: where its weights are) and cast
    to ``dtype`` ("float32" or "bfloat16") in place."""
    from sdumc_tpu_torch.cli.common import bf16_full_precision_reduction

    wd = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    n_taps = cfg.num_layers + 1
    idxs = sorted({i % n_taps for i in layer_ids if -n_taps <= i < n_taps})
    if not idxs:
        raise ValueError(f"layer_ids {tuple(layer_ids)} select none of the {n_taps} taps")
    device = torch.device(device) if device is not None else next(model.parameters()).device
    model.to(device=device, dtype=wd)
    results: List = [None] * len(wavs)
    with torch.inference_mode(), bf16_full_precision_reduction():
        for chunk in plan_batches(cfg, [len(w) for w in wavs], batch_size, buckets):
            group = [zero_mean_unit_var(wavs[i]) for i in chunk]
            maxlen = max(len(w) for w in group)
            bucket = next((b for b in buckets if maxlen <= b), maxlen)
            batch = np.zeros((len(group), bucket), np.float32)
            frame_len = [cfg.output_length(len(w)) for w in group]
            mask = np.zeros((len(group), cfg.output_length(bucket)), bool)
            for j, w in enumerate(group):
                batch[j, : len(w)] = w
                mask[j, : frame_len[j]] = True
            out = model(torch.from_numpy(batch).to(device, wd),
                        pad_mask=torch.from_numpy(mask).to(device), output_hidden_states=True)
            hs = out["hidden_states"]
            feats = sum(hs[i].float() for i in idxs).cpu().numpy()
            for j, i in enumerate(chunk):
                f = feats[j, : frame_len[j]]
                if feature_level == "UTTERANCE":
                    f = f.mean(axis=0)
                results[i] = f.astype(np.float32)
    return results


def main(argv=None):
    """Extract every ``*.wav`` of --audio_dir into
    ``{save_dir}/{model}-{LEVEL[:3]}_{layer}/{vid}.npy``. Returns a summary:
    the output directory, clip and batch counts, the extraction's host-clock
    seconds (weights already on the device) and the audio seconds."""
    from sdumc_tpu_torch.cli.common import resolve_device, set_matmul_precision
    from sdumc_tpu_torch.convert.hf_wavlm import load_hf_wavlm

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_dir", type=str, required=True,
                        help="HF-format WavLM directory (config.json + weights)")
    parser.add_argument("--audio_dir", type=str, required=True)
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--model_name", type=str, default="wavlm-large")
    parser.add_argument("--feature_level", type=str, default="FRAME",
                        choices=["FRAME", "UTTERANCE"])
    parser.add_argument("--layer_ids", type=str, default="-5")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--attention_impl", type=str, default="auto",
                        choices=["auto", "einsum", "flash"],
                        help="auto = the hand-written kernel on CUDA; on the CPU einsum "
                             "at float32, the kernel's plain version at bfloat16")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="bfloat16 casts the weights and the waves to bf16 (the "
                             "kernel's bf16 instance); float32 matches HF exactly")
    parser.add_argument("--overwrite", action="store_true", default=True)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (the default) raises when no card is present")
    parser.add_argument("--matmul_precision", type=str, default="highest",
                        choices=["default", "high", "highest"],
                        help="highest keeps matmuls and convolutions in true f32 "
                             "(TF32 off); the others allow TF32")
    args = parser.parse_args(argv)

    layer_ids = tuple(int(x) for x in args.layer_ids.split(","))
    device = resolve_device(args.device)
    set_matmul_precision(args.matmul_precision)
    cfg, model = load_hf_wavlm(args.model_dir, attention_impl=args.attention_impl)
    model.to(device)

    audio_files = sorted(glob.glob(os.path.join(args.audio_dir, "*.wav")))
    print(f'Find total "{len(audio_files)}" audio files.')
    # output dir naming parity: {model}-{LEVEL[:3]}_{layer} (:137-138)
    dir_name = args.model_name if len(layer_ids) == 1 else f"{args.model_name}-{len(layer_ids)}"
    dir_name = f"{dir_name}-{args.feature_level[:3]}_{layer_ids[0]}"
    save_dir = os.path.join(args.save_dir, dir_name)
    os.makedirs(save_dir, exist_ok=True)

    t0 = time.perf_counter()
    wavs = [read_wav(f) for f in audio_files]
    feats = extract_audio_features(
        model, cfg, wavs, layer_ids=layer_ids, feature_level=args.feature_level,
        batch_size=args.batch_size, dtype=args.dtype, device=device)
    for f, feat in zip(audio_files, feats):
        vid = os.path.basename(f).split(".")[0]
        np.save(os.path.join(save_dir, f"{vid}.npy"), feat)
    seconds = time.perf_counter() - t0
    print(f"Total time used: {seconds:.1f}s.")
    return {"save_dir": save_dir, "clips": len(wavs),
            "batches": len(plan_batches(cfg, [len(w) for w in wavs], args.batch_size)),
            "seconds": seconds, "audio_seconds": sum(len(w) for w in wavs) / SAMPLE_RATE}
