"""Whisper ASR: a directory of wavs -> transcription.csv, the text stage's
input.

The port of ``sdumc_tpu/extract/asr.py``. It produces the transcripts
behind the reference's ASR text-variant recipes (``-gt(base.en_vad)``):

  wav -> ops/mel.log_mel_spectrogram (the 30-s window) -> WhisperEncoder ->
  greedy decode in lockstep over a batch of clips
  (models/whisper.greedy_transcribe) -> the tokenizer's decode -> a csv
  with an ``english`` column, byte-identical to JAX's and read by
  extract/text.py read_transcripts.

Every clip is padded to the 30-s window, so one batch shape serves every
batch. A span longer than the window (MOSEI's long tail passes 60 s) is
split into window-long pieces whose transcripts re-join in order; with
``--vad`` each voiced segment (``energy_vad``) is decoded on its own and
re-joined the same way. The last batch holds only the pieces left: the rows
of a batch are independent, so it is not padded with silence rows as JAX's
(which keeps one compiled program) is.

    python -m sdumc_tpu_torch.cli.extract asr --model_dir DIR --audio_dir WAVS \\
        --save_csv transcription.csv [--batch 8] [--vad] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from typing import List, Tuple

import numpy as np
import torch

from sdumc_tpu_torch.ops.mel import CHUNK_SECONDS, SAMPLE_RATE

WINDOW = CHUNK_SECONDS * SAMPLE_RATE


def energy_vad(wav: np.ndarray, sr: int = 16000, frame_ms: int = 20,
               threshold_db: float = 12.0, min_voice_ms: int = 200,
               min_gap_ms: int = 300, pad_ms: int = 100) -> List[Tuple[int, int]]:
    """Energy-based voice activity detection -> [(start, end)] in samples.

    A frame is voiced when its RMS energy sits ``threshold_db`` above the
    clip's noise floor (its 10th-percentile frame energy); voiced runs
    shorter than ``min_voice_ms`` are dropped, gaps shorter than
    ``min_gap_ms`` merged, and ``pad_ms`` of context kept on each side. The
    whole clip when nothing clears the floor."""
    hop = sr * frame_ms // 1000
    n = len(wav) // hop
    if n == 0:
        return [(0, len(wav))]
    frames = wav[: n * hop].reshape(n, hop)
    db = 10.0 * np.log10(np.mean(frames ** 2, axis=1) + 1e-10)
    floor = np.percentile(db, 10.0)
    voiced = db > floor + threshold_db
    segs: List[Tuple[int, int]] = []
    start = None
    for i, v in enumerate(voiced):
        if v and start is None:
            start = i
        elif not v and start is not None:
            segs.append((start, i))
            start = None
    if start is not None:
        segs.append((start, n))
    merged: List[Tuple[int, int]] = []
    gap = max(1, min_gap_ms // frame_ms)
    for s, e in segs:
        if merged and s - merged[-1][1] <= gap:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    keep = max(1, min_voice_ms // frame_ms)
    pad = max(0, pad_ms // frame_ms)
    out = [(max(0, s - pad) * hop, min(n, e + pad) * hop)
           for s, e in merged if e - s >= keep]
    return out or [(0, len(wav))]


def plan_items(names: List[str], wavs: List[np.ndarray], vad: bool = False):
    """(clip name, piece order, samples) of every piece: each clip's spans
    (its voiced segments with ``vad``, else the whole clip) cut into
    window-long pieces."""
    items = []
    for name, wav in zip(names, wavs):
        spans = energy_vad(wav) if vad else [(0, len(wav))]
        j = 0
        for s, e in spans:
            for cs in range(s, e, WINDOW):
                items.append((name, j, wav[cs:min(cs + WINDOW, e)]))
                j += 1
    return items


def transcribe(model, tokenizer, meta: dict, items, *, batch: int = 8,
               max_new_tokens: int = 200, device=None) -> dict:
    """{clip name: text} of the pieces ``items`` (``plan_items``), decoded
    ``batch`` pieces at a time on ``device`` and re-joined in order."""
    from sdumc_tpu_torch.models.whisper import greedy_transcribe
    from sdumc_tpu_torch.ops.mel import log_mel_spectrogram

    device = torch.device(device) if device is not None else next(model.parameters()).device
    kw = dict(start_id=meta["decoder_start_token_id"], eos_id=meta["eos_token_id"],
              max_new_tokens=max_new_tokens,
              forced_ids=tuple((int(p), int(t)) for p, t in meta["forced_decoder_ids"]),
              suppress_ids=tuple(meta["suppress_tokens"]),
              begin_suppress_ids=tuple(meta["begin_suppress_tokens"]))
    n_mels = model.cfg.num_mel_bins
    pieces: dict = {}
    with torch.inference_mode():
        for i in range(0, len(items), batch):
            group = items[i:i + batch]
            audio = np.zeros((len(group), WINDOW), np.float32)
            for j, (_, _, w) in enumerate(group):
                audio[j, : len(w)] = w
            mel = log_mel_spectrogram(torch.from_numpy(audio).to(device), n_mels=n_mels)
            out = greedy_transcribe(model, mel, **kw)
            tokens, counts = out["tokens"].cpu().tolist(), out["n_tokens"].cpu().tolist()
            for (name, seg, _), ids, n in zip(group, tokens, counts):
                text = tokenizer.decode(ids[:n], skip_special_tokens=True).strip()
                pieces.setdefault(name, []).append((seg, text))
    return {name: " ".join(t for _, t in sorted(segs) if t).strip()
            for name, segs in pieces.items()}


def write_csv(save_csv: str, rows) -> None:
    """``name,english`` rows, as JAX's csv.writer writes them."""
    os.makedirs(os.path.dirname(save_csv) or ".", exist_ok=True)
    with open(save_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["name", "english"])
        w.writerows(rows)


def main(argv=None):
    """Transcribe every ``*.wav`` of --audio_dir into --save_csv. Returns a
    summary: the csv's path, its rows, the clip, piece and batch counts,
    the host-clock seconds of the transcription (weights on the device, wav
    reading included) and the audio seconds."""
    from sdumc_tpu_torch.cli.common import resolve_device, set_matmul_precision
    from sdumc_tpu_torch.convert.hf_whisper import load_hf_whisper
    from sdumc_tpu_torch.convert.whisper_tokenizer import WhisperTokenizer
    from sdumc_tpu_torch.extract.audio import read_wav

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_dir", required=True,
                   help="HF-format Whisper directory (config.json, generation_config.json, "
                        "weights, tokenizer.json), e.g. base.en")
    p.add_argument("--audio_dir", required=True)
    p.add_argument("--save_csv", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=200)
    p.add_argument("--vad", action="store_true",
                   help="energy VAD: transcribe voiced segments and join them "
                        "(the reference recipes' _vad suffix)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) raises when no card is present")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    set_matmul_precision("highest")              # f32 with TF32 off, as JAX's f32 model
    _, model, meta = load_hf_whisper(args.model_dir, device)
    tokenizer = WhisperTokenizer.from_dir(args.model_dir)

    t0 = time.perf_counter()
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(args.audio_dir)
                   if f.endswith(".wav"))
    wavs = [read_wav(os.path.join(args.audio_dir, n + ".wav")) for n in names]
    items = plan_items(names, wavs, args.vad)
    texts = transcribe(model, tokenizer, meta, items, batch=args.batch,
                       max_new_tokens=args.max_new_tokens, device=device)
    rows = [(n, texts.get(n, "")) for n in names]
    seconds = time.perf_counter() - t0
    for n, text in rows:
        print(f"{n}: {text}")
    write_csv(args.save_csv, rows)
    return {"save_csv": args.save_csv, "rows": rows, "clips": len(names),
            "pieces": len(items), "batches": -(-len(items) // args.batch),
            "seconds": seconds, "audio_seconds": sum(len(w) for w in wavs) / SAMPLE_RATE}
