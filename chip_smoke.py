#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sdumc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, as below
    python3 chip_smoke.py --ab OTHER      # phases 2-3, 17 and 19 only, for this
                                          # checkout's kernels and OTHER's (the
                                          # root of another checkout), in turns

Phases, each fatal on failure (non-zero exit, no result line):
  1. environment: the card's name and power limit, then the kernel build
     from the sources in this checkout (all sources compile in parallel);
  2. the fusion kernel against its plain PyTorch version on the card, at the
     shapes of the inference path's first dual batch (B = 64 rows, D = 256,
     the audio / text / video buckets), once with mixed per-row t_max and
     once with the batch's own lengths, which are also timed (CUDA events,
     and device time per call from torch.profiler; each call takes the next
     of x's clones, so its x is not in the L2) beside the plain version and
     the bound; and the gradient through the kernel's autograd.Function
     (its recomputing backward) against the plain version's, with the mixed
     t_max (a check of its wiring: the recompute is the plain version);
  3. the WavLM attention kernel against its plain version at wavlm-large's
     H = 16, hd = 64, for a 5-s bucket batch (B = 8, T = 249) and the 60-s
     clip (B = 1, T = 2999), with mixed key masks, timed the same way beside
     the plain version, the bound and one scaled_dot_product_attention call;
  4. the inference path: ``sdumc_tpu_torch.cli.infer.main`` on the
     synthetic store at the full published width (1024/4096/1024 -> 256,
     batch 32, dual view, seeded weights), with every launch counter set to
     0 before and read after it, and the first batch's predictions held
     against the same model's plain path on the CPU;
  5. the extraction path: ``sdumc_tpu_torch.cli.extract.main(["audio",
     ...])`` with its defaults on a seeded wavlm-large HF-format directory
     and 17 seeded wavs (16 of 2-24 s and one of 60 s), with the launch
     counters around it, every saved feature checked for shape and
     finiteness, and one short clip held against the plain path on the CPU;
  6. a second (warm) extraction of the same wavs under torch.profiler:
     device time by kernel and by family (attention kernel, convolutions,
     GEMMs, copies, the rest) and the device's busy share of the host-clock
     window;
  7. the training path: ``sdumc_tpu_torch.cli.train.main`` on the synthetic
     store for two epochs at the inference path's width and batch (live
     dropouts, seeded weights), with the launch counters set to 0 before and
     read after it (3 launches per Q for each train, eval and test batch),
     every logged loss finite, and its best_full.pt through cli.infer
     --checkpoint reproducing the recorded test MAE;
  8. one train step with dropout off from the same seeded weights on the
     first train batch, card against CPU: the loss and every gradient; then
     the card's step again with TF32 allowed in torch's matmuls, which the
     gradient check must refuse (it shows the check can see TF32);
  9. a warm train step on the card, timed with CUDA events over 10 steps,
     then device time by family (fusion kernel, GEMMs, optimizer, copies,
     the rest) of 3 steps under torch.profiler, with the idle share;
 10. the feat4 decoder at Vicuna-7B width (vocab 32000, hidden 4096, 32
     heads, FFN 11008) cut to 2 layers, f32, TF32 off, seeded weights, card
     against CPU: full-sequence logits and tap sum, then a beam-4 decode of
     16 tokens of 2 clips of different prompt lengths in one bucket (tokens
     equal, taps to a tolerance, the smallest gap between the 4th and 5th
     candidate score printed);
 11. the feat4 path: ``sdumc_tpu_torch.cli.extract.main(["feat4", ...])``
     with its defaults (bf16, beam 4, --gen_batch 4, 200 new tokens) on a
     seeded 2-layer Vicuna in HF's format (two fp16 shards with their index,
     a hand-written tokenizer.json), a seeded projector and phase 5's
     features (17 clips, one of 60 s), with the launch counters around it
     (the decode runs no kernel of the port), every output checked, and one
     4-clip chunk against its clips decoded alone;
 12. Vicuna-7B at full depth (32 layers, bf16, seeded on the card) through
     Feat4Extractor.extract_many on the same features: host-clock rate and
     peak memory, a chunk's ms per decode step (CUDA events) beside its
     weight-and-KV-stream bound, device time by family, idle share and host
     launches per step from torch.profiler, then 32-step runs of the same
     chunk with --quant int8, --quant w8a8 and --kv_quant int8, timed, and
     their taps' shift from bf16's;
 13. the text path: ``sdumc_tpu_torch.cli.extract.main(["text", ...])`` with
     its defaults (bf16, FRAME, taps -4..-1, batch 16) on phase 11's 2-layer
     Vicuna directory (its tokenizer.json has LLaMA's decoder, the 256 byte
     tokens and a vocabulary covering the probe and the transcripts) and 64
     seeded MOSEI-like transcripts (3-60 words, one of about 200 tokens, one
     empty, one with a non-ASCII word): every output's shape and
     finiteness, then one batch through the f32 trunk, card against CPU;
 14. the text stage at full depth (32 layers, bf16, seeded on the card)
     through extract_text_features with --layer_ids -3 and -4..-1:
     sentences/s by the host clock, peak memory, ms per batch by CUDA events
     beside its bound, device time by family and the idle share;
 15. the visual path: ``cli.extract visual`` with its defaults (batch 32,
     FRAME) on a seeded MANet .pth in the reference's format and 12 clips of
     30-300 OpenFace-style 112x112 24-bit BMP frames: shapes and
     finiteness, one clip's first batch card against CPU and a control run
     with cuDNN's TF32 allowed that the check must refuse; a warm second
     run (frames/s, decode-and-resize time apart), a warm run of the 3
     shortest clips under torch.profiler (device time by family, idle
     share) and the f32 bound from the MACs of every conv;
 16. the MANet trainer: ``cli.extract manet_train`` for one epoch (3 steps
     at batch 128, full width) on a seeded 7-class ImageFolder of 100x100
     BMPs, finite losses; one step card against CPU in float64 (loss and
     every gradient); ms per step by CUDA events;
 17. the fusion kernel's bf16 instance (bf16 x, the Q = 7 query bf16, f32
     keys, scores and softmax, bf16 output) against its plain version at
     phase 2's shapes, mixed per-row t_max and the batch's own, to one bf16
     ulp of the output, and its gradient through the recomputing backward;
     per call the blocks that hold a tile and the W bytes read per frame
     (from each row's t_max and the instance's tile); timed (CUDA events,
     profiler device ms, each over 3 repetitions with their spread) beside
     phase 2's f32 instance, each with its bound;
 18. the production store: seeded MOSEI-like clips at the published widths
     (the synthetic store's clips, 128 / 32 / 32 for train / val / test)
     packed by ``cli.extract pack`` at float32, bfloat16 and int8 (bytes and
     seconds); ``cli.train --feature_dtype bfloat16`` for one epoch on the
     bf16 store, then on the int8 store (dequantised on the card), with the
     launch counters around each run (the bf16 instance launches, the f32
     one does not), finite losses, best_full.pt through cli.infer
     reproducing the logged MAE, and the first eval batch's first rows card
     against CPU (the predictions, and the text representations, with a
     control run of the card's streams in f32 that their check must
     refuse); then a warm train step on the f32, bf16 and int8
     stores (CUDA events, peak memory, device time by family and idle share);
 19. the WavLM kernel's bf16 instance (bf16 q, k, v, gate and bias, f32
     scores and softmax, p rounded to bf16 against the running max of
     128-key tiles, bf16 output) against its bf16 plain version at phase 3's
     shapes and masks, to flash_wavlm.bf16_tolerance element by element and
     to flash_wavlm.BF16_MISMATCH_LIMIT in the share of elements that
     differ, which three controls (p unrounded, the row sum of the
     unrounded p, p rounded against the final max) must exceed; timed beside
     phase 3's f32 instance (3 repetitions with their spread), its bound
     (the bf16 tensor-core rate) and one bf16 SDPA call with a materialised
     mask;
 20. the WavLM kernel's gradient (FlashGatedAttention: the kernel forward,
     the chunked backward) against autograd through the plain version at
     both of phase 3's shapes, f32: dq, dk, dv, dgate and d rel_embed, with
     the backward's ms and the peak memory beside the plain version's;
 21. ``cli.extract audio --dtype bfloat16`` on phase 5's wavs and model, with
     the launch counters around it (24 bf16-instance launches a batch, none
     of the f32 instance), every clip against phase 5's f32 features (per
     frame cosine > 0.995, JAX's rule); on the shortest clip every attention
     module on the card against the CPU's bf16 plain path fed the same
     input, to BF16_LAYER_L2, which two controls (the f32 instance; the
     einsum path's bf16 scores) must exceed; its audio s per s beside phase
     5's and a profiled warm run;
 22. ``cli.extract asr`` with its defaults, and once with --vad, on the same
     wavs and a seeded whisper-base.en in HF's format (config.json,
     generation_config.json with base.en's decode rules, model.safetensors,
     a byte-level tokenizer.json over all 51864 ids): one csv row per clip,
     the 60-s clip split over the 30-s window and re-joined, the launch
     counters around each run (no kernel of the port); one batch's tokens
     card against CPU with the smallest top-1 / top-2 logit gap; ms per
     decode step (CUDA events) beside its bound, device time by family and
     idle share; then the csv through ``cli.extract text`` on phase 11's
     2-layer Vicuna, the ASR text variant end to end;
 23. ``cli.extract vision`` for each encoder with its defaults (FRAME,
     every 5th frame, batch 32) on phase 15's 12 clips of BMP crops, with
     seeded weights at the published configs in each loader's format
     (openai/clip-vit-large-patch14 as a whole CLIPModel with text tensors
     beside, facebook/dinov2-base at 518, MCG-NJU/videomae-base in its
     pretraining layout, timm's eva02_base_patch14_224 state dict, a
     torchvision resnet18 .pth): every output's shape and finiteness, the
     launch counters around the runs (no kernel of the port), one batch
     card against CPU per family on the same host-resized pixels, a TF32
     control that the CLIP check must refuse, CLIP once at UTTERANCE; per
     family a warm run (frames/s, reading and resizing apart, peak
     memory), a profiled warm run of the 2 shortest clips (device time by
     the operator that launched it, idle share) and the f32 bound from
     the forward's MACs.
Each phase prints its seconds. The second-to-last line is {"kernels":
[...]}, the last line {"ok": true, "device": {...}}. Imports nothing of JAX
or sdumc_tpu.

A bound is the least time the card could take for the call: the larger of
its bytes (each input read once, the output written once) at the HBM rate
and its operations at the rate of the units the kernel runs them on. Both
kernels' f32 instances run their matrix products on the tensor cores in the
3xTF32 split (three TF32 passes, f32-grade results), so those flops count
three times at the TF32 rate; the fusion kernel's scores and weighted sum
are f32 FMA and count once at the f32 rate. The f32 bound (every flop at
the f32 rate, the bound of the earlier FFMA kernels) is printed beside it.
The fusion kernel's bf16 instance reads x (and a batched query) at 2 bytes,
writes 2, and runs its key projection as 3 bf16 passes (x times W's hi, mid
and lo parts) at the bf16 rate; the count of its earlier design (2 TF32
passes) is printed beside it. The WavLM kernel's bf16 instance reads q, k,
v, the gate and the bias diagonal at 2 bytes, writes 2, and its products
count once at the bf16 rate.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time
import wave

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12        # f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12      # TF32 on the tensor cores
TF32_PASSES = 3               # the 3xTF32 split: hi.hi + hi.lo + lo.hi
PEAK_HBM_BYTES = 3.35e12      # bytes/s
COLD_BYTES = 4 * 50 * 2**20   # 4 x the L2: timed fusion calls cycle through x's clones
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5   # f32 reassociation over <= 2048 frames
MODEL_RTOL, MODEL_ATOL = 1e-3, 1e-4     # f32 reassociation through the whole net
B_DUAL, D = 64, 256
MAIN_ARGV = ["--synthetic", "--batch_size", "32", "--device", "cuda"]
REPLACES = {
    7: ("fused_cross", "sdumc_tpu/ops/pallas/fused_cross.py:37"),
    1: ("fused_pool", "sdumc_tpu/ops/pallas/fused_pool.py:32"),
}
# the bf16 instance of the same kernel (phases 17-18): the same TPU kernel at bf16 x
REPLACES_BF16 = {q: (name + "_bf16", line) for q, (name, line) in REPLACES.items()}
BF16_PASSES = 3               # bf16 x . W's hi, mid and lo parts, at the bf16 rate
BF16_TF32_PASSES = 2          # the count of the earlier design: x . W_lo and x . W_hi in TF32
TIMING_REPS = 3               # phases 17 and 19 time each call this many times
SOURCE = "sdumc_tpu_torch/csrc/fused_cross.cu"
FLASH = {"name": "flash_wavlm", "source": "sdumc_tpu_torch/csrc/flash_wavlm.cu",
         "replaces": "sdumc_tpu/ops/pallas/flash_wavlm.py:140"}
# the bf16 instance of the same kernel (phases 19-21): bf16 tensor-core products
FLASH_BF16 = {**FLASH, "name": "flash_wavlm_bf16"}
FLASH_SHAPES = ((8, 249), (1, 2999))   # a 5-s bucket batch, the 60-s clip
FLASH_H, FLASH_HD = 16, 64             # wavlm-large's heads
FLASH_RTOL, FLASH_ATOL = 1e-4, 1e-5    # f32, summed in another order over <= 3000 keys
FEAT_RTOL, FEAT_ATOL = 1e-3, 1e-3      # f32 reassociation through 20 of 24 layers
N_CLIPS, LONG_CLIP_S = 16, 60.0
TRAIN_EPOCHS = 2
TRAIN_ARGV = MAIN_ARGV + ["--epochs", str(TRAIN_EPOCHS)]
# one train step, card vs CPU: per parameter, max abs diff of the gradients
# <= GRAD_RTOL * max |grad| + GRAD_ATOL (f32 reassociation through the net
# and its backward, about 1e-6 of max |grad|; one TF32 product in the step
# gives about 1e-4 and fails it); the losses to STEP_LOSS_RTOL
GRAD_RTOL, GRAD_ATOL, STEP_LOSS_RTOL = 1e-5, 1e-6, 1e-4
CKPT_MAE_RTOL = 1e-6     # best_full.pt through cli.infer: the same kernels on the same batches
# the production store (phase 18): MOSEI-like splits at the published widths, packed
# at each dtype, trained with bf16 streams at the main path's batch
STORE_SPLITS = (("train", 128), ("val", 32), ("test", 32))
STORE_DTYPES = ("float32", "bfloat16", "int8")
STORE_ARGV = ["--device", "cuda", "--batch_size", "32", "--feature_dtype", "bfloat16"]
STORE_CPU_ROWS = 8
# card vs CPU at bf16 streams, the same bf16 roundings in another summation order:
# the predictions to max |diff| <= BF16_REL max |pred| (sound runs read <= 4.2e-6 of
# it; streams in f32 read 1.4e-6-4.6e-5 there too, so it cannot tell them apart), and
# the text representations (text_feat, text_query_feat, both views) to a relative L2
# error <= BF16_REP_L2 (sound <= 1.6e-4, f32 streams >= 7.6e-4 in the 11 seeded cases
# of ``python -m sdumc_tpu_torch.bench.bf16_gap`` on the H100; the limit near their
# geometric mean), which a control with the card's streams in f32 must fail
BF16_REL, BF16_REP_L2 = 1e-4, 3e-4
BF16_REP_KEYS = ("text_feat", "text_query_feat")
TIMED_STEPS, PROFILED_STEPS = 10, 3
TRAIN_FAMILIES = (
    ("fusion kernel (forward)", ("cross_partial", "cross_combine", "split_w")),
    ("cuBLAS GEMMs (forward and backward)", ("gemm", "cutlass", "sm80_xmma", "sm90_xmma")),
    ("optimizer (Adam, foreach)", ("multi_tensor", "adam")),
    ("memory copies", ("memcpy", "memset")),
)
# feat4 (phases 10-12): Vicuna-7B-v1.5's published widths (its config.json)
VICUNA = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008, num_heads=32,
              rope_theta=10000.0, rms_eps=1e-5)
DEVICE = "cuda"
VICUNA_LAYERS, CLI_LAYERS = 32, 2      # phase 12 at full depth; phases 10-11 cut to 2 layers
BEAMS, GEN_BATCH, MAX_NEW = 4, 4, 200  # the feat4 CLI's defaults
TAP_LAYERS = (-4, -3, -2, -1)
PARITY_STEPS = 16
# card vs CPU at f32 with TF32 off: reassociation through 2 layers and the
# 32000-way lm_head (values up to about 5)
LLAMA_RTOL, LLAMA_ATOL = 1e-4, 1e-4
# a chunk against its clips decoded alone, bf16: the same GEMM shapes in
# both, so equal to the bit is expected; the bound is a few bf16 ulps of a tap
BF16_RTOL, BF16_ATOL = 1e-2, 1e-2
QUANT_STEPS, PROFILE_FROM, PROFILED_DECODE_STEPS = 32, 0, 8
PEAK_BF16_FLOPS = 989e12      # bf16 on the tensor cores, dense
DECODE_FAMILIES = (
    ("cuBLAS GEMMs (projections, MLP, lm_head, attention products)",
     ("gemm", "nvjet", "cutlass", "xmma", "gemv", "splitk")),
    ("softmax and log_softmax", ("softmax",)),
    ("argmax sweeps (exact_topk)", ("argmax",)),
    ("index gathers and scatters (cache reorder, top-k, taps, embedding)",
     ("index", "gather", "scatter")),
    ("memory copies", ("memcpy", "memset")),
)
# (family, name fragments) of the extraction's device kernels, matched in order
EXTRACTION_FAMILIES = (
    ("flash_wavlm kernel", ("flash_wavlm", "flash_bf16")),
    ("cuDNN convolutions", ("conv", "fprop", "dgrad", "wgrad")),
    ("cuBLAS GEMMs", ("gemm", "nvjet", "cutlass", "sm80_xmma", "sm90_xmma")),
    ("memory copies", ("memcpy", "memset")),
)
# the bf16 audio path (phase 21): JAX's rule (tests/test_wavlm.py:151-170) for bf16
# against f32 features; and each bf16 attention module on the card against the same
# module on the CPU fed the same input, to a relative L2 error of its output of
# BF16_LAYER_L2, which the controls (p not rounded; scores rounded to bf16) must exceed.
# On an H100 (700 W) the sound path read at most 6.5e-4 over the 24 layers of the
# shortest clip and the controls at least 1.71e-3 and 2.10e-3; the limit is near the
# geometric mean of 6.5e-4 and 1.71e-3. The clip's features at tap -5 are no check:
# there card and CPU part by 0.0138, as far as each lies from the f32 features (0.0143,
# 0.0142), and so do both controls (0.0138, 0.0137).
BF16_COS_MIN = 0.995
BF16_LAYER_L2 = 1e-3
# the flash gradient (phase 20): JAX's test tolerance (tests/test_flash_wavlm.py)
FLASH_GRAD_RTOL, FLASH_GRAD_ATOL = 3e-4, 3e-5
# ASR (phase 22): whisper-base.en's published config.json (51864 tokens, 80 mels,
# 1500 source positions, 6 + 6 layers of width 512, 8 heads, FFN 2048) and the
# decode rules of its generation_config.json: <|notimestamps|> forced at position 1,
# suppress_tokens, begin_suppress_tokens [220, <|endoftext|>]
WHISPER_BASE_EN = dict(
    vocab_size=51864, num_mel_bins=80, d_model=512, encoder_layers=6,
    encoder_attention_heads=8, decoder_layers=6, decoder_attention_heads=8,
    encoder_ffn_dim=2048, decoder_ffn_dim=2048, max_source_positions=1500,
    max_target_positions=448, bos_token_id=50257, eos_token_id=50256, pad_token_id=50256,
    decoder_start_token_id=50257)
WHISPER_RULES = dict(
    forced_decoder_ids=[[1, 50362]], begin_suppress_tokens=[220, 50256],
    suppress_tokens=[1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63,
                     90, 91, 92, 93, 357, 366, 438, 532, 685, 705, 796, 930, 1058, 1220, 1267,
                     1279, 1303, 1343, 1377, 1391, 1635, 1782, 1875, 2162, 2361, 2488, 3467,
                     4008, 4211, 4600, 4808, 5299, 5855, 6329, 7203, 9609, 9959, 10563, 10786,
                     11420, 11709, 11907, 13163, 13697, 13700, 14808, 15306, 16410, 16791,
                     17992, 19203, 19510, 20724, 22305, 22935, 27007, 30109, 30420, 33409,
                     34949, 40283, 40493, 40549, 47282, 49146, 50257, 50357, 50358, 50359,
                     50360, 50361])
ASR_BATCH, ASR_TIMED_STEPS = 8, 64
ASR_FAMILIES = (
    ("cuBLAS GEMMs (projections, FFN, logits)", ("gemm", "nvjet", "cutlass", "xmma", "gemv",
                                                 "splitk")),
    ("softmax", ("softmax",)),
    ("argmax and masking", ("argmax", "masked", "where")),
    ("memory copies", ("memcpy", "memset", "copy")),
)
# text and visual (phases 13-16)
TEXT_BATCH, TEXT_TAPS = 16, ((-3,), (-4, -3, -2, -1))
N_TRANSCRIPTS, LONG_WORDS = 64, 199
PROBE = "today is a good day"                # extract/text.py find_token_span's probe
MOSEI_WORDS = (
    "i think the movie was really good and you know it had a lot of great acting but "
    "um the story was kind of slow at times so overall i would say it is okay not the "
    "best film i have seen this year my friends liked it more than me because they love "
    "action and there were some amazing scenes with cars and music that made me feel happy "
    "sad angry excited bored honestly it could have been better if the director cut about "
    "twenty minutes from the middle part where nothing really happens").split()
NON_ASCII = "the café scene was très good"
VISUAL_CLIPS, VISUAL_FRAMES, FACE = 12, (30, 300), 112   # OpenFace's aligned crops
PROFILED_CLIPS = 3
# card vs CPU on a clip (f32, TF32 off): allclose at MODEL_RTOL / MODEL_ATOL and
# max |diff| <= VISUAL_REL * max |embedding|; f32 reassociation through about
# 20 convolutions gives about 1e-6 of the largest value, one TF32 conv about 1e-3
VISUAL_REL = 1e-4
MANET_CLASSES, TRAIN_PER_CLASS, TEST_PER_CLASS, RAF = 7, 55, 4, 100   # RAF-DB's 100x100 crops
MANET_BATCH, PARITY_BATCH, TIMED_TRAIN_STEPS = 128, 8, 5
# one MANet train step card vs CPU in float64: f32 steps part by up to 4e-3 of
# the largest gradient from rounding order alone (BatchNorm in training mode
# cancels), too loose to tell a fault; float64 parts at about 1e-12
MANET_GRAD_REL, MANET_LOSS_RTOL = 1e-8, 1e-10
# the vision stage (phase 23): each family at its published config, on phase 15's clips;
# card vs CPU on one batch to max |diff| <= VISION_REL * max |embedding| (f32
# reassociation through the encoder; one TF32 product in every layer gives about 1e-3)
VISION_FAMILIES = ("clip", "dinov2", "videomae", "eva02", "imagenet")
VISION_CHECK_FRAMES, VISION_PROFILED_CLIPS, VISION_REL = 4, 2, 1e-4
TEXT_FAMILIES = (
    ("cuBLAS GEMMs", ("gemm", "nvjet", "cutlass", "xmma", "gemv", "splitk")),
    ("softmax", ("softmax",)),
    ("memory copies", ("memcpy", "memset")),
)
VISUAL_FAMILIES = (
    ("cuDNN convolutions", ("conv", "fprop", "dgrad", "wgrad", "winograd", "implicit")),
    ("pooling", ("pool",)),
    ("BatchNorm, elementwise and reductions", ("batch_norm", "bn_", "elementwise", "vectorized",
                                               "unrolled", "reduce")),
    ("memory copies", ("memcpy", "memset")),
)


def main_path_config(argv=MAIN_ARGV):
    """The ExperimentConfig that ``cli.infer.main(argv)`` runs with."""
    from sdumc_tpu_torch.cli.common import add_reference_args, add_runtime_args, args_to_config

    parser = argparse.ArgumentParser()
    add_reference_args(parser)
    add_runtime_args(parser)
    return args_to_config(parser.parse_args(argv))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_cycle(x):
    """A function that returns x or one of its clones in turn, the lot
    COLD_BYTES together, so that a timed loop over it finds each call's x
    out of the L2, as a train step, which reads each x once, does."""
    n = max(2, math.ceil(COLD_BYTES / (x.numel() * x.element_size())))
    copies = [x] + [x.clone() for _ in range(n - 1)]
    turn = [0]

    def next_x():
        turn[0] = (turn[0] + 1) % n
        return copies[turn[0]]

    return next_x


def device_ms(torch, fn, names, calls: int = 20) -> float:
    """Device time per call of the kernels whose names contain one of
    `names`, from torch.profiler over `calls` warm calls: the kernel time
    without the wrapper's host overhead (NaN if no trace holds them all)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):          # a trace now and then comes back without kernels,
        with profile(activities=[ProfilerActivity.CUDA]) as prof:   # or some of them
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and any(n in e.key for n in names)]
        total = sum(e.self_device_time_total for e in found)
        if total > 0 and all(e.count % calls == 0 for e in found):
            return total / 1e3 / calls
    return math.nan


def bound_ms(q_count: int, t_valid, shared_query: bool, bf16: bool = False):
    """Least time for one call, as {"bytes", "operations", "f32",
    "operations_tf32"} in ms: each input read once (x only up to each row's
    t_max) and the output written once, over the HBM rate; the key
    projection (2 D^2 per valid frame) in 3xTF32 over the TF32 rate (for
    bf16 x: 3 bf16 passes over the bf16 rate) plus bias + tanh (2 D), scores
    and weighted sum (4 Q D) over the f32 rate; every flop over the f32
    rate, the earlier bound; and, for bf16 x, the earlier design's count, 2
    TF32 passes over the TF32 rate. The bf16 instance reads x and a batched
    query as bf16 and writes a bf16 output (2 bytes); the shared context, W
    and the bias stay f32."""
    n = int(sum(t_valid))
    rows = len(t_valid)
    xb = 2 if bf16 else 4
    q_bytes = (q_count * D * 4 if shared_query else rows * q_count * D * xb)
    nbytes = q_bytes + n * D * xb + D * D * 4 + D * 4 + rows * 4 + rows * q_count * D * xb
    mma, ffma = n * 2 * D * D, n * (2 * D + 4 * q_count * D)
    mma_s = BF16_PASSES * mma / PEAK_BF16_FLOPS if bf16 else TF32_PASSES * mma / PEAK_TF32_FLOPS
    return {"bytes": 1e3 * nbytes / PEAK_HBM_BYTES,
            "operations": 1e3 * (mma_s + ffma / PEAK_F32_FLOPS),
            "operations_tf32": 1e3 * (BF16_TF32_PASSES * mma / PEAK_TF32_FLOPS
                                      + ffma / PEAK_F32_FLOPS),
            "f32": 1e3 * (mma + ffma) / PEAK_F32_FLOPS}


def repeated_ms(fn, device_fn, reps: int):
    """(events ms, device ms, their spreads, the readings) over `reps`
    repetitions of time_ms and device_ms: the medians and (max - min) / min
    of the readings, a device reading whose trace lost its kernels (NaN)
    left out."""
    ev = [fn() for _ in range(reps)]
    dv = [device_fn() for _ in range(reps)]

    def median_spread(v):
        v = sorted(x for x in v if math.isfinite(x))
        if not v:
            return math.nan, math.nan
        return v[len(v) // 2], (v[-1] - v[0]) / v[0] if v[0] > 0 else math.nan

    (e_ms, e_spread), (d_ms, d_spread) = median_spread(ev), median_spread(dv)
    return e_ms, d_ms, e_spread, d_spread, ev, dv


def tile_blocks(t_valid, T: int, tile: int) -> int:
    """The blocks of a fusion call that hold a tile: ceil(n_valid / tile) a
    row (the other blocks exit at once)."""
    return sum(math.ceil(min(t, T) / tile) if t > 0 else math.ceil(T / tile) for t in t_valid)


def fusion_w_reads(fused_cross, blocks: int, bf16: bool) -> int:
    """Bytes of W's split one call streams: the whole split once per tile,
    3 bf16 parts in the bf16 instance (2 f32 parts, hi and lo, in the f32
    one, and in a bf16 instance that has no W_PARTS, as --ab may time)."""
    parts = getattr(fused_cross, "W_PARTS", None) if bf16 else None
    return blocks * (parts * D * D * 2 if parts else 2 * D * D * 4)


def bf16_ulp_err(torch, got, ref) -> tuple:
    """(max abs diff, max of diff / bound) of two bf16 outputs, the bound one
    bf16 ulp at the larger of the two plus the f32 tolerance (KERNEL_RTOL |ref|
    + KERNEL_ATOL: the f32 sums before the rounding differ by that much, which
    near an output's zero is many of its ulps); the second is <= 1 when
    the outputs are one rounding apart."""
    got, ref = got.float(), ref.float()
    big = torch.maximum(got.abs(), ref.abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    diff = (got - ref).abs()
    return diff.max().item(), (diff / (ulp + KERNEL_RTOL * ref.abs() + KERNEL_ATOL)).max().item()


def main_path_lengths(cfg):
    """{modality: (T, t_max)} of the main path's first dual batch: audio and
    video share one batch max over all 2B rows (an int, as the model passes
    it), the text stream carries per-row lengths (gt rows, then feat4 rows)
    padded to a common bucket."""
    from sdumc_tpu_torch.data.pipeline import BatchIterator, get_loaders

    _, _, test_ds = get_loaders(cfg.data.dataset, cfg.data, cfg.paths, synthetic=True)
    batch = next(iter(BatchIterator(test_ds, cfg.data.batch_size, shuffle=False,
                                    buckets=cfg.data.length_buckets, prefetch=0)))
    ta, tt, tv, tf4 = batch.t_max
    half = B_DUAL // 2
    return {"audio": (batch.audio.shape[1], ta),
            "text": (max(batch.text.shape[1], batch.feat4.shape[1]), [tt] * half + [tf4] * half),
            "video": (batch.video.shape[1], tv)}


def kernel_phase(torch, fused_cross, fused_pool, lengths, grads: bool = True,
                 bf16: bool = False):
    """Each kernel vs its plain version on the card: for correctness with
    mixed per-row t_max (= T, not a tile multiple, 1, 0, > T), then timed at
    the main path's lengths. Returns per-Q totals over the three modality
    calls of one dual batch. ``bf16`` runs the bf16 instance (x and the
    Q = 7 query bf16, as the model hands them over)."""
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    names = REPLACES_BF16 if bf16 else REPLACES
    reps = TIMING_REPS if bf16 else 1
    tile = getattr(fused_cross, "TILE_T_BF16", 64) if bf16 else 64
    totals = {q: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
                  "bytes_ms": 0.0, "operations_ms": 0.0, "operations_tf32_ms": 0.0,
                  "f32_bound_ms": 0.0, "device_ms": 0.0, "grad_max_abs_err": 0.0,
                  "max_ulps": 0.0, "blocks": 0, "tile_frames": 0, "w_bytes": 0, "frames": 0,
                  "ms_reps": [0.0] * reps, "device_ms_reps": [0.0] * reps,
                  "calls": {}} for q in REPLACES}
    if bf16:
        print(f"bf16 instance vs plain (B={B_DUAL}, D={D}; tolerance: one bf16 ulp of the "
              f"output plus rtol={KERNEL_RTOL} atol={KERNEL_ATOL}: both sum in f32, as the f32 "
              f"instance, and round once; gradients rtol={KERNEL_RTOL} atol={KERNEL_ATOL}, the "
              f"recompute is the plain version)")
    else:
        print(f"kernel vs plain (B={B_DUAL}, D={D}; tolerance rtol={KERNEL_RTOL} "
              f"atol={KERNEL_ATOL}: f32 reassociation over <= 2048 frames)")
    for modality, (T, t_main) in lengths.items():
        x = (0.5 * torch.randn(B_DUAL, T, D, generator=gen)).to(dev)
        w = ((torch.rand(D, D, generator=gen) * 2 - 1) / 16).to(dev)
        b = ((torch.rand(D, generator=gen) * 2 - 1) / 16).to(dev)
        query = (0.5 * torch.randn(B_DUAL, 7, D, generator=gen)).to(dev)
        context = (0.1 * torch.randn(D, generator=gen)).to(dev)
        if bf16:
            x, query = x.bfloat16(), query.bfloat16()
        mixed = torch.randint(1, T + 1, (B_DUAL,), generator=gen, dtype=torch.int32)
        mixed[:5] = torch.tensor([T, max(1, T - 37), 1, 0, T + 5])
        mixed = mixed.to(dev)
        if isinstance(t_main, list):
            t_valid, t_main = t_main, torch.tensor(t_main, dtype=torch.int32, device=dev)
        else:
            t_valid = [t_main] * B_DUAL
        for q_count in REPLACES:
            if q_count == 7:
                first = query

                def kern_of(q, x, w, b, t):
                    return fused_cross.fused_cross_attention(q, x, w, b, t)

                def plain_of(q, x, w, b, t):
                    return fused_cross.fused_cross_attention_plain(q, x, w, b, t)
            else:
                first = context

                def kern_of(c, x, w, b, t):
                    return fused_pool.fused_attention_pool(x, w, b, c, t)

                def plain_of(c, x, w, b, t):
                    return fused_pool.fused_attention_pool_plain(x, w, b, c, t)

            def kern(t, kern_of=kern_of, first=first):
                return kern_of(first, x, w, b, t)

            def plain(t, plain_of=plain_of, first=first):
                return plain_of(first, x, w, b, t)

            grad_err = gradient_check(torch, names[q_count][0], modality, kern_of, plain_of,
                                      [first, x, w, b], mixed) if grads else math.nan
            with torch.inference_mode():
                errs, ulps = [], []
                for t in (mixed, t_main):
                    got, ref = kern(t), plain(t)
                    torch.cuda.synchronize()
                    if bf16:
                        err, n_ulps = bf16_ulp_err(torch, got, ref)
                        errs.append(err)
                        ulps.append(n_ulps)
                        if got.dtype != torch.bfloat16 or n_ulps > 1.0:
                            raise AssertionError(
                                f"{names[q_count][0]} at T={T}: {got.dtype}, max abs err "
                                f"{err!r}, {n_ulps!r} of its bound (one bf16 ulp + the f32 "
                                f"tolerance)")
                        continue
                    errs.append((got - ref).abs().max().item())
                    if not torch.allclose(got, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
                        raise AssertionError(
                            f"{names[q_count][0]} at T={T}: max abs err {errs[-1]} "
                            f"outside rtol={KERNEL_RTOL} atol={KERNEL_ATOL}")
                # timed with x cold in the L2 (the audio x alone is 33.5 MB
                # in bf16, 67 MB in f32, the L2 50 MB)
                next_x = cold_cycle(x)
                ms, dev_ms, ms_spread, dev_spread, ms_reps, dev_reps = repeated_ms(
                    lambda: time_ms(lambda: kern_of(first, next_x(), w, b, t_main)),
                    lambda: device_ms(torch, lambda: kern_of(first, next_x(), w, b, t_main),
                                      ("cross_",)), reps)
                plain_ms = time_ms(lambda: plain_of(first, next_x(), w, b, t_main))
                del next_x
            bnd = bound_ms(q_count, t_valid, q_count == 1, bf16)
            blocks = tile_blocks(t_valid, T, tile)
            w_bytes = fusion_w_reads(fused_cross, blocks, bf16)
            tot = totals[q_count]
            tot["max_ulps"] = max([tot["max_ulps"], *ulps])
            tot["bytes_ms"] += bnd["bytes"]
            tot["operations_ms"] += bnd["operations"]
            tot["operations_tf32_ms"] += bnd["operations_tf32"]
            tot["blocks"] += blocks
            tot["tile_frames"] += blocks * tile
            tot["w_bytes"] += w_bytes
            tot["frames"] += sum(t_valid)
            tot["ms_reps"] = [a + c for a, c in zip(tot["ms_reps"], ms_reps)]
            tot["device_ms_reps"] = [a + c for a, c in zip(tot["device_ms_reps"], dev_reps)]
            tot["f32_bound_ms"] += bnd["f32"]
            tot["ms"] += ms
            tot["device_ms"] += dev_ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += max(bnd["bytes"], bnd["operations"])
            tot["max_abs_err"] = max(tot["max_abs_err"], *errs)
            if grads:
                tot["grad_max_abs_err"] = max(tot["grad_max_abs_err"], grad_err)
            tot["calls"][modality] = ms
            reps_note = (f" over {reps} repetitions: kernel_ms {ms_reps!r} (spread "
                         f"{ms_spread:.1%}), device_ms {dev_reps!r} (spread {dev_spread:.1%}); "
                         f"blocks with a tile {blocks} of {tile} frames, W bytes read "
                         f"{w_bytes} = {w_bytes / (blocks * tile):.0f} per tile frame, "
                         f"{w_bytes / sum(t_valid):.0f} per valid frame; the earlier 2-TF32-pass "
                         f"count's bound {bnd['operations_tf32']!r}" if bf16 else "")
            print(f"  {names[q_count][0]:16s} {modality:5s} T={T:4d} "
                  f"t_max={sorted(set(t_valid))} frames={sum(t_valid)} "
                  f"max_abs_err mixed={errs[0]!r} main={errs[1]!r} grad={grad_err!r} "
                  f"kernel_ms={ms!r} device_ms={dev_ms!r} plain_ms={plain_ms!r} "
                  f"bound_ms={max(bnd['bytes'], bnd['operations'])!r} "
                  f"(bytes {bnd['bytes']!r}, operations {bnd['operations']!r}; "
                  f"f32 bound {bnd['f32']!r}){reps_note}")
    return totals


def gradient_check(torch, name, modality, kern_of, plain_of, inputs, t_max) -> float:
    """The gradient through the kernel's autograd.Function (the recomputing
    backward) against autograd through the plain version, both on the card:
    d(first input), dx, dW, db of <out, g> for a seeded g. The backward
    recomputes the plain version on its saved inputs, so this checks the
    wiring (what is saved, the shared context's sum over rows, t_max as a
    tensor) and reads 0 when it is right. Returns the largest abs
    difference; raises outside the kernel tolerance."""
    gen = torch.Generator().manual_seed(2)
    grads = []
    for fn in (kern_of, plain_of):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves, t_max)
        g = torch.randn(out.shape, generator=gen.manual_seed(2)).to(out.device, out.dtype)
        grads.append(torch.autograd.grad(out, leaves, g))
    torch.cuda.synchronize()
    worst = 0.0
    for label, got, ref in zip(("dq", "dx", "dW", "db"), *grads):
        got, ref = got.float(), ref.float()
        err = (got - ref).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(got, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
            raise AssertionError(f"{name} {modality} gradient {label}: max abs err {err!r} "
                                 f"outside rtol={KERNEL_RTOL} atol={KERNEL_ATOL}")
    return worst


def reset_counts():
    from sdumc_tpu_torch.ops.kernels import flash_wavlm, fused_cross

    fused_cross.reset_launches()
    flash_wavlm.reset_launches()


def read_counts() -> dict:
    """{kernel name: launches}, every kernel of the port."""
    from sdumc_tpu_torch.ops.kernels import flash_wavlm, fused_cross

    counts = {REPLACES[q][0]: n for q, n in fused_cross.LAUNCHES.items()}
    counts.update({REPLACES_BF16[q][0]: n for q, n in fused_cross.LAUNCHES_BF16.items()})
    counts[FLASH["name"]] = flash_wavlm.LAUNCHES
    counts[FLASH_BF16["name"]] = flash_wavlm.LAUNCHES_BF16
    return counts


def flash_bound_ms(B, T, n_valid, num_buckets=320):
    """Least time for one call, as {"bytes", "operations", "f32"} in ms: q,
    k, v, the gate, rel_embed and kvalid read once and out written once,
    over the HBM rate; QK^T and PV (4 hd flops per query and valid key) in
    3xTF32 over the TF32 rate; and the same flops over the f32 rate, the
    earlier bound. Keys that a row masks need no work, so only valid keys
    count."""
    H, hd = FLASH_H, FLASH_HD
    nbytes = 4 * (4 * B * T * H * hd + B * H * T + num_buckets * H + B * T)
    flops = 4 * H * hd * T * int(sum(n_valid))
    return {"bytes": 1e3 * nbytes / PEAK_HBM_BYTES,
            "operations": 1e3 * TF32_PASSES * flops / PEAK_TF32_FLOPS,
            "f32": 1e3 * flops / PEAK_F32_FLOPS}


def flash_phase(torch, flash_wavlm):
    """The WavLM attention kernel vs its plain version at wavlm-large's
    shapes, then timed beside the plain version, the bound and SDPA."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(1)
    dev = torch.device("cuda")
    kw = dict(num_buckets=320, max_distance=800)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bytes_ms": 0.0, "operations_ms": 0.0, "f32_bound_ms": 0.0, "max_abs_err": 0.0,
           "device_ms": 0.0, "calls": {}}
    print(f"flash_wavlm vs plain (H={FLASH_H}, hd={FLASH_HD}; tolerance rtol={FLASH_RTOL} "
          f"atol={FLASH_ATOL}: f32, summed in another order over <= 3000 keys)")
    for B, T in FLASH_SHAPES:
        rows = max(B, 3)        # correctness: one row at T, one at T - 37, one at 1
        q, k, v = (torch.randn(rows, T, FLASH_H, FLASH_HD, generator=gen).to(dev)
                   for _ in range(3))
        gate = (1 + torch.rand(rows, FLASH_H, T, generator=gen)).to(dev)
        rel = torch.randn(320, FLASH_H, generator=gen).to(dev)
        lengths = torch.randint(1, T + 1, (rows,), generator=gen)
        lengths[:3] = torch.tensor([T, T - 37, 1])
        kvalid = (torch.arange(T)[None, :] < lengths[:, None]).float().to(dev)
        with torch.inference_mode():
            diag = flash_wavlm.bias_diag_for(rel, T, **kw)
            got = flash_wavlm.flash_gated_attention(q, k, v, gate, None, kvalid, diag, **kw)
            ref = flash_wavlm.flash_gated_attention_plain(q, k, v, gate, None, kvalid, diag, **kw)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if not torch.allclose(got, ref, rtol=FLASH_RTOL, atol=FLASH_ATOL):
                raise AssertionError(f"flash_wavlm at B={rows} T={T}: max abs err {err!r} "
                                     f"outside rtol={FLASH_RTOL} atol={FLASH_ATOL}")
            # timed at the slice's shape: the first B rows (B = 1: the full row)
            args = [t[:B].contiguous() for t in (q, k, v, gate)]
            mask_b = kvalid[:B].contiguous()
            def kern():
                return flash_wavlm.flash_gated_attention(*args, None, mask_b, diag, **kw)

            ms = time_ms(kern)
            dev_ms = device_ms(torch, kern, ("flash_wavlm",))
            plain_ms = time_ms(lambda: flash_wavlm.flash_gated_attention_plain(
                *args, None, mask_b, diag, **kw))
            # SDPA on the same function: heads-first q/k/v and a materialised
            # f32 mask gate * bias + keymask, all built outside the timed region
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in args[:3])
            attn_mask = (args[3][..., None] * flash_wavlm.dense_bias(diag, T)[None]
                         + torch.where(mask_b > 0, 0.0, flash_wavlm.NEG)[:, None, None, :])
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=attn_mask))
            lib_err = (F.scaled_dot_product_attention(qh, kh, vh, attn_mask=attn_mask)
                       .transpose(1, 2) - ref[:B]).abs().max().item()
        bnd = flash_bound_ms(B, T, lengths[:B].tolist())
        least = max(bnd["bytes"], bnd["operations"])
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", least), ("bytes_ms", bnd["bytes"]),
                         ("operations_ms", bnd["operations"]), ("f32_bound_ms", bnd["f32"]),
                         ("device_ms", dev_ms)):
            tot[key] += val
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["calls"][f"B={B} T={T}"] = ms
        print(f"  flash_wavlm B={B} T={T} valid keys={lengths[:B].tolist() if B > 1 else T} "
              f"max_abs_err={err!r} (checked at B={rows}) kernel_ms={ms!r} device_ms={dev_ms!r} "
              f"plain_ms={plain_ms!r} sdpa_ms={lib_ms!r} (sdpa max abs diff {lib_err!r}) "
              f"bound_ms={least!r} (bytes {bnd['bytes']!r}, operations {bnd['operations']!r}; "
              f"f32 bound {bnd['f32']!r})")
    return tot


def main_path_phase(torch, fused_cross):
    from sdumc_tpu_torch.cli import infer
    from sdumc_tpu_torch.cli.common import build_model
    from sdumc_tpu_torch.data.pipeline import BatchIterator, get_loaders
    from sdumc_tpu_torch.train.step import batch_to_device_dict, make_eval_step

    reset_counts()
    t0 = time.perf_counter()
    out = infer.main(MAIN_ARGV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    launches = dict(fused_cross.LAUNCHES)

    cfg = main_path_config()
    train_ds, _, test_ds = get_loaders(cfg.data.dataset, cfg.data, cfg.paths, synthetic=True)
    n_batches = math.ceil(len(test_ds) / cfg.data.batch_size)
    for q_count in REPLACES:
        if launches.get(q_count, 0) != 3 * n_batches:
            raise AssertionError(f"{REPLACES[q_count][0]}: {launches.get(q_count, 0)} launches "
                                 f"on the main path, expected 3 x {n_batches} batches")
    res = out["results"]
    for key in ("val_preds_full", "val_preds_missing"):
        preds = res[key]
        if preds.shape != (len(test_ds),) or not all(map(math.isfinite, preds.tolist())):
            raise AssertionError(f"{key}: shape {preds.shape} or non-finite values")
    print(f"inference path: {len(test_ds)} clips in {n_batches} dual batches, "
          f"{seconds!r} s host clock (data generation and model init included); "
          f"launches {counts}")

    # first batch: card predictions vs the same weights' plain path on the CPU
    batch = next(iter(BatchIterator(test_ds, cfg.data.batch_size, shuffle=False,
                                    buckets=cfg.data.length_buckets, prefetch=0)))
    cpu = torch.device("cpu")
    model = build_model(cfg, train_ds.input_dims(), cpu)
    v0, v1 = make_eval_step(model)(batch_to_device_dict(batch, cpu))
    n = batch.size
    for name, ref, got in (("full", v0, res["val_preds_full"][:n]),
                           ("missing", v1, res["val_preds_missing"][:n])):
        got = torch.from_numpy(got)
        err = (got - ref).abs().max().item()
        print(f"first batch {name} view: card vs CPU plain max abs diff {err!r} "
              f"(tolerance rtol={MODEL_RTOL} atol={MODEL_ATOL}: f32 reassociation "
              f"through the whole net)")
        if not torch.allclose(got, ref, rtol=MODEL_RTOL, atol=MODEL_ATOL):
            raise AssertionError(f"{name} view: card and CPU predictions disagree")
    print(f"metrics full: {out['full']}")
    print(f"metrics missing: {out['missing']}")
    return launches


def write_wavlm_dir(torch, path: str, seed: int = 0):
    """A seeded wavlm-large in HF's format: config.json with HF's key names
    (the port's WavLMConfig defaults, wavlm-large's widths) and
    pytorch_model.bin at the published shapes, normal(0, 0.02) as HF's init
    draws Linear and Embedding weights, biases 0, norms 1 / 0,
    gru_rel_pos_const 1, the positional conv in HF's weight_g / weight_v
    form. Returns the config."""
    from sdumc_tpu_torch.convert.hf_wavlm import config_from_hf, fold_weight_norm
    from sdumc_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

    d = WavLMConfig()
    config = {"model_type": "wavlm", "architectures": ["WavLMModel"],
              "hidden_size": d.hidden_size, "num_hidden_layers": d.num_layers,
              "num_attention_heads": d.num_heads, "intermediate_size": d.intermediate_size,
              "conv_dim": list(d.conv_dim), "conv_kernel": list(d.conv_kernel),
              "conv_stride": list(d.conv_stride), "conv_bias": d.conv_bias,
              "feat_extract_norm": d.feat_extract_norm,
              "do_stable_layer_norm": d.do_stable_layer_norm,
              "num_conv_pos_embeddings": d.num_conv_pos_embeddings,
              "num_conv_pos_embedding_groups": d.num_conv_pos_embedding_groups,
              "num_buckets": d.num_buckets, "max_bucket_distance": d.max_bucket_distance,
              "layer_norm_eps": d.layer_norm_eps}
    cfg = config_from_hf(config)
    with torch.device("meta"):
        shapes = {k: t.shape for k, t in WavLMModel(cfg).state_dict().items()}
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape in shapes.items():
        if key.endswith("gru_rel_pos_const") or (key.endswith("norm.weight")):
            sd[key] = torch.ones(shape)
        elif key.endswith(".bias"):
            sd[key] = torch.zeros(shape)
        else:
            sd[key] = 0.02 * torch.randn(shape, generator=gen)
    pre = "encoder.pos_conv_embed.conv."
    w = sd.pop(pre + "weight")
    sd[pre + "weight_g"] = w.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    sd[pre + "weight_v"] = w
    assert torch.allclose(fold_weight_norm(sd[pre + "weight_g"], w), w, rtol=1e-6, atol=1e-7)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    return cfg


def write_wavs(path: str, seed: int = 0):
    """N_CLIPS 16-bit PCM wavs of seeded durations in 2-24 s and one of
    60 s (T = 2999 frames); {name: samples}."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seconds = list(rng.uniform(2.0, 24.0, size=N_CLIPS)) + [LONG_CLIP_S]
    os.makedirs(path, exist_ok=True)
    clips = {}
    for i, sec in enumerate(seconds):
        n = int(round(sec * 16000))
        pcm = (np.clip(0.1 * rng.standard_normal(n), -1, 1) * 32767).astype("<i2")
        name = f"clip_{i:02d}"
        with wave.open(os.path.join(path, f"{name}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes(pcm.tobytes())
        clips[name] = n
    return clips


def profile_extraction(torch, model_dir: str, audio_dir: str, top: int = 15,
                       dtype: str = "float32"):
    """A warm extraction of every wav in audio_dir under torch.profiler, at
    `dtype`: device time by kernel, and the device's busy share of the
    window."""
    import glob

    from torch.profiler import ProfilerActivity, profile

    from sdumc_tpu_torch.convert.hf_wavlm import load_hf_wavlm
    from sdumc_tpu_torch.extract.audio import extract_audio_features, read_wav

    cfg, model = load_hf_wavlm(model_dir)
    model.to("cuda")
    wavs = [read_wav(p) for p in sorted(glob.glob(os.path.join(audio_dir, "*.wav")))]
    extract_audio_features(model, cfg, wavs, dtype=dtype)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extract_audio_features(model, cfg, wavs, dtype=dtype)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_device_time(prof, wall, f"profiled extraction ({dtype}, warm, same wavs)",
                      EXTRACTION_FAMILIES, "elementwise, norms and the rest", top)


def print_device_time(prof, wall: float, title: str, families_by_name, rest: str,
                      top: int = 15) -> dict:
    """Device time by kernel and by family of a torch.profiler run, and the
    device's idle share of the host-clock window `wall` (s); returns
    {family: ms}."""
    from torch.autograd import DeviceType

    # device-side user annotations (Optimizer.step#Adam.step) span kernels
    # that are counted on their own
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and not e.key.startswith("Optimizer.")),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    if busy <= 0:
        raise AssertionError(f"{title}: the profiler saw no device time")
    print(f"{title}: {wall!r} s host clock, device busy {busy!r} s, idle share "
          f"{1 - busy / wall!r}; device time by kernel:")
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d} calls "
              f"{e.self_device_time_total / 1e6 / busy:7.2%}  {e.key[:90]}")
    families = {}
    for e in kernels:
        name = e.key.lower()
        family = next((f for f, keys in families_by_name if any(k in name for k in keys)), rest)
        ms, calls = families.get(family, (0.0, 0))
        families[family] = (ms + e.self_device_time_total / 1e3, calls + e.count)
    print("device time by family:")
    for family, (ms, calls) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:10.3f} ms {calls:6d} calls {ms / 1e3 / busy:7.2%}  {family}")
    return {family: ms for family, (ms, _) in families.items()}


def extraction_phase(torch, flash_wavlm, tmp: str):
    """cli.extract audio at wavlm-large's full width on the card; its
    features stay in `tmp` for the feat4 phases. Returns (launch counts,
    the features' directory)."""
    import numpy as np

    from sdumc_tpu_torch.cli import extract
    from sdumc_tpu_torch.convert.hf_wavlm import load_hf_wavlm
    from sdumc_tpu_torch.extract.audio import extract_audio_features, plan_batches, read_wav

    model_dir, audio_dir, save_dir = (os.path.join(tmp, n) for n in ("model", "wavs", "out"))
    cfg = write_wavlm_dir(torch, model_dir)
    clips = write_wavs(audio_dir)
    names = sorted(clips)
    n_batches = len(plan_batches(cfg, [clips[n] for n in names], 8))

    reset_counts()
    out = extract.main(["audio", "--model_dir", model_dir, "--audio_dir", audio_dir,
                        "--save_dir", save_dir])
    torch.cuda.synchronize()
    counts = read_counts()
    if out["batches"] != n_batches or counts[FLASH["name"]] != cfg.num_layers * n_batches:
        raise AssertionError(f"flash_wavlm: {counts[FLASH['name']]} launches in "
                             f"{out['batches']} batches, expected {cfg.num_layers} x "
                             f"{n_batches}")
    if not out["save_dir"].endswith("wavlm-large-FRA_-5"):
        raise AssertionError(f"output directory {out['save_dir']}")
    for name in names:
        feat = np.load(os.path.join(out["save_dir"], f"{name}.npy"))
        want = (cfg.output_length(clips[name]), cfg.hidden_size)
        if feat.shape != want or not np.isfinite(feat).all():
            raise AssertionError(f"{name}: shape {feat.shape} (want {want}) or non-finite")
    print(f"extraction path: {out['clips']} clips ({out['audio_seconds']!r} s of audio, "
          f"longest T={cfg.output_length(max(clips.values()))} frames) in {out['batches']} "
          f"batches, {out['seconds']!r} s host clock (weights on the card; wav reading "
          f"included, weight loading and wav writing excluded): "
          f"{out['audio_seconds'] / out['seconds']!r} audio s per s host clock; "
          f"launches {counts}")

    # the shortest clip: card features vs the same weights' plain path on the CPU
    short = min(names, key=clips.get)
    _, cpu_model = load_hf_wavlm(model_dir)
    wav = read_wav(os.path.join(audio_dir, f"{short}.wav"))
    ref = extract_audio_features(cpu_model, cfg, [wav], device="cpu")[0]
    got = np.load(os.path.join(out["save_dir"], f"{short}.npy"))
    err = float(np.abs(got - ref).max())
    print(f"{short} ({clips[short] / 16000!r} s): card vs CPU plain max abs diff {err!r}, "
          f"max |feature| {float(np.abs(ref).max())!r} (tolerance rtol={FEAT_RTOL} "
          f"atol={FEAT_ATOL}: f32 reassociation through 20 of 24 layers)")
    if not np.allclose(got, ref, rtol=FEAT_RTOL, atol=FEAT_ATOL):
        raise AssertionError(f"{short}: card and CPU features disagree")
    profile_extraction(torch, model_dir, audio_dir)
    return counts, out["save_dir"], out["audio_seconds"] / out["seconds"]


def training_phase(torch, fused_cross):
    """cli.train --synthetic for TRAIN_EPOCHS epochs at full width, with the
    launch counters around it; its best_full.pt through cli.infer."""
    from sdumc_tpu_torch.cli import infer, train
    from sdumc_tpu_torch.data.pipeline import get_loaders

    cfg = main_path_config()
    bs = cfg.data.batch_size
    train_ds, val_ds, test_ds = get_loaders(cfg.data.dataset, cfg.data, cfg.paths, synthetic=True)
    per_epoch = len(train_ds) // bs + math.ceil(len(val_ds) / bs) + math.ceil(len(test_ds) / bs)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t0 = time.perf_counter()
        result = train.main(TRAIN_ARGV + ["--checkpoint_dir", tmp, "--save_root", tmp])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        launches = dict(fused_cross.LAUNCHES)
        for q_count in REPLACES:
            want = 3 * TRAIN_EPOCHS * per_epoch
            if launches.get(q_count, 0) != want:
                raise AssertionError(
                    f"{REPLACES[q_count][0]}: {launches.get(q_count, 0)} launches on the training "
                    f"path, expected 3 x {TRAIN_EPOCHS} epochs x {per_epoch} batches = {want}")
        for h in result["history"]:
            values = [h["train_loss"], h["train_mse_full"], h["train_mse_missing"],
                      h["eval_mse_full"], h["test"]["full"]["mae"], h["test"]["missing"]["mae"]]
            if not all(map(math.isfinite, values)):
                raise AssertionError(f"non-finite training log: {h}")
            print(f"  epoch {h['epoch'] + 1}: train_loss={h['train_loss']!r} "
                  f"train_mse_full={h['train_mse_full']!r} test_mae_full="
                  f"{h['test']['full']['mae']!r} test_mae_missing={h['test']['missing']['mae']!r} "
                  f"{h['clips_per_sec']!r} clips/s host clock (collation and copies included)")
        print(f"training path: {TRAIN_EPOCHS} epochs of {len(train_ds) // bs} steps at batch {bs} "
              f"(+ eval {len(val_ds)} and test {len(test_ds)} clips per epoch), {seconds!r} s "
              f"host clock (data generation, model init and checkpoints included); "
              f"launches {counts}")

        out = infer.main(MAIN_ARGV + ["--checkpoint", os.path.join(tmp, "best_full.pt")])
        mae, best = out["full"]["mae"], result["best_full"]["mae"]
        print(f"best_full.pt (epoch {result['best_full']['epoch'] + 1}) through cli.infer: test MAE "
              f"{mae!r}, the loop recorded {best!r} (tolerance rtol={CKPT_MAE_RTOL}: the same "
              f"kernels on the same batches)")
        if abs(mae - best) > CKPT_MAE_RTOL * abs(best):
            raise AssertionError("the best checkpoint does not reproduce its MAE")
    return launches


def first_train_batch(cfg, train_ds):
    from sdumc_tpu_torch.data.pipeline import BatchIterator

    return next(iter(BatchIterator(train_ds, cfg.data.batch_size, shuffle=True,
                                   seed=cfg.data.shuffle_seed, epoch=0,
                                   buckets=cfg.data.length_buckets, prefetch=0,
                                   drop_remainder=True)))


def make_step(torch, cfg, model):
    from sdumc_tpu_torch.train.state import create_train_state
    from sdumc_tpu_torch.train.step import make_train_step

    state = create_train_state(model, cfg.train, 8)
    return make_train_step(state, cfg.loss, cfg.train.seed)


def step_parity_phase(torch):
    """One train step (dual-view loss, backward, Adam) with dropout off from
    the same seeded weights on the first train batch: card against CPU."""
    import dataclasses

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.data.pipeline import get_loaders
    from sdumc_tpu_torch.models import get_model
    from sdumc_tpu_torch.train.step import batch_to_device_dict

    cfg = main_path_config()
    set_matmul_precision(cfg.model.matmul_precision)
    train_ds, _, _ = get_loaders(cfg.data.dataset, cfg.data, cfg.paths, synthetic=True)
    batch = first_train_batch(cfg, train_ds)
    mcfg = dataclasses.replace(cfg.model, input_dims=train_ds.input_dims()[:3],
                               dropout=0.0, attn_dropout=0.0)

    def run(dev):
        model = get_model(mcfg, torch.Generator().manual_seed(cfg.train.seed)).to(dev)
        metrics = make_step(torch, cfg, model)(batch_to_device_dict(batch, dev))
        return (metrics["loss"].item(),
                {k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None})

    def worst_ratio(g_ref, g):
        if g_ref.keys() != g.keys():
            raise AssertionError("card and CPU steps give gradients to different parameters")
        return max(((g[k] - ref).abs().max().item() / (GRAD_RTOL * ref.abs().max().item()
                                                        + GRAD_ATOL), k)
                   for k, ref in g_ref.items())

    (loss_cpu, g_cpu), (loss_card, g_card) = run("cpu"), run("cuda")
    worst, worst_key = worst_ratio(g_cpu, g_card)
    print(f"one train step, card vs CPU (T = {batch.audio.shape[1]} / {batch.text.shape[1]} / "
          f"{batch.video.shape[1]}, dropout off): loss {loss_card!r} vs {loss_cpu!r} (rtol "
          f"{STEP_LOSS_RTOL}); {len(g_cpu)} gradients, worst max-abs-diff / (GRAD_RTOL max|grad| "
          f"+ GRAD_ATOL) = {worst!r} at {worst_key} (GRAD_RTOL={GRAD_RTOL}, GRAD_ATOL={GRAD_ATOL}: "
          f"f32 reassociation through the net and its backward; must be <= 1)")
    if abs(loss_card - loss_cpu) > STEP_LOSS_RTOL * abs(loss_cpu) or worst > 1.0:
        raise AssertionError("card and CPU train steps disagree")

    # control: the same card step with TF32 allowed must fail the check
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        loss_tf32, g_tf32 = run("cuda")
    finally:
        set_matmul_precision(cfg.model.matmul_precision)
    tf32_worst, tf32_key = worst_ratio(g_cpu, g_tf32)
    print(f"control, the card step with torch.backends.cuda.matmul.allow_tf32 = True: loss "
          f"{loss_tf32!r}, worst ratio {tf32_worst!r} at {tf32_key} (must be > 1)")
    if tf32_worst <= 1.0:
        raise AssertionError("the gradient check does not see TF32 in the train step")


def step_timing_phase(torch):
    """A warm train step (the live dropouts) on the card's copy of the first
    train batch: CUDA events over TIMED_STEPS steps, peak memory, then
    device time by family of PROFILED_STEPS steps under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdumc_tpu_torch.cli.common import build_model, set_matmul_precision
    from sdumc_tpu_torch.data.pipeline import get_loaders
    from sdumc_tpu_torch.train.step import batch_to_device_dict

    cfg = main_path_config()
    set_matmul_precision(cfg.model.matmul_precision)
    bs = cfg.data.batch_size
    train_ds, _, _ = get_loaders(cfg.data.dataset, cfg.data, cfg.paths, synthetic=True)
    batch = first_train_batch(cfg, train_ds)
    model = build_model(cfg, train_ds.input_dims(), torch.device("cuda"))
    step = make_step(torch, cfg, model)
    d = batch_to_device_dict(batch, "cuda")
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: step(d), iters=TIMED_STEPS, warmup=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"warm train step (batch {bs}, dual view = {2 * bs} rows, T = {batch.audio.shape[1]} / "
          f"{max(batch.text.shape[1], batch.feat4.shape[1])} / {batch.video.shape[1]}, batch "
          f"on the card): {ms!r} ms per step over {TIMED_STEPS} steps (CUDA events), "
          f"{bs / ms * 1e3!r} clips/s; peak device memory {peak!r} GiB")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            step(d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_device_time(prof, wall, f"profiled train steps ({PROFILED_STEPS}, warm)", TRAIN_FAMILIES,
                      "elementwise, softmax and reductions (the plain backward, losses)")
    host_ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)
    launches = sum(e.count for e in host_ops if "LaunchKernel" in e.key)
    print(f"host side: {launches / PROFILED_STEPS!r} kernel launches per step; host ops by "
          f"self time:")
    for e in host_ops[:8]:
        print(f"  {e.self_cpu_time_total / 1e3 / PROFILED_STEPS:10.3f} ms per step "
              f"{e.count // PROFILED_STEPS:6d} calls  {e.key[:80]}")
    return ms


# ---------------------------------------------------------------- feat4 (phases 10-12)

def feat4_config(torch, num_layers: int, **kw):
    """Vicuna-7B-v1.5's published widths (lmsys/vicuna-7b-v1.5 config.json)
    at `num_layers` layers."""
    from sdumc_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(**VICUNA, num_layers=num_layers, **kw)


def beam_chunk(torch, model, cfg, prompts, lens, max_new, **kw):
    from sdumc_tpu_torch.models.generation import beam_generate_batched

    with torch.inference_mode():
        return beam_generate_batched(model, prompts, cfg, embed_fn=model.model.embed_tokens,
                                     prompt_len=lens, num_beams=BEAMS, max_new_tokens=max_new,
                                     eos_id=2, **kw)


def llama_parity_phase(torch):
    """Phase 10: the decoder at Vicuna-7B width (2 layers, f32, TF32 off,
    seeded weights), card against CPU: full-sequence logits and tap sum of
    one prompt, then a beam-4 decode of 2 clips of different lengths in one
    bucket."""
    import copy

    import numpy as np

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.models.llama import LlamaForCausalLM, init_weights

    set_matmul_precision("highest")
    cfg = feat4_config(torch, CLI_LAYERS, dtype=torch.float32)
    cpu_model = init_weights(LlamaForCausalLM(cfg), seed=0).eval()
    card_model = copy.deepcopy(cpu_model).to(DEVICE)
    rng = np.random.default_rng(10)
    bucket, lens = 64, [41, 57]
    prompts = np.zeros((2, bucket, cfg.hidden_size), np.float32)
    for c, n in enumerate(lens):
        prompts[c, bucket - n:] = 0.5 * rng.standard_normal((n, cfg.hidden_size))
    prompts = torch.from_numpy(prompts)
    outs = {}
    for dev, model in (("cpu", cpu_model), (DEVICE, card_model)):
        with torch.inference_mode():
            full = model(inputs_embeds=prompts[1:, bucket - lens[1]:].to(dev),
                         tap_sum_layers=TAP_LAYERS)
        trace = {}
        beam = beam_chunk(torch, model, cfg, prompts.to(dev), lens, PARITY_STEPS, trace=trace)
        outs[dev] = ({k: full[k].cpu() for k in ("logits", "tap_sum")},
                     {k: v.cpu() for k, v in beam.items()}, trace["gap"].cpu())
    (full_cpu, beam_cpu, gap_cpu), (full_card, beam_card, gap_card) = outs["cpu"], outs[DEVICE]
    print(f"decoder at Vicuna-7B width (vocab {cfg.vocab_size}, hidden {cfg.hidden_size}, "
          f"{cfg.num_heads} heads, FFN {cfg.intermediate_size}, {cfg.num_layers} layers, f32, TF32 "
          f"off), card vs CPU (tolerance rtol={LLAMA_RTOL} atol={LLAMA_ATOL}: f32 reassociation "
          f"through the layers and the {cfg.vocab_size}-way lm_head):")
    for key in ("logits", "tap_sum"):
        err = (full_card[key] - full_cpu[key]).abs().max().item()
        print(f"  full sequence ({lens[1]} positions) {key}: max abs diff {err!r}, max |value| "
              f"{full_cpu[key].abs().max().item()!r}")
        if not torch.allclose(full_card[key], full_cpu[key], rtol=LLAMA_RTOL, atol=LLAMA_ATOL):
            raise AssertionError(f"full-sequence {key}: card and CPU disagree")
    same = torch.equal(beam_card["tokens"], beam_cpu["tokens"]) and torch.equal(
        beam_card["n_steps"], beam_cpu["n_steps"])
    err = (beam_card["taps"] - beam_cpu["taps"]).abs().max().item()
    print(f"  beam-{BEAMS} decode, 2 clips (prompt lengths {lens} in bucket {bucket}), "
          f"{PARITY_STEPS} steps: tokens equal {same}, taps max abs diff {err!r} (max |tap| "
          f"{beam_cpu['taps'].abs().max().item()!r}); smallest gap between the {BEAMS}th and "
          f"{BEAMS + 1}th candidate score over the run: card {gap_card.tolist()}, CPU "
          f"{gap_cpu.tolist()}")
    print(f"  tokens (card) {beam_card['tokens'][:, :PARITY_STEPS].tolist()}")
    if not same:
        print(f"  tokens (CPU)  {beam_cpu['tokens'][:, :PARITY_STEPS].tolist()}")
        raise AssertionError("beam decode: card and CPU tokens differ")
    if not torch.allclose(beam_card["taps"], beam_cpu["taps"], rtol=LLAMA_RTOL, atol=LLAMA_ATOL):
        raise AssertionError("beam decode: card and CPU taps disagree")


def llama_vocab(words):
    """A small LLaMA-style tokenizer.json vocabulary covering `words`:
    <unk>/<s>/</s>, the byte tokens <0x00>-<0xFF> (ids 3-258, as LLaMA's),
    every character of the words, and each word built up left to right
    from its first character (merge ranks in that order). Any other
    character falls back to its UTF-8 bytes."""
    space = "▁"
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    vocab.update({f"<0x{b:02X}>": 3 + b for b in range(256)})
    pieces = [space + w for w in dict.fromkeys(words)] + [space]
    for ch in sorted(set("".join(pieces))):
        vocab.setdefault(ch, len(vocab))
    merges = []
    for w in pieces:
        for n in range(2, len(w) + 1):
            if w[:n] not in vocab:
                vocab[w[:n]] = len(vocab)
                merges.append(f"{w[:n - 1]} {w[n - 1]}")
    return vocab, merges


def write_vicuna_dir(torch, path: str, num_layers: int, seed: int = 1):
    """A seeded Vicuna-7B-v1.5 in HF's format at `num_layers` layers:
    config.json with HF's key names; fp16 weights at the published shapes,
    normal(0, 0.02) as HF's init draws them, norms 1, in two shards
    pytorch_model-0000k-of-00002.bin with pytorch_model.bin.index.json;
    tokenizer_config.json and a hand-written tokenizer.json (BPE with byte
    fallback, LLaMA's normalizer and decoder) that covers the ASR prompt,
    the text stage's probe and the transcripts' words."""
    from sdumc_tpu_torch.extract.llm4wav import DEFAULT_PROMPT
    from sdumc_tpu_torch.models.llama import LlamaForCausalLM

    cfg = feat4_config(torch, num_layers)
    config = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
              "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
              "intermediate_size": cfg.intermediate_size, "num_hidden_layers": num_layers,
              "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_heads,
              "rms_norm_eps": cfg.rms_eps, "rope_theta": cfg.rope_theta,
              "max_position_embeddings": cfg.max_position_embeddings, "bos_token_id": 1,
              "eos_token_id": 2, "pad_token_id": 0, "tie_word_embeddings": False,
              "torch_dtype": "float16", "hidden_act": "silu"}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    with torch.device("meta"):
        shapes = {k: t.shape for k, t in LlamaForCausalLM(cfg).state_dict().items()}
    gen = torch.Generator().manual_seed(seed)
    names = [f"pytorch_model-0000{i}-of-00002.bin" for i in (1, 2)]
    shards, weight_map, total = ({}, {}), {}, 0
    for key, shape in shapes.items():
        t = (torch.ones(shape) if key.endswith("norm.weight")
             else 0.02 * torch.randn(shape, generator=gen)).half()
        i = 0 if key.startswith("model.embed_tokens") or key.startswith("model.layers.0.") else 1
        shards[i][key] = t
        weight_map[key] = names[i]
        total += t.numel() * 2
    for name, shard in zip(names, shards):
        torch.save(shard, os.path.join(path, name))
    with open(os.path.join(path, "pytorch_model.bin.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    vocab, merges = llama_vocab(DEFAULT_PROMPT.split() + PROBE.split() + MOSEI_WORDS)
    space = "▁"
    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": i, "content": t, "single_word": False, "lstrip": False,
                              "rstrip": False, "normalized": False, "special": True}
                             for t, i in (("<unk>", 0), ("<s>", 1), ("</s>", 2))],
            "normalizer": {"type": "Sequence", "normalizers": [
                {"type": "Prepend", "prepend": space},
                {"type": "Replace", "pattern": {"String": " "}, "content": space}]},
            "pre_tokenizer": None, "post_processor": None,
            "decoder": {"type": "Sequence", "decoders": [
                {"type": "Replace", "pattern": {"String": space}, "content": " "},
                {"type": "ByteFallback"}, {"type": "Fuse"},
                {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
            "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": True, "byte_fallback": True, "vocab": vocab, "merges": merges}}
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"add_bos_token": True, "add_eos_token": False, "bos_token": "<s>",
                   "eos_token": "</s>", "unk_token": "<unk>"}, f)
    return total


def write_projector(torch, path: str, seed: int = 2):
    """A seeded EncoderProjectorConcat (5 x 1024 -> 2048 -> 4096) saved as the
    released checkpoint is, keys prefixed ``encoder_projector.``."""
    from sdumc_tpu_torch.extract.projector import EncoderProjectorConcat

    torch.manual_seed(seed)
    proj = EncoderProjectorConcat()
    torch.save({"encoder_projector." + k: v for k, v in proj.state_dict().items()}, path)


def feat4_cli_phase(torch, tmp: str, feats_dir: str):
    """Phase 11: ``cli.extract feat4`` with its defaults (the card, bf16,
    beam 4, --gen_batch 4, --max_new_tokens 200) on a seeded 2-layer Vicuna
    in HF's format and the WavLM features of phase 5; every output checked;
    one 4-clip chunk against the same clips decoded alone."""
    import glob

    import numpy as np

    from sdumc_tpu_torch.cli import extract
    from sdumc_tpu_torch.convert.hf_llama import load_hf_llama
    from sdumc_tpu_torch.convert.llama_tokenizer import LlamaTokenizer
    from sdumc_tpu_torch.extract.llm4wav import Feat4Extractor
    from sdumc_tpu_torch.extract.projector import load_projector

    llm_dir, proj_path, save_dir = (os.path.join(tmp, n) for n in ("vicuna", "proj.pt", "feat4"))
    t0 = time.perf_counter()
    nbytes = write_vicuna_dir(torch, llm_dir, CLI_LAYERS)
    write_projector(torch, proj_path)
    print(f"seeded Vicuna-7B-v1.5 widths at {CLI_LAYERS} layers in HF's format "
          f"({nbytes / 1e9!r} GB fp16 in 2 shards) and a projector in "
          f"{time.perf_counter() - t0!r} s")
    files = sorted(glob.glob(os.path.join(feats_dir, "*.npy")))
    reset_counts()
    out = extract.main(["feat4", "--llm_dir", llm_dir, "--projector_path", proj_path,
                        "--wavlm_dir", feats_dir, "--save_dir", save_dir, "--device", DEVICE])
    torch.cuda.synchronize()
    counts = read_counts()
    if out["clips"] != len(files):
        raise AssertionError(f"feat4: {out['clips']} of {len(files)} clips extracted")
    steps = []
    for path in files:
        taps = np.load(os.path.join(save_dir, os.path.basename(path)))
        if (taps.ndim != 2 or taps.shape[1] != VICUNA["hidden_size"]
                or not 1 <= len(taps) <= MAX_NEW or taps.dtype != np.float32
                or not np.isfinite(taps).all()):
            raise AssertionError(f"{path}: taps {taps.shape} {taps.dtype} or non-finite")
        steps.append(len(taps))
    print(f"feat4 path (cli.extract feat4, defaults): {out['clips']} clips, {out['steps']} taps "
          f"rows (steps per clip {sorted(set(steps))}), {out['seconds']!r} s host clock "
          f"(weights loaded before it), {out['steps'] / out['seconds']!r} clip-tokens/s; "
          f"launches of the port's kernels on this path {counts} (the decode runs cuBLAS "
          f"and PyTorch's own kernels only)")

    # one 4-clip chunk (the CLI's first) against each of its clips alone
    # (a chunk of one, filled by repeating it, as a tail chunk is)
    _, model = load_hf_llama(llm_dir, device=DEVICE)
    ex = Feat4Extractor(model, load_projector(proj_path, device=DEVICE),
                        LlamaTokenizer.from_dir(llm_dir), gen_batch=GEN_BATCH)
    pending = sorted(((ex.prompt_len_for(np.load(p, mmap_mode="r").shape[0]), p) for p in files))
    bucket_of = lambda n: next((b for b in ex.prompt_buckets if n <= b), n)  # noqa: E731
    first = [p for n, p in pending if bucket_of(n) == bucket_of(pending[0][0])][:GEN_BATCH]
    feats = [np.load(p) for p in first]
    chunk = ex.extract_many(feats)
    worst, same = 0.0, True
    for path, f, got in zip(first, feats, chunk):
        solo = ex.extract_many([f])[0]
        same &= bool(np.array_equal(got["tokens"], solo["tokens"])) and \
            got["taps"].shape == solo["taps"].shape
        if got["taps"].shape == solo["taps"].shape:
            worst = max(worst, float(np.abs(got["taps"] - solo["taps"]).max()))
            if not np.allclose(got["taps"], solo["taps"], rtol=BF16_RTOL, atol=BF16_ATOL):
                same = False
    cli_worst = max(float(np.abs(np.load(os.path.join(save_dir, os.path.basename(p)))
                                 - got["taps"]).max()) for p, got in zip(first, chunk))
    print(f"one {len(first)}-clip chunk (prompt bucket {bucket_of(pending[0][0])}) against each "
          f"clip alone: tokens and step counts equal {same}, taps max abs diff {worst!r}; the "
          f"CLI's saved taps of the same clips (decoded in its own chunks) max abs diff "
          f"{cli_worst!r} (tolerance rtol={BF16_RTOL} atol={BF16_ATOL}: bf16, the same GEMM "
          f"shapes in all)")
    if not same or not cli_worst <= BF16_ATOL + BF16_RTOL * max(
            float(np.abs(g["taps"]).max()) for g in chunk):
        raise AssertionError("feat4: a chunk and its clips decoded alone disagree")
    del model, ex
    torch.cuda.empty_cache()
    return llm_dir, proj_path


def weight_bytes(model) -> int:
    """Bytes a decode step streams for the weights: every Linear (codes and
    scales) and norm; not the embedding (a gather of one row per beam)."""
    return sum(t.numel() * t.element_size() for n, t in
               list(model.named_parameters()) + list(model.named_buffers())
               if "embed_tokens" not in n)


def decode_bound_ms(cfg, wbytes: int, C: int, P: int, steps: int) -> float:
    """Least time of one decode step, averaged over `steps` steps: the
    larger of the bytes (the weights and the KV cache each read once: the
    prompt part per clip, the generated part per beam up to the step; k and
    v, with their f32 scales under int8-KV) at the HBM rate, and the
    operations (2 per weight and row, C x BEAMS rows) at the bf16
    tensor-core rate, which is far below."""
    per_slot = 2 * cfg.num_layers * cfg.kv_heads * (
        cfg.head_dim * (1 if cfg.kv_quant else 2) + (4 if cfg.kv_quant else 0))
    kv = per_slot * (C * P + C * BEAMS * (steps - 1) / 2)
    n_weights = cfg.num_layers * (4 * cfg.hidden_size ** 2 + 3 * cfg.hidden_size
                                  * cfg.intermediate_size) + cfg.hidden_size * cfg.vocab_size
    return 1e3 * max((wbytes + kv) / PEAK_HBM_BYTES,
                     2 * n_weights * C * BEAMS / PEAK_BF16_FLOPS)


def time_decode(torch, model, cfg, prompts, lens, steps: int):
    """(ms per decode step by CUDA events, the run's outputs): a run of
    `steps` new tokens minus a run of 1 (the prefill and the first
    selection), over the steps-1 decode forwards."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    beam_chunk(torch, model, cfg, prompts, lens, 2)             # warm
    torch.cuda.synchronize()
    ev[0].record()
    beam_chunk(torch, model, cfg, prompts, lens, 1)
    ev[1].record()
    ev[2].record()
    out = beam_chunk(torch, model, cfg, prompts, lens, steps)
    ev[3].record()
    torch.cuda.synchronize()
    n = int(out["n_steps"].max())
    return (ev[2].elapsed_time(ev[3]) - ev[0].elapsed_time(ev[1])) / max(n - 1, 1), out


def profile_decode(torch, model, cfg, prompts, lens, first: int = PROFILE_FROM,
                   steps: int = PROFILED_DECODE_STEPS):
    """Device time by family, host launches and the idle share of decode
    steps first+1 .. first+steps: two profiled runs (first + 1 and first +
    steps + 1 new tokens) and their difference, so the prefill and the
    earlier steps drop out. The profiler records every op of both runs,
    so a late window (first of about 100) takes minutes; the default is
    the first steps, with the generated cache nearly empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runs = []
    for n in (first + 1, first + steps + 1):
        beam_chunk(torch, model, cfg, prompts, lens, n)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            beam_chunk(torch, model, cfg, prompts, lens, n)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        fams, busy = {}, 0.0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
                continue
            name = e.key.lower()
            fam = next((f for f, keys in DECODE_FAMILIES if any(k in name for k in keys)),
                       "elementwise and reductions (norms, rope, casts, attention math)")
            fams[fam] = fams.get(fam, 0.0) + e.self_device_time_total / 1e3
            busy += e.self_device_time_total / 1e6
        launches = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU and "LaunchKernel" in e.key)
        runs.append((fams, busy, wall, launches))
    (f1, b1, w1, l1), (f2, b2, w2, l2) = runs
    per = {k: (f2.get(k, 0.0) - f1.get(k, 0.0)) / steps for k in set(f1) | set(f2)}
    total = sum(per.values())
    if total <= 0:
        print("  profiled decode: the trace held no device time (not measured)")
        return
    print(f"  profiled decode (steps {first + 1}-{first + steps}, the difference of a "
          f"{first + steps + 1}-token and a {first + 1}-token run): device {total!r} ms per "
          f"step, idle share "
          f"{1 - (b2 - b1) / (w2 - w1)!r}, {(l2 - l1) / steps!r} host kernel launches per step; "
          f"device time per step by family:")
    for fam, ms in sorted(per.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:9.4f} ms {ms / total:7.2%}  {fam}")


def full_depth_phase(torch, llm_dir: str, proj_path: str, feats_dir: str):
    """Phase 12: Vicuna-7B at 32 layers in bf16 (seeded on the card) through
    Feat4Extractor.extract_many on phase 5's features at --gen_batch 4; a
    timed and profiled chunk; then one chunk of 32 steps with int8, w8a8
    and int8-KV, each against bf16."""
    import dataclasses
    import glob

    import numpy as np

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.convert.llama_tokenizer import LlamaTokenizer
    from sdumc_tpu_torch.extract.llm4wav import Feat4Extractor
    from sdumc_tpu_torch.extract.projector import load_projector
    from sdumc_tpu_torch.models.llama import LlamaForCausalLM, init_weights, model_from_state_dict
    from sdumc_tpu_torch.ops.quant import quantize_params

    set_matmul_precision("highest")
    cfg = feat4_config(torch, VICUNA_LAYERS)
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    model = init_weights(model.to_empty(device=DEVICE), seed=3).eval()
    torch.cuda.synchronize()
    wbytes = weight_bytes(model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Vicuna-7B-v1.5 at full depth ({cfg.num_layers} layers, bf16, {n_params} parameters, "
          f"{wbytes / 1e9!r} GB streamed per step), seeded on the card in "
          f"{time.perf_counter() - t0!r} s")
    ex = Feat4Extractor(model, load_projector(proj_path, device=DEVICE),
                        LlamaTokenizer.from_dir(llm_dir), max_new_tokens=MAX_NEW,
                        gen_batch=GEN_BATCH)
    files = sorted(glob.glob(os.path.join(feats_dir, "*.npy")))
    feats = [np.load(p) for p in files]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = ex.extract_many(feats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_tok = sum(len(r["taps"]) for r in results)
    for path, r in zip(files, results):
        if r["taps"].shape[1] != cfg.hidden_size or not np.isfinite(r["taps"]).all():
            raise AssertionError(f"{path}: taps {r['taps'].shape} or non-finite")
    per_clip = sorted({len(r["taps"]) for r in results})
    print(f"full depth, Feat4Extractor.extract_many on {len(feats)} clips at --gen_batch "
          f"{GEN_BATCH}: {n_tok} taps rows (steps per clip {per_clip}), {seconds!r} s host "
          f"clock, {n_tok / seconds!r} clip-tokens/s; peak device memory {peak!r} GiB")

    # the timed chunk: the first GEN_BATCH clips of the 256 bucket (else the largest full one)
    lens_all = [ex.prompt_len_for(len(f)) for f in feats]
    buckets = [next((b for b in ex.prompt_buckets if n <= b), n) for n in lens_all]
    bucket = 256 if buckets.count(256) >= GEN_BATCH else max(
        b for b in set(buckets) if buckets.count(b) >= GEN_BATCH)
    pick = [i for i, b in enumerate(buckets) if b == bucket][:GEN_BATCH]
    prompts = torch.stack([ex._padded_prompt(feats[i], bucket) for i in pick])
    lens = [lens_all[i] for i in pick]
    ms, out = time_decode(torch, model, cfg, prompts, lens, MAX_NEW)
    steps = int(out["n_steps"].max())
    bound = decode_bound_ms(cfg, wbytes, GEN_BATCH, bucket, steps)
    print(f"  timed chunk ({GEN_BATCH} clips, prompt bucket {bucket}, {steps} steps): {ms!r} ms "
          f"per decode step (CUDA events), {GEN_BATCH * 1e3 / ms!r} clip-tokens/s; bound "
          f"{bound!r} ms per step (weights {wbytes / 1e9!r} GB + the KV cache at "
          f"{PEAK_HBM_BYTES / 1e12} TB/s), {bound / ms:.1%} of it")
    profile_decode(torch, model, cfg, prompts, lens)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    def forward_taps(m):       # teacher-forced: one forward over the chunk's real prompts
        with torch.inference_mode():
            return torch.cat([m(inputs_embeds=prompts[c:c + 1, bucket - n:],
                                tap_sum_layers=TAP_LAYERS)["tap_sum"][0]
                              for c, n in enumerate(lens)])

    ref_ms, ref = time_decode(torch, model, cfg, prompts, lens, QUANT_STEPS)
    ref_fwd = forward_taps(model)
    print(f"  bf16, {QUANT_STEPS} steps on the same chunk: {ref_ms!r} ms per step")
    for quant, kv_quant in (("int8", None), ("w8a8", None), (None, "int8")):
        qcfg = dataclasses.replace(cfg, quant=quant, kv_quant=kv_quant)
        sd = dict(model.state_dict())
        qmodel = model_from_state_dict(qcfg, quantize_params(sd, quant) if quant else sd)
        qms, qout = time_decode(torch, qmodel, qcfg, prompts, lens, QUANT_STEPS)
        qbytes = weight_bytes(qmodel)
        n = int(qout["n_steps"].min())
        shifts = (rel(forward_taps(qmodel), ref_fwd),
                  rel(qout["taps"][:, 0], ref["taps"][:, 0]),
                  rel(qout["taps"][:, :n], ref["taps"][:, :n]))
        same = torch.equal(qout["tokens"][:, :n], ref["tokens"][:, :n])
        if not all(map(math.isfinite, shifts)):
            raise AssertionError(f"{quant or kv_quant}: non-finite taps")
        print(f"  --quant {quant} --kv_quant {kv_quant}: {qms!r} ms per step (CUDA events, "
              f"{QUANT_STEPS} steps), bound "
              f"{decode_bound_ms(qcfg, qbytes, GEN_BATCH, bucket, QUANT_STEPS)!r} ms "
              f"({qbytes / 1e9!r} GB of weights); taps' relative shift from bf16's "
              f"(||delta|| / ||bf16||): {shifts[0]!r} in a teacher-forced forward over the "
              f"prompts (the cache plays no part there), {shifts[1]!r} at the first decode "
              f"step, {shifts[2]!r} over {n} decode steps (best hypotheses equal {same}; "
              f"beams that part make the taps part)")
        del qmodel, sd
        torch.cuda.empty_cache()
    del model, ex
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- text and visual (phases 13-16)

def transcripts(seed: int = 4):
    """N_TRANSCRIPTS seeded MOSEI-like transcripts [(name, sentence)]: 3-60
    words drawn from MOSEI_WORDS, one of LONG_WORDS words (about 200
    tokens), one empty and one with non-ASCII words."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = [" ".join(rng.choice(MOSEI_WORDS, size=int(rng.integers(3, 61))))
            for _ in range(N_TRANSCRIPTS - 3)]
    rows += [" ".join(rng.choice(MOSEI_WORDS, size=LONG_WORDS)), "", NON_ASCII]
    return [(f"utt_{i:03d}", s) for i, s in enumerate(rows)]


def text_cli_phase(torch, tmp: str, llm_dir: str):
    """Phase 13: ``cli.extract text`` with its defaults on phase 11's
    2-layer Vicuna directory; every output checked; the 16 shortest
    transcripts (one batch of one bucket) through the f32 trunk, card
    against CPU. Returns the transcripts."""
    import csv

    import numpy as np

    from sdumc_tpu_torch.cli import extract
    from sdumc_tpu_torch.convert.hf_llama import load_hf_llama_trunk
    from sdumc_tpu_torch.convert.llama_tokenizer import LlamaTokenizer
    from sdumc_tpu_torch.extract.text import extract_text_features, find_token_span

    rows = transcripts()
    csv_path, save_dir = os.path.join(tmp, "transcripts.csv"), os.path.join(tmp, "text")
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(["name", "sentence"])
        writer.writerows(rows)
    tok = LlamaTokenizer.from_dir(llm_dir)
    start, end = find_token_span(tok)
    hidden = VICUNA["hidden_size"]
    reset_counts()
    out = extract.main(["text", "--model_dir", llm_dir, "--trans_path", csv_path,
                        "--save_dir", save_dir])
    torch.cuda.synchronize()
    counts = read_counts()
    n_tok = {name: len(tok(s)["input_ids"]) if s.strip() else 0 for name, s in rows}
    for name, _ in rows:
        feat = np.load(os.path.join(save_dir, f"{name}.npy"))
        n = n_tok[name]
        want = (n - start + end, hidden) if n else (1, hidden)
        if (feat.shape != want or feat.dtype != np.float32 or not np.isfinite(feat).all()
                or (not n and feat.any())):
            raise AssertionError(f"{name}: {feat.shape} {feat.dtype} (want {want}) or non-finite")
    ids = tok(NON_ASCII)["input_ids"]
    if tok.decode(ids[start:]) != NON_ASCII:
        raise AssertionError(f"decode of {NON_ASCII!r}: {tok.decode(ids[start:])!r}")
    print(f"text path (cli.extract text, defaults: bf16, FRAME, taps -4..-1, batch {TEXT_BATCH}): "
          f"{out['rows']} transcripts, {sum(n_tok.values())} tokens (longest {max(n_tok.values())}"
          f"), probe span ({start}, {end}), {out['seconds']!r} s host clock (weights loaded "
          f"before it), {out['rows'] / out['seconds']!r} sentences/s; launches of the port's "
          f"kernels {counts} (the text stage runs cuBLAS and PyTorch's own kernels only); "
          f"{NON_ASCII!r} is {len(ids)} tokens, decoded back exactly")

    short = sorted((n_tok[name], s) for name, s in rows if n_tok[name])[:TEXT_BATCH]
    sents = [s for _, s in short]
    feats = {}
    for dev in ("cpu", DEVICE):
        _, trunk = load_hf_llama_trunk(llm_dir, device=dev, dtype=torch.float32)
        feats[dev] = extract_text_features(trunk, tok, sents)
        del trunk
    err = max(float(np.abs(g - r).max()) for g, r in zip(feats[DEVICE], feats["cpu"]))
    top = max(float(np.abs(r).max()) for r in feats["cpu"])
    print(f"one batch ({len(sents)} transcripts of {short[0][0]}-{short[-1][0]} tokens), f32 "
          f"trunk, TF32 off, card vs CPU: max abs diff {err!r}, max |feature| {top!r} (tolerance "
          f"rtol={LLAMA_RTOL} atol={LLAMA_ATOL}: f32 reassociation through 2 layers)")
    if not all(np.allclose(g, r, rtol=LLAMA_RTOL, atol=LLAMA_ATOL)
               for g, r in zip(feats[DEVICE], feats["cpu"])):
        raise AssertionError("text features: card and CPU disagree")
    torch.cuda.empty_cache()
    return rows


def text_full_depth_phase(torch, llm_dir: str, rows):
    """Phase 14: the Vicuna-7B trunk at 32 layers in bf16 (seeded on the
    card) through extract_text_features on the transcripts, with each tap
    set: sentences/s, peak memory, ms per batch by CUDA events beside the
    bound, and device time by family of a profiled run."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.convert.llama_tokenizer import LlamaTokenizer
    from sdumc_tpu_torch.extract.text import BUCKETS, extract_text_features, run_batch
    from sdumc_tpu_torch.models.llama import LlamaModel, init_weights

    set_matmul_precision("highest")
    cfg = feat4_config(torch, VICUNA_LAYERS)
    t0 = time.perf_counter()
    with torch.device("meta"):
        trunk = LlamaModel(cfg)
    trunk = init_weights(trunk.to_empty(device=DEVICE), seed=5).eval()
    torch.cuda.synchronize()
    body = [p for n, p in trunk.named_parameters() if "embed_tokens" not in n]
    n_body = sum(p.numel() for p in body)
    wbytes = sum(p.numel() * p.element_size() for p in body)
    print(f"Vicuna-7B-v1.5 trunk at full depth ({cfg.num_layers} layers, bf16, {n_body} "
          f"non-embedding parameters, {wbytes / 1e9!r} GB), seeded on the card in "
          f"{time.perf_counter() - t0!r} s")
    tok = LlamaTokenizer.from_dir(llm_dir)
    sents = [s for _, s in rows]
    torch.cuda.reset_peak_memory_stats()
    for taps in TEXT_TAPS:
        extract_text_features(trunk, tok, sents, layer_ids=taps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = extract_text_features(trunk, tok, sents, layer_ids=taps)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if not all(np.isfinite(f).all() and f.shape[1] == cfg.hidden_size for f in feats):
            raise AssertionError(f"taps {taps}: non-finite features or wrong width")
        print(f"  --layer_ids {','.join(map(str, taps))}: {len(sents)} transcripts in {seconds!r} s "
              f"host clock (tokenizing included, warm), {len(sents) / seconds!r} sentences/s")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30!r} GiB")

    # one full batch of the most populated bucket, timed alone
    ids_of = [tok(s)["input_ids"] for s in sents if s.strip()]
    bucket_of = [next((b for b in BUCKETS if len(i) <= b), len(i)) for i in ids_of]
    bucket = max(set(bucket_of), key=bucket_of.count)
    chunk = [i for i, b in zip(ids_of, bucket_of) if b == bucket][:TEXT_BATCH]
    ids = torch.zeros(TEXT_BATCH, bucket, dtype=torch.long)
    for j, row in enumerate(chunk):
        ids[j, :len(row)] = torch.tensor(row)
    lengths = torch.tensor([len(r) for r in chunk] + [0] * (TEXT_BATCH - len(chunk)))
    ids, lengths = ids.to(DEVICE), lengths.to(DEVICE)
    with torch.inference_mode():
        ms = time_ms(lambda: run_batch(trunk, ids, lengths, TEXT_TAPS[0]), iters=10, warmup=2)
    real = int(lengths.sum())
    ops_ms = 1e3 * 2 * n_body * real / PEAK_BF16_FLOPS
    bytes_ms = 1e3 * wbytes / PEAK_HBM_BYTES
    bound = max(ops_ms, bytes_ms)
    padded_ms = 1e3 * 2 * n_body * TEXT_BATCH * bucket / PEAK_BF16_FLOPS
    print(f"  one batch ({len(chunk)} transcripts in bucket {bucket}, {real} real of "
          f"{TEXT_BATCH * bucket} tokens, taps -3): {ms!r} ms (CUDA events, 10 runs); bound "
          f"{bound!r} ms = max(2 x {n_body} x {real} flops at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s "
          f"= {ops_ms!r}, {wbytes / 1e9!r} GB at {PEAK_HBM_BYTES / 1e12} TB/s = {bytes_ms!r}), "
          f"{bound / ms:.1%} of it (the padded tokens' flops: {padded_ms!r} ms)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extract_text_features(trunk, tok, sents, layer_ids=TEXT_TAPS[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_device_time(prof, wall, "  profiled text extraction (taps -4..-1, warm)", TEXT_FAMILIES,
                      "elementwise, norms, rope, casts and the tap sum", top=10)
    del trunk
    torch.cuda.empty_cache()


def write_bmp(path: str, rgb) -> None:
    """A 24-bit BI_RGB BMP, bottom-up, rows padded to 4 bytes (OpenFace's
    aligned-crop format), written with numpy."""
    import numpy as np

    h, w, _ = rgb.shape
    stride = (3 * w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)
    header = (struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
              + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0))
    with open(path, "wb") as f:
        f.write(header + rows.tobytes())


def random_image(rng, size: int):
    """A seeded [size, size, 3] uint8 image: a smooth gradient plus noise."""
    import numpy as np

    ramp = np.linspace(0, 1, size)
    base = 255 * rng.uniform(size=3) * (ramp[:, None, None] + ramp[None, :, None]) / 2
    return np.clip(base + rng.normal(0, 20, size=(size, size, 3)), 0, 255).astype(np.uint8)


def write_manet_checkpoint(torch, path: str, seed: int = 6) -> None:
    """A seeded MANet (RAF-DB, 7 classes) saved as the released .pth is:
    ``{"state_dict": ...}`` with ``module.``-prefixed keys; BN scales,
    biases and running statistics drawn at random."""
    from sdumc_tpu_torch.models.manet import MANet, init_weights

    model = init_weights(MANet(), seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    torch.save({"state_dict": {"module." + k: v for k, v in model.state_dict().items()},
                "epoch": 0, "best_acc": 0.0}, path)


def manet_macs(torch, model) -> int:
    """Multiply-accumulates of one 224x224 frame through every Conv2d and
    Linear that the forward runs (forward hooks, batch 1)."""
    macs = []

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
        else:
            k = mod.in_features
        macs.append(out.numel() * k)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    dev = next(model.parameters()).device
    with torch.inference_mode():
        model(torch.zeros(1, 3, 224, 224, device=dev))
    for h in hooks:
        h.remove()
    return sum(macs)


def visual_phase(torch, tmp: str):
    """Phase 15: ``cli.extract visual`` with its defaults on a seeded MANet
    .pth and 12 clips of BMP face crops; outputs checked; one clip's first
    batch card against CPU, and the TF32 control; a warm run; a profiled
    warm run of the shortest clips; the f32 bound."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from sdumc_tpu_torch.cli import extract
    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.convert.torch_manet import load_manet
    from sdumc_tpu_torch.extract.visual import (extract_video_embeddings, load_face,
                                                sample_frame_paths)

    ckpt, face_dir, save_root = (os.path.join(tmp, n) for n in ("manet.pth", "faces", "visual"))
    write_manet_checkpoint(torch, ckpt)
    rng = np.random.default_rng(7)
    frames = {}
    t0 = time.perf_counter()
    for i in range(VISUAL_CLIPS):
        vid = f"clip_{i:02d}"
        os.makedirs(os.path.join(face_dir, vid))
        frames[vid] = int(rng.integers(VISUAL_FRAMES[0], VISUAL_FRAMES[1] + 1))
        for j in range(frames[vid]):
            write_bmp(os.path.join(face_dir, vid, f"frame_det_00_{j + 1:06d}.bmp"),
                      random_image(rng, FACE))
    print(f"seeded MANet (RAF-DB, 7 classes) .pth and {VISUAL_CLIPS} clips of "
          f"{sum(frames.values())} {FACE}x{FACE} 24-bit BMP frames written in "
          f"{time.perf_counter() - t0!r} s")
    argv = ["visual", "--checkpoint", ckpt, "--face_dir", face_dir, "--save_dir", save_root]
    reset_counts()
    out = extract.main(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    for vid, n in frames.items():
        feat = np.load(os.path.join(out["save_dir"], f"{vid}.npy"))
        if feat.shape != (n, 1024) or feat.dtype != np.float32 or not np.isfinite(feat).all():
            raise AssertionError(f"{vid}: {feat.shape} {feat.dtype} (want ({n}, 1024)) or non-finite")
    print(f"visual path (cli.extract visual, defaults: batch 32, FRAME): {out['videos']} clips, "
          f"{out['frames']} frames in {out['seconds']!r} s host clock (cold; reading and "
          f"resizing {out['decode_seconds']!r} s of it); launches of the port's kernels "
          f"{counts} (MANet runs cuDNN and PyTorch's own kernels only)")

    vid = min(frames, key=frames.get)      # its first batch of 32 frames, card against CPU
    faces = [load_face(p) for p in sample_frame_paths(os.path.join(face_dir, vid))[:32]]
    cpu_model, _ = load_manet(ckpt, "cpu")
    ref = extract_video_embeddings(cpu_model, faces)
    top = float(np.abs(ref).max())

    def check(x):
        err = float(np.abs(x - ref).max())
        return err, bool(np.allclose(x, ref, rtol=MODEL_RTOL, atol=MODEL_ATOL)
                         and err <= VISUAL_REL * top)

    err, ok = check(np.load(os.path.join(out["save_dir"], f"{vid}.npy"))[:len(faces)])
    print(f"{vid}'s first {len(faces)} frames: card vs CPU max abs diff {err!r}, max |embedding| "
          f"{top!r} (tolerance rtol={MODEL_RTOL} atol={MODEL_ATOL} and max abs diff <= "
          f"{VISUAL_REL} x max |embedding|: f32 reassociation through about 20 convolutions)")
    if not ok:
        raise AssertionError(f"{vid}: card and CPU embeddings disagree")
    card_model, _ = load_manet(ckpt, DEVICE)
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_err, tf32_ok = check(extract_video_embeddings(card_model, faces))
    finally:
        set_matmul_precision("highest")
    print(f"control, the same frames with torch.backends.cudnn.allow_tf32 = True: max abs diff "
          f"{tf32_err!r}, {tf32_err / top!r} of max |embedding| (must be refused)")
    if tf32_ok:
        raise AssertionError("the visual check does not see TF32 in the convolutions")

    out = extract.main(argv)
    print(f"warm second run: {out['frames']} frames in {out['seconds']!r} s host clock, "
          f"{out['frames'] / out['seconds']!r} frames/s; reading and resizing "
          f"{out['decode_seconds']!r} s ({out['decode_seconds'] / out['seconds']:.1%})")
    # the profiler's trace of all 12 clips takes longer to read than the run
    # itself: a warm run over the PROFILED_CLIPS shortest clips instead
    sub_dir = os.path.join(tmp, "faces_profiled")
    os.makedirs(sub_dir)
    for v in sorted(frames, key=frames.get)[:PROFILED_CLIPS]:
        os.symlink(os.path.join(face_dir, v), os.path.join(sub_dir, v))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sub = extract.main(["visual", "--checkpoint", ckpt, "--face_dir", sub_dir, "--save_dir",
                            os.path.join(tmp, "visual_profiled")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fams = print_device_time(prof, wall, f"profiled warm run of the {PROFILED_CLIPS} shortest "
                             f"clips ({sub['frames']} frames; reading and resizing "
                             f"{sub['decode_seconds']!r} s)", VISUAL_FAMILIES,
                             "the rest (CBAM gates, concatenations, means)", top=10)
    macs = manet_macs(torch, card_model)
    device = sum(fams.values())
    bound = 1e3 * 2 * macs * sub["frames"] / PEAK_F32_FLOPS
    print(f"  MANet: {macs} MACs per frame (every Conv2d and Linear, hooks); bound for "
          f"{sub['frames']} frames {bound!r} ms (f32 at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s, TF32 "
          f"off), device time {device!r} ms ({bound / device:.1%} of the bound), per frame "
          f"{device / sub['frames']!r} ms device")
    del cpu_model, card_model
    torch.cuda.empty_cache()


def manet_train_phase(torch, tmp: str):
    """Phase 16: ``cli.extract manet_train`` for one epoch at full width,
    batch 128, on a seeded ImageFolder of BMPs; one step card against CPU
    in float64; ms per step by CUDA events on a prepared batch."""
    import numpy as np

    from sdumc_tpu_torch.cli import extract
    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.extract.image_io import load_face
    from sdumc_tpu_torch.extract.manet_train import (image_folder, make_optimizer,
                                                     make_train_step, random_resized_crop_flip)
    from sdumc_tpu_torch.models.manet import MANet, MANetConfig, init_weights

    root = os.path.join(tmp, "rafdb")
    rng = np.random.default_rng(8)
    for split, per_class in (("train", TRAIN_PER_CLASS), ("test", TEST_PER_CLASS)):
        for c in range(MANET_CLASSES):
            os.makedirs(os.path.join(root, split, str(c + 1)))
            for i in range(per_class):
                write_bmp(os.path.join(root, split, str(c + 1), f"{split}_{c}_{i:04d}_aligned.bmp"),
                          random_image(rng, RAF))
    reset_counts()
    out = extract.main(["manet_train", "--data", root, "--epochs", "1", "--batch-size",
                        str(MANET_BATCH), "--checkpoint_path", os.path.join(tmp, "manet_ck")])
    torch.cuda.synchronize()
    counts = read_counts()
    steps = TRAIN_PER_CLASS * MANET_CLASSES // MANET_BATCH
    if out["steps"] != steps or len(out["losses"]) != steps or not all(
            map(math.isfinite, out["losses"])):
        raise AssertionError(f"manet_train: {out['steps']} steps, losses {out['losses']}")
    print(f"MANet trainer (cli.extract manet_train, 1 epoch, batch {MANET_BATCH}, full width): "
          f"losses {out['losses']}, test acc {out['accs']}, {out['seconds'] / steps!r} s per step "
          f"host clock (reading, cropping and resizing included); launches {counts}")

    paths, labels, _ = image_folder(os.path.join(root, "train"))
    rng = np.random.default_rng(0)
    order = rng.permutation(len(paths))[:MANET_BATCH]
    t0 = time.perf_counter()
    imgs = np.stack([random_resized_crop_flip(rng, load_face(paths[i])) for i in order])
    host = time.perf_counter() - t0
    x, y = torch.from_numpy(imgs), torch.from_numpy(labels[order])
    set_matmul_precision("highest")
    model = init_weights(MANet(MANetConfig(num_classes=MANET_CLASSES)), 0).to(DEVICE)
    opt, sched = make_optimizer(model, 0.01, steps)
    step = make_train_step(model, opt, sched)
    xd, yd = x.to(DEVICE), y.to(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: step(xd, yd), iters=TIMED_TRAIN_STEPS, warmup=2)
    macs = manet_macs(torch, model)
    bound = 1e3 * 3 * 2 * macs * MANET_BATCH / PEAK_F32_FLOPS
    print(f"  warm train step, batch {MANET_BATCH} on the card: {ms!r} ms (CUDA events, "
          f"{TIMED_TRAIN_STEPS} steps), {MANET_BATCH / ms * 1e3!r} images/s; bound {bound!r} ms "
          f"(3 x the forward's {macs} MACs per image in f32 at {PEAK_F32_FLOPS / 1e12:.0f} "
          f"TFLOP/s), {bound / ms:.1%} of it; the batch's crops took {host!r} s on the host; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30!r} GiB")
    del model, opt, step

    def run(dev):
        m = init_weights(MANet(MANetConfig(num_classes=MANET_CLASSES)), 0).double().to(dev)
        o, s = make_optimizer(m, 0.01, steps)
        met = make_train_step(m, o, s)(x[:PARITY_BATCH].double().to(dev), y[:PARITY_BATCH].to(dev))
        return met["loss"].item(), {k: p.grad.cpu() for k, p in m.named_parameters()}

    (loss_cpu, g_cpu), (loss_card, g_card) = run("cpu"), run(DEVICE)
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    worst, key = max(((g_card[k] - g).abs().max().item(), k) for k, g in g_cpu.items())
    print(f"  one step card vs CPU (float64, batch {PARITY_BATCH}): loss {loss_card!r} vs "
          f"{loss_cpu!r}; {len(g_cpu)} gradients, worst max abs diff {worst!r} at {key} = "
          f"{worst / gmax!r} of the largest gradient {gmax!r} (tolerance {MANET_GRAD_REL} of "
          f"it, loss rtol {MANET_LOSS_RTOL}: float64 reassociation)")
    if abs(loss_card - loss_cpu) > MANET_LOSS_RTOL * abs(loss_cpu) or worst > MANET_GRAD_REL * gmax:
        raise AssertionError("MANet train step: card and CPU disagree")
    torch.cuda.empty_cache()


# ------------------------------------------------ the production store (phases 17-18)

def bf16_kernel_phase(torch, fused_cross, fused_pool, lengths, f32_totals):
    """Phase 17: the bf16 instance vs its plain version at phase 2's shapes,
    timed beside phase 2's f32 instance."""
    totals = kernel_phase(torch, fused_cross, fused_pool, lengths, bf16=True)
    for q_count in REPLACES:
        f, h = f32_totals[q_count], totals[q_count]
        print(f"  per dual batch, Q={q_count}: f32 instance kernel_ms={f['ms']!r} "
              f"device_ms={f['device_ms']!r} bound_ms={f['bound_ms']!r}; bf16 instance "
              f"kernel_ms={h['ms']!r} device_ms={h['device_ms']!r} bound_ms={h['bound_ms']!r} "
              f"(bytes {h['bytes_ms']!r}, operations {h['operations_ms']!r}; the earlier "
              f"2-TF32-pass count {h['operations_tf32_ms']!r}) plain_ms="
              f"{h['plain_ms']!r} max_abs_err={h['max_abs_err']!r} ({h['max_ulps']!r} of its "
              f"bound) grad_max_abs_err={h['grad_max_abs_err']!r}; per repetition kernel_ms "
              f"{h['ms_reps']!r} device_ms {h['device_ms_reps']!r}; {h['blocks']} blocks with a "
              f"tile, W bytes {h['w_bytes']} = {h['w_bytes'] / h['frames']:.0f} per valid frame, "
              f"{h['w_bytes'] / h['tile_frames']:.0f} per tile frame")
    return totals


def dir_bytes(paths) -> int:
    return sum(os.path.getsize(p) for p in paths if os.path.exists(p))


def write_store_datasets(torch, root: str) -> dict:
    """Seeded MOSEI-like clips at the published widths (the synthetic
    store's clips, so phase 4's lengths: audio 50-1200 frames of 1024, text
    4-96 of 4096, video 8-300 of 1024, feat4 4-64 of 4096), STORE_SPLITS
    of them, as .npy directories; then ``cli.extract pack`` of each at each
    STORE_DTYPES into a dataset root of its own (features/CMU-MOSEI/{name}
    .bin / .json, labels/CMU-MOSEI.npz). Returns {dtype: root}."""
    import shutil

    import numpy as np

    from sdumc_tpu_torch.cli import extract
    from sdumc_tpu_torch.data.pipeline import build_sources

    cfg = main_path_config()
    sources = build_sources(cfg.data, cfg.paths, synthetic=True)
    names = [f"{split}_{i}" for split, n in STORE_SPLITS for i in range(n)]
    npy = os.path.join(root, "npy")
    t0 = time.perf_counter()
    for src in sources.values():
        os.makedirs(os.path.join(npy, src.name))
        for n in names:
            np.save(os.path.join(npy, src.name, n + ".npy"), src.get(n))
    del sources
    raw = dir_bytes(os.path.join(npy, d, f) for d in os.listdir(npy)
                    for f in os.listdir(os.path.join(npy, d)))
    print(f"store clips: {len(names)} clips x 4 streams, {raw!r} bytes of f32 .npy, "
          f"{time.perf_counter() - t0!r} s to generate and write")
    rng = np.random.default_rng(11)
    corpora = {f"{split}_corpus": {f"{split}_{i}": {"emo": 0.0,
                                                    "val": float(np.round(rng.uniform(-3, 3), 2))}
                                   for i in range(n)} for split, n in STORE_SPLITS}
    roots = {}
    for dtype in STORE_DTYPES:
        roots[dtype] = os.path.join(root, dtype)
        features = os.path.join(roots[dtype], "features", cfg.data.dataset)
        os.makedirs(features)
        os.makedirs(os.path.join(roots[dtype], "labels"))
        np.savez(os.path.join(roots[dtype], "labels", f"{cfg.data.dataset}.npz"), **corpora)
        t0 = time.perf_counter()
        for name in os.listdir(npy):
            if extract.main(["pack", "--src_dir", os.path.join(npy, name), "--out_prefix",
                             os.path.join(features, name), "--dtype", dtype]) != 0:
                raise AssertionError(f"cli.extract pack {name} --dtype {dtype} failed")
        seconds = time.perf_counter() - t0
        nbytes = dir_bytes(os.path.join(features, f) for f in os.listdir(features))
        print(f"cli.extract pack --dtype {dtype}: {nbytes!r} bytes ({nbytes / raw!r} of the "
              f".npy), {seconds!r} s for the 4 streams")
    shutil.rmtree(npy)
    return roots


def store_step(torch, cfg, store: str, feature_dtype: str):
    """A warm train step on the card on the first train batch of the store
    at ``cfg``'s paths: ms by CUDA events over TIMED_STEPS steps, peak
    memory, then PROFILED_STEPS steps under torch.profiler (device time by
    family, idle share)."""
    from torch.profiler import ProfilerActivity, profile

    from sdumc_tpu_torch.cli.common import bf16_full_precision_reduction, build_model
    from sdumc_tpu_torch.data.pipeline import get_loaders
    from sdumc_tpu_torch.train.step import batch_to_device_dict

    train_ds, _, _ = get_loaders(cfg.data.dataset, cfg.data, cfg.paths)
    batch = first_train_batch(cfg, train_ds)
    model = build_model(cfg, train_ds.input_dims(), torch.device("cuda"))
    step = make_step(torch, cfg, model)
    nbytes = sum(getattr(batch, k).nbytes for k in ("audio", "text", "video", "feat4"))
    with bf16_full_precision_reduction():
        d = batch_to_device_dict(batch, "cuda", feature_dtype)
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: step(d), iters=TIMED_STEPS, warmup=3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                step(d)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    streams = {k: str(v.dtype).replace("torch.", "") for k, v in d.items() if k in
               ("audio", "text", "video", "feat4")}
    title = (f"warm train step on the {store} store (streams {streams}, batch "
             f"{batch.size}, T = {batch.audio.shape[1]} / {max(batch.text.shape[1], batch.feat4.shape[1])}"
             f" / {batch.video.shape[1]}, {nbytes!r} feature bytes to the card): {ms!r} ms per step "
             f"over {TIMED_STEPS} steps (CUDA events), peak device memory {peak!r} GiB; profiled "
             f"({PROFILED_STEPS} steps)")
    print_device_time(prof, wall, title, TRAIN_FAMILIES,
                      "elementwise, casts, softmax and reductions", top=6)
    del model, step, d
    torch.cuda.empty_cache()
    return ms


def representations(torch, model, d) -> dict:
    """{key: both views' BF16_REP_KEYS outputs, f32 on the CPU} of a device
    batch (features already dequantised) through the fused dual view in eval
    mode, with cuBLAS's bf16 products reducing in f32 as the CLIs run them."""
    from sdumc_tpu_torch.cli.common import bf16_full_precision_reduction

    ta, tt, tv, tf4 = d["t_max"]
    model.eval()
    with torch.inference_mode(), bf16_full_precision_reduction():
        _, aux = model(d["audio"], (d["text"], d["feat4"]), d["video"],
                       t_max=(ta, (tt, tf4), tv), dual=True)
    return {k: aux[k].float().cpu() for k in BF16_REP_KEYS}


def store_phase(torch, fused_cross, work: str):
    """Phase 18: the production store end to end: pack at three dtypes;
    cli.train --feature_dtype bfloat16 for one epoch on the bf16 store, then
    on the int8 store, with the launch counters around each run (the bf16
    instance runs, the f32 instance does not); best_full.pt through
    cli.infer reproducing the logged MAE; the first eval batch's first rows
    card vs CPU; a warm train step on each store. Returns {store dtype:
    the bf16 instance's launches in its cli.train run}."""
    import dataclasses

    from sdumc_tpu_torch.cli import infer, train
    from sdumc_tpu_torch.cli.common import build_model
    from sdumc_tpu_torch.data.pipeline import BatchIterator, get_loaders
    from sdumc_tpu_torch.train.step import batch_to_device_dict, dequant_features, make_eval_step

    roots = write_store_datasets(torch, os.path.join(work, "store"))
    before = os.environ.get("SDUMC_DATA_DIR")
    launches = {}
    try:
        for dtype in ("bfloat16", "int8"):
            os.environ["SDUMC_DATA_DIR"] = roots[dtype]
            cfg = main_path_config(STORE_ARGV)
            bs = cfg.data.batch_size
            train_ds, val_ds, test_ds = get_loaders(cfg.data.dataset, cfg.data, cfg.paths)
            per_epoch = (len(train_ds) // bs + math.ceil(len(val_ds) / bs)
                         + math.ceil(len(test_ds) / bs))
            ck = os.path.join(work, f"ck_{dtype}")
            reset_counts()
            t0 = time.perf_counter()
            result = train.main(STORE_ARGV + ["--epochs", "1", "--checkpoint_dir", ck,
                                              "--save_root", ck])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = read_counts()
            for q_count in REPLACES:
                got, f32 = fused_cross.LAUNCHES_BF16[q_count], fused_cross.LAUNCHES[q_count]
                if got != 3 * per_epoch or f32:
                    raise AssertionError(
                        f"{dtype} store: {REPLACES_BF16[q_count][0]} launched {got} times "
                        f"(expected 3 x {per_epoch} batches), the f32 instance {f32}")
            launches[dtype] = dict(fused_cross.LAUNCHES_BF16)
            (h,) = result["history"]
            values = [h["train_loss"], h["train_mse_full"], h["train_mse_missing"],
                      h["eval_mse_full"], h["test"]["full"]["mae"], h["test"]["missing"]["mae"]]
            if not all(map(math.isfinite, values)):
                raise AssertionError(f"{dtype} store: non-finite training log {h}")
            print(f"cli.train --feature_dtype bfloat16 on the {dtype} store: one epoch of "
                  f"{len(train_ds) // bs} steps at batch {bs} (+ eval {len(val_ds)} and test "
                  f"{len(test_ds)} clips), {seconds!r} s host clock (model init and checkpoints "
                  f"included), train_loss={h['train_loss']!r} test_mae_full="
                  f"{h['test']['full']['mae']!r} {h['clips_per_sec']!r} clips/s; launches {counts}")

            best = os.path.join(ck, "best_full.pt")
            out = infer.main(STORE_ARGV + ["--checkpoint", best])
            mae, logged = out["full"]["mae"], result["best_full"]["mae"]
            print(f"  best_full.pt through cli.infer: test MAE {mae!r}, logged {logged!r} "
                  f"(tolerance rtol={CKPT_MAE_RTOL}: the same kernels on the same batches)")
            if abs(mae - logged) > CKPT_MAE_RTOL * abs(logged):
                raise AssertionError(f"{dtype} store: the best checkpoint does not reproduce its MAE")

            # the first eval batch's first rows (the batch's own t_max), card vs CPU
            batch = next(iter(BatchIterator(test_ds, bs, shuffle=False,
                                            buckets=cfg.data.length_buckets, prefetch=0)))
            n = STORE_CPU_ROWS
            rows = dataclasses.replace(
                batch, **{k: getattr(batch, k)[:n] for k in ("audio", "text", "video", "feat4",
                                                            "emos", "vals")},
                lengths=batch.lengths[:, :n], names=batch.names[:n],
                scales={k: v[:n] for k, v in batch.scales.items()} if batch.scales else None)
            cpu = build_model(cfg, train_ds.input_dims(), torch.device("cpu"), best)
            d_cpu = batch_to_device_dict(rows, "cpu", "bfloat16")
            v0, v1 = make_eval_step(cpu)(d_cpu)
            for view, ref, key in (("full", v0, "val_preds_full"),
                                   ("missing", v1, "val_preds_missing")):
                got = torch.from_numpy(out["results"][key][:n])
                err = (got - ref).abs().max().item()
                limit = BF16_REL * ref.abs().max().item()
                print(f"  first eval batch, {n} rows, {view} view: cli.infer's predictions vs "
                      f"CPU max abs diff {err!r}, {err / limit!r} of the tolerance {BF16_REL} x "
                      f"max |pred| = {limit!r} (bf16 streams on both, summed in another order)")
                if err > limit:
                    raise AssertionError(f"{dtype} store, {view} view: card and CPU disagree")
            # the text representations of the same rows, card vs CPU, and a
            # control with the card's streams in f32 (the features widened
            # exactly after the dequantisation), which the check must refuse
            card = build_model(cfg, train_ds.input_dims(), torch.device("cuda"), best)
            d_card = dequant_features(batch_to_device_dict(rows, "cuda", "bfloat16"))
            d_wide = {k: v.float() if k in ("audio", "text", "video", "feat4") else v
                      for k, v in d_card.items()}
            ref = representations(torch, cpu, dequant_features(d_cpu))
            errs = {}
            for label, d in (("bf16 streams", d_card), ("f32-stream control", d_wide)):
                got = representations(torch, card, d)
                errs[label] = {k: ((got[k] - ref[k]).norm() / ref[k].norm()).item()
                               for k in BF16_REP_KEYS}
            del card, d_card, d_wide
            print(f"  the same rows' text representations (both views), card vs CPU, relative "
                  f"L2 error (tolerance {BF16_REP_L2}): {errs}")
            if max(errs["bf16 streams"].values()) > BF16_REP_L2:
                raise AssertionError(f"{dtype} store: card and CPU representations disagree")
            if min(errs["f32-stream control"].values()) <= BF16_REP_L2:
                raise AssertionError(f"{dtype} store: the f32-stream control passes the bf16 "
                                     f"check, which so cannot tell them apart")

        for dtype in STORE_DTYPES:
            os.environ["SDUMC_DATA_DIR"] = roots[dtype]
            store_step(torch, main_path_config(STORE_ARGV), dtype,
                       "float32" if dtype == "float32" else "bfloat16")
    finally:
        if before is None:
            os.environ.pop("SDUMC_DATA_DIR", None)
        else:
            os.environ["SDUMC_DATA_DIR"] = before
    return launches


# ------------------------------------- the WavLM kernel's bf16 instance and ASR (phases 19-22)

def flash_bf16_bound_ms(B, T, n_valid):
    """Least time for one call of the bf16 instance, as {"bytes",
    "operations"} in ms: bf16 q, k, v, the gate and the bias diagonal read
    once, f32 kvalid, the bf16 output written once, over the HBM rate; QK^T
    and PV (4 hd flops per query and valid key) on bf16 operands over the
    card's dense bf16 tensor-core rate."""
    H, hd = FLASH_H, FLASH_HD
    nbytes = 2 * (4 * B * T * H * hd + B * H * T + H * (2 * T - 1)) + 4 * B * T
    flops = 4 * H * hd * T * int(sum(n_valid))
    return {"bytes": 1e3 * nbytes / PEAK_HBM_BYTES, "operations": 1e3 * flops / PEAK_BF16_FLOPS}


def flash_bf16_control(torch, flash_wavlm, q, k, v, gate, diag, kvalid, variant):
    """The bf16 plain version with one step wrong, a control for the
    mismatch share: "f32 p" (p not rounded) or "f32 row sum" (the row sum of
    the unrounded p); p against the running max of the kernel's key tiles."""
    B, T, H, hd = q.shape
    bf, tile = torch.bfloat16, bf16_key_tile(flash_wavlm)
    qs = (q * torch.tensor(hd ** -0.5, dtype=bf)).float()
    s = torch.einsum("bthd,bshd->bhts", qs, k.float())
    s = s + gate.float()[..., None] * flash_wavlm.dense_bias(diag.float(), T)[None]
    s = s.masked_fill(~(kvalid[:, None, None, :] > 0), flash_wavlm.NEG_BF16)
    n = -(-T // tile)
    tiles = torch.nn.functional.pad(s, (0, n * tile - T), value=-float("inf"))
    del s
    tiles = tiles.view(B, H, T, n, tile)
    m = tiles.amax(-1).cummax(-1).values
    p32 = torch.exp(tiles - m[..., None])
    del tiles
    carry = torch.exp(m - m[..., -1:])
    l = (p32.sum(-1) * carry).sum(-1)
    pw = p32 if variant == "f32 p" else p32.to(bf).float()
    w = (pw * carry[..., None]).view(B, H, T, n * tile)[..., :T]
    out = torch.einsum("bhts,bshd->bthd", w, v.float())
    return (out / l.transpose(1, 2)[..., None]).to(bf)


def bf16_key_tile(flash_wavlm) -> int:
    """The bf16 instance's key tile (128; 64, the f32 instance's, in a
    checkout without KEY_TILE_BF16, which --ab may time)."""
    return getattr(flash_wavlm, "KEY_TILE_BF16", flash_wavlm.KEY_TILE)


def bf16_ulps(torch, err, ref):
    """The largest of err in bf16 ulps (8 significant bits) of the largest
    |ref|: near an output's zero its own ulp is far below the error that p's
    rounding brings (2^-7 of the spread of v), so the output's scale is the
    unit."""
    top = ref.float().abs().max()
    return (err.max() / torch.ldexp(torch.ones_like(top), torch.frexp(top).exponent - 8)).item()


def flash_bf16_phase(torch, flash_wavlm, f32_totals):
    """Phase 19: the WavLM kernel's bf16 instance against its bf16 plain
    version at phase 3's shapes and masks (and a row of 4 keys), to
    flash_wavlm.bf16_tolerance element by element and to
    flash_wavlm.BF16_MISMATCH_LIMIT in the share of elements that differ,
    which three controls must exceed (p unrounded, the row sum of the
    unrounded p, p rounded against the final max); timed beside phase 3's
    f32 instance, the bound and one bf16 SDPA call with a materialised
    mask."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(19)
    dev = torch.device("cuda")
    kw = dict(num_buckets=320, max_distance=800)
    limit = flash_wavlm.BF16_MISMATCH_LIMIT
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
           "operations_ms": 0.0, "max_abs_err": 0.0,
           "max_ulps": 0.0, "max_of_bound": 0.0, "max_share": 0.0, "device_ms": 0.0,
           "ms_reps": [0.0] * TIMING_REPS, "device_ms_reps": [0.0] * TIMING_REPS,
           "calls": {}, "controls": {}}
    print(f"flash_wavlm_bf16 vs its bf16 plain version (H={FLASH_H}, hd={FLASH_HD}; p "
          f"rounded to bf16 against the running max of {bf16_key_tile(flash_wavlm)}-key tiles "
          "in both; tolerance "
          "flash_wavlm.bf16_tolerance: 2^-7 max_u |v_u - out| + 1 bf16 ulp + 1e-5 max |v|, "
          f"and at most {limit} of the elements differing, a share the controls must exceed)")
    for B, T in FLASH_SHAPES:
        rows = max(B, 4)
        q, k, v = (torch.randn(rows, T, FLASH_H, FLASH_HD, generator=gen).to(dev).bfloat16()
                   for _ in range(3))
        gate = (1 + torch.rand(rows, FLASH_H, T, generator=gen)).to(dev).bfloat16()
        rel = torch.randn(320, FLASH_H, generator=gen).to(dev).bfloat16()
        lengths = torch.randint(1, T + 1, (rows,), generator=gen)
        lengths[:4] = torch.tensor([T, T - 37, 1, 4])
        kvalid = (torch.arange(T)[None, :] < lengths[:, None]).float().to(dev)
        with torch.inference_mode():
            diag = flash_wavlm.bias_diag_for(rel, T, **kw)
            got = flash_wavlm.flash_gated_attention(q, k, v, gate, None, kvalid, diag, **kw)
            ref = flash_wavlm.flash_gated_attention_plain(q, k, v, gate, None, kvalid, diag, **kw)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs()
            of_bound = (diff / flash_wavlm.bf16_tolerance(ref, v)).max().item()
            err, ulps = diff.max().item(), bf16_ulps(torch, diff, ref)
            share = flash_wavlm.bf16_mismatch_share(got, ref)
            controls = {variant: flash_wavlm.bf16_mismatch_share(flash_bf16_control(
                torch, flash_wavlm, q, k, v, gate, diag, kvalid, variant), ref)
                for variant in ("f32 p", "f32 row sum")}
            controls["final max"] = flash_wavlm.bf16_mismatch_share(
                flash_wavlm.flash_gated_attention_plain(q, k, v, gate, None, kvalid, diag,
                                                        key_tile=T, **kw), ref)
            del diff, ref
            print(f"  flash_wavlm_bf16 B={rows} T={T}: max_abs_err={err!r} ({ulps!r} bf16 ulps "
                  f"of the largest output, {of_bound!r} of the bound), elements differing "
                  f"{share!r} (limit {limit}); controls against the plain version {controls!r}")
            if got.dtype != torch.bfloat16 or not of_bound <= 1.0 or not share <= limit:
                raise AssertionError(f"flash_wavlm_bf16 at B={rows} T={T}: max abs err {err!r}, "
                                     f"{of_bound!r} of its bound, {share!r} of the elements "
                                     "differ")
            if not all(c > limit for c in controls.values()):
                raise AssertionError(f"a control passes the mismatch limit {limit}: {controls}")
            args = [t[:B].contiguous() for t in (q, k, v, gate)]
            mask_b = kvalid[:B].contiguous()

            def kern():
                return flash_wavlm.flash_gated_attention(*args, None, mask_b, diag, **kw)

            ms, dev_ms, ms_spread, dev_spread, ms_reps, dev_reps = repeated_ms(
                    lambda: time_ms(kern),
                lambda: device_ms(torch, kern, ("flash_wavlm", "flash_bf16")), TIMING_REPS)
            plain_ms = time_ms(lambda: flash_wavlm.flash_gated_attention_plain(
                *args, None, mask_b, diag, **kw))
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in args[:3])
            attn_mask = (args[3].float()[..., None] * flash_wavlm.dense_bias(diag.float(), T)[None]
                         + torch.where(mask_b > 0, 0.0, flash_wavlm.NEG)[:, None, None, :]
                         ).bfloat16()
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=attn_mask))
        bnd = flash_bf16_bound_ms(B, T, lengths[:B].tolist())
        least = max(bnd["bytes"], bnd["operations"])
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", least), ("bytes_ms", bnd["bytes"]),
                         ("operations_ms", bnd["operations"]), ("device_ms", dev_ms)):
            tot[key] += val
        tot["ms_reps"] = [a + c for a, c in zip(tot["ms_reps"], ms_reps)]
        tot["device_ms_reps"] = [a + c for a, c in zip(tot["device_ms_reps"], dev_reps)]
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["max_ulps"] = max(tot["max_ulps"], ulps)
        tot["max_of_bound"] = max(tot["max_of_bound"], of_bound)
        tot["max_share"] = max(tot["max_share"], share)
        tot["controls"][f"T={T}"] = controls
        tot["calls"][f"B={B} T={T}"] = ms
        print(f"  flash_wavlm_bf16 B={B} T={T} kernel_ms={ms!r} device_ms={dev_ms!r} "
              f"plain_ms={plain_ms!r} sdpa_bf16_ms={lib_ms!r} bound_ms={least!r} (bytes "
              f"{bnd['bytes']!r}, operations at the bf16 rate {bnd['operations']!r}); over "
              f"{TIMING_REPS} repetitions kernel_ms {ms_reps!r} (spread {ms_spread:.1%}), "
              f"device_ms {dev_reps!r} (spread {dev_spread:.1%})")
    print(f"  both shapes: f32 instance (phase 3) kernel_ms={f32_totals['ms']!r} device_ms="
          f"{f32_totals['device_ms']!r} bound_ms={f32_totals['bound_ms']!r}; bf16 instance "
          f"kernel_ms={tot['ms']!r} device_ms={tot['device_ms']!r} bound_ms={tot['bound_ms']!r} "
          f"({tot['device_ms'] and tot['bound_ms'] / tot['device_ms']:.1%} of its device time) "
          f"plain_ms={tot['plain_ms']!r} sdpa_bf16_ms={tot['library_ms']!r}; per repetition "
          f"kernel_ms {tot['ms_reps']!r} device_ms {tot['device_ms_reps']!r}")
    return tot


def flash_grad_phase(torch, flash_wavlm):
    """Phase 20: FlashGatedAttention (the kernel forward, the chunked
    backward) on the card against autograd through the plain version, at
    B=8 T=249 and B=1 T=2999, f32, with mixed key masks: dq, dk, dv, dgate
    and d rel_embed; the backward's ms (CUDA events) and peak memory of
    forward + backward, each beside the plain version's."""
    gen = torch.Generator().manual_seed(20)
    dev = torch.device("cuda")
    kw = dict(num_buckets=320, max_distance=800)
    print(f"flash gradient vs plain autograd (f32, tolerance rtol={FLASH_GRAD_RTOL} "
          f"atol={FLASH_GRAD_ATOL}: JAX's test's, another summation order)")
    for B, T in FLASH_SHAPES:
        base = [torch.randn(B, T, FLASH_H, FLASH_HD, generator=gen) for _ in range(3)]
        base += [1 + torch.rand(B, FLASH_H, T, generator=gen), torch.randn(320, FLASH_H, generator=gen)]
        base = [t.to(dev) for t in base]
        lengths = torch.randint(1, T + 1, (B,), generator=gen)
        lengths[0] = T
        kvalid = (torch.arange(T)[None, :] < lengths[:, None]).float().to(dev)
        dout = torch.randn(B, T, FLASH_H, FLASH_HD, generator=gen).to(dev)
        result = {}
        for name, fn in (("flash", flash_wavlm.flash_gated_attention),
                         ("plain", flash_wavlm.flash_gated_attention_plain)):
            leaves = [t.clone().requires_grad_() for t in base]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            out = fn(*leaves, kvalid, **kw)
            grads = torch.autograd.grad(out, leaves, dout, retain_graph=True)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - before) / 2**20
            ms = time_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True),
                         iters=5, warmup=1)
            result[name] = (grads, peak, ms)
            del out
        errs = []
        for gname, g, r in zip(("dq", "dk", "dv", "dgate", "drel"), result["flash"][0],
                               result["plain"][0]):
            errs.append(f"{gname} {(g - r).abs().max().item()!r} of max {r.abs().max().item()!r}")
            if not torch.allclose(g, r, rtol=FLASH_GRAD_RTOL, atol=FLASH_GRAD_ATOL):
                raise AssertionError(f"flash gradient {gname} at B={B} T={T}: "
                                     f"{(g - r).abs().max().item()!r}")
        print(f"  B={B} T={T}: {'; '.join(errs)}; backward_ms={result['flash'][2]!r} "
              f"(plain autograd {result['plain'][2]!r}), peak MiB forward + backward "
              f"{result['flash'][1]!r} (plain {result['plain'][1]!r})")
        del result
        torch.cuda.empty_cache()


def bf16_layer_holds(torch, cpu_model, cfg, wav, cpu_tap):
    """Each bf16 WavLM attention module on the card (the projections, the
    gate, the kernel's bf16 instance, out_proj) against the same module on
    the CPU (the bf16 plain path), both fed the card's input to it: the
    relative L2 error of the module's output over the clip's frames, largest
    over the 24 layers, for the sound card path and for two controls run on
    the card, the f32 instance on the widened inputs (p not rounded) and the
    einsum path (scores rounded to bf16, JAX's einsum semantics). Returns
    {name: (largest error, its layer, the relative L2 error of the card's
    tap -5 against ``cpu_tap``, the CPU's bf16 features)}."""
    import copy

    import numpy as np

    from sdumc_tpu_torch.cli.common import bf16_full_precision_reduction
    from sdumc_tpu_torch.extract.audio import BUCKETS, zero_mean_unit_var
    from sdumc_tpu_torch.models import wavlm as wavlm_mod
    from sdumc_tpu_torch.ops.kernels import flash_wavlm

    cpu_model.to(dtype=torch.bfloat16)
    card_model = copy.deepcopy(cpu_model).to("cuda")
    bucket = next(b for b in BUCKETS if len(wav) <= b)
    batch = np.zeros((1, bucket), np.float32)
    batch[0, : len(wav)] = zero_mean_unit_var(wav)
    frames = cfg.output_length(len(wav))
    mask = torch.zeros(1, cfg.output_length(bucket), dtype=torch.bool)
    mask[0, :frames] = True
    wav_t = torch.from_numpy(batch).bfloat16()

    def f32_attention(q, k, v, gate, rel_embed, kvalid, bias_diag, **kw):
        return flash_wavlm.launch(q.float(), k.float(), v.float(), gate.float(),
                                  bias_diag.float(), kvalid).to(q.dtype)

    runs = {"sound": {}, "control: the f32 instance on widened inputs": {
                "flash_gated_attention": f32_attention},
            "control: the einsum path (bf16 scores)": {
                "resolve_attention_impl": lambda *a: "einsum"}}
    holds = {}
    with torch.inference_mode(), bf16_full_precision_reduction():
        for name, patches in runs.items():
            saved = {attr: getattr(wavlm_mod, attr) for attr in patches}
            seen = []
            hooks = [layer.attention.register_forward_hook(
                lambda mod, args, out: seen.append((args[0].cpu(), out[0].cpu())))
                for layer in card_model.encoder.layers]
            try:
                for attr, fn in patches.items():
                    setattr(wavlm_mod, attr, fn)
                taps = card_model(wav_t.to("cuda"), pad_mask=mask.to("cuda"),
                                  output_hidden_states=True)["hidden_states"]
            finally:
                for attr, fn in saved.items():
                    setattr(wavlm_mod, attr, fn)
                for hook in hooks:
                    hook.remove()
            errs, bias = [], None
            for layer, (x, h_card) in zip(cpu_model.encoder.layers, seen):
                h, bias = layer.attention(x, bias, mask)
                want = h[0, :frames].float()
                errs.append(((h_card[0, :frames].float() - want).norm() / want.norm()).item())
            tap = taps[-5][0, :frames].float().cpu().numpy()
            at = int(np.argmax(errs))
            holds[name] = (errs[at], at, float(np.linalg.norm(tap - cpu_tap)
                                               / np.linalg.norm(cpu_tap)))
    del card_model
    return holds


def bf16_extraction_phase(torch, tmp: str, f32_dir: str, f32_rate: float):
    """Phase 21: ``cli.extract audio --dtype bfloat16`` on phase 5's wavs and
    seeded wavlm-large, with the launch counters around it (the bf16
    instance 24 times per batch, the f32 instance never); every clip against
    phase 5's f32 features (JAX's cosine rule); on the shortest, each
    attention module card against CPU (``bf16_layer_holds``); its rate beside
    phase 5's; a profiled warm run. Returns the launch counts."""
    import numpy as np

    from sdumc_tpu_torch.cli import extract
    from sdumc_tpu_torch.convert.hf_wavlm import load_hf_wavlm
    from sdumc_tpu_torch.extract.audio import extract_audio_features, plan_batches, read_wav

    model_dir, audio_dir = os.path.join(tmp, "model"), os.path.join(tmp, "wavs")
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(audio_dir))
    wavs = {n: read_wav(os.path.join(audio_dir, n + ".wav")) for n in names}
    cfg, cpu_model = load_hf_wavlm(model_dir)
    n_batches = len(plan_batches(cfg, [len(wavs[n]) for n in names], 8))
    reset_counts()
    out = extract.main(["audio", "--model_dir", model_dir, "--audio_dir", audio_dir,
                        "--save_dir", os.path.join(tmp, "out_bf16"), "--dtype", "bfloat16"])
    torch.cuda.synchronize()
    counts = read_counts()
    if (counts[FLASH_BF16["name"]] != cfg.num_layers * n_batches or counts[FLASH["name"]]
            or out["batches"] != n_batches):
        raise AssertionError(f"bf16 extraction: launches {counts} in {out['batches']} batches, "
                             f"expected {cfg.num_layers} x {n_batches} of the bf16 instance")
    cos_min = 1.0
    for name in names:
        got = np.load(os.path.join(out["save_dir"], f"{name}.npy"))
        ref = np.load(os.path.join(f32_dir, f"{name}.npy"))
        if got.shape != ref.shape or got.dtype != np.float32 or not np.isfinite(got).all():
            raise AssertionError(f"{name}: {got.shape} {got.dtype} (want {ref.shape}) or non-finite")
        cos = np.sum(got * ref, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
        cos_min = min(cos_min, float(cos.min()))
    if not cos_min > BF16_COS_MIN:
        raise AssertionError(f"bf16 vs f32 features: min cosine {cos_min!r}")
    short = min(names, key=lambda n: len(wavs[n]))
    ref = extract_audio_features(cpu_model, cfg, [wavs[short]], device="cpu", dtype="bfloat16")[0]
    got = np.load(os.path.join(out["save_dir"], f"{short}.npy"))
    f32 = np.load(os.path.join(f32_dir, f"{short}.npy"))
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    rel_card, rel_cpu = (float(np.linalg.norm(a - f32) / np.linalg.norm(f32)) for a in (got, ref))
    print(f"bf16 extraction path (cli.extract audio --dtype bfloat16): {out['clips']} clips in "
          f"{out['batches']} batches, {out['seconds']!r} s host clock, "
          f"{out['audio_seconds'] / out['seconds']!r} audio s per s (f32, phase 5: {f32_rate!r}); "
          f"launches {counts}; min per-frame cosine against the f32 features {cos_min!r} "
          f"(rule > {BF16_COS_MIN}); {short} at tap -5, card vs CPU bf16 relative L2 error "
          f"{rel!r}, each against f32: card {rel_card!r}, CPU {rel_cpu!r} (not a check: through "
          "20 layers two sound bf16 runs part as far as each lies from f32)")
    holds = bf16_layer_holds(torch, cpu_model, cfg, wavs[short], ref)
    print(f"  {short}, every attention module fed the card's input, card vs CPU (the CPU's "
          f"bf16 plain path), relative L2 error of its output (limit {BF16_LAYER_L2}):")
    for name, (worst, at, tap) in holds.items():
        print(f"    {name}: largest {worst!r} at layer {at}; its tap -5 against the CPU's "
              f"bf16 features {tap!r}")
    if not holds["sound"][0] <= BF16_LAYER_L2:
        raise AssertionError(f"{short}: a bf16 attention module on the card parts from the CPU's by "
                             f"{holds['sound'][0]!r}")
    if not all(h[0] > BF16_LAYER_L2 for name, h in holds.items() if name != "sound"):
        raise AssertionError(f"a control passes the bf16 attention check: {holds}")
    del cpu_model
    profile_extraction(torch, model_dir, audio_dir, dtype="bfloat16")
    torch.cuda.empty_cache()
    return counts


def write_whisper_dir(torch, path: str, seed: int = 22):
    """A seeded whisper-base.en in HF's format: config.json and
    generation_config.json (WHISPER_BASE_EN, WHISPER_RULES), model.safetensors
    (WhisperForConditionalGeneration's keys, ``model.`` prefixed, proj_out
    tied and left out, as HF saves it; normal(0, 0.02) weights as HF's init
    draws them, biases 0, norms 1 / 0, the encoder's sinusoidal table),
    written by the port's own writer, and a hand-written byte-level
    tokenizer.json over all 51864 ids."""
    from sdumc_tpu_torch.convert import safetensors_io
    from sdumc_tpu_torch.convert.hf_whisper import config_from_hf
    from sdumc_tpu_torch.models.whisper import WhisperModel, sinusoids

    config = {"model_type": "whisper", "architectures": ["WhisperForConditionalGeneration"],
              **WHISPER_BASE_EN, **WHISPER_RULES}
    cfg = config_from_hf(config)
    with torch.device("meta"):
        shapes = {k: t.shape for k, t in WhisperModel(cfg).state_dict().items()}
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape in shapes.items():
        if key == "encoder.embed_positions.weight":
            val = sinusoids(*shape)
        elif "layer_norm" in key:
            val = torch.ones(shape) if key.endswith("weight") else torch.zeros(shape)
        elif key.endswith(".bias"):
            val = torch.zeros(shape)
        else:
            val = 0.02 * torch.randn(shape, generator=gen)
        sd["model." + key] = val
    os.makedirs(path, exist_ok=True)
    safetensors_io.save_file(sd, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"decoder_start_token_id": WHISPER_BASE_EN["decoder_start_token_id"],
                   "eos_token_id": WHISPER_BASE_EN["eos_token_id"], **WHISPER_RULES}, f, indent=1)
    write_whisper_tokenizer(path, cfg.vocab_size)
    return cfg


def write_whisper_tokenizer(path: str, n_ids: int) -> None:
    """tokenizer.json in Whisper's English layout: the BPE vocabulary at ids
    0-50255 (the 256 byte pieces of byte-level BPE, then two-byte pieces),
    then the added tokens: <|endoftext|> 50256, <|startoftranscript|> 50257,
    99 language tokens, <|translate|>, <|transcribe|>, <|startoflm|>,
    <|startofprev|>, <|nocaptions|>, <|notimestamps|> 50362 (specials) and the
    1501 timestamps <|0.00|> .. <|30.00|> (not special)."""
    from sdumc_tpu_torch.convert.whisper_tokenizer import bytes_to_unicode

    b2u = bytes_to_unicode()
    pieces = [b2u[b] for b in range(256)]
    pieces += [b2u[a] + b2u[b] for a in range(256) for b in range(256)][: 50256 - 256]
    vocab = {p: i for i, p in enumerate(pieces)}
    specials = (["<|endoftext|>", "<|startoftranscript|>"]
                + [f"<|{chr(97 + i // 26)}{chr(97 + i % 26)}|>" for i in range(99)]
                + ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
                   "<|nocaptions|>", "<|notimestamps|>"])
    stamps = ["<|%.2f|>" % (i * 0.02) for i in range(1501)]
    added = [{"id": len(vocab) + i, "content": c, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": c in specials}
             for i, c in enumerate(specials + stamps)]
    if len(vocab) + len(added) != n_ids or added[-1 - 1501]["content"] != "<|notimestamps|>":
        raise AssertionError("the tokenizer does not cover the vocabulary")
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": None,
            "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                              "trim_offsets": True, "use_regex": True},
            "post_processor": None,
            "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                        "use_regex": True},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": []}}
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)


def whisper_decode_bound_ms(cfg, batch: int) -> float:
    """Least time of one decode step at `batch`: the decoder's f32 weights
    read once per step (every layer's self-attention, cross q / out and
    FFN, the tied embedding for the logits) and every layer's cross K / V of
    the batch (1500 frames each), over the HBM rate."""
    d, f = cfg.d_model, cfg.ffn_dim
    per_layer = 4 * d * d + 3 * d + 2 * d * d + 2 * d + 2 * d * f + d + f + 6 * d
    weights = cfg.decoder_layers * per_layer + cfg.vocab_size * d
    cross = cfg.decoder_layers * 2 * batch * cfg.max_source_positions * d
    return 1e3 * 4 * (weights + cross) / PEAK_HBM_BYTES


def asr_phase(torch, tmp: str, llm_dir: str):
    """Phase 22: ``cli.extract asr`` with its defaults (and once with
    --vad) on phase 5's wavs and a seeded whisper-base.en: one csv row per
    clip, the 60-s clip split over the window and re-joined; one batch's
    tokens card against CPU and the smallest top-1 / top-2 logit gap; ms per
    decode step (CUDA events) beside its bound, device time by family and
    the idle share; the launch counters (no kernel of the port runs); then
    the csv through ``cli.extract text`` on phase 11's 2-layer Vicuna."""
    import csv

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from sdumc_tpu_torch.cli import extract
    from sdumc_tpu_torch.convert.hf_whisper import load_hf_whisper
    from sdumc_tpu_torch.convert.whisper_tokenizer import WhisperTokenizer
    from sdumc_tpu_torch.extract.asr import WINDOW, plan_items, transcribe
    from sdumc_tpu_torch.extract.audio import read_wav
    from sdumc_tpu_torch.models.whisper import greedy_transcribe, init_self_caches
    from sdumc_tpu_torch.ops.mel import log_mel_spectrogram

    model_dir, audio_dir = os.path.join(tmp, "whisper"), os.path.join(tmp, "wavs")
    t0 = time.perf_counter()
    cfg = write_whisper_dir(torch, model_dir)
    print(f"seeded whisper-base.en written in {time.perf_counter() - t0!r} s")
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(audio_dir))
    wavs = [read_wav(os.path.join(audio_dir, n + ".wav")) for n in names]
    items = plan_items(names, wavs)
    runs = {}
    for label, flags in (("defaults", []), ("--vad", ["--vad"])):
        csv_path = os.path.join(tmp, f"transcription{'_vad' if flags else ''}.csv")
        reset_counts()
        out = extract.main(["asr", "--model_dir", model_dir, "--audio_dir", audio_dir,
                            "--save_csv", csv_path, *flags])
        torch.cuda.synchronize()
        counts = read_counts()
        with open(csv_path, newline="", encoding="utf-8") as f:
            table = list(csv.reader(f))
        if (table[0] != ["name", "english"] or [r[0] for r in table[1:]] != names
                or any(counts.values())):
            raise AssertionError(f"asr {label}: header {table[0]}, {len(table) - 1} rows for "
                                 f"{len(names)} clips, launches {counts}")
        runs[label] = (out, dict((r[0], r[1]) for r in table[1:]), csv_path)
        print(f"asr path (cli.extract asr {label}): {out['clips']} clips, {out['pieces']} pieces "
              f"of <= 30 s in {out['batches']} batches of {ASR_BATCH}, {out['seconds']!r} s host "
              f"clock (weights on the card, wav reading included), "
              f"{out['audio_seconds'] / out['seconds']!r} audio s per s; launches of the port's "
              f"kernels {counts} (the ASR stage runs cuBLAS, cuFFT and PyTorch's own kernels)")
    out, texts, csv_path = runs["defaults"]
    if out["pieces"] != len(items):
        raise AssertionError(f"asr: {out['pieces']} pieces, planned {len(items)}")
    cfg_gpu, model, meta = load_hf_whisper(model_dir, "cuda")
    tok = WhisperTokenizer.from_dir(model_dir)
    long_name = max(names, key=lambda n: len(wavs[names.index(n)]))
    long_items = [it for it in items if it[0] == long_name]
    alone = transcribe(model, tok, meta, [(f"{n}#{j}", 0, w) for n, j, w in long_items],
                       batch=ASR_BATCH)
    joined = " ".join(t for t in (alone[f"{long_name}#{j}"] for _, j, _ in long_items) if t)
    if len(long_items) < 2 or texts[long_name] != joined.strip():
        raise AssertionError(f"{long_name}: {len(long_items)} pieces; the csv's text is not "
                             "its pieces' texts re-joined")
    print(f"{long_name} ({len(wavs[names.index(long_name)]) / 16000!r} s): {len(long_items)} "
          f"pieces of <= {WINDOW / 16000} s, transcribed alone and re-joined: the csv's text")

    # one batch of pieces, card against CPU: equal tokens
    kw = dict(start_id=meta["decoder_start_token_id"], eos_id=meta["eos_token_id"],
              forced_ids=[tuple(x) for x in meta["forced_decoder_ids"]],
              suppress_ids=meta["suppress_tokens"],
              begin_suppress_ids=meta["begin_suppress_tokens"])
    audio = np.zeros((ASR_BATCH, WINDOW), np.float32)
    for j, (_, _, w) in enumerate(items[:ASR_BATCH]):
        audio[j, : len(w)] = w
    _, cpu_model, _ = load_hf_whisper(model_dir, "cpu")
    toks = {}
    with torch.inference_mode():
        for dev, m in (("cpu", cpu_model), ("cuda", model)):
            mel = log_mel_spectrogram(torch.from_numpy(audio).to(dev), n_mels=cfg.num_mel_bins)
            toks[dev] = greedy_transcribe(m, mel, **kw)
        mel = log_mel_spectrogram(torch.from_numpy(audio).cuda(), n_mels=cfg.num_mel_bins)
        xkvs = model.decoder.cross_kv(model.encoder(mel))
        tokens, n_tok = toks["cuda"]["tokens"], toks["cuda"]["n_tokens"]
        seq = torch.cat([torch.full_like(tokens[:, :1], kw["start_id"]), tokens[:, :-1]], 1)
        logits = model.decoder(seq, xkvs)                           # teacher-forced [B, 200, V]
    if not torch.equal(toks["cpu"]["tokens"], tokens.cpu()):
        raise AssertionError("asr: card and CPU tokens differ on the first batch")
    sup = torch.zeros(cfg.vocab_size, dtype=torch.bool, device="cuda")
    sup[kw["suppress_ids"]] = True
    gaps = []
    for step in range(tokens.shape[1]):
        if step < 1:                                                # the forced <|notimestamps|>
            continue
        ban = sup.clone()
        if step == 1:
            ban[kw["begin_suppress_ids"]] = True
        live = n_tok >= step                                        # rows still decoding
        if live.any():
            top2 = logits[:, step].masked_fill(ban, -math.inf)[live].topk(2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).min().item())
    del cpu_model
    print(f"first batch ({ASR_BATCH} pieces, {int(n_tok.sum())} tokens, up to "
          f"{int(n_tok.max())} a piece): card tokens equal the CPU's (f32, TF32 off); the "
          f"smallest top-1 / top-2 logit gap over its live steps {min(gaps)!r}")

    # ms per decode step at batch ASR_BATCH, the cross K / V of the batch in place
    state = {"step": 0}

    def decode_step():
        s = state["step"]
        logits = model.decoder(state["last"], xkvs, start=s, caches=state["caches"])[:, -1]
        state["last"] = logits.argmax(dim=-1, keepdim=True)
        state["step"] = s + 1

    with torch.inference_mode():
        state["caches"] = init_self_caches(cfg, ASR_BATCH, ASR_TIMED_STEPS + 9, "cuda")
        state["last"] = torch.full((ASR_BATCH, 1), kw["start_id"], device="cuda")
        ms = time_ms(decode_step, iters=ASR_TIMED_STEPS, warmup=3)
        state["step"] = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(16):
                decode_step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    bound = whisper_decode_bound_ms(cfg, ASR_BATCH)
    print(f"whisper-base.en decode step, batch {ASR_BATCH} (f32, TF32 off): {ms!r} ms by CUDA "
          f"events over {ASR_TIMED_STEPS} steps, bound {bound!r} ms (decoder weights and the "
          f"batch's cross K/V at 3.35 TB/s; {bound / ms:.1%} of it)")
    print_device_time(prof, wall, "profiled decode (16 steps)", ASR_FAMILIES,
                      "elementwise, norms and the rest")

    # the ASR text variant: the csv through the text stage
    save_dir = os.path.join(tmp, "asr_text")
    reset_counts()
    t_out = extract.main(["text", "--model_dir", llm_dir, "--trans_path", csv_path,
                          "--save_dir", save_dir])
    torch.cuda.synchronize()
    for name in names:
        feat = np.load(os.path.join(save_dir, f"{name}.npy"))
        if feat.ndim != 2 or feat.shape[1] != VICUNA["hidden_size"] or not np.isfinite(feat).all():
            raise AssertionError(f"asr text {name}: {feat.shape} or non-finite")
    print(f"ASR text variant: cli.extract text on the transcription csv, {t_out['rows']} rows, "
          f"{t_out['seconds']!r} s host clock, launches {read_counts()}")
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- the vision stage (phase 23)

def vision_config_files() -> dict:
    """Each family's config.json as published (openai/clip-vit-large-patch14: a
    whole CLIPModel whose vision_config leaves image_size 224, quick_gelu and
    1e-5 to HF's defaults; facebook/dinov2-base; MCG-NJU/videomae-base, a
    VideoMAEForPreTraining checkpoint without mean pooling; timm's
    eva02_base_patch14_224.mim_in22k, whose config names no widths)."""
    return {
        "clip": {"architectures": ["CLIPModel"], "model_type": "clip", "projection_dim": 768,
                 "logit_scale_init_value": 2.6592,
                 "text_config": {"hidden_size": 768, "intermediate_size": 3072,
                                 "num_attention_heads": 12, "num_hidden_layers": 12,
                                 "projection_dim": 768},
                 "vision_config": {"hidden_size": 1024, "intermediate_size": 4096,
                                   "num_attention_heads": 16, "num_hidden_layers": 24,
                                   "patch_size": 14, "projection_dim": 768}},
        "dinov2": {"architectures": ["Dinov2Model"], "model_type": "dinov2", "hidden_act": "gelu",
                   "hidden_size": 768, "image_size": 518, "layer_norm_eps": 1e-6,
                   "layerscale_value": 1.0, "mlp_ratio": 4, "num_attention_heads": 12,
                   "num_channels": 3, "num_hidden_layers": 12, "patch_size": 14, "qkv_bias": True,
                   "use_swiglu_ffn": False},
        "videomae": {"architectures": ["VideoMAEForPreTraining"], "model_type": "videomae",
                     "decoder_hidden_size": 384, "decoder_intermediate_size": 1536,
                     "decoder_num_attention_heads": 6, "decoder_num_hidden_layers": 4,
                     "hidden_act": "gelu", "hidden_size": 768, "image_size": 224,
                     "intermediate_size": 3072, "layer_norm_eps": 1e-12, "norm_pix_loss": True,
                     "num_attention_heads": 12, "num_channels": 3, "num_frames": 16,
                     "num_hidden_layers": 12, "patch_size": 16, "qkv_bias": True,
                     "tubelet_size": 2, "use_mean_pooling": False},
        "eva02": {"architecture": "eva02_base_patch14_224", "num_classes": 0,
                  "pretrained_cfg": {"tag": "mim_in22k", "input_size": [3, 224, 224],
                                     "interpolation": "bicubic"}},
    }


def seeded_vision_state_dict(torch, model, seed: int) -> dict:
    """``model``'s state dict (on the CPU) with every parameter drawn
    normal(0, 0.02) on the card (HF's init range), LayerNorm weights and
    DINOv2's LayerScale about 1."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    model = model.to(DEVICE)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.normal_(0.0, 0.02, generator=gen)
            if name.endswith("lambda1"):
                p.add_(1.0)
        for m in model.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.add_(1.0)
    return {k: v.cpu() for k, v in model.state_dict().items()}


def write_vision_models(torch, root: str) -> dict:
    """Seeded weights of each family at its published config, in the format
    its loader reads, with the tensors a published file carries beside the
    encoder (CLIP's text tower, VideoMAE's pretraining decoder, DINOv2's
    mask token, ResNet's fc head), which the loaders must skip. Returns
    {family: the flags that name them}."""
    from sdumc_tpu_torch.convert.hf_clip import config_from_hf as clip_config
    from sdumc_tpu_torch.convert.hf_dinov2 import config_from_hf as dinov2_config
    from sdumc_tpu_torch.convert.hf_videomae import config_from_hf as videomae_config
    from sdumc_tpu_torch.convert.safetensors_io import save_file
    from sdumc_tpu_torch.models.clip_vit import CLIPVisionTower
    from sdumc_tpu_torch.models.dinov2 import Dinov2Model
    from sdumc_tpu_torch.models.eva02 import Eva02Config, Eva02Model
    from sdumc_tpu_torch.models.manet import init_weights
    from sdumc_tpu_torch.models.resnet import ResNetEmbedding
    from sdumc_tpu_torch.models.videomae import VideoMAEModel

    configs, flags = vision_config_files(), {}
    r = torch.Generator().manual_seed(23)
    extra = {
        "clip": {"text_model.final_layer_norm.weight": torch.ones(768),
                 "text_model.final_layer_norm.bias": torch.zeros(768),
                 "text_projection.weight": torch.randn(768, 768, generator=r) * 0.02,
                 "logit_scale": torch.tensor(2.6592)},
        "dinov2": {"embeddings.mask_token": torch.zeros(1, 768)},
        "videomae": {"encoder_to_decoder.weight": torch.randn(384, 768, generator=r) * 0.02,
                     "mask_token": torch.zeros(1, 1, 384),
                     "decoder.norm.weight": torch.ones(384), "decoder.norm.bias": torch.zeros(384),
                     "decoder.head.weight": torch.randn(1536, 384, generator=r) * 0.02,
                     "decoder.head.bias": torch.zeros(1536)},
    }
    models = {"clip": CLIPVisionTower(clip_config(configs["clip"])),
              "dinov2": Dinov2Model(dinov2_config(configs["dinov2"])),
              "videomae": VideoMAEModel(videomae_config(configs["videomae"])),
              "eva02": Eva02Model(Eva02Config())}
    for seed, (family, model) in enumerate(models.items()):
        sd = seeded_vision_state_dict(torch, model, 30 + seed)
        if family == "videomae":
            sd = {"videomae." + k: v for k, v in sd.items()}
        if family == "eva02":          # a MIM export's final norm, which the loader takes as fc_norm
            sd["norm.weight"], sd["norm.bias"] = sd.pop("fc_norm.weight"), sd.pop("fc_norm.bias")
        path = os.path.join(root, family)
        os.makedirs(path)
        save_file({**sd, **extra.get(family, {})}, os.path.join(path, "model.safetensors"))
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(configs[family], f, indent=2)
        flags[family] = ["--model_dir", path]
    models.clear()
    resnet = init_weights(ResNetEmbedding(), 34)    # ResNet's init, BN drawn as for phase 15
    gen = torch.Generator().manual_seed(35)
    with torch.no_grad():
        for m in resnet.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    sd = dict(resnet.state_dict())
    sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, 512, generator=r) * 0.02, torch.zeros(1000)
    torch.save(sd, os.path.join(root, "resnet18.pth"))      # torchvision's: a bare state dict
    flags["imagenet"] = ["--checkpoint", os.path.join(root, "resnet18.pth")]
    return flags


def vision_macs(torch, model, family: str, cfg) -> int:
    """Multiply-accumulates of one sample (a frame; VideoMAE a window)
    through every Linear and convolution (forward hooks) plus the attention
    products, 2 T^2 D a layer (q.k^T and p.v over all heads)."""
    macs = []

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Linear):
            k = mod.in_features
        else:
            k = mod.in_channels // mod.groups * math.prod(mod.kernel_size)
        macs.append(out.numel() * k)

    kinds = (torch.nn.Linear, torch.nn.Conv2d, torch.nn.Conv3d)
    hooks = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, kinds)]
    dev = next(model.parameters()).device
    size = 224 if cfg is None else cfg.image_size
    x = (torch.zeros(1, cfg.num_frames, 3, size, size, device=dev) if family == "videomae"
         else torch.zeros(1, 3, size, size, device=dev))
    with torch.inference_mode():
        out = model(x)
    for h in hooks:
        h.remove()
    attention = 0
    if isinstance(out, dict):
        _, T, D = out["last_hidden_state"].shape
        attention = 2 * T * T * D * cfg.num_layers
    return sum(macs) + attention


VISION_OP_FAMILIES = (
    ("GEMMs (Linear)", ("aten::addmm", "aten::mm")),
    ("attention einsums (q.k^T, p.v)", ("aten::bmm", "aten::baddbmm")),
    ("convolutions", ("aten::cudnn_convolution", "aten::_convolution", "aten::convolution")),
    ("softmax", ("aten::_softmax",)),
    ("memory copies", ("aten::copy_", "aten::_to_copy")),
)


def print_op_families(prof, wall: float, title: str, card: str) -> dict:
    """Device time by the operator that launched each kernel (so an
    attention product tells itself from a Linear's though both are cuBLAS
    GEMMs), and the device's idle share of the host-clock window `wall`."""
    from torch.autograd import DeviceType

    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    families = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU or e.self_device_time_total <= 0:
            continue
        family = next((f for f, ops in VISION_OP_FAMILIES if e.key in ops),
                      "elementwise, norms and the rest")
        families[family] = families.get(family, 0.0) + e.self_device_time_total / 1e3
    if busy <= 0:
        raise AssertionError(f"{title}: the profiler saw no device time")
    print(f"  {title}: {wall!r} s host clock, device busy {busy / 1e3!r} s, idle share "
          f"{1 - busy / 1e3 / wall!r} ({card}); device time by family:")
    for family, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:10.3f} ms {ms / busy:7.2%}  {family}")
    return {"busy_ms": busy, **families}


def vision_phase(torch, tmp: str, card: str):
    """Phase 23: ``cli.extract vision`` for each family (its defaults:
    FRAME, every 5th frame, batch 32) on phase 15's BMP crops, with seeded
    weights at the published configs; shapes and finiteness; the launch
    counters (no kernel of the port runs); one batch card against CPU per
    family on the same host-resized pixels, and a TF32 control that the
    CLIP check must refuse; a warm run (frames/s, decode-and-resize apart,
    peak memory), a profiled warm run of the shortest clips (device time
    by family, idle share) and the f32 bound."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from sdumc_tpu_torch.cli import extract
    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.extract import vision_hf

    face_dir = os.path.join(tmp, "faces")
    frames = {v: len(os.listdir(os.path.join(face_dir, v))) for v in sorted(os.listdir(face_dir))}
    t0 = time.perf_counter()
    flags = write_vision_models(torch, os.path.join(tmp, "vision_models"))
    print(f"seeded clip-vit-large-patch14 (whole CLIPModel config, text tensors beside), "
          f"dinov2-base, videomae-base (pretraining layout), eva02_base_patch14_224 (timm) and "
          f"resnet18 (torchvision .pth) written in {time.perf_counter() - t0!r} s; "
          f"{len(frames)} clips of {sum(frames.values())} crops from phase 15")
    shortest = sorted(frames, key=frames.get)
    sub_dir = os.path.join(tmp, "faces_vision_profiled")
    os.makedirs(sub_dir)
    for v in shortest[:VISION_PROFILED_CLIPS]:
        os.symlink(os.path.join(face_dir, v), os.path.join(sub_dir, v))
    reset_counts()
    for family in VISION_FAMILIES:
        base = ["vision", "--model", family, *flags[family], "--face_dir", face_dir]
        out = extract.main(base + ["--save_dir", os.path.join(tmp, "vision", family)])
        torch.cuda.reset_peak_memory_stats()        # the warm run's peak: its model alone
        warm = extract.main(base + ["--save_dir", os.path.join(tmp, "vision", family + "_warm")])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30

        def encoder(dev):
            named = flags[family][1]
            return vision_hf.build_encoder(family, None if family == "imagenet" else named,
                                           named if family == "imagenet" else None,
                                           torch.device(dev))

        def rows(n):        # a clip's saved rows: every 5th frame, VideoMAE's windows of them
            r = -(-n // 5)
            return max(-(-r // cfg.num_frames), 1) if family == "videomae" else r

        model, cfg, key, size, mean, std, dim = encoder(DEVICE)
        for vid, n in frames.items():
            feat = np.load(os.path.join(out["save_dir"], f"{vid}.npy"))
            if feat.shape != (rows(n), dim) or feat.dtype != np.float32 \
                    or not np.isfinite(feat).all():
                raise AssertionError(f"vision {family} {vid}: {feat.shape} {feat.dtype} "
                                     f"(want ({rows(n)}, {dim})) or non-finite")
        # card against CPU on the same host-resized pixels: 4 frames (VideoMAE one window)
        vid = max(frames, key=frames.get)
        clip_dir = os.path.join(face_dir, vid)
        paths = vision_hf.resample_frames([os.path.join(clip_dir, f)
                                           for f in sorted(os.listdir(clip_dir))])
        n_px = cfg.num_frames if family == "videomae" else VISION_CHECK_FRAMES
        px = [vision_hf.load_normalized(p, size, mean, std) for p in paths[:n_px]]
        cpu_model = encoder("cpu")[0]

        def embed_px(m, dev):
            return vision_hf.make_embed(family, m, cfg, key, torch.device(dev), 32)(px)

        ref = embed_px(cpu_model, "cpu")
        top = float(np.abs(ref).max())

        def check(x):
            err = float(np.abs(x - ref).max())
            return err, err <= VISION_REL * top

        err, ok = check(embed_px(model, DEVICE))
        print(f"vision {family}: {len(px)} frames of {vid}, card vs CPU max abs diff {err!r}, "
              f"{err / top!r} of max |embedding| {top!r} (limit {VISION_REL}: f32 reassociation "
              f"through the encoder) ({card})")
        if not ok:
            raise AssertionError(f"vision {family}: card and CPU embeddings disagree")
        if family == "clip":
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32_err, tf32_ok = check(embed_px(model, DEVICE))
            finally:
                set_matmul_precision("highest")
            print(f"  control, the same frames with torch.backends.cuda.matmul.allow_tf32 = "
                  f"True: max abs diff {tf32_err!r}, {tf32_err / top!r} of max |embedding| "
                  f"(must be refused)")
            if tf32_ok:
                raise AssertionError("the vision check does not see TF32 in the products")
            utt = extract.main(base + ["--feature_level", "UTTERANCE", "--save_dir",
                                       os.path.join(tmp, "vision", "clip_utt")])
            for v in frames:
                u = np.load(os.path.join(utt["save_dir"], f"{v}.npy"))
                f = np.load(os.path.join(out["save_dir"], f"{v}.npy"))
                if u.shape != (dim,) or not np.allclose(u, f.mean(axis=0), rtol=1e-5, atol=1e-6):
                    raise AssertionError(f"vision clip UTTERANCE {v}: {u.shape}, not the frames' mean")
        del cpu_model
        # the stage's loop on the encoder already on the card (a run of the CLI would
        # put the upload of its weights into the window)
        embed = vision_hf.make_embed(family, model, cfg, key, torch.device(DEVICE), 32)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sub = vision_hf.extract_dir(embed, sub_dir, os.path.join(tmp, "vision", family + "_prof"),
                                        image_size=size, mean=mean, std=std, dim=dim)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        samples = sum(rows(frames[v]) for v in shortest[:VISION_PROFILED_CLIPS])
        print(f"vision {family} ({card}): cold run {out['frames']} frames in {out['seconds']!r} s; "
              f"warm run {warm['frames']} frames in {warm['seconds']!r} s host clock, "
              f"{warm['frames'] / warm['seconds']!r} frames/s, reading and resizing "
              f"{warm['decode_seconds']!r} s of it; peak memory {peak!r} GiB")
        fams = print_op_families(prof, wall, f"profiled warm run of the {VISION_PROFILED_CLIPS} "
                                 f"shortest clips ({sub['frames']} frames, {samples} samples; "
                                 f"reading and resizing {sub['decode_seconds']!r} s)", card)
        macs = vision_macs(torch, model, family, cfg)
        bound = 1e3 * 2 * macs * samples / PEAK_F32_FLOPS
        print(f"  {family}: {macs} MACs per {'window' if family == 'videomae' else 'frame'}; f32 "
              f"bound for {samples} {bound!r} ms ({PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s, TF32 off), "
              f"device time {fams['busy_ms']!r} ms ({bound / fams['busy_ms']:.1%} of the bound) "
              f"({card})")
        del model
        torch.cuda.empty_cache()
    counts = read_counts()
    print(f"launches of the port's kernels over phase 23's runs: {counts}")
    if any(counts.values()):
        raise AssertionError(f"the vision path launched a kernel of the port: {counts}")


def kernels_only(torch, root: str, lengths: dict) -> dict:
    """Phases 2-3, 17 and 19 (without the gradient checks) with the kernels
    of the checkout at `root`, built from its own sources into its own
    build/kernels/, each held to that checkout's own plain versions;
    per-kernel totals."""
    sys.path.insert(0, os.path.abspath(root))
    from sdumc_tpu_torch.ops.kernels import build, flash_wavlm, fused_cross, fused_pool

    build.build()
    totals = kernel_phase(torch, fused_cross, fused_pool, lengths, grads=False)
    flash = flash_phase(torch, flash_wavlm)
    bf16 = kernel_phase(torch, fused_cross, fused_pool, lengths, grads=False, bf16=True)
    return {REPLACES[7][0]: totals[7], REPLACES[1][0]: totals[1], FLASH["name"]: flash,
            REPLACES_BF16[7][0]: bf16[7], REPLACES_BF16[1][0]: bf16[1],
            FLASH_BF16["name"]: flash_bf16_phase(torch, flash_wavlm, flash)}


def ab_phase(other: str) -> None:
    """Phases 2-3, 17 and 19 for OTHER's kernels and this checkout's, each in
    its own process, in the order OTHER, this, this, OTHER, on one card; the
    inputs and the timing are this script's in every run."""
    here = os.path.dirname(os.path.abspath(__file__))
    lengths = json.dumps(main_path_lengths(main_path_config()), default=int)
    runs = []
    for label, root in (("other", other), ("this", here), ("this", here), ("other", other)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--kernels-from", root,
                               "--lengths", lengths], capture_output=True, text=True, timeout=1200)
        print(f"=== {label}: {os.path.abspath(root)} (exit {proc.returncode})")
        print(proc.stdout.rstrip())
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the kernel phases failed for {root}")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
    for name in (REPLACES[7][0], REPLACES[1][0], FLASH["name"], REPLACES_BF16[7][0],
                 REPLACES_BF16[1][0], FLASH_BF16["name"]):
        for key in ("ms", "device_ms"):
            print(f"{name:12s} {key:9s} " + "  ".join(
                f"{label}={res[name][key]!r}" for label, res in runs))
        for call in runs[0][1][name]["calls"]:
            print(f"{name:12s} {call:12s} " + "  ".join(
                f"{label}={res[name]['calls'][call]!r}" for label, res in runs))
    print(json.dumps({"ab": [{"run": label, **res} for label, res in runs]}))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ab", metavar="OTHER",
                        help="time phases 2-3, 17 and 19 against OTHER's kernels")
    parser.add_argument("--kernels-from", help=argparse.SUPPRESS)
    parser.add_argument("--lengths", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.kernels_from:
        lengths = {m: tuple(v) for m, v in json.loads(args.lengths).items()}
        print(json.dumps(kernels_only(torch, args.kernels_from, lengths)))
        return 0
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.ab:
        print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        ab_phase(args.ab)
        print(card_line())
        return 0
    from sdumc_tpu_torch.ops.kernels import build, flash_wavlm, fused_cross, fused_pool

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    report = build.build()
    print(f"kernel build: {time.perf_counter() - t0!r} s for {sorted(report) or 'cached'}")
    for name, rep in report.items():
        print(f"--- nvcc {name} ---\n{rep['log'].strip()}")

    def phase(n: int, fn, *a):
        t = time.perf_counter()
        result = fn(*a)
        print(f"phase {n} ({fn.__name__}): {time.perf_counter() - t!r} s")
        return result

    lengths = main_path_lengths(main_path_config())
    totals = phase(2, kernel_phase, torch, fused_cross, fused_pool, lengths)
    flash = phase(3, flash_phase, torch, flash_wavlm)
    infer_launches = phase(4, main_path_phase, torch, fused_cross)
    with tempfile.TemporaryDirectory() as work:
        extract_counts, feats_dir, f32_rate = phase(5, extraction_phase, torch, flash_wavlm,
                                                     work)
        launches = phase(7, training_phase, torch, fused_cross)
        phase(8, step_parity_phase, torch)
        phase(9, step_timing_phase, torch)
        phase(10, llama_parity_phase, torch)
        llm_dir, proj_path = phase(11, feat4_cli_phase, torch, work, feats_dir)
        phase(12, full_depth_phase, torch, llm_dir, proj_path, feats_dir)
        rows = phase(13, text_cli_phase, torch, work, llm_dir)
        phase(14, text_full_depth_phase, torch, llm_dir, rows)
        phase(15, visual_phase, torch, work)
        phase(16, manet_train_phase, torch, work)
        bf16_totals = phase(17, bf16_kernel_phase, torch, fused_cross, fused_pool, lengths, totals)
        store_launches = phase(18, store_phase, torch, fused_cross, work)
        flash_bf16 = phase(19, flash_bf16_phase, torch, flash_wavlm, flash)
        phase(20, flash_grad_phase, torch, flash_wavlm)
        bf16_counts = phase(21, bf16_extraction_phase, torch, work, feats_dir, f32_rate)
        phase(22, asr_phase, torch, work, llm_dir)
        phase(23, vision_phase, torch, work, card)

    kernels = []
    for q_count, (name, replaces) in REPLACES.items():
        tot = totals[q_count]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[q_count], "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["operations_ms"] >= tot["bytes_ms"]
                         else "bytes"),
            "library_ms": None,
        })
    kernels.append({
        **FLASH, "route": "cuda", "launches": extract_counts[FLASH["name"]],
        "max_abs_err": flash["max_abs_err"], "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": "operations" if flash["operations_ms"] >= flash["bytes_ms"] else "bytes",
        "library_ms": flash["library_ms"],
    })
    for q_count, (name, replaces) in REPLACES_BF16.items():
        tot = bf16_totals[q_count]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": store_launches["bfloat16"][q_count], "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["operations_ms"] >= tot["bytes_ms"]
                         else "bytes"),
            "library_ms": None,
        })
    kernels.append({
        **FLASH_BF16, "route": "cuda", "launches": bf16_counts[FLASH_BF16["name"]],
        "max_abs_err": flash_bf16["max_abs_err"], "ms": flash_bf16["ms"],
        "plain_ms": flash_bf16["plain_ms"], "bound_ms": flash_bf16["bound_ms"],
        "bound_by": ("operations" if flash_bf16["operations_ms"] >= flash_bf16["bytes_ms"]
                     else "bytes"),
        "library_ms": flash_bf16["library_ms"],
    })
    print("fused_cross / fused_pool times are per dual batch: the sum of the "
          "audio, text and video calls above; library_ms is null: no single "
          "PyTorch call computes tanh(x W^T + b) keys, the masked softmax and "
          "the weighted sum (SDPA takes keys already projected). flash_wavlm "
          "times are the sum of one call at each of its two shapes above; its "
          "library_ms is scaled_dot_product_attention with a materialised f32 "
          "mask gate * bias + keymask, built outside the timed region. "
          "Launches are counted on each kernel's own path: cli.train for "
          "fused_cross / fused_pool (cli.infer: "
          f"{ {REPLACES[q][0]: n for q, n in infer_launches.items()} }), cli.extract audio "
          "for flash_wavlm, cli.train --feature_dtype bfloat16 on the bf16 store for the "
          "bf16 instances (the int8 store's run: "
          f"{ {REPLACES_BF16[q][0]: n for q, n in store_launches['int8'].items()} }), "
          "cli.extract audio --dtype bfloat16 for flash_wavlm_bf16 (its library_ms: bf16 SDPA "
          "with a materialised bf16 mask); max_abs_err is "
          "the forward's against the plain version")
    for name, tot in ((REPLACES[7][0], totals[7]), (REPLACES[1][0], totals[1]),
                      (FLASH["name"], flash), (REPLACES_BF16[7][0], bf16_totals[7]),
                      (REPLACES_BF16[1][0], bf16_totals[1]), (FLASH_BF16["name"], flash_bf16)):
        print(f"{name}: kernel_ms={tot['ms']!r} device_ms={tot['device_ms']!r} "
              f"grad_max_abs_err={tot.get('grad_max_abs_err')!r} "
              f"bound_ms={tot['bound_ms']!r} ({tot['ms'] and tot['bound_ms'] / tot['ms']:.1%} "
              f"of it) f32_bound_ms={tot.get('f32_bound_ms')!r}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
