#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sdumc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, as below
    python3 chip_smoke.py --ab OTHER      # phases 2-3, 9, 17 and 19 only, for
                                          # this checkout and OTHER (the root of
                                          # another checkout), in turns
    python3 chip_smoke.py --tp-cli N      # phase 29 (a) alone at --tp N (on N
                                          # cards: NCCL), from its own inputs
    python3 chip_smoke.py --pp-only       # phase 30 alone, from its own inputs

Phases, each fatal on failure (non-zero exit, no result line):
  1. environment: the card's name and power limit, then the kernel build
     from the sources in this checkout (all sources compile in parallel,
     the data plane's C++ with g++ beside the kernels' nvcc; its seconds
     printed);
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
     gradient check must refuse (it shows the check can see TF32); then,
     with the live dropouts, the remat step (``make_train_step(remat=True)``,
     the dual-view loss under torch.utils.checkpoint) against the default
     step from the same weights on the same batch: the loss and every
     gradient to the same tolerance (equal to the bit expected);
  9. a warm train step on the card, timed with CUDA events over 10 steps,
     then device time by family (fusion kernel, GEMMs, optimizer, copies,
     the rest) of 3 steps under torch.profiler, with the idle share; its
     roofline (``utils.roofline``: flops and bytes counted on one untimed
     step, the fusion op by its formula; ``Roofline.report`` at the timed ms
     against the H100's peaks, the custom ops' share of the flops); the
     remat step timed the same way, with its peak memory beside the
     default step's;
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
 12. Vicuna-7B at 4 of its 32 layers (bf16, seeded on the card) through
     Feat4Extractor.extract_many on 9 of the same features (8 short clips
     and the 60 s one; cut from 17 to hold the script's time): host-clock
     rate and peak memory, one of its own chunks' ms per decode step (CUDA
     events around its steps as it ran) beside its
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
 14. the text stage at 4 of Vicuna-7B's 32 layers (bf16, seeded on the card)
     through extract_text_features with --layer_ids -3 and -4..-1:
     sentences/s by the host clock, peak memory, ms per batch by CUDA events
     beside its bound, device time by family and the idle share;
 15. the visual path: ``cli.extract visual`` with its defaults (batch 32,
     FRAME) on a seeded MANet .pth in the reference's format and 12 clips of
     30-300 OpenFace-style 112x112 24-bit BMP frames: shapes and
     finiteness, one clip's first batch card against CPU and a control run
     with cuDNN's TF32 allowed that the check must refuse; the 12 clips
     run once, warm (after a cold run of the 3 shortest; frames/s,
     decode-and-resize time apart), a warm run of the 3 shortest clips
     under torch.profiler (device time by family, idle share) and the f32
     bound from the MACs of every conv;
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
     seconds); the data plane: one epoch of the train split through
     BatchIterator as cli.train reads it (page-locked), the C++ fill
     (data/native.py) against the plain numpy fill in lockstep over the
     .npy directories and each store, every batch held equal (FILL_RTOL /
     FILL_ATOL for pooled f32 rows) and each fill's seconds and GB/s
     printed; the ring (reuse_buffers) on the bf16 store, each batch copied
     by batch_to_device_dict behind torch.cuda._sleep, every batch on the
     card equal to the plain fill's, with a control that skips the wait
     before a refill and must show another batch's bytes;
     ``cli.train --feature_dtype bfloat16`` for one epoch on the
     bf16 store, then on the int8 store (dequantised on the card), with the
     launch counters around each run (the bf16 instance launches, the f32
     one does not) and the C++ fills counted (4 a batch; cli.infer's too),
     finite losses, best_full.pt through cli.infer
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
     family the 12 clips run once, warm (after a cold run of the 2
     shortest; frames/s, reading and resizing apart, peak memory), a
     profiled warm run of the 2 shortest clips (device time by
     the operator that launched it, idle share) and the f32 bound from
     the forward's MACs;
 24. the baseline zoo: each of the JAX package's ten baseline families
     (tfn, lmf, attention, misa, mmim, mfn, graph_mfn, mfm, mctn, mult) at
     ModelConfig's widths through ``cli.train --synthetic --model NAME``
     (one epoch at the inference path's width and batch) and its
     best_full.pt through ``cli.infer --model NAME``, every logged loss
     finite, the MAE reproduced and the launch counters at 0 for every
     kernel of the port (no kernel lies on these models); tfn once more
     with --feature_dtype bfloat16; one train step card vs CPU (dropout
     off) for tfn, mfn, mctn and mult (the GEMM, LSTM, GRU and attention
     paths) with a TF32 control that each check must refuse; per family a
     warm step timed by CUDA events, its peak memory, and one profiled
     step (device time by the operator that launched it, idle share,
     launches);
 25. the other text families: for each of bert-base-uncased (vocab.txt),
     roberta-large and deberta-large (v1; vocab.json + merges.txt),
     albert-base-v2 (tokenizer.json: Unigram, a small precompiled charsmap),
     bloom-7b1 (tokenizer.json) and chatglm2-6b (tokenizer.model, THUDM's
     fused layout in pytorch_model.bin) at its published config, seeded on
     the card and written in its on-disk format (the encoders at full depth,
     the two decoders at 2 layers, the large ones in bf16):
     ``cli.extract text --family F`` with its defaults on phase 13's
     transcripts, every output's shape (the probe's span stripped), dtype
     and finiteness, the launch counters at 0, then one batch card vs CPU
     at f32 with TF32 off; then bloom-7b1 and chatglm2-6b at
     DECODER_LAYERS (4) of their 30 and 28 layers, f32, seeded on the card,
     through extract_text_features: sentences/s, one 16-row batch by CUDA events
     beside its bound (max of the f32 flops of the real tokens and the f32
     weight bytes), peak memory, device time by family;
 26. serving export: ``python -m sdumc_tpu_torch.cli.export`` with its
     defaults (input widths 1024/4096/1024/4096, batch 128, combos
     64x64x64x64, 256x64x256x64, 512x64x512x64) on phase 7's best_full.pt,
     the bundle's bytes, every program checked for 0 weights, 0 constants
     and 6 sdumc::fused_cross nodes; then a fresh process that imports only
     sdumc_tpu_torch.serve loads the bundle and serves a partial batch (100
     rows) in each combo and a second request in one combo at other lengths,
     3 + 3 f32 launches each, and refuses lengths that fit no combo; every
     answer held to make_eval_step on the same padded batch and checkpoint
     on the card; a warm request per combo by host clock (numpy to numpy),
     its padding and copy alone and the program alone (CUDA events) beside
     the eager step, peak memory, one profiled request;
 27. decode serving: ``python -m sdumc_tpu_torch.cli.export --decode`` on
     phase 11's 2-layer Vicuna (bf16, prompt buckets 64, 128 and 256,
     --gen_batch 4, 200 new tokens; a prefill, a step and a finalize
     program a bucket): export time and bytes; a fresh process that imports
     only sdumc_tpu_torch.serve serves a chunk in each bucket (the launch
     counters around each at 0: the decode runs no kernel of the port) and
     refuses a prompt that fits no bucket; every chunk held to the engine's
     functions run eagerly on the served arithmetic (served_path_eager: the
     step index a 0-d tensor, the generated cache read whole and masked;
     tokens and step counts equal, taps to phase 11's bf16 tolerance); the
     eager beam_generate_batched's sliced decode of the same padded prompts
     printed beside it, not held: at bf16 the two pick other beams where
     the logits tie exactly (eager's near-tie gap printed); ms per step
     served and eager; 32-step int8, w8a8 and int8-KV bundles built
     in-process, each held to served_path_eager on its model; an f32 bundle
     held to the eager beam_generate_batched at phase 10's tolerance; then
     Vicuna-7B at 4 of 32 layers (phase 12's seed): bucket 256 built in-process
     (nothing saved), held to served_path_eager, the sliced decode printed
     beside it, ms per step of served, served_path_eager and eager beside
     the bound, and a profiled window of served steps (device time by
     family, idle share, launches);
 28. data-parallel training: two ranks on the card over gloo (NCCL takes
     one rank a device), each started as ``chip_smoke.py --dp-worker``
     with the SDUMC_* environment beside phase 24's runs, which time
     nothing (phase 24 waits for this work too); there: (b) ``cli.train
     --multihost --synthetic --epochs 1`` and the same with ``--model
     mfm``, rank 0's best_full.pt of each (rank 0 alone writes) through
     cli.infer; then from the seeded weights with dropout off, on the
     first train batch (16 rows a rank): (a) the 2-rank step against the
     single-process step (32 rows) on the card, and the control, each
     rank's own loss with the gradients averaged; (c) the same for the
     four baseline families whose model_loss couples the batch's rows
     (misa, mmim, mfm, mctn) with live batch-wide draws (``mfm_mmd_w`` 1,
     ``mctn_teacher_forcing`` 0.5), their control each rank's own
     model_loss averaged (mctn: each rank's own teacher mask). Phase 28
     itself, nothing else on the card: the warm DP steps and the fusion
     net's gradient all_reduce timed (CUDA events) beside phases 9 and
     24's single-process steps; then held: (a) the loss to STEP_LOSS_RTOL
     and every gradient to phase 8's ratio, which the control must
     exceed; (b) identical metrics on both ranks, within JAX's 0.05 of
     phase 7's first epoch, each rank's fusion launches 3 a batch and Q,
     rank 0's best_full.pt reproducing its MAE; (c) per family as (a),
     both ranks' losses, gradients and parameters equal to the bit, no
     kernel launched; the mfm epoch's logs the same on both ranks and
     finite, no kernel launched, its checkpoint reproducing its MAE;
 29. tensor and sequence parallelism: two ranks on the card over gloo. Its parts that
     time nothing run beside phase 24's runs, which time nothing either
     (phase 24 waits for them before it times its steps): (a) ``python -m
     sdumc_tpu_torch.cli.extract text --tp 2`` on phase 13's transcripts
     and ``... feat4 --tp 2`` on phase 5's features, both on phase 11's
     2-layer Vicuna (bf16; two commands, each starting its two ranks);
     two ranks started as ``chip_smoke.py --tp-worker``: (b) phase 10's
     f32 decoder at Vicuna-7B width split in two against one process,
     every hidden state and the logits to phase 10's 1e-4, a beam-4
     decode's tokens and step counts equal and its taps to 1e-4; (d) phase
     5's wavlm-large split in two (8 heads a rank) at f32 and bf16 on its
     two shortest wavs, the last hidden state and tap -5 held to one
     process at phase 5's and phase 21's tolerances, 24 flash launches a
     rank, each rank's first at H = 8 held to its plain version; (e)
     phase 5's wavlm-large on its 60-s clip (T = 2999, padded to 3000),
     the frames split in two by ``parallel.wavlm_forward_sp`` (ring
     attention: the WavLM kernel's block instance, 2 steps a layer, K, V
     and the key mask rotated through gloo's page-locked host copies),
     every tap held to one process's flash-path forward at phase 5's f32
     tolerance, 48 block launches a rank and no other kernel, each rank's
     first (out and log-sum-exp) held to its plain version, then at bf16:
     finite, each tap's least per-frame cosine against the f32 SP taps
     held to phase 21's floor; rank 0 computes (a)'s witness, each clip's
     first feat4 row at f32 in one process. Phase 29 itself: with nothing
     else on the card, the ranks
     run (c), the 4-layer bf16 model, each rank seeding its shards, phase
     14's batch and 31 decode steps of phase 12's chunk, ms by CUDA events
     beside phases 14 and 12, the collectives' ms and share of a run that
     times each, each rank's peak memory beside phase 12's; then every
     part is held, each rank's: (a)'s files written by rank 0, the text
     taps within 4 bf16 ulps of the largest of phase 13's --tp 1 files,
     every feat4 clip's first row (before any beam choice) within 4 bf16
     ulps of the row's largest tap of phase 11's, at most 1% of those
     elements outside phase 11's bf16 tolerance, and the first rows no
     farther from the f32 witness than 1.25 times --tp 1's (relative L2),
     the ranks' tokens checked equal after each chunk, and how far the
     rest of each clip follows --tp 1 printed, not held; (b); (c); (d);
     (e); then (e) timed, the ranks alone on the card: the SP forward by
     CUDA events and the host clock beside one process's (rank 0, the
     other rank at a barrier), the rotations' share of a run that times
     each, each rank's peak memory beside one process's; then (e)'s
     gradient at f32, the loss a seeded linear functional of every tap:
     the SP forward under autograd (48 block launches a rank), the ring's
     backward and ``parallel.reduce_gradients`` of every parameter and
     the wave, timed the same way (the rotations' and the collectives'
     share) beside one process's forward (the flash path) and backward,
     rank 0's gradients held to one process's, tensor by tensor on the
     card (SP_GRAD_RTOL, SP_GRAD_FLOOR), and rank 1's to rank 0's bit for
     bit (a digest of each tensor's bits); last, the block
     instance at the ring's shape (B = 1, 1500 frames, 16 heads of 64) held
     to its plain version and timed beside the bound and PyTorch's
     memory-efficient attention with its log-sum-exp.
 30. the hierarchical data axis, the combined step and the pipeline: four
     ranks on the card over gloo, each started as ``chip_smoke.py
     --pp-worker`` beside phase 24's runs (phase 24 waits for their untimed
     work too); there: (a) one dropout-off train step at the published
     widths on the first train batch (8 rows a rank) on the 2 x 2
     ``parallel.make_hierarchical_mesh`` axis and on the flat 4-rank axis,
     the launch counters around each, and the single-process step; rank 0
     writes Vicuna-7B's trunk at 4 of its 32 layers in HF's format (fp16,
     seeded on the card); (b) ``parallel.make_tp_dp_dual_step`` on the 2 x
     2 ``make_mesh`` grid: that trunk at f32, each model rank reading its
     slices, frozen, its -4..-1 tap sum the text stream of 64 token ids a
     row, one dropout-off fusion step on 16 rows a data rank, the launch
     counters around it, and the TP 1 x DP 1 step in one process; (c)
     ``parallel.llama_pp_forward`` of the same trunk over 4 stages (stage s
     reading its layer, the embedding and the final norm), 16 x 64 ids, M =
     4, one tap, each stage's weights and forward peak, and one process's
     forward. Phase 30 itself, nothing else on the card: the gradient sums
     and steps of (a), the step of (b) and the forward of (c) timed by CUDA
     events beside one process's, the pipeline's exchanges timed one by
     one; then every part held, each rank's: (a) the loss to 1e-5 of one
     process, every gradient to phase 8's ratio, 3 + 3 fusion launches a
     rank; (b) the loss to 1e-4, JAX's first fusion leaf to 1e-3 / 1e-5,
     the fusion parameters moved and equal in each model group, 3 + 3
     launches a rank; (c) the last hidden state and the tap within 2.5e-5
     of one process's forward of the same microbatches, and of its
     forward of the whole batch within 2.5e-5 of the largest value (f32
     sums of other GEMM shapes), each stage holding only its layer.
Each phase prints its seconds, and the total of phases 2-30 follows; a
watchdog stops a phase past max(PHASE_MIN_BOUND, 3 x PHASE_BUDGET), or
past SCRIPT_DEADLINE, printing every thread's stack, and every wait on
another process is bounded (WAIT_SECONDS, TP_GO_SECONDS; the ranks'
collectives RANK_COLLECTIVE_SECONDS). Before the last lines, one JSON line
gives each phase's seconds, its budget, the kernel build's and the whole
script's; then the card's name and power limit, {"kernels": [...]}, and
last {"ok": true, "device": {...}}. Imports nothing of JAX or
sdumc_tpu.

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
import faulthandler
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time
import wave

T_START = time.perf_counter()

# The script's budget: each phase's seconds on a host whose phases ran about 1.3 times
# as long as on the fastest one measured (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
# section 6), their sum with the kernel build under 960 s, well under the 1200 s limit. A phase that runs past max(PHASE_MIN_BOUND, 3 x its budget), or past
# SCRIPT_DEADLINE since the start, is stopped by a watchdog that prints every thread's
# stack and exits non-zero.
PHASE_BUDGET = {2: 18, 3: 1, 4: 5, 5: 17, 7: 18, 8: 5, 9: 9, 10: 16, 11: 35, 12: 25, 13: 5,
                14: 6, 15: 44, 16: 16, 17: 2, 18: 43, 19: 3, 20: 1, 21: 15, 22: 32, 23: 74,
                24: 170, 25: 45, 26: 75, 27: 180, 28: 8, 29: 30, 30: 25}
PHASE_MIN_BOUND = 120
SCRIPT_DEADLINE = 1180
# Every wait of the main run is bounded at about 3 x what it took in measured runs
# and at most 300 s; each rank's collectives time out at RANK_COLLECTIVE_SECONDS.
WAIT_SECONDS = {
    "cli.export": 90,               # 22-28 s
    "serve": 100,                   # 33 s
    "cli.export --decode": 120,     # 37-39 s
    "serve --decode": 105,          # 34 s
    "dp side": 150,                 # phase 28's work beside phase 24, from its start: 48 s
    "dp ranks": 15,                 # phase 28's timed steps: 4.3 s
    # phase 24's wait past its own runs for phase 29's side work (its long pole
    # ``cli.extract feat4 --tp 2``): 27.3 s, and 38.2 s on a host about 1.45 times
    # slower; about 100 s expected on a host whose gloo is the slow kind (PERF.md
    # section 7)
    "tp side": 240,
    "tp ranks": 90,                 # phase 29's (c) and (e) with its gradient, timed: 17-27 s
    "pp ranks": 75,                 # phase 30's timed part: 3 x its budget
    "pp side": 240,                 # phase 30's untimed part alone (--pp-only)
    "kernel build": 60,             # 10.7-11.0 s
}
RANK_COLLECTIVE_SECONDS = 120
RANK_ENV = {"SDUMC_SHUTDOWN_TIMEOUT": str(RANK_COLLECTIVE_SECONDS)}

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
# the block instance (phase 29 (e)): ring attention's step, with each row's log-sum-exp
FLASH_BLOCK = {**FLASH, "name": "flash_wavlm_block"}
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
# the data plane (phase 18): one epoch of the train split through BatchIterator at the
# main path's batch, page-locked as cli.train reads it, the C++ fill against the plain one.
# Every batch equal, save the rows of a clip mean-pooled into the last bucket: f32 there to
# FILL_RTOL / FILL_ATOL (the JAX package's rule for its two fills, tests/test_native.py:
# numpy's mean divides, the C++ multiplies by 1 / pool), bf16 and int8 to one unit in the
# last place (that last bit of the f32 mean can move the cast)
FILL_RTOL, FILL_ATOL = 1e-6, 1e-7
# the ring on the bf16 store: each batch's copy to the card held back behind
# torch.cuda._sleep (about 0.2 s at up to 2 GHz, longer than the producer takes to refill
# the ring's next slots at this width), over RING_EPOCHS epochs
RING_PREFETCH, RING_EPOCHS, RING_SLEEP_CYCLES = 1, 2, 4 * 10**8
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
# Vicuna-7B has 32 layers. Phases 12, 14, 27 and 29 (c) run 4 of them: the depth
# cut that holds the script's time (PERF.md section 6: at 32, 16 and 8 layers the
# script ran past its budget); phases 10-11 run 2
VICUNA_FULL_LAYERS = 32
VICUNA_LAYERS, CLI_LAYERS = 4, 2
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


def run_bounded(argv, what: str, **kw) -> subprocess.CompletedProcess:
    """``subprocess.run(argv, capture_output=True, text=True, **kw)`` within
    WAIT_SECONDS[what]; past it the process is killed, the end of its output
    printed, and RuntimeError raised."""
    try:
        return subprocess.run(argv, capture_output=True, text=True,
                              timeout=WAIT_SECONDS[what], **kw)
    except subprocess.TimeoutExpired as e:
        for name, text in (("output", e.stdout), ("errors", e.stderr)):
            if text:
                text = text.decode(errors="replace") if isinstance(text, bytes) else text
                print(f"--- {what}: the end of its {name} ---\n{text[-4000:]}", file=sys.stderr)
        raise RuntimeError(f"{what} ran past its bound of {WAIT_SECONDS[what]} s") from None


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def key_averages(prof):
    """``prof.key_averages()``, grouped once per profile: each call groups
    every event of the trace again (seconds for a recurrent family's step
    of 12-26 thousand launches)."""
    if getattr(prof, "_averages", None) is None:
        prof._averages = prof.key_averages()
    return prof._averages


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
        found = [e for e in key_averages(prof)
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
    return {"bytes": 1e3 * nbytes / PEAK_HBM_BYTES, "flops": mma + ffma,
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
                  "bound_flops": 0, "max_ulps": 0.0, "blocks": 0, "tile_frames": 0, "w_bytes": 0, "frames": 0,
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
            tot["bound_flops"] += bnd["flops"]
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
    counts[FLASH_BLOCK["name"]] = flash_wavlm.LAUNCHES_BLOCK
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
    return {"bytes": 1e3 * nbytes / PEAK_HBM_BYTES, "flops": flops,
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
           "device_ms": 0.0, "bound_flops": 0, "calls": {}}
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
                         ("device_ms", dev_ms), ("bound_flops", bnd["flops"])):
            tot[key] += val
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["calls"][f"B={B} T={T}"] = ms
        print(f"  flash_wavlm B={B} T={T} valid keys={lengths[:B].tolist() if B > 1 else T} "
              f"max_abs_err={err!r} (checked at B={rows}) kernel_ms={ms!r} device_ms={dev_ms!r} "
              f"plain_ms={plain_ms!r} sdpa_ms={lib_ms!r} (sdpa max abs diff {lib_err!r}) "
              f"bound_ms={least!r} (bytes {bnd['bytes']!r}, operations {bnd['operations']!r}; "
              f"f32 bound {bnd['f32']!r})")
    return tot


def flash_block_bound_ms(B, T, n_valid, num_buckets=320):
    """flash_bound_ms for the block instance: the same reads, its bias
    diagonal in place of rel_embed, and the log-sum-exp written too."""
    H, hd = FLASH_H, FLASH_HD
    nbytes = 4 * (4 * B * T * H * hd + 2 * B * H * T + H * (2 * T - 1) + B * T)
    flops = 4 * H * hd * T * int(sum(n_valid))
    return {"bytes": 1e3 * nbytes / PEAK_HBM_BYTES, "flops": flops,
            "operations": 1e3 * TF32_PASSES * flops / PEAK_TF32_FLOPS}


def flash_block_phase(torch, flash_wavlm, t_local: int) -> dict:
    """The block instance at the ring's shape (B = 1, T_local frames,
    wavlm-large's heads) on seeded inputs, its keys masked as the last
    rank's padded block is (the last key), at offsets 0 and +T_local: out
    and log-sum-exp against the plain version (FLASH_RTOL / FLASH_ATOL), then
    timed (CUDA events, the profiler's device time) beside the plain
    version, the bound and one PyTorch call: the memory-efficient SDPA
    kernel with compute_log_sumexp on the same materialised f32 bias."""
    gen = torch.Generator().manual_seed(29)
    dev = torch.device("cuda")
    q, k, v = (torch.randn(1, t_local, FLASH_H, FLASH_HD, generator=gen).to(dev)
               for _ in range(3))
    gate = (1 + torch.rand(1, FLASH_H, t_local, generator=gen)).to(dev)
    rel = torch.randn(320, FLASH_H, generator=gen).to(dev)
    kvalid = (torch.arange(t_local) < t_local - 1).float()[None].to(dev)
    err = 0.0
    with torch.inference_mode():
        for offset in (0, t_local):
            diag = flash_wavlm.bias_diag_for(rel, t_local, 320, 800, offset=offset)
            out, lse = flash_wavlm.flash_block(q, k, v, gate, diag, kvalid)
            ref_out, ref_lse = flash_wavlm.flash_block_plain(q, k, v, gate, diag, kvalid)
            torch.cuda.synchronize()
            err = max(err, (out - ref_out).abs().max().item(), (lse - ref_lse).abs().max().item())
            if not (torch.allclose(out, ref_out, rtol=FLASH_RTOL, atol=FLASH_ATOL)
                    and torch.allclose(lse, ref_lse, rtol=FLASH_RTOL, atol=FLASH_ATOL)):
                raise AssertionError(f"flash_wavlm_block at offset {offset}: max abs err {err!r}")

        def kern():
            return flash_wavlm.flash_block(q, k, v, gate, diag, kvalid)

        ms = time_ms(kern)
        dev_ms = device_ms(torch, kern, ("flash_wavlm",))
        plain_ms = time_ms(lambda: flash_wavlm.flash_block_plain(q, k, v, gate, diag, kvalid))
        # the library's call: heads-first q, k, v and the bias built outside the timed region,
        # its rows padded to a multiple of 16 floats (the kernel's alignment) and cut back
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pad = -t_local % 16
        bias = torch.zeros(1, FLASH_H, t_local, t_local + pad, device=dev)
        bias[..., :t_local] = (gate[..., None] * flash_wavlm.dense_bias(diag, t_local)[None]
                               + torch.where(kvalid > 0, 0.0, flash_wavlm.NEG)[:, None, None, :])
        bias = bias[..., :t_local]

        def library():
            return torch.ops.aten._scaled_dot_product_efficient_attention(
                qh, kh, vh, bias, True)

        try:
            lib_out, lib_lse = library()[:2]
            lib_err = max((lib_out.transpose(1, 2) - ref_out).abs().max().item(),
                          (lib_lse[..., :t_local] - ref_lse).abs().max().item())
            lib_ms = time_ms(library)
        except RuntimeError as e:
            lib_ms, lib_err = None, f"raises: {str(e).splitlines()[0]}"
    bnd = flash_block_bound_ms(1, t_local, [t_local - 1])
    least = max(bnd["bytes"], bnd["operations"])
    print(f"  flash_wavlm_block (the ring's step) B=1 T_local={t_local} H={FLASH_H} hd={FLASH_HD}, "
          f"the last key masked, offsets 0 and +{t_local}: max_abs_err={err!r} (out and lse, "
          f"rtol {FLASH_RTOL} atol {FLASH_ATOL}) kernel_ms={ms!r} device_ms={dev_ms!r} "
          f"plain_ms={plain_ms!r} library_ms={lib_ms!r} (efficient SDPA with its log-sum-exp; "
          f"max abs diff {lib_err!r}) bound_ms={least!r} (bytes {bnd['bytes']!r}, operations "
          f"{bnd['operations']!r}), {least / ms:.1%} of it")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": least, "bytes_ms": bnd["bytes"], "operations_ms": bnd["operations"],
            "bound_flops": bnd["flops"], "shape": (1, t_local), "max_abs_err": err}


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
    kernels = sorted((e for e in key_averages(prof) if e.device_type == DeviceType.CUDA
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


def training_phase(torch, fused_cross, ckpt_dir: str):
    """cli.train --synthetic for TRAIN_EPOCHS epochs at full width, with the
    launch counters around it, its checkpoints in `ckpt_dir` (phase 26
    exports best_full.pt); its best_full.pt through cli.infer."""
    from sdumc_tpu_torch.cli import infer, train
    from sdumc_tpu_torch.data.pipeline import get_loaders

    cfg = main_path_config()
    bs = cfg.data.batch_size
    train_ds, val_ds, test_ds = get_loaders(cfg.data.dataset, cfg.data, cfg.paths, synthetic=True)
    per_epoch = len(train_ds) // bs + math.ceil(len(val_ds) / bs) + math.ceil(len(test_ds) / bs)
    os.makedirs(ckpt_dir, exist_ok=True)
    reset_counts()
    t0 = time.perf_counter()
    result = train.main(TRAIN_ARGV + ["--checkpoint_dir", ckpt_dir, "--save_root", ckpt_dir])
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

    out = infer.main(MAIN_ARGV + ["--checkpoint", os.path.join(ckpt_dir, "best_full.pt")])
    mae, best = out["full"]["mae"], result["best_full"]["mae"]
    print(f"best_full.pt (epoch {result['best_full']['epoch'] + 1}) through cli.infer: test MAE "
          f"{mae!r}, the loop recorded {best!r} (tolerance rtol={CKPT_MAE_RTOL}: the same "
          f"kernels on the same batches)")
    if abs(mae - best) > CKPT_MAE_RTOL * abs(best):
        raise AssertionError("the best checkpoint does not reproduce its MAE")
    return launches, result["history"]


def first_train_batch(cfg, train_ds):
    from sdumc_tpu_torch.data.pipeline import BatchIterator

    return next(iter(BatchIterator(train_ds, cfg.data.batch_size, shuffle=True,
                                   seed=cfg.data.shuffle_seed, epoch=0,
                                   buckets=cfg.data.length_buckets, prefetch=0,
                                   drop_remainder=True)))


def make_step(torch, cfg, model, axis=None, **kw):
    from sdumc_tpu_torch.train.state import create_train_state
    from sdumc_tpu_torch.train.step import make_train_step

    state = create_train_state(model, cfg.train, 8)
    return make_train_step(state, cfg.loss, cfg.train.seed, axis, **kw)


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

    # remat: the same seeded weights and batch on the card with the live dropouts,
    # make_train_step(remat=True) against the default step
    live = dataclasses.replace(cfg.model, input_dims=train_ds.input_dims()[:3])

    def run_live(remat):
        model = get_model(live, torch.Generator().manual_seed(cfg.train.seed)).to("cuda")
        metrics = make_step(torch, cfg, model, remat=remat)(batch_to_device_dict(batch, "cuda"))
        return (metrics["loss"].item(),
                {k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None})

    t_remat = time.perf_counter()
    (loss_live, g_live), (loss_remat, g_remat) = run_live(False), run_live(True)
    remat_worst, remat_key = worst_ratio(g_live, g_remat)
    max_diff = max((g_remat[k] - ref).abs().max().item() for k, ref in g_live.items())
    equal = loss_remat == loss_live and all(torch.equal(g_remat[k], g_live[k]) for k in g_live)
    print(f"remat, one card step with the live dropouts (dropout {live.dropout}, attn_dropout "
          f"{live.attn_dropout}; loss {loss_live!r}, {loss_card!r} with dropout off): "
          f"remat=True loss {loss_remat!r} vs the default step's {loss_live!r}; "
          f"{len(g_live)} gradients, max abs diff {max_diff!r}, worst max-abs-diff / "
          f"(GRAD_RTOL max|grad| + GRAD_ATOL) = {remat_worst!r} at {remat_key} (must be <= 1); "
          f"equal to the bit: {equal}; {time.perf_counter() - t_remat!r} s")
    if (abs(loss_remat - loss_live) > GRAD_RTOL * abs(loss_live) + GRAD_ATOL
            or remat_worst > 1.0):
        raise AssertionError("the remat train step disagrees with the default step")
    if loss_live == loss_card:
        raise AssertionError("the live dropouts drew nothing")


def step_timing_phase(torch, card=None, extras: bool = True):
    """A warm train step (the live dropouts) on the card's copy of the first
    train batch: CUDA events over TIMED_STEPS steps, peak memory, then
    device time by family of PROFILED_STEPS steps under torch.profiler.
    With `extras`: the step's roofline (``utils.roofline.program_cost`` on
    one untimed step, ``Roofline.report`` at the timed ms against
    ``detect_peaks()``), then the remat step (``make_train_step(remat=True)``)
    timed the same way with its peak memory, from the same seeded weights."""
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
    resident = torch.cuda.memory_allocated() / 2**30
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
    host_ops = sorted((e for e in key_averages(prof) if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)
    launches = sum(e.count for e in host_ops if "LaunchKernel" in e.key)
    print(f"host side: {launches / PROFILED_STEPS!r} kernel launches per step; host ops by "
          f"self time:")
    for e in host_ops[:8]:
        print(f"  {e.self_cpu_time_total / 1e3 / PROFILED_STEPS:10.3f} ms per step "
              f"{e.count // PROFILED_STEPS:6d} calls  {e.key[:80]}")
    if extras:
        step_roofline_and_remat(torch, cfg, train_ds, d, step, ms, peak - resident,
                                card or card_line())
    return ms


def step_roofline_and_remat(torch, cfg, train_ds, d, step, ms: float, grown: float, card: str):
    """Phase 9's roofline of the warm step and its remat twin (see
    ``step_timing_phase``); `grown` is how far the default step's peak
    memory rose above what was allocated when its timing began (GiB)."""
    from sdumc_tpu_torch.cli.common import build_model
    from sdumc_tpu_torch.utils.roofline import CostMode, Roofline, detect_peaks

    t0 = time.perf_counter()
    with CostMode() as cost:
        step(d)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    peaks = detect_peaks()
    report = Roofline(cost.flops, cost.bytes).report(ms / 1e3, peaks)
    ops = {k: v for k, v in cost.flops_by_op.items() if k.startswith("sdumc.")}
    rate = cost.flops / (ms / 1e3)
    print(f"roofline of the warm train step ({card}): {cost.flops!r} flops (the matrix products "
          f"and the custom ops' formulas; elementwise work uncounted) and {cost.bytes!r} bytes "
          f"(every dispatched op's inputs read and outputs and mutated inputs written, an upper "
          f"bound; {cost.bytes_written!r} of them written) counted on one untimed "
          f"step in {count_s!r} s; at the timed {ms!r} ms: {report} against detect_peaks() "
          f"{peaks}; {100 * rate / peaks['flops_tf32']!r}% of the TF32 peak, "
          f"{100 * rate / peaks['flops_f32']!r}% of the f32 peak; the custom ops' share of the "
          f"counted flops {sum(ops.values()) / cost.flops!r} ({ops}); flops by op "
          f"{dict(cost.flops_by_op)}")
    if not report or not ops:
        raise AssertionError("the roofline counted no work of the step or none of its kernels")

    model = build_model(cfg, train_ds.input_dims(), torch.device("cuda"))
    remat = make_step(torch, cfg, model, remat=True)
    resident = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    remat_ms = time_ms(lambda: remat(d), iters=TIMED_STEPS, warmup=3)
    remat_grown = torch.cuda.max_memory_allocated() / 2**30 - resident
    print(f"remat warm train step ({card}): {remat_ms!r} ms per step over {TIMED_STEPS} steps "
          f"(CUDA events; the default step's {ms!r} ms, ratio {remat_ms / ms!r}); peak device "
          f"memory {remat_grown!r} GiB above what was allocated when its timing began (Adam's "
          f"state and the step's own; the default step's {grown!r} GiB); the roofline and the "
          f"remat step took {time.perf_counter() - t0!r} s")


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


def time_decode(torch, model, cfg, prompts, lens, steps: int, trace=None):
    """(ms per decode step by CUDA events, the run's outputs): a run of
    `steps` new tokens minus a run of 1 (the prefill and the first
    selection), over the steps-1 decode forwards. `trace`, if a dict,
    receives the timed run's candidate gap."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    beam_chunk(torch, model, cfg, prompts, lens, 2)             # warm
    torch.cuda.synchronize()
    ev[0].record()
    beam_chunk(torch, model, cfg, prompts, lens, 1)
    ev[1].record()
    ev[2].record()
    out = beam_chunk(torch, model, cfg, prompts, lens, steps, trace=trace)
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
        for e in key_averages(prof):
            if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
                continue
            name = e.key.lower()
            fam = next((f for f, keys in DECODE_FAMILIES if any(k in name for k in keys)),
                       "elementwise and reductions (norms, rope, casts, attention math)")
            fams[fam] = fams.get(fam, 0.0) + e.self_device_time_total / 1e3
            busy += e.self_device_time_total / 1e6
        launches = sum(e.count for e in key_averages(prof)
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


FULL_DEPTH_CLIPS = 8          # phase 12's short clips, beside the 60 s one


class ChunkTimer:
    """Within it, each chunk that ``Feat4Extractor.extract_many`` decodes
    (``beam_generate_batched``) is timed by CUDA events from the end of its
    prefill to the end of its last decode step; ``chunks`` lists (prompt
    bucket, events, decode steps) in the order they ran."""

    def __init__(self, torch):
        self.torch, self.chunks = torch, []

    def __enter__(self):
        from sdumc_tpu_torch.models import generation

        self.saved = generation.beam_prefill, generation.beam_step
        prefill, step = self.saved

        def timed_prefill(apply_fn, prompt_embeds, *a, **kw):
            state = prefill(apply_fn, prompt_embeds, *a, **kw)
            ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            self.chunks.append([prompt_embeds.shape[1], ev, 0])
            return state

        def timed_step(*a, **kw):
            live = step(*a, **kw)
            self.chunks[-1][1][1].record()
            self.chunks[-1][2] += 1
            return live

        generation.beam_prefill, generation.beam_step = timed_prefill, timed_step
        return self

    def __exit__(self, *exc):
        from sdumc_tpu_torch.models import generation

        generation.beam_prefill, generation.beam_step = self.saved
        return False

    def ms_per_step(self, i: int) -> float:
        _, ev, steps = self.chunks[i]
        self.torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / steps


def timed_chunk(torch, ex, feats):
    """Phase 12's timed chunk: the first GEN_BATCH clips of the 256 bucket
    (else the largest full one), as (prompts [C, bucket, D], lengths,
    bucket), their prompts made by `ex` (a Feat4Extractor)."""
    lens_all = [ex.prompt_len_for(len(f)) for f in feats]
    buckets = [next((b for b in ex.prompt_buckets if n <= b), n) for n in lens_all]
    bucket = 256 if buckets.count(256) >= GEN_BATCH else max(
        b for b in set(buckets) if buckets.count(b) >= GEN_BATCH)
    pick = [i for i, b in enumerate(buckets) if b == bucket][:GEN_BATCH]
    prompts = torch.stack([ex._padded_prompt(feats[i], bucket) for i in pick])
    return prompts, [lens_all[i] for i in pick], bucket


def full_depth_phase(torch, llm_dir: str, proj_path: str, feats_dir: str):
    """Phase 12: Vicuna-7B at VICUNA_LAYERS in bf16 (seeded on the card) through
    Feat4Extractor.extract_many on 9 of phase 5's features at --gen_batch 4; a
    timed and profiled chunk; then one chunk of 32 steps with int8, w8a8
    and int8-KV, each against bf16. Returns the bf16 chunk's ms per step
    over QUANT_STEPS steps and the extraction's peak memory (GiB)."""
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
    print(f"Vicuna-7B-v1.5 at {cfg.num_layers} of its {VICUNA_FULL_LAYERS} layers (bf16, "
          f"{n_params} parameters, "
          f"{wbytes / 1e9!r} GB streamed per step), seeded on the card in "
          f"{time.perf_counter() - t0!r} s")
    ex = Feat4Extractor(model, load_projector(proj_path, device=DEVICE),
                        LlamaTokenizer.from_dir(llm_dir), max_new_tokens=MAX_NEW,
                        gen_batch=GEN_BATCH)
    files = sorted(glob.glob(os.path.join(feats_dir, "*.npy")))
    feats = [np.load(p) for p in files]
    # depth cut to hold the script's time: the first FULL_DEPTH_CLIPS short clips and the
    # 60 s one (the timed chunk below still picks from all of them)
    run = list(range(FULL_DEPTH_CLIPS)) + [len(files) - 1]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ChunkTimer(torch) as chunks:
        results = ex.extract_many([feats[i] for i in run])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_tok = sum(len(r["taps"]) for r in results)
    for path, r in zip([files[i] for i in run], results):
        if r["taps"].shape[1] != cfg.hidden_size or not np.isfinite(r["taps"]).all():
            raise AssertionError(f"{path}: taps {r['taps'].shape} or non-finite")
    per_clip = sorted({len(r["taps"]) for r in results})
    print(f"{cfg.num_layers} layers, Feat4Extractor.extract_many on {len(run)} clips at --gen_batch "
          f"{GEN_BATCH}: {n_tok} taps rows (steps per clip {per_clip}), {seconds!r} s host "
          f"clock, {n_tok / seconds!r} clip-tokens/s; peak device memory {peak!r} GiB")

    # one of extract_many's own chunks, timed as it ran: the first whole one
    # (GEN_BATCH real clips) of the 256 bucket, else of the largest bucket that has one
    per_bucket = {}
    for i in run:
        per_bucket.setdefault(next((b for b in ex.prompt_buckets
                                    if ex.prompt_len_for(len(feats[i])) <= b),
                                   ex.prompt_len_for(len(feats[i]))), []).append(i)
    real = [min(GEN_BATCH, len(rows) - ofs) for _, rows in sorted(per_bucket.items())
            for ofs in range(0, len(rows), GEN_BATCH)]
    whole = [i for i, n in enumerate(real) if n == GEN_BATCH]
    if len(real) != len(chunks.chunks) or not whole:
        raise AssertionError(f"extract_many ran {len(chunks.chunks)} chunks, expected "
                             f"{len(real)} with a whole one")
    pick = next((i for i in whole if chunks.chunks[i][0] == 256),
                max(whole, key=lambda i: chunks.chunks[i][0]))
    bucket, _, steps = chunks.chunks[pick]
    ms = chunks.ms_per_step(pick)
    bound = decode_bound_ms(cfg, wbytes, GEN_BATCH, bucket, steps + 1)
    print(f"  one of extract_many's chunks, timed as it ran ({GEN_BATCH} clips, prompt bucket "
          f"{bucket}, {steps} decode steps after the prefill): {ms!r} ms per decode step "
          f"(CUDA events), {GEN_BATCH * 1e3 / ms!r} clip-tokens/s; bound {bound!r} ms per "
          f"step (weights {wbytes / 1e9!r} GB + the KV cache at {PEAK_HBM_BYTES / 1e12} "
          f"TB/s), {bound / ms:.1%} of it; every chunk's ms per step "
          f"{[(c[0], chunks.ms_per_step(i)) for i, c in enumerate(chunks.chunks)]!r}")
    prompts, lens, bucket = timed_chunk(torch, ex, feats)
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
    return {"step_ms": ref_ms, "peak_gib": peak}


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


def text_batch(torch, tok, sents):
    """Phase 14's timed batch: one full batch of the most populated bucket,
    as (ids [TEXT_BATCH, bucket], lengths, bucket) on the card."""
    from sdumc_tpu_torch.extract.text import BUCKETS

    ids_of = [tok(s)["input_ids"] for s in sents if s.strip()]
    bucket_of = [next((b for b in BUCKETS if len(i) <= b), len(i)) for i in ids_of]
    bucket = max(set(bucket_of), key=bucket_of.count)
    chunk = [i for i, b in zip(ids_of, bucket_of) if b == bucket][:TEXT_BATCH]
    ids = torch.zeros(TEXT_BATCH, bucket, dtype=torch.long)
    for j, row in enumerate(chunk):
        ids[j, :len(row)] = torch.tensor(row)
    lengths = torch.tensor([len(r) for r in chunk] + [0] * (TEXT_BATCH - len(chunk)))
    return ids.to(DEVICE), lengths.to(DEVICE), bucket


def text_full_depth_phase(torch, llm_dir: str, rows):
    """Phase 14: the Vicuna-7B trunk at VICUNA_LAYERS in bf16 (seeded on the
    card) through extract_text_features on the transcripts, with each tap
    set: sentences/s, peak memory, ms per batch by CUDA events beside the
    bound, and device time by family of a profiled run. Returns the batch's
    ms and the peak memory (GiB)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.convert.llama_tokenizer import LlamaTokenizer
    from sdumc_tpu_torch.extract.text import extract_text_features, run_batch
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
    print(f"Vicuna-7B-v1.5 trunk at {cfg.num_layers} of its {VICUNA_FULL_LAYERS} layers (bf16, "
          f"{n_body} "
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
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak device memory {peak!r} GiB")

    ids, lengths, bucket = text_batch(torch, tok, sents)
    chunk = [n for n in lengths.tolist() if n]
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
    return {"batch_ms": ms, "peak_gib": peak}


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
    # the PROFILED_CLIPS shortest clips: the cold run's and the profiled run's
    sub_dir = os.path.join(tmp, "faces_profiled")
    os.makedirs(sub_dir)
    for v in sorted(frames, key=frames.get)[:PROFILED_CLIPS]:
        os.symlink(os.path.join(face_dir, v), os.path.join(sub_dir, v))
    argv = ["visual", "--checkpoint", ckpt, "--face_dir", face_dir, "--save_dir", save_root]
    reset_counts()
    cold = extract.main(["visual", "--checkpoint", ckpt, "--face_dir", sub_dir, "--save_dir",
                         os.path.join(tmp, "visual_cold")])
    out = extract.main(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    for vid, n in frames.items():
        feat = np.load(os.path.join(out["save_dir"], f"{vid}.npy"))
        if feat.shape != (n, 1024) or feat.dtype != np.float32 or not np.isfinite(feat).all():
            raise AssertionError(f"{vid}: {feat.shape} {feat.dtype} (want ({n}, 1024)) or non-finite")
    print(f"visual path (cli.extract visual, defaults: batch 32, FRAME): a cold run of the "
          f"{PROFILED_CLIPS} shortest clips ({cold['frames']} frames in {cold['seconds']!r} s), "
          f"then {out['videos']} clips, {out['frames']} frames in {out['seconds']!r} s host "
          f"clock, {out['frames'] / out['seconds']!r} frames/s (warm; reading and resizing "
          f"{out['decode_seconds']!r} s of it, "
          f"{out['decode_seconds'] / out['seconds']:.1%}); launches of the port's kernels "
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

    # the profiler's trace of all 12 clips takes longer to read than the run
    # itself: a warm run over the PROFILED_CLIPS shortest clips instead
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
    .bin / .json, labels/CMU-MOSEI.npz). Returns ({dtype: root}, the
    directory of the .npy directories)."""
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
    return roots, npy


def store_train_split(cfg, sources: dict):
    """The store's train split (STORE_SPLITS' first) over `sources`."""
    from sdumc_tpu_torch.data.pipeline import MoseiDataset

    names = [f"train_{i}" for i in range(STORE_SPLITS[0][1])]
    return MoseiDataset(names, [{"val": 0.5}] * len(names), sources)


def store_sources(cfg, npy: str, roots: dict, kind: str) -> dict:
    """{modality: source} of the .npy directories (kind "npy") or of the
    packed store at dtype `kind`."""
    from sdumc_tpu_torch.data.feature_store import NpyDirSource
    from sdumc_tpu_torch.data.packed import PackedSource

    names = {"audio": cfg.data.audio_feature, "text": cfg.data.text_feature,
             "video": cfg.data.video_feature, "feat4": cfg.data.feat4_feature}
    if kind == "npy":
        return {k: NpyDirSource(npy, v) for k, v in names.items()}
    features = os.path.join(roots[kind], "features", cfg.data.dataset)
    return {k: PackedSource(os.path.join(features, v), v) for k, v in names.items()}


def hold_fill(native, plain, sources) -> tuple:
    """(pooled rows, elements that differ) of one batch of the C++ fill
    against the plain fill's; raises where they disagree past FILL_RTOL /
    FILL_ATOL or one unit in the last place (pooled rows), or at all."""
    import numpy as np

    if native.names != plain.names or native.t_max != plain.t_max or not np.array_equal(
            native.lengths, plain.lengths):
        raise AssertionError("the C++ and the plain fill give other clips, t_max or lengths")
    pooled = differ = 0
    for key in ("audio", "text", "video", "feat4"):
        a, b = getattr(native, key), getattr(plain, key)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{key}: {a.dtype} {a.shape} against {b.dtype} {b.shape}")
        rows = np.array([sources[key].length_of(n) > a.shape[1] for n in native.names])
        if not np.array_equal(a[~rows], b[~rows]):
            raise AssertionError(f"{key}: the C++ fill differs from the plain fill")
        if rows.any():
            if a.dtype == np.float32:
                np.testing.assert_allclose(a[rows], b[rows], rtol=FILL_RTOL, atol=FILL_ATOL)
            elif np.abs(a[rows].astype(np.int64) - b[rows].astype(np.int64)).max() > 1:
                raise AssertionError(f"{key}: pooled rows differ by more than one unit")
            pooled += int(rows.sum())
            differ += int((a[rows] != b[rows]).sum())
    return pooled, differ


def producer_epoch(torch, cfg, ds, label: str) -> dict:
    """One epoch of `ds` through BatchIterator as cli.train reads it
    (shuffled, whole batches, page-locked), the C++ fill and the plain fill
    in lockstep with no prefetch (each next() is the producer's own time):
    every batch held (hold_fill), and each fill's seconds and GB/s of batch
    bytes printed. Returns {"native"|"plain": seconds, "bytes": ...}."""
    from sdumc_tpu_torch.data.pipeline import BatchIterator

    kw = dict(shuffle=True, seed=cfg.data.shuffle_seed, buckets=cfg.data.length_buckets,
              pin_memory=True, drop_remainder=True, prefetch=0)
    its = {"native": iter(BatchIterator(ds, cfg.data.batch_size, **kw)),
           "plain": iter(BatchIterator(ds, cfg.data.batch_size, plain=True, **kw))}
    per_batch = {path: [] for path in its}
    nbytes = pooled = differ = 0
    while True:
        got = {}
        for path, it in its.items():
            t0 = time.perf_counter()
            got[path] = next(it, None)
            per_batch[path].append(time.perf_counter() - t0)
        if got["native"] is None or got["plain"] is None:
            if got["native"] is not got["plain"]:
                raise AssertionError(f"{label}: the two fills give other batch counts")
            break
        p, d = hold_fill(got["native"], got["plain"], ds.sources)
        pooled, differ = pooled + p, differ + d
        nbytes += sum(getattr(got["native"], k).nbytes for k in ("audio", "text", "video", "feat4"))
    out = {path: sum(v) for path, v in per_batch.items()}
    out["bytes"] = nbytes
    print(f"  {label}: {len(per_batch['native']) - 1} batches of {cfg.data.batch_size}, "
          f"{nbytes!r} bytes; C++ fill {out['native']!r} s ({nbytes / out['native'] / 1e9!r} "
          f"GB/s), plain fill {out['plain']!r} s ({nbytes / out['plain'] / 1e9!r} GB/s); per "
          f"batch C++ {per_batch['native']!r}, plain {per_batch['plain']!r}; {pooled} pooled "
          f"rows, {differ} elements of them differ")
    return out


def ring_check(torch, cfg, ds) -> None:
    """The ring on the bf16 store: BatchIterator(reuse_buffers=RING_PREFETCH
    + 2, pin_memory=True) over RING_EPOCHS epochs at the main path's batch,
    each batch copied by batch_to_device_dict (the train loop's copy, to
    bf16 streams, non_blocking) behind torch.cuda._sleep; every batch on the
    card equal to the plain fill's. The control drops each batch's event
    before its copy (nothing is recorded, so a refill does not wait): some
    batch on the card must then hold another batch's bytes."""
    import numpy as np

    from sdumc_tpu_torch.data.pipeline import BatchIterator
    from sdumc_tpu_torch.train.step import batch_to_device_dict

    kw = dict(shuffle=True, seed=cfg.data.shuffle_seed, buckets=cfg.data.length_buckets,
              drop_remainder=True)
    refs = [list(BatchIterator(ds, cfg.data.batch_size, plain=True, prefetch=0, epoch=e, **kw))
            for e in range(RING_EPOCHS)]
    for wait in (True, False):
        ring = BatchIterator(ds, cfg.data.batch_size, pin_memory=True, prefetch=RING_PREFETCH,
                             reuse_buffers=RING_PREFETCH + 2, **kw)
        pending = []
        t0 = time.perf_counter()
        for epoch in range(RING_EPOCHS):
            ring.epoch = epoch
            for batch in ring:
                if not wait:
                    batch.copied = None
                torch.cuda._sleep(RING_SLEEP_CYCLES)
                pending.append(batch_to_device_dict(batch, "cuda", "bfloat16"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        flat = [r for epoch in refs for r in epoch]
        equal = [all(np.array_equal(d[k].cpu().view(torch.int16).numpy().view(np.uint16),
                                    getattr(r, k)) for k in ("audio", "text", "video", "feat4"))
                 for d, r in zip(pending, flat)]
        turns = max(r[0] for r in ring._rings.values())
        print(f"  ring of {RING_PREFETCH + 2} on the bf16 store ({'each refill waits for its '
              f'copy' if wait else 'control: no wait'}), {len(pending)} batches over "
              f"{RING_EPOCHS} epochs behind {RING_SLEEP_CYCLES} cycles of sleep each, "
              f"{seconds!r} s: {sum(equal)} equal to the plain fill; a ring's slots filled "
              f"{turns} times")
        if len(pending) != len(flat) or turns <= RING_PREFETCH + 2:
            raise AssertionError("the ring ran other batches, or reused no slot")
        if wait and not all(equal):
            raise AssertionError(f"ring batches on the card differ from the plain fill: {equal}")
        if not wait and all(equal):
            raise AssertionError("the ring's control shows no race: the check cannot see one")
        del pending
        torch.cuda.empty_cache()


def data_plane_checks(torch, npy: str, roots: dict) -> None:
    """Phase 18's data plane: producer_epoch over the .npy directories and
    each packed store, then ring_check on the bf16 store."""
    cfg = main_path_config(STORE_ARGV)
    t0 = time.perf_counter()
    print("the data plane: one epoch of the train split, C++ fill against plain fill "
          "(page-locked, no prefetch; the files just written, so warm in the page cache)")
    for kind in ("npy",) + STORE_DTYPES:
        producer_epoch(torch, cfg, store_train_split(cfg, store_sources(cfg, npy, roots, kind)),
                       ".npy directories" if kind == "npy" else f"{kind} store")
    ring_check(torch, cfg, store_train_split(cfg, store_sources(cfg, npy, roots, "bfloat16")))
    print(f"the data plane's checks: {time.perf_counter() - t0!r} s")


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

    import shutil

    from sdumc_tpu_torch.data import native

    roots, npy = write_store_datasets(torch, os.path.join(work, "store"))
    data_plane_checks(torch, npy, roots)
    shutil.rmtree(npy)
    before = os.environ.get("SDUMC_DATA_DIR")
    launches = {}
    fill, fills = native.fill_batch_packed, []
    native.fill_batch_packed = lambda *a, **k: fills.append(1) or fill(*a, **k)
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
            fills.clear()
            t0 = time.perf_counter()
            result = train.main(STORE_ARGV + ["--epochs", "1", "--checkpoint_dir", ck,
                                              "--save_root", ck])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = read_counts()
            if len(fills) != 4 * per_epoch:
                raise AssertionError(f"{dtype} store: cli.train filled {len(fills)} streams by "
                                     f"the C++ fill, expected 4 x {per_epoch} batches")
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
            fills.clear()
            out = infer.main(STORE_ARGV + ["--checkpoint", best])
            if len(fills) != 4 * math.ceil(len(test_ds) / bs):
                raise AssertionError(f"{dtype} store: cli.infer filled {len(fills)} streams by "
                                     f"the C++ fill")
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
        native.fill_batch_packed = fill
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
    return {"bytes": 1e3 * nbytes / PEAK_HBM_BYTES, "flops": flops,
            "operations": 1e3 * flops / PEAK_BF16_FLOPS}


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
           "operations_ms": 0.0, "max_abs_err": 0.0, "bound_flops": 0,
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
                         ("operations_ms", bnd["operations"]), ("device_ms", dev_ms),
                         ("bound_flops", bnd["flops"])):
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
        return torch.ops.sdumc.flash_wavlm(q.float(), k.float(), v.float(), gate.float(),
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


def print_op_families(prof, wall: float, title: str, card: str,
                      op_families=VISION_OP_FAMILIES) -> dict:
    """Device time by the operator that launched each kernel (so an
    attention product tells itself from a Linear's though both are cuBLAS
    GEMMs), and the device's idle share of the host-clock window `wall`.
    An operator name ending in ``*`` is a prefix."""
    from torch.autograd import DeviceType

    def matches(key, ops):
        return any(key == op or (op.endswith("*") and key.startswith(op[:-1])) for op in ops)

    busy = sum(e.self_device_time_total for e in key_averages(prof)
               if e.device_type == DeviceType.CUDA) / 1e3
    families = {}
    for e in key_averages(prof):
        if e.device_type != DeviceType.CPU or e.self_device_time_total <= 0:
            continue
        family = next((f for f, ops in op_families if matches(e.key, ops)),
                      "elementwise, norms and the rest")
        families[family] = families.get(family, 0.0) + e.self_device_time_total / 1e3
    if busy <= 0:
        raise AssertionError(f"{title}: the profiler saw no device time")
    print(f"  {title}: {wall!r} s host clock, device busy {busy / 1e3!r} s, idle share "
          f"{1 - busy / 1e3 / wall!r} ({card}); device time by family:")
    for family, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:10.3f} ms {ms / busy:7.2%}  {family}")
    rest = busy - sum(families.values())
    print(f"    {rest:10.3f} ms {rest / busy:7.2%}  (kernels the trace ties to no operator)")
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
        flagged = ["vision", "--model", family, *flags[family]]
        base = flagged + ["--face_dir", face_dir]
        cold = extract.main(flagged + ["--face_dir", sub_dir, "--save_dir",
                                       os.path.join(tmp, "vision", family + "_cold")])
        torch.cuda.reset_peak_memory_stats()        # the warm run's peak: its model alone
        out = warm = extract.main(base + ["--save_dir", os.path.join(tmp, "vision", family)])
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
        print(f"vision {family} ({card}): cold run of the {VISION_PROFILED_CLIPS} shortest clips "
              f"{cold['frames']} frames in {cold['seconds']!r} s; "
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


# ---------------------------------------------------------------- the baseline zoo (phase 24)

# the JAX package's ten registered baseline families, at ModelConfig's widths (what
# ``cli.train --model NAME`` runs in JAX too), on the synthetic store at the published
# input widths, one epoch each
BASELINES = ("tfn", "lmf", "attention", "misa", "mmim", "mfn", "graph_mfn", "mfm", "mctn", "mult")
BASELINE_ARGV = MAIN_ARGV + ["--epochs", "1"]
# one train step card vs CPU on the first rows of the first train batch, dropout off:
# the GEMM (tfn), LSTM (mfn), GRU (mctn, teacher forcing 1 so that no draw enters) and
# attention (mult) paths, with each one's GRAD_RTOL; MulT's CPU step at 8 rows (its
# [rows, 4, 2048, 2048] scores). MulT's gradients sum over 2048 keys, softmax and
# LayerNorm in another order: a sound step read 2.8e-5 of the largest gradient, its
# TF32 control 5.8e-2 (an H100 80GB HBM3 at 700.00 W); 1e-4 lies between
BASELINE_PARITY = (("tfn", 32, GRAD_RTOL), ("mfn", 32, GRAD_RTOL), ("mctn", 32, GRAD_RTOL),
                   ("mult", 8, 1e-4))
# a recurrent family's step launches 12-26 thousand kernels; the profiler's reading of
# 3 steps took most of phase 24 (an H100 80GB HBM3 at 700.00 W), so 1; the warm step
# (0.25-0.74 s for the recurrent families) is timed over 3 steps after 1 (cli.train has
# run each family at these shapes in this process before)
BASELINE_PROFILED_STEPS = 1
BASELINE_TIMED_STEPS, BASELINE_WARMUP = 3, 1
TRAIN_OP_FAMILIES = (
    ("GEMMs (Linear, the cells' products)", ("aten::addmm", "aten::mm")),
    ("batched products (attention q.k^T and p.v, TFN / LMF einsums)",
     ("aten::bmm", "aten::baddbmm")),
    ("convolutions (MulT)", ("aten::cudnn_convolution", "aten::_convolution",
                             "aten::convolution", "aten::convolution_backward")),
    ("softmax", ("aten::_softmax", "aten::_softmax_backward_data", "aten::_log_softmax",
                 "aten::_log_softmax_backward_data")),
    ("Adam (foreach)", ("aten::_foreach_*", "aten::_fused_adam*")),
    ("memory copies", ("aten::copy_", "aten::_to_copy")),
)


def head_rows(batch, rows: int):
    """The first `rows` clips of a host batch (its t_max kept)."""
    import dataclasses

    return dataclasses.replace(
        batch, audio=batch.audio[:rows], text=batch.text[:rows], video=batch.video[:rows],
        feat4=batch.feat4[:rows], lengths=batch.lengths[:, :rows], emos=batch.emos[:rows],
        vals=batch.vals[:rows], names=batch.names[:rows], pinned=())


class SharedSyntheticSources:
    """Within it, each synthetic store that ``cli.train`` / ``cli.infer``
    build in this process takes the ``SyntheticSource`` objects (with the
    clips they have drawn) of the first store of the same arguments: phase
    24's eleven runs read one store, which each drew again otherwise (about
    9 s of the host's time a run at full width). The sources go when it is
    left."""

    def __enter__(self):
        from sdumc_tpu_torch.data import pipeline

        self.pipeline, self.real, made = pipeline, pipeline.SyntheticSource, {}

        def source(*args, **kw):
            key = (args, tuple(sorted(kw.items())))
            if key not in made:
                made[key] = self.real(*args, **kw)
            return made[key]

        pipeline.SyntheticSource = source
        return self

    def __exit__(self, *exc):
        self.pipeline.SyntheticSource = self.real


def baseline_cli_runs(torch, tmp: str, card: str) -> None:
    """Each family through cli.train (one epoch) and its best_full.pt
    through cli.infer, with the launch counters around both, mult first;
    then tfn with --feature_dtype bfloat16. The runs share one synthetic
    store (``SharedSyntheticSources``)."""
    with SharedSyntheticSources():
        baseline_runs(torch, tmp, card)


def baseline_runs(torch, tmp: str, card: str) -> None:
    from sdumc_tpu_torch.cli import infer, train

    # mult's epoch holds about 35 GiB of the card: first, while the side work
    # beside phase 24 is still starting, and its cache emptied after each run
    # (with it last, the side work and this run together filled the card)
    order = sorted(BASELINES, key=lambda n: n != "mult")
    for name, dtype in [(n, "float32") for n in order] + [("tfn", "bfloat16")]:
        bf16 = dtype == "bfloat16"
        ck = os.path.join(tmp, name + ("_bf16" if bf16 else ""))
        argv = BASELINE_ARGV + ["--model", name, "--feature_dtype", dtype]
        reset_counts()
        t0 = time.perf_counter()
        result = train.main(argv + ["--checkpoint_dir", ck, "--save_root", ck])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        (h,) = result["history"]
        values = [h["train_loss"], h["train_mse_full"], h["train_mse_missing"],
                  h["eval_mse_full"], h["test"]["full"]["mae"], h["test"]["missing"]["mae"]]
        if not all(map(math.isfinite, values)):
            raise AssertionError(f"{name}: non-finite training log: {h}")
        out = infer.main(MAIN_ARGV + ["--model", name, "--feature_dtype", dtype,
                                      "--checkpoint", os.path.join(ck, "best_full.pt")])
        counts = read_counts()
        mae, best = out["full"]["mae"], result["best_full"]["mae"]
        print(f"baseline {name}{' (bf16 streams)' if bf16 else ''}: cli.train 1 epoch in "
              f"{seconds!r} s host clock (data generation included), train_loss="
              f"{h['train_loss']!r} test_mae_full={h['test']['full']['mae']!r} "
              f"test_mae_missing={h['test']['missing']['mae']!r}; best_full.pt through "
              f"cli.infer: test MAE {mae!r} (recorded {best!r}, rtol {CKPT_MAE_RTOL}); "
              f"launches of the port's kernels {counts} ({card})")
        if any(counts.values()):
            raise AssertionError(f"{name}: a baseline launched a kernel of the port: {counts}")
        if abs(mae - best) > CKPT_MAE_RTOL * abs(best):
            raise AssertionError(f"{name}: the best checkpoint does not reproduce its MAE")
        torch.cuda.empty_cache()


def baseline_parity(torch, cfg, batch, dims, card: str) -> None:
    """One train step (dual-view loss, backward, Adam) with dropout off from
    the same seeded weights, card against CPU, per BASELINE_PARITY; then the
    card's step with TF32 allowed, which the check must refuse."""
    import dataclasses

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.models import get_model
    from sdumc_tpu_torch.train.step import batch_to_device_dict

    for name, rows, rtol in BASELINE_PARITY:
        sub = head_rows(batch, rows)
        mcfg = dataclasses.replace(cfg.model, name=name, input_dims=dims, dropout=0.0,
                                   mctn_teacher_forcing=1.0)

        def run(dev):
            model = get_model(mcfg, torch.Generator().manual_seed(cfg.train.seed)).to(dev)
            metrics = make_step(torch, cfg, model)(batch_to_device_dict(sub, dev))
            return (metrics["loss"].item(),
                    {k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None})

        def worst_ratio(g_ref, g):
            if g_ref.keys() != g.keys():
                raise AssertionError(f"{name}: card and CPU steps give gradients to different "
                                     "parameters")
            return max(((g[k] - ref).abs().max().item()
                        / (rtol * ref.abs().max().item() + GRAD_ATOL), k)
                       for k, ref in g_ref.items())

        (loss_cpu, g_cpu), (loss_card, g_card) = run("cpu"), run(DEVICE)
        worst, worst_key = worst_ratio(g_cpu, g_card)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            loss_tf32, g_tf32 = run(DEVICE)
        finally:
            set_matmul_precision(cfg.model.matmul_precision)
        tf32_worst, tf32_key = worst_ratio(g_cpu, g_tf32)
        print(f"baseline {name}: one train step card vs CPU ({rows} rows, dropout off): loss "
              f"{loss_card!r} vs {loss_cpu!r} (rtol {STEP_LOSS_RTOL}); {len(g_cpu)} gradients, "
              f"worst max-abs-diff / ({rtol} max|grad| + {GRAD_ATOL}) = {worst!r} at "
              f"{worst_key} (must be <= 1); control with TF32 allowed (matmul and cuDNN): loss "
              f"{loss_tf32!r}, worst ratio {tf32_worst!r} at {tf32_key} (must be > 1) ({card})")
        if abs(loss_card - loss_cpu) > STEP_LOSS_RTOL * abs(loss_cpu) or worst > 1.0:
            raise AssertionError(f"{name}: card and CPU train steps disagree")
        if tf32_worst <= 1.0:
            raise AssertionError(f"{name}: the gradient check does not see TF32 in the step")


def baseline_timing(torch, cfg, batch, dims, card: str) -> dict:
    """A warm train step per family (live dropouts) on the card's copy of
    the first train batch: CUDA events over BASELINE_TIMED_STEPS steps, peak memory,
    then BASELINE_PROFILED_STEPS under torch.profiler: device time by the
    operator that launched it, the idle share, launches per step."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdumc_tpu_torch.models import get_model
    from sdumc_tpu_torch.train.step import batch_to_device_dict

    d = batch_to_device_dict(batch, DEVICE)
    summary = {}
    for name in BASELINES:
        mcfg = dataclasses.replace(cfg.model, name=name, input_dims=dims)
        model = get_model(mcfg, torch.Generator().manual_seed(cfg.train.seed)).to(DEVICE)
        step = make_step(torch, cfg, model)
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: step(d), iters=BASELINE_TIMED_STEPS, warmup=BASELINE_WARMUP)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(BASELINE_PROFILED_STEPS):
                step(d)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = sum(e.count for e in key_averages(prof)
                       if e.device_type == DeviceType.CPU and "LaunchKernel" in e.key)
        print(f"baseline {name}: warm train step {ms!r} ms (CUDA events, {BASELINE_TIMED_STEPS} "
              f"steps, "
              f"batch {batch.audio.shape[0]}, T = {batch.audio.shape[1]} / "
              f"{max(batch.text.shape[1], batch.feat4.shape[1])} / {batch.video.shape[1]}), "
              f"{launches / BASELINE_PROFILED_STEPS!r} kernel launches per step, peak device memory "
              f"{peak!r} GiB, {sum(p.numel() for p in model.parameters())} parameters")
        fams = print_op_families(prof, wall, f"{name}: {BASELINE_PROFILED_STEPS} profiled warm "
                                 f"step(s)", card, TRAIN_OP_FAMILIES)
        summary[name] = {"ms": ms, "device_ms": fams["busy_ms"] / BASELINE_PROFILED_STEPS,
                         "idle": 1 - fams["busy_ms"] / 1e3 / wall,
                         "launches": launches / BASELINE_PROFILED_STEPS, "peak_gib": peak}
        del model, step, prof
        torch.cuda.empty_cache()
    return summary


def baseline_phase(torch, tmp: str, card: str, quiet=lambda: None) -> dict:
    """Phase 24: the baseline zoo. Each of the ten families through
    ``cli.train --model NAME`` (one epoch) and ``cli.infer --model
    NAME --checkpoint best_full.pt``, with no kernel of the port launched;
    tfn once more with bf16 streams; one train step card vs CPU for tfn,
    mfn, mctn and mult with a refused TF32 control; then, once ``quiet()``
    returns (nothing else on the card), a timed and profiled warm step per
    family."""
    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.data.pipeline import get_loaders

    cfg = main_path_config()
    set_matmul_precision(cfg.model.matmul_precision)
    baseline_cli_runs(torch, os.path.join(tmp, "baselines"), card)
    train_ds, _, _ = get_loaders(cfg.data.dataset, cfg.data, cfg.paths, synthetic=True)
    batch = first_train_batch(cfg, train_ds)
    dims = tuple(train_ds.input_dims()[:3])
    baseline_parity(torch, cfg, batch, dims, card)
    quiet()
    reset_counts()
    summary = baseline_timing(torch, cfg, batch, dims, card)
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"the baseline steps launched a kernel of the port: {counts}")
    print(f"phase 24 summary ({card}): {json.dumps(summary)}")
    return summary


# ---------------------------------------------------------------- the other text families (phase 25)

# each checkpoint: (name, --family, layers kept at step 1 or None for all, on-disk dtype);
# its config.json and tokenizer layout below
TEXT_FAMILY_DIRS = (
    ("bert-base-uncased", "bert", None, "float32"),
    ("roberta-large", "bert", None, "bfloat16"),
    ("albert-base-v2", "albert", None, "float32"),
    ("deberta-large", "deberta", None, "bfloat16"),
    ("bloom-7b1", "bloom", 2, "bfloat16"),
    ("chatglm2-6b", "glm", 2, "bfloat16"),
)
TEXT_FAMILY_SPANS = {"bert-base-uncased": (1, -1), "roberta-large": (1, -1),
                     "albert-base-v2": (1, -1), "deberta-large": (1, -1), "bloom-7b1": (0, 0),
                     "chatglm2-6b": (2, 0)}
FULL_DEPTH_DECODERS = ("bloom-7b1", "chatglm2-6b")
# step 2 runs them at 4 of their 30 and 28 layers: the depth cut that holds the script's
# time (PERF.md section 6)
DECODER_LAYERS = 4
# a small precompiled charsmap for ALBERT's files (NFKC-style folds)
ALBERT_CHARSMAP = {"ｆ": "f", "ｕ": "u", "ｌ": "l", "ﬁ": "fi", "…": "...", "　": " ", "™": "TM"}
BLOOM_SPLIT = " ?[^(\\s|[.,!?…。，、।۔،])]+"


def text_family_config_files() -> dict:
    """Each checkpoint's config.json as published (bloom-7b1's and
    chatglm2-6b's layer counts are cut at step 1, in the directory only)."""
    return {
        "bert-base-uncased": {
            "architectures": ["BertForMaskedLM"], "model_type": "bert", "hidden_act": "gelu",
            "hidden_size": 768, "intermediate_size": 3072, "layer_norm_eps": 1e-12,
            "max_position_embeddings": 512, "num_attention_heads": 12, "num_hidden_layers": 12,
            "pad_token_id": 0, "type_vocab_size": 2, "vocab_size": 30522},
        "roberta-large": {
            "architectures": ["RobertaForMaskedLM"], "model_type": "roberta", "bos_token_id": 0,
            "eos_token_id": 2, "hidden_act": "gelu", "hidden_size": 1024,
            "intermediate_size": 4096, "layer_norm_eps": 1e-5, "max_position_embeddings": 514,
            "num_attention_heads": 16, "num_hidden_layers": 24, "pad_token_id": 1,
            "type_vocab_size": 1, "vocab_size": 50265},
        "albert-base-v2": {
            "architectures": ["AlbertForMaskedLM"], "model_type": "albert", "embedding_size": 128,
            "hidden_act": "gelu_new", "hidden_size": 768, "inner_group_num": 1,
            "intermediate_size": 3072, "layer_norm_eps": 1e-12, "max_position_embeddings": 512,
            "num_attention_heads": 12, "num_hidden_groups": 1, "num_hidden_layers": 12,
            "pad_token_id": 0, "type_vocab_size": 2, "vocab_size": 30000},
        "deberta-large": {
            "model_type": "deberta", "hidden_act": "gelu", "hidden_size": 1024,
            "intermediate_size": 4096, "max_position_embeddings": 512, "relative_attention": True,
            "pos_att_type": "c2p|p2c", "layer_norm_eps": 1e-7, "max_relative_positions": -1,
            "position_biased_input": False, "num_attention_heads": 16, "num_hidden_layers": 24,
            "type_vocab_size": 0, "vocab_size": 50265},
        "bloom-7b1": {
            "architectures": ["BloomForCausalLM"], "model_type": "bloom",
            "apply_residual_connection_post_layernorm": False, "bos_token_id": 1,
            "eos_token_id": 2, "hidden_size": 4096, "layer_norm_epsilon": 1e-5, "n_head": 32,
            "n_layer": 30, "offset_alibi": 100, "pad_token_id": 3, "unk_token_id": 0,
            "vocab_size": 250880},
        "chatglm2-6b": {
            "architectures": ["ChatGLMModel"], "model_type": "chatglm", "add_bias_linear": False,
            "add_qkv_bias": True, "apply_residual_connection_post_layernorm": False,
            "ffn_hidden_size": 13696, "hidden_size": 4096, "kv_channels": 128,
            "layernorm_epsilon": 1e-5, "multi_query_attention": True, "multi_query_group_num": 2,
            "num_attention_heads": 32, "num_layers": 28, "padded_vocab_size": 65024,
            "post_layer_norm": True, "rmsnorm": True, "seq_length": 32768,
            "torch_dtype": "float16", "eos_token_id": 2, "pad_token_id": 0},
    }


def _family_words():
    return list(dict.fromkeys(list(MOSEI_WORDS) + NON_ASCII.split()))


def _byte_bpe(specials, words):
    """A byte-level BPE vocabulary (the specials, the 256 byte characters,
    each word and ' ' + word built up left to right) and its merges."""
    from sdumc_tpu_torch.convert.hf_tokenizer import BYTE_CHARS

    vocab = {t: i for i, t in enumerate(specials)}
    for c in BYTE_CHARS.values():
        vocab.setdefault(c, len(vocab))
    merges = []
    for w in words:
        for variant in (w, " " + w):
            b = "".join(BYTE_CHARS[x] for x in variant.encode("utf-8"))
            for n in range(2, len(b) + 1):
                if b[:n] not in vocab:
                    vocab[b[:n]] = len(vocab)
                    merges.append((b[:n - 1], b[n - 1]))
    return vocab, merges


def added_token(i: int, content: str) -> dict:
    """One special entry of a tokenizer.json's added_tokens, every field
    written."""
    return {"id": i, "content": content, "single_word": False, "lstrip": False,
            "rstrip": False, "normalized": False, "special": True}


def _protobuf(fields) -> bytes:
    """A protobuf message of (field, value) pairs: int -> varint, float ->
    fixed32, bytes / str -> length-delimited."""
    def varint(v):
        out = bytearray()
        while True:
            out.append((v & 0x7F) | (0x80 if v > 0x7F else 0))
            v >>= 7
            if not v:
                return bytes(out)

    out = bytearray()
    for field, value in fields:
        if isinstance(value, bool) or isinstance(value, int):
            out += varint(field << 3) + varint(int(value))
        elif isinstance(value, float):
            out += varint(field << 3 | 5) + struct.pack("<f", value)
        else:
            value = value.encode("utf-8") if isinstance(value, str) else value
            out += varint(field << 3 | 2) + varint(len(value)) + value
    return bytes(out)


def write_family_tokenizer(path: str, name: str) -> None:
    """Each family's tokenizer files in its published layout, covering the
    transcripts' words: bert-base-uncased's vocab.txt (30522 lines,
    [unused] fillers), roberta-large's and deberta-large's vocab.json +
    merges.txt (byte-level BPE), albert-base-v2's tokenizer.json (Unigram,
    ALBERT's normalizers with a small precompiled charsmap), bloom-7b1's
    tokenizer.json (its Split regex, ByteLevel, BPE), chatglm2-6b's
    tokenizer.model (SentencePiece BPE with byte fallback, protobuf written
    by hand)."""
    from sdumc_tpu_torch.convert.hf_tokenizer import build_precompiled_charsmap

    words, space = _family_words(), "▁"

    def dump(fname, obj):
        with open(os.path.join(path, fname), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)

    if name == "bert-base-uncased":
        chars = sorted(set("".join(words)) | set("abcdefghijklmnopqrstuvwxyz0123456789.,!?'"))
        lines = (["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                                   "[MASK]"]
                 + list(dict.fromkeys(chars + ["##" + c for c in chars] + words)))
        lines += [f"[unused{i}]" for i in range(99, 99 + 30522 - len(lines))]
        with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        dump("tokenizer_config.json", {"tokenizer_class": "BertTokenizer", "do_lower_case": True})
    elif name in ("roberta-large", "deberta-large"):
        specials = (("<s>", "<pad>", "</s>", "<unk>") if name == "roberta-large"
                    else ("[PAD]", "[CLS]", "[SEP]", "[UNK]"))
        vocab, merges = _byte_bpe(specials, words)
        vocab["<mask>" if name == "roberta-large" else "[MASK]"] = 50264
        dump("vocab.json", vocab)
        with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
        dump("tokenizer_config.json", {"tokenizer_class": "RobertaTokenizer" if name ==
                                       "roberta-large" else "DebertaTokenizer"})
    elif name == "albert-base-v2":
        import base64

        pieces = [["<pad>", 0.0], ["<unk>", 0.0], ["[CLS]", 0.0], ["[SEP]", 0.0], ["[MASK]", 0.0],
                  [space, -2.0]]
        for i, w in enumerate(words):
            pieces.append([space + w, -3.0 - 0.01 * i])
        for c in sorted(set("".join(words)) | set("abcdefghijklmnopqrstuvwxyz0123456789")):
            pieces.append([c, -12.0])
        blob = build_precompiled_charsmap(ALBERT_CHARSMAP)
        cls, sep = ({"SpecialToken": {"id": t, "type_id": 0}} for t in ("[CLS]", "[SEP]"))
        template = {"single": [cls, {"Sequence": {"id": "A", "type_id": 0}}, sep],
                    "pair": [cls, {"Sequence": {"id": "A", "type_id": 0}}, sep,
                             {"Sequence": {"id": "B", "type_id": 1}}, sep],
                    "special_tokens": {"[CLS]": {"id": "[CLS]", "ids": [2], "tokens": ["[CLS]"]},
                                       "[SEP]": {"id": "[SEP]", "ids": [3], "tokens": ["[SEP]"]}}}
        dump("tokenizer.json", {
            "version": "1.0", "added_tokens": [
                added_token(i, t) for i, t in
                enumerate(("<pad>", "<unk>", "[CLS]", "[SEP]", "[MASK]"))],
            "normalizer": {"type": "Sequence", "normalizers": [
                {"type": "Replace", "pattern": {"String": "``"}, "content": '"'},
                {"type": "Replace", "pattern": {"String": "''"}, "content": '"'},
                {"type": "NFKD"}, {"type": "StripAccents"}, {"type": "Lowercase"},
                {"type": "Precompiled",
                 "precompiled_charsmap": base64.b64encode(blob).decode("ascii")},
                {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
            "pre_tokenizer": {"type": "Metaspace", "replacement": space,
                              "prepend_scheme": "always", "split": True},
            "post_processor": {"type": "TemplateProcessing", **template},
            "decoder": {"type": "Metaspace", "replacement": space, "prepend_scheme": "always",
                        "split": True},
            "model": {"type": "Unigram", "unk_id": 1, "vocab": pieces, "byte_fallback": False}})
        dump("tokenizer_config.json", {"tokenizer_class": "AlbertTokenizer"})
    elif name == "bloom-7b1":
        specials = ("<unk>", "<s>", "</s>", "<pad>")
        vocab, merges = _byte_bpe(specials, words)
        dump("tokenizer.json", {
            "version": "1.0", "added_tokens": [added_token(i, t) for i, t in enumerate(specials)],
            "normalizer": None,
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": BLOOM_SPLIT}, "behavior": "Isolated",
                 "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                 "use_regex": False}]},
            "post_processor": {"type": "ByteLevel", "add_prefix_space": True,
                               "trim_offsets": False, "use_regex": False},
            "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                        "use_regex": True},
            "model": {"type": "BPE", "dropout": None, "unk_token": None, "fuse_unk": False,
                      "byte_fallback": False, "vocab": vocab,
                      "merges": [[a, b] for a, b in merges]}})
        dump("tokenizer_config.json", {"tokenizer_class": "BloomTokenizerFast"})
    else:                                           # chatglm2-6b: SentencePiece BPE
        pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
        pieces += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
        seen = {p for p, _, _ in pieces}
        marked = [space + w for w in words]
        for c in sorted(set("".join(marked))):
            seen.add(c)
            pieces.append((c, -1000.0, 1))
        rank = 0
        for w in marked:
            for n in range(2, len(w) + 1):
                if w[:n] not in seen:
                    seen.add(w[:n])
                    pieces.append((w[:n], -float(rank), 1))
                    rank += 1
        proto = [(1, _protobuf([(1, p), (2, s), (3, t)])) for p, s, t in pieces]
        proto.append((2, _protobuf([(3, 2), (35, 1), (40, 0), (41, 1), (42, 2)])))
        proto.append((3, _protobuf([(1, "identity"), (3, 1), (4, 0), (5, 1)])))
        with open(os.path.join(path, "tokenizer.model"), "wb") as f:
            f.write(_protobuf(proto))
        dump("tokenizer_config.json", {"tokenizer_class": "ChatGLMTokenizer"})


def text_family_model(torch, name: str, layers=None):
    """(config, the port's model on the card) of checkpoint ``name``, built
    on the meta device (``layers`` kept) and seeded there: every weight
    normal(0, 0.02) from one generator, norms at scale 1 and bias 0."""
    import dataclasses

    from sdumc_tpu_torch.convert import hf_albert, hf_bert, hf_bloom, hf_deberta, hf_glm
    from sdumc_tpu_torch.models import albert, bert, bloom, deberta, glm

    family = next(f for n, f, _, _ in TEXT_FAMILY_DIRS if n == name)
    config_of, cls = {"bert": (hf_bert.config_from_hf, bert.BertModel),
                      "albert": (hf_albert.config_from_hf, albert.AlbertModel),
                      "deberta": (hf_deberta.config_from_hf, deberta.DebertaModel),
                      "bloom": (hf_bloom.config_from_hf, bloom.BloomModel),
                      "glm": (hf_glm.config_from_chatglm, glm.GlmModel)}[family]
    cfg = config_of(text_family_config_files()[name])
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    with torch.device("meta"):
        model = cls(cfg)
    model = model.to_empty(device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(25)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
        for m in model.modules():
            if isinstance(m, torch.nn.LayerNorm) or type(m).__name__ == "RMSNorm":
                m.weight.fill_(1.0)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
    return cfg, model.eval()


def write_family_dir(torch, root: str, name: str) -> str:
    """checkpoint ``name``'s directory at step 1's depth: config.json (the
    layer count cut for the decoders), its tokenizer files and its seeded
    weights in the published layout and dtype (bf16 for the large ones;
    chatglm2's THUDM names with the fused QKV and gate|up, the lm head
    included, in pytorch_model.bin)."""
    from sdumc_tpu_torch.convert import safetensors_io

    _, family, layers, dtype = next(d for d in TEXT_FAMILY_DIRS if d[0] == name)
    path = os.path.join(root, name)
    os.makedirs(path)
    raw = dict(text_family_config_files()[name])
    if layers:
        raw["n_layer" if family == "bloom" else "num_layers"] = layers
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(raw, f, indent=1)
    write_family_tokenizer(path, name)
    cfg, model = text_family_model(torch, name, layers)
    dt = getattr(torch, dtype)
    sd = {k: v.to(dt).cpu() for k, v in model.state_dict().items()}
    del model
    if family == "glm":
        out = {"transformer.embedding.word_embeddings.weight": sd["embed_tokens.weight"],
               "transformer.encoder.final_layernorm.weight": sd["norm.weight"],
               "transformer.output_layer.weight": sd["embed_tokens.weight"].clone()}
        for i in range(cfg.num_layers):
            src, dst = f"layers.{i}.", f"transformer.encoder.layers.{i}."
            for kind in ("weight", "bias"):
                out[dst + f"self_attention.query_key_value.{kind}"] = torch.cat(
                    [sd[src + f"self_attn.{p}_proj.{kind}"] for p in "qkv"])
            out[dst + "self_attention.dense.weight"] = sd[src + "self_attn.o_proj.weight"]
            out[dst + "mlp.dense_h_to_4h.weight"] = sd[src + "mlp.gate_up_proj.weight"]
            out[dst + "mlp.dense_4h_to_h.weight"] = sd[src + "mlp.down_proj.weight"]
            for ln in ("input_layernorm", "post_attention_layernorm"):
                out[dst + f"{ln}.weight"] = sd[src + f"{ln}.weight"]
        sd = out
    if name in ("roberta-large", "deberta-large", "chatglm2-6b"):
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    else:
        safetensors_io.save_file(sd, os.path.join(path, "model.safetensors"))
    torch.cuda.empty_cache()
    return path


def family_cli_run(torch, path: str, name: str, rows, csv_path: str, tmp: str):
    """Step 1 for one checkpoint: ``cli.extract text --family F`` with its
    defaults, every output checked; then one batch (the 16 shortest
    transcripts) card vs CPU at f32 with TF32 off. Returns the port's
    tokenizer."""
    import numpy as np

    from sdumc_tpu_torch.cli import extract
    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.convert.vocab_tokenizers import load_tokenizer
    from sdumc_tpu_torch.extract.text import LOADERS, extract_text_features, find_token_span

    _, family, layers, dtype = next(d for d in TEXT_FAMILY_DIRS if d[0] == name)
    tok = load_tokenizer(path)
    start, end = find_token_span(tok)
    if (start, end) != TEXT_FAMILY_SPANS[name]:
        raise AssertionError(f"{name}: probe span {(start, end)}, want {TEXT_FAMILY_SPANS[name]}")
    save_dir = os.path.join(tmp, f"text-{name}")
    reset_counts()
    out = extract.main(["text", "--family", family, "--model_dir", path, "--trans_path",
                        csv_path, "--save_dir", save_dir])
    torch.cuda.synchronize()
    counts = read_counts()
    hidden = text_family_config_files()[name]["hidden_size"]
    n_tok = {n: len(tok(s)["input_ids"]) if s.strip() else 0 for n, s in rows}
    for n, _ in rows:
        feat = np.load(os.path.join(save_dir, f"{n}.npy"))
        want = (n_tok[n] - start + end, hidden) if n_tok[n] else (1, hidden)
        if (feat.shape != want or feat.dtype != np.float32 or not np.isfinite(feat).all()
                or (not n_tok[n] and feat.any())):
            raise AssertionError(f"{name} {n}: {feat.shape} {feat.dtype} (want {want}) or "
                                 "non-finite")
    if any(counts.values()):
        raise AssertionError(f"{name}: the port's kernels launched {counts}")
    print(f"  {name} (--family {family}, {layers or 'all'} layers, {dtype} on disk, width "
          f"{hidden}): {out['rows']} transcripts, {sum(n_tok.values())} tokens (longest "
          f"{max(n_tok.values())}), span ({start}, {end}), {out['seconds']!r} s host clock "
          f"(weights loaded before it), {out['rows'] / out['seconds']!r} sentences/s; "
          f"launches {counts}")
    short = sorted((n_tok[n], s) for n, s in rows if n_tok[n])[:TEXT_BATCH]
    set_matmul_precision("highest")
    feats = {}
    for dev in ("cpu", DEVICE):
        _, model = LOADERS[family](path, device=dev)
        feats[dev] = extract_text_features(model, tok, [s for _, s in short])
        del model
        torch.cuda.empty_cache()
    err = max(float(np.abs(g - r).max()) for g, r in zip(feats[DEVICE], feats["cpu"]))
    top = max(float(np.abs(r).max()) for r in feats["cpu"])
    print(f"    one batch ({len(short)} transcripts of {short[0][0]}-{short[-1][0]} tokens), f32, "
          f"TF32 off, card vs CPU: max abs diff {err!r}, max |feature| {top!r} (tolerance "
          f"rtol={LLAMA_RTOL} atol={LLAMA_ATOL}: f32 reassociation)")
    if not all(np.allclose(g, r, rtol=LLAMA_RTOL, atol=LLAMA_ATOL)
               for g, r in zip(feats[DEVICE], feats["cpu"])):
        raise AssertionError(f"{name}: card and CPU disagree")
    return tok


def family_full_depth(torch, name: str, tok, rows) -> None:
    """Step 2 for one decoder: the trunk at DECODER_LAYERS of its published
    depth, f32, seeded on the card, through extract_text_features on the transcripts:
    sentences/s, one 16-row batch by CUDA events beside its bound, peak
    memory, device time by family of a profiled run."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.extract.text import BUCKETS, extract_text_features, run_batch

    set_matmul_precision("highest")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model = text_family_model(torch, name, DECODER_LAYERS)
    torch.cuda.synchronize()
    n_all = sum(p.numel() for p in model.parameters())
    body = [p for n, p in model.named_parameters()
            if not n.startswith(("word_embeddings.", "embed_tokens."))]
    n_body = sum(p.numel() for p in body)
    wbytes = sum(p.numel() * p.element_size() for p in body)
    published = text_family_config_files()[name]["num_layers" if name == "chatglm2-6b" else "n_layer"]
    print(f"  {name} at {cfg.num_layers} of its {published} layers (f32, {n_all} parameters, "
          f"{n_body} outside the embedding, {wbytes / 1e9!r} GB), seeded on the card in "
          f"{time.perf_counter() - t0!r} s")
    sents = [s for _, s in rows]
    with torch.inference_mode():
        extract_text_features(model, tok, sents)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = extract_text_features(model, tok, sents)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    if not all(np.isfinite(f).all() and f.shape[1] == cfg.hidden_size for f in feats):
        raise AssertionError(f"{name}: non-finite features or wrong width")
    print(f"    {len(sents)} transcripts in {seconds!r} s host clock (tokenizing included, warm), "
          f"{len(sents) / seconds!r} sentences/s")
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
        ms = time_ms(lambda: run_batch(model, ids, lengths, TEXT_TAPS[1]), iters=5, warmup=1)
    real = int(lengths.sum())
    ops_ms = 1e3 * 2 * n_body * real / PEAK_F32_FLOPS
    bytes_ms = 1e3 * wbytes / PEAK_HBM_BYTES
    bound = max(ops_ms, bytes_ms)
    padded_ms = 1e3 * 2 * n_body * TEXT_BATCH * bucket / PEAK_F32_FLOPS
    print(f"    one batch ({len(chunk)} transcripts in bucket {bucket}, {real} real of "
          f"{TEXT_BATCH * bucket} tokens, taps -4..-1): {ms!r} ms (CUDA events, 5 runs); bound "
          f"{bound!r} ms = max(2 x {n_body} x {real} flops at {PEAK_F32_FLOPS / 1e12:.0f} "
          f"TFLOP/s f32 = {ops_ms!r}, {wbytes / 1e9!r} GB at {PEAK_HBM_BYTES / 1e12} TB/s = "
          f"{bytes_ms!r}), {bound / ms:.1%} of it (the padded tokens' flops: {padded_ms!r} ms)")
    print(f"    peak device memory {torch.cuda.max_memory_allocated() / 2**30!r} GiB")
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extract_text_features(model, tok, sents)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_device_time(prof, wall, f"    profiled {name} extraction (taps -4..-1, warm)",
                      TEXT_FAMILIES, "elementwise, norms, rope / ALiBi, casts and the tap sum",
                      top=8)
    del model, feats
    torch.cuda.empty_cache()


def text_families_phase(torch, tmp: str, rows):
    """Phase 25: the other text families. Step 1: each checkpoint of
    TEXT_FAMILY_DIRS at its published width (the decoders at 2 layers) in
    its on-disk format through ``cli.extract text --family F`` on phase 13's
    transcripts, then one batch card vs CPU; step 2: bloom-7b1 and
    chatglm2-6b at DECODER_LAYERS, timed and profiled."""
    import csv
    import shutil

    csv_path = os.path.join(tmp, "family_transcripts.csv")
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(["name", "sentence"])
        writer.writerows(rows)
    root = os.path.join(tmp, "families")
    os.makedirs(root)
    toks = {}
    print("step 1: cli.extract text --family F with its defaults (FRAME, taps -4..-1, batch "
          f"{TEXT_BATCH}) on {len(rows)} transcripts, each checkpoint at its published width")
    for name, *_ in TEXT_FAMILY_DIRS:
        t0 = time.perf_counter()
        path = write_family_dir(torch, root, name)
        written = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        print(f"  {name}: directory written in {written!r} s ({size / 1e9!r} GB)")
        toks[name] = family_cli_run(torch, path, name, rows, csv_path, tmp)
        shutil.rmtree(path)
    print(f"step 2: the decoders at {DECODER_LAYERS} layers, f32, seeded on the card")
    for name in FULL_DEPTH_DECODERS:
        family_full_depth(torch, name, toks[name], rows)


# ---------------------------------------------------------------- serving (phase 26)

# cli.export's defaults (JAX's): the published input widths, batch 128, three combos
SERVE_DIMS = (1024, 4096, 1024, 4096)
SERVE_BATCH = 128
SERVE_COMBOS = ((64, 64, 64, 64), (256, 64, 256, 64), (512, 64, 512, 64))
# (label, lengths, rows): a partial batch for each combo, then a second request in
# the middle combo at other lengths; UNFIT_LENGTHS fits no combo
SERVE_REQUESTS = (("64 combo", (50, 40, 64, 30), 100),
                  ("256 combo", (200, 64, 180, 50), 100),
                  ("512 combo", (512, 60, 400, 64), 100),
                  ("256 combo, other lengths", (130, 20, 256, 9), 37))
UNFIT_LENGTHS = (600, 10, 10, 10)
SERVE_TIMED = 10
SERVE_FAMILIES = (
    ("fusion kernel", ("cross_partial", "cross_combine", "split_w")),
    ("cuBLAS GEMMs (frame and query projections, MLPs)",
     ("gemm", "nvjet", "cutlass", "sm80_xmma", "sm90_xmma")),
    ("memory copies (the request to the card, the answers back)", ("memcpy", "memset")),
)


def serve_request(i: int) -> dict:
    """Request i of SERVE_REQUESTS (numpy f32 streams [rows, T_m, D_m]), made
    from seed i in bulk; i = -1 is the request that fits no combo."""
    import numpy as np

    lens, rows = (UNFIT_LENGTHS, 2) if i < 0 else SERVE_REQUESTS[i][1:]
    rng = np.random.default_rng(100 + i)
    return {k: rng.standard_normal((rows, t, d), dtype=np.float32)
            for k, t, d in zip(("audio", "text", "video", "feat4"), lens, SERVE_DIMS)}


def served_kernel_vs_plain(torch, fused_cross, calls) -> list:
    """Each fusion-kernel launch of one served request (``calls``: the
    arguments ``fused_cross.launch`` got from the op and what it returned)
    held against its plain version on the same inputs, on the card:
    [{"q": Q, "shape": [B, T, D], "t_max": [...], "nsplit": n,
    "max_abs_err": e, "ok": allclose at KERNEL_RTOL / KERNEL_ATOL}]."""
    rows = []
    with torch.no_grad():
        for (q, x, weight, bias, t_max, scale), kw, got in calls:
            if kw["q_batched"]:
                ref = fused_cross.fused_cross_attention_plain(q, x, weight, bias, t_max, scale)
            else:
                ref = fused_cross.fused_attention_pool_plain(x, weight, bias, q[0], t_max,
                                                             scale)[:, None]
            B, T, _ = x.shape
            rows.append({"q": q.shape[-2], "shape": list(x.shape),
                         "t_max": (t_max.reshape(-1).tolist() if isinstance(t_max, torch.Tensor)
                                   else t_max),
                         "t_max_form": (f"{t_max.ndim}-d {t_max.dtype} on {t_max.device.type}"
                                        if isinstance(t_max, torch.Tensor) else type(t_max).__name__),
                         "nsplit": fused_cross._splits(x.device, B, T),
                         "max_abs_err": (got - ref).abs().max().item(),
                         "ok": bool(got.shape == ref.shape and torch.isfinite(got).all()
                                    and torch.allclose(got, ref, rtol=KERNEL_RTOL,
                                                       atol=KERNEL_ATOL))})
    return rows


def serve_worker(torch, bundle_dir: str, out_dir: str) -> None:
    """The serving process of phase 26: imports sdumc_tpu_torch.serve alone,
    loads the bundle, answers SERVE_REQUESTS with the launch counters around
    each and the unfittable one, times a warm request per combo (host clock,
    numpy to numpy; the padding and copy alone; CUDA events around the
    program alone), its peak memory and one profiled request. Writes
    answers.npz and report.json to `out_dir`."""
    import numpy as np

    from sdumc_tpu_torch.ops.kernels import fused_cross
    from sdumc_tpu_torch.serve import ServingBundle

    t0 = time.perf_counter()
    bundle = ServingBundle.load(bundle_dir)
    torch.cuda.synchronize()
    report = {"load_s": time.perf_counter() - t0, "requests": []}
    answers, batches = {}, []
    launch = fused_cross.launch
    for i, (label, lens, rows) in enumerate(SERVE_REQUESTS):
        batch = serve_request(i)
        batches.append(batch)
        calls = []

        def recorded(*a, **kw):   # the op's CUDA implementation looks launch up per call
            out = launch(*a, **kw)
            calls.append((a, kw, out))
            return out

        fused_cross.launch = recorded
        fused_cross.reset_launches()
        try:
            answers[f"full{i}"], answers[f"missing{i}"] = bundle(batch)
        finally:
            fused_cross.launch = launch
        report["requests"].append({"label": label, "combo": list(bundle._pick(lens)),
                                   "launches": dict(fused_cross.LAUNCHES),
                                   "launches_bf16": dict(fused_cross.LAUNCHES_BF16),
                                   "kernel_vs_plain": served_kernel_vs_plain(torch, fused_cross,
                                                                             calls)})
        del calls
    try:
        bundle(serve_request(-1))
        report["unfit"] = None
    except ValueError as e:
        report["unfit"] = str(e)
    torch.cuda.reset_peak_memory_stats()
    report["timing"] = []
    for i, batch in enumerate(batches[:len(SERVE_COMBOS)]):
        for _ in range(3):
            bundle(batch)
        host, pad = [], []
        for _ in range(SERVE_TIMED):
            t0 = time.perf_counter()
            bundle(batch)
            host.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            combo, inputs, _ = bundle.pad(batch)
            torch.cuda.synchronize()
            pad.append((time.perf_counter() - t0) * 1e3)
        program_ms = time_ms(lambda: bundle.run(combo, inputs), iters=SERVE_TIMED)
        nbytes = sum(x.nbytes for x in batch.values())
        report["timing"].append({"combo": list(combo), "rows": batch["audio"].shape[0],
                                 "request_bytes": nbytes,
                                 "host_ms": sorted(host)[len(host) // 2],
                                 "pad_copy_ms": sorted(pad)[len(pad) // 2],
                                 "program_ms": program_ms})
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bundle(batches[2])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report["profile"] = print_device_time(
        prof, wall, f"profiled served request ({SERVE_REQUESTS[2][0]}, warm, numpy to numpy)",
        SERVE_FAMILIES, "elementwise, softmax and the rest")
    report["profile_launches"] = sum(e.count for e in key_averages(prof)
                                     if e.device_type == DeviceType.CPU and "LaunchKernel" in e.key)
    report["models_imported"] = sorted(m for m in sys.modules
                                       if m.startswith("sdumc_tpu_torch.models"))
    np.savez(os.path.join(out_dir, "answers.npz"), **answers)
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f)


def serve_phase(torch, work: str, ckpt: str, card: str) -> dict:
    """Phase 26: ``python -m sdumc_tpu_torch.cli.export`` with its defaults on
    phase 7's best_full.pt; every program without weights or constants and
    with 6 fusion-op nodes; a fresh process (``serve_worker``) serves
    SERVE_REQUESTS from the bundle; every answer against make_eval_step on
    the same padded batch, the same checkpoint, on the card; the timings.
    Returns the launches of one served request, {query count: n}."""
    import numpy as np

    from sdumc_tpu_torch.cli.common import build_model, set_matmul_precision
    from sdumc_tpu_torch.core.config import ExperimentConfig
    from sdumc_tpu_torch.train.step import make_eval_step

    here = os.path.dirname(os.path.abspath(__file__))
    bundle_dir, out_dir = os.path.join(work, "bundle"), os.path.join(work, "served")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    proc = run_bounded([sys.executable, "-m", "sdumc_tpu_torch.cli.export", "--checkpoint",
                        ckpt, "--out_dir", bundle_dir], "cli.export", cwd=here)
    print(proc.stdout.rstrip())
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise RuntimeError("cli.export failed")
    sizes = {f: os.path.getsize(os.path.join(bundle_dir, f))
             for f in sorted(os.listdir(bundle_dir))}
    print(f"cli.export (defaults: dims {SERVE_DIMS}, batch {SERVE_BATCH}, combos "
          f"{SERVE_COMBOS}, the card): {time.perf_counter() - t0!r} s (process start, model "
          f"build and checkpoint load included); bundle {sum(sizes.values())!r} bytes: {sizes}")
    for name in sizes:
        if name.endswith(".pt2"):
            program = torch.export.load(os.path.join(bundle_dir, name))
            ops = sum(n.target is torch.ops.sdumc.fused_cross.default for n in program.graph.nodes)
            if len(program.state_dict) or len(program.constants) or ops != 6:
                raise AssertionError(f"{name}: {len(program.state_dict)} weights, "
                                     f"{len(program.constants)} constants, {ops} fusion-op nodes "
                                     "(expected 0, 0, 6)")
    print("every program: 0 weights, 0 constants, 6 sdumc::fused_cross nodes")

    t0 = time.perf_counter()
    proc = run_bounded([sys.executable, os.path.abspath(__file__), "--serve", bundle_dir,
                        "--serve-out", out_dir], "serve", cwd=here)
    print(proc.stdout.rstrip())
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise RuntimeError("the serving process failed")
    with open(os.path.join(out_dir, "report.json")) as f:
        report = json.load(f)
    answers = np.load(os.path.join(out_dir, "answers.npz"))
    print(f"served from a fresh process: {time.perf_counter() - t0!r} s, bundle load "
          f"{report['load_s']!r} s; sdumc_tpu_torch.models modules imported there: "
          f"{report['models_imported']}")
    if report["models_imported"]:
        raise AssertionError("the serving process imported model code")
    if not report["unfit"] or "bucket" not in report["unfit"]:
        raise AssertionError(f"lengths {UNFIT_LENGTHS} did not raise ValueError: {report['unfit']}")
    print(f"lengths {UNFIT_LENGTHS}: ValueError({report['unfit']!r})")

    set_matmul_precision("highest")
    model = build_model(ExperimentConfig(), SERVE_DIMS, torch.device("cuda"), ckpt)
    eval_step = make_eval_step(model)
    eager_ms = {}
    worst = 0.0
    for i, ((label, lens, rows), req) in enumerate(zip(SERVE_REQUESTS, report["requests"])):
        if req["launches"] != {"1": 3, "7": 3} or any(req["launches_bf16"].values()):
            raise AssertionError(f"{label}: launches {req['launches']} (bf16 "
                                 f"{req['launches_bf16']}), expected 3 + 3 f32 and no bf16")
        batch, combo = serve_request(i), tuple(req["combo"])
        d = {}
        for k, t_b in zip(("audio", "text", "video", "feat4"), combo):
            x = batch[k]
            padded = np.zeros((SERVE_BATCH, t_b, x.shape[2]), np.float32)
            padded[:rows, : x.shape[1]] = x
            d[k] = torch.from_numpy(padded).cuda()
        d["t_max"] = lens
        v0, v1 = (v[:rows].cpu() for v in eval_step(d))
        if i < len(SERVE_COMBOS):
            eager_ms[combo] = time_ms(lambda: eval_step(d), iters=SERVE_TIMED)
        for view, ref, got in (("full", v0, answers[f"full{i}"]),
                               ("missing", v1, answers[f"missing{i}"])):
            got = torch.from_numpy(got)
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{label} {view}: shape {tuple(got.shape)} or non-finite")
            err = (got - ref).abs().max().item()
            worst = max(worst, err)
            if not torch.allclose(got, ref, rtol=MODEL_RTOL, atol=MODEL_ATOL):
                raise AssertionError(f"{label} {view}: served and eager disagree by {err!r}")
        print(f"  {label}: {rows} rows, lengths {lens} -> combo {combo}; launches "
              f"{req['launches']} (bf16 none)")
        del d
    print(f"served vs eager make_eval_step on the card (same checkpoint, same padded batch): "
          f"largest abs diff {worst!r} (tolerance rtol={MODEL_RTOL} atol={MODEL_ATOL})")
    print(f"each fusion-kernel launch of each served request vs its plain version on the same "
          f"inputs, on the card (tolerance rtol={KERNEL_RTOL} atol={KERNEL_ATOL}):")
    worst_kernel = 0.0
    for (label, _, _), req in zip(SERVE_REQUESTS, report["requests"]):
        calls = req["kernel_vs_plain"]
        if len(calls) != 6:
            raise AssertionError(f"{label}: {len(calls)} fusion-kernel launches recorded, not 6")
        for c in calls:
            worst_kernel = max(worst_kernel, c["max_abs_err"])
            print(f"  {label}: Q={c['q']} x {c['shape']}, t_max {c['t_max_form']} "
                  f"{c['t_max'][:1] if isinstance(c['t_max'], list) else c['t_max']}, "
                  f"{c['nsplit']} blocks per row: max abs err {c['max_abs_err']!r}")
            if not c["ok"]:
                raise AssertionError(f"{label}: the fusion kernel (Q={c['q']}, x {c['shape']}) "
                                     f"disagrees with its plain version by {c['max_abs_err']!r}")
    print(f"served fusion kernel vs plain: largest abs err {worst_kernel!r}")
    print(f"warm served requests ({card}; medians of {SERVE_TIMED}; host clock numpy to numpy, "
          "the padding and copy alone, CUDA events around the program alone, beside CUDA events "
          "around the eager make_eval_step on the same padded batch on the card):")
    for t in report["timing"]:
        combo = tuple(t["combo"])
        print(f"  {'x'.join(map(str, combo))}: {t['rows']} rows ({t['request_bytes']!r} request "
              f"bytes): served {t['host_ms']!r} ms, padding and copy {t['pad_copy_ms']!r} ms, "
              f"program {t['program_ms']!r} ms, eager {eager_ms[combo]!r} ms")
    print(f"serving process peak device memory {report['peak_gib']!r} GiB; the profiled request: "
          f"{report['profile_launches']} kernel launches")
    return {int(q): n for q, n in report["requests"][0]["launches"].items()}


# ---------------------------------------------------------------- decode serving (phase 27)

# cli.export --decode's buckets, at the feat4 CLI's gen_batch and token count
DECODE_BUCKETS = (64, 128, 256)
# (bucket, real prompt lengths): a chunk in each bucket, the 128 one partial
DECODE_REQUESTS = ((64, (41, 57, 64, 33)), (128, (100, 77, 128)), (256, (200, 129, 256, 180)))
DECODE_UNFIT = 300
DECODE_TIMED_BUCKET = 256
# A served bf16 answer is held to the engine's functions run eagerly on the served
# arithmetic (``served_path_eager``: the step index a 0-d tensor, the generated cache
# read whole, masked, and reordered whole): the same ops on the same card, so equal to
# the bit is expected; phase 11's bf16 tolerance (a few bf16 ulps of a tap) bounds it.
# Against the eager engine's sliced read the f32 attention sums differ in order, and
# bf16 logits tie exactly (the gap between the 4th and 5th candidate is often 0.0 on
# seeded weights), so a flipped rounding can pick another beam: that comparison is
# held at f32 (an f32 bundle, phase 10's tolerance) and printed at bf16.
DECODE_RTOL, DECODE_ATOL = BF16_RTOL, BF16_ATOL
DECODE_PROFILED_STEPS = 8


def decode_prompts(bucket_lens, hidden: int):
    """A chunk's prompts, [P_i, hidden] f32 numpy, made from a seed per
    chunk in bulk (0.5 x normal, as phase 10's)."""
    import numpy as np

    bucket, lens = bucket_lens
    rng = np.random.default_rng(270 + bucket)
    return [(0.5 * rng.standard_normal((n, hidden), dtype=np.float32)) for n in lens]


def served_step_ms(torch, bundle, prompts) -> tuple:
    """(ms per decode step of a served chunk by CUDA events, its outputs on
    the card): ``bundle.run`` on the padded chunk minus its prefill program
    alone, over the step calls (max_new - 1: seeded weights never emit
    EOS, so no check ends the loop early)."""
    bucket, pe, pl = bundle.pad(prompts)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    prog = bundle._modules[bucket]
    with torch.inference_mode():
        state = prog["prefill"](bundle._params, pe, pl)             # warm: every shape once
        prog["step"](bundle._params, state, pl, bundle._its[0])
        prog["finalize"]({k: v for k, v in state.items() if k != "caches"})
        del state
        torch.cuda.synchronize()
        ev[0].record()
        prog["prefill"](bundle._params, pe, pl)
        ev[1].record()
        ev[2].record()
        out = bundle.run(bucket, pe, pl)
        ev[3].record()
    torch.cuda.synchronize()
    if int(out["n_steps"].max()) != bundle.max_new:
        raise AssertionError(f"served chunk stopped at {out['n_steps'].tolist()} steps")
    return (ev[2].elapsed_time(ev[3]) - ev[0].elapsed_time(ev[1])) / (bundle.max_new - 1), out


def decode_serve_worker(torch, bundle_dir: str, out_dir: str) -> None:
    """The serving process of phase 27: imports sdumc_tpu_torch.serve alone,
    loads the decode bundle, answers DECODE_REQUESTS with the launch
    counters around them and a prompt that fits no bucket, times each
    chunk's steps (``served_step_ms``). Writes answers.npz and report.json
    to `out_dir`."""
    import numpy as np

    from sdumc_tpu_torch.serve import DecodeBundle

    t0 = time.perf_counter()
    bundle = DecodeBundle.load(bundle_dir)
    torch.cuda.synchronize()
    report = {"load_s": time.perf_counter() - t0, "chunks": []}
    answers = {}
    torch.cuda.reset_peak_memory_stats()
    for req in DECODE_REQUESTS:
        prompts = decode_prompts(req, bundle.hidden_size)
        reset_counts()
        t0 = time.perf_counter()
        out = bundle(prompts)
        seconds = time.perf_counter() - t0
        counts = read_counts()
        for k, v in out.items():
            answers[f"{k}{req[0]}"] = v
        step_ms, _ = served_step_ms(torch, bundle, prompts)
        report["chunks"].append({"bucket": bundle.pad(prompts)[0], "clips": len(prompts),
                                 "seconds": seconds, "step_ms": step_ms, "launches": counts})
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    try:
        bundle([np.zeros((DECODE_UNFIT, bundle.hidden_size), np.float32)])
        report["unfit"] = None
    except ValueError as e:
        report["unfit"] = str(e)
    report["models_imported"] = sorted(m for m in sys.modules
                                       if m.startswith("sdumc_tpu_torch.models"))
    np.savez(os.path.join(out_dir, "answers.npz"), **answers)
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f)


def eager_padded(torch, bucket_lens, hidden: int):
    """The chunk as DecodeBundle.pad makes it, on the card: (prompts [C, P,
    D] left-padded, zero rows at length 1 up to GEN_BATCH, prompt_len)."""
    bucket, lens = bucket_lens
    pe = torch.zeros(GEN_BATCH, bucket, hidden)
    pl = torch.ones(GEN_BATCH, dtype=torch.int64)
    for i, p in enumerate(decode_prompts(bucket_lens, hidden)):
        pe[i, bucket - len(p):] = torch.from_numpy(p)
        pl[i] = len(p)
    return pe.to(DEVICE), pl.to(DEVICE)


def hold_served(torch, label, got, ref, n, gap=None, rtol=DECODE_RTOL, atol=DECODE_ATOL
                ) -> float:
    """Served outputs (numpy, n clips) against an eager run's (card
    tensors): tokens and step counts equal, taps to rtol / atol. Returns
    the taps' max abs diff."""
    same = all(torch.equal(torch.from_numpy(got[k]), ref[k][:n].cpu())
               for k in ("tokens", "n_tokens", "n_steps"))
    taps = torch.from_numpy(got["taps"])
    ref_taps = ref["taps"][:n].float().cpu()
    err = (taps - ref_taps).abs().max().item()
    print(f"  {label}: tokens and step counts equal {same}, taps max abs diff {err!r} (max "
          f"|tap| {ref_taps.abs().max().item()!r})"
          + ("" if gap is None else f"; eager's smallest gap between the {BEAMS}th and "
             f"{BEAMS + 1}th candidate score {gap[:n].tolist()}"))
    if not same or not torch.isfinite(taps).all() or not torch.allclose(
            taps, ref_taps, rtol=rtol, atol=atol):
        raise AssertionError(f"{label}: served and eager decodes disagree")
    return err


def served_path_eager(torch, model, cfg, pe, pl, max_new, timing=None):
    """(outputs, gap): ``beam_prefill`` / ``beam_step`` / ``beam_finalize``
    run eagerly as the bundle's programs run them: each step's index a 0-d
    tensor, so the generated cache is read whole with the unwritten slots
    masked and reordered whole; ``done`` read every 8 steps. `timing`, if a
    dict, receives ``step_ms``: the steps and the finalize by CUDA events,
    over max_new - 1 (as ``served_step_ms`` counts)."""
    from sdumc_tpu_torch.models.generation import beam_finalize, beam_prefill, beam_step
    from sdumc_tpu_torch.models.llama import SplitCache

    its = torch.arange(max(max_new - 1, 1), device=pe.device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.inference_mode():
        state = beam_prefill(model, pe, cfg, prompt_len=pl, num_beams=BEAMS,
                             max_new_tokens=max_new, eos_id=2, trace=True)
        flat = state["caches"].tensors()
        ev[0].record()
        for it in range(max_new - 1):
            if it and it % 8 == 0 and not bool(live.any()):
                break
            state["caches"] = SplitCache.from_tensors(flat, its[it])
            live = beam_step(model, state, its[it], embed_fn=model.model.embed_tokens, eos_id=2)
        out = beam_finalize(state)
        ev[1].record()
    if timing is not None:
        torch.cuda.synchronize()
        timing["step_ms"] = ev[0].elapsed_time(ev[1]) / max(max_new - 1, 1)
    return out, state["gap"]


def print_sliced(torch, label, got, ref, n, gap) -> None:
    """Served outputs against the eager engine's sliced decode, printed, not
    held: whether the best hypotheses' tokens agree, the first column where
    they part, and eager's smallest candidate gap."""
    tokens = torch.from_numpy(got["tokens"])
    ref_tokens = ref["tokens"][:n].cpu()
    parted = [int((a != b).nonzero()[0]) if not torch.equal(a, b) else None
              for a, b in zip(tokens, ref_tokens)]
    print(f"  {label}, against the eager engine's sliced read: tokens equal "
          f"{torch.equal(tokens, ref_tokens)} (first differing column per clip {parted}); "
          f"eager's smallest gap between the {BEAMS}th and {BEAMS + 1}th candidate score "
          f"{gap[:n].tolist()}")


def decode_serve_phase(torch, work: str, llm_dir: str, card: str) -> None:
    """Phase 27: ``python -m sdumc_tpu_torch.cli.export --decode`` on phase
    11's 2-layer Vicuna (bf16, DECODE_BUCKETS, --gen_batch 4, 200 new
    tokens): export time and bytes; a fresh process (``decode_serve_worker``)
    serves a chunk per bucket, each held to the eager engine on the same
    padded prompts, the bucket-256 chunk's ms per step beside eager's; 32-step
    int8 / w8a8 / int8-KV bundles built in-process, each against its eager
    decode; then Vicuna-7B at VICUNA_LAYERS (phase 12's seed, on the card): one
    bucket built in-process, its ms per step beside eager's and the bound,
    and a profiled window of served steps."""
    import dataclasses

    import numpy as np

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.convert.hf_llama import load_hf_llama
    from sdumc_tpu_torch.models.llama import LlamaForCausalLM, init_weights, model_from_state_dict
    from sdumc_tpu_torch.ops.quant import quantize_params
    from sdumc_tpu_torch.serve import DecodeBundle

    here = os.path.dirname(os.path.abspath(__file__))
    bundle_dir, out_dir = os.path.join(work, "decode_bundle"), os.path.join(work, "decode_served")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    proc = run_bounded([sys.executable, "-m", "sdumc_tpu_torch.cli.export", "--decode",
                        "--llm_dir", llm_dir, "--out_dir", bundle_dir, "--prompt_buckets",
                        ",".join(map(str, DECODE_BUCKETS)), "--gen_batch", str(GEN_BATCH),
                        "--max_new_tokens", str(MAX_NEW)], "cli.export --decode", cwd=here)
    print(proc.stdout.rstrip())
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise RuntimeError("cli.export --decode failed")
    sizes = {f: os.path.getsize(os.path.join(bundle_dir, f))
             for f in sorted(os.listdir(bundle_dir))}
    print(f"cli.export --decode ({CLI_LAYERS}-layer Vicuna-7B-v1.5 widths, bf16, buckets "
          f"{DECODE_BUCKETS}, --gen_batch {GEN_BATCH}, {MAX_NEW} new tokens, the card; {card}): "
          f"{time.perf_counter() - t0!r} s (process start and the checkpoint's load included); "
          f"bundle {sum(sizes.values())!r} bytes, params.safetensors "
          f"{sizes['params.safetensors']!r}: {sizes}")

    t0 = time.perf_counter()
    proc = run_bounded([sys.executable, os.path.abspath(__file__), "--serve-decode",
                        bundle_dir, "--serve-out", out_dir], "serve --decode", cwd=here)
    print(proc.stdout.rstrip())
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise RuntimeError("the decode serving process failed")
    with open(os.path.join(out_dir, "report.json")) as f:
        report = json.load(f)
    answers = np.load(os.path.join(out_dir, "answers.npz"))
    print(f"served from a fresh process: {time.perf_counter() - t0!r} s, bundle load "
          f"{report['load_s']!r} s, peak device memory {report['peak_gib']!r} GiB; "
          f"sdumc_tpu_torch.models modules imported there: {report['models_imported']}")
    if report["models_imported"]:
        raise AssertionError("the decode serving process imported model code")
    if not report["unfit"] or "bucket" not in report["unfit"]:
        raise AssertionError(f"a {DECODE_UNFIT}-long prompt did not raise: {report['unfit']}")
    print(f"a {DECODE_UNFIT}-long prompt: ValueError({report['unfit']!r})")

    set_matmul_precision("highest")
    cfg, model = load_hf_llama(llm_dir, device=DEVICE)
    print(f"served vs the engine run eagerly on the served arithmetic (served_path_eager), "
          f"the same padded chunk and checkpoint, on the card (tolerance rtol={DECODE_RTOL} "
          f"atol={DECODE_ATOL}):")
    eager_ms = None
    for req, chunk in zip(DECODE_REQUESTS, report["chunks"]):
        if any(chunk["launches"].values()):
            raise AssertionError(f"bucket {req[0]}: kernels of the port launched {chunk}")
        pe, pl = eager_padded(torch, req, cfg.hidden_size)
        got = {k: answers[f"{k}{req[0]}"] for k in ("tokens", "n_tokens", "taps", "n_steps")}
        label = (f"bucket {req[0]} ({len(req[1])} clips, lengths {req[1]}, "
                 f"{chunk['seconds']!r} s served, launches {chunk['launches']})")
        hold_served(torch, label, got, served_path_eager(torch, model, cfg, pe, pl, MAX_NEW)[0],
                    len(req[1]))
        trace = {}
        if req[0] == DECODE_TIMED_BUCKET:
            eager_ms, ref = time_decode(torch, model, cfg, pe, pl, MAX_NEW, trace=trace)
        else:
            ref = beam_chunk(torch, model, cfg, pe, pl, MAX_NEW, trace=trace)
        print_sliced(torch, f"bucket {req[0]}", got, ref, len(req[1]), trace["gap"])
    print(f"  ms per decode step ({card}; CUDA events, {MAX_NEW - 1} steps): served "
          + ", ".join(f"bucket {c['bucket']} {c['step_ms']!r}" for c in report["chunks"])
          + f"; eager bucket {DECODE_TIMED_BUCKET} {eager_ms!r}")

    # the quantized bundles: built in-process, one bucket, QUANT_STEPS tokens
    req = DECODE_REQUESTS[0]
    prompts = decode_prompts(req, cfg.hidden_size)
    pe, pl = eager_padded(torch, req, cfg.hidden_size)
    for quant, kv_quant in (("int8", None), ("w8a8", None), (None, "int8")):
        qcfg = dataclasses.replace(cfg, quant=quant, kv_quant=kv_quant)
        sd = dict(model.state_dict())
        qmodel = model_from_state_dict(qcfg, quantize_params(sd, quant) if quant else sd)
        t0 = time.perf_counter()
        qbundle = DecodeBundle.build(qmodel, buckets=(req[0],), gen_batch=GEN_BATCH,
                                     max_new_tokens=QUANT_STEPS)
        seconds = time.perf_counter() - t0
        got = qbundle(prompts)
        ref, _ = served_path_eager(torch, qmodel, qcfg, pe, pl, QUANT_STEPS)
        hold_served(torch, f"--quant {quant} --kv_quant {kv_quant}, bucket {req[0]}, "
                    f"{QUANT_STEPS} steps (built in {seconds!r} s)", got, ref, len(req[1]))
        del qbundle, qmodel, sd
    del model
    torch.cuda.empty_cache()

    # f32 (TF32 off): the served masked read against the eager engine's sliced one
    cfg32, model32 = load_hf_llama(llm_dir, device=DEVICE, dtype=torch.float32)
    bundle32 = DecodeBundle.build(model32, buckets=(req[0],), gen_batch=GEN_BATCH,
                                  max_new_tokens=PARITY_STEPS)
    trace = {}
    ref = beam_chunk(torch, model32, cfg32, pe, pl, PARITY_STEPS, trace=trace)
    print(f"f32 bundle (bucket {req[0]}, {PARITY_STEPS} steps) against the eager engine "
          f"(tolerance rtol={LLAMA_RTOL} atol={LLAMA_ATOL}, phase 10's):")
    hold_served(torch, "served vs eager beam_generate_batched", bundle32(prompts), ref,
                len(req[1]), trace["gap"], rtol=LLAMA_RTOL, atol=LLAMA_ATOL)
    del bundle32, model32
    torch.cuda.empty_cache()

    # phase 12's seeded model, one bucket built in-process, nothing saved
    cfg = feat4_config(torch, VICUNA_LAYERS)
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    t0 = time.perf_counter()
    model = init_weights(model.to_empty(device=DEVICE), seed=3).eval()
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    wbytes = weight_bytes(model)
    req = next(r for r in DECODE_REQUESTS if r[0] == DECODE_TIMED_BUCKET)
    t0 = time.perf_counter()
    bundle = DecodeBundle.build(model, buckets=(req[0],), gen_batch=GEN_BATCH,
                                max_new_tokens=MAX_NEW)
    export_s = time.perf_counter() - t0
    prompts = decode_prompts(req, cfg.hidden_size)
    served_ms, got = served_step_ms(torch, bundle, prompts)
    got = {k: v[:len(prompts)].cpu().numpy() for k, v in got.items()}
    pe, pl = eager_padded(torch, req, cfg.hidden_size)
    trace = {}
    eager_ms, ref = time_decode(torch, model, cfg, pe, pl, MAX_NEW, trace=trace)
    bound = decode_bound_ms(cfg, wbytes, GEN_BATCH, req[0], MAX_NEW)
    print(f"{cfg.num_layers} of {VICUNA_FULL_LAYERS} layers (bf16, seed 3 as phase 12, seeded on the card in "
          f"{seed_s!r} s), bucket {req[0]} built in-process in {export_s!r} s (3 programs):")
    if got["taps"].shape != (len(prompts), MAX_NEW, cfg.hidden_size) or not np.isfinite(
            got["taps"]).all():
        raise AssertionError(f"{cfg.num_layers} layers: served taps {got['taps'].shape} or non-finite")
    timing = {}
    hold_served(torch, f"served vs served_path_eager, {len(prompts)} clips, {MAX_NEW} new "
                f"tokens", got, served_path_eager(torch, model, cfg, pe, pl, MAX_NEW,
                                                  timing=timing)[0], len(prompts))
    print_sliced(torch, f"{len(prompts)} clips, {MAX_NEW} new tokens", got, ref, len(prompts),
                 trace["gap"])
    print(f"  ms per decode step ({card}; CUDA events, {MAX_NEW - 1} steps): served "
          f"{served_ms!r}, served_path_eager {timing['step_ms']!r} (the eager step on a 0-d "
          f"tensor index), eager {eager_ms!r} (served / eager {served_ms / eager_ms!r}); bound "
          f"{bound!r} ms ({wbytes / 1e9!r} GB of weights + the KV cache at "
          f"{PEAK_HBM_BYTES / 1e12} TB/s; the served step reads the generated cache whole: "
          f"{decode_bound_ms(cfg, wbytes, GEN_BATCH, req[0], 2 * MAX_NEW - 1)!r} ms)")
    profile_served_steps(torch, bundle, prompts)
    del bundle, model
    torch.cuda.empty_cache()


def profile_served_steps(torch, bundle, prompts, first: int = PROFILE_FROM,
                         steps: int = DECODE_PROFILED_STEPS) -> None:
    """Device time by family, host launches and the idle share of served
    step calls first .. first+steps-1 under torch.profiler (the prefill and
    the earlier steps run before it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bucket, pe, pl = bundle.pad(prompts)
    prog = bundle._modules[bucket]
    with torch.inference_mode():
        state = prog["prefill"](bundle._params, pe, pl)
        for it in range(first):
            prog["step"](bundle._params, state, pl, bundle._its[it])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for it in range(first, first + steps):
                prog["step"](bundle._params, state, pl, bundle._its[it])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    launches = sum(e.count for e in key_averages(prof)
                   if e.device_type == DeviceType.CPU and "LaunchKernel" in e.key)
    fams = print_device_time(prof, wall, f"profiled served steps {first}-{first + steps - 1} "
                             f"(the step program, bucket {bucket})", DECODE_FAMILIES,
                             "elementwise and reductions (norms, rope, casts, attention math)",
                             top=10)
    print(f"  per step: device {sum(fams.values()) / steps!r} ms, {launches / steps!r} host "
          f"kernel launches, host clock {wall * 1e3 / steps!r} ms")


# ---------------------------------------------------------------- data parallel (phase 28)

DP_WORLD = 2                 # two ranks on the one card, over gloo
DP_ARGV = MAIN_ARGV + ["--epochs", "1", "--multihost"]
DP_METRIC_ATOL = 0.05        # JAX's bound against a single process (tests/test_multihost.py:119-121)
DP_TIMED = 10
# (c): the baseline families whose model_loss couples the batch's rows
BDP_FAMILIES = ("misa", "mmim", "mfm", "mctn")
BDP_DRAWS = dict(mfm_mmd_w=1.0, mctn_teacher_forcing=0.5)   # live batch-wide draws
BDP_CLI_MODEL = "mfm"        # the family with the most batch-coupled terms
BDP_TIMED, BDP_WARMUP = 3, 1  # phase 24's BASELINE_TIMED_STEPS and BASELINE_WARMUP


def fresh_fusion_state(torch, cfg, dims):
    """The fusion net at the input widths `dims` from the seeded weights,
    dropout off, on the card, and its train state."""
    import dataclasses

    from sdumc_tpu_torch.models import get_model
    from sdumc_tpu_torch.train.state import create_train_state

    mcfg = dataclasses.replace(cfg.model, input_dims=dims[:3], dropout=0.0, attn_dropout=0.0)
    model = get_model(mcfg, torch.Generator().manual_seed(cfg.train.seed)).to(DEVICE)
    return create_train_state(model, cfg.train, 8)


def dropout_off_step(torch, cfg, dims, d, axis=None, local_loss: bool = False):
    """One train step from the seeded weights with dropout off on the card's
    batch dict `d` (a rank's rows under `axis`); returns (model, step, loss,
    {name: gradient on the CPU}). ``local_loss``: the control, the rank's
    own loss with the gradients averaged over the ranks."""
    from sdumc_tpu_torch.parallel import reduce_gradients
    from sdumc_tpu_torch.train.step import dual_view_loss, make_train_step

    state = fresh_fusion_state(torch, cfg, dims)
    model = state.model
    step = make_train_step(state, cfg.loss, cfg.train.seed, axis)
    if local_loss:
        model.train()
        loss, _ = dual_view_loss(model, d, cfg.loss)
        loss.backward()
        reduce_gradients(model.parameters(), axis)
        for p in model.parameters():
            if p.grad is not None:
                p.grad /= axis.world
        loss = loss.item()
    else:
        loss = step(d)["loss"].item()
    return model, step, loss, grads_of(model)


def grads_of(model) -> dict:
    """{name: gradient on the CPU} of the parameters that have one."""
    return {k: p.grad.detach().cpu() for k, p in model.named_parameters() if p.grad is not None}


def worst_grad_ratio(g: dict, ref: dict) -> tuple:
    """(the largest max-abs-diff / (GRAD_RTOL max|ref| + GRAD_ATOL) over the
    parameters, its parameter): phase 8's ratio of a step's gradients `g`
    against the single-process step's `ref` ({name: tensor} each)."""
    if g.keys() != ref.keys():
        raise AssertionError("DP and single-process steps give gradients to different "
                             "parameters")
    return max(((g[k] - r).abs().max().item() / (GRAD_RTOL * r.abs().max().item() + GRAD_ATOL),
                k) for k, r in ref.items())


def bdp_model(torch, cfg, dims, name: str, dropout_off: bool):
    """Family `name` at ModelConfig's widths from the seeded weights, with
    BDP_DRAWS, on the card."""
    import dataclasses

    from sdumc_tpu_torch.models import get_model

    mcfg = dataclasses.replace(cfg.model, name=name, input_dims=dims, **BDP_DRAWS,
                               **(dict(dropout=0.0) if dropout_off else {}))
    return get_model(mcfg, torch.Generator().manual_seed(cfg.train.seed)).to(DEVICE)


def own_rows_control(model, world: int) -> None:
    """The control of (c): mctn's teacher-forcing mask from each rank's own
    stream (its terms are means over rows), the others' model_loss each
    rank's own (of its rows, with its own prior samples) averaged over the
    ranks."""
    if model.cfg.name == "mctn":
        model.teacher.generator = model.drop.generator
        return
    whole = model.batch_loss
    model.batch_loss = lambda rows: sum(
        whole(tuple(t[q::world] for t in rows)) for q in range(world)) / world


def fresh_coordinator(work: str, rank: int, name: str) -> None:
    """Point SDUMC_COORDINATOR at a port that rank 0 has just found free and
    published in `work`/`name`.coordinator: a port picked long before its
    use can be taken meanwhile by another process's socket."""
    from sdumc_tpu_torch.parallel.multihost import free_port

    path = os.path.join(work, name + ".coordinator")
    if rank == 0:
        with open(path + ".tmp", "w") as f:
            f.write(f"127.0.0.1:{free_port()}")
        os.replace(path + ".tmp", path)
    deadline = time.monotonic() + RANK_COLLECTIVE_SECONDS
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise RuntimeError(f"rank 0 published no coordinator in {RANK_COLLECTIVE_SECONDS} s")
        time.sleep(0.05)
    with open(path) as f:
        os.environ["SDUMC_COORDINATOR"] = f.read()


def multihost_epoch(torch, work: str, rank: int, name: str, extra: list) -> dict:
    """``cli.train --multihost --epochs 1`` (DP_ARGV + `extra`) on the
    rendezvous SDUMC_COORDINATOR names, the launch counters around it, its
    checkpoints in `work`/`name`/ck{rank}; on rank 0 its best_full.pt
    through cli.infer (one process, after the group has gone)."""
    from sdumc_tpu_torch.cli import infer, train
    from sdumc_tpu_torch.ops.kernels import fused_cross

    ck = os.path.join(work, name, f"ck{rank}")
    reset_counts()
    result = train.main(DP_ARGV + extra + ["--checkpoint_dir", ck,
                                           "--save_root", os.path.join(work, name, f"saved{rank}")])
    record = {"history": result["history"], "best_full": result["best_full"],
              "best_missing": result["best_missing"], "launches": dict(fused_cross.LAUNCHES),
              "counts": read_counts()}
    if rank == 0:
        out = infer.main(MAIN_ARGV + extra + ["--checkpoint", os.path.join(ck, "best_full.pt")])
        record["infer_mae"] = out["full"]["mae"]
    return record


def dp_worker(torch, work: str) -> None:
    """One rank of phase 28, started with the SDUMC_* environment beside
    phase 24's runs. There: (b) ``cli.train --multihost --synthetic
    --epochs 1`` on that rendezvous and (c) the same with ``--model mfm``
    on a second, rank 0's best_full.pt of each through cli.infer; then, on
    a third (``fresh_coordinator``), from the seeded weights with dropout
    off on this rank's rows of the first train batch: (a) the fusion net's
    DP step, the control (the rank's own loss, gradients averaged) and on
    rank 0 the single-process step on the whole batch, gloo's all_gather
    on CUDA tensors; (c) per family of BDP_FAMILIES with live draws the
    same (its control ``own_rows_control``), the launch counters around
    each DP step, its gradients and parameters to `work`/NAME{r}.pt;
    writes side{r}.json. Then, once phase 28 writes `work`/go (nothing else
    on the card): the fusion net's warm DP step and gradient all_reduce,
    and each family's warm DP step with live dropouts, timed; writes
    rank{r}.json. One synthetic store serves the whole worker
    (``SharedSyntheticSources``)."""
    import torch.distributed as dist

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.data.pipeline import get_loaders
    from sdumc_tpu_torch.parallel import (initialize_from_env, make_data_axis,
                                          reduce_gradients, shard_batch, shutdown)
    from sdumc_tpu_torch.train.step import batch_to_device_dict

    t0 = time.perf_counter()
    rank = int(os.environ["SDUMC_PROCESS_ID"])
    report = {"rank": rank, "families": {}}
    with SharedSyntheticSources():
        report["epoch"] = multihost_epoch(torch, work, rank, "fusion", [])
        fresh_coordinator(work, rank, BDP_CLI_MODEL)
        report["cli"] = multihost_epoch(torch, work, rank, BDP_CLI_MODEL,
                                        ["--model", BDP_CLI_MODEL])
        report["epochs_seconds"] = time.perf_counter() - t0
        fresh_coordinator(work, rank, "steps")
        _, world = initialize_from_env(device="cuda")
        axis = make_data_axis(torch.device("cuda", torch.cuda.current_device()))
        cfg = main_path_config()
        set_matmul_precision(cfg.model.matmul_precision)
        splits = get_loaders(cfg.data.dataset, cfg.data, cfg.paths, synthetic=True)
    report["sizes"] = [len(ds) for ds in splits]
    dims = splits[0].input_dims()
    whole = batch_to_device_dict(first_train_batch(cfg, splits[0]), DEVICE)
    local = shard_batch(whole, rank, world)
    report["rows"] = int(local["vals"].shape[0])

    model, step, report["loss"], grads = dropout_off_step(torch, cfg, dims, local, axis)
    _, _, report["control_loss"], control = dropout_off_step(torch, cfg, dims, local, axis,
                                                             local_loss=True)
    if rank == 0:                   # the other rank waits in its next collective
        _, _, report["single_loss"], single = dropout_off_step(torch, cfg, dims, whole)
        report["worst"] = worst_grad_ratio(grads, single)
        report["control_worst"] = worst_grad_ratio(control, single)
    x = torch.full((2,), float(rank), device=DEVICE)
    try:        # gloo's all_gather on CUDA tensors, for the record (the port gathers by all_reduce)
        out = [torch.empty(2, device=DEVICE) for _ in range(world)]
        dist.all_gather(out, x)
        report["gloo_all_gather_cuda"] = f"works: {[t.tolist() for t in out]}"
    except (RuntimeError, ValueError) as e:
        report["gloo_all_gather_cuda"] = f"raises {type(e).__name__}: {str(e).splitlines()[0]}"

    for name in BDP_FAMILIES:
        fam = report["families"][name] = {}
        family = bdp_model(torch, cfg, dims[:3], name, dropout_off=True)
        reset_counts()
        fam["loss"] = make_step(torch, cfg, family, axis)(local)["loss"].item()
        fam["counts"] = read_counts()
        g = grads_of(family)
        torch.save({"g": g, "p": {k: p.detach().cpu() for k, p in family.named_parameters()}},
                   os.path.join(work, f"{name}{rank}.pt"))
        ctrl = bdp_model(torch, cfg, dims[:3], name, dropout_off=True)
        ctrl_step = make_step(torch, cfg, ctrl, axis)
        own_rows_control(ctrl, world)
        fam["control_loss"] = ctrl_step(local)["loss"].item()
        if rank == 0:
            single = bdp_model(torch, cfg, dims[:3], name, dropout_off=True)
            fam["single_loss"] = make_step(torch, cfg, single)(whole)["loss"].item()
            fam["worst"] = worst_grad_ratio(g, grads_of(single))
            fam["control_worst"] = worst_grad_ratio(grads_of(ctrl), grads_of(single))
    report["side_seconds"] = time.perf_counter() - t0
    report["reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    whole = single = family = ctrl = ctrl_step = None   # the card's memory back while it waits
    torch.cuda.empty_cache()
    with open(os.path.join(work, f"side{rank}.json"), "w") as f:
        json.dump(report, f, default=float)

    wait_for_go(work, "phase 28")
    report["step_ms"] = time_ms(lambda: step(local), iters=DP_TIMED, warmup=3)
    report["allreduce_ms"] = time_ms(lambda: reduce_gradients(model.parameters(), axis),
                                     iters=DP_TIMED, warmup=3)
    del model, step
    report["family_ms"] = {}
    for name in BDP_FAMILIES:
        fstep = make_step(torch, cfg, bdp_model(torch, cfg, dims[:3], name, dropout_off=False),
                          axis)
        report["family_ms"][name] = time_ms(lambda: fstep(local), iters=BDP_TIMED,
                                            warmup=BDP_WARMUP)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(report, f, default=float)
    shutdown()


def start_dp_phase(procs, work: str) -> str:
    """Phase 28's work that times nothing, started in `procs` beside phase
    24's runs: its two ranks (``chip_smoke.py --dp-worker``), which then
    wait to time their steps in phase 28. Returns the phase's directory."""
    dp_dir = os.path.join(work, "dp")
    os.makedirs(dp_dir)
    open(os.path.join(dp_dir, "alive"), "w").close()    # main() touches it at each phase
    procs.start_ranks([sys.executable, os.path.abspath(__file__), "--dp-worker", dp_dir],
                      DP_WORLD, env=RANK_ENV, log_dir=dp_dir,
                      cwd=os.path.dirname(os.path.abspath(__file__)))
    return dp_dir


def logged(record: dict) -> tuple:
    """What a rank's cli.train logged, without its clips/s."""
    return ([{k: v for k, v in h.items() if k != "clips_per_sec"} for h in record["history"]],
            record["best_full"], record["best_missing"])


def dp_phase(torch, procs, dp_dir: str, single_epoch, single_step_ms, zoo: dict,
             card: str) -> dict:
    """Phase 28: data-parallel training, two ranks on the card over gloo;
    their untimed work ran beside phase 24 (``start_dp_phase``). Now the
    ranks time their steps, then every part is held: (a) the fusion net's
    2-rank step (16 rows each) against the single-process step (32 rows)
    on the card, the loss to STEP_LOSS_RTOL, every gradient to phase 8's
    ratio, which the control (each rank's own loss, gradients averaged)
    must exceed; its warm step and gradient all_reduce beside phase 9's
    step. (b) ``cli.train --multihost --synthetic --epochs 1``: identical
    metrics on both ranks, within DP_METRIC_ATOL of phase 7's first epoch
    (`single_epoch`), 3 launches per batch and Q on each rank, rank 0 alone
    writing checkpoints, its best_full.pt through cli.infer reproducing its
    MAE. (c) Per family of BDP_FAMILIES (dropout off, live draws) the same
    as (a), the control each rank's own model_loss averaged (mctn: its own
    teacher mask), both ranks' losses, gradients and parameters equal to
    the bit, no kernel launched, its warm DP step beside phase 24's
    single-process step (`zoo`); ``cli.train --multihost --model mfm`` as
    (b), its metrics finite and no kernel launched. Returns the launches of
    each rank in (b)."""
    open(os.path.join(dp_dir, "go"), "w").close()
    procs.wait(until=lambda: all(os.path.exists(os.path.join(dp_dir, f"rank{r}.json"))
                                 for r in range(DP_WORLD)),
               timeout=WAIT_SECONDS["dp ranks"])
    for rank in range(DP_WORLD):
        with open(os.path.join(dp_dir, f"rank{rank}.log")) as f:
            shown = [ln for ln in f.read().splitlines()
                     if ln.startswith(("multihost:", "epoch:", "best_test"))]
        print("\n".join(f"  rank {rank}: {ln}" for ln in shown))
    reports = []
    for rank in range(DP_WORLD):
        with open(os.path.join(dp_dir, f"rank{rank}.json")) as f:
            reports.append(json.load(f))
    r0 = reports[0]
    print(f"the ranks' work beside phase 24: {[r['side_seconds'] for r in reports]!r} s by rank, "
          f"the two cli.train epochs {[r['epochs_seconds'] for r in reports]!r} of it; the "
          f"card's memory reserved at most {[r['reserved_gib'] for r in reports]!r} GiB by rank")

    (worst, worst_key), (ctrl, ctrl_key) = r0["worst"], r0["control_worst"]
    print(f"(a) one train step, {DP_WORLD} ranks x {r0['rows']} rows vs one process x "
          f"{DP_WORLD * r0['rows']} (dropout off, seeded weights, the card): loss {r0['loss']!r} vs "
          f"{r0['single_loss']!r} (rtol {STEP_LOSS_RTOL}, rank 1: {reports[1]['loss']!r}); worst "
          f"max-abs-diff / (GRAD_RTOL max|grad| + GRAD_ATOL) = {worst!r} at {worst_key} (must be "
          f"<= 1)")
    print(f"    control, each rank's own loss with averaged gradients: losses "
          f"{[r['control_loss'] for r in reports]!r}, worst ratio {ctrl!r} at {ctrl_key} "
          f"(must be > 1)")
    if abs(r0["loss"] - r0["single_loss"]) > STEP_LOSS_RTOL * abs(r0["single_loss"]) \
            or worst > 1.0:
        raise AssertionError("the data-parallel step is not the single-process step")
    if ctrl <= 1.0:
        raise AssertionError("the gradient check does not tell the local-loss step apart")
    step_ms = [r["step_ms"] for r in reports]
    ar_ms = [r["allreduce_ms"] for r in reports]
    print(f"    warm DP step (2 x 16 rows, gloo through the host, one card; CUDA events over "
          f"{DP_TIMED} steps): {step_ms!r} ms per step by rank, against phase 9's single-process "
          f"step (32 rows) {single_step_ms!r} ms; the gradient all_reduce alone "
          f"{ar_ms!r} ms ({ar_ms[0] / step_ms[0]:.1%} of rank 0's step) ({card}). Two ranks "
          f"on one card show correctness, not scaling.")
    print(f"    gloo all_gather on CUDA tensors (torch {torch.__version__}): "
          f"{r0['gloo_all_gather_cuda']}")

    epochs = [r["epoch"] for r in reports]
    if any(logged(e) != logged(epochs[0]) for e in epochs[1:]):
        raise AssertionError(f"the ranks log different metrics: {[logged(e) for e in epochs]}")
    (h,) = epochs[0]["history"]
    pairs = {} if single_epoch is None else {
        "train_mse_full": (h["train_mse_full"], single_epoch["train_mse_full"]),
        "train_mse_missing": (h["train_mse_missing"], single_epoch["train_mse_missing"]),
        "eval_mse_full": (h["eval_mse_full"], single_epoch["eval_mse_full"]),
        "test_mae_full": (h["test"]["full"]["mae"], single_epoch["test"]["full"]["mae"]),
        "test_mae_missing": (h["test"]["missing"]["mae"],
                             single_epoch["test"]["missing"]["mae"])}
    print(f"(b) cli.train --multihost, {DP_WORLD} processes, 1 epoch (live dropouts): both ranks "
          f"log the same metrics; against phase 7's first epoch (atol {DP_METRIC_ATOL}): "
          + (", ".join(f"{k} {a!r} vs {b!r}" for k, (a, b) in pairs.items())
             or "not run (--dp-only)"))
    if any(abs(a - b) > DP_METRIC_ATOL for a, b in pairs.values()):
        raise AssertionError("the data-parallel epoch is too far from the single-process one")
    train_n, val_n, test_n = r0["sizes"]
    bs = main_path_config().data.batch_size // DP_WORLD
    for r, e in zip(reports, epochs):
        n = ((train_n // DP_WORLD) // bs + sum(
            math.ceil(len(range(r["rank"], size, DP_WORLD)) / bs) for size in (val_n, test_n)))
        for q_count, (name, _) in REPLACES.items():
            got = e["launches"].get(str(q_count), 0)
            if got != 3 * n:
                raise AssertionError(f"rank {r['rank']}: {name} launched {got} times, expected "
                                     f"3 x {n} batches = {3 * n}")
        print(f"    rank {r['rank']}: {n} batches of {bs} rows, launches {e['counts']}")
    hold_rank0_checkpoint(dp_dir, "fusion", epochs[0], "")

    print(f"(c) the families whose model_loss couples the rows, as (a) (live batch-wide draws "
          f"{BDP_DRAWS})")
    for name in BDP_FAMILIES:
        fam = r0["families"][name]
        (worst, key), (ctrl, ctrl_key) = fam["worst"], fam["control_worst"]
        control = ("each rank its own teacher mask" if name == "mctn"
                   else "each rank its own model_loss, averaged")
        print(f"    {name}: loss {fam['loss']!r} vs {fam['single_loss']!r} (rank 1: "
              f"{reports[1]['families'][name]['loss']!r}); worst gradient ratio {worst!r} at "
              f"{key} (must be <= 1); control ({control}): loss {fam['control_loss']!r}, ratio "
              f"{ctrl!r} at {ctrl_key} (must be > 1); warm DP step "
              f"{[r['family_ms'][name] for r in reports]!r} ms by rank (CUDA events, live "
              f"dropouts, {BDP_TIMED} steps) against phase 24's single-process step "
              f"{zoo.get(name, {}).get('ms')!r} ({card})")
        if abs(fam["loss"] - fam["single_loss"]) > STEP_LOSS_RTOL * abs(fam["single_loss"]) \
                or worst > 1.0:
            raise AssertionError(f"{name}: the data-parallel step is not the single-process step")
        if ctrl <= 1.0:
            raise AssertionError(f"{name}: the gradient check does not tell the control apart")
        saved = [torch.load(os.path.join(dp_dir, f"{name}{r}.pt")) for r in range(DP_WORLD)]
        for part in ("g", "p"):
            for k, t in saved[0][part].items():
                if not torch.equal(t.view(torch.int32), saved[1][part][k].view(torch.int32)):
                    raise AssertionError(f"{name}: the ranks' {k} differ after the step")
        if any(r["families"][name]["loss"] != fam["loss"] for r in reports):
            raise AssertionError(f"{name}: the ranks' losses differ")
        if any(any(r["families"][name]["counts"].values()) for r in reports):
            raise AssertionError(f"{name}: a step launched a kernel of the port")
    print("    both ranks' losses, gradients and parameters after each step equal to the bit; "
          "no kernel of the port launched")
    clis = [r["cli"] for r in reports]
    (h,) = clis[0]["history"]
    values = [h["train_loss"], h["train_mse_full"], h["train_mse_missing"], h["eval_mse_full"],
              h["test"]["full"]["mae"], h["test"]["missing"]["mae"]]
    print(f"    cli.train --multihost --model {BDP_CLI_MODEL} --epochs 1 (live dropouts and "
          f"draws): train_loss {h['train_loss']!r}, test MAE {h['test']['full']['mae']!r} / "
          f"{h['test']['missing']['mae']!r}, the same on both ranks; the port's kernels launched "
          f"{[sum(c['counts'].values()) for c in clis]} times by rank")
    if any(logged(c) != logged(clis[0]) for c in clis[1:]):
        raise AssertionError(f"{BDP_CLI_MODEL}: the ranks log different metrics: "
                             f"{[logged(c) for c in clis]}")
    if not all(map(math.isfinite, values)):
        raise AssertionError(f"{BDP_CLI_MODEL}: non-finite training log: {h}")
    if any(any(c["counts"].values()) for c in clis):
        raise AssertionError(f"{BDP_CLI_MODEL}: cli.train launched a kernel of the port")
    hold_rank0_checkpoint(dp_dir, BDP_CLI_MODEL, clis[0], f" --model {BDP_CLI_MODEL}")
    return {r["rank"]: e["launches"] for r, e in zip(reports, epochs)}


def hold_rank0_checkpoint(dp_dir: str, name: str, record: dict, flags: str) -> None:
    """Rank 0 alone wrote `name`'s checkpoints, and its best_full.pt through
    cli.infer reproduced the MAE it recorded, to CKPT_MAE_RTOL."""
    mae, best = record["infer_mae"], record["best_full"]["mae"]
    print(f"    rank 0's best_full.pt through cli.infer{flags} (one process): test MAE {mae!r}, "
          f"the ranks recorded {best!r} (rtol {CKPT_MAE_RTOL})")
    if os.path.exists(os.path.join(dp_dir, name, "ck1")) \
            or not os.path.exists(os.path.join(dp_dir, name, "ck0", "best_full.pt")):
        raise AssertionError(f"{name}: rank 0 alone writes the checkpoints")
    if abs(mae - best) > CKPT_MAE_RTOL * abs(best):
        raise AssertionError(f"{name}: rank 0's checkpoint does not reproduce its MAE")


# ---------------------------------------------------------------- tensor parallelism (phase 29)

TP_WORLD = 2                 # two ranks on the one card, over gloo
TP_WAVLM_CLIPS = 2           # (d): phase 5's shortest clips, in one padded batch
TP_BATCH_RUNS = 1            # (c): timed runs of phase 14's batch (1.1-1.6 s each over gloo)
TP_TIMED_STEPS = 8           # (c): decode steps run on with each collective timed
TP_GO_SECONDS = 300          # a rank's wait for phase 29 past the main process's last phase
                             # start (phases 25-28 took 31-172 s each)
RING_TIMED_RUNS = 2          # (e): timed SP forwards, and one-process forwards on rank 0
RING_GRAD_RUNS = 1           # (e): timed SP forward + backward + reduction, after the run that
                             # times each rotation and collective; one-process forward +
                             # backward on rank 0, after a warm one
RING_GRAD_SEED = 29          # (e)'s gradient: the loss's weights over the taps, drawn on the card
# (e)'s gradient: each parameter's and the wave's, after the reduction, within SP_GRAD_RTOL of
# its scale in one process's: the tensor's own largest |grad|, or SP_GRAD_FLOOR times the
# largest of its module's gradients (a weight's and its bias's together) where that is larger.
# The floor: a bias's gradient sums over the frames what its weight's sums weighted by the
# input, and where that sum cancels it is float noise of the weight's scale (k_proj's bias: the
# softmax is invariant to a shift of a row's scores, so its exact gradient is zero). The one
# process runs the flash kernel and its chunked backward over all 2999 keys, the ranks the block
# kernel and the ring backward over 1500-key blocks merged by their log-sum-exps: the same sums
# in another order, through 24 layers forward and back. Measured under this rule (NVIDIA H100
# 80GB HBM3, 700.00 W): the worst of 494 tensors 1.75e-4 (layer 21's gru_rel_pos_linear bias),
# the next 6.2e-5; the limit is 3.4 times the worst.
SP_GRAD_RTOL = 6e-4
SP_GRAD_FLOOR = 0.1
TP_FIRST_ROW_SHARE = 0.01    # (a): feat4 first-row elements outside phase 11's rtol / atol
TP_WITNESS_RATIO = 1.25      # (a): --tp N's first rows no farther from f32 than this times --tp 1's
TEXT_BF16_ULPS = 4           # the text stage's bf16 rule (tests/test_torch_text.py BF16_ULPS)


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| (8 bits of mantissa)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


class TimedCollectives:
    """Within it, every call of ``ModelAxis.all_reduce`` / ``gather_last``
    is timed on the host clock between two synchronisations; ``ms`` lists
    them. The synchronisations slow the run they time, so the share is of
    that run's own host clock."""

    def __init__(self, torch):
        self.torch, self.ms = torch, []

    def __enter__(self):
        from sdumc_tpu_torch.parallel.mesh import ModelAxis

        self.saved = ModelAxis.all_reduce, ModelAxis.gather_last

        def timed(fn):
            def run(axis, x):
                self.torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(axis, x)
                self.torch.cuda.synchronize()
                self.ms.append(1e3 * (time.perf_counter() - t))
                return out
            return run

        ModelAxis.all_reduce, ModelAxis.gather_last = (timed(f) for f in self.saved)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from sdumc_tpu_torch.parallel.mesh import ModelAxis

        self.torch.cuda.synchronize()
        self.wall_ms = 1e3 * (time.perf_counter() - self.t0)
        ModelAxis.all_reduce, ModelAxis.gather_last = self.saved
        return False


def tp_parity(torch, axis) -> dict:
    """Phase 29 (b): phase 10's decoder (Vicuna-7B width, 2 layers, f32,
    seeded on the card alike in every rank) whole and split over the ranks:
    every hidden state and the logits of the full-sequence forward, then the
    beam-4 decode of phase 10's 2 clips (the ranks' tokens checked equal)."""
    import numpy as np

    from sdumc_tpu_torch.models.llama import LlamaForCausalLM, init_weights
    from sdumc_tpu_torch.parallel import shard_llama_model

    cfg = feat4_config(torch, CLI_LAYERS, dtype=torch.float32)
    with torch.device("meta"):
        full = LlamaForCausalLM(cfg)
    full = init_weights(full.to_empty(device=axis.device), seed=0).eval()
    split = shard_llama_model(full.state_dict(), cfg, axis)
    rng = np.random.default_rng(10)
    bucket, lens = 64, [41, 57]
    prompts = np.zeros((2, bucket, cfg.hidden_size), np.float32)
    for c, n in enumerate(lens):
        prompts[c, bucket - n:] = 0.5 * rng.standard_normal((n, cfg.hidden_size))
    prompts = torch.from_numpy(prompts).to(axis.device)
    outs = {}
    for name, model, kw in (("single", full, {}), ("tp", split, {"axis": axis})):
        with torch.inference_mode():
            fwd = model(inputs_embeds=prompts[1:, bucket - lens[1]:], output_hidden_states=True)
        beam = beam_chunk(torch, model, model.cfg, prompts, lens, PARITY_STEPS, **kw)
        outs[name] = (fwd, beam)
    (fwd, beam), (tfwd, tbeam) = outs["single"], outs["tp"]
    hidden = [(t - r).abs().max().item() for t, r in zip(tfwd["hidden_states"],
                                                         fwd["hidden_states"])]
    hidden_ok = all(torch.allclose(t, r, rtol=LLAMA_RTOL, atol=LLAMA_ATOL)
                    for t, r in zip(tfwd["hidden_states"], fwd["hidden_states"]))
    report = {
        "hidden_max_abs_diff": max(hidden), "hidden_ok": hidden_ok,
        "hidden_top": max(h.abs().max().item() for h in fwd["hidden_states"]),
        "logits_max_abs_diff": (tfwd["logits"] - fwd["logits"]).abs().max().item(),
        "logits_ok": torch.allclose(tfwd["logits"], fwd["logits"], rtol=LLAMA_RTOL,
                                    atol=LLAMA_ATOL),
        "tokens_equal": torch.equal(tbeam["tokens"], beam["tokens"]),
        "steps_equal": torch.equal(tbeam["n_steps"], beam["n_steps"]),
        "n_steps": beam["n_steps"].tolist(),
        "taps_max_abs_diff": (tbeam["taps"] - beam["taps"]).abs().max().item(),
        "taps_ok": torch.allclose(tbeam["taps"], beam["taps"], rtol=LLAMA_RTOL, atol=LLAMA_ATOL),
        "tokens": tbeam["tokens"][:, :PARITY_STEPS].tolist()}
    del full, split, outs
    torch.cuda.empty_cache()
    return report


def tp_full_depth(torch, axis, paths: dict) -> dict:
    """Phase 29 (c), with nothing else on the card: Vicuna-7B at VICUNA_LAYERS
    in bf16 split over the ranks, each seeding its own shards on the card;
    phase 14's batch through the trunk and QUANT_STEPS - 1 decode steps (a
    QUANT_STEPS-token run's) of phase 12's timed chunk at --gen_batch 4,
    after its prefill and two warm steps, each timed by CUDA events, then
    run on with every collective timed; the rank's peak memory over the
    decode."""
    import glob

    import numpy as np

    from sdumc_tpu_torch.convert.llama_tokenizer import LlamaTokenizer
    from sdumc_tpu_torch.extract.llm4wav import Feat4Extractor
    from sdumc_tpu_torch.extract.projector import load_projector
    from sdumc_tpu_torch.extract.text import run_batch
    from sdumc_tpu_torch.models.generation import beam_prefill, beam_step
    from sdumc_tpu_torch.models.llama import (LlamaForCausalLM, init_weights,
                                              tp_model_from_state_dict)
    from sdumc_tpu_torch.parallel.sharding import llama_specs, rank_part

    cfg = feat4_config(torch, VICUNA_LAYERS)
    with torch.device("meta"):
        whole = LlamaForCausalLM(cfg).state_dict()
    specs = llama_specs(whole, cfg, axis.world)
    local = {k: torch.empty(rank_part(t, specs[k], axis.rank, axis.world).shape, dtype=t.dtype,
                            device=axis.device) for k, t in whole.items()}
    model = init_weights(tp_model_from_state_dict(cfg, local, specs, axis), seed=3 + axis.rank)
    report = {"rank_params": sum(p.numel() for p in model.parameters()),
              "rank_weight_gb": sum(p.numel() * p.element_size()
                                    for p in model.parameters()) / 1e9}
    tok = LlamaTokenizer.from_dir(paths["llm_dir"])
    ids, lengths, bucket = text_batch(torch, tok, [s for _, s in transcripts()])
    ex = Feat4Extractor(model, load_projector(paths["proj_path"], device=axis.device), tok,
                        max_new_tokens=MAX_NEW, gen_batch=GEN_BATCH, axis=axis)
    feats = [np.load(p) for p in sorted(glob.glob(os.path.join(paths["feats_dir"], "*.npy")))]
    prompts, lens, decode_bucket = timed_chunk(torch, ex, feats)
    with torch.inference_mode():
        report["batch_ms"] = time_ms(lambda: run_batch(model.model, ids, lengths, TEXT_TAPS[0]),
                                     iters=TP_BATCH_RUNS, warmup=1)
        with TimedCollectives(torch) as timed:
            run_batch(model.model, ids, lengths, TEXT_TAPS[0])
    report.update(batch_bucket=bucket, batch_rows=int((lengths > 0).sum()),
                  batch_collectives=len(timed.ms), batch_collective_ms=sum(timed.ms),
                  batch_timed_ms=timed.wall_ms)

    steps = QUANT_STEPS - 1                  # the decode steps of a QUANT_STEPS-token run

    def prefill():
        return beam_prefill(model, prompts, model.cfg, prompt_len=lens, num_beams=BEAMS,
                            max_new_tokens=MAX_NEW)

    def step(state, it):
        beam_step(model, state, it, embed_fn=model.model.embed_tokens)

    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = prefill()
        for it in range(2):                  # warm
            step(state, it)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for it in range(2, 2 + steps):
            step(state, it)
        ev[1].record()
        torch.cuda.synchronize()
        report["step_ms"] = ev[0].elapsed_time(ev[1]) / steps
        report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        with TimedCollectives(torch) as timed:       # more steps, each collective timed
            for it in range(2 + steps, 2 + steps + TP_TIMED_STEPS):
                step(state, it)
    report.update(decode_bucket=decode_bucket, steps=QUANT_STEPS,
                  step_collectives=len(timed.ms) / TP_TIMED_STEPS,
                  step_collective_ms=sum(timed.ms) / TP_TIMED_STEPS,
                  step_timed_ms=timed.wall_ms / TP_TIMED_STEPS)
    del state, model, ex, local
    torch.cuda.empty_cache()
    return report


def tp_wavlm(torch, axis, wavlm, paths: dict) -> dict:
    """Phase 29 (d): phase 5's seeded wavlm-large whole and split over the
    ranks (8 of 16 heads a rank), at f32 and at bf16, on one padded batch of
    phase 5's TP_WAVLM_CLIPS shortest wavs: the last hidden state and tap
    -5 on the real frames, the split model's flash launches, the first of
    them held to its plain version at H = 8."""
    import copy

    import numpy as np

    from sdumc_tpu_torch.cli.common import bf16_full_precision_reduction
    from sdumc_tpu_torch.extract.audio import BUCKETS, read_wav, zero_mean_unit_var
    from sdumc_tpu_torch.ops.kernels import flash_wavlm
    from sdumc_tpu_torch.parallel import shard_wavlm_model

    cfg, cpu_model = wavlm
    sd = {k: v.to(axis.device) for k, v in cpu_model.state_dict().items()}
    audio = paths["audio_dir"]
    wavs = sorted((read_wav(os.path.join(audio, f)) for f in os.listdir(audio)), key=len)
    wavs = wavs[:TP_WAVLM_CLIPS]
    bucket = next(b for b in BUCKETS if len(wavs[-1]) <= b)
    batch = np.zeros((len(wavs), bucket), np.float32)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = zero_mean_unit_var(w)
    frames = [cfg.output_length(len(w)) for w in wavs]
    mask = torch.zeros(len(wavs), cfg.output_length(bucket), dtype=torch.bool)
    for i, n in enumerate(frames):
        mask[i, :n] = True
    mask = mask.to(axis.device)
    report = {"clips_s": [len(w) / 16000 for w in wavs], "frames": frames,
              "layers": cfg.num_layers}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        single = copy.deepcopy(cpu_model).to(axis.device, dtype).eval()
        split = shard_wavlm_model(sd, cfg, axis).to(dtype)
        x = torch.from_numpy(batch).to(axis.device, dtype)
        seen = []

        def spy(*args, _launch=flash_wavlm.launch):
            out = _launch(*args)
            if not seen:
                seen.append(([a.clone() if isinstance(a, torch.Tensor) else a for a in args],
                             out.clone()))
            return out

        with torch.inference_mode(), bf16_full_precision_reduction():
            ref = single(x, pad_mask=mask, output_hidden_states=True)
            flash_wavlm.launch, saved = spy, flash_wavlm.launch
            try:
                reset_counts()
                got = split(x, pad_mask=mask, output_hidden_states=True)
                torch.cuda.synchronize()
                counts = read_counts()
            finally:
                flash_wavlm.launch = saved
            (q, k, v, gate, diag, kvalid), out = seen[0]
            plain = flash_wavlm.flash_gated_attention_plain(
                q, k, v, gate, None, kvalid, diag, num_buckets=cfg.num_buckets,
                max_distance=cfg.max_bucket_distance)
            diff = (out.float() - plain.float()).abs()
            if dtype == torch.bfloat16:
                flash_ok = bool((diff / flash_wavlm.bf16_tolerance(plain, v)).max() <= 1.0
                                and flash_wavlm.bf16_mismatch_share(out, plain)
                                <= flash_wavlm.BF16_MISMATCH_LIMIT)
            else:
                flash_ok = torch.allclose(out, plain, rtol=FLASH_RTOL, atol=FLASH_ATOL)
            r = {"launches": counts, "flash_shape": list(q.shape), "flash_ok": flash_ok,
                 "flash_max_abs_err": diff.max().item()}
            for key, a, b in (("last", got["last_hidden_state"], ref["last_hidden_state"]),
                              ("tap", got["hidden_states"][-5], ref["hidden_states"][-5])):
                a = torch.cat([a[i, :n] for i, n in enumerate(frames)]).float()
                b = torch.cat([b[i, :n] for i, n in enumerate(frames)]).float()
                cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
                r[key] = {"max_abs_diff": (a - b).abs().max().item(),
                          "max_abs": b.abs().max().item(),
                          "rel_l2": ((a - b).norm() / b.norm()).item(),
                          "min_cos": cos.min().item(),
                          "ok": (cos.min().item() > BF16_COS_MIN if dtype == torch.bfloat16
                                 else torch.allclose(a, b, rtol=FEAT_RTOL, atol=FEAT_ATOL))}
        report[tag] = r
        del single, split, got, ref, seen
        torch.cuda.empty_cache()
    return report


def longest_clip(torch, device, paths: dict):
    """Phase 5's longest wav (the 60-s clip), normalised, as [1, S] on
    `device`."""
    from sdumc_tpu_torch.extract.audio import read_wav, zero_mean_unit_var

    audio = paths["audio_dir"]
    wav = max((read_wav(os.path.join(audio, f)) for f in os.listdir(audio)), key=len)
    return torch.from_numpy(zero_mean_unit_var(wav))[None].to(device)


def per_frame_cos(torch, a, b) -> float:
    """The least cosine between a's and b's rows (frames), in f32."""
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min().item()


def tp_ring(torch, axis, wavlm, paths: dict) -> dict:
    """Phase 29 (e), beside phase 24: phase 5's seeded wavlm-large (24
    layers, 1024 wide, 16 heads of 64) on phase 5's 60-s clip, its frames
    split over the ranks by ``parallel.wavlm_forward_sp`` (T = 2999 padded
    to 3000, 1500 a rank; the attention round the ring, each rotation
    through gloo's page-locked host copies). At f32: every hidden-state tap
    against one process's flash-path forward on the card (FEAT_RTOL /
    FEAT_ATOL, phase 29 (d)'s); the block kernel's launches (two a layer
    on two ranks, no other kernel), the rank's first launch, out and
    log-sum-exp, against its plain version (FLASH_RTOL / FLASH_ATOL). At
    bf16 (the ring widens to f32): finite, its block launches, each tap's
    least per-frame cosine against the f32 SP taps, held to BF16_COS_MIN
    (phase 21's floor)."""
    import copy

    from sdumc_tpu_torch.cli.common import bf16_full_precision_reduction
    from sdumc_tpu_torch.ops.kernels import flash_wavlm
    from sdumc_tpu_torch.parallel import wavlm_forward_sp

    cfg, cpu_model = wavlm
    model = copy.deepcopy(cpu_model).to(axis.device).eval()
    x = longest_clip(torch, axis.device, paths)
    seen = []

    def spy(*args, _launch=flash_wavlm.launch_block):
        out = _launch(*args)
        if not seen:
            seen.append(([a.clone() if isinstance(a, torch.Tensor) else a for a in args],
                         [t.clone() for t in out]))
        return out

    report = {"samples": x.shape[1], "frames": cfg.output_length(x.shape[1]),
              "layers": cfg.num_layers}
    with torch.inference_mode():
        ref = model(x, output_hidden_states=True)["hidden_states"]
        flash_wavlm.launch_block, saved = spy, flash_wavlm.launch_block
        try:
            reset_counts()
            got = wavlm_forward_sp(model, x, axis, output_hidden_states=True)["hidden_states"]
            torch.cuda.synchronize()
            report["launches"] = read_counts()
        finally:
            flash_wavlm.launch_block = saved
        (q, k, v, gate, diag, kvalid), (out, lse) = seen[0]
        plain_out, plain_lse = flash_wavlm.flash_block_plain(q, k, v, gate, diag, kvalid)
        report.update(
            block_shape=list(q.shape),
            block_out_err=(out - plain_out).abs().max().item(),
            block_lse_err=(lse - plain_lse).abs().max().item(),
            block_ok=bool(torch.allclose(out, plain_out, rtol=FLASH_RTOL, atol=FLASH_ATOL)
                          and torch.allclose(lse, plain_lse, rtol=FLASH_RTOL, atol=FLASH_ATOL)),
            taps=len(got), tap_max_abs_diff=max((g - r).abs().max().item()
                                                for g, r in zip(got, ref)),
            tap_top=max(r.abs().max().item() for r in ref),
            taps_ok=len(got) == len(ref) and all(
                g.shape == r.shape and torch.allclose(g, r, rtol=FEAT_RTOL, atol=FEAT_ATOL)
                for g, r in zip(got, ref)))
        del ref, seen
        model = model.to(torch.bfloat16)
        with bf16_full_precision_reduction():
            reset_counts()
            got16 = wavlm_forward_sp(model, x.bfloat16(), axis,
                                     output_hidden_states=True)["hidden_states"]
            torch.cuda.synchronize()
            report["bf16_launches"] = read_counts()
        cos = [per_frame_cos(torch, a, b) for a, b in zip(got16, got)]
        report.update(bf16_finite=all(bool(torch.isfinite(t).all()) for t in got16),
                      bf16_cos=cos, bf16_ok=min(cos) > BF16_COS_MIN)
    del model, got, got16
    torch.cuda.empty_cache()
    return report


def ring_grad_weights(torch, cfg, frames: int, device) -> list:
    """(e)'s loss, a seeded linear functional of every tap: its weights, one
    [1, frames, hidden] normal draw a tap on the card from RING_GRAD_SEED
    (the same on every rank and in one process)."""
    gen = torch.Generator(device).manual_seed(RING_GRAD_SEED)
    return [torch.randn(1, frames, cfg.hidden_size, generator=gen, device=device)
            for _ in range(cfg.num_layers + 1)]


def ring_grad_step(torch, model, x, weights, taps_of, reduce=None):
    """Forward (``taps_of(wav)``: the hidden-state taps), the loss sum_i
    <tap_i, w_i>, backward, then ``reduce(leaves)`` if given; returns the
    wave leaf (its gradient, the parameters' in ``model``)."""
    model.zero_grad(set_to_none=True)
    wav = x.clone().requires_grad_()
    sum((t * w).sum() for t, w in zip(taps_of(wav), weights)).backward()
    if reduce is not None:
        reduce([*model.parameters(), wav])
    return wav


def grad_ratios(torch, got: dict, one: dict) -> dict:
    """{tensor: (max |got - one| / the larger of the tensor's largest |one|
    and SP_GRAD_FLOOR times its module's (a weight's and its bias's
    together; see SP_GRAD_RTOL), the same over the module's largest)}, both
    on the card; one read-back."""
    if got.keys() != one.keys() or any(g is None for g in (*got.values(), *one.values())):
        raise AssertionError("(e): the SP and one-process runs give gradients to different "
                             "tensors")
    keys = list(one)
    err = torch.stack([(got[k] - one[k]).abs().max() for k in keys]).tolist()
    top = torch.stack([one[k].abs().max() for k in keys]).tolist()
    tops = {}
    for key, t in zip(keys, top):
        module = key.rsplit(".", 1)[0]
        tops[module] = max(tops.get(module, 0.0), t)
    ratio = {}
    for key, e, t in zip(keys, err, top):
        module_top = tops[key.rsplit(".", 1)[0]]
        scale = max(t, SP_GRAD_FLOOR * module_top)
        ratio[key] = ((e / scale, e / module_top) if module_top else
                      (0.0, 0.0) if e == 0 else (math.inf, math.inf))
    return ratio


def grad_digests(torch, grads: dict) -> list:
    """Each gradient tensor's digest of its f32 bits: the int64 sums
    (wrapping) of its bit patterns and of them times their positions, equal
    wherever the bits are."""
    out = []
    for g in grads.values():
        bits = g.reshape(-1).view(torch.int32).long()
        out.append(torch.stack([bits.sum(), (bits * torch.arange(
            bits.numel(), device=bits.device)).sum()]))
    return torch.stack(out).tolist()


class TimedRotations:
    """Within it, every ``ModelAxis.ring_shift`` is timed on the host clock
    between two synchronisations; ``ms`` lists them (the synchronisations
    slow the run they time: the share is of that run's own host clock)."""

    def __init__(self, torch):
        self.torch, self.ms = torch, []

    def __enter__(self):
        from sdumc_tpu_torch.parallel.mesh import ModelAxis

        self.saved = ModelAxis.ring_shift

        def run(axis, tensors, _shift=self.saved):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            out = _shift(axis, tensors)
            self.torch.cuda.synchronize()
            self.ms.append(1e3 * (time.perf_counter() - t))
            return out

        ModelAxis.ring_shift = run
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from sdumc_tpu_torch.parallel.mesh import ModelAxis

        self.torch.cuda.synchronize()
        self.wall_ms = 1e3 * (time.perf_counter() - self.t0)
        ModelAxis.ring_shift = self.saved
        return False


def tp_ring_timed(torch, axis, wavlm, paths: dict) -> dict:
    """Phase 29 (e) timed, after (c), with nothing else on the card: the f32
    SP forward of the 60-s clip (the last hidden state gathered) by CUDA
    events and the host clock over RING_TIMED_RUNS runs after a warm one,
    each rank's peak memory over them; one more with each rotation timed
    alone (its share); then, the other rank waiting at a barrier, one
    process's forward of the same clip on rank 0 timed the same way, with
    its peak. Then (e)'s gradient at f32, the loss a seeded linear
    functional of every tap: the SP forward (every tap gathered), backward
    and ``reduce_gradients`` of every parameter and the wave, once with
    each rotation and collective timed alone (the gather, the reduction;
    also the warm run), then over RING_GRAD_RUNS runs by CUDA events with
    the launches counted (48 block launches a rank, no other kernel); one
    process's forward (the flash path) and backward on rank 0, timed the
    same way after a warm one, the other rank waiting at a barrier. Rank
    0's gradients of its last SP run against its one process's, tensor by
    tensor on the card (see SP_GRAD_RTOL); each rank's digests of their
    bits, which the main process holds equal (the reduction leaves the same
    sum on every rank); the card's free memory before."""
    import copy

    import torch.distributed as dist

    from sdumc_tpu_torch.parallel import reduce_gradients, wavlm_forward_sp

    model = copy.deepcopy(wavlm[1]).to(axis.device).eval()
    x = longest_clip(torch, axis.device, paths)

    def timed(fn, runs: int = RING_TIMED_RUNS, warm: bool = True) -> tuple:
        if warm:
            fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        for _ in range(runs):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return (ev[0].elapsed_time(ev[1]) / runs, 1e3 * (time.perf_counter() - t0) / runs,
                torch.cuda.max_memory_allocated() / 2**30)

    report = {}
    with torch.inference_mode():
        report["sp_ms"], report["sp_host_ms"], report["sp_peak_gib"] = timed(
            lambda: wavlm_forward_sp(model, x, axis))
        with TimedRotations(torch) as rot:
            wavlm_forward_sp(model, x, axis)
        report.update(rotations=len(rot.ms), rotation_ms=sum(rot.ms), rotation_run_ms=rot.wall_ms)
        dist.barrier()
        if axis.rank == 0:
            report["one_ms"], report["one_host_ms"], report["one_peak_gib"] = timed(
                lambda: model(x))
        dist.barrier()
    cfg = wavlm[0]
    report["free_gib"] = torch.cuda.mem_get_info()[0] / 2**30
    weights = ring_grad_weights(torch, cfg, cfg.output_length(x.shape[1]), axis.device)

    def grads(wav) -> dict:
        return {**{k: p.grad for k, p in model.named_parameters()}, "wav": wav.grad}

    def sp_grad():
        return ring_grad_step(
            torch, model, x, weights,
            lambda w: wavlm_forward_sp(model, w, axis, output_hidden_states=True)["hidden_states"],
            reduce=lambda leaves: reduce_gradients(leaves, axis))

    def one_grad():
        return ring_grad_step(torch, model, x, weights,
                              lambda w: model(w, output_hidden_states=True)["hidden_states"])

    with TimedRotations(torch) as rot, TimedCollectives(torch) as coll:
        sp_grad()                                   # also the warm run
    report.update(grad_rotations=len(rot.ms), grad_rotation_ms=sum(rot.ms),
                  grad_rotation_run_ms=rot.wall_ms, grad_collectives=len(coll.ms),
                  grad_collective_ms=sum(coll.ms), grad_reduce_ms=coll.ms[-1])
    reset_counts()
    held = []
    report["grad_ms"], report["grad_host_ms"], report["grad_peak_gib"] = timed(
        lambda: held.append(sp_grad()), RING_GRAD_RUNS, warm=False)
    report["grad_launches"] = read_counts()
    # the last SP run's gradients, reduced (the run below gives the model new tensors)
    got = grads(held[-1])
    report.update(layers=cfg.num_layers, digests=grad_digests(torch, got),
                  grad_finite=bool(torch.stack([torch.isfinite(g).all()
                                                for g in got.values()]).all()))
    del held
    dist.barrier()
    if axis.rank == 0:                              # timed alone; its last run is the reference
        held = []
        report["one_grad_ms"], report["one_grad_host_ms"], report["one_grad_peak_gib"] = timed(
            lambda: held.append(one_grad()), RING_GRAD_RUNS)
        ratio = grad_ratios(torch, got, grads(held[-1]))
        worst = max(ratio, key=lambda k: ratio[k][0])
        worst_module = max(ratio, key=lambda k: ratio[k][1])
        report.update(tensors=len(ratio), worst=worst, worst_ratio=ratio[worst][0],
                      worst_module=worst_module, worst_module_ratio=ratio[worst_module][1],
                      wav_ratio=ratio["wav"][0],
                      embed_ratio=ratio["encoder.layers.0.attention.rel_attn_embed.weight"][0],
                      grad_ok=all(v[0] <= SP_GRAD_RTOL for v in ratio.values()))
        del held
    dist.barrier()
    del model, weights, got
    torch.cuda.empty_cache()
    return report


def tp_f32_first_rows(torch, device, paths: dict) -> dict:
    """Phase 29 (a)'s witness: each clip's first feat4 row (the one before
    any beam choice) from phase 11's Vicuna loaded at f32 in one process
    (TF32 off), in the CLI's chunks and prompt buckets, two new tokens (the
    first row is the step that reads the first token); saved to
    `paths['tp_dir']`/f32_first.npz by the clip's file name."""
    import glob

    import numpy as np

    from sdumc_tpu_torch.convert.hf_llama import load_hf_llama
    from sdumc_tpu_torch.convert.llama_tokenizer import LlamaTokenizer
    from sdumc_tpu_torch.extract.llm4wav import Feat4Extractor
    from sdumc_tpu_torch.extract.projector import load_projector

    files = sorted(glob.glob(os.path.join(paths["feats_dir"], "*.npy")))
    _, model = load_hf_llama(paths["llm_dir"], device=device, dtype=torch.float32)
    ex = Feat4Extractor(model, load_projector(paths["proj_path"], device=device),
                        LlamaTokenizer.from_dir(paths["llm_dir"]), max_new_tokens=2,
                        gen_batch=GEN_BATCH)
    rows = ex.extract_many([np.load(f) for f in files])
    np.savez(os.path.join(paths["tp_dir"], "f32_first.npz"),
             **{os.path.basename(f): r["taps"][0] for f, r in zip(files, rows)})
    del model, ex
    torch.cuda.empty_cache()
    return {"clips": len(files)}


def wait_for_go(work: str, what: str) -> None:
    """A side worker's wait for `work`/go, which the main process writes when
    `what` starts with nothing else on the card; fails once the main process
    has begun no phase for TP_GO_SECONDS (it touches `work`/alive at each)."""
    go, alive = os.path.join(work, "go"), os.path.join(work, "alive")
    while not os.path.exists(go):
        idle = time.time() - os.path.getmtime(alive)
        if idle > TP_GO_SECONDS:
            raise RuntimeError(f"{what} did not start: the main process began no phase for "
                               f"{idle:.0f} s (bound {TP_GO_SECONDS} s)")
        time.sleep(0.2)


def tp_worker(torch, work: str) -> None:
    """One rank of phase 29, started with the SDUMC_* environment beside
    phase 24's runs: (b), (d), (e) and, on rank 0, (a)'s f32 witness, after
    which it writes side{r}.json; then, once the main process starts phase
    29 (it writes `work`/go: nothing else runs on the card), (c) and (e)
    timed with its gradient; writes rank{r}.json. The wait for go fails
    once the main process has begun no phase for TP_GO_SECONDS (it touches
    `work`/alive at each)."""
    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.parallel import initialize_from_env, make_model_axis, shutdown

    from sdumc_tpu_torch.convert.hf_wavlm import load_hf_wavlm

    with open(os.path.join(work, "paths.json")) as f:
        paths = json.load(f)
    rank, _ = initialize_from_env(device="cuda")
    axis = make_model_axis(torch.device("cuda", torch.cuda.current_device()), TP_WORLD)
    set_matmul_precision("highest")
    wavlm = load_hf_wavlm(paths["wavlm_dir"])           # (cfg, the model on the CPU)
    report = {"rank": rank}

    def run(parts):
        for key, fn, args in parts:
            t0 = time.perf_counter()
            report[key] = fn(torch, *args)
            report[key]["seconds"] = time.perf_counter() - t0

    run([("parity", tp_parity, (axis,)), ("wavlm", tp_wavlm, (axis, wavlm, paths)),
         ("ring", tp_ring, (axis, wavlm, paths))]
        + ([("witness", tp_f32_first_rows, (axis.device, paths))] if rank == 0 else []))
    with open(os.path.join(work, f"side{rank}.json"), "w") as f:
        json.dump(report, f, default=float)
    wait_for_go(work, "phase 29")
    run([("depth", tp_full_depth, (axis, paths)), ("ring_timed", tp_ring_timed, (axis, wavlm, paths))])
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(report, f, default=float)
    shutdown()


def start_tp_clis(procs, work: str, tp_dir: str, llm_dir: str, proj_path: str, feats_dir: str,
                  world: int) -> list:
    """Phase 29 (a): ``python -m sdumc_tpu_torch.cli.extract text --tp N``
    and ``... feat4 --tp N`` started in `procs` (a
    ``multihost.LocalProcesses``) as two commands, each of which starts its
    N ranks (the card's default bf16), on phases 13 and 11's inputs; their
    files go to `tp_dir`/text and /feat4, their output to `tp_dir`/NAME.log.
    Returns the two processes."""
    argv = {"text": ["text", "--model_dir", llm_dir, "--trans_path",
                     os.path.join(work, "transcripts.csv")],
            "feat4": ["feat4", "--llm_dir", llm_dir, "--projector_path", proj_path,
                      "--wavlm_dir", feats_dir]}
    return [procs.start(f"cli.extract {name} --tp {world}",
                        [sys.executable, "-m", "sdumc_tpu_torch.cli.extract", *args,
                         "--save_dir", os.path.join(tp_dir, name), "--tp", str(world)],
                        env=RANK_ENV, log=os.path.join(tp_dir, f"{name}.log"),
                        cwd=os.path.dirname(os.path.abspath(__file__)))
            for name, args in argv.items()]


def start_tp_phase(procs, work: str, llm_dir: str, proj_path: str, feats_dir: str) -> tuple:
    """Phase 29's work that times nothing, started in `procs` beside phase
    24's runs (which time nothing either): (a)'s two commands
    (``start_tp_clis``) and the phase's two ranks (``chip_smoke.py
    --tp-worker``: (b), (d), (e) and the witness, then (c) and (e) timed
    once phase 29 starts). Returns (the phase's directory, the commands'
    processes)."""
    tp_dir = os.path.join(work, "tp")
    os.makedirs(tp_dir)
    with open(os.path.join(tp_dir, "paths.json"), "w") as f:
        json.dump({"llm_dir": llm_dir, "proj_path": proj_path, "feats_dir": feats_dir,
                   "wavlm_dir": os.path.join(work, "model"),
                   "audio_dir": os.path.join(work, "wavs"), "tp_dir": tp_dir}, f)
    open(os.path.join(tp_dir, "alive"), "w").close()    # main() touches it at each phase
    clis = start_tp_clis(procs, work, tp_dir, llm_dir, proj_path, feats_dir, TP_WORLD)
    procs.start_ranks([sys.executable, os.path.abspath(__file__), "--tp-worker", tp_dir],
                      TP_WORLD, env=RANK_ENV, log_dir=tp_dir,
                      cwd=os.path.dirname(os.path.abspath(__file__)))
    return tp_dir, clis


def wait_side(procs, tp_dir: str, clis: list, pp_procs, pp_dir: str, dp_procs,
              dp_dir: str, dp_started: float) -> None:
    """Phase 24's wait, before it times anything, for phases 29, 30 and
    28's work beside it: both commands ended and both ranks of phase 29
    past (b), (d), (e) and the witness; the four ranks of phase 30 past (a),
    (b) and (c); the two ranks of phase 28 past their untimed work. A
    process that failed, or WAIT_SECONDS["tp side"] passing in all (for
    phase 28, WAIT_SECONDS["dp side"] since its start), raises."""
    def done():
        return (all(p.poll() == 0 for p in clis)
                and all(os.path.exists(os.path.join(tp_dir, f"side{r}.json"))
                        for r in range(TP_WORLD)))

    import torch

    free, total = torch.cuda.mem_get_info()
    print(f"phase 24's wait for the side work begins with {free / 2**30!r} GiB of the card's "
          f"{total / 2**30!r} free")
    t0 = time.perf_counter()
    procs.wait(until=done, timeout=WAIT_SECONDS["tp side"])
    t29 = time.perf_counter() - t0
    pp_procs.wait(until=lambda: all(os.path.exists(os.path.join(pp_dir, f"side{r}.json"))
                                    for r in range(PP_WORLD)),
                  timeout=max(1.0, WAIT_SECONDS["tp side"] - t29))
    t30 = time.perf_counter() - t0 - t29
    dp_procs.wait(until=lambda: all(os.path.exists(os.path.join(dp_dir, f"side{r}.json"))
                                    for r in range(DP_WORLD)),
                  timeout=max(1.0, WAIT_SECONDS["dp side"] - (time.perf_counter() - dp_started)))
    print(f"phase 29's work beside phase 24 ((a), (b), (d), (e) and the witness) done; phase 24 "
          f"waited {t29!r} s for it, then {t30!r} s for phase 30's, then "
          f"{time.perf_counter() - t0 - t29 - t30!r} s for phase 28's")


def check_tp_cli(work: str, tp_dir: str, world: int) -> None:
    """Phase 29 (a)'s files in `tp_dir` against the --tp 1 files in `work`
    (phases 13 and 11's): the text taps to TEXT_BF16_ULPS bf16 ulps of the
    largest; every feat4 clip written, each first row (before any beam
    choice) to TEXT_BF16_ULPS ulps of the row's largest tap, at most
    TP_FIRST_ROW_SHARE of those elements outside phase 11's rtol / atol,
    and the first rows no farther from the f32 witness
    (``tp_f32_first_rows``) than TP_WITNESS_RATIO times --tp 1's (relative
    L2). How far the rest of each clip agrees is printed, not held."""
    import numpy as np

    for name in ("text", "feat4"):
        with open(os.path.join(tp_dir, f"{name}.log")) as f:
            shown = [ln for ln in f.read().splitlines()
                     if ln.startswith(("multihost:", "TP:", "extracted"))]
        print("\n".join(f"  cli.extract {name} --tp {world}: {ln}" for ln in shown))
    text_dir, feat4_dir = os.path.join(tp_dir, "text"), os.path.join(tp_dir, "feat4")

    names = sorted(os.listdir(os.path.join(work, "text")))
    if sorted(os.listdir(text_dir)) != names:
        raise AssertionError(f"text --tp {world}: files {len(os.listdir(text_dir))} of "
                             f"{len(names)}")
    top = max(float(np.abs(np.load(os.path.join(work, "text", n))).max()) for n in names)
    err = 0.0
    for n in names:
        got, want = np.load(os.path.join(text_dir, n)), np.load(os.path.join(work, "text", n))
        if got.shape != want.shape or got.dtype != np.float32:
            raise AssertionError(f"text --tp {world}: {n} {got.shape} {got.dtype}, "
                                 f"--tp 1 {want.shape}")
        err = max(err, float(np.abs(got - want).max()))
    limit = TEXT_BF16_ULPS * bf16_ulp(top)
    print(f"(a) cli.extract text --tp {world} and cli.extract feat4 --tp {world} (two commands "
          f"of {world} ranks each). text, on phase 13's transcripts and 2-layer Vicuna (bf16): "
          f"{len(names)} files; against --tp 1 (phase 13): max abs diff {err!r}, limit "
          f"{limit!r} ({TEXT_BF16_ULPS} bf16 ulps of the largest tap {top!r})")
    if not err <= limit:
        raise AssertionError(f"text --tp {world} parts from --tp 1 by {err!r}")

    clips = sorted(os.listdir(os.path.join(work, "feat4")))
    if sorted(os.listdir(feat4_dir)) != clips:
        raise AssertionError(f"feat4 --tp {world}: files {len(os.listdir(feat4_dir))} of "
                             f"{len(clips)}")
    f32 = np.load(os.path.join(tp_dir, "f32_first.npz"))
    first, of_limit, over, same_len, rest, rows = 0.0, 0.0, 0, 0, 0.0, 0
    firsts = []
    for c in clips:
        got, want = np.load(os.path.join(feat4_dir, c)), np.load(os.path.join(work, "feat4", c))
        if got.ndim != 2 or got.shape[1] != want.shape[1] or not np.isfinite(got).all():
            raise AssertionError(f"feat4 --tp {world}: {c} {got.shape} or non-finite")
        rows += len(got)
        err = float(np.abs(got[0] - want[0]).max())
        limit = TEXT_BF16_ULPS * bf16_ulp(float(np.abs(want[0]).max()))
        if not err <= limit:
            raise AssertionError(f"feat4 --tp {world}: {c}'s first row parts from --tp 1 by "
                                 f"{err!r} (limit {limit!r})")
        first, of_limit = max(first, err), max(of_limit, err / limit)
        over += int((~np.isclose(got[0], want[0], rtol=BF16_RTOL, atol=BF16_ATOL)).sum())
        firsts.append((got[0], want[0], f32[c]))
        if got.shape == want.shape:
            same_len += 1
            rest = max(rest, float(np.abs(got - want).max()))
    share = over / (len(clips) * VICUNA["hidden_size"])
    tp_rows, one_rows, ref = (np.stack(x).astype(np.float64) for x in zip(*firsts))
    if not (np.isfinite(ref).all() and (np.abs(ref).max(axis=1) > 0).all()):
        raise AssertionError("the f32 witness gave an empty or non-finite first row")
    dist = {k: (float(np.linalg.norm(x - ref) / np.linalg.norm(ref)),
                float(np.abs(x - ref).max()))
            for k, x in (("tp", tp_rows), ("one", one_rows))}
    print(f"    feat4, on phase 5's features and phase 11's Vicuna (bf16, beam 4, --gen_batch 4, "
          f"200 tokens): {len(clips)} clips, {rows} taps rows; the ranks' tokens equal after "
          f"every chunk (checked in the ranks); every clip's first row against --tp 1 (phase "
          f"11): max abs diff {first!r}, {of_limit!r} of the limit ({TEXT_BF16_ULPS} bf16 ulps "
          f"of the row's largest tap); {over} of {len(clips) * VICUNA['hidden_size']} "
          f"first-row elements ({share!r}) outside phase 11's rtol {BF16_RTOL} atol "
          f"{BF16_ATOL} (limit {TP_FIRST_ROW_SHARE}); against the same rows at f32 in one "
          f"process: --tp {world} relative L2 {dist['tp'][0]!r} (max abs {dist['tp'][1]!r}), "
          f"--tp 1 {dist['one'][0]!r} (max abs {dist['one'][1]!r}), ratio "
          f"{dist['tp'][0] / dist['one'][0]!r} (limit {TP_WITNESS_RATIO}); not held: "
          f"{same_len} of {len(clips)} clips of --tp 1's step count, their taps max abs diff "
          f"{rest!r} (bf16 sums in another order can break exact ties)")
    if share > TP_FIRST_ROW_SHARE:
        raise AssertionError(f"feat4 --tp {world}: {share!r} of the first rows' elements outside "
                             f"phase 11's tolerance")
    if not dist["tp"][0] <= TP_WITNESS_RATIO * dist["one"][0]:
        raise AssertionError(f"feat4 --tp {world}: the first rows sit farther from f32 than "
                             f"--tp 1's")


TP_CLI_SECONDS = (2.5, 3.8, 5.1, 6.4, 7.7, 9.0, 10.3, 11.6)   # --tp-cli's feature clips


def tp_cli_only(torch, world: int) -> None:
    """``chip_smoke.py --tp-cli N``: phase 29 (a) alone, at N ranks (N cards:
    NCCL), from its own inputs: phase 11's seeded 2-layer Vicuna and
    projector, phase 13's transcripts, and WavLM-width features of
    TP_CLI_SECONDS (seeded normals: the stage's shapes, not phase 5's
    extraction); cli.extract text and feat4 at --tp 1, then at --tp N, and
    the f32 witness on card 0."""
    import csv

    import numpy as np

    from sdumc_tpu_torch.cli import extract
    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.parallel.multihost import LocalProcesses

    with tempfile.TemporaryDirectory() as work:
        llm_dir, proj_path = os.path.join(work, "vicuna"), os.path.join(work, "proj.pt")
        feats_dir, csv_path = os.path.join(work, "feats"), os.path.join(work, "transcripts.csv")
        write_vicuna_dir(torch, llm_dir, CLI_LAYERS)
        write_projector(torch, proj_path)
        os.makedirs(feats_dir)
        rng = np.random.default_rng(29)
        for i, sec in enumerate(TP_CLI_SECONDS):
            np.save(os.path.join(feats_dir, f"clip_{i:02d}.npy"),
                    rng.standard_normal((int(sec * 50), 1024)).astype(np.float32))
        with open(csv_path, "w", newline="", encoding="utf-8") as f:
            writer = csv.writer(f)
            writer.writerow(["name", "sentence"])
            writer.writerows(transcripts())
        t0 = time.perf_counter()
        extract.main(["text", "--model_dir", llm_dir, "--trans_path", csv_path, "--save_dir",
                      os.path.join(work, "text")])
        extract.main(["feat4", "--llm_dir", llm_dir, "--projector_path", proj_path,
                      "--wavlm_dir", feats_dir, "--save_dir", os.path.join(work, "feat4")])
        print(f"--tp 1 (one process on card 0): {time.perf_counter() - t0!r} s")
        tp_dir = os.path.join(work, "tp")
        os.makedirs(tp_dir)
        t0 = time.perf_counter()
        with LocalProcesses() as procs:
            start_tp_clis(procs, work, tp_dir, llm_dir, proj_path, feats_dir, world)
            procs.wait(timeout=900)
        print(f"--tp {world}, both commands at once: {time.perf_counter() - t0!r} s")
        set_matmul_precision("highest")
        tp_f32_first_rows(torch, torch.device("cuda", 0),
                          {"llm_dir": llm_dir, "proj_path": proj_path, "feats_dir": feats_dir,
                           "tp_dir": tp_dir})
        check_tp_cli(work, tp_dir, world)


def check_ring(reports: list, card: str) -> dict:
    """Phase 29 (e) held, each rank's, from the ranks' reports: the SP
    forward's taps, launches and first block launch, at f32 and bf16; its
    gradient against one process's; the timed forwards and gradients.
    Returns {rank: its block launches in the f32 SP forward}."""
    launches = {}
    name = FLASH_BLOCK["name"]
    e = reports[0]["ring"]
    print(f"(e) wavlm-large (phase 5's seeded weights, {e['layers']} layers) on phase 5's 60-s "
          f"clip ({e['samples']} samples, T = {e['frames']}), its frames split over {TP_WORLD} "
          f"ranks by parallel.wavlm_forward_sp (the attention round the ring: {TP_WORLD} block "
          f"steps a layer, {TP_WORLD - 1} rotation(s) through gloo's page-locked host copies; "
          f"every tap gathered), against one process's flash-path forward on the card:")
    for r in reports:
        e = r["ring"]
        print(f"    rank {r['rank']}: f32, {e['taps']} taps, max abs diff "
              f"{e['tap_max_abs_diff']!r} (max |h| {e['tap_top']!r}; rtol {FEAT_RTOL} atol "
              f"{FEAT_ATOL}, phase 29 (d)'s: {e['taps_ok']}); launches {e['launches']}; the "
              f"rank's first block launch at q {e['block_shape']} against its plain version: out "
              f"{e['block_out_err']!r}, log-sum-exp {e['block_lse_err']!r} (rtol {FLASH_RTOL} "
              f"atol {FLASH_ATOL}: {e['block_ok']}); bf16 (widened to f32 in the ring): finite "
              f"{e['bf16_finite']}, launches {e['bf16_launches']}, least per-frame cosine of "
              f"each tap against the f32 SP taps {min(e['bf16_cos'])!r} (by tap "
              f"{[round(c, 6) for c in e['bf16_cos']]}; floor {BF16_COS_MIN}, phase 21's); "
              f"beside phase 24 {e['seconds']:.1f} s")
        for key in ("launches", "bf16_launches"):
            counts = e[key]
            others = {k: n for k, n in counts.items() if k != name and n}
            if counts[name] != TP_WORLD * e["layers"] or others:
                raise AssertionError(f"(e) rank {r['rank']} {key}: {counts}, expected "
                                     f"{TP_WORLD * e['layers']} of {name} alone")
        if not (e["taps_ok"] and e["block_ok"] and e["bf16_finite"] and e["bf16_ok"]):
            raise AssertionError(f"(e) rank {r['rank']}: the sequence-parallel WavLM is not the "
                                 "single process's")
        launches[r["rank"]] = e["launches"][name]
    t = [r["ring_timed"] for r in reports]
    one = t[0]
    print(f"    timed, f32, the last hidden state gathered ({card}; {RING_TIMED_RUNS} runs after "
          f"a warm one): the SP forward {[x['sp_ms'] for x in t]!r} ms by rank (CUDA events), "
          f"{[x['sp_host_ms'] for x in t]!r} ms host clock, against one process's "
          f"{one['one_ms']!r} ms ({one['one_host_ms']!r} host; rank 0 alone), SP / one "
          f"{t[0]['sp_ms'] / one['one_ms']!r}; once more with each rotation synchronised: "
          f"{t[0]['rotations']} rotations, {t[0]['rotation_ms']!r} ms of "
          f"{t[0]['rotation_run_ms']!r} ({t[0]['rotation_ms'] / t[0]['rotation_run_ms']:.1%}; "
          f"rank 1 {t[1]['rotation_ms'] / t[1]['rotation_run_ms']:.1%}); peak device memory "
          f"by rank {[x['sp_peak_gib'] for x in t]!r} GiB, one process {one['one_peak_gib']!r}")
    print(f"    timed, the gradient ({RING_GRAD_RUNS} run(s) after a warm one): the SP forward "
          f"(every tap gathered), backward and reduction {[x['grad_ms'] for x in t]!r} ms by "
          f"rank (CUDA events), {[x['grad_host_ms'] for x in t]!r} ms host clock, against one "
          f"process's forward and backward {one['one_grad_ms']!r} ms ({one['one_grad_host_ms']!r} "
          f"host), SP / one {t[0]['grad_ms'] / one['one_grad_ms']!r}; the warm run with each "
          f"rotation and collective synchronised: {t[0]['grad_rotations']} rotations "
          f"{t[0]['grad_rotation_ms']!r} ms and {t[0]['grad_collectives']} collectives "
          f"{t[0]['grad_collective_ms']!r} ms (the gradients' reduction "
          f"{t[0]['grad_reduce_ms']!r}) of {t[0]['grad_rotation_run_ms']!r} "
          f"({t[0]['grad_rotation_ms'] / t[0]['grad_rotation_run_ms']:.1%} and "
          f"{t[0]['grad_collective_ms'] / t[0]['grad_rotation_run_ms']:.1%}; rank 1 "
          f"{t[1]['grad_rotation_ms'] / t[1]['grad_rotation_run_ms']:.1%} and "
          f"{t[1]['grad_collective_ms'] / t[1]['grad_rotation_run_ms']:.1%}); peak device memory "
          f"by rank {[x['grad_peak_gib'] for x in t]!r} GiB, one process "
          f"{one['one_grad_peak_gib']!r}")
    if not all(math.isfinite(x[k]) for x in t for k in ("sp_ms", "grad_ms")) or not all(
            math.isfinite(one[k]) for k in ("one_ms", "one_grad_ms")):
        raise AssertionError("(e): a time is not finite")
    g = t[0]
    print(f"    the gradient, f32, eval mode: the loss sum_i <tap_i, w_i> over every tap (w seeded "
          f"on the card), backward, then parallel.reduce_gradients over every parameter and the "
          f"wave (the last timed SP run's), rank 0's against one process's forward (flash path) "
          f"and backward on the card, tensor by tensor: max abs diff / max(the tensor's max "
          f"|grad|, {SP_GRAD_FLOOR} x its module's) <= {SP_GRAD_RTOL}: {g['tensors']} tensors, "
          f"the worst {g['worst']} at {g['worst_ratio']!r} (over its module's max |grad|, the "
          f"worst {g['worst_module']} at {g['worst_module_ratio']!r}); the wave "
          f"{g['wav_ratio']!r}, the shared rel_attn_embed {g['embed_ratio']!r}; the card's free "
          f"memory before {g['free_gib']!r} GiB")
    if not g["grad_ok"]:
        raise AssertionError(f"(e): the SP gradient is not one process's ({g['worst']}: "
                             f"{g['worst_ratio']!r})")
    for r in reports:
        g = r["ring_timed"]
        same = g["digests"] == t[0]["digests"]
        print(f"    rank {r['rank']}: finite {g['grad_finite']}; every tensor's bits equal rank "
              f"0's (digests) {same}; the SP run's launches under autograd "
              f"{g['grad_launches']}")
        counts = g["grad_launches"]
        if counts[name] != TP_WORLD * g["layers"] or any(
                n for k, n in counts.items() if k != name):
            raise AssertionError(f"(e) rank {r['rank']} gradient's forward: {counts}, expected "
                                 f"{TP_WORLD * g['layers']} of {name} alone")
        if not (same and g["grad_finite"]):
            raise AssertionError(f"(e) rank {r['rank']}: the reduced SP gradient is not finite "
                                 "or not rank 0's")
    return launches


def tp_phase(torch, procs, tp_dir: str, work: str, depth: dict, text_depth: dict,
             card: str) -> dict:
    """Phase 29: tensor and sequence parallelism, two ranks on the card
    over gloo. (a) the CLIs' --tp 2 against --tp 1, (b) f32 parity at full
    width, (d) wavlm-large split in two, its flash kernel at 8 heads, and
    (e) wavlm-large's frames split in two by ``wavlm_forward_sp``, the
    block kernel round the ring (``tp_ring``), ran beside phase 24
    (``start_tp_phase``); now, with nothing else on the card, the ranks run
    (c): the VICUNA_LAYERS model's batch and decode step timed, the
    collectives' share, each rank's peak memory; then (e) and its gradient
    timed (``tp_ring_timed``). Every part is held here, each rank's
    (``check_ring`` for (e) and its gradient); then the
    block kernel at the ring's shape (``flash_block_phase``). Returns
    {"launches": each rank's flash launches of (d) and block launches of
    (e), "block": the block kernel's numbers}."""
    open(os.path.join(tp_dir, "go"), "w").close()
    procs.wait(timeout=WAIT_SECONDS["tp ranks"])
    reports = []
    for rank in range(TP_WORLD):
        with open(os.path.join(tp_dir, f"rank{rank}.json")) as f:
            reports.append(json.load(f))
    print("  " + "; ".join(
        f"rank {r['rank']}: beside phase 24 (b) {r['parity']['seconds']:.1f} s, (d) "
        f"{r['wavlm']['seconds']:.1f} s, (e) {r['ring']['seconds']:.1f} s"
        + (f", the witness {r['witness']['seconds']:.1f} s" if "witness" in r else "")
        + f"; here (c) {r['depth']['seconds']:.1f} s, (e) {r['ring_timed']['seconds']:.1f} s"
        for r in reports))
    check_tp_cli(work, tp_dir, TP_WORLD)

    for r in reports:
        p = r["parity"]
        print(f"(b) rank {r['rank']}: phase 10's decoder (Vicuna-7B width, {CLI_LAYERS} layers, f32, TF32 off), "
              f"{TP_WORLD} ranks against one process on the card (rtol {LLAMA_RTOL} atol "
              f"{LLAMA_ATOL}): hidden states max abs diff {p['hidden_max_abs_diff']!r} (max |h| "
              f"{p['hidden_top']!r}), logits {p['logits_max_abs_diff']!r}; beam-{BEAMS} decode "
              f"of 2 clips, {PARITY_STEPS} steps: tokens equal {p['tokens_equal']}, step counts "
              f"equal {p['steps_equal']} {p['n_steps']}, taps max abs diff "
              f"{p['taps_max_abs_diff']!r}")
        if not (p["hidden_ok"] and p["logits_ok"] and p["tokens_equal"] and p["steps_equal"]
                and p["taps_ok"]):
            raise AssertionError("the tensor-parallel decoder is not the single process's")

    d = [r["depth"] for r in reports]
    print(f"(c) Vicuna-7B at {VICUNA_LAYERS} layers, bf16, split over {TP_WORLD} ranks on one "
          f"card (gloo through the host), each rank {d[0]['rank_params']} parameters "
          f"({d[0]['rank_weight_gb']!r} GB), seeded on the card in each rank ({card}):")
    print(f"    phase 14's batch ({d[0]['batch_rows']} transcripts, bucket "
          f"{d[0]['batch_bucket']}, taps -3): {[x['batch_ms'] for x in d]!r} ms by rank (CUDA "
          f"events, {TP_BATCH_RUNS} runs) against one process's {text_depth['batch_ms']!r} "
          f"(phase 14, 10 runs); timed "
          f"again with each collective synchronised: {d[0]['batch_collectives']} collectives, "
          f"{d[0]['batch_collective_ms']!r} ms of {d[0]['batch_timed_ms']!r} "
          f"({d[0]['batch_collective_ms'] / d[0]['batch_timed_ms']:.1%})")
    print(f"    decode, phase 12's chunk ({GEN_BATCH} clips, bucket {d[0]['decode_bucket']}, "
          f"{QUANT_STEPS - 1} decode steps after 2 warm ones): "
          f"{[x['step_ms'] for x in d]!r} ms per step by rank against one process's "
          f"{depth['step_ms']!r} (phase 12, the {QUANT_STEPS - 1} steps of a {QUANT_STEPS}-token "
          f"run); {TP_TIMED_STEPS} steps more with "
          f"each collective synchronised: {d[0]['step_collectives']!r} collectives and "
          f"{d[0]['step_collective_ms']!r} ms of {d[0]['step_timed_ms']!r} per step "
          f"({d[0]['step_collective_ms'] / d[0]['step_timed_ms']:.1%})")
    print(f"    peak device memory by rank {[x['peak_gib'] for x in d]!r} GiB (weights and the "
          f"decode's caches), one process {depth['peak_gib']!r} GiB (phase 12, its 9 clips)")
    if not all(math.isfinite(x["step_ms"]) and math.isfinite(x["batch_ms"]) for x in d):
        raise AssertionError("(c): a time is not finite")

    launches = {}
    for r in reports:
        w = r["wavlm"]
        for tag, name in (("f32", FLASH["name"]), ("bf16", FLASH_BF16["name"])):
            counts = w[tag]["launches"]
            launches.setdefault(r["rank"], {})[name] = counts[name]
            others = {k: n for k, n in counts.items() if k != name and n}
            if counts[name] != w["layers"] or others:
                raise AssertionError(f"(d) rank {r['rank']} {tag}: launches {counts}, expected "
                                     f"{w['layers']} of {name} alone (one a layer)")
    w = reports[0]["wavlm"]
    print(f"(d) wavlm-large (phase 5's seeded weights) split over {TP_WORLD} ranks, on phase 5's "
          f"{TP_WAVLM_CLIPS} shortest wavs {w['clips_s']!r} s ({w['frames']} frames) in one "
          f"padded batch, against one process on the card:")
    for tag, rule in (("f32", f"rtol {FEAT_RTOL} atol {FEAT_ATOL}, phase 5's"),
                      ("bf16", f"per-frame cosine > {BF16_COS_MIN}, phase 21's")):
        for r in reports:
            x = r["wavlm"][tag]
            print(f"    {tag}, rank {r['rank']}: last hidden state max abs diff "
                  f"{x['last']['max_abs_diff']!r} (max {x['last']['max_abs']!r}, rel L2 "
                  f"{x['last']['rel_l2']!r}, min cos {x['last']['min_cos']!r}); tap -5 "
                  f"{x['tap']['max_abs_diff']!r} (rel L2 {x['tap']['rel_l2']!r}, min cos "
                  f"{x['tap']['min_cos']!r}) ({rule}); flash launches {x['launches']}; the "
                  f"rank's first launch at q {x['flash_shape']} against its plain version max "
                  f"abs err {x['flash_max_abs_err']!r} (held: {x['flash_ok']})")
            if not (x["last"]["ok"] and x["tap"]["ok"] and x["flash_ok"]):
                raise AssertionError(f"(d) rank {r['rank']} {tag}: the split WavLM is not the "
                                     "whole one's")

    for r, n in check_ring(reports, card).items():
        launches[r][FLASH_BLOCK["name"]] = n
    from sdumc_tpu_torch.ops.kernels import flash_wavlm

    return {"launches": launches,
            "block": flash_block_phase(torch, flash_wavlm, reports[0]["ring"]["block_shape"][1])}


# ------------------------------------------- the pipeline, the grid, the hierarchy (phase 30)

PP_WORLD = 4                 # four ranks on the one card, over gloo
PP_HIER = (2, 2)             # (a): dcn x ici
PP_GRID = (2, 2)             # (b): data x model
PP_BATCH, PP_TOKENS, PP_MICRO, PP_TAPS = 16, 64, 4, 1    # (c), at VICUNA_LAYERS over 4 stages
COMBINED_TOKENS = 64         # (b): the text stream's token ids a row
PP_TIMED = 5                 # timed runs of each step and forward, after 2 warm ones
HIER_LOSS_RTOL = 1e-5        # (a): tests/test_hierarchy.py's loss rtol
COMBINED_LOSS_RTOL = 1e-4    # (b): tests/test_hierarchy.py's
COMBINED_LEAF_RTOL, COMBINED_LEAF_ATOL = 1e-3, 1e-5
FIRST_LEAF = "attention_mlp.0.bias"     # JAX's first fusion leaf, the one test_hierarchy.py holds
# (c): PR 17's f32 tensor-parallel difference (PERF.md section 6), against one process's
# forward of the same microbatches (the same GEMM shapes); against its forward of the
# whole batch (other GEMM shapes, so other f32 sums) within PP_TOL of the largest value
PP_TOL = 2.5e-5
TRUNK_SEED = 3               # phase 12's seed


def write_trunk_dir(torch, path: str, num_layers: int, device) -> None:
    """Vicuna-7B's trunk at `num_layers` in HF's format: config.json and
    pytorch_model.bin with the ``model.*`` weights in fp16, normal(0, 0.02)
    drawn on the card from TRUNK_SEED, norms 1 (the loaders read no
    tokenizer and no lm_head for a trunk)."""
    from sdumc_tpu_torch.models.llama import LlamaModel, init_weights

    cfg = feat4_config(torch, num_layers, dtype=torch.float32)
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"], "model_type": "llama",
                   "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                   "intermediate_size": cfg.intermediate_size, "num_hidden_layers": num_layers,
                   "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_heads,
                   "rms_norm_eps": cfg.rms_eps, "rope_theta": cfg.rope_theta,
                   "max_position_embeddings": cfg.max_position_embeddings,
                   "torch_dtype": "float16"}, f)
    with torch.device("meta"):
        trunk = LlamaModel(cfg)
    trunk = init_weights(trunk.to_empty(device=device), seed=TRUNK_SEED)
    torch.save({"model." + k: v.half().cpu() for k, v in trunk.state_dict().items()},
               os.path.join(path, "pytorch_model.bin"))
    del trunk
    torch.cuda.empty_cache()


def combined_batch(torch, cfg, train_ds, device) -> dict:
    """Phase 28's first train batch at the published widths with its text
    stream replaced by COMBINED_TOKENS seeded token ids a row (int32, no
    padding), the text entry of t_max the token batch-max."""
    import numpy as np

    from sdumc_tpu_torch.train.step import batch_to_device_dict

    d = batch_to_device_dict(first_train_batch(cfg, train_ds), device)
    ids = np.random.default_rng(30).integers(0, VICUNA["vocab_size"],
                                             (d["vals"].shape[0], COMBINED_TOKENS))
    d.pop("text")
    d["text_ids"] = torch.from_numpy(ids.astype(np.int32)).to(device)
    ta, _, tv, tf = d["t_max"]
    d["t_max"] = (ta, COMBINED_TOKENS, tv, tf)
    return d


class TimedExchanges:
    """Within it, every ``ModelAxis.exchange`` and ``broadcast`` (the
    pipeline's sends and receives, its last stage's results) is timed on the
    host clock between two synchronisations; ``ms`` lists them (the share is
    of the run's own host clock, which they slow)."""

    def __init__(self, torch):
        self.torch, self.ms = torch, []

    def __enter__(self):
        from sdumc_tpu_torch.parallel.mesh import ModelAxis

        self.saved = ModelAxis.exchange, ModelAxis.broadcast

        def timed(fn):
            def run(axis, *a):
                self.torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(axis, *a)
                self.torch.cuda.synchronize()
                self.ms.append(1e3 * (time.perf_counter() - t))
                return out
            return run

        ModelAxis.exchange, ModelAxis.broadcast = (timed(f) for f in self.saved)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from sdumc_tpu_torch.parallel.mesh import ModelAxis

        self.torch.cuda.synchronize()
        self.wall_ms = 1e3 * (time.perf_counter() - self.t0)
        ModelAxis.exchange, ModelAxis.broadcast = self.saved
        return False


def pp_hierarchy(torch, dev, work: str, keep: dict) -> dict:
    """Phase 30 (a): the first train batch (32 rows, published widths, 8
    rows a rank) through one dropout-off step on the 2 x 2 hierarchical
    axis and on the flat 4-rank axis, each with the launch counters around
    it; rank 0 saves both steps' gradients and takes the single-process
    step (the others at a barrier). Keeps the models and steps for the
    timing in `keep`."""
    import torch.distributed as dist

    from sdumc_tpu_torch.data.pipeline import get_loaders
    from sdumc_tpu_torch.parallel import make_data_axis, make_hierarchical_mesh, shard_batch
    from sdumc_tpu_torch.train.step import batch_to_device_dict

    cfg = main_path_config()
    train_ds, _, _ = get_loaders(cfg.data.dataset, cfg.data, cfg.paths, synthetic=True)
    dims = train_ds.input_dims()
    batch = batch_to_device_dict(first_train_batch(cfg, train_ds), dev)
    hier = make_hierarchical_mesh(dev, *PP_HIER)
    flat = make_data_axis(dev)
    local = shard_batch(batch, hier.rank, hier.world)
    report = {"rows": int(local["vals"].shape[0]), "global_rows": int(batch["vals"].shape[0])}
    for name, axis in (("hier", hier), ("flat", flat)):
        reset_counts()
        model, step, report[f"{name}_loss"], grads = dropout_off_step(torch, cfg, dims, local,
                                                                      axis)
        torch.cuda.synchronize()
        report[f"{name}_launches"] = read_counts()
        if hier.rank == 0:
            torch.save(grads, os.path.join(work, f"{name}_grads.pt"))
        keep[name] = (model, step, axis)
    keep["local"] = local
    if hier.rank == 0:
        _, _, report["single_loss"], grads = dropout_off_step(torch, cfg, dims, batch)
        torch.save(grads, os.path.join(work, "single_grads.pt"))
    dist.barrier()
    keep["cfg"], keep["train_ds"], keep["dims"] = cfg, train_ds, dims
    return report


def pp_combined(torch, dev, work: str, keep: dict) -> dict:
    """Phase 30 (b): Vicuna-7B at VICUNA_LAYERS, f32, read from the
    directory rank 0 wrote (each model rank reading only its slices), as
    the frozen trunk of the combined step on the 2 x 2 grid (TP 2 x DP 2),
    the fusion net at the published widths: one dropout-off step on this
    data rank's 16 rows, the launch counters around it; the largest
    difference of the fusion parameters from the model group's rank 0
    (they must be equal). Rank 0 then takes the TP 1 x DP 1 step on the
    global batch (the others at a barrier), its trunk kept for the
    timing."""
    import torch.distributed as dist

    from sdumc_tpu_torch.convert.hf_llama import load_hf_llama_trunk
    from sdumc_tpu_torch.parallel import make_mesh, make_tp_dp_dual_step, shard_batch

    cfg, dims = keep["cfg"], keep["dims"]
    trunk_dir = os.path.join(work, "trunk")
    data, model_axis = make_mesh(dev, *PP_GRID)
    _, trunk = load_hf_llama_trunk(trunk_dir, device=dev, dtype=torch.float32, axis=model_axis)
    batch = combined_batch(torch, cfg, keep["train_ds"], dev)
    local = shard_batch(batch, data.rank, data.world)
    state = fresh_fusion_state(torch, cfg, dims)
    first = dict(state.model.named_parameters())[FIRST_LEAF].detach().clone()
    step = make_tp_dp_dual_step(trunk, state, cfg.loss, cfg.train.seed, data)
    reset_counts()
    loss = step(local)["loss"].item()
    torch.cuda.synchronize()
    report = {"cell": [data.rank, model_axis.rank], "rows": int(local["vals"].shape[0]),
              "loss": loss, "launches": read_counts(),
              "rank_trunk_gb": sum(p.numel() * p.element_size()
                                   for p in trunk.parameters()) / 1e9}
    leaf = dict(state.model.named_parameters())[FIRST_LEAF].detach()
    report["moved"] = (leaf - first).abs().max().item()
    torch.save(leaf.cpu(), os.path.join(work, f"leaf{dist.get_rank()}.pt"))
    mine = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])
    theirs = model_axis.broadcast(mine.clone(), 0)
    report["group_max_abs_diff"] = (mine - theirs).abs().max().item()
    keep["combined"] = (step, local)
    dist.barrier()
    if dist.get_rank() == 0:
        _, whole = load_hf_llama_trunk(trunk_dir, device=dev, dtype=torch.float32)
        state1 = fresh_fusion_state(torch, cfg, dims)
        step1 = make_tp_dp_dual_step(whole, state1, cfg.loss, cfg.train.seed)
        report["one_loss"] = step1(batch)["loss"].item()
        torch.save(dict(state1.model.named_parameters())[FIRST_LEAF].detach().cpu(),
                   os.path.join(work, "leaf_one.pt"))
        keep["one"] = (whole, step1, batch)
    dist.barrier()
    return report


def last_layer_output(torch, model, ids):
    """(last_hidden_state, the last layer's output before the final norm)
    of one process's forward: the second from a hook on the last layer."""
    seen = []
    hook = model.layers[-1].register_forward_hook(lambda m, a, out: seen.append(out))
    try:
        last = model(input_ids=ids)["last_hidden_state"]
    finally:
        hook.remove()
    return last, seen[0]


def pp_pipeline(torch, dev, work: str, keep: dict) -> dict:
    """Phase 30 (c): the same directory's trunk over 4 stages, each stage
    reading its one layer, the embedding and the final norm: the pipelined
    forward of PP_BATCH x PP_TOKENS seeded ids at M = PP_MICRO with
    PP_TAPS tap; each stage's weights and the forward's peak above them.
    Every stage saves its result; then, the others at a barrier, rank 0
    runs one process's forward (its trunk from (b)) of the whole batch,
    with the same two numbers, and of each microbatch alone."""
    import numpy as np
    import torch.distributed as dist

    from sdumc_tpu_torch.convert.hf_llama import load_hf_llama_trunk
    from sdumc_tpu_torch.parallel import llama_pp_forward, make_model_axis

    stage = make_model_axis(dev, PP_WORLD)
    _, model = load_hf_llama_trunk(os.path.join(work, "trunk"), device=dev, dtype=torch.float32,
                                   stage=stage)
    ids = torch.from_numpy(np.random.default_rng(31).integers(
        0, VICUNA["vocab_size"], (PP_BATCH, PP_TOKENS))).to(dev)

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 2**30

    def pipelined():
        return llama_pp_forward(model, stage, input_ids=ids, n_microbatches=PP_MICRO,
                                collect_taps=PP_TAPS)

    with torch.inference_mode():
        (last, taps), fwd_gib = peak(pipelined)
    held = [p for p in model.parameters() if not p.is_meta]
    report = {"layers": [i for i, layer in enumerate(model.layers)
                         if not layer.mlp.up_proj.weight.is_meta],
              "weights_gib": sum(p.numel() * p.element_size() for p in held) / 2**30,
              "forward_gib": fwd_gib}
    torch.save({"last": last.cpu(), "tap": taps[-1].cpu()},
               os.path.join(work, f"pp{stage.rank}.pt"))
    keep["pipeline"] = (model, stage, ids, pipelined)
    dist.barrier()
    if stage.rank == 0:
        whole = keep["one"][0]
        rows = PP_BATCH // PP_MICRO
        with torch.inference_mode():
            (last1, tap1), one_gib = peak(lambda: last_layer_output(torch, whole, ids))
            parts = [last_layer_output(torch, whole, ids[i:i + rows])
                     for i in range(0, PP_BATCH, rows)]
        torch.save({"last": last1.cpu(), "tap": tap1.cpu()}, os.path.join(work, "pp_one.pt"))
        torch.save({"last": torch.cat([a for a, _ in parts]).cpu(),
                    "tap": torch.cat([b for _, b in parts]).cpu()},
                   os.path.join(work, "pp_one_mb.pt"))
        report.update(one_weights_gib=sum(p.numel() * p.element_size()
                                          for p in whole.parameters()) / 2**30,
                      one_forward_gib=one_gib)
    dist.barrier()
    return report


def pp_timed(torch, keep: dict) -> dict:
    """Phase 30 timed, with nothing else on the card: (a) the hierarchical
    and the flat gradient sums and steps, (b) the combined step, (c) the
    pipelined forward (CUDA events, PP_TIMED runs after 2 warm ones), then
    one more pipelined forward with each exchange and broadcast timed; then,
    the others at a barrier, one process's combined step and forward on
    rank 0."""
    import torch.distributed as dist

    from sdumc_tpu_torch.parallel import reduce_gradients

    report = {}
    for name in ("hier", "flat"):
        model, step, axis = keep[name]
        report[f"{name}_sum_ms"] = time_ms(lambda: reduce_gradients(model.parameters(), axis),
                                           iters=PP_TIMED, warmup=2)
        report[f"{name}_step_ms"] = time_ms(lambda: step(keep["local"]), iters=PP_TIMED,
                                            warmup=2)
    step, local = keep["combined"]
    report["combined_ms"] = time_ms(lambda: step(local), iters=PP_TIMED, warmup=2)
    model, stage, ids, pipelined = keep["pipeline"]
    with torch.inference_mode():
        report["pp_ms"] = time_ms(pipelined, iters=PP_TIMED, warmup=2)
        with TimedExchanges(torch) as timed:
            pipelined()
    report.update(exchanges=len(timed.ms), exchange_ms=sum(timed.ms), exchange_run_ms=timed.wall_ms)
    dist.barrier()
    if dist.get_rank() == 0:
        whole, step1, batch = keep["one"]
        report["one_combined_ms"] = time_ms(lambda: step1(batch), iters=PP_TIMED, warmup=2)
        with torch.inference_mode():
            report["one_pp_ms"] = time_ms(lambda: whole(input_ids=ids), iters=PP_TIMED,
                                          warmup=2)
    dist.barrier()
    return report


def pp_worker(torch, work: str) -> None:
    """One rank of phase 30, started with the SDUMC_* environment beside
    phase 24's runs: (a), rank 0 writing the trunk's directory, (b) and
    (c), after which it writes side{r}.json; then, once the main process
    starts phase 30 (it writes `work`/go), the timed runs; writes
    rank{r}.json. The wait for go fails once the main process has begun no
    phase for TP_GO_SECONDS (it touches `work`/alive at each)."""
    import torch.distributed as dist

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.parallel import initialize_from_env, shutdown

    rank, _ = initialize_from_env(device="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    set_matmul_precision("highest")
    report, keep = {"rank": rank}, {}
    t0 = time.perf_counter()
    report["hier"] = pp_hierarchy(torch, dev, work, keep)
    if rank == 0:
        write_trunk_dir(torch, os.path.join(work, "trunk"), VICUNA_LAYERS, dev)
    dist.barrier()
    report["combined"] = pp_combined(torch, dev, work, keep)
    report["pipeline"] = pp_pipeline(torch, dev, work, keep)
    report["side_seconds"] = time.perf_counter() - t0
    with open(os.path.join(work, f"side{rank}.json"), "w") as f:
        json.dump(report, f, default=float)
    wait_for_go(work, "phase 30")
    t0 = time.perf_counter()
    report["timed"] = pp_timed(torch, keep)
    report["timed_seconds"] = time.perf_counter() - t0
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(report, f, default=float)
    shutdown()


def start_pp_phase(procs, work: str) -> str:
    """Phase 30's work that times nothing, started in `procs` beside phase
    24's runs: its four ranks (``chip_smoke.py --pp-worker``). Returns the
    phase's directory."""
    pp_dir = os.path.join(work, "pp")
    os.makedirs(pp_dir)
    open(os.path.join(pp_dir, "alive"), "w").close()    # main() touches it at each phase
    procs.start_ranks([sys.executable, os.path.abspath(__file__), "--pp-worker", pp_dir],
                      PP_WORLD, env=RANK_ENV, log_dir=pp_dir,
                      cwd=os.path.dirname(os.path.abspath(__file__)))
    return pp_dir


def pp_phase(torch, procs, pp_dir: str, card: str) -> dict:
    """Phase 30: the hierarchical data axis, the combined TP x DP step and
    the pipeline, four ranks on the card over gloo; their untimed parts
    ran beside phase 24 (``start_pp_phase``). Now the ranks time theirs,
    and every part is held, each rank's: (a) the 2 x 2 hierarchical step
    and the flat 4-rank step against the single process, the loss to
    HIER_LOSS_RTOL and every gradient to phase 8's ratio, 3 + 3 fusion
    launches a rank; (b) the combined step at TP 2 x DP 2 against TP 1 x DP
    1, the loss to COMBINED_LOSS_RTOL, FIRST_LEAF to COMBINED_LEAF_RTOL /
    ATOL, the fusion parameters moved and equal in each model group, 3 + 3
    launches a rank; (c) the pipelined last hidden state and tap within
    PP_TOL of one process's forward of the same microbatches, and of its
    forward of the whole batch within PP_TOL of the largest value, each
    stage holding its layer alone. Returns each rank's launches of (a) and
    (b)."""
    open(os.path.join(pp_dir, "go"), "w").close()
    procs.wait(timeout=WAIT_SECONDS["pp ranks"])
    reports = []
    for rank in range(PP_WORLD):
        with open(os.path.join(pp_dir, f"rank{rank}.json")) as f:
            reports.append(json.load(f))
    print("  " + "; ".join(f"rank {r['rank']}: beside phase 24 {r['side_seconds']:.1f} s, here "
                           f"{r['timed_seconds']:.1f} s" for r in reports))
    single = torch.load(os.path.join(pp_dir, "single_grads.pt"))

    def worst_ratio(g):
        if g.keys() != single.keys():
            raise AssertionError("the steps give gradients to different parameters")
        return max(((g[k] - ref).abs().max().item() / (GRAD_RTOL * ref.abs().max().item()
                                                        + GRAD_ATOL), k)
                   for k, ref in single.items())

    def fusion_launches(counts):
        return {name: counts.get(name, 0) for name, _ in REPLACES.values()}

    def three_each(counts):
        return fusion_launches(counts) == {name: 3 for name, _ in REPLACES.values()} and not any(
            n for k, n in counts.items() if k not in fusion_launches(counts))

    h = [r["hier"] for r in reports]
    single_loss = h[0]["single_loss"]
    worst = {name: worst_ratio(torch.load(os.path.join(pp_dir, f"{name}_grads.pt")))
             for name in ("hier", "flat")}
    t = [r["timed"] for r in reports]
    print(f"(a) one train step (dropout off, seeded weights, published widths) on the first "
          f"train batch, {PP_WORLD} ranks x {h[0]['rows']} rows against one process x "
          f"{h[0]['global_rows']}: the {PP_HIER[0]} x {PP_HIER[1]} hierarchical axis (a "
          f"reduce-scatter in each pod of {PP_HIER[1]}, an all-reduce across the pods, an "
          f"all-gather) loss {[x['hier_loss'] for x in h]!r} by rank, the flat 4-rank axis "
          f"{[x['flat_loss'] for x in h]!r}, one process {single_loss!r} (rtol "
          f"{HIER_LOSS_RTOL}); gradients (rank 0), worst max-abs-diff / (GRAD_RTOL max|grad| + "
          f"GRAD_ATOL): hierarchical {worst['hier'][0]!r} at {worst['hier'][1]}, flat "
          f"{worst['flat'][0]!r} at {worst['flat'][1]} (must be <= 1)")
    print(f"    launches a rank, hierarchical step: "
          f"{[fusion_launches(x['hier_launches']) for x in h]}; flat: "
          f"{[fusion_launches(x['flat_launches']) for x in h]}")
    print(f"    timed ({card}; CUDA events, {PP_TIMED} runs after 2 warm ones): the gradient sum "
          f"(12.8M f32) hierarchical {[x['hier_sum_ms'] for x in t]!r} ms by rank, flat "
          f"all_reduce {[x['flat_sum_ms'] for x in t]!r}; the step hierarchical "
          f"{[x['hier_step_ms'] for x in t]!r}, flat {[x['flat_step_ms'] for x in t]!r}. Four "
          f"ranks on one card over gloo show correctness, not scaling.")
    for x in h:
        for name in ("hier", "flat"):
            if abs(x[f"{name}_loss"] - single_loss) > HIER_LOSS_RTOL * abs(single_loss):
                raise AssertionError(f"(a) {name}: the loss is not the single process's")
            if not three_each(x[f"{name}_launches"]):
                raise AssertionError(f"(a) {name}: launches {x[f'{name}_launches']}, expected 3 "
                                     "of each fusion instance and nothing else")
    if max(w for w, _ in worst.values()) > 1.0:
        raise AssertionError("(a): a gradient is not the single process's")

    c = [r["combined"] for r in reports]
    one_loss = c[0]["one_loss"]
    leaf_one = torch.load(os.path.join(pp_dir, "leaf_one.pt"))
    leaves = [torch.load(os.path.join(pp_dir, f"leaf{r}.pt")) for r in range(PP_WORLD)]
    leaf_err = [(x - leaf_one).abs().max().item() for x in leaves]
    leaf_ok = [torch.allclose(x, leaf_one, rtol=COMBINED_LEAF_RTOL, atol=COMBINED_LEAF_ATOL)
               for x in leaves]
    print(f"(b) the combined step on the {PP_GRID[0]} x {PP_GRID[1]} grid (TP {PP_GRID[1]} x DP "
          f"{PP_GRID[0]}): Vicuna-7B at {VICUNA_LAYERS} of {VICUNA_FULL_LAYERS} layers, f32, "
          f"read from HF's format (each model rank its slices, {c[0]['rank_trunk_gb']!r} GB), "
          f"frozen, its -4..-1 tap sum the text stream of {COMBINED_TOKENS} token ids a row; the "
          f"fusion net at the published widths, one dropout-off step on {c[0]['rows']} rows a "
          f"data rank, against one process (TP 1 x DP 1) on the {2 * c[0]['rows']} rows: loss "
          f"{[x['loss'] for x in c]!r} by rank (cells {[x['cell'] for x in c]}), one process "
          f"{one_loss!r} (rtol {COMBINED_LOSS_RTOL}); {FIRST_LEAF} max abs diff {leaf_err!r} "
          f"(rtol {COMBINED_LEAF_RTOL} atol {COMBINED_LEAF_ATOL}: {leaf_ok}); moved "
          f"{[x['moved'] for x in c]!r}; the fusion parameters' largest difference from the "
          f"model group's rank 0 {[x['group_max_abs_diff'] for x in c]!r} (must be 0)")
    print(f"    launches a rank: {[fusion_launches(x['launches']) for x in c]}; timed: the step "
          f"{[x['combined_ms'] for x in t]!r} ms by rank, one process {t[0]['one_combined_ms']!r} "
          f"ms (rank 0 alone) ({card})")
    for x, ok in zip(c, leaf_ok):
        if abs(x["loss"] - one_loss) > COMBINED_LOSS_RTOL * abs(one_loss) or not ok:
            raise AssertionError(f"(b) cell {x['cell']}: the combined step is not one process's")
        if not x["moved"] > 1e-6 or x["group_max_abs_diff"] != 0.0:
            raise AssertionError(f"(b) cell {x['cell']}: the fusion parameters did not move, or "
                                 "differ within a model group")
        if not three_each(x["launches"]):
            raise AssertionError(f"(b) cell {x['cell']}: launches {x['launches']}, expected 3 of "
                                 "each fusion instance and nothing else")

    p = [r["pipeline"] for r in reports]
    one = torch.load(os.path.join(pp_dir, "pp_one.pt"))
    one_mb = torch.load(os.path.join(pp_dir, "pp_one_mb.pt"))
    top = {k: one[k].abs().max().item() for k in ("last", "tap")}
    errs, errs_mb = [], []
    for rank in range(PP_WORLD):
        got = torch.load(os.path.join(pp_dir, f"pp{rank}.pt"))
        errs_mb.append({k: (got[k] - one_mb[k]).abs().max().item() for k in ("last", "tap")})
        errs.append({k: (got[k] - one[k]).abs().max().item() for k in ("last", "tap")})
        ok = (all(torch.allclose(got[k], one_mb[k], rtol=PP_TOL, atol=PP_TOL)
                  for k in ("last", "tap"))
              and all(errs[-1][k] <= PP_TOL * top[k] for k in ("last", "tap")))
        if not ok or p[rank]["layers"] != [rank]:
            raise AssertionError(f"(c) stage {rank}: layers {p[rank]['layers']}, differences "
                                 f"{errs_mb[-1]} / {errs[-1]}: the pipeline is not one "
                                 "process's forward")
    print(f"(c) the same trunk over {PP_WORLD} stages (stage s reading layer s, the embedding "
          f"and the final norm), {PP_BATCH} x {PP_TOKENS} token ids, M = {PP_MICRO}, "
          f"collect_taps {PP_TAPS} (f32, TF32 off): max abs diff by stage against one process's "
          f"forward of the same {PP_MICRO} microbatches {errs_mb!r} (rtol = atol = {PP_TOL}); "
          f"against its forward of the whole batch {errs!r} (largest |value| {top!r}; within "
          f"{PP_TOL} of it)")
    print(f"    timed ({card}): the pipelined forward {[x['pp_ms'] for x in t]!r} ms by stage "
          f"(CUDA events), one process {t[0]['one_pp_ms']!r}; once more with each exchange and "
          f"broadcast synchronised: {t[0]['exchanges']} of them, {t[0]['exchange_ms']!r} ms of "
          f"{t[0]['exchange_run_ms']!r} ({t[0]['exchange_ms'] / t[0]['exchange_run_ms']:.1%}; "
          f"stage {PP_WORLD - 1}: {t[-1]['exchange_ms'] / t[-1]['exchange_run_ms']:.1%})")
    print(f"    memory by stage: weights {[x['weights_gib'] for x in p]!r} GiB, the forward's "
          f"peak above them {[x['forward_gib'] for x in p]!r}; one process: weights "
          f"{p[0]['one_weights_gib']!r} GiB, forward {p[0]['one_forward_gib']!r}")
    if not all(math.isfinite(x) for x in [*(y["pp_ms"] for y in t), t[0]["one_pp_ms"],
                                          *(y["combined_ms"] for y in t),
                                          t[0]["one_combined_ms"]]):
        raise AssertionError("phase 30: a time is not finite")
    return {r["rank"]: {"hierarchical": fusion_launches(r["hier"]["hier_launches"]),
                        "combined": fusion_launches(r["combined"]["launches"])}
            for r in reports}


def pp_only(torch) -> None:
    """``chip_smoke.py --pp-only``: phase 30 alone, from its own inputs (the
    synthetic store, its own trunk directory), its side work and timed part
    run back to back."""
    from sdumc_tpu_torch.parallel.multihost import LocalProcesses

    card = card_line()
    with tempfile.TemporaryDirectory() as work:
        with LocalProcesses() as procs:
            pp_dir = start_pp_phase(procs, work)
            t0 = time.perf_counter()
            procs.wait(until=lambda: all(os.path.exists(os.path.join(pp_dir, f"side{r}.json"))
                                         for r in range(PP_WORLD)),
                       timeout=WAIT_SECONDS["pp side"])
            print(f"phase 30's untimed work: {time.perf_counter() - t0!r} s")
            t0 = time.perf_counter()
            print(pp_phase(torch, procs, pp_dir, card))
            print(f"phase 30: {time.perf_counter() - t0!r} s")


def dp_only(torch) -> None:
    """``chip_smoke.py --dp-only``: phase 28 alone, its side work and timed
    part back to back, without phases 7, 9 and 24's single-process runs to
    compare with."""
    from sdumc_tpu_torch.parallel.multihost import LocalProcesses

    card = card_line()
    with tempfile.TemporaryDirectory() as work:
        with LocalProcesses() as procs:
            t0 = time.perf_counter()
            dp_dir = start_dp_phase(procs, work)
            procs.wait(until=lambda: all(os.path.exists(os.path.join(dp_dir, f"side{r}.json"))
                                         for r in range(DP_WORLD)),
                       timeout=WAIT_SECONDS["dp side"])
            print(f"phase 28's untimed work: {time.perf_counter() - t0!r} s")
            t0 = time.perf_counter()
            dp_phase(torch, procs, dp_dir, None, None, {}, card)
            print(f"phase 28: {time.perf_counter() - t0!r} s")


def kernels_only(torch, root: str, lengths: dict) -> dict:
    """Phases 2-3, 17 and 19 (without the gradient checks) with the kernels
    of the checkout at `root`, built from its own sources into its own
    build/kernels/, each held to that checkout's own plain versions, and
    phase 9's warm train step on that checkout's package; per-kernel
    totals and the step's ms."""
    sys.path.insert(0, os.path.abspath(root))
    from sdumc_tpu_torch.ops.kernels import build, flash_wavlm, fused_cross, fused_pool

    build.build()
    totals = kernel_phase(torch, fused_cross, fused_pool, lengths, grads=False)
    flash = flash_phase(torch, flash_wavlm)
    bf16 = kernel_phase(torch, fused_cross, fused_pool, lengths, grads=False, bf16=True)
    return {REPLACES[7][0]: totals[7], REPLACES[1][0]: totals[1], FLASH["name"]: flash,
            REPLACES_BF16[7][0]: bf16[7], REPLACES_BF16[1][0]: bf16[1],
            FLASH_BF16["name"]: flash_bf16_phase(torch, flash_wavlm, flash),
            "train_step_ms": step_timing_phase(torch, extras=False)}


def ab_phase(other: str) -> None:
    """Phases 2-3, 9, 17 and 19 for OTHER's checkout and this one, each in
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
    print("train step (phase 9, ms) " + "  ".join(
        f"{label}={res['train_step_ms']!r}" for label, res in runs))
    print(json.dumps({"ab": [{"run": label, **res} for label, res in runs]}))


def formula_flops(lengths, block_shape) -> dict:
    """{kernel name: the flops its op's formula counts (registered beside
    the op in ops/kernels/*.py) over the calls its row of the kernel line
    times}: the three modality calls of one dual batch for the fusion rows,
    FLASH_SHAPES for the WavLM rows, one call at `block_shape` (B, T) for the
    block instance."""
    from sdumc_tpu_torch.ops.kernels.flash_wavlm import flash_wavlm_flops
    from sdumc_tpu_torch.ops.kernels.fused_cross import fused_cross_flops

    out = {}
    for q_count in REPLACES:
        n = sum(fused_cross_flops((B_DUAL, q_count, D), (B_DUAL, T, D), (D, D),
                                  out_val=(B_DUAL, q_count, D)) for T, _ in lengths.values())
        out[REPLACES[q_count][0]] = out[REPLACES_BF16[q_count][0]] = n

    def flash(B, T):
        shape = (B, T, FLASH_H, FLASH_HD)
        return flash_wavlm_flops(shape, shape, shape)

    out[FLASH["name"]] = out[FLASH_BF16["name"]] = sum(flash(B, T) for B, T in FLASH_SHAPES)
    out[FLASH_BLOCK["name"]] = flash(*block_shape)
    return out


def start_kernel_build():
    """``ops/kernels/build.py`` as a script, started before this process
    imports torch (the build imports only the standard library): the
    kernels compile while torch and the card start up. None where the
    checkout has no kernels to build."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sdumc_tpu_torch", "ops",
                          "kernels", "build.py")
    if not os.path.exists(script):
        return None
    return subprocess.Popen([sys.executable, script], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_kernel_build(proc) -> dict:
    """``build()``'s report from ``start_kernel_build``'s process, within
    WAIT_SECONDS["kernel build"]; raises if it failed or ran past it."""
    try:
        out, err = proc.communicate(timeout=WAIT_SECONDS["kernel build"])
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"the kernel build ran past its bound of "
                           f"{WAIT_SECONDS['kernel build']} s") from None
    if proc.returncode:
        raise RuntimeError(f"the kernel build failed:\n{err[-4000:]}")
    return json.loads(out)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ab", metavar="OTHER",
                        help="time phases 2-3, 9, 17 and 19 against OTHER's checkout")
    parser.add_argument("--kernels-from", help=argparse.SUPPRESS)
    parser.add_argument("--lengths", help=argparse.SUPPRESS)
    parser.add_argument("--serve", help=argparse.SUPPRESS)
    parser.add_argument("--serve-out", help=argparse.SUPPRESS)
    parser.add_argument("--serve-decode", help=argparse.SUPPRESS)
    parser.add_argument("--dp-worker", help=argparse.SUPPRESS)
    parser.add_argument("--tp-worker", help=argparse.SUPPRESS)
    parser.add_argument("--pp-worker", help=argparse.SUPPRESS)
    parser.add_argument("--pp-only", action="store_true",
                        help="phase 30 alone, from its own inputs")
    parser.add_argument("--dp-only", action="store_true",
                        help="phase 28 alone, from its own inputs")
    parser.add_argument("--tp-cli", type=int, metavar="N",
                        help="phase 29 (a) alone: cli.extract text and feat4 at --tp N against "
                             "--tp 1 (one rank a card: NCCL)")
    args = parser.parse_args()
    main_run = not any((args.ab, args.kernels_from, args.serve, args.serve_decode,
                        args.dp_worker, args.tp_worker, args.tp_cli, args.pp_worker,
                        args.pp_only, args.dp_only))
    building = start_kernel_build() if main_run else None
    import torch

    sys.stdout.reconfigure(line_buffering=True)    # a watchdog's exit loses no printed line
    if not torch.cuda.is_available():
        if building is not None:
            building.kill()
            building.communicate()
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.kernels_from:
        lengths = {m: tuple(v) for m, v in json.loads(args.lengths).items()}
        print(json.dumps(kernels_only(torch, args.kernels_from, lengths)))
        return 0
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.serve:
        serve_worker(torch, args.serve, args.serve_out)
        return 0
    if args.serve_decode:
        decode_serve_worker(torch, args.serve_decode, args.serve_out)
        return 0
    if args.dp_worker:
        dp_worker(torch, args.dp_worker)
        return 0
    if args.tp_worker:
        tp_worker(torch, args.tp_worker)
        return 0
    if args.pp_worker:
        pp_worker(torch, args.pp_worker)
        return 0
    if args.pp_only:
        from sdumc_tpu_torch.ops.kernels import build

        print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        build.build()
        pp_only(torch)
        return 0
    if args.dp_only:
        print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        dp_only(torch)
        return 0
    if args.tp_cli:
        print(f"card: {card_line()} x {torch.cuda.device_count()}; torch {torch.__version__}")
        tp_cli_only(torch, args.tp_cli)
        return 0
    if args.ab:
        print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        ab_phase(args.ab)
        print(card_line())
        return 0
    from sdumc_tpu_torch.ops.kernels import build, flash_wavlm, fused_cross, fused_pool
    from sdumc_tpu_torch.parallel.multihost import LocalProcesses

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    report = finish_kernel_build(building) if building is not None else build.build()
    build_s = max((rep["seconds"] for rep in report.values()), default=0.0)
    print(f"kernel build: {build_s!r} s for {sorted(report) or 'cached'}, begun before torch's "
          f"import, ready {time.perf_counter() - T_START!r} s after the start")
    if "sdumc_data" in report:
        print(f"the data plane's library (g++): built in {report['sdumc_data']['seconds']!r} s")
    for name, rep in report.items():
        compiler = "g++" if name in build.HOST_SOURCES else "nvcc"
        print(f"--- {compiler} {name} ---\n{rep['log'].strip()}")

    seconds, heartbeats = {}, []

    def phase(n: int, fn, *a):
        for path in heartbeats:                 # phase 29's ranks wait on these
            os.utime(path)
        left = SCRIPT_DEADLINE - (time.perf_counter() - T_START)
        bound = max(1.0, min(left, max(PHASE_MIN_BOUND, 3 * PHASE_BUDGET[n])))
        print(f"phase {n} ({fn.__name__}) starts; its watchdog fires at {bound:.0f} s")
        faulthandler.dump_traceback_later(bound, exit=True)
        t = time.perf_counter()
        try:
            result = fn(*a)
        except BaseException:
            print(f"phase {n} ({fn.__name__}) failed after {time.perf_counter() - t!r} s",
                  file=sys.stderr)
            raise
        finally:
            faulthandler.cancel_dump_traceback_later()
        seconds[n] = time.perf_counter() - t
        print(f"phase {n} ({fn.__name__}): {seconds[n]!r} s")
        return result

    lengths = main_path_lengths(main_path_config())
    t_phases = time.perf_counter()
    totals = phase(2, kernel_phase, torch, fused_cross, fused_pool, lengths)
    flash = phase(3, flash_phase, torch, flash_wavlm)
    infer_launches = phase(4, main_path_phase, torch, fused_cross)
    with tempfile.TemporaryDirectory() as work:
        extract_counts, feats_dir, f32_rate = phase(5, extraction_phase, torch, flash_wavlm,
                                                     work)
        launches, history = phase(7, training_phase, torch, fused_cross,
                                  os.path.join(work, "train"))
        phase(8, step_parity_phase, torch)
        step_ms = phase(9, step_timing_phase, torch, card)
        phase(10, llama_parity_phase, torch)
        llm_dir, proj_path = phase(11, feat4_cli_phase, torch, work, feats_dir)
        depth = phase(12, full_depth_phase, torch, llm_dir, proj_path, feats_dir)
        rows = phase(13, text_cli_phase, torch, work, llm_dir)
        text_depth = phase(14, text_full_depth_phase, torch, llm_dir, rows)
        phase(15, visual_phase, torch, work)
        phase(16, manet_train_phase, torch, work)
        bf16_totals = phase(17, bf16_kernel_phase, torch, fused_cross, fused_pool, lengths, totals)
        store_launches = phase(18, store_phase, torch, fused_cross, work)
        flash_bf16 = phase(19, flash_bf16_phase, torch, flash_wavlm, flash)
        phase(20, flash_grad_phase, torch, flash_wavlm)
        bf16_counts = phase(21, bf16_extraction_phase, torch, work, feats_dir, f32_rate)
        phase(22, asr_phase, torch, work, llm_dir)
        phase(23, vision_phase, torch, work, card)
        # phases 28, 29 and 30's work that times nothing, beside phase 24's
        with LocalProcesses() as tp_procs, LocalProcesses() as pp_procs, \
                LocalProcesses() as dp_procs:
            tp_dir, tp_clis = start_tp_phase(tp_procs, work, llm_dir, proj_path, feats_dir)
            pp_dir = start_pp_phase(pp_procs, work)
            dp_started = time.perf_counter()
            dp_dir = start_dp_phase(dp_procs, work)
            heartbeats.extend(os.path.join(d, "alive") for d in (tp_dir, pp_dir, dp_dir))
            zoo = phase(24, baseline_phase, torch, work, card,
                        lambda: wait_side(tp_procs, tp_dir, tp_clis, pp_procs, pp_dir,
                                          dp_procs, dp_dir, dp_started))
            phase(25, text_families_phase, torch, work, rows)
            served = phase(26, serve_phase, torch, work,
                           os.path.join(work, "train", "best_full.pt"), card)
            phase(27, decode_serve_phase, torch, work, llm_dir, card)
            dp_launches = phase(28, dp_phase, torch, dp_procs, dp_dir, history[0], step_ms, zoo,
                                card)
            tp = phase(29, tp_phase, torch, tp_procs, tp_dir, work, depth, text_depth, card)
            pp_launches = phase(30, pp_phase, torch, pp_procs, pp_dir, card)
    tp_launches, block = tp["launches"], tp["block"]
    print(f"phases 2-30: {time.perf_counter() - t_phases!r} s")

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
          f"{ {REPLACES[q][0]: n for q, n in infer_launches.items()} }; a request served "
          "from cli.export's bundle, phase 26: "
          f"{ {REPLACES[q][0]: n for q, n in served.items()} }; each rank of cli.train "
          "--multihost over 2 processes, phase 28: "
          f"{ {r: {REPLACES[int(q)][0]: n for q, n in c.items()} for r, c in dp_launches.items()} }"
          "; each rank of one step on the 2 x 2 hierarchical axis and of one combined TP 2 x DP 2 "
          f"step over 4 processes, phase 30: {pp_launches}"
          "), cli.extract audio "
          "for flash_wavlm, cli.train --feature_dtype bfloat16 on the bf16 store for the "
          "bf16 instances (the int8 store's run: "
          f"{ {REPLACES_BF16[q][0]: n for q, n in store_launches['int8'].items()} }), "
          "cli.extract audio --dtype bfloat16 for flash_wavlm_bf16 (its library_ms: bf16 SDPA "
          "with a materialised bf16 mask; each rank of wavlm-large split over 2 processes, "
          "8 heads a rank, one batch, phase 29: "
          f"{tp_launches}); max_abs_err is "
          "the forward's against the plain version")
    kernels.append({
        **FLASH_BLOCK, "route": "cuda", "launches": tp_launches[0][FLASH_BLOCK["name"]],
        "max_abs_err": block["max_abs_err"], "ms": block["ms"], "plain_ms": block["plain_ms"],
        "bound_ms": block["bound_ms"],
        "bound_by": "operations" if block["operations_ms"] >= block["bytes_ms"] else "bytes",
        "library_ms": block["library_ms"],
    })
    print("flash_wavlm_block (the f32 instance that also writes each row's log-sum-exp, ring "
          "attention's step) is timed at the ring's shape, one call (phase 29); its launches "
          "are rank 0's in wavlm_forward_sp of the 60-s clip over 2 processes at f32 (phase 29 "
          f"(e); each rank's: { {r: c[FLASH_BLOCK['name']] for r, c in tp_launches.items()} }); "
          "its library_ms is aten._scaled_dot_product_efficient_attention with "
          "compute_log_sumexp on the materialised f32 bias, or null where it raises")
    formula = formula_flops(lengths, block["shape"])
    print("formula_flops: each custom op's flop formula (ops/kernels/*.py, the padded "
          "bucket, as program_cost counts the op) summed over the row's calls; bound_flops: "
          "the operations behind bound_ms (the valid frames or keys only; the fusion rows' "
          "key projection among them, run as 3 TF32 or bf16 passes)")
    for name, tot in ((REPLACES[7][0], totals[7]), (REPLACES[1][0], totals[1]),
                      (FLASH["name"], flash), (REPLACES_BF16[7][0], bf16_totals[7]),
                      (REPLACES_BF16[1][0], bf16_totals[1]), (FLASH_BF16["name"], flash_bf16),
                      (FLASH_BLOCK["name"], block)):
        print(f"{name}: kernel_ms={tot['ms']!r} device_ms={tot['device_ms']!r} "
              f"grad_max_abs_err={tot.get('grad_max_abs_err')!r} "
              f"bound_ms={tot['bound_ms']!r} ({tot['ms'] and tot['bound_ms'] / tot['ms']:.1%} "
              f"of it) f32_bound_ms={tot.get('f32_bound_ms')!r} "
              f"formula_flops={formula[name]!r} bound_flops={tot['bound_flops']!r}")
    total = time.perf_counter() - T_START
    print(json.dumps({"phase_seconds": {str(n): round(t, 2) for n, t in sorted(seconds.items())},
                      "budget_seconds": {str(n): PHASE_BUDGET[n] for n in sorted(seconds)},
                      "kernel_build_seconds": round(build_s, 2),
                      "whole_script_seconds": round(total, 2)}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
