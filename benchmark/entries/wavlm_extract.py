"""WavLM feature extraction, as ``cli.extract audio`` runs it, in a closed
loop of requests: each request is one call of ``extract_audio_features``
over a list of waves (normalised, sorted and batched by the call itself,
the tap -5 summed, one [T, 1024] array a wave returned on the host); the
next request is issued when it returns.

Set-up builds the model on the card with the seeded weights and runs one
request of the cell's sizes, which warms every shape the window uses (each
request holds the same durations in another order). The check runs the
plain reference (``reference/wavlm.py``) on a sample of the waves returned
in the window, drawn from the seed, the longest of each request in it, one
clip at a time at its own length, and compares each clip's frames.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.counts import wavlm as counts
from benchmark.lib import seeds, traffic, weights
from benchmark.lib.runner import Window
from benchmark.reference import wavlm as ref
from benchmark.reference.precision import Precision, true_f32

# faults planted in the timed path for the tests and the calibration:
# the longest wave's answer altered (its first frame zeroed); the longer half of the waves left out
# and answered with the shorter half's answers
FAULTS = ("altered_answer", "half_batch")


def model_config(cfg: Dict):
    from sdumc_tpu_torch.models.wavlm import WavLMConfig

    return WavLMConfig(
        hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"], intermediate_size=cfg["intermediate_size"],
        conv_dim=tuple(cfg["conv_dim"]), conv_kernel=tuple(cfg["conv_kernel"]),
        conv_stride=tuple(cfg["conv_stride"]), conv_bias=cfg["conv_bias"],
        feat_extract_norm=cfg["feat_extract_norm"],
        do_stable_layer_norm=cfg["do_stable_layer_norm"],
        num_conv_pos_embeddings=cfg["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=cfg["num_conv_pos_embedding_groups"],
        num_buckets=cfg["num_buckets"], max_bucket_distance=cfg["max_bucket_distance"],
        layer_norm_eps=cfg["layer_norm_eps"], attention_impl="auto")


class Job:
    def __init__(self, cfg: Dict, cell: Dict, seed: int, device, spans, fault: Optional[str] = None):
        from sdumc_tpu_torch.cli.common import set_matmul_precision
        from sdumc_tpu_torch.models.wavlm import WavLMModel

        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.cell, self.seed, self.fault = cfg, cell, seed, fault
        self.device, self.spans = torch.device(device), spans
        self.params = cell["traffic_params"]
        self.limits = cell["check"]
        self.tap_layers = counts.tap_layers(cfg, cfg["tap"])
        set_matmul_precision("highest")
        self.mcfg = model_config(cfg)
        with torch.device("meta"):
            model = WavLMModel(self.mcfg)
        model.load_state_dict(self._weights(), assign=True)
        self.program = model.eval()
        self.pool = traffic.wave_pool(self.params, seed, self.device)
        self.request = 0
        self.kept: List = []            # (wave's (start, length), the program's frames)
        self._extract(self._next_request())

    def _weights(self):
        return weights.state_dict(ref.weight_layout(self.cfg), seeds.derive(self.seed, "weights"),
                                  self.device)

    def _next_request(self):
        req = traffic.wave_requests(self.params, seeds.derive(self.seed, "r", self.request), 1)[0]
        self.request += 1
        return req

    def _extract(self, request):
        from sdumc_tpu_torch.extract.audio import extract_audio_features

        with self.spans("prep"):
            waves = traffic.waves_of(self.pool, request)
            by_length = np.argsort([len(w) for w in waves], kind="stable")
            if self.fault == "half_batch":
                short = by_length[: len(waves) // 2]
                waves = [waves[short[i % len(short)]] for i in range(len(waves))]
        with self.spans("extract"):
            feats = extract_audio_features(self.program, self.mcfg, waves,
                                           layer_ids=(self.cfg["tap"],),
                                           feature_level=self.cfg["feature_level"],
                                           batch_size=self.params["batch_size"],
                                           device=self.device)
        if self.fault == "altered_answer":
            i = by_length[-1]
            feats[i] = feats[i].copy()
            feats[i][0] = 0.0
        return feats

    def window(self, seconds: float) -> Window:
        rate = self.params["sample_rate"]
        audio_s, requests, failed, flops = 0.0, 0, 0, 0.0
        kf, kb = 0.0, 0.0
        t0 = time.perf_counter()
        while True:
            request = self._next_request()
            feats = self._extract(request)
            requests += 1
            if len(feats) != len(request):
                failed += 1
            audio_s += sum(n for _, n in request) / rate
            frames = [counts.frames(self.cfg, n) for _, n in request]
            flops += sum(counts.clip_flops(self.cfg, n, self.tap_layers) for _, n in request)
            f, b = counts.attention_call(self.cfg, frames)
            kf += f * self.cfg["num_hidden_layers"]
            kb += b * self.cfg["num_hidden_layers"]
            self._keep(request, feats)
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        return Window(seconds=elapsed, e2e={"audio_s_per_s": audio_s / elapsed},
                      attempted=requests, failed=failed, flops=flops,
                      kernel_work={"flash_wavlm": (kf, kb)}, steps=requests)

    def _keep(self, request, feats) -> None:
        """Keeps the longest wave's frames and one drawn from the seed."""
        longest = int(np.argmax([n for _, n in request]))
        drawn = int(seeds.rng(self.seed, "keep", self.request).integers(len(request)))
        for i in sorted({longest, drawn}):
            if i < len(feats):
                self.kept.append((request[i], feats[i]))

    def release(self) -> None:
        self.program = None

    def check(self) -> List:
        """(name, reading, limit): the worst sampled clip's relative error."""
        return [("feat_rel_err", self.readings(Precision("f32")), self.limits["feat_rel_err"])]

    def control(self) -> Dict[str, float]:
        """The reading of the reference at TF32 in the program's place."""
        params = self._weights()
        got = []
        for wave, _ in self._sample():
            with true_f32():
                got.append(ref.forward_tap(params, self.cfg, self._wave(wave), Precision("tf32"),
                                           self.tap_layers).cpu().numpy())
        del params
        return {"feat_rel_err": self.readings(Precision("f32"), got)}

    def _sample(self):
        n = self.cell["check_clips"]
        if len(self.kept) <= n:
            return self.kept
        longest = int(np.argmax([w[1] for w, _ in self.kept]))
        rest = [i for i in range(len(self.kept)) if i != longest]
        drawn = seeds.rng(self.seed, "sample").choice(rest, n - 1, replace=False)
        return [self.kept[i] for i in sorted([longest, *drawn.tolist()])]

    def _wave(self, wave) -> np.ndarray:
        start, n = wave
        return self.pool[start: start + n]

    def readings(self, pr: Precision, got: Optional[List[np.ndarray]] = None) -> float:
        """max over the sample of |got - reference|_F / |reference|_F, each
        clip's frames; a clip of the wrong frame count reads inf."""
        sample = self._sample()
        params = self._weights()
        worst = 0.0
        with true_f32():
            for j, (wave, feats) in enumerate(sample):
                want = ref.forward_tap(params, self.cfg, self._wave(wave), pr,
                                       self.tap_layers).cpu().numpy()
                have = feats if got is None else got[j]
                if have.shape != want.shape:
                    return float("inf")
                err = np.linalg.norm(have - want) / np.linalg.norm(want)
                worst = max(worst, float(err))
        return worst
