"""Whisper's log-mel spectrogram, the port of ``sdumc_tpu/ops/mel.py``.

The recipe Whisper checkpoints were trained with (HF's
``WhisperFeatureExtractor``): 16 kHz audio padded or trimmed to the 30-s
window, a reflect-centred 400-point Hann STFT at hop 160 (the last frame
dropped), the Slaney-scale, Slaney-normalised mel filterbank, then
``log10(max(mel, 1e-10))`` compressed to ``(max(log, max - 8) + 4) / 4``
per clip. The filters are built in float64 with numpy, as JAX's are; the
STFT runs as one ``torch.fft.rfft`` over the framed audio on the run
device, in f32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
CHUNK_SECONDS = 30


def _hz_to_mel(f):
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3)
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / (200.0 / 3))


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    min_log_mel = 1000.0 / (200.0 / 3)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    1000.0 * np.exp(logstep * (m - min_log_mel)),
                    m * (200.0 / 3))


@functools.lru_cache(maxsize=4)
def mel_filters(n_mels: int = 80, n_fft: int = N_FFT, sr: int = SAMPLE_RATE) -> np.ndarray:
    """[n_mels, n_fft // 2 + 1] f32 Slaney-normalised triangular filterbank
    (fmin 0, fmax sr / 2), the table HF ships inside its extractor."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    lower, center, upper = hz_pts[:-2], hz_pts[1:-1], hz_pts[2:]
    up = (fft_freqs[None, :] - lower[:, None]) / (center - lower)[:, None]
    down = (upper[:, None] - fft_freqs[None, :]) / (upper - center)[:, None]
    fb = np.maximum(0.0, np.minimum(up, down))
    fb *= (2.0 / (upper - lower))[:, None]      # Slaney norm: constant energy per channel
    return fb.astype(np.float32)


def log_mel_spectrogram(audio, n_mels: int = 80, pad_to_chunk: bool = True,
                        device=None) -> torch.Tensor:
    """audio [S] or [B, S] (numpy or torch) at 16 kHz -> f32 [.., n_mels,
    frames] on ``device`` (default: the audio's, the CPU for numpy), HF's
    layout. ``pad_to_chunk`` zero-pads or trims to the 30-s window first."""
    x = torch.as_tensor(audio, dtype=torch.float32, device=device)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    if pad_to_chunk:
        target = CHUNK_SECONDS * SAMPLE_RATE
        x = x[:, :target] if x.shape[1] >= target else torch.nn.functional.pad(
            x, (0, target - x.shape[1]))
    half = N_FFT // 2
    xp = torch.nn.functional.pad(x[:, None], (half, half), mode="reflect")[:, 0]
    frames = xp.unfold(1, N_FFT, HOP)                                # [B, F, 400]
    window = torch.from_numpy(np.hanning(N_FFT + 1)[:-1].astype(np.float32)).to(x.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec[:, :-1].abs() ** 2                                  # drop the last frame
    fb = torch.from_numpy(mel_filters(n_mels)).to(x.device)
    mel = torch.einsum("mf,btf->bmt", fb, power)
    log_spec = torch.log10(mel.clamp(min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    out = (log_spec + 4.0) / 4.0
    return out[0] if squeeze else out
