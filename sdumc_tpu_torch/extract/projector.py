"""WavLM -> LLM embedding-space projector (the SDUMC bridge).

The port of ``sdumc_tpu/extract/projector.py``. Reference
``EncoderProjectorConcat`` (extract_wavlm_vicuna.py:160-184): stack k=5
adjacent WavLM frames (the remainder is dropped), then Linear(5*1024 ->
2048) -> ReLU -> Linear(2048 -> 4096), loaded frozen from the released
``WalmL2VicunaV1.5_model.pt`` (:190-196). Runs in f32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

PREFIX = "encoder_projector."


class EncoderProjectorConcat(nn.Module):
    def __init__(self, k: int = 5, encoder_dim: int = 1024, hidden_dim: int = 2048,
                 llm_dim: int = 4096, device=None):
        super().__init__()
        self.k = k
        self.linear1 = nn.Linear(encoder_dim * k, hidden_dim, device=device)
        self.linear2 = nn.Linear(hidden_dim, llm_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, encoder_dim] -> [B, T // k, llm_dim]."""
        b, t, d = x.shape
        t = (t // self.k) * self.k
        x = x[:, :t].reshape(b, t // self.k, d * self.k)
        return self.linear2(torch.relu(self.linear1(x)))


def projector_from_state_dict(state_dict: Dict[str, torch.Tensor], k: int = 5,
                              device=None) -> EncoderProjectorConcat:
    """The projector from a released-style state dict (keys possibly
    prefixed ``encoder_projector.``, extract_wavlm_vicuna.py:192-193); the
    widths come from the weights. f32, eval mode."""
    sd = {key[len(PREFIX):] if key.startswith(PREFIX) else key: v.float()
          for key, v in state_dict.items()}
    hidden, enc_k = sd["linear1.weight"].shape
    with torch.device("meta"):
        proj = EncoderProjectorConcat(k, enc_k // k, hidden, sd["linear2.weight"].shape[0])
    proj.load_state_dict({n: t.to(device) for n, t in sd.items()}, strict=True, assign=True)
    return proj.eval()


def load_projector(path: str, device=None) -> EncoderProjectorConcat:
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return projector_from_state_dict(blob, device=device)


def projector_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX projector's params ({linear1, linear2} x {kernel, bias}) as
    the port's state dict (Dense kernel [in, out] -> Linear weight [out, in])."""
    out = {}
    for name in ("linear1", "linear2"):
        out[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(params[name]["kernel"], np.float32).T))
        out[f"{name}.bias"] = torch.from_numpy(np.asarray(params[name]["bias"], np.float32).copy())
    return out
