"""An HF-format Whisper directory -> the port's WhisperModel and its
generation settings, without ``transformers``.

The port of ``sdumc_tpu/convert/hf_whisper.py``: ``config.json`` and
``generation_config.json`` are read with ``json``, the weights through
``convert/safetensors_io.py`` (``pytorch_model.bin`` with ``torch.load``,
``model.safetensors`` with the port's own reader, or either's shards).
WhisperForConditionalGeneration's keys lose their ``model.`` prefix;
``proj_out`` is the tied token embedding and is not read.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping

import torch

from sdumc_tpu_torch.convert import safetensors_io
from sdumc_tpu_torch.models.whisper import WhisperConfig, WhisperModel

GENERATION_KEYS = ("forced_decoder_ids", "suppress_tokens", "begin_suppress_tokens")


def config_from_hf(mapping: Mapping) -> WhisperConfig:
    """A ``config.json`` dict -> WhisperConfig (HF's WhisperConfig names)."""
    return WhisperConfig(
        vocab_size=mapping["vocab_size"],
        num_mel_bins=mapping["num_mel_bins"],
        d_model=mapping["d_model"],
        encoder_layers=mapping["encoder_layers"],
        encoder_heads=mapping["encoder_attention_heads"],
        decoder_layers=mapping["decoder_layers"],
        decoder_heads=mapping["decoder_attention_heads"],
        ffn_dim=mapping["encoder_ffn_dim"],
        max_source_positions=mapping["max_source_positions"],
        max_target_positions=mapping["max_target_positions"],
    )


def generation_meta(config: Mapping, generation: Mapping) -> Dict:
    """The decode settings, as JAX's ``load_hf_whisper`` takes them: the
    start and EOS ids from ``config.json``; the forced ids and the suppress
    lists from ``generation_config.json``, each falling back to
    ``config.json`` where it is missing or null, then to none."""
    meta = {"decoder_start_token_id": config["decoder_start_token_id"],
            "eos_token_id": config["eos_token_id"]}
    for key in GENERATION_KEYS:
        meta[key] = [list(x) if isinstance(x, (list, tuple)) else x
                     for x in (generation.get(key) or config.get(key) or [])]
    return meta


def state_dict_from_hf(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """HF's keys -> the port's: the ``model.`` prefix dropped, ``proj_out``
    (tied to decoder.embed_tokens) left out."""
    out = {}
    for key, val in state_dict.items():
        key = key[len("model."):] if key.startswith("model.") else key
        if not key.startswith("proj_out."):
            out[key] = val
    return out


def load_hf_whisper(model_dir: str, device="cpu"):
    """(WhisperConfig, WhisperModel in eval mode in f32 on ``device``, the
    generation settings) from an HF-format directory. Raises if a weight of
    the model is missing or the checkpoint holds a key the model does not
    know."""
    with open(os.path.join(model_dir, "config.json")) as f:
        config = json.load(f)
    gen_path = os.path.join(model_dir, "generation_config.json")
    generation = {}
    if os.path.exists(gen_path):
        with open(gen_path) as f:
            generation = json.load(f)
    cfg = config_from_hf(config)
    with torch.device("meta"):
        model = WhisperModel(cfg)
    sd = {k: v.to(device=device, dtype=torch.float32)
          for k, v in state_dict_from_hf(safetensors_io.load_hf_weights(model_dir)).items()}
    result = model.load_state_dict(sd, strict=False, assign=True)
    if result.missing_keys or result.unexpected_keys:
        raise KeyError(f"{model_dir}: missing {result.missing_keys}, "
                       f"unexpected {result.unexpected_keys}")
    return cfg, model.eval(), generation_meta(config, generation)
