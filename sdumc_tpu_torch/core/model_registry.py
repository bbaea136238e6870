"""Pretrained-model name registry: the feature extractors' names, their
widths and modality groupings, the emotion label maps, display names and
quality rankings, as data.

The port's own copy of ``sdumc_tpu/core/model_registry.py`` (the reference's
``toolkit/globals.py``), which imports no JAX; the port imports nothing of
the JAX package.
"""

from __future__ import annotations

from typing import Dict, List

# --- canonical feature names used by the live MOSEI recipe
AUDIO_WAVLM_LARGE = "wavlm-large-FRA_-5"
TEXT_VICUNA_GT = "vicuna-7b-v1.5-FRA-wavlm2vicuna-half-gt"
VIDEO_MANET = "manet_FRA"
FEAT4_VICUNA_GEN = (
    "vicuna-7b-v1.5-FRA-wavlm2vicuna-half-wav+prompt[take_generate_wordembed_-4]"
)

# --- extractor families (reference WHOLE_AUDIO/TEXT/IMAGE, globals.py:92-136)
AUDIO_ENCODERS: Dict[str, dict] = {
    "wavlm-large": {"hf": "microsoft/wavlm-large", "dim": 1024, "frame_hz": 50},
    "wavlm-base": {"hf": "microsoft/wavlm-base", "dim": 768, "frame_hz": 50},
    "hubert-large-ls960-ft": {"hf": "facebook/hubert-large-ls960-ft", "dim": 1024, "frame_hz": 50},
    "wav2vec2-base-960h": {"hf": "facebook/wav2vec2-base-960h", "dim": 768, "frame_hz": 50},
    "wav2vec2-large-960h": {"hf": "facebook/wav2vec2-large-960h", "dim": 1024, "frame_hz": 50},
    "chinese-hubert-large": {"hf": "TencentGameMate/chinese-hubert-large", "dim": 1024, "frame_hz": 50},
    "chinese-wav2vec2-large": {"hf": "TencentGameMate/chinese-wav2vec2-large", "dim": 1024, "frame_hz": 50},
}
TEXT_ENCODERS: Dict[str, dict] = {
    "vicuna-7b-v1.5": {"hf": "lmsys/vicuna-7b-v1.5", "dim": 4096, "family": "llama"},
    "llama-2-7b": {"hf": "meta-llama/Llama-2-7b-hf", "dim": 4096, "family": "llama"},
    "llama-2-13b": {"hf": "meta-llama/Llama-2-13b-hf", "dim": 5120, "family": "llama"},
    "bloom-7b": {"hf": "bigscience/bloom-7b1", "dim": 4096, "family": "bloom"},
    "chatglm2-6b": {"hf": "THUDM/chatglm2-6b", "dim": 4096, "family": "glm"},
    "deberta-large": {"hf": "microsoft/deberta-v3-large", "dim": 1024, "family": "bert"},
    "roberta-large": {"hf": "roberta-large", "dim": 1024, "family": "bert"},
}
VISUAL_ENCODERS: Dict[str, dict] = {
    "manet": {"dim": 1024, "input": 224, "source": "RAF-DB ckpt"},
    "clip-vit-large-patch14": {"hf": "openai/clip-vit-large-patch14", "dim": 768},
    "dinov2-large": {"hf": "facebook/dinov2-large", "dim": 1024},
    "videomae-large": {"hf": "MCG-NJU/videomae-large", "dim": 1024},
    "resnet50-imagenet": {"dim": 2048, "source": "torchvision"},
}

# --- emotion label maps (reference globals.py emotion dictionaries)
MOSEI_EMOTIONS: List[str] = ["happy", "sad", "anger", "surprise", "disgust", "fear"]
EMO2IDX = {e: i for i, e in enumerate(MOSEI_EMOTIONS)}
IDX2EMO = {i: e for i, e in enumerate(MOSEI_EMOTIONS)}

# --- display names (reference globals.py:138-193 style)
DISPLAY_NAMES = {
    AUDIO_WAVLM_LARGE: "WavLM-large (layer -5)",
    TEXT_VICUNA_GT: "Vicuna-7B gt-text embedding",
    VIDEO_MANET: "MANet face embedding",
    FEAT4_VICUNA_GEN: "WavLM->Vicuna generated pseudo-text",
}

# --- per-modality quality rankings (reference globals.py:199-215): order =
# published MOSEI/MER downstream quality, best first.
QUALITY_RANKING = {
    "audio": ["wavlm-large", "hubert-large-ls960-ft", "wav2vec2-large-960h",
              "wav2vec2-base-960h"],
    "text": ["vicuna-7b-v1.5", "llama-2-13b", "llama-2-7b", "deberta-large",
             "roberta-large"],
    "video": ["manet", "clip-vit-large-patch14", "dinov2-large",
              "videomae-large", "resnet50-imagenet"],
}


def feature_dim(feature_name: str) -> int:
    """Best-effort dim lookup from a feature-directory name."""
    for table in (AUDIO_ENCODERS, TEXT_ENCODERS, VISUAL_ENCODERS):
        for key, meta in table.items():
            if feature_name.startswith(key):
                return meta["dim"]
    if "manet" in feature_name:
        return 1024
    if "vicuna" in feature_name or "llama" in feature_name:
        return 4096
    if "wavlm" in feature_name or "hubert" in feature_name:
        return 1024
    raise KeyError(feature_name)
