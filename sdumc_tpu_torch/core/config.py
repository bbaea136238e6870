"""Single-source configuration: immutable dataclasses that the CLI entry
points fill from flags and never mutate afterwards.

This is the port's own copy of the parts of ``sdumc_tpu/core/config.py``
that the inference path reads.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PathsConfig:
    """Filesystem layout of a dataset.

    A directory per feature type holding ``{clip}.npy`` of shape ``[T, D]``,
    and a label ``.npz`` with ``train_corpus/val_corpus/test_corpus`` dicts
    of ``name -> {'emo', 'val'}``.
    """

    data_dir: str = ""
    features_dir: str = ""
    label_path: str = ""

    @staticmethod
    def from_env(dataset: str = "CMU-MOSEI") -> "PathsConfig":
        root = os.environ.get("SDUMC_DATA_DIR", os.path.join(os.getcwd(), "dataset"))
        return PathsConfig(
            data_dir=root,
            features_dir=os.path.join(root, "features", dataset),
            label_path=os.path.join(root, "labels", f"{dataset}.npz"),
        )


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline. Batches are zero-padded to the smallest length bucket
    that holds the batch max, and carry that max as ``t_max`` so the model's
    softmax masks reproduce the reference's batch-max padding (see
    ops/masking.py)."""

    dataset: str = "CMU-MOSEI"
    # cross-corpus transfer: when train_dataset is set, get_loaders takes
    # train/val from it and test from test_dataset
    train_dataset: str = ""
    test_dataset: str = ""
    audio_feature: str = "wavlm-large-FRA_-5"
    text_feature: str = "vicuna-7b-v1.5-FRA-wavlm2vicuna-half-gt"
    video_feature: str = "manet_FRA"
    feat4_feature: str = (
        "vicuna-7b-v1.5-FRA-wavlm2vicuna-half-wav+prompt[take_generate_wordembed_-4]"
    )
    feat_scale: int = 1              # pre-compress [T, D] -> [T/scale, D]
    batch_size: int = 96
    drop_too_long_train_clips: bool = True
    debug: bool = False              # truncate every split to 100 samples
    length_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048, 4096)
    # only float32 so far; the bf16 feature streams are not ported yet
    feature_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Fusion-model hyperparameters (reference model defaults)."""

    name: str = "wengnet_mosei_mult_views_text_missing"
    input_dims: Tuple[int, int, int] = (1024, 4096, 1024)  # audio, text, video
    general_dim: int = 256
    layers: Tuple[int, ...] = (256, 128)
    fused_layers: Tuple[int, ...] = (256, 256)
    output_dim: int = 1
    # the reference CLI parses --dropout=0.5 but never forwards it into the
    # model; the model's own default 0.3 is what actually runs
    dropout: float = 0.3
    attn_dropout: float = 0.5        # FRA2UTT_new / Cross_Attention hardcode 0.5
    softmax_scale: float = 0.3
    rnc_proj_dim: int = 64
    # the imagination ResidualAE modules exist in the released checkpoint,
    # but the reference's substitution that calls them is commented out
    use_imagination: bool = False
    # "highest" = true f32 matmuls (TF32 off), required for checkpoint
    # parity; "high"/"default" allow TF32 in the torch matmuls. The fused
    # kernel computes in f32 either way.
    matmul_precision: str = "highest"


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    paths: PathsConfig = dataclasses.field(default_factory=PathsConfig.from_env)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    seed: int = 100                  # weight init
