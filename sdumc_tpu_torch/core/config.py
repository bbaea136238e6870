"""Single-source configuration: immutable dataclasses that the CLI entry
points fill from flags and never mutate afterwards.

This is the port's own copy of the parts of ``sdumc_tpu/core/config.py``
that the inference and training paths read.
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
    # frame features on the device: "bfloat16" casts f32 batches to bf16
    # (round to nearest even) and so runs the fusion net's bf16 frame
    # streams; a bf16 or int8 packed store gives bf16 streams either way.
    # "float32" keeps the checkpoint-parity path.
    feature_dtype: str = "float32"
    shuffle_seed: int = 100          # train batches shuffle with (shuffle_seed, epoch)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters: the fusion net's (the reference model's
    defaults) and the baseline families'."""

    name: str = "wengnet_mosei_mult_views_text_missing"
    input_dims: Tuple[int, int, int] = (1024, 4096, 1024)  # audio, text, video
    general_dim: int = 256
    layers: Tuple[int, ...] = (256, 128)
    fused_layers: Tuple[int, ...] = (256, 256)
    output_dim: int = 1
    # the baseline families (models/baselines.py: tfn, lmf, attention, misa,
    # mmim; models/baselines_seq.py: mfn, graph_mfn, mfm, mctn, mult), with
    # the JAX package's defaults; core/tuner.py's grids reach other widths
    baseline_hidden_dim: int = 32
    baseline_rank: int = 4
    baseline_mem_dim: int = 32       # MFN / Graph-MFN memory, MFM factors
    baseline_align_t: int = 32       # the align-only families' resampled length
    baseline_layers: int = 2         # MulT depth, MMIM's CPC critic depth
    baseline_heads: int = 4          # MulT attention heads
    baseline_kernel_size: int = 3    # MulT conv1d temporal kernel
    # the families' own loss weights
    misa_sim_w: float = 0.1
    misa_diff_w: float = 0.1
    misa_recon_w: float = 0.1
    mmim_alpha: float = 0.1
    mmim_beta: float = 0.1
    mfm_recon_w: float = 0.1
    mfm_mmd_w: float = 1.0
    mctn_cycle_w: float = 0.3
    mctn_teacher_forcing: float = 0.5
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
class LossConfig:
    """Loss mixing weights (the canonical ICASSP recipe's)."""

    full_mse_w: float = 0.5
    missing_mse_w: float = 0.5
    text_feat_w: float = 0.0
    text_query_feat_w: float = 0.0
    features_w: float = 0.13
    rnc_w: float = 0.5
    rnc_temperature: float = 2.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and checkpoints."""

    lr: float = 1e-4
    l2: float = 1e-5                 # torch-Adam L2 (decay added to the gradient)
    epochs: int = 25
    warmup_epochs: int = 5
    decay_gamma: float = 0.9
    decay_stepsize: int = 10
    seed: int = 100                  # weight init and the train step's random stream
    checkpoint_dir: str = "./saved/ckpt"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The device layout. The fusion net trains data-parallel across
    processes (``cli.train --multihost``), one device a process:
    ``data_parallel`` is -1 (every process) or the number of processes.
    ``model_parallel`` is kept for recipe parity and not read yet."""

    data_parallel: int = -1          # -1: every process
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    paths: PathsConfig = dataclasses.field(default_factory=PathsConfig.from_env)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
