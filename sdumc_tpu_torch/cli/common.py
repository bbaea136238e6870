"""Shared CLI argument plumbing.

Flag names mirror the reference's argparse surface (and the JAX package's
CLI), so shell recipes port by changing only the module name. The port adds
``--device``.
"""

from __future__ import annotations

import argparse

import torch

from sdumc_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig, PathsConfig


def add_reference_args(p: argparse.ArgumentParser) -> None:
    # input
    p.add_argument("--dataset", type=str, default="CMU-MOSEI")
    p.add_argument("--train_dataset", type=str, default=None)
    p.add_argument("--valid_dataset", type=str, default=None)
    p.add_argument("--test_dataset", type=str, default=None)
    p.add_argument("--audio_feature", type=str, default=DataConfig.audio_feature)
    p.add_argument("--text_feature", type=str, default=DataConfig.text_feature)
    p.add_argument("--video_feature", type=str, default=DataConfig.video_feature)
    p.add_argument("--feat4_feature", type=str, default=DataConfig.feat4_feature)
    p.add_argument("--debug", action="store_true", default=False)
    p.add_argument("--test_sets", type=str, default="test1,test2")
    p.add_argument("--save_root", type=str, default="./saved")
    p.add_argument("--savewhole", action="store_true", default=False)
    p.add_argument("--feat_type", type=str, default="frm_unalign",
                   choices=["utt", "frm_align", "frm_unalign"])
    p.add_argument("--feat_scale", type=int, default=1)
    p.add_argument("--feature_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="only float32 is ported so far; bfloat16 raises")
    # model
    p.add_argument("--model", type=str, default="wengnet_mosei_mult_views_text_missing")
    p.add_argument("--layers", type=str, default="256,128")
    p.add_argument("--full_mse_loss_w", type=float, default=0.5)
    p.add_argument("--missing_mse_loss_w", type=float, default=0.5)
    p.add_argument("--text_feat_loss_w", type=float, default=0.1)
    p.add_argument("--text_query_feat_loss_w", type=float, default=0.7)
    p.add_argument("--features_loss_w", type=float, default=0.1)
    p.add_argument("--rnc_loss_w", type=float, default=0.8)
    # training
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--l2", type=float, default=1e-5)
    p.add_argument("--dropout", type=float, default=0.5,
                   help="parsed for recipe parity; like the reference, the "
                        "live model keeps its own default")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--gpu", type=int, default=0,
                   help="index of the CUDA device to use")


def add_runtime_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) runs the hand-written kernels and "
                        "raises when no card is present; cpu runs their plain "
                        "versions")
    p.add_argument("--synthetic", action="store_true",
                   help="use the deterministic synthetic feature store "
                        "(no dataset on disk required)")
    p.add_argument("--data_parallel", type=int, default=-1,
                   help="parsed for recipe parity; this path runs on one device")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="parsed for recipe parity; this path runs on one device")
    p.add_argument("--length_pool", type=int, default=0,
                   help="parsed for recipe parity; inference batches in order")
    p.add_argument("--matmul_precision", type=str, default="highest",
                   choices=["default", "high", "highest"],
                   help="highest keeps every torch matmul in true f32 "
                        "(TF32 off); the others allow TF32")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="a reference .pt checkpoint")
    p.add_argument("--checkpoint_dir", type=str, default="./saved/ckpt")


def args_to_config(args) -> ExperimentConfig:
    return ExperimentConfig(
        paths=PathsConfig.from_env(args.dataset),
        data=DataConfig(
            dataset=args.dataset,
            train_dataset=args.train_dataset or "",
            test_dataset=args.test_dataset or args.dataset,
            audio_feature=args.audio_feature,
            text_feature=args.text_feature,
            video_feature=args.video_feature,
            feat4_feature=args.feat4_feature,
            feat_scale=args.feat_scale,
            feature_dtype=args.feature_dtype,
            batch_size=args.batch_size,
            debug=args.debug,
        ),
        model=ModelConfig(
            name=args.model,
            layers=tuple(int(x) for x in args.layers.split(",")),
            matmul_precision=args.matmul_precision,
        ),
        seed=args.seed,
    )


def resolve_device(name: str, index: int = 0) -> torch.device:
    """The device an entry point runs on. CUDA is never replaced by the CPU
    silently: without a card, only an explicit ``cpu`` runs."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to "
                           "run the plain PyTorch versions on the CPU")
    return torch.device("cuda", index)


def set_matmul_precision(precision: str) -> None:
    """"highest" turns TF32 off for torch's matmuls and convolutions (the
    checkpoint-parity path); the other settings allow it."""
    tf32 = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def build_model(cfg: ExperimentConfig, input_dims, device, checkpoint=None):
    """The fusion model with seeded init (or a reference .pt), in eval mode
    on `device`."""
    import dataclasses

    from sdumc_tpu_torch.models import get_model

    mcfg = dataclasses.replace(cfg.model, input_dims=tuple(input_dims[:3]))
    model = get_model(mcfg, torch.Generator().manual_seed(cfg.seed))
    if checkpoint:
        if not checkpoint.endswith(".pt"):
            raise ValueError(f"--checkpoint takes a reference .pt file, got {checkpoint}")
        from sdumc_tpu_torch.convert import load_reference_checkpoint

        report = load_reference_checkpoint(checkpoint, model)
        print(f"loaded torch checkpoint {checkpoint}: "
              f"{len(report['unmapped'])} unmapped, {len(report['missing'])} missing")
    return model.to(device).eval()
