"""Training entry point: dual-view (teacher/student) self-distillation of
the fusion net with best-test-MAE model selection.

The flags are the JAX package's (``sdumc_tpu/cli/train.py``), so the
canonical ICASSP recipe ports by changing the module name:

    python -m sdumc_tpu_torch.cli.train --dataset=CMU-MOSEI \\
        --model=wengnet_mosei_mult_views_text_missing \\
        --audio_feature=wavlm-large-FRA_-5 \\
        --text_feature=vicuna-7b-v1.5-FRA-wavlm2vicuna-half-gt \\
        --video_feature=manet_FRA \\
        --feat4_feature='vicuna-7b-v1.5-FRA-wavlm2vicuna-half-wav+prompt[take_generate_wordembed_-4]' \\
        --batch_size=96 --lr=1e-4 --epochs=25 \\
        --full_mse_loss_w=0.5 --missing_mse_loss_w=0.5 --text_feat_loss_w=0 \\
        --text_query_feat_loss_w=0 --features_loss_w=0.13 --rnc_loss_w=0.5

Runs on CUDA unless ``--device cpu`` is given; ``--synthetic`` runs without
a dataset on disk. Checkpoints (``--checkpoint_dir``) are reference-format
``.pt`` files; ``--resume`` takes a ``latest.pt``.
"""

from __future__ import annotations

import argparse
import os
import time

from sdumc_tpu_torch.cli.common import (
    add_reference_args, add_runtime_args, args_to_config, build_model, resolve_device,
    set_matmul_precision)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_reference_args(parser)
    add_runtime_args(parser)
    parser.add_argument("--resume", type=str, default=None,
                        help="a latest.pt checkpoint to resume from")
    parser.add_argument("--multihost", action="store_true",
                        help="multi-host data parallelism (not ported yet)")
    args = parser.parse_args(argv)
    cfg = args_to_config(args)
    if args.multihost:
        raise NotImplementedError("--multihost is not ported yet (ROADMAP.md queue 1, "
                                  "multi-device)")
    if cfg.data.feature_dtype != "float32":
        raise NotImplementedError(
            "--feature_dtype bfloat16 is not ported yet: the bf16 frame "
            "streams come in a later step; use float32")
    device = resolve_device(args.device, args.gpu)
    set_matmul_precision(cfg.model.matmul_precision)

    from sdumc_tpu_torch.data.pipeline import get_loaders
    from sdumc_tpu_torch.train.loop import train

    print("====== Reading Data =======")
    train_ds, eval_ds, test_ds = get_loaders(cfg.data.dataset, cfg.data, cfg.paths,
                                             synthetic=args.synthetic)
    input_dims = train_ds.input_dims()
    print(f"train: {len(train_ds)}  val: {len(eval_ds)}  test: {len(test_ds)}; dims {input_dims}")

    print("====== Training and Evaluation =======")
    model = build_model(cfg, input_dims, device, args.checkpoint)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model size: {n_params / 1e6:.2f}M params ({n_params * 4 / 2**20:.1f} MB fp32) "
          f"on {device}")

    t0 = time.time()
    result = train(cfg, model, train_ds, eval_ds, test_ds, device, resume_from=args.resume)
    print(f">>>>> Finish: training duration {time.time() - t0:.1f}s >>>>>")
    print("best_test_full:", result["best_full"])
    print("best_test_missing:", result["best_missing"])

    # the reference's ablation append-log
    os.makedirs(args.save_root, exist_ok=True)
    with open(os.path.join(args.save_root, "features_ablation_study.txt"), "a") as f:
        f.write(
            f"--full_mse_loss_w={cfg.loss.full_mse_w} --missing_mse_loss_w={cfg.loss.missing_mse_w} "
            f"--text_feat_loss_w={cfg.loss.text_feat_w} --text_query_feat_loss_w={cfg.loss.text_query_feat_w} "
            f"--features_loss_w={cfg.loss.features_w} --rnc_loss_w={cfg.loss.rnc_w}\n"
            f"{result['best_full']}\n{result['best_missing']}\n"
        )
    return result


if __name__ == "__main__":
    main()
