"""Training entry point: dual-view (teacher/student) self-distillation of
the fusion net, or of a baseline family (``--model tfn|lmf|attention|misa|
mmim|mfn|graph_mfn|mfm|mctn|mult``), with best-test-MAE model selection.

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
a dataset on disk. ``--multihost`` trains data-parallel across processes
started with the SDUMC_* environment (``parallel/multihost.py``), one
device each, as the single-process step on the global batch (every
family; a ``model_loss`` that couples the batch's rows is taken of the
gathered rows, ``train/step.py``); every rank logs the same metrics and
rank 0 writes the checkpoints:

    SDUMC_COORDINATOR=127.0.0.1:29500 SDUMC_NUM_PROCESSES=2 SDUMC_PROCESS_ID=0 \
        python -m sdumc_tpu_torch.cli.train --multihost --synthetic &
    SDUMC_COORDINATOR=127.0.0.1:29500 SDUMC_NUM_PROCESSES=2 SDUMC_PROCESS_ID=1 \
        python -m sdumc_tpu_torch.cli.train --multihost --synthetic
 A packed store (``cli.extract pack``) in the features
directory is read in place of the ``.npy`` directory of the same name;
``--feature_dtype bfloat16``, a bf16 store or an int8 store run the fusion
net's bf16 frame streams. Checkpoints (``--checkpoint_dir``) are reference-format
``.pt`` files; ``--resume`` takes a ``latest.pt``.
"""

from __future__ import annotations

import argparse
import os
import time

from sdumc_tpu_torch.cli.common import (
    add_reference_args, add_runtime_args, args_to_config, bf16_full_precision_reduction,
    build_model, resolve_device, set_matmul_precision)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_reference_args(parser)
    add_runtime_args(parser)
    parser.add_argument("--resume", type=str, default=None,
                        help="a latest.pt checkpoint to resume from")
    parser.add_argument("--multihost", action="store_true",
                        help="data parallelism across processes: the rendezvous from "
                             "SDUMC_COORDINATOR (host:port), SDUMC_NUM_PROCESSES and "
                             "SDUMC_PROCESS_ID; each process reads its shard of every batch")
    args = parser.parse_args(argv)
    cfg = args_to_config(args)

    from sdumc_tpu_torch.parallel import make_data_axis

    if args.multihost:
        import torch

        from sdumc_tpu_torch.parallel.multihost import initialize_from_env

        rank, world = initialize_from_env(device=args.device)
        print(f"multihost: process {rank}/{world}")
        device = resolve_device(args.device, torch.cuda.current_device()
                                if args.device == "cuda" else 0)
    else:
        device = resolve_device(args.device, args.gpu)
    try:
        return _train(args, cfg, device, make_data_axis(device, cfg.mesh.data_parallel))
    finally:
        if args.multihost:
            from sdumc_tpu_torch.parallel import shutdown

            shutdown()


def _train(args, cfg, device, axis):
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
    with bf16_full_precision_reduction():
        result = train(cfg, model, train_ds, eval_ds, test_ds, device, resume_from=args.resume,
                       axis=axis)
    print(f">>>>> Finish: training duration {time.time() - t0:.1f}s >>>>>")
    print("best_test_full:", result["best_full"])
    print("best_test_missing:", result["best_missing"])

    if axis.rank:
        return result
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
