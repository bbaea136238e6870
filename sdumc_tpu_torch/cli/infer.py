"""Inference / evaluation entry point.

Loads a reference ``.pt`` checkpoint (or seeds the weights), runs both
views over the test split, prints ``eval_mosei_metric`` for the full and
the text-missing view, and with ``--savewhole`` dumps the 8 embedding
streams. Runs on CUDA unless ``--device cpu`` is given.

    python -m sdumc_tpu_torch.cli.infer --synthetic
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from sdumc_tpu_torch.cli.common import (
    add_reference_args, add_runtime_args, args_to_config, build_model,
    resolve_device, set_matmul_precision)


def run_embedding_eval(model, dataset, cfg, device):
    """Eval pass that also harvests the embedding streams:
    full/missing x {rep, rnc, text_query, text}."""
    from sdumc_tpu_torch.data.pipeline import BatchIterator
    from sdumc_tpu_torch.train.loop import _pad_partial
    from sdumc_tpu_torch.train.step import batch_to_device_dict

    # aux key -> (full-view stream, missing-view stream) in the dump
    streams = {"features": ("full_rep", "missing_rep"),
               "rnc": ("full_rnc", "missing_rnc"),
               "text_feat": ("text_rep_query_full", "text_rep_query_missing"),
               "text_query_feat": ("text_rep_full", "text_rep_missing")}
    out = {"val_preds_full": [], "val_preds_missing": [], "val_labels": [],
           "names": []}
    out.update({name: [] for pair in streams.values() for name in pair})
    model.eval()
    it = BatchIterator(dataset, cfg.data.batch_size, shuffle=False,
                       buckets=cfg.data.length_buckets,
                       pin_memory=device.type == "cuda")
    for batch in it:
        padded, n = _pad_partial(batch, cfg.data.batch_size)
        d = batch_to_device_dict(padded, device)
        ta, tt, tv, tf4 = d["t_max"]
        with torch.inference_mode():
            v0, a0 = model(d["audio"], d["text"], d["video"],
                           t_max=(ta, tt, tv), missing=False)
            v1, a1 = model(d["audio"], d["feat4"], d["video"],
                           t_max=(ta, tf4, tv), missing=True)
        out["val_preds_full"].append(v0.reshape(-1)[:n].cpu().numpy())
        out["val_preds_missing"].append(v1.reshape(-1)[:n].cpu().numpy())
        out["val_labels"].append(batch.vals)
        out["names"].extend(batch.names)
        for key, (full, missing) in streams.items():
            out[full].append(a0[key][:n].cpu().numpy())
            out[missing].append(a1[key][:n].cpu().numpy())
    for k, v in out.items():
        if k != "names":
            out[k] = np.concatenate(v, axis=0)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_reference_args(parser)
    add_runtime_args(parser)
    args = parser.parse_args(argv)
    cfg = args_to_config(args)
    if cfg.data.feature_dtype != "float32":
        raise NotImplementedError(
            "--feature_dtype bfloat16 is not ported yet: the bf16 frame "
            "streams come in a later step; use float32")
    device = resolve_device(args.device, args.gpu)
    set_matmul_precision(cfg.model.matmul_precision)

    from sdumc_tpu_torch.core.metrics import eval_mosei_metric
    from sdumc_tpu_torch.data.pipeline import get_loaders
    from sdumc_tpu_torch.train.loop import run_eval
    from sdumc_tpu_torch.train.step import make_eval_step

    train_ds, _, test_ds = get_loaders(cfg.data.dataset, cfg.data, cfg.paths,
                                       synthetic=args.synthetic)
    model = build_model(cfg, train_ds.input_dims(), device, args.checkpoint)

    if args.savewhole:
        results = run_embedding_eval(model, test_ds, cfg, device)
        os.makedirs(args.save_root, exist_ok=True)
        save_path = os.path.join(args.save_root, "test_embeddings.npz")
        np.savez_compressed(save_path, **{k: v for k, v in results.items() if k != "names"})
        print(f"saved embeddings -> {save_path}")
    else:
        results = run_eval(make_eval_step(model), test_ds, cfg, device)

    m_full = eval_mosei_metric(results["val_preds_full"], results["val_labels"])
    m_missing = eval_mosei_metric(results["val_preds_missing"], results["val_labels"])
    print("test full:")
    print(m_full)
    print("test missing:")
    print(m_missing)
    return {"full": m_full, "missing": m_missing, "results": results}


if __name__ == "__main__":
    main()
