"""Hyperparameter grids and the random-selection tuner.

The port's own copy of ``sdumc_tpu/core/tuner.py`` (which imports no JAX,
but the port imports nothing of the JAX package). Each tuning run draws one
value per listed hyperparameter from its model's grid (the reference's
``model-tune.yaml`` and ``func_random_select``). The grids live in
``TUNE_GRIDS``, keyed by ModelConfig / TrainConfig field names, so a draw
overlays the dataclasses directly; a yaml file may replace them where
pyyaml imports (it is imported only then, and only inside ``load_grids``).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict

# per-model grids (model-tune.yaml equivalent; live model + baselines slots)
TUNE_GRIDS: Dict[str, Dict[str, list]] = {
    "wengnet_mosei_mult_views_text_missing": {
        "lr": [1e-4, 3e-4, 5e-5],
        "batch_size": [64, 96, 128],
        "dropout": [0.3, 0.5],
        "rnc_loss_w": [0.0, 0.5, 0.8],
        "features_loss_w": [0.0, 0.1, 0.13],
        "text_feat_loss_w": [0.0, 0.1],
        "text_query_feat_loss_w": [0.0, 0.7],
    },
    # baseline-family grids mirroring model-tune.yaml:1-80 value-for-value,
    # keyed by OUR ModelConfig/TrainConfig field names so merge_args_config
    # can overlay draws directly onto the dataclasses
    "attention": {"lr": [1e-3, 1e-4], "baseline_hidden_dim": [64, 128, 256],
                  "dropout": [0.2, 0.3, 0.4, 0.5]},
    "tfn": {"lr": [1e-3, 1e-4], "baseline_hidden_dim": [64, 128],
            "dropout": [0.2, 0.3, 0.4, 0.5]},
    "lmf": {"lr": [1e-3, 1e-4], "baseline_hidden_dim": [32, 64, 128, 256],
            "baseline_rank": [3, 4, 5, 6], "dropout": [0.2, 0.3, 0.4, 0.5]},
    "misa": {"lr": [1e-3, 1e-4], "baseline_hidden_dim": [64, 128, 256],
             "dropout": [0.2, 0.3, 0.4, 0.5],
             "misa_sim_w": [0.0, 0.1, 0.2], "misa_diff_w": [0.0, 0.1, 0.2],
             "misa_recon_w": [0.0, 0.1, 0.2]},
    "mmim": {"lr": [1e-3, 1e-4], "baseline_hidden_dim": [64, 128, 256],
             "dropout": [0.0, 0.1, 0.2, 0.3], "baseline_layers": [1, 2, 3, 4],
             "mmim_alpha": [0.0, 0.1, 0.2], "mmim_beta": [0.0, 0.1, 0.2]},
    "mfn": {"lr": [1e-3, 1e-4], "baseline_hidden_dim": [128, 256],
            "baseline_mem_dim": [128], "dropout": [0.0, 0.3, 0.5, 0.7]},
    "graph_mfn": {"lr": [1e-3, 1e-4], "baseline_hidden_dim": [128, 256],
                  "baseline_mem_dim": [128], "dropout": [0.0, 0.3, 0.5, 0.7]},
    "mfm": {"lr": [1e-3, 1e-4], "baseline_hidden_dim": [128, 256],
            "baseline_mem_dim": [128], "dropout": [0.0, 0.3, 0.5, 0.7],
            "mfm_recon_w": [0.01, 0.1, 0.5, 1.0],
            "mfm_mmd_w": [10.0, 50.0, 100.0]},
    "mult": {"lr": [1e-3, 1e-4], "baseline_layers": [2, 4, 6],
             "baseline_heads": [8], "baseline_hidden_dim": [64, 128, 256],
             "baseline_kernel_size": [1, 3], "dropout": [0.0, 0.1, 0.2, 0.3]},
    "mctn": {"lr": [1e-3, 1e-4], "baseline_hidden_dim": [64, 128, 256],
             "dropout": [0.0, 0.1, 0.2, 0.3],
             "mctn_teacher_forcing": [0.3, 0.5],
             "mctn_cycle_w": [0.1, 0.3, 0.5, 0.8, 1.0]},
}


def load_grids(yaml_path: str | None = None) -> Dict[str, Dict[str, list]]:
    if yaml_path:
        try:
            import yaml

            with open(yaml_path) as f:
                return yaml.safe_load(f)
        except ImportError:
            pass
    return TUNE_GRIDS


def random_select(grid: Dict[str, list], seed: int | None = None) -> Dict[str, Any]:
    """One random draw per hyperparameter (reference func_random_select)."""
    rng = random.Random(seed)
    return {k: rng.choice(v) for k, v in grid.items()}


def merge_args_config(args, model_name: str, seed: int | None = None,
                      yaml_path: str | None = None):
    """Overlay a random grid draw onto an argparse namespace / dataclass
    (reference merge_args_config, functions.py:144-159)."""
    grids = load_grids(yaml_path)
    if model_name not in grids:
        return args, {}
    draw = random_select(grids[model_name], seed)
    for key, value in draw.items():
        if dataclasses.is_dataclass(args):
            if hasattr(args, key):
                args = dataclasses.replace(args, **{key: value})
        elif hasattr(args, key):
            setattr(args, key, value)
    return args, draw
