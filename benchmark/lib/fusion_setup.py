"""What the fusion cells share: the store written from the seed, the
program's dataset over it, the model with the seeded weights, and the
inputs the reference reads."""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict

import numpy as np
import torch

from benchmark.lib import seeds, traffic, weights
from benchmark.reference import fusion as ref


@dataclasses.dataclass
class Store:
    tmp: tempfile.TemporaryDirectory
    raw: Dict                     # stream -> (blob memmap, {clip: (offset, rows, cols)})
    names: list
    vals: np.ndarray

    @property
    def directory(self) -> str:
        return self.tmp.name


def stream_dims(cfg: Dict) -> Dict[str, int]:
    Da, Dt, Dv = cfg["input_dims"]
    return {"audio": Da, "text": Dt, "video": Dv, "feat4": cfg["feat4_dim"]}


def make_store(cfg: Dict, params: Dict, seed: int, device, n_clips: int) -> Store:
    """The cell's clips as the program's f32 packed stores, in a fresh
    directory under TMPDIR (removed by ``Store.tmp.cleanup``)."""
    clips = traffic.fusion_clips(params, seed, n_clips)
    tmp = tempfile.TemporaryDirectory(prefix="bench-store-")
    raw = traffic.write_store(tmp.name, stream_dims(cfg), clips, seed, device)
    return Store(tmp, raw, [f"c{i}" for i in range(n_clips)], clips["vals"].astype(np.float32))


def dataset(store: Store):
    """The program's MoseiDataset over the packed stores."""
    from sdumc_tpu_torch.data.packed import PackedSource
    from sdumc_tpu_torch.data.pipeline import MODALITIES, MoseiDataset

    sources = {m: PackedSource(os.path.join(store.directory, m), m) for m in MODALITIES}
    labels = [{"emo": 0.0, "val": float(v)} for v in store.vals]
    return MoseiDataset(list(store.names), labels, sources)


def state_dict(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return weights.state_dict(ref.weight_layout(cfg), seeds.derive(seed, "weights"), device)


def model(cfg: Dict, seed: int, device):
    """The program's fusion net with the seeded weights, on `device`."""
    from sdumc_tpu_torch.core.config import ModelConfig
    from sdumc_tpu_torch.models.fusion import SDUMCFusion

    mcfg = ModelConfig(
        input_dims=tuple(cfg["input_dims"]), general_dim=cfg["general_dim"],
        layers=tuple(cfg["layers"]), fused_layers=tuple(cfg["fused_layers"]),
        output_dim=cfg["output_dim"], dropout=cfg["dropout"],
        attn_dropout=cfg["attn_dropout"], softmax_scale=cfg["softmax_scale"],
        rnc_proj_dim=cfg["rnc_proj_dim"], use_imagination=cfg["use_imagination"],
        matmul_precision="highest")
    with torch.device("meta"):
        net = SDUMCFusion(mcfg)
    net.load_state_dict(state_dict(cfg, seed, device), assign=True)
    return net


def reference_batch(store: Store, rows, cfg: Dict, device) -> Dict:
    """Rows `rows` of the store as the reference pads them."""
    names = [store.names[i] for i in rows]
    return ref.assemble(store.raw, names, store.vals[list(rows)], cfg["length_buckets"], device)
