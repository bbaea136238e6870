"""Flax params of the JAX package -> the port's state_dict.

The inverse of the reference-key table in
``sdumc_tpu/convert/torch_to_jax.py``, kept here as the port's own copy.
The port names its submodules after the reference torch state_dict, so the
keys produced here are the reference keys, and Dense ``kernel`` [in, out]
transposes to Linear ``weight`` [out, in].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

MLP_NAMES = frozenset({
    "audio_mlp", "text_mlp", "video_mlp", "attention_mlp",
    "cross_fused_query_mlp", "cross_at_query_mlp", "cross_tv_query_mlp",
    "cross_av_query_mlp", "cross_audio_query_mlp", "cross_text_query_mlp",
    "cross_video_query_mlp", "cross_audio_mlp", "cross_text_mlp",
    "cross_video_mlp", "cross_attention_mlp",
})
PLAIN_LINEAR = frozenset({
    "frame_dim_reshape_0", "frame_dim_reshape_1", "frame_dim_reshape_2",
    "fc_att", "cross_fc_att", "fc_out_e", "fc_out_v", "fc_out_ev",
})
FRA2UTT = frozenset({"fra2utt_0", "fra2utt_1", "fra2utt_2"})
XATT = frozenset({"cross_att_fra2utt_0", "cross_att_fra2utt_1", "cross_att_fra2utt_2"})
IMAG = frozenset({"missing_text_imagination_mlp",
                  "missing_cross_text_query_imagination_mlp"})

_LEAF = {"kernel": "weight", "bias": "bias"}
_NORM_LEAF = {"scale": "weight", "bias": "bias"}


def torch_key_for(path: Tuple[str, ...]) -> Optional[str]:
    """Reference state_dict key of one Flax param path, or None."""
    name = path[0]
    if name in MLP_NAMES:       # (name, linear_i, dense, leaf) -> Sequential idx 3i
        i = int(path[1].split("_")[1])
        return f"{name}.{3 * i}.{_LEAF[path[3]]}"
    if name.startswith("orgin_linear_change_"):   # Sequential(Linear, ReLU, Linear)
        i = int(name.rsplit("_", 1)[1])
        return f"orgin_linear_change.{2 * i}.{_LEAF[path[2]]}"
    if name in FRA2UTT and path[1] == "context":
        return f"{name}.attention_context_vector"
    if name in FRA2UTT or name in XATT:
        return f"{name}.{path[1]}.{_LEAF[path[3]]}"
    if name in PLAIN_LINEAR:
        return f"{name}.{_LEAF[path[2]]}"
    if name == "prelu_weight":
        return "prelu.weight"
    if name == "layer_normali":
        return f"layer_normali.{_NORM_LEAF[path[1]]}"
    if name in IMAG:
        sub, leaf = path[1], _LEAF[path[3]]
        if sub.startswith("transition_"):
            return f"{name}.transition.{2 * int(sub.split('_')[1])}.{leaf}"
        kind, blk, i = sub.split("_")            # encoder_{blk}_{i}
        return f"{name}.{kind}_{blk}.{3 * int(i)}.{leaf}"
    return None


def _leaves(tree, prefix=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX SDUMCFusion's params (a nested dict of arrays) as the port's
    state_dict. Raises on a param path with no reference key."""
    out = {}
    for path, value in _leaves(params):
        key = torch_key_for(path)
        if key is None:
            raise KeyError(f"no port key for flax param {'/'.join(path)}")
        arr = np.array(value, dtype=np.float32)
        if path[-1] == "kernel" and arr.ndim == 2:
            arr = arr.T
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
