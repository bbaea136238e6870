"""Tensor-parallel weight layouts for the extractor graphs (LLaMA / WavLM).

The port of ``sdumc_tpu/parallel/sharding.py``. The reference shards its 7B
extractor LLMs over GPUs with ``accelerate.dispatch_model``
(extract_text_embedding_huggingface.py:204-210,
extract_wavlm_vicuna.py:306-312); JAX annotates each weight with a
PartitionSpec over the mesh's ``model`` axis and lets GSPMD insert the
collectives. Here the axis is N processes (``parallel/mesh.py ModelAxis``),
each holding its shard of every split weight, and the models place the
collectives themselves (``parallel/layers.py``, used by ``models/llama.py
TPLlamaAttention`` / ``TPLlamaMLP`` and ``models/wavlm.py TPWavLMAttention``
/ ``TPFeedForward``): the standard Megatron split.

A layout maps each state_dict key to the dimension of the tensor that is
split over the ranks, or to None (replicated). The rules are JAX's, in
torch's layout: ``nn.Linear.weight`` is [out, in], so JAX's ``P(None,
"model")`` on a flax kernel [in, out] (an output split) is dim 0 here and
``P("model", None)`` (an input split) dim 1; embeddings keep flax's [num,
dim] layout. As in JAX, a tensor whose split dimension the world size does
not divide stays replicated (``_split_for``).

Where JAX's GSPMD may split a head-split dimension mid-head, the port splits
attention by whole heads: when ``num_heads % world != 0`` a model's whole
attention block stays replicated (q, k, v, o; for WavLM also the biases,
``rel_attn_embed`` and ``gru_rel_pos_const``), and when a LLaMA's
``kv_heads % world != 0`` (but its heads divide) K and V stay replicated,
each rank taking the KV heads its query heads group into. The results equal
the replicated model's either way; only the layout, and so the summary, can
differ from JAX's there (ROADMAP §3).
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

# (key regex, split dim): first match wins; keys are the port's state_dict keys
LLAMA_RULES: List[Tuple[str, int]] = [
    (r"(q|k|v)_proj\.weight$", 0),
    (r"o_proj\.weight$", 1),
    (r"(gate|up)_proj\.weight$", 0),
    (r"down_proj\.weight$", 1),
    (r"embed_tokens\.weight$", 1),
    (r"lm_head\.weight$", 0),
]

WAVLM_RULES: List[Tuple[str, int]] = [
    (r"(q|k|v)_proj\.weight$", 0),
    (r"(q|k|v)_proj\.bias$", 0),
    (r"out_proj\.weight$", 1),
    (r"intermediate_dense\.weight$", 0),
    (r"intermediate_dense\.bias$", 0),
    (r"output_dense\.weight$", 1),
    (r"rel_attn_embed\.weight$", 1),
    (r"gru_rel_pos_const$", 1),
]

# the keys of a model's attention block, replicated as a whole when the heads do not divide
LLAMA_HEAD_KEYS = r"(q|o)_proj\.weight$"
LLAMA_KV_KEYS = r"(k|v)_proj\.weight$"
WAVLM_HEAD_KEYS = r"((q|k|v)_proj\.(weight|bias)|out_proj\.weight|rel_attn_embed\.weight" \
                  r"|gru_rel_pos_const)$"

Specs = Dict[str, Optional[int]]


def _shape(value) -> Tuple[int, ...]:
    return tuple(value.shape) if hasattr(value, "shape") else tuple(value)


def _split_for(key: str, shape: Tuple[int, ...], rules, world: int) -> Optional[int]:
    """The first matching rule's dim, or None where no rule matches, the
    tensor has no such dim or ``world`` does not divide it (replicated:
    correct, just not split)."""
    for pattern, dim in rules:
        if re.search(pattern, key):
            if dim >= len(shape) or shape[dim] % world != 0:
                return None
            return dim
    return None


def partition_specs(shapes: Mapping, rules: Sequence[Tuple[str, int]], world: int) -> Specs:
    """Key -> split dim (or None) for every entry of ``shapes`` (a state
    dict, or key -> shape), by the rules, over ``world`` ranks."""
    return {k: _split_for(k, _shape(v), rules, world) for k, v in shapes.items()}


def _whole_heads(specs: Specs, pattern: str) -> Specs:
    return {k: None if re.search(pattern, k) else d for k, d in specs.items()}


def llama_specs(shapes: Mapping, cfg, world: int) -> Specs:
    """The LLaMA layout (``LLAMA_RULES``), attention split by whole heads
    (``cfg.num_heads`` and ``cfg.kv_heads`` against ``world``)."""
    specs = partition_specs(shapes, LLAMA_RULES, world)
    if cfg.num_heads % world:
        specs = _whole_heads(specs, LLAMA_HEAD_KEYS)
    if cfg.num_heads % world or cfg.kv_heads % world:
        specs = _whole_heads(specs, LLAMA_KV_KEYS)
    return specs


def wavlm_specs(shapes: Mapping, cfg, world: int) -> Specs:
    """The WavLM layout (``WAVLM_RULES``), attention split by whole heads."""
    specs = partition_specs(shapes, WAVLM_RULES, world)
    if cfg.num_heads % world:
        specs = _whole_heads(specs, WAVLM_HEAD_KEYS)
    return specs


def rank_part(t: torch.Tensor, dim: Optional[int], rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` along ``dim`` (a view), or ``t`` itself
    when ``dim`` is None."""
    if dim is None:
        return t
    n = t.shape[dim] // world
    return t.narrow(dim, rank * n, n)


def shard_state_dict(state_dict: Mapping[str, torch.Tensor], specs: Specs, rank: int,
                     world: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s tensors: each split tensor's slice (a contiguous
    copy), each replicated one as it is."""
    return {k: rank_part(t, specs[k], rank, world).contiguous() if specs[k] is not None else t
            for k, t in state_dict.items()}


def shard_llama_model(state_dict: Mapping[str, torch.Tensor], cfg, axis, trunk: bool = False):
    """A LLaMA (or its trunk) as rank ``axis.rank`` holds it: the whole
    model's state dict (HF keys; ``convert.from_flax`` gives it from JAX's
    params) cut by ``llama_specs`` and built by
    ``models.llama.tp_model_from_state_dict``, on the tensors' device. A
    world of 1 gives the single-process model."""
    from sdumc_tpu_torch.models.llama import tp_model_from_state_dict

    specs = (llama_specs(state_dict, cfg, axis.world) if axis.world > 1
             else dict.fromkeys(state_dict))
    local = shard_state_dict(state_dict, specs, axis.rank, axis.world)
    return tp_model_from_state_dict(cfg, local, specs, axis, trunk=trunk)


def shard_wavlm_model(state_dict: Mapping[str, torch.Tensor], cfg, axis):
    """A WavLMModel as rank ``axis.rank`` holds it: the whole model's state
    dict cut by ``wavlm_specs`` and built by
    ``models.wavlm.tp_model_from_state_dict``, on the tensors' device (a
    world of 1: the single-process model). On
    the card each rank's flash kernel runs at ``num_heads / world`` heads.
    JAX reaches its WavLM rules the same way, by sharding a model's params
    (no CLI flag: ``cli.extract audio`` has no ``--tp``)."""
    from sdumc_tpu_torch.models.wavlm import tp_model_from_state_dict

    specs = (wavlm_specs(state_dict, cfg, axis.world) if axis.world > 1
             else dict.fromkeys(state_dict))
    local = shard_state_dict(state_dict, specs, axis.rank, axis.world)
    return tp_model_from_state_dict(cfg, local, specs, axis)


def tp_sharding_summary(state_dict: Mapping[str, torch.Tensor], specs: Specs) -> str:
    """Count of split vs replicated tensors and their bytes, JAX's string
    (the whole model's tensors)."""
    sizes = {k: t.numel() * t.element_size() for k, t in state_dict.items()}
    split = [k for k in state_dict if specs.get(k) is not None]
    total = sum(sizes.values())
    split_bytes = sum(sizes[k] for k in split)
    return (f"TP: {len(split)}/{len(state_dict)} tensors sharded "
            f"({split_bytes / max(total, 1):.0%} of {total / 2**20:.0f} MiB)")
