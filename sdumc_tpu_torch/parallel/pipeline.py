"""Pipeline parallelism: the GPipe schedule over the LLaMA trunk's layers
(the JAX package's ``parallel/pipeline.py``).

The reference places its 7B extractors layer by layer over GPUs with
``accelerate.dispatch_model`` (extract_text_embedding_huggingface.py:204-210),
each forward hopping device to device. JAX runs a real pipeline: the stacked
[L, ...] layer params sharded over a ``stage`` mesh axis, the batch split
into M microbatches, activations handed stage to stage by ``ppermute`` on a
GPipe schedule of S + M - 1 ticks. Here the stages are the S ranks of a
``ModelAxis`` (``make_model_axis(device, S)``, or a ``make_mesh`` grid's
model axis), one process each, and stage s holds only layers ``[s L/S, (s +
1) L/S)`` (``stage_layers``): its ``LlamaModel`` has the embedding, the
final norm and those layers on its device, the other layers on the meta
device (``stage_model_from_state_dict``, ``convert.hf_llama
load_hf_llama_trunk(stage=...)``, which reads only the stage's keys).

The schedule is JAX's: on tick t stage 0 takes microbatch t, every stage
hands its output to stage s + 1 (``ModelAxis.exchange``: every send and
receive of a tick posted together), and the last stage writes microbatch t
- (S - 1). Two deliberate differences give the same results: a stage
computes nothing on a tick where it holds no microbatch (JAX recomputes the
last microbatch on the drain ticks and drops the result), and the last
stage's outputs reach the others by a broadcast (exact) where JAX sums a
one-hot mask over the stages.

Scope, as in JAX: the full-sequence forward (text taps, prompt prefill);
a one-token decode step would leave S - 1 stages idle, so decode splits by
tensor parallelism (``parallel/sharding.py``).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import torch

_LAYER = re.compile(r"^(model\.)?layers\.(\d+)\.")


def stage_layers(num_layers: int, axis) -> range:
    """The layers stage ``axis.rank`` of ``axis.world`` holds (JAX's
    ``stage_sharding``: the leading layer axis split in equal blocks);
    raises unless the stages divide the layers."""
    if num_layers % axis.world:
        raise ValueError(f"{num_layers} layers do not divide over {axis.world} stages")
    n = num_layers // axis.world
    return range(axis.rank * n, (axis.rank + 1) * n)


def in_stage(key: str, layers: range) -> bool:
    """True for a state-dict key a stage holding `layers` keeps: a layer's
    key (``layers.{i}.`` or ``model.layers.{i}.``) with ``i`` in `layers`,
    and every key outside the layers (embedding, final norm)."""
    m = _LAYER.match(key)
    return m is None or int(m.group(2)) in layers


def stage_model_from_state_dict(cfg, state_dict: Mapping[str, torch.Tensor], axis):
    """Stage ``axis.rank``'s ``LlamaModel`` (eval mode): the trunk built on
    the meta device and given, as they are (``assign=True``), the embedding,
    the final norm and the stage's layers of `state_dict` (the whole trunk's,
    or only those); the other layers stay on the meta device, holding no
    memory (its own ``forward`` fails on them: it runs through
    ``llama_pp_forward``). Raises if a key of the stage is missing or
    unknown."""
    from sdumc_tpu_torch.models.llama import LlamaModel

    layers = stage_layers(cfg.num_layers, axis)
    with torch.device("meta"):
        model = LlamaModel(cfg)
    mine = {k: v for k, v in state_dict.items() if in_stage(k, layers)}
    missing, unexpected = model.load_state_dict(mine, strict=False, assign=True)
    missing = [k for k in missing if in_stage(k, layers)]
    if missing or unexpected:
        raise KeyError(f"stage {axis.rank}: missing {missing}, unexpected {unexpected}")
    return model.eval()


def pipeline_apply(axis, layer_fn: Callable[[Any, torch.Tensor, Any], torch.Tensor],
                   stage_params: Sequence[Any], x: torch.Tensor, extras: Any = (), *,
                   n_microbatches: int, collect_local_hidden: bool = False):
    """Run ``x`` through all the stages' layers, pipelined over `axis`
    (every stage calls it with the same ``x``).

    Args:
      layer_fn: ``(layer_params, h, extras) -> h`` for one layer; ``h``
        keeps its shape and dtype.
      stage_params: this stage's layers' params, in order (``stage_layers``
        says which; every stage holds as many).
      x: ``[B, ...]``, the same on every stage; B % n_microbatches == 0.
      extras: side inputs passed to every ``layer_fn`` call (positions,
        masks, ...), the same for every microbatch.
      collect_local_hidden: also return the last stage's per-layer outputs
        ``[L/S, B, ...]`` (with L/S >= 4 the reference's -4..-1 taps come out
        of the pipeline).

    Returns ``y [B, ...]`` (the sequential application of all L layers) on
    every stage, or ``(y, local_hidden)`` with ``collect_local_hidden``.
    """
    S, s, M = axis.world, axis.rank, n_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} does not divide into {M} microbatches")
    xm = x.reshape((M, B // M) + tuple(x.shape[1:]))
    last = s == S - 1
    out = torch.empty_like(xm) if last else None
    hid = (torch.empty((len(stage_params),) + tuple(xm.shape), dtype=x.dtype, device=x.device)
           if last and collect_local_hidden else None)
    h = None
    for t in range(S + M - 1):
        m = t - s                               # this stage's microbatch on tick t
        busy = 0 <= m < M
        if busy:
            y = xm[m] if s == 0 else h
            for j, lp in enumerate(stage_params):
                y = layer_fn(lp, y, extras)
                if hid is not None:
                    hid[j, m] = y
            if last:
                out[m] = y
        # hand the output to stage s + 1; take stage s - 1's for tick t + 1
        sends = [(y, s + 1)] if busy and not last else []
        recvs = [(xm[0], s - 1)] if s > 0 and 0 <= m + 1 < M else []
        if sends or recvs:
            got = axis.exchange(sends, recvs)
            if recvs:
                h = got[0]
    if S > 1:
        if not last:
            out = torch.empty_like(xm)
            if collect_local_hidden:
                hid = torch.empty((len(stage_params),) + tuple(xm.shape), dtype=x.dtype,
                                  device=x.device)
        axis.broadcast(out, S - 1)
        if collect_local_hidden:
            axis.broadcast(hid, S - 1)
    y = out.reshape(x.shape)
    if collect_local_hidden:
        return y, hid.reshape((len(stage_params),) + tuple(x.shape))
    return y


def llama_pp_forward(model, axis, *, inputs_embeds: Optional[torch.Tensor] = None,
                     input_ids: Optional[torch.Tensor] = None, n_microbatches: int = 4,
                     collect_taps: int = 0) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-sequence LLaMA forward with the trunk's layers pipelined over
    `axis` (every stage calls it with the same inputs). Returns
    ``(last_hidden_state, taps)``: ``taps`` the final ``collect_taps``
    PRE-norm layer outputs ``[K, B, T, D]`` (K <= L / S, so they all lie on
    the last stage), else None. The last tap is the last layer's output
    before the final norm, unlike ``hidden_states[-1]`` (post-norm): a
    caller summing -4..-1 puts ``last_hidden_state`` in its place.

    ``model``: a stage's ``LlamaModel`` (or a ``LlamaForCausalLM``, whose
    trunk is taken) holding at least this stage's layers
    (``stage_model_from_state_dict``); the embedding and the final norm run
    on every stage, as JAX runs them replicated. Positions are one
    microbatch's, the mask causal. Raises when the stages do not divide the
    layers, the microbatches the batch, or K > L / S."""
    from sdumc_tpu_torch.models.llama import NEG_MASK, rope_tables

    model = getattr(model, "model", model)
    cfg = model.cfg
    layers = stage_layers(cfg.num_layers, axis)
    if collect_taps > len(layers):
        raise ValueError(f"collect_taps {collect_taps} > the {len(layers)} layers of a stage")
    x = (model.embed_tokens(input_ids) if inputs_embeds is None
         else inputs_embeds.to(cfg.dtype))
    B, T, _ = x.shape
    if B % n_microbatches:
        raise ValueError(f"batch {B} does not divide into {n_microbatches} microbatches")
    positions = torch.arange(T, device=x.device)[None].expand(B // n_microbatches, T)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    extras = (rope_tables(positions, cfg.head_dim, cfg.rope_theta),
              torch.where(causal, 0.0, NEG_MASK)[None, None])

    def layer_fn(layer, h, extras):
        rope_cs, mask = extras
        return layer(h, rope_cs, mask)

    stage = [model.layers[i] for i in layers]
    if collect_taps:
        y, hid = pipeline_apply(axis, layer_fn, stage, x, extras, n_microbatches=n_microbatches,
                                collect_local_hidden=True)
        taps = hid[-collect_taps:]
    else:
        y = pipeline_apply(axis, layer_fn, stage, x, extras, n_microbatches=n_microbatches)
        taps = None
    return model.norm(y), taps

