"""Autoregressive decoding: greedy and beam search with hidden-state taps.

The port of ``sdumc_tpu/models/generation.py``. The reference's feat4
extractor runs HF ``generate`` with num_beams=4, do_sample=False,
max_new_tokens=200 and harvests the last-4-layer hidden states of the
leading beam at every step (extract_wavlm_vicuna.py:245-264).

Beam semantics are JAX's (HF's BeamSearchScorer, early_stopping=False):
step 0 takes the top B of beam 0; then 2B candidates per step; EOS
candidates ranked < B enter a B-slot hypothesis pool through one top-B merge
with ties resolved pool-first; the first B non-EOS candidates continue; a
clip is done when its pool is full and the best attainable running score
cannot beat the worst hypothesis; then the finalize loop fills the pool with
the running beams.

The engine is batched over clips (leading axis C), C clips x B beams in
lockstep, per-clip ``done`` freezing only the small state (tokens, taps,
scores, pools); the caches free-run for done clips. The KV cache is split
(models/llama.py): the per-clip prompt part [C, P] is read shared and never
copied or reordered; eagerly, the beam-ancestry reorder gathers only the
written slots of the generated part [C*B, G].

JAX's ``while_loop`` becomes a Python loop over at most max_new_tokens - 1
steps that reads ``done`` on the host only every ``check_every`` steps (one
synchronisation per check). A step taken after every clip is done changes
nothing the engine returns: the frozen state stays frozen (a clip counts as
live while it is not done and has steps left, which is the loop condition
of JAX's engine), so any ``check_every`` gives the results of 1.

The engine is three functions over one state dict, ``beam_prefill``,
``beam_step`` (the loop body, in place on the state) and
``beam_finalize``, so that the serving bundle (``serve/export.py
DecodeBundle``) exports each as a program and runs the same loop on the
host; there the step index is a 0-d tensor, and the generated cache is
read and reordered whole, the unwritten slots masked.

Top-k is ``exact_topk``: k argmax sweeps, ties to the lowest index
(``torch.argmax`` returns the first maximum), the order ``lax.top_k`` gives;
``torch.topk`` promises no tie order on CUDA.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from sdumc_tpu_torch.models.llama import (LlamaConfig, cache_mask, init_cache,
                                          split_cache_from_prefill)

NEG = -1e9


def exact_topk(x: torch.Tensor, k: int):
    """Top-k over the last axis by k argmax sweeps: values descending, equal
    values by ascending index. Returns (values, indices), both [..., k]."""
    work = x.clone()
    vals, idxs = [], []
    for _ in range(k):
        idx = torch.argmax(work, dim=-1, keepdim=True)
        vals.append(torch.gather(work, -1, idx))
        idxs.append(idx)
        work.scatter_(-1, idx, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def _gather_caches(caches, rows: torch.Tensor, n) -> None:
    """Beam-ancestry reorder of a split cache, in place, one gather per
    stack. With a host int ``n`` only the written slots [0, n) of the
    generated part move; with a 0-d tensor (a traced step) all of them do,
    as in JAX: a slot not yet written is masked until it is. The prompt part
    is the same for every beam of a clip and the row map never crosses
    clips, so it stays as it is."""
    for stack in caches.stacks.values():
        if isinstance(n, torch.Tensor):
            stack.copy_(stack[:, rows])
        else:
            stack[:, :, :n] = stack[:, rows, :n]


def _slot_mask(cur_slots: torch.Tensor, max_len: int, offset: torch.Tensor) -> torch.Tensor:
    """Additive mask [R, 1, T, max_len]: attend cache slots in [offset,
    cur_slot]; ``offset`` [R] is the number of left-pad slots."""
    slots = torch.arange(max_len, device=cur_slots.device)[None, None, None, :]
    ok = (slots <= cur_slots[:, None, :, None]) & (slots >= offset[:, None, None, None])
    return torch.where(ok, 0.0, -1e30)


def beam_prefill(apply_fn: Callable, prompt_embeds: torch.Tensor, cfg: LlamaConfig, *,
                 prompt_len, num_beams: int = 4, max_new_tokens: int = 200, eos_id: int = 2,
                 trace: bool = False) -> Dict:
    """The prefill of ``beam_generate_batched`` and its first selection.

    Returns the decode state, a dict of tensors on the prompt's device:
    ``caches`` (the split cache), ``pmask`` [C, P] (the prompt's additive
    mask), ``prompt_len`` [C] int64, ``beam_scores`` [C, B], ``last_tokens``
    [C, B], ``tokens`` [C, B, max_new] (EOS-filled past the step), ``step``
    [C] (tokens chosen so far), ``taps`` [C, max_new, D] f32, the hypothesis
    pool ``hyp_scores`` [C, B], ``hyp_tokens`` [C, B, max_new], ``hyp_lens``
    [C, B], ``done`` [C]; and ``gap`` [C] when ``trace``."""
    B = num_beams
    C, P, D = prompt_embeds.shape
    dev = prompt_embeds.device
    prompt_len = torch.as_tensor(prompt_len, dtype=torch.int64, device=dev).expand(C)
    offset = P - prompt_len                                          # [C]
    arange_p = torch.arange(P, device=dev)

    # ---- prefill: C streams, not C*B; the prompt cache becomes the shared
    # prompt part of the split decode cache as it is
    prefill = init_cache(cfg, C, P, dev)
    pos = torch.clamp(arange_p[None] - offset[:, None], min=0)      # [C, P]
    out = apply_fn(inputs_embeds=prompt_embeds, positions=pos,
                   attn_mask=_slot_mask(arange_p[None].expand(C, P), P, offset),
                   caches=prefill, last_logit_only=True)
    caches = split_cache_from_prefill(cfg, prefill, B, max_new_tokens)
    del prefill, out["caches"]
    logp = torch.log_softmax(out["logits"][:, -1].float(), dim=-1)  # [C, V]
    V = logp.shape[-1]

    # HF init: only beam 0 counts on the first selection
    init_bias = torch.where(torch.arange(B, device=dev) == 0, 0.0, NEG)
    scores0 = logp[:, None, :] + init_bias[None, :, None]           # [C, B, V]
    beam_scores, top_idx = exact_topk(scores0.reshape(C, B * V), B)
    last_tokens = top_idx % V                                       # [C, B]
    tokens = torch.full((C, B, max_new_tokens), eos_id, dtype=torch.int64, device=dev)
    tokens[:, :, 0] = last_tokens
    state = {"caches": caches,
             "pmask": torch.where(arange_p[None] >= offset[:, None], 0.0, -1e30),
             "prompt_len": prompt_len, "beam_scores": beam_scores, "last_tokens": last_tokens,
             "tokens": tokens, "step": torch.ones(C, dtype=torch.int64, device=dev),
             "taps": torch.zeros(C, max_new_tokens, D, device=dev),
             "hyp_scores": torch.full((C, B), NEG, device=dev),
             "hyp_tokens": torch.full((C, B, max_new_tokens), eos_id, dtype=torch.int64,
                                      device=dev),
             "hyp_lens": torch.zeros(C, B, dtype=torch.int64, device=dev),
             "done": torch.zeros(C, dtype=torch.bool, device=dev)}
    if trace:
        state["gap"] = torch.full((C,), float("inf"), device=dev)
    return state


def beam_live(state: Dict) -> torch.Tensor:
    """[C] bool: the clips still decoding (not done, steps left), the loop
    condition of JAX's engine."""
    return ~state["done"] & (state["step"] < state["tokens"].shape[2])


def _take(x, idx):
    """take_along_axis over the beam / candidate axis (1)."""
    return torch.gather(x, 1, idx.view(*idx.shape, *([1] * (x.dim() - 2))).expand(
        *idx.shape, *x.shape[2:]))


def beam_step(apply_fn: Callable, state: Dict, it, *, embed_fn: Callable, eos_id: int = 2,
              length_penalty: float = 1.0,
              tap_layers: Sequence[int] = (-4, -3, -2, -1)) -> torch.Tensor:
    """Step ``it`` of the loop (one token per clip and beam), in place on
    ``state`` (``beam_prefill``'s): its tensors and the caches are written,
    none is rebound. Frozen clips (not ``beam_live``) keep their small state;
    the caches free-run. ``it`` is a host int eagerly, where the generated
    cache is read and reordered up to its written slots, or a 0-d int64
    tensor in a traced program, where the whole generated cache is, the
    slots at and past ``it`` masked. Returns ``beam_live`` of the new state,
    which the loop reads on the host every ``check_every`` steps."""
    s, caches = state, state["caches"]
    C, B = s["beam_scores"].shape
    D = s["taps"].shape[2]
    dev = s["step"].device
    lp = length_penalty
    step = s["step"]
    live = beam_live(s)                                             # [C]
    frozen = ~live
    cidx = torch.arange(C, device=dev)
    rank = torch.arange(2 * B, device=dev)

    # ---- one token per (clip, beam) row; rope position from the real prompt length
    rpos = (s["prompt_len"] + step - 1)[:, None].expand(C, B).reshape(C * B, 1)
    out = apply_fn(inputs_embeds=embed_fn(s["last_tokens"].reshape(C * B, 1)),
                   positions=rpos, attn_mask=s["pmask"], caches=caches,
                   tap_sum_layers=tuple(tap_layers))
    tap = out["tap_sum"][:, 0].reshape(C, B, D)[:, 0]                # leading beam, [C, D]
    taps, row = s["taps"], step - 1
    taps[cidx, row] = torch.where(live[:, None], tap, taps[cidx, row])

    logp = torch.log_softmax(out["logits"][:, -1].float(), dim=-1)
    V = logp.shape[-1]
    cand = s["beam_scores"][:, :, None] + logp.reshape(C, B, V)
    top_vals, top_idx = exact_topk(cand.reshape(C, B * V), 2 * B)
    new = {}
    if "gap" in s:
        new["gap"] = torch.where(live, torch.minimum(s["gap"], top_vals[:, B - 1] - top_vals[:, B]),
                                 s["gap"])
    cand_beam = top_idx // V                                        # [C, 2B]
    cand_tok = top_idx % V
    is_eos = cand_tok == eos_id

    # ---- EOS candidates ranked < B enter the pool: one top-B merge of
    # (pool | pushable candidates), ties pool-first, then by rank
    cur_len = step.float()
    hyp_cand_score = top_vals / (cur_len[:, None] ** lp)
    push = is_eos & (rank[None] < B) & live[:, None]
    merged = torch.cat([s["hyp_scores"], torch.where(push, hyp_cand_score, NEG)], dim=1)
    new["hyp_scores"], sel_idx = exact_topk(merged, B)
    cand_seqs = _take(s["tokens"], cand_beam)                       # [C, 2B, N]
    new["hyp_tokens"] = _take(torch.cat([s["hyp_tokens"], cand_seqs], dim=1), sel_idx)
    all_lens = torch.cat([s["hyp_lens"], step[:, None].expand(C, 2 * B)], dim=1)
    new["hyp_lens"] = torch.gather(all_lens, 1, sel_idx)

    # ---- the first B non-EOS candidates continue as running beams
    live_rank = torch.cumsum((~is_eos).to(torch.int64), dim=1) - 1
    slot_of = torch.where(~is_eos, live_rank, 2 * B)
    sel = torch.argmax((slot_of[:, None, :] == torch.arange(B, device=dev)[None, :, None])
                       .to(torch.int8), dim=2)                      # [C, B]
    new["beam_scores"] = torch.gather(top_vals, 1, sel)
    new_beam_idx = torch.gather(cand_beam, 1, sel)
    new["last_tokens"] = torch.gather(cand_tok, 1, sel)
    col_ids = torch.arange(s["tokens"].shape[2], device=dev)
    new["tokens"] = torch.where(col_ids[None, None, :] == step[:, None, None],
                                new["last_tokens"][:, :, None], _take(s["tokens"], new_beam_idx))
    rows = (cidx[:, None] * B + new_beam_idx).reshape(-1)          # [C*B]
    _gather_caches(caches, rows, it + 1)

    # ---- HF is_done (early_stopping=False, lp > 0)
    n_hyps = (new["hyp_scores"] > NEG / 2).sum(dim=1)
    best_attainable = new["beam_scores"].max(dim=1).values / ((cur_len + 1.0) ** lp)
    done_now = (n_hyps >= B) & (new["hyp_scores"].min(dim=1).values >= best_attainable)
    new["step"] = step + 1
    new["done"] = s["done"] | (done_now & live)

    # every new value is computed before any is written
    for key, value in new.items():
        old = s[key]
        keep = frozen.view(C, *([1] * (old.dim() - 1))) if key not in ("gap", "done") else None
        old.copy_(value if keep is None else torch.where(keep, old, value))
    return beam_live(s)


def beam_finalize(state: Dict, length_penalty: float = 1.0) -> Dict:
    """HF's finalize: the pool filled with the running beams, then each
    clip's best hypothesis. Returns tokens [C, max_new] (EOS-padded),
    n_tokens [C], taps [C, max_new, D] f32 (rows >= n_steps zero), n_steps
    [C] and score [C]; ``state`` is not changed."""
    step = state["step"]
    C, B = state["beam_scores"].shape
    cidx = torch.arange(C, device=step.device)
    hyp_scores, hyp_tokens, hyp_lens = (state[k].clone() for k in
                                        ("hyp_scores", "hyp_tokens", "hyp_lens"))
    tokens = state["tokens"]
    run_score = state["beam_scores"] / (step.float()[:, None] ** length_penalty)   # [C, B]
    for i in range(B):
        worst = torch.argmin(hyp_scores, dim=1)
        worst_val = hyp_scores[cidx, worst]
        better = run_score[:, i] > worst_val
        hyp_scores[cidx, worst] = torch.where(better, run_score[:, i], worst_val)
        hyp_tokens[cidx, worst] = torch.where(better[:, None], tokens[:, i],
                                              hyp_tokens[cidx, worst])
        hyp_lens[cidx, worst] = torch.where(better, step, hyp_lens[cidx, worst])
    best = torch.argmax(hyp_scores, dim=1)
    return {"tokens": hyp_tokens[cidx, best], "n_tokens": hyp_lens[cidx, best],
            "taps": state["taps"], "n_steps": step, "score": hyp_scores[cidx, best]}


def assert_ranks_agree(tokens: torch.Tensor, axis) -> None:
    """Raise unless every rank of the model axis chose the same ``tokens``:
    one all_reduce (max) of the tokens and of their negation, so max ==
    -max(-x) == min over the ranks; every rank sees the same sums and so
    raises or returns alike. A tensor-parallel decode runs the same beam
    bookkeeping on the same gathered logits on every rank; ranks that
    parted would wait on each other in the next collective, so they are
    stopped, not resynchronised."""
    import torch.distributed as dist

    both = torch.stack([tokens, -tokens])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=axis.group)
    if not torch.equal(both[0], -both[1]):
        raise RuntimeError(f"the {axis.world} tensor-parallel ranks chose different tokens")


def beam_generate_batched(
    apply_fn: Callable,
    prompt_embeds: torch.Tensor,
    cfg: LlamaConfig,
    *,
    embed_fn: Callable,
    prompt_len,
    num_beams: int = 4,
    max_new_tokens: int = 200,
    eos_id: int = 2,
    length_penalty: float = 1.0,
    tap_layers: Sequence[int] = (-4, -3, -2, -1),
    check_every: int = 8,
    trace: Optional[Dict] = None,
    axis=None,
):
    """Beam-search decode a batch of clips in lockstep: ``beam_prefill``,
    ``beam_step`` for each step while a clip is live (read on the host every
    ``check_every`` steps), ``beam_finalize``.

    Args:
      apply_fn: the model (a ``LlamaForCausalLM``, or any callable taking its
        keyword arguments and returning its dict).
      prompt_embeds: [C, P, D], left-padded to the shared bucket P: the last
        ``prompt_len[c]`` slots of clip c are real; pad slots are masked out
        of every key set and their rope positions clamp to 0.
      prompt_len: [C] ints (or one int): real prompt positions per clip.
      embed_fn: token ids [R, 1] -> embeddings [R, 1, D].
      check_every: steps between host reads of ``done``.
      trace: if a dict, receives ``gap`` [C]: the smallest gap between the
        B-th and (B+1)-th candidate score of each clip over its live steps
        (how near a tie the beam choice came).
      axis: the model axis of a tensor-parallel model (``parallel.ModelAxis``):
        at the end of the chunk, ``assert_ranks_agree`` on its tokens.

    Returns a dict of tensors on the prompt's device, leading axis C:
      tokens [C, max_new]: best hypothesis (EOS-padded), n_tokens [C],
      taps [C, max_new, D] f32: per-step tap sum of the leading beam (rows
      >= n_steps are zero), n_steps [C], score [C].
    """
    state = beam_prefill(apply_fn, prompt_embeds, cfg, prompt_len=prompt_len,
                         num_beams=num_beams, max_new_tokens=max_new_tokens, eos_id=eos_id,
                         trace=trace is not None)
    for it in range(max_new_tokens - 1):
        if it and it % check_every == 0 and not bool(live.any()):
            break
        live = beam_step(apply_fn, state, it, embed_fn=embed_fn, eos_id=eos_id,
                         length_penalty=length_penalty, tap_layers=tap_layers)
    if trace is not None:
        trace["gap"] = state["gap"]
    out = beam_finalize(state, length_penalty)
    if axis is not None and axis.world > 1:
        assert_ranks_agree(out["tokens"], axis)
    return out


def beam_generate(apply_fn: Callable, prompt_embeds: torch.Tensor, cfg: LlamaConfig, *,
                  embed_fn: Callable, num_beams: int = 4, max_new_tokens: int = 200,
                  eos_id: int = 2, length_penalty: float = 1.0,
                  tap_layers: Sequence[int] = (-4, -3, -2, -1), prompt_len=None,
                  check_every: int = 8):
    """Single-clip beam search, the C = 1 case of ``beam_generate_batched``
    (``prompt_embeds`` [1, P, D]); the same dict without the clip axis."""
    P = prompt_embeds.shape[1]
    out = beam_generate_batched(
        apply_fn, prompt_embeds[:1], cfg, embed_fn=embed_fn,
        prompt_len=P if prompt_len is None else int(prompt_len), num_beams=num_beams,
        max_new_tokens=max_new_tokens, eos_id=eos_id, length_penalty=length_penalty,
        tap_layers=tap_layers, check_every=check_every)
    return {k: v[0] for k, v in out.items()}


def greedy_generate(apply_fn: Callable, prompt_embeds: torch.Tensor, cfg: LlamaConfig, *,
                    embed_fn: Callable, max_new_tokens: int = 200, eos_id: int = 2,
                    tap_layers: Sequence[int] = (-4, -3, -2, -1), check_every: int = 8):
    """Greedy decode of one clip with the same tap semantics, over a
    monolithic cache. Returns tokens [max_new], n_steps and taps [max_new, D]."""
    P, D = prompt_embeds.shape[1], prompt_embeds.shape[2]
    dev = prompt_embeds.device
    max_len = P + max_new_tokens
    caches = init_cache(cfg, 1, max_len, dev)
    pos = torch.arange(P, device=dev)[None]
    out = apply_fn(inputs_embeds=prompt_embeds, positions=pos,
                   attn_mask=cache_mask(pos, max_len), caches=caches)
    last = torch.argmax(out["logits"][:, -1], dim=-1)               # [1]
    tokens = torch.full((max_new_tokens,), eos_id, dtype=torch.int64, device=dev)
    tokens[0] = last[0]
    taps = torch.zeros(max_new_tokens, D, device=dev)
    step = torch.ones((), dtype=torch.int64, device=dev)
    done = last[0] == eos_id
    for it in range(max_new_tokens - 1):
        live = ~done & (step < max_new_tokens)
        if it and it % check_every == 0 and not bool(live):
            break
        positions = torch.full((1, 1), P + it, dtype=torch.int64, device=dev)
        out = apply_fn(inputs_embeds=embed_fn(last[:, None]), positions=positions,
                       attn_mask=cache_mask(positions, max_len), caches=caches,
                       tap_sum_layers=tuple(tap_layers))
        nxt = torch.argmax(out["logits"][:, -1], dim=-1)
        taps[it] = torch.where(live, out["tap_sum"][0, 0], taps[it])
        tokens[it + 1] = torch.where(live, nxt[0], tokens[it + 1])
        last = torch.where(live, nxt, last)
        step = step + live.to(torch.int64)
        done = done | (live & (nxt[0] == eos_id))
    return {"tokens": tokens, "n_steps": step, "taps": taps}
