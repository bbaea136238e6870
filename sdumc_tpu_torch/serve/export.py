"""Serving export: the dual-view eval as ``torch.export`` programs.

Port of ``sdumc_tpu/serve/export.py``'s ``ServingBundle``. The dual-view
eval (both views, bucketed static shapes, the four ``t_max`` as int32
tensor inputs: what ``cli.infer`` runs) is exported with ``torch.export``
once per length-bucket combination, for one batch size and one device. A
later process loads the bundle and answers requests without the model's
code: importing this module registers the fusion kernel's custom op
(``sdumc::fused_cross``), which the programs call six times a request.

The parameters are inputs of every program, not weights baked into it:
the exported module holds the model unregistered and swaps the
parameters in as ``torch.func.functional_call`` does, so each program's
``state_dict`` and ``constants`` are empty. The bundle saves them once, as
``params.safetensors`` (the port's own reader and writer; no pickle, and
bf16 tensors keep their bits), and ``load`` moves them to the bundle's
device once, not with every call.

    bundle = ServingBundle.build(model, input_dims, combos, B)
    bundle.save(dir)                      # manifest.json, eval_*.pt2, params.safetensors
    bundle = ServingBundle.load(dir)      # any later process
    v_full, v_missing = bundle(batch_np_dict)   # picks the bucket, pads, runs

The feat4 beam decode (``DecodeBundle``, port of JAX's of the same name)
is exported the same way, per prompt bucket for one ``gen_batch``, but as
three programs where JAX exports one ``while_loop`` program: the prefill
with the first beam selection, one loop body (the step), and HF's
finalize (``models/generation.py beam_prefill / beam_step /
beam_finalize``). The bundle runs them as the eager engine does: the step
program for each step index, ``done`` read on the host every
``check_every`` steps. The step program writes the decode state, KV caches
included, in place: its inputs are the prefill program's outputs, so no
cache is copied from one step to the next. Its step index is a 0-d tensor
input, so one program serves every step; the generated cache is then read
whole with the unwritten slots masked (JAX's form) where the eager engine
reads only the written ones.

    bundle = DecodeBundle.build(llama, buckets=(64, 128, 256), gen_batch=4)
    bundle.save(dir)                      # manifest.json, decode_p*_c*_{prefill,step,finalize}.pt2
    out = DecodeBundle.load(dir)(prompts) # [P_i, D] f32 arrays -> tokens, n_tokens, taps, ...
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.nn.utils.stateless import _reparametrize_module

from sdumc_tpu_torch.convert.safetensors_io import load_file, save_file
# registers sdumc::fused_cross, which the saved programs name
from sdumc_tpu_torch.ops.kernels import fused_cross  # noqa: F401

FEATURES = ("audio", "text", "video", "feat4")


class _ParamsAsInputs(torch.nn.Module):
    """(params, *args) -> fn(model, *args) with ``params`` swapped in for the
    model's own (what ``torch.func.functional_call`` does for a forward).
    The model is held unregistered, so nothing of it is exported as a weight
    or a constant."""

    def __init__(self, model, fn):
        super().__init__()
        object.__setattr__(self, "model", model)
        self.fn = fn

    def forward(self, params, *args):
        with _reparametrize_module(self.model, params):
            return self.fn(self.model, *args)


def model_params(model) -> Dict[str, torch.Tensor]:
    """The model's parameters and buffers by their state-dict names."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def _example_inputs(input_dims: Sequence[int], B: int, combo: Sequence[int], device):
    da, dt, dv = input_dims[:3]
    df = input_dims[3] if len(input_dims) > 3 else dt
    streams = tuple(torch.zeros((B, t, d), dtype=torch.float32, device=device)
                    for t, d in zip(combo, (da, dt, dv, df)))
    t_max = tuple(torch.tensor(t, dtype=torch.int32, device=device) for t in combo)
    return streams, t_max


def export_dual_view_eval(model, input_dims: Sequence[int], B: int, combo: Sequence[int]):
    """One (batch_size, bucket-combo) dual-view eval program, an
    ``ExportedProgram`` for the device the model is on: (params, audio,
    text, video, feat4 [B, T_m, D_m] f32, t_max (4 int32 0-d tensors)) ->
    (vals_full [B], vals_missing [B]). The model is put in eval mode."""
    from sdumc_tpu_torch.train.step import dual_view_eval

    model.eval()
    params = model_params(model)
    device = next(iter(params.values())).device
    streams, t_max = _example_inputs(input_dims, B, combo, device)
    with torch.no_grad():
        program = torch.export.export(_ParamsAsInputs(model, dual_view_eval),
                                      (params, *streams, t_max), strict=False)
    # torch.export.save would pickle the example inputs, params and zero
    # streams included, into every program (805 MB at the largest default
    # combo), and torch.export.load may unpickle them with weights_only=False
    program.example_inputs = None
    return program


def load_exported(path: str):
    """An ``ExportedProgram`` saved by ``ServingBundle.save``."""
    return torch.export.load(path)


def _combo_key(combo: Sequence[int]) -> str:
    return "x".join(map(str, combo))


class ServingBundle:
    """A directory of exported programs and one parameter file, dispatched
    by bucket."""

    def __init__(self, combos: List[Tuple[int, ...]], B: int, input_dims: Sequence[int],
                 programs: Dict[tuple, object], params: Dict[str, torch.Tensor],
                 device: torch.device):
        self.combos = combos
        self.B = B
        self.input_dims = list(input_dims)
        self.device = torch.device(device)
        self._programs = programs
        self._params = params
        self._modules = {c: p.module() for c, p in programs.items()}

    @staticmethod
    def build(model, input_dims: Sequence[int], combos: Sequence[Sequence[int]],
              B: int) -> "ServingBundle":
        """Export every combo for the device the model is on; the bundle's
        ``export_seconds`` holds each combo's export time."""
        progs, seconds = {}, {}
        for c in map(tuple, combos):
            t0 = time.perf_counter()
            progs[c] = export_dual_view_eval(model, input_dims, B, c)
            seconds[c] = time.perf_counter() - t0
        params = {k: v.detach() for k, v in model_params(model).items()}
        device = next(iter(params.values())).device
        bundle = ServingBundle(list(progs), B, input_dims, progs, params, device)
        bundle.export_seconds = seconds
        return bundle

    # ---- persistence -----------------------------------------------------
    def save(self, out_dir: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        names = {}
        for c in self.combos:
            name = f"eval_{_combo_key(c)}.pt2"
            torch.export.save(self._programs[c], os.path.join(out_dir, name))
            names[_combo_key(c)] = name
        save_file({k: v.cpu() for k, v in self._params.items()},
                  os.path.join(out_dir, "params.safetensors"))
        with open(os.path.join(out_dir, "manifest.json"), "w") as f:
            json.dump({"batch_size": self.B, "input_dims": self.input_dims,
                       "combos": [list(c) for c in self.combos], "programs": names,
                       "device": self.device.type, "params": list(self._params)}, f, indent=1)

    @staticmethod
    def load(out_dir: str) -> "ServingBundle":
        """The bundle, its parameters on the manifest's device (a ``cuda``
        bundle raises without a card)."""
        with open(os.path.join(out_dir, "manifest.json")) as f:
            man = json.load(f)
        progs = {tuple(c): load_exported(os.path.join(out_dir, man["programs"][_combo_key(c)]))
                 for c in man["combos"]}
        device = torch.device(man["device"])
        stored = load_file(os.path.join(out_dir, "params.safetensors"))
        params = {k: stored[k].to(device) for k in man["params"]}
        return ServingBundle([tuple(c) for c in man["combos"]], man["batch_size"],
                             man["input_dims"], progs, params, device)

    # ---- dispatch --------------------------------------------------------
    def _pick(self, lens: Tuple[int, ...]) -> Tuple[int, ...]:
        fitting = [c for c in self.combos if all(l <= b for l, b in zip(lens, c))]
        if not fitting:
            raise ValueError(f"no exported bucket combo fits lengths {lens}; "
                             f"have {self.combos}")
        # the least total padded length, not the tuple order: with
        # heterogeneous combos the tuple-smallest can pad far more
        return min(fitting, key=lambda c: (sum(c), c))

    def pad(self, batch: Dict[str, np.ndarray]):
        """(combo, the program's inputs after the params on the bundle's
        device, B') for a request: the streams zero-padded to (batch_size,
        combo) in f32, the four lengths as int32 0-d tensors."""
        lens = tuple(batch[k].shape[1] for k in FEATURES)
        combo = self._pick(lens)
        Bp = batch["audio"].shape[0]
        if Bp > self.B:
            raise ValueError(f"{Bp} rows exceed the bundle's batch size {self.B}")
        cuda = self.device.type == "cuda"
        streams = []
        for k, t_b in zip(FEATURES, combo):
            x = batch[k]
            out = torch.zeros((self.B, t_b, x.shape[2]), dtype=torch.float32,
                              pin_memory=cuda)
            out[:Bp, : x.shape[1]] = torch.from_numpy(np.asarray(x, dtype=np.float32))
            streams.append(out.to(self.device, non_blocking=cuda))
        t_max = torch.tensor(lens, dtype=torch.int32).to(self.device, non_blocking=cuda)
        return combo, (*streams, tuple(t_max.unbind())), Bp

    def run(self, combo: Tuple[int, ...], inputs) -> Tuple[torch.Tensor, torch.Tensor]:
        """The combo's program on padded inputs (``pad``): device tensors."""
        return self._modules[combo](self._params, *inputs)

    def __call__(self, batch: Dict[str, np.ndarray]):
        """batch: audio/text/video/feat4 [B', T_m, D_m] (B' <= batch_size)
        -> (vals_full [B'], vals_missing [B']) as numpy."""
        combo, inputs, Bp = self.pad(batch)
        v0, v1 = self.run(combo, inputs)
        return v0[:Bp].cpu().numpy(), v1[:Bp].cpu().numpy()


# ---------------------------------------------------------------------------
# feat4 decode serving: the beam engine as three programs per prompt bucket
# ---------------------------------------------------------------------------

DECODE_PARTS = ("prefill", "step", "finalize")


def _decode_prefill(model, prompt_embeds, prompt_len, *, num_beams, max_new_tokens, eos_id):
    """The prefill program's body: ``beam_prefill``'s state with the split
    cache as plain tensors (no view of another, ``SplitCache.tensors``) and
    without ``prompt_len``, which the host loop holds."""
    from sdumc_tpu_torch.models.generation import beam_prefill

    state = beam_prefill(model, prompt_embeds, model.cfg, prompt_len=prompt_len,
                         num_beams=num_beams, max_new_tokens=max_new_tokens, eos_id=eos_id)
    del state["prompt_len"]
    state["caches"] = state["caches"].tensors()
    return state


def _decode_step(model, state, prompt_len, it, *, eos_id, length_penalty):
    """The step program's body: ``beam_step`` at the 0-d step index ``it``,
    writing ``state`` (its tensors and the caches) in place; returns the
    clips still live, [C] bool."""
    from sdumc_tpu_torch.models.generation import beam_step
    from sdumc_tpu_torch.models.llama import SplitCache

    live = {**state, "caches": SplitCache.from_tensors(state["caches"], it),
            "prompt_len": prompt_len}
    return beam_step(model, live, it, embed_fn=model.model.embed_tokens, eos_id=eos_id,
                     length_penalty=length_penalty)


def _decode_finalize(state, *, length_penalty):
    """The finalize program's body on the state without its caches. Every
    output is a tensor of its own: the state's taps and step are copied."""
    from sdumc_tpu_torch.models.generation import beam_finalize

    out = beam_finalize(state, length_penalty)
    return {k: v.clone() if k in ("taps", "n_steps") else v for k, v in out.items()}


class _Program(torch.nn.Module):
    """fn(*args) as a module with no parameters."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _small_state(state: Dict) -> Dict:
    return {k: v for k, v in state.items() if k != "caches"}


def export_beam_decode(model, *, prompt_bucket: int, gen_batch: int, num_beams: int = 4,
                       max_new_tokens: int = 200, eos_id: int = 2,
                       length_penalty: float = 1.0) -> Dict[str, object]:
    """One (prompt_bucket, gen_batch) beam decode of a ``LlamaForCausalLM``
    as three ``ExportedProgram``s for the device the model is on:

    * ``prefill``: (params, prompt_embeds [C, P, D] f32, prompt_len [C]
      int64) -> the decode state (``_decode_prefill``);
    * ``step``: (params, state, prompt_len, it 0-d int64) -> live [C] bool,
      the state written in place;
    * ``finalize``: (the state without ``caches``) -> dict(tokens, n_tokens,
      taps, n_steps, score).

    C = gen_batch, P = prompt_bucket. The model is put in eval mode."""
    model.eval()
    params = model_params(model)
    device = next(iter(params.values())).device
    pe = torch.zeros(gen_batch, prompt_bucket, model.cfg.hidden_size, device=device)
    pl = torch.full((gen_batch,), prompt_bucket, dtype=torch.int64, device=device)
    it = torch.zeros((), dtype=torch.int64, device=device)
    prefill = functools.partial(_decode_prefill, num_beams=num_beams,
                                max_new_tokens=max_new_tokens, eos_id=eos_id)
    step = functools.partial(_decode_step, eos_id=eos_id, length_penalty=length_penalty)
    finalize = functools.partial(_decode_finalize, length_penalty=length_penalty)
    with torch.no_grad():
        state = prefill(model, pe, pl)
        programs = {
            "prefill": torch.export.export(_ParamsAsInputs(model, prefill), (params, pe, pl),
                                           strict=False),
            "step": torch.export.export(_ParamsAsInputs(model, step), (params, state, pl, it),
                                        strict=False),
            "finalize": torch.export.export(_Program(finalize), (_small_state(state),),
                                            strict=False)}
    for program in programs.values():
        program.example_inputs = None      # as export_dual_view_eval: no pickled tensors
    return programs


class DecodeBundle:
    """Exported beam-decode programs (prefill, step, finalize per prompt
    bucket, for one ``gen_batch`` and one device) and one parameter file,
    dispatched by prompt bucket and driven by the host loop of
    ``beam_generate_batched``."""

    def __init__(self, buckets: Sequence[int], gen_batch: int, hidden_size: int, max_new: int,
                 programs: Dict[int, Dict[str, object]], params: Dict[str, torch.Tensor],
                 device, *, num_beams: int = 4, eos_id: int = 2, check_every: int = 8):
        self.buckets = sorted(int(b) for b in buckets)
        self.gen_batch = gen_batch
        self.hidden_size = hidden_size
        self.max_new = max_new
        self.num_beams, self.eos_id, self.check_every = num_beams, eos_id, check_every
        self.device = torch.device(device)
        self._programs = programs
        self._params = params
        self._modules = {b: {part: p.module() for part, p in progs.items()}
                         for b, progs in programs.items()}
        # the step index of every step, each a 0-d view, made once
        self._its = torch.arange(max(max_new - 1, 1), device=self.device)

    @staticmethod
    def build(model, *, buckets: Sequence[int], gen_batch: int, num_beams: int = 4,
              max_new_tokens: int = 200, eos_id: int = 2) -> "DecodeBundle":
        """Export every bucket for the device the model is on; the bundle's
        ``export_seconds`` holds each bucket's export time (its three
        programs)."""
        progs, seconds = {}, {}
        for b in sorted({int(b) for b in buckets}):
            t0 = time.perf_counter()
            progs[b] = export_beam_decode(model, prompt_bucket=b, gen_batch=gen_batch,
                                          num_beams=num_beams, max_new_tokens=max_new_tokens,
                                          eos_id=eos_id)
            seconds[b] = time.perf_counter() - t0
        params = {k: v.detach() for k, v in model_params(model).items()}
        device = next(iter(params.values())).device
        bundle = DecodeBundle(list(progs), gen_batch, model.cfg.hidden_size, max_new_tokens,
                              progs, params, device, num_beams=num_beams, eos_id=eos_id)
        bundle.export_seconds = seconds
        return bundle

    # ---- persistence -----------------------------------------------------
    def save(self, out_dir: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        names = {}
        for b in self.buckets:
            names[str(b)] = {}
            for part in DECODE_PARTS:
                name = f"decode_p{b}_c{self.gen_batch}_{part}.pt2"
                torch.export.save(self._programs[b][part], os.path.join(out_dir, name))
                names[str(b)][part] = name
        save_file({k: v.cpu() for k, v in self._params.items()},
                  os.path.join(out_dir, "params.safetensors"))
        with open(os.path.join(out_dir, "manifest.json"), "w") as f:
            json.dump({"kind": "beam_decode", "buckets": self.buckets,
                       "gen_batch": self.gen_batch, "hidden_size": self.hidden_size,
                       "max_new_tokens": self.max_new, "programs": names,
                       "device": self.device.type, "params": list(self._params),
                       "num_beams": self.num_beams, "eos_id": self.eos_id,
                       "check_every": self.check_every}, f, indent=1)

    @staticmethod
    def load(out_dir: str) -> "DecodeBundle":
        """The bundle, its parameters on the manifest's device (a ``cuda``
        bundle raises without a card)."""
        with open(os.path.join(out_dir, "manifest.json")) as f:
            man = json.load(f)
        if man.get("kind") != "beam_decode":
            raise ValueError(f"{out_dir}: not a beam-decode bundle (kind {man.get('kind')!r})")
        progs = {int(b): {part: load_exported(os.path.join(out_dir, name))
                          for part, name in man["programs"][str(b)].items()}
                 for b in man["buckets"]}
        device = torch.device(man["device"])
        stored = load_file(os.path.join(out_dir, "params.safetensors"))
        params = {k: stored.pop(k).to(device) for k in man["params"]}
        return DecodeBundle(man["buckets"], man["gen_batch"], man["hidden_size"],
                            man["max_new_tokens"], progs, params, device,
                            num_beams=man["num_beams"], eos_id=man["eos_id"],
                            check_every=man["check_every"])

    # ---- dispatch --------------------------------------------------------
    def pad(self, prompts: List[np.ndarray]):
        """(bucket, prompt_embeds [gen_batch, bucket, D] f32, prompt_len
        [gen_batch] int64) on the bundle's device: each prompt left-padded
        into the smallest bucket that fits, pad rows zero with length 1."""
        C = len(prompts)
        if not 0 < C <= self.gen_batch:
            raise ValueError(f"{C} prompts; the bundle takes 1 to {self.gen_batch}")
        longest = max(p.shape[0] for p in prompts)
        fitting = [b for b in self.buckets if longest <= b]
        if not fitting:
            raise ValueError(f"no exported prompt bucket fits length {longest}; "
                             f"have {self.buckets}")
        bucket = min(fitting)
        cuda = self.device.type == "cuda"
        pe = torch.zeros((self.gen_batch, bucket, self.hidden_size), dtype=torch.float32,
                         pin_memory=cuda)
        pl = torch.ones(self.gen_batch, dtype=torch.int64, pin_memory=cuda)
        for i, p in enumerate(prompts):
            pe[i, bucket - p.shape[0]:] = torch.from_numpy(np.asarray(p, dtype=np.float32))
            pl[i] = p.shape[0]
        return (bucket, pe.to(self.device, non_blocking=cuda),
                pl.to(self.device, non_blocking=cuda))

    def run(self, bucket: int, prompt_embeds: torch.Tensor, prompt_len: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
        """The bucket's programs on padded inputs (``pad``), as
        ``beam_generate_batched`` runs its three parts: device tensors with
        leading axis gen_batch."""
        prog = self._modules[bucket]
        with torch.inference_mode():
            state = prog["prefill"](self._params, prompt_embeds, prompt_len)
            for it in range(self.max_new - 1):
                if it and it % self.check_every == 0 and not bool(live.any()):
                    break
                live = prog["step"](self._params, state, prompt_len, self._its[it])
            return prog["finalize"](_small_state(state))

    def __call__(self, prompts: List[np.ndarray]) -> Dict[str, np.ndarray]:
        """prompts: a list of [P_i, D] f32 embedding matrices (at most
        gen_batch). Returns tokens [C, max_new], n_tokens, taps [C, max_new,
        D], n_steps and score, numpy with leading axis C = len(prompts)."""
        out = self.run(*self.pad(prompts))
        return {k: v[:len(prompts)].cpu().numpy() for k, v in out.items()}
