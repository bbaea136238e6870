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
"""

from __future__ import annotations

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
    """(params, audio, text, video, feat4, t_max) -> (vals_full, vals_missing):
    the model's dual-view eval with ``params`` swapped in for its own (what
    ``torch.func.functional_call`` does for a forward). The model is held
    unregistered, so nothing of it is exported as a weight or a constant."""

    def __init__(self, model):
        super().__init__()
        object.__setattr__(self, "model", model)

    def forward(self, params, audio, text, video, feat4, t_max):
        from sdumc_tpu_torch.train.step import dual_view_eval

        with _reparametrize_module(self.model, params):
            return dual_view_eval(self.model, audio, text, video, feat4, t_max)


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
    model.eval()
    params = model_params(model)
    device = next(iter(params.values())).device
    streams, t_max = _example_inputs(input_dims, B, combo, device)
    with torch.no_grad():
        program = torch.export.export(_ParamsAsInputs(model), (params, *streams, t_max),
                                      strict=False)
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
