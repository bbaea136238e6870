"""Roofline accounting: flops and bytes of an eager run -> share of peak.

Eager PyTorch has no cost analysis of a compiled program, so
``program_cost`` counts one eager run of a function under a
``TorchDispatchMode``:

- flops: what ``torch.utils.flop_counter``'s formulas count (mm, addmm,
  bmm, baddbmm, convolutions, SDPA), the formulas ``FlopCounterMode``
  reads. Each custom op of the port registers its own beside its
  definition (``ops/kernels/fused_cross.py``, ``ops/kernels/flash_wavlm.py``),
  counting the products of the padded bucket as the plain version computes
  them, so the count is the same whichever implements the op. A custom op
  is one dispatched op, so the aten ops of its CPU implementation (the
  plain version) are not seen and it is counted once, by its formula.
  Elementwise work (tanh, softmax, the optimizer) counts no flops, where
  XLA's cost analysis counts it.
- bytes: read from each op's schema. Every tensor argument is read once,
  and one that the op mutates (``Tensor(a!)``, a list of them as the
  ``_foreach_*_`` ops take) is written once besides; an ``out=`` argument,
  and the target of ``copy_``, ``fill_`` and ``zero_``, is written only. A
  returned tensor that aliases an argument is that argument; any other is
  written once. View and alias ops count zero. A fused kernel reads and
  writes less than the chain of aten ops it replaces, so, as XLA's
  post-fusion count, the bytes depend on what implements the function; and
  as XLA's, they book every operand as moved through memory, an upper bound
  on the device's traffic (caches keep some of it on chip).

A backward run inside the mode is counted too. Counting slows every op: run
it on one untimed call, never inside a timed window.

``PEAKS`` holds the H100 SXM5's public dense peaks; ``Roofline`` turns a
count and a measured time into achieved rates and their shares of them.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections import Counter
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# public dense peaks (NVIDIA H100 SXM5 data sheet): flop/s and GB/s
PEAKS = {
    "h100": {"flops_bf16": 989.4e12, "flops_tf32": 494.7e12, "flops_f32": 66.9e12,
             "hbm_gbps": 3352.0},
}
# what torch.cuda.get_device_name() holds for each entry's card: the SXM5's
# name, not an H100 PCIe's or NVL's, whose peaks are lower
DEVICE_NAMES = {"h100": "H100 80GB HBM3"}

# in-place ops that write their target without reading it
_WRITE_ONLY = {torch.ops.aten.copy_, torch.ops.aten.fill_, torch.ops.aten.zero_}


def detect_peaks() -> Dict[str, float]:
    """The peaks of the card whose ``torch.cuda.get_device_name()`` holds
    an entry's ``DEVICE_NAMES``. Any other card gets the H100 SXM5's, with a
    warning (its shares of peak are then misread); no card gets them
    without one."""
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name()
        for key, spec in PEAKS.items():
            if DEVICE_NAMES[key] in name:
                return spec
        warnings.warn(f"{name!r} has no entry in PEAKS: its shares of peak are read against "
                      "the H100 SXM5's peaks", stacklevel=2)
    return PEAKS["h100"]


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


def op_bytes(func, args, kwargs, out) -> Tuple[int, int]:
    """(read, written) bytes of one dispatched op, from its schema (see the
    module docstring)."""
    schema = func._schema
    read = written = 0
    for i, arg in enumerate(schema.arguments):
        n = _tensor_bytes(args[i] if i < len(args) else kwargs.get(arg.name))
        mutated = arg.alias_info is not None and arg.alias_info.is_write
        if not (mutated and (arg.kwarg_only or func._overloadpacket in _WRITE_ONLY)):
            read += n
        if mutated:
            written += n
    outs = out if len(schema.returns) > 1 else (out,)
    for ret, val in zip(schema.returns, outs):
        if ret.alias_info is None:
            written += _tensor_bytes(val)
    return read, written


class CostMode(TorchDispatchMode):
    """Counts the flops and bytes of every op dispatched inside it (see
    the module docstring); ``bytes_written`` is the written part of
    ``bytes``, and ``flops_by_op`` splits the flops by op name
    (``"aten.mm"``, ``"sdumc.fused_cross"``, ...). As ``FlopCounterMode``,
    an op without a formula that decomposes is counted through its
    decomposition."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.bytes_written = 0
        self.flops_by_op: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        formula = flop_registry.get(packet)
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
            self.flops += flops
            self.flops_by_op[str(packet)] += flops
        if not (func.is_view or func is torch.ops.aten._unsafe_view.default):
            read, written = op_bytes(func, args, kwargs, out)
            self.bytes += read + written
            self.bytes_written += written
        return out


def program_cost(fn, *args, **kwargs) -> Tuple[float, float]:
    """(flops, bytes) of one eager run of ``fn(*args, **kwargs)``, its
    backward too if it runs one."""
    with CostMode() as mode:
        fn(*args, **kwargs)
    return float(mode.flops), float(mode.bytes)


@dataclasses.dataclass
class Roofline:
    """Accumulates (cost x call count) and renders utilization."""

    flops: float = 0.0
    bytes: float = 0.0

    def add(self, cost: Tuple[float, float], calls: int = 1) -> "Roofline":
        """Adds ``calls`` runs of a function whose ``program_cost`` is
        `cost`."""
        f, b = cost
        self.flops += f * calls
        self.bytes += b * calls
        return self

    def report(self, seconds: float, peaks: Optional[Dict[str, float]] = None
               ) -> Dict[str, float]:
        """-> {tflops, hbm_gbps, mfu_pct, hbm_util_pct, arithmetic_intensity}
        (empty dict when no cost was counted). ``mfu_pct`` is against the
        bf16 tensor-core peak, whatever the products' dtype; read an f32
        path's against ``flops_tf32`` or ``flops_f32`` from the same peaks.
        The bytes are an upper bound on the device's traffic (see the module
        docstring): read ``hbm_util_pct`` near or above 100 as "bound by
        memory", not as an achieved rate."""
        if not (self.flops or self.bytes) or seconds <= 0:
            return {}
        peaks = peaks or detect_peaks()
        out = {
            "tflops": round(self.flops / seconds / 1e12, 2),
            "hbm_gbps": round(self.bytes / seconds / 1e9, 1),
            "mfu_pct": round(100 * self.flops / seconds / peaks["flops_bf16"], 2),
            "hbm_util_pct": round(
                100 * self.bytes / seconds / 1e9 / peaks["hbm_gbps"], 1),
        }
        if self.bytes:
            out["arithmetic_intensity"] = round(self.flops / self.bytes, 2)
        return out
