"""The port's profiling and roofline tools against the JAX package's, on
the CPU.

- ``program_cost`` of ``a @ b`` at n = 128: 2 n^3 flops and 3 n^2 4 bytes
  (two inputs read, one output written), each equal to XLA's count of the
  same product. ``Roofline.report`` equals JAX's ``Roofline.report`` on the
  same counts and peaks; ``PEAKS`` has no TPU entry, and ``detect_peaks``
  warns on a card it has no entry for.
- Bytes come from each op's schema: an in-place op writes its target once,
  a ``_foreach_*_`` op each tensor of its list, an ``out=`` or ``copy_``
  target is written and not read. One Adam step writes the same bytes
  whether it runs foreach or tensor by tensor.
- Each custom op is counted by its formula, once, and its count equals the
  products its plain version dispatches at the same shapes: the fusion op at
  Q = 7 and at Q = 1 (the pool's shared context), f32 and bf16 x; the
  WavLM op at hd = 16 and 64, f32 and bf16; its block instance. A control
  without the registered formula counts the op as 0 flops.
- A backward inside the mode is counted: the fusion op's recomputing
  backward costs the plain version's forward and backward, plus the op's
  own forward.
- ``StepTimer`` and ``log_compile_time`` on a fake clock equal JAX's;
  ``trace`` writes a trace file.
"""

import glob
import math
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from sdumc_tpu.utils import profiling as jax_profiling
from sdumc_tpu.utils.roofline import Roofline as JaxRoofline
from sdumc_tpu.utils.roofline import program_cost as jax_program_cost
from sdumc_tpu_torch.core.config import LossConfig, ModelConfig, TrainConfig
from sdumc_tpu_torch.models import get_model
from sdumc_tpu_torch.ops.kernels import flash_wavlm, fused_cross, fused_pool
from sdumc_tpu_torch.train.state import create_train_state
from sdumc_tpu_torch.train.step import make_train_step
from sdumc_tpu_torch.utils import profiling
from sdumc_tpu_torch.ops.kernels.fused_cross import fused_cross_flops
from sdumc_tpu_torch.utils.roofline import PEAKS, CostMode, Roofline, detect_peaks, program_cost

torch.set_num_threads(1)

OPS = (torch.ops.sdumc.fused_cross, torch.ops.sdumc.flash_wavlm,
       torch.ops.sdumc.flash_wavlm_lse)


def test_matmul_flops_and_bytes_match_jax():
    n = 128
    a = torch.ones(n, n)
    flops, nbytes = program_cost(lambda: a @ a)
    assert flops == 2 * n ** 3
    assert nbytes == 3 * n * n * 4
    x = jnp.ones((n, n), jnp.float32)
    jflops, jbytes = jax_program_cost(jax.jit(lambda p, q: p @ q).lower(x, x).compile())
    assert jflops > 0 and jbytes > 0      # XLA's CPU backend reports a cost analysis
    assert (flops, nbytes) == (jflops, jbytes)


def test_views_count_no_bytes_and_copies_do():
    a = torch.ones(64, 32)
    assert program_cost(lambda: a.view(32, 64).t()[0].unsqueeze(0).expand(3, -1)) == (0.0, 0.0)
    flops, nbytes = program_cost(lambda: a.t().contiguous())
    assert flops == 0 and nbytes == 2 * a.numel() * 4


@pytest.mark.parametrize("flops,nbytes", [(5e14, 1e12), (1e12, 1e9), (3e9, 0.0), (0.0, 7e8)])
def test_roofline_report_fields_and_scaling(flops, nbytes):
    h100 = PEAKS["h100"]
    rl, jax_rl = Roofline(flops=flops, bytes=nbytes), JaxRoofline(flops=flops, bytes=nbytes)
    for seconds in (1.0, 2.0, 0.37):
        rep = rl.report(seconds, peaks=h100)
        assert rep == jax_rl.report(seconds, peaks=h100)
        assert set(rep) == {"tflops", "hbm_gbps", "mfu_pct", "hbm_util_pct"} | (
            {"arithmetic_intensity"} if nbytes else set())
    assert rl.report(1.0) == rl.report(1.0, peaks=h100)     # detect_peaks' H100 by default
    if flops == 5e14:      # doubling time halves every rate
        rep, rep2 = rl.report(1.0, peaks=h100), rl.report(2.0, peaks=h100)
        assert (rep["tflops"], rep2["tflops"]) == (500.0, 250.0)
        assert math.isclose(rep2["mfu_pct"], rep["mfu_pct"] / 2, rel_tol=1e-3)


def test_roofline_empty_add_and_peaks():
    for flops, nbytes, seconds in ((0.0, 0.0, 1.0), (5.0, 0.0, 0.0), (5.0, 7.0, -1.0)):
        got = Roofline(flops=flops, bytes=nbytes).report(seconds, peaks=PEAKS["h100"])
        assert got == JaxRoofline(flops=flops, bytes=nbytes).report(seconds,
                                                                    peaks=PEAKS["h100"]) == {}
    rl = Roofline().add((5.0, 7.0)).add((1.0, 2.0), calls=3)
    assert (rl.flops, rl.bytes) == (8.0, 13.0)
    assert set(PEAKS) == {"h100"}
    assert PEAKS["h100"] == {"flops_bf16": 989.4e12, "flops_tf32": 494.7e12,
                             "flops_f32": 66.9e12, "hbm_gbps": 3352.0}
    assert detect_peaks() is PEAKS["h100"]


def _bytes_cases():
    """(name, fn, read bytes, written bytes) of single ops on f32 [10] tensors."""
    a, b, c = torch.ones(10), torch.ones(10), torch.empty(10)
    n = 40
    return [
        ("add", lambda: a + b, 2 * n, n),
        ("add_ (its target read and written once)", lambda: a.add_(b), 2 * n, n),
        ("out= (written, not read)", lambda: torch.add(a, b, out=c), 2 * n, n),
        ("copy_", lambda: a.copy_(b), n, n),
        ("zero_", lambda: a.zero_(), 0, n),
        ("_foreach_add_ (returns nothing)", lambda: torch._foreach_add_([a, c], [b, b]),
         4 * n, 2 * n),
        ("_foreach_mul_ by a scalar", lambda: torch._foreach_mul_([a, b, c], 0.9), 3 * n, 3 * n),
        ("_foreach_sqrt", lambda: torch._foreach_sqrt([a, b]), 2 * n, 2 * n),
        ("max over a dim (two outputs)", lambda: torch.max(a.view(2, 5), 1), n, 2 * 4 + 2 * 8),
    ]


BYTES_CASES = _bytes_cases()


@pytest.mark.parametrize("case", BYTES_CASES, ids=[c[0] for c in BYTES_CASES])
def test_bytes_read_and_written_follow_the_schema(case):
    _, fn, read, written = case
    with CostMode() as mode:
        fn()
    assert (mode.bytes - mode.bytes_written, mode.bytes_written) == (read, written)


def test_adam_foreach_step_counts_its_writes():
    """One Adam step over three parameters writes each parameter and both
    moments at least once: the ``_foreach_*_`` ops (the default on the card)
    return nothing, and their writes are counted as those of the tensor by
    tensor loop, whose ops return their target."""
    def run(foreach):
        g = torch.Generator().manual_seed(0)
        params = [torch.nn.Parameter(torch.randn(*s, generator=g)) for s in ((5, 7), (3,), (4, 4, 2))]
        for p in params:
            p.grad = torch.randn(p.shape, generator=g)
        opt = torch.optim.Adam(params, lr=1e-3, foreach=foreach)
        opt.step()      # the state exists before the counted step
        with CostMode() as mode:
            opt.step()
        return mode, sum(p.numel() * p.element_size() for p in params), len(params)

    (fe, p_bytes, n), (loop, _, _) = run(True), run(False)
    assert fe.bytes_written == loop.bytes_written >= 3 * p_bytes + 4 * n   # + the step counts


@pytest.mark.parametrize("name,warns", [("NVIDIA H100 80GB HBM3", False),
                                        ("NVIDIA H100 PCIe", True), ("NVIDIA H100 NVL", True),
                                        ("NVIDIA A100-SXM4-80GB", True)])
def test_detect_peaks_names_the_sxm5_and_warns_on_another_card(name, warns, monkeypatch,
                                                               recwarn):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    assert detect_peaks() is PEAKS["h100"]
    got = [str(w.message) for w in recwarn.list]
    assert (len(got) == 1 and name in got[0]) if warns else not got


def _fusion_inputs(Q, dtype, B=3, T=11, D=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, D, generator=g).to(dtype)
    w, b = torch.randn(D, D, generator=g), torch.randn(D, generator=g)
    q = torch.randn(B, Q, D, generator=g) if Q > 1 else torch.randn(D, generator=g)
    return q, x, w, b, torch.tensor([11, 4, 7])


def _fusion_pair(Q):
    """(kernel path, plain version) of the fusion op at Q queries."""
    if Q == 1:
        return (lambda q, x, w, b, t: fused_pool.fused_attention_pool(x, w, b, q, t),
                lambda q, x, w, b, t: fused_cross.fused_attention_pool_plain(x, w, b, q, t))
    return (fused_cross.fused_cross_attention, fused_cross.fused_cross_attention_plain)


def _flash_inputs(hd, dtype, B=2, T=13, H=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, T, H, hd, generator=g).to(dtype) for _ in range(3))
    gate = torch.rand(B, H, T, generator=g)
    diag = torch.randn(H, 2 * T - 1, generator=g)
    kvalid = torch.ones(B, T)
    kvalid[1, 9:] = 0
    return q, k, v, gate, diag, kvalid


def _cases():
    """(name, op packet, kernel path, plain version, inputs, formula flops)."""
    out = []
    for Q in (7, 1):
        for dtype in (torch.float32, torch.bfloat16):
            B, T, D = 3, 11, 16
            kern, plain = _fusion_pair(Q)
            out.append((f"fusion Q={Q} {dtype}", OPS[0], kern, plain,
                        _fusion_inputs(Q, dtype), 2 * B * T * D * D + 4 * B * Q * T * D))
    for hd in (16, 64):
        for dtype in (torch.float32, torch.bfloat16):
            B, T, H = 2, 13, 3
            kw = dict(num_buckets=0, max_distance=0)

            def kern(q, k, v, gate, diag, kvalid, kw=kw):
                return flash_wavlm.flash_gated_attention(q, k, v, gate, None, kvalid, diag,
                                                         **kw)

            def plain(q, k, v, gate, diag, kvalid, kw=kw):
                return flash_wavlm.flash_gated_attention_plain(q, k, v, gate, None, kvalid,
                                                               diag, **kw)

            out.append((f"flash hd={hd} {dtype}", OPS[1], kern, plain,
                        _flash_inputs(hd, dtype), 4 * B * H * T * T * hd))
    out.append(("flash block hd=64", OPS[2], flash_wavlm.flash_block,
                flash_wavlm.flash_block_plain, _flash_inputs(64, torch.float32),
                4 * 2 * 3 * 13 * 13 * 64))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_formula_counts_its_plain_products_once(case):
    _, packet, kern, plain, inputs, expected = case
    with CostMode() as got:
        kern(*inputs)
    with CostMode() as ref:
        plain(*inputs)
    assert got.flops == ref.flops == expected
    assert dict(got.flops_by_op) == {str(packet): expected}     # no aten product of the body
    assert set(ref.flops_by_op) <= {"aten.mm", "aten.addmm", "aten.bmm"}
    with FlopCounterMode(display=False) as counter:   # the formula is FlopCounterMode's too
        kern(*inputs)
    assert counter.get_total_flops() == expected


def test_formulas_register_with_their_ops():
    """The formulas sit beside the ops: ``FlopCounterMode`` counts an op in
    a process that never imported ``utils.roofline``."""
    code = """
import sys, torch
from torch.utils.flop_counter import FlopCounterMode
from sdumc_tpu_torch.ops.kernels import fused_cross
x, q, w, b = torch.ones(2, 5, 8), torch.ones(2, 3, 8), torch.ones(8, 8), torch.ones(8)
with FlopCounterMode(display=False) as counter:
    fused_cross.fused_cross_attention(q, x, w, b)
assert "sdumc_tpu_torch.utils.roofline" not in sys.modules
print(counter.get_total_flops())
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) == 2 * 2 * 5 * 8 * 8 + 4 * 2 * 3 * 5 * 8


@pytest.mark.parametrize("case", CASES[::2], ids=[c[0] for c in CASES[::2]])
def test_control_without_the_formula_the_op_counts_nothing(case, monkeypatch):
    _, packet, kern, _, inputs, expected = case
    monkeypatch.delitem(flop_registry, packet)
    flops, nbytes = program_cost(kern, *inputs)
    assert flops == 0 and nbytes > 0
    monkeypatch.undo()
    assert program_cost(kern, *inputs)[0] == expected


def test_formula_reads_the_padded_bucket_whatever_t_max():
    q, x, w, b, _ = _fusion_inputs(7, torch.float32)
    counts = {program_cost(fused_cross.fused_cross_attention, q, x, w, b, t)[0]
              for t in (None, 1, torch.tensor([2, 3, 11]))}
    B, T, D, Q = 3, 11, 16, 7
    assert counts == {2 * B * T * D * D + 4 * B * Q * T * D}
    assert fused_cross_flops(q, x, w, out_val=torch.empty(B, Q, D)) == counts.pop()


@pytest.mark.parametrize("Q", [7, 1])
def test_backward_is_counted(Q):
    """The op's autograd.Function recomputes the plain version in its
    backward: the kernel path's forward and backward cost the plain path's
    forward and backward plus the op's own forward."""
    kern, plain = _fusion_pair(Q)
    q, x, w, b, t = _fusion_inputs(Q, torch.float32)

    def run(fn):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        with CostMode() as mode:
            fn(q, xr, wr, b, t).square().sum().backward()
        return mode

    k, p = run(kern), run(plain)
    op = k.flops_by_op["sdumc.fused_cross"]
    assert op > 0 and k.flops == p.flops + op
    forward = program_cost(plain, q, x, w, b, t)[0]
    assert p.flops > 2 * forward


def test_train_step_cost_splits_by_op():
    """One train step of the small fusion net under the mode: the fusion
    op's share is its six calls' formulas (three Q = 7 blocks, three pools;
    one [2B]-row dual forward), the rest the products of the net, the
    recompute and the backward."""
    dims, B = (16, 32, 16), 4
    model = get_model(ModelConfig(input_dims=dims, general_dim=32, layers=(32, 16),
                                  fused_layers=(32, 32)), torch.Generator().manual_seed(0))
    state = create_train_state(model, TrainConfig(), 2)
    step = make_train_step(state, LossConfig(), seed=0)
    g = torch.Generator().manual_seed(1)
    T = (10, 7, 9, 6)
    batch = {k: torch.randn(B, t, d, generator=g)
             for k, t, d in zip(("audio", "text", "video", "feat4"), T, dims + (dims[1],))}
    batch["vals"] = torch.rand(B, generator=g) * 6 - 3
    batch["t_max"] = T
    with CostMode() as mode:
        step(batch)
    op = mode.flops_by_op["sdumc.fused_cross"]
    assert 0 < op < mode.flops
    assert op % (2 * B) == 0 and mode.bytes > 0
    assert set(mode.flops_by_op) == {"sdumc.fused_cross", "aten.mm", "aten.addmm", "aten.bmm"}


class _Clock:
    def __init__(self, ticks):
        self.ticks = iter(ticks)

    def __call__(self):
        return next(self.ticks)


def test_step_timer_and_log_compile_time_match_jax(monkeypatch):
    ticks = [0.0, 0.5, 1.0, 1.2, 2.0, 2.9, 3.0, 3.05]
    got = {}
    for side, mod in (("jax", jax_profiling), ("port", profiling)):
        monkeypatch.setattr(time, "perf_counter", _Clock(ticks))
        timer = mod.StepTimer(ema=0.8)
        for _ in range(4):
            with timer:
                pass
        logged = []
        monkeypatch.setattr(time, "perf_counter", _Clock([0.0, 1.5, 2.0, 2.5]))
        for label in ("slow", "fast"):
            with mod.log_compile_time(label, log=logged.append):
                pass
        got[side] = (timer.avg, timer.count, timer.clips_per_sec(32), logged)
    assert got["port"] == got["jax"]
    assert got["port"][3] == ["[compile] slow: 1.5s"]
    assert profiling.StepTimer().clips_per_sec(8) == 0.0


def test_trace_writes_a_trace_and_is_a_no_op_when_disabled(tmp_path):
    with profiling.trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not os.path.exists(tmp_path / "off")
    with profiling.trace(str(tmp_path / "on")) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    traces = glob.glob(str(tmp_path / "on" / "*.pt.trace.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
