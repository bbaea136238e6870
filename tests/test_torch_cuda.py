"""sdumc_tpu_torch's hand-written CUDA kernels against their plain versions,
on the card. Every test here is marked ``cuda`` and skips without a card.

The file imports neither JAX nor the JAX package, so it also runs where
only the port's dependencies exist:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance rtol 1e-4 / atol 1e-5: f32 in both, summed in another order over
up to a few hundred frames (the fusion kernel) or a thousand keys (the
WavLM attention kernel). The kernels' products run on the tensor cores in
the 3xTF32 split; the float64 checks at the full shapes (wavlm-large's
T = 2999 clip, the fusion kernel's 64-row dual batch) hold them to f32
grade at the same tolerance, which a single TF32 pass (about 1e-3 relative
on the scores) would not meet. The tiny WavLM model on the card runs the
attention kernel's hd = 16 instance (hidden 64, 4 heads); wavlm-large's
hd = 64 instance is tested directly. The fusion kernel's gradient (its
autograd.Function, which recomputes the plain version) is held against
autograd through the plain version on the card, and against float64 at
the full shape; a tiny fusion train step on the card against the CPU. The
feat4 decode (no kernel of the port) is held to the CPU too: exact_topk's
tie order, the padded int8 product, a tiny decode, and a --gen_batch chunk
against its clips alone. So are the text stage (f32 and bf16), a tiny
MANet and one MANet train step (float64). The fusion kernel's bf16 instance
(W in three bf16 parts on the bf16 tensor cores, 256-frame tiles) is held
to its plain version to one bf16 ulp of the output plus the f32 tolerance,
at the tile edges and with rows that end in different tiles, and to the
f32 instance rounded to bf16; with it the page-locked batches of a packed
store and a bf16 dual-view forward, card against CPU. The WavLM kernel's
bf16 instance is held to its plain version to ``flash_wavlm.bf16_tolerance``
and ``flash_wavlm.BF16_MISMATCH_LIMIT`` (both round p against the running max
of 128-key tiles), its gradient (the autograd.Function's
chunked backward) against the plain version's autograd, and a tiny bf16
WavLM extraction card against CPU. The vision stage's encoders (CLIP,
DINOv2, VideoMAE, EVA-02, ResNet-18; no kernel of the port) are held to
the CPU at tiny sizes, alone and through ``cli.extract vision``. So are
the baseline families' train steps (tfn, mfn, mctn, mult: the GEMM, LSTM,
GRU and attention paths; no kernel of the port), and ``cli.train`` /
``cli.infer --model`` for tfn and mfn. The other text families (BERT,
RoBERTa, ALBERT, DeBERTa, BLOOM, GLM; no kernel of the port) run at 2
layers through extract_text_features, card against CPU, and
``cli.extract text --family bert|glm`` on a directory written without
transformers, card against ``--device cpu``. The fusion kernel's custom op
``sdumc::fused_cross`` is called as an exported program calls it, with each
form of t_max, against its plain version; a ``ServingBundle`` exported on
the card at D = 256 answers as the eager eval with 3 + 3 launches a
request; and ``cli.export`` on the card serves from a fresh process that
imports no model code. A tiny ``DecodeBundle`` exported on the card (its
step program writing the decode state in place) answers as the eager
beam engine on the card and as the bundle exported on the CPU. Two ranks
on the card over gloo (every collective of the data-parallel step on CUDA
tensors) take the single-process step on the CPU, and two tensor-parallel
ranks (half the heads each; the flash kernel at 2 heads) give a tiny LLaMA's
logits and a tiny WavLM's last hidden state of the single process. The
WavLM kernel's block instance (ring attention's step, with each row's
log-sum-exp) is held to its plain version at offset key blocks, and two
sequence-parallel ranks on the card (the ring's rotation through gloo's
page-locked host copies) give a tiny WavLM's taps of the single process;
a one-rank ring's gradient on the card (the block instance forward, the
ring backward) equals the same ring's on the CPU.
Four ranks on the card over gloo sum a vector on the 2 x 2 hierarchical
axis (gloo's reduce-scatter and all-gather on CUDA tensors), and pass a
pipeline's microbatches stage to stage (send and receive through
page-locked host copies, bf16 as its bit patterns; the last stage's
broadcast): the tanh-affine pipeline at f32 and bf16 and a tiny LLaMA's
pipelined forward equal the single process on the CPU.
"""

import math

import numpy as np
import pytest
import torch

from sdumc_tpu_torch.ops.kernels import flash_wavlm, fused_cross, fused_pool

RTOL, ATOL = 1e-4, 1e-5
D = 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(B, T, Q, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32))  # noqa: E731
    return f(B, T, D, scale=0.5), f(D, D, scale=0.06), f(D, scale=0.06), f(B, Q, D, scale=0.5), f(D, scale=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129, 200, 300])
@pytest.mark.parametrize("tmax", ["rows", None, 37, 0])
def test_kernel_matches_plain(cuda, T, tmax):
    B = 6
    x, w, b, q, c = (t.to(cuda) for t in _inputs(B, T, 7))
    if tmax == "rows":
        rows = [T, max(1, T - 5), 1, 0, T + 3, (T + 1) // 2]   # incl. all-masked and > T
        tmax = torch.tensor(rows, dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        got = fused_cross.fused_cross_attention(q, x, w, b, tmax)
        ref = fused_cross.fused_cross_attention_plain(q, x, w, b, tmax)
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        got = fused_pool.fused_attention_pool(x, w, b, c, tmax)
        ref = fused_pool.fused_attention_pool_plain(x, w, b, c, tmax)
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 7])
def test_kernel_matches_float64_at_full_shape(cuda, Q):
    """The fusion kernel at the dual batch's shape (B = 64, D = 256, the
    2048-frame audio bucket) with mixed per-row t_max, against the plain
    version in float64 on the CPU."""
    B, T = 64, 2048
    x, w, b, q, c = _inputs(B, T, Q, seed=5)
    if Q == 1:
        q = c.expand(B, 1, D)
    rows = np.random.default_rng(6).integers(1, T + 1, size=B)
    rows[:6] = [T, T - 37, 1, 0, T + 5, 64]
    tmax = torch.from_numpy(rows.astype(np.int32))
    ref = fused_cross.fused_cross_attention_plain(q.double(), x.double(), w.double(),
                                                  b.double(), tmax.long())
    with torch.inference_mode():
        args = [t.to(cuda) for t in (x, w, b, tmax)]
        if Q == 1:
            got = fused_pool.fused_attention_pool(args[0], args[1], args[2], c.to(cuda),
                                                  args[3])[:, None]
        else:
            got = fused_cross.fused_cross_attention(q.to(cuda), *args)
    torch.testing.assert_close(got.cpu().double(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_launches_count_and_wrapper_checks(cuda):
    x, w, b, q, c = (t.to(cuda) for t in _inputs(2, 64, 7))
    fused_cross.reset_launches()
    with torch.inference_mode():
        fused_cross.fused_cross_attention(q, x, w, b, 10)
        fused_pool.fused_attention_pool(x, w, b, c, 10)
        assert fused_cross.LAUNCHES == {1: 1, 7: 1}
        with pytest.raises(TypeError):
            fused_cross.fused_cross_attention(q.double(), x.double(), w.double(), b.double())
        with pytest.raises(ValueError):
            fused_cross.fused_cross_attention(q, x.transpose(1, 2).contiguous().transpose(1, 2), w, b)
        with pytest.raises(ValueError):   # the kernel takes D = 256 only
            fused_cross.fused_cross_attention(q[..., :96].contiguous(), x[..., :96].contiguous(),
                                              w[:96, :96].contiguous(), b[:96].contiguous())
    # with a gradient: one forward launch each, the backward launches none
    w.requires_grad_()
    fused_cross.fused_cross_attention(q, x, w, b, 10).sum().backward()
    fused_pool.fused_attention_pool(x, w, b, c, 10).sum().backward()
    assert fused_cross.LAUNCHES == {1: 2, 7: 2}
    assert w.grad is not None and torch.isfinite(w.grad).all()


def _grads(fn, inputs, g):
    """fn's output and the gradients of <output, g> w.r.t. every input."""
    inputs = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*inputs)
    return out, torch.autograd.grad(out, inputs, g)


def _kernel_and_plain(Q, tmax):
    """(kernel path, plain path) as functions of (q or context, x, w, b)."""
    if Q == 1:
        return (lambda c, x, w, b: fused_pool.fused_attention_pool(x, w, b, c, tmax),
                lambda c, x, w, b: fused_pool.fused_attention_pool_plain(x, w, b, c, tmax))
    return (lambda q, x, w, b: fused_cross.fused_cross_attention(q, x, w, b, tmax),
            lambda q, x, w, b: fused_cross.fused_cross_attention_plain(q, x, w, b, tmax))


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [7, 1])
def test_kernel_gradient_matches_plain(cuda, Q):
    """The wiring of the kernel's autograd.Function: its backward recomputes
    the plain version on the saved inputs, so against autograd through the
    plain version on the card it differs only if an input is saved or
    routed wrongly. Per-row t_max (a saved tensor, incl. 0 and > T) and an
    int t_max (kept on the context); the pool's shared context summed over
    the rows; a gradient for one input only (needs_input_grad)."""
    B, T = 6, 129
    x, w, b, q, c = (t.to(cuda) for t in _inputs(B, T, Q))
    rows = torch.tensor([T, T - 5, 1, 0, T + 3, 65], dtype=torch.int32, device=cuda)
    g = torch.randn((B, D) if Q == 1 else (B, Q, D), generator=torch.Generator().manual_seed(3)).to(cuda)
    for tmax in (rows, 37):
        kern, plain = _kernel_and_plain(Q, tmax)
        inputs = [c if Q == 1 else q, x, w, b]
        out, got = _grads(kern, inputs, g)
        ref_out, ref = _grads(plain, inputs, g)
        torch.testing.assert_close(out, ref_out, rtol=RTOL, atol=ATOL)
        for name, a, r in zip(("dq", "dx", "dW", "db"), got, ref):
            torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL, msg=name)
        wl = w.detach().clone().requires_grad_()
        (dw,) = torch.autograd.grad(kern(inputs[0], x, wl, b), wl, g)
        torch.testing.assert_close(dw, ref[2], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_pinned_batches_copy_from_their_own_buffers(cuda):
    """BatchIterator(pin_memory=True) collates into page-locked tensors that
    the Batch keeps; batch_to_device_dict copies from them."""
    from sdumc_tpu_torch.data.feature_store import SyntheticSource
    from sdumc_tpu_torch.data.pipeline import BatchIterator, MoseiDataset
    from sdumc_tpu_torch.train.step import batch_to_device_dict

    sources = {k: SyntheticSource(k, d, 3, 40) for k, d in
               (("audio", 8), ("text", 16), ("video", 8), ("feat4", 16))}
    ds = MoseiDataset([f"c{i}" for i in range(5)], [{"val": 0.5}] * 5, sources)
    for batch in BatchIterator(ds, 4, shuffle=False, pin_memory=True, prefetch=2):
        assert len(batch.pinned) == 4 and all(t.is_pinned() for t in batch.pinned)
        d = batch_to_device_dict(batch, cuda)
        for name, owner in zip(("audio", "text", "video", "feat4"), batch.pinned):
            assert owner.data_ptr() == getattr(batch, name).ctypes.data
            np.testing.assert_array_equal(d[name].cpu().numpy(), getattr(batch, name))


def _bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |a| (8 significant bits), as f32."""
    return torch.ldexp(torch.ones_like(a), torch.frexp(a.abs()).exponent - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize("tmax", ["rows", None, 37, 0, -3])
def test_bf16_kernel_matches_plain(cuda, T, tmax):
    """The bf16 instance (bf16 x, the Q = 7 query the bf16 output of the
    query projection, the Q = 1 context f32) against its plain version at
    the tile edges and with t_max <= 0: both sum in f32 (to RTOL / ATOL, as
    the f32 instance) and round the output to bf16 once, so they differ by
    one bf16 ulp plus that tolerance."""
    B = 6
    x, w, b, q, c = (t.to(cuda) for t in _inputs(B, T, 7))
    x, q = x.bfloat16(), q.bfloat16()
    if tmax == "rows":
        rows = [T, max(1, T - 5), 1, 0, T + 3, (T + 1) // 2]
        tmax = torch.tensor(rows, dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        for got, ref in ((fused_cross.fused_cross_attention(q, x, w, b, tmax),
                          fused_cross.fused_cross_attention_plain(q, x, w, b, tmax)),
                         (fused_pool.fused_attention_pool(x, w, b, c, tmax),
                          fused_pool.fused_attention_pool_plain(x, w, b, c, tmax))):
            assert got.dtype == ref.dtype == torch.bfloat16
            got, ref = got.float(), ref.float()
            bound = _bf16_ulp(torch.maximum(got.abs(), ref.abs())) + RTOL * ref.abs() + ATOL
            assert ((got - ref).abs() <= bound).all(), (got - ref).abs().max().item()


# The largest share of bf16 outputs in which the bf16 instance may differ
# from the f32 instance's output rounded to bf16. Both sum f32-grade keys,
# in other orders (three bf16 parts of W on the bf16 tensor cores against
# the 3xTF32 split; the bf16 instance's tanh within 2e-7), so their f32
# outputs part by about 1e-6 relative, which moves the rounding only of an
# output within that distance of a bf16 rounding midpoint: about 1e-6 /
# 2^-9, 5e-4 of them.
BF16_VS_F32_SHARE = 0.005


@pytest.mark.cuda
@pytest.mark.parametrize("T", [65, 300, 2048])
def test_bf16_instance_is_the_f32_instance_rounded(cuda, T):
    """The bf16 instance against the f32 instance on the widened inputs,
    rounded to bf16 once: within one bf16 ulp of the larger plus the f32
    tolerance everywhere (near an output's zero the f32 sums' difference is
    many of its ulps), and differing in at most BF16_VS_F32_SHARE of the
    elements (2.8e-4 read on an H100)."""
    B = 4
    x, w, b, q, c = (t.to(cuda) for t in _inputs(B, T, 7, seed=7))
    x, q = x.bfloat16(), q.bfloat16()
    rows = torch.tensor([T, T // 2, 1, 0], dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        for got, wide in ((fused_cross.fused_cross_attention(q, x, w, b, rows),
                           fused_cross.fused_cross_attention(q.float(), x.float(), w, b, rows)),
                          (fused_pool.fused_attention_pool(x, w, b, c, rows),
                           fused_pool.fused_attention_pool(x.float(), w, b, c, rows))):
            rounded = wide.bfloat16()
            assert got.dtype == torch.bfloat16
            g, r = got.float(), rounded.float()
            bound = _bf16_ulp(torch.maximum(g.abs(), r.abs())) + RTOL * r.abs() + ATOL
            assert ((g - r).abs() <= bound).all(), ((g - r).abs() / bound).max().item()
            share = (got != rounded).float().mean().item()
            assert share <= BF16_VS_F32_SHARE, share


@pytest.mark.cuda
@pytest.mark.parametrize("T", [300, 600])
def test_bf16_rows_end_at_different_tiles(cuda, T):
    """Rows of one batch that end in different 256-frame tiles of the bf16
    instance (t_max 0, 1, 64, 127, 128, 255, 256, 257 and T), so that a row
    takes one block, two or three, and some blocks of the grid exit at once:
    against the plain version, to one bf16 ulp plus the f32 tolerance, at
    Q = 7 and Q = 1."""
    rows = [0, 1, 64, 127, 128, 255, 256, 257, T]
    x, w, b, q, c = (t.to(cuda) for t in _inputs(len(rows), T, 7, seed=11))
    x, q = x.bfloat16(), q.bfloat16()
    tmax = torch.tensor(rows, dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        for got, ref in ((fused_cross.fused_cross_attention(q, x, w, b, tmax),
                          fused_cross.fused_cross_attention_plain(q, x, w, b, tmax)),
                         (fused_pool.fused_attention_pool(x, w, b, c, tmax),
                          fused_pool.fused_attention_pool_plain(x, w, b, c, tmax))):
            got, ref = got.float(), ref.float()
            bound = _bf16_ulp(torch.maximum(got.abs(), ref.abs())) + RTOL * ref.abs() + ATOL
            assert ((got - ref).abs() <= bound).all(), (got - ref).abs().max().item()


@pytest.mark.cuda
def test_bf16_launches_gradient_and_checks(cuda):
    """The bf16 instance counts under LAUNCHES_BF16 (the f32 instance's
    counts stay 0); its gradient (the recomputing backward) equals autograd
    through the plain version, dx in bf16; an f16 x is refused."""
    B, T = 5, 129
    x, w, b, q, c = (t.to(cuda) for t in _inputs(B, T, 7))
    x, q = x.bfloat16(), q.bfloat16()
    rows = torch.tensor([T, 64, 1, 0, T + 2], dtype=torch.int32, device=cuda)
    fused_cross.reset_launches()
    for Q in (7, 1):
        kern, plain = _kernel_and_plain(Q, rows)
        inputs = [c if Q == 1 else q, x, w, b]
        g = torch.randn((B, D) if Q == 1 else (B, Q, D), generator=torch.Generator().manual_seed(3))
        out, got = _grads(kern, inputs, g.to(cuda).bfloat16())
        _, ref = _grads(plain, inputs, g.to(cuda).bfloat16())
        assert out.dtype == torch.bfloat16 and got[1].dtype == torch.bfloat16
        for name, a, r in zip(("dq", "dx", "dW", "db"), got, ref):
            torch.testing.assert_close(a, r, rtol=0, atol=0, msg=name)
    assert fused_cross.LAUNCHES_BF16 == {1: 1, 7: 1} and fused_cross.LAUNCHES == {1: 0, 7: 0}
    with pytest.raises(TypeError):
        fused_cross.fused_cross_attention(q, x.half(), w, b, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_pinned_packed_batches_keep_the_store_dtype(cuda, tmp_path, dtype):
    """BatchIterator(pin_memory=True) on a packed store collates into
    page-locked tensors of the store's dtype (bf16 owners behind uint16
    views; int8) that batch_to_device_dict copies from; the device batch
    holds the store's bits, and an int8 batch its scales."""
    from sdumc_tpu_torch.data.packed import PackedSource, pack_features
    from sdumc_tpu_torch.data.pipeline import BatchIterator, MoseiDataset
    from sdumc_tpu_torch.train.step import batch_to_device_dict

    rng = np.random.default_rng(5)
    sources = {}
    for key, d in (("audio", 8), ("text", 16), ("video", 8), ("feat4", 16)):
        (tmp_path / key).mkdir()
        for i in range(5):
            np.save(tmp_path / key / f"c{i}.npy", rng.normal(size=(3 + 7 * i, d)).astype(np.float32))
        pack_features(str(tmp_path / key), str(tmp_path / f"{key}_{dtype}"), dtype=dtype)
        sources[key] = PackedSource(str(tmp_path / f"{key}_{dtype}"), key)
    ds = MoseiDataset([f"c{i}" for i in range(5)], [{"val": 0.5}] * 5, sources)
    want = torch.bfloat16 if dtype == "bfloat16" else torch.int8
    for batch in BatchIterator(ds, 4, shuffle=False, pin_memory=True, prefetch=2):
        assert all(t.is_pinned() and t.dtype == want for t in batch.pinned)
        d = batch_to_device_dict(batch, cuda)
        for name, owner in zip(("audio", "text", "video", "feat4"), batch.pinned):
            assert owner.data_ptr() == getattr(batch, name).ctypes.data
            assert d[name].dtype == want and torch.equal(d[name].cpu(), owner)
            if dtype == "int8":
                np.testing.assert_array_equal(d[name + "_scale"].cpu().numpy(),
                                              batch.scales[name])


@pytest.mark.cuda
def test_fusion_bf16_dual_view_on_card_matches_cpu(cuda):
    """The fused dual view at bf16 streams: card (the bf16 instance, cuBLAS
    bf16 products reducing in f32) vs CPU (plain). The same bf16 roundings
    on both sides, summed in another order: the predictions and rnc within
    1e-4 of their largest value, the text representations to a relative L2
    error of 3e-4 and ``features`` to 5e-4 (the seeded cases of
    bench/bf16_gap.py read <= 1.6e-4, and <= 3.4e-4 up to 16 rows, on the
    H100). A control
    with the card's streams in f32 (the same inputs widened) must fail the
    check on the text representations (it reads >= 7.6e-4 there; at the
    predictions 1e-6-5e-5, too close to tell)."""
    from sdumc_tpu_torch.cli.common import bf16_full_precision_reduction
    from sdumc_tpu_torch.core.config import ModelConfig
    from sdumc_tpu_torch.models.fusion import SDUMCFusion

    dims = (32, 64, 32)
    model = SDUMCFusion(ModelConfig(input_dims=dims), torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(3)
    a, t, f, v = (torch.from_numpy(rng.normal(size=(3, n, d)).astype(np.float32)).bfloat16()
                  for n, d in ((70, dims[0]), (20, dims[1]), (12, dims[1]), (40, dims[2])))
    kw = dict(t_max=(65, (17, 12), 33), dual=True)
    fused_cross.reset_launches()
    with torch.inference_mode(), bf16_full_precision_reduction():
        ref, ref_aux = model(a, (t, f), v, **kw)
        model.to(cuda)
        got, aux = model(a.to(cuda), (t.to(cuda), f.to(cuda)), v.to(cuda), **kw)
        assert fused_cross.LAUNCHES_BF16 == {1: 3, 7: 3} and fused_cross.LAUNCHES == {1: 0, 7: 0}
        a32, t32, f32, v32 = (z.float().to(cuda) for z in (a, t, f, v))
        _, control_aux = model(a32, (t32, f32), v32, **kw)
    for name, g, r in (("vals", got, ref), ("rnc", aux["rnc"], ref_aux["rnc"])):
        assert g.dtype == torch.float32
        err = (g.cpu() - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item(), (name, err)

    def rel_l2(out, key):
        return ((out[key].cpu() - ref_aux[key]).norm() / ref_aux[key].norm()).item()

    for key, limit in (("features", 5e-4), ("text_feat", 3e-4), ("text_query_feat", 3e-4)):
        assert aux[key].dtype == torch.float32 and rel_l2(aux, key) <= limit, key
    for key in ("text_feat", "text_query_feat"):
        assert rel_l2(control_aux, key) > 3e-4, key


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [7, 1])
def test_kernel_gradient_matches_float64_at_full_shape(cuda, Q):
    """The gradient at the dual batch's shape (B = 64, D = 256, the
    2048-frame audio bucket, mixed per-row t_max incl. 0 and > T) against
    the plain version in float64 on the CPU. Tolerance per tensor: max abs
    diff <= 1e-4 max |ref| + 1e-6 (f32 sums over up to B T = 131072 terms)."""
    B, T = 64, 2048
    x, w, b, q, c = _inputs(B, T, Q, seed=8)
    rows = np.random.default_rng(9).integers(1, T + 1, size=B)
    rows[:5] = [T, T - 37, 1, 0, T + 5]
    tmax = torch.from_numpy(rows.astype(np.int32))
    g = torch.randn((B, D) if Q == 1 else (B, Q, D), generator=torch.Generator().manual_seed(1))
    inputs = [c if Q == 1 else q, x, w, b]
    kern, _ = _kernel_and_plain(Q, tmax.to(cuda))
    _, plain = _kernel_and_plain(Q, tmax.long())
    _, got = _grads(kern, [t.to(cuda) for t in inputs], g.to(cuda))
    _, ref = _grads(plain, [t.double() for t in inputs], g.double())
    for name, a, r in zip(("dq", "dx", "dW", "db"), got, ref):
        err = (a.cpu().double() - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item() + 1e-6, (name, err, r.abs().max().item())


@pytest.mark.cuda
def test_fusion_dual_view_on_card_matches_cpu(cuda):
    """The whole fused dual-view forward: card (kernel) vs CPU (plain)."""
    from sdumc_tpu_torch.core.config import ModelConfig
    from sdumc_tpu_torch.models.fusion import SDUMCFusion

    dims = (32, 64, 32)
    model = SDUMCFusion(ModelConfig(input_dims=dims), torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(3)
    a, t, f, v = (torch.from_numpy(rng.normal(size=(3, n, d)).astype(np.float32))
                  for n, d in ((70, dims[0]), (20, dims[1]), (12, dims[1]), (40, dims[2])))
    kw = dict(t_max=(65, (17, 12), 33), dual=True)
    with torch.inference_mode():
        ref, ref_aux = model(a, (t, f), v, **kw)
        model.to(cuda)
        got, aux = model(a.to(cuda), (t.to(cuda), f.to(cuda)), v.to(cuda), **kw)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-5)
    for key in ("features", "rnc", "text_feat", "text_query_feat"):
        torch.testing.assert_close(aux[key].cpu(), ref_aux[key], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_fusion_train_step_on_card_matches_cpu(cuda):
    """One dual-view loss and backward (dropout off, gradients flowing):
    card (kernels, recomputing backward) vs CPU (plain). Loss rtol 1e-4;
    each gradient max abs diff <= 1e-5 max |grad| + 1e-6 (f32 reassociation
    through the net and its backward; a TF32 product would miss it). Then a train step with dropout on:
    six forward launches per step, a finite loss."""
    import copy

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.core.config import LossConfig, ModelConfig, TrainConfig
    from sdumc_tpu_torch.models.fusion import SDUMCFusion
    from sdumc_tpu_torch.train.state import create_train_state
    from sdumc_tpu_torch.train.step import dual_view_loss, make_train_step

    set_matmul_precision("highest")
    dims = (32, 64, 32)
    model = SDUMCFusion(ModelConfig(input_dims=dims), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.normal(size=(3, n, d)).astype(np.float32))
             for k, n, d in (("audio", 70, dims[0]), ("text", 20, dims[1]),
                             ("video", 40, dims[2]), ("feat4", 12, dims[1]))}
    batch["vals"] = torch.from_numpy(rng.uniform(-3, 3, size=3).astype(np.float32))
    batch["t_max"] = (65, 17, 33, 12)
    loss_cfg = LossConfig(text_feat_w=0.1, text_query_feat_w=0.7)
    card = copy.deepcopy(model).to(cuda).eval()
    model.eval()
    ref, _ = dual_view_loss(model, batch, loss_cfg)
    ref.backward()
    fused_cross.reset_launches()
    got, _ = dual_view_loss(card, {k: v.to(cuda) if torch.is_tensor(v) else v
                                   for k, v in batch.items()}, loss_cfg)
    got.backward()
    assert fused_cross.LAUNCHES == {1: 3, 7: 3}
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=0)
    for (name, p), pc in zip(model.named_parameters(), card.parameters()):
        if p.grad is None:
            assert pc.grad is None, name
            continue
        err = (pc.grad.cpu() - p.grad).abs().max().item()
        assert err <= 1e-5 * p.grad.abs().max().item() + 1e-6, (name, err)

    state = create_train_state(card, TrainConfig(), 4)
    step = make_train_step(state, loss_cfg, seed=0)
    fused_cross.reset_launches()
    metrics = step({k: v.to(cuda) if torch.is_tensor(v) else v for k, v in batch.items()})
    assert fused_cross.LAUNCHES == {1: 3, 7: 3} and torch.isfinite(metrics["loss"])


NB, MD = 40, 100     # the tiny bucket config of the CPU tests


def _flash_inputs(B, T, H, hd, mask, seed=0):
    """q, k, v, gate, rel_embed, kvalid; row 0 of kvalid attends to every
    key, row 1 to one key only, the rest to a prefix ("prefix") or to a
    random pattern ("scattered")."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    q, k, v = f(B, T, H, hd), f(B, T, H, hd), f(B, T, H, hd)
    gate = torch.from_numpy((1.0 + rng.uniform(size=(B, H, T))).astype(np.float32))
    rel_embed = f(NB, H)
    if mask == "prefix":
        lengths = np.concatenate([[T, 1], rng.integers(1, T + 1, size=B - 2)])
        kvalid = np.arange(T)[None, :] < lengths[:, None]
    else:
        kvalid = rng.uniform(size=(B, T)) < 0.6
        kvalid[0] = True
        kvalid[1] = False
        kvalid[1, T // 2] = True
    return q, k, v, gate, rel_embed, torch.from_numpy(kvalid.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129, 249, 1000])
@pytest.mark.parametrize("mask", ["prefix", "scattered"])
def test_flash_kernel_matches_plain(cuda, T, mask):
    hd = 16 if T in (65, 129) else 64
    args = [t.to(cuda) for t in _flash_inputs(3, T, 4, hd, mask)]
    kw = dict(num_buckets=NB, max_distance=MD)
    with torch.inference_mode():
        got = flash_wavlm.flash_gated_attention(*args, **kw)
        ref = flash_wavlm.flash_gated_attention_plain(*args, **kw)
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        # unmasked, and a row with no valid key (averages v, as plain does)
        got = flash_wavlm.flash_gated_attention(*args[:5], **kw)
        ref = flash_wavlm.flash_gated_attention_plain(*args[:5], **kw)
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        none = torch.zeros_like(args[5])
        got = flash_wavlm.flash_gated_attention(*args[:5], none, **kw)
        ref = flash_wavlm.flash_gated_attention_plain(*args[:5], none, **kw)
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


def _flash_float64(q, k, v, gate, bias_diag, kvalid):
    """The attention in float64 on the CPU, softmax included."""
    q, k, v, gate, bias_diag = (t.double() for t in (q, k, v, gate, bias_diag))
    T, hd = q.shape[1], q.shape[3]
    scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    scores = scores + gate[..., None] * flash_wavlm.dense_bias(bias_diag, T)[None]
    if kvalid is not None:
        scores = scores.masked_fill(~(kvalid[:, None, None, :] > 0), flash_wavlm.NEG)
    return torch.einsum("bhts,bshd->bthd", torch.softmax(scores, dim=-1), v)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_flash_kernel_matches_float64_at_wavlm_large(cuda, masked):
    """wavlm-large's heads (H = 16, hd = 64) over the 60-s clip (T = 2999),
    all keys valid or the last 1000 masked, against float64 on the CPU."""
    B, T, H, hd, nb, md = 1, 2999, 16, 64, 320, 800
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, T, H, hd)).astype(np.float32))
               for _ in range(3))
    gate = torch.from_numpy((1.0 + rng.uniform(size=(B, H, T))).astype(np.float32))
    rel = torch.from_numpy(rng.normal(size=(nb, H)).astype(np.float32))
    kvalid = (torch.arange(T) < T - 1000).float()[None] if masked else None
    diag = flash_wavlm.bias_diag_for(rel, T, nb, md)
    ref = _flash_float64(q, k, v, gate, diag, kvalid)
    with torch.inference_mode():
        got = flash_wavlm.flash_gated_attention(
            *(t.to(cuda) for t in (q, k, v, gate)), None,
            None if kvalid is None else kvalid.to(cuda), diag.to(cuda),
            num_buckets=nb, max_distance=md)
    torch.testing.assert_close(got.cpu().double(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_flash_launches_and_wrapper_checks(cuda):
    q, k, v, gate, rel, kvalid = (t.to(cuda) for t in _flash_inputs(2, 70, 4, 64, "prefix"))
    kw = dict(num_buckets=NB, max_distance=MD)
    flash_wavlm.reset_launches()
    with torch.inference_mode():
        flash_wavlm.flash_gated_attention(q, k, v, gate, rel, kvalid, **kw)
        diag = flash_wavlm.bias_diag_for(rel, 70, NB, MD)
        flash_wavlm.flash_gated_attention(q, k, v, gate, None, kvalid.bool(), diag, **kw)
        assert flash_wavlm.LAUNCHES == 2
        with pytest.raises(TypeError):
            flash_wavlm.flash_gated_attention(q.double(), k.double(), v.double(),
                                              gate.double(), rel.double(), **kw)
        with pytest.raises(ValueError, match="contiguous"):
            flash_wavlm.flash_gated_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                                              k, v, gate, rel, **kw)
        with pytest.raises(ValueError, match="hd"):      # no hd = 8 instance
            flash_wavlm.flash_gated_attention(q[..., :8].contiguous(), k[..., :8].contiguous(),
                                              v[..., :8].contiguous(), gate, rel, **kw)
    # under grad the kernel runs forward (it was forward-only before its
    # autograd.Function); its gradient is held in test_flash_gradient_on_card
    out = flash_wavlm.flash_gated_attention(q.requires_grad_(), k, v, gate, rel, **kw)
    assert out.requires_grad and flash_wavlm.LAUNCHES == 3
    assert flash_wavlm.LAUNCHES_BF16 == 0


@pytest.mark.cuda
@pytest.mark.parametrize("stable", [True, False])
def test_tiny_wavlm_on_card_matches_cpu(cuda, stable):
    """A tiny WavLM (hd = 16) on the card, kernel attention, against the
    plain path on the CPU: every hidden-state tap, with a batched pad mask."""
    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

    set_matmul_precision("highest")
    cfg = WavLMConfig.tiny(hidden_size=64, num_heads=4, do_stable_layer_norm=stable,
                           feat_extract_norm="layer" if stable else "group")
    torch.manual_seed(0)
    model = WavLMModel(cfg).eval()
    rng = np.random.default_rng(2)
    wav = torch.from_numpy(rng.normal(size=(2, 1800)).astype(np.float32))
    t = cfg.output_length(1800)
    mask = torch.from_numpy(np.arange(t)[None, :] < np.array([t, t - 9])[:, None])
    with torch.inference_mode():
        ref = model(wav, pad_mask=mask, output_hidden_states=True)["hidden_states"]
        model.to(cuda)
        flash_wavlm.reset_launches()
        got = model(wav.to(cuda), pad_mask=mask.to(cuda),
                    output_hidden_states=True)["hidden_states"]
    assert flash_wavlm.LAUNCHES == cfg.num_layers
    keep = mask[:, :, None]
    for i, (g, r) in enumerate(zip(got, ref)):
        torch.testing.assert_close(torch.where(keep, g.cpu(), 0.0), torch.where(keep, r, 0.0),
                                   rtol=1e-4, atol=1e-4, msg=f"hidden_states[{i}]")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 129, 249, 1000, 128, 255, 256, 257])
@pytest.mark.parametrize("mask", ["prefix", "scattered"])
def test_flash_bf16_kernel_matches_plain(cuda, T, mask):
    """The bf16 instance against its plain version at the edges of the
    128-key (and 128-query) tiles, with masks, without, and with a row of
    no valid key, to ``flash_wavlm.bf16_tolerance`` (a p one bf16 ulp
    apart: 2^-7 of the output's spread over v, one bf16 ulp, the f32 sums)
    and to ``flash_wavlm.BF16_MISMATCH_LIMIT`` in the share of elements that
    differ (both round p against the running max of 128-key tiles)."""
    hd = 16 if T in (65, 129, 257) else 64
    args = [t.to(cuda).bfloat16() for t in _flash_inputs(3, T, 4, hd, mask)[:5]]
    kvalid = _flash_inputs(3, T, 4, hd, mask)[5].to(cuda)
    kw = dict(num_buckets=NB, max_distance=MD)
    flash_wavlm.reset_launches()
    with torch.inference_mode():
        for mask_arg in (kvalid, None, torch.zeros_like(kvalid)):
            got = flash_wavlm.flash_gated_attention(*args, mask_arg, **kw)
            ref = flash_wavlm.flash_gated_attention_plain(*args, mask_arg, **kw)
            assert got.dtype == ref.dtype == torch.bfloat16
            err = (got.float() - ref.float()).abs()
            bound = flash_wavlm.bf16_tolerance(ref, args[2])
            assert (err <= bound).all(), (err / bound).max().item()
            share = flash_wavlm.bf16_mismatch_share(got, ref)
            assert share <= flash_wavlm.BF16_MISMATCH_LIMIT, share
    assert flash_wavlm.LAUNCHES_BF16 == 3 and flash_wavlm.LAUNCHES == 0


@pytest.mark.cuda
def test_flash_bf16_at_wavlm_large_and_checks(cuda):
    """wavlm-large's heads over the 60-s clip, the last 1000 keys masked, the
    bf16 instance against its plain version on the card (the bound and the
    mismatch share of test_flash_bf16_kernel_matches_plain); the gate and the
    bias may come in f32 (rounded by the wrapper); a bf16 q with f32 k is
    refused."""
    B, T, H, hd, nb, md = 1, 2999, 16, 64, 320, 800
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, T, H, hd)).astype(np.float32)).to(cuda)
               for _ in range(3))
    gate = torch.from_numpy((1.0 + rng.uniform(size=(B, H, T))).astype(np.float32)).to(cuda)
    rel = torch.from_numpy(rng.normal(size=(nb, H)).astype(np.float32)).to(cuda)
    kvalid = (torch.arange(T, device=cuda) < T - 1000).float()[None]
    kw = dict(num_buckets=nb, max_distance=md)
    with torch.inference_mode():
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        got = flash_wavlm.flash_gated_attention(qb, kb, vb, gate, rel, kvalid, **kw)
        ref = flash_wavlm.flash_gated_attention_plain(qb, kb, vb, gate, rel, kvalid, **kw)
        err = (got.float() - ref.float()).abs()
        bound = flash_wavlm.bf16_tolerance(ref, vb)
        assert (err <= bound).all(), (err / bound).max().item()
        share = flash_wavlm.bf16_mismatch_share(got, ref)
        assert share <= flash_wavlm.BF16_MISMATCH_LIMIT, share
        with pytest.raises(TypeError):
            flash_wavlm.flash_gated_attention(qb, k, vb, gate, rel, kvalid, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_gradient_on_card(cuda, dtype):
    """FlashGatedAttention on the card (the kernel forward, the chunked
    backward on the card): at f32 its gradients for q, k, v, the gate and
    rel_embed equal autograd through the plain version to rtol 3e-4 / atol
    3e-5 (JAX's tolerance, tests/test_flash_wavlm.py); at bf16 they take the
    inputs' dtypes and equal the f32 chunked backward run on the widened
    inputs and the kernel's bf16 output, rounded once, to one bf16 ulp."""
    B, T, H, hd = 3, 200, 4, 64
    base = [t.to(cuda) for t in _flash_inputs(B, T, H, hd, "prefix", seed=5)]
    kvalid = base[5]
    g = torch.randn(B, T, H, hd, generator=torch.Generator().manual_seed(2)).to(cuda)
    kw = dict(num_buckets=NB, max_distance=MD)
    flash_wavlm.reset_launches()
    leaves = [t.to(dtype).requires_grad_() for t in base[:5]]
    out = flash_wavlm.flash_gated_attention(*leaves, kvalid, **kw)
    got = torch.autograd.grad(out, leaves, g.to(dtype))
    assert (flash_wavlm.LAUNCHES_BF16 if dtype == torch.bfloat16 else flash_wavlm.LAUNCHES) == 1
    if dtype == torch.float32:
        plain = [t.clone().detach().requires_grad_() for t in base[:5]]
        ref_out = flash_wavlm.flash_gated_attention_plain(*plain, kvalid, **kw)
        want = torch.autograd.grad(ref_out, plain, g)
        for name, a, r in zip(("dq", "dk", "dv", "dgate", "drel"), got, want):
            torch.testing.assert_close(a, r, rtol=3e-4, atol=3e-5, msg=name)
        return
    diag = flash_wavlm.bias_diag_for(leaves[4].detach(), T, NB, MD)
    wide = flash_wavlm.flash_backward(*(t.detach().float() for t in leaves[:4]), diag.float(),
                                      kvalid, out.detach().float(), g.bfloat16().float())
    for name, a, r in zip(("dq", "dk", "dv", "dgate"), got[:4], wide[:4]):
        assert a.dtype == torch.bfloat16
        err = (a.float() - r.bfloat16().float()).abs()
        assert (err <= _bf16_ulp(r)).all(), name
    assert got[4].dtype == torch.bfloat16 and torch.isfinite(got[4].float()).all()


@pytest.mark.cuda
def test_tiny_bf16_wavlm_on_card_matches_cpu(cuda):
    """A tiny WavLM (hd = 16) in bf16 through extract_audio_features on the
    card (the bf16 instance, cuBLAS / cuDNN bf16) against the CPU (the plain
    version): relative L2 error per clip <= 4 u (u = 2^-8; each rounds at
    every op in its own order); one bf16 launch per layer and batch, none of
    the f32 instance."""
    from sdumc_tpu_torch.extract.audio import extract_audio_features, plan_batches
    from sdumc_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

    cfg = WavLMConfig.tiny(hidden_size=64, num_heads=4)
    torch.manual_seed(0)
    model = WavLMModel(cfg).eval()
    sd = model.state_dict()
    rng = np.random.default_rng(3)
    wavs = [rng.normal(size=(n,)).astype(np.float32) for n in (900, 1800, 1300)]
    kw = dict(layer_ids=(-2,), batch_size=2, buckets=(1000, 2000), dtype="bfloat16")
    ref = extract_audio_features(model, cfg, wavs, device="cpu", **kw)
    card = WavLMModel(cfg).eval()
    card.load_state_dict(sd)
    flash_wavlm.reset_launches()
    got = extract_audio_features(card, cfg, wavs, device=cuda, **kw)
    n_batches = len(plan_batches(cfg, [len(w) for w in wavs], 2, (1000, 2000)))
    assert flash_wavlm.LAUNCHES_BF16 == cfg.num_layers * n_batches
    assert flash_wavlm.LAUNCHES == 0
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.linalg.norm(g - r) / np.linalg.norm(r) <= 4 * 2.0 ** -8


# ---------------------------------------------------------------- feat4 decode on the card
# (no kernel of the port: cuBLAS and PyTorch's own kernels; the tie order of
# exact_topk, the padded int8 product and per-clip independence on CUDA)

@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((4, 128000), 8), ((2, 33), 5), ((3, 64), 1)])
def test_exact_topk_ties_on_card(cuda, shape, k):
    """Ties to the lowest index on CUDA too (torch.topk promises no order):
    duplicated leaders and a run of equal values at the top, equal to the
    CPU's result bit for bit."""
    from sdumc_tpu_torch.models.generation import exact_topk

    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    x[:, 1] = x[:, 0]
    x[:, 5:9] = x.max(axis=-1, keepdims=True)
    want_v, want_i = exact_topk(torch.from_numpy(x), k)
    got_v, got_i = exact_topk(torch.from_numpy(x).to(cuda), k)
    assert torch.equal(got_i.cpu(), want_i) and torch.equal(got_v.cpu(), want_v)
    assert got_i[0, :min(k, 4)].tolist() == [5, 6, 7, 8][:min(k, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 16, 17, 40])
def test_int8_matmul_on_card_is_the_integer_product(cuda, M):
    """torch._int_mm with the rows zero-padded where M <= 16 (decode at
    --gen_batch 4 has 16 rows): equal to the CPU's exact product."""
    from sdumc_tpu_torch.ops.quant import int8_matmul

    rng = np.random.default_rng(M)
    a = torch.from_numpy(rng.integers(-127, 128, size=(M, 64), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, size=(48, 64), dtype=np.int8))
    got = int8_matmul(a.to(cuda), w.to(cuda))
    assert got.dtype == torch.int32 and got.shape == (M, 48)
    assert torch.equal(got.cpu(), int8_matmul(a, w))


def _tiny_llama(seed=0, **kw):
    from sdumc_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_weights

    cfg = LlamaConfig.tiny(num_layers=2, vocab_size=96, hidden_size=48, intermediate_size=96, **kw)
    return cfg, init_weights(LlamaForCausalLM(cfg), seed=seed, std=0.2).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("quant,kv_quant", [(None, None), ("int8", None), ("w8a8", "int8")])
def test_tiny_decode_on_card_matches_cpu(cuda, quant, kv_quant):
    """A tiny beam-4 decode of 2 clips (f32, TF32 off) on the card against
    the CPU: tokens equal, taps to 1e-4; with int8 weights (w8a8: the padded
    int32 product) and the int8 KV cache too."""
    import copy

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.models.generation import beam_generate_batched
    from sdumc_tpu_torch.models.llama import model_from_state_dict
    from sdumc_tpu_torch.ops.quant import quantize_params

    set_matmul_precision("highest")
    cfg, model = _tiny_llama()
    if quant or kv_quant:
        import dataclasses

        cfg = dataclasses.replace(cfg, quant=quant, kv_quant=kv_quant)
        sd = dict(model.state_dict())
        model = model_from_state_dict(cfg, quantize_params(sd, quant) if quant else sd)
    rng = np.random.default_rng(1)
    pe = torch.from_numpy((rng.normal(size=(2, 12, 48)) * 0.5).astype(np.float32))
    pe[1, :4] = 0.0
    outs = []
    for m, dev in ((model, "cpu"), (copy.deepcopy(model).to(cuda), cuda)):
        with torch.inference_mode():
            out = beam_generate_batched(m, pe.to(dev), cfg, embed_fn=m.model.embed_tokens,
                                        prompt_len=[12, 8], num_beams=4, max_new_tokens=10)
        outs.append({k: v.cpu() for k, v in out.items()})
    cpu, card = outs
    for key in ("tokens", "n_tokens", "n_steps"):
        assert torch.equal(card[key], cpu[key]), key
    torch.testing.assert_close(card["taps"], cpu["taps"], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gen_batch_chunk_matches_solo_on_card(cuda, dtype):
    """Feat4Extractor at --gen_batch 4 on the card: a chunk of 4 clips of one
    prompt bucket gives each clip what it gets alone (a chunk of one, filled
    by repeating it, the same GEMM shapes): tokens equal, taps equal."""
    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.extract.llm4wav import Feat4Extractor
    from sdumc_tpu_torch.extract.projector import EncoderProjectorConcat

    set_matmul_precision("highest")
    cfg, model = _tiny_llama(seed=1, dtype=dtype)
    model.to(cuda)
    torch.manual_seed(2)
    proj = EncoderProjectorConcat(5, 16, 32, 48).to(cuda).eval()
    ex = Feat4Extractor(model, proj, None, max_new_tokens=12, prompt_buckets=(64,), gen_batch=4)
    rng = np.random.default_rng(3)
    feats = [rng.normal(size=(t, 16)).astype(np.float32) for t in (60, 150, 200, 300)]
    chunk = ex.extract_many(feats)
    for f, got in zip(feats, chunk):
        solo = ex.extract_many([f])[0]
        np.testing.assert_array_equal(got["tokens"], solo["tokens"])
        np.testing.assert_array_equal(got["taps"], solo["taps"])


class _WordTokenizer:
    """A whitespace tokenizer with BOS and an invertible decode: the surface
    extract_text_features needs (the probe and the encoder)."""

    def __init__(self):
        self.ids, self.words = {}, {1: "<s>"}

    def __call__(self, text):
        out = [1]
        for w in text.split():
            if w not in self.ids:
                self.ids[w] = len(self.ids) + 3
                self.words[self.ids[w]] = w
            out.append(self.ids[w])
        return {"input_ids": out}

    def decode(self, ids):
        return " ".join(self.words[i] for i in ids)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiny_text_extraction_on_card_matches_cpu(cuda, dtype):
    """extract_text_features (length buckets, a short last chunk, an empty
    row) on the card against the CPU: f32 with TF32 off to 1e-4; bf16 to a
    few bf16 ulps of the largest feature (cuBLAS and the CPU round the
    products' sums at other places)."""
    import copy

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.extract.text import extract_text_features
    from sdumc_tpu_torch.models.llama import LlamaConfig, LlamaModel, init_weights

    set_matmul_precision("highest")
    cfg = LlamaConfig.tiny(num_layers=2, vocab_size=96, hidden_size=48, intermediate_size=96,
                           dtype=dtype)
    model = init_weights(LlamaModel(cfg), seed=4, std=0.2).eval()
    words = "today is a good day and the movie was really not bad at all".split()
    rng = np.random.default_rng(5)
    sents = [" ".join(rng.choice(words, size=n)) for n in (3, 9, 1, 14, 20, 5, 7)] + [""]
    kw = dict(layer_ids=(-3,), buckets=(8, 16), batch_size=3)
    cpu = extract_text_features(model, _WordTokenizer(), sents, **kw)
    card = extract_text_features(copy.deepcopy(model).to(cuda), _WordTokenizer(), sents, **kw)
    top = max(float(np.abs(c).max()) for c in cpu)
    for c, g in zip(cpu, card):
        assert c.shape == g.shape
        if dtype == torch.float32:
            np.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-4)
        else:
            assert np.abs(g - c).max() <= 4 * 2.0 ** (np.floor(np.log2(top)) - 7)


def _tiny_manet(seed=0):
    from sdumc_tpu_torch.models.manet import MANet, MANetConfig, init_weights

    return init_weights(MANet(MANetConfig(layers=(1, 1, 1, 1), num_classes=3)), seed)


@pytest.mark.cuda
def test_tiny_manet_on_card_matches_cpu(cuda):
    """MANet (layers 1,1,1,1) embeddings and logits in eval mode with BN
    statistics drawn at random, f32 with cuDNN's TF32 off: card against
    CPU to 1e-4 of the largest value."""
    import copy

    from sdumc_tpu_torch.cli.common import set_matmul_precision

    set_matmul_precision("highest")
    model = _tiny_manet().eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    x = torch.from_numpy(np.random.default_rng(2).uniform(size=(3, 3, 224, 224)).astype(np.float32))
    card = copy.deepcopy(model).to(cuda)
    with torch.inference_mode():
        for kw in ({}, {"return_embedding": False}):
            want, got = model(x, **kw), card(x.to(cuda), **kw)
            for w, g in zip(want if isinstance(want, tuple) else (want,),
                            got if isinstance(got, tuple) else (got,)):
                assert (g.cpu() - w).abs().max().item() <= 1e-4 * w.abs().max().item()


@pytest.mark.cuda
def test_manet_train_step_on_card_matches_cpu(cuda):
    """One MANet train step (BN in training mode, SGD with weight decay) in
    float64 on the card against the CPU: the loss, every gradient to 1e-9
    of the largest and the running statistics (f32 steps part by up to
    4e-3 of the largest gradient from rounding order alone)."""
    from sdumc_tpu_torch.extract.manet_train import make_optimizer, make_train_step

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(size=(4, 224, 224, 3)))
    y = torch.tensor([0, 2, 1, 2])
    runs = []
    for dev in ("cpu", cuda):
        model = _tiny_manet(seed=5).double().to(dev)
        opt, sched = make_optimizer(model, 0.01, 10)
        loss = make_train_step(model, opt, sched)(x.to(dev), y.to(dev))["loss"].item()
        runs.append((loss, {k: p.grad.cpu() for k, p in model.named_parameters()},
                     {k: b.cpu() for k, b in model.named_buffers()}))
    (loss_cpu, g_cpu, b_cpu), (loss_card, g_card, b_card) = runs
    assert loss_card == pytest.approx(loss_cpu, rel=1e-10)
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    for k, g in g_cpu.items():
        assert (g_card[k] - g).abs().max().item() <= 1e-9 * gmax, k
    for k, b in b_cpu.items():
        torch.testing.assert_close(b_card[k], b, rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------- the vision stage

def _vision_tiny(kind):
    """(a tiny seeded encoder of family ``kind`` in eval mode, its input
    shape, its config.json or None): parameters normal(0, 0.1), LayerNorm
    weights about 1, BN statistics drawn at random."""
    from sdumc_tpu_torch.models import clip_vit, dinov2, eva02, resnet, videomae

    torch.manual_seed(11)
    if kind == "clip":
        c = clip_vit.CLIPVisionConfig.tiny()
        model, shape = clip_vit.CLIPVisionTower(c), (3, 3, 32, 32)
        config = {"model_type": "clip_vision_model", "hidden_size": c.hidden_size,
                  "intermediate_size": c.intermediate_size, "num_hidden_layers": c.num_layers,
                  "num_attention_heads": c.num_heads, "image_size": c.image_size,
                  "patch_size": c.patch_size, "projection_dim": c.projection_dim}
    elif kind == "dinov2":
        c = dinov2.Dinov2Config.tiny()
        model, shape = dinov2.Dinov2Model(c), (2, 3, 28, 28)
        config = {"model_type": "dinov2", "hidden_size": c.hidden_size,
                  "num_hidden_layers": c.num_layers, "num_attention_heads": c.num_heads,
                  "image_size": c.image_size, "patch_size": c.patch_size}
    elif kind == "videomae":
        c = videomae.VideoMAEConfig.tiny(use_mean_pooling=False)
        model, shape = videomae.VideoMAEModel(c), (2, 4, 3, 16, 16)
        config = {"model_type": "videomae", "hidden_size": c.hidden_size,
                  "num_hidden_layers": c.num_layers, "num_attention_heads": c.num_heads,
                  "intermediate_size": c.intermediate_size, "image_size": c.image_size,
                  "patch_size": c.patch_size, "num_frames": c.num_frames,
                  "tubelet_size": c.tubelet_size, "use_mean_pooling": False}
    elif kind == "eva02":
        model, shape, config = eva02.Eva02Model(eva02.Eva02Config.tiny(
            hidden_size=128, num_heads=2, mlp_hidden=64, ref_grid=(4, 4))), (2, 3, 28, 28), None
    else:
        model, shape, config = resnet.ResNetEmbedding(resnet.ResNetConfig.tiny()), (3, 3, 64, 64), None
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        for m in model.modules():
            if isinstance(m, (torch.nn.LayerNorm, torch.nn.BatchNorm2d)):
                m.weight.add_(1.0)
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return model.eval(), shape, config


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["clip", "dinov2", "videomae", "eva02", "imagenet"])
def test_tiny_vision_encoder_on_card_matches_cpu(cuda, kind):
    """Each vision encoder, f32 with TF32 off, card against CPU: every
    output to 1e-4 of its largest value."""
    import copy

    from sdumc_tpu_torch.cli.common import set_matmul_precision

    set_matmul_precision("highest")
    model, shape, _ = _vision_tiny(kind)
    x = torch.from_numpy(np.random.default_rng(13).normal(size=shape).astype(np.float32))
    card = copy.deepcopy(model).to(cuda)
    with torch.inference_mode():
        want, got = model(x), card(x.to(cuda))
    if not isinstance(want, dict):
        want, got = {"embedding": want}, {"embedding": got}
    for key, w in want.items():
        assert (got[key].cpu() - w).abs().max().item() <= 1e-4 * w.abs().max().item(), key


def _write_bmp(path, rgb):
    """A 24-bit bottom-up BMP (OpenFace's crop format), without Pillow."""
    import struct

    h, w, _ = rgb.shape
    stride = (3 * w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)
    header = (struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
              + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0))
    path.write_bytes(header + rows.tobytes())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["clip", "dinov2", "videomae", "eva02", "imagenet"])
def test_cli_extract_vision_on_card_matches_cpu(cuda, tmp_path, kind):
    """``cli.extract vision`` on the card (its default device) against
    ``--device cpu``, on seeded tiny weights written in each family's
    format and 112x112 BMP crops: every file to 1e-4 of its largest value."""
    import json

    from sdumc_tpu_torch.cli import extract
    from sdumc_tpu_torch.convert import safetensors_io

    model, _, config = _vision_tiny(kind)
    weights = tmp_path / "m"
    weights.mkdir()
    if kind == "imagenet":
        torch.save(model.state_dict(), weights / "r.pth")
        flags = ["--checkpoint", str(weights / "r.pth")]
    else:
        safetensors_io.save_file(model.state_dict(), str(weights / "model.safetensors"))
        (weights / "config.json").write_text(json.dumps(config or {"architecture": "eva02"}))
        flags = ["--model_dir", str(weights)]
    rng = np.random.default_rng(14)
    for vid, n in (("v_a", 23), ("v_b", 1), ("v_c", 0)):
        (tmp_path / "faces" / vid).mkdir(parents=True)
        for i in range(n):
            _write_bmp(tmp_path / "faces" / vid / f"f_{i:03d}.bmp",
                       rng.integers(0, 256, size=(112, 112, 3), dtype=np.uint8))
    argv = ["vision", "--model", kind, *flags, "--face_dir", str(tmp_path / "faces"),
            "--batch_size", "2"]
    extract.main(argv + ["--save_dir", str(tmp_path / "card")])
    extract.main(argv + ["--save_dir", str(tmp_path / "cpu"), "--device", "cpu"])
    for vid in ("v_a", "v_b", "v_c"):
        got, want = np.load(tmp_path / "card" / f"{vid}.npy"), np.load(tmp_path / "cpu" / f"{vid}.npy")
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------------ the baseline zoo

def _baseline_batch(dims, seed=15):
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.normal(size=(6, n, d)).astype(np.float32))
             for k, n, d in (("audio", 70, dims[0]), ("text", 20, dims[1]),
                             ("video", 40, dims[2]), ("feat4", 12, dims[1]))}
    batch["vals"] = torch.from_numpy(rng.uniform(-3, 3, size=6).astype(np.float32))
    batch["t_max"] = (65, 17, 33, 12)
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("name, rtol", [("tfn", 1e-5), ("mfn", 1e-5), ("mctn", 1e-5),
                                        ("mult", 1e-4)])
def test_baseline_train_step_on_card_matches_cpu(cuda, name, rtol):
    """One dual-view loss and backward of a baseline family at a small
    width (dims 32 / 64 / 32, hidden 16, align_t 8; dropout off, MCTN
    teacher-forced so that no draw enters): card vs CPU. Loss rtol 1e-4;
    each gradient max abs diff <= rtol max |grad| + 1e-6 (1e-5; MulT's
    softmax over the padded keys and its LayerNorms 1e-4, as chip_smoke's
    phase 24). No kernel of the port is launched."""
    import copy

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.core.config import LossConfig, ModelConfig
    from sdumc_tpu_torch.models import get_model
    from sdumc_tpu_torch.models.layers import use_generator
    from sdumc_tpu_torch.train.step import dual_view_loss

    set_matmul_precision("highest")
    dims = (32, 64, 32)
    cfg = ModelConfig(name=name, input_dims=dims, baseline_hidden_dim=16, baseline_mem_dim=16,
                      baseline_align_t=8, dropout=0.0, mctn_teacher_forcing=1.0)
    model = get_model(cfg, torch.Generator().manual_seed(0)).train()
    card = copy.deepcopy(model).to(cuda)
    use_generator(model, torch.Generator().manual_seed(1))
    use_generator(card, torch.Generator(device=cuda).manual_seed(1))
    batch = _baseline_batch(dims)
    loss_cfg = LossConfig(text_feat_w=0.1, text_query_feat_w=0.7)
    ref, _ = dual_view_loss(model, batch, loss_cfg)
    ref.backward()
    fused_cross.reset_launches()
    flash_wavlm.reset_launches()
    got, _ = dual_view_loss(card, {k: v.to(cuda) if torch.is_tensor(v) else v
                                   for k, v in batch.items()}, loss_cfg)
    got.backward()
    assert not any(fused_cross.LAUNCHES.values()) and flash_wavlm.LAUNCHES == 0
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=0)
    for (key, p), pc in zip(model.named_parameters(), card.parameters()):
        err = (pc.grad.cpu() - p.grad).abs().max().item()
        assert err <= rtol * p.grad.abs().max().item() + 1e-6, (key, err)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tfn", "mfn"])
def test_cli_train_baseline_on_card(cuda, tmp_path, name):
    """cli.train --model NAME on the card (its default device) for one
    epoch of the small synthetic store: finite losses, and best_full.pt
    through cli.infer --model NAME reproduces the logged test MAE."""
    from sdumc_tpu_torch.cli import infer, train

    common = ["--synthetic", "--feat_scale", "16", "--batch_size", "8", "--model", name]
    result = train.main(common + ["--epochs", "1", "--checkpoint_dir", str(tmp_path / "ck"),
                                  "--save_root", str(tmp_path / "saved")])
    (h,) = result["history"]
    assert all(np.isfinite(h[k]) for k in ("train_loss", "train_mse_full", "eval_mse_full"))
    assert next(result["state"].model.parameters()).is_cuda
    out = infer.main(common + ["--checkpoint", str(tmp_path / "ck" / "best_full.pt")])
    assert out["full"]["mae"] == pytest.approx(result["best_full"]["mae"], rel=1e-6)


def _seeded(model, seed, std=0.05):
    """Every weight normal(0, std), 1-D norm scales 1 + normal(0, std),
    drawn on the CPU from one generator."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen) * std
            p.copy_(1 + noise if p.ndim == 1 and "norm" in name.lower() else noise)
    return model.eval()


def _text_family(kind, layers=2):
    """A port model of each text family at a small width, 2 layers."""
    from sdumc_tpu_torch.models import albert, bert, bloom, deberta, glm

    return {
        "bert": lambda: bert.BertModel(bert.BertConfig.tiny(num_layers=layers, vocab_size=120)),
        "roberta": lambda: bert.BertModel(bert.BertConfig.tiny(num_layers=layers, vocab_size=120,
                                                               position_offset=2)),
        "albert": lambda: albert.AlbertModel(albert.AlbertConfig.tiny(num_layers=layers,
                                                                      vocab_size=120)),
        "deberta": lambda: deberta.DebertaModel(deberta.DebertaConfig.tiny(
            num_layers=layers, vocab_size=120, max_relative_positions=8)),
        "bloom": lambda: bloom.BloomModel(bloom.BloomConfig.tiny(num_layers=layers,
                                                                 vocab_size=120)),
        "glm": lambda: glm.GlmModel(glm.GlmConfig.tiny(num_layers=layers, vocab_size=120)),
    }[kind]()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bert", "roberta", "albert", "deberta", "bloom", "glm"])
def test_text_family_on_card_matches_cpu(cuda, kind):
    """Each text family at 2 layers (f32, TF32 off) through
    extract_text_features on the card against the CPU: length buckets, a
    short last chunk padded with rows of length 0, an empty row; 1e-4."""
    import copy

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.extract.text import extract_text_features

    set_matmul_precision("highest")
    model = _seeded(_text_family(kind), seed=7)
    words = "today is a good day and the movie was really not bad at all".split()
    rng = np.random.default_rng(8)
    sents = [" ".join(rng.choice(words, size=n)) for n in (3, 9, 1, 14, 20, 5, 7)] + [""]
    kw = dict(layer_ids=(-2, -1), buckets=(8, 16), batch_size=3)
    cpu = extract_text_features(model, _WordTokenizer(), sents, **kw)
    card = extract_text_features(copy.deepcopy(model).to(cuda), _WordTokenizer(), sents, **kw)
    for c, g in zip(cpu, card):
        assert c.shape == g.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-4)


def _write_family_dir(path, kind):
    """A tiny directory the port's loaders read, written without
    transformers: config.json, the model's state dict as model.safetensors
    (the port's keys are HF's), and a tokenizer (BERT's vocab.txt; for
    GLM a byte-level tokenizer.json with the [gMASK] <sop> template)."""
    import json
    import os

    from sdumc_tpu_torch.convert import safetensors_io
    from sdumc_tpu_torch.convert.hf_tokenizer import BYTE_CHARS

    os.makedirs(path, exist_ok=True)
    words = "today is a good day and the movie was really not bad at all".split()
    if kind == "bert":
        vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words + list("abcdefghijklmnopqrstuvwxyz")
        (path / "vocab.txt").write_text("\n".join(vocab) + "\n")
        config = {"model_type": "bert", "vocab_size": len(vocab), "hidden_size": 32,
                  "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 64,
                  "max_position_embeddings": 64, "type_vocab_size": 2}
        from sdumc_tpu_torch.convert.hf_bert import config_from_hf
        from sdumc_tpu_torch.models.bert import BertModel as cls
        tok_cfg = {"tokenizer_class": "BertTokenizer", "do_lower_case": True}
    else:
        vocab = {c: i for i, c in enumerate(BYTE_CHARS.values())}
        merges = []
        for w in words:
            b = "".join(BYTE_CHARS[x] for x in (" " + w).encode())
            for n in range(2, len(b) + 1):
                if b[:n] not in vocab:
                    vocab[b[:n]] = len(vocab)
                    merges.append(f"{b[:n - 1]} {b[n - 1]}")
        n = len(vocab)
        spec = {"normalizer": None,
                "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False},
                "model": {"type": "BPE", "vocab": vocab, "merges": merges},
                "post_processor": {"type": "TemplateProcessing", "single": [
                    {"SpecialToken": {"id": "[gMASK]", "type_id": 0}},
                    {"SpecialToken": {"id": "<sop>", "type_id": 0}},
                    {"Sequence": {"id": "A", "type_id": 0}}],
                    "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                             {"Sequence": {"id": "B", "type_id": 1}}],
                    "special_tokens": {"[gMASK]": {"id": "[gMASK]", "ids": [n], "tokens": ["[gMASK]"]},
                                       "<sop>": {"id": "<sop>", "ids": [n + 1], "tokens": ["<sop>"]}}},
                "decoder": {"type": "ByteLevel"},
                "added_tokens": [{"id": n + i, "content": t, "single_word": False,
                                  "lstrip": False, "rstrip": False, "normalized": False,
                                  "special": True} for i, t in enumerate(("[gMASK]", "<sop>"))]}
        (path / "tokenizer.json").write_text(json.dumps(spec))
        config = {"model_type": "glm", "vocab_size": n + 2, "hidden_size": 48,
                  "intermediate_size": 80, "num_hidden_layers": 2, "num_attention_heads": 4,
                  "num_key_value_heads": 2, "head_dim": 12, "rms_norm_eps": 1e-5}
        from sdumc_tpu_torch.convert.hf_glm import config_from_hf
        from sdumc_tpu_torch.models.glm import GlmModel as cls
        tok_cfg = {"tokenizer_class": "PreTrainedTokenizerFast"}
    (path / "config.json").write_text(json.dumps(config))
    (path / "tokenizer_config.json").write_text(json.dumps(tok_cfg))
    model = _seeded(cls(config_from_hf(config)), seed=9)
    safetensors_io.save_file(model.state_dict(), str(path / "model.safetensors"))
    return words


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bert", "glm"])
def test_cli_extract_text_family_on_card_matches_cpu(cuda, tmp_path, kind):
    """``cli.extract text --family bert|glm`` on the card (its default
    device) against ``--device cpu`` on the same directory: every feature
    finite, of the same shape, within 1e-4."""
    import csv

    from sdumc_tpu_torch.cli import extract

    words = _write_family_dir(tmp_path / "model", kind)
    rng = np.random.default_rng(10)
    rows = [(f"u{i}", " ".join(rng.choice(words, size=n))) for i, n in enumerate((2, 7, 12, 30))]
    with open(tmp_path / "t.csv", "w", newline="") as f:
        csv.writer(f).writerows([("name", "sentence")] + rows + [("empty", "")])
    common = ["text", "--family", kind, "--model_dir", str(tmp_path / "model"),
              "--trans_path", str(tmp_path / "t.csv")]
    extract.main(common + ["--save_dir", str(tmp_path / "card")])
    extract.main(common + ["--save_dir", str(tmp_path / "cpu"), "--device", "cpu"])
    for name, _ in rows + [("empty", "")]:
        g, c = (np.load(tmp_path / d / f"{name}.npy") for d in ("card", "cpu"))
        assert g.shape == c.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["none", "int", "0-d", "rows"])
@pytest.mark.parametrize("q_count", [7, 1])
def test_fused_cross_op_on_card_matches_plain(cuda, form, q_count):
    """``sdumc::fused_cross`` called as an op (what an exported program
    calls) with each form of t_max, f32 and bf16 x, against the plain
    version; one launch a call, counted by its instance."""
    B, T = 6, 129
    x, w, b, q, c = (t.to(cuda) for t in _inputs(B, T, 7))
    tensor, scalar = {"none": (None, None), "int": (None, 70),
                      "0-d": (torch.tensor(37, dtype=torch.int32, device=cuda), None),
                      "rows": (torch.tensor([T, 64, 1, 0, T + 3, 65], dtype=torch.int32,
                                            device=cuda), None)}[form]
    t_max = tensor if tensor is not None else scalar
    query = q if q_count == 7 else c.reshape(1, D)
    for xx in (x, x.bfloat16()):
        fused_cross.reset_launches()
        with torch.inference_mode():
            got = torch.ops.sdumc.fused_cross(query, xx, w, b, tensor, scalar, 0.3, q_count == 7)
            if q_count == 7:
                ref = fused_cross.fused_cross_attention_plain(query, xx, w, b, t_max)
            else:
                ref = fused_pool.fused_attention_pool_plain(xx, w, b, c, t_max)[:, None]
        counts = fused_cross.LAUNCHES_BF16 if xx.dtype == torch.bfloat16 else fused_cross.LAUNCHES
        assert counts[q_count] == 1 and sum(fused_cross.LAUNCHES.values()) + sum(
            fused_cross.LAUNCHES_BF16.values()) == 1
        assert got.dtype == ref.dtype == xx.dtype and got.shape == (B, q_count, D)
        got, ref = got.float(), ref.float()
        bound = RTOL * ref.abs() + ATOL
        if xx.dtype == torch.bfloat16:
            bound = bound + _bf16_ulp(torch.maximum(got.abs(), ref.abs()))
        assert ((got - ref).abs() <= bound).all(), (xx.dtype, (got - ref).abs().max().item())


def _serve_request(rng, rows, lens, dims):
    return {k: rng.normal(size=(rows, t, d)).astype(np.float32)
            for k, t, d in zip(("audio", "text", "video", "feat4"), lens, dims)}


def _serve_eager(model, batch, combo, rows, device):
    """The eager eval step on the request padded to (rows, combo)."""
    from sdumc_tpu_torch.train.step import make_eval_step

    d = {}
    for k, t_b in zip(("audio", "text", "video", "feat4"), combo):
        x = batch[k]
        p = np.zeros((rows, t_b, x.shape[2]), np.float32)
        p[: x.shape[0], : x.shape[1]] = x
        d[k] = torch.from_numpy(p).to(device)
    d["t_max"] = tuple(batch[k].shape[1] for k in ("audio", "text", "video", "feat4"))
    n = batch["audio"].shape[0]
    return tuple(v[:n].cpu().numpy() for v in make_eval_step(model)(d))


@pytest.mark.cuda
def test_serving_bundle_on_card_matches_eager(cuda, tmp_path):
    """A bundle exported on the card at the fusion net's width (D = 256)
    answers as the eager eval on the card and as the same model on the CPU
    (where the op runs its plain version), at two lengths in one combo, with
    3 + 3 f32 launches a request; its programs hold no weights."""
    import copy

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.core.config import ModelConfig
    from sdumc_tpu_torch.models.fusion import SDUMCFusion
    from sdumc_tpu_torch.serve import ServingBundle

    set_matmul_precision("highest")
    dims, combos, rows = (32, 64, 32, 64), [(64, 16, 32, 16), (128, 16, 32, 16)], 8
    model = SDUMCFusion(ModelConfig(input_dims=dims[:3]), torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(model).eval()
    model.to(cuda).eval()
    ServingBundle.build(model, dims, combos, rows).save(str(tmp_path / "b"))
    bundle = ServingBundle.load(str(tmp_path / "b"))
    assert bundle.device.type == "cuda"
    assert all(len(p.state_dict) == 0 and len(p.constants) == 0 for p in bundle._programs.values())
    rng = np.random.default_rng(11)
    for lens in ((40, 16, 9, 5), (64, 3, 32, 16), (100, 12, 20, 16)):
        batch = _serve_request(rng, 5, lens, dims)
        fused_cross.reset_launches()
        got = bundle(batch)
        assert fused_cross.LAUNCHES == {1: 3, 7: 3}, fused_cross.LAUNCHES
        assert sum(fused_cross.LAUNCHES_BF16.values()) == 0
        ref = _serve_eager(model, batch, bundle._pick(lens), rows, cuda)
        plain = _serve_eager(cpu_model, batch, bundle._pick(lens), rows, torch.device("cpu"))
        for g, r, c in zip(got, ref, plain):
            assert g.shape == (5,) and np.isfinite(g).all()
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-4)


_CARD_SERVER = """
import json, sys
import numpy as np
sys.path.insert(0, {repo!r})
from sdumc_tpu_torch.ops.kernels import fused_cross
from sdumc_tpu_torch.serve import ServingBundle
bundle = ServingBundle.load({bundle!r})
req = np.load({req!r})
fused_cross.reset_launches()
full, missing = bundle({{k: req[k] for k in ("audio", "text", "video", "feat4")}})
np.savez({out!r}, full=full, missing=missing)
print(json.dumps({{"launches": fused_cross.LAUNCHES, "device": bundle.device.type,
                   "models": [m for m in sys.modules if m.startswith("sdumc_tpu_torch.models")]}}))
"""


@pytest.mark.cuda
def test_cli_export_on_card_serves_in_a_fresh_process(cuda, tmp_path):
    """``cli.export`` (its default device, the card) at small widths, then a
    process that imports only ``sdumc_tpu_torch.serve`` loads the bundle and
    answers through the kernel; the answers equal the eager eval's."""
    import json
    import os
    import subprocess
    import sys

    from sdumc_tpu_torch.cli import export as export_cli
    from sdumc_tpu_torch.cli.common import build_model
    from sdumc_tpu_torch.core.config import ExperimentConfig

    dims = (32, 64, 32, 64)
    assert export_cli.main(["--out_dir", str(tmp_path / "b"), "--batch_size", "4",
                            "--input_dims", "32,64,32,64", "--combos", "16x8x16x8"]) == 0
    batch = _serve_request(np.random.default_rng(12), 3, (11, 8, 5, 6), dims)
    np.savez(tmp_path / "req.npz", **batch)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _CARD_SERVER.format(repo=repo, bundle=str(tmp_path / "b"),
                               req=str(tmp_path / "req.npz"), out=str(tmp_path / "out.npz"))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    info = json.loads(run.stdout.strip().splitlines()[-1])
    assert info == {"launches": {"1": 3, "7": 3}, "device": "cuda", "models": []}
    model = build_model(ExperimentConfig(), dims, cuda)
    ref = _serve_eager(model, batch, (16, 8, 16, 8), 4, cuda)
    out = np.load(tmp_path / "out.npz")
    np.testing.assert_allclose(out["full"], ref[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out["missing"], ref[1], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("quant,kv_quant", [(None, None), ("w8a8", "int8")])
def test_decode_bundle_on_card_matches_eager_and_cpu(cuda, tmp_path, quant, kv_quant):
    """A tiny DecodeBundle (f32, TF32 off; w8a8 runs the padded int32 product
    in the programs) exported on the card, saved and loaded: its step
    program writes its inputs in place on the card's torch (a step writes
    generated-cache slot 0 of the state the prefill program returned), and
    a partial batch answers as the eager engine on the card and as the same
    bundle exported on the CPU (tokens and step counts equal, taps to
    1e-4)."""
    import copy
    import dataclasses

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.models.generation import beam_generate_batched
    from sdumc_tpu_torch.models.llama import model_from_state_dict
    from sdumc_tpu_torch.ops.quant import quantize_params
    from sdumc_tpu_torch.serve import DecodeBundle

    set_matmul_precision("highest")
    cfg, model = _tiny_llama(seed=4)
    if quant or kv_quant:
        cfg = dataclasses.replace(cfg, quant=quant, kv_quant=kv_quant)
        sd = dict(model.state_dict())
        model = model_from_state_dict(cfg, quantize_params(sd, quant) if quant else sd)
    card_model = copy.deepcopy(model).to(cuda)
    rng = np.random.default_rng(21)
    prompts = [(rng.normal(size=(n, 48)) * 0.5).astype(np.float32) for n in (12, 7, 16)]
    outs = {}
    for dev, m in (("cpu", model), ("cuda", card_model)):
        DecodeBundle.build(m, buckets=(8, 16), gen_batch=4,
                           max_new_tokens=10).save(str(tmp_path / dev))
        bundle = DecodeBundle.load(str(tmp_path / dev))
        assert bundle.device.type == dev
        outs[dev] = bundle(prompts)
    bucket, pe, pl = bundle.pad(prompts)
    assert bucket == 16 and pe.device.type == "cuda"
    prog = bundle._modules[bucket]
    with torch.inference_mode():
        state = prog["prefill"](bundle._params, pe, pl)
        assert state["caches"]["gk"].abs().sum().item() == 0
        prog["step"](bundle._params, state, pl, bundle._its[0])
        written = state["caches"]["gk"].float().abs().sum(dim=(-2, -1))
        assert (written[:, :, 0] > 0).all() and (written[:, :, 1:] == 0).all()
        assert state["step"].tolist() == [2] * 4
        eager = beam_generate_batched(card_model, pe, cfg, embed_fn=card_model.model.embed_tokens,
                                      prompt_len=pl, num_beams=4, max_new_tokens=10)
    eager = {k: v[:3].cpu().numpy() for k, v in eager.items()}
    for ref in (eager, outs["cpu"]):
        for key in ("tokens", "n_tokens", "n_steps"):
            np.testing.assert_array_equal(outs["cuda"][key], ref[key], err_msg=key)
        np.testing.assert_allclose(outs["cuda"]["taps"], ref["taps"], rtol=1e-4, atol=1e-4)


_DP_RANK = """
import sys
import numpy as np, torch
from sdumc_tpu_torch.cli.common import set_matmul_precision
from sdumc_tpu_torch.core.config import LossConfig, ModelConfig, TrainConfig
from sdumc_tpu_torch.models.fusion import SDUMCFusion
from sdumc_tpu_torch.ops.kernels import fused_cross
from sdumc_tpu_torch.parallel import initialize_from_env, make_data_axis, shard_batch, shutdown
from sdumc_tpu_torch.train.state import create_train_state
from sdumc_tpu_torch.train.step import make_train_step

work = sys.argv[1]
set_matmul_precision("highest")
rank, world = initialize_from_env(device="cuda")
dev = torch.device("cuda", torch.cuda.current_device())
data = np.load(work + "/case.npz")
batch = {k: torch.from_numpy(data[k]).to(dev) for k in ("audio", "text", "video", "feat4", "vals")}
batch["t_max"] = tuple(int(t) for t in data["t_max"])
model = SDUMCFusion(ModelConfig(input_dims=tuple(int(d) for d in data["dims"]), dropout=0.0,
                                attn_dropout=0.0), torch.Generator().manual_seed(0)).to(dev)
state = create_train_state(model, TrainConfig(), 4)
step = make_train_step(state, LossConfig(text_feat_w=0.1, text_query_feat_w=0.7), seed=0,
                       axis=make_data_axis(dev))
fused_cross.reset_launches()
loss = step(shard_batch(batch, rank, world))["loss"].item()
np.savez(work + f"/rank{rank}.npz", loss=loss,
         launches=np.array([fused_cross.LAUNCHES.get(1, 0), fused_cross.LAUNCHES.get(7, 0)]),
         **{"g/" + k: p.grad.cpu().numpy() for k, p in model.named_parameters()
            if p.grad is not None})
shutdown()
"""


@pytest.mark.cuda
def test_two_rank_gloo_step_on_card_matches_cpu(cuda, tmp_path):
    """Two ranks on the card over gloo (each collective of the step on CUDA
    tensors), each with half the rows of a global batch of 4, take one
    train step (dropout off): the global-batch loss and the summed
    gradients equal the single-process step on the CPU, at the tolerance
    of the card-vs-CPU step above; 3 + 3 fusion launches on each rank."""
    import importlib.util
    import pathlib
    import sys

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.core.config import LossConfig, ModelConfig, TrainConfig
    from sdumc_tpu_torch.models.fusion import SDUMCFusion
    from sdumc_tpu_torch.train.state import create_train_state
    from sdumc_tpu_torch.train.step import make_train_step

    # the launcher of the CPU tests, loaded from its file (the card's machine
    # may hold another top-level package named tests)
    spec = importlib.util.spec_from_file_location(
        "test_torch_multihost", pathlib.Path(__file__).with_name("test_torch_multihost.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    set_matmul_precision("highest")
    dims = (32, 64, 32)
    rng = np.random.default_rng(5)
    case = {k: rng.normal(size=(4, n, d)).astype(np.float32)
            for k, n, d in (("audio", 70, dims[0]), ("text", 20, dims[1]),
                            ("video", 40, dims[2]), ("feat4", 12, dims[1]))}
    case["vals"] = rng.uniform(-3, 3, size=4).astype(np.float32)
    t_max = (65, 17, 33, 12)
    np.savez(tmp_path / "case.npz", t_max=np.array(t_max), dims=np.array(dims), **case)
    helpers.run_ranks(2, [sys.executable, "-c", _DP_RANK, str(tmp_path)])

    model = SDUMCFusion(ModelConfig(input_dims=dims, dropout=0.0, attn_dropout=0.0),
                        torch.Generator().manual_seed(0))
    state = create_train_state(model, TrainConfig(), 4)
    batch = dict({k: torch.from_numpy(v) for k, v in case.items()}, t_max=t_max)
    ref = make_train_step(state, LossConfig(text_feat_w=0.1, text_query_feat_w=0.7),
                          seed=0)(batch)["loss"].item()
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for r in ranks:
        assert r["launches"].tolist() == [3, 3]
        assert float(r["loss"]) == pytest.approx(ref, rel=1e-4)
        grads = {k[2:]: r[k] for k in r.files if k.startswith("g/")}
        assert grads.keys() == {k for k, p in model.named_parameters() if p.grad is not None}
        for name, p in model.named_parameters():
            if p.grad is not None:
                err = np.abs(grads[name] - p.grad.numpy()).max()
                assert err <= 1e-5 * p.grad.abs().max().item() + 1e-6, (name, err)


_TP_RANK = """
import sys
import torch
from sdumc_tpu_torch.cli.common import set_matmul_precision
from sdumc_tpu_torch.models.llama import LlamaConfig
from sdumc_tpu_torch.models.wavlm import WavLMConfig
from sdumc_tpu_torch.ops.kernels import flash_wavlm
from sdumc_tpu_torch.parallel import (initialize_from_env, make_model_axis, shard_llama_model,
                                      shard_wavlm_model, shutdown)

work = sys.argv[1]
set_matmul_precision("highest")
rank, world = initialize_from_env(device="cuda")
dev = torch.device("cuda", torch.cuda.current_device())
axis = make_model_axis(dev, world)
case = torch.load(work + "/case.pt")
with torch.inference_mode():
    llama = shard_llama_model({k: v.to(dev) for k, v in case["llama"].items()},
                              LlamaConfig.tiny(num_kv_heads=2), axis)
    logits = llama(input_ids=case["ids"].to(dev))["logits"]
    wavlm = shard_wavlm_model({k: v.to(dev) for k, v in case["wavlm"].items()},
                              WavLMConfig.tiny(hidden_size=64), axis)
    flash_wavlm.reset_launches()
    last = wavlm(case["wav"].to(dev))["last_hidden_state"]
    torch.cuda.synchronize()
torch.save({"logits": logits.cpu(), "last": last.cpu(), "launches": flash_wavlm.LAUNCHES,
            "heads": wavlm.encoder.layers[0].attention.heads}, work + f"/rank{rank}.pt")
shutdown()
"""


@pytest.mark.cuda
def test_two_rank_tensor_parallel_forward_on_card_matches_cpu(cuda, tmp_path):
    """Two ranks on the card over gloo, each holding half of the heads and
    of the MLP of a tiny GQA LLaMA (2 kv heads, one a rank) and of a tiny
    WavLM (hidden 64: 2 of 4 heads of hd 16 a rank, the flash kernel's hd 16
    instance): the logits and the last hidden state equal the
    single-process models on the CPU at this file's tolerance; each rank
    launches the flash kernel once a layer."""
    import importlib.util
    import pathlib
    import sys

    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_weights
    from sdumc_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

    spec = importlib.util.spec_from_file_location(
        "test_torch_multihost", pathlib.Path(__file__).with_name("test_torch_multihost.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    set_matmul_precision("highest")
    llama = init_weights(LlamaForCausalLM(LlamaConfig.tiny(num_kv_heads=2)), seed=0).eval()
    torch.manual_seed(0)
    wcfg = WavLMConfig.tiny(hidden_size=64)
    wavlm = WavLMModel(wcfg).eval()
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 12)))
    wav = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 1600)).astype(np.float32))
    torch.save({"llama": llama.state_dict(), "wavlm": wavlm.state_dict(), "ids": ids,
                "wav": wav}, tmp_path / "case.pt")
    helpers.run_ranks(2, [sys.executable, "-c", _TP_RANK, str(tmp_path)])
    with torch.inference_mode():
        logits = llama(input_ids=ids)["logits"]
        last = wavlm(wav)["last_hidden_state"]
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        torch.testing.assert_close(got["logits"], logits, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(got["last"], last, rtol=RTOL, atol=ATOL)
        assert got["heads"] == 2 and got["launches"] == wcfg.num_layers


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 63, 64, 65, 129, 300])
@pytest.mark.parametrize("offset_blocks", [0, -2, 3])
def test_flash_block_instance_matches_plain(cuda, T, offset_blocks):
    """The block instance (ring attention's step: out and each row's
    log-sum-exp) against its plain version, its keys ``offset_blocks`` blocks
    of T from its queries; rows attend to every key, one key, a prefix, and
    none (lse = -1e30, out the mean of v, as the plain version gives)."""
    hd = 16 if T in (65, 129) else 64
    q, k, v, gate, rel, kvalid = (t.to(cuda) for t in _flash_inputs(4, T, 4, hd, "prefix"))
    kvalid[3] = 0.0
    diag = flash_wavlm.bias_diag_for(rel, T, NB, MD, offset=offset_blocks * T)
    flash_wavlm.reset_launches()
    with torch.inference_mode():
        out, lse = flash_wavlm.flash_block(q, k, v, gate, diag, kvalid)
        ref_out, ref_lse = flash_wavlm.flash_block_plain(q, k, v, gate, diag, kvalid)
    assert flash_wavlm.LAUNCHES_BLOCK == 1 and flash_wavlm.LAUNCHES == 0
    assert lse.shape == (4, 4, T) and lse.dtype == torch.float32
    torch.testing.assert_close(out, ref_out, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(lse, ref_lse, rtol=RTOL, atol=ATOL)
    assert (lse[3] <= -9.99e29).all()
    with pytest.raises(TypeError):
        flash_wavlm.flash_block(q.bfloat16(), k.bfloat16(), v.bfloat16(), gate, diag, kvalid)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [249, 1500])
def test_one_rank_ring_gradient_on_card_matches_cpu(cuda, T):
    """A one-rank ring under autograd at wavlm-large's heads (16 of 64): on
    the card the forward is one launch of the block instance and the
    backward the ring's (``flash_backward`` with the merged log-sum-exp, on
    the card); its q, k, v, gate and rel_embed gradients equal the same
    ring's on the CPU (the plain block) to rtol 3e-4 / atol 3e-5 (JAX's
    gradient tolerance). Rows attend to every key, one key, a prefix, and
    none."""
    from sdumc_tpu_torch.parallel import ModelAxis, ring_gated_attention

    q, k, v, gate, rel, kvalid = _flash_inputs(4, T, 16, 64, "prefix", seed=7)
    kvalid[3] = 0.0
    g = torch.randn(4, T, 16, 64, generator=torch.Generator().manual_seed(3))
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v, gate, rel)]
        flash_wavlm.reset_launches()
        out = ring_gated_attention(*leaves[:4], kvalid.to(dev), leaves[4],
                                   axis=ModelAxis(device=dev), num_buckets=NB, max_distance=MD)
        grads[dev.type] = [t.cpu() for t in torch.autograd.grad(out, leaves, g.to(dev))]
        assert flash_wavlm.LAUNCHES_BLOCK == (1 if dev.type == "cuda" else 0)
    for name, a, r in zip(("dq", "dk", "dv", "dgate", "drel"), grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, r, rtol=3e-4, atol=3e-5, msg=name)


_SP_RANK = """
import sys
import torch
from sdumc_tpu_torch.cli.common import set_matmul_precision
from sdumc_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from sdumc_tpu_torch.ops.kernels import flash_wavlm
from sdumc_tpu_torch.parallel import (initialize_from_env, make_model_axis, shutdown,
                                      wavlm_forward_sp)

work = sys.argv[1]
set_matmul_precision("highest")
rank, world = initialize_from_env(device="cuda")
dev = torch.device("cuda", torch.cuda.current_device())
axis = make_model_axis(dev, world)
case = torch.load(work + "/case.pt")
model = WavLMModel(WavLMConfig.tiny(hidden_size=64)).to(dev).eval()
model.load_state_dict(case["wavlm"])
flash_wavlm.reset_launches()
with torch.inference_mode():
    got = wavlm_forward_sp(model, case["wav"].to(dev), axis, pad_mask=case["mask"].to(dev),
                           output_hidden_states=True)
    torch.cuda.synchronize()
torch.save({"hidden": [h.cpu() for h in got["hidden_states"]],
            "block": flash_wavlm.LAUNCHES_BLOCK, "flash": flash_wavlm.LAUNCHES},
           work + f"/sp{rank}.pt")
shutdown()
"""


@pytest.mark.cuda
def test_two_rank_sequence_parallel_wavlm_on_card_matches_cpu(cuda, tmp_path):
    """Two ranks on the card over gloo split a tiny WavLM's frames (hidden
    64, hd 16; 99 frames, so the last rank's slice ends in a padded frame;
    the second row 20 frames shorter) and rotate K and V through the ring's
    page-locked host copies: every tap equals the single-process forward on
    the CPU at this file's tolerance, and each rank launches the block
    instance twice a layer and no other kernel."""
    import importlib.util
    import pathlib
    import sys

    from sdumc_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

    spec = importlib.util.spec_from_file_location(
        "test_torch_multihost", pathlib.Path(__file__).with_name("test_torch_multihost.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    torch.manual_seed(0)
    wcfg = WavLMConfig.tiny(hidden_size=64)
    wavlm = WavLMModel(wcfg).eval()
    wav = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 2000)).astype(np.float32))
    t = wcfg.output_length(2000)
    mask = torch.arange(t)[None, :] < torch.tensor([t, t - 20])[:, None]
    assert t % 2
    torch.save({"wavlm": wavlm.state_dict(), "wav": wav, "mask": mask}, tmp_path / "case.pt")
    helpers.run_ranks(2, [sys.executable, "-c", _SP_RANK, str(tmp_path)])
    with torch.inference_mode():
        want = wavlm(wav, pad_mask=mask, output_hidden_states=True)["hidden_states"]
    for rank in range(2):
        got = torch.load(tmp_path / f"sp{rank}.pt")
        assert got["block"] == 2 * wcfg.num_layers and got["flash"] == 0
        for g, w in zip(got["hidden"], want):
            torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


_PP_RANK = """
import sys
import torch
from sdumc_tpu_torch.cli.common import set_matmul_precision
from sdumc_tpu_torch.models.llama import LlamaConfig
from sdumc_tpu_torch.parallel import (initialize_from_env, llama_pp_forward,
                                      make_hierarchical_mesh, make_model_axis, pipeline_apply,
                                      shutdown, stage_layers, stage_model_from_state_dict)

work = sys.argv[1]
set_matmul_precision("highest")
rank, world = initialize_from_env(device="cuda")
dev = torch.device("cuda", torch.cuda.current_device())
case = torch.load(work + "/case.pt")
hier = make_hierarchical_mesh(dev, 2, 2)
summed = hier.all_reduce(case["vectors"][rank].to(dev))
stage = make_model_axis(dev, world)
out = {"summed": summed.cpu(), "ici": hier.ici}
with torch.inference_mode():
    for dtype in (torch.float32, torch.bfloat16):
        w, b = case["w"].to(dev, dtype), case["b"].to(dev, dtype)
        mine = [(w[i], b[i]) for i in stage_layers(w.shape[0], stage)]
        out[str(dtype)] = pipeline_apply(
            stage, lambda lp, h, e: torch.tanh(h @ lp[0] + lp[1]), mine,
            case["x"].to(dev, dtype), n_microbatches=4).cpu()
    model = stage_model_from_state_dict(LlamaConfig.tiny(num_layers=8),
                                        {k: v.to(dev) for k, v in case["llama"].items()}, stage)
    out["last"], out["taps"] = (t.cpu() for t in llama_pp_forward(
        model, stage, input_ids=case["ids"].to(dev), n_microbatches=2, collect_taps=2))
torch.save(out, work + f"/pp{rank}.pt")
shutdown()
"""


@pytest.mark.cuda
def test_four_rank_hierarchical_sum_and_pipeline_on_card(cuda, tmp_path):
    """Four ranks on the card over gloo: the 2 x 2 hierarchical sum of a
    vector of 1001 elements (not a multiple of the pod, so the last part is
    padded) equals the plain sum, exactly for these integers; the
    tanh-affine pipeline (8 layers, 4 stages, 4 microbatches) equals the
    sequential layers on the CPU at f32 (this file's tolerance) and at bf16
    (the same bf16 products: 2 bf16 ulps); a tiny LLaMA's pipelined forward
    (8 layers over 4 stages, 2 microbatches, 2 taps) equals the single
    process's forward on the CPU."""
    import importlib.util
    import pathlib
    import sys

    from sdumc_tpu_torch.models.llama import LlamaConfig, LlamaModel, init_weights

    spec = importlib.util.spec_from_file_location(
        "test_torch_multihost", pathlib.Path(__file__).with_name("test_torch_multihost.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    rng = np.random.default_rng(20)
    vectors = torch.from_numpy(rng.integers(-1000, 1000, (4, 1001)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(8, 16, 16)) * 0.3).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    llama = init_weights(LlamaModel(LlamaConfig.tiny(num_layers=8)), seed=0).eval()
    ids = torch.from_numpy(rng.integers(0, 128, (4, 12)))
    torch.save({"vectors": vectors, "w": w, "b": b, "x": x, "llama": llama.state_dict(),
                "ids": ids}, tmp_path / "case.pt")
    helpers.run_ranks(4, [sys.executable, "-c", _PP_RANK, str(tmp_path)])
    with torch.inference_mode():
        ref = llama(input_ids=ids, output_hidden_states=True)
    for rank in range(4):
        got = torch.load(tmp_path / f"pp{rank}.pt")
        assert got["ici"] == 2
        assert torch.equal(got["summed"], vectors.sum(0))
        for dtype in (torch.float32, torch.bfloat16):
            y = x.to(dtype)
            for i in range(8):
                y = torch.tanh(y @ w[i].to(dtype) + b[i].to(dtype))
            tol = (dict(rtol=RTOL, atol=ATOL) if dtype == torch.float32
                   else dict(rtol=2 ** -7, atol=2 ** -7))
            torch.testing.assert_close(got[str(dtype)], y, **tol)
        torch.testing.assert_close(got["last"], ref["last_hidden_state"], rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(got["taps"][0], ref["hidden_states"][7], rtol=RTOL, atol=ATOL)
