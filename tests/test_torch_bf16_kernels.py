"""The plain twins of the kernels' bf16 instances against exact arithmetic
and the JAX package, on the CPU, at small sizes, with seeded numpy inputs.

The fusion kernel's bf16 instance cuts W into three bf16 parts and sums
x . lo, x . mid and x . hi in f32; the WavLM kernel's rounds p against the
running max of 128-key tiles, JAX's default block. Tolerances:
- the split: hi + mid + lo == W to the bit for |w| >= 2^-110 (and 0); below
  that a part falls under bf16's smallest subnormal, and the sum is within
  2^-133 of w;
- the product order: the keys before tanh within n u sum_k |x_k w_k| + u |b|
  of float64 (n = 257 terms with the bias, u = 2^-24): the worst case of an
  f32 sum of n terms in any order, which the f32 formula on the widened x
  meets as well; after tanh one more f32 rounding;
- the fusion plain version against JAX's Pallas kernels at bf16 x (interpret
  mode, as tests/test_pallas_ops.py runs them): bf16 outputs within one bf16
  ulp of the larger (both compute in f32 and round once); so are the
  outputs computed with keys in the instance's order;
- the bf16 flash plain version against JAX's Pallas kernel at block = 128,
  its default (interpret mode): ``flash_wavlm.bf16_tolerance`` element by
  element, and at most ``flash_wavlm.BF16_MISMATCH_LIMIT`` of the elements
  differing (both round p against the same running max; f32 rounding in
  other orders moves a p by one ulp where it lies at a rounding midpoint).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.ops.pallas import fused_attention_pool as jax_fused_pool
from sdumc_tpu.ops.pallas import fused_cross_attention as jax_fused_cross
from sdumc_tpu.ops.pallas.flash_wavlm import flash_gated_attention as jax_flash
from sdumc_tpu_torch.ops.kernels import flash_wavlm, fused_cross, fused_pool
from sdumc_tpu_torch.ops.masking import mask_time_scores

# several test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

U = 2.0 ** -24                   # f32's unit roundoff
D = 256
F32_MAX = float(np.finfo(np.float32).max)


def bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |a| (8 significant bits)."""
    return np.ldexp(1.0, np.frexp(np.abs(np.asarray(a, np.float32)))[1] - 8)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 0.06, 1.0, 1e3, 1e30])
def test_split_w_bf16_is_exact(scale):
    """Seeded W over several magnitudes, both signs: three bf16 parts whose
    f32 sum is W to the bit, each the top 16 bits of what the earlier leave
    (at scale 1e-30 a few normal draws fall below 2^-110: within 2^-133)."""
    rng = np.random.default_rng(int(np.log10(scale) + 40))
    w = torch.from_numpy((rng.normal(size=(D, D)) * scale).astype(np.float32))
    hi, mid, lo = fused_cross.split_w_bf16(w)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = (hi.float() + mid.float()) + lo.float()
    kept = w.abs() >= 2.0 ** -110
    assert kept.float().mean() > 0.99
    np.testing.assert_array_equal(_bits(total[kept]), _bits(w[kept]))
    assert ((total - w).abs()[~kept] <= 2.0 ** -133).all()
    assert torch.equal(hi.float(), (w.view(torch.int32) & -65536).view(torch.float32))
    assert (mid.float().abs() <= hi.float().abs()).all()
    assert (lo.float().abs() <= mid.float().abs()).all()


def test_split_w_bf16_at_f32_extremes():
    """Values near f32's largest (where a bf16 rounding to nearest would
    overflow to inf), the smallest the split keeps exact (2^-110), zero (-0
    sums to +0, the same value), and below 2^-110, where the lost part is
    under 2^-133."""
    big = [F32_MAX, -F32_MAX, np.nextafter(F32_MAX, 0, dtype=np.float32), 3.0e38, -3.3e38,
           1.7e38]
    exact_small = [2.0 ** -110, -(2.0 ** -110) * 1.9999999, 2.0 ** -100 * 1.2345678, 0.0]
    w = torch.tensor(big + exact_small, dtype=torch.float32)
    hi, mid, lo = fused_cross.split_w_bf16(w)
    assert torch.isfinite(hi.float()).all()
    np.testing.assert_array_equal(_bits((hi.float() + mid.float()) + lo.float()), _bits(w))
    assert sum(p.float() for p in fused_cross.split_w_bf16(torch.tensor([-0.0]))).item() == 0.0
    tiny = torch.tensor([2.0 ** -111 * 1.9999999, 1.17549435e-38, -1.5e-38, 1e-40, -1e-44],
                        dtype=torch.float32)
    hi, mid, lo = fused_cross.split_w_bf16(tiny)
    err = ((hi.float() + mid.float()) + lo.float() - tiny).abs()
    assert (err <= 2.0 ** -133).all(), err


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keys_in_the_instance_order_are_f32_grade(seed):
    """x . lo + x . mid + x . hi in f32 (bf16 x, each product exact) against
    float64: within the worst case of an f32 sum of 257 terms; the f32
    formula on the widened x lies within the same bound."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(40, D)) * 0.5).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.normal(size=(D, D)) * 0.06).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(D,)) * 0.06).astype(np.float32))
    hi, mid, lo = fused_cross.split_w_bf16(w)
    xf = x.float()
    lin = ((xf @ lo.float().T) + xf @ mid.float().T) + xf @ hi.float().T + b
    want = x.double() @ w.double().T + b.double()
    bound = (D + 1) * U * (x.double().abs() @ w.double().abs().T + b.double().abs())
    assert ((lin.double() - want).abs() <= bound).all()
    assert (((xf @ w.T + b).double() - want).abs() <= bound).all()
    keys = fused_cross.keys_bf16_order(x, w, b)
    assert torch.equal(keys, torch.tanh(lin))
    assert ((keys.double() - torch.tanh(want)).abs() <= bound + U).all()


ROWS = [512, 257, 256, 255, 1]    # the 256-frame tile's edges
T = 512


@pytest.fixture(scope="module")
def fusion_data():
    rng = np.random.default_rng(9)
    return {
        "x": rng.normal(size=(len(ROWS), T, D)).astype(np.float32),
        "W": (rng.normal(size=(D, D)) * 0.06).astype(np.float32),     # JAX [in, out]
        "b": (rng.normal(size=(D,)) * 0.06).astype(np.float32),
        "c": (rng.normal(size=(D,)) * 0.08).astype(np.float32),
        "q": (rng.normal(size=(len(ROWS), 7, D)) * 0.2).astype(np.float32),
    }


def _attention_in_instance_order(q, x, w, b, t_max, scale=0.3):
    """The fusion attention with keys summed as the bf16 instance sums them."""
    k = fused_cross.keys_bf16_order(x, w, b)
    scores = mask_time_scores(scale * torch.einsum("btd,bqd->btq", k, q.float()), t_max, axis=1)
    return torch.einsum("btd,btq->bqd", x.float(), torch.softmax(scores, dim=1)).to(x.dtype)


@pytest.mark.parametrize("q_count", [7, 1])
def test_fusion_bf16_plain_matches_jax_at_tile_edges(fusion_data, q_count):
    """Rows ending at the bf16 instance's 256-frame tile edges (512, 257,
    256, 255, 1 frames): the plain version (the CPU path), and the same
    attention with keys in the instance's order, against JAX's Pallas
    kernels at bf16 x, each row at its own scalar t_max: within one bf16 ulp."""
    d = fusion_data
    jx = jnp.asarray(d["x"]).astype(jnp.bfloat16)
    tx = torch.from_numpy(d["x"]).bfloat16()
    W, b = jnp.asarray(d["W"]), jnp.asarray(d["b"])
    tw, tb = torch.from_numpy(d["W"].T.copy()), torch.from_numpy(d["b"])
    rows = torch.tensor(ROWS, dtype=torch.int32)
    if q_count == 7:
        jq = jnp.asarray(d["q"]).astype(jnp.bfloat16)
        tq = torch.from_numpy(d["q"]).bfloat16()
        ref = jnp.concatenate([jax_fused_cross(jq[i:i + 1], jx[i:i + 1], W, b, t)
                               for i, t in enumerate(ROWS)])
        got = fused_cross.fused_cross_attention(tq, tx, tw, tb, rows)
        ordered = _attention_in_instance_order(tq, tx, tw, tb, rows)
    else:
        jc, tc = jnp.asarray(d["c"]), torch.from_numpy(d["c"])
        ref = jnp.concatenate([jax_fused_pool(jx[i:i + 1], W, b, jc, t)
                               for i, t in enumerate(ROWS)])
        got = fused_pool.fused_attention_pool(tx, tw, tb, tc, rows)
        ordered = _attention_in_instance_order(tc.expand(len(ROWS), 1, D), tx, tw, tb,
                                               rows)[:, 0]
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.dtype == ordered.dtype == torch.bfloat16
    for out in (got, ordered):
        out = out.float().numpy()
        diff = np.abs(out - ref)
        assert (diff <= bf16_ulp(np.maximum(np.abs(out), np.abs(ref)))).all(), diff.max()


def _flash_inputs(B, T_, H, hd, mask, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T_, H, hd)).astype(np.float32) for _ in range(3))
    gate = (1.0 + rng.uniform(size=(B, H, T_))).astype(np.float32)
    rel = rng.normal(size=(40, H)).astype(np.float32)
    if mask == "prefix":
        kvalid = np.arange(T_)[None, :] < np.array([T_, 1, 129])[:B, None]
    elif mask == "scattered":
        kvalid = rng.uniform(size=(B, T_)) < 0.6
        kvalid[0] = True
    else:
        kvalid = np.ones((B, T_), bool)
    return q, k, v, gate, rel, kvalid.astype(np.float32)


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("mask", [None, "prefix", "scattered"])
def test_flash_bf16_plain_matches_jax_at_block_128(hd, mask):
    """T = 300 (3 key tiles of 128, the last ragged), hd 16 and 64, with and
    without key masks: the bf16 plain version at its default key tile (128,
    the kernel's) against JAX's Pallas kernel at its default block (128),
    every element to the derived bound and in the share that differs."""
    T_ = 300
    q, k, v, gate, rel, kvalid = _flash_inputs(3, T_, 2, hd, mask, seed=hd + T_)
    kw = dict(num_buckets=40, max_distance=100)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)          # noqa: E731
    jmask = None if mask is None else jnp.asarray(kvalid)
    want = jax_flash(bf(q), bf(k), bf(v), bf(gate), bf(rel), jmask, interpret=True, **kw)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    tb = lambda a: torch.from_numpy(a).bfloat16()        # noqa: E731
    tmask = None if mask is None else torch.from_numpy(kvalid)
    got = flash_wavlm.flash_gated_attention(tb(q), tb(k), tb(v), tb(gate), tb(rel), tmask, **kw)
    assert flash_wavlm.KEY_TILE_BF16 == 128
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want).abs()
    bound = flash_wavlm.bf16_tolerance(got, tb(v))
    assert (err <= bound).all(), (err / bound).max().item()
    share = flash_wavlm.bf16_mismatch_share(got, want.bfloat16())
    assert share <= flash_wavlm.BF16_MISMATCH_LIMIT, share


@pytest.mark.parametrize("B, T_, want", [
    (64, 2048, 8),      # the audio bucket: one block per 256-frame tile
    (64, 512, 2),       # the video bucket
    (64, 128, 1),       # the text bucket: one tile a row
    (6, 300, 2),
    (1000, 256, 1),
])
def test_bf16_splits_follow_the_256_frame_tile(B, T_, want):
    assert fused_cross.splits_for(132, B, T_, fused_cross.TILE_T_BF16) == want
