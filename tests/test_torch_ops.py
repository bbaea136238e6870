"""sdumc_tpu_torch ops vs the JAX package's ops on the same numpy inputs.

The masking, attention-pool and cross-attention plain versions against the
JAX einsum formulations, and the fused kernels' CPU path (their plain
versions) against the JAX Pallas kernels run in interpret mode, as
tests/test_pallas_ops.py runs them. Tolerance rtol 2e-5 / atol 2e-6, as
there: both sides compute in f32, in another summation order. Weights are
handed to the port in nn.Linear layout ([out, in], the JAX kernel
transposed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.ops.attention_pool import attention_pool as jax_attention_pool
from sdumc_tpu.ops.cross_attention import multi_query_cross_attention as jax_cross
from sdumc_tpu.ops.masking import mask_time_scores as jax_mask
from sdumc_tpu.ops.pallas import fused_attention_pool as jax_fused_pool
from sdumc_tpu.ops.pallas import fused_cross_attention as jax_fused_cross
from sdumc_tpu_torch.ops.attention_pool import attention_pool
from sdumc_tpu_torch.ops.cross_attention import multi_query_cross_attention
from sdumc_tpu_torch.ops.kernels import fused_cross, fused_pool
from sdumc_tpu_torch.ops.masking import NEG_INF, mask_time_scores

B, T, D, Q = 4, 128, 256, 7
RTOL, ATOL = 2e-5, 2e-6
ROW_TMAX = [T, 1, 63, 97]     # = T, one frame, and two non-multiples of a tile


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {
        "x": rng.normal(size=(B, T, D)).astype(f32),
        "W": (rng.normal(size=(D, D)) * 0.06).astype(f32),     # JAX [in, out]
        "b": (rng.normal(size=(D,)) * 0.06).astype(f32),
        "c": (rng.normal(size=(D,)) * 0.08).astype(f32),
        "q": (rng.normal(size=(B, Q, D)) * 0.2).astype(f32),
        "query": (rng.normal(size=(B, Q, D)) * 0.2).astype(f32),
        "Wq": (rng.normal(size=(D, D)) * 0.06).astype(f32),
        "bq": (rng.normal(size=(D,)) * 0.06).astype(f32),
    }


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tmax(kind):
    """(jax t_max, torch t_max) for a test case."""
    if kind is None:
        return None, None
    if kind == "rows":
        return jnp.asarray(ROW_TMAX, jnp.int32), torch.tensor(ROW_TMAX, dtype=torch.int32)
    return jnp.int32(kind), kind


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", [None, 0, 5, T + 9, "rows"])
def test_mask_time_scores_matches_jax(kind):
    scores = np.random.default_rng(1).normal(size=(B, T, 3)).astype(np.float32)
    jt, tt = _tmax(kind)
    got = mask_time_scores(_t(scores), tt, axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_mask(jnp.asarray(scores), jt, axis=1)))
    if kind == "rows":
        assert (got[1, 1:] == NEG_INF).all() and (got[0] == _t(scores)[0]).all()


@pytest.mark.parametrize("kind", [None, 97, "rows"])
def test_attention_pool_matches_jax(data, kind):
    jt, tt = _tmax(kind)
    ref, ref_attn = jax_attention_pool(jnp.asarray(data["x"]), jnp.asarray(data["W"]),
                                       jnp.asarray(data["b"]), jnp.asarray(data["c"]),
                                       softmax_scale=0.3, t_max=jt)
    got, attn = attention_pool(_t(data["x"]), _t(data["W"].T), _t(data["b"]),
                               _t(data["c"]), softmax_scale=0.3, t_max=tt)
    _close(got, ref)
    _close(attn, ref_attn)


@pytest.mark.parametrize("kind", [None, 97, "rows"])
def test_cross_attention_matches_jax(data, kind):
    jt, tt = _tmax(kind)
    ref, ref_attn = jax_cross(*(jnp.asarray(data[k]) for k in ("query", "x", "Wq", "bq", "W", "b")),
                              softmax_scale=0.3, t_max=jt)
    got, attn = multi_query_cross_attention(
        _t(data["query"]), _t(data["x"]), _t(data["Wq"].T), _t(data["bq"]),
        _t(data["W"].T), _t(data["b"]), softmax_scale=0.3, t_max=tt)
    _close(got, ref)
    _close(attn, ref_attn)


@pytest.mark.parametrize("tmax", [None, 97])
def test_fused_pool_cpu_matches_pallas_kernel(data, tmax):
    jt, tt = _tmax(tmax)
    ref = jax_fused_pool(jnp.asarray(data["x"]), jnp.asarray(data["W"]), jnp.asarray(data["b"]),
                         jnp.asarray(data["c"]), jt, softmax_scale=0.3, block_t=64)
    got = fused_pool.fused_attention_pool(_t(data["x"]), _t(data["W"].T), _t(data["b"]),
                                          _t(data["c"]), tt, softmax_scale=0.3)
    _close(got, ref)


@pytest.mark.parametrize("tmax", [None, 97])
def test_fused_cross_cpu_matches_pallas_kernel(data, tmax):
    jt, tt = _tmax(tmax)
    ref = jax_fused_cross(jnp.asarray(data["q"]), jnp.asarray(data["x"]), jnp.asarray(data["W"]),
                          jnp.asarray(data["b"]), jt, softmax_scale=0.3, block_t=64)
    got = fused_cross.fused_cross_attention(_t(data["q"]), _t(data["x"]), _t(data["W"].T),
                                            _t(data["b"]), tt, softmax_scale=0.3)
    _close(got, ref)


def test_fused_per_row_tmax_matches_jax_einsum(data):
    """Per-row [B] t_max (the fused dual view's text stream) == the JAX
    einsum path with vector t_max, for both query counts."""
    jt, tt = _tmax("rows")
    x, W, b = jnp.asarray(data["x"]), jnp.asarray(data["W"]), jnp.asarray(data["b"])
    ref_pool, _ = jax_attention_pool(x, W, b, jnp.asarray(data["c"]), softmax_scale=0.3, t_max=jt)
    k = jnp.tanh(x @ W + b)
    scores = jax_mask(0.3 * jnp.einsum("btd,bqd->btq", k, jnp.asarray(data["q"])), jt, axis=1)
    ref_cross = jnp.einsum("btd,btq->bqd", x, jax.nn.softmax(scores, axis=1))
    got_pool = fused_pool.fused_attention_pool(_t(data["x"]), _t(data["W"].T), _t(data["b"]),
                                               _t(data["c"]), tt)
    got_cross = fused_cross.fused_cross_attention(_t(data["q"]), _t(data["x"]),
                                                  _t(data["W"].T), _t(data["b"]), tt)
    _close(got_pool, ref_pool)
    _close(got_cross, ref_cross)


def test_cpu_path_launches_no_kernel(data):
    """A CPU tensor takes the plain version and counts nothing; the kernel
    entry refuses a tensor that is not on a card (no quiet fallback)."""
    before = dict(fused_cross.LAUNCHES)
    fused_cross.fused_cross_attention(_t(data["q"]), _t(data["x"]), _t(data["W"].T), _t(data["b"]))
    fused_pool.fused_attention_pool(_t(data["x"]), _t(data["W"].T), _t(data["b"]), _t(data["c"]))
    assert fused_cross.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA device"):
        fused_cross.launch(_t(data["q"]), _t(data["x"]), _t(data["W"].T), _t(data["b"]),
                           None, 0.3, q_batched=True)
