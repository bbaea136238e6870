"""The port's bf16 frame streams against the JAX package, on the CPU.

The fusion kernel's bf16 instance has a plain version (the f32 formula on
the widened inputs, the output rounded to bf16): here it is held to JAX's
Pallas kernels run in interpret mode at bf16 x, as tests/test_pallas_ops.py
runs them, to within one bf16 ulp of the output (both compute in f32 and
round once; the sums run in another order). Then the whole model at bf16:
single view with scalar t_max against JAX with ``use_pallas="on"`` (every
frame op takes the kernel there, as on the port's card path), and the fused
dual view and one train step against JAX's default bf16 path (the einsum,
which rounds the keys and CrossAttention's scores to bf16 and keeps the
pool in f32), at the JAX package's own bf16 bound. Inputs are seeded numpy
f32, rounded to bf16 by each framework's cast (both round to nearest even:
the bits are checked equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.core.config import LossConfig as JaxLossConfig
from sdumc_tpu.core.config import ModelConfig as JaxModelConfig
from sdumc_tpu.models.fusion import SDUMCFusion as JaxFusion
from sdumc_tpu.ops.pallas import fused_attention_pool as jax_fused_pool
from sdumc_tpu.ops.pallas import fused_cross_attention as jax_fused_cross
from sdumc_tpu.ops.pallas.fused_cross import _bwd as jax_cross_bwd
from sdumc_tpu.ops.pallas.fused_pool import _bwd as jax_pool_bwd
from sdumc_tpu.train.step import dual_view_loss as jax_dual_view_loss
from sdumc_tpu_torch.convert import state_dict_from_flax
from sdumc_tpu_torch.core.config import LossConfig, ModelConfig
from sdumc_tpu_torch.models.fusion import SDUMCFusion
from sdumc_tpu_torch.ops.kernels import fused_cross, fused_pool
from sdumc_tpu_torch.train.step import dual_view_loss

# several test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

B, T, D, Q = 4, 128, 256, 7
ROW_TMAX = [T, 1, 63, 97]         # = T, one frame, and two non-multiples of a tile
DIMS = (32, 64, 32)
AUX_KEYS = ("features", "rnc", "text_feat", "text_query_feat")
# the JAX package's bound between its bf16 and f32 paths (tests/test_train.py
# test_bf16_feature_dtype_close_to_f32), here between its bf16 einsum path
# and the port's bf16 kernel path
BF16_RTOL, BF16_ATOL = 2e-2, 2e-3


def bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |a| (8 significant bits)."""
    return np.ldexp(1.0, np.frexp(np.abs(np.asarray(a, np.float32)))[1] - 8)


def to_bf16(a: np.ndarray):
    """(jax bf16 array, torch bf16 tensor) of the same f32 numpy array."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(j).view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16))
    return j, t


def f32(a) -> np.ndarray:
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a).astype(np.float32))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return {
        "x": rng.normal(size=(B, T, D)).astype(np.float32),
        "W": (rng.normal(size=(D, D)) * 0.06).astype(np.float32),     # JAX [in, out]
        "b": (rng.normal(size=(D,)) * 0.06).astype(np.float32),
        "c": (rng.normal(size=(D,)) * 0.08).astype(np.float32),
        "q": (rng.normal(size=(B, Q, D)) * 0.2).astype(np.float32),
        "g7": rng.normal(size=(B, Q, D)).astype(np.float32),
        "g1": rng.normal(size=(B, D)).astype(np.float32),
    }


def _ops(data, q_count):
    """(jax per-row fn, port fn, jax first input, port first input): the
    query is the bf16 output of the query projection for Q = 7 and the f32
    context vector for Q = 1, as in the model."""
    W, b = jnp.asarray(data["W"]), jnp.asarray(data["b"])
    if q_count == 7:
        jq, tq = to_bf16(data["q"])

        def jax_fn(q, x, w, bias, t):
            return jax_fused_cross(q, x, w, bias, t)

        def port_fn(q, x, w, bias, t):
            return fused_cross.fused_cross_attention(q, x, w, bias, t)
    else:
        jq, tq = jnp.asarray(data["c"]), torch.from_numpy(data["c"])

        def jax_fn(c, x, w, bias, t):
            return jax_fused_pool(x, w, bias, c, t)

        def port_fn(c, x, w, bias, t):
            return fused_pool.fused_attention_pool(x, w, bias, c, t)
    return jax_fn, port_fn, jq, tq, W, b


def _jax_rows(jax_fn, jq, jx, W, b, q_batched):
    """JAX's kernel takes one scalar t_max: each row runs at its own."""
    return jnp.concatenate([
        jax_fn(jq[i:i + 1] if q_batched else jq, jx[i:i + 1], W, b, t)
        for i, t in enumerate(ROW_TMAX)])


@pytest.mark.parametrize("q_count", [7, 1])
def test_bf16_plain_matches_jax_pallas(data, q_count):
    """The bf16 instance's plain version (the CPU path) against JAX's Pallas
    kernel at bf16 x, per-row t_max: bf16 outputs within one bf16 ulp."""
    jax_fn, port_fn, jq, tq, W, b = _ops(data, q_count)
    jx, tx = to_bf16(data["x"])
    ref = _jax_rows(jax_fn, jq, jx, W, b, q_count == 7)
    got = port_fn(tq, tx, torch.from_numpy(data["W"].T.copy()), torch.from_numpy(data["b"]),
                  torch.tensor(ROW_TMAX, dtype=torch.int32))
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    diff = np.abs(f32(got) - f32(ref))
    assert (diff <= bf16_ulp(np.maximum(np.abs(f32(got)), np.abs(f32(ref))))).all(), diff.max()
    assert (got == 0).float().mean() < 0.01


@pytest.mark.parametrize("q_count", [7, 1])
def test_bf16_gradients_match_jax(data, q_count):
    """Gradients at bf16 x, per-row t_max, through the port's plain version
    and through ``fused_cross.Recomputed`` (the card's autograd.Function,
    with the plain version as its forward here), against the JAX kernel's
    backward rule (the einsum recompute, HIGHEST precision), given the same
    bf16 cotangent. dx (and Q = 7's dq) come back bf16: the port rounds
    the f32 gradient once, so it is within one bf16 ulp of the rule on the
    widened inputs; the rule at bf16 inputs rounds dx's two terms (through
    the keys and through the weighted sum) to bf16 before it adds them, so
    there the bound is 2^-7 of the largest. dW, db (and Q = 1's context)
    are f32, within 1e-5 of the largest. JAX's own gradient through the kernel raises at bf16 x
    (its recompute returns f32 where the forward returned bf16; ROADMAP.md
    section 3), so its rule is called with the cotangent widened to f32."""
    jax_fn, port_fn, jq, tq, W, b = _ops(data, q_count)
    jx, tx = to_bf16(data["x"])
    # the cotangent of a bf16 output is bf16
    jg, tg = to_bf16(data["g7"] if q_count == 7 else data["g1"])
    jt = jnp.asarray(ROW_TMAX, jnp.int32)
    with pytest.raises(ValueError, match="unexpected JAX type"):
        jax.grad(lambda x: jnp.sum(jax_fn(jq[:1] if q_count == 7 else jq, x, W, b, T)
                                   .astype(jnp.float32)))(jx[:1])

    def jax_rule(q, x):
        with jax.default_matmul_precision("highest"):
            if q_count == 7:
                dq, dx, dw, db, _ = jax_cross_bwd(0.3, 256, (q, x, W, b, jt),
                                                  jg.astype(jnp.float32))
            else:
                dx, dw, db, dq, _ = jax_pool_bwd(0.3, 256, (x, W, b, q, jt),
                                                 jg.astype(jnp.float32))
        return [f32(dq), f32(dx), f32(dw).T, f32(db)]     # dW in nn.Linear layout

    wide = jax_rule(jq.astype(jnp.float32), jx.astype(jnp.float32))
    at_bf16 = jax_rule(jq, jx)
    tmax = torch.tensor(ROW_TMAX, dtype=torch.int32)
    plain = fused_cross.fused_cross_attention_plain if q_count == 7 else (
        lambda c, x, w, bias, t, s: fused_pool.fused_attention_pool_plain(x, w, bias, c, t, s))
    for route in ("plain", "recomputed"):
        leaves = [tq.clone().requires_grad_(), tx.clone().requires_grad_(),
                  torch.from_numpy(data["W"].T.copy()).requires_grad_(),
                  torch.from_numpy(data["b"]).requires_grad_()]
        out = (port_fn(*leaves, tmax) if route == "plain" else
               fused_cross.Recomputed.apply(plain, plain, *leaves, tmax, 0.3))
        grads = torch.autograd.grad(out, leaves, tg)
        for i, (name, got, leaf) in enumerate(zip(("dq", "dx", "dW", "db"), grads, leaves)):
            assert got.dtype == leaf.dtype, (route, name)
            got = f32(got)
            if leaf.dtype == torch.bfloat16:
                want = wide[i]
                bound = (bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
                         + 1e-6 * np.abs(want).max())
                assert (np.abs(got - want) <= bound).all(), (route, name)
                want = at_bf16[i]
                assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max(), (route, name)
            else:
                want = wide[i]
                assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (route, name)
                np.testing.assert_allclose(want, at_bf16[i], rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def models():
    """(jax params, port model) with the same weights, the published widths."""
    rng = np.random.default_rng(0)
    dummy = [jnp.asarray(rng.normal(size=(2, 8, d)), jnp.float32) for d in DIMS]
    params = jax.jit(JaxFusion(JaxModelConfig(input_dims=DIMS)).init)(
        jax.random.PRNGKey(0), *dummy)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = SDUMCFusion(ModelConfig(input_dims=DIMS)).eval()
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    return params, port


def _inputs(seed, lengths=(40, 12, 30, 9), pad=(8, 4, 2, 3)):
    """bf16 audio/text/video/feat4 [3, T, D], zero-padded past each length,
    as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    dims = (DIMS[0], DIMS[1], DIMS[2], DIMS[1])
    arrays = [np.pad(rng.normal(size=(3, n, d)).astype(np.float32), ((0, 0), (0, p), (0, 0)))
              for n, d, p in zip(lengths, dims, pad)]
    pairs = [to_bf16(a) for a in arrays]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _compare(got, ref, rtol, atol):
    (v, aux), (rv, raux) = got, ref
    np.testing.assert_allclose(f32(v), f32(rv), rtol=rtol, atol=atol)
    for key in AUX_KEYS:
        np.testing.assert_allclose(f32(aux[key]), f32(raux[key]), rtol=rtol, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("missing", [False, True])
def test_single_view_bf16_matches_jax_kernel_path(models, missing):
    """Single view, scalar t_max, bf16 features: the port (the bf16 plain
    versions, the kernel's semantics) against JAX with use_pallas="on"
    (its Pallas kernels at bf16 x). The same bf16 products and roundings
    on both sides, summed in another order, so a bf16 rounding (2^-8
    relative) flips in a few elements: every output within 1e-3 of its
    largest value (JAX's default bf16 path parts from both by about 2e-3)."""
    params, port = models
    (ja, jt, jv, jf), (ta_, tt_, tv_, tf_) = _inputs(1)
    text_j, text_t, tt = (jf, tf_, 9) if missing else (jt, tt_, 12)
    jm = JaxFusion(JaxModelConfig(input_dims=DIMS, use_pallas="on"))
    ref = jax.jit(jm.apply, static_argnames=("missing",))(
        {"params": params}, ja, text_j, jv,
        t_max=(jnp.int32(40), jnp.int32(tt), jnp.int32(30)), missing=missing)
    with torch.inference_mode():
        got = port(ta_, text_t, tv_, t_max=(40, tt, 30), missing=missing)
    assert got[0].dtype == torch.float32
    (v, aux), (rv, raux) = got, ref
    for key, a, r in [("vals", v, rv)] + [(k, aux[k], raux[k]) for k in AUX_KEYS]:
        a, r = f32(a), f32(r)
        assert np.abs(a - r).max() <= 1e-3 * np.abs(r).max(), key


def test_dual_view_bf16_matches_jax_default_path(models):
    """The fused dual view at bf16 (per-row text lengths) against JAX's
    default bf16 path (use_pallas "auto": the einsum) at the JAX package's
    bf16 bound, rtol 2e-2 / atol 2e-3."""
    params, port = models
    (ja, jt, jv, jf), (ta_, tt_, tv_, tf_) = _inputs(2)
    jm = JaxFusion(JaxModelConfig(input_dims=DIMS))
    ref = jax.jit(jm.apply, static_argnames=("dual",))(
        {"params": params}, ja, (jt, jf), jv,
        t_max=(jnp.int32(40), (jnp.int32(12), jnp.int32(9)), jnp.int32(30)), dual=True)
    with torch.inference_mode():
        got = port(ta_, (tt_, tf_), tv_, t_max=(40, (12, 9), 30), dual=True)
    _compare(got, ref, BF16_RTOL, BF16_ATOL)


def test_train_step_bf16_matches_jax_dual_view_loss(models):
    """One dual-view loss and its gradients at bf16 streams, dropout off,
    against JAX's dual_view_loss (its default bf16 path): the loss within
    rtol 2e-2, every parameter's gradient within 3e-2 of the largest
    gradient of the model (the two paths round the keys and the pooled
    vectors differently)."""
    params, _ = models
    loss_kw = dict(text_feat_w=0.1, text_query_feat_w=0.7, features_w=0.1, rnc_w=0.8)
    (ja, jt, jv, jf), (ta_, tt_, tv_, tf_) = _inputs(3)
    vals = np.random.default_rng(4).uniform(-3, 3, size=(3,)).astype(np.float32)
    t_max = (40, 12, 30, 9)
    jm = JaxFusion(JaxModelConfig(input_dims=DIMS, dropout=0.0, attn_dropout=0.0))
    jbatch = {"audio": ja, "text": jt, "video": jv, "feat4": jf, "vals": jnp.asarray(vals),
              "t_max": tuple(jnp.int32(x) for x in t_max)}

    def loss_fn(p):
        return jax_dual_view_loss(jm, p, jbatch, JaxLossConfig(**loss_kw),
                                  jax.random.PRNGKey(0), deterministic=True)[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = SDUMCFusion(ModelConfig(input_dims=DIMS, dropout=0.0, attn_dropout=0.0)).train()
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    batch = {"audio": ta_, "text": tt_, "video": tv_, "feat4": tf_,
             "vals": torch.from_numpy(vals), "t_max": t_max}
    loss, _ = dual_view_loss(model, batch, LossConfig(**loss_kw))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=2e-2)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, ref_grads))
    got = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
           for k, p in model.named_parameters()}
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    worst = max((float(np.abs(got[k].numpy() - want[k].numpy()).max()), k) for k in want)
    assert worst[0] <= 3e-2 * scale, (worst, scale)
    assert all(p.grad is None or p.grad.dtype == torch.float32 for p in model.parameters())


def test_bf16_gap_bench_reads_zero_sound_and_a_refused_control_on_the_cpu():
    """bench/bf16_gap.py on the CPU at the tiny case: the 'sound' run is the
    reference itself (0 apart), the f32-stream control parts from it past
    the 3e-4 relative L2 limit of the card checks on the text
    representations, as on the card."""
    from sdumc_tpu_torch.bench import bf16_gap

    config, rows, seed = bf16_gap.CASES[0]
    res = bf16_gap.gaps(config, rows, seed, torch.device("cpu"))
    assert set(res) == {"vals", *AUX_KEYS}
    assert all(r[0] == 0.0 and r[2] == 0.0 for r in res.values())
    assert all(res[k][3] > 3e-4 for k in ("text_feat", "text_query_feat"))
