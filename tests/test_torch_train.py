"""The port's training slice against the JAX package, on the CPU.

Each module on the numpy inputs the JAX module gets, from a seed: the
losses (values and gradients), the LR schedule, ``dual_view_loss`` (loss
and every parameter gradient, dropout off, per-row dual text lengths),
five Adam steps of the train step (dropout rates 0), and one step against
the reference torch model's own (``tests/goldens/adam_step_parity.npz``).
The JAX fusion model takes its einsum path (``use_pallas="auto"``); the
port's takes the kernels' plain versions, which are also the kernels'
recomputing backward. The dropout path has no JAX counterpart (the random
streams differ by design) and is checked by its statistics and by
bit-exact resume. Tolerances: f32 on both sides in another summation
order; each test states its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu import losses as jax_losses
from sdumc_tpu.core.config import LossConfig as JaxLossConfig
from sdumc_tpu.core.config import ModelConfig as JaxModelConfig
from sdumc_tpu.models.fusion import SDUMCFusion as JaxFusion
from sdumc_tpu.train.schedule import make_lr_schedule, warmup_step_decay_factor as jax_factor
from sdumc_tpu.train.state import create_train_state as jax_create_train_state
from sdumc_tpu.train.step import dual_view_loss as jax_dual_view_loss
from sdumc_tpu.train.step import make_train_step as jax_make_train_step
from sdumc_tpu_torch import losses
from sdumc_tpu_torch.convert import load_reference_state_dict, state_dict_from_flax
from sdumc_tpu_torch.core.config import (DataConfig, ExperimentConfig, LossConfig, ModelConfig,
                                         PathsConfig, TrainConfig)
from sdumc_tpu_torch.data.feature_store import SyntheticSource
from sdumc_tpu_torch.data.pipeline import MoseiDataset
from sdumc_tpu_torch.models.fusion import SDUMCFusion
from sdumc_tpu_torch.models.layers import Dropout, FrameDropout, use_generator
from sdumc_tpu_torch.ops.kernels import fused_cross, fused_pool
from sdumc_tpu_torch.train import loop
from sdumc_tpu_torch.train.schedule import make_lr_lambda, warmup_step_decay_factor
from sdumc_tpu_torch.train.state import create_train_state, make_optimizer
from sdumc_tpu_torch.train.step import dual_view_loss, make_eval_step, make_train_step

DIMS = (16, 32, 16)
SMALL = dict(general_dim=32, layers=(32, 16), fused_layers=(32, 32))
# every term of the mixed loss weighted (the CLI defaults)
LOSS = dict(text_feat_w=0.1, text_query_feat_w=0.7, features_w=0.1, rnc_w=0.8)
LENGTHS = (9, 7, 8, 5)          # ta, tt, tv, tf4: the dual text streams differ


def _batch(seed, B=6, T=(10, 7, 9, 6), lengths=LENGTHS, dims=DIMS):
    """Numpy audio/text/video/feat4 zero-padded past each t_max, vals."""
    rng = np.random.default_rng(seed)
    feats = []
    for t, n, d in zip(T, lengths, dims + (dims[1],)):
        a = rng.normal(size=(B, t, d)).astype(np.float32)
        a[:, n:] = 0.0
        feats.append(a)
    vals = rng.uniform(-3, 3, size=(B,)).astype(np.float32)
    return (*feats, vals, tuple(lengths))


def _jax_batch(b):
    a, t, v, f, vals, tmax = b
    return {"audio": jnp.asarray(a), "text": jnp.asarray(t), "video": jnp.asarray(v),
            "feat4": jnp.asarray(f), "vals": jnp.asarray(vals),
            "t_max": tuple(jnp.int32(x) for x in tmax)}


def _port_batch(b):
    a, t, v, f, vals, tmax = b
    return {"audio": torch.from_numpy(a), "text": torch.from_numpy(t),
            "video": torch.from_numpy(v), "feat4": torch.from_numpy(f),
            "vals": torch.from_numpy(vals), "t_max": tmax}


def _jax_model(**kw):
    model = JaxFusion(JaxModelConfig(input_dims=DIMS, **SMALL, **kw))
    dummy = [jnp.zeros((2, 4, d), jnp.float32) for d in DIMS]
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *dummy)["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, **kw):
    model = SDUMCFusion(ModelConfig(input_dims=DIMS, **SMALL, **kw))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def _port_grads(model):
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
            for k, p in model.named_parameters()}


# ---------------------------------------------------------------- losses

def _grad_pair(jax_fn, torch_fn, *arrays):
    """(value, grads) of a scalar loss on both sides, grads w.r.t. every input."""
    jv, jg = jax.value_and_grad(jax_fn, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tv = torch_fn(*ts)
    tg = torch.autograd.grad(tv, ts)
    return (float(jv), [np.asarray(g) for g in jg]), (tv.item(), [g.numpy() for g in tg])


def test_mse_rmse_match_jax():
    rng = np.random.default_rng(0)
    pred, target = rng.normal(size=(6, 1)).astype(np.float32), rng.normal(size=6).astype(np.float32)
    a, b = rng.normal(size=(6, 3, 5)).astype(np.float32), rng.normal(size=(6, 3, 5)).astype(np.float32)
    for jfn, tfn, args in ((jax_losses.mse_loss, losses.mse_loss, (pred, target)),
                           (jax_losses.rmse_loss, losses.rmse_loss, (a, b))):
        (jv, jg), (tv, tg) = _grad_pair(jfn, tfn, *args)
        np.testing.assert_allclose(tv, jv, rtol=1e-5)
        for g, r in zip(tg, jg):
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", ["distinct", "duplicates"])
def test_rnc_loss_matches_jax(case):
    """Values and feature gradients, rtol 1e-5; "duplicates" repeats labels
    and makes one pair of feature rows identical (a zero distance off the
    diagonal), where a plain norm's gradient is NaN."""
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(8, 2, 5)).astype(np.float32)
    labels = rng.uniform(-3, 3, size=(8, 1)).astype(np.float32)
    if case == "duplicates":
        labels[3] = labels[1]
        labels[6] = labels[1]
        feats[5, 1] = feats[2, 0]
    (jv, (jg,)), (tv, (tg,)) = _grad_pair(
        lambda f: jax_losses.rnc_loss(f, jnp.asarray(labels)),
        lambda f: losses.rnc_loss(f, torch.from_numpy(labels)), feats)
    assert np.isfinite(tg).all()
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-7)


# -------------------------------------------------------------- schedule

def test_schedule_matches_jax_and_lambdalr():
    """40 epochs of factors vs the JAX schedule and the reference's
    per-epoch LambdaLR, and the per-step LambdaLR floored to epochs, rtol
    1e-6."""
    base_lr, spe = 1e-4, 3
    ours = [base_lr * warmup_step_decay_factor(e) for e in range(40)]
    np.testing.assert_allclose(ours, [base_lr * float(jax_factor(e)) for e in range(40)], rtol=1e-6)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=base_lr)
    ref = torch.optim.lr_scheduler.LambdaLR(opt, lambda e: warmup_step_decay_factor(e))
    lrs = []
    for _ in range(40):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        ref.step()
    np.testing.assert_allclose(ours, lrs, rtol=1e-6)

    sched = make_lr_schedule(base_lr, steps_per_epoch=spe)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=base_lr)
    per_step = torch.optim.lr_scheduler.LambdaLR(opt, make_lr_lambda(spe))
    for step in range(40 * spe):
        # read before the update, as optax reads its count
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(sched(step)), rtol=1e-6)
        opt.step()
        per_step.step()


# ---------------------------------------------------- dual-view loss, Adam

@pytest.fixture(scope="module")
def loss_case():
    """JAX's dual_view_loss value and grads (deterministic, one jit)."""
    jmodel, params = _jax_model()
    batch = _batch(2)
    cfg = JaxLossConfig(**LOSS)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_dual_view_loss(jmodel, p, b, cfg, jax.random.PRNGKey(0),
                                        deterministic=True), has_aux=True))
    (loss, metrics), grads = fn(params, _jax_batch(batch))
    return params, batch, float(loss), jax.tree_util.tree_map(np.asarray, metrics), \
        state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))


def test_dual_view_loss_matches_jax(loss_case):
    """Loss rtol 1e-5, every parameter gradient rtol 1e-4 / atol 1e-6, the
    metric sums rtol 1e-5; the port in eval mode with gradients flowing."""
    params, batch, ref_loss, ref_metrics, ref_grads = loss_case
    model = _port_model(params).eval()
    loss, metrics = dual_view_loss(model, _port_batch(batch), LossConfig(**LOSS))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    for key in ("mse_full", "mse_missing", "rnc", "sq_err_full", "sq_err_missing", "count"):
        np.testing.assert_allclose(metrics[key].item(), ref_metrics[key], rtol=1e-5, err_msg=key)
    grads = _port_grads(model)
    assert grads.keys() == ref_grads.keys()
    for key, ref in ref_grads.items():
        np.testing.assert_allclose(grads[key], ref.numpy(), rtol=1e-4, atol=1e-6, err_msg=key)
    # the teacher's text targets are detached, its features are not
    assert np.abs(grads["cross_text_query_mlp.0.weight"]).max() > 0


def test_five_adam_steps_match_jax():
    """create_train_state + make_train_step on both sides, dropout rates 0,
    five batches with per-row dual text lengths, a warmup schedule of 2
    steps per epoch. Each step's loss rtol 1e-4; the params rtol 1e-3 /
    atol 2 * lr * steps: Adam moves each element by about lr a step, so
    float noise on a near-zero gradient can flip its sign."""
    lr, steps, spe = 1e-3, 5, 2
    rates = dict(dropout=0.0, attn_dropout=0.0)
    jmodel, params = _jax_model(**rates)
    jstate = jax_create_train_state(jmodel, params, make_lr_schedule(lr, spe), l2=1e-5)
    jstep = jax_make_train_step(jmodel, JaxLossConfig(**LOSS))
    model = _port_model(params, **rates)
    state = create_train_state(model, TrainConfig(lr=lr, l2=1e-5), spe)
    step = make_train_step(state, LossConfig(**LOSS), seed=0)
    for i in range(steps):
        lengths = (10 - i % 3, 7 - i % 2, 9, 6 - i % 4)
        b = _batch(10 + i, lengths=lengths)
        jstate, jm = jstep(jstate, _jax_batch(b), jax.random.PRNGKey(0))
        m = step(_port_batch(b))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4, err_msg=str(i))
    assert state.step == steps and state.scheduler.get_last_lr()[0] == pytest.approx(lr * 0.6)
    ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    for key, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), ref[key].numpy(), rtol=1e-3,
                                   atol=2 * lr * steps, err_msg=key)


# the golden's checked params: flax path -> (port key, stored transposed)
_ADAM_CHECKS = {
    ("frame_dim_reshape_0", "dense", "kernel"): ("frame_dim_reshape_0.weight", True),
    ("fc_out_v", "dense", "bias"): ("fc_out_v.bias", False),
    ("fra2utt_1", "context"): ("fra2utt_1.attention_context_vector", False),
    ("cross_att_fra2utt_0", "query_proj", "dense", "kernel"):
        ("cross_att_fra2utt_0.query_proj.weight", True),
    ("orgin_linear_change_1", "dense", "kernel"): ("orgin_linear_change.2.weight", True),
}


def test_adam_step_matches_reference_golden():
    """One Adam(1e-4, l2 1e-5) step from the reference torch model's weights
    on the golden's batch, dropout off: the loss rtol 1e-4 and the checked
    params rtol 2e-3 / atol 2e-4 (= 2 lr: Adam's first step is about
    +-lr * sign(g)), as tests/test_train.py holds the JAX step."""
    from pathlib import Path

    golden = np.load(Path(__file__).parent / "goldens" / "adam_step_parity.npz")
    dims = (24, 48, 24)
    model = SDUMCFusion(ModelConfig(input_dims=dims))
    init = {k[len("init/"):]: torch.from_numpy(golden[k]) for k in golden.files
            if k.startswith("init/")}
    report = load_reference_state_dict(init, model)
    assert report["unmapped"] == [] and report["missing"] == []
    rng = np.random.default_rng(0)          # the golden's batch (tests/test_train.py)
    B, TA, TT, TV, TF = 6, 7, 5, 6, 4
    a = rng.normal(size=(B, TA, dims[0])).astype(np.float32)
    t = rng.normal(size=(B, TT, dims[1])).astype(np.float32)
    v = rng.normal(size=(B, TV, dims[2])).astype(np.float32)
    f = rng.normal(size=(B, TF, dims[1])).astype(np.float32)
    vals = rng.uniform(-3, 3, size=(B,)).astype(np.float32)
    model.eval()
    opt = make_optimizer(model.parameters(), 1e-4, 1e-5)
    loss, _ = dual_view_loss(model, _port_batch((a, t, v, f, vals, (TA, TT, TV, TF))),
                             LossConfig())
    loss.backward()
    opt.step()
    np.testing.assert_allclose(loss.item(), float(golden["loss_t"]), rtol=1e-4)
    sd = model.state_dict()
    for path, (key, transpose) in _ADAM_CHECKS.items():
        got = sd[key].numpy()
        np.testing.assert_allclose(got.T if transpose else got, golden["post/" + "|".join(path)],
                                   rtol=2e-3, atol=2e-4, err_msg=key)


# --------------------------------------------------------------- dropout

def _drop(module_cls, rate, x, seed=0):
    m = module_cls(rate).train()
    m.generator = torch.Generator().manual_seed(seed)
    return m(x)


@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_frame_dropout_keep_share_and_exact_scale(rate):
    """Kept share within 4 sigma of 1 - k/256; kept values scaled by exactly
    1 / (1 - k/256); dropped positions get zero gradient, kept ones the
    scale."""
    k = round(rate * 256)
    keep_p = 1 - k / 256
    x = (torch.rand(64, 50, 32) + 0.5).requires_grad_()
    y = _drop(FrameDropout, rate, x)
    kept = y != 0
    share = kept.float().mean().item()
    assert abs(share - keep_p) < 4 * np.sqrt(keep_p * (1 - keep_p) / x.numel())
    assert torch.equal(y[kept], x.detach()[kept] * (1.0 / keep_p))
    y.sum().backward()
    assert torch.equal(x.grad[~kept], torch.zeros(int((~kept).sum())))
    assert torch.equal(x.grad[kept], torch.full((int(kept.sum()),), 1.0 / keep_p))


@pytest.mark.parametrize("module_cls", [FrameDropout, Dropout])
def test_dropout_rate_one_gives_zeros_and_zero_gradient(module_cls):
    x = torch.randn(4, 9, 8, requires_grad=True)
    y = _drop(module_cls, 1.0, x)
    y.sum().backward()
    assert torch.equal(y, torch.zeros_like(y))
    assert torch.equal(x.grad, torch.zeros_like(x))


def test_frame_dropout_below_one_in_512_still_drops():
    """rate 1e-3 quantises to k = 0; it drops at its exact rate instead."""
    x = torch.ones(200, 100, 50)
    y = _drop(FrameDropout, 1e-3, x)
    dropped = (y == 0).float().mean().item()
    assert abs(dropped - 1e-3) < 4 * np.sqrt(1e-3 / x.numel())
    assert torch.allclose(y[y != 0], torch.tensor(1 / (1 - 1e-3)))


def test_dropout_draws_only_from_its_generator():
    """The same generator seed gives the same mask, the global stream is
    not read, eval mode is the identity, and training without a generator
    raises."""
    x = torch.randn(8, 30, 16)
    state = torch.get_rng_state()
    assert torch.equal(_drop(FrameDropout, 0.5, x, 3), _drop(FrameDropout, 0.5, x, 3))
    assert torch.equal(_drop(Dropout, 0.3, x, 3), _drop(Dropout, 0.3, x, 3))
    assert torch.equal(torch.get_rng_state(), state)
    assert FrameDropout(0.5).eval()(x) is x
    with pytest.raises(RuntimeError, match="generator"):
        Dropout(0.3).train()(x)


def test_batch_to_device_reads_the_batch_owned_buffers():
    """batch_to_device_dict copies from the torch tensors that own a batch's
    arrays (``Batch.pinned``, page-locked on a card), and from a fresh copy
    of an array that was replaced since; the values are the batch's."""
    from sdumc_tpu_torch.data.collate import make_batch
    from sdumc_tpu_torch.train.step import batch_to_device_dict

    a, t, v, f, vals, _ = _batch(4)
    owners = []

    def alloc(shape):
        owners.append(torch.zeros(shape))
        return owners[-1].numpy()

    batch = make_batch(list(a), list(t), list(v), list(f), np.zeros(6), vals,
                       [str(i) for i in range(6)], buckets=(16,), alloc=alloc)
    batch.pinned = tuple(owners)
    d = batch_to_device_dict(batch, "cpu")
    assert [d[k].data_ptr() for k in ("audio", "text", "video", "feat4")] == [
        o.data_ptr() for o in owners]
    replaced = dataclasses.replace(batch, audio=batch.audio.copy())
    d2 = batch_to_device_dict(replaced, "cpu")
    assert d2["audio"].data_ptr() != owners[0].data_ptr()
    assert d2["text"].data_ptr() == owners[1].data_ptr()
    for k in ("audio", "text", "video", "feat4", "vals"):
        np.testing.assert_array_equal(d2[k].numpy(), getattr(batch, k))
    assert d2["t_max"] == batch.t_max


# ------------------------------------------ the kernel's autograd.Function

def _kernel_case(Q, seed=0):
    rng = np.random.default_rng(seed)
    B, T, D = 4, 6, 5
    f = lambda *s: torch.from_numpy(rng.normal(size=s) * 0.5)  # noqa: E731
    q = f(D) if Q == 1 else f(B, Q, D)
    return q, f(B, T, D), f(D, D), f(D), torch.tensor([T, 0, 3, T + 2])


@pytest.mark.parametrize("Q", [7, 1])
def test_recomputed_backward_gradcheck(Q):
    """``fused_cross.Recomputed`` (the card path's autograd.Function) with
    the plain formulation standing in for the kernel: float64 gradcheck of
    q (or the shared context), x, W and b, with per-row t_max 0, < T and
    > T."""
    q, x, w, b, tmax = _kernel_case(Q)
    if Q == 1:
        fn = lambda c, x, w, b: fused_cross.Recomputed.apply(  # noqa: E731
            fused_pool._plain, fused_pool._plain, c, x, w, b, tmax, 0.3)
    else:
        plain = fused_cross.fused_cross_attention_plain
        fn = lambda q, x, w, b: fused_cross.Recomputed.apply(  # noqa: E731
            plain, plain, q, x, w, b, tmax, 0.3)
    args = [t.requires_grad_() for t in (q, x, w, b)]
    assert torch.autograd.gradcheck(fn, args)
    # only some inputs needing a gradient
    out = fn(q.detach(), x, w.detach(), b.detach())
    (gx,) = torch.autograd.grad(out.sum(), [x])
    assert gx.shape == x.shape


def test_fully_masked_row_gradients():
    """A row with t_max = 0 softmaxes uniformly over the whole bucket: it
    sends nothing to q, W and b, and g / T to every frame of x."""
    q, x, w, b, tmax = _kernel_case(7)
    q, x, w, b = (t.requires_grad_() for t in (q, x, w, b))
    g = torch.randn(4, 7, 5, dtype=torch.float64)
    only_row1 = torch.zeros_like(g)
    only_row1[1] = g[1]
    out = fused_cross.fused_cross_attention_plain(q, x, w, b, tmax)
    gq, gx, gw, gb = torch.autograd.grad(out, [q, x, w, b], only_row1)
    T = x.shape[1]
    assert torch.equal(gq, torch.zeros_like(gq))
    assert torch.equal(gw, torch.zeros_like(gw)) and torch.equal(gb, torch.zeros_like(gb))
    torch.testing.assert_close(gx[1], g[1].sum(0).expand(T, -1) / T)


# ------------------------------------------------------------ loop, CLI

def _loop_dataset():
    dims = {"audio": 16, "text": 32, "video": 16, "feat4": 32}
    sources = {k: SyntheticSource(k, d, 4, 16) for k, d in dims.items()}
    rng = np.random.default_rng(0)
    names = [f"c{i}" for i in range(24)]
    labels = [{"emo": 0.0, "val": float(rng.uniform(-3, 3))} for _ in names]
    return MoseiDataset(names, labels, sources)


def _loop_cfg(ckpt, epochs=2):
    return ExperimentConfig(
        paths=PathsConfig(),
        data=DataConfig(batch_size=8, length_buckets=(16,)),
        model=ModelConfig(input_dims=DIMS, **SMALL),       # dropout on: 0.3 / 0.5
        train=TrainConfig(epochs=epochs, lr=1e-3, checkpoint_dir=str(ckpt)),
    )


def _fresh_model(cfg):
    return SDUMCFusion(cfg.model, torch.Generator().manual_seed(4))


def _assert_same_run(a, b):
    assert a["history"][-1]["epoch"] == b["history"][-1]["epoch"]
    assert a["best_full"] == b["best_full"] and a["best_missing"] == b["best_missing"]
    sa, sb = a["state"].model.state_dict(), b["state"].model.state_dict()
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key
    assert a["state"].step == b["state"].step


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    ds = _loop_dataset()
    cfg = _loop_cfg(tmp_path_factory.mktemp("full"))
    return ds, loop.train(cfg, _fresh_model(cfg), ds, ds, ds, log=lambda *a: None)


def test_resume_is_bit_exact(uninterrupted, tmp_path):
    """One epoch, then --resume from latest.pt for the second == two epochs
    straight, bit for bit, with dropout on."""
    ds, full = uninterrupted
    first = loop.train(_loop_cfg(tmp_path, epochs=1), _fresh_model(_loop_cfg(tmp_path)),
                       ds, ds, ds, log=lambda *a: None)
    timeless = lambda h: {k: v for k, v in h.items() if k != "clips_per_sec"}  # noqa: E731
    assert timeless(first["history"][0]) == timeless(full["history"][0])
    cfg = _loop_cfg(tmp_path)
    resumed = loop.train(cfg, _fresh_model(cfg), ds, ds, ds, log=lambda *a: None,
                         resume_from=str(tmp_path / "latest.pt"))
    _assert_same_run(resumed, full)


def test_preemption_then_resume_is_bit_exact(uninterrupted, tmp_path):
    """A guard that fires at the 5th per-step poll (epoch 1, step 2) saves
    the epoch-boundary state under epoch 0; --resume redoes epoch 1 and
    ends bit-equal to the uninterrupted run."""
    ds, full = uninterrupted

    class Countdown:
        def __init__(self, n):
            self.n = n

        @property
        def fired(self):
            self.n -= 1
            return self.n < 0

    cfg = _loop_cfg(tmp_path)
    cut = loop.train(cfg, _fresh_model(cfg), ds, ds, ds, log=lambda *a: None,
                     preemption_guard=Countdown(4))
    assert cut.get("preempted") is True and cut["state"].step == 3
    assert torch.load(tmp_path / "latest.pt", weights_only=True)["epoch"] == 0
    resumed = loop.train(cfg, _fresh_model(cfg), ds, ds, ds, log=lambda *a: None,
                         resume_from=str(tmp_path / "latest.pt"))
    _assert_same_run(resumed, full)


def test_eval_after_a_train_step_runs_in_eval_mode():
    """The eval step sets eval mode on every call: after a train step (which
    sets train mode) its predictions repeat and equal a plain eval forward."""
    model = _fresh_model(_loop_cfg("unused"))
    state = create_train_state(model, TrainConfig(), 3)
    train_step, eval_step = make_train_step(state, LossConfig(), 0), make_eval_step(model)
    batch = _port_batch(_batch(5))
    train_step(batch)
    assert model.training
    first = eval_step(batch)
    assert not model.training
    model.train()
    again = eval_step(batch)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_train_cli_synthetic_cpu_and_best_checkpoint_through_infer(tmp_path):
    """cli.train --synthetic --device cpu at feat_scale 16 / batch 8 / one
    epoch: finite history, reference-format checkpoints, and best_full.pt
    through cli.infer --checkpoint gives the in-memory model's test
    predictions (same CPU ops: atol 1e-6) and the recorded best MAE."""
    from sdumc_tpu_torch.cli import infer, train
    from sdumc_tpu_torch.data.pipeline import get_loaders

    common = ["--synthetic", "--device", "cpu", "--feat_scale", "16", "--batch_size", "8"]
    result = train.main(common + ["--epochs", "1", "--checkpoint_dir", str(tmp_path / "ck"),
                                  "--save_root", str(tmp_path / "saved")])
    (h,) = result["history"]
    assert all(np.isfinite(h[k]) for k in ("train_loss", "train_mse_full", "train_mse_missing"))
    assert (tmp_path / "saved" / "features_ablation_study.txt").exists()
    best = tmp_path / "ck" / "best_full.pt"
    blob = torch.load(best, weights_only=True)
    assert set(blob) == {"epoch", "state_dict", "optimizer"} and blob["epoch"] == 0

    out = infer.main(common + ["--checkpoint", str(best)])
    cfg = ExperimentConfig(data=DataConfig(feat_scale=16, batch_size=8))
    _, _, test_ds = get_loaders("CMU-MOSEI", cfg.data, cfg.paths, synthetic=True)
    ref = loop.run_eval(make_eval_step(result["state"].model), test_ds, cfg, "cpu")
    np.testing.assert_allclose(out["results"]["val_preds_full"], ref["val_preds_full"],
                               rtol=0, atol=1e-6)
    assert out["full"]["mae"] == pytest.approx(result["best_full"]["mae"], rel=1e-9)


@pytest.mark.parametrize("flags, error", [
    (["--multihost"], "multi-device"),
    (["--feature_dtype", "bfloat16"], "bfloat16"),
    (["--checkpoint", "orbax_dir"], "Orbax"),
])
def test_train_cli_refuses_what_is_not_ported(flags, error, tmp_path):
    from sdumc_tpu_torch.cli import train

    with pytest.raises((NotImplementedError, ValueError), match=error):
        train.main(["--synthetic", "--device", "cpu", "--feat_scale", "16",
                    "--checkpoint_dir", str(tmp_path)] + flags)


def test_use_generator_reaches_every_dropout():
    model = SDUMCFusion(ModelConfig(input_dims=DIMS, **SMALL))
    gen = torch.Generator()
    use_generator(model, gen)
    drops = [m for m in model.modules() if isinstance(m, (Dropout, FrameDropout))]
    # frame + output dropout of the 6 attention ops, one per MLP layer (23)
    assert len(drops) == 12 + 23 and all(m.generator is gen for m in drops)
    assert not any(isinstance(m, torch.nn.Dropout) for m in model.modules())


def test_dual_view_config_keys_are_the_reference_losses():
    """The port's LossConfig / TrainConfig defaults are the JAX package's;
    JAX's one more loss key, the input frame dropout that nothing sets, is
    off there."""
    from sdumc_tpu.core.config import TrainConfig as JaxTrainConfig

    jl = dataclasses.asdict(JaxLossConfig())
    assert jl.pop("frame_dropout_p") == 0.0
    assert dataclasses.asdict(LossConfig()) == jl
    jt = dataclasses.asdict(JaxTrainConfig())
    assert {k: jt[k] for k in dataclasses.asdict(TrainConfig())} == dataclasses.asdict(TrainConfig())
