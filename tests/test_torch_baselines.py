"""The port's baseline families against the JAX package, on the CPU: the
utterance families (tfn, lmf, attention, misa, mmim), the shared encoder
modules, and the helpers the sequence families' file
(``test_torch_baselines_seq.py``) uses too.

Each JAX family is initialised at a small size (dims 16 / 32 / 16, B = 12,
T = 6, hidden 8, rank 3, mem 8, align_t 6, one layer, two heads, dropout
0) and its params go through ``baseline_state_dict_from_flax`` into the
port. The JAX side runs eagerly (``apply`` and ``jax.grad`` outside
``jax.jit``) under ``jax.default_matmul_precision("highest")``.

Tolerances, each the largest |difference| over the largest |reference|
value: forward REL_UTT = 1e-5 for the utterance families, REL_SEQ = 1e-4
for the recurrent families and MulT (f32 in another summation order
through up to 2 x 6 steps or an attention stack); every gradient of
``dual_view_loss`` GRAD_REL = 1e-4 of its parameter's largest value plus
GRAD_FLOOR = 1e-7 of the largest gradient of all.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.core.config import LossConfig as JaxLossConfig
from sdumc_tpu.core.config import ModelConfig as JaxModelConfig
from sdumc_tpu.models import baselines as jax_baselines
from sdumc_tpu.models import get_model as jax_get_model
from sdumc_tpu.models.modules import transformer_encoder as jax_te
from sdumc_tpu.train.schedule import make_lr_schedule
from sdumc_tpu.train.state import create_train_state as jax_create_train_state
from sdumc_tpu.train.step import dual_view_loss as jax_dual_view_loss
from sdumc_tpu_torch.convert import baseline_state_dict_from_flax
from sdumc_tpu_torch.core.config import LossConfig, ModelConfig, TrainConfig
from sdumc_tpu_torch.models import baselines, get_model
from sdumc_tpu_torch.models.layers import Draws, use_generator
from sdumc_tpu_torch.models.modules import transformer_encoder as te
from sdumc_tpu_torch.train.state import create_train_state
from sdumc_tpu_torch.train.step import dual_view_loss, make_train_step

torch.set_num_threads(1)

DIMS = (16, 32, 16)
SMALL = dict(input_dims=DIMS, baseline_hidden_dim=8, baseline_rank=3, baseline_mem_dim=8,
             baseline_align_t=6, baseline_layers=1, baseline_heads=2, dropout=0.0)
B, T = 12, 6
LENGTHS = (5, 6, 4, 3)           # ta, tt, tv, tf4: below T and equal to it
LOSS = dict(text_feat_w=0.1, text_query_feat_w=0.7, features_w=0.1, rnc_w=0.8)
AUX_KEYS = ("features", "rnc", "text_feat", "text_query_feat")
REL_UTT, REL_SEQ, GRAD_REL, GRAD_FLOOR = 1e-5, 1e-4, 1e-4, 1e-7
UTTERANCE = ("tfn", "lmf", "attention", "misa", "mmim")


def assert_rel(got, ref, rel, what="", atol=0.0):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max(initial=0.0)
    assert err <= rel * max(np.abs(ref).max(initial=0.0), 1e-30) + atol, (what, err)


def make_batch(seed, lengths=LENGTHS, dtype=np.float32):
    """Numpy audio/text/video/feat4 [B, T, D] zero past each t_max, vals."""
    rng = np.random.default_rng(seed)
    feats = {}
    for key, n, d in zip(("audio", "text", "video", "feat4"), lengths, DIMS + (DIMS[1],)):
        a = rng.normal(size=(B, T, d)).astype(np.float32)
        a[:, n:] = 0.0
        feats[key] = a.astype(dtype)
    feats["vals"] = rng.uniform(-3, 3, size=B).astype(np.float32)
    feats["t_max"] = tuple(lengths)
    return feats


def jax_batch(b):
    out = {k: jnp.asarray(v) for k, v in b.items() if k != "t_max"}
    out["t_max"] = tuple(jnp.int32(t) for t in b["t_max"])
    return out


def port_batch(b):
    out = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in b.items() if k != "t_max"}
    out["t_max"] = b["t_max"]
    return out


_FAMILIES = {}


def jax_family(name, **kw):
    """(JAX model, its params as numpy) at the small size, made once per
    process for each configuration."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _FAMILIES:
        model = jax_get_model(JaxModelConfig(name=name, **{**SMALL, **kw}))
        dummy = [jnp.zeros((2, T, d), jnp.float32) for d in DIMS]
        params = jax.jit(model.init)(jax.random.PRNGKey(0), *dummy)["params"]
        _FAMILIES[key] = model, jax.tree_util.tree_map(np.asarray, params)
    return _FAMILIES[key]


def port_family(name, params, **kw):
    model = get_model(ModelConfig(name=name, **{**SMALL, **kw}), torch.Generator().manual_seed(0))
    model.load_state_dict(baseline_state_dict_from_flax(name, params), strict=True)
    return model


def jax_apply(model, params, b, t_max, train=False):
    with jax.default_matmul_precision("highest"):
        kw = {"rngs": {"dropout": jax.random.PRNGKey(3)}} if train else {}
        vals, aux = model.apply({"params": params}, jnp.asarray(b["audio"]),
                                jnp.asarray(b["text"]), jnp.asarray(b["video"]),
                                t_max=tuple(jnp.int32(t) for t in t_max),
                                deterministic=not train, **kw)
    return np.asarray(vals), jax.tree_util.tree_map(np.asarray, aux)


def port_apply(model, b, t_max, train=False):
    model.train(train)
    if train:
        use_generator(model, torch.Generator().manual_seed(0))
    x = [torch.from_numpy(np.asarray(b[k], np.float32))
         .to(torch.float32 if b[k].dtype == np.float32 else torch.bfloat16)
         for k in ("audio", "text", "video")]
    with torch.no_grad():
        vals, aux = model(*x, t_max=t_max)
    return vals, aux


def check_forward(name, rel, t_max):
    """Eval-mode vals and the four aux streams, port vs JAX."""
    jm, params = jax_family(name)
    b = make_batch(1)
    jv, ja = jax_apply(jm, params, b, t_max)
    tv, ta = port_apply(port_family(name, params), b, t_max)
    assert_rel(tv.numpy(), jv, rel, "vals")
    for key in AUX_KEYS:
        assert_rel(ta[key].numpy(), ja[key], rel, key)


def check_model_loss(name, rel, **kw):
    """Training-mode model_loss (and vals), port vs JAX, dropout 0."""
    jm, params = jax_family(name, **kw)
    b = make_batch(2)
    jv, ja = jax_apply(jm, params, b, LENGTHS[:3], train=True)
    tv, ta = port_apply(port_family(name, params, **kw), b, LENGTHS[:3], train=True)
    assert_rel(tv.numpy(), jv, rel, "vals")
    np.testing.assert_allclose(float(ta["model_loss"]), float(ja["model_loss"]), rtol=rel,
                               atol=1e-7)


def check_gradients(name, **kw):
    """dual_view_loss's loss and every parameter gradient in training mode
    (dropout 0), port vs jax.grad of JAX's dual_view_loss; the loss to rtol
    1e-5, each gradient to GRAD_REL of its largest value plus GRAD_FLOOR of
    the largest gradient of all (the floor of a gradient that is 0 up to
    rounding: RnC is blind to a shift of its features, so rnc_proj's bias
    gets about 1e-9)."""
    jm, params = jax_family(name, **kw)
    b = make_batch(3)
    with jax.default_matmul_precision("highest"):
        (ref_loss, _), grads = jax.value_and_grad(
            lambda p: jax_dual_view_loss(jm, p, jax_batch(b), JaxLossConfig(**LOSS),
                                         jax.random.PRNGKey(0), deterministic=False),
            has_aux=True)(params)
    ref = baseline_state_dict_from_flax(name, jax.tree_util.tree_map(np.asarray, grads))
    model = port_family(name, params, **kw).train()
    use_generator(model, torch.Generator().manual_seed(0))
    loss, _ = dual_view_loss(model, port_batch(b), LossConfig(**LOSS))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    got = dict(model.named_parameters())
    assert got.keys() == ref.keys()
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in ref.values())
    for key, g in ref.items():
        pg = got[key].grad
        assert_rel(np.zeros(g.shape) if pg is None else pg.numpy(), g.numpy(), GRAD_REL, key,
                   atol=floor)


def check_adam(name, lr=1e-3, steps=5, spe=2):
    """Five train steps (dropout 0, L2 1e-5, a 2-steps-per-epoch warmup
    schedule) from the same weights: JAX's gradient (one jit for the five
    batches, which share their shapes) and optax update, the port's train
    step; each loss rtol 1e-4, the params rtol 1e-3 / atol 2 lr steps (Adam
    moves an element about lr a step, so float noise on a near-zero
    gradient can flip its direction)."""
    jm, params = jax_family(name)
    jstate = jax_create_train_state(jm, params, make_lr_schedule(lr, spe), l2=1e-5)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, jb: jax_dual_view_loss(jm, p, jb, JaxLossConfig(**LOSS),
                                         jax.random.PRNGKey(0), deterministic=False),
        has_aux=True))
    model = port_family(name, params)
    state = create_train_state(model, TrainConfig(lr=lr, l2=1e-5), spe)
    step = make_train_step(state, LossConfig(**LOSS), seed=0)
    for i in range(steps):
        lengths = (6 - i % 3, 6 - i % 2, 5, 4 - i % 3)
        b = make_batch(10 + i, lengths)
        with jax.default_matmul_precision("highest"):
            (jloss, _), grads = grad_fn(jstate.params, jax_batch(b))
        jstate = jstate.apply_gradients(grads=grads)
        m = step(port_batch(b))
        np.testing.assert_allclose(m["loss"].item(), float(jloss), rtol=1e-4, err_msg=str(i))
    ref = baseline_state_dict_from_flax(name, jax.tree_util.tree_map(np.asarray, jstate.params))
    for key, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), ref[key].numpy(), rtol=1e-3,
                                   atol=2 * lr * steps, err_msg=key)


def count_params(name):
    _, params = jax_family(name)
    jax_counts = sorted(np.size(v) for v in jax.tree_util.tree_leaves(params))
    model = get_model(ModelConfig(name=name, **SMALL))
    return jax_counts, sorted(p.numel() for p in model.parameters() if p.requires_grad)


# ------------------------------------------------------------------ families

@pytest.mark.parametrize("t_max", [LENGTHS[:3], (T, T, T)], ids=["below_T", "equal_T"])
@pytest.mark.parametrize("name", UTTERANCE)
def test_forward_matches_jax(name, t_max):
    check_forward(name, REL_UTT, t_max)


@pytest.mark.parametrize("name", ["misa", "mmim"])
def test_model_loss_in_training_mode_matches_jax(name):
    check_model_loss(name, REL_UTT)


@pytest.mark.parametrize("name", UTTERANCE)
def test_dual_view_gradients_match_jax(name):
    check_gradients(name)


def test_five_adam_steps_match_jax_misa():
    check_adam("misa")


@pytest.mark.parametrize("name", UTTERANCE)
def test_trainable_parameters_are_jax_s(name):
    """The same trainable tensors as JAX, element counts and all."""
    jax_counts, port_counts = count_params(name)
    assert port_counts == jax_counts


def test_lmf_fresh_init_has_flax_s_distributions():
    """At the default widths: zero biases, Dense kernels with std
    1 / sqrt(fan_in) truncated at 2 of the draw's std, LMF's factors and
    fusion weights xavier-uniform over flax's fans."""
    model = get_model(ModelConfig(name="lmf"), torch.Generator().manual_seed(1))
    for name, p in model.named_parameters():
        w = p.detach().double()
        if name.endswith("bias"):
            assert torch.count_nonzero(w) == 0, name
        elif name.endswith("weight"):
            fan_in = w.shape[1]
            std = w.std().item() * np.sqrt(fan_in)
            assert abs(std - 1.0) < max(0.1, 4 / np.sqrt(w.numel())), (name, std)
            assert w.abs().max() <= 2 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-7, name
        else:                                                      # factor_i, fusion_weights
            rec = int(np.prod(w.shape[:-2]))
            limit = np.sqrt(6 / (rec * (w.shape[-2] + w.shape[-1])))
            assert w.abs().max() <= limit, name
            if w.numel() > 1000:
                assert abs(w.std().item() / (limit / np.sqrt(3)) - 1) < 0.05, name


# ------------------------------------------------------------------ helpers

def test_masked_mean_matches_jax_in_f32_and_bf16():
    """f32 to 1e-6; bf16 bit for bit (the sum in f32 rounded to bf16, then
    divided by t_max in bf16), at t_max 0, below T, equal to T and where
    t_max is not a bf16 integer."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 300, 4)).astype(np.float32)
    for t in (0, 7, 257, 300):
        ref = np.asarray(jax_baselines.masked_mean(jnp.asarray(x), jnp.int32(t)))
        np.testing.assert_allclose(baselines.masked_mean(torch.from_numpy(x), t).numpy(), ref,
                                   rtol=1e-6, atol=1e-7)
        xb = jnp.asarray(x, jnp.bfloat16)
        ref = np.asarray(jax_baselines.masked_mean(xb, jnp.int32(t)).astype(jnp.float32))
        got = baselines.masked_mean(torch.from_numpy(np.array(xb.astype(jnp.float32)))
                                    .to(torch.bfloat16), t)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), ref)


def test_cmd_diff_and_infonce_match_jax():
    rng = np.random.default_rng(6)
    x, y = (rng.uniform(size=(10, 7)).astype(np.float32) for _ in range(2))
    s = rng.normal(size=(10, 10)).astype(np.float32)
    for jfn, tfn, args in ((jax_baselines._cmd_loss, baselines._cmd_loss, (x, y)),
                           (jax_baselines._diff_loss, baselines._diff_loss, (x, y)),
                           (jax_baselines._infonce, baselines._infonce, (s,))):
        ref = float(jfn(*map(jnp.asarray, args)))
        np.testing.assert_allclose(tfn(*map(torch.from_numpy, args)).item(), ref, rtol=1e-5)


def test_unknown_model_lists_the_registered_families():
    with pytest.raises(KeyError) as exc:
        get_model(ModelConfig(name="nope"))
    for name in UTTERANCE + ("mfn", "graph_mfn", "mfm", "mctn", "mult"):
        assert name in str(exc.value)


def test_use_generator_reaches_the_families_draws():
    """MFM's prior and MCTN's teacher-forcing mask draw from the step's
    generator; without one, training mode raises."""
    for name in ("mfm", "mctn"):
        model = get_model(ModelConfig(name=name, **SMALL))
        draws = [m for m in model.modules() if isinstance(m, Draws)]
        gen = torch.Generator()
        use_generator(model, gen)
        assert draws and all(m.generator is gen for m in draws)
        fresh = get_model(ModelConfig(name=name, **SMALL)).train()
        b = make_batch(0)
        with pytest.raises(RuntimeError, match="generator"):
            fresh(*(torch.from_numpy(b[k]) for k in ("audio", "text", "video")),
                  t_max=LENGTHS[:3])


# ------------------------------------------------------------------ modules

def _module_pair(jax_module, port_module, name, *inputs):
    params = jax.jit(jax_module.init)(jax.random.PRNGKey(0), *map(jnp.asarray, inputs))["params"]
    port_module.load_state_dict(
        baseline_state_dict_from_flax(name, jax.tree_util.tree_map(np.asarray, params)),
        strict=True)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_module.apply({"params": params}, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = port_module.eval()(*map(torch.from_numpy, inputs)).numpy()
    return got, ref


@pytest.mark.parametrize("kind", ["cross", "self", "causal"])
def test_transformer_encoder_matches_jax(kind):
    """Two layers, dim 12, 3 heads, scaled embeddings; cross attends a
    9-step stream from a 7-step one, causal masks at -1e30."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 7, 12)).astype(np.float32)
    kv = rng.normal(size=(4, 9, 12)).astype(np.float32)
    kw = dict(dim=12, layers=2, heads=3, causal=kind == "causal")
    inputs = (x, kv) if kind == "cross" else (x,)
    got, ref = _module_pair(jax_te.CrossModalTransformerEncoder(**kw),
                            te.CrossModalTransformerEncoder(**kw, cross=kind == "cross"),
                            "encoder", *inputs)
    assert_rel(got, ref, REL_UTT)


def test_sinusoidal_positions_match_jax():
    for length, dim in ((7, 12), (5, 9), (3, 2)):
        np.testing.assert_allclose(te.sinusoidal_positions(length, dim).numpy(),
                                   np.asarray(jax_te.sinusoidal_positions(length, dim)),
                                   rtol=1e-6, atol=1e-6)


def test_mlp_and_lstm_encoders_match_jax():
    """The LSTM encoder's backward direction runs over the whole padded
    sequence from its last frame, as flax's nn.RNN(reverse=True)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(5, 11)).astype(np.float32)
    got, ref = _module_pair(jax_te.MLPEncoder(hidden=6, out_dim=4), te.MLPEncoder(11, 6, 4),
                            "mlp_encoder", x)
    assert_rel(got, ref, REL_UTT)
    seq = rng.normal(size=(5, 8, 11)).astype(np.float32)
    got, ref = _module_pair(jax_te.LSTMEncoder(hidden=6, out_dim=4), te.LSTMEncoder(11, 6, 4),
                            "lstm_encoder", seq)
    assert_rel(got, ref, REL_SEQ)


# ---------------------------------------------------------------- bf16, CLI

def check_bf16(name, rel):
    """A bf16 batch (the same bf16 values on both sides), eval mode."""
    jm, params = jax_family(name)
    b = make_batch(4)
    for k in ("audio", "text", "video"):
        b[k] = np.asarray(jnp.asarray(b[k], jnp.bfloat16))
    jv, ja = jax_apply(jm, params, b, LENGTHS[:3])
    tv, ta = port_apply(port_family(name, params), b, LENGTHS[:3])
    assert_rel(tv.numpy(), jv, rel, "vals")
    for key in AUX_KEYS:
        assert_rel(ta[key].numpy(), ja[key], rel, key)


def test_bf16_batch_matches_jax_tfn():
    """The pool rounds as JAX's (bit for bit above); after it, f32: 1e-5."""
    check_bf16("tfn", REL_UTT)


def run_cli(name, tmp_path):
    """cli.train --synthetic --device cpu --feat_scale 16 --model NAME, one
    epoch; then best_full.pt through cli.infer --model NAME reproduces the
    logged best test MAE (the same CPU ops)."""
    from sdumc_tpu_torch.cli import infer, train

    common = ["--synthetic", "--device", "cpu", "--feat_scale", "16", "--batch_size", "8",
              "--model", name]
    result = train.main(common + ["--epochs", "1", "--checkpoint_dir", str(tmp_path / "ck"),
                                  "--save_root", str(tmp_path / "saved")])
    (h,) = result["history"]
    assert all(np.isfinite(h[k]) for k in ("train_loss", "train_mse_full", "eval_mse_full"))
    out = infer.main(common + ["--checkpoint", str(tmp_path / "ck" / "best_full.pt")])
    assert out["full"]["mae"] == pytest.approx(result["best_full"]["mae"], rel=1e-9)
    return result


def test_train_and_infer_cli_tfn(tmp_path):
    run_cli("tfn", tmp_path)


def test_model_config_baseline_defaults_are_jax_s():
    jc = dataclasses.asdict(JaxModelConfig())
    for key, value in dataclasses.asdict(ModelConfig()).items():
        if key.startswith(("baseline_", "misa_", "mmim_", "mfm_", "mctn_")):
            assert jc[key] == value, key
    assert sum(k.startswith(("misa_", "mmim_", "mfm_", "mctn_")) for k in jc) == 9
