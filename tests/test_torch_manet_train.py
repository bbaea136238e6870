"""sdumc_tpu_torch's MANet trainer (the two-head loss, SGD with weight decay
and the step schedule, one train step with BatchNorm in training mode, and
``cli.extract manet_train``) against the JAX package on the CPU.

JAX's ``make_train_step`` runs here with jit disabled, in float64, and the
port's step in float64 too. Jitted on XLA:CPU, that step's gradient
through MANet's CBAM blocks disagrees with finite differences, with eager
JAX and with the port (ROADMAP §3), so the jitted step is no reference for
gradients. In float64 every parameter after the step agrees to 1e-7 (JAX
rounds one product in f32: 2**-24 at weights near 1), which also holds the
weight decay (1e-4 · lr · |w|, 5e-6 at the BN scales) to account.

Tolerances: the loss to 1e-9 and the optimizer algebra to 1e-6 relative;
running means to 1e-6 relative (JAX's BN update rounds at f32 grade);
running variances to 1e-6 after JAX's biased batch variance is scaled by
n / (n - 1), n = B·H·W (torch keeps the unbiased one; the factor moves the
stem's statistics by 4e-6 and the spatial gates' by 1e-3).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from sdumc_tpu.convert.torch_manet import torch_manet_to_params
from sdumc_tpu.extract import manet_train as jtrain
from sdumc_tpu.models.manet import MANet as JaxMANet
from sdumc_tpu.models.manet import MANetConfig as JaxMANetConfig
from sdumc_tpu_torch.convert import manet_state_dict_from_flax
from sdumc_tpu_torch.extract import manet_train
from sdumc_tpu_torch.models.manet import MANet, MANetConfig, init_weights

# several test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

SMALL = dict(layers=(1, 1, 1, 1), num_classes=3)


def test_two_head_loss_matches_jax():
    rng = np.random.default_rng(0)
    l1, l2 = (rng.normal(size=(8, 7)).astype(np.float32) for _ in range(2))
    y = rng.integers(0, 7, size=8)
    loss, acc = manet_train.two_head_loss(torch.from_numpy(l1), torch.from_numpy(l2),
                                          torch.from_numpy(y), 0.6)
    jloss, jacc = jtrain.two_head_loss(jnp.asarray(l1), jnp.asarray(l2), jnp.asarray(y), 0.6)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    assert acc.item() == float(jacc)


def test_sgd_with_weight_decay_equals_the_optax_chain():
    """torch SGD(momentum 0.9, weight_decay 1e-4) against optax
    ``chain(add_decayed_weights(1e-4), sgd(lr, momentum=0.9))`` over three
    steps of given gradients; the first step's momentum buffer is the
    decayed gradient."""
    rng = np.random.default_rng(1)
    p0 = {k: rng.normal(size=(4, 3)) for k in "ab"}
    grads = [{k: rng.normal(size=(4, 3)) for k in "ab"} for _ in range(3)]
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, v)
    opt, sched = manet_train.make_optimizer(module, 0.05, steps_per_epoch=1)
    tx = optax.chain(optax.add_decayed_weights(1e-4), optax.sgd(0.05, momentum=0.9))
    with jax.enable_x64(True):
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        state = tx.init(jp)
        for i, g in enumerate(grads):
            for k in params:
                params[k].grad = torch.from_numpy(g[k].copy())
            opt.step()
            sched.step()
            if i == 0:
                for k in params:
                    np.testing.assert_allclose(opt.state[params[k]]["momentum_buffer"].numpy(),
                                               g[k] + 1e-4 * p0[k], rtol=1e-12)
            updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
            jp = optax.apply_updates(jp, updates)
        for k in params:
            np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6)


def test_step_schedule_matches_jax():
    """The per-step LambdaLR gives JAX's step_lr: lr · 0.1 ** (epoch // 15)."""
    model = torch.nn.Linear(2, 2)
    spe = 3
    opt, sched = manet_train.make_optimizer(model, 0.01, spe)
    want = jtrain.step_lr(0.01, spe)
    for step in range(spe * 46):
        assert opt.param_groups[0]["lr"] == pytest.approx(float(want(step)), rel=1e-12), step
        opt.step()
        sched.step()


def _bn_counts(model, x):
    """n = B·H·W seen by each BatchNorm2d in a forward of x."""
    counts, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: counts.__setitem__(
                    name, inp[0].shape[0] * inp[0].shape[2] * inp[0].shape[3])))
    with torch.no_grad():
        model.eval()(x)
    for h in hooks:
        h.remove()
    return counts


def test_train_step_matches_jax_make_train_step():
    """One step in training mode (layers 1,1,1,1; batch 2 at 224x224): the
    loss, every parameter after SGD, and the BN running statistics against
    JAX's make_train_step (float64, jit disabled: see the module
    docstring)."""
    model = init_weights(MANet(MANetConfig(**SMALL)), 0).double()
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(2, 224, 224, 3))
    y = np.array([0, 2])
    with jax.enable_x64(True), jax.disable_jit():
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                           torch_manet_to_params(model.state_dict()))
        create, step = jtrain.make_train_step(JaxMANet(JaxMANetConfig(**SMALL)), 0.6,
                                              jtrain.step_lr(0.05, 100))
        state, metrics = step(create(variables), jnp.asarray(x), jnp.asarray(y))
        want = manet_state_dict_from_flax(jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats}))
        jax_loss = float(metrics["loss"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    counts = _bn_counts(model, torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    opt, sched = manet_train.make_optimizer(model, 0.05, 100)
    out = manet_train.make_train_step(model, opt, sched, 0.6)(torch.from_numpy(x),
                                                              torch.from_numpy(y))
    np.testing.assert_allclose(out["loss"].item(), jax_loss, rtol=1e-9)
    got = model.state_dict()
    assert set(want) == {k for k in got if not k.endswith("num_batches_tracked")}
    for key, w in want.items():
        g = got[key]
        if key.endswith("running_var"):
            n = counts[key.rsplit(".", 1)[0]]
            m = 0.01 if ".spatial.bn." in key else 0.1     # torch momentum
            w = (1 - m) * before[key] + (w - (1 - m) * before[key]) * n / (n - 1)
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-9, err_msg=key)
        elif key.endswith("running_mean"):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-9, err_msg=key)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-7, err_msg=key)


def _image_folder(root, per_class, classes=3, size=100, seed=0):
    rng = np.random.default_rng(seed)
    for split, n in (("train", per_class), ("test", 2)):
        for c in range(classes):
            os.makedirs(root / split / f"class_{c}", exist_ok=True)
            for i in range(n):
                img = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
                Image.fromarray(img).save(root / split / f"class_{c}" / f"img_{i:03d}.bmp")


def test_cli_manet_train_writes_a_checkpoint_that_visual_reads(tmp_path):
    """``cli.extract manet_train --device cpu`` for one epoch on a tiny
    ImageFolder of BMPs: finite losses, a reference-format .pth with BN
    statistics, which ``cli.extract visual`` then reads."""
    from sdumc_tpu_torch.cli import extract

    _image_folder(tmp_path / "data", per_class=2)
    out = extract.main(["manet_train", "--data", str(tmp_path / "data"), "--epochs", "1",
                        "--batch-size", "3", "--checkpoint_path", str(tmp_path / "ck"),
                        "--device", "cpu"])
    assert out["steps"] == 2 and len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert len(out["accs"]) == 1
    if out["checkpoint"] is None:          # no test image right: nothing better than 0 to keep
        assert out["best_acc"] == 0.0
        return
    blob = torch.load(out["checkpoint"], weights_only=True)
    assert set(blob) == {"state_dict", "epoch", "best_acc"} and blob["epoch"] == 0
    assert any(k.endswith("running_var") for k in blob["state_dict"])
    (tmp_path / "faces" / "vid").mkdir(parents=True)
    Image.fromarray(np.zeros((112, 112, 3), np.uint8)).save(tmp_path / "faces" / "vid" / "0.bmp")
    res = extract.main(["visual", "--checkpoint", out["checkpoint"], "--face_dir",
                        str(tmp_path / "faces"), "--save_dir", str(tmp_path / "feat"),
                        "--device", "cpu"])
    feat = np.load(os.path.join(res["save_dir"], "vid.npy"))
    assert feat.shape == (1, 1024) and np.isfinite(feat).all()
