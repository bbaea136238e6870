"""The rest of the port's loss zoo, its tuner and its model-name registry
against the JAX package, on the CPU.

Losses: values to rtol 1e-5 and the gradient of every input to rtol 1e-5
plus an atol of 1e-6 of its largest value (f32 on both sides in another
summation order). The tuner's
draws and the registry's tables are equal, not close.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu import losses as jax_losses
from sdumc_tpu.core import model_registry as jax_registry
from sdumc_tpu.core import tuner as jax_tuner
from sdumc_tpu.core.config import ModelConfig as JaxModelConfig
from sdumc_tpu_torch import losses
from sdumc_tpu_torch.core import model_registry, tuner
from sdumc_tpu_torch.core.config import ModelConfig

torch.set_num_threads(1)


def _check(jax_fn, torch_fn, arrays, consts=()):
    """Value and the gradient of each of `arrays` (consts enter as they are)."""
    jv, jg = jax.value_and_grad(
        lambda *a: jax_fn(*a, *map(jnp.asarray, consts)), argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tv = torch_fn(*ts, *map(torch.from_numpy, consts))
    tg = torch.autograd.grad(tv, ts)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    for g, r in zip(tg, jg):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-6 * np.abs(r).max())


def _rng(seed):
    rng = np.random.default_rng(seed)
    return lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731


def test_ce_loss_matches_jax():
    f = _rng(0)
    target = np.array([0, 2, 1, 2, 0], np.int32)
    _check(jax_losses.ce_loss, losses.ce_loss, (f(5, 3),), (target,))


def test_kl_and_mi_losses_match_jax():
    f = _rng(1)
    _check(jax_losses.kl_loss, losses.kl_loss, (f(6, 4), f(6, 4)))
    _check(lambda a, b, c: jax_losses.mi_loss([a, b, c]),
           lambda a, b, c: losses.mi_loss([a, b, c]), (f(6, 4), f(6, 4), f(6, 4)))


@pytest.mark.parametrize("ndim", [2, 3])
def test_cosine_losses_match_jax(ndim):
    f = _rng(2)
    shape = (6, 5) if ndim == 2 else (6, 3, 5)
    if ndim == 2:
        _check(jax_losses.cosine_similarity_loss, losses.cosine_similarity_loss,
               (f(*shape), f(*shape)))
    _check(jax_losses.cosine_similarity_loss_seq, losses.cosine_similarity_loss_seq,
           (f(*shape), f(*shape)))


def test_mosei_emo_loss_matches_jax():
    f = _rng(3)
    target = np.abs(f(7, 6))
    vals = np.random.default_rng(3).uniform(-3, 3, size=7).astype(np.float32)
    _check(jax_losses.mosei_emo_loss, losses.mosei_emo_loss, (f(7, 7),), (target, vals))


@pytest.mark.parametrize("mode", ["all", "one"])
@pytest.mark.parametrize("positives", ["labels", "mask", "views"])
def test_supcon_loss_matches_jax(mode, positives):
    """Both contrast modes, positives from labels, a mask or each sample's
    own views; the row max is held out of the gradient on both sides."""
    f = _rng(4)
    feats = f(8, 3, 2, 3)                                  # [bsz, views, 2, 3] -> flattened
    labels = np.array([0, 1, 0, 2, 1, 1, 3, 0], np.int32)
    mask = (np.random.default_rng(4).uniform(size=(8, 8)) < 0.3).astype(np.float32)
    kw = dict(contrast_mode=mode, temperature=0.5)
    if positives == "labels":
        _check(lambda x, y: jax_losses.supcon_loss(x, labels=y, **kw),
               lambda x, y: losses.supcon_loss(x, labels=y, **kw), (feats,), (labels,))
    elif positives == "mask":
        _check(lambda x, m: jax_losses.supcon_loss(x, mask=m, **kw),
               lambda x, m: losses.supcon_loss(x, mask=m, **kw), (feats,), (mask,))
    else:
        _check(lambda x: jax_losses.supcon_loss(x, **kw),
               lambda x: losses.supcon_loss(x, **kw), (feats,))


def test_supcon_loss_refuses_labels_and_mask():
    x = torch.zeros(4, 2, 3)
    with pytest.raises(ValueError, match="both"):
        losses.supcon_loss(x, labels=torch.zeros(4), mask=torch.eye(4))


# ------------------------------------------------------------------ tuner

def test_tune_grids_are_jax_s():
    assert tuner.TUNE_GRIDS == jax_tuner.TUNE_GRIDS
    assert tuner.load_grids() is tuner.TUNE_GRIDS


@pytest.mark.parametrize("seed", [0, 1, 7, None])
def test_random_draws_equal_jax_s(seed):
    """Both draw with Python's random.Random(seed); None draws anew."""
    for name, grid in tuner.TUNE_GRIDS.items():
        draw = tuner.random_select(grid, seed)
        assert draw.keys() == grid.keys() and all(draw[k] in grid[k] for k in grid)
        if seed is not None:
            assert draw == jax_tuner.random_select(grid, seed), name


@pytest.mark.parametrize("name", ["lmf", "mult", "mctn", "nope"])
def test_merge_args_config_overlays_the_same_draw(name):
    """On the ModelConfig dataclass: the same draw and the same fields set
    (the rest of a draw, lr for one, is not a ModelConfig field); an
    unknown model is left as it is."""
    got, draw = tuner.merge_args_config(ModelConfig(name=name), name, seed=3)
    ref, jdraw = jax_tuner.merge_args_config(JaxModelConfig(name=name), name, seed=3)
    assert draw == jdraw
    for key in dataclasses.asdict(got):
        if key in dataclasses.asdict(ref) and key != "dtype":
            assert getattr(got, key) == getattr(ref, key), key
    if name == "nope":
        assert draw == {} and got == ModelConfig(name=name)


def test_load_grids_reads_yaml_lazily(tmp_path):
    """A yaml file replaces the grids where pyyaml imports, as in JAX."""
    pytest.importorskip("yaml")
    path = tmp_path / "grids.yaml"
    path.write_text("tfn:\n  lr: [0.1, 0.2]\n")
    assert tuner.load_grids(str(path)) == jax_tuner.load_grids(str(path)) == {
        "tfn": {"lr": [0.1, 0.2]}}


# --------------------------------------------------------------- registry

def test_registry_tables_are_jax_s():
    for name in ("AUDIO_ENCODERS", "TEXT_ENCODERS", "VISUAL_ENCODERS", "MOSEI_EMOTIONS",
                 "EMO2IDX", "IDX2EMO", "DISPLAY_NAMES", "QUALITY_RANKING", "AUDIO_WAVLM_LARGE",
                 "TEXT_VICUNA_GT", "VIDEO_MANET", "FEAT4_VICUNA_GEN"):
        assert getattr(model_registry, name) == getattr(jax_registry, name), name


@pytest.mark.parametrize("feature", [
    "wavlm-large-FRA_-5", "vicuna-7b-v1.5-FRA-wavlm2vicuna-half-gt", "manet_FRA",
    "clip-vit-large-patch14-UTT", "llama-2-13b-FRA", "my-manet-variant", "hubert-base-x",
    "resnet50-imagenet", "bloom-7b-FRA_-4", "some-llama-tune"])
def test_feature_dim_agrees_with_jax(feature):
    assert model_registry.feature_dim(feature) == jax_registry.feature_dim(feature)


def test_feature_dim_unknown_raises_as_jax():
    for fn in (model_registry.feature_dim, jax_registry.feature_dim):
        with pytest.raises(KeyError):
            fn("no-such-encoder")
