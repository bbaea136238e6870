"""sdumc_tpu_torch's SDUMCFusion vs the JAX SDUMCFusion, with the JAX
params carried across by ``state_dict_from_flax``, and the reference-key
``.pt`` loader.

Small input dims, short sequences, the published fusion widths. The JAX
model runs both with ``use_pallas="off"`` (einsum) and ``"on"`` (the Pallas
kernels, interpret mode on the CPU). Tolerance rtol 1e-4 / atol 1e-5, as
tests/test_pallas_ops.py's whole-model check: f32 on both sides, summed in
another order through the whole net.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.convert.torch_to_jax import torch_state_dict_to_params
from sdumc_tpu.core.config import ModelConfig as JaxModelConfig
from sdumc_tpu.models.fusion import SDUMCFusion as JaxFusion
from sdumc_tpu_torch.convert import (load_reference_checkpoint, load_reference_state_dict,
                                     state_dict_from_flax)
from sdumc_tpu_torch.core.config import ModelConfig
from sdumc_tpu_torch.models.fusion import SDUMCFusion

DIMS = (32, 64, 32)
RTOL, ATOL = 1e-4, 1e-5
AUX_KEYS = ("features", "rnc", "text_feat", "text_query_feat")


@pytest.fixture(scope="module")
def models():
    """(jax params, port model) with the same weights."""
    rng = np.random.default_rng(0)
    dummy = [jnp.asarray(rng.normal(size=(2, 8, d)), jnp.float32) for d in DIMS]
    init = jax.jit(JaxFusion(JaxModelConfig(input_dims=DIMS)).init)
    params = init(jax.random.PRNGKey(0), *dummy)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = SDUMCFusion(ModelConfig(input_dims=DIMS)).eval()
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    return params, port


def _inputs(seed, lengths=(40, 12, 30, 9), pad=(0, 0, 0, 0)):
    """Numpy audio/text/video/feat4 [B, T, D], each zero-padded by `pad`."""
    rng = np.random.default_rng(seed)
    dims = (DIMS[0], DIMS[1], DIMS[2], DIMS[1])
    return [np.pad(rng.normal(size=(3, n, d)).astype(np.float32), ((0, 0), (0, p), (0, 0)))
            for n, d, p in zip(lengths, dims, pad)]


def _port(port, *args, **kw):
    with torch.inference_mode():
        return port(*args, **kw)


def _check(got, ref):
    (v, aux), (rv, raux) = got, ref
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=RTOL, atol=ATOL)
    for key in AUX_KEYS:
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(raux[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_single_view_matches_jax(models, use_pallas):
    params, port = models
    a, t, v, _ = _inputs(1, pad=(24, 4, 2, 0))
    t_max = (40, 12, 30)
    jm = JaxFusion(JaxModelConfig(input_dims=DIMS, use_pallas=use_pallas))
    ref = jax.jit(jm.apply)({"params": params}, *map(jnp.asarray, (a, t, v)),
                            t_max=tuple(jnp.int32(x) for x in t_max))
    got = _port(port, *map(torch.from_numpy, (a, t, v)), t_max=t_max)
    _check(got, ref)
    assert got[1]["attn"] == (None, None, None)   # the fused kernel keeps no map


@pytest.mark.parametrize("use_pallas", ["off", "on"])
@pytest.mark.parametrize("pad_f4", [0, 7])   # unequal text buckets exercise the re-pad
def test_dual_view_matches_jax(models, use_pallas, pad_f4):
    params, port = models
    a, t, v, f = _inputs(2, pad=(8, 0, 2, pad_f4))
    ta, tt, tv, tf = 40, 12, 30, 9
    jm = JaxFusion(JaxModelConfig(input_dims=DIMS, use_pallas=use_pallas))
    apply = jax.jit(jm.apply, static_argnames=("dual",))
    ref = apply({"params": params}, jnp.asarray(a), (jnp.asarray(t), jnp.asarray(f)),
                jnp.asarray(v), t_max=(jnp.int32(ta), (jnp.int32(tt), jnp.int32(tf)),
                                       jnp.int32(tv)), dual=True)
    got = _port(port, torch.from_numpy(a), (torch.from_numpy(t), torch.from_numpy(f)),
                torch.from_numpy(v), t_max=(ta, (tt, tf), tv), dual=True)
    _check(got, ref)
    # the fused rows equal two single-view forwards of the port
    single0 = _port(port, *map(torch.from_numpy, (a, t, v)), t_max=(ta, tt, tv))
    single1 = _port(port, *map(torch.from_numpy, (a, f, v)), t_max=(ta, tf, tv), missing=True)
    torch.testing.assert_close(got[0][:3], single0[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[0][3:], single1[0], rtol=0, atol=1e-6)


def test_bucketed_padding_matches_unpadded(models):
    """Zero-padding to a bucket plus t_max == the unpadded batch-max input."""
    _, port = models
    a, t, v, _ = _inputs(3)
    ap, tp, vp, _ = _inputs(3, pad=(24, 52, 34, 0))
    ref = _port(port, *map(torch.from_numpy, (a, t, v)))
    got = _port(port, *map(torch.from_numpy, (ap, tp, vp)), t_max=(40, 12, 30))
    torch.testing.assert_close(got[0], ref[0], rtol=RTOL, atol=ATOL)
    for key in AUX_KEYS:
        torch.testing.assert_close(got[1][key], ref[1][key], rtol=RTOL, atol=ATOL)


def test_key_table_inverts_the_jax_converter(models):
    """The port's state_dict goes back through the JAX converter to the same
    params, every reference key finding its Flax home."""
    params, port = models
    template = jax.tree_util.tree_map(np.zeros_like, params)
    back, report = torch_state_dict_to_params(port.state_dict(), template)
    assert report == {"unmapped": [], "missing": []}
    for (path, x), (_, y) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_array_equal(x, y, err_msg=str(path))


def test_reference_checkpoint_roundtrip(tmp_path):
    """A released-style .pt ({'epoch','state_dict','optimizer'}, ``module.``
    prefixes) loads with strict=False semantics, reporting junk and missing
    keys."""
    cfg = ModelConfig(input_dims=DIMS)
    src = SDUMCFusion(cfg, torch.Generator().manual_seed(1))
    dst = SDUMCFusion(cfg, torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    dropped = "module.fc_att.bias"
    del sd[dropped]
    sd["module.junk.weight"] = torch.zeros(3)
    path = tmp_path / "best.pt"
    torch.save({"epoch": 7, "state_dict": sd, "optimizer": {"state": {}, "param_groups": []}}, path)

    report = load_reference_checkpoint(str(path), dst)
    assert report == {"unmapped": ["module.junk.weight"], "missing": ["fc_att.bias"]}
    for k, v in dst.state_dict().items():
        expect = before[k] if k == "fc_att.bias" else src.state_dict()[k]
        torch.testing.assert_close(v, expect, rtol=0, atol=0, msg=k)
    # a shape mismatch is reported, never loaded
    bad = {"fc_att.weight": torch.zeros(5, 5)}
    assert load_reference_state_dict(bad, dst)["unmapped"] == ["fc_att.weight"]


def test_seeded_init_is_reproducible():
    cfg = dataclasses.replace(ModelConfig(), input_dims=DIMS)
    a = SDUMCFusion(cfg, torch.Generator().manual_seed(5)).state_dict()
    b = SDUMCFusion(cfg, torch.Generator().manual_seed(5)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # torch-default Linear bound and the PReLU init
    w = a["frame_dim_reshape_1.weight"]
    assert w.abs().max() <= 1 / np.sqrt(DIMS[1]) and torch.equal(a["prelu.weight"], torch.full((6,), 0.25))
