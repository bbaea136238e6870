"""Sequence-parallel WavLM of the port (``parallel.wavlm_forward_sp``,
``attention_impl="ring"``) against the JAX package's single-device forward
on the CPU: ``WavLMConfig.tiny()`` over 2 and 3 real processes (gloo); 3
does not divide the clip's 44 frames, so the last rank's slice ends in
padded, masked frames.

JAX's own ``wavlm_forward_sp`` tests are ``slow`` (a whole-encoder
``shard_map`` compiles for about 2 minutes, tests/test_wavlm_sp.py:7) and
show that it equals that forward; the port is held to the forward itself,
on every hidden-state tap, with a batched pad mask (the second row 9 frames
shorter), for the pre-LN model and a post-LN one, at
``tests/test_torch_wavlm.py``'s tolerance against JAX (rtol = atol = 1e-4:
f32 through the layers in another order), and to the port's own
single-process forward at the JAX SP test's 3e-5 (the same arithmetic but
the blocks' softmax merge). Without a mask, the last hidden state over 2
ranks. Every frame is compared, the padded rows' included.
"""

import concurrent.futures
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.models.wavlm import WavLMConfig as JaxConfig
from sdumc_tpu.models.wavlm import WavLMModel as JaxModel
from sdumc_tpu_torch.convert import wavlm_state_dict_from_flax
from sdumc_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from sdumc_tpu_torch.parallel import ModelAxis, wavlm_forward_sp
from tests.test_torch_multihost import run_ranks

torch.set_num_threads(1)

WORLDS = (2, 3)
SAMPLES = 900
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
SP_TOL = dict(rtol=3e-5, atol=3e-5)
VARIANTS = {"pre_ln": dict(feat_extract_norm="layer", do_stable_layer_norm=True),
            "post_ln": dict(feat_extract_norm="group", do_stable_layer_norm=False)}

_RANK = """
import sys
import torch
torch.set_num_threads(1)
from sdumc_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from sdumc_tpu_torch.parallel import (initialize_from_env, make_model_axis, shutdown,
                                      wavlm_forward_sp)

work = sys.argv[1]
rank, world = initialize_from_env(device="cpu")
axis = make_model_axis("cpu", world)
cases = torch.load(work + "/cases.pt")
out = {}
with torch.inference_mode():
    for name, case in cases["variants"].items():
        model = WavLMModel(WavLMConfig.tiny(**case["cfg"])).eval()
        model.load_state_dict(case["sd"], strict=True)
        got = wavlm_forward_sp(model, cases["wav"], axis, pad_mask=cases["mask"],
                               output_hidden_states=True)
        out[name] = {"hidden": torch.stack(got["hidden_states"]),
                     "last": got["last_hidden_state"],
                     "impl": model.encoder.layers[0].attention.cfg.attention_impl}
        if name == "pre_ln" and world == 2:
            out["no_mask"] = wavlm_forward_sp(model, cases["wav"], axis)["last_hidden_state"]
torch.save(out, work + f"/out{world}_{rank}.pt")
shutdown()
"""


def _jax(variant):
    """(params, wav, mask, JAX's taps, JAX's unmasked last hidden state) of
    the tiny model, einsum attention."""
    cfg = JaxConfig.tiny(attention_impl="einsum", **VARIANTS[variant])
    wav = np.random.default_rng(2).normal(size=(2, SAMPLES)).astype(np.float32)
    t = cfg.output_length(SAMPLES)
    mask = np.arange(t)[None, :] < np.array([t, t - 9])[:, None]
    model = JaxModel(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(wav))["params"]
    out = model.apply({"params": params}, jnp.asarray(wav), pad_mask=jnp.asarray(mask),
                      output_hidden_states=True)
    last = model.apply({"params": params}, jnp.asarray(wav))["last_hidden_state"]
    return (params, wav, mask, np.stack([np.asarray(h) for h in out["hidden_states"]]),
            np.asarray(last))


def _port_single(variant, sd, wav, mask):
    model = WavLMModel(WavLMConfig.tiny(**VARIANTS[variant])).eval()
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        return model(torch.from_numpy(wav), pad_mask=None if mask is None else
                     torch.from_numpy(mask), output_hidden_states=True)


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """JAX's forward, the port's single-process forward and each rank's
    sequence-parallel result, per variant and world."""
    work = tmp_path_factory.mktemp("wavlm_sp")
    jax_out = {name: _jax(name) for name in VARIANTS}
    wav, mask = jax_out["pre_ln"][1], jax_out["pre_ln"][2]
    sds = {name: wavlm_state_dict_from_flax(j[0]) for name, j in jax_out.items()}
    torch.save({"variants": {name: {"cfg": VARIANTS[name], "sd": sds[name]} for name in VARIANTS},
                "wav": torch.from_numpy(wav), "mask": torch.from_numpy(mask)},
               work / "cases.pt")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        groups = [pool.submit(run_ranks, w, [sys.executable, "-c", _RANK, str(work)])
                  for w in WORLDS]
        single = {name: torch.stack(_port_single(name, sds[name], wav, mask)["hidden_states"])
                  .numpy() for name in VARIANTS}
        for g in groups:
            g.result()
    ranks = {w: [torch.load(work / f"out{w}_{r}.pt") for r in range(w)] for w in WORLDS}
    return jax_out, single, ranks


def test_the_clip_does_not_divide_over_three_ranks(sp_runs):
    jax_out, _, _ = sp_runs
    t = jax_out["pre_ln"][2].shape[1]
    assert t == 44 and t % 2 == 0 and t % 3 != 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_sp_forward_matches_jax_single_device_on_every_tap(sp_runs, variant, world):
    jax_out, _, ranks = sp_runs
    want = jax_out[variant][3]
    for rank, out in enumerate(ranks[world]):
        got = out[variant]
        assert got["impl"] != "ring"               # the model is as it was afterwards
        assert got["hidden"].shape == want.shape
        for i in range(len(want)):
            np.testing.assert_allclose(got["hidden"][i].numpy(), want[i], **JAX_TOL,
                                       err_msg=f"rank {rank} tap {i}")
        np.testing.assert_array_equal(got["last"].numpy(), got["hidden"][-1].numpy())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_sp_forward_matches_the_port_single_process(sp_runs, variant, world):
    _, single, ranks = sp_runs
    for rank, out in enumerate(ranks[world]):
        np.testing.assert_allclose(out[variant]["hidden"].numpy(), single[variant], **SP_TOL,
                                   err_msg=f"rank {rank}")


def test_sp_without_a_mask_matches_jax_last_hidden_state(sp_runs):
    jax_out, _, ranks = sp_runs
    for rank, out in enumerate(ranks[2]):
        np.testing.assert_allclose(out["no_mask"].numpy(), jax_out["pre_ln"][4], **JAX_TOL,
                                   err_msg=f"rank {rank}")


def test_ring_without_an_axis_raises():
    model = WavLMModel(WavLMConfig.tiny(attention_impl="ring")).eval()
    with pytest.raises(ValueError, match="ring axis"), torch.inference_mode():
        model(torch.zeros(1, SAMPLES))


def test_one_rank_sp_forward_matches_jax(sp_runs):
    """Over an axis of one rank (one block, no group) the SP forward runs
    attention_impl="ring" in one process: JAX's forward on every tap, and the
    model runs its own attention again afterwards."""
    jax_out, _, _ = sp_runs
    params, wav, mask, want, _ = jax_out["pre_ln"]
    model = WavLMModel(WavLMConfig.tiny(**VARIANTS["pre_ln"])).eval()
    model.load_state_dict(wavlm_state_dict_from_flax(params), strict=True)
    with torch.inference_mode():
        got = wavlm_forward_sp(model, torch.from_numpy(wav), ModelAxis(),
                               pad_mask=torch.from_numpy(mask), output_hidden_states=True)
        again = model(torch.from_numpy(wav), pad_mask=torch.from_numpy(mask),
                      output_hidden_states=True)
    np.testing.assert_allclose(torch.stack(got["hidden_states"]).numpy(), want, **JAX_TOL)
    assert all(a.ring_axis is None for a in (l.attention for l in model.encoder.layers))
    np.testing.assert_allclose(torch.stack(again["hidden_states"]).numpy(), want, **JAX_TOL)
