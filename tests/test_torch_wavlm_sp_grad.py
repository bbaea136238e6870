"""The gradient of the port's sequence-parallel WavLM
(``parallel.wavlm_forward_sp`` under autograd, then
``parallel.reduce_gradients``) against the JAX package on the CPU:
``WavLMConfig.tiny()`` over 2 and 3 real processes (gloo; 3 pads the clip's
44 frames to 45), with ``test_torch_wavlm_sp.py``'s wave and batched pad
mask (the second row 9 frames shorter).

Each rank takes the same loss, a seeded linear functional of every
hidden-state tap, calls ``backward()`` with the wave requiring grad, and sums
the gradients of every parameter and of the wave over the ranks. Then every
rank must hold the same gradients, to the bit. The pre-LN model's are held
to ``jax.grad`` of JAX's single-device ``WavLMModel`` (einsum attention),
carried across by ``wavlm_state_dict_from_flax`` (a transpose of each
kernel: a pure relayout, so it maps gradients as it maps weights), at
``tests/test_torch_wavlm.py``'s rtol = atol = 1e-4; the post-LN model's to
the port's single-process autograd at the JAX SP test's 3e-5. Over 3 ranks
the padded frame's gradient, at the stack's input on the last rank, is
exactly zero.
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
from sdumc_tpu_torch.parallel import (initialize_from_env, make_model_axis, reduce_gradients,
                                      shutdown, wavlm_forward_sp)

work = sys.argv[1]
rank, world = initialize_from_env(device="cpu")
axis = make_model_axis("cpu", world)
cases = torch.load(work + "/cases.pt")
out = {}
for name, case in cases["variants"].items():
    model = WavLMModel(WavLMConfig.tiny(**case["cfg"])).eval()
    model.load_state_dict(case["sd"], strict=True)
    stack_in = []
    hook = model.encoder.layers[0].register_forward_pre_hook(
        lambda m, args: stack_in.append(args[0]) or args[0].retain_grad())
    wav = cases["wav"].clone().requires_grad_()
    got = wavlm_forward_sp(model, wav, axis, pad_mask=cases["mask"], output_hidden_states=True)
    hook.remove()
    (torch.stack(got["hidden_states"]) * cases["w"]).sum().backward()
    reduce_gradients([*model.parameters(), wav], axis)
    out[name] = {"grads": {k: p.grad for k, p in model.named_parameters()}, "wav": wav.grad,
                 "stack_in_grad": stack_in[0].grad}
torch.save(out, work + f"/grads{world}_{rank}.pt")
shutdown()
"""


def _inputs():
    """(wav, mask, w): test_torch_wavlm_sp.py's wave and mask, and the
    loss's seeded weights over the taps [L + 1, B, T, D]."""
    cfg = WavLMConfig.tiny()
    wav = np.random.default_rng(2).normal(size=(2, SAMPLES)).astype(np.float32)
    t = cfg.output_length(SAMPLES)
    mask = np.arange(t)[None, :] < np.array([t, t - 9])[:, None]
    w = np.random.default_rng(3).normal(
        size=(cfg.num_layers + 1, 2, t, cfg.hidden_size)).astype(np.float32)
    return wav, mask, w


def _jax_model(variant, wav):
    """(JAX's tiny model of `variant`, einsum attention; its params)."""
    model = JaxModel(JaxConfig.tiny(attention_impl="einsum", **VARIANTS[variant]))
    return model, model.init(jax.random.PRNGKey(0), jnp.asarray(wav))["params"]


def _jax_grads(model, params, wav, mask, w):
    """({port key: JAX's gradient}, JAX's wave gradient)."""
    def loss(params, wav):
        out = model.apply({"params": params}, wav, pad_mask=jnp.asarray(mask),
                          output_hidden_states=True)
        return jnp.sum(jnp.stack(out["hidden_states"]) * jnp.asarray(w))

    gp, gw = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(wav))
    return wavlm_state_dict_from_flax(gp), np.asarray(gw)


def _port_single(variant, sd, wav, mask, w):
    """The port's single-process autograd: ({name: gradient}, wave gradient)."""
    model = WavLMModel(WavLMConfig.tiny(**VARIANTS[variant])).eval()
    model.load_state_dict(sd, strict=True)
    x = torch.from_numpy(wav).requires_grad_()
    out = model(x, pad_mask=torch.from_numpy(mask), output_hidden_states=True)
    (torch.stack(out["hidden_states"]) * torch.from_numpy(w)).sum().backward()
    return {k: p.grad for k, p in model.named_parameters()}, x.grad


@pytest.fixture(scope="module")
def sp_grads(tmp_path_factory):
    """JAX's pre-LN gradients, the port's single-process post-LN ones, and
    each rank's reduced ones per world and variant."""
    work = tmp_path_factory.mktemp("wavlm_sp_grad")
    wav, mask, w = _inputs()
    models = {name: _jax_model(name, wav) for name in VARIANTS}
    sds = {name: wavlm_state_dict_from_flax(p) for name, (_, p) in models.items()}
    torch.save({"variants": {name: {"cfg": VARIANTS[name], "sd": sds[name]} for name in VARIANTS},
                "wav": torch.from_numpy(wav), "mask": torch.from_numpy(mask),
                "w": torch.from_numpy(w)}, work / "cases.pt")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        groups = [pool.submit(run_ranks, w_, [sys.executable, "-c", _RANK, str(work)])
                  for w_ in WORLDS]
        jax_grads, jax_wav = _jax_grads(*models["pre_ln"], wav, mask, w)
        single = _port_single("post_ln", sds["post_ln"], wav, mask, w)
        for g in groups:
            g.result()
    ranks = {n: [torch.load(work / f"grads{n}_{r}.pt") for r in range(n)] for n in WORLDS}
    return {"jax": (jax_grads, jax_wav), "single": single, "ranks": ranks}


@pytest.mark.parametrize("world", WORLDS)
def test_sp_grads_match_jax_single_device(sp_grads, world):
    """Pre-LN: every parameter's gradient and the wave's."""
    jax_grads, jax_wav = sp_grads["jax"]
    for rank, out in enumerate(sp_grads["ranks"][world]):
        got = out["pre_ln"]
        assert got["grads"].keys() == jax_grads.keys()
        for key, want in jax_grads.items():
            np.testing.assert_allclose(got["grads"][key].numpy(), want.numpy(), **JAX_TOL,
                                       err_msg=f"rank {rank} {key}")
        np.testing.assert_allclose(got["wav"].numpy(), jax_wav, **JAX_TOL,
                                   err_msg=f"rank {rank} wav")


@pytest.mark.parametrize("world", WORLDS)
def test_sp_grads_match_the_port_single_process(sp_grads, world):
    """Post-LN: the port's single-process autograd."""
    grads, wav = sp_grads["single"]
    for rank, out in enumerate(sp_grads["ranks"][world]):
        got = out["post_ln"]
        assert got["grads"].keys() == grads.keys()
        for key, want in grads.items():
            torch.testing.assert_close(got["grads"][key], want, **SP_TOL,
                                       msg=f"rank {rank} {key}")
        torch.testing.assert_close(got["wav"], wav, **SP_TOL, msg=f"rank {rank} wav")


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_holds_the_same_gradients(sp_grads, world):
    ranks = sp_grads["ranks"][world]
    for rank, out in enumerate(ranks[1:], start=1):
        for variant in VARIANTS:
            for key, g in out[variant]["grads"].items():
                assert torch.equal(g, ranks[0][variant]["grads"][key]), (rank, variant, key)
            assert torch.equal(out[variant]["wav"], ranks[0][variant]["wav"]), (rank, variant)


def test_the_padded_frame_has_exactly_zero_gradient(sp_grads):
    """Over 3 ranks the 44 frames pad to 45: the last rank's slice ends in
    a masked frame cut off as a query, whose gradient at the stack's input
    is exactly zero; its real frames' is not."""
    for variant in VARIANTS:
        g = sp_grads["ranks"][3][2][variant]["stack_in_grad"]
        assert g.shape[1] == 15
        assert not g[:, -1].any(), variant
        assert g[:, :-1].abs().amax() > 0, variant
