"""The GPipe pipeline of the port (``parallel/pipeline.py``) against the JAX
package's on the CPU.

2 and 4 real processes over gloo (``ModelAxis.exchange``, the last stage's
broadcast), one rank launch per world, against JAX's ``pipeline_apply`` and
``llama_pp_forward`` on ``conftest.py``'s 8-device CPU mesh
(``jax.devices()[:n]``), at ``tests/test_pipeline.py``'s sizes and
tolerances: the tanh-affine layers (L = 8, B = 8, D = 16) for M in 1, 2, 4
and 8 to 1e-5 (f32, the same products in the same order); a LLaMA of 8
layers, B = 8, T = 12, M = 4, the last hidden state and taps to 2e-4,
against JAX's pipeline and its single-device forward. The taps keep JAX's
contract: the last is the last layer's output before the final norm. The
LLaMA's stages are read from a tiny HF-format directory, each stage reading
only its layers' keys (the others stay on the meta device). Bad configs
raise before any collective, so they are checked on a stage axis with no
group; one stage needs no group at all.
"""

import concurrent.futures
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sdumc_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sdumc_tpu.models.llama import LlamaModel as JaxLlamaModel
from sdumc_tpu.parallel.pipeline import llama_pp_forward as jax_llama_pp_forward
from sdumc_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from sdumc_tpu_torch.convert import llama_state_dict_from_flax
from sdumc_tpu_torch.models.llama import LlamaConfig, LlamaModel
from sdumc_tpu_torch.parallel import (ModelAxis, llama_pp_forward, pipeline_apply, stage_layers,
                                      stage_model_from_state_dict)
from tests.test_torch_multihost import run_ranks

torch.set_num_threads(1)

WORLDS = (2, 4)
MICROBATCHES = (1, 2, 4, 8)
L, B, D = 8, 8, 16                       # the affine layers
LB, LT, LM, TAPS = 8, 12, 4, 2           # the LLaMA: batch, tokens, microbatches, taps
AFFINE_TOL = dict(rtol=1e-5, atol=1e-5)
LLAMA_TOL = dict(rtol=2e-4, atol=2e-4)

_RANK = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from sdumc_tpu_torch.convert.hf_llama import load_hf_llama_trunk
from sdumc_tpu_torch.parallel import (initialize_from_env, llama_pp_forward, make_model_axis,
                                      pipeline_apply, shutdown, stage_layers)

work = sys.argv[1]
rank, world = initialize_from_env(device="cpu")
axis = make_model_axis("cpu", world)
case = np.load(work + "/case.npz")
w, b, x = (torch.from_numpy(case[k]) for k in ("w", "b", "x"))
mine = [(w[i], b[i]) for i in stage_layers(w.shape[0], axis)]
out = {}
with torch.inference_mode():
    for m in case["microbatches"]:
        out[f"affine{m}"] = pipeline_apply(axis, lambda lp, h, e: torch.tanh(h @ lp[0] + lp[1]),
                                           mine, x, n_microbatches=int(m)).numpy()
    _, model = load_hf_llama_trunk(work + "/hf", dtype=torch.float32, stage=axis)
    last, taps = llama_pp_forward(model, axis, input_ids=torch.from_numpy(case["ids"]),
                                  n_microbatches=int(case["lm"]), collect_taps=int(case["taps"]))
out["last"], out["taps"] = last.numpy(), taps.numpy()
out["held"] = np.array([not model.layers[i].mlp.up_proj.weight.is_meta
                        for i in range(len(model.layers))])
np.savez(work + f"/out{world}_{rank}.npz", **out)
shutdown()
"""


def _affine_case():
    rng = np.random.default_rng(0)
    return {"w": (rng.normal(size=(L, D, D)) * 0.3).astype(np.float32),
            "b": rng.normal(size=(L, D)).astype(np.float32),
            "x": rng.normal(size=(B, D)).astype(np.float32)}


def _jax_llama():
    cfg = JaxLlamaConfig.tiny(num_layers=8, scan_layers=True)
    model = JaxLlamaModel(cfg)
    ids = jnp.asarray(np.random.default_rng(1).integers(0, cfg.vocab_size, (LB, LT)))
    params = model.init(jax.random.PRNGKey(0), input_ids=ids)["params"]
    return cfg, model, ids, params


def _trunk_state_dict(params):
    """The JAX trunk's stacked params as the port's HF-named trunk keys."""
    sd = llama_state_dict_from_flax({"model": jax.tree_util.tree_map(np.asarray, params)})
    return {k[len("model."):]: v for k, v in sd.items()}


def _write_hf_dir(path, cfg, sd):
    """A tiny HF-format LLaMA directory: config.json and pytorch_model.bin
    with the trunk's ``model.*`` keys."""
    path.mkdir()
    (path / "config.json").write_text(json.dumps({
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "rms_norm_eps": cfg.rms_eps,
        "rope_theta": cfg.rope_theta, "max_position_embeddings": cfg.max_position_embeddings}))
    torch.save({"model." + k: v for k, v in sd.items()}, path / "pytorch_model.bin")


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: each rank's outputs} of the port's pipeline over gloo, and
    JAX's results on that many CPU devices, and its single-device forward."""
    work = tmp_path_factory.mktemp("pipeline")
    case = _affine_case()
    jcfg, jmodel, ids, params = _jax_llama()
    _write_hf_dir(work / "hf", jcfg, _trunk_state_dict(params))
    np.savez(work / "case.npz", microbatches=np.array(MICROBATCHES), ids=np.asarray(ids),
             lm=LM, taps=TAPS, **case)
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        groups = [pool.submit(run_ranks, w, [sys.executable, "-c", _RANK, str(work)])
                  for w in WORLDS]
        jax_out = {}
        for w in WORLDS:
            mesh = Mesh(np.array(jax.devices()[:w]), ("stage",))
            got = {f"affine{m}": np.asarray(jax_pipeline_apply(
                mesh, lambda lp, h, e: jnp.tanh(h @ lp["w"] + lp["b"]),
                {"w": jnp.asarray(case["w"]), "b": jnp.asarray(case["b"])},
                jnp.asarray(case["x"]), n_microbatches=m)) for m in MICROBATCHES}
            last, taps = jax_llama_pp_forward(jmodel, params, mesh, input_ids=ids,
                                              n_microbatches=LM, collect_taps=TAPS)
            got["last"], got["taps"] = np.asarray(last), np.asarray(taps)
            jax_out[w] = got
        single = jmodel.apply({"params": params}, input_ids=ids, output_hidden_states=True)
        for g in groups:
            g.result()
    port = {w: [dict(np.load(work / f"out{w}_{r}.npz")) for r in range(w)] for w in WORLDS}
    return case, port, jax_out, single


def _sequential(case):
    y = torch.from_numpy(case["x"])
    for w, b in zip(case["w"], case["b"]):
        y = torch.tanh(y @ torch.from_numpy(w) + torch.from_numpy(b))
    return y.numpy()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("m", MICROBATCHES)
def test_pipeline_apply_matches_jax_and_sequential(runs, world, m):
    case, port, jax_out, _ = runs
    for rank, got in enumerate(port[world]):
        np.testing.assert_allclose(got[f"affine{m}"], jax_out[world][f"affine{m}"],
                                   err_msg=f"rank {rank}", **AFFINE_TOL)
        np.testing.assert_allclose(got[f"affine{m}"], _sequential(case), err_msg=f"rank {rank}",
                                   **AFFINE_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_llama_pp_forward_matches_jax_pipeline_and_single_device(runs, world):
    _, port, jax_out, single = runs
    for rank, got in enumerate(port[world]):
        np.testing.assert_allclose(got["last"], jax_out[world]["last"], err_msg=f"rank {rank}",
                                   **LLAMA_TOL)
        np.testing.assert_allclose(got["taps"], jax_out[world]["taps"], err_msg=f"rank {rank}",
                                   **LLAMA_TOL)
        np.testing.assert_allclose(got["last"], np.asarray(single["last_hidden_state"]),
                                   err_msg=f"rank {rank}", **LLAMA_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_taps_are_pre_norm_layer_outputs(runs, world):
    """taps[k] is layer L - K + k's output before the final norm: the
    hidden state L - K + k + 1 for all but the last, which differs from the
    post-norm hidden_states[-1]."""
    _, port, _, single = runs
    hs = single["hidden_states"]
    for got in port[world]:
        assert got["taps"].shape == (TAPS, LB, LT, 64)
        np.testing.assert_allclose(got["taps"][0], np.asarray(hs[L - 1]), **LLAMA_TOL)
        assert not np.allclose(got["taps"][1], np.asarray(hs[L]))


@pytest.mark.parametrize("world", WORLDS)
def test_each_stage_holds_only_its_layers(runs, world):
    """The stage loader read its layers' keys alone: the others are meta."""
    _, port, _, _ = runs
    for rank, got in enumerate(port[world]):
        want = np.isin(np.arange(L), list(stage_layers(L, ModelAxis(rank, world))))
        np.testing.assert_array_equal(got["held"], want)


def test_llama_pp_bad_configs_raise():
    """L % S, B % M and K > L / S raise (JAX asserts), before any
    collective: a stage axis of 4 with no group."""
    _, _, ids, params = _jax_llama()
    sd = _trunk_state_dict(params)
    axis = ModelAxis(0, 4)
    ids = torch.from_numpy(np.array(ids))
    model6 = LlamaModel(LlamaConfig.tiny(num_layers=6))
    with pytest.raises(ValueError, match="do not divide over 4 stages"):
        llama_pp_forward(model6, axis, input_ids=ids[:4], n_microbatches=2)
    model = stage_model_from_state_dict(LlamaConfig.tiny(num_layers=8), sd, axis)
    with pytest.raises(ValueError, match="microbatches"):
        llama_pp_forward(model, axis, input_ids=ids[:6], n_microbatches=4)
    with pytest.raises(ValueError, match="collect_taps 3"):
        llama_pp_forward(model, axis, input_ids=ids, n_microbatches=4, collect_taps=3)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(axis, None, [], torch.zeros(6, 2), n_microbatches=4)


def test_one_stage_needs_no_group():
    """One stage: the pipeline is the sequential forward, with no process
    group, and llama_pp_forward equals the model's own forward."""
    case = _affine_case()
    x = torch.from_numpy(case["x"])
    layers = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in zip(case["w"], case["b"])]
    got = pipeline_apply(ModelAxis(), lambda lp, h, e: torch.tanh(h @ lp[0] + lp[1]), layers, x,
                         n_microbatches=4)
    np.testing.assert_allclose(_np(got), _sequential(case), **AFFINE_TOL)
    _, _, ids, params = _jax_llama()
    model = LlamaModel(LlamaConfig.tiny(num_layers=8)).eval()
    model.load_state_dict(_trunk_state_dict(params), strict=True)
    ids = torch.from_numpy(np.array(ids))
    with torch.inference_mode():
        last, taps = llama_pp_forward(model, ModelAxis(), input_ids=ids, n_microbatches=4,
                                      collect_taps=8)
        ref = model(input_ids=ids, output_hidden_states=True)
    np.testing.assert_allclose(_np(last), _np(ref["last_hidden_state"]), **LLAMA_TOL)
    for k in range(7):
        np.testing.assert_allclose(_np(taps[k]), _np(ref["hidden_states"][k + 1]), **LLAMA_TOL)
