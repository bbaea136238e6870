"""Tensor parallelism of the port (``parallel/sharding.py``, the
tensor-parallel LLaMA and WavLM modules, ``cli.extract text|feat4 --tp N``)
against the JAX package's replicated models on the CPU: 2 and 4 real
processes over gloo, at ``tests/test_tp.py``'s sizes and tolerances.

The same seeded weights on both sides: JAX's params, carried into the
port's state dict by ``convert.from_flax``, which each rank cuts with
``shard_state_dict``. Tolerances are ``tests/test_tp.py``'s: the forwards
rtol/atol 2e-5 (f32, the partial sums of each split product added in
another order), the beam decode's tokens and step counts equal and its
taps 2e-4. The split map and ``tp_sharding_summary`` equal JAX's
wherever the heads divide; where they do not, the port keeps the whole
attention block replicated and JAX splits mid-head (ROADMAP §3), and the
forward still equals the replicated one.

The CLI runs at bf16 (as the LLaMA loaders load) on tiny seeded
directories; ``--tp 2`` is held to ``--tp 1``'s files: the text taps to 4
bf16 ulps of the largest tap (tests/test_torch_text.py's bf16 rule), each
feat4 clip's first row, which comes before any beam choice, to 1e-2
(BF16_TOL, chip_smoke.py's feat4 bf16 tolerance); later rows may follow
another beam where bf16 sums in another order break an exact tie, as
chip_smoke.py phase 29 prints and does not hold.
"""

import concurrent.futures
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sdumc_tpu.models import generation as jg
from sdumc_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sdumc_tpu.models.llama import LlamaForCausalLM as JaxLlama
from sdumc_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from sdumc_tpu.models.wavlm import WavLMModel as JaxWavLM
from sdumc_tpu.parallel import make_mesh
from sdumc_tpu.parallel import sharding as jsharding
from sdumc_tpu_torch.convert import llama_state_dict_from_flax, wavlm_state_dict_from_flax
from sdumc_tpu_torch.convert.from_flax import wavlm_key_for
from sdumc_tpu_torch.models.llama import LlamaConfig
from sdumc_tpu_torch.models.wavlm import WavLMConfig
from sdumc_tpu_torch.parallel import (LLAMA_RULES, ModelAxis, llama_specs, partition_specs,
                                      shard_llama_model, shard_state_dict, shard_wavlm_model,
                                      tp_sharding_summary, wavlm_specs)
from tests.test_torch_multihost import run_ranks

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
BEAM_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
WORLDS = (2, 4)
BEAM = dict(num_beams=4, max_new_tokens=12, eos_id=2)
BEAM_CFG = dict(num_heads=4, hidden_size=64)

# each case's config beyond LlamaConfig.tiny; "heads6": 6 heads do not divide by 4
LLAMA_CASES = {"mha": dict(num_heads=4, hidden_size=64, intermediate_size=128),
               "gqa": dict(num_heads=4, num_kv_heads=2, hidden_size=64, intermediate_size=128),
               "heads6": dict(num_heads=6, hidden_size=48, intermediate_size=96, vocab_size=96)}

# one rank of the forward cases: every case's model cut for this rank, its outputs saved by
# rank 0 (every rank's outputs are the same all_reduce results)
_RANK = """
import sys
import torch
torch.set_num_threads(1)
from sdumc_tpu_torch.models.generation import beam_generate
from sdumc_tpu_torch.models.llama import LlamaConfig
from sdumc_tpu_torch.models.wavlm import WavLMConfig
from sdumc_tpu_torch.parallel import (initialize_from_env, make_model_axis, shard_llama_model,
                                      shard_wavlm_model, shutdown)
from sdumc_tpu_torch.parallel.layers import RowParallelLinear

work = sys.argv[1]
rank, world = initialize_from_env(device="cpu")
axis = make_model_axis("cpu", world)
cases = torch.load(work + "/cases.pt", weights_only=False)
out = {}
with torch.inference_mode():
    for name, case in cases["llama"].items():
        model = shard_llama_model(case["sd"], LlamaConfig.tiny(**case["cfg"]), axis)
        got = model(input_ids=case["ids"], output_hidden_states=True)
        out[name] = {"logits": got["logits"], "hidden": got["hidden_states"][-3]}
    beam = cases["beam"]
    model = shard_llama_model(beam["sd"], LlamaConfig.tiny(**beam["cfg"]), axis)
    got = beam_generate(model, beam["prompt"], model.cfg, embed_fn=model.model.embed_tokens,
                        **beam["kw"])
    out["beam"] = {k: got[k] for k in ("tokens", "n_steps", "taps")}
    out["beam_kv_heads"] = model.cfg.kv_heads
    for impl in ("einsum", "flash"):
        wavlm = cases["wavlm"]
        model = shard_wavlm_model(wavlm["sd"], WavLMConfig.tiny(attention_impl=impl), axis)
        got = model(wavlm["wav"], output_hidden_states=True)
        out["wavlm_" + impl] = {"hidden": got["hidden_states"][-2],
                                "last": got["last_hidden_state"]}
    row = cases["row"]
    n = row["w"].shape[1] // world
    layer = RowParallelLinear(n, row["w"].shape[0], axis, dtype=torch.bfloat16)
    layer.weight.copy_(row["w"][:, rank * n:(rank + 1) * n])
    out["row"] = layer(row["x"][:, rank * n:(rank + 1) * n])
if rank == 0:
    torch.save(out, work + f"/out{world}.pt")
shutdown()
"""


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _jax_llama(cfg_kw, seed=0, ids_shape=(2, 12)):
    cfg = JaxLlamaConfig.tiny(**cfg_kw)
    model = JaxLlama(cfg)
    ids = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab_size, ids_shape))
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), input_ids=ids)["params"]
    return cfg, model, ids, params


def _jax_beam():
    """tests/test_tp.py::test_tp_beam_generate_matches_replicated's setup:
    (prompt, params, a function that runs JAX's replicated decode)."""
    cfg = JaxLlamaConfig.tiny(**BEAM_CFG)
    model = JaxLlama(cfg)
    rng = np.random.default_rng(0)
    prompt = (rng.normal(size=(1, 6, cfg.hidden_size)) * 0.5).astype(np.float32)
    params = model.init(jax.random.PRNGKey(3), input_ids=jnp.zeros((1, 4), jnp.int32))["params"]

    def gen(p, pe):
        return jg.beam_generate(lambda **kw: model.apply({"params": p}, **kw), pe, cfg,
                                embed_fn=lambda ids: p["model"]["embed_tokens"]["embedding"][ids],
                                **BEAM)

    return prompt, params, lambda: jax.jit(gen)(params, jnp.asarray(prompt))


def _jax_wavlm():
    """(wav, params, a function that runs JAX's replicated forward)."""
    model = JaxWavLM(JaxWavLMConfig.tiny())
    wav = np.random.default_rng(1).normal(size=(2, 800)).astype(np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(wav))["params"]
    return wav, params, lambda: model.apply({"params": params}, jnp.asarray(wav),
                                            output_hidden_states=True)


def _row_case():
    """A bf16 input [8, 256] and weight [64, 256] for a row-split Linear."""
    rng = np.random.default_rng(7)
    return {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
            for k, shape in (("x", (8, 256)), ("w", (64, 256)))}


@pytest.fixture(scope="module")
def jax_cases():
    """Each case's JAX model, inputs and params, initialised once."""
    return {"llama": {name: _jax_llama(kw) for name, kw in LLAMA_CASES.items()},
            "beam": _jax_beam(), "wavlm": _jax_wavlm()}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory, jax_cases):
    """JAX's replicated outputs (computed here while the ranks run) and the
    2- and 4-rank groups' outputs of the same cases."""
    work = tmp_path_factory.mktemp("tp")
    llama, refs = {}, {}
    for name, (_, model, ids, params) in jax_cases["llama"].items():
        llama[name] = {"cfg": LLAMA_CASES[name], "ids": torch.from_numpy(np.array(ids)),
                       "sd": llama_state_dict_from_flax(params)}
        refs[name] = lambda model=model, params=params, ids=ids: model.apply(
            {"params": params}, input_ids=ids, output_hidden_states=True)
    prompt, beam_params, beam_ref = jax_cases["beam"]
    wav, wavlm_params, wavlm_ref = jax_cases["wavlm"]
    torch.save({"llama": llama,
                "beam": {"cfg": BEAM_CFG, "sd": llama_state_dict_from_flax(beam_params),
                         "prompt": torch.from_numpy(prompt), "kw": BEAM},
                "wavlm": {"sd": wavlm_state_dict_from_flax(wavlm_params),
                          "wav": torch.from_numpy(wav)},
                "row": _row_case()}, work / "cases.pt")

    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        groups = [pool.submit(run_ranks, w, [sys.executable, "-c", _RANK, str(work)])
                  for w in WORLDS]
        want = {}
        for name, ref in refs.items():
            out = ref()
            want[name] = {"logits": np.asarray(out["logits"]),
                          "hidden": np.asarray(out["hidden_states"][-3])}
        out = beam_ref()
        want["beam"] = {k: np.asarray(out[k]) for k in ("tokens", "n_steps", "taps")}
        out = wavlm_ref()
        want["wavlm"] = {"hidden": np.asarray(out["hidden_states"][-2]),
                         "last": np.asarray(out["last_hidden_state"])}
        for g in groups:
            g.result()
    return want, {w: torch.load(work / f"out{w}.pt", weights_only=False) for w in WORLDS}


# ------------------------------------------------------------------ the split map

def _jax_flat_specs(params, specs):
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(k.key for k in path): spec for path, spec in flat}


def _port_dim(path, spec, ndim):
    """JAX's PartitionSpec of a flax leaf as the port's split dim: flax's
    2-D Dense kernel is [in, out], torch's weight [out, in]."""
    dims = [i for i, name in enumerate(spec) if name is not None]
    if not dims:
        return None
    (dim,) = dims
    return 1 - dim if ndim == 2 and path[-1] == "kernel" else dim


def _llama_key(path):
    sd = llama_state_dict_from_flax(_nest(path, np.zeros((1, 1), np.float32)))
    return next(iter(sd))


def _nest(path, leaf):
    tree = leaf
    for k in reversed(path):
        tree = {k: tree}
    return tree


@pytest.mark.parametrize("case,tp", [("mha", 2), ("mha", 4), ("gqa", 2)])
def test_llama_split_map_and_summary_equal_jax(jax_cases, case, tp):
    """Wherever the heads divide (2 kv heads over 4 ranks do not: see
    test_whole_heads_where_jax_splits_mid_head)."""
    params = jax_cases["llama"][case][3]
    mesh = make_mesh(data_parallel=8 // tp, model_parallel=tp)
    jspecs = jsharding.llama_specs(params, mesh)
    flat = _jax_flat_specs(params, jspecs)
    sd = llama_state_dict_from_flax(params)
    specs = llama_specs(sd, LlamaConfig.tiny(**LLAMA_CASES[case]), tp)
    leaves = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    want = {}
    for path, spec in flat.items():
        leaf = np.asarray(leaves[tuple(jax.tree_util.DictKey(k) for k in path)])
        want[_llama_key(path)] = _port_dim(path, spec, leaf.ndim)
    assert specs == want
    assert tp_sharding_summary(sd, specs) == jsharding.tp_sharding_summary(params, jspecs)


@pytest.mark.parametrize("tp", WORLDS)
def test_wavlm_split_map_and_summary_equal_jax(jax_cases, tp):
    params = jax_cases["wavlm"][1]
    mesh = make_mesh(data_parallel=8 // tp, model_parallel=tp)
    jspecs = jsharding.wavlm_specs(params, mesh)
    sd = wavlm_state_dict_from_flax(params)
    specs = wavlm_specs(sd, WavLMConfig.tiny(), tp)
    leaves = dict((tuple(k.key for k in p), np.asarray(v))
                  for p, v in jax.tree_util.tree_flatten_with_path(params)[0])
    want = {wavlm_key_for(path): _port_dim(path, spec, leaves[path].ndim)
            for path, spec in _jax_flat_specs(params, jspecs).items()}
    assert specs == want
    assert sum(d is not None for d in specs.values()) == 2 * 11 + 1  # 11 a layer, rel_attn_embed
    assert tp_sharding_summary(sd, specs) == jsharding.tp_sharding_summary(params, jspecs)


def test_indivisible_dims_fall_back_to_replicated():
    """tests/test_tp.py's case: q_proj [in 3, out 5] at a model axis of 2."""
    mesh = make_mesh(data_parallel=4, model_parallel=2)
    odd = {"q_proj": {"kernel": np.zeros((3, 5), np.float32)}}
    assert jsharding.partition_specs(odd, jsharding.LLAMA_RULES, mesh)["q_proj"]["kernel"] == P()
    assert partition_specs({"q_proj.weight": (5, 3)}, LLAMA_RULES, 2) == {"q_proj.weight": None}
    assert partition_specs({"q_proj.weight": (6, 3)}, LLAMA_RULES, 2) == {"q_proj.weight": 0}


def test_whole_heads_where_jax_splits_mid_head(jax_cases):
    """6 heads over 4 ranks: JAX splits q/k/v/o's 48 columns into 12 (1.5
    heads), the port keeps attention whole and splits the rest; 2 kv heads
    over 4 ranks: the port keeps K and V whole."""
    cfg = LlamaConfig.tiny(**LLAMA_CASES["heads6"])
    params = jax_cases["llama"]["heads6"][3]
    sd = llama_state_dict_from_flax(params)
    specs = llama_specs(sd, cfg, 4)
    layer = "model.layers.0."
    assert all(specs[layer + f"self_attn.{p}_proj.weight"] is None for p in "qkvo")
    assert specs[layer + "mlp.gate_proj.weight"] == 0 and specs[layer + "mlp.down_proj.weight"] == 1
    assert specs["model.embed_tokens.weight"] == 1 and specs["lm_head.weight"] == 0
    jspecs = _jax_flat_specs(params, jsharding.llama_specs(params, make_mesh(2, 4)))
    assert jspecs[("model", "layers_0", "self_attn", "q_proj", "kernel")] == P(None, "model")

    gqa = LlamaConfig.tiny(**LLAMA_CASES["gqa"])
    specs = llama_specs(llama_state_dict_from_flax(jax_cases["llama"]["gqa"][3]), gqa, 4)
    assert specs[layer + "self_attn.q_proj.weight"] == 0
    assert specs[layer + "self_attn.k_proj.weight"] is None
    assert specs[layer + "self_attn.v_proj.weight"] is None


def test_shard_state_dict_cuts_each_rank_its_slice():
    sd = {"a.q_proj.weight": torch.arange(24.0).view(6, 4), "norm.weight": torch.ones(4)}
    specs = {"a.q_proj.weight": 0, "norm.weight": None}
    parts = [shard_state_dict(sd, specs, r, 2) for r in range(2)]
    assert torch.equal(torch.cat([p["a.q_proj.weight"] for p in parts]), sd["a.q_proj.weight"])
    assert all(p["norm.weight"] is sd["norm.weight"] for p in parts)


def test_one_rank_model_is_the_single_process_model(jax_cases):
    """A model axis of 1 cuts nothing and builds today's modules, whose
    forward is the plain model's to the bit."""
    from sdumc_tpu_torch.models.llama import LlamaAttention, LlamaMLP, model_from_state_dict
    from sdumc_tpu_torch.models.wavlm import FeedForward, WavLMAttention

    _, _, ids, params = jax_cases["llama"]["gqa"]
    sd, cfg = llama_state_dict_from_flax(params), LlamaConfig.tiny(**LLAMA_CASES["gqa"])
    model = shard_llama_model(sd, cfg, ModelAxis())
    layer = model.model.layers[0]
    assert type(layer.self_attn) is LlamaAttention and type(layer.mlp) is LlamaMLP
    assert model.cfg == cfg
    ids = torch.from_numpy(np.array(ids))
    with torch.no_grad():
        assert torch.equal(model(input_ids=ids)["logits"],
                           model_from_state_dict(cfg, sd)(input_ids=ids)["logits"])
    wparams = jax_cases["wavlm"][1]
    wavlm = shard_wavlm_model(wavlm_state_dict_from_flax(wparams), WavLMConfig.tiny(), ModelAxis())
    layer = wavlm.encoder.layers[0]
    assert type(layer.attention) is WavLMAttention and type(layer.feed_forward) is FeedForward


# ------------------------------------------------------------------ the forwards

@pytest.mark.parametrize("tp", WORLDS)
@pytest.mark.parametrize("case", list(LLAMA_CASES))
def test_llama_tp_matches_jax_replicated(tp_runs, case, tp):
    want, got = tp_runs
    for key in ("logits", "hidden"):
        np.testing.assert_allclose(_np(got[tp][case][key]), want[case][key], **TOL)


@pytest.mark.parametrize("tp", WORLDS)
def test_tp_beam_generate_matches_jax_replicated(tp_runs, tp):
    want, got = tp_runs
    beam = got[tp]["beam"]
    np.testing.assert_array_equal(_np(beam["tokens"]).astype(np.int64), want["beam"]["tokens"])
    n = int(want["beam"]["n_steps"])
    assert int(beam["n_steps"]) == n
    np.testing.assert_allclose(_np(beam["taps"])[:n], want["beam"]["taps"][:n], **BEAM_TOL)
    assert got[tp]["beam_kv_heads"] == 4 // tp        # the rank's cache holds its KV heads


@pytest.mark.parametrize("tp", WORLDS)
@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_wavlm_tp_matches_jax_replicated(tp_runs, impl, tp):
    """The einsum path and the flash kernel's plain version (its CPU path)
    at num_heads / tp heads a rank."""
    want, got = tp_runs
    for key in ("hidden", "last"):
        np.testing.assert_allclose(_np(got[tp]["wavlm_" + impl][key]), want["wavlm"][key], **TOL)


def test_row_split_bf16_sums_f32_partials_and_rounds_once(tp_runs):
    """At bf16, a row-split Linear over 2 ranks is each rank's partial
    product in f32, summed in f32 (two addends: one order) and rounded to
    bf16 once; rounding each partial first (the control) moves some
    elements by an ulp."""
    _, got = tp_runs
    row = _row_case()
    partials = [torch.nn.functional.linear(row["x"][:, c].float(), row["w"][:, c].float())
                for c in (slice(0, 128), slice(128, 256))]
    once = (partials[0] + partials[1]).bfloat16()
    twice = (partials[0].bfloat16().float() + partials[1].bfloat16().float()).bfloat16()
    assert got[2]["row"].dtype == torch.bfloat16
    assert torch.equal(got[2]["row"], once)
    assert not torch.equal(twice, once)


# ------------------------------------------------------------------ the CLI

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """cli.extract text and feat4 at --tp 1 in this process and --tp 2 on
    the CPU (each starting its two ranks), on tiny seeded directories."""
    from sdumc_tpu_torch.cli import extract
    from tests.test_torch_feat4 import _write_stage_dir
    from tests.test_torch_text import SENTENCES, _write_csv, write_text_model_dir

    work = tmp_path_factory.mktemp("tp_cli")
    write_text_model_dir(work / "llm", seed=3)
    rows = [(f"clip_{i}", s if isinstance(s, str) else "") for i, s in enumerate(SENTENCES)]
    _write_csv(work / "trans.csv", rows)
    text = ["text", "--model_dir", str(work / "llm"), "--trans_path", str(work / "trans.csv"),
            "--device", "cpu"]
    llm, proj, feats = _write_stage_dir(work / "feat4_stage")
    feat4 = ["feat4", "--llm_dir", str(llm), "--projector_path", str(proj), "--wavlm_dir",
             str(feats), "--max_new_tokens", "6", "--device", "cpu"]
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        tp2 = {name: pool.submit(extract.main, argv + ["--save_dir", str(work / f"{name}2"),
                                                       "--tp", "2"])
               for name, argv in (("text", text), ("feat4", feat4))}
        tp1 = {name: extract.main(argv + ["--save_dir", str(work / f"{name}1")])
               for name, argv in (("text", text), ("feat4", feat4))}
        tp2 = {name: f.result() for name, f in tp2.items()}
    return work, rows, tp1, tp2


def test_cli_text_tp2_writes_tp1s_files(cli_runs):
    """Every file, each within BF16_ULPS bf16 ulps of the largest tap of
    --tp 1's (the text stage's bf16 tolerance, tests/test_torch_text.py:
    the tap sum is taken in bf16)."""
    from tests.test_torch_text import BF16_ULPS, _bf16_ulp

    work, rows, tp1, tp2 = cli_runs
    assert tp2["text"]["rows"] == tp1["text"]["rows"] == len(rows)
    assert sorted(os.listdir(work / "text2")) == sorted(os.listdir(work / "text1"))
    top = max(float(np.abs(np.load(work / "text1" / f"{n}.npy")).max()) for n, _ in rows)
    for name, _ in rows:
        got, want = (np.load(work / d / f"{name}.npy") for d in ("text2", "text1"))
        assert got.dtype == np.float32 and got.shape == want.shape, name
        assert np.abs(got - want).max() <= BF16_ULPS * _bf16_ulp(top), name


def test_cli_feat4_tp2_writes_every_clip(cli_runs):
    work, _, tp1, tp2 = cli_runs
    assert tp2["feat4"]["clips"] == tp1["feat4"]["clips"] == 3
    assert sorted(os.listdir(work / "feat42")) == sorted(os.listdir(work / "feat41"))
    for clip in sorted(os.listdir(work / "feat41")):
        got, want = (np.load(work / d / clip) for d in ("feat42", "feat41"))
        assert got.dtype == np.float32 and got.shape[1] == want.shape[1] == 48
        assert 1 <= len(got) <= 6 and np.isfinite(got).all()
        np.testing.assert_allclose(got[0], want[0], **BF16_TOL, err_msg=clip)


def test_cli_tp_ranks_but_0_write_nothing(cli_runs, tmp_path, capfd):
    """Rank 0 alone prints its summary line (the one beside its saves), and
    a rerun skips every saved clip on both ranks."""
    from sdumc_tpu_torch.cli import extract

    work, _, _, tp2 = cli_runs
    argv = ["feat4", "--llm_dir", str(work / "feat4_stage" / "llm"), "--projector_path",
            str(work / "feat4_stage" / "proj.pt"), "--wavlm_dir", str(work / "feat4_stage" / "wavlm"),
            "--max_new_tokens", "6", "--device", "cpu", "--save_dir", str(work / "feat42"),
            "--tp", "2"]
    capfd.readouterr()
    assert extract.main(argv)["clips"] == 0
    out = capfd.readouterr().out
    assert out.count("extracted 0/3 clips") == 1, out
    assert out.count("multihost: backend gloo (--device cpu)") == 2, out


def test_cli_tp_refusals(tmp_path, monkeypatch):
    """--quant with --tp > 1 is a usage error, --tp with a family other
    than llama raises, --tp 2 without --device cpu and no card raises
    before any rank starts, and a rank that fails fails the command."""
    from sdumc_tpu_torch.cli import extract

    feat4 = ["feat4", "--llm_dir", "x", "--projector_path", "x", "--wavlm_dir", "x",
             "--save_dir", str(tmp_path / "o"), "--tp", "2", "--device", "cpu"]
    with pytest.raises(SystemExit):
        extract.main(feat4 + ["--quant", "int8"])
    text = ["text", "--model_dir", str(tmp_path / "missing"), "--trans_path", "x",
            "--save_dir", str(tmp_path / "t"), "--tp", "2"]
    with pytest.raises(ValueError, match="llama family only"):
        extract.main(text + ["--family", "bert", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract.main(text)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(RuntimeError, match="rank . exited with code"):
        extract.main(text + ["--device", "cpu"])
