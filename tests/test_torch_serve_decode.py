"""The port's beam-decode serving bundle (``serve/export.py DecodeBundle``,
``cli.export --decode``) against the port's eager engine and the JAX
package's live ``beam_generate_batched``, on the CPU.

The sizes are JAX's ``tests/test_serve.py::test_decode_bundle_roundtrip``:
``LlamaConfig.tiny()`` with JAX's seeded params carried across
(``llama_state_dict_from_flax``), prompt buckets 8 and 16, gen_batch 3, 6
new tokens. Tokens, their counts and the step counts are equal; taps and
scores agree to rtol = atol = 1e-5 (JAX's own tolerance for its bundle; f32,
the generated cache read whole with its unwritten slots masked where the
eager engine reads only the written ones). The quantized bundles (int8,
w8a8, int8-KV) have one bucket. A model whose logits are 100x sharper, with
an EOS its clips reach, stops the loop early through ``check_every``.
``cli.export --decode`` runs on an HF-format directory (bf16 on the CPU,
as the CLI loads it).
"""

import json
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.models import generation as jg
from sdumc_tpu.models import llama as jl
from sdumc_tpu.ops.quant import quantize_params as jax_quantize_params
from sdumc_tpu_torch.cli import export as export_cli
from sdumc_tpu_torch.convert import llama_state_dict_from_flax
from sdumc_tpu_torch.convert.hf_llama import load_hf_llama
from sdumc_tpu_torch.models.generation import beam_generate_batched
from sdumc_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from sdumc_tpu_torch.serve import DecodeBundle

# several test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
BUCKETS, GEN_BATCH, MAX_NEW = (8, 16), 3, 6
D = 64
SHARP, SHARP_EOS, SHARP_NEW = 100.0, 66, 16     # clip (seed 0, length 7) ends at step 8


def _jax_params():
    jcfg = jl.LlamaConfig.tiny()
    params = jl.LlamaForCausalLM(jcfg).init(jax.random.PRNGKey(0),
                                            input_ids=jnp.zeros((1, 4), jnp.int32))["params"]
    return jcfg, jax.tree_util.tree_map(np.asarray, params)


def _port(params, **kw):
    cfg = LlamaConfig.tiny(**kw)
    model = LlamaForCausalLM(cfg).eval()
    model.load_state_dict(llama_state_dict_from_flax(params), strict=True)
    return model


def _sharp(params):
    return {**params, "lm_head": {"kernel": params["lm_head"]["kernel"] * SHARP}}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's tiny config and params, the port's model with them, and the
    bundle built from it, saved (its directory)."""
    jcfg, params = _jax_params()
    model = _port(params)
    path = tmp_path_factory.mktemp("decode") / "bundle"
    DecodeBundle.build(model, buckets=BUCKETS, gen_batch=GEN_BATCH,
                       max_new_tokens=MAX_NEW).save(str(path))
    return jcfg, params, model, path


@pytest.fixture(scope="module")
def loaded(setup):
    """The saved bundle loaded in a fresh object (once for the module)."""
    return DecodeBundle.load(str(setup[3]))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(P, D)) * 0.5).astype(np.float32) for P in lens]


def _padded(prompts, bucket):
    """The batch the bundle runs: left-padded, pad rows zero with length 1."""
    pe = np.zeros((GEN_BATCH, bucket, D), np.float32)
    pl = np.ones(GEN_BATCH, np.int64)
    for i, p in enumerate(prompts):
        pe[i, bucket - len(p):] = p
        pl[i] = len(p)
    return pe, pl


def _eager(model, pe, pl, max_new=MAX_NEW, eos=2, **kw):
    with torch.inference_mode():
        out = beam_generate_batched(model, torch.from_numpy(pe), model.cfg,
                                    embed_fn=model.model.embed_tokens,
                                    prompt_len=torch.from_numpy(pl), num_beams=4,
                                    max_new_tokens=max_new, eos_id=eos, **kw)
    return {k: v.numpy() for k, v in out.items()}


def _jax(jcfg, params, pe, pl, max_new=MAX_NEW, eos=2):
    model = jl.LlamaForCausalLM(jcfg)
    emb = jnp.asarray(params["model"]["embed_tokens"]["embedding"])
    out = jax.jit(lambda pe, pl: jg.beam_generate_batched(
        lambda **kw: model.apply({"params": params}, **kw), pe, jcfg,
        embed_fn=lambda t: emb[t], prompt_len=pl, num_beams=4, max_new_tokens=max_new,
        eos_id=eos))(jnp.asarray(pe), jnp.asarray(pl, jnp.int32))
    return {k: np.asarray(v) for k, v in out.items()}


def _same(got, want, n, tol=TOL):
    """got (the bundle's answer for n clips) against an engine's [GEN_BATCH]
    results."""
    for key in ("tokens", "n_tokens", "n_steps"):
        np.testing.assert_array_equal(got[key], want[key][:n], err_msg=key)
    for key in ("taps", "score"):
        np.testing.assert_allclose(got[key], want[key][:n], err_msg=key, **tol)


def test_roundtrip_matches_eager_and_jax(setup, loaded):
    """save -> load in a fresh object; a partial batch (two clips, lengths 5
    and 7, in bucket 8) answers as the port's eager engine and JAX's live
    engine do on the same left-padded batch."""
    jcfg, params, model, _ = setup
    assert (loaded.buckets, loaded.gen_batch, loaded.max_new) == (list(BUCKETS), GEN_BATCH, MAX_NEW)
    assert loaded.device.type == "cpu"
    prompts = _prompts(0, (5, 7))
    out = loaded(prompts)
    assert out["tokens"].shape == (2, MAX_NEW) and out["taps"].shape == (2, MAX_NEW, D)
    assert out["taps"].dtype == np.float32
    pe, pl = _padded(prompts, 8)
    _same(out, _eager(model, pe, pl), 2)
    _same(out, _jax(jcfg, params, pe, pl), 2)


def test_bucket_dispatch(setup, loaded):
    """A 13-long prompt picks bucket 16 (and answers as both engines at 16);
    a 17-long one and more prompts than gen_batch raise."""
    jcfg, params, model, _ = setup
    prompts = _prompts(1, (13,))
    assert loaded.pad(prompts)[0] == 16
    out = loaded(prompts)
    pe, pl = _padded(prompts, 16)
    _same(out, _eager(model, pe, pl), 1)
    _same(out, _jax(jcfg, params, pe, pl), 1)
    with pytest.raises(ValueError, match="bucket"):
        loaded([np.zeros((17, D), np.float32)])
    with pytest.raises(ValueError, match="prompts"):
        loaded(_prompts(2, (3,) * (GEN_BATCH + 1)))


def test_programs_carry_no_weights(setup, loaded):
    """Three programs a bucket, each without weights, constants or example
    inputs; the manifest has JAX's fields and the port's; the parameters
    are the model's."""
    _, _, model, path = setup
    with open(path / "manifest.json") as f:
        man = json.load(f)
    assert man["kind"] == "beam_decode" and man["buckets"] == list(BUCKETS)
    assert (man["gen_batch"], man["hidden_size"], man["max_new_tokens"]) == (GEN_BATCH, D, MAX_NEW)
    assert (man["device"], man["num_beams"], man["eos_id"], man["check_every"]) == ("cpu", 4, 2, 8)
    assert man["params"] == list(model.state_dict())
    names = [n for b in BUCKETS for n in man["programs"][str(b)].values()]
    assert sorted(os.listdir(path)) == sorted(["manifest.json", "params.safetensors", *names])
    for b in BUCKETS:
        assert set(loaded._programs[b]) == {"prefill", "step", "finalize"}
        for program in loaded._programs[b].values():
            assert len(program.state_dict) == 0 and len(program.constants) == 0
    # each archive holds the graph as JSON and nothing pickled
    for name in names:
        with zipfile.ZipFile(path / name) as archive:
            for member in archive.infolist():
                if member.filename.endswith("_config.json"):
                    assert json.loads(archive.read(member)) == {"config": {}}, member.filename
                elif "/data/" in member.filename:
                    assert member.file_size == 0, member.filename
    for key, value in model.state_dict().items():
        assert torch.equal(loaded._params[key], value), key


def test_step_index_is_an_input_of_the_step_program(loaded):
    """One step program serves every step: called at index 0, 1, 2 it
    writes generated-cache slot 0, 1, 2 of every layer, and no slot past
    the last index it was given (the beam reorder moves the unwritten,
    zero, slots as they are)."""
    bucket, pe, pl = loaded.pad(_prompts(3, (6, 8, 4)))
    prog = loaded._modules[bucket]
    with torch.inference_mode():
        state = prog["prefill"](loaded._params, pe, pl)
        for it in range(3):
            live = prog["step"](loaded._params, state, pl, loaded._its[it])
            for key in ("gk", "gv"):
                written = state["caches"][key].abs().sum(dim=(-2, -1))   # [L, R, G]
                assert (written[:, :, :it + 1] > 0).all(), (key, it)
                assert (written[:, :, it + 1:] == 0).all(), (key, it)
    assert live.dtype == torch.bool and live.shape == (GEN_BATCH,) and live.all()
    assert state["step"].tolist() == [4] * GEN_BATCH


def test_check_every_stops_the_loop_early(tmp_path):
    """A model with 100x sharper logits and an EOS its clip reaches at step
    8: the bundle's loop breaks at its first check after every clip is
    done (9 step calls at check_every 3, 8 at 4, 7 at 1), with the results
    of checking every step, of the eager engine and of JAX's engine."""
    jcfg, params = _jax_params()
    sparams = _sharp(params)
    model = _port(sparams)
    DecodeBundle.build(model, buckets=(8,), gen_batch=GEN_BATCH, max_new_tokens=SHARP_NEW,
                       eos_id=SHARP_EOS).save(str(tmp_path / "b"))
    loaded = DecodeBundle.load(str(tmp_path / "b"))
    prompts = _prompts(0, (5, 7))[1:] * GEN_BATCH
    results = {}
    for every, calls in ((1, 7), (3, 9), (4, 8)):
        step = loaded._modules[8]["step"]
        seen = []

        def counted(*a, step=step, seen=seen):
            seen.append(int(a[-1]))
            return step(*a)

        loaded._modules[8]["step"] = counted
        loaded.check_every = every
        try:
            results[every] = loaded(prompts)
        finally:
            loaded._modules[8]["step"] = step
        assert seen == list(range(calls)), (every, seen)
    assert results[1]["n_steps"].tolist() == [8] * GEN_BATCH
    for every in (3, 4):
        for key, value in results[1].items():
            np.testing.assert_array_equal(results[every][key], value, err_msg=key)
    pe, pl = _padded(prompts, 8)
    _same(results[4], _eager(model, pe, pl, SHARP_NEW, SHARP_EOS), GEN_BATCH)
    _same(results[4], _jax(jcfg, sparams, pe, pl, SHARP_NEW, SHARP_EOS), GEN_BATCH)


# JAX's tolerance, but where an int8 KV code can round the other way: on
# these inputs one code of layer 2's prompt v (clip 0, slot 6) is 126 in
# torch and 125 in XLA, at a scale of 2.05e-3, from f32 sums in another
# order; the taps move by up to 4.9e-4 at steps that read it. The port's
# eager engine has the same code, and the bundle equals it to 1e-5.
JAX_TOL = {None: TOL, "int8": dict(rtol=1e-5, atol=1e-3)}


@pytest.mark.parametrize("quant,kv_quant", [("int8", None), ("w8a8", None), (None, "int8")])
def test_quantized_bundle_matches_eager_and_jax(tmp_path, quant, kv_quant):
    """int8 / w8a8 weights (JAX's quantize_params tree carried across) and
    the int8 KV cache, one bucket: the bundle answers as the port's eager
    quantized decode, and as JAX's (tokens and step counts equal; taps and
    scores to ``JAX_TOL``). The w8a8 bundle is saved and loaded first (its
    int8 codes and f32 scales through params.safetensors)."""
    jcfg, params = _jax_params()
    qparams = jax_quantize_params(params, mode=quant) if quant else params
    qparams = jax.tree_util.tree_map(np.asarray, qparams)
    model = _port(qparams, quant=quant, kv_quant=kv_quant)
    bundle = DecodeBundle.build(model, buckets=(8,), gen_batch=GEN_BATCH, max_new_tokens=MAX_NEW)
    if quant == "w8a8":
        bundle.save(str(tmp_path / "b"))
        bundle = DecodeBundle.load(str(tmp_path / "b"))
        for key, value in model.state_dict().items():
            assert torch.equal(bundle._params[key], value), key
    assert any(v.dtype == torch.int8 for v in bundle._params.values()) == bool(quant)
    prompts = _prompts(4, (8, 5, 6))
    out = bundle(prompts)
    pe, pl = _padded(prompts, 8)
    _same(out, _eager(model, pe, pl), GEN_BATCH)
    qcfg = jl.LlamaConfig(**{**jcfg.__dict__, "quant": quant, "kv_quant": kv_quant})
    _same(out, _jax(qcfg, qparams, pe, pl), GEN_BATCH, JAX_TOL[kv_quant])


_SERVER = """
import json, sys
import numpy as np
sys.path.insert(0, {repo!r})
from sdumc_tpu_torch.serve import DecodeBundle
bundle = DecodeBundle.load({bundle!r})
req = np.load({req!r})
out = bundle([req[k] for k in sorted(req.files)])
np.savez({out!r}, **out)
print(json.dumps(sorted(m for m in sys.modules if m.startswith("sdumc_tpu_torch.models"))))
"""


def test_a_fresh_process_serves_the_decode_without_model_code(setup, tmp_path):
    """A process that imports only ``sdumc_tpu_torch.serve`` loads the
    bundle and answers a full batch (bucket 16) as the eager engine does;
    it loads no module under ``sdumc_tpu_torch.models``."""
    _, _, model, path = setup
    prompts = _prompts(5, (9, 16, 11))
    np.savez(tmp_path / "req.npz", **{f"p{i}": p for i, p in enumerate(prompts)})
    code = _SERVER.format(repo=str(REPO), bundle=str(path), req=str(tmp_path / "req.npz"),
                          out=str(tmp_path / "out.npz"))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert run.returncode == 0, run.stderr
    assert json.loads(run.stdout.strip().splitlines()[-1]) == []
    out = dict(np.load(tmp_path / "out.npz"))
    pe, pl = _padded(prompts, 16)
    _same(out, _eager(model, pe, pl), GEN_BATCH)


def _hf_dir(path):
    """JAX's test_decode_export_cli's checkpoint (vocab 96, width 48, 2
    layers) in HF's format, written with the port's own weights (its state
    dict carries HF's names): config.json and pytorch_model.bin."""
    from sdumc_tpu_torch.models.llama import init_weights

    cfg = LlamaConfig.tiny(vocab_size=96, hidden_size=48, intermediate_size=96, num_layers=2)
    path.mkdir()
    with open(path / "config.json", "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"], "model_type": "llama",
                   "vocab_size": 96, "hidden_size": 48, "intermediate_size": 96,
                   "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 4,
                   "max_position_embeddings": 256, "rms_norm_eps": 1e-6, "eos_token_id": 2,
                   "bos_token_id": 1, "pad_token_id": 0}, f)
    torch.save(init_weights(LlamaForCausalLM(cfg), seed=0).state_dict(),
               path / "pytorch_model.bin")
    return str(path)


@pytest.mark.parametrize("quant,kv_quant", [(None, None), ("w8a8", "int8")])
def test_cli_export_decode_on_cpu(tmp_path, capsys, quant, kv_quant):
    """``cli.export --decode --device cpu`` (bf16, as the CLI loads the
    checkpoint) on an HF-format directory, plain and with ``--quant w8a8
    --kv_quant int8``: JAX's summary line; the manifest's params are the
    int8 codes where the CLI quantized; the bundle answers as the eager
    engine on the same model loaded with the same options."""
    llm_dir = _hf_dir(tmp_path / "hf_llama")
    out_dir = str(tmp_path / "bundle")
    flags = ["--quant", quant] if quant else []
    flags += ["--kv_quant", kv_quant] if kv_quant else []
    assert export_cli.main(["--decode", "--device", "cpu", "--llm_dir", llm_dir,
                            "--out_dir", out_dir, "--prompt_buckets", "8", "--gen_batch", "2",
                            "--max_new_tokens", "4", "--platforms", "native", *flags]) == 0
    printed = capsys.readouterr().out
    assert "exported 1 decode programs (gen_batch=2, beams=4) -> " + out_dir in printed
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    bundle = DecodeBundle.load(out_dir)
    assert bundle.gen_batch == 2 and bundle.buckets == [8]
    assert set(bundle._params) == set(manifest["params"])
    int8 = sorted(k for k, v in bundle._params.items() if v.dtype == torch.int8)
    if quant:
        assert int8 and all(k.endswith("_q") for k in int8), int8
    else:
        assert not int8
    assert all(v.dtype in (torch.bfloat16, torch.float32) for k, v in bundle._params.items()
               if k not in int8)
    rng = np.random.default_rng(0)
    prompts = [(rng.normal(size=(5, 48)) * 0.5).astype(np.float32)]
    out = bundle(prompts)
    assert out["tokens"].shape == (1, 4) and int(out["n_steps"][0]) >= 1
    _, model = load_hf_llama(llm_dir, quant=quant, kv_quant=kv_quant)
    pe = np.zeros((2, 8, 48), np.float32)
    pe[0, 3:] = prompts[0]
    ref = _eager(model, pe, np.array([5, 1]), max_new=4)
    for key in ("tokens", "n_tokens", "n_steps"):
        np.testing.assert_array_equal(out[key], ref[key][:1], err_msg=key)
    np.testing.assert_allclose(out["taps"], ref["taps"][:1], **TOL)


def test_cli_export_decode_refusals(tmp_path, monkeypatch):
    """--decode without --llm_dir refuses (JAX asserts); without a card and
    without --device cpu it raises before reading the checkpoint."""
    with pytest.raises(SystemExit):
        export_cli.main(["--decode", "--out_dir", str(tmp_path / "a"), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_cli.main(["--decode", "--llm_dir", str(tmp_path), "--out_dir",
                         str(tmp_path / "b")])
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()
