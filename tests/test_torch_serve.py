"""The port's serving export (``sdumc_tpu_torch/serve/export.py``,
``cli.export``) against the JAX package's dual-view eval, on the CPU.

A bundle built from the JAX weights (``state_dict_from_flax``), saved and
loaded in a fresh object, answers a partial batch as the port's eager eval
does (atol 1e-6: the same ops run on both sides) and as JAX's live
``make_eval_step`` does on the same padded batch (rtol 1e-4 / atol 1e-5:
f32 on both sides, summed in another order through the whole net). Two
requests in one combo at other lengths show that ``t_max`` stays an input
of the program. The sizes are JAX's ``tests/test_serve.py``'s. The two
custom ops that reach the hand-written kernels are checked with
``torch.library.opcheck`` on their CPU implementations.
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

from sdumc_tpu.core.config import ModelConfig as JaxModelConfig
from sdumc_tpu.models import get_model as jax_get_model
from sdumc_tpu.train.step import make_eval_step as jax_make_eval_step
from sdumc_tpu_torch.cli import export as export_cli
from sdumc_tpu_torch.cli.common import build_model
from sdumc_tpu_torch.convert import state_dict_from_flax
from sdumc_tpu_torch.core.config import ExperimentConfig, ModelConfig
from sdumc_tpu_torch.models.fusion import SDUMCFusion
from sdumc_tpu_torch.ops.kernels import flash_wavlm, fused_cross
from sdumc_tpu_torch.serve import ServingBundle
from sdumc_tpu_torch.train.step import make_eval_step

# several test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DIMS = (12, 24, 12, 24)
B = 4
COMBOS = [(8, 8, 8, 8), (16, 8, 8, 8)]
FEATURES = ("audio", "text", "video", "feat4")
WIDTHS = dict(general_dim=16, layers=(16, 8), fused_layers=(16, 16))


@pytest.fixture(scope="module")
def models():
    """(JAX model, its params, the port's model with the same weights)."""
    jmodel = jax_get_model(JaxModelConfig(input_dims=DIMS[:3], **WIDTHS))
    params = jmodel.init(jax.random.PRNGKey(0), *(jnp.zeros((2, 4, d)) for d in DIMS[:3]))["params"]
    model = SDUMCFusion(ModelConfig(input_dims=DIMS[:3], **WIDTHS))
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, model.eval()


@pytest.fixture(scope="module")
def bundle_dir(models, tmp_path_factory):
    path = tmp_path_factory.mktemp("serve") / "bundle"
    ServingBundle.build(models[2], DIMS, COMBOS, B).save(str(path))
    return path


def _request(rng, Bp, lens, dims=DIMS):
    return {k: rng.normal(size=(Bp, t, d)).astype(np.float32)
            for k, t, d in zip(FEATURES, lens, dims)}


def _padded(batch, combo, rows=B):
    out = {}
    for k, t_b in zip(FEATURES, combo):
        x = batch[k]
        p = np.zeros((rows, t_b, x.shape[2]), np.float32)
        p[: x.shape[0], : x.shape[1]] = x
        out[k] = p
    return out


def _eager(model, batch, combo, rows=B):
    """The port's eager eval on the padded batch, t_max host ints."""
    d = {k: torch.from_numpy(v) for k, v in _padded(batch, combo, rows).items()}
    d["t_max"] = tuple(batch[k].shape[1] for k in FEATURES)
    v0, v1 = make_eval_step(model)(d)
    n = batch["audio"].shape[0]
    return v0[:n].numpy(), v1[:n].numpy()


def _jax_eval(jmodel, params, batch, combo):
    """JAX's live eval on the padded batch, t_max traced int32 scalars."""
    jbatch = {k: jnp.asarray(v) for k, v in _padded(batch, combo).items()}
    jbatch["vals"] = jnp.zeros((B,), jnp.float32)
    jbatch["t_max"] = tuple(jnp.int32(batch[k].shape[1]) for k in FEATURES)
    n = batch["audio"].shape[0]
    return tuple(np.asarray(v)[:n] for v in jax_make_eval_step(jmodel)(params, jbatch))


def test_roundtrip_matches_eager_and_jax(models, bundle_dir):
    jmodel, params, model = models
    loaded = ServingBundle.load(str(bundle_dir))
    assert loaded.combos == COMBOS and loaded.B == B and loaded.device.type == "cpu"
    batch = _request(np.random.default_rng(0), 3, (5, 7, 6, 4))    # a partial batch
    v0, v1 = loaded(batch)
    assert v0.shape == v1.shape == (3,) and v0.dtype == np.float32
    r0, r1 = _eager(model, batch, COMBOS[0])
    np.testing.assert_allclose(v0, r0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(v1, r1, rtol=0, atol=1e-6)

    j0, j1 = _jax_eval(jmodel, params, batch, COMBOS[0])
    np.testing.assert_allclose(v0, j0, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v1, j1, rtol=1e-4, atol=1e-5)


def test_t_max_is_not_baked_into_the_program(models, bundle_dir):
    """Two requests in one combo at other lengths, each equal to the eager
    eval at its own lengths (a program that had kept the export's lengths
    would mask both at 8)."""
    loaded = ServingBundle.load(str(bundle_dir))
    rng = np.random.default_rng(1)
    answers = []
    for lens in ((3, 8, 2, 5), (8, 2, 7, 1)):
        batch = _request(rng, 4, lens)
        assert loaded._pick(lens) == COMBOS[0]
        got = loaded(batch)
        for g, r in zip(got, _eager(models[2], batch, COMBOS[0])):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)
        answers.append(got[0])
    # the same rows at the combo's full lengths answer differently
    full = _request(np.random.default_rng(1), 4, (3, 8, 2, 5))
    padded = _padded(full, COMBOS[0])
    assert np.abs(loaded(padded)[0] - answers[0]).max() > 1e-4


def test_dispatch_picks_the_least_padding(models, bundle_dir):
    loaded = ServingBundle.load(str(bundle_dir))
    rng = np.random.default_rng(2)
    batch = _request(rng, 3, (12, 7, 6, 4))     # longer audio: the bigger combo
    assert loaded._pick((12, 7, 6, 4)) == COMBOS[1]
    for g, r in zip(loaded(batch), _eager(models[2], batch, COMBOS[1])):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="bucket"):
        loaded(_request(rng, 3, (64, 7, 6, 4)))
    with pytest.raises(ValueError, match="batch size"):
        loaded(_request(rng, B + 1, (5, 7, 6, 4)))
    # heterogeneous combos: the least total padded length, not the tuple order
    hetero = ServingBundle([(64, 512, 512, 64), (256, 64, 64, 64)], B, DIMS, {}, {}, "cpu")
    assert hetero._pick((10, 10, 10, 10)) == (256, 64, 64, 64)
    assert hetero._pick((10, 100, 10, 10)) == (64, 512, 512, 64)


def test_programs_carry_no_weights_and_params_keep_their_bits(models, bundle_dir, tmp_path):
    loaded = ServingBundle.load(str(bundle_dir))
    for combo, program in loaded._programs.items():
        assert len(program.state_dict) == 0 and len(program.constants) == 0, combo
        ops = [n for n in program.graph.nodes if n.target is torch.ops.sdumc.fused_cross.default]
        assert len(ops) == 6, combo                 # 3 pools and 3 cross attentions
    with open(bundle_dir / "manifest.json") as f:
        man = json.load(f)
    assert sorted(os.listdir(bundle_dir)) == sorted(
        ["manifest.json", "params.safetensors", *man["programs"].values()])
    # each archive holds the graph as JSON and nothing pickled: no weights,
    # no constants, no example inputs
    for name in man["programs"].values():
        with zipfile.ZipFile(bundle_dir / name) as archive:
            for member in archive.infolist():
                if member.filename.endswith("_config.json"):
                    assert json.loads(archive.read(member)) == {"config": {}}, member.filename
                elif "/data/" in member.filename:
                    assert member.file_size == 0, member.filename
    assert man["params"] == list(dict(models[2].named_parameters()))
    for name, value in models[2].state_dict().items():
        assert torch.equal(loaded._params[name], value), name
    # a bf16 tensor keeps its bits through the params file
    bits = torch.tensor([1.0, -0.0, 1e-40, 3.0e38, float("nan")]).bfloat16()
    loaded._params["extra"] = bits
    loaded.save(str(tmp_path / "again"))
    back = ServingBundle.load(str(tmp_path / "again"))._params["extra"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), bits.view(torch.int16))


_SERVER = """
import json, sys
import numpy as np
sys.path.insert(0, {repo!r})
from sdumc_tpu_torch.serve import ServingBundle
bundle = ServingBundle.load({bundle!r})
req = np.load({req!r})
out = {{}}
for i in range(2):
    batch = {{k: req[f"{{k}}{{i}}"] for k in ("audio", "text", "video", "feat4")}}
    out[f"full{{i}}"], out[f"missing{{i}}"] = bundle(batch)
np.savez({out!r}, **out)
print(json.dumps(sorted(m for m in sys.modules if m.startswith("sdumc_tpu_torch.models"))))
"""


def test_a_fresh_process_serves_without_model_code(tmp_path):
    """JAX weights at ModelConfig's widths as a reference .pt, through
    ``python -m sdumc_tpu_torch.cli.export --device cpu``; a process that
    imports only ``sdumc_tpu_torch.serve`` serves two requests (two
    combos), as JAX's live eval and the port's eager eval answer them."""
    jmodel = jax_get_model(JaxModelConfig(input_dims=DIMS[:3]))
    params = jmodel.init(jax.random.PRNGKey(1), *(jnp.zeros((2, 4, d)) for d in DIMS[:3]))["params"]
    state = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    torch.save({"epoch": 0, "state_dict": {f"module.{k}": v for k, v in state.items()}},
               tmp_path / "ck.pt")
    export = subprocess.run(
        [sys.executable, "-m", "sdumc_tpu_torch.cli.export", "--device", "cpu", "--checkpoint",
         str(tmp_path / "ck.pt"), "--out_dir", str(tmp_path / "bundle"), "--batch_size", str(B),
         "--input_dims", ",".join(map(str, DIMS)), "--combos", "8x8x8x8,16x8x8x8"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert export.returncode == 0, export.stderr
    rng = np.random.default_rng(3)
    reqs = [_request(rng, 3, (5, 7, 6, 4)), _request(rng, 2, (14, 3, 8, 8))]
    np.savez(tmp_path / "req.npz",
             **{f"{k}{i}": r[k] for i, r in enumerate(reqs) for k in FEATURES})
    code = _SERVER.format(repo=str(REPO), bundle=str(tmp_path / "bundle"),
                          req=str(tmp_path / "req.npz"), out=str(tmp_path / "out.npz"))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert run.returncode == 0, run.stderr
    assert json.loads(run.stdout.strip().splitlines()[-1]) == []
    out = np.load(tmp_path / "out.npz")
    model = SDUMCFusion(ModelConfig(input_dims=DIMS[:3]))
    model.load_state_dict(state)
    for i, (req, combo) in enumerate(zip(reqs, COMBOS)):
        got = out[f"full{i}"], out[f"missing{i}"]
        for g, r in zip(got, _eager(model, req, combo)):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)
        for g, r in zip(got, _jax_eval(jmodel, params, req, combo)):
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5)


def test_cli_export_on_cpu_serves_the_seeded_model(tmp_path, capsys):
    dims, combos = (16, 32, 16, 32), "8x8x8x8,16x16x8x8"
    out_dir = tmp_path / "bundle"
    assert export_cli.main(["--device", "cpu", "--out_dir", str(out_dir), "--batch_size", "3",
                            "--input_dims", ",".join(map(str, dims)), "--combos", combos]) == 0
    assert "exported 16x16x8x8 in" in capsys.readouterr().out
    loaded = ServingBundle.load(str(out_dir))
    assert loaded.combos == [(8, 8, 8, 8), (16, 16, 8, 8)] and loaded.input_dims == list(dims)
    model = build_model(ExperimentConfig(), dims, torch.device("cpu"))     # the same seed
    batch = _request(np.random.default_rng(4), 2, (11, 9, 3, 8), dims)
    for g, r in zip(loaded(batch), _eager(model, batch, (16, 16, 8, 8), rows=3)):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)


def test_cli_export_refusals(tmp_path, monkeypatch, capsys):
    with pytest.raises(SystemExit):          # --decode needs --llm_dir, as JAX's assert
        export_cli.main(["--decode", "--out_dir", str(tmp_path / "d")])
    assert "--decode needs --llm_dir" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_cli.main(["--out_dir", str(tmp_path / "b"), "--input_dims", "16,32,16,32"])
    assert not (tmp_path / "b").exists()


def _cross_inputs(q_count, dtype):
    rng = np.random.default_rng(5)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    Bx, T, D = 3, 9, 8
    q = f(Bx, 7, D) if q_count == 7 else f(1, D)
    return q, f(Bx, T, D).to(dtype), f(D, D) * 0.3, f(D)


# (tensor, host int) arguments of the op for each form of t_max
T_MAX_FORMS = {"none": (None, None), "int": (None, 5),
               "0-d": (torch.tensor(4, dtype=torch.int32), None),
               "rows": (torch.tensor([9, 3, 0], dtype=torch.int32), None)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", list(T_MAX_FORMS))
@pytest.mark.parametrize("q_count", [7, 1])
def test_opcheck_fused_cross(q_count, form, dtype):
    q, x, w, b = _cross_inputs(q_count, dtype)
    tensor, scalar = T_MAX_FORMS[form]
    torch.library.opcheck(torch.ops.sdumc.fused_cross.default,
                          (q, x, w, b, tensor, scalar, 0.3, q_count == 7))
    # the wrappers reach the op and give the plain version's values
    t_max = tensor if tensor is not None else scalar
    if q_count == 7:
        got = fused_cross.fused_cross_attention(q, x, w, b, t_max)
        want = fused_cross.fused_cross_attention_plain(q, x, w, b, t_max)
    else:
        from sdumc_tpu_torch.ops.kernels import fused_pool

        got = fused_pool.fused_attention_pool(x, w, b, q[0], t_max)
        want = fused_pool.fused_attention_pool_plain(x, w, b, q[0], t_max)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_opcheck_flash_wavlm(dtype, masked):
    rng = np.random.default_rng(6)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    Bx, T, H, hd = 2, 9, 2, 4
    q, k, v = (f(Bx, T, H, hd).to(dtype) for _ in range(3))
    kvalid = torch.from_numpy((rng.random((Bx, T)) > 0.3).astype(np.float32)) if masked else None
    gate, diag = f(Bx, H, T), f(H, 2 * T - 1)
    torch.library.opcheck(torch.ops.sdumc.flash_wavlm.default, (q, k, v, gate, diag, kvalid))
    got = flash_wavlm.flash_gated_attention(q, k, v, gate, None, kvalid, diag,
                                            num_buckets=0, max_distance=0)
    want = flash_wavlm.flash_gated_attention_plain(q, k, v, gate, None, kvalid, diag,
                                                   num_buckets=0, max_distance=0)
    assert torch.equal(got, want)
