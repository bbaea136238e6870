"""sdumc_tpu_torch's WavLM extraction path vs the JAX package (and HF) on the
CPU, at tiny sizes, with the same numpy inputs on both sides.

Tolerances: buckets are integers and must be equal; the plain attention
against the JAX kernel (interpret mode) and einsum reference rtol/atol 2e-5,
as tests/test_flash_wavlm.py holds them (f32, another summation order); the
models' hidden states rtol/atol 1e-4 against JAX and HF (f32 through a few
layers of convs, LNs and attention, summed in another order); the loaded
HF model against HF's own forward 1e-5 (the same torch ops).
"""

import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.convert.hf_wavlm import hf_wavlm_to_params
from sdumc_tpu.extract.audio import extract_audio_features as jax_extract
from sdumc_tpu.models.wavlm import WavLMConfig as JaxConfig
from sdumc_tpu.models.wavlm import WavLMModel as JaxModel
from sdumc_tpu.models.wavlm import relative_position_buckets as jax_rel_buckets
from sdumc_tpu.ops.pallas.flash_wavlm import bucket_from_rel as jax_bucket
from sdumc_tpu.ops.pallas.flash_wavlm import flash_gated_attention as jax_flash
from sdumc_tpu_torch.convert import wavlm_state_dict_from_flax
from sdumc_tpu_torch.convert.hf_wavlm import config_from_hf, load_hf_wavlm
from sdumc_tpu_torch.extract.audio import extract_audio_features, read_wav
from sdumc_tpu_torch.models.wavlm import WavLMConfig, WavLMModel, resolve_attention_impl
from sdumc_tpu_torch.ops.kernels import flash_wavlm
from tests.test_flash_wavlm import einsum_reference

# several test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

NB, MD = 40, 100
ATT_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("num_buckets,max_distance", [(40, 100), (320, 800)])
def test_bucket_from_rel_matches_jax_exactly(num_buckets, max_distance):
    """Every offset in +-2 max_distance, so every bucket boundary, equal."""
    rel = np.arange(-2 * max_distance, 2 * max_distance + 1)
    got = flash_wavlm.bucket_from_rel(torch.from_numpy(rel), num_buckets, max_distance)
    want = np.asarray(jax_bucket(jnp.asarray(rel), num_buckets, max_distance))
    np.testing.assert_array_equal(_np(got), want)
    assert len(np.unique(want)) == num_buckets - 1   # every bucket but +0, which no offset hits
    got = flash_wavlm.relative_position_buckets(37, 250, num_buckets, max_distance)
    want = np.asarray(jax_rel_buckets(37, 250, num_buckets, max_distance))
    np.testing.assert_array_equal(_np(got), want)


def _att_inputs(T, masked, B=2, H=4, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, H, hd)).astype(np.float32) for _ in range(3))
    gate = (1.0 + rng.uniform(size=(B, H, T))).astype(np.float32)
    rel_embed = rng.normal(size=(NB, H)).astype(np.float32)
    lengths = rng.integers(T // 2, T + 1, size=B) if masked else np.full(B, T)
    kvalid = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return q, k, v, gate, rel_embed, kvalid


@pytest.mark.parametrize("T", [64, 100, 130])
@pytest.mark.parametrize("masked", [True, False])
def test_plain_attention_matches_jax(T, masked):
    arrays = _att_inputs(T, masked)
    kvalid = arrays[5]
    kw = dict(num_buckets=NB, max_distance=MD)
    got = flash_wavlm.flash_gated_attention_plain(
        *map(torch.from_numpy, arrays[:5]), torch.from_numpy(kvalid) if masked else None, **kw)
    jx = tuple(map(jnp.asarray, arrays))
    kernel = jax_flash(*jx[:5], jx[5] if masked else None, block=32, interpret=True, **kw)
    ref = einsum_reference(*jx)
    keep = kvalid[:, :, None, None] > 0        # only valid rows are consumed downstream
    for want in (kernel, ref):
        np.testing.assert_allclose(np.where(keep, _np(got), 0.0),
                                   np.where(keep, np.asarray(want), 0.0), **ATT_TOL)
    # the CPU wrapper is the plain version, with or without the carried bias
    t = [torch.from_numpy(a) for a in arrays]
    diag = flash_wavlm.bias_diag_for(t[4], T, NB, MD)
    wrapped = flash_wavlm.flash_gated_attention(*t[:4], None, t[5], diag, **kw)
    plain = flash_wavlm.flash_gated_attention_plain(*t, **kw)
    torch.testing.assert_close(wrapped, plain, rtol=0, atol=0)


def _jax_tiny(**kw):
    cfg = JaxConfig.tiny(**kw)
    wav = np.random.default_rng(2).normal(size=(2, 900)).astype(np.float32)
    t = cfg.output_length(900)
    mask = np.arange(t)[None, :] < np.array([t, t - 9])[:, None]
    model = JaxModel(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(wav))["params"]
    out = model.apply({"params": params}, jnp.asarray(wav), pad_mask=jnp.asarray(mask),
                      output_hidden_states=True)
    return cfg, params, wav, mask, out["hidden_states"]


@pytest.mark.parametrize("norm,stable,impl,rel_pos", [
    ("layer", True, "einsum", True),
    ("group", False, "einsum", True),
    ("layer", True, "flash", True),      # the kernel path's CPU form: plain + carried diag
    ("layer", True, "einsum", False),    # wav2vec2 / HuBERT attention
])
def test_model_matches_jax(norm, stable, impl, rel_pos):
    """Every hidden-state tap, params carried by wavlm_state_dict_from_flax,
    with a batched pad mask."""
    jcfg, params, wav, mask, want = _jax_tiny(
        feat_extract_norm=norm, do_stable_layer_norm=stable,
        attention_impl="einsum", use_rel_pos_bias=rel_pos)
    cfg = WavLMConfig.tiny(feat_extract_norm=norm, do_stable_layer_norm=stable,
                           attention_impl=impl, use_rel_pos_bias=rel_pos)
    model = WavLMModel(cfg).eval()
    model.load_state_dict(wavlm_state_dict_from_flax(params), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(wav), pad_mask=torch.from_numpy(mask),
                    output_hidden_states=True)["hidden_states"]
    assert len(got) == len(want) == cfg.num_layers + 1
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g), np.asarray(w), **MODEL_TOL, err_msg=f"tap {i}")


def test_from_flax_raises_on_unknown_path():
    _, params, *_ = _jax_tiny()
    params = dict(params)
    params["extra_head"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="extra_head"):
        wavlm_state_dict_from_flax(params)


def _hf_dir(path, norm="layer", stable=True, fmt="bin", family="wavlm", seed=0):
    """A tiny HF model saved with save_pretrained; fmt "weight_g" rewrites
    the positional conv's weight norm into the older key style."""
    import transformers

    common = dict(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        conv_dim=(16, 16, 16), conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
        conv_bias=True, feat_extract_norm=norm, do_stable_layer_norm=stable,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        mask_time_prob=0.0, mask_feature_prob=0.0, layerdrop=0.0)
    if family == "wavlm":
        hf_cfg = transformers.WavLMConfig(num_buckets=NB, max_bucket_distance=MD, **common)
        cls = transformers.WavLMModel
    else:
        hf_cfg = transformers.Wav2Vec2Config(**common)
        cls = transformers.Wav2Vec2Model
    torch.manual_seed(seed)
    hf = cls(hf_cfg).eval()
    hf.save_pretrained(path, safe_serialization=fmt == "safetensors")
    if fmt == "weight_g":
        sd = torch.load(os.path.join(path, "pytorch_model.bin"), weights_only=True)
        pre = "encoder.pos_conv_embed.conv."
        sd[pre + "weight_g"] = sd.pop(pre + "parametrizations.weight.original0")
        sd[pre + "weight_v"] = sd.pop(pre + "parametrizations.weight.original1")
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    return hf


@pytest.mark.parametrize("norm,stable,fmt", [
    ("layer", True, "bin"), ("group", False, "bin"),
    ("layer", True, "safetensors"), ("layer", True, "weight_g"),
])
def test_load_hf_wavlm_matches_hf_and_jax(tmp_path, norm, stable, fmt):
    hf = _hf_dir(tmp_path, norm, stable, fmt)
    cfg, model = load_hf_wavlm(str(tmp_path))
    assert cfg.use_rel_pos_bias and cfg.attention_impl == "auto"
    wav = np.random.default_rng(0).normal(size=(2, 800)).astype(np.float32)
    with torch.inference_mode():
        got = model(torch.from_numpy(wav), output_hidden_states=True)["hidden_states"]
        want = hf(torch.from_numpy(wav), output_hidden_states=True).hidden_states
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in (
        "hidden_size", "num_layers", "num_heads", "intermediate_size", "conv_dim",
        "conv_kernel", "conv_stride", "conv_bias", "feat_extract_norm",
        "do_stable_layer_norm", "num_conv_pos_embeddings", "num_conv_pos_embedding_groups",
        "num_buckets", "max_bucket_distance", "layer_norm_eps", "use_rel_pos_bias")})
    jx = JaxModel(jcfg).apply({"params": hf_wavlm_to_params(hf.state_dict())},
                              jnp.asarray(wav), output_hidden_states=True)["hidden_states"]
    assert len(got) == len(want) == len(jx)
    for i, (g, w, j) in enumerate(zip(got, want, jx)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5, err_msg=f"tap {i} vs HF")
        np.testing.assert_allclose(_np(g), np.asarray(j), **MODEL_TOL, err_msg=f"tap {i} vs JAX")


def test_config_without_buckets_is_wav2vec2(tmp_path):
    hf = _hf_dir(tmp_path, family="wav2vec2", seed=5)
    with open(tmp_path / "config.json") as f:
        assert not config_from_hf(json.load(f)).use_rel_pos_bias
    cfg, model = load_hf_wavlm(str(tmp_path))
    wav = np.random.default_rng(0).normal(size=(2, 700)).astype(np.float32)
    with torch.inference_mode():
        got = model(torch.from_numpy(wav))["last_hidden_state"]
        want = hf(torch.from_numpy(wav)).last_hidden_state
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("level", ["FRAME", "UTTERANCE"])
def test_extract_audio_features_matches_jax(tmp_path, level):
    """Mixed lengths, batch_size 2 and small buckets: frame-budget chunking,
    per-clip normalisation, padding and the frame mask as in JAX."""
    hf = _hf_dir(tmp_path)
    cfg, model = load_hf_wavlm(str(tmp_path))
    jcfg = JaxConfig.tiny(num_layers=2, conv_bias=True)
    rng = np.random.default_rng(3)
    wavs = [rng.normal(size=(n,)).astype(np.float32) for n in (300, 800, 555, 1200, 90)]
    kw = dict(layer_ids=(-2, -1), feature_level=level, batch_size=2, buckets=(400, 800, 1600))
    got = extract_audio_features(model, cfg, wavs, device="cpu", **kw)
    want = jax_extract(JaxModel(jcfg), hf_wavlm_to_params(hf.state_dict()), jcfg, wavs, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, **MODEL_TOL)


def _write_wav(path, samples):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes())


def test_cli_extract_audio_on_cpu(tmp_path):
    from sdumc_tpu_torch.cli import extract

    _hf_dir(tmp_path / "model")
    audio = tmp_path / "wavs"
    audio.mkdir()
    rng = np.random.default_rng(4)
    for vid, n in (("clip_a", 900), ("clip_b", 1500)):
        _write_wav(audio / f"{vid}.wav", 0.3 * rng.normal(size=n))
    out = extract.main(["audio", "--model_dir", str(tmp_path / "model"), "--audio_dir", str(audio),
                        "--save_dir", str(tmp_path / "out"), "--device", "cpu",
                        "--layer_ids", "-2"])
    save_dir = tmp_path / "out" / "wavlm-large-FRA_-2"
    assert out["save_dir"] == str(save_dir) and out["clips"] == 2 and out["batches"] == 1
    cfg, model = load_hf_wavlm(str(tmp_path / "model"))
    for vid in ("clip_a", "clip_b"):
        feat = np.load(save_dir / f"{vid}.npy")
        wav = read_wav(str(audio / f"{vid}.wav"))
        assert feat.shape == (cfg.output_length(len(wav)), cfg.hidden_size)
        want = extract_audio_features(model, cfg, [wav], layer_ids=(-2,), device="cpu")[0]
        np.testing.assert_allclose(feat, want, rtol=1e-5, atol=1e-5)


def test_cli_refusals_without_a_card(tmp_path, monkeypatch, capsys):
    from sdumc_tpu_torch.cli import extract

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _hf_dir(tmp_path / "model")
    (tmp_path / "wavs").mkdir()
    base = ["audio", "--model_dir", str(tmp_path / "model"), "--audio_dir",
            str(tmp_path / "wavs"), "--save_dir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract.main(base)
    # --dtype bfloat16 runs (it raised before the kernel's bf16 instance),
    # without a card only on --device cpu
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract.main(base + ["--dtype", "bfloat16"])
    out = extract.main(base + ["--device", "cpu", "--dtype", "bfloat16", "--layer_ids", "-2"])
    assert out["clips"] == 0 and os.path.isdir(out["save_dir"])
    assert resolve_attention_impl("auto", torch.device("cpu")) == "einsum"
    assert resolve_attention_impl("auto", torch.device("cpu"), torch.bfloat16) == "flash"
    assert resolve_attention_impl("auto", torch.device("cuda")) == "flash"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        resolve_attention_impl("ring", torch.device("cpu"))
    # every stage of the JAX CLI is ported; an unknown stage prints the stage list
    assert extract.NOT_PORTED == {} and "vision" in extract.STAGES
    capsys.readouterr()
    assert extract.main(["no_such_stage"]) == 1
    printed = capsys.readouterr().out
    assert "unknown stage 'no_such_stage'" in printed
    assert all(f"cli.extract {stage} " in printed for stage in extract.STAGES)
