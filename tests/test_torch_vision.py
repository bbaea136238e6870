"""The port's vision stage (``cli.extract vision``: CLIP, DINOv2, VideoMAE,
EVA-02 and the ImageNet ResNet-18) against the JAX package, transformers,
the EVA-02 golden and Pillow, on the CPU at tiny sizes.

Tolerances: the encoders rtol 1e-4 / atol 1e-5 (f32 in both, summed in
another order), EVA-02 against its golden rtol 2e-4 / atol 2e-5 (JAX's own,
``tests/test_eva02.py``), the bicubic resize equal to Pillow's to the bit,
and the rope tables to the bit (the same float64 numpy arithmetic).
Inputs are drawn from numpy seeds; JAX's params are its init with seeded
noise added, so that no zero or unit leaf hides a wrong mapping.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdumc_tpu.convert.torch_resnet import torch_resnet_to_params
from sdumc_tpu.extract import vision_hf as jvision
from sdumc_tpu.models import clip_vit as jclip
from sdumc_tpu.models import dinov2 as jdino
from sdumc_tpu.models import eva02 as jeva
from sdumc_tpu.models import resnet as jresnet
from sdumc_tpu.models import videomae as jvmae
from sdumc_tpu_torch.convert import from_flax, safetensors_io
from sdumc_tpu_torch.convert.hf_clip import load_hf_clip_vision
from sdumc_tpu_torch.convert.hf_dinov2 import load_hf_dinov2
from sdumc_tpu_torch.convert.hf_videomae import load_hf_videomae
from sdumc_tpu_torch.convert.timm_eva02 import load_timm_eva02
from sdumc_tpu_torch.convert.torch_resnet import load_resnet
from sdumc_tpu_torch.extract import image_io
from sdumc_tpu_torch.extract import vision_hf as pvision
from sdumc_tpu_torch.models import clip_vit, dinov2, eva02, resnet, videomae

# several test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
GOLDEN_TOL = dict(rtol=2e-4, atol=2e-5)
NCHW = (0, 3, 1, 2)


def _noisy(tree, seed):
    """Every leaf of a Flax tree plus normal(0, 0.05) noise (seeded)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + rng.normal(0, 0.05, np.shape(x)).astype(np.float32)),
        tree)


def _assert_outputs(got: dict, want: dict, tol=TOL):
    for key, ref in want.items():
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(ref), **tol, err_msg=key)


# ---------------------------------------------------------------- the bicubic resize

def _pattern(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, size=shape + (3,), dtype=np.uint8)
    yy, xx = np.indices(shape)
    if kind == "checker":          # drives the cubic's negative lobes past 0 and 255
        return np.repeat((((yy + xx) % 2) * 255).astype(np.uint8)[..., None], 3, axis=2)
    img = np.zeros(shape + (3,), np.uint8)   # "edges": flat blocks with hard steps
    img[(yy // 5 + xx // 7) % 2 == 0] = (255, 0, 128)
    return img


@pytest.mark.parametrize("kind,shape,size", [
    ("noise", (112, 112), (224, 224)), ("noise", (112, 112), (518, 518)),
    ("checker", (112, 112), (224, 224)), ("checker", (112, 112), (518, 518)),
    ("edges", (112, 112), (224, 224)), ("noise", (300, 300), (112, 112)),
    ("checker", (97, 143), (61, 224)), ("edges", (230, 70), (28, 28)),
    ("noise", (112, 112), (112, 224)),
])
def test_resize_bicubic_is_bit_equal_to_pillow(kind, shape, size):
    img = _pattern(kind, shape)
    want = np.asarray(Image.fromarray(img).resize(size, Image.BICUBIC))
    got = image_io.resize_bicubic(img, size)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_bicubic_lobes_leave_0_255_before_the_clip():
    """The checkerboard's fixed-point sums leave [0, 255 * 2**22] on both
    sides, so the clip at 0 (Pillow's clip8) is what the bit test holds."""
    row = _pattern("checker", (112, 112))[0, :, 0].astype(np.float64)
    acc = image_io._coefficients(112, 224, "bicubic") @ row
    assert acc.min() < 0 and acc.max() > 255 * (1 << image_io.PRECISION_BITS)


# ---------------------------------------------------------------- each encoder against JAX

def _jax_vit(kind):
    """(JAX module, its params, input NHWC / NTHWC, the port's model, the
    family name of from_flax)."""
    rng = np.random.default_rng(1)
    if kind == "clip":
        jm, pm = jclip.CLIPVisionTower(jclip.CLIPVisionConfig.tiny()), clip_vit.CLIPVisionTower(
            clip_vit.CLIPVisionConfig.tiny())
        x = rng.normal(size=(3, 32, 32, 3))
    elif kind.startswith("dinov2"):
        sw = kind.endswith("swiglu")
        jm = jdino.Dinov2Model(jdino.Dinov2Config.tiny(use_swiglu_ffn=sw))
        pm = dinov2.Dinov2Model(dinov2.Dinov2Config.tiny(use_swiglu_ffn=sw))
        x = rng.normal(size=(2, 28, 28, 3))
    elif kind.startswith("videomae"):
        mp = kind.endswith("mean")
        jm = jvmae.VideoMAEModel(jvmae.VideoMAEConfig.tiny(use_mean_pooling=mp))
        pm = videomae.VideoMAEModel(videomae.VideoMAEConfig.tiny(use_mean_pooling=mp))
        x = rng.normal(size=(2, 4, 16, 16, 3))
    else:
        jm, pm = jeva.Eva02Model(jeva.Eva02Config.tiny()), eva02.Eva02Model(eva02.Eva02Config.tiny())
        x = rng.normal(size=(2, 28, 28, 3))
    x = x.astype(np.float32)
    params = _noisy(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2)
    return jm, params, x, pm.eval(), kind.split("_")[0]


@pytest.mark.parametrize("kind", ["clip", "dinov2_gelu", "dinov2_swiglu", "videomae_mean",
                                  "videomae_ln", "eva02"])
def test_vit_matches_jax(kind):
    """Every output of the port's encoder equals JAX's, with JAX's params
    carried by ``*_state_dict_from_flax`` (loaded strictly)."""
    jm, params, x, model, family = _jax_vit(kind)
    convert = {"clip": from_flax.clip_state_dict_from_flax,
               "dinov2": from_flax.dinov2_state_dict_from_flax,
               "videomae": from_flax.videomae_state_dict_from_flax,
               "eva02": from_flax.eva02_state_dict_from_flax}[family]
    model.load_state_dict(convert(params), strict=True)
    want = jm.apply({"params": params}, jnp.asarray(x))
    layout = (0, 1, 4, 2, 3) if family == "videomae" else NCHW
    with torch.no_grad():
        got = model(torch.from_numpy(np.ascontiguousarray(x.transpose(layout))))
    assert set(got) == set(want)
    _assert_outputs(got, want)


def test_videomae_k_has_no_bias_and_q_v_do():
    attn = videomae.VideoMAEModel(videomae.VideoMAEConfig.tiny()).encoder.layer[0].attention.attention
    assert attn.key.bias is None and attn.query.bias is None
    assert attn.q_bias.shape == attn.v_bias.shape == (32,)
    off = videomae.VideoMAEModel(videomae.VideoMAEConfig.tiny(qkv_bias=False))
    assert off.encoder.layer[0].attention.attention.q_bias is None


def test_vit_key_for_refuses_unknown_paths():
    with pytest.raises(KeyError, match="no port key"):
        from_flax.vit_key_for("eva02", ("rope_table",))
    assert (from_flax.vit_key_for("videomae", ("layers_3", "value", "bias"))
            == "encoder.layer.3.attention.attention.v_bias")
    assert (from_flax.vit_key_for("clip", ("pre_layernorm", "scale"))
            == "vision_model.pre_layrnorm.weight")


@pytest.mark.parametrize("grid,hd,ref", [((4, 4), 16, (4, 4)), ((16, 16), 64, (16, 16)),
                                         ((3, 5), 8, None), ((6, 6), 32, (16, 16))])
def test_rope_tables_and_rotation_match_jax(grid, hd, ref):
    sin, cos = eva02.rope_2d(grid, hd, ref)
    jsin, jcos = jeva.rope_2d(grid, hd, ref)
    np.testing.assert_array_equal(sin, jsin)
    np.testing.assert_array_equal(cos, jcos)
    x = np.random.default_rng(3).normal(size=(2, 3, grid[0] * grid[1], hd)).astype(np.float32)
    got = eva02.apply_rope(torch.from_numpy(x), torch.from_numpy(sin), torch.from_numpy(cos))
    want = jeva.apply_rope(jnp.asarray(x), jnp.asarray(jsin), jnp.asarray(jcos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _resnet_variables(cfg, seed=4):
    """JAX ResNet variables with noisy params and positive running variances."""
    x = jnp.zeros((1, 32, 32, 3))
    v = jresnet.ResNetEmbedding(cfg).init(jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(rng.uniform(0.5, 1.5, np.shape(a)) if p[-1].key == "var"
                                 else rng.normal(0, 0.1, np.shape(a)), jnp.float32),
        v["batch_stats"])
    return {"params": _noisy(v["params"], seed), "batch_stats": stats}


@pytest.mark.parametrize("blocks,channels", [((1, 1, 1, 1), (8, 16, 16, 24)),
                                             ((2, 2, 2, 2), (8, 16, 32, 64))])
def test_resnet_matches_jax(blocks, channels):
    jcfg = jresnet.ResNetConfig(blocks=blocks, channels=channels, stem_channels=channels[0])
    variables = _resnet_variables(jcfg)
    model = resnet.ResNetEmbedding(resnet.ResNetConfig(blocks, channels, channels[0])).eval()
    sd = from_flax.resnet_state_dict_from_flax(variables)
    result = model.load_state_dict(sd, strict=False)
    assert result.missing_keys == [] or all(k.endswith("num_batches_tracked")
                                           for k in result.missing_keys)
    assert result.unexpected_keys == []
    x = np.random.default_rng(5).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = jresnet.ResNetEmbedding(jcfg).apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(np.ascontiguousarray(x.transpose(NCHW))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _seeded_resnet_state_dict(cfg, seed=6):
    """A torchvision-layout state dict (with an fc head) from the port's
    ResNetEmbedding: ResNet's init, BN statistics drawn at random."""
    from sdumc_tpu_torch.models.manet import init_weights

    model = init_weights(resnet.ResNetEmbedding(cfg), seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    sd = dict(model.state_dict())
    sd["fc.weight"], sd["fc.bias"] = torch.randn(10, cfg.channels[-1]), torch.randn(10)
    return sd


@pytest.mark.parametrize("layout", ["bare", "state_dict_module"])
def test_resnet_pth_loader_matches_jax(tmp_path, layout, capsys):
    """The port's .pth loader (fc dropped, ``module.`` stripped, widths read
    from the keys) against JAX's converter and model on the same file."""
    cfg = resnet.ResNetConfig.tiny()
    sd = _seeded_resnet_state_dict(cfg)
    blob = (sd if layout == "bare"
            else {"state_dict": {"module." + k: v for k, v in sd.items()}, "epoch": 3})
    torch.save(blob, tmp_path / "r.pth")
    model, report = load_resnet(str(tmp_path / "r.pth"))
    assert report == {"missing": [], "unexpected": []}
    assert model.cfg == cfg and "missing keys []" in capsys.readouterr().out
    jcfg = jresnet.ResNetConfig(blocks=cfg.blocks, channels=cfg.channels,
                                stem_channels=cfg.stem_channels)
    x = np.random.default_rng(7).normal(size=(3, 48, 48, 3)).astype(np.float32)
    want = jresnet.ResNetEmbedding(jcfg).apply(torch_resnet_to_params(sd), jnp.asarray(x),
                                               train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(np.ascontiguousarray(x.transpose(NCHW))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------- against transformers / golden

def _pixels(shape, seed=8):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def _tiny_clip_dir(path, whole: bool):
    import transformers

    vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=4, image_size=32, patch_size=8)
    torch.manual_seed(0)
    if whole:
        text = dict(hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                    num_attention_heads=2, vocab_size=50, max_position_embeddings=16)
        cfg = transformers.CLIPConfig(text_config=text, vision_config=vision, projection_dim=24)
        hf = transformers.CLIPModel(cfg)
    else:
        hf = transformers.CLIPVisionModelWithProjection(
            transformers.CLIPVisionConfig(projection_dim=24, **vision))
    hf.config._attn_implementation = "eager"
    hf.eval().save_pretrained(path)
    return hf


@pytest.mark.parametrize("whole", [True, False])
def test_clip_loader_matches_transformers(tmp_path, whole):
    """A whole ``CLIPModel`` directory (its text tower skipped, the
    projection as wide as the top-level ``projection_dim``) and a
    stand-alone vision tower's, read without transformers, against HF."""
    hf = _tiny_clip_dir(tmp_path, whole)
    weights = safetensors_io.load_hf_weights(str(tmp_path))
    assert any(k.startswith("text_model.") for k in weights) == whole
    cfg, model = load_hf_clip_vision(str(tmp_path))
    assert cfg.projection_dim == 24 and cfg.hidden_act == "quick_gelu"
    assert not any(k.startswith("text") for k in model.state_dict())
    px = _pixels((3, 3, 32, 32))
    with torch.no_grad():
        got = model(px)
        if whole:
            feats = hf.get_image_features(pixel_values=px)
            hidden = hf.vision_model(pixel_values=px).last_hidden_state
        else:
            out = hf(pixel_values=px)
            feats, hidden = out.image_embeds, out.last_hidden_state
    np.testing.assert_allclose(got["image_features"].numpy(), feats.numpy(), **TOL)
    np.testing.assert_allclose(got["last_hidden_state"].numpy(), hidden.numpy(), **TOL)


def test_jax_clip_loader_misreads_a_whole_clip_model(tmp_path):
    """JAX's loader (``CLIPVisionModelWithProjection.from_pretrained``) takes
    the nested ``projection_dim``, which transformers 4.57 writes as its
    default 512, and fails on a whole CLIPModel of another projection
    width; the port reads the top level (ROADMAP section 3)."""
    from sdumc_tpu.convert.hf_clip import load_hf_clip_vision as jax_load

    _tiny_clip_dir(tmp_path, whole=True)
    assert json.loads((tmp_path / "config.json").read_text())["vision_config"][
        "projection_dim"] == 512
    with pytest.raises(RuntimeError, match="size mismatch"):
        jax_load(str(tmp_path))
    assert load_hf_clip_vision(str(tmp_path))[0].projection_dim == 24


@pytest.mark.parametrize("swiglu", [False, True])
def test_dinov2_loader_matches_transformers(tmp_path, swiglu):
    import transformers

    torch.manual_seed(1)
    hf_cfg = transformers.Dinov2Config(hidden_size=24 if swiglu else 32, num_hidden_layers=2,
                                       num_attention_heads=4, image_size=28, patch_size=7,
                                       use_swiglu_ffn=swiglu, attn_implementation="eager")
    hf = transformers.Dinov2Model(hf_cfg).eval()
    with torch.no_grad():      # LayerScale and positions away from their init
        for name, p in hf.named_parameters():
            if "lambda1" in name or "position" in name or "cls_token" in name:
                p.normal_(0.5, 0.2)
    hf.save_pretrained(tmp_path)
    cfg, model = load_hf_dinov2(str(tmp_path))
    assert cfg.use_swiglu_ffn == swiglu and cfg.image_size == 28
    px = _pixels((2, 3, 28, 28))
    with torch.no_grad():
        got, ref = model(px), hf(pixel_values=px)
    np.testing.assert_allclose(got["last_hidden_state"].numpy(), ref.last_hidden_state.numpy(),
                               **TOL)
    np.testing.assert_allclose(got["pooled"].numpy(), ref.pooler_output.numpy(), **TOL)


@pytest.mark.parametrize("pretraining", [False, True])
def test_videomae_loader_matches_transformers(tmp_path, pretraining):
    """``VideoMAEModel`` (mean pooling, no final LN) and the published
    ``VideoMAEForPreTraining`` layout (encoder under ``videomae.`` with a
    final LN, the decoder dropped by the loader)."""
    import transformers

    torch.manual_seed(2)
    hf_cfg = transformers.VideoMAEConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        image_size=16, patch_size=8, num_frames=4, tubelet_size=2,
        use_mean_pooling=not pretraining, decoder_hidden_size=16, decoder_num_hidden_layers=1,
        decoder_num_attention_heads=2, decoder_intermediate_size=32, attn_implementation="eager")
    hf = (transformers.VideoMAEForPreTraining if pretraining
          else transformers.VideoMAEModel)(hf_cfg).eval()
    with torch.no_grad():      # the q / v biases away from their zero init
        for name, p in hf.named_parameters():
            if name.endswith(("q_bias", "v_bias")):
                p.normal_(0.0, 0.5)
    hf.save_pretrained(tmp_path)
    cfg, model = load_hf_videomae(str(tmp_path))
    assert cfg.use_mean_pooling == (not pretraining)
    video = _pixels((2, 4, 3, 16, 16))
    with torch.no_grad():
        ref = (hf.videomae if pretraining else hf)(pixel_values=video).last_hidden_state
        got = model(video)
    np.testing.assert_allclose(got["last_hidden_state"].numpy(), ref.numpy(), **TOL)
    np.testing.assert_allclose(got["pooled"].numpy(), ref.mean(dim=1).numpy(), **TOL)


def _golden():
    from pathlib import Path

    blob = np.load(Path(__file__).resolve().parent / "goldens" / "eva02_tiny.npz")
    return blob, {k[3:]: blob[k] for k in blob.files if k.startswith("sd/")}


@pytest.mark.parametrize("layout", ["safetensors", "bin_model_prefix"])
def test_eva02_loader_matches_golden(tmp_path, layout):
    """The golden's timm-schema state dict, as ``model.safetensors`` or as a
    ``pytorch_model.bin`` with ``model.``-prefixed keys, through the port's
    loader (config inferred from the shapes) against the golden's torch
    forward, at JAX's own tolerance."""
    blob, sd = _golden()
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    if layout == "safetensors":
        safetensors_io.save_file(tensors, str(tmp_path / "model.safetensors"))
    else:
        torch.save({"model." + k: v for k, v in tensors.items()}, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps({"architecture": "eva02"}))
    cfg, model = load_timm_eva02(str(tmp_path))
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads) == (128, 2, 2)
    assert (cfg.image_size, cfg.patch_size, cfg.mlp_hidden) == (28, 7, 64)
    with torch.no_grad():
        got = model(torch.from_numpy(blob["pixels"]))
    _assert_outputs(got, {"last_hidden_state": blob["last_hidden_state"],
                          "pooled": blob["pooled"]}, GOLDEN_TOL)


# ---------------------------------------------------------------- the stage, against JAX's

FRAMES = {"v_a": 12, "v_b": 1, "v_empty": 0, "v_long": 23}   # step 5: 3, 1, 0 and 5 frames


@pytest.fixture(scope="module")
def faces(tmp_path_factory):
    """112x112 face crops (24-bit BMP, one PNG) in one folder per video."""
    root = tmp_path_factory.mktemp("faces")
    rng = np.random.default_rng(9)
    for vid, n in FRAMES.items():
        (root / vid).mkdir()
        for i in range(n):
            img = Image.fromarray(rng.integers(0, 256, size=(112, 112, 3), dtype=np.uint8))
            img.save(root / vid / f"frame_{i:04d}.{'png' if i == 3 else 'bmp'}")
    return root


def _write_model(kind, path):
    """A directory (or .pth) that both stages read, and the flags naming it."""
    import transformers

    torch.manual_seed(3)
    if kind == "clip":
        _tiny_clip_dir(path, whole=False)
    elif kind == "dinov2":
        transformers.Dinov2Model(transformers.Dinov2Config(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4, image_size=28,
            patch_size=7)).save_pretrained(path)
    elif kind == "videomae":
        transformers.VideoMAEModel(transformers.VideoMAEConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            image_size=16, patch_size=8, num_frames=4, tubelet_size=2)).save_pretrained(path)
    elif kind == "eva02":
        path.mkdir()
        torch.save({k: torch.from_numpy(v) for k, v in _golden()[1].items()},
                   path / "pytorch_model.bin")
    else:
        path.mkdir()
        torch.save(_seeded_resnet_state_dict(resnet.ResNetConfig()), path / "r18.pth")
        return ["--checkpoint", str(path / "r18.pth")]
    return ["--model_dir", str(path)]


@pytest.mark.parametrize("kind,level", [("clip", "FRAME"), ("clip", "UTTERANCE"),
                                        ("dinov2", "FRAME"), ("videomae", "FRAME"),
                                        ("videomae", "UTTERANCE"), ("eva02", "FRAME"),
                                        ("imagenet", "FRAME")])
def test_cli_extract_vision_matches_jax(tmp_path, faces, kind, level):
    """``cli.extract vision --device cpu`` against JAX's stage on the same
    crops and weights: every file, with the every-5th-frame resample, the
    last partial batch (batch 2), the one-frame and empty videos, and
    VideoMAE's windows with their repeated tail (5 frames, windows of 4)."""
    from sdumc_tpu_torch.cli import extract

    flags = ["--model", kind, *_write_model(kind, tmp_path / "m"), "--face_dir", str(faces),
             "--feature_level", level, "--batch_size", "2"]
    jvision.main(flags + ["--save_dir", str(tmp_path / "jax")])
    out = extract.main(["vision", *flags, "--save_dir", str(tmp_path / "port"), "--device", "cpu"])
    dim = {"clip": 24, "imagenet": 512, "eva02": 128}.get(kind, 32)
    assert out["videos"] == len(FRAMES) and out["frames"] == 9 and out["dim"] == dim
    for vid in FRAMES:
        got = np.load(tmp_path / "port" / f"{vid}.npy")
        want = np.load(tmp_path / "jax" / f"{vid}.npy")
        rows = {"v_a": 3, "v_b": 1, "v_empty": 1, "v_long": 5}[vid]
        if kind == "videomae":
            rows = {"v_long": 2}.get(vid, 1)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.shape == ((rows, dim) if level == "FRAME" else (dim,))
        if vid == "v_empty":
            assert not got.any()
        np.testing.assert_allclose(got, want, **TOL)


def test_load_normalized_matches_jax(faces):
    """The port's crop path (its BMP / PNG reader, the bicubic resize, /255,
    mean and std) equals JAX's PIL path to the bit."""
    for path in sorted(faces.glob("v_long/*"))[:5]:
        for size, mean, std in ((224, pvision.CLIP_MEAN, pvision.CLIP_STD),
                                (518, pvision.IMAGENET_MEAN, pvision.IMAGENET_STD)):
            np.testing.assert_array_equal(pvision.load_normalized(str(path), size, mean, std),
                                          jvision.load_normalized(str(path), size, mean, std))


@pytest.mark.parametrize("n,level", [(0, "FRAME"), (1, "FRAME"), (4, "FRAME"), (0, "UTTERANCE"),
                                     (1, "UTTERANCE"), (4, "UTTERANCE")])
def test_save_embeddings_matches_jax(tmp_path, n, level):
    emb = np.random.default_rng(n).normal(size=(n, 6)).astype(np.float32)
    pvision.save_embeddings(str(tmp_path / "p.npy"), emb, 6, level)
    jvision.save_embeddings(str(tmp_path / "j.npy"), emb, 6, level)
    got, want = np.load(tmp_path / "p.npy"), np.load(tmp_path / "j.npy")
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert pvision.resample_frames(list(range(11)), 5) == jvision.resample_frames(list(range(11)), 5)


def test_imagenet_without_checkpoint_is_seeded(tmp_path, faces, capsys):
    """``--model imagenet`` without ``--checkpoint`` runs ResNet's init with
    seed 0, says so, and gives the same files twice; without a card and
    without ``--device cpu`` the stage raises, and a ViT family needs
    ``--model_dir``."""
    from sdumc_tpu_torch.cli import extract

    argv = ["vision", "--model", "imagenet", "--face_dir", str(faces), "--resample_step", "12"]
    runs = [extract.main(argv + ["--save_dir", str(tmp_path / d), "--device", "cpu"])
            for d in ("a", "b")]
    assert "seeded weights (ResNet's init, seed 0)" in capsys.readouterr().out
    assert runs[0]["frames"] == 4 and runs[0]["dim"] == 512
    for vid in FRAMES:
        np.testing.assert_array_equal(np.load(tmp_path / "a" / f"{vid}.npy"),
                                      np.load(tmp_path / "b" / f"{vid}.npy"))
    with pytest.raises(ValueError, match="--model_dir is required"):
        extract.main(["vision", "--model", "dinov2", "--face_dir", str(faces),
                      "--save_dir", str(tmp_path / "c"), "--device", "cpu"])
    import unittest.mock

    with unittest.mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            extract.main(argv + ["--save_dir", str(tmp_path / "d")])


def test_every_jax_stage_is_ported():
    """The port routes every stage that the JAX package's extraction CLI
    routes (read from its source), ``vision`` the last of them."""
    import re
    from pathlib import Path

    from sdumc_tpu_torch.cli import extract

    src = (Path(__file__).resolve().parent.parent / "sdumc_tpu" / "cli" / "extract.py").read_text()
    jax_stages = set(re.findall(r'stage == "(\w+)"', src))
    assert "vision" in jax_stages and jax_stages == set(extract.STAGES)
    assert extract.NOT_PORTED == {}
