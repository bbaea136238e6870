"""sdumc_tpu_torch's visual stage (MANet, its converters, the image reader
and resize, the OpenFace readers and ``cli.extract visual``) against the JAX
package and Pillow on the CPU, the same numpy inputs on both sides.

Tolerances: MANet embeddings and logits rtol 2e-3 / atol 2e-4 (those of
``tests/test_manet.py``: f32 through about 20 convolutions, NHWC against
NCHW); decoded pixels, the resize, ``load_face`` and the crops equal to the
bit; the converters' round trip exact; the OpenFace readers equal.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdumc_tpu.convert.torch_manet import torch_manet_to_params
from sdumc_tpu.extract import manet_train as jtrain
from sdumc_tpu.extract import visual as jvisual
from sdumc_tpu.models.manet import MANet as JaxMANet
from sdumc_tpu.models.manet import MANetConfig as JaxMANetConfig
from sdumc_tpu_torch.convert import manet_state_dict_from_flax
from sdumc_tpu_torch.extract import image_io, manet_train, visual
from sdumc_tpu_torch.models.manet import MANet, MANetConfig, init_weights

TOL = dict(rtol=2e-3, atol=2e-4)


def seeded_state_dict(seed=0, num_classes=7, layers=(2, 2, 2, 2)):
    """A reference-format MANet state dict: ResNet init, BN scale / bias and
    running statistics drawn at random (so inference BN is exercised)."""
    model = init_weights(MANet(MANetConfig(layers=layers, num_classes=num_classes)), seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return model.state_dict()


@pytest.fixture(scope="module")
def variables():
    """JAX MANet variables (its own converter on a seeded reference-format
    state dict)."""
    return torch_manet_to_params(seeded_state_dict())


def _port(variables, num_classes=7):
    model = MANet(MANetConfig(num_classes=num_classes)).eval()
    result = model.load_state_dict(manet_state_dict_from_flax(variables), strict=False)
    assert result.missing_keys == [] and result.unexpected_keys == []
    return model


def test_manet_embedding_and_logits_match_jax(variables):
    """Full width (layers 2,2,2,2, 7 classes, 224x224), batch 2, BN
    statistics randomised; and the converters' round trip."""
    port = _port(variables)
    back = torch_manet_to_params(port.state_dict())
    same = jax.tree_util.tree_map(lambda a, b: np.array_equal(a, b), back, variables)
    assert all(jax.tree_util.tree_leaves(same))
    x = (np.random.default_rng(0).normal(size=(2, 224, 224, 3)) * 0.5).astype(np.float32)
    jm = JaxMANet(JaxMANetConfig())
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
        emb = port(xt).numpy()
        l1, l2 = port(xt, return_embedding=False)
    want = jm.apply(variables, jnp.asarray(x))
    assert emb.shape == want.shape == (2, 1024)
    np.testing.assert_allclose(emb, np.asarray(want), **TOL)
    w1, w2 = jm.apply(variables, jnp.asarray(x), return_embedding=False)
    np.testing.assert_allclose(l1.numpy(), np.asarray(w1), **TOL)
    np.testing.assert_allclose(l2.numpy(), np.asarray(w2), **TOL)


def test_load_manet_reads_the_reference_format(tmp_path, capsys):
    """``{"state_dict"}`` with ``module.`` keys or a bare dict; strict=False
    with the missing / unexpected keys reported; classes from fc_1."""
    from sdumc_tpu_torch.convert.torch_manet import load_manet

    sd = seeded_state_dict(seed=2, num_classes=5)
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}, "epoch": 3,
                "best_acc": 0.5}, tmp_path / "a.pth")
    torch.save({**sd, "junk.weight": torch.zeros(1)}, tmp_path / "b.pth")
    a, report = load_manet(str(tmp_path / "a.pth"))
    assert report == {"missing": [], "unexpected": []} and a.fc_1.out_features == 5
    b, report = load_manet(str(tmp_path / "b.pth"))
    assert report["unexpected"] == ["junk.weight"] and "junk.weight" in capsys.readouterr().out
    for key, val in a.state_dict().items():
        assert torch.equal(val, sd[key]) and torch.equal(b.state_dict()[key], val), key


# ---------------------------------------------------------------- image input

def _pil_rgb(path):
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def _no_fallback(path, fmt):
    raise AssertionError(f"{path} ({fmt}) fell back to Pillow")


def _write_top_down_bmp(path, rgb):
    """A 24-bit BI_RGB BMP stored top-down (negative height), rows padded."""
    h, w, _ = rgb.shape
    stride = (3 * w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = rgb[..., ::-1].reshape(h, 3 * w)
    header = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54) + header + rows.tobytes())


@pytest.mark.parametrize("kind", ["bmp24", "bmp32", "bmp_top_down", "png_rgb", "png_rgba",
                                  "png_grey"])
def test_reader_matches_pillow(tmp_path, kind, monkeypatch):
    """The port's own decoder (the Pillow fallback is disabled here)."""
    monkeypatch.setattr(image_io, "_read_with_pillow", _no_fallback)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(37, 53, 4), dtype=np.uint8)
    img[:12] = np.linspace(0, 255, 53).astype(np.uint8)[None, :, None]    # smooth rows
    path = tmp_path / f"x.{kind[:3]}"
    if kind == "bmp_top_down":
        _write_top_down_bmp(path, img[..., :3])
    else:
        mode, arr = {"bmp24": ("RGB", img[..., :3]), "bmp32": ("RGBA", img),
                     "png_rgb": ("RGB", img[..., :3]), "png_rgba": ("RGBA", img),
                     "png_grey": ("L", img[..., 0])}[kind]
        Image.fromarray(arr, mode).save(path)
    got = image_io.read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, _pil_rgb(path))


@pytest.mark.parametrize("shape", [(112, 112), (224, 224), (300, 300), (97, 143), (230, 70)])
def test_resize_is_bit_equal_to_pillow(shape):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=shape + (3,), dtype=np.uint8)
    img[: shape[0] // 2] = np.linspace(0, 255, shape[1]).astype(np.uint8)[None, :, None]
    for size in ((224, 224), (61, 224)):
        want = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))
        np.testing.assert_array_equal(image_io.resize_bilinear(img, size), want)


def test_load_face_and_crops_match_jax(tmp_path, monkeypatch):
    """``load_face`` on a 112x112 BMP (OpenFace's default) equals JAX's PIL
    path; ``random_resized_crop_flip`` equals JAX's for the same seeds."""
    monkeypatch.setattr(image_io, "_read_with_pillow", _no_fallback)
    img = np.random.default_rng(3).integers(0, 256, size=(112, 112, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "f.bmp")
    face = visual.load_face(str(tmp_path / "f.bmp"))
    want = jvisual.load_face(str(tmp_path / "f.bmp"))
    assert face.dtype == np.float32 and face.shape == (224, 224, 3)
    np.testing.assert_array_equal(face, want)
    for seed in range(6):
        got = manet_train.random_resized_crop_flip(np.random.default_rng(seed), face)
        ref = jtrain.random_resized_crop_flip(np.random.default_rng(seed), face)
        np.testing.assert_array_equal(got, ref)


def test_other_formats_go_to_pillow(tmp_path, monkeypatch):
    """JPEG is Pillow's; where Pillow is missing the error names the
    format."""
    import builtins

    img = np.random.default_rng(4).integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "f.jpg")
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "f.jpg")),
                                  _pil_rgb(tmp_path / "f.jpg"))
    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match="reading JPEG images needs Pillow"):
        image_io.read_image(str(tmp_path / "f.jpg"))


# ---------------------------------------------------------------- the visual CLI

def test_cli_extract_visual_matches_jax(tmp_path, variables, monkeypatch):
    """``cli.extract visual --device cpu`` on 24-bit BMP frames (a
    ``module.``-prefixed ``{"state_dict"}`` checkpoint) against JAX's
    extract_video_embeddings on JAX's load_face; an empty video gives
    zeros [1, 1024]; without --device cpu and no card, it raises."""
    from sdumc_tpu_torch.cli import extract

    sd = manet_state_dict_from_flax(variables)
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, tmp_path / "m.pth")
    rng = np.random.default_rng(5)
    frames = {"vid_a": 3, "vid_b": 5, "vid_c": 0}
    for vid, n in frames.items():
        (tmp_path / "faces" / vid).mkdir(parents=True)
        for i in range(n):
            img = rng.integers(0, 256, size=(112, 112, 3), dtype=np.uint8)
            Image.fromarray(img).save(tmp_path / "faces" / vid / f"frame_{i:03d}.bmp")
    argv = ["visual", "--checkpoint", str(tmp_path / "m.pth"), "--face_dir",
            str(tmp_path / "faces"), "--save_dir", str(tmp_path / "out"), "--batch_size", "4"]
    out = extract.main(argv + ["--device", "cpu"])
    assert out["videos"] == 3 and out["frames"] == 8 and out["save_dir"].endswith("manet_FRA")
    jm = JaxMANet(JaxMANetConfig())
    for vid, n in frames.items():
        got = np.load(tmp_path / "out" / "manet_FRA" / f"{vid}.npy")
        if not n:
            assert got.shape == (1, 1024) and not got.any()
            continue
        paths = visual.sample_frame_paths(str(tmp_path / "faces" / vid))
        want = jvisual.extract_video_embeddings(
            jm, variables, [jvisual.load_face(p) for p in paths], batch_size=4)
        assert got.shape == (n, 1024) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract.main(argv)


@pytest.mark.parametrize("policy", ["all", "uniform", "head", "center"])
def test_sample_frame_paths_matches_jax(tmp_path, policy):
    for i in range(23):
        (tmp_path / f"{i:03d}.bmp").touch()
    assert (visual.sample_frame_paths(str(tmp_path), policy, 8)
            == jvisual.sample_frame_paths(str(tmp_path), policy, 8))


# ---------------------------------------------------------------- OpenFace readers

def test_openface_readers_match_jax(tmp_path):
    """read_hog on a written .hog; read_csv (the port's csv module against
    JAX's pandas) on a float table and an all-integer one, from start_idx."""
    from sdumc_tpu.extract import openface as jopenface
    from sdumc_tpu_torch.extract import openface

    rng = np.random.default_rng(6)
    cols, rows, ch, n_frames = 2, 3, 4, 5
    feats = rng.normal(size=(n_frames, cols * rows * ch)).astype(np.float32)
    with open(tmp_path / "c.hog", "wb") as f:
        for i in range(n_frames):
            f.write(struct.pack("3if", cols, rows, ch, float(i % 2)) + feats[i].tobytes())
    for got, want in zip(openface.read_hog(str(tmp_path / "c.hog")),
                         jopenface.read_hog(str(tmp_path / "c.hog"))):
        np.testing.assert_array_equal(got, want)
    table = rng.normal(size=(6, 7))
    with open(tmp_path / "f.csv", "w") as f:
        f.write("frame, face_id, timestamp, confidence, success, gaze_0_x, gaze_0_y\n")
        for i, r in enumerate(table):
            f.write(f"{i + 1}, 0, {0.04 * i:.3f}, " + ", ".join(f"{x:.6f}" for x in r[3:]) + "\n")
    with open(tmp_path / "i.csv", "w") as f:
        f.write("a,b,c\n1,2,3\n4,5,6\n")
    for name, start in (("f.csv", 3), ("f.csv", 0), ("i.csv", 1)):
        got = openface.read_csv(str(tmp_path / name), start)
        want = jopenface.read_csv(str(tmp_path / name), start)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)
