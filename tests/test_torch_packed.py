"""The port's packed feature store and its production input path against
the JAX package, on the CPU.

Seeded numpy clips (varied lengths, one utterance-level [D] clip, an
all-zero channel, bf16 rounding ties) go through the JAX function and the
port's: ``pack_features`` writes byte-identical stores at each dtype, and
each package reads the other's; the batch fill and the int8 scales, the
all-packed ``BatchIterator``, ``dequant_features`` and the bf16 cast of
``batch_to_device_dict`` are equal to the bit. Eval on an int8 store tracks
the f32 store at the JAX package's bound; a last eval batch of 2 at batch 4
on an int8 store runs in the port and raises in the JAX package. Last, the
CLI: ``cli.extract pack`` then ``cli.train`` and ``cli.infer --savewhole``
with ``--device cpu`` on a tiny packed dataset.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.core.config import DataConfig as JaxDataConfig
from sdumc_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from sdumc_tpu.core.config import ModelConfig as JaxModelConfig
from sdumc_tpu.data.packed import PackedSource as JaxPackedSource
from sdumc_tpu.data.packed import batch_scales as jax_batch_scales
from sdumc_tpu.data.packed import fill_batch_from_packed as jax_fill
from sdumc_tpu.data.packed import pack_features as jax_pack
from sdumc_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from sdumc_tpu.data.pipeline import MoseiDataset as JaxDataset
from sdumc_tpu.models.fusion import SDUMCFusion as JaxFusion
from sdumc_tpu.train.loop import run_eval as jax_run_eval
from sdumc_tpu.train.step import batch_to_device_dict as jax_batch_to_device_dict
from sdumc_tpu.train.step import dequant_features as jax_dequant
from sdumc_tpu.train.step import make_eval_step as jax_make_eval_step
from sdumc_tpu_torch.cli import extract
from sdumc_tpu_torch.convert import state_dict_from_flax
from sdumc_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig
from sdumc_tpu_torch.data.collate import Batch
from sdumc_tpu_torch.data.packed import (PackedSource, batch_scales, bf16_bits,
                                         fill_batch_from_packed, pack_features)
from sdumc_tpu_torch.data.pipeline import BatchIterator, MoseiDataset, build_sources
from sdumc_tpu_torch.models.fusion import SDUMCFusion
from sdumc_tpu_torch.train import loop
from sdumc_tpu_torch.train.step import batch_to_device_dict, dequant_features, make_eval_step

# several test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

DTYPES = ("float32", "bfloat16", "int8")
MODALITIES = ("audio", "text", "video", "feat4")
DIMS = {"audio": 24, "text": 40, "video": 24, "feat4": 40}
# the feature names of DataConfig: the feat4 one holds "[...]"
FEATURES = {"audio": DataConfig.audio_feature, "text": DataConfig.text_feature,
            "video": DataConfig.video_feature, "feat4": DataConfig.feat4_feature}
LENGTHS = (5, 17, 1, 30, 9, 12, 3, 25, 8, 14)      # 17, 30 and 25 overflow a 16 bucket


def write_clips(path, dim, lengths=LENGTHS, seed=0, prefix="clip"):
    """Seeded f32 clips {prefix}{i:02d}.npy [T, dim] under `path`, one of
    them a [dim] utterance vector, one channel all zero, and bf16 rounding
    ties; returns the clip names."""
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = []
    for i, t in enumerate(lengths):
        a = (rng.normal(size=(t, dim)) * 2).astype(np.float32)
        a[:, 3] = 0.0
        a[0, :4] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(2 + 2 ** -7), 0.0]   # ties to even
        name = f"{prefix}{i:02d}"
        np.save(path / f"{name}.npy", a[0] if t == 1 else a)
        names.append(name)
    return names


def _exts(dtype):
    return (".bin", ".json", ".scales.bin") if dtype == "int8" else (".bin", ".json")


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{dtype: (jax prefix, port prefix)} of one clip directory named with
    glob metacharacters, packed by each package at each dtype."""
    root = tmp_path_factory.mktemp("packed")
    src = root / "vicuna-wav+prompt[take_generate_wordembed_-4]"
    names = write_clips(src, 24)
    out = {}
    for dtype in DTYPES:
        jax_pack(str(src), str(root / f"jax_{dtype}"), dtype=dtype)
        pack_features(str(src), str(root / f"port_{dtype}"), dtype=dtype)
        out[dtype] = (str(root / f"jax_{dtype}"), str(root / f"port_{dtype}"))
    return names, out


def _payload(a) -> np.ndarray:
    """A payload array as numpy, bf16 (ml_dtypes) as its uint16 bits."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_features_is_byte_identical_to_jax(stores, dtype):
    names, out = stores
    jax_prefix, port_prefix = out[dtype]
    for ext in _exts(dtype):
        with open(jax_prefix + ext, "rb") as a, open(port_prefix + ext, "rb") as b:
            assert a.read() == b.read(), ext
    with open(port_prefix + ".json") as f:
        assert list(json.load(f)["index"]) == names


@pytest.mark.parametrize("dtype", DTYPES)
def test_stores_read_across_packages(stores, dtype):
    """The port reads the JAX package's store and the JAX package the
    port's: payloads, f32 views (bf16 widened, int8 dequantised), lengths,
    entries and scales equal."""
    names, out = stores
    jax_prefix, port_prefix = out[dtype]
    for jax_src, port_src in ((JaxPackedSource(port_prefix), PackedSource(jax_prefix)),
                              (JaxPackedSource(jax_prefix), PackedSource(port_prefix))):
        assert port_src.dim == jax_src.dim == 24
        np.testing.assert_array_equal(port_src.lengths_for(names), jax_src.lengths_for(names))
        np.testing.assert_array_equal(port_src.entry_arrays(names[::-1]),
                                      jax_src.entry_arrays(names[::-1]))
        for n in names:
            assert port_src.length_of(n) == jax_src.length_of(n)
            np.testing.assert_array_equal(port_src.get_raw(n), _payload(jax_src.get_raw(n)))
            got, ref = port_src.get(n), np.asarray(jax_src.get(n)).astype(np.float32)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, ref)
            if dtype == "int8":
                np.testing.assert_array_equal(port_src.scales_for(n), jax_src.scales_for(n))
        if dtype == "int8":
            np.testing.assert_array_equal(port_src.scales_matrix(), jax_src.scales_matrix())
        else:
            assert port_src.scales_matrix() is None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bucket", [16, 32])
def test_fill_batch_and_scales_match_jax(stores, dtype, bucket):
    """The batch fill in the store's dtype, clips longer than the bucket
    mean-pooled in f32 and cast back (bf16 to nearest even, int8 toward
    zero), and the int8 scales: equal to JAX's."""
    names, out = stores
    jax_src, src = JaxPackedSource(out[dtype][0]), PackedSource(out[dtype][1])
    pick = names[::-1][:7]
    got, lens = fill_batch_from_packed(src, pick, bucket)
    ref, ref_lens = jax_fill(jax_src, pick, bucket)
    assert got.dtype == src.payload_dtype and got.shape == (7, bucket, 24)
    np.testing.assert_array_equal(got, _payload(ref))
    np.testing.assert_array_equal(lens, ref_lens)
    if dtype == "int8":
        np.testing.assert_array_equal(batch_scales(src, pick), jax_batch_scales(jax_src, pick))


def _write_store(root, dtype, names_lengths=LENGTHS):
    """Four modality stores (FEATURES' names) packed at `dtype` under
    `root`, from seeded clips; returns the clip names."""
    for i, key in enumerate(MODALITIES):
        src = root / "npy" / FEATURES[key]
        names = write_clips(src, DIMS[key], names_lengths, seed=10 + i, prefix="c")
        pack_features(str(src), str(root / FEATURES[key]), dtype=dtype)
    return names


def _labels(names, seed=5):
    rng = np.random.default_rng(seed)
    return [{"emo": 0.0, "val": float(np.round(rng.uniform(-3, 3), 2))} for _ in names]


def _jax_sources(root):
    return {k: JaxPackedSource(str(root / FEATURES[k]), FEATURES[k]) for k in MODALITIES}


def _port_sources(root):
    return {k: PackedSource(str(root / FEATURES[k]), FEATURES[k]) for k in MODALITIES}


@pytest.mark.parametrize("dtype", DTYPES)
def test_batch_iterator_on_packed_store_matches_jax(tmp_path, dtype):
    """An all-packed dataset through both BatchIterators (shuffled, buckets
    8 / 16, batches of 4, 4 and 2): arrays in the store's dtype, t_max,
    lengths, labels, names and the int8 scales equal."""
    names = _write_store(tmp_path, dtype)
    labels = _labels(names)
    kw = dict(shuffle=True, seed=3, epoch=1, buckets=(8, 16), prefetch=0)
    ref = list(JaxBatchIterator(JaxDataset(names, labels, _jax_sources(tmp_path)), 4, **kw))
    got = list(BatchIterator(MoseiDataset(names, labels, _port_sources(tmp_path)), 4, **kw))
    assert [b.size for b in got] == [4, 4, 2]
    for g, r in zip(got, ref):
        for key in MODALITIES:
            np.testing.assert_array_equal(getattr(g, key), _payload(getattr(r, key)), err_msg=key)
        assert g.t_max == r.t_max and g.names == r.names
        for key in ("lengths", "vals", "emos"):
            np.testing.assert_array_equal(getattr(g, key), getattr(r, key), err_msg=key)
        if dtype == "int8":
            assert g.scales.keys() == r.scales.keys() == set(MODALITIES)
            for key in MODALITIES:
                np.testing.assert_array_equal(g.scales[key], r.scales[key])
        else:
            assert g.scales is None and r.scales is None


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_generic_path_on_packed_store_matches_jax(tmp_path, dtype):
    """--feat_scale 2 takes the generic path on both sides: each clip from
    get() (an int8 clip dequantised to f32 on the host), compressed and
    collated in f32. (A bf16 store differs here by design: the JAX package
    compresses the bf16 clip in bf16 arithmetic, the port in f32 on the
    widened clip.)"""
    names = _write_store(tmp_path, dtype)
    labels = _labels(names)
    kw = dict(shuffle=False, buckets=(8, 16), prefetch=0)
    ref = list(JaxBatchIterator(JaxDataset(names, labels, _jax_sources(tmp_path), 2), 4, **kw))
    got = list(BatchIterator(MoseiDataset(names, labels, _port_sources(tmp_path), 2), 4, **kw))
    for g, r in zip(got, ref):
        for key in MODALITIES:
            assert getattr(g, key).dtype == np.float32
            np.testing.assert_array_equal(getattr(g, key), getattr(r, key), err_msg=key)
        assert g.t_max == r.t_max and g.scales is None


def test_build_sources_prefers_a_packed_store(tmp_path):
    """{features_dir}/{name}.bin + .json win over {features_dir}/{name}/."""
    from sdumc_tpu_torch.core.config import PathsConfig
    from sdumc_tpu_torch.data.feature_store import NpyDirSource

    _write_store(tmp_path, "bfloat16")
    (tmp_path / (FEATURES["video"] + ".json")).unlink()
    (tmp_path / FEATURES["video"]).mkdir()
    sources = build_sources(DataConfig(), PathsConfig(features_dir=str(tmp_path)))
    assert {k: type(s) for k, s in sources.items()} == {
        "audio": PackedSource, "text": PackedSource, "video": NpyDirSource,
        "feat4": PackedSource}
    assert sources["feat4"].dtype_name == "bfloat16"


def test_dequant_features_is_bit_equal_to_jax():
    rng = np.random.default_rng(7)
    batch = {"vals": rng.normal(size=(3,)).astype(np.float32)}
    for k, d in zip(MODALITIES, (24, 40, 24, 40)):
        batch[k] = rng.integers(-127, 128, size=(3, 11, d)).astype(np.int8)
        batch[k + "_scale"] = (rng.uniform(0.001, 0.05, size=(3, d))).astype(np.float32)
    ref = jax_dequant({k: jnp.asarray(v) for k, v in batch.items()})
    got = dequant_features({k: torch.from_numpy(v) for k, v in batch.items()})
    for k in MODALITIES:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[k].view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(ref[k]).view(np.uint16), err_msg=k)
    plain = {k: torch.from_numpy(batch[k]) for k in MODALITIES}
    assert dequant_features(plain) is plain          # no scales: unchanged


def _f32_batch(seed=8, B=3):
    rng = np.random.default_rng(seed)
    arrays = []
    for d in (24, 40, 24, 40):
        a = (rng.normal(size=(B, 6, d)) * 3).astype(np.float32)
        a[0, 0, :6] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 3.0e38, 1e-30, -0.0]
        arrays.append(a)
    return Batch(*arrays, t_max=(6, 6, 6, 6), lengths=np.full((4, B), 6, np.int32),
                 emos=np.zeros(B, np.float32), vals=rng.normal(size=(B,)).astype(np.float32),
                 names=[str(i) for i in range(B)])


def test_batch_to_device_dict_bf16_cast_matches_jax():
    """feature_dtype="bfloat16" on an f32 batch gives JAX's bf16 bits (round
    to nearest even, ties and overflow included); a bf16 store's batch
    ships its bits as bf16 whatever feature_dtype says, and an int8 store's
    its codes and scales."""
    batch = _f32_batch()
    jbatch = dataclasses.replace(batch)
    ref = jax_batch_to_device_dict(jbatch, None, feature_dtype="bfloat16")
    got = batch_to_device_dict(batch, "cpu", "bfloat16")
    for k in MODALITIES:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[k].view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(ref[k]).view(np.uint16), err_msg=k)
    assert got["vals"].dtype == torch.float32 and got["t_max"] == (6, 6, 6, 6)
    assert batch_to_device_dict(batch, "cpu")["audio"].dtype == torch.float32

    stored = dataclasses.replace(batch, **{k: bf16_bits(getattr(batch, k)) for k in MODALITIES})
    for feature_dtype in ("float32", "bfloat16"):
        d = batch_to_device_dict(stored, "cpu", feature_dtype)
        for k in MODALITIES:
            assert torch.equal(d[k], got[k]), k

    codes = {k: np.ones((3, 6, d), np.int8) for k, d in zip(MODALITIES, (24, 40, 24, 40))}
    scales = {k: np.full((3, d), 0.5, np.float32) for k, d in zip(MODALITIES, (24, 40, 24, 40))}
    d = batch_to_device_dict(dataclasses.replace(batch, **codes, scales=scales), "cpu", "bfloat16")
    for k in MODALITIES:
        assert d[k].dtype == torch.int8 and d[k + "_scale"].dtype == torch.float32
        assert dequant_features(d)[k].float().eq(0.5).all()


def _eval_models():
    """(jax model, jax params, port model) at DIMS, the published widths."""
    import jax

    dims = tuple(DIMS[k] for k in ("audio", "text", "video"))
    jm = JaxFusion(JaxModelConfig(input_dims=dims))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              *[jnp.zeros((2, 4, d), jnp.float32) for d in dims])["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = SDUMCFusion(ModelConfig(input_dims=dims)).eval()
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    return jm, params, port


def test_eval_on_int8_store_tracks_f32_store(tmp_path):
    """The port's dual-view eval on the int8 store against the f32 store:
    within 5% of the largest prediction (the JAX package's bound for the
    same comparison, tests/test_int8_store.py); and against the JAX
    package's int8 eval (its default bf16 path): rtol 2e-2 / atol 2e-3,
    the JAX package's bf16 bound."""
    jm, params, port = _eval_models()
    step = make_eval_step(port)
    outs = {}
    for dtype in ("float32", "int8"):
        root = tmp_path / dtype
        names = _write_store(root, dtype)
        labels = _labels(names)
        it = BatchIterator(MoseiDataset(names, labels, _port_sources(root)), 8,
                           shuffle=False, buckets=(16, 64), prefetch=0)
        outs[dtype] = [v.numpy() for v in step(batch_to_device_dict(next(iter(it)), "cpu"))]
        if dtype == "int8":
            jit = JaxBatchIterator(JaxDataset(names, labels, _jax_sources(root)), 8,
                                   shuffle=False, buckets=(16, 64), prefetch=0)
            ref = jax_make_eval_step(jm)(params, jax_batch_to_device_dict(next(iter(jit))))
            for got, want in zip(outs[dtype], ref):
                np.testing.assert_allclose(got, np.asarray(want), rtol=2e-2, atol=2e-3)
    for a, b in zip(outs["float32"], outs["int8"]):
        assert np.abs(a - b).max() / (np.abs(a).max() + 1e-9) < 0.05


def test_last_int8_eval_batch_of_two_pads_its_scales(tmp_path):
    """6 clips at batch 4 on an int8 store: the last batch holds 2 clips.
    The JAX package's run_eval raises there (its _pad_partial pads the
    codes, not the scales); the port's pads both, and its predictions for
    the two clips equal those of a full batch of the same rows."""
    names = _write_store(tmp_path, "int8", LENGTHS[:6])
    labels = _labels(names)
    jm, params, port = _eval_models()
    jcfg = JaxExperimentConfig(data=JaxDataConfig(batch_size=4, length_buckets=(16, 64)))
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_run_eval(jax_make_eval_step(jm), params,
                     JaxDataset(names, labels, _jax_sources(tmp_path)), jcfg)

    cfg = ExperimentConfig(data=DataConfig(batch_size=4, length_buckets=(16, 64)))
    sources = _port_sources(tmp_path)
    res = loop.run_eval(make_eval_step(port), MoseiDataset(names, labels, sources), cfg, "cpu")
    # the padded batch repeats its last row: the same batch, built full
    rows = [4, 5, 5, 5]
    full = loop.run_eval(make_eval_step(port), MoseiDataset(
        [names[i] for i in rows], [labels[i] for i in rows], sources), cfg, "cpu")
    for key in ("val_preds_full", "val_preds_missing"):
        assert res[key].shape == (6,)
        np.testing.assert_array_equal(res[key][4:], full[key][:2])


def test_embedding_pass_on_int8_store_dequantises(tmp_path):
    """cli.infer --savewhole's pass (two single views) on an int8 store
    dequantises as the eval step does: its predictions equal run_eval's
    fused pair to 1e-6 of the largest. The JAX package's pass does not
    dequantise, and raises on an int8 store (the model's compute dtype
    follows the int8 codes)."""
    from sdumc_tpu.cli.infer import run_embedding_eval as jax_embedding_eval
    from sdumc_tpu_torch.cli.infer import run_embedding_eval

    names = _write_store(tmp_path, "int8", LENGTHS[:6])
    labels = _labels(names)
    jm, params, port = _eval_models()
    jcfg = JaxExperimentConfig(data=JaxDataConfig(batch_size=4, length_buckets=(16, 64)))
    with pytest.raises(ValueError, match="inexact"):
        jax_embedding_eval(jm, params, JaxDataset(names, labels, _jax_sources(tmp_path)),
                           jcfg)
    cfg = ExperimentConfig(data=DataConfig(batch_size=4, length_buckets=(16, 64)))
    ds = MoseiDataset(names, labels, _port_sources(tmp_path))
    dump = run_embedding_eval(port, ds, cfg, torch.device("cpu"))
    ref = loop.run_eval(make_eval_step(port), ds, cfg, "cpu")
    for key in ("val_preds_full", "val_preds_missing"):
        assert dump[key].shape == (6,)
        np.testing.assert_allclose(dump[key], ref[key], rtol=0, atol=1e-6 * np.abs(ref[key]).max())


def write_dataset(root, dtype, splits=(("train", 8), ("val", 4), ("test", 6))):
    """A tiny dataset in the layout PathsConfig.from_env reads under `root`:
    the four stores packed by ``cli.extract pack`` at `dtype` under
    features/CMU-MOSEI (DataConfig's feature names) and labels/CMU-MOSEI.npz."""
    features = root / "features" / "CMU-MOSEI"
    features.mkdir(parents=True)
    split_of = [s for s, n in splits for _ in range(n)]
    lengths = [3 + (7 * i) % 29 for i in range(len(split_of))]
    for i, key in enumerate(MODALITIES):
        src = root / "npy" / FEATURES[key]
        names = write_clips(src, DIMS[key], lengths, seed=20 + i, prefix="v")
        assert extract.main(["pack", "--src_dir", str(src), "--out_prefix",
                             str(features / FEATURES[key]), "--dtype", dtype]) == 0
    corpora = {f"{s}_corpus": {} for s, _ in splits}
    for name, split, label in zip(names, split_of, _labels(names)):
        corpora[f"{split}_corpus"][name] = label
    (root / "labels").mkdir()
    np.savez(root / "labels" / "CMU-MOSEI.npz", **corpora)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_cli_pack_train_infer_on_cpu(tmp_path, monkeypatch, dtype):
    """cli.extract pack, cli.train --feature_dtype bfloat16 for one epoch and
    cli.infer on its best_full.pt, all --device cpu, on a bf16 and on an
    int8 store: finite losses, the logged best MAE reproduced (the same
    CPU ops on the same batches: rel 1e-9), and with --savewhole (two
    single views in place of the fused pair: abs 1e-3) the dump's shapes."""
    from sdumc_tpu_torch.cli import infer, train

    write_dataset(tmp_path / "data", dtype)
    monkeypatch.setenv("SDUMC_DATA_DIR", str(tmp_path / "data"))
    common = ["--device", "cpu", "--feature_dtype", "bfloat16", "--batch_size", "4",
              "--layers", "16,8", "--save_root", str(tmp_path / "saved")]
    result = train.main(common + ["--epochs", "1", "--checkpoint_dir", str(tmp_path / "ck")])
    (h,) = result["history"]
    assert all(np.isfinite(h[k]) for k in ("train_loss", "train_mse_full", "eval_mse_full"))
    best = ["--checkpoint", str(tmp_path / "ck" / "best_full.pt")]
    out = infer.main(common + best)
    assert out["full"]["mae"] == pytest.approx(result["best_full"]["mae"], rel=1e-9)
    out = infer.main(common + best + ["--savewhole"])
    assert out["full"]["mae"] == pytest.approx(result["best_full"]["mae"], abs=1e-3)
    dump = np.load(tmp_path / "saved" / "test_embeddings.npz")
    assert dump["full_rep"].shape == (6, 8) and np.isfinite(dump["missing_rnc"]).all()
