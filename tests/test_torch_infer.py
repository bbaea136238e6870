"""The port's inference slice as a whole: ``run_eval`` against the JAX
package's ``run_eval`` on one in-memory dataset, and the port's
``cli.infer`` end to end on the CPU.

The JAX side is driven through ``run_eval(make_eval_step(model), params,
ds, cfg, mesh=None)`` directly (its CLI would build a device mesh). The
port gets the JAX params through ``state_dict_from_flax``. Tolerance rtol
1e-4 / atol 1e-5 on the predictions: f32 on both sides, summed in another
order through the whole net.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.core.config import DataConfig as JaxDataConfig
from sdumc_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from sdumc_tpu.core.config import ModelConfig as JaxModelConfig
from sdumc_tpu.core.config import PathsConfig as JaxPathsConfig
from sdumc_tpu.data.pipeline import MoseiDataset as JaxMoseiDataset
from sdumc_tpu.models.fusion import SDUMCFusion as JaxFusion
from sdumc_tpu.train.loop import run_eval as jax_run_eval
from sdumc_tpu.train.step import make_eval_step as jax_make_eval_step
from sdumc_tpu_torch.cli import infer
from sdumc_tpu_torch.convert import state_dict_from_flax
from sdumc_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig, PathsConfig
from sdumc_tpu_torch.data.pipeline import MoseiDataset
from sdumc_tpu_torch.models.fusion import SDUMCFusion
from sdumc_tpu_torch.train.loop import run_eval
from sdumc_tpu_torch.train.step import make_eval_step

DIMS = (24, 48, 24, 48)        # audio, text, video, feat4
BUCKETS = (8, 16, 32, 64)


class ArraySource:
    """In-memory feature source: clip name -> [T, D] array."""

    def __init__(self, arrays):
        self.arrays = arrays

    def get(self, clip):
        return self.arrays[clip]

    @property
    def dim(self):
        return next(iter(self.arrays.values())).shape[-1]


def _dataset(n=10, seed=0):
    rng = np.random.default_rng(seed)
    names = [f"clip_{i}" for i in range(n)]
    ranges = {"audio": (5, 60), "text": (3, 14), "video": (4, 30), "feat4": (2, 9)}
    sources = {}
    for (key, (lo, hi)), dim in zip(ranges.items(), DIMS):
        sources[key] = ArraySource({
            name: rng.normal(size=(int(rng.integers(lo, hi + 1)), dim)).astype(np.float32)
            for name in names})
    labels = [{"emo": 0.0, "val": float(np.round(rng.uniform(-3, 3), 2))} for _ in names]
    return names, labels, sources


def test_run_eval_matches_jax():
    names, labels, sources = _dataset()
    jcfg = JaxExperimentConfig(
        paths=JaxPathsConfig(),
        data=JaxDataConfig(batch_size=4, length_buckets=BUCKETS),
        model=JaxModelConfig(input_dims=DIMS[:3], general_dim=256))
    jmodel = JaxFusion(jcfg.model)
    dummy = [jnp.zeros((2, 8, d), jnp.float32) for d in DIMS[:3]]
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3), *dummy)["params"]
    ref = jax_run_eval(jax_make_eval_step(jmodel), params,
                       JaxMoseiDataset(names, labels, sources), jcfg, mesh=None)

    cfg = ExperimentConfig(paths=PathsConfig(),
                           data=DataConfig(batch_size=4, length_buckets=BUCKETS),
                           model=ModelConfig(input_dims=DIMS[:3]))
    model = SDUMCFusion(cfg.model)
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    got = run_eval(make_eval_step(model), MoseiDataset(names, labels, sources), cfg, "cpu")

    assert got["names"] == ref["names"] == names       # 3 batches, the last partial
    np.testing.assert_array_equal(got["val_labels"], ref["val_labels"])
    for key in ("val_preds_full", "val_preds_missing"):
        assert got[key].shape == (len(names),)
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, atol=1e-5, err_msg=key)
    for key in ("metric_full", "metric_missing"):
        assert got[key].keys() == ref[key].keys()
        for m in ("mse", "mae", "corr"):
            np.testing.assert_allclose(got[key][m], ref[key][m], rtol=1e-3, atol=1e-5)


def _write_dataset(root, rng, n_per_split=(6, 4, 5)):
    """An on-disk dataset: per-clip npy dirs and the label npz."""
    names = {"audio": "a_feat", "text": "t_feat", "video": "v_feat", "feat4": "f_feat"}
    feat_dir = root / "features" / "CMU-MOSEI"
    corpora = {}
    for split, n in zip(("train", "val", "test"), n_per_split):
        corpora[split] = {f"{split}{i}": {"emo": 0.0, "val": float(rng.uniform(-3, 3))}
                          for i in range(n)}
    for (key, name), dim in zip(names.items(), DIMS):
        (feat_dir / name).mkdir(parents=True)
        for corpus in corpora.values():
            for clip in corpus:
                t = int(rng.integers(2, 40))
                np.save(feat_dir / name / f"{clip}.npy", rng.normal(size=(t, dim)).astype(np.float32))
    (root / "labels").mkdir()
    np.savez_compressed(root / "labels" / "CMU-MOSEI.npz",
                        **{f"{s}_corpus": np.array(c, dtype=object) for s, c in corpora.items()})
    return ["--audio_feature", names["audio"], "--text_feature", names["text"],
            "--video_feature", names["video"], "--feat4_feature", names["feat4"]]


def test_infer_cli_end_to_end_on_cpu(tmp_path, monkeypatch):
    """npy feature store -> seeded model -> a .pt checkpoint -> both views ->
    metrics, and the --savewhole 8-stream dump."""
    rng = np.random.default_rng(0)
    flags = _write_dataset(tmp_path / "data", rng)
    monkeypatch.setenv("SDUMC_DATA_DIR", str(tmp_path / "data"))
    common = flags + ["--batch_size", "2", "--layers", "16,8", "--device", "cpu"]

    out = infer.main(common)
    assert np.isfinite(out["full"]["mse"]) and np.isfinite(out["missing"]["mae"])
    assert out["results"]["val_preds_full"].shape == (5,)

    model = SDUMCFusion(ModelConfig(input_dims=DIMS[:3], layers=(16, 8)),
                        torch.Generator().manual_seed(9))
    ckpt = tmp_path / "best.pt"
    torch.save({"epoch": 1, "state_dict": {f"module.{k}": v for k, v in model.state_dict().items()}},
               ckpt)
    dumped = infer.main(common + ["--checkpoint", str(ckpt), "--savewhole",
                                  "--save_root", str(tmp_path / "saved")])
    dump = np.load(tmp_path / "saved" / "test_embeddings.npz")
    for stream, width in (("full_rep", 8), ("missing_rep", 8), ("full_rnc", 64),
                          ("missing_rnc", 64), ("text_rep_query_full", 256),
                          ("text_rep_query_missing", 256), ("text_rep_full", 8),
                          ("text_rep_missing", 8)):
        assert dump[stream].shape[0] == 5 and dump[stream].shape[-1] == width, stream
        assert np.isfinite(dump[stream]).all(), stream
    # the embedding pass (two single views) and the fused eval agree
    fused = infer.main(common + ["--checkpoint", str(ckpt)])
    np.testing.assert_allclose(dumped["results"]["val_preds_full"],
                               fused["results"]["val_preds_full"], rtol=1e-5, atol=1e-6)


def test_infer_without_cuda_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        infer.main(["--synthetic"])


def test_infer_rejects_bfloat16_features():
    with pytest.raises(NotImplementedError, match="bfloat16"):
        infer.main(["--synthetic", "--device", "cpu", "--feature_dtype", "bfloat16"])
