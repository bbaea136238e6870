"""Each plain reference agrees with the program's plain path at toy widths
on the CPU (the test imports both; the reference modules import nothing of
the program), and the references import nothing of it."""

from __future__ import annotations

import ast
import pathlib

import numpy as np
import torch

from benchmark.lib import seeds, spec, traffic, weights
from benchmark.lib import fusion_setup as fs
from benchmark.reference import fusion as rf
from benchmark.reference import wavlm as rw
from benchmark.reference.precision import Precision, round_tf32
from benchmark.tests import tiny

CPU = torch.device("cpu")


def test_references_import_nothing_of_the_program():
    for path in pathlib.Path(rf.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("sdumc_tpu_torch", "sdumc_tpu", "jax", "flax"), \
                    (path.name, n)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -11, 3.0e38])
    r = round_tf32(x)
    assert r[0] == 1.0
    assert r[1] == 1.0                          # a tie rounds to even
    assert r[2] == 1.0 + 2 ** -9
    assert r[3] == -1.0
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)


def _fusion_setup(tmp_seed=5):
    _, cell, cfg = tiny.cell("fusion-train-mosei")
    p = cell["traffic_params"]
    store = fs.make_store(cfg, p, tmp_seed, CPU, 24)
    return cfg, p, store


def test_fusion_eval_matches_the_program():
    from sdumc_tpu_torch.data.pipeline import BatchIterator
    from sdumc_tpu_torch.train.step import batch_to_device_dict, make_eval_step

    cfg, p, store = _fusion_setup()
    try:
        model = fs.model(cfg, 5, CPU)
        it = iter(BatchIterator(fs.dataset(store), 6, shuffle=False,
                                buckets=tuple(cfg["length_buckets"])))
        batch = next(it)
        v0, v1 = make_eval_step(model)(batch_to_device_dict(batch, CPU))
        r0, r1 = rf.eval_preds(fs.state_dict(cfg, 5, CPU), fs.reference_batch(store, range(6), cfg, CPU),
                               cfg, Precision("f32"))
        torch.testing.assert_close(v0, r0, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(v1, r1, rtol=1e-5, atol=1e-6)
    finally:
        store.tmp.cleanup()


def test_fusion_train_steps_match_the_program():
    """Three steps of the program's train step against the reference's,
    the same dropout masks drawn on both sides."""
    from sdumc_tpu_torch.core.config import LossConfig, TrainConfig
    from sdumc_tpu_torch.data.pipeline import BatchIterator
    from sdumc_tpu_torch.train.state import create_train_state
    from sdumc_tpu_torch.train.step import batch_to_device_dict, make_train_step

    cfg, p, store = _fusion_setup()
    try:
        model = fs.model(cfg, 5, CPU)
        s = cfg["schedule"]
        state = create_train_state(model, TrainConfig(lr=cfg["lr"], l2=cfg["l2"],
                                                      warmup_epochs=s["warmup_epochs"]), 4)
        step = make_train_step(state, LossConfig(**cfg["loss"]), 77)
        it = iter(BatchIterator(fs.dataset(store), 6, shuffle=True, seed=11, epoch=0,
                                buckets=tuple(cfg["length_buckets"]), drop_remainder=True))
        losses = [float(step(batch_to_device_dict(next(it), CPU))["loss"]) for _ in range(3)]
        order = rf.epoch_order(24, 11, 0)
        batches = [fs.reference_batch(store, order[i * 6:(i + 1) * 6], cfg, CPU) for i in range(3)]
        params = fs.state_dict(cfg, 5, CPU)
        r_losses, _ = rf.train_steps(params, batches, cfg, 77, 4, Precision("f32"))
        np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
        for k, v in model.named_parameters():
            torch.testing.assert_close(v.detach(), params[k], rtol=1e-4, atol=1e-6)
    finally:
        store.tmp.cleanup()


def test_wavlm_tap_matches_the_program_batched_and_padded():
    from benchmark.entries.wavlm_extract import model_config
    from sdumc_tpu_torch.extract.audio import extract_audio_features
    from sdumc_tpu_torch.models.wavlm import WavLMModel

    _, cell, cfg = tiny.cell("wavlm-extract-mosei")
    mcfg = model_config(cfg)
    with torch.device("meta"):
        model = WavLMModel(mcfg)
    sd = weights.state_dict(rw.weight_layout(cfg), seeds.derive(3, "weights"), CPU)
    model.load_state_dict(sd, assign=True)
    pool = traffic.wave_pool(cell["traffic_params"], 3, CPU)
    request = traffic.wave_requests(cell["traffic_params"], 3, 1)[0]
    waves = traffic.waves_of(pool, request)
    feats = extract_audio_features(model.eval(), mcfg, waves, layer_ids=(cfg["tap"],),
                                   batch_size=4, device=CPU)
    params = weights.state_dict(rw.weight_layout(cfg), seeds.derive(3, "weights"), CPU)
    for wave, f in zip(waves, feats):
        want = rw.forward_tap(params, cfg, wave, Precision("f32"), cfg["tap"] % 4).numpy()
        assert f.shape == want.shape == (rw.output_frames(cfg, len(wave)), cfg["hidden_size"])
        np.testing.assert_allclose(f, want, rtol=1e-4, atol=1e-4)


def test_weight_layouts_match_the_program_state_dicts():
    from benchmark.entries.wavlm_extract import model_config
    from sdumc_tpu_torch.core.config import ModelConfig
    from sdumc_tpu_torch.models.fusion import SDUMCFusion
    from sdumc_tpu_torch.models.wavlm import WavLMModel

    fcfg, wcfg = spec.config("sdumc-fusion"), spec.config("wavlm-large")
    with torch.device("meta"):
        wavlm = WavLMModel(model_config(wcfg))
        fusion = SDUMCFusion(ModelConfig(input_dims=tuple(fcfg["input_dims"])))
    for model, layout in ((wavlm, rw.weight_layout(wcfg)), (fusion, rf.weight_layout(fcfg))):
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert want == {n: tuple(s) for n, s, _, _ in layout}
