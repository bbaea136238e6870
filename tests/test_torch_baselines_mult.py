"""The port's translation and transformer baseline families (mctn, mult)
against the JAX package, on the CPU, with the helpers and sizes of
``test_torch_baselines.py``; and the sequence families through the CLI.

Forward and training-mode ``model_loss`` to REL_SEQ = 1e-4 of the largest
value (f32 through 6 GRU steps, or MulT's attention stack, in another
summation order); the gradient of ``dual_view_loss`` as there. Training
mode fixes MCTN's teacher-forcing mask with ``mctn_teacher_forcing`` 0 or
1 (all false or all true).
"""

import numpy as np
import pytest
import torch

from sdumc_tpu_torch.core.config import ModelConfig
from tests.test_torch_baselines import (REL_SEQ, T, check_forward, check_gradients,
                                        check_model_loss, count_params, jax_apply, jax_family,
                                        make_batch, port_apply, port_family, run_cli)

torch.set_num_threads(1)

FAMILIES = ("mctn", "mult")


@pytest.mark.parametrize("t_max", [(5, 6, 4), (T, T, T)], ids=["below_T", "equal_T"])
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_jax(name, t_max):
    check_forward(name, REL_SEQ, t_max)


@pytest.mark.parametrize("forcing", [0.0, 1.0], ids=["free_running", "teacher_forced"])
def test_model_loss_in_training_mode_matches_jax_mctn(forcing):
    check_model_loss("mctn", REL_SEQ, mctn_teacher_forcing=forcing)


def test_eval_model_loss_is_jax_s():
    """Eval mode: MFM's loss is the reconstruction alone, MCTN's 0."""
    for name in ("mfm", "mctn"):
        jm, params = jax_family(name)
        b = make_batch(9)
        _, ja = jax_apply(jm, params, b, (5, 6, 4))
        _, ta = port_apply(port_family(name, params), b, (5, 6, 4))
        np.testing.assert_allclose(float(ta["model_loss"]), float(ja["model_loss"]),
                                   rtol=REL_SEQ, atol=0)
    assert float(ja["model_loss"]) == 0.0


@pytest.mark.parametrize("name", FAMILIES)
def test_dual_view_gradients_match_jax(name):
    check_gradients(name, **(dict(mctn_teacher_forcing=1.0) if name == "mctn" else {}))


@pytest.mark.parametrize("name", FAMILIES)
def test_trainable_parameters_are_jax_s(name):
    """MCTN's first encoder is one GRU applied twice, as JAX's."""
    jax_counts, port_counts = count_params(name)
    assert port_counts == jax_counts


def test_train_and_infer_cli_mfn(tmp_path):
    run_cli("mfn", tmp_path)


def test_infer_embedding_dump_runs_a_baseline(tmp_path):
    """cli.infer --savewhole on a seeded mult: the aux streams of both
    views, MulT's fused vector 6 x hidden wide."""
    from sdumc_tpu_torch.cli import infer

    out = infer.main(["--synthetic", "--device", "cpu", "--feat_scale", "16", "--batch_size",
                      "8", "--model", "mult", "--savewhole", "--save_root", str(tmp_path)])
    res = out["results"]
    assert res["full_rep"].shape[1] == 6 * ModelConfig().baseline_hidden_dim
    assert res["missing_rnc"].shape[1] == 64
    assert np.isfinite(res["val_preds_full"]).all()
    assert (tmp_path / "test_embeddings.npz").exists()
