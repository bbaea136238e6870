"""The port's recurrent baseline families with a memory (mfn, graph_mfn,
mfm) against the JAX package, on the CPU, with the helpers and sizes of
``test_torch_baselines.py`` (mctn and mult: ``test_torch_baselines_mult.py``).

Forward and training-mode ``model_loss`` to REL_SEQ = 1e-4 of the largest
value (f32 through 6 recurrent steps in another summation order); the
gradient of ``dual_view_loss`` as there. Training mode fixes MFM's random
draws with ``mfm_mmd_w`` 0 (the prior samples weigh nothing).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.models import baselines_seq as jax_seq
from sdumc_tpu_torch.core.config import ModelConfig
from sdumc_tpu_torch.models import baselines_seq, get_model
from tests.test_torch_baselines import (REL_SEQ, T, check_adam, check_bf16, check_forward,
                                        check_gradients, check_model_loss, count_params)

torch.set_num_threads(1)

SEQUENCE = ("mfn", "graph_mfn", "mfm")


@pytest.mark.parametrize("t_max", [(5, 6, 4), (T, T, T)], ids=["below_T", "equal_T"])
@pytest.mark.parametrize("name", SEQUENCE)
def test_forward_matches_jax(name, t_max):
    check_forward(name, REL_SEQ, t_max)


def test_model_loss_in_training_mode_matches_jax_mfm():
    check_model_loss("mfm", REL_SEQ, mfm_mmd_w=0.0)


@pytest.mark.parametrize("name", SEQUENCE)
def test_dual_view_gradients_match_jax(name):
    check_gradients(name, **(dict(mfm_mmd_w=0.0) if name == "mfm" else {}))


def test_five_adam_steps_match_jax_mfn():
    check_adam("mfn")


@pytest.mark.parametrize("name", SEQUENCE)
def test_trainable_parameters_are_jax_s(name):
    """The same trainable tensors as JAX: the cells carry flax's one bias
    per gate (the hidden side of an LSTM gate; GRU's ir, iz, in and hn)."""
    jax_counts, port_counts = count_params(name)
    assert port_counts == jax_counts


def test_mfn_fresh_init_has_flax_s_distributions():
    """At the default widths: zero biases, input kernels with std
    1 / sqrt(fan_in), orthogonal recurrent kernels (W W^T = I)."""
    model = get_model(ModelConfig(name="mfn"), torch.Generator().manual_seed(2))
    recurrent = 0
    for name, p in model.named_parameters():
        w = p.detach().double()
        if name.endswith("bias"):
            assert torch.count_nonzero(w) == 0, name
        elif ".lstm_" in name and name.split(".")[-2].startswith("h"):
            torch.testing.assert_close(w @ w.T, torch.eye(w.shape[0], dtype=w.dtype),
                                       rtol=0, atol=1e-5)
            recurrent += 1
        else:
            std = w.std().item() * np.sqrt(w.shape[1])
            assert abs(std - 1.0) < max(0.1, 4 / np.sqrt(w.numel())), (name, std)
    assert recurrent == 12


# ------------------------------------------------------------------ helpers

def test_rbf_mmd_matches_jax():
    rng = np.random.default_rng(11)
    x, y = rng.normal(size=(9, 5)).astype(np.float32), rng.normal(size=(9, 5)).astype(np.float32)
    ref = float(jax_seq._rbf_mmd(jnp.asarray(x), jnp.asarray(y)))
    got = baselines_seq._rbf_mmd(torch.from_numpy(x), torch.from_numpy(y)).item()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("t_max, t_out", [(37, 32), (50, 50), (9, 32), (1, 8), (0, 8), (None, 32)])
def test_resample_time_matches_jax(t_max, t_out):
    """f32 and bf16 input (JAX widens bf16 at the interpolation weights)."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(3, 50, 4)).astype(np.float32)
    tj = None if t_max is None else jnp.int32(t_max)
    for dtype, tdtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        xj = jnp.asarray(x, dtype)
        ref = np.asarray(jax_seq.resample_time(xj, tj, t_out))
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdtype)
        got = baselines_seq.resample_time(xt, t_max, t_out)
        assert got.dtype == torch.float32 and ref.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- bf16, CLI

def test_bf16_batch_matches_jax_mfn():
    """A bf16 batch widens at the resample, as in JAX; f32 after it."""
    check_bf16("mfn", REL_SEQ)
