"""The hierarchical data axis (``parallel.make_hierarchical_mesh``) and the
combined tensor-parallel trunk / data-parallel fusion step
(``parallel.make_tp_dp_dual_step`` on a ``make_mesh`` grid) against the JAX
package on the CPU.

Four real processes over gloo, one rank launch, at ``tests/test_hierarchy.py``'s
sizes (the fusion net at 16 / 32 / 16 -> 32, a global batch of 8, 8 frames;
LLaMA.tiny as the text trunk) and tolerances, with dropout 0 (the port's
random streams are not JAX's): the 2 x 2 hierarchical step (a reduce-scatter
inside each pod of 2, an all-reduce across the pods, an all-gather) equals
the flat 4-rank step and JAX's single-device ``make_train_step`` (the loss
rtol 1e-5, every parameter after the Adam step rtol 1e-4 / atol 1e-6); the
combined step at TP 2 x DP 2 equals the port's TP 1 x DP 1 step and JAX's
``make_tp_dp_dual_step`` on a 1 x 1 mesh (the loss rtol 1e-4, the
parameters rtol 1e-3 / atol 1e-5), the parameters moved, and the two ranks
of each model group hold equal fusion parameters. JAX's tap sum at a bf16
trunk rounds in bf16 (ROADMAP §3); the port's sums in f32.
"""

import concurrent.futures
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sdumc_tpu.core.config import LossConfig as JaxLossConfig
from sdumc_tpu.core.config import ModelConfig as JaxModelConfig
from sdumc_tpu.models.fusion import SDUMCFusion as JaxFusion
from sdumc_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sdumc_tpu.models.llama import LlamaModel as JaxLlamaModel
from sdumc_tpu.parallel import make_tp_dp_dual_step as jax_make_tp_dp_dual_step
from sdumc_tpu.train.state import create_train_state as jax_create_train_state
from sdumc_tpu.train.step import make_train_step as jax_make_train_step
from sdumc_tpu_torch.convert import llama_state_dict_from_flax, state_dict_from_flax
from sdumc_tpu_torch.convert.from_flax import torch_key_for
from sdumc_tpu_torch.core.config import LossConfig, ModelConfig
from sdumc_tpu_torch.models.fusion import SDUMCFusion
from sdumc_tpu_torch.models.llama import LlamaConfig, LlamaModel
from sdumc_tpu_torch.parallel import (DataAxis, make_hierarchical_mesh, make_mesh,
                                      make_tp_dp_dual_step)
from sdumc_tpu_torch.train.state import TrainState, make_optimizer
from tests.test_torch_multihost import run_ranks

torch.set_num_threads(1)

DIMS = (16, 32, 16)
SMALL = dict(general_dim=32, layers=(32, 16), fused_layers=(32, 32), dropout=0.0,
             attn_dropout=0.0)
B, T, LR = 8, 8, 1e-2
TAP_LAYERS = (-4, -3, -2, -1)
HIER_TOL = dict(rtol=1e-4, atol=1e-6)
COMBINED_TOL = dict(rtol=1e-3, atol=1e-5)
# Adam's first step moves an element by lr * g / (|g| + eps): about lr either way, so where
# a gradient is float noise (a bias ahead of a normalisation) the two sides may step apart
ADAM_TOL = dict(rtol=0, atol=2 * LR)
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6        # chip_smoke.py phase 8's gradient rule

_RANK = """
import sys
import torch
torch.set_num_threads(1)
from sdumc_tpu_torch.core.config import LossConfig, ModelConfig
from sdumc_tpu_torch.models.fusion import SDUMCFusion
from sdumc_tpu_torch.models.llama import LlamaConfig
from sdumc_tpu_torch.parallel import (initialize_from_env, make_data_axis,
                                      make_hierarchical_mesh, make_mesh, make_tp_dp_dual_step,
                                      shard_batch, shard_llama_model, shutdown)
from sdumc_tpu_torch.train.state import TrainState, make_optimizer
from sdumc_tpu_torch.train.step import make_train_step


def fusion_state(sd, dims):
    model = SDUMCFusion(ModelConfig(input_dims=tuple(dims), **case["small"]))
    model.load_state_dict(sd, strict=True)
    opt = make_optimizer(model.parameters(), case["lr"], l2=0.0)
    return TrainState(model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0))


work = sys.argv[1]
rank, world = initialize_from_env(device="cpu")
case = torch.load(work + "/case.pt")
out = {}
hier = make_hierarchical_mesh("cpu", 2, 2)
flat = make_data_axis("cpu")
for name, axis in (("hier", hier), ("flat", flat)):
    state = fusion_state(case["fusion"], case["dims"])
    m = make_train_step(state, LossConfig(), seed=0, axis=axis)(
        shard_batch(case["batch"], axis.rank, axis.world))
    out[name] = {"loss": m["loss"].item(), "params": state.model.state_dict(),
                 "grads": {k: p.grad for k, p in state.model.named_parameters()
                           if p.grad is not None}}
data, model_axis = make_mesh("cpu", 2, 2)
trunk = shard_llama_model(case["llama"], LlamaConfig.tiny(), model_axis, trunk=True)
state = fusion_state(case["text_fusion"], case["text_dims"])
m = make_tp_dp_dual_step(trunk, state, LossConfig(), 0, data)(
    shard_batch(case["text_batch"], data.rank, data.world))
out["combined"] = {"loss": m["loss"].item(), "params": state.model.state_dict(),
                   "grads": {k: p.grad for k, p in state.model.named_parameters()
                             if p.grad is not None},
                   "cell": (data.rank, model_axis.rank)}
torch.save(out, work + f"/rank{rank}.pt")
shutdown()
"""


def fusion_state(sd, dims):
    """The port's fusion net at `dims` with `sd`, dropout off, and Adam at
    a constant LR (JAX's ``lambda s: 1e-2``, L2 0); the rank script builds
    the same."""
    model = SDUMCFusion(ModelConfig(input_dims=tuple(dims), **SMALL))
    model.load_state_dict(sd, strict=True)
    opt = make_optimizer(model.parameters(), LR, l2=0.0)
    return TrainState(model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0))


def _jax_fusion(dims):
    model = JaxFusion(JaxModelConfig(input_dims=dims, **SMALL))
    dummy = [jnp.zeros((2, 4, d), jnp.float32) for d in dims]
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *dummy)["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _batch(dims, seed=0):
    rng = np.random.default_rng(seed)
    return {"audio": rng.normal(size=(B, T, dims[0])).astype(np.float32),
            "text": rng.normal(size=(B, T, dims[1])).astype(np.float32),
            "video": rng.normal(size=(B, T, dims[2])).astype(np.float32),
            "feat4": rng.normal(size=(B, T, dims[1])).astype(np.float32),
            "vals": rng.uniform(-3, 3, size=(B,)).astype(np.float32)}


def _jax_step(step, model, params, batch, *args):
    """(loss, the port's state dict of the params after the step, the port
    key of JAX's first leaf: ``tests/test_hierarchy.py`` holds that one)."""
    state = jax_create_train_state(model, params, lambda s: LR, l2=0.0)
    d = {k: jnp.asarray(v) for k, v in batch.items()}
    d["t_max"] = tuple(jnp.int32(T) for _ in range(4))
    state, metrics = step(state, *args, d, jax.random.PRNGKey(1))
    path = jax.tree_util.tree_flatten_with_path(state.params)[0][0][0]
    return (float(metrics["loss"]),
            state_dict_from_flax(jax.tree_util.tree_map(np.asarray, state.params)),
            torch_key_for(tuple(k.key for k in path)))


def _torch_batch(batch):
    return dict({k: torch.from_numpy(v) for k, v in batch.items()}, t_max=(T,) * 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's losses and parameters (the 4-rank launch), the port's
    TP 1 x DP 1 combined step, and JAX's single-device steps."""
    work = tmp_path_factory.mktemp("hierarchy")
    jcfg = JaxLlamaConfig.tiny()
    text_dims = (DIMS[0], jcfg.hidden_size, DIMS[2])
    model, params = _jax_fusion(DIMS)
    tmodel, tparams = _jax_fusion(text_dims)
    batch = _batch(DIMS)
    text_batch = {k: v for k, v in _batch(text_dims, seed=1).items() if k != "text"}
    text_batch["text_ids"] = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    lmodel = JaxLlamaModel(jcfg)
    lparams = lmodel.init(jax.random.PRNGKey(3), input_ids=jnp.asarray(text_batch["text_ids"]))
    lparams = jax.tree_util.tree_map(np.asarray, lparams["params"])
    llama = {k[len("model."):]: v for k, v in
             llama_state_dict_from_flax({"model": lparams}).items()}
    torch.save({"dims": DIMS, "text_dims": text_dims, "small": SMALL, "lr": LR,
                "fusion": state_dict_from_flax(params), "text_fusion": state_dict_from_flax(tparams),
                "llama": llama, "batch": _torch_batch(batch),
                "text_batch": _torch_batch(text_batch)}, work / "case.pt")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, 4, [sys.executable, "-c", _RANK, str(work)])
        jax_single = _jax_step(jax_make_train_step(model, JaxLossConfig()), model, params, batch)
        jax_combined = _jax_step(jax_make_tp_dp_dual_step(lmodel, tmodel, JaxLossConfig()),
                                 tmodel, tparams, text_batch, lparams)
        data, model_axis = make_mesh("cpu", 1, 1)
        trunk = LlamaModel(LlamaConfig.tiny()).eval()
        trunk.load_state_dict(llama, strict=True)
        state = fusion_state(state_dict_from_flax(tparams), text_dims)
        loss = make_tp_dp_dual_step(trunk, state, LossConfig(), 0, data)(
            _torch_batch(text_batch))["loss"].item()
        one = {"loss": loss, "params": state.model.state_dict(),
               "grads": {k: p.grad for k, p in state.model.named_parameters()
                         if p.grad is not None}}
        ranks.result()
    port = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return port, jax_single, jax_combined, one, state_dict_from_flax(tparams)


def _close(got, want, tol, what, keys=None):
    assert got.keys() == want.keys()
    for k in keys or want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=f"{what}: {k}",
                                   **tol)


def _grads_close(got, want, what):
    """Every gradient within GRAD_RTOL of its largest element plus GRAD_ATOL."""
    assert got.keys() == want.keys()
    for k, ref in want.items():
        err = (got[k] - ref).abs().max().item()
        assert err <= GRAD_RTOL * ref.abs().max().item() + GRAD_ATOL, (what, k, err)


@pytest.mark.parametrize("rank", range(4))
def test_hierarchical_step_matches_flat_step_and_jax(runs, rank):
    """The loss rtol 1e-5; the gradients summed hierarchically and flat by
    phase 8's rule; the parameters after the step: JAX's first leaf rtol
    1e-4 / atol 1e-6 (``tests/test_hierarchy.py``'s), every one within
    Adam's sign bound."""
    port, (jax_loss, jax_params, first), _, _, _ = runs
    hier, flat = port[rank]["hier"], port[rank]["flat"]
    assert np.isfinite(hier["loss"])
    np.testing.assert_allclose(hier["loss"], flat["loss"], rtol=1e-5)
    np.testing.assert_allclose(hier["loss"], jax_loss, rtol=1e-5)
    _grads_close(hier["grads"], flat["grads"], "hierarchical vs flat")
    for ref, what in ((flat["params"], "flat"), (jax_params, "JAX")):
        _close(hier["params"], ref, HIER_TOL, f"hierarchical vs {what}", keys=[first])
        _close(hier["params"], ref, ADAM_TOL, f"hierarchical vs {what}")


@pytest.mark.parametrize("rank", range(4))
def test_combined_step_matches_one_process_and_jax(runs, rank):
    """TP 2 x DP 2 against TP 1 x DP 1 and JAX: the loss rtol 1e-4, the
    gradients by phase 8's rule (against the port's), JAX's first leaf rtol
    1e-3 / atol 1e-5, every parameter within Adam's sign bound, and moved."""
    port, _, (jax_loss, jax_params, first), one, before = runs
    got = port[rank]["combined"]
    assert got["cell"] == divmod(rank, 2)
    assert np.isfinite(got["loss"])
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["loss"], jax_loss, rtol=1e-4)
    _grads_close(got["grads"], one["grads"], "TP 2 x DP 2 vs TP 1 x DP 1")
    for ref, what in ((one["params"], "TP 1 x DP 1"), (jax_params, "JAX")):
        _close(got["params"], ref, COMBINED_TOL, f"TP 2 x DP 2 vs {what}", keys=[first])
        _close(got["params"], ref, ADAM_TOL, f"TP 2 x DP 2 vs {what}")
    moved = max((got["params"][k] - v).abs().max().item() for k, v in before.items())
    assert moved > 1e-6


@pytest.mark.parametrize("group", [(0, 1), (2, 3)])
def test_model_group_ranks_hold_equal_fusion_parameters(runs, group):
    """Ranks d * 2 + 0 and d * 2 + 1 ran one fusion step on the same rows
    (the dropout stream of the data rank): equal to the bit."""
    port = runs[0]
    a, b = (port[r]["combined"]["params"] for r in group)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_one_rank_needs_no_group():
    """A 1 x 1 grid and a 1 x 1 hierarchical layout are this process alone,
    with no process group; a larger one raises without one."""
    data, model_axis = make_mesh("cpu", 1, 1)
    assert data == DataAxis() and (model_axis.rank, model_axis.world) == (0, 1)
    assert make_hierarchical_mesh("cpu", 1, 1) == DataAxis()
    with pytest.raises(ValueError, match="needs 4 processes"):
        make_mesh("cpu", 2, 2)
    with pytest.raises(ValueError, match="needs 4 processes"):
        make_hierarchical_mesh("cpu", 2, 2)


def test_jax_bf16_tap_sum_differs_from_the_f32_sum():
    """JAX's combined step sums the taps in the trunk's dtype and widens
    after (``sdumc_tpu/parallel/combined.py:50``): at bf16 that is three
    roundings, farther from the f32 sum of the same bf16 hidden states than
    one rounding of it, and another bf16 value than that rounding in a few
    percent of the elements. The port's ``tap_sum`` at bf16 is the f32
    sum, to the bit (the same order)."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.bfloat16)
    lmodel = JaxLlamaModel(jcfg)
    ids = jnp.asarray(np.random.default_rng(4).integers(0, jcfg.vocab_size, size=(4, 16)))
    lparams = lmodel.init(jax.random.PRNGKey(5), input_ids=ids)["params"]
    hs = lmodel.apply({"params": lparams}, input_ids=ids, output_hidden_states=True)[
        "hidden_states"]
    jax_sum = np.asarray(sum(hs[i] for i in TAP_LAYERS).astype(jnp.float32))
    f32_sum = sum(np.asarray(hs[i]).astype(np.float32) for i in TAP_LAYERS)
    rounded = f32_sum.astype(ml_dtypes.bfloat16).astype(np.float32)
    assert np.abs(jax_sum - f32_sum).max() > np.abs(rounded - f32_sum).max()
    assert (jax_sum != rounded).mean() > 0.02

    trunk = LlamaModel(LlamaConfig.tiny(dtype=torch.bfloat16)).eval()
    llama = llama_state_dict_from_flax({"model": jax.tree_util.tree_map(np.asarray, lparams)})
    trunk.load_state_dict({k[len("model."):]: v for k, v in llama.items()}, strict=True)
    tids = torch.from_numpy(np.array(ids))
    with torch.inference_mode():
        got = trunk(input_ids=tids, tap_sum_layers=TAP_LAYERS)
        ths = trunk(input_ids=tids, output_hidden_states=True)["hidden_states"]
    want = ((ths[0].float() + ths[1].float()) + ths[2].float()) + ths[3].float()
    assert got["tap_sum"].dtype == torch.float32
    assert torch.equal(got["tap_sum"], want)
