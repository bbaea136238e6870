"""``make_train_step(..., remat=True)``: the dual-view loss under
``torch.utils.checkpoint``, on the CPU.

- With the live dropouts, three steps with remat equal three without it to
  the bit: losses, every metric, every gradient and every parameter after
  each update. The checkpointed function seeds the step's generators at its
  entry, so the recompute draws the forward's masks.
- Control: the same checkpoint without that reseed (the generator seeded
  once, before the forward, as the step without remat seeds it) recomputes
  with other masks, and its gradients differ.
- The recompute is real: the model's forward runs twice a step.
- At dropout 0, five steps against JAX's ``make_train_step(remat=True)``
  at ``test_torch_train.py``'s five-step tolerance.
- Two gloo ranks with a data axis: each rank's remat step equals its step
  without remat to the bit (the recompute repeats ``gather_rows``'s
  collective on both ranks), and the ranks hold the same parameters.
"""

import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from sdumc_tpu.core.config import LossConfig as JaxLossConfig
from sdumc_tpu.train.schedule import make_lr_schedule
from sdumc_tpu.train.state import create_train_state as jax_create_train_state
from sdumc_tpu.train.step import make_train_step as jax_make_train_step
from sdumc_tpu_torch.convert import state_dict_from_flax
from sdumc_tpu_torch.core.config import LossConfig, ModelConfig, TrainConfig
from sdumc_tpu_torch.models import get_model
from sdumc_tpu_torch.models.layers import use_generator
from sdumc_tpu_torch.train.state import create_train_state
from sdumc_tpu_torch.train.step import dual_view_loss, make_train_step, step_seed
from tests.test_torch_multihost import run_ranks
from tests.test_torch_train import (DIMS, LOSS, SMALL, _batch, _jax_batch, _jax_model,
                                    _port_batch, _port_model)

torch.set_num_threads(1)

STEPS, LR, SPE = 3, 1e-3, 2


def _model():
    """The small fusion net at ModelConfig's dropout rates (0.3, 0.5)."""
    return get_model(ModelConfig(input_dims=DIMS, **SMALL), torch.Generator().manual_seed(0))


def _twin(model):
    twin = _model()
    twin.load_state_dict(model.state_dict())
    return twin


def _batches(n=STEPS):
    return [_port_batch(_batch(20 + i, lengths=(10 - i % 3, 7 - i % 2, 9, 6 - i % 4)))
            for i in range(n)]


def _grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}


def _run(model, remat, batches):
    state = create_train_state(model, TrainConfig(lr=LR, l2=1e-5), SPE)
    step = make_train_step(state, LossConfig(**LOSS), seed=0, remat=remat)
    out = []
    for b in batches:
        metrics = {k: v.clone() for k, v in step(b).items()}
        out.append((metrics, _grads(model),
                    {k: v.clone() for k, v in model.state_dict().items()}))
    return out


def _assert_equal_runs(a, b):
    for i, ((ma, ga, pa), (mb, gb, pb)) in enumerate(zip(a, b)):
        assert ma.keys() == mb.keys() and ga.keys() == gb.keys()
        for k in ma:
            assert torch.equal(ma[k], mb[k]), (i, k)
        for k in ga:
            assert torch.equal(ga[k], gb[k]), (i, k)
        for k in pa:
            assert torch.equal(pa[k], pb[k]), (i, k)


def test_remat_equals_the_default_step_to_the_bit_with_dropout():
    model = _model()
    assert model.cfg.dropout > 0 and model.cfg.attn_dropout > 0
    batches = _batches()
    ref = _run(_twin(model), False, batches)
    got = _run(_twin(model), True, batches)
    assert len(got) == STEPS
    _assert_equal_runs(got, ref)
    # the dropouts drew: a step with other masks gives another loss
    other = _twin(model)
    state = create_train_state(other, TrainConfig(lr=LR, l2=1e-5), SPE)
    m = make_train_step(state, LossConfig(**LOSS), seed=1, remat=True)(batches[0])
    assert m["loss"].item() != ref[0][0]["loss"].item()


def test_control_checkpoint_without_the_reseed_gives_other_gradients():
    """The step without remat seeds its generator once, before the
    forward; under checkpoint that alone lets the recompute draw the next
    masks: the loss is the same, the gradients are not."""
    batch = _batches(1)[0]
    model = _model()
    ref_model = _twin(model)
    ref_state = create_train_state(ref_model, TrainConfig(lr=LR, l2=1e-5), SPE)
    ref_loss = make_train_step(ref_state, LossConfig(**LOSS), seed=0)(batch)["loss"]
    ref_grads = _grads(ref_model)

    generator = torch.Generator()
    use_generator(model, generator)
    model.train()
    generator.manual_seed(step_seed(0, 0))
    loss, _ = checkpoint(dual_view_loss, model, batch, LossConfig(**LOSS), use_reentrant=False)
    loss.backward()
    assert torch.equal(loss.detach(), ref_loss)
    grads = _grads(model)
    assert grads.keys() == ref_grads.keys()
    differ = [k for k in grads if not torch.allclose(grads[k], ref_grads[k], rtol=1e-3,
                                                     atol=1e-6)]
    assert len(differ) > len(grads) // 2, differ


@pytest.mark.parametrize("remat, calls", [(False, 1), (True, 2)])
def test_remat_recomputes_the_forward(remat, calls):
    """One dual [2B]-row forward a step, twice under remat (the backward's
    recompute)."""
    model = _model()
    seen = []
    model.register_forward_pre_hook(lambda *a: seen.append(1))
    state = create_train_state(model, TrainConfig(lr=LR, l2=1e-5), SPE)
    make_train_step(state, LossConfig(**LOSS), seed=0, remat=remat)(_batches(1)[0])
    assert len(seen) == calls


def test_remat_five_adam_steps_match_jax_remat():
    """JAX's and the port's remat steps at dropout 0, five batches: each
    step's loss rtol 1e-4, the params rtol 1e-3 / atol 2 lr steps, as
    ``test_torch_train.py::test_five_adam_steps_match_jax``."""
    lr, steps, spe = 1e-3, 5, 2
    rates = dict(dropout=0.0, attn_dropout=0.0)
    jmodel, params = _jax_model(**rates)
    jstate = jax_create_train_state(jmodel, params, make_lr_schedule(lr, spe), l2=1e-5)
    jstep = jax_make_train_step(jmodel, JaxLossConfig(**LOSS), remat=True)
    model = _port_model(params, **rates)
    state = create_train_state(model, TrainConfig(lr=lr, l2=1e-5), spe)
    step = make_train_step(state, LossConfig(**LOSS), seed=0, remat=True)
    for i in range(steps):
        b = _batch(10 + i, lengths=(10 - i % 3, 7 - i % 2, 9, 6 - i % 4))
        jstate, jm = jstep(jstate, _jax_batch(b), jax.random.PRNGKey(0))
        m = step(_port_batch(b))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4, err_msg=str(i))
    ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    for key, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), ref[key].numpy(), rtol=1e-3,
                                   atol=2 * lr * steps, err_msg=key)


# one rank: the small net (live dropouts) from the saved state dict, 2 steps
# on its rows of the saved global batches with and without remat; writes
# rank{r}.npz
_RANK = """
import sys
import numpy as np, torch
torch.set_num_threads(1)
from sdumc_tpu_torch.core.config import LossConfig, ModelConfig, TrainConfig
from sdumc_tpu_torch.models import get_model
from sdumc_tpu_torch.parallel import initialize_from_env, make_data_axis, shard_batch, shutdown
from sdumc_tpu_torch.train.state import create_train_state
from sdumc_tpu_torch.train.step import make_train_step

work = sys.argv[1]
rank, world = initialize_from_env(device="cpu")
axis = make_data_axis("cpu")
data = np.load(work + "/case.npz")
sd = {{k[2:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("p/")}}
out = {{}}
for remat in (False, True):
    model = get_model(ModelConfig(input_dims={dims!r}, **{small!r}))
    model.load_state_dict(sd)
    state = create_train_state(model, TrainConfig(lr={lr!r}, l2=1e-5), {spe!r})
    step = make_train_step(state, LossConfig(**{loss!r}), seed=0, axis=axis, remat=remat)
    for i in range({steps!r}):
        batch = {{k: torch.from_numpy(data[f"b{{i}}/{{k}}"])
                  for k in ("audio", "text", "video", "feat4", "vals")}}
        batch["t_max"] = tuple(int(t) for t in data[f"b{{i}}/t_max"])
        metrics = step(shard_batch(batch, rank, world))
        for k, v in metrics.items():
            out[f"{{remat}}/{{i}}/m/{{k}}"] = v.numpy()
        for k, p in model.named_parameters():
            out[f"{{remat}}/{{i}}/g/{{k}}"] = (p.grad if p.grad is not None
                                                else torch.zeros_like(p)).numpy().copy()
    for k, v in model.state_dict().items():
        out[f"{{remat}}/p/{{k}}"] = v.numpy()
np.savez(work + f"/rank{{rank}}.npz", **out)
shutdown()
"""


def test_remat_over_two_gloo_ranks_equals_the_default_step(tmp_path):
    world, steps = 2, 2
    model = _model()
    arrays = {f"p/{k}": v.numpy() for k, v in model.state_dict().items()}
    for i in range(steps):
        a, t, v, f, vals, tmax = _batch(30 + i, B=8, lengths=(10 - i, 7, 9 - i, 6))
        arrays.update({f"b{i}/audio": a, f"b{i}/text": t, f"b{i}/video": v, f"b{i}/feat4": f,
                       f"b{i}/vals": vals, f"b{i}/t_max": np.asarray(tmax)})
    np.savez(tmp_path / "case.npz", **arrays)
    script = _RANK.format(dims=DIMS, small=SMALL, lr=LR, spe=SPE, loss=LOSS, steps=steps)
    run_ranks(world, [sys.executable, "-c", script, str(tmp_path)])
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    for r in ranks:
        default = sorted(k for k in r.files if k.startswith("False/"))
        assert len(default) > steps * len(list(model.parameters()))
        for k in default:
            np.testing.assert_array_equal(r["True/" + k[6:]], r[k], err_msg=k)
    for k in (k for k in ranks[0].files if "/p/" in k):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
