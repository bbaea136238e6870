"""Data-parallel training of the four baseline families whose ``model_loss``
couples the batch's rows (misa, mmim, mfm, mctn), the port against JAX.

Two processes over gloo on the CPU (``test_torch_multihost.run_ranks``),
each holding half the rows of one global batch at the sizes of
``test_torch_baselines.py`` (dims 16 / 32 / 16, B = 12, T = 6, hidden 8,
align_t 6, dropout 0), take one train step of each family:

- with the draws neutralised (``mfm_mmd_w`` 0, ``mctn_teacher_forcing`` 1,
  as ``test_torch_baselines_{seq,mult}.py`` fix them), against JAX's
  single-device step on the global batch (``jax.grad`` of its
  ``dual_view_loss`` and ``make_train_step``), the parameters carried
  across by ``baseline_state_dict_from_flax``;
- with live draws (``mfm_mmd_w`` 1, ``mctn_teacher_forcing`` 0.5), against
  the port's single-process step: the batch-wide draws come from a
  generator every rank seeds from (seed, step), so with dropout off they
  are the single process's.

Each family's control must fail the same check: misa, mmim and mfm with
each rank's own ``model_loss`` (of its rows, with its own prior samples)
averaged; mctn, whose terms are means over rows, with each rank drawing
its own teacher-forcing mask. Then: both ranks hold the same parameters to
the bit, a 2-rank eval pass over ragged shards gathers nothing, and
``cli.train --multihost --model mfm`` logs the same metrics on both ranks,
the single process's at dropout 0.

Tolerances: the loss rtol 1e-5; the gradients against JAX as
``test_torch_baselines.py`` holds each family (GRAD_REL of the
parameter's largest value plus GRAD_FLOOR of the largest gradient of
all), against the port rtol 1e-4 / atol 1e-6; the parameters after one
Adam step rtol 1e-4 / atol 1e-5 (``test_torch_sharding.py``), but those
whose gradient is 0 up to rounding (within GRAD_FLOOR of the largest:
a key projection's bias, which the softmax cancels, and ``rnc_proj``'s
bias, to which RnC is blind), which Adam's first step moves by up to lr
in the direction of the rounding: within 2 lr, as
``test_torch_hierarchy.py`` holds them.
"""

import concurrent.futures
import functools
import sys

import jax
import numpy as np
import pytest
import torch

from sdumc_tpu.core.config import LossConfig as JaxLossConfig
from sdumc_tpu.train.schedule import make_lr_schedule
from sdumc_tpu.train.state import create_train_state as jax_create_train_state
from sdumc_tpu.train.step import dual_view_loss as jax_dual_view_loss
from sdumc_tpu.train.step import make_train_step as jax_make_train_step
from sdumc_tpu_torch.cli import common, train
from sdumc_tpu_torch.convert import baseline_state_dict_from_flax
from sdumc_tpu_torch.core.config import LossConfig, ModelConfig, TrainConfig
from sdumc_tpu_torch.models import get_model
from sdumc_tpu_torch.models.layers import Draws, use_generator
from sdumc_tpu_torch.train.state import create_train_state
from sdumc_tpu_torch.train.step import make_eval_step, make_train_step, step_seed

from tests.test_torch_baselines import (GRAD_FLOOR, GRAD_REL, LOSS, SMALL, assert_rel,
                                        jax_batch, jax_family, make_batch, port_batch)
from tests.test_torch_multihost import NO_DROPOUT, _logged, run_ranks

torch.set_num_threads(1)

FAMILIES = ("misa", "mmim", "mfm", "mctn")
# the draws neutralised (JAX's bit generator is another) and live
NEUTRAL = {"mfm": dict(mfm_mmd_w=0.0), "mctn": dict(mctn_teacher_forcing=1.0)}
LIVE = {"mfm": dict(mfm_mmd_w=1.0), "mctn": dict(mctn_teacher_forcing=0.5)}
WORLD, LR, SPE, EVAL_ROWS = 2, 1e-3, 2, 11          # 11 rows: shards of 6 and 5

# one rank: per family the DP step with the draws neutralised ("dp_neutral";
# misa and mmim draw nothing, so their "dp_live" serves both) and live, the
# control, and an eval pass over its ragged shard; writes rank{r}.npz
_RANK = """
import sys
import numpy as np, torch
torch.set_num_threads(1)
from sdumc_tpu_torch.core.config import LossConfig, ModelConfig, TrainConfig
from sdumc_tpu_torch.models import get_model
from sdumc_tpu_torch.parallel import (gather_eval, initialize_from_env, make_data_axis,
                                      multihost, shard_batch, shutdown)
from sdumc_tpu_torch.train.state import create_train_state
from sdumc_tpu_torch.train.step import make_eval_step, make_train_step

work = sys.argv[1]
rank, world = initialize_from_env(device="cpu")
axis = make_data_axis("cpu")
data = np.load(work + "/case.npz")
batch = {{k: torch.from_numpy(data[k]) for k in ("audio", "text", "video", "feat4", "vals")}}
batch["t_max"] = tuple(int(t) for t in data["t_max"])
local = shard_batch(batch, rank, world)
out = {{}}


def build(name, kw):
    model = get_model(ModelConfig(name=name, **{small!r}, **kw), torch.Generator().manual_seed(0))
    model.load_state_dict({{k[len(name) + 3:]: torch.from_numpy(data[k]) for k in data.files
                           if k.startswith("p/" + name + "/")}})
    return model, create_train_state(model, TrainConfig(lr={lr!r}, l2=1e-5), {spe!r})


for name, tag, kw in {cases!r}:
    model, state = build(name, kw)
    step = make_train_step(state, LossConfig(**{loss!r}), seed=0, axis=axis)
    if tag == "ctrl" and name == "mctn":     # each rank's teacher mask from its own stream
        model.teacher.generator = model.drop.generator
    elif tag == "ctrl":                      # each rank's own model_loss, averaged
        whole = model.batch_loss
        model.batch_loss = lambda rows: sum(
            whole(tuple(t[q::world] for t in rows)) for q in range(world)) / world
    out[f"{{name}}/{{tag}}/loss"] = step(local)["loss"].item()
    for k, p in model.named_parameters():
        out[f"{{name}}/{{tag}}/g/{{k}}"] = (p.grad if p.grad is not None
                                          else torch.zeros_like(p)).numpy()
        out[f"{{name}}/{{tag}}/p/{{k}}"] = p.detach().numpy()


def no_gather(*a, **kw):
    raise AssertionError("an eval pass gathered rows")


multihost._GatherRows.apply = no_gather
for name in {families!r}:
    model, _ = build(name, {{}})
    part = shard_batch({{k: (v[:{rows}] if k != "t_max" else v) for k, v in batch.items()}},
                       rank, world)
    preds = [p.numpy() for p in make_eval_step(model)(part)]
    out[f"{{name}}/eval/rows"] = np.asarray(len(preds[0]))
    out[f"{{name}}/eval/full"], out[f"{{name}}/eval/missing"] = gather_eval(preds, axis, {rows})
np.savez(work + f"/rank{{rank}}.npz", **out)
shutdown()
"""


def _rank_cases():
    cases = []
    for name in FAMILIES:
        if name in NEUTRAL:
            cases.append((name, "dp_neutral", NEUTRAL[name]))
        cases += [(name, "dp_live", LIVE.get(name, {})), (name, "ctrl", LIVE.get(name, {}))]
    return cases


def _port_family(name, sd, **kw):
    model = get_model(ModelConfig(name=name, **{**SMALL, **kw}), torch.Generator().manual_seed(0))
    model.load_state_dict(sd, strict=True)
    return model


def _jax_step(name, params, b):
    """JAX's single-device step on the global batch, the draws neutralised:
    the loss and gradients (jax.grad of its dual_view_loss) and the
    parameters after make_train_step's Adam update."""
    jm, _ = jax_family(name, **NEUTRAL.get(name, {}))
    cfg = JaxLossConfig(**LOSS)
    with jax.default_matmul_precision("highest"):
        grads = jax.jit(jax.grad(lambda p: jax_dual_view_loss(
            jm, p, jax_batch(b), cfg, jax.random.PRNGKey(0), deterministic=False)[0]))(params)
        state = jax_create_train_state(jm, params, make_lr_schedule(LR, SPE), l2=1e-5)
        state, metrics = jax_make_train_step(jm, cfg)(state, jax_batch(b), jax.random.PRNGKey(1))
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return {"loss": float(metrics["loss"]),
            "g": baseline_state_dict_from_flax(name, as_np(grads)),
            "p": baseline_state_dict_from_flax(name, as_np(state.params))}


def _port_step(name, sd, b, **kw):
    """The port's single-process step on the global batch."""
    model = _port_family(name, sd, **kw)
    state = create_train_state(model, TrainConfig(lr=LR, l2=1e-5), SPE)
    loss = make_train_step(state, LossConfig(**LOSS), seed=0)(port_batch(b))["loss"].item()
    return {"loss": loss,
            "g": {k: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
                  for k, p in model.named_parameters()},
            "p": {k: p.detach().clone() for k, p in model.named_parameters()}}


CLI_ARGS = ["--synthetic", "--device", "cpu", "--feat_scale", "16", "--batch_size", "12",
            "--model", "mfm"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups of 2 ranks (the steps, controls and eval passes; and
    ``cli.train --multihost --model mfm`` at dropout 0, live prior
    samples) and, in a thread, the single-process CLI run; meanwhile JAX's
    steps, the port's single-process steps and eval, all from one set of
    flax parameters per family on one global batch."""
    work = tmp_path_factory.mktemp("dp_model_loss")
    argv = [sys.executable, "-c", NO_DROPOUT, "--multihost", "--data_parallel", str(WORLD),
            "--epochs", "1", *CLI_ARGS, "--checkpoint_dir", str(work / "ck{rank}"),
            "--save_root", str(work / "saved{rank}")]
    single_argv = CLI_ARGS + ["--epochs", "1", "--checkpoint_dir", str(work / "ck"),
                              "--save_root", str(work / "saved")]
    with pytest.MonkeyPatch.context() as mp, concurrent.futures.ThreadPoolExecutor(3) as pool:
        mp.setattr(common, "ModelConfig", functools.partial(
            common.ModelConfig, dropout=0.0, attn_dropout=0.0))
        cli = pool.submit(run_ranks, WORLD, argv)
        single = pool.submit(train.main, single_argv)
        b = make_batch(3)
        params = {n: jax_family(n, **NEUTRAL.get(n, {}))[1] for n in FAMILIES}
        sds = {n: baseline_state_dict_from_flax(n, params[n]) for n in FAMILIES}
        np.savez(work / "case.npz", t_max=np.asarray(b["t_max"]),
                 **{k: b[k] for k in ("audio", "text", "video", "feat4", "vals")},
                 **{f"p/{n}/{k}": v.numpy() for n in FAMILIES for k, v in sds[n].items()})
        script = _RANK.format(small=SMALL, lr=LR, spe=SPE, loss=LOSS, cases=_rank_cases(),
                              families=FAMILIES, rows=EVAL_ROWS)
        ranks = pool.submit(run_ranks, WORLD, [sys.executable, "-c", script, str(work)])
        refs = {n: {"jax": _jax_step(n, params[n], b),
                    "live": _port_step(n, sds[n], b, **LIVE.get(n, {}))} for n in FAMILIES}
        for n in FAMILIES:
            model = _port_family(n, sds[n])
            ev = {k: (v[:EVAL_ROWS] if k != "t_max" else v) for k, v in port_batch(b).items()}
            refs[n]["eval"] = [p.numpy() for p in make_eval_step(model)(ev)]
        ranks.result()
        logs = [_logged(o) for o in cli.result()]
        single = single.result()
    return {"refs": refs, "ranks": [np.load(work / f"rank{r}.npz") for r in range(WORLD)],
            "single": single, "logs": logs}


@pytest.fixture(scope="module")
def dp_case(runs):
    return runs["refs"], runs["ranks"]


def _side(ranks, name, tag, rank=0):
    r, head = ranks[rank], f"{name}/{tag}/"
    return {"loss": float(r[head + "loss"]),
            "g": {k[len(head) + 2:]: r[k] for k in r.files if k.startswith(head + "g/")},
            "p": {k[len(head) + 2:]: r[k] for k in r.files if k.startswith(head + "p/")}}


def _floor(ref):
    return GRAD_FLOOR * max(g.abs().max().item() for g in ref["g"].values())


def _rounding_only(ref):
    """The parameters whose reference gradient is 0 up to rounding."""
    floor = _floor(ref)
    return {k for k, g in ref["g"].items() if g.abs().max().item() <= floor}


def _check_params(got, ref):
    """Each parameter after the Adam step rtol 1e-4 / atol 1e-5; one whose
    gradient is 0 up to rounding within 2 lr."""
    noise = _rounding_only(ref)
    for k, p in ref["p"].items():
        np.testing.assert_allclose(got["p"][k], p.numpy(), rtol=1e-4,
                                   atol=2 * LR if k in noise else 1e-5, err_msg=k)


def _check_jax(got, ref):
    """The loss rtol 1e-5; each gradient GRAD_REL of its largest value plus
    GRAD_FLOOR of the largest gradient of all; the parameters
    (``_check_params``)."""
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    assert got["g"].keys() == ref["g"].keys() == got["p"].keys()
    floor = _floor(ref)
    for k, g in ref["g"].items():
        assert_rel(got["g"][k], g.numpy(), GRAD_REL, k, atol=floor)
    _check_params(got, ref)


def _check_port(got, ref):
    """The loss rtol 1e-5; each gradient rtol 1e-4 / atol 1e-6; the
    parameters (``_check_params``)."""
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    assert got["g"].keys() == ref["g"].keys() == got["p"].keys()
    for k, g in ref["g"].items():
        np.testing.assert_allclose(got["g"][k], g.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    _check_params(got, ref)


@pytest.mark.parametrize("name", FAMILIES)
def test_two_rank_step_matches_jax_single_device(dp_case, name):
    refs, ranks = dp_case
    _check_jax(_side(ranks, name, "dp_neutral" if name in NEUTRAL else "dp_live"),
               refs[name]["jax"])


def test_rounding_only_gradients_are_shift_invariant_biases(dp_case):
    """The parameters held within 2 lr are biases whose shift the loss
    cannot see: MISA's key projection (the softmax over keys cancels a
    shift common to every key) and ``rnc_proj``'s (RnC reads differences
    of features)."""
    refs, _ = dp_case
    for name in FAMILIES:
        for ref in ("jax", "live"):
            assert _rounding_only(refs[name][ref]) <= {"fusion_tr.attn_0.k_proj.bias",
                                                       "rnc_proj.bias"}, (name, ref)


@pytest.mark.parametrize("name", FAMILIES)
def test_two_rank_step_matches_single_process_port_with_live_draws(dp_case, name):
    refs, ranks = dp_case
    _check_port(_side(ranks, name, "dp_live"), refs[name]["live"])


@pytest.mark.parametrize("name, ref", [(n, "live") for n in FAMILIES]
                         + [("misa", "jax"), ("mmim", "jax")])
def test_control_fails_the_check(dp_case, name, ref):
    """misa, mmim and mfm with each rank's own model_loss averaged, mctn
    with each rank's own teacher-forcing mask: another step. (mfm's and
    mctn's controls are held where their draws are live; with the draws
    neutralised their terms are means over rows.)"""
    refs, ranks = dp_case
    ctrl, target = _side(ranks, name, "ctrl"), refs[name][ref]
    check = _check_jax if ref == "jax" else _check_port
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(ctrl["loss"], target["loss"], rtol=1e-5)
    with pytest.raises(AssertionError):
        check(dict(ctrl, loss=target["loss"]), target)


@pytest.mark.parametrize("name", FAMILIES)
def test_ranks_hold_the_same_parameters_after_the_step(dp_case, name):
    """Every rank takes the global model_loss and the summed gradients: the
    same update, to the bit."""
    _, ranks = dp_case
    keys = [k for k in ranks[0].files if k.startswith(f"{name}/dp_")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


@pytest.mark.parametrize("name", FAMILIES)
def test_eval_pass_over_ragged_shards_gathers_nothing(dp_case, name):
    """Shards of 6 and 5 rows, the gather's collective replaced by a raise:
    each rank's eval takes its own rows, and the gathered predictions are
    the single process's."""
    refs, ranks = dp_case
    assert [int(r[f"{name}/eval/rows"]) for r in ranks] == [6, 5]
    for r in ranks:
        for view, ref in zip(("full", "missing"), refs[name]["eval"]):
            np.testing.assert_allclose(r[f"{name}/eval/{view}"], ref, rtol=1e-5, atol=1e-6,
                                       err_msg=view)


def test_batch_wide_draws_take_the_shared_generator():
    """use_generator: the batch-wide draws (MFM's prior, MCTN's mask) take
    the second generator where one is given, every other draw the first;
    without one, all take the first. The step seeds the shared one from
    (seed, step) and each rank's from (seed, step, rank)."""
    for name in ("mfm", "mctn"):
        model = get_model(ModelConfig(name=name, **SMALL))
        wide = [m for m in model.modules() if isinstance(m, Draws) and m.batch_wide]
        own = [m for m in model.modules() if isinstance(m, Draws) and not m.batch_wide]
        assert len(wide) == 1 and own
        g, shared = torch.Generator(), torch.Generator()
        use_generator(model, g, shared)
        assert wide[0].generator is shared and all(m.generator is g for m in own)
        use_generator(model, g)
        assert all(m.generator is g for m in wide + own)
    assert step_seed(0, 4) not in (step_seed(0, 4, 0), step_seed(0, 4, 1))


# ------------------------------------------------------------------ the CLI

@pytest.fixture(scope="module")
def cli_runs(runs):
    return runs["single"], runs["logs"]


def test_cli_multihost_mfm_ranks_log_the_same_metrics(cli_runs):
    _, logs = cli_runs
    assert all(log == logs[0] for log in logs[1:]), logs
    fields = dict(f.split(":") for f in logs[0]["epoch"].split("; "))
    assert all(np.isfinite(float(fields[k])) for k in ("train_val_mse_full", "train_val_mse_missing"))


def test_cli_multihost_mfm_equals_the_single_process_run_at_dropout_0(cli_runs):
    """The prior samples are the single process's (the shared generator),
    the MMD is the global batch's: the epoch is the single-process one, to
    test_torch_multihost.py's tolerances."""
    single, logs = cli_runs
    (h,) = single["history"]
    fields = dict(f.split(":") for f in logs[0]["epoch"].split("; "))
    for key in ("train_val_mse_full", "train_val_mse_missing"):   # logged to 4 decimals
        assert float(fields[key]) == pytest.approx(h[key.replace("_val", "")], abs=6e-5), key
    for view in ("full", "missing"):
        got, want = logs[0][f"best_test_{view}"], single[f"best_{view}"]
        assert got.keys() == want.keys()
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-4,
                                             abs=1e-5 if key == "corr" else 0), (view, key)
