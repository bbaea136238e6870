"""Data-parallel training of the fusion net, the port against JAX.

Two processes over gloo on the CPU (sdumc_tpu_torch.parallel), each holding
half the rows of one global batch, take one train step: it must equal the
JAX package's single-device ``make_train_step`` on the global batch (JAX's
own DP oracle, tests/test_sharding.py, with its widths 16/32/16, B = 16,
T = 8), with the parameters carried across by ``state_dict_from_flax``, and
the port's own single-process step. Dropout is off; every term of the mixed
loss is weighted (the CLI's defaults), so the RMSE and RnC terms, which are
no means over samples, decide the gradient. The control, each rank taking
the loss of its own rows with the gradients averaged (the usual DDP idiom),
must fail the same check. Then the sharded BatchIterator's order against
JAX's, on the synthetic, .npy and packed-store paths.

Tolerances: the loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-6 (f32
reassociation, as tests/test_torch_train.py holds the loss's gradients);
the parameters after one Adam step rtol 1e-4 / atol 1e-5, JAX's own bound
for its 8-device step (tests/test_sharding.py:77-80).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.core.config import LossConfig as JaxLossConfig
from sdumc_tpu.core.config import ModelConfig as JaxModelConfig
from sdumc_tpu.data.feature_store import SyntheticSource as JaxSyntheticSource
from sdumc_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from sdumc_tpu.data.pipeline import MoseiDataset as JaxMoseiDataset
from sdumc_tpu.models.fusion import SDUMCFusion as JaxFusion
from sdumc_tpu.train.schedule import make_lr_schedule
from sdumc_tpu.train.state import create_train_state as jax_create_train_state
from sdumc_tpu.train.step import dual_view_loss as jax_dual_view_loss
from sdumc_tpu.train.step import make_train_step as jax_make_train_step
from sdumc_tpu_torch.convert import state_dict_from_flax
from sdumc_tpu_torch.core.config import LossConfig, ModelConfig, TrainConfig
from sdumc_tpu_torch.data.feature_store import NpyDirSource, SyntheticSource
from sdumc_tpu_torch.data.packed import PackedSource, pack_features
from sdumc_tpu_torch.data.pipeline import BatchIterator, MoseiDataset
from sdumc_tpu_torch.models.fusion import SDUMCFusion
from sdumc_tpu_torch.parallel import shard_batch
from sdumc_tpu_torch.train.state import create_train_state
from sdumc_tpu_torch.train.step import make_train_step

from tests.test_torch_multihost import run_ranks

torch.set_num_threads(1)

DIMS = (16, 32, 16)
SMALL = dict(general_dim=32, layers=(32, 16), fused_layers=(32, 32), dropout=0.0,
             attn_dropout=0.0)
LOSS = dict(text_feat_w=0.1, text_query_feat_w=0.7, features_w=0.1, rnc_w=0.8)
B, T, WORLD = 16, 8, 2
LR, STEPS_PER_EPOCH = 1e-3, 2

# one rank: the DP step and the local-loss control, each from the same
# weights on this rank's rows of the global batch; writes rank{r}.npz
_RANK = """
import sys
import numpy as np, torch
torch.set_num_threads(1)
from sdumc_tpu_torch.core.config import LossConfig, ModelConfig, TrainConfig
from sdumc_tpu_torch.models.fusion import SDUMCFusion
from sdumc_tpu_torch.parallel import (initialize_from_env, make_data_axis, reduce_gradients,
                                      shard_batch, shutdown)
from sdumc_tpu_torch.train.state import create_train_state
from sdumc_tpu_torch.train.step import dual_view_loss, make_train_step

work = sys.argv[1]
rank, world = initialize_from_env(device="cpu")
axis = make_data_axis("cpu")
data = np.load(work + "/case.npz")
batch = {{k: torch.from_numpy(data[k]) for k in ("audio", "text", "video", "feat4", "vals")}}
batch["t_max"] = tuple(int(t) for t in data["t_max"])
local = shard_batch(batch, rank, world)
out = {{}}
for tag in ("dp", "ctrl"):
    model = SDUMCFusion(ModelConfig(input_dims={dims!r}, **{small!r}))
    model.load_state_dict({{k[2:]: torch.from_numpy(data[k]) for k in data.files
                           if k.startswith("p/")}})
    state = create_train_state(model, TrainConfig(lr={lr!r}, l2=1e-5), {spe!r})
    cfg = LossConfig(**{loss!r})
    if tag == "dp":
        loss = make_train_step(state, cfg, seed=0, axis=axis)(local)["loss"]
    else:   # each rank's own loss, gradients averaged
        model.train()
        loss, _ = dual_view_loss(model, local, cfg)
        loss.backward()
        reduce_gradients(model.parameters(), axis)
        for p in model.parameters():
            if p.grad is not None:
                p.grad /= world
        state.optimizer.step()
    out[tag + "/loss"] = loss.item()
    for k, p in model.named_parameters():
        out[tag + "/g/" + k] = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        out[tag + "/p/" + k] = p.detach().numpy()
np.savez(work + f"/rank{{rank}}.npz", **out)
shutdown()
"""


def _grad(p):
    """A parameter's gradient, zeros where it has none (unused layers)."""
    return (p.grad if p.grad is not None else torch.zeros_like(p)).clone()


def _case():
    rng = np.random.default_rng(0)
    d = {k: rng.normal(size=(B, T, dim)).astype(np.float32)
         for k, dim in zip(("audio", "text", "video", "feat4"), DIMS + (DIMS[1],))}
    d["vals"] = rng.uniform(-3, 3, size=(B,)).astype(np.float32)
    return d


@pytest.fixture(scope="module")
def dp_case(tmp_path_factory):
    """JAX's single-device step and gradients, the port's single-process
    step, and the two ranks' DP and control steps, all from one set of
    flax parameters on one global batch."""
    work = tmp_path_factory.mktemp("dp")
    case = _case()
    jmodel = JaxFusion(JaxModelConfig(input_dims=DIMS, **SMALL))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *(
        jnp.asarray(case[k]) for k in ("audio", "text", "video")))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in case.items()}
    jbatch["t_max"] = tuple(jnp.int32(T) for _ in range(4))
    jcfg = JaxLossConfig(**LOSS)
    grads = jax.jit(jax.grad(lambda p, b: jax_dual_view_loss(
        jmodel, p, b, jcfg, jax.random.PRNGKey(1), deterministic=True)[0]))(params, jbatch)
    jstate = jax_create_train_state(jmodel, params, make_lr_schedule(LR, STEPS_PER_EPOCH),
                                    l2=1e-5)
    jstate, jm = jax_make_train_step(jmodel, jcfg)(jstate, jbatch, jax.random.PRNGKey(1))
    jax_ref = {"loss": float(jm["loss"]),
               "g": state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads)),
               "p": state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))}

    sd = state_dict_from_flax(params)
    model = SDUMCFusion(ModelConfig(input_dims=DIMS, **SMALL))
    model.load_state_dict(sd)
    state = create_train_state(model, TrainConfig(lr=LR, l2=1e-5), STEPS_PER_EPOCH)
    batch = {k: torch.from_numpy(v) for k, v in case.items()}
    batch["t_max"] = (T,) * 4
    loss = make_train_step(state, LossConfig(**LOSS), seed=0)(batch)["loss"].item()
    single = {"loss": loss,
              "g": {k: _grad(p) for k, p in model.named_parameters()},
              "p": {k: p.detach().clone() for k, p in model.named_parameters()},
              "unreached": {k for k, p in model.named_parameters() if p.grad is None},
              "init": sd}

    np.savez(work / "case.npz", t_max=np.full(4, T), **case,
             **{"p/" + k: v.numpy() for k, v in sd.items()})
    script = _RANK.format(dims=DIMS, small=SMALL, lr=LR, spe=STEPS_PER_EPOCH, loss=LOSS)
    run_ranks(WORLD, [sys.executable, "-c", script, str(work)])
    ranks = [np.load(work / f"rank{r}.npz") for r in range(WORLD)]
    return jax_ref, single, ranks


def _side(ranks, tag):
    r0 = ranks[0]
    return {"loss": float(r0[tag + "/loss"]),
            "g": {k[len(tag) + 3:]: r0[k] for k in r0.files if k.startswith(tag + "/g/")},
            "p": {k[len(tag) + 3:]: r0[k] for k in r0.files if k.startswith(tag + "/p/")}}


def _check(got, ref, skip=()):
    """The loss rtol 1e-5, every gradient rtol 1e-4 / atol 1e-6, every
    parameter after the Adam step but those in `skip` rtol 1e-4 / atol 1e-5."""
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    assert got["g"].keys() == set(ref["g"]) == got["p"].keys()
    for k in got["g"]:
        np.testing.assert_allclose(got["g"][k], np.asarray(ref["g"][k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
        if k not in skip:
            np.testing.assert_allclose(got["p"][k], np.asarray(ref["p"][k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_two_rank_step_matches_jax_single_device(dp_case):
    """Every parameter the loss reaches; the others below."""
    jax_ref, single, ranks = dp_case
    assert single["unreached"]                  # the imagination MLPs (use_imagination off)
    _check(_side(ranks, "dp"), jax_ref, skip=single["unreached"])


def test_unreached_parameters_keep_their_values_where_optax_decays_them(dp_case):
    """A parameter without a gradient: torch's Adam (the reference's
    optimizer) skips it, optax adds the L2 decay to its zero gradient and
    moves it by about the step's lr, beyond the parameter tolerance. The
    two-rank step keeps it, as a single process does."""
    jax_ref, single, ranks = dp_case
    dp = _side(ranks, "dp")
    for k in single["unreached"]:
        init = single["init"][k].numpy()
        np.testing.assert_array_equal(dp["p"][k], init, err_msg=k)
        moved = np.abs(np.asarray(jax_ref["p"][k]) - init).max()
        assert moved <= LR and (moved > 1e-5 or not init.any()), (k, moved)   # zeros stay


def test_two_rank_step_matches_single_process_port(dp_case):
    _, single, ranks = dp_case
    _check(_side(ranks, "dp"), single)


def test_ranks_hold_the_same_parameters_after_the_step(dp_case):
    """The gradients are summed, not averaged per rank: every rank applies
    the same update, to the bit."""
    _, _, ranks = dp_case
    for k in ranks[0].files:
        if "/p/" in k or "/g/" in k:
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


@pytest.mark.parametrize("ref", ["jax", "single_process"])
def test_local_loss_control_fails_the_check(dp_case, ref):
    """Each rank's own loss with averaged gradients is another loss: it
    fails the loss check, and its gradients fail the gradient check."""
    jax_ref, single, ranks = dp_case
    target = jax_ref if ref == "jax" else single
    ctrl = _side(ranks, "ctrl")
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(ctrl["loss"], target["loss"], rtol=1e-5)
    with pytest.raises(AssertionError):
        _check(dict(ctrl, loss=target["loss"]), target)
    worst = max(np.abs(ctrl["g"][k] - np.asarray(target["g"][k])).max()
                / (np.abs(np.asarray(target["g"][k])).max() + 1e-12) for k in ctrl["g"])
    assert worst > 1e-2, worst


# ------------------------------------------------------------ shard order

N_CLIPS = 23


def _names(it):
    return [b.names for b in it]


def _jax_iter(shuffle, bs, shard, world, drop):
    src = {k: JaxSyntheticSource(k, 4, 2, 6) for k in ("audio", "text", "video", "feat4")}
    ds = JaxMoseiDataset([f"c{i:02d}" for i in range(N_CLIPS)], [{"val": 0.0}] * N_CLIPS, src)
    return JaxBatchIterator(ds, bs, shuffle=shuffle, seed=5, epoch=3, buckets=(8,),
                            drop_remainder=drop, prefetch=0, shard_index=shard,
                            shard_count=world)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same 23 clips as .npy directories and as packed stores."""
    root = tmp_path_factory.mktemp("stores")
    rng = np.random.default_rng(1)
    npy, packed = {}, {}
    for key, dim in (("audio", 4), ("text", 6), ("video", 4), ("feat4", 6)):
        d = root / key
        d.mkdir()
        for i in range(N_CLIPS):
            np.save(d / f"c{i:02d}.npy", rng.normal(size=(2 + i % 5, dim)).astype(np.float32))
        npy[key] = NpyDirSource(str(root), key)
        packed[key] = PackedSource(pack_features(str(d), str(root / f"{key}_packed")), key)
    return {"synthetic": {k: SyntheticSource(k, 4, 2, 6) for k in npy}, "npy": npy,
            "packed": packed}


@pytest.mark.parametrize("path", ["synthetic", "npy", "packed"])
@pytest.mark.parametrize("world", [2, 3, 4])
def test_shards_give_jax_names_rank_for_rank(stores, path, world):
    """Each rank's batches, shuffled and not, with and without the
    remainder, hold JAX's names in JAX's order."""
    ds = MoseiDataset([f"c{i:02d}" for i in range(N_CLIPS)], [{"val": 0.0}] * N_CLIPS,
                      stores[path])
    if path == "packed":
        assert BatchIterator(ds, 2, shuffle=False)._packed_usable()
    for shuffle, drop in ((True, True), (False, False)):
        for shard in range(world):
            got = _names(BatchIterator(ds, 3, shuffle=shuffle, seed=5, epoch=3, buckets=(8,),
                                       drop_remainder=drop, prefetch=0, shard_index=shard,
                                       shard_count=world))
            assert got == _names(_jax_iter(shuffle, 3, shard, world, drop)), (shuffle, shard)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_union_of_shards_is_the_global_batch(stores, world):
    """With batch B / W on each rank, the ranks' k-th batches together are
    the single-process k-th batch of B, row g on rank g % W as its row
    g // W (the order gather_rows restores)."""
    ds = MoseiDataset([f"c{i:02d}" for i in range(N_CLIPS)], [{"val": 0.0}] * N_CLIPS,
                      stores["synthetic"])
    bs = 12 if world != 4 else 8
    whole = _names(BatchIterator(ds, bs, shuffle=True, seed=5, drop_remainder=True, prefetch=0))
    shards = [_names(BatchIterator(ds, bs // world, shuffle=True, seed=5, drop_remainder=True,
                                   prefetch=0, shard_index=r, shard_count=world))
              for r in range(world)]
    for k, names in enumerate(whole):
        assert [shards[g % world][k][g // world] for g in range(bs)] == names


def test_shard_batch_takes_strided_rows():
    batch = {"audio": torch.arange(10).reshape(5, 2), "vals": np.arange(5.0), "t_max": (7, 1, 2, 3)}
    part = shard_batch(batch, 1, 2)
    assert part["audio"].tolist() == [[2, 3], [6, 7]] and part["vals"].tolist() == [1.0, 3.0]
    assert part["t_max"] == (7, 1, 2, 3)
