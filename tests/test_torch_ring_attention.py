"""Ring attention of the port (``parallel/ring_attention.py``, the f32 block
step ``flash_wavlm.flash_block``) against the JAX package on the CPU.

The ring over 2 and 4 real processes (gloo, ``ModelAxis.ring_shift``) is
held to JAX's ``ring_attention_sharded`` on ``conftest.py``'s 8-device CPU
mesh (``jax.devices()[:n]``) and to the port's single-process plain
attention (``flash_gated_attention_plain`` over the whole clip), at
``tests/test_ring_attention.py``'s sizes (NB = 40, MD = 100) and tolerance
(rtol = atol = 2e-5: f32, the blocks' softmax merged in another order). T =
256 puts keys up to 255 frames from their queries, past MD, in blocks that
sit 128 (2 ranks) or 64 (4 ranks) frames apart. Four rows: every key valid,
the last 11 masked, 40 valid (the other blocks entirely masked for that
row: they must weigh zero), none valid (every block masked: JAX's NEG
arithmetic gives the mean of v over every key, and so must the port).

The block step's plain version is held to an independent dense formulation
(JAX's ``bucket_from_rel`` on the global positions, the block sliced out,
``torch.logsumexp``) at offsets of -3, -1, 0, 1 and 3 blocks of a 4-block
split, to 1e-5 / 1e-6 (f32, the same sums: only the bias's gather and the
scale's rounding order differ).
"""

import concurrent.futures
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sdumc_tpu.ops.pallas.flash_wavlm import bucket_from_rel as jax_bucket_from_rel
from sdumc_tpu.parallel.ring_attention import ring_attention_sharded as jax_ring
from sdumc_tpu_torch.ops.kernels import flash_wavlm
from sdumc_tpu_torch.parallel import ModelAxis, ring_attention_sharded, ring_gated_attention
from tests.test_torch_multihost import run_ranks

torch.set_num_threads(1)

NB, MD = 40, 100
B, T, H, HD = 4, 256, 4, 8
LENGTHS = (T, T - 11, 40, 0)
WORLDS = (2, 4)
TOL = dict(rtol=2e-5, atol=2e-5)

_RANK = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from sdumc_tpu_torch.parallel import (initialize_from_env, make_model_axis,
                                      ring_attention_sharded, shutdown)

work = sys.argv[1]
rank, world = initialize_from_env(device="cpu")
axis = make_model_axis("cpu", world)
case = np.load(work + "/case.npz")
args = [torch.from_numpy(case[k]) for k in ("q", "k", "v", "gate", "kvalid", "rel")]
with torch.inference_mode():
    out = ring_attention_sharded(*args, axis=axis, num_buckets=int(case["nb"]),
                                 max_distance=int(case["md"]))
np.save(work + f"/out{world}_{rank}.npy", out.numpy())
shutdown()
"""


def _case():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"q": f(B, T, H, HD), "k": f(B, T, H, HD), "v": f(B, T, H, HD),
            "gate": (1 + rng.uniform(size=(B, H, T))).astype(np.float32),
            "rel": f(NB, H),
            "kvalid": (np.arange(T)[None, :] < np.array(LENGTHS)[:, None]).astype(np.float32)}


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """{world: each rank's whole output} of the port's ring over gloo, and
    {world: JAX's ring_attention_sharded} on that many CPU devices."""
    work = tmp_path_factory.mktemp("ring")
    case = _case()
    np.savez(work / "case.npz", nb=NB, md=MD, **case)
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        groups = [pool.submit(run_ranks, w, [sys.executable, "-c", _RANK, str(work)])
                  for w in WORLDS]
        jax_out = {}
        for w in WORLDS:
            mesh = Mesh(np.array(jax.devices()[:w]), ("data",))
            jax_out[w] = np.asarray(jax_ring(
                mesh, *(jnp.asarray(case[k]) for k in ("q", "k", "v", "gate", "kvalid", "rel")),
                num_buckets=NB, max_distance=MD))
        for g in groups:
            g.result()
    port = {w: [np.load(work / f"out{w}_{r}.npy") for r in range(w)] for w in WORLDS}
    return case, port, jax_out


def _plain(case):
    """The port's single-process attention over the whole clip."""
    args = [torch.from_numpy(case[k]) for k in ("q", "k", "v", "gate")]
    with torch.inference_mode():
        return flash_wavlm.flash_gated_attention_plain(
            *args, torch.from_numpy(case["rel"]), torch.from_numpy(case["kvalid"]),
            num_buckets=NB, max_distance=MD).numpy()


@pytest.mark.parametrize("world", WORLDS)
def test_ring_matches_jax_ring_attention_sharded(ring_runs, world):
    case, port, jax_out = ring_runs
    for rank, got in enumerate(port[world]):
        np.testing.assert_allclose(got, jax_out[world], err_msg=f"rank {rank}", **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_matches_single_process_plain_attention(ring_runs, world):
    case, port, _ = ring_runs
    ref = _plain(case)
    for rank, got in enumerate(port[world]):
        np.testing.assert_allclose(got, ref, err_msg=f"rank {rank}", **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_fully_masked_blocks_weigh_zero_and_an_empty_row_averages_v(ring_runs, world):
    """Row 2 (40 valid keys, all in rank 0's block) equals attention over
    its first block alone; row 3 (no valid key) is the mean of v."""
    case, port, _ = ring_runs
    got = port[world][0]
    # attention of row 2's queries over keys 0..39 only, the bias from the global buckets
    rel = np.arange(40)[None, :] - np.arange(T)[:, None]
    bias = case["rel"][np.asarray(jax_bucket_from_rel(jnp.asarray(rel), NB, MD))]   # [T, 40, H]
    s = (np.einsum("thd,shd->hts", case["q"][2], case["k"][2, :40]) / np.sqrt(HD)
         + case["gate"][2][..., None] * bias.transpose(2, 0, 1))
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(got[2], np.einsum("hts,shd->thd", p, case["v"][2, :40]), **TOL)
    np.testing.assert_allclose(got[3], np.broadcast_to(case["v"][3].mean(0), got[3].shape),
                               **TOL)


def _dense_scores(case, row):
    """[H, T, T] scores of one row over the whole clip: JAX's buckets of the
    global distance, keys masked to -1e30."""
    rel = np.arange(T)[None, :] - np.arange(T)[:, None]
    bias = case["rel"][np.asarray(jax_bucket_from_rel(jnp.asarray(rel), NB, MD))]
    s = (np.einsum("thd,shd->hts", case["q"][row], case["k"][row]) / np.sqrt(HD)
         + case["gate"][row][..., None] * bias.transpose(2, 0, 1))
    return np.where(case["kvalid"][row][None, None, :] > 0, s, -1e30).astype(np.float32)


@pytest.mark.parametrize("qi,kj", [(0, 0), (0, 3), (3, 0), (1, 2), (2, 1)])
def test_block_plain_version_matches_logsumexp_of_the_dense_block(qi, kj):
    """``flash_block_plain`` on (queries of block qi, keys of block kj), the
    offset folded into ``bias_diag_for``, against the same block cut from
    the dense scores: its log-sum-exp by ``torch.logsumexp`` and its
    softmax-weighted v."""
    case, n = _case(), T // 4
    rq, rk = slice(qi * n, (qi + 1) * n), slice(kj * n, (kj + 1) * n)
    diag = flash_wavlm.bias_diag_for(torch.from_numpy(case["rel"]), n, NB, MD,
                                     offset=(kj - qi) * n)
    out, lse = flash_wavlm.flash_block_plain(
        torch.from_numpy(case["q"][:, rq]), torch.from_numpy(case["k"][:, rk]),
        torch.from_numpy(case["v"][:, rk]), torch.from_numpy(case["gate"][:, :, rq]), diag,
        torch.from_numpy(case["kvalid"][:, rk]))
    assert out.shape == (B, n, H, HD) and lse.shape == (B, H, n) and lse.dtype == torch.float32
    for row in range(B):
        s = torch.from_numpy(_dense_scores(case, row)[:, rq, rk])          # [H, n, n]
        torch.testing.assert_close(lse[row], torch.logsumexp(s, -1), rtol=1e-5, atol=1e-6)
        want = torch.einsum("hts,shd->thd", torch.softmax(s, -1),
                            torch.from_numpy(case["v"][row, rk]))
        torch.testing.assert_close(out[row], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_opcheck_flash_wavlm_lse(masked):
    """The block instance's op, ``sdumc::flash_wavlm_lse``, passes
    ``torch.library.opcheck`` on its CPU implementation, and ``flash_block``
    reaches it: the plain version's out and lse, to the bit."""
    case, n = _case(), T // 4
    args = [torch.from_numpy(case["q"][:, :n]), torch.from_numpy(case["k"][:, n:2 * n]),
            torch.from_numpy(case["v"][:, n:2 * n]), torch.from_numpy(case["gate"][:, :, :n]),
            flash_wavlm.bias_diag_for(torch.from_numpy(case["rel"]), n, NB, MD, offset=n),
            torch.from_numpy(case["kvalid"][:, n:2 * n]) if masked else None]
    torch.library.opcheck(torch.ops.sdumc.flash_wavlm_lse.default, tuple(args))
    for got, want in zip(flash_wavlm.flash_block(*args), flash_wavlm.flash_block_plain(*args)):
        assert torch.equal(got, want)


def test_one_rank_ring_is_the_plain_attention_and_needs_no_group():
    """An axis of one rank: one block, no rotation, no process group."""
    case = _case()
    args = [torch.from_numpy(case[k]) for k in ("q", "k", "v", "gate", "kvalid", "rel")]
    with torch.inference_mode():
        got = ring_attention_sharded(*args, axis=ModelAxis(), num_buckets=NB, max_distance=MD)
    np.testing.assert_allclose(got.numpy(), _plain(case), **TOL)


def test_ring_refuses_gradients_and_ragged_splits():
    """The ring once refused gradients; now a one-rank ring (``ModelAxis()``,
    no process group) gives the plain attention's autograd gradients. It
    still refuses a T that does not divide over the ranks."""
    case = _case()
    args = [torch.from_numpy(case[k]) for k in ("q", "k", "v", "gate", "kvalid", "rel")]
    w = torch.from_numpy(np.random.default_rng(5).normal(size=(B, T, H, HD)).astype(np.float32))
    grads = []
    for fn in (lambda q, k, v, g, r: ring_gated_attention(
                   q, k, v, g, args[4], r, axis=ModelAxis(), num_buckets=NB, max_distance=MD),
               lambda q, k, v, g, r: flash_wavlm.flash_gated_attention_plain(
                   q, k, v, g, r, args[4], num_buckets=NB, max_distance=MD)):
        leaves = [a.clone().requires_grad_() for a in args[:4] + args[5:]]
        (fn(*leaves) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for name, got, want in zip(("q", "k", "v", "gate", "rel"), *grads):
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-5, msg=name)
    with pytest.raises(ValueError, match="divide"):
        ring_attention_sharded(*args, axis=ModelAxis(world=3), num_buckets=NB, max_distance=MD)
