"""The gradient of the port's ring attention (``parallel/ring_attention.py``
``RingGatedAttention``, ``GatherTime``, ``parallel.reduce_gradients``)
against the JAX package on the CPU.

``test_torch_ring_attention.py``'s case (B = 4, T = 256, H = 4, hd = 8, NB
= 40, MD = 100; rows with 256, 245, 40 and 0 valid keys: row 2's keys all
lie in the first block, so its other blocks are fully masked, and row 3
has no valid key) runs ``ring_attention_sharded`` over 2 and 4 real
processes (gloo); each rank takes the same loss, a seeded linear functional
of the whole output, calls ``backward()`` and sums the replicated inputs'
gradients over the ranks. The q, k, v, gate and rel_embed gradients are
held to (a) ``jax.grad`` of JAX's single-device einsum reference
(``tests/test_ring_attention.py``'s), and (c) the port's single-process
autograd through ``flash_gated_attention_plain``; at world 4 and
``test_ring_grads_flow``'s size (B = 1, T = 32, H = 2, hd = 4, every key
valid, the loss sum(out ** 2)) to (b) ``jax.grad`` of JAX's own
``ring_attention_sharded`` on 4 CPU devices, which ``test_ring_grads_flow``
holds to the einsum reference (a ``slow`` test, so not run by tier-1).
Tolerance: that test's, rtol 3e-4 and atol 3e-5. Every rank's gradients
are equal to the bit (one all_reduce).

The block backward (``flash_wavlm.flash_backward`` with the merged
log-sum-exp) is held to autograd of a dense formulation at offsets of -3,
-1, 0, 1 and 3 blocks of a 4-block split: the softmax over every key of
the clip, in which only the block under test reads the leaves, so autograd
gives that block's share of dq, dgate and the diagonal's gradient and all
of its dk and dv (f32, the same sums in another order: rtol 1e-5, atol
2e-6).
"""

import concurrent.futures
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sdumc_tpu.parallel.ring_attention import ring_attention_sharded as jax_ring
from sdumc_tpu_torch.ops.kernels import flash_wavlm
from sdumc_tpu_torch.parallel import ModelAxis, ring_attention_sharded
from tests.test_ring_attention import einsum_reference
from tests.test_torch_multihost import run_ranks

torch.set_num_threads(1)

NB, MD = 40, 100
B, T, H, HD = 4, 256, 4, 8
LENGTHS = (T, T - 11, 40, 0)
SMALL = (1, 32, 2, 4)                 # test_ring_grads_flow's B, T, H, hd
WORLDS = (2, 4)
NAMES = ("q", "k", "v", "gate", "rel")
TOL = dict(rtol=3e-4, atol=3e-5)
BLOCK_TOL = dict(rtol=1e-5, atol=2e-6)

_RANK = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from sdumc_tpu_torch.parallel import (initialize_from_env, make_model_axis,
                                      reduce_gradients, ring_attention_sharded, shutdown)

work = sys.argv[1]
rank, world = initialize_from_env(device="cpu")
axis = make_model_axis("cpu", world)
grads = {}
for name in ("case",) + (("small",) if world == 4 else ()):
    case = np.load(work + f"/{name}.npz")
    leaves = [torch.from_numpy(case[k]).requires_grad_() for k in ("q", "k", "v", "gate", "rel")]
    out = ring_attention_sharded(*leaves[:4], torch.from_numpy(case["kvalid"]), leaves[4],
                                 axis=axis, num_buckets=int(case["nb"]),
                                 max_distance=int(case["md"]))
    loss = (out * torch.from_numpy(case["w"])).sum() if name == "case" else (out ** 2).sum()
    loss.backward()
    reduce_gradients(leaves, axis)
    for key, t in zip(("q", "k", "v", "gate", "rel"), leaves):
        grads[f"{name}_{key}"] = t.grad.numpy()
np.savez(work + f"/grads{world}_{rank}.npz", **grads)
shutdown()
"""


def _case():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    case = {"q": f(B, T, H, HD), "k": f(B, T, H, HD), "v": f(B, T, H, HD),
            "gate": (1 + rng.uniform(size=(B, H, T))).astype(np.float32),
            "rel": f(NB, H),
            "kvalid": (np.arange(T)[None, :] < np.array(LENGTHS)[:, None]).astype(np.float32)}
    case["w"] = f(B, T, H, HD)                      # the loss: sum(out * w)
    return case


def _small():
    """test_ring_grads_flow's inputs (its seed, shapes and all-valid mask)."""
    b, t, h, hd = SMALL
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(b, t, h, hd)).astype(np.float32) for _ in range(3))
    return {"q": q, "k": k, "v": v,
            "gate": (1 + rng.uniform(size=(b, h, t))).astype(np.float32),
            "rel": rng.normal(size=(NB, h)).astype(np.float32),
            "kvalid": np.ones((b, t), np.float32)}


def _jax_einsum_grads(case):
    def loss(q, k, v, gate, rel):
        out = einsum_reference(q, k, v, gate, rel, jnp.asarray(case["kvalid"]))
        return jnp.sum(out * jnp.asarray(case["w"]))

    with jax.default_matmul_precision("highest"):
        grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(case[k]) for k in NAMES))
    return dict(zip(NAMES, (np.asarray(g) for g in grads)))


def _jax_ring_grads(small):
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    kvalid = jnp.asarray(small["kvalid"])

    def loss(q, k, v, gate, rel):
        out = jax_ring(mesh, q, k, v, gate, kvalid, rel, num_buckets=NB, max_distance=MD)
        return jnp.sum(out ** 2)

    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(small[k]) for k in NAMES))
    return dict(zip(NAMES, (np.asarray(g) for g in grads)))


def _plain_grads(case):
    """The port's single-process autograd through the plain attention."""
    leaves = [torch.from_numpy(case[k]).requires_grad_() for k in NAMES]
    out = flash_wavlm.flash_gated_attention_plain(
        *leaves[:4], leaves[4], torch.from_numpy(case["kvalid"]), num_buckets=NB,
        max_distance=MD)
    (out * torch.from_numpy(case["w"])).sum().backward()
    return {k: t.grad.numpy() for k, t in zip(NAMES, leaves)}


@pytest.fixture(scope="module")
def grad_runs(tmp_path_factory):
    """Each rank's gradients per world ({world: [{name: array}]}), JAX's
    einsum reference's, JAX's ring's at the small size, and the port's
    single-process autograd's."""
    work = tmp_path_factory.mktemp("ring_grad")
    case, small = _case(), _small()
    np.savez(work / "case.npz", nb=NB, md=MD, **case)
    np.savez(work / "small.npz", nb=NB, md=MD, **small)
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        groups = [pool.submit(run_ranks, w, [sys.executable, "-c", _RANK, str(work)])
                  for w in WORLDS]
        ref = {"einsum": _jax_einsum_grads(case), "ring": _jax_ring_grads(small),
               "plain": _plain_grads(case)}
        for g in groups:
            g.result()
    ranks = {w: [dict(np.load(work / f"grads{w}_{r}.npz")) for r in range(w)] for w in WORLDS}
    return case, ranks, ref


@pytest.mark.parametrize("world", WORLDS)
def test_ring_grads_match_jax_einsum_reference(grad_runs, world):
    _, ranks, ref = grad_runs
    for rank, got in enumerate(ranks[world]):
        for name in NAMES:
            np.testing.assert_allclose(got[f"case_{name}"], ref["einsum"][name], **TOL,
                                       err_msg=f"rank {rank} d{name}")


def test_ring_grads_match_jax_ring_attention_sharded(grad_runs):
    _, ranks, ref = grad_runs
    for rank, got in enumerate(ranks[4]):
        for name in NAMES:
            assert np.all(np.isfinite(got[f"small_{name}"]))
            np.testing.assert_allclose(got[f"small_{name}"], ref["ring"][name], **TOL,
                                       err_msg=f"rank {rank} d{name}")


@pytest.mark.parametrize("world", WORLDS)
def test_ring_grads_match_the_port_single_process_autograd(grad_runs, world):
    _, ranks, ref = grad_runs
    for rank, got in enumerate(ranks[world]):
        for name in NAMES:
            np.testing.assert_allclose(got[f"case_{name}"], ref["plain"][name], **TOL,
                                       err_msg=f"rank {rank} d{name}")


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_holds_the_same_gradients(grad_runs, world):
    _, ranks, _ = grad_runs
    for rank, got in enumerate(ranks[world][1:], start=1):
        assert got.keys() == ranks[world][0].keys()
        for key, g in got.items():
            np.testing.assert_array_equal(g, ranks[world][0][key], err_msg=f"rank {rank} {key}")


@pytest.mark.parametrize("world", WORLDS)
def test_masked_keys_and_the_empty_row(grad_runs, world):
    """Masked keys of rows with valid keys (row 1's last 11, row 2's past
    40, whole blocks of it) get exactly zero dk and dv; the row with no
    valid key gets dq, dk and dgate exactly zero and dv = sum_t dout_t / T,
    as JAX's ``where`` and its NEG arithmetic give them."""
    case, ranks, _ = grad_runs
    want_dv = np.broadcast_to(case["w"][3].sum(0) / T, (T, H, HD))
    for got in ranks[world]:
        for row, n in ((1, T - 11), (2, 40)):
            assert not got["case_k"][row, n:].any() and not got["case_v"][row, n:].any()
        for name in ("q", "k", "gate"):
            assert not got[f"case_{name}"][3].any(), name
        np.testing.assert_allclose(got["case_v"][3], want_dv, rtol=1e-5, atol=1e-6)


def test_one_rank_bf16_grads_are_the_f32_ring_s_rounded_once():
    """At bf16 the ring widens to f32 as its forward does: the gradients
    come back in bf16, each the f32 ring's on the widened inputs rounded
    once."""
    case = _case()
    kw = dict(axis=ModelAxis(), num_buckets=NB, max_distance=MD)
    kvalid = torch.from_numpy(case["kvalid"])
    w16 = torch.from_numpy(case["w"]).bfloat16()
    got, want = [], []
    for dtype, out_list in ((torch.bfloat16, got), (torch.float32, want)):
        leaves = [torch.from_numpy(case[k]).bfloat16().to(dtype).requires_grad_() for k in NAMES]
        out = ring_attention_sharded(*leaves[:4], kvalid, leaves[4], **kw)
        assert out.dtype == dtype
        out.backward(w16.to(dtype))
        out_list.extend(t.grad for t in leaves)
    for name, g, f in zip(NAMES, got, want):
        assert g.dtype == torch.bfloat16, name
        assert torch.equal(g, f.bfloat16()), name


@pytest.mark.parametrize("qi,kj", [(0, 0), (0, 3), (3, 0), (1, 2), (2, 1)])
def test_block_backward_with_the_merged_lse_matches_dense_autograd(qi, kj):
    case, n = _case(), T // 4
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    blocks = [slice(j * n, (j + 1) * n) for j in range(4)]
    rq = blocks[qi]
    q, gate, dout = t["q"][:, rq], t["gate"][:, :, rq], t["w"][:, rq]
    diags = [flash_wavlm.bias_diag_for(t["rel"], n, NB, MD, offset=(j - qi) * n)
             for j in range(4)]
    leaves = [x.clone().requires_grad_() for x in
              (q, t["k"][:, blocks[kj]], t["v"][:, blocks[kj]], gate, diags[kj])]
    idx = torch.arange(n)[None, :] - torch.arange(n)[:, None] + (n - 1)

    def scores(j):
        qq, kk, gg, dd = ((leaves[0], leaves[1], leaves[3], leaves[4]) if j == kj else
                          (q, t["k"][:, blocks[j]], gate, diags[j]))
        s = (torch.einsum("bthd,bshd->bhts", qq, kk) / math.sqrt(HD)
             + gg[..., None] * dd[:, idx][None])
        return s.masked_fill(~(t["kvalid"][:, blocks[j]] > 0)[:, None, None, :], -1e30)

    s = torch.cat([scores(j) for j in range(4)], -1)                  # [B, H, n, T]
    v = torch.cat([leaves[2] if j == kj else t["v"][:, blocks[j]] for j in range(4)], 1)
    out = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v)
    (out * dout).sum().backward()
    got = flash_wavlm.flash_backward(
        q, t["k"][:, blocks[kj]], t["v"][:, blocks[kj]], gate, diags[kj],
        t["kvalid"][:, blocks[kj]], out.detach(), dout, lse=torch.logsumexp(s.detach(), -1),
        keys_total=T)
    for name, g, leaf in zip(("dq", "dk", "dv", "dgate", "d_bias_diag"), got, leaves):
        torch.testing.assert_close(g, leaf.grad, **BLOCK_TOL, msg=name)
