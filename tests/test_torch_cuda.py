"""sdumc_tpu_torch's hand-written CUDA kernel against its plain version, on
the card. Every test here is marked ``cuda`` and skips without a card.

The file imports neither JAX nor the JAX package, so it also runs where
only the port's dependencies exist:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance rtol 1e-4 / atol 1e-5: f32 in both, summed in another order over
up to a few hundred frames.
"""

import numpy as np
import pytest
import torch

from sdumc_tpu_torch.ops.kernels import fused_cross, fused_pool

RTOL, ATOL = 1e-4, 1e-5
D = 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(B, T, Q, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32))  # noqa: E731
    return f(B, T, D, scale=0.5), f(D, D, scale=0.06), f(D, scale=0.06), f(B, Q, D, scale=0.5), f(D, scale=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 63, 64, 200, 300])
@pytest.mark.parametrize("tmax", ["rows", None, 37, 0])
def test_kernel_matches_plain(cuda, T, tmax):
    B = 6
    x, w, b, q, c = (t.to(cuda) for t in _inputs(B, T, 7))
    if tmax == "rows":
        rows = [T, max(1, T - 5), 1, 0, T + 3, (T + 1) // 2]   # incl. all-masked and > T
        tmax = torch.tensor(rows, dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        got = fused_cross.fused_cross_attention(q, x, w, b, tmax)
        ref = fused_cross.fused_cross_attention_plain(q, x, w, b, tmax)
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        got = fused_pool.fused_attention_pool(x, w, b, c, tmax)
        ref = fused_pool.fused_attention_pool_plain(x, w, b, c, tmax)
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_launches_count_and_wrapper_checks(cuda):
    x, w, b, q, c = (t.to(cuda) for t in _inputs(2, 64, 7))
    fused_cross.reset_launches()
    with torch.inference_mode():
        fused_cross.fused_cross_attention(q, x, w, b, 10)
        fused_pool.fused_attention_pool(x, w, b, c, 10)
        assert fused_cross.LAUNCHES == {1: 1, 7: 1}
        with pytest.raises(TypeError):
            fused_cross.fused_cross_attention(q.double(), x.double(), w.double(), b.double())
        with pytest.raises(ValueError):
            fused_cross.fused_cross_attention(q, x.transpose(1, 2).contiguous().transpose(1, 2), w, b)
        with pytest.raises(ValueError):   # the kernel takes D = 256 only
            fused_cross.fused_cross_attention(q[..., :96].contiguous(), x[..., :96].contiguous(),
                                              w[:96, :96].contiguous(), b[:96].contiguous())
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_cross.fused_cross_attention(q, x, w.requires_grad_(), b)
    assert fused_cross.LAUNCHES == {1: 1, 7: 1}


@pytest.mark.cuda
def test_fusion_dual_view_on_card_matches_cpu(cuda):
    """The whole fused dual-view forward: card (kernel) vs CPU (plain)."""
    from sdumc_tpu_torch.core.config import ModelConfig
    from sdumc_tpu_torch.models.fusion import SDUMCFusion

    dims = (32, 64, 32)
    model = SDUMCFusion(ModelConfig(input_dims=dims), torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(3)
    a, t, f, v = (torch.from_numpy(rng.normal(size=(3, n, d)).astype(np.float32))
                  for n, d in ((70, dims[0]), (20, dims[1]), (12, dims[1]), (40, dims[2])))
    kw = dict(t_max=(65, (17, 12), 33), dual=True)
    with torch.inference_mode():
        ref, ref_aux = model(a, (t, f), v, **kw)
        model.to(cuda)
        got, aux = model(a.to(cuda), (t.to(cuda), f.to(cuda)), v.to(cuda), **kw)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-5)
    for key in ("features", "rnc", "text_feat", "text_query_feat"):
        torch.testing.assert_close(aux[key].cpu(), ref_aux[key], rtol=1e-4, atol=1e-5)
