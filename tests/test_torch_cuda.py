"""sdumc_tpu_torch's hand-written CUDA kernels against their plain versions,
on the card. Every test here is marked ``cuda`` and skips without a card.

The file imports neither JAX nor the JAX package, so it also runs where
only the port's dependencies exist:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance rtol 1e-4 / atol 1e-5: f32 in both, summed in another order over
up to a few hundred frames (the fusion kernel) or a thousand keys (the
WavLM attention kernel). The tiny WavLM model on the card runs the
attention kernel's hd = 16 instance (hidden 64, 4 heads); wavlm-large's
hd = 64 instance is tested directly.
"""

import numpy as np
import pytest
import torch

from sdumc_tpu_torch.ops.kernels import flash_wavlm, fused_cross, fused_pool

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


NB, MD = 40, 100     # the tiny bucket config of the CPU tests


def _flash_inputs(B, T, H, hd, mask, seed=0):
    """q, k, v, gate, rel_embed, kvalid; row 0 of kvalid attends to every
    key, row 1 to one key only, the rest to a prefix ("prefix") or to a
    random pattern ("scattered")."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    q, k, v = f(B, T, H, hd), f(B, T, H, hd), f(B, T, H, hd)
    gate = torch.from_numpy((1.0 + rng.uniform(size=(B, H, T))).astype(np.float32))
    rel_embed = f(NB, H)
    if mask == "prefix":
        lengths = np.concatenate([[T, 1], rng.integers(1, T + 1, size=B - 2)])
        kvalid = np.arange(T)[None, :] < lengths[:, None]
    else:
        kvalid = rng.uniform(size=(B, T)) < 0.6
        kvalid[0] = True
        kvalid[1] = False
        kvalid[1, T // 2] = True
    return q, k, v, gate, rel_embed, torch.from_numpy(kvalid.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 63, 64, 65, 249, 1000])
@pytest.mark.parametrize("mask", ["prefix", "scattered"])
def test_flash_kernel_matches_plain(cuda, T, mask):
    hd = 16 if T == 65 else 64
    args = [t.to(cuda) for t in _flash_inputs(3, T, 4, hd, mask)]
    kw = dict(num_buckets=NB, max_distance=MD)
    with torch.inference_mode():
        got = flash_wavlm.flash_gated_attention(*args, **kw)
        ref = flash_wavlm.flash_gated_attention_plain(*args, **kw)
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        # unmasked, and a row with no valid key (averages v, as plain does)
        got = flash_wavlm.flash_gated_attention(*args[:5], **kw)
        ref = flash_wavlm.flash_gated_attention_plain(*args[:5], **kw)
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        none = torch.zeros_like(args[5])
        got = flash_wavlm.flash_gated_attention(*args[:5], none, **kw)
        ref = flash_wavlm.flash_gated_attention_plain(*args[:5], none, **kw)
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_flash_launches_and_wrapper_checks(cuda):
    q, k, v, gate, rel, kvalid = (t.to(cuda) for t in _flash_inputs(2, 70, 4, 64, "prefix"))
    kw = dict(num_buckets=NB, max_distance=MD)
    flash_wavlm.reset_launches()
    with torch.inference_mode():
        flash_wavlm.flash_gated_attention(q, k, v, gate, rel, kvalid, **kw)
        diag = flash_wavlm.bias_diag_for(rel, 70, NB, MD)
        flash_wavlm.flash_gated_attention(q, k, v, gate, None, kvalid.bool(), diag, **kw)
        assert flash_wavlm.LAUNCHES == 2
        with pytest.raises(TypeError):
            flash_wavlm.flash_gated_attention(q.double(), k.double(), v.double(),
                                              gate.double(), rel.double(), **kw)
        with pytest.raises(ValueError, match="contiguous"):
            flash_wavlm.flash_gated_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                                              k, v, gate, rel, **kw)
        with pytest.raises(ValueError, match="hd"):      # no hd = 8 instance
            flash_wavlm.flash_gated_attention(q[..., :8].contiguous(), k[..., :8].contiguous(),
                                              v[..., :8].contiguous(), gate, rel, **kw)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_wavlm.flash_gated_attention(q.requires_grad_(), k, v, gate, rel, **kw)
    assert flash_wavlm.LAUNCHES == 2


@pytest.mark.cuda
@pytest.mark.parametrize("stable", [True, False])
def test_tiny_wavlm_on_card_matches_cpu(cuda, stable):
    """A tiny WavLM (hd = 16) on the card, kernel attention, against the
    plain path on the CPU: every hidden-state tap, with a batched pad mask."""
    from sdumc_tpu_torch.cli.common import set_matmul_precision
    from sdumc_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

    set_matmul_precision("highest")
    cfg = WavLMConfig.tiny(hidden_size=64, num_heads=4, do_stable_layer_norm=stable,
                           feat_extract_norm="layer" if stable else "group")
    torch.manual_seed(0)
    model = WavLMModel(cfg).eval()
    rng = np.random.default_rng(2)
    wav = torch.from_numpy(rng.normal(size=(2, 1800)).astype(np.float32))
    t = cfg.output_length(1800)
    mask = torch.from_numpy(np.arange(t)[None, :] < np.array([t, t - 9])[:, None])
    with torch.inference_mode():
        ref = model(wav, pad_mask=mask, output_hidden_states=True)["hidden_states"]
        model.to(cuda)
        flash_wavlm.reset_launches()
        got = model(wav.to(cuda), pad_mask=mask.to(cuda),
                    output_hidden_states=True)["hidden_states"]
    assert flash_wavlm.LAUNCHES == cfg.num_layers
    keep = mask[:, :, None]
    for i, (g, r) in enumerate(zip(got, ref)):
        torch.testing.assert_close(torch.where(keep, g.cpu(), 0.0), torch.where(keep, r, 0.0),
                                   rtol=1e-4, atol=1e-4, msg=f"hidden_states[{i}]")
