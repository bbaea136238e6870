"""sdumc_tpu_torch's bf16 WavLM extraction and the flash attention's
gradient vs the JAX package on the CPU, at tiny sizes, with the same numpy
inputs on both sides.

Tolerances:
- the bf16 plain version against JAX's Pallas kernel at bf16 (interpret
  mode): ``flash_wavlm.bf16_tolerance``, element by element. Both round p =
  exp(s - m) to bf16, each against the running max of its key tiles (the
  kernel's 64 keys, JAX's ``block``), so a p may differ by a factor of 1 +-
  2^-7 and the output by 2^-7 max_u |v_u - out|, plus one bf16 ulp of the
  output (both round their f32 quotient once) and 1e-5 max |v| for the f32
  sums. At JAX's own tile the plain version differs from it in at most
  ``flash_wavlm.BF16_MISMATCH_LIMIT`` of the elements, and the variants
  that round p against another max, leave p unrounded or sum the unrounded
  p exceed that share;
- a tiny bf16 WavLM against JAX's jitted bf16 extraction: relative L2 error
  of each clip's features <= 4 u (u = 2^-8, bf16's unit roundoff). Both
  round at every op, in other places and orders (XLA fuses elementwise
  chains in f32, torch rounds each op), and each sits about 2 u from the
  f32 result, so two such runs part by about 2.8 u; and JAX's own rule
  (tests/test_wavlm.py:151-170): bf16 against f32 extraction at cosine >
  0.995 per frame;
- the flash gradients against JAX's ``flash_gated_attention_trainable`` and
  against autograd through the plain version: rtol 3e-4 / atol 3e-5, JAX's
  test's (tests/test_flash_wavlm.py:123-161; f32, another summation order);
  the loss, a sum that cancels, to 2e-5 of the sum of its terms' sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.extract.audio import extract_audio_features as jax_extract
from sdumc_tpu.models.wavlm import WavLMConfig as JaxConfig
from sdumc_tpu.models.wavlm import WavLMModel as JaxModel
from sdumc_tpu.ops.pallas.flash_wavlm import flash_gated_attention as jax_flash
from sdumc_tpu.ops.pallas.flash_wavlm import flash_gated_attention_trainable as jax_trainable
from sdumc_tpu_torch.convert import wavlm_state_dict_from_flax
from sdumc_tpu_torch.extract.audio import extract_audio_features
from sdumc_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from sdumc_tpu_torch.ops.kernels import flash_wavlm

# several test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

NB, MD = 40, 100
U = 2.0 ** -8                      # bf16's unit roundoff
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)


def _inputs(B, T, H, hd, mask, seed=0):
    """Seeded q, k, v, gate, rel_embed and a [B, T] key mask: "prefix"
    (row 0 all keys, row 1 one key, the rest random lengths), "scattered"
    (random keys, row 0 all, row 1 the middle key only) or None."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, H, hd)).astype(np.float32) for _ in range(3))
    gate = (1.0 + rng.uniform(size=(B, H, T))).astype(np.float32)
    rel = rng.normal(size=(NB, H)).astype(np.float32)
    if mask == "prefix":
        lengths = np.concatenate([[T, 1], rng.integers(1, T + 1, size=B - 2)])
        kvalid = np.arange(T)[None, :] < lengths[:, None]
    elif mask == "scattered":
        kvalid = rng.uniform(size=(B, T)) < 0.6
        kvalid[0] = True
        kvalid[1] = False
        kvalid[1, T // 2] = True
    else:
        kvalid = np.ones((B, T), bool)
    return q, k, v, gate, rel, kvalid.astype(np.float32)


@pytest.mark.parametrize("T,hd,block,mask", [
    (100, 16, 32, "prefix"), (100, 16, 32, "scattered"),
    (130, 64, 64, "prefix"), (130, 64, 64, "scattered"), (70, 64, 32, None),
])
def test_bf16_plain_matches_jax_kernel(T, hd, block, mask):
    """T not a multiple of the tile (JAX's block, the kernel's 64), hd 16
    and 64, mixed key masks: the bf16 plain version (the CPU wrapper) against
    JAX's Pallas kernel at bf16 in interpret mode, every output element."""
    q, k, v, gate, rel, kvalid = _inputs(4, T, 4, hd, mask, seed=T + hd)
    kw = dict(num_buckets=NB, max_distance=MD)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)          # noqa: E731
    want = jax_flash(bf(q), bf(k), bf(v), bf(gate), bf(rel),
                     None if mask is None else jnp.asarray(kvalid),
                     block=block, interpret=True, **kw)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    tb = lambda a: torch.from_numpy(a).bfloat16()        # noqa: E731
    got = flash_wavlm.flash_gated_attention(
        tb(q), tb(k), tb(v), tb(gate), tb(rel),
        None if mask is None else torch.from_numpy(kvalid), **kw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want).abs()
    bound = flash_wavlm.bf16_tolerance(got, tb(v))
    assert (err <= bound).all(), (err / bound).max().item()
    # the wrapper is the plain version, with or without the carried bias
    diag = flash_wavlm.bias_diag_for(tb(rel), T, NB, MD)
    assert diag.dtype == torch.bfloat16
    again = flash_wavlm.flash_gated_attention_plain(
        tb(q), tb(k), tb(v), tb(gate), None,
        None if mask is None else torch.from_numpy(kvalid), diag, **kw)
    assert torch.equal(got, again)
    # at JAX's own key tile the plain version rounds every p as JAX does
    same_tile = flash_wavlm.flash_gated_attention_plain(
        tb(q), tb(k), tb(v), tb(gate), None,
        None if mask is None else torch.from_numpy(kvalid), diag, key_tile=block, **kw)
    share = flash_wavlm.bf16_mismatch_share(same_tile, want.bfloat16())
    assert share <= flash_wavlm.BF16_MISMATCH_LIMIT, share


def _control_bf16(q, k, v, gate, diag, kvalid, variant, key_tile=flash_wavlm.KEY_TILE):
    """The bf16 plain version with one step wrong: "f32 p" (p not rounded)
    or "f32 row sum" (the row sum of the unrounded p)."""
    B, T, H, hd = q.shape
    bf = torch.bfloat16
    qs = (q * torch.tensor(hd ** -0.5, dtype=bf)).float()
    s = torch.einsum("bthd,bshd->bhts", qs, k.float())
    s = s + gate.float()[..., None] * flash_wavlm.dense_bias(diag.float(), T)[None]
    s = s.masked_fill(~(kvalid[:, None, None, :] > 0), flash_wavlm.NEG_BF16)
    n = -(-T // key_tile)
    tiles = torch.nn.functional.pad(s, (0, n * key_tile - T), value=-float("inf"))
    tiles = tiles.view(B, H, T, n, key_tile)
    m = tiles.amax(-1).cummax(-1).values
    p32 = torch.exp(tiles - m[..., None])
    p16 = p32.to(bf).float()
    carry = torch.exp(m - m[..., -1:])
    pw = p32 if variant == "f32 p" else p16
    w = (pw * carry[..., None]).view(B, H, T, n * key_tile)[..., :T]
    out = torch.einsum("bhts,bshd->bthd", w, v.float())
    return (out / (p32.sum(-1) * carry).sum(-1).transpose(1, 2)[..., None]).to(bf)


@pytest.mark.parametrize("T", [249, 700])
def test_bf16_mismatch_share_refuses_the_controls(T):
    """wavlm-large's 16 heads at hd 64, mixed key lengths (all, T - 37, 1,
    4 and random): the variants that leave p unrounded, sum the unrounded p
    or round p against the row's final max each differ from the bf16 plain
    version in more than ``BF16_MISMATCH_LIMIT`` of the output elements;
    the plain version through the wrapper equals it."""
    gen = torch.Generator().manual_seed(T)
    B, H, hd = 5, 16, 64
    q, k, v = (torch.randn(B, T, H, hd, generator=gen).bfloat16() for _ in range(3))
    gate = (1 + torch.rand(B, H, T, generator=gen)).bfloat16()
    rel = torch.randn(320, H, generator=gen).bfloat16()
    lengths = torch.tensor([T, T - 37, 1, 4, int(torch.randint(1, T + 1, (1,), generator=gen))])
    kvalid = (torch.arange(T)[None, :] < lengths[:, None]).float()
    kw = dict(num_buckets=320, max_distance=800)
    diag = flash_wavlm.bias_diag_for(rel, T, **kw)
    ref = flash_wavlm.flash_gated_attention_plain(q, k, v, gate, None, kvalid, diag, **kw)
    assert torch.equal(flash_wavlm.flash_gated_attention(q, k, v, gate, rel, kvalid, **kw), ref)
    controls = {variant: _control_bf16(q, k, v, gate, diag, kvalid, variant)
                for variant in ("f32 p", "f32 row sum")}
    controls["final max"] = flash_wavlm.flash_gated_attention_plain(
        q, k, v, gate, None, kvalid, diag, key_tile=T, **kw)
    shares = {name: flash_wavlm.bf16_mismatch_share(c, ref) for name, c in controls.items()}
    assert all(share > flash_wavlm.BF16_MISMATCH_LIMIT for share in shares.values()), shares


@pytest.mark.parametrize("stable,norm", [(True, "layer"), (False, "group")])
def test_bf16_model_matches_jax(stable, norm):
    """A tiny WavLM with attention_impl="flash" through extract_audio_features
    at dtype="bfloat16": the port (the kernel's bf16 plain version on the
    CPU) against JAX's jitted extraction (its Pallas kernel in interpret
    mode), mixed lengths in padded batches; then the port's bf16 against its
    own f32 extraction, JAX's cosine rule."""
    jcfg = JaxConfig.tiny(attention_impl="flash", do_stable_layer_norm=stable,
                          feat_extract_norm=norm)
    rng = np.random.default_rng(4)
    wavs = [rng.normal(size=(n,)).astype(np.float32) for n in (300, 800, 555)]
    jmodel = JaxModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(wavs[1][None]))["params"]
    kw = dict(layer_ids=(-2, -1), batch_size=2, buckets=(400, 800))
    want = jax_extract(jmodel, params, jcfg, wavs, dtype="bfloat16", **kw)

    cfg = WavLMConfig.tiny(attention_impl="flash", do_stable_layer_norm=stable,
                           feat_extract_norm=norm)
    model = WavLMModel(cfg).eval()
    model.load_state_dict(wavlm_state_dict_from_flax(params), strict=True)
    f32 = extract_audio_features(model, cfg, wavs, device="cpu", **kw)
    got = extract_audio_features(model, cfg, wavs, device="cpu", dtype="bfloat16", **kw)
    assert next(model.parameters()).dtype == torch.bfloat16
    for g, w, f in zip(got, want, f32):
        assert g.shape == w.shape == f.shape and g.dtype == np.float32
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 4 * U, rel
        cos = np.sum(g * f, -1) / (np.linalg.norm(g, axis=-1) * np.linalg.norm(f, axis=-1))
        assert float(cos.min()) > 0.995, float(cos.min())


def _loss_weights(shape, kvalid):
    w = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    return w * (kvalid[:, :, None, None] > 0)        # pad query rows are never consumed


@pytest.mark.parametrize("mask", ["prefix", "scattered"])
def test_flash_gradients_match_jax_and_plain(mask):
    """FlashGatedAttention's dq, dk, dv, dgate and d rel_embed (through
    bias_diag_for's gather) against JAX's trainable wrapper (its custom_vjp:
    the chunked scan) and against autograd through the plain version; T = 150
    spans two backward chunks of 128."""
    q, k, v, gate, rel, kvalid = _inputs(3, 150, 4, 16, mask, seed=3)
    w = _loss_weights(q.shape, kvalid)

    def loss_jax(*args):
        out = jax_trainable(*args, jnp.asarray(kvalid), num_buckets=NB, max_distance=MD,
                            block=32, chunk=32, interpret=True)
        return jnp.sum(out * w)

    want_val, want = jax.value_and_grad(loss_jax, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (q, k, v, gate, rel)))
    names = ("dq", "dk", "dv", "dgate", "d_rel_embed")
    for fn in (flash_wavlm.flash_gated_attention, flash_wavlm.flash_gated_attention_plain):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, gate, rel)]
        out = fn(*leaves, torch.from_numpy(kvalid), num_buckets=NB, max_distance=MD)
        loss = (out * torch.from_numpy(w)).sum()
        # the loss cancels: hold it to 2e-5 of the sum of its terms' sizes
        scale = (out * torch.from_numpy(w)).abs().sum().item()
        assert abs(loss.item() - float(want_val)) <= 2e-5 * scale
        grads = torch.autograd.grad(loss, leaves)
        for name, g, ref in zip(names, grads, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(ref), **GRAD_TOL,
                                       err_msg=f"{fn.__name__} {name}")


def test_flash_function_backward_in_chunks():
    """The Function's backward equals autograd through the plain version at
    several chunk sizes (one chunk, a ragged last chunk, one row a chunk),
    without a mask, and its bf16 gradients take the inputs' dtypes."""
    q, k, v, gate, rel, _ = _inputs(2, 70, 4, 16, None, seed=9)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, gate))
    diag = flash_wavlm.bias_diag_for(torch.from_numpy(rel), 70, NB, MD)
    kw = dict(num_buckets=NB, max_distance=MD)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv, tg, diag)]
    out = flash_wavlm.flash_gated_attention_plain(*leaves[:4], None, None, leaves[4], **kw)
    dout = torch.from_numpy(np.random.default_rng(1).normal(size=q.shape).astype(np.float32))
    want = torch.autograd.grad(out, leaves, dout)
    for chunk in (128, 32, 1):
        got = flash_wavlm.flash_backward(tq, tk, tv, tg, diag, None, out.detach(), dout,
                                         chunk=chunk)
        for name, g, ref in zip(("dq", "dk", "dv", "dgate", "d_bias_diag"), got, want):
            torch.testing.assert_close(g, ref, **GRAD_TOL, msg=f"chunk {chunk} {name}")
    leaves = [t.bfloat16().requires_grad_() for t in (tq, tk, tv, tg, torch.from_numpy(rel))]
    out = flash_wavlm.flash_gated_attention(*leaves, **kw)
    grads = torch.autograd.grad(out.float().sum(), leaves)
    assert out.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all() for g in grads)


def test_wavlm_flash_path_trains_like_einsum():
    """Grad enabled, the tiny WavLM's flash path goes through the Function
    (as JAX's flash path always goes through its trainable wrapper); every
    parameter's gradient equals the einsum path's, rel_attn_embed's summed
    over both layers."""
    torch.manual_seed(0)
    cfg = WavLMConfig.tiny(attention_impl="einsum")
    ref_model = WavLMModel(cfg)
    model = WavLMModel(WavLMConfig.tiny(attention_impl="flash"))
    model.load_state_dict(ref_model.state_dict())
    wav = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 900)).astype(np.float32))
    t = cfg.output_length(900)
    mask = torch.from_numpy(np.arange(t)[None, :] < np.array([t, t - 9])[:, None])
    grads = []
    for m in (ref_model, model):
        hs = m(wav, pad_mask=mask, output_hidden_states=True)["hidden_states"]
        (hs[-1] * mask[:, :, None]).square().sum().backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    assert grads[1]["encoder.layers.0.attention.rel_attn_embed.weight"].abs().max() > 0
    for name, ref in grads[0].items():
        got = grads[1][name]
        tol = GRAD_TOL["rtol"] * ref.abs().max().item() + GRAD_TOL["atol"]
        assert (got - ref).abs().max().item() <= tol, name
