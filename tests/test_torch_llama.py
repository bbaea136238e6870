"""sdumc_tpu_torch's LLaMA decoder, its converters and int8 weights against
the JAX package and HF on the CPU, at tiny sizes, the same numpy inputs on
both sides.

Tolerances: against HF rtol/atol 1e-5 (the same torch ops in another
arrangement); against JAX 1e-5 (f32, XLA and torch sum in other orders);
int8 codes and scales equal to the bit; the bf16 model against JAX's bf16
model 2e-2 of the largest logit (bf16 rounds at other places in the two
frameworks; the point there is which tensors stay f32).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdumc_tpu.convert.hf_llama import config_from_hf as jax_config_from_hf
from sdumc_tpu.convert.hf_llama import hf_llama_to_params, stack_scan_layers
from sdumc_tpu.models import llama as jl
from sdumc_tpu.models.generation import _gather_caches as jax_gather
from sdumc_tpu.models.generation import _slot_mask as jax_slot_mask
from sdumc_tpu.models.generation import exact_topk as jax_exact_topk
from sdumc_tpu.ops.quant import dequantize_kernel as jax_dequantize_kernel
from sdumc_tpu.ops.quant import quantize_kernel as jax_quantize_kernel
from sdumc_tpu.ops.quant import quantize_params as jax_quantize_params
from sdumc_tpu_torch.convert import llama_state_dict_from_flax
from sdumc_tpu_torch.convert.hf_llama import config_from_hf, load_hf_llama
from sdumc_tpu_torch.models.generation import _gather_caches, _slot_mask, exact_topk
from sdumc_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM, cache_mask, init_cache,
                                          quantize_kv, rope, split_cache_from_prefill)
from sdumc_tpu_torch.ops.quant import (dequantize_kernel, int8_matmul, quantize_kernel,
                                       quantize_params)

# several test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def hf_model(seed=0, kv_heads=4, **kw):
    """A tiny random HF LlamaForCausalLM (eager attention) and its config."""
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM as HFLlama

    base = dict(vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=3,
                num_attention_heads=4, num_key_value_heads=kv_heads,
                max_position_embeddings=128, attn_implementation="eager")
    base.update(kw)
    hf_cfg = HFConfig(**base)
    torch.manual_seed(seed)
    return hf_cfg, HFLlama(hf_cfg).eval()


def port_from_hf(hf, hf_cfg, dtype=torch.float32):
    cfg = config_from_hf(hf_cfg.to_dict(), dtype)
    model = LlamaForCausalLM(cfg).eval()
    model.load_state_dict({k: v.to(torch.float32 if k.endswith("norm.weight") else dtype)
                           for k, v in hf.state_dict().items()}, strict=True)
    return cfg, model


def jax_from_hf(hf, hf_cfg, dtype=jnp.float32, **kw):
    cfg = jax_config_from_hf(hf_cfg)
    cfg = jl.LlamaConfig(**{**cfg.__dict__, "dtype": dtype, **kw})
    return cfg, hf_llama_to_params(hf.state_dict())


def _trio(kv_heads):
    hf_cfg, hf = hf_model(kv_heads=kv_heads)
    cfg, port = port_from_hf(hf, hf_cfg)
    jcfg, params = jax_from_hf(hf, hf_cfg)
    return hf, cfg, port, jcfg, params


@pytest.fixture(scope="module")
def trio():
    """HF, the port and JAX on the same tiny weights (4 heads, MHA)."""
    return _trio(4)


@pytest.fixture(scope="module")
def gqa_trio():
    """The same with 2 kv heads for 4 query heads (grouped-query attention)."""
    return _trio(2)


@pytest.mark.parametrize("heads", ["trio", "gqa_trio"])
def test_forward_logits_and_hidden_match_hf_and_jax(request, heads):
    hf, cfg, port, jcfg, params = request.getfixturevalue(heads)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 11))
    with torch.no_grad():
        want = hf(torch.tensor(ids), output_hidden_states=True)
        got = port(input_ids=torch.tensor(ids), output_hidden_states=True)
    jx = jl.LlamaForCausalLM(jcfg).apply({"params": params}, input_ids=jnp.asarray(ids),
                                         output_hidden_states=True)
    np.testing.assert_allclose(_np(got["logits"]), want.logits.numpy(), **TOL)
    np.testing.assert_allclose(_np(got["logits"]), np.asarray(jx["logits"]), **TOL)
    assert len(got["hidden_states"]) == len(want.hidden_states) == len(jx["hidden_states"])
    for g, h, j in zip(got["hidden_states"], want.hidden_states, jx["hidden_states"]):
        np.testing.assert_allclose(_np(g), h.numpy(), **TOL)
        np.testing.assert_allclose(_np(g), np.asarray(j), **TOL)


@pytest.mark.parametrize("layout", ["unrolled", "stacked"])
def test_state_dict_from_flax_both_layouts(trio, layout):
    """JAX's param tree (unrolled, or stacked by stack_scan_layers) carried
    across by llama_state_dict_from_flax gives the HF-loaded model's keys
    and values."""
    _, cfg, port, _, params = trio
    tree = stack_scan_layers(params) if layout == "stacked" else params
    sd = llama_state_dict_from_flax(tree)
    want = port.state_dict()
    assert sorted(sd) == sorted(want)
    for key, val in want.items():
        torch.testing.assert_close(sd[key], val, rtol=0, atol=0)


def test_bf16_dtype_placement_matches_jax():
    """bf16 model: activations bf16; norm scales, the tap sum and the logits
    f32; logits close to JAX's bf16 model on the same weights."""
    hf_cfg, hf = hf_model(seed=3)
    cfg, port = port_from_hf(hf, hf_cfg, torch.bfloat16)
    jcfg, params = jax_from_hf(hf, hf_cfg, jnp.bfloat16)
    assert port.model.norm.weight.dtype == torch.float32
    assert port.model.layers[0].self_attn.q_proj.weight.dtype == torch.bfloat16
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(2, 9))
    with torch.no_grad():
        got = port(input_ids=torch.tensor(ids), output_hidden_states=True,
                   tap_sum_layers=(-4, -3, -2, -1))
    jx = jl.LlamaForCausalLM(jcfg).apply({"params": params}, input_ids=jnp.asarray(ids))
    assert got["last_hidden_state"].dtype == torch.bfloat16
    assert got["logits"].dtype == got["tap_sum"].dtype == torch.float32
    want = np.asarray(jx["logits"], np.float32)
    err = np.abs(_np(got["logits"]) - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_kv_cache_decode_matches_full_forward_and_jax(trio, kv_quant):
    """Prefill 6 tokens into a monolithic cache, then decode 3 one at a
    time: equal to the full forward (exact cache) and to JAX's cached
    decode (both caches)."""
    import dataclasses

    _, cfg, port, jcfg, params = trio
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    jcfg = jl.LlamaConfig(**{**jcfg.__dict__, "kv_quant": kv_quant})
    model = LlamaForCausalLM(cfg).eval()
    model.load_state_dict(port.state_dict())
    jmodel = jl.LlamaForCausalLM(jcfg)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(1, 9))
    with torch.no_grad():
        full = model(input_ids=torch.tensor(ids))["logits"]
        caches = init_cache(cfg, 1, 16)
        jcaches = jl.init_cache(jcfg, 1, 16)
        for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 9)):
            pos = np.arange(lo, hi)[None]
            out = model(input_ids=torch.tensor(ids[:, lo:hi]), positions=torch.tensor(pos),
                        attn_mask=cache_mask(torch.tensor(pos), 16), caches=caches)
            jout = jmodel.apply({"params": params}, input_ids=jnp.asarray(ids[:, lo:hi]),
                                positions=jnp.asarray(pos),
                                attn_mask=jl.cache_mask(jnp.asarray(pos), 16), caches=jcaches)
            jcaches = jout["caches"]
            np.testing.assert_allclose(_np(out["logits"][:, -1]),
                                       np.asarray(jout["logits"][:, -1]), **TOL)
            if kv_quant is None:
                np.testing.assert_allclose(_np(out["logits"][:, -1]), _np(full[:, hi - 1]),
                                           rtol=2e-5, atol=2e-5)
    assert caches[0]["index"] == 9
    assert caches[0]["k"].dtype == (torch.int8 if kv_quant else torch.float32)


@pytest.mark.parametrize("heads,kv_quant", [("trio", None), ("trio", "int8"), ("gqa_trio", None)])
def test_split_cache_decode_matches_jax(request, heads, kv_quant):
    """Left-padded prefill of 2 clips, the split cache for 3 beams, then 3
    decode steps with a beam reorder after each: logits and tap sums equal
    JAX's unrolled split-cache decode (for GQA, JAX repeats the kv heads,
    the port groups the query heads)."""
    import dataclasses

    _, cfg, port, jcfg, params = request.getfixturevalue(heads)
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    jcfg = jl.LlamaConfig(**{**jcfg.__dict__, "kv_quant": kv_quant})
    model = LlamaForCausalLM(cfg).eval()
    model.load_state_dict(port.state_dict())
    jmodel = jl.LlamaForCausalLM(jcfg)
    rng = np.random.default_rng(3)
    C, P, B, G = 2, 8, 3, 5
    lens = np.array([8, 5])
    offset = P - lens
    embeds = (rng.normal(size=(C, P, cfg.hidden_size)) * 0.5).astype(np.float32)
    embeds[1, :offset[1]] = 0.0
    pos = np.maximum(np.arange(P)[None] - offset[:, None], 0)
    slot = np.broadcast_to(np.arange(P)[None], (C, P))
    with torch.no_grad():
        pre = init_cache(cfg, C, P)
        out = model(inputs_embeds=torch.tensor(embeds), positions=torch.tensor(pos),
                    attn_mask=_slot_mask(torch.tensor(slot), P, torch.tensor(offset)),
                    caches=pre, last_logit_only=True)
        caches = split_cache_from_prefill(cfg, pre, B, G)
        jmask = jax_slot_mask(jnp.asarray(slot), P, jnp.asarray(offset)[:, None, None, None])
        jout = jmodel.apply({"params": params}, inputs_embeds=jnp.asarray(embeds),
                            positions=jnp.asarray(pos), attn_mask=jmask,
                            caches=jl.init_cache(jcfg, C, P), last_logit_only=True)
        np.testing.assert_allclose(_np(out["logits"]), np.asarray(jout["logits"]), **TOL)
        jcaches = jl.split_cache_from_prefill(jcfg, jout["caches"], B, G)
        pmask = np.where(np.arange(P)[None] >= offset[:, None], 0.0, -1e30).astype(np.float32)
        for step in range(3):
            toks = rng.integers(0, cfg.vocab_size, size=(C * B, 1))
            rpos = np.repeat(lens + step, B)[:, None]
            out = model(input_ids=torch.tensor(toks), positions=torch.tensor(rpos),
                        attn_mask=torch.tensor(pmask), caches=caches,
                        tap_sum_layers=(-4, -3, -2, -1))
            jout = jmodel.apply({"params": params}, input_ids=jnp.asarray(toks),
                                positions=jnp.asarray(rpos), attn_mask=jnp.asarray(pmask),
                                caches=jcaches, tap_sum_layers=(-4, -3, -2, -1))
            np.testing.assert_allclose(_np(out["logits"]), np.asarray(jout["logits"]), **TOL)
            np.testing.assert_allclose(_np(out["tap_sum"]), np.asarray(jout["tap_sum"]), **TOL)
            rows = np.concatenate([c * B + rng.permutation(B) for c in range(C)])
            rows[0] = rows[1]                            # two beams from one ancestor
            _gather_caches(caches, torch.tensor(rows), step + 1)
            jcaches = jax_gather(jout["caches"], jnp.asarray(rows))
    for key in ("gk", "gv"):
        got = caches[0][key][:, :3].float().numpy()
        np.testing.assert_allclose(got, np.asarray(jcaches[0][key][:, :3], np.float32), **TOL)


@pytest.mark.parametrize("layers,taps", [(2, (-4, -3, -2, -1)), (3, (-4, -3, -2, -1)),
                                         (2, (0, -6, 5)), (3, (1, -1))])
def test_tap_sum_layers_match_stacked_sum_and_jax(layers, taps):
    """tap_sum equals the sum of the selected HF-convention hidden states,
    with out-of-range indices dropped (the shallow-model clamp), and JAX's
    tap_sum; the raw last-layer output never enters it."""
    cfg = LlamaConfig.tiny(num_layers=layers)
    jcfg = jl.LlamaConfig.tiny(num_layers=layers)
    ids = jnp.asarray(np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 7)))
    params = jl.LlamaModel(jcfg).init(jax.random.PRNGKey(0), input_ids=ids)["params"]
    model = LlamaForCausalLM(cfg).eval()
    sd = llama_state_dict_from_flax({"model": params, "lm_head": {
        "kernel": np.zeros((cfg.hidden_size, cfg.vocab_size), np.float32)}})
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = model.model(input_ids=torch.tensor(np.asarray(ids)), output_hidden_states=True,
                          tap_sum_layers=taps)
    n = len(out["hidden_states"])
    want = sum((_np(out["hidden_states"][i % n]) for i in set(t % n for t in taps
                                                               if -n <= t < n)),
               np.zeros(out["tap_sum"].shape, np.float32))
    np.testing.assert_allclose(_np(out["tap_sum"]), want, rtol=1e-6, atol=1e-6)
    jx = jl.LlamaModel(jcfg).apply({"params": params}, input_ids=ids, tap_sum_layers=taps)
    np.testing.assert_allclose(_np(out["tap_sum"]), np.asarray(jx["tap_sum"]), **TOL)


@pytest.mark.parametrize("shape,k", [((4, 1000), 8), ((1, 33), 5), ((3, 64), 1),
                                     ((2, 4, 50), 6)])
def test_exact_topk_matches_lax_topk_with_ties(shape, k):
    """Values and indices equal lax.top_k's and JAX's exact_topk, ties to
    the lowest index: duplicated leaders and a run of equal values."""
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    x[..., 1] = x[..., 0]
    x[..., 5:9] = x.max(axis=-1, keepdims=True)                  # a 4-way tie at the top
    v, i = exact_topk(torch.from_numpy(x), k)
    v_ref, i_ref = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(_np(v), np.asarray(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    if len(shape) == 2:
        v_j, i_j = jax_exact_topk(jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))


@pytest.mark.parametrize("shape", [(64, 96), (3, 16, 8)])
def test_quantize_kernel_matches_jax_bitwise(shape):
    """The port's [out, in] layout against JAX's [in, out]: codes, scales
    and the dequantized weights equal to the bit."""
    w = (np.random.default_rng(1).normal(size=shape) * 0.02).astype(np.float32)
    if len(shape) == 3:
        w[1] *= 10.0
    q, s = quantize_kernel(torch.from_numpy(np.swapaxes(w, -1, -2).copy()))
    jq, js = jax_quantize_kernel(jnp.asarray(w))
    np.testing.assert_array_equal(np.swapaxes(q.numpy(), -1, -2), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = dequantize_kernel(q, s, torch.float32).numpy()
    np.testing.assert_array_equal(np.swapaxes(back, -1, -2),
                                  np.asarray(jax_dequantize_kernel(jq, js, jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_and_quantize_kv_match_jax(dtype):
    """Rotary embedding (half-split, f32 inside, cast back) and the int8 KV
    quantizer against JAX's."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 5))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got = rope(torch.from_numpy(x).to(dtype), torch.from_numpy(pos), 10000.0)
    want = jl.rope(jnp.asarray(x, jdt), jnp.asarray(pos), 10000.0)
    assert got.dtype == dtype
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)
    q, s = quantize_kv(torch.from_numpy(x))
    jq, js = jl.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("M", [1, 16, 17, 40])
def test_int8_matmul_is_the_exact_integer_product(M):
    rng = np.random.default_rng(M)
    a = rng.integers(-127, 128, size=(M, 48), dtype=np.int8)
    w = rng.integers(-127, 128, size=(24, 48), dtype=np.int8)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)


@pytest.mark.parametrize("mode,scan", [("int8", False), ("w8a8", True)])
def test_quantized_forward_matches_jax(mode, scan):
    """JAX's quantize_params tree carried across, and the port's own
    quantize_params on the float state dict, give JAX's quantized logits."""
    jcfg = jl.LlamaConfig.tiny(scan_layers=scan)
    ids = jnp.asarray(np.random.default_rng(2).integers(0, 128, (2, 12)))
    params = jl.LlamaForCausalLM(jcfg).init(jax.random.PRNGKey(0), input_ids=ids)["params"]
    qjcfg = jl.LlamaConfig.tiny(scan_layers=scan, quant=mode)
    qparams = jax_quantize_params(params, mode=mode)
    want = jl.LlamaForCausalLM(qjcfg).apply({"params": qparams}, input_ids=ids)["logits"]

    cfg = LlamaConfig.tiny(quant=mode)
    ported = LlamaForCausalLM(cfg).eval()
    ported.load_state_dict(llama_state_dict_from_flax(qparams), strict=True)
    own = LlamaForCausalLM(cfg).eval()
    sd = llama_state_dict_from_flax(params)
    own.load_state_dict(quantize_params(sd, mode), strict=True)
    assert sd == {}                                   # every entry was consumed
    for model in (ported, own):
        with torch.no_grad():
            got = model(input_ids=torch.tensor(np.asarray(ids)))["logits"]
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _save_hf_dir(hf, path, **kw):
    hf.save_pretrained(path, **kw)
    return path


@pytest.mark.parametrize("fmt", ["sharded_bin", "safetensors"])
def test_hf_loader_reads_every_weight_format(tmp_path, fmt):
    """config.json + shards pytorch_model-0000k-of-0000n.bin with their
    index, or model.safetensors: the loaded model gives HF's logits; the
    default dtype is bf16 with f32 norm scales; an old checkpoint's
    rotary_emb.inv_freq keys are ignored."""
    hf_cfg, hf = hf_model(seed=7)
    kw = dict(safe_serialization=fmt.endswith("safetensors"))
    if fmt.startswith("sharded"):
        kw["max_shard_size"] = "100KB"
    path = _save_hf_dir(hf, str(tmp_path / fmt), **kw)
    files = os.listdir(path)
    if fmt == "sharded_bin":
        assert "pytorch_model.bin.index.json" in files
        shard = sorted(f for f in files if f.startswith("pytorch_model-"))[0]
        sd = torch.load(os.path.join(path, shard), weights_only=True)
        sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(8)
        torch.save(sd, os.path.join(path, shard))
    cfg, model = load_hf_llama(path, dtype=torch.float32)
    ids = torch.tensor(np.random.default_rng(8).integers(0, 128, size=(1, 10)))
    with torch.no_grad():
        np.testing.assert_allclose(_np(model(input_ids=ids)["logits"]), hf(ids).logits.numpy(),
                                   **TOL)
    _, bf = load_hf_llama(path)
    assert bf.cfg.dtype == torch.bfloat16
    assert bf.lm_head.weight.dtype == torch.bfloat16
    assert bf.model.layers[1].input_layernorm.weight.dtype == torch.float32


def test_hf_loader_raises_on_missing_weights(tmp_path):
    hf_cfg, hf = hf_model(seed=9)
    path = _save_hf_dir(hf, str(tmp_path / "m"), safe_serialization=False)
    sd = torch.load(os.path.join(path, "pytorch_model.bin"), weights_only=True)
    del sd["model.layers.2.mlp.up_proj.weight"]
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with pytest.raises(KeyError, match="up_proj"):
        load_hf_llama(path)
    with open(os.path.join(path, "config.json")) as f:
        assert json.load(f)["num_hidden_layers"] == 3
