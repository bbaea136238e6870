"""Flax params of the JAX package -> the port's state_dict.

For the fusion net, the inverse of the reference-key table in
``sdumc_tpu/convert/torch_to_jax.py``, kept here as the port's own copy;
for WavLM, LLaMA, MANet, Whisper and the vision encoders (CLIP, DINOv2,
VideoMAE, EVA-02, ResNet), the inverses of the JAX package's
``convert/{hf_wavlm,hf_llama,torch_manet,hf_whisper,hf_clip,hf_dinov2,
hf_videomae,timm_eva02,torch_resnet}.py``; for the baseline families, their
flax param paths (``baseline_state_dict_from_flax``); for the text families
(BERT, ALBERT, DeBERTa, BLOOM, GLM), the inverses of
``convert/hf_{bert,albert,deberta,bloom,glm}.py``
(``{family}_state_dict_from_flax``).
The port names its submodules after the reference torch (or HF)
state_dict, so the keys produced here are those keys: Dense ``kernel``
[in, out] transposes to Linear ``weight`` [out, in], a Flax conv kernel
[k, in/groups, out] to a torch Conv1d weight [out, in/groups, k] (a 2-d
[kh, kw, in, out] to Conv2d's [out, in, kh, kw], VideoMAE's 3-d
[kt, kh, kw, in, out] to Conv3d's [out, in, kt, kh, kw]).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

MLP_NAMES = frozenset({
    "audio_mlp", "text_mlp", "video_mlp", "attention_mlp",
    "cross_fused_query_mlp", "cross_at_query_mlp", "cross_tv_query_mlp",
    "cross_av_query_mlp", "cross_audio_query_mlp", "cross_text_query_mlp",
    "cross_video_query_mlp", "cross_audio_mlp", "cross_text_mlp",
    "cross_video_mlp", "cross_attention_mlp",
})
PLAIN_LINEAR = frozenset({
    "frame_dim_reshape_0", "frame_dim_reshape_1", "frame_dim_reshape_2",
    "fc_att", "cross_fc_att", "fc_out_e", "fc_out_v", "fc_out_ev",
})
FRA2UTT = frozenset({"fra2utt_0", "fra2utt_1", "fra2utt_2"})
XATT = frozenset({"cross_att_fra2utt_0", "cross_att_fra2utt_1", "cross_att_fra2utt_2"})
IMAG = frozenset({"missing_text_imagination_mlp",
                  "missing_cross_text_query_imagination_mlp"})

_LEAF = {"kernel": "weight", "bias": "bias"}
_NORM_LEAF = {"scale": "weight", "bias": "bias"}


def torch_key_for(path: Tuple[str, ...]) -> Optional[str]:
    """Reference state_dict key of one Flax param path, or None."""
    name = path[0]
    if name in MLP_NAMES:       # (name, linear_i, dense, leaf) -> Sequential idx 3i
        i = int(path[1].split("_")[1])
        return f"{name}.{3 * i}.{_LEAF[path[3]]}"
    if name.startswith("orgin_linear_change_"):   # Sequential(Linear, ReLU, Linear)
        i = int(name.rsplit("_", 1)[1])
        return f"orgin_linear_change.{2 * i}.{_LEAF[path[2]]}"
    if name in FRA2UTT and path[1] == "context":
        return f"{name}.attention_context_vector"
    if name in FRA2UTT or name in XATT:
        return f"{name}.{path[1]}.{_LEAF[path[3]]}"
    if name in PLAIN_LINEAR:
        return f"{name}.{_LEAF[path[2]]}"
    if name == "prelu_weight":
        return "prelu.weight"
    if name == "layer_normali":
        return f"layer_normali.{_NORM_LEAF[path[1]]}"
    if name in IMAG:
        sub, leaf = path[1], _LEAF[path[3]]
        if sub.startswith("transition_"):
            return f"{name}.transition.{2 * int(sub.split('_')[1])}.{leaf}"
        kind, blk, i = sub.split("_")            # encoder_{blk}_{i}
        return f"{name}.{kind}_{blk}.{3 * int(i)}.{leaf}"
    return None


def _leaves(tree, prefix=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX SDUMCFusion's params (a nested dict of arrays) as the port's
    state_dict. Raises on a param path with no reference key."""
    out = {}
    for path, value in _leaves(params):
        key = torch_key_for(path)
        if key is None:
            raise KeyError(f"no port key for flax param {'/'.join(path)}")
        arr = np.array(value, dtype=np.float32)
        if path[-1] == "kernel" and arr.ndim == 2:
            arr = arr.T
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


_WAVLM_TOP = {
    "feature_ln": "feature_projection.layer_norm",
    "feature_projection": "feature_projection.projection",
    "pos_conv_embed": "encoder.pos_conv_embed.conv",
    "encoder_ln": "encoder.layer_norm",
}
_WAVLM_LAYER = {
    "layer_norm": "layer_norm", "final_layer_norm": "final_layer_norm",
    "intermediate_dense": "feed_forward.intermediate_dense",
    "output_dense": "feed_forward.output_dense",
}
_WAVLM_ATTN = {"q_proj", "k_proj", "v_proj", "out_proj", "gru_rel_pos_linear"}


def wavlm_key_for(path: Tuple[str, ...]) -> Optional[str]:
    """The port's WavLMModel key of one Flax param path, or None."""
    name, leaf = path[0], path[-1]
    if name == "feature_extractor":
        sub = path[1]
        if len(path) == 2:                       # conv_{i}_kernel / conv_{i}_bias
            _, i, kind = sub.split("_")
            return f"feature_extractor.conv_layers.{i}.conv.{_LEAF[kind]}"
        if len(path) == 3 and leaf in _NORM_LEAF and (sub.startswith("ln_") or sub == "gn_0"):
            i = sub.split("_")[1]
            return f"feature_extractor.conv_layers.{i}.layer_norm.{_NORM_LEAF[leaf]}"
        return None
    if name in _WAVLM_TOP and len(path) == 2:
        table = _NORM_LEAF if name.endswith("_ln") else _LEAF
        return f"{_WAVLM_TOP[name]}.{table[leaf]}" if leaf in table else None
    if name.startswith("layers_"):
        pre = f"encoder.layers.{int(name.split('_')[1])}"
        if path[1] == "attention":
            if path[2:] == ("gru_rel_pos_const",):
                return f"{pre}.attention.gru_rel_pos_const"
            if path[2:] == ("rel_attn_embed",):
                return f"{pre}.attention.rel_attn_embed.weight"
            if len(path) == 4 and path[2] in _WAVLM_ATTN and leaf in _LEAF:
                return f"{pre}.attention.{path[2]}.{_LEAF[leaf]}"
            return None
        if len(path) == 3 and path[1] in _WAVLM_LAYER:
            table = _NORM_LEAF if path[1].endswith("layer_norm") else _LEAF
            return f"{pre}.{_WAVLM_LAYER[path[1]]}.{table[leaf]}" if leaf in table else None
    return None


def wavlm_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX WavLMModel's params (a nested dict of arrays) as the port's
    state_dict. Raises on a param path it does not know."""
    out = {}
    for path, value in _leaves(params):
        key = wavlm_key_for(path)
        if key is None:
            raise KeyError(f"no port key for flax param {'/'.join(path)}")
        arr = np.array(value, dtype=np.float32)
        if arr.ndim == 3 and path[-1].endswith("kernel"):    # conv [k, in/g, out]
            arr = arr.transpose(2, 1, 0)
        elif arr.ndim == 2 and path[-1] == "kernel":         # dense [in, out]
            arr = arr.T
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


_LLAMA_LEAF = {"kernel": "weight", "kernel_q": "weight_q", "kernel_scale": "weight_scale",
               "scale": "weight", "embedding": "weight"}


def _llama_leaf(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, torch.Tensor]:
    """The port key and tensor of one unstacked JAX LLaMA leaf (path below
    ``model``'s layer or at the top)."""
    leaf = path[-1]
    if leaf not in _LLAMA_LEAF:
        raise KeyError(f"no port key for flax param {'/'.join(path)}")
    if leaf in ("kernel", "kernel_q"):          # Dense [in, out] -> Linear [out, in]
        arr = arr.T
    dtype = np.int8 if leaf == "kernel_q" else np.float32
    return ".".join(path[:-1] + (_LLAMA_LEAF[leaf],)), torch.from_numpy(
        np.array(arr, dtype=dtype, order="C"))


def llama_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX LlamaForCausalLM's params as the port's (HF-named) state dict.
    Takes both of JAX's layouts, unrolled ``layers_{i}`` and the stacked
    ``layers`` of ``stack_scan_layers`` (leading [L] axis), and the quantized
    tree of ``ops.quant.quantize_params`` (``kernel_q`` int8 /
    ``kernel_scale``). Raises on a param path it does not know."""
    out = {}
    for path, value in _leaves(params):
        arr = np.asarray(value)
        if path[0] == "model" and path[1].startswith("layers_"):
            pre = ("model", "layers", path[1].split("_")[1])
            key, t = _llama_leaf(pre + path[2:], arr)
            out[key] = t
        elif path[0] == "model" and path[1] == "layers":
            for i in range(arr.shape[0]):
                key, t = _llama_leaf(("model", "layers", str(i)) + path[2:], arr[i])
                out[key] = t
        elif path in (("model", "embed_tokens", "embedding"), ("model", "norm", "scale")) \
                or path[0] == "lm_head":
            key, t = _llama_leaf(path, arr)
            out[key] = t
        else:
            raise KeyError(f"no port key for flax param {'/'.join(path)}")
    return out


_MANET_SUB = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1",
              "gate_fc1": "ChannelGate.mlp.1", "gate_fc2": "ChannelGate.mlp.3",
              "spatial_conv": "SpatialGate.spatial.conv", "spatial_bn": "SpatialGate.spatial.bn"}
_MANET_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight", "mean": "running_mean",
               "var": "running_var"}


def manet_key_for(path: Tuple[str, ...]) -> str:
    """The port's (the reference's) MANet key of one Flax path of either
    collection: ``layer3_1_p1_0/cbam/spatial_bn/bn/scale`` ->
    ``layer3_1_p1.0.cbam.SpatialGate.spatial.bn.weight``."""
    *scopes, leaf = path
    if leaf not in _MANET_LEAF:
        raise KeyError(f"no port key for flax MANet path {'/'.join(path)}")
    names = []
    for i, s in enumerate(scopes):
        if s == "bn" and i == len(scopes) - 1:        # the BN wrapper's inner module
            continue
        if i == 0 and s.startswith("layer"):          # layer3_1_p1_0 -> layer3_1_p1.0
            stage, block = s.rsplit("_", 1)
            names += [stage, block]
        else:
            names.append(_MANET_SUB.get(s, s))
    return ".".join(names + [_MANET_LEAF[leaf]])


def manet_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """JAX MANet's ``{"params", "batch_stats"}`` (arrays) as the port's state
    dict: conv kernels [kh, kw, I, O] -> [O, I, kh, kw], dense kernels
    transposed, BN scale / bias / mean / var to weight / bias /
    running_mean / running_var (``num_batches_tracked`` is not carried)."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            arr = np.array(value, dtype=np.float32)
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            out[manet_key_for(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def whisper_key_for(path: Tuple[str, ...]) -> str:
    """Port (HF) key of one param path of the JAX WhisperModel:
    ``encoder/layers_0_self_attn/q_proj/kernel`` ->
    ``encoder.layers.0.self_attn.q_proj.weight``."""
    side, name, *rest = path
    leaf = {**_LEAF, **_NORM_LEAF}
    if name in ("embed_positions", "embed_tokens") and not rest:
        return f"{side}.{name}.weight"
    if name.startswith("layers_"):
        _, i, sub = name.split("_", 2)
        name = f"layers.{i}.{sub}"
    if len(rest) == 2:                     # an attention projection
        return f"{side}.{name}.{rest[0]}.{leaf[rest[1]]}"
    if len(rest) == 1 and rest[0] in leaf:
        return f"{side}.{name}.{leaf[rest[0]]}"
    raise KeyError(f"no port key for flax param {'/'.join(path)}")


def whisper_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX WhisperModel's params as the port's (HF's) state_dict. Raises
    on a param path it does not know."""
    out = {}
    for path, value in _leaves(params):
        arr = np.array(value, dtype=np.float32)
        if arr.ndim == 3:                                    # conv [k, in, out]
            arr = arr.transpose(2, 1, 0)
        elif arr.ndim == 2 and path[-1] == "kernel":         # dense [in, out]
            arr = arr.T
        out[whisper_key_for(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def resnet_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """JAX ResNetEmbedding's ``{"params", "batch_stats"}`` as the port's
    (torchvision's) state dict: its scopes (``layer2_0/downsample_conv``,
    ``bn1/bn``) are MANet's, so the MANet mapping carries them."""
    return manet_state_dict_from_flax(variables)


# the vision transformers: Flax scope -> the port's (HF's / timm's) module name.
# A key of the tables is either a first scope, renamed, or a whole path
# (leaf included) for the params that sit on a module of their own in torch.
_TORCH_LAYOUT = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}   # Dense, Conv2d, Conv3d
_VIT = {
    "clip": ({("class_embedding",): "vision_model.embeddings.class_embedding",
              ("position_embedding",): "vision_model.embeddings.position_embedding.weight",
              "patch_embedding": "vision_model.embeddings.patch_embedding",
              "pre_layernorm": "vision_model.pre_layrnorm",
              "post_layernorm": "vision_model.post_layernorm"},
             ("layers_", "vision_model.encoder.layers"),
             {"fc1": "mlp.fc1", "fc2": "mlp.fc2"}),
    "dinov2": ({("cls_token",): "embeddings.cls_token",
                ("position_embeddings",): "embeddings.position_embeddings",
                "patch_embed": "embeddings.patch_embeddings.projection"},
               ("layers_", "encoder.layer"),
               {("layer_scale1",): "layer_scale1.lambda1",
                ("layer_scale2",): "layer_scale2.lambda1",
                "query": "attention.attention.query", "key": "attention.attention.key",
                "value": "attention.attention.value", "attn_out": "attention.output.dense",
                "fc1": "mlp.fc1", "fc2": "mlp.fc2",
                "weights_in": "mlp.weights_in", "weights_out": "mlp.weights_out"}),
    "videomae": ({("patch_kernel",): "embeddings.patch_embeddings.projection.weight",
                  ("patch_bias",): "embeddings.patch_embeddings.projection.bias"},
                 ("layers_", "encoder.layer"),
                 {("query", "bias"): "attention.attention.q_bias",
                  ("value", "bias"): "attention.attention.v_bias",
                  "query": "attention.attention.query", "key": "attention.attention.key",
                  "value": "attention.attention.value", "attn_out": "attention.output.dense",
                  "fc1": "intermediate.dense", "fc2": "output.dense"}),
    "eva02": ({("cls_token",): "cls_token", ("pos_embed",): "pos_embed",
               "patch_embed": "patch_embed.proj"},
              ("blocks_", "blocks"),
              {"q_proj": "attn.q_proj", "k_proj": "attn.k_proj", "v_proj": "attn.v_proj",
               "proj": "attn.proj", "fc1_g": "mlp.fc1_g", "fc1_x": "mlp.fc1_x",
               "mlp_norm": "mlp.norm", "fc2": "mlp.fc2"}),
}


def vit_key_for(family: str, path: Tuple[str, ...]) -> str:
    """The port's key of one Flax param path of a JAX vision transformer
    (``clip``, ``dinov2``, ``videomae``, ``eva02``):
    ``layers_3/attn_out/kernel`` -> ``encoder.layer.3.attention.output.dense.weight``."""
    top, (flax_layer, torch_layer), sub = _VIT[family]
    table, base, rest = top, [], path
    if path[0].startswith(flax_layer):
        table, base, rest = sub, [f"{torch_layer}.{path[0][len(flax_layer):]}"], path[1:]
    if rest in table:
        return ".".join(base + [table[rest]])
    if len(rest) < 2 or rest[-1] not in {**_LEAF, **_NORM_LEAF}:
        raise KeyError(f"no port key for flax {family} param {'/'.join(path)}")
    return ".".join(base + [table.get(rest[0], rest[0]), *rest[1:-1],
                            {**_LEAF, **_NORM_LEAF}[rest[-1]]])


def vit_state_dict_from_flax(family: str, params) -> Dict[str, torch.Tensor]:
    """A JAX vision transformer's params as the port's state dict: Dense
    kernels [in, out] -> [out, in], conv kernels HWIO -> OIHW (VideoMAE's
    DHWIO -> OIDHW)."""
    out = {}
    for path, value in _leaves(params):
        arr = np.array(value, dtype=np.float32)
        if path[-1] in ("kernel", "patch_kernel"):
            arr = arr.transpose(_TORCH_LAYOUT[arr.ndim])
        out[vit_key_for(family, path)] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def clip_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    return vit_state_dict_from_flax("clip", params)


def dinov2_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    return vit_state_dict_from_flax("dinov2", params)


def videomae_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    return vit_state_dict_from_flax("videomae", params)


def eva02_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    return vit_state_dict_from_flax("eva02", params)


# flax names a cell built inline and handed to nn.RNN after its class, in
# the scope of the module that built it; the port names it after its RNN
_CELL_NAMES = {
    "mfm": {"OptimizedLSTMCell_0": "enc_a", "OptimizedLSTMCell_1": "enc_t",
            "OptimizedLSTMCell_2": "enc_v",
            "GRUCell_0": "dec_a", "GRUCell_1": "dec_t", "GRUCell_2": "dec_v"},
    "mctn": {"GRUCell_0": "enc1", "GRUCell_1": "enc2"},
    "lstm_encoder": {"LSTMCell_0": "fwd", "LSTMCell_1": "bwd"},
}


def baseline_state_dict_from_flax(name: str, params) -> Dict[str, torch.Tensor]:
    """The params of a JAX baseline family (``name`` as registered, or
    ``"lstm_encoder"`` / any other name for a module of
    ``models/modules``) as the port's state_dict. The port's modules carry
    flax's names, so a key is the param's path joined with dots, an
    inline cell renamed after its RNN (``_CELL_NAMES``); a Dense kernel
    [in, out] becomes ``weight`` [out, in], a Conv kernel [K, in, out]
    ``weight`` [out, in, K], a LayerNorm ``scale`` ``weight``; LMF's
    ``factor_i``, ``fusion_weights`` and ``fusion_bias`` keep their shape."""
    renames = _CELL_NAMES.get(name, {})
    out = {}
    for path, value in _leaves(params):
        *mods, leaf = path
        mods = [renames.get(m, m) for m in mods]
        arr = np.array(value, dtype=np.float32)
        if leaf == "kernel":
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(mods + [leaf])] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


# the text families: {flax module path (joined with "/"): HF module name} at
# the top, the flax layer prefix and HF's, and the table inside a layer
_TEXT_EMBED = {"word_embeddings": "embeddings.word_embeddings",
               "position_embeddings": "embeddings.position_embeddings",
               "token_type_embeddings": "embeddings.token_type_embeddings",
               "embeddings_ln": "embeddings.LayerNorm"}
_TEXT_POST_LN = {"attn_output": "attention.output.dense",
                 "attn_ln": "attention.output.LayerNorm",
                 "intermediate": "intermediate.dense", "output": "output.dense",
                 "output_ln": "output.LayerNorm"}
_ALBERT_LAYER = "encoder.albert_layer_groups.0.albert_layers.0."
_TEXT = {
    "bert": (_TEXT_EMBED, ("layers_", "encoder.layer"),
             {"self_attn/query": "attention.self.query", "self_attn/key": "attention.self.key",
              "self_attn/value": "attention.self.value", **_TEXT_POST_LN}),
    "albert": ({**_TEXT_EMBED, "embedding_projection": "encoder.embedding_hidden_mapping_in",
                **{f"layer/{k}": _ALBERT_LAYER + v for k, v in (
                    ("query", "attention.query"), ("key", "attention.key"),
                    ("value", "attention.value"), ("attn_dense", "attention.dense"),
                    ("attn_ln", "attention.LayerNorm"), ("ffn", "ffn"),
                    ("ffn_output", "ffn_output"), ("full_layer_ln", "full_layer_layer_norm"))}},
               None, {}),
    "deberta": ({**_TEXT_EMBED, "rel_embeddings": "encoder.rel_embeddings.weight"},
                ("layers_", "encoder.layer"),
                {"self_attn/in_proj": "attention.self.in_proj",
                 "self_attn/q_bias": "attention.self.q_bias",
                 "self_attn/v_bias": "attention.self.v_bias",
                 "self_attn/pos_proj": "attention.self.pos_proj",
                 "self_attn/pos_q_proj": "attention.self.pos_q_proj", **_TEXT_POST_LN}),
    "bloom": ({"word_embeddings": "word_embeddings",
               "word_embeddings_layernorm": "word_embeddings_layernorm", "ln_f": "ln_f"},
              ("h_", "h"),
              {"input_layernorm": "input_layernorm",
               "post_attention_layernorm": "post_attention_layernorm",
               "self_attention/query_key_value": "self_attention.query_key_value",
               "self_attention/dense": "self_attention.dense",
               "dense_h_to_4h": "mlp.dense_h_to_4h", "dense_4h_to_h": "mlp.dense_4h_to_h"}),
    "glm": ({"embed_tokens": "embed_tokens", "norm": "norm"}, ("layers_", "layers"),
            {"input_layernorm": "input_layernorm",
             "post_attention_layernorm": "post_attention_layernorm",
             **{f"self_attn/{p}": f"self_attn.{p}" for p in ("q_proj", "k_proj", "v_proj",
                                                              "o_proj")},
             "mlp/gate_up_proj": "mlp.gate_up_proj", "mlp/down_proj": "mlp.down_proj"}),
}
_TEXT_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight", "embedding": "weight"}


def text_key_for(family: str, path: Tuple[str, ...]) -> str:
    """The port's (HF's) key of one Flax param path of a JAX text family:
    ``layers_3/self_attn/query/kernel`` -> ``encoder.layer.3.attention.self.query.weight``;
    a bare param (DeBERTa's ``rel_embeddings``, ``q_bias``) maps whole."""
    top, layer, sub = _TEXT[family]
    table, base, rest = top, "", path
    if layer is not None and path[0].startswith(layer[0]):
        table, base, rest = sub, f"{layer[1]}.{path[0][len(layer[0]):]}.", path[1:]
    joined = "/".join(rest)
    if joined in table:                          # a bare param
        return base + table[joined]
    module = "/".join(rest[:-1])
    if module not in table or rest[-1] not in _TEXT_LEAF:
        raise KeyError(f"no port key for flax {family} param {'/'.join(path)}")
    return f"{base}{table[module]}.{_TEXT_LEAF[rest[-1]]}"


def text_state_dict_from_flax(family: str, params) -> Dict[str, torch.Tensor]:
    """A JAX text family's params (``bert``, ``albert``, ``deberta``,
    ``bloom``, ``glm``) as the port's state dict: Dense kernels [in, out] ->
    [out, in]. ALBERT's one shared layer maps once."""
    out = {}
    for path, value in _leaves(params):
        arr = np.array(value, dtype=np.float32)
        if path[-1] == "kernel":
            arr = arr.T
        out[text_key_for(family, path)] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def bert_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    return text_state_dict_from_flax("bert", params)


def albert_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    return text_state_dict_from_flax("albert", params)


def deberta_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    return text_state_dict_from_flax("deberta", params)


def bloom_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    return text_state_dict_from_flax("bloom", params)


def glm_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    return text_state_dict_from_flax("glm", params)
