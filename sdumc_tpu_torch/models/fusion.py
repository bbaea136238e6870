"""The SDUMC unified-modality cross-attention fusion network, in PyTorch.

Port of ``sdumc_tpu/models/fusion.py`` (reference
``WengnetMOSEIMultViewsTextMissing``): three frame-level modality streams
are projected to a shared width, attention-pooled to utterance vectors,
fused through an (unnormalised) modality-weight attention, expanded into 7
multimodal queries that cross-attend back over every modality's frames,
re-weighted by the same modality weights, and collapsed through a 7-slot
attention into the prediction head.

Submodule names follow the reference torch state_dict, so a released
``.pt`` loads as it is (convert/checkpoint.py). The six frame-attention ops
(3 pools, 3 cross attentions) run through the fused kernel on the card and
through its plain version on the CPU (ops/kernels/).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sdumc_tpu_torch.core.config import ModelConfig
from sdumc_tpu_torch.core.registry import MODELS
from sdumc_tpu_torch.models.layers import MLP, FrameDropout, Linear
from sdumc_tpu_torch.models.residual_ae import ResidualAE
from sdumc_tpu_torch.ops.kernels.fused_cross import fused_cross_attention
from sdumc_tpu_torch.ops.kernels.fused_pool import fused_attention_pool


def _xavier_normal_vector(dim: int, generator) -> torch.Tensor:
    # torch nn.init.xavier_normal_ on a (1, dim) tensor: std = sqrt(2/(1+dim))
    std = (2.0 / (1 + dim)) ** 0.5
    return std * torch.randn(1, dim, generator=generator)


class FRA2UTTNew(nn.Module):
    """Frame->utterance attention pooling (reference ``FRA2UTT_new``)."""

    def __init__(self, dim: int, softmax_scale: float = 0.3,
                 dropout: float = 0.5, generator=None):
        super().__init__()
        self.softmax_scale = softmax_scale
        self.input_proj = Linear(dim, dim, generator)
        self.attention_context_vector = nn.Parameter(
            _xavier_normal_vector(dim, generator))
        self.frame_dropout = FrameDropout(dropout)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, t_max=None):
        x = self.frame_dropout(x)
        pooled = fused_attention_pool(
            x, self.input_proj.weight, self.input_proj.bias,
            self.attention_context_vector[0], t_max, self.softmax_scale)
        return self.dropout(pooled)


class CrossAttention(nn.Module):
    """7-query cross attention over frames (reference ``Cross_Attention``);
    the query projection stays a plain Linear."""

    def __init__(self, dim: int, softmax_scale: float = 0.3,
                 dropout: float = 0.5, generator=None):
        super().__init__()
        self.softmax_scale = softmax_scale
        self.query_proj = Linear(dim, dim, generator)
        self.input_proj = Linear(dim, dim, generator)
        self.frame_dropout = FrameDropout(dropout)
        self.dropout = nn.Dropout(dropout)

    def forward(self, query, x, t_max=None):
        x = self.frame_dropout(x)
        q = self.query_proj(query)
        out = fused_cross_attention(
            q, x, self.input_proj.weight, self.input_proj.bias, t_max,
            self.softmax_scale)
        return self.dropout(out)


def _row_lengths(t_gt, t_ps, B: int, device) -> torch.Tensor:
    """Per-row [2B] int32 lengths: teacher rows first, then student rows."""
    def rows(t):
        if isinstance(t, torch.Tensor):
            return t.to(device=device, dtype=torch.int32).expand(B)
        return torch.full((B,), int(t), dtype=torch.int32, device=device)
    return torch.cat([rows(t_gt), rows(t_ps)])


@MODELS.register("wengnet_mosei_mult_views_text_missing")
class SDUMCFusion(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        g = generator
        d = cfg.general_dim
        fused, layers = tuple(cfg.fused_layers), tuple(cfg.layers)
        h, H = fused[-1], layers[-1]
        self.frame_dim_reshape_0 = Linear(cfg.input_dims[0], d, g)
        self.frame_dim_reshape_1 = Linear(cfg.input_dims[1], d, g)
        self.frame_dim_reshape_2 = Linear(cfg.input_dims[2], d, g)
        for i in range(3):
            setattr(self, f"fra2utt_{i}", FRA2UTTNew(
                d, cfg.softmax_scale, cfg.attn_dropout, g))
        self.audio_mlp = MLP(d, fused, cfg.dropout, g)
        self.text_mlp = MLP(d, fused, cfg.dropout, g)
        self.video_mlp = MLP(d, fused, cfg.dropout, g)
        self.missing_text_imagination_mlp = ResidualAE([128], 1, d, h, cfg.dropout, g)
        self.attention_mlp = MLP(3 * h, fused, cfg.dropout, g)
        self.fc_att = Linear(h, 3, g)
        for name in ("fused", "at", "tv", "av", "audio", "text", "video"):
            setattr(self, f"cross_{name}_query_mlp", MLP(h, (d,), cfg.dropout, g))
        for i in range(3):
            setattr(self, f"cross_att_fra2utt_{i}", CrossAttention(
                d, cfg.softmax_scale, cfg.attn_dropout, g))
        self.cross_audio_mlp = MLP(d, layers, cfg.dropout, g)
        self.cross_text_mlp = MLP(d, layers, cfg.dropout, g)
        self.cross_video_mlp = MLP(d, layers, cfg.dropout, g)
        self.missing_cross_text_query_imagination_mlp = ResidualAE(
            [64], 1, H, H, cfg.dropout, g)
        self.cross_attention_mlp = MLP(7 * H, layers, cfg.dropout, g)
        self.cross_fc_att = Linear(H, 7, g)
        self.fc_out_v = Linear(H, cfg.output_dim, g)
        self.orgin_linear_change = nn.Sequential(
            Linear(H, cfg.rnc_proj_dim, g), nn.ReLU(),
            Linear(cfg.rnc_proj_dim, cfg.rnc_proj_dim, g))
        # unused but present in the released checkpoint
        self.fc_out_e = Linear(H, cfg.output_dim, g)
        self.fc_out_ev = Linear(cfg.output_dim, cfg.output_dim, g)
        self.prelu = nn.PReLU(6, init=0.25)
        self.layer_normali = nn.LayerNorm(h)

    def forward(self, audio, text, video, *, t_max=None, missing: bool = False,
                dual: bool = False):
        """Forward one view, or both views fused.

        Args:
          audio/text/video: [B, T_m, D_m] zero-padded frame features. The
            student view passes feat4 (pseudo-text) as `text`.
          t_max: optional (ta, tt, tv): the dynamic batch-max lengths (ints
            or per-row [B] tensors); rows beyond are masked from every time
            softmax.
          missing: text-missing view flag; triggers the imagination
            substitution only when cfg.use_imagination is set.
          dual: fused dual view. ``text`` is (text_gt, feat4) and ``t_max``
            is (ta, (tt_gt, tt_feat4), tv); the views are stacked along
            batch after the shared input projections (teacher rows first),
            so every later op runs once at 2B rows and the audio/video
            projections run once. Per-row results equal two single-view
            calls.

        Returns:
          (vals_out [B, 1], aux) with the distillation targets: features,
          rnc, text_feat (post-query-MLP text hidden), text_query_feat
          (cross_hiddens[:, 1]) and attn (three Nones: the fused kernel
          never materialises the attention maps).
        """
        cfg = self.cfg
        ta, tt, tv = t_max if t_max is not None else (None, None, None)

        if dual:
            if cfg.use_imagination:
                raise ValueError("the fused dual view needs use_imagination off")
            if t_max is None:
                raise ValueError("the fused dual view needs t_max")
            text_gt, text_ps = text
            tt_gt, tt_ps = tt
            B = audio.shape[0]
            tf_gt = self.frame_dim_reshape_1(text_gt)
            tf_ps = self.frame_dim_reshape_1(text_ps)
            T_t = max(tf_gt.shape[1], tf_ps.shape[1])
            text_f = torch.cat([F.pad(z, (0, 0, 0, T_t - z.shape[1]))
                                for z in (tf_gt, tf_ps)])
            tt = _row_lengths(tt_gt, tt_ps, B, audio.device)
            audio_f = self.frame_dim_reshape_0(audio)
            video_f = self.frame_dim_reshape_2(video)
            audio_f = torch.cat([audio_f, audio_f])
            video_f = torch.cat([video_f, video_f])
        else:
            audio_f = self.frame_dim_reshape_0(audio)
            text_f = self.frame_dim_reshape_1(text)
            video_f = self.frame_dim_reshape_2(video)

        # frame -> utterance pooling
        audio_pre = self.fra2utt_0(audio_f, ta)
        text_pre = self.fra2utt_1(text_f, tt)
        video_pre = self.fra2utt_2(video_f, tv)

        audio_hidden = self.audio_mlp(audio_pre)
        text_hidden = self.text_mlp(text_pre)
        video_hidden = self.video_mlp(video_pre)
        if cfg.use_imagination and missing:
            text_hidden = self.missing_text_imagination_mlp(
                audio_hidden, text_hidden, video_hidden)

        # modality-weight attention: unnormalised, no softmax
        multi_hidden1 = torch.cat([audio_hidden, text_hidden, video_hidden], dim=1)
        att = self.fc_att(self.attention_mlp(multi_hidden1))           # [B, 3]
        hiddens = torch.stack([audio_hidden, text_hidden, video_hidden], dim=1)
        fused_feat = torch.einsum("bmd,bm->bd", hiddens, att)
        fused_feat_at = torch.einsum("bmd,bm->bd", hiddens[:, :2], att[:, :2])
        fused_feat_tv = torch.einsum("bmd,bm->bd", hiddens[:, 1:], att[:, 1:])
        fused_feat_av = torch.einsum("bmd,bm->bd", hiddens[:, 0::2], att[:, 0::2])

        # 7 query MLPs
        text_q = self.cross_text_query_mlp(text_hidden)
        multi_query = torch.stack([
            self.cross_fused_query_mlp(fused_feat),
            self.cross_at_query_mlp(fused_feat_at),
            self.cross_tv_query_mlp(fused_feat_tv),
            self.cross_av_query_mlp(fused_feat_av),
            self.cross_audio_query_mlp(audio_hidden),
            text_q,
            self.cross_video_query_mlp(video_hidden),
        ], dim=1)                                                       # [B, 7, d]

        # cross attention back over each modality's frames
        cross_audio = self.cross_audio_mlp(self.cross_att_fra2utt_0(multi_query, audio_f, ta))
        cross_text = self.cross_text_mlp(self.cross_att_fra2utt_1(multi_query, text_f, tt))
        cross_video = self.cross_video_mlp(self.cross_att_fra2utt_2(multi_query, video_f, tv))
        if cfg.use_imagination and missing:
            cross_text = self.missing_cross_text_query_imagination_mlp(
                cross_audio, cross_text, cross_video)

        # re-weighting by the modality weights, then the 7-slot collapse
        cross_hiddens = torch.stack([cross_audio, cross_text, cross_video], dim=1)
        weighted = torch.einsum("bmqh,bm->bqh", cross_hiddens, att)     # [B, 7, H]
        cross_att = self.cross_fc_att(
            self.cross_attention_mlp(weighted.reshape(weighted.shape[0], -1)))
        cross_fused_feat = torch.einsum("bqh,bq->bh", weighted, cross_att)

        vals_out = self.fc_out_v(cross_fused_feat)
        rnc = self.orgin_linear_change(cross_fused_feat)
        aux = {
            "features": cross_fused_feat,
            "rnc": rnc,
            "text_feat": text_q,
            "text_query_feat": cross_hiddens[:, 1],
            "attn": (None, None, None),
        }
        return vals_out, aux
