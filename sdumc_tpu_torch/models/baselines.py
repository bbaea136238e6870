"""Utterance-level baseline fusion families: TFN, LMF, Attention, MISA, MMIM.

The port of ``sdumc_tpu/models/baselines.py``. The reference names these
families but ships no code for them; the JAX package's clean-room versions
(Zadeh et al. 2017 TFN; Liu et al. 2018 LMF; Hazarika et al. 2020 MISA;
Han et al. 2021 MMIM) are their spec. Each speaks the fusion net's
single-view interface, ``(audio, text, video, t_max, missing) -> (vals,
aux)``, so the dual-view train and eval steps drive it, as two forwards
(``train/step.py _fusable``). Families with their own self-supervised
objective return it in ``aux["model_loss"]``, which the dual-view loss
adds for each view; MISA's and MMIM's couple the batch's rows, so they
also return the per-row tensors it is computed from (``_BaselineBase
has_model_loss``).

Parameters are flax's, tensor for tensor, with flax's initialisers
(``modules/linen.py``): a checkpoint of the JAX package loads through
``convert.from_flax.baseline_state_dict_from_flax``. ``t_max`` is a host
int per modality. A bf16 stream is pooled in bf16 as JAX pools it (the
sum taken in f32 and rounded, then divided in bf16); everything after the
pool is f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sdumc_tpu_torch.core.config import ModelConfig
from sdumc_tpu_torch.core.registry import MODELS
from sdumc_tpu_torch.models.layers import Dropout
from sdumc_tpu_torch.models.modules import CrossModalTransformerEncoder
from sdumc_tpu_torch.models.modules.linen import Dense, xavier_uniform_

MODALITIES = ("audio", "text", "video")


def masked_mean(x: torch.Tensor, t_max: Optional[int]) -> torch.Tensor:
    """[B, T, D] -> [B, D], the mean over the first ``t_max`` frames (the
    collate zero-fills the rest). A bf16 ``x`` gives a bf16 mean: the sum in
    f32 rounded to bf16, divided by ``max(t_max, 1)`` rounded to bf16, as
    JAX's ``jnp.sum(x * mask) / jnp.maximum(t_max, 1)`` computes it."""
    if t_max is None:
        return x.mean(dim=1, dtype=torch.float32).to(x.dtype)
    total = x[:, :t_max].sum(dim=1, dtype=torch.float32).to(x.dtype)
    return total / torch.tensor(max(t_max, 1), dtype=x.dtype)


class ModalityEncoder(nn.Module):
    """Pool -> dropout -> 2-layer ReLU MLP (TFN / LMF's subnetwork)."""

    def __init__(self, in_dim: int, hidden: int, dropout: float, generator=None):
        super().__init__()
        self.fc1 = Dense(in_dim, hidden, generator=generator)
        self.fc2 = Dense(hidden, hidden, generator=generator)
        self.drop = Dropout(dropout)

    def forward(self, x, t_max=None):
        h = self.drop(masked_mean(x, t_max))
        return torch.relu(self.fc2(torch.relu(self.fc1(h))))


class _BaselineBase(nn.Module):
    """The aux streams that the dual-view distillation loss reads."""

    # True where aux["model_loss"] couples the batch's rows (moments, negatives,
    # kernel sums over pairs of rows, one draw for every row). Such a family
    # applies every parameter in forward and returns the per-row tensors the
    # loss reads in aux["loss_rows"]; its ``batch_loss(rows)`` turns them, this
    # rank's or every rank's gathered, into the loss with no parameter, in the
    # model's mode, so a data-parallel step takes it of the global batch
    # (train/step.py) after forward(..., model_loss=False)
    has_model_loss = False

    def __init__(self, cfg: ModelConfig, feat_dim: int, generator=None):
        super().__init__()
        self.cfg = cfg
        self.rnc_proj = Dense(feat_dim, 64, generator=generator)

    def _encoders(self, generator):
        """audio_enc, text_enc, video_enc: one ModalityEncoder each."""
        cfg = self.cfg
        for name, d in zip(MODALITIES, cfg.input_dims):
            self.add_module(f"{name}_enc", ModalityEncoder(d, cfg.baseline_hidden_dim,
                                                           cfg.dropout, generator))

    def _encode(self, audio, text, video, t_max):
        tm = t_max or (None, None, None)
        return [self._modules[f"{n}_enc"](x, t)
                for n, x, t in zip(MODALITIES, (audio, text, video), tm)]

    def _aux(self, fused_hidden, text_hidden):
        return {"features": fused_hidden, "rnc": self.rnc_proj(fused_hidden),
                "text_feat": text_hidden, "text_query_feat": text_hidden, "attn": None}


def _with_one(z):
    return torch.cat([z.new_ones(z.shape[0], 1), z], dim=-1)


@MODELS.register("tfn")
class TFN(_BaselineBase):
    """Tensor Fusion Network: the outer product of the three [1; z_m]
    vectors, flattened into a post-fusion MLP."""

    def __init__(self, cfg: ModelConfig, generator=None):
        h = cfg.baseline_hidden_dim
        super().__init__(cfg, h, generator)
        self._encoders(generator)
        self.post_fc1 = Dense((h + 1) ** 3, h, generator=generator)
        self.post_fc2 = Dense(h, h, generator=generator)
        self.out = Dense(h, cfg.output_dim, generator=generator)
        self.drop = Dropout(cfg.dropout)

    def forward(self, audio, text, video, *, t_max: Optional[Tuple] = None,
                missing: bool = False):
        za, zt, zv = self._encode(audio, text, video, t_max)
        fused = torch.einsum("bi,bj,bk->bijk", _with_one(za), _with_one(zt), _with_one(zv))
        f = self.drop(fused.reshape(fused.shape[0], -1))
        f = torch.relu(self.post_fc2(torch.relu(self.post_fc1(f))))
        return self.out(f), self._aux(f, zt)


@MODELS.register("lmf")
class LMF(_BaselineBase):
    """Low-rank Multimodal Fusion: per-modality rank factors, their
    elementwise product across modalities, summed over rank."""

    def __init__(self, cfg: ModelConfig, generator=None):
        h, r = cfg.baseline_hidden_dim, cfg.baseline_rank
        super().__init__(cfg, h, generator)
        self._encoders(generator)
        for i in range(3):
            self.register_parameter(f"factor_{i}", nn.Parameter(
                xavier_uniform_(torch.empty(r, h + 1, h), generator)))
        self.fusion_weights = nn.Parameter(xavier_uniform_(torch.empty(1, r), generator))
        self.fusion_bias = nn.Parameter(torch.zeros(h))
        self.out = Dense(h, cfg.output_dim, generator=generator)

    def forward(self, audio, text, video, *, t_max: Optional[Tuple] = None,
                missing: bool = False):
        zs = [_with_one(z) for z in self._encode(audio, text, video, t_max)]
        fused = None
        for i, z in enumerate(zs):
            proj = torch.einsum("bj,rjk->brk", z, getattr(self, f"factor_{i}"))
            fused = proj if fused is None else fused * proj
        f = torch.einsum("or,brk->bk", self.fusion_weights, fused) + self.fusion_bias
        return self.out(f), self._aux(f, zs[1][:, 1:])


@MODELS.register("attention")
class AttentionFusion(_BaselineBase):
    """Per-modality encoders, a softmax attention over the three modality
    vectors, the attention-weighted concat into a fusion MLP."""

    def __init__(self, cfg: ModelConfig, generator=None):
        h = cfg.baseline_hidden_dim
        super().__init__(cfg, h, generator)
        self._encoders(generator)
        self.att_hidden = Dense(3 * h, h, generator=generator)
        self.att_fc = Dense(h, 3, generator=generator)
        self.post_fc1 = Dense(3 * h, h, generator=generator)
        self.out = Dense(h, cfg.output_dim, generator=generator)
        self.drop = Dropout(cfg.dropout)

    def forward(self, audio, text, video, *, t_max: Optional[Tuple] = None,
                missing: bool = False):
        zs = self._encode(audio, text, video, t_max)
        w = torch.softmax(self.att_fc(torch.tanh(self.att_hidden(torch.cat(zs, dim=-1)))),
                          dim=-1)                                         # [B, 3]
        fused = torch.cat([z * w[:, i:i + 1] for i, z in enumerate(zs)], dim=-1)
        f = torch.relu(self.post_fc1(self.drop(fused)))
        return self.out(f), self._aux(f, zs[1])


def _cmd_loss(x, y, n_moments: int = 5):
    """Central Moment Discrepancy between two batches (MISA's similarity
    loss between the invariant spaces)."""
    mx, my = x.mean(dim=0), y.mean(dim=0)
    cx, cy = x - mx, y - my
    loss = torch.linalg.vector_norm(mx - my)
    for k in range(2, n_moments + 1):
        loss = loss + torch.linalg.vector_norm((cx ** k).mean(dim=0) - (cy ** k).mean(dim=0))
    return loss


def _diff_loss(a, b):
    """Squared Frobenius norm of the correlation of two batch-centred,
    row-normalised matrices, averaged (MISA's orthogonality loss)."""
    a = a - a.mean(dim=0)
    b = b - b.mean(dim=0)
    a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-6)
    b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-6)
    return ((a.T @ b) ** 2).mean()


@MODELS.register("misa")
class MISA(_BaselineBase):
    """Modality-invariant and -specific representations: one shared
    projection (applied to each modality) and three private ones; CMD pulls
    the invariant spaces together, an orthogonality loss pushes the private
    ones from them, one decoder reconstructs each utterance vector from
    private + shared; the six vectors fuse through a small self-attention
    transformer."""

    has_model_loss = True      # see _BaselineBase.has_model_loss

    def __init__(self, cfg: ModelConfig, generator=None):
        h = cfg.baseline_hidden_dim
        super().__init__(cfg, h, generator)
        self._encoders(generator)
        self.shared_proj = Dense(h, h, generator=generator)
        for m in "atv":
            self.add_module(f"private_{m}", Dense(h, h, generator=generator))
        self.recon_dec = Dense(h, h, generator=generator)
        self.fusion_tr = CrossModalTransformerEncoder(
            dim=h, layers=1, heads=2, dropout=cfg.dropout, scale_embeds=False,
            generator=generator)
        self.post_fc1 = Dense(6 * h, h, generator=generator)
        self.out = Dense(h, cfg.output_dim, generator=generator)

    def forward(self, audio, text, video, *, t_max: Optional[Tuple] = None,
                missing: bool = False, model_loss: bool = True):
        utts = self._encode(audio, text, video, t_max)
        inv = [torch.sigmoid(self.shared_proj(u)) for u in utts]
        spec = [torch.sigmoid(self._modules[f"private_{m}"](u)) for m, u in zip("atv", utts)]
        recon = torch.stack([((self.recon_dec(s + i) - u.detach()) ** 2).mean(dim=1)
                             for s, i, u in zip(spec, inv, utts)], dim=1)     # [B, 3]
        rows = (*inv, *spec, recon)

        fused = self.fusion_tr(torch.stack(inv + spec, dim=1))               # [B, 6, h]
        f = torch.relu(self.post_fc1(fused.reshape(fused.shape[0], -1)))
        vals = self.out(f)
        aux = self._aux(f, utts[1])
        aux["loss_rows"] = rows
        if model_loss:
            aux["model_loss"] = self.batch_loss(rows)
        return vals, aux

    def batch_loss(self, rows):
        """CMD between the invariant spaces, the orthogonality of each
        private space to its invariant one, the reconstruction; rows:
        inv x3, spec x3 [B, h], each modality's reconstruction error [B, 3]."""
        cfg, inv, spec = self.cfg, rows[:3], rows[3:6]
        sim = (_cmd_loss(inv[0], inv[1]) + _cmd_loss(inv[0], inv[2])
               + _cmd_loss(inv[1], inv[2])) / 3.0
        diff = sum(_diff_loss(s, i) for s, i in zip(spec, inv)) / 3.0
        recon = sum(e.mean() for e in rows[6].unbind(1)) / 3.0
        return cfg.misa_sim_w * sim + cfg.misa_diff_w * diff + cfg.misa_recon_w * recon


def _infonce(scores):
    """The InfoNCE loss of a [B, B] score matrix whose diagonal holds the
    positive pairs."""
    return -torch.diagonal(torch.log_softmax(scores, dim=-1)).mean()


@MODELS.register("mmim")
class MMIM(_BaselineBase):
    """MultiModal InfoMax: beta-weighted InfoNCE bounds tie text to audio and
    video at the input level; alpha-weighted CPC critics tie the fusion
    result back to each modality. The batch's other items are the
    negatives."""

    has_model_loss = True      # see _BaselineBase.has_model_loss

    def __init__(self, cfg: ModelConfig, generator=None):
        h = cfg.baseline_hidden_dim
        super().__init__(cfg, h, generator)
        self._encoders(generator)
        self.post_fc1 = Dense(3 * h, h, generator=generator)
        self.out = Dense(h, cfg.output_dim, generator=generator)
        self.W_ta = Dense(h, h, bias=False, generator=generator)
        self.W_tv = Dense(h, h, bias=False, generator=generator)
        for m in "atv":
            for li in range(cfg.baseline_layers):
                self.add_module(f"cpc_{m}_{li}", Dense(h, h, generator=generator))
        self.drop = Dropout(cfg.dropout)

    def forward(self, audio, text, video, *, t_max: Optional[Tuple] = None,
                missing: bool = False, model_loss: bool = True):
        cfg = self.cfg
        za, zt, zv = self._encode(audio, text, video, t_max)
        f = torch.relu(self.post_fc1(self.drop(torch.cat([za, zt, zv], dim=-1))))
        vals = self.out(f)
        preds = []
        for m in "atv":
            pred = f
            for li in range(cfg.baseline_layers):
                pred = self._modules[f"cpc_{m}_{li}"](pred)
                if li < cfg.baseline_layers - 1:
                    pred = torch.relu(pred)
            preds.append(pred)
        rows = (za, zt, zv, self.W_ta(za), self.W_tv(zv), *preds)
        aux = self._aux(f, zt)
        aux["loss_rows"] = rows
        if model_loss:
            aux["model_loss"] = self.batch_loss(rows)
        return vals, aux

    def batch_loss(self, rows):
        """The InfoNCE bounds over the batch's [B, B] scores; rows: za, zt,
        zv, W_ta(za), W_tv(zv) and the three CPC predictions [B, h]."""
        za, zt, zv, wa, wv, *preds = rows
        ta = _infonce(zt @ wa.T)
        tv = _infonce(zt @ wv.T)
        cpc = 0.0
        for pred, z in zip(preds, (za, zt, zv)):
            cpc = cpc + _infonce(pred @ z.T)
        return self.cfg.mmim_beta * (ta + tv) + self.cfg.mmim_alpha * cpc
