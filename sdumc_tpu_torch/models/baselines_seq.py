"""Sequence-level baseline fusion families: MFN, Graph-MFN, MFM, MCTN, MulT.

The port of ``sdumc_tpu/models/baselines_seq.py`` (clean-room versions of
Zadeh et al. 2018 MFN and Graph-MFN; Tsai et al. 2019 MFM; Pham et al.
2019 MCTN; Tsai et al. 2019 MulT), with flax's parameters and initialisers
(``modules/linen.py``):

- the recurrences step through time in Python, one hidden product a step
  (the input products of a sequence are one product): flax's cells, not
  cuDNN's, whose two biases a gate would add trainable tensors;
- the align-only families (mfn, graph_mfn, mfm, mctn) resample each
  modality linearly onto ``baseline_align_t`` steps in the model, as JAX
  does; ``t_max`` is a host int per modality;
- MFM's prior samples and MCTN's teacher-forcing mask draw from the train
  step's generator (``layers.Draws``, set by ``use_generator``; batch-wide
  draws, which a data-parallel step takes from a generator every rank
  seeds alike) in training mode only. In eval mode MFM's ``model_loss`` is
  the reconstruction alone, MCTN's is 0, and MCTN skips its translation
  decoders, whose outputs feed only that loss. Both return the per-row
  tensors of their ``model_loss`` too (``baselines._BaselineBase
  has_model_loss``);
- MulT keeps each modality's own length; its attention is two plain
  products and a softmax over the whole padded bucket, as JAX's.

A bf16 stream enters MulT's convolutions and the resample widened to f32,
as flax promotes it; everything after is f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sdumc_tpu_torch.core.config import ModelConfig
from sdumc_tpu_torch.core.registry import MODELS
from sdumc_tpu_torch.models.baselines import _BaselineBase
from sdumc_tpu_torch.models.layers import Draws, Dropout
from sdumc_tpu_torch.models.modules import CrossModalTransformerEncoder
from sdumc_tpu_torch.models.modules.linen import Conv1dSame, Dense, GRUCell, LSTMCell


def resample_time(x: torch.Tensor, t_max: Optional[int], t_out: int) -> torch.Tensor:
    """Linearly resample the first ``t_max`` frames of x [B, T, D] onto
    ``t_out`` steps -> [B, t_out, D] (f32 for an f32 or bf16 x); the
    positions in f32, as JAX computes them."""
    t = float(x.shape[1] if t_max is None else t_max)
    pos = (torch.arange(t_out, dtype=torch.float32, device=x.device) + 0.5) / t_out * t - 0.5
    pos = pos.clamp(0.0, max(t - 1.0, 0.0))
    lo = pos.floor().long()
    hi = (lo + 1).clamp(max=max(int(t) - 1, 0))
    w = (pos - lo)[None, :, None]
    return x[:, lo] * (1.0 - w) + x[:, hi] * w


def _align_inputs(cfg, audio, text, video, t_max):
    tm = t_max or (None, None, None)
    return [resample_time(x, t, cfg.baseline_align_t) for x, t in zip((audio, text, video), tm)]


class DynamicFusionGraph(nn.Module):
    """Graph-MFN's Dynamic Fusion Graph over the three singleton views: pair
    and triple vertices are MLPs of their parents, every edge carries a
    sigmoid efficacy, the output is the efficacy-weighted sum of the seven
    vertices."""

    def __init__(self, in_dim: int, dim: int, generator=None):
        super().__init__()
        self.efficacies = Dense(3 * in_dim, 19, generator=generator)
        for v in "atv":
            self.add_module(f"v_{v}", Dense(in_dim, dim, generator=generator))
        for v in ("at", "av", "tv"):
            self.add_module(f"v_{v}", Dense(2 * dim, dim, generator=generator))
        self.v_atv = Dense(6 * dim, dim, generator=generator)

    def forward(self, sa, st, sv):
        eff = torch.sigmoid(self.efficacies(torch.cat([sa, st, sv], dim=-1)))
        e = [eff[:, i:i + 1] for i in range(19)]
        va, vt, vv = (torch.tanh(self._modules[f"v_{m}"](s))
                      for m, s in zip("atv", (sa, st, sv)))
        p_at = torch.tanh(self.v_at(torch.cat([va * e[0], vt * e[1]], dim=-1)))
        p_av = torch.tanh(self.v_av(torch.cat([va * e[2], vv * e[3]], dim=-1)))
        p_tv = torch.tanh(self.v_tv(torch.cat([vt * e[4], vv * e[5]], dim=-1)))
        tri = torch.tanh(self.v_atv(torch.cat(
            [va * e[6], vt * e[7], vv * e[8], p_at * e[9], p_av * e[10], p_tv * e[11]],
            dim=-1)))
        return sum(v * e[12 + i] for i, v in enumerate((va, vt, vv, p_at, p_av, p_tv, tri)))


class _MFNStep(nn.Module):
    """The Memory Fusion Network's step: three LSTMs in lockstep; the
    Delta-memory Attention Network over the old and new memories (or, for
    Graph-MFN, the DFG over the new hidden states); a gated multi-view
    memory ``u``."""

    def __init__(self, hidden: int, mem: int, use_graph: bool, generator=None):
        super().__init__()
        self.use_graph, self.mem = use_graph, mem
        for m in "atv":
            self.add_module(f"lstm_{m}", LSTMCell(hidden, hidden, generator))
        if use_graph:
            self.dfg = DynamicFusionGraph(hidden, mem, generator)
        else:
            self.dman_fc1 = Dense(6 * hidden, mem, generator=generator)
            self.dman_fc2 = Dense(mem, 6 * hidden, generator=generator)
            self.attended_proj = Dense(6 * hidden, mem, generator=generator)
        self.gamma1 = Dense(mem, mem, generator=generator)
        self.gamma2 = Dense(mem, mem, generator=generator)
        self.u_hat = Dense(mem, mem, generator=generator)

    def forward(self, xs):
        """xs: the three projected sequences [B, T, h]; returns the three
        final LSTM carries (c, h) and the final memory u [B, mem]."""
        cells = [self._modules[f"lstm_{m}"] for m in "atv"]
        gxs = [c.input_gates(x) for c, x in zip(cells, xs)]
        params = [c.hidden_params() for c in cells]
        B = xs[0].shape[0]
        states = [c.zeros(B, g) for c, g in zip(cells, gxs)]
        u = gxs[0].new_zeros(B, self.mem)
        for t in range(xs[0].shape[1]):
            new = [c.step(g[:, t], s, p) for c, g, s, p in zip(cells, gxs, states, params)]
            if self.use_graph:
                z = self.dfg(*(s[1] for s in new))
            else:
                cc = torch.cat([s[0] for s in states] + [s[0] for s in new], dim=-1)  # [B, 6h]
                a = torch.softmax(self.dman_fc2(torch.relu(self.dman_fc1(cc))), dim=-1)
                z = torch.relu(self.attended_proj(cc * a))
            u = (torch.sigmoid(self.gamma1(z)) * u
                 + torch.sigmoid(self.gamma2(z)) * torch.tanh(self.u_hat(z)))
            states = new
        return states, u


class _MFNCore(_BaselineBase):
    """MFN / Graph-MFN (they differ only in the step's cross-view
    integrator)."""

    use_graph = False

    def __init__(self, cfg: ModelConfig, generator=None):
        h, m = cfg.baseline_hidden_dim, cfg.baseline_mem_dim
        super().__init__(cfg, h, generator)
        for name, d in zip("atv", cfg.input_dims):
            self.add_module(f"proj_{name}", Dense(d, h, generator=generator))
        self.steps = _MFNStep(h, m, self.use_graph, generator)
        self.post_fc1 = Dense(3 * h + m, h, generator=generator)
        self.out = Dense(h, cfg.output_dim, generator=generator)
        self.drop = Dropout(cfg.dropout)

    def forward(self, audio, text, video, *, t_max: Optional[Tuple] = None,
                missing: bool = False):
        seqs = _align_inputs(self.cfg, audio, text, video, t_max)
        xs = [self._modules[f"proj_{n}"](x) for n, x in zip("atv", seqs)]
        (sa, st, sv), u = self.steps(xs)
        f = self.drop(torch.cat([sa[1], st[1], sv[1], u], dim=-1))
        f = torch.relu(self.post_fc1(f))
        return self.out(f), self._aux(f, st[1])


@MODELS.register("mfn")
class MFN(_MFNCore):
    use_graph = False


@MODELS.register("graph_mfn")
class GraphMFN(_MFNCore):
    use_graph = True


def _rbf_mmd(x, y, sigmas=(1.0, 2.0, 4.0)):
    """Multi-bandwidth RBF-kernel Maximum Mean Discrepancy."""

    def k(a, b):
        d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(dim=-1)
        return sum(torch.exp(-d / (2.0 * s * s)) for s in sigmas)

    return k(x, x).mean() + k(y, y).mean() - 2.0 * k(x, y).mean()


@MODELS.register("mfm")
class MFM(_BaselineBase):
    """Multimodal Factorization Model: LSTM encoders infer one
    discriminative factor F_y and per-modality generative factors F_m; GRU
    decoders reconstruct each projected sequence from [F_m, F_y]
    (stop-gradient targets); in training mode an MMD matches every factor to
    N(0, I) samples. The prediction reads F_y only."""

    has_model_loss = True      # see _BaselineBase.has_model_loss

    def __init__(self, cfg: ModelConfig, generator=None):
        h, m = cfg.baseline_hidden_dim, cfg.baseline_mem_dim
        super().__init__(cfg, h, generator)
        for name, d in zip("atv", cfg.input_dims):
            self.add_module(f"proj_{name}", Dense(d, h, generator=generator))
            self.add_module(f"enc_{name}", LSTMCell(h, h, generator))
            self.add_module(f"factor_{name}", Dense(h, m, generator=generator))
            self.add_module(f"dec_{name}", GRUCell(2 * m, h, generator))
            self.add_module(f"dec_out_{name}", Dense(h, h, generator=generator))
        self.factor_y_pre = Dense(3 * h, h, generator=generator)
        self.factor_y = Dense(h, m, generator=generator)
        self.post_fc1 = Dense(m, h, generator=generator)
        self.out = Dense(h, cfg.output_dim, generator=generator)
        self.drop = Dropout(cfg.dropout)
        self.prior = Draws(batch_wide=True)

    def forward(self, audio, text, video, *, t_max: Optional[Tuple] = None,
                missing: bool = False, model_loss: bool = True):
        cfg, mods = self.cfg, self._modules
        seqs = _align_inputs(cfg, audio, text, video, t_max)
        projs = [mods[f"proj_{n}"](x) for n, x in zip("atv", seqs)]
        qs = [mods[f"enc_{n}"].scan(p)[:, -1] for n, p in zip("atv", projs)]
        f_y = self.factor_y(torch.relu(self.factor_y_pre(torch.cat(qs, dim=-1))))
        f_ms = [mods[f"factor_{n}"](q) for n, q in zip("atv", qs)]

        recon = []
        for n, f_m, p in zip("atv", f_ms, projs):
            code = torch.cat([f_m, f_y], dim=-1)[:, None, :]                # [B, 1, 2m]
            dec = mods[f"dec_{n}"].scan(code.expand(-1, cfg.baseline_align_t, -1))
            recon.append(((mods[f"dec_out_{n}"](dec) - p.detach()) ** 2).mean(dim=(1, 2)))
        rows = (*f_ms, f_y, torch.stack(recon, dim=1))
        # the prior's draws come before the dropout's in the step's stream
        loss = self.batch_loss(rows) if model_loss else None

        f = self.drop(torch.relu(self.post_fc1(f_y)))
        aux = self._aux(f, f_ms[1])
        aux["loss_rows"] = rows
        if loss is not None:
            aux["model_loss"] = loss
        return self.out(f), aux

    def batch_loss(self, rows):
        """The reconstruction and, in training mode, the MMD of each factor
        against N(0, I) samples of its shape (batch-wide draws); rows: f_m
        x3, f_y [B, m], each modality's reconstruction error [B, 3]."""
        cfg, factors = self.cfg, rows[:4]
        loss = cfg.mfm_recon_w * sum(e.mean() for e in rows[4].unbind(1))
        if self.training:
            mmd = sum(_rbf_mmd(fac, self.prior.normal(fac.shape, fac.dtype)) for fac in factors)
            loss = loss + cfg.mfm_mmd_w * mmd
        return loss


class _TFStep(nn.Module):
    """A GRU decode step and its output Dense."""

    def __init__(self, hidden: int, generator=None):
        super().__init__()
        self.cell = GRUCell(hidden, hidden, generator)
        self.out = Dense(hidden, hidden, generator=generator)


class _TFGRUDecoder(nn.Module):
    """Teacher-forced GRU sequence decoder (MCTN's translation decoder): a
    step's input is the ground-truth previous frame where the mask says so,
    else the decoder's own previous prediction."""

    def __init__(self, hidden: int, generator=None):
        super().__init__()
        self.steps = _TFStep(hidden, generator)

    def forward(self, h0, targets, tf_mask):
        cell, out = self.steps.cell, self.steps.out
        params = cell.hidden_params()
        state, prev = h0, torch.zeros_like(targets[:, 0])
        preds = []
        for t in range(targets.shape[1]):
            gt_prev = targets[:, t - 1] if t else torch.zeros_like(prev)
            inp = torch.where(tf_mask[t], gt_prev, prev)
            state = cell.step(cell.input_gates(inp), state, params)
            prev = out(state)
            preds.append(prev)
        return torch.stack(preds, dim=1)


@MODELS.register("mctn")
class MCTN(_BaselineBase):
    """Multimodal Cyclic Translation Network (hierarchical): a GRU seq2seq
    translates text -> audio and cyclically back with the same encoder; a
    second level encodes the first's joint representation and translates it
    to video. The regression reads the second encoder's final state; the
    translation and cycle losses (MSE in the projected space) weigh
    ``mctn_cycle_w``, with teacher forcing drawn per step at
    ``mctn_teacher_forcing`` in training."""

    has_model_loss = True      # see _BaselineBase.has_model_loss

    def __init__(self, cfg: ModelConfig, generator=None):
        h = cfg.baseline_hidden_dim
        super().__init__(cfg, h, generator)
        for name, d in zip("atv", cfg.input_dims):
            self.add_module(f"proj_{name}", Dense(d, h, generator=generator))
        self.enc1 = GRUCell(h, h, generator)
        self.enc2 = GRUCell(h, h, generator)
        for name in "atv":
            self.add_module(f"dec_{name}", _TFGRUDecoder(h, generator))
        self.post_fc1 = Dense(h, h, generator=generator)
        self.out = Dense(h, cfg.output_dim, generator=generator)
        self.drop = Dropout(cfg.dropout)
        self.teacher = Draws(batch_wide=True)

    def forward(self, audio, text, video, *, t_max: Optional[Tuple] = None,
                missing: bool = False, model_loss: bool = True):
        cfg = self.cfg
        seqs = _align_inputs(cfg, audio, text, video, t_max)
        pa, pt, pv = (self._modules[f"proj_{n}"](x) for n, x in zip("atv", seqs))
        joint = self.enc1.scan(pt)                                           # [B, Ta, h]
        joint2 = self.enc2.scan(joint)
        rows = ()
        if self.training:
            # one mask for every row of the batch (a batch-wide draw)
            tf_mask = self.teacher.uniform((cfg.baseline_align_t,)) < cfg.mctn_teacher_forcing
            a_hat = self.dec_a(joint[:, -1], pa, tf_mask)
            t_hat = self.dec_t(self.enc1.scan(a_hat)[:, -1], pt, tf_mask)
            v_hat = self.dec_v(joint2[:, -1], pv, tf_mask)
            rows = (torch.stack([((y - p.detach()) ** 2).mean(dim=(1, 2))
                                 for y, p in ((a_hat, pa), (t_hat, pt), (v_hat, pv))], dim=1),)
        f = self.drop(torch.relu(self.post_fc1(joint2[:, -1])))
        aux = self._aux(f, joint[:, -1])
        aux["loss_rows"] = rows
        if model_loss:
            aux["model_loss"] = self.batch_loss(rows)
        return self.out(f), aux

    def batch_loss(self, rows):
        """The translation and cycle errors (0 in eval mode, which runs no
        decoder); rows: each translation's error [B, 3], or none."""
        if not rows:
            return 0.0
        return self.cfg.mctn_cycle_w * sum(e.mean() for e in rows[0].unbind(1))


@MODELS.register("mult")
class MULT(_BaselineBase):
    """Multimodal Transformer: conv1d temporal projections, two cross-modal
    transformers per target modality, a causal self-attention transformer
    over their concat, the last valid step of each target, a residual output
    MLP. Each modality keeps its own length."""

    ORDER = (("a", "t", "v"), ("t", "a", "v"), ("v", "a", "t"))

    def __init__(self, cfg: ModelConfig, generator=None):
        d = cfg.baseline_hidden_dim
        L, H, K = cfg.baseline_layers, cfg.baseline_heads, cfg.baseline_kernel_size
        super().__init__(cfg, 6 * d, generator)
        for name, dim in zip("atv", cfg.input_dims):
            self.add_module(f"conv_{name}", Conv1dSame(dim, d, K, generator))
        for tgt, o1, o2 in self.ORDER:
            for o in (o1, o2):
                self.add_module(f"cross_{tgt}_{o}", CrossModalTransformerEncoder(
                    dim=d, layers=L, heads=H, dropout=cfg.dropout, cross=True,
                    generator=generator))
            self.add_module(f"self_{tgt}", CrossModalTransformerEncoder(
                dim=2 * d, layers=L, heads=H, dropout=cfg.dropout, causal=True,
                generator=generator))
        self.post_fc1 = Dense(6 * d, 6 * d, generator=generator)
        self.post_fc2 = Dense(6 * d, 6 * d, generator=generator)
        self.out = Dense(6 * d, cfg.output_dim, generator=generator)
        self.drop = Dropout(cfg.dropout)

    def forward(self, audio, text, video, *, t_max: Optional[Tuple] = None,
                missing: bool = False):
        mods = self._modules
        tm = dict(zip("atv", t_max or (None, None, None)))
        xs = {n: mods[f"conv_{n}"](x) for n, x in zip("atv", (audio, text, video))}
        lasts = []
        for tgt, o1, o2 in self.ORDER:
            c1 = mods[f"cross_{tgt}_{o1}"](xs[tgt], xs[o1])
            c2 = mods[f"cross_{tgt}_{o2}"](xs[tgt], xs[o2])
            hself = mods[f"self_{tgt}"](torch.cat([c1, c2], dim=-1))          # [B, T, 2d]
            t = tm[tgt]
            lasts.append(hself[:, hself.shape[1] - 1 if t is None else max(t - 1, 0)])
        last = torch.cat(lasts, dim=-1)                                      # [B, 6d]
        p = self.drop(torch.relu(self.post_fc1(last)))
        p = self.post_fc2(p) + last
        return self.out(p), self._aux(p, lasts[1])

