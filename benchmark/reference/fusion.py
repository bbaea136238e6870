"""Plain PyTorch reference of the SDUMC fusion net's dual-view train and eval
steps (WengnetMOSEIMultViewsTextMissing, github.com/WarmCongee/SDUMC,
``main_frame_val_text_missing.py``), written from the published model and
recipe. It imports nothing of the program under test.

A batch is padded to its own maximum length per stream (the reference's
batch-max padding): pad frames are zeros, so after a projection they carry
its bias and take part in the time softmax. The teacher view reads (audio,
text, video), the student view (audio, feat4, video); the two views run as
2B stacked rows, teacher rows first, the text stream of each row masked
past its own view's length.

Dropout. A training step draws its masks from one ``torch.Generator``
seeded by ``step_seed(seed, step)``, in the order in which the modules run:
frame dropout (one random byte a value, kept where the byte is >= 128,
scaled by 2: the attention rate 0.5) on each stream before each of its
frame-attention ops, and dropout (a uniform draw a value, kept where it is
>= rate, scaled by 1 / (1 - rate)) after every pool and every cross
attention (at the attention rate) and after every MLP ReLU (at the MLPs'
rate). A frame stream's mask is drawn at the stream's padded length bucket
(``bucket_for``), as the batches come padded to a bucket, and its first
t_max frames are used. This is the rule of the recipe's train step; the
reference repeats it so that both sides drop the same values.

The step: loss = w_full MSE(full) + w_miss MSE(missing) + w_tf RMSE(text
query MLP outputs, the teacher's held) + w_tqf RMSE(cross-attended text,
the teacher's held) + w_f RMSE(fused features, the teacher's not held) +
w_rnc RnC(rnc projections, labels); its gradient by autograd; torch Adam's
update with L2 (the decay added to the gradient) at the warm-up schedule's
rate. Parameters that receive no gradient are not updated.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference.precision import Precision


def step_seed(seed: int, step: int) -> int:
    """The 64-bit seed of one step's dropout generator: the two 32-bit
    words of numpy's SeedSequence over (seed, step)."""
    hi, lo = np.random.SeedSequence([seed, step]).generate_state(2)
    return (int(hi) << 32) | int(lo)


def bucket_for(t: int, buckets: Sequence[int]) -> int:
    """The smallest length bucket that holds t frames (the last holds all)."""
    return next((b for b in buckets if t <= b), buckets[-1])


def lr_factor(step: int, steps_per_epoch: int, warmup_epochs: int, gamma: float,
              stepsize: int) -> float:
    """The recipe's LambdaLR factor, at the epoch of an optimizer step."""
    epoch = step // max(steps_per_epoch, 1)
    if epoch < warmup_epochs:
        return (epoch + 1) / warmup_epochs
    return gamma ** ((epoch + 1 - warmup_epochs) // stepsize)


class Drops:
    """The step's dropout masks, drawn in module order from `generator`
    (None: eval mode, no dropout)."""

    def __init__(self, generator: Optional[torch.Generator], rate: float, attn_rate: float):
        self.g = generator
        self.rate = rate
        self.attn_rate = attn_rate
        self.k = int(round(attn_rate * 256))

    def frames(self, x: torch.Tensor, bucket: int) -> torch.Tensor:
        """Frame dropout of x [R, T, d], the mask drawn at [R, bucket, d]."""
        if self.g is None:
            return x
        bits = torch.empty((x.shape[0], bucket, x.shape[2]), dtype=torch.uint8, device=x.device)
        bits.random_(generator=self.g)
        keep = bits[:, : x.shape[1]] >= self.k
        return torch.where(keep, x * (1.0 / (1.0 - self.k / 256.0)), 0.0)

    def values(self, x: torch.Tensor, rate: Optional[float] = None) -> torch.Tensor:
        """Dropout at `rate` (the MLPs' by default)."""
        if self.g is None:
            return x
        rate = self.rate if rate is None else rate
        u = torch.rand(x.shape, generator=self.g, device=x.device)
        return torch.where(u >= rate, x * (1.0 / (1.0 - rate)), 0.0)


def _mask_after(scores: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """scores [R, T, ...] with positions t >= lengths[r] at -inf-like."""
    t = torch.arange(scores.shape[1], device=scores.device)
    keep = (t[None, :] < lengths[:, None]).reshape(scores.shape[:2] + (1,) * (scores.ndim - 2))
    return torch.where(keep, scores, torch.full_like(scores, -1e30))


def _frame_attention(pr: Precision, query, x, w, b, lengths, scale):
    """softmax over time of scale * (tanh(x W^T + b) . q), then the
    weighted sum of x: query [R, Q, d] (or [d], one query for every row)."""
    k = torch.tanh(pr.linear(x, w, b))
    if query.ndim == 1:
        scores = pr.einsum("rtd,d->rt", k, query)[..., None]
    else:
        scores = pr.einsum("rtd,rqd->rtq", k, query)
    attn = torch.softmax(_mask_after(scale * scores, lengths), dim=1)
    out = pr.einsum("rtd,rtq->rqd", x, attn)
    return out[:, 0] if query.ndim == 1 else out


def _mlp(pr: Precision, p, name: str, n_layers: int, x, drops: Drops):
    for i in range(n_layers):
        x = torch.relu(pr.linear(x, p[f"{name}.{3 * i}.weight"], p[f"{name}.{3 * i}.bias"]))
        x = drops.values(x)
    return x


def forward_dual(p: Dict[str, torch.Tensor], batch: Dict, cfg: Dict, pr: Precision,
                 drops: Drops):
    """Both views as 2B stacked rows. `batch`: audio [B, ta, Da], text
    [B, tt, Dt], feat4 [B, tf, Dt], video [B, tv, Dv] (batch-max padded),
    and ``buckets`` (audio, text, video): the padded lengths the masks are
    drawn at. Returns (preds [2B], aux {features, rnc, text_feat,
    text_query_feat}, each [2B, ...])."""
    scale = cfg["softmax_scale"]
    audio, text, feat4, video = batch["audio"], batch["text"], batch["feat4"], batch["video"]
    B = audio.shape[0]
    dev = audio.device
    ba, bt, bv = batch["buckets"]

    def lin(name, x):
        return pr.linear(x, p[name + ".weight"], p[name + ".bias"])

    audio_f = lin("frame_dim_reshape_0", audio)
    audio_f = torch.cat([audio_f, audio_f])
    video_f = lin("frame_dim_reshape_2", video)
    video_f = torch.cat([video_f, video_f])
    tf_gt, tf_ps = lin("frame_dim_reshape_1", text), lin("frame_dim_reshape_1", feat4)
    T_t = max(tf_gt.shape[1], tf_ps.shape[1])
    pad = torch.nn.functional.pad
    text_f = torch.cat([pad(tf_gt, (0, 0, 0, T_t - tf_gt.shape[1])),
                        pad(tf_ps, (0, 0, 0, T_t - tf_ps.shape[1]))])
    len_a = torch.full((2 * B,), audio.shape[1], device=dev)
    len_v = torch.full((2 * B,), video.shape[1], device=dev)
    len_t = torch.cat([torch.full((B,), text.shape[1], device=dev),
                       torch.full((B,), feat4.shape[1], device=dev)])
    streams = ((audio_f, len_a, ba), (text_f, len_t, bt), (video_f, len_v, bv))

    pooled = []
    for i, (x, lengths, bucket) in enumerate(streams):
        x = drops.frames(x, bucket)
        pre = f"fra2utt_{i}"
        out = _frame_attention(pr, p[pre + ".attention_context_vector"][0], x,
                               p[pre + ".input_proj.weight"], p[pre + ".input_proj.bias"],
                               lengths, scale)
        pooled.append(drops.values(out, drops.attn_rate))

    hidden = [_mlp(pr, p, name, 2, x, drops)
              for name, x in zip(("audio_mlp", "text_mlp", "video_mlp"), pooled)]
    audio_h, text_h, video_h = hidden
    att = lin("fc_att", _mlp(pr, p, "attention_mlp", 2, torch.cat(hidden, dim=1), drops))
    hiddens = torch.stack(hidden, dim=1)                                   # [R, 3, h]
    fused = pr.einsum("bmd,bm->bd", hiddens, att)
    fused_at = pr.einsum("bmd,bm->bd", hiddens[:, :2], att[:, :2])
    fused_tv = pr.einsum("bmd,bm->bd", hiddens[:, 1:], att[:, 1:])
    fused_av = pr.einsum("bmd,bm->bd", hiddens[:, 0::2], att[:, 0::2])

    text_q = _mlp(pr, p, "cross_text_query_mlp", 1, text_h, drops)
    q = {}
    for name, x in (("fused", fused), ("at", fused_at), ("tv", fused_tv), ("av", fused_av),
                    ("audio", audio_h), ("video", video_h)):
        q[name] = _mlp(pr, p, f"cross_{name}_query_mlp", 1, x, drops)
    multi_query = torch.stack([q["fused"], q["at"], q["tv"], q["av"], q["audio"], text_q,
                               q["video"]], dim=1)                           # [R, 7, d]

    cross = []
    for i, ((x, lengths, bucket), name) in enumerate(zip(streams, ("audio", "text", "video"))):
        x = drops.frames(x, bucket)
        pre = f"cross_att_fra2utt_{i}"
        qp = lin(pre + ".query_proj", multi_query)
        out = _frame_attention(pr, qp, x, p[pre + ".input_proj.weight"],
                               p[pre + ".input_proj.bias"], lengths, scale)
        out = drops.values(out, drops.attn_rate)
        cross.append(_mlp(pr, p, f"cross_{name}_mlp", 2, out, drops))

    cross_h = torch.stack(cross, dim=1)                                     # [R, 3, 7, H]
    weighted = pr.einsum("bmqh,bm->bqh", cross_h, att)
    cross_att = lin("cross_fc_att", _mlp(pr, p, "cross_attention_mlp", 2,
                                         weighted.reshape(weighted.shape[0], -1), drops))
    features = pr.einsum("bqh,bq->bh", weighted, cross_att)
    preds = lin("fc_out_v", features)[:, 0]
    rnc = lin("orgin_linear_change.2", torch.relu(lin("orgin_linear_change.0", features)))
    aux = {"features": features, "rnc": rnc, "text_feat": text_q,
           "text_query_feat": cross_h[:, 1]}
    return preds, aux


def _rmse(a, b):
    return torch.sqrt(torch.mean((a.reshape(a.shape[0], -1) - b.reshape(b.shape[0], -1)) ** 2))


def rnc_loss(pr: Precision, feats2: torch.Tensor, labels: torch.Tensor, temperature: float):
    """Rank-N-Contrast over the two views' projections: feats2 [2B, D]
    (teacher rows first), labels [B]."""
    labels = torch.cat([labels, labels])[:, None]
    label_diffs = torch.abs(labels[:, None, :] - labels[None, :, :]).sum(-1)
    sq = ((feats2[:, None, :] - feats2[None, :, :]) ** 2).sum(-1)
    positive = sq > 0.0
    sim = torch.where(positive, -torch.sqrt(torch.where(positive, sq, 1.0)), 0.0)
    logits = sim / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    n = logits.shape[0]
    offdiag = 1.0 - torch.eye(n, dtype=logits.dtype, device=logits.device)
    exp_logits = torch.exp(logits) * offdiag
    neg_mask = (label_diffs[:, None, :] >= label_diffs[:, :, None] - 1e-4).to(logits.dtype)
    denom = pr.einsum("ikj,ij->ik", neg_mask, exp_logits)
    return -torch.sum((logits - torch.log(denom)) * offdiag) / (n * (n - 1))


def dual_loss(p, batch, cfg, pr: Precision, drops: Drops):
    preds, aux = forward_dual(p, batch, cfg, pr, drops)
    B = batch["vals"].shape[0]
    vals = batch["vals"]
    w = cfg["loss"]
    t0 = {k: v[:B] for k, v in aux.items()}
    t1 = {k: v[B:] for k, v in aux.items()}
    mse0 = torch.sum((preds[:B] - vals) ** 2) / B
    mse1 = torch.sum((preds[B:] - vals) ** 2) / B
    rnc = rnc_loss(pr, aux["rnc"], vals, w["rnc_temperature"])
    return (w["full_mse_w"] * mse0 + w["missing_mse_w"] * mse1
            + w["text_feat_w"] * _rmse(t1["text_feat"], t0["text_feat"].detach())
            + w["text_query_feat_w"] * _rmse(t1["text_query_feat"], t0["text_query_feat"].detach())
            + w["features_w"] * _rmse(t1["features"], t0["features"])
            + w["rnc_w"] * rnc)


class Adam:
    """torch.optim.Adam's update with L2 (decay added to the gradient),
    written out; a parameter whose gradient is None is skipped."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, l2: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.l2, self.betas, self.eps = lr, l2, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.steps = {k: 0 for k in params}

    def step(self, params, grads, factor: float) -> Dict[str, torch.Tensor]:
        """Updates `params` in place; returns the gradient each parameter's
        moments took (L2 included)."""
        b1, b2 = self.betas
        taken = {}
        with torch.no_grad():
            for k, g in grads.items():
                if g is None:
                    continue
                p = params[k]
                g = g + self.l2 * p
                taken[k] = g
                self.steps[k] += 1
                t = self.steps[k]
                self.m[k].lerp_(g, 1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(self.eps)
                p.addcdiv_(self.m[k], denom, value=-(self.lr * factor) / (1 - b1 ** t))
        return taken


def train_steps(params: Dict[str, torch.Tensor], batches: List[Dict], cfg: Dict, seed: int,
                steps_per_epoch: int, pr: Precision):
    """Runs the recipe's first len(batches) optimizer steps from `params`
    (updated in place). Returns (losses [float], first_grads {name: the
    first step's gradient as Adam takes it}); both in the order of steps."""
    opt = Adam(params, cfg["lr"], cfg["l2"])
    sched = cfg["schedule"]
    losses, first = [], None
    dev = next(iter(params.values())).device
    for step, batch in enumerate(batches):
        g = torch.Generator(device=dev)
        g.manual_seed(step_seed(seed, step))
        drops = Drops(g, cfg["dropout"], cfg["attn_dropout"])
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = dual_loss(leaves, batch, cfg, pr, drops)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        factor = lr_factor(step, steps_per_epoch, sched["warmup_epochs"], sched["decay_gamma"],
                           sched["decay_stepsize"])
        taken = opt.step(params, dict(zip(names, grads)), factor)
        losses.append(float(loss.detach()))
        if first is None:
            first = taken
        del leaves, loss, grads
    return losses, first


def eval_preds(params, batch, cfg, pr: Precision):
    """(preds_full [B], preds_missing [B]) in eval mode (no dropout)."""
    with torch.no_grad():
        preds, _ = forward_dual(params, batch, cfg, pr, Drops(None, 0.0, 0.0))
    B = batch["audio"].shape[0]
    return preds[:B], preds[B:]


def assemble(store, names: Sequence[str], vals: np.ndarray, buckets: Sequence[int], device):
    """A batch as the reference pads it, from the store's raw bytes:
    ``store[m]`` is (the stream's blob as a flat f32 array, {clip: (offset,
    rows, cols)}). Each stream is zero-padded to its batch max, capped at
    the last bucket (longer clips do not occur in the cells' traffic and
    are refused)."""
    out = {}
    lens = {}
    for m in ("audio", "text", "video", "feat4"):
        blob, index = store[m]
        entries = [index[n] for n in names]
        t = max(e[1] for e in entries)
        if t > buckets[-1]:
            raise ValueError(f"a {m} clip of {t} frames is past the last bucket")
        dim = entries[0][2]
        arr = np.zeros((len(names), t, dim), np.float32)
        for i, (off, rows, cols) in enumerate(entries):
            arr[i, :rows] = np.asarray(blob[off: off + rows * cols]).reshape(rows, cols)
        out[m] = torch.from_numpy(arr).to(device)
        lens[m] = t
    out["vals"] = torch.as_tensor(np.asarray(vals, np.float32), device=device)
    out["buckets"] = (bucket_for(lens["audio"], buckets),
                      max(bucket_for(lens["text"], buckets), bucket_for(lens["feat4"], buckets)),
                      bucket_for(lens["video"], buckets))
    return out


def weight_layout(cfg: Dict):
    """The net's tensors as (name, shape, lo, hi): every Linear at torch's
    default range U(+-1/sqrt(fan_in)), each pool's context vector at the
    spread of its xavier-normal init, PReLU at 0.25, layer norm at (1, 0).
    The imagination blocks, the PReLU, the layer norm and the fc_out_e /
    fc_out_ev heads are in the published checkpoint but unused by the
    recipe (``use_imagination`` off)."""
    Da, Dt, Dv = cfg["input_dims"]
    d = cfg["general_dim"]
    f0, f1 = cfg["fused_layers"]
    l0, l1 = cfg["layers"]
    Q, r = 7, cfg["rnc_proj_dim"]
    out = []

    def lin(name, n_out, n_in):
        b = 1.0 / math.sqrt(n_in)
        out.append((name + ".weight", (n_out, n_in), -b, b))
        out.append((name + ".bias", (n_out,), -b, b))

    def mlp(name, n_in, dims):
        for i, n in enumerate(dims):
            lin(f"{name}.{3 * i}", n, n_in)
            n_in = n

    def residual_ae(name, hidden, n_in):
        lin(f"{name}.transition.0", n_in, 3 * n_in)
        lin(f"{name}.transition.2", n_in, n_in)
        lin(f"{name}.encoder_0.0", hidden, n_in)
        lin(f"{name}.decoder_0.0", n_in, hidden)

    ctx = math.sqrt(3.0) * math.sqrt(2.0 / (1 + d))
    for i, n_in in enumerate((Da, Dt, Dv)):
        lin(f"frame_dim_reshape_{i}", d, n_in)
    for i in range(3):
        out.append((f"fra2utt_{i}.attention_context_vector", (1, d), -ctx, ctx))
        lin(f"fra2utt_{i}.input_proj", d, d)
    for m in ("audio", "text", "video"):
        mlp(f"{m}_mlp", d, (f0, f1))
    residual_ae("missing_text_imagination_mlp", 128, f1)
    mlp("attention_mlp", 3 * f1, (f0, f1))
    lin("fc_att", 3, f1)
    for m in ("fused", "at", "tv", "av", "audio", "text", "video"):
        mlp(f"cross_{m}_query_mlp", f1, (d,))
    for i in range(3):
        lin(f"cross_att_fra2utt_{i}.query_proj", d, d)
        lin(f"cross_att_fra2utt_{i}.input_proj", d, d)
    for m in ("audio", "text", "video"):
        mlp(f"cross_{m}_mlp", d, (l0, l1))
    residual_ae("missing_cross_text_query_imagination_mlp", 64, l1)
    mlp("cross_attention_mlp", Q * l1, (l0, l1))
    lin("cross_fc_att", Q, l1)
    lin("fc_out_v", cfg["output_dim"], l1)
    lin("orgin_linear_change.0", r, l1)
    lin("orgin_linear_change.2", r, r)
    lin("fc_out_e", cfg["output_dim"], l1)
    lin("fc_out_ev", cfg["output_dim"], cfg["output_dim"])
    out.append(("prelu.weight", (6,), 0.25, 0.25))
    out.append(("layer_normali.weight", (f1,), 1.0, 1.0))
    out.append(("layer_normali.bias", (f1,), 0.0, 0.0))
    return out


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The recipe's shuffled order of an epoch's n clips: numpy's
    default_rng over (seed, epoch) shuffling 0..n-1."""
    idx = np.arange(n)
    np.random.default_rng((seed, epoch)).shuffle(idx)
    return idx
