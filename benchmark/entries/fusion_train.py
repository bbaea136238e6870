"""The fusion net's dual-view training, as ``cli.train`` runs its epochs.

Set-up writes the cell's store, builds the dataset, the model with the
seeded weights, the train state (Adam with L2, the warm-up schedule) and
the train step (``make_train_step``), and takes the first steps of epoch 0
through the window's own feed: ``BatchIterator`` (shuffled, page-locked,
the remainder dropped) -> ``batch_to_device_dict`` -> the step. Those steps
warm every shape and are what the check follows. The window goes on from
there with the same iterator, state and step, and starts a new
``BatchIterator`` at each epoch's end, after reading the epoch's summed
metrics back once, as ``train/loop.py``'s train pass does.

The check runs the plain reference (``reference/fusion.py``) from the same
seeded weights over the same clips, read from the store's bytes, for the
same first steps, and compares each step's loss, the first step's gradient
as Adam took it (its first moment over 1 - beta1) leaf by leaf, and each
leaf's change over the steps; the gradient and the change by the median
leaf's gap, since the worst leaf's swings from seed to seed where a ReLU's
input lies within rounding of 0 and takes the other side on one of the
two (PERF.md gives both readings).
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.counts import fusion as counts
from benchmark.lib import fusion_setup as fs
from benchmark.lib import seeds
from benchmark.lib.runner import Window
from benchmark.reference import fusion as ref
from benchmark.reference.precision import Precision, true_f32

CHECK_STEPS = 3
BETA1 = 0.9
# faults planted in the timed path for the tests and the calibration
FAULTS = ("stale_state", "half_batch")


class Job:
    def __init__(self, cfg: Dict, cell: Dict, seed: int, device, spans, fault: Optional[str] = None):
        from sdumc_tpu_torch.cli.common import set_matmul_precision
        from sdumc_tpu_torch.core.config import LossConfig, TrainConfig
        from sdumc_tpu_torch.train.state import create_train_state
        from sdumc_tpu_torch.train.step import make_train_step

        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        p = cell["traffic_params"]
        self.cfg, self.device, self.spans, self.fault = cfg, torch.device(device), spans, fault
        self.limits = cell["check"]
        self.bs = p["batch_size"]
        self.n_clips = p["clips_per_epoch"]
        self.steps_per_epoch = self.n_clips // self.bs
        self.shuffle_seed = seeds.derive(seed, "shuffle")
        self.train_seed = seeds.derive(seed, "dropout")
        self.seed = seed
        self.prefetch = p["prefetch"]
        self.store = fs.make_store(cfg, p, seed, self.device, self.n_clips)
        self.ds = fs.dataset(self.store)
        set_matmul_precision("highest")
        model = fs.model(cfg, seed, self.device)
        self.leaves = dict(model.named_parameters())
        p0 = {k: v.detach().clone() for k, v in self.leaves.items()}
        s = cfg["schedule"]
        tcfg = TrainConfig(lr=cfg["lr"], l2=cfg["l2"], warmup_epochs=s["warmup_epochs"],
                           decay_gamma=s["decay_gamma"], decay_stepsize=s["decay_stepsize"],
                           seed=self.train_seed)
        self.state = create_train_state(model, tcfg, self.steps_per_epoch)
        self.program = make_train_step(self.state, LossConfig(**cfg["loss"]), self.train_seed)
        if fault == "stale_state":
            self.state.optimizer.step = lambda *a, **k: None
        self.epoch = 0
        self.iterator = self._epoch(0)
        self.acc = None

        losses = []
        for i in range(CHECK_STEPS):
            losses.append(self._step()[2]["loss"])
            if i == 0:
                self.grad_norms = self._first_grad_norms()
        self.losses = [float(x) for x in losses]
        self.change_norms = {k: float(torch.linalg.vector_norm(v.detach() - p0[k]))
                             for k, v in self.leaves.items()}
        del p0

    def _epoch(self, epoch: int):
        from sdumc_tpu_torch.data.pipeline import BatchIterator

        it = BatchIterator(self.ds, self.bs, shuffle=True, seed=self.shuffle_seed, epoch=epoch,
                           buckets=tuple(self.cfg["length_buckets"]), prefetch=self.prefetch,
                           pin_memory=self.device.type == "cuda", drop_remainder=True)
        return itertools.islice(iter(it), self.steps_per_epoch)

    def _step(self):
        """One step of the train pass; at an epoch's end, the epoch's metrics
        read back once and the next epoch's iterator started first."""
        from sdumc_tpu_torch.train.step import batch_to_device_dict

        with self.spans("data_wait"):
            batch = next(self.iterator, None)
        if batch is None:
            with self.spans("epoch_end"):
                self.epoch_sums = {k: float(v) for k, v in (self.acc or {}).items()}
                self.acc = None
                self.epoch += 1
                self.iterator = self._epoch(self.epoch)
            with self.spans("data_wait"):
                batch = next(self.iterator)
        with self.spans("h2d"):
            d = batch_to_device_dict(batch, self.device, "float32")
        if self.fault == "half_batch":
            d = _half(d)
        with self.spans("step"):
            metrics = self.program(d)
        self.acc = metrics if self.acc is None else {k: self.acc[k] + v
                                                     for k, v in metrics.items()}
        return tuple(int(t) for t in batch.t_max), batch.size, metrics

    def _first_grad_norms(self) -> Dict[str, float]:
        """Each leaf's gradient as Adam took it in the first step (its first
        moment over 1 - beta1); 0 for a leaf it did not update."""
        opt = self.state.optimizer
        out = {}
        for k, v in self.leaves.items():
            m = opt.state.get(v, {}).get("exp_avg")
            out[k] = 0.0 if m is None else float(torch.linalg.vector_norm(m / (1 - BETA1)))
        return out

    def window(self, seconds: float) -> Window:
        flops, clips, steps = 0.0, 0, 0
        kf, kb = 0.0, 0.0
        t0 = time.perf_counter()
        while True:
            t_max, size, _ = self._step()
            steps += 1
            clips += size
            flops += counts.train_step_flops(self.cfg, size, t_max)
            for f, b in counts.kernel_calls(self.cfg, size, t_max):
                kf += f
                kb += b
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        return Window(seconds=elapsed, e2e={"train_clips_per_s": clips / elapsed},
                      attempted=steps, flops=flops, kernel_work={"fused_cross": (kf, kb)},
                      steps=steps)

    def release(self) -> None:
        """Frees the program's state: model, optimizer, step, iterator."""
        self.iterator = None
        self.program = self.state = self.leaves = self.acc = None
        self.ds = None

    def check(self) -> List:
        """(name, reading, limit) of the loss, first-gradient and change
        gaps against the reference; the store is removed afterwards."""
        try:
            readings = self.readings((self.losses, self.grad_norms, self.change_norms))
        finally:
            self.store.tmp.cleanup()
        return [(k, readings[k], self.limits[k]) for k in ("loss_gap", "grad_gap", "change_gap")]

    def control(self) -> Dict[str, float]:
        """The readings of the reference at TF32 in the program's place."""
        try:
            return self.readings(self.reference_run(Precision("tf32")))
        finally:
            self.store.tmp.cleanup()

    def look(self) -> Dict[str, float]:
        """The readings of the reference at f32 in the program's place, its
        weights nudged by 2^-22 of themselves: what rounding alone moves."""
        try:
            return self.readings(self.reference_run(Precision("f32"), nudge=2.0 ** -22))
        finally:
            self.store.tmp.cleanup()

    def reference_run(self, pr: Precision, nudge: float = 0.0):
        """The reference's (losses, first gradients, changes) over the
        first steps, from the seeded weights (times 1 + `nudge`)."""
        cfg, dev = self.cfg, self.device
        order = ref.epoch_order(self.n_clips, self.shuffle_seed, 0)
        batches = [fs.reference_batch(self.store, order[i * self.bs:(i + 1) * self.bs], cfg, dev)
                   for i in range(CHECK_STEPS)]
        with true_f32():
            params = fs.state_dict(cfg, self.seed, dev)
            if nudge:
                for v in params.values():
                    v.mul_(1.0 + nudge)
            p0 = {k: v.clone() for k, v in params.items()}
            losses, first = ref.train_steps(params, batches, cfg, self.train_seed,
                                            self.steps_per_epoch, pr)
        grads = {k: float(torch.linalg.vector_norm(g)) for k, g in first.items()}
        changes = {k: float(torch.linalg.vector_norm(params[k] - p0[k])) for k in first}
        return losses, grads, changes

    def readings(self, program) -> Dict[str, float]:
        """The three gaps between `program`'s (losses, first gradients,
        changes) and the reference's at f32."""
        losses, grads, changes = program
        r_losses, r_grads, r_changes = self.reference_run(Precision("f32"))
        gaps = {"grad": leaf_gaps(grads, r_grads, r_grads),
                "change": leaf_gaps(changes, r_changes, r_grads)}
        # the worst leaf, reported beside the compared median (see PERF.md)
        self.worst = {k: [max(g.values()), max(g, key=g.get)] for k, g in gaps.items()}
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
                "grad_gap": float(np.median(list(gaps["grad"].values()))),
                "change_gap": float(np.median(list(gaps["change"].values())))}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              ref_grads: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's |got - want| over the larger of its reference norm and
    the median leaf's. Leaves whose reference gradient is under a
    thousandth of the median leaf's (nought to rounding, moved by Adam's
    round-off alone) are left out; a leaf the reference did not update, or
    the program did not, reads as 0 on that side."""
    med_grad = float(np.median(list(ref_grads.values())))
    keep = [k for k in want if ref_grads[k] >= 1e-3 * med_grad]
    med = float(np.median([want[k] for k in keep]))
    gaps = {k: abs(got.get(k, 0.0) - want[k]) / max(want[k], med) for k in keep}
    gaps.update({k: 1.0 for k in got if got[k] > 0 and k not in want})
    return gaps


def _half(d: Dict) -> Dict:
    """The batch's first half of rows, as a fault: the mean taken over it."""
    out = dict(d)
    n = d["vals"].shape[0] // 2
    for k in ("audio", "text", "video", "feat4", "vals"):
        out[k] = d[k][:n]
    return out
