"""MANet FER trainer (RAF-DB): the trainer of the visual stage's encoder.

The port of ``sdumc_tpu/extract/manet_train.py``. Reference
(feature_extraction/visual/manet/main.py): SGD(lr 0.01, momentum 0.9, wd
1e-4), StepLR(15, 0.1), 100 epochs, batch 128, two-head cross-entropy mixed
with beta = 0.6, best-accuracy checkpointing, on reorganize_rafdb.py's
ImageFolder layout. RandomResizedCrop + horizontal flip run on the host
with the same numpy draws as JAX's, so the crops equal JAX's to the bit.

Differences from JAX, on purpose (ROADMAP §3):
* BatchNorm trains with torch's semantics: its running variance is the
  unbiased batch variance (flax keeps the biased one, n / (n - 1) apart,
  n = B*H*W);
* the best checkpoint is a reference-format ``.pth``,
  ``{"state_dict", "epoch", "best_acc"}`` with the BN running statistics,
  which ``cli.extract visual`` reads (JAX saves Orbax params without
  ``batch_stats``, which its visual stage cannot read);
* weights start from ``models/manet.init_weights`` (seed 0), not flax's
  initialisers.

    python -m sdumc_tpu_torch.cli.extract manet_train --data RAFDB \\
        [--epochs 100] [--batch-size 128] [--device cpu]   # ./saved/manet/model_best.pth
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from sdumc_tpu_torch.extract.image_io import load_face, resize_bilinear
from sdumc_tpu_torch.models.manet import MANet, MANetConfig, init_weights


def two_head_loss(logits1, logits2, labels, beta: float = 0.6):
    """(beta CE(head 1) + (1 - beta) CE(head 2), accuracy of the mixed
    logits' argmax)."""
    loss = beta * F.cross_entropy(logits1, labels) + (1.0 - beta) * F.cross_entropy(logits2,
                                                                                    labels)
    combined = beta * logits1 + (1.0 - beta) * logits2
    acc = (combined.argmax(dim=-1) == labels).float().mean()
    return loss, acc


def step_lr(base_lr: float, steps_per_epoch: int, step_size: int = 15, gamma: float = 0.1):
    """The learning rate of an optimizer step: StepLR over epochs."""
    def sched(step):
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * gamma ** (epoch // step_size)

    return sched


def make_optimizer(model, lr: float, steps_per_epoch: int, momentum: float = 0.9,
                   wd: float = 1e-4):
    """torch SGD with weight decay (optax's ``add_decayed_weights`` then
    ``sgd(momentum)``: the first step's momentum buffer is the decayed
    gradient) and a per-step LambdaLR giving ``lr * 0.1 ** (epoch // 15)``."""
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum, weight_decay=wd)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, step_lr(1.0, steps_per_epoch))


def make_train_step(model, optimizer, scheduler, beta: float = 0.6):
    """step(images [B, 224, 224, 3] f32 on the model's device, labels [B])
    -> {"loss", "acc"} device scalars: BN in training mode (batch
    statistics, running statistics updated), backward, SGD, schedule."""
    def step(images, labels):
        model.train()
        l1, l2 = model(images.permute(0, 3, 1, 2).contiguous(), return_embedding=False)
        loss, acc = two_head_loss(l1, l2, labels, beta)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        scheduler.step()
        return {"loss": loss.detach(), "acc": acc}

    return step


def random_resized_crop_flip(rng: np.random.Generator, img: np.ndarray, size=224):
    """Host-side RandomResizedCrop((224, 224)) + RandomHorizontalFlip of a
    [H, W, 3] image in 0..1, with JAX's draws from ``rng``."""
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = rng.uniform(0.08, 1.0) * area
        ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if cw <= w and ch <= h:
            x0 = rng.integers(0, w - cw + 1)
            y0 = rng.integers(0, h - ch + 1)
            crop = img[y0:y0 + ch, x0:x0 + cw]
            break
    else:
        crop = img
    out = resize_bilinear((crop * 255).astype(np.uint8), (size, size)).astype(np.float32) / 255.0
    if rng.random() < 0.5:
        out = out[:, ::-1]
    return out


def image_folder(root: str):
    """torchvision ImageFolder layout: root/class_x/img -> (paths, labels,
    classes)."""
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for ci, cls in enumerate(classes):
        for fn in sorted(os.listdir(os.path.join(root, cls))):
            paths.append(os.path.join(root, cls, fn))
            labels.append(ci)
    return paths, np.array(labels), classes


def evaluate(model, paths, labels, batch_size: int, beta: float, device) -> float:
    """Test accuracy of the mixed heads, BN in eval mode."""
    model.eval()
    correct = 0
    with torch.inference_mode():
        for s in range(0, len(paths), batch_size):
            imgs = torch.from_numpy(np.stack([load_face(p) for p in paths[s:s + batch_size]]))
            l1, l2 = model(imgs.to(device).permute(0, 3, 1, 2).contiguous(),
                           return_embedding=False)
            pred = (beta * l1 + (1 - beta) * l2).argmax(dim=-1).cpu().numpy()
            correct += int((pred == labels[s:s + len(pred)]).sum())
    return correct / len(paths)


def main(argv=None) -> dict:
    """Train, evaluate every epoch, keep the best checkpoint. Returns the
    per-step losses, per-epoch accuracies, the best, the checkpoint path
    and the host-clock seconds of the training steps."""
    from sdumc_tpu_torch.cli.common import resolve_device, set_matmul_precision

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data", type=str, required=True,
                        help="ImageFolder root with train/ test/")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--beta", type=float, default=0.6)
    parser.add_argument("--checkpoint_path", type=str, default="./saved/manet")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (the default) raises when no card is present")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    set_matmul_precision("highest")
    train_paths, train_labels, classes = image_folder(os.path.join(args.data, "train"))
    test_paths, test_labels, _ = image_folder(os.path.join(args.data, "test"))
    model = init_weights(MANet(MANetConfig(num_classes=len(classes))), seed=0).to(device)
    steps_per_epoch = len(train_paths) // args.batch_size
    optimizer, scheduler = make_optimizer(model, args.lr, steps_per_epoch)
    step = make_train_step(model, optimizer, scheduler, args.beta)

    os.makedirs(args.checkpoint_path, exist_ok=True)
    ckpt = os.path.join(args.checkpoint_path, "model_best.pth")
    rng = np.random.default_rng(0)
    best_acc, losses, accs, step_seconds = 0.0, [], [], 0.0
    for epoch in range(args.epochs):
        order = rng.permutation(len(train_paths))
        t0 = time.perf_counter()
        epoch_losses = []
        for s in range(0, steps_per_epoch * args.batch_size, args.batch_size):
            idx = order[s:s + args.batch_size]
            imgs = np.stack([random_resized_crop_flip(rng, load_face(train_paths[i]))
                             for i in idx])
            metrics = step(torch.from_numpy(imgs).to(device),
                           torch.from_numpy(train_labels[idx]).to(device))
            epoch_losses.append(metrics["loss"])
        losses += torch.stack(epoch_losses).tolist() if epoch_losses else []
        step_seconds += time.perf_counter() - t0
        acc = evaluate(model, test_paths, test_labels, args.batch_size, args.beta, device)
        accs.append(acc)
        print(f"epoch {epoch + 1}: test acc {acc:.4f} ({time.perf_counter() - t0:.1f}s)")
        if acc > best_acc:
            best_acc = acc
            torch.save({"state_dict": model.state_dict(), "epoch": epoch, "best_acc": best_acc},
                       ckpt)
    print(f"best acc: {best_acc:.4f}")
    return {"losses": losses, "accs": accs, "best_acc": best_acc,
            "checkpoint": ckpt if os.path.exists(ckpt) else None,
            "steps": steps_per_epoch * args.epochs, "seconds": step_seconds}
