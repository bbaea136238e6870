"""The other visual encoders: CLIP / DINOv2 / VideoMAE / EVA-02 / ImageNet
ResNet-18 embeddings of face crops, the video stream's alternatives to
MANet. The port of ``sdumc_tpu/extract/vision_hf.py``.

Reference (feature_extraction/visual/extract_vision_huggingface.py and
extract_imagenet_embedding.py): per video, the OpenFace face crops sorted
by name and resampled every 5th frame (:100-107), resized bicubic and
normalised as HF's processor does, batched through the encoder; FRAME
saves [T, D], UTTERANCE the mean [D], with the empty and one-frame cases
of :186-200. VideoMAE embeds windows of ``num_frames`` frames (the tail
repeats the last frame), one token-mean row a window.

The crops are read and resized on the host by ``extract/image_io.py``
(no Pillow; the bicubic resize equals Pillow's to the bit); each batch
goes to the card as one NCHW copy from page-locked memory. The encoders
run in f32 with TF32 off, as the reference ran HF in f32. Each video's
last chunk runs at its true size (JAX pads it to ``--batch_size``; the
rows are independent), and a video's VideoMAE windows run in batches of
``--batch_size`` (JAX runs one window a call).

    python -m sdumc_tpu_torch.cli.extract vision --model clip --model_dir DIR \\
        --face_dir FACES --save_dir OUT [--device cpu]       # OUT/{vid}.npy
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from sdumc_tpu_torch.extract.image_io import read_image, resize_bicubic

# HF CLIPImageProcessor's constants (openai/clip-vit-*)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
# torchvision's ImageNet constants (extract_imagenet_embedding.py:158-160)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
MODELS = ("clip", "dinov2", "videomae", "eva02", "imagenet")


def resample_frames(paths: List[str], step: int = 5) -> List[str]:
    """Every ``step``-th frame, in name order (reference :100-107)."""
    return paths[::step]


def load_normalized(path: str, size: int, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """[size, size, 3] f32: the crop resized bicubic, scaled to 0..1 and
    normalised per channel, as JAX's PIL path computes it."""
    arr = resize_bicubic(read_image(path), (size, size)).astype(np.float32) / 255.0
    return (arr - mean) / std


def to_device(frames: np.ndarray, device: torch.device, layout=(0, 3, 1, 2)) -> torch.Tensor:
    """Host frames (channels last) -> the model's layout on ``device``, in one
    copy; on a card from page-locked memory."""
    src = torch.from_numpy(frames).permute(*layout)
    if device.type != "cuda":
        return src.contiguous()
    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    pinned.copy_(src)
    return pinned.to(device, non_blocking=True)


def batched_embed(run: Callable, frames: List[np.ndarray], batch_size: int = 32) -> np.ndarray:
    """``run`` over ``frames`` in chunks of ``batch_size``, the last at its
    true size -> [T, D]."""
    return np.concatenate([run(np.stack(frames[s:s + batch_size]))
                           for s in range(0, len(frames), batch_size)], axis=0)


def save_embeddings(save_path: str, embeddings: np.ndarray, dim: int, feature_level: str) -> None:
    """The reference's FRAME / UTTERANCE files, with its empty and one-frame
    cases (extract_vision_huggingface.py:186-200)."""
    emb = np.asarray(embeddings).squeeze()
    if feature_level == "FRAME":
        if emb.size == 0:
            emb = np.zeros((1, dim), np.float32)
        elif emb.ndim == 1:
            emb = emb[None, :]
    else:
        if emb.size == 0:
            emb = np.zeros((dim,), np.float32)
        elif emb.ndim == 2:
            emb = emb.mean(axis=0)
    np.save(save_path, emb.astype(np.float32))


def extract_dir(embed: Callable, face_dir: str, save_dir: str, *, image_size: int,
                mean: np.ndarray, std: np.ndarray, dim: int, feature_level: str = "FRAME",
                resample_step: int = 5) -> dict:
    """One folder of face crops per video -> ``save_dir/{vid}.npy``, a video
    whose file exists skipped.
    ``embed`` maps a video's normalised frames to its rows; a video with no
    frame saves zeros (JAX's VideoMAE branch saves zeros [1, dim] there,
    which save_embeddings turns into the same file). Returns the counts, the
    host-clock seconds and, apart, the seconds spent reading and resizing
    the crops."""
    os.makedirs(save_dir, exist_ok=True)
    vids = sorted(os.listdir(face_dir))
    done = n_frames = 0
    decode = 0.0
    t0 = time.perf_counter()
    for vid in vids:
        save_path = os.path.join(save_dir, f"{vid}.npy")
        if os.path.exists(save_path):
            continue
        paths = resample_frames(sorted(glob.glob(os.path.join(face_dir, vid, "*"))), resample_step)
        t1 = time.perf_counter()
        frames = [load_normalized(p, image_size, mean, std) for p in paths]
        decode += time.perf_counter() - t1
        n_frames += len(frames)
        emb = embed(frames) if frames else np.zeros((0, dim), np.float32)
        save_embeddings(save_path, emb, dim, feature_level)
        done += 1
    seconds = time.perf_counter() - t0
    print(f"extracted {done}/{len(vids)} videos in {seconds:.1f}s")
    return {"videos": done, "frames": n_frames, "seconds": seconds, "decode_seconds": decode,
            "save_dir": save_dir}


def image_runner(model, key: Optional[str], device: torch.device,
                 layout=(0, 3, 1, 2)) -> Callable:
    """A batch of host frames (channels last) -> [B, D] f32 on the host:
    ``model``'s output ``key`` (the whole output where ``key`` is None) on
    the batch in ``layout``."""
    def run(batch: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            out = model(to_device(batch, device, layout))
            return (out if key is None else out[key]).float().cpu().numpy()
    return run


def window_runner(model, cfg, device: torch.device, batch_size: int) -> Callable:
    """A video's frames -> [n_windows, D]: windows of ``num_frames``, the tail
    repeating the last frame, each window's token mean (JAX's
    ``run_windows``), the windows in batches of ``batch_size``."""
    T = cfg.num_frames
    run = image_runner(model, "pooled", device, (0, 1, 4, 2, 3))

    def embed(frames: List[np.ndarray]) -> np.ndarray:
        wins = (frames[s:s + T] for s in range(0, len(frames), T))
        return batched_embed(run, [np.stack(w + [w[-1]] * (T - len(w))) for w in wins], batch_size)
    return embed


def make_embed(name: str, model, cfg, key: Optional[str], device: torch.device,
               batch_size: int) -> Callable:
    """A video's normalised frames -> its rows, for the encoder of ``--model
    name``: VideoMAE's windows, or frame batches of ``batch_size``."""
    if name == "videomae":
        return window_runner(model, cfg, device, batch_size)
    run = image_runner(model, key, device)
    return lambda frames: batched_embed(run, frames, batch_size)


def build_encoder(name: str, model_dir: Optional[str], checkpoint: Optional[str],
                  device: torch.device):
    """(model in eval mode on ``device``, its config or None, output key,
    image size, mean, std, embedding width) for ``--model name``."""
    if name == "imagenet":
        from sdumc_tpu_torch.convert.torch_resnet import load_resnet
        from sdumc_tpu_torch.models.manet import init_weights
        from sdumc_tpu_torch.models.resnet import ResNetEmbedding

        if checkpoint:
            model, _ = load_resnet(checkpoint, device)
        else:
            print("no --checkpoint: ImageNet ResNet-18 with seeded weights (ResNet's init, "
                  "seed 0), not trained ones")
            model = init_weights(ResNetEmbedding(), 0).to(device).eval()
        return model, None, None, 224, IMAGENET_MEAN, IMAGENET_STD, model.cfg.channels[-1]
    if not model_dir:
        raise ValueError(f"--model_dir is required for --model {name}")
    if name == "clip":
        from sdumc_tpu_torch.convert.hf_clip import load_hf_clip_vision as load
        key, mean, std = "image_features", CLIP_MEAN, CLIP_STD
    elif name == "dinov2":
        from sdumc_tpu_torch.convert.hf_dinov2 import load_hf_dinov2 as load
        key, mean, std = "pooled", IMAGENET_MEAN, IMAGENET_STD
    elif name == "eva02":
        from sdumc_tpu_torch.convert.timm_eva02 import load_timm_eva02 as load
        key, mean, std = "pooled", IMAGENET_MEAN, IMAGENET_STD
    elif name == "videomae":
        from sdumc_tpu_torch.convert.hf_videomae import load_hf_videomae as load
        key, mean, std = "pooled", IMAGENET_MEAN, IMAGENET_STD
    else:
        raise ValueError(f"unknown --model {name!r}")
    cfg, model = load(model_dir)
    dim = cfg.projection_dim if name == "clip" else cfg.hidden_size
    return model.to(device), cfg, key, cfg.image_size, mean, std, dim


def main(argv=None) -> dict:
    """Parse the flags, load the encoder, embed every video of ``face_dir``
    to ``save_dir/{vid}.npy``. Returns extract_dir's counts and seconds,
    with the embedding width."""
    from sdumc_tpu_torch.cli.common import resolve_device, set_matmul_precision

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", type=str, default="clip", choices=MODELS)
    parser.add_argument("--model_dir", type=str, default=None,
                        help="HF-format directory (clip, dinov2, videomae) or timm's (eva02)")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="torchvision resnet18 state dict (imagenet)")
    parser.add_argument("--face_dir", type=str, required=True)
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--feature_level", type=str, default="FRAME")
    parser.add_argument("--resample_step", type=int, default=5)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (the default) raises when no card is present")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    set_matmul_precision("highest")
    model, cfg, key, size, mean, std, dim = build_encoder(args.model, args.model_dir,
                                                          args.checkpoint, device)
    embed = make_embed(args.model, model, cfg, key, device, args.batch_size)
    out = extract_dir(embed, args.face_dir, args.save_dir, image_size=size, mean=mean, std=std,
                      dim=dim, feature_level=args.feature_level,
                      resample_step=args.resample_step)
    return {**out, "dim": dim}
