"""Visual features: face crops -> MANet [T, 1024] embeddings, the video
stream of both views (``DataConfig.video_feature = "manet_FRA"``).

The port of ``sdumc_tpu/extract/visual.py``. Reference
(feature_extraction/visual/extract_manet_embedding.py): per video, the
OpenFace face crops sorted by file name, resized to 224x224, ToTensor (0..1,
no normalisation), batched through MANet with ``return_embedding=True``;
FRAME saves [T, 1024], UTTERANCE the mean over frames.

Each video is batched on its own, as JAX's code does (its docstring says
frames are pooled across videos; the loop does not); the last chunk runs
at its true size, since BatchNorm in eval mode is per sample. The crops are
read and resized by ``extract/image_io.py`` (no Pillow), equal to the bit
to JAX's PIL path. Convolutions run in f32 with TF32 off.

    python -m sdumc_tpu_torch.cli.extract visual --checkpoint MANET.pth \\
        --face_dir FACES --save_dir OUT [--device cpu]   # OUT/manet_FRA/{vid}.npy
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import List

import numpy as np
import torch

from sdumc_tpu_torch.extract.image_io import load_face

EMBED_DIM = 1024


def extract_video_embeddings(model, frames: List[np.ndarray], batch_size: int = 32) -> np.ndarray:
    """frames: [224, 224, 3] arrays -> [T, 1024] f32, on the device the
    model's weights are on."""
    dev = model.conv1.weight.device
    out = []
    with torch.inference_mode():
        for s in range(0, len(frames), batch_size):
            batch = torch.from_numpy(np.stack(frames[s:s + batch_size])).to(dev)
            out.append(model(batch.permute(0, 3, 1, 2).contiguous()).float().cpu().numpy())
    return np.concatenate(out, axis=0)


def sample_frame_paths(video_dir: str, policy: str = "all", n: int = 16) -> List[str]:
    """Frame-sampling policies (reference toolkit/utils/functions.py): 'all'
    keeps every frame; 'uniform' picks n evenly spaced; 'head' / 'center'
    take the first / middle n; name-sorted like the reference."""
    paths = sorted(glob.glob(os.path.join(video_dir, "*")))
    if policy == "all" or len(paths) <= n:
        return paths
    if policy == "uniform":
        idx = np.linspace(0, len(paths) - 1, n).round().astype(int)
        return [paths[i] for i in idx]
    if policy == "head":
        return paths[:n]
    if policy == "center":
        s = max((len(paths) - n) // 2, 0)
        return paths[s:s + n]
    raise ValueError(policy)


def main(argv=None) -> dict:
    """Parse the flags, load the checkpoint, embed every video of
    ``face_dir`` to ``save_dir/manet_{LEVEL[:3]}/{vid}.npy``. Returns the
    counts, the host-clock seconds and, apart, the seconds spent reading
    and resizing the crops."""
    from sdumc_tpu_torch.cli.common import resolve_device, set_matmul_precision
    from sdumc_tpu_torch.convert.torch_manet import load_manet

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="torch MANet checkpoint (.pth)")
    parser.add_argument("--face_dir", type=str, required=True)
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--feature_level", type=str, default="FRAME",
                        choices=["FRAME", "UTTERANCE"])
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (the default) raises when no card is present")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    set_matmul_precision("highest")
    model, _ = load_manet(args.checkpoint, device=device)
    save_dir = os.path.join(args.save_dir, f"manet_{args.feature_level[:3]}")
    os.makedirs(save_dir, exist_ok=True)
    vids = sorted(os.listdir(args.face_dir))
    print(f'Find total "{len(vids)}" videos.')
    t0 = time.perf_counter()
    decode, n_frames = 0.0, 0
    for i, vid in enumerate(vids, 1):
        paths = sample_frame_paths(os.path.join(args.face_dir, vid))
        if not paths:
            feat = np.zeros((1, EMBED_DIM), np.float32)
        else:
            t1 = time.perf_counter()
            frames = [load_face(p) for p in paths]
            decode += time.perf_counter() - t1
            n_frames += len(frames)
            feat = extract_video_embeddings(model, frames, args.batch_size)
        if args.feature_level == "UTTERANCE":
            feat = feat.mean(axis=0)
        np.save(os.path.join(save_dir, f"{vid}.npy"), feat.astype(np.float32))
        if i % 50 == 0:
            print(f"{i}/{len(vids)}")
    seconds = time.perf_counter() - t0
    print(f"Total time used: {seconds:.1f}s.")
    return {"videos": len(vids), "frames": n_frames, "seconds": seconds,
            "decode_seconds": decode, "save_dir": save_dir}
