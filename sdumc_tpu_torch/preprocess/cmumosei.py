"""CMU-MOSEI raw-dataset preprocessing (reference toolkit/preprocess/cmumosei.py).

Stages (all host-side; ffmpeg stays an external binary by design —
SURVEY §2.1):

1. split_video_by_segments: long video + segment transcript -> per-clip mp4
   via ffmpeg -ss/-to (reference :21-50), parallelized with a process pool
   instead of the reference's sequential os.system loop.
2. generate_transcription: label pkl -> transcription.csv (:71-84).
3. normalize_dataset_format: pkl labels -> train/val/test splits -> label
   npz with {'emo': 0, 'val': sentiment} dicts (:100-142).
"""

from __future__ import annotations

import concurrent.futures as futures
import glob
import os
import pickle
import shutil
import subprocess
from typing import List, Tuple

from sdumc_tpu_torch.data.labels import write_label_npz
from sdumc_tpu_torch.utils.files import write_key_csv

FFMPEG = os.environ.get("SDUMC_FFMPEG", shutil.which("ffmpeg") or "ffmpeg")


def ms_to_timestamp(t_ms: float) -> str:
    """reference convert_time: milliseconds -> HH:MM:SS.mmm."""
    ms = int(t_ms % 1000)
    t = int(t_ms // 1000)
    h, rem = divmod(t, 3600)
    m, s = divmod(rem, 60)
    return f"{h:02d}:{m:02d}:{s:02d}.{ms:03d}"


def _clip_cmd(video_path: str, start_s: float, end_s: float, out_path: str) -> List[str]:
    return [
        FFMPEG, "-nostats", "-loglevel", "0",
        "-ss", ms_to_timestamp(start_s * 1000),
        "-to", ms_to_timestamp(end_s * 1000),
        "-accurate_seek", "-i", video_path,
        "-vcodec", "copy", "-acodec", "copy", out_path, "-y",
    ]


def split_video_by_segments(data_root: str, save_root: str, workers: int = 8) -> int:
    """Segment transcripts: '{vid}___{seg}___{start}___{end}___{sentence}'
    lines per video (reference :30-50)."""
    trans_root = os.path.join(data_root, "Transcript/Segmented/Combined")
    video_root = os.path.join(data_root, "Videos/Full/Combined")
    os.makedirs(save_root, exist_ok=True)

    jobs = []
    for video_path in sorted(glob.glob(os.path.join(video_root, "*"))):
        video_name = os.path.basename(video_path).rsplit(".", 1)[0]
        trans_path = os.path.join(trans_root, video_name + ".txt")
        if not os.path.exists(trans_path):
            continue
        with open(trans_path, encoding="utf8") as f:
            lines = [l.strip() for l in f if l.strip()]
        for line in lines:
            name1, name2, start, end, _sentence = line.split("___", 4)
            out = os.path.join(save_root, f"{name1}_{name2}.mp4")
            if os.path.exists(out):
                continue
            jobs.append(_clip_cmd(video_path, float(start), float(end), out))

    def run(cmd):
        subprocess.run(cmd, check=False, capture_output=True)

    with futures.ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(run, jobs))
    return len(jobs)


def _load_label_pkl(label_path: str):
    with open(label_path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def generate_transcription(label_path: str, save_path: str) -> None:
    """pkl -> transcription.csv with an 'english' column (reference :71-84)."""
    videoIDs, _, _, videoSentences, _, _, _ = _load_label_pkl(label_path)
    names, sentences = [], []
    for vid in videoIDs:
        names.extend(videoIDs[vid])
        sentences.extend(videoSentences[vid])
    write_key_csv(save_path, names, {n: [s] for n, s in zip(names, sentences)},
                  ["english"])


def read_split(label_path: str, split: str) -> Tuple[List[str], List[float]]:
    """reference read_train_val_test (:87-97)."""
    assert split in ("train", "val", "test")
    videoIDs, videoLabels, _, _, trainVids, valVids, testVids = _load_label_pkl(label_path)
    vids = {"train": trainVids, "val": valVids, "test": testVids}[split]
    names, labels = [], []
    for vid in vids:
        names.extend(videoIDs[vid])
        labels.extend(videoLabels[vid])
    return names, labels


def normalize_dataset_format(label_path: str, npz_path: str) -> None:
    """pkl -> label npz with train/val/test corpora of
    name -> {'emo': 0, 'val': sentiment} (reference :100-142: emo is a
    stub; valence is the sentiment score)."""
    corpora = {}
    for split in ("train", "val", "test"):
        names, labels = read_split(label_path, split)
        corpora[split] = {
            n: {"emo": 0, "val": float(v)} for n, v in zip(names, labels)
        }
    write_label_npz(npz_path, corpora["train"], corpora["val"], corpora["test"])
