"""CMU-MOSI raw-dataset preprocessing (reference toolkit/preprocess/cmumosi.py).

The MOSI pkl ships pre-segmented clips, so unlike MOSEI there is no ffmpeg
split stage: the pipeline is pkl labels -> train/val/test name/label lists
(:32-42) -> transcription csv (:9-29) -> label npz + per-clip video copies
(:45-87). The reference's csv also carries a Chinese translation produced by
a ChatGPT helper (toolkit/utils/chatgpt.py — absent from the snapshot); the
rebuild makes translation an injectable callable and defaults to passthrough.
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Callable, Dict, List, Optional, Tuple

from sdumc_tpu_torch.data.labels import write_label_npz
from sdumc_tpu_torch.utils.files import write_key_csv


def read_mosi_pkl(label_path: str):
    """The 7-tuple layout of CMUMOSI_features_raw_2way.pkl (reference :13,
    :35): (videoIDs, videoLabels, _, videoSentences, trainVids, valVids,
    testVids)."""
    with open(label_path, "rb") as f:
        blob = pickle.load(f, encoding="latin1")
    video_ids, video_labels, _, video_sentences, train_v, val_v, test_v = blob
    return video_ids, video_labels, video_sentences, train_v, val_v, test_v


def read_train_val_test(label_path: str, data_type: str) -> Tuple[List[str], List[float]]:
    """Flatten per-video clip names + labels for one split (reference :32-42)."""
    assert data_type in ("train", "val", "test"), data_type
    video_ids, video_labels, _, train_v, val_v, test_v = read_mosi_pkl(label_path)
    vids = {"train": train_v, "val": val_v, "test": test_v}[data_type]
    names: List[str] = []
    labels: List[float] = []
    for vid in vids:
        names.extend(video_ids[vid])
        labels.extend(video_labels[vid])
    return names, labels


def generate_transcription(
    label_path: str,
    save_path: str,
    translate: Optional[Callable[[str], str]] = None,
) -> int:
    """pkl sentences -> csv with (chinese, english) columns (reference
    :9-29). ``translate`` replaces the chatgpt eng2chi helper; None writes
    an empty chinese column (the MOSEI path never reads it)."""
    video_ids, _, video_sentences, *_ = read_mosi_pkl(label_path)
    names: List[str] = []
    sentences: List[str] = []
    for vid in video_ids:
        names.extend(video_ids[vid])
        sentences.extend(video_sentences[vid])
    name2row = {
        n: [translate(s) if translate else "", s]
        for n, s in zip(names, sentences)
    }
    write_key_csv(save_path, names, name2row, ["chinese", "english"])
    return len(names)


def normalize_dataset_format(
    data_root: str,
    save_root: str,
    copy_videos: bool = True,
    translate: Optional[Callable[[str], str]] = None,
) -> Dict[str, int]:
    """pkl -> label.npz ({'emo': 0, 'val': sentiment} per clip) +
    transcription.csv + per-clip video copies (reference :45-87)."""
    label_path = os.path.join(save_root, "CMUMOSI_features_raw_2way.pkl")
    assert os.path.exists(label_path), "must have a pre-processed label file"
    video_root = os.path.join(data_root, "Video", "Segmented")

    os.makedirs(save_root, exist_ok=True)
    save_video = os.path.join(save_root, "subvideo")
    if copy_videos:
        os.makedirs(save_video, exist_ok=True)

    generate_transcription(
        label_path, os.path.join(save_root, "transcription.csv"), translate
    )

    corpora: Dict[str, Dict[str, dict]] = {}
    counts: Dict[str, int] = {}
    for split in ("train", "val", "test"):
        names, labels = read_train_val_test(label_path, split)
        corpora[split] = {
            name: {"emo": 0, "val": labels[i]} for i, name in enumerate(names)
        }
        counts[split] = len(names)
        if copy_videos:
            for name in names:
                src = os.path.join(video_root, name + ".mp4")
                dst = os.path.join(save_video, name + ".mp4")
                if os.path.exists(src):
                    shutil.copy(src, dst)

    write_label_npz(
        os.path.join(save_root, "label.npz"),
        corpora["train"], corpora["val"], corpora["test"],
    )
    return counts
