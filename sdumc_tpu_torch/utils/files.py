"""File IO helpers (reference toolkit/utils/read_files.py equivalents):
key->columns csv read/write, label-studio style json export reading, and
simple name-list IO used across preprocessing and extraction stages."""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Sequence, Tuple


def write_key_csv(path: str, names: Sequence[str], name2row: Dict[str, list],
                  columns: Sequence[str]) -> None:
    """reference func_write_key_to_csv: one row per name, 'name' first."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(["name", *columns])
        for n in names:
            writer.writerow([n, *name2row[n]])


def read_key_csv(path: str, column: str) -> Tuple[List[str], Dict[str, str]]:
    """reference func_read_key_from_csv: returns (names, name->value)."""
    names, mapping = [], {}
    with open(path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            name = row["name"]
            names.append(name)
            mapping[name] = row.get(column, "")
    return names, mapping


def read_labelstudio_export(path: str) -> Dict[str, str]:
    """Label-studio JSON export -> {clip_name: choice} (read_files.py:9-60
    style; tolerant of the two common export shapes)."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    out: Dict[str, str] = {}
    for item in data:
        src = item.get("data", {})
        name = os.path.basename(
            src.get("audio") or src.get("video") or src.get("image") or ""
        ).split(".")[0]
        for ann in item.get("annotations", item.get("completions", [])):
            for res in ann.get("result", []):
                choices = res.get("value", {}).get("choices")
                if choices:
                    out[name] = choices[0]
    return out


def read_names(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]


def labelstudio_init_tasks(keyname: str, names: Sequence[str],
                           values: Sequence[Sequence[str]],
                           uri_template: str = "{name}.webm") -> List[dict]:
    """Build a label-studio task list (reference func_labelstudio_init_key,
    read_files.py:9-32): one task per clip, ragged per-clip values padded
    with '' to the max count, empty annotations/predictions. The media URI
    prefix is a template instead of the reference's hardcoded s3 bucket."""
    max_len = max((len(v) for v in values), default=0)
    tasks = []
    for i, name in enumerate(names):
        data = {"video": uri_template.format(name=name)}
        for j in range(max_len):
            data[f"{keyname}{j}"] = values[i][j] if j < len(values[i]) else ""
        tasks.append({"id": i, "data": data,
                      "annotations": [], "predictions": []})
    return tasks


def labelstudio_update_key(json_path: str, val_name: str,
                           name2val: Dict[str, str]) -> None:
    """Add a data key to every task of an existing export
    (func_labelstudio_update_key, read_files.py:35-46)."""
    with open(json_path, encoding="utf-8") as f:
        data = json.load(f)
    for item in data:
        name = os.path.basename(item["data"]["video"]).rsplit(".", 1)[0]
        item["data"][val_name] = name2val[name]
    with open(json_path, "w") as f:
        json.dump(data, f)


def split_json_tasks(json_path: str, store_root: str, split_num: int = 8,
                     shuffle: bool = True, seed: int = 0) -> List[str]:
    """Split one task json into per-annotator shards
    (func_labelstudio_split_json, read_files.py:49-65); seeded shuffle
    replaces the reference's unseeded random."""
    import math

    import numpy as np

    os.makedirs(store_root, exist_ok=True)
    with open(json_path, encoding="utf-8") as f:
        data = json.load(f)
    if shuffle:
        order = np.random.default_rng(seed).permutation(len(data))
        data = [data[i] for i in order]
    per = math.ceil(len(data) / split_num)
    paths = []
    for i in range(split_num):
        path = os.path.join(store_root, f"split-{i}.json")
        with open(path, "w") as f:
            json.dump(data[i * per:(i + 1) * per], f)
        paths.append(path)
    return paths


def read_labelstudio_values(path: str) -> Dict[str, List[str]]:
    """Full annotation reader (func_labelstudio_read_key,
    read_files.py:84-134): handles the 'uuid-name' prefixed filenames and
    collects choices AND free-text results per clip as a list."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    out: Dict[str, List[str]] = {}
    for item in data:
        name = os.path.basename(item["data"]["video"]).rsplit(".", 1)[0]
        name = name.split("-", 1)[-1]
        values: List[str] = []
        anns = item.get("annotations", [])
        if len(anns) == 1:
            for res in anns[0].get("result", []):
                val = res.get("value", {})
                entry = val.get("choices") or val.get("text")
                if entry:
                    assert len(entry) == 1, f"{name}: multi-value result"
                    values.append(entry[0].strip())
        out[name] = values
    return out
