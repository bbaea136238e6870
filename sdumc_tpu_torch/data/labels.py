"""CMU-MOSEI label reading.

On-disk contract: one ``.npz`` with ``train_corpus/val_corpus/test_corpus``
pickled dicts of ``name -> {'emo': float, 'val': float}``. The reference
deletes its 51 longest train clips because its unbucketed batch-max padding
cannot afford them; that exclusion is kept as a switch for recipe parity.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

TOO_LONG_TRAIN_CLIPS = frozenset({
    "125344_0", "SqAiJrvHXNA_0", "30162_9", "96361_16", "6-0bcijTR8k_0",
    "254427_0", "PEBwwe0PLZ8_0", "JGEEA_JVriE_0", "skRqBxLLJkE_0",
    "d-Uw_uZyUys_1", "jjbOD6u7V34_16", "IRSxo_XXArg_11", "aNOuoSVlunM_5",
    "veHYwR7ge6Y_0", "9K5mYSaoBL4_2", "d-Uw_uZyUys_2", "139006_5",
    "245243_1", "4Vl6AeEkAg4_1", "mHEtr7PHxoA_0", "70710_2", "fsBzpr4k3rY_0",
    "wI7DDCRh4Nw_1", "69707_3", "4oeKDFIaL7o_4", "y3r2kk8zvl0_3",
    "6UV6ktwbLoo_0", "HR18U0yAlTc_5", "MFrwi-RibUk_3", "83310_2", "69707_4",
    "112425_10", "vttEPA6Xffk_1", "gLTxaEcx41E_3", "8XODJwsvBa0_2",
    "130149_5", "NuRvTWhELqs_5", "GSnt_fW8qjI_4", "dQ56b0bqmc8_3",
    "xkEK17UUyi4_0", "193291_0", "slLRsFFiiRc_5", "dQ56b0bqmc8_0",
    "275248_0", "cX8FScpsfLE_0", "243646_10", "SqAiJrvHXNA_6", "264418_7",
    "AggyS1coOb8_1", "XXvSLz8QmGk_11", "XaVYxIW0FDg_2",
})


def read_names_labels(
    label_path: str,
    split: str,
    *,
    debug: bool = False,
    drop_too_long: bool = False,
) -> Tuple[List[str], List[Dict[str, float]]]:
    """Read one split's (names, labels) from the label npz, with the
    train-split exclusion and the --debug truncation to 100 clips."""
    if split not in ("train", "val", "test"):
        raise ValueError(f"unknown split {split!r}")
    corpus = np.load(label_path, allow_pickle=True)[f"{split}_corpus"].tolist()
    names, labels = [], []
    for name in corpus:
        names.append(name)
        labels.append(corpus[name])
    if split == "train" and drop_too_long:
        keep = [i for i, n in enumerate(names) if n not in TOO_LONG_TRAIN_CLIPS]
        names = [names[i] for i in keep]
        labels = [labels[i] for i in keep]
    if debug:
        names, labels = names[:100], labels[:100]
    return names, labels


def write_label_npz(path: str, train: dict, val: dict, test: dict) -> None:
    """The label npz that ``read_names_labels`` reads: each split's
    ``name -> {'emo', 'val'}`` dict pickled as a 0-d object array,
    compressed."""
    np.savez_compressed(
        path,
        train_corpus=np.array(train, dtype=object),
        val_corpus=np.array(val, dtype=object),
        test_corpus=np.array(test, dtype=object),
    )
