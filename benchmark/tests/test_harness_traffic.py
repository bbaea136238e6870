"""The traffic is a pure function of the seed, and every seed gets the same
sizes in another order."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.lib import seeds, traffic
from benchmark.lib import spec

BIG = 2 ** 31 + 12345


def _train_params():
    return spec.cell("fusion-train-mosei")["traffic_params"]


def test_fusion_clips_repeat_for_a_seed_and_keep_their_sizes():
    p = _train_params()
    a = traffic.fusion_clips(p, BIG, 3072)
    b = traffic.fusion_clips(p, BIG, 3072)
    c = traffic.fusion_clips(p, BIG + 1, 3072)
    for m in traffic.MODALITIES:
        assert np.array_equal(a["lengths"][m], b["lengths"][m])
        assert np.array_equal(a["starts"][m], b["starts"][m])
        assert not np.array_equal(a["lengths"][m], c["lengths"][m])
        assert np.array_equal(np.sort(a["lengths"][m]), np.sort(c["lengths"][m]))
        lo, hi = p["lengths"][m]
        assert a["lengths"][m].min() >= lo and a["lengths"][m].max() <= hi
        assert np.all(a["starts"][m] + a["lengths"][m] <= a["pool_frames"][m])
    assert np.array_equal(np.sort(a["vals"]), np.sort(c["vals"]))


def test_store_bytes_repeat_for_a_seed(tmp_path):
    p = dict(_train_params(), pool_clips=2,
             lengths={"audio": [2, 5], "text": [1, 3], "video": [2, 4], "feat4": [1, 2]})
    clips = traffic.fusion_clips(p, BIG, 8)
    dims = {"audio": 4, "text": 6, "video": 3, "feat4": 6}
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a = traffic.write_store(str(tmp_path / "a"), dims, clips, BIG, torch.device("cpu"))
    b = traffic.write_store(str(tmp_path / "b"), dims, clips, BIG, torch.device("cpu"))
    for m in traffic.MODALITIES:
        assert np.array_equal(np.asarray(a[m][0]), np.asarray(b[m][0]))
        assert a[m][1] == b[m][1]


def test_wave_requests_repeat_and_keep_their_durations():
    p = spec.cell("wavlm-extract-mosei")["traffic_params"]
    a = traffic.wave_requests(p, seeds.derive(BIG, "r", 0), 1)[0]
    b = traffic.wave_requests(p, seeds.derive(BIG, "r", 0), 1)[0]
    c = traffic.wave_requests(p, seeds.derive(BIG, "r", 1), 1)[0]
    assert a == b and a != c
    assert sorted(n for _, n in a) == sorted(n for _, n in c)
    rate = p["sample_rate"]
    assert all(p["seconds"][0] * rate <= n <= p["seconds"][1] * rate for _, n in a)


def test_derived_seeds_take_large_seeds():
    assert seeds.derive(2 ** 40, "x") != seeds.derive(2 ** 40 + 1, "x")
    assert 0 <= seeds.derive(2 ** 40, "x") < 2 ** 63
