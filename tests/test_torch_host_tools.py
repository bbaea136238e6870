"""The port's host tools against their JAX-package originals, on the CPU.

Each function runs on the same inputs on both sides (those of
``tests/test_utils.py`` and ``tests/test_metrics.py``, plus the edge cases
each function branches on): the csv, json and wav files they write are
equal byte for byte, the label npz files hold equal arrays, and every
returned value is equal. ffmpeg is a stub script named by the modules'
``FFMPEG`` (it records its arguments in the file it is asked to write), or
a path that does not exist, where the media jobs fail and are reported.
Nothing here reads a reference checkout.
"""

import json
import os
import pickle
import sys
import wave

import numpy as np
import pytest

import sdumc_tpu.core.metrics as jax_metrics
import sdumc_tpu.data.feature_store as jax_store
import sdumc_tpu.data.labels as jax_labels
import sdumc_tpu.preprocess.cmumosei as jax_mosei
import sdumc_tpu.preprocess.cmumosi as jax_mosi
import sdumc_tpu.preprocess.media as jax_media
import sdumc_tpu.utils.files as jax_files
import sdumc_tpu.utils.noise as jax_noise
import sdumc_tpu_torch.core.metrics as metrics
import sdumc_tpu_torch.data.feature_store as store
import sdumc_tpu_torch.data.labels as labels
import sdumc_tpu_torch.preprocess.cmumosei as mosei
import sdumc_tpu_torch.preprocess.cmumosi as mosi
import sdumc_tpu_torch.preprocess.media as media
import sdumc_tpu_torch.utils.files as files
import sdumc_tpu_torch.utils.noise as noise

SIDES = (("jax", jax_noise, jax_files), ("port", noise, files))


def _write_wav(path, data_i16, framerate=16000):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(framerate)
        f.writeframes(np.asarray(data_i16, "<i2").tobytes())


def _tree_bytes(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _npz_equal(a, b):
    za, zb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, k
        assert za[k].tolist() == zb[k].tolist(), k


# ---------------------------------------------------------------- noise

# (clip amplitudes, SNRs): test_utils.py's one clip at 10 dB; three clips at
# a mix of SNRs, one short noise file that must loop; loud clips at -10 dB,
# which take the int16 clip-guard
NOISE_CASES = {
    "one_snr": ((3000,), (10.0,), 48000),
    "snr_mix": ((3000, 1000, 8000), (0.0, 5.0, 10.0), 9000),
    "clip_guard": ((20000, 25000), (-10.0,), 48000),
}


@pytest.mark.parametrize("case", sorted(NOISE_CASES))
def test_add_noise_dir_writes_the_same_wavs(tmp_path, case):
    amps, snrs, noise_len = NOISE_CASES[case]
    rng = np.random.default_rng(0)
    clips = [np.clip(rng.normal(size=16000 + 4000 * i) * a, -32768, 32767).astype(np.int16)
             for i, a in enumerate(amps)]
    noises = [(rng.normal(size=noise_len) * 3000).astype(np.int16),
              (rng.normal(size=noise_len // 2) * 2000).astype(np.int16)]
    got = {}
    for side, mod, _ in SIDES:
        root = tmp_path / side
        (root / "audio").mkdir(parents=True)
        (root / "noise").mkdir()
        for i, c in enumerate(clips):
            _write_wav(root / "audio" / f"c{i}.wav", c)
        for i, n in enumerate(noises):
            _write_wav(root / "noise" / f"n{i}.wav", n)
        out = mod.add_noise_dir(str(root / "audio"), str(root / "noise"), list(snrs),
                                workers=2, seed=3)
        got[side] = (os.path.relpath(out, root), _tree_bytes(out))
    assert got["port"] == got["jax"]
    assert len(got["port"][1]) == len(clips)
    if case == "clip_guard":     # the guard scaled a mix back into int16's range
        peak = max(np.abs(np.frombuffer(b[44:], "<i2")).max() for b in got["port"][1].values())
        assert peak >= 32767


def test_noise_helpers_match(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.normal(size=1000) * 500
    assert noise.rms(x) == jax_noise.rms(x)
    assert noise.adjusted_noise_rms(123.4, 7.5) == jax_noise.adjusted_noise_rms(123.4, 7.5)
    _write_wav(tmp_path / "a.wav", x.astype(np.int16), framerate=8000)
    a, pa = noise.read_pcm16(str(tmp_path / "a.wav"))
    b, pb = jax_noise.read_pcm16(str(tmp_path / "a.wav"))
    np.testing.assert_array_equal(a, b)
    assert pa == pb
    noise.write_pcm16(str(tmp_path / "p.wav"), pa, a * 0.5)
    jax_noise.write_pcm16(str(tmp_path / "j.wav"), pb, b * 0.5)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


# ---------------------------------------------------------------- files

def test_key_csv_roundtrip_matches(tmp_path):
    names = ["a", "b", "c,d"]
    rows = {"a": ["hi", "1"], "b": ["yo", ""], "c,d": ['say "x"', "3"]}
    for side, _, mod in SIDES:
        mod.write_key_csv(tmp_path / f"{side}.csv", names, rows, ["english", "n"])
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    for column in ("english", "n", "missing"):
        assert (files.read_key_csv(tmp_path / "port.csv", column)
                == jax_files.read_key_csv(tmp_path / "jax.csv", column))


def _tasks(mod):
    tasks = mod.labelstudio_init_tasks(
        "sent", ["clip_a", "clip_b", "clip_c"], [["hello", "there"], ["hi"], []])
    tasks[0]["annotations"] = [{"result": [
        {"value": {"choices": ["positive"]}},
        {"value": {"text": [" great "]}},
    ]}]
    return tasks


def test_labelstudio_tools_match(tmp_path):
    """Task init -> update -> split -> read, test_utils.py's sequence, on
    each side's own files."""
    assert _tasks(files) == _tasks(jax_files)
    assert (files.labelstudio_init_tasks("k", ["x"], [["v"]], uri_template="s3://b/{name}.mp4")
            == jax_files.labelstudio_init_tasks("k", ["x"], [["v"]],
                                                uri_template="s3://b/{name}.mp4"))
    got = {}
    for side, _, mod in SIDES:
        root = tmp_path / side
        root.mkdir()
        path = root / "tasks.json"
        path.write_text(json.dumps(_tasks(mod)))
        mod.labelstudio_update_key(str(path), "val",
                                   {"clip_a": "1.5", "clip_b": "-1", "clip_c": "0"})
        values = mod.read_labelstudio_values(str(path))
        paths = mod.split_json_tasks(str(path), str(root / "splits"), split_num=2, seed=5)
        unshuffled = mod.split_json_tasks(str(path), str(root / "plain"), split_num=3,
                                          shuffle=False)
        pref = root / "pref.json"
        pref.write_text(json.dumps([{"data": {"video": "x/def5d5b7-clip_c.webm"},
                                     "annotations": []}]))
        got[side] = (path.read_bytes(), values, [os.path.relpath(p, root) for p in paths],
                     [os.path.relpath(p, root) for p in unshuffled],
                     _tree_bytes(root / "splits"), _tree_bytes(root / "plain"),
                     mod.read_labelstudio_values(str(pref)))
    assert got["port"] == got["jax"]
    assert got["port"][1]["clip_a"] == ["positive", "great"]


def test_labelstudio_export_and_names_match(tmp_path):
    export = [
        {"data": {"audio": "s3://x/clip_1.wav"},
         "annotations": [{"result": [{"value": {"choices": ["neg", "pos"]}}]}]},
        {"data": {"video": "clip_2.mp4"}, "completions": [{"result": [{"value": {}}]}]},
        {"data": {"image": "dir/clip_3.png"},
         "completions": [{"result": [{"value": {"choices": ["neu"]}}]}]},
        {"data": {}, "annotations": []},
    ]
    path = tmp_path / "export.json"
    path.write_text(json.dumps(export))
    assert files.read_labelstudio_export(str(path)) == jax_files.read_labelstudio_export(str(path))
    names = tmp_path / "names.txt"
    names.write_text("a\n\n  b  \nc\n")
    assert files.read_names(str(names)) == jax_files.read_names(str(names)) == ["a", "b", "c"]


# ---------------------------------------------------------------- labels, feature store

def test_write_label_npz_matches_and_reads_back(tmp_path):
    train = {"vidA_0": {"emo": 0, "val": 1.5}, "vidA_1": {"emo": 0, "val": -0.5}}
    val = {}
    test = {"vidB_0": {"emo": 1.0, "val": 2.0}}
    labels.write_label_npz(tmp_path / "port.npz", train, val, test)
    jax_labels.write_label_npz(tmp_path / "jax.npz", train, val, test)
    _npz_equal(tmp_path / "port.npz", tmp_path / "jax.npz")
    for split in ("train", "val", "test"):
        assert (labels.read_names_labels(str(tmp_path / "port.npz"), split)
                == jax_labels.read_names_labels(str(tmp_path / "jax.npz"), split))


def test_check_feature_completeness_matches(tmp_path):
    """Good clips, an empty one, one with a NaN, one with an inf, a missing
    file and an unreadable one, through each side's NpyDirSource; and the
    synthetic source, which has every clip."""
    d = tmp_path / "feat"
    d.mkdir()
    rng = np.random.default_rng(0)
    np.save(d / "good.npy", rng.normal(size=(5, 4)).astype(np.float32))
    np.save(d / "utt.npy", rng.normal(size=(4,)).astype(np.float32))
    np.save(d / "empty.npy", np.zeros((0, 4), np.float32))
    nan = rng.normal(size=(3, 4))
    nan[1, 2] = np.nan
    np.save(d / "nan.npy", nan)
    np.save(d / "inf.npy", np.full((2, 4), np.inf))
    (d / "junk.npy").write_bytes(b"not an npy")
    names = ["good", "utt", "empty", "nan", "inf", "missing", "junk"]
    got = store.check_feature_completeness(store.NpyDirSource(str(tmp_path), "feat"), names)
    ref = jax_store.check_feature_completeness(jax_store.NpyDirSource(str(tmp_path), "feat"),
                                               names)
    assert got == ref == ["empty", "nan", "inf", "missing", "junk"]
    synthetic = store.SyntheticSource("audio", 8, min_len=2, max_len=5)
    assert store.check_feature_completeness(synthetic, names) == []


# ---------------------------------------------------------------- preprocess

def _mosei_pkl(path):
    videoIDs = {"vidA": ["vidA_0", "vidA_1"], "vidB": ["vidB_0"], "vidC": ["vidC_0"]}
    videoLabels = {"vidA": [1.5, -0.5], "vidB": [2.0], "vidC": [0.0]}
    videoSentences = {"vidA": ["hello there", "again, \"quoted\""], "vidB": ["bye"],
                      "vidC": ["é ü"]}
    blob = (videoIDs, videoLabels, None, videoSentences, ["vidA", "vidC"], ["vidB"], ["vidA"])
    with open(path, "wb") as f:
        pickle.dump(blob, f)


def test_cmumosei_label_and_transcription_match(tmp_path):
    pkl = tmp_path / "labels.pkl"
    _mosei_pkl(pkl)
    for side, mod in (("jax", jax_mosei), ("port", mosei)):
        mod.normalize_dataset_format(str(pkl), str(tmp_path / f"{side}.npz"))
        mod.generate_transcription(str(pkl), str(tmp_path / f"{side}.csv"))
    _npz_equal(tmp_path / "port.npz", tmp_path / "jax.npz")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    for split in ("train", "val", "test"):
        assert mosei.read_split(str(pkl), split) == jax_mosei.read_split(str(pkl), split)
    for t in (0, 999, 1000, 59_999.7, 3_723_456, 86_399_999):
        assert mosei.ms_to_timestamp(t) == jax_mosei.ms_to_timestamp(t)
    assert mosei.ms_to_timestamp(3_723_456) == "01:02:03.456"


def _ffmpeg_stub(path):
    """An executable that writes its arguments, without the input and
    output paths, into the output file (the last .mp4 / .wav argument after
    the input)."""
    path.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        "src = args[args.index('-i') + 1]\n"
        "out = [a for a in args if a.endswith(('.mp4', '.wav')) and a != src][-1]\n"
        "open(out, 'w').write(' '.join(a for a in args if a not in (src, out)))\n")
    path.chmod(0o755)
    return str(path)


def _mosei_tree(root):
    trans = root / "Transcript/Segmented/Combined"
    vids = root / "Videos/Full/Combined"
    trans.mkdir(parents=True)
    vids.mkdir(parents=True)
    for v, segs in (("v1", [(0, 1.25, 3.5), (1, 3.5, 3725.004)]), ("v2", [(0, 0.0, 2.0)]),
                    ("v3", [(0, 1.0, 2.0)])):
        (vids / f"{v}.mp4").write_bytes(b"video")
        if v == "v3":      # no transcript: skipped
            continue
        (trans / f"{v}.txt").write_text("".join(
            f"{v}___{i}___{s}___{e}___a sentence ___ with separators\n" for i, s, e in segs))


def test_cmumosei_split_video_by_segments_matches(tmp_path, monkeypatch):
    stub = _ffmpeg_stub(tmp_path / "ffmpeg")
    monkeypatch.setattr(mosei, "FFMPEG", stub)
    monkeypatch.setattr(jax_mosei, "FFMPEG", stub)
    got = {}
    for side, mod in (("jax", jax_mosei), ("port", mosei)):
        root = tmp_path / side
        _mosei_tree(root)
        out = root / "clips"
        n = mod.split_video_by_segments(str(root), str(out), workers=2)
        again = mod.split_video_by_segments(str(root), str(out), workers=2)  # all exist
        got[side] = (n, again, _tree_bytes(out))
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (3, 0)
    written = b" ".join(got["port"][2].values())
    assert b"-ss 00:00:03.500 -to 01:02:05.004" in written


def _mosi_tree(root):
    save = root / "mosi"
    save.mkdir(parents=True)
    blob = ({"vidA": ["vidA_0", "vidA_1"], "vidB": ["vidB_0"]},
            {"vidA": [1.5, -0.5], "vidB": [2.0]}, None,
            {"vidA": ["hello there", "ok bye"], "vidB": ["mosi"]},
            ["vidA"], [], ["vidB"])
    with open(save / "CMUMOSI_features_raw_2way.pkl", "wb") as f:
        pickle.dump(blob, f)
    seg = root / "Video" / "Segmented"
    seg.mkdir(parents=True)
    (seg / "vidA_0.mp4").write_bytes(b"clip A0")
    (seg / "vidB_0.mp4").write_bytes(b"clip B0")       # vidA_1 has no video
    return save


@pytest.mark.parametrize("copy_videos, translate", [(False, str.upper), (True, None)])
def test_cmumosi_preprocess_matches(tmp_path, copy_videos, translate):
    got = {}
    for side, mod in (("jax", jax_mosi), ("port", mosi)):
        root = tmp_path / side
        save = _mosi_tree(root)
        pkl = str(save / "CMUMOSI_features_raw_2way.pkl")
        counts = mod.normalize_dataset_format(str(root), str(save), copy_videos=copy_videos,
                                              translate=translate)
        splits = [mod.read_train_val_test(pkl, s) for s in ("train", "val", "test")]
        n = mod.generate_transcription(pkl, str(root / "t2.csv"), translate)
        got[side] = {"counts": counts, "splits": splits, "n": n,
                     "csv": (save / "transcription.csv").read_bytes(),
                     "t2": (root / "t2.csv").read_bytes(),
                     "videos": _tree_bytes(save / "subvideo") if copy_videos else None,
                     "npz": save / "label.npz"}
    _npz_equal(got["port"].pop("npz"), got["jax"].pop("npz"))
    assert got["port"] == got["jax"]
    assert got["port"]["counts"] == {"train": 2, "val": 0, "test": 1}
    if copy_videos:
        assert sorted(got["port"]["videos"]) == ["vidA_0.mp4", "vidB_0.mp4"]


def _media_tree(root):
    vids = root / "videos"
    vids.mkdir(parents=True)
    (vids / "clip_a.avi").write_bytes(b"not a real video")
    (vids / "clip_b.mp4").write_bytes(b"not a real video")
    (vids / "clip_c.mkv").write_bytes(b"not a real video")
    return vids


@pytest.mark.parametrize("ffmpeg", ["stub", "absent"])
def test_media_helpers_match(tmp_path, monkeypatch, ffmpeg):
    """With the stub every job runs (avi_to_mp4 removes its sources); with
    no ffmpeg at the named path every job fails gracefully: nothing
    removed, every wav reported missing."""
    exe = _ffmpeg_stub(tmp_path / "ffmpeg") if ffmpeg == "stub" else str(tmp_path / "none")
    monkeypatch.setattr(media, "FFMPEG", exe)
    monkeypatch.setattr(jax_media, "FFMPEG", exe)
    got = {}
    for side, mod in (("jax", jax_media), ("port", media)):
        root = tmp_path / side
        vids = _media_tree(root)
        n_audio = mod.split_audio_from_video_16k(str(vids), str(root / "wavs"), workers=2)
        missing = mod.find_missing_audio(str(vids), str(root / "wavs"))
        n_mp4 = mod.avi_to_mp4(str(vids), workers=2, remove_src=True)
        got[side] = (n_audio, missing, n_mp4, _tree_bytes(vids), _tree_bytes(root / "wavs"))
    assert got["port"] == got["jax"]
    if ffmpeg == "stub":
        assert got["port"][:3] == (3, [], 2)
        assert sorted(got["port"][3]) == ["clip_a.mp4", "clip_b.mp4", "clip_c.mp4"]
    else:
        assert got["port"][:3] == (0, ["clip_a", "clip_b", "clip_c"], 0)
        assert len(got["port"][3]) == 3


# ---------------------------------------------------------------- metrics

def _binary_inputs(seed=1):
    rng = np.random.default_rng(seed)
    labels_ = rng.uniform(-3, 3, size=200)
    labels_[:20] = 0.0
    return rng.uniform(-3, 3, size=200), labels_


@pytest.mark.parametrize("case", ["test_metrics", "column", "all_zero"])
def test_calculate_binary_results_matches(case):
    preds, labs = _binary_inputs()
    if case == "column":
        preds, labs = preds[:, None], labs[:, None]
    elif case == "all_zero":
        labs = np.zeros_like(labs)
    got = metrics.calculate_binary_results(preds, labs)
    ref = jax_metrics.calculate_binary_results(preds, labs)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _folds():
    rng = np.random.default_rng(0)
    labs = rng.uniform(-3, 3, 10)
    return [{"eval_valmse": 0.5 + 0.1 * k, "eval_emofscore": 0.7 - 0.05 * k,
             "eval_emoacc": 0.6 + 0.01 * k,
             "test_vallabels": labs, "test_valpreds": labs + 0.1 * (k + 1),
             "test_emolabels": np.arange(10) % 2, "test_emoprobs": rng.uniform(size=(10, 2))}
            for k in range(3)]


def test_cross_validation_helpers_match():
    folds = _folds()
    for name in ("average_folds_for_vals", "average_folds_for_emos"):
        for testname in ("test", "val"):
            got = getattr(metrics, name)(folds, testname)
            ref = getattr(jax_metrics, name)(folds, testname)
            assert len(got) == len(ref) == 2
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    assert metrics.gain_cv_results(folds) == jax_metrics.gain_cv_results(folds)
    partial = [{"eval_valmse": f["eval_valmse"]} for f in folds]
    assert metrics.gain_cv_results(partial) == jax_metrics.gain_cv_results(partial)
    assert metrics.overall_metric(0.8, 0.4) == jax_metrics.overall_metric(0.8, 0.4)
    r = {"emofscore": 0.7, "valmse": 0.5, "loss": 1.0}
    for name in ("emoval", "emo", "val", "loss"):
        assert (metrics.gain_metric_from_results(r, name)
                == jax_metrics.gain_metric_from_results(r, name))
    assert metrics.gain_metric_from_results(r) == jax_metrics.gain_metric_from_results(r)
    with pytest.raises(KeyError):
        metrics.gain_metric_from_results(r, "other")
    assert metrics.average_folds_for_vals([{"x": 1}], "test") == ([], [])

