"""Host-side media conversion (reference toolkit/utils/functions.py:18-31,
269-284): avi -> mp4 re-mux and 16 kHz mono wav extraction from clip videos.

ffmpeg stays an external binary by design (SURVEY §2.1); the reference's
sequential ``os.system`` loops become a thread pool of subprocesses (the
work is process-bound inside ffmpeg, threads only overlap the spawns).
"""

from __future__ import annotations

import concurrent.futures as futures
import glob
import os
import subprocess
from typing import List

from sdumc_tpu_torch.preprocess.cmumosei import FFMPEG


def _run(cmd: List[str]) -> bool:
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        return True
    except (subprocess.CalledProcessError, OSError):
        return False


def avi_to_mp4(video_root: str, workers: int = 8, remove_src: bool = True) -> int:
    """Re-mux every non-mp4 video in place (reference func_avi_to_mp4)."""
    jobs = []
    for path in sorted(glob.glob(os.path.join(video_root, "*"))):
        if path.endswith(".mp4"):
            continue
        jobs.append((path, path.rsplit(".", 1)[0] + ".mp4"))

    def one(job):
        src, dst = job
        ok = _run([FFMPEG, "-y", "-i", src, "-loglevel", "quiet", dst])
        if ok and remove_src:
            os.remove(src)
        return ok

    with futures.ThreadPoolExecutor(workers) as pool:
        return sum(pool.map(one, jobs))


def split_audio_from_video_16k(video_root: str, save_root: str,
                               workers: int = 8) -> int:
    """Per-clip 16 kHz mono wav extraction (func_split_audio_from_video_16k)
    — produces the input contract of extract/audio.py. Skip-and-continue
    like the reference (:273)."""
    os.makedirs(save_root, exist_ok=True)
    jobs = []
    for path in sorted(glob.glob(os.path.join(video_root, "*"))):
        name = os.path.basename(path).rsplit(".", 1)[0]
        out = os.path.join(save_root, name + ".wav")
        if not os.path.exists(out):
            jobs.append((path, out))

    def one(job):
        src, dst = job
        return _run([FFMPEG, "-loglevel", "quiet", "-y", "-i", src,
                     "-ar", "16000", "-ac", "1", dst])

    with futures.ThreadPoolExecutor(workers) as pool:
        return sum(pool.map(one, jobs))


def find_missing_audio(video_root: str, audio_root: str) -> List[str]:
    """Clips whose wav failed to materialize (func_find_false_audio)."""
    missing = []
    for path in sorted(glob.glob(os.path.join(video_root, "*"))):
        name = os.path.basename(path).rsplit(".", 1)[0]
        if not os.path.exists(os.path.join(audio_root, name + ".wav")):
            missing.append(name)
    return missing
