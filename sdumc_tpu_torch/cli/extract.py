"""Feature-extraction entry point of the port (stage L1).

    python -m sdumc_tpu_torch.cli.extract audio --model_dir ... --audio_dir ... --save_dir ...
    python -m sdumc_tpu_torch.cli.extract text --model_dir ... --trans_path ... --save_dir ...
    python -m sdumc_tpu_torch.cli.extract visual --checkpoint ... --face_dir ... --save_dir ...
    python -m sdumc_tpu_torch.cli.extract manet_train --data ...
    python -m sdumc_tpu_torch.cli.extract feat4 --llm_dir ... --projector_path ... \
        --wavlm_dir ... --save_dir ...
    python -m sdumc_tpu_torch.cli.extract pack --src_dir ... --out_prefix ... \
        [--dtype float32|bfloat16|int8]
    python -m sdumc_tpu_torch.cli.extract asr --model_dir ... --audio_dir ... \
        --save_csv ... [--vad]

Seven stages are ported: ``audio`` (WavLM, extract/audio.py), ``text``
(the LLaMA family, extract/text.py), ``visual`` (MANet, extract/visual.py),
``manet_train`` (MANet's RAF-DB trainer, extract/manet_train.py),
``feat4`` (the Vicuna pseudo-text decode, extract/llm4wav.py), ``pack``
(a directory of ``.npy`` features into one packed store, data/packed.py,
that cli.train and cli.infer read when it sits in the features directory
as ``{feature}.bin`` / ``.json``) and ``asr`` (Whisper transcripts,
extract/asr.py). The JAX package's other stage is still to port (ROADMAP
queue 1): ``vision`` (the other visual encoders).
"""

from __future__ import annotations

import importlib
import sys

STAGES = {
    "audio": "sdumc_tpu_torch.extract.audio",
    "text": "sdumc_tpu_torch.extract.text",
    "visual": "sdumc_tpu_torch.extract.visual",
    "manet_train": "sdumc_tpu_torch.extract.manet_train",
    "feat4": "sdumc_tpu_torch.extract.llm4wav",
    "pack": "sdumc_tpu_torch.data.packed",
    "asr": "sdumc_tpu_torch.extract.asr",
}
NOT_PORTED = {
    "vision": "the other visual encoders",
}


def main(argv=None):
    """Runs a stage; returns 1 for a stage that is missing or not ported,
    else the stage's own result."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    stage, rest = argv[0], argv[1:]
    if stage in STAGES:
        return importlib.import_module(STAGES[stage]).main(rest)
    print(__doc__)
    if stage in NOT_PORTED:
        print(f"stage {stage!r} is not ported yet: ROADMAP queue 1, {NOT_PORTED[stage]}")
    else:
        print(f"unknown stage {stage!r}")
    return 1


if __name__ == "__main__":
    result = main()
    sys.exit(result if isinstance(result, int) else 0)
