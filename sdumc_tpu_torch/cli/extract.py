"""Feature-extraction entry point of the port (stage L1).

    python -m sdumc_tpu_torch.cli.extract audio --model_dir ... --audio_dir ... --save_dir ...
    python -m sdumc_tpu_torch.cli.extract feat4 --llm_dir ... --projector_path ... \
        --wavlm_dir ... --save_dir ...

Two stages are ported: ``audio`` (WavLM, extract/audio.py) and ``feat4``
(the Vicuna pseudo-text decode, extract/llm4wav.py). The JAX package's
other stages are still to port (ROADMAP queue 1): ``text`` (text
families), ``visual``, ``vision`` and ``manet_train`` (visual), ``asr``
(ASR) and ``pack`` (bf16 streams and the int8 store).
"""

from __future__ import annotations

import sys

NOT_PORTED = {
    "text": "text families",
    "visual": "visual",
    "vision": "visual",
    "manet_train": "visual",
    "asr": "ASR",
    "pack": "bf16 streams and the int8 store",
}


def main(argv=None):
    """Runs a stage; returns 1 for a stage that is missing or not ported,
    else the stage's own result."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    stage, rest = argv[0], argv[1:]
    if stage == "audio":
        from sdumc_tpu_torch.extract.audio import main as run

        return run(rest)
    if stage == "feat4":
        from sdumc_tpu_torch.extract.llm4wav import main as run

        return run(rest)
    print(__doc__)
    if stage in NOT_PORTED:
        print(f"stage {stage!r} is not ported yet: ROADMAP queue 1, {NOT_PORTED[stage]}")
    else:
        print(f"unknown stage {stage!r}")
    return 1


if __name__ == "__main__":
    result = main()
    sys.exit(result if isinstance(result, int) else 0)
