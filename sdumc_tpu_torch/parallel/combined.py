"""Combined tensor-parallel extractor and data-parallel fusion training (the
JAX package's ``parallel/combined.py``).

JAX jits one program over a ``(data, model)`` mesh: a frozen LLM trunk,
sharded over ``model`` (Megatron shardings), embeds the batch's raw token
ids; its layer-tap sum feeds the text slot of the dual-view fusion step,
whose gradients sum over ``data``. This is the end-to-end path the
tokenize-in-collate dataset (``data/raw_text.py``) exists for: no offline
text features, the text tower inside the train step.

Here each process is one cell of a ``make_mesh`` grid: it runs its model
group's tensor-parallel trunk (``models.llama.tp_model_from_state_dict(...,
trunk=True)`` or ``convert.hf_llama.load_hf_llama_trunk(axis=model_axis)``)
on its data rank's rows under ``no_grad``, then the port's train step over
the data axis. Every rank of a model group runs the same fusion step on the
same rows, as JAX replicates it over ``model``: their dropout draws are
seeded by the data rank (``DataAxis.rank``), so their fusion parameters stay
equal.

The tap sum is ``LlamaModel``'s ``tap_sum``, in f32 at any trunk dtype. JAX
sums the taps in the trunk's dtype and then widens (ROADMAP §3: at bf16 it
rounds three times); at f32 the two are the same sum in the same order.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from sdumc_tpu_torch.parallel.mesh import DataAxis

TAP_LAYERS = (-4, -3, -2, -1)


def make_tp_dp_dual_step(trunk, state, loss_cfg, seed: int,
                         axis: Optional[DataAxis] = None,
                         tap_layers: Sequence[int] = TAP_LAYERS):
    """Returns batch -> metrics (device tensors): the frozen `trunk` (a
    ``LlamaModel``, tensor-parallel over its model axis or whole) embeds
    ``batch["text_ids"]`` ([B, Tt] integer ids of this data rank's rows,
    padded on the left as ``data/raw_text.py`` pads them, run with no pad
    mask as in JAX), the sum of its hidden states ``tap_layers`` (HF's
    convention: -1 is post-norm) is the text stream, and
    ``train.step.make_train_step(state, loss_cfg, seed, axis)`` takes the
    step. ``batch`` holds audio / video / feat4 [B, T, D] and vals [B] as
    the train step takes them, and ``t_max``, whose text entry is the
    token batch-max."""
    from sdumc_tpu_torch.train.step import make_train_step   # train.step imports parallel

    train_step = make_train_step(state, loss_cfg, seed, axis)

    def step(batch: Dict) -> Dict:
        with torch.no_grad():
            text = trunk(input_ids=batch["text_ids"], tap_sum_layers=tap_layers)["tap_sum"]
        fbatch = {k: v for k, v in batch.items() if k != "text_ids"}
        fbatch["text"] = text
        return train_step(fbatch)

    return step
