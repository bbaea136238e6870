"""Load a released reference ``.pt`` checkpoint into the port's model.

The reference saves ``{'epoch', 'state_dict', 'optimizer'}`` and loads with
a ``module.`` prefix strip and ``strict=False``. The port's submodules carry
the reference names, so no key table is needed: prefixes are stripped,
matching keys load, and the rest is reported.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch

PREFIXES = ("module.", "model.")


def strip_prefixes(key: str) -> str:
    for prefix in PREFIXES:
        if key.startswith(prefix):
            key = key[len(prefix):]
    return key


def load_reference_state_dict(state_dict: Mapping[str, torch.Tensor],
                              model: torch.nn.Module) -> Dict[str, List[str]]:
    """Load with the reference semantics; returns {'unmapped': checkpoint
    keys the model has no place for, 'missing': model keys the checkpoint
    did not provide (they keep their initial values)}."""
    own = model.state_dict()
    renamed, unmapped = {}, []
    for key, value in state_dict.items():
        k = strip_prefixes(key)
        if k in own and tuple(own[k].shape) == tuple(value.shape):
            renamed[k] = value
        else:
            unmapped.append(key)
    model.load_state_dict(renamed, strict=False)
    missing = [k for k in own if k not in renamed]
    return {"unmapped": unmapped, "missing": missing}


def load_reference_checkpoint(path: str, model: torch.nn.Module) -> Dict[str, List[str]]:
    """Read a reference ``.pt`` file and load it into `model`."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return load_reference_state_dict(state_dict, model)
