"""A reference MANet checkpoint (``.pth``) -> the port's MANet.

The reference loads its RAF-DB checkpoint with a ``module.`` strip and
``strict=False`` (extract_manet_embedding.py:110-112); so does the port,
whose module names are the reference's (``models/manet.py``). A blob is
either ``{"state_dict": ..., ...}`` (the released file, and the port's
trainer, ``extract/manet_train.py``) or a bare state dict. The number of
classes is read from ``fc_1.weight``, so a checkpoint trained on another
label set loads too.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from sdumc_tpu_torch.models.manet import MANet, MANetConfig


def manet_state_dict(blob) -> Dict[str, torch.Tensor]:
    """The state dict of a checkpoint blob, ``module.`` prefixes removed."""
    sd = blob.get("state_dict", blob) if isinstance(blob, Mapping) else blob
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def load_manet(path: str, device="cpu"):
    """(MANet in eval mode on ``device``, {"missing", "unexpected"} keys)
    from a ``.pth``, loaded with strict=False and its report printed as the
    reference prints it."""
    sd = manet_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    num_classes = sd["fc_1.weight"].shape[0] if "fc_1.weight" in sd else MANetConfig.num_classes
    model = MANet(MANetConfig(num_classes=num_classes))
    result = model.load_state_dict(sd, strict=False)
    report = {"missing": list(result.missing_keys), "unexpected": list(result.unexpected_keys)}
    print(f"loaded MANet {path}: missing keys {report['missing']}, "
          f"unexpected keys {report['unexpected']}")
    return model.to(device).eval(), report
