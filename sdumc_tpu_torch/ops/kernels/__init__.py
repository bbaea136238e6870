"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
versions. Nothing here compiles or touches a card at import time."""

import torch


def check_operand(name: str, t: torch.Tensor, shape, device: torch.device,
                  dtypes=(torch.float32,)) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned tensor of one of
    ``dtypes`` (f32 unless the kernel says otherwise), of ``shape``, on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name} must be {names}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
