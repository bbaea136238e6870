"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
versions. Nothing here compiles or touches a card at import time."""

import torch


def check_operand(name: str, t: torch.Tensor, shape, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned f32 tensor of
    ``shape`` on ``device``: what every kernel of the package takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
