"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
versions. Nothing here compiles or touches a card at import time."""
