"""PyTorch/CUDA port of sdumc_tpu: the SDUMC fusion net and its data path,
with the frame-attention kernel written by hand for NVIDIA Hopper.

The JAX package ``sdumc_tpu`` is the reference; this package imports
nothing of it, nor JAX. Entry points run on CUDA unless the caller asks for
the CPU, where every kernel takes its plain PyTorch version.
"""
