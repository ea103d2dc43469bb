"""PyTorch/CUDA port of chemprop_tpu: the D-MPNN inference path on an NVIDIA
Hopper GPU, with hand-written CUDA kernels in place of the Pallas TPU ones.

The package imports torch and numpy only. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on the CPU every kernel wrapper
takes its plain PyTorch version."""
