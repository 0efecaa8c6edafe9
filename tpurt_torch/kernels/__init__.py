"""Hand-written CUDA kernels and their plain PyTorch versions.

``tilewave`` holds the two kernels of the flat tile traversal path —
the exact entry build (``csrc/entries.cu``) and the tile loop
(``csrc/tileloop.cu``) — behind wrappers that launch the kernel for CUDA
tensors and run the plain version for CPU tensors. ``cuda_build`` compiles
the sources with nvcc at first use.
"""
