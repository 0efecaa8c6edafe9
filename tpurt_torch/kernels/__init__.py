"""Hand-written CUDA kernels and their plain PyTorch versions.

``tilewave`` holds the tile traversal path's kernels — the exact entry
build and exact mask (``csrc/entries.cu``), the tile loop and the grid
over (tile, cluster) pairs (``csrc/tileloop.cu``); ``pairwave`` the
pair-wavefront intersector's pair test (``csrc/pairwave.cu``); ``packet``
the packet-BVH walk (``csrc/packet.cu``). Each sits behind a wrapper that
launches the kernel for CUDA tensors and runs the plain version for CPU
tensors. ``cuda_build`` compiles the sources with nvcc at first use.
"""


def reset_launch_counts() -> None:
    """Zero every kernel's launch counter."""
    from tpurt_torch.kernels import packet, pairwave, tilewave

    tilewave.reset_launch_counts()
    pairwave.reset_launch_counts()
    packet.reset_launch_counts()


def launch_counts() -> dict:
    """Launches since the last reset, by kernel (K1 and K4 by mode)."""
    from tpurt_torch.kernels import packet, pairwave, tilewave

    return {**tilewave.launch_counts(), **pairwave.launch_counts(),
            **packet.launch_counts()}
