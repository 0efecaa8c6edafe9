"""Hand-written CUDA kernels and their plain PyTorch versions.

``tilewave`` holds the tile traversal path's kernels — the exact entry
build and exact mask (``csrc/entries.cu``), the tile loop and the grid
over (tile, cluster) pairs (``csrc/tileloop.cu``); ``pairwave`` the
pair-wavefront intersector's pair test (``csrc/pairwave.cu``); ``packet``
the packet-BVH walk (``csrc/packet.cu``). Each sits behind a wrapper that
launches the kernel for CUDA tensors and runs the plain version for CPU
tensors. ``shade`` launches the staged loop's shade of a wave
(``csrc/shade.cu``), whose plain version is the loop's own PyTorch shade
(``render.staged``), chosen when the renderer is built
(``shade.shade_path``). ``cuda_build`` compiles the sources with nvcc at
first use.

Each CUDA wrapper counts its launches on itself (``.launches``, and K1
and K4 by mode in ``.variant_launches``). A CUDA graph runs no Python on
replay, so the staged loop's graphs take a ``launch_snapshot`` before
each capture, take back what the capture counted
(``take_launches_since``: a capture launches nothing) and add it again
on every replay (``add_launches``); ``chip_smoke.py`` holds each graph's
count to the kernel nodes that libcuda holds for it.
"""


def _wrappers():
    from tpurt_torch.kernels import packet, pairwave, shade, tilewave

    return (tilewave.entries_cuda, tilewave.exact_mask_cuda,
            tilewave.tileloop_cuda, tilewave.tilegrid_cuda,
            pairwave.pair_test_cuda, packet.packet_cuda, shade.shade_cuda)


def reset_launch_counts() -> None:
    """Zero every kernel's launch counter."""
    from tpurt_torch.kernels import packet, pairwave, shade, tilewave

    tilewave.reset_launch_counts()
    pairwave.reset_launch_counts()
    packet.reset_launch_counts()
    shade.reset_launch_counts()


def launch_counts() -> dict:
    """Launches since the last reset, by kernel (K1 and K4 by mode)."""
    from tpurt_torch.kernels import packet, pairwave, shade, tilewave

    return {**tilewave.launch_counts(), **pairwave.launch_counts(),
            **packet.launch_counts(), **shade.launch_counts()}


def launch_snapshot() -> dict:
    """Every counter's value, keyed (wrapper, attribute, mode or None)."""
    snap = {}
    for fn in _wrappers():
        for attr in ("launches", "variant_launches"):
            value = getattr(fn, attr, None)
            if isinstance(value, dict):
                snap.update(((fn, attr, k), n) for k, n in value.items())
            elif value is not None:
                snap[(fn, attr, None)] = value
    return snap


def take_launches_since(snap: dict) -> dict:
    """The counts added since ``snap``, by the same keys; every counter
    is put back to its value in ``snap``."""
    now = launch_snapshot()
    for fn in _wrappers():
        if isinstance(getattr(fn, "variant_launches", None), dict):
            fn.variant_launches = {}
    for (fn, attr, k), n in snap.items():
        if k is None:
            setattr(fn, attr, n)
        else:
            getattr(fn, attr)[k] = n
    return {k: n - snap.get(k, 0) for k, n in now.items()
            if n != snap.get(k, 0)}


def add_launches(delta: dict) -> None:
    """Add ``take_launches_since``'s counts to the counters."""
    for (fn, attr, k), n in delta.items():
        if k is None:
            setattr(fn, attr, getattr(fn, attr) + n)
        else:
            counts = getattr(fn, attr)
            counts[k] = counts.get(k, 0) + n
