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
(``shade.shade_path``). ``raysort`` sorts the tile intersector's bounce
and shadow waves into octant order and restores their outputs
(``csrc/raysort.cu``). ``cuda_build`` compiles the sources with nvcc at
first use.

Every CUDA launcher goes through ``launch``, which counts the launch
under its key here: ``entries`` (K2), ``exact_mask`` (K3), K1's and K4's
modes (``tileloop…``, ``tilegrid…``), ``pair`` (K6), ``packet`` (K5),
``shade`` and ``shade_tl`` (S1 on the flat and the two-level accel) and
the ray sort's ``raysort`` (its keys, then CUB's
sort), ``raygather`` and ``rayrestore``; ``KERNELS`` names the device
kernel behind each key (the sort's own kernels are CUB's). The
tile intersector counts its waves here too, by tile mode
(``waves.<mode>``), and the staged loop each wave its PyTorch shade
shades (``shade.plain``, on the CPU and the card alike). A CUDA graph
runs no Python on replay, so the staged loop's graphs take back what
their capture counted (``take_since``: a capture launches nothing) and
add it again on every replay (``add``);
``chip_smoke.py`` holds each graph's count to the kernel nodes that
libcuda holds for it.
"""

import torch

from tpurt_torch.utils import profiling

# the library entry point of each kernel's launches, by the name its
# launch errors give; a launch key starts with its kernel's name
ENTRY_POINTS = {"entries": "tpurt_entries",
                "exact_mask": "tpurt_exact_mask",
                "tileloop": "tpurt_tileloop", "tilegrid": "tpurt_tilegrid",
                "pair": "tpurt_pair_test", "packet": "tpurt_packet",
                "shade": "tpurt_shade", "raysort": "tpurt_raysort",
                "raygather": "tpurt_raygather",
                "rayrestore": "tpurt_rayrestore"}
# the device kernel (tpurt_torch/csrc) behind each launch key: K1's modes
# (tilewave._variant) and K4's are variants of one template
KERNELS = {"entries": "slab_kernel<true>", "exact_mask": "slab_kernel<false>",
           **{f"tileloop{tl}{mode}": "tileloop_kernel" for tl in ("", "_tl")
              for mode in ("", "_sc", "_seg", "_allpairs")},
           **{f"tilegrid{tl}{mode}": "tileloop_kernel" for tl in ("", "_tl")
              for mode in ("", "_allpairs")},
           "pair": "pair_kernel", "packet": "packet_kernel",
           "shade": "shade_kernel<false>", "shade_tl": "shade_kernel<true>",
           "raysort": "raysort_keys_kernel",
           "raygather": "raygather_kernel",
           "rayrestore": "rayrestore_kernel"}
# the launch keys that ``launch_counts`` always holds (K1's and K4's modes,
# S1's two-level instantiation and the ray sort's appear once launched)
FIXED = ("entries", "exact_mask", "pair", "packet", "shade")
# counted beside the launches where the PyTorch code does a kernel's work:
# a wave that the staged loop's PyTorch shade shades (render/staged.py)
PLAIN = ("shade.plain",)

_COUNTS: dict = {}  # launch keys and "waves.<mode>" since their reset


def _kernel_name(key: str) -> str:
    return next(name for name in ENTRY_POINTS if key.startswith(name))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to counter ``key``; a wave mode also counts in the
    recorder (``profiling.count``)."""
    _COUNTS[key] = _COUNTS.get(key, 0) + n
    if key.startswith("waves."):
        profiling.count(key, n)


def counts(prefix: str = "") -> dict:
    """The counters whose key starts with ``prefix``, those above 0."""
    return {k: n for k, n in _COUNTS.items() if k.startswith(prefix) and n}


def reset(prefix: str) -> None:
    """Zero the counters whose key starts with ``prefix``."""
    for k in [k for k in _COUNTS if k.startswith(prefix)]:
        del _COUNTS[k]


def take_since(before: dict) -> dict:
    """The counts added since ``before`` (a ``counts()``), taken back off
    the counters."""
    delta = {k: n - before.get(k, 0) for k, n in _COUNTS.items()
             if n != before.get(k, 0)}
    add({k: -n for k, n in delta.items()})
    return delta


def add(delta: dict) -> None:
    """Add counts by key (a graph's, on each replay)."""
    for k, n in delta.items():
        count(k, n)


def launch(key: str, device, *args, work: bool) -> None:
    """Launch the kernel of ``key`` (an entry of ``KERNELS``) through its
    library entry point with ``args`` and ``device``'s current stream;
    count the launch when it had ``work`` (a launcher over no tiles, pairs
    or rays launches nothing)."""
    from tpurt_torch.kernels import cuda_build

    if key not in KERNELS:
        raise KeyError(f"{key}: no device kernel in KERNELS")
    name = _kernel_name(key)
    entry = getattr(cuda_build.load().lib, ENTRY_POINTS[name])
    err = entry(*args, _stream(device))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    if work:
        count(key)


def reset_launch_counts() -> None:
    """Zero every kernel's launch counter and the ``PLAIN`` counts, and
    K2's and K3's ray counters on the card
    (``tilewave.slab_ray_counts``)."""
    from tpurt_torch.kernels import tilewave

    tilewave._slab_rays(reset=True)
    for k in (*KERNELS, *PLAIN):
        _COUNTS.pop(k, None)


def launch_counts() -> dict:
    """Launches since the last reset, by launch key: the ``FIXED`` keys,
    then K1's and K4's modes, the ray sort's keys and the ``PLAIN``
    counts that moved, in ``ENTRY_POINTS``' order."""
    got = {**dict.fromkeys(FIXED, 0),
           **{k: n for k, n in counts().items()
              if k in KERNELS or k in PLAIN}}
    order = list(ENTRY_POINTS)
    return dict(sorted(got.items(),
                       key=lambda kv: order.index(_kernel_name(kv[0]))))
