"""The traced window of a ``--trace 1`` run, reduced from ``torch.profiler``.

The profiler records the device's activity alone: its operations (kernels,
copies, fills) and the host's CUDA runtime calls, not every host operation.
The harness opens and closes the traced window with a one-element fill on
an idle device, so the record's first and last device operations bound it.
The reduction reads the profiler's raw records (building its event tree
would take longer than the traced window), merges the device operations'
intervals and reports the device's busy seconds inside the window, its idle
gaps labelled by the host's CUDA runtime call in flight at the gap's middle
(``python`` where there is none), device seconds by name, and the device
seconds of the tile intersector's kernels.
"""

from __future__ import annotations

import collections

# the program's hand-written traversal kernels: K1 (and its K4 mode), K2
# and K3, the pair test, the packet walk
TRAVERSAL = ("tileloop_kernel", "slab_kernel", "pair_kernel",
             "packet_kernel")
K1, K2 = "tileloop_kernel", "slab_kernel<true>"


def _events(prof):
    """(device ops, host runtime calls) as (start_ns, end_ns, name)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_user_annotation", bool)():
            continue  # a program's span and its device twin: no operation
        a = e.start_ns()
        rng = (a, a + e.duration_ns(), e.name())
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            dev.append(rng)
        elif kind == DeviceType.CPU:
            host.append(rng)
    return dev, host


def _labels(host, times):
    """For each of ``times`` (ascending), the name of the latest-starting
    interval of ``host`` (sorted by start) that covers it, or "python":
    one sweep, since an interval that ends before one time covers no
    later one."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "python")
    return out


def reduce(prof) -> dict:
    """The traced window's device summary (seconds), or {} when the record
    holds no device operation."""
    dev, host = _events(prof)
    if not dev:
        return {}
    dev.sort()
    w0, w1 = dev[0][0], max(b for _, b, _ in dev)
    busy, gaps, cur0, cur1 = 0.0, [], dev[0][0], dev[0][1]
    for a, b, _ in dev[1:]:
        if a > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    busy += cur1 - cur0
    by_name = collections.Counter()
    counts = collections.Counter()
    for a, b, n in dev:
        by_name[n] += b - a
        counts[n] += 1
    host.sort()
    idle = collections.Counter()
    for (a, b), name in zip(gaps, _labels(host, [(a + b) // 2
                                                 for a, b in gaps])):
        idle[name] += b - a
    trav = sum(t for n, t in by_name.items()
               if any(k in n for k in TRAVERSAL))
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy * 1e-9,
        "traversal_s": trav * 1e-9,
        "other_s": (sum(by_name.values()) - trav) * 1e-9,
        "k1_records": sum(c for n, c in counts.items() if K1 in n),
        "k2_records": sum(c for n, c in counts.items() if K2 in n),
        "device_ops": [[n[:160], t * 1e-9]
                       for n, t in by_name.most_common(10)],
        "idle_gaps": [[n[:160], t * 1e-9] for n, t in idle.most_common(10)],
    }
