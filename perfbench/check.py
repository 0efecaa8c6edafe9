"""Whether what the timed path delivered is correct: a sample of the
window's units, drawn from the seed (with the slowest unit in it), and of
each unit's pixels, recomputed by the plain reference from the scene, the
camera, the seed and the unit's sample window.

The number compared is ``off_share``: the share of checked pixel channels
on which the program's delivery departs from the reference's. For a
``host_u8`` delivery a channel departs when its byte differs; for a
``device`` delivery (mean radiance) when the two differ by more than
``REL_TOL`` of the reference's value (or ``ABS_TOL``). Rounding moves a
channel by far less than either; a path that takes another branch (a ray
that grazes a triangle's edge, a shadow ray ending at a surface) moves it
past them, so the sound program's share is small and not 0.
"""

from __future__ import annotations

import numpy as np
import torch

REL_TOL = 1e-4
ABS_TOL = 1e-6


class Keeper:
    """The units a run checks: a uniform sample of ``k`` of them (reservoir
    sampling, drawn from the seed) and the slowest."""

    def __init__(self, k: int, seed: int, slowest: bool):
        self.k = k
        self.rng = np.random.default_rng([int(seed), 2])
        self.kept = []
        self.seen = 0
        self.slowest = slowest
        self.slow = None  # (seconds, unit, image)

    def offer(self, unit, image):
        if len(self.kept) < self.k:
            self.kept.append((unit, image))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = (unit, image)
        self.seen += 1

    def offer_time(self, seconds, unit, image):
        if self.slowest and (self.slow is None or seconds > self.slow[0]):
            self.slow = (seconds, unit, image)

    def units(self):
        out = list(self.kept)
        if self.slow is not None and all(u.index != self.slow[1].index
                                         for u, _ in out):
            out.append(self.slow[1:])
        return sorted(out, key=lambda x: x[0].index)


def compare(ws, kept, camera, render: dict, mix: dict, seed: int, device,
            produced=None):
    """``off_share`` over the kept units, and the per-channel gaps behind
    it. ``produced(unit, px, py)`` stands in for the program's delivery
    (the control uses it); otherwise the kept images are read."""
    from perfbench.reference.render import render_pixels, to_u8

    w, h = render["width"], render["height"]
    n_px = int(mix["check"]["pixels"])
    rng = np.random.default_rng([int(seed), 3])
    off = total = 0
    gaps = []
    for unit, image in kept:
        flat = torch.as_tensor(rng.choice(w * h, size=min(n_px, w * h),
                                          replace=False), device=device)
        px, py = flat % w, flat // w
        ref = render_pixels(ws, camera, unit.seed, unit.samples, px, py, w, h,
                            render["max_bounces"], render["use_nee"])
        ref_mean = ref / float(unit.samples)
        if produced is not None:
            got = produced(unit, px, py)
        else:
            got = image[py.to(image.device), px.to(image.device)]
        if mix["deliver"] == "host_u8":
            got = torch.as_tensor(got).to(device)
            if got.dtype != torch.uint8:  # a stand-in's mean radiance
                got = to_u8(got)
            diff = (got.int() - to_u8(ref_mean).int()).abs().float()
            bad = diff > 0
        else:
            got = torch.as_tensor(got).to(device).float()
            diff = (got - ref_mean).abs() / torch.clamp_min(
                ref_mean.abs(), ABS_TOL / REL_TOL)
            bad = ~(diff <= REL_TOL)  # NaN counts as off
        off += int(bad.sum())
        total += bad.numel()
        gaps.append(diff.flatten().cpu())
    gaps = torch.cat(gaps) if gaps else torch.zeros(0)
    return off / max(total, 1), total, gaps
