"""The one traffic generator: a closed loop of units read from a traffic
file (``perfbench/traffic/<name>.json``) and drawn from the run's seed.

A unit is one delivery to the user: an image or a frame. It adds
``samples_per_unit`` samples a pixel to an accumulation that starts afresh
every ``units_per_accumulation`` units, each accumulation with its own
seed, at the scene's camera. Every seed gets the same units in the same
order: only the random streams differ.

Keys of a traffic file:
  samples_per_unit         samples a pixel each unit adds
  units_per_accumulation   units before the accumulation restarts
  render                   RenderConfig fields this mix overrides
                           (``spp_per_batch``)
  deliver                  "device": the mean radiance stays on the card;
                           "host_u8": the tonemapped 8-bit image is copied
                           into host memory
  trace_seconds            length of each stretch of a --trace 1 run's
                           window: untraced, then traced
  check                    {"units": units compared, "pixels": pixels a
                           unit, "slowest": also the slowest unit}
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

KEYS = {"samples_per_unit", "units_per_accumulation", "render", "deliver",
        "trace_seconds", "check"}


@dataclasses.dataclass(frozen=True)
class Unit:
    index: int  # position in the window
    seed: int  # the accumulation's seed
    first: bool  # the unit starts a new accumulation
    samples: int  # samples a pixel after this unit


def load(root: str, name: str) -> dict:
    with open(os.path.join(root, "perfbench", "traffic", f"{name}.json")) as f:
        mix = json.load(f)
    unknown = set(mix) - KEYS
    if unknown:
        raise ValueError(f"traffic {name}: unknown keys {sorted(unknown)}")
    if mix["deliver"] not in ("device", "host_u8"):
        raise ValueError(f"traffic {name}: deliver {mix['deliver']!r}")
    return mix


def units(mix: dict, seed: int, stream: int = 0):
    """The endless unit sequence of ``mix`` under ``seed``; ``stream``
    picks an independent sequence of accumulation seeds (the warm-up's)."""
    rng = np.random.default_rng([int(seed), int(stream)])
    per = int(mix["units_per_accumulation"])
    spu = int(mix["samples_per_unit"])
    i = 0
    while True:
        acc_seed = int(rng.integers(0, 1 << 31))
        for k in range(per):
            yield Unit(i, acc_seed, k == 0, (k + 1) * spu)
            i += 1
