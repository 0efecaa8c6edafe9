"""Measured live-wave caps — port of the read side of
``tpurt.utils.autotune``.

Truncating a bounce or shadow wave at a cap at least its live count drops
only dead rays (the intersector's octant sort puts them at the back) and
shrinks every later stage to the live prefix. Live counts depend on the
scene and the sampling, so caps are measured: the repository's table
``benchmarks/autotune.json`` holds per-batch live/want counts per config
signature, read here (read-only) with a safety margin. A cap that would
cut alive rays trips the live_overflow counter and ``render_scene``
re-renders uncapped.
"""

from __future__ import annotations

import json
import os

# margin over the measured per-batch average live count
MARGIN = 1.35


def autotune_key(config) -> str:
    """Sampling signature: everything the per-bounce live counts depend on."""
    return (
        f"{config.scene}|{config.width}x{config.height}"
        f"|sppb{config.spp_per_batch}|b{config.max_bounces}"
        f"|nee{config.use_nee}|{config.shading_mode}"
    )


def _repo_table() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "benchmarks", "autotune.json",
    )


def _entry(config) -> dict:
    try:
        with open(_repo_table()) as f:
            table = json.load(f)
    except (OSError, ValueError):
        return {}
    return table.get(autotune_key(config)) or {}


def live_caps_for(config) -> tuple:
    """Measured live caps (entry b caps the bounce-(b+1) trace wave; the
    last bounce's wave is never traced). Empty tuple = no entry."""
    live = _entry(config).get("live_per_batch") or []
    return tuple(
        int(-(-v * MARGIN // 1)) for v in live[: config.max_bounces]
    )


def want_caps_for(config) -> tuple:
    """Measured NEE want caps: entry b caps bounce b's occlusion trace."""
    want = _entry(config).get("want_per_batch") or []
    return tuple(
        int(-(-v * MARGIN // 1)) for v in want[: config.max_bounces + 1]
    )
