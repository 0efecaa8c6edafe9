"""Measured live-wave caps — port of ``tpurt.utils.autotune``.

Truncating a bounce or shadow wave at a cap at least its live count drops
only dead rays (the intersector's octant sort puts them at the back) and
shrinks every later stage to the live prefix. Live counts depend on the
scene and the sampling, so caps are measured: an uncapped render records
its per-bounce live and want counts in its stats, ``record`` keeps them
per config signature in the user cache (under ``TPURT_AUTOTUNE_WRITE=1``;
``TPURT_AUTOTUNE_PATH``, default ``~/.cache/tpurt_torch_autotune.json``),
and the lookups read the user cache, then the repository's table
``benchmarks/autotune.json``, with a safety margin. A cap that would cut
alive rays trips the live_overflow counter and ``render_scene``
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


def _user_table() -> str:
    return os.environ.get(
        "TPURT_AUTOTUNE_PATH",
        os.path.expanduser("~/.cache/tpurt_torch_autotune.json"),
    )


def _load(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _entry(config) -> dict:
    key = autotune_key(config)
    return (_load(_user_table()).get(key) or _load(_repo_table()).get(key)
            or {})


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


def record(config, stats) -> None:
    """Keep the per-batch live/want counts of an uncapped render's stats
    in the user cache, the largest seen per bounce (callers gate on
    TPURT_AUTOTUNE_WRITE=1)."""
    live = stats.get("live_counts") or []
    want = stats.get("want_counts") or []
    if (not live and not want) or stats.get("live_overflow"):
        return
    batches = max(1, -(-int(stats.get("spp", config.spp_per_batch))
                       // config.spp_per_batch))
    path = _user_table()
    table = _load(path)
    key = autotune_key(config)
    entry = dict(table.get(key, {}))
    for field, vals in (("live_per_batch", live),
                        ("want_per_batch", want)):
        if not vals:
            continue
        per_batch = [v / batches for v in vals]
        prev = entry.get(field)
        if prev:
            per_batch = [max(a, b) for a, b in zip(per_batch, prev)]
        entry[field] = per_batch
    table[key] = entry
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
