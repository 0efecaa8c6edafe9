"""Frozen scene builders, found by name: ``perfbench/scenes/<builder>.py``
exposes ``build(**args) -> SceneData``. They are copies of the program's
procedural stand-ins as they were when the benchmark was defined, so a later
edit to the program's scene code cannot move the yardstick."""

from __future__ import annotations

import importlib


def build(builder: str, args: dict):
    """The ``SceneData`` of the named builder with ``args``."""
    module = importlib.import_module(f"perfbench.scenes.{builder}")
    return module.build(**args)

