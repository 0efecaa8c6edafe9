"""Scene entry point — port of ``tpurt.scene.loader``."""

from __future__ import annotations

from tpurt_torch.scene.types import Scene
from tpurt_torch.scene.procedural import PRESET_BUILDERS


def load_scene(path_or_preset: str) -> Scene:
    """Build a named procedural preset (hello_triangle, cornell, bunny,
    cornell_pt, sponza). OBJ/glTF files are not ported yet (ROADMAP §1
    item 12)."""
    if path_or_preset in PRESET_BUILDERS:
        return PRESET_BUILDERS[path_or_preset]()
    if path_or_preset.lower().endswith((".obj", ".gltf", ".glb")):
        raise NotImplementedError(
            "OBJ/glTF loading is not ported to tpurt_torch yet "
            "(ROADMAP §1 item 12: loaders, export and native)")
    raise ValueError(
        f"unknown scene {path_or_preset!r}: expected .obj/.gltf/.glb or one of "
        f"{sorted(PRESET_BUILDERS)}"
    )
