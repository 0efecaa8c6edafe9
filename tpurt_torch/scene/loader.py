"""Format-sniffing scene entry point — port of ``tpurt.scene.loader``."""

from __future__ import annotations

from tpurt_torch.scene.types import Scene
from tpurt_torch.scene.procedural import PRESET_BUILDERS


def load_scene(path_or_preset: str) -> Scene:
    """Load a scene from an .obj/.gltf/.glb path, or build a named
    procedural preset (hello_triangle, cornell, bunny, cornell_pt,
    sponza)."""
    if path_or_preset in PRESET_BUILDERS:
        return PRESET_BUILDERS[path_or_preset]()
    lower = path_or_preset.lower()
    if lower.endswith(".obj"):
        from tpurt_torch.scene.obj import load_obj

        return load_obj(path_or_preset)
    if lower.endswith((".gltf", ".glb")):
        from tpurt_torch.scene.gltf import load_gltf

        return load_gltf(path_or_preset)
    raise ValueError(
        f"unknown scene {path_or_preset!r}: expected .obj/.gltf/.glb or one of "
        f"{sorted(PRESET_BUILDERS)}"
    )
