"""The system under test, driven as its users drive it: the harness's
only contact with the program (``tpurt_torch``).

``Driver`` renders the traffic's units through ``render_scene`` on the
staged loop and delivers each one: the mean radiance kept on the card
(``deliver: device``) or the tonemapped 8-bit image copied into host
memory (``deliver: host_u8``). ``render_scene`` reads its counters after
each call and renders again, uncapped, where a live cap or the pair budget
overflowed; that time counts.
"""

from __future__ import annotations

import dataclasses

import torch


def port_scene(sd):
    """The program's host Scene of a ``SceneData``."""
    from tpurt_torch.scene.types import Instance, Material, Mesh, Scene

    scene = Scene(name=sd.name, background=tuple(sd.background))
    for m in sd.materials:
        scene.add_material(Material(kind=m.kind, albedo=tuple(m.albedo),
                                    emission=tuple(m.emission),
                                    param0=m.param0, param1=m.param1,
                                    name=m.name))
    for m in sd.meshes:
        scene.add_mesh(Mesh(m.vertices, m.indices, m.material_ids,
                            normals=m.normals, name=m.name))
    for inst in sd.instances:
        scene.add_instance(Instance(inst.mesh_id, inst.transform,
                                    name=inst.name))
    scene.camera = port_camera(sd.camera)
    return scene


def port_camera(c):
    from tpurt_torch.core.camera import Camera

    return Camera.make(c.position, c.look_at, c.up, c.vfov_deg)


def render_config(render: dict):
    """The program's RenderConfig of the configuration's ``render`` keys
    (the traffic's overrides merged in)."""
    from tpurt_torch.utils.config import RenderConfig

    return RenderConfig(**render)


def load_kernels(device) -> None:
    """Build (first run in a checkout) or load the program's kernels."""
    if device.type == "cuda":
        from tpurt_torch.kernels import cuda_build

        cuda_build.load()


def build_context(config, scene, device) -> None:
    """Upload the scene and build its accel: the program's scene context,
    which ``render_scene`` then finds cached."""
    from tpurt_torch.render import _scene_context

    _scene_context(config, scene, device)


def free_program_state() -> None:
    """Drop the program's cached scene context, its renderer and graphs."""
    import gc

    from tpurt_torch.render import _SCENE_CACHE

    _SCENE_CACHE.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Driver:
    """Renders and delivers units of one traffic mix."""

    def __init__(self, config, scene, mix: dict, device):
        self.config = config  # RenderConfig of the cell
        self.scene = scene  # the program's host Scene
        self.mix = mix
        self.device = device
        self.state = None
        self.rays = 0.0  # rays the program counted

    def run(self, unit):
        """Render and deliver ``unit``: the delivered image (mean radiance
        on the card, or host uint8) and the number of batches rendered."""
        config = dataclasses.replace(self.config, seed=unit.seed,
                                     spp=unit.samples)
        from tpurt_torch.render import render_scene

        state = None if unit.first else self.state
        start = 0 if state is None else int(state.batch_index)
        out, stats = render_scene(config, scene=self.scene, state=state,
                                  device=self.device)
        self.rays += stats["rays_traced"]
        self.state = out
        return self._deliver(out), int(out.batch_index) - start

    def _deliver(self, state):
        from tpurt_torch.render import framebuffer as fb

        if self.mix["deliver"] == "host_u8":
            return fb.pack_u8(fb.tonemap(fb.resolve(state),
                                         self.config.exposure)).cpu()
        return fb.resolve(state)


def launch_counts() -> dict:
    from tpurt_torch import kernels

    return kernels.launch_counts()


def reset_launch_counts() -> None:
    from tpurt_torch import kernels

    kernels.reset_launch_counts()
