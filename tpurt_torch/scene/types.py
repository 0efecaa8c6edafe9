"""Host-side scene/state API — port of ``tpurt.scene.types``.

The reference holds meshes, materials, instances (transform + mesh id +
material id) and a camera behind a scene/state API (BASELINE.json:5; exact
reference names unverifiable — mount empty, SURVEY.md §0). These classes are
that API for the rebuild: plain numpy on the host, converted once to a SoA
device pytree by :func:`tpurt_torch.scene.device.to_device` (SURVEY.md §3.4).

Material model (fixed for the whole framework, BASELINE.json:8–10):
  kind 0 LAMBERT      albedo;                     (Cornell box walls)
  kind 1 BLINN_PHONG  albedo + specular/shininess (bunny demo)
  kind 2 MIRROR       albedo = reflection tint    (1-bounce mirror, glossy=fuzz)
  kind 3 DIELECTRIC   ior + albedo tint           (glass, path-tracer config)
Any material may also carry ``emission`` (area lights are emissive
triangles; next-event estimation samples them directly).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from tpurt_torch.core.camera import Camera

LAMBERT = 0
BLINN_PHONG = 1
MIRROR = 2
DIELECTRIC = 3

MATERIAL_KIND_NAMES = {
    LAMBERT: "lambert",
    BLINN_PHONG: "blinn_phong",
    MIRROR: "mirror",
    DIELECTRIC: "dielectric",
}


@dataclasses.dataclass
class Material:
    """One material record. ``param0``/``param1`` meaning depends on kind:
    BLINN_PHONG: param0 = shininess exponent, param1 = specular strength;
    MIRROR:      param0 = fuzz (0 = perfect mirror, >0 = glossy);
    DIELECTRIC:  param0 = index of refraction."""

    kind: int = LAMBERT
    albedo: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    param0: float = 0.0
    param1: float = 0.0
    # Base-color texture (index into Scene.textures, -1 = none). Sampled
    # at the interpolated UV and MULTIPLIED into albedo — the glTF 2.0
    # baseColorTexture x baseColorFactor convention.
    base_color_texture: int = -1
    # Alpha-cutout threshold (glTF alphaMode=MASK + alphaCutoff): > 0
    # makes the material alpha-TESTED — texels whose base-color alpha is
    # below the cutoff neither shade nor occlude (foliage/fence cards,
    # SURVEY.md G4 "alpha/shadow filtering"). 0 = opaque (default).
    alpha_cutoff: float = 0.0
    name: str = ""

    def is_emissive(self) -> bool:
        return any(e > 0.0 for e in self.emission)


@dataclasses.dataclass
class Mesh:
    """Indexed triangle mesh. ``material_ids`` maps each triangle to a scene
    material (per-triangle, so a single Cornell-box mesh can mix wall
    colors); scalar broadcast allowed at construction."""

    vertices: np.ndarray  # (V, 3) f32
    indices: np.ndarray  # (T, 3) i32
    material_ids: np.ndarray  # (T,) i32
    normals: Optional[np.ndarray] = None  # (V, 3) f32, optional shading normals
    uvs: Optional[np.ndarray] = None  # (V, 2) f32 texture coordinates
    name: str = ""

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, np.float32)
        self.indices = np.ascontiguousarray(self.indices, np.int32)
        mat = np.asarray(self.material_ids, np.int32)
        if mat.ndim == 0:
            mat = np.full((self.indices.shape[0],), int(mat), np.int32)
        self.material_ids = mat
        if self.normals is not None:
            self.normals = np.ascontiguousarray(self.normals, np.float32)
        if self.uvs is not None:
            self.uvs = np.ascontiguousarray(self.uvs, np.float32)
            assert self.uvs.shape == (self.vertices.shape[0], 2)
        assert self.vertices.ndim == 2 and self.vertices.shape[1] == 3
        assert self.indices.ndim == 2 and self.indices.shape[1] == 3
        assert self.material_ids.shape == (self.indices.shape[0],)

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

    def compute_vertex_normals(self) -> np.ndarray:
        """Area-weighted smooth vertex normals (used when a loader supplies
        none — matches the common OBJ fallback)."""
        v = self.vertices
        i = self.indices
        fn = np.cross(v[i[:, 1]] - v[i[:, 0]], v[i[:, 2]] - v[i[:, 0]])
        n = np.zeros_like(v)
        for k in range(3):
            np.add.at(n, i[:, k], fn)
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        return (n / np.maximum(ln, 1e-20)).astype(np.float32)


def identity_transform() -> np.ndarray:
    return np.eye(3, 4, dtype=np.float32)


def make_transform(translate=(0, 0, 0), rotate_y: float = 0.0,
                   scale=1.0) -> np.ndarray:
    """Convenience TRS helper → (3, 4) row-major affine (world = M @ [p;1])."""
    c, s = np.cos(rotate_y), np.sin(rotate_y)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    sc = np.asarray(scale, np.float32) * np.ones(3, np.float32)
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = r * sc[None, :]
    m[:, 3] = translate
    return m


@dataclasses.dataclass
class Instance:
    """One placed mesh: 3x4 affine transform + mesh id (+ optional material
    override applied to every triangle). Mirrors the role of
    VkAccelerationStructureInstanceKHR in the reference's TLAS
    (SURVEY.md §2.1 C9 [VK-API])."""

    mesh_id: int
    transform: np.ndarray = dataclasses.field(default_factory=identity_transform)
    material_override: int = -1  # -1 = use per-triangle mesh materials
    name: str = ""

    def __post_init__(self):
        self.transform = np.ascontiguousarray(self.transform, np.float32)
        assert self.transform.shape == (3, 4)


@dataclasses.dataclass
class Scene:
    """The scene/state API root (SURVEY.md §2.1 C7)."""

    meshes: List[Mesh] = dataclasses.field(default_factory=list)
    materials: List[Material] = dataclasses.field(default_factory=list)
    instances: List[Instance] = dataclasses.field(default_factory=list)
    camera: Optional[Camera] = None
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # Base-color textures: (H, W, 3) or (H, W, 4) f32 LINEAR-space arrays
    # (alpha channel linear, used by alpha-cutout materials), indexed by
    # Material.base_color_texture (loaders convert sRGB PNGs on decode).
    textures: List[np.ndarray] = dataclasses.field(default_factory=list)
    name: str = ""

    def add_texture(self, image: np.ndarray) -> int:
        img = np.ascontiguousarray(image, np.float32)
        assert img.ndim == 3 and img.shape[2] in (3, 4), \
            "textures are (H, W, 3|4)"
        self.textures.append(img)
        return len(self.textures) - 1

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_material(self, material: Material) -> int:
        self.materials.append(material)
        return len(self.materials) - 1

    def add_instance(self, instance: Instance) -> int:
        self.instances.append(instance)
        return len(self.instances) - 1

    @property
    def num_triangles(self) -> int:
        """Total unique triangles across meshes (not counting instancing)."""
        return sum(m.num_triangles for m in self.meshes)

    def validate(self) -> None:
        n_mat = len(self.materials)
        n_mesh = len(self.meshes)
        for m in self.meshes:
            if m.num_triangles and (
                m.material_ids.min() < 0 or m.material_ids.max() >= n_mat
            ):
                raise ValueError(f"mesh {m.name!r}: material id out of range")
            if m.num_triangles and m.indices.max() >= m.vertices.shape[0]:
                raise ValueError(f"mesh {m.name!r}: vertex index out of range")
        for inst in self.instances:
            if not (0 <= inst.mesh_id < n_mesh):
                raise ValueError(f"instance {inst.name!r}: bad mesh id")
            if inst.material_override >= n_mat:
                raise ValueError(f"instance {inst.name!r}: bad material override")
        n_tex = len(self.textures)
        for mat in self.materials:
            if mat.base_color_texture >= n_tex:
                raise ValueError(
                    f"material {mat.name!r}: texture id out of range"
                )
