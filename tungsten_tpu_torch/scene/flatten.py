"""Scene flattening: SceneDocument -> device-resident tables (torch).

Port of the slice subset of tungsten_tpu/scene/flatten.py. The host build
(`flatten_arrays`) is the same numpy code as the JAX package's, so it yields
the same tables: the triangle SoA in BVH leaf order, the packed shading rows
(`shade_pack`, with one virtual row per analytic prim after the T
triangles), the packed material rows (`gpack2`) with the texture kinds
that roughness slots use (`rough_kinds`), the texture table, the env
light with its alias-table Distribution2D, the light table (`lights`: one
row per emissive mesh / quad / cube with its triangle set and area CDF, then
the env light's row; `tri_light` and the last column of `shade_pack` map a
triangle to its light), the camera, the static SceneMeta, the
analytic prim table (`ana`, None without analytic prims) and the
intersector packs the render's dispatch falls through
(integrators/path_tracer.py `_intersect_tris`):
  pbvh8  the BVH8 pack (K3);
  gbvh   the gather pack (K1: an 8-ary tree of 8-triangle leaves, its own
         tree), built over 64 triangles as the JAX flatten builds it;
  pbvh3  the binary pack (K4; it shares pbvh8's plane slabs);
  pbvh   the packet pack (K5);
  ptris  the streaming brute-force pack (K2), always present.
The pbvh8, pbvh3 and pbvh packs come from one binary tree with 128-triangle
leaves. The JAX package builds them only under its TPU VMEM gates (13 MB for
pbvh8 and pbvh3, 10 MB for pbvh, none at 64 triangles or fewer) and leaves
them None otherwise; the port's own flatten always builds them, and a
FlatScene without them (the JAX package's, or `dataclasses.replace(scene,
pbvh8=None, ...)`) renders through the next pack of the fall-through.

`from_arrays(arrays, meta, device)` is the one constructor of FlatScene. It
takes the arrays under the JAX FlatScene's own attribute paths (ARRAY_KEYS),
so the JAX package's flattened scene can be carried across as numpy arrays
and both packages render the very same tables. Each BVH pack and the
analytic table is taken all-or-none (OPTIONAL).

The port supports mesh / quad / cube geometry and analytic sphere / disk /
cylinder prims, each emissive or not (a disk's emission cone included),
every surface BSDF of models/bsdfs/dispatch.py (all but the fibers, the
wrappers with their `gpack3` substrate rows; roughness, ratio, alpha and
thickness scalar or textured; `meta.has_forward` set where a material has a
forward lobe), constant / checker / bitmap textures from PFM, .hdr (or, with
cv2, .exr) and LDR images, the lights of the JAX flatten but the skydome:
area lights, any number of infinite_sphere lights (sampled or not; `envs`
in primitive order, `env` the last, the escape winner), infinite_sphere_cap
lights (the `cap` table) and point lights (the `point` table), every
camera of the JAX package (pinhole, thinlens with a disk, blade, bitmap or
constant aperture, cat-eye and focus pivot, equirectangular, cubemap; the
flatten's camera section, flatten.py:948-1000) and the depth / normal /
albedo output buffers (`meta.aovs`), and the participating media
(homogeneous, exponential, atmosphere and voxel; the medium table `media`,
the per-triangle `tri_med_int` / `tri_med_ext` / `tri_med_override`
permuted with the triangles and followed by the analytic prims' rows,
`meta.has_media` and `meta.camera_medium`; flatten.py:324, 428-430,
518-550, 600-616, 935-939, 1039-1041). The light rows come in the JAX
flatten's order: the area and analytic emitters in primitive order, then the
sampled envs, the sampled caps, the points. Everything else (skydomes, the
fiber BSDFs, ...) raises NotImplementedError naming the missing piece.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..accel.bvh import build_bvh_best
from ..io.meshio import compute_smooth_normals, load_mesh
from ..math import transform as tf
from ..models.bsdfs.dispatch import MaterialTable, build_gpack2, build_gpack3, pack_materials
from ..models.media.media import MediumTable, pack_media_arrays
from ..models.primitives import analytic, tessellate
from ..models.textures.textures import TextureBuilder, TextureTable, texture_from_spec
from ..ops.bvh import BvhPack, build_bvh_pack
from ..ops.bvh2 import Bvh3Pack, build_bvh_pack3
from ..ops.bvh8 import Bvh8Pack, build_bvh_pack8, tri_tree
from ..ops.gather_bvh import GatherBvhPack, build_gather_pack
from ..ops.intersect import TriangleSoA
from ..ops.intersect_stream import TriPack, build_tri_pack
from ..sampling.distributions import Distribution2D
from .load import SceneDocument

DEFAULT_EPSILON = 5e-4  # TraceableScene.hpp:39

# numpy arrays a FlatScene is made from, under the JAX FlatScene's attribute
# paths (getattr along key.split("."); a pack the JAX flatten left out is None)
ENV_KEYS = ("rot", "inv_rot", "tex", "dist.alias_pack", "dist.joint_pdf", "dist.shape")
LIGHT_FIELDS = (  # LightTable's arrays in order, with their numpy types
    ("offset", np.int32), ("count", np.int32), ("cdf_offset", np.int32),
    ("area", np.float32), ("tex", np.int32), ("is_env", np.bool_),
    ("cone_cos", np.float32), ("is_dirac", np.bool_), ("tri_idx", np.int32),
    ("cdf", np.float32), ("apx_avg", np.float32), ("apx_base", np.float32),
    ("apx_e0", np.float32), ("apx_e1", np.float32), ("apx_n", np.float32),
    ("ana_prim", np.int32), ("pt_slot", np.int32), ("env_slot", np.int32),
    ("cap_slot", np.int32), ("apx_cbase", np.float32))
LIGHT_STATICS = ("max_count", "apx_kind", "has_surface", "emit_kinds")
# CameraParams' arrays; the ap_dist ones are None without a bitmap aperture
CAMERA_KEYS = ("rot", "pos", "plane_dist", "aperture_size", "focus_dist", "ap_angle", "cateye",
               "ap_dist.alias_pack", "ap_dist.joint_pdf", "ap_dist.shape")

ARRAY_KEYS = (
    "tris.v0", "tris.e1", "tris.e2", "shade_pack",
    "tri_ng", "tri_uv0", "tri_uv1", "tri_uv2", "tri_light",
    "tri_med_int", "tri_med_ext", "tri_med_override",
    *(f"lights.{k}" for k, _ in LIGHT_FIELDS), *(f"lights.{k}" for k in LIGHT_STATICS),
    "materials.gpack2", "materials.gpack3", "materials.rough_kinds",
    "textures.tpack", "textures.data", "textures.data4",
    *(f"env.{k}" for k in ENV_KEYS),
    "cap.dir", "cap.cos_angle", "cap.radiance", "point.pos", "point.intensity",
    *(f"camera.{k}" for k in CAMERA_KEYS),
    "ptris.tris_t", "ptris.clusters", "ptris.n_tris",
    "pbvh8.boxes", "pbvh8.kid", "pbvh8.order", "pbvh8.planes", "pbvh8.prim_map",
    "gbvh.rows", "gbvh.root", "gbvh.n_rows", "gbvh.depth", "gbvh.n_tris",
    "pbvh3.nf", "pbvh3.ni", "pbvh.nodes", "pbvh.tris", "pbvh.prim_map", "pbvh.n_nodes",
    *(f"ana.{k}" for k, _ in analytic.FIELDS),
)
# groups of ARRAY_KEYS taken all-or-none: None (or absent) where the JAX
# flatten left the pack out, or the scene has no analytic prims
OPTIONAL = ("pbvh8", "gbvh", "pbvh3", "pbvh", "ana")
# besides ARRAY_KEYS, arrays["envs"] lists every env light in primitive
# order (the JAX FlatScene's `envs`), each a dict under ENV_KEYS, and
# arrays["media"] holds the medium table as MediumTable.from_arrays takes it
# (models/media/media.py `pack_media_arrays`, or another table's fields
# read by name into the same dict; absent: a scene without media)
# None in a scene without bitmap textures, without a single-substrate
# wrapper BSDF or with a mixed one (dispatch.build_gpack3), and without a
# bitmap aperture
NULLABLE = ("textures.data4", "materials.gpack3", "camera.ap_dist.alias_pack",
            "camera.ap_dist.joint_pdf", "camera.ap_dist.shape")

_TESSELLATED = {"quad": tessellate.quad, "cube": tessellate.cube}
ANALYTIC = ("sphere", "disk", "cylinder")  # flatten.py's analytic branch
APX_KINDS = ("quad", "sphere", "disk", "point", "const", "none")
LIGHT_PRIMS = ("infinite_sphere", "infinite_sphere_cap", "point")


@dataclass
class CameraParams:
    rot: torch.Tensor  # (3, 3) camera-to-world rotation (columns = x, y, z)
    pos: torch.Tensor  # (3,)
    plane_dist: torch.Tensor  # ()
    aperture_size: torch.Tensor  # () thinlens
    focus_dist: torch.Tensor  # () thinlens
    ap_angle: torch.Tensor  # () blade-aperture rotation (radians)
    cateye: torch.Tensor  # () cat-eye vignetting strength
    ap_dist: Distribution2D | None = None  # over a bitmap aperture's luminance


@dataclass
class LightTable:
    """Lights: per-light triangle sets with area CDFs, and the columns that
    send a row to its analytic prim, point, env or cap (flatten.py
    LightTable)."""

    offset: torch.Tensor  # (L,) start into tri_idx
    count: torch.Tensor  # (L,)
    cdf_offset: torch.Tensor  # (L,) start into cdf (count + 1 entries per light)
    area: torch.Tensor  # (L,) total area
    tex: torch.Tensor  # (L,) emission texture id
    is_env: torch.Tensor  # (L,) bool
    cone_cos: torch.Tensor  # (L,) emission-cone cos (0 = none)
    is_dirac: torch.Tensor  # (L,) bool
    tri_idx: torch.Tensor  # (LT,) global triangle index (post BVH permutation)
    cdf: torch.Tensor  # (LT + L,)
    # approximateRadiance geometry (TraceBase::chooseLight weighting)
    apx_avg: torch.Tensor  # (L,) emission average().max() / const value
    apx_base: torch.Tensor  # (L, 3) quad base
    apx_e0: torch.Tensor  # (L, 3) quad edge0
    apx_e1: torch.Tensor  # (L, 3) quad edge1
    apx_n: torch.Tensor  # (L, 3) quad / disk plane normal
    ana_prim: torch.Tensor  # (L,) analytic prim index, -1 = triangles
    pt_slot: torch.Tensor  # (L,) PointLight row, -1 = not a point light
    env_slot: torch.Tensor  # (L,) FlatScene.envs slot, -1 = not an env
    cap_slot: torch.Tensor  # (L,) CapLight row, -1 = not a cap light
    apx_cbase: torch.Tensor  # (L, 3) disk emission-cone base
    max_count: int  # static: the largest triangle set
    apx_kind: tuple  # static, per light: "quad" | "sphere" | "disk" | "point" | "const" | "none"
    has_surface: bool  # static: some area light exists
    emit_kinds: tuple  # static: texture kinds of the area lights' emission

    @staticmethod
    def from_arrays(arrays: dict, device) -> "LightTable":
        """From numpy arrays under LIGHT_FIELDS' and LIGHT_STATICS' names."""
        kinds = tuple(str(k) for k in np.asarray(arrays["apx_kind"]).tolist())
        for k in kinds:
            if k not in APX_KINDS:
                raise ValueError(f"unknown approximateRadiance kind '{k}'")
        def t(k, dt):  # indices as int64, torch's index type
            return torch.as_tensor(np.array(arrays[k], np.int64 if dt == np.int32 else dt),
                                   device=device)

        return LightTable(
            **{k: t(k, dt) for k, dt in LIGHT_FIELDS},
            max_count=int(np.asarray(arrays["max_count"])), apx_kind=kinds,
            has_surface=bool(np.asarray(arrays["has_surface"])),
            emit_kinds=tuple(int(k) for k in np.asarray(arrays["emit_kinds"]).tolist()))


@dataclass
class EnvLight:
    rot: torch.Tensor  # (3, 3)
    inv_rot: torch.Tensor  # (3, 3)
    tex: int  # emission texture id
    dist: Distribution2D  # over the emission bitmap (sin-weighted, dilated)
    tex_kind: int  # static texture type of `tex`


@dataclass
class CapLight:
    """Directional spherical-cap lights (InfiniteSphereCap.cpp:233-249), a
    table of C caps: axis = the transform's +Y, uniform radiance inside the
    cone. LightTable.cap_slot maps a light row to its cap."""

    dir: torch.Tensor  # (C, 3)
    cos_angle: torch.Tensor  # (C,)
    radiance: torch.Tensor  # (C, 3)


@dataclass
class PointLight:
    """Dirac point lights (Point.cpp): intensity = power / (4 pi), a table
    of P points; LightTable.pt_slot maps a light row to its point."""

    pos: torch.Tensor  # (P, 3)
    intensity: torch.Tensor  # (P, 3)


def _default_point() -> dict:
    return {"pos": np.zeros((1, 3), np.float32), "intensity": np.zeros((1, 3), np.float32)}


def _default_cap() -> dict:
    return {"dir": np.array([[0.0, 1.0, 0.0]], np.float32),
            "cos_angle": np.ones((1,), np.float32), "radiance": np.zeros((1, 3), np.float32)}


@dataclass(frozen=True)
class SceneMeta:
    """Static scene facts: the fields of flatten.py SceneMeta."""

    res_x: int
    res_y: int
    camera_type: str
    tonemap: str
    filter: str
    fov_deg: float
    n_lights: int
    has_env: bool
    env_light_index: int
    env_is_constant: bool
    min_bounces: int
    max_bounces: int
    enable_light_sampling: bool
    enable_volume_light_sampling: bool
    low_order_scattering: bool
    include_surfaces: bool
    enable_two_sided: bool
    has_media: bool
    has_forward: bool
    camera_medium: int
    spp: int
    spp_step: int
    use_bvh: bool
    aovs: tuple = ()
    stratified: bool = False
    has_cap: bool = False
    cap_light_index: int = -1
    cap_after_env: bool = False
    n_envs: int = 0
    env_const: tuple = ()
    env_light_idx: tuple = ()
    n_caps: int = 0
    cap_light_idx: tuple = ()
    esc_caps: tuple = ()
    point_light_index: int = -1
    aperture_kind: str = "disk"
    ap_blades: int = 6
    cateye: float = 0.0
    has_fiber_tan: bool = False
    has_analytic: bool = False
    bdpt_max_vertices: int = 16


@dataclass
class FlatScene:
    tris: TriangleSoA
    # (T, 20) packed shading row [ng | n0 n1 n2 | uv0 uv1 uv2 | mat | light]
    shade_pack: torch.Tensor
    tri_ng: torch.Tensor  # (T, 3) geometric normal (winding)
    tri_uv0: torch.Tensor  # (T, 2)
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_light: torch.Tensor  # (T,) int64 (-1 = not emissive)
    # per triangle (and analytic prim row): the interior / exterior medium
    # (-1 = vacuum) and whether the primitive overrides media
    # (Primitive::overridesMedia)
    tri_med_int: torch.Tensor  # (T,) int64
    tri_med_ext: torch.Tensor  # (T,) int64
    tri_med_override: torch.Tensor  # (T,) bool
    media: MediumTable
    lights: LightTable
    materials: MaterialTable
    textures: TextureTable
    env: EnvLight
    camera: CameraParams
    ptris: TriPack
    pbvh8: Bvh8Pack | None
    gbvh: GatherBvhPack | None
    pbvh3: Bvh3Pack | None
    pbvh: BvhPack | None
    ana: analytic.AnalyticTable | None
    meta: SceneMeta
    cap: CapLight
    point: PointLight
    # every env light in primitive order (env is envs[-1], the escape winner;
    # the earlier ones are sampled through LightTable.env_slot)
    envs: tuple = ()


# the BDPT subpath vertex cap where the scene sets no "bdpt_max_vertices":
# the (s, t) families grow ~K^2/2 (flatten.py:275-280)
BDPT_DEFAULT_CEIL = 16


def _bdpt_cap(integ: dict) -> int:
    """BDPT's subpath vertex cap (flatten.py:283-310): the integrator's
    "bdpt_max_vertices", else max_bounces + 1 up to BDPT_DEFAULT_CEIL; the
    reference never truncates a subpath (BidirectionalPathTracer.cpp:14-15),
    so a BDPT or MLT scene cut by the ceiling gets the JAX package's
    warning."""
    want = int(integ.get("max_bounces", 64)) + 1
    explicit = integ.get("bdpt_max_vertices")
    if explicit is not None:
        return int(explicit)
    cap = min(want, BDPT_DEFAULT_CEIL)
    if want > cap and integ.get("type") in ("bidirectional_path_tracer", "kelemen_mlt",
                                            "multiplexed_mlt", "reversible_jump_mlt"):
        warnings.warn(
            f"BDPT subpath vertices capped at {cap} (< max_bounces+1 = "
            f"{want}): transport beyond {cap - 1} bounces is truncated. "
            "Set integrator 'bdpt_max_vertices' to raise the cap "
            "(compile/sample cost grows ~K^2/2).", stacklevel=2)
    return cap


def _check_slice(doc: SceneDocument):
    """Raise NotImplementedError for every scene feature the port lacks:
    skydome lights, and primitives other than mesh / quad / cube / sphere /
    disk / cylinder and the infinite_sphere, infinite_sphere_cap and point
    lights. BSDF types (dispatch.pack_materials), textures
    (texture_from_spec), image formats (io/imageio.py) and media
    (media.pack_media_arrays: homogeneous, exponential, atmosphere and voxel
    pass) are checked where they are packed; every surface BSDF but the
    fibers, textured parameters, .hdr images, every camera and filter and
    the depth / normal / albedo output buffers pass."""
    for prim in doc.primitives:
        ptype = prim.get("type", "mesh")
        if ptype == "skydome":
            raise NotImplementedError("'skydome' lights are not ported")
        if ptype not in ("mesh", "quad", "cube") + ANALYTIC + LIGHT_PRIMS:
            raise NotImplementedError(f"primitive type '{ptype}' is not ported")


def _apx_geometry(ptype: str, m: np.ndarray, prim: dict) -> dict:
    """approximateRadiance geometry of an emissive quad, sphere or disk
    (flatten.py:351-382; Quad.cpp:256-281, Sphere.cpp:266-271,
    Disk.cpp:268-295): base, the edges or radii, the plane normal and a
    disk's emission-cone base. Other prims weigh as "none" (a uniform share)."""
    r3 = m[:3, :3]
    zero3 = np.zeros(3)
    if ptype == "quad":
        e0 = r3 @ np.array([1.0, 0.0, 0.0])
        e1 = r3 @ np.array([0.0, 0.0, 1.0])
        nq = np.cross(e1, e0)
        return dict(kind="quad", base=m[:3, 3] - 0.5 * e0 - 0.5 * e1, e0=e0, e1=e1,
                    n=nq / max(np.linalg.norm(nq), 1e-30), cbase=zero3)
    scale = np.linalg.norm(r3, axis=0)
    if ptype == "sphere":
        return dict(kind="sphere", base=m[:3, 3], e0=np.array([float(scale.max()), 0.0, 0.0]),
                    e1=zero3, n=zero3, cbase=zero3)
    r = float(max(scale[0], scale[2]))
    nd = r3 @ np.array([0.0, 1.0, 0.0])
    nd = nd / max(np.linalg.norm(nd), 1e-30)
    ca = np.deg2rad(float(prim.get("cone_angle", 90.0)))
    td, bd = analytic._tangent_frame(nd)
    return dict(kind="disk", base=m[:3, 3], e0=td * r, e1=bd * r, n=nd,
                cbase=m[:3, 3] - nd / max(np.sin(ca), 1e-9))


# a light row's fields where the row does not give them (and the one row of a
# scene without lights)
_LIGHT_DEFAULTS = dict(area=1.0, is_env=False, cone_cos=0.0, is_dirac=False, ana_prim=-1,
                       pt_slot=-1, env_slot=-1, cap_slot=-1, apx_avg=0.0, apx_base=None,
                       apx_e0=None, apx_e1=None, apx_n=None, apx_cbase=None)


def _light_row(tri_idx_list, cdf_list, count=0, tex=0, kind="none", avg=0.0, base=None,
               e0=None, e1=None, n=None, cbase=None, **fields) -> dict:
    """One light row (flatten.py's l_* lists): its triangle set starts after
    the sets listed so far; the fields it does not give take _LIGHT_DEFAULTS."""
    return {**_LIGHT_DEFAULTS, "offset": sum(len(x) for x in tri_idx_list), "count": count,
            "cdf_offset": sum(len(x) for x in cdf_list), "tex": tex, "kind": kind,
            "apx_avg": avg, "apx_base": base, "apx_e0": e0, "apx_e1": e1, "apx_n": n,
            "apx_cbase": cbase, **fields}


def _default_env(tex: int) -> dict:
    """flatten.py _default_env: a black constant env (the arrays of `env`
    in a scene without one)."""
    dist = Distribution2D.build_arrays(np.ones((1, 1), np.float32))
    return {"rot": np.eye(3, dtype=np.float32), "inv_rot": np.eye(3, dtype=np.float32),
            "tex": np.int32(tex), "dist.alias_pack": dist["alias_pack"],
            "dist.joint_pdf": dist["joint_pdf"], "dist.shape": np.asarray(dist["shape"])}


def _env_weights(img: np.ndarray) -> np.ndarray:
    """Env importance weights: max-channel * sin(theta), 3x3 max-dilated
    with wraparound (flatten.py _env_weights)."""
    h = img.shape[0]
    w = img.max(axis=-1)
    row_theta = np.sin(np.arange(h) * np.pi / h)
    w = w * row_theta[:, None]
    w = np.maximum(np.maximum(np.roll(w, 1, 1), np.roll(w, -1, 1)), w)
    w = np.maximum(np.maximum(np.roll(w, 1, 0), np.roll(w, -1, 0)), w)
    return w.astype(np.float32)


def _camera_arrays(doc: SceneDocument, cam_m: np.ndarray) -> tuple:
    """The thinlens fields (ThinlensCamera.cpp:55-100; flatten.py:959-1000):
    aperture size, focus distance (from a named primitive's origin where
    `focus_pivot` names one, ThinlensCamera.cpp:206-217), the aperture's
    kind (disk, blade, bitmap or const), blade count and angle, the cat-eye
    strength, and a bitmap aperture's Distribution2D arrays. Returns (the
    camera arrays under CAMERA_KEYS' names, the aperture kind, the blade
    count); the last two are SceneMeta's."""
    cam = doc.camera
    focus_dist = float(cam.get("focus_distance", 1.0))
    pivot = cam.get("focus_pivot")
    if pivot:
        for p in doc.primitives:
            if p.get("name") == pivot:
                pm = tf.mat4_from_json(p.get("transform"))
                focus_dist = float(np.linalg.norm(pm[:3, 3] - cam_m[:3, 3]))
                break
    ap_spec = cam.get("aperture")
    # 0.593412: the JAX package's blade angle, a known caveat (ROADMAP §3)
    kind, blades, angle, dist = "disk", 6, 0.593412, {}
    if isinstance(ap_spec, str):
        from ..io.imageio import load_image

        img = np.asarray(load_image(doc.resolve_path(ap_spec)), np.float32)
        lum = img.mean(-1) if img.ndim == 3 else img
        dist = Distribution2D.build_arrays(np.maximum(lum, 0.0))
        kind = "bitmap"
    elif isinstance(ap_spec, dict):
        t = ap_spec.get("type", "disk")
        if t == "blade":
            kind = "blade"
            blades = int(ap_spec.get("blades", 6))
            angle = float(ap_spec.get("angle", 0.593412))
        elif t == "constant":
            kind = "const"
        # any other texture type keeps the uniform-disk default
    elif isinstance(ap_spec, (int, float)):
        kind = "const"
    arrays = {"aperture_size": np.float32(cam.get("aperture_size", 0.001)),
              "focus_dist": np.float32(focus_dist), "ap_angle": np.float32(angle),
              "cateye": np.float32(cam.get("cateye", 0.0)),
              **{f"ap_dist.{k}": dist.get(k) for k in ("alias_pack", "joint_pdf", "shape")}}
    return arrays, kind, blades


def flatten_arrays(doc: SceneDocument):
    """Host build: SceneDocument -> ({ARRAY_KEYS: numpy}, SceneMeta)."""
    _check_slice(doc)
    tex_builder = TextureBuilder()

    # ---- geometry (flatten.py primitive loop: tessellated and analytic) ----
    pos_l, n_l, uv_l, idx_l, mat_l, prim_l = [], [], [], [], [], []
    med_int_l, med_ext_l, med_ov_l = [], [], []  # per triangle (flatten.py:324)
    emissive_prims = []  # primitive indices of the area / analytic lights, in order
    prim_apx = {}  # primitive index -> approximateRadiance geometry
    prim_cone_cos = {}  # primitive index -> a disk's emission-cone cos
    env_specs, cap_specs, point_specs = [], [], []  # in primitive order
    ana_entries = []  # analytic prims in primitive order (virtual ids T + k)
    ana_prim_of = {}  # primitive index -> analytic index
    vert_base = 0
    for pi, prim in enumerate(doc.primitives):
        ptype = prim.get("type", "mesh")
        m = tf.mat4_from_json(prim.get("transform"))
        emissive = "emission" in prim or "power" in prim
        if ptype == "infinite_sphere":
            if emissive:
                env_specs.append((prim, m, pi))
            continue
        if ptype == "point":
            point_specs.append((prim, m))
            continue
        if ptype == "infinite_sphere_cap":
            cap_specs.append((prim, m, pi))
            continue
        if emissive and ptype in ("quad", "sphere", "disk"):
            prim_apx[pi] = _apx_geometry(ptype, m, prim)
        if ptype == "disk":
            ca = float(prim.get("cone_angle", 90.0))
            if ca < 90.0:
                prim_cone_cos[pi] = float(np.cos(np.deg2rad(ca)))
        if ptype in ANALYTIC:
            entry = analytic.extract_params(ptype, m, prim)
            entry["_mat"] = prim["_bsdf_index"]
            entry["_med_int"] = prim.get("_int_medium", -1)
            entry["_med_ext"] = prim.get("_ext_medium", -1)
            ana_prim_of[pi] = len(ana_entries)
            ana_entries.append(entry)
            if emissive:
                emissive_prims.append(pi)
            continue
        if ptype == "mesh":
            mesh = load_mesh(doc.resolve_path(prim["file"]))
            smooth = prim.get("smooth", True)
            if prim.get("recompute_normals", False) or (smooth and not np.any(mesh.normal)):
                compute_smooth_normals(mesh)
            soup = tessellate.TriSoup(pos=mesh.pos, normal=mesh.normal if smooth else None,
                                      uv=mesh.uv, indices=mesh.indices)
        else:
            soup = _TESSELLATED[ptype]()
        if emissive:
            emissive_prims.append(pi)
        wpos = tf.transform_point(m, soup.pos).astype(np.float32)
        if soup.normal is not None:
            wn = tf.transform_normal(m, soup.normal)
            lens = np.linalg.norm(wn, axis=-1, keepdims=True)
            wn = np.where(lens > 1e-20, wn / np.maximum(lens, 1e-20), 0.0).astype(np.float32)
        else:
            wn = None
        pos_l.append(wpos)
        n_l.append(wn)
        uv_l.append(soup.uv.astype(np.float32))
        idx_l.append(soup.indices + vert_base)
        mat_l.append(np.full(len(soup.indices), prim["_bsdf_index"], np.int32))
        prim_l.append(np.full(len(soup.indices), pi, np.int32))
        nt = len(soup.indices)
        mi, me = prim.get("_int_medium", -1), prim.get("_ext_medium", -1)
        med_int_l.append(np.full(nt, mi, np.int32))
        med_ext_l.append(np.full(nt, me, np.int32))
        med_ov_l.append(np.full(nt, mi >= 0 or me >= 0, bool))
        vert_base += len(wpos)
    if not idx_l:
        if not ana_entries:
            raise ValueError("scene has no finite geometry")
        # all-analytic scene: one degenerate far-away triangle keeps the
        # triangle tables and packs well-formed (never hit)
        pos_l.append(np.full((3, 3), 2.0e37, np.float32))
        n_l.append(None)
        uv_l.append(np.zeros((3, 2), np.float32))
        idx_l.append(np.arange(3, dtype=np.int32)[None, :])
        mat_l.append(np.zeros(1, np.int32))
        prim_l.append(np.full(1, -1, np.int32))
        med_int_l.append(np.full(1, -1, np.int32))
        med_ext_l.append(np.full(1, -1, np.int32))
        med_ov_l.append(np.zeros(1, bool))

    all_pos = np.concatenate(pos_l)
    all_uv = np.concatenate(uv_l)
    indices = np.concatenate(idx_l)
    tri_mat = np.concatenate(mat_l)
    tri_prim = np.concatenate(prim_l)
    tri_med_int = np.concatenate(med_int_l)
    tri_med_ext = np.concatenate(med_ext_l)
    tri_med_ov = np.concatenate(med_ov_l)
    p0, p1, p2 = (all_pos[indices[:, k]] for k in range(3))
    face_n = np.cross(p1 - p0, p2 - p0)
    face_area = 0.5 * np.linalg.norm(face_n, axis=-1)
    norm = np.linalg.norm(face_n, axis=-1, keepdims=True)
    tri_ng = (face_n / np.maximum(norm, 1e-30)).astype(np.float32)

    # shading normals: vertex normals where present, face normal otherwise
    all_n = np.zeros_like(all_pos)
    off = 0
    for wpos, wn in zip(pos_l, n_l):
        if wn is not None:
            all_n[off: off + len(wpos)] = wn
        off += len(wpos)
    n0, n1, n2 = (all_n[indices[:, k]] for k in range(3))
    missing = (np.linalg.norm(n0, axis=-1) < 0.5)[:, None]
    n0 = np.where(missing, tri_ng, n0)
    n1 = np.where(missing, tri_ng, n1)
    n2 = np.where(missing, tri_ng, n2)

    # ---- BVH leaf order (the binary leaf-4 tree fixes the permutation) ----
    bvh = build_bvh_best(np.minimum(np.minimum(p0, p1), p2), np.maximum(np.maximum(p0, p1), p2))
    perm = bvh.prim_order

    def permute(a):
        return np.ascontiguousarray(a[perm])

    p0, p1, p2 = permute(p0), permute(p1), permute(p2)
    tri_ng = permute(tri_ng)
    n0, n1, n2 = permute(n0), permute(n1), permute(n2)
    uv0, uv1, uv2 = (permute(all_uv[indices[:, k]]) for k in range(3))
    tri_mat = permute(tri_mat)
    tri_prim = permute(tri_prim)
    face_area = permute(face_area)
    tri_med_int, tri_med_ext, tri_med_ov = (permute(a) for a in (tri_med_int, tri_med_ext,
                                                                   tri_med_ov))

    # ---- materials, textures, lights (flatten.py:606-920, in its order, so
    # the texture ids come out the same) ----
    mats = pack_materials(doc.bsdfs, tex_builder)

    def prim_origin(name):
        """The transform origin of the named primitive (an atmosphere's
        "pivot", AtmosphericMedium.cpp:63-70); None where none is named so."""
        for p in doc.primitives:
            if p.get("name") == name:
                return tf.mat4_from_json(p.get("transform"))[:3, 3]
        return None

    media = pack_media_arrays(doc.media, resolve=doc.resolve_path, prim_origin=prim_origin)

    def emission_tex(prim, area):
        if "power" in prim:  # power * powerToRadianceFactor: 1 / (pi area)
            pw = np.asarray(prim["power"], np.float64)
            if pw.ndim == 0:
                pw = np.repeat(pw, 3)
            return tex_builder.add_constant((pw / (np.pi * area)).astype(np.float32))
        return texture_from_spec(prim["emission"], tex_builder, doc.resolve_path)

    # one light row per emissive primitive: its triangles (ids after the BVH
    # permutation) and their area CDF, or its analytic prim (no triangles)
    tri_light = np.full(len(tri_mat), -1, np.int32)
    rows = []  # one dict per light row (_light_row's fields)
    tri_idx_list, cdf_list = [], []
    for pi in emissive_prims:
        prim = doc.primitives[pi]
        if pi in ana_prim_of:
            k = ana_prim_of[pi]
            total = float(ana_entries[k]["area"])
            ana_entries[k]["_light"] = len(rows)
            sel, cdf = None, None
        else:
            sel = np.nonzero(tri_prim == pi)[0].astype(np.int32)
            total = float(face_area[sel].sum())
            if len(sel) == 0 or total <= 0:
                continue
            tri_light[sel] = len(rows)
            cdf = np.concatenate([[0.0], np.cumsum(face_area[sel] / total)]).astype(np.float32)
            cdf[-1] = 1.0
        tex_id = emission_tex(prim, total)
        apx = prim_apx.get(pi)
        rows.append(_light_row(
            tri_idx_list, cdf_list, count=0 if sel is None else len(sel), area=total, tex=tex_id,
            cone_cos=prim_cone_cos.get(pi, 0.0), ana_prim=ana_prim_of.get(pi, -1),
            avg=float(np.max(tex_builder.average(tex_id))) if apx else 0.0, **(apx or {})))
        if sel is not None:
            tri_idx_list.append(sel)
            cdf_list.append(cdf)

    # env lights in primitive order (flatten.py:724-797): the last one is the
    # escape winner (`env`); each samplable one has a light row. The default
    # env's black texture comes first, as flatten.py's _default_env adds it
    default_tex = tex_builder.add_constant([0.0, 0.0, 0.0])
    envs, env_const, env_light_idx = [], [], []
    for slot, (prim, m, _) in enumerate(env_specs):
        rot = m[:3, :3].astype(np.float64)
        rot = rot / np.maximum(np.linalg.norm(rot, axis=0, keepdims=True), 1e-30)
        etex = emission_tex(prim, 1.0)
        is_const = not isinstance(prim.get("emission"), str)
        weights = (np.ones((1, 1), np.float32) if is_const
                   else _env_weights(tex_builder.image(etex)))
        dist = Distribution2D.build_arrays(weights)
        envs.append({"rot": rot.astype(np.float32), "inv_rot": rot.T.astype(np.float32),
                     "tex": np.int32(etex), "dist.alias_pack": dist["alias_pack"],
                     "dist.joint_pdf": dist["joint_pdf"], "dist.shape": np.asarray(dist["shape"])})
        env_const.append(is_const)
        if prim.get("sample", True):
            env_light_idx.append(len(rows))
            # InfiniteSphere::approximateRadiance = 2 pi * avg max
            rows.append(_light_row(
                tri_idx_list, cdf_list, tex=etex, is_env=True, env_slot=slot, kind="const",
                avg=float(2.0 * np.pi * np.max(tex_builder.average(etex)))))
        else:
            env_light_idx.append(-1)
    env_prim_index = env_specs[-1][2] if env_specs else -1

    # spherical-cap lights (flatten.py:799-857): a cap can win the escape
    # only where it is listed after the last env
    cap = _default_cap()
    cap_rows, cap_light_idx, esc_caps = [], [], []
    for slot, (prim, m, cap_pi) in enumerate(cap_specs):
        rot = m[:3, :3].astype(np.float64)
        rot = rot / np.maximum(np.linalg.norm(rot, axis=0, keepdims=True), 1e-30)
        cap_dir = rot @ np.array([0.0, 1.0, 0.0])
        cap_dir = cap_dir / max(np.linalg.norm(cap_dir), 1e-30)
        cos_cap = float(np.cos(np.deg2rad(float(prim.get("cap_angle", 10.0)))))
        if "power" in prim:  # power * powerToRadianceFactor = power / (2 pi (1 - cos))
            rad = np.broadcast_to(np.asarray(prim["power"], np.float64), (3,)) / (
                2.0 * np.pi * max(1.0 - cos_cap, 1e-9))
        else:
            rad = np.broadcast_to(np.asarray(prim.get("emission", 1.0), np.float64), (3,))
        cap_rows.append((cap_dir, cos_cap, rad))
        if prim.get("sample", True):
            cap_light_idx.append(len(rows))
            # InfiniteSphereCap::approximateRadiance = 2 pi (1 - cos) avg max
            rows.append(_light_row(tri_idx_list, cdf_list, cap_slot=slot, kind="const",
                                   avg=float(2.0 * np.pi * (1.0 - cos_cap) * np.max(rad))))
        else:
            cap_light_idx.append(-1)
        if cap_pi > env_prim_index:
            esc_caps.append(slot)
    if cap_rows:
        cap = {"dir": np.asarray([c[0] for c in cap_rows], np.float32),
               "cos_angle": np.asarray([c[1] for c in cap_rows], np.float32),
               "radiance": np.asarray([c[2] for c in cap_rows], np.float32)}

    # dirac point lights (flatten.py:859-896): one light row and one
    # PointLight row each
    point = _default_point()
    pt_pos, pt_int = [], []
    for prim, m in point_specs:
        ppos = (m @ np.array([0.0, 0.0, 0.0, 1.0]))[:3]
        pw = np.broadcast_to(np.asarray(prim.get("power", prim.get("emission", 1.0)),
                                        np.float64), (3,))
        # Point::approximateRadiance = intensity.max / r^2
        rows.append(_light_row(tri_idx_list, cdf_list, is_dirac=True, pt_slot=len(pt_pos),
                               kind="point", avg=float(np.max(pw / (4.0 * np.pi))), base=ppos))
        pt_pos.append(ppos)
        pt_int.append(pw / (4.0 * np.pi))
    if pt_pos:
        point = {"pos": np.asarray(pt_pos, np.float32), "intensity": np.asarray(pt_int, np.float32)}
    point_index = next((i for i, r in enumerate(rows) if r["pt_slot"] >= 0), -1)

    n_lights = len(rows)
    surface = [r for r in rows if r["env_slot"] < 0 and r["cap_slot"] < 0 and r["pt_slot"] < 0]
    zero3 = np.zeros(3)
    lights = {k: [r[k] for r in rows] or [_LIGHT_DEFAULTS.get(k, 0)] for k, _ in LIGHT_FIELDS
              if k not in ("tri_idx", "cdf")}  # one default row without lights
    lights.update({
        "tri_idx": np.concatenate(tri_idx_list or [np.zeros(1, np.int32)]),
        "cdf": np.concatenate(cdf_list or [np.array([0.0, 1.0], np.float32)]),
        "max_count": max([r["count"] for r in rows] + [1]),
        "apx_kind": tuple(r["kind"] for r in rows),
        "has_surface": bool(surface),
        "emit_kinds": tex_builder.kinds_of([r["tex"] for r in surface]),
    })
    for k in ("apx_base", "apx_e0", "apx_e1", "apx_n", "apx_cbase"):
        lights[k] = [np.asarray(v, np.float64) if v is not None else zero3 for v in lights[k]]
    lights.update({k: np.asarray(lights[k], dt) for k, dt in LIGHT_FIELDS})

    rough_kinds = np.asarray(tex_builder.kinds_of(tex_builder.rough_ids), np.int32)
    tex = tex_builder.build_arrays()
    gpack2 = build_gpack2(mats, tex["tpack"])
    gpack3 = build_gpack3(mats, gpack2)

    # ---- camera (flatten.py:948-1000) ----
    cam = doc.camera
    cam_m = tf.mat4_from_json(cam.get("transform"))
    cam_m[:3, 0] = -cam_m[:3, 0]  # Camera.cpp:63 setRight(-right)
    fov = float(cam.get("fov", 60.0))
    plane_dist = 1.0 / np.tan(np.deg2rad(fov) * 0.5)
    camera, ap_kind, ap_blades = _camera_arrays(doc, cam_m)

    e1, e2 = p1 - p0, p2 - p0
    tree = tri_tree(p0, e1, e2, leaf_size=128)
    packs = {
        **{f"ptris.{k}": v for k, v in build_tri_pack(p0, e1, e2).items()},
        **{f"pbvh8.{k}": v for k, v in build_bvh_pack8(p0, e1, e2, tree, 128).items()},
        **{f"pbvh3.{k}": v for k, v in build_bvh_pack3(tree).items()},
        **{f"pbvh.{k}": v for k, v in build_bvh_pack(p0, e1, e2, tree).items()},
        "pbvh.n_nodes": len(tree.count),
    }

    if len(p0) > 64:  # the gather pack, over 64 triangles (flatten.py:1073-1077)
        packs.update({f"gbvh.{k}": v for k, v in build_gather_pack(p0, e1, e2).items()})

    # ---- analytic prim table + virtual-id rows (flatten.py:922-946): the
    # shading rows grow by one row per analytic prim (its material, its
    # light row or -1, zero geometry that the integrator overrides at the
    # hit) ----
    ana = analytic.build_table(ana_entries)
    if ana is not None:
        tri_mat = np.concatenate([tri_mat, np.array([e["_mat"] for e in ana_entries], np.int32)])
        z3 = np.zeros((len(ana_entries), 3), np.float32)
        z2 = np.zeros((len(ana_entries), 2), np.float32)
        tri_light = np.concatenate(
            [tri_light, np.array([e.get("_light", -1) for e in ana_entries], np.int32)])
        tri_ng, n0, n1, n2 = (np.concatenate([x, z3]) for x in (tri_ng, n0, n1, n2))
        uv0, uv1, uv2 = (np.concatenate([x, z2]) for x in (uv0, uv1, uv2))
        a_mi = np.array([e["_med_int"] for e in ana_entries], np.int32)
        a_me = np.array([e["_med_ext"] for e in ana_entries], np.int32)
        tri_med_int = np.concatenate([tri_med_int, a_mi])
        tri_med_ext = np.concatenate([tri_med_ext, a_me])
        tri_med_ov = np.concatenate([tri_med_ov, (a_mi >= 0) | (a_me >= 0)])
        packs.update({f"ana.{k}": v for k, v in ana.items()})
    shade_pack = np.concatenate(
        [tri_ng, n0, n1, n2, uv0, uv1, uv2, np.asarray(tri_mat, np.float32)[:, None],
         np.asarray(tri_light, np.float32)[:, None]], axis=1).astype(np.float32)
    arrays = {
        "tris.v0": p0, "tris.e1": e1, "tris.e2": e2, "shade_pack": shade_pack,
        "tri_ng": tri_ng, "tri_uv0": uv0, "tri_uv1": uv1, "tri_uv2": uv2,
        "tri_light": tri_light, "tri_med_int": tri_med_int, "tri_med_ext": tri_med_ext,
        "tri_med_override": tri_med_ov, "media": media,
        **{f"lights.{k}": v for k, v in lights.items()},
        "materials.gpack2": gpack2, "materials.gpack3": gpack3,
        "materials.rough_kinds": rough_kinds,
        "textures.tpack": tex["tpack"], "textures.data": tex["data"],
        "textures.data4": tex["data4"],
        **{f"env.{k}": v for k, v in (envs[-1] if envs else _default_env(default_tex)).items()},
        "envs": envs,
        **{f"cap.{k}": v for k, v in cap.items()}, **{f"point.{k}": v for k, v in point.items()},
        "camera.rot": cam_m[:3, :3].astype(np.float32),
        "camera.pos": cam_m[:3, 3].astype(np.float32),
        "camera.plane_dist": np.float32(plane_dist),
        **{f"camera.{k}": v for k, v in camera.items()},
        **packs,
    }

    res = cam.get("resolution", [1000, 563])
    if isinstance(res, (int, float)):
        res = [int(res), int(res)]
    integ = doc.integrator
    max_b = int(integ.get("max_bounces", 64))
    meta = SceneMeta(
        res_x=int(res[0]), res_y=int(res[1]),
        camera_type=cam.get("type", "pinhole"), tonemap=cam.get("tonemap", "gamma"),
        filter=cam.get("reconstruction_filter", "tent"), fov_deg=fov,
        n_lights=n_lights, has_env=bool(env_specs),
        env_light_index=env_light_idx[-1] if envs else -1,
        env_is_constant=env_const[-1] if envs else True,
        stratified=bool(doc.renderer.get("stratified_sampler", False)),
        has_cap=bool(cap_specs),
        cap_light_index=next((i for i in cap_light_idx if i >= 0), -1),
        cap_after_env=bool(esc_caps), n_envs=len(envs), env_const=tuple(env_const),
        env_light_idx=tuple(env_light_idx), n_caps=len(cap_specs),
        cap_light_idx=tuple(cap_light_idx), esc_caps=tuple(esc_caps),
        point_light_index=point_index,
        aperture_kind=ap_kind, ap_blades=ap_blades,
        cateye=float(cam.get("cateye", 0.0)),
        min_bounces=int(integ.get("min_bounces", 0)), max_bounces=max_b,
        enable_light_sampling=bool(integ.get("enable_light_sampling", True)),
        enable_volume_light_sampling=bool(integ.get("enable_volume_light_sampling", True)),
        low_order_scattering=bool(integ.get("low_order_scattering", True)),
        include_surfaces=bool(integ.get("include_surfaces", True)),
        enable_two_sided=bool(integ.get("enable_two_sided_shading", True)),
        has_media=len(doc.media) > 0, has_forward=bool(np.any(mats["lobes"] & 0x80)),
        camera_medium=(int(doc.medium_names.get(cam.get("medium"), -1))
                       if isinstance(cam.get("medium"), str) else -1),
        spp=int(doc.renderer.get("spp", 32)),
        spp_step=int(doc.renderer.get("spp_step", 16)),
        use_bvh=bool(doc.renderer.get("scene_bvh", True)),
        bdpt_max_vertices=_bdpt_cap(integ),
        has_analytic=ana is not None,
        aovs=tuple((b.get("type"), b.get("output_file", ""), b.get("hdr_output_file", ""))
                   for b in doc.renderer.get("output_buffers", [])
                   if b.get("type") in ("depth", "normal", "albedo")),
    )
    return arrays, meta


def _group(key: str) -> str:
    return key.split(".", 1)[0]


def from_arrays(arrays: dict, meta, device) -> FlatScene:
    """FlatScene on `device` from numpy arrays under ARRAY_KEYS (and the env
    lights under "envs", each a dict under ENV_KEYS) and a meta object with
    SceneMeta's fields (the port's or the JAX package's). An OPTIONAL group
    whose arrays are all absent or None gives None; one that is partly
    given raises KeyError, as does a missing required array or an "envs" list
    whose length is not meta.n_envs."""
    given = {k for k in ARRAY_KEYS if arrays.get(k) is not None}
    missing = [k for k in ARRAY_KEYS
               if k not in given and _group(k) not in OPTIONAL and k not in NULLABLE]
    partial = sorted({_group(k) for k in ARRAY_KEYS if _group(k) in OPTIONAL and k not in given}
                     & {_group(k) for k in given})
    if missing or partial:
        raise KeyError(f"from_arrays: missing arrays {missing}, partial groups {partial}")
    has = {g: any(_group(k) == g for k in given) for g in OPTIONAL}
    if has["pbvh3"] and not has["pbvh8"]:
        raise ValueError("from_arrays: pbvh3 shares pbvh8's leaves and cannot come without it")
    meta = SceneMeta(**{f.name: getattr(meta, f.name) for f in dataclasses.fields(SceneMeta)})
    envs = arrays.get("envs") or ()
    media = arrays.get("media")
    if media is None:
        if meta.has_media:
            raise KeyError("from_arrays: meta.has_media but no 'media' table")
        media = pack_media_arrays([])
    if len(envs) != meta.n_envs:
        raise KeyError(f"from_arrays: {len(envs)} env lights under 'envs', meta.n_envs = "
                       f"{meta.n_envs}")

    def t(key):
        return torch.as_tensor(np.array(arrays[key], np.float32), device=device)

    textures = TextureTable.from_arrays(
        arrays["textures.tpack"], arrays["textures.data"], arrays["textures.data4"], device)

    def sub(prefix):
        return {k.split(".", 1)[1]: arrays[k] for k in ARRAY_KEYS if k.startswith(prefix + ".")}

    def env_light(a):
        tex = int(np.asarray(a["tex"]))
        return EnvLight(
            rot=torch.as_tensor(np.array(a["rot"], np.float32), device=device),
            inv_rot=torch.as_tensor(np.array(a["inv_rot"], np.float32), device=device), tex=tex,
            dist=Distribution2D.from_arrays(a["dist.alias_pack"], a["dist.joint_pdf"],
                                            np.asarray(a["dist.shape"]), device),
            tex_kind=int(np.asarray(arrays["textures.tpack"])[tex, -1]))

    def table(cls, prefix):
        return cls(**{k: torch.as_tensor(np.array(v, np.float32), device=device)
                      for k, v in sub(prefix).items()})

    # the bf16 halves of pbvh8's planes may come along, as bit patterns
    halves = {k: arrays.get(f"pbvh8.{k}") for k in ("planes_hi", "planes_lo")}
    pbvh8 = Bvh8Pack.from_arrays({**sub("pbvh8"), **halves}, device) if has["pbvh8"] else None
    pbvh3 = Bvh3Pack.from_arrays(sub("pbvh3"), pbvh8) if has["pbvh3"] else None
    pbvh = None
    if has["pbvh"]:  # the padded `pbvh.nodes` does not record the node count:
        # the JAX pack keeps it as a static field
        pbvh = BvhPack.from_arrays(sub("pbvh"), int(np.asarray(arrays["pbvh.n_nodes"])), device)
    return FlatScene(
        tris=TriangleSoA(v0=t("tris.v0"), e1=t("tris.e1"), e2=t("tris.e2")),
        shade_pack=t("shade_pack"),
        tri_ng=t("tri_ng"), tri_uv0=t("tri_uv0"), tri_uv1=t("tri_uv1"), tri_uv2=t("tri_uv2"),
        tri_light=torch.as_tensor(np.array(arrays["tri_light"], np.int64), device=device),
        tri_med_int=torch.as_tensor(np.array(arrays["tri_med_int"], np.int64), device=device),
        tri_med_ext=torch.as_tensor(np.array(arrays["tri_med_ext"], np.int64), device=device),
        tri_med_override=torch.as_tensor(np.array(arrays["tri_med_override"], np.bool_),
                                         device=device),
        media=MediumTable.from_arrays(media, device),
        lights=LightTable.from_arrays(sub("lights"), device),
        materials=MaterialTable.from_arrays(arrays["materials.gpack2"],
                                            arrays["materials.rough_kinds"], device,
                                            arrays.get("materials.gpack3")),
        textures=textures,
        env=env_light(sub("env")),
        camera=CameraParams(
            **{k: t(f"camera.{k}") for k in CAMERA_KEYS if not k.startswith("ap_dist")},
            ap_dist=None if arrays.get("camera.ap_dist.alias_pack") is None
            else Distribution2D.from_arrays(*(arrays[f"camera.ap_dist.{k}"]
                                              for k in ("alias_pack", "joint_pdf", "shape")),
                                            device)),
        ptris=TriPack.from_arrays(sub("ptris"), device),
        pbvh8=pbvh8,
        gbvh=GatherBvhPack.from_arrays(sub("gbvh"), device) if has["gbvh"] else None,
        pbvh3=pbvh3,
        pbvh=pbvh,
        ana=analytic.AnalyticTable.from_arrays(sub("ana"), device) if has["ana"] else None,
        meta=meta,
        cap=table(CapLight, "cap"),
        point=table(PointLight, "point"),
        envs=tuple(env_light(a) for a in envs),
    )


def flatten_scene(doc: SceneDocument, device) -> FlatScene:
    arrays, meta = flatten_arrays(doc)
    return from_arrays(arrays, meta, device)
