"""Scenes built in code: a materialtest-like scene in two sizes, with variants.

`write_scene(out_dir, size)` writes scene.json, ball.obj and, where the
size has them, sky.pfm, sky.hdr, lamp.obj and orb.obj into out_dir and
returns the scene.json path. The scene has materialtest's features:

  * a lambert floor quad with a checker albedo;
  * a rough_conductor ball (Cu, GGX, roughness 0.1): a UV-sphere OBJ with
    smooth normals (its pole triangles are degenerate, as real meshes' are);
  * a lambert cube;
  * an infinite_sphere lit by a procedural lat-long sky with a bright sun
    blob, so the env's alias table is far from uniform;
  * in the -analytic sizes only, three analytic prims (Tungsten's default
    `sphere` is analytic, as are `disk` and `cylinder`): a lambert sphere,
    a lambert disk just above the floor and a capped rough_conductor
    cylinder standing on it, none emissive;
  * in the -area sizes only, two area lights beside the sky: an emissive
    quad facing down and an emissive triangle mesh (lamp.obj, a 64-triangle
    sphere), so the light choice weighs a quad, a mesh and the env;
  * in the box sizes (small-box, box-synth) the floor quad and the sky
    give way to a closed box around the ball, the cube and the camera, lit
    by one emissive quad under its ceiling: no env light, every path ends
    inside (a Cornell-box kind of scene). Neither the light tracer nor BDPT
    takes an env light, so these are the scenes on which they and the path
    tracer must agree; a box size's `variant` names the scene's integrator
    (path_tracer by default, light_tracer, bidirectional_path_tracer,
    bdpt_pyramid: BDPT with its image_pyramid, photon_map or
    progressive_photon_map, with PHOTON_COUNT photons an iteration,
    kelemen_mlt, multiplexed_mlt, reversible_jump_mlt), and may name kinds
    after it: "kelemen_mlt+pt" gives Kelemen MLT path-traced chains
    ("bidirectional": false), "+caustic" makes the ball a smooth dielectric
    (ior 1.5: caustics on the floor, and a camera chain through the glass),
    "+fog" fills the box with FOG (the camera's medium and every prim's
    outer and inner medium), "+fog+<type>" sets the volume photon type
    (points, beams, planes, planes_1d).

The two interior sizes build another scene with the interior cell's surfaces
(BASELINE.json configs[1]: area lights, NEE/MIS, dielectric and plastic
BSDFs, an HDR env map): a closed room of cubes (floor, ceiling, walls) with
one window in its back wall, and in it
  * the ball mesh as a smooth dielectric (ior 1.5);
  * a rough_dielectric cube, a thin frosted pane;
  * a plastic sphere and a rough_plastic sphere whose roughness is a checker
    texture (orb.obj, a smaller UV sphere);
  * a smooth conductor sphere (Au) and a mirror quad on the right wall;
  * an emissive ceiling quad, the light fixture, with the null BSDF;
  * the sky as sky.hdr, written by the port's RGBE writer, seen through the
    window;
  * lambert walls and a lambert floor with a checker albedo.

The two lights sizes build the materialtest-like scene with every light
kind of the JAX flatten but the skydome, beside its floor, ball and cube:
an emissive sphere, an emissive disk with a 30-degree emission cone facing
down, an emissive capped cylinder, a constant infinite_sphere, a spherical
cap listed before the last env (NEE-sampled, masked on escape), the bitmap
sky (the last env, the escape winner), a cap given by its power and listed
after it (it wins the escapes inside its cone) and a point light.

The two camera sizes render the materialtest-like scene (floor, ball, cube,
sky) through the other cameras, in four variants (`write_scene`'s
`variant`):
  * thinlens: a 6-blade aperture, cat-eye 0.5, focused on the ball by
    `focus_pivot`, the mitchell_netravali filter, and depth, normal and
    albedo output buffers;
  * bitmap: the thinlens variant with a bitmap aperture (aperture.pfm, a
    ring with a bright spot, written in code);
  * equirectangular: the lat-long camera with the lanczos filter, at twice
    the height's width;
  * cubemap: six square faces side by side, the catmull_rom filter.
Their outputs are PFM files (the LDR ones too at camera-synth's size: PFM
needs neither PIL nor cv2), and small-camera's LDR outputs PNG.

The two media sizes put participating media into the materialtest-like
scene (floor, ball, cube, sky), lit also by a lamp quad facing down (an
infinite homogeneous medium hides the sky: a ray to it never gets out), in
four variants (`write_scene`'s `variant`):
  * fog: the camera sits in a homogeneous fog with the davis
    transmittance (alpha 2) and a Henyey-Greenstein phase (g = 0.6);
  * cloud: a voxel medium in a box beside the ball, exact_linear: at
    small-media a 16^3 dense cloud.npz with an emission grid, at media-synth
    a 192^3 procedurally modulated blob written as a zip-compressed 5-4-3
    cloud.vdb by this module's copy of tests/test_vdb.py's independent writer
    (`write_vdb`), which the port's reader reads back. The box is an
    index-matched smooth dielectric (ior 1): paths cross it unchanged, and
    it has no forward lobe, so regen renders it (the null BSDF would end
    every path at the box);
  * haze: an exponential camera medium (its density falls with height, so
    the sky shows through) and an absorption-only atmosphere with the
    erlang transmittance inside an analytic sphere (ior-1 dielectric), its
    center given by a `pivot` naming the sphere;
  * forward: fog with forward lobes: the cube a transparency with a checker
    alpha, a thinsheet bubble orb. Lockstep only (the forward branch and
    its volume NEE).

The two hair sizes put curves on the materialtest-like scene's ball and
floor, lit by a skydome alone (turbidity 3, the sun 30 degrees up): a
.hair file (cyHair) written in code with curly strands of 25 nodes rooted
on the ball's upper half, their radius tapering from root to tip, split
over three curves prims, each its own file: the middle half of the strands
(by the root's x) with the hair BCSDF (melanin 1.3, roughness 0.3), the
left quarter lambertian_fiber, the right quarter rough_wire (Au, roughness
0.2). hair-synth: 4,096 strands of radius 0.003 at the root and 0.0015 at
the tip, 4,096 x 24 x 3 x 2 = 589,824 triangles under the curves' max_tris
of 2^20, so none is dropped; small-hair: 64 strands ten times as thick.

The two minecraft sizes render a minecraft_map world written in code with
the port's Anvil writer: a heightfield terrain of stone, dirt and grass
with glowstone lamps on it (mc-synth: 8 x 8 chunks, 128 x 128 columns, 64
blocks high, 12 lamps; small-mc: one chunk, 16 blocks high, 2 lamps),
textured by a resource pack written in code (pack/: models with a parent
chain and '#var' references, blockstates, a mapping.json with masks, 16x16
PNG textures, the grass's top tinted, and an emitters.json that makes
glowstone emit), an analytic sphere whose emission is an IES profile
written in code (lamp.ies), and a skydome. Their renderer block turns
adaptive sampling off, so the CLI renders every pass in regen.

The two coat sizes and the two cut-out sizes build the materialtest-like
scene with the remaining surfaces (every non-fiber type the interior sizes
do not show), lit by the sky and one emissive quad facing down:
  * coat: the ball as a smooth_coat (ior 1.5, thickness 1, a coloured
    sigma_a) over rough_conductor Cu; an oren_nayar floor with a checker
    roughness; the cube as a mixed BSDF of lambert and phong with a checker
    ratio; three orbs: a rough_coat over lambert (checker roughness), a
    phong and a diffuse_transmission. No forward lobe, so both wavefronts
    render it.
  * cutout: the ball as a transparency over lambert with a checker alpha
    (seen through in stripes); a thinsheet bubble orb with thin-film
    interference; a forward quad standing across part of the view; a
    lambert checker floor and a plastic orb; the light above the ball and
    the bubble, so shadow rays cross them. Forward lobes: lockstep only.
  No rough coat or rough dielectric closes a volume with internal
  reflections (the parity trap of ROADMAP §3): the coats reflect only.

Sizes:
  materialtest-synth  80,000-triangle ball, 512x256 sky, 1000x563, 32 spp,
                      max_bounces 64 (materialtest's renderer block; the
                      triangle count is materialtest's, pallas_bvh8.py:40)
  small               2,000-triangle ball, 128x64 sky, 64x48, 4 spp,
                      max_bounces 6 (the CPU tests' size)
  materialtest-analytic   materialtest-synth plus the analytic prims
  small-analytic          small plus the analytic prims
  materialtest-area       materialtest-synth plus the two area lights
  small-area              small plus the two area lights
  small-box               small's ball and cube in the closed box
  box-synth               materialtest-synth's ball and cube in the closed
                          box (1000x563, 32 spp, 64 bounces: BDPT runs at
                          its default cap of 16 vertices)
  interior-synth      the interior scene at materialtest-synth's scale: the
                      80,000-triangle ball, 9,216-triangle orbs, 512x256
                      sky, 1000x563, 32 spp, max_bounces 64
  small-interior      the interior scene at small's: 2,000-triangle ball,
                      576-triangle orbs, 128x64 sky, 64x48, 4 spp,
                      max_bounces 6
  coat-synth, cutout-synth    the coat and cut-out scenes at
                      materialtest-synth's scale (80,000-triangle ball,
                      9,216-triangle orbs)
  small-coat, small-cutout    the same at small's (576-triangle orbs)
  lights-synth        the lights scene at materialtest-synth's scale
  small-lights        the same at small's
  camera-synth        the camera scene at materialtest-synth's scale:
                      thinlens and bitmap 1000x563, equirectangular
                      1000x500, cubemap 1536x256 (256x256 faces)
  small-camera        the same at small's: 64x48, cubemap 96x16
  media-synth         the media scene at materialtest-synth's scale
                      (80,000-triangle ball, 1000x563, 32 spp, 64 bounces)
  small-media         the same at small's (the CPU parity scene)
  hair-synth          the hair scene at materialtest-synth's scale
                      (80,000-triangle ball, 4,096 strands, 1000x563,
                      32 spp, 64 bounces)
  small-hair          the same at small's (64 strands, 64x48, 4 spp, 6
                      bounces)
  mc-synth            the minecraft scene: 8 x 8 chunks, 1000x563, 32 spp,
                      64 bounces
  small-mc            the same with one chunk at small's render size

Usage: python -m tungsten_tpu_torch.synth OUT_DIR [size [variant]]
"""
from __future__ import annotations

import copy
import json
import os
import struct
import sys
import zlib

import numpy as np

from .integrators.photon_map import VOLUME_PHOTON_TYPES
from .io.imageio import save_hdr, save_pfm

SIZES = {
    # name: (sphere u segments, v segments, sky w, sky h, res, spp, max_bounces)
    "materialtest-synth": (400, 100, 512, 256, (1000, 563), 32, 64),
    "small": (50, 20, 128, 64, (64, 48), 4, 6),
}
SIZES["materialtest-analytic"] = SIZES["materialtest-synth"]
SIZES["small-analytic"] = SIZES["small"]
SIZES["materialtest-area"] = SIZES["materialtest-synth"]
SIZES["small-area"] = SIZES["small"]
SIZES["small-box"] = SIZES["small"]
SIZES["box-synth"] = SIZES["materialtest-synth"]
BOX = ("box-synth", "small-box")
BOX_VARIANTS = ("path_tracer", "light_tracer", "bidirectional_path_tracer", "bdpt_pyramid",
                "photon_map", "progressive_photon_map", "kelemen_mlt", "multiplexed_mlt",
                "reversible_jump_mlt")
# a box variant's kinds, after its integrator: "<integrator>+caustic",
# "<integrator>+fog", "<integrator>+fog+<volume photon type>" and
# "kelemen_mlt+pt" (path-traced chains, "bidirectional": false)
BOX_KINDS = ("caustic", "fog", "pt")
PHOTON_COUNT = {"small-box": 1 << 14, "box-synth": 1 << 18}  # photons an SPPM iteration
# photon_map's kNN count: small-box's photons are too few for the default
# 20 to shrink any radius, 4 does
GATHER_COUNT = {"small-box": 4, "box-synth": 20}
CAUSTIC_BSDF = {"name": "ball", "type": "dielectric", "ior": 1.5}
SIZES["interior-synth"] = SIZES["materialtest-synth"]
SIZES["small-interior"] = SIZES["small"]
# the surface scenes: size -> its kind
SURFACES = {"coat-synth": "coat", "small-coat": "coat", "cutout-synth": "cutout",
            "small-cutout": "cutout"}
for _size in SURFACES:
    SIZES[_size] = SIZES["small" if _size.startswith("small") else "materialtest-synth"]
INTERIOR = ("interior-synth", "small-interior")
LIGHTS = ("lights-synth", "small-lights")
SIZES["lights-synth"] = SIZES["materialtest-synth"]
SIZES["small-lights"] = SIZES["small"]
CAMERA = ("camera-synth", "small-camera")
SIZES["camera-synth"] = SIZES["materialtest-synth"]
SIZES["small-camera"] = SIZES["small"]
MEDIA = ("media-synth", "small-media")
SIZES["media-synth"] = SIZES["materialtest-synth"]
SIZES["small-media"] = SIZES["small"]
MEDIA_VARIANTS = ("fog", "cloud", "haze", "forward")
CLOUD_RES = {"media-synth": 192, "small-media": 16}  # the cloud grid's n^3
FIBER = ("hair-synth", "small-hair")
MINECRAFT = ("mc-synth", "small-mc")
for _big, _small in (FIBER, MINECRAFT):
    SIZES[_big], SIZES[_small] = SIZES["materialtest-synth"], SIZES["small"]
STRANDS = {"hair-synth": 4096, "small-hair": 64}
STRAND_NODES = 25
STRAND_RADIUS = {"hair-synth": (0.003, 0.0015), "small-hair": (0.03, 0.015)}  # root, tip
# (file, bsdf, share of the strands by the root's x: left quarter, middle
# half, right quarter)
FIBER_FILES = (("fiber.hair", "fiber", 0.25), ("hair.hair", "hair", 0.75),
               ("wire.hair", "wire", 1.0))
FIBER_BSDFS = [
    {"name": "hair", "type": "hair", "melanin_concentration": 1.3, "melanin_ratio": 0.5,
     "roughness": 0.3},
    {"name": "fiber", "type": "lambertian_fiber", "albedo": [0.85, 0.8, 0.7]},
    {"name": "wire", "type": "rough_wire", "material": "Au", "roughness": 0.2},
]
# the sun 30 degrees up (the skydome's sun is its transform's +y)
SKYDOME = {"type": "skydome", "turbidity": 3.0, "intensity": 2.0, "temperature": 5777.0,
           "transform": {"rotation": [60, 30, 0]}}
# minecraft sizes: (chunks a side, world height, glowstone lamps, camera
# position, look_at, the IES sphere's position and scale)
MC_WORLD = {"mc-synth": (8, 64, 12, [64.0, 60.0, -40.0], [64.0, 40.0, 64.0],
                         [64.0, 58.0, 64.0], 4.0),
            "small-mc": (1, 16, 2, [8.0, 13.0, -10.0], [8.0, 8.0, 8.0], [8.0, 12.0, 9.0], 1.5)}
MC_IDS = {"stone": 1, "grass": 2, "dirt": 3, "glowstone": 89}  # legacy block ids
# variant -> (camera fields, filter, resolution of camera-synth, of small-camera)
THINLENS = {"type": "thinlens", "aperture_size": 0.3, "cateye": 0.5, "focus_pivot": "ball",
            "aperture": {"type": "blade", "blades": 6}}
CAMERA_VARIANTS = {
    "thinlens": (THINLENS, "mitchell_netravali", (1000, 563), (64, 48)),
    "bitmap": ({**THINLENS, "aperture": "aperture.pfm"}, "mitchell_netravali", (1000, 563),
               (64, 48)),
    "equirectangular": ({"type": "equirectangular"}, "lanczos", (1000, 500), (64, 48)),
    "cubemap": ({"type": "cubemap"}, "catmull_rom", (1536, 256), (96, 16)),
}
AOV_VARIANTS = ("thinlens", "bitmap")  # the variants with output buffers
ORB_SEGMENTS = {size: (24, 12) if size.startswith("small") else (96, 48)
                for size in INTERIOR + tuple(SURFACES) + MEDIA}  # orb.obj
LAMP_SEGMENTS = (8, 4)  # lamp.obj: 2 * 8 * 4 = 64 triangles

# the -analytic sizes' extra materials and prims
ANALYTIC_BSDFS = [
    {"name": "accent", "type": "lambert", "albedo": [0.25, 0.5, 0.3]},
    {"name": "chrome", "type": "rough_conductor", "material": "Cr",
     "distribution": "ggx", "roughness": 0.25},
]
ANALYTIC_PRIMS = [
    {"type": "sphere", "bsdf": "accent",
     "transform": {"position": [-1.5, 0.5, 0.9], "scale": 0.5}},
    {"type": "disk", "bsdf": "inner",
     "transform": {"position": [1.0, 0.01, 2.2], "scale": 0.6}},
    {"type": "cylinder", "bsdf": "chrome", "capped": True,
     "transform": {"position": [-0.5, 0.4, 2.4], "scale": [0.6, 0.8, 0.6]}},
]


# the -area sizes' lights: a quad's normal is +y, so it is turned to face down
AREA_LIGHTS = [
    {"type": "quad", "bsdf": "inner", "emission": [8.0, 7.0, 6.0],
     "transform": {"position": [-2.0, 3.5, 1.0], "scale": 1.5, "rotation": [180, 0, 0]}},
    {"type": "mesh", "file": "lamp.obj", "smooth": False, "bsdf": "inner",
     "emission": [4.0, 6.0, 10.0],
     "transform": {"position": [2.2, 1.6, 1.8], "scale": 0.3}},
]
# the lights sizes' lights: (before the sky, after it); the sky stays where
# it is, the last env
LIGHTS_BEFORE_SKY = [
    {"type": "sphere", "bsdf": "inner", "emission": [6.0, 5.0, 4.0],
     "transform": {"position": [-1.6, 0.45, 1.2], "scale": 0.35}},
    {"type": "disk", "bsdf": "inner", "emission": [30.0, 26.0, 20.0], "cone_angle": 30.0,
     "transform": {"position": [1.4, 2.4, 1.3], "scale": 0.4, "rotation": [180, 0, 0]}},
    {"type": "cylinder", "bsdf": "inner", "emission": [1.5, 3.0, 4.0], "capped": True,
     "transform": {"position": [2.6, 0.3, -0.8], "scale": [0.2, 0.6, 0.2]}},
    {"type": "infinite_sphere", "emission": [0.05, 0.06, 0.08]},
    {"type": "infinite_sphere_cap", "emission": 20.0, "cap_angle": 8.0,
     "transform": {"rotation": [35, 0, 0]}},
]
LIGHTS_AFTER_SKY = [
    {"type": "infinite_sphere_cap", "power": 40.0, "cap_angle": 5.0,
     "transform": {"rotation": [-30, 40, 0]}},
    {"type": "point", "power": [40.0, 35.0, 30.0], "transform": {"position": [-0.8, 2.2, 1.8]}},
]
# the -box size: walls seen from inside (two-sided shading), one ceiling light
BOX_BSDF = {"name": "wall", "type": "lambert", "albedo": [0.7, 0.68, 0.62]}
BOX_PRIMS = [
    {"type": "cube", "bsdf": "wall",
     "transform": {"position": [0.0, 2.0, 2.5], "scale": [8.0, 4.0, 10.0]}},
    {"type": "quad", "bsdf": "inner", "emission": [12.0, 11.0, 9.0],
     "transform": {"position": [0.0, 3.95, 1.5], "scale": 2.0, "rotation": [180, 0, 0]}},
]


# the interior sizes: a room of wall slabs 0.2 thick, x in [-4, 4], y in
# [0, 3.5], z in [-4, 6], its window in the back wall at x in [-3, -0.6], y in
# [1, 2.8]; (position, scale) of each slab
INTERIOR_WALLS = [
    ([0.0, -0.1, 1.0], [8.4, 0.2, 10.4]),  # floor
    ([0.0, 3.6, 1.0], [8.4, 0.2, 10.4]),  # ceiling
    ([-4.1, 1.75, 1.0], [0.2, 3.5, 10.4]),  # left wall
    ([4.1, 1.75, 1.0], [0.2, 3.5, 10.4]),  # right wall
    ([0.0, 1.75, 6.1], [8.4, 3.5, 0.2]),  # front wall, behind the camera
    ([-3.5, 1.75, -4.1], [1.0, 3.5, 0.2]),  # back wall, left of the window
    ([1.7, 1.75, -4.1], [4.6, 3.5, 0.2]),  # back wall, right of it
    ([-1.8, 0.5, -4.1], [2.4, 1.0, 0.2]),  # below the window
    ([-1.8, 3.15, -4.1], [2.4, 0.7, 0.2]),  # above it
]
INTERIOR_BSDFS = [
    {"name": "wall", "type": "lambert", "albedo": [0.7, 0.68, 0.62]},
    {"name": "floor", "type": "lambert",
     "albedo": {"type": "checker", "on_color": [0.75, 0.7, 0.6],
                "off_color": [0.3, 0.28, 0.25], "res_u": 8, "res_v": 10}},
    {"name": "glass", "type": "dielectric", "ior": 1.5},
    {"name": "frosted", "type": "rough_dielectric", "ior": 1.5, "distribution": "ggx",
     "roughness": 0.15},
    {"name": "blue_plastic", "type": "plastic", "ior": 1.5, "albedo": [0.1, 0.35, 0.8]},
    {"name": "red_plastic", "type": "rough_plastic", "ior": 1.5, "distribution": "ggx",
     "albedo": [0.8, 0.25, 0.1],
     "roughness": {"type": "checker", "on_color": 0.05, "off_color": 0.5,
                   "res_u": 8, "res_v": 4}},
    {"name": "gold", "type": "conductor", "material": "Au"},
    {"name": "mirror", "type": "mirror", "albedo": 0.9},
    {"name": "fixture", "type": "null"},
]
INTERIOR_PRIMS = [
    {"type": "mesh", "file": "ball.obj", "smooth": True, "bsdf": "glass",
     "transform": {"position": [0.4, 1.0, -0.8]}},
    {"type": "cube", "bsdf": "frosted",  # a frosted pane standing on the floor
     "transform": {"position": [-2.2, 0.5, 0.6], "scale": [1.4, 1.0, 0.08],
                   "rotation": [0, 25, 0]}},
    {"type": "mesh", "file": "orb.obj", "smooth": True, "bsdf": "blue_plastic",
     "transform": {"position": [2.4, 0.6, 0.8], "scale": 0.6}},
    {"type": "mesh", "file": "orb.obj", "smooth": True, "bsdf": "red_plastic",
     "transform": {"position": [-0.9, 0.55, 1.9], "scale": 0.55}},
    {"type": "mesh", "file": "orb.obj", "smooth": True, "bsdf": "gold",
     "transform": {"position": [1.5, 0.45, 2.3], "scale": 0.45}},
    {"type": "quad", "bsdf": "mirror",
     "transform": {"position": [3.95, 1.6, 0.0], "scale": [2.0, 1.0, 3.0],
                   "rotation": [0, 0, 90]}},
    {"type": "quad", "bsdf": "fixture", "emission": [14.0, 12.5, 10.0],
     "transform": {"position": [0.0, 3.49, 1.0], "scale": 1.6, "rotation": [180, 0, 0]}},
    {"type": "infinite_sphere", "emission": "sky.hdr",
     "transform": {"rotation": [0, 200, 0]}},
]


# the surface scenes: the materialtest floor, ball and cube with other
# BSDFs, three orbs, and a light quad facing down beside the sky
SURFACE_BSDFS = {
    "coat": [
        {"name": "floor", "type": "oren_nayar", "albedo": [0.7, 0.68, 0.62],
         "roughness": {"type": "checker", "on_color": 0.9, "off_color": 0.1,
                       "res_u": 20, "res_v": 20}},
        {"name": "ball", "type": "smooth_coat", "ior": 1.5, "thickness": 1.0,
         "sigma_a": [0.05, 0.3, 0.6],
         "substrate": {"type": "rough_conductor", "material": "Cu", "distribution": "ggx",
                       "roughness": 0.1}},
        {"name": "inner", "type": "mixed",
         "ratio": {"type": "checker", "on_color": 0.85, "off_color": 0.15,
                   "res_u": 4, "res_v": 4},
         "bsdf0": {"type": "lambert", "albedo": [0.6, 0.3, 0.2]},
         "bsdf1": {"type": "phong", "albedo": [0.8, 0.8, 0.7], "exponent": 40,
                   "diffuse_ratio": 0.2}},
        {"name": "coat_orb", "type": "rough_coat", "ior": 1.5, "distribution": "ggx",
         "roughness": {"type": "checker", "on_color": 0.05, "off_color": 0.35,
                       "res_u": 8, "res_v": 4},
         "substrate": {"type": "lambert", "albedo": [0.15, 0.4, 0.7]}},
        {"name": "phong_orb", "type": "phong", "albedo": [0.9, 0.75, 0.3], "exponent": 60,
         "diffuse_ratio": 0.3},
        {"name": "translucent_orb", "type": "diffuse_transmission",
         "albedo": [0.8, 0.85, 0.7], "transmittance": 0.5},
        {"name": "lamp", "type": "lambert", "albedo": 0.5},
    ],
    "cutout": [
        {"name": "floor", "type": "lambert",
         "albedo": {"type": "checker", "on_color": [0.8, 0.8, 0.8],
                    "off_color": [0.2, 0.2, 0.2], "res_u": 20, "res_v": 20}},
        {"name": "ball", "type": "transparency",
         "alpha": {"type": "checker", "on_color": 1.0, "off_color": 0.1,
                   "res_u": 1, "res_v": 12},
         "base": {"type": "lambert", "albedo": [0.75, 0.35, 0.15]}},
        {"name": "bubble", "type": "thinsheet", "ior": 1.33, "enable_interference": True,
         "thickness": 0.8},
        {"name": "veil", "type": "forward"},
        {"name": "plastic_orb", "type": "plastic", "ior": 1.5, "albedo": [0.1, 0.5, 0.25]},
        {"name": "lamp", "type": "lambert", "albedo": 0.5},
    ],
}
SURFACE_PRIMS = {
    "coat": [
        {"type": "cube", "bsdf": "inner",
         "transform": {"position": [1.9, 0.5, 0.6], "scale": 1.0, "rotation": [0, 30, 0]}},
        {"type": "mesh", "file": "orb.obj", "smooth": True, "bsdf": "coat_orb",
         "transform": {"position": [-1.8, 0.45, 0.8], "scale": 0.45}},
        {"type": "mesh", "file": "orb.obj", "smooth": True, "bsdf": "phong_orb",
         "transform": {"position": [-0.9, 0.35, 2.1], "scale": 0.35}},
        {"type": "mesh", "file": "orb.obj", "smooth": True, "bsdf": "translucent_orb",
         "transform": {"position": [1.0, 0.4, 2.3], "scale": 0.4}},
    ],
    "cutout": [
        {"type": "mesh", "file": "orb.obj", "smooth": True, "bsdf": "bubble",
         "transform": {"position": [-1.5, 0.75, 1.3], "scale": 0.6}},
        {"type": "quad", "bsdf": "veil",  # stands upright, facing the camera
         "transform": {"position": [1.5, 0.9, 0.9], "scale": [1.4, 1.0, 1.8],
                       "rotation": [90, 0, 0]}},
        {"type": "mesh", "file": "orb.obj", "smooth": True, "bsdf": "plastic_orb",
         "transform": {"position": [0.9, 0.4, 2.3], "scale": 0.4}},
    ],
}
# above the ball and the bubble (cutout: so their shadow rays cross them)
SURFACE_LIGHT = {"type": "quad", "bsdf": "lamp", "emission": [9.0, 8.0, 7.0],
                 "transform": {"position": [-0.6, 3.6, 0.5], "scale": 1.6,
                               "rotation": [180, 0, 0]}}


# the media sizes: a lamp beside the sky, an index-matched boundary, and each
# variant's media, prims and camera medium
MEDIA_LAMP_BSDF = {"name": "lamp", "type": "lambert", "albedo": 0.5}
MEDIA_LAMP = {"type": "quad", "bsdf": "lamp", "emission": [9.0, 8.0, 7.0],
              "transform": {"position": [-0.6, 3.6, 0.5], "scale": 1.6, "rotation": [180, 0, 0]}}
BOUNDARY_BSDF = {"name": "boundary", "type": "dielectric", "ior": 1.0}
FOG = {"name": "fog", "type": "homogeneous", "sigma_a": 0.04, "sigma_s": [0.05, 0.055, 0.06],
       "phase_function": {"type": "henyey_greenstein", "g": 0.6},
       "transmittance": {"type": "davis", "alpha": 2.0}}
CLOUD_BOX = {"position": [-1.9, 0.02, 1.0], "scale": 1.4}  # the grid's unit box -> world
CLOUD = {"name": "cloud", "type": "voxel", "sigma_a": 0.3, "sigma_s": [3.0, 2.8, 2.6],
         "phase_function": {"type": "isotropic"},
         "grid": {"transform": CLOUD_BOX}}
CLOUD_PRIM = {"type": "cube", "bsdf": "boundary", "int_medium": "cloud",
              "transform": {"position": [-1.9, 0.72, 1.0], "scale": 1.42}}
HAZE = {"name": "haze", "type": "exponential", "sigma_a": 0.02, "sigma_s": [0.12, 0.15, 0.2],
        "falloff_scale": 0.8, "falloff_direction": [0, 1, 0], "unit_point": [0, 0, 0],
        "phase_function": {"type": "rayleigh"},
        "transmittance": {"type": "erlang", "rate": 1.5}}
ATMOSPHERE = {"name": "atmo", "type": "atmosphere", "sigma_a": [0.9, 0.5, 0.15],
              "sigma_s": 0.0, "radius": 0.8, "falloff_scale": 1.5, "pivot": "dome"}
DOME_PRIM = {"type": "sphere", "name": "dome", "bsdf": "boundary", "int_medium": "atmo",
             "ext_medium": "haze", "transform": {"position": [-1.8, 0.8, 1.2], "scale": 0.8}}
FORWARD_BSDFS = [
    {"name": "inner", "type": "transparency",
     "alpha": {"type": "checker", "on_color": 1.0, "off_color": 0.15, "res_u": 3, "res_v": 3},
     "base": {"type": "lambert", "albedo": [0.6, 0.3, 0.2]}},
    {"name": "bubble", "type": "thinsheet", "ior": 1.33, "enable_interference": True,
     "thickness": 0.8},
]
BUBBLE_PRIM = {"type": "mesh", "file": "orb.obj", "smooth": True, "bsdf": "bubble",
               "transform": {"position": [-1.5, 0.75, 1.3], "scale": 0.6}}


def _media_variant(doc: dict, size: str, variant: str) -> dict:
    """The media scene's `variant` (MEDIA_VARIANTS) at `size`."""
    doc["bsdfs"] += [copy.deepcopy(MEDIA_LAMP_BSDF), copy.deepcopy(BOUNDARY_BSDF)]
    doc["primitives"][3:3] = [copy.deepcopy(MEDIA_LAMP)]  # before the env light
    if variant in ("fog", "forward"):
        doc["media"] = [copy.deepcopy(FOG)]
        doc["camera"]["medium"] = "fog"
    if variant == "forward":
        doc["bsdfs"] = [b for b in doc["bsdfs"] if b["name"] != "inner"] + copy.deepcopy(
            FORWARD_BSDFS)
        doc["primitives"][3:3] = [copy.deepcopy(BUBBLE_PRIM)]
    if variant == "cloud":
        cloud = copy.deepcopy(CLOUD)
        if size == "small-media":
            cloud["grid"].update(type="dense", file="cloud.npz")
        else:
            cloud["grid"].update(type="vdb", file="cloud.vdb")
        doc["media"] = [cloud]
        doc["primitives"][3:3] = [copy.deepcopy(CLOUD_PRIM)]
    if variant == "haze":
        doc["media"] = [copy.deepcopy(HAZE), copy.deepcopy(ATMOSPHERE)]
        doc["camera"]["medium"] = "haze"
        doc["primitives"][3:3] = [copy.deepcopy(DOME_PRIM)]
    return doc


def cloud_density(n: int) -> np.ndarray:
    """The cloud: an n^3 gaussian blob modulated by a product of sines, cut
    to zero where it falls below 0.05 (the box's corners), peak ~1;
    (nz, ny, nx) f32."""
    c = ((np.arange(n, dtype=np.float32) + 0.5) / n - 0.5)
    z, y, x = c[:, None, None], c[None, :, None], c[None, None, :]
    base = np.exp(-(x * x + y * y + z * z) / (2.0 * 0.22 * 0.22))
    mod = 1.0 + 0.45 * np.sin(11.0 * x) * np.sin(13.0 * y + 1.0) * np.sin(9.0 * z + 2.0)
    return (np.clip(base * mod - 0.05, 0.0, None) / 0.95).astype(np.float32)


def _write_cloud(out_dir: str, size: str):
    """cloud.npz (density and an emission grid) at small-media, cloud.vdb
    (density, zip-compressed) at media-synth."""
    dens = cloud_density(CLOUD_RES[size])
    if size == "small-media":
        emission = dens[..., None] * np.array([0.8, 0.35, 0.1], np.float32)
        np.savez(os.path.join(out_dir, "cloud.npz"), density=dens, emission=emission)
    else:
        write_vdb(os.path.join(out_dir, "cloud.vdb"),
                  [{"name": "density", "type": "float", "dense": dens, "voxel_size": 0.01}])


# ---------------------------------------------------------------------------
# an OpenVDB writer: a copy of tests/test_vdb.py's independent writer, with
# leaf blocks in place of its per-voxel dicts, so that a dense 192^3 grid
# writes in seconds; a grid given by voxels writes the same bytes as the
# test's writer (tests/test_torch_vdb.py checks)
# ---------------------------------------------------------------------------

VDB_MAGIC = 0x56444220
VDB_ZIP, VDB_ACTIVE_MASK = 0x1, 0x2
LEAF, INT4, INT5 = 8, 16, 32


class _W:
    def __init__(self):
        self.parts = []

    def raw(self, b):
        self.parts.append(b)

    def u32(self, v):
        self.raw(struct.pack("<I", v))

    def i32(self, v):
        self.raw(struct.pack("<i", v))

    def i64(self, v):
        self.raw(struct.pack("<q", v))

    def u64(self, v):
        self.raw(struct.pack("<Q", v))

    def i8(self, v):
        self.raw(struct.pack("<b", v))

    def f64(self, v):
        self.raw(struct.pack("<d", v))

    def boolean(self, v):
        self.raw(b"\x01" if v else b"\x00")

    def name(self, s):
        b = s.encode()
        self.u32(len(b))
        self.raw(b)

    def bytes(self):
        return b"".join(self.parts)


def _write_mask(w, bits):
    """LSB-first little-endian words (NodeMask::save)."""
    w.raw(np.packbits(bits.astype(np.uint8), bitorder="little").tobytes())


def _write_values(w, vals, zipped, half):
    """readData framing: [int64 nbytes | payload]; nbytes <= 0 = raw."""
    dt = np.float16 if half else np.float32
    raw = np.asarray(vals, np.float32).astype(dt).tobytes()
    if zipped:
        if len(raw) == 0:
            w.i64(0)
            return
        z = zlib.compress(raw)
        w.i64(len(z))
        w.raw(z)
    else:
        w.raw(raw)


def _write_compressed(w, dense, mask, zipped, half, ncomp):
    """writeCompressedValues: the metadata code from the inactive values,
    ONLY the active values stored for every code but NO_MASK_AND_ALL_VALS,
    the selection NodeMask for the two-inactive-value codes; versions
    before 222 store all values with no metadata."""
    flat = dense.reshape(-1, ncomp)
    if not getattr(w, "v222", True):
        _write_values(w, flat, zipped, half)
        return
    inactive = flat[~mask]
    uniq = np.unique(inactive, axis=0) if len(inactive) else np.zeros((0, ncomp))
    if len(uniq) <= 1 and (len(uniq) == 0 or np.all(uniq[0] == 0.0)):
        w.i8(0)  # NO_MASK_OR_INACTIVE_VALS: inactive == +background (0)
    elif len(uniq) == 1:
        w.i8(2)  # NO_MASK_AND_ONE_INACTIVE_VAL
        _write_values(w, uniq[0:1], False, half)
    else:
        assert len(uniq) == 2, "writer supports at most two inactive values"
        w.i8(5)  # MASK_AND_TWO_INACTIVE_VALS
        _write_values(w, uniq[0:1], False, half)
        _write_values(w, uniq[1:2], False, half)
        sel = np.zeros(len(flat), bool)
        sel[~mask] = np.all(flat[~mask] == uniq[1], axis=1)
        _write_mask(w, sel)
    _write_values(w, flat[mask], zipped, half)


def _xyz_to_off(x, y, z, dim):
    return (x * dim + y) * dim + z


def _leaf_blocks(g, ncomp):
    """{leaf origin: (active mask (512,), values (512, ncomp))} of a grid
    given by "voxels" {(x, y, z): value}, or by "dense" (nz, ny, nx[, 3])
    with its "origin" (a multiple of 8; every voxel active)."""
    blocks = {}
    if "dense" in g:
        a = np.asarray(g["dense"], np.float32)
        a = a[..., None] if a.ndim == 3 else a
        ox, oy, oz = g.get("origin", (0, 0, 0))
        assert ox % LEAF == 0 and oy % LEAF == 0 and oz % LEAF == 0
        nz, ny, nx = a.shape[:3]
        for lz in range(0, nz, LEAF):
            for ly in range(0, ny, LEAF):
                for lx in range(0, nx, LEAF):
                    blk = np.zeros((LEAF, LEAF, LEAF, ncomp), np.float32)
                    act = np.zeros((LEAF, LEAF, LEAF), bool)
                    sub = a[lz:lz + LEAF, ly:ly + LEAF, lx:lx + LEAF]
                    blk[:sub.shape[0], :sub.shape[1], :sub.shape[2]] = sub
                    act[:sub.shape[0], :sub.shape[1], :sub.shape[2]] = True
                    # leaf offsets are x-major / z-minor: (x * 8 + y) * 8 + z
                    blocks[(ox + lx, oy + ly, oz + lz)] = (
                        act.transpose(2, 1, 0).reshape(-1),
                        blk.transpose(2, 1, 0, 3).reshape(-1, ncomp))
        return blocks
    for (vx, vy, vz), v in g["voxels"].items():
        key = (vx // LEAF * LEAF, vy // LEAF * LEAF, vz // LEAF * LEAF)
        if key not in blocks:
            blocks[key] = (np.zeros(LEAF ** 3, bool), np.zeros((LEAF ** 3, ncomp), np.float32))
        off = _xyz_to_off(vx - key[0], vy - key[1], vz - key[2], LEAF)
        blocks[key][0][off] = True
        blocks[key][1][off] = v
    return blocks


def _write_internal(w, dim, child_span, leaves, tiles, origin, child_writer,
                    zipped, half, ncomp, leaf_order):
    size = dim ** 3
    child_mask = np.zeros(size, bool)
    value_mask = np.zeros(size, bool)
    vals = np.zeros((size, ncomp), np.float32)
    kids = {}
    for key, blk in leaves.items():
        off = _xyz_to_off((key[0] - origin[0]) // child_span, (key[1] - origin[1]) // child_span,
                          (key[2] - origin[2]) // child_span, dim)
        child_mask[off] = True
        kids.setdefault(off, {})[key] = blk
    for (tx, ty, tz), span, v in tiles:
        assert span == child_span, "tile must sit at this node's child level"
        off = _xyz_to_off((tx - origin[0]) // child_span, (ty - origin[1]) // child_span,
                          (tz - origin[2]) // child_span, dim)
        assert not child_mask[off]
        value_mask[off] = True
        vals[off] = v
    _write_mask(w, child_mask)
    _write_mask(w, value_mask)
    _write_compressed(w, vals, value_mask, zipped, half, ncomp)
    for off in np.where(child_mask)[0]:
        cx, cy, cz = off // (dim * dim), (off // dim) % dim, off % dim
        corigin = (origin[0] + int(cx) * child_span, origin[1] + int(cy) * child_span,
                   origin[2] + int(cz) * child_span)
        child_writer(w, corigin, kids[off], zipped, half, ncomp, leaf_order)


def _write_leaf_topology(w, origin, leaves, zipped, half, ncomp, leaf_order):
    mask, buf = leaves[origin]
    _write_mask(w, mask)
    leaf_order.append((mask, buf))


def _write_int4(w, origin, leaves, zipped, half, ncomp, leaf_order):
    _write_internal(w, INT4, LEAF, leaves, [], origin, _write_leaf_topology,
                    zipped, half, ncomp, leaf_order)


def _write_int5(w, origin, leaves, tiles, zipped, half, ncomp, leaf_order):
    _write_internal(w, INT5, INT4 * LEAF, leaves, tiles, origin, _write_int4,
                    zipped, half, ncomp, leaf_order)


def write_vdb(path, grids, version=224, zipped=True):
    """Write a 5-4-3 OpenVDB archive. grids: dicts {name, type ("float" |
    "vec3s"), half, voxels {(x, y, z): value} or dense (nz, ny, nx[, 3]) with
    origin, tiles [((x, y, z), 128, value)], voxel_size}; zipped: zlib value
    compression (or none)."""
    w = _W()
    w.u64(VDB_MAGIC)
    w.u32(version)
    w.u32(8)
    w.u32(1)  # library version
    w.boolean(True)  # has grid offsets
    if version >= 222:  # per-grid compression: the header goes on to the uuid
        w.raw(b"0123456789ab-cdef-0123-456789abcdef0")  # raw 36-char uuid
    else:
        w.boolean(zipped)
        w.name("0123456789ab-cdef-0123-456789abcdef0")  # prefixed uuid
    w.u32(0)  # empty file metadata
    w.u32(len(grids))
    for g in grids:
        ncomp = 3 if g["type"] == "vec3s" else 1
        half = g.get("half", False)
        gw = _W()  # the grid payload, built out of line to learn its offsets
        gw.v222 = version >= 222
        if version >= 222:
            gw.u32((VDB_ZIP if zipped else 0) | VDB_ACTIVE_MASK)
        gw.u32(0)  # empty grid metadata
        gw.name("UniformScaleMap")
        vs = g.get("voxel_size", 1.0)
        for val in [vs] * 6 + [1.0 / vs] * 3 + [1.0 / vs ** 2] * 3 + [0.5 / vs] * 3:
            gw.f64(val)
        gw.u32(1)  # tree buffer count
        _write_values(gw, np.zeros((1, ncomp)), False, half)  # background
        gw.u32(0)  # root tiles
        roots = {}
        for key, blk in _leaf_blocks(g, ncomp).items():
            ro = tuple((c // 4096) * 4096 for c in key)
            roots.setdefault(ro, ({}, []))[0][key] = blk
        for (to_, span, v) in g.get("tiles", []):
            ro = tuple((c // 4096) * 4096 for c in to_)
            roots.setdefault(ro, ({}, []))[1].append((to_, span, v))
        gw.u32(len(roots))
        leaf_order = []
        for ro in sorted(roots):
            leaves, tiles = roots[ro]
            for c in ro:
                gw.i32(c)
            _write_int5(gw, ro, leaves, tiles, zipped, half, ncomp, leaf_order)
        topo_end = sum(len(p) for p in gw.parts)
        for mask, buf in leaf_order:  # the leaf buffers, in DFS order
            _write_mask(gw, mask)
            _write_compressed(gw, buf, mask, zipped, half, ncomp)
        payload = gw.bytes()
        dw = _W()  # the descriptor (instance-parent variant) and its offsets
        dw.name(g["name"])
        dw.name(f"Tree_{g['type']}_5_4_3" + ("_HalfFloat" if half else ""))
        dw.name("")  # no instance parent
        gridpos = len(b"".join(w.parts)) + len(dw.bytes()) + 24
        dw.i64(gridpos)
        dw.i64(gridpos + topo_end)  # blockPos: the leaf buffers
        dw.i64(gridpos + len(payload))  # endPos
        w.raw(dw.bytes())
        w.raw(payload)
    with open(path, "wb") as f:
        f.write(w.bytes())


def write_hair(path: str, pts: np.ndarray, thickness: np.ndarray):
    """A cyHair .hair file (CurveIO.cpp loadHair): strands of equal node
    count, pts (n, m, 3), per-node thickness (n, m): the segments, points
    and thickness arrays (descriptor 0x1 | 0x2 | 0x4)."""
    n, m = thickness.shape
    hdr = (b"HAIR" + struct.pack("<IIII", n, n * m, 0x1 | 0x2 | 0x4, m - 1)
           + struct.pack("<ff", float(thickness.mean()), 1.0) + struct.pack("<fff", 1, 1, 1)
           + b"\0" * 88)
    with open(path, "wb") as f:
        f.write(hdr + np.full(n, m - 1, "<u2").tobytes() + np.asarray(pts, "<f4").tobytes()
                + np.asarray(thickness, "<f4").tobytes())


def strands(size: str, seed: int = 7):
    """(pts (n, 25, 3), radius (n, 25)): curly strands rooted on the upper
    half of the unit ball at (0, 1, 0), growing along the normal with a
    helical curl and a droop, each 0.35-0.5 long."""
    n, m = STRANDS[size], STRAND_NODES
    rng = np.random.default_rng(seed)
    y = rng.uniform(0.1, 0.95, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    r = np.sqrt(1.0 - y * y)
    nrm = np.stack([r * np.cos(phi), y, r * np.sin(phi)], axis=-1)
    t = np.cross(nrm, [0.0, 1.0, 0.0])
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    b = np.cross(nrm, t)
    s = np.linspace(0.0, 1.0, m)[None, :, None]
    length = rng.uniform(0.35, 0.5, n)[:, None, None]
    curl = rng.uniform(0.02, 0.04, n)[:, None, None]
    ang = (rng.uniform(0.0, 2.0 * np.pi, n)[:, None]
           + 2.0 * np.pi * rng.uniform(2.0, 3.0, n)[:, None] * s[..., 0])[..., None]
    pts = (np.array([0.0, 1.0, 0.0]) + nrm[:, None] * (1.0 + length * s)
           + curl * s * (np.cos(ang) * t[:, None] + np.sin(ang) * b[:, None])
           - np.array([0.0, 0.15, 0.0]) * length * s * s)
    root, tip = STRAND_RADIUS[size]
    radius = np.broadcast_to(root + (tip - root) * s[..., 0], (n, m))
    return pts.astype(np.float32), radius.astype(np.float32)


def _write_strands(out_dir: str, size: str):
    """The three .hair files of FIBER_FILES, split by the root's x."""
    pts, radius = strands(size)
    rank = np.argsort(np.argsort(pts[:, 0, 0], kind="stable"), kind="stable") / len(pts)
    lo = 0.0
    for name, _, hi in FIBER_FILES:
        sel = (rank >= lo) & (rank < hi)
        write_hair(os.path.join(out_dir, name), pts[sel], 2.0 * radius[sel])
        lo = hi


def _fiber_dict(doc: dict) -> dict:
    """The materialtest-like floor and ball, the three curves prims and the
    skydome."""
    doc["bsdfs"] = doc["bsdfs"][:2] + copy.deepcopy(FIBER_BSDFS)
    doc["primitives"] = doc["primitives"][:2] + [
        {"type": "curves", "file": name, "mode": "bcsdf_cylinder", "bsdf": bsdf}
        for name, bsdf, _ in FIBER_FILES] + [copy.deepcopy(SKYDOME)]
    return doc


def heightfield(size: str) -> np.ndarray:
    """The terrain's column heights (nz, nx) in blocks, 3 to 3/4 of the
    world's height."""
    chunks, height = MC_WORLD[size][:2]
    n = 16 * chunks
    z, x = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    f = 2.0 * np.pi / max(n, 32)
    h = (0.45 + 0.14 * np.sin(1.3 * f * x + 0.4) * np.cos(0.9 * f * z)
         + 0.08 * np.sin(3.1 * f * (x + z)) + 0.04 * np.cos(5.3 * f * x - 2.7 * f * z))
    return np.clip(np.round(h * height), 3, 3 * height // 4).astype(np.int64)


def world_blocks(size: str, seed: int = 11) -> np.ndarray:
    """The world's legacy block ids (height, nz, nx) [y, z, x]: stone under
    three layers of dirt under grass, glowstone lamps one block above the
    grass."""
    chunks, height, lamps = MC_WORLD[size][:3]
    h = heightfield(size)
    y = np.arange(height)[:, None, None]
    ids = np.where(y < h - 4, MC_IDS["stone"], np.where(y < h - 1, MC_IDS["dirt"], MC_IDS["grass"]))
    ids = np.where(y < h, ids, 0).astype(np.uint8)
    rng = np.random.default_rng(seed)
    n = 16 * chunks
    for z, x in rng.integers(1, n - 1, (lamps, 2)):
        ids[h[z, x], z, x] = MC_IDS["glowstone"]
    return ids


def _chunk_nbt(column: np.ndarray) -> bytes:
    """One chunk (height, 16, 16) [y, z, x] -> its NBT, a section for each
    16 blocks of height that holds a block (MapLoader.hpp:35-78)."""
    from .io.nbt import TAG_BYTE_ARRAY, TAG_COMPOUND, TAG_INT, TAG_LIST, NbtTag, write_nbt

    secs = [NbtTag("", TAG_COMPOUND, {
        "Y": NbtTag("Y", TAG_INT, cy),
        "Blocks": NbtTag("Blocks", TAG_BYTE_ARRAY,
                         column[16 * cy: 16 * cy + 16].reshape(4096).astype(np.int8))})
        for cy in range(column.shape[0] // 16) if column[16 * cy: 16 * cy + 16].any()]
    return write_nbt(NbtTag("", TAG_COMPOUND, {"Level": NbtTag("Level", TAG_COMPOUND, {
        "Sections": NbtTag("Sections", TAG_LIST, secs)})}))


def _write_world(out_dir: str, size: str):
    """world/region/r.0.0.mca through the port's Anvil writer."""
    from .io.anvil import write_region

    ids = world_blocks(size)
    chunks = MC_WORLD[size][0]
    region = os.path.join(out_dir, "world", "region")
    os.makedirs(region, exist_ok=True)
    write_region(os.path.join(region, "r.0.0.mca"), {
        (cx, cz): _chunk_nbt(ids[:, 16 * cz: 16 * cz + 16, 16 * cx: 16 * cx + 16])
        for cz in range(chunks) for cx in range(chunks)})


def _block_texture(rng, base, spread, rows=None):
    """A 16x16 texture: `base` rgb with seeded per-texel noise; `rows`:
    (count, rgb) paints the top rows."""
    img = np.clip(np.asarray(base) * (1.0 + spread * rng.standard_normal((16, 16, 1))), 0, 1)
    if rows:
        img[: rows[0]] = rows[1]
    return img.astype(np.float32)


def write_pack(root: str, seed: int = 5):
    """A resource pack in the shape of tests/test_minecraft.py's _tiny_pack:
    block/cube with elements, cube_all and cube_bottom_top by parent chain
    and '#var' references, a grass model of its own whose top face is
    tinted, blockstates (glowstone's a list), mapping.json with masks,
    16x16 PNGs, and emitters.json making glowstone emit."""
    from .io.imageio import save_image

    mdir = os.path.join(root, "assets/minecraft/models/block")
    sdir = os.path.join(root, "assets/minecraft/blockstates")
    tdir = os.path.join(root, "assets/minecraft/textures/blocks")
    for d in (mdir, sdir, tdir):
        os.makedirs(d, exist_ok=True)
    faces = ("down", "up", "north", "south", "west", "east")
    box = {"from": [0, 0, 0], "to": [16, 16, 16]}
    models = {
        "cube": {"elements": [{**box, "faces": {f: {"texture": "#" + f} for f in faces}}]},
        "cube_all": {"parent": "block/cube", "textures": {f: "#all" for f in faces}},
        "cube_bottom_top": {"parent": "block/cube", "textures": {
            "up": "#top", "down": "#bottom", **{f: "#side" for f in faces[2:]}}},
        "stone": {"parent": "block/cube_all", "textures": {"all": "blocks/stone"}},
        "dirt": {"parent": "minecraft:block/cube_all", "textures": {"all": "blocks/dirt"}},
        "glowstone": {"parent": "block/cube_all", "textures": {"all": "blocks/glowstone"}},
        "grass": {"textures": {"top": "blocks/grass_top", "side": "blocks/grass_side",
                               "bottom": "blocks/dirt"},
                  "elements": [{**box, "faces": {
                      "up": {"texture": "#top", "tintindex": 0}, "down": {"texture": "#bottom"},
                      **{f: {"texture": "#side"} for f in faces[2:]}}}]},
    }
    for name, model in models.items():
        with open(os.path.join(mdir, name + ".json"), "w") as f:
            json.dump(model, f)
    for name in ("stone", "dirt", "grass"):
        with open(os.path.join(sdir, name + ".json"), "w") as f:
            json.dump({"variants": {"normal": {"model": "block/" + name}}}, f)
    with open(os.path.join(sdir, "glowstone.json"), "w") as f:
        json.dump({"variants": {"normal": [{"model": "block/glowstone"}]}}, f)
    rng = np.random.default_rng(seed)
    dirt = [0.45, 0.32, 0.22]
    for name, img in (("stone", _block_texture(rng, [0.5, 0.5, 0.52], 0.15)),
                      ("dirt", _block_texture(rng, dirt, 0.2)),
                      ("grass_top", _block_texture(rng, [0.75, 0.75, 0.75], 0.12)),
                      ("grass_side", _block_texture(rng, dirt, 0.2, (3, [0.3, 0.55, 0.2]))),
                      ("glowstone", _block_texture(rng, [0.95, 0.8, 0.5], 0.1))):
        save_image(os.path.join(tdir, name + ".png"), img)
    with open(os.path.join(root, "mapping.json"), "w") as f:
        json.dump([{"id": MC_IDS["stone"], "data": 0, "mask": 0, "blockstate": "stone"},
                   {"id": MC_IDS["grass"], "data": 0, "mask": 12, "blockstate": "grass"},
                   {"id": MC_IDS["dirt"], "data": 0, "mask": 0, "blockstate": "dirt"},
                   {"id": MC_IDS["glowstone"], "data": 0, "mask": 0,
                    "blockstate": "glowstone"}], f)
    with open(os.path.join(root, "emitters.json"), "w") as f:
        json.dump([{"texture": "blocks/glowstone", "primary_scale": 12.0}], f)


def ies_profile() -> str:
    """An LM-63 type-C profile with horizontal angles 0-90 (expanded by
    symmetry to the full circle): a forward-throwing cosine lobe whose
    strength varies with the horizontal angle."""
    vert = np.arange(0.0, 181.0, 10.0)
    horz = np.array([0.0, 30.0, 60.0, 90.0])
    cd = (np.clip(np.cos(np.deg2rad(vert)), 0.0, None)[None, :] ** 1.5 * 800.0
          * (1.0 - 0.4 * np.sin(np.deg2rad(horz))[:, None]) + 40.0)
    lines = ["IESNA:LM-63-2002", "[TEST] synthesized", "TILT=NONE",
             f"1 1000 1 {len(vert)} {len(horz)} 1 1 0.1 0.1 0.1", "1 1 100",
             " ".join(f"{v:.1f}" for v in vert), " ".join(f"{h:.1f}" for h in horz)]
    lines += [" ".join(f"{c:.3f}" for c in row) for row in cd]
    return "\n".join(lines) + "\n"


def _minecraft_dict(size: str) -> dict:
    res, spp, max_b = SIZES[size][4:]
    cam, look, lamp, lamp_scale = MC_WORLD[size][3:]
    return {
        "bsdfs": [{"name": "lamp", "type": "lambert", "albedo": 0.8}],
        "primitives": [
            {"type": "minecraft_map", "map_path": "world", "resource_packs": ["pack"]},
            {"type": "sphere", "bsdf": "lamp", "emission": "lamp.ies",
             "transform": {"position": lamp, "scale": lamp_scale, "rotation": [180, 0, 0]}},
            copy.deepcopy(SKYDOME),
        ],
        "camera": {"type": "pinhole", "tonemap": "filmic", "fov": 60, "resolution": list(res),
                   "transform": {"position": cam, "look_at": look, "up": [0, 1, 0]}},
        "integrator": {"type": "path_tracer", "max_bounces": max_b},
        # the CLI renders every pass in regen, as render_flat does
        "renderer": {"spp": spp, "spp_step": spp, "adaptive_sampling": False},
    }


def _write_sphere_obj(path: str, nu: int, nv: int):
    """Unit UV sphere, 2 * nu * nv triangles, with normals and uvs."""
    us = np.linspace(0.0, 2.0 * np.pi, nu + 1)
    vs = np.linspace(0.0, np.pi, nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing="xy")
    pos = np.stack([np.sin(vv) * np.cos(uu), np.cos(vv), np.sin(vv) * np.sin(uu)],
                   axis=-1).reshape(-1, 3)
    uv = np.stack([uu / (2.0 * np.pi), 1.0 - vv / np.pi], axis=-1).reshape(-1, 2)
    j, i = np.meshgrid(np.arange(nv), np.arange(nu), indexing="ij")
    a = (j * (nu + 1) + i).ravel()
    b, c = a + 1, a + nu + 1
    dd = c + 1
    faces = np.concatenate([np.stack([a, b, dd], 1), np.stack([a, dd, c], 1)]) + 1
    lines = [f"v {x:.7f} {y:.7f} {z:.7f}\nvn {x:.7f} {y:.7f} {z:.7f}" for x, y, z in pos]
    lines += [f"vt {s:.7f} {t:.7f}" for s, t in uv]
    lines += [f"f {p}/{p}/{p} {q}/{q}/{q} {r}/{r}/{r}" for p, q, r in faces]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _sky(w: int, h: int) -> np.ndarray:
    """Lat-long sky (row 0 = up): blue gradient, dim ground, bright sun."""
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v[:, None] * np.pi  # 0 at the zenith
    phi = (u[None, :] - 0.5) * 2.0 * np.pi
    up = np.cos(theta)
    sky = np.where(up[..., None] > 0.0,
                   np.array([0.35, 0.55, 1.0]) * (0.4 + 0.6 * up[..., None]),
                   np.array([0.25, 0.22, 0.2]) * np.ones_like(up)[..., None])
    sky = np.broadcast_to(sky, (h, w, 3)).copy()
    # sun at theta 40 deg, phi 60 deg, ~3 deg radius, radiance ~ 400
    sun_t, sun_p = np.deg2rad(40.0), np.deg2rad(60.0)
    dirs = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta) * np.ones_like(phi),
                     np.sin(theta) * np.sin(phi)], axis=-1)
    sun = np.array([np.sin(sun_t) * np.cos(sun_p), np.cos(sun_t), np.sin(sun_t) * np.sin(sun_p)])
    cosang = np.clip(dirs @ sun, -1.0, 1.0)
    blob = 400.0 * np.exp(-((np.arccos(cosang) / np.deg2rad(3.0)) ** 2))
    sky += blob[..., None] * np.array([1.0, 0.9, 0.75])
    return sky.astype(np.float32)


def _interior_dict(size: str) -> dict:
    res, spp, max_b = SIZES[size][4:]
    walls = [{"type": "cube", "bsdf": "floor" if i == 0 else "wall",
              "transform": {"position": p, "scale": sc}}
             for i, (p, sc) in enumerate(INTERIOR_WALLS)]
    return {
        "bsdfs": copy.deepcopy(INTERIOR_BSDFS),
        "primitives": walls + copy.deepcopy(INTERIOR_PRIMS),
        "camera": {"type": "pinhole", "tonemap": "filmic", "fov": 60,
                   "resolution": list(res),
                   "transform": {"position": [0.2, 1.7, 5.6], "look_at": [-0.3, 1.2, -2.0],
                                 "up": [0, 1, 0]}},
        "integrator": {"type": "path_tracer", "max_bounces": max_b},
        "renderer": {"spp": spp, "spp_step": spp},
    }


def _aperture_image(n: int = 32) -> np.ndarray:
    """A bitmap aperture: a ring, dimmer inside, with a bright spot on it."""
    c = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    x, y = np.meshgrid(c, c)
    r = np.hypot(x, y)
    img = np.where(r < 0.9, np.where(r > 0.6, 1.0, 0.25), 0.0)
    img = img + 4.0 * (np.hypot(x - 0.45, y + 0.45) < 0.2)
    return np.repeat(img[..., None], 3, -1).astype(np.float32)


def _camera_variant(doc: dict, size: str, variant: str) -> dict:
    """The camera scene's `variant` (CAMERA_VARIANTS) at `size`."""
    fields, rfilter, big, small = CAMERA_VARIANTS[variant]
    doc["primitives"][1]["name"] = "ball"  # the thinlens focus pivot
    doc["camera"].update(copy.deepcopy(fields), reconstruction_filter=rfilter,
                         resolution=list(small if size.startswith("small") else big))
    ldr = ".png" if size.startswith("small") else "_ldr.pfm"
    doc["renderer"].update(output_file=variant + ldr, hdr_output_file=variant + ".pfm")
    if variant in AOV_VARIANTS:
        doc["renderer"]["output_buffers"] = [
            {"type": t, "output_file": f"{variant}_{t}{ldr}",
             "hdr_output_file": f"{variant}_{t}.pfm"} for t in ("depth", "normal", "albedo")]
    return doc


def _box_variant(variant: str):
    """A box variant's (integrator, kinds): "progressive_photon_map+fog+beams"
    -> ("progressive_photon_map", ("fog", "beams")). Raises for an unknown
    part, or a volume photon type without the fog."""
    integ, *kinds = variant.split("+")
    bad = [k for k in kinds if k not in BOX_KINDS + VOLUME_PHOTON_TYPES]
    if (integ not in BOX_VARIANTS or bad
            or (any(k in VOLUME_PHOTON_TYPES for k in kinds) and "fog" not in kinds)
            or ("pt" in kinds and integ != "kelemen_mlt")):
        raise ValueError(f"box variant {variant!r}: an integrator of {list(BOX_VARIANTS)}, "
                         f"then +caustic, +fog or +fog+<one of {list(VOLUME_PHOTON_TYPES)}>; "
                         f"kelemen_mlt+pt")
    return integ, tuple(kinds)


def scene_dict(size: str, variant: str | None = None) -> dict:
    if size in INTERIOR:
        return _interior_dict(size)
    if size in MINECRAFT:
        return _minecraft_dict(size)
    nu, nv, sw, sh, res, spp, max_b = SIZES[size]
    doc = {
        "bsdfs": [
            {"name": "floor", "type": "lambert",
             "albedo": {"type": "checker", "on_color": [0.8, 0.8, 0.8],
                        "off_color": [0.2, 0.2, 0.2], "res_u": 20, "res_v": 20}},
            {"name": "ball", "type": "rough_conductor", "material": "Cu",
             "distribution": "ggx", "roughness": 0.1},
            {"name": "inner", "type": "lambert", "albedo": [0.6, 0.3, 0.2]},
        ],
        "primitives": [
            {"type": "quad", "bsdf": "floor",
             "transform": {"position": [0, 0, 0], "scale": [12, 1, 12]}},
            {"type": "mesh", "file": "ball.obj", "smooth": True, "bsdf": "ball",
             "transform": {"position": [0, 1, 0]}},
            {"type": "cube", "bsdf": "inner",
             "transform": {"position": [1.9, 0.5, 0.6], "scale": 1.0,
                           "rotation": [0, 30, 0]}},
            {"type": "infinite_sphere", "emission": "sky.pfm",
             "transform": {"rotation": [0, 20, 0]}},
        ],
        "camera": {"type": "pinhole", "tonemap": "filmic", "fov": 40,
                   "resolution": list(res),
                   "transform": {"position": [0.5, 2.2, 6.5], "look_at": [0.4, 0.8, 0],
                                 "up": [0, 1, 0]}},
        "integrator": {"type": "path_tracer", "max_bounces": max_b},
        "renderer": {"spp": spp, "spp_step": spp},
    }
    if size.endswith("-analytic"):
        doc["bsdfs"] += copy.deepcopy(ANALYTIC_BSDFS)
        doc["primitives"][3:3] = copy.deepcopy(ANALYTIC_PRIMS)  # before the env light
    if size.endswith("-area"):
        doc["primitives"][3:3] = copy.deepcopy(AREA_LIGHTS)  # before the env light
    if size in BOX:
        doc["bsdfs"].append(copy.deepcopy(BOX_BSDF))
        doc["primitives"] = doc["primitives"][1:3] + copy.deepcopy(BOX_PRIMS)
        integ, kinds = _box_variant(variant or "path_tracer")
        if integ == "bdpt_pyramid":
            doc["integrator"].update(type="bidirectional_path_tracer", image_pyramid=True)
        else:
            doc["integrator"]["type"] = integ
        if integ in ("photon_map", "progressive_photon_map"):
            doc["integrator"]["photon_count"] = PHOTON_COUNT[size]
        if integ == "photon_map":
            doc["integrator"]["gather_photon_count"] = GATHER_COUNT[size]
        if "pt" in kinds:
            doc["integrator"]["bidirectional"] = False
        if "caustic" in kinds:
            doc["bsdfs"] = [copy.deepcopy(CAUSTIC_BSDF) if b["name"] == "ball" else b
                            for b in doc["bsdfs"]]
        if "fog" in kinds:
            doc["media"] = [copy.deepcopy(FOG)]
            doc["camera"]["medium"] = "fog"
            for prim in doc["primitives"]:
                prim.update(ext_medium="fog", int_medium="fog")
        vtype = [k for k in kinds if k in VOLUME_PHOTON_TYPES]
        if vtype:
            doc["integrator"]["volume_photon_type"] = vtype[0]
    if size in LIGHTS:
        doc["primitives"] = (doc["primitives"][:3] + copy.deepcopy(LIGHTS_BEFORE_SKY)
                             + doc["primitives"][3:] + copy.deepcopy(LIGHTS_AFTER_SKY))
    if size in SURFACES:
        kind = SURFACES[size]
        doc["bsdfs"] = copy.deepcopy(SURFACE_BSDFS[kind])
        doc["primitives"][2:3] = copy.deepcopy(SURFACE_PRIMS[kind]) + [
            copy.deepcopy(SURFACE_LIGHT)]  # the cube's place, before the env light
    if size in CAMERA:
        doc = _camera_variant(doc, size, variant or "thinlens")
    if size in MEDIA:
        doc = _media_variant(doc, size, variant or "fog")
    if size in FIBER:
        doc = _fiber_dict(doc)
    return doc


def write_scene(out_dir: str, size: str = "small", variant: str | None = None) -> str:
    """Write the scene of `size` (a camera size's `variant`, thinlens by
    default; a media size's, fog by default; a box size's integrator,
    path_tracer by default) into out_dir; returns the scene.json path."""
    if size not in SIZES:
        raise ValueError(f"unknown size {size!r}; one of {sorted(SIZES)}")
    if size in BOX and variant is not None:
        _box_variant(variant)
    elif variant is not None and not ((size in CAMERA and variant in CAMERA_VARIANTS)
                                      or (size in MEDIA and variant in MEDIA_VARIANTS)):
        raise ValueError(f"variant {variant!r}: the camera sizes {CAMERA} have "
                         f"{sorted(CAMERA_VARIANTS)}, the media sizes {MEDIA} "
                         f"{list(MEDIA_VARIANTS)}, the box sizes {BOX} {list(BOX_VARIANTS)}")
    nu, nv, sw, sh = SIZES[size][:4]
    os.makedirs(out_dir, exist_ok=True)
    if size in MINECRAFT:
        _write_world(out_dir, size)
        write_pack(os.path.join(out_dir, "pack"))
        with open(os.path.join(out_dir, "lamp.ies"), "w") as f:
            f.write(ies_profile())
    else:
        _write_sphere_obj(os.path.join(out_dir, "ball.obj"), nu, nv)
    if size in FIBER:
        _write_strands(out_dir, size)
    if size.endswith("-area"):
        _write_sphere_obj(os.path.join(out_dir, "lamp.obj"), *LAMP_SEGMENTS)
    if size in ORB_SEGMENTS:
        _write_sphere_obj(os.path.join(out_dir, "orb.obj"), *ORB_SEGMENTS[size])
    if size in INTERIOR:
        save_hdr(os.path.join(out_dir, "sky.hdr"), _sky(sw, sh))
    elif size not in BOX + FIBER + MINECRAFT:
        save_pfm(os.path.join(out_dir, "sky.pfm"), _sky(sw, sh))
    if size in CAMERA and variant == "bitmap":
        save_pfm(os.path.join(out_dir, "aperture.pfm"), _aperture_image())
    if size in MEDIA and variant == "cloud":
        _write_cloud(out_dir, size)
    path = os.path.join(out_dir, "scene.json")
    with open(path, "w") as f:
        json.dump(scene_dict(size, variant), f, indent=1)
    return path


if __name__ == "__main__":
    print(write_scene(sys.argv[1], *sys.argv[2:4]))
