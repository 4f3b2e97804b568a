"""The port's host side of the curves, the skydome, the IES textures and
minecraft_map against the JAX package: the arrays must be equal.

  * the strand loaders (.hair, .fiber) and tessellate.curve_tubes (the
    port walks the strands of one node count together; rings, uvs,
    triangles, normals and tangents equal the JAX package's strand-by-strand
    walk bit for bit, with taper, subsample and the max_tris stride);
  * NBT parse and write, the Anvil region reader and writer, the exposed
    faces and their quads, load_minecraft_map, the built-in palette and the
    resource packs (parent chains, '#var' references, the mapping.json
    mask, emitters.json, tinted faces) with the textures they register;
  * the Hosek-Wilkie skydome bake and the IES bake at rtol 1e-6, and the
    texture specs that reach them (".ies", {"type": "ies"}, "_prebuilt");
  * flatten_scene of small-hair, small-mc, small-mc on the built-in
    palette and a skydome beside an infinite_sphere: every table equal
    (tri_tan and hair's tables included, the light rows of the minecraft
    groups under their pseudo primitive ids), the static facts equal.
"""
import dataclasses
import json
import os
import struct
import warnings

import numpy as np
import pytest
import torch

from test_torch_host import _tensors, jax_arrays, numpy_bvh  # noqa: F401
from tungsten_tpu_torch import synth


def _equal(a, b, label=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (label, a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=label)


def write_fiber(path, counts, pos, width=None):
    """A Tungsten .fiber file (CurveIO.cpp saveFiber): the num_vertices
    (per curve, u16), position (f32 x 3) and, where given, width (f32)
    attributes."""
    def attr(name, per_curve, vtype, vper, payload):
        desc = struct.pack("<QHBB", len(payload), int(per_curve), vtype, vper) + name + b"\0"
        return struct.pack("<Q", 8 + len(desc)) + desc + payload

    body = attr(b"num_vertices", True, 3, 1, np.asarray(counts, "<u2").tobytes())
    body += attr(b"position", False, 8, 3, np.asarray(pos, "<f4").tobytes())
    if width is not None:
        body += attr(b"width", False, 8, 1, np.asarray(width, "<f4").tobytes())
    head = bytes([0x80, 0xBF, 0x80, 0x46, 0x49, 0x42, 0x45, 0x52]) + struct.pack(
        "<HHIQQQ", 1, 0, 0, 40, len(pos), len(counts))
    with open(path, "wb") as f:
        f.write(head + body + struct.pack("<Q", 0))


def test_hair_and_fiber_files_load_as_in_jax(tmp_path):
    from test_curves import _write_hair
    from tungsten_tpu.io import curveio as jio
    from tungsten_tpu_torch.io import curveio

    _write_hair(str(tmp_path / "t.hair"))  # tests/test_curves.py's: segments, no thickness
    pts, radius = synth.strands("small-hair")
    synth.write_hair(str(tmp_path / "s.hair"), pts[:9], 2.0 * radius[:9])
    rng = np.random.default_rng(3)
    counts = rng.integers(2, 7, 11)
    pos = rng.normal(size=(int(counts.sum()), 3)).astype(np.float32)
    write_fiber(str(tmp_path / "w.fiber"), counts, pos, rng.uniform(0.01, 0.02, len(pos)))
    write_fiber(str(tmp_path / "short.fiber"), counts, pos, np.full(5, 0.03))  # widths run out
    write_fiber(str(tmp_path / "bare.fiber"), counts, pos)  # no width: 1e-2
    for name in ("t.hair", "s.hair", "w.fiber", "short.fiber", "bare.fiber"):
        mine, theirs = (m.load_curves(str(tmp_path / name)) for m in (curveio, jio))
        for a, b in zip(mine, theirs):
            _equal(a, b, name)
    ends, nodes = curveio.load_curves(str(tmp_path / "s.hair"))
    _equal(ends, np.arange(1, 10, dtype=np.uint32) * 25)
    np.testing.assert_allclose(nodes[:25, 3], radius[0], rtol=1e-6)
    np.testing.assert_allclose(nodes[:, :3], pts[:9].reshape(-1, 3))
    with open(tmp_path / "bad.hair", "wb") as f:
        f.write(b"HAIX" + bytes(128))
    with pytest.raises(ValueError, match="not a HAIR"):
        curveio.load_hair(str(tmp_path / "bad.hair"))


def _ragged(rng, n=300, m=9):
    """Strands of 1..m nodes (single-node strands are skipped), every 7th one
    straight up (the frame's side case)."""
    pts, ends, c = [], [], 0
    for i in range(n):
        k = int(rng.integers(1, m + 1))
        t = np.linspace(0.0, 1.0, k)
        base = rng.uniform(-1, 1, 3)
        curl = np.stack([0.05 * np.cos(10 * t + i), t, 0.05 * np.sin(10 * t + i)], 1)
        pts.append(base + (curl * [0, 1, 0] if i % 7 == 0 else curl))
        c += k
        ends.append(c)
    nodes = np.concatenate([np.concatenate(pts), rng.uniform(1e-3, 3e-3, (c, 1))], 1)
    return np.array(ends), nodes.astype(np.float32)


@pytest.mark.parametrize("case", ["ragged", "ragged-taper-subsample", "stride-4-sides",
                                  "small-hair", "hair-synth-512"])
def test_curve_tubes_match_jax(case):
    from tungsten_tpu.models.primitives.tessellate import curve_tubes as jtubes
    from tungsten_tpu_torch.models.primitives.tessellate import curve_tubes

    rng = np.random.default_rng(5)
    kw = {}
    if case.startswith("ragged"):
        ends, nodes = _ragged(rng)
        if case.endswith("subsample"):
            kw = dict(taper=True, subsample=0.5, seed=11)
    else:
        size = "small-hair" if case == "small-hair" else "hair-synth"
        pts, radius = synth.strands(size)
        n = 512 if case == "hair-synth-512" else len(pts)
        nodes = np.concatenate([pts[:n].reshape(-1, 3), radius[:n].reshape(-1, 1)], 1)
        ends = np.arange(1, n + 1) * pts.shape[1]
        if case == "stride-4-sides":
            kw = dict(sides=4, max_tris=5000)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mine = curve_tubes(ends, nodes, **kw)
        theirs = jtubes(ends, nodes, **kw)
    for k in ("pos", "normal", "uv", "indices", "tangent"):
        _equal(getattr(mine, k), getattr(theirs, k), k)
    strided = [str(w.message) for w in caught if "max_tris" in str(w.message)]
    assert len(strided) == (2 if "stride" in case else 0)
    if "stride" in case:
        assert strided[0] == strided[1]
    if case == "small-hair":
        assert mine.indices.shape == (64 * 24 * 3 * 2, 3)


def test_empty_curves_give_an_empty_soup():
    from tungsten_tpu_torch.models.primitives.tessellate import curve_tubes

    soup = curve_tubes(np.array([1, 2]), np.ones((2, 4), np.float32))
    assert soup.indices.shape == (0, 3) and soup.pos.shape == (0, 3) and soup.tangent is None


def _nbt_tag(n):
    return n.NbtTag("", n.TAG_COMPOUND, {
        "b": n.NbtTag("b", n.TAG_BYTE, -3),
        "s": n.NbtTag("s", n.TAG_SHORT, -1234),
        "i": n.NbtTag("i", n.TAG_INT, 123456),
        "l": n.NbtTag("l", n.TAG_LONG, -(1 << 40)),
        "f": n.NbtTag("f", n.TAG_FLOAT, 1.5),
        "d": n.NbtTag("d", n.TAG_DOUBLE, -2.25),
        "ba": n.NbtTag("ba", n.TAG_BYTE_ARRAY, np.arange(-4, 4, dtype=np.int8)),
        "ia": n.NbtTag("ia", n.TAG_INT_ARRAY, np.array([1, -2, 3], np.int32)),
        "st": n.NbtTag("st", n.TAG_STRING, "hello nbt"),
        "li": n.NbtTag("li", n.TAG_LIST, [n.NbtTag("", n.TAG_INT, 7),
                                          n.NbtTag("", n.TAG_INT, 8)]),
        "cp": n.NbtTag("cp", n.TAG_COMPOUND, {"x": n.NbtTag("x", n.TAG_INT, 42)}),
    })


def test_nbt_matches_jax():
    """tests/test_minecraft.py's round trip of every tag type: the port's
    writer gives the JAX writer's bytes, and the port's parser reads them
    back as the JAX parser does (missing tags falsy)."""
    from tungsten_tpu.io import nbt as jn
    from tungsten_tpu_torch.io import nbt as n

    data = n.write_nbt(_nbt_tag(n))
    assert data == jn.write_nbt(_nbt_tag(jn))
    r, jr = n.parse_nbt(data), jn.parse_nbt(data)
    for k in ("b", "s", "i", "l"):
        assert r[k].as_int() == jr[k].as_int()
    assert r["f"].value == jr["f"].value == 1.5 and r["d"].value == -2.25
    _equal(r["ba"].as_array(), jr["ba"].as_array())
    _equal(r["ia"].as_array(), jr["ia"].as_array())
    assert r["st"].value == "hello nbt" and r["li"].subtag(1).as_int() == 8
    assert r["cp"]["x"].as_int() == 42
    assert not r["nope"] and not r["cp"]["nope"]


def _world(tmp_path, size="small-mc"):
    path = synth.write_scene(str(tmp_path / size), size)
    return os.path.dirname(path)


def test_anvil_matches_jax(tmp_path):
    """small-mc's region (written by the port's writer, one chunk of four
    sections) and a chunk with data nibbles decode as in the JAX package;
    the writers give the JAX writers' bytes."""
    from tungsten_tpu.io import anvil as jav
    from tungsten_tpu_torch.io import anvil as av

    out = _world(tmp_path)
    world = os.path.join(out, "world")
    mine, theirs = av.load_world(world), jav.load_world(world)
    assert list(mine) == list(theirs) == [(0, 0)]
    for a, b in zip(mine[(0, 0)], theirs[(0, 0)]):
        _equal(a, b)
    grid, _, height = mine[(0, 0)]
    blocks = synth.world_blocks("small-mc")
    _equal(grid[:16, :16, :16], blocks.transpose(1, 0, 2).astype(np.uint16) << 4)
    assert height == int(np.nonzero(blocks.any(axis=(1, 2)))[0][-1]) + 1

    ids = np.zeros((16, 16, 16), np.uint8)
    ids[2, 3, 4] = 35
    data = np.zeros((16, 16, 16), np.uint8)
    data[2, 3, 4] = 11
    chunk = av.make_chunk_nbt(ids, chunk_y=1, data_nibbles=data)
    assert chunk == jav.make_chunk_nbt(ids, chunk_y=1, data_nibbles=data)
    for w, name in ((av, "p.mca"), (jav, "j.mca")):
        os.makedirs(tmp_path / "w2" / "region", exist_ok=True)
        w.write_region(str(tmp_path / name), {(0, 0): chunk, (3, 1): chunk})
    assert (tmp_path / "p.mca").read_bytes() == (tmp_path / "j.mca").read_bytes()
    os.replace(tmp_path / "p.mca", tmp_path / "w2" / "region" / "r.0.0.mca")
    grid2, _, h2 = av.load_world(str(tmp_path / "w2"))[(0, 0)]
    assert grid2[3, 16 + 2, 4] == (35 << 4) | 11 and h2 == 16 + 3
    assert grid2[16 + 3, 16 + 2, 3 * 16 + 4] == (35 << 4) | 11


def test_minecraft_geometry_matches_jax(tmp_path):
    """exposed_faces, faces_to_quads, load_minecraft_map (with the faces'
    packed ids, axes, signs and uvs) and the built-in palette's materials."""
    from tungsten_tpu.models.primitives import minecraft as jmc
    from tungsten_tpu_torch.models.primitives import minecraft as mc

    world = os.path.join(_world(tmp_path), "world")
    mine = mc.load_minecraft_map(world, with_faces=True)
    theirs = jmc.load_minecraft_map(world, with_faces=True)
    for a, b in zip(mine, theirs):
        _equal(a, b)
    for a, b in zip(mc.block_materials(mine[2]), jmc.block_materials(theirs[2])):
        assert (a.tolist() if isinstance(a, np.ndarray) else a) == (
            b.tolist() if isinstance(b, np.ndarray) else b)
    grid = np.zeros((4, 4, 4), np.uint16)
    grid[1, 1, 1] = grid[1, 1, 2] = 1 << 4  # two touching blocks: 10 faces
    faces = mc.exposed_faces(grid)
    for a, b in zip(faces, jmc.exposed_faces(grid)):
        _equal(a, b)
    assert len(faces[0]) == 10
    for a, b in zip(mc.faces_to_quads(*faces, (16, 32)), jmc.faces_to_quads(*faces, (16, 32))):
        _equal(a, b)
    with pytest.raises(ValueError, match="no region data"):
        mc.load_minecraft_map(str(tmp_path))


def test_resource_pack_matches_jax(tmp_path):
    """The pack synth writes: model resolution through the parent chain and
    '#var' references, the six face textures and tints of every mapped
    block (the mask covering the data nibbles), emitters.json, and
    block_materials_pack's specs, face materials, emissions and the
    textures it registers."""
    from tungsten_tpu.models.primitives import mc_resources as jres
    from tungsten_tpu.models.primitives import minecraft as jmc
    from tungsten_tpu.models.textures import TextureBuilder as JTextureBuilder
    from tungsten_tpu_torch.models.primitives import mc_resources as res
    from tungsten_tpu_torch.models.textures.textures import TextureBuilder

    out = _world(tmp_path)
    root = os.path.join(out, "pack")
    rp, jrp = res.ResourcePack([root]), jres.ResourcePack([root])
    for name in ("block/stone", "block/dirt", "block/grass", "block/glowstone"):
        assert rp.resolve_model(name) == jrp.resolve_model(name)
    assert rp.resolve_model("block/dirt")["textures"]["up"] == "blocks/dirt"
    for bid in synth.MC_IDS.values():
        for data in (0, 3, 7):
            assert rp.face_textures((bid << 4) | data) == jrp.face_textures((bid << 4) | data)
    texs, tints = rp.face_textures(synth.MC_IDS["grass"] << 4)
    assert texs[2] == "blocks/grass_top" and tints[2] and not any(tints[:2] + tints[3:])
    assert rp.face_textures((synth.MC_IDS["grass"] << 4) | 4) is None  # outside the mask
    assert rp.emission_of("blocks/glowstone") == jrp.emission_of("blocks/glowstone")
    assert rp.emission_of("blocks/stone") is None
    _equal(rp.texture_image("blocks/stone"), jrp.texture_image("blocks/stone"))

    pos, idx, fids, pk, fax, fsg, quv = jmc.load_minecraft_map(os.path.join(out, "world"),
                                                               with_faces=True)
    tb, jtb = TextureBuilder(), JTextureBuilder()
    mine = res.block_materials_pack(pk, fax, fsg, rp, tb)
    theirs = jres.block_materials_pack(pk, fax, fsg, jrp, jtb)
    assert mine[0] == theirs[0] and mine[2] == theirs[2]
    _equal(mine[1], theirs[1])
    assert sum(e is not None for e in mine[2]) == 5  # glowstone's faces but the bottom
    jtab = jtb.build()
    arrays = tb.build_arrays()
    _equal(arrays["tpack"], np.asarray(jtab.tpack))
    _equal(arrays["data"], np.asarray(jtab.data))


@pytest.mark.parametrize("sun,kw", [([0.3, 0.8, 0.1], dict(turbidity=3.0, intensity=4.0)),
                                    ([-0.4, 0.5, 0.75], {}),
                                    ([0.0, 0.05, 1.0], dict(turbidity=8.0, temperature=4000.0,
                                                            gamma_scale=1.5)),
                                    ([0.2, -0.3, 0.9], dict(turbidity=1.5))])
def test_skydome_bake_matches_jax(sun, kw):
    """bake_skydome at rtol 1e-6 (the sun high, at 30 degrees, grazing and
    below the horizon); the zenith row lit and the rows under the 2-row
    horizon extension black (tests/test_sky_cap.py)."""
    from tungsten_tpu.models.primitives.sky import bake_skydome as jbake
    from tungsten_tpu_torch.models.primitives.sky import bake_skydome

    img = bake_skydome(sun, **kw)
    np.testing.assert_allclose(img, jbake(sun, **kw), rtol=1e-6, atol=0)
    assert img.shape == (256, 512, 3) and img.dtype == np.float32
    assert img[130:].max() == 0.0
    np.testing.assert_allclose(img[128], img[127])
    if sun[1] > 0:
        assert img[0].mean() > 0.0


def _jax_ies_profile():
    """tests/test_textures.py's profile: isotropic, a cosine falloff."""
    vert = np.linspace(0, 180, 19)
    cand = np.cos(np.deg2rad(vert)).clip(0) * 100.0
    return ("IESNA:LM-63-1995\nTILT=NONE\n" + f"1 1000 1 {len(vert)} 1 1 1 0 0 0\n1 1 100\n"
            + " ".join(f"{v:.1f}" for v in vert) + "\n0\n"
            + " ".join(f"{c:.3f}" for c in cand) + "\n")


@pytest.mark.parametrize("profile", ["isotropic", "synth", "malformed"])
def test_ies_bake_matches_jax(tmp_path, profile):
    """parse_ies and bake_ies at rtol 1e-6 (synth's profile has horizontal
    angles 0-90, expanded by symmetry); a malformed file bakes the uniform
    1 / 2 pi; the texture specs that reach the bake register the JAX
    package's clamped bitmaps, and a `_prebuilt` entry is its id."""
    from tungsten_tpu.models.textures import TextureBuilder as JTextureBuilder
    from tungsten_tpu.models.textures.ies import bake_ies_file as jbake_file
    from tungsten_tpu.models.textures.textures import texture_from_spec as jspec
    from tungsten_tpu_torch.models.textures.ies import bake_ies, bake_ies_file, parse_ies
    from tungsten_tpu_torch.models.textures.textures import TextureBuilder, texture_from_spec

    text = {"isotropic": _jax_ies_profile(), "synth": synth.ies_profile(),
            "malformed": "IESNA:LM-63\nno tilt line\n"}[profile]
    path = str(tmp_path / "lamp.ies")
    with open(path, "w") as f:
        f.write(text)
    for res in (32, 256):
        np.testing.assert_allclose(bake_ies_file(path, res), jbake_file(path, res), rtol=1e-6,
                                   atol=0)
    if profile != "malformed":
        img = bake_ies(*parse_ies(text), resolution=32)
        assert img.max() == 1.0 and img[-1, 0, 0] == 1.0  # vert 0 at the bottom row
    tb, jtb = TextureBuilder(), JTextureBuilder()
    for spec in ("lamp.ies", {"type": "ies", "file": "lamp.ies", "resolution": 16},
                 {"type": "_prebuilt", "id": 0}):
        def resolve(p):
            return str(tmp_path / p)

        assert texture_from_spec(spec, tb, resolve) == jspec(spec, jtb, resolve)
    arrays, jtab = tb.build_arrays(), jtb.build()
    _equal(arrays["tpack"], np.asarray(jtab.tpack))
    assert (arrays["tpack"][:, 3] == 1.0).all()  # clamped
    _equal(arrays["data"], np.asarray(jtab.data))
    _equal(arrays["data4"], np.asarray(jtab.data4))


def _edit(path, fn):
    with open(path) as f:
        doc = json.load(f)
    fn(doc)
    with open(path, "w") as f:
        json.dump(doc, f)


def _palette(doc):  # the built-in block palette: no resource packs
    del doc["primitives"][0]["resource_packs"]


def _two_skies(doc):  # a skydome, then an unsampled constant env after it
    doc["primitives"].append({"type": "infinite_sphere", "emission": [0.1, 0.2, 0.3],
                              "sample": False})


@pytest.mark.parametrize("case", ["small-hair", "small-mc", "small-mc-palette",
                                  "small-hair-two-skies"])
def test_flatten_matches_jax(numpy_bvh, tmp_path, case):  # noqa: F811
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch.scene.flatten import SceneMeta, flatten_scene, from_arrays
    from tungsten_tpu_torch.scene.load import load_scene

    size = "small-mc" if case.startswith("small-mc") else "small-hair"
    path = synth.write_scene(str(tmp_path / case), size)
    if case.endswith("palette"):
        _edit(path, _palette)
    if case.endswith("two-skies"):
        _edit(path, _two_skies)
    cpu = torch.device("cpu")
    js = jflatten(jload(path))
    mine, theirs = flatten_scene(load_scene(path), cpu), from_arrays(jax_arrays(js), js.meta, cpu)
    a, b = _tensors(mine), _tensors(theirs)
    for s, t in ((a, mine), (b, theirs)):
        s["tri_tan"], s["tri_light"], s["lights.tri_idx"] = t.tri_tan, t.tri_light, t.lights.tri_idx
        s["lights.cdf"], s["lights.tex"] = t.lights.cdf, t.lights.tex
        for k in ("hair_tables", "hair_cdf", "hair_sums"):
            if getattr(t.materials, k) is not None:
                s[f"materials.{k}"] = getattr(t.materials, k)
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k].numpy(), b[k].numpy()
        assert x.shape == y.shape and x.dtype == y.dtype, k
        if k.startswith("pbvh") or not np.issubdtype(x.dtype, np.floating):
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=0, err_msg=k)
    for f in (f.name for f in dataclasses.fields(SceneMeta)):
        assert getattr(mine.meta, f) == getattr(js.meta, f), f
    assert mine.lights.apx_kind == tuple(js.lights.apx_kind)
    m = mine.meta
    if size == "small-hair":
        assert m.has_fiber_tan and mine.materials.present == (0, 3, 18, 19, 20)
        fiber = mine.tri_tan.norm(dim=-1) > 0.5
        assert int(fiber.sum()) == 64 * 24 * 6 and mine.tri_tan.shape[0] == mine.tris.v0.shape[0]
        # the skydome: identity rotation, its bake as the env bitmap; the
        # constant env after it wins the escapes
        sky = mine.envs[0]
        assert torch.equal(sky.rot, torch.eye(3)) and sky.tex_kind == 2
        assert m.n_envs == (2 if case.endswith("two-skies") else 1) and m.env_const[0] is False
    else:
        assert not m.has_fiber_tan and mine.tri_tan.shape == (1, 3)
        # the glowstone groups (with the pack one per face direction, five:
        # the sixth lies on the grass; one on the palette), the IES sphere
        # (analytic) and the skydome
        groups = 1 if case.endswith("palette") else 5
        assert mine.lights.apx_kind == ("none",) * groups + ("sphere", "const")
        assert m.n_lights == groups + 2 and m.has_analytic
        n_tex = mine.textures.tpack.shape[0]
        assert (mine.textures.tpack[:, -1] == 2).sum() >= (2 if case.endswith("palette") else 7)
        assert n_tex == theirs.textures.tpack.shape[0]
