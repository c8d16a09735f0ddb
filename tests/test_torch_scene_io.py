"""radiance_tpu_torch scene I/O vs radiance_tpu's.

The port carries numpy copies of the JAX package's importers (OBJ, glTF
and GLB, STL, PLY, COLLADA, FBX), its GLB writer and its loader, so each
must give the JAX package's output exactly: the same arrays (dtype and
value) on the inputs that tests/test_loader.py, tests/test_meshformats.py
and tests/test_fbx.py build, the same GLB bytes, and from load_scene the
same TLAS blob and resources, with and without the AS cache.  The port's
PNG writer (numpy + zlib, no PIL) must read back through PIL as the
array it was given.
"""

import dataclasses
import json
import shutil
import struct

import numpy as np
import pytest
import torch

from radiance_tpu.scene import glb_writer as jglb
from radiance_tpu.scene import gltf as jgltf
from radiance_tpu.scene import loader as jloader
from radiance_tpu.scene import meshformats as jmesh

from radiance_tpu_torch.scene import glb_writer as tglb
from radiance_tpu_torch.scene import gltf as tgltf
from radiance_tpu_torch.scene import loader as tloader
from radiance_tpu_torch.scene import meshformats as tmesh
from radiance_tpu_torch.utils import image as timage

from test_fbx import _ASCII_DOC, _cube_doc, _write_binary_fbx
from test_loader import two_mesh_glb
from test_meshformats import _DAE_DOC, _cube_tris


def assert_same(a, b, where="value"):
    """Deep equality: arrays by dtype and value (NaNs equal), dataclasses
    and containers field by field."""
    if isinstance(b, torch.Tensor):
        b = b.cpu().numpy()
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{where}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{where}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), f"{where}: keys differ"
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


# ------------------------------------------------------ mesh file builders

def _obj(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvt 0 0\nvt 1 0\n"
                 "vt 0 1\nvn 0 0 1\nf 1/1/1 2/2/1 4/3/1 3/1/1\n")
    return p


def _stl_binary(tmp_path):
    v, f = _cube_tris()
    p = tmp_path / "cube.stl"
    with open(p, "wb") as fh:
        fh.write(b"\0" * 80 + struct.pack("<I", len(f)))
        for tri in f:
            fh.write(struct.pack("<3f", 0, 0, 0))
            for i in tri:
                fh.write(struct.pack("<3f", *v[i]))
            fh.write(struct.pack("<H", 0))
    return p


def _stl_ascii(tmp_path):
    v, f = _cube_tris()
    p = tmp_path / "cube_ascii.stl"
    lines = ["solid cube"]
    for tri in f:
        lines += [" facet normal 0 0 0", "  outer loop"]
        lines += [f"   vertex {v[i][0]} {v[i][1]} {v[i][2]}" for i in tri]
        lines += ["  endloop", " endfacet"]
    p.write_text("\n".join(lines + ["endsolid cube", ""]))
    return p


def _ply_ascii(tmp_path):
    p = tmp_path / "quad.ply"
    p.write_text(
        "ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\n"
        "property float y\nproperty float z\nproperty float nx\n"
        "property float ny\nproperty float nz\nproperty float s\n"
        "property float t\nelement face 1\n"
        "property list uchar int vertex_indices\nend_header\n"
        "0 0 0 0 0 1 0 0\n1 0 0 0 0 1 1 0\n1 1 0 0 0 1 1 1\n"
        "0 1 0 0 0 1 0 1\n4 0 1 2 3\n")
    return p


def _ply_binary(tmp_path):
    v, f = _cube_tris()
    p = tmp_path / "cube.ply"
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(v)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(f)}\n"
            "property list uchar uint vertex_indices\nend_header\n")
    with open(p, "wb") as fh:
        fh.write(head.encode() + v.astype("<f4").tobytes())
        for tri in f:
            fh.write(struct.pack("<B", 3) + np.asarray(tri, "<u4").tobytes())
    return p


def _dae(tmp_path):
    p = tmp_path / "scene.dae"
    p.write_text(_DAE_DOC)
    return p


def _fbx_7400(tmp_path):
    p = tmp_path / "cube.fbx"
    _write_binary_fbx(p, _cube_doc(), version=7400)
    return p


def _fbx_7500z(tmp_path):
    p = tmp_path / "cube75.fbx"
    _write_binary_fbx(p, _cube_doc(), version=7500, compress=True)
    return p


def _fbx_ascii(tmp_path):
    p = tmp_path / "cube_ascii.fbx"
    p.write_text(_ASCII_DOC)
    return p


MESH_FILES = [_obj, _stl_binary, _stl_ascii, _ply_ascii, _ply_binary, _dae,
              _fbx_7400, _fbx_7500z, _fbx_ascii]


@pytest.mark.parametrize("make", MESH_FILES, ids=lambda f: f.__name__[1:])
def test_mesh_importers_match_jax(tmp_path, make):
    """load_mesh (obj/stl/ply/dae/fbx dispatch): vertices, triangles,
    normals and UVs array-equal to the JAX package's."""
    path = str(make(tmp_path))
    assert_same(jmesh.load_mesh(path), tmesh.load_mesh(path), "mesh")


def _external_gltf(tmp_path):
    """two_mesh_glb cracked into .gltf + scene.bin + tex0.png (the
    on-disk layout of tests/test_loader.py::test_external_file_gltf)."""
    with open(two_mesh_glb(tmp_path, with_texture=True), "rb") as f:
        blob = f.read()
    _, _, length = struct.unpack_from("<4sII", blob, 0)
    off, doc, bin_chunk = 12, None, b""
    while off < length:
        n, kind = struct.unpack_from("<I4s", blob, off)
        data = blob[off + 8:off + 8 + n]
        if kind == b"JSON":
            doc = json.loads(data)
        elif kind == b"BIN\x00":
            bin_chunk = data
        off += 8 + n
    (tmp_path / "scene.bin").write_bytes(bin_chunk)
    doc["buffers"] = [{"uri": "scene.bin", "byteLength": len(bin_chunk)}]
    bv = doc["bufferViews"][doc["images"][0]["bufferView"]]
    start = bv.get("byteOffset", 0)
    (tmp_path / "tex0.png").write_bytes(
        bin_chunk[start:start + bv["byteLength"]])
    doc["images"][0] = {"uri": "tex0.png"}
    path = tmp_path / "scene.gltf"
    path.write_text(json.dumps(doc))
    return path


@pytest.mark.parametrize("form", ["embedded", "external"])
def test_gltf_parse_matches_jax(tmp_path, form):
    """parse_glb: primitives, materials, images, nodes and the flattened
    instance transforms equal to the JAX package's."""
    path = str(two_mesh_glb(tmp_path) if form == "embedded"
               else _external_gltf(tmp_path))
    js, ts = jgltf.parse_glb(path), tgltf.parse_glb(path)
    assert_same(js, ts, "scene")
    assert_same(js.instances(), ts.instances(), "instances")


def test_write_glb_bytes_match_jax():
    rng = np.random.default_rng(3)
    meshes = [dict(positions=rng.normal(size=(5, 3)).astype(np.float32),
                   normals=rng.normal(size=(5, 3)).astype(np.float32),
                   uvs=rng.uniform(size=(5, 2)).astype(np.float32),
                   indices=np.array([[0, 1, 2], [2, 3, 4]], np.uint32),
                   material=0),
              dict(positions=rng.normal(size=(3, 3)).astype(np.float32),
                   indices=np.array([[0, 1, 2]], np.uint32))]
    materials = [dict(baseColorFactor=(1, 0.5, 0, 1), metallicFactor=0.3,
                      roughnessFactor=0.4, transmission=0.2, ior=1.5,
                      baseColorTexture=0)]
    images = [timage.encode_png(np.full((4, 4, 4), 77, np.uint8))]
    nodes = [{"mesh": 0, "children": [1]},
             {"mesh": 1, "translation": [1, 2, 3]}]
    jb = jglb.write_glb(None, meshes, materials, images, nodes)
    tb = tglb.write_glb(None, meshes, materials, images, nodes)
    assert jb == tb


def _assert_resources_equal(jres, tres):
    assert jres.keys() == tres.keys()
    for k, v in jres.items():
        if k == "sampler":
            assert (v.addressing, v.filter) == (tres[k].addressing,
                                                tres[k].filter)
        elif v is None:
            assert tres[k] is None, k
        else:
            assert_same(np.asarray(v), tres[k], k)


@pytest.mark.parametrize("use_cache", [False, True])
@pytest.mark.parametrize("kind", ["glb", "obj"])
def test_load_scene_matches_jax(tmp_path, use_cache, kind):
    """load_scene: the TLAS blob byte-equal and the resources equal to
    the JAX loader's; with the cache, both the building call (which
    writes <path>.cache) and the cache-loading call, whose device scene
    equals the built one tensor for tensor."""
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    if kind == "glb":
        src = two_mesh_glb(tmp_path, with_texture=True)
    else:
        src = str(_obj(tmp_path))
    jpath = shutil.copy(src, tmp_path / "j")
    tpath = shutil.copy(src, tmp_path / "t")
    scenes = []
    for _ in range(2 if use_cache else 1):
        js = jloader.load_scene(jpath, use_cache=use_cache, tex_dim=16,
                                verbose=False)
        ts = tloader.load_scene(tpath, use_cache=use_cache, tex_dim=16,
                                verbose=False, device="cpu")
        assert js.tlas.blob == ts.tlas.blob
        _assert_resources_equal(js.resources, ts.resources)
        assert_same(js.mesh_infos, ts.mesh_infos, "mesh_infos")
        assert_same(js.materials, ts.materials, "materials")
        scenes.append(ts)
    if use_cache:
        built, loaded = (s.device_scene("cpu") for s in scenes)
        assert not scenes[1].instances      # the second came from .cache
        assert_same(dataclasses.asdict(built), dataclasses.asdict(loaded),
                    "device scene")


@pytest.mark.parametrize("channels", [3, 4])
def test_png_writer_reads_back_through_pil(tmp_path, channels):
    from PIL import Image

    rng = np.random.default_rng(channels)
    arr = rng.integers(0, 256, size=(17, 23, channels), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    timage.write_image(path, arr)
    back = np.asarray(Image.open(path))
    assert back.shape == arr.shape
    np.testing.assert_array_equal(back, arr)
