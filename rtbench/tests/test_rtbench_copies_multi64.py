"""rtbench/geometry/multi64.py against its original, bench.py's
_build_multi_tlas (bench.py:705-737), at a small size: literals printed
by bench.py's own loop (bench.py may not be imported here)."""

import hashlib

import numpy as np

from conftest import ROOT  # noqa: F401  (puts the repository on sys.path)
from rtbench.geometry import multi64


def test_multi64_matches_bench_build_multi_tlas():
    # bench.N_TRIS = 7680; bench._build_multi_tlas(): every instance's
    # BLAS vertices under its transform, in instance order
    v, t = multi64.generate(7680)
    assert v.shape == (23040, 3) and t.shape == (7680, 3)
    assert hashlib.sha256(v.tobytes()).hexdigest() == (
        "a9ef0aacf759af8886a3eacea39c26aeafe632aa1c7b140a102bddbe8ebaea58")
    assert v[-1].tolist() == [-31.280479431152344, -3.2309184074401855,
                              -30.6769962310791]
    assert (t == np.arange(23040, dtype=np.uint32).reshape(-1, 3)).all()
    meshes, translations, mesh_of = multi64.scene(7680)
    assert [len(m) for m in meshes] == [360] * 8
    assert translations.shape == (64, 3)
    assert (mesh_of == np.repeat(np.arange(8), 8)).all()


def test_world_normals_are_the_meshes_flat_normals():
    meshes, translations, mesh_of = multi64.scene(7680)
    verts, tris, fn = multi64.world(meshes, translations, mesh_of)
    assert fn.shape == (len(tris), 3)
    assert np.allclose(np.linalg.norm(fn, axis=-1), 1.0, atol=1e-6)
    per = len(meshes[0]) // 3
    for i in (0, 9, 63):
        assert np.array_equal(fn[i * per:(i + 1) * per],
                              multi64.flat_normals(meshes[mesh_of[i]]))
