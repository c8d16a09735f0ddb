"""radiance_tpu_torch's procedural stress scenes vs radiance_tpu's.

interior_hall (bench.py's interior scene, where temporal t-bounds are
measured) and random_triangle_cloud of the port's scene/procedural.py are
numpy-only copies of the JAX module's: the same arrays from the same
seeds (as bytes and dtype), the same meta, and for the cloud the same
TLAS blob, resources, mesh infos and materials.
"""

import numpy as np
import pytest

from radiance_tpu.scene import procedural as jproc

from radiance_tpu_torch.scene import procedural as tproc

from test_torch_scene_io import _assert_resources_equal, assert_same


@pytest.mark.parametrize("n_tris,seed", [(3_000, 11), (20_000, 11),
                                         (12_345, 4)])
def test_interior_hall_matches_jax(n_tris, seed):
    jv, jt, jmeta = jproc.interior_hall(n_tris, seed=seed)
    tv, tt, tmeta = tproc.interior_hall(n_tris, seed=seed)
    assert_same(jv, tv, "verts")
    assert_same(jt, tt, "tris")
    assert jmeta == tmeta
    assert abs(len(tt) - n_tris) < 0.1 * n_tris     # the budget is met


@pytest.mark.parametrize("n_tris,seed", [(200, 0), (1_000, 9)])
def test_random_triangle_cloud_matches_jax(n_tris, seed):
    js = jproc.random_triangle_cloud(n_tris, seed=seed)
    ts = tproc.random_triangle_cloud(n_tris, seed=seed, device="cpu")
    assert js.tlas.blob == ts.tlas.blob
    _assert_resources_equal(js.resources, ts.resources)
    assert_same(js.mesh_infos, ts.mesh_infos, "mesh_infos")
    assert_same(js.materials, ts.materials, "materials")
