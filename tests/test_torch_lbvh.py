"""radiance_tpu_torch's on-device LBVH (bvh/lbvh.py) vs radiance_tpu's.

lbvh_scene on the random triangle clouds of tests/test_lbvh.py at 5, 64
and 1000 triangles: the port's node_packed and bundle_packed equal the
JAX build's bit for bit (compared as int32: the rows hold integer bit
patterns), and the port's walk on its tables gives the JAX walk's hits
on the JAX tables (the bars of test_torch_traversal.py).  The Morton
helpers are held to the JAX ones on full-range inputs.  The JAX build
runs under jit, at these sizes in seconds (tests/test_lbvh.py's own
cases are in the slow tier).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radiance_tpu.bvh import lbvh as jlbvh
from radiance_tpu.ops import traversal as jtrav

from radiance_tpu_torch.bvh import lbvh as tlbvh
from radiance_tpu_torch.engine import pathtracer as tpath
from radiance_tpu_torch.ops import traversal as ttrav

from test_lbvh import random_tris
from test_torch_stream3 import _one_torch_thread  # noqa: F401
from test_torch_traversal import FIELDS, assert_same_hits, gen_rays

TMIN, TMAX = 1e-3, 1e3


def _as_i32(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.int32)


@pytest.mark.parametrize("n_tris", [5, 64, 1000])
def test_lbvh_tables_and_walk_match_jax(n_tris):
    verts, tris = random_tris(np.random.default_rng(n_tris), n_tris)
    js = jax.jit(jlbvh.lbvh_scene)(jnp.asarray(verts), jnp.asarray(tris))
    ts = tlbvh.lbvh_scene(torch.from_numpy(verts), torch.from_numpy(tris))
    for k in ("node_packed", "bundle_packed"):
        a, b = _as_i32(getattr(js, k)), _as_i32(getattr(ts, k).numpy())
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("inst_transform", "inst_inv", "inst_id", "inst_custom",
              "inst_sbt", "inst_blas_root"):
        np.testing.assert_array_equal(np.asarray(getattr(js, k)),
                                      getattr(ts, k).numpy(), err_msg=k)
    assert ts.knode_f is None and ts.kblas is None

    o, d = gen_rays(np.random.default_rng(n_tris + 1), 256, spread=8.0)
    for any_hit in (False, True):
        ref = jtrav.trace_rays(js, jnp.asarray(o), jnp.asarray(d), TMIN,
                               TMAX, any_hit_terminate=any_hit)
        # the engine's dispatch: no kernel tables, so the walk
        got = tpath._trace_dispatch(ts, torch.from_numpy(o),
                                    torch.from_numpy(d), TMIN, TMAX,
                                    any_hit_terminate=any_hit)
        assert_same_hits({k: np.asarray(getattr(ref, k)) for k in FIELDS},
                         {k: getattr(got, k).numpy() for k in FIELDS})
    if n_tris == 1000:
        assert (got.t < ttrav.FLT_MAX).sum() > 20


def test_morton_helpers_match_jax():
    rng = np.random.default_rng(0)
    p = rng.uniform(-0.1, 1.1, (4096, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jlbvh.morton3d(jnp.asarray(p))).astype(np.int64),
        tlbvh.morton3d(torch.from_numpy(p)).numpy())
    x = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    x[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    np.testing.assert_array_equal(
        np.asarray(jlbvh._bit_length(jnp.asarray(x.astype(np.uint32)))),
        tlbvh._bit_length(torch.from_numpy(x.astype(np.int64))).numpy())
