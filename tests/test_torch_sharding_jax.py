"""radiance_tpu_torch.parallel.sharding against the JAX package's own
sharded functions.

Each mode of the JAX module (render_sharded on a 3-device mesh, so the
256 pixels pad to 258; sample_parallel_frame on 4 devices, batch 1;
tile_sample_frame on 2x2, batch 1; staged_shard_frame on 8 devices with
routes (None, None, None)) and its port counterpart on the same number of
CPU shards render the Cornell box at 16x16, batch 2 (the sample modes 4
samples in all), depth 2, from the same geometry, camera and seeds.  The
bar is the golden tests' (tests/test_golden.py :396): u8 RMSE < 3.0 at
depth 2, and the mean accumulation within 5%.

The JAX meshes are built directly from jax.devices() (the virtual
8-device CPU mesh of tests/conftest.py).  jax.experimental.mesh_utils,
which the JAX module's make_mesh reads, is never imported here: loading
it would change the outcome of tests/test_sharding.py in whichever
worker process ran this file first.  The JAX calls (6-9 s each here) are
made once, in a module fixture.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiance_tpu.parallel import sharding as jsharding
from radiance_tpu_torch.parallel import sharding as tsharding

from test_torch_engine import (  # noqa: F401
    _cornell, _one_torch_thread, tracers)

W = H = 16
N = W * H
MESH_UTILS = "jax.experimental.mesh_utils"
MODES = ("render_sharded", "sample_parallel", "tile_sample", "staged")


def _jmesh(shape, axes):
    k = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices()[:k]).reshape(shape),
                             axes)


def _cpu(k):
    return ["cpu"] * k


@pytest.fixture(scope="module")
def outputs(tracers):  # noqa: F811
    jt, tt = tracers
    (jds, jres), (tds, tres) = _cornell(W, H)
    jacc0 = jnp.zeros((N, 3), jnp.float32)
    jpix = jnp.arange(N, dtype=jnp.int32)
    tpix = torch.arange(N)
    out = {"mesh_utils_before": MESH_UTILS in sys.modules}
    out["render_sharded"] = (
        jsharding.render_sharded(jt, _jmesh((3,), ("px",)), jds, jres, jacc0,
                                 0, W, H, batch=2, depth=2),
        tsharding.render_sharded(tt, tsharding.make_mesh(3, devices=_cpu(3)),
                                 tds, tres, torch.zeros(N, 3), 0, W, H,
                                 batch=2, depth=2))
    out["sample_parallel"] = (
        jsharding.sample_parallel_frame(jt, _jmesh((4,), ("px",)), batch=1,
                                        depth=2)(
            jds, jres, jacc0, jnp.uint32(0), jpix),
        tsharding.sample_parallel_frame(
            tt, tsharding.make_mesh(4, devices=_cpu(4)), batch=1, depth=2)(
            tds, tres, torch.zeros(N, 3), 0, tpix))
    out["tile_sample"] = (
        jsharding.tile_sample_frame(jt, _jmesh((2, 2), ("px", "sp")),
                                    batch=1, depth=2)(
            jds, jres, jacc0, jnp.uint32(0), jpix),
        tsharding.tile_sample_frame(
            tt, tsharding.make_mesh2d(2, 2, devices=_cpu(4)), batch=1,
            depth=2)(tds, tres, torch.zeros(N, 3), 0, tpix))
    out["staged"] = (
        jsharding.staged_shard_frame(jt, _jmesh((8,), ("px",)), batch=2,
                                     depth=2, routes=(None, None, None))(
            jds, jres, jacc0, jnp.uint32(0), jpix),
        tsharding.staged_shard_frame(
            tt, tsharding.make_mesh(8, devices=_cpu(8)), batch=2, depth=2,
            routes=(None, None, None))(tds, tres, torch.zeros(N, 3), 0,
                                       tpix))
    out["mesh_utils_after"] = MESH_UTILS in sys.modules
    return out


def test_jax_calls_leave_mesh_utils_unloaded(outputs):
    assert outputs["mesh_utils_after"] == outputs["mesh_utils_before"]


@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_jax_sharded(outputs, mode):
    (jacc, jimg), (tacc, timg) = outputs[mode]
    assert tacc.shape == (N, 3) and timg.dtype == torch.uint8
    assert torch.isfinite(tacc).all()
    ref = np.asarray(jimg).reshape(N, 4)[:, :3].astype(np.float64)
    got = timg.reshape(N, 4)[:, :3].numpy().astype(np.float64)
    assert got.std() > 1.0
    rmse = float(np.sqrt(np.mean((got - ref) ** 2)))
    assert rmse < 3.0, rmse
    np.testing.assert_allclose(float(tacc.mean()), float(jnp.mean(jacc)),
                               rtol=0.05)
