"""radiance_tpu_torch's samples vs the JAX package's, on the CPU.

sample0 at 48x48 against samples/sample0.py; render_sample2 at size 32
with 64^2 textures, batch 1, depth 1, against samples/sample2.py (both
with their TLAS file and images in the test's directory); sample1's
--glb route (loader with the AS cache, then the RD API) on a two-mesh
GLB at 32x32, depth 2, against the JAX loader and RD route.  Bars: u8
RMSE < 2.0 at depth 1, < 3.0 at depth 2 (tests/test_golden.py).
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from radiance_tpu.api import pipeline as jpipeline
from radiance_tpu.api import platform as jplatform
from radiance_tpu.scene import loader as jloader

from radiance_tpu_torch.api import platform as tplatform
from radiance_tpu_torch.samples import sample0 as tsample0
from radiance_tpu_torch.samples import sample1 as tsample1
from radiance_tpu_torch.samples import sample2 as tsample2
from radiance_tpu_torch.utils.image import rmse

from test_loader import two_mesh_glb
from test_torch_api import JAX, W, H, read_image, set_total_samples, wire

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "samples"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernel versions run thousands of tiny ops a wave; with
    the parallel test runner's processes sharing the cores, torch's
    intra-op thread pool only adds contention.  One thread, restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_platform(monkeypatch):
    monkeypatch.setattr(tplatform.Platform, "_instance", None)


def test_sample0_matches_jax(tmp_path):
    import sample0 as jsample0

    jimg = jsample0.main(size=48, out=str(tmp_path / "j.png"))
    timg = tsample0.main(size=48, out=str(tmp_path / "t.png"), device="cpu")
    assert timg.shape == (48, 48, 4) and timg[..., :3].std() > 10
    err = rmse(timg[..., :3], np.asarray(jimg)[..., :3])
    assert err < 2.0, f"sample0 u8 RMSE {err:.3f}"


def test_render_sample2_matches_jax(tmp_path, monkeypatch, fresh_platform):
    import sample2 as jsample2

    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    monkeypatch.setattr(jsample2, "AS_PATH", str(tmp_path / "j" / "bvh.bin"))
    monkeypatch.setattr(tsample2, "AS_PATH", str(tmp_path / "t" / "bvh.bin"))
    kw = dict(size=32, batch=1, depth=1, frames=1, tex_dim=64)
    jimg = jsample2.render_sample2(out=str(tmp_path / "j" / "s2.png"), **kw)
    timg = tsample2.render_sample2(out=str(tmp_path / "t" / "s2.png"),
                                   device="cpu", **kw)
    # the TLAS file round trip and the texture dumps went to the test's
    # directory; the files of both packages are byte-equal
    with open(tmp_path / "j" / "bvh.bin", "rb") as a, \
            open(tmp_path / "t" / "bvh.bin", "rb") as b:
        assert a.read() == b.read()
    assert (tmp_path / "t" / "blue.png").exists()
    assert timg[..., :3].std() > 5
    err = rmse(timg[..., :3], np.asarray(jimg)[..., :3])
    assert err < 2.0, f"sample2 u8 RMSE {err:.3f}"
    # a second render takes the file route (FileToTopAccelStruct)
    timg2 = tsample2.render_sample2(out=str(tmp_path / "t" / "s2b.png"),
                                    load_cache=True, **kw)
    np.testing.assert_array_equal(timg2, timg)


def test_sample1_glb_route_matches_jax(tmp_path, fresh_platform):
    src = two_mesh_glb(tmp_path, with_texture=False)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jpath = shutil.copy(src, tmp_path / "j")
    tpath = shutil.copy(src, tmp_path / "t")
    args = ["--glb", tpath, "--cpu", "--width", str(W), "--height", str(H),
            "--batch", "2", "--depth", "2", "--frames", "2",
            "--out", str(tmp_path / "t" / "s1.png")]
    tsample1.main(args)                 # builds and writes scene.glb.cache
    assert os.path.exists(tpath + ".cache")
    timg = tsample1.main(args)          # loads the TLAS from the cache
    w = wire(JAX, jplatform.Platform.GetPlatform(),
             jloader.load_scene(jpath, use_cache=True, verbose=False))
    for _ in range(2):
        jpipeline.TraceRays(w["plt"], 0, 0, 0, W, H)
        set_total_samples(JAX, w)
    jimg = read_image(JAX, w)
    assert timg[..., :3].std() > 3
    err = rmse(timg[..., :3], jimg[..., :3])
    assert err < 3.0, f"sample1 --glb u8 RMSE {err:.3f}"
