"""radiance_tpu_torch's terminal viewer and asset inspector, and sample1's
--interactive loop, on the CPU.

tests/test_viewer.py's cases on the port's tools/viewer.py; the port's
tools/model_viewer.py printing exactly what the JAX tool prints for a
GLB and an OBJ; the terminal preview equal to the JAX one; sample1's
render() callback in the loop with a --controls-file edit between two
frames (totalSamples restarts, and the next frame equals a fresh sample1
render at the edited camera), and `sample1 --interactive --frames 3
--controls-file ...` end to end.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from radiance_tpu.tools import model_viewer as jmv
from radiance_tpu.tools import viewer as jviewer

from radiance_tpu_torch.api import platform as tplatform
from radiance_tpu_torch.samples import sample1
from radiance_tpu_torch.tools import model_viewer as tmv
from radiance_tpu_torch.tools import viewer

from test_loader import two_mesh_glb

SIDE = 16


@pytest.fixture
def cpu_platform():
    """The port's Platform on the CPU, reset before and after."""
    tplatform.Platform._instance = None
    tplatform.Platform.GetPlatform("cpu")
    yield
    tplatform.Platform._instance = None


def test_parse_line():
    assert viewer.ControlChannel.parse_line("camera.x 1.5") == {
        "camera.x": 1.5}
    assert viewer.ControlChannel.parse_line("light.dir 0.3 -1 -0.4") == {
        "light.dir": [0.3, -1.0, -0.4]}
    assert viewer.ControlChannel.parse_line("debug 7") == {"debug": 7.0}
    assert viewer.ControlChannel.parse_line("save") == {"_save": True}
    assert viewer.ControlChannel.parse_line("quit") == {"_quit": True}
    assert viewer.ControlChannel.parse_line("") == {}
    assert viewer.ControlChannel.parse_line("camera.x") == {}


def test_watch_file_fires_once_per_change(tmp_path):
    path = str(tmp_path / "controls.json")
    ch = viewer.ControlChannel(use_stdin=False, watch_file=path)
    assert ch.poll() == {}  # missing file: no updates

    with open(path, "w") as f:
        json.dump({"camera.x": 2.0, "debug": 3}, f)
    up = ch.poll()
    assert up == {"camera.x": 2.0, "debug": 3}
    assert ch.poll() == {}  # unchanged mtime: no re-fire

    os.utime(path, ns=(1, 1))  # touch with a different mtime
    assert ch.poll() == {"camera.x": 2.0, "debug": 3}


def test_render_loop_applies_controls_and_resets(tmp_path):
    """A camera edit must reach on_change before the next frame renders
    (the reset-on-change contract, sample1.cpp:482)."""
    path = str(tmp_path / "controls.json")
    with open(path, "w") as f:
        json.dump({"camera.x": 5.0}, f)

    state = {"camera_x": 0.0, "total_samples": 10, "frames": 0}

    def on_change(updates):
        if "camera.x" in updates:
            state["camera_x"] = updates["camera.x"]
        state["total_samples"] = 0

    def callback(_):
        state["frames"] += 1
        state["total_samples"] += 1
        return np.zeros((4, 4, 4), np.uint8)

    viewer.render_loop(
        callback, None, frames=2, preview=False,
        out_path=str(tmp_path / "out.png"),
        controls=viewer.ControlChannel(use_stdin=False, watch_file=path),
        on_change=on_change)

    assert state["frames"] == 2
    assert state["camera_x"] == 5.0
    # reset happened before frame 1, then 2 frames accumulated
    assert state["total_samples"] == 2
    # the last frame, and the Save analog's timestamped copy beside it
    assert any(p.startswith("output.") for p in os.listdir(tmp_path))
    assert os.path.exists(tmp_path / "out.png")


def test_terminal_preview_matches_jax():
    img = np.random.default_rng(0).integers(0, 256, (37, 53, 4),
                                            dtype=np.uint8)
    for cols in (64, 20):
        assert viewer._terminal_preview(img, cols) \
            == jviewer._terminal_preview(img, cols)


def _printed(fn, *a):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a)
    return buf.getvalue()


def test_model_viewer_matches_jax(tmp_path, monkeypatch):
    """print_glb and print_mesh (through main's dispatch) line for line
    the JAX tool's output."""
    glb = two_mesh_glb(tmp_path, with_texture=True)
    obj = tmp_path / "quad.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvt 0 0\nvt 1 0\n"
                   "vt 0 1\nvn 0 0 1\nf 1/1/1 2/2/1 4/3/1 3/1/1\n")
    for path in (glb, str(obj)):
        outs = []
        for mod in (tmv, jmv):
            monkeypatch.setattr("sys.argv", ["model_viewer", path])
            outs.append(_printed(mod.main))
        assert outs[0] == outs[1] and len(outs[0].splitlines()) >= 3
    assert "node tree" in _printed(tmv.print_glb, glb)


def test_sample1_controls_reset_accumulation(tmp_path, cpu_platform):
    """Sample1's render() callback in render_loop; a --controls-file edit
    written after frame 1 reaches apply_controls before frame 2:
    totalSamples restarts, and frame 2 equals a fresh sample1 render at
    the edited camera (the same seeds: frame ids from totalSamples)."""
    s1 = sample1.Sample1(SIDE, SIDE, batch=1, depth=1)
    ctl = str(tmp_path / "controls.json")
    frames = []

    def render(data):
        img = s1.render_frame(data)
        frames.append(img.copy())
        if len(frames) == 2:
            with open(ctl, "w") as f:
                json.dump({"camera.x": 0.4, "camera.wy": 0.1}, f)
        return img

    out = viewer.render_loop(
        render, None, frames=3, preview=False,
        out_path=str(tmp_path / "out.png"),
        controls=viewer.ControlChannel(use_stdin=False, watch_file=ctl),
        on_change=s1.apply_controls)
    assert len(frames) == 3 and np.array_equal(out, frames[2])
    assert s1.total_samples() == 1              # one frame since the edit
    assert s1.controls()["camera.x"] == pytest.approx(0.4)
    cam = sample1.sample1_camera(SIDE, SIDE)
    cam.x, cam.wy = 0.4, 0.1
    fresh = sample1.render_sample1(SIDE, SIDE, batch=1, depth=1, frames=1,
                                   camera=cam, out=str(tmp_path / "f.png"))
    assert np.array_equal(frames[2], fresh)
    assert not np.array_equal(frames[1], frames[2])


def test_sample1_interactive_main(tmp_path, monkeypatch, cpu_platform):
    """`sample1 --cpu --interactive --frames 3 --controls-file c.json`: the
    edit is applied, three frames render, the last is written to --out
    and a timestamped copy beside it."""
    ctl = tmp_path / "c.json"
    ctl.write_text(json.dumps({"camera.x": 0.25, "debug": 0}))
    out = tmp_path / "progressive.png"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        img = sample1.main(["--cpu", "--width", str(SIDE), "--height",
                            str(SIDE), "--batch", "1", "--depth", "1",
                            "--interactive", "--frames", "3",
                            "--controls-file", str(ctl), "--out", str(out)])
    log = buf.getvalue()
    assert "set camera.x = 0.25" in log and "frame 2:" in log
    assert img.shape == (SIDE, SIDE, 4) and img.dtype == np.uint8
    assert out.exists()
    assert any(p.startswith("output.") for p in os.listdir(tmp_path))
