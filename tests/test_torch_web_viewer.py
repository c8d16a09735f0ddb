"""radiance_tpu_torch's browser-served viewer (tools/web_viewer.py) and
sample1 --web on the CPU.

tests/test_web_viewer.py's cases on the port's module, with every client
call under its own timeout.  The port encodes frames with its own PNG
writer (no PIL), so a served frame is checked as bytes: equal to
utils/image.encode_png of the frame the loop returned.  Then sample1's
render() callback in render_loop_web: a camera edit POSTed to /control
restarts totalSamples, and the next frame equals a fresh sample1 render
at the edited camera.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from radiance_tpu_torch.api import platform as tplatform
from radiance_tpu_torch.samples import sample1
from radiance_tpu_torch.tools import web_viewer
from radiance_tpu_torch.utils import image as image_io

TIMEOUT = 10        # seconds a client call may take


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.status, dict(r.headers), r.read()


def _post(url, payload=None):
    data = json.dumps(payload).encode() if payload is not None else b""
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.status, r.read()


def _frame(base):
    """The served frame once there is one: (frame id, png bytes)."""
    for _ in range(500):
        try:
            st, hdrs, png = _get(base + "/frame.png")
        except urllib.error.HTTPError:      # 503 before the first frame
            st, png = 503, b""
        if st == 200 and png:
            return int(hdrs["X-Frame-Id"]), png
        time.sleep(0.02)
    raise AssertionError("no frame served")


def _start(target, **kw):
    """Run a web loop on a daemon thread; (thread, base url)."""
    box, ready = {}, threading.Event()

    def on_start(addr):
        box["addr"] = addr
        ready.set()

    t = threading.Thread(target=target, kwargs=dict(kw, on_start=on_start),
                         daemon=True)
    t.start()
    assert ready.wait(TIMEOUT)
    host, port = box["addr"]
    return t, f"http://{host}:{port}"


def test_web_viewer_end_to_end(tmp_path):
    """Full loop: frames served as PNG, control edits reach on_change
    before the next frame (the reset-on-change contract,
    sample1.cpp:479-490), Save writes a timestamped PNG, /quit stops
    the loop."""
    seen = []
    state = {"v": 64}

    def on_change(updates):
        seen.append(dict(updates))
        if "camera.x" in updates:
            state["v"] = int(updates["camera.x"])

    def img_of(v):
        img = np.full((8, 8, 4), v, np.uint8)
        img[..., 3] = 255
        return img

    def frame(_):
        return img_of(state["v"])

    out = str(tmp_path / "web.png")
    t, base = _start(web_viewer.render_loop_web, callback=frame, frames=0,
                     out_path=out, on_change=on_change,
                     controls={"camera.x": 64.0})

    st, _, body = _get(base + "/")
    assert st == 200 and b"radiance_tpu inspector" in body
    _, png = _frame(base)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert png == image_io.encode_png(img_of(64))

    st, body = _post(base + "/control", {"camera.x": 200})
    assert st == 200
    for _ in range(500):                    # a frame rendered after the edit
        _, png = _frame(base)
        if png == image_io.encode_png(img_of(200)):
            break
        time.sleep(0.02)
    assert png == image_io.encode_png(img_of(200))
    assert any("camera.x" in u for u in seen)

    st, _, body = _get(base + "/state")
    s = json.loads(body)
    assert s["controls"]["camera.x"] == 200
    assert s["frame"] > 0

    n0 = len(os.listdir(tmp_path))
    _post(base + "/save")
    for _ in range(500):
        if len(os.listdir(tmp_path)) > n0:
            break
        time.sleep(0.02)
    assert len(os.listdir(tmp_path)) > n0

    _post(base + "/quit")
    t.join(TIMEOUT)
    assert not t.is_alive()
    assert os.path.exists(out)  # final frame persisted


def test_control_rejects_bad_json(tmp_path):
    viewer = web_viewer.WebViewer()
    host, port = viewer.serve()
    try:
        req = urllib.request.Request(
            f"http://{host}:{port}/control", data=b"not json",
            method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=TIMEOUT)
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://{host}:{port}/nothing",
                                   timeout=TIMEOUT)
        assert ei.value.code == 404
    finally:
        viewer.shutdown()


def test_publish_encodes_floats_like_jax():
    """A float frame is quantised as the JAX publish does (x * 255 + 0.5,
    clipped) before the PNG encode."""
    v = web_viewer.WebViewer()
    img = np.linspace(-0.2, 1.2, 4 * 5 * 3, dtype=np.float32).reshape(4, 5, 3)
    v.publish(img, 1.5, "x")
    want = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    assert v.png == image_io.encode_png(want)
    assert (v.frame, v.ms, v.extra) == (1, 1.5, "x")


def test_sample1_web_resets_on_edit(tmp_path):
    """sample1 --web's loop (run_viewer) on the CPU: a camera edit POSTed
    to /control restarts totalSamples, and the first frame after it
    equals a fresh sample1 render at the edited camera; /quit ends the
    loop and the last frame is written."""
    tplatform.Platform._instance = None
    tplatform.Platform.GetPlatform("cpu")
    try:
        side = 16
        s1 = sample1.Sample1(side, side, batch=1, depth=1)
        frames, edited = [], []
        plain_render, plain_apply = s1.render_frame, s1.apply_controls

        def render(data):
            img = plain_render(data)
            frames.append((s1.total_samples(), img.copy()))
            return img

        def apply(updates):
            edited.append(len(frames))
            plain_apply(updates)

        s1.render_frame, s1.apply_controls = render, apply
        out = str(tmp_path / "web.png")
        t, base = _start(sample1.run_viewer, s1=s1, web=True, frames=0,
                         out=out, web_port=0)
        _frame(base)
        st, _, body = _get(base + "/state")
        assert json.loads(body)["controls"]["camera.z"] == pytest.approx(4.0)
        _post(base + "/control", {"camera.x": 0.3})
        for _ in range(500):
            if edited and len(frames) > edited[0]:
                break
            time.sleep(0.02)
        _post(base + "/quit")
        t.join(30)
        assert not t.is_alive() and os.path.exists(out)
        k = edited[0]
        assert frames[k][0] == 1 and frames[k - 1][0] == k  # restarted
        cam = sample1.sample1_camera(side, side)
        cam.x = 0.3
        s1.render_frame, s1.apply_controls = plain_render, plain_apply
        fresh = sample1.render_sample1(side, side, batch=1, depth=1,
                                       frames=1, camera=cam,
                                       out=str(tmp_path / "fresh.png"))
        assert np.array_equal(frames[k][1], fresh)
    finally:
        tplatform.Platform._instance = None
