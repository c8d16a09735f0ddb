"""The view_glb driver's floor on a window's frames: a window that closes
with fewer than the mix's min_frames frames exits without a result, and
one that reaches it is returned as the view driver gave it."""

import types

import pytest

from rtbench.drivers import view, view_glb


@pytest.mark.parametrize("done", [3, 9, 10, 28])
def test_a_window_below_min_frames_gives_no_result(monkeypatch, done):
    w = dict(done=done, unit="frames")
    monkeypatch.setattr(view, "window", lambda run, st, seconds: w)
    run = types.SimpleNamespace(cell="multi64_view",
                                traffic={"min_frames": 10})
    if done < 10:
        with pytest.raises(SystemExit) as e:
            view_glb.window(run, {}, 48)
        assert f"held {done} frames" in str(e.value.code)
        assert "min_frames (10)" in str(e.value.code)
    else:
        assert view_glb.window(run, {}, 48) is w
