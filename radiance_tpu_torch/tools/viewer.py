"""Progressive render viewer: the interactive-loop analog.

Equivalent of the reference's inspector (reference:
visualization/inspector.{h,cpp}): a render loop that calls a user
callback each frame and displays/persists the returned RGBA8 image.
This environment is headless, so "display" means writing a PNG each
refresh (plus an optional terminal half-block preview); the callback
contract matches renderLoop's (inspector.h:6-8).

Port of radiance_tpu/tools/viewer.py (numpy and the standard library
only): the same ControlChannel, terminal preview, callback contract,
save paths and reset-on-change hook.  Frames are written with the port's
PNG writer (utils/image.py), which needs no PIL.
"""

from __future__ import annotations

import json
import os
import select
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np


class ControlChannel:
    """Live parameter-edit input for the render loop.

    The reference's inspector shows ImGui sliders for camera / light /
    debug and the sample resets totalSamples when any changed
    (reference: sample1.cpp:479-548, RenderSceneConfigUI :501-548).
    This environment is headless, so edits arrive through two channels,
    both optional and merged per frame:

      - stdin lines (non-blocking): `camera.x 1.5`, `camera.wy 3.14`,
        `light.dir 0.3 -1 -0.4`, `light.color 3 3 3`, `debug 7`,
        `batch 8`, `depth 4`, plus `save` and `quit`
      - a watch file: a JSON dict with the same dotted keys, re-read
        whenever its mtime changes

    poll() returns {key: value} updates; values are float, or a list of
    floats for multi-argument keys.  `save`/`quit` appear under the
    "_save"/"_quit" keys.
    """

    def __init__(self, use_stdin: bool = True,
                 watch_file: Optional[str] = None):
        self.use_stdin = use_stdin
        self.watch_file = watch_file
        self._mtime = None

    @staticmethod
    def parse_line(line: str) -> Dict:
        parts = line.strip().split()
        if not parts:
            return {}
        key = parts[0]
        if key in ("save", "quit"):
            return {"_" + key: True}
        vals = [float(v) for v in parts[1:]]
        if not vals:
            return {}
        return {key: vals[0] if len(vals) == 1 else vals}

    def _poll_stdin(self) -> Dict:
        updates: Dict = {}
        if not self.use_stdin:
            return updates
        try:
            while select.select([sys.stdin], [], [], 0)[0]:
                line = sys.stdin.readline()
                if not line:  # EOF
                    self.use_stdin = False
                    break
                updates.update(self.parse_line(line))
        except (OSError, ValueError):
            self.use_stdin = False
        return updates

    def _poll_file(self) -> Dict:
        if not self.watch_file or not os.path.exists(self.watch_file):
            return {}
        mtime = os.stat(self.watch_file).st_mtime_ns
        if mtime == self._mtime:
            return {}
        self._mtime = mtime
        try:
            with open(self.watch_file) as f:
                data = json.load(f)
            return dict(data) if isinstance(data, dict) else {}
        except (json.JSONDecodeError, OSError):
            return {}

    def poll(self) -> Dict:
        updates = self._poll_file()
        updates.update(self._poll_stdin())
        return updates


def _terminal_preview(image: np.ndarray, max_cols: int = 64) -> str:
    """Render the image as ANSI half-block characters."""
    h, w = image.shape[:2]
    cols = min(max_cols, w)
    rows = max(2, int(cols * h / w / 1.0)) & ~1
    ys = (np.linspace(0, h - 1, rows)).astype(int)
    xs = (np.linspace(0, w - 1, cols)).astype(int)
    small = image[np.ix_(ys, xs)][..., :3]
    lines = []
    for r in range(0, rows - 1, 2):
        line = []
        for c in range(cols):
            top = small[r, c]
            bot = small[r + 1, c]
            line.append(f"\x1b[38;2;{top[0]};{top[1]};{top[2]}m"
                        f"\x1b[48;2;{bot[0]};{bot[1]};{bot[2]}m▀")
        lines.append("".join(line) + "\x1b[0m")
    return "\n".join(lines)


def render_loop(callback: Callable, data=None, *, frames: int = 0,
                out_path: str = "viewer_output.png",
                preview: bool = True,
                save_every: int = 1,
                controls: Optional[ControlChannel] = None,
                on_change: Optional[Callable] = None) -> Optional[np.ndarray]:
    """Run the progressive render loop (reference: renderLoop,
    inspector.cpp:71-283).

    callback(data) -> np.ndarray [H, W, 4] u8 (the reference's callback
    fills image/width/height out-params; returning the array is the
    Python shape of the same contract).
    frames: 0 = loop until Ctrl-C.
    controls/on_change: live parameter editing -- each frame, pending
    ControlChannel updates are handed to on_change(updates), which
    mutates the bound buffers and resets accumulation (the reference
    resets totalSamples when any ImGui control changed,
    sample1.cpp:479-490).
    """
    from radiance_tpu_torch.utils import image as image_io

    def stamp_path():
        # timestamped saves land NEXT TO out_path, not in the cwd
        d = os.path.dirname(os.path.abspath(out_path))
        return os.path.join(d, image_io.timestamped_path("output",
                                                         "png"))

    image = None
    frame = 0
    try:
        while frames == 0 or frame < frames:
            if controls is not None:
                updates = controls.poll()
                if updates.pop("_quit", None):
                    break
                if updates.pop("_save", None) and image is not None:
                    p = stamp_path()
                    image_io.write_image(p, image)
                    print(f"saved {p}")
                if updates and on_change is not None:
                    on_change(updates)
            t0 = time.time()
            image = np.asarray(callback(data))
            dt = time.time() - t0
            if frame % save_every == 0:
                image_io.write_image(out_path, image)
            if preview and sys.stdout.isatty():
                sys.stdout.write("\x1b[2J\x1b[H")
                sys.stdout.write(_terminal_preview(image) + "\n")
            print(f"frame {frame}: {dt:.3f}s -> {out_path}")
            frame += 1
    except KeyboardInterrupt:
        print("\nviewer stopped.")
    if image is not None:
        # "Save" button analog: timestamped copy (inspector.cpp:234-243)
        final = stamp_path()
        image_io.write_image(final, image)
        print(f"saved {final}")
    return image
