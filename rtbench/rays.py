"""The wave cells' rays, made on the device: frozen copies of bench.py's.

- tile_order: bench.camera_rays's 32x32-pixel tile order
  (bench.py:192-228; chip_smoke.py:329 camera_rays and :2538
  interior_rays are its copies on the card);
- primaries: the same rays with the engine's per-pixel PCG3D sub-pixel
  jitter of one sample id (bench._pcg3d_np, bench.py:175-190);
- mirror_bounce: bench.py's bounce off a radial normal
  (bench.py:1410-1417; chip_smoke.py:346 bounce_rays);
- to_light: bench.light_vec (bench.py:231-237; chip_smoke.py:2565
  interior_light).

PCG3D runs on int64 holding uint32 words, each 32x32-bit product split
at 16 bits (the port's core/math.py does the same), so it is exact on
any device.
"""

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def _mul32(a, b):
    b_lo = b & 0xFFFF
    b_hi = b >> 16
    return (a * b_lo + ((a * b_hi) & 0xFFFF) * 65536) & MASK32


def pcg3d_words(v):
    """PCG3D on int64 [..., 3] uint32 words (bench._pcg3d_np's hash)."""
    v = v.to(torch.int64) & MASK32
    v = (_mul32(v, 1664525) + 1013904223) & MASK32
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x = (x + _mul32(y, z)) & MASK32
    y = (y + _mul32(z, x)) & MASK32
    z = (z + _mul32(x, y)) & MASK32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + _mul32(y, z)) & MASK32
    y = (y + _mul32(z, x)) & MASK32
    z = (z + _mul32(x, y)) & MASK32
    return torch.stack([x, y, z], dim=-1)


def pcg3d(v):
    """PCG3D as float32 in [0, 1] (the words over 0xFFFFFFFF)."""
    return pcg3d_words(v).to(torch.float32) / torch.tensor(
        float(MASK32), dtype=torch.float32, device=v.device)


def tile_order(w: int, h: int, ts: int = 32):
    """The pixel index of each ray in tile order: 32x32-pixel tiles in
    row-major order, row-major inside a tile (int64 numpy [w*h])."""
    n = w * h
    px = np.arange(n, dtype=np.int64) % w
    py = np.arange(n, dtype=np.int64) // w
    tile = (py // ts) * (w // ts) + (px // ts)
    return np.argsort(tile * ts * ts + (py % ts) * ts + (px % ts))


class Primaries:
    """Jittered tile-ordered primaries of one camera on `dev`.

    eye: the pinhole; the rays look down -z through a 1.2 x 0.7 screen
    at distance 1 (bench.camera_rays).  rays(jitter, index) gives the
    rays at positions `index` of the tile order (all when None) for the
    sample id `jitter`: o, d float32 [k, 3]."""

    def __init__(self, w, h, eye, dev, ts=32):
        self.w, self.h, self.dev = w, h, dev
        order = tile_order(w, h, ts)
        self.order = torch.from_numpy(order).to(dev)
        self.px = (self.order % w).to(torch.float64)
        self.py = (self.order // w).to(torch.float64)
        self.eye = torch.tensor(eye, dtype=torch.float32, device=dev)

    def rays(self, jitter: int, index=None):
        order, px, py = self.order, self.px, self.py
        if index is not None:
            order, px, py = order[index], px[index], py[index]
        k = order.shape[0]
        seed = torch.stack([torch.full((k,), jitter & MASK32,
                                       dtype=torch.int64, device=self.dev),
                            torch.zeros(k, dtype=torch.int64,
                                        device=self.dev), order], -1)
        jit = (pcg3d(seed)[:, :2] - 0.5).to(torch.float64)
        xs = (px + jit[:, 0]) / self.w - 0.5
        ys = (py + jit[:, 1]) / self.h - 0.5
        d = torch.stack([xs * 1.2, ys * 0.7, torch.full_like(xs, -1.0)],
                        -1).to(torch.float32)
        d = d / torch.sqrt(torch.sum(d * d, -1, keepdim=True))
        return self.eye.expand(k, 3), d


def mirror_bounce(o, d, t1, flt_max):
    """The bounce off a radial normal (toward the camera) at each hit,
    offset 1e-3 along it; a miss keeps its origin.  Returns (o2, d2)."""
    hit = t1 < flt_max
    hit_p = o + t1[:, None] * d
    v = o - hit_p
    nrm = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                          min=1e-6)
    d2 = d - 2.0 * torch.sum(d * nrm, -1, keepdim=True) * nrm
    o2 = torch.where(hit[:, None], hit_p + nrm * 1e-3, o)
    return o2, d2


def to_light(v):
    """The unit to-light direction (float32 [3] numpy) from `v`."""
    v = np.asarray(v, np.float64)
    return (v / np.linalg.norm(v)).astype(np.float32)
