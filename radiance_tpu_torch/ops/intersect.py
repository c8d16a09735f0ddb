"""Ray/triangle intersection on torch tensors.

Port of radiance_tpu/ops/intersect.py (reference:
radiance/shader/radiance.cl:194-251): the slab AABB test, the
edge-precomputed Moller-Trumbore test and the brute-force soup oracle,
shape-polymorphic over leading batch dimensions.
"""

from __future__ import annotations

import torch

from radiance_tpu_torch.core import math as rmath

FLT_MAX = 3.4028234663852886e38   # float32 max, exactly representable


def intersect_aabb(origin, inv_dir, box_min, box_max, t_clip=None):
    """Slab test (reference: radiance.cl:195-208).

    origin/inv_dir: [..., 3]; box_min/box_max: [..., 3].  Returns bool
    [...]: t_far >= max(t_near, 0), the JAX package's inclusive form (the
    reference's strict test culls flat axis-aligned boxes).  `t_clip`
    ([...], optional) also culls boxes entered at or beyond it.

    torch.minimum/maximum propagate NaN as jnp.minimum/maximum do: an
    axis-parallel ray on a slab plane gives 0 * inf = NaN there, and the
    box must then miss, as in the JAX package.
    """
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = t_far >= torch.maximum(t_near, torch.zeros_like(t_near))
    if t_clip is not None:
        hit = hit & (t_near < t_clip)
    return hit


def intersect_triangle(origin, direction, v0, e1, e2):
    """Moller-Trumbore with precomputed edges e1 = v1 - v0, e2 = v2 - v0.

    origin/direction/v0/e1/e2: broadcastable [..., 3].
    Returns (valid [...], t [...], b1 [...], b2 [...]) with the
    reference's accept conditions: det != 0, 0 <= b1 <= 1, b2 >= 0,
    b1 + b2 <= 1, t > 0.
    """
    pvec = rmath.cross(direction, e2)
    det = rmath.dot(e1, pvec)
    inv_det = 1.0 / det
    s = origin - v0
    b1 = inv_det * rmath.dot(s, pvec)
    qvec = rmath.cross(s, e1)
    b2 = inv_det * rmath.dot(direction, qvec)
    t = inv_det * rmath.dot(e2, qvec)
    valid = ((det != 0.0)
             & (b1 >= 0.0) & (b1 <= 1.0)
             & (b2 >= 0.0) & (b1 + b2 <= 1.0)
             & (t > 0.0))
    return valid, t, b1, b2


def intersect_triangle_soup(origin, direction, v0, e1, e2, tmin, tmax):
    """Brute-force closest hit against a triangle soup; the test oracle.

    origin/direction: [N, 3]; v0/e1/e2: [T, 3].
    Returns (t [N], tri_idx [N], b1 [N], b2 [N]) with t = FLT_MAX on miss.
    Accept window tmin < t < tmax.
    """
    valid, t, b1, b2 = intersect_triangle(
        origin[:, None, :], direction[:, None, :],
        v0[None], e1[None], e2[None])
    valid = valid & (t > tmin) & (t < tmax)
    t = torch.where(valid, t, torch.full_like(t, FLT_MAX))
    best = torch.argmin(t, dim=1)
    n = torch.arange(origin.shape[0], device=origin.device)
    t_best = t[n, best]
    hit = t_best < FLT_MAX
    return (t_best, torch.where(hit, best, torch.full_like(best, -1)),
            b1[n, best], b2[n, best])
