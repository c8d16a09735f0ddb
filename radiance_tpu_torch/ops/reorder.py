"""Cheap ray reordering: a stable bucket (counting) sort.

Port of radiance_tpu/ops/reorder.py.  A scattered secondary wave (bounce
or shadow) loses packet coherence in two ways: dead lanes spread one to a
packet, so every packet still walks, and direction octants mix, which
breaks the near-child-first walk order.  A stable counting sort over a
handful of buckets fixes both,

    key = live ? direction_octant(d) : 8

and keeps pixel order inside each bucket, so the origins' coherence
survives; the dead rays collapse into trailing all-dead packets, which
the live-masked packet kernel retires in about one node step.

The JAX module avoids an argsort (one cumsum a bucket and one scatter),
which was slow on its accelerator.  Here the sort is one stable
torch.argsort of the keys: on an H100 the nine cumsums took 6-11x its
time (PERF.md).  A stable sort is deterministic, so every permutation
here equals the JAX module's value for value.  Permutations are int64
(torch's index type); the JAX module's are int32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# the inverse permutation is compaction's (the JAX package has the same
# function in both modules)
from radiance_tpu_torch.ops.compaction import invert_perm  # noqa: F401


def bucket_perm(keys: torch.Tensor) -> torch.Tensor:
    """Stable sort permutation of small integer keys: perm [N] i64 with
    keys[perm] ascending and equal keys in their original order (the
    reference's bucket_perm(keys, n_buckets); a stable argsort needs no
    bucket count)."""
    return torch.argsort(keys, stable=True)


def octant_key(direction, live: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Bucket key [N] i32: the direction octant 0-7 of live rays, 8 for
    dead ones.  direction is [N, 3] or a (dx, dy, dz) row tuple."""
    i32 = torch.int32
    if isinstance(direction, (tuple, list)):
        dx, dy, dz = direction
    else:
        dx, dy, dz = direction[:, 0], direction[:, 1], direction[:, 2]
    key = ((dx < 0).to(i32) + 2 * (dy < 0).to(i32) + 4 * (dz < 0).to(i32))
    if live is not None:
        key = torch.where(live, key, 8).to(i32)
    return key


def coherence_perm(direction, live: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm, inv): live rays grouped by direction octant, dead rays last,
    stable, so pixel-order origin coherence survives."""
    perm = bucket_perm(octant_key(direction, live))
    return perm, invert_perm(perm)


def apply_perm_rows(rows, perm):
    """Gather each component row of a rays-as-rows tuple."""
    return tuple(r[perm] for r in rows)
