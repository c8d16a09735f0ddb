"""Shader binding table: record specs + dispatch tables.

Port of radiance_tpu/api/sbt.py.  Accepts the reference's sbt.json
schema (samples/sbt.json): an array of records {raygen, closestHit,
anyHit, miss} whose index is the dispatch key.  The reference's
generated switch (genSBT.py:18-41, shader.cl:574-605) becomes masked
wavefront dispatch over registered Python shaders:

  closest-hit key = instanceSBTOffset + sbtRecordOffset (shader.cl:588)
  miss key        = missIndex (shader.cl:600)

Shaders take (ctx: ShadeContext, payload: Payload) and return a new
Payload; each runs on the full wavefront and is blended in by its
dispatch mask, so every shader must be total.  A shader no lane selects
is skipped.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List

import torch


@dataclasses.dataclass
class SBTRecord:
    raygen: str = ""
    closest_hit: str = ""
    any_hit: str = ""
    miss: str = ""


@dataclasses.dataclass(eq=False)
class ShaderBindingTable:
    """Records + name->callable registry."""
    records: List[SBTRecord]
    shaders: Dict[str, Callable]

    @staticmethod
    def from_json(path_or_list, shaders: Dict[str, Callable]
                  ) -> "ShaderBindingTable":
        """Load the reference's sbt.json format (samples/sbt.json)."""
        if isinstance(path_or_list, str):
            with open(path_or_list) as f:
                data = json.load(f)
        else:
            data = path_or_list
        records = [SBTRecord(raygen=r.get("raygen", ""),
                             closest_hit=r.get("closestHit", ""),
                             any_hit=r.get("anyHit", ""),
                             miss=r.get("miss", ""))
                   for r in data]
        return ShaderBindingTable(records=records, shaders=shaders)

    def _dispatch(self, kind: str, key, ctx, payload, active):
        """Run every registered shader of `kind` on the lanes whose key
        selects its record, blending results by mask; the mask rides into
        the shader as ctx.active so its occlusion traces skip dead lanes."""
        out = payload
        for index, rec in enumerate(self.records):
            name = getattr(rec, kind)
            if not name:
                continue
            fn = self.shaders.get(name)
            if fn is None:
                raise KeyError(f"SBT record {index} references unregistered "
                               f"shader {name!r}")
            mask = active & (key == index)
            if not bool(mask.any()):
                continue
            new = fn(ctx.replace(active=mask), out)
            m1 = mask[:, None]
            out = out.replace(
                color=torch.where(m1, new.color, out.color),
                hit=torch.where(mask, new.hit, out.hit),
                next_factor=torch.where(m1, new.next_factor, out.next_factor),
                next_origin=torch.where(m1, new.next_origin, out.next_origin),
                next_dir=torch.where(m1, new.next_dir, out.next_dir))
        return out

    def call_hit(self, sbt_record_offset, ctx, payload, active):
        """callHit switch (shader.cl:585-594)."""
        key = ctx.sbt_offset + sbt_record_offset
        return self._dispatch("closest_hit", key, ctx, payload, active)

    def call_miss(self, miss_index: int, ctx, payload, active):
        """callMiss switch (shader.cl:597-605)."""
        key = torch.full_like(ctx.sbt_offset, miss_index)
        return self._dispatch("miss", key, ctx, payload, active)

    def make_any_hit_program(self, sbt_record_offset: int, res):
        """The callAnyHit dispatch for traversal (shader.cl:574-583).

        Any-hit shaders take (cand: ops.traversal.AnyHitCandidates, res)
        and return (accept, terminate), [N, W] bool.  The program keys
        each candidate on its instance's sbt_offset + sbt_record_offset;
        a candidate whose key selects no any-hit record is accepted and
        does not terminate (plain closest hit).

        Returns None when every registered any-hit shader is the
        canonical terminate-on-first (marked `terminate_on_first = True`,
        the reference's anyShadow): tracers then use their built-in
        any-hit mode, which is semantically identical.
        """
        entries = []
        nontrivial = False
        for index, rec in enumerate(self.records):
            if not rec.any_hit:
                continue
            fn = self.shaders.get(rec.any_hit)
            if fn is None:
                raise KeyError(f"SBT record {index} references unregistered "
                               f"any-hit shader {rec.any_hit!r}")
            entries.append((index, fn))
            if not getattr(fn, "terminate_on_first", False):
                nontrivial = True
        if not nontrivial:
            return None

        def program(cand):
            accept = torch.ones_like(cand.valid)
            term = torch.zeros_like(cand.valid)
            key = cand.sbt_offset + sbt_record_offset          # [N]
            for index, fn in entries:
                a, t = fn(cand, res)
                m = (key == index)[:, None]
                accept = torch.where(m, a, accept)
                term = torch.where(m, t, term)
            return accept, term

        return program
