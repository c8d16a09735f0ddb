"""bench.py's traversal waves as a closed loop (bench.py:1380-1440).

Each iteration traces three full-frame waves against the configuration's
scene, enqueued back to back (only the program's own host reads wait):
  1. a jittered tile-ordered primary (sample id base + i, base drawn from
     the seed) through stream3.build_tracer(scene), closest hit;
  2. the mirror bounce off a radial normal from the primary's hits,
     through the live-masked packet kernel, closest hit;
  3. a shadow ray toward the light from the same points, through the
     live-masked packet kernel, any hit.
Rays are made on the device each iteration (rays.py).  A sample of rays
drawn from the seed keeps its three answers from every iteration; once
the window has closed, `check_iters` iterations drawn from the seed (the
last among them) are traced again by the plain reference.
"""

import numpy as np
import torch

from rtbench import check as rcheck
from rtbench import rays as rrays
from rtbench import scenes
from rtbench.reference import trace as rtrace

FLT_MAX = 3.4028234663852886e38


def _draws(run, n):
    """(jitter base, the checked rays' positions) from the seed."""
    rng = np.random.default_rng(run.seed)
    base = int(rng.integers(0, 2 ** 32))
    k = min(run.traffic["check_rays"], n)
    return base, np.sort(rng.choice(n, size=k, replace=False)), rng


def setup(run):
    from radiance_tpu_torch.api import accel
    from radiance_tpu_torch.core import types
    from radiance_tpu_torch.ops import packet_trace, stream3

    cfg, tr, dev = run.cfg, run.traffic, run.dev
    verts, tris = scenes.geometry(run)
    with run.span("bvh.build"):
        blas = accel.BuildBottomAccelStruct(types.Mesh(verts, tris))
        tlas = accel.BuildTopAccelStruct([types.Instance(
            np.eye(4, dtype=np.float32), 0, 0, blas)])
        scene = tlas.device_scene(dev, leaf_cap=cfg["leaf_cap"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
    w, h = tr["width"], tr["height"]
    n = w * h
    base, pick, rng = _draws(run, n)
    st = dict(scene=scene, tracer=stream3.build_tracer(
        scene, tq_bits=cfg["tq_bits"]), pk=packet_trace,
        prim=rrays.Primaries(w, h, cfg["eye"], dev), n=n, base=base,
        pick=torch.from_numpy(pick).to(dev), rng=rng, verts=verts,
        tris=tris)
    st["o"] = st["prim"].eye.expand(n, 3).contiguous()
    st["light"] = torch.from_numpy(rrays.to_light(cfg["wave_light"])).to(
        dev).expand(n, 3).contiguous()
    with run.span("warmup"):
        for i in range(tr["warmup_iters"]):
            _iteration(run, st, -1 - i, keep=False)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    return st


def _iteration(run, st, i, keep=True):
    tmin, tmax = run.traffic["tmin"], run.traffic["tmax"]
    pk = st["pk"]
    with run.span("wave.raygen"):
        _, d = st["prim"].rays(st["base"] + i)
    with run.span("wave.primary"), run.event_span("primary"):
        r1 = st["tracer"](st["o"], d, tmin, tmax)
    with run.span("wave.bounce_rays"):
        o2, d2 = rrays.mirror_bounce(st["o"], d, r1.t, FLT_MAX)
        live = r1.t < FLT_MAX
    with run.event_span("secondary"):
        with run.span("wave.bounce"):
            r2 = pk.trace_rays_packet(st["scene"], o2, d2, tmin, tmax,
                                      live=live)
        with run.span("wave.shadow"):
            r3 = pk.trace_rays_packet(st["scene"], o2, st["light"], tmin,
                                      tmax, any_hit=True, live=live)
    if keep:
        s = st["pick"]
        st["kept"].append(torch.stack([
            r1.t[s], r1.prim[s].to(torch.float32), r2.t[s],
            r2.prim[s].to(torch.float32), r3.t[s]]))
    st["last"] = live


def window(run, st, seconds):
    import time
    st["kept"] = []
    dev = run.dev
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        _iteration(run, st, i)
        i += 1
    with run.span("window.sync"):
        if dev.type == "cuda":
            torch.cuda.synchronize()
    t1 = time.perf_counter()
    return dict(window_s=t1 - t0, done=i, unit="iterations",
                rays=3 * st["n"] * i, n=st["n"], n_tris=len(st["tris"]),
                live=int(st["last"].sum()))


def release(run, st):
    """Keep what the check needs, on the host; the program's state goes."""
    kept = torch.stack(st["kept"]).cpu() if st["kept"] else None
    return dict(kept=kept, base=st["base"], pick=st["pick"].cpu(),
                rng=st["rng"], verts=st["verts"], tris=st["tris"],
                done=run.window["done"])


def _reference(run, k, jitters, pick, dtype):
    """The reference's answers (t1, prim1, t2, prim2, occluded) for the
    rays at `pick` of each sample id in `jitters`."""
    cfg, tr, dev = run.cfg, run.traffic, run.dev
    tree = scenes.reference_tree(run, k["verts"], k["tris"], dtype)
    prim = rrays.Primaries(tr["width"], tr["height"], cfg["eye"], dev)
    light = torch.from_numpy(rrays.to_light(cfg["wave_light"])).to(dev)
    idx = pick.to(dev)
    # every checked iteration's rays in one trace a wave
    o, d = zip(*(prim.rays(j, idx) for j in jitters))
    o, d = torch.cat(o).contiguous(), torch.cat(d)
    t1, p1, _, _ = rtrace.trace(tree, o, d, tr["tmin"], tr["tmax"])
    o2, d2 = rrays.mirror_bounce(o, d, t1, FLT_MAX)
    live = t1 < FLT_MAX
    t2, p2, _, _ = rtrace.trace(tree, o2, d2, tr["tmin"], tr["tmax"],
                                live=live)
    _, p3, _, _ = rtrace.trace(tree, o2, light.expand_as(o2).contiguous(),
                               tr["tmin"], tr["tmax"], any_hit=True,
                               live=live)
    k = idx.shape[0]
    return [dict(o=o[s], t1=t1[s], p1=p1[s], o2=o2[s], t2=t2[s], p2=p2[s],
                 occ=p3[s] >= 0)
            for s in (slice(i * k, (i + 1) * k) for i in range(len(jitters)))]


def _checked_iters(done, m, rng):
    """The iterations the check traces again: the last one, and m - 1
    more drawn from the seed."""
    m = min(m, done)
    rest = rng.choice(done - 1, size=m - 1, replace=False) if m > 1 else []
    return sorted({int(x) for x in rest} | {done - 1})


def check(run, k, limits):
    if k["kept"] is None or k["done"] == 0:
        return False, [("iterations_checked", 0, ">= 1")]
    iters = _checked_iters(k["done"], run.traffic["check_iters"], k["rng"])
    ref = _reference(run, k, [k["base"] + i for i in iters], k["pick"],
                     torch.float32)
    got = [k["kept"][i].to(run.dev) for i in iters]
    return rcheck.judge_waves(got, ref, limits)


def control_setup(run):
    verts, tris = scenes.geometry(run)
    n = run.traffic["width"] * run.traffic["height"]
    base, pick, rng = _draws(run, n)
    return dict(verts=verts, tris=tris, base=base, pick=torch.from_numpy(
        pick), rng=rng, done=run.traffic["control_iters"])


def control(run, k, limits):
    """The reference one precision lower (bfloat16) in the program's
    place, judged against the float32 reference."""
    iters = _checked_iters(k["done"], run.traffic["check_iters"], k["rng"])
    jit = [k["base"] + i for i in iters]
    ref = _reference(run, k, jit, k["pick"], torch.float32)
    low = _reference(run, k, jit, k["pick"], torch.bfloat16)
    got = [torch.stack([r["t1"], r["p1"].to(torch.float32), r["t2"],
                        r["p2"].to(torch.float32),
                        torch.where(r["occ"], 1.0, FLT_MAX)]) for r in low]
    correct, numbers = rcheck.judge_waves(got, ref, limits)
    return correct, numbers, len(iters)
