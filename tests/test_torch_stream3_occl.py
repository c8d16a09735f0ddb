"""radiance_tpu_torch's stream3 occlusion path and prep scalars vs
radiance_tpu's.

The plain versions of kernel F (the octant scalars) and kernel E (the
occlusion pair intersection), the occlusion _run (against the JAX _run
with and without its refine), trace_rows_stream3(occl=True) and the
plain route of rows_from_aos_fast, against the JAX module
(ops/stream3.py) with its Pallas kernels in interpret mode, or against
the JAX traversal walk as an exact oracle.  Scenes and rays as
in test_torch_stream3.py (each package builds its own scene from the same
mesh; inputs are made from a seed with numpy).

Bars:
  * F: equal values, NaN for NaN, against both JAX forms (the Pallas
    kernel and the XLA broadcasts).  A minimum or maximum over +0 and -0
    may return either zero, so zeros are compared as values, not bits;
  * E on the same unrefined word lists: the out lanes equal per ray on
    >= 0.999 of rays.  The leaf products sum their 16 terms in another
    order than the interpret-mode dot, so a hit at t ~ tmin or t ~ tmax,
    or on a triangle edge, may round either way;
  * whole occlusion waves: occluded-or-not agreement >= 0.999, t only 0
    or FLT_MAX.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiance_tpu.ops import stream3 as js3
from radiance_tpu.ops import traversal
from radiance_tpu.ops.intersect import FLT_MAX

from radiance_tpu_torch.ops import stream3 as ts3
from radiance_tpu_torch.ops import stream3_stages as stg

from test_torch_stream3 import (  # noqa: F401
    TMAX, TMIN, _one_torch_thread, camera_wave, jrows, mini_city_pair,
    soup_pair, trows)
from test_traversal import gen_rays


def occluded_agree(ref_t, got_t, bar=0.999):
    """Occluded-or-not agreement of two t arrays; returns got's mask."""
    hr = np.asarray(ref_t) < FLT_MAX
    hg = np.asarray(got_t) < FLT_MAX
    assert (hr == hg).mean() >= bar, (hr == hg).mean()
    return hg


# ------------------------------------------------------------ F (prep)

def oscal_rows(seed=5):
    """8 packets of mixed-octant rays with exact +0 and -0 direction
    components (and +-0 origin components), as six [8 * PKT] f32 rows."""
    n = 8 * js3.PKT
    o, d = gen_rays(np.random.default_rng(seed), n, spread=6.0)
    d[: n // 8, 0] = 0.0
    d[n // 8: n // 4, 1] = -0.0
    d[n // 4: 3 * n // 8, 2] = np.where(np.arange(n // 8) % 2, 0.0, -0.0)
    d[3 * n // 8: n // 2] /= np.linalg.norm(d[3 * n // 8: n // 2], axis=-1,
                                            keepdims=True)
    o[n // 2: 5 * n // 8, 0] = np.where(np.arange(n // 8) % 2, 0.0, -0.0)
    d[7 * n // 8:, 1] = 0.0                 # a packet with a zero axis
    return tuple(np.ascontiguousarray(v, np.float32) for v in
                 (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]))


@pytest.mark.parametrize("masked", [False, True])
def test_oscal_plain_matches_jax_kernel_and_xla(monkeypatch, masked):
    rows = oscal_rows()
    n = rows[0].shape[0]
    npk = n // js3.PKT
    live = (np.random.default_rng(9).uniform(size=n) < 0.6) if masked \
        else None
    got = stg._oscal_plain(tuple(torch.from_numpy(r) for r in rows),
                           None if live is None else torch.from_numpy(live),
                           npk)
    jr = tuple(jnp.asarray(r) for r in rows)
    jl = None if live is None else jnp.asarray(live)
    monkeypatch.delenv("RADIANCE_PREP_KERNEL", raising=False)
    refs = {"pallas": js3._octant_scalars_kernel(jr, jl, npk,
                                                 interpret=True),
            "xla": js3._octant_scalars(jr, jl, npk, interpret=True)}
    assert len(got) == 4
    for name, ref in refs.items():
        for a, b in zip(ref, got[:3]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=name)
    # the fourth output: the reference prep's 32-ray sub-frustum rows,
    # sub-major within each packet (stream3.py:509-515)
    spb = js3.BLK // js3.REFINE_SUB
    sub = js3._group_scalars(
        jr, js3.REFINE_SUB,
        mask=None if jl is None else jl.reshape(-1, js3.REFINE_SUB))
    bscal = sub.reshape(npk, 8, spb, 16).transpose(0, 2, 1, 3) \
        .reshape(npk * 8 * spb, 16)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(bscal))
    # the case is not vacuous: mixed packets, a zero axis, +-0 inputs
    assert (got[1].sum(dim=1) > 1).all() and (got[0][..., 0:3] == 0).any()
    # the sub-frusta tile their packet: their 1/|d| extrema fold into the
    # packet's, and some are tighter
    ihi = got[3][:, 12:15].reshape(npk, 32, 3)
    assert torch.equal(ihi.amax(dim=1), got[2][:, 12:15])
    assert (ihi < got[2][:, None, 12:15]).any()


def test_stage_prep_takes_sub_rows_from_kernel_f(monkeypatch):
    """On the kernel route _stage_prep takes the 32-ray sub-frustum rows
    from octant_scalars' fourth output and reduces nothing at 32 rays
    itself: with group_scalars refused, it gives the plain route's six
    outputs."""
    _, tds = soup_pair(300, 10)
    o, d = gen_rays(np.random.default_rng(4), 2 * js3.PKT, spread=8.0)
    live = torch.from_numpy(np.random.default_rng(5).uniform(size=len(o))
                            < 0.5)
    args = (trows(o, d), tds.knode_f, tds.inst_inv[0])
    ref = ts3._stage_prep(*args, live=live, stable=tds.stable_frames)
    plain, reduce = stg._oscal_plain, stg.group_scalars
    calls, inside = [], []

    def kernel_f(r, lv, npk):       # stands in for the card's kernel
        calls.append(npk)
        inside.append(True)
        try:
            return plain(r, lv, npk)
        finally:
            inside.pop()

    def group_scalars(*a, **k):
        if not inside:
            raise AssertionError("_stage_prep reduced rows outside F")
        return reduce(*a, **k)

    monkeypatch.setattr(stg, "_route", lambda t: "cuda")
    monkeypatch.setattr(stg, "oscal_cuda", kernel_f)
    monkeypatch.setattr(stg, "group_scalars", group_scalars)
    got = ts3._stage_prep(*args, live=live, stable=tds.stable_frames)
    assert calls == [js3.G]         # two packets padded to a group of G
    for a, b in zip(ref, got):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
        else:
            assert torch.equal(a, b)


def test_stages_route_cpu_tensors_to_plain_versions():
    """octant_scalars and stage_isect(occl=True) take the plain versions
    on CPU tensors; kernels E and F refuse them."""
    rows = tuple(torch.from_numpy(r) for r in oscal_rows(seed=3))
    a = stg.octant_scalars(rows, None, 8)
    b = stg._oscal_plain(rows, None, 8)
    assert len(a) == 4
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        stg.oscal_cuda(rows, None, 8)
    _, tds = soup_pair(200, 2)
    o, d = gen_rays(np.random.default_rng(1), js3.PKT, spread=5.0)
    rows, feats_t, scal, smeta, bscal, _ = ts3._stage_prep(
        trows(o, d), tds.knode_f, tds.inst_inv[0], stable=tds.stable_frames)
    words, emeta = stg.stage_emit(scal, smeta, bscal, tds.knode_f, TMAX)
    args = (words, emeta, smeta[:, 0].contiguous(),
            stg.feats_rows_to_major(feats_t), tds.kleaf, TMIN, TMAX)
    out = stg.stage_isect(*args, stable=tds.stable_frames, occl=True)
    assert torch.equal(out, stg._isect_occl_plain(*args, stg.PCAP,
                                                  tds.stable_frames))
    assert (out[..., 0] == 0).any()
    with pytest.raises(ValueError):
        stg.isect_occl_cuda(*args, stg.PCAP, tds.stable_frames)


# ----------------------------------------------------------- E (isect)

@pytest.fixture(scope="module")
def occl_words():
    """An 8192-ray mixed wave through the JAX prep and emit: its
    UNREFINED word lists, and the JAX occlusion kernel's output on them
    (interpret mode)."""
    jds, tds = soup_pair(600, 21)
    o, d = gen_rays(np.random.default_rng(7), js3.G * js3.PKT, spread=8.0)
    _, feats_t, scal, smeta, bscal, lim, _ = js3._stage_prep(
        jrows(o, d), TMIN, TMAX, jds.knode_f, jds.inst_inv[0],
        stable=jds.stable_frames)
    words, emeta = js3._stage_emit(lim, scal, smeta, bscal, jds.knode_f,
                                   interpret=True, treelet=False)
    out = js3._stage_isect(words, emeta, smeta[:, 0], feats_t.T, lim,
                           jds.kleaf, precision="f32", interpret=True,
                           orient="major", occl=True,
                           stable=jds.stable_frames)
    t = {k: torch.from_numpy(np.array(v)) for k, v in dict(
        feats_t=feats_t, smeta=smeta, words=words, emeta=emeta).items()}
    return tds, t, np.asarray(out)


def test_stage_isect_occl_matches_jax(occl_words):
    tds, t, ref = occl_words
    st = {}
    args = (t["words"], t["emeta"], t["smeta"][:, 0].contiguous(),
            stg.feats_rows_to_major(t["feats_t"]), tds.kleaf, TMIN, TMAX,
            stg.PCAP, tds.stable_frames)
    got = stg._isect_occl_plain(*args, stats=st).numpy()
    same = (got == ref).all(axis=2).ravel()
    assert same.mean() >= 0.999, same.mean()
    occ = got[..., 0].ravel() < FLT_MAX
    assert 0.02 < occ.mean() < 0.98 and st["pairs"] > 1000
    # the layout the glue folds: (0, 0, 0, 0) / (FLT_MAX, -1, 0, 0)
    assert (got[..., 1].ravel() == np.where(occ, 0.0, -1.0)).all()
    assert (got[..., 2:] == 0).all()


def test_isect_occl_plain_counts_needed_ray_tests(occl_words):
    """stats["ray_tests"] counts the rays of the tested pairs not yet
    occluded, live ones only when `live` is given; the count changes no
    result."""
    tds, t, _ = occl_words
    args = (t["words"], t["emeta"], t["smeta"][:, 0].contiguous(),
            stg.feats_rows_to_major(t["feats_t"]), tds.kleaf, TMIN, TMAX,
            stg.PCAP, tds.stable_frames)
    npad = t["feats_t"].shape[1]
    live = torch.from_numpy(np.random.default_rng(4).random(npad) < 0.5)
    st = {k: {} for k in ("none", "all", "half", "dead")}
    outs = {k: stg._isect_occl_plain(*args, stats=st[k], live=lv)
            for k, lv in (("none", None),
                          ("all", torch.ones(npad, dtype=torch.bool)),
                          ("half", live),
                          ("dead", torch.zeros(npad, dtype=torch.bool)))}
    assert all(torch.equal(o, outs["none"]) for o in outs.values())
    n = {k: v["ray_tests"] for k, v in st.items()}
    assert n["all"] == n["none"] <= st["none"]["pairs"] * stg.BLK
    assert 0 < n["half"] < n["all"] and n["dead"] == 0
    assert 0.3 < n["half"] / n["all"] < 0.7


def test_isect_occl_plain_counts_triangle_lane_tests(occl_words):
    """stats["tri_tests"] weights each needed ray by its leaf's triangle
    lanes: between the fewest and the most lanes of a leaf times
    ray_tests, below all T lanes where leaves are padded, 0 when no ray
    is live."""
    tds, t, _ = occl_words
    args = (t["words"], t["emeta"], t["smeta"][:, 0].contiguous(),
            stg.feats_rows_to_major(t["feats_t"]), tds.kleaf, TMIN, TMAX,
            stg.PCAP, tds.stable_frames)
    npad = t["feats_t"].shape[1]
    lanes = (tds.kleaf[:, 3:6, :3 * stg.T].reshape(-1, 3, 3, stg.T) != 0) \
        .any(dim=2).any(dim=1).sum(dim=1)
    assert int(lanes.min()) >= 1 and int(lanes.sum()) < lanes.numel() * stg.T
    st, dead = {}, {}
    stg._isect_occl_plain(*args, stats=st)
    stg._isect_occl_plain(*args, stats=dead,
                          live=torch.zeros(npad, dtype=torch.bool))
    assert st["ray_tests"] > 0 and dead["tri_tests"] == 0
    assert (int(lanes.min()) * st["ray_tests"] <= st["tri_tests"]
            <= int(lanes.max()) * st["ray_tests"])
    assert st["tri_tests"] < stg.T * st["ray_tests"]


# ------------------------------------------------------ whole waves

@pytest.mark.parametrize("window", ["full", "short"])
def test_trace_rows_stream3_occl_matches_jax(window):
    """The mini city, a 2-packet wave with 30% dead lanes holding NaN
    origins, against the JAX occlusion wave (interpret mode); the short
    window ends before every surface, so nothing may occlude there (held
    against the JAX traversal walk: the interpret-mode wave costs ~20 s
    a window)."""
    jds, tds = mini_city_pair()
    tmax = 1e4 if window == "full" else 30.0
    o, d = camera_wave(2 * js3.PKT, 64, 60.0)
    live = np.random.default_rng(3).uniform(size=len(o)) > 0.3
    o_bad = o.copy()
    o_bad[~live] = np.nan
    got, diag = ts3.trace_rows_stream3(tds, trows(o_bad, d), TMIN, tmax,
                                       live=torch.from_numpy(live),
                                       occl=True, with_diag=True)
    t = got.t.numpy()
    assert np.isin(t, [0.0, np.float32(FLT_MAX)]).all()
    if window == "full":
        ref = js3.trace_rows_stream3(jds, jrows(o_bad, d), TMIN, tmax,
                                     precision="f32",
                                     live=jnp.asarray(live), occl=True)
        ref_t = np.asarray(ref.t)
    else:
        ref = traversal.trace_rays(jds, jnp.asarray(o), jnp.asarray(d),
                                   TMIN, tmax, any_hit_terminate=True)
        ref_t = np.where(live, np.asarray(ref.t), FLT_MAX)
    occ = occluded_agree(ref_t, t)
    assert not occ[~live].any() and diag["flagged"] == 0
    if window == "full":
        assert occ[live].sum() >= 10        # tiny triangles: few occluders
    else:
        assert not occ.any()


def test_forced_occlusion_residual_rewalks_every_packet(monkeypatch):
    """With the walk cut after its first step window (8 node rows) every
    packet is flagged and re-walked by the packet tracer's any-hit mode;
    occluded-or-not still holds against the JAX any-hit traversal walk."""
    monkeypatch.setattr(ts3, "STEP_CAP", 1)
    jds, tds = soup_pair(900, 3)
    o, d = camera_wave(2 * js3.PKT, 64, 12.0)
    ref = traversal.trace_rays(jds, jnp.asarray(o), jnp.asarray(d), TMIN,
                               TMAX, any_hit_terminate=True)
    got, diag = ts3.trace_rows_stream3(tds, trows(o, d), TMIN, TMAX,
                                       occl=True, with_diag=True)
    assert diag["flagged"] == diag["pkt_flag"].numel() == js3.G
    assert diag["residual_rays"] == 2 * js3.PKT
    occ = occluded_agree(ref.t, got.t.numpy())
    assert occ.mean() > 0.05
    assert np.isin(got.t.numpy(), [0.0, np.float32(FLT_MAX)]).all()


@pytest.fixture(scope="module")
def occl_run():
    """The mini city's 2-packet wave with 30% dead lanes, parked as
    trace_rows_stream3 parks them, through the port's _run(occl=True),
    which refines the word lists before kernel E."""
    jds, tds = mini_city_pair()
    o, d = camera_wave(2 * js3.PKT, 64, 60.0)
    live = np.random.default_rng(3).uniform(size=len(o)) > 0.3
    o[~live] = 1e30
    d[~live] = 1.0
    got = ts3._run(trows(o, d), TMIN, TMAX, tds.knode_f, tds.kleaf,
                   tds.inst_inv[0], live=torch.from_numpy(live),
                   stable=tds.stable_frames, occl=True)
    return jds, o, d, live, got


@pytest.mark.parametrize("jax_refine", [True, None])
def test_run_occl_matches_jax_refined_and_default(occl_run, jax_refine):
    """The port's occlusion _run against the JAX _run with its refine on
    (exact_refine=True) and in its default form (no refine on occlusion
    waves), interpret mode: both are exact, so occluded-or-not agrees on
    the live rays and dead lanes miss."""
    jds, o, d, live, got = occl_run
    tstart, _ = js3.leaf_tables(jds.knode_f, jds.kleaf.shape[0])
    ref = js3._run(jrows(o, d), TMIN, TMAX, jds.knode_f, jds.kleaf,
                   jds.kprim, jds.ktri_geo, jds.inst_inv[0], tstart,
                   precision="f32", interpret=True, live=jnp.asarray(live),
                   occl=True, exact_refine=jax_refine,
                   stable=jds.stable_frames)
    ref_t = np.where(live, np.asarray(ref.t), FLT_MAX)
    t = got.t.numpy()
    assert np.isin(t, [0.0, np.float32(FLT_MAX)]).all()
    occ = occluded_agree(ref_t, np.where(live, t, FLT_MAX))
    assert occ[live].sum() >= 10
    assert not (t[~live] < FLT_MAX).any()


@pytest.mark.parametrize("n", [1, 31, 1025, 5000])
def test_rows_from_aos_fast_plain_matches_jax_rows(n):
    """rows_from_aos_fast on CPU tensors (its plain route, two
    transposes) against JAX rows_from_aos, bit for bit, at odd n."""
    rng = np.random.default_rng(n)
    o = rng.standard_normal((n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    got = ts3.rows_from_aos_fast(torch.from_numpy(o), torch.from_numpy(d))
    ref = js3.rows_from_aos(jnp.asarray(o), jnp.asarray(d))
    assert len(got) == 6
    for g, r in zip(got, ref):
        assert g.is_contiguous() and g.shape == (n,)
        assert g.numpy().tobytes() == np.asarray(r).tobytes()


def test_kernel_a_wrappers_refuse_cpu_tensors():
    """Kernel A's two wrappers never run on CPU tensors (the stages route
    those to .t().contiguous()); the features kernel takes 16 rows only."""
    x = torch.zeros(5, 3)
    with pytest.raises(ValueError):
        stg.aos_rows_cuda(x, x)
    with pytest.raises(ValueError):
        stg.transpose_cuda(torch.zeros(16, 8))
    f = torch.arange(16 * 5, dtype=torch.float32).reshape(16, 5)
    assert torch.equal(stg.feats_rows_to_major(f), f.t())


def test_trace_rays_stream3_any_hit_zero_directions():
    _, tds = soup_pair(200, 2)
    z = torch.zeros(256, 3)
    rec = ts3.trace_rays_stream3(tds, z, z, TMIN, TMAX, any_hit=True)
    assert (rec.t.numpy() == np.float32(FLT_MAX)).all()
