"""The tq word width in radiance_tpu_torch vs radiance_tpu.

The JAX module fixes its word format at import (RADIANCE_TQ_BITS, 5..9);
its tests retune it in-process with stream3._apply_tq_bits, always inside
a try/finally that restores 9, as tests/test_stream3.py's
test_stream3_tq7_word_format does.  The port takes tq_bits as an argument
(stream3_stages.WordFormat).

Bars: the emitted and refined word lists (unsorted and tq-sorted)
identical to the JAX stages' at 7 bits, and the wave's t and prim to the
JAX _run's at PERF.md section 2's bars (t rtol 1e-5 atol 1e-6, prim
>= 0.999); t and prim of the port's 7-bit wave bit-equal to its 9-bit
wave (tq only orders the culls); the temporal cull and the quantised
lower bound bit-equal at 5, 7 and 9 bits, the bound never above the entry
distance it encodes; supports / supports_native at the leaf reach in both
packages; every width the JAX module refuses, the port refuses.
"""

import types as pytypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiance_tpu.ops import stream3 as js3
from radiance_tpu.ops import stream3_multi as jsm

from radiance_tpu_torch.engine import pathtracer as tpt
from radiance_tpu_torch.ops import stream3 as ts3
from radiance_tpu_torch.ops import stream3_multi as tsm
from radiance_tpu_torch.ops import stream3_stages as stg

from test_torch_stream3 import (  # noqa: F401
    _one_torch_thread, hold, jrows, soup_pair, trows)
from test_traversal import gen_rays

TMIN, TMAX = 1e-3, 1e3


def at_bits(bits, fn):
    """fn() with the JAX module's word format at `bits`, restored to 9."""
    try:
        js3._apply_tq_bits(bits)
        return fn()
    finally:
        js3._apply_tq_bits(9)


@pytest.fixture(scope="module")
def tq7_case():
    """test_stream3_tq7_word_format's case (400 triangles, seed 21, 2048
    rays), its JAX stages and _run at 7 bits, unsorted and tq-sorted."""
    jds, tds = soup_pair(400, 21)
    o, d = gen_rays(np.random.default_rng(5), 2048, spread=8.0)
    tstart, _ = js3.leaf_tables(jds.knode_f, jds.kleaf.shape[0])
    _, aabb = js3.leaf_tables(jds.knode_f, jds.kleaf.shape[0])
    nl = aabb.shape[0]
    aabb8 = jnp.zeros((((nl + 7) // 8) * 8, 8), jnp.float32).at[
        :nl, :6].set(aabb)

    def jax_side():
        rows = jrows(o, d)
        pad = (-rows[0].shape[0]) % (js3.G * js3.PKT)
        rows_p = tuple(jnp.concatenate([r, jnp.broadcast_to(r[:1], (pad,))])
                       for r in rows)
        _, feats_t, scal, smeta, bscal, lim, _ = js3._stage_prep(
            rows_p, TMIN, TMAX, jds.knode_f, jds.inst_inv[0])
        words, emeta = js3._stage_emit(lim, scal, smeta, bscal, jds.knode_f,
                                       interpret=True, treelet=False)
        out = dict(feats_t=feats_t, scal=scal, smeta=smeta, bscal=bscal,
                   words=words, emeta=emeta, aabb8=aabb8)
        for sort in (False, True):
            out[f"words_i{int(sort)}"], out[f"emeta_i{int(sort)}"] = \
                js3._stage_refine_exact(words, emeta, smeta[:, 0], feats_t,
                                        aabb8, lim, interpret=True, sort=sort)
        args = (rows, TMIN, TMAX, jds.knode_f, jds.kleaf, jds.kprim,
                jds.ktri_geo, jds.inst_inv[0], tstart)
        rec = js3._run(*args, precision="f32", interpret=True)
        out["t"], out["prim"] = rec.t, rec.prim
        return {k: np.asarray(v) for k, v in out.items()}

    j = at_bits(7, jax_side)
    assert js3.W_TQ_BITS == 9 and js3.W_LEAF_MAX == 1 << 14
    t = {k: torch.from_numpy(v.copy()) for k, v in j.items()}
    return tds, o, d, j, t


def test_tq7_emit_matches_jax(tq7_case):
    tds, _, _, j, t = tq7_case
    words, emeta = stg.stage_emit(t["scal"], t["smeta"], t["bscal"],
                                  tds.knode_f, TMAX, tq_bits=7)
    words, emeta = words.numpy(), emeta.numpy()
    np.testing.assert_array_equal(emeta[:, :2], j["emeta"][:, :2])
    cnt = np.minimum(emeta[:, 0], stg.PCAP)
    for s in np.nonzero(cnt)[0]:
        np.testing.assert_array_equal(words[s, :cnt[s]],
                                      j["words"][s, :cnt[s]])
    # the 7-bit words are not the 9-bit ones: the fields moved
    w9, _ = stg.stage_emit(t["scal"], t["smeta"], t["bscal"], tds.knode_f,
                           TMAX)
    assert cnt.sum() > 50 and not torch.equal(w9, torch.from_numpy(words))
    fmt = stg.word_format(7)
    used = np.arange(words.shape[1])[None, :] < cnt[:, None]
    assert (words[used] >> fmt.leaf_shift).max() - 1 < tds.kleaf.shape[0]


@pytest.mark.parametrize("sort", [False, True])
def test_tq7_refine_matches_jax(tq7_case, sort):
    """Kernel C's plain version at 7 bits on the JAX emitted lists: the
    kept lists identical, unsorted and in stable tq-bucket order (the
    bucket shift rescaled to 2)."""
    _, _, _, j, t = tq7_case
    words, emeta = stg.stage_refine(t["words"], t["emeta"],
                                    t["smeta"][:, 0].contiguous(),
                                    t["feats_t"], t["aabb8"], TMAX,
                                    sort=sort, tq_bits=7)
    words, emeta = words.numpy(), emeta.numpy()
    k = int(sort)
    np.testing.assert_array_equal(emeta[:, 0], j[f"emeta_i{k}"][:, 0])
    for s in np.nonzero(emeta[:, 0])[0]:
        np.testing.assert_array_equal(words[s, :emeta[s, 0]],
                                      j[f"words_i{k}"][s, :emeta[s, 0]])
    if sort:
        b = stg.tq_bucket(torch.from_numpy(words), 7).numpy()
        for s in np.nonzero(emeta[:, 0])[0]:
            assert (np.diff(b[s, :emeta[s, 0]]) >= 0).all()
    assert emeta[:, 0].sum() > 20


@pytest.mark.parametrize("sort", [False, True])
def test_tq7_wave_matches_jax_and_9_bits(tq7_case, sort):
    """The port's _run at 7 bits (with and without the tq sort) against
    the JAX _run at 7 bits, and t and prim bit-equal to the port's 9-bit
    wave (tq orders nothing a closest hit keeps)."""
    tds, o, d, j, _ = tq7_case
    args = (trows(o, d), TMIN, TMAX, tds.knode_f, tds.kleaf,
            tds.inst_inv[0])
    rec7 = ts3._run(*args, stable=tds.stable_frames, tqsort=sort, tq_bits=7)
    rec9 = ts3._run(*args, stable=tds.stable_frames)
    hold(j["t"], j["prim"], rec7.t, rec7.prim)
    assert torch.equal(rec7.t, rec9.t) and torch.equal(rec7.prim, rec9.prim)


@pytest.mark.parametrize("bits", [5, 7, 9])
def test_block_bound_cull_at_width(bits):
    """_apply_block_bound on random words of the width, bounds from
    block_bound_from_t, bit-equal to the JAX cull under _apply_tq_bits;
    lb_bits equal to the JAX formula, and as a float never above the
    entry distance kernel B encodes."""
    rng = np.random.default_rng(bits)
    fmt = stg.word_format(bits)
    npk, pcap = 6, 80
    nslot = 4 * npk + 1
    leaf = rng.integers(0, 5000, size=(nslot, pcap))
    kmask = rng.integers(0, 256, size=(nslot, pcap))
    tq = rng.integers(0, fmt.tq_mask + 1, size=(nslot, pcap))
    tq[rng.uniform(size=tq.shape) < 0.2] = 0
    words = ((leaf + 1) << fmt.leaf_shift | kmask << fmt.keep_shift
             | tq).astype(np.int32)
    words[rng.uniform(size=words.shape) < 0.1] = 0
    slot_pkt = rng.integers(0, npk, size=nslot).astype(np.int32)
    t_prev = rng.uniform(0.2, 200.0, size=npk * 1024).astype(np.float32)
    bb = ts3.block_bound_from_t(torch.from_numpy(t_prev))
    assert bb.numpy().tobytes() == np.asarray(
        js3.block_bound_from_t(jnp.asarray(t_prev))).tobytes()
    ref = at_bits(bits, lambda: np.asarray(js3._apply_block_bound(
        jnp.asarray(words), jnp.asarray(slot_pkt), jnp.asarray(bb.numpy()))))
    got = ts3._apply_block_bound(torch.from_numpy(words),
                                 torch.from_numpy(slot_pkt), bb,
                                 tq_bits=bits).numpy()
    assert (ref != words).any() and (ref == words).any()
    np.testing.assert_array_equal(got, ref)
    lb = stg.lb_bits(torch.from_numpy(words), bits).numpy()
    tqw = words & fmt.tq_mask
    jlb = at_bits(bits, lambda: np.where(
        tqw == 0, 0, (tqw + js3.TQ_BIAS3) << js3.TQ_SHIFT))
    np.testing.assert_array_equal(lb, jlb)
    # the encode of kernel B's plain walk, then the decode: a lower bound
    tn = np.concatenate([rng.uniform(0.0, 2e4, 4000),
                         10.0 ** rng.uniform(-3, 4, 4000)]).astype(np.float32)
    tq_n = np.clip((tn.view(np.int32) >> fmt.tq_shift) - fmt.tq_bias3, 0,
                   fmt.tq_mask).astype(np.int32)
    dec = stg.lb_bits(torch.from_numpy(tq_n), bits).numpy().view(np.float32)
    assert (dec <= tn).all()


def test_supports_at_the_leaf_reach():
    """A table past 16,382 leaves: supports and supports_native refuse it
    at 9 bits and take it at 7, in both packages (the JAX module's under
    _apply_tq_bits)."""
    rows = 20_000
    tkleaf = torch.empty(rows, 1)
    jkleaf = np.empty((rows, 1))

    def scene(kleaf, inv):
        return pytypes.SimpleNamespace(knode_f=kleaf, kleaf=kleaf,
                                       inst_inv=inv)

    tsc = scene(tkleaf, torch.empty(1, 4, 4))
    jsc = scene(jkleaf, np.empty((1, 4, 4)))
    tmt = pytypes.SimpleNamespace(kleaf_cat=tkleaf)
    jmt = pytypes.SimpleNamespace(kleaf_cat=jkleaf)
    for bits, want in ((9, False), (8, True), (7, True)):
        j = at_bits(bits, lambda: (js3.supports(jsc),
                                   jsm.supports_native(jmt)))
        assert j == (want, want)
        assert ts3.supports(tsc, bits) == tsm.supports_native(tmt, bits) \
            == want
    assert ts3.supports(tsc) is False
    for bits in (5, 6, 7, 8, 9):
        assert ts3.leaf_reach(bits) == stg.word_format(bits).leaf_max \
            == at_bits(bits, lambda: js3.W_LEAF_MAX)


@pytest.mark.parametrize("bits", [-1, 0, 4, 5, 7, 9, 10, 16])
def test_port_refuses_what_jax_refuses(bits):
    """The same verdict as the JAX _apply_tq_bits (which raises before it
    changes anything) from the format, the stages' and entries' checks
    and the engine's field."""
    try:
        at_bits(bits, lambda: None)
        jax_ok = True
    except ValueError:
        jax_ok = False
    assert js3.W_TQ_BITS == 9
    checks = (lambda: stg.word_format(bits),
              lambda: stg.lb_bits(torch.zeros(3, dtype=torch.int32), bits),
              lambda: ts3.leaf_reach(bits),
              lambda: tpt.WavefrontPathTracer(ray_generator=None, sbt=None,
                                              tq_bits=bits))
    for check in checks:
        if jax_ok:
            check()
        else:
            with pytest.raises(ValueError, match="RADIANCE_TQ_BITS"):
                check()
    for bad in (7.0, "7", True):
        with pytest.raises(ValueError):
            stg.word_format(bad)
