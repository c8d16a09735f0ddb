"""radiance_tpu_torch.utils.profiling on the CPU: timed's scope and its
synchronize rule, device_trace's Chrome trace, and the program's spans:
off without a profiler (no record_function, no CUDA event, no op added),
the span tree of a Sample1 frame on the stream3 primary route, per-thread
parents, stream3's counts against its diagnostics, the same hits and
kernel calls with spans on, the log's cap and restart, the anchor's
clock, and _run's default path without the diagnostic sums."""

import contextlib
import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from radiance_tpu_torch.api import accel, platform
from radiance_tpu_torch.core import types
from radiance_tpu_torch.ops import packet_trace
from radiance_tpu_torch.ops import stream3
from radiance_tpu_torch.samples import sample1
from radiance_tpu_torch.scene import procedural
from radiance_tpu_torch.utils import profiling as tprof

CPU_PROFILE = dict(activities=[ProfilerActivity.CPU])
TMIN, TMAX = 1e-3, 1e4
STAGES = ("stream3.prep", "stream3.emit", "stream3.refine",
          "stream3.isect", "stream3.glue", "stream3.residual")


def test_timed_records_and_prints(capsys):
    with tprof.timed("frame") as box:
        box["sync"] = torch.ones(4) * 2
    assert box["seconds"] >= 0.0
    assert capsys.readouterr().out.startswith("[frame] ")
    with tprof.timed("quiet", quiet=True) as box:
        pass
    assert "seconds" in box and capsys.readouterr().out == ""


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a card as its device."""
    @property
    def device(self):
        return torch.device("cuda", 1)


def test_timed_synchronizes_cuda_devices_only(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    with tprof.timed("cpu", sync={"a": [torch.zeros(2)]}, quiet=True):
        pass
    assert synced == []
    # every card the nested results live on, each once; box["sync"]
    # takes the place of the argument
    card = torch.zeros(2).as_subclass(_OnCard)
    with tprof.timed("card", sync=torch.zeros(1), quiet=True) as box:
        box["sync"] = {"acc": card, "img": (torch.ones(1), [card * 2])}
    assert synced == [torch.device("cuda", 1)]


def test_timed_records_on_error():
    with pytest.raises(KeyError):
        with tprof.timed("boom", quiet=True) as box:
            raise KeyError("x")
    assert box["seconds"] >= 0.0


def test_device_trace_writes_a_chrome_trace(tmp_path, capsys):
    with tprof.device_trace(str(tmp_path / "tr")) as d:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    path = os.path.join(d, "trace.json")
    with open(path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert path in capsys.readouterr().out


# ----------------------------------------------------------------- spans

@pytest.fixture
def cpu_platform():
    """The port's Platform on the CPU, reset before and after."""
    platform.Platform._instance = None
    platform.Platform.GetPlatform("cpu")
    yield
    platform.Platform._instance = None


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _soup_scene(n_tris=900, seed=3):
    """A single-instance triangle soup on the CPU (the stream3 and packet
    routes' kind of scene)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, size=(n_tris, 3)).astype(np.float32)
    offs = rng.normal(scale=0.5, size=(n_tris, 3, 3)).astype(np.float32)
    verts = (centers[:, None, :] + offs).reshape(-1, 3)
    tris = np.arange(n_tris * 3, dtype=np.uint32).reshape(-1, 3)
    blas = accel.BuildBottomAccelStruct(types.Mesh(verts, tris))
    inst = types.Instance(np.eye(4, dtype=np.float32), 0, 0, blas)
    return accel.BuildTopAccelStruct([inst]).device_scene("cpu")


def _wave(n=2048, w=64, z=12.0):
    """A pinhole camera's rays toward -z, as six world-space rows."""
    ij = np.arange(n)
    d = np.stack([((ij % w) / w - 0.5) * 1.2,
                  ((ij // w) / (n / w) - 0.5) * 0.7,
                  np.full(n, -1.0)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.float32([[0.0, 0.0, z]]), (n, 1))
    return stream3.rows_from_aos(torch.from_numpy(o), torch.from_numpy(d))


def _one_mesh_box():
    """The Cornell box's walls and boxes as one mesh, one instance: the
    engine's primary then takes the stream3 route, as rtbench's --cpu
    view runs do."""
    cb = procedural.cornell_box(device="cpu")
    r = cb.resources
    verts = r["vertex_data"].reshape(-1, 3).numpy()
    tris = r["index_data"].reshape(-1, 3).numpy().astype(np.uint32)
    normals = r["normal_data"].reshape(-1, 3).numpy()
    return procedural.assemble_scene(
        [(verts, tris, normals, np.zeros_like(verts), 0)],
        [types.Material(albedo=(0.7, 0.7, 0.7, 1.0), roughness=0.6)],
        types.SceneProperties(lights=[types.DirLight(
            direction=(0.3, -1.0, -0.4, 0.0), color=(3.0, 3.0, 3.0, 1.0))]),
        device="cpu")


class _Ops(TorchDispatchMode):
    """Counts every aten op dispatched (device ops and host reads alike:
    .item() and nonzero are ops too)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _profiled():
    """A CPU profile whose first span restarts the log: a span that finds
    the profiler off ends the log's session first."""
    with tprof.span("off"):
        pass
    with profile(**CPU_PROFILE) as p:
        yield p


def _no_span(name):
    return contextlib.nullcontext(tprof._OFF)


def test_spans_off_without_a_profiler(monkeypatch, cpu_platform,
                                      one_thread):
    """No profiler: span returns one shared object, logs nothing and makes
    no record_function and no CUDA event, through a whole Sample1 frame
    (RD API, engine, stream3, packet kernel)."""
    def refuse(*a, **k):
        raise AssertionError("made while spans are off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    before = tprof.spans()
    assert tprof.span("a") is tprof.span("b") is tprof._OFF
    with tprof.span("rdapi.frame") as sp:
        sp.note(rays=3)
    s1 = sample1.Sample1(16, 16, batch=1, depth=2, scene=_one_mesh_box())
    s1.render_frame()
    after = tprof.spans()
    assert after.records == before.records
    assert after.anchor == before.anchor


def test_spans_off_add_no_ops(monkeypatch, one_thread):
    """With spans off, a stream3 wave (its residual forced, so its host
    reads run) dispatches exactly the ops it does with no span at all."""
    monkeypatch.setattr(stream3, "STEP_CAP", 1)
    scene = _soup_scene()
    rows = _wave()
    counts = []
    for span in (tprof.span, _no_span):
        monkeypatch.setattr(tprof, "span", span)
        with _Ops() as ops:
            rec, diag = stream3.trace_rows_stream3(scene, rows, TMIN, TMAX,
                                                   with_diag=True)
        counts.append(ops.ops)
    assert diag["residual_rays"] > 0
    assert counts[0] == counts[1]


def _tree(log):
    recs = log.records
    for i, r in enumerate(recs):
        assert r.end_ns >= r.start_ns > 0
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
            assert r.root == p.root and r.thread == p.thread
        else:
            assert r.root == i
    return {(recs[r.parent].name if r.parent >= 0 else None, r.name)
            for r in recs}


def test_sample1_frame_span_tree(cpu_platform, one_thread):
    """A 16x16 batch-1 depth-2 frame through Sample1 under a CPU profile:
    the spans of every layer, children inside their parents, one root
    (the frame) for all, and every stream3 stage of the primary."""
    s1 = sample1.Sample1(16, 16, batch=1, depth=2, scene=_one_mesh_box())
    s1.render_frame()                           # warm
    with _profiled():
        s1.render_frame()
    log = tprof.spans()
    assert log.dropped == 0 and log.anchor is not None
    edges = _tree(log)
    assert {r.root for r in log.records} == {0}
    assert log.records[0].name == "rdapi.frame"
    want = {(None, "rdapi.frame"),
            ("rdapi.frame", "rdapi.trace_rays"),
            ("rdapi.trace_rays", "rdapi.parse"),
            ("rdapi.trace_rays", "engine.frame"),
            ("rdapi.frame", "rdapi.read_back"),
            ("engine.frame", "engine.raygen"),
            ("engine.frame", "engine.trace.primary"),
            ("engine.frame", "engine.trace.bounce"),
            ("engine.frame", "engine.shade"),
            ("engine.frame", "engine.finish"),
            ("engine.shade", "engine.trace.shadow"),
            ("engine.trace.primary", "stream3.trace"),
            ("engine.trace.shadow", "packet.trace"),
            ("engine.trace.bounce", "packet.trace")}
    want |= {("stream3.trace", s) for s in STAGES}
    assert want <= edges, want - edges
    trace = [r for r in log.records if r.name == "stream3.trace"]
    assert len(trace) == 1 and trace[0].counts["rays"] == 256


def test_threads_keep_separate_parent_stacks():
    """Spans opened in two threads at once nest within their own thread:
    each child's parent is its thread's span, and each thread's spans
    share its own root."""
    gate = threading.Barrier(2, timeout=10)

    def work(tag):
        with tprof.span(f"outer.{tag}"):
            gate.wait()
            with tprof.span(f"inner.{tag}"):
                gate.wait()

    with _profiled():
        threads = [threading.Thread(target=work, args=(t,))
                   for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    log = tprof.spans()
    _tree(log)
    by = {r.name: r for r in log.records}
    for tag in "ab":
        inner, outer = by[f"inner.{tag}"], by[f"outer.{tag}"]
        assert log.records[inner.parent] is outer
        assert inner.root == outer.root == log.records.index(outer)
        assert inner.thread == outer.thread
    assert by["outer.a"].thread != by["outer.b"].thread


@pytest.mark.parametrize("bounded", [False, True])
def test_stream3_notes_rays_and_residual(monkeypatch, one_thread, bounded):
    """stream3.trace notes rays = N and residual_rays = the flagged
    packets' rays plus the temporal residual's, as with_diag reports
    them (the residual forced by a one-window step cap; the bound 1.0
    sends every hit past it to the temporal residual)."""
    monkeypatch.setattr(stream3, "STEP_CAP", 1)
    scene = _soup_scene()
    rows = _wave()
    n = rows[0].shape[0]
    bound = (torch.full((-(-n // stream3.BLK),), 1.0) if bounded
             else None)
    with _profiled():
        _, diag = stream3.trace_rows_stream3(scene, rows, TMIN, TMAX,
                                             with_diag=True,
                                             blk_bound=bound)
    (rec,) = [r for r in tprof.spans().records if r.name == "stream3.trace"]
    want = diag["residual_rays"] + diag.get("tb_residual", 0)
    assert diag["residual_rays"] > 0
    assert (diag["tb_residual"] > 0) if bounded else "tb_residual" not in diag
    assert rec.counts == {"rays": n, "residual_rays": want}


def _counting(monkeypatch, mod, name, calls):
    fn = getattr(mod, name)

    def counted(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **k)

    monkeypatch.setattr(mod, name, counted)


def test_hits_and_kernel_calls_same_with_spans_on(monkeypatch, one_thread):
    """A stream3 wave with its residual and a masked packet wave: the
    same records bit for bit, the same kernel dispatches and launch
    counts, with a profiler active and without."""
    monkeypatch.setattr(stream3, "STEP_CAP", 1)
    scene = _soup_scene()
    rows = _wave()
    o = torch.stack(rows[:3], 1)
    d = torch.stack(rows[3:], 1)
    live = torch.arange(o.shape[0]) % 3 > 0
    calls = {}
    for mod, name in ((stream3, "stage_emit"), (stream3, "stage_refine"),
                      (stream3, "stage_isect"),
                      (packet_trace, "packet_trace")):
        _counting(monkeypatch, mod, name, calls)

    def run():
        calls.clear()
        packet_trace.packet_trace_cuda.launches.clear()
        a = stream3.trace_rows_stream3(scene, rows, TMIN, TMAX)
        b = packet_trace.trace_rays_packet(scene, o, d, TMIN, TMAX,
                                           any_hit=True, live=live)
        return a, b, dict(calls), dict(packet_trace.packet_trace_cuda.launches)

    off = run()
    with _profiled():
        on = run()
    assert any(r.name == "packet.trace" for r in tprof.spans().records)
    for rec_off, rec_on in zip(off[:2], on[:2]):
        for f in ("t", "prim", "slot", "b1", "b2"):
            assert torch.equal(getattr(rec_off, f), getattr(rec_on, f))
    assert off[2] == on[2] and off[2]["packet_trace"] >= 2
    assert off[3] == on[3]


def test_log_cap_drops_and_restart(monkeypatch):
    """Past LOG_CAP a span is counted as dropped; a span that finds the
    profiler off ends the session, and the next profiled span restarts
    the log with a fresh anchor."""
    monkeypatch.setattr(tprof, "LOG_CAP", 3)
    with _profiled():
        for i in range(5):
            with tprof.span(f"s{i}") as sp:
                sp.note(i=i)
        first = tprof.spans()
    assert [r.name for r in first.records] == ["s0", "s1", "s2"]
    assert first.dropped == 2
    assert [r.counts for r in first.records] == [{"i": 0}, {"i": 1},
                                                 {"i": 2}]
    with tprof.span("off"):
        pass
    with profile(**CPU_PROFILE):
        with tprof.span("again"):
            pass
    second = tprof.spans()
    assert [r.name for r in second.records] == ["again"]
    assert second.dropped == 0
    assert second.anchor.perf_ns > first.anchor.perf_ns


def test_span_counts_are_host_ints():
    with _profiled():
        with tprof.span("x") as sp:
            with pytest.raises(TypeError):
                sp.note(rays=torch.tensor(3))


def test_anchor_maps_profiler_records_into_spans():
    """The profiler's record of each span's record_function, mapped by
    the anchor, lies inside the span's perf_counter_ns interval, within
    20 us."""
    with _profiled() as p:
        with tprof.span("outer.clock"):
            (torch.ones(256, 256) @ torch.ones(256, 256)).sum()
            with tprof.span("inner.clock"):
                torch.ones(1000).cumsum(0)
    log = tprof.spans()
    got = {e.name(): e for e in p.profiler.kineto_results.events()
           if e.name() in ("outer.clock", "inner.clock")}
    assert set(got) == {"outer.clock", "inner.clock"}
    slack = 20_000
    for r in log.records:
        e = got[r.name]
        start = log.anchor.to_perf_ns(e.start_ns())
        end = log.anchor.to_perf_ns(e.start_ns() + e.duration_ns())
        assert r.start_ns - slack <= start < end <= r.end_ns + slack


def test_device_trace_shows_program_spans(tmp_path, capsys, one_thread):
    """device_trace's Chrome trace names the program's spans beside the
    ops they hold."""
    scene = _soup_scene(200)
    rows = _wave(1024, 32)
    with tprof.device_trace(str(tmp_path / "tr")) as d:
        stream3.trace_rows_stream3(scene, rows, TMIN, TMAX)
    with open(os.path.join(d, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"stream3.trace", *STAGES[:-1]} <= names


def test_run_default_path_skips_the_diagnostic_sums(one_thread):
    """_run computes words, kept_words, steps and capped only for
    with_diag; flags alone returns the residual's keys; the records are
    the same in every form, and trace_rows_stream3's default path
    dispatches fewer ops than with_diag."""
    scene = _soup_scene()
    rows = _wave()
    args = (rows, TMIN, TMAX, scene.knode_f, scene.kleaf, scene.inst_inv[0])
    kw = dict(stable=True)
    plain = stream3._run(*args, **kw)
    rec_f, flags = stream3._run(*args, flags=True, **kw)
    rec_d, diag = stream3._run(*args, with_diag=True, **kw)
    assert set(flags) == {"pkt_flag", "blk_perm"}
    assert set(diag) == {"pkt_flag", "blk_perm", "words", "kept_words",
                         "steps", "capped"}
    for f in ("t", "prim", "slot", "b1", "b2"):
        assert torch.equal(getattr(plain, f), getattr(rec_f, f))
        assert torch.equal(getattr(plain, f), getattr(rec_d, f))
    n_ops = []
    for with_diag in (False, True):
        with _Ops() as ops:
            stream3.trace_rows_stream3(scene, rows, TMIN, TMAX,
                                       with_diag=with_diag)
        n_ops.append(len(ops.ops))
    assert n_ops[1] - n_ops[0] >= 8
