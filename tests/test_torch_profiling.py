"""radiance_tpu_torch.utils.profiling on the CPU: timed's scope and its
synchronize rule, FrameStats against the JAX package's on the same
frame times, and device_trace's Chrome trace."""

import json
import os

import pytest
import torch

from radiance_tpu.utils import profiling as jprof
from radiance_tpu_torch.utils import profiling as tprof


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


def test_frame_stats_match_jax():
    times = [0.010 + 0.001 * (i % 7) for i in range(130)]
    t, j = tprof.FrameStats(), jprof.FrameStats()
    for s in times:
        t.record(s)
        j.record(s)
    assert t.frames == j.frames == 130 and len(t.history) == 100
    assert t.history == j.history and t.mean_s == j.mean_s
    assert t.rays_per_sec(2_073_600) == j.rays_per_sec(2_073_600)
    assert t.report(2_073_600) == j.report(2_073_600)
    assert t.report() == j.report()
    assert tprof.FrameStats().rays_per_sec(10) == 0.0


def test_device_trace_writes_a_chrome_trace(tmp_path, capsys):
    with tprof.device_trace(str(tmp_path / "tr")) as d:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    path = os.path.join(d, "trace.json")
    with open(path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert path in capsys.readouterr().out
