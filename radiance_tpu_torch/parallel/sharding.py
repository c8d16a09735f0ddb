"""Multi-device rendering: pixel and sample parallelism over a device mesh.

Port of radiance_tpu/parallel/sharding.py (:37-258).  The reference puts
WavefrontPathTracer.frame_fn under shard_map: one controller drives every
device of a mesh, the scene and resources are replicated, each device
traces and shades its own pixels or samples, and only the psum and the
image assembly communicate.  The port keeps that single-controller model
in one process:

  * a Mesh is an array of torch.device with axis names; a device may
    repeat, so one card can hold several shards (and the CPU tests' eight
    shards of the CPU stand in for the reference's virtual 8-device CPU
    mesh);
  * replicate() copies the scene and the resources to each device of the
    mesh once (cached per scene and device, copied anew after an in-place
    update of the source, such as a refit);
  * a call slices its inputs per shard and runs the shards on one worker
    thread per distinct device: the worker makes its device current and
    runs that device's shards in mesh order on the caller's current
    stream of the device, so shards that share a device run one after
    another, never on side streams; a worker's exception is raised in
    the caller;
  * the caller's thread then does what the reference's psum and output
    sharding do: sample sums are added on the group's first device in
    shard order (so the result is deterministic), and outputs are
    concatenated in shard order on the mesh's first device.

Modes:
  * pixel sharding (shard_frame; render_sharded pads the pixel count to
    the mesh size and crops): accum and pixel_index cut into equal
    contiguous slices, the same results as one device;
  * sample parallelism (sample_parallel_frame): every device renders all
    pixels, device d the frame ids [ts + d*batch, ts + (d+1)*batch); the
    sums merge into the running average, (accum*ts + sum) / (ts +
    n_dev*batch), so one call advances totalSamples by n_dev*batch;
  * 2D (make_mesh2d, tile_sample_frame): pixels over the px axis, the
    sample ids over the sp axis, merged over sp;
  * staged (staged_shard_frame): the reference shards each wave of its
    staged scheduler as its own jitted program; eager PyTorch already
    dispatches a frame wave by wave, so here it is the pixel mode of a
    frame with explicit routes and SBT group offsets.

Every mode runs unbounded (frame_fn's tbound=False), as the reference's
do, whatever the tracer's tbound field says.  There is no
torch.distributed: the reference's model is a single controller, and
NCCL refuses two ranks on one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from radiance_tpu_torch.bvh.device import DeviceScene
from radiance_tpu_torch.core import device as rdevice
from radiance_tpu_torch.engine.pathtracer import (WavefrontPathTracer,
                                                  _finish_frame)


class Mesh:
    """devices: an ndarray of torch.device, one dimension per name of
    axis_names.  shape is the reference's ordered {axis: size}."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _mesh_devices(n, devices) -> List[torch.device]:
    """The first n of `devices`, or of the CUDA cards when devices is
    None (all of them when n is None or 0); raises when there are fewer."""
    if devices is None:
        rdevice.resolve("cuda:0")        # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        what = "CUDA cards"
    else:
        devices = [rdevice.resolve(d) for d in devices]
        what = "devices given"
    n = n or len(devices)
    if n > len(devices):
        raise ValueError(f"a mesh of {n} devices, but {len(devices)} "
                         f"{what}")
    return devices[:n]


def _device_array(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return arr.reshape(shape)


def make_mesh(n_devices: int = None, axis: str = "px",
              devices: Sequence = None) -> Mesh:
    """A 1D mesh of the first n_devices CUDA cards (all of them by
    default), or of the first n_devices of `devices` (names or
    torch.device; a device may repeat).  Raises when fewer exist: no CPU
    fallback, no smaller mesh."""
    devs = _mesh_devices(n_devices, devices)
    return Mesh(_device_array(devs, (len(devs),)), (axis,))


def make_mesh2d(n_px: int, n_sp: int, axes=("px", "sp"),
                devices: Sequence = None) -> Mesh:
    """[n_px, n_sp] mesh: pixel tiles over the first axis, sample slices
    over the second, from the first n_px * n_sp CUDA cards or of
    `devices`, row-major."""
    devs = _mesh_devices(n_px * n_sp, devices)
    if len(devs) != n_px * n_sp:
        raise ValueError(f"a {n_px}x{n_sp} mesh needs {n_px * n_sp} devices")
    return Mesh(_device_array(devs, (n_px, n_sp)), axes)


# ---------------------------------------------------------------------------
# Replication
# ---------------------------------------------------------------------------

_REPLICA_CAP = 8
# (id(scene), id(resources), device) -> (scene, resources, versions,
# (scene', resources')), oldest evicted past _REPLICA_CAP; the held
# sources keep their ids from being reused while an entry lives
_replicas: dict = {}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def _scene_fields(scene: DeviceScene) -> dict:
    return {f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)
            if f.name != "multi"}


def replicate(scene: DeviceScene, resources: Dict, device):
    """(scene, resources) on `device`: every tensor of the scene (the
    kblas tuples too) and of the resource dict (the camera's too) copied
    there, the scene's MultiTables left to be rebuilt there at its first
    many-instance trace (multi=None).  The inputs come back unchanged
    when they already live on the device.  Cached per (scene, resources,
    device); an in-place update of a source tensor (a refit) or a new
    inst_kblas makes a new copy."""
    device = rdevice.resolve(device)
    fields = _scene_fields(scene)
    src = list(_tensors(fields)) + list(_tensors(resources))
    if all(t.device == device for t in src):
        return scene, resources
    key = (id(scene), id(resources), device)
    versions = (tuple(t._version for t in src), scene.inst_kblas,
                scene.stable_frames)
    held = _replicas.get(key)
    if (held is not None and held[0] is scene and held[1] is resources
            and held[2] == versions):
        return held[3]
    out = (dataclasses.replace(scene, **_to(fields, device), multi=None),
           _to(resources, device))
    _replicas.pop(key, None)
    _replicas[key] = (scene, resources, versions, out)
    while len(_replicas) > _REPLICA_CAP:
        _replicas.pop(next(iter(_replicas)))
    return out


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _current(device, stream):
    """Make `device` and its `stream` current in this thread (CUDA)."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def _run(jobs):
    """jobs: [(device, fn)] in mesh order -> [fn()] in that order.  One
    worker thread per distinct device runs that device's jobs in order,
    with the device and the caller's current stream of it made current.
    Every worker is joined; then the first failed device's exception (in
    mesh order) is raised in the caller."""
    by_dev = {}
    for i, (dev, fn) in enumerate(jobs):
        by_dev.setdefault(dev, []).append((i, fn))
    streams = {dev: torch.cuda.current_stream(dev) for dev in by_dev
               if dev.type == "cuda"}
    done = {}

    def work(dev, items):
        try:
            with _current(dev, streams.get(dev)):
                done[dev] = [(i, fn()) for i, fn in items]
        except BaseException as e:      # re-raised in the caller below
            done[dev] = e

    workers = [threading.Thread(target=work, args=(dev, items),
                                name=f"radiance-shard-{dev}")
               for dev, items in by_dev.items()]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    out = [None] * len(jobs)
    for dev in by_dev:
        if isinstance(done[dev], BaseException):
            raise done[dev]
        for i, r in done[dev]:
            out[i] = r
    return out


def _along(mesh: Mesh, axis: str) -> List[torch.device]:
    """The devices along `axis`, each at index 0 of every other axis (the
    reference replicates a shard over the axes its specs do not name)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no {axis!r}")
    arr = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
    return list(arr.reshape(arr.shape[0], -1)[:, 0])


def _replicas_for(devices, scene, resources) -> dict:
    return {d: replicate(scene, resources, d) for d in dict.fromkeys(devices)}


def _slices(n: int, k: int) -> List[slice]:
    if n % k:
        raise ValueError(f"{n} pixels do not split into {k} equal shards")
    m = n // k
    return [slice(i * m, (i + 1) * m) for i in range(k)]


def _gather(parts, device) -> torch.Tensor:
    return torch.cat([p.to(device) for p in parts])


def _merge(tracer, debug, accum, sums, total_samples, weight, device):
    """The reference's psum and running-average merge on `device`: the
    sums added in shard order, then (accum*ts + sum) / (ts + weight),
    tonemapped and quantized."""
    total = sums[0].to(device)
    for s in sums[1:]:
        total = total + s.to(device)
    return _finish_frame(tracer, weight, debug, accum.to(device), total,
                         total_samples)


def _pixel_sharded(frame, devices) -> Callable:
    def fn(scene, resources, accum, total_samples, pixel_index):
        reps = _replicas_for(devices, scene, resources)
        ts = int(total_samples)
        jobs = [(d, functools.partial(frame, *reps[d], accum[sl].to(d), ts,
                                      pixel_index[sl].to(d)))
                for d, sl in zip(devices, _slices(pixel_index.shape[0],
                                                  len(devices)))]
        outs = _run(jobs)
        return (_gather([o[0] for o in outs], devices[0]),
                _gather([o[1] for o in outs], devices[0]))
    return fn


def shard_frame(tracer: WavefrontPathTracer, mesh: Mesh, *,
                batch: int, depth: int, debug: int = 0,
                axis: str = "px") -> Callable:
    """Pixel-sharded frame: accum/pixel_index split across the mesh,
    scene + resources replicated.  Returns
    fn(scene, resources, accum [N,3], total_samples, pixel_index [N])
      -> (accum', image_u8 [N,4]) with N divisible by the mesh size."""
    frame = tracer.frame_fn(batch=batch, depth=depth, debug=debug)
    return _pixel_sharded(frame, _along(mesh, axis))


def sample_parallel_frame(tracer: WavefrontPathTracer, mesh: Mesh, *,
                          batch: int, depth: int, debug: int = 0,
                          axis: str = "px") -> Callable:
    """Sample-parallel frame: every device renders all pixels with its own
    slice of the sample sequence; the sums merge into the running
    average on the mesh's first device.

    With D devices and per-device batch B, one call advances the running
    average by D*B samples; callers advance totalSamples by D*B."""
    devices = _along(mesh, axis)
    frame = tracer.frame_fn(batch=batch, depth=depth, debug=debug)

    def fn(scene, resources, accum, total_samples, pixel_index):
        reps = _replicas_for(devices, scene, resources)
        ts = int(total_samples)
        # device d consumes sample ids [ts + d*B, ts + (d+1)*B)
        sums = _run([(d, functools.partial(
            frame.sample_sum, *reps[d], pixel_index.to(d), ts + i * batch,
            ts)) for i, d in enumerate(devices)])
        return _merge(tracer, debug, accum, sums, ts, len(devices) * batch,
                      devices[0])
    return fn


def tile_sample_frame(tracer: WavefrontPathTracer, mesh: Mesh, *,
                      batch: int, depth: int, debug: int = 0,
                      px: str = "px", sp: str = "sp") -> Callable:
    """Pixels sharded over `px`, samples over `sp`: device (i, s)
    renders pixel tile i with sample ids [ts + s*batch, ts +
    (s+1)*batch); tile i's sums merge on device (i, 0), so one call
    advances every pixel by mesh.shape[sp] * batch samples.  The result
    matches a single-device frame of batch' = n_sp * batch up to float
    summation order."""
    for a in (px, sp):
        if a not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} have no {a!r}")
    grid = np.moveaxis(mesh.devices, [mesh.axis_names.index(px),
                                      mesh.axis_names.index(sp)], [0, 1])
    grid = grid.reshape(grid.shape[0], grid.shape[1], -1)[:, :, 0]
    n_sp = grid.shape[1]
    frame = tracer.frame_fn(batch=batch, depth=depth, debug=debug)

    def fn(scene, resources, accum, total_samples, pixel_index):
        reps = _replicas_for(list(grid.flat), scene, resources)
        ts = int(total_samples)
        tiles = _slices(pixel_index.shape[0], grid.shape[0])
        sums = _run([(d, functools.partial(
            frame.sample_sum, *reps[d], pixel_index[sl].to(d),
            ts + s * batch, ts))
            for sl, row in zip(tiles, grid) for s, d in enumerate(row)])
        outs = [_merge(tracer, debug, accum[sl], sums[i * n_sp:(i + 1) * n_sp],
                       ts, n_sp * batch, row[0])
                for i, (sl, row) in enumerate(zip(tiles, grid))]
        return (_gather([o[0] for o in outs], grid[0, 0]),
                _gather([o[1] for o in outs], grid[0, 0]))
    return fn


def staged_shard_frame(tracer: WavefrontPathTracer, mesh: Mesh, *,
                       batch: int, depth: int, debug: int = 0,
                       axis: str = "px", routes="auto",
                       hit_group_offset: int = 0,
                       miss_group_offset: int = 0) -> Callable:
    """Pixel-sharded frame on the staged scheduler's wave routes.

    The reference shards each wave of its staged scheduler as its own
    jitted program, since a monolithic frame under shard_map was slow
    there; here every frame already runs wave by wave, so this is
    shard_frame with per-frame routes and SBT group offsets.  routes:
    "auto", the tracer's route fields and the staged defaults (frame_fn's
    routes=None), or (primary, bounce, shadow[, shadow_bounce]) as
    frame_fn takes them (None entries: the wave's field or default).
    Returns fn(scene, resources, accum [N,3], total_samples,
    pixel_index [N]) -> (accum', image u8 [N,4]), N divisible by the mesh
    size."""
    frame = tracer.frame_fn(
        batch=batch, depth=depth, debug=debug,
        hit_group_offset=hit_group_offset,
        miss_group_offset=miss_group_offset,
        routes=None if isinstance(routes, str) and routes == "auto"
        else tuple(routes))
    return _pixel_sharded(frame, _along(mesh, axis))


def render_sharded(tracer: WavefrontPathTracer, mesh: Mesh,
                   scene: DeviceScene, resources: Dict, accum,
                   total_samples: int, width: int, height: int, *,
                   batch: int, depth: int, debug: int = 0):
    """Convenience wrapper: pads the pixel wavefront to the size of the
    mesh's first axis, renders pixel-sharded over it, crops, and reshapes
    the image; outputs on the mesh's first device."""
    n = width * height
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    pad = (-n) % n_dev
    dev = mesh.devices.flat[0]
    pixel_index = torch.arange(n + pad, dtype=torch.int64, device=dev)
    accum = accum.to(dev)
    if pad:
        accum = torch.cat([accum, torch.zeros(pad, 3, dtype=torch.float32,
                                              device=dev)])
    fn = shard_frame(tracer, mesh, batch=batch, depth=depth, debug=debug,
                     axis=axis)
    accum2, image = fn(scene, resources, accum, total_samples, pixel_index)
    return accum2[:n], image[:n].reshape(height, width, 4)
