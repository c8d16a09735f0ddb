"""Acceleration-structure build API (RD::BuildAccelStruct equivalents).

Port of radiance_tpu/api/accel.py (reference: radiance/src/radiance.cpp:
20-84 BLAS/TLAS builds, :428-479 the file round trip).  The SAH build
runs in NumPy or the C++ native builder exactly as in the JAX package;
the device scene is made lazily on the device the caller names.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from radiance_tpu_torch.bvh import builder, serialize
from radiance_tpu_torch.bvh import device as bvh_device
from radiance_tpu_torch.core import device as rdevice
from radiance_tpu_torch.core import types


def BuildBottomAccelStruct(mesh: types.Mesh,
                           verbose: bool = False) -> types.BottomAccelStruct:
    """Build a BLAS from a mesh (reference: radiance.cpp:20-52)."""
    t0 = time.time()
    nodes, faces, max_depth = builder.build_blas_arrays(mesh.vertices,
                                                        mesh.triangles)
    blob = serialize.serialize_blas(nodes, faces, mesh.vertices)
    if verbose:
        print(f"BLAS build: {len(mesh.triangles)} tris, {len(nodes)} nodes, "
              f"depth {max_depth}, {time.time() - t0:.3f}s")
    return types.BottomAccelStruct(
        data=blob,
        nodes=nodes,
        faces=faces,
        vertices=np.ascontiguousarray(mesh.vertices, np.float32),
        root_bottom=np.asarray(nodes[0]["bottom"], np.float32),
        root_top=np.asarray(nodes[0]["top"], np.float32),
    )


@dataclasses.dataclass
class TopAccelStruct:
    """Built TLAS: serialized blob + host arrays + lazy device scenes.

    A TLAS loaded from a file (FileToTopAccelStruct) has no BLAS objects:
    its device scenes come from the blob's parsed BLAS arrays, padded to
    the capacity a build of the same instances would use, so loaded and
    built scenes are equal array for array.  `blob` is made lazily: a
    refit only drops it."""
    _blob: Optional[bytes]
    nodes: np.ndarray               # DEVICE_BVH_NODE_DTYPE
    instances: np.ndarray           # DEVICE_INSTANCE_DTYPE (leaf order)
    blas_offsets: list              # [(offset, BottomAccelStruct)]
    source_instances: Optional[list] = None  # RD Instance list (builds)
    tlas_capacity: int = 0
    # offset -> (nodes, faces, verts) parsed from a file's blob
    _parsed_blas: Optional[dict] = dataclasses.field(default=None,
                                                     repr=False)
    _scenes: dict = dataclasses.field(default_factory=dict, repr=False)
    # scene key -> {id(BLAS object): its root row in that scene}: a refit
    # finds each instance's BLAS rows by identity
    _blas_roots: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def blob(self) -> bytes:
        if self._blob is None:
            self._blob = serialize.serialize_tlas(
                self.nodes, self.instances, self.blas_offsets)
        return self._blob

    def device_scene(self, device=rdevice.DEFAULT, *,
                     stable_frames: bool = True,
                     leaf_cap: int = 128, collapse: str = "greedy",
                     rho: float = 0.15) -> bvh_device.DeviceScene:
        """The DeviceScene with its tensors on `device` (built once per
        device, frame mode, leaf cap -- triangles per kernel leaf, a
        multiple of 32 in [32, 512] -- and leaf collapse, "greedy" or
        "sah" with its rho: bvh_device.build_device_scene)."""
        device = rdevice.resolve(device)
        key = (str(device), stable_frames, leaf_cap, collapse, float(rho))
        if key not in self._scenes:
            blas_by_offset = self._parsed_blas or {
                off: (b.nodes, b.faces, b.vertices)
                for off, b in self.blas_offsets}
            self._scenes[key] = bvh_device.build_device_scene(
                self.nodes, self.instances, blas_by_offset,
                tlas_capacity=self.tlas_capacity,
                stable_frames=stable_frames, leaf_cap=leaf_cap,
                collapse=collapse, rho=rho, device=device)
            # where the build put each BLAS: its instances' root rows
            blas_at = dict(self.blas_offsets)
            self._blas_roots[key] = {
                id(blas_at[int(off)]): root for off, root in zip(
                    self.instances["bottomAccelStructOffset"],
                    self._scenes[key].inst_blas_root.tolist())
                if int(off) in blas_at}
        return self._scenes[key]

    def refit(self, new_transforms,
              device=rdevice.DEFAULT) -> bvh_device.DeviceScene:
        """Animated-transform refit (radiance_tpu/api/accel.py:76-117):
        rebuild the small TLAS over the existing BLASes and update the TLAS
        block and instance arrays of every device scene made so far in
        place (bvh/device.update_tlas).  The reference has no refit; it
        rebuilds and re-uploads the whole TLAS buffer.

        new_transforms: [I, 4, 4] row-major, in creation order (the order
        the instances were passed to BuildTopAccelStruct).  Returns
        device_scene(device), made first if needed; device_scene gives
        any other scene, refitted too.
        Needs the TLAS built by BuildTopAccelStruct (a file-loaded TLAS
        has no BLAS objects to rebuild over).
        """
        if self.source_instances is None:
            raise ValueError("refit needs the TLAS's source instances "
                             "(BuildTopAccelStruct); a file-loaded TLAS "
                             "has none")
        scene = self.device_scene(device)
        for inst, tf in zip(self.source_instances, new_transforms,
                            strict=True):
            inst.transform = np.ascontiguousarray(tf, np.float32)
        nodes, dev_inst, new_offsets, _ = builder.build_tlas_arrays(
            self.source_instances)
        self.nodes = nodes
        self.instances = dev_inst
        self.blas_offsets = new_offsets
        self._blob = None                 # reserialized if .blob is read
        # serialized offsets shift with the TLAS's shape, so each scene's
        # BLAS rows are found by BLAS identity
        for key, s in self._scenes.items():
            roots = self._blas_roots[key]
            bvh_device.update_tlas(
                s, nodes, dev_inst,
                {off: roots[id(b)] for off, b in new_offsets},
                self.tlas_capacity)
        return scene


def BuildTopAccelStruct(instances: Sequence[types.Instance],
                        verbose: bool = False) -> TopAccelStruct:
    """Build a TLAS over instances (reference: radiance.cpp:54-84)."""
    t0 = time.time()
    nodes, dev_inst, blas_offsets, max_depth = builder.build_tlas_arrays(
        list(instances))
    blob = serialize.serialize_tlas(nodes, dev_inst, blas_offsets)
    if verbose:
        print(f"TLAS build: {len(instances)} instances, {len(nodes)} nodes, "
              f"depth {max_depth}, {time.time() - t0:.3f}s")
    return TopAccelStruct(_blob=blob, nodes=nodes, instances=dev_inst,
                          blas_offsets=blas_offsets,
                          source_instances=list(instances),
                          tlas_capacity=bvh_device.tlas_capacity_for(
                              len(instances)))


def BuildAccelStruct(arg, verbose: bool = False):
    """Overloaded like the reference: Mesh -> BLAS, [Instance] -> TLAS."""
    if isinstance(arg, types.Mesh):
        return BuildBottomAccelStruct(arg, verbose=verbose)
    return BuildTopAccelStruct(arg, verbose=verbose)


def TopAccelStructToFile(accel: TopAccelStruct, path: str) -> None:
    """Checkpoint (reference: radiance.cpp:428-448)."""
    serialize.tlas_to_file(accel.blob, path)


def FileToTopAccelStruct(path: str) -> TopAccelStruct:
    """Resume (reference: radiance.cpp:450-479).  The device scene is made
    when first asked for, on the device asked for."""
    parsed = serialize.tlas_from_file(path)
    return TopAccelStruct(
        _blob=parsed.blob, nodes=parsed.nodes, instances=parsed.instances,
        blas_offsets=[],
        tlas_capacity=bvh_device.tlas_capacity_for(len(parsed.instances)),
        _parsed_blas=parsed.blas)
