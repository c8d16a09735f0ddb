"""Platform + resource API (RD:: namespace parity).

Port of radiance_tpu/api/platform.py (reference: radiance/include/
radiance.h:115-174, radiance/src/radiance.cpp:86-240): a singleton
Platform and CreateBuffer/CreateImage/CreateImageArray/CreateSampler with
blocking Read/Write.

A Buffer is host bytes + lazily made tensors on the platform's device.
Frame-loop state (the accumulation scratch) stays on the device across
TraceRays calls -- the reference round-trips every frame
(sample1.cpp:469-490); here ReadBuffer only materializes host bytes on
demand.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from radiance_tpu_torch import config
from radiance_tpu_torch.core import device as rdevice
from radiance_tpu_torch.scene.bindings import Sampler
from radiance_tpu_torch.utils import profiling


class Buffer:
    """A device buffer handle (reference: CreateBuffer, radiance.cpp:133-140).

    Host bytes are authoritative unless `device_dirty` is set, in which case
    the device value is newer (written by TraceRays) and host reads sync.
    """

    def __init__(self, size: int):
        self.size = size
        self.host = np.zeros(size, np.uint8)
        self.version = 0
        self._device: Dict[Any, Any] = {}
        self._device_version = -1
        self.device_value: Optional[torch.Tensor] = None  # device-newer value
        self.device_dirty = False
        self._to_host = None  # callable converting device_value -> numpy

    # --- host side ---
    def write(self, data, offset: int = 0):
        raw = np.frombuffer(np.ascontiguousarray(data).tobytes(), np.uint8)
        self.host[offset:offset + raw.size] = raw
        self.version += 1
        self.device_dirty = False

    def read(self, size: Optional[int] = None, offset: int = 0) -> np.ndarray:
        self.sync_to_host()
        size = self.size if size is None else size
        return self.host[offset:offset + size]

    def sync_to_host(self):
        if self.device_dirty and self.device_value is not None:
            with profiling.span("rdapi.read_back"):
                raw = self.device_value.cpu().numpy()
                if self._to_host is not None:
                    raw = self._to_host(raw)
                raw = np.frombuffer(np.ascontiguousarray(raw).tobytes(),
                                    np.uint8)
                self.host[:raw.size] = raw
            self.version += 1
            self.device_dirty = False

    # --- device side ---
    def device(self, key, parser):
        """Cached device view; key identifies the parse (dtype/shape)."""
        if self.device_dirty and key in self._device and self._device_version == self.version:
            return self._device[key]
        if self.device_dirty:
            # device holds a newer value under a *different* key: parsing
            # self.host would read stale bytes, so materialize first
            self.sync_to_host()
        if self._device_version != self.version:
            self._device.clear()
        if key not in self._device:
            self._device[key] = parser(self.host)
            self._device_version = self.version
        return self._device[key]

    def set_device_value(self, value: torch.Tensor, to_host=None, key=None):
        """TraceRays output: the device value is now authoritative.
        to_host maps value.cpu().numpy() to the buffer's host layout."""
        self.device_value = value
        self._to_host = to_host
        self.device_dirty = True
        if key is not None:
            self._device = {key: value}
            self._device_version = self.version


class Image(Buffer):
    """W*H*4 byte image buffer -- the reference's CreateImage is a plain
    buffer too, not a CL image (radiance.cpp:86-93)."""

    def __init__(self, width: int, height: int):
        super().__init__(width * height * config.CHANNEL)
        self.width = width
        self.height = height


class ImageArray:
    """[T, H, W, 4] uint8 texture array (reference: radiance.cpp:96-121),
    made on `device` when first bound."""

    def __init__(self, width: int, height: int, array_size: int,
                 device: torch.device):
        self.width = width
        self.height = height
        self.array_size = max(array_size, 1)
        self.host = np.zeros((self.array_size, height, width, config.CHANNEL),
                             np.uint8)
        self.version = 0
        self._device_of = device
        self._device = None
        self._device_version = -1

    def write_layer(self, index: int, data: np.ndarray):
        self.host[index] = np.asarray(data, np.uint8).reshape(
            self.height, self.width, config.CHANNEL)
        self.version += 1

    def read_layer(self, index: int) -> np.ndarray:
        return self.host[index]

    def device(self) -> torch.Tensor:
        if self._device is None or self._device_version != self.version:
            self._device = torch.from_numpy(self.host.copy()).to(
                self._device_of)
            self._device_version = self.version
        return self._device


class Platform:
    """Singleton platform (reference: radiance.h:146-174).

    Every tensor the API makes lives on `device`, which the first
    GetPlatform call fixes: the card unless it asks for the CPU."""

    _instance: Optional["Platform"] = None

    def __init__(self, device: torch.device):
        self.device = device
        self.active_pipeline = None
        self.bound_descriptor_set: Optional[List[Any]] = None

    @staticmethod
    def GetPlatform(device=None) -> "Platform":
        """The platform; the first call makes it on `device` (default
        "cuda", which raises without a card).  A later call naming another
        device raises."""
        inst = Platform._instance
        if inst is None:
            dev = rdevice.resolve(device or rdevice.DEFAULT)
            inst = Platform._instance = Platform(dev)
            if dev.type == "cuda":
                name, count = (torch.cuda.get_device_name(dev),
                               torch.cuda.device_count())
            else:
                name, count = dev.type, 1
            print(f"Platform initialized: {dev} ({name}), {count} "
                  f"device(s).")
        elif device is not None and rdevice.resolve(device) != inst.device:
            raise RuntimeError(
                f"the platform was initialized on {inst.device}; it cannot "
                f"also run on {device}")
        return inst


def CreateBuffer(platform: Platform, size: int) -> Buffer:
    return Buffer(size)


def CreateImage(platform: Platform, width: int, height: int) -> Image:
    return Image(int(width), int(height))


def CreateImageArray(platform: Platform, width: int, height: int,
                     array_size: int) -> ImageArray:
    return ImageArray(width, height, array_size, platform.device)


def CreateSampler(platform: Platform, addressing_mode: int,
                  filter_mode: int) -> Sampler:
    return Sampler(addressing=addressing_mode, filter=filter_mode)


def WriteBuffer(platform: Platform, handle: Buffer, size: int, data,
                offset: int = 0):
    raw = np.frombuffer(np.ascontiguousarray(data).tobytes(), np.uint8)[:size]
    handle.write(raw, offset)


def ReadBuffer(platform: Platform, handle: Buffer, size: int,
               out: Optional[np.ndarray] = None, offset: int = 0) -> np.ndarray:
    data = handle.read(size, offset)
    if out is not None:
        flat = np.frombuffer(np.ascontiguousarray(out).data, np.uint8)
        flat[:size] = data
        return out
    return data


def WriteImage(platform: Platform, handle: ImageArray, width: int, height: int,
               array_index: int, data):
    handle.write_layer(array_index, np.asarray(data, np.uint8))


def ReadImage(platform: Platform, handle: ImageArray, width: int, height: int,
              array_index: int) -> np.ndarray:
    return handle.read_layer(array_index)
