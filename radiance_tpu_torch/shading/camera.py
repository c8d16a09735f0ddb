"""Physical thin-lens camera with PCG3D-jittered ray generation.

Port of radiance_tpu/shading/camera.py (reference:
samples/shader.cl:89-173): identical jitter sequence ({frameID,
totalSamples, index} PCG3D input), rotation order (X*Y*Z) and pinhole
shortcut when fStop == 0.
"""

from __future__ import annotations

import torch

from radiance_tpu_torch.core import device as rdevice
from radiance_tpu_torch.core import math as rmath

PI = 3.14159265359


def sample_uniform_disk(u):
    """Concentric disk mapping (reference: shader.cl:89-109).  u: [..., 2]."""
    uo = 2.0 * u - 1.0
    ux, uy = uo[..., 0], uo[..., 1]
    x_major = torch.abs(ux) > torch.abs(uy)
    safe_ux = torch.where(ux == 0.0, 1.0, ux)
    safe_uy = torch.where(uy == 0.0, 1.0, uy)
    r = torch.where(x_major, ux, uy)
    theta = torch.where(x_major, (PI / 4.0) * (uy / safe_ux),
                        (PI / 2.0) - (PI / 4.0) * (ux / safe_uy))
    out = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)],
                                     dim=-1)
    zero = (ux == 0.0) & (uy == 0.0)
    return torch.where(zero[..., None], 0.0, out)


def generate_rays(cam: dict, pixel_index, rand_input):
    """Camera rays for a batch of pixels.

    cam: dict of 0-d float32 tensors with the PhysicalCamera fields
    (camera_params).  pixel_index: [N] int flat pixel index (row major).
    rand_input: [N, 3] uint32 values (int64 tensor) for PCG3D.
    Returns (origin [N,3], direction [N,3]).
    """
    w = cam["width_pixel"]
    h = cam["height_pixel"]
    wi = w.to(torch.int32)
    xi = torch.remainder(pixel_index, wi).to(torch.float32)
    yi = torch.div(pixel_index, wi, rounding_mode="floor").to(torch.float32)

    random = rmath.pcg3d(rand_input)
    fx = (xi + random[..., 0]) / w - 0.5
    fy = 0.5 - (yi + random[..., 1]) / h

    aspect = h / w
    pin_dir = torch.stack([
        fx * cam["sensor_width"],
        fy * cam["sensor_width"] * aspect,
        (-cam["focal_length"]).expand(fx.shape),
    ], dim=-1)
    pin_dir = rmath.normalize(pin_dir)
    pin_origin = torch.stack([cam["x"], cam["y"], cam["z"]])
    # time uses the *unrotated* direction z (shader.cl:135)
    time = -cam["focal_distance"] / pin_dir[..., 2]

    rot = rmath.mat4_mat4(rmath.euler_x(cam["wx"]),
                          rmath.mat4_mat4(rmath.euler_y(cam["wy"]),
                                          rmath.euler_z(cam["wz"])))
    pin_dir = rmath.normalize(rmath.mat4_transform_dir(rot, pin_dir))

    pinhole = cam["f_stop"] == 0.0
    lens_radius = (cam["focal_length"]
                   / torch.where(pinhole, 1.0, cam["f_stop"])) / 2.0
    lens_pos = lens_radius * sample_uniform_disk(random[..., 1:3])
    hit_point = pin_origin + pin_dir * time[..., None]
    lens_local = torch.stack([lens_pos[..., 0], lens_pos[..., 1],
                              torch.zeros_like(lens_pos[..., 0])], dim=-1)
    lens_origin = pin_origin + rmath.mat4_transform_dir(rot, lens_local)
    lens_dir = rmath.normalize(hit_point - lens_origin)

    origin = torch.where(pinhole, pin_origin.expand(lens_origin.shape),
                         lens_origin)
    direction = torch.where(pinhole, pin_dir, lens_dir)
    return origin, direction


def physical_camera_raygen(resources, pixel_index, rand_input):
    """Ray generator for WavefrontPathTracer reading res["camera"]."""
    return generate_rays(resources["camera"], pixel_index, rand_input)


def camera_params(cam, device=rdevice.DEFAULT) -> dict:
    """PhysicalCamera dataclass or PHYSICAL_CAMERA_DTYPE record -> dict of
    0-d float32 tensors on `device`."""
    device = rdevice.resolve(device)
    if hasattr(cam, "width_pixel"):
        fields = dict(
            width_pixel=cam.width_pixel, height_pixel=cam.height_pixel,
            focal_length=cam.focal_length, sensor_width=cam.sensor_width,
            focal_distance=cam.focal_distance, f_stop=cam.f_stop,
            x=cam.x, y=cam.y, z=cam.z, wx=cam.wx, wy=cam.wy, wz=cam.wz)
    else:  # structured numpy record (a camera buffer parsed by TraceRays)
        fields = dict(
            width_pixel=cam["widthPixel"], height_pixel=cam["heightPixel"],
            focal_length=cam["focalLength"], sensor_width=cam["sensorWidth"],
            focal_distance=cam["focalDistance"], f_stop=cam["fStop"],
            x=cam["x"], y=cam["y"], z=cam["z"],
            wx=cam["wx"], wy=cam["wy"], wz=cam["wz"])
    return {k: torch.tensor(float(v), dtype=torch.float32, device=device)
            for k, v in fields.items()}
