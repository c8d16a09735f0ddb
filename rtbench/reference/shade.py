"""The plain reference of sample1's progressive frames at chosen pixels.

What one frame of sample1 computes at a pixel (reference:
samples/shader.cl:89-305 and radiance/shader/pbr.cl; the port's
engine/pathtracer.py, engine/shaders.py, engine/context.py,
shading/camera.py, shading/pbr.py and ops/tonemap.py follow them), for a
scene of one mesh with flat per-triangle normals, one material without
textures, a pinhole camera and one directional light:

  for each sample s of a frame whose accumulation holds totalSamples:
  raygen: PCG3D({totalSamples + s, totalSamples, pixel}) sub-pixel
    jitter;
  per bounce: closest hit; on a hit the material shader: a shadow ray
    toward the light, the transmission-weighted GGX BRDF times the
    light's colour unless occluded, plus 0.1 albedo ambient, and the next
    ray from the GGX / cosine sampler on PCG3D({frame, pixel, bounce});
    on a miss the sky colour at bounce 0;
  the running average (f * accum + the batch's colour sum) / (f + batch)
  with f = totalSamples, ACES and gamma 0.7, and the u8 truncation,
  after every frame (engine/pathtracer.py frame_fn, _finish_frame).

Traces go through reference/trace.py.  Every float runs in `dtype`
(float32, or bfloat16 for the control).
"""

import torch

from rtbench import rays as rrays
from rtbench.reference import trace as rtrace

PI = 3.14159265359
SKY = (0.2, 0.2, 0.5)
AMBIENT = 0.1


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(v, eps=0.0):
    n = torch.sqrt(torch.sum(v * v, -1, keepdim=True))
    if eps:
        n = torch.clamp(n, min=eps)
    return v / n


def _tangent_frame(n):
    x = torch.zeros_like(n)
    x[..., 0] = 1.0
    y = torch.zeros_like(n)
    y[..., 1] = 1.0
    use = (1.0 - torch.abs(_dot(x, n))) > 1e-6
    t = torch.where(use[..., None], _norm(rtrace._cross(x, n), 1e-30), y)
    return t, rtrace._cross(n, t)


def _to_world(n, local):
    t, b = _tangent_frame(n)
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


def _fresnel(cos_t, metallic, albedo):
    f0 = 0.04 * (1.0 - metallic) + albedo * metallic
    p = torch.pow(torch.clamp(1.0 - cos_t, min=0.0), 5.0)
    return f0 + (1.0 - f0) * p[..., None]


def _lambda(x, y, z, a):
    cos2 = z * z
    sin2 = torch.clamp(1.0 - cos2, min=0.0)
    tan2 = sin2 / cos2
    sin_t = torch.sqrt(sin2)
    zero = sin_t == 0.0
    safe = torch.where(zero, 1.0, sin_t)
    cos_p = torch.where(zero, 1.0, torch.clamp(x / safe, -1.0, 1.0))
    sin_p = torch.where(zero, 0.0, torch.clamp(y / safe, -1.0, 1.0))
    a2 = (cos_p * a) ** 2 + (sin_p * a) ** 2
    lam = (torch.sqrt(1.0 + a2 * tan2) - 1.0) / 2.0
    return torch.where(torch.isinf(tan2), 0.0, lam)


def _g_smith(wo, wi, n, rough):
    t, b = _tangent_frame(n)
    ox, oy, oz = _dot(wo, t), _dot(wo, b), _dot(wo, n)
    ix, iy, iz = _dot(wi, t), _dot(wi, b), _dot(wi, n)
    g = 1.0 / (1.0 + _lambda(ix, iy, iz, rough) + _lambda(ox, oy, oz, rough))
    return torch.where((iz < 0.0) | (oz < 0.0), 0.0, g)


def _ggx_d(nh, rough):
    a2 = (rough * rough) ** 2
    den = nh * nh * (a2 - 1.0) + 1.0
    return a2 / (PI * den * den)


def _c01(x):
    return torch.clamp(x, 0.0, 1.0)


def _brdf(l, v, n, albedo, metallic, rough, transm):
    h = _norm(v + l, 1e-30)
    nv, nl = _c01(_dot(n, v)), _c01(_dot(n, l))
    nh, vh = _c01(_dot(n, h)), _c01(_dot(v, h))
    f = _fresnel(vh, metallic, albedo)
    spec = f * (_ggx_d(nh, rough) * _g_smith(v, l, n, rough)
                / torch.clamp(4.0 * nv * nl, min=0.001))[..., None]
    diff = (1.0 - f) * (1.0 - metallic) * (1.0 - transm) * (albedo / PI)
    return (diff + spec) * nl[..., None]


def _dir(n, a_or_none, rx, ry):
    """Cosine-weighted (a None) or GGX half-vector (roughness^2 = a)
    direction about n."""
    if a_or_none is None:
        theta = torch.arccos(torch.sqrt(ry))
    else:
        a = a_or_none
        theta = torch.arccos(torch.sqrt((1.0 - ry) / (1.0 + (a * a - 1.0)
                                                      * ry)))
    phi = 2.0 * PI * rx
    st, ct = torch.sin(theta), torch.cos(theta)
    return _to_world(n, torch.stack([st * torch.cos(phi),
                                     st * torch.sin(phi), ct], -1))


def _sample(v, n, albedo, metallic, rough, transm, rnd):
    """The transmission-aware sampler with transmission 0: specular for
    rz >= 0.5, else cosine-weighted diffuse.  (direction, factor)."""
    rx, ry, rz = rnd[..., 0], rnd[..., 1], rnd[..., 2]
    l_d = _dir(n, None, rx, ry)
    h_d = _norm(v + l_d, 1e-30)
    f_d = _fresnel(_c01(_dot(v, h_d)), metallic, albedo)
    fac_d = (1.0 - f_d) * (1.0 - metallic) * albedo * 2.0
    h_s = _dir(n, rough * rough, rx, ry)
    l_s = -v + 2.0 * _dot(v, h_s)[..., None] * h_s
    nv, nh, vh = _c01(_dot(n, v)), _c01(_dot(n, h_s)), _c01(_dot(v, h_s))
    g = _g_smith(v, l_s, n, rough)
    f_s = _fresnel(vh, metallic, albedo)
    fac_s = f_s * (g * vh / torch.clamp(nh * nv, min=0.001))[..., None] * 2.0
    spec = (rz >= 0.5)[..., None]
    return torch.where(spec, l_s, l_d), torch.where(spec, fac_s, fac_d)


def _aces_gamma(x):
    x = x * 0.6
    x = torch.clamp((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14),
                    0.0, 1.0)
    return torch.pow(torch.clamp(x, min=0.0), 0.7)


class Frames:
    """sample1's frames at `pixels` of a w x h image.

    tree: reference/trace.py's Tree; normals: [T, 3] unit face normals;
    cam: dict(eye, focal_length, sensor_width); light: (direction the
    light travels, colour); mat: dict(albedo, metallic, roughness,
    transmission)."""

    def __init__(self, tree, normals, w, h, cam, light, mat, depth,
                 tmin=0.001, tmax=1000.0, dtype=torch.float32):
        if mat["transmission"] != 0.0:
            raise ValueError("the reference samples no transmission")
        self.tree, self.w, self.h, self.depth = tree, w, h, depth
        self.tmin, self.tmax, self.dtype = tmin, tmax, dtype
        dev = normals.device
        self.normals = normals.to(dtype)
        f = dict(dtype=dtype, device=dev)
        self.eye = torch.tensor(cam["eye"], **f)
        self.fl = torch.tensor(cam["focal_length"], **f)
        self.sw = torch.tensor(cam["sensor_width"], **f)
        self.to_light = _norm(-torch.tensor(light["direction"], **f), 1e-30)
        self.light_rgb = torch.tensor(light["color"], **f)
        self.albedo = torch.tensor(mat["albedo"][:3], **f)
        self.metallic = torch.tensor(mat["metallic"], **f)
        self.rough = torch.clamp(torch.tensor(mat["roughness"], **f), 0.0, 1.0)
        self.transm = torch.tensor(mat["transmission"], **f)
        self.sky = torch.tensor(SKY, **f)

    def _pcg(self, a, b, c):
        return rrays.pcg3d(torch.stack([a, b, c], -1)).to(self.dtype)

    def colors(self, pixels, fids, ts):
        """The sample colours [len(fids), len(pixels), 3] of sample ids
        `fids` (int64 [S]), each in the frame whose accumulation held
        `ts` (int64 [S]) samples."""
        dev = pixels.device
        dt = self.dtype
        nf, npx = fids.shape[0], pixels.shape[0]
        pix = pixels[None].expand(nf, npx).reshape(-1).to(torch.int64)
        fid = fids[:, None].expand(nf, npx).reshape(-1).to(torch.int64)
        tsi = ts[:, None].expand(nf, npx).reshape(-1).to(torch.int64)
        w = torch.tensor(float(self.w), dtype=dt, device=dev)
        h = torch.tensor(float(self.h), dtype=dt, device=dev)
        rnd = self._pcg(fid, tsi, pix)
        xi = torch.remainder(pix, self.w).to(dt)
        yi = torch.div(pix, self.w, rounding_mode="floor").to(dt)
        fx = (xi + rnd[:, 0]) / w - 0.5
        fy = 0.5 - (yi + rnd[:, 1]) / h
        d = _norm(torch.stack([fx * self.sw, fy * self.sw * (h / w),
                               (-self.fl).expand(fx.shape)], -1))
        d = _norm(d)
        o = self.eye.expand(d.shape).contiguous()
        n = d.shape[0]
        color = torch.zeros(n, 3, dtype=dt, device=dev)
        contrib = torch.ones(n, 3, dtype=dt, device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        for b in range(self.depth):
            t, prim, _, _ = rtrace.trace(self.tree, o, d, self.tmin,
                                         self.tmax, live=alive)
            hit = alive & (prim >= 0)
            fn = _norm(self.normals[torch.clamp(prim, min=0)], 1e-30)
            pos = o + t.to(dt)[:, None] * d + fn * 1e-5
            v = _norm(-d, 1e-30)
            l = self.to_light.expand(n, 3)
            _, occ, _, _ = rtrace.trace(self.tree, pos, l.contiguous(),
                                        0.001, 1000.0, any_hit=True, live=hit)
            direct = _brdf(l, v, fn, self.albedo, self.metallic, self.rough,
                           self.transm) * self.light_rgb
            c = torch.where((occ >= 0)[:, None], 0.0, direct) \
                + self.albedo * AMBIENT
            rb = self._pcg(fid, pix, torch.full_like(pix, b))
            nd, fac = _sample(v, fn, self.albedo, self.metallic, self.rough,
                              self.transm, rb)
            below = _dot(nd, fn) < 0.0
            pos_out = torch.where(below[:, None],
                                  o + t.to(dt)[:, None] * d - fn * 1e-5, pos)
            color = color + torch.where(hit[:, None], contrib * c, 0.0)
            if b == 0:
                color = torch.where((alive & ~hit)[:, None], self.sky, color)
            contrib = torch.where(hit[:, None], contrib * fac, contrib)
            alive = hit
            o = torch.where(hit[:, None], pos_out, o)
            d = torch.where(hit[:, None], nd, d)
        return color.view(nf, npx, 3)

    def images(self, pixels, n_frames, batch, lanes=65536):
        """The u8 image [n_frames, P, 3] (as float32) at `pixels` after
        each of frames 0..n_frames-1 of `batch` samples each, accumulated
        from totalSamples 0; samples are traced `lanes` paths at once."""
        dev = pixels.device
        n = n_frames * batch
        chunk = max(lanes // pixels.shape[0], 1)
        cols = []
        for k0 in range(0, n, chunk):
            fid = torch.arange(k0, min(k0 + chunk, n), device=dev)
            cols.append(self.colors(pixels, fid, fid - fid % batch))
        cols = torch.cat(cols)
        acc = torch.zeros(pixels.shape[0], 3, dtype=self.dtype, device=dev)
        out = []
        for i in range(n_frames):
            s = torch.zeros_like(acc)
            for c in cols[i * batch:(i + 1) * batch]:
                s = s + c            # the engine's order of the batch's sum
            f = torch.tensor(float(i * batch), dtype=self.dtype, device=dev)
            acc = (f * acc + s) / (f + float(batch))
            out.append(torch.clamp(torch.floor(_aces_gamma(acc) * 255.0),
                                   0.0, 255.0))
        return torch.stack(out).to(torch.float32)
