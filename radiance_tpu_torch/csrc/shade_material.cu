// The engine's material wave: the built-in `material` closest-hit shader,
// the `environment` miss shader and the path update of one closest-hit
// wave, in two kernels placed around the shadow trace.
//
// Replaces no TPU kernel.  The JAX package's `material`
// (radiance_tpu/engine/shaders.py), its context gathers
// (engine/context.py), shading/pbr.py and the accumulation of
// pathtracer.py's _sample_step are plain jnp that XLA fuses under jit;
// the port ran the same code as ~1,000 small torch kernels a wave.  These
// kernels are the port's hand-written counterpart of that fusion
// (reference: samples/shader.cl:482-541, :543-557, :238-252).
//
//   rt_material_prep   (shader.cl:482-501, engine/context.py): per lane
//     alive and hit, the instance row by slot, the triangle's indices, the
//     interpolated world face normal, the world hit point and the nudged
//     shadow-ray origin, the normal-mapped shading normal, metallic,
//     roughness, transmission, ior and albedo (textures sampled as
//     ops/texture.sample_image_array does, every addressing and filter
//     mode).  Writes the shadow origins [n, 3] and a shading record
//     [n, 16]: (world.xyz, metallic), (face_n.xyz, roughness),
//     (nrm.xyz, transmission), (albedo.xyz, ior).  A lane that does not
//     shade gets the shadow origin 0: the trace masks or parks it, and a
//     finite value keeps packet_trace.coherence_key's Morton box (amin /
//     amax over every lane) on the scene, where the SBT path's arithmetic
//     on miss records (t = FLT_MAX) stretches it past 1e38 and the
//     argsort route then orders its shadow rays by octant alone.
//   the shadow trace: unchanged, in Python between the two launches.
//   rt_material_finish (shader.cl:502-541, :550-557, :238-252): the
//     direct term (microfacet_brdf x light colour, 0 where occluded) plus
//     the ambient albedo * 0.1, PCG3D of (frame, pixel, depth) in uint32,
//     sample_microfacet_brdf_transm computing only the branch rz and
//     transmission select, the far-side restart of transmitted rays, the
//     environment colour of live misses (the background at depth 0), and
//     the colour, throughput and alive update.
//
// What bounds it on an H100: bytes.  Prep reads the hit record (20 B), the
// ray (24 B), alive (1 B), three indices and nine normal floats as gathers
// (48 B, more in whole 32-B sectors) and writes 76 B; finish reads hit t,
// alive, the occlusion bit, the record, the ray, the pixel index and the
// path state (126 B) and writes 49 B: ~345 B a lane, 0.71 GB for a
// 1920x1080 wave, 0.21 ms at 3.35 TB/s.  Instance, mesh and material rows
// and the light are a few KB, read through L1/L2.
//
// Design: one thread a lane, 256 a block, no shared memory.  The record
// between the kernels, rather than a second pass over the gathers: it
// moves 128 B a lane in coalesced 16-B accesses, where recomputing in
// finish would re-read the hit record, the origin, the indices and the
// normals (80 B, 48 of them scattered gathers that move whole sectors) and,
// on textured scenes, the UVs and up to four bilinear samples again; and
// the world hit point, which the far-side restart nudges, cannot be
// recovered from the shadow origin.  Finish updates color, contribution
// and alive in place (the engine's own path state, made by _sample_init
// and read by no one after the wave) and writes next_origin and next_dir
// to new tensors (a ray generator may hand out views, e.g. an expanded
// origin), copying the ray where the lane does not shade.
//
// Numerics: the torch path's float32 arithmetic operation for operation.
// The library is built with -fmad=false and IEEE division and square root
// (no fast math); acosf, sinf, cosf, powf and sqrtf are the functions
// ATen's kernels call; clamps propagate NaN as ATen's do.  Three-term sums
// follow the card's torch.sum: over a contiguous last dim of 3 (dot,
// normalize, the 4x4 transforms) (a0 + a2) + a1, over the strided vertex
// dim of the barycentric interpolation (a0 + a1) + a2.  A division by a
// Python scalar is ATen's multiply by the scalar's float reciprocal; 1 / x
// of a tensor its reciprocal.  pow(x, 2) is x * x and pow(x, 5) powf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kFltMax = 3.4028234663852886e38f;
// pbr.PI and its uses: x / PI is ATen's x * (1.0f / (float)PI); Python
// folds 2.0 * PI in double first.
constexpr float kPi = static_cast<float>(3.14159265359);
constexpr float kInvPiDiv = 1.0f / kPi;
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265359);
constexpr float kInv255 = 1.0f / 255.0f;
constexpr float kEps = 1e-30f;

// ops/texture.py / config.py
constexpr int kClampToEdge = 0;
constexpr int kClampBorder = 1;
constexpr int kRepeat = 2;
constexpr int kMirroredRepeat = 3;
constexpr int kNearest = 0;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }

// torch.sum over a contiguous last dim of 3 on the card
__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
  return (a0 + a2) + a1;
}
// torch.sum over the strided vertex dim (dim 1 of [n, 3, 3])
__device__ __forceinline__ float sum3_strided(float a0, float a1, float a2) {
  return (a0 + a1) + a2;
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return sum3(a.x * b.x, a.y * b.y, a.z * b.z);
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp01(float x) { return clamp(x, 0.0f, 1.0f); }
__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// rmath.normalize(v, eps=1e-30)
__device__ __forceinline__ V3 normalize(V3 v) {
  float n = clamp_min(sqrtf(sum3(v.x * v.x, v.y * v.y, v.z * v.z)), kEps);
  return v3(v.x / n, v.y / n, v.z / n);
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}

// rmath.tangent_frame: (tangent, bitangent) of n
__device__ __forceinline__ void tangent_frame(V3 n, V3* t, V3* b) {
  const V3 some = v3(1.0f, 0.0f, 0.0f);
  float dd = dot(some, n);
  bool use_cross = (1.0f - fabsf(dd)) > 1e-6f;
  *t = use_cross ? normalize(cross(some, n)) : v3(0.0f, 1.0f, 0.0f);
  *b = cross(n, *t);
}

// rmath.transform_local_dir
__device__ __forceinline__ V3 transform_local_dir(V3 n, V3 local) {
  V3 t, b;
  tangent_frame(n, &t, &b);
  return add(add(scale(t, local.x), scale(b, local.y)), scale(n, local.z));
}

// rmath.mat4_transform_point / _dir on a row-major 4x4
__device__ __forceinline__ V3 xform_dir(const float* m, V3 p) {
  return v3(sum3(m[0] * p.x, m[1] * p.y, m[2] * p.z),
            sum3(m[4] * p.x, m[5] * p.y, m[6] * p.z),
            sum3(m[8] * p.x, m[9] * p.y, m[10] * p.z));
}
__device__ __forceinline__ V3 xform_point(const float* m, V3 p) {
  V3 r = xform_dir(m, p);
  return v3(r.x + m[3], r.y + m[7], r.z + m[11]);
}

__device__ __forceinline__ V3 load3(const float* p, long long i) {
  return v3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}
__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// ---------------------------------------------------------------------------
// shading/pbr.py
// ---------------------------------------------------------------------------

__device__ __forceinline__ V3 f_schlick(float cos_theta, float metallic,
                                        V3 albedo) {
  float om = 1.0f - metallic;
  V3 f0 = v3(om * 0.04f + albedo.x * metallic, om * 0.04f + albedo.y * metallic,
             om * 0.04f + albedo.z * metallic);
  float p = powf(clamp_min(1.0f - cos_theta, 0.0f), 5.0f);
  return v3(f0.x + (1.0f - f0.x) * p, f0.y + (1.0f - f0.y) * p,
            f0.z + (1.0f - f0.z) * p);
}

__device__ __forceinline__ float d_ggx(float dot_nh, float roughness) {
  float alpha = roughness * roughness;
  float alpha2 = alpha * alpha;
  float denom = dot_nh * dot_nh * (alpha2 - 1.0f) + 1.0f;
  return alpha2 / (denom * kPi * denom);
}

__device__ __forceinline__ float lambda_ggx(float x, float y, float z,
                                            float a) {
  float cos2 = z * z;
  float sin2 = clamp_min(1.0f - cos2, 0.0f);
  float tan2 = sin2 / cos2;
  float sin_theta = sqrtf(sin2);
  bool zero = sin_theta == 0.0f;
  float safe = zero ? 1.0f : sin_theta;
  float cos_phi = zero ? 1.0f : clamp(x / safe, -1.0f, 1.0f);
  float sin_phi = zero ? 0.0f : clamp(y / safe, -1.0f, 1.0f);
  float ca = cos_phi * a, sa = sin_phi * a;
  float alpha2 = ca * ca + sa * sa;
  float lam = (sqrtf(1.0f + alpha2 * tan2) - 1.0f) * 0.5f;
  return isinf(tan2) ? 0.0f : lam;
}

// pbr.g_pbrt(wo, wi, n, roughness)
__device__ __forceinline__ float g_pbrt(V3 wo, V3 wi, V3 n, float roughness) {
  V3 t, b;
  tangent_frame(n, &t, &b);
  float ox = dot(wo, t), oy = dot(wo, b), oz = dot(wo, n);
  float ix = dot(wi, t), iy = dot(wi, b), iz = dot(wi, n);
  float g = 1.0f / (1.0f + lambda_ggx(ix, iy, iz, roughness)
                    + lambda_ggx(ox, oy, oz, roughness));
  return (iz < 0.0f || oz < 0.0f) ? 0.0f : g;
}

// pbr.microfacet_brdf
__device__ V3 microfacet_brdf(V3 l, V3 v, V3 n, V3 albedo, float metallic,
                              float roughness, float transmission) {
  V3 h = normalize(add(v, l));
  float dot_nv = clamp01(dot(n, v));
  float dot_nl = clamp01(dot(n, l));
  float dot_nh = clamp01(dot(n, h));
  float dot_vh = clamp01(dot(v, h));
  V3 f = f_schlick(dot_vh, metallic, albedo);
  float d = d_ggx(dot_nh, roughness);
  float g = g_pbrt(v, l, n, roughness);
  float s = d * g / clamp_min(4.0f * dot_nv * dot_nl, 0.001f);
  V3 f_spec = scale(f, s);
  float om = 1.0f - metallic, ot = 1.0f - transmission;
  V3 not_spec = v3((1.0f - f.x) * om * ot, (1.0f - f.y) * om * ot,
                   (1.0f - f.z) * om * ot);
  V3 f_diff = mul(not_spec, scale(albedo, kInvPiDiv));
  return scale(add(f_diff, f_spec), dot_nl);
}

// pbr._diffuse_dir / _ggx_half_dir: a local direction at (theta, phi)
__device__ __forceinline__ V3 polar_dir(V3 n, float theta, float rx) {
  float phi = kTwoPi * rx;
  float st = sinf(theta), ct = cosf(theta);
  return transform_local_dir(n, v3(st * cosf(phi), st * sinf(phi), ct));
}
__device__ __forceinline__ V3 ggx_half_dir(V3 n, float roughness, float rx,
                                           float ry) {
  float a = roughness * roughness;
  float theta = acosf(sqrtf((1.0f - ry) / (1.0f + (a * a - 1.0f) * ry)));
  return polar_dir(n, theta, rx);
}

// rmath.reflect(v, h)
__device__ __forceinline__ V3 reflect(V3 v, V3 h) {
  return add(neg(v), scale(h, 2.0f * dot(v, h)));
}

// rmath.refract(v, h, eta)
__device__ __forceinline__ V3 refract(V3 v, V3 h, float eta) {
  float cos_i = dot(h, v);
  float sin2_i = clamp_min(1.0f - cos_i * cos_i, 0.0f);
  float sin2_t = sin2_i / (eta * eta);
  bool tir = (1.0f - sin2_t) < 0.0f;
  float cos_t = sqrtf(clamp_min(1.0f - sin2_t, 0.0f));
  if (tir) {
    return v3((cos_i * h.x - v.x) / eta, (cos_i * h.y - v.y) / eta,
              (cos_i * h.z - v.z) / eta);
  }
  float k = cos_i / eta - cos_t;
  return v3(-v.x / eta + k * h.x, -v.y / eta + k * h.y, -v.z / eta + k * h.z);
}

// pbr._spec_factor's scalar: g * vo_h / max(no_h * no_v, 0.001)
__device__ __forceinline__ float spec_scalar(float g, float vo_h, float no_h,
                                             float no_v) {
  return g * vo_h / clamp_min(no_h * no_v, 0.001f);
}

// pbr.sample_microfacet_brdf_transm, only the branch (rz, transmission)
// selects: rz >= 0.5 specular, 2 rz < transmission refracted, else diffuse
__device__ void sample_transm(V3 v, V3 n, V3 base, float metallic,
                              float roughness, float transmission, float ior,
                              float rx, float ry, float rz, V3* l_out,
                              V3* f_out) {
  if (rz >= 0.5f) {
    V3 h = ggx_half_dir(n, roughness, rx, ry);
    V3 l = reflect(v, h);
    float no_v = clamp01(dot(n, v));
    float no_h = clamp01(dot(n, h));
    float vo_h = clamp01(dot(v, h));
    float g = g_pbrt(v, l, n, roughness);
    V3 f = f_schlick(vo_h, metallic, base);
    *l_out = l;
    *f_out = scale(scale(f, spec_scalar(g, vo_h, no_h, no_v)), 2.0f);
  } else if (2.0f * rz < transmission) {
    bool back = dot(v, n) < 0.0f;
    V3 fwd = back ? neg(n) : n;
    float eta = back ? 1.0f / ior : ior;
    V3 h = ggx_half_dir(fwd, roughness, rx, ry);
    V3 l = refract(v, h, eta);
    float no_v = clamp01(dot(fwd, v));
    float no_h = clamp01(dot(fwd, h));
    float vo_h = clamp01(dot(v, h));
    V3 f = f_schlick(vo_h, metallic, base);
    float g = g_pbrt(v, neg(l), fwd, roughness);
    float s = spec_scalar(g, vo_h, no_h, no_v);
    *l_out = l;
    *f_out = v3(base.x * (1.0f - f.x) * s * 2.0f, base.y * (1.0f - f.y) * s * 2.0f,
                base.z * (1.0f - f.z) * s * 2.0f);
  } else {
    V3 l = polar_dir(n, acosf(sqrtf(ry)), rx);
    V3 h = normalize(add(v, l));
    V3 f = f_schlick(clamp01(dot(v, h)), metallic, base);
    float om = 1.0f - metallic;
    *l_out = l;
    *f_out = v3((1.0f - f.x) * om * base.x * 2.0f, (1.0f - f.y) * om * base.y * 2.0f,
                (1.0f - f.z) * om * base.z * 2.0f);
  }
}

// rmath.pcg3d_words (math.cl:10-23), uint32 wrap-around arithmetic
__device__ __forceinline__ void pcg3d(uint32_t& x, uint32_t& y, uint32_t& z) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  z = z * 1664525u + 1013904223u;
  x += y * z;
  y += z * x;
  z += x * y;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  x += y * z;
  y += z * x;
  z += x * y;
}

// ---------------------------------------------------------------------------
// ops/texture.sample_image_array
// ---------------------------------------------------------------------------

struct Tex {
  const unsigned char* p;
  int t, h, w, c, addressing, filter;
};

// texture._address: the texel index of an unnormalized coordinate; *ok is
// false only for CLAMP (border) reads out of range
__device__ __forceinline__ int address(float coord, int size, int mode,
                                       bool* ok) {
  float size_f = static_cast<float>(size);
  *ok = true;
  if (mode == kRepeat) {
    coord = coord - floorf(coord * (1.0f / size_f)) * size_f;
  } else if (mode == kMirroredRepeat) {
    float period = 2.0f * size_f;
    float m = coord - floorf(coord * (1.0f / period)) * period;
    coord = m >= size_f ? period - m - 1.0f : m;
  } else if (mode == kClampBorder) {
    *ok = coord >= 0.0f && coord < size_f;
  } else {
    coord = clamp(coord, 0.0f, size_f - 1.0f);
  }
  int i = static_cast<int>(coord);
  if (mode == kClampToEdge) return i;
  return i < 0 ? 0 : (i > size - 1 ? size - 1 : i);
}

__device__ __forceinline__ float texel(const Tex& tx, int layer, int y, int x,
                                       int ch) {
  long long at = ((static_cast<long long>(layer) * tx.h + y) * tx.w + x)
                 * tx.c + ch;
  return static_cast<float>(tx.p[at]);
}

// sample_image_array(tex, u, v, idx) channels 0..2 in [0, 255]
__device__ V3 sample_tex(const Tex& tx, float u, float v, int idx) {
  int layer = idx < 0 ? 0 : (idx > tx.t - 1 ? tx.t - 1 : idx);
  if (tx.filter == kNearest) {
    bool okx, oky;
    int xi = address(u * static_cast<float>(tx.w), tx.w, tx.addressing, &okx);
    int yi = address(v * static_cast<float>(tx.h), tx.h, tx.addressing, &oky);
    bool ok = okx && oky;
    return v3(ok ? texel(tx, layer, yi, xi, 0) : 0.0f,
              ok ? texel(tx, layer, yi, xi, 1) : 0.0f,
              ok ? texel(tx, layer, yi, xi, 2) : 0.0f);
  }
  float x = u * static_cast<float>(tx.w) - 0.5f;
  float y = v * static_cast<float>(tx.h) - 0.5f;
  float x0f = floorf(x), y0f = floorf(y);
  float fx = x - x0f, fy = y - y0f;
  V3 out = v3(0.0f, 0.0f, 0.0f);
  for (int dy = 0; dy < 2; ++dy) {
    for (int dx = 0; dx < 2; ++dx) {
      bool okx, oky;
      int xi = address(x0f + static_cast<float>(dx), tx.w, tx.addressing, &okx);
      int yi = address(y0f + static_cast<float>(dy), tx.h, tx.addressing, &oky);
      bool ok = okx && oky;
      float wgt = (dx ? fx : (1.0f - fx)) * (dy ? fy : (1.0f - fy));
      V3 t = v3(ok ? texel(tx, layer, yi, xi, 0) : 0.0f,
                ok ? texel(tx, layer, yi, xi, 1) : 0.0f,
                ok ? texel(tx, layer, yi, xi, 2) : 0.0f);
      out = add(out, scale(t, wgt));
    }
  }
  return out;
}

}  // namespace

// The prep kernel's inputs and outputs; the wrapper fills it
// (shading/material_cuda.py's PrepArgs, field for field).
struct MaterialPrepArgs {
  // the wave: hit record, rays, alive
  const float* t;
  const int* prim;
  const int* slot;
  const float* b1;
  const float* b2;
  const float* o;
  const float* d;
  const unsigned char* alive;
  // instances (DeviceScene): [n_inst, 4, 4] f32 x 2, [n_inst] i32
  const float* inst_inv;
  const float* inst_tf;
  const int* inst_id;
  // meshes: [n_mesh] i32 tables, flat index / normal / uv data
  const int* mesh_io;
  const int* mesh_no;
  const int* mesh_uo;
  const int* mesh_mat;
  const int* index_data;
  const float* normal_data;
  const float* uv_data;
  // materials: [n_mat, albedo_w] albedo, [n_mat] tables
  const float* mat_albedo;
  const float* mat_metallic;
  const float* mat_roughness;
  const float* mat_transmission;
  const float* mat_ior;
  const int* albedo_tex;
  const int* metallic_tex;
  const int* roughness_tex;
  const int* normal_tex;
  // textures [tex_t, tex_h, tex_w, tex_c] u8, or null
  const unsigned char* tex;
  // outputs
  float* hit_pos;
  float* rec;
  long long n;
  long long n_index;
  long long n_normal;
  long long n_uv;
  int n_inst;
  int n_mesh;
  int n_mat;
  int albedo_w;
  int tex_t;
  int tex_h;
  int tex_w;
  int tex_c;
  int addressing;
  int filter;
};

namespace {

__global__ void __launch_bounds__(kThreads)
material_prep_kernel(const MaterialPrepArgs a) {
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  float t = a.t[i];
  if (!(a.alive[i] && t < kFltMax)) {
    store3(a.hit_pos, i, v3(0.0f, 0.0f, 0.0f));
    return;
  }
  // the instance row (_make_context): slot clamped into range, row 0 of a
  // one-instance scene
  int s = a.slot[i];
  s = s < 0 ? 0 : (s > a.n_inst - 1 ? a.n_inst - 1 : s);
  const float* inv = a.inst_inv + 16 * s;
  const float* tf = a.inst_tf + 16 * s;
  V3 o = load3(a.o, i), d = load3(a.d, i);
  V3 hp = add(xform_point(inv, o), scale(xform_dir(inv, d), t));
  float b1 = a.b1[i], b2 = a.b2[i];
  float w0 = 1.0f - b1 - b2;

  // context.get_indices / _fetch3, every index clamped into its table
  long long mesh = clampll(a.inst_id[s], 0, a.n_mesh - 1);
  long long base = static_cast<long long>(a.mesh_io[mesh])
                   + 3LL * a.prim[i];
  long long idx[3];
  for (int k = 0; k < 3; ++k) {
    idx[k] = a.index_data[clampll(base + k, 0, a.n_index - 1)];
  }
  long long no = a.mesh_no[mesh];
  V3 nv[3];
  for (int k = 0; k < 3; ++k) {
    long long at = no + 3 * idx[k];
    nv[k] = v3(a.normal_data[clampll(at, 0, a.n_normal - 1)],
               a.normal_data[clampll(at + 1, 0, a.n_normal - 1)],
               a.normal_data[clampll(at + 2, 0, a.n_normal - 1)]);
  }
  V3 normal = v3(sum3_strided(nv[0].x * w0, nv[1].x * b1, nv[2].x * b2),
                 sum3_strided(nv[0].y * w0, nv[1].y * b1, nv[2].y * b2),
                 sum3_strided(nv[0].z * w0, nv[1].z * b1, nv[2].z * b2));
  V3 face_n = normalize(xform_dir(tf, normal));
  V3 world = xform_point(tf, hp);
  store3(a.hit_pos, i, add(world, scale(face_n, 1e-5f)));

  long long mat = clampll(a.mesh_mat[mesh], 0, a.n_mat - 1);
  float metallic = a.mat_metallic[mat];
  float roughness = clamp(a.mat_roughness[mat], 0.0f, 1.0f);
  float transmission = clamp(a.mat_transmission[mat], 0.0f, 1.0f);
  float ior = clamp(a.mat_ior[mat], 0.0f, 10.0f);
  const float* alb = a.mat_albedo + a.albedo_w * mat;
  V3 albedo = v3(alb[0], alb[1], alb[2]);
  V3 nrm = face_n;
  if (a.tex != nullptr) {
    long long uo = a.mesh_uo[mesh];
    float uvx[3], uvy[3];
    for (int k = 0; k < 3; ++k) {
      long long at = uo + 3 * idx[k];
      uvx[k] = a.uv_data[clampll(at, 0, a.n_uv - 1)];
      uvy[k] = a.uv_data[clampll(at + 1, 0, a.n_uv - 1)];
    }
    float u = sum3_strided(uvx[0] * w0, uvx[1] * b1, uvx[2] * b2);
    float v = 1.0f - sum3_strided(uvy[0] * w0, uvy[1] * b1, uvy[2] * b2);
    Tex tx = {a.tex, a.tex_t, a.tex_h, a.tex_w, a.tex_c, a.addressing,
              a.filter};
    int nt = a.normal_tex[mat];
    if (nt != -1) {   // get_mat_normal
      V3 c = sample_tex(tx, u, v, nt);
      V3 local = normalize(v3(clamp01(c.x * kInv255) * 2.0f - 1.0f,
                              clamp01(c.y * kInv255) * 2.0f - 1.0f,
                              clamp01(c.z * kInv255) * 2.0f - 1.0f));
      nrm = normalize(transform_local_dir(face_n, local));
    }
    int mt = a.metallic_tex[mat], rt = a.roughness_tex[mat];
    if (mt != -1) {   // glTF metallicRoughness: metallic = B
      metallic = clamp01(sample_tex(tx, u, v, mt).z * kInv255);
    }
    if (rt != -1) {   // roughness = G
      roughness = clamp(sample_tex(tx, u, v, rt).y * kInv255, 0.05f, 1.0f);
    }
    int at = a.albedo_tex[mat];
    if (at != -1) {
      V3 c = sample_tex(tx, u, v, at);
      albedo = v3(clamp01(c.x * kInv255), clamp01(c.y * kInv255),
                  clamp01(c.z * kInv255));
    }
  }
  float4* r = reinterpret_cast<float4*>(a.rec) + 4 * i;
  r[0] = make_float4(world.x, world.y, world.z, metallic);
  r[1] = make_float4(face_n.x, face_n.y, face_n.z, roughness);
  r[2] = make_float4(nrm.x, nrm.y, nrm.z, transmission);
  r[3] = make_float4(albedo.x, albedo.y, albedo.z, ior);
}

__global__ void __launch_bounds__(kThreads)
material_finish_kernel(long long n, const float* __restrict__ hit_t,
                       const unsigned char* __restrict__ occluded,
                       const float* __restrict__ rec,
                       const float* __restrict__ o,
                       const float* __restrict__ d,
                       const long long* __restrict__ pixel,
                       const float* __restrict__ light_l,
                       const float* __restrict__ light_rgb,
                       unsigned int frame, unsigned int depth,
                       float* color, float* contribution,
                       unsigned char* alive, float* next_o, float* next_d) {
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  V3 c = load3(color, i);
  V3 ray_d = load3(d, i);
  bool live = alive[i];
  if (!(live && hit_t[i] < kFltMax)) {
    // a miss adds 0 and keeps its throughput; a live miss at depth 0
    // paints the environment (shader.cl:550-557); the path ends
    c = v3(c.x + 0.0f, c.y + 0.0f, c.z + 0.0f);
    if (live && depth == 0) c = v3(0.2f, 0.2f, 0.5f);
    store3(color, i, c);
    alive[i] = 0;
    store3(next_o, i, load3(o, i));
    store3(next_d, i, ray_d);
    return;
  }
  const float4* r = reinterpret_cast<const float4*>(rec) + 4 * i;
  float4 r0 = r[0], r1 = r[1], r2 = r[2], r3 = r[3];
  V3 world = v3(r0.x, r0.y, r0.z), face_n = v3(r1.x, r1.y, r1.z);
  V3 nrm = v3(r2.x, r2.y, r2.z), albedo = v3(r3.x, r3.y, r3.z);
  float metallic = r0.w, roughness = r1.w, transmission = r2.w, ior = r3.w;
  V3 v = normalize(neg(ray_d));
  V3 l = v3(light_l[0], light_l[1], light_l[2]);

  // direct light (shader.cl:502-512)
  V3 direct = mul(microfacet_brdf(l, v, nrm, albedo, metallic, roughness,
                                  transmission),
                  v3(light_rgb[0], light_rgb[1], light_rgb[2]));
  V3 mc = occluded[i] ? v3(0.0f, 0.0f, 0.0f) : direct;
  mc = add(mc, scale(albedo, 0.1f));

  // global illumination (shader.cl:518-531)
  uint32_t wx = frame, wy = static_cast<uint32_t>(pixel[i]), wz = depth;
  pcg3d(wx, wy, wz);
  const float inv32 = 1.0f / 4294967296.0f;
  float rx = static_cast<float>(wx) * inv32;
  float ry = static_cast<float>(wy) * inv32;
  float rz = static_cast<float>(wz) * inv32;
  V3 nd, factor;
  sample_transm(v, nrm, albedo, metallic, roughness, transmission, ior, rx,
                ry, rz, &nd, &factor);
  bool below = dot(nd, nrm) < 0.0f;
  V3 no = below ? add(world, scale(neg(face_n), 1e-5f))
                : add(world, scale(face_n, 1e-5f));

  // accumulation (shader.cl:238-252)
  V3 k = load3(contribution, i);
  store3(color, i, add(c, mul(k, mc)));
  store3(contribution, i, mul(k, factor));
  store3(next_o, i, no);
  store3(next_d, i, nd);
}

inline unsigned blocks(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() of the launch.
int rt_material_prep(const MaterialPrepArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  material_prep_kernel<<<blocks(args->n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// hit_t [n] f32, occluded [n] bool bytes, rec [n, 16] f32, o, d [n, 3] f32,
// pixel [n] i64, light_l, light_rgb [3] f32; color, contribution [n, 3] f32
// and alive [n] bool bytes updated in place; next_o, next_d [n, 3] f32
// written.  Returns cudaGetLastError().
int rt_material_finish(long long n, const float* hit_t,
                       const unsigned char* occluded, const float* rec,
                       const float* o, const float* d, const long long* pixel,
                       const float* light_l, const float* light_rgb,
                       unsigned int frame, unsigned int depth, float* color,
                       float* contribution, unsigned char* alive,
                       float* next_o, float* next_d, void* stream) {
  if (n <= 0) return 0;
  material_finish_kernel<<<blocks(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      n, hit_t, occluded, rec, o, d, pixel, light_l, light_rgb, frame, depth,
      color, contribution, alive, next_o, next_d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
