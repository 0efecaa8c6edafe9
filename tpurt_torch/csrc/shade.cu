// S1, the staged loop's shade of one wave in one pass: resolve, emission,
// NEE setup, BRDF, bounce sampling and the per-pixel hash. It replaces no
// TPU kernel: the reference leaves its shading (tpurt/render/staged.py
// _shade, tpurt/materials) to XLA, which fuses the jnp code on the TPU.
// On the card PyTorch runs the same code unfused, every material family
// for every ray, each step an (N,) or (N, 3) temporary in device memory,
// and each 32-bit hash as some fifteen int64 passes (core/prng.py). Its
// plain version is StagedRenderer._shade (tpurt_torch/render/staged.py),
// which the wrapper (tpurt_torch/kernels/shade.py) leaves to the CPU and
// to the paths this kernel does not take.
//
// One thread a ray, 256 a block. A thread reads its ray's state and hit,
// gathers its 32-float shade record (PairAccel.shade_rows, 128 B, the
// bunny's 10.5 MB table stays in L2) and, where the scene has textures,
// its nearest texel; it hashes its own random stream in registers
// (pcg_hash of seed, sample0 + sample and pix, then one hash a draw, the
// tags of core/prng.py); it evaluates only its own material family; and
// it writes the next wave and the shadow ray. Nothing else touches device
// memory. The wave's live count is added to its counter slot (f64) with
// one atomicAdd a block after __syncthreads_count: whole numbers, so the
// sum does not depend on the order.
//
// The two-level accel (PairAccelTL) is the kernel's other instantiation
// (kTwoLevel), chosen at launch by whether an instance table is given;
// the flat one is the code without it. Its records are object space and
// shared by a mesh's instances: a thread also reads its hit's instance id
// and that instance's 96 B row of the (I, 24) table (atrium's 126 rows
// stay in L1/L2), takes the normals through the row's normal matrix (the
// geometric one times its det sign) and, where the row overrides the
// material, its kind, albedo, emission and parameters with no texture, as
// materials.resolve_hit_packed_tl does.
//
// What bounds it on this card: bytes. About 83 B in and 91 B out a ray
// (state, hit, the next wave, the shadow tuple), and a few hundred f32
// operations a hit: a 3.84M-ray bunny wave is ~0.67 GB, ~0.2 ms at 3.35
// TB/s, against ~0.06 ms of arithmetic at 33.5e12 f32/s.
//
// Numerics follow _shade on the card op for op, in f32: the same sums in
// the same order, IEEE sqrtf, division, sinf, cosf and powf, no
// contraction (-fmad=false), and PyTorch's own forms where they differ
// from the formula: a dot product's three terms summed as its CUDA
// reduction sums them ((x + z) + y), a tensor divided by a Python number
// as a product with its reciprocal (x / pi is x * (1 / pi)), a number
// divided by a tensor as the tensor's reciprocal times the number, x ** 2
// as x * x, and a max over three channels propagating NaN. The random
// bits are PixelSampler's. On the made-up waves of
// tests/test_torch_shade.py every output came out bit-equal to the plain
// version's on an H100; what the plain version computes densely and then
// discards (another family's sample, a miss's resolve, NEE on a delta
// surface, whose contribution is 0) is not computed here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kShadeLanes = 32;  // floats a shade record (bvh.paircluster)
constexpr int kLightLanes = 16;  // floats a light row (kernels/shade.py)
constexpr int kInstLanes = 24;   // floats an instance row (bvh.paircluster)

// material kinds (scene/types.py)
constexpr int kLambert = 0;
constexpr int kBlinnPhong = 1;
constexpr int kMirror = 2;
constexpr int kDielectric = 3;

// draw-site tags (core/prng.py): bounce b draws tag 8 + 8 b + site
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kBounceBase = 8;
constexpr int kBounceStride = 8;
constexpr int kSiteLightPick = 0;
constexpr int kSiteLightBary = 1;  // 2 tags
constexpr int kSiteDiffuse = 3;    // 2 tags
constexpr int kSiteSphere = 5;     // 2 tags
constexpr int kSiteFresnel = 7;

// Python's float constants as torch rounds them to f32
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  return V3{x, y, z};
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 operator*(float s, V3 a) {
  return v3(s * a.x, s * a.y, s * a.z);
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

// vecmath.dot: (a * b).sum(-1) as PyTorch's CUDA reduction sums three
// terms: two threads an output, the first adding x and z, then y
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return (a.x * b.x + a.z * b.z) + a.y * b.y;
}

// vecmath.normalize: v * reciprocal(sqrt(clamp_min(dot(v, v), 1e-20)))
__device__ __forceinline__ V3 normalize(V3 v) {
  return v * (1.0f / sqrtf(fmaxf(dot(v, v), 1e-20f)));
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}

// vecmath.reflect: d - 2 dot(d, n) n
__device__ __forceinline__ V3 reflect(V3 d, V3 n) {
  return d - (2.0f * dot(d, n)) * n;
}

// amax(dim=-1) > t, NaN propagating as torch's amax does
__device__ __forceinline__ bool max_gt(V3 a, float t) {
  if (isnan(a.x) || isnan(a.y) || isnan(a.z)) return false;
  return a.x > t || a.y > t || a.z > t;
}

__device__ __forceinline__ V3 load3(const float* __restrict__ p, long i) {
  return v3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}
__device__ __forceinline__ void store3(float* __restrict__ p, long i, V3 a) {
  p[3 * i] = a.x;
  p[3 * i + 1] = a.y;
  p[3 * i + 2] = a.z;
}

// core/prng.py: pcg_hash (lowbias32) and u01 (top 24 bits)
__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ float u01(uint32_t base, int bounce, int site) {
  const uint32_t tag = static_cast<uint32_t>(kBounceBase +
                                             bounce * kBounceStride + site);
  return static_cast<float>(pcg_hash(base + tag * kGolden) >> 8) *
         (1.0f / 16777216.0f);
}

// materials.eval_brdf for (wo, wi) about the shading normal n: Lambert,
// Blinn-Phong, 0 for every other family
__device__ __forceinline__ V3 eval_brdf(int kind, V3 albedo, float p0,
                                        float p1, V3 n, V3 wo, V3 wi) {
  if ((kind != kLambert && kind != kBlinnPhong) || !(dot(n, wi) > 0.0f) ||
      !(dot(n, wo) > 0.0f))
    return v3(0.0f, 0.0f, 0.0f);
  const V3 diffuse = albedo * (1.0f / kPi);
  if (kind == kLambert) return diffuse;
  const V3 h = normalize(wo + wi);
  const float shin = fmaxf(p0, 1.0f);
  const float spec_norm = (shin + 2.0f) * (1.0f / kTwoPi);
  const float ndh = fmaxf(dot(n, h), 0.0f);
  const float spec = p1 * spec_norm * powf(ndh, shin);
  return v3(diffuse.x + spec, diffuse.y + spec, diffuse.z + spec);
}

// materials._mat3_vec: the row-major 3x3 in the floats m[0..8] times x,
// each row summed left to right
__device__ __forceinline__ V3 mat3_vec(const float* m, V3 x) {
  return v3((m[0] * x.x + m[1] * x.y) + m[2] * x.z,
            (m[3] * x.x + m[4] * x.y) + m[5] * x.z,
            (m[6] * x.x + m[7] * x.y) + m[8] * x.z);
}

template <bool kTwoLevel>
__global__ void __launch_bounds__(kThreads)
shade_kernel(const float* __restrict__ org, const float* __restrict__ dirn,
             const float* __restrict__ radiance,
             const float* __restrict__ throughput,
             const uint8_t* __restrict__ alive,
             const uint8_t* __restrict__ allow_emission,
             const int64_t* __restrict__ pix,
             const int64_t* __restrict__ sample,
             const float* __restrict__ hit_t, const float* __restrict__ hit_u,
             const float* __restrict__ hit_v,
             const int32_t* __restrict__ hit_slot,
             const uint8_t* __restrict__ hit_valid,
             const float* __restrict__ shade_rows, int n_slots,
             const float* __restrict__ lights, int num_lights,
             const float* __restrict__ tex_data,
             const float* __restrict__ tex_meta, int n_tex, float bg_r,
             float bg_g, float bg_b, const int64_t* __restrict__ seed,
             const int64_t* __restrict__ sample0,
             const int64_t* __restrict__ base_in, int bounce, int last,
             int use_nee, float eps_ray, float shadow_scale, long n,
             float* __restrict__ org_out, float* __restrict__ dirn_out,
             float* __restrict__ radiance_out,
             float* __restrict__ throughput_out,
             uint8_t* __restrict__ alive_out,
             uint8_t* __restrict__ allow_out, float* __restrict__ s_org,
             float* __restrict__ s_dir, float* __restrict__ s_tmax,
             float* __restrict__ s_contrib, uint8_t* __restrict__ s_want,
             double* __restrict__ live_count,
             const int32_t* __restrict__ hit_inst,
             const float* __restrict__ inst_table, int n_inst) {
  const long i = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  bool next_alive = false;
  if (i < n) {
    const bool ray_alive = alive[i] != 0;
    const bool valid = hit_valid[i] != 0;
    const bool hv = valid && ray_alive;
    const V3 thr = load3(throughput, i);
    V3 rad = load3(radiance, i);
    rad = rad + sel(ray_alive && !valid, thr * v3(bg_r, bg_g, bg_b),
                    v3(0.0f, 0.0f, 0.0f));

    // the record's row: the plain version resolves every ray at
    // clamp_min(slot, 0), so a miss's kind still sets allow_emission
    int slot = hit_slot[i];
    slot = slot < 0 ? 0 : (slot >= n_slots ? n_slots - 1 : slot);
    const float4* row =
        reinterpret_cast<const float4*>(shade_rows) +
        static_cast<long>(slot) * (kShadeLanes / 4);
    const float4 r3 = __ldg(row + 3);  // kind, albedo
    int kind = static_cast<int>(r3.x);
    // the hit's instance row, at clamp(inst, 0, I - 1) as the plain
    // version resolves every ray: a miss's kind is instance 0's override
    const float4* irow = nullptr;
    bool over = false;
    if constexpr (kTwoLevel) {
      int inst = hit_inst[i];
      inst = inst < 0 ? 0 : (inst >= n_inst ? n_inst - 1 : inst);
      irow = reinterpret_cast<const float4*>(inst_table) +
             static_cast<long>(inst) * (kInstLanes / 4);
      const float4 i2 = __ldg(irow + 2);  // m22, det sign, override, kind
      over = i2.z > 0.5f;
      if (over) kind = static_cast<int>(i2.w);
    }
    const bool is_mirror = kind == kMirror;
    const bool is_diel = kind == kDielectric;
    const bool specular = is_mirror || is_diel;

    V3 new_org = v3(0.0f, 0.0f, 0.0f), new_dir = v3(1.0f, 1.0f, 1.0f);
    V3 new_thr = thr;
    V3 sh_org = v3(0.0f, 0.0f, 0.0f), sh_dir = v3(1.0f, 1.0f, 1.0f);
    V3 contrib = v3(0.0f, 0.0f, 0.0f);
    float sh_tmax = -1.0f;
    bool want = false;

    if (hv) {
      // --- resolve (materials.resolve_hit_packed, _tl) --------------------
      const float4 r0 = __ldg(row + 0), r1 = __ldg(row + 1),
                   r2 = __ldg(row + 2), r4 = __ldg(row + 4),
                   r5 = __ldg(row + 5);
      const float t = hit_t[i], u = hit_u[i], v = hit_v[i];
      const float w = 1.0f - u - v;
      // the flat instantiation's statements keep this order: moving them
      // changes its instructions and registers (cuobjdump -sass)
      V3 n_geom, n_shade;
      if constexpr (kTwoLevel) {  // object space to world
        const float4 i0 = __ldg(irow), i1 = __ldg(irow + 1),
                     i2 = __ldg(irow + 2);
        const float m[9] = {i0.x, i0.y, i0.z, i0.w, i1.x,
                            i1.y, i1.z, i1.w, i2.x};
        n_geom = normalize(mat3_vec(m, v3(r0.x, r0.y, r0.z)) * i2.y);
        const V3 sn0 = v3(r0.w, r1.x, r1.y), sn1 = v3(r1.z, r1.w, r2.x),
                 sn2 = v3(r2.y, r2.z, r2.w);
        n_shade = normalize(mat3_vec(m, (w * sn0 + u * sn1) + v * sn2));
      } else {
        n_geom = normalize(v3(r0.x, r0.y, r0.z));
        const V3 sn0 = v3(r0.w, r1.x, r1.y), sn1 = v3(r1.z, r1.w, r2.x),
                 sn2 = v3(r2.y, r2.z, r2.w);
        n_shade = normalize((w * sn0 + u * sn1) + v * sn2);
      }
      const V3 o = load3(org, i), d = load3(dirn, i);
      const V3 pos = o + t * d;
      const bool front = dot(n_geom, d) < 0.0f;
      n_geom = sel(front, n_geom, -n_geom);
      n_shade = sel(dot(n_shade, n_geom) >= 0.0f, n_shade, -n_shade);
      V3 albedo = v3(r3.y, r3.z, r3.w);
      if constexpr (kTwoLevel) {  // the override's
        if (over) {
          const float4 i3 = __ldg(irow + 3);
          albedo = v3(i3.x, i3.y, i3.z);
        }
      }
      if (n_tex > 0) {  // nearest texel (materials.sample_base_color)
        const float4 r6 = __ldg(row + 6), r7 = __ldg(row + 7);
        const float tu = (w * r5.z + u * r6.x) + v * r6.z;
        const float tv = (w * r5.w + u * r6.y) + v * r6.w;
        int tex_id = static_cast<int>(r7.x);
        // an override carries no texture: the white fallback texel
        if constexpr (kTwoLevel) tex_id = over ? -1 : tex_id;
        const int tid = tex_id < 0 ? 0 : (tex_id >= n_tex ? n_tex - 1
                                                           : tex_id);
        const float4 meta = __ldg(reinterpret_cast<const float4*>(tex_meta) +
                                  tid);
        const int off = static_cast<int>(meta.x);
        const float wf = fmaxf(meta.y, 1.0f), hf = fmaxf(meta.z, 1.0f);
        const int wi = static_cast<int>(wf), hi = static_cast<int>(hf);
        const float fu = tu - floorf(tu), fv = tv - floorf(tv);
        const int tx = min(static_cast<int>(fu * wf), wi - 1);
        const int ty = min(static_cast<int>(fv * hf), hi - 1);
        const long idx = tex_id >= 0 ? static_cast<long>(off + ty * wi + tx)
                                     : 0L;
        albedo = albedo * load3(tex_data, idx);
      }
      V3 emission = v3(r4.x, r4.y, r4.z);
      float p0 = r4.w, p1 = r5.x;
      if constexpr (kTwoLevel) {
        if (over) {
          const float4 i3 = __ldg(irow + 3), i4 = __ldg(irow + 4);
          emission = v3(i3.w, i4.x, i4.y);
          p0 = i4.z;
          p1 = i4.w;
        }
      }
      rad = rad + sel(allow_emission[i] != 0, thr * emission,
                      v3(0.0f, 0.0f, 0.0f));

      // bounce_origin's scale-aware offset
      const float eps =
          eps_ray * fmaxf(fmaxf(fmaxf(fabsf(pos.x), fabsf(pos.y)),
                                fabsf(pos.z)), 1.0f);
      const V3 wo = -d;

      // --- the ray's stream (PixelSampler.make) ----------------------------
      uint32_t base;
      if (base_in != nullptr) {
        base = static_cast<uint32_t>(base_in[i]);
      } else {
        uint32_t s = pcg_hash(static_cast<uint32_t>(*seed));
        s = pcg_hash(s + static_cast<uint32_t>(*sample0 + sample[i]));
        base = pcg_hash(s + static_cast<uint32_t>(pix[i]) * kGolden);
      }

      // --- NEE (materials.sample_light; eval_brdf is 0 on delta families,
      // so no shadow ray is wanted there) ----------------------------------
      if (use_nee && !specular) {
        sh_org = pos + eps * n_geom;
        const int nl = num_lights > 1 ? num_lights : 1;
        const float u_pick = u01(base, bounce, kSiteLightPick);
        const int pick = min(static_cast<int>(u_pick * static_cast<float>(nl)),
                             nl - 1);
        const float ub0 = u01(base, bounce, kSiteLightBary);
        const float ub1 = u01(base, bounce, kSiteLightBary + 1);
        const float su = sqrtf(ub0);
        const float b0 = 1.0f - su;
        const float b1 = ub1 * su;
        const float b2 = 1.0f - b0 - b1;
        const float4* lrow = reinterpret_cast<const float4*>(lights) +
                             static_cast<long>(pick) * (kLightLanes / 4);
        const float4 l0 = __ldg(lrow), l1 = __ldg(lrow + 1),
                     l2 = __ldg(lrow + 2), l3 = __ldg(lrow + 3);
        const V3 lv0 = v3(l0.x, l0.y, l0.z), lv1 = v3(l0.w, l1.x, l1.y),
                 lv2 = v3(l1.z, l1.w, l2.x);
        const V3 l_emission = v3(l2.y, l2.z, l2.w);
        const float area = l3.x;
        const V3 lp = (b0 * lv0 + b1 * lv1) + b2 * lv2;
        const V3 ln = normalize(cross(lv1 - lv0, lv2 - lv0));
        const V3 to_light = lp - sh_org;
        const float dist2 = fmaxf(dot(to_light, to_light), 1e-12f);
        const float dist = sqrtf(dist2);
        const V3 wi_l = v3(to_light.x / dist, to_light.y / dist,
                           to_light.z / dist);
        const float cos_light = fabsf(dot(ln, wi_l));
        const float g = cos_light * area * static_cast<float>(nl) / dist2;
        const V3 l_over_pdf = l_emission * g;
        const bool l_valid = num_lights > 0 && area > 0.0f &&
                             cos_light > 1e-6f;
        const V3 brdf_l = eval_brdf(kind, albedo, p0, p1, n_shade, wo, wi_l);
        const float cos_s = fmaxf(dot(n_shade, wi_l), 0.0f);
        contrib = thr * brdf_l * cos_s * l_over_pdf;
        want = l_valid && max_gt(contrib, 0.0f);
        if (want) {
          sh_dir = wi_l;
          sh_tmax = dist * shadow_scale;
        } else {
          sh_org = v3(0.0f, 0.0f, 0.0f);
        }
      }

      // --- the bounce (materials.sample_bounce), the ray's family only ----
      V3 wi, weight;
      float offset_sign = 1.0f;
      if (is_mirror || is_diel) {
        const V3 refl = normalize(reflect(d, n_shade));
        if (is_mirror) {  // fuzz = param0
          const float us0 = u01(base, bounce, kSiteSphere);
          const float us1 = u01(base, bounce, kSiteSphere + 1);
          const float z = 1.0f - 2.0f * us0;  // sampling.uniform_sphere
          const float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
          const float phi = kTwoPi * us1;
          const V3 sph = v3(r * cosf(phi), r * sinf(phi), z);
          wi = normalize(refl + p0 * sph);
          weight = albedo * (dot(wi, n_geom) > 0.0f ? 1.0f : 0.0f);
        } else {  // ior = param0; Schlick's Fresnel picks the side
          const float u_fres = u01(base, bounce, kSiteFresnel);
          const float ior = fmaxf(p0, 1.0001f);
          const float eta = front ? 1.0f / ior : ior;
          const float cos_i = -dot(d, n_shade);
          const float cos_theta = fminf(fmaxf(cos_i, 0.0f), 1.0f);
          // vecmath.refract
          const float sin2_t = (eta * eta) *
                               fmaxf(1.0f - cos_i * cos_i, 0.0f);
          const bool tir = sin2_t > 1.0f;
          const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
          const V3 refr = normalize(eta * d + (eta * cos_i - cos_t) * n_shade);
          // vecmath.schlick_fresnel(cos_theta, 1, 1 / eta)
          const float ior_t = 1.0f / eta;
          const float q = (1.0f - ior_t) / (1.0f + ior_t);
          const float r0 = q * q;
          const float fresnel =
              r0 + (1.0f - r0) * powf(1.0f - fabsf(cos_theta), 5.0f);
          const bool reflect_choice = tir || u_fres < fresnel;
          wi = sel(reflect_choice, refl, refr);
          weight = albedo;
          offset_sign = reflect_choice ? 1.0f : -1.0f;
        }
      } else {  // cosine hemisphere about the shading normal
        const float ud0 = u01(base, bounce, kSiteDiffuse);
        const float ud1 = u01(base, bounce, kSiteDiffuse + 1);
        // vecmath.build_onb (Duff et al.)
        const float nx = n_shade.x, ny = n_shade.y, nz = n_shade.z;
        const float sign = nz >= 0.0f ? 1.0f : -1.0f;
        const float a = -(1.0f / (sign + nz));
        const float b = nx * ny * a;
        const V3 tb = v3(1.0f + sign * nx * nx * a, sign * b, -sign * nx);
        const V3 bb = v3(b, sign + ny * ny * a, -ny);
        // sampling.cosine_hemisphere and to_world
        const float r = sqrtf(ud0);
        const float phi = kTwoPi * ud1;
        const float x = r * cosf(phi), y = r * sinf(phi);
        const float z = sqrtf(fmaxf(1.0f - ud0, 0.0f));
        const float pdf = z * (1.0f / kPi);
        wi = (x * tb + y * bb) + z * n_shade;
        const V3 brdf = eval_brdf(kind, albedo, p0, p1, n_shade, wo, wi);
        const float cos_i = fmaxf(dot(n_shade, wi), 0.0f);
        weight = brdf * (cos_i / fmaxf(pdf, 1e-8f));
      }
      new_thr = thr * weight;
      next_alive = !last && max_gt(new_thr, 1e-6f);
      new_org = pos + (offset_sign * eps) * n_geom;
      new_dir = wi;
    }

    store3(org_out, i, new_org);
    store3(dirn_out, i, new_dir);
    store3(radiance_out, i, rad);
    store3(throughput_out, i, new_thr);
    alive_out[i] = next_alive;
    allow_out[i] = specular || !use_nee;
    if (use_nee) {
      store3(s_org, i, sh_org);
      store3(s_dir, i, sh_dir);
      s_tmax[i] = sh_tmax;
      store3(s_contrib, i, contrib);
      s_want[i] = want;
    }
  }
  const int live = __syncthreads_count(next_alive);
  if (threadIdx.x == 0 && live > 0)
    atomicAdd(live_count, static_cast<double>(live));
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
// The wave: org, dirn, radiance, throughput (n, 3) f32; alive,
// allow_emission (n,) u8; pix, sample (n,) i64. The hit: t, u, v (n,)
// f32, slot (n,) i32, valid (n,) u8. shade_rows (n_slots, 32) f32; lights
// (max(num_lights, 1), 16) f32; tex_data (P, 3) f32 and tex_meta (n_tex,
// 4) f32, n_tex 0 for an untextured scene. seed and sample0 one i64 each
// on the device; base (n,) i64 or null (then each ray's stream is hashed
// from seed, sample0 + sample and pix). last: the bounce is the path's
// last (no ray stays alive). The outputs as the inputs; the shadow tuple
// (s_org, s_dir (n, 3), s_tmax (n,), s_contrib (n, 3) f32, s_want (n,) u8)
// only with use_nee (else null); live_count one f64 the wave's live rays
// are added to. The two-level accel: hit_inst (n,) i32 and inst_table
// (n_inst, 24) f32 (the records then object space); both null on the
// flat accel, which launches the flat instantiation.
extern "C" int tpurt_shade(
    const float* org, const float* dirn, const float* radiance,
    const float* throughput, const uint8_t* alive,
    const uint8_t* allow_emission, const int64_t* pix, const int64_t* sample,
    const float* hit_t, const float* hit_u, const float* hit_v,
    const int32_t* hit_slot, const uint8_t* hit_valid,
    const float* shade_rows, int n_slots, const float* lights,
    int num_lights, const float* tex_data, const float* tex_meta, int n_tex,
    float bg_r, float bg_g, float bg_b, const int64_t* seed,
    const int64_t* sample0, const int64_t* base, int bounce, int last,
    int use_nee, float eps_ray, float shadow_scale, long n, float* org_out,
    float* dirn_out, float* radiance_out, float* throughput_out,
    uint8_t* alive_out, uint8_t* allow_out, float* s_org, float* s_dir,
    float* s_tmax, float* s_contrib, uint8_t* s_want, double* live_count,
    const int32_t* hit_inst, const float* inst_table, int n_inst,
    void* stream) {
  if (n <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  auto kernel = inst_table != nullptr ? shade_kernel<true>
                                      : shade_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      org, dirn, radiance, throughput, alive, allow_emission, pix, sample,
      hit_t, hit_u, hit_v, hit_slot, hit_valid, shade_rows, n_slots, lights,
      num_lights, tex_data, tex_meta, n_tex, bg_r, bg_g, bg_b, seed, sample0,
      base, bounce, last, use_nee, eps_ray, shadow_scale, n, org_out,
      dirn_out, radiance_out, throughput_out, alive_out, allow_out, s_org,
      s_dir, s_tmax, s_contrib, s_want, live_count, hit_inst, inst_table,
      n_inst);
  return static_cast<int>(cudaGetLastError());
}
