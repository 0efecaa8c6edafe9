// The tile intersector's ray coherence sort on the card: a bounce or
// shadow wave put in octant order (direction signs first, origin Morton
// second, dead rays last) and the traversal's outputs put back in the
// caller's order. It replaces no TPU kernel: the reference sorts with
// jnp (tpurt/kernels/tilewave.py _octant_sort_keys, jnp.argsort, takes),
// which XLA fuses on the TPU. On the card PyTorch ran the same code
// unfused: some 55 int64 passes over the wave to build the keys, an int64
// radix sort (8 passes), three gathers, and after the traversal the
// dead tail's concatenations and one scatter an output. Its plain version
// stays in tpurt_torch/kernels/raysort.py (the CPU path and the oracle).
//
// Three passes and a sort, one thread a ray, 256 a block:
//   - raysort_keys_kernel builds each ray's key in registers from its
//     origin, direction and tmax and the scene box, and writes it with the
//     ray's index; CUB's stable LSD radix sort then orders the keys' low
//     kKeyBits bits (three 8-bit digit passes) with the int32 indices,
//     giving the permutation (tpurt_raysort: both, one entry point);
//   - raygather_kernel writes the sorted org, dirn and tmax of the rays
//     the wave keeps (a live-capped wave keeps its first n_keep) and
//     counts the live rays (tmax >= 0) past the cut into one f32 (whole
//     numbers below 2^24, so the sum does not depend on the order);
//   - rayrestore_kernel writes each output back, r[perm[i]] = out[i], and
//     the dead-lane values (bt -1, bu bv 0, bs -1, bi -1) at the rays past
//     a truncated wave's cut.
//
// The key: on a live ray (tmax < 0 is false; NaN is live) octant << 18 |
// morton, the 18-bit Morton code of the origin quantized to 64 cells an
// axis of the scene box; on a dead ray kDeadKey, above every live key.
// That is _octant_sort_keys's value on every live ray, and its int64
// DEAD_KEY (0xFFFFFFFF) mapped to 1 << 21: a strictly monotone map that
// keeps ties, so the stable sort gives the same permutation. Its f32
// steps are torch's on the card: ext = clamp_min(hi - lo, 1e-12) (NaN
// stays NaN), (org - lo) / ext with IEEE division, clamp(., 0, 1) (NaN
// stays NaN), * 64, truncation to an integer (a NaN gives 0, as torch's
// cast does on the card; the CPU's INT64_MIN spreads to 0 bits too) and
// min(., 63); dirn >= 0 is true for -0.0 and false for NaN.
//
// What bounds it on this card: bytes. A 3.84M-ray wave moves about 28 B
// in and 8 B out a ray for the keys, 52 B for the sort (three passes of
// key and index, read and written, and a histogram pass), 60 B for the
// gather and 12-36 B for the restore: ~0.7 GB, ~0.2 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kDeadKey = 1u << 21;  // above every live key (21 bits)
constexpr int kKeyBits = 22;             // the bits the sort orders
constexpr int kFields = 5;               // bt, bu, bv, bs, bi

// spread the low 7 bits so there are 2 zero bits between each
// (kernels/packet.py _expand_bits7)
__device__ __forceinline__ uint32_t expand_bits7(uint32_t v) {
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

// torch.clamp_min(hi - lo, 1e-12): a NaN stays NaN
__device__ __forceinline__ float extent(float lo, float hi) {
  const float e = hi - lo;
  return e < 1e-12f ? 1e-12f : e;
}

// min(trunc(clamp((o - lo) / ext, 0, 1) * 64), 63), a NaN giving 0
__device__ __forceinline__ uint32_t cell64(float o, float lo, float ext) {
  float q = (o - lo) / ext;
  if (q != q) return 0u;
  q = q < 0.f ? 0.f : (q > 1.f ? 1.f : q);
  const int g = static_cast<int>(q * 64.f);
  return static_cast<uint32_t>(g < 63 ? g : 63);
}

__global__ void __launch_bounds__(kThreads)
raysort_keys_kernel(const float* __restrict__ org,
                    const float* __restrict__ dirn,
                    const float* __restrict__ tmax,
                    const float* __restrict__ lo,
                    const float* __restrict__ hi, int n,
                    uint32_t* __restrict__ keys,
                    int32_t* __restrict__ index) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t key = kDeadKey;
  if (!(tmax[i] < 0.f)) {  // dead rays read nothing more
    const long r = 3L * i;
    const uint32_t gx = cell64(org[r + 0], lo[0], extent(lo[0], hi[0]));
    const uint32_t gy = cell64(org[r + 1], lo[1], extent(lo[1], hi[1]));
    const uint32_t gz = cell64(org[r + 2], lo[2], extent(lo[2], hi[2]));
    const uint32_t octant = static_cast<uint32_t>(dirn[r + 0] >= 0.f) |
                            static_cast<uint32_t>(dirn[r + 1] >= 0.f) << 1 |
                            static_cast<uint32_t>(dirn[r + 2] >= 0.f) << 2;
    key = octant << 18 | expand_bits7(gx) << 2 | expand_bits7(gy) << 1 |
          expand_bits7(gz);
  }
  keys[i] = key;
  index[i] = i;
}

__global__ void __launch_bounds__(kThreads)
raygather_kernel(const int32_t* __restrict__ perm,
                 const float* __restrict__ org,
                 const float* __restrict__ dirn,
                 const float* __restrict__ tmax, int n, int n_keep,
                 float* __restrict__ org_out, float* __restrict__ dirn_out,
                 float* __restrict__ tmax_out, float* __restrict__ live_over) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int past = 0;  // a live ray past the cut
  if (i < n) {
    const long j = perm[i];
    if (i < n_keep) {
      const long r = 3L * i, s = 3L * j;
      org_out[r + 0] = org[s + 0];
      org_out[r + 1] = org[s + 1];
      org_out[r + 2] = org[s + 2];
      dirn_out[r + 0] = dirn[s + 0];
      dirn_out[r + 1] = dirn[s + 1];
      dirn_out[r + 2] = dirn[s + 2];
      tmax_out[i] = tmax[j];
    } else {
      past = tmax[j] >= 0.f;
    }
  }
  if (live_over == nullptr) return;  // uniform: the wave keeps every ray
  const int count = __syncthreads_count(past);
  if (threadIdx.x == 0 && count)
    atomicAdd(live_over, static_cast<float>(count));
}

struct Fields {
  const float* in[kFields];  // the kernel's outputs in sorted order
  float* out[kFields];       // nullptr: not restored
};

__global__ void __launch_bounds__(kThreads)
rayrestore_kernel(const int32_t* __restrict__ perm, int n, int n_keep,
                  Fields f) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long j = perm[i];
  const bool kept = i < n_keep;
  constexpr float kDead[kFields] = {-1.f, 0.f, 0.f, -1.f, -1.f};
#pragma unroll
  for (int k = 0; k < kFields; ++k)
    if (f.out[k] != nullptr) f.out[k][j] = kept ? f.in[k][i] : kDead[k];
}

unsigned blocks(int n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// The scratch bytes tpurt_raysort needs for n rays, into *bytes; returns
// the cudaError of CUB's query (0 = found).
extern "C" int tpurt_raysort_temp_bytes(int n, size_t* bytes) {
  *bytes = 0;
  return static_cast<int>(cub::DeviceRadixSort::SortPairs(
      nullptr, *bytes, static_cast<const uint32_t*>(nullptr),
      static_cast<uint32_t*>(nullptr), static_cast<const int32_t*>(nullptr),
      static_cast<int32_t*>(nullptr), n, 0, kKeyBits));
}

// Launch on ``stream``; returns the first cudaError (0 = launched).
// org/dirn: (n, 3) f32, tmax: (n,) f32, lo/hi: (3,) f32 the scene box;
// keys, keys_sorted: (n,) u32, index, perm: (n,) i32; temp: temp_bytes
// (tpurt_raysort_temp_bytes). perm gathers the wave into octant order.
extern "C" int tpurt_raysort(const float* org, const float* dirn,
                             const float* tmax, const float* lo,
                             const float* hi, int n, uint32_t* keys,
                             uint32_t* keys_sorted, int32_t* index,
                             int32_t* perm, void* temp, size_t temp_bytes,
                             void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  raysort_keys_kernel<<<blocks(n), kThreads, 0, s>>>(org, dirn, tmax, lo, hi,
                                                     n, keys, index);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cub::DeviceRadixSort::SortPairs(temp, temp_bytes, keys, keys_sorted,
                                        index, perm, n, 0, kKeyBits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
// perm: (n,) i32; org/dirn: (n, 3) f32, tmax: (n,) f32; org_out/dirn_out:
// (n_keep, 3) f32, tmax_out: (n_keep,) f32; live_over: one f32 that the
// live rays past n_keep are added to, or nullptr where n_keep == n.
extern "C" int tpurt_raygather(const int32_t* perm, const float* org,
                               const float* dirn, const float* tmax, int n,
                               int n_keep, float* org_out, float* dirn_out,
                               float* tmax_out, float* live_over,
                               void* stream) {
  const int span = live_over != nullptr ? n : n_keep;
  if (span <= 0) return 0;
  raygather_kernel<<<blocks(span), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      perm, org, dirn, tmax, n, n_keep, org_out, dirn_out, tmax_out,
      live_over);
  return static_cast<int>(cudaGetLastError());
}

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
// perm: (n,) i32; in0..in4: (n_keep,) f32 the outputs in sorted order,
// out0..out4: (n,) f32 in the caller's order; an output whose out is
// nullptr is not restored (its in is not read).
extern "C" int tpurt_rayrestore(const int32_t* perm, int n, int n_keep,
                                const float* in0, const float* in1,
                                const float* in2, const float* in3,
                                const float* in4, float* out0, float* out1,
                                float* out2, float* out3, float* out4,
                                void* stream) {
  if (n <= 0) return 0;
  const Fields f = {{in0, in1, in2, in3, in4},
                    {out0, out1, out2, out3, out4}};
  rayrestore_kernel<<<blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(perm, n, n_keep, f);
  return static_cast<int>(cudaGetLastError());
}
