// Exact per-(tile, cluster) slab reduction: the Hopper port of two TPU
// kernels that share one body,
//   tpurt/kernels/tilewave.py::_exact_entry_kernel (K2, launcher
//     _exact_entries_pallas) — packs an entry word per (tile, cluster);
//   tpurt/kernels/tilewave.py::_exact_mask_kernel (K3, launcher
//     _exact_any_mask_pallas) — writes the hit-any mask and the minimum
//     entry distance unpacked, for the per-tile clamp of the budget path.
//
// For every (1024-ray tile, cluster) pair the body slab-tests each live ray
// of the tile against the cluster's AABB and keeps hit-any and the minimum
// slab-entry distance over the hitting rays. K2 then packs
//     clamp(trunc(max(tn_min, 0) / scale), 0, 32766) << 16 | cluster
// or INT32_MAX where no ray hits or the lane is padding (>= C); a per-row
// sort of that slab (done by the caller) gives each tile's front-to-back
// entry list for the traversal kernel (tileloop.cu). K3 writes the mask
// (u8 0/1) and tn_min (3.4e38 where no ray hits) at (tile, cluster), with
// no padding lanes in its output.
//
// What bounds it on this card: arithmetic. Each ray x cluster pair costs
// about 28 operations (per axis two sub, two mul, min, max and the two
// running min/max; then the hit test and the accumulation), and the wave
// is 3.84M rays x 854 clusters at the bunny bench size, against ~28 MB of
// ray data read once per 128-cluster chunk. The simple design: one block
// per (tile, 128-cluster chunk) with one thread per cluster lane, so each
// thread holds its box in registers and loops over the tile's rays, which
// are staged through shared memory in 256-ray chunks and read as
// broadcasts (every thread reads the same ray). Hit-any and min-tn live in
// registers; nothing is reduced across threads, so both kernels are
// bit-equal to their plain versions.
//
// Numerics match the reference op for op: t0 = (lo - o) * iv, tn starts at
// 0 and tf at max(tm, 0), tn = max(tn, min(t0, t1)), tf = min(tf,
// max(t0, t1)), hit = tn <= tf && tm >= 0. Built with -fmad=false (no
// contraction) and IEEE division, and the quantized distance is clamped in
// float before the cast, because a float->int cast out of range is
// undefined.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;   // rays per tile
constexpr int kLanes = 128;   // clusters per block (one per thread)
constexpr int kChunk = 256;   // rays staged through shared memory at once
constexpr float kBig = 3.4e38f;

// kPack: K2 (packed entry word into out_word, (n_tiles, cp)); else K3
// (mask into out_mask and tn_min into out_tn, both (n_tiles, n_clusters)).
template <bool kPack>
__global__ void __launch_bounds__(kLanes)
slab_kernel(const float* __restrict__ org, const float* __restrict__ inv_d,
            const float* __restrict__ tmax, const float* __restrict__ lo,
            const float* __restrict__ hi, int n_clusters, int cp,
            float scale, int32_t* __restrict__ out_word,
            uint8_t* __restrict__ out_mask, float* __restrict__ out_tn) {
  __shared__ float s_ray[7][kChunk];  // ox oy oz ivx ivy ivz tm

  const long tile = blockIdx.x;
  const int lane = blockIdx.y * kLanes + threadIdx.x;
  const bool real = lane < n_clusters;
  float lox = 0.f, loy = 0.f, loz = 0.f, hix = 0.f, hiy = 0.f, hiz = 0.f;
  if (real) {
    lox = lo[3 * lane + 0];
    loy = lo[3 * lane + 1];
    loz = lo[3 * lane + 2];
    hix = hi[3 * lane + 0];
    hiy = hi[3 * lane + 1];
    hiz = hi[3 * lane + 2];
  }

  bool any_hit = false;
  float tn_min = kBig;
  for (int base = 0; base < kTile; base += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    for (int k = threadIdx.x; k < kChunk; k += kLanes) {
      const long r = tile * kTile + base + k;
      s_ray[0][k] = org[3 * r + 0];
      s_ray[1][k] = org[3 * r + 1];
      s_ray[2][k] = org[3 * r + 2];
      s_ray[3][k] = inv_d[3 * r + 0];
      s_ray[4][k] = inv_d[3 * r + 1];
      s_ray[5][k] = inv_d[3 * r + 2];
      s_ray[6][k] = tmax[r];
    }
    __syncthreads();
    if (!real) continue;
    for (int k = 0; k < kChunk; ++k) {
      const float tm = s_ray[6][k];
      float tn = 0.f;
      float tf = fmaxf(tm, 0.f);
      float t0 = (lox - s_ray[0][k]) * s_ray[3][k];
      float t1 = (hix - s_ray[0][k]) * s_ray[3][k];
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
      t0 = (loy - s_ray[1][k]) * s_ray[4][k];
      t1 = (hiy - s_ray[1][k]) * s_ray[4][k];
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
      t0 = (loz - s_ray[2][k]) * s_ray[5][k];
      t1 = (hiz - s_ray[2][k]) * s_ray[5][k];
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
      if (tn <= tf && tm >= 0.f) {
        any_hit = true;
        tn_min = fminf(tn_min, tn);
      }
    }
  }

  if (kPack) {
    int32_t word = INT32_MAX;
    if (real && any_hit) {
      float q = fmaxf(tn_min, 0.f) / scale;
      q = fminf(fmaxf(q, 0.f), 32766.f);
      word = (static_cast<int32_t>(q) << 16) | lane;
    }
    out_word[tile * cp + lane] = word;
  } else if (real) {
    out_mask[tile * n_clusters + lane] = any_hit ? 1 : 0;
    out_tn[tile * n_clusters + lane] = tn_min;
  }
}

}  // namespace

// Both launch on ``stream`` and return cudaGetLastError() (0 = launched).
// org/inv_d: (n_tiles*1024, 3) f32, tmax: (n_tiles*1024,) f32,
// lo/hi: (n_clusters, 3) f32; cp is n_clusters rounded up to 128.

// K2. out: (n_tiles, cp) i32.
extern "C" int tpurt_entries(const float* org, const float* inv_d,
                             const float* tmax, const float* lo,
                             const float* hi, int n_tiles, int n_clusters,
                             int cp, float scale, int32_t* out,
                             void* stream) {
  if (n_tiles <= 0) return 0;
  const dim3 grid(n_tiles, cp / kLanes);
  slab_kernel<true><<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      org, inv_d, tmax, lo, hi, n_clusters, cp, scale, out, nullptr,
      nullptr);
  return static_cast<int>(cudaGetLastError());
}

// K3. mask: (n_tiles, n_clusters) u8 (0/1), tn: (n_tiles, n_clusters) f32.
extern "C" int tpurt_exact_mask(const float* org, const float* inv_d,
                                const float* tmax, const float* lo,
                                const float* hi, int n_tiles, int n_clusters,
                                int cp, uint8_t* mask, float* tn,
                                void* stream) {
  if (n_tiles <= 0) return 0;
  const dim3 grid(n_tiles, cp / kLanes);
  slab_kernel<false><<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      org, inv_d, tmax, lo, hi, n_clusters, cp, 1.f, nullptr, mask, tn);
  return static_cast<int>(cudaGetLastError());
}
