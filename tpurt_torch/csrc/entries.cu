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
// Only live rays are tested. A dead ray (tmax < 0, which the intersector
// gives the rays that left the batch and the shadow rays with nothing to
// test) can never hit, yet an uncapped or over-capped wave is full of
// them: its octant sort puts them last (a dead tail), the sorted-wave loop
// interleaves them. So each 256-ray chunk reads its tmax first (two rays
// a thread), compacts its live rays to the front of shared memory in ray
// order (a warp ballot, popc prefixes, the four warps' counts through
// shared memory) and reads origin and inverse direction for those alone;
// the loop runs over the chunk's live rays, padded with at most three
// dead ones to whole quads that it reads as 16-byte words (a loop to the
// bare count compiled to a second, remainder loop and cost an all-live
// wave 2.6% on an H100), and a chunk with none skips both. What bounds a block is thus
// its tile's live rays x 28 operations a lane, plus 4 KB of tmax a tile;
// a tile of dead rays reads its tmax, writes its empty words and exits.
// The output is unchanged bit for bit: a dead ray never passes the hit
// test, hit-any is an OR, and the live rays reach min-tn in the order
// they did.
//
// Lane block 0 of every tile adds the tile's 1024 ray slots and its live
// rays to a device counter per kernel (g_slab_rays), read and cleared by
// tpurt_slab_rays / tpurt_slab_rays_reset; a captured graph adds on each
// replay.
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
constexpr int kWarps = kLanes / 32;
constexpr int kPasses = kChunk / kLanes;  // rays of a chunk a thread reads
constexpr float kBig = 3.4e38f;

// {ray slots, live rays} of every tile launched on this device: K2 [0],
// K3 [1].
__device__ unsigned long long g_slab_rays[2][2];

// One ray against the lane's box (lo xyz, hi xyz) in the reference's op
// order; a hit sets hit-any and lowers min-tn.
__device__ __forceinline__ void slab_test(const float (&box)[6], float ox,
                                          float oy, float oz, float ivx,
                                          float ivy, float ivz, float tm,
                                          bool& any_hit, float& tn_min) {
  float tn = 0.f;
  float tf = fmaxf(tm, 0.f);
  float t0 = (box[0] - ox) * ivx;
  float t1 = (box[3] - ox) * ivx;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = (box[1] - oy) * ivy;
  t1 = (box[4] - oy) * ivy;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = (box[2] - oz) * ivz;
  t1 = (box[5] - oz) * ivz;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  if (tn <= tf && tm >= 0.f) {
    any_hit = true;
    tn_min = fminf(tn_min, tn);
  }
}

// kPack: K2 (packed entry word into out_word, (n_tiles, cp)); else K3
// (mask into out_mask and tn_min into out_tn, both (n_tiles, n_clusters)).
template <bool kPack>
__global__ void __launch_bounds__(kLanes)
slab_kernel(const float* __restrict__ org, const float* __restrict__ inv_d,
            const float* __restrict__ tmax, const float* __restrict__ lo,
            const float* __restrict__ hi, int n_clusters, int cp,
            float scale, int32_t* __restrict__ out_word,
            uint8_t* __restrict__ out_mask, float* __restrict__ out_tn) {
  // ox oy oz ivx ivy ivz tm of the chunk's live rays, in ray order
  __shared__ __align__(16) float s_ray[7][kChunk];
  // live rays a (pass, warp) of a chunk, two chunks apart: a thread that
  // finds its chunk empty goes on to count the next one while others
  // still read this one's
  __shared__ int s_live[2][kPasses * kWarps];

  const long tile = blockIdx.x;
  const int lane = blockIdx.y * kLanes + threadIdx.x;
  const bool real = lane < n_clusters;
  const int warp = threadIdx.x / 32;
  const unsigned below = (1u << (threadIdx.x % 32)) - 1u;
  float box[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // lo xyz, hi xyz
  if (real) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      box[a] = lo[3 * lane + a];
      box[3 + a] = hi[3 * lane + a];
    }
  }

  bool any_hit = false;
  float tn_min = kBig;
  int tile_live = 0;
  for (int c = 0; c < kTile / kChunk; ++c) {
    const long r0 = tile * kTile + c * kChunk;
    int* live_of = s_live[c & 1];
    float tms[kPasses];  // ray p * kLanes + threadIdx.x of the chunk
    unsigned ballot[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      tms[p] = tmax[r0 + p * kLanes + threadIdx.x];
      ballot[p] = __ballot_sync(0xffffffffu, tms[p] >= 0.f);
      if (threadIdx.x % 32 == 0)
        live_of[p * kWarps + warp] = __popc(ballot[p]);
    }
    __syncthreads();  // the counts are in; the previous chunk is consumed
    int n_live = 0, at[kPasses];
#pragma unroll
    for (int i = 0; i < kPasses * kWarps; ++i) {
      if (i % kWarps == warp) at[i / kWarps] = n_live;
      n_live += live_of[i];
    }
    tile_live += n_live;
    if (n_live == 0) continue;  // the same for every thread
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      if (!(tms[p] >= 0.f)) continue;
      const int k = at[p] + __popc(ballot[p] & below);
      const long r = r0 + p * kLanes + threadIdx.x;
      s_ray[0][k] = org[3 * r + 0];
      s_ray[1][k] = org[3 * r + 1];
      s_ray[2][k] = org[3 * r + 2];
      s_ray[3][k] = inv_d[3 * r + 0];
      s_ray[4][k] = inv_d[3 * r + 1];
      s_ray[5][k] = inv_d[3 * r + 2];
      s_ray[6][k] = tms[p];
    }
    // dead rays (tm -1, never a hit) pad the live ones to whole quads,
    // which the loop reads as 16-byte words
    const int n_quad = (n_live + 3) / 4;
    if (threadIdx.x < 4 * n_quad - n_live) {
      const int k = n_live + threadIdx.x;
#pragma unroll
      for (int i = 0; i < 6; ++i) s_ray[i][k] = 0.f;
      s_ray[6][k] = -1.f;
    }
    __syncthreads();
    if (!real) continue;
    for (int q = 0; q < 4 * n_quad; q += 4) {
      float4 v[7];
#pragma unroll
      for (int i = 0; i < 7; ++i)
        v[i] = *reinterpret_cast<const float4*>(&s_ray[i][q]);
      slab_test(box, v[0].x, v[1].x, v[2].x, v[3].x, v[4].x, v[5].x, v[6].x,
                any_hit, tn_min);
      slab_test(box, v[0].y, v[1].y, v[2].y, v[3].y, v[4].y, v[5].y, v[6].y,
                any_hit, tn_min);
      slab_test(box, v[0].z, v[1].z, v[2].z, v[3].z, v[4].z, v[5].z, v[6].z,
                any_hit, tn_min);
      slab_test(box, v[0].w, v[1].w, v[2].w, v[3].w, v[4].w, v[5].w, v[6].w,
                any_hit, tn_min);
    }
  }

  if (blockIdx.y == 0 && threadIdx.x == 0) {
    atomicAdd(&g_slab_rays[kPack ? 0 : 1][0],
              static_cast<unsigned long long>(kTile));
    atomicAdd(&g_slab_rays[kPack ? 0 : 1][1],
              static_cast<unsigned long long>(tile_live));
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

// The ray counters of the current device: out (4 u64) = {K2 slots, K2 live,
// K3 slots, K3 live}, read after the work queued on ``stream`` (a sync).
extern "C" int tpurt_slab_rays(unsigned long long* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyFromSymbolAsync(
      out, g_slab_rays, sizeof(g_slab_rays), 0, cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return static_cast<int>(err);
}

// Zero the current device's ray counters after the work queued on
// ``stream``, and wait for it.
extern "C" int tpurt_slab_rays_reset(void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* counts = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&counts, g_slab_rays);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(counts, 0, sizeof(g_slab_rays), s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return static_cast<int>(err);
}
