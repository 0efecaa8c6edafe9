// Tile traversal loop: the Hopper port of the TPU kernel
// tpurt/kernels/tilewave.py::_tileloop_kernel (launcher
// _launch_tiles_loop) in its entry-row, flat (one-level) mode, closest-hit
// and lean any-hit variants.
//
// One block per 1024-ray tile, one thread per ray. The block walks the
// tile's front-to-back entry row ((tn_q << 16) | cluster, sorted by the
// caller, ``counts[tile]`` live entries). Per entry it copies the
// cluster's 8 x 128 f32 triangle rows (4 KB) into shared memory; each
// thread then runs the cluster box pre-test (lanes 126-127 of rows 0-2),
// the 8 row sub-box tests (lanes 120-125) and the 12 Moller-Trumbore tests
// of every surviving row against its own ray. Candidates fold with strict
// '<' in row, lane and entry order, so ties keep the earlier candidate,
// exactly as the reference's fold does. The lean any-hit variant runs the
// division-free window test of _row_occluded_smem and retires an occluded
// lane with bt = -1, bs = 0.
//
// Far break: the entry's quantized distance is a floor, so it lower-bounds
// the slab entry of every ray that can hit the cluster. Once every lane's
// best t (tmax for misses, -1 for dead or occluded lanes) is below it, no
// later entry can change any lane: __syncthreads_and ends the tile. A
// thread whose own best t is already below it skips the entry's work.
// Doing the box tests per thread instead of per tile only prunes more; it
// changes no result.
//
// What bounds it on this card: latency of the serial entry loop. Each
// entry is a dependent chain (barrier, 4 KB copy, barrier, box tests, up
// to 96 triangle tests) and the trip count varies per tile, so the block
// spends much of its time waiting on the copy and on its slowest warp.
// The simple design keeps 1024 threads per block (two blocks' worth of
// warps cannot share an SM at 64 registers/thread, so latency is hidden
// only across warps of one tile) and plain loads plus __syncthreads for
// the copy; double buffering with cp.async or TMA is later work.
//
// Built with -fmad=false and IEEE division (1/det), matching the
// reference's op order term for term.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;          // rays per tile = threads per block
constexpr int kRowsPerCluster = 8;
constexpr int kLanesPerRow = 128;
constexpr int kTrisPerRow = 12;
constexpr int kLanesPerTri = 10;
constexpr float kEpsDenom = 1e-12f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Slab interval of the box (lo, hi) far-limited by ``far`` — the order of
// tilewave._row_box_interval and the cluster pre-test.
__device__ __forceinline__ bool box_reachable(const Ray& r, float lox,
                                              float loy, float loz,
                                              float hix, float hiy,
                                              float hiz, float far) {
  const float t0x = (lox - r.ox) * r.ix;
  const float t1x = (hix - r.ox) * r.ix;
  const float t0y = (loy - r.oy) * r.iy;
  const float t1y = (hiy - r.oy) * r.iy;
  const float t0z = (loz - r.oz) * r.iz;
  const float t1z = (hiz - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fmaxf(fminf(t0z, t1z), 0.f));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fminf(fmaxf(t0z, t1z), far));
  return tn <= tf;
}

template <bool kLean>
__global__ void __launch_bounds__(kTile)
tileloop_kernel(const float* __restrict__ org,
                const float* __restrict__ dirn,
                const float* __restrict__ inv_d,
                const float* __restrict__ tmax,
                const float* __restrict__ tri_rows,
                const int32_t* __restrict__ entries,
                const int32_t* __restrict__ counts, int cp, float scale,
                float* __restrict__ bt_out, float* __restrict__ bu_out,
                float* __restrict__ bv_out, float* __restrict__ bs_out) {
  __shared__ float rows[kRowsPerCluster * kLanesPerRow];

  const long tile = blockIdx.x;
  const long ray = tile * kTile + threadIdx.x;
  Ray r;
  r.ox = org[3 * ray + 0];
  r.oy = org[3 * ray + 1];
  r.oz = org[3 * ray + 2];
  r.dx = dirn[3 * ray + 0];
  r.dy = dirn[3 * ray + 1];
  r.dz = dirn[3 * ray + 2];
  r.ix = inv_d[3 * ray + 0];
  r.iy = inv_d[3 * ray + 1];
  r.iz = inv_d[3 * ray + 2];
  const float tm = tmax[ray];
  float bt = tm >= 0.f ? tm : -1.f;
  float bu = 0.f, bv = 0.f, bs = -1.f;

  const int n = counts[tile];
  const int32_t* ent = entries + tile * cp;
  for (int p = 0; p < n; ++p) {
    const int32_t e = ent[p];
    const float deq = static_cast<float>(e >> 16) * scale;
    // far break (also the barrier before the shared rows are replaced)
    if (__syncthreads_and(bt < deq)) break;
    const int c = e & 0xFFFF;
    rows[threadIdx.x] =
        tri_rows[static_cast<long>(c) * kRowsPerCluster * kLanesPerRow +
                 threadIdx.x];
    __syncthreads();
    if (bt < deq) continue;
    // cluster box pre-test, far-limited by the current best t
    if (!box_reachable(r, rows[126], rows[127], rows[kLanesPerRow + 126],
                       rows[kLanesPerRow + 127],
                       rows[2 * kLanesPerRow + 126],
                       rows[2 * kLanesPerRow + 127], bt))
      continue;
    for (int rr = 0; rr < kRowsPerCluster; ++rr) {
      const float* row = rows + rr * kLanesPerRow;
      if (!box_reachable(r, row[120], row[121], row[122], row[123],
                         row[124], row[125], bt))
        continue;
      bool occ = false;
      const float bt_row = bt;
      for (int j = 0; j < kTrisPerRow; ++j) {
        const float* tri = row + j * kLanesPerTri;
        const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
        const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
        const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
        const float px = r.dy * e2z - r.dz * e2y;
        const float py = r.dz * e2x - r.dx * e2z;
        const float pz = r.dx * e2y - r.dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const float tx = r.ox - v0x;
        const float ty = r.oy - v0y;
        const float tz = r.oz - v0z;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        if (kLean) {
          // division-free window test (tilewave._row_occluded_smem)
          const float sg = det >= 0.f ? 1.f : -1.f;
          const float ad = det * sg;
          const float su = (tx * px + ty * py + tz * pz) * sg;
          const float sv = (r.dx * qx + r.dy * qy + r.dz * qz) * sg;
          const float st = (e2x * qx + e2y * qy + e2z * qz) * sg;
          occ = occ || (ad > kEpsDenom && su >= 0.f && sv >= 0.f &&
                        su + sv <= ad && st > 0.f && st < bt_row * ad);
        } else {
          const bool ok_det = fabsf(det) > kEpsDenom;
          const float inv = 1.f / (ok_det ? det : 1.f);
          const float u = (tx * px + ty * py + tz * pz) * inv;
          const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
          const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
          if (ok_det && u >= 0.f && v >= 0.f && u + v <= 1.f && t > 0.f &&
              t < bt) {
            bt = t;
            bu = u;
            bv = v;
            bs = tri[9];
          }
        }
      }
      if (kLean && occ) {
        bt = -1.f;
        bs = 0.f;
        break;
      }
    }
  }
  bt_out[ray] = bt;
  bu_out[ray] = bu;
  bv_out[ray] = bv;
  bs_out[ray] = bs;
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
// org/dirn/inv_d: (n_tiles*1024, 3) f32, tmax: (n_tiles*1024,) f32
// (< 0 = dead lane), tri_rows: (R, 128) f32 with 8 rows per cluster,
// entries: (n_tiles, cp) i32 sorted per row, counts: (n_tiles,) i32,
// outputs: (n_tiles*1024,) f32 each (bt, bu, bv, slot-as-f32).
extern "C" int tpurt_tileloop(const float* org, const float* dirn,
                              const float* inv_d, const float* tmax,
                              const float* tri_rows, const int32_t* entries,
                              const int32_t* counts, int n_tiles, int cp,
                              float scale, int lean, float* bt, float* bu,
                              float* bv, float* bs, void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lean) {
    tileloop_kernel<true><<<n_tiles, kTile, 0, s>>>(
        org, dirn, inv_d, tmax, tri_rows, entries, counts, cp, scale, bt, bu,
        bv, bs);
  } else {
    tileloop_kernel<false><<<n_tiles, kTile, 0, s>>>(
        org, dirn, inv_d, tmax, tri_rows, entries, counts, cp, scale, bt, bu,
        bv, bs);
  }
  return static_cast<int>(cudaGetLastError());
}
