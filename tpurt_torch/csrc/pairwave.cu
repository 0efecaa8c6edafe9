// Pair test: the Hopper port of the TPU kernel
// tpurt/kernels/pairwave.py::_pair_kernel (launcher _trace_pairs), the
// third phase of the pair-wavefront intersector.
//
// Input is the pair list the cull/expand phase built: slot s holds a ray
// (pair_ray[s], -1 for padding) and the cluster its box test passed
// (pair_cluster[s]), laid out cluster-major in 64-aligned segments, and
// block_cmin[s / 1024] is -1 for a 1024-slot block past the last segment.
// Every slot gets the closest hit of its ray among its cluster's 96
// triangles (8 rows x 12): bt, bu, bv, bs (slot id as f32), each (P,) f32.
// A live slot starts at bt = tmax, bu = bv = 0, bs = -1, and only t < tmax
// wins; a dead slot (tmax < 0 or padding) writes (-1, 0, 0, -1).
//
// The Pallas kernel tests every slot of its 1024-pair block against every
// cluster of the block's range (up to 16) under a cluster-match mask,
// because a lockstep (8, 128) tile cannot branch per pair. Its result is
// the own-cluster test, which is what this kernel computes: one thread per
// slot, its own cluster only. The fold order is the reference's: within a
// row the min-tree keeps the lowest lane at the minimum (candidates that
// fail the test count as 3.4e38), across rows a strict '<' keeps the
// earlier row.
//
// What bounds it on this card: arithmetic, ~60 operations per
// Moller-Trumbore test, 96 tests per live slot (10 M live slots of the
// 32.4 M in a bunny 800x600 x 8 spp primary wave). The simple design: one
// thread per slot, 256-thread blocks, triangle rows read through the
// cache. Slots are cluster-major, so the threads of a warp mostly read the
// same rows (broadcast loads) and the bunny's 3.5 MB of rows stay in L2.
// Blocks of padding write the dead values and stop.
//
// Built with -fmad=false and IEEE division (1/det), matching the
// reference's op order term for term.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockPairs = 1024;    // slots per pair block of the list
constexpr int kRowsPerCluster = 8;
constexpr int kLanesPerRow = 128;
constexpr int kTrisPerRow = 12;
constexpr int kLanesPerTri = 10;
constexpr float kEpsDenom = 1e-12f;
constexpr float kBig = 3.4e38f;

__global__ void __launch_bounds__(kThreads)
pair_kernel(const int32_t* __restrict__ pair_ray,
            const int32_t* __restrict__ pair_cluster,
            const int32_t* __restrict__ block_cmin,
            const float* __restrict__ org, const float* __restrict__ dirn,
            const float* __restrict__ tmax,
            const float* __restrict__ tri_rows, long n_slots,
            float* __restrict__ bt_out, float* __restrict__ bu_out,
            float* __restrict__ bv_out, float* __restrict__ bs_out) {
  const long s = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n_slots) return;
  int r = -1;
  float tm = -1.f;
  if (block_cmin[s / kBlockPairs] >= 0) {  // padding blocks read nothing
    r = pair_ray[s];
    if (r >= 0) tm = tmax[r];
  }
  float bt = tm >= 0.f ? tm : -1.f;
  float bu = 0.f, bv = 0.f, bs = -1.f;
  if (tm >= 0.f) {
    const float ox = org[3L * r + 0], oy = org[3L * r + 1],
                oz = org[3L * r + 2];
    const float dx = dirn[3L * r + 0], dy = dirn[3L * r + 1],
                dz = dirn[3L * r + 2];
    const float* rows = tri_rows + static_cast<long>(pair_cluster[s]) *
                                       kRowsPerCluster * kLanesPerRow;
    for (int row = 0; row < kRowsPerCluster; ++row) {
      const float* tri = rows + row * kLanesPerRow;
      float rt = kBig, ru = 0.f, rv = 0.f, rs = 0.f;
      for (int j = 0; j < kTrisPerRow; ++j, tri += kLanesPerTri) {
        const float v0x = __ldg(tri + 0), v0y = __ldg(tri + 1),
                    v0z = __ldg(tri + 2);
        const float e1x = __ldg(tri + 3), e1y = __ldg(tri + 4),
                    e1z = __ldg(tri + 5);
        const float e2x = __ldg(tri + 6), e2y = __ldg(tri + 7),
                    e2z = __ldg(tri + 8);
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool ok_det = fabsf(det) > kEpsDenom;
        const float inv = 1.f / (ok_det ? det : 1.f);
        const float tx = ox - v0x;
        const float ty = oy - v0y;
        const float tz = oz - v0z;
        const float u = (tx * px + ty * py + tz * pz) * inv;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (dx * qx + dy * qy + dz * qz) * inv;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
        const bool ok = ok_det && u >= 0.f && v >= 0.f && u + v <= 1.f &&
                        t > 0.f;
        const float cand = ok ? t : kBig;
        // the reference's min-tree: lane 0 seeds the row, a later lane
        // takes it only with a strictly smaller candidate
        if (j == 0 || cand < rt) {
          rt = cand;
          ru = u;
          rv = v;
          rs = __ldg(tri + 9);
        }
      }
      if (rt < bt) {
        bt = rt;
        bu = ru;
        bv = rv;
        bs = rs;
      }
    }
  }
  bt_out[s] = bt;
  bu_out[s] = bu;
  bv_out[s] = bv;
  bs_out[s] = bs;
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
// pair_ray/pair_cluster: (n_slots,) i32, block_cmin: (n_slots / 1024,) i32,
// org/dirn: (n_rays, 3) f32, tmax: (n_rays,) f32, tri_rows: (R, 128) f32,
// bt/bu/bv/bs: (n_slots,) f32. n_slots is a multiple of 1024.
extern "C" int tpurt_pair_test(const int32_t* pair_ray,
                               const int32_t* pair_cluster,
                               const int32_t* block_cmin, const float* org,
                               const float* dirn, const float* tmax,
                               const float* tri_rows, long n_slots,
                               float* bt, float* bu, float* bv, float* bs,
                               void* stream) {
  if (n_slots <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((n_slots + kThreads - 1) /
                                              kThreads);
  pair_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pair_ray, pair_cluster, block_cmin, org, dirn, tmax, tri_rows, n_slots,
      bt, bu, bv, bs);
  return static_cast<int>(cudaGetLastError());
}
