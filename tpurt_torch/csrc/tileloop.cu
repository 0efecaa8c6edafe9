// Tile traversal loop: the Hopper port of the TPU kernel
// tpurt/kernels/tilewave.py::_tileloop_kernel (launcher
// _launch_tiles_loop) in its entry-row mode, closest-hit and lean any-hit,
// with the modes the reference's default paths reach:
//
//   flat       entries are cluster ids; cluster c's rows start at 8c;
//   all-pairs  the same code fed the row [0, 1, ..., C-1] with scale 0
//              (scenes of at most 8 clusters): the far break then fires
//              only once every lane is dead or occluded;
//   kTwoLevel  a two-level accel: cluster c's rows start at
//              pair_meta[c] & 0xFFFFF, the thread's ray goes into the
//              cluster's object space with inv_xform[c] (d is not
//              renormalized, so t stays in world units), and a closest
//              win records the instance pair_meta[c] >> 20 in a fifth
//              output;
//   kSc        entries are superclusters: sc_meta[sid] gives the first
//              child cluster (v & 0xFFFF) and the child count (v >> 16,
//              at most 8); the children are consecutive clusters with
//              contiguous rows, so the block copies all of them at once
//              and runs each child's box pre-test and row tests. With
//              kTwoLevel the children share one instance, so the ray is
//              transformed once per supercluster.
//
// One block per 1024-ray tile, one thread per ray. The block walks the
// tile's front-to-back entry row ((tn_q << 16) | id, sorted by the
// caller, ``counts[tile]`` live entries). Per entry it copies the rows
// (8 x 128 f32 = 4 KB per cluster, up to 32 KB per supercluster) into
// shared memory; each thread then runs the cluster box pre-test (lanes
// 126-127 of the cluster's rows 0-2), the 8 row sub-box tests (lanes
// 120-125) and the 12 Moller-Trumbore tests of every surviving row against
// its own ray. Candidates fold with strict '<' in entry, child, row and
// lane order, so ties keep the earlier candidate, exactly as the
// reference's fold does. The lean any-hit variant runs the division-free
// window test of _row_occluded_smem and retires an occluded lane with
// bt = -1, bs = 0.
//
// Far break: the entry's quantized distance is a floor, so it lower-bounds
// the slab entry of every ray that can hit the cluster (in sc mode, of the
// superbox, which contains every child). Once every lane's best t (tmax
// for misses, -1 for dead or occluded lanes) is below it, no later entry
// can change any lane: __syncthreads_and ends the tile. A thread whose own
// best t is already below it skips the entry's work. Doing the box tests
// per thread instead of per tile only prunes more; it changes no result.
//
// What bounds it on this card: latency of the serial entry loop. Each
// entry is a dependent chain (barrier, row copy, barrier, box tests, up to
// 96 triangle tests per cluster) and the trip count varies per tile, so
// the block spends much of its time waiting on the copy and on its
// slowest warp. The simple design keeps 1024 threads per block (latency is
// hidden only across warps of one tile) and plain loads plus
// __syncthreads for the copy; double buffering with cp.async or TMA is
// later work. The sc variant runs the same serial loop with an up to 8x
// larger copy per entry (32 KB of static shared memory), and the
// two-level variants keep up to 9 more live registers per thread for the
// object-space ray (ptxas: 47 registers flat closest, 53-59 in the
// two-level and sc variants, no spills at 1024 threads).
//
// Built with -fmad=false and IEEE division (1/det, 1/d), matching the
// reference's op order term for term.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;          // rays per tile = threads per block
constexpr int kRowsPerCluster = 8;
constexpr int kLanesPerRow = 128;
constexpr int kClusterFloats = kRowsPerCluster * kLanesPerRow;
constexpr int kTrisPerRow = 12;
constexpr int kLanesPerTri = 10;
constexpr int kScSize = 8;           // children per supercluster, at most
constexpr int kInstShift = 20;       // pair_meta: row base | inst << 20
constexpr float kEpsDenom = 1e-12f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// 1 / d with the sign-preserving clamp away from 0 of the reference.
__device__ __forceinline__ float safe_inv(float d) {
  return 1.f / (fabsf(d) < 1e-12f ? (d >= 0.f ? 1e-12f : -1e-12f) : d);
}

// World ray -> object space of a 3x4 row-major world->object matrix, in
// the reference's term order (m0*x + m1*y + m2*z + m3, left to right).
__device__ __forceinline__ Ray to_object(const Ray& w,
                                         const float* __restrict__ m) {
  Ray r;
  r.ox = m[0] * w.ox + m[1] * w.oy + m[2] * w.oz + m[3];
  r.oy = m[4] * w.ox + m[5] * w.oy + m[6] * w.oz + m[7];
  r.oz = m[8] * w.ox + m[9] * w.oy + m[10] * w.oz + m[11];
  r.dx = m[0] * w.dx + m[1] * w.dy + m[2] * w.dz;
  r.dy = m[4] * w.dx + m[5] * w.dy + m[6] * w.dz;
  r.dz = m[8] * w.dx + m[9] * w.dy + m[10] * w.dz;
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

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

// One cluster's work for this thread's ray: the cluster box pre-test,
// then per row the sub-box test and the 12 triangle tests. ``rows`` is
// the cluster's 8 x 128 block in shared memory.
template <bool kLean>
__device__ __forceinline__ void cluster_body(const float* rows, const Ray& r,
                                             float inst, float& bt,
                                             float& bu, float& bv,
                                             float& bs, float& bi) {
  // cluster box pre-test, far-limited by the current best t
  if (!box_reachable(r, rows[126], rows[127], rows[kLanesPerRow + 126],
                     rows[kLanesPerRow + 127], rows[2 * kLanesPerRow + 126],
                     rows[2 * kLanesPerRow + 127], bt))
    return;
  for (int rr = 0; rr < kRowsPerCluster; ++rr) {
    const float* row = rows + rr * kLanesPerRow;
    if (!box_reachable(r, row[120], row[121], row[122], row[123], row[124],
                       row[125], bt))
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
          bi = inst;
        }
      }
    }
    if (kLean && occ) {
      bt = -1.f;
      bs = 0.f;
      return;
    }
  }
}

template <bool kLean, bool kTwoLevel, bool kSc>
__global__ void __launch_bounds__(kTile)
tileloop_kernel(const float* __restrict__ org,
                const float* __restrict__ dirn,
                const float* __restrict__ inv_d,
                const float* __restrict__ tmax,
                const float* __restrict__ tri_rows,
                const int32_t* __restrict__ entries,
                const int32_t* __restrict__ counts, int cp, float scale,
                const int32_t* __restrict__ pair_meta,
                const float* __restrict__ inv_xform,
                const int32_t* __restrict__ sc_meta,
                float* __restrict__ bt_out, float* __restrict__ bu_out,
                float* __restrict__ bv_out, float* __restrict__ bs_out,
                float* __restrict__ bi_out) {
  __shared__ float rows[(kSc ? kScSize : 1) * kClusterFloats];

  const long tile = blockIdx.x;
  const long ray = tile * kTile + threadIdx.x;
  Ray w;  // the world-space ray
  w.ox = org[3 * ray + 0];
  w.oy = org[3 * ray + 1];
  w.oz = org[3 * ray + 2];
  w.dx = dirn[3 * ray + 0];
  w.dy = dirn[3 * ray + 1];
  w.dz = dirn[3 * ray + 2];
  w.ix = inv_d[3 * ray + 0];
  w.iy = inv_d[3 * ray + 1];
  w.iz = inv_d[3 * ray + 2];
  const float tm = tmax[ray];
  float bt = tm >= 0.f ? tm : -1.f;
  float bu = 0.f, bv = 0.f, bs = -1.f, bi = -1.f;

  const int n = counts[tile];
  const int32_t* ent = entries + tile * cp;
  for (int p = 0; p < n; ++p) {
    const int32_t e = ent[p];
    const float deq = static_cast<float>(e >> 16) * scale;
    // far break (also the barrier before the shared rows are replaced)
    if (__syncthreads_and(bt < deq)) break;
    const int id = e & 0xFFFF;
    int c = id, nch = 1;  // first cluster and cluster count of the entry
    if (kSc) {
      const int32_t v = sc_meta[id];
      c = v & 0xFFFF;
      nch = v >> 16;
    }
    const long row0 = kTwoLevel ? (pair_meta[c] & ((1 << kInstShift) - 1))
                                : static_cast<long>(c) * kRowsPerCluster;
    const float* src = tri_rows + row0 * kLanesPerRow;
    for (int i = threadIdx.x; i < nch * kClusterFloats; i += kTile)
      rows[i] = src[i];
    __syncthreads();
    if (bt < deq) continue;
    Ray r = w;
    float inst = -1.f;
    if (kTwoLevel) {
      r = to_object(w, inv_xform + 12L * c);
      if (!kLean) inst = static_cast<float>(pair_meta[c] >> kInstShift);
    }
    for (int k = 0; k < nch; ++k) {
      cluster_body<kLean>(rows + k * kClusterFloats, r, inst, bt, bu, bv,
                          bs, bi);
      if (kLean && bt < 0.f) break;  // occluded: nothing left to find
    }
  }
  bt_out[ray] = bt;
  bu_out[ray] = bu;
  bv_out[ray] = bv;
  bs_out[ray] = bs;
  if (kTwoLevel) bi_out[ray] = bi;
}

template <bool kLean, bool kTwoLevel, bool kSc>
void launch(const float* org, const float* dirn, const float* inv_d,
            const float* tmax, const float* tri_rows,
            const int32_t* entries, const int32_t* counts, int n_tiles,
            int cp, float scale, const int32_t* pair_meta,
            const float* inv_xform, const int32_t* sc_meta, float* bt,
            float* bu, float* bv, float* bs, float* bi, cudaStream_t s) {
  tileloop_kernel<kLean, kTwoLevel, kSc><<<n_tiles, kTile, 0, s>>>(
      org, dirn, inv_d, tmax, tri_rows, entries, counts, cp, scale,
      pair_meta, inv_xform, sc_meta, bt, bu, bv, bs, bi);
}

template <bool kLean>
void launch_mode(bool two_level, bool sc, const float* org,
                 const float* dirn, const float* inv_d, const float* tmax,
                 const float* tri_rows, const int32_t* entries,
                 const int32_t* counts, int n_tiles, int cp, float scale,
                 const int32_t* pair_meta, const float* inv_xform,
                 const int32_t* sc_meta, float* bt, float* bu, float* bv,
                 float* bs, float* bi, cudaStream_t s) {
  if (two_level && sc)
    launch<kLean, true, true>(org, dirn, inv_d, tmax, tri_rows, entries,
                              counts, n_tiles, cp, scale, pair_meta,
                              inv_xform, sc_meta, bt, bu, bv, bs, bi, s);
  else if (two_level)
    launch<kLean, true, false>(org, dirn, inv_d, tmax, tri_rows, entries,
                               counts, n_tiles, cp, scale, pair_meta,
                               inv_xform, sc_meta, bt, bu, bv, bs, bi, s);
  else if (sc)
    launch<kLean, false, true>(org, dirn, inv_d, tmax, tri_rows, entries,
                               counts, n_tiles, cp, scale, pair_meta,
                               inv_xform, sc_meta, bt, bu, bv, bs, bi, s);
  else
    launch<kLean, false, false>(org, dirn, inv_d, tmax, tri_rows, entries,
                                counts, n_tiles, cp, scale, pair_meta,
                                inv_xform, sc_meta, bt, bu, bv, bs, bi, s);
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
// org/dirn/inv_d: (n_tiles*1024, 3) f32, tmax: (n_tiles*1024,) f32
// (< 0 = dead lane), tri_rows: (R, 128) f32 with 8 rows per cluster,
// entries: (n_tiles, cp) i32 sorted per row, counts: (n_tiles,) i32.
// pair_meta (IC,) i32 and inv_xform (IC, 12) f32: a two-level accel, or
// both null. sc_meta (S,) i32: supercluster entries, or null.
// Outputs: (n_tiles*1024,) f32 each (bt, bu, bv, slot-as-f32, and with a
// two-level accel the instance as f32 in bi; bi may be null otherwise).
extern "C" int tpurt_tileloop(const float* org, const float* dirn,
                              const float* inv_d, const float* tmax,
                              const float* tri_rows, const int32_t* entries,
                              const int32_t* counts, int n_tiles, int cp,
                              float scale, int lean,
                              const int32_t* pair_meta,
                              const float* inv_xform,
                              const int32_t* sc_meta, float* bt, float* bu,
                              float* bv, float* bs, float* bi,
                              void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool two_level = pair_meta != nullptr;
  const bool sc = sc_meta != nullptr;
  if (lean)
    launch_mode<true>(two_level, sc, org, dirn, inv_d, tmax, tri_rows,
                      entries, counts, n_tiles, cp, scale, pair_meta,
                      inv_xform, sc_meta, bt, bu, bv, bs, bi, s);
  else
    launch_mode<false>(two_level, sc, org, dirn, inv_d, tmax, tri_rows,
                       entries, counts, n_tiles, cp, scale, pair_meta,
                       inv_xform, sc_meta, bt, bu, bv, bs, bi, s);
  return static_cast<int>(cudaGetLastError());
}
