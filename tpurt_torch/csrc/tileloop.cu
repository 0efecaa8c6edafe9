// Tile traversal loop: the Hopper port of the TPU kernel
// tpurt/kernels/tilewave.py::_tileloop_kernel (launcher
// _launch_tiles_loop), closest-hit and lean any-hit, with the modes the
// reference's paths reach:
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
//              transformed once per supercluster;
//   kSeg       the pair-segment mode: the tile's entries are
//              pair_cl[off[tile] .. off[tile + 1]) of one flat,
//              tile-major list instead of the first counts[tile] words of
//              its entry row (flat or two-level; never with kSc).
//
// One block per 1024-ray tile, one thread per ray. The block walks the
// tile's front-to-back entries ((tn_q << 16) | id, sorted by the caller).
// Per entry it copies the rows (8 x 128 f32 = 4 KB per cluster, up to
// 32 KB per supercluster) into shared memory; each thread then runs the
// cluster box pre-test (lanes
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

// First row of cluster c: 8c flat, pair_meta's low bits two-level.
template <bool kTwoLevel>
__device__ __forceinline__ long cluster_row0(int c,
                                             const int32_t* pair_meta) {
  return kTwoLevel ? (pair_meta[c] & ((1 << kInstShift) - 1))
                   : static_cast<long>(c) * kRowsPerCluster;
}

// Copy n consecutive clusters' rows from row0 into shared memory, then the
// barrier after which every thread reads them.
__device__ __forceinline__ void stage_rows(float* rows,
                                           const float* __restrict__ tri_rows,
                                           long row0, int n) {
  const float* src = tri_rows + row0 * kLanesPerRow;
  for (int i = threadIdx.x; i < n * kClusterFloats; i += kTile)
    rows[i] = src[i];
  __syncthreads();
}

// The thread's ray in cluster c's space (two-level: object space) and the
// instance a closest win there records.
template <bool kTwoLevel>
__device__ __forceinline__ Ray cluster_ray(const Ray& w, int c,
                                           const int32_t* pair_meta,
                                           const float* inv_xform,
                                           float& inst) {
  if (!kTwoLevel) {
    inst = -1.f;
    return w;
  }
  inst = static_cast<float>(pair_meta[c] >> kInstShift);
  return to_object(w, inv_xform + 12L * c);
}

// This thread's world-space ray.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ org,
                                        const float* __restrict__ dirn,
                                        const float* __restrict__ inv_d,
                                        long ray) {
  Ray w;
  w.ox = org[3 * ray + 0];
  w.oy = org[3 * ray + 1];
  w.oz = org[3 * ray + 2];
  w.dx = dirn[3 * ray + 0];
  w.dy = dirn[3 * ray + 1];
  w.dz = dirn[3 * ray + 2];
  w.ix = inv_d[3 * ray + 0];
  w.iy = inv_d[3 * ray + 1];
  w.iz = inv_d[3 * ray + 2];
  return w;
}

template <bool kLean, bool kTwoLevel, bool kSc, bool kSeg>
__global__ void __launch_bounds__(kTile)
tileloop_kernel(const float* __restrict__ org,
                const float* __restrict__ dirn,
                const float* __restrict__ inv_d,
                const float* __restrict__ tmax,
                const float* __restrict__ tri_rows,
                const int32_t* __restrict__ entries,
                const int32_t* __restrict__ counts,
                const int32_t* __restrict__ off, int cp, float scale,
                const int32_t* __restrict__ pair_meta,
                const float* __restrict__ inv_xform,
                const int32_t* __restrict__ sc_meta,
                float* __restrict__ bt_out, float* __restrict__ bu_out,
                float* __restrict__ bv_out, float* __restrict__ bs_out,
                float* __restrict__ bi_out) {
  __shared__ float rows[(kSc ? kScSize : 1) * kClusterFloats];

  const long tile = blockIdx.x;
  const long ray = tile * kTile + threadIdx.x;
  const Ray w = load_ray(org, dirn, inv_d, ray);
  const float tm = tmax[ray];
  float bt = tm >= 0.f ? tm : -1.f;
  float bu = 0.f, bv = 0.f, bs = -1.f, bi = -1.f;

  const int n = kSeg ? off[tile + 1] - off[tile] : counts[tile];
  const int32_t* ent = kSeg ? entries + off[tile] : entries + tile * cp;
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
    stage_rows(rows, tri_rows, cluster_row0<kTwoLevel>(c, pair_meta), nch);
    if (bt < deq) continue;
    float inst;
    const Ray r = cluster_ray<kTwoLevel>(w, c, pair_meta, inv_xform, inst);
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

// Grid over (tile, cluster) pairs: the Hopper port of the TPU kernel
// tpurt/kernels/tilewave.py::_tile_kernel (launchers _trace_tiles,
// _launch_tiles), closest-hit and any-hit, flat or two-level (kTwoLevel as
// above, instance in a fifth output).
//
// The pair list is the reference's scalar-prefetch operand:
// tile << 16 | (cluster + 1), tile-major, each tile's sentinel (cluster -1)
// first, then its clusters in cluster order, then fill slots (tile T-1,
// cluster -1) up to the list's capacity. The TPU grid runs one step per
// pair and folds each pair into its tile's output block, revisiting the
// block across consecutive steps; blocks here run in no order, so one block
// per 1024-ray tile walks its own contiguous segment of the list (found by
// a binary search on the tile field) and the sentinel's initialisation is
// the block's own. Per pair, per thread: the cluster box pre-test, then per
// row the sub-box test and the 12 triangle tests folded with strict '<'
// against the running best, as in cluster_body: the reference's row
// min-tree, row-winner fold and pair-winner fold keep the same candidate
// (the first at the minimal t, in pair, row and lane order). There is no
// far break (the pairs carry no entry distance). Any-hit runs the same
// closest body and ends the tile once every lane is occluded (bs >= 0) or
// dead (bt < 0), the reference's early-out; the caller reads bs >= 0 only.
//
// Bound on this card: as the loop kernel, the latency of the serial pair
// loop (barrier, 4 KB row copy, barrier, tests); the primary interval mask
// of the grid path passes more pairs per tile than the exact entries.

// First index of the tile-major pair list whose tile field is >= t.
__device__ __forceinline__ int tile_start(const int32_t* __restrict__ pairs,
                                          int n_pairs, long t) {
  int lo = 0, hi = n_pairs;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((pairs[mid] >> 16) < t)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <bool kAny, bool kTwoLevel>
__global__ void __launch_bounds__(kTile)
tilegrid_kernel(const float* __restrict__ org,
                const float* __restrict__ dirn,
                const float* __restrict__ inv_d,
                const float* __restrict__ tmax,
                const float* __restrict__ tri_rows,
                const int32_t* __restrict__ pairs, int n_pairs,
                const int32_t* __restrict__ pair_meta,
                const float* __restrict__ inv_xform,
                float* __restrict__ bt_out, float* __restrict__ bu_out,
                float* __restrict__ bv_out, float* __restrict__ bs_out,
                float* __restrict__ bi_out) {
  __shared__ float rows[kClusterFloats];
  __shared__ int seg[2];

  const long tile = blockIdx.x;
  const long ray = tile * kTile + threadIdx.x;
  const Ray w = load_ray(org, dirn, inv_d, ray);
  const float tm = tmax[ray];
  float bt = tm >= 0.f ? tm : -1.f;
  float bu = 0.f, bv = 0.f, bs = -1.f, bi = -1.f;
  if (threadIdx.x < 2) seg[threadIdx.x] = tile_start(pairs, n_pairs,
                                                     tile + threadIdx.x);
  __syncthreads();

  for (int p = seg[0]; p < seg[1]; ++p) {
    const int c = (pairs[p] & 0xFFFF) - 1;
    if (c < 0) continue;  // sentinel or fill slot
    // the barrier before the shared rows are replaced; any-hit: the
    // early-out once every lane is occluded or dead
    if (kAny) {
      if (__syncthreads_and(bs >= 0.f || bt < 0.f)) break;
    } else {
      __syncthreads();
    }
    stage_rows(rows, tri_rows, cluster_row0<kTwoLevel>(c, pair_meta), 1);
    float inst;
    const Ray r = cluster_ray<kTwoLevel>(w, c, pair_meta, inv_xform, inst);
    cluster_body<false>(rows, r, inst, bt, bu, bv, bs, bi);
  }
  bt_out[ray] = bt;
  bu_out[ray] = bu;
  bv_out[ray] = bv;
  bs_out[ray] = bs;
  if (kTwoLevel) bi_out[ray] = bi;
}

template <bool kLean, bool kTwoLevel, bool kSc, bool kSeg>
void launch(const float* org, const float* dirn, const float* inv_d,
            const float* tmax, const float* tri_rows,
            const int32_t* entries, const int32_t* counts,
            const int32_t* off, int n_tiles, int cp, float scale,
            const int32_t* pair_meta, const float* inv_xform,
            const int32_t* sc_meta, float* bt, float* bu, float* bv,
            float* bs, float* bi, cudaStream_t s) {
  tileloop_kernel<kLean, kTwoLevel, kSc, kSeg><<<n_tiles, kTile, 0, s>>>(
      org, dirn, inv_d, tmax, tri_rows, entries, counts, off, cp, scale,
      pair_meta, inv_xform, sc_meta, bt, bu, bv, bs, bi);
}

// The mode flags as template arguments: supercluster or segment entries
// (never both), then two-level or flat.
template <bool kLean, bool kTwoLevel>
void launch_entries(bool sc, bool seg, const float* org, const float* dirn,
                    const float* inv_d, const float* tmax,
                    const float* tri_rows, const int32_t* entries,
                    const int32_t* counts, const int32_t* off, int n_tiles,
                    int cp, float scale, const int32_t* pair_meta,
                    const float* inv_xform, const int32_t* sc_meta,
                    float* bt, float* bu, float* bv, float* bs, float* bi,
                    cudaStream_t s) {
  if (sc)
    launch<kLean, kTwoLevel, true, false>(
        org, dirn, inv_d, tmax, tri_rows, entries, counts, off, n_tiles, cp,
        scale, pair_meta, inv_xform, sc_meta, bt, bu, bv, bs, bi, s);
  else if (seg)
    launch<kLean, kTwoLevel, false, true>(
        org, dirn, inv_d, tmax, tri_rows, entries, counts, off, n_tiles, cp,
        scale, pair_meta, inv_xform, sc_meta, bt, bu, bv, bs, bi, s);
  else
    launch<kLean, kTwoLevel, false, false>(
        org, dirn, inv_d, tmax, tri_rows, entries, counts, off, n_tiles, cp,
        scale, pair_meta, inv_xform, sc_meta, bt, bu, bv, bs, bi, s);
}

template <bool kLean>
void launch_mode(bool two_level, bool sc, bool seg, const float* org,
                 const float* dirn, const float* inv_d, const float* tmax,
                 const float* tri_rows, const int32_t* entries,
                 const int32_t* counts, const int32_t* off, int n_tiles,
                 int cp, float scale, const int32_t* pair_meta,
                 const float* inv_xform, const int32_t* sc_meta, float* bt,
                 float* bu, float* bv, float* bs, float* bi, cudaStream_t s) {
  if (two_level)
    launch_entries<kLean, true>(sc, seg, org, dirn, inv_d, tmax, tri_rows,
                                entries, counts, off, n_tiles, cp, scale,
                                pair_meta, inv_xform, sc_meta, bt, bu, bv,
                                bs, bi, s);
  else
    launch_entries<kLean, false>(sc, seg, org, dirn, inv_d, tmax, tri_rows,
                                 entries, counts, off, n_tiles, cp, scale,
                                 pair_meta, inv_xform, sc_meta, bt, bu, bv,
                                 bs, bi, s);
}

template <bool kAny, bool kTwoLevel>
void launch_grid(const float* org, const float* dirn, const float* inv_d,
                 const float* tmax, const float* tri_rows,
                 const int32_t* pairs, int n_pairs, int n_tiles,
                 const int32_t* pair_meta, const float* inv_xform, float* bt,
                 float* bu, float* bv, float* bs, float* bi, cudaStream_t s) {
  tilegrid_kernel<kAny, kTwoLevel><<<n_tiles, kTile, 0, s>>>(
      org, dirn, inv_d, tmax, tri_rows, pairs, n_pairs, pair_meta, inv_xform,
      bt, bu, bv, bs, bi);
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
// org/dirn/inv_d: (n_tiles*1024, 3) f32, tmax: (n_tiles*1024,) f32
// (< 0 = dead lane), tri_rows: (R, 128) f32 with 8 rows per cluster.
// Entry rows: entries (n_tiles, cp) i32 sorted per row, counts
// (n_tiles,) i32, off null. Pair segments: entries the flat tile-major
// list, off (n_tiles + 1,) i32 the segment bounds, counts null.
// pair_meta (IC,) i32 and inv_xform (IC, 12) f32: a two-level accel, or
// both null. sc_meta (S,) i32: supercluster entries, or null.
// Outputs: (n_tiles*1024,) f32 each (bt, bu, bv, slot-as-f32, and with a
// two-level accel the instance as f32 in bi; bi may be null otherwise).
extern "C" int tpurt_tileloop(const float* org, const float* dirn,
                              const float* inv_d, const float* tmax,
                              const float* tri_rows, const int32_t* entries,
                              const int32_t* counts, const int32_t* off,
                              int n_tiles, int cp, float scale, int lean,
                              const int32_t* pair_meta,
                              const float* inv_xform,
                              const int32_t* sc_meta, float* bt, float* bu,
                              float* bv, float* bs, float* bi,
                              void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool two_level = pair_meta != nullptr;
  const bool sc = sc_meta != nullptr;
  const bool seg = off != nullptr;
  if (sc && seg) return static_cast<int>(cudaErrorInvalidValue);
  if (lean)
    launch_mode<true>(two_level, sc, seg, org, dirn, inv_d, tmax, tri_rows,
                      entries, counts, off, n_tiles, cp, scale, pair_meta,
                      inv_xform, sc_meta, bt, bu, bv, bs, bi, s);
  else
    launch_mode<false>(two_level, sc, seg, org, dirn, inv_d, tmax, tri_rows,
                       entries, counts, off, n_tiles, cp, scale, pair_meta,
                       inv_xform, sc_meta, bt, bu, bv, bs, bi, s);
  return static_cast<int>(cudaGetLastError());
}

// The grid-over-pairs kernel on ``stream``; returns cudaGetLastError().
// Rays and tables as tpurt_tileloop; pairs (n_pairs,) i32 the tile-major
// list tile << 16 | (cluster + 1) with one sentinel per tile.
extern "C" int tpurt_tilegrid(const float* org, const float* dirn,
                              const float* inv_d, const float* tmax,
                              const float* tri_rows, const int32_t* pairs,
                              int n_pairs, int n_tiles, int any_hit,
                              const int32_t* pair_meta,
                              const float* inv_xform, float* bt, float* bu,
                              float* bv, float* bs, float* bi,
                              void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool two_level = pair_meta != nullptr;
  if (any_hit && two_level)
    launch_grid<true, true>(org, dirn, inv_d, tmax, tri_rows, pairs, n_pairs,
                            n_tiles, pair_meta, inv_xform, bt, bu, bv, bs,
                            bi, s);
  else if (any_hit)
    launch_grid<true, false>(org, dirn, inv_d, tmax, tri_rows, pairs,
                             n_pairs, n_tiles, pair_meta, inv_xform, bt, bu,
                             bv, bs, bi, s);
  else if (two_level)
    launch_grid<false, true>(org, dirn, inv_d, tmax, tri_rows, pairs,
                             n_pairs, n_tiles, pair_meta, inv_xform, bt, bu,
                             bv, bs, bi, s);
  else
    launch_grid<false, false>(org, dirn, inv_d, tmax, tri_rows, pairs,
                              n_pairs, n_tiles, pair_meta, inv_xform, bt, bu,
                              bv, bs, bi, s);
  return static_cast<int>(cudaGetLastError());
}
