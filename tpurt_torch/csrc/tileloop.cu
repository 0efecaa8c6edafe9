// Tile traversal loop: the Hopper port of two TPU kernels of
// tpurt/kernels/tilewave.py, _tileloop_kernel (K1, launcher
// _launch_tiles_loop; closest-hit and lean any-hit) and _tile_kernel (K4,
// the grid over pairs, launchers _trace_tiles and _launch_tiles;
// closest-hit and any-hit), as one walk with the modes the reference's
// paths reach:
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
//              contiguous rows, so one copy brings all of them and each
//              child gets its box pre-test and row tests. With kTwoLevel
//              the children share one instance, so the ray is transformed
//              once per supercluster;
//   kSeg       the pair-segment mode: the tile's entries are
//              pair_cl[off[tile] .. off[tile + 1]) of one flat,
//              tile-major list instead of the first counts[tile] words of
//              its entry row (flat or two-level; never with kSc);
//   kPairs     the grid over pairs (K4, tpurt_tilegrid): the tile's
//              entries are its real pairs in the reference's tile-major
//              pair list, tile << 16 | (cluster + 1), which each block
//              finds by two searches of the list (pair_bounds: the
//              sentinel and the fill slots are left out); the cluster is
//              (w & 0xFFFF) - 1 and the distance 0 (scale 0, as in the
//              all-pairs mode).
//
// Per ray the work is fixed by its own walk: for each of its tile's
// front-to-back entries ((tn_q << 16) | id, sorted by the caller) whose
// quantized distance deq is not above the ray's best t, the cluster box
// pre-test (lanes 126-127 of the cluster's rows 0-2), the 8 row sub-box
// tests (lanes 120-125) and the 12 Moller-Trumbore tests of every
// surviving row. Candidates fold with strict '<' in entry, child, row and
// lane order, so ties keep the earlier candidate, exactly as the
// reference's fold does. The lean any-hit variant runs the division-free
// window test of _row_occluded_smem and retires an occluded lane with
// bt = -1, bs = 0. Since entries are sorted by deq and a ray's best t only
// falls, a ray skips every entry after its first skipped one: so any group
// of rays may stop walking once all of its rays are below the next deq
// (the far break), and the result of every ray is the same whichever group
// it walks in and however far ahead the rows are fetched.
//
// The walk. A tile's 1024 rays are cut into slices (kSliceWarps warps,
// kScSliceWarps with supercluster entries); each
// slice is one block, so the grid is n_tiles x slices and several blocks
// share an SM. Each block walks its tile's whole entry list for its own
// rays, in groups of kGroup entries (one supercluster with kSc). At each
// group a block-wide vote (__syncthreads_and over the slice) is its far
// break; a smaller, coherent slice of octant-sorted rays breaks earlier,
// and the warps of one slice wait only for each other, once per group,
// while the other resident blocks keep the SM busy. A warp skips an entry
// that none of its rays reaches.
//
// The ring. The rows of a group (kGroup clusters of 8 x 128 f32 = 4 KB
// each, or a supercluster's up to 8 clusters = 32 KB) are one stage of a
// ring of kStages stages in dynamic shared memory. Lanes of warp 0 fetch
// group g + kStages - 1 with 1-D bulk copies (cp.async.bulk, the TMA)
// completing on the stage's mbarrier, issued right after the vote of group
// g (which certifies every thread is done with the stage), so the rows of
// the next group arrive while this one is tested. A warp that tests group
// g waits on its stage's barrier; one that skips it does not. The entry
// words and tables that say what to fetch are read before the vote, so
// their latency hides behind it. A block that breaks early waits for every
// copy it issued before it exits, so no copy lands in shared memory that a
// later block owns. Shared memory per block: kStages x kGroup x 4 KB (32
// KB), kStages x 32 KB (64 KB) with kSc; the launch raises the kernel's
// dynamic shared-memory limit once.
//
// The rows. Per cluster each lane tests the cluster box and the 8 row
// sub-boxes of its ray (the same shared address across the warp, float4
// and float2 reads); that gives each lane the rows it must test. A warp
// running each lane's rows itself runs every row one of its lanes needs,
// 12 triangle tests each, whatever the other 31 lanes need. So where the
// warp's rows are sparse (cluster_body: the rounds needed, at most 8 rows
// a round and one row of a lane a round, below kCoopPer4 / 4 x the rows
// any lane needs), groups of 4 lanes test one lane's next row together, 3
// triangles each, and fold the row's winner as its strict-'<' fold in
// lane order would (first minimum of (t, lane), or any occluder for the
// lean test); where they are dense (all-pairs rows of a Cornell box), each
// lane walks its own rows (lane_rows). Both give each ray exactly its
// sequential walk: the same rows, in order, each against the best t it
// had then.
//
// The hit modes: closest, lean any-hit (kLean: the window test, an
// occluded ray retires with bt = -1), and K4's any-hit (kOccluded: the
// closest body, and a ray stops walking once it holds a hit, bs >= 0; the
// caller reads bs >= 0 only). A ray is done with an entry at quantized
// distance deq once bt < deq (or, kOccluded, once bs >= 0): that is the
// far break's vote, the warp skip and the entry's live test alike.
//
// Registers: __launch_bounds__(threads, 65536 / (threads * cap)) with the
// cap kRegCap (flat) or kTlRegCap (two-level: 9 more live registers for
// the object-space ray); ptxas spills nothing at these caps.
//
// What bounds it on this card: the issue rate of the box and triangle
// tests, and then the barrier per group (a slice waits for its slowest
// warp) and the L2 reads of the rows, which each slice of a tile fetches
// for itself. K4's lists carry no distances, so only dead (and, for its
// any-hit, occluded) rays stop early and every live ray tests every
// cluster box of its tile's list.
//
// Built with -fmad=false and IEEE division (1/det, 1/d), matching the
// reference's op order term for term; the wide shared-memory reads change
// no arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;          // rays per tile
constexpr int kRowsPerCluster = 8;
constexpr int kLanesPerRow = 128;
constexpr int kClusterFloats = kRowsPerCluster * kLanesPerRow;
constexpr int kClusterBytes = kClusterFloats * 4;
constexpr int kTrisPerRow = 12;
constexpr int kLanesPerTri = 10;
constexpr int kScSize = 8;           // children per supercluster, at most
constexpr int kInstShift = 20;       // pair_meta: row base | inst << 20
constexpr float kEpsDenom = 1e-12f;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// The loop's shape (the note above).
constexpr int kSliceWarps = 4;       // warps per block, cluster entries
constexpr int kScSliceWarps = 8;     // the same, supercluster entries
constexpr int kStages = 2;           // ring depth
constexpr int kGroup = 4;            // cluster entries per stage
constexpr int kRegCap = 72;          // registers per thread the bounds allow
constexpr int kTlRegCap = 80;        // the same, two-level variants
constexpr int kTriLanes = 4;         // lanes sharing one row's tests
constexpr int kCoopPer4 = 8;         // shared rows while 4 x rounds < this
                                     // x rows the warp's lanes touch

// What a walk computes (the note above).
enum Hit { kClosest, kLean, kOccluded };
// Where a tile's entries come from: its entry row (counts), a segment of
// a flat list (off), or the real pairs of a pair list (pair_bounds).
enum Src { kRows, kSeg, kPairs };

template <bool kTwoLevel, bool kSc>
struct Walk {
  static constexpr int kThreads = 32 * (kSc ? kScSliceWarps : kSliceWarps);
  static constexpr int kSlices = kTile / kThreads;
  static constexpr int kEntries = kSc ? 1 : kGroup;  // entries per stage
  static constexpr int kStageFloats =
      (kSc ? kScSize : kGroup) * kClusterFloats;
  static constexpr int kSmemBytes = kStages * kStageFloats * 4;
  static constexpr int kMinBlocks =
      65536 / (kThreads * (kTwoLevel ? kTlRegCap : kRegCap));
  static_assert(kTile % kThreads == 0, "a tile is whole slices");
  static_assert(kEntries <= 32, "warp 0 fetches one entry per lane");
  static_assert(kTrisPerRow % kTriLanes == 0 && 32 % kTriLanes == 0,
                "a row's triangles split evenly over a group of lanes");
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// --- the ring's barriers and copies (PTX for sm_90) ------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(1)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival of the stage's phase, with the bytes its copies bring.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// 1-D bulk copy global -> shared (16-byte aligned, a multiple of 16 bytes)
// completing on ``bar``.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// --- the tests -------------------------------------------------------------

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

// One Moller-Trumbore test of triangle j, t = (v0, e1, e2, slot), against
// the ray, folded with strict '<' into the best (bt, bj, bu, bv, bs)
// (closest) or into ``occ`` (lean, window bt_row).
template <bool kLean>
__device__ __forceinline__ void tri_test(const float (&t)[kLanesPerTri],
                                         const Ray& r, int j, float bt_row,
                                         bool& occ, float& bt, int& bj,
                                         float& bu, float& bv, float& bs) {
  const float v0x = t[0], v0y = t[1], v0z = t[2];
  const float e1x = t[3], e1y = t[4], e1z = t[5];
  const float e2x = t[6], e2y = t[7], e2z = t[8];
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
    const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
    if (ok_det && u >= 0.f && v >= 0.f && u + v <= 1.f && tt > 0.f &&
        tt < bt) {
      bt = tt;
      bj = j;
      bu = u;
      bv = v;
      bs = t[9];
    }
  }
}

// The rows of ``todo`` whose sub-box (lanes 120-125) the ray enters before
// ``far``; every lane reads the same row at once.
__device__ __forceinline__ unsigned rows_reached(const float* rows,
                                                 const Ray& r, float far,
                                                 unsigned todo) {
  unsigned out = 0;
#pragma unroll
  for (int rr = 0; rr < kRowsPerCluster; ++rr) {
    const float* row = rows + rr * kLanesPerRow;
    const float4 lo = *reinterpret_cast<const float4*>(row + 120);
    const float2 hi = *reinterpret_cast<const float2*>(row + 124);
    if ((todo >> rr & 1u) &&
        box_reachable(r, lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, far))
      out |= 1u << rr;
  }
  return out;
}

// This lane's ray against the rows of ``todo`` of one cluster, in row
// order: each row's sub-box test with the current best t, then its 12
// triangle tests (three float4 loads a triangle pair, the same address
// across the warp). A row outside ``todo`` is one the ray missed at a
// larger best t, so it would miss now. ``tested``: todo's rows passed
// their sub-box test at the current best t; a lean walk's best t holds
// until it returns, so it skips the test again.
template <bool kLean>
__device__ __forceinline__ void lane_rows(const float* rows, const Ray& r,
                                          float inst, unsigned todo,
                                          bool tested, float& bt, float& bu,
                                          float& bv, float& bs, float& bi) {
  for (int rr = 0; rr < kRowsPerCluster; ++rr) {
    if (!(todo >> rr & 1u)) continue;
    const float* row = rows + rr * kLanesPerRow;
    const float4 lo = *reinterpret_cast<const float4*>(row + 120);
    const float2 hi = *reinterpret_cast<const float2*>(row + 124);
    if (!(kLean && tested) &&
        !box_reachable(r, lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, bt))
      continue;
    bool occ = false;
    int bj = kTrisPerRow;
    const float bt_row = bt;
    const float4* q = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int j = 0; j < kTrisPerRow / 2; ++j) {
      const float4 a = q[5 * j], b = q[5 * j + 1], c = q[5 * j + 2];
      const float4 d = q[5 * j + 3], e = q[5 * j + 4];
      const float t0[kLanesPerTri] = {a.x, a.y, a.z, a.w, b.x,
                                      b.y, b.z, b.w, c.x, c.y};
      const float t1[kLanesPerTri] = {c.z, c.w, d.x, d.y, d.z,
                                      d.w, e.x, e.y, e.z, e.w};
      tri_test<kLean>(t0, r, 2 * j, bt_row, occ, bt, bj, bu, bv, bs);
      tri_test<kLean>(t1, r, 2 * j + 1, bt_row, occ, bt, bj, bu, bv, bs);
    }
    if (bj < kTrisPerRow) bi = inst;
    if (kLean && occ) {
      bt = -1.f;
      bs = 0.f;
      return;
    }
  }
}

// The cluster box pre-test (lanes 126-127 of the cluster's rows 0-2) of
// this lane's ray, far-limited by its best t.
__device__ __forceinline__ bool cluster_reachable(const float* rows,
                                                  const Ray& r, float far) {
  const float2 b0 = *reinterpret_cast<const float2*>(rows + 126);
  const float2 b1 =
      *reinterpret_cast<const float2*>(rows + kLanesPerRow + 126);
  const float2 b2 =
      *reinterpret_cast<const float2*>(rows + 2 * kLanesPerRow + 126);
  return box_reachable(r, b0.x, b0.y, b1.x, b1.y, b2.x, b2.y, far);
}

// One cluster's work for the warp's rays, each lane's ray in the parent's
// order: the cluster box pre-test, then per row the sub-box test and the
// 12 triangle tests. ``rows`` is the cluster's 8 x 128 block in shared
// memory; a lane with ``live`` false takes no part. Every lane of the warp
// calls it together.
//
// The triangle tests are shared out: each round, groups of kTriLanes lanes
// each take the next row of one lane that still has rows to test (up to
// 32 / kTriLanes such lanes a round), every lane of a group testing 12 /
// kTriLanes of the row's triangles against the owner's ray. The group's
// first minimum of (t, lane of the row) among the candidates below the
// owner's best t is exactly what the row's strict-'<' fold in lane order
// keeps; the lean test ORs the group's window tests. A lane's rows go in
// order, one a round, and after a closest win it re-tests the sub-boxes
// of its remaining rows with its new best t, so every lane tests exactly
// the rows, in the order and against the best t, of its own sequential
// walk.
template <bool kLean>
__device__ __forceinline__ void cluster_body(const float* rows, const Ray& r,
                                             float inst, bool live,
                                             float& bt, float& bu, float& bv,
                                             float& bs, float& bi) {
  constexpr int kPairs = 32 / kTriLanes;             // rows tested a round
  constexpr int kPerLane = kTrisPerRow / kTriLanes;  // triangles a lane
  const int lane = threadIdx.x & 31;
  const int grp = lane / kTriLanes, sub = lane % kTriLanes;
  const bool in = live && cluster_reachable(rows, r, bt);
  if (!__any_sync(kFullMask, in)) return;
  unsigned todo = rows_reached(rows, r, bt, in ? 0xFFu : 0u);
  // rows dense across the warp: each lane walks its own (the warp runs
  // every row one of its lanes needs); sparse: the lanes share them out
  const unsigned any_row = __reduce_or_sync(kFullMask, todo);
  const int n_rows = __popc(todo);
  const int rounds = max(
      static_cast<int>((__reduce_add_sync(kFullMask, n_rows) + kPairs - 1) /
                       kPairs),
      static_cast<int>(__reduce_max_sync(kFullMask, n_rows)));
  if (4 * rounds >= kCoopPer4 * __popc(any_row)) {
    lane_rows<kLean>(rows, r, inst, todo, true, bt, bu, bv, bs, bi);
    return;
  }
  for (;;) {
    const unsigned want = __ballot_sync(kFullMask, todo != 0);
    if (!want) return;
    // group grp serves the grp-th lane that wants a row (its lowest row)
    unsigned w = want;
    for (int i = 0; i < grp && w; ++i) w &= w - 1;
    const bool busy = w != 0;
    const int owner = busy ? __ffs(w) - 1 : lane;
    Ray q;
    q.ox = __shfl_sync(kFullMask, r.ox, owner);
    q.oy = __shfl_sync(kFullMask, r.oy, owner);
    q.oz = __shfl_sync(kFullMask, r.oz, owner);
    q.dx = __shfl_sync(kFullMask, r.dx, owner);
    q.dy = __shfl_sync(kFullMask, r.dy, owner);
    q.dz = __shfl_sync(kFullMask, r.dz, owner);
    const float bt_row = __shfl_sync(kFullMask, bt, owner);
    const int rr = __shfl_sync(kFullMask, __ffs(todo) - 1, owner);
    bool occ = false;
    float ct = bt_row, cu = 0.f, cv = 0.f, cs = 0.f;
    int cj = kTrisPerRow;  // none
    if (busy) {
      const float* row = rows + rr * kLanesPerRow;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int j = sub + kTriLanes * i;
        const float2* p =
            reinterpret_cast<const float2*>(row + kLanesPerTri * j);
        const float2 a = p[0], b = p[1], c = p[2], d = p[3], e = p[4];
        const float t[kLanesPerTri] = {a.x, a.y, b.x, b.y, c.x,
                                       c.y, d.x, d.y, e.x, e.y};
        tri_test<kLean>(t, q, j, bt_row, occ, ct, cj, cu, cv, cs);
      }
    }
    // each served lane takes its group's result for its row
    const int rank = __popc(want & ((1u << lane) - 1));
    const bool served = todo != 0 && rank < kPairs;
    if (kLean) {
      const unsigned hits = __ballot_sync(kFullMask, occ);
      if (served) {
        if ((hits >> (rank * kTriLanes)) & ((1u << kTriLanes) - 1)) {
          bt = -1.f;
          bs = 0.f;
          todo = 0;
        } else {
          todo &= todo - 1;
        }
      }
    } else {
#pragma unroll
      for (int off = 1; off < kTriLanes; off <<= 1) {
        const float ot = __shfl_xor_sync(kFullMask, ct, off);
        const int oj = __shfl_xor_sync(kFullMask, cj, off);
        if (ot < ct || (ot == ct && oj < cj)) {
          ct = ot;
          cj = oj;
        }
      }
      const int from = served ? rank * kTriLanes : lane;
      const float rt = __shfl_sync(kFullMask, ct, from);
      const int rj = __shfl_sync(kFullMask, cj, from);
      const int win = served ? rank * kTriLanes + rj % kTriLanes : lane;
      const float ru = __shfl_sync(kFullMask, cu, win);
      const float rv = __shfl_sync(kFullMask, cv, win);
      const float rs = __shfl_sync(kFullMask, cs, win);
      bool fell = false;
      if (served) {
        todo &= todo - 1;
        if (rj < kTrisPerRow) {
          bt = rt;
          bu = ru;
          bv = rv;
          bs = rs;
          bi = inst;
          fell = true;
        }
      }
      // the lanes whose best t fell re-test their remaining rows with it
      // (the others get their own rows back: their best t is unchanged)
      if (__any_sync(kFullMask, fell)) todo = rows_reached(rows, r, bt, todo);
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

// What lane ``lane`` of warp 0 copies for group g: entry g * kEntries +
// lane's rows (its supercluster's children with kSc), or nothing (0
// bytes) past the group's end.
struct Fetch {
  const float* src;
  uint32_t bytes;
};

// The cluster (kSc: supercluster) id of entry word e.
template <int kSrc>
__device__ __forceinline__ int entry_id(int32_t e) {
  return (e & 0xFFFF) - (kSrc == kPairs ? 1 : 0);
}

template <bool kTwoLevel, bool kSc, int kSrc>
__device__ __forceinline__ Fetch group_fetch(
    int g, int lane, int n, const int32_t* __restrict__ ent,
    const float* __restrict__ tri_rows, const int32_t* __restrict__ pair_meta,
    const int32_t* __restrict__ sc_meta) {
  constexpr int kEntries = Walk<kTwoLevel, kSc>::kEntries;
  const int p = g * kEntries + lane;
  if (lane >= kEntries || p >= n) return {nullptr, 0u};
  int c = entry_id<kSrc>(ent[p]), nch = 1;
  if (kSc) {
    const int32_t v = sc_meta[c];
    c = v & 0xFFFF;
    nch = v >> 16;
  }
  return {tri_rows + cluster_row0<kTwoLevel>(c, pair_meta) * kLanesPerRow,
          static_cast<uint32_t>(nch * kClusterBytes)};
}

// Warp 0 starts group g's copies into ``stage``: lane 0 arms the stage's
// barrier with the group's bytes, then each lane copies its own entry's.
__device__ __forceinline__ void group_issue(const Fetch& f, int lane,
                                            float* stage, uint64_t* bar) {
  const uint32_t total = __reduce_add_sync(0xFFFFFFFFu, f.bytes);
  if (lane == 0) mbar_expect(bar, total);
  __syncwarp();
  if (f.bytes)
    bulk_copy(stage + lane * kClusterFloats, f.src, f.bytes, bar);
}

// The key of word p of K4's tile-major pair list: its tile x 4 plus its
// kind, 0 for its tile's sentinel (a first word of cluster field 0), 1
// for a real pair, 2 for a fill slot (cluster field 0 after the first
// word; fill slots close a launch chunk's last tile). In a tile's stretch
// of the list the sentinel comes first, then the real pairs, then any
// fill, so the key never falls along the list.
__device__ __forceinline__ int pair_key(const int32_t* __restrict__ pairs,
                                        int p) {
  const int32_t w = pairs[p];
  const int tile = w >> 16;
  int kind = 1;
  if ((w & 0xFFFF) == 0)
    kind = p > 0 && (pairs[p - 1] >> 16) == tile ? 2 : 0;
  return tile * 4 + kind;
}

// The first word of the list whose key is at least ``key`` (n_pairs if
// none): with tile * 4 + 1 the start of the tile's real pairs, with
// tile * 4 + 2 their end. The 32 lanes of a warp search together: each
// round cuts the range that holds the answer into 32 pieces and probes
// the last word of each, so a list of n words takes log32(n) rounds of
// loads (5 for the bunny's 2.9 M slots) where a binary search takes
// log2(n).
__device__ __forceinline__ int pair_bounds(const int32_t* __restrict__ pairs,
                                           int n_pairs, int key, int lane) {
  int lo = 0, hi = n_pairs;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int q = lo + (lane + 1) * step - 1;
    const unsigned ge = __ballot_sync(
        kFullMask, q >= hi || pair_key(pairs, q) >= key);
    if (ge == 0) return hi;
    const int j = __ffs(ge) - 1;  // the first piece whose last word is >=
    hi = min(hi, lo + (j + 1) * step - 1);
    lo += j * step;
  }
  return lo;
}

// Whether a ray is done with an entry at quantized distance deq: its best
// t is below it (a dead or lean-occluded ray has bt = -1), or, kOccluded,
// it holds a hit.
template <int kHit>
__device__ __forceinline__ bool done_at(float bt, float bs, float deq) {
  return bt < deq || (kHit == kOccluded && bs >= 0.f);
}

template <int kHit, bool kTwoLevel, bool kSc, int kSrc>
__global__ void __launch_bounds__(Walk<kTwoLevel, kSc>::kThreads,
                                  Walk<kTwoLevel, kSc>::kMinBlocks)
tileloop_kernel(const float* __restrict__ org,
                const float* __restrict__ dirn,
                const float* __restrict__ inv_d,
                const float* __restrict__ tmax,
                const float* __restrict__ tri_rows,
                const int32_t* __restrict__ entries,
                const int32_t* __restrict__ counts,
                const int32_t* __restrict__ seg_lo,
                const int32_t* __restrict__ seg_hi, int cp, float scale,
                const int32_t* __restrict__ pair_meta,
                const float* __restrict__ inv_xform,
                const int32_t* __restrict__ sc_meta,
                float* __restrict__ bt_out, float* __restrict__ bu_out,
                float* __restrict__ bv_out, float* __restrict__ bs_out,
                float* __restrict__ bi_out) {
  using W = Walk<kTwoLevel, kSc>;
  constexpr bool kLeanBody = kHit == kLean;
  extern __shared__ __align__(128) float ring[];  // kStages x kStageFloats
  __shared__ uint64_t full[kStages];
  __shared__ int seg[2];  // kPairs: the tile's real pairs

  const long tile = blockIdx.x / W::kSlices;
  const long ray = static_cast<long>(blockIdx.x) * W::kThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Ray w = load_ray(org, dirn, inv_d, ray);
  const float tm = tmax[ray];
  float bt = tm >= 0.f ? tm : -1.f;
  float bu = 0.f, bv = 0.f, bs = -1.f, bi = -1.f;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    mbar_fence_init();
  }
  // kPairs (cp is the list's length): warp 0 finds where the tile's real
  // pairs start, warp 1 where they end
  if (kSrc == kPairs && warp < 2) {
    const int key = static_cast<int>(tile) * 4 + 1 + warp;
    const int b = pair_bounds(entries, cp, key, lane);
    if (lane == 0) seg[warp] = b;
  }
  __syncthreads();
  const int e0p = kSrc == kRows ? 0 : kSrc == kSeg ? seg_lo[tile] : seg[0];
  const int n = kSrc == kRows   ? counts[tile]
                : kSrc == kSeg ? seg_hi[tile] - e0p
                               : seg[1] - e0p;
  const int32_t* ent = kSrc == kRows ? entries + tile * cp : entries + e0p;
  const int n_groups = (n + W::kEntries - 1) / W::kEntries;
  if (warp == 0) {
    for (int h = 0; h < kStages - 1 && h < n_groups; ++h)
      group_issue(group_fetch<kTwoLevel, kSc, kSrc>(h, lane, n, ent,
                                                    tri_rows, pair_meta,
                                                    sc_meta),
                  lane, ring + h * W::kStageFloats, &full[h]);
  }

  int32_t e_next = n > 0 ? ent[0] : 0;
  int g = 0;
  for (; g < n_groups; ++g) {
    const int32_t e0 = e_next;  // the group's first (nearest) entry
    if (g + 1 < n_groups) e_next = ent[(g + 1) * W::kEntries];
    const float deq0 = static_cast<float>(e0 >> 16) * scale;
    // what this iteration fetches, read before the vote
    const int gf = g + kStages - 1;
    Fetch f = {nullptr, 0u};
    if (warp == 0 && gf < n_groups)
      f = group_fetch<kTwoLevel, kSc, kSrc>(gf, lane, n, ent, tri_rows,
                                            pair_meta, sc_meta);
    // far break (K4's any-hit: every ray occluded or dead); also the
    // point after which no thread reads group g - 1's stage, which group
    // gf takes over
    if (__syncthreads_and(done_at<kHit>(bt, bs, deq0))) break;
    if (warp == 0 && gf < n_groups)
      group_issue(f, lane, ring + (gf % kStages) * W::kStageFloats,
                  &full[gf % kStages]);
    // sorted: a ray done at deq0 is done with the whole group, and so is
    // a warp of such rays
    if (__all_sync(kFullMask, done_at<kHit>(bt, bs, deq0))) continue;
    mbar_wait(&full[g % kStages], (g / kStages) & 1);
    const float* stage = ring + (g % kStages) * W::kStageFloats;
    for (int q = 0; q < W::kEntries; ++q) {
      const int p = g * W::kEntries + q;
      if (p >= n) break;
      const int32_t e = q ? ent[p] : e0;
      const bool live =
          !done_at<kHit>(bt, bs, static_cast<float>(e >> 16) * scale);
      if (!__any_sync(kFullMask, live)) continue;
      const int id = entry_id<kSrc>(e);
      int c = id, nch = 1;  // first cluster and cluster count of the entry
      if (kSc) {
        const int32_t v = sc_meta[id];
        c = v & 0xFFFF;
        nch = v >> 16;
      }
      float inst;
      const Ray r = cluster_ray<kTwoLevel>(w, c, pair_meta, inv_xform, inst);
      for (int k = 0; k < nch; ++k) {
        // an occluded lane (bt = -1) reaches no box: it takes no part
        cluster_body<kLeanBody>(stage + (q + k) * kClusterFloats, r, inst,
                                live, bt, bu, bv, bs, bi);
        if (kLeanBody && __all_sync(kFullMask, bt < 0.f)) break;
      }
    }
  }
  // a block that broke early still owns the copies it issued ahead: wait
  // for them before its shared memory can pass to another block
  if (threadIdx.x == 0) {
    for (int h = g; h < g + kStages - 1 && h < n_groups; ++h)
      mbar_wait(&full[h % kStages], (h / kStages) & 1);
  }
  bt_out[ray] = bt;
  bu_out[ray] = bu;
  bv_out[ray] = bv;
  bs_out[ray] = bs;
  if (kTwoLevel) bi_out[ray] = bi;
}

// The K1 and K4 launches: every variant takes the same arguments.
struct Launch {
  const float *org, *dirn, *inv_d, *tmax, *tri_rows;
  const int32_t *entries, *counts, *seg_lo, *seg_hi;
  int n_tiles, cp;  // cp: the entry rows' width; kPairs: the list's length
  float scale;
  const int32_t* pair_meta;
  const float* inv_xform;
  const int32_t* sc_meta;
  float *bt, *bu, *bv, *bs, *bi;
  cudaStream_t stream;
};

template <int kHit, bool kTwoLevel, bool kSc, int kSrc>
void launch(const Launch& a) {
  using W = Walk<kTwoLevel, kSc>;
  const auto kernel = tileloop_kernel<kHit, kTwoLevel, kSc, kSrc>;
  // once per variant: the ring may pass the 48 KB a launch gets by
  // default (with the barriers' static bytes); a refusal shows as the
  // launch's error
  static const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::kSmemBytes);
  (void)set;
  kernel<<<a.n_tiles * W::kSlices, W::kThreads, W::kSmemBytes, a.stream>>>(
      a.org, a.dirn, a.inv_d, a.tmax, a.tri_rows, a.entries, a.counts,
      a.seg_lo, a.seg_hi, a.cp, a.scale, a.pair_meta, a.inv_xform,
      a.sc_meta, a.bt, a.bu, a.bv, a.bs, a.bi);
}

// K1's entry sources as template arguments: supercluster entry rows,
// segments, or cluster entry rows.
template <int kHit, bool kTwoLevel>
void launch_entries(bool sc, bool seg, const Launch& a) {
  if (sc)
    launch<kHit, kTwoLevel, true, kRows>(a);
  else if (seg)
    launch<kHit, kTwoLevel, false, kSeg>(a);
  else
    launch<kHit, kTwoLevel, false, kRows>(a);
}

template <int kHit>
void launch_mode(bool two_level, bool sc, bool seg, const Launch& a) {
  if (two_level)
    launch_entries<kHit, true>(sc, seg, a);
  else
    launch_entries<kHit, false>(sc, seg, a);
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
// org/dirn/inv_d: (n_tiles*1024, 3) f32, tmax: (n_tiles*1024,) f32
// (< 0 = dead lane), tri_rows: (R, 128) f32 with 8 rows per cluster,
// 16-byte aligned (the rows are fetched by bulk copies).
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
  const bool two_level = pair_meta != nullptr;
  const bool sc = sc_meta != nullptr;
  const bool seg = off != nullptr;
  if (sc && seg) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tri_rows) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Launch a = {org, dirn, inv_d, tmax, tri_rows, entries, counts,
                    off, seg ? off + 1 : nullptr, n_tiles, cp, scale,
                    pair_meta, inv_xform, sc_meta, bt, bu, bv, bs, bi,
                    static_cast<cudaStream_t>(stream)};
  if (lean)
    launch_mode<kLean>(two_level, sc, seg, a);
  else
    launch_mode<kClosest>(two_level, sc, seg, a);
  return static_cast<int>(cudaGetLastError());
}

// The grid over pairs (K4: the Hopper port of the TPU kernel
// tpurt/kernels/tilewave.py::_tile_kernel, launchers _trace_tiles and
// _launch_tiles) on ``stream``; returns cudaGetLastError(). Rays and
// tables as tpurt_tileloop; pairs (n_pairs,) i32 the tile-major list
// tile << 16 | (cluster + 1), tiles numbered from 0 in this launch, each
// tile's sentinel (cluster -1) first, then its clusters, and fill slots
// (cluster -1) after a launch chunk's last tile. The TPU grid runs one
// step per pair and folds it into its tile's output block; here K1's walk
// takes each tile's real pairs as its entries at distance 0. Closest
// keeps the strict-'<' fold in pair, row and lane order; any-hit runs the
// same closest body and a ray stops once it holds a hit (the reference
// ends a tile once all of its rays do), so only bs >= 0 is the any-hit
// result.
extern "C" int tpurt_tilegrid(const float* org, const float* dirn,
                              const float* inv_d, const float* tmax,
                              const float* tri_rows, const int32_t* pairs,
                              int n_pairs, int n_tiles, int any_hit,
                              const int32_t* pair_meta,
                              const float* inv_xform, float* bt, float* bu,
                              float* bv, float* bs, float* bi,
                              void* stream) {
  if (n_tiles <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(tri_rows) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Launch a = {org, dirn, inv_d, tmax, tri_rows, pairs, nullptr,
                    nullptr, nullptr, n_tiles, n_pairs, 0.f, pair_meta,
                    inv_xform, nullptr, bt, bu, bv, bs, bi,
                    static_cast<cudaStream_t>(stream)};
  const bool two_level = pair_meta != nullptr;
  if (any_hit && two_level)
    launch<kOccluded, true, false, kPairs>(a);
  else if (any_hit)
    launch<kOccluded, false, false, kPairs>(a);
  else if (two_level)
    launch<kClosest, true, false, kPairs>(a);
  else
    launch<kClosest, false, false, kPairs>(a);
  return static_cast<int>(cudaGetLastError());
}
