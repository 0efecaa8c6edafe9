// Packet-BVH traversal: the Hopper port of the TPU kernel
// tpurt/kernels/packet.py::_packet_kernel (launcher _trace), closest-hit
// and any-hit.
//
// The tree is the reference's preorder median-split BVH over leaf row
// groups with skip links (tpurt_torch/bvh/cluster.py): node k has an AABB,
// ``count`` > 0 rows [first, first + count) of 12 packed triangles when it
// is a leaf, and ``skip`` (the next node once k's subtree is done). The
// wrapper packs each node, once per accel, into two 16-byte words:
// (bmin.xyz, skip) and (bmax.xyz, first << kCountBits | count), the ints
// as their bit patterns, so a node step is two vector loads.
//
// The TPU kernel walks a 2048-ray packet behind ONE scalar node pointer and
// enters a subtree when ANY ray of the packet hits its box: that lockstep is
// what a machine without per-lane gathers needs. Here every lane walks its
// own ray: stackless, in preorder, entering a node when its own ray hits the
// node box (slab test far-limited by its own best t). The packet visits a
// superset of the nodes a ray visits, in the same order, so the per-ray
// result is the same up to slab-test rounding at grazing boxes.
//
// Per ray, the contract of the TPU kernel: dead lanes (tmax < 0) start at
// bt = -1 and never hit; a leaf row's 12 Moller-Trumbore candidates
// (t = 3.4e38 where the test fails) reduce to the first one at the
// minimal t (the reference's min-tree with take_b = tb < ta), which wins
// against the running best with a strict '<'. Closest-hit keeps (t, u, v,
// slot); any-hit records the slot and sets bt = -1 on the first win, then
// stops walking, and bt is normalised to 0 (occluded) or 3.4e38 at the end.
// The slot comes back as f32, as the reference returns it.
//
// Counters: per 2048-ray group (the reference's packet), the sum over the
// group's rays of node steps and of leaf rows tested. The reference counts
// the steps of the packet's one walk; these are per-ray walks summed, a
// different quantity with the same name.
//
// The walk of a warp. Each iteration, every walking lane takes one node
// step; the lanes whose node is a leaf their ray enters then have its rows
// to test before their next step. A lane testing its own rows runs 12
// triangle tests a row while the warp's other lanes wait, so where the
// warp's leaf rows are few (chosen from the rounds the shared rows would
// take, at kShareCost one lane's triangle tests a round, against the most
// rows one lane has), the warp shares them out:
// each round, groups of kRowLanes lanes take the next row of the list of
// every lane's rows in lane and row order, each lane testing 12 /
// kRowLanes of the row's triangles against the owner's ray; the group
// folds the row to its first candidate at the minimal t (the first
// minimum of (t, triangle)), which is the row's sequential fold, and the
// owner applies its rows' results in row order with strict '<'. So every
// ray visits the same nodes and tests the same rows in the same order,
// against the same best t, as its walk alone: the outputs and counters do
// not depend on the warp. (Lanes that take new rays from a counter once
// their walk ends, and the whole tree in shared memory, were measured
// slower on the H100: PERF.md §6.)
//
// What bounds it on this card: the dependent walk (node load -> box test
// -> next node) and the divergence of the 32 walks of a warp: a warp
// steps until its longest walk ends.
//
// Built with -fmad=false and IEEE division, matching the plain version's
// op order term for term.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;          // threads a block
constexpr int kPacket = 2048;        // rays per counter group
constexpr int kLanesPerRow = 128;
constexpr int kTrisPerRow = 12;
constexpr int kLanesPerTri = 10;
constexpr int kCountBits = 8;        // node word 7: first << 8 | count
constexpr float kBig = 3.4e38f;
constexpr float kEpsDenom = 1e-12f;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// The walk's shape (the note above).
constexpr int kRowLanes = 4;         // lanes sharing one row's tests
constexpr int kShareCost = 6;        // a shared round against this many of
                                     // one lane's triangle tests

constexpr int kRowsARound = 32 / kRowLanes;
constexpr int kPerLane = kTrisPerRow / kRowLanes;
static_assert(kTrisPerRow % kRowLanes == 0 && 32 % kRowLanes == 0,
              "a row's triangles split evenly over a group of lanes");
static_assert(kPacket % kBlock == 0, "a block's rays lie in one group");

// 1 / d with the sign-preserving clamp away from 0 of the reference.
__device__ __forceinline__ float safe_inv(float d) {
  return 1.f / (fabsf(d) < 1e-12f ? (d >= 0.f ? 1e-12f : -1e-12f) : d);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;  // the ray
  float ivx, ivy, ivz, oix, oiy, oiz;  // 1/d and o/d for the box tests
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ org,
                                        const float* __restrict__ dirn,
                                        long i) {
  Ray r;
  r.ox = org[3 * i + 0];
  r.oy = org[3 * i + 1];
  r.oz = org[3 * i + 2];
  r.dx = dirn[3 * i + 0];
  r.dy = dirn[3 * i + 1];
  r.dz = dirn[3 * i + 2];
  r.ivx = safe_inv(r.dx);
  r.ivy = safe_inv(r.dy);
  r.ivz = safe_inv(r.dz);
  r.oix = r.ox * r.ivx;
  r.oiy = r.oy * r.ivy;
  r.oiz = r.oz * r.ivz;
  return r;
}

// One Moller-Trumbore test of the triangle (v0, e1, e2): its candidate t
// (kBig where the test fails) and u, v.
__device__ __forceinline__ float tri_test(float v0x, float v0y, float v0z,
                                          float e1x, float e1y, float e1z,
                                          float e2x, float e2y, float e2z,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float& u, float& v) {
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok_det = fabsf(det) > kEpsDenom;
  const float inv = 1.f / (ok_det ? det : 1.f);
  const float tx = ox - v0x;
  const float ty = oy - v0y;
  const float tz = oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (dx * qx + dy * qy + dz * qz) * inv;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  const bool ok = ok_det && u >= 0.f && v >= 0.f && u + v <= 1.f && t > 0.f;
  return ok ? t : kBig;
}

// A row's 12 tests by one lane (five float4 reads a triangle pair): the
// first candidate at the minimal t, with its u, v and slot.
__device__ __forceinline__ void row_fold(const float* __restrict__ row,
                                         const Ray& r, float& rt, float& ru,
                                         float& rv, float& rs) {
  const float4* q = reinterpret_cast<const float4*>(row);
#pragma unroll 2
  for (int j = 0; j < kTrisPerRow / 2; ++j) {
    const float4 a = __ldg(q + 5 * j), b = __ldg(q + 5 * j + 1);
    const float4 c = __ldg(q + 5 * j + 2), d = __ldg(q + 5 * j + 3);
    const float4 e = __ldg(q + 5 * j + 4);
    float u, v;
    float tc = tri_test(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, r.ox,
                        r.oy, r.oz, r.dx, r.dy, r.dz, u, v);
    if (j == 0 || tc < rt) {  // the first candidate at the minimum
      rt = tc;
      ru = u;
      rv = v;
      rs = c.y;
    }
    tc = tri_test(c.z, c.w, d.x, d.y, d.z, d.w, e.x, e.y, e.z, r.ox, r.oy,
                  r.oz, r.dx, r.dy, r.dz, u, v);
    if (tc < rt) {
      rt = tc;
      ru = u;
      rv = v;
      rs = e.w;
    }
  }
}

// A row's result against the lane's best: strict '<'; any-hit records the
// slot and retires the lane (bt = -1).
template <bool kAny>
__device__ __forceinline__ void take_row(float rt, float ru, float rv,
                                         float rs, float& bt, float& bu,
                                         float& bv, float& bs) {
  if (rt < bt) {
    bs = rs;
    if (kAny) {
      bt = -1.f;
    } else {
      bt = rt;
      bu = ru;
      bv = rv;
    }
  }
}

// The warp's leaf rows of this step: lane L has rows [first, first + cnt)
// of tri_rows to test for its ray (cnt = 0: none). Every lane of the warp
// calls it together; ``buf`` is the warp's kRowsARound x 4 floats of
// shared memory.
template <bool kAny>
__device__ __forceinline__ void leaf_rows(const float* __restrict__ tri_rows,
                                          const Ray& r, int first, int cnt,
                                          float* buf, float& bt, float& bu,
                                          float& bv, float& bs) {
  const int lane = threadIdx.x & 31;
  if (!__any_sync(kFullMask, cnt > 0)) return;
  // inclusive prefix of the row counts over the lanes
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += o;
  }
  const int total = __shfl_sync(kFullMask, incl, 31);
  const int rounds = (total + kRowsARound - 1) / kRowsARound;
  if (rounds * kShareCost >=
      static_cast<int>(__reduce_max_sync(kFullMask, cnt)) * kTrisPerRow) {
    for (int k = 0; k < cnt; ++k) {
      float rt = kBig, ru = 0.f, rv = 0.f, rs = -1.f;
      row_fold(tri_rows + static_cast<long>(first + k) * kLanesPerRow, r,
               rt, ru, rv, rs);
      take_row<kAny>(rt, ru, rv, rs, bt, bu, bv, bs);
      if (kAny && bt < 0.f) break;
    }
    return;
  }
  const int grp = lane / kRowLanes, sub = lane % kRowLanes;
  const int excl = incl - cnt;
  for (int base = 0; base < total; base += kRowsARound) {
    // group grp takes row i of the warp's list: the owner is the number
    // of lanes whose rows all come before it
    const int i = base + grp;
    int owner = 0;
#pragma unroll
    for (int step = 16; step; step >>= 1)
      if (__shfl_sync(kFullMask, incl, owner + step - 1) <= i) owner += step;
    const int row = __shfl_sync(kFullMask, first, owner) + i -
                    __shfl_sync(kFullMask, excl, owner);
    const float ox = __shfl_sync(kFullMask, r.ox, owner);
    const float oy = __shfl_sync(kFullMask, r.oy, owner);
    const float oz = __shfl_sync(kFullMask, r.oz, owner);
    const float dx = __shfl_sync(kFullMask, r.dx, owner);
    const float dy = __shfl_sync(kFullMask, r.dy, owner);
    const float dz = __shfl_sync(kFullMask, r.dz, owner);
    float ct = kBig, cu = 0.f, cv = 0.f, cs = -1.f;
    int cj = 0;
    if (i < total) {
      const float* rp = tri_rows + static_cast<long>(row) * kLanesPerRow;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int j = sub + kRowLanes * k;
        const float2* p =
            reinterpret_cast<const float2*>(rp + kLanesPerTri * j);
        const float2 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
        const float2 d = __ldg(p + 3), e = __ldg(p + 4);
        float u, v;
        const float tc = tri_test(a.x, a.y, b.x, b.y, c.x, c.y, d.x, d.y,
                                  e.x, ox, oy, oz, dx, dy, dz, u, v);
        if (k == 0 || tc < ct) {
          ct = tc;
          cj = j;
          cu = u;
          cv = v;
          cs = e.y;
        }
      }
    }
    // the group's first minimum of (t, triangle)
#pragma unroll
    for (int off = 1; off < kRowLanes; off <<= 1) {
      const float ot = __shfl_xor_sync(kFullMask, ct, off);
      const int oj = __shfl_xor_sync(kFullMask, cj, off);
      if (ot < ct || (ot == ct && oj < cj)) {
        ct = ot;
        cj = oj;
      }
    }
    const int win = grp * kRowLanes + cj % kRowLanes;
    const float ru = __shfl_sync(kFullMask, cu, win);
    const float rv = __shfl_sync(kFullMask, cv, win);
    const float rs = __shfl_sync(kFullMask, cs, win);
    if (sub == 0 && i < total) {
      float* b = buf + 4 * grp;
      b[0] = ct;
      b[1] = ru;
      b[2] = rv;
      b[3] = rs;
    }
    __syncwarp();
    // each owner takes its rows of this round, in row order
    const int lo = max(excl, base), hi = min(incl, base + kRowsARound);
    for (int k = lo; k < hi; ++k) {
      const float* b = buf + 4 * (k - base);
      take_row<kAny>(b[0], b[1], b[2], b[3], bt, bu, bv, bs);
    }
    __syncwarp();
  }
}

template <bool kAny>
__global__ void __launch_bounds__(kBlock)
packet_kernel(const float4* __restrict__ nodes, int n_nodes,
              const float* __restrict__ tri_rows,
              const float* __restrict__ org, const float* __restrict__ dirn,
              const float* __restrict__ tmax, float* __restrict__ bt_out,
              float* __restrict__ bu_out, float* __restrict__ bv_out,
              float* __restrict__ bs_out, int32_t* __restrict__ stats) {
  __shared__ float bufs[kBlock / 32][kRowsARound * 4];
  float* buf = bufs[threadIdx.x >> 5];
  const long ray = static_cast<long>(blockIdx.x) * kBlock + threadIdx.x;
  const Ray r = load_ray(org, dirn, ray);
  const float tm = tmax[ray];
  float bt = tm >= 0.f ? tm : -1.f;
  float bu = 0.f, bv = 0.f, bs = -1.f;
  int node = 0, steps = 0, rows = 0;
  bool walking = true;
  while (__any_sync(kFullMask, walking)) {
    // one node step for every walking lane
    int first = 0, cnt = 0, next = 0;
    if (walking) {
      ++steps;
      const float4 a = __ldg(nodes + 2 * node);
      const float4 b = __ldg(nodes + 2 * node + 1);
      const float t0x = a.x * r.ivx - r.oix;
      const float t1x = b.x * r.ivx - r.oix;
      const float t0y = a.y * r.ivy - r.oiy;
      const float t1y = b.y * r.ivy - r.oiy;
      const float t0z = a.z * r.ivz - r.oiz;
      const float t1z = b.z * r.ivz - r.oiz;
      const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fmaxf(fminf(t0z, t1z), 0.f));
      const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fminf(fmaxf(t0z, t1z), bt));
      const int fc = __float_as_int(b.w);
      const int c = fc & ((1 << kCountBits) - 1);
      if (tn <= tf && c == 0) {
        next = node + 1;  // internal node: descend
      } else {
        next = __float_as_int(a.w);
        if (tn <= tf) {  // leaf: its rows
          rows += c;
          first = static_cast<int>(static_cast<unsigned>(fc) >> kCountBits);
          cnt = c;
        }
      }
    }
    leaf_rows<kAny>(tri_rows, r, first, cnt, buf, bt, bu, bv, bs);
    if (walking) {
      node = next;
      walking = node < n_nodes && !(kAny && bt < 0.f);
    }
  }
  if (kAny) bt = bs >= 0.f ? 0.f : kBig;
  bt_out[ray] = bt;
  bu_out[ray] = bu;
  bv_out[ray] = bv;
  bs_out[ray] = bs;
  // group counters: a warp's rays lie in one group
  steps = __reduce_add_sync(kFullMask, steps);
  rows = __reduce_add_sync(kFullMask, rows);
  if ((threadIdx.x & 31) == 0) {
    const long g = ray / kPacket;
    atomicAdd(stats + 2 * g, steps);
    atomicAdd(stats + 2 * g + 1, rows);
  }
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
// nodes (n_nodes, 8) f32: per node bmin.xyz, skip (int bits), bmax.xyz,
// first << 8 | count (int bits), 16-byte aligned; tri_rows (R, 128) f32;
// org/dirn (n, 3) f32, tmax (n,) f32 (< 0 = dead lane), n a multiple of
// 2048. Outputs: bt/bu/bv/bs (n,) f32 and stats (n / 2048, 2) i32, which
// the caller zeroes (steps, leaf rows).
extern "C" int tpurt_packet(const float* nodes, int n_nodes,
                            const float* tri_rows, const float* org,
                            const float* dirn, const float* tmax, long n,
                            int any_hit, float* bt, float* bu, float* bv,
                            float* bs, int32_t* stats, void* stream) {
  if (n <= 0) return 0;
  if (n % kPacket) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(nodes) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  const long blocks = n / kBlock;
  if (any_hit)
    packet_kernel<true><<<blocks, kBlock, 0, s>>>(
        nd, n_nodes, tri_rows, org, dirn, tmax, bt, bu, bv, bs, stats);
  else
    packet_kernel<false><<<blocks, kBlock, 0, s>>>(
        nd, n_nodes, tri_rows, org, dirn, tmax, bt, bu, bv, bs, stats);
  return static_cast<int>(cudaGetLastError());
}
