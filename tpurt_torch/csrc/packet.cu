// Packet-BVH traversal: the Hopper port of the TPU kernel
// tpurt/kernels/packet.py::_packet_kernel (launcher _trace), closest-hit
// and any-hit.
//
// The tree is the reference's preorder median-split BVH over leaf row
// groups with skip links (tpurt_torch/bvh/cluster.py): node k has an AABB,
// ``count`` > 0 rows [first, first + count) of 12 packed triangles when it
// is a leaf, and ``skip`` (the next node once k's subtree is done).
//
// The TPU kernel walks a 2048-ray packet behind ONE scalar node pointer and
// enters a subtree when ANY ray of the packet hits its box: that lockstep is
// what a machine without per-lane gathers needs. Here every thread walks its
// own ray: stackless, in preorder, entering a node when its own ray hits the
// node box (slab test far-limited by its own best t), node scalars through
// the read-only cache. The packet visits a superset of the nodes a ray
// visits, in the same order, so the per-ray result is the same up to
// slab-test rounding at grazing boxes.
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
// What bounds it on this card: latency of the dependent walk (node load ->
// box test -> next pointer) and divergence between the 32 rays of a warp,
// whose walks differ in length and in which leaves they test. The simple
// design keeps no stack and no shared memory (128 threads a block, node
// and row loads through the read-only cache); warp-coherent descent,
// node-array packing and ray reordering by warp are later work.
//
// Built with -fmad=false and IEEE division, matching the plain version's
// op order term for term.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 2048;      // rays per counter group
constexpr int kLanesPerRow = 128;
constexpr int kTrisPerRow = 12;
constexpr int kLanesPerTri = 10;
constexpr float kBig = 3.4e38f;
constexpr float kEpsDenom = 1e-12f;

// 1 / d with the sign-preserving clamp away from 0 of the reference.
__device__ __forceinline__ float safe_inv(float d) {
  return 1.f / (fabsf(d) < 1e-12f ? (d >= 0.f ? 1e-12f : -1e-12f) : d);
}

template <bool kAny>
__global__ void __launch_bounds__(kThreads)
packet_kernel(const float* __restrict__ bminx, const float* __restrict__ bminy,
              const float* __restrict__ bminz, const float* __restrict__ bmaxx,
              const float* __restrict__ bmaxy, const float* __restrict__ bmaxz,
              const int32_t* __restrict__ first,
              const int32_t* __restrict__ count,
              const int32_t* __restrict__ skip, int n_nodes,
              const float* __restrict__ tri_rows,
              const float* __restrict__ org, const float* __restrict__ dirn,
              const float* __restrict__ tmax, float* __restrict__ bt_out,
              float* __restrict__ bu_out, float* __restrict__ bv_out,
              float* __restrict__ bs_out, int32_t* __restrict__ stats) {
  const long i = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  const float ox = org[3 * i + 0], oy = org[3 * i + 1], oz = org[3 * i + 2];
  const float dx = dirn[3 * i + 0], dy = dirn[3 * i + 1],
              dz = dirn[3 * i + 2];
  const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
  const float oix = ox * ivx, oiy = oy * ivy, oiz = oz * ivz;
  const float tm = tmax[i];
  float bt = tm >= 0.f ? tm : -1.f;
  float bu = 0.f, bv = 0.f, bs = -1.f;
  int node = 0, steps = 0, rows = 0;
  while (node < n_nodes) {
    ++steps;
    const float t0x = __ldg(bminx + node) * ivx - oix;
    const float t1x = __ldg(bmaxx + node) * ivx - oix;
    const float t0y = __ldg(bminy + node) * ivy - oiy;
    const float t1y = __ldg(bmaxy + node) * ivy - oiy;
    const float t0z = __ldg(bminz + node) * ivz - oiz;
    const float t1z = __ldg(bmaxz + node) * ivz - oiz;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fmaxf(fminf(t0z, t1z), 0.f));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fminf(fmaxf(t0z, t1z), bt));
    const int cnt = __ldg(count + node);
    if (tn <= tf && cnt == 0) {
      node = node + 1;  // internal node: descend
      continue;
    }
    if (tn <= tf) {  // leaf: test its rows
      rows += cnt;
      const float* row = tri_rows +
                         static_cast<long>(__ldg(first + node)) * kLanesPerRow;
      for (int r = 0; r < cnt; ++r, row += kLanesPerRow) {
        float rt = kBig, ru = 0.f, rv = 0.f, rs = -1.f;
        for (int j = 0; j < kTrisPerRow; ++j) {
          const float* tri = row + j * kLanesPerTri;
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
          const float tc = ok ? t : kBig;
          if (j == 0 || tc < rt) {  // the first candidate at the minimum
            rt = tc;
            ru = u;
            rv = v;
            rs = __ldg(tri + 9);
          }
        }
        if (rt < bt) {
          bs = rs;
          if (kAny) {
            bt = -1.f;  // occluded: the lane is done
            break;
          }
          bt = rt;
          bu = ru;
          bv = rv;
        }
      }
    }
    node = __ldg(skip + node);
    if (kAny && bt < 0.f) break;
  }
  if (kAny) bt = bs >= 0.f ? 0.f : kBig;
  bt_out[i] = bt;
  bu_out[i] = bu;
  bv_out[i] = bv;
  bs_out[i] = bs;
  // group counters: a warp lies in one group (2048 is a multiple of 32)
  steps = __reduce_add_sync(0xffffffffu, steps);
  rows = __reduce_add_sync(0xffffffffu, rows);
  if ((threadIdx.x & 31) == 0) {
    const long g = i / kGroup;
    atomicAdd(stats + 2 * g, steps);
    atomicAdd(stats + 2 * g + 1, rows);
  }
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
// Node tables: bmin/bmax xyz (n_nodes,) f32, first/count/skip (n_nodes,)
// i32; tri_rows (R, 128) f32; org/dirn (n, 3) f32, tmax (n,) f32 (< 0 =
// dead lane), n a multiple of 2048. Outputs: bt/bu/bv/bs (n,) f32 and
// stats (n / 2048, 2) i32, which the caller zeroes (steps, leaf rows).
extern "C" int tpurt_packet(const float* bminx, const float* bminy,
                            const float* bminz, const float* bmaxx,
                            const float* bmaxy, const float* bmaxz,
                            const int32_t* first, const int32_t* count,
                            const int32_t* skip, int n_nodes,
                            const float* tri_rows, const float* org,
                            const float* dirn, const float* tmax, int n,
                            int any_hit, float* bt, float* bu, float* bv,
                            float* bs, int32_t* stats, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = n / kThreads;
  if (any_hit)
    packet_kernel<true><<<blocks, kThreads, 0, s>>>(
        bminx, bminy, bminz, bmaxx, bmaxy, bmaxz, first, count, skip,
        n_nodes, tri_rows, org, dirn, tmax, bt, bu, bv, bs, stats);
  else
    packet_kernel<false><<<blocks, kThreads, 0, s>>>(
        bminx, bminy, bminz, bmaxx, bmaxy, bmaxz, first, count, skip,
        n_nodes, tri_rows, org, dirn, tmax, bt, bu, bv, bs, stats);
  return static_cast<int>(cudaGetLastError());
}
