// Host library: the pair-cluster accel's kd-SAH triangle order
// (tpurt_torch/bvh/paircluster.py: kd_cluster_order with sah=True and
// hier_cluster_order), the same permutation as the numpy recursion there,
// which stays as its twin.
//
// Every step is the twin's, in the twin's arithmetic, so the order is
// byte-equal to it:
//   * centroids (v0 + v1 + v2) / 3 and the triangle boxes in float32, then
//     widened to double;
//   * each node sorts its triangles by centroid on each axis with a stable
//     sort (numpy's argsort kind="stable": ties keep the node's order);
//   * the SAH cost area(L) * nL + area(R) * nR in double, summed left to
//     right as numpy does (build with -ffp-contract=off: no fused
//     multiply-adds); the first strictly cheaper candidate wins, axes
//     0..2, candidate counts ascending;
//   * leaves come out in the twin's stack order (right child first);
//   * clusters are ordered by the Morton code of their mean centroid (the
//     mean a sequential double sum over the cluster, as numpy's mean over
//     axis 0), then rows within clusters by a nested kd-SAH of 12, and
//     rows of 12 by Morton code, all in float32 as cluster._morton.
// Independent subtrees, axes and clusters run on up to n_threads threads;
// the result does not depend on the count.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -ffp-contract=off -pthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <functional>
#include <future>
#include <thread>
#include <vector>

namespace {

using Ids = std::vector<int64_t>;

struct Tris {
  std::vector<double> c, lo, hi;  // (n, 3) centroid, box min, box max
};

constexpr int kRow = 12;              // triangles a row
constexpr size_t kParallelNode = 1 << 15;  // nodes this big split in tasks

struct KV {
  double k;
  int64_t i;
};

uint32_t expand_bits(uint32_t v) {
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

// cluster._morton of one float32 point in the float32 box [lo, hi]
uint32_t morton(const float c[3], const float lo[3], const float hi[3]) {
  uint32_t g[3];
  for (int a = 0; a < 3; ++a) {
    float ext = hi[a] - lo[a];
    float den = ext > 1e-12f ? ext : 1e-12f;
    float q = (c[a] - lo[a]) / den;
    q = q > 0.0f ? q : 0.0f;
    q = q < 1.0f ? q : 1.0f;
    uint32_t v = static_cast<uint32_t>(q * 1024.0f);
    g[a] = v < 1023u ? v : 1023u;
  }
  return (expand_bits(g[0]) << 2) | (expand_bits(g[1]) << 1) |
         expand_bits(g[2]);
}

void parallel_for(int64_t n, int threads, const std::function<void(int64_t)>& fn) {
  if (threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next{0};
  auto work = [&]() {
    for (int64_t i = next++; i < n; i = next++) fn(i);
  };
  std::vector<std::thread> pool;
  int t = static_cast<int>(std::min<int64_t>(threads, n));
  for (int k = 1; k < t; ++k) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
}

double area(const double lo[3], const double hi[3]) {
  double d[3];
  for (int a = 0; a < 3; ++a) {
    double e = hi[a] - lo[a];
    d[a] = e > 0.0 ? e : 0.0;
  }
  return d[0] * d[1] + d[1] * d[2] + d[2] * d[0];
}

// s sorted stably by centroid coordinate ax
Ids sorted_on(const Tris& t, const Ids& s, int ax) {
  std::vector<KV> kv(s.size());
  for (size_t j = 0; j < s.size(); ++j) kv[j] = {t.c[3 * s[j] + ax], s[j]};
  std::stable_sort(kv.begin(), kv.end(),
                   [](const KV& a, const KV& b) { return a.k < b.k; });
  Ids so(s.size());
  for (size_t j = 0; j < s.size(); ++j) so[j] = kv[j].i;
  return so;
}

struct Best {
  bool found = false;
  double cost = 0.0;
  size_t k = 0;
  Ids so;
};

// the candidates of one axis, folded into best in the twin's order
void scan_axis(const Tris& t, Ids so, size_t size,
               const std::vector<int64_t>& cands, Best& best) {
  const size_t n = so.size();
  // prefix boxes at k - 1 and suffix boxes at k, for each candidate k
  std::vector<size_t> ks;
  for (int64_t m : cands) {
    size_t k = static_cast<size_t>(m) * size;
    if (k < n) ks.push_back(k);
  }
  std::vector<double> pre(ks.size() * 6), suf(ks.size() * 6);
  double lo[3], hi[3];
  for (int a = 0; a < 3; ++a) { lo[a] = INFINITY; hi[a] = -INFINITY; }
  size_t q = 0;
  for (size_t j = 0; j < n && q < ks.size(); ++j) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], t.lo[3 * so[j] + a]);
      hi[a] = std::max(hi[a], t.hi[3 * so[j] + a]);
    }
    while (q < ks.size() && ks[q] - 1 == j) {
      for (int a = 0; a < 3; ++a) { pre[6 * q + a] = lo[a]; pre[6 * q + 3 + a] = hi[a]; }
      ++q;
    }
  }
  for (int a = 0; a < 3; ++a) { lo[a] = INFINITY; hi[a] = -INFINITY; }
  int64_t r = static_cast<int64_t>(ks.size()) - 1;
  for (size_t j = n; j-- > 0 && r >= 0;) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], t.lo[3 * so[j] + a]);
      hi[a] = std::max(hi[a], t.hi[3 * so[j] + a]);
    }
    while (r >= 0 && ks[r] == j) {
      for (int a = 0; a < 3; ++a) { suf[6 * r + a] = lo[a]; suf[6 * r + 3 + a] = hi[a]; }
      --r;
    }
  }
  bool improved = false;
  for (size_t c = 0; c < ks.size(); ++c) {
    const size_t k = ks[c];
    double cost = area(&pre[6 * c], &pre[6 * c + 3]) * static_cast<double>(k) +
                  area(&suf[6 * c], &suf[6 * c + 3]) * static_cast<double>(n - k);
    if (!best.found || cost < best.cost) {
      best.found = true;
      best.cost = cost;
      best.k = k;
      improved = true;
    }
  }
  if (improved) best.so = std::move(so);
}

// leaves of the node s, appended in the twin's stack order
bool split(const Tris& t, Ids s, size_t size, int threads,
           std::vector<Ids>& leaves) {
  if (s.size() <= size) {
    leaves.push_back(std::move(s));
    return true;
  }
  const size_t n = s.size();
  const int64_t n_cl = static_cast<int64_t>(n / size);
  const int64_t mid = std::max<int64_t>(
      1, static_cast<int64_t>(std::nearbyint(static_cast<double>(n_cl) / 2.0)));
  std::vector<int64_t> cands;
  for (int64_t d = -2; d <= 2; ++d)
    cands.push_back(std::max<int64_t>(1, std::min(n_cl, mid + d)));
  cands.erase(std::unique(cands.begin(), cands.end()), cands.end());

  Best best;
  const bool wide = threads > 1 && n >= kParallelNode;
  if (wide) {
    std::future<Ids> f[3];
    for (int ax = 0; ax < 3; ++ax)
      f[ax] = std::async(std::launch::async, sorted_on, std::cref(t),
                         std::cref(s), ax);
    for (int ax = 0; ax < 3; ++ax) scan_axis(t, f[ax].get(), size, cands, best);
  } else {
    for (int ax = 0; ax < 3; ++ax) scan_axis(t, sorted_on(t, s, ax), size, cands, best);
  }
  if (!best.found) return false;  // unreachable: k = size always fits
  Ids left(best.so.begin(), best.so.begin() + best.k);
  Ids right(best.so.begin() + best.k, best.so.end());
  best.so = Ids();
  s = Ids();
  if (wide) {
    // the two subtrees at once; the right one's leaves come first
    std::vector<Ids> left_leaves;
    int half = std::max(1, threads / 2);
    auto f = std::async(std::launch::async, [&]() {
      return split(t, std::move(left), size, half, left_leaves);
    });
    bool ok = split(t, std::move(right), size, threads - half, leaves);
    ok = f.get() && ok;
    for (auto& g : left_leaves) leaves.push_back(std::move(g));
    return ok;
  }
  return split(t, std::move(right), size, 1, leaves) &&
         split(t, std::move(left), size, 1, leaves);
}

// s in Morton order of its centroids within their own box
Ids morton_sorted(const Tris& t, const Ids& s) {
  double lo[3] = {INFINITY, INFINITY, INFINITY};
  double hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int64_t e : s)
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], t.c[3 * e + a]);
      hi[a] = std::max(hi[a], t.c[3 * e + a]);
    }
  float flo[3], fhi[3];
  for (int a = 0; a < 3; ++a) {
    flo[a] = static_cast<float>(lo[a]);
    fhi[a] = static_cast<float>(hi[a]);
  }
  std::vector<std::pair<uint32_t, int64_t>> code(s.size());
  for (size_t j = 0; j < s.size(); ++j) {
    float c[3];
    for (int a = 0; a < 3; ++a) c[a] = static_cast<float>(t.c[3 * s[j] + a]);
    code[j] = {morton(c, flo, fhi), s[j]};
  }
  std::stable_sort(code.begin(), code.end(),
                   [](const auto& a, const auto& b) { return a.first < b.first; });
  Ids out(s.size());
  for (size_t j = 0; j < s.size(); ++j) out[j] = code[j].second;
  return out;
}

// kd_cluster_order(sah=True) of the triangles s (in that input order)
bool kd_order(const Tris& t, const Ids& s, size_t size, int threads, Ids& out) {
  std::vector<Ids> groups;
  if (!split(t, s, size, threads, groups)) return false;
  std::vector<Ids> full;
  Ids rest;
  int n_rest = 0;
  for (auto& g : groups) {
    if (g.size() == size) {
      full.push_back(std::move(g));
    } else {
      rest = std::move(g);
      ++n_rest;
    }
  }
  if (n_rest > 1) return false;
  if (!full.empty()) {
    double lo[3] = {INFINITY, INFINITY, INFINITY};
    double hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int64_t e : s)
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], t.c[3 * e + a]);
        hi[a] = std::max(hi[a], t.c[3 * e + a]);
      }
    float flo[3], fhi[3];
    for (int a = 0; a < 3; ++a) {
      flo[a] = static_cast<float>(lo[a]);
      fhi[a] = static_cast<float>(hi[a]);
    }
    std::vector<std::pair<uint32_t, int64_t>> code(full.size());
    for (size_t g = 0; g < full.size(); ++g) {
      double sum[3] = {0.0, 0.0, 0.0};
      for (int64_t e : full[g])
        for (int a = 0; a < 3; ++a) sum[a] += t.c[3 * e + a];
      float mean[3];
      for (int a = 0; a < 3; ++a)
        mean[a] = static_cast<float>(sum[a] / static_cast<double>(full[g].size()));
      code[g] = {morton(mean, flo, fhi), static_cast<int64_t>(g)};
    }
    std::stable_sort(code.begin(), code.end(),
                     [](const auto& a, const auto& b) { return a.first < b.first; });
    std::vector<Ids> sorted(full.size());
    for (size_t g = 0; g < full.size(); ++g) sorted[g] = std::move(full[code[g].second]);
    full = std::move(sorted);
  }
  if (n_rest) full.push_back(std::move(rest));
  // rows within each cluster: kd-SAH of 12 where a cluster is larger,
  // else Morton order
  std::vector<Ids> rows(full.size());
  std::atomic<bool> ok{true};
  parallel_for(static_cast<int64_t>(full.size()), threads, [&](int64_t g) {
    if (full[g].size() > static_cast<size_t>(kRow)) {
      if (!kd_order(t, full[g], kRow, 1, rows[g])) ok = false;
    } else {
      rows[g] = morton_sorted(t, full[g]);
    }
  });
  out.clear();
  out.reserve(s.size());
  for (auto& r : rows) out.insert(out.end(), r.begin(), r.end());
  return ok;
}

}  // namespace

extern "C" {

// The kd-SAH cluster order of n triangles (v0, v1, v2: (n, 3) float32):
// parent == 0 gives kd_cluster_order(size, sah=True); parent > 0
// hier_cluster_order(size, parent). Writes n int64 indices; returns 0, or
// -1 where the twin would fail its own checks.
int tpurt_cluster_order(int64_t n, const float* v0, const float* v1,
                        const float* v2, int32_t size, int32_t parent,
                        int32_t threads, int64_t* out) {
  Tris t;
  t.c.resize(3 * n);
  t.lo.resize(3 * n);
  t.hi.resize(3 * n);
  for (int64_t i = 0; i < 3 * n; ++i) {
    float a = v0[i], b = v1[i], c = v2[i];
    float sum = a + b;
    sum = sum + c;
    t.c[i] = static_cast<double>(sum / 3.0f);
    t.lo[i] = static_cast<double>(std::min(std::min(a, b), c));
    t.hi[i] = static_cast<double>(std::max(std::max(a, b), c));
  }
  threads = std::max(1, threads);
  Ids all(n);
  for (int64_t i = 0; i < n; ++i) all[i] = i;
  Ids order;
  if (parent <= 0) {
    if (!kd_order(t, all, static_cast<size_t>(size), threads, order)) return -1;
    std::copy(order.begin(), order.end(), out);
    return 0;
  }
  Ids outer;
  if (!kd_order(t, all, static_cast<size_t>(parent), threads, outer)) return -1;
  const int64_t n_blocks = (n + parent - 1) / parent;
  std::atomic<bool> ok{true};
  parallel_for(n_blocks, threads, [&](int64_t b) {
    const int64_t start = b * parent;
    const int64_t end = std::min<int64_t>(start + parent, n);
    Ids blk(outer.begin() + start, outer.begin() + end);
    Ids inner;
    if (!kd_order(t, blk, static_cast<size_t>(size), 1, inner)) {
      ok = false;
      return;
    }
    std::copy(inner.begin(), inner.end(), out + start);
  });
  return ok ? 0 : -1;
}

}  // extern "C"
