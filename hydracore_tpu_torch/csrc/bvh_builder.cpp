// Native SAH BVH builder — the performance path for large scenes.
//
// Role analogue of the reference's native builder (bvh_builder/ wraps a
// patched Embree 2.17; the builder is host-side native code while traversal
// runs on the device — the same split used here). Binned SAH over triangle
// centroids, identical output ABI to the numpy builder in
// hydracore_tpu_torch/bvh/builder.py (FlatBVH: bmin/bmax/left/right/count/
// perm), exposed through a C interface consumed via ctypes. A byte-for-byte
// copy of the JAX package's builder apart from this header, so both
// packages cut the same BVH from the same triangles.
//
// Build: see hydracore_tpu_torch/bvh/native.py (compiled on first use with
// g++ into the git-ignored hydracore_tpu_torch/_build/).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBins = 16;
constexpr int kMaxLeaf = 4;
constexpr float kTravCost = 1.0f;
constexpr float kIsectCost = 1.0f;

struct V3 {
  float x, y, z;
};

inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  V3 lo{3e38f, 3e38f, 3e38f};
  V3 hi{-3e38f, -3e38f, -3e38f};
  void grow(const AABB& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const V3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Node {
  V3 bmin, bmax;
  int32_t left, right, count;
};

struct Builder {
  const AABB* boxes;
  const V3* centroids;
  std::vector<int32_t> order;
  std::vector<Node> nodes;

  int32_t new_node() {
    nodes.push_back({});
    return (int32_t)nodes.size() - 1;
  }

  void build_range(int32_t node, int32_t start, int32_t end) {
    AABB nb;
    AABB cb;
    for (int32_t i = start; i < end; ++i) {
      nb.grow(boxes[order[i]]);
      cb.grow(centroids[order[i]]);
    }
    nodes[node].bmin = nb.lo;
    nodes[node].bmax = nb.hi;
    int32_t n = end - start;
    if (n <= kMaxLeaf) {
      nodes[node].left = start;
      nodes[node].right = -1;
      nodes[node].count = n;
      return;
    }

    // widest centroid axis
    V3 ext = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int axis = 0;
    float w = ext.x;
    if (ext.y > w) { axis = 1; w = ext.y; }
    if (ext.z > w) { axis = 2; w = ext.z; }

    int32_t mid = -1;
    if (w > 1e-12f) {
      const float c_lo = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
      const float scale = kBins * (1.0f - 1e-6f) / w;
      AABB bin_box[kBins];
      int32_t bin_cnt[kBins] = {0};
      auto bin_of = [&](int32_t tri) {
        const V3& c = centroids[tri];
        float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
        int b = (int)((v - c_lo) * scale);
        return b < 0 ? 0 : (b >= kBins ? kBins - 1 : b);
      };
      for (int32_t i = start; i < end; ++i) {
        int b = bin_of(order[i]);
        bin_box[b].grow(boxes[order[i]]);
        bin_cnt[b]++;
      }
      // sweep SAH
      float area_l[kBins], area_r[kBins];
      int32_t cnt_l[kBins], cnt_r[kBins];
      {
        AABB acc;
        int32_t c = 0;
        for (int b = 0; b < kBins; ++b) {
          acc.grow(bin_box[b]);
          c += bin_cnt[b];
          area_l[b] = acc.area();
          cnt_l[b] = c;
        }
      }
      {
        AABB acc;
        int32_t c = 0;
        for (int b = kBins - 1; b >= 0; --b) {
          acc.grow(bin_box[b]);
          c += bin_cnt[b];
          area_r[b] = acc.area();
          cnt_r[b] = c;
        }
      }
      int best = -1;
      float best_cost = 3e38f;
      for (int b = 0; b < kBins - 1; ++b) {
        if (cnt_l[b] == 0 || cnt_r[b + 1] == 0) continue;
        float cost = area_l[b] * cnt_l[b] + area_r[b + 1] * cnt_r[b + 1];
        if (cost < best_cost) { best_cost = cost; best = b; }
      }
      if (best >= 0) {
        float split_cost = kTravCost + kIsectCost * best_cost / std::max(nb.area(), 1e-12f);
        if (split_cost >= kIsectCost * n && n <= 2 * kMaxLeaf) {
          nodes[node].left = start;
          nodes[node].right = -1;
          nodes[node].count = n;
          return;
        }
        auto it = std::partition(order.begin() + start, order.begin() + end,
                                 [&](int32_t t) { return bin_of(t) <= best; });
        mid = (int32_t)(it - order.begin());
        if (mid == start || mid == end) mid = -1;
      }
    }
    if (mid < 0) mid = start + n / 2;  // degenerate: median split

    int32_t l = new_node();
    int32_t r = new_node();
    nodes[node].left = l;
    nodes[node].right = r;
    nodes[node].count = 0;
    build_range(l, start, mid);
    build_range(r, mid, end);
  }
};

// ---------------------------------------------------------------------------
// Triangle-reference pre-split (role of bvh_builder/early_split.h +
// RefMesh, bvh_access_dll2_utils.cpp:61 — the reference computes the
// SubdivMetric = boxSA^2/triSA per reference; its split loop is vestigial
// and m_earlySplit defaults off, so this is an above-parity implementation
// of the intended feature). Long thin / huge triangles whose AABB vastly
// exceeds their surface get their *references* split along the box's
// longest axis; each half re-clips the original triangle (Sutherland-
// Hodgman) so ref boxes stay tight. Leaves then hold duplicated tri ids,
// which closest-hit/any-hit traversal tolerates by construction.

struct TriRef {
  AABB box;
  int32_t tri;
  float metric;
};

inline float axis_at(const V3& v, int a) { return a == 0 ? v.x : (a == 1 ? v.y : v.z); }

// Clip triangle polygon to box, return bbox of the clipped polygon.
// Returns false if the clipped polygon is (numerically) empty.
static bool clip_tri_box(const V3& a, const V3& b, const V3& c,
                         const AABB& box, AABB* out) {
  V3 poly[16] = {a, b, c};
  V3 tmp[16];
  int n = 3;
  for (int axis = 0; axis < 3 && n > 0; ++axis) {
    for (int side = 0; side < 2 && n > 0; ++side) {
      const float plane = side == 0 ? axis_at(box.lo, axis) : axis_at(box.hi, axis);
      const float sgn = side == 0 ? 1.0f : -1.0f;  // keep sgn*(v-plane) >= 0
      int m = 0;
      for (int i = 0; i < n; ++i) {
        const V3& p = poly[i];
        const V3& q = poly[(i + 1) % n];
        const float dp = sgn * (axis_at(p, axis) - plane);
        const float dq = sgn * (axis_at(q, axis) - plane);
        if (dp >= 0.0f) tmp[m++] = p;
        if ((dp >= 0.0f) != (dq >= 0.0f)) {
          const float t = dp / (dp - dq);
          tmp[m++] = {p.x + t * (q.x - p.x), p.y + t * (q.y - p.y),
                      p.z + t * (q.z - p.z)};
        }
      }
      n = m;
      std::memcpy(poly, tmp, sizeof(V3) * n);
    }
  }
  if (n == 0) return false;
  AABB r;
  for (int i = 0; i < n; ++i) r.grow(poly[i]);
  *out = r;
  return true;
}

inline float tri_sa(const V3& a, const V3& b, const V3& c) {
  const V3 e1 = {b.x - a.x, b.y - a.y, b.z - a.z};
  const V3 e2 = {c.x - a.x, c.y - a.y, c.z - a.z};
  const V3 cr = {e1.y * e2.z - e1.z * e2.y, e1.z * e2.x - e1.x * e2.z,
                 e1.x * e2.y - e1.y * e2.x};
  return std::sqrt(cr.x * cr.x + cr.y * cr.y + cr.z * cr.z);
}

// SubdivMetric of early_split.h:116 (boxSA^2 / triSA), on the 2x half-area
// convention of AABB::area() — monotonicity is all that matters here.
inline float subdiv_metric(float box_area, float sa) {
  return box_area * box_area / std::max(sa, 1e-6f);
}

static void presplit_refs(const float* v0, const float* v1, const float* v2,
                          const uint8_t* splittable, int32_t num_tris,
                          int32_t max_refs, std::vector<TriRef>* refs) {
  refs->reserve(max_refs);
  std::vector<float> sa(num_tris);
  double mean_metric = 0.0;
  for (int32_t i = 0; i < num_tris; ++i) {
    V3 a = {v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
    V3 b = {v1[3 * i], v1[3 * i + 1], v1[3 * i + 2]};
    V3 c = {v2[3 * i], v2[3 * i + 1], v2[3 * i + 2]};
    AABB bb;
    bb.grow(a); bb.grow(b); bb.grow(c);
    sa[i] = tri_sa(a, b, c);
    TriRef r{bb, i, subdiv_metric(bb.area(), sa[i])};
    refs->push_back(r);
    mean_metric += r.metric;
  }
  mean_metric /= std::max(num_tris, 1);
  const float stop_metric = (float)(2.0 * mean_metric);

  auto cmp = [&](int32_t x, int32_t y) {
    return (*refs)[x].metric < (*refs)[y].metric;  // max-heap
  };
  std::vector<int32_t> heap(num_tris);
  for (int32_t i = 0; i < num_tris; ++i) heap[i] = i;
  std::make_heap(heap.begin(), heap.end(), cmp);

  while ((int32_t)refs->size() < max_refs && !heap.empty()) {
    std::pop_heap(heap.begin(), heap.end(), cmp);
    const int32_t ri = heap.back();
    heap.pop_back();
    TriRef r = (*refs)[ri];
    if (r.metric <= stop_metric) break;  // heap max below threshold: done
    const int32_t t = r.tri;
    if (splittable && !splittable[t]) continue;
    V3 ext = {r.box.hi.x - r.box.lo.x, r.box.hi.y - r.box.lo.y,
              r.box.hi.z - r.box.lo.z};
    int axis = 0;
    float w = ext.x;
    if (ext.y > w) { axis = 1; w = ext.y; }
    if (ext.z > w) { axis = 2; w = ext.z; }
    if (w < 1e-20f) continue;
    const float mid = 0.5f * (axis_at(r.box.lo, axis) + axis_at(r.box.hi, axis));
    AABB left_box = r.box, right_box = r.box;
    if (axis == 0) { left_box.hi.x = mid; right_box.lo.x = mid; }
    else if (axis == 1) { left_box.hi.y = mid; right_box.lo.y = mid; }
    else { left_box.hi.z = mid; right_box.lo.z = mid; }
    V3 a = {v0[3 * t], v0[3 * t + 1], v0[3 * t + 2]};
    V3 b = {v1[3 * t], v1[3 * t + 1], v1[3 * t + 2]};
    V3 c = {v2[3 * t], v2[3 * t + 1], v2[3 * t + 2]};
    AABB lb, rb;
    if (!clip_tri_box(a, b, c, left_box, &lb) ||
        !clip_tri_box(a, b, c, right_box, &rb))
      continue;  // degenerate: keep the unsplit ref
    TriRef l{lb, t, subdiv_metric(lb.area(), sa[t])};
    TriRef rr{rb, t, subdiv_metric(rb.area(), sa[t])};
    (*refs)[ri] = l;
    heap.push_back(ri);
    std::push_heap(heap.begin(), heap.end(), cmp);
    refs->push_back(rr);
    heap.push_back((int32_t)refs->size() - 1);
    std::push_heap(heap.begin(), heap.end(), cmp);
  }
}

}  // namespace

extern "C" {

// Builds the BVH. Returns node count. Caller allocates outputs:
//   out_bmin/out_bmax: (2*T) * 3 floats (upper bound on node count)
//   out_left/out_right/out_count: 2*T int32
//   out_perm: T int32
int32_t hydra_build_bvh(const float* v0, const float* v1, const float* v2,
                        int32_t num_tris, float* out_bmin, float* out_bmax,
                        int32_t* out_left, int32_t* out_right,
                        int32_t* out_count, int32_t* out_perm) {
  if (num_tris <= 0) return 0;
  std::vector<AABB> boxes(num_tris);
  std::vector<V3> cents(num_tris);
  for (int32_t i = 0; i < num_tris; ++i) {
    V3 a = {v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
    V3 b = {v1[3 * i], v1[3 * i + 1], v1[3 * i + 2]};
    V3 c = {v2[3 * i], v2[3 * i + 1], v2[3 * i + 2]};
    AABB bb;
    bb.grow(a);
    bb.grow(b);
    bb.grow(c);
    boxes[i] = bb;
    cents[i] = {(bb.lo.x + bb.hi.x) * 0.5f, (bb.lo.y + bb.hi.y) * 0.5f,
                (bb.lo.z + bb.hi.z) * 0.5f};
  }
  Builder bld;
  bld.boxes = boxes.data();
  bld.centroids = cents.data();
  bld.order.resize(num_tris);
  for (int32_t i = 0; i < num_tris; ++i) bld.order[i] = i;
  bld.nodes.reserve(2 * num_tris);
  int32_t root = bld.new_node();
  bld.build_range(root, 0, num_tris);

  int32_t n = (int32_t)bld.nodes.size();
  for (int32_t i = 0; i < n; ++i) {
    const Node& nd = bld.nodes[i];
    std::memcpy(out_bmin + 3 * i, &nd.bmin, 12);
    std::memcpy(out_bmax + 3 * i, &nd.bmax, 12);
    out_left[i] = nd.left;
    out_right[i] = nd.right;
    out_count[i] = nd.count;
  }
  std::memcpy(out_perm, bld.order.data(), sizeof(int32_t) * num_tris);
  return n;
}

// Pre-split variant: splits references of large/thin triangles before the
// SAH build (see presplit_refs above). `splittable` (len T, may be NULL =
// all) masks triangles that must stay single-reference (e.g. mesh-light
// emitters, whose area CDFs assume one row per triangle). Outputs are
// sized for `max_refs` references (nodes: 2*max_refs); out_perm[i] is the
// SOURCE tri id of ref i (duplicates allowed). *out_num_refs gets the ref
// count R; the return value is the node count.
int32_t hydra_build_bvh_ps(const float* v0, const float* v1, const float* v2,
                           int32_t num_tris, const uint8_t* splittable,
                           int32_t max_refs, float* out_bmin, float* out_bmax,
                           int32_t* out_left, int32_t* out_right,
                           int32_t* out_count, int32_t* out_perm,
                           int32_t* out_num_refs) {
  if (num_tris <= 0) {
    *out_num_refs = 0;
    return 0;
  }
  std::vector<TriRef> refs;
  presplit_refs(v0, v1, v2, splittable, num_tris,
                std::max(max_refs, num_tris), &refs);
  const int32_t R = (int32_t)refs.size();
  std::vector<AABB> boxes(R);
  std::vector<V3> cents(R);
  for (int32_t i = 0; i < R; ++i) {
    boxes[i] = refs[i].box;
    cents[i] = {(refs[i].box.lo.x + refs[i].box.hi.x) * 0.5f,
                (refs[i].box.lo.y + refs[i].box.hi.y) * 0.5f,
                (refs[i].box.lo.z + refs[i].box.hi.z) * 0.5f};
  }
  Builder bld;
  bld.boxes = boxes.data();
  bld.centroids = cents.data();
  bld.order.resize(R);
  for (int32_t i = 0; i < R; ++i) bld.order[i] = i;
  bld.nodes.reserve(2 * R);
  int32_t root = bld.new_node();
  bld.build_range(root, 0, R);

  int32_t n = (int32_t)bld.nodes.size();
  for (int32_t i = 0; i < n; ++i) {
    const Node& nd = bld.nodes[i];
    std::memcpy(out_bmin + 3 * i, &nd.bmin, 12);
    std::memcpy(out_bmax + 3 * i, &nd.bmax, 12);
    out_left[i] = nd.left;
    out_right[i] = nd.right;
    out_count[i] = nd.count;
  }
  for (int32_t i = 0; i < R; ++i) out_perm[i] = refs[bld.order[i]].tri;
  *out_num_refs = R;
  return n;
}
}
