// srt_bvh: binned-SAH BVH8 builder (host, C++).
//
// The analog of what Embree's rtcCommitScene gives the reference for
// free (scene.cpp:101-107): a surface-area-heuristic tree. The
// renderers walk an implicit Morton-median 8-ary heap (ops/wbvh.py),
// whose equal-size subtree constraint produces overlapping children
// on uneven scenes. This build produces an explicit-pointer 8-wide
// tree, kept for a walk that reads it (not wired to the renderers):
//
//   1. top-down binary binned SAH (16 bins, all 3 axes swept and the
//      cheapest (axis, bin) split taken — round-3: the largest-extent-
//      only sweep left ~5-10% SAH on the table on architectural
//      scenes; forced split while count > leaf capacity). Round 3
//      adds OPTIONAL spatial splits (the SBVH shape of Stich et al.
//      2009): when the best object split's children overlap by more
//      than alpha x root area, chopped binning evaluates axis-plane
//      splits that DUPLICATE straddling references, clipping the
//      triangle polygon to each side. Large architectural triangles
//      (sponza floors/walls) stop inflating child boxes, shrinking
//      the boxes a traversal visits. Reference count
//      is budgeted (max_ref_factor x n); when the budget runs out
//      the build degrades gracefully to pure object splits,
//   2. collapse to 8-wide by a dynamic program that minimizes the
//      total surface area of wide-node roots (round 3). Taking a
//      wide-node visit to cost ~1 unit no matter how many of its 8
//      slots are full, and since binary leaves are immutable
//      (leaf-drain count is partition-independent), so expected node
//      visits ~ sum over wide nodes W of P(ray hits W's box) ~
//      sum A(W). The DP (the cost shape of Ylitie et al. 2017's
//      BVH8 collapse, with the member-wide cost constant dropped)
//      partitions the binary tree into fragments with <= 8 exits:
//        g(n, i) = min cost of covering subtree(n) with <= i exits
//                  (n strictly inside the current fragment)
//        g(leaf, i) = 0;  g(n, 1) = f(n)
//        g(n, i) = min(f(n), min_{i1+i2=i} g(l,i1) + g(r,i2))
//        f(n) = A(n) + min_{i1+i2=8} g(l,i1) + g(r,i2)
//      (round 2 expanded the largest-area child greedily),
//   3. emit component-major children rows [NI, 48] + child ids
//      [NI, 8] + leaf order [L*K] (original triangle ids, -1 pad).
//
// Child id encoding: internal child = its row index; leaf child =
// NI + leaf_row; empty slot = id 0 with a point-at-infinity box (never
// hit, never visited).
//
// Exposed via a C ABI consumed with ctypes (ops/sah.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr float kInf = 3.0e38f;
constexpr int kBins = 16;

struct Vec3 {
  float x = 0, y = 0, z = 0;
};

struct Box {
  float lo[3] = {kInf, kInf, kInf};
  float hi[3] = {-kInf, -kInf, -kInf};
  void grow(const float* p) {
    for (int c = 0; c < 3; c++) {
      lo[c] = std::min(lo[c], p[c]);
      hi[c] = std::max(hi[c], p[c]);
    }
  }
  void grow(const Box& b) {
    for (int c = 0; c < 3; c++) {
      lo[c] = std::min(lo[c], b.lo[c]);
      hi[c] = std::max(hi[c], b.hi[c]);
    }
  }
  float area() const {
    float dx = std::max(hi[0] - lo[0], 0.0f);
    float dy = std::max(hi[1] - lo[1], 0.0f);
    float dz = std::max(hi[2] - lo[2], 0.0f);
    return 2.0f * (dx * dy + dy * dz + dz * dx);
  }
  // Minkowski-dilated area: the area seen by a ray PACKET of spatial
  // spread s rather than a point ray (the
  // traversal cost model is packet-union visits, and a packet of
  // cross-section s "hits" a box enlarged by s on every side).
  float area_dilated(float s) const {
    float dx = std::max(hi[0] - lo[0], 0.0f) + s;
    float dy = std::max(hi[1] - lo[1], 0.0f) + s;
    float dz = std::max(hi[2] - lo[2], 0.0f) + s;
    return 2.0f * (dx * dy + dy * dz + dz * dx);
  }
};

struct BNode {            // binary SAH node
  Box box;
  int32_t left = -1;      // internal: children indices
  int32_t right = -1;
  int32_t start = 0;      // leaf: [start, start+count) in leaf_tris
  int32_t count = 0;      // 0 = internal
};

// A build reference: one (possibly clipped) occurrence of a triangle.
// Object splits move refs; spatial splits duplicate them with the
// triangle polygon clipped to each side of the plane.
struct Ref {
  int32_t tri = -1;
  Box box;
};

// Box of the triangle polygon clipped to lo <= p[axis] <= hi
// (Sutherland-Hodgman against the two axis planes). Returns an
// empty (default) box when the polygon misses the slab.
Box clip_tri_slab(const float* v /* [3][3] */, int axis, float lo,
                  float hi) {
  float poly[16][3];
  int np = 3;
  for (int i = 0; i < 3; i++)
    for (int c = 0; c < 3; c++) poly[i][c] = v[i * 3 + c];
  float tmp[16][3];
  // two half-space passes: keep p[axis] >= lo, then p[axis] <= hi
  for (int pass = 0; pass < 2; pass++) {
    float plane = pass == 0 ? lo : hi;
    float sgn = pass == 0 ? 1.0f : -1.0f;
    int nt = 0;
    for (int i = 0; i < np; i++) {
      const float* a = poly[i];
      const float* b = poly[(i + 1) % np];
      float da = sgn * (a[axis] - plane);
      float db = sgn * (b[axis] - plane);
      if (da >= 0) {
        for (int c = 0; c < 3; c++) tmp[nt][c] = a[c];
        nt++;
      }
      if ((da >= 0) != (db >= 0)) {
        float t = da / (da - db);
        for (int c = 0; c < 3; c++)
          tmp[nt][c] = a[c] + t * (b[c] - a[c]);
        nt++;
      }
      if (nt >= 14) break;  // paranoia; a slab clip of a tri is <= 5
    }
    np = nt;
    for (int i = 0; i < np; i++)
      for (int c = 0; c < 3; c++) poly[i][c] = tmp[i][c];
    if (np == 0) break;
  }
  Box out;
  for (int i = 0; i < np; i++) out.grow(poly[i]);
  return out;
}

bool box_valid(const Box& b) { return b.lo[0] <= b.hi[0]; }

Box box_intersect(const Box& a, const Box& b) {
  Box out;
  for (int c = 0; c < 3; c++) {
    out.lo[c] = std::max(a.lo[c], b.lo[c]);
    out.hi[c] = std::min(a.hi[c], b.hi[c]);
    if (out.lo[c] > out.hi[c]) return Box();  // empty
  }
  return out;
}

struct Builder {
  const float* tv = nullptr;  // [n, 3, 3]
  int64_t n = 0;
  int32_t k = 8;              // leaf capacity
  int32_t w = 8;              // wide-node fanout (8 by default;
                              // parameterized for tree-shape probes)
  float spatial_alpha = 0.0f;  // 0 = object splits only
  float collapse_dilate = 0.0f;  // packet-spread margin for the
                                 // union-weighted DP objective
  int64_t ref_budget = 0;      // extra refs spatial splits may mint
  float root_area = 1.0f;
  std::vector<int32_t> leaf_tris;  // leaf emission arena
  std::vector<BNode> bnodes;

  // --- outputs (8-wide) ---
  std::vector<float> children;    // [NI, 48] component-major boxes
  std::vector<int32_t> child_ids; // [NI, 8]
  std::vector<int32_t> leaf_order;  // [L, k] original tri ids, -1 pad
  int32_t depth = 0;

  static float ref_cent(const Ref& r, int axis) {
    return 0.5f * (r.box.lo[axis] + r.box.hi[axis]);
  }

  int32_t emit_leaf(const std::vector<Ref>& refs, const Box& box) {
    BNode node;
    node.box = box;
    node.start = (int32_t)leaf_tris.size();
    node.count = (int32_t)refs.size();
    for (const Ref& r : refs) leaf_tris.push_back(r.tri);
    int32_t me = (int32_t)bnodes.size();
    bnodes.push_back(node);
    return me;
  }

  int32_t build_binary(std::vector<Ref> refs) {
    Box box;
    for (const Ref& r : refs) box.grow(r.box);
    if ((int32_t)refs.size() <= k) return emit_leaf(refs, box);
    int32_t me = (int32_t)bnodes.size();
    bnodes.push_back(BNode{box, -1, -1, 0, 0});

    // centroid bounds
    Box cb;
    for (const Ref& r : refs) {
      float p[3] = {ref_cent(r, 0), ref_cent(r, 1), ref_cent(r, 2)};
      cb.grow(p);
    }
    // --- object split: binned SAH over ALL 3 axes, cheapest wins ---
    float best = kInf;
    int best_axis = -1, best_b = -1;
    for (int axis = 0; axis < 3; axis++) {
      float ext = cb.hi[axis] - cb.lo[axis];
      if (ext <= 1e-20f) continue;
      Box bin_box[kBins];
      int32_t bin_cnt[kBins] = {0};
      float k1 = kBins * (1.0f - 1e-6f) / ext;
      float lo = cb.lo[axis];
      for (const Ref& r : refs) {
        int b = (int)((ref_cent(r, axis) - lo) * k1);
        b = std::min(std::max(b, 0), kBins - 1);
        bin_box[b].grow(r.box);
        bin_cnt[b]++;
      }
      // sweep: left-to-right and right-to-left prefix areas
      float rarea[kBins];
      Box acc;
      int32_t rcnt[kBins];
      int32_t cnt = 0;
      for (int b = kBins - 1; b > 0; b--) {
        acc.grow(bin_box[b]);
        cnt += bin_cnt[b];
        rarea[b] = acc.area();
        rcnt[b] = cnt;
      }
      acc = Box();
      cnt = 0;
      for (int b = 0; b < kBins - 1; b++) {
        acc.grow(bin_box[b]);
        cnt += bin_cnt[b];
        if (cnt == 0 || rcnt[b + 1] == 0) continue;
        float cost = acc.area() * cnt + rarea[b + 1] * rcnt[b + 1];
        if (cost < best) { best = cost; best_axis = axis; best_b = b; }
      }
    }

    // Geometry boxes of the chosen object split (for the SBVH
    // overlap test): one more pass over the best axis's bins.
    Box obj_lbox, obj_rbox;
    if (best_b >= 0) {
      int axis = best_axis;
      float ext = cb.hi[axis] - cb.lo[axis];
      float k1 = kBins * (1.0f - 1e-6f) / ext;
      float lo = cb.lo[axis];
      for (const Ref& r : refs) {
        int b = (int)((ref_cent(r, axis) - lo) * k1);
        b = std::min(std::max(b, 0), kBins - 1);
        (b <= best_b ? obj_lbox : obj_rbox).grow(r.box);
      }
    }

    // --- spatial split (SBVH): evaluated only when the object
    // split's children overlap by more than alpha x root area ---
    float sp_best = kInf;
    int sp_axis = -1;
    float sp_pos = 0.0f;
    if (spatial_alpha > 0.0f && best_b >= 0 && ref_budget > 0) {
      Box ov = box_intersect(obj_lbox, obj_rbox);
      if (box_valid(ov) && ov.area() > spatial_alpha * root_area) {
        for (int axis = 0; axis < 3; axis++) {
          float lo = box.lo[axis], hi = box.hi[axis];
          float ext = hi - lo;
          if (ext <= 1e-20f) continue;
          float inv = kBins * (1.0f - 1e-6f) / ext;
          Box bin_box[kBins];
          int32_t entry[kBins] = {0}, exit_[kBins] = {0};
          for (const Ref& r : refs) {
            int b0 = (int)((r.box.lo[axis] - lo) * inv);
            int b1 = (int)((r.box.hi[axis] - lo) * inv);
            b0 = std::min(std::max(b0, 0), kBins - 1);
            b1 = std::min(std::max(b1, b0), kBins - 1);
            entry[b0]++;
            exit_[b1]++;
            if (b0 == b1) {
              bin_box[b0].grow(r.box);
            } else {
              const float* v = tv + (int64_t)r.tri * 9;
              for (int b = b0; b <= b1; b++) {
                float slo = lo + ext * b / kBins;
                float shi = lo + ext * (b + 1) / kBins;
                Box cbx = clip_tri_slab(v, axis, slo, shi);
                if (!box_valid(cbx)) continue;
                cbx = box_intersect(cbx, r.box);
                if (box_valid(cbx)) bin_box[b].grow(cbx);
              }
            }
          }
          float rarea[kBins];
          int32_t rcnt[kBins];
          Box acc;
          int32_t cnt = 0;
          for (int b = kBins - 1; b > 0; b--) {
            acc.grow(bin_box[b]);
            cnt += exit_[b];
            rarea[b] = acc.area();
            rcnt[b] = cnt;
          }
          acc = Box();
          cnt = 0;
          for (int b = 0; b < kBins - 1; b++) {
            acc.grow(bin_box[b]);
            cnt += entry[b];
            if (cnt == 0 || rcnt[b + 1] == 0) continue;
            float cost = acc.area() * cnt + rarea[b + 1] * rcnt[b + 1];
            if (cost < sp_best) {
              sp_best = cost;
              sp_axis = axis;
              sp_pos = lo + ext * (b + 1) / kBins;
            }
          }
        }
      }
    }

    std::vector<Ref> lrefs, rrefs;
    if (sp_axis >= 0 && sp_best < best) {
      // spatial partition: duplicate straddlers (budget permitting)
      int axis = sp_axis;
      float pos = sp_pos;
      for (const Ref& r : refs) {
        if (r.box.hi[axis] <= pos) {
          lrefs.push_back(r);
        } else if (r.box.lo[axis] >= pos) {
          rrefs.push_back(r);
        } else if (ref_budget > 0) {
          const float* v = tv + (int64_t)r.tri * 9;
          Box lb = box_intersect(clip_tri_slab(v, axis, -kInf, pos),
                                 r.box);
          Box rb = box_intersect(clip_tri_slab(v, axis, pos, kInf),
                                 r.box);
          if (!box_valid(lb)) {
            rrefs.push_back(r);
          } else if (!box_valid(rb)) {
            lrefs.push_back(r);
          } else {
            lrefs.push_back({r.tri, lb});
            rrefs.push_back({r.tri, rb});
            ref_budget--;
          }
        } else {
          (ref_cent(r, axis) <= pos ? lrefs : rrefs).push_back(r);
        }
      }
      if (lrefs.empty() || rrefs.empty()) {
        lrefs.clear();
        rrefs.clear();
        sp_axis = -1;  // degenerate; fall through to object split
      }
    }
    if (sp_axis < 0 || (lrefs.empty() && rrefs.empty())) {
      if (best_b < 0) {
        // degenerate centroids: median split
        std::nth_element(
            refs.begin(), refs.begin() + refs.size() / 2, refs.end(),
            [](const Ref& a, const Ref& b) {
              return ref_cent(a, 0) < ref_cent(b, 0);
            });
        lrefs.assign(refs.begin(), refs.begin() + refs.size() / 2);
        rrefs.assign(refs.begin() + refs.size() / 2, refs.end());
      } else {
        int axis = best_axis;
        float ext = cb.hi[axis] - cb.lo[axis];
        float k1 = kBins * (1.0f - 1e-6f) / ext;
        float lo = cb.lo[axis];
        for (const Ref& r : refs) {
          int b = (int)((ref_cent(r, axis) - lo) * k1);
          b = std::min(std::max(b, 0), kBins - 1);
          (b <= best_b ? lrefs : rrefs).push_back(r);
        }
        if (lrefs.empty() || rrefs.empty()) {
          lrefs.clear();
          rrefs.clear();
          size_t mid = refs.size() / 2;
          lrefs.assign(refs.begin(), refs.begin() + mid);
          rrefs.assign(refs.begin() + mid, refs.end());
        }
      }
    }
    refs.clear();
    refs.shrink_to_fit();
    int32_t l = build_binary(std::move(lrefs));
    int32_t r = build_binary(std::move(rrefs));
    bnodes[me].left = l;
    bnodes[me].right = r;
    return me;
  }

  // --- DP collapse (see file header): minimize sum of wide-node-root
  // areas over all partitions of the binary tree into fragments with
  // <= 8 exits. Exits become the wide node's children (leaf exits =
  // leaf slots; internal exits = new wide-node roots).
  std::vector<float> gtab;      // [m, w]: g(n, i) at [n*w + i-1]
  std::vector<float> fcost;     // [m]: f(n)
  std::vector<uint8_t> fsplit;  // [m]: f(n)'s left-budget choice
  std::vector<uint8_t> gsplit;  // [m, w]: 0 = SELF (n is an exit),
                                //         else left-budget i1

  void dp_collapse_tables() {
    size_t m = bnodes.size();
    gtab.assign(m * w, 0.0f);
    fcost.assign(m, 0.0f);
    fsplit.assign(m, 1);
    gsplit.assign(m * w, 0);
    // build_binary pushes a node before recursing into its children,
    // so descending index order visits children before parents
    for (size_t n = m; n-- > 0;) {
      const BNode& nd = bnodes[n];
      if (nd.count > 0) continue;  // binary leaf: g = 0 everywhere
      const float* gl = &gtab[(size_t)nd.left * w];
      const float* gr = &gtab[(size_t)nd.right * w];
      float best = kInf;
      int bi = 1;
      for (int i1 = 1; i1 <= w - 1; i1++) {
        float c = gl[i1 - 1] + gr[w - i1 - 1];
        if (c < best) { best = c; bi = i1; }
      }
      fcost[n] = (collapse_dilate > 0.0f
                      ? nd.box.area_dilated(collapse_dilate)
                      : nd.box.area()) + best;
      fsplit[n] = (uint8_t)bi;
      float* gn = &gtab[n * w];
      uint8_t* gs = &gsplit[n * w];
      gn[0] = fcost[n];
      gs[0] = 0;  // at budget 1, n must itself be the exit
      for (int i = 2; i <= w; i++) {
        best = fcost[n];
        int choice = 0;  // SELF
        for (int i1 = 1; i1 <= i - 1; i1++) {
          float c = gl[i1 - 1] + gr[i - i1 - 1];
          if (c < best) { best = c; choice = i1; }
        }
        gn[i - 1] = best;
        gs[i - 1] = (uint8_t)choice;
      }
    }
  }

  void exits_of(int32_t n, int budget, std::vector<int32_t>& out) {
    if (bnodes[n].count > 0) {  // binary leaf: always an exit
      out.push_back(n);
      return;
    }
    uint8_t c = gsplit[(size_t)n * w + budget - 1];
    if (c == 0) {  // SELF: n becomes a wide-node root
      out.push_back(n);
      return;
    }
    exits_of(bnodes[n].left, c, out);
    exits_of(bnodes[n].right, budget - c, out);
  }

  // children of the wide node rooted at binary node `b`
  void gather8(int32_t b, std::vector<int32_t>& out) {
    out.clear();
    if (bnodes[b].count > 0) {  // root itself a leaf
      out.push_back(b);
      return;
    }
    int i1 = fsplit[b];
    exits_of(bnodes[b].left, i1, out);
    exits_of(bnodes[b].right, w - i1, out);
  }

  void collapse() {
    // BFS over 8-wide nodes; each queue entry is a binary node that
    // becomes one 8-wide internal row (a binary leaf root degenerates
    // to a single-leaf-child row).
    struct Item { int32_t bnode; int32_t level; };
    std::vector<Item> queue;
    queue.push_back({0, 1});
    // internal rows are assigned on enqueue; leaf rows on discovery
    int32_t next_row = 1;
    for (size_t qi = 0; qi < queue.size(); qi++) {
      Item it = queue[qi];
      depth = std::max(depth, it.level);
      std::vector<int32_t> kids;
      gather8(it.bnode, kids);
      size_t row_base = children.size();
      children.resize(row_base + 6 * (size_t)w, kInf);
      size_t id_base = child_ids.size();
      child_ids.resize(id_base + w, 0);
      for (int j = 0; j < (int)kids.size(); j++) {
        const BNode& nd = bnodes[kids[j]];
        for (int c = 0; c < 3; c++) {
          children[row_base + c * w + j] = nd.box.lo[c];
          children[row_base + (3 + c) * w + j] = nd.box.hi[c];
        }
        if (nd.count > 0) {
          // leaf child: final id = NI + leaf_row, fixed up once NI is
          // known (stored as -(leaf_row+1) meanwhile)
          int32_t leaf_row = (int32_t)(leaf_order.size() / k);
          leaf_order.resize(leaf_order.size() + k, -1);
          for (int32_t i = 0; i < nd.count; i++)
            leaf_order[leaf_row * k + i] = leaf_tris[nd.start + i];
          child_ids[id_base + j] = -(leaf_row + 1);
        } else {
          child_ids[id_base + j] = next_row;
          queue.push_back({kids[j], it.level + 1});
          next_row++;
        }
      }
      // unfilled slots keep the point-at-infinity box and id 0
    }
    // fix up leaf ids now that NI is known
    int32_t ni = next_row;
    for (auto& id : child_ids)
      if (id < 0) id = ni + (-id - 1);
  }

  void run() {
    if (n == 0) {
      children.assign(6 * (size_t)w, kInf);  // no child box ever hit
      child_ids.assign(w, 0);
      child_ids[0] = 1;            // = NI + leaf 0 (never visited)
      leaf_order.assign(k, -1);
      depth = 1;
      return;
    }
    std::vector<Ref> refs(n);
    Box root;
    for (int64_t i = 0; i < n; i++) {
      Box b;
      b.grow(tv + i * 9 + 0);
      b.grow(tv + i * 9 + 3);
      b.grow(tv + i * 9 + 6);
      refs[i] = {(int32_t)i, b};
      root.grow(b);
    }
    root_area = std::max(root.area(), 1e-20f);
    leaf_tris.reserve(n + ref_budget);
    bnodes.reserve((size_t)(2.2 * (double)std::max<int64_t>(n / k, 1)) + 8);
    build_binary(std::move(refs));
    dp_collapse_tables();
    collapse();
  }
};

}  // namespace

extern "C" {

void* srt_bvh_build(const float* tri_v, int64_t n, int32_t leaf_size) {
  auto* b = new Builder();
  b->tv = tri_v;
  b->n = n;
  b->k = leaf_size;
  b->run();
  return b;
}

// SBVH variant: spatial_alpha is the Stich et al. overlap threshold
// (fraction of root surface area; 1e-5 typical; 0 disables), and
// max_ref_factor bounds total references at factor x n.
void* srt_bvh_build2(const float* tri_v, int64_t n, int32_t leaf_size,
                     float spatial_alpha, float max_ref_factor) {
  auto* b = new Builder();
  b->tv = tri_v;
  b->n = n;
  b->k = leaf_size;
  b->spatial_alpha = spatial_alpha;
  if (spatial_alpha > 0.0f && max_ref_factor > 1.0f)
    b->ref_budget = (int64_t)((max_ref_factor - 1.0f) * (double)n);
  b->run();
  return b;
}

// total leaf references (> n when spatial splits duplicated)
int64_t srt_bvh_nrefs(void* h) {
  return (int64_t)((Builder*)h)->leaf_tris.size();
}

int64_t srt_bvh_ni(void* h) {
  auto* b = (Builder*)h;
  return (int64_t)(b->child_ids.size() / b->w);
}

// Probe variant: wide-node fanout as a parameter. The default builds
// stay 8-wide (srt_bvh_build/build2).
void* srt_bvh_build3(const float* tri_v, int64_t n, int32_t leaf_size,
                     int32_t width) {
  auto* b = new Builder();
  b->tv = tri_v;
  b->n = n;
  b->k = leaf_size;
  b->w = width < 2 ? 2 : (width > 64 ? 64 : width);
  b->run();
  return b;
}

int32_t srt_bvh_width(void* h) { return ((Builder*)h)->w; }

// Union-weighted collapse: the DP minimizes the
// sum of PACKET-DILATED wide-root areas — area of each box enlarged
// by `dilate` (world units, the captured packet spatial spread) —
// instead of point-ray areas. dilate = 0 reproduces srt_bvh_build.
void* srt_bvh_build4(const float* tri_v, int64_t n, int32_t leaf_size,
                     float dilate) {
  auto* b = new Builder();
  b->tv = tri_v;
  b->n = n;
  b->k = leaf_size;
  b->collapse_dilate = dilate;
  b->run();
  return b;
}

int64_t srt_bvh_nleaves(void* h) {
  auto* b = (Builder*)h;
  return (int64_t)(b->leaf_order.size() / b->k);
}

int32_t srt_bvh_depth(void* h) { return ((Builder*)h)->depth; }

void srt_bvh_copy(void* h, float* children48, int32_t* child_ids8,
                  int32_t* order) {
  auto* b = (Builder*)h;
  std::memcpy(children48, b->children.data(),
              b->children.size() * sizeof(float));
  std::memcpy(child_ids8, b->child_ids.data(),
              b->child_ids.size() * sizeof(int32_t));
  std::memcpy(order, b->leaf_order.data(),
              b->leaf_order.size() * sizeof(int32_t));
}

void srt_bvh_free(void* h) { delete (Builder*)h; }

}  // extern "C"
