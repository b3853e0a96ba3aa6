// leme_ops: host-side C++ ops for eval-time post-processing.
//
// lemevit_tpu_torch's own copy of the JAX package's native/leme_ops.cpp
// (the counterpart of the reference's op pack,
// object_detection/mmdet/ops/{nms,nms_rotated,box_iou_rotated}): greedy
// NMS, soft-NMS, rotated IoU and rotated NMS on the host, where
// variable-length post-processing of a handful of boxes is cheaper than a
// device round trip. Sutherland-Hodgman clipping on fixed 8-vertex
// buffers, the geometry of ops/rotated.py. Plain C ABI for ctypes; only
// the C++ standard library.
//
// Built at first use by lemevit_tpu_torch/ops/native.py into
// lemevit_tpu_torch/_build/libleme_ops_<hash>.so.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Pt {
  float x, y;
};

// Shoelace area of poly[0..n)
float poly_area(const Pt* poly, int n) {
  float s = 0.f;
  for (int i = 0; i < n; ++i) {
    const Pt& a = poly[i];
    const Pt& b = poly[(i + 1) % n];
    s += a.x * b.y - b.x * a.y;
  }
  return std::fabs(s) * 0.5f;
}

// Clip convex polygon (poly, n) by half-plane left of edge a->b.
int clip_halfplane(const Pt* poly, int n, Pt a, Pt b, Pt* out) {
  int m = 0;
  const float ex = b.x - a.x, ey = b.y - a.y;
  auto side = [&](const Pt& p) { return ex * (p.y - a.y) - ey * (p.x - a.x); };
  for (int i = 0; i < n; ++i) {
    const Pt& cur = poly[i];
    const Pt& nxt = poly[(i + 1) % n];
    const float sc = side(cur), sn = side(nxt);
    if (sc >= 0.f) out[m++] = cur;
    if ((sc >= 0.f) != (sn >= 0.f)) {
      float denom = sc - sn;
      if (std::fabs(denom) < 1e-12f) denom = denom < 0 ? -1e-12f : 1e-12f;
      const float t = sc / denom;
      out[m++] = {cur.x + t * (nxt.x - cur.x), cur.y + t * (nxt.y - cur.y)};
    }
  }
  return m;
}

void obb_corners(const float* box, Pt* c) {
  const float cx = box[0], cy = box[1], w = box[2] * 0.5f, h = box[3] * 0.5f;
  const float ct = std::cos(box[4]), st = std::sin(box[4]);
  const float dx[4] = {w, w, -w, -w};
  const float dy[4] = {-h, h, h, -h};
  for (int i = 0; i < 4; ++i) {
    c[i] = {cx + dx[i] * ct - dy[i] * st, cy + dx[i] * st + dy[i] * ct};
  }
}

void ensure_ccw(Pt* q) {
  float s = 0.f;
  for (int i = 0; i < 4; ++i) {
    s += q[i].x * q[(i + 1) % 4].y - q[(i + 1) % 4].x * q[i].y;
  }
  if (s < 0.f) std::swap(q[0], q[3]), std::swap(q[1], q[2]);
}

float quad_inter_area(const Pt* q1, const Pt* q2) {
  Pt bufa[16], bufb[16];
  std::memcpy(bufa, q1, 4 * sizeof(Pt));
  int n = 4;
  Pt* cur = bufa;
  Pt* nxt = bufb;
  for (int e = 0; e < 4 && n >= 3; ++e) {
    n = clip_halfplane(cur, n, q2[e], q2[(e + 1) % 4], nxt);
    std::swap(cur, nxt);
  }
  return n >= 3 ? poly_area(cur, n) : 0.f;
}

float rotated_iou_single(const float* a, const float* b, int mode) {
  Pt qa[4], qb[4];
  obb_corners(a, qa);
  obb_corners(b, qb);
  ensure_ccw(qa);
  ensure_ccw(qb);
  const float inter = quad_inter_area(qa, qb);
  const float area_a = a[2] * a[3], area_b = b[2] * b[3];
  const float denom = mode == 1 ? area_a : area_a + area_b - inter;
  return denom > 1e-6f ? inter / denom : 0.f;
}

float aabb_iou(const float* a, const float* b) {
  const float x1 = std::max(a[0], b[0]), y1 = std::max(a[1], b[1]);
  const float x2 = std::min(a[2], b[2]), y2 = std::min(a[3], b[3]);
  const float iw = std::max(0.f, x2 - x1), ih = std::max(0.f, y2 - y1);
  const float inter = iw * ih;
  const float ua = (a[2] - a[0]) * (a[3] - a[1]) +
                   (b[2] - b[0]) * (b[3] - b[1]) - inter;
  return ua > 1e-6f ? inter / ua : 0.f;
}

}  // namespace

extern "C" {

// Greedy NMS on xyxy boxes. keep_out: n int32 (1 = kept). Returns kept count.
int leme_nms(const float* boxes, const float* scores, int n,
             float iou_thr, int32_t* keep_out) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(),
            [&](int i, int j) { return scores[i] > scores[j]; });
  std::vector<char> suppressed(n, 0);
  int kept = 0;
  std::fill(keep_out, keep_out + n, 0);
  for (int oi = 0; oi < n; ++oi) {
    const int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[i] = 1;
    ++kept;
    for (int oj = oi + 1; oj < n; ++oj) {
      const int j = order[oj];
      if (suppressed[j]) continue;
      if (aabb_iou(boxes + 4 * i, boxes + 4 * j) > iou_thr) suppressed[j] = 1;
    }
  }
  return kept;
}

// Soft-NMS: decays scores in place. method 0=linear, 1=gaussian.
void leme_soft_nms(const float* boxes, float* scores, int n, float iou_thr,
                   float sigma, int method, float score_thr) {
  std::vector<int> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  for (int step = 0; step < n; ++step) {
    // select current max among remaining
    int best = step;
    for (int i = step; i < n; ++i) {
      if (scores[idx[i]] > scores[idx[best]]) best = i;
    }
    std::swap(idx[step], idx[best]);
    const int i = idx[step];
    if (scores[i] < score_thr) break;
    for (int oj = step + 1; oj < n; ++oj) {
      const int j = idx[oj];
      const float ov = aabb_iou(boxes + 4 * i, boxes + 4 * j);
      float decay = 1.f;
      if (method == 1) {
        decay = std::exp(-(ov * ov) / sigma);
      } else if (ov > iou_thr) {
        decay = 1.f - ov;
      }
      scores[j] *= decay;
    }
  }
  for (int i = 0; i < n; ++i) {
    if (scores[i] < score_thr) scores[i] = 0.f;
  }
}

// Pairwise rotated IoU: a (n,5) x b (m,5) -> out (n*m). mode 0=iou, 1=iof.
void leme_box_iou_rotated(const float* a, int n, const float* b, int m,
                          int mode, float* out) {
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < m; ++j) {
      out[i * m + j] = rotated_iou_single(a + 5 * i, b + 5 * j, mode);
    }
  }
}

// Greedy NMS on rotated boxes (n,5). Returns kept count.
int leme_obb_nms(const float* boxes, const float* scores, int n,
                 float iou_thr, float min_size, int32_t* keep_out) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(),
            [&](int i, int j) { return scores[i] > scores[j]; });
  std::vector<char> suppressed(n, 0);
  std::fill(keep_out, keep_out + n, 0);
  int kept = 0;
  for (int oi = 0; oi < n; ++oi) {
    const int i = order[oi];
    if (suppressed[i]) continue;
    if (boxes[5 * i + 2] < min_size || boxes[5 * i + 3] < min_size) continue;
    keep_out[i] = 1;
    ++kept;
    for (int oj = oi + 1; oj < n; ++oj) {
      const int j = order[oj];
      if (suppressed[j]) continue;
      if (rotated_iou_single(boxes + 5 * i, boxes + 5 * j, 0) > iou_thr) {
        suppressed[j] = 1;
      }
    }
  }
  return kept;
}

// Version probe (replaces the reference's compiling_info op).
const char* leme_version() { return "leme_ops 0.1.0 (c++17 host)"; }

}  // extern "C"
