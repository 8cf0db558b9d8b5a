// Rotated-rectangle overlap for the offline KITTI/VoD/TJ4D evaluators.
//
// Native replacement for the reference's numba kernels
// (pcdet/datasets/kitti/kitti_object_eval_python/rotate_iou.py:73-330,
// devRotateIoUEval, and the njit copy utils/rotate_iou_cpu.py): exact convex
// intersection of rotated BEV rectangles via Sutherland-Hodgman clipping,
// double precision, one tight loop over all (N, M) pairs.
//
// Box layout matches eval/rotated_iou_np.py: (cx, cy, w, h, angle) with the
// KITTI-eval camera-BEV convention. criterion: -1 IoU, 0 overlap/area_a,
// 1 overlap/area_b, 2 raw intersection area.
//
// Host code, not a device kernel: native.build_host compiles it with the
// host C++ compiler into a plain shared object, bound with ctypes.

#include <cmath>
#include <cstdint>

namespace {

struct Pt {
  double x, y;
};

// 4 corners of (cx, cy, w, h, angle); template order matches the numpy
// implementation ((+,+), (-,+), (-,-), (+,-)) so orientations agree.
// Rotation is CLOCKWISE for positive angle (x' = c*x + s*y,
// y' = -s*x + c*y), the KITTI/second.pytorch eval convention
// (reference rotate_iou_cpu.rbbox_to_corners) — the relative geometry
// of two boxes with different headings depends on this sign.
inline void corners(const double* b, Pt* c) {
  const double cx = b[0], cy = b[1], hw = 0.5 * b[2], hh = 0.5 * b[3];
  const double ca = std::cos(b[4]), sa = std::sin(b[4]);
  const double tx[4] = {hw, -hw, -hw, hw};
  const double ty[4] = {hh, hh, -hh, -hh};
  for (int i = 0; i < 4; ++i) {
    c[i].x = cx + tx[i] * ca + ty[i] * sa;
    c[i].y = cy - tx[i] * sa + ty[i] * ca;
  }
}

inline double shoelace(const Pt* p, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt& a = p[i];
    const Pt& b = p[(i + 1) % n];
    s += a.x * b.y - b.x * a.y;
  }
  return 0.5 * std::fabs(s);
}

// Clip convex polygon `in` (n vertices) against the half-plane on the left
// of directed edge a->b. Output to `out`; returns the new vertex count.
// Max output size for quad-vs-quad clipping is 8.
inline int clip_edge(const Pt* in, int n, Pt a, Pt b, Pt* out) {
  const double ex = b.x - a.x, ey = b.y - a.y;
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const Pt& cur = in[i];
    const Pt& nxt = in[(i + 1) % n];
    const double dc = ex * (cur.y - a.y) - ey * (cur.x - a.x);
    const double dn = ex * (nxt.y - a.y) - ey * (nxt.x - a.x);
    if (dc >= 0.0) out[m++] = cur;
    if ((dc > 0.0 && dn < 0.0) || (dc < 0.0 && dn > 0.0)) {
      const double t = dc / (dc - dn);
      out[m].x = cur.x + t * (nxt.x - cur.x);
      out[m].y = cur.y + t * (nxt.y - cur.y);
      ++m;
    }
  }
  return m;
}

// Exact intersection area of two convex quads (both CCW).
inline double quad_intersection_area(const Pt* qa, const Pt* qb) {
  Pt buf1[16], buf2[16];
  int n = 4;
  for (int i = 0; i < 4; ++i) buf1[i] = qa[i];
  Pt* cur = buf1;
  Pt* nxt = buf2;
  for (int e = 0; e < 4 && n >= 3; ++e) {
    n = clip_edge(cur, n, qb[e], qb[(e + 1) % 4], nxt);
    Pt* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return (n >= 3) ? shoelace(cur, n) : 0.0;
}

}  // namespace

extern "C" {

// boxes (n, 5) row-major, query (m, 5); out (n, m) row-major.
void rotate_iou_eval(const double* boxes, int64_t n, const double* query,
                     int64_t m, int criterion, double* out) {
  constexpr double kEps = 1e-8;
  // pre-compute query corners once
  Pt* qc = new Pt[4 * m];
  for (int64_t j = 0; j < m; ++j) corners(query + 5 * j, qc + 4 * j);

  Pt ac[4];
  for (int64_t i = 0; i < n; ++i) {
    const double* ba = boxes + 5 * i;
    corners(ba, ac);
    const double area_a = ba[2] * ba[3];
    double* row = out + i * m;
    for (int64_t j = 0; j < m; ++j) {
      const double* bb = query + 5 * j;
      // a zero-area clip polygon would degenerate every half-plane test to
      // "keep" (0 >= 0) and return area(A); the true intersection is 0
      const double inter =
          (area_a <= 0.0 || bb[2] * bb[3] <= 0.0)
              ? 0.0
              : quad_intersection_area(ac, qc + 4 * j);
      double denom;
      switch (criterion) {
        case -1:
          denom = area_a + bb[2] * bb[3] - inter;
          break;
        case 0:
          denom = area_a;
          break;
        case 1:
          denom = bb[2] * bb[3];
          break;
        default:
          row[j] = inter;
          continue;
      }
      row[j] = (denom > 0.0) ? inter / (denom > kEps ? denom : kEps) : 0.0;
    }
  }
  delete[] qc;
}

}  // extern "C"
