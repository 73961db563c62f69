// Greedy symmetric pose clustering on the host, behind a plain C interface.
//
// The port's counterpart of the JAX package's native pose clustering. It runs
// once per object, when the rotation grid is built. Semantics are those of
// core/poses.py::cluster_poses_plain, the numpy version: scan the poses in
// input order and drop a pose iff some already kept pose lies within
// dist_diff in translation AND within angle_diff_deg geodesic rotation for at
// least one symmetry transform applied on the right of the candidate.
//
// The arithmetic follows the numpy version term by term (three-term sums in
// index order, no fused multiply-add: built with -ffp-contract=off), so both
// keep the same poses.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// (Rc * Rs)[i][j] for the upper-left 3x3 blocks of two row-major 4x4 poses.
inline void rot_mult(const double* c, const double* s, double* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[i * 3 + j] = c[i * 4 + 0] * s[0 * 4 + j] + c[i * 4 + 1] * s[1 * 4 + j] +
                       c[i * 4 + 2] * s[2 * 4 + j];
}

// trace(A * K^T) = sum_ij A_ij K_ij, A a 3x3 row-major block, K a 4x4 pose.
inline double trace_mult(const double* a, const double* k) {
  double tr = 0.0;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) tr += a[i * 3 + j] * k[i * 4 + j];
  return tr;
}

}  // namespace

extern "C" {

// poses: n x 16 row-major doubles; sym_tfs: n_sym x 16; keep: n bytes out
// (1 = kept). Returns the number of kept poses.
int64_t fp_cluster_poses(double angle_diff_deg, double dist_diff, const double* poses,
                         int64_t n, const double* sym_tfs, int64_t n_sym, uint8_t* keep) {
  const double radian_thres = angle_diff_deg / 180.0 * M_PI;
  for (int64_t i = 0; i < n; ++i) keep[i] = 0;
  if (n == 0) return 0;
  std::vector<int64_t> kept{0};
  keep[0] = 1;
  std::vector<double> rsym(9 * (n_sym > 0 ? n_sym : 1));
  for (int64_t i = 1; i < n; ++i) {
    const double* cur = poses + i * 16;
    for (int64_t s = 0; s < n_sym; ++s) rot_mult(cur, sym_tfs + s * 16, &rsym[9 * s]);
    bool is_new = true;
    for (size_t c = 0; c < kept.size() && is_new; ++c) {
      const double* cl = poses + kept[c] * 16;
      const double dx = cl[3] - cur[3], dy = cl[7] - cur[7], dz = cl[11] - cur[11];
      if (!(std::sqrt(dx * dx + dy * dy + dz * dz) < dist_diff)) continue;
      for (int64_t s = 0; s < n_sym; ++s) {
        double cosv = (trace_mult(&rsym[9 * s], cl) - 1.0) / 2.0;
        cosv = cosv < -1.0 ? -1.0 : (cosv > 1.0 ? 1.0 : cosv);
        if (std::acos(cosv) < radian_thres) {
          is_new = false;
          break;
        }
      }
    }
    if (is_new) {
      keep[i] = 1;
      kept.push_back(i);
    }
  }
  return static_cast<int64_t>(kept.size());
}

}  // extern "C"
