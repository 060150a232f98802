// Native eval engine: Hungarian assignment + maximum-IoU score matrices.
//
// The reference's maximum-IoU metric is a double-Hungarian over layout sets
// (`helpers/metric.py:300-371`) and its hot loop is pure-python pair
// iteration (SURVEY.md §7 "hard parts" #5).  This module moves the whole
// group computation native: per-label IoU submatrices, the O(n^2 m)
// potential-based Hungarian, and the N x M score matrix over layout pairs.
// Exposed via a C ABI for ctypes (no pybind11 dependency).
//
// Built at first use by native/__init__.py (g++, into layoutdm_tpu_torch/_build/).

#include <algorithm>
#include <cmath>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double INF = std::numeric_limits<double>::infinity();

// Potential-based Hungarian algorithm (shortest augmenting paths),
// minimizing total cost of an n x m assignment, n <= m.
// cost is row-major n*m; col4row[i] = column assigned to row i.
double hungarian_min(int n, int m, const double* cost, int* col4row) {
  // 1-indexed potentials and matching (column 0 is virtual)
  std::vector<double> u(n + 1, 0.0), v(m + 1, 0.0);
  std::vector<int> p(m + 1, 0), way(m + 1, 0);
  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(m + 1, INF);
    std::vector<char> used(m + 1, 0);
    do {
      used[j0] = 1;
      int i0 = p[j0], j1 = -1;
      double delta = INF;
      for (int j = 1; j <= m; ++j) {
        if (used[j]) continue;
        double cur = cost[(i0 - 1) * m + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int j = 0; j <= m; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    do {
      int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  double total = 0.0;
  for (int j = 1; j <= m; ++j) {
    if (p[j] > 0) {
      col4row[p[j] - 1] = j - 1;
      total += cost[(p[j] - 1) * m + (j - 1)];
    }
  }
  return total;
}

inline double iou(const float* a, const float* b) {
  // center-xywh boxes
  double l1 = a[0] - a[2] / 2, t1 = a[1] - a[3] / 2;
  double r1 = a[0] + a[2] / 2, b1 = a[1] + a[3] / 2;
  double l2 = b[0] - b[2] / 2, t2 = b[1] - b[3] / 2;
  double r2 = b[0] + b[2] / 2, b2 = b[1] + b[3] / 2;
  double a1 = (r1 - l1) * (b1 - t1);
  double a2 = (r2 - l2) * (b2 - t2);
  double lmax = std::max(l1, l2), rmin = std::min(r1, r2);
  double tmax = std::max(t1, t2), bmin = std::min(b1, b2);
  double ai = 0.0;
  if (lmax < rmin && tmax < bmin) ai = (rmin - lmax) * (bmin - tmax);
  double au = a1 + a2 - ai;
  return au > 0.0 ? ai / au : 0.0;
}

// score for one layout pair with identical label multisets
// (`metric.py:300-314`): per shared label, optimal IoU matching; sum / N.
double pair_score(const float* b1, const int* l1, int n1, const float* b2,
                  const int* l2, int n2) {
  if (n1 == 0) return 0.0;
  std::vector<int> labels(l1, l1 + n1);
  std::sort(labels.begin(), labels.end());
  labels.erase(std::unique(labels.begin(), labels.end()), labels.end());

  double score = 0.0;
  std::vector<int> idx1, idx2;
  std::vector<double> cost;
  std::vector<int> assign;
  for (int lab : labels) {
    idx1.clear();
    idx2.clear();
    for (int i = 0; i < n1; ++i)
      if (l1[i] == lab) idx1.push_back(i);
    for (int j = 0; j < n2; ++j)
      if (l2[j] == lab) idx2.push_back(j);
    int k1 = (int)idx1.size(), k2 = (int)idx2.size();
    if (k1 == 0 || k2 == 0) continue;
    int n = std::min(k1, k2), m = std::max(k1, k2);
    bool flip = k1 > k2;
    cost.assign((size_t)n * m, 0.0);
    for (int i = 0; i < k1; ++i) {
      for (int j = 0; j < k2; ++j) {
        double w = iou(b1 + 4 * idx1[i], b2 + 4 * idx2[j]);
        if (flip)
          cost[(size_t)j * m + i] = -w;  // rows = smaller side
        else
          cost[(size_t)i * m + j] = -w;
      }
    }
    assign.assign(n, -1);
    score += -hungarian_min(n, m, cost.data(), assign.data());
  }
  return score / n1;
}

}  // namespace

extern "C" {

// Rectangular LSAP.  cost: n*m row-major.  col4row: length n (only valid for
// matched rows; with n <= m all rows match).  Set maximize != 0 to maximize.
double solve_lsap(const double* cost, int n, int m, int* col4row,
                  int maximize) {
  std::vector<double> c(cost, cost + (size_t)n * m);
  bool transposed = n > m;
  int rn = n, rm = m;
  std::vector<double> ct;
  if (transposed) {
    ct.resize((size_t)n * m);
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < m; ++j) ct[(size_t)j * n + i] = c[(size_t)i * m + j];
    c.swap(ct);
    rn = m;
    rm = n;
  }
  if (maximize)
    for (auto& x : c) x = -x;
  std::vector<int> a(rn, -1);
  double total = hungarian_min(rn, rm, c.data(), a.data());
  if (maximize) total = -total;
  for (int i = 0; i < n; ++i) col4row[i] = -1;
  if (transposed) {
    for (int j = 0; j < rn; ++j)
      if (a[j] >= 0) col4row[a[j]] = j;
  } else {
    for (int i = 0; i < rn; ++i) col4row[i] = a[i];
  }
  return total;
}

// Maximum-IoU score matrix between two groups of layouts sharing a label
// multiset (`metric.py:317-329`).  Boxes are concatenated (sum(n)*4 floats);
// offsets have length N+1 / M+1.
void max_iou_score_matrix(const float* boxes1, const int* labels1,
                          const int* offsets1, int N, const float* boxes2,
                          const int* labels2, const int* offsets2, int M,
                          double* out) {
#pragma omp parallel for collapse(2) schedule(dynamic)
  for (int i = 0; i < N; ++i) {
    for (int j = 0; j < M; ++j) {
      int s1 = offsets1[i], e1 = offsets1[i + 1];
      int s2 = offsets2[j], e2 = offsets2[j + 1];
      out[(size_t)i * M + j] =
          pair_score(boxes1 + 4 * s1, labels1 + s1, e1 - s1, boxes2 + 4 * s2,
                     labels2 + s2, e2 - s2);
    }
  }
}

// DocSim between aligned layout pairs (`metric.py:434-507`): per pair,
// optimal assignment over the position/size similarity kernel, mean of the
// matched weights; 0 when element counts differ by >= max_diff_thresh.
void docsim_pairs(const float* boxes1, const int* labels1,
                  const int* offsets1, const float* boxes2,
                  const int* labels2, const int* offsets2, int n_pairs,
                  int max_diff_thresh, double* out) {
#pragma omp parallel for schedule(dynamic)
  for (int p = 0; p < n_pairs; ++p) {
    int s1 = offsets1[p], e1 = offsets1[p + 1];
    int s2 = offsets2[p], e2 = offsets2[p + 1];
    int n = e1 - s1, m = e2 - s2;
    if (n >= m + max_diff_thresh || n <= m - max_diff_thresh || n == 0 ||
        m == 0) {
      out[p] = 0.0;
      continue;
    }
    std::vector<double> w((size_t)n * m, 0.0);
    for (int i = 0; i < n; ++i) {
      const float* b1 = boxes1 + 4 * (s1 + i);
      for (int j = 0; j < m; ++j) {
        if (labels1[s1 + i] != labels2[s2 + j]) continue;
        const float* b2 = boxes2 + 4 * (s2 + j);
        double dc = std::sqrt((b1[0] - b2[0]) * (b1[0] - b2[0]) +
                              (b1[1] - b2[1]) * (b1[1] - b2[1]));
        double dsz = std::abs(b1[2] - b2[2]) + std::abs(b1[3] - b2[3]);
        double area = std::min((double)b1[2] * b1[3], (double)b2[2] * b2[3]);
        double alpha = std::pow(std::max(area, 0.0), 0.5);
        w[(size_t)i * m + j] = alpha * std::pow(2.0, -dc - 2.0 * dsz);
      }
    }
    // maximize => minimize negated; rows must be the smaller side
    int rn = std::min(n, m), rm = std::max(n, m);
    std::vector<double> cost((size_t)rn * rm);
    if (n <= m) {
      for (size_t k = 0; k < w.size(); ++k) cost[k] = -w[k];
    } else {
      for (int i = 0; i < n; ++i)
        for (int j = 0; j < m; ++j)
          cost[(size_t)j * rm + i] = -w[(size_t)i * m + j];
    }
    std::vector<int> assign(rn, -1);
    double total = -hungarian_min(rn, rm, cost.data(), assign.data());
    out[p] = total / rn;
  }
}

}  // extern "C"
