// Host-side cell-list neighbor search (C++), the PyTorch port's own copy.
//
// An O(N) cell-list radius search used on the host for exact edge counting
// when sizing the fixed-capacity neighbor buffers (ops/neighbors.py). The
// same source as lagrangebench_tpu/native/neighbors.cpp, kept here so the
// port builds and loads nothing of the JAX package.
//
// Conventions match the device kernels: self-edges included, edges emitted
// receiver-major (sorted by receiver), periodic boundaries via the
// minimum-image rule applied to all dimensions if any is periodic.
//
// Build (ops/neighbors_host.py does this on first use):
//   g++ -O3 -shared -fPIC neighbors.cpp -o libneighbors_host.so

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Grid {
  int dim;
  int cps[3];        // cells per side
  double cell[3];    // cell size
  double box[3];
  bool periodic;
  int num_cells;
};

inline int flat_cell(const Grid &g, const int *c) {
  int f = c[0];
  for (int d = 1; d < g.dim; ++d) f = f * g.cps[d] + c[d];
  return f;
}

inline void coords_of(const Grid &g, const double *p, int *c) {
  for (int d = 0; d < g.dim; ++d) {
    int v = (int)std::floor(p[d] / g.cell[d]);
    if (v < 0) v = 0;
    if (v >= g.cps[d]) v = g.cps[d] - 1;
    c[d] = v;
  }
}

inline double dist2(const Grid &g, const double *a, const double *b) {
  double s = 0.0;
  for (int d = 0; d < g.dim; ++d) {
    double diff = a[d] - b[d];
    if (g.periodic) {
      diff -= g.box[d] * std::nearbyint(diff / g.box[d]);
    }
    s += diff * diff;
  }
  return s;
}

}  // namespace

extern "C" {

// Count or emit radius-graph edges.
//
// positions: (n, dim) row-major doubles; box: (dim,) side lengths;
// periodic: 1 if ANY dimension is periodic (all-or-nothing, matching the
// displacement convention); cutoff: radius; num_particles: valid prefix of
// the position array (padding excluded).
//
// If receivers/senders are non-null and e_cap > 0, writes up to e_cap edges
// receiver-major. Returns the TOTAL edge count (which may exceed e_cap —
// the caller compares against capacity for overflow detection). Returns -1
// on invalid input.
int64_t neighbor_edges(const double *positions, int64_t n, int dim,
                       const double *box, int periodic, double cutoff,
                       int64_t num_particles, int32_t *receivers,
                       int32_t *senders, int64_t e_cap) {
  if (dim < 1 || dim > 3 || n < 0 || num_particles > n) return -1;

  Grid g;
  g.dim = dim;
  g.periodic = periodic != 0;
  g.num_cells = 1;
  bool use_cells = true;
  for (int d = 0; d < dim; ++d) {
    g.box[d] = box[d];
    int cps = (int)std::floor(box[d] / cutoff);
    if (cps < 1) cps = 1;
    if (g.periodic && cps < 3) use_cells = false;  // stencil would alias
    g.cps[d] = cps;
    g.cell[d] = box[d] / cps;
    g.num_cells *= cps;
  }
  if (g.num_cells < 27) use_cells = false;

  const double cutoff2 = cutoff * cutoff;
  const int64_t np = num_particles;
  int64_t count = 0;

  auto emit = [&](int64_t i, int64_t j) {
    if (receivers && count < e_cap) {
      receivers[count] = (int32_t)i;
      senders[count] = (int32_t)j;
    }
    ++count;
  };

  if (!use_cells) {
    for (int64_t i = 0; i < np; ++i)
      for (int64_t j = 0; j < np; ++j)
        if (dist2(g, positions + i * dim, positions + j * dim) <= cutoff2)
          emit(i, j);
    return count;
  }

  // bin particles
  std::vector<int32_t> head(g.num_cells, -1), next(np, -1);
  int c[3];
  for (int64_t i = 0; i < np; ++i) {
    coords_of(g, positions + i * dim, c);
    int f = flat_cell(g, c);
    next[i] = head[f];
    head[f] = (int32_t)i;
  }

  // stencil scan, receiver-major
  int lo[3] = {0, 0, 0}, hi[3] = {0, 0, 0};
  for (int64_t i = 0; i < np; ++i) {
    const double *pi = positions + i * dim;
    coords_of(g, pi, c);
    int nc[3] = {0, 0, 0};
    for (int d = 0; d < dim; ++d) { lo[d] = -1; hi[d] = 1; }
    // iterate the 3^dim stencil
    int off[3] = {lo[0], dim > 1 ? lo[1] : 0, dim > 2 ? lo[2] : 0};
    while (true) {
      bool valid = true;
      for (int d = 0; d < dim; ++d) {
        int v = c[d] + off[d];
        if (g.periodic) {
          v = (v + g.cps[d]) % g.cps[d];
        } else if (v < 0 || v >= g.cps[d]) {
          valid = false;
          break;
        }
        nc[d] = v;
      }
      if (valid) {
        for (int32_t j = head[flat_cell(g, nc)]; j >= 0; j = next[j]) {
          if (dist2(g, pi, positions + j * dim) <= cutoff2) emit(i, j);
        }
      }
      // advance stencil counter
      int d = dim - 1;
      while (d >= 0) {
        if (++off[d] <= 1) break;
        off[d] = -1;
        --d;
      }
      if (d < 0) break;
    }
  }
  return count;
}

// Maximum cell occupancy for capacity sizing (same grid as above).
int64_t max_cell_occupancy(const double *positions, int64_t n, int dim,
                           const double *box, double cutoff,
                           int64_t num_particles) {
  if (dim < 1 || dim > 3) return -1;
  Grid g;
  g.dim = dim;
  g.periodic = false;
  g.num_cells = 1;
  for (int d = 0; d < dim; ++d) {
    g.box[d] = box[d];
    int cps = (int)std::floor(box[d] / cutoff);
    if (cps < 1) cps = 1;
    g.cps[d] = cps;
    g.cell[d] = box[d] / cps;
    g.num_cells *= cps;
  }
  std::vector<int32_t> occ(g.num_cells, 0);
  int c[3];
  int32_t best = 0;
  for (int64_t i = 0; i < num_particles; ++i) {
    coords_of(g, positions + i * dim, c);
    int32_t v = ++occ[flat_cell(g, c)];
    if (v > best) best = v;
  }
  return best;
}

}  // extern "C"
