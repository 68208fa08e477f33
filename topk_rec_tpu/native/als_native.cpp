// Native CPU weighted-ALS solver: golden reference + host fallback.
//
// The host equivalent of the reference's GSL collaborative-regression
// solver (old/cr/cr.cpp:71-326): confidence-weighted normal equations with
// the a/b background trick and an optional content prior, solved per entity
// with a dense Cholesky factorization (k <= a few hundred). Used to
// cross-check the batched device ALS (ops/als.py) in tests and as a
// host-side fallback when no accelerator is present.
//
// Semantics (matching ops/als.py::half_sweep):
//   A_t = b * Gram + (a-b) * sum_{j in I_t} v_j v_j^T + lam * I
//   A_t x_t = a * sum_{j in I_t} v_j  (+ lam * prior_t when prior != NULL)
// where Gram = V_rated^T V_rated over rows with >= 1 rating.
// Without a prior, entities with empty I_t keep their current value
// (reference wmf.py:82 guard); with a prior every entity is solved
// (reference cer.py:49-63).
//
// Build: make -C topk_rec_tpu/native

#include <cmath>
#include <cstring>
#include <vector>

extern "C" {

// In-place Cholesky solve of A x = rhs for SPD A (k x k, row-major).
// Returns 0 on success, 1 if not positive definite.
static int chol_solve(double* A, double* rhs, int k) {
  // factorize A = L L^T (lower in-place)
  for (int i = 0; i < k; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = A[i * k + j];
      for (int p = 0; p < j; ++p) s -= A[i * k + p] * A[j * k + p];
      if (i == j) {
        if (s <= 0.0) return 1;
        A[i * k + i] = std::sqrt(s);
      } else {
        A[i * k + j] = s / A[j * k + j];
      }
    }
  }
  // forward substitution L y = rhs
  for (int i = 0; i < k; ++i) {
    double s = rhs[i];
    for (int p = 0; p < i; ++p) s -= A[i * k + p] * rhs[p];
    rhs[i] = s / A[i * k + i];
  }
  // back substitution L^T x = y
  for (int i = k - 1; i >= 0; --i) {
    double s = rhs[i];
    for (int p = i + 1; p < k; ++p) s -= A[p * k + i] * rhs[p];
    rhs[i] = s / A[i * k + i];
  }
  return 0;
}

// One ALS half-sweep. Arrays are float32 row-major.
//   this_emb   [n_this, k]   in/out — updated side
//   other_emb  [n_other, k]  fixed side
//   indptr     [n_this + 1]  CSR into `flat`
//   flat       [nnz]         other-side indices of positives
//   rated_other[n_rated]     rows of other_emb with >= 1 rating (Gram)
//   prior      [n_this, k] or NULL
// Returns 0 on success.
int tkr_als_half_sweep(float* this_emb, long long n_this,
                       const float* other_emb, long long n_other,
                       const int* indptr, const int* flat,
                       const int* rated_other, long long n_rated, int k,
                       float a, float b, float lam, const float* prior) {
  // Gram = b * sum over rated rows of v v^T  (+ lam I added per entity)
  std::vector<double> gram((size_t)k * k, 0.0);
  for (long long r = 0; r < n_rated; ++r) {
    const float* v = other_emb + (size_t)rated_other[r] * k;
    for (int i = 0; i < k; ++i)
      for (int j = 0; j < k; ++j) gram[i * k + j] += (double)v[i] * v[j];
  }
  for (int i = 0; i < k * k; ++i) gram[i] *= b;

  std::vector<double> A((size_t)k * k);
  std::vector<double> rhs(k);
  for (long long t = 0; t < n_this; ++t) {
    int lo = indptr[t], hi = indptr[t + 1];
    if (hi == lo && prior == nullptr) continue;  // keep old value
    std::memcpy(A.data(), gram.data(), sizeof(double) * k * k);
    std::fill(rhs.begin(), rhs.end(), 0.0);
    for (int e = lo; e < hi; ++e) {
      const float* v = other_emb + (size_t)flat[e] * k;
      for (int i = 0; i < k; ++i) {
        for (int j = 0; j < k; ++j)
          A[i * k + j] += (double)(a - b) * v[i] * v[j];
        rhs[i] += (double)a * v[i];
      }
    }
    for (int i = 0; i < k; ++i) A[i * k + i] += lam;
    if (prior) {
      const float* p = prior + (size_t)t * k;
      for (int i = 0; i < k; ++i) rhs[i] += (double)lam * p[i];
    }
    if (chol_solve(A.data(), rhs.data(), k) != 0) return 1;
    float* out = this_emb + (size_t)t * k;
    for (int i = 0; i < k; ++i) out[i] = (float)rhs[i];
  }
  return 0;
}

}  // extern "C"
