// K3 and K4: the interior-point iteration's small dense eigenvalue and
// singular value solves, a batch of (n, n) float64 matrices, one thread
// block a matrix, by Jacobi rotations.
//
// Replaces no Pallas kernel: they are the counterparts of XLA's eigvalsh
// (bluest_tpu/solvers/sdp.py:320, _max_step_psd) and svd (:304,
// _nt_scaling) inside the JAX package's lax.while_loop, and of the
// cuSOLVER calls behind torch.linalg.eigvalsh and torch.linalg.svd that
// bluest_tpu_torch/solvers/sdp.py made through _eigvalsh and _svd.  Those
// calls read their convergence status back to the host on every call
// (ATen checks the info), so an iteration that made them could not be one
// CUDA graph.  These kernels write a status per matrix to device memory
// instead and never synchronise; the IPM folds the status into the
// factorization statuses of its one packed read.  Their plain versions are
// those torch.linalg calls (bluest_tpu_torch/ops/psd_eig.py).
//
// K3, bluest_sym_eigvalsh_f64: the eigenvalues, ascending, of each
//   symmetric A (B, n, n) -> w (B, n).  Cyclic two-sided Jacobi: a sweep
//   visits every pair (p, q) once, in n_pad - 1 rounds of n_pad / 2
//   disjoint pairs (the round-robin order, n_pad = n rounded up to even;
//   a pair with the padding index is skipped), so one round's rotations
//   are computed together and applied together: rows, then columns, then
//   the pair's closed-form diagonal (a_pp - t a_pq, a_qq + t a_pq) and a
//   zero at (p, q) (Golub and Van Loan, sym.schur2).
// K4, bluest_nt_svd_f64: the left singular vectors U (B, n, n) and the
//   singular values S (B, n), descending, of each M.  One-sided (Hestenes)
//   Jacobi on G = M^T: a rotation of columns p, q of G (rows p, q of M,
//   contiguous here) makes them orthogonal, and the product of the
//   rotations, accumulated from the identity, is U, since G U has
//   orthogonal columns of norms sigma (M^T U = V Sigma).  U is orthogonal
//   whatever the rank of M.  V is not formed: the IPM uses U and sigma
//   alone (M = Ls^T Lz, the NT scaling).
//
// Stopping rule, relative, not absolute: the blocks the IPM hands over
// span scales of 1e-150 to 1e150 between iterations, and their entries
// differ by many orders within one block.  First each matrix is scaled by
// a power of two that brings its largest entry into [1, 2) (exact), and
// its results scaled back.  K3 rotates pair (p, q) while
// |a_pq| > eps * sqrt|a_pp| * sqrt|a_qq|, K4 while
// |g_p . g_q| > n * eps * |g_p| * |g_q| (the dot product's own rounding
// stays below that bound, so a converged pair is never rotated again by
// round-off).  Both skip a pair whose coupling is below eps^2 times the
// matrix's Frobenius norm (K3) or its square (K4), which moves no result
// by more than that: without the floor, K4 on a rank-deficient M keeps
// rotating the columns that orthogonalization left at round-off level
// against each other (they stay nearly parallel) until they underflow,
// ~15 sweeps more at n = 11.  A sweep that rotates no
// pair ends the solve (status 0).  PSD_MAX_SWEEPS sweeps without that end
// it with status 2 (Jacobi converges quadratically: ~6-12 sweeps at the
// IPM's n).  A non-finite entry ends it before any sweep with status 1
// and NaN results.
//
// Bound: latency.  At the IPM's shapes (n = M + 1: 11 on the flagship, 13
// on Hodgkin-Huxley at K=5, up to 33 for a 32-model group; batches of nb
// to 4 nb blocks, 3-20) the work is a few microseconds of the FP64 pipe
// on one SM and the bytes a few kilobytes, while a sweep is n_pad - 1
// dependent rounds of four barriers each: one block a matrix keeps every
// round in one SM's shared memory, and the batch runs on that many SMs
// at once.  No tensor cores: a rotation is two multiplies and an add per
// entry.  Golub and Van Loan count 4n^3/3 flops for the symmetric
// eigenvalues and 12 n^3 for the SVD's sigma and U1 (m = n); chip_smoke.py
// sets the bound from those counts.
//
// Memory: each matrix's working copy (and K4's U) and the round's
// rotations sit in dynamic shared memory while they fit in
// PSD_SHARED_BYTES (n <= 74 for K3, n <= 52 for K4); past that the same
// code runs on a global-memory workspace of bluest_psd_work_doubles(kind,
// n) doubles a matrix that the wrapper allocates, so every n works.
// Each launch is on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#define PSD_MAX_SWEEPS 40
#define PSD_MAX_THREADS 256
// the dynamic shared memory a block may take without opting in (48 KiB),
// less room for the kernel's static shared reduction array
#define PSD_SHARED_BYTES (48 * 1024 - 2 * PSD_MAX_THREADS * 8)

// pair j of round r of the round-robin order of the indices 0..m (m odd:
// n_pad - 1); over the m rounds each unordered pair appears once
__device__ __forceinline__ void pair_of(int r, int j, int m, int* p, int* q)
{
    const int a = j == 0 ? r : (r + j) % m;
    const int b = j == 0 ? m : (r - j + m) % m;
    *p = a < b ? a : b;
    *q = a < b ? b : a;
}

// the largest (sum = false) or the sum (sum = true) of the threads' v;
// the block's threads are a power of two
__device__ double block_reduce(double v, double* red, bool sum)
{
    const int tid = threadIdx.x;
    red[tid] = v;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (tid < s)
            red[tid] = sum ? red[tid] + red[tid + s]
                           : fmax(red[tid], red[tid + s]);
        __syncthreads();
    }
    const double out = red[0];
    __syncthreads();
    return out;
}

// copy a matrix in, scaled by the power of two that brings its largest
// entry into [1, 2); returns false if an entry is not finite, else sets
// *e, the exponent that scales the results back, and *f, the squared
// Frobenius norm of the scaled matrix
__device__ bool load_scaled(const double* __restrict__ src, double* a,
                            int nn, double* red, int* e, double* f)
{
    const int tid = threadIdx.x, nt = blockDim.x;
    double mx = 0.0;
    for (int i = tid; i < nn; i += nt) {
        const double v = src[i];
        a[i] = v;
        mx = fmax(mx, isfinite(v) ? fabs(v) : INFINITY);
    }
    mx = block_reduce(mx, red, false);
    if (!isfinite(mx))
        return false;
    *e = mx > 0.0 ? ilogb(mx) : 0;
    const double sc = ldexp(1.0, -*e);
    double f2 = 0.0;
    for (int i = tid; i < nn; i += nt) {
        a[i] *= sc;
        f2 += a[i] * a[i];
    }
    *f = block_reduce(f2, red, true);
    return true;
}

// -------------------------------- K3 ------------------------------------ //

template <bool SHARED>
__global__ void __launch_bounds__(PSD_MAX_THREADS)
eigvalsh_kernel(const double* __restrict__ A, double* __restrict__ w,
                int* __restrict__ status, double* __restrict__ work, int n)
{
    extern __shared__ double smem[];
    __shared__ double red[PSD_MAX_THREADS];
    const int np = (n + 1) / 2, m = 2 * np - 1;
    const int tid = threadIdx.x, nt = blockDim.x;
    const size_t words = (size_t)n * n + 4 * (size_t)np;
    double* a = SHARED ? smem : work + blockIdx.x * words;
    double* rot = a + (size_t)n * n;      // per pair: c, s, new a_pp, a_qq
    double* out = w + (size_t)blockIdx.x * n;
    int e = 0;
    double f = 0.0;
    if (!load_scaled(A + (size_t)blockIdx.x * n * n, a, n * n, red, &e, &f)) {
        for (int i = tid; i < n; i += nt)
            out[i] = NAN;
        if (tid == 0)
            status[blockIdx.x] = 1;
        return;
    }
    const double floor = DBL_EPSILON * DBL_EPSILON * sqrt(f);
    bool converged = false;
    for (int sweep = 0; sweep < PSD_MAX_SWEEPS && !converged; ++sweep) {
        int rotated = 0;
        for (int r = 0; r < m; ++r) {
            for (int j = tid; j < np; j += nt) {
                int p, q;
                pair_of(r, j, m, &p, &q);
                double c = 0.0, s = 0.0, dp = 0.0, dq = 0.0;
                if (q < n) {
                    const double apq = a[p * n + q];
                    const double app = a[p * n + p], aqq = a[q * n + q];
                    if (fabs(apq) > fmax(DBL_EPSILON * sqrt(fabs(app))
                                         * sqrt(fabs(aqq)), floor)) {
                        const double tau = (aqq - app) / (2.0 * apq);
                        const double t = (tau >= 0.0 ? 1.0 : -1.0)
                            / (fabs(tau) + hypot(1.0, tau));
                        c = 1.0 / sqrt(1.0 + t * t);
                        s = t * c;
                        dp = app - t * apq;
                        dq = aqq + t * apq;
                        rotated = 1;
                    }
                }
                rot[4 * j] = c;             // c = 0: no rotation
                rot[4 * j + 1] = s;
                rot[4 * j + 2] = dp;
                rot[4 * j + 3] = dq;
            }
            __syncthreads();
            for (int i = tid; i < np * n; i += nt) {      // rows: J^T A
                const int j = i / n, k = i - j * n;
                const double c = rot[4 * j], s = rot[4 * j + 1];
                if (c == 0.0)
                    continue;
                int p, q;
                pair_of(r, j, m, &p, &q);
                const double x = a[p * n + k], y = a[q * n + k];
                a[p * n + k] = c * x - s * y;
                a[q * n + k] = s * x + c * y;
            }
            __syncthreads();
            for (int i = tid; i < np * n; i += nt) {      // columns: (J^T A) J
                const int k = i / np, j = i - k * np;
                const double c = rot[4 * j], s = rot[4 * j + 1];
                if (c == 0.0)
                    continue;
                int p, q;
                pair_of(r, j, m, &p, &q);
                const double x = a[k * n + p], y = a[k * n + q];
                a[k * n + p] = c * x - s * y;
                a[k * n + q] = s * x + c * y;
            }
            __syncthreads();
            for (int j = tid; j < np; j += nt) {
                if (rot[4 * j] == 0.0)
                    continue;
                int p, q;
                pair_of(r, j, m, &p, &q);
                a[p * n + p] = rot[4 * j + 2];
                a[q * n + q] = rot[4 * j + 3];
                a[p * n + q] = 0.0;
                a[q * n + p] = 0.0;
            }
            __syncthreads();
        }
        converged = !__syncthreads_or(rotated);
    }
    // the diagonal, scaled back, in ascending order (rank by comparison)
    int bad = 0;
    for (int i = tid; i < n; i += nt) {
        const double d = a[i * n + i];
        int rank = 0;
        for (int k = 0; k < n; ++k) {
            const double o = a[k * n + k];
            rank += (o < d) || (o == d && k < i);
        }
        const double v = ldexp(d, e);
        out[rank] = v;
        bad |= !isfinite(v);
    }
    bad = __syncthreads_or(bad);
    if (tid == 0)
        status[blockIdx.x] = bad ? 1 : (converged ? 0 : 2);
}

// -------------------------------- K4 ------------------------------------ //

template <bool SHARED>
__global__ void __launch_bounds__(PSD_MAX_THREADS)
nt_svd_kernel(const double* __restrict__ M, double* __restrict__ U,
              double* __restrict__ S, int* __restrict__ status,
              double* __restrict__ work, int n)
{
    extern __shared__ double smem[];
    __shared__ double red[PSD_MAX_THREADS];
    const int np = (n + 1) / 2, m = 2 * np - 1;
    const int tid = threadIdx.x, nt = blockDim.x;
    const size_t nn = (size_t)n * n;
    const size_t words = 2 * nn + 4 * (size_t)np;
    double* g = SHARED ? smem : work + blockIdx.x * words;   // g[j][k] = M[j][k]
    double* v = g + nn;                    // v[j][k] = U[k][j]: U's columns
    double* rot = v + nn;                  // per pair: c, s; then sigma, order
    double* u_out = U + blockIdx.x * nn;
    double* s_out = S + (size_t)blockIdx.x * n;
    int e = 0;
    double f = 0.0;
    if (!load_scaled(M + blockIdx.x * nn, g, n * n, red, &e, &f)) {
        for (int i = tid; i < n * n; i += nt)
            u_out[i] = NAN;
        for (int i = tid; i < n; i += nt)
            s_out[i] = NAN;
        if (tid == 0)
            status[blockIdx.x] = 1;
        return;
    }
    for (int i = tid; i < n * n; i += nt)
        v[i] = (i / n == i % n) ? 1.0 : 0.0;
    __syncthreads();
    const double tol = n * DBL_EPSILON;
    const double floor = DBL_EPSILON * DBL_EPSILON * f;
    bool converged = false;
    for (int sweep = 0; sweep < PSD_MAX_SWEEPS && !converged; ++sweep) {
        int rotated = 0;
        for (int r = 0; r < m; ++r) {
            for (int j = tid; j < np; j += nt) {
                int p, q;
                pair_of(r, j, m, &p, &q);
                double c = 0.0, s = 0.0;
                if (q < n) {
                    double alpha = 0.0, beta = 0.0, gamma = 0.0;
                    for (int k = 0; k < n; ++k) {
                        const double x = g[p * n + k], y = g[q * n + k];
                        alpha += x * x;
                        beta += y * y;
                        gamma += x * y;
                    }
                    if (fabs(gamma) > fmax(tol * sqrt(alpha) * sqrt(beta),
                                           floor)) {
                        const double zeta = (beta - alpha) / (2.0 * gamma);
                        const double t = (zeta >= 0.0 ? 1.0 : -1.0)
                            / (fabs(zeta) + hypot(1.0, zeta));
                        c = 1.0 / sqrt(1.0 + t * t);
                        s = t * c;
                        rotated = 1;
                    }
                }
                rot[2 * j] = c;             // c = 0: no rotation
                rot[2 * j + 1] = s;
            }
            __syncthreads();
            for (int i = tid; i < np * n; i += nt) {
                const int j = i / n, k = i - j * n;
                const double c = rot[2 * j], s = rot[2 * j + 1];
                if (c == 0.0)
                    continue;
                int p, q;
                pair_of(r, j, m, &p, &q);
                const double x = g[p * n + k], y = g[q * n + k];
                g[p * n + k] = c * x - s * y;
                g[q * n + k] = s * x + c * y;
                const double ux = v[p * n + k], uy = v[q * n + k];
                v[p * n + k] = c * ux - s * uy;
                v[q * n + k] = s * ux + c * uy;
            }
            __syncthreads();
        }
        converged = !__syncthreads_or(rotated);
    }
    // sigma_j = |g_j|; rot[0..n) sigma, rot[n..2n) the column of U that
    // goes to each place of the descending order (2n <= 4 np words)
    for (int j = tid; j < n; j += nt) {
        double a2 = 0.0;
        for (int k = 0; k < n; ++k)
            a2 += g[j * n + k] * g[j * n + k];
        rot[j] = sqrt(a2);
    }
    __syncthreads();
    int bad = 0;
    for (int j = tid; j < n; j += nt) {
        const double sj = rot[j];
        int rank = 0;
        for (int k = 0; k < n; ++k)
            rank += (rot[k] > sj) || (rot[k] == sj && k < j);
        rot[n + rank] = (double)j;
        const double sv = ldexp(sj, e);
        s_out[rank] = sv;
        bad |= !isfinite(sv);
    }
    bad = __syncthreads_or(bad);
    for (int i = tid; i < n * n; i += nt) {       // U[k][c] = v[order[c]][k]
        const int k = i / n, col = i - k * n;
        u_out[i] = v[(int)rot[n + col] * n + k];
    }
    if (tid == 0)
        status[blockIdx.x] = bad ? 1 : (converged ? 0 : 2);
}

// ------------------------------ C interface ------------------------------ //

static int threads_for(int n)
{
    const int items = ((n + 1) / 2) * n;
    int t = 32;
    while (t < items && t < PSD_MAX_THREADS)
        t *= 2;
    return t;
}

static size_t words_for(int kind, int n)
{
    const size_t nn = (size_t)n * n, np = (size_t)(n + 1) / 2;
    return (kind == 3 ? nn : 2 * nn) + 4 * np;
}

// doubles of global workspace a matrix needs (kind 3: K3, 4: K4), 0 when
// its working set fits in shared memory
extern "C" long long bluest_psd_work_doubles(int kind, int n)
{
    const size_t words = words_for(kind, n);
    return words * sizeof(double) <= PSD_SHARED_BYTES ? 0 : (long long)words;
}

extern "C" int bluest_sym_eigvalsh_f64(const double* A, double* w,
                                       int* status, double* work, int batch,
                                       int n, void* stream)
{
    cudaStream_t s = (cudaStream_t)stream;
    const size_t bytes = words_for(3, n) * sizeof(double);
    if (bytes <= PSD_SHARED_BYTES)
        eigvalsh_kernel<true><<<batch, threads_for(n), bytes, s>>>(
            A, w, status, work, n);
    else
        eigvalsh_kernel<false><<<batch, threads_for(n), 0, s>>>(
            A, w, status, work, n);
    return (int)cudaGetLastError();
}

extern "C" int bluest_nt_svd_f64(const double* M, double* U, double* S,
                                 int* status, double* work, int batch, int n,
                                 void* stream)
{
    cudaStream_t s = (cudaStream_t)stream;
    const size_t bytes = words_for(4, n) * sizeof(double);
    if (bytes <= PSD_SHARED_BYTES)
        nt_svd_kernel<true><<<batch, threads_for(n), bytes, s>>>(
            M, U, S, status, work, n);
    else
        nt_svd_kernel<false><<<batch, threads_for(n), 0, s>>>(
            M, U, S, status, work, n);
    return (int)cudaGetLastError();
}
