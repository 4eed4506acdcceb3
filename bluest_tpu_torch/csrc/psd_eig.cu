// K3, K4 and K5: the allocation's small dense eigenvalue, singular value
// and eigenvector solves, a batch of (n, n) float64 matrices, by Jacobi
// rotations: one warp a matrix for n <= 32, one thread block a matrix
// past that.
//
// Replaces no Pallas kernel: K3 and K4 are the counterparts of XLA's
// eigvalsh (bluest_tpu/solvers/sdp.py:320, _max_step_psd) and svd (:304,
// _nt_scaling) inside the JAX package's lax.while_loop, and of the
// cuSOLVER calls behind torch.linalg.eigvalsh and torch.linalg.svd that
// bluest_tpu_torch/solvers/sdp.py made through _eigvalsh and _svd.  K5
// replaces XLA's eigh in the integer corner search
// (bluest_tpu/solvers/integer.py:93, _chunk_var00), the Hermitian
// pseudo-inverse (core/psi.py:92), the SPD clip (linalg/spd.py:27) and
// ADMM's PSD projections (solvers/admm.py:244, 371), and the cuSOLVER
// torch.linalg.eigh behind the port's copies of them.  Those calls read
// their convergence status back to the host on every call (ATen checks
// the info), so an iteration that made them could not be one CUDA graph,
// and the corner search paid a synchronisation per chunk.  These kernels
// write a status per matrix to device memory instead and never
// synchronise; the IPM folds the status into the factorization statuses
// of its one packed read, the corner search reads it with the results.
// Their plain versions are those torch.linalg calls
// (bluest_tpu_torch/ops/psd_eig.py).
//
// K3, bluest_sym_eigvalsh_f64: the eigenvalues, ascending, of each
//   symmetric A (B, n, n) -> w (B, n), from its lower triangle (as
//   torch.linalg.eigvalsh reads it).  Cyclic two-sided Jacobi: a sweep
//   visits every pair (p, q) once, in n_pad - 1 rounds of n_pad / 2
//   disjoint pairs (the round-robin order, n_pad = n rounded up to even;
//   a pair with the padding index never rotates), so one round's
//   rotations are computed together and applied together: rows, then
//   columns, then the pair's closed-form diagonal (a_pp - t a_pq,
//   a_qq + t a_pq) and a zero at (p, q) (Golub and Van Loan, sym.schur2).
// K5, bluest_sym_eigh_f64 and bluest_pinv00_f64: K3 with its rotations
//   accumulated (a template mode of K3's kernels, so K3's eigenvalues are
//   K5's, bit for bit).  V starts at the identity and takes each rotation
//   J of the pair (p, q) on its columns p and q, V J, as A's columns do;
//   at the end A = V diag(w) V^T.  sym_eigh returns w ascending with V's
//   columns moved alike.  pinv00 returns pinv(A)[0, 0] = sum v0_j^2 / w_j
//   over |w_j| > rcond max|w| (the JAX package's _chunk_var00 cutoff), and
//   accumulates only the row e0^T V: n values a matrix, rotated by the
//   same c and s.
// K4, bluest_nt_svd_f64: the left singular vectors U (B, n, n) and the
//   singular values S (B, n), descending, of each M.  One-sided (Hestenes)
//   Jacobi on G = M^T: a rotation of columns p, q of G (rows p, q of M)
//   makes them orthogonal, and the product of the rotations, accumulated
//   from the identity, is U, since G U has orthogonal columns of norms
//   sigma (M^T U = V Sigma).  U is orthogonal whatever the rank of M.  V
//   is not formed: the IPM uses U and sigma alone (M = Ls^T Lz, the NT
//   scaling).  Same round-robin order.
//
// The rotation (rotation() below): with d = a_qq - a_pp, GVL's
// t = sign(tau) / (|tau| + sqrt(1 + tau^2)), tau = d / (2 a_pq), taken as
// t = sign(tau) 2 |a_pq| / (|d| + sqrt(d^2 + 4 a_pq^2)), the same number
// with one division fewer; c = rsqrt(1 + t^2), s = t c.  K4 takes
// beta - alpha and gamma, the rows' squared norms and their dot product,
// in place of d and a_pq.  The scaling below bounds every operand by the
// scaled matrix's Frobenius norm (< 2n) or its square, so the squares
// cannot overflow, and the floor keeps a_pq^2 clear of underflow.
//
// Stopping rule, relative, not absolute: the blocks the IPM hands over
// span scales of 1e-150 to 1e150 between iterations, and their entries
// differ by many orders within one block.  First each matrix is scaled by
// a power of two that brings its largest entry into [1, 2) (exact), and
// its results scaled back.  K3 rotates pair (p, q) while
// a_pq^2 > eps^2 |a_pp a_qq|, K4 while gamma^2 > (n eps)^2 alpha beta
// (the dot product's own rounding stays below that bound, so a converged
// pair is never rotated again by round-off); squares, so no sqrt sits in
// the test.  Both skip a pair whose coupling is below eps^2 times the
// matrix's Frobenius norm (K3) or its square (K4), which moves no result
// by more than that, and keeps the squares clear of underflow: without
// the floor, K4 on a rank-deficient M keeps rotating the rows that
// orthogonalization left at round-off level against each other (they
// stay nearly parallel) until they underflow, ~15 sweeps more at n = 11.
// A sweep that rotates no pair ends the solve (status 0).  PSD_MAX_SWEEPS
// sweeps without that end it with status 2 (Jacobi converges
// quadratically: ~6-12 sweeps at the IPM's n).  A non-finite entry,
// anywhere in the matrix, ends it before any sweep with status 1 and NaN
// results.
//
// Bound: latency.  At the IPM's shapes (n = M + 1: 11 on the flagship, 13
// on Hodgkin-Huxley at K=5, up to 33 for a 32-model group; batches of nb
// to 4 nb blocks, 3-20) the work is a few kiloflops on a few kilobytes:
// microseconds of one SM's FP64 pipe, nanoseconds of HBM.  The time is a
// chain of dependent rounds, sweeps x (n_pad - 1) of them for the slowest
// matrix of a call (~90-110 at n = 11, ~130-145 at n = 13), so a call
// takes rounds x the cycles a round.  A round is a chain of dependent
// steps: the pair's loads or row exchange, the threshold and the warp's
// vote, the rotation chain (a sqrt, a division and an rsqrt in FP64, each
// a Newton sequence of dependent FMAs), the exchange of c and s, the
// updates.  One matrix a warp leaves nothing to hide their latency, so
// the design shortens the chain and removes the block-wide steps:
// - one warp a matrix (n <= 32): the round needs no block barrier.  K4
//   keeps the matrix in registers, lane j row j of M and column j of U;
//   a lane trades its row with its partner by __shfl_sync at
//   compile-time register indices, both lanes of a pair compute alpha,
//   beta and gamma in the same order (so the same c and s), and each
//   rotates its own row: no shared memory, no barrier.  K3's two-sided
//   rotation also mixes columns, so the matrix sits in the warp's shared
//   memory and the round works on 2 x 2 blocks: lane P < n_pad / 2 owns
//   pair P and its diagonal block, the other lanes the blocks (P, Q),
//   P < Q, of two pairs, each block rotated by rows, then by columns, in
//   registers and stored with its transpose (so the matrix stays exactly
//   symmetric), one __syncwarp a round;
// - no integer division in a round: a lane's partner (K4) and its
//   blocks' pairs (K3) advance by one add and one compare a round;
// - the sweep's vote is __any_sync, and a round in which no pair rotates
//   skips its updates (every round of the last sweep);
// - squares in the threshold, t without tau's division and one rsqrt for
//   c shorten the chain;
// - warp shuffles reduce the scaling's largest entry and its norm.
// - K5's V is one-sided: the lane of pair (p, q) owns V's columns p and
//   q for the round, so it rotates them alone (n pairs of entries a
//   round; of e0^T V one), and the round's one __syncwarp still
//   suffices.  Its bound at the corner search's batches (n = 10, 8192
//   blocks) is ~2.2 us either way: 6.6 MB read at 3.35 TB/s, or Golub
//   and Van Loan's ~9 n^3 flops a block with the vectors at 34 TFLOP/s;
//   far from reached, for the same reason as K3's.
// Past n = 32 (the 32-model group's 33) the block kernels run: each
// thread block one matrix, the round's phases parted by __syncthreads,
// the same pairs, rotation and thresholds; they compute both triangles
// of K3's matrix, which therefore differ from each other by rounding.
// No tensor cores: a rotation is two multiplies and an add per entry.
// Golub and Van Loan count 4n^3/3 flops for the symmetric eigenvalues and
// 12 n^3 for the SVD's sigma and U1 (m = n); chip_smoke.py sets the
// bound from those counts.
//
// Memory: a warp kernel's matrix (K3, K5) sits in n_pad (n_pad + 1)
// doubles of dynamic shared memory, K5's V in as many more beside it (its
// e0^T V in n_pad + 1), K4's in registers (instantiated per even
// n_pad, so every register index is a constant).  A block kernel's
// working copy (and K4's U) and the round's rotations sit in dynamic
// shared memory while they fit in PSD_SHARED_BYTES (n <= 74 for K3,
// n <= 52 for K4); past that the same code runs on a global-memory
// workspace of bluest_psd_work_doubles(kind, n) doubles a matrix that the
// wrapper allocates, so every n works.  Each launch is on the caller's
// stream, allocates nothing and returns cudaGetLastError().  A non-null
// `sweeps` receives the sweeps each matrix took (measurement only; the
// wrappers pass null).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#define PSD_MAX_SWEEPS 40
#define PSD_MAX_THREADS 256
// the dynamic shared memory a block may take without opting in (48 KiB),
// less room for the kernel's static shared reduction array
#define PSD_SHARED_BYTES (48 * 1024 - 2 * PSD_MAX_THREADS * 8)
// the largest n one warp solves
#define PSD_WARP_N 32
#define PSD_FULL 0xffffffffu
#define PSD_EPS2 (DBL_EPSILON * DBL_EPSILON)
// what an eigenvalue kernel returns: K3's eigenvalues, K5's eigenvalues
// and vectors (sym_eigh), or K5's pinv(A)[0, 0] (pinv00)
#define PSD_VALS 0
#define PSD_VECS 1
#define PSD_PINV 2

// the rotation that zeroes the coupling `num` of a pair whose diagonal
// difference is `diff` (a_qq - a_pp, or beta - alpha): t, c and s
__device__ __forceinline__ void rotation(double num, double diff, double* t,
                                         double* c, double* s)
{
    const double n2 = 2.0 * fabs(num);
    const double root = sqrt(fma(diff, diff, n2 * n2));
    // the sign of tau = diff / (2 num), +1 at tau = 0
    const bool plus = diff == 0.0 || ((diff > 0.0) == (num > 0.0));
    *t = (plus ? n2 : -n2) / (fabs(diff) + root);
    *c = rsqrt(fma(*t, *t, 1.0));
    *s = *t * *c;
}

// K3's test: does the coupling a_pq of diagonal entries a_pp, a_qq rotate
__device__ __forceinline__ bool k3_rotates(double apq, double app, double aqq,
                                           double floor)
{
    return fabs(apq) > floor && apq * apq > PSD_EPS2 * fabs(app * aqq);
}

// K4's test, with tol2 = (n eps)^2
__device__ __forceinline__ bool k4_rotates(double gamma, double alpha,
                                           double beta, double tol2,
                                           double floor)
{
    return fabs(gamma) > floor && gamma * gamma > tol2 * alpha * beta;
}

// the next round's index of a pair slot (round robin over 0..m, m odd:
// every index but m moves one on, modulo m)
__device__ __forceinline__ int next_index(int i, int m)
{
    return i == m ? m : (i + 1 == m ? 0 : i + 1);
}

__device__ __forceinline__ double warp_max(double v)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmax(v, __shfl_xor_sync(PSD_FULL, v, o));
    return v;
}

__device__ __forceinline__ double warp_sum(double v)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(PSD_FULL, v, o);
    return v;
}

// the exponent that brings the largest entry mx into [1, 2)
__device__ __forceinline__ int scale_exponent(double mx)
{
    return mx > 0.0 ? ilogb(mx) : 0;
}

// columns p and q of a row of V times a rotation (V J, as A J rotates A's
// columns)
__device__ __forceinline__ void rotate_pair(double* row, int p, int q,
                                            double c, double s)
{
    const double x = row[p], y = row[q];
    row[p] = c * x - s * y;
    row[q] = s * x + c * y;
}

// NaN outputs of a matrix with a non-finite entry, written by threads tid
// of nt (out: the matrix's eigenvalues; vecs: the batch's V or var)
template <int MODE>
__device__ void psd_nan_outputs(double* out, double* vecs, int n, int tid,
                                int nt)
{
    if (MODE != PSD_PINV)
        for (int i = tid; i < n; i += nt)
            out[i] = NAN;
    if (MODE == PSD_VECS)
        for (int i = tid; i < n * n; i += nt)
            vecs[(size_t)blockIdx.x * n * n + i] = NAN;
    if (MODE == PSD_PINV && tid == 0)
        vecs[blockIdx.x] = NAN;
}

// --------------------- K3 and K5, one warp a matrix --------------------- //

// ITEMS: the most 2 x 2 blocks a lane owns, ceil((n_pad / 2)(n_pad / 2 + 1)
// / 2 / 32); the block grid is one warp of 32 threads a matrix
template <int ITEMS, int MODE>
__global__ void __launch_bounds__(32)
eigvalsh_warp_kernel(const double* __restrict__ A, double* __restrict__ w,
                     double* __restrict__ vecs, int* __restrict__ status,
                     int* __restrict__ sweeps_out, int n, double rcond)
{
    extern __shared__ double a[];        // n_pad x ld, row-major
    const int lane = threadIdx.x;
    const int np = (n + 1) / 2, m = 2 * np - 1, ld = 2 * np + 1;
    const double* src = A + (size_t)blockIdx.x * n * n;
    double* out = w + (size_t)blockIdx.x * n;
    // K5: V (n_pad x ld, from the identity) or e0^T V (n_pad, from e0)
    double* v = a + (m + 1) * ld;

    for (int i = lane; i < (m + 1) * ld; i += 32) {
        a[i] = 0.0;
        if (MODE == PSD_VECS)
            v[i] = i % (ld + 1) == 0 ? 1.0 : 0.0;
    }
    if (MODE == PSD_PINV && lane <= m)
        v[lane] = lane == 0 ? 1.0 : 0.0;
    __syncwarp();
    // lane y reads column y of every row; the lower triangle, mirrored
    double mx = 0.0;
    bool bad = false;
    if (lane < n) {
        for (int x = 0; x < n; ++x) {
            const double v = src[x * n + lane];
            bad |= !isfinite(v);
            if (x >= lane) {
                a[x * ld + lane] = v;
                a[lane * ld + x] = v;
                mx = fmax(mx, fabs(v));
            }
        }
    }
    if (__any_sync(PSD_FULL, bad)) {
        psd_nan_outputs<MODE>(out, vecs, n, lane, 32);
        if (lane == 0) {
            status[blockIdx.x] = 1;
            if (sweeps_out)
                sweeps_out[blockIdx.x] = 0;
        }
        return;
    }
    const int e = scale_exponent(warp_max(mx));
    const double sc = ldexp(1.0, -e);
    __syncwarp();
    double f2 = 0.0;
    for (int i = lane; i < (m + 1) * ld; i += 32) {
        const double v = a[i] * sc;
        a[i] = v;
        f2 = fma(v, v, f2);
    }
    const double floor = PSD_EPS2 * sqrt(warp_sum(f2));
    __syncwarp();

    // this lane's blocks, numbered lane, lane + 32, ...: block b < np is
    // pair b's diagonal block (so item 0 of lane P < np is pair P's), the
    // others the blocks (P, Q), P < Q, in row order; per block its pairs'
    // slots and their indices in round 0 (slot 0: (0, m); slot j:
    // (j, m - j))
    int P[ITEMS], Q[ITEMS], ia[ITEMS], ib[ITEMS], ja[ITEMS], jb[ITEMS];
    bool own[ITEMS];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
        const int b = lane + 32 * it;
        int bp = b, bq = b;
        if (b >= np) {
            int off = b - np, len = np - 1;
            bp = 0;
            while (len > 0 && off >= len) {
                off -= len;
                --len;
                ++bp;
            }
            bq = bp + 1 + off;
        }
        own[it] = b < np * (np + 1) / 2;
        P[it] = own[it] ? bp : 0;
        Q[it] = own[it] ? bq : 0;
        ia[it] = P[it];
        ib[it] = P[it] == 0 ? m : m - P[it];
        ja[it] = Q[it];
        jb[it] = Q[it] == 0 ? m : m - Q[it];
    }

    bool converged = false;
    int sweep = 0;
    for (; sweep < PSD_MAX_SWEEPS && !converged; ++sweep) {
        bool rotated = false;
        for (int r = 0; r < m; ++r) {
            // the pair lanes read their pair's 2 x 2 diagonal block, the
            // others their blocks' four entries
            double x1[ITEMS], x2[ITEMS], y1[ITEMS], y2[ITEMS];
            int pP[ITEMS], qP[ITEMS], pQ[ITEMS], qQ[ITEMS];
#pragma unroll
            for (int it = 0; it < ITEMS; ++it) {
                pP[it] = min(ia[it], ib[it]);
                qP[it] = max(ia[it], ib[it]);
                pQ[it] = min(ja[it], jb[it]);
                qQ[it] = max(ja[it], jb[it]);
                x1[it] = x2[it] = y1[it] = y2[it] = 0.0;
                if (own[it]) {
                    x1[it] = a[pP[it] * ld + pQ[it]];
                    x2[it] = a[pP[it] * ld + qQ[it]];
                    y1[it] = a[qP[it] * ld + pQ[it]];
                    y2[it] = a[qP[it] * ld + qQ[it]];
                }
            }
            // item 0 of a pair lane: app = x1, apq = x2, aqq = y2
            const bool pair_lane = lane < np;
            const bool rot = pair_lane && k3_rotates(x2[0], x1[0], y2[0],
                                                     floor);
            if (__any_sync(PSD_FULL, rot)) {
                rotated = true;
                double t = 0.0, c = 1.0, s = 0.0;
                if (rot) {
                    rotation(x2[0], y2[0] - x1[0], &t, &c, &s);
                    // K5: V J, columns p and q of V (or of e0^T V), which
                    // no other lane touches this round
                    const int p = pP[0], q = qP[0];
                    if (MODE == PSD_VECS) {
                        for (int k = 0; k < n; ++k)
                            rotate_pair(v + k * ld, p, q, c, s);
                    } else if (MODE == PSD_PINV) {
                        rotate_pair(v, p, q, c, s);
                    }
                }
#pragma unroll
                for (int it = 0; it < ITEMS; ++it) {
                    const double cP = __shfl_sync(PSD_FULL, c, P[it]);
                    const double sP = __shfl_sync(PSD_FULL, s, P[it]);
                    const double cQ = __shfl_sync(PSD_FULL, c, Q[it]);
                    const double sQ = __shfl_sync(PSD_FULL, s, Q[it]);
                    if (!own[it] || (sP == 0.0 && sQ == 0.0))
                        continue;
                    const int p1 = pP[it], q1 = qP[it];
                    const int p2 = pQ[it], q2 = qQ[it];
                    if (P[it] == Q[it]) {        // the closed-form diagonal
                        a[p1 * ld + p1] = x1[it] - t * x2[it];
                        a[q1 * ld + q1] = y2[it] + t * x2[it];
                        a[p1 * ld + q1] = 0.0;
                        a[q1 * ld + p1] = 0.0;
                        continue;
                    }
                    // rows by pair P (J^T A), then columns by pair Q (A J)
                    const double r1 = cP * x1[it] - sP * y1[it];
                    const double r2 = cP * x2[it] - sP * y2[it];
                    const double u1 = sP * x1[it] + cP * y1[it];
                    const double u2 = sP * x2[it] + cP * y2[it];
                    const double b11 = cQ * r1 - sQ * r2;
                    const double b12 = sQ * r1 + cQ * r2;
                    const double b21 = cQ * u1 - sQ * u2;
                    const double b22 = sQ * u1 + cQ * u2;
                    a[p1 * ld + p2] = b11;
                    a[p2 * ld + p1] = b11;
                    a[p1 * ld + q2] = b12;
                    a[q2 * ld + p1] = b12;
                    a[q1 * ld + p2] = b21;
                    a[p2 * ld + q1] = b21;
                    a[q1 * ld + q2] = b22;
                    a[q2 * ld + q1] = b22;
                }
                __syncwarp();
            }
#pragma unroll
            for (int it = 0; it < ITEMS; ++it) {
                ia[it] = next_index(ia[it], m);
                ib[it] = next_index(ib[it], m);
                ja[it] = next_index(ja[it], m);
                jb[it] = next_index(jb[it], m);
            }
        }
        converged = !rotated;
    }
    // the diagonal, scaled back, in ascending order (rank by comparison);
    // K5's sym_eigh moves V's column with its eigenvalue, its pinv00 sums
    // v0^2 / w over the eigenvalues past the cutoff
    bool nonfinite = false;
    double wl = 0.0, term = 0.0;
    if (lane < n) {
        const double d = a[lane * ld + lane];
        wl = ldexp(d, e);
        nonfinite = !isfinite(wl);
        if (MODE != PSD_PINV) {
            int rank = 0;
            for (int k = 0; k < n; ++k) {
                const double o = a[k * ld + k];
                rank += (o < d) || (o == d && k < lane);
            }
            out[rank] = wl;
            if (MODE == PSD_VECS) {
                double* vo = vecs + (size_t)blockIdx.x * n * n;
                for (int k = 0; k < n; ++k)
                    vo[k * n + rank] = v[k * ld + lane];
            }
        }
    }
    if (MODE == PSD_PINV) {
        const double cutoff = rcond * warp_max(fabs(wl));
        if (lane < n && fabs(wl) > cutoff)
            term = v[lane] * (1.0 / wl) * v[lane];
        const double var = warp_sum(term);
        nonfinite |= !isfinite(var);
        if (lane == 0)
            vecs[blockIdx.x] = var;
    }
    nonfinite = __any_sync(PSD_FULL, nonfinite);
    if (lane == 0) {
        status[blockIdx.x] = nonfinite ? 1 : (converged ? 0 : 2);
        if (sweeps_out)
            sweeps_out[blockIdx.x] = sweep;
    }
}

// ------------------------- K4, one warp a matrix ------------------------- //

// NMAX: n rounded up to even; lane j keeps row j of M in g and column j of
// U in v, NMAX registers each (zero past n)
template <int NMAX>
__global__ void __launch_bounds__(32)
nt_svd_warp_kernel(const double* __restrict__ M, double* __restrict__ U,
                   double* __restrict__ S, int* __restrict__ status,
                   int* __restrict__ sweeps_out, int n)
{
    const int lane = threadIdx.x;
    const int np = (n + 1) / 2, m = 2 * np - 1;
    const size_t nn = (size_t)n * n;
    const double* src = M + blockIdx.x * nn;
    double* u_out = U + blockIdx.x * nn;
    double* s_out = S + (size_t)blockIdx.x * n;

    double g[NMAX], v[NMAX];
    double mx = 0.0;
    bool bad = false;
#pragma unroll
    for (int k = 0; k < NMAX; ++k) {
        const double x = (lane < n && k < n) ? src[lane * n + k] : 0.0;
        bad |= !isfinite(x);
        mx = fmax(mx, fabs(x));
        g[k] = x;
        v[k] = k == lane ? 1.0 : 0.0;
    }
    if (__any_sync(PSD_FULL, bad)) {
        if (lane < n) {
            for (int k = 0; k < n; ++k)
                u_out[k * n + lane] = NAN;
            s_out[lane] = NAN;
        }
        if (lane == 0) {
            status[blockIdx.x] = 1;
            if (sweeps_out)
                sweeps_out[blockIdx.x] = 0;
        }
        return;
    }
    const int e = scale_exponent(warp_max(mx));
    const double sc = ldexp(1.0, -e);
    double f2 = 0.0;
#pragma unroll
    for (int k = 0; k < NMAX; ++k) {
        g[k] *= sc;
        f2 = fma(g[k], g[k], f2);
    }
    const double tol2 = (n * DBL_EPSILON) * (n * DBL_EPSILON);
    const double floor = PSD_EPS2 * warp_sum(f2);

    bool converged = false;
    int sweep = 0;
    for (; sweep < PSD_MAX_SWEEPS && !converged; ++sweep) {
        bool rotated = false;
        // lane j < m meets (2r - j) mod m in round r, or m where that is j
        // itself; lane m meets r; lanes past m sit out
        int tt = lane == 0 || lane >= m ? 0 : m - lane;
        for (int r = 0; r < m; ++r) {
            const int partner = lane < m ? (tt == lane ? m : tt)
                                         : (lane == m ? r : lane);
            tt += 2;
            tt = tt >= m ? tt - m : tt;
            double y[NMAX];
#pragma unroll
            for (int k = 0; k < NMAX; ++k)
                y[k] = __shfl_sync(PSD_FULL, g[k], partner);
            // own and partner norms and the dot product, the same
            // operations on both lanes of a pair (fma is symmetric)
            double a0 = 0.0, a1 = 0.0, b0 = 0.0, b1 = 0.0, c0 = 0.0,
                   c1 = 0.0;
#pragma unroll
            for (int k = 0; k < NMAX; k += 2) {
                a0 = fma(g[k], g[k], a0);
                a1 = fma(g[k + 1], g[k + 1], a1);
                b0 = fma(y[k], y[k], b0);
                b1 = fma(y[k + 1], y[k + 1], b1);
                c0 = fma(g[k], y[k], c0);
                c1 = fma(g[k + 1], y[k + 1], c1);
            }
            const bool lo = lane < partner;
            const double mine = a0 + a1, theirs = b0 + b1, gamma = c0 + c1;
            const double alpha = lo ? mine : theirs;
            const double beta = lo ? theirs : mine;
            const bool rot = partner != lane && lane < n && partner < n
                && k4_rotates(gamma, alpha, beta, tol2, floor);
            if (!__any_sync(PSD_FULL, rot))
                continue;
            rotated = true;
            double t = 0.0, c = 1.0, s = 0.0;
            if (rot)
                rotation(gamma, beta - alpha, &t, &c, &s);
            // row p' = c p - s q (the lower lane), row q' = s p + c q
            const double so = lo ? -s : s;
#pragma unroll
            for (int k = 0; k < NMAX; ++k) {
                g[k] = fma(c, g[k], so * y[k]);
                const double vo = __shfl_sync(PSD_FULL, v[k], partner);
                v[k] = fma(c, v[k], so * vo);
            }
        }
        converged = !rotated;
    }
    // sigma_j = |g_j|, descending (rank by comparison); lane j's column of
    // U goes to place rank
    double a2 = 0.0;
#pragma unroll
    for (int k = 0; k < NMAX; ++k)
        a2 = fma(g[k], g[k], a2);
    const double sj = sqrt(a2);
    int rank = 0;
#pragma unroll
    for (int k = 0; k < NMAX; ++k) {
        const double o = __shfl_sync(PSD_FULL, sj, k);
        rank += k < n && ((o > sj) || (o == sj && k < lane));
    }
    bool nonfinite = false;
    if (lane < n) {
        const double sv = ldexp(sj, e);
        s_out[rank] = sv;
        nonfinite = !isfinite(sv);
#pragma unroll
        for (int k = 0; k < NMAX; ++k)
            if (k < n)
                u_out[k * n + rank] = v[k];
    }
    nonfinite = __any_sync(PSD_FULL, nonfinite);
    if (lane == 0) {
        status[blockIdx.x] = nonfinite ? 1 : (converged ? 0 : 2);
        if (sweeps_out)
            sweeps_out[blockIdx.x] = sweep;
    }
}

// --------------------- past n = 32: one block a matrix -------------------- //

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

// copy a matrix in (lower = true: its lower triangle, mirrored), scaled by
// the power of two that brings its largest entry into [1, 2); returns
// false if an entry is not finite, else sets *e, the exponent that scales
// the results back, and *f, the squared Frobenius norm of the scaled
// matrix
__device__ bool load_scaled(const double* __restrict__ src, double* a,
                            int n, bool lower, double* red, int* e,
                            double* f)
{
    const int tid = threadIdx.x, nt = blockDim.x, nn = n * n;
    double mx = 0.0;
    for (int i = tid; i < nn; i += nt) {
        const double v = src[i];
        const int x = i / n, y = i - x * n;
        if (!isfinite(v))
            mx = INFINITY;
        else if (!lower)
            a[i] = v;
        else if (x >= y) {
            a[i] = v;
            a[y * n + x] = v;
        }
        if (!lower || x >= y)
            mx = fmax(mx, fabs(v));
    }
    mx = block_reduce(mx, red, false);
    if (!isfinite(mx))
        return false;
    *e = scale_exponent(mx);
    const double sc = ldexp(1.0, -*e);
    double f2 = 0.0;
    for (int i = tid; i < nn; i += nt) {
        a[i] *= sc;
        f2 += a[i] * a[i];
    }
    *f = block_reduce(f2, red, true);
    return true;
}

// the doubles of a block kernel's working set a matrix (kind 3: K3, 4:
// K4, 5: K5's sym_eigh, 6: K5's pinv00): the matrix (K4: and U; K5: and
// V or e0^T V) and the round's rotations
static __host__ __device__ size_t words_for(int kind, int n)
{
    const size_t nn = (size_t)n * n, np = (size_t)(n + 1) / 2;
    const size_t vw = kind == 4 || kind == 5 ? nn : (kind == 6 ? n : 0);
    return nn + vw + 4 * np;
}

template <bool SHARED, int MODE>
__global__ void __launch_bounds__(PSD_MAX_THREADS)
eigvalsh_kernel(const double* __restrict__ A, double* __restrict__ w,
                double* __restrict__ vecs, int* __restrict__ status,
                int* __restrict__ sweeps_out, double* __restrict__ work,
                int n, double rcond)
{
    extern __shared__ double smem[];
    __shared__ double red[PSD_MAX_THREADS];
    const int np = (n + 1) / 2, m = 2 * np - 1;
    const int tid = threadIdx.x, nt = blockDim.x;
    const size_t words = words_for(MODE == PSD_VALS ? 3 : 4 + MODE, n);
    double* a = SHARED ? smem : work + blockIdx.x * words;
    double* v = a + (size_t)n * n;        // K5: V, or e0^T V
    double* rot = a + words - 4 * np;     // per pair: c, s, new a_pp, a_qq
    double* out = w + (size_t)blockIdx.x * n;
    int e = 0;
    double f = 0.0;
    if (!load_scaled(A + (size_t)blockIdx.x * n * n, a, n, true, red, &e,
                     &f)) {
        psd_nan_outputs<MODE>(out, vecs, n, tid, nt);
        if (tid == 0) {
            status[blockIdx.x] = 1;
            if (sweeps_out)
                sweeps_out[blockIdx.x] = 0;
        }
        return;
    }
    const double floor = PSD_EPS2 * sqrt(f);
    if (MODE == PSD_VECS)
        for (int i = tid; i < n * n; i += nt)
            v[i] = (i / n == i % n) ? 1.0 : 0.0;
    if (MODE == PSD_PINV)
        for (int i = tid; i < n; i += nt)
            v[i] = i == 0 ? 1.0 : 0.0;
    bool converged = false;
    int sweep = 0;
    for (; sweep < PSD_MAX_SWEEPS && !converged; ++sweep) {
        int rotated = 0;
        for (int r = 0; r < m; ++r) {
            for (int j = tid; j < np; j += nt) {
                int p, q;
                pair_of(r, j, m, &p, &q);
                double c = 0.0, s = 0.0, dp = 0.0, dq = 0.0;
                if (q < n) {
                    const double apq = a[q * n + p];
                    const double app = a[p * n + p], aqq = a[q * n + q];
                    if (k3_rotates(apq, app, aqq, floor)) {
                        double t;
                        rotation(apq, aqq - app, &t, &c, &s);
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
                if (MODE == PSD_VECS)                     // K5: V J
                    rotate_pair(v + k * n, p, q, c, s);
                else if (MODE == PSD_PINV && k == 0)
                    rotate_pair(v, p, q, c, s);
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
    // the diagonal, scaled back, in ascending order (rank by comparison);
    // K5 as in the warp kernel
    int bad = 0;
    double wmax = 0.0;
    for (int i = tid; i < n; i += nt) {
        const double d = a[i * n + i];
        const double wi = ldexp(d, e);
        bad |= !isfinite(wi);
        wmax = fmax(wmax, fabs(wi));
        if (MODE == PSD_PINV)
            continue;
        int rank = 0;
        for (int k = 0; k < n; ++k) {
            const double o = a[k * n + k];
            rank += (o < d) || (o == d && k < i);
        }
        out[rank] = wi;
        if (MODE == PSD_VECS) {
            double* vo = vecs + (size_t)blockIdx.x * n * n;
            for (int k = 0; k < n; ++k)
                vo[k * n + rank] = v[k * n + i];
        }
    }
    if (MODE == PSD_PINV) {
        const double cutoff = rcond * block_reduce(wmax, red, false);
        double term = 0.0;
        for (int i = tid; i < n; i += nt) {
            const double wi = ldexp(a[i * n + i], e);
            if (fabs(wi) > cutoff)
                term += v[i] * (1.0 / wi) * v[i];
        }
        const double var = block_reduce(term, red, true);
        bad |= !isfinite(var);
        if (tid == 0)
            vecs[blockIdx.x] = var;
    }
    bad = __syncthreads_or(bad);
    if (tid == 0) {
        status[blockIdx.x] = bad ? 1 : (converged ? 0 : 2);
        if (sweeps_out)
            sweeps_out[blockIdx.x] = sweep;
    }
}

template <bool SHARED>
__global__ void __launch_bounds__(PSD_MAX_THREADS)
nt_svd_kernel(const double* __restrict__ M, double* __restrict__ U,
              double* __restrict__ S, int* __restrict__ status,
              int* __restrict__ sweeps_out, double* __restrict__ work, int n)
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
    if (!load_scaled(M + blockIdx.x * nn, g, n, false, red, &e, &f)) {
        for (int i = tid; i < n * n; i += nt)
            u_out[i] = NAN;
        for (int i = tid; i < n; i += nt)
            s_out[i] = NAN;
        if (tid == 0) {
            status[blockIdx.x] = 1;
            if (sweeps_out)
                sweeps_out[blockIdx.x] = 0;
        }
        return;
    }
    for (int i = tid; i < n * n; i += nt)
        v[i] = (i / n == i % n) ? 1.0 : 0.0;
    __syncthreads();
    const double tol2 = (n * DBL_EPSILON) * (n * DBL_EPSILON);
    const double floor = PSD_EPS2 * f;
    bool converged = false;
    int sweep = 0;
    for (; sweep < PSD_MAX_SWEEPS && !converged; ++sweep) {
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
                    if (k4_rotates(gamma, alpha, beta, tol2, floor)) {
                        double t;
                        rotation(gamma, beta - alpha, &t, &c, &s);
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
    if (tid == 0) {
        status[blockIdx.x] = bad ? 1 : (converged ? 0 : 2);
        if (sweeps_out)
            sweeps_out[blockIdx.x] = sweep;
    }
}

// an empty kernel: its launch is the floor under any kernel's (measurement)
__global__ void psd_empty_kernel() {}

// ------------------------------ C interface ------------------------------ //

static int threads_for(int n)
{
    const int items = ((n + 1) / 2) * n;
    int t = 32;
    while (t < items && t < PSD_MAX_THREADS)
        t *= 2;
    return t;
}

// doubles of global workspace a matrix needs (kind 3: K3, 4: K4, 5: K5's
// sym_eigh, 6: K5's pinv00), 0 when its working set fits in shared memory
// (always, for n <= PSD_WARP_N)
extern "C" long long bluest_psd_work_doubles(int kind, int n)
{
    const size_t words = words_for(kind, n);
    return n <= PSD_WARP_N || words * sizeof(double) <= PSD_SHARED_BYTES
        ? 0 : (long long)words;
}

// K3's (and K5's) 2 x 2 blocks a lane owns, as a template argument; the
// warp's shared memory holds the matrix and K5's V or e0^T V
template <int ITEMS, int MODE>
static void launch_eig_warp(const double* A, double* w, double* vecs,
                            int* status, int* sweeps, int batch, int n,
                            double rcond, cudaStream_t s)
{
    const size_t np2 = 2 * ((n + 1) / 2), ld = np2 + 1;
    const size_t words = np2 * ld * (MODE == PSD_VECS ? 2 : 1)
        + (MODE == PSD_PINV ? ld : 0);
    eigvalsh_warp_kernel<ITEMS, MODE><<<batch, 32, words * sizeof(double),
                                        s>>>(A, w, vecs, status, sweeps, n,
                                             rcond);
}

// K3 (MODE PSD_VALS) and K5 (PSD_VECS, PSD_PINV): one warp a matrix to
// n = 32, one block past it
template <int MODE>
static int launch_eig(const double* A, double* w, double* vecs, int* status,
                      int* sweeps, double* work, int batch, int n,
                      double rcond, cudaStream_t s)
{
    if (n <= PSD_WARP_N) {
        const int np = (n + 1) / 2, blocks = np * (np + 1) / 2;
        switch ((blocks + 31) / 32) {
        case 1: launch_eig_warp<1, MODE>(A, w, vecs, status, sweeps, batch,
                                         n, rcond, s); break;
        case 2: launch_eig_warp<2, MODE>(A, w, vecs, status, sweeps, batch,
                                         n, rcond, s); break;
        case 3: launch_eig_warp<3, MODE>(A, w, vecs, status, sweeps, batch,
                                         n, rcond, s); break;
        case 4: launch_eig_warp<4, MODE>(A, w, vecs, status, sweeps, batch,
                                         n, rcond, s); break;
        default: launch_eig_warp<5, MODE>(A, w, vecs, status, sweeps, batch,
                                          n, rcond, s); break;
        }
        return (int)cudaGetLastError();
    }
    const size_t bytes =
        words_for(MODE == PSD_VALS ? 3 : 4 + MODE, n) * sizeof(double);
    if (bytes <= PSD_SHARED_BYTES)
        eigvalsh_kernel<true, MODE><<<batch, threads_for(n), bytes, s>>>(
            A, w, vecs, status, sweeps, work, n, rcond);
    else
        eigvalsh_kernel<false, MODE><<<batch, threads_for(n), 0, s>>>(
            A, w, vecs, status, sweeps, work, n, rcond);
    return (int)cudaGetLastError();
}

extern "C" int bluest_sym_eigvalsh_f64(const double* A, double* w,
                                       int* status, int* sweeps,
                                       double* work, int batch, int n,
                                       void* stream)
{
    return launch_eig<PSD_VALS>(A, w, nullptr, status, sweeps, work, batch,
                                n, 0.0, (cudaStream_t)stream);
}

// K5, sym_eigh: w (B, n) ascending and V (B, n, n), A = V diag(w) V^T
extern "C" int bluest_sym_eigh_f64(const double* A, double* w, double* V,
                                   int* status, int* sweeps, double* work,
                                   int batch, int n, void* stream)
{
    return launch_eig<PSD_VECS>(A, w, V, status, sweeps, work, batch, n,
                                0.0, (cudaStream_t)stream);
}

// K5, pinv00: var (B,) = pinv(A)[0, 0], the eigenvalues |w| <= rcond
// max|w| cut off
extern "C" int bluest_pinv00_f64(const double* A, double* var, int* status,
                                 int* sweeps, double* work, double rcond,
                                 int batch, int n, void* stream)
{
    return launch_eig<PSD_PINV>(A, nullptr, var, status, sweeps, work, batch,
                                n, rcond, (cudaStream_t)stream);
}

#define PSD_K4_WARP(N)                                                      \
    case N:                                                                 \
        nt_svd_warp_kernel<N><<<batch, 32, 0, s>>>(M, U, S, status, sweeps, \
                                                   n);                      \
        break;

extern "C" int bluest_nt_svd_f64(const double* M, double* U, double* S,
                                 int* status, int* sweeps, double* work,
                                 int batch, int n, void* stream)
{
    cudaStream_t s = (cudaStream_t)stream;
    if (n <= PSD_WARP_N) {
        switch (n + (n & 1)) {
        PSD_K4_WARP(2) PSD_K4_WARP(4) PSD_K4_WARP(6) PSD_K4_WARP(8)
        PSD_K4_WARP(10) PSD_K4_WARP(12) PSD_K4_WARP(14) PSD_K4_WARP(16)
        PSD_K4_WARP(18) PSD_K4_WARP(20) PSD_K4_WARP(22) PSD_K4_WARP(24)
        PSD_K4_WARP(26) PSD_K4_WARP(28) PSD_K4_WARP(30) PSD_K4_WARP(32)
        }
        return (int)cudaGetLastError();
    }
    const size_t bytes = words_for(4, n) * sizeof(double);
    if (bytes <= PSD_SHARED_BYTES)
        nt_svd_kernel<true><<<batch, threads_for(n), bytes, s>>>(
            M, U, S, status, sweeps, work, n);
    else
        nt_svd_kernel<false><<<batch, threads_for(n), 0, s>>>(
            M, U, S, status, sweeps, work, n);
    return (int)cudaGetLastError();
}

// `batch` empty one-warp blocks on the stream: the launch floor that the
// smoke run's timings stand beside
extern "C" int bluest_psd_empty(int batch, void* stream)
{
    psd_empty_kernel<<<batch, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
