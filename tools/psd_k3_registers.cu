// K3 with the matrix in registers: the other layout of one warp a matrix,
// built and timed by tools/psd_round_probe.py beside the package's K3
// (bluest_tpu_torch/csrc/psd_eig.cu, whose matrix sits in the warp's
// shared memory).  Not a kernel of the package.
//
// Lane i holds row i of the matrix (column positions in its registers,
// its diagonal apart in d).  Every round pairs positions (2j, 2j+1), so
// lane i's partner is lane i ^ 1 and the column update of pair j touches
// registers 2j and 2j + 1, compile-time indices: rows rotate by a
// shuffle of the partner's row, columns by the pair's c and s broadcast
// from lane 2j.  After each round the positions move by a fixed
// permutation (the circle method: position 0 stays, the others move one
// place along the circle 0, 2, 4, ..., n_pad - 2, n_pad - 1, ..., 3, 1),
// rows by one shuffle from a lane fixed per lane and columns by the same
// permutation of register indices, so every pair meets once a sweep and
// the layout is the identity again after n_pad - 1 rounds.  The coupling
// a_{i, i^1} sits at a runtime register index and is read by a binary
// tree of selects.  The same scaling, thresholds, rotation, floor, sweep
// cap and statuses as the package's K3; rounding differs (both
// triangles are computed, and the pair order is the circle's).
//
// bluest_sym_eigvalsh_f64 here launches this kernel for n <= 32 and the
// package's block kernel past that, with the package's C interface.

#define bluest_sym_eigvalsh_f64 bluest_sym_eigvalsh_f64_shared
#include "../bluest_tpu_torch/csrc/psd_eig.cu"
#undef bluest_sym_eigvalsh_f64

// the circle index of position p, the position of circle index ci, and
// the position whose row (and column) moves to position p a round
__host__ __device__ constexpr int circle_of(int p, int np2)
{
    return (p & 1) == 0 ? p / 2 : np2 - 1 - p / 2;
}

__host__ __device__ constexpr int position_of(int ci, int np2)
{
    return ci < np2 / 2 ? 2 * ci : 2 * (np2 - 1 - ci) + 1;
}

__host__ __device__ constexpr int source_of(int p, int np2)
{
    return p >= np2 ? p
        : circle_of(p, np2) == 0 ? p
        : position_of(circle_of(p, np2) == 1 ? np2 - 1
                                             : circle_of(p, np2) - 1, np2);
}

__host__ __device__ constexpr int pow2_at_least(int n)
{
    return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// b[idx] for a runtime idx < NP: a binary tree of selects on idx's bits
template <int NP>
__device__ __forceinline__ double pick(const double (&b)[NP], int idx)
{
    constexpr int W = pow2_at_least(NP);
    double v[W];
#pragma unroll
    for (int k = 0; k < W; ++k)
        v[k] = k < NP ? b[k] : 0.0;
#pragma unroll
    for (int w = W / 2; w >= 1; w /= 2) {
#pragma unroll
        for (int k = 0; k < w; ++k)
            v[k] = (idx & w) ? v[k + w] : v[k];
    }
    return v[0];
}

// NP: n rounded up to even
template <int NP>
__global__ void __launch_bounds__(32)
eigvalsh_reg_kernel(const double* __restrict__ A, double* __restrict__ w,
                    int* __restrict__ status, int* __restrict__ sweeps_out,
                    int n)
{
    const int lane = threadIdx.x;
    const double* src = A + (size_t)blockIdx.x * n * n;
    double* out = w + (size_t)blockIdx.x * n;

    // row `lane` of the matrix from its lower triangle; every entry of
    // the row checked
    double b[NP];
    double mx = 0.0;
    bool bad = false;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
        double v = 0.0;
        if (lane < n && k < n) {
            bad |= !isfinite(src[lane * n + k]);
            v = lane >= k ? src[lane * n + k] : src[k * n + lane];
        }
        b[k] = v;
        mx = fmax(mx, fabs(v));
    }
    if (__any_sync(PSD_FULL, bad)) {
        if (lane < n)
            out[lane] = NAN;
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
    for (int k = 0; k < NP; ++k) {
        b[k] *= sc;
        f2 = fma(b[k], b[k], f2);
    }
    const double floor = PSD_EPS2 * sqrt(warp_sum(f2));
    double d = pick(b, lane < NP ? lane : 0);
    const int from = source_of(lane, NP);
    const bool even = (lane & 1) == 0;

    bool converged = false;
    int sweep = 0;
    for (; sweep < PSD_MAX_SWEEPS && !converged; ++sweep) {
        bool rotated = false;
        for (int r = 0; r < NP - 1; ++r) {
            // the pair's coupling is the even lane's a_{2j, 2j+1}
            const double own = pick(b, (lane ^ 1) < NP ? lane ^ 1 : 0);
            const double cpl = __shfl_xor_sync(PSD_FULL, own, 1);
            const double dpart = __shfl_xor_sync(PSD_FULL, d, 1);
            const double apq = even ? own : cpl;
            const double app = even ? d : dpart, aqq = even ? dpart : d;
            const bool rot = lane < NP && k3_rotates(apq, app, aqq, floor);
            if (__any_sync(PSD_FULL, rot)) {
                rotated = true;
                double t = 0.0, c = 1.0, s = 0.0;
                if (rot)
                    rotation(apq, aqq - app, &t, &c, &s);
                // rows: p' = c p - s q (the even lane), q' = s p + c q
                const double so = even ? -s : s;
#pragma unroll
                for (int k = 0; k < NP; ++k) {
                    const double pb = __shfl_xor_sync(PSD_FULL, b[k], 1);
                    b[k] = fma(c, b[k], so * pb);
                }
                // columns, pair by pair, with the pair's c and s
#pragma unroll
                for (int j = 0; j < NP / 2; ++j) {
                    const double cj = __shfl_sync(PSD_FULL, c, 2 * j);
                    const double sj = __shfl_sync(PSD_FULL, s, 2 * j);
                    const double x = b[2 * j], y = b[2 * j + 1];
                    b[2 * j] = cj * x - sj * y;
                    b[2 * j + 1] = sj * x + cj * y;
                }
                if (rot) {
                    d = even ? app - t * apq : aqq + t * apq;
#pragma unroll
                    for (int k = 0; k < NP; ++k) {
                        b[k] = k == (lane ^ 1) ? 0.0 : b[k];
                        b[k] = k == lane ? d : b[k];
                    }
                }
            }
            // the next round's positions: rows and columns alike
            double nb[NP];
#pragma unroll
            for (int k = 0; k < NP; ++k)
                nb[k] = __shfl_sync(PSD_FULL, b[source_of(k, NP)], from);
#pragma unroll
            for (int k = 0; k < NP; ++k)
                b[k] = nb[k];
            d = __shfl_sync(PSD_FULL, d, from);
        }
        converged = !rotated;
    }
    // after whole sweeps lane i holds row i again: its diagonal, scaled
    // back, in ascending order
    bool nonfinite = false;
    int rank = 0;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
        const double o = __shfl_sync(PSD_FULL, d, k);
        rank += k < n && ((o < d) || (o == d && k < lane));
    }
    if (lane < n) {
        const double v = ldexp(d, e);
        out[rank] = v;
        nonfinite = !isfinite(v);
    }
    nonfinite = __any_sync(PSD_FULL, nonfinite);
    if (lane == 0) {
        status[blockIdx.x] = nonfinite ? 1 : (converged ? 0 : 2);
        if (sweeps_out)
            sweeps_out[blockIdx.x] = sweep;
    }
}

#define PSD_K3_REG(N)                                                       \
    case N:                                                                 \
        eigvalsh_reg_kernel<N><<<batch, 32, 0, s>>>(A, w, status, sweeps,   \
                                                    n);                     \
        break;

extern "C" int bluest_sym_eigvalsh_f64(const double* A, double* w,
                                       int* status, int* sweeps,
                                       double* work, int batch, int n,
                                       void* stream)
{
    if (n > PSD_WARP_N)
        return bluest_sym_eigvalsh_f64_shared(A, w, status, sweeps, work,
                                              batch, n, stream);
    cudaStream_t s = (cudaStream_t)stream;
    switch (n + (n & 1)) {
    PSD_K3_REG(2) PSD_K3_REG(4) PSD_K3_REG(6) PSD_K3_REG(8)
    PSD_K3_REG(10) PSD_K3_REG(12) PSD_K3_REG(14) PSD_K3_REG(16)
    PSD_K3_REG(18) PSD_K3_REG(20) PSD_K3_REG(22) PSD_K3_REG(24)
    PSD_K3_REG(26) PSD_K3_REG(28) PSD_K3_REG(30) PSD_K3_REG(32)
    }
    return (int)cudaGetLastError();
}
