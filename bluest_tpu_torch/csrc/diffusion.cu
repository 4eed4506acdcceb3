// Fused diffusion model for Hopper (sm_90a): K1 of the port.
//
// Replaces bluest_tpu/ops/pallas_diffusion.py:diffusion_outputs_pallas
// (the Pallas body `_kernel`).  For every sample b it computes, in one
// launch and one thread:
//
//   log a_i = sum_k mck[i, k] * xi[b, k]          (mode synthesis)
//   a_i     = exp(log a_i),  i = 0 .. n-1         (cell-face coefficients)
//   -(a u')' = 1, u(0) = u(1) = 0                  (tridiagonal, m = n-1 rows)
//   Thomas forward sweep, then back substitution with the three QoIs fused:
//   q_int = h sum u,  q_mid = u[n/2 - 1],  q_energy = (1/h) sum a (du)^2
//
// What bounds it on this card.  The Thomas recurrence is sequential in
// the grid: 2(n-1) dependent steps per sample, each a handful of flops
// and one division, so one sample cannot be spread over threads without
// changing the algorithm (cyclic reduction).  Parallelism therefore comes
// from the batch only: one thread per sample, B threads per launch (8192
// on the flagship = 64 blocks of 128, under one block per SM on 132 SMs).
// The Pallas kernel keeps a, cp and dp in VMEM as (n, S, 128); at n=1024
// that is 3 * 1024 * 4 B = 12 KB per sample in f32, which no block of
// samples fits in shared memory or registers.  They live instead in a
// global-memory workspace laid out (row, batch): step i of every thread
// of a warp touches 32 consecutive words, so each load and store is one
// coalesced transaction, and the workspace (3n-2) * B * sizeof(T) bytes
// (100 MB at n=1024, B=8192, f32) streams through L2 once forward and once
// backward.  `a` is stored, not recomputed, in the back sweep: recomputing
// it would double the n * n_kl FMAs of the mode synthesis to save one of
// the three workspace streams.
//
// Arithmetic.  The mode synthesis is a plain multiply-add loop over the
// n_kl modes in IEEE T (no tensor cores, no TF32).  It, the recurrence
// and the QoIs all use the _rn intrinsics, which the compiler never
// contracts into FMAs, so the f64 kernel performs exactly the operations
// of the plain PyTorch version (ops/diffusion.py:diffusion_outputs_plain)
// in the same order.  The lognormal coefficient spans ~e^-8..e^8 over a
// batch, and the Thomas forward error grows with n^2 times that spread:
// an fma in the mode synthesis alone moved the f64 outputs by 1.8e-10
// relative against the plain version at n=1024 (H100, 700 W), over the
// 1e-10 bound the port holds the two to.
//
// Interface: plain C entry points returning cudaGetLastError(), loaded
// with ctypes; the caller allocates out (B, 3) and ws ((3n-2) * B) and
// passes its current stream.

#include <cuda_runtime.h>

namespace {

template <typename T>
struct Arith;

template <>
struct Arith<float> {
    static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
    static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
    static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
    static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
    static __device__ __forceinline__ float exp(float a) { return expf(a); }
};

template <>
struct Arith<double> {
    static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
    static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
    static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
    static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
    static __device__ __forceinline__ double exp(double a) { return ::exp(a); }
};

constexpr int kBlock = 128;

template <typename T>
__global__ void __launch_bounds__(kBlock)
diffusion_outputs_kernel(const T* __restrict__ xis,   // (B, n_kl)
                         const T* __restrict__ mck,   // (n, n_kl)
                         T* __restrict__ out,         // (B, 3)
                         T* __restrict__ ws,          // (3n-2) * B
                         int B, int n_kl, int n, T inv_h2, T h) {
    using A = Arith<T>;
    extern __shared__ unsigned char smem_raw[];
    T* xs = reinterpret_cast<T*>(smem_raw);          // (n_kl, kBlock)

    const int tid = threadIdx.x;
    const long long b0 = static_cast<long long>(blockIdx.x) * kBlock;
    // stage this block's xi rows transposed: the global read walks the
    // (B, n_kl) rows contiguously, the shared layout gives each thread
    // its own bank for every k
    for (int idx = tid; idx < kBlock * n_kl; idx += kBlock) {
        const int t = idx / n_kl;
        const int k = idx - t * n_kl;
        const long long bb = b0 + t;
        xs[k * kBlock + t] = bb < B ? xis[bb * n_kl + k] : T(0);
    }
    __syncthreads();

    const long long b = b0 + tid;
    if (b >= B) return;
    const int m = n - 1;
    T* o = out + b * 3;
    if (m <= 0) {                   // one cell: no interior unknowns
        o[0] = T(0); o[1] = T(0); o[2] = T(0);
        return;
    }
    const long long Bl = B;
    T* a_ws = ws;                   // (n, B)
    T* cp_ws = ws + n * Bl;         // (m, B)
    T* dp_ws = cp_ws + m * Bl;      // (m, B)

    auto coeff = [&](int i) {
        const T* row = mck + static_cast<long long>(i) * n_kl;
        T acc = A::mul(__ldg(row), xs[tid]);
        for (int k = 1; k < n_kl; ++k)
            acc = A::add(acc, A::mul(__ldg(row + k), xs[k * kBlock + tid]));
        return A::exp(acc);
    };

    // ---- forward sweep (lower[0] and upper[m-1] are inert: zero carry
    // and zero x_next, as in models.diffusion.thomas_solve) ----
    T ai = coeff(0);
    a_ws[b] = ai;
    T cp_prev = T(0), dp_prev = T(0);
    for (int i = 0; i < m; ++i) {
        const T ai1 = coeff(i + 1);
        a_ws[(i + 1) * Bl + b] = ai1;
        const T diag = A::mul(A::add(ai, ai1), inv_h2);
        const T low = -A::mul(ai, inv_h2);
        const T up = -A::mul(ai1, inv_h2);
        const T denom = A::sub(diag, A::mul(low, cp_prev));
        const T cp = A::div(up, denom);
        const T dp = A::div(A::sub(T(1), A::mul(low, dp_prev)), denom);
        cp_ws[i * Bl + b] = cp;
        dp_ws[i * Bl + b] = dp;
        cp_prev = cp;
        dp_prev = dp;
        ai = ai1;
    }

    // ---- back substitution with the QoIs fused in ----
    const int mid = n / 2 - 1;
    T x_next = T(0), s_int = T(0), energy = T(0), x_mid = T(0);
    for (int i = m - 1; i >= 0; --i) {
        const T x = A::sub(dp_ws[i * Bl + b], A::mul(cp_ws[i * Bl + b], x_next));
        s_int = A::add(s_int, x);
        const T d = A::sub(x_next, x);
        energy = A::add(energy, A::mul(A::mul(a_ws[(i + 1) * Bl + b], d), d));
        if (i == mid) x_mid = x;
        x_next = x;
    }
    energy = A::add(energy, A::mul(A::mul(a_ws[b], x_next), x_next));
    o[0] = A::mul(h, s_int);
    o[1] = x_mid;
    o[2] = A::div(energy, h);
}

template <typename T>
int launch(const T* xis, const T* mck, T* out, T* ws, int B, int n_kl,
           int n, double inv_h2, double h, void* stream) {
    if (B <= 0) return 0;
    const size_t smem = static_cast<size_t>(n_kl) * kBlock * sizeof(T);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            diffusion_outputs_kernel<T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (B + kBlock - 1) / kBlock;
    diffusion_outputs_kernel<T><<<grid, kBlock, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
        xis, mck, out, ws, B, n_kl, n, static_cast<T>(inv_h2),
        static_cast<T>(h));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bluest_diffusion_outputs_f32(
        const float* xis, const float* mck, float* out, float* ws, int B,
        int n_kl, int n, double inv_h2, double h, void* stream) {
    return launch<float>(xis, mck, out, ws, B, n_kl, n, inv_h2, h, stream);
}

extern "C" int bluest_diffusion_outputs_f64(
        const double* xis, const double* mck, double* out, double* ws,
        int B, int n_kl, int n, double inv_h2, double h, void* stream) {
    return launch<double>(xis, mck, out, ws, B, n_kl, n, inv_h2, h, stream);
}
