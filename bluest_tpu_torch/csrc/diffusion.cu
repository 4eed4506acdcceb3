// Fused diffusion model for Hopper (sm_90a): K1 of the port.
//
// Replaces bluest_tpu/ops/pallas_diffusion.py:diffusion_outputs_pallas
// (the Pallas body `_kernel`).  For every sample b of xis (B, n_kl) it
// computes, in one launch, the three QoIs of -(a u')' = 1 on (0, 1),
// u(0) = u(1) = 0, on n cells (m = n - 1 interior unknowns x_i = u_{i+1}):
//
//   log a_i = sum_k mck[i, k] * xi[b, k],  a_i = exp(log a_i),  i < n
//   row i:  -a_i x_{i-1} + (a_i + a_{i+1}) x_i - a_{i+1} x_{i+1} = h^2
//   q_int = h sum x,  q_mid = x_{n/2-1},  q_energy = n sum_i a_i (dx_i)^2
//
// The solve is partitioned over the lanes of a warp.  Lane p of P owns
// the rows [p m / P, (p+1) m / P); its last row is a separator S_p and
// the rows before it are its interior.  Each lane runs Thomas down its
// interior for two loads (the unit source, and the coupling to the left
// separator) and back up, which gives every interior row as
// x = Y + S_{p-1} Al + S_p Bl.  Eliminating the interiors leaves a
// tridiagonal system in the P separators (the Schur complement, one row
// per lane), solved across the warp by parallel cyclic reduction over
// shuffles.  Each lane then forms its rows and reduces the QoI sums over
// the warp.  This is a generic tridiagonal solve with Thomas's error in
// f32 (median ~2e-3 relative at n=1024, as the JAX package's f32 cyclic
// reduction): the pilot covariance of the flagship's four finest models,
// which share all 32 modes, needs that error to stay clear of the SPD
// projection's clip, or the MLBLUE allocation degenerates to plain MC
// (PERF.md, Findings).
//
// The bound counts the function's least work, not this design's: at
// n=1024, n_kl=32, B=8192, f32 the mode synthesis is 2 n_kl - 1 = 63
// flops per cell (528.5 MFLOP), its exp one per cell (8.4 M), and a
// Thomas solve with the QoIs fused 17 flops per row (142.5 MFLOP): ~0.68
// GFLOP, ~10.1 us at 67 TFLOP/s.  The bytes are xi 1.05 MB + mck 0.13 MB
// + out 0.10 MB, 0.38 us at 3.35 TB/s: K1 is compute-bound.  (This
// design does 28 flops per row, two loads down and three responses back
// up, and its arithmetic is non-contracting, below, so its own ceiling
// is well under the bound.)
//
// What the design does about what held the one-thread-per-sample Thomas
// kernel to ~0.7% of its bound:
//   1. Threads in flight: a block of 256 threads owns a tile of S samples
//      (16 in f32, 8 in f64), so B=8192 is 512 blocks on 132 SMs, and the
//      solve gives each sample a warp (L = 2..16 lanes when n <= 16, so a
//      warp then holds 32/L samples).
//   2. The dependent chain: 2(n-1) Thomas steps become 3 ceil(m/32)
//      steps per lane plus 5 cyclic-reduction levels and 5 butterfly
//      levels (~96 + 10 steps at n=1024).
//   3. Mode synthesis off the chain: the block forms log a for its whole
//      tile first, as a register-tiled product on CUDA cores -- warp w owns
//      the cells i = 32w + lane (+256 per pass), each thread accumulates its
//      cell for all S samples of the tile, reading one mck value (coalesced,
//      L1/L2-resident) and the tile's xi column (one broadcast shared-memory
//      vector load per 4 samples) per mode.  No tensor cores: TF32 keeps ~3
//      digits, and log a spans ~+-8.
//   4. No workspace: a lives in shared memory, (S, n + n/32) per block
//      (66 KB at n=1024 in both dtypes; above 48 KB through
//      cudaFuncSetAttribute; the pad word after every 32 cells keeps the
//      solve's lanes, whose rows start ~32 cells apart, on different banks),
//      and each lane keeps its <= 31 interior rows' three values in
//      registers.  The kernel touches device memory only for xis, mck and
//      out.
//
// Reach: n <= 32 * 32 + 1 = 1025 cells (bluest_diffusion_max_cells), so
// a lane owns at most 32 rows and keeps them in registers.  Longer lanes
// spilled (a 128-row variant used 255 registers and local memory) and no
// model of the repo is finer than 1024 cells; a larger n raises in the
// wrapper.
//
// Arithmetic.  Every multiply, add, subtract, divide and reciprocal uses the _rn
// intrinsics, which the compiler never contracts into FMAs, and the mode
// synthesis keeps the order k = 0, 1, ..., n_kl-1 for each cell.  The
// plain PyTorch version (ops/diffusion.py:diffusion_outputs_plain) runs
// the same partition, the same loop orders, the same cyclic-reduction
// levels and the same butterfly tree (at each level lane j adds lane
// j + L/2^l), so in the same dtype the two agree bit for bit.  An FMA in
// the mode synthesis alone moved f64 outputs by 1.8e-10 against the plain
// version at n=1024 on an H100, over the 1e-10 bound the port holds them
// to.
//
// Interface: plain C entry points returning cudaGetLastError(), or -1
// for a shape the kernel has no tile for, loaded with ctypes; mck is
// passed transposed, (n_kl, n); the caller allocates out (B, 3) and
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
    static __device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
    static __device__ __forceinline__ float exp(float a) { return expf(a); }
};

template <>
struct Arith<double> {
    static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
    static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
    static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
    static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
    static __device__ __forceinline__ double rcp(double a) { return __drcp_rn(a); }
    static __device__ __forceinline__ double exp(double a) { return ::exp(a); }
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;        // opt-in shared memory of one block
constexpr int kMaxRows = 32;            // rows a lane keeps in registers
constexpr int kMaxCells = 32 * kMaxRows + 1;
constexpr int kNoTile = -1;             // the launcher's refusal of a shape
constexpr unsigned kFull = 0xffffffffu;

// x[0..S) = p[0..S) with 16-byte shared-memory loads (p 16-byte aligned)
template <int S>
__device__ __forceinline__ void load_tile(const float* p, float (&x)[S]) {
#pragma unroll
    for (int j = 0; j < S; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(p + j);
        x[j] = v.x; x[j + 1] = v.y; x[j + 2] = v.z; x[j + 3] = v.w;
    }
}

template <int S>
__device__ __forceinline__ void load_tile(const double* p, double (&x)[S]) {
#pragma unroll
    for (int j = 0; j < S; j += 2) {
        const double2 v = *reinterpret_cast<const double2*>(p + j);
        x[j] = v.x; x[j + 1] = v.y;
    }
}

// the a tile keeps one pad word after every 32 cells, so the solve's lanes,
// whose rows start ~32 cells apart, read different banks
__host__ __device__ __forceinline__ int padded(int i) { return i + (i >> 5); }
__host__ __device__ __forceinline__ int tile_ld(int n) { return padded(n - 1) + 1; }

// sum over the `lanes` lanes of each group; lane j adds lane j ^ o, so lane
// 0's value is the plain version's halving fold
template <typename T>
__device__ __forceinline__ T lane_sum(T v, int lanes) {
    for (int o = lanes >> 1; o > 0; o >>= 1)
        v = Arith<T>::add(v, __shfl_xor_sync(kFull, v, o));
    return v;
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
diffusion_outputs_kernel(const T* __restrict__ xis,    // (B, n_kl)
                         const T* __restrict__ mckT,   // (n_kl, n)
                         T* __restrict__ out,          // (B, 3)
                         int B, int n_kl, int n, int lanes, T h2, T h) {
    using A = Arith<T>;
    constexpr int CMAX = kMaxRows;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int ld = tile_ld(n);
    T* atile = reinterpret_cast<T*>(smem_raw);          // (S, ld), padded
    T* xs = atile + static_cast<size_t>(S) * ld;         // (n_kl, S)

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long b0 = static_cast<long long>(blockIdx.x) * S;

    if (n <= 1) {                   // one cell: no interior unknowns
        for (int s = tid; s < S; s += kThreads)
            if (b0 + s < B) {
                T* o = out + (b0 + s) * 3;
                o[0] = T(0); o[1] = T(0); o[2] = T(0);
            }
        return;
    }

    // stage the tile's xi transposed: the global read walks the (B, n_kl)
    // rows contiguously; padded samples past B get xi = 0
    for (int idx = tid; idx < S * n_kl; idx += kThreads) {
        const int s = idx / n_kl;
        const int k = idx - s * n_kl;
        const long long b = b0 + s;
        xs[k * S + s] = b < B ? xis[b * n_kl + k] : T(0);
    }
    __syncthreads();

    // ---- mode synthesis: a[s][i] = exp(sum_k mck[i, k] xi[s, k]) ----
    for (int i0 = warp * 32; i0 < n; i0 += kThreads) {
        const int i = i0 + lane;
        if (i < n) {
            T x[S], acc[S];
            load_tile<S>(xs, x);
            const T m0 = __ldg(mckT + i);
#pragma unroll
            for (int s = 0; s < S; ++s) acc[s] = A::mul(m0, x[s]);
#pragma unroll 4
            for (int k = 1; k < n_kl; ++k) {
                const T m = __ldg(mckT + static_cast<size_t>(k) * n + i);
                load_tile<S>(xs + k * S, x);
#pragma unroll
                for (int s = 0; s < S; ++s)
                    acc[s] = A::add(acc[s], A::mul(m, x[s]));
            }
#pragma unroll
            for (int s = 0; s < S; ++s)
                atile[s * ld + padded(i)] = A::exp(acc[s]);
        }
    }
    __syncthreads();

    // ---- partitioned solve: `lanes` lanes per sample, 32/lanes samples
    // per warp.  The loop bound is warp-uniform, so every lane reaches the
    // shuffles; slots past the tile are idle lanes and write nothing. ----
    const int m = n - 1;
    const int P = lanes < m ? lanes : m;          // lanes that own rows
    const int per_warp = 32 / lanes;
    const int sub = lane / lanes;
    const int p = lane - sub * lanes;             // lane within the sample
    const int mid = n / 2 - 1;
    for (int s0 = warp * per_warp; s0 < S; s0 += kWarps * per_warp) {
        const int slot = s0 + sub;
        const bool active = slot < S && p < P;
        const T* w = atile + static_cast<size_t>(active ? slot : 0) * ld;
        const int rs = active ? p * m / P : m;          // rows [rs, re)
        const int re = active ? (p + 1) * m / P : m;
        const int c = re - rs;
        const int ni = c > 0 ? c - 1 : 0;              // interior rows

        // interior rows rs .. re-2: Thomas down the rows for the unit
        // load (dpy) and the load w_rs at the first row (dpa); the
        // stores keep cp, dpy, dpa per row
        T st0[CMAX - 1], st1[CMAX - 1], st2[CMAX - 1];
        T cp = T(0), dpy = T(0), dpa = T(0), dpb = T(0);
#pragma unroll
        for (int t = 0; t < CMAX - 1; ++t) {
            if (t < ni) {
                const T wi = w[padded(rs + t)], wi1 = w[padded(rs + t + 1)];
                const T lo = -wi;
                const T r = A::rcp(A::sub(A::add(wi, wi1), A::mul(lo, cp)));
                cp = A::mul(-wi1, r);
                dpy = A::mul(A::sub(h2, A::mul(lo, dpy)), r);
                dpa = A::mul(A::sub(t == 0 ? wi : T(0), A::mul(lo, dpa)), r);
                if (t == ni - 1) dpb = A::mul(wi1, r);
                st0[t] = cp; st1[t] = dpy; st2[t] = dpa;
            }
        }
        // back up the rows: each row's response to the unit load (Y), to
        // the left separator (Al) and to this lane's separator (Bl),
        // stored in place of cp, dpy, dpa as (Bl, Y, Al)
        T Yn = T(0), An = T(0), Bn = T(0);
#pragma unroll
        for (int t = CMAX - 2; t >= 0; --t) {
            if (t < ni) {
                const T c_t = st0[t];
                Yn = A::sub(st1[t], A::mul(c_t, Yn));
                An = A::sub(st2[t], A::mul(c_t, An));
                Bn = A::sub(t == ni - 1 ? dpb : T(0), A::mul(c_t, Bn));
                st0[t] = Bn; st1[t] = Yn; st2[t] = An;
            }
        }
        const bool has = ni > 0;
        const T yF = has ? Yn : T(0), aF = has ? An : T(0),
                bF = has ? Bn : T(1);
        const T yL = has ? dpy : T(0), aL = has ? dpa : T(1),
                bL = has ? dpb : T(0);

        // the reduced system on the separators (row re-1 of each lane),
        // one row per lane, idle lanes holding the identity
        const bool last_lane = active && p == P - 1;
        T yFn = __shfl_down_sync(kFull, yF, 1, lanes);
        T aFn = __shfl_down_sync(kFull, aF, 1, lanes);
        T bFn = __shfl_down_sync(kFull, bF, 1, lanes);
        if (last_lane) { yFn = T(0); aFn = T(0); bFn = T(0); }
        T Ar = T(0), Br = T(1), Cr = T(0), Rr = T(0);
        if (active) {
            const T wr = w[padded(re - 1)], wr1 = w[padded(re)];
            Ar = p > 0 ? -A::mul(wr, aL) : T(0);
            Br = A::sub(A::sub(A::add(wr, wr1), A::mul(wr, bL)),
                        A::mul(wr1, aFn));
            Cr = -A::mul(wr1, bFn);
            Rr = A::add(A::add(h2, A::mul(wr, yL)), A::mul(wr1, yFn));
        }
        for (int d = 1; d < lanes; d <<= 1) {   // parallel cyclic reduction
            T Am = __shfl_up_sync(kFull, Ar, d, lanes);
            T Bm = __shfl_up_sync(kFull, Br, d, lanes);
            T Cm = __shfl_up_sync(kFull, Cr, d, lanes);
            T Rm = __shfl_up_sync(kFull, Rr, d, lanes);
            if (p < d) { Am = T(0); Bm = T(1); Cm = T(0); Rm = T(0); }
            T Ap = __shfl_down_sync(kFull, Ar, d, lanes);
            T Bp = __shfl_down_sync(kFull, Br, d, lanes);
            T Cp = __shfl_down_sync(kFull, Cr, d, lanes);
            T Rp = __shfl_down_sync(kFull, Rr, d, lanes);
            if (p + d >= lanes) { Ap = T(0); Bp = T(1); Cp = T(0); Rp = T(0); }
            const T k1 = A::div(Ar, Bm), k2 = A::div(Cr, Bp);
            Ar = -A::mul(k1, Am);
            Br = A::sub(A::sub(Br, A::mul(k1, Cm)), A::mul(k2, Ap));
            Cr = -A::mul(k2, Cp);
            Rr = A::sub(A::sub(Rr, A::mul(k1, Rm)), A::mul(k2, Rp));
        }
        const T Sp = A::div(Rr, Br);
        T Sprev = __shfl_up_sync(kFull, Sp, 1, lanes);
        if (p == 0) Sprev = T(0);

        // this lane's rows in order: the QoI sums
        T s_int = T(0), eng = T(0), x_mid = T(0), x_prev = Sprev;
#pragma unroll
        for (int t = 0; t < CMAX; ++t) {
            if (t < c) {
                T x = Sp;
                if (t < CMAX - 1 && t < ni)
                    x = A::add(A::add(st1[t], A::mul(Sprev, st2[t])),
                               A::mul(Sp, st0[t]));
                const T dd = A::sub(x, x_prev);
                s_int = A::add(s_int, x);
                eng = A::add(eng, A::mul(A::mul(w[padded(rs + t)], dd), dd));
                if (rs + t == mid) x_mid = x;
                x_prev = x;
            }
        }
        if (last_lane) {            // the last cell, to u(1) = 0
            const T dd = A::sub(T(0), x_prev);
            eng = A::add(eng, A::mul(A::mul(w[padded(m)], dd), dd));
        }
        s_int = lane_sum(s_int, lanes);
        eng = lane_sum(eng, lanes);
        x_mid = lane_sum(x_mid, lanes);
        const long long b = b0 + slot;
        if (slot < S && p == 0 && b < B) {
            T* o = out + b * 3;
            o[0] = A::mul(h, s_int);
            o[1] = x_mid;
            o[2] = A::mul(static_cast<T>(n), eng);
        }
    }
}

// a tile of 16 samples in f32, 8 in f64; kNoTile where n exceeds
// kMaxCells or the tile's a and xi exceed one block's shared memory
template <typename T>
int launch(const T* xis, const T* mckT, T* out, int B, int n_kl, int n,
           double h2, double h, void* stream_) {
    constexpr int S = sizeof(T) == 4 ? 16 : 8;
    if (n > kMaxCells) return kNoTile;
    const size_t smem = static_cast<size_t>(S)
        * (static_cast<size_t>(tile_ld(n)) + n_kl) * sizeof(T);
    if (smem > kMaxSmem) return kNoTile;
    if (B <= 0) return 0;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            diffusion_outputs_kernel<T, S>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    int lanes = 1;                  // power of two >= n, at most a warp
    while (lanes < n && lanes < 32) lanes <<= 1;
    const int grid = static_cast<int>((static_cast<long long>(B) + S - 1) / S);
    diffusion_outputs_kernel<T, S>
        <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream_)>>>(
            xis, mckT, out, B, n_kl, n, lanes, static_cast<T>(h2),
            static_cast<T>(h));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bluest_diffusion_max_cells() { return kMaxCells; }

extern "C" int bluest_diffusion_outputs_f32(
        const float* xis, const float* mckT, float* out, int B, int n_kl,
        int n, double h2, double h, void* stream) {
    return launch<float>(xis, mckT, out, B, n_kl, n, h2, h, stream);
}

extern "C" int bluest_diffusion_outputs_f64(
        const double* xis, const double* mckT, double* out, int B,
        int n_kl, int n, double h2, double h, void* stream) {
    return launch<double>(xis, mckT, out, B, n_kl, n, h2, h, stream);
}
