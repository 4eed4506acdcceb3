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
// Reach: K1 takes n <= 32 * 32 + 1 = 1025 cells (bluest_diffusion_max_cells),
// so a lane owns at most 32 rows and keeps them in registers (a 128-row
// register variant spilled at 255 registers), and only shapes whose tile of
// a and xi fits one block's shared memory.  Every other shape runs the wide
// tier below, which computes the same function with the same partition and
// arithmetic, so no (n, n_kl) is refused.
//
// The wide tier (diffusion_outputs_wide_kernel).  A block of 256 threads
// walks tiles of S samples (32 in f32, 16 in f64; a persistent grid of as
// many blocks as the card holds at once).  For each tile it
//   1. forms log a for the whole tile as K1 does (a thread per cell, each
//      accumulating its cell for all S samples of the tile, one mck read
//      shared by the S samples), with xi staged through shared memory 128
//      modes at a time, so n_kl is unbounded: between chunks the partial
//      sums wait in the row store (same dtype, same order k = 0, 1, ...,
//      so the sum is the one K1 and the plain version form).  A thread
//      forms one cell (forming several from each load of xi is untried);
//   2. solves each sample with a warp, as K1, but each lane's rows (a, and
//      the three elimination values of each interior row) live in a row
//      store: a per sample, padded as K1's tile, then the three values
//      lane-minor, (rows, lanes), so a warp's step t touches consecutive
//      words.  The row store is shared memory where the block's tile fits
//      (with the xi chunk) in 227 KB, else a global workspace that the
//      wrapper allocates, one slab of S samples per block of the grid.
// At n = 4096, n_kl = 1024, B = 8192 the synthesis is 68.7 GFLOP of the
// 69.3 that the function needs (bluest_diffusion_wide's bound, 1.04 ms, is
// the FP64 tensor-core rate; non-contracting CUDA-core arithmetic can reach
// ~4 ms in f64), and the row store moves ~0.5 MB a sample through L2.
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
// for a shape the kernel has no tile for (K1 past its reach; the wide tier
// given a workspace smaller than its plan), loaded with ctypes; mck is
// passed transposed, (n_kl, n); the caller allocates out (B, 3) and the
// wide tier's workspace (bluest_diffusion_wide_workspace_*) and passes its
// current stream.

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

// The reduced system on the separators (row re-1 of each lane), one row
// per lane, idle lanes holding the identity, solved across the `lanes`
// lanes of each sample by parallel cyclic reduction over shuffles.  yF, aF,
// bF are the responses of the lane's first row to the unit load and to the
// two separators, yL, aL, bL those of its last interior row; wr, wr1 the
// coefficients a at cells re-1 and re.  Gives this lane's separator Sp and
// the one before it, Sprev (0 for the first lane).  K1 and the wide tier
// share it, and the plain version mirrors it step for step.
template <typename T>
__device__ __forceinline__ void solve_separators(
        bool active, int p, int P, int lanes, T h2, T wr, T wr1,
        T yF, T aF, T bF, T yL, T aL, T bL, T& Sp, T& Sprev) {
    using A = Arith<T>;
    const bool last_lane = active && p == P - 1;
    T yFn = __shfl_down_sync(kFull, yF, 1, lanes);
    T aFn = __shfl_down_sync(kFull, aF, 1, lanes);
    T bFn = __shfl_down_sync(kFull, bF, 1, lanes);
    if (last_lane) { yFn = T(0); aFn = T(0); bFn = T(0); }
    T Ar = T(0), Br = T(1), Cr = T(0), Rr = T(0);
    if (active) {
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
    Sp = A::div(Rr, Br);
    Sprev = __shfl_up_sync(kFull, Sp, 1, lanes);
    if (p == 0) Sprev = T(0);
}

// lanes that share one sample: the power of two >= n, at most a warp
__host__ __device__ __forceinline__ int lanes_for(int n) {
    int lanes = 1;
    while (lanes < n && lanes < 32) lanes <<= 1;
    return lanes;
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

        T Sp, Sprev;
        solve_separators<T>(active, p, P, lanes, h2,
                            active ? w[padded(re - 1)] : T(0),
                            active ? w[padded(re)] : T(0),
                            yF, aF, bF, yL, aL, bL, Sp, Sprev);
        const bool last_lane = active && p == P - 1;

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

// K1's tile: 16 samples in f32, 8 in f64, of padded a and xi; 0 bytes
// where K1 has none (n past kMaxCells, or the tile past one block's
// shared memory)
size_t k1_smem(int itemsize, int n_kl, int n) {
    const int S = itemsize == 4 ? 16 : 8;
    const size_t smem = static_cast<size_t>(S)
        * (static_cast<size_t>(tile_ld(n)) + n_kl) * itemsize;
    return n <= kMaxCells && smem <= static_cast<size_t>(kMaxSmem) ? smem
                                                                   : 0;
}

template <typename T>
int launch(const T* xis, const T* mckT, T* out, int B, int n_kl, int n,
           double h2, double h, void* stream_) {
    constexpr int S = sizeof(T) == 4 ? 16 : 8;
    const size_t smem = k1_smem(sizeof(T), n_kl, n);
    if (smem == 0) return kNoTile;
    if (B <= 0) return 0;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            diffusion_outputs_kernel<T, S>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int lanes = lanes_for(n);
    const int grid = static_cast<int>((static_cast<long long>(B) + S - 1) / S);
    diffusion_outputs_kernel<T, S>
        <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream_)>>>(
            xis, mckT, out, B, n_kl, n, lanes, static_cast<T>(h2),
            static_cast<T>(h));
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- wide tier

constexpr int kModeChunk = 128;     // modes of xi staged in shared memory

template <typename T>
struct WideTile {                   // samples a block's tile holds
    static constexpr int S = sizeof(T) == 4 ? 32 : 16;
};

__host__ __device__ __forceinline__ long long round32(long long v) {
    return (v + 31) / 32 * 32;
}

// the wide tier's row store of one sample: a (padded as K1's tile), then
// st0, st1, st2, each (cm1, lanes) lane-minor, cm1 = the most interior rows
// a lane owns; one sample's store is `wide_stride` values
struct WideRows {
    int lanes, P, cm1;
    long long a_ld, stride;
};

__host__ __device__ __forceinline__ WideRows wide_rows(int n) {
    WideRows r;
    const int m = n - 1;
    r.lanes = lanes_for(n);
    r.P = r.lanes < m ? r.lanes : m;
    r.cm1 = m > 0 ? (m + r.P - 1) / r.P - 1 : 0;
    r.a_ld = round32(tile_ld(n > 1 ? n : 1));
    r.stride = round32(r.a_ld + 3LL * r.cm1 * r.lanes);
    return r;
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
diffusion_outputs_wide_kernel(const T* __restrict__ xis,    // (B, n_kl)
                              const T* __restrict__ mckT,   // (n_kl, n)
                              T* __restrict__ out,          // (B, 3)
                              T* __restrict__ ws,           // row stores
                              int B, int n_kl, int n, int rows_in_smem,
                              T h2, T h) {
    using A = Arith<T>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* xs = reinterpret_cast<T*>(smem_raw);          // (kModeChunk, S)
    const WideRows R = wide_rows(n);
    T* rows = rows_in_smem
        ? xs + kModeChunk * S
        : ws + static_cast<long long>(blockIdx.x) * S * R.stride;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long tiles = (static_cast<long long>(B) + S - 1) / S;

    if (n <= 1) {                   // one cell: no interior unknowns
        for (long long b = static_cast<long long>(blockIdx.x) * kThreads
                 + tid; b < B; b += static_cast<long long>(gridDim.x)
                 * kThreads) {
            T* o = out + b * 3;
            o[0] = T(0); o[1] = T(0); o[2] = T(0);
        }
        return;
    }

    const int m = n - 1;
    const int lanes = R.lanes, P = R.P, cm1 = R.cm1;
    const int per_warp = 32 / lanes;
    const int sub = lane / lanes;
    const int p = lane - sub * lanes;             // lane within the sample
    const int mid = n / 2 - 1;
    const long long cstride = static_cast<long long>(cm1) * lanes;

    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long b0 = tile * S;

        // ---- mode synthesis, kModeChunk modes of xi at a time; between
        // chunks each cell's partial sum waits in its place in the store,
        // and the last chunk writes exp of the whole sum ----
        for (int k0 = 0; k0 < n_kl; k0 += kModeChunk) {
            const int kc = n_kl - k0 < kModeChunk ? n_kl - k0 : kModeChunk;
            __syncthreads();        // the tile's (or chunk's) readers are done
            for (int idx = tid; idx < S * kc; idx += kThreads) {
                const int s = idx / kc;
                const int k = idx - s * kc;
                const long long b = b0 + s;
                xs[k * S + s] = b < B ? xis[b * n_kl + k0 + k] : T(0);
            }
            __syncthreads();
            const bool last = k0 + kc >= n_kl;
            for (int i = tid; i < n; i += kThreads) {
                T x[S], acc[S];
                int k = 0;
                if (k0 == 0) {
                    load_tile<S>(xs, x);
                    const T m0 = __ldg(mckT + i);
#pragma unroll
                    for (int s = 0; s < S; ++s) acc[s] = A::mul(m0, x[s]);
                    k = 1;
                } else {
#pragma unroll
                    for (int s = 0; s < S; ++s)
                        acc[s] = rows[s * R.stride + padded(i)];
                }
#pragma unroll 4
                for (; k < kc; ++k) {
                    const T mk = __ldg(mckT + static_cast<size_t>(k0 + k) * n
                                       + i);
                    load_tile<S>(xs + k * S, x);
#pragma unroll
                    for (int s = 0; s < S; ++s)
                        acc[s] = A::add(acc[s], A::mul(mk, x[s]));
                }
#pragma unroll
                for (int s = 0; s < S; ++s)
                    rows[s * R.stride + padded(i)] = last ? A::exp(acc[s])
                                                          : acc[s];
            }
        }
        __syncthreads();

        // ---- the partitioned solve, as K1's, the rows in the store ----
        for (int s0 = warp * per_warp; s0 < S; s0 += kWarps * per_warp) {
            const int slot = s0 + sub;
            const bool active = slot < S && p < P;
            T* const w = rows + (active ? slot : 0) * R.stride;
            T* const st0 = w + R.a_ld + p;          // row t at [t * lanes]
            T* const st1 = st0 + cstride;
            T* const st2 = st1 + cstride;
            const int rs = active ? p * m / P : m;      // rows [rs, re)
            const int re = active ? (p + 1) * m / P : m;
            const int c = re - rs;
            const int ni = c > 0 ? c - 1 : 0;          // interior rows

            T cp = T(0), dpy = T(0), dpa = T(0), dpb = T(0);
            for (int t = 0; t < ni; ++t) {
                const T wi = w[padded(rs + t)], wi1 = w[padded(rs + t + 1)];
                const T lo = -wi;
                const T r = A::rcp(A::sub(A::add(wi, wi1), A::mul(lo, cp)));
                cp = A::mul(-wi1, r);
                dpy = A::mul(A::sub(h2, A::mul(lo, dpy)), r);
                dpa = A::mul(A::sub(t == 0 ? wi : T(0), A::mul(lo, dpa)), r);
                if (t == ni - 1) dpb = A::mul(wi1, r);
                st0[t * lanes] = cp; st1[t * lanes] = dpy;
                st2[t * lanes] = dpa;
            }
            T Yn = T(0), An = T(0), Bn = T(0);
            for (int t = ni - 1; t >= 0; --t) {
                const T c_t = st0[t * lanes];
                Yn = A::sub(st1[t * lanes], A::mul(c_t, Yn));
                An = A::sub(st2[t * lanes], A::mul(c_t, An));
                Bn = A::sub(t == ni - 1 ? dpb : T(0), A::mul(c_t, Bn));
                st0[t * lanes] = Bn; st1[t * lanes] = Yn;
                st2[t * lanes] = An;
            }
            const bool has = ni > 0;
            const T yF = has ? Yn : T(0), aF = has ? An : T(0),
                    bF = has ? Bn : T(1);
            const T yL = has ? dpy : T(0), aL = has ? dpa : T(1),
                    bL = has ? dpb : T(0);

            T Sp, Sprev;
            solve_separators<T>(active, p, P, lanes, h2,
                                active ? w[padded(re - 1)] : T(0),
                                active ? w[padded(re)] : T(0),
                                yF, aF, bF, yL, aL, bL, Sp, Sprev);
            const bool last_lane = active && p == P - 1;

            T s_int = T(0), eng = T(0), x_mid = T(0), x_prev = Sprev;
            for (int t = 0; t < c; ++t) {
                T x = Sp;
                if (t < ni)
                    x = A::add(A::add(st1[t * lanes],
                                      A::mul(Sprev, st2[t * lanes])),
                               A::mul(Sp, st0[t * lanes]));
                const T dd = A::sub(x, x_prev);
                s_int = A::add(s_int, x);
                eng = A::add(eng, A::mul(A::mul(w[padded(rs + t)], dd), dd));
                if (rs + t == mid) x_mid = x;
                x_prev = x;
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
}

// The wide tier's launch plan: the row stores in shared memory when the
// tile's fit beside the xi chunk, else in a workspace of `ws_elems` values
// (one slab of S samples per block); a persistent grid of as many blocks
// as the card holds at once, at most one per tile.
template <typename T>
int wide_plan(int B, int n, int* grid, size_t* smem, int* in_smem,
              long long* ws_elems) {
    constexpr int S = WideTile<T>::S;
    const WideRows R = wide_rows(n);
    const size_t xs_bytes = static_cast<size_t>(kModeChunk) * S * sizeof(T);
    const size_t tile_bytes = static_cast<size_t>(S) * R.stride * sizeof(T);
    *in_smem = xs_bytes + tile_bytes <= static_cast<size_t>(kMaxSmem);
    *smem = *in_smem ? xs_bytes + tile_bytes : xs_bytes;
    if (*smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            diffusion_outputs_wide_kernel<T, S>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(*smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, diffusion_outputs_wide_kernel<T, S>, kThreads, *smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long tiles = (static_cast<long long>(B) + S - 1) / S;
    long long g = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
    if (g > tiles) g = tiles;
    if (g < 1) g = 1;
    *grid = static_cast<int>(g);
    *ws_elems = *in_smem ? 0 : g * S * R.stride;
    return 0;
}

template <typename T>
int wide_workspace(int B, int n, long long* ws_elems) {
    int grid = 0, in_smem = 0;
    size_t smem = 0;
    return wide_plan<T>(B, n, &grid, &smem, &in_smem, ws_elems);
}

template <typename T>
int launch_wide(const T* xis, const T* mckT, T* out, T* ws,
                long long ws_elems, int B, int n_kl, int n, double h2,
                double h, void* stream_) {
    constexpr int S = WideTile<T>::S;
    if (B <= 0) return 0;
    int grid = 0, in_smem = 0;
    size_t smem = 0;
    long long need = 0;
    const int rc = wide_plan<T>(B, n, &grid, &smem, &in_smem, &need);
    if (rc != 0) return rc;
    if (n > 1 && ws_elems < need) return kNoTile;
    diffusion_outputs_wide_kernel<T, S>
        <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream_)>>>(
            xis, mckT, out, ws, B, n_kl, n, in_smem, static_cast<T>(h2),
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

// 1 where K1 has a tile for the shape, else 0: what the wrapper's
// dispatch predicate (ops/diffusion.py:tier) must agree with
extern "C" int bluest_diffusion_k1_fits(int itemsize, int n_kl, int n) {
    return k1_smem(itemsize, n_kl, n) > 0;
}

extern "C" int bluest_diffusion_wide_workspace_f32(int B, int n,
                                                   long long* ws_elems) {
    return wide_workspace<float>(B, n, ws_elems);
}

extern "C" int bluest_diffusion_wide_workspace_f64(int B, int n,
                                                   long long* ws_elems) {
    return wide_workspace<double>(B, n, ws_elems);
}

extern "C" int bluest_diffusion_wide_f32(
        const float* xis, const float* mckT, float* out, float* ws,
        long long ws_elems, int B, int n_kl, int n, double h2, double h,
        void* stream) {
    return launch_wide<float>(xis, mckT, out, ws, ws_elems, B, n_kl, n, h2,
                              h, stream);
}

extern "C" int bluest_diffusion_wide_f64(
        const double* xis, const double* mckT, double* out, double* ws,
        long long ws_elems, int B, int n_kl, int n, double h2, double h,
        void* stream) {
    return launch_wide<double>(xis, mckT, out, ws, ws_elems, B, n_kl, n, h2,
                               h, stream);
}
