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
// tier below, which computes the same function, so no (n, n_kl) is refused.
//
// The wide tier: two kernels a slab of samples, the slab's a (slab, n) in a
// buffer of ~32 MB (kSlabBytes) that the wrapper allocates, so stage 2 reads
// what stage 1 wrote largely from the 50 MB L2.
//   Stage 1 (synth_kernel), a = exp(xis @ mckT), is the function's work: at
//   n = 4096, n_kl = 1024, B = 8192 it is 68.7 of 69.3 GFLOP, so it is
//   bound by operations (bluest_diffusion_wide's bound, 1.04 ms, takes it
//   at the FP64 tensor rate).  A tiled product: a block owns 64 samples x
//   128 cells in f64 (128 x 128 in f32), stages tiles of xi and mckT
//   through shared memory kBK = 16 modes at a time with cp.async, double-
//   buffered, and keeps its sums in registers over all n_kl, so mck is read
//   B / 64 times (B / 128 in f32) from L2 and no partial sum leaves the
//   block.  f64 runs on the FP64 tensor cores (mma.sync m16n8k8; Hopper's
//   wgmma has no f64 form), so the sum's order is the hardware's: it differs
//   from the plain version's in-order sum within the bound of a sum taken in
//   any order, 2 n_kl u sum_k |mck_ik xi_bk| relative to log a.  f32 stays
//   on CUDA cores (TF32 keeps ~3 digits and log a spans ~+-8): a thread owns
//   8 samples x 8 cells and adds mode by mode in order, with separate _rn
//   multiplies and adds, so it is bit-equal to the plain version; its
//   ceiling is 68.7 G instructions at 33.5 T/s, ~2.05 ms.
//   Stage 2 (solve_kernel), the solve, ~0.6 GFLOP, waits on dependent
//   chains.  L(n) lanes a sample (wide_lanes: the power of two >= min(n,
//   32) and >= ceil((n-1)/32), as K1's 32 at n <= 1025, 128 at n = 4096), so
//   a lane owns <= 32 rows and its chain is ~3 x 32 steps.  Up to L = 256
//   (n <= 8193) a block of 256 threads holds 256 / L samples, copies their a
//   into padded shared memory (coalesced) and each lane keeps its rows'
//   three values in registers, as K1; the separators are solved by
//   parallel cyclic reduction across the block's warps through shared
//   memory, and the QoI sums fold over the lanes, both in the plain
//   version's order.  Past n = 8193, 32 rows for each of 512 or 1024 lanes
//   exceed a block's 64K registers, so a sample takes one block of L
//   threads, reads a where it lies and keeps the rows in a row store of
//   bluest_diffusion_wide_store(n) values a sample beside the slab's a;
//   past n = 32769 a lane owns more than 32 rows there.  Stage 2 is
//   bit-equal to the plain version's solve in both dtypes.
//
// Arithmetic.  Every multiply, add, subtract, divide and reciprocal outside
// the tensor cores uses the _rn intrinsics, which the compiler never
// contracts into FMAs, and K1's and the f32 mode synthesis keep the order
// k = 0, 1, ..., n_kl-1 for each cell.  The plain PyTorch version
// (ops/diffusion.py: synthesize_plain, then solve_plain) runs the same
// partition, the same loop orders, the same cyclic-reduction levels and
// the same butterfly tree (at each level lane j adds lane j + L/2^l), so
// in the same dtype K1 and the f32 wide tier agree with it bit for bit,
// and the f64 wide tier's solve does given its own a.  An FMA in the mode
// synthesis alone moved f64 outputs by 1.8e-10 against the plain version
// at n=1024 on an H100, which is why K1 keeps the in-order sum.
//
// Interface: plain C entry points returning cudaGetLastError(), or -1
// for a shape the kernel has no tile for (K1 past its reach; the wide tier
// given a buffer smaller than its plan), loaded with ctypes; mck is passed
// transposed, (n_kl, n); the caller allocates out (B, 3) and the wide
// tier's buffer (bluest_diffusion_wide_workspace_*) and passes its current
// stream.

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

constexpr int kSynthThreads = 256;  // stage 1's block
constexpr int kBK = 16;             // modes a stage of the staged tiles
constexpr int kBN = 128;            // cells a block tile
constexpr int kLdA = kBK + 4;       // padded row of the xi tile (BM, kBK)
constexpr int kLdB = kBN + 4;       // padded row of the mckT tile (kBK, kBN)
constexpr int kSolveThreads = 256;  // stage 2's block on the register path
constexpr int kRegLanes = 256;      // lanes up to which the rows fit registers
constexpr int kMaxLanes = 1024;     // lanes of one sample at most (a block)
constexpr long long kSlabBytes = 32LL << 20;   // a slab's a, ~L2-resident
constexpr int kMaxTilesY = 65535;   // stage 1's sample tiles a launch

template <typename T>
struct SynthTile;                   // samples a block tile of stage 1
template <>
struct SynthTile<double> { static constexpr int BM = 64; };
template <>
struct SynthTile<float> { static constexpr int BM = 128; };

// dst (shared) = src (global), Bytes of them, or zeros where !valid
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(Bytes), "r"(valid ? Bytes : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d += a b on the FP64 tensor cores: A (16, 8) row-major, B (8, 8)
// column-major; thread (g, t) = (lane / 4, lane % 4) holds a = A[g][t],
// A[g+8][t], A[g][t+4], A[g+8][t+4], b = B[t][g], B[t+4][g] and
// d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]
__device__ __forceinline__ void mma_16x8x8(double (&d)[4],
                                           const double (&a)[4],
                                           const double (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
          "d"(b[1]));
}

// one stage of stage 1's tiles: xi rows b0.. (BM, kBK) at As, mckT rows
// k0.. (kBK, kBN) at Bs, V values a copy, zeros past B, n_kl and n (V > 1
// only where n_kl and n are multiples of V, so a copy is all in or all out)
template <typename T, int BM, int V>
__device__ __forceinline__ void synth_load(T* As, T* Bs, const T* xis,
                                           const T* mckT, int B, int n_kl,
                                           int n, int b0, int i0, int k0,
                                           int tid) {
    constexpr int bytes = static_cast<int>(V * sizeof(T));
#pragma unroll
    for (int c = tid; c < BM * kBK / V; c += kSynthThreads) {
        const int r = c / (kBK / V), kk = (c % (kBK / V)) * V;
        const int b = b0 + r, k = k0 + kk;
        const bool ok = b < B && k < n_kl;
        cp_async<bytes>(As + r * kLdA + kk,
                        ok ? xis + static_cast<long long>(b) * n_kl + k
                           : xis, ok);
    }
#pragma unroll
    for (int c = tid; c < kBK * kBN / V; c += kSynthThreads) {
        const int kk = c / (kBN / V), j = (c % (kBN / V)) * V;
        const int k = k0 + kk, i = i0 + j;
        const bool ok = k < n_kl && i < n;
        cp_async<bytes>(Bs + kk * kLdB + j,
                        ok ? mckT + static_cast<long long>(k) * n + i
                           : mckT, ok);
    }
}

// Stage 1's product on one staged tile, and its epilogue.  f64: warp w
// owns samples BM/2 (w / 4) .. +BM/2 and cells 32 (w % 4) .. +32 of the
// block tile, as BM/32 x 4 tensor-core tiles of 16 x 8.  f32: thread (ty, tx) =
// (tid / 16, tid % 16) owns samples 4 ty + {0..3} and 64 + 4 ty + {0..3}
// and cells 4 tx + {0..3} and 64 + 4 tx + {0..3}, each sum taken mode by
// mode in order with separate _rn multiplies and adds.
template <typename T>
struct SynthAcc;

template <>
struct SynthAcc<double> {
    static constexpr int MT = SynthTile<double>::BM / 32;  // 16-row tiles
    double acc[MT][4][4];
    __device__ __forceinline__ void zero() {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.0;
    }
    __device__ __forceinline__ void stage(const double* As, const double* Bs,
                                          int tid) {
        const int warp = tid >> 5, lane = tid & 31;
        const int g = lane >> 2, t = lane & 3;
        const int wm = (warp >> 2) * 16 * MT, wn = (warp & 3) * 32;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 8) {
            double af[MT][4], bf[4][2];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                const double* r0 = As + (wm + 16 * mt + g) * kLdA + kk + t;
                const double* r1 = r0 + 8 * kLdA;
                af[mt][0] = r0[0]; af[mt][1] = r1[0];
                af[mt][2] = r0[4]; af[mt][3] = r1[4];
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const double* c0 = Bs + (kk + t) * kLdB + wn + 8 * nt + g;
                bf[nt][0] = c0[0]; bf[nt][1] = c0[4 * kLdB];
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                    mma_16x8x8(acc[mt][nt], af[mt], bf[nt]);
        }
    }
    __device__ __forceinline__ void store(double* a, int B, int n, int b0,
                                          int i0, int tid) const {
        const int warp = tid >> 5, lane = tid & 31;
        const int g = lane >> 2, t = lane & 3;
        const int wm = (warp >> 2) * 16 * MT, wn = (warp & 3) * 32;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                    const int b = b0 + wm + 16 * mt + g + 8 * (v >> 1);
                    const int i = i0 + wn + 8 * nt + 2 * t + (v & 1);
                    if (b < B && i < n)
                        a[static_cast<long long>(b) * n + i] =
                            Arith<double>::exp(acc[mt][nt][v]);
                }
    }
};

template <>
struct SynthAcc<float> {
    float acc[8][8];                // [sample j][cell c]
    __device__ __forceinline__ void zero() {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[j][c] = 0.0f;
    }
    static __device__ __forceinline__ int row(int ty, int j) {
        return 4 * ty + (j & 3) + 64 * (j >> 2);
    }
    static __device__ __forceinline__ int col(int tx, int c) {
        return 4 * tx + (c & 3) + 64 * (c >> 2);
    }
    __device__ __forceinline__ void stage(const float* As, const float* Bs,
                                          int tid) {
        using A = Arith<float>;
        const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
        for (int k4 = 0; k4 < kBK; k4 += 4) {
            float xa[8][4];
#pragma unroll
            for (int j = 0; j < 8; ++j)
                load_tile<4>(As + row(ty, j) * kLdA + k4, xa[j]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                float lo[4], hi[4];         // cells 4 tx.. and 64 + 4 tx..
                load_tile<4>(Bs + (k4 + kk) * kLdB + 4 * tx, lo);
                load_tile<4>(Bs + (k4 + kk) * kLdB + 64 + 4 * tx, hi);
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int c = 0; c < 8; ++c)
                        acc[j][c] = A::add(acc[j][c],
                                           A::mul(c < 4 ? lo[c] : hi[c - 4],
                                                  xa[j][kk]));
            }
        }
    }
    __device__ __forceinline__ void store(float* a, int B, int n, int b0,
                                          int i0, int tid) const {
        const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int b = b0 + row(ty, j);
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const int i = i0 + col(tx, c);
                if (b < B && i < n)
                    a[static_cast<long long>(b) * n + i] =
                        Arith<float>::exp(acc[j][c]);
            }
        }
    }
};

// Stage 1: a (B, n) = exp(xis (B, n_kl) @ mckT (n_kl, n)).  Block (x, y)
// owns cells x kBN.. and samples y BM.. and walks the modes kBK at a time,
// the next stage's tiles in flight (cp.async) while this one's are used.
template <typename T, int V>
__global__ void __launch_bounds__(kSynthThreads)
synth_kernel(const T* __restrict__ xis, const T* __restrict__ mckT,
             T* __restrict__ a, int B, int n_kl, int n) {
    constexpr int BM = SynthTile<T>::BM;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* As = reinterpret_cast<T*>(smem_raw);          // 2 x (BM, kLdA)
    T* Bs = As + 2 * BM * kLdA;                      // 2 x (kBK, kLdB)
    const int tid = threadIdx.x;
    const int i0 = blockIdx.x * kBN;
    const int b0 = blockIdx.y * BM;
    const int stages = (n_kl + kBK - 1) / kBK;
    SynthAcc<T> acc;
    acc.zero();
    synth_load<T, BM, V>(As, Bs, xis, mckT, B, n_kl, n, b0, i0, 0, tid);
    cp_async_commit();
    for (int st = 0; st < stages; ++st) {
        const int cur = st & 1;
        if (st + 1 < stages) {
            synth_load<T, BM, V>(As + (cur ^ 1) * BM * kLdA,
                                 Bs + (cur ^ 1) * kBK * kLdB, xis, mckT, B,
                                 n_kl, n, b0, i0, (st + 1) * kBK, tid);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        acc.stage(As + cur * BM * kLdA, Bs + cur * kBK * kLdB, tid);
        __syncthreads();
    }
    acc.store(a, B, n, b0, i0, tid);
}

// L(n): lanes that share one sample in the wide tier's solve -- the power
// of two >= min(n, 32) and >= ceil((n-1)/32), at most 1024; as K1's
// lanes_for up to n = 1025, and a lane owns <= 32 rows up to n = 32769
__host__ __device__ __forceinline__ int wide_lanes(int n) {
    const int need_rows = (n - 1 + kMaxRows - 1) / kMaxRows;
    const int need = (n < 32 ? n : 32) > need_rows ? (n < 32 ? n : 32)
                                                   : need_rows;
    int lanes = 1;
    while (lanes < need && lanes < kMaxLanes) lanes <<= 1;
    return lanes;
}

// values of one sample's row store on the store path (lanes > kRegLanes):
// the three elimination values of each interior row, (3, rows - 1, lanes)
// lane-minor; 0 on the register path
__host__ __device__ __forceinline__ long long wide_store(int n) {
    const int lanes = wide_lanes(n);
    if (n <= 1 || lanes <= kRegLanes) return 0;
    const long long m = n - 1;
    const long long P = lanes < m ? lanes : m;
    return 3 * ((m + P - 1) / P - 1) * lanes;
}

// Thomas down one interior row t of a lane (the unit load and the load
// w_rs at its first row), as K1.  With `flux` (lanes > 32, past K1's reach)
// the pivot is wi1 + ex, its excess over the next coefficient formed from
// the row before as wi ex' r' -- the same value as K1's (wi + wi1) - wi^2 r',
// without the cancellation that loses ~log2(t) bits by row t (3-10x more
// accurate QoIs at n = 2048); r and ex carry the row before's.
template <typename T>
__device__ __forceinline__ void thomas_down(T wi, T wi1, int t, int ni, T h2,
                                            bool flux, T& r, T& ex, T& cp,
                                            T& dpy, T& dpa, T& dpb) {
    using A = Arith<T>;
    const T lo = -wi;
    if (flux) {
        ex = t == 0 ? wi : A::mul(A::mul(wi, r), ex);
        r = A::rcp(A::add(wi1, ex));
    } else {
        r = A::rcp(A::sub(A::add(wi, wi1), A::mul(lo, cp)));
    }
    cp = A::mul(-wi1, r);
    dpy = A::mul(A::sub(h2, A::mul(lo, dpy)), r);
    dpa = A::mul(A::sub(t == 0 ? wi : T(0), A::mul(lo, dpa)), r);
    if (t == ni - 1) dpb = A::mul(wi1, r);
}

// back up one row: its responses to the unit load, the left separator and
// the lane's own separator
template <typename T>
__device__ __forceinline__ void thomas_up(T c_t, T dy, T da, T db, T& Yn,
                                          T& An, T& Bn) {
    using A = Arith<T>;
    Yn = A::sub(dy, A::mul(c_t, Yn));
    An = A::sub(da, A::mul(c_t, An));
    Bn = A::sub(db, A::mul(c_t, Bn));
}

// solve_separators across the block's lanes: the same reduced system and
// parallel cyclic reduction levels, exchanged through shared memory (X, 4
// values a thread) so a sample's lanes may span warps
template <typename T>
__device__ __forceinline__ void separators_block(
        T* X, int tid, bool active, int p, int P, int lanes, T h2, T wr,
        T wr1, T yF, T aF, T bF, T yL, T aL, T bL, T& Sp, T& Sprev) {
    using A = Arith<T>;
    const int nt = blockDim.x;
    T* X0 = X; T* X1 = X + nt; T* X2 = X + 2 * nt; T* X3 = X + 3 * nt;
    const bool last_lane = active && p == P - 1;
    X0[tid] = yF; X1[tid] = aF; X2[tid] = bF;
    __syncthreads();
    T yFn = T(0), aFn = T(0), bFn = T(0);
    if (!last_lane && p + 1 < lanes) {
        yFn = X0[tid + 1]; aFn = X1[tid + 1]; bFn = X2[tid + 1];
    }
    __syncthreads();
    T Ar = T(0), Br = T(1), Cr = T(0), Rr = T(0);
    if (active) {
        Ar = p > 0 ? -A::mul(wr, aL) : T(0);
        Br = A::sub(A::sub(A::add(wr, wr1), A::mul(wr, bL)),
                    A::mul(wr1, aFn));
        Cr = -A::mul(wr1, bFn);
        Rr = A::add(A::add(h2, A::mul(wr, yL)), A::mul(wr1, yFn));
    }
    for (int d = 1; d < lanes; d <<= 1) {   // parallel cyclic reduction
        X0[tid] = Ar; X1[tid] = Br; X2[tid] = Cr; X3[tid] = Rr;
        __syncthreads();
        T Am = T(0), Bm = T(1), Cm = T(0), Rm = T(0);
        T Ap = T(0), Bp = T(1), Cp = T(0), Rp = T(0);
        if (p >= d) {
            Am = X0[tid - d]; Bm = X1[tid - d]; Cm = X2[tid - d];
            Rm = X3[tid - d];
        }
        if (p + d < lanes) {
            Ap = X0[tid + d]; Bp = X1[tid + d]; Cp = X2[tid + d];
            Rp = X3[tid + d];
        }
        __syncthreads();
        const T k1 = A::div(Ar, Bm), k2 = A::div(Cr, Bp);
        Ar = -A::mul(k1, Am);
        Br = A::sub(A::sub(Br, A::mul(k1, Cm)), A::mul(k2, Ap));
        Cr = -A::mul(k2, Cp);
        Rr = A::sub(A::sub(Rr, A::mul(k1, Rm)), A::mul(k2, Rp));
    }
    Sp = A::div(Rr, Br);
    X0[tid] = Sp;
    __syncthreads();
    Sprev = p > 0 ? X0[tid - 1] : T(0);
    __syncthreads();
}

// Stage 2: the QoIs of B samples from their a (B, n), `lanes` lanes a
// sample (K1's partitioned solve).  kRegs: 256 threads hold 256 / lanes
// samples, each sample's a copied into padded shared memory, each lane's
// <= 32 rows in registers.  Else (lanes > 256, n > 8193: 32 rows of three
// values for every lane of a sample exceed a block's registers) one sample
// a block of `lanes` threads, a read where it lies and the rows in the
// row store (wide_store(n) values a sample).
template <typename T, bool kRegs>
__global__ void __launch_bounds__(kRegs ? kSolveThreads : kMaxLanes)
solve_kernel(const T* __restrict__ a, T* __restrict__ out,
             T* __restrict__ store, int B, int n, int lanes, T h2, T h) {
    using A = Arith<T>;
    constexpr int CMAX = kMaxRows;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* X = reinterpret_cast<T*>(smem_raw);           // (4, threads)
    const int tid = threadIdx.x;
    const int per_block = blockDim.x / lanes;
    const int slot = tid / lanes;
    const int p = tid - slot * lanes;                // lane within the sample
    const long long first = static_cast<long long>(blockIdx.x) * per_block;
    const long long b = first + slot;
    const bool valid = b < B;
    const int m = n - 1;
    const int P = lanes < m ? lanes : m;             // lanes that own rows
    const bool active = valid && p < P;
    const int ld = tile_ld(n);
    const T* w;
    if constexpr (kRegs) {
        T* tile = X + 4 * blockDim.x;                // (per_block, ld)
        for (int idx = tid; idx < per_block * n; idx += blockDim.x) {
            const int s = idx / n, i = idx - s * n;
            if (first + s < B)
                tile[s * ld + padded(i)] = a[(first + s) * n + i];
        }
        __syncthreads();
        w = tile + slot * ld;
    } else {
        w = a + (valid ? b : 0) * n;
    }
    auto at = [&](int i) -> T {
        if constexpr (kRegs) return w[padded(i)];
        else return w[i];
    };
    const int rs = active ? static_cast<int>(static_cast<long long>(p) * m / P)
                          : m;                       // rows [rs, re)
    const int re = active
        ? static_cast<int>(static_cast<long long>(p + 1) * m / P) : m;
    const int c = re - rs;
    const int ni = c > 0 ? c - 1 : 0;                // interior rows

    const bool flux = lanes > 32;
    T cp = T(0), dpy = T(0), dpa = T(0), dpb = T(0), r = T(0), ex = T(0);
    T Yn = T(0), An = T(0), Bn = T(0);
    T st0[kRegs ? CMAX - 1 : 1], st1[kRegs ? CMAX - 1 : 1],
      st2[kRegs ? CMAX - 1 : 1];
    T *g0 = nullptr, *g1 = nullptr, *g2 = nullptr;   // row t at [t * lanes]
    if constexpr (kRegs) {
#pragma unroll
        for (int t = 0; t < CMAX - 1; ++t) {
            if (t < ni) {
                thomas_down(at(rs + t), at(rs + t + 1), t, ni, h2, flux, r,
                            ex, cp, dpy, dpa, dpb);
                st0[t] = cp; st1[t] = dpy; st2[t] = dpa;
            }
        }
#pragma unroll
        for (int t = CMAX - 2; t >= 0; --t) {
            if (t < ni) {
                thomas_up(st0[t], st1[t], st2[t], t == ni - 1 ? dpb : T(0),
                          Yn, An, Bn);
                st0[t] = Bn; st1[t] = Yn; st2[t] = An;
            }
        }
    } else {
        const long long cstride = wide_store(n) / 3;
        g0 = store + (valid ? b : 0) * 3 * cstride + p;
        g1 = g0 + cstride;
        g2 = g1 + cstride;
        for (int t = 0; t < ni; ++t) {
            thomas_down(at(rs + t), at(rs + t + 1), t, ni, h2, flux, r, ex,
                        cp, dpy, dpa, dpb);
            g0[t * lanes] = cp; g1[t * lanes] = dpy; g2[t * lanes] = dpa;
        }
        for (int t = ni - 1; t >= 0; --t) {
            thomas_up(g0[t * lanes], g1[t * lanes], g2[t * lanes],
                      t == ni - 1 ? dpb : T(0), Yn, An, Bn);
            g0[t * lanes] = Bn; g1[t * lanes] = Yn; g2[t * lanes] = An;
        }
    }
    const bool has = ni > 0;
    const T yF = has ? Yn : T(0), aF = has ? An : T(0), bF = has ? Bn : T(1);
    const T yL = has ? dpy : T(0), aL = has ? dpa : T(1),
            bL = has ? dpb : T(0);

    T Sp, Sprev;
    separators_block<T>(X, tid, active, p, P, lanes, h2,
                        active ? at(re - 1) : T(0), active ? at(re) : T(0),
                        yF, aF, bF, yL, aL, bL, Sp, Sprev);

    // this lane's rows in order: the QoI sums
    const int mid = n / 2 - 1;
    T s_int = T(0), eng = T(0), x_mid = T(0), x_prev = Sprev;
    auto row = [&](int t, T x) {
        const T dd = A::sub(x, x_prev);
        s_int = A::add(s_int, x);
        eng = A::add(eng, A::mul(A::mul(at(rs + t), dd), dd));
        if (rs + t == mid) x_mid = x;
        x_prev = x;
    };
    if constexpr (kRegs) {
#pragma unroll
        for (int t = 0; t < CMAX; ++t) {
            if (t < c) {
                T x = Sp;
                if (t < CMAX - 1 && t < ni)
                    x = A::add(A::add(st1[t], A::mul(Sprev, st2[t])),
                               A::mul(Sp, st0[t]));
                row(t, x);
            }
        }
    } else {
        for (int t = 0; t < c; ++t) {
            T x = Sp;
            if (t < ni)
                x = A::add(A::add(g1[t * lanes], A::mul(Sprev, g2[t * lanes])),
                           A::mul(Sp, g0[t * lanes]));
            row(t, x);
        }
    }
    if (active && p == P - 1) {     // the last cell, to u(1) = 0
        const T dd = A::sub(T(0), x_prev);
        eng = A::add(eng, A::mul(A::mul(at(m), dd), dd));
    }

    // the sums over the sample's lanes, the plain version's halving fold
    X[tid] = s_int; X[blockDim.x + tid] = x_mid;
    X[2 * blockDim.x + tid] = eng;
    __syncthreads();
    for (int o = lanes >> 1; o > 0; o >>= 1) {
        if (p < o)
            for (int q = 0; q < 3; ++q)
                X[q * blockDim.x + tid] = A::add(X[q * blockDim.x + tid],
                                                 X[q * blockDim.x + tid + o]);
        __syncthreads();
    }
    if (valid && p == 0) {
        T* o = out + b * 3;
        o[0] = A::mul(h, X[tid]);
        o[1] = X[blockDim.x + tid];
        o[2] = A::mul(static_cast<T>(n), X[2 * blockDim.x + tid]);
    }
}

__host__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
}

template <typename T, int V>
int launch_synth_v(const T* xis, const T* mckT, T* a, int B, int n_kl, int n,
                   cudaStream_t stream) {
    constexpr int BM = SynthTile<T>::BM;
    const size_t smem = (2 * BM * kLdA + 2 * kBK * kLdB) * sizeof(T);
    int rc = allow_smem(synth_kernel<T, V>, smem);
    if (rc != 0) return rc;
    constexpr long long kRows = static_cast<long long>(kMaxTilesY) * BM;
    for (long long b0 = 0; b0 < B; b0 += kRows) {
        const int rows = static_cast<int>(B - b0 < kRows ? B - b0 : kRows);
        const dim3 grid((n + kBN - 1) / kBN, (rows + BM - 1) / BM);
        synth_kernel<T, V><<<grid, kSynthThreads, smem, stream>>>(
            xis + b0 * n_kl, mckT, a + b0 * n, rows, n_kl, n);
        rc = static_cast<int>(cudaGetLastError());
        if (rc != 0) return rc;
    }
    return 0;
}

// stage 1 on B samples: 16-byte copies where every row of xi and mckT
// starts 16-byte aligned, else one value a copy
template <typename T>
int launch_synth(const T* xis, const T* mckT, T* a, int B, int n_kl, int n,
                 cudaStream_t stream) {
    constexpr int V = 16 / sizeof(T);
    if (B <= 0) return 0;
    if (n_kl % V == 0 && n % V == 0 && aligned16(xis) && aligned16(mckT))
        return launch_synth_v<T, V>(xis, mckT, a, B, n_kl, n, stream);
    return launch_synth_v<T, 1>(xis, mckT, a, B, n_kl, n, stream);
}

// stage 2 on B samples; `store` holds B * wide_store(n) values
template <typename T>
int launch_solve(const T* a, T* out, T* store, int B, int n, double h2,
                 double h, cudaStream_t stream) {
    if (B <= 0) return 0;
    if (n <= 1)                     // one cell: no interior unknowns
        return static_cast<int>(cudaMemsetAsync(
            out, 0, static_cast<size_t>(B) * 3 * sizeof(T), stream));
    const int lanes = wide_lanes(n);
    if (lanes <= kRegLanes) {
        const int per_block = kSolveThreads / lanes;
        const size_t smem = (4 * kSolveThreads
                             + static_cast<size_t>(per_block) * tile_ld(n))
            * sizeof(T);
        const int rc = allow_smem(solve_kernel<T, true>, smem);
        if (rc != 0) return rc;
        const int grid = (B + per_block - 1) / per_block;
        solve_kernel<T, true><<<grid, kSolveThreads, smem, stream>>>(
            a, out, store, B, n, lanes, static_cast<T>(h2),
            static_cast<T>(h));
    } else {
        const size_t smem = 4 * static_cast<size_t>(lanes) * sizeof(T);
        solve_kernel<T, false><<<B, lanes, smem, stream>>>(
            a, out, store, B, n, lanes, static_cast<T>(h2),
            static_cast<T>(h));
    }
    return static_cast<int>(cudaGetLastError());
}

// samples a slab: its a (and row store) within kSlabBytes, at least one
template <typename T>
long long wide_slab(int B, int n) {
    const long long per =
        (n + wide_store(n)) * static_cast<long long>(sizeof(T));
    long long slab = kSlabBytes / per;
    if (slab < 1) slab = 1;
    return slab < B ? slab : B;
}

template <typename T>
int wide_workspace(int B, int n, long long* ws_elems) {
    *ws_elems = B > 0 && n > 1 ? wide_slab<T>(B, n) * (n + wide_store(n)) : 0;
    return 0;
}

// the whole function: slab by slab, stage 1 into the slab's a, then stage
// 2 from it, both on `stream`; ws holds wide_workspace's values
template <typename T>
int launch_wide(const T* xis, const T* mckT, T* out, T* ws,
                long long ws_elems, int B, int n_kl, int n, double h2,
                double h, void* stream_) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_);
    if (B <= 0) return 0;
    if (n <= 1)
        return launch_solve<T>(nullptr, out, nullptr, B, n, h2, h, stream);
    long long need = 0;
    wide_workspace<T>(B, n, &need);
    if (ws_elems < need) return kNoTile;
    const long long slab = wide_slab<T>(B, n);
    T* abuf = ws;
    T* store = ws + slab * n;
    for (long long b0 = 0; b0 < B; b0 += slab) {
        const int rows = static_cast<int>(B - b0 < slab ? B - b0 : slab);
        int rc = launch_synth<T>(xis + b0 * n_kl, mckT, abuf, rows, n_kl, n,
                                 stream);
        if (rc != 0) return rc;
        rc = launch_solve<T>(abuf, out + b0 * 3, store, rows, n, h2, h,
                             stream);
        if (rc != 0) return rc;
    }
    return 0;
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

extern "C" int bluest_diffusion_wide_lanes(int n) { return wide_lanes(n); }

extern "C" long long bluest_diffusion_wide_store(int n) {
    return wide_store(n);
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

// the wide tier's two stages alone (phase 3 holds each against its plain
// version): stage 1 into a (B, n); stage 2 from a, with `store` holding
// B * bluest_diffusion_wide_store(n) values
extern "C" int bluest_diffusion_synth_f32(const float* xis, const float* mckT,
                                          float* a, int B, int n_kl, int n,
                                          void* stream) {
    return launch_synth<float>(xis, mckT, a, B, n_kl, n,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int bluest_diffusion_synth_f64(const double* xis,
                                          const double* mckT, double* a,
                                          int B, int n_kl, int n,
                                          void* stream) {
    return launch_synth<double>(xis, mckT, a, B, n_kl, n,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int bluest_diffusion_solve_f32(const float* a, float* out,
                                          float* store, long long store_elems,
                                          int B, int n, double h2, double h,
                                          void* stream) {
    if (store_elems < static_cast<long long>(B) * wide_store(n)) return kNoTile;
    return launch_solve<float>(a, out, store, B, n, h2, h,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int bluest_diffusion_solve_f64(const double* a, double* out,
                                          double* store, long long store_elems,
                                          int B, int n, double h2, double h,
                                          void* stream) {
    if (store_elems < static_cast<long long>(B) * wide_store(n)) return kNoTile;
    return launch_solve<double>(a, out, store, B, n, h2, h,
                                static_cast<cudaStream_t>(stream));
}
