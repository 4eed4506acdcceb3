// K6: the sampling combiner.  One launch folds a chunk of model outputs
// into the masked float64 MLBLUE sums of its group, added to the call's
// running sums.
//
// Replaces no Pallas kernel: it is the counterpart of the XLA einsums of
// the JAX package's combiner, bluest_tpu/sampling/kernel_engine.py:293
// (KernelEngineV2._get_combiners, its `core`).  Its plain version is
// bluest_tpu_torch/sampling/engine.py:combine_plain, which eager PyTorch
// ran on the card as ~20 small kernels and cuBLAS gemvs a chunk.
//
// What it computes: outs is (k, rows, No, d), read through its strides
// (the group engine's (rows, No, k, d) blocks moved model-major, the
// factored engine's stacked (k, rows, No, d)), float32 or float64.  Row r
// is valid when base + r < N and finite when all of its No k d values are
// finite; a valid finite row adds, for each output n,
//   se[n, i, c]     += P_i,c
//   sc[n, i, j]     += sum_c P_i,c P_j,c           (i <= j)
//   d1[n, i, j, c]  += P_i,c - P_j,c               (i < j)
//   d2[n, i, j]     += sum_c (P_i,c - P_j,c)^2     (i < j)
// with P_i,c = outs[i, r, n, c] in float64, and n_failed counts the valid
// rows that are not finite.  The lower triangles are mirrored from the
// upper ones at the end (sc and d2 equal, d1 negated: every term mirrors
// exactly), and the diagonals of d1 and d2 are 0.  d1 and d2 are summed
// from the differences themselves, never derived from se and sc, which
// would lose the digits the MLMC differences of close models keep.
//
// Bound: bytes.  A row is read once (40 bytes for the five outputs of one
// model in float64) and feeds k d + k(k+1)/2 + k(k-1)/2 (d+1) sums an
// output: 2 at k = 1, 15 at k = 3, 222 at k = 12 (d = 1), one or two
// operations each; up to k ~ 12 that stays under the card's FP64 rate
// per byte.  The outputs are a few kilobytes.  A block's threads keep
// K6_BATCH loads each in flight while staging a tile; the tile's load,
// check and sum phases do not overlap, which leaves the kernel latency
// bound at the cell's chunk (0.019 ms against 0.0031 at 3.35 TB/s on an
// H100 80GB HBM3, k = 1, five outputs, 262,144 rows).
//
// Layout: blocks of K6_THREADS threads.  A block stages a tile of R rows
// in shared memory (converted to float64, a row's values at a pitch made
// odd, so a warp reading one value of 32 rows meets no bank conflict),
// marks its valid finite rows, then its threads walk the tile as (slot,
// lane) pairs, thread slot * 256/S + lane: a thread holds K6_NE running
// sums in registers, the entries slot, slot + S, ..., slot + (K6_NE-1) S
// of the pass, over the tile's rows lane, lane + 256/S, ....  S is the
// power of two that covers the entries in K6_NE's (at most 256), so the
// row tile is shared by 256/S lanes; past 256 K6_NE entries the grid's
// second dimension takes further passes over the rows.  A warp's threads
// are lanes of one slot while a slot has 32 lanes or more, so they take
// the same branch for the same entry.  The host makes the plan from the
// shape alone (ops/combine.py:plan) and passes it in.  (A thread a row
// with 16 sums in registers, S = 1, ran 6-15% slower than this at every
// shape of at most 16 entries.)
//
// Determinism: every sum is taken in an order fixed by the shape.  A
// thread adds its rows in order; the lanes of a slot in one warp are
// added by an xor butterfly (16, 8, ..., 1, over at most the slot's
// lanes), then its warps in order; a block writes its partial sums to a
// scratch row of its own.
// The last block to finish (a ticket counter, reset by that block) adds
// the blocks' partials in block order -- each warp an entry, its lanes
// striding the blocks, then a butterfly -- and writes the total to the
// outputs (the call's first chunk) or adds it to what they hold
// (accumulate: the call's running sums, in place).  No floating-point
// atomics.  Each multiply, add and subtract rounds on its own (no fma
// contraction), so the order above fixes every bit:
// tests/test_torch_combine.py mirrors it.

#include <cuda_runtime.h>
#include <math.h>

#define K6_THREADS 256
// blocks at most: two an SM of an H100 (132 SMs), which the register
// budget keeps resident (K6_MIN_BLOCKS); fixed, so the grid, and with it
// the order of the sums, depends on the shape alone
#define K6_MAX_BLOCKS 264
#define K6_MIN_BLOCKS 2
// running sums (entries) a thread holds
#define K6_NE 8
// global loads a thread keeps in flight (the tile's, the last block's)
#define K6_BATCH 8
// a row's values fit the tile: an odd pitch of at most this many doubles
#define K6_MAX_PITCH 4095

struct K6Args {
  const void* outs;
  long long stride[4];      // model, row, output, component (elements)
  long long base, N;
  int k, rows, No, d;
  // the plan (ops/combine.py:plan)
  int W, pitch, per_output, E;
  int S, R, blocks, passes, region, flat;
  double* out[4];           // se, sc, d1, d2
  long long* nf;
  int accumulate;           // add to out (the running sums) or write it
  double* part;             // blocks x E partial sums
  long long* nf_part;       // blocks
  unsigned int* ticket;
};

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}

// the pair p of i < j (strict) or i <= j, row-major
__device__ __forceinline__ void pair(int p, int k, bool strict, int& i,
                                     int& j) {
  i = 0;
  int len = strict ? k - 1 : k;
  while (p >= len) {
    p -= len;
    ++i;
    --len;
  }
  j = i + p + (strict ? 1 : 0);
}

// Entry e of the sums: output n, then se (i, c), sc (i <= j), d1 (i < j,
// c), d2 (i < j).  op 0 se, 1 sc, 2 d1, 3 d2.
__device__ void decode(int e, const K6Args& a, int& op, int& n, int& i,
                       int& j, int& c) {
  const int k = a.k, d = a.d;
  n = e / a.per_output;
  int x = e - n * a.per_output;
  c = 0;
  j = 0;
  if (x < k * d) {
    op = 0;
    i = x / d;
    c = x - i * d;
    return;
  }
  x -= k * d;
  if (x < k * (k + 1) / 2) {
    op = 1;
    pair(x, k, false, i, j);
    return;
  }
  x -= k * (k + 1) / 2;
  const int P = k * (k - 1) / 2;
  if (x < P * d) {
    op = 2;
    const int p = x / d;
    c = x - p * d;
    pair(p, k, true, i, j);
    return;
  }
  op = 3;
  pair(x - P * d, k, true, i, j);
}

// an entry as the tile's inner loop reads it: op | a << 2 | b << 17, a and
// b the positions of its operands in a row, (n k + i) d + c
__device__ unsigned encode(int e, const K6Args& a) {
  int op, n, i, j, c;
  decode(e, a, op, n, i, j, c);
  const unsigned row = (unsigned)(n * a.k);
  const unsigned x = (row + i) * a.d + c, y = (row + j) * a.d + c;
  return (unsigned)op | (x << 2) | (y << 17);
}

// one row's term of an entry
__device__ __forceinline__ double term(unsigned t, const double* v, int d) {
  const int op = t & 3, x = (t >> 2) & 0x7fff, y = t >> 17;
  if (op == 0) return v[x];
  if (op == 2) return sub(v[x], v[y]);
  double s;
  if (op == 1) {
    s = mul(v[x], v[y]);
    for (int c = 1; c < d; ++c) s = add(s, mul(v[x + c], v[y + c]));
  } else {
    double z = sub(v[x], v[y]);
    s = mul(z, z);
    for (int c = 1; c < d; ++c) {
      z = sub(v[x + c], v[y + c]);
      s = add(s, mul(z, z));
    }
  }
  return s;
}

template <typename T>
__device__ __forceinline__ double load(const K6Args& a, long long row,
                                       int w) {
  const T* p = static_cast<const T*>(a.outs);
  long long off = row * a.stride[1];
  if (a.flat) {
    off += w;
  } else {
    const int kd = a.k * a.d, n = w / kd, r = w - n * kd, i = r / a.d,
              c = r - i * a.d;
    off += n * a.stride[2] + i * a.stride[0] + c * a.stride[3];
  }
  return (double)__ldg(p + off);
}

// out[t][idx] += v, or = v
__device__ __forceinline__ void put(const K6Args& a, int t, long long idx,
                                    double v) {
  a.out[t][idx] = a.accumulate ? add(a.out[t][idx], v) : v;
}

// the last block: each warp an entry, its lanes striding the blocks in
// order, then a butterfly; the mirrored entries and the diagonals
__device__ void finish(const K6Args& a) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k = a.k, d = a.d;
  for (int e = warp; e < a.E; e += K6_THREADS / 32) {
    // the lane's blocks in order, K6_BATCH loads in flight at a time
    double v = 0.0;
    for (int b0 = lane; b0 < a.blocks; b0 += 32 * K6_BATCH) {
      double x[K6_BATCH];
#pragma unroll
      for (int u = 0; u < K6_BATCH; ++u) {
        const int b = b0 + 32 * u;
        x[u] = b < a.blocks ? __ldcg(a.part + (long long)b * a.E + e) : 0.0;
      }
#pragma unroll
      for (int u = 0; u < K6_BATCH; ++u)
        if (b0 + 32 * u < a.blocks) v = add(v, x[u]);
    }
    for (int off = 16; off >= 1; off >>= 1)
      v = add(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane != 0) continue;
    int op, n, i, j, c;
    decode(e, a, op, n, i, j, c);
    const long long ij = ((long long)n * k + i) * k + j,
                    ji = ((long long)n * k + j) * k + i;
    if (op == 0) {
      put(a, 0, ((long long)n * k + i) * d + c, v);
    } else if (op == 1) {
      put(a, 1, ij, v);
      if (i != j) put(a, 1, ji, v);
    } else if (op == 2) {
      put(a, 2, ij * d + c, v);
      put(a, 2, ji * d + c, -v);
    } else {
      put(a, 3, ij, v);
      put(a, 3, ji, v);
    }
  }
  for (int x = tid; x < a.No * k; x += K6_THREADS) {
    const long long ii = (long long)x * k + x % k;   // (n k + i) k + i
    put(a, 3, ii, 0.0);
    for (int c = 0; c < d; ++c) put(a, 2, ii * d + c, 0.0);
  }
  // the failed rows (integers: any order gives the same count)
  __shared__ unsigned long long failed;
  if (tid == 0) failed = 0;
  __syncthreads();
  long long t = 0;
  for (int b = tid; b < a.blocks; b += K6_THREADS) t += __ldcg(a.nf_part + b);
  atomicAdd(&failed, (unsigned long long)t);
  __syncthreads();
  if (tid == 0)
    *a.nf = a.accumulate ? *a.nf + (long long)failed : (long long)failed;
}

template <typename T>
__global__ void __launch_bounds__(K6_THREADS, K6_MIN_BLOCKS)
combine_kernel(const K6Args a) {
  constexpr int NE = K6_NE;
  extern __shared__ double smem[];
  __shared__ int nf_block;
  __shared__ bool last;
  double* tile = smem;                              // R x pitch, then reused
  unsigned* tab = reinterpret_cast<unsigned*>(smem + a.region);  // S NE
  int* ok = reinterpret_cast<int*>(tab + a.S * NE);               // R
  const int tid = threadIdx.x, bx = blockIdx.x, S = a.S;
  const int e0 = blockIdx.y * S * NE, Ep = min(S * NE, a.E - e0);
  // thread (slot s, lane l): a warp's threads are lanes of one slot (or of
  // a few neighbouring slots), so they take the same branch of term()
  const int lanes = K6_THREADS / S, s = tid / lanes, l = tid - s * lanes;
  const int W = a.W, pitch = a.pitch, R = a.R;

  for (int x = tid; x < Ep; x += K6_THREADS) tab[x] = encode(e0 + x, a);
  if (tid == 0) nf_block = 0;
  __syncthreads();
  unsigned mine[NE];              // the thread's entries, ~0u past the pass
  double acc[NE];
#pragma unroll
  for (int q = 0; q < NE; ++q) {
    const int x = s + q * S;
    mine[q] = x < Ep ? tab[x] : ~0u;
    acc[q] = 0.0;
  }
  int nf = 0;
  // a thread's first value of a tile, (row, w), and its step
  const int row0 = tid / W, w0 = tid - row0 * W;
  const int drow = K6_THREADS / W, dw = K6_THREADS - drow * W;
  const long long tiles = ((long long)a.rows + R - 1) / R;
  for (long long t = bx; t < tiles; t += a.blocks) {
    const long long r0 = t * R;
    const int nr = (int)min((long long)R, (long long)a.rows - r0);
    __syncthreads();              // the last tile is read
    // K6_BATCH loads in flight, then their stores
    int row = row0, w = w0;
    for (int x0 = tid; x0 < nr * W; x0 += K6_BATCH * K6_THREADS) {
      double v[K6_BATCH];
      int at[K6_BATCH];
#pragma unroll
      for (int u = 0; u < K6_BATCH; ++u) {
        at[u] = row * pitch + w;
        if (x0 + u * K6_THREADS < nr * W) v[u] = load<T>(a, r0 + row, w);
        w += dw;
        row += drow;
        if (w >= W) {
          w -= W;
          ++row;
        }
      }
#pragma unroll
      for (int u = 0; u < K6_BATCH; ++u)
        if (x0 + u * K6_THREADS < nr * W) tile[at[u]] = v[u];
    }
    __syncthreads();
    if (tid < nr) {
      const double* v = tile + tid * pitch;
      bool fin = true;
      for (int x = 0; x < W; ++x) fin = fin && isfinite(v[x]);
      const bool valid = a.base + r0 + tid < a.N;
      ok[tid] = valid && fin;
      nf += valid && !fin;
    }
    __syncthreads();
    for (int r = l; r < nr; r += lanes) {
      if (!ok[r]) continue;
      const double* v = tile + r * pitch;
#pragma unroll
      for (int q = 0; q < NE; ++q)
        if (mine[q] != ~0u) acc[q] = add(acc[q], term(mine[q], v, a.d));
    }
  }

  // a slot's lanes inside a warp (an xor butterfly over LW lanes), then
  // its groups of LW lanes in order
  const int LW = min(lanes, 32), groups = lanes / LW;
#pragma unroll
  for (int q = 0; q < NE; ++q)
    for (int off = LW >> 1; off >= 1; off >>= 1)
      acc[q] = add(acc[q], __shfl_xor_sync(0xffffffffu, acc[q], off));
  nf = __reduce_add_sync(0xffffffffu, nf);
  __syncthreads();                // the tile is read: its space is reused
  double* red = smem;             // S x groups x NE
  if (l % LW == 0) {
#pragma unroll
    for (int q = 0; q < NE; ++q)
      red[(s * groups + l / LW) * NE + q] = acc[q];
  }
  if ((tid & 31) == 0) atomicAdd(&nf_block, nf);
  __syncthreads();
  for (int x = tid; x < S * NE; x += K6_THREADS) {
    const int sl = x / NE, q = x - sl * NE, xe = sl + q * S;
    if (xe >= Ep) continue;
    const double* r = red + sl * groups * NE + q;
    double v = r[0];
    for (int g = 1; g < groups; ++g) v = add(v, r[g * NE]);
    a.part[(long long)bx * a.E + e0 + xe] = v;
  }
  if (tid == 0 && blockIdx.y == 0) a.nf_part[bx] = nf_block;

  // the last block of the grid adds the partials
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(a.ticket, 1u) == (unsigned)(a.blocks * a.passes - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  finish(a);
  if (tid == 0) *a.ticket = 0u;
}

extern "C" int bluest_combine_max_blocks() { return K6_MAX_BLOCKS; }

extern "C" int bluest_combine_threads() { return K6_THREADS; }

extern "C" int bluest_combine_ne() { return K6_NE; }

// One launch on the stream.  strides: the four strides of outs in
// elements; shape: k, rows, No, d; plan: W, pitch, per_output, E, S, R,
// blocks, passes, region, flat, shared bytes (ops/combine.py:plan);
// sums: se, sc, d1, d2, n_failed; accumulate: add to them (1) or write
// them (0); scratch: blocks x E doubles, blocks int64 and a ticket
// counter that is 0 (each launch leaves it 0).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// it does not take.
extern "C" int bluest_combine_sums(const void* outs, int itemsize,
                                   const long long* strides,
                                   const int* shape, long long base,
                                   long long N, const int* plan,
                                   void* const* sums, int accumulate,
                                   double* part, long long* nf_part,
                                   unsigned int* ticket, void* stream) {
  K6Args a;
  a.outs = outs;
  for (int q = 0; q < 4; ++q) a.stride[q] = strides[q];
  a.base = base;
  a.N = N;
  a.k = shape[0];
  a.rows = shape[1];
  a.No = shape[2];
  a.d = shape[3];
  a.W = plan[0];
  a.pitch = plan[1];
  a.per_output = plan[2];
  a.E = plan[3];
  a.S = plan[4];
  a.R = plan[5];
  a.blocks = plan[6];
  a.passes = plan[7];
  a.region = plan[8];
  a.flat = plan[9];
  const int ne = K6_NE, bytes = plan[10];
  for (int q = 0; q < 4; ++q) a.out[q] = static_cast<double*>(sums[q]);
  a.nf = static_cast<long long*>(sums[4]);
  a.accumulate = accumulate != 0;
  a.part = part;
  a.nf_part = nf_part;
  a.ticket = ticket;
  const int kd = a.k * a.d;
  if (a.k < 1 || a.No < 1 || a.d < 1 || a.rows < 0
      || a.W != a.No * kd || a.pitch < a.W || (a.pitch & 1) == 0
      || a.pitch > K6_MAX_PITCH
      || a.S < 1 || a.S > K6_THREADS || (a.S & (a.S - 1)) != 0
      || a.R < 1 || a.R > K6_THREADS || a.blocks < 1
      || a.blocks > K6_MAX_BLOCKS || a.passes < 1
      || (long long)a.passes * a.S * ne < a.E
      || a.region < a.R * a.pitch
      || a.region < a.S * ne * (K6_THREADS / a.S < 32 ? 1
                                : K6_THREADS / a.S / 32)
      || bytes > 48 * 1024 || (itemsize != 4 && itemsize != 8)
      || a.per_output != kd + a.k * (a.k + 1) / 2
                             + a.k * (a.k - 1) / 2 * (a.d + 1)
      || a.E != a.No * a.per_output)
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < 5; ++q)
    if (sums[q] == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid(a.blocks, a.passes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (itemsize == 8)
    combine_kernel<double><<<grid, K6_THREADS, bytes, s>>>(a);
  else
    combine_kernel<float><<<grid, K6_THREADS, bytes, s>>>(a);
  return (int)cudaGetLastError();
}
