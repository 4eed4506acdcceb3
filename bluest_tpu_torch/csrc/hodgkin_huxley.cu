// K2: Hodgkin-Huxley time stepping with the five outputs reduced in
// registers, for every model of a group in one launch (float64).
//
// Replaces no Pallas kernel: it is the counterpart of XLA's fusion of the
// JAX package's lax.scan, bluest_tpu/models/hodgkin_huxley.py:_integrate
// (:66-89, the scan at :88) and _outputs (:92-102), per model under vmap
// of evaluate_jax (:127-133).  Its plain version is
// bluest_tpu_torch/ops/hodgkin_huxley.py:hh_group_outputs_plain, the same
// operations in the same order as eager PyTorch computes them on the card.
//
// What it computes: for each sample i (params (n, 3): applied current,
// gNa, gK) and each entry of the launch's model table (kind, dt, n_steps,
// output column), the RK4 (kind 0) or Euler (kind 1) integration of the
// HH equations, or RK4 of FitzHugh-Nagumo (kind 2), over n_steps steps of
// dt, and over the states after each step: the mean V, the final V, the
// max V (NaN if any V is NaN), the mean of sigmoid(V / 2) and the mean
// n-gate (FHN rescaled to HH units).  out is (n, 5, L), row-major.
//
// Bound: the FP64 pipe (64 lanes an SM, no tensor core: there is no
// product) and the latency of one serial chain a sample.  Bytes are
// negligible: 24 bytes of parameters per sample and 40 bytes of outputs
// per (sample, model).  A right-hand side of the HH equations is six
// rates, each an exp and a division, then ~40 multiplies and adds; one
// RK4 step is four dependent right-hand sides, and a model is up to 1000
// steps.  chip_smoke.py (k2_work) counts the operations of this source,
// each add, subtract, multiply, divide, exp and compare as one (a sign
// flip and a loop-invariant product not counted): 57 per HH right-hand
// side, 288 per HH RK4 step with the reductions, 73 per Euler step, 79
// per FHN step.  exp and a division take many FP64 instructions each;
// chip_smoke.py counts those in the SASS of one step.
//
// Layout: LANES lanes of a warp per (sample, model); LANES is the
// variant, chosen per launch on the host (ops.hodgkin_huxley.launch_plan):
//   LANES = 1 ("thread"): one thread integrates a sample, for launches
//     that fill the card with warps (a group at a large n): there the FP64
//     pipe is busy (on an H100, 57% of its issue slots for the 12-model
//     group at n=16384, 80% at 65536) and the fewest instructions win;
//   LANES = 8 ("lanes8"): a sample's seven exp-and-divide items (its six
//     rates and the sigmoid of the output) go one to a lane, in
//     lane-uniform code; each lane computes its item with its own
//     constants, the values are gathered with __shfl_sync, and the
//     derivatives, the RK4 stages and the five running reductions are
//     repeated on every lane of the sample.  For launches that leave each
//     SM sub-partition about one warp or less (one model at a few
//     thousand samples, the small groups of a solve): there one sample's
//     dependent chain sets the time (on an H100, 1000 RK4 steps of model
//     0 take ~2.4 ms on one lane whatever n up to 16384), and one exp a
//     lane a stage shortens it to ~1.05 ms, at 3x the FP64 instructions a
//     sample.
// A lane holds items j, j + LANES, ... (its slots): all seven on one lane,
// one on each of eight.
// blockIdx.y is the entry of the table, so kind, dt and the step count are
// uniform in a block and no warp diverges on them; the host orders the
// table longest model first, and blocks are dispatched in order of their
// linear index, so the longest models start first.  A warp wholly past n
// leaves; a sample past n in a live warp computes a copy of sample n-1
// (its lanes take part in the shuffles) and stores nothing.  The
// sigmoid of the state after step t is an item of step t+1's first stage,
// which starts from that state (and one more after the last step), so it
// overlaps the rates.  No shared memory.  The loop over steps is not
// unrolled.
//
// Arithmetic: the plain version's operations one by one, each rounded on
// its own as eager PyTorch rounds them (mul/add/sub below: no a*b+c is
// contracted into an fma).  exp and the divisions are CUDA's, compiled
// with nvcc's default flags as PyTorch's kernels are.  PyTorch on the
// card divides a tensor by a Python number as a multiply by the number's
// reciprocal (taken in double): divs() below.  m ** 3 is m*m*m, n ** 4 is
// (n*n)*(n*n) (the JAX package's integer_pow, written out in the plain
// version), 1.0 / x a true division.  A rate is num / den in one of three
// forms: c*(V+d) / ((1 - e) + 1e-12), c*e / 1.0 (exact: the product) and
// 1.0 / (1 + e), with e = exp(-(V+d) * r); the sigmoid is the third form
// at d = 0, r = 1/2, where V + 0 and V - 0 differ only in the sign of a
// zero, which exp maps to 1 either way.  So every variant gives the plain
// version's bits.

#include <cuda_runtime.h>
#include <math.h>

#define HH_MAX_MODELS 32
#define HH_THREADS 64
#define HH_ITEMS 7             // six rates and the sigmoid
#define HH_SIG 6               // the sigmoid's item
// blocks of HH_THREADS an SM that the register budget must allow
// (__launch_bounds__): 12 (24 warps) at <= 80 registers a thread, where
// both variants compile without spills (16 blocks, 64 registers, spill)
#define HH_MIN_BLOCKS 12

struct HHEntry {
  int kind;          // 0 HH RK4, 1 HH Euler, 2 FitzHugh-Nagumo RK4
  int n_steps;       // round(T_END / dt), >= 1
  int col;           // the model's column of the output
  double dt, hdt, c6, inv_steps;   // dt, 0.5*dt, dt/6.0, 1.0/n_steps
};

struct HHTable {
  HHEntry e[HH_MAX_MODELS];
};

// Each multiply, add and subtract rounds on its own (__dmul_rn, __dadd_rn,
// __dsub_rn are never contracted into an fma), as eager PyTorch rounds
// each operation; exp and the divisions are compiled as in PyTorch's
// kernels (nvcc's default flags).
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
// x / c for a tensor x and a Python number c, as PyTorch computes it on
// the card: x times the reciprocal of c (in double; constant here)
__device__ __forceinline__ double divs(double x, double c) {
  return __dmul_rn(x, 1.0 / c);
}

// One item: e = exp(-(x + d) * r), then num / den in the item's form
// (0: c*(x+d) / ((1 - e) + 1e-12), 1: c*e / 1.0, 2: 1.0 / (1 + e)).  The
// selects keep the code uniform across lanes whose items differ.
__device__ __forceinline__ double item_value(double x, double d, double r,
                                             double c, int form) {
  const double xd = add(x, d);
  const double e = exp(mul(-xd, r));
  const double num = form == 0 ? mul(c, xd) : (form == 1 ? mul(c, e) : 1.0);
  const double den = form == 0 ? add(sub(1.0, e), 1e-12)
                               : (form == 2 ? add(1.0, e) : 1.0);
  return num / den;
}

// item -> (d, r, c, form): a_m, b_m, a_h, b_h, a_n, b_n, the sigmoid; an
// index past the items (a lane with fewer items than its slots) takes
// item 0's constants, and its value is never read
__device__ __forceinline__ void item_constants(int q, double& d, double& r,
                                               double& c, int& form) {
  d = q == 3 ? 35.0 : q == 4 ? 55.0 : q == HH_SIG ? 0.0
      : (q == 1 || q == 2 || q == 5) ? 65.0 : 40.0;
  r = q == 1 ? 1.0 / 18.0 : q == 2 ? 1.0 / 20.0 : q == 5 ? 1.0 / 80.0
      : q == HH_SIG ? 1.0 / 2.0 : 1.0 / 10.0;
  c = q == 1 ? 4.0 : q == 2 ? 0.07 : q == 4 ? 0.01 : q == 5 ? 0.125
      : (q == 3 || q == HH_SIG) ? 0.0 : 0.1;
  form = (q == 1 || q == 2 || q == 5) ? 1 : (q == 3 || q == HH_SIG) ? 2 : 0;
}

// a lane's items: slot k holds item j + k * LANES (j the lane of the sample)
template <int LANES>
struct Items {
  static constexpr int SLOTS = (HH_ITEMS + LANES - 1) / LANES;
  double d[SLOTS], r[SLOTS], c[SLOTS];
  int form[SLOTS];
  __device__ __forceinline__ explicit Items(int j) {
#pragma unroll
    for (int k = 0; k < SLOTS; ++k)
      item_constants(j + k * LANES, d[k], r[k], c[k], form[k]);
  }
};

// item q's value, from the lane that computed it (slot q / LANES of lane
// q % LANES of the sample's lanes)
template <int LANES>
__device__ __forceinline__ double gather(const double* val, int q) {
  if constexpr (LANES == 1) {
    return val[q];
  } else {
    return __shfl_sync(0xffffffffu, val[q / LANES], q % LANES, LANES);
  }
}

// One right-hand side at state s.  FIRST: the step's first stage, which
// also computes the sigmoid of the output V of state s, x (s[0] for HH).
template <int KIND, int LANES, bool FIRST>
__device__ __forceinline__ void rhs(const double s[4], double x,
                                    const Items<LANES>& it, double I,
                                    double gNa, double gK, double k[4],
                                    double& sig) {
  constexpr int SLOTS = Items<LANES>::SLOTS;
  double val[SLOTS];
#pragma unroll
  for (int q = 0; q < SLOTS; ++q) {
    // rates for HH, the sigmoid at the first stage (FHN: that alone)
    const bool need = KIND == 2 ? (FIRST && q == HH_SIG / LANES)
                                : (FIRST || q * LANES < HH_SIG);
    if (need)
      val[q] = item_value(KIND == 2 ? x : s[0], it.d[q], it.r[q], it.c[q],
                          it.form[q]);
  }
  if (FIRST) sig = gather<LANES>(val, HH_SIG);
  if (KIND == 2) {
    const double a = 0.7, b = 0.8, tau = 12.5;
    const double v = s[0], w = s[1];
    k[0] = add(sub(sub(v, divs(mul(mul(v, v), v), 3.0)), w), divs(I, 10.0));
    k[1] = divs(sub(add(v, a), mul(b, w)), tau);
    return;
  }
  const double gL = 0.3, ENa = 50.0, EK = -77.0, EL = -54.387, Cm = 1.0;
  const double V = s[0], m = s[1], h = s[2], n = s[3];
  const double INa = mul(mul(mul(gNa, mul(mul(m, m), m)), h), sub(V, ENa));
  const double IK = mul(mul(gK, mul(mul(n, n), mul(n, n))), sub(V, EK));
  const double IL = mul(gL, sub(V, EL));
  const double a_m = gather<LANES>(val, 0), b_m = gather<LANES>(val, 1),
               a_h = gather<LANES>(val, 2), b_h = gather<LANES>(val, 3),
               a_n = gather<LANES>(val, 4), b_n = gather<LANES>(val, 5);
  k[0] = divs(sub(sub(sub(I, INa), IK), IL), Cm);
  k[1] = sub(mul(a_m, sub(1.0, m)), mul(b_m, m));
  k[2] = sub(mul(a_h, sub(1.0, h)), mul(b_h, h));
  k[3] = sub(mul(a_n, sub(1.0, n)), mul(b_n, n));
}

// one model for one sample on lane j of its LANES lanes: the integration
// and the five reductions (the same on every lane of the sample)
template <int KIND, int LANES>
__device__ __forceinline__ void integrate(const HHEntry& e, double I,
                                          double gNa, double gK, int j,
                                          double r[5]) {
  const int N = KIND == 2 ? 2 : 4;       // FHN's last two states stay 0
  const Items<LANES> it(j);
  double s[4];
  if (KIND == 2) {
    s[0] = -1.0; s[1] = 1.0; s[2] = 0.0; s[3] = 0.0;
  } else {
    s[0] = -65.0; s[1] = 0.0529; s[2] = 0.5961; s[3] = 0.3177;
  }
  const double dt = e.dt, hdt = e.hdt, c6 = e.c6;
  double sum_v = 0.0, sum_sig = 0.0, sum_n = 0.0, v_max = -INFINITY;
  double v_out = -65.0;                 // the output V of the last state
#pragma unroll 1
  for (int t = 0; t < e.n_steps; ++t) {
    double k[4], sig;
    if (KIND == 1) {                      // Euler
      rhs<KIND, LANES, true>(s, v_out, it, I, gNa, gK, k, sig);
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] = add(s[c], mul(dt, k[c]));
    } else {                              // RK4: k1 + 2 k2 + 2 k3 + k4 summed
      double acc[4], u[4];                // left to right as each stage ends
      rhs<KIND, LANES, true>(s, v_out, it, I, gNa, gK, k, sig);
#pragma unroll
      for (int c = 0; c < N; ++c) {
        acc[c] = k[c];
        u[c] = add(s[c], mul(hdt, k[c]));
      }
      rhs<KIND, LANES, false>(u, v_out, it, I, gNa, gK, k, sig);
#pragma unroll
      for (int c = 0; c < N; ++c) {
        acc[c] = add(acc[c], mul(2.0, k[c]));
        u[c] = add(s[c], mul(hdt, k[c]));
      }
      rhs<KIND, LANES, false>(u, v_out, it, I, gNa, gK, k, sig);
#pragma unroll
      for (int c = 0; c < N; ++c) {
        acc[c] = add(acc[c], mul(2.0, k[c]));
        u[c] = add(s[c], mul(dt, k[c]));
      }
      rhs<KIND, LANES, false>(u, v_out, it, I, gNa, gK, k, sig);
#pragma unroll
      for (int c = 0; c < N; ++c)
        s[c] = add(s[c], mul(c6, add(acc[c], k[c])));
    }
    // sig is the sigmoid of the state before this step: step t's output
    if (t > 0) sum_sig = add(sum_sig, sig);
    double n_gate;
    if (KIND == 2) {                      // FHN in HH-like units
      v_out = add(-65.0, mul(40.0, add(s[0], 1.0)));
      n_gate = add(0.3177, mul(0.1, s[1]));
    } else {
      v_out = s[0];
      n_gate = s[3];
    }
    sum_v = add(sum_v, v_out);
    v_max = (v_out > v_max || v_out != v_out) ? v_out : v_max;  // NaN sticks
    sum_n = add(sum_n, n_gate);
  }
  // the last state's sigmoid
  sum_sig = add(sum_sig, item_value(v_out, 0.0, 1.0 / 2.0, 0.0, 2));
  r[0] = mul(sum_v, e.inv_steps);
  r[1] = v_out;
  r[2] = v_max;
  r[3] = mul(sum_sig, e.inv_steps);
  r[4] = mul(sum_n, e.inv_steps);
}

template <int LANES>
__global__ void __launch_bounds__(HH_THREADS, HH_MIN_BLOCKS)
hh_kernel(const double* __restrict__ params, double* __restrict__ out,
          int n, int L, HHTable table) {
  const HHEntry e = table.e[blockIdx.y];
  const int t = blockIdx.x * HH_THREADS + threadIdx.x;
  if (t - (threadIdx.x & 31) >= n * LANES) return;   // the warp is past n
  const int i = t / LANES, j = LANES == 1 ? 0 : t % LANES;
  const int src = i < n ? i : n - 1;
  const double I = params[3 * src], gNa = params[3 * src + 1],
               gK = params[3 * src + 2];
  double r[5];
  if (e.kind == 0) integrate<0, LANES>(e, I, gNa, gK, j, r);
  else if (e.kind == 1) integrate<1, LANES>(e, I, gNa, gK, j, r);
  else integrate<2, LANES>(e, I, gNa, gK, j, r);
  if (i >= n || j != 0) return;
  double* o = out + (5 * i) * L + e.col;
#pragma unroll
  for (int q = 0; q < 5; ++q) o[q * L] = r[q];
}

extern "C" int bluest_hh_max_models() { return HH_MAX_MODELS; }

// One launch for `count` (<= HH_MAX_MODELS) models on the stream, with
// `lanes` (1 or 8) lanes a sample.  ints holds (kind, n_steps, col)
// per model, reals (dt, 0.5*dt, dt/6.0, 1.0/n_steps) per model, both on
// the host, in the order the blocks are to start.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take (the wrapper checks them first).
extern "C" int bluest_hh_outputs_f64(const double* params, double* out,
                                     int n, int L, int count,
                                     const int* ints, const double* reals,
                                     int lanes, void* stream) {
  if (n < 1 || L < 1 || count < 1 || count > HH_MAX_MODELS
      || (lanes != 1 && lanes != 8)
      || (long long)n * lanes + HH_THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  HHTable table;
  for (int j = 0; j < count; ++j) {
    HHEntry& e = table.e[j];
    e.kind = ints[3 * j];
    e.n_steps = ints[3 * j + 1];
    e.col = ints[3 * j + 2];
    e.dt = reals[4 * j];
    e.hdt = reals[4 * j + 1];
    e.c6 = reals[4 * j + 2];
    e.inv_steps = reals[4 * j + 3];
    if (e.kind < 0 || e.kind > 2 || e.n_steps < 1 || e.col < 0
        || e.col >= L)
      return (int)cudaErrorInvalidValue;
  }
  for (int j = count; j < HH_MAX_MODELS; ++j) table.e[j] = table.e[0];
  dim3 grid((unsigned)(((long long)n * lanes + HH_THREADS - 1) / HH_THREADS),
            count);
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes == 1)
    hh_kernel<1><<<grid, HH_THREADS, 0, s>>>(params, out, n, L, table);
  else
    hh_kernel<8><<<grid, HH_THREADS, 0, s>>>(params, out, n, L, table);
  return (int)cudaGetLastError();
}
