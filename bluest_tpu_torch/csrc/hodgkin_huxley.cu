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
// Layout: one thread per (sample, model).  blockIdx.y is the entry of the
// table, so kind, dt and the step count are uniform in a block and no
// warp diverges on them; the host orders the table longest model first,
// and blocks are dispatched in order of their linear index, so the
// longest models start first.  The state (4), the parameters (3), the
// RK4 stages and the five running reductions stay in registers.  The
// parameters are read once and the outputs written once.  No shared
// memory and no tensor cores: a sample's steps are one serial chain,
// samples share nothing, and there is no product to give the tensor
// cores.  The loop over steps is not unrolled.
//
// Bound: FP64 throughput outside the tensor cores (34 TFLOP/s on the H100
// SXM data sheet).  Bytes are negligible: 24 bytes of parameters per
// sample and 40 bytes of outputs per (sample, model).  chip_smoke.py
// (k2_work) counts the operations of this source, each add, subtract,
// multiply, divide, exp, pow and compare as one (a sign flip and a
// loop-invariant product not counted): 56 per HH right-hand side, 284
// per HH RK4 step with the reductions, 72 per Euler step, 79 per FHN
// step.  It is a lower bound: exp, pow and a division each take many
// FP64 instructions.
//
// Arithmetic: the plain version's operations one by one, each rounded on
// its own as eager PyTorch rounds them (mul/add/sub below: no a*b+c is
// contracted into an fma).  exp and pow are CUDA's, compiled with nvcc's
// default flags as PyTorch's kernels are (-fmad=false would compile them
// otherwise).  PyTorch on the card divides a tensor by a Python number as
// a multiply by the number's reciprocal (taken in double): divs() below.
// m ** 3 is m*m*m (PyTorch's special case of the cube), n ** 4 is
// pow(n, 4.0), 1.0 / x a true division.

#include <cuda_runtime.h>
#include <math.h>

#define HH_MAX_MODELS 32
#define HH_THREADS 64

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
// each operation; exp, pow and the divisions are compiled as in PyTorch's
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

__device__ __forceinline__ void hh_rhs(double V, double m, double h,
                                       double n, double I, double gNa,
                                       double gK, double d[4]) {
  const double gL = 0.3, ENa = 50.0, EK = -77.0, EL = -54.387, Cm = 1.0;
  const double v40 = add(V, 40.0), v65 = add(V, 65.0), v35 = add(V, 35.0),
               v55 = add(V, 55.0);
  const double a_m = mul(0.1, v40)
      / add(sub(1.0, exp(divs(-v40, 10.0))), 1e-12);
  const double b_m = mul(4.0, exp(divs(-v65, 18.0)));
  const double a_h = mul(0.07, exp(divs(-v65, 20.0)));
  const double b_h = 1.0 / add(1.0, exp(divs(-v35, 10.0)));
  const double a_n = mul(0.01, v55)
      / add(sub(1.0, exp(divs(-v55, 10.0))), 1e-12);
  const double b_n = mul(0.125, exp(divs(-v65, 80.0)));

  const double INa = mul(mul(mul(gNa, mul(mul(m, m), m)), h), sub(V, ENa));
  const double IK = mul(mul(gK, pow(n, 4.0)), sub(V, EK));
  const double IL = mul(gL, sub(V, EL));
  d[0] = divs(sub(sub(sub(I, INa), IK), IL), Cm);
  d[1] = sub(mul(a_m, sub(1.0, m)), mul(b_m, m));
  d[2] = sub(mul(a_h, sub(1.0, h)), mul(b_h, h));
  d[3] = sub(mul(a_n, sub(1.0, n)), mul(b_n, n));
}

__device__ __forceinline__ void fhn_rhs(double v, double w, double I,
                                        double d[2]) {
  const double a = 0.7, b = 0.8, tau = 12.5;
  d[0] = add(sub(sub(v, divs(mul(mul(v, v), v), 3.0)), w), divs(I, 10.0));
  d[1] = divs(sub(add(v, a), mul(b, w)), tau);
}

// one model for one sample: the integration and the five reductions
template <int KIND>
__device__ __forceinline__ void integrate(const HHEntry& e, double I,
                                          double gNa, double gK,
                                          double r[5]) {
  const int N = KIND == 2 ? 2 : 4;       // FHN's last two states stay 0
  double s[4];
  if (KIND == 2) {
    s[0] = -1.0; s[1] = 1.0; s[2] = 0.0; s[3] = 0.0;
  } else {
    s[0] = -65.0; s[1] = 0.0529; s[2] = 0.5961; s[3] = 0.3177;
  }
  const double dt = e.dt, hdt = e.hdt, c6 = e.c6;
  double sum_v = 0.0, sum_sig = 0.0, sum_n = 0.0, v_max = -INFINITY;
  double v_out = 0.0;
#pragma unroll 1
  for (int t = 0; t < e.n_steps; ++t) {
    if (KIND == 1) {                      // Euler
      double k[4];
      hh_rhs(s[0], s[1], s[2], s[3], I, gNa, gK, k);
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] = add(s[c], mul(dt, k[c]));
    } else {                              // RK4
      double k1[4], k2[4], k3[4], k4[4], u[4];
      if (KIND == 0) hh_rhs(s[0], s[1], s[2], s[3], I, gNa, gK, k1);
      else fhn_rhs(s[0], s[1], I, k1);
#pragma unroll
      for (int c = 0; c < N; ++c) u[c] = add(s[c], mul(hdt, k1[c]));
      if (KIND == 0) hh_rhs(u[0], u[1], u[2], u[3], I, gNa, gK, k2);
      else fhn_rhs(u[0], u[1], I, k2);
#pragma unroll
      for (int c = 0; c < N; ++c) u[c] = add(s[c], mul(hdt, k2[c]));
      if (KIND == 0) hh_rhs(u[0], u[1], u[2], u[3], I, gNa, gK, k3);
      else fhn_rhs(u[0], u[1], I, k3);
#pragma unroll
      for (int c = 0; c < N; ++c) u[c] = add(s[c], mul(dt, k3[c]));
      if (KIND == 0) hh_rhs(u[0], u[1], u[2], u[3], I, gNa, gK, k4);
      else fhn_rhs(u[0], u[1], I, k4);
#pragma unroll
      for (int c = 0; c < N; ++c)
        s[c] = add(s[c], mul(c6, add(add(add(k1[c], mul(2.0, k2[c])),
                                         mul(2.0, k3[c])), k4[c])));
    }
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
    sum_sig = add(sum_sig, 1.0 / add(1.0, exp(-divs(sub(v_out, 0.0), 2.0))));
    sum_n = add(sum_n, n_gate);
  }
  r[0] = mul(sum_v, e.inv_steps);
  r[1] = v_out;
  r[2] = v_max;
  r[3] = mul(sum_sig, e.inv_steps);
  r[4] = mul(sum_n, e.inv_steps);
}

__global__ void __launch_bounds__(HH_THREADS)
hh_kernel(const double* __restrict__ params, double* __restrict__ out,
          int n, int L, HHTable table) {
  const HHEntry e = table.e[blockIdx.y];
  const int i = blockIdx.x * HH_THREADS + threadIdx.x;
  if (i >= n) return;
  const double I = params[3 * i], gNa = params[3 * i + 1],
               gK = params[3 * i + 2];
  double r[5];
  if (e.kind == 0) integrate<0>(e, I, gNa, gK, r);
  else if (e.kind == 1) integrate<1>(e, I, gNa, gK, r);
  else integrate<2>(e, I, gNa, gK, r);
  double* o = out + (5 * i) * L + e.col;
#pragma unroll
  for (int q = 0; q < 5; ++q) o[q * L] = r[q];
}

extern "C" int bluest_hh_max_models() { return HH_MAX_MODELS; }

// One launch for `count` (<= HH_MAX_MODELS) models on the stream.  ints
// holds (kind, n_steps, col) per model, reals (dt, 0.5*dt, dt/6.0,
// 1.0/n_steps) per model, both on the host, in the order the blocks are
// to start.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it does not take (the wrapper
// checks them first).
extern "C" int bluest_hh_outputs_f64(const double* params, double* out,
                                     int n, int L, int count,
                                     const int* ints, const double* reals,
                                     void* stream) {
  if (n < 1 || L < 1 || count < 1 || count > HH_MAX_MODELS)
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
  dim3 grid((n + HH_THREADS - 1) / HH_THREADS, count);
  hh_kernel<<<grid, HH_THREADS, 0, (cudaStream_t)stream>>>(params, out, n,
                                                            L, table);
  return (int)cudaGetLastError();
}
