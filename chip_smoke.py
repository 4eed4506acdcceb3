#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. device: require a CUDA card; print its name and power limit;
  2. build K1 and its wide tier (bluest_tpu_torch/csrc/diffusion.cu),
     K2 (bluest_tpu_torch/csrc/hodgkin_huxley.cu), K2's step probes
     (a cubin for the SASS counts) and K3/K4
     (bluest_tpu_torch/csrc/psd_eig.cu) and K6
     (bluest_tpu_torch/csrc/combine.cu) with nvcc, one process each, in
     parallel; print each kernel's registers and spills;
  3. hold K1 against its plain PyTorch version on the card, for
     n in {1, 2, 3, 8, 33, 64, 100, 256, 1024}, B in {1, 77, 8192} and
     every grid and chunk size of the flagship and of the diffusion
     example (phase 9(a): n 256/64/16/4, B 4096), all at 32 modes, and
     at phase 10's K1 grids (1024 ... 8) with its 1024 modes and B in
     {1, 77, 4096, 8192}, f32 and f64: each launch counted for K1,
     bit-equal in each dtype, f64 within 1e-10 and f32 within
     the f32 error class of the f64 plain version; time both at the
     flagship shape (n=1024, B=8192, f32) beside K1's bound, then K1 on
     every flagship grid, over B at n=1024, and in f64; then the wide
     tier (the two-stage kernel pair for every shape K1 has no tile for)
     for n in {1026, 1500, 2048, 4096, 4097, 8192, 16385}, n_kl in
     {32, 1024}, B in {1, 77, 8192} (at most 1024 past 4097 cells), at
     n=40000 (32 modes, B 1 and 77: past the rows a lane keeps in
     registers), phase 10's pilot (B 4096 at n 4096 and 2048, 1024
     modes), and n=1024 with n_kl=3000, both dtypes, each launch counted
     for the wide tier and held stage by stage (wide_stages_hold): stage
     1 bit-equal to synthesize_plain in f32 and within the bound of a sum
     taken in any order in f64 (its tensor cores sum in their own order),
     stage 2 bit-equal to solve_plain on stage 1's a in both dtypes, the
     call equal to its stages, f32 end to end bit-equal to the plain
     version and f64's max and median relative difference printed; its
     time at n=4096 and 2048, n_kl=1024, and n=4096, n_kl=32, B=8192,
     in both dtypes beside its bound (K1's, the same function), each
     stage's time,
     torch.matmul's for stage 1's product alone (TF32 off) and its slab
     buffer's bytes, and the plain version's time beside it at n=4096 in
     f64; last, both tiers timed in turns at shapes tier() gives K1
     (n=1024 with 32 and 1024 modes in both dtypes, n=512 and 256 with
     1024 modes in f64, B=8192), the wide tier launched by name
     (ops.diffusion.launch); then K2 against its plain version
     (ops.hodgkin_huxley.hh_group_outputs_plain) on the same parameters:
     each of the 12 default models alone and the 12-model group, at n in
     {1, 77, 256, 16384, 65536}, in each variant (lanes a sample) and as
     launch_plan picks, each launch counted and by variant: the same
     (row, model) pairs non-finite, each model's normwise relative
     difference <= 1e-10 on the rest, and every entry bit-equal
     (k2_holds); the SASS instructions of one step of each kind and
     variant by class (cuobjdump of step probes, sass_step_counts), FP64
     apart; each variant's time at model 0 and the group for n in
     K2_SWEEP_N with its FP64 issue share (FP64 instructions over 132 SMs
     x 64 lanes x the SM clock that nvidia-smi reads meanwhile x the
     time); K2's time at n=16384 for model 0 and for the group beside
     its bound (FP64 operations, k2_work) and the plain version's time,
     in turns (plain, kernel, kernel, plain); then K3 and K4 (the IPM's
     Jacobi eigenvalue and SVD kernels) against their plain versions
     (torch.linalg.eigvalsh and svd) on a host copy of the inputs and on
     the card (k3_holds, k4_holds: 32 n eps ||A||_F, orthogonality and
     the reconstruction M M^T; cuSOLVER only at unit scale, where it is
     accurate) at n in PSD_CHECK_N and B in PSD_CHECK_B, each launch
     counted, a NaN block flagged, the host wall of each kernel's first
     call in the process; each timed at the IPM's batches and at 1024
     blocks beside its bound (Golub and Van Loan's flop counts over the
     FP64 rate) and the blocks' mean and largest sweeps: eager in turns
     with the plain version and the torch.linalg call (and an earlier
     design, below), and as 100 calls in one CUDA graph, as the IPM runs
     them, beside an empty kernel's (the launch floor), with the cycles a
     Jacobi round at the SM clock nvidia-smi reads; then K5 (the
     allocation's Jacobi eigh, K3 with its rotations accumulated:
     sym_eigh and pinv00) against its plain versions (torch.linalg.eigh,
     and for pinv00 its cutoff and sum) on a host copy at every scale and
     on the card at unit scale (k5_eigh_holds, k5_pinv_holds: sym_eigh's
     eigenvalues K3's bit for bit and within 32 n eps ||A||_F, ||V^T V -
     I||_F <= 32 n eps, ||V diag(w) V^T - A||_F <= 64 n eps ||A||_F;
     pinv00 within 64 n eps kappa sum|v0^2/w|) at n in K5_CHECK_N and B
     in K5_CHECK_B (B n^2 <= K5_CHECK_MAX), each launch counted, a NaN
     block flagged, cuSOLVER's eigh against LAPACK printed, the first
     call's host wall; each timed at K5_TIMED beside its bound, eager in
     turns with the plain version and torch.linalg.eigh and as calls in
     one CUDA graph beside the launch floor, with sweeps a block and
     cycles a round; then K6 (the sampling combiner) against its plain
     version (sampling.engine.combine_plain) on the card, in the group
     engine's strided layout and the factored engine's stacked one, f32
     and f64, k in {1, 2, 3, 5, 12}, d in {1, 3}, rows in {1, 77, 3001}
     with NaN, inf and past-N rows (phase_k6_check: 1e-12 of each sum's
     largest entry, n_failed exact, each launch counted), the flagship's
     chunks (the stacked layout, 1 to K models, its outputs, BATCH rows,
     f32 and f64), the cell's chunk shapes (k, No) = (1, 5), (3, 5),
     (12, 5) at 262,144 rows (two calls bit-equal, the running sums in
     place equal to add_sums of the chunks'), each timed there beside its
     bound (bytes at 3.35 TB/s) and the plain version's time, in turns
     (plain, K6, K6, plain); K6's launches are counted by phase (4 to 11)
     for the kernel line;
  4. drive the flagship end to end on the default device (the card):
     pilot (4096 samples) + SPD projection, setup_solver(K=4) with the
     budget calibrated to ~1e6 samples (K3's, K4's and K5's launches
     counted from 0 just before and read just after: the kernel line's
     "flagship_alloc"), split (setup_probes) into psi assembly, the IPM
     (its graph captures apart), the cleanup walk, the integer projection
     and the rest, with the host wall of the first and later calls of
     K3/K4, cholesky_ex and solve_triangular, then the same calibrated
     set-up again (a fresh MOSAP, the warm cache emptied) split the same
     way, the steady set-up beside the process's first; solve() (all
     groups dispatched,
     then one fetch of their sums); check the certificate, the estimates
     and that the model evaluations went through K1; then the same
     allocation seven times through solve(), through its fetch alone
     (_pipelined_sumse: no estimator assembly) and through a loop of
     blue_fn calls (the per-group path), in turns: the median and spread
     of each, and the two paths' sums bit-equal from the same call
     counters (two problems loaded from the saved graph);
  5. target RMSE on the same problem, at eps* = the largest error of
     phase 4's integer budget solve: setup_solver(K=4, eps=eps*) (cost
     within 2% of phase 4's, tolerance met, no NLP fallback; K3/K4/K5
     launches counted: the kernel line's "eps_star_alloc"), then
     MLBLUE, MC, MLMC and MFMC at eps* -- each estimate checked against
     its error bar and against MLBLUE's, each path's model evaluations
     counted through K1 -- then complexity_test([2 eps*, eps*, eps*/2])
     (rate in [1.9, 2.1]) and variance_test(eps=2 eps*, N=20)
     (err/err_ex in [0.5, 1.6]).  Every estimator draws from the seed and
     call counter the entry points give it.  MC runs twice: on the f32
     problem, measured and not gated (the f32 model at n=1024 breaks down
     on rare draws, which ~2.5e5 draws of the finest model meet often:
     a line gives its estimate, how many of its draws' q_energy values
     are off the f64 model's on the same inputs, and the f64 mean of
     those draws, which is gated), and on the f64 problem at the same
     width through K1's f64 instantiation, which carries MC's gates;
  6. user models on the card, each part timed:
     (a) Matern 2D at its default grids (64, 32, 16, 8), f64: 4096-sample
         pilot, setup_solver(K=4, eps) and solve(); the card's outputs
         against the CPU's on the same white noise (<= 1e-12 relative) and
         the estimates against a 2^17-sample MC estimate of model 0;
     (b) Hodgkin-Huxley, all 12 models and 5 outputs, through the
         coupled-group engine (chunks of 16384 samples): pilot,
         setup_solver(K=3, budget) and solve(), K2's count set to 0 just
         before the pilot and read just after the solve (launches equal
         to the group evaluations: the kernel line's "hh_group_engine",
         by variant), each launch's models, n and variant logged;
         K2 on the allocation's active groups against the plain version
         on the K2 check's inputs, in every variant; the finest model's
         device items per
         evaluation (torch.profiler) for the plain version and for
         hh_outputs (K2: at most 4); the card's outputs against the
         CPU's on the same parameters (<= 1e-8 relative, the CPU parity
         tests' tolerance) and the estimates against an MC estimate of
         model 0; hh_pilot_s, hh_solve_s and hh_mc_s printed, the first
         two beside the one-lane pow design's (HH_WALLS_ONE_LANE_POW);
     (c) snapshots through K1: the flagship problem with a samplefile and
         outputs_to_save=[0], solve(K=2) at a small budget; every group
         file holds as many rows as the samples its sums cover, K1 on
         stored inputs gives the stored outputs bit for bit, and K1's
         launches in the solve are the kernel line's "snapshots" path;
     (d) a black-box numpy model with an inf sentinel (models 0 and 1
         never coupled), host_workers=2: the masked SPG projection
         converges through K5's sym_eigh (its launches counted: the
         kernel line's "masked_spg"), no group of setup_solver(K=3, eps) holds 0 and 1, and
         solve_mc is within 4 error bars of exp(0.5);
  7. the allocation's solver families (in f64 on the problems' device,
     the card, as every allocation of phases 4-10 is; the scipy NLP and
     the SPG family's Dykstra projection on the host; the sampling that
     follows on the card):
     (a) on phase 6(a)'s Matern problem, setup_solver(K=4, eps, solver=s,
         continuous_relaxation=True) for s in sdp, admm, spg, scipy: every
         tolerance met, ADMM and scipy costs within 1e-3 of the IPM's,
         SPG within 10%, no NLP fallback; the Newton polish of the IPM
         point (solver_params={"polish": True}) and of the ADMM point:
         stationarity <= 1e-9 and the two polished costs within 1e-8; the
         integer ADMM allocation sampled on the card, within 4 error bars
         of phase 6(a)'s MC reference.  ADMM's set-up runs once, through
         setup_solver with the polish and the integer projection, at
         most 20,000 iterations a cone program (its epigraph
         cross-check never converges): the point it hands to the polish
         serves the cost comparison.  The cap is a depth cut: users get
         ADMM's 60,000, which takes ~6 minutes on the card (ROADMAP
         queue 2);
     (b) on phase 4's problem, two rebuilds of the budget allocation, the
         IPM's warm-start cache emptied before the first: the second
         starts warm, takes fewer iterations and gives the same
         continuous cost; the polished allocation at eps* sampled through
         K1 (the kernel line's "mlblue_polished" launches), estimates
         within 4 error bars of phase 4's; solver="spg" at phase 4's
         budget: feasible, its max-variance over the IPM's logged.
  8. distribution, on the one card (problems loaded from phase 4's saved
     graph, so no pilot is paid again):
     (a) a world of one rank, backend nccl, mesh=sample_mesh(): the
         flagship allocation and solve through the mesh path; the sums
         equal the mesh-less sums bit for bit, K1's launches equal the
         chunk evaluations, one all_reduce and one copy per fetch;
     (b) two ranks spawned with torch.multiprocessing, both on the one
         card, backend gloo named explicitly (NCCL refuses two ranks on
         one device; the reduced tensor is a few kilobytes, so its host
         copy is reduced): the flagship allocation (rank 0's, broadcast)
         and solve; the sums equal the one-process sums to 1e-12
         relative, the ranks' K1 launches add up to the one-process
         count; then phase 6(c)'s snapshot solve under the two ranks: the
         files, written by rank 0 alone, hold the one-process rows.  K1
         was built in phase 2, so the ranks load it.  A rank that fails
         fails the run.
     The model axis needs a card per rank for NCCL and is not run here.
  9. the user's front door on the card: each script of examples/torch/
     and tutorials/01_tutorial_torch.py through its main([...]) in this
     process, on its default device (the card), each part timed, its
     printed output kept under build/chip_smoke/phase9/ and its last
     lines echoed:
     (a) single_output_diffusion --tests: the MLBLUE estimate within 4
         error bars of a 2^20-sample MC estimate of model 0 through K1,
         complexity rate in [1.9, 2.1], variance_test ratio in [0.5, 1.6],
         and K1's launches in the run equal to its chunk evaluations (at
         the example's own device_batch_size): the kernel line's
         "example_diffusion" launches;
     (b) matern_restrictions: every allocation of the sweep meets its
         eps, and the estimate is finite with a positive error;
     (c) multi_output_hodgkin_huxley as it ships (the 6-model subset,
         a pilot of 1024) and with --full (the paper's 12 models), each
         with K2's count set to 0 just before and read just after: K2's
         launches equal to the run's group evaluations (the kernel
         line's "hh_example" and "hh_example_full", by variant), every
         estimate and
         error finite, output 0 within 4 error bars of an MC estimate of
         its model 0 on the card;
     (d) navier_stokes_study, its NS_NPZ pointed at a 12-model, 6-output
         graph that the phase writes (write_ns_graph): MLBLUE's offline
         cost at most MFMC's and MLMC's, and the surrogate's estimates
         within 5 predicted RMSEs of their known means;
     (e) nested_blackbox_parallel: the covariance diagonals of the nested
         pools and of the one-process evaluations agree to the printed
         5 decimals;
     (f) the tutorial ends with "Tutorial completed.".
 10. the deep-grid flagship on the default device: DiffusionProblem with
     grids 4096..8 (10 models), 1024 KL modes, sigma 1.0, nu 0.6, three
     outputs, f64, chunks of 8192, a 4096-sample pilot, setup_solver(K=4)
     with the budget calibrated to ~1e6 samples as in phase 4 (L=385,
     certificate checked) and solve(), the counts set to 0 just before
     the pilot and read just after the solve: models 0 and 1 through the
     wide tier, models 2-9 through K1, each tier's launches equal to its
     chunk evaluations; five more solves timed (median, min, max); max_rel_err
     < 0.01, MLBLUE's q_int within 4 error bars of a 2^17-draw f64 MC of
     model 0 through the wide tier, and that MC's q_energy = q_int;
 11. the allocation on the card against the host, on problems loaded
     from phase 4's saved graph and phase 6(b)'s HH pilot (no pilot
     paid again): (a) the flagship setup_solver(K=4, budget) at phase
     4's calibrated budget, (b) setup_solver(K=4, eps=eps*) at phase 5's
     eps*, (c) HH setup_solver(K=5, budget=2e5) (its L printed), each in
     turns eager, graph, host, host, graph, eager ("graph": the card's
     IPM as it runs, one CUDA-graph replay an iteration; "eager": its
     eager card loop, sdp._ipm_solve(..., loop="eager"); the host through
     BLUEST_TPU_ALLOC_DEVICE=cpu), every set-up cold (a fresh MOSAP, the
     warm cache emptied): per set-up the wall and its split (psi
     assembly, IPM, cleanup walk, integer projection, rest), the IPM's
     iterations and ms an iteration beside ipm_iteration_flops over the
     card's FP64 rate, each capture's host wall and K3's, K4's and K5's
     launches (the kernel line's "alloc_on_card" paths: the last graph
     turn's); gated graph against host: the same status for every cone
     solve, continuous cost within 1e-6 relative, max-variance within
     1e-3 relative, the budget or eps* met (whether the set-ups' integer
     samples are the same is printed: the IPMs stop at other points of a
     degenerate face, ROADMAP queue 3); gated on the card: K3, K4 and K5
     launched, no torch.linalg eigensolver called on a CUDA tensor; gated graph against eager:
     the same statuses, each cone solve's iterations and done code, its
     x bit-equal (or within 1e-12 relative, printed); then one more card
     set-up of each program under torch.cuda.set_sync_debug_mode("warn")
     with its graphs kept: the synchronisations an iteration in the
     replays, packed reads and step copies (gate: 1), those of the
     captures, the replays an iteration (gate: 1), each graph's nodes
     (cuGraphGetNodes), and the synchronising calls left by call site;
     then each program's integer search alone from the host set-up's
     continuous point (integer_search_gate): on the card and on the host
     (gated: the same samples; printed: the chosen max-variance gap and
     the card's wall; its synchronising calls are the listing's);
     (a)'s card allocation sampled through K1 (the kernel line's
     "mlblue_alloc_on_card" launches), estimates within 4 error bars of
     phase 4's; host reads an IPM iteration (<= 2) and aten operations
     an iteration, on the host; whether each torch.linalg call of the
     IPM and K3/K4 synchronise on the card, and their wall a call.
Each of phases 4-11 logs where its allocations ran (the device of every
MOSAP built and of every cone solve).
The second-to-last line is the kernel report as JSON, an entry for K1,
one for its wide tier, one for K2, one each for K3 and K4 and one each
for K5's sym_eigh and pinv00; the last line is {"ok": true, "device":
{...}}.

With --parent-source PATH (another csrc/diffusion.cu with the same C
interface to its wide tier, e.g. the previous commit's, written out
under build/: the copy the chip runs is no git checkout), phase 3 times
that wide tier in turns with this one (parent, new, new, parent) at its
timed shapes.  With --k2-parent-source PATH (another
csrc/hodgkin_huxley.cu with the one-lane C interface, e.g. the commit's
before the variants, written out under build/), phase 1 builds it and
its step probes beside the others, and the K2 check prints its SASS
counts and times it in turns with this K2 (parent, new, new, parent) at
K2_TURNS: model 0 at n=256 and 16384 and the group at 16384.  With
--k34-parent-source PATH (another csrc/psd_eig.cu with this one's C
interface to K3 and K4, e.g. the commit's before K5, written out under
build/), phase 1 builds it beside the others and the K3/K4 check times
its K3 and K4 in turns with this one (parent, new, new, parent), eager
and in a graph, at every K3_TIMED and K4_TIMED shape, and counts the
check shapes at which the two K3s give the same eigenvalues bit for
bit.  tools/integer_search_turns.py times phase 11's integer search in
turns with another integer.py.

With --profile, one more budget solve after phase 4 runs under
torch.profiler and a line gives K1's device time, the device's busy share
of the solve's wall and the largest device items; a further solve runs
under torch.cuda.set_sync_debug_mode("warn") and a line lists the
synchronising calls that are left, by call site (those of one
allocation are phase 11's, in every run).  It is the standing
source of PERF.md's busy-share metric (the sampling layer's), measured
again after every change to the sampling path or K1; the plain run
leaves it out, so the profiler's cost never enters its other numbers.
"""

import contextlib
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

GRIDS = (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2)
N_KL = 32
SIGMA = 1.0
NU = 0.6
K = 4
PILOT = 4096
BATCH = 8192
TARGET_SAMPLES = 1_000_000
CHECK_GRIDS = (1, 2, 3, 8, 33, 64, 100, 256, 1024)
CHECK_BATCHES = (1, 77, 8192)
B_SWEEP = (1024, 8192, 65536, 262144)
# the card's best dense rates by item size, NVIDIA H100 SXM data sheet
# (700 W): for the mode synthesis product (FP32 outside the tensor cores,
# which keep only TF32 in f32; FP64 tensor cores in f64), for the rest
# (FP32, FP64), and HBM bandwidth
PRODUCT_FLOPS = {4: 67e12, 8: 67e12}
OTHER_FLOPS = {4: 67e12, 8: 34e12}
HBM_BYTES_PER_S = 3.35e12
EPS64 = 2.0 ** -52
K1_SOURCE = "bluest_tpu_torch/csrc/diffusion.cu"
K1_REPLACES = "bluest_tpu/ops/pallas_diffusion.py:151"
K2_SOURCE = "bluest_tpu_torch/csrc/hodgkin_huxley.cu"
K2_REPLACES = "bluest_tpu/models/hodgkin_huxley.py:88 (lax.scan, XLA)"
K34_SOURCE = "bluest_tpu_torch/csrc/psd_eig.cu"
K3_REPLACES = ("bluest_tpu/solvers/sdp.py:320 (eigvalsh in the IPM's "
               "lax.while_loop, XLA)")
K4_REPLACES = ("bluest_tpu/solvers/sdp.py:304 (svd in the IPM's "
               "lax.while_loop, XLA)")
K5_REPLACES = {
    "sym_eigh": ("bluest_tpu/core/psi.py:92, linalg/spd.py:27, "
                 "solvers/admm.py:244,371 (eigh, XLA)"),
    "pinv00": ("bluest_tpu/solvers/integer.py:93 (_chunk_var00's eigh, "
               "XLA)")}
# the K5 check: block sizes (the flagship's M=10 and M+1, HH's 12 and 13,
# a 32-model group's 33, 64 and 100 past the warp kernel and the shared
# tiles), batches (1 for the SPD clip and psi's variance, 3 and 77 odd,
# 1024, the corner search's 8192-corner chunk) while B n^2 <= K5_CHECK_MAX;
# the timed (n, B): the corner search's chunks at M=10 (flagship) and 12
# (HH), a short chunk, ADMM's and psi's single blocks
K5_CHECK_N = (1, 2, 5, 10, 11, 12, 13, 33, 64, 100)
K5_CHECK_B = (1, 3, 77, 1024, 8192)
K5_CHECK_MAX = 8192 * 13 * 13
K5_TIMED = ((10, 8192), (12, 8192), (10, 1024), (11, 1), (33, 1))
K5_RCOND = 1.0e-10          # the corner search's cutoff (integer._PINV_RCOND)
# the K3/K4 check: block sizes (n = M + 1: the flagship's 11, HH's 13 at
# K=5, a 32-model group's 33; 64 past K4's shared-memory tile and 100
# past K3's) and batches (nb, 2 nb, 4 nb of the IPM, and 1024)
PSD_CHECK_N = (2, 5, 11, 13, 33, 64, 100)
PSD_CHECK_B = (1, 3, 6, 12, 20, 1024)
# (name, n, batch) timed: the flagship's and HH's calls of an iteration
# (K3 at nb, 2 nb and 4 nb blocks, K4 at nb) and 1024 blocks
K3_TIMED = (("flagship", 11, 3), ("flagship", 11, 6), ("flagship", 11, 12),
            ("hh", 13, 5), ("hh", 13, 10), ("hh", 13, 20),
            ("1024", 11, 1024), ("1024", 13, 1024))
K4_TIMED = (("flagship", 11, 3), ("hh", 13, 5), ("1024", 11, 1024),
            ("1024", 13, 1024))
K6_SOURCE = "bluest_tpu_torch/csrc/combine.cu"
K6_REPLACES = ("bluest_tpu/sampling/kernel_engine.py:293 (_get_combiners' "
               "einsums, XLA)")
# the K6 check: models a group, output dimensions, rows (one, a ragged
# few, past a block's tile many times), both layouts, f32 and f64; the
# cell's chunk shapes (No = 5) at its chunk of 262,144 rows, also timed
K6_CHECK_K = (1, 2, 3, 5, 12)
K6_CHECK_D = (1, 3)
K6_CHECK_ROWS = (1, 77, 3001)
K6_TIMED = ((1, 5, 1), (3, 5, 1), (12, 5, 1))
K6_CHUNK = 262144
# and the flagship's chunks (phases 4, 5 and 10): the factored engine's
# stacked layout, groups of 1 to K models at BATCH rows, in f32 (the
# flagship) and f64 (the deep flagship); its outputs a row come from
# the model
K6_FLAGSHIP_K = tuple(range(1, K + 1))
# K2's check after phase 3: the batches (one redraw round of the group
# engine may draw 4 x 16384), and the batch it is timed at (phase 6(b)'s
# chunk)
K2_CHECK_N = (1, 77, 256, 16384, 65536)
K2_TIMED_N = 16384
# each variant timed at model 0 and the group over n (the host rule's
# ground), and the shapes timed in turns against an earlier design
K2_SWEEP_N = (256, 1024, 2048, 4096, 6144, 8192, 10240, 12288, 16384,
              32768, 65536)
K2_TURNS = (("model0", 256), ("model0", 16384), ("group", 16384))
# phase 6(b)'s walls with the one-lane pow design of K2 (NVIDIA H100 80GB
# HBM3, 700.00 W), printed beside this run's
HH_WALLS_ONE_LANE_POW = {"hh_pilot_s": 0.037, "hh_solve_s": 0.027}
# phase 3, K1's wide tier: the grids past K1's reach, the modes, the
# batches (at most WIDE_MAX_B past 4097 cells, the plain version's time),
# a shape K1 refuses for its n_kl, and the grids timed at N_KL_DEEP modes
WIDE_GRIDS = (1026, 1500, 2048, 4096, 4097, 8192, 16385)
WIDE_N_KL = (32, 1024)
WIDE_MAX_B = 1024
WIDE_K1_REFUSED = (1024, 3000)
# (n, n_kl) timed at B = BATCH: the deep flagship's wide grids at its
# modes, and n=4096 at 32 modes, where the synthesis is ~3% of the work
WIDE_TIMED = ((4096, 1024), (2048, 1024), (4096, 32))
# (n, n_kl, B) past 32769 cells, where a lane owns more than 32 rows
WIDE_PAST_REGS = ((40000, 32, 1), (40000, 32, 77))
# phase 10: the deep-grid flagship (f64), repeated solves, MC draws
DEEP_GRIDS = (4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8)
N_KL_DEEP = 1024
DEEP_REPS = 5
DEEP_MC = 1 << 17
# phase 6: user models
DEV = "cuda"
MATERN_PILOT = 4096
MATERN_EPS_REL = 0.01       # each output's eps: this x its sd
MATERN_MC = 1 << 17
MATERN_MC_CHUNK = 8192
# phase 6(b): a chunk of 16384 samples of the 12-model group is one K2
# launch
HH_BATCH = 16384
HH_PILOT = 16384
HH_BUDGET = 2.0e5           # in HH cost units (the cheapest model is 1)
HH_MC = 16384
SNAP_BUDGET = 2.0e4
HOST_PILOT = 1024
HOST_EPS = 0.02
# phase 4: repeated solves per path; phase 8: seconds a rank waits for
# another in a collective before it fails
PATH_REPS = 7
# phase 7(a)'s ADMM iteration cap: its direct form converges in ~15,000
# iterations on both devices, and its epigraph cross-check never converges
# (ROADMAP queue 3); at ADMM's default of 60,000 the two took 361 s with
# the allocation on an NVIDIA H100 80GB HBM3 (~4.8 ms an iteration, where
# the card's host CPU takes ~0.5)
ADMM_MAX_ITER = 20000
RANK_TIMEOUT_S = 180
# phase 9: the front door's scripts (by directory), MC references of model
# 0, the graph written for the Navier-Stokes study, lines echoed per part
FRONT_DOOR = {"single_output_diffusion": "examples/torch",
              "matern_restrictions": "examples/torch",
              "multi_output_hodgkin_huxley": "examples/torch",
              "navier_stokes_study": "examples/torch",
              "nested_blackbox_parallel": "examples/torch",
              "01_tutorial_torch": "tutorials"}
EX_DIFFUSION_MC = 1 << 20
EX_DIFFUSION_MC_CHUNK = 1 << 16
EX_HH_MC = 16384
NS_MODELS = 12
NS_OUTPUTS = 6
ECHO_LINES = 8


def log(*a):
    print(*a, flush=True)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card "
                           "only")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log("device:", name, "| count:", torch.cuda.device_count())
    log(smi)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])
    return name, smi


def phase_build(k2_parent_source=None, k34_parent_source=None):
    """Build every kernel source at once (one nvcc each, in parallel) and
    print nvcc's registers and spills for each kernel; with them, K2's
    step probes for the SASS counts and, given ``k2_parent_source`` or
    ``k34_parent_source``, that earlier K2 and its probes or that earlier
    K3/K4.  Returns {"sass": {design: counts}, "k2_parent": launcher or
    None, "k34_parent": launchers or None}."""
    from concurrent.futures import ThreadPoolExecutor
    from bluest_tpu_torch.ops import _build
    from bluest_tpu_torch.ops import combine as k6
    from bluest_tpu_torch.ops import diffusion as k1
    from bluest_tpu_torch.ops import hodgkin_huxley as k2
    from bluest_tpu_torch.ops import psd_eig as k34
    mods = (("K1", k1), ("K2", k2), ("K3/K4/K5", k34), ("K6", k6))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods) + 4) as pool:
        jobs = [pool.submit(mod.build_library) for _, mod in mods]
        probes = {"new": pool.submit(k2_probe_cubin, k2._SOURCE, False)}
        parent = psd_parent = None
        if k2_parent_source:
            parent = pool.submit(parent_k2, k2_parent_source)
            probes["parent"] = pool.submit(k2_probe_cubin, k2_parent_source,
                                           True)
        if k34_parent_source:
            psd_parent = pool.submit(parent_psd, k34_parent_source)
        for f in jobs:
            f.result()
        cubins = {d: f.result() for d, f in probes.items()}
        parent = parent.result() if parent else None
        psd_parent = psd_parent.result() if psd_parent else None
    dt = time.perf_counter() - t0
    log("K1, K2, K3/K4/K5 and K6 build, in parallel%s%s: %.2f s"
        % (" (with K2's step probes%s)"
           % (" and the parent K2" if parent else ""),
           " and the parent K3/K4" if psd_parent else "", dt))
    logs = [(name, mod.build_log) for name, mod in mods]
    if parent:
        logs.append(("K2 parent", _build.build_logs.get(
            _build.build(k2_parent_source, k2.NVCC_FLAGS), "")))
    for name, text in logs:
        for line in text.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry function" in line):
                log("  %s nvcc:" % name, line.strip())
    return {"sass": {d: sass_step_counts(c) for d, c in cubins.items()},
            "k2_parent": parent, "k34_parent": psd_parent}


def _time_ms(fn, reps):
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_work(n, n_kl, B, itemsize):
    """The least work of the function K1 computes, from its inputs: the
    mode synthesis product (2 n_kl - 1 flops per cell), then one exp per
    cell and Thomas's 17 flops per row with the QoIs fused (10 down, 7
    back); each input read once (xi, mck) and the output written once."""
    product = B * (2 * n_kl - 1) * n
    other = B * (n + 17 * (n - 1))
    nbytes = itemsize * (B * n_kl + n * n_kl + 3 * B)
    return product, other, nbytes


def k1_bound_ms(n, n_kl, B, dtype):
    """The least time the card could take for K1's work: the larger of
    the operations over the card's best rate for each (summed) and the
    bytes over HBM bandwidth (NVIDIA H100 SXM data sheet, 700 W)."""
    import torch
    itemsize = 4 if dtype == torch.float32 else 8
    product, other, nbytes = k1_work(n, n_kl, B, itemsize)
    t_ops = (product / PRODUCT_FLOPS[itemsize]
             + other / OTHER_FLOPS[itemsize]) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), product + other, nbytes


def _deep_cases(which):
    """Phase 10's (n, n_kl, B) for one tier: each DEEP_GRIDS grid that
    tier() gives `which` at N_KL_DEEP modes in f64 (and in f32: the
    caller checks it), B the pilot, the chunk and the edge sizes."""
    import torch
    from bluest_tpu_torch.ops.diffusion import tier
    batches = sorted(set(CHECK_BATCHES) | {PILOT, BATCH})
    return [(n, N_KL_DEEP, B) for n in DEEP_GRIDS
            if tier(n, N_KL_DEEP, torch.float64) == which for B in batches]


def phase_kernel_check():
    """K1 against the plain version on the same card and inputs, at every
    shape a main path gives K1, then K1's times (CUDA events after
    warm-up) at the main path's shapes."""
    import numpy as np
    import torch
    from bluest_tpu_torch.ops import diffusion as k1
    from bluest_tpu_torch.ops.diffusion import (diffusion_outputs,
                                                diffusion_outputs_plain)
    from bluest_tpu_torch.problem import default_params
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    worst = 0.0
    max_abs = {torch.float32: 0.0, torch.float64: 0.0}   # kernel vs plain
    # the edge cases, every grid and chunk size that a main path (the
    # flagship's, and the diffusion example's of phase 9) gives K1 at
    # N_KL modes, and phase 10's K1 grids at N_KL_DEEP modes
    example = _front_door_module("single_output_diffusion")
    grids = sorted(set(CHECK_GRIDS) | set(GRIDS) | set(example.GRIDS))
    batches = sorted(set(CHECK_BATCHES) | {
        BATCH, int(default_params["device_batch_size"])})
    deep = _deep_cases("k1")
    cases = [(n, N_KL, B) for n in grids for B in batches] + deep
    log("K1 check: n in %s, B in %s at n_kl %d; phase 10's K1 grids %s at "
        "n_kl %d, B in %s" % (grids, batches, N_KL,
                              sorted({c[0] for c in deep}), N_KL_DEEP,
                              sorted({c[2] for c in deep})))
    by_tier = k1.diffusion_outputs.launches_by_tier
    for n, n_kl, B in cases:
        xi64 = torch.as_tensor(rng.standard_normal((B, n_kl)),
                               dtype=torch.float64, device=dev)
        xi32 = xi64.to(torch.float32)
        if {k1.tier(n, n_kl, x.dtype) for x in (xi64, xi32)} != {"k1"}:
            raise AssertionError("n=%d n_kl=%d is not K1's" % (n, n_kl))
        before = by_tier["k1"]
        got64 = diffusion_outputs(xi64, n, SIGMA, NU)
        got32 = diffusion_outputs(xi32, n, SIGMA, NU)
        torch.cuda.synchronize()
        if by_tier["k1"] != before + 2:
            raise AssertionError("K1 did not launch at n=%d n_kl=%d"
                                 % (n, n_kl))
        ref64 = diffusion_outputs_plain(xi64, n, SIGMA, NU)
        pl32 = diffusion_outputs_plain(xi32, n, SIGMA, NU)
        r = ref64.cpu().numpy()
        denom = np.abs(r) + 1e-9
        e64 = np.abs(got64.cpu().numpy() - r) / denom
        e32 = np.abs(got32.double().cpu().numpy() - r) / denom
        eref = np.abs(pl32.double().cpu().numpy() - r) / denom
        if got64.shape != (B, 3) or got32.shape != (B, 3):
            raise AssertionError("K1 output shape at n=%d n_kl=%d B=%d"
                                 % (n, n_kl, B))
        if not (np.isfinite(got64.cpu().numpy()).all()
                and np.isfinite(got32.cpu().numpy()).all()):
            raise AssertionError("K1 non-finite at n=%d n_kl=%d B=%d"
                                 % (n, n_kl, B))
        if n == 1 and (np.abs(got64.cpu().numpy()).max() != 0
                       or np.abs(got32.cpu().numpy()).max() != 0):
            raise AssertionError("K1 n=1 must give zeros")
        if e64.max() > 1e-10:
            raise AssertionError(
                "K1 f64 vs plain f64: max rel err %.3e > 1e-10 at n=%d "
                "n_kl=%d B=%d" % (e64.max(), n, n_kl, B))
        if not (np.median(e32) <= 10 * np.median(eref) + 1e-6
                and e32.max() <= 10 * eref.max() + 1e-5):
            raise AssertionError(
                "K1 f32 outside the f32 error class at n=%d n_kl=%d B=%d: "
                "median %.3e (plain %.3e), max %.3e (plain %.3e)"
                % (n, n_kl, B, np.median(e32), np.median(eref), e32.max(),
                   eref.max()))
        a64 = float((got64 - ref64).abs().max())
        a32 = float((got32 - pl32).abs().max())
        if a64 != 0 or a32 != 0:
            raise AssertionError(
                "K1 is not bit-equal to its plain version at n=%d n_kl=%d "
                "B=%d: max abs err f64 %.3e, f32 %.3e" % (n, n_kl, B, a64,
                                                          a32))
        log("K1 n=%4d n_kl=%4d B=%4d  f64 max rel %.2e abs %.2e | f32 "
            "median %.2e max %.2e (plain f32 %.2e / %.2e) abs vs plain f32 "
            "%.2e" % (n, n_kl, B, e64.max(), a64, np.median(e32), e32.max(),
                      np.median(eref), eref.max(), a32))
        worst = max(worst, float(e64.max()))
        max_abs[torch.float64] = max(max_abs[torch.float64], a64)
        max_abs[torch.float32] = max(max_abs[torch.float32], a32)
    log("K1 vs plain, same dtype, %d shapes: max abs err f32 %.3e, f64 "
        "%.3e; f64 max rel err %.3e" % (len(cases), max_abs[torch.float32],
                                        max_abs[torch.float64], worst))

    def normal(B, dtype):
        return torch.as_tensor(rng.standard_normal((B, N_KL)), dtype=dtype,
                               device=dev)

    # the flagship shape, f32: plain, kernel, kernel, plain
    n = GRIDS[0]
    xi = normal(BATCH, torch.float32)
    run_k = lambda: diffusion_outputs(xi, n, SIGMA, NU)
    run_p = lambda: diffusion_outputs_plain(xi, n, SIGMA, NU)
    p1 = _time_ms(run_p, 5)
    k1_ = _time_ms(run_k, 50)
    k2_ = _time_ms(run_k, 50)
    p2 = _time_ms(run_p, 5)
    ms, plain_ms = min(k1_, k2_), min(p1, p2)
    log("K1 timing n=%d B=%d f32: kernel %.4f / %.4f ms, plain %.4f / %.4f "
        "ms (plain, kernel, kernel, plain)" % (n, BATCH, k1_, k2_, p1, p2))
    bound, by, ops, nbytes = k1_bound_ms(n, N_KL, BATCH, torch.float32)
    log("K1 bound n=%d B=%d f32: %.4g GFLOP, %.4g MB -> %.5f ms (%s-bound); "
        "kernel %.4f ms = %.1f%% of the bound"
        % (n, BATCH, ops / 1e9, nbytes / 1e6, bound, by, ms,
           100 * bound / ms))
    for g in GRIDS:
        log("K1 time n=%4d B=%d f32: %.4f ms"
            % (g, BATCH, _time_ms(lambda: diffusion_outputs(xi, g, SIGMA,
                                                            NU), 50)))
    for B in B_SWEEP:
        xb = normal(B, torch.float32)
        t = _time_ms(lambda: diffusion_outputs(xb, n, SIGMA, NU), 20)
        log("K1 time n=%d B=%6d f32: %.4f ms = %.2fM samples/s"
            % (n, B, t, B / t / 1e3))
    x64 = normal(BATCH, torch.float64)
    t64 = _time_ms(lambda: diffusion_outputs(x64, n, SIGMA, NU), 50)
    b64 = k1_bound_ms(n, N_KL, BATCH, torch.float64)[0]
    log("K1 time n=%d B=%d f64: %.4f ms (bound %.5f ms, %.1f%%)"
        % (n, BATCH, t64, b64, 100 * b64 / t64))
    return {"max_abs_err": max(max_abs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}


def parent_wide(src):
    """The wide tier of another csrc/diffusion.cu with the same C
    interface (bluest_diffusion_wide_workspace_* and bluest_diffusion_wide_*,
    as the earlier one-kernel design has), built with K1's nvcc flags
    beside the package's libraries, as a launcher (xis, n) -> (B, 3) on the
    current stream.  For timing in turns only: it is counted nowhere and
    never on a path."""
    import ctypes
    import torch
    from bluest_tpu_torch.ops import _build
    from bluest_tpu_torch.ops import diffusion as k1
    so = _build.build(src, k1.NVCC_FLAGS)
    lib = ctypes.CDLL(so)
    for sfx in ("f32", "f64"):
        fn = getattr(lib, "bluest_diffusion_wide_" + sfx)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
            ctypes.c_int] * 3 + [ctypes.c_double, ctypes.c_double,
                                 ctypes.c_void_p]
        plan = getattr(lib, "bluest_diffusion_wide_workspace_" + sfx)
        plan.restype = ctypes.c_int
        plan.argtypes = [ctypes.c_int, ctypes.c_int,
                         ctypes.POINTER(ctypes.c_longlong)]

    def run(xis, n):
        B, n_kl = xis.shape
        sfx = "f32" if xis.dtype == torch.float32 else "f64"
        mckT = k1._mode_matrix_t(n, n_kl, SIGMA, NU, xis.dtype, xis.device)
        elems = ctypes.c_longlong(0)
        rc = getattr(lib, "bluest_diffusion_wide_workspace_" + sfx)(
            B, n, ctypes.byref(elems))
        ws = torch.empty(max(elems.value, 1), dtype=xis.dtype,
                         device=xis.device)
        out = torch.empty((B, 3), dtype=xis.dtype, device=xis.device)
        if rc == 0:
            rc = getattr(lib, "bluest_diffusion_wide_" + sfx)(
                xis.data_ptr(), mckT.data_ptr(), out.data_ptr(),
                ws.data_ptr(), elems.value, B, n_kl, n, 1.0 / n ** 2,
                1.0 / n, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError("parent wide tier: error %d at n=%d n_kl=%d"
                               % (rc, n, n_kl))
        return out
    return run


def _bit_equal(a, b):
    """Equal bit for bit, NaN where the other is NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def wide_stages_hold(xi, n, got):
    """Hold a wide-tier result ``got`` for xi at n by its stages: stage 1
    (the kernel's own a) against synthesize_plain, stage 2 on that a
    bit-equal to solve_plain in both dtypes, and the call equal to its two
    stages.  Stage 1 is bit-equal in f32 (the same in-order _rn sum).  In
    f64 it runs on the tensor cores, which take the sum in their own order:
    a sum of n_kl terms taken in any order, with or without FMA, is within
    n_kl u sum_k |mck_ik xi_bk| of the exact one (u = 2^-53), so two such
    sums differ by at most twice that, and exp turns a difference d of log a
    into a relative difference of ~d, plus an ulp of each exp (4u):
    |a_k - a_p| / a_p <= 2 n_kl u sum_k |mck_ik xi_bk| + 4u for each
    element.  Returns stage 1's largest relative difference and its largest
    share of that bound (0 in f32)."""
    import torch
    from bluest_tpu_torch.ops import diffusion as k1
    where = "n=%d n_kl=%d B=%d %s" % (n, xi.shape[1], xi.shape[0],
                                     str(xi.dtype)[6:])
    a_k = k1.synthesize(xi, n, SIGMA, NU)
    a_p = k1.synthesize_plain(xi, n, SIGMA, NU)
    rel, share = 0.0, 0.0
    if xi.dtype == torch.float32:
        if not _bit_equal(a_k, a_p):
            raise AssertionError("wide stage 1 (f32) is not bit-equal to "
                                 "synthesize_plain at " + where)
    else:
        u = 2.0 ** -53
        mckT = k1._mode_matrix_t(n, xi.shape[1], SIGMA, NU, xi.dtype,
                                 xi.device)
        bound = 2 * xi.shape[1] * u * (xi.abs() @ mckT.abs()) + 4 * u
        r = (a_k - a_p).abs() / a_p
        rel, share = float(r.max()), float((r / bound).max())
        if not (share <= 1.0):
            raise AssertionError(
                "wide stage 1 (f64) outside the bound of a sum in any order "
                "at %s: max rel %.3e, %.3f of the bound" % (where, rel, share))
    o2 = k1.solve(a_k, n)
    if not _bit_equal(o2, k1.solve_plain(a_k, n)):
        raise AssertionError("wide stage 2 is not bit-equal to solve_plain "
                             "on its stage 1's a at " + where)
    if not _bit_equal(got, o2):
        raise AssertionError("the wide call is not its two stages at "
                             + where)
    return rel, share


def phase_wide_check(parent=None):
    """Phase 3, the wide tier: at every grid of WIDE_GRIDS, past 32769
    cells, at phase 10's wide grids and batches, and at a shape K1 refuses
    for its n_kl, both dtypes: each stage held (wide_stages_hold), f32 end
    to end bit-equal to the plain version, f64 end to end against it
    printed (max and median relative difference); then its times at the
    deep flagship's wide grids -- the call, each stage, torch.matmul for
    stage 1's product, and an earlier wide tier (``parent``, a launcher
    from parent_wide) in turns -- beside K1's bound, which counts the same
    function, and K1 and the wide tier in turns at shapes that are K1's."""
    import numpy as np
    import torch
    from bluest_tpu_torch.ops import diffusion as k1
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    cases = [(n, n_kl, B if n <= 4097 else min(B, WIDE_MAX_B))
             for n in WIDE_GRIDS for n_kl in WIDE_N_KL
             for B in CHECK_BATCHES]
    cases += [WIDE_K1_REFUSED + (B,) for B in CHECK_BATCHES]
    cases += list(WIDE_PAST_REGS)
    cases = sorted(set(cases) | set(_deep_cases("wide")))  # + phase 10's
    log("wide tier check: %d shapes (n, n_kl, B), f64 and f32" % len(cases))
    max_abs, e2e = 0.0, []
    by_tier = k1.diffusion_outputs.launches_by_tier
    for n, n_kl, B in cases:
        xi64 = torch.as_tensor(rng.standard_normal((B, n_kl)),
                               dtype=torch.float64, device=dev)
        xi32 = xi64.to(torch.float32)
        if {k1.tier(n, n_kl, x.dtype) for x in (xi64, xi32)} != {"wide"}:
            raise AssertionError("n=%d n_kl=%d is not the wide tier's"
                                 % (n, n_kl))
        before = by_tier["wide"]
        got64 = k1.diffusion_outputs(xi64, n, SIGMA, NU)
        ws64 = k1.diffusion_outputs.workspace_bytes
        got32 = k1.diffusion_outputs(xi32, n, SIGMA, NU)
        ws32 = k1.diffusion_outputs.workspace_bytes
        torch.cuda.synchronize()
        if by_tier["wide"] != before + 2:
            raise AssertionError("the wide tier did not launch at n=%d "
                                 "n_kl=%d" % (n, n_kl))
        ref64 = k1.diffusion_outputs_plain(xi64, n, SIGMA, NU)
        pl32 = k1.diffusion_outputs_plain(xi32, n, SIGMA, NU)
        if got64.shape != (B, 3) or got32.shape != (B, 3):
            raise AssertionError("wide output shape at n=%d B=%d" % (n, B))
        if not bool(torch.isfinite(got64).all()):
            raise AssertionError("wide f64 non-finite at n=%d n_kl=%d B=%d"
                                 % (n, n_kl, B))
        s1_64, share = wide_stages_hold(xi64, n, got64)
        wide_stages_hold(xi32, n, got32)
        if not _bit_equal(got32, pl32):
            raise AssertionError("the wide tier (f32) is not bit-equal to "
                                 "the plain version at n=%d n_kl=%d B=%d"
                                 % (n, n_kl, B))
        r = ref64.cpu().numpy()
        e64 = np.abs(got64.cpu().numpy() - r) / (np.abs(r) + 1e-9)
        e32 = np.abs(got32.double().cpu().numpy() - r) / (np.abs(r) + 1e-9)
        a64 = float((got64 - ref64).abs().max())
        log("wide n=%5d n_kl=%4d B=%4d  f64 vs plain max rel %.2e median "
            "%.2e (stage 1 max rel %.2e, %.3f of its bound; stage 2 "
            "bit-equal) | f32 bit-equal, vs f64 plain median %.2e max %.2e "
            "| buffer f64 %d B, f32 %d B"
            % (n, n_kl, B, e64.max(), np.median(e64), s1_64, share,
               np.nanmedian(e32), np.nanmax(e32), ws64, ws32))
        e2e.append((n, n_kl, B, float(e64.max()), float(np.median(e64))))
        max_abs = max(max_abs, a64)
    log("wide f64 vs plain over %d shapes: max rel %.3e, largest median "
        "%.3e, max abs %.3e; f32 bit-equal at all"
        % (len(cases), max(e[3] for e in e2e), max(e[4] for e in e2e),
           max_abs))

    # the call, each stage and stage 1's library product at the deep
    # flagship's wide grids, B = BATCH, both dtypes; the parent's wide tier
    # in turns (parent, new, new, parent) where one is given
    timed = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 for matmul
    try:
        for n, n_kl in WIDE_TIMED:
            xi = torch.as_tensor(rng.standard_normal((BATCH, n_kl)),
                                 device=dev)
            for dt in (torch.float64, torch.float32):
                x = xi.to(dt)
                run = lambda: k1.diffusion_outputs(x, n, SIGMA, NU)
                turns = {}
                if parent is not None:
                    turns["parent_1"] = _time_ms(lambda: parent(x, n), 10)
                turns["new_1"] = _time_ms(run, 10)
                turns["new_2"] = _time_ms(run, 10)
                if parent is not None:
                    turns["parent_2"] = _time_ms(lambda: parent(x, n), 10)
                ws = k1.diffusion_outputs.workspace_bytes
                a = k1.synthesize(x, n, SIGMA, NU)
                s1 = _time_ms(lambda: k1.synthesize(x, n, SIGMA, NU), 10)
                s2 = _time_ms(lambda: k1.solve(a, n), 10)
                mckT = k1._mode_matrix_t(n, n_kl, SIGMA, NU, dt, dev)
                lib_ms = _time_ms(lambda: torch.matmul(x, mckT), 10)
                del a
                bound, by, ops, nbytes = k1_bound_ms(n, n_kl, BATCH, dt)
                ms = min(turns["new_1"], turns["new_2"])
                key = "n%d_nkl%d_%s" % (n, n_kl, str(dt)[6:])
                timed[key] = {"ms": ms, "turns_ms": turns,
                              "stage_ms": {"synthesis": s1, "solve": s2},
                              "synthesis_library_ms": lib_ms,
                              "bound_ms": bound, "workspace_bytes": ws}
                log("wide time n=%d n_kl=%d B=%d %s: %s ms; %.1f%% of the "
                    "bound %.5f ms (%.4g GFLOP, %.4g MB, %s-bound); stages: "
                    "synthesis %.4f ms (%.1f TFLOP/s), solve %.4f ms; "
                    "torch.matmul (synthesis only, no exp, TF32 off) %.4f "
                    "ms; buffer %d B a launch"
                    % (n, n_kl, BATCH, str(dt)[6:],
                       " / ".join("%s %.4f" % kv for kv in turns.items()),
                       100 * bound / ms, bound, ops / 1e9, nbytes / 1e6, by,
                       s1, 2 * BATCH * n * n_kl / s1 / 1e9, s2, lib_ms, ws))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # the deep flagship's finest model: plain, kernel, kernel, plain
    n = DEEP_GRIDS[0]
    x = torch.as_tensor(rng.standard_normal((BATCH, N_KL_DEEP)), device=dev)
    run_k = lambda: k1.diffusion_outputs(x, n, SIGMA, NU)
    run_p = lambda: k1.diffusion_outputs_plain(x, n, SIGMA, NU)
    p1 = _time_ms(run_p, 1)
    k_a = _time_ms(run_k, 10)
    k_b = _time_ms(run_k, 10)
    p2 = _time_ms(run_p, 1)
    ms, plain_ms = min(k_a, k_b), min(p1, p2)
    bound, by, _ops, _nbytes = k1_bound_ms(n, N_KL_DEEP, BATCH, torch.float64)
    log("wide timing n=%d n_kl=%d B=%d f64: kernel %.4f / %.4f ms, plain "
        "%.4f / %.4f ms (plain, kernel, kernel, plain); %.1f%% of the bound"
        % (n, N_KL_DEEP, BATCH, k_a, k_b, p1, p2, 100 * bound / ms))

    # both tiers at shapes tier() gives K1 -- the flagship's finest, and
    # phase 10's three finest K1 grids at its modes -- in turns: K1, wide,
    # wide, K1
    at_k1 = {}
    for n, n_kl, dts in ((GRIDS[0], N_KL, (torch.float32, torch.float64)),
                         (DEEP_GRIDS[2], N_KL_DEEP,
                          (torch.float32, torch.float64)),
                         (DEEP_GRIDS[3], N_KL_DEEP, (torch.float64,)),
                         (DEEP_GRIDS[4], N_KL_DEEP, (torch.float64,))):
        for dt in dts:
            x = torch.as_tensor(rng.standard_normal((BATCH, n_kl)),
                                dtype=dt, device=dev)
            run_1 = lambda: k1.launch("k1", x, n, SIGMA, NU)
            run_w = lambda: k1.launch("wide", x, n, SIGMA, NU)
            t_1a, t_wa = _time_ms(run_1, 20), _time_ms(run_w, 20)
            t_wb, t_1b = _time_ms(run_w, 20), _time_ms(run_1, 20)
            key = "n%d_nkl%d_%s" % (n, n_kl, str(dt)[6:])
            at_k1[key] = {"k1_ms": min(t_1a, t_1b),
                          "wide_ms": min(t_wa, t_wb)}
            log("tiers at K1's shape n=%d n_kl=%d B=%d %s: K1 %.4f / %.4f "
                "ms, wide %.4f / %.4f ms (K1, wide, wide, K1): wide/K1 = "
                "%.2f; bound %.5f ms" % (
                    n, n_kl, BATCH, str(dt)[6:], t_1a, t_1b, t_wa, t_wb,
                    min(t_wa, t_wb) / min(t_1a, t_1b),
                    k1_bound_ms(n, n_kl, BATCH, dt)[0]))
    head = timed["n%d_nkl%d_float64" % (DEEP_GRIDS[0], N_KL_DEEP)]
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by,
            "workspace_bytes": head["workspace_bytes"],
            "stage_ms": head["stage_ms"],
            "synthesis_library_ms": head["synthesis_library_ms"],
            "timed": timed, "f64_vs_plain": e2e, "ms_at_k1_shapes": at_k1}


def hh_params(n, seed):
    """(n, 3) float64 HH parameters on DEV from a numpy seed, distributed
    as HodgkinHuxleyProblem.sample_group draws them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    p = np.stack([8.0 + 4.0 * rng.random(n),
                  120.0 * (1.0 + 0.1 * rng.standard_normal(n)),
                  36.0 * (1.0 + 0.1 * rng.standard_normal(n))], axis=1)
    return torch.as_tensor(p, dtype=torch.float64, device=DEV)


def k2_work(models, n):
    """The least work of the function K2 computes, from its inputs: per
    sample and model its steps times ops.hodgkin_huxley.STEP_OPS (each
    add, subtract, multiply, divide, exp, pow and compare one, as
    csrc/hodgkin_huxley.cu's note counts them); the parameters read once
    and the (n, 5, L) outputs written once."""
    from bluest_tpu_torch.ops.hodgkin_huxley import STEP_OPS, n_steps
    ops = n * sum(n_steps(dt) * STEP_OPS[kind] for kind, dt in models)
    nbytes = 8 * (3 * n + 5 * n * len(models))
    return ops, nbytes


def k2_bound_ms(models, n):
    """The least time the card could take for K2's work: the larger of its
    operations over the FP64 rate outside the tensor cores and its bytes
    over HBM bandwidth (NVIDIA H100 SXM data sheet, 700 W)."""
    ops, nbytes = k2_work(models, n)
    t_ops = ops / OTHER_FLOPS[8] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), ops, nbytes


def k2_holds(got, ref, where):
    """K2's (n, 5, L) outputs against the plain version's on the same
    inputs: the same (row, model) pairs non-finite, on the finite ones
    each model's normwise relative difference <= 1e-10, and every entry
    bit-equal (NaN where the plain version has NaN): K2 rounds each
    operation as eager PyTorch does on the card, and was bit-equal in
    every entry of every check run on the H100.  Returns (worst normwise
    difference, bit-equal entries, entries, max abs difference over the
    entries finite in both)."""
    import torch
    if got.shape != ref.shape:
        raise AssertionError("K2 %s: shape %s, plain %s"
                             % (where, tuple(got.shape), tuple(ref.shape)))
    fin = torch.isfinite(ref).all(dim=1)                     # (n, L)
    if not torch.equal(torch.isfinite(got).all(dim=1), fin):
        raise AssertionError("K2 %s: non-finite rows differ from the "
                             "plain version's" % where)
    worst = 0.0
    for l in range(ref.shape[2]):
        f = fin[:, l]
        if bool(f.any()):
            worst = max(worst, _normwise(got[f, :, l], ref[f, :, l]))
    same = (got == ref) | (got.isnan() & ref.isnan())
    both = torch.isfinite(got) & torch.isfinite(ref)
    max_abs = float((got - ref)[both].abs().max()) if bool(both.any()) \
        else 0.0
    if not worst <= 1e-10:
        raise AssertionError("K2 %s: normwise relative difference %.3e > "
                             "1e-10" % (where, worst))
    if not bool(same.all()):
        raise AssertionError("K2 %s: %d of %d entries differ from the plain "
                             "version's (max abs %.3e)"
                             % (where, int((~same).sum()), same.numel(),
                                max_abs))
    return worst, int(same.sum()), same.numel(), max_abs


def _plain_model_ms(models, x):
    """K2's plain version on x, one model after another as
    hh_group_outputs_plain runs them: each model's ms (CUDA events)."""
    import torch
    from bluest_tpu_torch.ops.hodgkin_huxley import hh_group_outputs_plain
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(models) + 1)]
    ev[0].record()
    for i, m in enumerate(models):
        hh_group_outputs_plain((m,), x)
        ev[i + 1].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(len(models))]


# one kernel per (kind, lanes) that runs integrate<> of a K2 source alone,
# its step count from an argument: its loop is one step of that kind
K2_PROBE = r"""#include "%(src)s"
template <int KIND, int LANES>
__global__ void __launch_bounds__(HH_THREADS%(bounds)s)
k2_step_probe(const double* p, double* o, int n_steps) {
  HHEntry e;
  e.kind = KIND; e.n_steps = n_steps; e.col = 0;
  e.dt = p[3]; e.hdt = p[4]; e.c6 = p[5]; e.inv_steps = p[6];
  double r[5];
  %(call)s
  for (int q = 0; q < 5; ++q) o[5 * threadIdx.x + q] = r[q];
}
%(inst)s
"""
# SASS opcodes by class: the FP64 pipe's, the rest apart
SASS_FP64 = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET")
SASS_CLASSES = (
    ("int", ("IADD3", "IMAD", "LEA", "SHF", "LOP3", "ISETP", "IABS",
             "IMNMX", "FLO", "POPC", "SHL", "SHR", "LOP", "IADD", "BMSK")),
    ("fp32", ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FCHK", "FSET")),
    ("branch", ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC",
                "BREAK", "YIELD", "JMP", "BMOV")),
    ("shfl", ("SHFL",)),
)


def k2_probe_cubin(src, parent):
    """Compile the step probes of the K2 source ``src`` (``parent``: the
    one-lane design before the variants, whose integrate<> takes no lane)
    to a cubin with K2's code-generation flags; returns its path."""
    import hashlib
    from bluest_tpu_torch.ops import _build
    from bluest_tpu_torch.ops import hodgkin_huxley as k2
    lanes = (1,) if parent else tuple(k2.VARIANTS.values())
    text = K2_PROBE % {
        "src": os.path.abspath(src),
        "bounds": "" if parent else ", HH_MIN_BLOCKS",
        "call": "integrate<KIND>(e, p[0], p[1], p[2], r);" if parent else
        "integrate<KIND, LANES>(e, p[0], p[1], p[2], threadIdx.x % LANES, r);",
        "inst": "\n".join(
            "template __global__ void k2_step_probe<%d, %d>(const double*, "
            "double*, int);" % (kind, ln) for kind in (0, 1, 2)
            for ln in lanes)}
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read() + text.encode()).hexdigest()[:16]
    d = os.path.join(_build.BUILD_DIR, "k2_sass")
    os.makedirs(d, exist_ok=True)
    cu = os.path.join(d, "probe_%s.cu" % tag)
    cubin = cu[:-3] + ".cubin"
    if not os.path.exists(cubin):
        with open(cu, "w") as f:
            f.write(text)
        flags = [x for x in _build.BASE_FLAGS
                 if x not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas",
                              "-v")]
        proc = subprocess.run([_build.find_nvcc(), "-cubin"] + flags
                              + ["-o", cubin + ".tmp", cu],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on the K2 step probes:\n%s"
                               % (proc.stdout + proc.stderr))
        os.replace(cubin + ".tmp", cubin)
    return cubin


def sass_step_counts(cubin):
    """{(kind, lanes): counts} of one step, from cuobjdump -sass of the
    probes: the instructions of each probe's loop (from the target of its
    first backward branch to that branch; both sides of a branch inside
    counted) and of each subroutine the loop calls on every pass (from
    its entry to its first RET: libdevice's pow keeps its log there), by
    opcode class, with "fp64" the FP64 pipe's (SASS_FP64) and "mufu" MUFU
    apart; "skipped_calls" counts the calls a forward branch of the loop
    can jump over (the slow paths of division and exp), not added."""
    import re
    from bluest_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", cubin], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs, cur, pending = {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), ([], {}))
            pending = []
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L\w*):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                cur[1][lab] = addr
            pending = []
            cur[0].append((addr, m.group(2)))
    out = {}
    for name, (ins, labels) in funcs.items():
        m = re.search(r"k2_step_probeILi(\d)ELi(\d)E", name)
        if not m:
            continue
        ops = []
        for addr, body in ins:
            tok = body.split()
            if tok[0].startswith("@"):
                tok = tok[1:]
            op = tok[0]
            target = None
            if op.split(".")[0] == "BRA":
                rest = " ".join(tok[1:])
                t = re.search(r"`\((\.L\w*)\)", rest)
                if t:
                    target = labels.get(t.group(1))
                else:
                    t = re.search(r"0x([0-9a-f]+)", rest)
                    target = int(t.group(1), 16) if t else None
            ops.append((addr, op, target))
        back = [(addr, target) for addr, _, target in ops
                if target is not None and target < addr]
        if not back:
            raise AssertionError("no loop in the SASS of %s" % name)
        end, start = min(back)
        counts = dict.fromkeys(("fp64", "mufu") + SASS_FP64
                               + tuple(c for c, _ in SASS_CLASSES)
                               + ("other", "all", "skipped_calls"), 0)

        def add(addr_ok):
            for addr, op, _ in ops:
                if not addr_ok(addr):
                    continue
                base = op.split(".")[0]
                counts["all"] += 1
                if base in SASS_FP64:
                    counts["fp64"] += 1
                    counts[base] += 1
                elif base == "MUFU":
                    counts["mufu"] += 1
                else:
                    cls = [c for c, names in SASS_CLASSES if base in names]
                    counts[cls[0] if cls else "other"] += 1

        add(lambda a: start <= a <= end)
        jumps = [(addr, target) for addr, _, target in ops
                 if target is not None and start <= addr < target]
        for addr, op, _ in ops:
            if not (start <= addr <= end and op.startswith("CALL")):
                continue
            if any(a < addr < t for a, t in jumps):
                counts["skipped_calls"] += 1
                continue
            body = ins[[a for a, _ in ins].index(addr)][1]
            entry = int(re.search(r"0x([0-9a-f]+)", body).group(1), 16)
            ret = min(a for a, o, _ in ops if a >= entry
                      and o.startswith("RET"))
            add(lambda a: entry <= a <= ret)
        out[(int(m.group(1)), int(m.group(2)))] = counts
    return out


def parent_k2(src):
    """K2 of another csrc/hodgkin_huxley.cu with the one-lane C interface
    (bluest_hh_outputs_f64 without a lanes argument, as the design before
    the variants has), built with K2's nvcc flags beside the package's
    libraries, as a launcher (models, x) -> (n, 5, L) on the current
    stream, one launch per table of launch_plan.  For timing in turns
    only: it is counted nowhere and never on a path."""
    import ctypes
    import torch
    from bluest_tpu_torch.ops import _build
    from bluest_tpu_torch.ops import hodgkin_huxley as k2
    lib = ctypes.CDLL(_build.build(src, k2.NVCC_FLAGS))
    fn = lib.bluest_hh_outputs_f64
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_double), ctypes.c_void_p]

    def run(models, x):
        n, L = x.shape[0], len(models)
        out = torch.empty((n, 5, L), dtype=torch.float64, device=x.device)
        for launch in k2.launch_plan(models, n):
            e = launch.entries
            rc = fn(x.data_ptr(), out.data_ptr(), n, L, len(e),
                    *k2._table_args(e),
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError("parent K2: CUDA error %d (n=%d, L=%d)"
                                   % (rc, n, L))
        return out
    return run


def parent_psd(src):
    """K3 and K4 of another csrc/psd_eig.cu with this one's C interface
    to them (bluest_sym_eigvalsh_f64 and bluest_nt_svd_f64 with a sweeps
    argument, passed null), built with the package's nvcc flags beside its
    libraries, as launchers {"eigvalsh": x -> (w, status), "svd": x ->
    (U, S, status)} on the current stream.  For timing in turns and K3's
    bit-equality only: counted nowhere and never on a path."""
    import ctypes
    import torch
    from bluest_tpu_torch.ops import _build
    from bluest_tpu_torch.ops import psd_eig as k34
    lib = ctypes.CDLL(_build.build(src, k34.NVCC_FLAGS))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bluest_sym_eigvalsh_f64.restype = I
    lib.bluest_sym_eigvalsh_f64.argtypes = [P, P, P, P, P, I, I, P]
    lib.bluest_nt_svd_f64.restype = I
    lib.bluest_nt_svd_f64.argtypes = [P, P, P, P, P, P, I, I, P]
    lib.bluest_psd_work_doubles.restype = ctypes.c_longlong
    lib.bluest_psd_work_doubles.argtypes = [I, I]

    def work(kind, x):
        return torch.empty(x.shape[0] * lib.bluest_psd_work_doubles(
            kind, x.shape[1]), dtype=torch.float64, device=x.device)

    def check(rc, what, x):
        if rc != 0:
            raise RuntimeError("parent %s: CUDA error %d (B=%d, n=%d)"
                               % (what, rc, x.shape[0], x.shape[1]))

    def eigvalsh(x):
        B, n = x.shape[0], x.shape[1]
        w = torch.empty((B, n), dtype=torch.float64, device=x.device)
        st = torch.empty(B, dtype=torch.int32, device=x.device)
        check(lib.bluest_sym_eigvalsh_f64(
            x.data_ptr(), w.data_ptr(), st.data_ptr(), None,
            work(3, x).data_ptr(), B, n,
            torch.cuda.current_stream().cuda_stream), "K3", x)
        return w, st

    def svd(x):
        B, n = x.shape[0], x.shape[1]
        U = torch.empty((B, n, n), dtype=torch.float64, device=x.device)
        S = torch.empty((B, n), dtype=torch.float64, device=x.device)
        st = torch.empty(B, dtype=torch.int32, device=x.device)
        check(lib.bluest_nt_svd_f64(
            x.data_ptr(), U.data_ptr(), S.data_ptr(), st.data_ptr(), None,
            work(4, x).data_ptr(), B, n,
            torch.cuda.current_stream().cuda_stream), "K4", x)
        return U, S, st
    return {"eigvalsh": eigvalsh, "svd": svd}


@contextlib.contextmanager
def smi_sampler(period_ms=100):
    """nvidia-smi's SM clock (MHz), power draw and power limit (W),
    sampled every ``period_ms`` while the block runs: the list it yields
    holds (clock, draw, limit) once the block has ended."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader,nounits", "-lms", str(period_ms)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    samples = []
    try:
        yield samples
    finally:
        proc.terminate()
        try:
            out = proc.communicate(timeout=30)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            out = proc.communicate()[0]
        for line in out.splitlines():
            try:
                samples.append(tuple(float(v) for v in line.split(",")))
            except ValueError:
                pass


def k2_fp64_instructions(models, n, lanes, counts):
    """FP64 instructions a K2 launch of ``models`` at n samples issues,
    from the SASS counts of one step per thread: steps x threads."""
    from bluest_tpu_torch.ops.hodgkin_huxley import n_steps
    return sum(n_steps(dt) * n * lanes * counts[(kind, lanes)]["fp64"]
               for kind, dt in models)


def k2_issue_share(instructions, clock_mhz, ms, sms):
    """Share of the FP64 pipe's issue slots (64 lanes an SM a clock) that
    ``instructions`` thread-instructions fill in ``ms`` at ``clock_mhz``."""
    return instructions / (sms * 64 * clock_mhz * 1e6 * ms * 1e-3)


def phase_k2_check(parent=None, sass=None):
    """K2 against its plain version on the same card and inputs: each of
    the 12 default models alone and the 12-model group, at every n of
    K2_CHECK_N, in every variant and in the one launch_plan picks; each
    launch counted, and by variant.  Then the SASS counts of one step of
    each kind, variant and design (``sass``: {design: counts}); each
    variant's time (CUDA events after warm-up) at model 0 and the group
    for n in K2_SWEEP_N beside its FP64 issue share, the SM clock sampled
    meanwhile; with ``parent`` (parent_k2), the earlier design and this
    one in turns (parent, new, new, parent) at K2_TURNS; and the time at
    n=K2_TIMED_N for model 0 and the group beside the bound and the plain
    version's time, in turns (plain, kernel, kernel, plain).  Returns the
    kernel line's numbers, and the inputs and plain outputs for phase
    6(b), which holds its K=3 groups against them."""
    import statistics as st
    import torch
    from bluest_tpu_torch.models.hodgkin_huxley import DEFAULT_MODELS
    from bluest_tpu_torch.ops import hodgkin_huxley as k2
    t_phase = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    xs = [hh_params(n, 100 + i) for i, n in enumerate(K2_CHECK_N)]
    # the plain version computes each row on its own, elementwise: one call
    # on all the batches' rows gives each batch's outputs
    t0 = time.perf_counter()
    refs = torch.split(k2.hh_group_outputs_plain(DEFAULT_MODELS,
                                                 torch.cat(xs)), K2_CHECK_N)
    _sync()
    log("K2 check: plain version of the 12 models on %d rows (n in %s): "
        "%.3f s" % (sum(K2_CHECK_N), K2_CHECK_N, time.perf_counter() - t0))
    stats = []
    by_variant = k2.hh_group_outputs.launches_by_variant
    for x, ref in zip(xs, refs):
        n = x.shape[0]
        cases = [(str(l), (m,), [l]) for l, m in enumerate(DEFAULT_MODELS)]
        cases.append(("group", DEFAULT_MODELS, list(range(12))))
        picks = {}
        for variant in tuple(k2.VARIANTS) + (None,):
            for name, models, cols in cases:
                want = variant or k2.launch_plan(models, n, sms)[0].variant
                before = (k2.hh_group_outputs.launches, by_variant[want])
                got = k2.hh_group_outputs(models, x, variant=variant)
                _sync()
                if (k2.hh_group_outputs.launches,
                        by_variant[want]) != (before[0] + 1, before[1] + 1):
                    raise AssertionError("K2 (%s) did not launch once for "
                                         "model(s) %s at n=%d"
                                         % (want, name, n))
                stats.append(k2_holds(got, ref[:, :, cols],
                                      "%s, model(s) %s, n=%d"
                                      % (variant or "picked " + want, name,
                                         n)))
                if variant is None:
                    picks[want] = picks.get(want, 0) + 1
        fin = int(torch.isfinite(ref).all(dim=1).sum())
        log("K2 n=%5d: 12 models and the group hold in every variant (%s) "
            "and as picked %s; %d of %d (row, model) pairs finite"
            % (n, ", ".join(k2.VARIANTS), picks, fin, 12 * n))
    worst = max(s_[0] for s_ in stats)
    same, total = sum(s_[1] for s_ in stats), sum(s_[2] for s_ in stats)
    max_abs = max(s_[3] for s_ in stats)
    log("K2 vs plain, %d launches: max normwise rel diff %.3e, max abs diff "
        "%.3e, bit-equal entries %d of %d (%.6f%%)"
        % (len(stats), worst, max_abs, same, total, 100.0 * same / total))

    # SASS: one step of each kind, per thread
    sass = sass or {}
    kinds = {0: "HH RK4", 1: "HH Euler", 2: "FHN RK4"}
    for design, counts in sorted(sass.items()):
        for (kind, lanes), c in sorted(counts.items()):
            log("K2 SASS %s lanes=%d %s step, per thread: FP64 %d (DADD %d, "
                "DMUL %d, DFMA %d, DSETP %d), MUFU %d, int %d, fp32 %d, "
                "shfl %d, branch %d, other (moves, selects, memory) %d; all "
                "%d (%d calls to slow paths not counted)"
                % (design, lanes, kinds[kind], c["fp64"], c["DADD"],
                   c["DMUL"], c["DFMA"], c["DSETP"], c["mufu"], c["int"],
                   c["fp32"], c["shfl"], c["branch"], c["other"], c["all"],
                   c["skipped_calls"]))
    new_counts = sass.get("new")

    def share(models, n, lanes, ms, counts, clock):
        if counts is None or not clock:
            return float("nan")
        return k2_issue_share(k2_fp64_instructions(models, n, lanes, counts),
                              clock, ms, sms)

    shapes = {"model0": DEFAULT_MODELS[:1], "group": DEFAULT_MODELS}
    sweep, turns = [], []
    with smi_sampler() as smi:
        # every variant over n: the host rule's ground
        for n in K2_SWEEP_N:
            x = hh_params(n, 7)
            for name, models in shapes.items():
                row = {v: _time_ms(lambda: k2.hh_group_outputs(
                    models, x, variant=v), 5) for v in k2.VARIANTS}
                sweep.append((name, n, row,
                              k2.launch_plan(models, n, sms)[0].variant))
        # the earlier design in turns: parent, new, new, parent
        if parent is not None:
            for name, n in K2_TURNS:
                models, x = shapes[name], hh_params(n, 8)
                t = [_time_ms(lambda: parent(models, x), 20),
                     _time_ms(lambda: k2.hh_group_outputs(models, x), 20),
                     _time_ms(lambda: k2.hh_group_outputs(models, x), 20),
                     _time_ms(lambda: parent(models, x), 20)]
                turns.append((name, n, t))
    clocks = [c[0] for c in smi]
    clock = st.median(clocks) if clocks else None
    if clocks:
        log("K2 timing: SM clock %.0f MHz median (%.0f-%.0f), power draw "
            "%.1f-%.1f W, limit %.2f W (%d nvidia-smi samples)"
            % (clock, min(clocks), max(clocks), min(c[1] for c in smi),
               max(c[1] for c in smi), smi[0][2], len(smi)))
    else:
        log("K2 timing: nvidia-smi gave no SM clock; issue shares not "
            "computed")
    for name, n, row, pick in sweep:
        models = shapes[name]
        bound = k2_bound_ms(models, n)[0]
        log("K2 sweep %s n=%5d (fill %.3f, picks %s; bound %.5f ms): %s"
            % (name, n, k2.fill(k2.launch_plan(models, n, sms)[0].entries,
                                n, sms), pick, bound,
               ", ".join("%s %.4f ms (FP64 issue %.1f%%)"
                         % (v, ms, 100 * share(models, n, k2.VARIANTS[v], ms,
                                               new_counts, clock))
                         for v, ms in row.items())))
    turns_out = {}
    for name, n, (p1, n1, n2, p2) in turns:
        models = shapes[name]
        lanes = k2.VARIANTS[k2.launch_plan(models, n, sms)[0].variant]
        log("K2 in turns %s n=%d: parent %.4f / %.4f ms, new %.4f / %.4f ms "
            "(parent, new, new, parent): %.2fx; FP64 issue parent %.1f%%, "
            "new %.1f%%; bound %.5f ms"
            % (name, n, p1, p2, n1, n2, min(p1, p2) / min(n1, n2),
               100 * share(models, n, 1, min(p1, p2), sass.get("parent"),
                           clock),
               100 * share(models, n, lanes, min(n1, n2), new_counts, clock),
               k2_bound_ms(models, n)[0]))
        turns_out["%s_n%d" % (name, n)] = {"parent_ms": [p1, p2],
                                           "ms": [n1, n2]}

    # in turns: the plain version, K2 (model 0, the group), K2 again, the
    # plain version again; a plain turn runs the 12 models one after
    # another, as hh_group_outputs_plain does, so it times model 0 and
    # the group at once
    x = xs[K2_CHECK_N.index(K2_TIMED_N)]
    plain_turns, kernel_turns = [], []
    for turn in range(4):
        if turn in (0, 3):
            per_model = _plain_model_ms(DEFAULT_MODELS, x)
            plain_turns.append({"model0": per_model[0],
                                "group": sum(per_model)})
        else:
            kernel_turns.append({
                name: _time_ms(lambda: k2.hh_group_outputs(models, x), 10)
                for name, models in shapes.items()})
    timed = {}
    for name, models in shapes.items():
        (t1, t2), (p1, p2) = ([t[name] for t in turns_]
                              for turns_ in (kernel_turns, plain_turns))
        bound, by, ops, nbytes = k2_bound_ms(models, K2_TIMED_N)
        ms = min(t1, t2)
        log("K2 timing %s n=%d: kernel %.4f / %.4f ms, plain %.1f / %.1f ms "
            "(plain, kernel, kernel, plain); bound %.4g GFLOP, %.4g MB -> "
            "%.5f ms (%s-bound), kernel at %.1f%% of it"
            % (name, K2_TIMED_N, t1, t2, p1, p2, ops / 1e9, nbytes / 1e6,
               bound, by, 100 * bound / ms))
        timed[name] = {"ms": ms, "plain_ms": min(p1, p2), "bound_ms": bound,
                       "bound_by": by,
                       "variant": k2.launch_plan(models, K2_TIMED_N,
                                                 sms)[0].variant}
    log("K2 check: %.3f s" % (time.perf_counter() - t_phase))
    g = timed["group"]
    return {"xs": xs, "refs": refs, "max_abs_err": max_abs,
            "bit_equal_share": same / total, "ms": g["ms"],
            "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
            "bound_by": g["bound_by"], "model0": timed["model0"],
            "sm_clock_mhz": clock, "in_turns": turns_out}


def k6_outputs(layout, dtype, k, rows, No, d, seed):
    """Model-major outputs (k, rows, No[, d]) on the card as an engine
    hands them to K6: the group engine's (rows, No, k[, d]) block moved
    model-major (strided) or the factored engine's stacked tensor;
    correlated models around an offset, a failing model on row 3, another
    on row 10 (an inf), every model on row 40."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    shape = (rows, No) + ((d,) if d > 1 else ())
    common = 3.0 + rng.standard_normal(shape)
    x = np.stack([common + 0.1 * (i + 1) * rng.standard_normal(shape)
                  for i in range(k)])
    x[0, 3 % rows] = np.nan
    x[k - 1, 10 % rows, 0] = np.inf
    if rows > 40:
        x[:, 40] = -np.inf
    x = torch.from_numpy(x)
    if layout == "group":
        return x.movedim(0, 2).contiguous().to(DEV, dtype).movedim(2, 0)
    return x.to(DEV, dtype).contiguous()


def k6_bound_ms(k, rows, No, d, itemsize):
    """K6's least time: each value of the chunk read once and the sums
    written once, at HBM_BYTES_PER_S (its one or two FP64 operations a sum
    and row stay under the FP64 rate's time to k = 12)."""
    from bluest_tpu_torch.ops.combine import per_output
    nbytes = itemsize * k * rows * No * d + 8 * No * (
        k * d + 2 * k * k + k * k * d)
    flops = 2.0 * rows * No * per_output(k, d) * d
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / OTHER_FLOPS[8])


def k6_holds(got, ref, where):
    """Within 1e-12 of the largest entry of each of ref's sums, and the
    failed rows' count equal; returns the largest relative difference."""
    worst = 0.0
    for name, g, r in zip(("se", "sc", "d1", "d2"), got[:4], ref[:4]):
        scale = max(float(r.abs().max()) if r.numel() else 0.0, 1e-300)
        err = float((g - r).abs().max()) / scale if r.numel() else 0.0
        if not err <= 1e-12:
            raise AssertionError("K6 %s: %s off the plain version by %.3e "
                                 "of its largest entry" % (where, name, err))
        worst = max(worst, err)
    if int(got[4]) != int(ref[4]):
        raise AssertionError("K6 %s: n_failed %d, plain %d"
                             % (where, int(got[4]), int(ref[4])))
    return worst


def phase_k6_check():
    """K6 against combine_plain on the card at K6_CHECK_* in both layouts
    and dtypes (the last five rows past N, each launch counted), at the
    flagship's chunk shapes (stacked, K6_FLAGSHIP_K models, BATCH rows,
    f32 and f64), at the cell's chunk shapes (two calls bit-equal), the
    running sums in place equal to add_sums of the chunks' own sums;
    then each timed shape at
    K6_CHUNK rows: K6 beside its bound and the plain version, in turns
    (plain, K6, K6, plain).  Returns the kernel line's numbers."""
    import torch
    from bluest_tpu_torch.models.diffusion import solve_diffusion_outputs
    from bluest_tpu_torch.ops import combine as k6
    from bluest_tpu_torch.sampling.engine import (add_sums, combine,
                                                  combine_plain)
    t0 = time.perf_counter()
    worst, checked = 0.0, 0
    flagship_no = solve_diffusion_outputs(
        torch.zeros(1, N_KL, dtype=torch.float64), GRIDS[-1], SIGMA,
        NU).shape[-1]
    for dtype in (torch.float32, torch.float64):
        for k in K6_FLAGSHIP_K:
            outs = k6_outputs("stacked", dtype, k, BATCH, flagship_no, 1,
                              BATCH + k)
            got = combine(outs, 0, BATCH - 5)
            worst = max(worst, k6_holds(
                got, combine_plain(outs, 0, BATCH - 5),
                "flagship %s k=%d No=%d rows=%d"
                % (dtype, k, flagship_no, BATCH)))
            checked += 1
    for layout in ("group", "stacked"):
        for dtype in (torch.float32, torch.float64):
            for k in K6_CHECK_K:
                for d in K6_CHECK_D:
                    for rows in K6_CHECK_ROWS:
                        outs = k6_outputs(layout, dtype, k, rows, 5, d,
                                          rows + k)
                        before = k6.combine_sums.launches
                        got = combine(outs, 3, rows - 2)
                        torch.cuda.synchronize()
                        if k6.combine_sums.launches != before + 1:
                            raise AssertionError("K6 did not launch once")
                        worst = max(worst, k6_holds(
                            got, combine_plain(outs, 3, rows - 2),
                            "%s %s k=%d d=%d rows=%d"
                            % (layout, dtype, k, d, rows)))
                        checked += 1
    for k, No, d in K6_TIMED:
        outs = k6_outputs("group", torch.float64, k, K6_CHUNK, No, d, k)
        a = combine(outs, 0, K6_CHUNK - 100)
        b = combine(outs, 0, K6_CHUNK - 100)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError("K6 k=%d: two calls differ" % k)
        worst = max(worst, k6_holds(a, combine_plain(outs, 0, K6_CHUNK - 100),
                                    "cell k=%d" % k))
        cuts = ((0, 100000), (100000, 200001), (200001, K6_CHUNK))
        acc = None
        for lo, hi in cuts:
            acc = combine(outs[:, lo:hi], lo, K6_CHUNK, acc)
        ref = None
        for lo, hi in cuts:
            ref = add_sums(ref, combine(outs[:, lo:hi], lo, K6_CHUNK))
        if not all(torch.equal(x, y) for x, y in zip(acc, ref)):
            raise AssertionError("K6 k=%d: the running sums in place differ "
                                 "from add_sums of the chunks'" % k)
    log("K6 check: %d shapes within 1e-12 of the plain version (largest "
        "%.3e), the cell's chunks bit-equal call to call and in place; "
        "%.2f s" % (checked + len(K6_TIMED), worst,
                    time.perf_counter() - t0))
    timed = {}
    for k, No, d in K6_TIMED:
        outs = k6_outputs("group", torch.float64, k, K6_CHUNK, No, d, k)
        key = "k%d_No%d_rows%d" % (k, No, K6_CHUNK)
        acc = combine(outs, 0, K6_CHUNK)
        run = {"plain": lambda: combine_plain(outs, 0, K6_CHUNK),
               "k6": lambda: combine(outs, 0, K6_CHUNK, acc)}
        turns = {"plain": [], "k6": []}
        for name in ("plain", "k6", "k6", "plain"):
            turns[name].append(_device_ms(run[name]))
        bound = k6_bound_ms(k, K6_CHUNK, No, d, 8)
        ms = statistics.median(turns["k6"])
        timed[key] = {"ms": round(ms, 5),
                      "plain_ms": round(statistics.median(turns["plain"]),
                                        5),
                      "bound_ms": round(bound, 5),
                      "share": round(bound / ms, 4),
                      "ms_turns": [round(v, 5) for v in turns["k6"]],
                      "plain_ms_turns": [round(v, 5)
                                         for v in turns["plain"]],
                      "host_us": round(1e3 * _host_ms(run["k6"]), 2),
                      "plain_host_us": round(1e3 * _host_ms(run["plain"]),
                                             2)}
        log("K6 %s: device %s ms a call (plain %s ms), bound %.5f ms "
            "(bytes at 3.35 TB/s), share %.1f%%; the host's dispatch %.1f us "
            "a call (plain %.1f us)"
            % (key, _turns(turns["k6"]),
               _turns(turns["plain"]), bound, 100 * bound / ms,
               timed[key]["host_us"], timed[key]["plain_host_us"]))
    main = timed["k1_No5_rows%d" % K6_CHUNK]
    return {"max_rel_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "timed": timed}


def _device_ms(fn, calls=20):
    """The card's busy time a call of ``fn``: the durations of the device
    items that ``calls`` calls run, from the profiler, over ``calls``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):          # a profile that caught no item is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        items = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if items:
            return sum(e.time_range.end - e.time_range.start
                       for e in items) / 1e3 / calls
    raise RuntimeError("the profiler saw no device items in three tries")


def _host_ms(fn, calls=200):
    """The host's time to dispatch a call of ``fn``: ``calls`` calls with
    no synchronisation between them (the card keeps up or queues), by the
    host's clock, over ``calls``."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / calls


@contextlib.contextmanager
def counting_k6(path, into):
    """K6's launches inside the block, added to ``into[path]``."""
    from bluest_tpu_torch.ops import combine as k6
    before = k6.combine_sums.launches
    try:
        yield
    finally:
        into[path] = into.get(path, 0) + k6.combine_sums.launches - before


def psd_work(kind, n, B):
    """The work of K3 (kind 3) or K4 (kind 4) on B blocks of n x n: Golub
    and Van Loan's flop counts, 4n^3/3 for the symmetric eigenvalues
    (tridiagonalization, then QR) and 12 n^3 for the SVD's sigma and U1
    (Golub-Reinsch, 14mn^2 - 2n^3 at m = n); each input read once and
    each output written once (K3: w and the status, K4: U, S and the
    status)."""
    ops = B * (4.0 * n ** 3 / 3.0 if kind == 3 else 12.0 * n ** 3)
    out = n * 8 + 4 if kind == 3 else n * n * 8 + n * 8 + 4
    return ops, B * (n * n * 8 + out)


def psd_bound_ms(kind, n, B):
    """The least time of K3's or K4's work: the larger of its operations
    over the card's FP64 rate outside the tensor cores and its bytes over
    HBM bandwidth (NVIDIA H100 SXM data sheet, 700 W)."""
    ops, nbytes = psd_work(kind, n, B)
    t_ops, t_bytes = ops / OTHER_FLOPS[8] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def psd_blocks(n, B, seed, kind):
    """B seeded test blocks of n x n (f64, on the card): symmetric for K3
    (kind 3), general for K4; every fourth at unit scale, the others
    scaled by 1e-150 ... 1e150, every fifth with repeated and zero
    eigenvalues (K3) or half its columns zero (K4)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, n, n))
    if kind == 3:
        X = (X + X.transpose(0, 2, 1)) / 2
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        lam = np.repeat(rng.standard_normal((n + 2) // 3), 3)[:n]
        lam[: n // 3] = 0.0
        X[::5] = Q @ np.diag(lam) @ Q.T
    else:
        X[::5] = X[::5] * (np.arange(n) % 2)
    scale = 10.0 ** rng.integers(-150, 151, B)
    scale[::4] = 1.0
    return torch.from_numpy(X * scale[:, None, None]).to("cuda")


def _psd_refs(plain, x):
    """The plain version's results on the card and on a host copy of the
    same inputs (LAPACK): (card, host), each on the card."""
    card = plain(x)
    host = plain(x.cpu())
    return card, tuple(t.to(x.device) for t in host)


def k3_holds(A, w, status, refs, where):
    """K3 against the plain version (torch.linalg.eigvalsh), ``refs`` its
    (card, host) eigenvalues: every status 0, each block's eigenvalues
    within 32 n eps ||A||_F of the host's (LAPACK), and of the card's
    (cuSOLVER) on the unit-scale blocks; cuSOLVER's eigvalsh is off the
    host's by up to ~0.1 ||A||_F on blocks near 1e-150 with repeated
    eigenvalues, so it is no reference there (measured beside).  Returns
    the largest difference from the host over ||A||_F, the largest
    absolute difference from the card's on the unit-scale blocks, and the
    card's plain version's largest difference from the host's over
    ||A||_F."""
    import torch
    n = A.shape[1]
    card, host = refs
    if not bool((status == 0).all()):
        raise AssertionError("K3 %s: statuses %s" % (where, status.tolist()))
    nrm = torch.clamp(torch.linalg.norm(A, dim=(1, 2)), min=1e-300)
    rel = ((w - host).abs().amax(dim=1) / nrm).max().item()
    unit = (w - card)[::4].abs().amax(dim=1)
    plain_off = ((card - host).abs().amax(dim=1) / nrm).max().item()
    if not (rel <= 32 * n * EPS64
            and bool((unit <= 32 * n * EPS64 * nrm[::4]).all())):
        raise AssertionError("K3 %s: eigenvalues off the host's by %.3g "
                             "||A||_F, off the card's at unit scale by %.3g"
                             % (where, rel, unit.max().item()))
    return rel, unit.max().item(), plain_off


def k4_holds(M, U, S, status, refs, where):
    """K4 against the plain version (torch.linalg.svd), ``refs`` its
    (card, host) singular values: every status 0, U orthogonal within
    32 n eps, U diag(S^2) U^T within 64 n eps ||M||_F^2 of M M^T, and the
    singular values within 32 n eps ||M||_F of the host's (LAPACK) and,
    on the unit-scale blocks, of the card's (cuSOLVER).  Returns the
    largest singular value difference from the host over ||M||_F, the
    largest absolute difference from the card's on the unit-scale
    blocks, and the card's plain version's largest difference from the
    host's over ||M||_F."""
    import torch
    n = M.shape[1]
    card, host = refs
    if not bool((status == 0).all()):
        raise AssertionError("K4 %s: statuses %s" % (where, status.tolist()))
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    orth = (U.mT @ U - eye).abs().max().item()
    nrm = torch.clamp(torch.linalg.norm(M, dim=(1, 2)), min=1e-300)
    Mn, Sn = M / nrm[:, None, None], S / nrm[:, None]
    rec = ((U * Sn[:, None, :] ** 2) @ U.mT - Mn @ Mn.mT).abs().max().item()
    rel = ((S - host).abs().amax(dim=1) / nrm).max().item()
    unit = (S - card)[::4].abs().amax(dim=1)
    plain_off = ((card - host).abs().amax(dim=1) / nrm).max().item()
    if not (orth <= 32 * n * EPS64 and rec <= 64 * n * EPS64
            and rel <= 32 * n * EPS64
            and bool((unit <= 32 * n * EPS64 * nrm[::4]).all())):
        raise AssertionError("K4 %s: U^T U - I %.3g, U S^2 U^T - M M^T "
                             "%.3g ||M||^2, singular values off the host's "
                             "by %.3g ||M||_F, off the card's at unit scale "
                             "by %.3g" % (where, orth, rec, rel,
                                          unit.max().item()))
    return rel, unit.max().item(), plain_off


def phase_psd_check(parent=None):
    """K3 and K4 against their plain versions (torch.linalg.eigvalsh and
    svd) on the same inputs, on the host and on the card (k3_holds,
    k4_holds), at every n of PSD_CHECK_N and batch of PSD_CHECK_B (seeded
    blocks at scales 1e-150 ... 1e150, repeated and zero eigenvalues,
    rank-deficient), each launch counted; a NaN block
    flagged (status 1, NaN results) and its neighbours unharmed; then
    each kernel's time at the IPM's batches and at 1024 blocks (K3_TIMED,
    K4_TIMED) beside its bound and the blocks' mean and largest sweeps
    (psd_sweeps): eager calls in turns with the plain version, the
    torch.linalg call (the library_ms) and, given ``parent`` (parent_psd's
    launchers), an earlier design (plain, torch.linalg, parent, kernel,
    kernel, parent, torch.linalg, plain); then 100 calls captured in one
    CUDA graph and replayed, as the IPM runs them, in turns with the
    parent's and with an empty kernel's (the launch floor), and the SM
    clock nvidia-smi reads meanwhile, from which the cycles a Jacobi
    round (graph time over the slowest block's rounds)."""
    import torch
    from bluest_tpu_torch.ops import psd_eig as k34
    t_phase = time.perf_counter()
    # the host wall of the process's first call of each kernel (CUDA
    # loads a module, and a kernel of it, at its first launch) and of the
    # second, at the flagship's n, each ended by a synchronise
    first = {}
    for key, fn, kind in (("K3", k34.sym_eigvalsh, 3), ("K4", k34.nt_svd, 4)):
        x = psd_blocks(11, 3, 5 + kind, kind)
        first[key] = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(x)
            torch.cuda.synchronize()
            first[key].append(1e3 * (time.perf_counter() - t0))
    log("K3/K4 first calls in the process (host wall, ms; first / second): "
        "K3 %.3f / %.3f, K4 %.3f / %.3f" % (*first["K3"], *first["K4"]))
    worst = {3: [0.0, 0.0, 0.0], 4: [0.0, 0.0, 0.0]}
    same_as_parent = []
    for n in PSD_CHECK_N:
        for B in PSD_CHECK_B:
            A = psd_blocks(n, B, 1000 * n + B, 3)
            before = k34.sym_eigvalsh.launches
            w, st = k34.sym_eigvalsh(A)
            if k34.sym_eigvalsh.launches != before + 1:
                raise AssertionError("K3 launch not counted")
            if parent:
                same_as_parent.append(torch.equal(w, parent["eigvalsh"](A)[0]))
            refs = [r[0] for r in _psd_refs(k34.sym_eigvalsh_plain, A)]
            got = k3_holds(A, w, st, refs, "n=%d B=%d" % (n, B))
            worst[3] = [max(a, b) for a, b in zip(worst[3], got)]
            M = psd_blocks(n, B, 1000 * n + B + 7, 4)
            before = k34.nt_svd.launches
            U, S, st = k34.nt_svd(M)
            if k34.nt_svd.launches != before + 1:
                raise AssertionError("K4 launch not counted")
            refs = [r[1] for r in _psd_refs(k34.nt_svd_plain, M)]
            got = k4_holds(M, U, S, st, refs, "n=%d B=%d" % (n, B))
            worst[4] = [max(a, b) for a, b in zip(worst[4], got)]
        # a NaN block between two finite ones
        A = psd_blocks(n, 3, n, 3)
        A[1, 0, n - 1] = float("nan")
        w, st = k34.sym_eigvalsh(A)
        U, S, st4 = k34.nt_svd(A)
        if not (st.tolist() == [0, 1, 0] and st4.tolist() == [0, 1, 0]
                and bool(w[1].isnan().all()) and bool(S[1].isnan().all())
                and bool(U[1].isnan().all())):
            raise AssertionError("n=%d: a NaN block gave statuses %s / %s"
                                 % (n, st.tolist(), st4.tolist()))
        two = A[::2].contiguous()
        k3_holds(two, w[::2], st[::2],
                 [r[0] for r in _psd_refs(k34.sym_eigvalsh_plain, two)],
                 "beside a NaN block")
    log("K3/K4 check: every block converged at n in %s, B in %s; K3 "
        "eigenvalues within %.3g ||A||_F of the plain version's on the host "
        "(LAPACK) and within %.3g absolute of its on the card at unit "
        "scale; K4 singular values within %.3g ||M||_F and %.3g; NaN blocks "
        "flagged.  The plain versions on the card (cuSOLVER) are "
        "off the host's by up to %.3g ||A||_F (eigvalsh) and %.3g ||M||_F "
        "(svd)"
        % (PSD_CHECK_N, PSD_CHECK_B, worst[3][0], worst[3][1], worst[4][0],
           worst[4][1], worst[3][2], worst[4][2]))
    if parent:
        log("K3's eigenvalues bit-equal to the parent source's at %d of %d "
            "check shapes" % (sum(same_as_parent), len(same_as_parent)))
    timed = {}
    lib = k34.build_library()
    for kind, shapes in ((3, K3_TIMED), (4, K4_TIMED)):
        fn, plain, libcall = (
            (k34.sym_eigvalsh, k34.sym_eigvalsh_plain, torch.linalg.eigvalsh)
            if kind == 3 else (k34.nt_svd, k34.nt_svd_plain,
                               torch.linalg.svd))
        old = parent and parent["eigvalsh" if kind == 3 else "svd"]
        for name, n, B in shapes:
            x = psd_blocks(n, B, 7 * n + B, kind)
            sweeps = psd_sweeps(kind, x)
            reps = 50 if B < 1024 else 10
            counts = (fn.launches, fn.captured)
            with smi_sampler() as smi:
                eager = {k: [] for k in ("plain", "library", "parent",
                                         "kernel")}
                order = ["plain", "library"] + (["parent"] if old else [])
                calls = {"plain": lambda: plain(x), "library":
                         lambda: libcall(x), "parent": lambda: old(x),
                         "kernel": lambda: fn(x)}
                for key in order + ["kernel", "kernel"] + order[::-1]:
                    eager[key].append(_time_ms(calls[key], reps))

                def floor():
                    rc = lib.bluest_psd_empty(
                        B, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError("empty kernel: CUDA error %d" % rc)
                graphs = {k: [] for k in ("kernel", "parent", "floor")}
                gorder = ["kernel"] + (["parent"] if old else []) + ["floor"]
                gcalls = {"kernel": calls["kernel"], "parent": calls["parent"],
                          "floor": floor}
                for key in gorder + gorder[::-1]:
                    graphs[key].append(_graph_ms(gcalls[key]))
            fn.launches, fn.captured = counts
            clock = (statistics.median(c for c, _, _ in smi) if smi
                     else float("nan"))
            bound, by = psd_bound_ms(kind, n, B)
            ms, graph_ms = min(eager["kernel"]), min(graphs["kernel"])
            rounds = sweeps["max"] * (n + (n & 1) - 1)
            cycles = ((graph_ms - min(graphs["floor"])) * 1e-3 * clock * 1e6
                      / max(rounds, 1))
            log("K%d timing %s n=%d B=%d (sweeps a block: mean %.2f, most "
                "%d; %d rounds): eager kernel %s ms, parent %s, "
                "torch.linalg %s, plain %s (plain, torch.linalg, parent, "
                "kernel, kernel, parent, torch.linalg, plain); 100 calls in "
                "one CUDA graph: kernel %s ms a call, parent %s, "
                "empty kernel %s (the launch floor; kernel, parent, empty, "
                "empty, parent, kernel); SM clock %.0f MHz: %.0f cycles a "
                "round; bound %.6f ms (%s), kernel at %.3f%% of it"
                % (kind, name, n, B, sweeps["mean"], sweeps["max"], rounds,
                   _turns(eager["kernel"]), _turns(eager["parent"]),
                   _turns(eager["library"]), _turns(eager["plain"]),
                   _turns(graphs["kernel"]), _turns(graphs["parent"]),
                   _turns(graphs["floor"]), clock, cycles, bound, by,
                   100 * bound / ms))
            timed["K%d_%s_n%d_B%d" % (kind, name, n, B)] = {
                "ms": ms, "graph_ms": graph_ms,
                "launch_floor_ms": min(graphs["floor"]),
                "parent_ms": min(eager["parent"]) if old else None,
                "parent_graph_ms": min(graphs["parent"]) if old else None,
                "plain_ms": min(eager["plain"]),
                "library_ms": min(eager["library"]),
                "eager_turns": eager, "graph_turns": graphs,
                "bound_ms": bound, "bound_by": by,
                "mean_sweeps": sweeps["mean"], "max_sweeps": sweeps["max"],
                "sm_clock_mhz": clock, "cycles_per_round": cycles}
    log("K3/K4 check: %.3f s" % (time.perf_counter() - t_phase))

    def line(kind, key):
        t = timed[key]
        return {"max_abs_err": worst[kind][1], "max_err_over_norm":
                worst[kind][0], "plain_card_err_over_norm": worst[kind][2],
                "ms": t["ms"], "graph_ms": t["graph_ms"],
                "launch_floor_ms": t["launch_floor_ms"],
                "parent_ms": t["parent_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"],
                "mean_sweeps": t["mean_sweeps"], "timed_at": key,
                "first_call_ms": first["K%d" % kind],
                "timed": {k: {f: v for f, v in r.items()
                              if not f.endswith("_turns")}
                          for k, r in timed.items()
                          if k.startswith("K%d" % kind)}}
    return {"K3": line(3, "K3_flagship_n11_B12"),
            "K4": line(4, "K4_flagship_n11_B3")}


def k5_work(kind, n, B):
    """The work of K5's sym_eigh (kind 5) or pinv00 (kind 6) on B blocks
    of n x n, from Golub and Van Loan's flop counts: sym_eigh ~9 n^3 a
    block for the symmetric eigenvalues with their vectors
    (tridiagonalization with Q, then QR); pinv00 needs the eigenvalues
    (4 n^3/3) and only e0^T V, one row of the 4 n^3/3 that form Q and of
    the 6 n^3 that accumulate QR's rotations into it (4 n^2/3 + 6 n^2),
    plus the cut and the sum (3 n).  Each input read once and each output
    written once (sym_eigh: w, V and the status, pinv00: var and the
    status)."""
    if kind == 5:
        return B * 9.0 * n ** 3, B * (n * n * 8 + n * 8 + n * n * 8 + 4)
    ops = 4.0 * n ** 3 / 3.0 + 22.0 * n ** 2 / 3.0 + 3.0 * n
    return B * ops, B * (n * n * 8 + 8 + 4)


def k5_bound_ms(kind, n, B):
    """The least time of K5's work: its operations over the card's FP64
    rate outside the tensor cores or its bytes over HBM bandwidth,
    whichever is larger (NVIDIA H100 SXM data sheet, 700 W)."""
    ops, nbytes = k5_work(kind, n, B)
    t_ops, t_bytes = ops / OTHER_FLOPS[8] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def k5_eigh_holds(A, w, V, status, w3, refs, where):
    """K5's sym_eigh against its plain version (torch.linalg.eigh),
    ``refs`` its (card, host) (w, V): every status 0; w bit-equal to K3's
    eigenvalues ``w3`` on the same blocks (K5 is K3 with its rotations
    accumulated); w within 32 n eps ||A||_F of the host's (LAPACK) on
    every block and of the card's (cuSOLVER) on the unit-scale ones;
    ||V^T V - I||_F <= 32 n eps and ||V diag(w) V^T - A||_F <= 64 n eps
    ||A||_F.  Returns the largest eigenvalue difference from the host
    over ||A||_F, the largest absolute one from the card's at unit scale,
    the orthogonality and reconstruction errors, and cuSOLVER's
    eigenvalue difference from LAPACK over ||A||_F and its own
    reconstruction error."""
    import torch
    n = A.shape[1]
    (cw, cV), (hw, _) = refs
    if not bool((status == 0).all()):
        raise AssertionError("K5 sym_eigh %s: statuses %s"
                             % (where, status.tolist()))
    if not torch.equal(w, w3):
        raise AssertionError("K5 sym_eigh %s: eigenvalues not K3's bit for "
                             "bit" % where)
    nrm = torch.clamp(torch.linalg.norm(A, dim=(1, 2)), min=1e-300)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)

    def rec_of(w, V):
        wn = w / nrm[:, None]
        return (torch.linalg.norm((V * wn[:, None, :]) @ V.mT
                                  - A / nrm[:, None, None], dim=(1, 2))
                .max().item())
    rel = ((w - hw).abs().amax(dim=1) / nrm).max().item()
    unit = (w - cw)[::4].abs().amax(dim=1)
    orth = torch.linalg.norm(V.mT @ V - eye, dim=(1, 2)).max().item()
    rec = rec_of(w, V)
    plain_off = ((cw - hw).abs().amax(dim=1) / nrm).max().item()
    if not (rel <= 32 * n * EPS64 and orth <= 32 * n * EPS64
            and rec <= 64 * n * EPS64
            and bool((unit <= 32 * n * EPS64 * nrm[::4]).all())):
        raise AssertionError("K5 sym_eigh %s: eigenvalues off the host's by "
                             "%.3g ||A||_F, off the card's at unit scale by "
                             "%.3g; ||V^T V - I|| %.3g, ||V w V^T - A|| %.3g "
                             "||A||" % (where, rel, unit.max().item(), orth,
                                        rec))
    return rel, unit.max().item(), orth, rec, plain_off, rec_of(cw, cV)


def k5_pinv_holds(A, var, status, refs, rcond, where):
    """K5's pinv00 against its plain version, ``refs`` its (card, host)
    variances: every status 0; |var - host| <= 64 n eps kappa
    sum_j |v0_j^2 / w_j| on every block and the same against the card's
    on the unit-scale ones, with kappa = max|w| / min kept |w| and the
    sum over the kept eigenvalues (|var| for a positive semidefinite
    block), both from the host's eigendecomposition; blocks with an
    eigenvalue within 1e-3 relative of the cutoff, where either side may
    keep it, are left out and counted.  Returns the largest difference
    over its bound (host, card), the blocks left out, the largest
    difference from the host over sum |terms| and the largest absolute
    difference from the card's at unit scale."""
    import torch
    n = A.shape[1]
    card, host = refs
    if not bool((status == 0).all()):
        raise AssertionError("K5 pinv00 %s: statuses %s"
                             % (where, status.tolist()))
    hw, hV = torch.linalg.eigh(A.cpu())
    aw = hw.abs()
    cutoff = rcond * aw.amax(dim=1, keepdim=True)
    keep = aw > cutoff
    near = ((aw - cutoff).abs() <= 1e-3 * cutoff).any(dim=1)
    kept = torch.where(keep, aw, torch.full_like(aw, float("inf")))
    kappa = aw.amax(dim=1) / kept.amin(dim=1)
    v0 = hV[:, 0, :]
    mag = torch.where(keep, v0 * v0 / aw, torch.zeros_like(aw)).sum(dim=1)
    bound = (64 * n * EPS64 * kappa * mag).to(A.device)
    far = ~near.to(A.device)
    d_host = (var - host).abs()
    d_card = (var - card).abs()[::4]
    r_host = (d_host / torch.clamp(bound, min=1e-300))[far].max().item() \
        if bool(far.any()) else 0.0
    unit = far[::4]
    r_card = ((d_card / torch.clamp(bound[::4], min=1e-300))[unit].max()
              .item() if bool(unit.any()) else 0.0)
    if not (r_host <= 1.0 and r_card <= 1.0):
        raise AssertionError("K5 pinv00 %s: off the host's by %.3g of its "
                             "bound, off the card's at unit scale by %.3g"
                             % (where, r_host, r_card))
    rel = ((d_host / torch.clamp(mag.to(A.device), min=1e-300))[far].max()
           .item() if bool(far.any()) else 0.0)
    abs_card = d_card[unit].max().item() if bool(unit.any()) else 0.0
    return r_host, r_card, int(near.sum()), rel, abs_card


def phase_k5_check():
    """K5 (sym_eigh and pinv00, csrc/psd_eig.cu) against its plain
    versions (torch.linalg.eigh, and for pinv00 its cutoff and sum) on
    the same inputs, on a host copy (LAPACK) at every scale and on the
    card (cuSOLVER) at unit scale (k5_eigh_holds, k5_pinv_holds), at every
    K5_CHECK shape (psd_blocks: scales 1e-150 ... 1e150, repeated and
    zero eigenvalues), each launch counted, sym_eigh's eigenvalues
    bit-equal to K3's; a NaN block flagged; how far cuSOLVER's eigh is
    from LAPACK there; then each at K5_TIMED beside its bound and the
    blocks' sweeps: eager in turns with the plain version and
    torch.linalg.eigh (plain, torch.linalg, kernel, kernel, torch.linalg,
    plain), and as 100 calls in one CUDA graph beside an empty kernel's
    (kernel, empty, empty, kernel), with the cycles a Jacobi round at the
    SM clock nvidia-smi reads."""
    import torch
    from bluest_tpu_torch.ops import psd_eig as k5
    t_phase = time.perf_counter()
    first = {}
    for key, fn in (("sym_eigh", k5.sym_eigh),
                    ("pinv00", lambda x: k5.pinv00(x, K5_RCOND))):
        x = psd_blocks(10, 3, 15, 3)
        first[key] = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(x)
            torch.cuda.synchronize()
            first[key].append(1e3 * (time.perf_counter() - t0))
    log("K5 first calls in the process (host wall, ms; first / second): "
        "sym_eigh %.3f / %.3f, pinv00 %.3f / %.3f"
        % (*first["sym_eigh"], *first["pinv00"]))
    worst = {"eigh": [0.0] * 6, "pinv": [0.0, 0.0, 0, 0.0, 0.0]}
    for n in K5_CHECK_N:
        for B in K5_CHECK_B:
            if B * n * n > K5_CHECK_MAX:
                continue
            A = psd_blocks(n, B, 2000 * n + B, 3)
            before = (k5.sym_eigh.launches, k5.pinv00.launches)
            w, V, st = k5.sym_eigh(A)
            var, st6 = k5.pinv00(A, K5_RCOND)
            if (k5.sym_eigh.launches, k5.pinv00.launches) != (
                    before[0] + 1, before[1] + 1):
                raise AssertionError("K5 launch not counted")
            w3, _ = k5.sym_eigvalsh(A)
            card = k5.sym_eigh_plain(A)
            host = k5.sym_eigh_plain(A.cpu())
            refs = ((card[0], card[1]),
                    tuple(t.to(A.device) for t in host[:2]))
            got = k5_eigh_holds(A, w, V, st, w3, refs, "n=%d B=%d" % (n, B))
            worst["eigh"] = [max(a, b) for a, b in zip(worst["eigh"], got)]
            prefs = (k5.pinv00_plain(A, K5_RCOND)[0],
                     k5.pinv00_plain(A.cpu(), K5_RCOND)[0].to(A.device))
            got = k5_pinv_holds(A, var, st6, prefs, K5_RCOND,
                                "n=%d B=%d" % (n, B))
            near = worst["pinv"][2] + got[2]       # blocks left out, summed
            worst["pinv"] = [max(a, b) for a, b in zip(worst["pinv"], got)]
            worst["pinv"][2] = near
        A = psd_blocks(n, 3, n + 1, 3)
        A[1, n - 1, 0] = float("nan")
        w, V, st = k5.sym_eigh(A)
        var, st6 = k5.pinv00(A, K5_RCOND)
        if not (st.tolist() == st6.tolist() == [0, 1, 0]
                and bool(w[1].isnan().all()) and bool(V[1].isnan().all())
                and bool(var[1].isnan())
                and not bool(w[::2].isnan().any())
                and not bool(var[::2].isnan().any())):
            raise AssertionError("K5 n=%d: a NaN block gave statuses %s / %s"
                                 % (n, st.tolist(), st6.tolist()))
    log("K5 check: every block converged at n in %s, B in %s (B n^2 <= %d); "
        "sym_eigh's eigenvalues bit-equal to K3's, within %.3g ||A||_F of "
        "the plain version's on the host (LAPACK) and %.3g absolute of its "
        "on the card at unit scale, ||V^T V - I||_F <= %.3g, ||V w V^T - "
        "A||_F <= %.3g ||A||_F; pinv00 within %.3g (host) and %.3g (card) of "
        "its bound 64 n eps kappa sum|v0^2/w|, %.3g of sum|v0^2/w| from the "
        "host's, %d blocks near the cutoff left out; NaN blocks flagged.  "
        "cuSOLVER's eigh on the card is off LAPACK by up to %.3g ||A||_F "
        "(eigenvalues) and reconstructs A within %.3g ||A||_F"
        % (K5_CHECK_N, K5_CHECK_B, K5_CHECK_MAX, worst["eigh"][0],
           worst["eigh"][1], worst["eigh"][2], worst["eigh"][3],
           worst["pinv"][0], worst["pinv"][1], worst["pinv"][3],
           worst["pinv"][2], worst["eigh"][4], worst["eigh"][5]))
    lib = k5.build_library()
    timed = {}
    for kind, name, fn, plain in (
            (5, "sym_eigh", k5.sym_eigh, k5.sym_eigh_plain),
            (6, "pinv00", lambda x: k5.pinv00(x, K5_RCOND),
             lambda x: k5.pinv00_plain(x, K5_RCOND))):
        counter = k5.sym_eigh if kind == 5 else k5.pinv00
        for n, B in K5_TIMED:
            x = psd_blocks(n, B, 9 * n + B, 3)
            sweeps = psd_sweeps(kind, x)
            reps = 50 if B < 1024 else 10
            counts = (counter.launches, counter.captured)
            with smi_sampler() as smi:
                eager = {k: [] for k in ("plain", "library", "kernel")}
                calls = {"plain": lambda: plain(x),
                         "library": lambda: torch.linalg.eigh(x),
                         "kernel": lambda: fn(x)}
                for key in ("plain", "library", "kernel", "kernel",
                            "library", "plain"):
                    eager[key].append(_time_ms(calls[key], reps))

                def floor():
                    rc = lib.bluest_psd_empty(
                        B, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError("empty kernel: CUDA error %d" % rc)
                graphs = {"kernel": [], "floor": []}
                for key in ("kernel", "floor", "floor", "kernel"):
                    graphs[key].append(_graph_ms(
                        calls["kernel"] if key == "kernel" else floor,
                        calls=100 if B < 8192 else 20))
            counter.launches, counter.captured = counts
            clock = (statistics.median(c for c, _, _ in smi) if smi
                     else float("nan"))
            bound, by = k5_bound_ms(kind, n, B)
            ms, graph_ms = min(eager["kernel"]), min(graphs["kernel"])
            rounds = sweeps["max"] * (n + (n & 1) - 1)
            cycles = ((graph_ms - min(graphs["floor"])) * 1e-3 * clock * 1e6
                      / max(rounds, 1))
            log("K5 %s timing n=%d B=%d (sweeps a block: mean %.2f, most %d; "
                "%d rounds): eager kernel %s ms, torch.linalg.eigh %s, plain "
                "%s (plain, torch.linalg.eigh, kernel, kernel, "
                "torch.linalg.eigh, plain); in one CUDA graph: kernel %s ms "
                "a call, empty kernel %s (the launch floor; kernel, empty, "
                "empty, kernel); SM clock %.0f MHz: %.0f cycles a round; "
                "bound %.6f ms (%s), kernel at %.4f%% of it"
                % (name, n, B, sweeps["mean"], sweeps["max"], rounds,
                   _turns(eager["kernel"]), _turns(eager["library"]),
                   _turns(eager["plain"]), _turns(graphs["kernel"]),
                   _turns(graphs["floor"]), clock, cycles, bound, by,
                   100 * bound / ms))
            timed["%s_n%d_B%d" % (name, n, B)] = {
                "ms": ms, "graph_ms": graph_ms,
                "launch_floor_ms": min(graphs["floor"]),
                "plain_ms": min(eager["plain"]),
                "library_ms": min(eager["library"]),
                "bound_ms": bound, "bound_by": by,
                "mean_sweeps": sweeps["mean"], "max_sweeps": sweeps["max"],
                "sm_clock_mhz": clock, "cycles_per_round": cycles,
                "eager_turns": eager, "graph_turns": graphs}
    log("K5 check: %.3f s" % (time.perf_counter() - t_phase))

    def line(name, key):
        t = timed[key]
        errs = ({"max_abs_err": worst["eigh"][1],
                 "max_err_over_norm": worst["eigh"][0],
                 "orthogonality": worst["eigh"][2],
                 "reconstruction": worst["eigh"][3],
                 "plain_card_err_over_norm": worst["eigh"][4]}
                if name == "sym_eigh" else
                {"max_abs_err": worst["pinv"][4],
                 "max_err_over_sum": worst["pinv"][3],
                 "max_err_over_bound": max(worst["pinv"][:2]),
                 "near_cutoff_left_out": worst["pinv"][2]})
        return errs | {
            k: t[k] for k in ("ms", "graph_ms", "launch_floor_ms",
                              "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "mean_sweeps")} | {
            "timed_at": key, "first_call_ms": first[name],
            "timed": {k: {f: v for f, v in r.items()
                          if not f.endswith("_turns")}
                      for k, r in timed.items() if k.startswith(name)}}
    return {"sym_eigh": line("sym_eigh", "sym_eigh_n11_B1"),
            "pinv00": line("pinv00", "pinv00_n10_B8192")}


def _turns(values):
    """Times taken in turns, as ' / '-joined ms (or '-' if none)."""
    return " / ".join("%.4f" % v for v in values) if values else "-"


def _graph_ms(fn, calls=100, replays=5):
    """ms a call of ``fn`` when ``calls`` calls are captured in one CUDA
    graph and the graph is replayed ``replays`` times (CUDA events)."""
    import torch
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def psd_launcher(lib, kind, x):
    """A launch of ``lib``'s K3 (kind 3), K4 (kind 4) or K5 (5: sym_eigh,
    6: pinv00 at K5_RCOND) on ``x`` into outputs of its own, with the
    sweeps of each block, on the current stream; counted nowhere
    (measurement only).  Returns (call, (values, status, sweeps)), values
    the eigenvalues, the singular values or pinv00's variances."""
    import torch
    B, n = x.shape[0], x.shape[1]
    dev = x.device
    st = torch.empty(B, dtype=torch.int32, device=dev)
    sw = torch.empty(B, dtype=torch.int32, device=dev)
    work = torch.empty(B * lib.bluest_psd_work_doubles(kind, n),
                       dtype=torch.float64, device=dev)
    vals = torch.empty((B, n) if kind != 6 else B, dtype=torch.float64,
                       device=dev)
    U = torch.empty((B, n, n) if kind in (4, 5) else 0, dtype=torch.float64,
                    device=dev)

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        if kind == 3:
            rc = lib.bluest_sym_eigvalsh_f64(
                x.data_ptr(), vals.data_ptr(), st.data_ptr(), sw.data_ptr(),
                work.data_ptr(), B, n, stream)
        elif kind == 4:
            rc = lib.bluest_nt_svd_f64(
                x.data_ptr(), U.data_ptr(), vals.data_ptr(), st.data_ptr(),
                sw.data_ptr(), work.data_ptr(), B, n, stream)
        elif kind == 5:
            rc = lib.bluest_sym_eigh_f64(
                x.data_ptr(), vals.data_ptr(), U.data_ptr(), st.data_ptr(),
                sw.data_ptr(), work.data_ptr(), B, n, stream)
        else:
            rc = lib.bluest_pinv00_f64(
                x.data_ptr(), vals.data_ptr(), st.data_ptr(), sw.data_ptr(),
                work.data_ptr(), K5_RCOND, B, n, stream)
        if rc != 0:
            raise RuntimeError("kind %d at n=%d B=%d: CUDA error %d"
                               % (kind, n, B, rc))
    return call, (vals, st, sw)


def psd_sweeps(kind, x):
    """The mean and largest sweeps a block of ``x`` takes in K3 (kind 3),
    K4 (kind 4) or K5 (5, 6), from the package library's measurement
    output."""
    from bluest_tpu_torch.ops import psd_eig as k34
    call, (_, st, sw) = psd_launcher(k34.build_library(), kind, x)
    call()
    if not bool((st == 0).all()):
        raise AssertionError("K%d sweeps at n=%d B=%d: statuses %s"
                             % (kind, x.shape[1], x.shape[0], st.tolist()))
    return {"mean": sw.double().mean().item(), "max": int(sw.max().item())}


PSD_KERNELS = ("sym_eigvalsh", "nt_svd", "sym_eigh", "pinv00")
# K3/K4/K5 launches of the paths that phases 5 and 6(d) drive, for the
# kernel line (phases 4 and 11 return theirs)
PSD_PATHS = {}


def psd_launches():
    """K3's, K4's and K5's launch counts (eager calls plus graph
    replays)."""
    from bluest_tpu_torch.ops import psd_eig as k35
    return {k: getattr(k35, k).launches for k in PSD_KERNELS}


def reset_psd_launches():
    from bluest_tpu_torch.ops import psd_eig as k35
    for k in PSD_KERNELS:
        getattr(k35, k).launches = 0


def _total_samples(problem):
    return int(sum(int(n) for n in problem.MOSAP_output["samples"]))


def _both_paths(problem, budget, smi, graph):
    """The same allocation through solve() (dispatch all groups, fetch
    once) and through a loop of blue_fn calls (one fetch per group), in
    one process, alternating: sample_s of each, and the sums of the two
    from the same call counters, which must be bit-equal (two problems
    loaded from the saved graph, so both count their calls from 0)."""
    import numpy as np
    import torch
    out = problem.MOSAP_output
    groups = [list(g) for g in out["flattened_groups"]]
    ns = [int(n) for n in out["samples"]]

    def per_group(p=problem):
        return [p.blue_fn(g, n, verbose=False)[0] if n > 0 else None
                for g, n in zip(groups, ns)]

    a = _flagship_from_graph(graph)._pipelined_sumse(groups, ns)
    b = per_group(_flagship_from_graph(graph))
    same = all((x is None and y is None)
               or np.array_equal(np.array(x), np.array(y))
               for x, y in zip(a, b))
    if not same:
        raise AssertionError("the pipelined sums differ from the per-group "
                             "path's from the same call counter")
    # solve() also assembles the BLUE estimators on the host, which the
    # loop does not: the fetch alone (_pipelined_sumse) is timed beside them
    times = {"solve": [], "one fetch": [], "blue_fn loop": []}
    for _ in range(PATH_REPS):
        for name, run in (
                ("solve", lambda: problem.solve(K=K, budget=budget,
                                                verbose=False)),
                ("one fetch", lambda: problem._pipelined_sumse(groups, ns)),
                ("blue_fn loop", per_group)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        log("sample_s through %-12s: median %.6f s, min %.6f, max %.6f over "
            "%d runs of %d active groups (%s)"
            % (name, statistics.median(ts), min(ts), max(ts), len(ts),
               sum(n > 0 for n in ns), smi))
    log("pipelined and per-group sums bit-equal over %d groups"
        % sum(n > 0 for n in ns))
    # what the chunk-keyed streams cost the host: one derived seed and one
    # re-seeding of the card's generator per chunk
    from bluest_tpu_torch.sampling.engine import generator_seed
    import math
    gen = torch.Generator(device=problem.device)
    reps = 2000
    t0 = time.perf_counter()
    for c in range(reps):
        gen.manual_seed(generator_seed(0, 1, c))
    per_chunk = (time.perf_counter() - t0) / reps
    chunks = sum(math.ceil(n / BATCH) for n in ns)
    log("chunk-keyed streams: %.2f us per chunk to derive a seed and re-seed "
        "the generator, %d chunks a solve = %.3f ms of its sample_s"
        % (per_chunk * 1e6, chunks, per_chunk * chunks * 1e3))


def _calibrated_allocation(problem):
    """setup_solver(K) with the budget calibrated to ~TARGET_SAMPLES
    samples as bench.py:211-231 does (up to four continuous set-ups, then
    the integer one); returns the budget and the wall of all of it."""
    t0 = time.perf_counter()
    budget = 2.0e4
    problem.setup_solver(K=K, budget=budget, continuous_relaxation=True)
    for _ in range(3):
        n0 = _total_samples(problem)
        if 0.85 <= n0 / TARGET_SAMPLES <= 1.15:
            break
        budget = budget * TARGET_SAMPLES / max(n0, 1)
        problem.setup_solver(K=K, budget=budget, continuous_relaxation=True)
    problem.setup_solver(K=K, budget=budget)
    return budget, time.perf_counter() - t0


def phase_flagship(smi, graph):
    """The bench.py flagship through the port's public entry points, on
    the default sampling device; its graph (covariances and costs) is
    saved to ``graph`` for the phases that load it without a pilot."""
    import math
    import numpy as np
    import torch
    from bluest_tpu_torch.models.diffusion import (DiffusionProblem,
                                                   solve_diffusion_outputs)
    from bluest_tpu_torch.ops import diffusion as k1

    t0 = time.perf_counter()
    problem = DiffusionProblem(
        grids=GRIDS, n_kl=N_KL, sigma=SIGMA, nu=NU, multi_output=True,
        covariance_estimation_samples=PILOT, dtype=torch.float32,
        device_batch_size=BATCH, verbose=False)
    torch.cuda.synchronize()
    if problem.device.type != "cuda":
        raise AssertionError("the default sampling device is %s, not the "
                             "card" % problem.device)
    log("pilot (%d samples x %d models) + SPD projection: %.3f s"
        % (PILOT, len(GRIDS), time.perf_counter() - t0))

    # the problem's model path (mask + K1, f32) against the model-level
    # reference formulation on a small input, in the f32 error class of
    # the reference's own f32 run (these launches are not the main path's)
    gen = torch.Generator(device="cuda").manual_seed(1)
    xi = problem.sample_inputs(gen, 256)
    for l in range(len(GRIDS)):
        got = problem.evaluate_model(l, xi).double()
        mask = (torch.arange(N_KL, device="cuda") < problem.n_modes[l])
        xm = xi * mask
        ref = solve_diffusion_outputs(xm.double(), GRIDS[l], SIGMA, NU)
        inc = solve_diffusion_outputs(xm, GRIDS[l], SIGMA, NU).double()
        rel = ((got - ref).abs() / (ref.abs() + 1e-9)).cpu().numpy()
        rel_inc = ((inc - ref).abs() / (ref.abs() + 1e-9)).cpu().numpy()
        if not (got.shape == (256, 3)
                and np.median(rel) <= 10 * np.median(rel_inc) + 1e-6
                and rel.max() <= 10 * rel_inc.max() + 1e-5):
            raise AssertionError(
                "model %d vs the f64 reference: median %.3e max %.3e "
                "(f32 reference %.3e / %.3e)" % (l, np.median(rel), rel.max(),
                                                  np.median(rel_inc),
                                                  rel_inc.max()))
    log("model path (mask + K1, f32) within the f32 error class of the "
        "f64 reference for all %d models" % len(GRIDS))

    # the allocation's interior-point solves go through K3 and K4 (their
    # counts set to 0 just before and read just after)
    reset_psd_launches()
    first = {}
    with setup_probes(first):
        budget, alloc_s = _calibrated_allocation(problem)
    k34 = psd_launches()
    # the same calibrated set-up again, in a process that has run one: a
    # fresh MOSAP and an empty warm cache, as the first had
    from bluest_tpu_torch.solvers import sdp
    sdp._WARM_CACHE.clear()
    problem._mosap_key = None
    steady = {}
    with setup_probes(steady):
        _calibrated_allocation(problem)
    for what, rec in (("the process's first", first),
                      ("the same again (steady)", steady)):
        log("allocation set-up, %s: %s" % (what, _probe_summary(rec)))
    L = problem.MOSAP.L
    certs = problem.MOSAP_output["certificates"]
    log("allocation: L=%d, budget %.6g, %d samples, %.3f s, certificates %s;"
        " K3 launches %d, K4 launches %d, K5 launches: pinv00 %d, sym_eigh %d"
        % (L, budget, _total_samples(problem), alloc_s,
           [(c["form"], c["status"], c["iterations"]) for c in certs],
           k34["sym_eigvalsh"], k34["nt_svd"], k34["pinv00"],
           k34["sym_eigh"]))
    if not (k34["sym_eigvalsh"] > 0 and k34["nt_svd"] > 0
            and k34["pinv00"] > 0):
        raise AssertionError("the card's allocation launched K3, K4 and "
                             "K5's pinv00 %s times" % k34)
    if L != 385:
        raise AssertionError("expected L=385 groups, got %d" % L)
    if not certs or any(c["status"] not in ("optimal", "inaccurate")
                        for c in certs):
        raise AssertionError("IPM certificate not ok: %s" % certs)

    # estimation: every model evaluation must go through K1
    out = problem.MOSAP_output
    active = [(g, int(n)) for g, n in zip(out["flattened_groups"],
                                          out["samples"]) if n > 0]
    chunk_evals = sum(len(g) * math.ceil(n / BATCH) for g, n in active)
    n_evals = sum(len(g) * n for g, n in active)
    k1.diffusion_outputs.launches = 0
    t0 = time.perf_counter()
    mus, errs, cost = problem.solve(K=K, budget=budget)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    launches = k1.diffusion_outputs.launches
    mus = np.asarray(mus, dtype=float)
    errs = np.asarray(errs, dtype=float)
    rel_err = float(np.max(errs) / abs(mus[0]))
    log("estimation: %d active groups, %d samples, %d model evaluations in "
        "%.3f s = %.0f evals/s; K1 launches %d (chunk evaluations %d)"
        % (len(active), sum(n for _, n in active), n_evals, sample_s,
           n_evals / sample_s, launches, chunk_evals))
    log("mus", mus.tolist(), "errs", errs.tolist(), "max_rel_err %.4g"
        % rel_err)
    if not (np.all(np.isfinite(mus)) and np.all(np.isfinite(errs))):
        raise AssertionError("non-finite estimates")
    if not rel_err < 0.01:
        raise AssertionError("max(errs)/|mus[0]| = %.4g >= 0.01" % rel_err)
    # q_energy = int a u'^2 = int u = q_int for -(a u')' = 1
    if not abs(mus[2] - mus[0]) <= 4 * float(np.max(errs)):
        raise AssertionError("q_energy and q_int estimates disagree")
    if launches < chunk_evals or launches == 0:
        raise AssertionError("K1 launched %d times for %d chunk evaluations"
                             % (launches, chunk_evals))
    problem.save_graph_data(graph)
    _both_paths(problem, budget, smi, graph)
    return {"launches": launches, "alloc_s": alloc_s, "sample_s": sample_s,
            "psd_launches": k34, "alloc_split": {
                "first": _probe_record(first),
                "steady": _probe_record(steady)},
            "n_evals": n_evals, "problem": problem, "budget": budget,
            "mus": mus, "errs": errs,
            "eps_star": float(np.sqrt(max(out["variances"])))}


def _chunk_evals(groups, ns):
    """K1 launches a path needs at least: one per model per chunk."""
    import math
    return sum(len(g) * math.ceil(int(n) / BATCH)
               for g, n in zip(groups, ns) if int(n) > 0)


def _run_path(name, run, groups_of, launches_by_path):
    """Drive one estimator with K1's count set to 0 just before and read
    just after; require a launch for every chunk evaluation."""
    import torch
    from bluest_tpu_torch.ops import diffusion as k1
    k1.diffusion_outputs.launches = 0
    t0 = time.perf_counter()
    mus, errs, cost = run()
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    launches = k1.diffusion_outputs.launches
    groups, ns = groups_of()
    need = _chunk_evals(groups, ns)
    launches_by_path[name] = launches
    if not launches >= need > 0:
        raise AssertionError("%s: K1 launched %d times for %d chunk "
                             "evaluations" % (name, launches, need))
    return mus, errs, cost, sample_s, launches, need


def _f32_mc_against_f64(problem, p64, counter, N, mus):
    """The draws of the f32 MC estimate again (call ``counter`` of the
    problem's seed, chunk by chunk), through the f32 model and through the
    f64 model on the same inputs: how many of the f32 ``q_energy`` values
    are off, the worst, and the f64 mean of these very draws."""
    import math
    import numpy as np
    import torch
    from bluest_tpu_torch.sampling.engine import generator_seed
    gen = torch.Generator(device=problem.device)
    over = {0.01: 0, 1.0: 0, 100.0: 0}
    worst = torch.zeros((), dtype=torch.float64, device=problem.device)
    s32 = torch.zeros(3, dtype=torch.float64, device=problem.device)
    s64 = torch.zeros_like(s32)
    for c in range(math.ceil(N / BATCH)):
        gen.manual_seed(generator_seed(problem.params["seed"], counter, c))
        xi = problem.sample_inputs(gen, min(BATCH, N - c * BATCH))
        q32 = problem.evaluate_model(0, xi).double()
        q64 = p64.evaluate_model(0, xi.double())
        err = (q32 - q64).abs()[:, 2]
        for t in over:
            over[t] += int((err > t).sum())
        worst = torch.maximum(worst, err.max())
        s32 += q32.sum(dim=0)
        s64 += q64.sum(dim=0)
    m32, m64 = (s32 / N).cpu().numpy(), (s64 / N).cpu().numpy()
    # the replay is the estimate's own draws (unless a non-finite row made
    # the estimator draw more): its f32 mean is the estimate
    same = bool(np.all(np.abs(m32 - mus) <= 1e-9 * np.abs(mus)))
    return over, float(worst), m64, same


def phase_target_rmse(problem, graph, launches_by_path):
    """Phase 5: the target-RMSE path on phase 4's problem (pilot paid
    once), at eps* = sqrt(max_n V_n) of phase 4's integer budget solve."""
    import numpy as np
    import torch

    budget_cost = float(problem.MOSAP_output["cost"])
    eps_star = float(np.sqrt(max(problem.MOSAP_output["variances"])))
    log("target RMSE: eps* = %.10e (phase 4 budget-mode cost %.10g)"
        % (eps_star, budget_cost))

    # eps-mode MLBLUE allocation (K3/K4/K5 counted from 0 just before and
    # read just after: the kernel line's "eps_star_alloc")
    reset_psd_launches()
    t0 = time.perf_counter()
    problem.setup_solver(K=K, eps=eps_star)
    _sync()
    alloc_eps_s = time.perf_counter() - t0
    PSD_PATHS["eps_star_alloc"] = psd_launches()
    log("eps* allocation: K3 %(sym_eigvalsh)d, K4 %(nt_svd)d, K5 pinv00 "
        "%(pinv00)d, sym_eigh %(sym_eigh)d launches" % PSD_PATHS["eps_star_alloc"])
    if not PSD_PATHS["eps_star_alloc"]["pinv00"] > 0:
        raise AssertionError("the eps* allocation launched no K5")
    out = problem.MOSAP_output
    certs = out["certificates"]
    ratio = float(max(out["variances"])) / eps_star ** 2
    eps_cost = float(out["cost"])
    log("alloc_eps_s %.3f: cost %.10g (budget mode %.10g, rel diff %.3e), "
        "max V/eps*^2 %.6f, NLP fallbacks %d, certificates %s"
        % (alloc_eps_s, eps_cost, budget_cost,
           (eps_cost - budget_cost) / budget_cost, ratio,
           problem.MOSAP.n_nlp_fallbacks,
           [(c["form"], c["status"], c["iterations"]) for c in certs]))
    # candidate (a), the direct eps form, must be certified; candidate (b),
    # the scaled budget epigraph, runs when (a)'s certificate is loose and
    # on this problem ends "infeasible"/"failed" in both packages -- a
    # failed (b) is no candidate, so the allocation is (a)'s point
    if not (certs and certs[0]["form"] == "direct-eps"
            and certs[0]["status"] in ("optimal", "inaccurate")):
        raise AssertionError("eps-mode certificate not ok: %s" % certs)
    if not ratio <= 1.0001:
        raise AssertionError("max V/eps*^2 = %.6f > 1.0001" % ratio)
    if problem.MOSAP.n_nlp_fallbacks != 0:
        raise AssertionError("eps-mode allocation fell back to the NLP")
    # min-cost-at-eps and min-variance-at-budget share a Pareto frontier
    if not abs(eps_cost - budget_cost) <= 0.02 * budget_cost:
        raise AssertionError("eps-mode cost %.10g not within 2%% of the "
                             "budget-mode cost %.10g" % (eps_cost, budget_cost))

    w = problem.get_costs()
    res = {}

    # MLBLUE at eps*: the allocation above must be reused, not rerun
    mosap = problem.MOSAP
    real_solve = mosap.solve
    n_alloc = [0]

    def counted_solve(*a, **k):
        n_alloc[0] += 1
        return real_solve(*a, **k)

    mosap.solve = counted_solve
    try:
        mus, errs, cost, s, n, need = _run_path(
            "mlblue_eps", lambda: problem.solve(K=K, eps=eps_star),
            lambda: (out["flattened_groups"], out["samples"]),
            launches_by_path)
    finally:
        del mosap.solve
    if n_alloc[0] != 0 or problem.MOSAP is not mosap:
        raise AssertionError("solve(eps=eps*) reran the allocation")
    active = [(g, int(m)) for g, m in zip(out["flattened_groups"],
                                          out["samples"]) if m > 0]
    res["mlblue"] = (mus, errs, cost)
    log("MLBLUE @eps*: setup_s %.3f sample_s %.3f | %d groups, %d samples, "
        "cost %.10g | K1 launches %d (chunk evaluations %d)"
        % (alloc_eps_s, s, len(active), sum(m for _, m in active), cost, n,
           need))

    # MC: N = max_n ceil(C_n[0,0]/eps*^2) samples of model 0.  The f32
    # discretisation at n=1024 breaks down on rare draws (q_energy off by
    # more than 1 on a few draws in 1e5, now and then by 1e2 to 1e7, where
    # the f64 model is right), and ~2.5e5 draws of the finest model meet
    # such draws often: the f32 MC estimate of q_energy is then off by far
    # more than its error bar.  So the f32 MC run is driven and measured
    # (its draws again through the f64 model, on the same inputs) but its
    # estimate is not gated; the gates below hold the MC estimator on the
    # f64 problem at the same width (K1's f64 instantiation), loaded from
    # phase 4's graph, so its N is the same.
    mc_n = [0]

    def run_mc(p):
        r = p.solve_mc(eps=eps_star)
        mc_n[0] = int(round(r[2] / w[0]))
        return r

    counter = problem._call_counter
    mus, errs, cost, s, n, need = _run_path(
        "mc", lambda: run_mc(problem), lambda: ([[0]], [mc_n[0]]),
        launches_by_path)
    mus, errs = np.asarray(mus, float), np.asarray(errs, float)
    p64 = _flagship_from_graph(graph, dtype=torch.float64)
    over, worst, m64, same = _f32_mc_against_f64(problem, p64, counter,
                                                 mc_n[0], mus)
    z32 = abs(mus[2] - mus[0]) / float(np.max(errs))
    z64 = abs(m64[2] - m64[0]) / float(np.max(errs))
    log("MC @eps* in f32 (measured, not gated): sample_s %.3f | models [0], "
        "%d samples from call %d | K1 launches %d (chunk evaluations %d) | "
        "mus %s: q_energy - q_int = %.2f error bars; the same draws through "
        "the f64 model%s: mean %s, %.2f error bars; f32 q_energy off the "
        "f64 one by more than %s, worst %.4g"
        % (s, mc_n[0], counter, n, need, mus.tolist(), z32,
           "" if same else " (the estimate drew more: non-finite rows)",
           m64.tolist(), z64, json.dumps({str(k): v for k, v in
                                          over.items()}), worst))
    if not (np.all(np.isfinite(mus)) and np.all(errs <= 1.0001 * eps_star)):
        raise AssertionError("f32 MC: non-finite estimate or errs above eps*")
    if not z64 <= 4:
        raise AssertionError("the f32 MC's draws through the f64 model: "
                             "q_energy and q_int disagree (%.2f error bars)"
                             % z64)
    mus, errs, cost, s, n, need = _run_path(
        "mc_f64", lambda: run_mc(p64), lambda: ([[0]], [mc_n[0]]),
        launches_by_path)
    if p64.dtype != torch.float64 or p64.device.type != DEV:
        raise AssertionError("the f64 MC problem is %s on %s"
                             % (p64.dtype, p64.device))
    res["mc"] = (mus, errs, cost)
    log("MC @eps* in f64: setup_s 0 (closed form inside solve_mc) sample_s "
        "%.3f | models [0], %d samples, cost %.10g | K1 launches %d (chunk "
        "evaluations %d)" % (s, mc_n[0], cost, n, need))

    # MLMC: pairs of consecutive chain models plus the last singleton
    t0 = time.perf_counter()
    d = problem.setup_mlmc(eps=eps_star)
    setup_s = time.perf_counter() - t0
    chain = list(d["models"])
    mlmc_groups = [list(p) for p in zip(chain[:-1], chain[1:])] + [chain[-1:]]
    mus, errs, cost, s, n, need = _run_path(
        "mlmc", lambda: problem.solve_mlmc(mlmc_data=d),
        lambda: (mlmc_groups, d["samples"]), launches_by_path)
    res["mlmc"] = (mus, errs, cost)
    pair_cost = float(sum(int(m) * w[g].sum()
                          for g, m in zip(mlmc_groups, d["samples"])))
    log("MLMC @eps*: setup_s %.3f sample_s %.3f | models %s samples %s | "
        "cost %.10g (raw per-model costs, the reference convention), %.10g "
        "priced at its group costs | K1 launches %d (chunk evaluations %d)"
        % (setup_s, s, chain, [int(m) for m in d["samples"]], cost,
           pair_cost, n, need))

    # MFMC: nested groups models[i:] with the sample increments
    t0 = time.perf_counter()
    d = problem.setup_mfmc(eps=eps_star)
    setup_s = time.perf_counter() - t0
    order = list(d["models"])
    samp = [int(m) for m in d["samples"]]
    incs = [samp[i] - (samp[i - 1] if i else 0) for i in range(len(samp))]
    mus, errs, cost, s, n, need = _run_path(
        "mfmc", lambda: problem.solve_mfmc(mfmc_data=d),
        lambda: ([order[i:] for i in range(len(order))], incs),
        launches_by_path)
    res["mfmc"] = (mus, errs, cost)
    log("MFMC @eps*: setup_s %.3f sample_s %.3f | models %s samples %s | "
        "cost %.10g | K1 launches %d (chunk evaluations %d)"
        % (setup_s, s, order, samp, cost, n, need))

    # every estimator: tolerance met, finite, q_energy = q_int, and
    # consistent with MLBLUE within the combined error bars
    mu_b = np.asarray(res["mlblue"][0], dtype=float)
    err_b = np.asarray(res["mlblue"][1], dtype=float)
    for est, (mus, errs, cost) in res.items():
        mus = np.asarray(mus, dtype=float)
        errs = np.asarray(errs, dtype=float)
        log("  %-6s mus %s errs %s cost %.10g"
            % (est, mus.tolist(), errs.tolist(), cost))
        if not np.all(errs <= 1.0001 * eps_star):
            raise AssertionError("%s: errs %s above eps*" % (est, errs))
        if not np.all(np.isfinite(mus)):
            raise AssertionError("%s: non-finite estimate" % est)
        if not abs(mus[2] - mus[0]) <= 4 * float(np.max(errs)):
            raise AssertionError("%s: q_energy and q_int disagree" % est)
        if not np.all(np.abs(mus - mu_b) <= 4 * np.sqrt(errs ** 2
                                                        + err_b ** 2)):
            raise AssertionError("%s disagrees with MLBLUE beyond 4 sigma"
                                 % est)
    if not res["mlblue"][2] <= res["mc"][2]:
        raise AssertionError("MLBLUE cost %.10g above MC cost %.10g"
                             % (res["mlblue"][2], res["mc"][2]))

    # record each eps solve's wall and cone programs (candidate (b) runs
    # a second IPM whenever (a)'s certificate is loose)
    solves = []

    def timed_solve(*a, **k):
        t = time.perf_counter()
        r = real_solve(*a, **k)
        solves.append((time.perf_counter() - t,
                       [(c["form"], c["status"], c["iterations"])
                        for c in mosap.certificates]))
        return r

    mosap.solve = timed_solve
    t0 = time.perf_counter()
    try:
        costs, rate = problem.complexity_test([2 * eps_star, eps_star,
                                               eps_star / 2], K=K)
    finally:
        del mosap.solve
    log("complexity_test: costs %s rate %.4f (%.3f s); per solve %s"
        % (list(map(float, costs)), rate, time.perf_counter() - t0,
           ["%.3f s %s" % s for s in solves]))
    if not 1.9 <= rate <= 2.1:
        raise AssertionError("complexity rate %.4f outside [1.9, 2.1]" % rate)

    t0 = time.perf_counter()
    err_ex, err = problem.variance_test(eps=2 * eps_star, K=K, N=20)
    vt_s = time.perf_counter() - t0
    vt_ratio = np.asarray(err) / np.asarray(err_ex)
    log("variance_test(eps=2 eps*, N=20): err_ex %s err %s ratio %s "
        "(%.3f s)" % (np.asarray(err_ex).tolist(), np.asarray(err).tolist(),
                      vt_ratio.tolist(), vt_s))
    if not np.all((0.5 <= vt_ratio) & (vt_ratio <= 1.6)):
        raise AssertionError("variance_test ratio %s outside [0.5, 1.6]"
                             % vt_ratio)


def device_busy(prof, kernel_name=None) -> dict:
    """Device activity of a finished ``torch.profiler`` trace, in
    microseconds: ``busy_us`` (the union of all device items), ``by_name``
    (summed per item name) and, for the items whose name holds
    ``kernel_name``, ``kernel_us`` and ``kernel_n``."""
    import torch
    spans, by_name, k_us, k_n = [], {}, 0.0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        by_name[e.name] = by_name.get(e.name, 0.0) + (t1 - t0)
        if kernel_name is not None and kernel_name in e.name:
            k_us += t1 - t0
            k_n += 1
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {"busy_us": busy, "by_name": by_name, "kernel_us": k_us,
            "kernel_n": k_n}


def phase_profile(problem):
    """One more budget solve of phase 4's problem under torch.profiler:
    K1's device time and launches, the union of all device activity over
    the solve's wall (the busy share), and the largest device items; then
    one solve under the synchronisation debug mode: the calls that still
    make the host wait for the card, by call site (phase 11 lists those
    of one allocation, in every run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    budget = problem.MOSAP_output["budget"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        problem.solve(K=K, budget=budget)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    d = device_busy(prof, "diffusion_outputs_kernel")
    busy, k1_us, k1_n = d["busy_us"], d["kernel_us"], d["kernel_n"]
    top = sorted(d["by_name"].items(), key=lambda kv: -kv[1])[:6]
    log("profiled solve: wall %.3f ms, device busy %.3f ms (%.1f%%), K1 "
        "%.3f ms over %d launches (%.1f%% of busy); top device items %s"
        % (wall_ms, busy / 1e3, 100 * busy / 1e3 / wall_ms, k1_us / 1e3,
           k1_n, 100 * k1_us / max(busy, 1e-9),
           ["%s %.3f ms" % (nm[:60], us / 1e3) for nm, us in top]))

    sites = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            problem.solve(K=K, budget=budget)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            site = "%s:%d" % (os.path.relpath(w.filename), w.lineno)
            sites[site] = sites.get(site, 0) + 1
    log("synchronising calls left in one pipelined solve: %d %s"
        % (sum(sites.values()), json.dumps(sites, sort_keys=True)))



def _sync():
    import torch
    if DEV == "cuda":
        torch.cuda.synchronize()


def _normwise(got, ref):
    """max |got - ref| over the rows (dim 0), over max |ref|, worst
    column."""
    return float(((got - ref).abs().amax(dim=0)
                  / ref.abs().amax(dim=0).clamp_min(1e-300)).max())


def _check_on_sampling_device(problem):
    if problem.device.type != DEV:
        raise AssertionError("%s samples on %s, not on %s"
                             % (type(problem).__name__, problem.device, DEV))


def _within_bars(name, mus, errs, ref, ref_se):
    """Each estimate within 4 combined error bars of its reference."""
    import numpy as np
    mus, errs = np.asarray(mus, float), np.asarray(errs, float)
    ref, ref_se = np.asarray(ref, float), np.asarray(ref_se, float)
    z = np.abs(mus - ref) / np.sqrt(errs ** 2 + ref_se ** 2)
    log("%s: estimates %s errs %s, reference %s se %s, |z| %s"
        % (name, mus.tolist(), errs.tolist(), ref.tolist(), ref_se.tolist(),
           z.tolist()))
    if not (np.all(np.isfinite(mus)) and np.all(errs > 0) and np.all(z <= 4)):
        raise AssertionError("%s: estimates not within 4 error bars of the "
                             "reference" % name)


def phase_matern(times):
    """6(a): Matern 2D at its default grids, f64, on the default device."""
    import numpy as np
    import torch
    from bluest_tpu_torch.models.matern2d import Matern2DProblem
    t0 = time.perf_counter()
    p = Matern2DProblem(covariance_estimation_samples=MATERN_PILOT,
                        verbose=False)
    _sync()
    times["matern_pilot_s"] = time.perf_counter() - t0
    _check_on_sampling_device(p)
    if p.grids != (64, 32, 16, 8) or p.dtype != torch.float64:
        raise AssertionError("Matern2DProblem defaults changed: %s %s"
                             % (p.grids, p.dtype))

    w = p.sample_inputs(torch.Generator(device=DEV).manual_seed(3), 256)
    worst = max(_normwise(p.evaluate_model(l, w).cpu(),
                          p.evaluate_model(l, w.cpu()))
                for l in range(p.M))
    log("Matern card vs CPU, same white noise, 256 samples x 4 models: max "
        "normwise rel diff %.3e" % worst)
    if not worst <= 1e-12:
        raise AssertionError("Matern card vs CPU %.3e > 1e-12" % worst)

    eps = [MATERN_EPS_REL * float(np.sqrt(p.get_covariance(n)[0, 0]))
           for n in range(p.n_outputs)]
    t0 = time.perf_counter()
    p.setup_solver(K=4, eps=eps)
    times["matern_setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mus, errs, cost = p.solve(K=4, eps=eps)
    _sync()
    times["matern_solve_s"] = time.perf_counter() - t0
    out = p.MOSAP_output
    log("Matern: pilot %.3f s, setup_solver(K=4, eps=%s) %.3f s (L=%d, "
        "%d samples), solve %.3f s, cost %.8g"
        % (times["matern_pilot_s"], eps, times["matern_setup_s"], p.MOSAP.L,
           int(sum(int(n) for n in out["samples"])),
           times["matern_solve_s"], cost))
    if not np.all(np.asarray(errs, float) <= 1.0001 * np.asarray(eps)):
        raise AssertionError("Matern errs %s above eps %s" % (errs, eps))

    # plain MC of model 0 on the card
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(4)
    s1 = torch.zeros(p.n_outputs, dtype=torch.float64, device=DEV)
    s2 = torch.zeros_like(s1)
    for _ in range(MATERN_MC // MATERN_MC_CHUNK):
        q = p.evaluate_model(0, p.sample_inputs(gen, MATERN_MC_CHUNK))
        s1 += q.sum(dim=0)
        s2 += (q * q).sum(dim=0)
    mean = (s1 / MATERN_MC).cpu().numpy()
    var = (s2 / MATERN_MC).cpu().numpy() - mean ** 2
    times["matern_mc_s"] = time.perf_counter() - t0
    log("Matern MC reference: %d samples of model 0 in %.3f s"
        % (MATERN_MC, times["matern_mc_s"]))
    _within_bars("Matern MLBLUE vs MC", mus, errs, mean,
                 np.sqrt(var / MATERN_MC))
    return {"problem": p, "eps": eps, "mc_mean": mean,
            "mc_se": np.sqrt(var / MATERN_MC)}


def _device_kernels(fn):
    """Device items (kernels, copies) that ``fn`` puts on the card, from
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        _sync()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


@contextlib.contextmanager
def logging_k2_launches():
    """Log, in the list it yields, each K2 launch as (entries' (kind, dt),
    n, variant); the launches themselves are unchanged."""
    from bluest_tpu_torch.ops import hodgkin_huxley as k2
    shapes = []
    real = k2._launch

    def logged(lib, params, out, entries, variant, stream):
        shapes.append((tuple((kind, dt) for _, kind, _, dt in entries),
                       params.shape[0], variant))
        return real(lib, params, out, entries, variant, stream)

    k2._launch = logged
    try:
        yield shapes
    finally:
        k2._launch = real


def k2_launch_summary(shapes, models):
    """The logged launches as 'models (indices into ``models``) n=..
    variant: count' lines, most launches first."""
    import collections
    c = collections.Counter(
        (tuple(models.index(m) for m in ms), n, v) for ms, n, v in shapes)
    return ["%s n=%d %s: %d" % (list(ls), n, v, k)
            for (ls, n, v), k in sorted(c.items(), key=lambda kv: -kv[1])]


@contextlib.contextmanager
def counting_group_evals():
    """Count, in the list it yields, the Hodgkin-Huxley group evaluations
    (calls of HodgkinHuxleyProblem.evaluate_group with rows, the group
    engine's draws and redraws) and the K2 launches they need (one per
    ops.hodgkin_huxley.MAX_MODELS models): items 0 and 1."""
    from bluest_tpu_torch.models.hodgkin_huxley import HodgkinHuxleyProblem
    from bluest_tpu_torch.ops.hodgkin_huxley import launch_plan
    need = [0, 0]
    real = HodgkinHuxleyProblem.evaluate_group

    def counted(self, ls, params):
        if params.shape[0] > 0:
            need[0] += 1
            need[1] += len(launch_plan([self.models[l] for l in ls],
                                       params.shape[0]))
        return real(self, ls, params)

    HodgkinHuxleyProblem.evaluate_group = counted
    try:
        yield need
    finally:
        HodgkinHuxleyProblem.evaluate_group = real


def phase_hodgkin_huxley(times, graph, k2c, hh_launches, hh_by_variant):
    """6(b): all 12 Hodgkin-Huxley models through the group engine, the
    counted run (pilot, allocation, solve) through K2; the pilot's graph
    is saved to ``graph`` for phase 11."""
    import numpy as np
    import torch
    from bluest_tpu_torch.models import hodgkin_huxley as hh
    from bluest_tpu_torch.ops import hodgkin_huxley as k2
    from bluest_tpu_torch.sampling.engine import finite_rows
    # the counted run: K2's count set to 0 just before the pilot and read
    # just after the solve
    with counting_group_evals() as evals, logging_k2_launches() as shapes:
        k2.hh_group_outputs.launches = 0
        for v in k2.hh_group_outputs.launches_by_variant:
            k2.hh_group_outputs.launches_by_variant[v] = 0
        t0 = time.perf_counter()
        p = hh.HodgkinHuxleyProblem(covariance_estimation_samples=HH_PILOT,
                                    device_batch_size=HH_BATCH,
                                    verbose=False)
        _sync()
        times["hh_pilot_s"] = time.perf_counter() - t0
        _check_on_sampling_device(p)
        if p.M != 12 or p.n_outputs != 5 or not p._has_group_model():
            raise AssertionError("HodgkinHuxleyProblem is not the 12-model, "
                                 "5-output coupled-group family")
        log("HH pilot: %d samples x 12 models in %.3f s"
            % (HH_PILOT, times["hh_pilot_s"]))
        t0 = time.perf_counter()
        p.setup_solver(K=3, budget=HH_BUDGET)
        times["hh_setup_s"] = time.perf_counter() - t0
        out = p.MOSAP_output
        active = [(list(g), int(n)) for g, n in zip(out["flattened_groups"],
                                                    out["samples"]) if n > 0]
        t0 = time.perf_counter()
        mus, errs, cost = p.solve(K=3, budget=HH_BUDGET)
        _sync()
        times["hh_solve_s"] = time.perf_counter() - t0
        launches = k2.hh_group_outputs.launches
        by_variant = dict(k2.hh_group_outputs.launches_by_variant)
    hh_launches["hh_group_engine"] = launches
    hh_by_variant["hh_group_engine"] = by_variant
    log("HH: setup_solver(K=3, budget=%.6g) %.3f s (L=%d), %d active groups "
        "%s, solve %.3f s, cost %.8g"
        % (HH_BUDGET, times["hh_setup_s"], p.MOSAP.L, len(active), active,
           times["hh_solve_s"], cost))
    log("HH K2 launches %d (group evaluations %d, launches they need %d), "
        "by variant %s"
        % (launches, evals[0], evals[1], by_variant))
    log("HH walls beside the one-lane pow design's: hh_pilot_s %.3f (%.3f), "
        "hh_solve_s %.3f (%.3f)"
        % (times["hh_pilot_s"], HH_WALLS_ONE_LANE_POW["hh_pilot_s"],
           times["hh_solve_s"], HH_WALLS_ONE_LANE_POW["hh_solve_s"]))
    for line in k2_launch_summary(shapes, p.models):
        log("  HH K2 launch (models, n, variant): " + line)
    if not launches == evals[1] == evals[0] == len(shapes) > 0:
        raise AssertionError("HH: K2 launched %d times for %d group "
                             "evaluations" % (launches, evals[0]))
    if sum(by_variant.values()) != launches:
        raise AssertionError("HH: K2's launches by variant %s do not add up "
                             "to %d" % (by_variant, launches))

    # K2 on this allocation's K=3 groups against the plain version, on the
    # K2 check's inputs, in every variant
    for g, _ in active:
        for x, ref in zip(k2c["xs"], k2c["refs"]):
            for v in k2.VARIANTS:
                got = k2.hh_group_outputs([p.models[l] for l in g], x,
                                          variant=v)
                _sync()
                k2_holds(got, ref[:, :, g], "%s, group %s, n=%d"
                         % (v, g, x.shape[0]))
    log("HH K2 holds on the %d active groups at n in %s in every variant"
        % (len(active), K2_CHECK_N))

    # device items per evaluation of the finest model: the plain version
    # (its HH RK4 integration at 5 and 10 steps gives the count per step
    # and the fixed part, whatever the values; the finest model takes 1000
    # steps) and K2 (its time beside the K2 check's plain times)
    x = p.sample_group(torch.Generator(device=DEV).manual_seed(5), (0,), 256)
    c5 = _device_kernels(lambda: k2.hh_group_outputs_plain(((0, 2.0),), x))
    c10 = _device_kernels(lambda: k2.hh_group_outputs_plain(((0, 1.0),), x))
    per_step = (c10 - c5) / 5.0
    finest = c5 + (1000 - 5) * per_step
    # K2 over several evaluations: a lone short kernel at the edge of the
    # profiler's window can fall out of it (seen once on the H100)
    reps = 5
    c_k2 = _device_kernels(lambda: [hh.hh_outputs(0, 0.01, x)
                                    for _ in range(reps)]) / reps
    t0 = time.perf_counter()
    hh.hh_outputs(0, 0.01, x)
    _sync()
    t_k2 = time.perf_counter() - t0
    times.update(hh_finest_launches_plain=finest, hh_finest_items_k2=c_k2,
                 hh_finest_k2_s=t_k2)
    log("HH finest model (RK4, dt 0.01, 1000 steps), 256 samples: plain "
        "version %.0f device launches per evaluation (%.2f per RK4 step + "
        "%.0f; profiled %d and %d at 5 and 10 steps); hh_outputs (K2) %.1f "
        "device items per evaluation (%d evaluations profiled), %.6f s"
        % (finest, per_step, c5 - 5 * per_step, c5, c10, c_k2, reps, t_k2))
    if not 0 < c_k2 <= 4:
        raise AssertionError("hh_outputs put %.1f device items an evaluation "
                             "on the card (K2 and the output: at most 4)"
                             % c_k2)

    # card vs CPU on the same sampled parameters
    t0 = time.perf_counter()
    ls = tuple(range(p.M))
    x = p.sample_group(torch.Generator(device=DEV).manual_seed(6), ls, 64)
    got = p.evaluate_group(ls, x).cpu()
    ref = p.evaluate_group(ls, x.cpu())
    times["hh_check_s"] = time.perf_counter() - t0
    fin = finite_rows(ref)
    if not torch.equal(finite_rows(got), fin):
        raise AssertionError("HH card and CPU differ in their failing rows")
    worst = _normwise(got[fin].flatten(1), ref[fin].flatten(1))
    log("HH card vs CPU, same parameters, 64 samples x 12 models: %d rows "
        "finite in every model, max normwise rel diff %.3e (%.3f s)"
        % (int(fin.sum()), worst, times["hh_check_s"]))
    if int(fin.sum()) == 0 or not worst <= 1e-8:
        raise AssertionError("HH card vs CPU %.3e > 1e-8" % worst)

    # MC of model 0 (every draw finite: RK4 at dt 0.01 is stable)
    t0 = time.perf_counter()
    q = hh.hh_outputs(0, 0.01, p.sample_group(
        torch.Generator(device=DEV).manual_seed(7), (0,), HH_MC))
    if not bool(torch.isfinite(q).all()):
        raise AssertionError("HH model 0 gave non-finite outputs")
    q = q.cpu().numpy()
    times["hh_mc_s"] = time.perf_counter() - t0
    log("HH MC reference: %d samples of model 0 in %.3f s"
        % (HH_MC, times["hh_mc_s"]))
    log("HH walls: hh_pilot_s %.3f, hh_solve_s %.3f, hh_mc_s %.3f"
        % (times["hh_pilot_s"], times["hh_solve_s"], times["hh_mc_s"]))
    _within_bars("HH MLBLUE vs MC", np.asarray(mus, float).ravel(),
                 np.asarray(errs, float).ravel(), q.mean(axis=0),
                 q.std(axis=0) / np.sqrt(HH_MC))
    p.save_graph_data(graph)


def phase_snapshots(times, launches_by_path):
    """6(c): the flagship with a samplefile: snapshots through K1."""
    import glob
    import numpy as np
    import torch
    from bluest_tpu_torch.models.diffusion import DiffusionProblem
    from bluest_tpu_torch.ops import diffusion as k1
    with tempfile.TemporaryDirectory() as d:
        target = os.path.join(d, "snap.npz")
        t0 = time.perf_counter()
        p = DiffusionProblem(
            grids=GRIDS, n_kl=N_KL, sigma=SIGMA, nu=NU, multi_output=True,
            covariance_estimation_samples=PILOT, dtype=torch.float32,
            device_batch_size=BATCH, samplefile=target, outputs_to_save=[0],
            verbose=False)
        _sync()
        times["snap_pilot_s"] = time.perf_counter() - t0
        _check_on_sampling_device(p)
        t0 = time.perf_counter()
        p.setup_solver(K=2, budget=SNAP_BUDGET)
        times["snap_setup_s"] = time.perf_counter() - t0
        out = p.MOSAP_output
        groups = [list(g) for g, n in zip(out["flattened_groups"],
                                          out["samples"]) if n > 0]
        ns = [int(n) for n in out["samples"] if n > 0]
        k1.diffusion_outputs.launches = 0
        t0 = time.perf_counter()
        mus, errs, cost = p.solve(K=2, budget=SNAP_BUDGET)
        _sync()
        times["snap_solve_s"] = time.perf_counter() - t0
        launches = k1.diffusion_outputs.launches
        launches_by_path["snapshots"] = launches
        need = _chunk_evals(groups, ns)
        log("snapshots: pilot %.3f s, setup_solver(K=2, budget=%.6g) %.3f s, "
            "solve %.3f s, %d groups, %d samples, K1 launches %d (chunk "
            "evaluations %d)"
            % (times["snap_pilot_s"], SNAP_BUDGET, times["snap_setup_s"],
               times["snap_solve_s"], len(groups), sum(ns), launches, need))
        if not launches >= need > 0:
            raise AssertionError("snapshots: K1 launched %d times for %d "
                                 "chunk evaluations" % (launches, need))
        if not np.all(np.isfinite(np.asarray(mus, float))):
            raise AssertionError("snapshots: non-finite estimates")

        files = sorted(glob.glob(os.path.join(d, "snap*.npz")))
        seen = set()
        for f in files:
            with np.load(f) as z:
                ls = tuple(int(l) for l in z["models"][0])
                n = int(z["n_samples"][0])
                rows = {k: z[k].shape[0] for k in z.files
                        if k.startswith(("values_", "inputs_"))}
            seen.add(ls)
            if ls not in p.sampling_stats:
                raise AssertionError("snapshot %s of a group that was not "
                                     "sampled" % os.path.basename(f))
            covered = p.sampling_stats[ls]["samples"]
            if not (n == covered and set(rows.values()) == {n}
                    and len(rows) == 2 * len(ls)):
                raise AssertionError(
                    "snapshot %s: n_samples %d, rows %s, samples covered %d"
                    % (os.path.basename(f), n, rows, covered))
        if seen != set(p.sampling_stats):
            raise AssertionError("groups sampled without a snapshot: %s"
                                 % sorted(set(p.sampling_stats) - seen))
        log("snapshots: %d group files, rows equal the samples covered in "
            "each (%d rows in all)"
            % (len(files), sum(s["samples"]
                               for s in p.sampling_stats.values())))

        # K1 on stored inputs reproduces the stored outputs bit for bit
        big = max(groups, key=len)
        from bluest_tpu_torch.sampling.snapshots import snapshot_filename
        with np.load(snapshot_filename(target, big)) as z:
            for i, l in enumerate(big):
                xi = torch.as_tensor(z["inputs_%d" % i][:64], device=DEV)
                q = p.evaluate_model(l, xi)[:, 0].cpu().numpy()
                if not np.array_equal(q, z["values_0_%d" % i][:64]):
                    raise AssertionError(
                        "K1 on stored inputs of model %d differs from the "
                        "stored outputs" % l)
        log("snapshots: K1 on 64 stored inputs of group %s gives the stored "
            "outputs bit for bit" % big)


def phase_host_model(times):
    """6(d): a black-box numpy model with an inf sentinel, two workers."""
    import numpy as np
    from bluest_tpu_torch.linalg.spd import project_covariance_masked
    from bluest_tpu_torch.models.analytic import (TRUE_MEAN,
                                                  ExpSeriesHostProblem)
    C = np.full((5, 5), np.nan)
    C[0, 1] = C[1, 0] = np.inf
    t0 = time.perf_counter()
    p = ExpSeriesHostProblem(5, C=C, covariance_estimation_samples=HOST_PILOT,
                             host_workers=2, sample_batch_size=256,
                             skip_projection=True, verbose=False)
    times["host_pilot_s"] = time.perf_counter() - t0
    if p._has_torch_model() or p._engine is not None:
        raise AssertionError("the black-box model took a device path")
    Cp = p.get_covariance(0)
    spg = p.params["spg_params"]
    # the masked SPG's projections through K5's sym_eigh (its count set to
    # 0 just before and read just after: the kernel line's "masked_spg")
    reset_psd_launches()
    t0 = time.perf_counter()
    _, err, res = project_covariance_masked(
        Cp, (~np.isnan(Cp)).astype(float), spd_eps=spg["spd_threshold"],
        spg_eps=spg["eps"], maxit=spg["maxit"], max_fevals=spg["max_fevals"])
    PSD_PATHS["masked_spg"] = psd_launches()
    p.project_covariances()
    p.check_graphs(remove_uncorrelated=p.params["remove_uncorrelated"])
    times["host_projection_s"] = time.perf_counter() - t0
    log("masked SPG: K5 sym_eigh launches %d over %d iterations"
        % (PSD_PATHS["masked_spg"]["sym_eigh"], res.it))
    if not PSD_PATHS["masked_spg"]["sym_eigh"] > res.it:
        raise AssertionError("the masked SPG projection launched K5 %d times "
                             "in %d iterations"
                             % (PSD_PATHS["masked_spg"]["sym_eigh"], res.it))
    log("host model: pilot (%d samples, 2 workers) %.3f s; masked SPG: "
        "solver_info %d, %d iterations, error %.3e, %.3f s"
        % (HOST_PILOT, times["host_pilot_s"], res.solver_info, res.it, err,
           times["host_projection_s"]))
    if res.solver_info != 0 or not np.isnan(p.get_covariance(0)[0, 1]):
        raise AssertionError("masked SPG projection did not converge, or "
                             "lost the never-coupled pair")
    t0 = time.perf_counter()
    out = p.setup_solver(K=3, eps=HOST_EPS)
    times["host_setup_s"] = time.perf_counter() - t0
    both = [g for g in out["models"] if {0, 1} <= set(g)]
    if both:
        raise AssertionError("groups couple models 0 and 1: %s" % both)
    t0 = time.perf_counter()
    mus, errs, cost = p.solve_mc(eps=HOST_EPS)
    times["host_mc_s"] = time.perf_counter() - t0
    log("host model: setup_solver(K=3, eps=%g) %.3f s, %d groups, none "
        "holding 0 and 1; solve_mc %.3f s, cost %.6g"
        % (HOST_EPS, times["host_setup_s"], len(out["models"]),
           times["host_mc_s"], cost))
    _within_bars("host model MC vs exp(0.5)", mus, errs, [TRUE_MEAN], [0.0])


def phase_user_models(launches_by_path, hh_graph, k2c, hh_launches,
                      hh_by_variant):
    """Phase 6: every part raises on failure; nothing is caught."""
    times = {}
    kept = {}
    t0 = time.perf_counter()
    for name, run in (("a", lambda: phase_matern(times)),
                      ("b", lambda: phase_hodgkin_huxley(
                          times, hh_graph, k2c, hh_launches, hh_by_variant)),
                      ("c", lambda: phase_snapshots(times, launches_by_path)),
                      ("d", lambda: phase_host_model(times))):
        t = time.perf_counter()
        kept[name] = run()
        times["part_%s_s" % name] = time.perf_counter() - t
        log("phase 6(%s): %.3f s" % (name, times["part_%s_s" % name]))
    log("phase 6: %.3f s; %s" % (time.perf_counter() - t0,
                                 json.dumps({k: round(v, 6)
                                             for k, v in times.items()})))
    return kept["a"]


def _cone_solves(certs):
    """(form, status, iterations, warm) of each cone solve of one set-up."""
    return [(c["form"], c["status"], c["iterations"],
             bool(c.get("dims", {}).get("warm_start", False)))
            for c in certs]


def phase_solver_families(matern, times):
    """7(a): the four continuous solver families on the Matern 2D problem
    of phase 6(a) (pilot paid), the Newton polish on the two cone
    families' points, and an integer ADMM allocation sampled on the
    card."""
    import numpy as np
    from bluest_tpu_torch.allocation import polish as polish_mod
    from bluest_tpu_torch.solvers import sdp
    p, eps = matern["problem"], matern["eps"]
    eps2 = np.asarray(eps, float) ** 2
    sdp._WARM_CACHE.clear()
    p._mosap_key = None             # a fresh MOSAP: fallbacks count from 0
    polished = {"polish": True}
    admm_params = {"polish": True, "max_iter": ADMM_MAX_ITER}
    fam, pol = {}, {}

    # the point each polish starts from, as setup_solver hands it over
    raw_points = []
    real_polish = polish_mod.polish_eps

    def recording_polish(mosap, m, *a, **k):
        raw_points.append(np.asarray(m, float).copy())
        return real_polish(mosap, m, *a, **k)

    def check_polish(solver, wall, raw_cost):
        rep = p.MOSAP.polish_report
        if rep is None:
            raise AssertionError("the polish of the %s point was not "
                                 "accepted" % solver)
        log("polish from %-4s: set-up %.3f s, raw cost %.12g, report %s"
            % (solver, wall, raw_cost, rep))
        if not rep["stationarity"] <= 1e-9:
            raise AssertionError("polished %s point: stationarity %.3e > "
                                 "1e-9" % (solver, rep["stationarity"]))
        if not rep["cost"] <= raw_cost * (1 + 1e-12):
            raise AssertionError("the polish raised the %s cost" % solver)
        pol[solver] = float(rep["cost"])

    polish_mod.polish_eps = recording_polish
    try:
        for solver in ("sdp", "admm", "spg", "scipy"):
            # ADMM's set-up is the slow one (two cone programs of ~15,000
            # and ADMM_MAX_ITER iterations): it runs once, through
            # setup_solver with the polish and the integer projection, and
            # serves three checks -- the point it hands to the polish
            # stands beside the other families' here, the polished point
            # beside the IPM's below, and its integer allocation is
            # sampled on the card
            admm = solver == "admm"
            del raw_points[:]
            p.MOSAP.polish_report = None
            t0 = time.perf_counter()
            p.setup_solver(K=4, eps=eps, solver=solver,
                           continuous_relaxation=not admm,
                           optimization_solver_params=admm_params if admm
                           else None)
            wall = time.perf_counter() - t0
            out = p.MOSAP_output
            if admm:
                (point,) = raw_points
            else:
                point = np.asarray(p.MOSAP.continuous_solution, float)
            cost = float(point @ p.MOSAP.costs)
            ratio = float(np.max(np.asarray(p.MOSAP.variances(point))
                                 / eps2))
            fam[solver] = {"cost": cost, "ratio": ratio, "wall_s": wall}
            times["family_%s_s" % solver] = wall
            log("family %-5s: %.3f s, continuous cost %.10g, max V/eps^2 "
                "%.8f, cone solves %s, NLP fallbacks so far %d"
                % (solver, wall, cost, ratio,
                   _cone_solves(out["certificates"]),
                   p.MOSAP.n_nlp_fallbacks))
            if not ratio <= 1.005:
                raise AssertionError("%s: max V/eps^2 = %.6f > 1.005"
                                     % (solver, ratio))
            if not admm:
                continue
            check_polish("admm", wall, cost)
            # the ADMM family end to end: its integer allocation, from
            # the polished point, sampled on the card
            times["admm_setup_s"] = wall
            t0 = time.perf_counter()
            mus, errs, cost = p.solve(K=4, eps=eps, solver="admm",
                                      optimization_solver_params=admm_params)
            _sync()
            times["admm_solve_s"] = time.perf_counter() - t0
            log("ADMM allocation sampled: setup %.3f s, solve %.3f s, %d "
                "samples, cost %.8g (the IPM's integer cost in phase 6(a) is "
                "logged above)"
                % (wall, times["admm_solve_s"],
                   int(sum(int(n) for n in out["samples"])), cost))
            if p.MOSAP_output is not out:
                raise AssertionError("solve(solver=admm) reran the set-up")
            if not np.all(np.asarray(errs, float)
                          <= 1.0001 * np.asarray(eps)):
                raise AssertionError("ADMM allocation: errs %s above eps %s"
                                     % (errs, eps))
            _within_bars("Matern MLBLUE (ADMM allocation) vs MC", mus, errs,
                         matern["mc_mean"], matern["mc_se"])
    finally:
        polish_mod.polish_eps = real_polish
    c_ipm = fam["sdp"]["cost"]
    for solver, tol in (("admm", 1e-3), ("scipy", 1e-3), ("spg", 0.10)):
        rel = abs(fam[solver]["cost"] - c_ipm) / c_ipm
        log("family %-5s: cost over the IPM's - 1 = %+.3e (gate %.0e)"
            % (solver, fam[solver]["cost"] / c_ipm - 1.0, tol))
        if not rel <= tol:
            raise AssertionError("%s cost %.10g not within %g of the IPM's "
                                 "%.10g" % (solver, fam[solver]["cost"], tol,
                                            c_ipm))
    if p.MOSAP.n_nlp_fallbacks != 0:
        raise AssertionError("a cone family fell back to the NLP (%d times)"
                             % p.MOSAP.n_nlp_fallbacks)

    # the Newton polish removes each cone solver's own error: the IPM's
    # point, polished through setup_solver as ADMM's was above
    p.MOSAP.polish_report = None
    t0 = time.perf_counter()
    p.setup_solver(K=4, eps=eps, solver="sdp", continuous_relaxation=True,
                   optimization_solver_params=polished)
    check_polish("sdp", time.perf_counter() - t0, fam["sdp"]["cost"])
    rel = abs(pol["sdp"] - pol["admm"]) / pol["sdp"]
    log("polished costs: IPM %.14g ADMM %.14g, rel diff %.3e"
        % (pol["sdp"], pol["admm"], rel))
    if not rel <= 1e-8:
        raise AssertionError("polished costs differ by %.3e > 1e-8" % rel)


def phase_warm_and_polished(flagship, times, launches_by_path):
    """7(b): on phase 4's problem (pilot paid), a cold and a warm rebuild
    of the budget allocation, the polished target-RMSE solve sampled
    through K1, and the projected-gradient family at phase 4's budget."""
    import numpy as np
    from bluest_tpu_torch.solvers import sdp
    problem, budget = flagship["problem"], flagship["budget"]
    eps_star = flagship["eps_star"]

    sdp._WARM_CACHE.clear()
    runs = []
    for tag in ("cold", "warm"):
        problem._mosap_key = None   # a fresh MOSAP: no ray or structure cache
        t0 = time.perf_counter()
        problem.setup_solver(K=K, budget=budget)
        wall = time.perf_counter() - t0
        out = problem.MOSAP_output
        solves = _cone_solves(out["certificates"])
        ipm_s = sum(c["dims"]["wall_s"] for c in out["certificates"])
        cont = float(problem.MOSAP.continuous_solution @ problem.MOSAP.costs)
        runs.append({"solves": solves, "wall_s": wall, "ipm_s": ipm_s,
                     "iterations": sum(s[2] for s in solves),
                     "cont_cost": cont, "samples": np.array(out["samples"]),
                     "maxvar": float(max(out["variances"]))})
        times["alloc_%s_s" % tag] = wall
        times["ipm_%s_s" % tag] = ipm_s
        log("%s rebuild: setup_solver %.3f s of which cone solves %.3f s, "
            "%d iterations %s, continuous cost %.10g, max variance %.8e"
            % (tag, wall, ipm_s, runs[-1]["iterations"], solves, cont,
               runs[-1]["maxvar"]))
    cold, warm = runs
    if any(s[3] for s in cold["solves"]):
        raise AssertionError("a cold solve reports a warm start")
    if not all(s[3] for s in warm["solves"]):
        raise AssertionError("the second rebuild did not start warm: %s"
                             % warm["solves"])
    if not warm["iterations"] < cold["iterations"]:
        raise AssertionError("warm %d iterations, cold %d"
                             % (warm["iterations"], cold["iterations"]))
    if not abs(warm["cont_cost"] - cold["cont_cost"]) \
            <= 1e-6 * cold["cont_cost"]:
        raise AssertionError("warm continuous cost %.10g, cold %.10g"
                             % (warm["cont_cost"], cold["cont_cost"]))
    same = np.array_equal(warm["samples"], cold["samples"])
    log("warm vs cold: same integer samples %s, max-variance rel diff %.3e"
        % (same, abs(warm["maxvar"] - cold["maxvar"]) / cold["maxvar"]))
    if not (same or abs(warm["maxvar"] - cold["maxvar"])
            <= 1e-3 * cold["maxvar"]):
        raise AssertionError("warm and cold allocations differ")

    # the polished target-RMSE allocation, sampled through K1
    problem.MOSAP.polish_report = None
    t0 = time.perf_counter()
    problem.setup_solver(K=K, eps=eps_star,
                         optimization_solver_params={"polish": True})
    times["alloc_polished_s"] = time.perf_counter() - t0
    out = problem.MOSAP_output
    ratio = float(max(out["variances"])) / eps_star ** 2
    log("polished eps* allocation: %.3f s, cost %.10g, max V/eps*^2 %.6f, "
        "polish report %s, cone solves %s"
        % (times["alloc_polished_s"], out["cost"], ratio,
           problem.MOSAP.polish_report, _cone_solves(out["certificates"])))
    if not ratio <= 1.0001:
        raise AssertionError("polished: max V/eps*^2 = %.6f" % ratio)
    mus, errs, cost, s, n, need = _run_path(
        "mlblue_polished",
        lambda: problem.solve(
            K=K, eps=eps_star,
            optimization_solver_params={"polish": True}),
        lambda: (out["flattened_groups"], out["samples"]), launches_by_path)
    times["sample_polished_s"] = s
    log("MLBLUE polished @eps*: sample_s %.3f, cost %.10g, K1 launches %d "
        "(chunk evaluations %d)" % (s, cost, n, need))
    if problem.MOSAP_output is not out:
        raise AssertionError("solve(eps=eps*) reran the allocation")
    if not np.all(np.asarray(errs, float) <= 1.0001 * eps_star):
        raise AssertionError("polished: errs %s above eps*" % (errs,))
    _within_bars("polished MLBLUE vs phase 4", mus, errs, flagship["mus"],
                 flagship["errs"])

    # the projected-gradient family at phase 4's budget
    t0 = time.perf_counter()
    problem.setup_solver(K=K, budget=budget, solver="spg",
                         continuous_relaxation=True)
    times["alloc_spg_s"] = time.perf_counter() - t0
    m = np.asarray(problem.MOSAP.samples, float)
    spent = float(m @ problem.MOSAP.costs)
    v_spg = float(max(problem.MOSAP.variances(m)))
    problem.setup_solver(K=K, budget=budget, continuous_relaxation=True)
    v_ipm = float(max(problem.MOSAP_output["variances"]))
    log("SPG at the budget: %.3f s, spent %.10g of %.10g, max variance "
        "%.8e over the IPM's continuous %.8e = %.4f"
        % (times["alloc_spg_s"], spent, budget, v_spg, v_ipm, v_spg / v_ipm))
    if not (spent <= budget * (1 + 1e-9) and np.all(m >= 0)
            and np.isfinite(v_spg)):
        raise AssertionError("SPG point infeasible: spent %.10g of %.10g"
                             % (spent, budget))


def phase_allocation_families(flagship, matern, launches_by_path):
    """Phase 7: every part raises on failure; nothing is caught."""
    times = {}
    t0 = time.perf_counter()
    for name, run in (
            ("a", lambda: phase_solver_families(matern, times)),
            ("b", lambda: phase_warm_and_polished(flagship, times,
                                                  launches_by_path))):
        t = time.perf_counter()
        run()
        times["part_%s_s" % name] = time.perf_counter() - t
        log("phase 7(%s): %.3f s" % (name, times["part_%s_s" % name]))
    log("phase 7: %.3f s; %s" % (time.perf_counter() - t0,
                                 json.dumps({k: round(v, 6)
                                             for k, v in times.items()})))


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _flagship_from_graph(graph, **params):
    """The flagship problem from its saved graph: no pilot is sampled, so
    its call counter starts at 0.  ``dtype`` defaults to f32."""
    import torch
    from bluest_tpu_torch.models.diffusion import DiffusionProblem
    params.setdefault("dtype", torch.float32)
    return DiffusionProblem(
        grids=GRIDS, n_kl=N_KL, sigma=SIGMA, nu=NU, multi_output=True,
        device_batch_size=BATCH, datafile=graph, verbose=False, **params)


def _counted_solve(problem, **how):
    """solve() with K1's count set to 0 just before and read just after,
    the sums of its one _pipelined_sumse call, and the all_reduce(SUM)
    and host-copy calls of its fetches (a problem's first fetch under a
    mesh also agrees on the model's output dimension, one 8-byte
    all_reduce(MAX) counted apart as "agree")."""
    import torch
    from bluest_tpu_torch.ops import diffusion as k1
    seen, calls = [], {"reduce": 0, "copy": 0, "agree": 0}
    real_sumse, real_copy = problem._pipelined_sumse, problem._sums_to_host

    def sumse(group_list, n_list):
        out = real_sumse(group_list, n_list)
        seen.append(out)
        return out

    def copy(flat):
        calls["copy"] += 1
        return real_copy(flat)

    problem._pipelined_sumse, problem._sums_to_host = sumse, copy
    mesh = problem.mesh
    if mesh is not None:
        real_reduce = mesh.all_reduce_samples

        def reduce(x, op="sum"):
            calls["reduce" if op == "sum" else "agree"] += 1
            return real_reduce(x, op)
        mesh.all_reduce_samples = reduce
    try:
        k1.diffusion_outputs.launches = 0
        t0 = time.perf_counter()
        mus, errs, cost = problem.solve(**how)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = k1.diffusion_outputs.launches
    finally:
        del problem._pipelined_sumse, problem._sums_to_host
        if mesh is not None:
            del mesh.all_reduce_samples
    (sums,) = seen
    return mus, errs, sums, launches, calls, wall


def _sums_gap(got, ref):
    """Largest |got - ref| over the largest |ref|, group by group."""
    import numpy as np
    worst = 0.0
    for g, r in zip(got, ref):
        if (g is None) != (r is None):
            raise AssertionError("the paths sampled different groups")
        if g is not None:
            g, r = np.array(g, float), np.array(r, float)
            worst = max(worst, float(np.abs(g - r).max() / np.abs(r).max()))
    return worst


def _rank_main(rank, world, port, graph, budget, workdir):
    """One rank of phase 8(b).  Raises on any failure: the parent joins
    the ranks and fails the run on a non-zero exit code."""
    import datetime
    import pickle
    import numpy as np
    import torch
    from bluest_tpu_torch.parallel import initialize_distributed, sample_mesh
    initialize_distributed(
        backend="gloo", init_method="tcp://localhost:%d" % port,
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        mesh = sample_mesh()
        p = _flagship_from_graph(graph, mesh=mesh)
        _check_on_sampling_device(p)
        t0 = time.perf_counter()
        p.setup_solver(K=K, budget=budget)
        alloc_s = time.perf_counter() - t0
        mus, errs, sums, launches, calls, wall = _counted_solve(
            p, K=K, budget=budget)
        res = {"samples": np.array(p.MOSAP_output["samples"]),
               "groups": [list(g) for g in
                          p.MOSAP_output["flattened_groups"]],
               "mus": np.asarray(mus, float), "errs": np.asarray(errs, float),
               "sums": sums, "launches": launches, "calls": calls,
               "alloc_s": alloc_s, "sample_s": wall}
        # phase 6(c)'s snapshot solve under the mesh
        ps = _flagship_from_graph(
            graph, mesh=mesh, outputs_to_save=[0],
            samplefile=os.path.join(workdir, "two.npz"))
        ps.setup_solver(K=2, budget=SNAP_BUDGET)
        _, _, sums, launches, _, wall = _counted_solve(ps, K=2,
                                                       budget=SNAP_BUDGET)
        res.update(snap_samples=np.array(ps.MOSAP_output["samples"]),
                   snap_groups=[list(g) for g in
                                ps.MOSAP_output["flattened_groups"]],
                   snap_sums=sums, snap_launches=launches, snap_s=wall)
        with open(os.path.join(workdir, "rank%d.pkl" % rank), "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


def phase_distribution(flagship, graph, launches_by_path):
    """Phase 8: the mesh path on the one card, on problems loaded from
    phase 4's saved graph.  Nothing is caught."""
    import glob
    import pickle
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from bluest_tpu_torch.ops import diffusion as k1
    from bluest_tpu_torch.parallel import initialize_distributed, sample_mesh
    from bluest_tpu_torch.solvers import sdp
    budget = flagship["budget"]
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        # (a) one rank, nccl
        t0 = time.perf_counter()
        initialize_distributed(
            backend="nccl", init_method="tcp://localhost:%d" % _free_port(),
            world_size=1, rank=0)
        try:
            mesh = sample_mesh()
            pa = _flagship_from_graph(graph, mesh=mesh)
            pa.setup_solver(K=K, budget=budget)
            out = pa.MOSAP_output
            groups = [list(g) for g in out["flattened_groups"]]
            ns = [int(n) for n in out["samples"]]
            mus, errs, sums, launches, calls, wall = _counted_solve(
                pa, K=K, budget=budget)
        finally:
            torch.distributed.destroy_process_group()
        need = _chunk_evals(groups, ns)
        ref = _flagship_from_graph(graph)._pipelined_sumse(groups, ns)
        gap = _sums_gap(sums, ref)
        launches_by_path["mesh_one_rank"] = launches
        log("8(a) one rank, nccl, sample_mesh(): %d samples in %.3f s, K1 "
            "launches %d (chunk evaluations %d), %d all_reduce and %d host "
            "copy in the solve, sums against the mesh-less path: max rel "
            "diff %.3e; part %.3f s"
            % (sum(ns), wall, launches, need, calls["reduce"], calls["copy"],
               gap, time.perf_counter() - t0))
        if gap != 0.0:
            raise AssertionError("8(a): the one-rank mesh sums are not "
                                 "bit-equal to the mesh-less sums")
        if launches != need or need == 0:
            raise AssertionError("8(a): K1 launched %d times for %d chunk "
                                 "evaluations" % (launches, need))
        if (calls["reduce"], calls["copy"]) != (1, 1) or calls["agree"] > 1:
            raise AssertionError("8(a): %s per solve, expected one all_reduce "
                                 "and one copy" % calls)
        _within_bars("8(a) mesh MLBLUE vs phase 4", mus, errs,
                     flagship["mus"], flagship["errs"])

        # (b) two ranks on the one card, gloo.  mp.spawn joins the ranks
        # and raises if any of them exits with a non-zero code.
        t0 = time.perf_counter()
        mp.spawn(_rank_main, args=(2, _free_port(), graph, budget, d),
                 nprocs=2, join=True)
        ranks = []
        for r in range(2):
            with open(os.path.join(d, "rank%d.pkl" % r), "rb") as f:
                ranks.append(pickle.load(f))
        spawn_s = time.perf_counter() - t0
        r0, r1 = ranks
        if not (np.array_equal(r0["samples"], r1["samples"])
                and np.array_equal(r0["mus"], r1["mus"])
                and np.array_equal(r0["snap_samples"], r1["snap_samples"])):
            raise AssertionError("8(b): the ranks disagree on the allocation "
                                 "or the estimates")
        groups, ns = r0["groups"], [int(n) for n in r0["samples"]]
        one = _flagship_from_graph(graph)
        k1.diffusion_outputs.launches = 0
        ref = one._pipelined_sumse(groups, ns)
        torch.cuda.synchronize()
        one_launches = k1.diffusion_outputs.launches
        gap = max(_sums_gap(r["sums"], ref) for r in ranks)
        two_launches = r0["launches"] + r1["launches"]
        launches_by_path["mesh_two_ranks"] = two_launches
        log("8(b) two ranks, gloo, one card: %d samples, rank walls %.3f / "
            "%.3f s (allocation %.3f / %.3f s), K1 launches %d + %d = %d "
            "(one process %d, chunk evaluations %d), all_reduce / host "
            "copies per solve %s / %s, sums against one process: max rel "
            "diff %.3e; spawn to join %.3f s"
            % (sum(ns), r0["sample_s"], r1["sample_s"], r0["alloc_s"],
               r1["alloc_s"], r0["launches"], r1["launches"], two_launches,
               one_launches, _chunk_evals(groups, ns), r0["calls"],
               r1["calls"], gap, spawn_s))
        if not gap <= 1e-12:
            raise AssertionError("8(b): two-rank sums differ from the "
                                 "one-process sums by %.3e > 1e-12" % gap)
        if not (two_launches == one_launches == _chunk_evals(groups, ns)
                and r0["launches"] > 0 and r1["launches"] > 0):
            raise AssertionError("8(b): the ranks' K1 launches do not add "
                                 "up to the one-process count")
        if any((r["calls"]["reduce"], r["calls"]["copy"]) != (1, 1)
               or r["calls"]["agree"] > 1 for r in ranks):
            raise AssertionError("8(b): more than one all_reduce or copy "
                                 "per solve")
        _within_bars("8(b) two-rank MLBLUE vs phase 4", r0["mus"],
                     r0["errs"], flagship["mus"], flagship["errs"])

        # the snapshot solve: rank 0's files against one process's, from
        # rank 0's allocation
        sg = r0["snap_groups"]
        sn = [int(n) for n in r0["snap_samples"]]
        one = _flagship_from_graph(graph, outputs_to_save=[0],
                                   samplefile=os.path.join(d, "one.npz"))
        k1.diffusion_outputs.launches = 0
        ref = one._pipelined_sumse(sg, sn)
        torch.cuda.synchronize()
        one_launches = k1.diffusion_outputs.launches
        gap = max(_sums_gap(r["snap_sums"], ref) for r in ranks)
        two_launches = r0["snap_launches"] + r1["snap_launches"]
        launches_by_path["mesh_two_ranks_snapshots"] = two_launches
        two = sorted(glob.glob(os.path.join(d, "two*.npz")))
        ones = sorted(glob.glob(os.path.join(d, "one*.npz")))
        rows = 0
        if not two or [os.path.basename(f)[3:] for f in two] \
                != [os.path.basename(f)[3:] for f in ones]:
            raise AssertionError("8(b): snapshot files %s against %s"
                                 % (two, ones))
        for ft, fo in zip(two, ones):
            with np.load(ft) as zt, np.load(fo) as zo:
                if sorted(zt.files) != sorted(zo.files):
                    raise AssertionError("8(b): keys of %s" % ft)
                for key in zo.files:
                    if not np.array_equal(zt[key], zo[key]):
                        raise AssertionError("8(b): %s of %s differs from "
                                             "the one-process file"
                                             % (key, os.path.basename(ft)))
                rows += int(zo["n_samples"][0])
        log("8(b) snapshots under two ranks: %d group files by rank 0 alone, "
            "%d rows, equal to the one-process files key for key; K1 "
            "launches %d + %d (one process %d); sums max rel diff %.3e"
            % (len(two), rows, r0["snap_launches"], r1["snap_launches"],
               one_launches, gap))
        if not (gap <= 1e-12 and two_launches == one_launches > 0
                and rows == sum(sn)):
            raise AssertionError("8(b): snapshot solve sums, launches or "
                                 "rows off")
    sdp._WARM_CACHE.clear()
    log("the model axis (sample_matern2d_sharded) needs one card per rank "
        "for nccl and is not run on this one card; the CPU tests hold it "
        "against the unsharded field (tests/test_torch_mesh.py)")
    log("phase 8: %.3f s" % (time.perf_counter() - t_phase))


def _front_door_module(name):
    """Import a script of examples/torch/ or tutorials/ by name, its
    directory on sys.path (spawned host workers import it from there)."""
    import importlib
    here = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(here, FRONT_DOOR[name])
    if d not in sys.path:
        sys.path.insert(0, d)
    return importlib.import_module(name)


def _run_script(name, argv, times):
    """``main(argv)`` of one front-door script in this process: its
    printed output goes to build/chip_smoke/phase9/<name>.log, its last
    lines to this log; returns (result, printed text)."""
    import io
    mod = _front_door_module(name)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = mod.main(list(argv))
    _sync()
    times[name + "_s"] = time.perf_counter() - t0
    text = buf.getvalue()
    logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke", "phase9")
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, name + ".log"), "w") as f:
        f.write(text)
    log("%s %s: %.3f s; its last lines:" % (name, " ".join(argv),
                                            times[name + "_s"]))
    for line in text.rstrip().splitlines()[-ECHO_LINES:]:
        log("  | " + line)
    return res, text


@contextlib.contextmanager
def counting_chunk_evals():
    """Count, in the list it yields, the chunk evaluations that sampling
    asks for: every device sampling call passes through
    BLUEProblem._device_sums, at the problem's own chunk size.  Item 0 is
    the count, item 1 the count per model index."""
    from bluest_tpu_torch import BLUEProblem
    need = [0, {}]
    real = BLUEProblem._device_sums

    def counted(self, calls):
        for key_ls, N, *_rest in calls:
            if N > 0:
                chunks = math.ceil(N / int(self.params["device_batch_size"]))
                need[0] += len(key_ls) * chunks
                for l in key_ls:
                    need[1][l] = need[1].get(l, 0) + chunks
        return real(self, calls)

    BLUEProblem._device_sums = counted
    try:
        yield need
    finally:
        BLUEProblem._device_sums = real


def _ex_diffusion(times, launches_by_path):
    """9(a): the diffusion example through K1, with its tests."""
    import numpy as np
    import torch
    from bluest_tpu_torch.models.diffusion import DiffusionProblem
    from bluest_tpu_torch.ops import diffusion as k1
    mod = _front_door_module("single_output_diffusion")
    with counting_chunk_evals() as need:
        k1.diffusion_outputs.launches = 0
        res, _ = _run_script("single_output_diffusion", ["--tests"], times)
        launches = k1.diffusion_outputs.launches
    launches_by_path["example_diffusion"] = launches
    log("9(a) K1 launches %d (chunk evaluations %d)" % (launches, need[0]))
    if not launches == need[0] > 0:
        raise AssertionError("9(a): K1 launched %d times for %d chunk "
                             "evaluations" % (launches, need[0]))

    # MC of model 0 through K1 (these launches are not the example's)
    m = len(mod.GRIDS)
    p = DiffusionProblem(grids=mod.GRIDS, n_kl=mod.N_KL, sigma=mod.SIGMA,
                         nu=mod.NU, C=np.eye(m), costs=np.ones(m),
                         verbose=False)
    _check_on_sampling_device(p)
    gen = torch.Generator(device=DEV).manual_seed(8)
    s1 = torch.zeros((), dtype=torch.float64, device=DEV)
    s2 = torch.zeros_like(s1)
    t0 = time.perf_counter()
    for _ in range(EX_DIFFUSION_MC // EX_DIFFUSION_MC_CHUNK):
        q = p.evaluate_model(0, p.sample_inputs(
            gen, EX_DIFFUSION_MC_CHUNK))[:, 0]
        s1 += q.sum()
        s2 += (q * q).sum()
    mean = float(s1) / EX_DIFFUSION_MC
    var = float(s2) / EX_DIFFUSION_MC - mean ** 2
    log("9(a) MC reference: %d samples of model 0 through K1 in %.3f s"
        % (EX_DIFFUSION_MC, time.perf_counter() - t0))
    _within_bars("9(a) example MLBLUE vs MC", [res["mu"]], [res["err"]],
                 [mean], [math.sqrt(var / EX_DIFFUSION_MC)])
    ratio = np.asarray(res["variance_empirical"]) \
        / np.asarray(res["variance_predicted"])
    log("9(a) complexity rate %.6f (costs %s), variance_test ratio %s"
        % (res["complexity_rate"], list(res["complexity_costs"]),
           ratio.tolist()))
    if not 1.9 <= res["complexity_rate"] <= 2.1:
        raise AssertionError("9(a): complexity rate %.4f outside [1.9, 2.1]"
                             % res["complexity_rate"])
    if not np.all((ratio >= 0.5) & (ratio <= 1.6)):
        raise AssertionError("9(a): variance_test ratio %s outside [0.5, "
                             "1.6]" % ratio)


def _ex_matern(times):
    """9(b): the pilot-size sweep meets every eps; one finite estimate."""
    import numpy as np
    res, _ = _run_script("matern_restrictions", [], times)
    for a in res["allocations"]:
        if not np.all(a["errors"] <= 1.0001 * np.asarray(a["eps"])):
            raise AssertionError("9(b): pilot %d: errors %s above eps %s"
                                 % (a["pilot"], a["errors"], a["eps"]))
    if not (np.isfinite(res["mu"]) and res["err"] > 0):
        raise AssertionError("9(b): estimate %r +- %r" % (res["mu"],
                                                          res["err"]))
    log("9(b) %d allocations within their eps; estimate %.6g +- %.3g"
        % (len(res["allocations"]), res["mu"], res["err"]))


def _ex_hodgkin_huxley(times, hh_launches, hh_by_variant):
    """9(c): the HH example as it ships (the 6-model subset, a pilot of
    1024) and with --full (the paper's 12 models), each with K2's count
    set to 0 just before and read just after: its launches equal to the
    run's group evaluations, output 0 within 4 error bars of an MC
    estimate of its model 0 on the card."""
    import numpy as np
    import torch
    from bluest_tpu_torch.models import hodgkin_huxley as hh
    from bluest_tpu_torch.ops import hodgkin_huxley as k2
    name = "multi_output_hodgkin_huxley"
    for argv, path in (([], "hh_example"), (["--full"], "hh_example_full")):
        with counting_group_evals() as evals:
            k2.hh_group_outputs.launches = 0
            for v in k2.hh_group_outputs.launches_by_variant:
                k2.hh_group_outputs.launches_by_variant[v] = 0
            res, _ = _run_script(name, argv, times)
            launches = k2.hh_group_outputs.launches
            by_variant = dict(k2.hh_group_outputs.launches_by_variant)
        times[path + "_s"] = times.pop(name + "_s")
        hh_launches[path] = launches
        hh_by_variant[path] = by_variant
        log("9(c) %s: K2 launches %d (group evaluations %d), by variant %s"
            % (" ".join([name] + argv), launches, evals[0], by_variant))
        if not (launches == evals[1] == evals[0] > 0
                and sum(by_variant.values()) == launches):
            raise AssertionError("9(c): K2 launched %d times for %d group "
                                 "evaluations" % (launches, evals[0]))
        est, errs = np.asarray(res["estimates"]), np.asarray(res["errors"])
        if not (np.all(np.isfinite(est)) and np.all(np.isfinite(errs))):
            raise AssertionError("9(c): estimates %s errors %s"
                                 % (est, errs))
        models = tuple(res["models"])
        m = len(models)
        p = hh.HodgkinHuxleyProblem(models=models,
                                    C=[np.eye(m)] * hh.N_OUTPUTS,
                                    verbose=False)
        _check_on_sampling_device(p)
        t0 = time.perf_counter()
        q = hh.hh_outputs(*models[0], p.sample_group(
            torch.Generator(device=DEV).manual_seed(9), (0,), EX_HH_MC))
        if not bool(torch.isfinite(q).all()):
            raise AssertionError("9(c): HH model 0 gave non-finite outputs")
        q = q[:, 0].cpu().numpy()
        log("9(c) MC reference: %d samples of model 0 %s in %.3f s"
            % (EX_HH_MC, models[0], time.perf_counter() - t0))
        _within_bars("9(c) %s output 0 vs MC" % path, est[:1], errs[:1],
                     [q.mean()], [q.std() / np.sqrt(EX_HH_MC)])


def _ex_navier_stokes(times):
    """9(d): the NS study on a written 12-model, 6-output graph."""
    import numpy as np
    mod = _front_door_module("navier_stokes_study")
    with tempfile.TemporaryDirectory() as d:
        mod.NS_NPZ = os.path.join(d, "ns_graph.npz")
        write_ns_graph(mod.NS_NPZ)
        with np.load(mod.NS_NPZ, allow_pickle=True) as z:
            shape = (int(z["M"]), int(z["n_outputs"]))
        res, _ = _run_script("navier_stokes_study", [], times)
    c = res["costs"]
    log("9(d) graph %s; offline costs MLBLUE %.1f, MFMC %.1f, MLMC %.1f; "
        "surrogate estimates within 5 RMSEs: %s"
        % (shape, c["mlblue"], c["mfmc"], c["mlmc"], res["within_5_rmse"]))
    if shape != (NS_MODELS, NS_OUTPUTS) or len(res["estimates"]) != 6:
        raise AssertionError("9(d): graph of %s models and outputs" % (shape,))
    if not c["mlblue"] <= min(c["mfmc"], c["mlmc"]):
        raise AssertionError("9(d): MLBLUE costs more than MFMC or MLMC: "
                             "%s" % c)
    if not res["within_5_rmse"]:
        raise AssertionError("9(d): the surrogate's assert did not hold")


def _ex_nested(times):
    """9(e): nested pools against one-process evaluations."""
    import numpy as np
    res, _ = _run_script("nested_blackbox_parallel", [], times)
    a = np.round(res["diagonal"], 5)
    b = np.round(res["serial_diagonal"], 5)
    log("9(e) covariance diagonals: nested %s, one process %s"
        % (a.tolist(), b.tolist()))
    if not np.array_equal(a, b):
        raise AssertionError("9(e): the diagonals differ at 5 decimals")


def _tutorial(times):
    """9(f): the tutorial, all six parts."""
    _, text = _run_script("01_tutorial_torch", [], times)
    if not text.rstrip().endswith("Tutorial completed."):
        raise AssertionError("9(f): the tutorial did not complete")


def phase_front_door(launches_by_path, hh_launches, hh_by_variant):
    """Phase 9: every part raises on failure; nothing is caught."""
    times = {}
    t0 = time.perf_counter()
    for name, run in (
            ("a", lambda: _ex_diffusion(times, launches_by_path)),
            ("b", lambda: _ex_matern(times)),
            ("c", lambda: _ex_hodgkin_huxley(times, hh_launches,
                                             hh_by_variant)),
            ("d", lambda: _ex_navier_stokes(times)),
            ("e", lambda: _ex_nested(times)),
            ("f", lambda: _tutorial(times))):
        t = time.perf_counter()
        run()
        times["part_%s_s" % name] = time.perf_counter() - t
        log("phase 9(%s): %.3f s" % (name, times["part_%s_s" % name]))
    log("phase 9: %.3f s; %s" % (time.perf_counter() - t0,
                                 json.dumps({k: round(v, 6)
                                             for k, v in times.items()})))


def phase_deep_flagship(smi):
    """Phase 10: the deep-grid flagship (DEEP_GRIDS, N_KL_DEEP modes, f64)
    end to end on the default device: models 0 and 1 through K1's wide
    tier, the rest through K1.  Pilot, calibrated K=4 budget allocation
    and solve(), with the counts set to 0 just before the pilot and read
    just after the solve (launches per tier = chunk evaluations per
    tier), DEEP_REPS more solves timed, and the gates: max_rel_err <
    0.01, MLBLUE's q_int within 4 error bars of an f64 MC of model 0
    through the wide tier (DEEP_MC draws), and that MC's q_energy =
    q_int."""
    import numpy as np
    import torch
    from bluest_tpu_torch.models.diffusion import DiffusionProblem
    from bluest_tpu_torch.ops import diffusion as k1
    t_phase = time.perf_counter()
    tiers = [k1.tier(g, N_KL_DEEP, torch.float64) for g in DEEP_GRIDS]
    if tiers[:2] != ["wide", "wide"] or set(tiers[2:]) != {"k1"}:
        raise AssertionError("deep flagship tiers %s" % tiers)
    by_tier = k1.diffusion_outputs.launches_by_tier
    # the counted run: pilot, allocation and the first solve
    with counting_chunk_evals() as need:
        k1.diffusion_outputs.launches = 0
        for t in by_tier:
            by_tier[t] = 0
        t0 = time.perf_counter()
        problem = DiffusionProblem(
            grids=DEEP_GRIDS, n_kl=N_KL_DEEP, sigma=SIGMA, nu=NU,
            multi_output=True, covariance_estimation_samples=PILOT,
            dtype=torch.float64, device_batch_size=BATCH, verbose=False)
        torch.cuda.synchronize()
        pilot_s = time.perf_counter() - t0
        pilot_launches = dict(by_tier)
        budget, alloc_s = _calibrated_allocation(problem)
        t0 = time.perf_counter()
        mus, errs, cost = problem.solve(K=K, budget=budget)
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        launches = dict(by_tier)
    _check_on_sampling_device(problem)
    C0 = problem.get_covariance(0)
    log("10 pilot (%d samples x %d models, n_kl %d, f64) + SPD projection: "
        "%.3f s, launches per tier %s; covariance eigenvalues (q_int) min "
        "%.3e max %.3e" % (PILOT, len(DEEP_GRIDS), N_KL_DEEP, pilot_s,
                           pilot_launches, np.linalg.eigvalsh(C0).min(),
                           np.linalg.eigvalsh(C0).max()))
    out = problem.MOSAP_output
    certs = out["certificates"]
    groups = [list(g) for g, n in zip(out["flattened_groups"], out["samples"])
              if n > 0]
    ns = [int(n) for n in out["samples"] if n > 0]
    log("10 allocation: L=%d, budget %.6g, %d samples, alloc_s %.3f, "
        "certificates %s; %d active groups %s"
        % (problem.MOSAP.L, budget, _total_samples(problem), alloc_s,
           [(c["form"], c["status"], c["iterations"]) for c in certs],
           len(groups), list(zip(groups, ns))))
    if problem.MOSAP.L != 385:
        raise AssertionError("expected L=385 groups, got %d"
                             % problem.MOSAP.L)
    if not certs or any(c["status"] not in ("optimal", "inaccurate")
                        for c in certs):
        raise AssertionError("IPM certificate not ok: %s" % certs)
    need_tier = {t: sum(c for l, c in need[1].items() if tiers[l] == t)
                 for t in by_tier}
    n_evals = sum(len(g) * n for g, n in zip(groups, ns))
    log("10 first solve: %d samples, %d model evaluations in %.3f s = %.0f "
        "evals/s; pilot + solve launches per tier %s, chunk evaluations per "
        "tier %s" % (sum(ns), n_evals, sample_s, n_evals / sample_s,
                     launches, need_tier))
    if launches != need_tier or not all(launches.values()):
        raise AssertionError("10: launches per tier %s, chunk evaluations "
                             "per tier %s" % (launches, need_tier))

    walls = []
    for _ in range(DEEP_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        problem.solve(K=K, budget=budget)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log("10 sample_s through solve: median %.6f s, min %.6f, max %.6f over "
        "%d runs (%s)" % (statistics.median(walls), min(walls), max(walls),
                          len(walls), smi))

    mus = np.asarray(mus, dtype=float)
    errs = np.asarray(errs, dtype=float)
    rel_err = float(np.max(errs) / abs(mus[0]))
    log("10 mus %s errs %s max_rel_err %.4g"
        % (mus.tolist(), errs.tolist(), rel_err))
    if not (np.all(np.isfinite(mus)) and np.all(np.isfinite(errs))):
        raise AssertionError("10: non-finite estimates")
    if not rel_err < 0.01:
        raise AssertionError("10: max(errs)/|mus[0]| = %.4g >= 0.01"
                             % rel_err)

    # the reference: an f64 MC of model 0, through the wide tier
    gen = torch.Generator(device=DEV).manual_seed(10)
    s1 = torch.zeros(4, dtype=torch.float64, device=DEV)
    s2 = torch.zeros_like(s1)
    wide0 = by_tier["wide"]
    t0 = time.perf_counter()
    for c in range(math.ceil(DEEP_MC / BATCH)):
        q = problem.evaluate_model(0, problem.sample_inputs(
            gen, min(BATCH, DEEP_MC - c * BATCH)))
        q = torch.cat([q, (q[:, 2] - q[:, 0])[:, None]], dim=1)
        s1 += q.sum(dim=0)
        s2 += (q * q).sum(dim=0)
    mean = (s1 / DEEP_MC).cpu().numpy()
    se = np.sqrt(np.maximum((s2 / DEEP_MC).cpu().numpy() - mean ** 2, 0.0)
                 / DEEP_MC)
    log("10 MC of model 0: %d draws through the wide tier (%d launches) in "
        "%.3f s: mean %s se %s; q_energy - q_int per draw: mean %.3e"
        % (DEEP_MC, by_tier["wide"] - wide0, time.perf_counter() - t0,
           mean[:3].tolist(), se[:3].tolist(), mean[3]))
    _within_bars("10 MLBLUE q_int vs MC of model 0", mus[:1], errs[:1],
                 mean[:1], se[:1])
    if not abs(mean[2] - mean[0]) <= 4 * float(np.max(se[:3])):
        raise AssertionError("10 MC: q_energy %.10g and q_int %.10g "
                             "disagree" % (mean[2], mean[0]))
    log("phase 10: %.3f s" % (time.perf_counter() - t_phase))
    return {"launches": launches, "pilot_s": pilot_s, "alloc_s": alloc_s,
            "sample_s": sample_s, "walls": walls}


HH_K_CARD = 5               # phase 11's HH width (the JAX package's L=792)
FP64_PEAK = 67e12           # FP64 tensor-core dense rate, H100 SXM (700 W)


@contextlib.contextmanager
def allocation_log(phase):
    """Log where a phase's allocations ran: the device of every MOSAP
    built and of every interior-point solve in it."""
    from bluest_tpu_torch.allocation import mosap
    from bluest_tpu_torch.solvers import sdp
    built, solved = {}, {}
    real_init, real_ipm = mosap.MOSAP.__init__, sdp._ipm_solve

    def init(self, *a, **k):
        real_init(self, *a, **k)
        built[str(self.device)] = built.get(str(self.device), 0) + 1

    def ipm(*a, **k):
        d = str(a[0].device)
        solved[d] = solved.get(d, 0) + 1
        return real_ipm(*a, **k)

    mosap.MOSAP.__init__, sdp._ipm_solve = init, ipm
    try:
        yield
    finally:
        mosap.MOSAP.__init__, sdp._ipm_solve = real_init, real_ipm
        log("%s allocations: MOSAPs built on %s, cone solves on %s"
            % (phase, json.dumps(built, sort_keys=True),
               json.dumps(solved, sort_keys=True)))


@contextlib.contextmanager
def allocation_split(rec):
    """Time the parts of one set-up into ``rec``: psi assembly, the IPM
    (its wall and iterations), the cleanup walk, the integer projection.
    Each part ends with a synchronise of the card, so its time is the
    device's too."""
    from bluest_tpu_torch.allocation import mosap
    from bluest_tpu_torch.core import psi as psimod
    from bluest_tpu_torch.solvers import sdp
    for k in ("psi_s", "ipm_s", "cleanup_s", "integer_s"):
        rec[k] = 0.0
    rec["iterations"], rec["dims"] = 0, []
    real = (psimod.GroupData.__dict__["build"], sdp._ipm_solve,
            mosap.MOSAP.cleanup_solution, mosap.MOSAP.integer_projection)

    def timed(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            _sync()
            rec[key] += time.perf_counter() - t0
            return out
        return run

    def ipm(*a, **k):
        out = timed("ipm_s", real[1])(*a, **k)
        rec["iterations"] += out[1]
        return out

    psimod.GroupData.build = classmethod(timed("psi_s", real[0].__func__))
    sdp._ipm_solve = ipm
    mosap.MOSAP.cleanup_solution = timed("cleanup_s", real[2])
    mosap.MOSAP.integer_projection = timed("integer_s", real[3])
    try:
        yield rec
    finally:
        psimod.GroupData.build = real[0]
        sdp._ipm_solve = real[1]
        mosap.MOSAP.cleanup_solution = real[2]
        mosap.MOSAP.integer_projection = real[3]


@contextlib.contextmanager
def setup_probes(rec):
    """allocation_split's parts of the set-ups run in the block, plus the
    host wall of each IPM graph capture (the warm-up's enqueue, the
    capture, the instantiation) and of every call of the IPM's K3/K4
    wrappers (sdp._eigvalsh, sdp._svd), its Cholesky (sdp._cholesky:
    cholesky_ex) and torch.linalg.solve_triangular (cuBLAS), none of them
    synchronised: a first call's excess over the later ones is host work
    done once a process (CUDA's lazy module load, a library's handle)."""
    import torch
    from bluest_tpu_torch.solvers import sdp
    rec["capture_s"] = []
    rec["calls"] = {k: [] for k in ("K3", "K4", "cholesky_ex",
                                    "solve_triangular")}
    real = {"K3": sdp._eigvalsh, "K4": sdp._svd,
            "cholesky_ex": sdp._cholesky,
            "solve_triangular": torch.linalg.solve_triangular}
    real_capture = sdp._IterationGraph._capture

    def walled(key):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = real[key](*a, **k)
            rec["calls"][key].append(time.perf_counter() - t0)
            return out
        return run

    def capture(self):
        t0 = time.perf_counter()
        real_capture(self)
        rec["capture_s"].append(time.perf_counter() - t0)

    sdp._eigvalsh, sdp._svd = walled("K3"), walled("K4")
    sdp._cholesky = walled("cholesky_ex")
    torch.linalg.solve_triangular = walled("solve_triangular")
    sdp._IterationGraph._capture = capture
    try:
        with allocation_split(rec):
            _sync()
            t0 = time.perf_counter()
            yield rec
            _sync()
            rec["wall_s"] = time.perf_counter() - t0
    finally:
        sdp._eigvalsh, sdp._svd = real["K3"], real["K4"]
        sdp._cholesky = real["cholesky_ex"]
        torch.linalg.solve_triangular = real["solve_triangular"]
        sdp._IterationGraph._capture = real_capture


def _probe_record(rec):
    """setup_probes' record as numbers: the wall and its parts (s), the
    captures (s), and per probed call its count, first wall and the
    median of the later ones (ms)."""
    out = {k: round(rec[k], 6) for k in ("wall_s", "psi_s", "ipm_s",
                                         "cleanup_s", "integer_s")}
    out["iterations"] = rec["iterations"]
    out["rest_s"] = round(rec["wall_s"] - sum(out[k] for k in (
        "psi_s", "ipm_s", "cleanup_s", "integer_s")), 6)
    out["capture_s"] = [round(c, 5) for c in rec["capture_s"]]
    out["calls"] = {
        k: {"count": len(v), "first_ms": round(1e3 * v[0], 4) if v else None,
            "later_median_ms": (round(1e3 * statistics.median(v[1:]), 4)
                                if len(v) > 1 else None)}
        for k, v in rec["calls"].items()}
    return out


def _probe_summary(rec):
    r = _probe_record(rec)
    return ("wall %.3f s = psi %.3f + IPM %.3f (%d iterations; %d graph "
            "captures %.3f s, the first %.3f s) + cleanup %.3f + integer "
            "%.3f + rest %.3f; host wall of the first call / median of the "
            "later ones (ms): %s"
            % (r["wall_s"], r["psi_s"], r["ipm_s"], r["iterations"],
               len(r["capture_s"]), sum(r["capture_s"]),
               r["capture_s"][0] if r["capture_s"] else float("nan"),
               r["cleanup_s"], r["integer_s"], r["rest_s"],
               ", ".join("%s %s / %s (%d calls)"
                         % (k, c["first_ms"], c["later_median_ms"],
                            c["count"]) for k, c in r["calls"].items())))


@contextlib.contextmanager
def recording_searches(calls):
    """Append to ``calls`` the arguments of every best_integer_blue_multi
    call that a MOSAP's integer projection makes in the block."""
    import copy
    from bluest_tpu_torch.allocation import mosap
    real = mosap.best_integer_blue_multi

    def rec(*a, **k):
        calls.append((copy.deepcopy(a), dict(k)))
        return real(*a, **k)
    mosap.best_integer_blue_multi = rec
    try:
        yield calls
    finally:
        mosap.best_integer_blue_multi = real


@contextlib.contextmanager
def counting_card_eigensolves(count):
    """Count in ``count`` the torch.linalg eigensolver and SVD calls made
    on CUDA tensors in the block (the card's allocation makes none: K3,
    K4 and K5 take their place)."""
    import torch
    names = ("eigh", "eigvalsh", "eig", "eigvals", "svd", "svdvals")
    real = {n: getattr(torch.linalg, n) for n in names}

    def wrap(n):
        def f(A, *a, **k):
            if isinstance(A, torch.Tensor) and A.is_cuda:
                count[n] = count.get(n, 0) + 1
            return real[n](A, *a, **k)
        return f
    for n in names:
        setattr(torch.linalg, n, wrap(n))
    try:
        yield count
    finally:
        for n in names:
            setattr(torch.linalg, n, real[n])


def _searches(mod, device, calls):
    """``mod.best_integer_blue_multi`` on each recorded call, on
    ``device``: (results, wall s)."""
    import copy
    from bluest_tpu_torch.config import allocation_device_scope
    args = [(copy.deepcopy(a), k) for a, k in calls]
    _sync()
    t0 = time.perf_counter()
    with allocation_device_scope(device):
        out = [mod.best_integer_blue_multi(*a, **k) for a, k in args]
    _sync()
    return out, time.perf_counter() - t0


def _same_results(a, b):
    """(the same samples from every search, the largest relative
    difference of the chosen corners' max-variances)."""
    import numpy as np
    same, dv = True, 0.0
    for (va, fa), (vb, fb) in zip(a, b):
        if va is None or vb is None:
            same &= va is None and vb is None
            continue
        same &= bool(np.array_equal(va, vb))
        dv = max(dv, abs(fa - fb) / abs(fb))
    return same, dv


def integer_search_gate(name, calls):
    """Phase 11's integer search alone, from the host set-up's continuous
    point (the recorded arguments of its best_integer_blue_multi calls),
    on the card and on the host: whether the samples are the same (the
    gate) and the chosen corners' max-variance gap, and the card's wall
    (after one warm run).  tools/integer_search_turns.py times it in
    turns with another integer.py."""
    from bluest_tpu_torch.solvers import integer
    _searches(integer, DEV, calls)             # warm: first calls
    card, wall = _searches(integer, DEV, calls)
    host = _searches(integer, "cpu", calls)[0]
    same, dv = _same_results(card, host)
    log("phase 11%s integer search from the host's continuous point (%d "
        "calls): card vs host same samples %s, chosen max-variance rel "
        "diff %.3e; card wall %.4f s" % (name, len(calls), same, dv, wall))
    return {"same_samples_card_host": same,
            "maxvar_rel_diff_card_host": dv, "card_wall_s": wall}


def _cold_setup(problem, where, how, loop=None):
    """One set-up from nothing: a fresh MOSAP (psi assembly included)
    and an empty warm cache, on the problem's device, the card
    (``where="card"``), or through BLUEST_TPU_ALLOC_DEVICE=cpu on the
    host (``where="host"``).  On the card ``loop="eager"`` runs the IPM's
    eager card loop (the graph path's reference); by default each
    iteration is a graph replay.  Records each cone solve's iterations,
    done code and best x, K3's and K4's launches, and the host wall of
    each graph capture (the warm-up's enqueue, the capture and the
    graph's instantiation); a host set-up records the arguments of its
    integer searches, a card set-up counts the torch.linalg eigensolver
    calls it made on the card."""
    import numpy as np
    from bluest_tpu_torch.solvers import sdp
    sdp._WARM_CACHE.clear()
    problem._mosap_key = None
    old = os.environ.pop("BLUEST_TPU_ALLOC_DEVICE", None)
    if where == "host":
        os.environ["BLUEST_TPU_ALLOC_DEVICE"] = "cpu"
    rec = {"solves": []}
    real_ipm = sdp._ipm_solve

    def recording(*a, **k):
        if loop is not None:
            k["loop"] = loop
        out = real_ipm(*a, **k)
        x = out[0]["x"]
        rec["solves"].append((out[1], out[2], x.cpu().numpy()
                              if np.isfinite(out[0]["merit"]) else None))
        return out

    sdp._ipm_solve = recording
    reset_psd_launches()
    rec["searches"], rec["card_eigensolves"] = [], {}
    watch = (counting_card_eigensolves(rec["card_eigensolves"])
             if where == "card" else recording_searches(rec["searches"]))
    try:
        with setup_probes(rec), watch:
            problem.setup_solver(**how)
    finally:
        sdp._ipm_solve = real_ipm
        os.environ.pop("BLUEST_TPU_ALLOC_DEVICE", None)
        if old is not None:
            os.environ["BLUEST_TPU_ALLOC_DEVICE"] = old
    m = problem.MOSAP
    out = problem.MOSAP_output
    if m.device.type != (DEV if where == "card" else "cpu"):
        raise AssertionError("a %s set-up allocated on %s" % (where, m.device))
    certs = out["certificates"]
    rec.update(
        device=where, loop=(loop or "graph") if where == "card" else "eager",
        status=[c["status"] for c in certs],
        cont_cost=float(m.continuous_solution @ m.costs),
        maxvar=float(max(out["variances"])), cost=float(out["cost"]),
        samples=np.array(out["samples"]), L=m.L, out=out, mosap=m,
        dims=[c["dims"] for c in certs if "dims" in c],
        psd_launches=psd_launches())
    rec["rest_s"] = rec["wall_s"] - (rec["psi_s"] + rec["ipm_s"]
                                     + rec["cleanup_s"] + rec["integer_s"])
    return rec


def _iteration_bound_ms(dims):
    """The least time of one IPM iteration: ipm_iteration_flops of the
    program over the card's FP64 rate (ms)."""
    from bluest_tpu_torch.solvers.sdp import ipm_iteration_flops
    return ipm_iteration_flops(dims) / FP64_PEAK * 1e3


def _host_iteration_counts(problem, how):
    """Host reads and aten operations an IPM iteration, counted over one
    host set-up's iterations (the set-up is not timed): the reads through
    every tensor method that hands a number or an array to the host, the
    operations through a dispatch mode."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from bluest_tpu_torch.solvers import sdp
    names = ("__float__", "__int__", "__index__", "__bool__", "item",
             "tolist", "numpy", "cpu")
    real = {n: getattr(torch.Tensor, n) for n in names}
    count = {"reads": 0, "ops": 0, "iterations": 0, "inside": False}
    core, read = sdp._iteration_core, sdp._read

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            count["ops"] += 1
            return func(*args, **(kwargs or {}))

    def counting(n):
        def f(self, *a, **k):
            if count["inside"]:
                count["reads"] += 1
            return real[n](self, *a, **k)
        return f

    def in_core(*a, **k):
        count["iterations"] += 1
        count["inside"] = True
        try:
            with Ops():
                return core(*a, **k)
        finally:
            count["inside"] = False

    def packed(t):
        count["reads"] += 1
        return read(t)

    for n in names:
        setattr(torch.Tensor, n, counting(n))
    sdp._iteration_core, sdp._read = in_core, packed
    try:
        _cold_setup(problem, "host", how)
    finally:
        for n in names:
            setattr(torch.Tensor, n, real[n])
        sdp._iteration_core, sdp._read = core, read
    it = max(count["iterations"], 1)
    return count["reads"] / it, count["ops"] / it


def _linalg_calls(n_x):
    """Each torch.linalg call of the IPM on the card, at the flagship's
    shapes (3 PSD blocks of 11 x 11, an n_x x n_x normal matrix), and K3,
    K4 and K5, which replace its eigvalsh, svd and eigh: whether
    it makes the host wait for the card (it raises under
    set_sync_debug_mode("error")) and its wall a call over 50 calls."""
    import torch
    g = torch.Generator().manual_seed(0)

    def spd(*shape):
        A = torch.randn(*shape, generator=g, dtype=torch.float64)
        eye = torch.eye(shape[-1], dtype=torch.float64)
        return (A @ A.mT + shape[-1] * eye).to("cuda")

    S, H = spd(3, 11, 11), spd(n_x, n_x)
    B = torch.randn(3, 11, 11, generator=g, dtype=torch.float64).to("cuda")
    L = torch.linalg.cholesky(S)
    from bluest_tpu_torch.ops import psd_eig as k34
    calls = {"cholesky_ex": lambda: torch.linalg.cholesky_ex(H),
             "solve_triangular": lambda: torch.linalg.solve_triangular(
                 L, B, upper=False),
             "eigvalsh": lambda: torch.linalg.eigvalsh(S),
             "svd": lambda: torch.linalg.svd(S),
             "eigh": lambda: torch.linalg.eigh(S),
             "sym_eigvalsh (K3)": lambda: k34.sym_eigvalsh(S),
             "nt_svd (K4)": lambda: k34.nt_svd(S),
             "sym_eigh (K5)": lambda: k34.sym_eigh(S),
             "pinv00 (K5)": lambda: k34.pinv00(S, K5_RCOND)}
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            syncs = False
        except RuntimeError:
            syncs = True
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        out[name] = {"syncs": syncs,
                     "us": round((time.perf_counter() - t0) / 50 * 1e6, 1)}
    return out


def _graph_nodes(graph):
    """The nodes of a captured graph kept with keep_graph=True
    (libcuda's cuGraphGetNodes on its cudaGraph_t)."""
    import ctypes
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError("cuGraphGetNodes failed: CUDA error %d" % rc)
    return n.value


def _graph_counts(problem, how):
    """One card set-up under torch.cuda.set_sync_debug_mode("warn"), its
    graphs kept (keep_graph=True, so each is instantiated at its first
    replay): the synchronising calls by call site; those made in the
    IPM's iterations (graph replays, packed reads, step adoptions) and in
    its captures; replays and iterations; and each graph's nodes (one
    graph a solve attempt, one iteration a graph)."""
    import torch
    from bluest_tpu_torch.solvers import sdp
    G = sdp._IterationGraph
    real = (G.run, G.adopt, G._capture, sdp._read, torch.cuda.CUDAGraph)
    graphs = []
    count = {"run": 0, "adopt": 0, "capture": 0, "read": 0, "replays": 0}

    def kept():
        graphs.append(real[4](keep_graph=True))
        return graphs[-1]

    def syncs_in(fn, key, caught):
        def f(*a, **k):
            before = len(caught)
            try:
                return fn(*a, **k)
            finally:
                count[key] += sum("synchroniz" in str(w.message)
                                  for w in caught[before:])
        return f

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run = syncs_in(real[0], "run", caught)

            def counted_run(self):
                count["replays"] += 1
                return run(self)
            G.run, G.adopt = counted_run, syncs_in(real[1], "adopt", caught)
            G._capture = syncs_in(real[2], "capture", caught)
            sdp._read = syncs_in(real[3], "read", caught)
            torch.cuda.CUDAGraph = kept
            rec = _cold_setup(problem, "card", how)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        G.run, G.adopt, G._capture, sdp._read = real[:4]
        torch.cuda.CUDAGraph = real[4]
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = "%s:%d" % (os.path.relpath(w.filename), w.lineno)
            sites[site] = sites.get(site, 0) + 1
    it = max(rec["iterations"], 1)
    in_loop = count["run"] - count["capture"] + count["read"] + count["adopt"]
    nodes = [_graph_nodes(g) for g in graphs]
    graphs.clear()
    return {"sites": sites, "syncs_per_iteration": in_loop / it,
            "capture_syncs": count["capture"], "reads": count["read"],
            "replays_per_iteration": count["replays"] / it,
            "iterations": rec["iterations"], "graphs": len(nodes),
            "nodes": nodes, "capture_s": rec["capture_s"]}


def _gate_graph_against_eager(name, graph, eager):
    """The graph card path against the eager card path on one program:
    the same status for every cone solve, and each interior-point solve
    with the same iterations and done code and its x bit-equal, or within
    1e-12 relative (reported).  Returns (bit-equal, the largest relative
    difference of x)."""
    import numpy as np
    if graph["status"] != eager["status"]:
        raise AssertionError("%s: graph statuses %s, eager %s"
                             % (name, graph["status"], eager["status"]))
    gs, es = graph["solves"], eager["solves"]
    if [s[:2] for s in gs] != [s[:2] for s in es]:
        raise AssertionError("%s: graph (iterations, done) %s, eager %s"
                             % (name, [s[:2] for s in gs],
                                [s[:2] for s in es]))
    same, worst = True, 0.0
    for (_, _, xg), (_, _, xe) in zip(gs, es):
        if xg is None or xe is None:
            same &= xg is None and xe is None
            continue
        if not np.array_equal(xg, xe):
            same = False
            worst = max(worst, float(np.max(np.abs(xg - xe))
                                     / max(np.max(np.abs(xe)), 1e-300)))
    if not same and not worst <= 1e-12:
        raise AssertionError("%s: graph and eager x differ by %.3e relative"
                             % (name, worst))
    return same, worst


def _gate_against_host(name, card, host, how):
    """Card against host on one program: the same status for every cone
    solve of the set-up, continuous cost within 1e-6 relative,
    max-variance within 1e-3 relative, and the budget or the tolerance
    met by both."""
    if card["status"] != host["status"]:
        raise AssertionError("%s: card statuses %s, host %s"
                             % (name, card["status"], host["status"]))
    dc = abs(card["cont_cost"] - host["cont_cost"]) / host["cont_cost"]
    dv = abs(card["maxvar"] - host["maxvar"]) / host["maxvar"]
    if not (dc <= 1e-6 and dv <= 1e-3):
        raise AssertionError("%s: continuous cost rel diff %.3e, max-variance"
                             " rel diff %.3e" % (name, dc, dv))
    for r in (card, host):
        if "budget" in how and not r["cost"] <= 1.0001 * how["budget"]:
            raise AssertionError("%s: cost %.10g over the budget %.10g"
                                 % (name, r["cost"], how["budget"]))
        if "eps" in how and not r["maxvar"] <= 1.0001 * how["eps"] ** 2:
            raise AssertionError("%s: max V/eps^2 = %.6f"
                                 % (name, r["maxvar"] / how["eps"] ** 2))
    return dc, dv


def phase_allocation_on_card(flagship, graph, hh_graph, launches_by_path):
    """Phase 11: the allocation on the card against the host, in turns
    (card, host, host, card), each set-up cold, on problems loaded from
    phase 4's saved graph and phase 6(b)'s HH pilot; then each program's
    integer search alone from the host's continuous point
    (integer_search_gate)."""
    import statistics as st
    import numpy as np
    from bluest_tpu_torch.models import hodgkin_huxley as hh
    budget, eps_star = flagship["budget"], flagship["eps_star"]
    fp = _flagship_from_graph(graph)
    hp = hh.HodgkinHuxleyProblem(datafile=hh_graph, device_batch_size=HH_BATCH,
                                 verbose=False)
    programs = (("(a) flagship budget", fp, dict(K=K, budget=budget)),
                ("(b) flagship eps*", fp, dict(K=K, eps=eps_star)),
                ("(c) HH K=%d budget" % HH_K_CARD, hp,
                 dict(K=HH_K_CARD, budget=HH_BUDGET)))
    summary = {}
    card_budget = None
    # programs whose integer search, from the host's continuous point,
    # gives other samples on the card than on the host
    mismatched = []
    order = (("card", "eager"), ("card", None), ("host", None), ("host", None),
             ("card", None), ("card", "eager"))
    for name, problem, how in programs:
        turns = [_cold_setup(problem, where, how, loop)
                 for where, loop in order]
        by = {"card": [t for t in turns if t["loop"] == "graph"],
              "eager": [t for t in turns if t["loop"] == "eager"
                        and t["device"] == "card"],
              "host": [t for t in turns if t["device"] == "host"]}
        for t in turns:
            bound = (_iteration_bound_ms(t["dims"][0]) if t["dims"]
                     else float("nan"))
            log("phase 11%s on %s (%s): L=%d wall %.3f s = psi %.3f + IPM "
                "%.3f (%d iterations, %.3f ms an iteration, bound %.6f ms; "
                "captures %s s) + cleanup %.3f + integer %.3f + rest %.3f; "
                "statuses %s, continuous cost %.10g, max variance %.8e; K3 "
                "launches %d, K4 %d, K5 pinv00 %d, sym_eigh %d"
                % (name, t["device"], t["loop"], t["L"], t["wall_s"],
                   t["psi_s"], t["ipm_s"], t["iterations"],
                   1e3 * t["ipm_s"] / max(t["iterations"], 1), bound,
                   [round(c, 4) for c in t["capture_s"]], t["cleanup_s"],
                   t["integer_s"], t["rest_s"], t["status"], t["cont_cost"],
                   t["maxvar"], t["psd_launches"]["sym_eigvalsh"],
                   t["psd_launches"]["nt_svd"], t["psd_launches"]["pinv00"],
                   t["psd_launches"]["sym_eigh"]))
        for c in by["card"]:
            for h in by["host"]:
                dc, dv = _gate_against_host(name, c, h, how)
            for e in by["eager"]:
                bit_equal, dx = _gate_graph_against_eager(name, c, e)
            if not (c["psd_launches"]["sym_eigvalsh"] > 0
                    and c["psd_launches"]["nt_svd"] > 0
                    and c["psd_launches"]["pinv00"] > 0):
                raise AssertionError("%s: the card's set-up launched K3/K4/K5 "
                                     "%s" % (name, c["psd_launches"]))
        for t in by["card"] + by["eager"]:
            if t["card_eigensolves"]:
                raise AssertionError("%s: the card's set-up called "
                                     "torch.linalg on the card: %s"
                                     % (name, t["card_eigensolves"]))
        same = bool(np.array_equal(by["card"][0]["samples"],
                                   by["host"][0]["samples"]))
        log("phase 11%s: card vs host: statuses %s / %s, IPM iterations "
            "%s / %s, continuous cost rel diff %.3e, max-variance rel diff "
            "%.3e, same integer samples %s; graph vs eager card: the same "
            "statuses, iterations and done codes, x bit-equal %s (largest "
            "rel diff %.3e)"
            % (name, by["card"][0]["status"], by["host"][0]["status"],
               [t["iterations"] for t in by["card"]],
               [t["iterations"] for t in by["host"]], dc, dv, same,
               bit_equal, dx))
        search = integer_search_gate(name, by["host"][-1]["searches"])
        if not search["same_samples_card_host"]:
            mismatched.append(name)
        counts = _graph_counts(problem, how)
        log("phase 11%s graph counts (one card set-up, sync debug mode "
            "warn): synchronisations an iteration %.4f (replays, packed "
            "reads and step copies), in the captures %d; replays an "
            "iteration %.4f over %d iterations; %d graphs of %s nodes (one "
            "iteration each); capture walls %s s; synchronising calls in "
            "the set-up %d, %d of them in the integer search's module, %s"
            % (name, counts["syncs_per_iteration"], counts["capture_syncs"],
               counts["replays_per_iteration"], counts["iterations"],
               counts["graphs"], counts["nodes"],
               [round(c, 4) for c in counts["capture_s"]],
               sum(counts["sites"].values()),
               sum(v for k, v in counts["sites"].items()
                   if "solvers/integer.py" in k),
               json.dumps(counts["sites"], sort_keys=True)))
        if not (counts["syncs_per_iteration"] == 1.0
                and counts["replays_per_iteration"] == 1.0):
            raise AssertionError("%s: %.4f synchronisations and %.4f replays "
                                 "an IPM iteration on the card"
                                 % (name, counts["syncs_per_iteration"],
                                    counts["replays_per_iteration"]))
        summary[name] = {
            d: {k: [round(t[k], 6) for t in by[d]]
                for k in ("wall_s", "psi_s", "ipm_s", "cleanup_s",
                          "integer_s", "rest_s")}
            | {"iterations": [t["iterations"] for t in by[d]],
               "ms_per_iteration": [round(1e3 * t["ipm_s"]
                                          / max(t["iterations"], 1), 4)
                                    for t in by[d]],
               "capture_s": [[round(c, 5) for c in t["capture_s"]]
                             for t in by[d]]}
            for d in ("card", "eager", "host")}
        summary[name]["L"] = turns[0]["L"]
        summary[name]["bound_ms_per_iteration"] = (
            _iteration_bound_ms(turns[0]["dims"][0]) if turns[0]["dims"]
            else None)
        summary[name]["wall_ratio_host_over_card"] = round(
            st.median(t["wall_s"] for t in by["host"])
            / st.median(t["wall_s"] for t in by["card"]), 4)
        summary[name]["wall_ratio_eager_over_graph"] = round(
            st.median(t["wall_s"] for t in by["eager"])
            / st.median(t["wall_s"] for t in by["card"]), 4)
        summary[name]["graph_vs_eager_bit_equal"] = bit_equal
        summary[name]["psd_launches"] = by["card"][-1]["psd_launches"]
        summary[name]["same_integer_samples"] = same
        summary[name]["integer_search"] = search
        summary[name]["graph_counts"] = {
            k: v for k, v in counts.items() if k != "sites"}
        if name.startswith("(a)"):
            card_budget = by["card"][-1]
    # (a)'s last card allocation, sampled through K1 (launches counted
    # from 0 just before)
    out = card_budget["out"]
    fp.MOSAP, fp.MOSAP_output = card_budget["mosap"], out
    mus, errs, cost, s, n, need = _run_path(
        "mlblue_alloc_on_card", lambda: fp.solve(K=K, budget=budget),
        lambda: (out["flattened_groups"], out["samples"]), launches_by_path)
    if fp.MOSAP_output is not out:
        raise AssertionError("solve() reran the card's allocation")
    log("phase 11 card allocation sampled through K1: %.3f s, K1 launches %d "
        "(chunk evaluations %d)" % (s, n, need))
    _within_bars("phase 11 card allocation vs phase 4", mus, errs,
                 flagship["mus"], flagship["errs"])
    how = dict(K=K, budget=budget)
    reads, ops = _host_iteration_counts(fp, how)
    log("phase 11 host reads an IPM iteration (host set-up, tensor reads "
        "counted): %.2f; aten operations an iteration %.1f" % (reads, ops))
    if not reads <= 2:
        raise AssertionError("%.2f host reads an IPM iteration" % reads)
    calls = _linalg_calls(fp.MOSAP.L)
    log("phase 11 torch.linalg calls of the IPM on the card and K3/K4/K5 "
        "(flagship shapes): %s" % json.dumps(calls, sort_keys=True))
    summary["host_reads_per_iteration"] = round(reads, 4)
    summary["ops_per_iteration"] = round(ops, 1)
    log("phase 11: %s" % json.dumps(summary, sort_keys=True))
    if mismatched:
        raise AssertionError("%s: from the same continuous point the card's "
                             "integer search gives other samples than the "
                             "host's" % ", ".join(mismatched))
    return summary


def write_ns_graph(path, seed=0):
    """A model graph in the shape of the reference's Navier-Stokes study
    (12 models, 6 outputs, costs 2^(11-l)), written in the reference npz
    format: per output a seeded SPD covariance of a hierarchy in which
    model l is the exact output plus errors whose variances grow
    2x per level, each with a random factor in [0.5, 2)."""
    import numpy as np
    from bluest_tpu_torch import BLUEProblem
    rng = np.random.default_rng(seed)
    m = NS_MODELS
    C = []
    for _ in range(NS_OUTPUTS):
        s = 2.0 ** ((np.arange(1, m) - m) / 2) * rng.uniform(0.5, 2.0, m - 1)
        A = np.zeros((m, m))
        A[:, 0] = 1.0
        for l in range(1, m):
            A[l, 1:l + 1] = s[:l]
        C.append(rng.uniform(0.5, 2.0) ** 2 * A @ A.T)
    costs = 2.0 ** (m - 1 - np.arange(m))
    BLUEProblem(m, n_outputs=NS_OUTPUTS, C=C, costs=costs, device="cpu",
                verbose=False).save_graph_data(path)


def _option(name):
    """The value after ``name`` on the command line, or None."""
    argv = sys.argv[1:]
    return argv[argv.index(name) + 1] if name in argv[:-1] else None


def main():
    import torch
    name, smi = phase_device()
    built = phase_build(_option("--k2-parent-source"),
                        _option("--k34-parent-source"))
    k = phase_kernel_check()
    parent = (parent_wide(_option("--parent-source"))
              if _option("--parent-source") else None)
    w = phase_wide_check(parent)
    h = phase_k2_check(built["k2_parent"], built["sass"])
    psd = phase_psd_check(built["k34_parent"])
    k5 = phase_k5_check()
    k6c = phase_k6_check()
    hh_launches = {}                    # K2's launches per path
    hh_by_variant = {}                  # and by variant
    k6_launches = {}                    # K6's launches per phase
    with tempfile.TemporaryDirectory() as d:
        graph = os.path.join(d, "flagship_graph.npz")
        hh_graph = os.path.join(d, "hh_graph.npz")
        with allocation_log("phase 4"), counting_k6("phase 4", k6_launches):
            f = phase_flagship(smi, graph)
        launches_by_path = {"mlblue_budget": f["launches"]}
        if "--profile" in sys.argv[1:]:
            with counting_k6("profile", k6_launches):
                phase_profile(f["problem"])
        with allocation_log("phase 5"), counting_k6("phase 5", k6_launches):
            phase_target_rmse(f["problem"], graph, launches_by_path)
        with allocation_log("phase 6"), counting_k6("phase 6", k6_launches):
            matern = phase_user_models(launches_by_path, hh_graph, h,
                                       hh_launches, hh_by_variant)
        with allocation_log("phase 7"), counting_k6("phase 7", k6_launches):
            phase_allocation_families(f, matern, launches_by_path)
        with allocation_log("phase 8"), counting_k6("phase 8", k6_launches):
            phase_distribution(f, graph, launches_by_path)
        with allocation_log("phase 9"), counting_k6("phase 9", k6_launches):
            phase_front_door(launches_by_path, hh_launches, hh_by_variant)
        with (allocation_log("phase 10"),
              counting_k6("phase 10", k6_launches)):
            deep = phase_deep_flagship(smi)["launches"]
        launches_by_path["deep_flagship"] = deep["k1"]
        t0 = time.perf_counter()
        with (allocation_log("phase 11"),
              counting_k6("phase 11", k6_launches)):
            alloc = phase_allocation_on_card(f, graph, hh_graph,
                                             launches_by_path)
        log("phase 11: %.3f s" % (time.perf_counter() - t0))
    log("K6 launches by phase: %s" % json.dumps(k6_launches, sort_keys=True))
    if not all(k6_launches[p] > 0 for p in ("phase 4", "phase 6",
                                             "phase 9", "phase 10")):
        raise AssertionError("a sampling phase ran no K6: %s" % k6_launches)
    # K3's, K4's and K5's launches per path: phase 4's calibrated
    # allocation, phase 5's eps* allocation, phase 6(d)'s masked SPG and
    # each of phase 11's programs (its last graph turn)
    psd_paths = {"flagship_alloc": f["psd_launches"]} | PSD_PATHS
    for program, rec in alloc.items():
        if isinstance(rec, dict) and "psd_launches" in rec:
            psd_paths["alloc_on_card " + program] = rec["psd_launches"]
    psd_lines = []
    for fn, replaces, measured in (
            ("sym_eigvalsh", K3_REPLACES, psd["K3"]),
            ("nt_svd", K4_REPLACES, psd["K4"]),
            ("sym_eigh", K5_REPLACES["sym_eigh"], k5["sym_eigh"]),
            ("pinv00", K5_REPLACES["pinv00"], k5["pinv00"])):
        by_path = {p: c[fn] for p, c in psd_paths.items()}
        psd_lines.append({"name": fn, "route": "cuda", "source": K34_SOURCE,
                          "replaces": replaces,
                          "launches": sum(by_path.values()),
                          "launches_by_path": by_path} | measured)
    print(json.dumps({"kernels": [{
        "name": "diffusion_outputs", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}, {
        "name": "diffusion_outputs_wide", "route": "cuda",
        "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": deep["wide"],
        "launches_by_path": {"deep_flagship": deep["wide"]},
        "max_abs_err": w["max_abs_err"], "ms": w["ms"],
        "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
        "bound_by": w["bound_by"], "library_ms": None,
        "synthesis_library_ms": w["synthesis_library_ms"],
        "stage_ms": w["stage_ms"],
        "workspace_bytes": w["workspace_bytes"], "timed": w["timed"],
        "ms_at_k1_shapes": w["ms_at_k1_shapes"]}, {
        "name": "hh_group_outputs", "route": "cuda", "source": K2_SOURCE,
        "replaces": K2_REPLACES, "launches": sum(hh_launches.values()),
        "launches_by_path": hh_launches,
        "launches_by_variant": hh_by_variant,
        "max_abs_err": h["max_abs_err"], "ms": h["ms"],
        "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
        "bound_by": h["bound_by"], "library_ms": None,
        "timed": "the 12 default models, n=%d" % K2_TIMED_N,
        "model0": h["model0"], "sm_clock_mhz": h["sm_clock_mhz"],
        "in_turns": h["in_turns"],
        "bit_equal_share": h["bit_equal_share"]}] + psd_lines + [{
        "name": "combine_sums", "route": "cuda", "source": K6_SOURCE,
        "replaces": K6_REPLACES, "launches": sum(k6_launches.values()),
        "launches_by_path": k6_launches,
        "max_rel_err": k6c["max_rel_err"], "ms": k6c["ms"],
        "plain_ms": k6c["plain_ms"], "bound_ms": k6c["bound_ms"],
        "bound_by": k6c["bound_by"], "library_ms": None,
        "timed": k6c["timed"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)

if __name__ == "__main__":
    main()
