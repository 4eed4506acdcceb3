"""Where a Jacobi round of K3's and K4's warp kernels spends its cycles,
on a CUDA card.

Builds variants of ``bluest_tpu_torch/csrc/psd_eig.cu`` by replacing the
body of its ``rotation()`` (the chain that turns a pair's coupling into
t, c and s) or the warp kernels' updates, each with the package's nvcc
flags:

* ``as built``: the source as it is (a sqrt, a division for t, an rsqrt
  for c);
* ``tau form``: tau = diff / (2 num), t = sign(tau) / (|tau| +
  sqrt(1 + tau^2)) (|tau| past 2^500), the same t with one division
  more;
* ``fp32 chain``: the chain in float32 (the rotations are no longer
  exact, so the sweeps change, and its results serve timing only): what
  is left of a round once the FP64 chain is nearly free;
* ``no update``: the chain's c and s kept alive but no rotation applied
  (K3's 2 x 2 blocks and K4's rows left as they are), so every block
  runs PSD_MAX_SWEEPS sweeps: a round without its updates (timing
  only); and ``no update, fp32`` with the float32 chain besides;
* ``registers`` (K3 only): ``tools/psd_k3_registers.cu``, K3 with the
  matrix's rows in the lanes' registers and a fixed permutation of
  positions a round in place of the warp's shared memory.

Each variant is timed in turns (as built, the others, the others in
reverse, as built) at the IPM's shapes, 100 calls captured in one CUDA
graph and replayed, beside an empty kernel's (the launch floor), on
seeded blocks of ``chip_smoke.psd_blocks``; a line per variant and shape
gives ms a call, the slowest block's sweeps (the kernels' measurement
output) and the cycles a round at the SM clock nvidia-smi reads,
(ms - floor) x clock / (sweeps x (n_pad - 1)), and the variant's largest
eigenvalue (K3) or singular value (K4) difference from the plain
version over the block's norm.

Run from the root of a checkout on a machine with a card and nvcc:
    python3 tools/psd_round_probe.py
"""

import ctypes
import os
import re
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((3, 11, 12), (3, 11, 3), (3, 13, 5), (4, 11, 3), (4, 13, 5))

TAU_FORM = """
    const double tau = diff / (2.0 * num);
    const double at = fabs(tau);
    const double root = at > 0x1p500 ? at : sqrt(fma(tau, tau, 1.0));
    *t = (tau >= 0.0 ? 1.0 : -1.0) / (at + root);
    *c = rsqrt(fma(*t, *t, 1.0));
    *s = *t * *c;
"""
FP32_CHAIN = """
    const float tau = (float)diff / (2.0f * (float)num);
    const float at = fabsf(tau);
    const float root = at > 0x1p60f ? at : sqrtf(fmaf(tau, tau, 1.0f));
    const float tf = (tau >= 0.0f ? 1.0f : -1.0f) / (at + root);
    const float cf = rsqrtf(fmaf(tf, tf, 1.0f));
    *t = tf;
    *c = cf;
    *s = (double)(tf * cf);
"""


# the warp kernels' updates, and what takes their place in ``no update``:
# a test of the chain's results that never holds, so nothing is dropped
NO_UPDATE = (
    ("""                    if (!own[it] || (sP == 0.0 && sQ == 0.0))
                        continue;
""", """                    if (cP + sP + cQ + sQ == 3.25)
                        a[0] = 0.0;
                    continue;
"""),
    ("""            const double so = lo ? -s : s;
#pragma unroll
            for (int k = 0; k < NMAX; ++k) {
                g[k] = fma(c, g[k], so * y[k]);
                const double vo = __shfl_sync(PSD_FULL, v[k], partner);
                v[k] = fma(c, v[k], so * vo);
            }
""", """            const double so = lo ? -s : s;
            if (c + so == 3.25)
                g[0] = 0.0;
"""))
VARIANTS = (("as built", None, ()), ("tau form", TAU_FORM, ()),
            ("fp32 chain", FP32_CHAIN, ()), ("no update", None, NO_UPDATE),
            ("no update, fp32", FP32_CHAIN, NO_UPDATE))


def variant_source(text, body, subs=()):
    """``text`` with the body of rotation() replaced by ``body`` (None:
    unchanged) and each (old, new) of ``subs`` made."""
    for old, new in subs:
        if old not in text:
            raise RuntimeError("not in the source: %r" % old[:60])
        text = text.replace(old, new)
    if body is None:
        return text
    head = re.search(r"__device__ __forceinline__ void rotation\([^)]*\)\s*\{",
                     text)
    if head is None:
        raise RuntimeError("rotation() not found in the source")
    end = text.index("\n}\n", head.end())
    return text[:head.end()] + body + text[end + 1:]


def load(path):
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bluest_sym_eigvalsh_f64.argtypes = [P, P, P, P, P, I, I, P]
    lib.bluest_nt_svd_f64.argtypes = [P, P, P, P, P, P, I, I, P]
    lib.bluest_psd_work_doubles.restype = ctypes.c_longlong
    lib.bluest_psd_work_doubles.argtypes = [I, I]
    lib.bluest_psd_empty.argtypes = [I, P]
    return lib


def main():
    import torch
    import chip_smoke as cs
    from bluest_tpu_torch.ops import _build
    from bluest_tpu_torch.ops import psd_eig
    if not torch.cuda.is_available():
        raise SystemExit("psd_round_probe.py needs a CUDA card")
    cs.phase_device()
    with open(psd_eig._SOURCE) as f:
        text = f.read()
    out_dir = os.path.join(_build.BUILD_DIR, "psd_round_probe")
    os.makedirs(out_dir, exist_ok=True)
    sources = {}
    for name, body, subs in VARIANTS:
        sources[name] = os.path.join(out_dir, "psd_eig_%s.cu"
                                     % re.sub(r"\W+", "_", name))
        with open(sources[name], "w") as f:
            f.write(variant_source(text, body, subs))
    # the register layout, with the package's source inlined where it
    # includes it (so the build's hash covers both)
    with open(os.path.join(ROOT, "tools", "psd_k3_registers.cu")) as f:
        reg = f.read().replace(
            '#include "../bluest_tpu_torch/csrc/psd_eig.cu"', text)
    sources["registers"] = os.path.join(out_dir, "psd_k3_registers.cu")
    with open(sources["registers"], "w") as f:
        f.write(reg)
    with ThreadPoolExecutor(len(sources)) as pool:       # one nvcc each
        paths = {k: pool.submit(_build.build, src, psd_eig.NVCC_FLAGS)
                 for k, src in sources.items()}
        libs = {k: load(f.result()) for k, f in paths.items()}
    floor_lib = libs["as built"]
    for kind, n, B in SHAPES:
        names = [k for k in libs if kind == 3 or k != "registers"]
        order = names + names[::-1]
        x = cs.psd_blocks(n, B, 7 * n + B, kind)
        ref = (torch.linalg.eigvalsh(x.cpu()) if kind == 3
               else torch.linalg.svd(x.cpu())[1]).to(x.device)
        nrm = torch.clamp(torch.linalg.norm(x, dim=(1, 2)), min=1e-300)
        times = {k: [] for k in names}
        floors = []
        calls = {k: cs.psd_launcher(libs[k], kind, x) for k in names}
        with cs.smi_sampler() as smi:
            for k in order:
                times[k].append(cs._graph_ms(calls[k][0]))
            for _ in range(2):
                floors.append(cs._graph_ms(
                    lambda: floor_lib.bluest_psd_empty(
                        B, torch.cuda.current_stream().cuda_stream)))
        clock = (statistics.median(c for c, _, _ in smi) if smi
                 else float("nan"))
        floor = min(floors)
        for k in names:
            call, (vals, st, sw) = calls[k]
            call()
            torch.cuda.synchronize()
            most = int(sw.max().item())
            rounds = most * (n + (n & 1) - 1)
            ms = min(times[k])
            err = ((vals - ref).abs().amax(dim=1) / nrm).max().item()
            print("K%d n=%d B=%d %-15s: %s ms a call in a graph (floor %.4f); "
                  "sweeps mean %.2f, most %d (%d rounds); %.0f cycles a round "
                  "at %.0f MHz; statuses %s; largest difference from the "
                  "plain version %.3g of the norm"
                  % (kind, n, B, k, " / ".join("%.4f" % t for t in times[k]),
                     floor, sw.double().mean().item(), most, rounds,
                     (ms - floor) * 1e-3 * clock * 1e6 / rounds, clock,
                     sorted(set(st.tolist())), err), flush=True)


if __name__ == "__main__":
    main()
