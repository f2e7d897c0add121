"""Measurements behind the design of csrc/fq_points.cu, on one CUDA card.

    python3 tools/point_kernel_probe.py            # variants, then latencies

1. Variants of the point kernels. The committed source is copied into a
   temporary directory with one substitution per variant, built with the
   package's nvcc flags, and launched through ops/fq_points.py's wrappers
   (their launcher swapped for the variant's): the cofactor ladder at 16
   lanes and the Miller loop at 16 x 2 and 128 x 3, each checked
   bit-identical to the committed kernel, with its ms and block 0's cycles
   a bundle, phase by phase (fq_points.bundle_clocks). The variants:
   - "committed": csrc/fq_points.cu as it is (the ladder's B and D on
     16-thread groups, the Miller loop's one thread an item);
   - "ladder threads": the ladder's kernel one thread an item;
   - "miller groups": the Miller kernel on 16-thread groups.
2. Latencies and throughputs of the operations a bundle chains, from a
   small kernel timed with clock64(): a dependent shared-memory load
   (32- and 128-bit), a dependent mad.wide.u32, a dependent shuffle, a
   block barrier; and the issue cost of independent mad.wide.u32 and 32-bit
   IMADs per warp instruction on one SM sub-partition.

Prints the card's name and power limit first. Imports no JAX.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from consensus_specs_tpu_torch.crypto import bls12_381 as gt  # noqa: E402
from consensus_specs_tpu_torch.ops import _nvcc  # noqa: E402
from consensus_specs_tpu_torch.ops import bls_torch as BT  # noqa: E402
from consensus_specs_tpu_torch.ops import fq_points as FPt  # noqa: E402
from consensus_specs_tpu_torch.ops import scalar_mul as SM  # noqa: E402

VARIANTS = {
    "committed": [],
    "ladder threads": [("  run_program<true>(p, io);", "  run_program<false>(p, io);")],
    "miller groups": [("  run_program<false>(p, io);", "  run_program<true>(p, io);")],
}

LATENCY_SRC = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ long long madw(unsigned a, unsigned b, long long c) {
  long long d; asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c)); return d; }
extern "C" __global__ void probe(long long* out, int n) {
  __shared__ __align__(16) int chain[1024];
  __shared__ __align__(16) long long rows[1024];
  const int tid = threadIdx.x;
  for (int i = tid; i < 1024; i += blockDim.x) { chain[i] = (i * 37 + 11) & 1023; rows[i] = i; }
  __syncthreads();
  int p = tid & 31; long long acc = 0; long long t;
  t = clock64(); for (int i = 0; i < n; ++i) p = chain[p];
  if (tid == 0) out[0] = clock64() - t;
  t = clock64();
  for (int i = 0; i < n; ++i) {
    longlong2 v = reinterpret_cast<longlong2*>(rows)[p & 511]; p = (int)(v.x + v.y) & 511; }
  if (tid == 0) out[1] = clock64() - t;
  unsigned m = p | 1;
  t = clock64();
  for (int i = 0; i < n; ++i) { acc = madw(m, 0x1fffaaab, acc); m = (unsigned)acc | 1; }
  if (tid == 0) out[2] = clock64() - t;
  int v = p;
  t = clock64(); for (int i = 0; i < n; ++i) v = __shfl_sync(0xffffffffu, v, (tid + 1) & 31) + 1;
  if (tid == 0) out[3] = clock64() - t;
  t = clock64(); for (int i = 0; i < n; ++i) __syncthreads();
  if (tid == 0) out[4] = clock64() - t;
  long long a[8] = {0, 1, 2, 3, 4, 5, 6, 7}; unsigned w = tid;
  __syncthreads(); t = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = madw(w, 0x1fffaaab + k, a[k]);
    w += 0x9e3779b9u; }
  __syncthreads(); if (tid == 0) out[5] = clock64() - t;
  int b[8] = {0, 1, 2, 3, 4, 5, 6, 7};
  __syncthreads(); t = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) b[k] = b[k] * (3 + 2 * k) + (int)w;
    w += 0x9e3779b9u; }
  __syncthreads(); if (tid == 0) out[6] = clock64() - t;
  long long s = acc + v + p;
  for (int k = 0; k < 8; ++k) s += a[k] + b[k];
  out[8 + tid] = s;
}
extern "C" int run(long long* out, int n, int threads) {
  probe<<<1, threads>>>(out, n); return (int)cudaDeviceSynchronize(); }
"""


def build(src: str, name: str, work: Path) -> ctypes.CDLL:
    cu = work / f"{name}.cu"
    cu.write_text(src)
    so = work / f"{name}.so"
    subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-I", str(_nvcc.CSRC), "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def use(lib: ctypes.CDLL) -> None:
    for k in ("g2_ladder", "miller_grouped"):
        fn = getattr(lib, f"{k}_launch")
        fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        FPt._fns[k] = fn


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cases(dev):
    """(label, program, run(stamps)) at the three shapes, inputs from a seed."""
    seed = 12345
    pts = [gt.hash_to_g2_candidate((seed + j).to_bytes(32, "big"), 1) for j in range(16)]
    arr = np.stack([BT.g2_to_limbs(p) for p in pts])
    x, y = (torch.from_numpy(arr[:, c]).to(dev) for c in (0, 1))
    rec = SM.recode_signed_windows(gt.G2_COFACTOR, BT._G2_COFACTOR_NBITS, BT.SCALAR_WINDOW)
    g1d = np.stack([BT.g1_to_limbs(gt.ec_mul(gt.G1_GEN, seed + 2 * j + 1)) for j in range(8)])
    g2d = np.stack([BT.g2_to_limbs(gt.ec_mul(gt.G2_GEN, seed + 2 * j + 2)) for j in range(8)])
    out = [("cofactor 16", FPt.ladder_program(BT._G2_COFACTOR_NBITS, BT.SCALAR_WINDOW),
            lambda st=None: FPt.g2_ladder_cuda(x, y, None, rec, stamps=st))]
    for G, P in ((16, 2), (128, 3)):
        sel = (np.arange(G)[:, None] * P + np.arange(P)[None, :]) % 8
        g1, g2 = (torch.from_numpy(d[sel]).to(dev) for d in (g1d, g2d))
        out.append((f"miller {G} x {P}", FPt.miller_program(P),
                    lambda st=None, g1=g1, g2=g2: FPt.miller_grouped_cuda(g1, g2, stamps=st)))
    return out


def variants(dev, work: Path) -> None:
    src = (_nvcc.CSRC / "fq_points.cu").read_text()
    want = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        use(build(text, "fq_points_" + name.replace(" ", "_"), work))
        for label, prog, run in cases(dev):
            got = run()
            got = [t.cpu() for t in got] if isinstance(got, tuple) else [got.cpu()]
            if label not in want:
                want[label] = got
            same = all(torch.equal(g, w) for g, w in zip(got, want[label]))
            ms = time_ms(run, 5)
            cycles, split = FPt.bundle_clocks(run, prog, dev)
            phases = " / ".join(f"{v:.0f}" for v in split.mean(axis=0))
            print(f"{name}: {label}: {ms:.4f} ms, bit-identical to committed {same}, block 0"
                  f" {int(cycles.sum())} cycles, a bundle {cycles.mean():.0f} (phases "
                  f"{' / '.join(FPt.PHASES)}: {phases})", flush=True)


def latencies(work: Path) -> None:
    lib = build(LATENCY_SRC, "latency", work)
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    n = 2000
    for threads in (32, 128, 288):
        out = torch.zeros(8 + threads, dtype=torch.int64, device="cuda")
        lib.run(out.data_ptr(), n, threads)
        lib.run(out.data_ptr(), n, threads)
        o = out.cpu().tolist()
        per_smsp = max(threads // 32 / 4, 1)
        print(f"{threads} threads, cycles: dependent LDS.32 {o[0] / n:.1f}, LDS.128 {o[1] / n:.1f},"
              f" mad.wide.u32 {o[2] / n:.1f}, shfl {o[3] / n:.1f}, __syncthreads {o[4] / n:.1f};"
              f" issue per warp instruction on a sub-partition: mad.wide.u32"
              f" {o[5] / (8 * n) / per_smsp:.2f}, IMAD {o[6] / (8 * n) / per_smsp:.2f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    work = Path(tempfile.mkdtemp(prefix="fq_points_probe_"))
    try:
        variants(torch.device("cuda"), work)
        latencies(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
