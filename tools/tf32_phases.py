#!/usr/bin/env python3
"""Where a split-TF32 backward kernel's stage goes: a per-phase clock64
breakdown of ``src/repro_torch/kernels/csrc/dyad_gemm_tf32.cuh``'s
mainloop (the fp32 ``dyad_mm_wgrad``, ``dyad_mm_dgrad_two`` and
``dyad_mm_dgrad`` kernels) at OPT-125m's training shapes.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 tools/tf32_phases.py

It copies the header into ``build/tf32_phases/`` with ``clock64()`` reads
inserted between the mainloop's phases (the barrier, stage t + 1's copies,
the A fragments, the wgmma issue, the gathers, the cp.async wait, the B
split, the wgmma wait, the adds and epilogue; the prologue apart), builds a
library of the same launches as the port's entries from it, and runs each
kernel at one OPT-125m layer's up and down shapes (M 4096, n 4; the wgrad
and the fused dgrad with the IT and OT views as the train steps pass them,
and with no stride-n view, ``copied``).  Threads 0 and 96 of every block
add their cycles into a device counter; it prints one JSON line per case:
the mean cycles a stage in each phase as those threads see them (two
blocks share an SM, so the phases of one overlap the other's).  The reads
themselves cost a few cycles each and keep the compiler from moving work
across them, so the sum runs above the kernel's unprofiled time.  Imports
nothing of JAX.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("barrier", "copies", "frags", "wgmma_issue", "gathers", "cp_wait",
          "ready", "wgmma_wait", "adds_epilogue", "prologue")
# (anchor in the header, text put after it): each anchor occurs once
TICKS = (
    ("  tc::cp_async_wait<0>();\n  ready(0);\n", "  TICK(9)\n"),
    ("    __syncthreads();\n", "    TICK(0)\n"),
    ("    copies(t + 1);\n", "    TICK(1)\n"),
    ("    a_frags(as, ah, al);\n", "    TICK(2)\n"),
    ("    asm volatile(\"wgmma.commit_group.sync.aligned;\\n\" ::: "
     "\"memory\");\n", "    TICK(3)\n"),
    ("    load(t + 2);\n", "    TICK(4)\n"),
)
ENTRIES = r"""
#include <utility>
#include "tf32_phases.cuh"
namespace t32 = repro::tf32t;

extern "C" int phases_read(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases));
}
extern "C" int phases_zero() {
  unsigned long long z[12] = {0};
  return cudaMemcpyToSymbol(g_phases, z, sizeof(z));
}
// the wgrad entry of dyad_wgrad.cu, fp32 in and out
extern "C" int wgrad(const void* x1, const void* x2, const void* z1,
                     const void* z2, void* dw1, void* dw2, float* part, int M,
                     int n, int d_in, int d_out, int split, int rows,
                     int x_as_a, long long x1_sb, long long x1_sg,
                     long long x1_si, long long x2_sb, long long x2_sg,
                     long long x2_si, long long z1_sb, long long z1_sg,
                     long long z1_so, long long z2_sb, long long z2_sg,
                     long long z2_so, void* stream) {
  const long long w_sg = (long long)d_out * d_in;
  repro::DyadGemmArgs r{{z1, z2}, {z1_sg, z2_sg}, {z1_so, z2_so},
                        {z1_sb, z2_sb}, {x1, x2}, {x1_sg, x2_sg},
                        {x1_sb, x2_sb}, {x1_si, x2_si}, {dw1, dw2},
                        {w_sg, w_sg}, {d_in, d_in}, {1, 1},
                        split > 1 ? part : nullptr, n, d_out, d_in, M,
                        split, rows};
  t32::Args t{{x1, x2}, {x1_sg, x2_sg}, {x1_sb, x2_sb}, {x1_si, x2_si},
              {z1, z2}, {z1_sg, z2_sg}, {z1_so, z2_so}, {z1_sb, z2_sb},
              {dw1, dw2}, {w_sg, w_sg}, {1, 1}, {d_in, d_in}, r.part, w_sg,
              n, d_in, d_out, M, split, rows};
  if (!x_as_a) {
    for (int c = 0; c < 2; ++c) {
      std::swap(t.A[c], t.B[c]);
      std::swap(t.a_sg[c], t.b_sg[c]);
      t.a_sk[c] = c ? z2_sb : z1_sb;
      t.a_sm[c] = c ? z2_so : z1_so;
      t.b_sj[c] = c ? x2_si : x1_si;
      t.b_sk[c] = c ? x2_sb : x1_sb;
      std::swap(t.c_sm[c], t.c_sj[c]);
    }
    std::swap(t.Mx, t.Jx);
  }
  return t32::launch_wgrad<float, 96>(t, r, static_cast<cudaStream_t>(stream));
}
// the fp32 entries of dyad_dgrad.cu (fuse 0) and dyad_dgrad_fused.cu
extern "C" int dgrad(int fuse, const void* z1, const void* z2,
                     const void* w1, const void* w2, void* dx1, void* dx2,
                     int M, int n, int d_in, int d_out, long long z1_sb,
                     long long z1_sg, long long z1_so, long long z2_sb,
                     long long z2_sg, long long z2_so, long long d1_sb,
                     long long d1_sg, long long d1_si, long long d2_sb,
                     long long d2_sg, long long d2_si, void* stream) {
  const long long w_sg = (long long)d_out * d_in;
  t32::Args t{{w1, w2}, {w_sg, w_sg}, {d_in, d_in}, {1, 1}, {z1, z2},
              {z1_sg, z2_sg}, {z1_sb, z2_sb}, {z1_so, z2_so}, {dx1, dx2},
              {d1_sg, d2_sg}, {d1_si, d2_si}, {d1_sb, d2_sb}, nullptr, 0, n,
              d_in, M, d_out, 1, d_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fuse ? t32::launch_dgrad<true, 96>(t, s)
              : t32::launch_dgrad<false, 128>(t, s);
}
"""


def instrument(src: str) -> str:
    """The header with a TICK(i) after each phase: cycles since the last
    tick added to tp[i], which threads 0 and 96 add into g_phases[i] at the
    end (g_phases[10]: blocks, [11]: stages)."""
    def once(text, old, new):
        if text.count(old) != 1:
            raise SystemExit(f"tf32_phases: anchor not found once: {old!r}")
        return text.replace(old, new)

    src = once(src, "namespace repro {\nnamespace tf32t {",
               "__device__ unsigned long long g_phases[12];\n"
               "#define TICK(i) { const long long c1 = clock64(); "
               "tp[i] += c1 - c0; c0 = c1; }\n"
               "namespace repro {\nnamespace tf32t {")
    src = once(src, "  float acc[J / 2], part[J / 2];\n",
               "  long long tp[10] = {}, c0 = clock64();\n"
               "  float acc[J / 2], part[J / 2];\n")
    for anchor, tick in TICKS:
        src = once(src, anchor, anchor + tick)
    src = once(src, "    tc::cp_async_wait<0>();\n    ready(t + 1);\n",
               "    tc::cp_async_wait<0>();\n    TICK(5)\n"
               "    ready(t + 1);\n    TICK(6)\n")
    src = once(src, "    tc::fence_acc(part);\n#pragma unroll\n"
               "    for (int x = 0; x < J / 2; ++x) acc[x] += part[x];\n",
               "    TICK(7)\n    tc::fence_acc(part);\n#pragma unroll\n"
               "    for (int x = 0; x < J / 2; ++x) acc[x] += part[x];\n")
    src = once(src, "    if (++tt < T) continue;",
               "    if (++tt < T) {\n      TICK(8)\n      continue;\n    }")
    src = once(src, "    for (int x = 0; x < J / 2; ++x) acc[x] = 0.f;\n  }\n"
               "  tc::cp_async_wait<0>();\n}",
               "    for (int x = 0; x < J / 2; ++x) acc[x] = 0.f;\n"
               "    TICK(8)\n  }\n  tc::cp_async_wait<0>();\n"
               "  if (threadIdx.x % 96 == 0) {\n"
               "    for (int i = 0; i < 10; ++i)\n"
               "      atomicAdd(&g_phases[i], (unsigned long long)tp[i]);\n"
               "    atomicAdd(&g_phases[10], 1ull);\n"
               "    atomicAdd(&g_phases[11], (unsigned long long)TT);\n"
               "  }\n}")
    return src


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, dyad_mm

    out_dir = ROOT / "build" / "tf32_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "tf32_phases.cuh").write_text(
        instrument((build.CSRC / "dyad_gemm_tf32.cuh").read_text()))
    (out_dir / "tf32_phases.cu").write_text(ENTRIES)
    lib_path = out_dir / "libtf32_phases.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-I", str(out_dir), "-o", str(lib_path),
                    str(out_dir / "tf32_phases.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wgrad.argtypes = [P] * 7 + [I] * 7 + [LL] * 12 + [P]
    lib.dgrad.argtypes = [I] + [P] * 6 + [I] * 4 + [LL] * 12 + [P]
    for fn in (lib.wgrad, lib.dgrad, lib.phases_read, lib.phases_zero):
        fn.restype = ctypes.c_int
    lib.phases_read.argtypes = [P]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    device = torch.cuda.get_device_name(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def measure(label, call):
        build.check(call(), label)        # warm
        build.check(lib.phases_zero(), "phases_zero")
        for _ in range(5):
            build.check(call(), label)
        torch.cuda.synchronize()
        got = (ctypes.c_ulonglong * 12)()
        build.check(lib.phases_read(ctypes.addressof(got)), "phases_read")
        stages = max(got[11], 1)
        cycles = {k: round(got[i] / stages, 1) for i, k in enumerate(PHASES)}
        print(json.dumps({"case": label, "cycles_a_stage": cycles,
                          "sum": round(sum(got[i] for i in range(9))
                                       / stages, 1),
                          "stages_a_block": round(got[11] / got[10], 1),
                          "device": device}), flush=True)

    M, n = 4096, 4
    for shape, (d_in, d_out) in (("up", (192, 768)), ("down", (768, 192))):
        x, g = randn(M, n * d_in), randn(M, n * d_out)
        x1, x2 = x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(1, 2)
        z1 = g.reshape(M, n, d_out)
        z2 = g.reshape(M, d_out, n).transpose(1, 2)
        w1, w2 = randn(n, d_out, d_in), randn(n, d_out, d_in)
        dw = [torch.empty(n, d_out, d_in, device=dev) for _ in range(2)]
        split, rows = dyad_mm.wgrad_split(M, n, d_in, d_out)
        part = torch.empty(split, 2, n, d_out, d_in, device=dev)
        for view, ops in (("it", (x1, x2, z1, z1)), ("ot", (x1, x1, z1, z2)),
                          ("copied", (x1, x1, z1, z1))):
            orient = int(dyad_mm.wgrad_orient(d_in, d_out,
                                              ops[1].stride(2) != 1,
                                              ops[3].stride(2) != 1))
            measure(f"dyad_mm_wgrad/{shape}/{view}", lambda: lib.wgrad(
                *(build.ptr(t) for t in (*ops, *dw, part)), M, n, d_in,
                d_out, split, rows, orient, *(s for t in ops
                                             for s in t.stride()),
                build.stream(dev)))
        dx1 = torch.empty(M, n, d_in, device=dev)
        dx2 = dyad_mm._permuted_out(M, n, d_in, z1)
        for name, fuse, zs, out2 in (
                ("dyad_mm_dgrad_two/it", 0, (z1, z1), dx2),
                ("dyad_mm_dgrad/ot", 1, (z1, z2), dx1),
                ("dyad_mm_dgrad/copied", 1, (z1, z1), dx1)):
            measure(f"{name}/{shape}", lambda: lib.dgrad(
                fuse, *(build.ptr(t) for t in (*zs, w1, w2, dx1, out2)), M, n,
                d_in, d_out, *zs[0].stride(), *zs[1].stride(), *dx1.stride(),
                *out2.stride(), build.stream(dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
