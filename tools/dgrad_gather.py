#!/usr/bin/env python3
"""The yardstick of fp32 ``dyad_mm_dgrad_two``'s split-TF32 route: the
tensor-core mainloop's own split-TF32 instantiation
(``tc::launch<true, true, float, false, float>`` of
``src/repro_torch/kernels/csrc/dyad_gemm_tc.cuh``), which reads w[g]
(o x i, i contiguous) as a K-major B by gathering it element by element
at a stride of d_in, against the port's kernel (``dyad_mm_dgrad_two``, the
product transposed) on the same inputs.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 tools/dgrad_gather.py

It builds a one-entry library from the checkout's headers into
``build/dgrad_gather/``, checks both routes against the plain version at
OPT-125m's up and down dx (M 4096, n 4, the IT cotangent view), and prints
one JSON line: each route's ms for one layer's up + down
(``chip_smoke.timer``: CUDA events, the L2 flushed before each run,
median of 25) and its largest error.  Imports nothing of JAX.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = r"""
#include "dyad_gemm_tc.cuh"

extern "C" int dgrad_gather(
    const void* z1, const void* z2, const void* w1, const void* w2,
    void* dx1, void* dx2, int M, int n, int d_in, int d_out,
    long long z1_sb, long long z1_sg, long long z1_so, long long z2_sb,
    long long z2_sg, long long z2_so, long long d1_sb, long long d1_sg,
    long long d1_si, long long d2_sb, long long d2_sg, long long d2_si,
    void* stream) {
  const long long w_sg = (long long)d_out * d_in;
  repro::DyadGemmArgs a{{z1, z2},      {z1_sg, z2_sg}, {z1_sb, z2_sb},
                        {z1_so, z2_so}, {w1, w2},      {w_sg, w_sg},
                        {d_in, d_in},   {1, 1},        {dx1, dx2},
                        {d1_sg, d2_sg}, {d1_sb, d2_sb}, {d1_si, d2_si},
                        nullptr,        n,             M,
                        d_in,           d_out,         1,
                        d_out};
  return repro::tc::launch<true, true, float, false, float>(
      a, static_cast<cudaStream_t>(stream));
}
"""


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build, dyad_mm

    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = ROOT / "build" / "dgrad_gather"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "dgrad_gather.cu", out_dir / "libdgrad_gather.so"
    src.write_text(SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib_path)).dgrad_gather
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    time_ms = cs.timer(torch, torch.empty(64 << 20, dtype=torch.uint8,
                                          device=dev))
    n, d, ff, M = 4, 768 // 4, 3072 // 4, 4096
    res = {"gather_ms": 0.0, "port_ms": 0.0, "gather_max_abs_err": 0.0,
           "port_max_abs_err": 0.0}
    for d_in, d_out in ((d, ff), (ff, d)):
        z = torch.randn(M, n, d_out, generator=gen, device=dev)
        w1, w2 = (torch.randn(n, d_out, d_in, generator=gen, device=dev)
                  for _ in range(2))
        dx1 = torch.empty(M, n, d_in, device=dev)
        dx2 = torch.empty(M, n, d_in, device=dev)

        def gather():
            build.check(fn(
                build.ptr(z), build.ptr(z), build.ptr(w1), build.ptr(w2),
                build.ptr(dx1), build.ptr(dx2), M, n, d_in, d_out,
                *z.stride(), *z.stride(), *dx1.stride(), *dx2.stride(),
                build.stream(dev)), "dgrad_gather")

        gather()
        port = dyad_mm.dyad_mm_dgrad_two(z, z, w1, w2)
        want = dyad_mm.dyad_mm_dgrad_two_plain(z, z, w1, w2)
        for key, got in (("gather", (dx1, dx2)), ("port", port)):
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            res[f"{key}_max_abs_err"] = max(res[f"{key}_max_abs_err"], err)
        res["gather_ms"] += time_ms(gather)
        res["port_ms"] += time_ms(
            lambda: dyad_mm.dyad_mm_dgrad_two(z, z, w1, w2))
    print(json.dumps({"dgrad_gather": {k: round(v, 6) for k, v in
                                       res.items()},
                      "device": torch.cuda.get_device_name(0),
                      "shape": "opt_up+down_M4096"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
