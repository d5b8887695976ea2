#!/usr/bin/env python3
"""What fp32 ``dyad_mm_blocks_two``'s z2 stores cost on the card.

Run from the repository root on a machine with one CUDA card:

    python3 tools/two_store.py

Times the kernel (split TF32, through its C entry, not counted) at
OPT-125m's OT and DT forward, up and down projections at the training rows
(M 4096), with z2 written three ways:

* ``interleaved``: the (M, n, d_out) view of a contiguous (M, d_out, n)
  buffer that the wrapper allocates (``ref.combine`` then reshapes it for
  free); where a block's k is at most ``kXchgStages`` stages the four
  blocks of a tile write it as one cluster (``store_xchg`` in
  ``csrc/dyad_gemm_tc.cuh``);
* ``interleaved_unaligned``: the same layout 4 bytes off 16-byte
  alignment, which the cluster write does not take: each element is
  stored alone, 4 bytes in every 16 for one block;
* ``contiguous``: z2 laid out as z1, no interleaving (what the stores
  cost with none).

Each layout's outputs must equal the wrapper's bit for bit.  Timing is
``chip_smoke.timer`` (CUDA events, the L2 flushed before each run, median
of 25), the layouts in turns (a, b, c, c, b, a).  One JSON line a shape,
with the card's name and power limit.  Imports nothing of JAX.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAYOUTS = ("interleaved", "interleaved_unaligned", "contiguous")


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
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    time_ms = cs.timer(torch, torch.empty(64 << 20, dtype=torch.uint8,
                                          device=dev))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    fn = build.entry("dyad_mm_two")
    M, n = 4096, 4
    for view in ("ot", "dt"):
        for proj, (d_in, d_out) in (("up", (192, 768)), ("down", (768, 192))):
            x = torch.randn(M, n * d_in, generator=gen, device=dev)
            x1 = x.reshape(M, n, d_in)
            x2 = x1 if view == "ot" else x.reshape(M, d_in, n).transpose(1, 2)
            w1, w2 = (torch.randn(n, d_out, d_in, generator=gen, device=dev)
                      for _ in range(2))
            want = dyad_mm.dyad_mm_blocks_two(x1, x2, w1, w2)
            z1 = torch.empty(M, n, d_out, device=dev)
            z2s = {
                "interleaved": dyad_mm._permuted_out(M, n, d_out, x1),
                "interleaved_unaligned": torch.empty(
                    M * d_out * n + 1, device=dev)[1:].view(
                        M, d_out, n).transpose(1, 2),
                "contiguous": torch.empty(M, n, d_out, device=dev)}

            def call(z2):
                build.check(fn(
                    build.ptr(x1), build.ptr(x2), build.ptr(w1),
                    build.ptr(w2), build.ptr(z1), build.ptr(z2), M, n, d_in,
                    d_out, *x1.stride(), *x2.stride(), *z1.stride(),
                    *z2.stride(), dyad_mm._DTYPES[x1.dtype],
                    build.stream(dev)), "dyad_mm_blocks_two")

            same = True
            for key, z2 in z2s.items():
                call(z2)
                torch.cuda.synchronize()
                same = same and torch.equal(z1, want[0]) and torch.equal(
                    z2, want[1])
            ms = {key: [] for key in LAYOUTS}
            for key in LAYOUTS + LAYOUTS[::-1]:
                ms[key].append(round(time_ms(lambda: call(z2s[key])), 4))
            print(json.dumps({"shape": f"opt_{proj}_M{M}", "view": view,
                              "ms": ms, "bitwise_vs_wrapper": same,
                              "card": card}), flush=True)
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
