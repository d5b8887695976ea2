#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: build, check, time, serve, train.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--seed N]

Phases, one line each (a phase that fails ends the run with a non-zero
exit and no result line):

1. the device: name and power limit (``nvidia-smi``);
2. the build of every kernel in ``src/repro_torch/kernels/csrc``;
3. each kernel against its plain PyTorch version on the card, fp32 and
   bf16, at the OPT-125m and Qwen3-0.6B serving and training shapes and
   the edge cases;
4. the time of each kernel, its plain version and a library yardstick
   (CUDA events around device work queued ahead, L2 flushed before each
   run, median of 25 after warm-up);
5. the OPT serving path: OPT-125m at full width with ``dyad_it_4_kernel``,
   random weights from ``--seed``, ``Engine.generate`` at batch 8, prompt
   128, 32 new tokens, with the kernels' launch counters read around it;
   5b. a ``torch.profiler`` trace of one more generate: device-busy share
   and the kernels that take the most device time;
6. that serving path on the card against the same port on the CPU;
7. the OPT training path: OPT-125m at full width, fp32, through the train
   launcher's ``build_trainer`` (``make_train_step`` and ``Trainer``), B 8
   x S 512 of ``SyntheticLM``; 2 warm-up steps, one step with the launch
   counters read around it, then 5 timed steps: the step (``step_time_s``),
   the host's batch (``data_time_s``) and the loop's wall time per step;
   the same with ``--linear dense`` (the paper's comparison, printed, not
   claimed); 7b. a ``torch.profiler`` trace of one DYAD train step;
   7c. the same training path with the OT and DT variants
   (``dyad_ot_4_kernel``, ``dyad_dt_4_kernel``) at full depth, their
   launch counters checked exactly;
8. one train step of OPT-125m and Pythia-160m at full width and 2 layers
   on the card against the CPU port on the same params and batch, and on
   the card the kernel backward against the forced plain backward;
9. the Qwen3-0.6B serving path at full width with the ff megakernel
   (``dyad_it_4_kernel_ffused``, bf16 compute, fp32 cache): generate at
   batch 8, prompt 128, 32 new, launch counters checked exactly, and a
   profile of one more generate;
10. the Qwen3-0.6B training path (full config, remat, bf16) at B 8 x
   S 512 as in phase 7, with the DENSE run and a profiled step;
11. Qwen3-0.6B at full width and 2 layers on the card against the CPU
   port: a train step in fp32 and in bf16, greedy tokens in fp32, the
   kernel backward against the plain one, the ``split`` ff route against
   ``fused``; and one OPT-125m train step each with the OT and DT
   variants at 2 layers;
12. the ``kernels`` JSON line, then the result line.

Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, the
# fp32 (non-tensor-core) FLOP/s and the bf16 tensor-core FLOP/s, the peak
# rate for each input type
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # x max(|plain|, 1)
LOGIT_TOL = 1e-4                             # x max(|cpu logits|, 1)
# card vs CPU train step, fp32 both: loss relative; each grad leaf against
# max(|cpu leaf|, 1e-3) (sums over 512 tokens and the 50k vocabulary run
# in other orders on the two devices)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4

# card vs CPU train step in bf16: both round every activation to bf16
# (2^-8 relative) at other places, over 2 layers; the loss read 4.8e-5
# and the grads 1.6e-2 on an H100.  The run also prints, not gated, the
# card's bf16 step against the CPU's fp32 step: the gap that rounding
# alone opens
LOSS_TOL_BF16, GRAD_TOL_BF16 = 1e-3, 5e-2

SMOKE = {"B": 8, "S": 128, "new": 32}        # the serving path's batch
PARITY = {"B": 2, "S": 32, "new": 8}         # the card vs CPU comparison
TRAIN = {"B": 8, "S": 512, "warmup": 2, "timed": 5}   # the training path
TRAIN_PARITY = {"B": 2, "S": 256, "layers": 2}
# Qwen3-0.6B at 2 layers against the CPU: its 151936-word LM head makes
# the CPU side the slow one, so the batch is smaller (bf16 smaller still)
QWEN_PARITY = {"B": 2, "S": 128, "S_bf16": 64, "layers": 2}
QWEN_FF = "dyad_it_4_kernel_ffused"


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def _close(got, want, tol: float):
    """(ok, max_abs_err, bound): error bound scaled to the plain magnitude."""
    got, want = got.float(), want.float()
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    return err <= tol * scale, err, tol * scale


def _timer(torch, flush_buf):
    """Median device time of ``fn`` in ms.  Before each run the L2 is
    flushed (the layer-by-layer caller finds it cold) and the device is
    kept busy for ~0.5 ms, so the host has enqueued all of ``fn`` before
    the start event fires: the events then time the device, not the host's
    launch overhead."""
    def time_ms(fn, warmup: int = 5, iters: int = 25) -> float:
        for _ in range(warmup):
            fn()
        ts = []
        for _ in range(iters):
            flush_buf.zero_()
            torch.cuda._sleep(1_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)
    return time_ms


def _bound_ms(nbytes: float, flops: float, flop_rate: float):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _time_ff_slice(torch, randn, record, time_ms, two_cases, ff_cases):
    """Phase 4 for the three kernels of the ff slice, at the shapes of
    the paths that launch them: dyad_mm_blocks_two at OPT-125m's OT
    forward (fp32, the OT train step) and at Qwen3's split-route down
    projection (bf16); dyad_mm_dgrad at Qwen3's down dh (bf16, the train
    step); dyad_ff_fused at Qwen3's training, prefill and decode rows (bf16
    x, the fp32 params), beside the split route and a torch.bmm chain,
    each a composition of several calls."""
    from repro_torch.kernels import dyad_mm

    bf16, f32 = torch.bfloat16, torch.float32

    def two(label, dt, rate):
        M, n, d_in, d_out = two_cases[label]
        x1 = randn(M, n, d_in, dtype=dt)
        w1, w2 = (randn(n, d_out, d_in).to(dt) for _ in range(2))
        # OT (x2 = x1); yardstick: one torch.bmm over both components
        xc = torch.cat([x1, x1], dim=1).transpose(0, 1).contiguous()
        wc = torch.cat([w1, w2], dim=0).transpose(1, 2).contiguous()
        es = x1.element_size()
        record("dyad_mm_blocks_two" + ("" if dt == f32 else "@qwen3_split"),
               time_ms(lambda: dyad_mm.dyad_mm_blocks_two(x1, x1, w1, w2)),
               time_ms(lambda: dyad_mm.dyad_mm_blocks_two_plain(
                   x1, x1, w1, w2)),
               time_ms(lambda: torch.bmm(xc, wc)),
               es * (M * n * d_in + 2 * n * d_out * d_in + 2 * M * n * d_out),
               4.0 * M * n * d_out * d_in, label, rate, str(dt)[6:])

    two("opt_up_M4096", f32, FP32_FLOPS)
    two("opt_down_M4096", f32, FP32_FLOPS)
    two("qwen3_split_down_M4096", bf16, BF16_FLOPS)

    # dyad_mm_dgrad: Qwen3's down projection dh at the training rows, the
    # OT cotangent views; yardstick: one torch.bmm over the contraction
    # of both components
    M, n, d_ff, d_out = two_cases["qwen3_split_down_M4096"]
    g = randn(M, n * d_out, dtype=bf16)
    z1, z2 = g.reshape(M, n, d_out), g.reshape(M, d_out, n).transpose(1, 2)
    w1, w2 = (randn(n, d_out, d_ff).to(bf16) for _ in range(2))
    zc = torch.cat([z1, z2], dim=2).transpose(0, 1).contiguous()
    wc = torch.cat([w1, w2], dim=1).contiguous()
    record("dyad_mm_dgrad",
           time_ms(lambda: dyad_mm.dyad_mm_dgrad(z1, z2, w1, w2)),
           time_ms(lambda: dyad_mm.dyad_mm_dgrad_plain(z1, z2, w1, w2)),
           time_ms(lambda: torch.bmm(zc, wc)),
           2 * (M * n * d_out + 2 * n * d_out * d_ff + M * n * d_ff),
           4.0 * M * n * d_out * d_ff, "qwen3_down_dh_M4096", BF16_FLOPS,
           "bfloat16")

    # dyad_ff_fused: bf16 x, fp32 params (the main path's inputs)
    for label, suffix in (("qwen3_M4096", ""), ("qwen3_M1024", "@prefill"),
                          ("qwen3_M8", "@decode")):
        M, n, d_in, d_ff, d_out, act = ff_cases[label]
        args = _ff_args(randn, M, n, d_in, d_ff, d_out, act, bf16, f32)
        x1, x2 = args[0], args[1]
        x = x1.reshape(M, n * d_in)
        wb = [a.to(bf16) for a in args[2:]]        # wu1 wu2 wd1 wd2 wg1 wg2
        # the split route, from bf16 weights: dyad_mm_blocks for up and
        # gate, silu * up, dyad_mm_blocks_two for down
        def split():
            u = dyad_mm.dyad_mm_blocks(x, wb[0], wb[1])
            h = torch.nn.functional.silu(dyad_mm.dyad_mm_blocks(
                x, wb[4], wb[5])) * u
            return dyad_mm.dyad_mm_blocks_two(h, h, wb[2], wb[3])
        # the same chain through torch.bmm over the -CAT operands
        xc = torch.cat([x1, x2], dim=2).transpose(0, 1).contiguous()
        wuc = torch.cat([wb[0], wb[1]], dim=2).transpose(1, 2).contiguous()
        wgc = torch.cat([wb[4], wb[5]], dim=2).transpose(1, 2).contiguous()
        wdc = torch.cat([wb[2], wb[3]], dim=1).transpose(1, 2).contiguous()
        def chain():
            h = torch.nn.functional.silu(torch.bmm(xc, wgc)) * torch.bmm(
                xc, wuc)
            return torch.bmm(h, wdc)
        flops = 2.0 * M * n * (4 * d_ff * d_in + 2 * d_out * d_ff)
        nbytes = (2 * M * n * d_in + 4 * (4 * n * d_ff * d_in
                                          + 2 * n * d_out * d_ff)
                  + 2 * 2 * M * n * d_out)
        record("dyad_ff_fused" + suffix,
               time_ms(lambda: dyad_mm.dyad_ff_fused(*args, act=act)),
               time_ms(lambda: dyad_mm.dyad_ff_fused_plain(*args, act=act)),
               None, nbytes, flops, label, BF16_FLOPS, "bfloat16",
               split_route_ms=time_ms(split), bmm_chain_ms=time_ms(chain))


def _ff_args(randn, M, n, d_in, d_ff, d_out, act, dtype, wdtype):
    """dyad_ff_fused's arguments: the IT views of one (M, n * d_in)
    activation in ``dtype``, up (and gate) and down weights in ``wdtype``
    at the init scale."""
    x = randn(M, n * d_in, dtype=dtype)
    x1, x2 = x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(1, 2)
    n_up = 4 if act == "swiglu" else 2
    ups = [(randn(n, d_ff, d_in) / d_in ** 0.5).to(wdtype)
           for _ in range(n_up)]
    downs = [(randn(n, d_out, d_ff) / d_ff ** 0.5).to(wdtype)
             for _ in range(2)]
    gates = ups[2:] if act == "swiglu" else [None, None]
    return (x1, x2, ups[0], ups[1], downs[0], downs[1], *gates)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    # -- 1. the device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log("device", kind=repr(kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import build, dyad_mm, flash_attn

    # -- 2. the build --------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    for name in build.ENTRIES:
        build.entry(name)
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        built=",".join(sorted(built)) or "none (cached)",
        dir=build.BUILD_DIR.relative_to(root))

    # -- 3. each kernel against its plain version ----------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    failures = []

    def check(label, got, want, dtype_name):
        ok, err, bound = _close(got, want, TOL[dtype_name])
        log("check", case=label, dtype=dtype_name, max_abs_err=f"{err:.3e}",
            tol=f"{bound:.3e}", ok=ok)
        if not ok:
            failures.append(label)
        return err

    D, FF, N = 768, 3072, 4
    dyad_cases = {
        # the training rows: B 8 x S 512
        "up_M4096": (4096, N, D // N, FF // N, "it"),
        "down_M4096": (4096, N, FF // N, D // N, "it"),
        "up_M1024": (1024, N, D // N, FF // N, "it"),
        "down_M1024": (1024, N, FF // N, D // N, "it"),
        "up_M8": (8, N, D // N, FF // N, "it"),
        "down_M8": (8, N, FF // N, D // N, "it"),
        "ragged_it": (64, 2, 129, 130, "it"),
        "ragged_ot": (64, 2, 129, 130, "ot"),
        "rows3_prime": (3, 3, 7, 5, "it"),       # the decode-row kernel
        "rows5_ragged_dt": (5, 2, 129, 130, "dt"),
    }
    max_err = {"dyad_mm_blocks": 0.0, "flash_prefill": 0.0,
               "flash_decode": 0.0, "dyad_mm_dgrad_two": 0.0,
               "dyad_mm_wgrad": 0.0, "flash_prefill_grads": 0.0,
               "dyad_mm_blocks_two": 0.0, "dyad_mm_dgrad": 0.0,
               "dyad_ff_fused": 0.0}
    # Qwen3-0.6B's ff: d 1024, d_ff 3072, n 4; blocks d_in 256, d_ff 768,
    # d_out 256
    QD, QFF = 1024, 3072
    # dyad_mm_blocks_two (x1 and both x2 views) and dyad_mm_dgrad (the OT
    # cotangent views): (M, n, d_in, d_out)
    two_cases = {
        "qwen3_split_down_M4096": (4096, N, QFF // N, QD // N),
        "opt_up_M4096": (4096, N, D // N, FF // N),
        "opt_down_M4096": (4096, N, FF // N, D // N),
        "ragged_M129": (129, 2, 13, 130),
        "prime": (7, 3, 5, 3),
    }
    # dyad_ff_fused: (M, n, d_in, d_ff, d_out, act); the Qwen3 cases at the
    # training, prefill and decode rows (the last two split the hidden)
    ff_cases = {
        "qwen3_M4096": (4096, N, QD // N, QFF // N, QD // N, "swiglu"),
        "qwen3_M1024": (1024, N, QD // N, QFF // N, QD // N, "swiglu"),
        "qwen3_M8": (8, N, QD // N, QFF // N, QD // N, "swiglu"),
        "ragged_gelu": (3, 2, 129, 130, 17, "gelu"),
        "ragged_relu_wide_out": (45, 3, 33, 200, 300, "relu"),
        "ragged_silu": (37, 2, 64, 100, 64, "silu"),
        "ragged_swiglu": (5, 2, 129, 130, 17, "swiglu"),
    }
    # the backward kernels at the OPT-125m training rows (B 8 x S 512) and
    # the edge cases: (M, n, d_in, d_out)
    bwd_cases = {
        "up_M4096": (4096, N, D // N, FF // N),
        "down_M4096": (4096, N, FF // N, D // N),
        "ragged_M129": (129, 2, 13, 130),
        "prime": (7, 3, 5, 3),
    }
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[1]
        for label, (M, n, d_in, d_out, var) in dyad_cases.items():
            x = randn(M, n * d_in, dtype=dt)
            k = 1.0 / (n * d_in) ** 0.5
            w1 = (randn(n, d_out, d_in) * k).to(dt)
            w2 = (randn(n, d_out, d_in) * k).to(dt)
            err = check(f"dyad_mm_blocks/{label}",
                        dyad_mm.dyad_mm_blocks(x, w1, w2, var),
                        dyad_mm.dyad_mm_blocks_plain(x, w1, w2, var), dn)
            if dt == torch.float32:
                max_err["dyad_mm_blocks"] = max(max_err["dyad_mm_blocks"],
                                                err)

        prefill_cases = {
            # the training attention of one layer: B 8, S = T = 512
            "train": dict(B=8, S=512, T=512, K=12, G=1, h=64, causal=True,
                          window=None, q_off=0, k_off=0),
            # the serving cache prefill: S = 128 prompt over the 160-slot cache
            "main": dict(B=8, S=128, T=160, K=12, G=1, h=64, causal=True,
                         window=None, q_off=0, k_off=0),
            # GQA, window, per-batch offsets; batch 3's queries (32..79)
            # sit before its first key (60): fully-masked rows
            "gqa_window_offsets": dict(
                B=4, S=48, T=80, K=3, G=2, h=64, causal=True, window=16,
                q_off=torch.tensor([0, 5, 17, 32], device=dev),
                k_off=torch.tensor([0, 0, 3, 60], device=dev)),
            "noncausal_h16": dict(B=2, S=37, T=37, K=2, G=2, h=16,
                                  causal=False, window=None, q_off=0,
                                  k_off=0),
            # Qwen3-0.6B: the training attention (K 8, G 2, h 128) and
            # the serving cache prefill
            "qwen3_train": dict(B=8, S=512, T=512, K=8, G=2, h=128,
                                causal=True, window=None, q_off=0, k_off=0),
            "qwen3_main": dict(B=8, S=128, T=160, K=8, G=2, h=128,
                               causal=True, window=None, q_off=0, k_off=0),
        }
        for label, c in prefill_cases.items():
            q = randn(c["B"], c["S"], c["K"], c["G"], c["h"], dtype=dt)
            kk = randn(c["B"], c["T"], c["K"], c["h"], dtype=dt)
            vv = randn(c["B"], c["T"], c["K"], c["h"], dtype=dt)
            kw = dict(causal=c["causal"], window=c["window"], save_lse=True)
            o, lse = flash_attn.flash_prefill(q, kk, vv, c["q_off"],
                                              c["k_off"], **kw)
            po, plse = flash_attn.flash_prefill_plain(q, kk, vv, c["q_off"],
                                                      c["k_off"], **kw)
            err = check(f"flash_prefill/{label}", o, po, dn)
            # lse: rows with a valid key within tolerance; fully-masked rows
            # (lse = -1e30 + log 1e-30) must be such rows in both
            live = plse > -1e29
            check(f"flash_prefill/{label}/lse", lse[live], plse[live], dn)
            dead = int((~live).sum())
            dead_ok = (bool((lse[~live] <= -1e29).all())
                       and bool((o.float().abs().amax(dim=-1) == 0).sum()
                                >= dead))
            if label == "gqa_window_offsets":
                dead_ok = dead_ok and dead > 0
            log("check", case=f"flash_prefill/{label}/fully_masked_rows",
                dtype=dn, rows=dead, ok=dead_ok)
            if not dead_ok:
                failures.append(f"flash_prefill/{label}/fully_masked_rows")
            if dt == torch.float32:
                max_err["flash_prefill"] = max(max_err["flash_prefill"], err)

        decode_cases = {
            "scalar_idx": dict(B=8, L=160, K=12, G=1, h=64, idx=143,
                               window=None),
            "vector_idx": dict(B=8, L=160, K=12, G=1, h=64,
                               idx=torch.tensor([0, 5, 77, 159, 130, 31, 32,
                                                 100], device=dev),
                               window=None),
            "wrapped_window": dict(B=4, L=64, K=3, G=2, h=64,
                                   idx=torch.tensor([70, 150, 64, 200],
                                                    device=dev), window=48),
            "qwen3": dict(B=8, L=160, K=8, G=2, h=128, idx=143, window=None),
        }
        for label, c in decode_cases.items():
            q = randn(c["B"], 1, c["K"], c["G"], c["h"], dtype=dt)
            kk = randn(c["B"], c["L"], c["K"], c["h"], dtype=dt)
            vv = randn(c["B"], c["L"], c["K"], c["h"], dtype=dt)
            err = check(f"flash_decode/{label}",
                        flash_attn.flash_decode(q, kk, vv, c["idx"],
                                                window=c["window"]),
                        flash_attn.flash_decode_plain(q, kk, vv, c["idx"],
                                                      window=c["window"]), dn)
            if dt == torch.float32:
                max_err["flash_decode"] = max(max_err["flash_decode"], err)

        def note(name, err):
            if dt == torch.float32:
                max_err[name] = max(max_err[name], err)

        for label, (M, n, d_in, d_out) in bwd_cases.items():
            x = randn(M, n * d_in, dtype=dt)
            g = randn(M, n * d_out, dtype=dt)
            w1 = (randn(n, d_out, d_in) / d_out ** 0.5).to(dt)
            w2 = (randn(n, d_out, d_in) / d_out ** 0.5).to(dt)
            # the IT operands: x1, the stride-n x2, one cotangent view; and
            # a strided z2 (the DT cotangent layout)
            x1, x2 = x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(
                1, 2)
            z, z2 = g.reshape(M, n, d_out), g.reshape(M, d_out, n).transpose(
                1, 2)
            for zl, zb in (("it", z), ("dt", z2)):
                got = dyad_mm.dyad_mm_dgrad_two(z, zb, w1, w2)
                want = dyad_mm.dyad_mm_dgrad_two_plain(z, zb, w1, w2)
                for c in (0, 1):
                    note("dyad_mm_dgrad_two", check(
                        f"dyad_mm_dgrad_two/{label}/{zl}/dx{c + 1}", got[c],
                        want[c], dn))
            for out_dt in {dt, torch.float32}:
                got = dyad_mm.dyad_mm_wgrad(x1, x2, z, z, out_dtype=out_dt)
                want = dyad_mm.dyad_mm_wgrad_plain(x1, x2, z, z,
                                                   out_dtype=out_dt)
                for c in (0, 1):
                    note("dyad_mm_wgrad", check(
                        f"dyad_mm_wgrad/{label}/out_{str(out_dt)[6:]}"
                        f"/dw{c + 1}", got[c], want[c], dn))

        grads_cases = {
            # the training attention of one layer: B 8, S 512, K 12, causal
            "main": dict(B=8, S=512, K=12, G=1, h=64, causal=True,
                         window=None, q_off=0, k_off=0),
            # GQA, window, per-batch offsets; batch 3's queries sit before
            # its first key: fully-masked rows, zero gradients
            "gqa_window_offsets": dict(
                B=4, S=48, K=3, G=2, h=64, causal=True, window=16,
                q_off=torch.tensor([0, 5, 17, 0], device=dev),
                k_off=torch.tensor([0, 0, 3, 60], device=dev)),
            "noncausal_h16": dict(B=2, S=37, K=2, G=2, h=16, causal=False,
                                  window=None, q_off=0, k_off=0),
            "ragged_h128": dict(B=2, S=45, K=1, G=4, h=128, causal=True,
                                window=None, q_off=3, k_off=3),
            "qwen3_train": dict(B=8, S=512, K=8, G=2, h=128, causal=True,
                                window=None, q_off=0, k_off=0),
        }
        for label, c in grads_cases.items():
            q = randn(c["B"], c["S"], c["K"], c["G"], c["h"], dtype=dt)
            kk = randn(c["B"], c["S"], c["K"], c["h"], dtype=dt)
            vv = randn(c["B"], c["S"], c["K"], c["h"], dtype=dt)
            do = randn(c["B"], c["S"], c["K"], c["G"], c["h"], dtype=dt)
            kw = dict(causal=c["causal"], window=c["window"])
            # each side's backward takes its own forward's o and lse, so a
            # wrong lse from the forward kernel shows here too
            o, lse = flash_attn.flash_prefill(q, kk, vv, c["q_off"],
                                              c["k_off"], save_lse=True, **kw)
            po, plse = flash_attn.flash_prefill_plain(
                q, kk, vv, c["q_off"], c["k_off"], save_lse=True, **kw)
            got = flash_attn.flash_prefill_grads(q, kk, vv, o, lse, do,
                                                 c["q_off"], c["k_off"], **kw)
            want = flash_attn.flash_prefill_grads_plain(
                q, kk, vv, po, plse, do, c["q_off"], c["k_off"], **kw)
            finite = all(bool(torch.isfinite(t.float()).all()) for t in got)
            if not finite:
                failures.append(f"flash_prefill_grads/{label}/finite")
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                note("flash_prefill_grads", check(
                    f"flash_prefill_grads/{label}/{name}", a, b, dn))

        if dt == torch.bfloat16:
            # bf16 queries against an fp32 cache (Qwen3's serving path):
            # the promoted product, as the plain versions compute it
            q = randn(8, 1, 8, 2, 128, dtype=dt)
            kk, vv = randn(8, 160, 8, 128), randn(8, 160, 8, 128)
            check("flash_decode/bf16_q_fp32_cache",
                  flash_attn.flash_decode(q, kk, vv, 143),
                  flash_attn.flash_decode_plain(q, kk, vv, 143), dn)
            q = randn(8, 128, 8, 2, 128, dtype=dt)
            check("flash_prefill/bf16_q_fp32_cache",
                  flash_attn.flash_prefill(q, kk, vv)[0],
                  flash_attn.flash_prefill_plain(q, kk, vv)[0], dn)

        for label, (M, n, d_in, d_out) in two_cases.items():
            x = randn(M, n * d_in, dtype=dt)
            w1 = (randn(n, d_out, d_in) / d_in ** 0.5).to(dt)
            w2 = (randn(n, d_out, d_in) / d_in ** 0.5).to(dt)
            x1 = x.reshape(M, n, d_in)
            for xl, xb in (("ot", x1),
                           ("dt", x.reshape(M, d_in, n).transpose(1, 2))):
                got = dyad_mm.dyad_mm_blocks_two(x1, xb, w1, w2)
                want = dyad_mm.dyad_mm_blocks_two_plain(x1, xb, w1, w2)
                for c in (0, 1):
                    note("dyad_mm_blocks_two", check(
                        f"dyad_mm_blocks_two/{label}/{xl}/z{c + 1}", got[c],
                        want[c], dn))
            g = randn(M, n * d_out, dtype=dt)
            z1 = g.reshape(M, n, d_out)
            z2 = g.reshape(M, d_out, n).transpose(1, 2)
            note("dyad_mm_dgrad", check(
                f"dyad_mm_dgrad/{label}", dyad_mm.dyad_mm_dgrad(z1, z2, w1, w2),
                dyad_mm.dyad_mm_dgrad_plain(z1, z2, w1, w2), dn))

        for label, (M, n, d_in, d_ff, d_out, act) in ff_cases.items():
            # the Qwen3 cases take what the main path gives the kernel: x
            # in the compute dtype, the fp32 params
            wdt = torch.float32 if label.startswith("qwen3") else dt
            ff_in = _ff_args(randn, M, n, d_in, d_ff, d_out, act, dt, wdt)
            got = dyad_mm.dyad_ff_fused(*ff_in, act=act)
            want = dyad_mm.dyad_ff_fused_plain(*ff_in, act=act)
            for c in (0, 1):
                note("dyad_ff_fused", check(
                    f"dyad_ff_fused/{label}/z{c + 1}", got[c], want[c], dn))
            # the hidden split adds in a fixed order: the same bits again
            again = dyad_mm.dyad_ff_fused(*ff_in, act=act)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            if wdt != dt:
                # fp32 weights rounded in the kernel = bf16 weights cast
                # before the call
                cast = [a if a is None or i < 2 else a.to(dt)
                        for i, a in enumerate(ff_in)]
                pre = dyad_mm.dyad_ff_fused(*cast, act=act)
                same = same and all(torch.equal(a, b)
                                    for a, b in zip(got, pre))
            log("check", case=f"dyad_ff_fused/{label}/bitwise_repeat",
                dtype=dn, split=dyad_mm.ff_split(
                    M, n, d_ff, d_out, dyad_mm.sm_count(dev))[0],
                ok=same)
            if not same:
                failures.append(f"dyad_ff_fused/{label}/bitwise_repeat")
    torch.cuda.synchronize()
    if failures:
        log("check", failed=",".join(failures))
        return 1

    # -- 4. time each kernel at the main path's shapes (fp32) ----------------
    import torch.nn.functional as F

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    time_ms = _timer(torch, flush)
    f32 = 4
    timing = {}

    def record(name, ms, plain_ms, lib_ms, nbytes, flops, shape,
               rate=FP32_FLOPS, dtype="float32", **extra):
        """One timed shape of a kernel; ``lib_ms`` None where no single
        PyTorch call computes the function (``extra`` then holds the
        compositions timed instead)."""
        bound, by = _bound_ms(nbytes, flops, rate)
        t = timing.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                     "library_ms": 0.0, "bound_ms": 0.0,
                                     "bytes": 0.0, "flops": 0.0,
                                     "shape": [], "rate": rate,
                                     "dtype": dtype})
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", bound),
                         ("bytes", nbytes), ("flops", flops)):
            t[key] = None if val is None or t[key] is None else t[key] + val
        for key, val in extra.items():
            t[key] = t.get(key, 0.0) + val
        t["shape"].append(shape)
        log("time", kernel=name, shape=shape, dtype=dtype, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}",
            library_ms="null" if lib_ms is None else f"{lib_ms:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=by,
            **{k: f"{v:.4f}" for k, v in extra.items()})

    # dyad_mm_blocks: one layer's ff, up + down, at prefill and decode rows
    # (the kernels line); at the training rows under a name of its own
    for label in ("up_M1024", "down_M1024", "up_M8", "down_M8", "up_M4096",
                  "down_M4096"):
        M, n, d_in, d_out, var = dyad_cases[label]
        x = randn(M, n * d_in)
        w1, w2 = randn(n, d_out, d_in), randn(n, d_out, d_in)
        x1 = x.reshape(M, n, d_in)
        x2 = x.reshape(M, d_in, n).transpose(1, 2)
        # the library yardstick: one torch.bmm over the -CAT operands
        xc = torch.cat([x1, x2], dim=-1).transpose(0, 1).contiguous()
        wc = torch.cat([w1, w2], dim=-1).transpose(1, 2).contiguous()
        nbytes = f32 * (M * n * d_in + 2 * n * d_out * d_in + M * n * d_out)
        name = "dyad_mm_blocks" + ("@train" if M == 4096 else "")
        record(name, time_ms(lambda: dyad_mm.dyad_mm_blocks(x, w1, w2, var)),
               time_ms(lambda: dyad_mm.dyad_mm_blocks_plain(x, w1, w2, var)),
               time_ms(lambda: torch.bmm(xc, wc)), nbytes,
               4.0 * M * n * d_out * d_in, label)

    # flash_prefill: one layer's training attention, under a name of its
    # own, with the lse the backward reads
    Bt, St, K, h = TRAIN["B"], TRAIN["S"], 12, 64
    q, kt, vt = (randn(Bt, St, K, 1, h), randn(Bt, St, K, h),
                 randn(Bt, St, K, h))
    qs, ks, vs = (q[:, :, :, 0].transpose(1, 2), kt.transpose(1, 2),
                  vt.transpose(1, 2))
    pairs = Bt * K * St * (St + 1) // 2
    record("flash_prefill@train",
           time_ms(lambda: flash_attn.flash_prefill(q, kt, vt, save_lse=True)),
           time_ms(lambda: flash_attn.flash_prefill_plain(q, kt, vt,
                                                          save_lse=True)),
           time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                          is_causal=True)),
           f32 * (4 * Bt * St * K * h + Bt * K * St),    # q, k, v, o; lse
           4.0 * h * pairs, f"B{Bt}_S{St}_K{K}_h{h}_causal")

    # flash_prefill: the cache prefill of one layer (q_off = k_off = 0)
    B, S, new, K, h = SMOKE["B"], SMOKE["S"], SMOKE["new"], 12, 64
    L = S + new
    q = randn(B, S, K, 1, h)
    kc, vc = randn(B, L, K, h), randn(B, L, K, h)
    pairs = B * K * S * (S + 1) // 2            # causal (q, k) pairs in band
    nbytes = f32 * (2 * B * S * K * h + 2 * B * S * K * h)  # q, o, k/v rows
    qt, kt, vt = (q[:, :, :, 0].transpose(1, 2), kc.transpose(1, 2),
                  vc.transpose(1, 2))
    record("flash_prefill",
           time_ms(lambda: flash_attn.flash_prefill(q, kc, vc, 0, 0)),
           time_ms(lambda: flash_attn.flash_prefill_plain(q, kc, vc, 0, 0)),
           time_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True)),
           nbytes, 4.0 * h * pairs, f"B{B}_S{S}_T{L}_K{K}_h{h}")

    # flash_decode: one decode step of one layer, mid-generation
    idx = S + new // 2 - 1
    q1 = randn(B, 1, K, 1, h)
    valid = idx + 1
    nbytes = f32 * (2 * B * K * h + 2 * B * valid * K * h)
    pos = torch.arange(L, device=dev)
    amask = (pos <= idx)[None, None, None, :]
    q1t = q1[:, 0].reshape(B, K, 1, h)
    record("flash_decode",
           time_ms(lambda: flash_attn.flash_decode(q1, kc, vc, idx)),
           time_ms(lambda: flash_attn.flash_decode_plain(q1, kc, vc, idx)),
           time_ms(lambda: F.scaled_dot_product_attention(
               q1t, kt, vt, attn_mask=amask)),
           nbytes, 4.0 * h * B * K * valid, f"B{B}_L{L}_K{K}_h{h}_idx{idx}")

    # dyad_mm_dgrad_two, dyad_mm_wgrad: one layer's ff backward, up + down,
    # at the training rows.  Yardstick: one torch.bmm over both components
    # on contiguous operands.
    for label in ("up_M4096", "down_M4096"):
        M, n, d_in, d_out = bwd_cases[label]
        x, g = randn(M, n * d_in), randn(M, n * d_out)
        w1, w2 = randn(n, d_out, d_in), randn(n, d_out, d_in)
        x1, x2 = x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(1, 2)
        z = g.reshape(M, n, d_out)
        flops = 4.0 * M * n * d_out * d_in
        zc = torch.cat([z, z], dim=1).transpose(0, 1).contiguous()
        wc = torch.cat([w1, w2], dim=0).contiguous()
        xc = torch.cat([x1, x2], dim=1).transpose(0, 1).contiguous()
        zt = zc.transpose(1, 2).contiguous()
        record("dyad_mm_dgrad_two",
               time_ms(lambda: dyad_mm.dyad_mm_dgrad_two(z, z, w1, w2)),
               time_ms(lambda: dyad_mm.dyad_mm_dgrad_two_plain(z, z, w1, w2)),
               time_ms(lambda: torch.bmm(zc, wc)),
               f32 * (M * n * d_out + 2 * n * d_out * d_in + 2 * M * n * d_in),
               flops, label)
        record("dyad_mm_wgrad",
               time_ms(lambda: dyad_mm.dyad_mm_wgrad(x1, x2, z, z)),
               time_ms(lambda: dyad_mm.dyad_mm_wgrad_plain(x1, x2, z, z)),
               time_ms(lambda: torch.bmm(zt, xc)),
               f32 * (M * n * d_in + M * n * d_out + 2 * n * d_out * d_in),
               flops, label)

    # flash_prefill_grads: one layer's attention backward at the training
    # shape.  Yardstick: the backward of F.scaled_dot_product_attention.
    Bt, St, K, h = TRAIN["B"], TRAIN["S"], 12, 64
    q, kt, vt, do = (randn(Bt, St, K, 1, h), randn(Bt, St, K, h),
                     randn(Bt, St, K, h), randn(Bt, St, K, 1, h))
    o, lse = flash_attn.flash_prefill(q, kt, vt, save_lse=True)
    sq, sk, sv = (t.reshape(Bt, St, K, h).transpose(1, 2).detach()
                  .requires_grad_() for t in (q, kt, vt))
    sout = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
    sdo = do.reshape(Bt, St, K, h).transpose(1, 2)
    pairs = Bt * K * St * (St + 1) // 2
    record("flash_prefill_grads",
           time_ms(lambda: flash_attn.flash_prefill_grads(q, kt, vt, o, lse,
                                                          do)),
           time_ms(lambda: flash_attn.flash_prefill_grads_plain(
               q, kt, vt, o, lse, do)),
           time_ms(lambda: torch.autograd.grad(sout, (sq, sk, sv), sdo,
                                               retain_graph=True)),
           # q, k, v, o, do read; dq, dk, dv written; lse
           f32 * (8 * Bt * St * K * h + Bt * K * St),
           # recomputed scores, dp, dq, dk, dv: five 2h products per pair
           10.0 * h * pairs, f"B{Bt}_S{St}_K{K}_h{h}_causal")
    _time_ff_slice(torch, randn, record, time_ms, two_cases, ff_cases)
    del flush, sout

    # -- 5. the OPT serving path ---------------------------------------------
    wrappers = {"dyad_mm_blocks": dyad_mm.dyad_mm_blocks,
                "flash_prefill": flash_attn.flash_prefill,
                "flash_decode": flash_attn.flash_decode,
                "dyad_mm_dgrad_two": dyad_mm.dyad_mm_dgrad_two,
                "dyad_mm_wgrad": dyad_mm.dyad_mm_wgrad,
                "flash_prefill_grads": flash_attn.flash_prefill_grads,
                "dyad_mm_blocks_two": dyad_mm.dyad_mm_blocks_two,
                "dyad_mm_dgrad": dyad_mm.dyad_mm_dgrad,
                "dyad_ff_fused": dyad_mm.dyad_ff_fused}
    run = _Run(torch, dev, args.seed, wrappers)

    steps = new - 1
    serve_launches = run.serve("opt125m", "dyad_it_4_kernel", B, S, new,
                               {"dyad_mm_blocks": 2 * (1 + steps),
                                "flash_prefill": 1, "flash_decode": steps},
                               "main", "profile")
    if serve_launches is None:
        return 1

    # -- 7, 7b. the OPT training path ------------------------------------------
    train_launches = run.train("opt125m", "dyad_it_4_kernel", {
        "dyad_mm_blocks": 2, "dyad_mm_dgrad_two": 2, "dyad_mm_wgrad": 2,
        "flash_prefill": 1, "flash_prefill_grads": 1}, "train")
    if train_launches is None:
        return 1

    # -- 7c. the OT and DT variants on the same path -------------------------
    # the forward of each ff projection is dyad_mm_blocks_two; its input
    # cotangent is dyad_mm_dgrad (OT: one accumulator) or dyad_mm_dgrad_two
    # (DT: the components apart, re-viewed)
    variant_launches = {}
    for spec, dx, phase in (
            ("dyad_ot_4_kernel", "dyad_mm_dgrad", "ot_train"),
            ("dyad_dt_4_kernel", "dyad_mm_dgrad_two", "dt_train")):
        got = run.train("opt125m", spec, {
            "dyad_mm_blocks_two": 2, dx: 2, "dyad_mm_wgrad": 2,
            "flash_prefill": 1, "flash_prefill_grads": 1}, phase,
            compare=False)
        if got is None:
            return 1
        variant_launches[spec] = got

    # -- 8. a train step on the card against the CPU port --------------------
    tp = TRAIN_PARITY
    for arch in ("opt125m", "pythia160m"):
        if not run.train_parity(arch, "dyad_it_4_kernel", tp["B"], tp["S"],
                                n_layers=tp["layers"]):
            return 1

    # -- 9. the Qwen3-0.6B serving path -------------------------------------
    qserve = run.serve("qwen3_0_6b", QWEN_FF, B, S, new,
                       {"dyad_ff_fused": 1 + steps, "flash_prefill": 1,
                        "flash_decode": steps}, "qwen3_main",
                       "qwen3_profile")
    if qserve is None:
        return 1

    # -- 10. the Qwen3-0.6B training path --------------------------------------
    # remat recomputes each block's forward once in the backward
    qtrain = run.train("qwen3_0_6b", QWEN_FF, {
        "dyad_ff_fused": 2, "dyad_mm_blocks": 2, "dyad_mm_dgrad": 1,
        "dyad_mm_wgrad": 3, "dyad_mm_dgrad_two": 2, "flash_prefill": 2,
        "flash_prefill_grads": 1}, "qwen3_train")
    if qtrain is None:
        return 1

    # -- 11. Qwen3-0.6B and the OT/DT variants against the CPU port --------
    qp = QWEN_PARITY
    over = {"n_layers": qp["layers"], "compute_dtype": "float32"}
    if not (run.train_parity("qwen3_0_6b", QWEN_FF, qp["B"], qp["S"], **over)
            and run.train_parity("qwen3_0_6b", QWEN_FF, qp["B"],
                                 qp["S_bf16"], tol=(LOSS_TOL_BF16,
                                                    GRAD_TOL_BF16),
                                 fp32_control=True, n_layers=qp["layers"])
            and run.split_vs_fused(qp["B"], qp["S"], **over)
            and run.serve_parity("qwen3_0_6b", QWEN_FF, **over)):
        return 1
    for spec in ("dyad_ot_4_kernel", "dyad_dt_4_kernel"):
        if not run.train_parity("opt125m", spec, tp["B"], tp["S"],
                                n_layers=tp["layers"]):
            return 1

    # -- 12. the kernels line ------------------------------------------------
    csrc = "src/repro_torch/kernels/csrc/"
    files = {"dyad_mm_blocks": ("dyad_mm.cu", "dyad_mm.py:286"),
             "flash_prefill": ("flash_prefill.cu", "flash_attn.py:288"),
             "flash_decode": ("flash_decode.cu", "flash_attn.py:670"),
             "dyad_mm_dgrad_two": ("dyad_dgrad.cu", "dyad_mm.py:472"),
             "dyad_mm_wgrad": ("dyad_wgrad.cu", "dyad_mm.py:560"),
             "flash_prefill_grads": ("flash_bwd.cu", "flash_attn.py:531"),
             "dyad_mm_blocks_two": ("dyad_mm_two.cu", "dyad_mm.py:261"),
             "dyad_mm_dgrad": ("dyad_dgrad_fused.cu", "dyad_mm.py:443"),
             "dyad_ff_fused": ("dyad_ff.cu", "dyad_mm.py:812")}
    # each kernel's launches come from the path that brought it in: OPT
    # serving for slice 1's, OPT training for slice 2's backward kernels,
    # the Qwen3 train step for the megakernel and dyad_mm_dgrad, the OPT
    # OT train step for dyad_mm_blocks_two; every path's counts were
    # checked exactly where it ran
    ot_train = variant_launches["dyad_ot_4_kernel"]
    main_path = {"dyad_mm_dgrad_two": train_launches,
                 "dyad_mm_wgrad": train_launches,
                 "flash_prefill_grads": train_launches,
                 "dyad_ff_fused": qtrain, "dyad_mm_dgrad": qtrain,
                 "dyad_mm_blocks_two": ot_train}
    line = []
    for name, (src, replaces) in files.items():
        tm = timing[name]
        _, by = _bound_ms(tm["bytes"], tm["flops"], tm["rate"])
        entry = {
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": "src/repro/kernels/" + replaces,
            "launches": main_path.get(name, serve_launches)[name],
            "launches_serve": serve_launches[name],
            "launches_train_step": train_launches[name],
            "launches_qwen3_serve": qserve[name],
            "launches_qwen3_train_step": qtrain[name],
            "launches_ot_train_step": ot_train[name],
            "launches_dt_train_step":
                variant_launches["dyad_dt_4_kernel"][name],
            "max_abs_err": max_err[name], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": by, "library_ms": tm["library_ms"],
            "shape": "+".join(tm["shape"]), "dtype": tm["dtype"]}
        for key in ("split_route_ms", "bmm_chain_ms"):
            if key in tm:
                entry[key] = tm[key]
        line.append(entry)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


class _Run:
    """The main-path phases: serving and training runs with the launch
    counters read around them, and the card-vs-CPU comparisons."""

    def __init__(self, torch, dev, seed, wrappers):
        self.torch, self.dev, self.seed = torch, dev, seed
        self.wrappers = wrappers
        self.cpu = torch.device("cpu")

    def zero_counts(self):
        for w in self.wrappers.values():
            w.launches = 0

    def counts(self):
        return {name: w.launches for name, w in self.wrappers.items()}

    def want(self, per_layer, n_layers):
        want = dict.fromkeys(self.wrappers, 0)
        want.update({k: v * n_layers for k, v in per_layer.items()})
        return want

    def serve(self, arch, spec, B, S, new, per_layer, phase, prof_phase):
        """Engine.generate at full width, counted; then one profiled
        generate and the card against the CPU port.  Returns the launch
        counts, None on a failure."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch import configs
        from repro_torch.models import model
        from repro_torch.serve.engine import Engine

        torch, dev = self.torch, self.dev
        cfg = configs.get(arch, linear=configs.linear_cfg(spec))
        pgen = torch.Generator(device=dev).manual_seed(self.seed)
        params = model.init_params(cfg, pgen, dev)
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=pgen,
                                device=dev)
        engine = Engine(cfg, params, max_len=S + new, device=dev)
        engine.generate(prompts, new)                     # warm-up
        self.zero_counts()
        toks = engine.generate(prompts, new)
        launches = self.counts()
        want = self.want(per_layer, cfg.n_layers)
        t = engine.timings
        steps = new - 1
        shape_ok = (tuple(toks.shape) == (B, new) and int(toks.min()) >= 0
                    and int(toks.max()) < cfg.vocab_size)
        log(phase, arch=cfg.name, linear=spec, dtype=cfg.compute_dtype,
            batch=B, prompt=S, new=new, prefill_s=f"{t['prefill_s']:.4f}",
            decode_s=f"{t['decode_s']:.4f}",
            decode_tok_s=f"{B * steps / t['decode_s']:.1f}",
            tok_s=f"{B * new / (t['prefill_s'] + t['decode_s']):.1f}",
            launches=json.dumps(launches, separators=(",", ":")),
            tokens_ok=shape_ok)
        if launches != want or not shape_ok:
            log(phase, failed=f"launches {launches} want {want}")
            return None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.generate(prompts, new)
        _log_profile(prof, (t["prefill_s"] + t["decode_s"]) * 1e3,
                     prof_phase)
        if arch == "opt125m" and not self.serve_parity(
                arch, spec, params=params, prompts=prompts):
            return None
        del engine, params
        torch.cuda.empty_cache()
        return launches

    def serve_parity(self, arch, spec, params=None, prompts=None, **over):
        """Prefill logits and greedy tokens on the card against the CPU
        port, at PARITY's batch, on the same weights."""
        from repro_torch import configs
        from repro_torch.models import model
        from repro_torch.serve.engine import Engine

        torch, dev, cpu = self.torch, self.dev, self.cpu
        pb, ps, pn = PARITY["B"], PARITY["S"], PARITY["new"]
        cfg = configs.get(arch, linear=configs.linear_cfg(spec), **over)
        if params is None:
            pgen = torch.Generator(device=dev).manual_seed(self.seed)
            params = model.init_params(cfg, pgen, dev)
            prompts = torch.randint(0, cfg.vocab_size, (pb, ps),
                                    generator=pgen, device=dev)
        params_cpu = _tree_to(params, cpu)
        pprompts = prompts[:pb, :ps]
        with torch.no_grad():
            gl, _ = model.prefill(cfg, params, model.init_cache(
                cfg, pb, ps + pn, torch.float32, dev), pprompts,
                last_only=False)
            cl, _ = model.prefill(cfg, params_cpu, model.init_cache(
                cfg, pb, ps + pn, torch.float32, cpu), pprompts.cpu(),
                last_only=False)
        finite = bool(torch.isfinite(gl).all())
        ok, err, bound = _close(gl.cpu(), cl, LOGIT_TOL)
        gt = Engine(cfg, params, max_len=ps + pn, device=dev).generate(
            pprompts, pn).cpu()
        ct = Engine(cfg, params_cpu, max_len=ps + pn, device=cpu).generate(
            pprompts.cpu(), pn)
        same = bool((gt == ct).all())
        margin = None
        if not same:
            step = int((gt != ct).any(dim=0).nonzero()[0])
            margin = _top2_margin(model, cfg, params_cpu, pprompts.cpu(), ct,
                                  step, ps + pn)
        tie_ok = same or (margin is not None and margin < bound)
        log("parity", arch=cfg.name, linear=spec, dtype=cfg.compute_dtype,
            layers=cfg.n_layers, batch=pb, prompt=ps, new=pn,
            logits_max_abs_err=f"{err:.3e}", tol=f"{bound:.3e}",
            finite=finite, tokens_equal=same, top2_margin=margin,
            ok=ok and finite and tie_ok)
        return ok and finite and tie_ok

    def train(self, arch, spec, per_layer, phase, compare=True):
        """The train launcher's trainer at full width, B x S of TRAIN: 2
        warm-up steps, one counted step, 5 timed; with ``compare``, the
        same with dense and one profiled step.  Returns the launch counts
        of the counted step, None on a failure."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch import configs
        from repro_torch.launch.train import build_trainer

        torch = self.torch
        n_layers = configs.get(arch).n_layers
        step_s, launches = {}, None
        for lin in (spec, "dense") if compare else (spec,):
            tcfg, trainer = build_trainer(
                arch, linear=lin, steps=100, seq_len=TRAIN["S"],
                batch=TRAIN["B"], seed=self.seed, device=self.dev,
                log_fn=lambda *a: None)
            losses = []

            def traced(state, batch, inner=trainer.train_step):
                state, m = inner(state, batch)
                losses.append(m["loss"])
                return state, m

            trainer.train_step = traced
            w0, nt = TRAIN["warmup"], TRAIN["timed"]
            trainer.run(w0)
            self.zero_counts()
            trainer.run(w0 + 1)                 # one step, counted
            got = self.counts()
            t_loop = time.perf_counter()
            trainer.run(w0 + 1 + nt)
            loop_s = (time.perf_counter() - t_loop) / nt
            times = trainer.metrics.histogram("step_time_s").samples[-nt:]
            data_s = statistics.median(
                trainer.metrics.histogram("data_time_s").samples[-nt:])
            step_s[lin] = statistics.median(times)
            loss_vals = [float(v) for v in losses]
            finite = all(math.isfinite(v) for v in loss_vals)
            # dense: the flash kernels only, once per layer forward (twice
            # under remat) and once backward
            want = self.want(per_layer if lin == spec else {
                "flash_prefill": per_layer["flash_prefill"],
                "flash_prefill_grads": 1}, n_layers)
            tokens = TRAIN["B"] * TRAIN["S"]
            log(phase, arch=tcfg.name, linear=lin, batch=TRAIN["B"],
                seq=TRAIN["S"], dtype=tcfg.compute_dtype, remat=tcfg.remat,
                step_ms_median=f"{step_s[lin] * 1e3:.3f}",
                step_ms_all=",".join(f"{t * 1e3:.3f}" for t in times),
                tok_s=f"{tokens / step_s[lin]:.1f}",
                data_ms_median=f"{data_s * 1e3:.3f}",
                loop_ms_per_step=f"{loop_s * 1e3:.3f}",
                loop_tok_s=f"{tokens / loop_s:.1f}",
                peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
                losses=",".join(f"{v:.4f}" for v in loss_vals),
                launches_per_step=json.dumps(got, separators=(",", ":")),
                finite=finite)
            if got != want or not finite:
                log(phase, failed=f"launches {got} want {want}, "
                    f"finite {finite}")
                return None
            if lin == spec:
                launches = got
            if lin == spec and compare:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    trainer.run(trainer.step + 1)
                _log_profile(prof, step_s[lin] * 1e3, phase + "_profile")
            del trainer, losses
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        if compare:
            log(phase, dyad_over_dense_step_time=
                f"{step_s[spec] / step_s['dense']:.3f}",
                note="printed, not claimed")
        return launches

    def _step_inputs(self, arch, spec, B, S, **over):
        from repro_torch import configs
        from repro_torch.data import SyntheticLM
        from repro_torch.models import model

        pcfg = configs.get(arch, linear=configs.linear_cfg(spec), **over)
        p_dev = model.init_params(
            pcfg, self.torch.Generator(device=self.dev).manual_seed(
                self.seed), self.dev)
        batch = SyntheticLM(pcfg.vocab_size, S, B, seed=self.seed,
                            device=str(self.dev)).batch(0)
        return pcfg, p_dev, batch

    def train_parity(self, arch, spec, B, S, tol=(LOSS_TOL, GRAD_TOL),
                     fp32_control=False, **over):
        """One train step's loss and grads on the card against the CPU
        port on the same params and batch, and on the card the kernel
        backward against the forced plain backward.  With
        ``fp32_control``, also prints (not gated) the card's step against
        the CPU's step in fp32 compute.  Returns the launch counts of the
        card's step (a true dict), or {} on a failure."""
        from repro_torch import configs
        from repro_torch.train.step import loss_and_grads

        pcfg, p_dev, batch = self._step_inputs(arch, spec, B, S, **over)
        p_cpu = _tree_to(p_dev, self.cpu)
        self.zero_counts()
        m_dev, g_dev = loss_and_grads(pcfg, p_dev, batch)
        launches = self.counts()
        m_cpu, g_cpu = loss_and_grads(pcfg, p_cpu, _tree_to(batch, self.cpu))
        os.environ["REPRO_KERNEL_BWD"] = "xla"
        try:
            _, g_plain = loss_and_grads(pcfg, p_dev, batch)
        finally:
            del os.environ["REPRO_KERNEL_BWD"]
        lg, lc = float(m_dev["loss"]), float(m_cpu["loss"])
        loss_err = abs(lg - lc) / abs(lc)
        cpu_err = _rel_err(g_dev, g_cpu)
        plain_err = _rel_err(g_dev, g_plain)
        finite = _finite(g_dev)
        loss_tol, grad_tol = tol
        ok = (loss_err <= loss_tol and cpu_err <= grad_tol
              and plain_err <= grad_tol and finite)
        control = {}
        if fp32_control:
            fcfg = configs.get(arch, linear=configs.linear_cfg(spec),
                               **{**over, "compute_dtype": "float32"})
            m_f, g_f = loss_and_grads(fcfg, p_cpu, _tree_to(batch, self.cpu))
            lf = float(m_f["loss"])
            control = {"control_loss_rel_err_vs_fp32_cpu":
                       f"{abs(lg - lf) / abs(lf):.3e}",
                       "control_grad_rel_err_vs_fp32_cpu":
                       f"{_rel_err(g_dev, g_f):.3e}"}
        log("train_parity", arch=pcfg.name, linear=spec,
            dtype=pcfg.compute_dtype, layers=pcfg.n_layers, batch=B, seq=S,
            loss_card=f"{lg:.6f}", loss_cpu=f"{lc:.6f}",
            loss_rel_err=f"{loss_err:.3e}",
            grad_rel_err_vs_cpu=f"{cpu_err:.3e}",
            grad_rel_err_kernel_vs_plain_bwd=f"{plain_err:.3e}",
            tol=f"{loss_tol:.0e}/{grad_tol:.0e}", finite=finite,
            launches=json.dumps({k: v for k, v in launches.items() if v},
                                separators=(",", ":")), **control, ok=ok)
        return launches if ok else {}

    def split_vs_fused(self, B, S, **over):
        """The ``split`` ff route (dyad_mm_blocks, the activation in
        torch, dyad_mm_blocks_two) against ``fused`` on the card: loss and
        grads of one Qwen3 step."""
        from repro_torch.train.step import loss_and_grads

        pcfg, p_dev, batch = self._step_inputs("qwen3_0_6b", QWEN_FF, B, S,
                                               **over)
        m_f, g_f = loss_and_grads(pcfg, p_dev, batch)
        os.environ["REPRO_KERNEL_FF"] = "split"
        try:
            self.zero_counts()
            m_s, g_s = loss_and_grads(pcfg, p_dev, batch)
            launches = self.counts()
        finally:
            del os.environ["REPRO_KERNEL_FF"]
        loss_err = abs(float(m_s["loss"]) - float(m_f["loss"])) / abs(
            float(m_f["loss"]))
        grad_err = _rel_err(g_s, g_f)
        n = pcfg.n_layers
        # forward (twice under remat): two dyad_mm_blocks and one
        # dyad_mm_blocks_two per layer; the backward's remat adds two more
        routed = (launches["dyad_ff_fused"] == 0
                  and launches["dyad_mm_blocks_two"] == 2 * n)
        ok = (loss_err <= LOSS_TOL and grad_err <= GRAD_TOL and routed
              and _finite(g_s))
        log("split_vs_fused", arch=pcfg.name, layers=n, batch=B, seq=S,
            loss_rel_err=f"{loss_err:.3e}", grad_rel_err=f"{grad_err:.3e}",
            tol=f"{LOSS_TOL:.0e}/{GRAD_TOL:.0e}",
            launches=json.dumps({k: v for k, v in launches.items() if v},
                                separators=(",", ":")), ok=ok)
        return ok


def _rel_err(got, want):
    """Largest |got - want| of any leaf over max(|want leaf|, 1e-3)."""
    from repro_torch import tree

    return max(float((a.cpu().float() - b.cpu().float()).abs().max())
               / max(float(b.float().abs().max()), 1e-3)
               for a, b in zip(tree.leaves(got), tree.leaves(want)))


def _finite(grads):
    from repro_torch import tree

    return all(bool(g.isfinite().all()) for g in tree.leaves(grads))


def _log_profile(prof, wall_ms: float, phase: str, top_n: int = 10) -> None:
    """Device-busy time of a profiled run against the unprofiled wall time
    of the same work, and the kernels that took the most device time."""
    per_kernel = {}
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0:
            per_kernel[ev.key] = (us / 1e3, ev.count)
    busy_ms = sum(ms for ms, _ in per_kernel.values())
    if busy_ms <= 0:
        log(phase, device_busy_ms="not measured (no device events)")
        return
    # the copy kernels, among them the casts of the fp32 params to the
    # compute dtype in every call
    copies = [(ms, cnt) for name, (ms, cnt) in per_kernel.items()
              if "copy" in name.lower()]
    log(phase, device_busy_ms=f"{busy_ms:.3f}",
        unprofiled_wall_ms=f"{wall_ms:.3f}",
        device_busy_share=f"{busy_ms / wall_ms:.3f}",
        device_kernel_launches=sum(c for _, c in per_kernel.values()),
        copy_kernel_launches=sum(c for _, c in copies),
        copy_kernel_ms=f"{sum(ms for ms, _ in copies):.3f}")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top_n]
    for name, (ms, cnt) in top:
        log(phase, kernel=repr(name[:70]), ms=f"{ms:.3f}", calls=cnt,
            share_of_busy=f"{ms / busy_ms:.3f}")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _top2_margin(model, cfg, params, prompts, toks, step: int,
                 max_len: int) -> float:
    """Gap between the two largest CPU logits at generation step ``step``,
    teacher-forced on the CPU's own tokens: a gap under the logit
    tolerance makes a differing greedy token a tie, not a fault."""
    import torch

    with torch.no_grad():
        cache = model.init_cache(cfg, prompts.shape[0], max_len,
                                 torch.float32, torch.device("cpu"))
        logits, cache = model.prefill(cfg, params, cache, prompts)
        for i in range(step):
            logits, cache = model.decode_step(cfg, params, cache,
                                              toks[:, i:i + 1])
        top2 = logits[:, -1].topk(2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


if __name__ == "__main__":
    sys.exit(main())
