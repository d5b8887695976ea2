#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: build, check, time, serve, train.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--seed N]

Phases, one line each (a phase that fails ends the run with a non-zero
exit and no result line):

1. the device: name and power limit (``nvidia-smi``);
2. the build of every kernel in ``src/repro_torch/kernels/csrc``;
3. each kernel against its plain PyTorch version on the card, fp32 and
   bf16, at the OPT-125m serving and training shapes and the edge cases;
4. the time of each kernel, its plain version and a library yardstick
   (CUDA events around device work queued ahead, L2 flushed before each
   run, median of 25 after warm-up);
5. the serving path: OPT-125m at full width with ``dyad_it_4_kernel``,
   random weights from ``--seed``, ``Engine.generate`` at batch 8, prompt
   128, 32 new tokens, with the kernels' launch counters read around it;
5b. a ``torch.profiler`` trace of one more generate: device-busy share
   and the kernels that take the most device time;
6. the serving path on the card against the same port on the CPU;
7. the training path: OPT-125m at full width, fp32, through the train
   launcher's ``build_trainer`` (``make_train_step`` and ``Trainer``), B 8
   x S 512 of ``SyntheticLM``; 2 warm-up steps, one step with the launch
   counters read around it, then 5 timed steps: the step (``step_time_s``),
   the host's batch (``data_time_s``) and the loop's wall time per step;
   the same with ``--linear dense`` (the paper's comparison, printed, not
   claimed);
7b. a ``torch.profiler`` trace of one DYAD train step;
8. one train step of OPT-125m and Pythia-160m at full width and 2 layers
   on the card against the CPU port on the same params and batch, and on
   the card the kernel backward against the forced plain backward;
9. the ``kernels`` JSON line, then the result line.

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

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and the
# fp32 (non-tensor-core) FLOP/s the FMA kernels of this slice run at
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12

TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # x max(|plain|, 1)
LOGIT_TOL = 1e-4                             # x max(|cpu logits|, 1)
# card vs CPU train step, fp32 both: loss relative; each grad leaf against
# max(|cpu leaf|, 1e-3) (sums over 512 tokens and the 50k vocabulary run
# in other orders on the two devices)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4

SMOKE = {"B": 8, "S": 128, "new": 32}        # the serving path's batch
PARITY = {"B": 2, "S": 32, "new": 8}         # the card vs CPU comparison
TRAIN = {"B": 8, "S": 512, "warmup": 2, "timed": 5}   # the training path
TRAIN_PARITY = {"B": 2, "S": 256, "layers": 2}


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
    from repro_torch import configs
    from repro_torch.kernels import build, dyad_mm, flash_attn
    from repro_torch.models import model
    from repro_torch.serve.engine import Engine

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
               "dyad_mm_wgrad": 0.0, "flash_prefill_grads": 0.0}
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

    def record(name, ms, plain_ms, lib_ms, nbytes, flops, shape):
        bound, by = _bound_ms(nbytes, flops, FP32_FLOPS)
        t = timing.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                     "library_ms": 0.0, "bound_ms": 0.0,
                                     "bytes": 0.0, "flops": 0.0,
                                     "shape": []})
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", bound),
                         ("bytes", nbytes), ("flops", flops)):
            t[key] += val
        t["shape"].append(shape)
        log("time", kernel=name, shape=shape, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=by)

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
    del flush, sout

    # -- 5. the main path ----------------------------------------------------
    cfg = configs.get("opt125m",
                      linear=configs.linear_cfg("dyad_it_4_kernel"))
    pgen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init_params(cfg, pgen, dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=pgen,
                            device=dev)
    engine = Engine(cfg, params, max_len=L, device=dev)
    engine.generate(prompts, new)                     # warm-up
    wrappers = {"dyad_mm_blocks": dyad_mm.dyad_mm_blocks,
                "flash_prefill": flash_attn.flash_prefill,
                "flash_decode": flash_attn.flash_decode,
                "dyad_mm_dgrad_two": dyad_mm.dyad_mm_dgrad_two,
                "dyad_mm_wgrad": dyad_mm.dyad_mm_wgrad,
                "flash_prefill_grads": flash_attn.flash_prefill_grads}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    zero_counts()
    toks = engine.generate(prompts, new)
    launches = counts()
    steps = new - 1
    want = dict.fromkeys(wrappers, 0)
    want.update({"dyad_mm_blocks": 2 * cfg.n_layers * (1 + steps),
                 "flash_prefill": cfg.n_layers,
                 "flash_decode": cfg.n_layers * steps})
    t = engine.timings
    shape_ok = (tuple(toks.shape) == (B, new)
                and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size)
    log("main", arch=cfg.name, linear="dyad_it_4_kernel", batch=B,
        prompt=S, new=new, prefill_s=f"{t['prefill_s']:.4f}",
        decode_s=f"{t['decode_s']:.4f}",
        decode_tok_s=f"{B * steps / t['decode_s']:.1f}",
        tok_s=f"{B * new / (t['prefill_s'] + t['decode_s']):.1f}",
        launches=json.dumps(launches, separators=(",", ":")),
        tokens_ok=shape_ok)
    if launches != want or not shape_ok:
        log("main", failed=f"launches {launches} want {want}")
        return 1

    # -- 5b. where the main path's time goes (torch.profiler, one generate) --
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.generate(prompts, new)
    _log_profile(prof, (t["prefill_s"] + t["decode_s"]) * 1e3, "profile")

    # -- 6. the main path on the card against the port on the CPU ------------
    pb, ps, pn = PARITY["B"], PARITY["S"], PARITY["new"]
    cpu = torch.device("cpu")
    params_cpu = _tree_to(params, cpu)
    pprompts = prompts[:pb, :ps]
    with torch.no_grad():
        gl, _ = model.prefill(cfg, params, model.init_cache(
            cfg, pb, ps + pn, torch.float32, dev), pprompts, last_only=False)
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
    log("parity", batch=pb, prompt=ps, new=pn, logits_max_abs_err=f"{err:.3e}",
        tol=f"{bound:.3e}", finite=finite, tokens_equal=same,
        top2_margin=margin, ok=ok and finite and tie_ok)
    if not (ok and finite and tie_ok):
        return 1

    serve_launches = launches
    del engine, params, params_cpu
    torch.cuda.empty_cache()

    # -- 7. the training path ------------------------------------------------
    from repro_torch.launch.train import build_trainer

    n_layers = configs.get("opt125m").n_layers
    want_train = dict.fromkeys(wrappers, 0)
    want_train.update({"flash_prefill": n_layers,
                       "flash_prefill_grads": n_layers})
    train_launches, step_s = {}, {}
    for spec in ("dyad_it_4_kernel", "dense"):
        tcfg, trainer = build_trainer(
            "opt125m", linear=spec, steps=100, seq_len=TRAIN["S"],
            batch=TRAIN["B"], seed=args.seed, device=dev,
            log_fn=lambda *a: None)
        losses = []

        def traced(state, batch, inner=trainer.train_step):
            state, m = inner(state, batch)
            losses.append(m["loss"])
            return state, m

        trainer.train_step = traced
        w0, nt = TRAIN["warmup"], TRAIN["timed"]
        trainer.run(w0)
        zero_counts()
        trainer.run(w0 + 1)                 # one step, counted
        got = counts()
        t_loop = time.perf_counter()
        trainer.run(w0 + 1 + nt)
        loop_s = (time.perf_counter() - t_loop) / nt
        times = trainer.metrics.histogram("step_time_s").samples[-nt:]
        data_s = statistics.median(
            trainer.metrics.histogram("data_time_s").samples[-nt:])
        step_s[spec] = statistics.median(times)
        loss_vals = [float(v) for v in losses]
        finite = all(math.isfinite(v) for v in loss_vals)
        want = dict(want_train)
        if spec != "dense":
            want.update({"dyad_mm_blocks": 2 * n_layers,
                         "dyad_mm_dgrad_two": 2 * n_layers,
                         "dyad_mm_wgrad": 2 * n_layers})
            train_launches = got
        tokens = TRAIN["B"] * TRAIN["S"]
        log("train", arch=tcfg.name, linear=spec, batch=TRAIN["B"],
            seq=TRAIN["S"], dtype="float32",
            step_ms_median=f"{step_s[spec] * 1e3:.3f}",
            step_ms_all=",".join(f"{t * 1e3:.3f}" for t in times),
            tok_s=f"{tokens / step_s[spec]:.1f}",
            data_ms_median=f"{data_s * 1e3:.3f}",
            loop_ms_per_step=f"{loop_s * 1e3:.3f}",
            loop_tok_s=f"{tokens / loop_s:.1f}",
            losses=",".join(f"{v:.4f}" for v in loss_vals),
            launches_per_step=json.dumps(got, separators=(",", ":")),
            finite=finite)
        if got != want or not finite:
            log("train", failed=f"launches {got} want {want}, "
                f"finite {finite}")
            return 1
        if spec != "dense":
            # -- 7b. where a train step's time goes (torch.profiler) -------
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                trainer.run(trainer.step + 1)
            _log_profile(prof, step_s[spec] * 1e3, "train_profile")
        del trainer, losses
        torch.cuda.empty_cache()
    log("train", dyad_over_dense_step_time=
        f"{step_s['dyad_it_4_kernel'] / step_s['dense']:.3f}",
        note="printed, not claimed")

    # -- 8. a train step on the card against the CPU port --------------------
    from repro_torch import tree
    from repro_torch.data import SyntheticLM
    from repro_torch.train.step import loss_and_grads

    tp = TRAIN_PARITY
    for arch in ("opt125m", "pythia160m"):
        pcfg = configs.get(arch, linear=configs.linear_cfg("dyad_it_4_kernel"),
                           n_layers=tp["layers"])
        p_dev = model.init_params(
            pcfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
        p_cpu = _tree_to(p_dev, cpu)
        batch = SyntheticLM(pcfg.vocab_size, tp["S"], tp["B"], seed=args.seed,
                            device="cuda").batch(0)
        m_dev, g_dev = loss_and_grads(pcfg, p_dev, batch)
        m_cpu, g_cpu = loss_and_grads(pcfg, p_cpu, _tree_to(batch, cpu))
        os.environ["REPRO_KERNEL_BWD"] = "xla"
        try:
            _, g_plain = loss_and_grads(pcfg, p_dev, batch)
        finally:
            del os.environ["REPRO_KERNEL_BWD"]
        lg, lc = float(m_dev["loss"]), float(m_cpu["loss"])
        loss_err = abs(lg - lc) / abs(lc)

        def rel_err(got, want):
            return max(float((a.cpu() - b.cpu()).abs().max())
                       / max(float(b.abs().max()), 1e-3)
                       for a, b in zip(tree.leaves(got), tree.leaves(want)))

        cpu_err, plain_err = rel_err(g_dev, g_cpu), rel_err(g_dev, g_plain)
        finite = all(bool(torch.isfinite(g).all())
                     for g in tree.leaves(g_dev))
        ok = (loss_err <= LOSS_TOL and cpu_err <= GRAD_TOL
              and plain_err <= GRAD_TOL and finite)
        log("train_parity", arch=pcfg.name, layers=tp["layers"],
            batch=tp["B"], seq=tp["S"], loss_card=f"{lg:.6f}",
            loss_cpu=f"{lc:.6f}", loss_rel_err=f"{loss_err:.3e}",
            grad_rel_err_vs_cpu=f"{cpu_err:.3e}",
            grad_rel_err_kernel_vs_plain_bwd=f"{plain_err:.3e}",
            tol=f"{LOSS_TOL:.0e}/{GRAD_TOL:.0e}", finite=finite, ok=ok)
        if not ok:
            return 1

    # -- 9. the kernels line -------------------------------------------------
    csrc = "src/repro_torch/kernels/csrc/"
    files = {"dyad_mm_blocks": ("dyad_mm.cu", "dyad_mm.py:286"),
             "flash_prefill": ("flash_prefill.cu", "flash_attn.py:288"),
             "flash_decode": ("flash_decode.cu", "flash_attn.py:670"),
             "dyad_mm_dgrad_two": ("dyad_dgrad.cu", "dyad_mm.py:472"),
             "dyad_mm_wgrad": ("dyad_wgrad.cu", "dyad_mm.py:560"),
             "flash_prefill_grads": ("flash_bwd.cu", "flash_attn.py:531")}
    # each kernel's launches come from the path that brought it in: the
    # serving path for slice 1's, the training path for the backward
    # kernels; both counts ride along
    line = []
    for name, (src, replaces) in files.items():
        tm = timing[name]
        _, by = _bound_ms(tm["bytes"], tm["flops"], FP32_FLOPS)
        main = (train_launches if name in ("dyad_mm_dgrad_two",
                                           "dyad_mm_wgrad",
                                           "flash_prefill_grads")
                else serve_launches)
        line.append({
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": "src/repro/kernels/" + replaces,
            "launches": main[name], "launches_serve": serve_launches[name],
            "launches_train_step": train_launches[name],
            "max_abs_err": max_err[name], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": by, "library_ms": tm["library_ms"],
            "shape": "+".join(tm["shape"]), "dtype": "float32"})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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
    log(phase, device_busy_ms=f"{busy_ms:.3f}",
        unprofiled_wall_ms=f"{wall_ms:.3f}",
        device_busy_share=f"{busy_ms / wall_ms:.3f}")
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
