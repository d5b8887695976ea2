#!/usr/bin/env python3
"""One side of an A/B of one tree's port: one measurement set a process.

Run from the repository root, once per tree and in turns (parent, change,
change, parent, ...), each run in a process of its own:

    python3 tools/ab_port.py --set fp32 --src build/parent/src --label parent
    python3 tools/ab_port.py --set fp32 --src src --label change

``--src`` names the ``src`` directory of the tree whose port is measured
(its kernels build into that tree's ``build/``); the measuring code is
this checkout's ``chip_smoke.py``, so both sides run the same driver on
the same inputs, drawn from ``--seed``.  Each run prints one JSON line per
measurement, its first key the label.  The sets:

``decode`` (one CUDA card): the ring decode on the serving paths.

* ``host``: the host's microseconds per ``flash_decode`` call at Qwen3-0.6B's
  batch step (B 8, L 160, K 8, G 2, h 128, bf16 q over an fp32 cache, idx
  143) and at its dense-ring step (8 x 512, an int32 (B,) idx of 511): the
  median over 30 bursts of 100 calls of the time to queue them, and of the
  time to finish them (synchronised); beside them the same for one
  ``Tensor.add_`` on 8 floats, which gauges how fast this process's host
  runs;
* ``generate``: ``Engine.generate`` for Qwen3-0.6B (``dyad_it_4_kernel_
  ffused``, batch 8, prompt 128, 32 new tokens, random weights from
  ``--seed``), a warm-up, then ``--generates`` timed runs: decode tok/s,
  prefill and decode seconds of each;
* ``dense``: the continuous engine's trace of ``chip_smoke.py`` phase 12 on
  dense rings (``REPRO_PAGED_KV=off``), after a short warm-up: decode step
  p50, decode tok/s, the run's wall and the wall of engine steps 60-89.

``fp32`` (one CUDA card): the fp32 kernels on the OPT-125m path.

* ``kernel``: ms of ``flash_prefill`` (fp32) at OPT-125m's training shape
  (B 8, S 512, 12 heads of 64, causal, with lse; ``flash_prefill@train``),
  at its serving prefill (B 8, a 128-token prompt over the 160-slot cache;
  ``flash_prefill``) and at Qwen3-0.6B's serving prefill over its fp32
  cache (bf16 q, K 8 x G 2, h 128; ``flash_prefill@qwen3_fp32_cache``);
  ms of ``dyad_mm_blocks`` (fp32, IT) for one OPT-125m layer's up + down
  at M 1024 and at M 8, and at the training rows, M 4096
  (``dyad_mm_blocks@train``); ms of ``flash_prefill_grads`` (fp32) at
  OPT-125m's training shape (its o and lse from ``flash_prefill``), of
  ``dyad_mm_dgrad_two`` (fp32, the IT cotangent view) for one layer's up +
  down dx at M 4096, of ``dyad_mm_wgrad`` (fp32, the IT views) for its up +
  down weight cotangents (``dyad_mm_wgrad@train``) and of ``dyad_mm_dgrad``
  (fp32, the OT cotangent views, z2 the stride-n z2bar) for its OT up +
  down dx (``dyad_mm_dgrad@opt_ot``); ms of ``dyad_mm_blocks_two`` (fp32)
  for its OT forward, up + down at M 4096 (x2 = x1;
  ``dyad_mm_blocks_two``) and its DT forward (the stride-n x2;
  ``dyad_mm_blocks_two@opt_dt``); ms of ``dyad_mm_blocks_q`` (fp32 x over
  int8 payloads, the IT views: the quantized OPT-125m generate) for one
  layer's up + down at M 1024 and at M 8 (``dyad_mm_blocks_q@M8``);
  ``chip_smoke.timer`` (CUDA events, the L2 flushed before each run,
  median of 25);
* ``step``: the OPT-125m train step (fp32, B 8 x S 512 of ``SyntheticLM``)
  with ``dyad_it_4_kernel``, ``dyad_ot_4_kernel``, ``dyad_dt_4_kernel``
  and ``dense``: 2 warm-up steps, then ``--steps`` timed, the median and
  every step in ms.

``hot`` (one CUDA card): the two paths the tracer and the fault sites
touch, with both off, as a user runs them.

* ``step``: the OPT-125m train step (fp32, ``dyad_it_4_kernel``, B 8 x
  S 512 of ``SyntheticLM``): 2 warm-up steps, then ``--steps`` timed, the
  median and every step in ms;
* ``generate``: ``Engine.generate`` for Qwen3-0.6B as in ``decode``: decode
  tok/s of each of ``--generates`` timed runs and their median.

``relu_ties`` (the CPU alone): the ReLU units that ``chip_smoke.py``
phase 8's OPT-125m step (2 layers, ``dyad_it_4_kernel``, B 2 x S 256, on
the card's attention route) puts on either side of zero when
``dyad_mm_blocks`` is summed in float64 and rounded once, against the
port's fp32 sums, and the grads' largest error as phase 8 measures it, as
they are and with the fp32 step taken on the float64 sums' branch of each
such unit.

It imports nothing of JAX.
"""
import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _emit(label: str, kind: str, **kw) -> None:
    print(json.dumps({"label": label, "kind": kind, **kw}), flush=True)


def _host_us(torch, fn, calls: int = 100, bursts: int = 30):
    """(queue, finish) microseconds per call of ``fn``: medians over
    ``bursts`` bursts of ``calls`` calls, each burst from an idle card."""
    queue, finish = [], []
    for _ in range(bursts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        queue.append((t1 - t0) / calls * 1e6)
        finish.append((t2 - t0) / calls * 1e6)
    return statistics.median(queue), statistics.median(finish)


def _decode(torch, cs, args) -> None:
    from repro_torch.kernels import dyad_mm, flash_attn

    dev = torch.device("cuda")
    label = args.label
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    small = torch.zeros(8, device=dev)
    host = {"add_": _host_us(torch, lambda: small.add_(1.0))}
    for name, L, idx in (("qwen3_batch", 160, 143),
                         ("ring512", 512, torch.full((8,), 511,
                                                     dtype=torch.int32,
                                                     device=dev))):
        q = randn(8, 1, 8, 2, 128, dtype=bf16)
        k, v = randn(8, L, 8, 128, dtype=f32), randn(8, L, 8, 128, dtype=f32)
        host[name] = _host_us(torch, lambda: flash_attn.flash_decode(
            q, k, v, idx))
    _emit(label, "host", **{f"{k}_queue_us": round(v[0], 3)
                            for k, v in host.items()},
          **{f"{k}_finish_us": round(v[1], 3) for k, v in host.items()})

    _generate(torch, cs, args)

    run = cs._Run(torch, dev, args.seed, cs._wrappers(dyad_mm, flash_attn))
    cfg, params, prompts, max_new, kw = run._cont_setup()
    kw = dict(kw, env={"REPRO_PAGED_KV": "off"})
    run._serve_trace(cfg, params, prompts[:2], [4, 4], **kw)  # warm-up
    r = run._serve_trace(cfg, params, prompts, max_new,
                         window=cs.CONT["profile_steps"], **kw)
    h = r["summary"]["histograms"]
    n_tok = sum(len(t) for t in r["tokens"])
    _emit(label, "dense", paged=r["paged"],
          decode_step_ms_p50=round(1e3 * h["decode_step_s"]["p50"], 3),
          decode_tok_s=round((n_tok - len(r["tokens"])) / r["decode_s"], 2),
          wall_s=round(r["wall_s"], 3),
          window_ms=round(1e3 * r["window_s"], 3),
          steps=r["steps"], flash_decode=r["launches"]["flash_decode"])


def _fp32(torch, cs, args) -> None:
    from repro_torch.kernels import dyad_mm, flash_attn

    dev = torch.device("cuda")
    label = args.label
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    time_ms = cs.timer(torch, torch.empty(64 << 20, dtype=torch.uint8,
                                          device=dev))
    B, S, K, h = 8, 512, 12, 64
    q, k, v = randn(B, S, K, 1, h), randn(B, S, K, h), randn(B, S, K, h)
    out = {"flash_prefill@train": time_ms(
        lambda: flash_attn.flash_prefill(q, k, v, save_lse=True))}
    do = randn(B, S, K, 1, h)
    o, lse = flash_attn.flash_prefill(q, k, v, save_lse=True)
    out["flash_prefill_grads"] = time_ms(
        lambda: flash_attn.flash_prefill_grads(q, k, v, o, lse, do))
    S, L = 128, 160
    q, kc, vc = randn(B, S, K, 1, h), randn(B, L, K, h), randn(B, L, K, h)
    out["flash_prefill"] = time_ms(
        lambda: flash_attn.flash_prefill(q, kc, vc, 0, 0))
    K, G, h = 8, 2, 128
    q = randn(B, S, K, G, h, dtype=torch.bfloat16)
    kc, vc = randn(B, L, K, h), randn(B, L, K, h)
    out["flash_prefill@qwen3_fp32_cache"] = time_ms(
        lambda: flash_attn.flash_prefill(q, kc, vc, 0, 0))
    n, d, ff = 4, 768 // 4, 3072 // 4
    for name, M in (("dyad_mm_blocks", 1024), ("dyad_mm_blocks@M8", 8),
                    ("dyad_mm_blocks@train", 4096)):
        total = 0.0
        for d_in, d_out in ((d, ff), (ff, d)):
            x = randn(M, n * d_in)
            w1, w2 = randn(n, d_out, d_in), randn(n, d_out, d_in)
            total += time_ms(lambda: dyad_mm.dyad_mm_blocks(x, w1, w2, "it"))
        out[name] = total
    total = 0.0
    for d_in, d_out in ((d, ff), (ff, d)):
        z = randn(4096, n, d_out)
        w1, w2 = randn(n, d_out, d_in), randn(n, d_out, d_in)
        total += time_ms(lambda: dyad_mm.dyad_mm_dgrad_two(z, z, w1, w2))
    out["dyad_mm_dgrad_two"] = total
    wgrad = dgrad = 0.0
    for d_in, d_out in ((d, ff), (ff, d)):
        x, g = randn(4096, n * d_in), randn(4096, n * d_out)
        x1, x2 = x.reshape(4096, n, d_in), x.reshape(4096, d_in, n).transpose(
            1, 2)
        z1, z2 = g.reshape(4096, n, d_out), g.reshape(4096, d_out,
                                                      n).transpose(1, 2)
        w1, w2 = randn(n, d_out, d_in), randn(n, d_out, d_in)
        wgrad += time_ms(lambda: dyad_mm.dyad_mm_wgrad(x1, x2, z1, z1))
        dgrad += time_ms(lambda: dyad_mm.dyad_mm_dgrad(z1, z2, w1, w2))
    out["dyad_mm_wgrad@train"] = wgrad
    out["dyad_mm_dgrad@opt_ot"] = dgrad
    for name, view in (("dyad_mm_blocks_two", "ot"),
                       ("dyad_mm_blocks_two@opt_dt", "dt")):
        total = 0.0
        for d_in, d_out in ((d, ff), (ff, d)):
            x = randn(4096, n * d_in)
            x1 = x.reshape(4096, n, d_in)
            x2 = x1 if view == "ot" else x.reshape(4096, d_in, n).transpose(
                1, 2)
            w1, w2 = randn(n, d_out, d_in), randn(n, d_out, d_in)
            total += time_ms(lambda: dyad_mm.dyad_mm_blocks_two(x1, x2, w1,
                                                                w2))
        out[name] = total
    for name, M in (("dyad_mm_blocks_q", 1024), ("dyad_mm_blocks_q@M8", 8)):
        total = 0.0
        for d_in, d_out in ((d, ff), (ff, d)):
            x = randn(M, n * d_in)
            x1, x2 = x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(
                1, 2)
            (q1, s1), (q2, s2) = (cs._qweight(randn, (n, d_out, d_in), "int8")
                                  for _ in range(2))
            total += time_ms(lambda: dyad_mm.dyad_mm_blocks_q(
                x1, x2, q1, q2, s1, s2))
        out[name] = total
    _emit(label, "kernel", **{k: round(v, 4) for k, v in out.items()},
          device=torch.cuda.get_device_name(0))

    for lin in ("dyad_it_4_kernel", "dyad_ot_4_kernel", "dyad_dt_4_kernel",
                "dense"):
        _train_steps(torch, args, lin)


def _train_steps(torch, args, lin: str) -> None:
    """The OPT-125m train step with ``lin``: 2 warm-up steps, then
    ``--steps`` timed; one JSON line."""
    from repro_torch.launch.train import build_trainer

    _, trainer = build_trainer(
        "opt125m", linear=lin, steps=100, seq_len=512, batch=8,
        seed=args.seed, device=torch.device("cuda"), log_fn=lambda *a: None)
    trainer.run(2)
    trainer.run(2 + args.steps)
    times = trainer.metrics.histogram("step_time_s").samples[-args.steps:]
    _emit(args.label, "step", linear=lin,
          step_ms_median=round(statistics.median(times) * 1e3, 3),
          step_ms_all=[round(t * 1e3, 3) for t in times])
    del trainer
    torch.cuda.empty_cache()


def _generate(torch, cs, args) -> None:
    """Qwen3-0.6B's batch generate: a warm-up, then ``--generates`` timed
    runs; one JSON line."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attn
    from repro_torch.models import model
    from repro_torch.serve.engine import Engine

    dev = torch.device("cuda")
    cfg = configs.get("qwen3_0_6b", linear=configs.linear_cfg(cs.QWEN_FF))
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    B, S, new = 8, 128, 32
    prompts = torch.randint(0, cfg.vocab_size, (B, S),
                            generator=torch.Generator(device=dev)
                            .manual_seed(args.seed), device=dev)
    engine = Engine(cfg, params, max_len=S + new, device=dev)
    engine.generate(prompts, new)                             # warm-up
    runs = []
    for _ in range(args.generates):
        flash_attn.flash_decode.launches = 0
        engine.generate(prompts, new)
        t = engine.timings
        runs.append({"decode_tok_s": round(B * (new - 1) / t["decode_s"], 2),
                     "prefill_s": round(t["prefill_s"], 4),
                     "decode_s": round(t["decode_s"], 4),
                     "flash_decode": flash_attn.flash_decode.launches})
    _emit(args.label, "generate", runs=runs,
          decode_tok_s_median=statistics.median(r["decode_tok_s"]
                                                for r in runs))
    del engine, params
    torch.cuda.empty_cache()


def _hot(torch, cs, args) -> None:
    _train_steps(torch, args, "dyad_it_4_kernel")
    _generate(torch, cs, args)


def _relu_ties(torch, cs, args) -> None:
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import dyad_mm, ops
    from repro_torch.models import model
    from repro_torch.train.step import loss_and_grads

    tp = cs.TRAIN_PARITY
    cfg = configs.get("opt125m", linear=configs.linear_cfg("dyad_it_4_kernel"),
                      n_layers=tp["layers"])
    cpu = torch.device("cpu")
    params = model.init_params(cfg, torch.Generator().manual_seed(args.seed),
                               cpu)
    batch = SyntheticLM(cfg.vocab_size, tp["S"], tp["B"], seed=args.seed,
                        device="cpu").batch(0)

    def exact(x, w1, w2, variant="it"):
        return dyad_mm.dyad_mm_blocks_plain(
            x.double(), w1.double(), w2.double(), variant).float()

    u_exact, u_fp32 = [], []
    fp32 = ops.dyad_mm_blocks
    ops.dyad_mm_blocks = exact
    try:
        with cs.relu_branch(record=u_exact):
            _, g_exact = loss_and_grads(cfg, params, batch)
    finally:
        ops.dyad_mm_blocks = fp32
    with cs.relu_branch(record=u_fp32):
        _, g_fp32 = loss_and_grads(cfg, params, batch)
    ties = cs.relu_ties(u_exact, u_fp32)
    with cs.relu_branch(masks=ties["masks"]):
        _, g_branch = loss_and_grads(cfg, params, batch)
    _emit(args.label, "relu_ties",
          relu_sign_differences=ties["differences"],
          all_ties=ties["all_ties"], units=ties["units"],
          grad_rel_err=cs.rel_err(g_exact, g_fp32),
          grad_rel_err_on_branch=cs.rel_err(g_exact, g_branch),
          grad_tol=cs.GRAD_TOL)


SETS = {"decode": _decode, "fp32": _fp32, "hot": _hot,
        "relu_ties": _relu_ties}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--set", required=True, choices=sorted(SETS),
                    help="the measurement set (see the module's docstring)")
    ap.add_argument("--src", required=True,
                    help="the src directory of the tree to measure")
    ap.add_argument("--label", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--generates", type=int, default=3,
                    help="decode, hot: timed generates")
    ap.add_argument("--steps", type=int, default=5,
                    help="fp32, hot: timed train steps of each linear")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    if args.set == "relu_ties":
        os.environ["REPRO_KERNEL_ATTN"] = "flash"

    import torch

    if args.set != "relu_ties" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import flash_attn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _emit(args.label, "tree", set=args.set,
          src=str(Path(args.src).resolve()), port=flash_attn.__file__)
    SETS[args.set](torch, cs, args)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONHASHSEED", "0")
    sys.exit(main())
