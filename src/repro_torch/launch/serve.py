"""Serving launcher: random weights from ``--seed``, then one of two engines.

* ``--engine batch`` (default): :class:`repro_torch.serve.engine.Engine`,
  one prefill of the whole ``(batch, prompt_len)`` prompt batch and a
  decode loop.
* ``--engine continuous``:
  :class:`repro_torch.serve.engine.ContinuousBatchingEngine` takes
  ``--requests`` prompts of mixed lengths into ``--slots`` cache slots;
  finished requests retire at EOS or length and queued ones back-fill the
  freed slots.  ``--page-size`` selects the paged KV cache (with
  ``--n-pages``, ``--prefill-chunk``, ``--prefix-cache`` and ``--quant-kv
  int8``); without it, or under ``REPRO_PAGED_KV=off``, dense per-slot
  rings.

``--quant-weights int8|fp8`` quantizes the DYAD weights after they are
built (``quant.quantize_params`` sidecars) and serves them through the
quantized kernels; it needs a kernel-routed linear spec, and
``REPRO_KERNEL_QUANT=off`` restores the fp routes.  ``--ckpt-dir`` serves
the params of the newest checkpoint there (the train launcher's, or the
reference's) instead of the random ones, restored before any
quantization.

``--trace`` records the engines' spans and exports Chrome-trace JSON at the
end; ``--faults`` (or ``REPRO_FAULT``) arms a seeded fault schedule
(``repro_torch.faults``); ``--metrics-json`` carries the route counts
(``routes``) and the fault tallies (``faults``) beside the metrics.

Runs on CUDA unless ``--device cpu``; without CUDA it exits non-zero.

Example:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt125m \
        --linear dyad_it_4_kernel --batch 8 --prompt-len 128 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b \
        --linear dyad_it_4_kernel_ffused --engine continuous --requests 32 \
        --slots 8 --page-size 16 --prefill-chunk 32 --prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b \
        --linear dyad_it_4_kernel_ffused --engine continuous --page-size 16 \
        --quant-weights int8 --quant-kv int8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt125m \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b \
        --smoke --device cpu --engine continuous --requests 8 --slots 4 \
        --prompt-len 12 --new-tokens 16 --page-size 4 --n-pages 24 \
        --faults "page_exhaustion:p=0.05;nan_logits:at_step=3;slow_step:ms=5" \
        --metrics-json chaos_serve.json --trace serve.json
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch import device as device_lib
from repro_torch import faults, obs, quant
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models import model
from repro_torch.serve.engine import ContinuousBatchingEngine, Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--linear", default=None)
    ap.add_argument("--engine", choices=("batch", "continuous"),
                    default="batch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--requests", type=int, default=12,
                    help="continuous engine: number of submitted requests")
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous engine: cache slots (padded batch)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="continuous engine: retire sequences at this token")
    ap.add_argument("--page-size", type=int, default=None,
                    help="continuous engine: paged KV cache with this many "
                         "tokens per page (default: dense per-slot rings)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="paged mode: physical pages in the pool incl. "
                         "scratch (default: full-capacity slots)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="paged mode: prefill prompts in chunks of this "
                         "many tokens, interleaved with decode steps")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged mode: share full prompt-prefix pages "
                         "between requests (skips re-prefill)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the engines' spans (admission, prefill, "
                         "decode, sync, retire) and export Chrome-trace "
                         "JSON here; diff two runs with python -m "
                         "repro_torch.perf.timeline")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the final serving metrics snapshot (TTFT/"
                         "ITL percentiles, tok/s, queue depth, page-pool "
                         "occupancy, prefix hits) as JSON, with the route "
                         "counts and the fault tallies")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="fault-injection schedule, e.g. 'page_exhaustion:"
                         "p=0.05;nan_logits:at_step=3;slow_step:ms=50' "
                         "(overrides REPRO_FAULT; see repro_torch.faults)")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--report-every", type=float, default=None,
                    metavar="SECONDS",
                    help="continuous engine: periodic one-line stats report")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="continuous engine: per-request wall-clock budget; "
                         "expired requests retire with reason=deadline "
                         "keeping their partial output")
    ap.add_argument("--quant-weights", choices=("int8", "fp8"),
                    default=None,
                    help="quantize the DYAD weights (per-(block, out_row) "
                         "scale sidecars) and serve them through the "
                         "quantized kernels; needs a kernel-routed linear "
                         "spec.  REPRO_KERNEL_QUANT=off restores the fp "
                         "routes")
    ap.add_argument("--quant-kv", choices=("int8",), default=None,
                    help="paged mode: int8 KV page pools with per-token-row "
                         "fp32 scale pools, dequantized in the paged decode "
                         "kernel")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the newest checkpoint here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        dev = device_lib.resolve(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[serve] {e}") from None
    if args.trace:
        obs.enable()
    if args.faults:
        faults.configure(args.faults, seed=args.fault_seed)
    linear = configs.linear_cfg(args.linear) if args.linear else None
    cfg = configs.get(args.arch, smoke=args.smoke, linear=linear)
    if args.quant_weights:
        cfg = cfg.replace(linear=cfg.linear.replace(quant=args.quant_weights))
    if args.quant_kv:
        if args.engine != "continuous" or args.page_size is None:
            raise SystemExit("--quant-kv requires --engine continuous with "
                             "--page-size (the quantized layout is the "
                             "paged pool)")
        cfg = cfg.replace(kv_quant=args.quant_kv)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init_params(cfg, gen, dev)
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if mgr.latest_step() is not None:
            step, state = mgr.restore({"params": params})
            params = state["params"]
            print(f"[serve] restored checkpoint step {step}")
    if args.quant_weights:
        params = quant.quantize_params(params, args.quant_weights)
        print(f"[serve] quantized DYAD weight sidecars: {args.quant_weights}")
    max_len = args.prompt_len + args.new_tokens
    if args.engine == "continuous":
        _continuous(args, cfg, params, gen, dev, max_len)
        return
    engine = Engine(cfg, params, max_len=max_len, device=dev)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            device=dev)
    out = engine.generate(prompts, args.new_tokens,
                          temperature=args.temperature, generator=gen)
    t = engine.timings
    tps = args.batch * args.new_tokens / (t["prefill_s"] + t["decode_s"])
    print(f"[serve] {cfg.name} on {dev}: generated {tuple(out.shape)} in "
          f"prefill {t['prefill_s']:.3f}s + decode {t['decode_s']:.3f}s "
          f"({tps:.1f} tok/s)")
    print(out[:, :16].cpu())
    print(f"[serve] summary: {obs.format_serving_line(engine.metrics)}")
    _finish(args, engine.metrics)


def _continuous(args, cfg, params, gen, dev, max_len):
    engine = ContinuousBatchingEngine(
        cfg, params, n_slots=args.slots, max_len=max_len,
        eos_id=args.eos_id, temperature=args.temperature, seed=args.seed,
        page_size=args.page_size, n_pages=args.n_pages,
        prefill_chunk=args.prefill_chunk, prefix_cache=args.prefix_cache,
        report_every_s=args.report_every, device=dev)
    # mixed prompt lengths, as the reference's launcher draws them
    lengths = [max(1, args.prompt_len - (i % 4))
               for i in range(args.requests)]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device=dev) for n in lengths]
    t0 = time.perf_counter()
    uids = [engine.submit(p, args.new_tokens, deadline_s=args.deadline_s)
            for p in prompts]
    results = engine.run()
    dt = time.perf_counter() - t0
    total = sum(len(results[u]) for u in uids)
    print(f"[serve] {cfg.name} on {dev}: continuous: {args.requests} "
          f"requests over {args.slots} slots, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s)")
    if engine.paged:
        print(f"[serve] paged: {engine.stats}"
              + (f" kv_quant={cfg.kv_quant}" if cfg.kv_quant else ""))
    if faults.active():
        print(f"[serve] faults: {faults.snapshot()} "
              f"demoted={engine.demoted}")
    print({u: results[u][:8] for u in uids[:4]})
    print(f"[serve] summary: {engine.format_summary()} "
          f"demoted={engine.demoted}")
    _finish(args, engine.metrics, demoted=list(engine.demoted))


def _finish(args, metrics, **extra):
    """Write the ``--metrics-json`` snapshot (with the route counts and the
    fault tallies) and export the ``--trace``."""
    if args.metrics_json:
        metrics.write_json(args.metrics_json, routes=obs.routes_snapshot(),
                           faults=faults.snapshot(), **extra)
        print(f"[serve] metrics: {args.metrics_json}")
    if args.trace:
        t = obs.get_tracer()
        n = len(t) if t else 0
        obs.export(args.trace)
        print(f"[serve] trace: {args.trace} ({n} events)")


if __name__ == "__main__":
    main()
