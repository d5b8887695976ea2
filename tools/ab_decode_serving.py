#!/usr/bin/env python3
"""One side of an A/B of the ring decode on the serving paths.

Run from the repository root on a machine with one CUDA card, once per
tree and in turns (parent, change, change, parent, ...), each run in a
process of its own:

    python3 tools/ab_decode_serving.py --src build/parent/src --label parent
    python3 tools/ab_decode_serving.py --src src --label change

``--src`` names the ``src`` directory of the tree whose port is measured
(its kernels build into that tree's ``build/``); the measuring code is
this checkout's ``chip_smoke.py``, so both sides run the same driver.
Each run prints one JSON line per measurement, its first key the label:

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory of the tree to measure")
    ap.add_argument("--label", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--generates", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import dyad_mm, flash_attn
    from repro_torch.models import model
    from repro_torch.serve.engine import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    label = args.label
    _emit(label, "tree", src=str(Path(args.src).resolve()),
          port=flash_attn.__file__)

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
    _emit(label, "generate", runs=runs, decode_tok_s_median=statistics.median(
        r["decode_tok_s"] for r in runs))
    del engine, params
    torch.cuda.empty_cache()

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
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONHASHSEED", "0")
    sys.exit(main())
