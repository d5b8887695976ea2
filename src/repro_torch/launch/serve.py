"""Serving launcher: random weights from ``--seed`` and batched generation
through :class:`repro_torch.serve.engine.Engine` (``--engine batch``).

Runs on CUDA unless ``--device cpu``; without CUDA it exits non-zero.

Example:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt125m \
        --linear dyad_it_4_kernel --batch 8 --prompt-len 128 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt125m \
        --smoke --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch import device as device_lib
from repro_torch.models import model
from repro_torch.serve.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--linear", default=None)
    ap.add_argument("--engine", choices=("batch",), default="batch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        dev = device_lib.resolve(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[serve] {e}") from None
    linear = configs.linear_cfg(args.linear) if args.linear else None
    cfg = configs.get(args.arch, smoke=args.smoke, linear=linear)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init_params(cfg, gen, dev)
    max_len = args.prompt_len + args.new_tokens
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


if __name__ == "__main__":
    main()
