"""Training launcher: random weights from ``--seed``, the synthetic LM
stream, AdamW with a warmup-cosine schedule, and the fault-tolerant
:class:`repro_torch.train.Trainer` (resume from ``--ckpt-dir``, NaN
rollback, SIGTERM/SIGINT save and exit 0).

Runs on CUDA unless ``--device cpu``; without CUDA it exits non-zero.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --arch opt125m \\
        --linear dyad_it_4_kernel --steps 100 --seq-len 512 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch opt125m \\
        --smoke --device cpu --steps 3
"""
from __future__ import annotations

import argparse
import signal

import torch

from repro_torch import configs
from repro_torch import device as device_lib
from repro_torch.data import SyntheticLM
from repro_torch.optim import AdamW, Compressor, schedule
from repro_torch.train import Trainer, init_train_state, make_train_step


def build_trainer(arch: str, *, smoke: bool = False, linear=None,
                  steps: int = 100, seq_len: int = 64, batch: int = 8,
                  lr: float = 1e-3, ckpt_dir=None, ckpt_every: int = 50,
                  nan_strikes: int = 3, seed: int = 0, device=None,
                  compress: str = "none", log_fn=print):
    """(cfg, trainer): the launcher's model, data, optimizer and loop.
    ``linear`` is a spec string (``configs.linear_cfg``) or None for the
    config's own; ``compress`` the gradient codec (``int8``, ``topk`` or
    ``none``)."""
    dev = device_lib.resolve(device)
    lin = configs.linear_cfg(linear) if linear else None
    cfg = configs.get(arch, smoke=smoke, linear=lin)
    opt = AdamW(lr=schedule.warmup_cosine(lr, steps // 10 + 1, steps))
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len,
                       global_batch=batch, seed=seed, device=str(dev))
    comp = Compressor(codec=compress)
    state = init_train_state(
        cfg, opt, torch.Generator(device=dev).manual_seed(seed),
        compressor=comp, device=dev)
    trainer = Trainer(make_train_step(cfg, opt, compressor=comp), state, data,
                      ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                      nan_strikes=nan_strikes, log_fn=log_fn)
    return cfg, trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--linear", default=None,
                    help="dense | dyad_<variant>_<n>[_cat][_kernel]"
                         "[_einsumbwd]")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the final training metrics snapshot as JSON")
    ap.add_argument("--nan-strikes", type=int, default=3,
                    help="consecutive non-finite steps before rolling back "
                         "to the last checkpoint")
    ap.add_argument("--compress", default="none",
                    choices=("none", "int8", "topk"),
                    help="gradient compression (with error feedback) "
                         "before the optimizer update")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        dev = device_lib.resolve(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[train] {e}") from None
    cfg, trainer = build_trainer(
        args.arch, smoke=args.smoke, linear=args.linear, steps=args.steps,
        seq_len=args.seq_len, batch=args.batch, lr=args.lr,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        nan_strikes=args.nan_strikes, seed=args.seed, device=dev,
        compress=args.compress)
    print(f"[train] arch={cfg.name} family={cfg.family} "
          f"linear={cfg.linear.impl}({cfg.linear.variant},"
          f"n={cfg.linear.n_dyad}) compress={args.compress} device={dev}",
          flush=True)
    # SIGTERM (spot reclaim, scheduler) and SIGINT (ctrl-C) both finish the
    # step in flight, write a blocking checkpoint and exit 0
    trainer.install_preemption_handler(
        signals=(signal.SIGTERM, signal.SIGINT))
    _, metrics = trainer.run(args.steps)
    if trainer.preempted:
        print(f"[train] preempted at step {trainer.step}: checkpoint saved, "
              "relaunch to resume")
    loss = float(metrics["loss"]) if "loss" in metrics else float("nan")
    print(f"[train] done at step {trainer.step}: loss={loss:.4f} "
          f"stragglers={len(trainer.straggler_events)}")
    snap = trainer.metrics.snapshot()
    h = snap["histograms"].get("step_time_s")
    if h:
        tok_s = snap["gauges"].get("tokens_per_s", {}).get("value", 0)
        data = snap["histograms"]["data_time_s"]
        print(f"[train] summary: steps={h['count']} "
              f"step_ms p50={h['p50'] * 1e3:.1f} p99={h['p99'] * 1e3:.1f} "
              f"data_ms p50={data['p50'] * 1e3:.1f} "
              f"tok/s={tok_s:.0f} "
              f"stragglers={snap['counters'].get('straggler_count', 0)}")
    if args.metrics_json:
        trainer.metrics.write_json(args.metrics_json)
        print(f"[train] metrics: {args.metrics_json}")


if __name__ == "__main__":
    main()
