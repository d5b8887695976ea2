"""Trace replay-diff (port of ``repro.perf.timeline``):

    python -m repro_torch.perf.timeline a.json b.json

Loads two runs and attributes the wall-time difference between them to
span names: instead of "the run got 18% slower", the diff says "the
``decode_step`` spans account for +41 ms of the +47 ms, mean +0.8 ms a
step".

Inputs may be either of:

* a Chrome-trace JSON exported by the tracer (``launch/serve.py --trace``,
  ``launch/train.py --trace``, of either package): spans are aggregated
  by name (count, total, mean);
* a ``BENCH_<suite>.json``-shaped benchmark document: each record with a
  ``us_per_call`` becomes one "span".

Rows are ranked by absolute total-time delta, so the top row is the
localization.  ``--fail-on-regress`` makes the diff a gate (a trace
diffed against itself finds nothing).

    python -m repro_torch.perf.timeline base_trace.json new_trace.json
    python -m repro_torch.perf.timeline t.json t.json --fail-on-regress
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional

DEFAULT_TOL = 0.20        # mean-time growth beyond 20% marks a row regressed
DEFAULT_MIN_US = 50.0     # ignore sub-noise-floor total deltas


@dataclasses.dataclass
class SpanStats:
    """Aggregated timing of one span name within a run."""

    name: str
    count: int = 0
    total_us: float = 0.0

    @property
    def mean_us(self) -> float:
        return self.total_us / self.count if self.count else 0.0


@dataclasses.dataclass
class DiffRow:
    name: str
    base: Optional[SpanStats]
    cur: Optional[SpanStats]

    @property
    def delta_total_us(self) -> float:
        b = self.base.total_us if self.base else 0.0
        c = self.cur.total_us if self.cur else 0.0
        return c - b

    @property
    def mean_ratio(self) -> Optional[float]:
        if not (self.base and self.cur and self.base.count
                and self.cur.count):
            return None
        return self.cur.mean_us / max(self.base.mean_us, 1e-9)

    def regressed(self, tol: float, min_us: float) -> bool:
        r = self.mean_ratio
        return (r is not None and r > 1.0 + tol
                and self.delta_total_us >= min_us)

    @property
    def status(self) -> str:
        if self.base is None:
            return "NEW"
        if self.cur is None:
            return "REMOVED"
        return "ok"


def load_timeline(path: str) -> Dict[str, SpanStats]:
    """Per-span-name aggregate of one run.  Accepts a Chrome-trace document
    (``traceEvents``) or a ``BENCH_*.json`` (``results``)."""
    with open(path) as f:
        doc = json.load(f)
    stats: Dict[str, SpanStats] = {}

    def add(name: str, us: float) -> None:
        s = stats.get(name)
        if s is None:
            s = stats[name] = SpanStats(name)
        s.count += 1
        s.total_us += us

    if isinstance(doc, dict) and "traceEvents" in doc:
        for ev in doc["traceEvents"]:
            if ev.get("ph") == "X":
                add(ev.get("name", "?"), float(ev.get("dur", 0.0)))
        return stats
    if isinstance(doc, dict) and "results" in doc:
        for r in doc["results"]:
            if isinstance(r, dict) and "us_per_call" in r:
                add(r.get("name", "?"), float(r["us_per_call"]))
        return stats
    raise ValueError(f"{path}: neither a Chrome trace (traceEvents) nor a "
                     f"BENCH document (results)")


def diff_timelines(base: Dict[str, SpanStats], cur: Dict[str, SpanStats]
                   ) -> List[DiffRow]:
    """Rows for every span name in either run, ranked by |total delta| —
    the first row is where the wall time went."""
    rows = [DiffRow(name, base.get(name), cur.get(name))
            for name in set(base) | set(cur)]
    rows.sort(key=lambda r: -abs(r.delta_total_us))
    return rows


def _fmt_us(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if abs(v) >= 1e6:
        return f"{v / 1e6:.2f}s"
    if abs(v) >= 1e3:
        return f"{v / 1e3:.1f}ms"
    return f"{v:.0f}us"


def format_diff(rows: List[DiffRow], *, top: int = 15,
                tol: float = DEFAULT_TOL,
                min_us: float = DEFAULT_MIN_US) -> str:
    hdr = (f"{'span':40s} {'n(base/cur)':>12s} {'base_total':>10s} "
           f"{'cur_total':>10s} {'d_total':>9s} {'base_mean':>10s} "
           f"{'cur_mean':>10s} {'ratio':>6s}  status")
    lines = [hdr, "-" * len(hdr)]
    for r in rows[:top]:
        nb = r.base.count if r.base else 0
        nc = r.cur.count if r.cur else 0
        ratio = r.mean_ratio
        status = ("REGRESSED" if r.regressed(tol, min_us)
                  else "faster" if (ratio is not None and ratio < 1.0 - tol
                                    and -r.delta_total_us >= min_us)
                  else r.status)
        lines.append(
            f"{r.name[:40]:40s} {f'{nb}/{nc}':>12s} "
            f"{_fmt_us(r.base.total_us if r.base else None):>10s} "
            f"{_fmt_us(r.cur.total_us if r.cur else None):>10s} "
            f"{_fmt_us(r.delta_total_us):>9s} "
            f"{_fmt_us(r.base.mean_us if r.base else None):>10s} "
            f"{_fmt_us(r.cur.mean_us if r.cur else None):>10s} "
            f"{'-' if ratio is None else f'{ratio:.2f}':>6s}  {status}")
    if len(rows) > top:
        lines.append(f"... {len(rows) - top} more spans (use --top)")
    return "\n".join(lines)


def attribute(rows: List[DiffRow], *, tol: float = DEFAULT_TOL,
              min_us: float = DEFAULT_MIN_US) -> List[DiffRow]:
    """The regression verdict: rows that got slower, worst first."""
    return [r for r in rows if r.regressed(tol, min_us)]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.perf.timeline", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("base", help="baseline trace.json or BENCH_*.json")
    p.add_argument("current", help="current trace.json or BENCH_*.json")
    p.add_argument("--top", type=int, default=15,
                   help="rows to print (ranked by |total delta|)")
    p.add_argument("--tol", type=float, default=DEFAULT_TOL,
                   help="mean-time growth marking a span regressed")
    p.add_argument("--min-us", type=float, default=DEFAULT_MIN_US,
                   help="ignore spans whose total delta is below this")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the full diff as JSON ('-' = stdout)")
    p.add_argument("--fail-on-regress", action="store_true",
                   help="exit 1 when any span regressed beyond --tol")
    args = p.parse_args(argv)

    base = load_timeline(args.base)
    cur = load_timeline(args.current)
    rows = diff_timelines(base, cur)
    total_b = sum(s.total_us for s in base.values())
    total_c = sum(s.total_us for s in cur.values())
    print(f"base: {args.base} ({len(base)} spans, {_fmt_us(total_b)} total)")
    print(f"cur:  {args.current} ({len(cur)} spans, {_fmt_us(total_c)} "
          f"total, delta {_fmt_us(total_c - total_b)})")
    print()
    print(format_diff(rows, top=args.top, tol=args.tol, min_us=args.min_us))

    bad = attribute(rows, tol=args.tol, min_us=args.min_us)
    print()
    if bad:
        worst = bad[0]
        print(f"REGRESSION localized to span '{worst.name}': "
              f"{_fmt_us(worst.delta_total_us)} of the "
              f"{_fmt_us(total_c - total_b)} total delta "
              f"(mean {_fmt_us(worst.base.mean_us)} -> "
              f"{_fmt_us(worst.cur.mean_us)}, x{worst.mean_ratio:.2f}, "
              f"{worst.cur.count} calls)")
        for r in bad[1:4]:
            print(f"  also regressed: '{r.name}' "
                  f"{_fmt_us(r.delta_total_us)} (x{r.mean_ratio:.2f})")
    else:
        print("no span regressed beyond tolerance "
              f"(tol={args.tol:.0%}, min_us={args.min_us:g})")

    if args.json:
        doc = {
            "base": args.base, "current": args.current,
            "tol": args.tol, "min_us": args.min_us,
            "total_base_us": total_b, "total_cur_us": total_c,
            "rows": [{
                "name": r.name,
                "base": dataclasses.asdict(r.base) if r.base else None,
                "cur": dataclasses.asdict(r.cur) if r.cur else None,
                "delta_total_us": r.delta_total_us,
                "mean_ratio": r.mean_ratio,
                "regressed": r.regressed(args.tol, args.min_us),
            } for r in rows],
        }
        if args.json == "-":
            json.dump(doc, sys.stdout, indent=1, sort_keys=True)
            sys.stdout.write("\n")
        else:
            with open(args.json, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.write("\n")
    return 1 if (bad and args.fail_on_regress) else 0


if __name__ == "__main__":
    sys.exit(main())
