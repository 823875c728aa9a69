"""The port's obsctl — run, summarize, diff, and gate observability
exports (the counterpart of the JAX package's `tools/obsctl.py`).

    PYTHONPATH=src python -m repro_torch.obs.cli run steady -o run.json
    PYTHONPATH=src python -m repro_torch.obs.cli run steady --device cpu
    PYTHONPATH=src python -m repro_torch.obs.cli summarize run.json
    PYTHONPATH=src python -m repro_torch.obs.cli diff a.json b.json
    PYTHONPATH=src python -m repro_torch.obs.cli check run.json --min-accuracy 0.5

`run` drives one named scenario with `REPRO_OBS=on` and writes the
canonical run document; its fills run on the card by default (the
``cuda`` water-fill backend, one `waterfill` launch a fill), and with
``--device cpu`` on the numpy loop, as the JAX package runs them.
`summarize` renders ANY of the repo's JSON observability documents
(obs runs, BENCH_*.json, dryrun cell lists) through the one report
path in `repro_torch.obs.export`; `check` validates the schema and
optional SLE floors, exiting non-zero on any problem. The subcommands
and exit codes are the JAX package's.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def _cmd_run(args) -> int:
    from repro_torch.device import resolve_device
    from repro_torch.obs import (export_scenario, to_json, write_json,
                                 write_spans_jsonl)
    from repro_torch.scenarios import ScenarioEngine, get_scenario
    dev = resolve_device(args.device)
    spec = get_scenario(args.scenario)
    spec.sim_kwargs["waterfill_backend"] = \
        "cuda" if dev.type == "cuda" else "numpy"
    eng = ScenarioEngine(spec, seed=args.seed, obs="on")
    doc = export_scenario(eng.run(), eng)
    if args.out:
        write_json(doc, args.out)
        sys.stderr.write(f"wrote {args.out}\n")
    else:
        sys.stdout.write(to_json(doc))
    if args.spans:
        write_spans_jsonl(eng.tracer, args.spans)
        sys.stderr.write(f"wrote {args.spans} "
                         f"({len(eng.tracer.spans)} spans)\n")
    return 0


def _cmd_summarize(args) -> int:
    from repro_torch.obs import load, summarize
    for path in args.paths:
        print(summarize(load(path)))
    return 0


def _cmd_diff(args) -> int:
    from repro_torch.obs import diff_runs, load
    d = diff_runs(load(args.a), load(args.b))
    if not d:
        print("no numeric differences")
        return 0
    w = max(len(k) for k in d)
    for k, row in d.items():
        rel = f"  ({row['rel']:+.1%})" if "rel" in row else ""
        print(f"{k:<{w}}  {row['a']} -> {row['b']}{rel}")
    return 1 if args.fail_on_diff else 0


def _cmd_check(args) -> int:
    from repro_torch.obs import check_run, load
    problems = check_run(load(args.path),
                         min_accuracy=args.min_accuracy,
                         min_capacity=args.min_capacity,
                         min_fairness=args.min_fairness,
                         max_usd=args.max_usd)
    for p in problems:
        print(f"FAIL: {p}")
    if not problems:
        print(f"OK: {args.path} passes schema + SLE checks")
    return 1 if problems else 0


def main(argv: Optional[List[str]] = None) -> int:
    """Parse `argv` (default: the command line), run the subcommand and
    return its exit code."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.cli",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run a scenario with obs on + export")
    p.add_argument("scenario")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="where the fills run: the card (default, the "
                        "cuda fill) or 'cpu' (the numpy fill)")
    p.add_argument("-o", "--out", default=None,
                   help="run-document path (default: stdout)")
    p.add_argument("--spans", default=None,
                   help="also write per-span JSONL here")
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser("summarize", help="render any obs/bench JSON")
    p.add_argument("paths", nargs="+")
    p.set_defaults(fn=_cmd_summarize)

    p = sub.add_parser("diff", help="numeric-leaf diff of two documents")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--fail-on-diff", action="store_true")
    p.set_defaults(fn=_cmd_diff)

    p = sub.add_parser("check", help="schema + SLE-floor gate")
    p.add_argument("path")
    p.add_argument("--min-accuracy", type=float, default=None)
    p.add_argument("--min-capacity", type=float, default=None)
    p.add_argument("--min-fairness", type=float, default=None)
    p.add_argument("--max-usd", type=float, default=None)
    p.set_defaults(fn=_cmd_check)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
