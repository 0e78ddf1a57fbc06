#!/usr/bin/env python
"""Noise-aware perf regression gate over the run-history ledger.

Compares one run (by default the ledger's newest entry) against the
baseline pool of earlier entries that agree with it on config
fingerprint, backend and n_reads (obs/history.py). The verdict is
median + MAD based: a run regresses only when its metric is worse than
the baseline median by more than

    max(--threshold * median, --mad-k * 1.4826 * MAD)

so a quiet baseline gates at the relative threshold while a noisy one
widens to what its own scatter justifies. Fewer than ``--min-samples``
matching baselines -> WARN and exit 0 (a thin ledger on a fresh machine
records instead of failing).

Metric: ``reads_per_sec`` (higher is better; bench entries) when the
current entry carries one, else ``duration_s`` (lower is better; run
entries). A second, independent verdict gates the data plane:
``host_round_trip_bytes`` (lower is better; obs/transfers.py ledger),
so a PR that reintroduces a host round-trip fails with measured vs
allowed bytes. Entries predating the transfer ledger simply lack the
field — they are skipped for the byte pool (WARN when it goes thin,
never a crash) while remaining full baselines for the timing gate.

A third additive verdict gates the serving SLOs over the ledger's
``source:"serve_load"`` entries (scripts/torch_serve_load.py reports): p99
job wait (lower better) and sustained reads_per_sec (higher better),
same allowance arithmetic. Ledgers with no load history WARN — the
load gate arms once a load report has been recorded.

Usage:
    python scripts/torch_perf_gate.py LEDGER.jsonl [--current latest|entry.json]
        [--threshold 0.15] [--mad-k 4.0] [--min-samples 3] [--json]

Exit codes: 0 pass/warn, 1 regression, 2 usage / unreadable ledger.
Garbage ledger lines are skipped with a named stderr warning (never a
traceback) — the gate must stay usable on the artifact someone tore.
The PyTorch port's gate, on the port's ``obs/history.py``: it imports
neither jax nor torch, so it runs on a host whose card is wedged.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ont_tcrconsensus_tpu_torch.obs import history  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Gate a run's perf against the run-history ledger "
        "(median + MAD over matching fingerprint/backend/n_reads entries)."
    )
    ap.add_argument("ledger", help="history .jsonl ledger path")
    ap.add_argument(
        "--current", default="latest",
        help="'latest' (default: the ledger's newest entry, gated against "
        "the rest) or a path to a JSON file holding one entry",
    )
    ap.add_argument("--threshold", type=float, default=0.15,
                    help="relative regression threshold vs the baseline "
                    "median (default 0.15 = 15%%)")
    ap.add_argument("--mad-k", type=float, default=4.0,
                    help="noise widening: allowance is at least this many "
                    "scaled MADs (default 4.0)")
    ap.add_argument("--min-samples", type=int, default=3,
                    help="matching baseline entries required to gate; "
                    "fewer -> WARN, exit 0 (default 3)")
    ap.add_argument("--json", action="store_true",
                    help="emit the verdict as one JSON line")
    ap.add_argument("--rt-budget", type=float, default=None, metavar="BYTES",
                    help="absolute host_round_trip_bytes ceiling for the "
                    "transfer verdict (the production data plane is "
                    "device-resident, so ~0 is the honest budget); gates "
                    "deterministically with no ledger history — omit to "
                    "use the relative median+MAD baseline gate")
    args = ap.parse_args(argv)

    entries, problems = history.read_entries(args.ledger)
    for p in problems:
        print(f"perf_gate: ledger {p}", file=sys.stderr)
    if not entries:
        print(f"perf_gate: no readable entries in {args.ledger}",
              file=sys.stderr)
        return 2
    if args.current == "latest":
        current = entries[-1]
    else:
        try:
            with open(args.current) as fh:
                current = json.load(fh)
        except (OSError, ValueError) as exc:
            print(f"perf_gate: unreadable --current {args.current!r}: "
                  f"{exc!r}", file=sys.stderr)
            return 2
        if not isinstance(current, dict):
            print(f"perf_gate: --current {args.current!r} is not a JSON "
                  "object", file=sys.stderr)
            return 2

    result = history.evaluate_gate(
        entries, current, rel_threshold=args.threshold,
        mad_k=args.mad_k, min_samples=args.min_samples,
    )
    transfer = history.evaluate_bytes_gate(
        entries, current, rel_threshold=args.threshold,
        mad_k=args.mad_k, min_samples=args.min_samples,
        abs_budget=args.rt_budget,
    )
    # serving-SLO verdict: gate the current entry when it IS a load
    # report, else the ledger's newest serve_load entry (warn when none)
    load = history.evaluate_load_gate(
        entries,
        current if current.get("source") == "serve_load" else None,
        rel_threshold=args.threshold, mad_k=args.mad_k,
        min_samples=args.min_samples,
    )
    if args.json:
        # one JSON object on stdout (consumers json.loads the whole
        # stream); the transfer + load verdicts ride additive keys
        body = dataclasses.asdict(result)
        body["transfer"] = dataclasses.asdict(transfer)
        body["load"] = dataclasses.asdict(load)
        print(json.dumps(body, sort_keys=True))
    else:
        print(f"perf_gate: {result.status.upper()} — {result.reason}")
        print(f"perf_gate: transfer {transfer.status.upper()} — "
              f"{transfer.reason}")
        print(f"perf_gate: load {load.status.upper()} — {load.reason}")
    return 1 if "fail" in (result.status, transfer.status,
                           load.status) else 0


if __name__ == "__main__":
    sys.exit(main())
