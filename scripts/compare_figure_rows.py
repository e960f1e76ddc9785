#!/usr/bin/env python3
"""Compare two runs of the paper's figure scripts, row by row.

Each directory holds ``fig2_latency_power.csv`` ... ``fig5_request_scaling.csv``,
the standard output of one package's scripts (``benchmarks/fig*.py`` or
``benchmarks/torch_fig*.py``; rows ``name,us_per_call,derived,feasibility``).

    python3 scripts/compare_figure_rows.py REFERENCE_DIR PORT_DIR [--rows]

Prints, per figure: the rows, the rows whose feasibility differs, the rows
where exactly one side is infinite, and the largest relative gap of the
derived column (latency, or Fig. 4's power) over the rows finite on both
sides, with its row.  ``--rows`` also prints the second directory's rows
as ``name derived feasibility``.  Exits non-zero when the row names
differ.
"""
from __future__ import annotations

import argparse
import math
import os
import sys

FIGURES = ("fig2_latency_power", "fig3_latency_memory", "fig4_min_power",
           "fig5_request_scaling")


def read_rows(path):
    with open(path) as fh:
        return [line.strip().split(",") for line in fh
                if line.count(",") == 3 and not line.startswith("name,")]


def compare(ref, got):
    """-> (feasibility differs, one side inf, (gap, name) of the largest
    relative gap of the derived column)."""
    feas, inf, worst = [], [], (0.0, "")
    for r, g in zip(ref, got):
        if r[3] != g[3]:
            feas.append(f"{r[0]} ({r[3]} / {g[3]})")
        a, b = float(r[2]), float(g[2])
        if math.isinf(a) != math.isinf(b):
            inf.append(r[0])
        elif math.isfinite(a) and a != 0.0 and abs(b - a) / abs(a) > worst[0]:
            worst = (abs(b - a) / abs(a), r[0])
    return feas, inf, worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("reference")
    ap.add_argument("port")
    ap.add_argument("--rows", action="store_true")
    args = ap.parse_args(argv)
    ok = True
    for fig in FIGURES:
        ref = read_rows(os.path.join(args.reference, fig + ".csv"))
        got = read_rows(os.path.join(args.port, fig + ".csv"))
        if [r[0] for r in ref] != [r[0] for r in got]:
            print(f"{fig}: row names differ")
            ok = False
            continue
        feas, inf, (gap, where) = compare(ref, got)
        print(f"{fig}: {len(got)} rows; feasibility differs in "
              f"{len(feas)} {feas}; one side inf in {len(inf)} {inf}; "
              f"largest derived gap {gap:.3e} ({where})")
        if args.rows:
            for g in got:
                print(f"  {g[0]} {g[2]} {g[3]}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
