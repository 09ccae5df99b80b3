"""CLI: ``python -m repro_torch.analysis --preset engine-matrix``.

Runs every combo of the preset, prints one verdict line a combo (the
findings of a failing one in full), writes the report to
``artifacts_torch/ANALYSIS.json`` (``--out`` overrides) and exits 1 if any
rule failed.  ``--only REGEX`` keeps the combos whose name matches;
``--list`` prints the names; ``--recalibrate`` measures the einsum
baselines (paste the printed dict into ``presets.EINSUM_BASELINE`` after
an intended change of the round).  ``--device`` is the card by default;
``--device cpu`` runs the plain kernel versions.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.analysis.presets import PRESETS, recalibrate, run_preset


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="run-time contract checks over the sweep engine's "
                    "program matrix and the serving tier")
    parser.add_argument("--preset", default="engine-matrix",
                        choices=sorted(PRESETS))
    parser.add_argument("--only", default=None, metavar="REGEX",
                        help="restrict to combos whose name matches")
    parser.add_argument("--list", action="store_true",
                        help="print combo names and exit")
    parser.add_argument("--out", default="artifacts_torch/ANALYSIS.json",
                        help="report path (default: %(default)s)")
    parser.add_argument("--recalibrate", action="store_true",
                        help="measure einsum baselines and print the "
                             "EINSUM_BASELINE literal")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    if args.list:
        for combo in PRESETS[args.preset]():
            print(combo.name)
        return 0

    if args.recalibrate:
        print("EINSUM_BASELINE = {")
        for key, counts in sorted(recalibrate(args.device).items()):
            print(f"    {key!r}: {counts!r},")
        print("}")
        return 0

    reports = run_preset(args.preset, only=args.only, device=args.device)
    if not reports:
        print(f"no combos match --only {args.only!r}", file=sys.stderr)
        return 2
    for report in reports:
        if report.ok:
            print(f"ok    {report.name}")
        else:
            print(f"FAIL  {report.name}")
            for finding in report.findings:
                print(f"      - {finding}")

    ok = all(r.ok for r in reports)
    payload = {
        "preset": args.preset,
        "only": args.only,
        "n_combos": len(reports),
        "ok": ok,
        "combos": {r.name: r.to_dict() for r in reports},
    }
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=2, sort_keys=True,
                              default=str) + "\n")
    n_bad = sum(not r.ok for r in reports)
    print(f"{len(reports)} combo(s) analyzed, {n_bad} failing -> {out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
