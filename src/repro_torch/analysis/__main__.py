"""CLI for the static-analysis pass: ``python -m repro_torch.analysis``.

Exit codes: 0: clean (every lint finding baselined, every audited
program within its budget); 1: new lint findings, a failed audit or a
derived constant that disagrees; 2: a ``--seed-bug`` run whose injected
bug was caught (the expected outcome of a seeded run).

    python -m repro_torch.analysis                    # lint + audit
    python -m repro_torch.analysis --device cpu       # audit on the CPU
    python -m repro_torch.analysis --skip-audit src/  # lint only
    python -m repro_torch.analysis --json report.json # machine-readable
    python -m repro_torch.analysis --seed-bug inf-depth     # exits 2
    python -m repro_torch.analysis --seed-bug pack-overflow # exits 2

The audit runs on the CUDA device, and fails where there is none, unless
`--device cpu` asks for the CPU (where the plain loops stand in for the
card's kernels, so the sync counts are the CPU path's). The seeded bugs
are the reference's witness programs written in torch:

  * ``inf-depth``: the unreachable-depth sentinel (INT32_MAX) cast into
    float32 and multiplied by an edge weight without the
    ``bfs.finite_depth`` guard.
  * ``pack-overflow``: the reference's int32 packed BFS relaxation key
    dist·(n+1)+id traced one past ``PACKED_KEY_MAX_N``, where it
    provably exceeds int32.
"""
from __future__ import annotations

import argparse
import json
import sys


def _seeded_bug(which: str):
    """Trace the witness program for the named bug and return the range
    findings (non-empty iff the analyzers work)."""
    import torch

    from repro_torch.analysis.ranges import INT32_MAX, Interval, check_ranges
    from repro_torch.core.bfs import PACKED_KEY_MAX_N

    if which == "inf-depth":
        def buggy_eff(depth, w):
            return depth.to(torch.float32) * w

        return check_ranges(
            buggy_eff,
            [Interval.of(0, 63, sentinel=INT32_MAX), Interval.of(0, 1)],
            torch.zeros((8,), dtype=torch.int64),
            torch.ones((8,), dtype=torch.float32))

    if which == "pack-overflow":
        n = PACKED_KEY_MAX_N + 1

        def pack(dist, ids, base):
            return dist * base + ids

        spec = torch.zeros((8,), dtype=torch.int32)
        return check_ranges(
            pack,
            [Interval.of(0, n), Interval.of(0, n), Interval.const(n + 1)],
            spec, spec, torch.tensor(n + 1, dtype=torch.int32))

    raise SystemExit(f"unknown --seed-bug {which!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static analysis: AST lint + graph audit")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or trees to lint (default: src/repro_torch)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the full machine-readable report here")
    ap.add_argument("--skip-audit", action="store_true",
                    help="lint only; skip running the device programs")
    ap.add_argument("--device", default=None,
                    help="where the audited programs run (default: the "
                         "CUDA device; 'cpu' asks for the CPU)")
    ap.add_argument("--baseline", default=None,
                    help="alternate baseline file (default: the "
                         "package's baseline.json)")
    ap.add_argument("--seed-bug", choices=("inf-depth", "pack-overflow"),
                    default=None,
                    help="inject a known bug as a witness program; exits 2 "
                         "when (and only when) the analyzers catch it")
    ns = ap.parse_args(argv)

    report = {"lint": [], "suppressed": 0, "audits": [],
              "derived_constants": [], "seeded": None, "ok": True}
    rc = 0

    if ns.seed_bug:
        findings = _seeded_bug(ns.seed_bug)
        report["seeded"] = {"bug": ns.seed_bug, "caught": bool(findings),
                            "findings": [str(f) for f in findings]}
        if findings:
            print(f"seeded bug '{ns.seed_bug}' CAUGHT:")
            for f in findings:
                print(f"  {f}")
            rc = 2
        else:
            print(f"seeded bug '{ns.seed_bug}' NOT caught: the analyzers "
                  f"have regressed", file=sys.stderr)
            report["ok"] = False
            # a miss exits 0, so a check that a seeded run exits 2 fails
            # loudly instead of passing by accident
        if ns.json:
            with open(ns.json, "w", encoding="utf-8") as f:
                json.dump(report, f, indent=2)
        return rc

    from repro_torch.analysis.lint import apply_baseline, load_baseline, \
        run_lint

    findings = run_lint(ns.paths)
    new, suppressed = apply_baseline(findings, load_baseline(ns.baseline))
    report["lint"] = [f.as_dict() for f in new]
    report["suppressed"] = len(suppressed)
    for f in new:
        print(f.format())
    if new:
        rc = 1
        report["ok"] = False
    print(f"lint: {len(new)} new finding(s), {len(suppressed)} baselined")

    if not ns.skip_audit:
        from repro_torch.analysis.graph_audit import (
            check_derived_constants, standard_program_audits)
        from repro_torch.core.sparsify import resolve_device

        try:
            dev = resolve_device(ns.device)
        except RuntimeError as e:
            print(f"graph audit: {e} (or --skip-audit)", file=sys.stderr)
            return 1

        derived = check_derived_constants()
        report["derived_constants"] = derived
        for msg in derived:
            print(f"derived-constant: {msg}")
        audits = standard_program_audits(device=dev)
        report["audits"] = [r.as_dict() for r in audits]
        bad = [r for r in audits if not r.ok]
        for r in audits:
            print(f"audit[{r.name}]: {r.n_syncs} host syncs "
                  f"({len(r.syncs)} sites)")
        for r in bad:
            for msg in r.findings:
                print(f"audit[{r.name}]: {msg}")
        print(f"graph audit: {len(audits)} programs, {len(bad)} failing")
        if derived or bad:
            rc = 1
            report["ok"] = False

    if ns.json:
        with open(ns.json, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
    return rc


if __name__ == "__main__":
    sys.exit(main())
