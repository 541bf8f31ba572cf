# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Perf regression sentinel: bench fingerprints vs committed baselines.

Copy of ``container_engine_accelerators_tpu/obs/baseline.py`` (pure
stdlib), its module path the port's; the fingerprint format, the bands
and the gate are the same, so either package's tools read the other's
files. The port's ``kvcache/hostbench.py --fingerprint-out`` writes
here.

Every drill and bench in the stack recomputes its metrics and throws
them away; a perf regression only surfaces if a hard-coded gate
(``--budget-us``, ``--min-speedup``) happens to cover it. This module
closes the loop:

  * benches emit a compact **fingerprint** via ``--fingerprint-out``
    (selected counters/latencies + run meta — see
    :func:`hostbench_series` / :func:`sched_series`);
  * ``seed`` turns a fingerprint from a known-good tree into a
    committed **baseline** (``test/baselines/*.json``) with per-series
    noise bands — relative width plus an absolute floor, each
    direction-aware (``better: lower|higher``);
  * ``gate`` compares a fresh fingerprint against the baseline: rc 1
    with the offending series named on regression, rc 0 with a drift
    table otherwise. ``compare`` renders the same table report-only.

Band defaults are heuristic by series name: host-side wall timings get
generous relative bands (shared-CI noise), deterministic counters
(device_calls, verify_steps) get tight ones, ratios get tight absolute
floors, ``speedup``/``ratio``/``improvement`` series gate on the
*lower* side (higher is better). Hand-tune a committed baseline by
editing its ``rel``/``abs``/``better`` fields — ``seed`` only writes
the starting point.

No-TPU containers are first-class: a fingerprint whose meta carries
``environment: no-tpu`` (what ``bench.py`` reports without hardware)
skips the gate cleanly with rc 0 — the sentinel never fails a tree for
lacking chips.
"""

import argparse
import json
import sys

FINGERPRINT_VERSION = 1

# (substring match, in order — first hit wins): better, rel, abs.
_BAND_RULES = (
    ("us_per_token", ("lower", 1.5, 5.0)),
    ("steps_per_token", ("lower", 0.15, 0.05)),
    ("speedup", ("higher", 0.6, 0.5)),
    ("improvement", ("higher", 0.6, 0.01)),
    ("ratio", ("higher", 0.15, 0.02)),
    ("hit", ("higher", 0.15, 0.02)),
    ("calls", ("lower", 0.25, 2.0)),
    ("steps", ("lower", 0.25, 2.0)),
    ("moves", ("lower", 0.5, 2.0)),
    ("_ms", ("lower", 1.0, 1.0)),
    ("_s", ("lower", 1.0, 1.0)),
)
_DEFAULT_BAND = ("lower", 0.25, 1e-9)


class BaselineError(ValueError):
    """Named sentinel input error (bad file, schema drift) — rc 2."""


def default_band(name):
    """``(better, rel, abs)`` noise band for a series name."""
    for needle, band in _BAND_RULES:
        if needle in name:
            return band
    return _DEFAULT_BAND


# -- fingerprint emission (called from the benches) ---------------------------


def hostbench_series(result):
    """The gated series of a hostbench/spec-bench result row."""
    series = {
        "host_us_per_token": result["host_us_per_token"],
        "device_calls": result["device_calls"],
        "prefix_hit_ratio": result["prefix_hit_ratio"],
    }
    if "device_steps_per_token" in result:
        series.update(
            device_steps_per_token=result["device_steps_per_token"],
            verify_steps=result["verify_steps"],
            acceptance_ratio=result["acceptance_ratio"],
        )
    return series


def sched_series(row):
    """The gated series of a scheduler-bench result row."""
    latency = row["detail"]["latency"]
    defrag = row["detail"]["defrag"]
    return {
        "speedup_p50": latency["speedup_p50"],
        "incremental_p50_ms": latency["incremental"]["p50_ms"],
        "full_p50_ms": latency["full"]["p50_ms"],
        "defrag_moves": defrag["defrag_moves"],
        "frag_improvement": round(
            defrag["frag_before"] - defrag["frag_after"], 6
        ),
    }


def write_fingerprint(path, bench, series, meta=None):
    """Write one fingerprint file; returns the fingerprint dict."""
    fp = {
        "fingerprint_version": FINGERPRINT_VERSION,
        "bench": bench,
        "meta": dict(meta or {}),
        "series": {k: series[k] for k in sorted(series)},
    }
    with open(path, "w") as f:
        json.dump(fp, f, indent=2, sort_keys=True)
        f.write("\n")
    return fp


# -- baseline seeding / comparison --------------------------------------------


def _load(path, what):
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise BaselineError(f"cannot read {what}: {e}") from e
    except json.JSONDecodeError as e:
        raise BaselineError(f"{path}: not JSON ({e.msg})") from e
    if not isinstance(doc, dict) or "series" not in doc:
        raise BaselineError(
            f"{path}: not a {what} (no 'series' — was this written by "
            f"--fingerprint-out / the seed subcommand?)"
        )
    return doc


def load_fingerprint(path):
    return _load(path, "fingerprint")


def load_baseline(path):
    doc = _load(path, "baseline")
    for name, band in doc["series"].items():
        if not isinstance(band, dict) or "value" not in band:
            raise BaselineError(
                f"{path}: series {name!r} has no band — this is a raw "
                f"fingerprint; seed a baseline from it first"
            )
    return doc


def seed_baseline(fingerprint):
    """A baseline doc from a known-good fingerprint: every series gets
    its heuristic band (edit the committed file to hand-tune)."""
    series = {}
    for name, value in fingerprint["series"].items():
        better, rel, floor = default_band(name)
        series[name] = {
            "value": value, "better": better, "rel": rel, "abs": floor,
        }
    return {
        "fingerprint_version": FINGERPRINT_VERSION,
        "bench": fingerprint.get("bench"),
        "meta": fingerprint.get("meta", {}),
        "series": series,
    }


def is_no_tpu(fingerprint):
    meta = fingerprint.get("meta", {})
    return (
        meta.get("environment") == "no-tpu"
        or fingerprint.get("environment") == "no-tpu"
    )


def compare(fingerprint, baseline):
    """``[{series, run, base, limit, better, drift, regressed}]`` —
    one row per baseline series (a series missing from the run is a
    regression: the bench stopped measuring it), plus drift-only rows
    for new run series the baseline doesn't gate."""
    rows = []
    run_series = fingerprint.get("series", {})
    for name, band in sorted(baseline["series"].items()):
        base = float(band["value"])
        better = band.get("better", "lower")
        rel = float(band.get("rel", _DEFAULT_BAND[1]))
        floor = float(band.get("abs", _DEFAULT_BAND[2]))
        margin = max(abs(base) * rel, floor)
        if name not in run_series:
            rows.append({
                "series": name, "run": None, "base": base,
                "limit": None, "better": better, "drift": None,
                "regressed": True,
            })
            continue
        run = float(run_series[name])
        if better == "higher":
            limit = base - margin
            regressed = run < limit
        else:
            limit = base + margin
            regressed = run > limit
        drift = (run - base) / abs(base) if base else None
        rows.append({
            "series": name, "run": run, "base": base,
            "limit": round(limit, 6), "better": better,
            "drift": round(drift, 4) if drift is not None else None,
            "regressed": regressed,
        })
    for name in sorted(set(run_series) - set(baseline["series"])):
        rows.append({
            "series": name, "run": float(run_series[name]),
            "base": None, "limit": None, "better": None, "drift": None,
            "regressed": False,
        })
    return rows


def render_table(bench, rows):
    lines = [f"perf sentinel: {bench or '?'}"]
    width = max([len(r["series"]) for r in rows] + [6])
    for r in rows:
        name = r["series"].ljust(width)
        if r["run"] is None:
            lines.append(
                f"  {name}  MISSING (baseline {r['base']:g}) "
                f"REGRESSED"
            )
        elif r["base"] is None:
            lines.append(
                f"  {name}  {r['run']:g} (new series, not gated)"
            )
        else:
            drift = (
                f"{r['drift']:+.1%}" if r["drift"] is not None
                else "n/a"
            )
            verdict = "REGRESSED" if r["regressed"] else "ok"
            lines.append(
                f"  {name}  {r['run']:g} vs {r['base']:g} "
                f"({drift}, {r['better']} is better, limit "
                f"{r['limit']:g}) {verdict}"
            )
    return "\n".join(lines) + "\n"


def gate(fingerprint_path, baseline_path, out=sys.stdout):
    """The ``make perf-gate`` core: rc 0 clean / no-tpu skip, rc 1
    regression (offenders named), raises BaselineError on bad input."""
    fp = load_fingerprint(fingerprint_path)
    if is_no_tpu(fp):
        out.write(
            f"perf sentinel: {fp.get('bench') or fingerprint_path} "
            f"reports environment no-tpu — skipping (rc 0)\n"
        )
        return 0
    base = load_baseline(baseline_path)
    if fp.get("bench") and base.get("bench") and (
        fp["bench"] != base["bench"]
    ):
        raise BaselineError(
            f"fingerprint is from bench {fp['bench']!r} but baseline "
            f"gates {base['bench']!r} — wrong file pairing"
        )
    rows = compare(fp, base)
    out.write(render_table(fp.get("bench"), rows))
    regressed = [r["series"] for r in rows if r["regressed"]]
    if regressed:
        out.write(
            "REGRESSION: " + ", ".join(regressed)
            + f" outside the baseline noise bands ({baseline_path})\n"
        )
        return 1
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m container_engine_accelerators_tpu_torch.obs."
             "baseline",
        description="Perf regression sentinel over bench fingerprints.",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_seed = sub.add_parser(
        "seed", help="turn a known-good fingerprint into a baseline",
    )
    p_seed.add_argument("fingerprint")
    p_seed.add_argument("-o", "--out", required=True,
                        help="baseline JSON to write")
    p_cmp = sub.add_parser(
        "compare", help="drift table only (always rc 0 on valid input)",
    )
    p_cmp.add_argument("fingerprint")
    p_cmp.add_argument("baseline")
    p_gate = sub.add_parser(
        "gate", help="rc 1 when any series regresses past its band",
    )
    p_gate.add_argument("fingerprint")
    p_gate.add_argument("baseline")
    args = parser.parse_args(argv)
    try:
        if args.cmd == "seed":
            fp = load_fingerprint(args.fingerprint)
            doc = seed_baseline(fp)
            with open(args.out, "w") as f:
                json.dump(doc, f, indent=2, sort_keys=True)
                f.write("\n")
            print(
                f"seeded {args.out} from {args.fingerprint} "
                f"({len(doc['series'])} series)"
            )
            return 0
        if args.cmd == "compare":
            fp = load_fingerprint(args.fingerprint)
            base = load_baseline(args.baseline)
            sys.stdout.write(
                render_table(fp.get("bench"), compare(fp, base))
            )
            return 0
        return gate(args.fingerprint, args.baseline)
    except (BaselineError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
