# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Fleet-level trace merging: many per-host span files, one timeline.

Copy of ``container_engine_accelerators_tpu/obs/fleet.py``, its imports
rewritten to the port's package (``goodput`` reads its loaders); the
contracts are the same.

A TPU slice is inherently multi-host: one training step is N hosts
dispatching the same program, one ring collective is N participants, and
the slowest host sets the pace for everyone (a straggler inside a
blocking collective *is* the step time). Per-process tracers
(``obs/trace.py``) each see only their own host; this module is the
Dapper-style aggregation layer that makes the whole step visible:

  * :func:`load_host_trace` reads one host's span JSONL (written by
    ``Tracer.write_jsonl``), including the leading ``__trace_meta__``
    record that carries the host name and the wall-clock epoch of the
    tracer's t=0.
  * :func:`estimate_offsets` corrects clock skew. Hosts' wall clocks
    disagree (NTP keeps them within ms–s, which is huge next to a ms
    step), but a *barrier-backed* span — a train step, a gang
    scheduler's pass over a shared collective — starts near-
    simultaneously on every participant by construction. Aligning the
    start times of matched occurrences of such a span (matched by an
    occurrence attribute like ``step``, falling back to appearance
    order) and taking the median difference estimates each host's
    offset against the reference host; the median discards the
    straggle tail (stragglers shift *some* starts, skew shifts all).
  * :func:`merge` emits one Chrome trace-event document with one
    process track per host (Perfetto renders them stacked), every
    timestamp skew-corrected onto the reference host's clock.
  * :func:`summarize` reports per-host span-duration percentiles and
    names the straggler host per phase (span name): the host whose
    median duration is slowest, with its ratio against the fastest.

The JAX package's CLI over it, ``obs/merge.py``, is not ported.
"""

import dataclasses
import json
import os

from container_engine_accelerators_tpu_torch.obs import trace as obs_trace

# Span names tried (in order) as the skew-alignment barrier when the
# caller doesn't name one: the training loop's per-step span, the
# scheduler's pass span, the serving engine's chunk span.
DEFAULT_ALIGN_SPANS = ("step", "run_pass", "chunk")

# Occurrence-matching attributes tried on the align span: "step" matches
# train-step K on host A to train-step K on host B even when a host
# missed some occurrences.
DEFAULT_ALIGN_KEYS = ("step", "pass", "seq")

_SCHEMA_KEYS = ("name", "start_s", "dur_s", "thread", "parent")


class TraceInputError(ValueError):
    """Unusable merge input; the message names the file and the fix
    (the merge CLI prints it instead of a traceback)."""


def check_mergeable(traces, strict_meta=False):
    """Validate loaded traces before merging.

    Always rejected: spanless files (an empty JSONL, or a file that is
    not a ``--trace-out`` twin at all) and *mixed-epoch* inputs — some
    files carrying a ``__trace_meta__`` epoch while others don't, which
    would scatter hosts across unrelated clocks (epoch-0 spans land at
    wall second ~0, real epochs at ~1.7e9) and silently produce a
    garbage timeline. ``strict_meta`` additionally rejects inputs with
    NO meta record anywhere (the CLI's posture: hand-built files are a
    library feature, not a merge-CLI contract)."""
    empty = [t.path or t.host for t in traces if not t.spans]
    if empty:
        raise TraceInputError(
            f"no span records in {', '.join(empty)} — empty or not a "
            f"span JSONL. Pass the .jsonl twins that --trace-out "
            f"writes next to the Chrome JSON."
        )
    have = [t for t in traces if t.epoch_ns]
    missing = [t.path or t.host for t in traces if not t.epoch_ns]
    if have and missing:
        raise TraceInputError(
            f"mixed-epoch inputs: {', '.join(missing)} carry no "
            f"__trace_meta__ record while other inputs do — their "
            f"clocks cannot be placed on one timeline. Regenerate the "
            f"missing files with a current --trace-out (older files "
            f"predate the meta line)."
        )
    if strict_meta and missing:
        raise TraceInputError(
            f"no __trace_meta__ record in {', '.join(missing)} — the "
            f"merge CLI needs each file's host + wall-clock epoch "
            f"(written as the first line by every current --trace-out). "
            f"Regenerate the traces, or merge hand-built files via "
            f"obs.fleet.merge_files()."
        )


@dataclasses.dataclass
class HostTrace:
    host: str
    epoch_ns: int          # wall-clock ns of the tracer's t=0 (0 = unknown)
    spans: list            # raw JSONL records (schema keys + attrs)
    dropped: int = 0
    path: str = ""

    def wall_start(self, span):
        """Wall-clock start (seconds) of one span on THIS host's clock."""
        return self.epoch_ns * 1e-9 + span["start_s"]


def load_host_trace(path):
    """Read one host's span JSONL (Tracer.write_jsonl output).

    Files from before the meta record (or hand-built ones) still load:
    the host falls back to the file stem and the epoch to 0 — merging
    then assumes start_s values are already on a shared clock."""
    host = os.path.splitext(os.path.basename(path))[0]
    epoch_ns = 0
    dropped = 0
    spans = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("name") == obs_trace.JSONL_META_NAME:
                host = rec.get("host", host)
                epoch_ns = int(rec.get("epoch_ns", 0))
                dropped = int(rec.get("dropped_events", 0))
                continue
            spans.append(rec)
    return HostTrace(host=host, epoch_ns=epoch_ns, spans=spans,
                     dropped=dropped, path=path)


def _median(values):
    vs = sorted(values)
    n = len(vs)
    if not n:
        return 0.0
    mid = n // 2
    return vs[mid] if n % 2 else (vs[mid - 1] + vs[mid]) / 2.0


def _percentile(values, q):
    """Nearest-rank percentile of a non-empty list (q in [0, 1])."""
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(round(q * (len(vs) - 1)))))
    return vs[idx]


def _align_occurrences(trace, align_span, align_keys):
    """{occurrence_key: wall_start} for one host's align spans.

    The key is the span's first matching occurrence attribute (a step
    number, a pass index); spans without one key by appearance order, so
    plain repeated spans still align positionally."""
    out = {}
    seq = 0
    for span in trace.spans:
        if span["name"] != align_span:
            continue
        key = None
        for attr in align_keys:
            if attr in span and span[attr] is not None:
                key = (attr, span[attr])
                break
        if key is None:
            key = ("#", seq)
        seq += 1
        # First occurrence wins (re-entered spans of the same key would
        # skew the alignment toward retries).
        out.setdefault(key, trace.wall_start(span))
    return out


def pick_align_span(traces, candidates=DEFAULT_ALIGN_SPANS):
    """First candidate span name present on every host (None if none)."""
    for name in candidates:
        if all(any(s["name"] == name for s in t.spans) for t in traces):
            return name
    return None


def display_names(traces):
    """One unique label per trace, in order. Hostnames usually suffice,
    but two traces CAN share one (several worker processes on a node, a
    re-run merged with itself) — keying per-trace data by a colliding
    name would silently merge/overwrite, so duplicates get a #N suffix."""
    seen = {}
    names = []
    for t in traces:
        n = seen.get(t.host, 0) + 1
        seen[t.host] = n
        names.append(t.host if n == 1 else f"{t.host}#{n}")
    return names


def estimate_offsets(traces, align_span=None,
                     align_keys=DEFAULT_ALIGN_KEYS):
    """Per-trace clock offsets (seconds to ADD to a trace's wall times
    to land on the reference trace's clock), keyed by display name. The
    first trace is the reference (offset 0.0); traces sharing no align
    occurrences with the reference get 0.0 (uncorrected)."""
    if not traces:
        return {}
    if align_span is None:
        align_span = pick_align_span(traces)
    names = display_names(traces)
    offsets = {names[0]: 0.0}
    if align_span is None:
        for name in names[1:]:
            offsets[name] = 0.0
        return offsets
    ref = _align_occurrences(traces[0], align_span, align_keys)
    for name, t in zip(names[1:], traces[1:]):
        mine = _align_occurrences(t, align_span, align_keys)
        deltas = [ref[k] - mine[k] for k in mine.keys() & ref.keys()]
        offsets[name] = _median(deltas) if deltas else 0.0
    return offsets


def merge(traces, align_span=None, align_keys=DEFAULT_ALIGN_KEYS):
    """Merge per-host traces into one Chrome trace-event document.

    One process per host (pid = 1..N, process_name = host), thread
    tracks preserved within each host, every timestamp corrected by the
    estimated clock offset and rebased so the earliest span is t=0.
    Returns ``(chrome_doc, offsets)``."""
    if align_span is None:
        align_span = pick_align_span(traces)
    offsets = estimate_offsets(traces, align_span=align_span,
                               align_keys=align_keys)
    names = display_names(traces)
    t0 = None
    corrected = []  # (display_name, trace, [(span, corrected_wall)])
    for name, t in zip(names, traces):
        off = offsets.get(name, 0.0)
        rows = [(s, t.wall_start(s) + off) for s in t.spans]
        corrected.append((name, t, rows))
        for _, w in rows:
            t0 = w if t0 is None else min(t0, w)
    t0 = t0 or 0.0
    events = []
    for pid, (name, t, rows) in enumerate(corrected, start=1):
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name,
                     "epoch_ns": t.epoch_ns,
                     "clock_offset_s": round(offsets.get(name, 0.0), 6),
                     "dropped_events": t.dropped},
        })
        tids = {}
        for s, _ in rows:
            label = s.get("thread") or "main"
            if label not in tids:
                tids[label] = len(tids) + 1
        for label, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": label},
            })
        for s, wall in rows:
            args = {k: v for k, v in s.items() if k not in _SCHEMA_KEYS}
            if s.get("parent"):
                args["parent"] = s["parent"]
            events.append({
                "name": s["name"],
                "ph": "X",
                "ts": round((wall - t0) * 1e6, 3),
                "dur": round(s["dur_s"] * 1e6, 3),
                "pid": pid,
                "tid": tids[s.get("thread") or "main"],
                "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}, offsets


def summarize(traces, offsets=None, align_span=None,
              percentiles=(0.5, 0.9, 0.99)):
    """Fleet summary: per-host span-duration percentiles + the straggler
    host per phase (span name seen on 2+ hosts)."""
    per_host = {}
    by_span = {}  # name -> {host: [durations]}
    for host, t in zip(display_names(traces), traces):
        durs = {}
        for s in t.spans:
            durs.setdefault(s["name"], []).append(float(s["dur_s"]))
        per_host[host] = {
            name: {
                "count": len(vals),
                **{
                    f"p{int(q * 100)}_ms": round(
                        _percentile(vals, q) * 1e3, 3)
                    for q in percentiles
                },
                "max_ms": round(max(vals) * 1e3, 3),
            }
            for name, vals in sorted(durs.items())
        }
        for name, vals in durs.items():
            by_span.setdefault(name, {})[host] = vals
    stragglers = {}
    for name, hosts in sorted(by_span.items()):
        if len(hosts) < 2:
            continue
        medians = {h: _median(vals) for h, vals in hosts.items()}
        slow = max(medians, key=medians.get)
        fast = min(medians, key=medians.get)
        stragglers[name] = {
            "host": slow,
            "median_ms": round(medians[slow] * 1e3, 3),
            "fastest_host": fast,
            "fastest_median_ms": round(medians[fast] * 1e3, 3),
            "vs_fastest": round(
                medians[slow] / medians[fast], 3
            ) if medians[fast] > 0 else None,
        }
    return {
        "hosts": display_names(traces),
        "align_span": align_span,
        "clock_offsets_s": {
            h: round(o, 6) for h, o in (offsets or {}).items()
        },
        "per_host": per_host,
        "stragglers": stragglers,
    }


def merge_files(paths, align_span=None, align_keys=DEFAULT_ALIGN_KEYS):
    """Load + merge + summarize in one call (the CLI's core).
    Returns ``(chrome_doc, summary)``."""
    traces = [load_host_trace(p) for p in paths]
    if align_span is None:
        align_span = pick_align_span(traces)
    doc, offsets = merge(traces, align_span=align_span,
                         align_keys=align_keys)
    summary = summarize(traces, offsets=offsets, align_span=align_span)
    return doc, summary
