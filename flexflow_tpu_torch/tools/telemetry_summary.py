"""Render a run_telemetry.jsonl into a step-time / compile-time /
search / resilience / fidelity table (flexflow_tpu's
tools/telemetry_summary.py: the same sections and text for the same
records; the port's obs/ writes the reference's schema).

Usage:
    python -m flexflow_tpu_torch.tools.telemetry_summary
        <run_telemetry.jsonl | trace-dir> [--allow-torn-tail]

Accepts either the JSONL itself or the trace_dir holding it.  Metrics
are cumulative snapshots, so for re-drained runs the latest record per
name wins (ties broken by file order).  See docs/OBSERVABILITY.md for
the record schema.

Unreadable lines are an ERROR, not a silent skip: a summary that
quietly dropped records would misreport the run.  A killed run may
leave torn line(s) at the FILE TAIL; --allow-torn-tail tolerates
exactly those (reported to stderr with a count); corruption anywhere
else always exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Tuple

#: the serving phases a request trace's spans bucket into, in report
#: order (the reference's tools/trace_analyze.py PHASES; spec_verify
#: overlaps decode rather than extending the critical path)
PHASES = ("queue", "dispatch", "prefill", "migration", "kv_adopt",
          "decode", "spec_verify")


class TornTelemetryError(Exception):
    """Unparseable run_telemetry.jsonl line(s).  `bad` holds
    (lineno, detail) pairs; `tail_only` is True when every bad line
    sits after the last good record (a killed run's torn tail)."""

    def __init__(self, bad: List[Tuple[int, str]], tail_only: bool):
        self.bad = bad
        self.tail_only = tail_only
        where = "tail" if tail_only else "mid-file"
        super().__init__(
            f"{len(bad)} unreadable telemetry line(s) ({where}): "
            f"line(s) {[ln for ln, _ in bad]}")


def load_records(path: str, allow_torn_tail: bool = False
                 ) -> Tuple[List[Dict], List[Tuple[int, str]]]:
    """(records, torn_lines).  Raises TornTelemetryError on any
    unparseable line, unless every bad line is at the file tail and
    `allow_torn_tail` is set: then the torn tail is returned for the
    caller to report."""
    if os.path.isdir(path):
        path = os.path.join(path, "run_telemetry.jsonl")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    out: List[Dict] = []
    bad: List[Tuple[int, str]] = []
    last_good = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
                last_good = lineno
            except json.JSONDecodeError as e:
                bad.append((lineno, str(e)))
    tail_only = bool(bad) and all(ln > last_good for ln, _ in bad)
    if bad and not (allow_torn_tail and tail_only):
        raise TornTelemetryError(bad, tail_only)
    return out, bad


def latest_by_name(records: List[Dict], kinds) -> Dict[str, Dict]:
    """Last record per name among `kinds` (cumulative snapshots: the
    newest drain supersedes older ones)."""
    out: Dict[str, Dict] = {}
    for rec in records:
        if rec.get("kind") in kinds and "name" in rec:
            out[rec["name"]] = rec
    return out


def trace_report(records: List[Dict]) -> Dict:
    """The request traces among the records (`"kind": "span"`, written
    by a serving run's request tracer): spans grouped by trace_id into
    one tree each, the shared batch spans (trace_id None) by span_id,
    each trace's connectivity (one root, every parent present), its
    total (the root's duration) and its time per phase, the slowest
    first.  The reference's trace_analyze.analyze, less the
    percentiles."""
    traces: Dict[str, List[Dict]] = {}
    batch: Dict[int, Dict] = {}
    for rec in records:
        if rec.get("kind") != "span":
            continue
        if rec.get("trace_id") is None:
            batch[rec["span_id"]] = rec
        else:
            traces.setdefault(rec["trace_id"], []).append(rec)
    rows, disconnected = [], []
    for tid, spans in traces.items():
        ids = {s["span_id"] for s in spans}
        roots = [s for s in spans if s.get("parent_id") is None]
        orphans = [s for s in spans if s.get("parent_id") is not None
                   and s["parent_id"] not in ids]
        if len(roots) != 1 or orphans:
            disconnected.append((tid, orphans))
        phases: Dict[str, float] = {}
        for s in spans:
            if s["name"] in PHASES:
                phases[s["name"]] = (phases.get(s["name"], 0.0)
                                     + float(s.get("dur_us", 0.0)))
            for ref in (s.get("args") or {}).get("batch_spans") or ():
                b = batch.get(ref)
                if b is not None and b["name"] == "spec_verify":
                    phases["spec_verify"] = (phases.get("spec_verify", 0.0)
                                             + float(b.get("dur_us", 0.0)))
        total = (float(roots[0].get("dur_us", 0.0)) if roots else
                 sum(float(s.get("dur_us", 0.0)) for s in spans
                     if s["name"] in PHASES))
        rows.append({"trace_id": tid, "total_us": total,
                     "spans": len(spans), "phases": phases})
    rows.sort(key=lambda r: -r["total_us"])
    return {"traces": len(rows), "spans": sum(r["spans"] for r in rows),
            "batch_spans": len(batch), "requests": rows,
            "disconnected": disconnected}


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _section(title: str, rows: List[tuple]) -> str:
    if not rows:
        return ""
    w = max(len(k) for k, _ in rows) + 2
    lines = [title, "-" * len(title)]
    lines += [f"{k:<{w}}{_fmt(v)}" for k, v in rows]
    return "\n".join(lines) + "\n"


def _hist(rec: Dict) -> str:
    """A histogram's streaming summary on one row."""
    return (f"n={rec.get('count', 0)} mean={_fmt(rec.get('mean', 0.0))} "
            f"min={_fmt(rec.get('min', 0.0))} "
            f"max={_fmt(rec.get('max', 0.0))}")


def _rows(metrics: Dict[str, Dict], keep) -> List[tuple]:
    """(name past its group, value or histogram summary) of each metric
    whose name `keep` admits, by name."""
    return [(name.split("/", 1)[1],
             _hist(rec) if rec.get("kind") == "histogram"
             else rec.get("value", 0.0))
            for name, rec in sorted(metrics.items()) if keep(name)]


def _serving_rows(metrics: Dict[str, Dict]) -> List[tuple]:
    """The Serving section: one composite line per feature that ran
    (prefix cache, tensor-parallel replicas, the disaggregated fleet,
    the paged kernel, speculative decoding), then every serving/ row."""
    rows = []

    def value(name):
        return metrics.get(name, {}).get("value", 0)

    hits = metrics.get("serving/prefix_hits")
    hit_toks = metrics.get("serving/prefix_hit_tokens")
    if hits is not None or hit_toks is not None:
        rows.append((
            "prefix cache",
            f"hits={int((hits or {}).get('value', 0))} "
            f"hit_tokens={int((hit_toks or {}).get('value', 0))} "
            f"shared_blocks={int(value('serving/kv_shared_blocks'))} "
            f"evictions={int(value('serving/prefix_evictions'))}",
        ))
    tp = metrics.get("serving/tp_degree")
    if tp is not None:
        rows.append((
            "tensor parallel",
            f"degree={int(tp.get('value', 1))} "
            f"chips={int(metrics.get('serving/tp_chips', {}).get('value', 1))} "
            f"kv_block_bytes_per_chip="
            f"{int(value('serving/tp_kv_block_bytes_per_chip'))} "
            f"kv_pool_bytes_per_chip="
            f"{int(value('serving/tp_kv_pool_bytes_per_chip'))}",
        ))
    mig = metrics.get("serving/disagg_migrate_decisions")
    rep = metrics.get("serving/disagg_reprefill_decisions")
    if mig is not None or rep is not None:
        rows.append((
            "disaggregated fleet",
            f"migrate={int((mig or {}).get('value', 0))} "
            f"reprefill={int((rep or {}).get('value', 0))} "
            f"migrations_done={int(value('serving/kv_migration_done'))} "
            f"failed={int(value('serving/kv_migration_failed'))} "
            f"bytes={int(value('serving/kv_migration_bytes'))} "
            f"blocks={int(value('serving/kv_migration_blocks'))}",
        ))
    blocks = metrics.get("serving/paged_kernel_blocks_read")
    if blocks is not None:
        rows.append((
            "paged kernel",
            f"blocks_read={int(blocks.get('value', 0))} "
            f"bytes_read={int(value('serving/paged_kernel_bytes_read'))} "
            f"dense_bytes_avoided="
            f"{int(value('serving/paged_dense_bytes_avoided'))}",
        ))
    prop = metrics.get("serving/spec_proposed")
    if prop is not None:
        per_round = metrics.get("serving/spec_accepted_per_round", {})
        n_prop = int(prop.get("value", 0))
        n_acc = int(value("serving/spec_accepted"))
        rate = n_acc / n_prop if n_prop else 0.0
        rows.append((
            "speculative",
            f"accept_rate={rate:.3f} ({n_acc}/{n_prop}) "
            f"tokens/round={_fmt(per_round.get('mean', 0.0))} "
            f"rounds={int(value('serving/spec_rounds'))} "
            f"rounds/s="
            f"{_fmt(metrics.get('serving/spec_rounds_per_s', {}).get('value', 0.0))}",
        ))
    return rows + _rows(metrics, lambda n: n.startswith("serving/"))


def _tracing_rows(records: List[Dict]) -> List[tuple]:
    """Span counts and the three slowest requests with their phase
    split (the full report is the reference's trace_analyze)."""
    report = trace_report(records)
    if not report["traces"]:
        return []
    rows = [
        ("traces recorded", report["traces"]),
        ("spans", report["spans"]),
        ("spans/trace", round(report["spans"] / report["traces"], 1)),
        ("shared batch spans", report["batch_spans"]),
    ]
    if report["disconnected"]:
        rows.append(("DISCONNECTED trees", len(report["disconnected"])))
    for r in report["requests"][:3]:
        split = " ".join(f"{p}={r['phases'][p] / 1e3:.2f}ms"
                         for p in PHASES if p in r["phases"])
        rows.append((f"slowest {r['trace_id']}",
                     f"total={r['total_us'] / 1e3:.2f}ms {split}"))
    return rows


def summarize(records: List[Dict]) -> str:
    metrics = latest_by_name(records, {"counter", "gauge", "histogram"})
    out: List[str] = []

    step = metrics.get("fit/step_ms")
    rows = []
    if step:
        rows += [
            ("steps", step.get("count", 0)),
            ("dispatch ms mean", step.get("mean", 0.0)),
            ("dispatch ms min/max",
             f"{_fmt(step.get('min', 0.0))} / {_fmt(step.get('max', 0.0))}"),
        ]
    epoch = metrics.get("fit/epoch_s")
    if epoch:
        rows.append(("epoch s mean", epoch.get("mean", 0.0)))
    tput = metrics.get("fit/throughput_sps")
    if tput:
        rows.append(("throughput samples/s", tput.get("value", 0.0)))
    out.append(_section("Steps", rows))

    out.append(_section("Compile (ms)", [
        (name.split("/", 1)[1] if "/" in name else name,
         rec.get("value", 0.0))
        for name, rec in sorted(metrics.items())
        if name.startswith("compile/")]))
    out.append(_section("Search", [
        (name.split("/", 2)[-1], rec.get("value", 0.0))
        for name, rec in sorted(metrics.items())
        if name.startswith("search/")]))
    # remote_* renders under Durability
    out.append(_section("Store", _rows(
        metrics, lambda n: n.startswith("store/")
        and not n.startswith("store/remote_"))))
    out.append(_section("Resilience", [
        (name.split("/", 1)[1], rec.get("value", 0.0))
        for name, rec in sorted(metrics.items())
        if name.startswith("resilience/")
        and not name.startswith("resilience/offload_")]))
    # the remote checkpoint tier's uploads, verifications and
    # degradations, and the strategy store's fleet-mirror traffic
    out.append(_section("Durability", _rows(
        metrics, lambda n: n.startswith(("resilience/offload_",
                                         "store/remote_")))))
    # the compiled placement's predicted comm split per tier
    out.append(_section("Comm", [
        (name.split("/", 1)[1], rec.get("value", 0.0))
        for name, rec in sorted(metrics.items())
        if name.startswith("comm/")]))
    # the searched remat plan's saved-activation bytes and the recompute
    # seconds it pays
    out.append(_section("Memory", [
        (name.split("/", 1)[1], rec.get("value", 0.0))
        for name, rec in sorted(metrics.items())
        if name.startswith("mem/") or name == "compute/recompute_s"]))
    out.append(_section("Serving", _serving_rows(metrics)))
    out.append(_section("Tracing", _tracing_rows(records)))

    rows = []
    for rec in records:
        if rec.get("kind") != "fidelity":
            continue
        rows += [
            ("source", rec.get("source", "?")),
            ("predicted step ms", rec.get("predicted_step_ms")),
            ("measured step ms", rec.get("measured_step_ms")),
            ("predicted / measured", rec.get("predicted_vs_measured")),
            ("mesh", json.dumps(rec.get("mesh_axes", {}))),
            ("calibrated", rec.get("calibrated", False)),
        ]
    out.append(_section("Fidelity", rows))

    logs = [r for r in records
            if r.get("kind") == "event" and r.get("name") == "log"]
    if logs:
        lines = ["Log events", "----------"]
        for r in logs[-20:]:
            f = r.get("fields", {})
            lines.append(
                f"[{f.get('level', '?')}] {f.get('logger', '?')}: "
                f"{f.get('message', '')}"
            )
        out.append("\n".join(lines) + "\n")

    body = "\n".join(s for s in out if s)
    return body if body.strip() else "no telemetry records found\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path", help="run_telemetry.jsonl or the trace dir")
    p.add_argument("--allow-torn-tail", action="store_true",
                   help="tolerate unreadable line(s) at the FILE TAIL "
                        "(a killed run's torn write); mid-file "
                        "corruption still exits non-zero")
    args = p.parse_args(argv)
    try:
        records, torn = load_records(
            args.path, allow_torn_tail=args.allow_torn_tail)
    except FileNotFoundError as e:
        print(f"error: no telemetry file at {e}", file=sys.stderr)
        return 1
    except TornTelemetryError as e:
        hint = (" (re-run with --allow-torn-tail to tolerate a "
                "killed run's torn tail)" if e.tail_only else "")
        print(f"error: {e}{hint}", file=sys.stderr)
        return 1
    if torn:
        print(f"warning: skipped {len(torn)} torn tail line(s): "
              f"{[ln for ln, _ in torn]}", file=sys.stderr)
    sys.stdout.write(summarize(records))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
