"""Flight-recorder forensics viewer: render the JSON-lines dump offline.

The port's copy of the repo's ``tools/flightrec.py``: it reads the dumps
of ``baikaldb_tpu_torch`` (``handle flightrec dump``; the record layout is
the JAX package's, with the card's memory stats under ``device_stats``).
The recorder itself lives in the engine process (obs/flightrec.py, one
bounded ring per Database); live inspection is SQL —
``SELECT * FROM information_schema.flight_recorder`` — and the export is
``handle flightrec dump '/path/records.jsonl'`` (or
``FlightRecorder.dump()`` from Python).  This tool is the postmortem half:
point it at a dump file and it lists the summaries, or expands one
record's full forensic bundle (plan text, trace spans as a tree, engine
counter deltas, per-device memory stats, exchange summary).

Usage:
  python -m baikaldb_tpu_torch.tools.flightrec records.jsonl             # summary table
  python -m baikaldb_tpu_torch.tools.flightrec records.jsonl --bundles   # bundled only
  python -m baikaldb_tpu_torch.tools.flightrec records.jsonl --show 7    # one full record
  python -m baikaldb_tpu_torch.tools.flightrec records.jsonl --show 7 --json
"""

from __future__ import annotations

import argparse
import json
import sys


def load(path: str) -> list[dict]:
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                recs.append(json.loads(line))
    return recs


def fmt_summary(recs: list[dict]) -> str:
    cols = ("rec_id", "status", "dur_ms", "rows", "query_id", "conn_id")
    lines = ["%6s  %-7s %10s %8s %8s %8s  %-9s %s"
             % (tuple(cols) + ("bundle", "query"))]
    for r in recs:
        lines.append("%6s  %-7s %10.2f %8s %8s %8s  %-9s %s" % (
            r.get("rec_id", "?"), r.get("status", "?"),
            float(r.get("dur_ms", 0.0)), r.get("rows", 0),
            r.get("query_id", 0), r.get("conn_id", 0),
            "yes" if r.get("bundle") else "",
            (r.get("text") or "")[:60].replace("\n", " ")))
    return "\n".join(lines)


def _span_tree(spans: list[dict]) -> list[str]:
    """Indent spans by parent chain (same shape obs/trace.span_tree gives,
    re-derived here so the viewer has no engine import)."""
    by_parent: dict = {}
    for sp in spans:
        by_parent.setdefault(sp.get("parent_id") or "", []).append(sp)
    roots = by_parent.get("", []) or spans[:1]
    out: list[str] = []

    def walk(sp: dict, depth: int) -> None:
        attrs = sp.get("attrs") or {}
        extra = " ".join(f"{k}={v}" for k, v in attrs.items()
                         if k != "text")
        out.append("  " * depth + "%-28s %9.3f ms  %s"
                   % (sp.get("name", "?"), float(sp.get("dur_ms", 0.0)),
                      extra))
        for c in by_parent.get(sp.get("span_id"), []):
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    return out


def fmt_record(r: dict) -> str:
    lines = [f"record {r.get('rec_id')}  status={r.get('status')}  "
             f"dur={float(r.get('dur_ms', 0.0)):.2f}ms  "
             f"rows={r.get('rows', 0)}",
             f"query: {r.get('text', '')}"]
    if r.get("error"):
        lines.append(f"error: {r['error']}")
    if r.get("phase_ms"):
        lines.append("phases: " + "  ".join(
            f"{k}={float(v):.2f}ms" for k, v in r["phase_ms"].items()))
    b = r.get("bundle")
    if not b:
        lines.append("(no forensic bundle — query was fast and clean)")
        return "\n".join(lines)
    if b.get("metric_delta"):
        lines.append("counter deltas over the query:")
        for k, v in sorted(b["metric_delta"].items()):
            lines.append(f"  {k:32s} +{v:g}")
    if b.get("exchange"):
        lines.append(f"exchange: {json.dumps(b['exchange'], default=str)}")
    if b.get("device_stats"):
        lines.append("devices:")
        for d in b["device_stats"]:
            peak = d.get("peak_bytes_in_use") or d.get("bytes_in_use")
            lines.append(f"  {d.get('device', '?'):24s} "
                         + (f"peak={peak:.0f}B" if peak is not None else ""))
    if b.get("spans"):
        lines.append(f"trace spans ({len(b['spans'])}):")
        lines.extend("  " + s for s in _span_tree(b["spans"]))
    if b.get("plan"):
        lines.append("plan:")
        lines.extend("  " + pl for pl in str(b["plan"]).split("\n"))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="JSON-lines dump from "
                                 "handle flightrec dump / dump()")
    ap.add_argument("--show", type=int, default=None, metavar="REC_ID",
                    help="expand one record's forensic bundle")
    ap.add_argument("--bundles", action="store_true",
                    help="list only records carrying a bundle")
    ap.add_argument("--json", action="store_true",
                    help="raw JSON instead of the rendered view")
    args = ap.parse_args(argv)
    recs = load(args.path)
    if args.show is not None:
        match = [r for r in recs if r.get("rec_id") == args.show]
        if not match:
            print(f"no record {args.show} in {args.path}", file=sys.stderr)
            return 1
        print(json.dumps(match[0], indent=2, default=str) if args.json
              else fmt_record(match[0]))
        return 0
    if args.bundles:
        recs = [r for r in recs if r.get("bundle")]
    print(json.dumps(recs, indent=2, default=str) if args.json
          else fmt_summary(recs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
