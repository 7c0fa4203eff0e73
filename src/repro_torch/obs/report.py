"""Run-report renderer for flight-recorder traces (port of
``repro.obs.report``; the same text for the same records).

    PYTHONPATH=src python -m repro_torch.obs.report run.jsonl [--md report.md]

Reads a schema-v1 JSONL trace (:mod:`repro_torch.obs.trace`), validates
it, and renders
a terminal summary — per-stage byte waterfall, staleness histogram, time
breakdown, eval-cadence series (gaps print as ``-``), and a claims-ready
``metric,value`` block — optionally also written as markdown.  Stdlib only.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.trace import validate_file

_BAR = 28


def _fmt_bytes(b: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("kB", 1e3)):
        if abs(b) >= div:
            return f"{b / div:.2f}{unit}"
    return f"{b:.0f}B"


def _bar(frac: float) -> str:
    n = max(0, min(_BAR, round(frac * _BAR)))
    return "#" * n + "." * (_BAR - n)


def summarize(records: list) -> dict:
    """Fold the record stream into one summary dict (pure data — render
    below turns it into text)."""
    meta = records[0]
    spans, flushes = {}, 0
    stages_up, stages_down = [], []
    rounds = []
    for r in records[1:]:
        if r.get("type") == "span":
            k = r["kind"]
            cnt, tot = spans.get(k, (0, 0.0))
            spans[k] = (cnt + 1, tot + float(r["dur_s"]))
        elif r["kind"] == "stages":
            stages_up, stages_down = r.get("up", []), r.get("down", [])
        elif r["kind"] == "round":
            rounds.append(r["m"])
        elif r["kind"] == "flush" or (r.get("type") == "event"
                                      and r["kind"] == "flush"):
            flushes += 1

    def col(name):
        return [m.get(name) for m in rounds]

    def vecsum(name):
        out = None
        for m in rounds:
            v = m.get(name)
            if not isinstance(v, list):
                continue
            vals = [0.0 if x is None else float(x) for x in v]
            out = vals if out is None else [a + b for a, b in zip(out, vals)]
        return out or []

    def scalarsum(name):
        return sum(float(x) for x in col(name) if x is not None)

    up = vecsum("round_stats.up_stage_bytes")
    down = vecsum("round_stats.down_stage_bytes")
    series = {}
    for name in sorted({k for m in rounds for k in m}):
        vals = col(name)
        if any(isinstance(v, list) for v in vals):
            continue
        if any(v is None for v in vals) and any(v is not None for v in vals):
            series[name] = vals          # cadence-gapped metric
    return {
        "meta": meta,
        "n_rounds": len(rounds),
        "spans": spans,
        "flushes": flushes,
        "stages_up": stages_up,
        "stages_down": stages_down,
        "up_stage_bytes": up,
        "down_stage_bytes": down,
        "staleness_hist": vecsum("round_stats.staleness_hist"),
        "uplink_wire": scalarsum("ledger.uplink_wire"),
        "downlink_wire": scalarsum("ledger.downlink_wire"),
        "uplink_dense": scalarsum("ledger.uplink_dense"),
        "loss": [v for v in col("loss") if v is not None],
        "gapped": series,
        "store": {k: scalarsum(f"round_stats.store_{k}")
                  for k in ("hits", "misses", "evictions",
                            "sketch_recovered")},
    }


def render(s: dict, md: bool = False) -> str:
    h1 = (lambda t: f"# {t}") if md else (lambda t: f"== {t} ==")
    h2 = (lambda t: f"## {t}") if md else (lambda t: f"-- {t} --")
    out = []
    meta = {k: v for k, v in s["meta"].items()
            if k not in ("v", "kind", "schema", "ts")}
    out.append(h1("run report"))
    out.append(" ".join(f"{k}={v}" for k, v in sorted(meta.items()))
               or "(no run metadata)")
    out.append(f"rounds recorded: {s['n_rounds']}")

    # ---------------------------------------------------------- byte waterfall
    out.append("")
    out.append(h2("uplink byte waterfall (per stage, whole run)"))
    names = s["stages_up"] or [f"stage[{i}]"
                               for i in range(len(s["up_stage_bytes"]))]
    total = sum(s["up_stage_bytes"]) or 1.0
    if s["up_stage_bytes"]:
        w = max(len(n) for n in names)
        for n, b in zip(names, s["up_stage_bytes"]):
            out.append(f"  {n:<{w}}  {_fmt_bytes(b):>10}  "
                       f"{_bar(b / total)} {100.0 * b / total:5.1f}%")
    else:
        out.append("  (no RoundStats rows — run with FLConfig.telemetry "
                   "/ --trace)")
    dn = sum(s["down_stage_bytes"]) if s["down_stage_bytes"] else 0.0
    out.append(f"  uplink total {_fmt_bytes(sum(s['up_stage_bytes']))}  "
               f"downlink total {_fmt_bytes(dn)}")
    if s["uplink_dense"] and s["uplink_wire"]:
        out.append(f"  compression vs dense f32: "
                   f"{s['uplink_dense'] / s['uplink_wire']:.1f}x")

    # ------------------------------------------------------ staleness histogram
    hist = s["staleness_hist"]
    if hist and sum(hist) > 0:
        out.append("")
        out.append(h2("staleness histogram (async arrivals)"))
        edges = [0, 1, 2, 4, 8, 16, 32, 64]
        tot = sum(hist)
        for i, c in enumerate(hist):
            lo = edges[i]
            hi = f"<{edges[i + 1]}" if i + 1 < len(edges) else "+"
            out.append(f"  tau {lo:>3}{hi:<4} {int(c):>6}  "
                       f"{_bar(c / tot)}")
        if s["flushes"]:
            out.append(f"  buffer flushes: {s['flushes']}")

    # ----------------------------------------------------------- store counters
    st = s["store"]
    if any(st.values()):
        out.append("")
        out.append(h2("residual store"))
        out.append("  " + "  ".join(f"{k}={int(v)}"
                                    for k, v in st.items()))

    # ------------------------------------------------------------ time breakdown
    if s["spans"]:
        out.append("")
        out.append(h2("time breakdown (host spans)"))
        wall = sum(t for _, t in s["spans"].values()) or 1.0
        for k, (cnt, tot) in sorted(s["spans"].items(),
                                    key=lambda kv: -kv[1][1]):
            out.append(f"  {k:<12} x{cnt:<4} {tot:8.3f}s  "
                       f"{_bar(tot / wall)} {100.0 * tot / wall:5.1f}%")

    # --------------------------------------------------- cadence-gapped series
    for name, vals in s["gapped"].items():
        out.append("")
        out.append(h2(f"{name} (eval cadence; - = skipped round)"))
        shown = vals if len(vals) <= 24 else vals[-24:]
        out.append("  " + " ".join("-" if v is None else f"{v:.3f}"
                                   for v in shown))

    # ------------------------------------------------------- claims-ready rows
    out.append("")
    out.append(h2("claims-ready rows"))
    rows = [("rounds", s["n_rounds"]),
            ("uplink_wire_mb", round(s["uplink_wire"] / 1e6, 4)),
            ("downlink_wire_mb", round(s["downlink_wire"] / 1e6, 4))]
    if s["uplink_dense"] and s["uplink_wire"]:
        rows.append(("compression_x",
                     round(s["uplink_dense"] / s["uplink_wire"], 2)))
    if s["loss"]:
        rows += [("loss_first", round(s["loss"][0], 4)),
                 ("loss_last", round(s["loss"][-1], 4))]
    for k, (cnt, tot) in sorted(s["spans"].items()):
        rows.append((f"wall_s_{k}", round(tot, 3)))
    fence = "```" if md else ""
    if fence:
        out.append(fence)
    out += [f"{k},{v}" for k, v in rows]
    if fence:
        out.append(fence)
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="render a flight-recorder JSONL trace")
    ap.add_argument("trace", help="JSONL file written via --trace")
    ap.add_argument("--md", default="", metavar="PATH",
                    help="also write a markdown rendering here")
    args = ap.parse_args(argv)
    records = validate_file(args.trace)
    s = summarize(records)
    print(render(s, md=False), end="")
    if args.md:
        with open(args.md, "w") as fh:
            fh.write(render(s, md=True))
        print(f"wrote {args.md}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
