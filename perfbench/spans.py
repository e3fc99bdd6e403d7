"""The program's own spans of a traced run, laid on the profiler's timeline.

`repro_torch.obs.spans` records a span at each layer boundary of a fit
(``ddrf.select``; ``pack_problem`` and its ``pack.stage``, ``pack.gram``,
``pack.aux`` and ``pack.inverse``; ``solve`` and its ``solve.tol_read``;
``predict``), on the clock torch.profiler stamps its host and device
events with. The fit generator keeps only the ``pack_problem``
durations (``Records.pack_spans``); `spans_of` takes the rest from the
program's last finished recording, and only when its ``pack_problem``
spans are the ones the window kept. Against a program without those
spans every reader here returns None.

Run as a module, it runs one cell's traced window and prints, for each
span name, the host ms a fit, the self ms a fit and the device's idle
ms a profiled fit charged to it, and checks that every ``pack_problem``
span of the profiled fits lies inside the benchmark's ``pack`` label
(on the card; it exits 2 without one):

    python3 -m perfbench.spans --workload <name> --seed <n> --seconds <s>
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import sys

PACK = ("pack_problem", "pack.stage", "pack.gram", "pack.aux",
        "pack.inverse")


def spans_of(rec) -> list | None:
    """The program's spans of the window that ``rec`` records, or None."""
    try:
        from repro_torch.obs.spans import last_recording
    except ImportError:
        return None
    got = last_recording()
    if got is None or not rec.pack_spans:
        return None
    spans = list(got.spans)
    if [s.duration for s in spans
            if s.name == "pack_problem"] != list(rec.pack_spans):
        return None
    return spans


def host_ms_per_fit(rec, name: str) -> float | None:
    """Host ms a fit summed over the program's spans named ``name``."""
    spans = spans_of(rec)
    if spans is None:
        return None
    hits = [s.duration for s in spans if s.name == name]
    return sum(hits) / len(rec.pack_spans) * 1e3 if hits else None


def timeline(prof, label: str = "fit", phases: tuple = ()) -> dict | None:
    """The traced window of ``prof`` as `perfbench.trace.summarize` reads
    it, kept in the profiler's ns: its edges (the first and last
    ``label``), the merged intervals in which an operation ran on the
    device, and the host labels ``(name, start, end)``."""
    from perfbench import trace as btrace

    events = btrace._raw_events(prof, (label,) + tuple(phases))
    labels = [(n, s, e) for n, s, e, _, lab in events if lab]
    fits = [(s, e) for n, s, e in labels if n == label]
    if not fits:
        return None
    w0, w1 = min(s for s, _ in fits), max(e for _, e in fits)
    busy = btrace._union([(max(s, w0), min(e, w1))
                          for _, s, e, dev, _ in events
                          if dev and e > w0 and s < w1])
    return dict(window_ns=(w0, w1), busy_ns=busy, labels=labels)


def _gaps(tl: dict):
    w0, w1 = tl["window_ns"]
    edges = [w0] + [x for s, e in tl["busy_ns"] for x in (s, e)] + [w1]
    return [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]


def idle_by_span(tl: dict, spans) -> dict[str, float]:
    """Idle seconds of the window by the innermost program span open at
    each idle gap's midpoint (``outside`` where none is). The values sum
    to the window's idle time."""
    opened = sorted((s.t_start * 1e9, s.t_end * 1e9, s.name) for s in spans)
    starts = [o[0] for o in opened]
    idle = collections.Counter()
    for s, e in _gaps(tl):
        mid = (s + e) / 2
        owner = "outside"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if opened[i][1] > mid:      # nested: the latest open is innermost
                owner = opened[i][2]
                break
        idle[owner] += (e - s) * 1e-9
    return dict(idle)


def idle_seconds(tl: dict) -> float:
    return sum(e - s for s, e in _gaps(tl)) * 1e-9


def pack_margins(tl: dict, spans, label: str = "pack") -> list:
    """For each ``pack_problem`` span in the window, (µs from the start of
    the overlapping ``label`` to the span's start, µs from the span's end
    to the label's end): both at least 0 where the label holds the span.
    None where no such label overlaps it."""
    w0, w1 = tl["window_ns"]
    marks = [(s, e) for n, s, e in tl["labels"] if n == label]
    out = []
    for sp in spans:
        a, b = sp.t_start * 1e9, sp.t_end * 1e9
        if sp.name == "pack_problem" and b > w0 and a < w1:
            m = next(((a - s, e - b) for s, e in marks if s < b and a < e),
                     None)
            out.append(m and (m[0] * 1e-3, m[1] * 1e-3))
    return out


def split(spans, fits: int, idle: dict, traced: int) -> dict:
    """Per span name: spans a fit, host ms a fit, self ms a fit (less
    its children's time), and the idle ms a profiled fit charged to it
    (``idle``: `idle_by_span`)."""
    child = collections.Counter()
    for s in spans:
        if s.parent_id is not None:
            child[s.parent_id] += s.duration
    rows = collections.defaultdict(lambda: [0, 0.0, 0.0])
    for s in spans:
        row = rows[s.name]
        row[0] += 1
        row[1] += s.duration
        row[2] += s.duration - child[s.span_id]
    out = {name: dict(n=n / fits, host_ms=1e3 * host / fits,
                      self_ms=1e3 * own / fits,
                      idle_ms=1e3 * idle.get(name, 0.0) / traced)
           for name, (n, host, own) in rows.items()}
    out["outside"] = dict(n=0.0, host_ms=0.0, self_ms=0.0,
                          idle_ms=1e3 * idle.get("outside", 0.0) / traced)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from perfbench import run

    if not torch.cuda.is_available():
        print("perfbench.spans needs a CUDA card", file=sys.stderr)
        return 2

    run._use_checkout(run.ROOT)
    from repro_torch.obs.spans import last_recording

    cell = run.resolve(run.ROOT, args.workload)
    gen = run.generator(run.ROOT, cell.traffic["generator"])
    prob = gen.build(cell.config, cell.traffic, args.seed, "cuda")
    gen.warm_up(prob, True)
    win = gen.window(prob, args.seed, args.seconds, True)
    tl = timeline(win.profile, win.label, win.phases)
    spans = list(last_recording().spans)
    traced, fits = len(win.traced), len(win.pack_spans)
    idle = idle_by_span(tl, spans)
    rows = split(spans, fits, idle, traced)
    margins = pack_margins(tl, spans)
    inside = [m for m in margins if m is not None and min(m) >= 0]
    w0, w1 = tl["window_ns"]
    per = 1e3 / traced
    result = dict(
        workload=args.workload, seed=args.seed, fits=fits, traced=traced,
        window_ms=(w1 - w0) * 1e-9 * per, idle_ms=idle_seconds(tl) * per,
        charged_ms=sum(idle.values()) * per,
        pack_idle_ms=sum(rows[n]["idle_ms"] for n in PACK if n in rows),
        pack_spans=len(margins), pack_spans_inside=len(inside),
        pack_margin_us=[min(m[i] for m in margins if m) for i in (0, 1)]
        if any(margins) else None,
        spans=rows)
    print(f"{'span':<16} {'a fit':>6} {'host ms':>9} {'self ms':>9} "
          f"{'idle ms':>9}", file=sys.stderr)
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["idle_ms"]):
        print(f"{name:<16} {r['n']:>6.1f} {r['host_ms']:>9.3f} "
              f"{r['self_ms']:>9.3f} {r['idle_ms']:>9.3f}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0 if margins and len(inside) == len(margins) else 1


if __name__ == "__main__":
    sys.exit(main())
