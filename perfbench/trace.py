"""Reading the profiler's trace of the traced fits.

`summarize` takes a finished `torch.profiler.profile` over whole units
of a generator's work, each inside a label (a fit: ``fit``) with its
phases labelled inside it (a fit's: ``ddrf``, ``pack``, ``solve`` and
``predict``, `perfbench.generators.fitloop.Phases`), and returns the
device operations inside the traced window, the window's length, the
seconds in which an operation ran on the device, and the idle gaps
labelled by the phase the host was in.
"""
from __future__ import annotations

import collections
import re

_TEMPLATE = re.compile(r"<[^<>]*>")


def base_name(name: str) -> str:
    """A kernel's name without return type, namespaces, template or
    arguments: ``void (anonymous namespace)::rff_gram_kernel<double>(...)``
    → ``rff_gram_kernel``."""
    s = name.replace("(anonymous namespace)", "anon")
    while True:
        t = _TEMPLATE.sub("", s)
        if t == s:
            break
        s = t
    s = s.split("(")[0].split()
    return s[-1].split("::")[-1] if s else name


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy",
                                "cudaMemset"))


def _raw_events(prof, names):
    """(name, start_ns, end_ns, on_device, is_label) from the profiler."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        name, start = ev.name(), ev.start_ns()
        on_dev = ev.device_type() == DeviceType.CUDA
        if on_dev and (name in names or ev.is_user_annotation()):
            continue            # a label's projection on the device timeline
        out.append((name, start, start + ev.duration_ns(), on_dev,
                    (not on_dev) and name in names))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof, fit_ids: list[int], label: str = "fit",
              phases: tuple = ()) -> dict:
    """The profile of the units ``fit_ids``, each inside ``label``."""
    events = _raw_events(prof, (label,) + tuple(phases))
    labels = [(n, s, e) for n, s, e, _, lab in events if lab]
    fits = [(s, e) for n, s, e in labels if n == label]
    if not fits:
        return dict(fit_ids=fit_ids, window_s=0.0, busy_s=0.0, device=[],
                    gaps={})
    w0, w1 = min(s for s, _ in fits), max(e for _, e in fits)
    device = [(n, max(s, w0), min(e, w1)) for n, s, e, dev, _ in events
              if dev and e > w0 and s < w1]
    busy = _union([(s, e) for _, s, e in device])
    marks = sorted((s, e, n) for n, s, e in labels if n in phases)
    gaps = collections.Counter()
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        owner = next((n for ps, pe, n in marks if ps <= mid < pe), "between")
        gaps[owner] += (e - s) * 1e-9
    return dict(fit_ids=fit_ids, window_s=(w1 - w0) * 1e-9,
                busy_s=sum(e - s for s, e in busy) * 1e-9,
                device=[(n, (e - s) * 1e-9) for n, s, e in device],
                gaps=dict(gaps))


def device_seconds(summary: dict, prefix: str) -> tuple[float, int]:
    """Device seconds and launches of the kernels whose base name starts
    with ``prefix``."""
    hits = [t for n, t in summary["device"]
            if is_kernel(n) and base_name(n).startswith(prefix)]
    return sum(hits), len(hits)


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    idle seconds by what the host was doing."""
    by_op = collections.Counter()
    for n, t in summary["device"]:
        by_op[base_name(n) if is_kernel(n) else n] += t
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])
    return dict(device_ops=[[n, t] for n, t in by_op.most_common(top)],
                idle_gaps=[[n, t] for n, t in gaps[:top]])
