"""The program's spans in the benchmark: idle gaps charged to the
innermost span, the span readers (and None where the spans are
missing), the readers that were there keeping their values, and the
program's ``pack_problem`` spans inside the benchmark's ``pack`` label
on the profiler's timeline (on the CPU and, marked ``gpu``, the card)."""
import pytest
import torch

from perfbench import roofline, run
from perfbench import spans as pspans
from perfbench import trace as btrace
from perfbench.generators import fitloop
from perfbench.tests.tinycell import ROOT, make_root
from repro_torch.obs import spans as obs_spans
from repro_torch.obs.metrics import FakeClock
from repro_torch.obs.spans import Span

NEW = {"pack_inverse_ms": "pack.inverse", "pack_stage_ms": "pack.stage",
       "ddrf_host_ms": "ddrf.select", "solve_wait_ms": "solve.tol_read"}
OLD = ("ddrf_ms", "pack_host_ms", "rff_gram_roofline", "solve_ms",
       "solve_rounds", "dekrr_solve_roofline", "fit_mfu_pct",
       "device_idle_pct", "kernels_per_fit")


def _span(name, t0_ns, t1_ns, span_id=0, parent_id=None):
    return Span(name=name, t_start=t0_ns * 1e-9, t_end=t1_ns * 1e-9,
                depth=0, parent=None, thread="MainThread", attrs={},
                span_id=span_id, parent_id=parent_id)


def test_idle_by_span_charges_the_innermost_open_span():
    """Gaps at 0-100 (inside A, after its closed child D), 200-400
    (inside A's child B), 500-900 (inside C) and 950-1000 (no span)."""
    tl = dict(window_ns=(0, 1000), busy_ns=[[100, 200], [400, 500],
                                            [900, 950]], labels=[])
    spans = [_span("A", 0, 600), _span("D", 10, 40), _span("B", 250, 350),
             _span("C", 650, 800)]
    got = pspans.idle_by_span(tl, spans)
    want = {"A": 100e-9, "B": 200e-9, "C": 400e-9, "outside": 50e-9}
    assert got == pytest.approx(want, abs=1e-15)
    assert sum(got.values()) == pytest.approx(pspans.idle_seconds(tl),
                                              abs=1e-15)
    assert pspans.idle_by_span(tl, []) == pytest.approx(
        {"outside": 750e-9}, abs=1e-15)


def test_split_gives_host_self_and_idle_a_fit():
    spans = [s for k in (0, 3) for s in (
        _span("pack_problem", 0, 600, k + 1),
        _span("pack.aux", 100, 500, k + 2, k + 1),
        _span("pack.inverse", 200, 300, k + 3, k + 2))]
    rows = pspans.split(spans, fits=2, idle={"pack.inverse": 4e-6,
                                             "outside": 2e-6}, traced=2)
    assert rows["pack_problem"]["host_ms"] == pytest.approx(600e-6)
    assert rows["pack_problem"]["self_ms"] == pytest.approx(200e-6)
    assert rows["pack.aux"]["self_ms"] == pytest.approx(300e-6)
    assert rows["pack.inverse"]["idle_ms"] == pytest.approx(2e-3)
    assert rows["outside"]["idle_ms"] == pytest.approx(1e-3)
    assert rows["pack.aux"]["n"] == 1.0


def _recorded(pack_seconds=(0.25, 0.5)):
    """A finished recording of two fits on a fake clock, and the records
    a window of them would hand the readers."""
    clock = FakeClock(100.0)
    with obs_spans.recording(clock=clock) as rec:
        for secs in pack_seconds:
            for _ in range(3):
                with obs_spans.span("ddrf.select"):
                    clock.advance(0.001)
            with obs_spans.span("pack_problem"):
                with obs_spans.span("pack.stage"):
                    clock.advance(0.002)
                with obs_spans.span("pack.aux"):
                    with obs_spans.span("pack.inverse"):
                        clock.advance(secs)
            with obs_spans.span("solve"):
                for _ in range(2):
                    with obs_spans.span("solve.tol_read"):
                        clock.advance(0.003)
    packs = [s.duration for s in rec.spans if s.name == "pack_problem"]
    return fitloop.Records(fits=[dict(i=i) for i in range(len(packs))],
                           pack_spans=packs, profile=None, shape=None)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_span_readers_read_the_window_recording(metric):
    rec = _recorded()
    want = {"pack_inverse_ms": 375.0, "pack_stage_ms": 2.0,
            "ddrf_host_ms": 3.0, "solve_wait_ms": 6.0}[metric]
    assert run.reader(ROOT, metric)(rec) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_span_readers_return_none_without_the_spans(metric, monkeypatch):
    read = run.reader(ROOT, metric)
    rec = _recorded()
    assert read(fitloop.Records(fits=[], pack_spans=[], profile=None,
                                shape=None)) is None
    _recorded(pack_seconds=(0.125,))       # another recording closed since
    assert read(rec) is None
    rec = _recorded()
    monkeypatch.delattr(obs_spans, "last_recording")   # a program without
    assert read(rec) is None


def test_span_reader_returns_none_where_a_span_never_opened():
    clock = FakeClock()
    with obs_spans.recording(clock=clock) as rec:
        with obs_spans.span("pack_problem"):
            clock.advance(0.01)
    records = fitloop.Records(fits=[{}], pack_spans=[0.01], profile=None,
                              shape=None)
    assert rec.spans and pspans.spans_of(records) == rec.spans
    for metric in NEW:
        assert run.reader(ROOT, metric)(records) is None


def _fixed_records():
    shape = lambda rounds: roofline.FitShape(
        d=4, dims=[3, 2], n_train=[10, 8], n_test=[5, 4],
        neighbours=[[1], [0]], candidates=[60, 40], rounds=rounds)
    fits = [dict(i=i, wall_s=0.02 + 0.001 * i, rounds=32 + 8 * i,
                 failed=False, traced=i in (1, 2),
                 phases=dict(ddrf=0.004 + 1e-4 * i, pack=0.011,
                             solve=0.002 * (i + 1), predict=0.001))
           for i in range(4)]
    profile = dict(fit_ids=[1, 2], window_s=0.05, busy_s=0.02, device=[
        ("void rff_gram_kernel<double>(double*)", 0.003),
        ("dekrr_solve_resident_kernel", 0.002),
        ("Memcpy HtoD (Pageable -> Device)", 0.001),
        ("elementwise_kernel", 0.004)],
        gaps={"pack": 0.02, "solve": 0.01})
    return fitloop.Records(fits=fits, pack_spans=[0.012, 0.013, 0.014],
                           profile=profile, shape=shape)


def test_existing_readers_keep_their_values():
    """The readers the benchmark had, on one fixed record, give the
    values they gave before the program's spans were added."""
    got = {m: run.reader(ROOT, m)(_fixed_records()) for m in OLD}
    want = {"ddrf_ms": 4.15, "pack_host_ms": 13.0, "solve_ms": 5.0,
            "solve_rounds": 44.0, "device_idle_pct": 60.0,
            "kernels_per_fit": 1.5,
            "rff_gram_roofline": 3.868656716417911e-05,
            "dekrr_solve_roofline": 2.5313432835820896e-05,
            "fit_mfu_pct": 1.1544602568552586e-06}
    assert got == pytest.approx(want, rel=1e-12)


def test_traced_run_reports_the_span_metrics(tmp_path):
    root = make_root(tmp_path)
    res, _ = run.run_cell(root, "tiny-fit", 2**31 + 11, 0.3, True,
                          device="cpu")
    got = {m: res["metrics"][m]["value"] for m in NEW}
    assert all(v > 0 for v in got.values()), got
    assert got["pack_inverse_ms"] + got["pack_stage_ms"] \
        < res["metrics"]["pack_host_ms"]["value"]
    for m in ("ddrf_ms", "pack_host_ms", "solve_ms", "solve_rounds",
              "fit_mfu_pct"):
        assert m in res["metrics"]


def _traced_window(tmp_path, device):
    root = make_root(tmp_path)
    cell = run.resolve(root, "tiny-fit")
    prob = fitloop.build(cell.config, cell.traffic, 2**31 + 13, device)
    fitloop.warm_up(prob, True)
    win = fitloop.window(prob, 2**31 + 13, 0.3, True)
    tl = pspans.timeline(win.profile, win.label, win.phases)
    spans = list(obs_spans.last_recording().spans)
    assert [s.duration for s in spans if s.name == "pack_problem"] \
        == win.pack_spans
    return win, tl, spans


def _check_window(win, tl, spans):
    """Every pack_problem span of the profiled fits lies inside the
    benchmark's pack label, and the idle time charged to the spans and
    ``outside`` is the window's."""
    margins = pspans.pack_margins(tl, spans)
    assert len(margins) == len(win.traced)
    assert all(m is not None and min(m) >= 0 for m in margins), margins
    idle = pspans.idle_by_span(tl, spans)
    assert sum(idle.values()) == pytest.approx(pspans.idle_seconds(tl),
                                               rel=1e-9)
    summary = btrace.summarize(win.profile, win.traced, win.label,
                               win.phases)
    assert pspans.idle_seconds(tl) == pytest.approx(
        summary["window_s"] - summary["busy_s"], rel=1e-9, abs=1e-12)


def test_pack_spans_lie_inside_the_pack_label_on_cpu(tmp_path):
    _check_window(*_traced_window(tmp_path, "cpu"))


def test_spans_tool_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pspans.main(["--workload", "wave-fit", "--seed", "1",
                        "--seconds", "1"]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err


@pytest.mark.gpu
def test_pack_spans_lie_inside_the_pack_label_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    win, tl, spans = _traced_window(tmp_path, "cuda")
    assert tl["busy_ns"]
    _check_window(win, tl, spans)
