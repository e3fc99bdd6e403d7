"""The fit traffic: one caller fitting DeKRR-DDRF models back to back.

A generator of the benchmark: `perfbench/run.py` finds it by the name a
mix gives under ``generator`` and drives it through ``build``,
``warm_up``, ``window``, ``check`` and ``records``. Every mix that names
it is a data file (``traffic/<name>.json``) of parameters: the c_nei
grid the fits cycle over (× N_train), the candidate pools drawn per
node, the Gram and solve backends and the solve's rounds between tol
checks, the warm-up fits, and the whole fits a traced run profiles. A
configuration file (``configs/<name>.json``) gives the data, the
partition, the features and the solver.

Fit i, on the program (`repro_torch`):

1. c_i = c_grid[i mod |grid|] × N_train, pool i mod pools_per_node;
2. energy DDRF selection of D_j features from the pool, every node;
3. `DeKRRSolver(..., build_aux=False)` and `pack_problem` (Eq. 17);
4. `solve_batched` to tol (Eq. 19);
5. every node's test predictions, then a device sync.

Inputs are made on the host in NumPy, so the reference gets the very
same arrays: the data and its partition from the configuration's
``data_seed``, the candidate pools from the run's seed. A generator for
another solver reuses ``build``, ``warm_up``, ``window`` and ``check``
with its own ``fit`` and reference passed in.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import sys
import time
import traceback

import numpy as np
import torch

from perfbench import check as bcheck
from perfbench import data as bdata
from perfbench import reference, roofline

PHASES = ("ddrf", "pack", "solve", "predict")


def _log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Problem:
    """A cell's inputs, on the host and staged on the device."""

    cfg: dict
    traffic: dict
    device: torch.device
    dims: list[int]                 # D_j
    neighbours: list[list[int]]     # slot order [(j+s1), (j-s1), (j+s2), ...]
    train: list[tuple[np.ndarray, np.ndarray]]
    test: list[tuple[np.ndarray, np.ndarray]]
    pools: list[list[tuple[np.ndarray, np.ndarray]]]   # [pool][node]
    n_train: int
    topology: object = None
    train_dev: list = None
    test_dev: list = None
    pools_dev: list = None

    def c_of(self, i: int) -> float:
        grid = self.traffic["c_grid"]
        return float(grid[i % len(grid)]) * self.n_train

    def pool_of(self, i: int) -> int:
        return i % int(self.traffic["pools_per_node"])

    def shape(self, rounds: int = 0) -> roofline.FitShape:
        return roofline.FitShape(
            d=int(self.cfg["d"]), dims=list(self.dims),
            n_train=[x.shape[1] for x, _ in self.train],
            n_test=[x.shape[1] for x, _ in self.test],
            neighbours=self.neighbours,
            candidates=[int(self.cfg["candidate_ratio"]) * dj
                        for dj in self.dims],
            rounds=rounds, chunk=int(self.traffic["solve_chunk"]),
            word=np.dtype(self.cfg["dtype"]).itemsize)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def circulant_slots(num_nodes: int, offsets) -> list[list[int]]:
    """Neighbours of each node in ring-shift slot order."""
    return [[(j + sign * s) % num_nodes for s in offsets for sign in (1, -1)]
            for j in range(num_nodes)]


def _expect(cfg: dict, key: str, got) -> None:
    if key in cfg and cfg[key] != got:
        raise ValueError(f"configuration states {key} {cfg[key]!r}; the "
                         f"generated inputs have {got!r}")


def make_inputs(cfg: dict, traffic: dict, seed: int) -> dict:
    """Host arrays of a cell: the stand-in dataset of the configuration's
    (d, N), its partition and per-node train/test halves (from the
    configuration's ``data_seed``: the data is the configuration's, as a
    user's data set is given), D_j, and the candidate pools (from the
    run's seed). The generated sizes are held to the ones the
    configuration states (d, N and, where given, each node's samples
    and features)."""
    if cfg["data"] != "stand-in":
        raise ValueError(f"data {cfg['data']!r}: only the stand-in exists")
    data_seed, n = int(cfg["data_seed"]), int(cfg["N"])
    full = bdata.DATASET_SPECS[cfg["dataset"]][1]
    x, y = bdata.make_dataset(cfg["dataset"], seed=data_seed,
                              subsample=n if n < full else None)
    _expect(cfg, "d", x.shape[0])
    _expect(cfg, "N", x.shape[1])
    num_nodes = int(cfg["nodes"])
    if cfg["partition"] == "imbalanced":
        sizes, mode = bdata.imbalanced_sizes(n, num_nodes), "iid"
    else:
        sizes, mode = None, cfg["partition"]
    nodes = bdata.partition(x, y, num_nodes, mode=mode, sizes=sizes,
                            seed=data_seed)
    _expect(cfg, "node_samples", [nx.shape[1] for nx, _ in nodes])
    train, test = bdata.train_test_split_nodes(nodes, seed=data_seed)
    n_j = [tx.shape[1] for tx, _ in train]
    if cfg["feature_allocation"] == "sqrt_proportional":
        dims = bdata.sqrt_proportional_d(n_j, int(cfg["dbar"]))
    else:
        dims = [int(cfg["dbar"])] * num_nodes
    _expect(cfg, "node_features", dims)
    rng = np.random.default_rng([seed % 2**64, 1])
    sigma, ratio, d = float(cfg["sigma"]), int(cfg["candidate_ratio"]), x.shape[0]
    pools = []
    for _ in range(int(traffic["pools_per_node"])):
        pools.append([(rng.normal(size=(ratio * dj, d)) / sigma,
                       rng.uniform(0.0, 2 * np.pi, size=ratio * dj))
                      for dj in dims])
    return dict(train=train, test=test, dims=dims, pools=pools)


def build(cfg: dict, traffic: dict, seed: int,
          device: str | torch.device) -> Problem:
    """Make a cell's inputs and stage them on ``device`` in the
    configuration's ``dtype``."""
    from repro_torch.core import FeatureMap, NodeData, circulant

    if cfg["topology"] != "circulant":
        raise ValueError(f"topology {cfg['topology']!r} is not supported")
    device = torch.device(device)
    inputs = make_inputs(cfg, traffic, seed)
    num_nodes = int(cfg["nodes"])
    offsets = tuple(int(s) for s in cfg["offsets"])
    prob = Problem(
        cfg=cfg, traffic=traffic, device=device, dims=inputs["dims"],
        neighbours=circulant_slots(num_nodes, offsets),
        train=inputs["train"], test=inputs["test"], pools=inputs["pools"],
        n_train=sum(x.shape[1] for x, _ in inputs["train"]))
    dtype = np.dtype(cfg["dtype"])
    as_t = lambda a: torch.as_tensor(a.astype(dtype, copy=False),
                                     device=device)
    prob.topology = circulant(num_nodes, offsets)
    prob.train_dev = [NodeData(x=as_t(x), y=as_t(y)) for x, y in prob.train]
    prob.test_dev = [as_t(x) for x, _ in prob.test]
    prob.pools_dev = [[FeatureMap(omega=as_t(om), bias=as_t(b),
                                  kind=cfg["feature_kind"])
                       for om, b in pool] for pool in prob.pools]
    return prob


class Phases:
    """Per-fit phase clock of a traced run: a device sync at both ends of
    each phase and a profiler label around it. Off, it does nothing."""

    def __init__(self, prob: Problem, on: bool):
        self.prob, self.on = prob, on
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        self.prob.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            self.prob.sync()
        self.times[name] = time.perf_counter() - t0


def fit(prob: Problem, i: int, phases: Phases | None = None) -> dict:
    """Fit i on the program. Returns its outputs (device tensors) and the
    rounds run; the caller times it."""
    from repro_torch.core import DeKRRConfig, DeKRRSolver, select_features
    from repro_torch.dist import pack_problem, solve_batched, unpack_theta

    cfg, tr = prob.cfg, prob.traffic
    phases = phases or Phases(prob, False)
    pool = prob.pools_dev[prob.pool_of(i)]
    with phases("ddrf"):
        fmaps = [select_features(None, int(cfg["d"]), prob.dims[j],
                                 float(cfg["sigma"]), nd.x, nd.y,
                                 method=cfg["ddrf"], candidates=pool[j])
                 for j, nd in enumerate(prob.train_dev)]
    with phases("pack"):
        solver = DeKRRSolver(
            prob.topology, fmaps, prob.train_dev,
            DeKRRConfig(lam=float(cfg["lam"]), c_nei=prob.c_of(i),
                        c_self_ratio=float(cfg["c_self_ratio"])),
            build_aux=False, device=prob.device)
        packed = pack_problem(solver, gram_backend=tr["gram_backend"],
                              device=prob.device)
    with phases("solve"):
        theta, rounds = solve_batched(
            packed, int(cfg["max_rounds"]), backend=tr["solve_backend"],
            tol=float(cfg["tol"]), chunk_rounds=int(tr["solve_chunk"]),
            return_rounds=True)
    with phases("predict"):
        th = unpack_theta(packed, theta)
        preds = [solver.predict(th, x, node=j)
                 for j, x in enumerate(prob.test_dev)]
        prob.sync()
    return dict(i=i, fmaps=fmaps, packed=packed, theta=theta, preds=preds,
                rounds=int(rounds),
                failed=int(rounds) >= int(cfg["max_rounds"]))


def to_host(prob: Problem, out: dict) -> dict:
    """A fit's outputs as host arrays in the comparison's layout: the
    selected pool rows (by index; -1 where a row is not the pool's), the
    packed Eq. 17 operands, θ [J, D_max] and the predictions."""
    host = lambda t: t.detach().cpu().numpy()
    pool = prob.pools[prob.pool_of(out["i"])]
    dtype = np.dtype(prob.cfg["dtype"])
    sel = []
    for j, fm in enumerate(out["fmaps"]):
        om, b = host(fm.omega), host(fm.bias)
        p_om = pool[j][0].astype(dtype, copy=False)
        p_b = pool[j][1].astype(dtype, copy=False)
        rows = {p_om[r].tobytes() + p_b[r:r + 1].tobytes(): r
                for r in range(p_om.shape[0])}
        sel.append(np.array([rows.get(om[r].tobytes() + b[r:r + 1].tobytes(),
                                      -1) for r in range(om.shape[0])]))
    pk = out["packed"]
    return dict(i=out["i"], c=prob.c_of(out["i"]), rounds=out["rounds"],
                sel=sel, g=host(pk.g), d=host(pk.d), s=host(pk.s),
                p=host(pk.p), nbr_idx=host(pk.nbr_idx),
                theta=host(out["theta"]), pred=[host(p) for p in out["preds"]])


def _counters():
    return (importlib.import_module("repro_torch.kernels.ops"),
            importlib.import_module("repro_torch.kernels.dekrr_solve"))


def warm_up(prob: Problem, trace: bool, fit=fit) -> None:
    """The mix's warm-up fits (every grid point, every shape the window
    uses), the profiler's own start when traced, and the launch counters
    set to zero."""
    for i in range(int(prob.traffic["warmup_fits"])):
        fit(prob, i)
    if trace:   # the profiler's own start-up belongs to set-up
        with torch.profiler.profile():
            fit(prob, 0)
    prob.sync()
    kops, kds = _counters()
    kops.reset_launch_counts()
    for key in kds.ROUTE_LAUNCHES:
        kds.ROUTE_LAUNCHES[key] = 0


@dataclasses.dataclass
class Window:
    """What the measured window left: every fit's record, the fits kept
    for the check (one per c_nei grid point, drawn from the seed), the
    clocks, the program's pack spans and the profile around it."""

    fits: list[dict]
    kept: dict
    attempted: int
    failed: int
    t_start: float
    t_end: float
    pack_spans: list[float]
    profile: object          # the finished torch.profiler.profile, or None
    traced: list[int]        # ids of the profiled fits
    end_to_end: dict         # the mix's end-to-end values (set-up aside)
    label: str = "fit"       # the profiler label of one unit of work
    phases: tuple = PHASES   # the labels inside it


def window(prob: Problem, seed: int, seconds: float, trace: bool,
           fit=fit) -> Window:
    """Fits back to back until the first fit boundary after ``seconds``.
    Traced, every fit syncs around its phases, the program's spans are
    recorded and the profiler records the mix's ``trace_fits`` whole
    fits after ``trace_skip``. The objects alive before the window are
    frozen out of the collector, so its passes scan only the window's."""
    from repro_torch.obs.spans import recording

    tr = prob.traffic
    skip, n_trace = int(tr["trace_skip"]), int(tr["trace_fits"])
    grid = len(tr["c_grid"])
    pick = np.random.default_rng([seed % 2**64, 2])
    kept, seen = {}, [0] * grid
    fits, attempted, failed, prof = [], 0, 0, None
    activities = [torch.profiler.ProfilerActivity.CPU]
    if prob.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with recording() if trace else contextlib.nullcontext() as spans:
        gc.collect()
        gc.freeze()
        t_start = time.perf_counter()
        k = 0
        while True:
            traced = trace and skip <= k < skip + n_trace
            if traced and k == skip:
                prof = torch.profiler.profile(activities=activities)
                prof.start()
            phases = Phases(prob, trace)
            attempted += 1
            f0 = time.perf_counter()
            try:
                if traced:
                    with torch.profiler.record_function("fit"):
                        out = fit(prob, k, phases)
                else:
                    out = fit(prob, k, phases)
            except Exception:           # a failed fit is counted, not fatal
                _log(f"fit {k} raised:\n{traceback.format_exc()}")
                out = None
            f1 = time.perf_counter()
            if traced and k == skip + n_trace - 1:
                prof.stop()
            if out is None or out["failed"]:
                failed += 1
            if out is not None:
                fits.append(dict(i=k, wall_s=f1 - f0, rounds=out["rounds"],
                                 failed=out["failed"], traced=traced,
                                 phases=dict(phases.times)))
                r = k % grid
                seen[r] += 1
                if pick.random() < 1.0 / seen[r]:
                    kept[r] = out
            out = None
            k += 1
            if f1 - t_start >= seconds and not (trace and k < skip + n_trace):
                break
        gc.unfreeze()
    walls = [f["wall_s"] for f in fits]
    return Window(
        fits=fits, kept=kept, attempted=attempted, failed=failed,
        t_start=t_start, t_end=f1,
        pack_spans=([s.duration for s in spans.spans
                     if s.name == "pack_problem"] if spans else []),
        profile=prof, traced=[f["i"] for f in fits if f["traced"]],
        end_to_end=dict(
            fit_ms=(f1 - t_start) / max(len(walls), 1) * 1e3,
            fit_p95_ms=(float(np.percentile(walls, 95)) * 1e3 if walls
                        else float("nan"))))


def describe(prob: Problem, win: Window) -> list[str]:
    """Lines for standard error: the fits by grid point, and the
    program's launches by kernel and by route."""
    kops, kds = _counters()
    grid = len(prob.traffic["c_grid"])
    by_grid = [[f for f in win.fits if f["i"] % grid == r]
               for r in range(grid)]
    blocks = np.array_split(np.array([f["wall_s"] for f in win.fits]), 10)
    return [
        "mean fit ms by tenth of the window: " + ", ".join(
            f"{1e3 * b.mean():.2f}" for b in blocks if b.size),
        "fits by grid point (n, mean ms, mean rounds): " + "; ".join(
            f"{len(fs)}, {1e3 * np.mean([f['wall_s'] for f in fs]):.3f}, "
            f"{np.mean([f['rounds'] for f in fs]):.1f}"
            for fs in by_grid if fs),
        f"launches {kops.launch_counts()}",
        "route launches " + json.dumps(
            {f"{n}/{r}": v for (n, r), v in kds.ROUTE_LAUNCHES.items()
             if v})]


def check(prob: Problem, win: Window, control: bool = False,
          ref=reference.fit) -> tuple[dict, dict | None]:
    """The kept fits against the float64 reference, once the program's
    device state is freed: each number's worst over them. With
    ``control``, also the control on the same fits: the reference in
    float32 put in the program's place, held to the float64 reference
    by the same numbers."""
    hosts = [to_host(prob, win.kept[r]) for r in sorted(win.kept)]
    win.kept.clear()
    prob.train_dev = prob.test_dev = prob.pools_dev = None
    gc.collect()
    if prob.device.type == "cuda":
        torch.cuda.empty_cache()
    cfg, readings, lows = prob.cfg, [], []
    c0 = time.perf_counter()
    for h in hosts:
        args = (prob.pools[prob.pool_of(h["i"])], prob.train, prob.test,
                prob.dims, prob.neighbours)
        kw = dict(c_nei=h["c"], c_self_ratio=float(cfg["c_self_ratio"]),
                  lam=float(cfg["lam"]), num_rounds=h["rounds"])
        want = reference.pad(ref(*args, **kw), max(prob.dims))
        readings.append(bcheck.compare(h, want))
        if control:
            low = reference.pad(ref(*args, dtype=np.float32, **kw),
                                max(prob.dims))
            lows.append(bcheck.compare(low, want))
    _log(f"checked fits {[h['i'] for h in hosts]} (rounds "
         f"{[h['rounds'] for h in hosts]}) in "
         f"{time.perf_counter() - c0:.3f} s")
    return (bcheck.worst(readings),
            bcheck.worst(lows, best=True) if control else None)


@dataclasses.dataclass
class Records:
    """What a traced run hands each per-layer metric's reader."""

    fits: list[dict]             # the window's fits: i, wall_s, rounds,
                                 # failed, phases {name: s}, traced
    pack_spans: list[float]      # the program's pack_problem spans (s)
    profile: dict | None         # perfbench.trace.summarize of the traced fits
    shape: object                # rounds -> roofline.FitShape


def records(prob: Problem, win: Window, summary: dict | None) -> Records:
    return Records(fits=win.fits, pack_spans=win.pack_spans,
                   profile=summary, shape=prob.shape)
