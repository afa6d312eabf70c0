"""One cell of ``BENCHMARK.json``, run through the measured package's own
training loop: its set-up, its measured window, its traced stretch and the
check of what the window's own chunk function computed.

The cell is data: ``BENCHMARK.json`` names its configuration and traffic,
``configs/<config>.json`` holds the configuration's sizes,
``traffic/<traffic>.json`` the protocol (walkers, iterations a chunk,
Metropolis steps, how many chunks warm up and how many are traced),
``workloads/<cell>.json`` the limits of its correctness check,
``metrics/<metric>.py`` one reader per per-layer metric and
``kernels/<kernel>.py`` one file per kernel of the package (the symbol it
runs as, and its frozen work count).

The entry that the window drives is ``cli.common.run_training_loop``,
composed as the two CLIs compose it (``cli/ground_state.py`` and
``cli/finite_t.py`` ``_run``, argparse aside).  The window opens when the
last warm-up row has been delivered and closes at the first chunk boundary
after ``seconds``: the harness's ``print_row`` raises ``StopWindow``
there, and the loop itself is not changed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import re
import subprocess
import time
from pathlib import Path

import torch

import check
import counts
import reference
import tracesum

HERE = Path(__file__).resolve().parent
# Top-level module names that no run may load (compared whole: the measured
# package's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "fermiflow_tpu")


class StopWindow(Exception):
    """Raised from ``print_row`` at the chunk boundary that ends a run."""


def forbidden_modules(modules) -> list:
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def _load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_map() -> dict:
    """{LAUNCHES key: module with SYMBOL and work(shapes)}, one file each."""
    return {p.stem: load_module(p) for p in sorted((HERE / "kernels").glob(
        "*.py"))}


def cell_spec(root: Path, name: str) -> dict:
    """Everything a run of cell ``name`` needs, read from the files."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"({', '.join(cells)})")
    cell = cells[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def reported(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if reported(m)]
    moved = {m["name"] for m in e2e}
    return dict(
        name=name, cell=cell, conf=_load_json(root / conf_entry["file"]),
        traffic=_load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        limits=_load_json(HERE / "workloads" / f"{name}.json")["limits"],
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"]
                   if m["moves"] in moved and reported(m)])


def kept_out_spec(name: str) -> dict:
    """What a run of cell ``name`` (``<config>.<traffic>``) needs, for a
    cell that waits for the program and that BENCHMARK.json does not hold
    (PERF.md, Open questions): its configuration, traffic and (where it
    has one) limits files, and no metrics."""
    config, traffic = name.split(".", 1)
    limits = HERE / "workloads" / f"{name}.json"
    return dict(
        name=name, cell=dict(name=name, config=config, traffic=traffic,
                             chips=1),
        conf=_load_json(HERE / "configs" / f"{config}.json"),
        traffic=_load_json(HERE / "traffic" / f"{traffic}.json"),
        limits=_load_json(limits)["limits"] if limits.exists() else {},
        end_to_end=[], per_layer=[])


def shapes(spec: dict) -> dict:
    """The configuration and the traffic in one dict, with the Hermite
    depths and the sampler's steps an iteration worked out."""
    c = dict(spec["conf"], **spec["traffic"])
    c["sampler_steps"] = (c["mcmc_steps"] if c["persistent_walkers"]
                          else c["equilibrium_steps"])
    nx, ny, _ = reference.ho2d_tables()
    c["gs_depth"] = int(max(nx[:c["nup"]].max(), ny[:c["nup"]].max())) + 1
    if c["kind"] == "finite_t":
        c["ms_depth"] = reference.Model(c).num
    return c


def program_config(spec: dict, seed: int, device: str, workdir: Path):
    """The package's ``Config`` for this cell: every key of the
    configuration and traffic files that is one of its fields, the seed,
    and an iteration count beyond what a window holds."""
    import dataclasses

    from fermiflow_tpu_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    given = {k: v for k, v in {**spec["conf"], **spec["traffic"]}.items()
             if k in fields}
    return Config(**given, seed=seed, iternum=10**9, device=device,
                  metrics_path=str(workdir / "metrics.jsonl"))


# ---- what the check reads of the program ----


def _leaves(state) -> dict:
    """{leaf name: the live parameter} of the state, flow and logits."""
    out = {f"{m}.{k}": p for m, mod in (("eta", state.flow.eta),
                                        ("mu", state.flow.mu))
           if mod is not None for k, p in mod.items()}
    if state.log_state_weights is not None:
        out["logits"] = state.log_state_weights
    return out


def _snapshot(state) -> dict:
    return {k: p.detach().clone() for k, p in _leaves(state).items()}


def _adam_gradient(state) -> dict:
    """The gradient that Adam took at its first step, from its first moment
    after that step: exp_avg = (1 - b1) g (0 where it took none)."""
    opt = state.optimizer.state
    return {k: opt[p]["exp_avg"].detach().clone() / (1 - reference.ADAM_B1)
            if "exp_avg" in opt.get(p, {}) else torch.zeros_like(p.detach())
            for k, p in _leaves(state).items()}


class FirstSteps:
    """What the program did in its first three iterations, at K = 1, where
    each iteration is a chunk of its own and the state after each row says
    it: each one's walkers (and states) as the sampler handed them on, the
    gradient Adam took at the first, the parameters before the first and
    after the third.  (At K > 1 the walkers of an iteration inside a chunk
    are the chunk's own, and only the last iteration's are read:
    ``last_iteration``.)"""

    def __init__(self, state):
        self.state = state
        self.theta0 = _snapshot(state)
        self.inputs, self.grad1, self.theta3 = [], None, None

    def row(self, n_row: int):
        """After row ``n_row`` has been delivered."""
        if n_row > 3:
            return
        st = self.state
        self.inputs.append((st.walkers_cm.detach().clone(),
                            None if st.state_idx is None
                            else st.state_idx.clone()))
        if n_row == 1:
            self.grad1 = _adam_gradient(st)
        if n_row == 3:
            self.theta3 = _snapshot(st)

    def complete(self) -> bool:
        return len(self.inputs) == 3 and self.theta3 is not None


def last_iteration(state, rec: dict) -> dict:
    """The chunk's last iteration as the state says after it: its walkers
    (and states), the parameters, Adam's moments and step count after its
    step, the gradient it handed the optimizer (each leaf's ``grad``) and
    its row.  Read from the state's own tensors and the optimizer's, not
    from inside the chunk."""
    opt = state.optimizer.state
    leaves = _leaves(state)
    held = lambda k, p: opt.get(p, {}).get(k)
    clone = lambda t: None if t is None else t.detach().clone()
    return dict(
        theta={k: clone(p) for k, p in leaves.items()},
        grad={k: clone(p.grad) for k, p in leaves.items()},
        m={k: clone(held("exp_avg", p)) for k, p in leaves.items()},
        v={k: clone(held("exp_avg_sq", p)) for k, p in leaves.items()},
        steps={k: (0.0 if held("step", p) is None else float(held("step", p)))
               for k, p in leaves.items()},
        z_cm=clone(state.walkers_cm), states=clone(state.state_idx),
        row={k: float(v) for k, v in rec.items()
             if isinstance(v, (int, float))})


# ---- the window ----


class Window:
    """Counts the delivered rows: warm-up, the measured window, then (with
    ``trace_chunks``) the traced stretch; calls ``on_close(row)`` at the
    chunk boundary that closes the window and raises ``StopWindow`` at the
    one where the run ends."""

    def __init__(self, K: int, warmup_chunks: int, seconds: float,
                 trace_chunks: int, tracer, on_close=lambda rec: None):
        self.K, self.seconds, self.on_close = K, seconds, on_close
        self.warmup = warmup_chunks * K
        self.trace_iters = trace_chunks * K
        self.tracer = tracer
        self.rows = 0
        self.t_open = self.t_close = None
        self.iters = 0  # delivered in the window
        self.traced = 0
        self.nonfinite = 0

    def row(self, rec: dict, key: str):
        self.rows += 1
        now = time.perf_counter()
        if self.t_open is None:
            if self.rows == self.warmup:
                self.t_open = now
            return
        if self.t_close is None:
            self.iters += 1
            self.nonfinite += not math.isfinite(rec[key])
            if self.iters % self.K == 0 and now - self.t_open >= self.seconds:
                self.t_close = now
                self.on_close(rec)
                if not self.trace_iters:
                    raise StopWindow
                self.tracer.start()
            return
        self.traced += 1
        if self.traced == self.trace_iters:
            self.tracer.stop()
            raise StopWindow

    @property
    def iter_ms(self) -> float:
        """The window's wall time over the iterations it delivered."""
        return 1e3 * (self.t_close - self.t_open) / self.iters


class Tracer:
    """A ``torch.profiler`` trace of the stretch after the window: the
    device's kernels and the host's operations, and the launch counts the
    package's wrappers and replays add meanwhile."""

    def __init__(self, workdir: Path, cuda: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        self.prof = profile(activities=acts)
        self.cuda, self.path = cuda, workdir / "trace.json"
        self.launches = None

    def start(self):
        from fermiflow_tpu_torch.ops import _build

        self._before = dict(_build.LAUNCHES)
        self.prof.start()

    def stop(self):
        from fermiflow_tpu_torch.ops import _build

        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        self.launches = {k: v - self._before[k]
                         for k, v in _build.LAUNCHES.items()}
        self.prof.export_chrome_trace(str(self.path))

    def events(self) -> dict:
        with open(self.path) as fh:
            return json.load(fh)


class Context:
    """What a per-layer metric's reader reads (``metrics/*.py``)."""

    def __init__(self, shapes_: dict, kernels: dict, window: Window,
                 spans: list, tracer: Tracer):
        self.c, self.kernels = shapes_, kernels
        self.wall_ms_per_iter = window.iter_ms
        self.chunk_call_ms = 1e3 * sum(
            d for t, d in spans if window.t_open <= t < window.t_close
        ) / window.iters
        trace = tracer.events()
        self.summary = tracesum.summarize(trace)
        self.idle_gaps = tracesum.idle_gaps(trace)
        self.iters = window.traced
        self.launches = tracer.launches
        self.kernel_events = [(e["name"], float(e["dur"]) / 1e3)
                              for e in trace.get("traceEvents", [])
                              if e.get("ph") == "X" and "dur" in e
                              and e.get("cat") == "kernel"]
        self.busy_ms_per_iter = (self.summary.get("device_busy_ms", 0.0)
                                 / self.iters)
        own = re.compile("|".join(k.SYMBOL for k in kernels.values()))
        self.other_kernels_ms = sum(ms for name, ms in self.kernel_events
                                    if not own.search(name)) / self.iters

    def kernel_ms(self, key: str):
        """Device ms a launch of kernel ``key`` in the traced chunks, or
        None where it did not run or shares its symbol with another kernel
        that ran."""
        symbol = self.kernels[key].SYMBOL
        ran = [k for k, m in self.kernels.items()
               if m.SYMBOL == symbol and self.launches.get(k)]
        if ran != [key]:
            return None
        ms = sum(d for name, d in self.kernel_events if re.search(symbol,
                                                                   name))
        return ms / self.launches[key] if ms > 0 else None

    def roofline(self, key: str):
        ms = self.kernel_ms(key)
        if ms is None:
            return None
        return 100.0 * counts.bound_ms(*self.kernels[key].work(self.c))[0] / ms

    def step_mfu(self) -> float:
        flops = sum(self.kernels[k].work(self.c)[0] * n
                    for k, n in self.launches.items() if n)
        return 100.0 * (flops / self.iters) / (
            1e-3 * self.wall_ms_per_iter * counts.H100_FP32_FLOPS)


# ---- a run ----


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str, t0: float, workdir: Path, hooks=None,
             keep: bool = False) -> dict:
    """One run of the cell.  ``t0`` is the process's start on the
    ``time.perf_counter`` clock.  ``hooks`` (planted faults: the tests and
    ``calibrate.py``) may replace parts of the timed path under what the
    check reads: a callable taking (model, state), called before anything
    runs.  ``keep`` adds what the check read to the result (for the
    control)."""
    from fermiflow_tpu_torch import train
    from fermiflow_tpu_torch.cli import common
    from fermiflow_tpu_torch.utils import MetricsLogger

    marks = {"imports": time.perf_counter()}
    workdir.mkdir(parents=True, exist_ok=True)
    c = shapes(spec)
    cfg = program_config(spec, seed, device, workdir)
    finite = c["kind"] == "finite_t"
    K = cfg.steps_per_call
    if finite:
        model, params = common.build_beta(cfg)
        state = train.init_beta_state(model, params, cfg,
                                      params["log_state_weights"].device)
        make = lambda k: train.make_multi_step(
            train.make_beta_train_step(model, cfg), k)
    else:
        model, params = common.build_gs(cfg)
        state = train.init_gs_state(model, params, cfg,
                                    params["eta"]["w1"].device)
        if K > 1:
            make = lambda k: train.make_gs_fused_multi_step(model, cfg, k)
        else:
            make = lambda k: train.make_multi_step(
                train.make_gs_train_step(model, cfg), k)
    marks["model and state"] = time.perf_counter()
    if hooks:
        hooks(model, state)
    first = FirstSteps(state) if K == 1 else None
    judged = {}

    def close(rec):
        judged.update(last_iteration(state, rec))

    cuda = torch.device(device).type == "cuda"
    tracer = Tracer(workdir, cuda) if trace else None
    window = Window(K, c["warmup_chunks"], seconds,
                    c["trace_chunks"] if trace else 0, tracer, close)
    spans, first_rows, last = [], [], [None]
    key = "F" if finite else "E"

    def make_chunk(k):
        fn = make(k)

        def timed(st):
            with torch.profiler.record_function("chunk_call"):
                t = time.perf_counter()
                out = fn(st)
                spans.append((t, time.perf_counter() - t))
            return out
        return timed

    class Logger(MetricsLogger):
        def log_many(self, *a):
            with torch.profiler.record_function("metrics_rows"):
                return super().log_many(*a)

        def log(self, *a):
            with torch.profiler.record_function("metrics_rows"):
                return super().log(*a)

    logger = Logger(cfg.metrics_path)
    failure = None
    with open(workdir / "rows.log", "w") as rows_fh:
        def print_row(rec):
            with torch.profiler.record_function("print_row"):
                # The CLIs' row (cli/ground_state.py, cli/finite_t.py).
                head = (f"iter: {rec['step']:03d} F: {rec['F']} F_std: "
                        f"{rec['F_std']} " if finite else
                        f"iter: {rec['step']:03d} ")
                rows_fh.write(
                    head + f"E: {rec['E']} E_std: {rec['E_std']} "
                    + (f"S: {rec['S']} S_analytical: {rec['S_analytical']} "
                       if finite else "")
                    + f"accept: {rec['accept_rate']:.3f} Instant speed "
                    f"(hours per 100 iters): "
                    f"{rec.get('hours_per_100_iters', float('nan'))}\n")
                if len(first_rows) < 3:
                    first_rows.append(rec)
                last[0] = rec
                if window.rows == 0:
                    marks["first chunk, capture"] = time.perf_counter()
                if first:
                    first.row(window.rows + 1)
                window.row(rec, key)

        try:
            common.run_training_loop(state, cfg, make_chunk, logger,
                                     print_row)
        except StopWindow:
            pass
        except FloatingPointError as err:  # the loop's watchdog
            failure = f"the training loop stopped: {err}"
        finally:
            logger.close()

    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(torch.device(device))
    else:
        peak = 0
    out = dict(attempted=window.iters, failed=window.nonfinite,
               setup_s=(window.t_open - t0) if window.t_open else None,
               memory_peak_bytes=peak, failure=failure)
    if window.t_open:
        marks["warm-up chunks"] = window.t_open
        prev, out["setup_parts"] = t0, {}
        for name, t in marks.items():
            out["setup_parts"][name], prev = t - prev, t
    if failure is None:
        out["iter_ms"] = window.iter_ms
        if trace:
            ctx = Context(c, kernel_map(), window, spans, tracer)
            out["per_layer"] = {}
            for m in spec["per_layer"]:
                value = load_module(HERE / "metrics" / f"{m['name']}.py").read(
                    ctx)
                if value is not None:
                    out["per_layer"][m["name"]] = value
            out["busy_s"] = ctx.summary.get("device_busy_ms", 0.0) / 1e3
            out["window_s"] = ctx.summary["window_ms"] / 1e3
            out["breakdown"] = {
                "device_ops": [[r["name"], r["ms"] / 1e3]
                               for r in ctx.summary.get("device_work", [])[:10]],
                "idle_gaps": ctx.idle_gaps}
    # What the check needs of the program's state, then nothing of it.
    B, n = cfg.batch, cfg.nup
    final = dict(z=state.walkers_cm.detach().T.reshape(B, n, 2).clone(),
                 tau=state.tau.detach().clone(),
                 states=(None if state.state_idx is None
                         else state.state_idx.clone()),
                 accept=last[0]["accept_rate"] if last[0] else float("nan"))
    if first:
        first.state = None
    del state, model, params, make, make_chunk, logger, close
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        out["power"] = _power_limit()
    if failure is None:
        if first and not first.complete():
            out["failure"] = "the first three iterations were not read"
        elif not judged:
            out["failure"] = "the window's last iteration was not read"
        else:
            out["compared"] = check.judge(c, first, first_rows, judged, final,
                                          seed, torch.device(device))
    if keep:
        out.update(first=first, first_rows=first_rows, judged=judged)
    return out
