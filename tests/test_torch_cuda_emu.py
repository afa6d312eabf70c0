"""The CUDA sources of the Hessian flow, the REINFORCE passes, the
Metropolis samplers and the Slater VGH kernels, built with the host C++
compiler under a thread-per-CUDA-thread stand-in for the runtime
(``tests/cuda_emu/cuda_runtime.h``), against the plain PyTorch versions
(in float64; the samplers in float32 on one injected random stream).

This runs the kernels' own indexing, lane ownership, barriers and
arithmetic on the CPU, through the port's wrappers (the library lookup and
the device checks are swapped for the emulated library).  It cannot stand
in for the card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold
the kernels as ``nvcc`` builds them, and time them, on an H100.
"""

import ctypes
import importlib
import multiprocessing
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from fermiflow_tpu_torch.nn.backflow import backflow_init_gaussian
from fermiflow_tpu_torch.ops import _build
from fermiflow_tpu_torch.ops import hessian_flow as hf
from fermiflow_tpu_torch.ops import reinforce as rf
from fermiflow_tpu_torch.ops.slater_vgh import slater_vgh_cm_plain
from fermiflow_tpu_torch.physics import HO2D

EMU_DIR = Path(__file__).resolve().parent / "cuda_emu"
# Sources whose kernels share a chain or walker among a group of lanes.
LANE_GROUP_SOURCES = ("metropolis", "metropolis_ms", "slater_vgh",
                      "slater_vgh_ms")
TS = (0.0, 1.0, 2, "dopri5")
ORB = HO2D()


def emulated_source(cu: str) -> str:
    """A .cu source rewritten for the host compiler: dynamic shared memory
    as the emulator's buffer, ``<<<...>>>`` launches as calls."""
    cu = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                r"\1* \2 = reinterpret_cast<\1*>(ff_emu_dyn_smem);", cu)
    cu = re.sub(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(",
                r"ff_emu_launch(\2, \1, ", cu, flags=re.S)
    return re.sub(r"#pragma unroll.*", "", cu)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++)")
    out = tmp_path_factory.mktemp("cuda_emu")
    builds = {}
    # The samplers and the VGH kernels also at 4 lanes per chain or walker
    # (FF_SAMPLER_LANES, FF_VGH_LANES, 8 when unset): "metropolis@4" etc.
    for key in ("hessian_flow", "reinforce", *LANE_GROUP_SOURCES,
                *(f"{n}@4" for n in LANE_GROUP_SOURCES)):
        name, _, lanes = key.partition("@")
        src = out / f"{name}.cpp"
        src.write_text(emulated_source(
            (_build.CSRC_DIR / f"{name}.cu").read_text()))
        lib = out / f"lib{name}{lanes}.so"
        defs = ([f"-DFF_SAMPLER_LANES={lanes}", f"-DFF_VGH_LANES={lanes}"]
                if lanes else [])
        builds[key] = (lib, subprocess.Popen(
            [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", *defs, "-I",
             str(EMU_DIR), "-I", str(_build.CSRC_DIR), "-o", str(lib),
             str(src), "-lpthread"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in builds.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{name}:\n{log.decode()}"
        libs[name] = ctypes.CDLL(str(lib))
    return libs


@pytest.fixture
def on_emu(emu, monkeypatch):
    """The wrappers' CUDA paths, on CPU tensors, through the emulated
    libraries."""
    monkeypatch.setattr(_build, "library", lambda name: emu[name])
    monkeypatch.setattr(_build, "check_cuda_f32", lambda **kw: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: ctypes.c_void_p(0))
    return emu


def occ(n):
    q = [tuple(int(v) for v in a) for a in (ORB.nx[:n], ORB.ny[:n])]
    return dict(nx_occ=q[0], ny_occ=q[1], num_shells=max(q[0] + q[1]) + 1)


def params(d_mu, std=0.3):
    return backflow_init_gaussian(torch.Generator().manual_seed(1), 8, d_mu,
                                  std=std, dtype=torch.float32, device="cpu")


def f64(p):
    return {k: None if v is None else {kk: t.double() for kk, t in v.items()}
            for k, v in p.items()}


# Ragged batches: 16 walkers per block, 4 per warp (N <= 6); 4 walkers per
# block, one per warp (N >= 7).  d_eta is 8: d_mu = 5 and 12 give the
# units unequal widths (padded with zeros).  From N = 7 the MLP inputs take
# one slot a lane (N = 7: 28 inputs) or two, the second holding pairs on
# some lanes and one-body inputs on others (N = 9, 10).
@pytest.mark.parametrize("n,d_mu,B", [(2, None, 5), (3, 8, 37), (6, 8, 19),
                                      (6, None, 17), (10, 8, 9),
                                      (8, None, 6), (6, 5, 19), (6, 12, 9),
                                      (4, 8, 13), (5, None, 21), (7, 8, 11),
                                      (9, 8, 5)])
def test_hessian_flow_source_matches_plain(on_emu, n, d_mu, B, w1=None):
    gen = torch.Generator().manual_seed(n + B)
    z = 0.8 * torch.randn((2 * n, B), generator=gen)
    y, g, H = slater_vgh_cm_plain(z, **occ(n))
    p = params(d_mu)
    if w1 is not None:
        p["eta"]["w1"][0, 0] = w1
    before = _build.LAUNCHES["hessian_flow"]
    k = hf._hflow_cuda(p, z, y, g, H, *TS)
    again = hf._hflow_cuda(p, z, y, g, H, *TS)
    ref = hf.hessian_flow_cm_plain(f64(p), z.double(), y.double(), g.double(),
                                   H.double(), *TS)
    assert _build.LAUNCHES["hessian_flow"] == before + 2
    for a, b, r in zip(k, again, ref):
        assert torch.equal(a, b)
        # tests/test_torch_cuda.py: err < 1e-4 * scale + 1e-5.
        err = float((a.double() - r).abs().max())
        assert err < 1e-4 * float(r.abs().max()) + 1e-5


@pytest.mark.parametrize("n,B", [(3, 37), (6, 17), (10, 7)])
def test_hessian_flow_source_both_reciprocal_paths(on_emu, n, B):
    # One eta unit with w1 = 30: the lanes whose pair distance passes
    # 80 / 30 run their hidden-unit loop on the division, the others on
    # the range-checked reciprocal (the division too, on the host).
    test_hessian_flow_source_matches_plain(on_emu, n, 8, B, w1=30.0)


def flat_grads(gr):
    return torch.cat([gr[m][k].reshape(-1).double()
                      for m in ("eta", "mu") if gr[m] is not None
                      for k in ("w2", "w1", "b1")])


# Ragged batches: 16 walkers per block, 4 per warp (N <= 6); 8 walkers per
# block, 2 per warp, the pairs in 3 (N = 9, 10) or 2 (N = 7) chunks, the
# last ragged (N >= 7).  d_eta is 8: at 16 lanes (N >= 7) every unit is one
# of the last d % 16, which each lane runs on the inputs it totals; at 8
# lanes d_mu = 12 deals 8 units and leaves 4.
@pytest.mark.parametrize("n,d_mu,B", [(3, 8, 37), (2, None, 33), (6, 8, 19),
                                      (6, None, 17), (10, 8, 19),
                                      (7, None, 11), (9, 8, 13), (6, 12, 9)])
def test_reinforce_source_matches_plain(on_emu, n, d_mu, B):
    gen = torch.Generator().manual_seed(3)
    z = torch.randn((2 * n, B), generator=gen)
    g = torch.randn((2 * n, B), generator=gen)
    w = torch.randn((B,), generator=gen) / B
    # At N=6 a std of 0.3 makes the flow stretch these walkers ~100-fold
    # over [0, 1], past what f32 holds to 1e-5; 0.1 is chip_smoke's std.
    p = params(d_mu, std=0.3 if n < 6 else 0.1)
    before = dict(_build.LAUNCHES)
    grads, zb = rf._reinforce_cuda(p, z, g, w, *TS)
    ref, zr = rf.reinforce_cm_plain(f64(p), z.double(), g.double(),
                                    w.double(), *TS)
    for k in ("reinforce_adjoint", "reinforce_reduce"):
        assert _build.LAUNCHES[k] == before[k] + 1
    # No atomics: a second call gives the same bits.
    grads2, zb2 = rf._reinforce_cuda(p, z, g, w, *TS)
    assert torch.equal(flat_grads(grads), flat_grads(grads2))
    assert torch.equal(zb, zb2)
    a, b = flat_grads(grads), flat_grads(ref)
    # tests/test_pallas_reinforce.py: atol 3e-6 * max|grad|, rtol 2e-5.
    torch.testing.assert_close(a, b, rtol=2e-5,
                               atol=3e-6 * float(b.abs().max()))
    torch.testing.assert_close(zb.double(), zr, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nq", [150, 300])
@pytest.mark.parametrize("nblocks", [1, 37, 257])
def test_reduce_source_matches_plain(on_emu, nblocks, nq):
    rng = np.random.default_rng(nblocks + nq)
    parts = torch.as_tensor(rng.standard_normal((nblocks, nq)),
                            dtype=torch.float32)
    rows = [torch.empty(nq), torch.empty(nq)]
    for r in rows:
        rc = on_emu["reinforce"].ff_reinforce_reduce(
            _build.ptr(parts), _build.ptr(r), ctypes.c_int(nblocks),
            ctypes.c_int(nq), ctypes.c_void_p(0))
        assert rc == 0
    assert torch.equal(rows[0], rows[1])
    ref = parts.double().sum(0)
    bound = nblocks * 2.0**-24 * parts.double().abs().sum(0)
    assert bool(((rows[0].double() - ref).abs() <= bound + 1e-30).all())


def test_occupancy_entries_count_warps(on_emu):
    # The emulator counts blocks by shared memory alone; the entries must
    # turn blocks into warps (4 per 128-thread block of either kernel): 4
    # adjoint blocks of 51,520 B at N = 6, the lanes' state entries and
    # slopes and their own rows of the last 50 % 8 units of each MLP
    # included.  On the card registers cap both at 4 blocks (16 warps).
    assert hf.hessian_flow_occupancy(6, 50, 50) == 16
    assert rf.reinforce_occupancy(6, 50, 50) == 16


# ---- the Metropolis samplers: a group of lanes per chain ----


def sampler_libs(libs, lanes):
    """The lane-group libraries (the samplers and the VGH kernels) built
    for ``lanes`` lanes per chain or walker."""
    suffix = "" if lanes == 8 else f"@{lanes}"
    return {n: libs[n + suffix] for n in LANE_GROUP_SOURCES}


@pytest.mark.parametrize("lanes", [4, 8])
def test_sampler_occupancy_entries_report_the_launch(on_emu, monkeypatch,
                                                     lanes):
    # The entries report the lanes they were built for and the grid their
    # launchers make: 128 / lanes walkers per 4-warp block.
    from fermiflow_tpu_torch.ops import metropolis as mp

    libs = sampler_libs(on_emu, lanes)
    monkeypatch.setattr(_build, "library", libs.__getitem__)
    for B in (8192, 37):
        for got in (mp.metropolis_occupancy(6, B),
                    mp.metropolis_ms_occupancy(6, 5, B)):
            assert got["lanes"] == lanes
            assert got["grid_warps"] == -(-B // (128 // lanes)) * 4
            assert got["warps_per_sm"] > 0 and got["warps_per_sm"] % 4 == 0


def _sampler_launch(lib_paths, entry, args):
    """One emulated launch of a lane-group wrapper's CUDA path (``entry`` of
    ``ops.metropolis``, or ``"module.entry"`` of another ``ops`` module,
    through the libraries at ``lib_paths``) on CPU tensors, in a worker
    process: (outputs, {kernel: launches it made})."""
    module, _, entry = entry.rpartition(".")
    mp = importlib.import_module(
        f"fermiflow_tpu_torch.ops.{module or 'metropolis'}")

    libs = {name: ctypes.CDLL(path) for name, path in lib_paths.items()}
    _build.library = libs.__getitem__
    _build.check_cuda_f32 = _build.check_cuda_i32 = lambda **kw: None
    _build.stream_ptr = lambda dev: ctypes.c_void_p(0)
    tensors = lambda a: (torch.from_numpy(a) if isinstance(a, np.ndarray)
                         else a if not isinstance(a, tuple)
                         else tuple(tensors(v) for v in a))
    before = dict(_build.LAUNCHES)
    out = getattr(mp, entry)(*tensors(tuple(args)))
    return ([t.numpy() for t in out],
            {k: v - before[k] for k, v in _build.LAUNCHES.items()
             if v != before[k]})


class EmuWorker:
    """Runs emulated lane-group launches one at a time in a spawned process.
    A lane that leaves before its group's last shuffle leaves the others
    waiting for ever: a launch still running after ``timeout`` seconds
    kills the worker and fails the test instead of hanging the run."""

    def __init__(self, libs, timeout=60.0):
        self.paths = {lanes: {n: lib._name for n, lib in
                              sampler_libs(libs, lanes).items()}
                      for lanes in (4, 8)}
        self.timeout = timeout
        self.pool = None

    def launch(self, entry, lanes, *args):
        if self.pool is None:
            self.pool = multiprocessing.get_context("spawn").Pool(1)
        arrays = lambda a: (a.numpy() if isinstance(a, torch.Tensor)
                            else a if not isinstance(a, tuple)
                            else tuple(arrays(v) for v in a))
        job = self.pool.apply_async(
            _sampler_launch, (self.paths[lanes], entry, arrays(args)))
        try:
            out, counts = job.get(self.timeout)
        except multiprocessing.TimeoutError:
            self.close()
            pytest.fail(f"emulated {entry} still running after "
                        f"{self.timeout} s: a lane waits on a shuffle that "
                        "no lane answers")
        return [torch.from_numpy(o) for o in out], counts

    def close(self):
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()
            self.pool = None


@pytest.fixture(scope="module")
def sampler_emu(emu):
    worker = EmuWorker(emu)
    yield worker
    worker.close()


def gs_occ(nup, ndown):
    up, dn = np.arange(nup), np.arange(ndown)
    q = [tuple(int(v) for v in a) for a in
         (ORB.nx[up], ORB.ny[up], ORB.nx[dn], ORB.ny[dn])]
    return dict(nx_occ=q[0], ny_occ=q[1], nx_dn=q[2], ny_dn=q[3],
                num_shells=max(q[0] + q[1] + q[2] + q[3]) + 1)


def walkers(n, B, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((2 * n, B), generator=gen), gen


def same_chains(k, p, walker_axes):
    """chip_smoke.py's shared-stream test: positions equal on the walkers
    that agree (an accept may flip on the last bit of exp() between two
    implementations; none does at these sizes), logp within 1e-3, rates and
    tau within 1e-6."""
    err = (k[0] - p[0]).abs().amax(dim=walker_axes)
    agree = err == 0
    assert bool(agree.all()), f"diverged walkers {(~agree).nonzero()}"
    assert float((k[1] - p[1]).abs().max()) <= 1e-3
    for a, b in zip(k[2:], p[2:]):
        assert float((a - b).abs().max()) <= 1e-6


# Ragged batches: 16 (lanes 8) or 32 (lanes 4) walkers per block.
@pytest.mark.parametrize("lanes", [4, 8])
@pytest.mark.parametrize("nup,ndown,B,reinit", [
    (2, 0, 5, False), (2, 1, 19, True), (6, 0, 37, False), (6, 0, 37, True),
    (10, 0, 21, False), (5, 4, 13, True)])
def test_metropolis_chains_source_matches_plain(sampler_emu, lanes, nup,
                                                ndown, B, reinit):
    from fermiflow_tpu_torch.ops.metropolis import metropolis_chains_plain

    n = nup + ndown
    x0, gen = walkers(n, B, nup + B)
    S, steps = 2, 4
    noise = (torch.randn((S, steps + 1, 2 * n, B), generator=gen),
             torch.rand((S, steps, B), generator=gen).clamp_min(1e-12))
    tau = torch.full((B,), 0.3)
    occ = gs_occ(nup, ndown)
    k, counts = sampler_emu.launch(
        "_chains_cuda", lanes, x0, tau, 0, steps, S,
        occ["nx_occ"] + occ["nx_dn"], occ["ny_occ"] + occ["ny_dn"], nup,
        0.5, 0.1, reinit, noise)
    p = metropolis_chains_plain(x0, tau, 0, steps=steps, segments=S,
                                reinit=reinit, noise=noise, **occ)
    assert counts == {"metropolis_chains": 1}
    same_chains(k, p, (0, 1))


@pytest.mark.parametrize("lanes", [4, 8])
@pytest.mark.parametrize("nup,ndown,B", [(3, 0, 19), (6, 0, 5), (10, 0, 7)])
def test_metropolis_single_source_matches_plain(sampler_emu, lanes, nup,
                                                ndown, B):
    from fermiflow_tpu_torch.ops.metropolis import metropolis_single_cm_plain

    n = nup + ndown
    x0, gen = walkers(n, B, 2 * B)
    steps = 6
    noise = (torch.randn((steps, 2 * n, B), generator=gen),
             torch.rand((steps, B), generator=gen).clamp_min(1e-12))
    tau = torch.full((B,), 0.3)
    occ = gs_occ(nup, ndown)
    k, counts = sampler_emu.launch(
        "_single_cuda", lanes, x0, tau, 0, steps,
        occ["nx_occ"] + occ["nx_dn"], occ["ny_occ"] + occ["ny_dn"], nup,
        noise)
    p = metropolis_single_cm_plain(x0, tau, 0, steps=steps, noise=noise,
                                   **occ)
    assert counts == {"metropolis_single": 1}
    same_chains(k, p, 0)


def ms_states(nup, B, gen, deltaE=2.0):
    """(nx, ny) (n, B) int32 of states drawn from the deltaE table.  At
    deltaE = 4 walker 0 takes the first state that holds quantum number 7,
    the deepest of depth 8 (8 of N = 10's 1781 states)."""
    table, _ = ORB.fermion_states(nup, 0, deltaE)
    idx = torch.randint(0, table.shape[0], (B,), generator=gen)
    if deltaE == 4.0:
        top = np.maximum(ORB.nx[table], ORB.ny[table]).max(axis=1)
        idx[0] = int(np.flatnonzero(top == 7)[0])
    occ = torch.as_tensor(table).long()[idx]
    return tuple(torch.as_tensor(q)[occ].T.to(torch.int32).contiguous()
                 for q in (ORB.nx, ORB.ny))


def ms_case(n):
    """(deltaE, Hermite depth) of the mixed-state rows at n particles: the
    deltaE = 2 table at depth 5 to N = 6, the deltaE = 4 table (quantum
    numbers to 7) at depth 8 from N = 7."""
    return (2.0, 5) if n <= 6 else (4.0, 8)


@pytest.mark.parametrize("lanes", [4, 8])
@pytest.mark.parametrize("n,B", [(3, 19), (6, 37), (7, 21), (10, 11)])
def test_metropolis_ms_source_matches_plain(sampler_emu, lanes, n, B):
    from fermiflow_tpu_torch.ops.metropolis import (
        metropolis_multistate_cm_plain,
    )

    x0, gen = walkers(n, B, 3 * B)
    deltaE, K = ms_case(n)
    nx, ny = ms_states(n, B, gen, deltaE)
    steps = 6
    noise = (torch.randn((steps, 2 * n, B), generator=gen),
             torch.rand((steps, B), generator=gen).clamp_min(1e-12))
    tau = torch.full((B,), 0.3)
    bad = nx.clone()
    bad[n - 1, B // 2] = K  # outside the compiled depth: NaN outputs
    k, counts = sampler_emu.launch("_multistate_cuda", lanes, x0, tau, 0,
                                   steps, bad, ny, K, noise)
    p = metropolis_multistate_cm_plain(x0, tau, 0, steps=steps, nx_cm=nx,
                                       ny_cm=ny, num_shells=K, noise=noise)
    assert counts == {"metropolis_multistate": 1}
    good = torch.arange(B) != B // 2
    assert all(bool(t[..., ~good].isnan().all()) for t in k)
    same_chains([t[..., good] for t in k], [t[..., good] for t in p], 0)


@pytest.mark.parametrize("entry", ["chains", "single", "multistate"])
def test_lane_groups_walk_the_same_philox_chains(sampler_emu, entry):
    """On the kernels' own stream, 4 and 8 lanes per chain draw the same
    numbers and take the same steps: every output is bitwise equal."""
    n, B = 6, 21
    x0, gen = walkers(n, B, 7)
    tau = torch.full((B,), 0.2)
    occ = gs_occ(n, 0)
    q = (occ["nx_occ"], occ["ny_occ"])
    nx, ny = ms_states(n, B, gen)
    args = {"chains": ("_chains_cuda", x0, tau, 11, 3, 2, *q, n, 0.5, 0.1,
                       False, None),
            "single": ("_single_cuda", x0, tau, 12, 4, *q, n, None),
            "multistate": ("_multistate_cuda", x0, tau, 13, 4, nx, ny, 5,
                           None)}[entry]
    outs = [sampler_emu.launch(args[0], lanes, *args[1:])[0]
            for lanes in (4, 8)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a).all())
    assert 0.2 < float(outs[0][2].mean()) < 1.0


@pytest.mark.parametrize("entry", ["chains", "single", "multistate"])
def test_walker0_launch_walks_the_full_launchs_rows(sampler_emu, entry):
    """A launch on rows k.. at walker0 = k (a rank's launch on its rows of
    a walker mesh) walks, bitwise, the chains of those rows in the launch
    over every walker: the Philox key is (seed, walker0 + row).  At
    walker0 = 0 the same rows walk other chains."""
    n, B, k = 6, 21, 8
    x0, gen = walkers(n, B, 17)
    tau = 0.1 + 0.2 * torch.rand((B,), generator=gen)
    occ = gs_occ(n, 0)
    q = (occ["nx_occ"], occ["ny_occ"])
    nx, ny = ms_states(n, B, gen)

    def launch(first, walker0):
        r = lambda t: t[..., first:].contiguous()
        args = {"chains": ("_chains_cuda", r(x0), r(tau), 21, 3, 2, *q, n,
                           0.5, 0.1, False, None, walker0),
                "single": ("_single_cuda", r(x0), r(tau), 22, 4, *q, n, None,
                           walker0),
                "multistate": ("_multistate_cuda", r(x0), r(tau), 23, 4,
                               r(nx), r(ny), 5, None, walker0)}[entry]
        return sampler_emu.launch(args[0], 8, *args[1:])[0]

    full, rows, unkeyed = launch(0, 0), launch(k, k), launch(k, 0)
    for a, b in zip(full, rows):
        assert torch.equal(a[..., k:], b)
    assert not torch.equal(full[0][..., k:], unkeyed[0])


# ---- the Slater VGH kernels: a group of lanes per walker ----

# chip_smoke.py's VGH_TOLERANCE against the f64 plain version (rtol = atol).
VGH_TOL = (2e-4, 3e-3, 5e-3)


def vgh_close(k, r, good=None):
    """(y, g, H) of a kernel within VGH_TOL of the f64 plain version on
    every entry of the walkers ``good`` (all by default)."""
    for name, a, b, tol in zip("ygH", k, r, VGH_TOL):
        if good is not None:
            a, b = a[..., good], b[..., good]
        assert bool(torch.isfinite(a).all()), name
        assert bool(torch.isclose(a.double(), b, rtol=tol, atol=tol).all()), (
            name, float((a.double() - b).abs().max()))


def gs_walkers(nup, ndown, B):
    """Walkers equilibrated on the ground state's |det|^2 by the plain
    sampler (the numerics rule: not raw Gaussian points)."""
    from fermiflow_tpu_torch.ops.metropolis import metropolis_chains_plain

    x0, _ = walkers(nup + ndown, B, 5 * B + nup)
    xs, _, _, _ = metropolis_chains_plain(
        x0, torch.full((B,), 0.3), 1, steps=30, segments=2, gain=0.0,
        **gs_occ(nup, ndown))
    return xs[-1].contiguous()


def ms_walkers(n, B):
    """Walkers in states of ``ms_case(n)``'s table, equilibrated by the
    plain mixed-state sampler, and the states' (nx, ny)."""
    from fermiflow_tpu_torch.ops.metropolis import (
        metropolis_multistate_cm_plain,
    )

    deltaE, K = ms_case(n)
    x0, gen = walkers(n, B, 7 * B + n)
    nx, ny = ms_states(n, B, gen, deltaE)
    x, _, _ = metropolis_multistate_cm_plain(
        x0, torch.full((B,), 0.3), 2, steps=60, nx_cm=nx, ny_cm=ny,
        num_shells=K)
    return x.contiguous(), nx, ny


# Ragged batches: 32 walkers per block.
@pytest.mark.parametrize("nup,ndown,B", [(2, 0, 5), (2, 1, 37), (3, 0, 37),
                                         (4, 2, 21), (6, 0, 37), (10, 0, 37),
                                         (5, 4, 21), (7, 0, 9)])
def test_slater_vgh_source_matches_plain(sampler_emu, nup, ndown, B):
    occ = gs_occ(nup, ndown)
    z = gs_walkers(nup, ndown, B)
    k, counts = sampler_emu.launch(
        "slater_vgh._vgh_cuda", 8, z, occ["nx_occ"] + occ["nx_dn"],
        occ["ny_occ"] + occ["ny_dn"], nup)
    assert counts == {"slater_vgh": 1}
    vgh_close(k, slater_vgh_cm_plain(z.double(), **occ))


@pytest.mark.parametrize("n,B", [(2, 5), (3, 37), (6, 37), (7, 21), (10, 37)])
def test_slater_vgh_ms_source_matches_plain(sampler_emu, n, B):
    from fermiflow_tpu_torch.ops.slater_vgh import slater_vgh_ms_cm_plain

    z, nx, ny = ms_walkers(n, B)
    _, K = ms_case(n)
    bad = nx.clone()
    bad[n - 1, B // 2] = K  # outside the compiled depth: NaN outputs
    k, counts = sampler_emu.launch("slater_vgh._vgh_ms_cuda", 8, z, bad, ny,
                                   K)
    assert counts == {"slater_vgh_ms": 1}
    good = torch.arange(B) != B // 2
    assert all(bool(t[..., ~good].isnan().all()) for t in k)
    vgh_close(k, slater_vgh_ms_cm_plain(z.double(), nx, ny, K), good)


@pytest.mark.parametrize("entry", ["static", "sectors", "multistate"])
def test_vgh_lane_groups_give_the_same_bits(sampler_emu, entry):
    """4 lanes per walker (two row slots on some lanes) and 8 (one) run
    the same arithmetic: every output is bitwise equal."""
    n, B = 6, 35
    if entry == "multistate":
        z, nx, ny = ms_walkers(n, B)
        args = ("slater_vgh._vgh_ms_cuda", z, nx, ny, 5)
    else:
        nup = n if entry == "static" else 4
        occ = gs_occ(nup, n - nup)
        args = ("slater_vgh._vgh_cuda", gs_walkers(nup, n - nup, B),
                occ["nx_occ"] + occ["nx_dn"], occ["ny_occ"] + occ["ny_dn"],
                nup)
    outs = [sampler_emu.launch(args[0], lanes, *args[1:])[0]
            for lanes in (4, 8)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a).all())


@pytest.mark.parametrize("entry", ["chains", "single", "vgh", "multistate",
                                   "vgh_ms"])
def test_lane_groups_agree_bitwise_at_n10(sampler_emu, entry):
    """N = 10 at 4 lanes (three row slots; three Philox calls on some lanes)
    and at 8 (two slots; one call per lane): every output bitwise equal.
    The mixed-state kernels run at depth 8 on deltaE = 4 states."""
    n, B = 10, 11
    occ = gs_occ(n, 0)
    q = (occ["nx_occ"], occ["ny_occ"])
    if entry == "vgh":
        args = ("slater_vgh._vgh_cuda", gs_walkers(n, 0, B), *q, n)
    elif entry == "vgh_ms":
        args = ("slater_vgh._vgh_ms_cuda", *ms_walkers(n, B), 8)
    else:
        x0, gen = walkers(n, B, 9)
        tau = torch.full((B,), 0.2)
        args = {"chains": ("_chains_cuda", x0, tau, 14, 3, 2, *q, n, 0.5,
                           0.1, False, None),
                "single": ("_single_cuda", x0, tau, 15, 4, *q, n,
                           None),
                "multistate": ("_multistate_cuda", x0, tau, 16, 4,
                               *ms_states(n, B, gen, 4.0), 8, None)}[entry]
    outs = [sampler_emu.launch(args[0], lanes, *args[1:])[0]
            for lanes in (4, 8)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a).all())


@pytest.mark.parametrize("lanes", [4, 8])
def test_vgh_occupancy_entries_report_the_launch(on_emu, monkeypatch, lanes):
    # 32 walkers per block of 32 x lanes threads.
    from fermiflow_tpu_torch.ops import slater_vgh as sv

    libs = sampler_libs(on_emu, lanes)
    monkeypatch.setattr(_build, "library", libs.__getitem__)
    for B in (8192, 37):
        for got in (sv.slater_vgh_occupancy(6, B),
                    sv.slater_vgh_ms_occupancy(6, 5, B)):
            assert got["lanes"] == lanes
            assert got["grid_warps"] == -(-B // 32) * lanes
            assert got["warps_per_sm"] > 0
            assert got["warps_per_sm"] % lanes == 0
