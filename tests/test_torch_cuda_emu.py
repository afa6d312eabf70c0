"""The CUDA sources of the Hessian flow and the REINFORCE passes, built with
the host C++ compiler under a thread-per-CUDA-thread stand-in for the
runtime (``tests/cuda_emu/cuda_runtime.h``), against the plain PyTorch
versions in float64.

This runs the kernels' own indexing, lane ownership, barriers and
arithmetic on the CPU, through the port's wrappers (the library lookup and
the device checks are swapped for the emulated library).  It cannot stand
in for the card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold
the kernels as ``nvcc`` builds them, and time them, on an H100.
"""

import ctypes
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
    libs = {}
    for name in ("hessian_flow", "reinforce"):
        src = out / f"{name}.cpp"
        src.write_text(emulated_source(
            (_build.CSRC_DIR / f"{name}.cu").read_text()))
        lib = out / f"lib{name}.so"
        subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-I",
                        str(EMU_DIR), "-I", str(_build.CSRC_DIR), "-o",
                        str(lib), str(src), "-lpthread"], check=True,
                       capture_output=True)
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


# Ragged batches: 16 walkers per block, 4 per warp.
@pytest.mark.parametrize("n,d_mu,B", [(2, None, 5), (3, 8, 37), (6, 8, 19),
                                      (6, None, 17)])
def test_hessian_flow_source_matches_plain(on_emu, n, d_mu, B):
    gen = torch.Generator().manual_seed(n + B)
    z = 0.8 * torch.randn((2 * n, B), generator=gen)
    y, g, H = slater_vgh_cm_plain(z, **occ(n))
    p = params(d_mu)
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


def flat_grads(gr):
    return torch.cat([gr[m][k].reshape(-1).double()
                      for m in ("eta", "mu") if gr[m] is not None
                      for k in ("w2", "w1", "b1")])


# Ragged batches: 16 walkers per block, 4 per warp.
@pytest.mark.parametrize("n,d_mu,B", [(3, 8, 37), (2, None, 33), (6, 8, 19),
                                      (6, None, 17)])
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
    # turn blocks into warps (4 per 128-thread block of either kernel).  On
    # the card registers cap both at 4 blocks (16 warps).
    assert hf.hessian_flow_occupancy(6, 50, 50) == 16
    assert rf.reinforce_occupancy(6, 50, 50) == 24
