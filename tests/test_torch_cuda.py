"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small, ragged batch sizes (the kernels mask the last partial block).

These need an NVIDIA GPU: on a machine without one every test skips.  On the
card, from the root of a checkout (no JAX needed, hence no conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from fermiflow_tpu_torch.nn.backflow import backflow_init_gaussian
from fermiflow_tpu_torch.ops import _build
from fermiflow_tpu_torch.ops.hessian_flow import (
    hessian_flow_cm,
    hessian_flow_cm_plain,
    hessian_flow_occupancy,
)
from fermiflow_tpu_torch.ops.metropolis import (
    metropolis_chains,
    metropolis_chains_plain,
    metropolis_multistate_cm,
    metropolis_multistate_cm_plain,
    metropolis_single_cm,
    metropolis_single_cm_plain,
)
from fermiflow_tpu_torch.ops.reinforce import (
    block_sum,
    reinforce_cm,
    reinforce_cm_plain,
    reinforce_occupancy,
)
from fermiflow_tpu_torch.ops.slater_vgh import (
    slater_vgh_cm,
    slater_vgh_cm_plain,
    slater_vgh_ms_cm,
    slater_vgh_ms_cm_plain,
)
from fermiflow_tpu_torch.physics import HO2D

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

ORB = HO2D()
TS = (0.0, 1.0, 2, "dopri5")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def occ(nup, ndown):
    up, dn = np.arange(nup), np.arange(ndown)
    q = [tuple(int(v) for v in a) for a in
         (ORB.nx[up], ORB.ny[up], ORB.nx[dn], ORB.ny[dn])]
    return dict(nx_occ=q[0], ny_occ=q[1], nx_dn=q[2], ny_dn=q[3],
                num_shells=max(q[0] + q[1] + q[2] + q[3]) + 1)


def equilibrated(device, nup, ndown, B, seed=0):
    n = nup + ndown
    gen = torch.Generator(device=device).manual_seed(seed)
    x0 = torch.randn((2 * n, B), generator=gen, device=device)
    tau = torch.full((B,), 0.3, device=device)
    xs, _, _, _ = metropolis_chains(x0, tau, seed, steps=50, segments=4,
                                    **occ(nup, ndown))
    return xs[-1].contiguous()


def params(device, d_mu, dtype=torch.float32, std=0.3):
    gen = torch.Generator(device=device).manual_seed(1)
    return backflow_init_gaussian(gen, 8, d_mu, std=std, dtype=dtype,
                                  device=device)


def f64(p):
    return {k: None if v is None else {kk: t.double() for kk, t in v.items()}
            for k, v in p.items()}


@pytest.mark.parametrize("nup,ndown,B", [(6, 0, 100), (2, 1, 33)])
def test_metropolis_kernel_matches_plain_on_shared_stream(cuda, nup, ndown, B):
    n = nup + ndown
    x0 = equilibrated(cuda, nup, ndown, B)
    gen = torch.Generator(device=cuda).manual_seed(2)
    S, steps = 3, 10
    noise = (torch.randn((S, steps + 1, 2 * n, B), generator=gen, device=cuda),
             torch.rand((S, steps, B), generator=gen,
                        device=cuda).clamp_min(1e-12))
    tau = torch.full((B,), 0.2, device=cuda)
    for reinit in (False, True):
        kw = dict(steps=steps, segments=S, reinit=reinit, noise=noise,
                  **occ(nup, ndown))
        before = _build.LAUNCHES["metropolis_chains"]
        k = metropolis_chains(x0, tau, 0, **kw)
        p = metropolis_chains_plain(x0, tau, 0, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["metropolis_chains"] == before + 1
        # Same roundings of the positions; an accept decision may flip on
        # the last bit of exp() for a rare walker.
        agree = (k[0] - p[0]).abs().amax(dim=(0, 1)) == 0
        assert float(agree.double().mean()) >= 0.95
        torch.testing.assert_close(k[1][:, agree], p[1][:, agree], rtol=1e-4,
                                   atol=1e-3)
        torch.testing.assert_close(k[2][:, agree], p[2][:, agree], rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(k[3][agree], p[3][agree], rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("nup,ndown,B", [(6, 0, 100), (2, 1, 33)])
def test_slater_vgh_kernel_matches_plain(cuda, nup, ndown, B):
    z = equilibrated(cuda, nup, ndown, B)
    k = slater_vgh_cm(z, **occ(nup, ndown))
    r = slater_vgh_cm_plain(z.double(), **occ(nup, ndown))
    torch.cuda.synchronize()
    # tests/test_pallas_slater_vgh.py's f32 tolerances for y, g, H.
    for a, b, tol in zip(k, r, (2e-4, 3e-3, 5e-3)):
        assert a.shape == b.shape
        torch.testing.assert_close(a.double(), b, rtol=tol, atol=tol)


# Batch sizes that leave the last block ragged (16 walkers per block, 4 per
# warp): 37 and 8191 end mid-warp, 100 mid-block.
@pytest.mark.parametrize("nup,d_mu,B", [
    (3, 8, 100), (3, None, 37), (2, 8, 37), (2, None, 8191), (6, 8, 8191),
    (6, None, 37)])
def test_hessian_flow_kernel_matches_plain(cuda, nup, d_mu, B):
    z = equilibrated(cuda, nup, 0, B)
    y, g, H = slater_vgh_cm(z, **occ(nup, 0))
    p = params(cuda, d_mu)
    before = _build.LAUNCHES["hessian_flow"]
    k = hessian_flow_cm(p, z, y, g, H, *TS)
    again = hessian_flow_cm(p, z, y, g, H, *TS)
    ref = hessian_flow_cm_plain(f64(p), z.double(), y.double(), g.double(),
                                H.double(), *TS)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["hessian_flow"] == before + 2
    for a, b, r in zip(k, again, ref):
        # No atomics: the same inputs give the same bits.
        assert torch.equal(a, b)
        # tests/test_hessian_flow.py: err < 1e-4 * scale + 1e-5.
        err = float((a.double() - r).abs().max())
        assert err < 1e-4 * float(r.abs().max()) + 1e-5


def test_hessian_flow_occupancy(cuda):
    # The paths' widths (N=6, d_eta = d_mu = 50): at least 8 warps per SM,
    # against one (Hessian flow) and two (adjoint) warps per SM for the
    # one-thread-per-walker designs.
    assert hessian_flow_occupancy(6, 50, 50) >= 8
    assert reinforce_occupancy(6, 50, 50) >= 8


# 16 walkers per adjoint block, 4 per warp: 37 and 8191 end mid-warp, 100
# mid-block.
@pytest.mark.parametrize("nup,d_mu,B", [(3, 8, 100), (3, None, 37),
                                        (6, 8, 8191), (6, None, 37)])
def test_reinforce_kernels_match_plain(cuda, nup, d_mu, B):
    z = equilibrated(cuda, nup, 0, B)
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = torch.randn((2 * nup, B), generator=gen, device=cuda)
    w = torch.randn((B,), generator=gen, device=cuda) / B
    # At N=6 a std of 0.3 stretches the walkers past what f32 holds to
    # 1e-5 (tests/test_torch_cuda_emu.py); 0.1 is chip_smoke's std.
    p = params(cuda, d_mu, std=0.3 if nup < 6 else 0.1)
    before = dict(_build.LAUNCHES)
    grads, zb = reinforce_cm(p, z, g, w, *TS)
    again, zb2 = reinforce_cm(p, z, g, w, *TS)
    ref, zr = reinforce_cm_plain(f64(p), z.double(), g.double(), w.double(),
                                 *TS)
    torch.cuda.synchronize()
    # One host call, both kernels counted.
    for k in ("reinforce_adjoint", "reinforce_reduce"):
        assert _build.LAUNCHES[k] == before[k] + 2
    flat = lambda gr: torch.cat([gr[m][k].reshape(-1).double()
                                 for m in ("eta", "mu") if gr[m] is not None
                                 for k in ("w2", "w1", "b1")])
    # No atomics: the same inputs give the same bits.
    assert torch.equal(flat(grads), flat(again)) and torch.equal(zb, zb2)
    a, b = flat(grads), flat(ref)
    # tests/test_pallas_reinforce.py: atol 3e-6 * max|grad|, rtol 2e-5.
    torch.testing.assert_close(a, b, rtol=2e-5,
                               atol=3e-6 * float(b.abs().max()))
    torch.testing.assert_close(zb.double(), zr, rtol=1e-5, atol=1e-5)
    # The reduce pass is deterministic: the same partials, the same sum.
    parts = torch.randn((37, 300), generator=gen, device=cuda)
    s1, s2 = block_sum(parts), block_sum(parts)
    assert torch.equal(s1, s2)
    torch.testing.assert_close(s1.double(), parts.double().sum(0), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("nq", [150, 300])
@pytest.mark.parametrize("nblocks", [1, 37, 257])
def test_reduce_kernel_matches_plain(cuda, nblocks, nq):
    gen = torch.Generator(device=cuda).manual_seed(nblocks + nq)
    parts = torch.randn((nblocks, nq), generator=gen, device=cuda)
    before = _build.LAUNCHES["reinforce_reduce"]
    s1, s2 = block_sum(parts), block_sum(parts)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["reinforce_reduce"] == before + 2
    assert torch.equal(s1, s2)
    torch.testing.assert_close(s1.double(), parts.double().sum(0), rtol=1e-5,
                               atol=1e-5)


# ---- the per-iteration and mixed-state kernels ----


def ms_inputs(device, nup, B, seed=4, deltaE=2.0):
    """Walkers equilibrated by the mixed-state kernel in states drawn
    uniformly from the deltaE table, and the states' quantum numbers."""
    occ_table, _ = ORB.fermion_states(nup, 0, deltaE)
    ks = int(max(ORB.nx[occ_table].max(), ORB.ny[occ_table].max())) + 1
    gen = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, occ_table.shape[0], (B,), generator=gen,
                        device=device)
    occ = torch.as_tensor(occ_table, device=device).long()[idx]
    nx = torch.as_tensor(ORB.nx, device=device)[occ].T.contiguous()
    ny = torch.as_tensor(ORB.ny, device=device)[occ].T.contiguous()
    x0 = torch.randn((2 * nup, B), generator=gen, device=device)
    tau = torch.full((B,), 0.3, device=device)
    x, _, _ = metropolis_multistate_cm(x0, tau, seed, steps=200, nx_cm=nx,
                                       ny_cm=ny, num_shells=ks)
    return x, nx, ny, ks, gen


def _agree_on_shared_stream(k, p):
    """Positions equal on all but a rare walker whose accept decision
    flips on the last bit of exp(); logp and rates agree on the rest."""
    agree = (k[0] - p[0]).abs().amax(dim=0) == 0
    assert float(agree.double().mean()) >= 0.95
    torch.testing.assert_close(k[1][agree], p[1][agree], rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(k[2][agree], p[2][agree], rtol=0, atol=1e-6)


@pytest.mark.parametrize("nup,ndown,B", [(6, 0, 1000), (2, 1, 33)])
def test_single_chain_kernel_matches_plain_on_shared_stream(cuda, nup, ndown,
                                                            B):
    n = nup + ndown
    x0 = equilibrated(cuda, nup, ndown, B)
    gen = torch.Generator(device=cuda).manual_seed(5)
    steps = 20
    noise = (torch.randn((steps, 2 * n, B), generator=gen, device=cuda),
             torch.rand((steps, B), generator=gen, device=cuda).clamp_min(1e-12))
    tau = torch.full((B,), 0.2, device=cuda)
    kw = dict(steps=steps, noise=noise, **occ(nup, ndown))
    before = _build.LAUNCHES["metropolis_single"]
    k = metropolis_single_cm(x0, tau, 0, **kw)
    p = metropolis_single_cm_plain(x0, tau, 0, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["metropolis_single"] == before + 1
    _agree_on_shared_stream(k, p)


@pytest.mark.parametrize("nup,B", [(6, 1000), (3, 37)])
def test_multistate_kernel_matches_plain_on_shared_stream(cuda, nup, B):
    x0, nx, ny, ks, gen = ms_inputs(cuda, nup, B)
    steps = 20
    noise = (torch.randn((steps, 2 * nup, B), generator=gen, device=cuda),
             torch.rand((steps, B), generator=gen, device=cuda).clamp_min(1e-12))
    tau = torch.full((B,), 0.2, device=cuda)
    kw = dict(steps=steps, nx_cm=nx, ny_cm=ny, num_shells=ks, noise=noise)
    before = _build.LAUNCHES["metropolis_multistate"]
    k = metropolis_multistate_cm(x0, tau, 0, **kw)
    p = metropolis_multistate_cm_plain(x0, tau, 0, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["metropolis_multistate"] == before + 1
    _agree_on_shared_stream(k, p)
    # A quantum number beyond the compiled depth marks the walker NaN.
    bad = nx.clone()
    bad[0, 0] = 99
    xb, lb, ab = metropolis_multistate_cm(x0, tau, 1, steps=2, nx_cm=bad,
                                          ny_cm=ny, num_shells=ks)
    assert torch.isnan(lb[0]) and torch.isfinite(lb[1:]).all()


def test_sampler_grids_fill_the_card(cuda):
    # The paths' batch: 8 lanes per chain place >= 7 warps per SM on
    # average, against 1.9 for one thread per chain.
    from fermiflow_tpu_torch.ops import metropolis as mp

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for got in (mp.metropolis_occupancy(6, 8192),
                mp.metropolis_ms_occupancy(6, 5, 8192)):
        assert got["lanes"] == mp.LANES
        assert min(got["grid_warps"], got["warps_per_sm"] * sms) / sms >= 7


def test_vgh_grids_fill_the_card(cuda):
    # The paths' batch: 8 lanes per walker place >= 8 warps per SM on
    # average, against 1.9 for one thread per walker.
    from fermiflow_tpu_torch.ops import slater_vgh as sv

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for got in (sv.slater_vgh_occupancy(6, 8192),
                sv.slater_vgh_ms_occupancy(6, 5, 8192)):
        assert got["lanes"] == sv.LANES
        assert min(got["grid_warps"], got["warps_per_sm"] * sms) / sms >= 8


@pytest.mark.parametrize("nup,B", [(6, 1000), (3, 37)])
def test_slater_vgh_ms_kernel_matches_plain(cuda, nup, B):
    z, nx, ny, ks, _ = ms_inputs(cuda, nup, B)
    before = _build.LAUNCHES["slater_vgh_ms"]
    k = slater_vgh_ms_cm(z, nx, ny, ks)
    r = slater_vgh_ms_cm_plain(z.double(), nx, ny, ks)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["slater_vgh_ms"] == before + 1
    # tests/test_pallas_slater_vgh.py's f32 tolerances for y, g, H.
    for a, b, tol in zip(k, r, (2e-4, 3e-3, 5e-3)):
        assert a.shape == b.shape
        torch.testing.assert_close(a.double(), b, rtol=tol, atol=tol)
    bad = ny.clone()
    bad[1, 2] = -1
    yb, gb, hb = slater_vgh_ms_cm(z, nx, bad, ks)
    assert torch.isnan(yb[2]) and torch.isnan(hb[:, 2]).all()
    assert torch.isfinite(yb[:2]).all()
