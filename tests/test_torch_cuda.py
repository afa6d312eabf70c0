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
    reciprocal_margin,
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
from fermiflow_tpu_torch.physics import HO2D, FreeFermion

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


@pytest.mark.parametrize("nup,ndown,B", [(6, 0, 100), (2, 1, 33),
                                         (10, 0, 100), (5, 4, 33)])
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


@pytest.mark.parametrize("nup,ndown,B", [(6, 0, 100), (2, 1, 33),
                                         (10, 0, 100), (5, 4, 33)])
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
# warp, to N = 6; 4 walkers per block from N = 7): 37 and 8191 end mid-warp
# (N <= 6) or mid-block, 100 mid-block (N <= 6).  d_eta is 8: d_mu = 5 and
# 12 give the 8-lane schedule unequal widths (its units padded with zeros).
@pytest.mark.parametrize("nup,d_mu,B", [
    (3, 8, 100), (3, None, 37), (2, 8, 37), (2, None, 8191), (6, 8, 8191),
    (6, None, 37), (10, 8, 4095), (9, None, 37), (6, 5, 100), (6, 12, 37),
    (4, 8, 37), (5, 8, 100), (5, None, 8191)])
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


@pytest.mark.parametrize("nup", [3, 6, 10])
def test_hessian_flow_kernel_both_reciprocal_paths(cuda, nup):
    # One eta unit with w1 = 30: a lane whose pair distance r passes
    # 80 / 30 runs its hidden-unit loop on the division, the others on the
    # range-checked reciprocal, in one warp (at N = 10 the 32-lane
    # schedule); both give the plain result.
    z = equilibrated(cuda, nup, 0, 1001)
    y, g, H = slater_vgh_cm(z, **occ(nup, 0))
    p = params(cuda, 8)
    p["eta"]["w1"][0, 0] = 30.0
    k = hessian_flow_cm(p, z, y, g, H, *TS)
    again = hessian_flow_cm(p, z, y, g, H, *TS)
    ref = hessian_flow_cm_plain(f64(p), z.double(), y.double(), g.double(),
                                H.double(), *TS)
    torch.cuda.synchronize()
    d = z.reshape(nup, 2, -1)
    r = (d[:, None] - d[None]).square().sum(2).sqrt()
    assert bool((r > 80 / 30).any()) and bool((r[0, 1] < 80 / 30).any())
    for a, b, rr in zip(k, again, ref):
        assert torch.equal(a, b)
        err = float((a.double() - rr).abs().max())
        assert err < 1e-4 * float(rr.abs().max()) + 1e-5


def test_hessian_flow_occupancy(cuda):
    # The paths' widths (N=6, d_eta = d_mu = 50): at least 8 warps per SM,
    # against one (Hessian flow) and two (adjoint) warps per SM for the
    # one-thread-per-walker designs.
    assert hessian_flow_occupancy(6, 50, 50) >= 8
    assert reinforce_occupancy(6, 50, 50) >= 8


def test_n10_occupancy(cuda):
    # N = 10 at the paths' widths: 4 blocks (16 warps) per SM of both
    # kernels at <= 128 registers, the Hessian flow's a warp per walker, the
    # adjoint's 16 lanes per walker with the dopri5 slopes in shared memory.
    assert hessian_flow_occupancy(10, 50, 50) >= 16
    assert reinforce_occupancy(10, 50, 50) >= 16


# 16 walkers per adjoint block, 4 per warp (to N = 6), 8 and 2 (from N = 7):
# 37 and 8191 end mid-warp, 100 mid-block.
@pytest.mark.parametrize("nup,d_mu,B", [(3, 8, 100), (3, None, 37),
                                        (6, 8, 8191), (6, None, 37),
                                        (10, 8, 4093), (7, None, 100)])
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


@pytest.mark.parametrize("nup", [6, 10])
def test_reinforce_kernel_both_reciprocal_paths(cuda, nup):
    # The paths' widths (d_eta = d_mu = 50: 48 units dealt over the lanes,
    # the last 2 run by every lane on its own inputs).  B walkers whose
    # every MLP input keeps r |w1|max + |b1|max < 80 take the range-checked
    # reciprocal; the same walkers and one more, a particle pushed past
    # that, take the division in that walker's warp (with an in-range
    # walker beside it).  Both batches give the plain result, and the
    # walkers they share the same z_back bits.
    B = 37
    z = equilibrated(cuda, nup, 0, B)
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = torch.randn((2 * nup, B + 1), generator=gen, device=cuda)
    w = torch.randn((B + 1,), generator=gen, device=cuda) / B
    p = backflow_init_gaussian(torch.Generator(device=cuda).manual_seed(1),
                               50, 50, std=0.1, dtype=torch.float32,
                               device=cuda)
    far = z[:, -1:].clone()
    far[0] += 100.0 / float(p["eta"]["w1"].abs().max())
    batches = [(z, g[:, :B].contiguous(), w[:B].contiguous()),
               (torch.cat([z, far], dim=1).contiguous(), g, w)]
    shares = [reciprocal_margin(p, zz.T.reshape(-1, nup, 2))["share_under"]
              for zz, _, _ in batches]
    assert shares == [1.0, pytest.approx(B / (B + 1))]
    flat = lambda gr: torch.cat([gr[m][k].reshape(-1).double()
                                 for m in ("eta", "mu")
                                 for k in ("w2", "w1", "b1")])
    zbs = []
    for zz, gg, ww in batches:
        grads, zb = reinforce_cm(p, zz, gg, ww, *TS)
        ref, zr = reinforce_cm_plain(f64(p), zz.double(), gg.double(),
                                     ww.double(), *TS)
        torch.cuda.synchronize()
        a, b = flat(grads), flat(ref)
        # test_reinforce_kernels_match_plain's bound.
        torch.testing.assert_close(a, b, rtol=2e-5,
                                   atol=3e-6 * float(b.abs().max()))
        torch.testing.assert_close(zb.double(), zr, rtol=1e-5, atol=1e-5)
        zbs.append(zb)
    assert torch.equal(zbs[0], zbs[1][:, :B])


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


def ms_inputs(device, nup, B, seed=4, deltaE=None):
    """Walkers equilibrated by the mixed-state kernel in states drawn
    uniformly from the deltaE table (by default 2 to N = 6, and 4, quantum
    numbers to 7, from N = 7), and the states' quantum numbers."""
    if deltaE is None:
        deltaE = 2.0 if nup <= 6 else 4.0
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


@pytest.mark.parametrize("nup,ndown,B", [(6, 0, 1000), (2, 1, 33),
                                         (10, 0, 1000)])
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


@pytest.mark.parametrize("nup,B", [(6, 1000), (3, 37), (10, 2048), (7, 100)])
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


def test_ms_n10_grids_are_resident_at_once(cuda):
    # The finite-T path at N = 10 (batch 2048, depth 8): 512 warps of
    # either 8-lane grid, all resident at once (the sampler at 4 blocks
    # per SM, the VGH kernel at one of 8 warps).
    from fermiflow_tpu_torch.ops import metropolis as mp
    from fermiflow_tpu_torch.ops import slater_vgh as sv

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for got, resident in ((mp.metropolis_ms_occupancy(10, 8, 2048), 16),
                          (sv.slater_vgh_ms_occupancy(10, 8, 2048), 8)):
        assert got["lanes"] == 8 and got["grid_warps"] == 512
        assert got["warps_per_sm"] >= resident
        assert got["warps_per_sm"] * sms >= got["grid_warps"]


def test_vgh_grids_fill_the_card(cuda):
    # The paths' batch: 8 lanes per walker place >= 8 warps per SM on
    # average, against 1.9 for one thread per walker.
    from fermiflow_tpu_torch.ops import slater_vgh as sv

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for got in (sv.slater_vgh_occupancy(6, 8192),
                sv.slater_vgh_ms_occupancy(6, 5, 8192)):
        assert got["lanes"] == sv.LANES
        assert min(got["grid_warps"], got["warps_per_sm"] * sms) / sms >= 8


@pytest.mark.parametrize("nup,B", [(6, 1000), (3, 37), (10, 2048), (7, 100)])
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


@pytest.mark.parametrize("entry", ["chains", "single", "multistate"])
def test_sampler_rows_at_walker0_are_the_full_launchs(cuda, entry):
    """A launch on rows k.. at walker0 = k (a rank of a walker mesh on its
    rows) walks bitwise the chains of those rows in the launch over every
    walker, on the kernels' own Philox stream."""
    B, k = 1000, 376
    z, nx, ny, ks, _ = ms_inputs(cuda, 6, B)
    tau = torch.full((B,), 0.2, device=cuda)
    rows = lambda t, first: t[..., first:].contiguous()

    def launch(first, walker0):
        if entry == "chains":
            return metropolis_chains(
                rows(z, first), rows(tau, first), 7, steps=5, segments=3,
                walker0=walker0, **occ(6, 0))
        if entry == "single":
            return metropolis_single_cm(rows(z, first), rows(tau, first), 8,
                                        steps=5, walker0=walker0,
                                        **occ(6, 0))
        return metropolis_multistate_cm(
            rows(z, first), rows(tau, first), 9, steps=5,
            nx_cm=rows(nx, first), ny_cm=rows(ny, first), num_shells=ks,
            walker0=walker0)

    full, part = launch(0, 0), launch(k, k)
    for a, b in zip(full, part):
        assert torch.equal(a[..., k:], b)


def test_sample_use_pallas_launches_kernel_5(cuda):
    """``FreeFermion.sample(use_pallas=True)`` on a CUDA generator: one
    launch of kernel #5 for a polarized float32 draw, none for float64 (the
    plain sampler, as in the JAX package); the kernel's draw against the
    plain sampler's by distribution (<sum x^2> within 5 standard errors,
    acceptance within 0.01); a float32 occupation the kernels lack raises."""
    fb = FreeFermion(ORB)
    up, dn = np.arange(6), np.arange(0)
    kw = dict(equilibrium_steps=200, tau=0.1, return_accept=True)
    before = _build.LAUNCHES["metropolis_single"]
    x, acc = fb.sample(up, dn, torch.Generator(device=cuda).manual_seed(1),
                       (8192,), dtype=torch.float32, use_pallas=True, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["metropolis_single"] == before + 1
    assert x.device.type == "cuda" and torch.isfinite(x).all()
    xp, accp = fb.sample(up, dn, torch.Generator(device=cuda).manual_seed(2),
                         (8192,), dtype=torch.float32, **kw)
    assert _build.LAUNCHES["metropolis_single"] == before + 1
    r2, r2p = ((a.double()**2).sum((-2, -1)) for a in (x, xp))
    se = float(torch.hypot(r2.std(), r2p.std())) / 8192**0.5
    assert abs(float(r2.mean() - r2p.mean())) < 5 * se
    assert abs(float(acc.mean() - accp.mean())) < 0.01
    fb.sample(up, dn, torch.Generator(device=cuda).manual_seed(3), (64,),
              dtype=torch.float64, use_pallas=True, **kw)
    assert _build.LAUNCHES["metropolis_single"] == before + 1
    with pytest.raises(ValueError):
        fb.sample(np.arange(11), dn, torch.Generator(device=cuda).manual_seed(4),
                  (64,), dtype=torch.float32, use_pallas=True, **kw)


# ---- the captured chunk (train.py): replays against eager chunks ----


def _graph_cfg(finite, K, **kw):
    from fermiflow_tpu_torch.config import Config

    cfg = Config(**{**dict(nup=3, batch=256, d_eta=8, d_mu=8, ode_steps=2,
                           mcmc_steps=5, equilibrium_steps=20,
                           dtype="float32", persistent_walkers=True,
                           steps_per_call=K, lr=1e-3, device="cuda"), **kw})
    if finite:
        cfg.beta, cfg.deltaE, cfg.boltzmann = 2.0, 2.0, True
    return cfg


def _graph_run(finite, K, graph, chunks, state=None, cfg=None):
    """``chunks`` chunks of K iterations from a fresh state (or ``state``)
    at N = 3, B = 256: the GS fused chunk (K > 1), the GS K = 1 step or
    the finite-T multi-step, captured or eager.  (state, metrics, chunk)."""
    from fermiflow_tpu_torch.cli import common
    from fermiflow_tpu_torch.train import (
        init_beta_state,
        init_gs_state,
        make_beta_train_step,
        make_gs_fused_multi_step,
        make_gs_train_step,
        make_multi_step,
    )

    cfg = cfg or _graph_cfg(finite, K)
    if finite:
        model, params = common.build_beta(cfg)
        state = state or init_beta_state(model, params, cfg,
                                         torch.device("cuda"))
        chunk = make_multi_step(make_beta_train_step(model, cfg, graph=graph),
                                K)
    else:
        model, params = common.build_gs(cfg)
        state = state or init_gs_state(model, params, cfg,
                                       torch.device("cuda"))
        chunk = (make_gs_fused_multi_step(model, cfg, K, graph=graph) if K > 1
                 else make_multi_step(make_gs_train_step(model, cfg,
                                                         graph=graph), 1))
    metrics = []
    for _ in range(chunks):
        state, m = chunk(state)
        metrics.append({k: v.clone() for k, v in m.items()})
    torch.cuda.synchronize()
    return state, metrics, chunk


def _state_tensors(state):
    """Every tensor a chunk changes: the state's, Adam's step and moments
    and the generators' states."""
    from fermiflow_tpu_torch.utils.checkpointing import named_tensors

    out = dict(named_tensors(state))
    for i, st in enumerate(state.optimizer.state.values()):
        out.update({f"adam{i}.{k}": v for k, v in st.items()})
    out["generator"] = state.generator.get_state()
    if state.device_generator is not None:
        out["device_generator"] = state.device_generator.get_state()
    return out


def _bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k


@pytest.mark.parametrize("persistent", [True, False],
                         ids=["persistent", "fresh"])
@pytest.mark.parametrize("finite,K", [(False, 3), (False, 1), (True, 3)])
def test_captured_chunk_replays_the_eager_chunk_bitwise(cuda, finite, K,
                                                        persistent):
    """Three chunks (the eager warm-up, then two replays) against three
    eager chunks from the same seed, with persistent and with fresh walkers
    (drawn from the registered device generator): the state, Adam and the
    generators, and every metric, bitwise; each replay counts the kernels
    it ran."""
    cfg = _graph_cfg(finite, K, persistent_walkers=persistent)
    _build.reset_launch_counts()
    s_g, m_g, chunk = _graph_run(finite, K, True, 3, cfg=cfg)
    counts = dict(_build.LAUNCHES)
    _build.reset_launch_counts()
    s_e, m_e, _ = _graph_run(finite, K, False, 3, cfg=cfg)
    assert counts == _build.LAUNCHES
    assert chunk.capture_seconds > 0 and chunk.pool_bytes >= 0
    assert s_g.step == s_e.step == 3 * K
    _bitwise(_state_tensors(s_g), _state_tensors(s_e))
    for a, b in zip(m_g, m_e):
        _bitwise(a, b)


# The autograd A/B paths at K = 3: (finite T, the flags).
NO_PALLAS = dict(pallas_sampler=False, pallas_local_energy=False,
                 pallas_reinforce=False)
AB_PATHS = {"no_pallas": (False, NO_PALLAS),
            "nested_jvp": (False, dict(local_energy="nested_jvp")),
            "no_pallas_beta": (True, NO_PALLAS),
            "no_pallas_reinforce": (False, dict(pallas_reinforce=False))}


@pytest.mark.parametrize("persistent", [True, False],
                         ids=["persistent", "fresh"])
@pytest.mark.parametrize("path", list(AB_PATHS))
def test_captured_ab_chunk_replays_the_eager_chunk_bitwise(cuda, path,
                                                           persistent):
    """The autograd A/B paths (``--no-pallas-*`` at GS and finite T, the
    nested-jvp engine, ``--no-pallas-reinforce`` alone), three chunks of 3
    captured against three eager ones, persistent and fresh: the state,
    Adam, both generators and every metric bitwise, and the same kernel
    launches (none where every flag is off)."""
    finite, kw = AB_PATHS[path]
    cfg = _graph_cfg(finite, 3, persistent_walkers=persistent, **kw)
    _build.reset_launch_counts()
    s_g, m_g, chunk = _graph_run(finite, 3, True, 3, cfg=cfg)
    counts = dict(_build.LAUNCHES)
    _build.reset_launch_counts()
    s_e, m_e, _ = _graph_run(finite, 3, False, 3, cfg=cfg)
    assert counts == _build.LAUNCHES
    assert (sum(counts.values()) == 0) == (kw is NO_PALLAS)
    assert chunk._replay is not None and s_g.step == s_e.step == 9
    _bitwise(_state_tensors(s_g), _state_tensors(s_e))
    for a, b in zip(m_g, m_e):
        _bitwise(a, b)


def test_eager_checkpoint_restores_into_the_captured_chunk(cuda, tmp_path):
    """A checkpoint of an eager run, once as saved and once with Adam's step
    count on the CPU (as a non-capturable Adam saves it), restored into a
    fresh state and continued by captured chunks: bitwise the eager run
    that never stopped."""
    from fermiflow_tpu_torch.utils.checkpointing import (
        restore_checkpoint,
        save_checkpoint,
    )

    cfg = _graph_cfg(False, 3)
    s_e, _, _ = _graph_run(False, 3, False, 2, cfg=cfg)
    save_checkpoint(str(tmp_path / "a"), s_e.step, s_e)
    payload = torch.load(tmp_path / "a" / "ckpt_00000006.pt",
                         weights_only=True)
    for g in payload["optimizer"]["param_groups"]:
        g["capturable"] = False
    (tmp_path / "b").mkdir()
    torch.save(payload, tmp_path / "b" / "ckpt_00000006.pt")
    s_e, _, _ = _graph_run(False, 3, False, 2, state=s_e, cfg=cfg)
    for d in ("a", "b"):
        fresh, _, _ = _graph_run(False, 3, True, 0, cfg=cfg)
        fresh, step = restore_checkpoint(str(tmp_path / d), fresh)
        assert step == 6
        s_g, _, _ = _graph_run(False, 3, True, 2, state=fresh, cfg=cfg)
        _bitwise(_state_tensors(s_g), _state_tensors(s_e))
