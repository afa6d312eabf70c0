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
)
from fermiflow_tpu_torch.ops.metropolis import (
    metropolis_chains,
    metropolis_chains_plain,
)
from fermiflow_tpu_torch.ops.reinforce import (
    block_sum,
    reinforce_cm,
    reinforce_cm_plain,
)
from fermiflow_tpu_torch.ops.slater_vgh import slater_vgh_cm, slater_vgh_cm_plain
from fermiflow_tpu_torch.physics import HO2D

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


def params(device, d_mu, dtype=torch.float32):
    gen = torch.Generator(device=device).manual_seed(1)
    return backflow_init_gaussian(gen, 8, d_mu, std=0.3, dtype=dtype,
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


@pytest.mark.parametrize("d_mu,B", [(8, 100), (None, 37)])
def test_hessian_flow_kernel_matches_plain(cuda, d_mu, B):
    z = equilibrated(cuda, 3, 0, B)
    y, g, H = slater_vgh_cm(z, **occ(3, 0))
    p = params(cuda, d_mu)
    k = hessian_flow_cm(p, z, y, g, H, *TS)
    ref = hessian_flow_cm_plain(f64(p), z.double(), y.double(), g.double(),
                                H.double(), *TS)
    torch.cuda.synchronize()
    for a, r in zip(k, ref):
        # tests/test_hessian_flow.py: err < 1e-4 * scale + 1e-5.
        err = float((a.double() - r).abs().max())
        assert err < 1e-4 * float(r.abs().max()) + 1e-5


@pytest.mark.parametrize("d_mu,B", [(8, 100), (None, 37)])
def test_reinforce_kernels_match_plain(cuda, d_mu, B):
    z = equilibrated(cuda, 3, 0, B)
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = torch.randn((6, B), generator=gen, device=cuda)
    w = torch.randn((B,), generator=gen, device=cuda) / B
    p = params(cuda, d_mu)
    before = _build.LAUNCHES["reinforce_reduce"]
    grads, zb = reinforce_cm(p, z, g, w, *TS)
    ref, zr = reinforce_cm_plain(f64(p), z.double(), g.double(), w.double(),
                                 *TS)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["reinforce_reduce"] == before + 1
    flat = lambda gr: torch.cat([gr[m][k].reshape(-1).double()
                                 for m in ("eta", "mu") if gr[m] is not None
                                 for k in ("w2", "w1", "b1")])
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
