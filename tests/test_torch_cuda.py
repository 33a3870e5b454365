"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither jax nor the JAX package, so it also runs on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: K1 is held to the tests/test_pallas.py class (float32
reassociation between two summation orders) and must be bit-identical from
launch to launch; K2 must equal its plain version exactly (torch.equal).
"""

import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu_torch import GMMConfig, GMMModel, fit_gmm
from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy
from cuda_gmm_mpi_tpu_torch.models.gmm import chunk_events
from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
from cuda_gmm_mpi_tpu_torch.ops.mstep import SuffStats, accumulate_stats, mstep_update

TOL = {"loglik": (1e-5, 0.0), "Nk": (1e-5, 1e-5), "M1": (1e-4, 1e-4),
       "M2": (1e-4, 1e-3)}
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _state(rng, k, d, diag, inactive=()):
    a = rng.normal(size=(k, d, d)) * 0.3
    R = a @ np.transpose(a, (0, 2, 1)) + np.eye(d)
    if diag:
        R = np.stack([np.diag(np.diag(r)) for r in R])
    N = np.abs(rng.normal(size=k)) * 100 + 1
    active = np.ones(k, bool)
    active[list(inactive)] = False
    f32 = lambda v: np.asarray(v, np.float32)
    return dict(N=f32(N), pi=f32(N / N.sum()),
                constant=f32(-d * 0.5 * np.log(2 * np.pi)
                             - 0.5 * np.linalg.slogdet(R)[1]),
                avgvar=f32(rng.uniform(0.01, 0.1, size=k)),
                means=f32(rng.normal(scale=3.0, size=(k, d))), R=f32(R),
                Rinv=f32(np.linalg.inv(R)), active=active)


@pytest.mark.parametrize("n,d,k,block_b", [
    (1000, 3, 5, 512), (4099, 6, 70, 512), (20000, 24, 100, 512),
    (4099, 6, 70, 64),       # 64-event tiles at K_pad = 128
    (30000, 32, 512, 512),   # K_pad = 512: the tile drops to 64 events
])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k1_matches_plain_and_repeats_bit_for_bit(dev, n, d, k, block_b, diag):
    rng = np.random.default_rng(n + k)
    state = state_from_numpy(_state(rng, k, d, diag, inactive=(1,)), device=dev)
    x = torch.as_tensor(rng.normal(scale=2.0, size=(n, d)), dtype=torch.float32,
                        device=dev)
    wt = torch.as_tensor(rng.uniform(0.0, 2.0, size=n), dtype=torch.float32,
                         device=dev)
    A, h, g = fs._prep_params(state, d, diag)
    before = fs.fused_stats.launches
    out = fs.fused_stats(x, wt, A, h, g, diag=diag, block_b=block_b)
    again = fs.fused_stats(x, wt, A, h, g, diag=diag, block_b=block_b)
    ref = fs.fused_stats_plain(x, wt, A, h, g, diag=diag)
    torch.cuda.synchronize()
    assert fs.fused_stats.launches == before + 2
    assert float(out[1][0, 1]) == 0.0
    for a, b, c, name in zip(out, again, ref, TOL):
        assert torch.equal(a, b), name
        rtol, atol = TOL[name]
        err = float((a - c).abs().max())
        assert err <= atol + rtol * float(c.abs().max()), (name, err)


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k1_no_less_accurate_than_plain_far_from_the_mean(dev, diag):
    """Events far from the global mean (|x| ~ 170): the expanded quadratic
    form cancels, and two float32 evaluations drift apart. Against a float64
    evaluation of the same inputs, K1's normwise error is at most twice the
    plain version's (floored at the float32 epsilon)."""
    rng = np.random.default_rng(17)
    n, d, k = 20000, 24, 100
    s = _state(rng, k, d, diag, inactive=(1,))
    s["means"] = rng.uniform(-60.0, 60.0, size=(k, d)).astype(np.float32)
    state = state_from_numpy(s, device=dev)
    x = torch.as_tensor(s["means"][rng.integers(0, k, n)]
                        + rng.normal(size=(n, d)), dtype=torch.float32,
                        device=dev)
    wt = torch.ones(n, dtype=torch.float32, device=dev)
    args = (x, wt) + fs._prep_params(state, d, diag)
    out = fs.fused_stats(*args, diag=diag)
    ref = fs.fused_stats_plain(*args, diag=diag)
    ref64 = fs.fused_stats_plain(*(t.double() for t in args), diag=diag)
    for a, b, c, name in zip(out, ref, ref64, TOL):
        scale = float(c.abs().max())
        err = float((a.double() - c).abs().max()) / scale
        plain = float((b.double() - c).abs().max()) / scale
        assert err <= 2.0 * max(plain, 2.0 ** -23), (name, err, plain)


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k2_equals_plain_and_mstep_update(dev, diag):
    rng = np.random.default_rng(5)
    k, d = 40, 24
    state = state_from_numpy(_state(rng, k, d, diag, inactive=(6,)), device=dev)
    chunks, wts = chunk_events(rng.normal(scale=2.0, size=(3000, d))
                               .astype(np.float32), 1024)
    stats = accumulate_stats(state, torch.as_tensor(chunks, device=dev),
                             torch.as_tensor(wts, device=dev), diag_only=diag)
    nk = stats.Nk.clone()
    nk[3], nk[4] = 0.0, 0.7  # the empty and dead-zone guards
    stats = SuffStats(stats.loglik, nk, stats.M1, stats.M2)
    ops = fs._mstep_operands(state, stats, diag)
    out = fs.mstep(*ops, diag=diag)
    for a, b in zip(out, fs.mstep_plain(*ops, diag=diag)):
        assert torch.equal(a, b)
    N, means, R = mstep_update(state, stats, diag_only=diag)
    assert torch.equal(out[0][:, 0], N) and torch.equal(out[1], means)
    assert torch.equal(torch.diag_embed(out[2]) if diag
                       else out[2].reshape(k, d, d), R)


def test_fit_through_kernels_matches_torch_ops(dev):
    rng = np.random.default_rng(11)
    c = rng.normal(scale=10, size=(4, 5))
    x = np.concatenate([rng.normal(c[i], 1, (500, 5))
                        for i in range(4)]).astype(np.float32)
    kw = dict(min_iters=10, max_iters=10)
    k1, k2 = fs.fused_stats.launches, fs.mstep.launches
    model = GMMModel(GMMConfig(**kw))
    assert model.estep_backend == "cuda"
    res = fit_gmm(x, 8, 4, config=model.config, model=model)
    iters = sum(r[3] for r in res.sweep_log)
    assert fs.mstep.launches - k2 == iters
    assert fs.fused_stats.launches - k1 == iters + len(res.sweep_log)
    ref = fit_gmm(x, 8, 4, config=GMMConfig(estep_backend="torch", **kw))
    assert [m[1] for m in res.merges] == [m[1] for m in ref.merges]
    np.testing.assert_allclose(res.final_loglik, ref.final_loglik, rtol=1e-5)
