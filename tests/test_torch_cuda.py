"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither jax nor the JAX package, so it also runs on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: K1 (three TF32 passes on the tensor cores) is held to the
tests/test_pallas.py class (float32 reassociation between two summation
orders) and must be bit-identical from launch to launch; so is K1 at
'high' and 'default' (bf16 passes) against its plain version at the same
precision, and within twice that version's error against float64; on blobs far from
the mean K1, K3 and K6 are held against float64 at twice the plain
version's error. K2 (the whole M-step) must give the torch-ops M-step's
``ok``, N, means and R exactly (torch.equal), Rinv and constant within
twice its error against a float64 compute_constants of the same updated R
(its Cholesky is another float32 factorization), and pi within 4 ulps
(another summation order); one M-step hook call is one kernel on the card.
Each live lane of K3 must equal K1 on its operands and each lane of K4 K2
(torch.equal): they run the same kernels. K5's per-event max is held to
its plain version normwise at 1e-6 (it is one of the logp values). Its
shifted sum adds exponentials of float32 logp differences, so two float32
evaluations differ by ~|logp| x 1e-7 relative (2.5e-6 normwise measured on
an H100 where clusters overlap): it is held against a float64 evaluation,
at most twice the plain version's error there. K6 is held to the K1 class, and the shards of K5 + K6 put side by side to K1 on the whole
K; both repeat bit for bit. At 'high' and 'default' K5/K6 run on K1's
kernel for every shard width and are held as ``_hold_stat`` says: against
float64 at twice the plain version's error (floored at the mode's unit
roundoff) always, and in the class of the plain version wherever that
version itself lies within the class of float64. The mesh tests run 2-rank
gloo worlds on the one GPU against single-device EM (float32, loglik rtol
1e-5); there K3 on a rank's block of the events and K4 on the all_reduced
statistics must be torch.equal to the same launches outside the world, and
restarts on a mesh (K3/K4 per rank, or K5/K6 per lane when the clusters
are sharded) must pick the one-card fit's init, K and merge pairs. ``GaussianMixture`` fits spherical and tied on the card (K1 for the
statistics, the torch-ops M-step) against the same fits on torch ops.
"""

import dataclasses
import gc
import time

import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu_torch import GMMConfig, GMMModel, fit_gmm
from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy
from cuda_gmm_mpi_tpu_torch.models.gmm import chunk_events
from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
from cuda_gmm_mpi_tpu_torch.ops.mstep import (
    SuffStats, accumulate_stats, apply_mstep, mstep_update,
)
from cuda_gmm_mpi_tpu_torch.state import lane, stack_states

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


def _far_state(rng, k, d, diag):
    s = _state(rng, k, d, diag, inactive=(1,))
    s["means"] = rng.uniform(-60.0, 60.0, size=(k, d)).astype(np.float32)
    return s


def _within_twice_plain(out, ref, ref64, name, floor=2.0 ** -23):
    """Normwise against float64: at most twice the plain version's error
    (floored at the arithmetic's unit roundoff: the float32 epsilon)."""
    scale = float(ref64.abs().max())
    err = float((out.double() - ref64).abs().max()) / scale
    plain = float((ref.double() - ref64).abs().max()) / scale
    assert err <= 2.0 * max(plain, floor), (name, err, plain)


# The unit roundoff of each bf16 mode, the floor of its float64 bar: 'high'
# keeps 16 of fp32's 24 mantissa bits of each operand (bf16 big + bf16
# small), 'default' 8.
BF16_FLOOR = {"high": 2.0 ** -17, "default": 2.0 ** -9}


def _hold_stat(a, c, c64, label, name, precision):
    """A K5/K6 output ``a`` at a bf16 precision against its plain version
    ``c`` at that precision and a float64 evaluation ``c64``: always within
    twice the plain version's float64 error (floored at the mode's unit
    roundoff), and in the tests/test_pallas.py class of ``c``, which it may
    miss only where the plain version itself lies outside that class of
    float64: there two evaluations of the mode differ by their own error:
    K6's weights
    exp(logp - logZ) carry logp's absolute error (no normalisation cancels
    it, as K1's e/s does), and one bf16 pass rounds each w to 8 bits, which
    two float32 evaluations of w straddle here and there. Measured on an
    H100: K6 'default' M2 1.02e-4 normwise against its plain version at
    N = 2053, D = 6, K_s = 130 (class 1e-4). An all-zero output (the
    all-masked shard) must be exactly zero."""
    if float(c64.abs().max()) == 0.0:
        assert not a.any(), (label, name)
        return
    _within_twice_plain(a, c, c64, f"{label} {name}", BF16_FLOOR[precision])
    assert (_within(a, c, TOL[name])
            or _normwise(c.double(), c64) > TOL[name][0]), (
        label, name, _normwise(a, c))


def _within(a, c, bar) -> bool:
    rtol, atol = bar
    return float((a - c).abs().max()) <= atol + rtol * float(c.abs().max())


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k1_no_less_accurate_than_plain_far_from_the_mean(dev, diag):
    """Events far from the global mean (|x| ~ 170): the expanded quadratic
    form cancels, and two float32 evaluations drift apart. Against a float64
    evaluation of the same inputs, the normwise error of K1, of K3's live
    lanes (a second far state, one frozen lane) and of K6 (one shard of 50
    clusters, from the float64 logZ of all K) is at most twice the plain
    version's (floored at the float32 epsilon)."""
    rng = np.random.default_rng(17)
    n, d, k = 20000, 24, 100
    states = [_far_state(rng, k, d, diag) for _ in range(2)]
    s = states[0]
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
        _within_twice_plain(a, b, c, "K1 " + name)

    params = [args[2:], fs._prep_params(state_from_numpy(states[1], device=dev),
                                        d, diag), args[2:]]
    A3, h3, g3 = (torch.stack(p) for p in zip(*params))
    lanes = torch.tensor([1.0, 0.0, 1.0], device=dev)
    args3 = (x, wt, lanes, A3, h3, g3)
    out = fs.fused_stats_batched(*args3, diag=diag)
    ref = fs.fused_stats_batched_plain(*args3, diag=diag)
    ref64 = fs.fused_stats_batched_plain(*(t.double() for t in args3), diag=diag)
    live = [0, 2]
    for a, b, c, name in zip(out, ref, ref64, TOL):
        _within_twice_plain(a[live], b[live], c[live], "K3 " + name)

    A, h, g = args[2:]
    logp64, _ = fs._logp_plain(x.double(), A.double(), h.double(), g.double(),
                               diag)
    logz = torch.logsumexp(logp64, dim=1, keepdim=True).float()
    args6 = (x, wt, logz) + tuple(t[:, :50].contiguous() for t in (A, h, g))
    out = fs.stats_logz(*args6, diag=diag)
    ref = fs.stats_logz_plain(*args6, diag=diag)
    ref64 = fs.stats_logz_plain(*(t.double() for t in args6), diag=diag)
    for a, b, c, name in zip(out, ref, ref64, TOL):
        _within_twice_plain(a, b, c, "K6 " + name)


@pytest.mark.parametrize("n,d,k,block_b", [
    (1000, 3, 5, 512), (20000, 24, 100, 512),
    (4099, 6, 70, 64),       # 64-event tiles at K_pad = 128
    (30000, 32, 512, 512),   # K_pad = 512: the tile drops to 64 events
])
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k1_bf16_modes_match_plain_float64_and_repeat(dev, n, d, k, block_b,
                                                      precision, diag):
    """K1 at 'high' (three bf16 passes) and 'default' (one) against its
    plain version at the same precision (the tests/test_pallas.py class),
    against a float64 evaluation (at most twice the plain version's error,
    floored at the mode's unit roundoff, 2^-17 or 2^-9), and bit-identical
    from launch to launch; also on blobs far from the mean (|x| ~ 170),
    where only the float64 bar applies. The floor matters for the loglik at
    'high': the tensor cores truncate the sums of phase 1's bf16 products
    (toward zero, a few fp32 ulps per 16-deep step), where the plain
    version rounds to nearest; measured on an H100 at N = 30000, D = 32,
    K = 512: 1.07e-5 against the plain version's 4.88e-6, under
    2 x 2^-17 = 1.53e-5."""
    rng = np.random.default_rng(n + k + 7)
    for far in (False, True):
        s = (_far_state(rng, k, d, diag) if far
             else _state(rng, k, d, diag, inactive=(1,)))
        state = state_from_numpy(s, device=dev)
        xs = (s["means"][rng.integers(0, k, n)] + rng.normal(size=(n, d))
              if far else rng.normal(scale=2.0, size=(n, d)))
        x = torch.as_tensor(xs, dtype=torch.float32, device=dev)
        wt = torch.as_tensor(rng.uniform(0.0, 2.0, size=n),
                             dtype=torch.float32, device=dev)
        args = (x, wt) + fs._prep_params(state, d, diag)
        kw = dict(diag=diag, block_b=block_b, precision=precision)
        out = fs.fused_stats(*args, **kw)
        again = fs.fused_stats(*args, **kw)
        ref = fs.fused_stats_plain(*args, diag=diag, precision=precision)
        ref64 = fs.fused_stats_plain(*(t.double() for t in args), diag=diag)
        torch.cuda.synchronize()
        assert float(out[1][0, 1]) == 0.0
        for a, b, c, c64, name in zip(out, again, ref, ref64, TOL):
            assert torch.equal(a, b), name
            _within_twice_plain(a, c, c64, f"K1 {precision} {name}",
                                BF16_FLOOR[precision])
            if far:
                continue
            rtol, atol = TOL[name]
            err = float((a - c).abs().max())
            assert err <= atol + rtol * float(c.abs().max()), (name, err)


@pytest.mark.parametrize("n,d,k", [(4099, 6, 70), (3000, 6, 400)])
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k3_bf16_modes_lanes_equal_k1(dev, n, d, k, precision, diag):
    """Each live K3 lane torch.equal to K1 at the same precision; a frozen
    lane all zeros."""
    rng = np.random.default_rng(n + k + 5)
    states = [state_from_numpy(_state(rng, k, d, diag, inactive=inact),
                               device=dev) for inact in ((1,), (), (0, 3))]
    x = torch.as_tensor(rng.normal(scale=2.0, size=(n, d)), dtype=torch.float32,
                        device=dev)
    wt = torch.ones(n, dtype=torch.float32, device=dev)
    params = [fs._prep_params(s, d, diag) for s in states]
    A, h, g = (torch.stack(p) for p in zip(*params))
    lanes = torch.tensor([1.0, 0.0, 1.0], device=dev)
    out = fs.fused_stats_batched(x, wt, lanes, A, h, g, diag=diag,
                                 precision=precision)
    for r in (0, 2):
        one = fs.fused_stats(x, wt, *params[r], diag=diag, precision=precision)
        for a, b in zip(out, one):
            assert torch.equal(a[r], b)
    assert not any(bool(a[1].any()) for a in out)


@pytest.mark.parametrize("n,d,k", [
    (4099, 6, 70),     # K_s = 35: the shard kernel's width, K1's kernel here
    (5003, 24, 100),   # K_s = 50, the mesh cell's shard
    (3001, 6, 130),    # K_s = 65: one 128-wide tile
    (2053, 6, 260)])   # K_s = 130: two tiles
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k5_k6_bf16_modes_match_plain_and_k1(dev, n, d, k, precision, diag):
    """K5/K6 at 'high' and 'default' (K1's kernel in their modes, bf16
    passes, for every shard width) on two cluster shards, the last one all
    inactive: K5's max in the tests/test_pallas.py class of its plain
    version at that precision, its shifted sum against float64 at twice the
    plain version's error floored at the mode's unit roundoff; K6's
    statistics and the shards combined side by side against K1 held as
    ``_hold_stat`` holds them; bit-identical from launch to launch; counted
    under their precision. And the route is really the bf16 one: K5's max
    differs from the 'highest' launch's."""
    rng = np.random.default_rng(n + k + 5)
    shards, ks = 2, -(-k // 2)
    state = state_from_numpy(_state(rng, k, d, diag,
                                    inactive=range(ks, k)), device=dev)
    x = torch.as_tensor(rng.normal(scale=2.0, size=(n, d)), dtype=torch.float32,
                        device=dev)
    wt = torch.as_tensor(rng.uniform(0.0, 2.0, size=n), dtype=torch.float32,
                         device=dev)
    A, h, g = fs._prep_params(state, d, diag)
    cols = [slice(i * ks, min(k, (i + 1) * ks)) for i in range(shards)]
    parts = [tuple(t[:, c].contiguous() for t in (A, h, g)) for c in cols]
    kw = dict(diag=diag, precision=precision)
    before = (fs.local_lse.precision_launches[precision],
              fs.stats_logz.precision_launches[precision])
    lse = [fs.local_lse(x, *p, **kw) for p in parts]
    for p, (m, s) in zip(parts, lse):
        m2, s2 = fs.local_lse(x, *p, **kw)
        pm, ps = fs.local_lse_plain(x, *p, **kw)
        _, ps64 = fs.local_lse_plain(x.double(), *(t.double() for t in p),
                                     diag=diag)
        assert torch.equal(m, m2) and torch.equal(s, s2)
        assert _normwise(m, pm) <= TOL["loglik"][0]
        assert (_normwise(s.double(), ps64) <= 2.0 * max(
            _normwise(ps.double(), ps64), BF16_FLOOR[precision]))
    m0_highest, _ = fs.local_lse(x, *parts[0], diag=diag)
    assert not torch.equal(lse[0][0], m0_highest)
    assert bool((lse[-1][0] == fs.NEG_LARGE).all())
    big_m = torch.stack([m for m, _ in lse]).max(dim=0).values
    logz = big_m + torch.log(sum(torch.exp(m - big_m) * s for m, s in lse))
    outs = []
    for p in parts:
        out = fs.stats_logz(x, wt, logz, *p, **kw)
        again = fs.stats_logz(x, wt, logz, *p, **kw)
        ref = fs.stats_logz_plain(x, wt, logz, *p, **kw)
        ref64 = fs.stats_logz_plain(x.double(), wt.double(), logz.double(),
                                    *(t.double() for t in p), diag=diag)
        for a, b, c, c64, name in zip(out, again, ref, ref64, TOL):
            assert torch.equal(a, b), name
            _hold_stat(a, c, c64, f"K6 {precision}", name, precision)
        outs.append(out)
    torch.cuda.synchronize()
    assert fs.local_lse.precision_launches[precision] - before[0] == 2 * shards
    assert fs.stats_logz.precision_launches[precision] - before[1] == 2 * shards
    k1 = fs.fused_stats(x, wt, A, h, g, **kw)
    k1_plain = fs.fused_stats_plain(x, wt, A, h, g, **kw)
    k1_64 = fs.fused_stats_plain(*(t.double() for t in (x, wt, A, h, g)),
                                 diag=diag)
    side = (outs[0][0], torch.cat([o[1] for o in outs], dim=1),
            torch.cat([o[2] for o in outs]), torch.cat([o[3] for o in outs]))
    for a, c, c1, c64, name in zip(side, k1, k1_plain, k1_64, TOL):
        _within_twice_plain(a, c1, c64, f"K5+K6 {precision} {name}",
                            BF16_FLOOR[precision])
        assert (_within(a, c, TOL[name])
                or _normwise(c1.double(), c64) > TOL[name][0]), (
            name, _normwise(a, c))
    assert not outs[-1][1].any()


@pytest.mark.parametrize("family", ["spherical", "tied"])
def test_gaussian_mixture_family_on_the_card(dev, family):
    """A spherical (diag statistics) and a tied (full statistics) fit of
    ``GaussianMixture`` on the card: K1 runs every E-step, the M-step is
    the torch-ops update (no K2 launch, as in the JAX package); the torch-ops
    fit's K and merge pairs, loglik within rtol 1e-4; the family's
    structure holds; inference sums to the fit's loglik."""
    from cuda_gmm_mpi_tpu_torch import GaussianMixture

    rng = np.random.default_rng(19)
    c = rng.normal(scale=10, size=(4, 5))
    x = np.concatenate([rng.normal(c[i], 1, (500, 5))
                        for i in range(4)]).astype(np.float32)
    kw = dict(covariance_type=family, min_iters=10, max_iters=10)
    launches = (fs.fused_stats.launches, fs.mstep.launches)
    gm = GaussianMixture(8, 4, **kw).fit(x)
    assert gm._model.estep_backend == "cuda"
    assert fs.fused_stats.launches - launches[0] > 0
    assert fs.mstep.launches == launches[1]
    ref = GaussianMixture(8, 4, estep_backend="torch", **kw).fit(x)
    assert gm.n_components_ == ref.n_components_ == 4
    assert [m[1] for m in gm.result_.merges] == [m[1] for m in
                                                 ref.result_.merges]
    np.testing.assert_allclose(gm.loglik_, ref.loglik_, rtol=1e-4)
    cov = gm.covariances_
    for i in range(4):
        if family == "tied":
            np.testing.assert_array_equal(cov[i], cov[0])
        else:
            assert np.ptp(np.diag(cov[i])) == 0.0
    np.testing.assert_allclose(gm.score_samples(x).sum(), gm.loglik_,
                               rtol=1e-4)
    np.testing.assert_allclose(gm.predict_proba(x).sum(axis=1), 1.0,
                               atol=1e-5)


def test_gaussian_mixture_lands_on_the_card_by_default(dev):
    from cuda_gmm_mpi_tpu_torch import GaussianMixture

    rng = np.random.default_rng(23)
    x = rng.normal(size=(600, 3)).astype(np.float32)
    gm = GaussianMixture(3, 2, min_iters=3, max_iters=3)
    assert gm.config.device == "cuda"
    gm.fit(x)
    assert gm._model.device.type == "cuda"
    assert gm._model.estep_backend == "cuda"


@pytest.mark.parametrize("precision", ["high", "default"])
def test_fit_bf16_modes_through_kernels_match_torch_ops(dev, precision):
    """A fit through K1/K2 at 'high' and 'default'. At 'high', against the
    torch-ops path at 'high' (ops/estep.py::kdot): the same merge pairs,
    final loglik within rtol 1e-4 (the float32 fit class). At 'default' the
    two paths' one-pass bf16 roundings of w (steps of 2^-9) flip wherever
    two float32 evaluations of w straddle a bf16 boundary, so their merge
    choices part ways (seen on an H100); there the kernel fit is held to
    what the path promises: every K of the sweep, finite, down to the
    target."""
    rng = np.random.default_rng(11)
    c = rng.normal(scale=10, size=(4, 5))
    x = np.concatenate([rng.normal(c[i], 1, (500, 5))
                        for i in range(4)]).astype(np.float32)
    kw = dict(min_iters=10, max_iters=10, matmul_precision=precision)
    k1 = fs.fused_stats.launches
    res = fit_gmm(x, 8, 4, config=GMMConfig(**kw))
    assert res.model.estep_backend == "cuda" and fs.fused_stats.launches > k1
    assert res.ideal_num_clusters == 4 and np.isfinite(res.final_loglik)
    assert np.isfinite(res.means).all()
    if precision == "default":
        return
    ref = fit_gmm(x, 8, 4, config=GMMConfig(estep_backend="torch", **kw))
    assert [m[1] for m in res.merges] == [m[1] for m in ref.merges]
    np.testing.assert_allclose(res.final_loglik, ref.final_loglik, rtol=1e-4)


# K2/K4: the guard cases of the M-step, forced into a state of K clusters.
EMPTY, DEAD, INACTIVE, NON_PD, NAN_M2 = 3, 4, 6, 8, 9


def _mstep_inputs(rng, k, d, diag, dev, n=3000):
    """A state (cluster INACTIVE inactive) and statistics of random events
    under it, with the guard cases forced: an empty cluster, a dead-zone
    one (Nk = 0.7), an M2 whose update has a negative eigenvalue and a NaN
    in M2 below the diagonal."""
    state = state_from_numpy(_state(rng, k, d, diag, inactive=(INACTIVE,)),
                             device=dev)
    chunks, wts = chunk_events(rng.normal(scale=2.0, size=(n, d))
                               .astype(np.float32), 1024)
    st = accumulate_stats(state, torch.as_tensor(chunks, device=dev),
                          torch.as_tensor(wts, device=dev), diag_only=diag)
    nk, m2 = st.Nk.clone(), st.M2.clone()
    nk[EMPTY], nk[DEAD], nk[NON_PD], nk[NAN_M2] = 0.0, 0.7, 50.0, 50.0
    for c in (NON_PD, NAN_M2):
        mu = st.M1[c] / nk[c]
        if diag:
            m2[c] = nk[c] * (mu * mu + 1.0)
        else:
            q, _ = torch.linalg.qr(torch.as_tensor(
                rng.normal(size=(d, d)), dtype=torch.float32, device=dev))
            lam = torch.ones(d, device=dev)
            lam[-1] = -1.0 if c == NON_PD else 1.0
            m2[c] = nk[c] * (torch.outer(mu, mu) + (q * lam) @ q.T)
    if diag:
        m2[NON_PD, 0] -= 2.0 * nk[NON_PD]  # variance ~ -1
        m2[NAN_M2, 1] = float("nan")
    else:
        m2[NAN_M2, 3, 1] = float("nan")
    return state, SuffStats(st.loglik, nk, st.M1, m2)


def _ulps(a, b):
    """|a - b| in units of b's last place."""
    spacing = torch.nextafter(b.abs(), torch.full_like(b, float("inf"))) - b.abs()
    return float(((a - b).abs() / spacing).max())


def _hold_mstep(out, state, stats, diag, label, only=slice(None)):
    """K2's (or one K4 lane's) outputs against the torch-ops M-step: ``ok``
    equal to the torch-ops flag, N, means and R torch.equal where it
    agrees, Rinv and constant (of the clusters ``only``) against a float64
    compute_constants of the same updated R within twice the torch-ops
    error, pi within 4 ulps."""
    from cuda_gmm_mpi_tpu_torch.ops.constants import constants

    n, mean, R, Rinv, constant, pi, ok = out
    N, means, R_upd = mstep_update(state, stats, diag_only=diag)
    ref = apply_mstep(state, stats, diag_only=diag)
    _, _, _, _, ref_ok = constants(N, R_upd, state.active, diag_only=diag)
    assert torch.equal(ok, ref_ok), label
    assert torch.equal(n, ref.N) and torch.equal(mean, ref.means), label
    assert torch.equal(R, ref.R), label
    _, Rinv64, const64, _, ok64 = constants(N.double(), R_upd.double(),
                                            state.active, diag_only=diag)
    assert torch.equal(ok64, ok), label
    _within_twice_plain(Rinv[only], ref.Rinv[only], Rinv64[only],
                        label + " Rinv")
    _within_twice_plain(constant[only], ref.constant[only], const64[only],
                        label + " constant")
    assert _ulps(pi, ref.pi) <= 4.0, (label, _ulps(pi, ref.pi))


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k2_equals_plain_and_mstep_update(dev, diag):
    """K2 at the main path's K = 100, D = 24, with every guard case: the
    torch-ops M-step's ok, N, means and R exactly, Rinv and constant
    within twice its float64 error, pi within 4 ulps; the plain version's
    ok, N, means and R exactly; two launches bit for bit."""
    rng = np.random.default_rng(5)
    k, d = 100, 24
    state, stats = _mstep_inputs(rng, k, d, diag, dev)
    ops = fs._mstep_operands(state, stats, diag)
    before = fs.mstep.launches
    out = fs.mstep(*ops, diag=diag)
    again = fs.mstep(*ops, diag=diag)
    torch.cuda.synchronize()
    assert fs.mstep.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    plain = fs.mstep_plain(*ops, diag=diag)
    for i in (0, 1, 2, 6):  # n, mean, R, ok
        assert torch.equal(out[i], plain[i]), i
    assert not out[6][NON_PD] and not out[6][NAN_M2]
    assert bool(out[6][[EMPTY, DEAD, INACTIVE]].all())
    _hold_mstep(out, state, stats, diag, "K2")


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k2_ill_conditioned_cluster_within_twice_torch_ops(dev, diag):
    """A cluster whose updated R has condition number ~1e6 (Nk = 1, zero
    mean and loading, so R = M2: Q diag(1 .. 1e-6) Q^T, or that diagonal):
    its Rinv and constant against float64 within twice the torch-ops
    path's error."""
    rng = np.random.default_rng(8)
    k, d, c = 100, 24, 10
    state, stats = _mstep_inputs(rng, k, d, diag, dev)
    lam = np.logspace(0.0, -6.0, d)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    m2 = lam if diag else (q * lam) @ q.T
    stats.Nk[c] = 1.0
    stats.M1[c] = 0.0
    stats.M2[c] = torch.as_tensor(m2, dtype=torch.float32, device=dev)
    avgvar = state.avgvar.clone()
    avgvar[c] = 0.0
    state = state.replace(avgvar=avgvar)
    R = mstep_update(state, stats, diag_only=diag)[2][c].double()
    cond = float(torch.linalg.cond(R))
    assert 3e5 < cond < 3e6, cond
    out = fs.mstep(*fs._mstep_operands(state, stats, diag), diag=diag)
    _hold_mstep(out, state, stats, diag, "K2 cond 1e6", only=slice(c, c + 1))


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k4_equals_plain_and_k2_per_lane(dev, diag):
    """K4 on 3 lanes of the guard cases: each lane torch.equal to K2 on
    its operands, and held to the torch-ops M-step as K2 is."""
    rng = np.random.default_rng(6)
    k, d = 40, 24
    cases = [_mstep_inputs(rng, k, d, diag, dev) for _ in range(3)]
    states = stack_states([s for s, _ in cases])
    stats = stack_states([st for _, st in cases])
    ops = fs._mstep_operands(states, stats, diag)
    before = fs.mstep_batched.launches
    out = fs.mstep_batched(*ops, diag=diag)
    assert fs.mstep_batched.launches == before + 1
    plain = fs.mstep_batched_plain(*ops, diag=diag)
    for i in (0, 1, 2, 6):
        assert torch.equal(out[i], plain[i]), i
    for r in range(3):
        for a, b in zip(out, fs.mstep(*(o[r] for o in ops), diag=diag)):
            assert torch.equal(a[r], b)
        _hold_mstep(tuple(o[r] for o in out), lane(states, r),
                    lane(stats, r), diag, f"K4 lane {r}")


@pytest.mark.parametrize("batched", [False, True], ids=["K2", "K4"])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_mstep_hook_is_one_kernel_launch(dev, diag, batched):
    """On the kernel path one M-step is one CUDA kernel: the profiler sees
    exactly one device activity (no copy, no fill) in one hook call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cuda_gmm_mpi_tpu_torch.ops.kernels import make_mstep_fn

    rng = np.random.default_rng(9)
    state, stats = _mstep_inputs(rng, 100, 24, diag, dev)
    if batched:
        state, stats = stack_states([state] * 4), stack_states([stats] * 4)
    hook = make_mstep_fn(GMMConfig(diag_only=diag), batched=batched)
    hook(state, stats)
    torch.cuda.synchronize()
    # The profiler keeps only device activities inside its session's
    # window, on its own clock: a kernel launched microseconds after the
    # session starts can land before the window there and be dropped (the
    # cause of this test's rare empty event list). The host sleeps put the
    # one kernel well inside the window; they add no device activity.
    for _ in range(10):  # ten sessions, each one launch
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            new = hook(state, stats)
            torch.cuda.synchronize()
            time.sleep(0.02)
        device = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        assert len(device) == 1 and "mstep_kernel" in device[0], device
    assert new.Rinv.shape == state.R.shape


def test_k2_refuses_a_d_beyond_its_shared_memory(dev):
    k, d = 2, 170  # two 170 x 170 float buffers exceed the 227 KB of a CTA
    z = lambda *s: torch.zeros(s, device=dev)
    act = torch.ones(k, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="D=170"):
        fs.mstep(z(k), z(k, d), z(k, d * d), z(k), act, diag=False)
    out = fs.mstep(z(k), z(k, d), z(k, d), z(k), act, diag=True)
    assert torch.equal(out[3][0], torch.eye(d, device=dev))  # empty: I


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


@pytest.mark.parametrize("n,d,k", [
    (4099, 6, 70), (20000, 24, 100),
    (3000, 6, 400),  # K_pad = 512: 64-event tiles
])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k3_lanes_equal_k1_and_frozen_lane_is_zero(dev, n, d, k, diag):
    rng = np.random.default_rng(n + k + 1)
    states = [state_from_numpy(_state(rng, k, d, diag, inactive=inact),
                               device=dev) for inact in ((1,), (), (0, 3))]
    x = torch.as_tensor(rng.normal(scale=2.0, size=(n, d)), dtype=torch.float32,
                        device=dev)
    wt = torch.as_tensor(rng.uniform(0.0, 2.0, size=n), dtype=torch.float32,
                         device=dev)
    params = [fs._prep_params(s, d, diag) for s in states]
    A, h, g = (torch.stack(p) for p in zip(*params))
    lanes = torch.tensor([1.0, 0.0, 1.0], device=dev)
    before = fs.fused_stats_batched.launches
    out = fs.fused_stats_batched(x, wt, lanes, A, h, g, diag=diag)
    ref = fs.fused_stats_batched_plain(x, wt, lanes, A, h, g, diag=diag)
    torch.cuda.synchronize()
    assert fs.fused_stats_batched.launches == before + 1
    for r in (0, 2):
        one = fs.fused_stats(x, wt, *params[r], diag=diag)
        for a, b in zip(out, one):
            assert torch.equal(a[r], b)
    for a, c, name in zip(out, ref, TOL):
        assert not a[1].any(), name
        rtol, atol = TOL[name]
        err = float((a - c).abs().max())
        assert err <= atol + rtol * float(c.abs().max()), (name, err)


def test_batched_restarts_through_k3_k4_match_sequential(dev):
    rng = np.random.default_rng(11)
    c = rng.normal(scale=4, size=(4, 5))
    x = np.concatenate([rng.normal(c[i], 1, (500, 5))
                        for i in range(4)]).astype(np.float32)
    kw = dict(min_iters=8, max_iters=8, n_init=3, seed=1)
    counts = (fs.fused_stats_batched.launches, fs.mstep_batched.launches,
              fs.fused_stats.launches)
    bat = fit_gmm(x, 4, 3, config=GMMConfig(restart_batch_size=3, **kw))
    steps = len(bat.sweep_log)
    assert fs.fused_stats_batched.launches - counts[0] == 8 * steps + steps
    assert fs.mstep_batched.launches - counts[1] == 8 * steps
    assert fs.fused_stats.launches == counts[2]
    seq = fit_gmm(x, 4, 3, config=GMMConfig(restart_batch_size=1, **kw))
    assert bat.init_index == seq.init_index
    assert [m[1] for m in bat.merges] == [m[1] for m in seq.merges]
    np.testing.assert_allclose(bat.final_loglik, seq.final_loglik, rtol=1e-5)


def _normwise(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("n,d,k,shards", [
    (4099, 6, 70, 2), (20000, 24, 100, 4),
    # K_s = 1, 50 and 64 (the 64-wide shard kernel), 65 (K1's kernel, one
    # 128-wide tile) and 130 (two tiles); N is never a multiple of B_t
    (1001, 5, 2, 2), (5003, 24, 100, 2), (4097, 10, 128, 2),
    (3001, 6, 130, 2), (2053, 6, 260, 2),
    # more event tiles than twice either grid (K5 396 CTAs, K6 264): every
    # CTA accumulates over several tiles
    (120001, 6, 100, 2)])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k5_k6_match_plain_and_their_shards_match_k1(dev, n, d, k, shards, diag):
    """K5 and K6 per cluster shard (K_s = ceil(k / shards)), the last shard
    with every cluster inactive, combined as fused_stats_cuda_sharded does
    (torch max and sum standing in for the all_reduce calls)."""
    rng = np.random.default_rng(n + k + 2)
    ks = -(-k // shards)
    state = state_from_numpy(_state(rng, k, d, diag,
                                    inactive=range((shards - 1) * ks, k)),
                             device=dev)
    x = torch.as_tensor(rng.normal(scale=2.0, size=(n, d)), dtype=torch.float32,
                        device=dev)
    wt = torch.as_tensor(rng.uniform(0.0, 2.0, size=n), dtype=torch.float32,
                         device=dev)
    A, h, g = fs._prep_params(state, d, diag)
    cols = [slice(i * ks, min(k, (i + 1) * ks)) for i in range(shards)]
    parts = [tuple(t[:, c].contiguous() for t in (A, h, g)) for c in cols]
    before = (fs.local_lse.launches, fs.stats_logz.launches)
    lse = [fs.local_lse(x, *p, diag=diag) for p in parts]
    for p, (m, s) in zip(parts, lse):
        m2, s2 = fs.local_lse(x, *p, diag=diag)
        pm, ps = fs.local_lse_plain(x, *p, diag=diag)
        _, ps64 = fs.local_lse_plain(x.double(), *(t.double() for t in p),
                                     diag=diag)
        assert torch.equal(m, m2) and torch.equal(s, s2)
        assert _normwise(m, pm) <= 1e-6
        assert (_normwise(s.double(), ps64)
                <= 2.0 * max(_normwise(ps.double(), ps64), 2.0 ** -23))
    m_last, s_last = lse[-1]
    assert bool((m_last == fs.NEG_LARGE).all())
    assert bool((s_last == cols[-1].stop - cols[-1].start).all())
    big_m = torch.stack([m for m, _ in lse]).max(dim=0).values
    logz = big_m + torch.log(sum(torch.exp(m - big_m) * s for m, s in lse))
    outs = []
    for p in parts:
        out = fs.stats_logz(x, wt, logz, *p, diag=diag)
        again = fs.stats_logz(x, wt, logz, *p, diag=diag)
        ref = fs.stats_logz_plain(x, wt, logz, *p, diag=diag)
        for a, b, c, name in zip(out, again, ref, TOL):
            assert torch.equal(a, b), name
            rtol, atol = TOL[name]
            assert float((a - c).abs().max()) <= atol + rtol * float(c.abs().max()), name
        outs.append(out)
    torch.cuda.synchronize()
    assert fs.local_lse.launches - before[0] == 2 * shards
    assert fs.stats_logz.launches - before[1] == 2 * shards
    k1 = fs.fused_stats(x, wt, A, h, g, diag=diag)
    side = (outs[0][0], torch.cat([o[1] for o in outs], dim=1),
            torch.cat([o[2] for o in outs]), torch.cat([o[3] for o in outs]))
    for a, c, name in zip(side, k1, TOL):
        rtol, atol = TOL[name]
        assert float((a - c).abs().max()) <= atol + rtol * float(c.abs().max()), name
    assert not outs[-1][1].any()


@pytest.mark.parametrize("d", [6, 24, 32])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_shard_kernels_fit_the_ctas_per_sm_of_their_tile(dev, d, diag):
    """The card's occupancy calculator, from the shard kernels' registers
    and shared memory, fits at least the CTAs per SM that shard_tile
    reports (its persistent grid is 132 x that), and more than one."""
    import ctypes

    from cuda_gmm_mpi_tpu_torch.ops.kernels._build import library

    lib = library("fused_stats.cu")
    for mode, stats in ((1, False), (2, True)):
        tile = fs.shard_tile(50, d, diag, stats=stats)
        ctas = ctypes.c_int(0)
        assert lib.gmm_shard_occupancy(mode, d, int(diag),
                                       ctypes.addressof(ctas)) == 0
        assert ctas.value >= tile.ctas_per_sm > 1, (mode, ctas.value, tile)


def test_two_rank_mesh_em_through_k5_k6_matches_single_device(dev, tmp_path):
    """A (1, 2) mesh (clusters sharded over two ranks of a gloo world on the
    one GPU) runs ShardedGMMModel.run_em through K5 + K6, one launch of each
    per E-step, and matches GMMModel.run_em through K1 + K2."""
    from cuda_gmm_mpi_tpu_torch.ops.seeding import seed_clusters
    from cuda_gmm_mpi_tpu_torch.interop import state_to_numpy
    from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon

    from .torch_mesh_worker import run_em_case, spawn_world

    rng = np.random.default_rng(3)
    c = rng.normal(scale=6, size=(6, 5))
    data = np.concatenate([rng.normal(c[i], 1, (700, 5))
                           for i in range(6)]).astype(np.float32)
    state_np = state_to_numpy(seed_clusters(torch.as_tensor(data), 6))
    iters, chunk = 8, 1024
    ranks = spawn_world(run_em_case, 2, tmp_path, data, state_np, iters,
                        (1, 2), chunk, "float32", True, "auto", "cuda",
                        device="cuda")  # run_em_case(..., stats, device)
    model = GMMModel(GMMConfig(min_iters=iters, max_iters=iters,
                               chunk_size=chunk, diag_only=True))
    chunks, wts = chunk_events(data, chunk)
    s, ll, it = model.run_em(state_from_numpy(state_np, device=dev),
                             torch.as_tensor(chunks, device=dev),
                             torch.as_tensor(wts, device=dev),
                             convergence_epsilon(*data.shape),
                             n_events=data.shape[0])
    for r in ranks:
        assert r["backend"] == "cuda" and r["iters"] == it
        assert r["launches"] == [iters + 1, iters + 1, 0, 0]  # K5, K6, K1, K2
        np.testing.assert_allclose(r["loglik"], ll, rtol=1e-5)
    means = np.concatenate([r["state"]["means"] for r in ranks])
    scale = float(np.abs(s.means.cpu().numpy()).max())
    np.testing.assert_allclose(means, s.means.cpu().numpy(), rtol=1e-5,
                               atol=1e-5 * scale)


def test_data_only_mesh_em_through_k1_k2_matches_single_device(dev, tmp_path):
    """A (2, 1) mesh (events split over two ranks of a gloo world on the
    one GPU, clusters whole) runs ShardedGMMModel.run_em through K1 and the
    one-launch M-step K2 on every rank, and matches GMMModel.run_em."""
    from cuda_gmm_mpi_tpu_torch.interop import state_to_numpy
    from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon
    from cuda_gmm_mpi_tpu_torch.ops.seeding import seed_clusters

    from .torch_mesh_worker import run_em_case, spawn_world

    rng = np.random.default_rng(4)
    c = rng.normal(scale=6, size=(6, 5))
    data = np.concatenate([rng.normal(c[i], 1, (700, 5))
                           for i in range(6)]).astype(np.float32)
    state_np = state_to_numpy(seed_clusters(torch.as_tensor(data), 6))
    iters, chunk = 8, 1024
    ranks = spawn_world(run_em_case, 2, tmp_path, data, state_np, iters,
                        (2, 1), chunk, "float32", False, "auto", "cuda",
                        device="cuda")
    model = GMMModel(GMMConfig(min_iters=iters, max_iters=iters,
                               chunk_size=chunk))
    chunks, wts = chunk_events(data, chunk)
    s, ll, it = model.run_em(state_from_numpy(state_np, device=dev),
                             torch.as_tensor(chunks, device=dev),
                             torch.as_tensor(wts, device=dev),
                             convergence_epsilon(*data.shape),
                             n_events=data.shape[0])
    for r in ranks:
        assert r["backend"] == "cuda" and r["iters"] == it
        assert r["launches"] == [0, 0, iters + 1, iters]  # K5, K6, K1, K2
        np.testing.assert_allclose(r["loglik"], ll, rtol=1e-5)
        scale = float(np.abs(s.means.cpu().numpy()).max())
        np.testing.assert_allclose(r["state"]["means"], s.means.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k3_k4_on_a_rank_shard_equal_the_launch_outside_the_world(
        dev, tmp_path, diag):
    """The mesh restart loop's kernels inside a 2-rank (2, 1) world on the
    one GPU: K3 on each rank's block of the events, then K4 on the
    all_reduced statistics, are torch.equal to the same launches outside
    the world (the reduction of two ranks is one addition, the same in
    either order), and are held to their plain versions as today: K3 in
    the K1 class over the live lanes, its frozen lane zero; K4's ok, N,
    means and R equal to the plain version."""
    from cuda_gmm_mpi_tpu_torch.parallel import distributed

    from .torch_mesh_worker import k3_k4_shard_case, spawn_world

    rng = np.random.default_rng(31 + diag)
    k, d, chunk = 40, 8, 1024
    data = rng.normal(scale=3.0, size=(5000, d)).astype(np.float32)
    states_np = [_state(rng, k, d, diag, inactive=inact)
                 for inact in ((1,), (), (0, 3))]
    mask = [True, False, True]
    ranks = spawn_world(k3_k4_shard_case, 2, tmp_path, data, states_np,
                        chunk, diag, mask, device="cuda")
    states = stack_states([state_from_numpy(st, device=dev)
                           for st in states_np])
    chunks, wts = chunk_events(data, chunk, num_shards=2)
    block = chunks.shape[0] // 2
    lanes = torch.tensor(mask, device=dev)
    locals_ = []
    for r in ranks:
        assert r["launches"] == (1, 1)
        lo, hi = r["rank"] * block, (r["rank"] + 1) * block
        assert r["n"] == min(max(data.shape[0] - lo * chunk, 1),
                             block * chunk)
        c = torch.as_tensor(chunks[lo:hi], device=dev)
        w = torch.as_tensor(wts[lo:hi], device=dev)
        out = fs.fused_stats_cuda_batched(states, c, w, lanes,
                                          diag_only=diag, n_events=r["n"])
        for f in dataclasses.fields(out):
            assert torch.equal(getattr(out, f.name).cpu(),
                               torch.as_tensor(r["local"][f.name])), f.name
        x, wt = fs._prep_events(c, w)
        params = [fs._prep_params(lane(states, i), d, diag) for i in range(3)]
        A, h, g = (torch.stack(p) for p in zip(*params))
        got = fs.fused_stats_batched(x[:r["n"]], wt[:r["n"]],
                                     lanes.float(), A, h, g, diag=diag)
        ref = fs.fused_stats_batched_plain(x[:r["n"]], wt[:r["n"]],
                                           lanes.float(), A, h, g, diag=diag)
        for a, b, name in zip(got, ref, TOL):
            assert not a[1].any(), name
            rtol, atol = TOL[name]
            err = float((a - b).abs().max())
            assert err <= atol + rtol * float(b.abs().max()), (name, err)
        locals_.append(out)
    reduced = SuffStats(*(getattr(locals_[0], f.name)
                          + getattr(locals_[1], f.name)
                          for f in dataclasses.fields(SuffStats)))
    ops = fs._mstep_operands(states, reduced, diag)
    out = fs.mstep_batched(*ops, diag=diag)
    plain = fs.mstep_batched_plain(*ops, diag=diag)
    for i in (0, 1, 2, 6):
        assert torch.equal(out[i], plain[i]), i
    mine = fs.fused_mstep_cuda_batched(states, reduced, diag_only=diag)
    for r in ranks:
        for f in dataclasses.fields(reduced):
            assert torch.equal(getattr(reduced, f.name).cpu(),
                               torch.as_tensor(r["reduced"][f.name])), f.name
        for f in dataclasses.fields(mine):
            assert torch.equal(getattr(mine, f.name).cpu(),
                               torch.as_tensor(r["mstep"][f.name])), f.name
    assert distributed.world_size() == 1


def test_mesh_restarts_through_k3_k4_match_one_card(dev, tmp_path):
    """n_init = 3 on a (2, 1) mesh of two ranks on the one GPU runs K3 and
    K4 on every rank (K3 once per batched iteration and sweep step, K4 once
    per iteration; K1, K2, K5, K6 never) and picks the one-card batched
    fit's init, K and merge pairs, loglik within rtol 1e-5."""
    from .torch_mesh_worker import run_cases, spawn_world

    rng = np.random.default_rng(12)
    c = rng.normal(scale=4, size=(4, 5))
    x = np.concatenate([rng.normal(c[i], 1, (600, 5))
                        for i in range(4)]).astype(np.float32)
    kw = dict(min_iters=8, max_iters=8, n_init=3, seed=1,
              restart_batch_size=3, chunk_size=512)
    ranks = [r[0] for r in spawn_world(
        run_cases, 2, tmp_path, [("counted_fit_case", dict(
            data=x, k0=4, target=3, mesh_shape=(2, 1), **kw))],
        device="cuda")]
    ref = fit_gmm(x, 4, 3, config=GMMConfig(**kw))
    steps = len(ref.sweep_log)
    for r in ranks:
        lc = r["launches"]
        assert lc["K3"] == 8 * steps + steps and lc["K4"] == 8 * steps, lc
        assert lc["K1"] == lc["K2"] == lc["K5"] == lc["K6"] == 0, lc
        assert r["init_index"] == ref.init_index
        assert r["k"] == ref.ideal_num_clusters
        assert r["merges"] == [m[1] for m in ref.merges]
        np.testing.assert_allclose(r["final_loglik"], ref.final_loglik,
                                   rtol=1e-5)


def test_cluster_sharded_mesh_restarts_through_k5_k6_match_one_card(
        dev, tmp_path):
    """Diag restarts (n_init = 3) on a (1, 2) mesh: each lane runs the
    mesh's own statistics, K5 + K6 once per lane and E-step (K1-K4 never),
    and the fit picks the one-card batched fit's init, K and merge pairs,
    loglik within rtol 1e-5."""
    from .torch_mesh_worker import run_cases, spawn_world

    rng = np.random.default_rng(13)
    c = rng.normal(scale=4, size=(4, 5))
    x = np.concatenate([rng.normal(c[i], 1, (600, 5))
                        for i in range(4)]).astype(np.float32)
    kw = dict(min_iters=8, max_iters=8, n_init=3, seed=1, diag_only=True,
              restart_batch_size=3, chunk_size=512)
    ranks = [r[0] for r in spawn_world(
        run_cases, 2, tmp_path, [("counted_fit_case", dict(
            data=x, k0=4, target=3, mesh_shape=(1, 2), **kw))],
        device="cuda")]
    ref = fit_gmm(x, 4, 3, config=GMMConfig(**kw))
    steps = len(ref.sweep_log)
    for r in ranks:
        lc = r["launches"]
        # 9 E-steps (8 iterations and the initial one) per lane and step,
        # for every lane whose sweep has not ended.
        assert lc["K5"] == lc["K6"] and 0 < lc["K5"] <= 3 * 9 * steps, lc
        assert lc["K5"] % 9 == 0, lc
        assert lc["K1"] == lc["K2"] == lc["K3"] == lc["K4"] == 0, lc
        assert r["init_index"] == ref.init_index
        assert r["k"] == ref.ideal_num_clusters
        assert r["merges"] == [m[1] for m in ref.merges]
        np.testing.assert_allclose(r["final_loglik"], ref.final_loglik,
                                   rtol=1e-5)


_MMA_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// d = a [16, 8] @ b [8, 8] + c [16, 8] by one mma.sync.m16n8k8 tf32 step.
__global__ void probe(const float* a, const float* b, const float* c, float* d) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  uint32_t af[4] = {__float_as_uint(a[g * 8 + t]), __float_as_uint(a[(g + 8) * 8 + t]),
                    __float_as_uint(a[g * 8 + t + 4]), __float_as_uint(a[(g + 8) * 8 + t + 4])};
  uint32_t bf[2] = {__float_as_uint(b[t * 8 + g]), __float_as_uint(b[(t + 4) * 8 + g])};
  float cf[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1], c[(g + 8) * 8 + 2 * t],
                 c[(g + 8) * 8 + 2 * t + 1]};
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(cf[0]), "+f"(cf[1]), "+f"(cf[2]), "+f"(cf[3])
      : "r"(af[0]), "r"(af[1]), "r"(af[2]), "r"(af[3]), "r"(bf[0]), "r"(bf[1]));
  d[g * 8 + 2 * t] = cf[0];
  d[g * 8 + 2 * t + 1] = cf[1];
  d[(g + 8) * 8 + 2 * t] = cf[2];
  d[(g + 8) * 8 + 2 * t + 1] = cf[3];
}
extern "C" int mma_probe(const float* a, const float* b, const float* c, float* d,
                         void* stream) {
  probe<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(a, b, c, d);
  return (int)cudaGetLastError();
}
"""


def test_tensor_core_fp32_sum_rounding(dev, tmp_path):
    """The rounding of mma.sync tf32 that K1's phase 3 is designed around
    (and tests/test_torch_tf32_split.py emulates): exact products, terms
    truncated toward zero 2 bits below the largest term's last bit, the
    sum truncated toward zero. Each case is one row of A against a column
    of ones."""
    import ctypes
    import subprocess

    from cuda_gmm_mpi_tpu_torch.ops.kernels._build import ARCH, nvcc

    from .test_torch_tf32_split import PROBED

    src, lib = tmp_path / "probe.cu", tmp_path / "probe.so"
    src.write_text(_MMA_PROBE)
    subprocess.run([nvcc()] + ARCH + ["-O3", "-shared", "-Xcompiler", "-fPIC",
                                      "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).mma_probe
    fn.argtypes = [ctypes.c_void_p] * 5
    a = torch.zeros((16, 8), dtype=torch.float64)
    c = torch.zeros((16, 8), dtype=torch.float64)
    for r, (row, c0, _) in enumerate(PROBED):
        a[r, :len(row)] = torch.tensor(row, dtype=torch.float64)
        c[r, 0] = c0
    a, c = (t.to(torch.float32).to(dev) for t in (a, c))
    b = torch.zeros((8, 8), dtype=torch.float32, device=dev)
    b[:, 0] = 1.0
    d = torch.empty((16, 8), dtype=torch.float32, device=dev)
    assert fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
              torch.cuda.current_stream(dev).cuda_stream) == 0
    got = d[:len(PROBED), 0].double().cpu().tolist()
    assert got == [expected for _, _, expected in PROBED]


# ------------------------------------------------- containment and resume

def _blobs_f32(seed=11):
    rng = np.random.default_rng(seed)
    c = rng.normal(scale=10, size=(4, 5))
    return np.concatenate([rng.normal(c[i], 1, (500, 5))
                           for i in range(4)]).astype(np.float32)


@pytest.mark.parametrize("times", [1, 2], ids=["regularize", "centered"])
def test_nan_loglik_recovery_on_the_kernel_path(dev, times):
    """An injected NaN loglik at iteration 3 of the first K: the kernel
    path recovers as the torch-ops path does (the same rungs, K and merge
    pairs); with times=2 the fit escalates to 'centered', which leaves K1
    for torch ops and says why."""
    from cuda_gmm_mpi_tpu_torch.testing import faults

    kw = dict(min_iters=10, max_iters=10)
    spec = {"nan_loglik": {"iter": 3, "times": times}}
    out = {}
    for backend in ("auto", "torch"):
        with faults.use(spec):
            out[backend] = fit_gmm(_blobs_f32(), 8, 4, config=GMMConfig(
                estep_backend=backend, **kw))
    res, ref = out["auto"], out["torch"]
    assert res.health["recoveries"] == ref.health["recoveries"] >= 1
    assert res.health["flags"] == ref.health["flags"]
    assert res.ideal_num_clusters == ref.ideal_num_clusters
    assert [m[1] for m in res.merges] == [m[1] for m in ref.merges]
    np.testing.assert_allclose(res.final_loglik, ref.final_loglik, rtol=1e-4)
    if times == 1:
        assert res.model.estep_backend == "cuda"
    else:
        assert res.model.config.quad_mode == "centered"
        assert res.model.estep_backend == "torch"
        assert "centered" in res.model.estep_backend_reason


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_nan_mean_makes_k1_and_k3_loglik_nonfinite(dev, diag):
    """K1/K3 take row maxima with fmaxf, which drops a NaN: the NaN must
    still reach the loglik through the shifted sum, so that
    nonfinite_loglik trips as on the plain version."""
    from cuda_gmm_mpi_tpu_torch import health

    rng = np.random.default_rng(5)
    n, d, k = 4099, 6, 70
    x = torch.as_tensor(rng.normal(scale=2.0, size=(2, n, d)),
                        dtype=torch.float32, device=dev)
    wt = torch.ones((2, n), dtype=torch.float32, device=dev)
    clean = _state(rng, k, d, diag)
    bad = {f: v.copy() for f, v in clean.items()}
    bad["means"][9] = np.nan
    state = state_from_numpy(bad, device=dev)
    k1 = fs.fused_stats_cuda(state, x, wt, diag_only=diag)
    plain = accumulate_stats(state, x, wt, diag_only=diag)
    for stats in (k1, plain):
        assert not torch.isfinite(stats.loglik)
        counts = health.iteration_counts(state, stats, stats.loglik)
        assert counts[health.NONFINITE_LOGLIK] == 1
    states = stack_states([state_from_numpy(s, device=dev)
                           for s in (clean, bad, clean)])
    k3 = fs.fused_stats_cuda_batched(states, x, wt, diag_only=diag)
    assert torch.isfinite(k3.loglik[[0, 2]]).all()
    assert not torch.isfinite(k3.loglik[1])


def test_preempt_in_the_second_k_resumes_exactly(dev, tmp_path):
    """A preempt that lands in the sweep's second K, then resume: the same
    final loglik, K and merge pairs as the uninterrupted fit (K1 repeats
    bit for bit, so resume is exact)."""
    from cuda_gmm_mpi_tpu_torch import supervisor
    from cuda_gmm_mpi_tpu_torch.testing import faults

    x = _blobs_f32()
    kw = dict(min_iters=10, max_iters=10, checkpoint_dir=str(tmp_path / "ck"),
              preempt_poll_iters=2)
    whole = fit_gmm(x, 8, 4, config=GMMConfig(min_iters=10, max_iters=10))
    for _ in range(2):  # K = 8 at iteration 4, then K = 7 at iteration 4
        with faults.use({"preempt": {"iter": 4}}), supervisor.use(
                supervisor.RunSupervisor(install_signals=False)):
            with pytest.raises(supervisor.PreemptedError):
                fit_gmm(x, 8, 4, config=GMMConfig(**kw))
    assert (tmp_path / "ck" / "sweep" / "1.iter4.npz").exists()
    with supervisor.use(supervisor.RunSupervisor(install_signals=False)):
        res = fit_gmm(x, 8, 4, config=GMMConfig(**kw))
    assert res.final_loglik == whole.final_loglik
    assert res.ideal_num_clusters == whole.ideal_num_clusters
    assert [m[1] for m in res.merges] == [m[1] for m in whole.merges[1:]]


# ------------------------------------------------ the captured EM program

def _em_case(dev, diag, backend, seed=21):
    data = _blobs_f32(seed)
    chunks, wts = chunk_events(data, 1024)
    return (data, torch.as_tensor(chunks, device=dev),
            torch.as_tensor(wts, device=dev),
            GMMConfig(diag_only=diag, estep_backend=backend, min_iters=3,
                      max_iters=30))


@pytest.mark.parametrize("backend", ["cuda", "torch"], ids=["K1K2", "torch"])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_captured_em_equals_eager_em(dev, diag, backend):
    """The EM loop captured as CUDA graphs runs what the eager host loop
    runs: state, trajectory, iterations and counters equal (bit for bit),
    on the kernel route and on torch ops."""
    from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon

    data, chunks, wts, cfg = _em_case(dev, diag, backend)
    state = state_from_numpy(_state(np.random.default_rng(3), 8,
                                    data.shape[1], diag, inactive=(5,)),
                             device=dev)
    eps = convergence_epsilon(*data.shape)
    out = {}
    for eager in (True, False):
        model = GMMModel(cfg, _eager_em=eager)
        assert model.estep_backend == backend
        out[eager] = model.run_em_resumable(state, chunks, wts, eps,
                                            n_events=len(data))
        out[eager] += (model.last_health,)
        assert model.captures is not eager
    (s0, ll0, it0, lls0, _, _, h0), (s1, ll1, it1, lls1, _, _, h1) = (
        out[True], out[False])
    for f in ("N", "pi", "constant", "means", "R", "Rinv", "active"):
        assert torch.equal(getattr(s0, f), getattr(s1, f)), f
    assert (ll0, it0, lls0) == (ll1, it1, lls1)
    assert it1 >= 3
    np.testing.assert_array_equal(h0, h1)


def test_captured_em_counts_replays_and_captures_once_per_width(dev):
    """K1/K2's counters advance by the launches each replay holds (the
    warm-up and the capture itself count nothing); a width is captured
    once and reused by every K at that width."""
    from cuda_gmm_mpi_tpu_torch.models.em_program import pool_bytes

    data, chunks, wts, cfg = _em_case(dev, False, "cuda")
    model = GMMModel(cfg)
    # The pool the fit's graphs share, and its size when the fit lets go.
    pools, held = [], []
    new_pool, release = model.graph_pool, model.release_programs
    model.graph_pool = lambda: pools.append(new_pool()) or pools[-1]
    model.release_programs = lambda: held.append(
        model.graph_pool_bytes()) or release()
    k1, k2 = fs.fused_stats.launches, fs.mstep.launches
    res = fit_gmm(data, 8, 3, config=dataclasses.replace(cfg, min_iters=5,
                                                         max_iters=5),
                  model=model)
    iters = sum(r[3] for r in res.sweep_log)
    assert fs.mstep.launches - k2 == iters
    assert fs.fused_stats.launches - k1 == iters + len(res.sweep_log)
    widths = [w for w, _ in model.capture_log]
    assert widths[0] == 8 and set(widths) <= {8, 4}  # pow2: 8 for K 8..5
    assert len(widths) == len(set(widths))
    # Freed with the fit: once the allocator returns its cached blocks, no
    # segment of the graphs' pool is left.
    (pool,) = set(pools)
    gc.collect()
    torch.cuda.empty_cache()
    assert pool_bytes(pool) == 0
    assert held and held[-1] > 0


def test_em_while_loop_is_captured_on_the_card(dev, monkeypatch):
    """The public ``em_while_loop`` runs the captured EM program on a CUDA
    device, and fits what the eager host loop fits, bit for bit."""
    from cuda_gmm_mpi_tpu_torch.models.em_program import EMProgram
    from cuda_gmm_mpi_tpu_torch.models.gmm import em_while_loop
    from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon

    data, chunks, wts, _ = _em_case(dev, False, "torch")
    state = state_from_numpy(_state(np.random.default_rng(3), 8,
                                    data.shape[1], False), device=dev)
    eps = convergence_epsilon(*data.shape)
    programs = []
    init = EMProgram.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        programs.append(self)

    monkeypatch.setattr(EMProgram, "__init__", spy)
    s1, ll1, it1 = em_while_loop(state, chunks, wts, eps, 3, 30)
    monkeypatch.undo()
    s0, ll0, it0 = em_while_loop(state, chunks, wts, eps, 3, 30,
                                 _eager_em=True)
    assert [p.captured for p in programs] == [True]
    for f in ("N", "pi", "constant", "means", "R", "Rinv", "active"):
        assert torch.equal(getattr(s0, f), getattr(s1, f)), f
    assert (ll0, it0) == (ll1, it1) and it1 >= 3


def test_fused_sweep_equals_host_sweep_off_on_the_card(dev):
    """The fused sweep's two graphs (EM, then the per-K step with the order
    reduction on the device) fit what the host-driven sweep at
    ``sweep_k_buckets='off'`` fits, bit for bit."""
    data, _, _, cfg = _em_case(dev, False, "cuda")
    host = fit_gmm(data, 8, 3, config=dataclasses.replace(
        cfg, sweep_k_buckets="off"))
    fused = fit_gmm(data, 8, 3, config=dataclasses.replace(
        cfg, fused_sweep=True))
    assert [r[:4] for r in fused.sweep_log] == [r[:4] for r in host.sweep_log]
    assert fused.final_loglik == host.final_loglik
    for f in ("N", "pi", "constant", "means", "R", "Rinv", "active"):
        assert torch.equal(getattr(fused.state, f), getattr(host.state, f)), f


def test_observed_fit_on_the_card(dev, tmp_path, monkeypatch):
    """A fit under the recorder and the live plane on the card: while each
    width's graphs are being captured, another thread samples the device's
    memory (the resource sampler) and scrapes /metrics, and the capture
    holds; the result == the bare fit's; one ``em_program`` compile event
    per captured width, as many as the model's own captures; the ``em_k``
    and ``sweep`` watermarks are not null and stay below the card's
    memory."""
    import json
    import threading
    import urllib.request

    from cuda_gmm_mpi_tpu_torch.models import em_program
    from cuda_gmm_mpi_tpu_torch.telemetry import exporter

    data, _, _, cfg = _em_case(dev, False, "cuda")
    bare = fit_gmm(data, 8, 3, config=cfg)
    during = []
    init = em_program.Captured.__init__

    def capture_with_observers(self, fn, pool):
        def observed():
            fn()

            def other():
                sample = exporter.ResourceSampler(device=dev).sample_once()
                port = exporter.current_exporter().port
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
                    during.append((sample, r.status, r.read().decode()))

            t = threading.Thread(target=other)
            t.start()
            t.join()
        init(self, observed, pool)

    monkeypatch.setattr(em_program.Captured, "__init__",
                        capture_with_observers)
    path = tmp_path / "s.jsonl"
    model = GMMModel(cfg)
    res = fit_gmm(data, 8, 3, config=dataclasses.replace(
        cfg, metrics_file=str(path), metrics_port=0), model=model)
    monkeypatch.undo()
    assert [r[:4] for r in res.sweep_log] == [r[:4] for r in bare.sweep_log]
    assert res.final_loglik == bare.final_loglik
    for f in ("N", "pi", "constant", "means", "R", "Rinv", "active"):
        assert torch.equal(getattr(res.state, f), getattr(bare.state, f)), f
    assert len(during) == 2 * len(model.capture_log)  # init + step graphs
    for sample, status, body in during:
        assert sample["memory_stats"]["bytes_in_use"] > 0
        assert status == 200 and body.endswith("# EOF\n")
    records = [json.loads(line) for line in open(path)]
    compiles = [r for r in records if r["event"] == "compile"
                and r["site"] == "em_program"]
    assert [c["width"] for c in compiles] == [w for w, _ in model.capture_log]
    assert all(c["graph_pool_bytes"] > 0 for c in compiles)
    prof = [r for r in records if r["event"] == "run_summary"][-1]["profile"]
    total = torch.cuda.get_device_properties(dev).total_memory
    for name in ("em_k", "sweep"):
        w = prof["watermarks"][name]
        assert 0 < w["peak_bytes"] < total, name
    assert 0 < prof["hbm_peak_bytes"] < total
    assert res.envelope["num_events"] == data.shape[0]


# ------------------------------------------------------------- streaming

def _stream_case(dev, diag, n=20000, d=24, k=100, chunk=4096, seed=31):
    """A state at the main path's width and a host chunk grid of ``n``
    events in ``chunk``-event blocks (the last one ragged)."""
    from cuda_gmm_mpi_tpu_torch.models.streaming import StreamingGMMModel

    rng = np.random.default_rng(seed)
    state = state_from_numpy(_state(rng, k, d, diag, inactive=(1,)),
                             device=dev)
    x = rng.normal(scale=2.0, size=(n, d)).astype(np.float32)
    chunks, wts = chunk_events(x, chunk)
    cfg = GMMConfig(chunk_size=chunk, diag_only=diag, stream_events=True,
                    min_iters=3, max_iters=3)
    return StreamingGMMModel(cfg), state, chunks, wts, x


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_streamed_pass_matches_k1_on_the_whole_grid(dev, diag):
    """One streamed pass (a K1 launch per block, the blocks added on the
    device) against one K1 launch on the whole grid: the tests/test_pallas.py
    class; the pass is one K1 launch per block."""
    model, state, chunks, wts, x = _stream_case(dev, diag)
    assert model.estep_backend == "cuda"
    model._set_local_rows(chunks, x.shape[0])
    before = fs.fused_stats.launches
    got = model._estep_all(state, chunks, wts)
    torch.cuda.synchronize()
    assert fs.fused_stats.launches - before == chunks.shape[0]
    ref = fs.fused_stats_cuda(state, torch.as_tensor(chunks, device=dev),
                              torch.as_tensor(wts, device=dev), diag_only=diag,
                              n_events=x.shape[0])
    for name in TOL:
        a, c = getattr(got, name), getattr(ref, name)
        assert _within(a, c, TOL[name]), (name, _normwise(a, c))


def test_double_buffered_copy_equals_synchronous_copy(dev):
    """The pinned double buffer on its side stream gives the same fit, bit
    for bit, as a plain synchronous copy per block; resident and
    pipelined; K1 once per block per pass and K2 once per M-step."""
    import dataclasses as dc

    from cuda_gmm_mpi_tpu_torch.io import FileSource, write_bin
    from cuda_gmm_mpi_tpu_torch.models.streaming import StreamingGMMModel

    rng = np.random.default_rng(12)
    c = rng.normal(scale=8, size=(6, 8))
    x = (c[rng.integers(0, 6, 50000)]
         + rng.normal(size=(50000, 8))).astype(np.float32)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ev.bin"
        write_bin(path, x)
        cfg = GMMConfig(chunk_size=8192, stream_events=True, min_iters=6,
                        max_iters=6)
        fits = {}
        for ingest in ("resident", "pipelined"):
            for sync in (True, False):
                k1, k2 = fs.fused_stats.launches, fs.mstep.launches
                c2 = dc.replace(cfg, ingest=ingest)
                model = StreamingGMMModel(c2, _sync_copy=sync)
                r = fit_gmm(FileSource(path), 8, 6, config=c2, model=model)
                iters = sum(row[3] for row in r.sweep_log)
                passes = iters + len(r.sweep_log)
                assert fs.fused_stats.launches - k1 == 7 * passes
                assert fs.mstep.launches - k2 == iters
                fits[ingest, sync] = r
    ref = fits["resident", True]
    for key, r in fits.items():
        assert r.final_loglik == ref.final_loglik, key
        assert [row[:4] for row in r.sweep_log] == [
            row[:4] for row in ref.sweep_log], key
        for f in ("N", "pi", "means", "R", "Rinv"):
            assert torch.equal(getattr(r.state, f), getattr(ref.state, f)), (
                key, f)
