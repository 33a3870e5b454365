"""K5/K6 at the matmul precisions 'high' and 'default', on the CPU.

- 'high' (bf16_3x): ``local_lse_plain`` and ``stats_logz_plain`` against
  the JAX package's ``_local_lse_call`` / ``_stats_logz_call`` in
  interpret mode at ``precision='high'``, per cluster shard (full and
  diagonal covariance, an inactive cluster, an all-masked shard), in the
  float32 reassociation class of tests/test_pallas.py.
- 'default' (one bf16 pass): XLA:CPU ignores Precision.DEFAULT, so it is
  held two ways, as tests/test_torch_precision.py holds K1: against a numpy
  float64 evaluation with each product's operands rounded to bf16 where
  the TPU kernel rounds them (the reassociation class), and against JAX's
  'highest' in the bf16 class.
- The route: at 'high' and 'default' every shard width runs K1's kernel in
  the K5/K6 mode (K_pad a multiple of 128, K1's tile), a shard of at most
  64 clusters included; the wrappers no longer refuse these precisions.
- A (1, 2) gloo world through ``fused_stats_cuda_sharded`` at 'high'
  (diag), against the single-process EM on K1's plain version at 'high'.

The CUDA kernels run only on the card (tests/test_torch_cuda.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu.ops.pallas.fused_stats import (
    _local_lse_call, _stats_logz_call,
)
from cuda_gmm_mpi_tpu_torch import GMMConfig, GMMModel
from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy
from cuda_gmm_mpi_tpu_torch.models.gmm import chunk_events
from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon
from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

from .conftest import make_blobs
from .test_torch_ops import F32_TOL, make_state_np
from .test_torch_precision import BF16_NORM, F32_NORM, _bf, normwise
from .test_torch_sharded_kernels import BLOCK, LSE_TOL, _events, _shards
from .torch_mesh_worker import run_cases, spawn_world

STATS = ("loglik", "Nk", "M1", "M2")


def _combine(lse):
    big_m = torch.stack([m for m, _ in lse]).max(dim=0).values
    return big_m + torch.log(sum(torch.exp(m - big_m) * s for m, s in lse))


@pytest.mark.parametrize("k,shards,inactive", [
    (5, 2, (1,)),   # inactive cluster; K=5 padded to 6
    (3, 4, ()),     # K=3 padded to 4: shard 3 is all-masked
], ids=["inactive", "all-masked-shard"])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k5_k6_plain_high_match_pallas_per_shard(rng, k, shards, inactive,
                                                 diag):
    d, n = 3, 2 * BLOCK
    state = state_from_numpy(make_state_np(rng, k, d, np.float32,
                                           inactive=inactive, diag=diag))
    x_np, wt_np = _events(rng, n, d)
    x, wt = torch.as_tensor(x_np), torch.as_tensor(wt_np)
    kw = dict(block_b=BLOCK, diag=diag, interpret=True, precision="high")
    lse, params = [], []
    for part in _shards(state, shards):
        p = fs._prep_params(part, d, diag)
        m, s = fs.local_lse(x, *p, diag=diag, precision="high")
        jm, js = _local_lse_call(jnp.asarray(x_np),
                                 *(jnp.asarray(t.numpy()) for t in p), **kw)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=LSE_TOL[0])
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=LSE_TOL[0])
        if not bool(part.active.any()):  # the all-masked shard
            assert bool((m == fs.NEG_LARGE).all())
            assert bool((s == part.num_clusters_padded).all())
        lse.append((m, s))
        params.append(p)
    logz = _combine(lse)
    for p in params:
        ours = fs.stats_logz(x, wt, logz, *p, diag=diag, precision="high")
        theirs = _stats_logz_call(
            jnp.asarray(x_np), jnp.asarray(wt_np[:, None]),
            jnp.asarray(logz.numpy()), *(jnp.asarray(t.numpy()) for t in p),
            **kw)
        for name, a, b in zip(F32_TOL, ours, theirs):
            rtol, atol = F32_TOL[name]
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                       atol=atol, err_msg=name)
    # 'high' is not 'highest': the bf16 split shows in the last bits.
    p = params[0]
    assert not torch.equal(fs.local_lse_plain(x, *p, diag=diag)[0],
                           fs.local_lse_plain(x, *p, diag=diag,
                                              precision="high")[0])


def _default_reference(x, wt, logz, A, h, g, diag):
    """K5's (m, s) and K6's statistics in numpy float64 with each product's
    operands rounded to bf16 where the TPU kernels round them at 'default'
    (x, the x2 features formed in float32, A, h and w)."""
    x = np.asarray(x, np.float32)
    x2 = x * x if diag else (x[:, :, None] * x[:, None, :]).reshape(len(x), -1)
    logp = -0.5 * (_bf(x2) @ _bf(A) - 2.0 * (_bf(x) @ _bf(h))) + g
    m = logp.max(axis=1, keepdims=True)
    s = np.exp(logp - m).sum(axis=1, keepdims=True)
    w8 = np.asarray(wt, np.float64)[:, None]
    z = np.asarray(logz, np.float64)
    w = np.exp(logp - z) * w8
    return (m, s), ((z * w8).sum(), w.sum(axis=0), _bf(w).T @ _bf(x),
                    _bf(w).T @ _bf(x2))


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k5_k6_plain_default_two_ways(rng, diag):
    """'default' against the float64 evaluation on bf16-rounded operands
    (reassociation class: K5's m and s, K6's four statistics), and K5's
    shard log-evidence m + log(s) against JAX's 'highest' Pallas kernel in
    the bf16 class. K6's statistics are held the first way only: their
    weights exp(logp - logZ) carry exp() of logp's absolute bf16 error (a
    quadratic form of tens loses ~0.1 in one bf16 pass), which no relative
    class bounds; s alone carries it too, so K5 is compared as m + log(s)."""
    k, d, n = 6, 3, 2 * BLOCK
    state = state_from_numpy(make_state_np(rng, k, d, np.float32,
                                           inactive=(2,), diag=diag))
    x_np, wt_np = _events(rng, n, d)
    x, wt = torch.as_tensor(x_np), torch.as_tensor(wt_np)
    parts = [fs._prep_params(p, d, diag) for p in _shards(state, 2)]
    lse = [fs.local_lse(x, *p, diag=diag, precision="default") for p in parts]
    logz = _combine(lse)
    kw = dict(block_b=BLOCK, diag=diag, interpret=True)
    for p, (m, s) in zip(parts, lse):
        (rm, rs), ref6 = _default_reference(x_np, wt_np, logz.numpy(),
                                            *(t.numpy() for t in p), diag)
        assert normwise(m.numpy(), rm) <= F32_NORM["loglik"]
        assert normwise(s.numpy(), rs) <= F32_NORM["loglik"]
        ours = fs.stats_logz(x, wt, logz, *p, diag=diag, precision="default")
        for name, a, b in zip(STATS, ours, ref6):
            err = normwise(a.numpy().reshape(np.shape(b)), b)
            assert err <= F32_NORM[name], f"{name}: {err:.2e}"
        jm, js = _local_lse_call(jnp.asarray(x_np),
                                 *(jnp.asarray(t.numpy()) for t in p), **kw)
        assert normwise((m + torch.log(s)).numpy(),
                        np.asarray(jm) + np.log(np.asarray(js))) <= BF16_NORM


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("k", [50, 64, 65, 130])
@pytest.mark.parametrize("stats", [False, True], ids=["K5", "K6"])
def test_route_by_precision(rng, precision, k, stats):
    """'highest' keeps the 64-wide shard kernel for K_s <= 64; 'high' and
    'default' take K1's kernel (128-padded operands, K1's tile) for every
    shard, as csrc/fused_stats.cu's run_shard does."""
    d, diag = 24, True
    tile = fs.shard_tile(k, d, diag, stats=stats, precision=precision)
    shard = k <= fs.SHARD_TILE and precision == "highest"
    assert fs.on_shard_kernel(k, precision) == shard
    if shard:
        assert tile.k_pad == fs.SHARD_TILE and tile.bt == fs.SHARD_ROWS
    else:
        assert tile == fs.wide_tile(k, d, diag)
        assert tile.k_pad % fs.TILE == 0
    state = state_from_numpy(make_state_np(rng, k, d, np.float32, diag=diag))
    A, h, g = fs._prep_params(state, d, diag)
    a_ext, g_pad = fs._shard_operands(A, h, g, d, diag, precision)
    assert a_ext.shape == (2 * d, tile.k_pad) and g_pad.shape == (tile.k_pad,)
    assert not a_ext[:, k:].any() and bool((g_pad[k:] == fs.NEG_LARGE).all())


@pytest.mark.parametrize("precision", ["high", "default"])
def test_sharded_wrappers_take_the_bf16_modes(precision):
    """Off the CPU the wrappers go to the kernels at every precision: a
    tensor that is not on the card is refused as such, never by precision,
    and nothing is counted."""
    meta = lambda *s: torch.empty(s, device="meta")
    x, A, h, g = meta(128, 3), meta(9, 4), meta(3, 4), meta(1, 4)
    before = (fs.local_lse.launches, fs.stats_logz.launches,
              dict(fs.local_lse.precision_launches))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.local_lse(x, A, h, g, diag=False, precision=precision)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.stats_logz(x, meta(128), meta(128, 1), A, h, g, diag=False,
                      precision=precision)
    assert (fs.local_lse.launches, fs.stats_logz.launches,
            dict(fs.local_lse.precision_launches)) == before


# Two EM iterations: a 'high' fit's covariance update amplifies the last
# bits of w (tests/test_torch_precision.py), so the K5/K6 and K1 routes,
# whose w differ in those bits, part by ~1e-4 after four iterations.
MESH, ITERS, CHUNK = (1, 2), 2, 64


def _mesh_inputs():
    data, _ = make_blobs(np.random.default_rng(21), n=256, d=3, k=4,
                         dtype=np.float32)
    state = make_state_np(np.random.default_rng(22), 4, 3, np.float32,
                          diag=True)
    return data, state


@pytest.fixture(scope="module")
def mesh_high(tmp_path_factory):
    data, state = _mesh_inputs()
    return spawn_world(run_cases, 2, tmp_path_factory.mktemp("world"), [(
        "run_em_case", dict(data=data, state_np=state, iters=ITERS,
                            mesh_shape=MESH, chunk=CHUNK, dtype="float32",
                            diag=True, stats="sharded", precision="high"))])


def test_mesh_high_diag_matches_single_process(mesh_high):
    """``fused_stats_cuda_sharded`` at 'high' through real collectives (K5
    and K6's plain versions on each rank) against one process running K1's
    plain version at 'high': the same EM to the 'high' fit class (loglik
    rtol 1e-4, as tests/test_torch_precision.py holds a 'high' fit)."""
    data, state = _mesh_inputs()
    cfg = GMMConfig(device="cpu", diag_only=True, min_iters=ITERS,
                    max_iters=ITERS, chunk_size=CHUNK,
                    matmul_precision="high")
    model = GMMModel(cfg, stats_fn=functools.partial(
        fs.fused_stats_cuda, diag_only=True, precision="high"))
    chunks, wts = chunk_events(data, CHUNK)
    _, ll, iters = model.run_em(state_from_numpy(state),
                                torch.as_tensor(chunks), torch.as_tensor(wts),
                                convergence_epsilon(*data.shape))
    ranks = [r[0] for r in mesh_high]
    for r in ranks:
        assert r["iters"] == iters
        np.testing.assert_allclose(r["loglik"], ll, rtol=1e-4)
    means = np.concatenate([r["state"]["means"] for r in ranks])
    single = model.run_em(state_from_numpy(state), torch.as_tensor(chunks),
                          torch.as_tensor(wts),
                          convergence_epsilon(*data.shape))[0]
    np.testing.assert_allclose(means, single.means.numpy(), rtol=1e-3,
                               atol=1e-3)
