"""The port's K5/K6 plain versions and their shard combination on the CPU,
against the JAX package's cluster-sharded Pallas kernels in interpret mode.

- ``local_lse_plain`` against ``_local_lse_call(interpret=True)`` and
  ``stats_logz_plain`` against ``_stats_logz_call(interpret=True)``, per
  cluster shard: full and diagonal covariance, an inactive cluster, and an
  all-masked shard (K = 3 padded to 4 over 4 shards).
- The shards combined in one process as ``fused_stats_cuda_sharded``
  combines them (torch max and sum in place of the all_reduce calls, a sum
  over data shards in place of the data-axis all_reduce) against
  ``fused_stats_pallas_sharded`` under ``shard_map`` on (1, 4) and (2, 2)
  meshes of the conftest's fake devices, and against the unsharded
  ``fused_stats_pallas``.

The CUDA kernels run only on the card (tests/test_torch_cuda.py). Tolerances
are the tests/test_pallas.py class (float32 reassociation); the per-event m
and s get loglik's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from cuda_gmm_mpi_tpu.ops.pallas.fused_stats import (
    _local_lse_call, _stats_logz_call, fused_stats_pallas,
    fused_stats_pallas_sharded,
)
from cuda_gmm_mpi_tpu.parallel import make_mesh as j_make_mesh
from cuda_gmm_mpi_tpu.parallel.mesh import state_pspecs, stats_pspecs
from cuda_gmm_mpi_tpu.parallel.sharded_em import pad_state_clusters as j_pad
from cuda_gmm_mpi_tpu.parallel.sharded_em import shard_map
from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy
from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
from cuda_gmm_mpi_tpu_torch.parallel import cluster_slice, pad_state_clusters
from cuda_gmm_mpi_tpu_torch.parallel.mesh import Mesh
from jax.sharding import PartitionSpec as P

from .test_torch_ops import F32_TOL, make_state_np, to_jax

BLOCK = 64
LSE_TOL = F32_TOL["loglik"]


def _shards(state, shards):
    """The port state padded to the shard count and cut into its shards."""
    padded = pad_state_clusters(state, shards)
    return [cluster_slice(Mesh((1, shards), j, None, None), padded)
            for j in range(shards)]


def _events(rng, n, d):
    x = rng.normal(scale=2.0, size=(n, d)).astype(np.float32)
    wt = np.ones(n, np.float32)
    wt[-BLOCK // 2:] = 0.0  # padding rows
    return x, wt


@pytest.mark.parametrize("k,shards,inactive", [
    (5, 2, (1,)),   # inactive cluster; K=5 padded to 6
    (3, 4, ()),     # K=3 padded to 4: shard 3 is all-masked
], ids=["inactive", "all-masked-shard"])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k5_k6_plain_match_pallas_per_shard(rng, k, shards, inactive, diag):
    d, n = 3, 2 * BLOCK
    state = state_from_numpy(make_state_np(rng, k, d, np.float32,
                                           inactive=inactive, diag=diag))
    x_np, wt_np = _events(rng, n, d)
    x, wt = torch.as_tensor(x_np), torch.as_tensor(wt_np)
    kw = dict(block_b=BLOCK, diag=diag, interpret=True)
    lse, params = [], []
    for part in _shards(state, shards):
        p = fs._prep_params(part, d, diag)
        m, s = fs.local_lse_plain(x, *p, diag=diag)
        jm, js = _local_lse_call(jnp.asarray(x_np),
                                 *(jnp.asarray(t.numpy()) for t in p), **kw)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=LSE_TOL[0])
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=LSE_TOL[0])
        if not bool(part.active.any()):  # the all-masked shard
            assert bool((m == fs.NEG_LARGE).all())
            assert bool((s == part.num_clusters_padded).all())
        lse.append((m, s))
        params.append(p)
    big_m = torch.stack([m for m, _ in lse]).max(dim=0).values
    logz = big_m + torch.log(sum(torch.exp(m - big_m) * s for m, s in lse))
    nk = []
    for p in params:
        ours = fs.stats_logz_plain(x, wt, logz, *p, diag=diag)
        nk.append(ours[1])
        theirs = _stats_logz_call(
            jnp.asarray(x_np), jnp.asarray(wt_np[:, None]),
            jnp.asarray(logz.numpy()), *(jnp.asarray(t.numpy()) for t in p),
            **kw)
        for name, a, b in zip(F32_TOL, ours, theirs):
            rtol, atol = F32_TOL[name]
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                       atol=atol, err_msg=name)
    nk = torch.cat(nk, dim=1)[0]
    assert not nk[list(inactive) + list(range(k, len(nk)))].any()


def _combined(state, chunks, wts, mesh_shape, diag):
    """The statistics of every (data, cluster) shard combined in one
    process: per data shard the log-sum-exp over the cluster shards, K6 per
    shard, then the sum over data shards; the cluster shards side by side."""
    S, C = mesh_shape
    d = chunks.shape[-1]
    parts = _shards(state, C)
    blocks = zip(np.split(chunks, S), np.split(wts, S))
    total = None
    for c_blk, w_blk in blocks:
        x, wt = fs._prep_events(torch.as_tensor(c_blk), torch.as_tensor(w_blk))
        params = [fs._prep_params(p, d, diag) for p in parts]
        lse = [fs.local_lse(x, *p, diag=diag) for p in params]
        big_m = torch.stack([m for m, _ in lse]).max(dim=0).values
        logz = big_m + torch.log(sum(torch.exp(m - big_m) * s for m, s in lse))
        outs = [fs.stats_logz(x, wt, logz, *p, diag=diag) for p in params]
        side = [outs[0][0], torch.cat([o[1] for o in outs], dim=1),
                torch.cat([o[2] for o in outs]), torch.cat([o[3] for o in outs])]
        total = side if total is None else [a + b for a, b in zip(total, side)]
    return total


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_shard_combination_matches_pallas_sharded(rng, mesh_shape, diag):
    k, d = 5, 3
    s_np = make_state_np(rng, k, d, np.float32, inactive=(1,), diag=diag)
    chunks = rng.normal(scale=2.0, size=(4, BLOCK, d)).astype(np.float32)
    wts = np.ones((4, BLOCK), np.float32)
    wts[-1, BLOCK // 2:] = 0.0
    ll, nk, m1, m2 = _combined(state_from_numpy(s_np), chunks, wts,
                               mesh_shape, diag)

    mesh = j_make_mesh(mesh_shape)
    j_state = j_pad(to_jax(s_np), mesh_shape[1])
    fn = functools.partial(fused_stats_pallas_sharded, cluster_axis="cluster",
                           diag_only=diag, block_b=BLOCK, interpret=True)
    body = lambda s, c, w: jax.tree_util.tree_map(
        lambda a: lax.psum(a, "data"), fn(s, c, w))
    sharded = jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(state_pspecs(), P("data", None, None), P("data", None)),
        out_specs=stats_pspecs(diag), check_vma=False))(
            j_state, jnp.asarray(chunks), jnp.asarray(wts))
    single = fused_stats_pallas(to_jax(s_np), jnp.asarray(chunks),
                                jnp.asarray(wts), diag_only=diag,
                                block_b=BLOCK, interpret=True)
    kp = nk.shape[1]
    ours = dict(loglik=ll[0, 0], Nk=nk[0], M1=m1,
                M2=m2 if diag else m2.reshape(kp, d, d))
    for ref in (sharded, single):
        for name, rtol_atol in F32_TOL.items():
            theirs = np.asarray(getattr(ref, name))
            mine = ours[name].numpy()
            if name != "loglik":
                mine = mine[:k]
                theirs = theirs[:k]
            np.testing.assert_allclose(mine, theirs, rtol=rtol_atol[0],
                                       atol=rtol_atol[1], err_msg=name)
    assert float(nk[0, 1]) == 0.0 and not nk[0, k:].any()
