"""K5/K6's tile choice and padded operands on the CPU.

- ``shard_tile``: K_pad 64 for a shard of at most 64 clusters (the shard
  kernel), else a multiple of 128 (K1's kernel and tile); the CTAs per SM it
  reports fit the H100's shared memory (233,472 bytes per SM, 1,024 of them
  reserved per CTA, at most 232,448 for one CTA); its grid is 132 x those
  CTAs, from the shapes alone; a shape that does not fit raises ValueError.
  Its constants are the ones csrc/fused_stats.cu is compiled with.
- ``_ext_operands`` at the shard's width: the padding columns are inert
  (A_ext 0, g NEG_LARGE), and m, s and Nk/M1/M2 computed in plain torch from
  the padded operands, as the kernels compute them (features [x2 packed | x
  | 1], the real columns only in m and s, w = 0 on the padding, each packed
  M2 sum written to both mirrored entries), match the JAX package's
  ``_local_lse_call`` and ``_stats_logz_call`` in interpret mode, at the
  tolerance of tests/test_torch_sharded_kernels.py.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu.ops.pallas.fused_stats import _local_lse_call, _stats_logz_call
from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy
from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

from .test_torch_ops import F32_TOL, make_state_np
from .test_torch_sharded_kernels import BLOCK, LSE_TOL, _events

CSRC = Path(fs.__file__).resolve().parents[2] / "csrc" / "fused_stats.cu"


@pytest.mark.parametrize("k,k_pad", [(1, 64), (25, 64), (50, 64), (64, 64),
                                     (65, 128), (128, 128), (130, 256),
                                     (257, 384)])
@pytest.mark.parametrize("stats", [False, True], ids=["K5", "K6"])
def test_k_pad_is_64_up_to_64_clusters_else_a_multiple_of_128(k, k_pad, stats):
    tile = fs.shard_tile(k, 24, True, stats=stats)
    assert tile.k_pad == k_pad
    if k <= fs.SHARD_TILE:
        assert tile.bt == fs.SHARD_ROWS
    else:  # K1's kernel in the K5/K6 mode, on K1's tile and grid
        assert tile == fs.wide_tile(k, 24, True)
        assert tile.bt == fs.k1_tile(k_pad, 24, 512, True)
        assert (tile.grid, tile.ctas_per_sm) == (fs.K1_GRID, 1)


@pytest.mark.parametrize("d", [2, 6, 24, 32])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_shared_memory_fits_the_ctas_per_sm_it_reports(d, diag):
    for k in (1, 50, 64, 65, 130):
        for stats in (False, True):
            tile = fs.shard_tile(k, d, diag, stats=stats)
            assert 1 <= tile.ctas_per_sm
            assert tile.smem <= fs.K1_SMEM_BYTES == 232448
            assert (tile.ctas_per_sm * (tile.smem + fs.CTA_RESERVED_SMEM)
                    <= fs.SM_SMEM_BYTES == 233472)
            if k <= fs.SHARD_TILE:
                # the mesh cell's widths get the CTAs the kernel is built for
                assert tile.ctas_per_sm == fs.SHARD_CTAS[stats] > 1
                assert tile.grid == fs.K1_GRID * tile.ctas_per_sm


def test_shared_memory_at_the_mesh_cell():
    """One rank of the (2, 2) cell, D = 24, K_s = 50: the byte counts of
    the shard kernel's buffers."""
    stage = 4 * 2 * 16 * (64 + 128 + 8)  # A_ext and feature stages, doubled
    events = 4 * 128 * 25
    pairs = 4 * 384  # T + D + 1 = 325 feature columns, padded to 128
    posteriors = 4 * 128 * 72
    k5 = fs.shard_tile(50, 24, False, stats=False)
    k6 = fs.shard_tile(50, 24, False, stats=True)
    assert k5 == fs.KernelTile(64, 128, 396, 3, stage + events + pairs)
    assert k6 == fs.KernelTile(64, 128, 264, 2,
                              stage + events + pairs + posteriors)


@pytest.mark.parametrize("k,d,diag,stats", [
    (50, 256, True, False),   # the pair table holds coordinates < 256
    (50, 200, False, True),   # K6's buffers outgrow one CTA's 232,448 bytes
    (130, 200, False, True),  # K1's kernel does not fit either
], ids=["d256", "k6-d200", "wide-d200"])
def test_a_shape_that_does_not_fit_raises(k, d, diag, stats):
    with pytest.raises(ValueError, match="does not fit"):
        fs.shard_tile(k, d, diag, stats=stats)


def test_k5_at_d200_full_fits_one_cta_per_sm():
    """Where the target's CTAs do not fit, fewer do; the grid follows."""
    tile = fs.shard_tile(50, 200, False, stats=False)
    assert tile.ctas_per_sm == 1 and tile.grid == fs.K1_GRID


def test_constants_are_the_kernel_source_s():
    src = CSRC.read_text()
    const = lambda name: int(re.search(rf"\b{name} = (\d+)", src).group(1))
    assert const("NS") == fs.SHARD_TILE
    assert const("SR") == fs.SHARD_ROWS
    assert const("K5_CTAS") == fs.SHARD_CTAS[False]
    assert const("K6_CTAS") == fs.SHARD_CTAS[True]
    assert const("NT") == fs.TILE
    assert const("PAD") == fs.ROW_PAD
    assert const("KC") == fs.STAGE_DEPTH


def _unpacked_m2(m2p, d, diag):
    """The reduction's layout: each packed upper-triangle sum (row-major
    (i, j), i <= j) at both [i*D + j] and [j*D + i]."""
    if diag:
        return m2p
    i, j = torch.triu_indices(d, d)
    out = torch.empty(m2p.shape[0], d, d, dtype=m2p.dtype)
    out[:, i, j] = m2p
    out[:, j, i] = m2p
    return out.reshape(-1, d * d)


def _kernel_arithmetic(x, wt, logz, a_ext, g_pad, k, d, diag):
    """What K5 and K6 compute from their padded operands, in plain torch:
    (m, s) over the k real columns, and (ll, Nk, M1, M2) with w = 0 on the
    padding columns."""
    if diag:
        x2 = x * x
    else:
        i, j = torch.triu_indices(d, d)
        x2 = x[:, i] * x[:, j]
    feat = torch.cat([x2, x], dim=1)  # [N, T + D], A_ext's rows
    logp = -0.5 * (feat @ a_ext) + g_pad
    real = logp[:, :k]
    m = real.max(dim=1, keepdim=True).values
    s = torch.exp(real - m).sum(dim=1, keepdim=True)
    w = torch.exp(logp - logz) * wt[:, None]
    w[:, k:] = 0.0
    aug = torch.cat([feat, torch.ones_like(x[:, :1])], dim=1)
    out = (w.T @ aug)[:k]  # [k, T + D + 1] = [M2 packed | M1 | Nk]
    t = x2.shape[1]
    return (m, s), ((logz[:, 0] * wt).sum().reshape(1, 1),
                    out[:, -1][None, :], out[:, t:t + d],
                    _unpacked_m2(out[:, :t], d, diag))


@pytest.mark.parametrize("k,inactive", [(5, (1,)), (50, (7,)), (64, ()),
                                        (3, (0, 1, 2))],
                         ids=["k5", "k50", "k64", "all-masked"])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_padded_operands_give_the_pallas_kernels_results(rng, k, inactive, diag):
    d, n = 3, 2 * BLOCK
    state = state_from_numpy(make_state_np(rng, k, d, np.float32,
                                           inactive=inactive, diag=diag))
    x_np, wt_np = _events(rng, n, d)
    x, wt = torch.as_tensor(x_np), torch.as_tensor(wt_np)
    A, h, g = fs._prep_params(state, d, diag)
    a_ext, g_pad, t = fs._ext_operands(A, h, g, d, diag, fs.SHARD_TILE)
    tile = fs.shard_tile(k, d, diag, stats=True)
    assert a_ext.shape == (t + d, tile.k_pad) and g_pad.shape == (tile.k_pad,)
    assert tile.k_pad == fs.SHARD_TILE
    assert not a_ext[:, k:].any() and bool((g_pad[k:] == fs.NEG_LARGE).all())
    assert torch.equal(a_ext[t:, :k], -2.0 * h)
    assert torch.equal(g_pad[:k], g[0])
    assert all(torch.equal(a, b) for a, b in zip(
        fs._shard_operands(A, h, g, d, diag), (a_ext, g_pad)))

    kw = dict(block_b=BLOCK, diag=diag, interpret=True)
    j_params = [jnp.asarray(v.numpy()) for v in (A, h, g)]
    jm, js = _local_lse_call(jnp.asarray(x_np), *j_params, **kw)
    # This shard's own evidence, or (all masked) another shard's: finite.
    logz = (torch.full((n, 1), 5.0) if len(inactive) == k else
            torch.as_tensor(np.asarray(jm) + np.log(np.asarray(js))))
    (m, s), stats = _kernel_arithmetic(x, wt, logz, a_ext, g_pad, k, d, diag)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=LSE_TOL[0])
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=LSE_TOL[0])
    if len(inactive) == k:  # the all-masked shard
        assert bool((m == fs.NEG_LARGE).all()) and bool((s == k).all())
    theirs = _stats_logz_call(jnp.asarray(x_np), jnp.asarray(wt_np[:, None]),
                              jnp.asarray(logz.numpy()), *j_params, **kw)
    for name, a, b in zip(F32_TOL, stats, theirs):
        rtol, atol = F32_TOL[name]
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=name)
    assert not stats[1][0, list(inactive)].any()

