"""K1/K3's tile choice and padded operands on the CPU (the narrow route).

- ``stats_tile``: at 'highest' with K <= 64, K_pad is the narrowest of 16,
  32 and 64 that holds K (the narrow route); else, and at 'high' and
  'default', a multiple of 128 (K1's 128-wide tiles, ``wide_tile``). Its
  event tile and grid are K1's at K_pad 128, so the narrow route reduces in
  that route's order; its CTAs per SM fit the H100's shared memory (the
  ones the instances are compiled for at D = 24). Its constants are the
  ones csrc/fused_stats.cu is compiled with.
- ``_ext_operands`` at width W: the padding columns are inert (A_ext 0, g
  NEG_LARGE), and Nk/M1/M2 and the loglik computed in plain torch from the
  W-padded operands, as the kernel computes them (features [x2 packed | x
  | 1], the log-sum-exp over all W columns, each packed M2 sum written to
  both mirrored entries), match the JAX package's ``_fused_stats_call`` and
  ``_fused_stats_batched_call`` in interpret mode, at the tolerance of
  tests/test_torch_shard_tiles.py.
- The restart batch's memory cap sizes K3's partial buffer at that K_pad.
- The port's CLI help names only the port's own modules.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu.ops.pallas.fused_stats import (
    _fused_stats_batched_call, _fused_stats_call,
)
from cuda_gmm_mpi_tpu_torch import GMMConfig
from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy
from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

from .test_torch_ops import F32_TOL, make_state_np
from .test_torch_shard_tiles import _unpacked_m2
from .test_torch_sharded_kernels import BLOCK, _events

CSRC = Path(fs.__file__).resolve().parents[2] / "csrc" / "fused_stats.cu"


@pytest.mark.parametrize("k,k_pad", [(1, 16), (8, 16), (16, 16), (17, 32),
                                     (32, 32), (33, 64), (64, 64), (65, 128),
                                     (100, 128), (130, 256)])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_k_pad_is_the_narrowest_width_at_highest_else_a_multiple_of_128(
        k, k_pad, precision):
    tile = fs.stats_tile(k, 24, False, precision)
    if precision == "highest" or k_pad >= fs.TILE:
        assert tile.k_pad == k_pad
    else:  # 'high' and 'default' keep the 128-wide route
        assert tile.k_pad == fs.TILE
    if tile.k_pad >= fs.TILE:
        assert tile == fs.wide_tile(k, 24, False)
        assert tile.ctas_per_sm == 1


@pytest.mark.parametrize("d", [2, 6, 24, 32])
@pytest.mark.parametrize("block_b", [64, 128, 512])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_bt_and_grid_are_k1s_at_k_pad_128(d, block_b, diag):
    for k in (1, 16, 17, 64):
        tile = fs.stats_tile(k, d, diag, block_b=block_b)
        assert tile.k_pad in fs.STATS_WIDTHS
        assert tile.bt == fs.k1_tile(fs.TILE, d, block_b, diag)
        assert tile.bt == fs.wide_tile(k, d, diag, block_b).bt
        assert tile.grid == fs.K1_GRID


@pytest.mark.parametrize("d", [2, 6, 24, 32, 48])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_shared_memory_fits_the_ctas_per_sm_it_reports(d, diag):
    for w in fs.STATS_WIDTHS:
        tile = fs.stats_tile(w, d, diag)
        assert 1 <= tile.ctas_per_sm <= fs.STATS_CTAS[w]
        assert tile.smem <= fs.K1_SMEM_BYTES == 232448
        assert (tile.ctas_per_sm * (tile.smem + fs.CTA_RESERVED_SMEM)
                <= fs.SM_SMEM_BYTES == 233472)
        assert tile.smem < fs.wide_tile(w, d, diag).smem
        if d == 24:  # the fleet's and the main path's D
            assert tile.ctas_per_sm == fs.STATS_CTAS[w]


@pytest.mark.parametrize("block_b", [64, 128, 512])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_every_shape_the_wide_route_fits_gets_a_tile_that_fits(block_b, diag):
    """Wherever the 128-wide route fits (D up to 255), the tile fits one
    CTA's shared memory and reports at least one CTA per SM; where a
    narrow pass of rows would not fit (a small event tile at a large D),
    it is the 128-wide route's tile, whose bits are the same."""
    fell_back = 0
    for d in range(1, 256):
        for k in (1, 16, 17, 33, 64):
            try:
                wide = fs.wide_tile(k, d, diag, block_b)
            except ValueError:
                with pytest.raises(ValueError):
                    fs.stats_tile(k, d, diag, block_b=block_b)
                continue
            tile = fs.stats_tile(k, d, diag, block_b=block_b)
            assert tile.smem <= fs.K1_SMEM_BYTES and tile.ctas_per_sm >= 1
            assert (tile.bt, tile.grid) == (wide.bt, wide.grid)
            if tile.k_pad == fs.TILE:
                assert tile == wide
                fell_back += 1
    # At block_b 512 the event tile is 256 rows, a whole pass at every W.
    assert (fell_back > 0) == (block_b < 512)
    # Full D = 150 at block_b 64: 256 rows of a W = 16 pass would need
    # 244,992 bytes, the 128-wide route's 64-row tile 154,368.
    if not diag and block_b == 64:
        assert fs._k1_smem(64, 16, 150, False) == 244992
        assert fs.stats_tile(16, 150, False, block_b=64) == fs.KernelTile(
            fs.TILE, 64, fs.K1_GRID, 1, 154368)


def test_shared_memory_at_the_fleets_shape():
    """A tenant of the fleet cell, D = 24, K = 16: the byte counts of the
    narrow route's buffers."""
    posteriors = 4 * 256 * (16 + 8)
    a_stages = 4 * 2 * 16 * 16
    f_stages = 4 * 2 * 16 * (128 + 8)
    events = 4 * 256 * (25 + 1)  # [x | 1] rows and the weights
    pairs = 4 * 384  # T + D + 1 = 325 feature columns, padded to 128
    smem = posteriors + a_stages + f_stages + events + pairs
    assert fs.stats_tile(16, 24, False) == fs.KernelTile(16, 256, 132, 3, smem)


def test_constants_are_the_kernel_source_s():
    src = CSRC.read_text()
    const = lambda name: int(re.search(rf"\b{name} = (\d+)", src).group(1))
    assert {w: const(f"W{w}_CTAS") for w in fs.STATS_WIDTHS} == fs.STATS_CTAS
    assert "kp == 16 || kp == 32 || kp == 64" in src  # narrow_kp
    rows = re.search(r"return w == 16 \? (\d+) : (\d+);", src).groups()
    assert fs.STATS_ROWS == {16: int(rows[0]), 32: int(rows[1]),
                             64: int(rows[1])}
    assert const("NT") == fs.TILE
    assert const("PAD") == fs.ROW_PAD
    assert const("KC") == fs.STAGE_DEPTH


def _kernel_arithmetic(x, wt, a_ext, g_pad, k, d, diag):
    """What K1's kernel computes from W-padded operands, in plain torch:
    logp over all W columns, the log-sum-exp over them, and (ll, Nk, M1,
    M2) for the k real clusters."""
    if diag:
        x2 = x * x
    else:
        i, j = torch.triu_indices(d, d)
        x2 = x[:, i] * x[:, j]
    feat = torch.cat([x2, x], dim=1)  # [N, T + D], A_ext's rows
    logp = -0.5 * (feat @ a_ext) + g_pad
    m = logp.max(dim=1, keepdim=True).values
    s = torch.exp(logp - m).sum(dim=1, keepdim=True)
    w = torch.exp(logp - m) / s * wt[:, None]
    aug = torch.cat([feat, torch.ones_like(x[:, :1])], dim=1)
    out = (w.T @ aug)[:k]  # [k, T + D + 1] = [M2 packed | M1 | Nk]
    t = x2.shape[1]
    return (((m[:, 0] + torch.log(s[:, 0])) * wt).sum().reshape(1, 1),
            out[:, -1][None, :], out[:, t:t + d],
            _unpacked_m2(out[:, :t], d, diag))


def _close(ours, theirs, label):
    for name, a, b in zip(F32_TOL, ours, theirs):
        rtol, atol = F32_TOL[name]
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=f"{label} {name}")


# Each K of {1, 8, 16, 17, 33, 64} once, K1 and K3 each at 16 and 64
# columns (K1 also at 32): one interpret-mode compile per case.
@pytest.mark.parametrize("call,k", [("K1", 1), ("K1", 17), ("K1", 64),
                                    ("K3", 8), ("K3", 16), ("K3", 33)])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_w_padded_operands_give_the_pallas_kernels_results(rng, call, k, diag):
    """K1 on one state, or K3 on two lanes (the second frozen), from the
    plain arithmetic on W-padded operands against the TPU kernels run in
    interpret mode (one event tile, to keep the test quick)."""
    d, n = 3, 2 * BLOCK
    w = fs.stats_tile(k, d, diag).k_pad
    inactive = [(k // 2,), (0, k - 1)] if k > 2 else [(), ()]
    states = [state_from_numpy(make_state_np(rng, k, d, np.float32,
                                             inactive=inact, diag=diag))
              for inact in inactive]
    x_np, wt_np = _events(rng, n, d)
    x, wt = torch.as_tensor(x_np), torch.as_tensor(wt_np)
    params = [fs._prep_params(s, d, diag) for s in states]
    A, h, g = (torch.stack(p) for p in zip(*params))
    a_ext, g_pad, t = fs._ext_operands(A, h, g, d, diag, w)
    assert a_ext.shape == (2, t + d, w) and g_pad.shape == (2, w)
    assert not a_ext[..., k:].any()
    assert bool((g_pad[:, k:] == fs.NEG_LARGE).all())
    assert torch.equal(a_ext[:, t:, :k], -2.0 * h)
    assert torch.equal(g_pad[:, :k], g[:, 0])

    kw = dict(block_b=n, diag=diag, interpret=True)
    j_x, j_wt = jnp.asarray(x_np), jnp.asarray(wt_np[:, None])
    if call == "K1":
        theirs = _fused_stats_call(
            j_x, j_wt, *(jnp.asarray(v[0].numpy()) for v in (A, h, g)), **kw)
        ours = _kernel_arithmetic(x, wt, a_ext[0], g_pad[0], k, d, diag)
        _close(ours, theirs, "K1")
        assert not ours[1][0, list(inactive[0])].any()
        return
    lanes = np.array([[1.0], [0.0]], np.float32)
    theirs = _fused_stats_batched_call(
        j_x, j_wt, jnp.asarray(lanes),
        *(jnp.asarray(v.numpy()) for v in (A, h, g)), **kw)
    for r in range(2):
        ours = _kernel_arithmetic(x, wt * float(lanes[r, 0]), a_ext[r],
                                  g_pad[r], k, d, diag)
        _close(ours, [np.asarray(v)[r] for v in theirs], f"K3 lane {r}")


def test_restart_cap_sizes_k3s_partials_at_the_tiles_k_pad(monkeypatch):
    """On the kernel path the per-lane device term counts K3's [G, K_pad,
    T+D+1] partials at stats_tile's K_pad: 16 columns for K = 16, not 128."""
    from cuda_gmm_mpi_tpu_torch.models import restarts
    from cuda_gmm_mpi_tpu_torch.ops import kernels

    free = 1 << 30
    monkeypatch.setenv("GMM_RESTART_MEM_BYTES", str(1 << 60))
    monkeypatch.setattr(kernels, "resolve_estep_backend",
                        lambda config: ("cuda", "test"))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (free, free))
    D, n = 24, 100_000
    t = D * (D + 1) // 2
    for k, precision in ((16, "highest"), (16, "high"), (100, "highest")):
        cfg = GMMConfig(matmul_precision=precision)
        k_pad = fs.stats_tile(k, D, False, precision).k_pad
        assert k_pad == (16 if (k, precision) == (16, "highest") else 128)
        per_lane = (4 * fs.K1_GRID * k_pad * (t + D + 1) + 8 * fs.K1_GRID
                    + 3 * (4 * k * (D * D + D + 1) + 4 * k * (2 * D * D + D + 4)
                           + k))
        cap = restarts.restart_batch_auto_cap(cfg, n, D, k)
        assert cap == (free // 4) // per_lane


def test_cli_help_names_only_the_ports_modules():
    """Every help text of the port's parser (its subcommands' too) names
    the port's modules, never the JAX package's (which the card's machine
    does not have)."""
    import argparse

    from cuda_gmm_mpi_tpu_torch.cli import build_parser

    texts, todo = [], [build_parser()]
    while todo:
        p = todo.pop()
        texts.append(p.format_help())
        for action in p._actions:
            if isinstance(action, argparse._SubParsersAction):
                todo.extend(action.choices.values())
    helps = "\n".join(texts)
    assert "cuda_gmm_mpi_tpu_torch.cli report" in helps
    assert not re.search(r"\bcuda_gmm_mpi_tpu\.", helps)
