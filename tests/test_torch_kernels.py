"""The port's kernel wrappers K1-K4 on CPU (their plain versions) against
the JAX Pallas kernels in interpret mode and the JAX jnp path.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these plain versions there. Tolerances are the
tests/test_pallas.py class (float32 reassociation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu.ops.constants import compute_constants as j_constants
from cuda_gmm_mpi_tpu.ops.mstep import SuffStats as JStats
from cuda_gmm_mpi_tpu.ops.mstep import accumulate_stats as j_accumulate
from cuda_gmm_mpi_tpu.ops.pallas.fused_stats import (
    fused_mstep_pallas, fused_stats_pallas, fused_stats_pallas_batched,
)
from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy
from cuda_gmm_mpi_tpu_torch.ops.estep import expand_features
from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
from cuda_gmm_mpi_tpu_torch.ops.mstep import SuffStats, mstep_update
from cuda_gmm_mpi_tpu_torch.state import stack_states

from .test_torch_mstep_constants import FIELDS as MSTEP_FIELDS
from .test_torch_mstep_constants import f32_close
from .test_torch_ops import F32_TOL, make_state_np, to_jax

CASES = {
    # name: (k, d, chunks, chunk_size, inactive, weights)
    "masked": (5, 4, 4, 64, (2,), "unit"),
    "uneven_tiles": (3, 3, 2, 48, (), "unit"),  # 96 events: 1.5 tiles of 64
    "weighted": (6, 3, 3, 50, (0, 5), "random"),
}


def case_inputs(rng, name, diag):
    k, d, c, b, inactive, weights = CASES[name]
    s = make_state_np(rng, k, d, np.float32, inactive=inactive, diag=diag)
    chunks = rng.normal(scale=2.0, size=(c, b, d)).astype(np.float32)
    wts = (np.ones((c, b), np.float32) if weights == "unit"
           else rng.uniform(0.0, 3.0, size=(c, b)).astype(np.float32))
    wts[-1, b // 2:] = 0.0  # padded tail
    return s, chunks, wts


def assert_close_stats(ours, theirs):
    for name in ("loglik", "Nk", "M1", "M2"):
        rtol, atol = F32_TOL[name]
        np.testing.assert_allclose(
            getattr(ours, name).numpy(), np.asarray(getattr(theirs, name)),
            rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_stats_plain_matches_pallas_and_jnp(rng, case, diag):
    """fused_stats_cuda on CPU tensors (prep + plain K1) against
    fused_stats_pallas(interpret=True) and JAX accumulate_stats: masked
    clusters, tiles that do not divide the events, non-unit weights."""
    s, chunks, wts = case_inputs(rng, case, diag)
    ours = fs.fused_stats_cuda(state_from_numpy(s), torch.as_tensor(chunks),
                               torch.as_tensor(wts), diag_only=diag)
    pallas = fused_stats_pallas(to_jax(s), jnp.asarray(chunks),
                                jnp.asarray(wts), diag_only=diag, block_b=64,
                                interpret=True)
    jnp_ref = j_accumulate(to_jax(s), jnp.asarray(chunks), jnp.asarray(wts),
                           diag_only=diag)
    assert_close_stats(ours, pallas)
    assert_close_stats(ours, jnp_ref)
    for i in CASES[case][4]:
        assert float(ours.Nk[i]) == 0.0


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_fused_stats_cuda_skips_padding_rows(rng, diag):
    """n_events hands K1 only the real events in front of the chunk grid's
    zero-weight padding; the statistics stay those of the whole grid."""
    s, chunks, wts = case_inputs(rng, "masked", diag)
    c, b = wts.shape
    state = state_from_numpy(s)
    whole = fs.fused_stats_cuda(state, torch.as_tensor(chunks),
                                torch.as_tensor(wts), diag_only=diag)
    real = fs.fused_stats_cuda(state, torch.as_tensor(chunks),
                               torch.as_tensor(wts), diag_only=diag,
                               n_events=(c - 1) * b + b // 2)
    assert_close_stats(real, whole)


@pytest.mark.parametrize("d", [1, 3, 6])
def test_packed_a_matches_full_features(rng, d):
    """K1's packed operand: the upper-triangle features x_i*x_j (i <= j)
    times the packed A equal the full features times A."""
    A = torch.as_tensor(rng.normal(size=(d * d, 5)))
    x = torch.as_tensor(rng.normal(size=(50, d)))
    i, j = torch.triu_indices(d, d)
    torch.testing.assert_close((x[:, i] * x[:, j]) @ fs._packed_a(A, d),
                               expand_features(x) @ A, rtol=1e-12, atol=1e-12)


def _mstep_case(rng, diag):
    k, d = 6, 4
    s = make_state_np(rng, k, d, np.float32, inactive=(5,), diag=diag)
    chunks = rng.normal(scale=2.0, size=(2, 128, d)).astype(np.float32)
    st = j_accumulate(to_jax(s), jnp.asarray(chunks), None, diag_only=diag)
    nk = np.asarray(st.Nk).copy()
    nk[3], nk[4] = 0.0, 0.7  # the empty and dead-zone guards
    stats = dict(loglik=np.asarray(st.loglik), Nk=nk, M1=np.asarray(st.M1),
                 M2=np.asarray(st.M2))
    return s, stats


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_mstep_plain_matches_pallas(rng, diag):
    """K2's plain version (the whole M-step) against fused_mstep_pallas in
    interpret mode followed by JAX's compute_constants (the float32 rule
    of tests/test_torch_mstep_constants.py)."""
    s, stats = _mstep_case(rng, diag)
    ours = fs.fused_mstep_cuda(
        state_from_numpy(s),
        SuffStats(**{k: torch.tensor(v) for k, v in stats.items()}),
        diag_only=diag)
    theirs = j_constants(fused_mstep_pallas(
        to_jax(s), JStats(**{k: jnp.asarray(v) for k, v in stats.items()}),
        diag_only=diag, interpret=True), diag_only=diag)
    for name in MSTEP_FIELDS:
        f32_close(name, getattr(ours, name).numpy(), getattr(theirs, name))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_mstep_plain_equals_mstep_update(rng, diag, dtype):
    """K2's plain version is the torch-ops update bit for bit (the kernel
    is held to the same bar on the card), and every cluster here is
    positive definite."""
    s, stats = _mstep_case(rng, diag)
    state = state_from_numpy(s)
    state = state.replace(**{k: getattr(state, k).to(dtype)
                             for k in ("N", "pi", "constant", "avgvar",
                                       "means", "R", "Rinv")})
    st = SuffStats(**{k: torch.tensor(v, dtype=dtype) for k, v in stats.items()})
    K, D = state.means.shape
    m2 = st.M2 if diag else st.M2.reshape(K, D * D)
    n, mean, R, *_, ok = fs.mstep_plain(st.Nk, st.M1, m2, state.avgvar,
                                        state.active, diag=diag)
    N, means, R_ref = mstep_update(state, st, diag_only=diag)
    assert bool(ok.all())
    assert torch.equal(n, N)
    assert torch.equal(mean, means)
    assert torch.equal(R, R_ref)


# ------------------------------------------------ K3 / K4 (restart-batched)


def _jstack(states):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_fused_stats_batched_plain_matches_pallas(rng, diag):
    """fused_stats_cuda_batched on CPU tensors (per-lane prep + plain K3)
    against fused_stats_pallas_batched(interpret=True): lanes with inactive
    clusters, a frozen lane, zero-weight padding rows. Per lane the plain K3
    is K1's plain version bit for bit, and the frozen lane is all zeros."""
    k, d = 5, 4
    lanes = [make_state_np(rng, k, d, np.float32, inactive=inact, diag=diag)
             for inact in ((), (2,), (), (0, 4))]
    chunks = rng.normal(scale=2.0, size=(4, 64, d)).astype(np.float32)
    wts = np.ones((4, 64), np.float32)
    wts[-1, 32:] = 0.0  # padding rows
    mask = np.array([True, True, False, True])
    states = stack_states([state_from_numpy(s) for s in lanes])
    ours = fs.fused_stats_cuda_batched(
        states, torch.as_tensor(chunks), torch.as_tensor(wts),
        lane_mask=torch.as_tensor(mask), diag_only=diag)
    theirs = fused_stats_pallas_batched(
        _jstack([to_jax(s) for s in lanes]), jnp.asarray(chunks),
        jnp.asarray(wts), lane_mask=jnp.asarray(mask), diag_only=diag,
        block_b=64, interpret=True)
    for name in ("loglik", "Nk", "M1", "M2"):
        rtol, atol = F32_TOL[name]
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(theirs, name)),
                                   rtol=rtol, atol=atol, err_msg=name)
        assert not getattr(ours, name)[2].any(), name
    x, wt = fs._prep_events(torch.as_tensor(chunks), torch.as_tensor(wts))
    params = [fs._prep_params(state_from_numpy(s), d, diag) for s in lanes]
    A, h, g = (torch.stack(p) for p in zip(*params))
    out = fs.fused_stats_batched(x, wt, torch.as_tensor(mask, dtype=torch.float32),
                                 A, h, g, diag=diag)
    for r in (0, 1, 3):
        one = fs.fused_stats(x, wt, *params[r], diag=diag)
        for a, b in zip(out, one):
            assert torch.equal(a[r], b)
    assert not any(o[2].any() for o in out)
    assert float(ours.Nk[1, 2]) == 0.0  # lane 1's inactive cluster


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_mstep_batched_plain_matches_pallas(rng, diag):
    """K4's plain version against fused_mstep_pallas on a batched state
    (interpret mode) and JAX's compute_constants per lane, and per lane bit
    for bit K2's plain version."""
    cases = [_mstep_case(rng, diag) for _ in range(3)]
    states = stack_states([state_from_numpy(s) for s, _ in cases])
    stats = SuffStats(**{k: torch.stack([torch.tensor(st[k]) for _, st in cases])
                         for k in ("loglik", "Nk", "M1", "M2")})
    ours = fs.fused_mstep_cuda_batched(states, stats, diag_only=diag)
    theirs = fused_mstep_pallas(
        _jstack([to_jax(s) for s, _ in cases]),
        JStats(**{k: jnp.asarray(getattr(stats, k).numpy())
                  for k in ("loglik", "Nk", "M1", "M2")}),
        diag_only=diag, interpret=True)
    for r in range(3):
        lane_r = j_constants(jax.tree_util.tree_map(lambda v: v[r], theirs),
                             diag_only=diag)
        for name in MSTEP_FIELDS:
            f32_close(name, getattr(ours, name)[r].numpy(),
                      getattr(lane_r, name))
    ops = fs._mstep_operands(states, stats, diag)
    out = fs.mstep_batched(*ops, diag=diag)
    for r in range(3):
        one = fs.mstep_plain(*(o[r] for o in ops), diag=diag)
        for a, b in zip(out, one):
            assert torch.equal(a[r], b)


def test_held_launches_hold_only_this_threads_counts():
    """A graph's warm-up and capture hold their own thread's launches
    aside; another thread's launches meanwhile reach the counter."""
    import threading

    from cuda_gmm_mpi_tpu_torch.ops.kernels.counts import (
        held_launches, note_launch,
    )

    def wrapper():
        pass

    wrapper.launches = 0
    with held_launches() as outer:
        note_launch(wrapper)
        with held_launches() as inner:
            note_launch(wrapper)
            note_launch(wrapper)
            other = threading.Thread(target=note_launch, args=(wrapper,))
            other.start()
            other.join()
        note_launch(wrapper)
    note_launch(wrapper)
    assert inner == {wrapper: 2}
    assert outer == {wrapper: 2}
    assert wrapper.launches == 2
