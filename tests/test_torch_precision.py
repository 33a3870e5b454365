"""The port's matmul precisions 'high' and 'default' against the JAX
package, on CPU.

'high' (bf16_3x): the port's ``kdot`` and the plain versions of K1/K3
spell out the same split as the TPU kernels' ``_kdot`` (x = bf16(x) +
bf16(x - bf16(x)), three bf16 products in fp32), which the JAX Pallas
kernels compute in interpret mode on the CPU too: they are held to each
other in the float32 reassociation class (tests/test_pallas.py's, applied
normwise: loglik 1e-5, Nk 1e-5, M1 1e-4, M2 1e-4 + 1e-3), and so is a
whole fit.

'default' (one bf16 pass): XLA:CPU ignores Precision.DEFAULT and computes
fp32, so no JAX function on the CPU computes the TPU's one-pass bf16
arithmetic. The port's 'default' is held two ways instead: against a numpy
float64 evaluation of the same formula with each product's operands
rounded to bf16 where the TPU kernel rounds them (x, the x2 features, A,
h, w), in the float32 reassociation class; and against JAX's 'highest', in
the bf16 class (2^-8 relative per operand; normwise 2e-2 here).
"""

import functools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu.config import GMMConfig as JConfig
from cuda_gmm_mpi_tpu.models.order_search import fit_gmm as j_fit
from cuda_gmm_mpi_tpu.ops.pallas.fused_stats import (
    _NT, _kdot, fused_stats_pallas, fused_stats_pallas_batched,
)
from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm
from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy
from cuda_gmm_mpi_tpu_torch.ops.estep import kdot
from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
from cuda_gmm_mpi_tpu_torch.state import stack_states

from .conftest import make_blobs
from .test_torch_kernels import CASES, case_inputs
from .test_torch_ops import make_state_np, to_jax

# float32 reassociation class, normwise (max |err| / max |ref|).
F32_NORM = {"loglik": 1e-5, "Nk": 1e-5, "M1": 1e-4, "M2": 1e-4}
BF16_NORM = 2e-2  # one bf16 pass against fp32: 2^-8 per operand
FIELDS = ("loglik", "Nk", "M1", "M2")


def normwise(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


def assert_norm(ours, theirs, tol):
    for name in FIELDS:
        err = normwise(getattr(ours, name).numpy(), getattr(theirs, name))
        limit = tol[name] if isinstance(tol, dict) else tol
        assert err <= limit, f"{name}: normwise {err:.2e} > {limit:.0e}"


@pytest.mark.parametrize("shape", [(64, 24, 100), (3, 17, 5, 9)],
                         ids=["matrix", "batched"])
def test_kdot_high_matches_jax_kdot(rng, shape):
    """kdot 'high' against the TPU kernels' manual bf16_3x ``_kdot``: the
    same three bf16 products, summed in another order (fp32 reassociation:
    normwise 1e-6). 'highest' is the plain product, float64 is never
    split, and 'default' is one pass over bf16-rounded operands, exactly."""
    *lead, m, k = shape[:-1]
    a = rng.normal(size=tuple(lead) + (m, k)).astype(np.float32)
    b = rng.normal(size=tuple(lead) + (k, shape[-1])).astype(np.float32)
    ours = kdot(torch.as_tensor(a), torch.as_tensor(b), "high").numpy()
    if lead:
        theirs = np.stack([np.asarray(_kdot(jnp.asarray(a[i]),
                                            jnp.asarray(b[i]), _NT, "high"))
                           for i in range(lead[0])])
    else:
        theirs = np.asarray(_kdot(jnp.asarray(a), jnp.asarray(b), _NT, "high"))
    assert normwise(ours, theirs) <= 1e-6
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert normwise(ours, exact) <= 2.0 ** -15  # bf16_3x, not one pass
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    assert torch.equal(kdot(ta, tb, "highest"), ta @ tb)
    assert torch.equal(kdot(ta.double(), tb.double(), "default"),
                       ta.double() @ tb.double())
    bf = lambda t: np.asarray(t, ml_dtypes.bfloat16).astype(np.float64)
    assert normwise(kdot(ta, tb, "default").numpy(), bf(a) @ bf(b)) <= 1e-6


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_stats_plain_high_matches_pallas(rng, case, diag):
    """K1's plain version at 'high' (fused_stats_cuda on CPU tensors)
    against fused_stats_pallas(interpret=True, precision='high')."""
    s, chunks, wts = case_inputs(rng, case, diag)
    ours = fs.fused_stats_cuda(state_from_numpy(s), torch.as_tensor(chunks),
                               torch.as_tensor(wts), diag_only=diag,
                               precision="high")
    pallas = fused_stats_pallas(to_jax(s), jnp.asarray(chunks),
                                jnp.asarray(wts), diag_only=diag, block_b=64,
                                interpret=True, precision="high")
    assert_norm(ours, pallas, F32_NORM)
    for i in CASES[case][4]:
        assert float(ours.Nk[i]) == 0.0


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_fused_stats_batched_plain_high_matches_pallas(rng, diag):
    """K3's plain version at 'high' against fused_stats_pallas_batched
    (interpret, 'high') on 3 lanes, lane 1 frozen by the lane mask."""
    states = [make_state_np(rng, 5, 4, np.float32, inactive=(r,), diag=diag)
              for r in range(3)]
    chunks = rng.normal(scale=2.0, size=(3, 64, 4)).astype(np.float32)
    wts = np.ones((3, 64), np.float32)
    wts[-1, 40:] = 0.0
    mask = np.array([True, False, True])
    ours = fs.fused_stats_cuda_batched(
        stack_states([state_from_numpy(s) for s in states]),
        torch.as_tensor(chunks), torch.as_tensor(wts),
        torch.as_tensor(mask), diag_only=diag, precision="high")
    theirs = fused_stats_pallas_batched(
        jax.tree.map(lambda *a: jnp.stack(a), *[to_jax(s) for s in states]),
        jnp.asarray(chunks),
        jnp.asarray(wts), lane_mask=jnp.asarray(mask), diag_only=diag,
        block_b=64, interpret=True, precision="high")
    for r in (0, 2):
        for name in FIELDS:
            err = normwise(getattr(ours, name)[r].numpy(),
                           np.asarray(getattr(theirs, name))[r])
            assert err <= F32_NORM[name], (r, name, err)
    for name in FIELDS:
        assert not getattr(ours, name)[1].any()


def _bf(a):
    """float32 values rounded to bfloat16 (nearest even), as float64."""
    return np.asarray(np.asarray(a, np.float32), ml_dtypes.bfloat16
                      ).astype(np.float64)


def default_reference(x, wt, A, h, g, diag):
    """K1's function in numpy float64 with each product's operands rounded
    to bf16 where the TPU kernel rounds them ('default'): x, the x2
    features (formed in float32, as the kernel forms them), A, h and w;
    the products' sums, the log-sum-exp and Nk in float64."""
    x = np.asarray(x, np.float32)
    if diag:
        x2 = x * x
    else:
        x2 = (x[:, :, None] * x[:, None, :]).reshape(len(x), -1)
    q = _bf(x2) @ _bf(A) - 2.0 * (_bf(x) @ _bf(h))
    logp = -0.5 * q + np.asarray(g, np.float64)
    m = np.maximum(logp.max(axis=1, keepdims=True), -1e30)
    e = np.exp(logp - m)
    s = e.sum(axis=1, keepdims=True)
    w8 = np.asarray(wt, np.float64)[:, None]
    w = e / s * w8
    return (((m + np.log(s)) * w8).sum(), w.sum(axis=0),
            _bf(w).T @ _bf(x), _bf(w).T @ _bf(x2))


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_stats_plain_default_two_ways(rng, case, diag):
    """K1's plain version at 'default': against the float64 evaluation with
    bf16-rounded operands (float32 reassociation class), and against JAX's
    'highest' Pallas kernel (interpret) in the bf16 class."""
    s, chunks, wts = case_inputs(rng, case, diag)
    state = state_from_numpy(s)
    x, wt = fs._prep_events(torch.as_tensor(chunks), torch.as_tensor(wts))
    A, h, g = fs._prep_params(state, x.shape[1], diag)
    ll, nk, m1, m2 = fs.fused_stats(x, wt, A, h, g, diag=diag,
                                    precision="default")
    ref = default_reference(x.numpy(), wt.numpy(), A.numpy(), h.numpy(),
                            g.numpy(), diag)
    for name, a, b in zip(FIELDS, (ll, nk, m1, m2), ref):
        err = normwise(a.numpy().reshape(np.shape(b)), b)
        assert err <= F32_NORM[name], f"{name}: {err:.2e}"
    highest = fused_stats_pallas(to_jax(s), jnp.asarray(chunks),
                                 jnp.asarray(wts), diag_only=diag,
                                 block_b=64, interpret=True)
    ours = fs.fused_stats_cuda(state, torch.as_tensor(chunks),
                               torch.as_tensor(wts), diag_only=diag,
                               precision="default")
    assert_norm(ours, highest, BF16_NORM)


def test_fit_high_matches_jax_pallas_high(tmp_path):
    """The slice as a whole: the port's fit_gmm at 'high' (torch ops, CPU)
    against the JAX fit_gmm on the Pallas kernels at 'high' (interpret): the
    same K and merge pairs (the JAX side's from its telemetry stream) and
    the final loglik within rtol 1e-4, the float32 fit class of the JAX
    package's own kernel-against-XLA fit (tests/test_pallas.py:182).

    Not 1e-5: a single 'high' E-step agrees to ~1e-7, but in a fit the
    M-step's covariance update (M2/N - mu mu^T) amplifies the bf16 split
    of w, whose low part moves in steps of 2^-17 where two float32
    evaluations of w differ in their last bits; over five seeds of this data
    two 'high' implementations (the torch ops and K1's plain version, each
    against the Pallas kernels) ended 7e-6 to 9.8e-5 apart, where
    'highest' ended within 1.6e-6."""
    data, _ = make_blobs(np.random.default_rng(11), n=384, d=3, k=3,
                         dtype=np.float32)
    kw = dict(min_iters=4, max_iters=4, chunk_size=128,
              matmul_precision="high")
    metrics = tmp_path / "jax.jsonl"
    jr = j_fit(data, 5, 2, config=JConfig(estep_backend="pallas",
                                          pallas_block_b=64,
                                          metrics_file=str(metrics), **kw))
    tr = fit_gmm(data, 5, 2, config=GMMConfig(device="cpu", **kw))
    assert tr.model.estep_backend == "torch"
    assert tr.ideal_num_clusters == jr.ideal_num_clusters
    jax_pairs = [tuple(r["pair"])
                 for r in map(json.loads, metrics.read_text().splitlines())
                 if r.get("event") == "merge"]
    assert [m[1] for m in tr.merges] == jax_pairs
    np.testing.assert_allclose(tr.final_loglik, jr.final_loglik, rtol=1e-4)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_precisions_run_on_main_and_restart_paths(precision):
    """No ValueError is left for 'high'/'default': the main path and the
    batched restart path run them on torch ops, and the config keeps the
    field."""
    data, _ = make_blobs(np.random.default_rng(3), n=300, d=3, k=3,
                         dtype=np.float32)
    cfg = functools.partial(GMMConfig, device="cpu", min_iters=2,
                            max_iters=2, chunk_size=128,
                            matmul_precision=precision)
    main = fit_gmm(data, 4, 2, config=cfg())
    restarts = fit_gmm(data, 4, 2, config=cfg(n_init=2,
                                              restart_batch_size=2))
    for r in (main, restarts):
        assert np.isfinite(r.final_loglik) and r.ideal_num_clusters == 2
