"""The accuracy case of K1's 3xTF32 products, emulated in numpy on the CPU.

K1's kernel (csrc/fused_stats.cu, shared by K3, K5 and K6) forms its
phase-3 product, the statistics w^T [x2 | x | 1], on the tensor cores with
``mma.sync.m16n8k8`` in TF32. Each operand value v is split as it is
loaded, big = tf32(v) and small = tf32(v - big) (round to nearest, ties
away from zero, to 10 mantissa bits), and every 8-deep step issues
small_a*big_b, then big_a*small_b, then big_a*big_b into a partial that
starts from zero; the partial is added to the fp32 sum outside the tensor
cores, rounding to nearest.

An mma.sync step does not round to nearest. On an H100 (the card test
``test_tensor_core_fp32_sum_rounding`` in tests/test_torch_cuda.py) its
products are exact, the terms are aligned to the largest with 2 guard
bits below the 24-bit significand (lower bits truncated toward zero), and
the sum is truncated toward zero to 24 bits. :func:`mma_sum` repeats that.
On the kernel's operands at D = 24, K = 100, on blobs near the global mean
(|x| ~ 30) and far from it (|x| ~ 170), full and diagonal:

- phase 3 as the kernel runs it is within twice the plain fp32 product's
  normwise error against float64 (floored at 2^-23, the bar chip_smoke.py
  holds K1 to on the card), and one TF32 pass is not;
- phase 1 (logp against A_ext = [A packed; -2h]) cannot go the same way:
  one pass misses the bar, and three passes, even with the same partials,
  bias the loglik of far blobs several times past it. That is why the
  kernel keeps phase 1 on the fp32 FMA units. The emulation reproduces,
  within 10%, the loglik errors that the card test of far blobs measured
  for two versions of the kernel that had logp on the tensor cores.
"""

import functools

import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu_torch.ops.kernels.fused_stats import _ext_operands

D, K = 24, 100
BT = 256  # K1's event tile at K_pad = 128
FP32_EPS = 2.0 ** -23
GUARD_BITS = 2
SPREAD = {"near": 10.0, "far": 60.0}  # blob centres uniform in +-spread


def tf32(v: np.ndarray) -> np.ndarray:
    """float32 -> the nearest TF32 value (cvt.rna.tf32.f32: ties away from
    zero), still stored as float32 with the low 13 mantissa bits zero."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(v: np.ndarray):
    big = tf32(v)
    return big, tf32(v - big)


def mma_sum(a8: np.ndarray, b8: np.ndarray, c: np.ndarray) -> np.ndarray:
    """One m16n8k8 step as the tensor cores compute it: a8 [M, 8] @ b8
    [8, N] + c [M, N] (TF32 / fp32 values in float64), each product exact,
    every term truncated toward zero to GUARD_BITS below the largest term's
    24-bit significand, the exact sum of those truncated toward zero to 24
    bits."""
    terms = np.concatenate([a8[:, None, :] * b8.T[None, :, :], c[:, :, None]],
                           axis=2)
    _, e = np.frexp(np.abs(terms))
    e_max = np.where(terms == 0, -2000, e).max(axis=2, keepdims=True)
    lsb = np.ldexp(1.0, np.maximum(e_max, -1000) - 24 - GUARD_BITS)
    s = (np.trunc(terms / lsb) * lsb).sum(axis=2)
    _, e = np.frexp(s)
    ulp = np.ldexp(1.0, e - 24)
    return np.where(s == 0, 0.0, np.trunc(s / ulp) * ulp)


def tc_product(a: np.ndarray, b: np.ndarray, passes: str,
               partials: bool = True) -> np.ndarray:
    """a [M, C] @ b [C, N] (float32) as the kernel's tensor-core stage:
    per 8-deep step the passes ("3x": small*big, big*small, big*big; "1x":
    big*big) go into a partial that starts from zero, and the partial is
    added to the float32 sum, rounding to nearest. ``partials=False`` keeps
    the whole sum in the tensor cores' accumulators instead."""
    c = a.shape[1]
    pad = -c % 8
    a = np.pad(a, ((0, 0), (0, pad)))
    b = np.pad(b, ((0, pad), (0, 0)))
    a_big, a_small = (t.astype(np.float64) for t in split(a))
    b_big, b_small = (t.astype(np.float64) for t in split(b))
    terms = ([(a_small, b_big), (a_big, b_small), (a_big, b_big)]
             if passes == "3x" else [(a_big, b_big)])
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, c + pad, 8):
        part = np.zeros(acc.shape) if partials else acc.astype(np.float64)
        for x, y in terms:
            part = mma_sum(x[:, k:k + 8], y[k:k + 8], part)
        acc = ((acc.astype(np.float64) + part) if partials else part).astype(np.float32)
    return acc


def stats_product(w_t: np.ndarray, aug: np.ndarray, passes: str) -> np.ndarray:
    """Phase 3 at N <= 132 * BT events: one tile per CTA, each tile's
    [K, T+D+1] sums from zero on the tensor cores, the CTAs' sums in
    float64 in index order, the result rounded to float32."""
    total = np.zeros((w_t.shape[0], aug.shape[1]), np.float64)
    for t0 in range(0, w_t.shape[1], BT):
        total += tc_product(w_t[:, t0:t0 + BT], aug[t0:t0 + BT], passes)
    return total.astype(np.float32)


@functools.lru_cache(maxsize=None)
def problem(blob: str, diag: bool, n: int):
    """Centred float32 events of K blobs, the kernel's phase-1 operands
    (features [x2 packed | x], A_ext) and g, from a state whose
    covariances fit the blobs."""
    rng = np.random.default_rng(0)
    centres = rng.uniform(-SPREAD[blob], SPREAD[blob], size=(K, D))
    scales = rng.uniform(0.5, 1.5, size=K)
    labels = rng.integers(0, K, n)
    x = centres[labels] + rng.normal(size=(n, D)) * scales[labels, None]
    mean = x.mean(axis=0)
    x, centres = (x - mean).astype(np.float32), centres - mean
    a = rng.normal(size=(K, D, D)) * 0.2
    cov = (a @ np.transpose(a, (0, 2, 1)) + np.eye(D)) * scales[:, None, None] ** 2
    if diag:
        cov = np.stack([np.diag(np.diag(c)) for c in cov])
    rinv = np.linalg.inv(cov).astype(np.float32)
    mu = centres.astype(np.float32)
    if diag:
        A = np.diagonal(rinv, axis1=1, axis2=2)
        h = A * mu
    else:
        A = rinv.reshape(K, D * D)
        h = np.einsum("kde,ke->kd", rinv, mu)
    g = -0.5 * (h * mu).sum(axis=1) - 0.5 * np.linalg.slogdet(cov)[1]
    a_ext, _, _ = _ext_operands(torch.as_tensor(A.T.copy()),
                                torch.as_tensor(h.T.copy()),
                                torch.as_tensor(g[None, :], dtype=torch.float32),
                                D, diag)
    if diag:
        x2 = x * x
    else:
        i, j = np.triu_indices(D)
        x2 = x[:, i] * x[:, j]
    return np.concatenate([x2, x], axis=1), a_ext[:, :K].numpy(), g


def normwise(p: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(p.astype(np.float64) - ref).max() / np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def errors(phase: str, blob: str, diag: bool):
    """Normwise errors against float64 of the plain fp32 product and of
    the 3- and 1-pass tensor-core products, on 1,024 events."""
    feats, a_ext, g = problem(blob, diag, 1024)
    if phase == "logp":
        a, b, product = feats, a_ext, tc_product
    else:
        logp = -0.5 * (feats.astype(np.float64) @ a_ext.astype(np.float64)) + g
        w = np.exp(logp - logp.max(axis=1, keepdims=True))
        w = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
        ones = np.ones((feats.shape[0], 1), np.float32)
        a = np.ascontiguousarray(w.T)
        b = np.concatenate([feats, ones], axis=1)
        product = stats_product
    ref = a.astype(np.float64) @ b.astype(np.float64)
    return {"plain": normwise(a @ b, ref), "3x": normwise(product(a, b, "3x"), ref),
            "1x": normwise(product(a, b, "1x"), ref)}


def bar(plain: float) -> float:
    return 2.0 * max(plain, FP32_EPS)


BLOBS = pytest.mark.parametrize(
    "blob,diag", [(b, d) for b in ("near", "far") for d in (False, True)],
    ids=lambda v: {False: "full", True: "diag"}.get(v, v))


def test_tf32_split_is_exact_to_22_bits():
    rng = np.random.default_rng(2)
    v = (rng.normal(size=10000) * 10.0 ** rng.uniform(-6, 6, 10000)).astype(np.float32)
    big, small = split(v)
    assert not (big.view(np.uint32) & 0x1FFF).any()
    assert not (small.view(np.uint32) & 0x1FFF).any()
    assert np.all(np.abs(v - big) <= np.abs(v) * 2.0 ** -11)
    rest = np.abs(v.astype(np.float64) - big.astype(np.float64) - small)
    assert np.all(rest <= np.abs(v) * 2.0 ** -21)
    # Ties round away from zero, as cvt.rna does.
    tie = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], np.float32)
    np.testing.assert_array_equal(tf32(tie), [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)])


# (row of A, C) -> the sum an H100 returns, with B's column all ones; the
# same cases as the card test. u is the ulp of 1.
U = 2.0 ** -23
PROBED = [
    ([1.0, 0.75 * U], 0.0, 1.0),                         # 1 + 0.75u: truncated
    ([-1.0] + [-0.25 * U] * 7, 0.0, -(1.0 + U)),         # toward zero, both signs
    ([1.0] + [0.125 * U] * 7, 0.0, 1.0),                 # below the guard bits
    ([0.25 * U] * 8, 1.0, 1.0 + 2.0 * U),                # within them: exact
    ([3.0, -0.25 * U], 0.0, 3.0),                        # a dropped negative term
    ([0.75 * U], -1.0, -1.0 + 1.0 * U),                  # -1 + 0.75u: toward zero
]


@pytest.mark.parametrize("row,c,expected", PROBED)
def test_mma_sum_matches_the_card(row, c, expected):
    a = np.zeros((1, 8))
    a[0, :len(row)] = row
    got = mma_sum(a, np.ones((8, 1)), np.array([[c]]))
    assert got[0, 0] == expected


@BLOBS
def test_three_tf32_passes_keep_fp32_accuracy_in_the_statistics(blob, diag):
    e = errors("stats", blob, diag)
    assert e["3x"] <= bar(e["plain"]), e


@pytest.mark.parametrize("phase", ["logp", "stats"])
@BLOBS
def test_one_tf32_pass_misses_the_fp32_bar(phase, blob, diag):
    e = errors(phase, blob, diag)
    assert e["1x"] > bar(e["plain"]), e


def test_logp_on_tensor_cores_misses_the_bar_far_from_the_mean():
    """Phase 1 on the tensor cores, three passes with the same partials:
    on far blobs (diag, 4,096 events) the truncated sums bias every logp
    the same way, and the loglik lands far outside twice the plain fp32
    product's error, where the fp32 FMA units stay inside it."""
    feats, a_ext, g = problem("far", True, 4096)

    def loglik(q):
        logp = -0.5 * q.astype(np.float64) + g
        m = logp.max(axis=1)
        return (m + np.log(np.exp(logp - m[:, None]).sum(axis=1))).sum()

    ref = loglik(feats.astype(np.float64) @ a_ext.astype(np.float64))
    plain = abs(loglik(feats @ a_ext) - ref) / abs(ref)
    tc = abs(loglik(tc_product(feats, a_ext, "3x")) - ref) / abs(ref)
    assert tc > 4.0 * bar(plain), (tc, plain)


@pytest.mark.parametrize("partials,card", [(False, 8.604e-06), (True, 2.212e-06)],
                         ids=["inside", "partials"])
def test_emulation_reproduces_the_card_far_case(partials, card):
    """The far-blob diag case of tests/test_torch_cuda.py (20,000 events)
    with logp on the tensor cores, the loglik's normwise error against
    float64 as that card test measured it on an H100 for two versions of
    the kernel: the sums kept inside the tensor cores, and the per-step
    partials added outside. The emulation lands within 10% of both."""
    from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    from .test_torch_cuda import _far_state

    rng = np.random.default_rng(17)
    n, d, k = 20000, 24, 100
    s = [_far_state(rng, k, d, True) for _ in range(2)][0]
    x = (s["means"][rng.integers(0, k, n)] + rng.normal(size=(n, d))).astype(np.float32)
    A, h, g = fs._prep_params(state_from_numpy(s, device=torch.device("cpu")), d, True)
    a_ext, g_pad, _ = _ext_operands(A, h, g, d, True)
    a_ext, g = a_ext[:, :k].numpy(), g_pad[:k].numpy().astype(np.float64)
    feats = np.concatenate([x * x, x], axis=1)

    def loglik(q):
        logp = -0.5 * q.astype(np.float64) + g
        m = logp.max(axis=1)
        return (m + np.log(np.exp(logp - m[:, None]).sum(axis=1))).sum()

    ref = loglik(feats.astype(np.float64) @ a_ext.astype(np.float64))
    q = np.concatenate([tc_product(feats[i:i + 2000], a_ext, "3x", partials)
                        for i in range(0, n, 2000)])
    err = abs(loglik(q) - ref) / abs(ref)
    assert abs(err / card - 1.0) < 0.1, (err, card)
