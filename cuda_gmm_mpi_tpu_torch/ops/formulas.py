"""Scalar formulas: convergence epsilon and the Rissanen/MDL score.

Straight functional ports of the reference's two closed-form expressions:

  epsilon  = (1 + D + 0.5*(D+1)*D) * ln(N*D) * 0.01      (gaussian.cu:458)
  rissanen = -loglik
             + 0.5 * (K*(1 + D + 0.5*(D+1)*D) - 1) * ln(N*D)   (gaussian.cu:826)

The inner factor is the per-cluster free-parameter count (1 weight + D mean
components + D(D+1)/2 covariance entries).
"""

from __future__ import annotations

import math


def free_params_per_cluster(num_dimensions: int,
                            diag_only: bool = False) -> float:
    d = num_dimensions
    cov = float(d) if diag_only else 0.5 * (d + 1) * d
    return 1.0 + d + cov


def n_free_params(num_clusters, num_dimensions: int,
                  diag_only: bool = False,
                  covariance_type: str | None = None):
    """Total free parameters of a K-component model: K per-cluster counts
    minus the weight-simplex constraint (the ``-1`` in gaussian.cu:826).

    Note: the reference's Rissanen formula always uses the FULL-covariance
    per-cluster count, even in its DIAG_ONLY build -- ``rissanen_score``
    reproduces that; information-criterion APIs that should count what the
    model actually estimates pass ``diag_only`` / ``covariance_type``
    ('spherical' = one variance per cluster; 'tied' = one shared D(D+1)/2
    covariance across clusters).
    """
    k, d = num_clusters, num_dimensions
    if covariance_type is None:
        covariance_type = "diag" if diag_only else "full"
    if covariance_type == "tied":
        return k * (1.0 + d) + 0.5 * (d + 1) * d - 1.0
    cov = {"full": 0.5 * (d + 1) * d, "diag": float(d),
           "spherical": 1.0}[covariance_type]
    return k * (1.0 + d + cov) - 1.0


def convergence_epsilon(
    num_events: int, num_dimensions: int, scale: float = 0.01
) -> float:
    return (
        free_params_per_cluster(num_dimensions)
        * math.log(float(num_events) * num_dimensions)
        * scale
    )


def rissanen_score(
    loglik: float, num_clusters: int, num_events: int, num_dimensions: int
) -> float:
    # Always the full-covariance parameter count (reference behavior even
    # under DIAG_ONLY; see n_free_params).
    return -loglik + 0.5 * n_free_params(
        num_clusters, num_dimensions
    ) * math.log(float(num_events) * num_dimensions)


def model_score(
    loglik,
    num_clusters,
    num_events: int,
    num_dimensions: int,
    criterion: str = "rissanen",
    covariance_type: str | None = None,
):
    """Order-selection score for one K (lower is better).

    'rissanen' is the reference's MDL formula exactly (gaussian.cu:826,
    full-covariance parameter count even under DIAG_ONLY). 'bic'
    (-2 loglik + p ln N), 'aic' (-2 loglik + 2p), and 'aicc' (AIC with the
    Hurvich-Tsai small-sample correction) are upgrades that count the
    parameters the model actually estimates (family-aware via
    ``covariance_type``) and use the conventional sample count N rather
    than the reference's N*D.
    """
    if criterion == "rissanen":
        return rissanen_score(loglik, num_clusters, num_events,
                              num_dimensions)
    p = n_free_params(num_clusters, num_dimensions,
                      covariance_type=covariance_type)
    if criterion == "bic":
        return -2.0 * loglik + p * math.log(float(num_events))
    if criterion == "aic":
        return -2.0 * loglik + 2.0 * p
    if criterion == "aicc":
        # Small-sample correction (Hurvich & Tsai); diverges as p -> n-1,
        # which is the correct behavior (such models are unsupportable).
        # max(d0, 0)+eps spelled branch-free via abs().
        n = float(num_events)
        d0 = n - p - 1.0
        denom = 0.5 * (d0 + abs(d0)) + 1e-12
        return -2.0 * loglik + 2.0 * p + 2.0 * p * (p + 1.0) / denom
    raise ValueError(f"unknown criterion: {criterion!r}")
