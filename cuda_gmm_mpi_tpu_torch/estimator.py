"""High-level estimator API: fit / predict / score / sample.

The port of the JAX package's ``estimator.py``: the reference's only "API"
is its ``.summary``/``.results`` file pair (``gaussian.cu:1171-1178``);
this module gives the same fits the scikit-learn surface. Every heavy path
is ``fit_gmm``, the serving executor (inference on one device) or the
fitted model's ``memberships`` (a mesh or streaming fit), so nothing here
adds numerics. Entry points run on ``config.device``, 'cuda' by default.
``to_registry``/``from_registry`` round-trip a fit through a serving model
registry in the JAX package's artifact format.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from .config import GMMConfig
from .models.gmm import GMMModel, chunk_events
from .models.order_search import GMMResult, fit_gmm


class GaussianMixture:
    """K-component Gaussian mixture fit by the port's EM engine.

    Parameters mirror the reference CLI (``num_clusters`` /
    ``target_num_clusters``, gaussian.cu:1111-1178) plus the runtime config.
    With ``target_components=0`` (default) the model-order search picks the
    best K in [1, n_components] under ``config.criterion``; pass
    ``target_components=n_components`` to fit a fixed K.

    Attributes after ``fit``:
      weights_      [K] mixture weights (pi)
      means_        [K, D] in original data coordinates
      covariances_  [K, D, D]
      n_components_ selected K (<= n_components when searching)
      rissanen_     best score under ``config.criterion``
      loglik_       total log-likelihood of the best model
      n_iter_       EM iterations at the selected K
      result_       the full GMMResult (sweep log, merges, ...)
    """

    def __init__(self, n_components: int, target_components: int = 0,
                 config: Optional[GMMConfig] = None,
                 means_init: Optional[np.ndarray] = None,
                 **config_overrides):
        if config is not None and config_overrides:
            raise ValueError("pass either config or field overrides, not both")
        self.n_components = n_components
        self.target_components = target_components
        self.config = config or GMMConfig(**config_overrides)
        # sklearn's means_init: [K, D] starting means in data coordinates,
        # replacing the seeding (covariances and weights still start from
        # the reference's seed recipe).
        self.means_init = means_init
        self.result_: Optional[GMMResult] = None
        self._model = None

    # -- fitting ----------------------------------------------------------

    def fit(self, X: np.ndarray, y=None, *,
            sample_weight: Optional[np.ndarray] = None) -> "GaussianMixture":
        """Fit; ``sample_weight`` ([N] nonnegative event multiplicities)
        weights every sufficient statistic (integer weights equal
        replicated rows). ``y`` is ignored (sklearn's convention; it warns,
        because a weight passed in its place would be dropped)."""
        if y is not None:
            warnings.warn(
                "fit() ignores y (unsupervised estimator); if you meant "
                "per-event weights, pass fit(X, sample_weight=...)",
                UserWarning, stacklevel=2)
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError(f"X must be [n_events, n_dims], got {X.shape}")
        self.result_ = fit_gmm(
            X, self.n_components, self.target_components, config=self.config,
            init_means=self.means_init, sample_weight=sample_weight)
        # Inference reuses the fitted model (a mesh fit's too).
        self._model = self.result_.model or GMMModel(self.config)
        return self

    def fit_predict(self, X: np.ndarray, y=None, *,
                    sample_weight: Optional[np.ndarray] = None) -> np.ndarray:
        """Fit and return the hard cluster assignment of X."""
        return self.fit(X, sample_weight=sample_weight).predict(X)

    # -- sklearn interop (clone(), pipelines, grid search) ---------------

    def get_params(self, deep: bool = True) -> dict:
        return {"n_components": self.n_components,
                "target_components": self.target_components,
                "config": self.config, "means_init": self.means_init}

    def set_params(self, **params) -> "GaussianMixture":
        known = ("n_components", "target_components", "config", "means_init")
        config_updates = {}
        for k, v in params.items():
            if k in known:
                setattr(self, k, v)
            elif hasattr(self.config, k):
                config_updates[k] = v  # config fields addressable directly
            else:
                raise ValueError(f"unknown parameter {k!r}")
        if config_updates:
            # diag_only and covariance_type are one coupled setting: the one
            # the caller set wins over the carried-over value of the other.
            if ("covariance_type" in config_updates
                    and "diag_only" not in config_updates):
                config_updates["diag_only"] = False
            elif ("diag_only" in config_updates
                    and "covariance_type" not in config_updates):
                cur = self.config.covariance_type
                if config_updates["diag_only"] and cur in ("full", "tied"):
                    config_updates["covariance_type"] = "diag"
                elif not config_updates["diag_only"] and cur in (
                        "diag", "spherical"):
                    config_updates["covariance_type"] = "full"
            self.config = dataclasses.replace(self.config, **config_updates)
        return self

    @classmethod
    def from_summary(cls, path: str, config: Optional[GMMConfig] = None,
                     **config_overrides) -> "GaussianMixture":
        """Rebuild a fitted estimator from a ``.summary`` model file (this
        package's, the JAX package's or the reference's own output). Means
        and covariances carry the format's 3 decimals, so predictions are
        close to, not equal to, the fitted model's. The config's covariance
        family must describe the file's covariances: a diag or spherical
        config refuses off-diagonal terms, spherical unequal variances
        within a cluster, tied clusters that differ."""
        from .io.readers import read_summary
        from .ops.constants import compute_constants
        from .state import GMMState

        m = read_summary(path)
        k, d = m["means"].shape
        if config is not None and config_overrides:
            raise ValueError("pass either config or field overrides, not both")
        config = config or GMMConfig(**config_overrides)
        if config.diag_only:
            offdiag = m["R"] - np.stack([np.diag(np.diag(r)) for r in m["R"]])
            if np.abs(offdiag).max() > 0:
                raise ValueError(
                    f"{path!r} holds full covariances (nonzero "
                    "off-diagonals) but the config requests "
                    f"covariance_type={config.covariance_type!r}; load "
                    "it without --diag-only/diag config")
        if config.covariance_type == "spherical":
            diags = np.stack([np.diag(r) for r in m["R"]])
            if np.abs(diags - diags[:, :1]).max() > 0:
                raise ValueError(
                    f"{path!r} holds non-spherical covariances (unequal "
                    "variances within a cluster) but the config requests "
                    "covariance_type='spherical'")
        if config.covariance_type == "tied" and k > 1:
            if np.abs(m["R"] - m["R"][:1]).max() > 0:
                raise ValueError(
                    f"{path!r} holds per-cluster covariances (clusters "
                    "differ) but the config requests "
                    "covariance_type='tied'")
        dtype = getattr(torch, config.dtype)
        as_t = lambda a: torch.as_tensor(a, dtype=dtype)
        state = GMMState(
            N=as_t(m["N"]), pi=as_t(m["pi"]),
            constant=torch.zeros(k, dtype=dtype),
            avgvar=torch.zeros(k, dtype=dtype), means=as_t(m["means"]),
            R=as_t(m["R"]), Rinv=torch.eye(d, dtype=dtype).expand(k, d, d),
            active=torch.ones(k, dtype=torch.bool))
        # Rinv, constant and pi recomputed from R and N (the summary's pi
        # is printf-rounded; a 3-decimal R that rounded to non-PD resets to
        # the identity, as constants_kernel does).
        state = compute_constants(state, diag_only=config.diag_only)
        return cls._from_state(state, np.zeros((d,), np.float64), config)

    # -- serving registry round trip ---------------------------------------

    def to_registry(self, registry, name: str, *, version=None,
                    run_id=None) -> int:
        """Persist this fitted estimator into a serving model registry.

        ``registry`` is a :class:`~cuda_gmm_mpi_tpu_torch.serving.
        ModelRegistry` or a root directory path. Unlike the 3-decimal
        ``.summary`` format, the artifact stores the exact state leaves,
        so a model re-hydrated via :meth:`from_registry` (or served by
        ``gmm serve``) scores bit-identically to this in-memory estimator.
        Returns the assigned version.
        """
        from .serving.registry import ModelRegistry

        if not isinstance(registry, ModelRegistry):
            registry = ModelRegistry(registry)
        return registry.save(name, self._fitted, config=self.config,
                             run_id=run_id, version=version)

    @classmethod
    def from_registry(cls, registry, name: str, version=None,
                      config: Optional[GMMConfig] = None
                      ) -> "GaussianMixture":
        """Rebuild a fitted estimator from a serving-registry artifact
        (exact round trip; the manifest supplies the dtype and covariance
        family, ``config`` the rest -- its device above all, 'cuda' by
        default, as in :meth:`from_summary`)."""
        from .serving.registry import ModelRegistry

        if not isinstance(registry, ModelRegistry):
            registry = ModelRegistry(registry)
        m = registry.load(name, version)
        config = dataclasses.replace(
            config or GMMConfig(), dtype=m.dtype,
            covariance_type=m.covariance_type,
            diag_only=m.covariance_type in ("diag", "spherical"))
        gm = cls(m.k, target_components=m.k, config=config)
        score = m.manifest.get("score")
        loglik = m.manifest.get("loglik")
        gm.result_ = GMMResult(
            state=m.state, ideal_num_clusters=m.k,
            min_rissanen=float("nan") if score is None else float(score),
            final_loglik=float("nan") if loglik is None else float(loglik),
            epsilon=float("nan"),
            num_events=int(m.manifest.get("num_events", 0)),
            num_dimensions=m.d,
            data_shift=np.asarray(m.data_shift, np.float64))
        gm._model = GMMModel(config)
        return gm

    @classmethod
    def _from_state(cls, state, data_shift, config: GMMConfig
                    ) -> "GaussianMixture":
        """A fitted estimator of ``state`` (compacted: its K clusters
        active) and the fit's centering shift; its score and loglik are
        NaN, no fit having produced them."""
        k, d = state.means.shape
        gm = cls(k, target_components=k, config=config)
        gm.result_ = GMMResult(
            state=state, ideal_num_clusters=k, min_rissanen=float("nan"),
            final_loglik=float("nan"), epsilon=float("nan"), num_events=0,
            num_dimensions=d, data_shift=np.asarray(data_shift, np.float64))
        gm._model = GMMModel(config)
        return gm

    @property
    def _fitted(self) -> GMMResult:
        if self.result_ is None:
            raise RuntimeError("estimator is not fitted; call fit(X) first")
        return self.result_

    @property
    def n_iter_(self) -> int:
        """EM iterations run at the selected K (from the sweep log)."""
        res = self._fitted
        for row in res.sweep_log:
            if int(row[0]) == res.ideal_num_clusters:
                return int(row[3])
        return 0

    @property
    def weights_(self) -> np.ndarray:
        return self._fitted.weights

    @property
    def means_(self) -> np.ndarray:
        return self._fitted.means

    @property
    def covariances_(self) -> np.ndarray:
        return self._fitted.covariances

    @property
    def n_components_(self) -> int:
        return self._fitted.ideal_num_clusters

    @property
    def rissanen_(self) -> float:
        return self._fitted.min_rissanen

    @property
    def loglik_(self) -> float:
        return self._fitted.final_loglik

    # -- inference --------------------------------------------------------

    def _posteriors_and_evidence(self, X: np.ndarray):
        """(w [N, K], logZ [N]) for X under the fitted model.

        A fit on one device scores through the serving executor
        (serving/executor.py): one executable per (N-bucket, K-bucket, D),
        on the card a CUDA graph of S1, so calls with varying row counts
        reuse one program per pow2 bucket. A mesh or streaming fit keeps
        the fitted model's ``memberships``, chunk by chunk."""
        from .validation import validate_finite

        res = self._fitted
        dtype = np.dtype(self.config.dtype)
        X = np.asarray(X, dtype)
        validate_finite(X)
        X = X - res.data_shift[None, :].astype(dtype)
        if (getattr(self._model, "mesh", None) is None
                and not self.config.stream_events):
            from .serving.executor import executor_for_config

            w, logz = executor_for_config(self.config).infer(
                res.state, X, want="proba")
            # The executor pads K to its pow2 bucket; inactive pad slots
            # carry exactly-zero responsibility -- slice them off.
            return w[:, :res.state.num_clusters_padded], logz
        chunks, _ = chunk_events(X, self.config.chunk_size)
        w, logz = self._model.memberships(res.state.to(self._model.device),
                                          chunks, return_logz=True)
        n = X.shape[0]
        return w[:n], logz[:n]

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        """Posterior responsibilities [N, K] (the .results memberships,
        gaussian.cu:1042-1059)."""
        return self._posteriors_and_evidence(X)[0]

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Hard cluster assignment: argmax posterior per event."""
        return np.argmax(self.predict_proba(X), axis=1)

    def score_samples(self, X: np.ndarray) -> np.ndarray:
        """Per-event log evidence log p(x) (estep2's logZ,
        gaussian_kernel.cu:489-495)."""
        return self._posteriors_and_evidence(X)[1]

    def score(self, X: np.ndarray) -> float:
        """Mean per-event log-likelihood."""
        return float(np.mean(self.score_samples(X)))

    def _criterion_on(self, X: np.ndarray, criterion: str) -> float:
        from .ops.formulas import model_score

        n = np.asarray(X).shape[0]
        ll = float(np.sum(self.score_samples(X)))
        return float(model_score(
            ll, self.n_components_, n, self._fitted.num_dimensions,
            criterion=criterion, covariance_type=self.config.covariance_type))

    def bic(self, X: np.ndarray) -> float:
        """Bayesian information criterion on X (lower is better), with the
        family's free parameters (``ops.formulas.model_score``)."""
        return self._criterion_on(X, "bic")

    def aic(self, X: np.ndarray) -> float:
        """Akaike information criterion on X (lower is better)."""
        return self._criterion_on(X, "aic")

    def sample(self, n_samples: int, seed: Optional[int] = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """Draw events from the fitted mixture: ``(X, y)``, samples and
        their component labels, as sklearn's ``GaussianMixture.sample``
        returns them; ``seed`` (default ``config.seed``) seeds a numpy
        generator, so the same parameters give the JAX package's draws. X
        is cast to ``config.dtype``."""
        rng = np.random.default_rng(self.config.seed if seed is None else seed)
        pi = np.asarray(self.weights_, np.float64)
        pi = pi / pi.sum()
        comps = rng.choice(len(pi), size=n_samples, p=pi)
        mu = np.asarray(self.means_, np.float64)
        cov = np.asarray(self.covariances_, np.float64)
        out = np.empty((n_samples, mu.shape[1]), np.float64)
        for c in range(len(pi)):
            m = comps == c
            if m.any():
                out[m] = rng.multivariate_normal(mu[c], cov[c],
                                                 size=int(m.sum()))
        return out.astype(np.dtype(self.config.dtype)), comps
