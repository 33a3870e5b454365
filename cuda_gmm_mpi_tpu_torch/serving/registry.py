"""Model registry: versioned persistence of fitted mixtures for serving.

The reference is fit-and-exit -- its only artifact is the printf-rounded
``.summary``/``.results`` pair (gaussian.cu:1180-1197), which loses 3
decimals of every parameter and is never read back by the reference
itself. The registry closes that gap for the serving path: a fitted
mixture is persisted as a versioned artifact holding the EXACT
:class:`~cuda_gmm_mpi_tpu_torch.state.GMMState` leaves (the atomic-npz format
shared with ``utils/checkpoint.py`` -- ``flatten_tree`` /
``write_npz_atomic`` / ``load_npz_tree``), so a re-hydrated model scores
bit-identically to the in-memory estimator it came from.

Layout (``<root>`` is the registry directory)::

    <root>/<name>/<version>/model.npz       # state leaves + data_shift
    <root>/<name>/<version>/manifest.json   # identity card (below)
    <root>/<name>/<version>/stage.candidate # marker: NOT live (lifecycle)
    <root>/<name>/<version>/quarantine.json # marker: rolled back / rejected

Versions are positive integers assigned monotonically per name;
``load(name)`` resolves the newest READABLE version (the checkpoint
walk-back semantics: a version torn by a crash warns and falls back to
the previous one instead of wedging the server; every version unreadable
raises :class:`RegistryError` with the aggregated failures). An
explicitly requested version never falls back -- a torn or mismatched
artifact is a loud :class:`RegistryError`.

The manifest records what the executor and the request router need
without opening the npz: K (active clusters), D, covariance_type, dtype,
the training run id, the final loglik, and -- for sweep-checkpoint
exports -- the model-order criterion and best score, so "which K won and
under which score" survives into serving (``gmm export``).

Staged versions (lifecycle, rev v2.6): a version saved with
``stage='candidate'`` carries a ``stage: candidate`` manifest stanza AND
a ``stage.candidate`` marker file, written BEFORE the npz so the version
is never transiently visible. Enumeration (:meth:`versions`,
:meth:`models`), the hot-reload poll (:meth:`latest_fingerprint` /
:meth:`poll`), and default :meth:`load` all skip marked versions --
candidates are invisible to every pre-lifecycle consumer -- while an
explicitly versioned ``load(name, v)`` still opens them (the canary
scorer's path). :meth:`promote` flips the stanza to ``stage: live``
first, then removes the marker: the marker is authoritative for
visibility, so a crash between the two steps (``promote_torn``) leaves
the candidate invisible and the flip retryable. :meth:`quarantine`
re-adds the marker plus a ``quarantine.json`` reason file;
:meth:`rollback` re-publishes a pinned prior version's exact leaves as
the newest live version (bit-identical scoring by the npz round-trip).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..state import GMMState
from ..utils.checkpoint import flatten_tree, load_npz_tree, write_npz_atomic

MODEL_FILE = "model.npz"
MANIFEST_FILE = "manifest.json"
# Training drift envelope (stream rev v2.4; telemetry/sketch.py): the
# fit data's score sketch + responsibility occupancy, persisted NEXT TO
# the model artifact. Optional by contract -- versions predating it (or
# fits that skipped the envelope pass) load fine without one, and `gmm
# drift --rebuild-envelope` can backfill it atomically without touching
# model.npz/manifest.json bit-identity.
ENVELOPE_FILE = "envelope.json"
# Lifecycle staging markers (rev v2.6). CANDIDATE_MARKER's PRESENCE is
# what enumeration skips -- a pure stat() check, so the hot-reload
# poll's "polling every few seconds is free" contract survives staging.
# QUARANTINE_FILE records WHY a version was pulled (rollback reason,
# failed canary gates); a quarantined version keeps the candidate
# marker so it can never be promoted or served again.
CANDIDATE_MARKER = "stage.candidate"
QUARANTINE_FILE = "quarantine.json"
MANIFEST_SCHEMA = 1

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


class RegistryError(RuntimeError):
    """A registry artifact is missing, torn, or self-inconsistent.

    Raised loudly at save/load/export time -- a manifest whose K/D/dtype
    disagrees with the stored arrays must never be served quietly under
    the wrong densities (the same contract ``GaussianMixture.from_summary``
    enforces for the text format).
    """


@dataclasses.dataclass
class ServedModel:
    """One re-hydrated registry artifact, ready for the executor.

    ``state`` holds the exact fitted parameters (centered coordinates);
    ``data_shift`` is the fit-time centering shift that request data must
    be shifted by before scoring (``GMMResult.data_shift`` semantics).
    """

    name: str
    version: int
    state: GMMState
    data_shift: np.ndarray  # [D] float64
    manifest: Dict[str, Any]
    # Training drift envelope (envelope.json; rev v2.4) -- None for
    # versions that carry none. The server's drift plane compares
    # serve-time score/occupancy windows against it.
    envelope: Optional[Dict[str, Any]] = None

    @property
    def k(self) -> int:
        return int(self.manifest["k"])

    @property
    def d(self) -> int:
        return int(self.manifest["d"])

    @property
    def dtype(self) -> str:
        return str(self.manifest["dtype"])

    @property
    def covariance_type(self) -> str:
        return str(self.manifest["covariance_type"])

    @property
    def diag_only(self) -> bool:
        return self.covariance_type in ("diag", "spherical")


class ModelRegistry:
    """Versioned model store rooted at one directory."""

    def __init__(self, root: str):
        self._root = os.path.abspath(root)
        os.makedirs(self._root, exist_ok=True)

    @property
    def root(self) -> str:
        return self._root

    # -- enumeration -----------------------------------------------------

    def models(self) -> List[str]:
        """Registered model names (sorted).

        Names whose only versions are candidates are NOT listed --
        un-promoted lifecycle output is invisible here just as it is to
        the poll. A registry root deleted out from under a live server
        degrades to an empty listing (the tick loop's ``maybe_reload``
        must keep serving prepared state, not crash on a stat race).
        """
        try:
            entries = sorted(os.listdir(self._root))
        except OSError:
            return []
        out = []
        for name in entries:
            if _NAME_RE.match(name) and self.versions(name):
                out.append(name)
        return out

    def versions(self, name: str,
                 include_candidates: bool = False) -> List[int]:
        """Existing LIVE versions of ``name`` (ascending; [] when
        unknown). ``include_candidates=True`` adds versions still
        carrying the ``stage.candidate`` marker (lifecycle canaries and
        quarantined versions)."""
        d = os.path.join(self._root, self._check_name(name))
        try:
            entries = os.listdir(d)
        except OSError:
            return []
        return sorted(
            int(v) for v in entries
            if v.isdigit()
            and os.path.isfile(os.path.join(d, v, MODEL_FILE))
            and (include_candidates
                 or not os.path.exists(os.path.join(d, v,
                                                    CANDIDATE_MARKER))))

    def _check_name(self, name: str) -> str:
        if not _NAME_RE.match(name or ""):
            raise RegistryError(
                f"invalid model name {name!r} (letters, digits, '.', '_', "
                "'-' only; must not start with a separator)")
        return name

    # -- hot-reload polling ----------------------------------------------

    def latest_fingerprint(self, name: str) -> Optional[Tuple[int, str]]:
        """(newest version, its manifest fingerprint) for ``name``;
        None when the model has no complete version.

        The fingerprint is the manifest's mtime_ns:size -- the manifest
        is written LAST in the atomic save protocol, so its stat changes
        exactly when a new version becomes complete. Versions are
        immutable, so a changed (version, fingerprint) pair is always a
        NEW version (or a re-rooted registry), never a mutated one.
        """
        versions = self.versions(name)
        if not versions:
            return None
        v = versions[-1]
        man = os.path.join(self._root, name, str(v), MANIFEST_FILE)
        try:
            st = os.stat(man)
            fp = f"{st.st_mtime_ns}:{st.st_size}"
        except OSError:
            fp = ""  # torn mid-write; the next poll re-stats
        return (v, fp)

    def poll(self, snapshot: Dict[str, Tuple[int, str]]
             ) -> Dict[str, Tuple[int, str]]:
        """Models whose newest version changed vs ``snapshot``.

        ``snapshot`` maps name -> (version, fingerprint) as previously
        returned by :meth:`latest_fingerprint`; the result carries only
        the CHANGED entries with their new pair. The server's hot-reload
        loop (serving/server.py ``maybe_reload``) is the caller: it
        swaps the ``version=None`` route of each changed model and
        updates its snapshot. Pure stat()s -- no artifact is opened, so
        polling every few seconds is free.
        """
        changed: Dict[str, Tuple[int, str]] = {}
        for name in set(snapshot) | set(self.models()):
            cur = self.latest_fingerprint(name)
            if cur is not None and cur != snapshot.get(name):
                changed[name] = cur
        return changed

    # -- save ------------------------------------------------------------

    def save(self, name: str, result, *, config=None,
             covariance_type: Optional[str] = None,
             criterion: Optional[str] = None,
             run_id: Optional[str] = None,
             version: Optional[int] = None,
             source: str = "fit",
             stage: Optional[str] = None,
             extra: Optional[Dict[str, Any]] = None) -> int:
        """Persist a fitted :class:`GMMResult` as ``name``'s next version.

        ``config`` (the fit's :class:`GMMConfig`) supplies the covariance
        family and criterion when the explicit kwargs are absent; the
        dtype is read off the state itself. Returns the version number.
        The write is atomic (npz first, manifest last): a version whose
        manifest exists is complete, and a crash mid-save leaves only an
        ignorable orphan. ``stage='candidate'`` publishes a lifecycle
        canary: invisible to enumeration/poll/default-load until
        :meth:`promote` flips it live.
        """
        if stage not in (None, "live", "candidate"):
            raise RegistryError(
                f"unknown stage {stage!r} (live or candidate)")
        state = result.state
        k = int(result.ideal_num_clusters)
        d = int(result.num_dimensions) or int(state.num_dimensions)
        if int(state.num_clusters_padded) != k:
            # Registry artifacts store the COMPACT state (every slot
            # active) so K in the manifest is the arrays' leading axis.
            from ..state import compact

            state, k = compact(state)
        cov = covariance_type or (config.covariance_type if config
                                  else "full")
        crit = criterion or (config.criterion if config else None)
        manifest = {
            "schema": MANIFEST_SCHEMA,
            "name": self._check_name(name),
            "k": k,
            "d": d,
            "covariance_type": cov,
            "dtype": _dtype_name(state),
            "loglik": _finite_or_none(result.final_loglik),
            "score": _finite_or_none(result.min_rissanen),
            "criterion": crit,
            "train_run_id": run_id,
            "num_events": int(getattr(result, "num_events", 0)),
            "source": source,
            "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime()),
        }
        if extra:
            manifest.update(extra)
        if stage == "candidate":
            manifest["stage"] = "candidate"
        envelope = getattr(result, "envelope", None)
        if envelope is not None:
            # Small identity stanza only; the full envelope rides its
            # own sidecar file (ENVELOPE_FILE).
            from ..telemetry.sketch import envelope_stanza

            manifest["envelope"] = envelope_stanza(envelope)
        return self._write_version(name, version, state,
                                   np.asarray(result.data_shift,
                                              np.float64), manifest,
                                   envelope=envelope, stage=stage)

    def _write_version(self, name: str, version: Optional[int],
                       state: GMMState, data_shift: np.ndarray,
                       manifest: Dict[str, Any],
                       envelope: Optional[Dict[str, Any]] = None,
                       stage: Optional[str] = None) -> int:
        name = self._check_name(name)
        # Candidates occupy version numbers too -- a promotion must not
        # collide with a version assigned while it was invisible.
        existing = self.versions(name, include_candidates=True)
        if version is None:
            version = (existing[-1] + 1) if existing else 1
        elif version in existing:
            raise RegistryError(
                f"{name!r} version {version} already exists; versions are "
                "immutable -- save a new one")
        elif version < 1:
            raise RegistryError("versions are positive integers")
        manifest = dict(manifest, version=int(version))
        vdir = os.path.join(self._root, name, str(version))
        os.makedirs(vdir, exist_ok=True)
        if stage == "candidate":
            # Marker FIRST: the version directory must never be visible
            # to enumeration between the npz landing and the stage
            # becoming known. versions() requires MODEL_FILE, so an
            # orphan marker alone hides nothing it shouldn't.
            with open(os.path.join(vdir, CANDIDATE_MARKER), "w",
                      encoding="utf-8") as f:
                f.write("candidate\n")
        flat = flatten_tree({"state": state,
                             "data_shift": data_shift})
        write_npz_atomic(vdir, os.path.join(vdir, MODEL_FILE), flat)
        if envelope is not None:
            # Envelope sidecar BEFORE the manifest: the manifest stays
            # the one commit record, so a crash here leaves an
            # ignorable orphan, never a committed version missing its
            # declared envelope.
            _write_json_atomic(os.path.join(vdir, ENVELOPE_FILE),
                               envelope)
        # Manifest last: its presence is the commit record.
        tmp = os.path.join(vdir, MANIFEST_FILE + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(vdir, MANIFEST_FILE))
        return int(version)

    # -- load ------------------------------------------------------------

    def load(self, name: str, version: Optional[int] = None) -> ServedModel:
        """Re-hydrate ``name`` at ``version`` (default: newest readable).

        Explicit versions fail loudly on ANY problem; the default
        resolution walks back over torn versions with a warning (the
        ``utils/checkpoint.py`` restore semantics -- losing one version
        beats wedging the server) and raises an aggregated
        :class:`RegistryError` only when every version is unreadable.
        Each walk-back step also emits a counted ``registry_torn``
        telemetry event (rev v2.6) -- a silent walk-back is exactly what
        a botched promotion looks like, so it must show up in
        ``gmm report``/``/metrics`` (``gmm_registry_torn_total``).

        Default resolution sees LIVE versions only; an explicit
        ``version`` may name a candidate (the canary scorer's path).
        """
        if version is not None:
            if version not in self.versions(name,
                                            include_candidates=True):
                raise RegistryError(
                    f"{name!r} has no version {version} "
                    f"(existing: {self.versions(name)})")
            return self._load_version(name, int(version))
        versions = self.versions(name)
        if not versions:
            raise RegistryError(
                f"unknown model {name!r} in registry {self._root!r} "
                f"(registered: {', '.join(self.models()) or 'none'})")
        failures: List[Tuple[int, BaseException]] = []
        for v in reversed(versions):
            try:
                return self._load_version(name, v)
            except Exception as e:
                failures.append((v, e))
                warnings.warn(
                    f"registry model {name!r} version {v} unreadable "
                    f"({type(e).__name__}: {e}); falling back to the "
                    "previous version", RuntimeWarning)
                from .. import telemetry

                rec = telemetry.current()
                if rec.active:
                    rec.emit("registry_torn", model=name, version=int(v),
                             error=f"{type(e).__name__}: {e}")
                    rec.metrics.count("registry_torn")
        raise RegistryError(
            f"every version of {name!r} is unreadable: "
            + "; ".join(f"v{v}: {type(e).__name__}: {e}"
                        for v, e in failures)) from failures[0][1]

    def _load_version(self, name: str, version: int) -> ServedModel:
        from ..testing import faults

        if faults.take("registry_torn", name=name,
                       version=version) is not None:
            # Deterministic stand-in for an artifact torn on disk: the
            # walk-back, breaker, and hot-reload paths rehearse against
            # it (docs/ROBUSTNESS.md "Serving").
            raise RegistryError(
                f"{name!r} v{version}: injected registry_torn fault")
        vdir = os.path.join(self._root, self._check_name(name),
                            str(version))
        man_path = os.path.join(vdir, MANIFEST_FILE)
        try:
            with open(man_path, encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise RegistryError(
                f"{name!r} v{version}: unreadable manifest: {e}") from e
        try:
            tree = load_npz_tree(os.path.join(vdir, MODEL_FILE),
                                 state_keys=("state",))
        except Exception as e:
            raise RegistryError(
                f"{name!r} v{version}: unreadable model artifact: "
                f"{e}") from e
        state = tree.get("state")
        if not isinstance(state, GMMState):
            raise RegistryError(
                f"{name!r} v{version}: artifact holds no state group")
        self._validate(name, version, manifest, state)
        shift = np.asarray(tree.get("data_shift",
                                    np.zeros((state.num_dimensions,))),
                           np.float64)
        # Envelope sidecar: optional by contract. Absent (pre-v2.4
        # versions, envelope-off fits) or unreadable -> None, never a
        # load failure -- drift observability must not break serving.
        envelope = None
        env_path = os.path.join(vdir, ENVELOPE_FILE)
        if os.path.isfile(env_path):
            try:
                with open(env_path, encoding="utf-8") as f:
                    envelope = json.load(f)
            except (OSError, ValueError) as e:
                warnings.warn(
                    f"registry model {name!r} v{version}: unreadable "
                    f"envelope.json ({e}); drift statistics unavailable "
                    "for this version", RuntimeWarning)
        return ServedModel(name=name, version=int(version), state=state,
                           data_shift=shift, manifest=manifest,
                           envelope=envelope)

    # -- drift envelopes -------------------------------------------------

    def load_envelope(self, name: str,
                      version: Optional[int] = None) -> Optional[dict]:
        """The training envelope of ``name``@``version`` (default:
        newest), or None when that version carries none."""
        return self.load(name, version).envelope

    def publish_envelope(self, name: str, version: int,
                         envelope: Dict[str, Any]) -> None:
        """Atomically (re)publish ``envelope.json`` for an EXISTING
        version -- the `gmm drift --rebuild-envelope` backfill path.

        Versions are immutable ARTIFACTS, not immutable directories:
        the envelope is observability metadata, so writing it must not
        (and does not) touch ``model.npz`` or ``manifest.json`` --
        their bytes, and therefore ``latest_fingerprint``'s
        mtime_ns:size commit record, stay bit-identical.
        """
        if version not in self.versions(self._check_name(name)):
            raise RegistryError(
                f"{name!r} has no version {version} "
                f"(existing: {self.versions(name)})")
        vdir = os.path.join(self._root, name, str(int(version)))
        _write_json_atomic(os.path.join(vdir, ENVELOPE_FILE), envelope)

    # -- lifecycle staging (rev v2.6) ------------------------------------

    def stage(self, name: str, version: int) -> str:
        """``'live'``, ``'candidate'``, or ``'quarantined'`` for an
        existing version (marker-file semantics; pure stat()s)."""
        vdir = os.path.join(self._root, self._check_name(name),
                            str(int(version)))
        if not os.path.isfile(os.path.join(vdir, MODEL_FILE)):
            raise RegistryError(
                f"{name!r} has no version {version} "
                f"(existing: {self.versions(name, include_candidates=True)})")
        if os.path.exists(os.path.join(vdir, QUARANTINE_FILE)):
            return "quarantined"
        if os.path.exists(os.path.join(vdir, CANDIDATE_MARKER)):
            return "candidate"
        return "live"

    def promote(self, name: str, version: int) -> None:
        """Atomically flip a candidate version live.

        Protocol: (1) rewrite the manifest with ``stage: live`` (tmp +
        fsync + rename -- this changes the manifest's mtime_ns:size, so
        once visible the version reads as NEW to every poll snapshot);
        (2) remove the candidate marker. The marker is authoritative for
        enumeration, so a crash between the steps -- the ``promote_torn``
        fault point -- leaves the candidate invisible and the promotion
        retryable; it can never publish a half-flipped version. The
        existing hot-reload path (``maybe_reload``) then does the actual
        route swap; breaker state deliberately carries over.
        """
        st = self.stage(name, version)
        if st == "quarantined":
            raise RegistryError(
                f"{name!r} v{version} is quarantined; it can never be "
                "promoted (see its quarantine.json)")
        if st == "live":
            raise RegistryError(f"{name!r} v{version} is already live")
        vdir = os.path.join(self._root, name, str(int(version)))
        man_path = os.path.join(vdir, MANIFEST_FILE)
        try:
            with open(man_path, encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise RegistryError(
                f"{name!r} v{version}: unreadable manifest: {e}") from e
        manifest["stage"] = "live"
        manifest["promoted_utc"] = time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        _write_json_atomic(man_path, manifest)
        from ..testing import faults

        if faults.take("promote_torn", name=name,
                       version=version) is not None:
            # Crash between the manifest flip and the marker removal:
            # the candidate stays invisible, the flip stays retryable.
            raise RegistryError(
                f"{name!r} v{version}: injected promote_torn fault "
                "(manifest flipped, marker still present)")
        os.remove(os.path.join(vdir, CANDIDATE_MARKER))

    def quarantine(self, name: str, version: int,
                   reason: Optional[Dict[str, Any]] = None) -> None:
        """Pull a version permanently: write a ``quarantine.json``
        reason file and (re)add the candidate marker so enumeration,
        the poll, and default load all skip it. Idempotent; works on
        candidates (failed canary) and on live versions (rollback of a
        bad promotion)."""
        vdir = os.path.join(self._root, self._check_name(name),
                            str(int(version)))
        if not os.path.isfile(os.path.join(vdir, MODEL_FILE)):
            raise RegistryError(
                f"{name!r} has no version {version} "
                f"(existing: {self.versions(name, include_candidates=True)})")
        marker = os.path.join(vdir, CANDIDATE_MARKER)
        if not os.path.exists(marker):
            with open(marker, "w", encoding="utf-8") as f:
                f.write("quarantined\n")
        _write_json_atomic(
            os.path.join(vdir, QUARANTINE_FILE),
            dict(reason or {}, name=name, version=int(version),
                 quarantined_utc=time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                               time.gmtime())))

    def rollback(self, name: str, *, to_version: int,
                 bad_version: Optional[int] = None,
                 reason: Optional[Dict[str, Any]] = None) -> int:
        """Restore a pinned prior version as the NEWEST live version.

        Versions are immutable, so rollback RE-PUBLISHES ``to_version``'s
        exact leaves under a fresh version number (the npz round-trip is
        bit-exact, so the restored model scores bit-identically to the
        pinned one); ``bad_version`` (the promotion being undone) is
        quarantined with ``reason``. Returns the new version number --
        the next poll sees it as newest and the hot-reload path swaps
        the route back.
        """
        src = self._load_version(self._check_name(name), int(to_version))
        manifest = {k: v for k, v in src.manifest.items()
                    if k not in ("version", "stage", "promoted_utc")}
        manifest.update(
            source="rollback",
            restored_version=int(to_version),
            rollback_of=(int(bad_version) if bad_version is not None
                         else None))
        new_v = self._write_version(name, None, src.state,
                                    src.data_shift, manifest,
                                    envelope=src.envelope)
        if bad_version is not None:
            self.quarantine(name, int(bad_version),
                            dict(reason or {},
                                 restored_as=int(new_v),
                                 restored_version=int(to_version)))
        return int(new_v)

    def _validate(self, name, version, manifest, state: GMMState) -> None:
        """The loud manifest-vs-arrays contract: serving a model whose
        identity card lies about its shapes/family would score every
        request under the wrong densities."""
        where = f"{name!r} v{version}"
        k = int(manifest.get("k", -1))
        d = int(manifest.get("d", -1))
        if state.num_clusters_padded != k or state.num_dimensions != d:
            raise RegistryError(
                f"{where}: manifest says K={k} D={d} but the stored state "
                f"is K={state.num_clusters_padded} "
                f"D={state.num_dimensions}")
        dtype = str(manifest.get("dtype"))
        actual = _dtype_name(state)
        if dtype != actual:
            raise RegistryError(
                f"{where}: manifest dtype {dtype!r} != stored {actual!r}")
        cov = manifest.get("covariance_type")
        if cov not in ("full", "diag", "spherical", "tied"):
            raise RegistryError(
                f"{where}: unknown covariance_type {cov!r}")
        if cov in ("diag", "spherical"):
            R = np.asarray(state.R)
            offdiag = R - np.stack([np.diag(np.diag(r)) for r in R])
            if np.abs(offdiag).max() > 0:
                raise RegistryError(
                    f"{where}: manifest says covariance_type={cov!r} but "
                    "the stored covariances carry nonzero off-diagonals")

    # -- export paths ----------------------------------------------------

    def export_result(self, name: str, result, **kw) -> int:
        """Alias of :meth:`save` (the library export entry point)."""
        return self.save(name, result, **kw)

    def export_checkpoint(self, checkpoint_dir: str, name: str, *,
                          version: Optional[int] = None,
                          run_id: Optional[str] = None,
                          device: str = "cuda") -> int:
        """Export the BEST-scoring model from an order-search sweep
        checkpoint directory.

        A sweep checkpoint's ``state`` is the in-flight K of the step it
        was taken at -- the LAST fitted K, usually not the winner.
        Export selects ``best_state`` (the best-criterion configuration
        so far, the ``saved_clusters`` analog) and records the score
        criterion, best score, and loglik in the manifest, so the served
        model is the one the sweep would have returned. Both the
        host-driven and fused-sweep checkpoint payloads are understood;
        a checkpoint predating the ``data_shift`` field exports with a
        zero shift and a loud warning (its fit may have centered data).
        The best state is compacted on ``device`` ('cuda', or 'cpu' when
        asked: without a GPU 'cuda' raises).
        """
        from ..models.order_search import (_COV_NAME, _CRITERION_NAME,
                                           GMMResult)
        from ..state import compact
        from ..utils.checkpoint import SweepCheckpointer

        sweep_dir = os.path.join(os.path.abspath(checkpoint_dir), "sweep")
        if not os.path.isdir(sweep_dir):
            raise RegistryError(
                f"{checkpoint_dir!r} holds no sweep checkpoints")
        restored = SweepCheckpointer(checkpoint_dir).restore()
        if restored is None:
            raise RegistryError(
                f"{checkpoint_dir!r} holds no restorable checkpoint step")
        from .executor import device_or_raise

        best = restored["best_state"].to(device_or_raise(device))
        if "fused_log" in restored:  # fused-sweep payload key names
            score = float(restored["best_riss"])
            loglik = float(restored["best_ll"])
        else:
            score = float(restored["min_rissanen"])
            loglik = float(restored["best_ll"])
        criterion = _CRITERION_NAME.get(
            int(restored.get("criterion_code", 0)), "rissanen")
        cov = _COV_NAME.get(int(restored.get("cov_code", 0)), "full")
        state, k_active = compact(best)
        if "data_shift" in restored:
            shift = np.asarray(restored["data_shift"], np.float64)
        else:
            shift = np.zeros((state.num_dimensions,), np.float64)
            warnings.warn(
                "checkpoint predates the data_shift field; exporting with "
                "a zero shift -- if the original fit centered its data "
                "(the default), served scores will be wrong. Re-fit or "
                "export from the .summary instead.", RuntimeWarning)
        result = GMMResult(
            state=state,
            ideal_num_clusters=k_active,
            min_rissanen=score,
            final_loglik=loglik,
            epsilon=float("nan"),
            num_events=0,
            num_dimensions=int(state.num_dimensions),
            data_shift=shift,
        )
        return self.save(
            name, result, covariance_type=cov, criterion=criterion,
            run_id=run_id, version=version, source="checkpoint",
            extra={"checkpoint_step": int(restored.get("step", -1)),
                   "checkpoint_dir": os.path.abspath(checkpoint_dir)})

    def export_fleet(self, fleet_dir: str, *,
                     version: Optional[int] = None,
                     device: str = "cuda") -> List[dict]:
        """Bulk export: one atomic version PER TENANT MODEL from a fleet
        fit's output directory (``gmm fleet --out-dir``).

        Reads ``<fleet_dir>/fleet.json`` and exports every fitted
        tenant's ``.summary`` under its tenant name. Partial failure is
        per tenant, never run-fatal: each row of the returned audit list
        carries either the assigned ``version`` or the ``error`` that
        skipped it (plus ``skipped: dropped`` rows for tenants the fleet
        itself dropped). Exact-state exports come from ``gmm fleet
        --registry`` in the fitting invocation; this path serves the
        decoupled fit-here-export-later workflow at the text format's
        precision.
        """
        manifest_path = os.path.join(os.path.abspath(fleet_dir),
                                     "fleet.json")
        try:
            with open(manifest_path, encoding="utf-8") as f:
                fleet = json.load(f)
        except (OSError, ValueError) as e:
            raise RegistryError(
                f"cannot read fleet manifest {manifest_path!r}: {e}"
            ) from e
        rows = fleet.get("tenants")
        if not isinstance(rows, list) or not rows:
            raise RegistryError(
                f"{manifest_path!r} lists no tenants")
        audit: List[dict] = []
        for row in rows:
            name = str(row.get("name"))
            if row.get("dropped"):
                audit.append({"name": name, "skipped": "dropped",
                              "error": row.get("error")})
                continue
            summary = row.get("summary")
            try:
                if not summary:
                    raise RegistryError(
                        "fleet.json row carries no summary path (was "
                        "the fleet run without --out-dir?)")
                v = self.export_summary(
                    summary, name,
                    covariance_type=row.get("covariance_type", "full"),
                    dtype=row.get("dtype", "float32"),
                    version=version, device=device)
                entry = {"name": name, "version": int(v)}
                env_path = row.get("envelope")
                if env_path:
                    # Republish the fleet fit's per-tenant training
                    # envelope next to the exported version (rev v2.4).
                    # Per-tenant containment applies here too: a torn
                    # envelope file degrades to an envelope-less
                    # version, it does not void the export.
                    try:
                        with open(env_path, encoding="utf-8") as f:
                            self.publish_envelope(name, v, json.load(f))
                        entry["envelope"] = True
                    except (OSError, ValueError) as e:
                        entry["envelope_error"] = str(e)
                audit.append(entry)
            except (RegistryError, OSError, ValueError) as e:
                # Per-tenant containment: one torn summary must not
                # void its siblings' exports.
                audit.append({"name": name, "error": str(e)})
        return audit

    def export_summary(self, summary_path: str, name: str, *,
                       covariance_type: str = "full",
                       dtype: str = "float32",
                       version: Optional[int] = None,
                       device: str = "cuda") -> int:
        """Export a ``.summary`` model file (ours or the reference's own).

        Carries the text format's 3-decimal precision -- exact
        persistence comes from exporting the in-memory fit
        (:meth:`save`); this path exists so reference-produced models can
        be served too. Constants/Rinv are recomputed coherently from R
        (``from_summary`` semantics).
        """
        from ..config import GMMConfig
        from ..estimator import GaussianMixture

        gm = GaussianMixture.from_summary(
            summary_path, config=GMMConfig(dtype=dtype,
                                           covariance_type=covariance_type,
                                           device=device))
        return self.save(
            name, gm.result_, covariance_type=gm.config.covariance_type,
            version=version, source="summary",
            extra={"summary_path": os.path.abspath(summary_path)})


def _dtype_name(state: GMMState) -> str:
    """The numpy name of the state's dtype ('float32', 'float64')."""
    return str(state.N.dtype).replace("torch.", "")


def _finite_or_none(x) -> Optional[float]:
    x = float(x)
    return x if np.isfinite(x) else None


def _write_json_atomic(path: str, obj: Any) -> None:
    """tmp + fsync + rename in the artifact's own directory (the
    manifest write discipline, shared by the envelope sidecar)."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def export_main(argv=None) -> int:
    """``gmm export``: persist a model into a serving registry.

    Sources (exactly one): ``--checkpoint DIR`` (an order-search sweep
    checkpoint directory -- exports the best-scoring K, not the last
    step) or ``--summary FILE.summary`` (the text model format, 3-decimal
    precision).
    """
    import argparse

    p = argparse.ArgumentParser(
        prog="gmm export",
        description="Export a fitted model into a serving registry "
        "(docs/SERVING.md); --fleet bulk-exports one version per tenant "
        "from a fleet fit (docs/TENANCY.md).")
    p.add_argument("--registry", required=True,
                   help="registry root directory (created if absent)")
    p.add_argument("--name", default=None, help="model name (single-"
                   "model sources; --fleet uses tenant names)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", metavar="DIR",
                     help="order-search sweep checkpoint directory; "
                     "exports the best-scoring K with its criterion")
    src.add_argument("--summary", metavar="FILE.summary",
                     help="a .summary model file (ours or the "
                     "reference's)")
    src.add_argument("--fleet", metavar="DIR",
                     help="a `gmm fleet --out-dir` directory: bulk-"
                     "export ONE version per fitted tenant (per-model "
                     "atomic npz; per-tenant failures reported, not "
                     "run-fatal)")
    p.add_argument("--covariance-type", default="full",
                   choices=["full", "diag", "spherical", "tied"],
                   help="covariance family of a --summary model "
                   "(checkpoints record their own)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="dtype for a --summary model")
    p.add_argument("--version", type=int, default=None,
                   help="explicit version (default: next)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device the exported state passes through "
                   "(default cuda; without a GPU pass --device cpu)")
    args = p.parse_args(argv)

    import sys

    from .executor import device_or_raise

    try:
        device_or_raise(args.device)
    except RuntimeError as e:
        print(f"export failed: {e}", file=sys.stderr)
        return 1

    if args.fleet:
        if args.name is not None:
            p.error("--fleet exports under tenant names; drop --name")
        reg = ModelRegistry(args.registry)
        try:
            audit = reg.export_fleet(args.fleet, version=args.version,
                                     device=args.device)
        except (RegistryError, OSError) as e:
            print(f"fleet export failed: {e}", file=sys.stderr)
            return 1
        ok = 0
        for row in audit:
            if "version" in row:
                ok += 1
                print(f"exported {row['name']!r} version "
                      f"{row['version']}")
            elif row.get("skipped") == "dropped":
                print(f"skipped {row['name']!r}: dropped by the fleet "
                      f"fit ({row.get('error')})", file=sys.stderr)
            else:
                print(f"export of {row['name']!r} failed: "
                      f"{row.get('error')}", file=sys.stderr)
        print(f"fleet export: {ok}/{len(audit)} tenants exported")
        return 0 if ok else 1
    if args.name is None:
        p.error("--name is required for single-model sources")

    reg = ModelRegistry(args.registry)
    try:
        if args.checkpoint:
            v = reg.export_checkpoint(args.checkpoint, args.name,
                                      version=args.version,
                                      device=args.device)
        else:
            v = reg.export_summary(args.summary, args.name,
                                   covariance_type=args.covariance_type,
                                   dtype=args.dtype,
                                   version=args.version,
                                   device=args.device)
    except (RegistryError, OSError, ValueError) as e:
        print(f"export failed: {e}", file=sys.stderr)
        return 1
    m = reg.load(args.name, v).manifest
    crit = (f" {m['criterion']}={m['score']:.6e}"
            if m.get("criterion") and m.get("score") is not None else "")
    print(f"exported {args.name!r} version {v} "
          f"(K={m['k']}, D={m['d']}, {m['covariance_type']}, "
          f"{m['dtype']}{crit})")
    return 0
