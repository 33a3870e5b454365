"""Runtime configuration of the PyTorch/CUDA port.

The field names and defaults are those of ``cuda_gmm_mpi_tpu.config.GMMConfig``
for every field this package reads, so one configuration means the same thing
in both packages. Fields of features that are not ported yet are absent
rather than ignored. Provenance of the reference's compile-time defines:

- ``max_clusters``             <- MAX_CLUSTERS            (gaussian.h:10)
- ``covariance_dynamic_range`` <- COVARIANCE_DYNAMIC_RANGE (gaussian.h:12)
- ``diag_only``                <- DIAG_ONLY               (gaussian.h:23)
- ``min_iters``/``max_iters``  <- MIN_ITERS/MAX_ITERS     (gaussian.h:26-27)
- ``enable_print``             <- ENABLE_PRINT            (gaussian.h:35)
- ``enable_debug``             <- ENABLE_DEBUG            (gaussian.h:31)
- ``device``                   <- DEVICE                  (gaussian.h:19), a
  torch device name ('cuda' or 'cpu').
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GMMConfig:
    """Configuration for GMM-EM fitting and the model-order search."""

    max_clusters: int = 512
    covariance_dynamic_range: float = 1e3
    diag_only: bool = False
    # 'full' (reference default) | 'diag' (the reference's DIAG_ONLY; the
    # same setting as diag_only=True) | 'spherical' (sigma^2 I per cluster;
    # the diagonal statistics path) | 'tied' (one shared D x D covariance;
    # the full statistics path). The merge scan scores merges with the
    # unconstrained pooled covariance and EM re-imposes the family each K.
    covariance_type: str = "full"
    min_iters: int = 100
    max_iters: int = 100
    # Model-order selection score: 'rissanen' = the reference's MDL score
    # (gaussian.cu:826); 'bic'/'aic'/'aicc' count the family's free
    # parameters and use the event count N.
    criterion: str = "rissanen"
    # epsilon = nparams_per_cluster * ln(N*D) * scale (gaussian.cu:458).
    epsilon_scale: float = 0.01
    dtype: str = "float32"
    # Matmul precision of every product (the TPU's three modes, spelled out
    # on any device by ops/estep.py::kdot and, on the card, by K1/K3):
    # 'highest' = fp32-class products (TF32 off; K1's statistics in three
    # TF32 passes on the tensor cores, its logp on the fp32 FMA units);
    # 'high' = bf16_3x (each fp32 operand split into two bf16 parts, three
    # bf16 passes); 'default' = one bf16 pass. The cluster-sharded kernels
    # K5/K6 take all three as well.
    matmul_precision: str = "highest"
    # Quadratic-form evaluation: 'expanded' = x Rinv x^T - 2 b x + c as
    # products (data centered at fit time keeps it well-conditioned);
    # 'packed' = the same on the D(D+1)/2 upper-triangle features;
    # 'centered' = explicit (x - mu) staging (most stable; torch ops only,
    # the kernels compute the expanded form).
    quad_mode: str = "expanded"
    # Events per step of the torch-ops statistics loop; also the padded
    # chunk grid the event data is laid out in.
    chunk_size: int = 65536
    # Center the data at fit time (shift-equivariant; outputs shifted back).
    center_data: bool = True
    # E-step/statistics backend: 'cuda' runs the hand-written kernels K1/K2,
    # 'torch' the torch-ops path, 'auto' picks by device and dtype
    # (ops/kernels/__init__.py::resolve_estep_backend).
    estep_backend: str = "auto"
    # Hoist the [N, F] quadratic features of ``quad_mode`` out of the EM
    # loop on the torch-ops path: built once per EM run and held in device
    # memory (N*F*itemsize bytes), read every iteration. Full-covariance,
    # 'expanded'/'packed' only; the kernels build their features on chip.
    precompute_features: bool = False
    # Upper bound on the events K1 holds in shared memory per tile (the
    # kernel lowers it to fit its shared-memory budget at large K).
    pallas_block_b: int = 512
    # Torch device every entry point runs on. There is no silent fallback:
    # 'cuda' without a GPU raises.
    device: str = "cuda"
    # Debug prints (ENABLE_DEBUG, gaussian.h:31): the logger at DEBUG and a
    # JSON ``em_done`` line per K on stderr.
    enable_debug: bool = False
    enable_print: bool = False
    # Run the whole model-order sweep as one device program
    # (models/fused_sweep.py): on one CUDA device each K's EM and its order
    # reduction are CUDA-graph replays, with one scalar read per iteration
    # past min_iters and one per K. Fixed-width by design (it ignores
    # ``sweep_k_buckets``). Composes with ``checkpoint_dir`` and the
    # recorder through a per-K emission; a model without it (a mesh) runs
    # the host-driven sweep with a warning.
    fused_sweep: bool = False
    # Cluster-width bucketing of the host-driven sweep: 'pow2' shrinks the
    # padded width to the active count's power of two as merges cross a
    # boundary (at most ceil(log2 K0) + 1 widths, one EM program each);
    # 'off' keeps the starting width.
    sweep_k_buckets: str = "pow2"

    # --- out of core (models/streaming.py, io/pipeline.py) ---
    # Stream the events through the device block by block on every EM pass
    # instead of uploading them once: the device holds one block (two on
    # the card, double-buffered) and the statistics, so N is bounded by
    # host memory (or, with ingest='pipelined', by the disk). Each block's
    # statistics are one K1 launch and each M-step one K2 launch where the
    # routing table (ops/kernels/__init__.py) gives 'cuda'; torch ops
    # elsewhere. The JAX package refuses ``use_pallas='always'`` here,
    # because its streaming path runs no Pallas kernel; this port's
    # counterpart, ``estep_backend='cuda'``, is honoured: streaming runs on
    # K1/K2 like the in-memory path. A data mesh (S, 1) streams each
    # rank's slice and sums the statistics over the data axis once per
    # pass.
    stream_events: bool = False
    # 'resident' reads this rank's events into host memory before
    # streaming; 'pipelined' never does: a worker thread reads each
    # block's rows from the file (a FileSource), casts and centres them
    # while the device computes the previous block, so host memory is
    # O(ingest_queue_depth x block). Bit-identical to 'resident'.
    ingest: str = "resident"  # 'resident' | 'pipelined'
    # Blocks the pipelined reader may hold ahead of the device.
    ingest_queue_depth: int = 4
    # 'full' = batch EM, one M-step per pass over the data; 'minibatch' =
    # stepwise EM (Cappe & Moulines 2009): each step streams the next
    # minibatch, rescales its statistics to the full weight, folds them
    # into a running estimate with gamma_t = (t + minibatch_t0) **
    # -minibatch_alpha and runs the M-step on it. min/max_iters count
    # steps; one full pass gives the final loglik. Needs stream_events.
    em_mode: str = "full"  # 'full' | 'minibatch'
    # Events per minibatch, rounded up to whole streamed blocks (chunk_size
    # x the data-axis size); 0 = one block per step.
    minibatch_size: int = 0
    minibatch_t0: float = 2.0
    # In (0.5, 1] (the Robbins-Monro conditions).
    minibatch_alpha: float = 0.7
    # Reject NaN/Inf event rows before any arithmetic (the reference's
    # reader admits them silently); False skips the check.
    validate_input: bool = True
    # RNG seed of the randomized paths (k-means++ seeding); the reference
    # itself is deterministic.
    seed: int = 0
    # Initial means: 'even' = the reference's evenly spaced event rows
    # (gaussian.cu:108-123); 'kmeans++' = D^2-weighted sampling,
    # deterministic given ``seed``.
    seed_method: str = "even"
    # Independent restarts (sklearn's n_init): init 0 uses ``seed_method``,
    # restarts i >= 1 use k-means++ at ``seed + i``; the best Rissanen score
    # is kept. 1 = the reference's single deterministic init.
    n_init: int = 1
    # Restarts per batched EM loop (models/restarts.py): one K3 + one K4
    # launch per EM iteration of the whole batch. None sizes the batch from
    # a memory budget (GMM_RESTART_MEM_BYTES overrides the budget); 1 = the
    # sequential path, which selects the same winner at the same seeds.
    restart_batch_size: Optional[int] = None
    # --- multi-tenancy fleet fits (tenancy/) ---
    # Per-group EM dispatch mode for `fit_fleet` / `gmm fleet`:
    #   'scan' (default): every tenant lane of one packed group runs its
    #     own solo EM loop (``GMMModel.run_em`` on the lane's events: K1/K2
    #     on the card, one captured program per lane), so per-tenant
    #     results are BIT-IDENTICAL to solo fits of the same tenants at
    #     ``sweep_k_buckets='off'`` (the fleet parity contract).
    #   'vmap': the lanes run as one batched loop over a leading tenant
    #     axis -- one K3 launch (its per-lane-events form) and one K4
    #     launch per EM iteration of the whole group -- at reduction-order
    #     tolerance instead of bit-parity.
    fleet_mode: str = "scan"
    # Tenants per packed-group EM dispatch. None = every tenant of a
    # (N-bucket, K-bucket) group rides one dispatch; smaller values split
    # groups (memory bound: one group holds T x the padded chunk grid on
    # device).
    fleet_group_size: Optional[int] = None
    # (data, cluster) mesh over the ranks of a torch.distributed world
    # (parallel/mesh.py): events sharded over the data axis, clusters over
    # the cluster axis. None = every rank on the data axis.
    mesh_shape: Optional[Tuple[int, int]] = None
    # Write the model's cluster blocks and the .results (the reference's
    # compile-time ENABLE_OUTPUT; --no-output turns it off).
    enable_output: bool = True

    # --- numerical fault containment (health.py) ---
    # The health counters are always computed. ``recovery`` selects what a
    # FATAL flag (non-finite loglik/params) does: 'retry' rolls back to the
    # K's input state and climbs the escalation ladder (sanitize + raise
    # the variance floor -> quad_mode='centered' -> 'highest' precision),
    # failing loudly (NumericalFaultError) only when the ladder is
    # exhausted; 'off' raises at once. A poisoned model is never returned.
    recovery: str = "retry"
    # Escalation rungs attempted per fault before giving up (3 exist).
    max_recovery_attempts: int = 3
    # Variance-floor multiplier per attempt: attempt i retries with
    # avgvar * boost**i.
    recovery_boost: float = 10.0
    # Reseed empty clusters from worst-fit events at a target-K fit instead
    # of letting elimination shrink the model below the requested K.
    recovery_reseed_empty: bool = False
    # A loglik drop beyond this many epsilons between EM iterations raises
    # the (non-fatal) loglik_regression flag.
    health_regression_scale: float = 10.0

    # --- checkpoint/resume and the run supervisor (utils/checkpoint.py,
    # supervisor.py) ---
    # Directory of the sweep's checkpoints (<dir>/sweep/<step>.npz, the
    # JAX package's layout); None = no checkpoints.
    checkpoint_dir: Optional[str] = None
    # Retained checkpoint steps (newest + fallbacks). >= 1.
    checkpoint_keep: int = 2
    # Bounded retries (jittered exponential backoff) of a checkpoint
    # write; 0 = the first failure is final.
    checkpoint_retries: int = 3
    # Wall-clock budget in seconds: reaching it acts like SIGTERM --
    # cooperative stop, emergency checkpoint, exit 75. None = no deadline.
    max_runtime_s: Optional[float] = None
    # EM iterations between the supervisor's stop-flag checks inside a K
    # (with a supervisor and checkpoint_dir).
    preempt_poll_iters: int = 25
    # 'auto' resumes from the newest checkpoint (an emergency mid-EM
    # sub-step included); 'never' starts fresh (and still writes).
    resume: str = "auto"
    # Liveness watchdog timeout of a mesh of more than one rank (with a
    # supervisor and checkpoint_dir): a peer whose heartbeat on the
    # checkpoint filesystem goes stale beyond this raises PeerLostError
    # (exit 75) instead of hanging in the next collective. 0 disables it.
    peer_timeout_s: float = 60.0
    # Elastic recovery (parallel/elastic.py): on PeerLostError the
    # surviving ranks rendezvous on the checkpoint filesystem, seal a
    # shrunken generation-stamped membership, rebuild the process group
    # over themselves and refit from the newest checkpoint. Requires
    # checkpoint_dir.
    elastic: bool = False
    # Smallest world an elastic shrink may leave; below it the run exits 75.
    min_hosts: int = 1
    # Shrinks before elastic recovery gives up (each loss takes one).
    elastic_max_retries: int = 2
    # Pause before the first rendezvous (doubles per attempt).
    elastic_backoff_s: float = 0.5
    # JSONL path of the run's telemetry stream (telemetry/); None = off.
    metrics_file: Optional[str] = None

    # --- observability (telemetry/, utils/profiling.py) ---
    # Per-phase timing in the reference's seven profile_t categories
    # (gaussian.cu:967): ``GMMResult.profile``/``profile_report`` and the
    # CLI's --profile table. A fit with an active recorder times its phases
    # anyway (``run_summary.phase_profile``).
    profile: bool = False
    # Live observability plane: serve OpenMetrics text on
    # 127.0.0.1:<port>/metrics for the fit's duration, sample host RSS and
    # the device's allocator counters onto heartbeat records, and emit
    # trace spans (fit, sweep, em_k, recovery, checkpoint, fused_sweep) and
    # a fit-scoped trace_id on the stream. 0 = an OS-assigned port. None
    # (default) = off.
    metrics_port: Optional[int] = None
    # Training envelope: at the fit's end one more pass of the fit data
    # through the final parameters, on the device, sketches the per-event
    # log evidence and counts each cluster's argmax occupancy
    # (telemetry/sketch.py); it rides ``GMMResult.envelope`` and
    # ``run_summary.envelope``. Observational: a failure logs and leaves
    # None. False skips the pass.
    envelope: bool = True
    # Profile-guided autotuning (tuning/):
    #   'off' (default): every knob runs exactly as set -- streams and
    #     results stay byte-identical to an untuned run.
    #   'db': resolve unset tunable knobs (chunk_size, estep_backend,
    #     sweep_k_buckets, restart_batch_size) from the nearest recorded
    #     profile in the tuning database, falling back to the static cost
    #     model; knobs whose value differs from the dataclass default are
    #     treated as user-pinned and never touched.
    #   'probe': like 'db', but missing rows are measured first by a
    #     bounded microprobe (2-3 real EM iterations per candidate) and
    #     written back to the database.
    # Every resolved decision is a `tune` telemetry event when a recorder
    # is active.
    autotune: str = "off"
    # Tuning database path. None = GMM_TUNING_DB or
    # ~/.cache/gmm/tuning.json (tuning.db.default_db_path).
    tuning_db: Optional[str] = None

    def __post_init__(self):
        if self.min_iters > self.max_iters:
            raise ValueError(
                f"min_iters ({self.min_iters}) must be <= max_iters "
                f"({self.max_iters})")
        if self.max_clusters < 1:
            raise ValueError("max_clusters must be >= 1")
        if self.metrics_port is not None and not (
                0 <= self.metrics_port <= 65535):
            raise ValueError(
                f"metrics_port must be in [0, 65535], got {self.metrics_port}")
        if self.covariance_type not in ("full", "diag", "spherical", "tied"):
            raise ValueError(
                f"unknown covariance_type: {self.covariance_type!r}")
        if self.criterion not in ("rissanen", "bic", "aic", "aicc"):
            raise ValueError(f"unknown criterion: {self.criterion!r}")
        # diag_only and covariance_type are one setting: keep them coherent
        # whichever way the caller spells it.
        if self.diag_only and self.covariance_type == "full":
            object.__setattr__(self, "covariance_type", "diag")
        elif self.covariance_type in ("diag", "spherical"):
            object.__setattr__(self, "diag_only", True)
        elif self.diag_only and self.covariance_type == "tied":
            raise ValueError(
                "covariance_type='tied' needs full-covariance statistics; "
                "it cannot combine with diag_only=True")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unknown dtype: {self.dtype!r}")
        if self.matmul_precision not in ("highest", "high", "default"):
            raise ValueError(
                f"unknown matmul_precision: {self.matmul_precision!r}")
        if self.autotune not in ("off", "db", "probe"):
            raise ValueError(
                f"unknown autotune mode: {self.autotune!r} "
                "(expected 'off', 'db' or 'probe')")
        if self.quad_mode not in ("expanded", "packed", "centered"):
            raise ValueError(f"unknown quad_mode: {self.quad_mode!r}")
        if self.estep_backend not in ("auto", "cuda", "torch"):
            raise ValueError(
                f"unknown estep_backend: {self.estep_backend!r} "
                "(expected 'auto', 'cuda' or 'torch')")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(
                f"unknown device: {self.device!r} (expected 'cuda' or 'cpu')")
        if self.chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if self.pallas_block_b < 64 or self.pallas_block_b % 64:
            raise ValueError("pallas_block_b must be a positive multiple of 64")
        if self.seed_method not in ("even", "kmeans++"):
            raise ValueError(f"unknown seed_method: {self.seed_method!r}")
        if self.n_init < 1:
            raise ValueError("n_init must be >= 1")
        if self.restart_batch_size is not None and self.restart_batch_size < 1:
            raise ValueError("restart_batch_size must be >= 1 (or None for "
                             "the memory-sized default)")
        if self.fleet_mode not in ("scan", "vmap"):
            raise ValueError(
                f"unknown fleet_mode: {self.fleet_mode!r} "
                "(expected 'scan' or 'vmap')")
        if self.fleet_group_size is not None and self.fleet_group_size < 1:
            raise ValueError("fleet_group_size must be >= 1 (or None for "
                             "whole-group dispatches)")
        if self.sweep_k_buckets not in ("pow2", "off"):
            raise ValueError(
                f"unknown sweep_k_buckets: {self.sweep_k_buckets!r} "
                "(expected 'pow2' or 'off')")
        if self.precompute_features:
            if self.diag_only:
                raise ValueError(
                    "precompute_features is a full-covariance optimization "
                    "(diag builds no [N, F] features)")
            if self.quad_mode == "centered":
                raise ValueError(
                    "precompute_features requires quad_mode='expanded' or "
                    "'packed' (the 'centered' staging has no loop-invariant "
                    "feature matrix to hoist)")
            if self.estep_backend == "cuda":
                raise ValueError(
                    "precompute_features is the torch-ops feature hoist; "
                    "the CUDA kernels build their features on chip -- drop "
                    "one flag")
            if self.stream_events:
                raise ValueError(
                    "precompute_features holds all features in device "
                    "memory; stream_events exists because the data does "
                    "not fit there -- drop one flag")
        if (self.stream_events and self.mesh_shape is not None
                and len(self.mesh_shape) == 2 and self.mesh_shape[1] != 1):
            raise ValueError(
                "stream_events shards events only; the cluster mesh axis "
                "must be 1 (use mesh_shape=(S, 1))")
        if self.ingest not in ("resident", "pipelined"):
            raise ValueError(
                f"unknown ingest: {self.ingest!r} "
                "(expected 'resident' or 'pipelined')")
        if self.ingest == "pipelined" and not self.stream_events:
            raise ValueError(
                "ingest='pipelined' feeds the streaming block loop; it "
                "requires stream_events=True")
        if self.ingest_queue_depth < 1:
            raise ValueError("ingest_queue_depth must be >= 1")
        if self.em_mode not in ("full", "minibatch"):
            raise ValueError(
                f"unknown em_mode: {self.em_mode!r} "
                "(expected 'full' or 'minibatch')")
        if self.em_mode == "minibatch" and not self.stream_events:
            raise ValueError(
                "em_mode='minibatch' is the streaming stepwise EM loop; it "
                "requires stream_events=True")
        if not 0.5 < self.minibatch_alpha <= 1.0:
            raise ValueError(
                f"minibatch_alpha must lie in (0.5, 1], got "
                f"{self.minibatch_alpha}")
        if self.minibatch_t0 < 0:
            raise ValueError("minibatch_t0 must be >= 0")
        if self.minibatch_size < 0:
            raise ValueError(
                "minibatch_size must be >= 0 (0 = one block per step)")
        if self.checkpoint_keep < 1:
            raise ValueError("checkpoint_keep must be >= 1")
        if self.max_runtime_s is not None and self.max_runtime_s <= 0:
            raise ValueError("max_runtime_s must be > 0 (or None)")
        if self.preempt_poll_iters < 1:
            raise ValueError("preempt_poll_iters must be >= 1")
        if self.resume not in ("auto", "never"):
            raise ValueError(
                f"unknown resume: {self.resume!r} "
                "(expected 'auto' or 'never')")
        if self.peer_timeout_s < 0:
            raise ValueError("peer_timeout_s must be >= 0 (0 disables)")
        if self.elastic and not self.checkpoint_dir:
            raise ValueError(
                "elastic recovery requires checkpoint_dir: the checkpoint "
                "filesystem is the survivors' rendezvous medium and the "
                "resume source")
        if self.min_hosts < 1:
            raise ValueError("min_hosts must be >= 1")
        if self.elastic_max_retries < 1:
            raise ValueError("elastic_max_retries must be >= 1")
        if self.elastic_backoff_s < 0:
            raise ValueError("elastic_backoff_s must be >= 0")
        if self.recovery not in ("retry", "off"):
            raise ValueError(
                f"unknown recovery: {self.recovery!r} "
                "(expected 'retry' or 'off')")
        if self.max_recovery_attempts < 0:
            raise ValueError("max_recovery_attempts must be >= 0")
        if self.checkpoint_retries < 0:
            raise ValueError("checkpoint_retries must be >= 0")
        if self.recovery_boost < 1.0:
            raise ValueError("recovery_boost must be >= 1")
        if self.health_regression_scale <= 0:
            raise ValueError("health_regression_scale must be > 0")
        if self.mesh_shape is not None and (
                len(self.mesh_shape) != 2 or min(self.mesh_shape) < 1):
            raise ValueError(f"mesh_shape must be (data, cluster) with both "
                             f">= 1, got {self.mesh_shape!r}")
