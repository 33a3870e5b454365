"""Event schema for the run-scoped telemetry stream (docs/OBSERVABILITY.md).

The port's own copy of the JAX package's ``telemetry/schema.py``, at the
same stream revision (v2.8) and with the same field tables, so a stream the
port writes validates under either package's ``validate_stream`` and the
JAX package's ``gmm report`` renders it. Every record a
:class:`~cuda_gmm_mpi_tpu_torch.telemetry.RunRecorder` emits is one JSON
object per line, stamped with a schema version. The port emits a subset of
the events (those of the fit, the recovery ladder and the run lifecycle);
the serving, fleet, drift and profiling events stay in the table so the two
copies remain one contract.

Versioning: ``SCHEMA_VERSION`` bumps only on breaking changes (a removed or
retyped required field). Adding optional fields is always allowed -- readers
must ignore unknown fields.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

SCHEMA_VERSION = 1

# Stamped on every record by the recorder. Rev v2.1 additions to the
# envelope are OPTIONAL (not listed here -- old fixtures must keep
# validating): ``mono_s``, the process-monotonic emission time
# (time.perf_counter()), which report/--follow prefer over wall-clock
# ``ts`` deltas for durations (``ts`` can jump under NTP slew -- the
# clock-skew bug class the PR-11 watchdog fix addressed); and
# ``trace_id``, the fit/request-scoped trace identity joining a record
# to its span tree (telemetry/spans.py).
#
# Rev v2.3 optional envelope additions: ``clock``, an atomically-sampled
# {"wall", "mono"} pair carried by the stream head (run_start / a serve
# stream's first record) and every heartbeat -- the cross-stream
# alignment anchor ``gmm timeline`` uses to merge multi-rank and
# fit+serve streams onto one timebase; the head also carries ``clock0``,
# the recorder-construction pair, so a heartbeat-free stream still holds
# two anchors for drift estimation. ``validate_record`` checks the
# pair's shape wherever it appears.
COMMON_FIELDS = ("event", "schema", "ts", "run_id", "process")

# The v2.3 clock-pair shape shared by ``clock`` and ``clock0``.
CLOCK_FIELDS = ("wall", "mono")

# event -> ((required fields), (optional well-known fields)). Optional
# fields are documented for readers; unknown extras are always legal.
EVENT_FIELDS: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    # One per fit (per init when n_init > 1): the run's identity card.
    # ``em_backend`` (stream rev v1.5) names the E-step/statistics backend
    # that ACTUALLY ran -- pallas / pallas-interpret / jnp / custom -- and
    # ``em_backend_reason`` why (resolve_estep_backend): a silent jnp
    # fallback away from a requested kernel is observable in the stream,
    # not indistinguishable from the kernel path.
    "run_start": (
        ("platform", "num_events", "num_dimensions", "start_k", "epsilon"),
        ("target_k", "process_count", "device_count", "local_device_count",
         "mesh", "path", "dtype", "chunk_size", "covariance_type",
         "criterion", "fused_sweep", "stream_events", "n_init", "init",
         "restart_batch_size", "memory_stats", "em_backend",
         "em_backend_reason"),
    ),
    # One per EM iteration of each K (host-driven sweeps; the fused
    # whole-sweep device program emits per-K records only).
    "em_iter": (
        ("k", "iter", "loglik", "delta", "epsilon", "wall_s", "timing"),
        (),
    ),
    # One per completed K of the model-order sweep.
    "em_done": (
        ("k", "loglik", "score", "criterion", "iters", "seconds"),
        (),
    ),
    # One per closest-pair merge between Ks. ``pair`` (optional) is the
    # merged clusters' positions in the compacted (post-elimination)
    # ordering -- stable across bucket recompaction, unlike padded-slot
    # indices (ops/merge.eliminate_and_reduce).
    "merge": (
        ("k_active", "next_k", "min_distance"),
        ("pair",),
    ),
    # One per bucket recompaction of the host-driven sweep (sweep_k_buckets):
    # the state was rebuilt from padded width ``from_width`` down to
    # ``to_width`` with ``k_active`` clusters live.
    "rebucket": (
        ("k_active", "from_width", "to_width"),
        (),
    ),
    # Streaming (out-of-core) path: one per host->device block flush.
    # ``prefetch_wait_s``/``compute_s`` (rev v1.9) split the block's host
    # wall: time blocked on ingestion (0.0 when the chunks are host-
    # resident) vs. time in the statistics dispatch -- the pipelined-
    # ingestion overlap win is directly observable per block.
    "chunk_flush": (
        ("iter", "block", "chunks", "bytes"),
        ("k", "prefetch_wait_s", "compute_s"),
    ),
    # Pipelined ingestion lifecycle (rev v1.9; io/pipeline.py): one
    # ingest_start per fit with a lazy block source -- the rank's file
    # source, row range, and bounded-queue depth.
    "ingest_start": (
        ("source", "rows", "queue_depth"),
        ("row_start", "row_stop", "blocks", "chunk_size", "mode"),
    ),
    # ...and one ingest_summary when the source closes: blocks served,
    # peak resident block count (the O(queue_depth x block) memory claim,
    # measured), cumulative prefetch wait, and bytes range-read.
    "ingest_summary": (
        ("blocks_read", "peak_resident_blocks"),
        ("prefetch_wait_s", "bytes", "queue_depth"),
    ),
    # Rate-limited liveness marker for long phases. The resource sampler
    # (rev v2.1; telemetry/exporter.py, --metrics-port) stamps periodic
    # heartbeats with ``rss_bytes`` (host VmRSS) and ``memory_stats``
    # (first local device's memory_stats(): HBM in-use / peak) so memory
    # high-water is observable DURING the run, not only at run_start.
    "heartbeat": (
        ("phase", "elapsed_s"),
        ("k", "rss_bytes", "memory_stats", "sampler"),
    ),
    # One per nonzero health word observed (health.py): ``flags`` is the
    # packed bitmask, ``flag_names`` its decoded lanes, ``counters`` the
    # per-lane counts, ``where`` the observation point (em / score /
    # fused_sweep).
    "health": (
        ("flags", "flag_names"),
        ("k", "counters", "where"),
    ),
    # One per recovery action: an escalation-ladder attempt after a fatal
    # health word (action = regularize / centered / highest), the fused
    # sweep's host_fallback, or a reseed_empty pass. ``outcome`` is
    # recovered / fatal / retry / rerun.
    "recovery": (
        ("k", "attempt", "action", "outcome"),
        ("flags", "flag_names"),
    ),
    # One per retried (or abandoned: gave_up=true) checkpoint write
    # (utils/checkpoint.py bounded backoff).
    "io_retry": (
        ("op", "attempt", "error"),
        ("step", "delay_s", "gave_up"),
    ),
    # Preemption lifecycle (supervisor.py; docs/ROBUSTNESS.md "Run
    # lifecycle"): the cooperative stop flag was first observed at a poll
    # point. ``reason`` is sigterm / sigint / deadline / peer_lost /
    # preempt_injected; ``where`` the poll site (sweep / em /
    # stream_block / fused_emit / serve).
    "preempt": (
        ("reason",),
        ("where", "k", "em_iter", "peer"),
    ),
    # The stop's endgame, just before the process exits 75:
    # ``checkpointed`` says whether the emergency intra-K sub-step (or,
    # between Ks, the previous full step) is durable for --resume auto.
    "shutdown": (
        ("reason", "checkpointed"),
        ("step", "k", "em_iter"),
    ),
    # The liveness watchdog flagged a dead/wedged peer rank: its
    # heartbeat on the shared checkpoint filesystem aged past the
    # timeout. Followed by a peer_lost-reason preempt/shutdown pair.
    "peer_lost": (
        ("rank", "timeout_s"),
        ("age_s",),
    ),
    # Elastic recovery (stream rev v2.0; parallel/elastic.py,
    # docs/DISTRIBUTED.md "Elastic recovery"): the survivors sealed a
    # shrunken membership generation after a peer loss -- ``survivors``
    # are the surviving ORIGINAL rank ids, ``world_size`` the new world.
    # Emitted once per shrink by every surviving rank.
    "elastic_shrink": (
        ("generation", "survivors", "world_size"),
        ("lost_ranks", "attempt", "min_hosts"),
    ),
    # The shrunken world resumed the sweep from the newest checkpoint
    # (rev v2.0): pairs with the preceding elastic_shrink; ``attempt``
    # counts recovery rounds within one run.
    "elastic_resume": (
        ("generation", "attempt"),
        ("step", "k", "world_size"),
    ),
    # One per n_init > 1 fit (stream rev v1.4): which restart won and
    # every init's best criterion score (NaN/Inf scores are null).
    # ``mode`` is batched / sequential; ``batch_size`` the restart batch
    # the winner ran in (1 = the sequential driver); ``dropped`` lists
    # init indices removed by the drop-one-keep-survivors fault path
    # (models/restarts.py).
    "restart_select": (
        ("winner", "scores", "criterion"),
        ("mode", "batch_size", "dropped"),
    ),
    # Serving loop (stream rev v1.6; serving/server.py, docs/SERVING.md):
    # one per answered request. ``n`` is the request's row count,
    # ``latency_ms`` arrival-to-reply; failed requests carry ok=false +
    # ``error``.
    "serve_request": (
        ("model", "op", "n", "latency_ms"),
        # ``trace_id`` (rev v2.1): present under ``--metrics-port``; the
        # same id is echoed in the client's response for joining.
        ("version", "ok", "error", "trace_id"),
    ),
    # One per coalesced micro-batch dispatch: how many concurrent
    # requests' rows rode one padded executor call, the pow2-bucketed
    # row count actually dispatched, and whether the dispatch had to
    # AOT-compile (``compiled`` > 0 = a cold bucket; a warmed server
    # emits zeros -- the zero-recompile proof is observable per batch).
    # ``stacked`` (optional, rev v1.8) marks a cross-model stacked
    # dispatch: how many DIFFERENT models' groups rode one executable
    # call (serving/server.py --stack-models; bit-identical to
    # per-model dispatch).
    "serve_batch": (
        ("model", "requests", "rows", "padded_rows", "wall_ms"),
        ("version", "compiled", "stacked"),
    ),
    # One per adaptive micro-batching window adaptation (stream rev
    # v2.8; serving/server.py --tick-min-ms/--tick-max-ms,
    # docs/SERVING.md "Adaptive micro-batching"): the controller moved
    # the gather window or flipped auto-stacking. ``window_ms`` is the
    # NEW window; ``reason`` is ``backlog`` (queue still deep after a
    # gather -> snap to the floor), ``idle`` (a near-empty window ->
    # widen toward the ceiling), or ``auto_stack_on``/``auto_stack_off``
    # (the stackable-window streak crossed the hysteresis thresholds).
    # Present only when the adaptive bounds are set, so fixed --tick-ms
    # streams stay byte-identical.
    "serve_window": (
        ("window_ms", "reason"),
        ("prev_window_ms", "queue_rows", "arrival_per_s", "requests",
         "stacked_auto", "streak"),
    ),
    # One per shed request (stream rev v1.7; serving resilience,
    # docs/ROBUSTNESS.md "Serving"): admission control rejected the
    # request before it entered the batching queue. ``reason`` is
    # ``overloaded`` (bounded queue full) or ``shutting_down`` (arrival
    # after the drain began).
    "serve_shed": (
        ("reason",),
        ("model", "rows", "queued_rows", "max_queue_rows"),
    ),
    # One per deadline-expired request (rev v1.7): its budget
    # (``deadline_ms``, per-request or --default-deadline-ms) ran out
    # while queued, so it was rejected BEFORE dispatch -- the executor
    # never ran for it. ``waited_ms`` is how long it actually sat.
    "serve_deadline": (
        ("deadline_ms", "waited_ms"),
        ("model", "op", "n"),
    ),
    # One per hot-reloaded default route (rev v1.7): the registry grew a
    # new version and the server atomically swapped the version=None
    # route from ``from_version`` to ``to_version`` between ticks
    # (in-flight ticks finished on the old version; pinned-version
    # routes are untouched).
    "serve_reload": (
        ("model", "from_version", "to_version"),
        ("fingerprint",),
    ),
    # One per circuit-breaker state transition (rev v1.7;
    # serving/breaker.py): ``state`` is open / half_open / closed;
    # ``reason`` what tripped it (non_finite / registry / executor);
    # ``backoff_s`` the open window on an open transition; ``trips``
    # the route's consecutive-open count.
    "circuit": (
        ("model", "state"),
        ("version", "failures", "trips", "reason", "backoff_s"),
    ),
    # One per serve session, at shutdown (run_summary's serving
    # sibling): volume, QPS, latency percentiles, aggregated executor
    # cache counters, and the metrics-registry snapshot. Rev v1.7 adds
    # the resilience counters: ``shed``, ``deadline_expired``,
    # ``reloads``, and the ``breaker`` {trips, closes, open_routes}
    # rollup.
    # ``profile`` (optional, rev v2.2): the CompileWatch rollup for the
    # serve session -- same shape as run_summary.profile.
    "serve_summary": (
        ("requests", "batches", "rows", "wall_s", "qps", "latency_ms",
         "metrics"),
        # ``drift`` (optional, rev v2.4): the drift-plane rollup --
        # {windows, alarms, last {model-> last stats}}; present only
        # when --drift-interval-s was set, so drift-off streams stay
        # byte-identical.
        # ``http`` (optional, rev v2.7): the HTTP front-end rollup --
        # {requests, errors_4xx, errors_5xx, shed_connections, retries,
        # retries_exhausted, worker_crashes, worker_respawns,
        # worker_quarantines, workers}; present only under ``--http``,
        # so HTTP-off streams stay byte-identical. ``gmm diff`` folds it
        # into the ``http.errors_5xx`` / ``http.worker_crashes`` /
        # ``http.retries_exhausted`` default gates.
        # ``window`` (optional, rev v2.8): the adaptive micro-batching
        # rollup -- {adaptations, window_ms, min_ms, max_ms,
        # auto_stack}; present only under --tick-min-ms/--tick-max-ms.
        # ``stacked_fallthrough`` (optional, rev v2.8): rows-groups that
        # arrived in a stacked window but failed ``stackable_rows`` and
        # dispatched solo -- reconciles serve_batch counts against
        # ``stacked_batches``.
        ("models", "executor", "errors", "shed", "deadline_expired",
         "reloads", "breaker", "stacked_batches", "stacked_fallthrough",
         "profile", "drift", "http", "window"),
    ),
    # One per answered HTTP request (stream rev v2.7; serving/http.py,
    # docs/SERVING.md "HTTP front end"): ``status`` is the HTTP status
    # actually sent, ``latency_ms`` receive-to-reply on the handler
    # thread. ``worker`` (pool mode) names the worker slot that scored
    # it; ``retried`` marks answers that needed the sibling retry after
    # a worker crash. ``trace_id`` is the echoed X-GMM-Trace-Id, joining
    # the HTTP edge to the server-side serve_request/span records.
    "http_request": (
        ("method", "path", "status", "latency_ms"),
        ("model", "op", "n", "error", "worker", "retried", "trace_id"),
    ),
    # One per worker-pool process start (rev v2.7; serving/pool.py):
    # first launch and every respawn. ``respawn`` marks restarts after a
    # crash; ``attempt`` the consecutive-crash count driving the
    # jittered doubling ``backoff_s``.
    "worker_spawn": (
        ("worker", "pid"),
        ("socket", "attempt", "backoff_s", "respawn"),
    ),
    # One per worker-pool process exit (rev v2.7): ``crash`` is true for
    # unexpected deaths (anything outside a requested drain), and
    # ``quarantined`` marks the crash that tripped the crash-loop
    # quarantine (reason file written; the slot stops respawning while
    # siblings keep serving).
    "worker_exit": (
        ("worker", "exitcode"),
        ("pid", "reason", "crash", "quarantined"),
    ),
    # One per elapsed drift window per served (model, version) route
    # (stream rev v2.4; serving/server.py --drift-interval-s,
    # docs/OBSERVABILITY.md "Drift detection"): the window's request-
    # score sketch and assignment occupancy compared against the
    # model's TRAINING envelope (registry envelope.json). ``psi`` /
    # ``ks`` are over the shared score-bucket ladder, ``occupancy_l1``
    # over normalized per-cluster assignment mass, ``window_rows`` the
    # rows observed in the window. ``score_sketch`` / ``occupancy``
    # (optional) carry the window's raw mergeable summary so ``gmm
    # drift`` can re-aggregate a recorded stream offline at any window
    # granularity. ``alarm`` marks windows whose PSI crossed
    # --drift-psi-threshold (the paired drift_alarm record follows).
    "drift": (
        ("model", "psi", "ks", "occupancy_l1", "window_rows"),
        ("version", "alarm", "threshold", "score_sketch", "occupancy",
         "mean_score", "train_rows"),
    ),
    # The drift alarm (rev v2.4): PSI crossed the configured threshold
    # for a route's window. Rides the health-event conventions (named
    # flags, counted in the metrics registry, rendered as instants by
    # ``gmm timeline``) but is OBSERVATIONAL ONLY -- it is not a
    # health.py fault lane and never trips the serving circuit breaker.
    "drift_alarm": (
        ("model", "psi", "threshold"),
        ("version", "ks", "occupancy_l1", "window_rows", "flag_names"),
    ),
    # Lifecycle transition (stream rev v2.6; lifecycle/controller.py,
    # docs/ROBUSTNESS.md "Model lifecycle"): one per state-machine edge
    # of the closed serve->drift->retrain->promote loop. ``phase`` is
    # retrain / canary / promote / watch / rollback / quarantine /
    # cooldown; ``outcome`` the edge taken (e.g. retrain: published /
    # retry / exhausted; canary: pass / rejected; promote: promoted /
    # torn; watch: passed / violated). Gate values ride the record:
    # ``psi`` / ``ks`` over the shared score-bucket ladder,
    # ``mean_incumbent`` / ``mean_candidate`` / ``regression`` /
    # ``tolerance`` for the health_regression_scale x epsilon score
    # gate, ``shadow_rows``/``shadow_ticks`` for the duplicate-dispatch
    # window. ``candidate_version`` names the canary under evaluation;
    # ``from_version``/``to_version`` the route flip on promote and
    # rollback; ``reason`` what tripped a rollback / quarantine
    # (breaker_trip / drift_alarm / score_regression / canary gates /
    # retrain_exhausted). Counted in the metrics registry
    # (``lifecycle_<phase>s``) and folded by ``gmm diff`` into the
    # ``lifecycle.rollbacks`` / ``lifecycle.quarantines`` default gates.
    "lifecycle": (
        ("model", "phase"),
        ("outcome", "version", "candidate_version", "from_version",
         "to_version", "attempt", "reason", "psi", "ks",
         "mean_incumbent", "mean_candidate", "regression", "tolerance",
         "shadow_rows", "shadow_ticks", "alarms", "cooldown_s",
         "retry_in_s", "flag_names"),
    ),
    # Registry walk-back (rev v2.6; serving/registry.py ``load``): the
    # newest version of ``model`` was unreadable and resolution fell
    # back to an earlier one. Previously a warning only -- but a silent
    # walk-back is exactly what a botched promotion looks like, so it
    # is now a counted event (``gmm_registry_torn_total``) rendered by
    # ``gmm report`` and ``gmm timeline``. Observational: the fallback
    # still happens, serving is not interrupted.
    "registry_torn": (
        ("model", "version"),
        ("error",),
    ),
    # Autotune decision (stream rev v2.5; tuning/, docs/PERF.md
    # "Autotuning"): one per knob the profile-guided resolver touched.
    # ``chosen`` is the value the run actually used, ``source`` the
    # fallback-ladder rung that supplied it ('db' = recorded profile,
    # 'probe' = measured this run by the microprobe, 'static' = cost
    # model), ``candidates`` a {candidate: wall_per_iter_s|null} map of
    # what was considered, ``predicted_s`` the chosen candidate's
    # recorded/modelled wall per EM iteration (the ``gmm diff``
    # ``tune.regressions`` gate compares the run's measured wall/iter
    # against it), ``key`` the tuning-DB shape key that resolved,
    # ``surface`` = fit|fleet|serve, ``default`` the pre-resolution
    # value. Only ``autotune != 'off'`` runs emit these -- the default
    # stream stays byte-identical.
    "tune": (
        ("knob", "chosen", "source"),
        ("candidates", "predicted_s", "key", "surface", "default",
         "distance"),
    ),
    # Fleet fits (stream rev v1.8; tenancy/, docs/TENANCY.md): one per
    # `fit_fleet` invocation -- the fleet's identity card: tenant count,
    # packed-group count, and the dispatch mode ('scan' = bit-exact
    # lane mapping, 'vmap' = batched-matmul throughput).
    # ``group_shapes`` lists each group's {tenants, n_bucket, k_bucket}.
    "fleet_start": (
        ("tenants", "groups", "mode"),
        ("platform", "num_dimensions", "dtype", "covariance_type",
         "criterion", "chunk_size", "group_shapes"),
    ),
    # One per tenant as its group completes (rev v1.8): the tenant's
    # solo-fit summary scalars, or ``dropped: true`` + ``error`` when
    # the drop-one containment removed it from its group.
    "tenant_done": (
        ("tenant", "dropped"),
        ("k", "score", "loglik", "iters", "group", "num_events",
         "criterion", "error"),
    ),
    # One per fleet fit, at the end (rev v1.8): totals + the metrics-
    # registry snapshot (run_summary's fleet sibling).
    "fleet_summary": (
        ("tenants", "dropped", "groups", "wall_s"),
        ("mode", "metrics"),
    ),
    # One per XLA compilation observed while a CompileWatch is active
    # (stream rev v2.2; telemetry/profiling.py). ``source`` is ``aot``
    # -- an instrumented executable-cache build (models/gmm.py EM
    # executables, serving/executor.py AOT scoring programs): the
    # lower+compile timed at the call site and enriched with
    # ``compiled.cost_analysis()`` (``flops``, ``bytes_accessed``) and
    # ``memory_analysis()`` (argument/output/temp/generated-code bytes)
    # where the backend provides them -- or ``xla``: a bare
    # jax.monitoring backend-compile observation OUTSIDE any
    # instrumented site, i.e. a (re)compile the caches did not expect.
    # ``site`` names the emitting cache (em / em_batched / em_fleet /
    # serve / serve_stacked), ``phase`` the active span/phase tag,
    # ``key`` the cache's own key string.
    "compile": (
        ("source", "seconds"),
        ("site", "phase", "key", "flops", "bytes_accessed",
         "argument_bytes", "output_bytes", "temp_bytes",
         "generated_code_bytes"),
    ),
    # Trace span (rev v2.1; telemetry/spans.py): one per completed phase
    # of a traced fit or serve request -- name, this span's id, its
    # parent's id (absent on the root), and the measured duration.
    # ``trace_id`` usually arrives via the recorder context (one trace
    # per fit) but serve spans carry it per-record (one trace per
    # request). ``t0_mono_s`` is the span's START on the process
    # monotonic clock (the envelope's ``mono_s`` is the emission time =
    # span END), so a reader can order siblings and compute self-time.
    # ``thread`` (rev v2.3) is the emitting OS thread id: serve routes
    # span concurrent threads, and ``gmm timeline`` keys its per-rank
    # sub-tracks on it so overlapping spans from different threads
    # never collide on one rendered lane.
    "span": (
        ("name", "span_id", "duration_s"),
        ("parent_id", "trace_id", "t0_mono_s", "k", "status", "thread"),
    ),
    # One per fit: final scores, the 7-category phase profile, the
    # compile-vs-execute split, and the metrics-registry snapshot.
    # ``buckets`` (optional; host-driven sweeps) describes cluster-width
    # bucketing: {mode, em_widths, em_compiles, rebuckets} -- em_compiles
    # counts the DISTINCT padded widths EM compiled for.
    # ``health`` (optional): the numerical-containment summary --
    # {flags, flag_names, fatal, counters, recoveries, io_retries};
    # all-zero flags on a clean run (docs/ROBUSTNESS.md).
    # ``em_backend`` (optional, rev v1.5) mirrors run_start's.
    # ``elastic`` (optional, rev v2.0): present only when the run
    # survived at least one elastic shrink -- {generation, world_size,
    # shrinks, resumes}.
    # ``profile`` (optional, rev v2.2): the CompileWatch rollup --
    # {compiles, compile_seconds, xla_compiles, xla_compile_seconds,
    # sites, by_phase, cost {flops, bytes_accessed}, memory
    # {argument/output/temp/generated_code bytes}, watermarks,
    # hbm_peak_bytes}; present only when profiling was active
    # (telemetry/profiling.py), so pre-v2.2 readers and byte-identity
    # fixtures are untouched.
    # ``envelope`` (optional, rev v2.4): the training drift envelope --
    # the fit data's per-event score sketch + responsibility occupancy
    # (telemetry/sketch.py make_envelope), the reference distribution
    # serve-time drift is measured against; absent when envelope
    # computation is disabled (config.envelope=False) or the data
    # source was lazy/pipelined.
    "run_summary": (
        ("ideal_k", "score", "criterion", "final_loglik", "total_iters",
         "wall_s", "phase_profile", "compile", "metrics"),
        ("per_process", "memory_stats", "buckets", "health", "em_backend",
         "elastic", "profile", "envelope"),
    ),
}


def validate_record(rec: Any) -> List[str]:
    """Schema errors for one decoded record ([] = valid).

    Checks the common envelope (version, event type) and the per-event
    required fields; unknown extra fields are legal by design.
    """
    errors: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    for f in COMMON_FIELDS:
        if f not in rec:
            errors.append(f"missing common field {f!r}")
    if rec.get("schema") not in (None, SCHEMA_VERSION):
        errors.append(
            f"schema version {rec.get('schema')!r} != {SCHEMA_VERSION}")
    for pair_field in ("clock", "clock0"):
        pair = rec.get(pair_field)
        if pair is None:
            continue
        if not isinstance(pair, dict):
            errors.append(f"{pair_field} is {type(pair).__name__}, "
                          f"not an object")
            continue
        for f in CLOCK_FIELDS:
            if not isinstance(pair.get(f), (int, float)) \
                    or isinstance(pair.get(f), bool):
                errors.append(
                    f"{pair_field}.{f} must be a number, "
                    f"got {pair.get(f)!r}")
    event = rec.get("event")
    spec = EVENT_FIELDS.get(event) if isinstance(event, str) else None
    if spec is None:
        errors.append(f"unknown event type {event!r}")
        return errors
    required, _ = spec
    for f in required:
        if f not in rec:
            errors.append(f"{event}: missing required field {f!r}")
    return errors


def validate_stream(records: Iterable[Any]) -> List[str]:
    """Flattened schema errors over a decoded stream, prefixed by index."""
    errors = []
    for i, rec in enumerate(records):
        errors.extend(f"record {i}: {e}" for e in validate_record(rec))
    return errors
