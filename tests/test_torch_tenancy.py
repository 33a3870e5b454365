"""The port's fleet fits (cuda_gmm_mpi_tpu_torch/tenancy/) on the CPU,
against the JAX package's (tests/test_tenancy.py's contracts and sizes).

Every JAX fleet runs once, in a module-scoped fixture, on three tenants
that pack into one group (700, 600 and 900 events at D = 3 in 1,024-event
buckets, K = 4, one with a target K). What is held:

- the port fleet against the JAX fleet at float64, full and diag, 'scan'
  and 'vmap': per tenant the same selected K and merge pairs (the JAX
  side's from its stream's ``merge`` records), loglik, score, means and R
  within 1e-12 relative, the shift and epsilon equal. The port's 'vmap'
  fleets are held to the JAX 'scan' fleets: the JAX package's two modes
  compute the same function and differ in reduction order only (~1e-15),
  and each JAX fleet costs seconds of compilation on one core;
- float32 against the JAX float32 fleet: the same K and merge pairs,
  loglik and score within 1e-6 relative (two float32 evaluations in
  different summation orders, carried through 4 iterations per K);
- 'scan' tenants BIT-IDENTICAL to the port's solo ``fit_gmm`` at
  ``sweep_k_buckets='off'``, full and diag (tests/test_tenancy.py's
  ``assert_tenant_bit_identical``, merges too); default bucketing, a
  non-pow2 K and 'vmap' against solo fits at the JAX test's bounds;
- the tenant states carried across packages (``interop``); packing,
  grouping and the refusals against the JAX package's for data axes 1 and
  2; drop-one, recovery='off', preempt/resume; the stream under both
  schemas and the port's report; ``gmm fleet`` against the JAX CLI;
  ``resolve_fleet_config_ex`` against the JAX resolver;
- K3's per-lane-events form on the CPU: its plain version's lane r equal to
  K1's plain version on lane r's rows, a frozen lane all zeros, and the
  fleet hook's per-lane SuffStats equal to K1's hook on each lane.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu import GMMConfig as JConfig
from cuda_gmm_mpi_tpu.tenancy import TenantSpec as JTenant
from cuda_gmm_mpi_tpu.tenancy import fit_fleet as j_fit_fleet
from cuda_gmm_mpi_tpu.tenancy import pack_group as j_pack_group
from cuda_gmm_mpi_tpu.tenancy import plan_fleet as j_plan_fleet
from cuda_gmm_mpi_tpu_torch import (
    GMMConfig, GMMModel, fit_gmm, health, supervisor,
)
from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy, state_to_numpy
from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
from cuda_gmm_mpi_tpu_torch.state import lane, stack_states
from cuda_gmm_mpi_tpu_torch.tenancy import (
    TenantSpec, fit_fleet, pack_group, plan_fleet, unpack_rows,
)
from cuda_gmm_mpi_tpu_torch.testing import faults

BASE = dict(min_iters=4, max_iters=4, chunk_size=256)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """A fleet fit on the CPU is many small torch ops; with several test
    workers on one host, torch's intra-op pool (a thread per core) spends
    more time waiting on its threads than computing (each small op took
    tens of ms in a six-worker run). One thread here, the worker's count
    restored after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def blob(n, k, seed, d=3):
    r = np.random.default_rng(seed)
    centers = r.normal(scale=8.0, size=(k, d))
    return (centers[r.integers(0, k, n)]
            + r.normal(size=(n, d))).astype(np.float64)


SPECS = [("alpha", blob(700, 4, 1), 4, 0, None),
         ("beta", blob(600, 4, 2), 4, 0, 3),
         ("gamma", blob(900, 4, 3), 4, 2, None)]


def port_tenants(dtype="float64", specs=SPECS):
    return [TenantSpec(n, x.astype(dtype), k, t, s) for n, x, k, t, s in specs]


def jax_tenants(dtype="float64", specs=SPECS):
    return [JTenant(n, x.astype(dtype), k, t, s) for n, x, k, t, s in specs]


def pcfg(**kw):
    return GMMConfig(device="cpu", **dict(BASE, **kw))


def solo_cfg(c, spec):
    return dataclasses.replace(c, seed=c.seed if spec.seed is None
                               else spec.seed)


JAX_RUNS = {
    ("scan", "full", "float64"): dict(sweep_k_buckets="off"),
    ("scan", "diag", "float64"): dict(sweep_k_buckets="off",
                                      covariance_type="diag"),
    ("scan", "full", "float32"): dict(sweep_k_buckets="off",
                                      dtype="float32"),
}


def _merge_pairs(path):
    """{tenant: [pair, ...]} from a fleet stream's merge records."""
    out = {}
    for line in open(path):
        r = json.loads(line)
        if r.get("event") == "merge":
            out.setdefault(r["tenant"], []).append(tuple(r["pair"]))
    return out


@pytest.fixture(scope="module")
def jax_fleets(tmp_path_factory):
    """{(mode, cov, dtype): (JAX FleetResult, {tenant: merge pairs})}."""
    d = tmp_path_factory.mktemp("jax_fleets")
    out = {}
    for key, kw in JAX_RUNS.items():
        path = str(d / ("_".join(key) + ".jsonl"))
        kw = {**BASE, "dtype": "float64", "metrics_file": path, **kw}
        fleet = j_fit_fleet(jax_tenants(kw["dtype"]), JConfig(**kw))
        out[key] = (fleet, _merge_pairs(path))
    return out


@pytest.fixture(scope="module")
def port_fleets():
    """The port's fleets of every compared configuration, once."""
    runs = {
        ("scan", "full", "float64"): pcfg(sweep_k_buckets="off",
                                          dtype="float64"),
        ("scan", "diag", "float64"): pcfg(sweep_k_buckets="off",
                                          dtype="float64",
                                          covariance_type="diag"),
        ("vmap", "full", "float64"): pcfg(sweep_k_buckets="off",
                                          dtype="float64", fleet_mode="vmap"),
        ("vmap", "diag", "float64"): pcfg(sweep_k_buckets="off",
                                          dtype="float64", fleet_mode="vmap",
                                          covariance_type="diag"),
        ("scan", "full", "float32"): pcfg(sweep_k_buckets="off",
                                          dtype="float32"),
    }
    return {key: (fit_fleet(port_tenants(key[2]), c), c)
            for key, c in runs.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("key,jax_key", [
    (("scan", "full", "float64"), ("scan", "full", "float64")),
    (("scan", "diag", "float64"), ("scan", "diag", "float64")),
    (("vmap", "full", "float64"), ("scan", "full", "float64")),
    (("vmap", "diag", "float64"), ("scan", "diag", "float64")),
], ids=["scan-full", "scan-diag", "vmap-full", "vmap-diag"])
def test_fleet_matches_jax_fleet_float64(jax_fleets, port_fleets, key,
                                         jax_key):
    fleet, _ = port_fleets[key]
    jfleet, jpairs = jax_fleets[jax_key]
    assert not fleet.dropped and fleet.mode == key[0]
    assert [g["tenants"] for g in fleet.groups] == [
        g["tenants"] for g in jfleet.groups]
    for name, *_ in SPECS:
        r, j = fleet[name].result, jfleet[name].result
        assert r.ideal_num_clusters == j.ideal_num_clusters
        assert [m[1] for m in r.merges] == jpairs.get(name, [])
        assert [row[0] for row in r.sweep_log] == [
            row[0] for row in j.sweep_log]
        assert [row[3] for row in r.sweep_log] == [
            row[3] for row in j.sweep_log]
        assert _rel(r.final_loglik, j.final_loglik) <= 1e-12
        assert _rel(r.min_rissanen, j.min_rissanen) <= 1e-12
        assert _rel(r.state.means.numpy(), j.state.means) <= 1e-12
        assert _rel(r.state.R.numpy(), j.state.R) <= 1e-12
        np.testing.assert_array_equal(r.data_shift, j.data_shift)
        assert r.epsilon == j.epsilon


def test_fleet_float32_matches_jax_fleet(jax_fleets, port_fleets):
    fleet, _ = port_fleets["scan", "full", "float32"]
    jfleet, jpairs = jax_fleets["scan", "full", "float32"]
    for name, *_ in SPECS:
        r, j = fleet[name].result, jfleet[name].result
        assert r.state.means.dtype == torch.float32
        assert r.ideal_num_clusters == j.ideal_num_clusters
        assert [m[1] for m in r.merges] == jpairs.get(name, [])
        assert _rel(r.final_loglik, j.final_loglik) <= 1e-6
        assert _rel(r.min_rissanen, j.min_rissanen) <= 1e-6
        np.testing.assert_allclose(r.state.means.numpy(),
                                   np.asarray(j.state.means), rtol=1e-4,
                                   atol=1e-4)


def assert_tenant_bit_identical(tr, solo):
    """tests/test_tenancy.py's ladder at 'off': the fitted model, the whole
    per-K trajectory and (the port's GMMResult has them) the merges."""
    r = tr.result
    assert r is not None, tr.error
    assert r.ideal_num_clusters == solo.ideal_num_clusters
    assert r.min_rissanen == solo.min_rissanen
    assert r.final_loglik == solo.final_loglik
    for f in ("means", "R", "N", "pi", "constant"):
        np.testing.assert_array_equal(getattr(r.state, f).numpy(),
                                      getattr(solo.state, f).numpy())
    np.testing.assert_array_equal(r.data_shift, solo.data_shift)
    assert [row[:4] for row in r.sweep_log] == [
        row[:4] for row in solo.sweep_log]
    assert r.merges == solo.merges
    assert r.epsilon == solo.epsilon


@pytest.mark.parametrize("key", [("scan", "full", "float64"),
                                 ("scan", "diag", "float64"),
                                 ("scan", "full", "float32")],
                         ids=["full", "diag", "full-float32"])
def test_fleet_scan_tenants_bit_identical_to_solo_fits(port_fleets, key):
    fleet, c = port_fleets[key]
    for spec in port_tenants(key[2]):
        solo = fit_gmm(spec.data, spec.num_clusters,
                       spec.target_num_clusters, config=solo_cfg(c, spec))
        assert_tenant_bit_identical(fleet[spec.name], solo)


@pytest.mark.parametrize("case", ["default-bucketing", "nonpow2-k", "vmap"])
def test_fleet_tolerance_cases_against_solo_fits(port_fleets, case):
    """tests/test_tenancy.py's tolerance classes: default pow2 bucketing
    (the solo width shrinks below the fleet's), a non-pow2 K (no shared
    width equals the solo's) and 'vmap'."""
    if case == "default-bucketing":
        tenants, c = port_tenants(), pcfg(dtype="float64")
        fleet, bounds = fit_fleet(tenants, c), (1e-12, 1e-9)
    elif case == "nonpow2-k":
        tenants = [TenantSpec("odd", blob(600, 3, 9), 3)]
        c = pcfg(dtype="float64")
        fleet, bounds = fit_fleet(tenants, c), (1e-9, 1e-7)
    else:
        fleet, c = port_fleets["vmap", "full", "float64"]
        tenants, bounds = port_tenants(), (1e-8, 1e-7)
    for spec in tenants:
        solo = fit_gmm(spec.data, spec.num_clusters,
                       spec.target_num_clusters, config=solo_cfg(c, spec))
        r = fleet[spec.name].result
        assert r.ideal_num_clusters == solo.ideal_num_clusters
        np.testing.assert_allclose(r.min_rissanen, solo.min_rissanen,
                                   rtol=bounds[0])
        np.testing.assert_allclose(r.final_loglik, solo.final_loglik,
                                   rtol=bounds[0])
        np.testing.assert_allclose(r.state.means.numpy(),
                                   solo.state.means.numpy(), rtol=bounds[1],
                                   atol=bounds[1])


def test_tenant_states_carry_across_packages(jax_fleets, port_fleets):
    """A JAX tenant's fitted state as numpy -> the port's GMMState
    (interop) equals the port tenant's to 1e-12, field by field, and the
    port state round-trips through numpy bit for bit."""
    fleet, _ = port_fleets["scan", "full", "float64"]
    jfleet, _ = jax_fleets["scan", "full", "float64"]
    for name, *_ in SPECS:
        mine = fleet[name].result.state
        theirs = state_from_numpy(jfleet[name].result.state)
        for f, a in state_to_numpy(theirs).items():
            b = getattr(mine, f).numpy()
            assert a.dtype == b.dtype, f
            if a.dtype == bool:
                np.testing.assert_array_equal(a, b)
            else:
                assert _rel(a, b) <= 1e-12, f
        back = state_from_numpy(state_to_numpy(mine))
        for f, a in state_to_numpy(back).items():
            np.testing.assert_array_equal(a, getattr(mine, f).numpy())


MIXED = [("t1", blob(500, 4, 1), 4, 0, None), ("t2", blob(400, 3, 2), 3, 0, 5),
         ("t3", blob(900, 4, 3), 4, 2, None), ("t4", blob(480, 8, 4), 8, 0, 1)]


@pytest.mark.parametrize("data_axis,cluster_axis", [(1, 1), (2, 2)])
def test_plan_and_pack_equal_the_jax_packages(data_axis, cluster_axis):
    jc = JConfig(dtype="float64", chunk_size=128, seed_method="kmeans++")
    pc = GMMConfig(device="cpu", dtype="float64", chunk_size=128,
                   seed_method="kmeans++")
    groups = plan_fleet(port_tenants(specs=MIXED), pc, data_axis,
                        cluster_axis)
    jgroups = j_plan_fleet(jax_tenants(specs=MIXED), jc, data_axis,
                           cluster_axis)
    assert [dataclasses.astuple(g) for g in groups] == [
        dataclasses.astuple(g) for g in jgroups]
    for g, jg in zip(groups, jgroups):
        p = pack_group(g, port_tenants(specs=MIXED), pc, data_axis)
        j = j_pack_group(jg, jax_tenants(specs=MIXED), jc, data_axis)
        for f in ("chunks", "wts", "epsilons", "shifts", "n_events", "k0",
                  "targets", "solo_chunks"):
            np.testing.assert_array_equal(getattr(p, f), getattr(j, f), f)
        assert p.names == j.names and p.data_axis == j.data_axis
        for mine, theirs in zip(p.states, j.states):
            for f, a in state_to_numpy(state_from_numpy(theirs)).items():
                np.testing.assert_array_equal(getattr(mine, f).numpy(), a)
        for lane_i, i in enumerate(g.indices):
            x = MIXED[i][1]
            want = x - p.shifts[lane_i][None, :]
            np.testing.assert_array_equal(unpack_rows(p, lane_i), want)
            w = p.wts[lane_i].reshape(-1)
            assert int((w != 0).sum()) == int(p.n_events[lane_i])


def test_grouping_caps_and_refusals():
    c = GMMConfig(device="cpu", chunk_size=256)
    tenants = port_tenants(specs=MIXED)
    keys = sorted((g.num_chunks, g.k_bucket, len(g.indices))
                  for g in plan_fleet(tenants, c))
    assert keys == [(2, 4, 2), (2, 8, 1), (4, 4, 1)]
    capped = plan_fleet(tenants, dataclasses.replace(c, fleet_group_size=1))
    assert all(len(g.indices) == 1 for g in capped)
    with pytest.raises(ValueError, match="dimensionality"):
        plan_fleet([TenantSpec("x", blob(100, 2, 1, d=3), 2),
                    TenantSpec("y", blob(100, 2, 1, d=4), 2)], c)
    with pytest.raises(ValueError, match="duplicate"):
        plan_fleet([TenantSpec("x", blob(100, 2, 1), 2),
                    TenantSpec("x", blob(100, 2, 2), 2)], c)
    with pytest.raises(ValueError, match="target_num_clusters"):
        TenantSpec("x", blob(100, 2, 1), 2, target_num_clusters=3)
    spec = [TenantSpec("t", blob(200, 2, 1), 2)]
    for bad, match in [
        (pcfg(stream_events=True), "stream_events"),
        (pcfg(fused_sweep=True), "fused_sweep"),
        (pcfg(n_init=3), "n_init"),
        (pcfg(precompute_features=True), "precompute_features"),
        (pcfg(recovery_reseed_empty=True), "recovery_reseed_empty"),
    ]:
        with pytest.raises(ValueError, match=match):
            fit_fleet(spec, bad)
    with pytest.raises(ValueError, match="fleet_mode"):
        pcfg(fleet_mode="bogus")
    with pytest.raises(ValueError, match="fleet_group_size"):
        pcfg(fleet_group_size=0)
    from cuda_gmm_mpi_tpu_torch.models.streaming import StreamingGMMModel

    assert GMMModel.supports_fleet and not StreamingGMMModel.supports_fleet


def test_frozen_lane_passes_through_untouched():
    c = pcfg(dtype="float64", sweep_k_buckets="off")
    tenants = port_tenants()
    g = plan_fleet(tenants, c)[0]
    p = pack_group(g, tenants, c)
    model = GMMModel(c)
    states = stack_states(p.states)
    chunks, wts = model.prepare_fleet(p.chunks, p.wts)
    for mode in ("scan", "vmap"):
        out, ll, iters = model.run_em_fleet(
            states, chunks, wts, p.epsilons, min_iters=[4, 0, 4],
            max_iters=[4, 0, 4], n_events=p.n_events,
            solo_chunks=p.solo_chunks, mode=mode)
        assert np.isnan(ll[1]) and iters.tolist() == [4, 0, 4]
        for f, a in state_to_numpy(lane(out, 1)).items():
            np.testing.assert_array_equal(a, getattr(p.states[1], f).numpy())
        assert model.last_health.shape == (3, health.NUM_FLAGS)
        assert not model.last_health[1].any()


@pytest.mark.parametrize("mode", ["scan", "vmap"])
def test_drop_one_poisoned_tenant_keeps_survivors(mode):
    """A lane-addressed nan_loglik poisons tenant "b" (lane 1) only: it is
    dropped (drop_tenant), its groupmates equal the clean fleet's."""
    tenants = [TenantSpec(n, blob(512, 4, i + 1), 4)
               for i, n in enumerate("abc")]
    c = pcfg(dtype="float64", fleet_mode=mode)
    clean = fit_fleet(tenants, c)
    assert not clean.dropped
    with faults.use({"nan_loglik": {"iter": 2, "restart": 1}}):
        fleet = fit_fleet(tenants, c)
    assert [t.name for t in fleet.dropped] == ["b"]
    assert "fatal numerical fault" in fleet["b"].error
    for name in ("a", "c"):
        r, want = fleet[name].result, clean[name].result
        assert r.final_loglik == want.final_loglik
        np.testing.assert_array_equal(r.state.means.numpy(),
                                      want.state.means.numpy())


def test_poisoned_tenant_with_recovery_off_raises():
    from cuda_gmm_mpi_tpu_torch.health import NumericalFaultError

    tenants = [TenantSpec("a", blob(512, 4, 1), 4),
               TenantSpec("b", blob(512, 4, 2), 4)]
    with faults.use({"nan_loglik": {"iter": 2, "restart": 0}}):
        with pytest.raises(NumericalFaultError, match=r"tenant\(s\) a "):
            fit_fleet(tenants, pcfg(dtype="float64", recovery="off"))


def test_fleet_preempt_then_bit_identical_resume(tmp_path):
    tenants = port_tenants()[:2]
    ck = tmp_path / "ck"
    want = fit_fleet(tenants, pcfg(dtype="float64"))
    c = pcfg(dtype="float64", checkpoint_dir=str(ck))
    with faults.use({"preempt": {"iter": 2}}):
        with supervisor.use(supervisor.RunSupervisor(install_signals=False)):
            with pytest.raises(supervisor.PreemptedError):
                fit_fleet(tenants, c)
    assert any(p.name.startswith("group") for p in ck.iterdir())
    resumed = fit_fleet(tenants, c)
    for spec in tenants:
        r, w = resumed[spec.name].result, want[spec.name].result
        assert r.final_loglik == w.final_loglik
        assert r.min_rissanen == w.min_rissanen
        assert [row[:4] for row in r.sweep_log] == [
            row[:4] for row in w.sweep_log]
        assert r.merges == w.merges
        for f in ("means", "R"):
            np.testing.assert_array_equal(getattr(r.state, f).numpy(),
                                          getattr(w.state, f).numpy())


def test_fleet_stream_validates_under_both_schemas_and_renders(tmp_path):
    from cuda_gmm_mpi_tpu.telemetry.schema import (
        validate_stream as j_validate,
    )
    from cuda_gmm_mpi_tpu_torch.telemetry import read_stream
    from cuda_gmm_mpi_tpu_torch.telemetry.report import render_report
    from cuda_gmm_mpi_tpu_torch.telemetry.schema import validate_stream

    path = str(tmp_path / "fleet.jsonl")
    fit_fleet(port_tenants()[:2], pcfg(dtype="float64", metrics_file=path))
    recs = read_stream(path)
    assert validate_stream(recs) == [] and j_validate(recs) == []
    kinds = [r["event"] for r in recs]
    assert (kinds.count("fleet_start"), kinds.count("tenant_done"),
            kinds.count("fleet_summary")) == (1, 2, 1)
    done = {r["tenant"]: r for r in recs if r["event"] == "tenant_done"}
    assert set(done) == {"alpha", "beta"}
    assert all(not r["dropped"] and r["k"] >= 1 for r in done.values())
    text = render_report(recs)
    assert "Fleet (rev v1.8" in text and "alpha" in text and "beta" in text


def _write_csv(path, x):
    with open(path, "w") as f:
        f.write(",".join(f"c{i}" for i in range(x.shape[1])) + "\n")
        for row in x:
            f.write(",".join(f"{v:.8f}" for v in row) + "\n")


def _strip(rows):
    drop = ("summary", "envelope")
    return [{k: v for k, v in r.items() if k not in drop} for r in rows]


def test_gmm_fleet_cli_matches_the_jax_cli(tmp_path, capsys, monkeypatch):
    """``gmm fleet`` (--device cpu, float64) against the JAX CLI: each
    tenant's .summary byte-identical, fleet.json's rows equal but for paths
    (loglik and score within 1e-12: the two packages sum in other orders)
    and the wall times, and ``gmm export --fleet`` exporting 2/2 into a
    second registry. Both CLIs run in this process (each package's
    ``cli.main``, what ``python -m`` runs): a JAX interpreter started for
    one fleet costs more than the rest of this file's port side."""
    d = tmp_path
    for i, (n, k) in enumerate([(300, 2), (260, 2)]):
        _write_csv(d / f"t{i}.csv", blob(n, k, i + 1))
    manifest = [
        {"name": "m0", "infile": str(d / "t0.csv"), "num_clusters": 2},
        {"name": "m1", "infile": str(d / "t1.csv"), "num_clusters": 2,
         "seed": 5},
    ]
    (d / "manifest.json").write_text(json.dumps(manifest))
    from cuda_gmm_mpi_tpu_torch.cli import main

    flags = ["--min-iters", "2", "--max-iters", "2", "--chunk-size", "128",
             "--device", "cpu", "--dtype", "float64"]

    def argv(pkg):
        return ["fleet", str(d / "manifest.json"), "--out-dir", str(d / pkg),
                "--registry", str(d / f"{pkg}_reg")] + flags

    from cuda_gmm_mpi_tpu.cli import main as jax_main

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")  # the JAX CLI sets it
    assert jax_main(argv("cuda_gmm_mpi_tpu")) == 0
    assert main(argv("cuda_gmm_mpi_tpu_torch")) == 0
    assert "2/2 tenants fitted" in capsys.readouterr().out
    mine, theirs = (json.loads((d / pkg / "fleet.json").read_text())
                    for pkg in ("cuda_gmm_mpi_tpu_torch", "cuda_gmm_mpi_tpu"))
    for a, b in zip(mine["tenants"], theirs["tenants"]):
        for f in ("loglik", "score"):
            assert _rel(a.pop(f), b.pop(f)) <= 1e-12, f
    assert _strip(mine["tenants"]) == _strip(theirs["tenants"])
    assert mine["mode"] == theirs["mode"] == "scan"
    assert [{k: v for k, v in g.items() if k != "seconds"}
            for g in mine["groups"]] == [
        {k: v for k, v in g.items() if k != "seconds"}
        for g in theirs["groups"]]
    for name in ("m0", "m1"):
        a = (d / "cuda_gmm_mpi_tpu_torch" / f"{name}.summary").read_bytes()
        b = (d / "cuda_gmm_mpi_tpu" / f"{name}.summary").read_bytes()
        assert a == b, name
    assert all(t.get("registry_version") == 1 for t in mine["tenants"])
    assert main(["export", "--registry", str(d / "reg2"), "--fleet",
                 str(d / "cuda_gmm_mpi_tpu_torch"), "--device", "cpu"]) == 0
    assert "2/2 tenants exported" in capsys.readouterr().out


def test_gmm_fleet_cli_exit_codes(tmp_path):
    """A bad manifest exits 1, a missing infile 74 (the JAX CLI's OSError
    path), a bad flag 2; without a GPU and without --device cpu, 1
    (tests/test_torch_isolation.py)."""
    from cuda_gmm_mpi_tpu_torch.cli import main

    (tmp_path / "bad.json").write_text("[]")
    assert main(["fleet", str(tmp_path / "bad.json"), "--device",
                 "cpu"]) == 1
    m = tmp_path / "m.json"
    m.write_text(json.dumps([{"name": "a", "infile": str(tmp_path / "no"),
                              "num_clusters": 2}]))
    assert main(["fleet", str(m), "--device", "cpu"]) == 74
    x = tmp_path / "a.csv"
    _write_csv(x, blob(200, 2, 1))
    m.write_text(json.dumps([{"name": "a", "infile": str(x),
                              "num_clusters": 2}]))
    with pytest.raises(SystemExit) as e:
        main(["fleet", str(m), "--fleet-mode", "bogus"])
    assert e.value.code == 2


def test_resolve_fleet_config_matches_the_jax_resolver(tmp_path):
    from cuda_gmm_mpi_tpu.tuning import (
        resolve_fleet_config_ex as j_resolve,
    )
    from cuda_gmm_mpi_tpu_torch.tuning import (
        TuningDB, TuningKey, resolve_fleet_config_ex,
    )

    path = str(tmp_path / "db.json")
    db = TuningDB(path)
    key = TuningKey.for_shape("cpu", "cpu", 900, 3, 4, "full", "float64")
    db.record(key, "fleet_mode", "vmap", {"wall_per_iter_s": 0.001})
    db.record(key, "fleet_mode", "scan", {"wall_per_iter_s": 0.002})
    db.save()
    kw = dict(dtype="float64", autotune="db", tuning_db=path)
    mine, dec = resolve_fleet_config_ex(GMMConfig(device="cpu", **kw),
                                        900, 3, 4)
    theirs, jdec = j_resolve(JConfig(**kw), 900, 3, 4)
    assert mine.fleet_mode == theirs.fleet_mode == "vmap"
    assert mine.autotune == theirs.autotune == "off"
    assert [(x["knob"], x["chosen"], x["source"]) for x in dec] == [
        (x["knob"], x["chosen"], x["source"]) for x in jdec
        if x["knob"] == "fleet_mode"]
    pinned, dec = resolve_fleet_config_ex(
        GMMConfig(device="cpu", fleet_mode="vmap", **kw), 900, 3, 4)
    assert pinned.fleet_mode == "vmap" and dec == []
    off, dec = resolve_fleet_config_ex(GMMConfig(device="cpu"), 900, 3, 4)
    assert off.autotune == "off" and dec == []


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_k3_per_lane_events_plain_equals_k1_per_lane(diag):
    """K3's per-lane-events form on the CPU (its plain version): lane r is
    torch.equal to K1's plain version on lane r's first n_r rows, a frozen
    lane is all zeros, and the fleet hook gives each lane K1's hook's
    SuffStats on that lane's grid."""
    rng = np.random.default_rng(3)
    R, C, B, d, k = 3, 3, 64, 3, 4
    tenants = [rng.normal(size=(n, d)) for n in (150, 7, 192)]
    chunks = np.zeros((R, C, B, d), np.float32)
    wts = np.zeros((R, C, B), np.float32)
    for r, x in enumerate(tenants):
        chunks[r].reshape(-1, d)[:len(x)] = x
        wts[r].reshape(-1)[:len(x)] = 1.0
    n = torch.tensor([len(x) for x in tenants], dtype=torch.int32)
    states = stack_states([pack_state(rng, k, d) for _ in range(R)])
    params = [fs._prep_params(lane(states, r), d, diag) for r in range(R)]
    A, h, g = (torch.stack(p) for p in zip(*params))
    x_t = torch.as_tensor(chunks).reshape(R, C * B, d)
    w_t = torch.as_tensor(wts).reshape(R, C * B)
    lanes = torch.tensor([1.0, 0.0, 1.0])
    before = fs.fused_stats_fleet.launches
    out = fs.fused_stats_fleet(x_t, w_t, n, lanes, A, h, g, diag=diag)
    assert fs.fused_stats_fleet.launches == before
    for r in (0, 2):
        m = int(n[r])
        one = fs.fused_stats_plain(x_t[r, :m], w_t[r, :m], *params[r],
                                   diag=diag)
        for a, b in zip(out, one):
            assert torch.equal(a[r], b)
    assert all(not a[1].any() for a in out)
    hook = fs.fused_stats_cuda_fleet(states, torch.as_tensor(chunks),
                                     torch.as_tensor(wts), diag_only=diag,
                                     n_events=n)
    for r in range(R):
        one = fs.fused_stats_cuda(lane(states, r), torch.as_tensor(chunks[r]),
                                  torch.as_tensor(wts[r]), diag_only=diag,
                                  n_events=int(n[r]))
        for f in dataclasses.fields(one):
            if f.name != "sanitized":
                assert torch.equal(getattr(hook, f.name)[r],
                                   getattr(one, f.name)), f.name


def pack_state(rng, k, d):
    from cuda_gmm_mpi_tpu_torch.ops.seeding import seed_state_from_parts

    return seed_state_from_parts(rng.normal(size=(k, d)).astype(np.float32),
                                 100, 1.0, k, dtype=np.float32)
