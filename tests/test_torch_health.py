"""The port's fault containment against the JAX package, on the CPU at
float64: the health lanes, the recovery ladder under an injected
``nan_loglik``, ``recovery='off'`` and an exhausted ladder (exit 70 in both
CLIs), drop-one containment of batched restarts, and the psum-OR parity of
the counters on a cluster-sharded mesh (a (1, 2) mesh of gloo ranks).

Shapes are those of tests/test_torch_cli.py: 2000 x 5 events, K 8 -> 4,
10 iterations. Both packages see the same numpy-seeded inputs; each has its
own fault plan (``testing.faults``), installed with the same spec.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu import health as j_health
from cuda_gmm_mpi_tpu.cli import main as jax_main
from cuda_gmm_mpi_tpu.config import GMMConfig as JConfig
from cuda_gmm_mpi_tpu.models.gmm import GMMModel as JModel
from cuda_gmm_mpi_tpu.models.gmm import chunk_events as j_chunk_events
from cuda_gmm_mpi_tpu.models.order_search import fit_gmm as j_fit
from cuda_gmm_mpi_tpu.ops import mstep as j_mstep
from cuda_gmm_mpi_tpu.testing import faults as j_faults
from cuda_gmm_mpi_tpu_torch import GMMConfig, GMMModel, fit_gmm, health
from cuda_gmm_mpi_tpu_torch.cli import main as torch_main
from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy
from cuda_gmm_mpi_tpu_torch.ops import mstep as t_mstep
from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon
from cuda_gmm_mpi_tpu_torch.testing import faults as t_faults

from .test_torch_cli import ARGS, blob_csv  # noqa: F401  (fixture)
from .test_torch_ops import make_state_np, to_jax
from .torch_mesh_worker import run_cases, spawn_world

# 2048-event chunks: the default 65536 would pad the 2000 events 32-fold.
FIT = dict(device="cpu", dtype="float64", min_iters=10, max_iters=10,
           chunk_size=2048)
CHUNK = "--chunk-size=2048"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tiny fits gain nothing from torch's intra-op threads, and the
    suite's workers share the machine's cores (timing tests among them):
    one thread per module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def blob_data():
    """tests/test_torch_cli.py's 4 blobs (2000 x 5) as float32 rows."""
    rng = np.random.default_rng(7)
    c = rng.normal(scale=10, size=(4, 5))
    return np.concatenate([rng.normal(c[i], 1, (500, 5))
                           for i in range(4)]).astype(np.float32)


def events(path):
    return [json.loads(line) for line in open(path)]


def both_fits(tmp_path, spec, ks=(8, 4), init_means=None, **cfg):
    """The same fit (K ``ks[0]`` -> ``ks[1]``) in both packages under the
    same fault spec; returns (jax result or exception, port result or
    exception, jax events, port events)."""
    out = []
    for name, fit, conf, faults in (("j", j_fit, JConfig, j_faults),
                                    ("t", fit_gmm, GMMConfig, t_faults)):
        metrics = tmp_path / f"{name}.jsonl"
        with faults.use(spec):
            try:
                res = fit(blob_data(), *ks, config=conf(
                    metrics_file=str(metrics), **dict(FIT, **cfg)),
                    init_means=init_means)
            except Exception as e:  # noqa: BLE001 -- compared below
                res = e
        out.append((res, events(metrics)))
    (jr, je), (tr, te) = out
    return jr, tr, je, te


def pick(evs, kind, keys):
    return [tuple(e.get(k) for k in keys) for e in evs if e["event"] == kind]


# ------------------------------------------------------------ the lanes

def _lane_case(case, rng):
    k, d = 5, 3
    s = make_state_np(rng, k, d)
    ll_prev_shift, dyn = 0.0, 1e3
    if case == "nan_mean":
        s["means"][1] = np.nan
    elif case == "empty":
        s["means"][2] = 1e3  # far from every event: Nk < 0.5
    elif case == "dynamic_range":
        s["R"][3] = np.diag([1e4, 1e-3, 1.0])  # ratio 1e7 > 1e3 ** 2
    elif case == "regression":
        ll_prev_shift = 1.0  # the previous loglik 1 above: a drop
    chunks = rng.normal(scale=2.0, size=(3, 64, d))
    wts = np.ones((3, 64))
    return s, chunks, wts, ll_prev_shift, dyn


@pytest.mark.parametrize("case", ["nan_mean", "empty", "dynamic_range",
                                  "regression"])
def test_health_lanes_equal_jax(case, rng):
    s, chunks, wts, shift, dyn = _lane_case(case, rng)
    tol = 0.1
    jst = j_mstep.accumulate_stats(to_jax(s), jnp.asarray(chunks),
                                   jnp.asarray(wts))
    j_counts = (j_health.em_iter_counts(jst.loglik, jst.loglik + shift,
                                        jnp.asarray(tol))
                + j_health.state_counts(to_jax(s), Nk=jst.Nk,
                                        dynamic_range=dyn)
                + jnp.zeros((j_health.NUM_FLAGS,), jnp.int32)
                .at[j_health.SANITIZED_LANES].set(jst.sanitized))
    tst = t_mstep.accumulate_stats(state_from_numpy(s),
                                   torch.as_tensor(chunks),
                                   torch.as_tensor(wts))
    t_counts = health.iteration_counts(
        state_from_numpy(s), tst, tst.loglik, tst.loglik + shift,
        torch.tensor(tol, dtype=torch.float64), dynamic_range=dyn)
    np.testing.assert_array_equal(np.rint(t_counts.numpy()).astype(int),
                                  np.asarray(j_counts))
    assert np.asarray(j_counts).any()  # each case trips a lane
    assert health.pack_word(t_counts.numpy()) == j_health.pack_word(j_counts)


# ------------------------------------------------------- the ladder

@pytest.mark.parametrize("times", [1, 2], ids=["regularize", "centered"])
def test_nan_loglik_retry_equals_jax(tmp_path, times):
    """times=1: the sweep's entry is armed at width 8, so K = 8..5 each
    recover on rung 1; times=2 arms rung 1 too and the fit escalates to
    'centered' (sticky) at K = 8."""
    jr, tr, je, te = both_fits(
        tmp_path, {"nan_loglik": {"iter": 3, "times": times}})
    assert pick(te, "recovery", ("k", "attempt", "action", "outcome",
                                 "flags")) == pick(
        je, "recovery", ("k", "attempt", "action", "outcome", "flags"))
    assert pick(te, "merge", ("k_active", "pair")) == pick(
        je, "merge", ("k_active", "pair"))
    assert tr.ideal_num_clusters == jr.ideal_num_clusters
    assert tr.final_loglik == pytest.approx(jr.final_loglik, rel=1e-12)
    assert tr.health == jr.health
    assert tr.health["recoveries"] >= 1
    if times == 2:
        assert tr.model.config.quad_mode == "centered"


def test_recovery_off_raises_jax_bundle(tmp_path):
    jr, tr, _, _ = both_fits(tmp_path, {"nan_loglik": {"iter": 3}},
                             recovery="off")
    assert isinstance(jr, j_health.NumericalFaultError)
    assert isinstance(tr, health.NumericalFaultError)
    assert tr.bundle == jr.bundle
    assert set(tr.bundle) == {"flags", "flag_names", "counters", "where",
                              "k", "config"}


def test_recovery_exhausted_equals_jax(tmp_path):
    jr, tr, je, te = both_fits(tmp_path, {"nan_loglik": {"iter": 3,
                                                         "times": 3}})
    assert isinstance(tr, health.NumericalFaultError)
    strip = lambda b: {k: v for k, v in b.items() if k != "attempts"}
    assert strip(tr.bundle) == strip(jr.bundle)
    keys = ("attempt", "action", "boost", "flags", "outcome")
    assert ([[a[k] for k in keys] for a in tr.bundle["attempts"]]
            == [[a[k] for k in keys] for a in jr.bundle["attempts"]])
    assert [a["action"] for a in tr.bundle["attempts"]] == [
        "regularize", "centered", "highest"]


def test_cli_rc70_no_model_written(blob_csv, tmp_path, capsys):  # noqa: F811
    argv = lambda out: ["8", blob_csv, str(tmp_path / out), "4"] + ARGS[4:] \
        + ["--recovery=off", CHUNK]
    for main, faults, out in ((jax_main, j_faults, "j"),
                              (torch_main, t_faults, "t")):
        with faults.use({"nan_loglik": {"iter": 3}}):
            assert main(argv(out)) == 70
        err = capsys.readouterr().err
        assert "Numerical fault -- no model written." in err
        assert "nonfinite_loglik" in err
        assert not (tmp_path / (out + ".summary")).exists()


def test_reseed_empty_clusters_equal_jax(tmp_path):
    """``recovery_reseed_empty`` at a target-K fit: two seeds far from every
    event leave two clusters empty, and both packages reseed them from the
    worst-fit events, attempt by attempt."""
    rng = np.random.default_rng(7)
    init = np.concatenate([rng.normal(scale=10, size=(4, 5)),
                           np.full((2, 5), 1e3)])
    jr, tr, je, te = both_fits(tmp_path, {}, ks=(6, 6), init_means=init,
                               recovery_reseed_empty=True)
    keys = ("k", "attempt", "action", "outcome", "flags")
    assert pick(te, "recovery", keys) == pick(je, "recovery", keys)
    assert [a for _, _, a, _, _ in pick(te, "recovery", keys)] == [
        "reseed_empty"] * 3
    assert tr.health == jr.health
    assert tr.final_loglik == pytest.approx(jr.final_loglik, rel=1e-12)


# -------------------------------------------------- batched restarts

def test_batched_restarts_drop_one_equals_jax(tmp_path):
    jr, tr, je, te = both_fits(
        tmp_path, {"nan_loglik": {"iter": 3, "restart": 2}},
        n_init=4, restart_batch_size=4, seed_method="kmeans++")
    js, ts = (next(e for e in ev if e["event"] == "restart_select")
              for ev in (je, te))
    assert ts["dropped"] == js["dropped"] == [2]
    for key in ("winner", "criterion", "mode", "batch_size"):
        assert ts[key] == js[key], key
    assert ts["scores"][2] is js["scores"][2] is None
    np.testing.assert_allclose(
        [x for x in ts["scores"] if x is not None],
        [x for x in js["scores"] if x is not None], rtol=1e-9)
    assert tr.init_index == jr.init_index
    assert tr.ideal_num_clusters == jr.ideal_num_clusters
    assert tr.health["restart_drops"] == jr.health["restart_drops"] == 1
    assert pick(te, "recovery", ("k", "action", "outcome")) == pick(
        je, "recovery", ("k", "action", "outcome"))


# ------------------------------------------------ psum-OR on a mesh

def _mesh_cases(rng):
    """An empty and a dynamic-range cluster (the loop runs on), and a NaN
    mean (fatal at once; every row sanitized on the torch-ops path)."""
    k, d = 6, 3
    data = rng.normal(scale=3.0, size=(400, d))
    runs = make_state_np(rng, k, d)
    runs["means"][2] = 1e3
    runs["R"][4] = np.diag([1e3, 1e-2, 1.0])
    nan = make_state_np(rng, k, d)
    nan["means"][4] = np.nan
    return data, [runs, nan]


def test_mesh_health_counts_equal_single_device(rng, tmp_path):
    data, states = _mesh_cases(rng)
    iters, chunk = 3, 128
    ranks = spawn_world(run_cases, 2, tmp_path, [
        ("run_em_case", dict(data=data, state_np=s, iters=iters,
                             mesh_shape=(1, 2), chunk=chunk))
        for s in states])
    cfg = dict(min_iters=iters, max_iters=iters, chunk_size=chunk,
               dtype="float64")
    chunks, wts = j_chunk_events(data, chunk)
    eps = convergence_epsilon(*data.shape)
    for i, s in enumerate(states):
        model = GMMModel(GMMConfig(device="cpu", **cfg))
        model.run_em(state_from_numpy(s), torch.as_tensor(chunks),
                     torch.as_tensor(wts), eps)
        jmodel = JModel(JConfig(**cfg))
        jmodel.run_em(to_jax(s), jnp.asarray(chunks), jnp.asarray(wts), eps)
        np.testing.assert_array_equal(model.last_health,
                                      np.asarray(jmodel.last_health))
        assert model.last_health.any()
        for r in ranks:
            np.testing.assert_array_equal(r[i]["health"], model.last_health)
