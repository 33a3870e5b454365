"""Elastic recovery in the port (parallel/elastic.py, supervisor.py's
ElasticRecovery and LivenessWatchdog) against the JAX package.

The library cases run the JAX package's single-process chaos harness
(tests/test_elastic.py:358-487): a generation-0 membership naming this
process rank 0 of a 2-rank world on paper, and an injected ``rank_lost``
fault. The CLI cases run the arc for real on 2 gloo ranks, each a process
of its own with a timeout: ``rank_lost`` on rank 1 at EM iteration 3 exits
75 on both ranks without ``--elastic``; with it the survivor tears the
process group down, seals generation 1 over itself and finishes at world
1, byte-identical to an uninterrupted run and to one process resumed from
the same emergency checkpoint. Membership, heartbeat and checkpoint files
written by either package are read by the other.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from cuda_gmm_mpi_tpu.models import fit_gmm as j_fit_gmm
from cuda_gmm_mpi_tpu.config import GMMConfig as JConfig
from cuda_gmm_mpi_tpu.parallel import distributed as j_dist
from cuda_gmm_mpi_tpu.parallel import elastic as j_elastic
from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm, supervisor
from cuda_gmm_mpi_tpu_torch.parallel import distributed, elastic
from cuda_gmm_mpi_tpu_torch.supervisor import (
    LivenessWatchdog, PeerLostError, RunSupervisor,
)
from cuda_gmm_mpi_tpu_torch.testing import faults
from cuda_gmm_mpi_tpu_torch.utils import checkpoint as ckpt_mod

from .test_torch_multihost import CLI_ARGS, _blobs, _env, bin_file, run_ranks  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_elastic_state():
    """The overlay and counters are process-wide; never leak them."""
    elastic.reset()
    j_elastic.reset()
    yield
    elastic.reset()
    j_elastic.reset()


def _sup():
    return RunSupervisor(install_signals=False)


def _cfg(ck, **kw):
    base = dict(device="cpu", min_iters=8, max_iters=8, chunk_size=512,
                dtype="float64", checkpoint_dir=ck, preempt_poll_iters=1,
                seed=3, elastic_backoff_s=0.0)
    base.update(kw)
    return GMMConfig(**base)


def _seed_two_hosts(ck):
    """A generation-0 membership naming this process rank 0 of a 2-rank
    world: the single-process chaos harness's world on paper."""
    mdir = elastic.membership_dir(ck)
    elastic.write_membership(
        mdir, elastic.Membership(generation=0, ranks=(0, 1), world_size0=2))
    return mdir


@pytest.fixture
def blobs3():
    rng = np.random.default_rng(11)
    centers = rng.normal(scale=8.0, size=(3, 3))
    return (centers[rng.integers(0, 3, 3000)]
            + rng.normal(size=(3000, 3))).astype(np.float64)


# ------------------------------------------------ files across the packages


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_membership_files_cross_packages(tmp_path, writer):
    """A generation written by either package reads back the same in the
    other, and the announcements of one are counted by the other."""
    w, r = (j_elastic, elastic) if writer == "jax" else (elastic, j_elastic)
    d = str(tmp_path / "membership")
    for g, ranks in ((0, (0, 1, 2, 3)), (2, (0, 3)), (1, (0, 1, 3))):
        w.write_membership(d, w.Membership(generation=g, ranks=ranks,
                                           world_size0=4))
    newest = r.read_membership(d)
    assert (newest.generation, newest.ranks, newest.world_size0) == \
        (2, (0, 3), 4)
    assert r.read_membership(d, generation=1).ranks == (0, 1, 3)
    w.announce_alive(d, 3, 3)
    w.announce_alive(d, 3, 0)
    assert r.announced_ranks(d, 3) == [0, 3]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_heartbeat_files_cross_packages(tmp_path, writer):
    w, r = (j_dist, distributed) if writer == "jax" else (distributed, j_dist)
    hb = str(tmp_path / "heartbeats")
    assert r.read_rank_heartbeat(hb, 1) is None
    w.write_rank_heartbeat(hb, 1)
    assert r.heartbeat_path(hb, 1) == w.heartbeat_path(hb, 1)
    assert r.read_rank_heartbeat(hb, 1) == os.stat(
        w.heartbeat_path(hb, 1)).st_mtime
    # The port's watchdog takes the other package's beat as alive.
    wd = LivenessWatchdog(hb, rank=0, nproc=2, timeout_s=0.3,
                          interval_s=60.0)
    assert wd.check_peers() is None
    time.sleep(0.4)
    assert wd.check_peers()[0] == 1


def test_rendezvous_seals_excludes_and_times_out(tmp_path):
    d = str(tmp_path / "m")
    prev = elastic.Membership(generation=0, ranks=(0, 1, 2), world_size0=3)
    elastic.announce_alive(d, 1, 1)
    sealed = elastic.rendezvous(d, my_rank=0, prev=prev, lost=(2,),
                                window_s=5.0)
    assert sealed.generation == 1 and sealed.ranks == (0, 1)
    assert j_elastic.read_membership(d, generation=1).ranks == (0, 1)
    with pytest.raises(PeerLostError):
        elastic.rendezvous(d, my_rank=2, prev=prev, lost=(2,))
    with pytest.raises(PeerLostError) as ei:
        elastic.rendezvous(str(tmp_path / "m2"), my_rank=1, prev=prev,
                           lost=(2,), window_s=0.2, poll_s=0.02)
    assert ei.value.rank == 0


def test_world_overlay_and_run_summary_section():
    assert elastic.world() == (0, 1) and elastic.run_summary_section() is None
    m = elastic.Membership(generation=2, ranks=(0, 3, 5), world_size0=6)
    elastic.set_world_overlay(m, 3)
    assert elastic.world() == (1, 3) and elastic.original_rank() == 3
    assert elastic.peer_ranks() == [0, 5]
    elastic.note_shrink()
    elastic.note_resume()
    assert elastic.run_summary_section() == {
        "generation": 2, "world_size": 3, "shrinks": 1, "resumes": 1}
    assert elastic.live_gauges() == {"gmm_elastic_generation": 2,
                                     "gmm_elastic_shrinks": 1,
                                     "gmm_elastic_resumes": 1}


def test_checkpoint_world_stamp_and_mismatch_walkback(tmp_path, blobs3):
    """Every step carries the JAX package's world stamp; another world
    without --elastic is an informative CheckpointRestoreError, with it a
    restore."""
    ck = str(tmp_path / "ck")
    with supervisor.use(_sup()):
        fit_gmm(blobs3, 4, 2, config=_cfg(ck, min_iters=3, max_iters=3))
    tree = ckpt_mod.SweepCheckpointer(ck).restore()
    assert int(np.asarray(tree["ckpt_world_size"])) == 1
    assert int(np.asarray(tree["ckpt_generation"])) == 0
    elastic.set_world_overlay(
        elastic.Membership(generation=1, ranks=(0, 1), world_size0=2), 0)
    with pytest.raises(ckpt_mod.CheckpointRestoreError) as ei:
        ckpt_mod.SweepCheckpointer(ck).restore()
    msg = str(ei.value.errors[0][1])
    assert "world size 1" in msg and "2 host(s)" in msg and "--elastic" in msg
    assert ckpt_mod.SweepCheckpointer(
        ck, allow_world_change=True).restore() is not None


def test_collective_timeout_fault_bounds_barrier():
    with faults.use({"collective_timeout": {"rank": 1, "timeout_s": 7.5,
                                            "name": "results_parts"}}):
        distributed.barrier("some_other_barrier")
        with pytest.raises(PeerLostError) as ei:
            distributed.barrier("results_parts")
    assert ei.value.rank == 1 and ei.value.timeout_s == 7.5


# ------------------------------------- the single-process harness (JAX's)


def test_rank_lost_without_elastic_raises_peer_lost(tmp_path, blobs3):
    from cuda_gmm_mpi_tpu_torch.telemetry import read_stream, validate_stream

    ck = str(tmp_path / "ck")
    mf = str(tmp_path / "m.jsonl")
    with pytest.raises(PeerLostError) as ei:
        with faults.use({"rank_lost": {"iter": 3, "rank": 1}}) as plan:
            with supervisor.use(_sup()):
                fit_gmm(blobs3, 6, 2, config=_cfg(ck, metrics_file=mf))
    assert plan.fired["rank_lost"] == 1 and ei.value.rank == 1
    assert [f for f in os.listdir(os.path.join(ck, "sweep"))
            if ".iter" in f] == ["0.iter3.npz"]
    records = read_stream(mf)
    assert validate_stream(records) == []
    kinds = [r["event"] for r in records]
    assert "peer_lost" in kinds and "elastic_shrink" not in kinds


def test_elastic_shrink_and_resume_end_to_end(tmp_path, blobs3):
    """rank_lost mid-sweep with elastic: one fit_gmm call survives the
    loss, and the model equals an uninterrupted run's -- and the JAX
    package's uninterrupted fit of the same config."""
    from cuda_gmm_mpi_tpu_torch.telemetry import read_stream, validate_stream
    from cuda_gmm_mpi_tpu_torch.telemetry.report import render_report

    with supervisor.use(_sup()):
        ref = fit_gmm(blobs3, 6, 2, config=_cfg(str(tmp_path / "ck_ref")))
    ck = str(tmp_path / "ck")
    mdir = _seed_two_hosts(ck)
    mf = str(tmp_path / "m.jsonl")
    with faults.use({"rank_lost": {"iter": 3, "rank": 1}}) as plan:
        with supervisor.use(_sup()):
            res = fit_gmm(blobs3, 6, 2,
                          config=_cfg(ck, elastic=True, metrics_file=mf))
    assert plan.fired["rank_lost"] == 1
    assert res.ideal_num_clusters == ref.ideal_num_clusters
    assert res.min_rissanen == ref.min_rissanen
    assert res.final_loglik == ref.final_loglik
    np.testing.assert_array_equal(res.means, ref.means)
    sealed = j_elastic.read_membership(mdir)
    assert sealed.generation == 1 and sealed.ranks == (0,)
    assert elastic.generation() == 1
    jref = j_fit_gmm(blobs3, 6, 2, config=JConfig(
        min_iters=8, max_iters=8, chunk_size=512, dtype="float64", seed=3))
    assert res.ideal_num_clusters == jref.ideal_num_clusters
    np.testing.assert_allclose(res.final_loglik, jref.final_loglik,
                               rtol=1e-9)
    records = read_stream(mf)
    assert validate_stream(records) == []
    shrink = next(r for r in records if r["event"] == "elastic_shrink")
    assert shrink["generation"] == 1 and shrink["survivors"] == [0]
    assert shrink["world_size"] == 1 and shrink["lost_ranks"] == [1]
    resume = next(r for r in records if r["event"] == "elastic_resume")
    assert resume["generation"] == 1 and resume["attempt"] == 1
    summary = next(r for r in records if r["event"] == "run_summary")
    assert summary["elastic"] == {"generation": 1, "world_size": 1,
                                  "shrinks": 1, "resumes": 1}
    assert "Elastic: generation 1" in render_report(records)


@pytest.mark.parametrize("name,spec", [
    ("mid_em", {"rank_lost": {"iter": 3, "rank": 1}}),
    ("between_k", {"rank_lost": {"where": "sweep", "rank": 1}}),
])
def test_chaos_matrix_rank_lost_sites_resume_identically(tmp_path, name,
                                                         spec):
    data = _blobs(5, 4096, spread=8.0)
    with supervisor.use(_sup()):
        ref = fit_gmm(data, 5, 2, config=_cfg(str(tmp_path / "ck_ref")))
    ck = str(tmp_path / "ck")
    _seed_two_hosts(ck)
    with faults.use(spec) as plan:
        with supervisor.use(_sup()):
            res = fit_gmm(data, 5, 2, config=_cfg(ck, elastic=True))
    assert plan.fired["rank_lost"] == 1
    assert res.ideal_num_clusters == ref.ideal_num_clusters
    assert res.final_loglik == ref.final_loglik
    np.testing.assert_array_equal(res.means, ref.means)
    assert elastic.generation() == 1


def test_elastic_survivor_set_determinism_across_runs(tmp_path, blobs3):
    results = []
    for trial in range(2):
        elastic.reset()
        ck = str(tmp_path / f"ck{trial}")
        mdir = _seed_two_hosts(ck)
        with faults.use({"rank_lost": {"iter": 3, "rank": 1}}):
            with supervisor.use(_sup()):
                res = fit_gmm(blobs3, 6, 2, config=_cfg(ck, elastic=True))
        results.append((elastic.read_membership(mdir), res))
    (m0, r0), (m1, r1) = results
    assert m0 == m1
    assert r0.final_loglik == r1.final_loglik
    np.testing.assert_array_equal(r0.means, r1.means)


def test_elastic_min_hosts_floor_gives_up(tmp_path, blobs3):
    ck = str(tmp_path / "ck")
    _seed_two_hosts(ck)
    with pytest.raises(PeerLostError):
        with faults.use({"rank_lost": {"iter": 3, "rank": 1}}):
            with supervisor.use(_sup()):
                fit_gmm(blobs3, 6, 2,
                        config=_cfg(ck, elastic=True, min_hosts=2))


def test_elastic_retry_budget_exhausts_to_peer_lost(tmp_path, blobs3):
    ck = str(tmp_path / "ck")
    _seed_two_hosts(ck)
    with pytest.raises(PeerLostError):
        with faults.use({"rank_lost": {"where": "sweep", "rank": 1,
                                       "times": 2}}) as plan:
            with supervisor.use(_sup()):
                fit_gmm(blobs3, 6, 2, config=_cfg(
                    ck, elastic=True, elastic_max_retries=1))
    assert plan.fired["rank_lost"] == 2


# ----------------------------------------------- the CLI on 2 real ranks


def test_cli_elastic_requires_checkpoint_dir(bin_file):
    tmp, infile = bin_file
    p = subprocess.run(
        [sys.executable, "-m", "cuda_gmm_mpi_tpu_torch.cli", "2", infile,
         str(tmp / "x"), "2", "--device=cpu", "--elastic"], cwd=tmp,
        env=_env(), capture_output=True, text=True, timeout=120)
    assert p.returncode == 1
    assert "elastic recovery requires checkpoint_dir" in p.stderr


def test_cli_rank_lost_exits_75_or_shrinks_with_elastic(bin_file):
    """rank_lost on rank 1 at EM iteration 3 of the first K, 2 ranks:
    without --elastic both exit 75 (rank 0 with the emergency sub-step);
    with it rank 1 exits 75 and rank 0 finishes at world 1. Its files are
    the uninterrupted run's and those of one process resumed (--elastic
    accepts the world change) from the first run's emergency sub-step."""
    tmp, infile = bin_file
    args = ["6", infile, None, "2", *CLI_ARGS, "--sweep-k-buckets=off",
            "--preempt-poll-iters=1", "--peer-timeout=5"]

    def cmd(out, ck, *extra):
        return [str(tmp / out) if a is None else a for a in args] + [
            f"--checkpoint-dir={tmp / ck}", *extra]

    env = _env(GMM_FAULTS=json.dumps({"rank_lost": {"iter": 3, "rank": 1}}))
    ranks = run_ranks(2, cmd("lost", "ck_lost"), tmp, env=env)
    assert [r[0] for r in ranks] == [75, 75], ranks[0][2][-2000:]
    assert all("Peer lost" in r[2] for r in ranks)
    assert sorted(os.listdir(tmp / "ck_lost" / "sweep")) == ["0.iter3.npz"]
    ranks = run_ranks(2, cmd("el", "ck_el", "--elastic"), tmp, env=env)
    assert [r[0] for r in ranks] == [0, 75], ranks[0][2][-2000:]
    assert "generation 1 sealed with 1/2 host(s) [0]" in ranks[0][2]
    assert j_elastic.read_membership(
        str(tmp / "ck_el" / "membership")).ranks == (0,)

    def single(out, ck, *extra):
        p = subprocess.run(
            [sys.executable, "-m", "cuda_gmm_mpi_tpu_torch.cli",
             *cmd(out, ck, *extra)], cwd=tmp, env=_env(),
            capture_output=True, text=True, timeout=240)
        assert p.returncode == 0, p.stderr[-2000:]
        return p.stderr

    single("ref", "ck_ref")
    assert "resuming INSIDE" in single("res", "ck_lost", "--elastic", "-v")
    for ext in (".summary", ".results"):
        el = (tmp / f"el{ext}").read_bytes()
        assert el == (tmp / f"ref{ext}").read_bytes(), ext
        assert el == (tmp / f"res{ext}").read_bytes(), ext
