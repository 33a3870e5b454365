"""The port's mesh path on the CPU against the JAX package's.

One gloo world of 4 CPU ranks (torch.multiprocessing, a worker module that
imports no jax: tests/torch_mesh_worker.py) runs every multi-process case
of this file once; the JAX side runs on the conftest's 8 fake devices.
Ported from tests/test_parallel.py and tests/test_pallas.py:

- ``ShardedGMMModel.run_em`` on (4, 1), (2, 2) and (1, 4) meshes at
  float64 against JAX's ``ShardedGMMModel`` on the same mesh and its
  single-device ``GMMModel`` (loglik rtol 1e-9, means 1e-7, N 1e-8: a
  last-bit difference carried through every iteration); K = 3 padded to 4
  over the cluster axis; events that do not fill the data shards;
- ``fit_gmm`` on (2, 2) against JAX's: the same K and merge pairs,
  min_rissanen rtol 1e-8, and the same training envelope on every rank
  (tests/test_torch_envelope.py's bar);
- the cluster-sharded statistics hook ``fused_stats_cuda_sharded`` (K5 +
  collectives + K6, their plain versions on the CPU) at float32, as an
  explicit stats_fn, against JAX's unsharded EM (test_pallas.py's
  ``test_sharded_kernel_*`` tolerances);
- the CLI under ``torch.distributed.run`` on a (2, 2) mesh against the JAX
  CLI on the same mesh: the same K, .summary and .results within 1e-6;
- fleet fits (tenancy/) in 'scan' on (4, 1) and (2, 2): each rank's
  tenants bit-identical to their sharded solo ``fit_gmm`` on that mesh, and
  within 1e-12 of the JAX package's sharded fleet on (2, 2) (the fleets on
  both meshes compute the same function; the (2, 2) one interleaves the
  pad chunks per data shard, tests/test_tenancy.py's sharded case). A
  (2, 1) mesh needs a world of 2 ranks; this world has 4;
- the fused sweep on (4, 1), (2, 2) and (1, 4) (K 6 -> 2, float64)
  against the JAX package's fused sweep on the same mesh and the port's
  one-process fused sweep (tests/test_fused_sweep.py's bars: the same K and
  Ks, min_rissanen rtol 1e-9, means rtol 1e-7 atol 1e-9), with no
  "fused_sweep disabled" line on any rank; on (2, 2) its per-K checkpoints
  (the whole state gathered) and their resume, its profile, and a stop
  asked of one rank that stops all four after the same K. Each fused case
  has a time limit of its own (``run_cases``): a hang fails its tests.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_gmm_mpi_tpu.cli import main as jax_main
from cuda_gmm_mpi_tpu.config import GMMConfig as JConfig
from cuda_gmm_mpi_tpu.models import fit_gmm as j_fit_gmm
from cuda_gmm_mpi_tpu.models.gmm import GMMModel as JModel
from cuda_gmm_mpi_tpu.models.gmm import chunk_events as j_chunk_events
from cuda_gmm_mpi_tpu.ops.formulas import convergence_epsilon
from cuda_gmm_mpi_tpu.ops.seeding import seed_clusters_host
from cuda_gmm_mpi_tpu.parallel import ShardedGMMModel as JSharded
from cuda_gmm_mpi_tpu.parallel.sharded_em import pad_state_clusters as j_pad
from cuda_gmm_mpi_tpu.state import bucket_width as j_bucket_width
from cuda_gmm_mpi_tpu_torch import GMMConfig
from cuda_gmm_mpi_tpu_torch.interop import FIELDS, state_from_numpy, state_to_numpy
from cuda_gmm_mpi_tpu_torch.models.gmm import chunk_events
from cuda_gmm_mpi_tpu_torch.parallel import ShardedGMMModel, make_mesh, pad_state_clusters
from cuda_gmm_mpi_tpu_torch.state import bucket_width

from .conftest import make_blobs
from .test_torch_envelope import hold_envelope
from .torch_mesh_worker import run_cases, spawn_world

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = [(4, 1), (2, 2), (1, 4)]


def _np_state(state):
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def _inputs():
    """Every case's data and seed state, from one seeded generator."""
    rng = np.random.default_rng(1234)
    em = make_blobs(rng, n=1024, d=3, k=4)[0]
    pad = make_blobs(rng, n=512, d=3, k=3)[0]
    uneven = make_blobs(rng, n=700, d=2, k=2)[0]
    fit = make_blobs(rng, n=512, d=2, k=3)[0]
    fleet = [("alpha", _blob(700, 4, 1), 4, 0, None),
             ("beta", _blob(600, 4, 2), 4, 0, 3)]
    k32 = make_blobs(rng, n=1024, d=3, k=5, dtype=np.float32)[0]
    pad32 = make_blobs(rng, n=512, d=3, k=3, dtype=np.float32)[0]
    fused = make_blobs(rng, n=768, d=3, k=3)[0]
    return dict(fused=fused,
        # 700 events in 8 chunks of 128 over 4 data shards: the last shard
        # holds no real event.
        em=(em, 4, 5, 128), pad=(pad, 3, 4, 128), uneven=(uneven, 2, 3, 128),
        fit=fit, k32=(k32, 5, 4, 128), pad32=(pad32, 3, 3, 128),
        fleet=fleet)


def _blob(n, k, seed, d=3):
    """tests/test_tenancy.py's tenant data."""
    r = np.random.default_rng(seed)
    centers = r.normal(scale=8.0, size=(k, d))
    return centers[r.integers(0, k, n)] + r.normal(size=(n, d))


FLEET_CFG = dict(min_iters=4, max_iters=4, chunk_size=128, dtype="float64",
                 sweep_k_buckets="off")
FUSED_CFG = dict(min_iters=4, max_iters=4, chunk_size=128, dtype="float64")
FUSED_K0, FUSED_TARGET, FUSED_LIMIT_S = 6, 2, 120


INPUTS = _inputs()
SHARDED32 = [(m, diag) for m in [(2, 2), (1, 4)] for diag in (False, True)]


def _em_case(name, mesh, **kw):
    data, k, iters, chunk = INPUTS[name]
    dtype = "float32" if data.dtype == np.float32 else "float64"
    state = _np_state(seed_clusters_host(data, k))
    return ("run_em_case", dict(data=data, state_np=state, iters=iters,
                                mesh_shape=mesh, chunk=chunk, dtype=dtype,
                                **kw))


CASES = {
    **{("em", m): _em_case("em", m) for m in MESHES},
    ("pad", (1, 4)): _em_case("pad", (1, 4)),
    ("uneven", (4, 1)): _em_case("uneven", (4, 1)),
    ("fit", (2, 2)): ("fit_case", dict(
        data=INPUTS["fit"], k0=5, target=3, min_iters=3, max_iters=3,
        chunk_size=128, dtype="float64", mesh_shape=(2, 2))),
    **{("k32", m, diag): _em_case("k32", m, diag=diag, stats="sharded")
       for m, diag in SHARDED32},
    ("pad32", (1, 4)): _em_case("pad32", (1, 4), diag=True, stats="sharded"),
    ("collectives",): ("collectives_case", {}),
    **{("fleet", m): ("fleet_case", dict(
        tenants=INPUTS["fleet"], mesh_shape=m, **FLEET_CFG))
       for m in [(4, 1), (2, 2)]},
    ("restarts", (2, 2)): ("fit_case", dict(
        data=INPUTS["fit"], k0=5, target=2, min_iters=3, max_iters=3,
        chunk_size=128, dtype="float64", mesh_shape=(2, 2), n_init=3,
        restart_batch_size=3)),
}


def _fused_case(mesh, **kw):
    return ("fused_fit_case", dict(data=INPUTS["fused"], k0=FUSED_K0,
                                   target=FUSED_TARGET, mesh_shape=mesh,
                                   **FUSED_CFG, **kw), FUSED_LIMIT_S)


# The fused sweep's cases, in this order: a checkpoint directory (relative
# here) lies under the world's directory, and each resume follows its run.
CASES.update({
    **{("fused", m): _fused_case(m) for m in MESHES},
    ("fused", "ck"): _fused_case((2, 2), checkpoint_dir="fused_ck"),
    ("fused", "resume"): _fused_case((2, 2), checkpoint_dir="fused_ck"),
    ("fused", "profile"): _fused_case((2, 2), profile=True),
    ("fused", "stop"): _fused_case((2, 2), checkpoint_dir="fused_stop",
                                   stop_rank=3),
    ("fused", "stop_resume"): _fused_case((2, 2),
                                          checkpoint_dir="fused_stop"),
})


def _in_dir(case, tmp):
    """``case`` with a relative ``checkpoint_dir`` placed under ``tmp``."""
    kw = case[1]
    if "checkpoint_dir" not in kw:
        return case
    return (case[0], dict(kw, checkpoint_dir=str(tmp / kw["checkpoint_dir"])),
            *case[2:])


@pytest.fixture(scope="module")
def world_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("world")


@pytest.fixture(scope="module")
def world(world_dir):
    """{case key: [rank 0 result, ..., rank 3 result]} from one world."""
    keys = list(CASES)
    ranks = spawn_world(run_cases, WORLD, world_dir,
                        [_in_dir(CASES[k], world_dir) for k in keys])
    return {k: [r[i] for r in ranks] for i, k in enumerate(keys)}


def _full_state(results):
    """The mesh's full (padded) state from the ranks of data index 0."""
    row = sorted((r for r in results if r["data_index"] == 0),
                 key=lambda r: r["cluster_index"])
    return {k: np.concatenate([r["state"][k] for r in row]) for k in FIELDS}


def _jax_single(data, k, iters, chunk, dtype="float64", diag=False):
    cfg = JConfig(min_iters=iters, max_iters=iters, chunk_size=chunk,
                  dtype=dtype, diag_only=diag)
    chunks, wts = j_chunk_events(data, chunk)
    s, ll, _ = JModel(cfg).run_em(seed_clusters_host(data, k),
                                  jnp.asarray(chunks), jnp.asarray(wts),
                                  convergence_epsilon(*data.shape))
    return jax.device_get(s), float(ll)


def _jax_sharded(data, k, iters, chunk, mesh):
    cfg = JConfig(min_iters=iters, max_iters=iters, chunk_size=chunk,
                  dtype="float64", mesh_shape=mesh)
    model = JSharded(cfg)
    chunks, wts = j_chunk_events(data, chunk, model.data_size)
    state, chunks, wts = model.prepare(seed_clusters_host(data, k), chunks, wts)
    s, ll, _ = model.run_em(state, chunks, wts,
                            convergence_epsilon(*data.shape))
    return jax.device_get(s), float(ll)


def _same_on_every_rank(results, key="loglik"):
    values = [r[key] for r in results]
    assert all(v == values[0] for v in values), values
    return values[0]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_run_em_matches_jax_float64(world, mesh):
    results = world[("em", mesh)]
    data, k, iters, chunk = INPUTS["em"]
    ll = _same_on_every_rank(results)
    ours = _full_state(results)
    for ref_s, ref_ll in (_jax_sharded(data, k, iters, chunk, mesh),
                          _jax_single(data, k, iters, chunk)):
        np.testing.assert_allclose(ll, ref_ll, rtol=1e-9)
        kp = np.asarray(ref_s.means).shape[0]
        np.testing.assert_allclose(ours["means"][:kp], ref_s.means, rtol=1e-7,
                                   atol=1e-9)
        np.testing.assert_allclose(ours["N"][:kp], ref_s.N, rtol=1e-8)
    assert {r["backend"] for r in results} == {"torch"}
    assert {r["collective"] for r in results} == {"gloo"}


def test_cluster_padding_matches_jax(world):
    """K = 3 over a cluster axis of 4: the padded slot stays inactive."""
    results = world[("pad", (1, 4))]
    data, k, iters, chunk = INPUTS["pad"]
    ll = _same_on_every_rank(results)
    ref_s, ref_ll = _jax_sharded(data, k, iters, chunk, (1, 4))
    np.testing.assert_allclose(ll, ref_ll, rtol=1e-9)
    ours = _full_state(results)
    assert ours["active"][:3].all() and not ours["active"][3:].any()
    np.testing.assert_allclose(ours["means"][:3], np.asarray(ref_s.means)[:3],
                               rtol=1e-7, atol=1e-9)


def test_uneven_events_across_shards_match_jax(world):
    results = world[("uneven", (4, 1))]
    data, k, iters, chunk = INPUTS["uneven"]
    ll = _same_on_every_rank(results)
    ref_s, ref_ll = _jax_single(data, k, iters, chunk)
    np.testing.assert_allclose(ll, ref_ll, rtol=1e-9)
    np.testing.assert_allclose(_full_state(results)["N"][:k], ref_s.N,
                               rtol=1e-9)


def test_fit_gmm_on_a_mesh_matches_jax(world, tmp_path):
    """The whole sweep on (2, 2): gather, merge scan on every rank, the
    rank's rows again, rebucketing to multiples of the cluster axis."""
    results = world[("fit", (2, 2))]
    data = INPUTS["fit"]
    metrics = tmp_path / "jax.jsonl"
    ref = j_fit_gmm(data, 5, 3, config=JConfig(
        min_iters=3, max_iters=3, chunk_size=128, dtype="float64",
        mesh_shape=(2, 2), metrics_file=str(metrics)))
    jax_pairs = [tuple(r["pair"]) for r in map(json.loads,
                                               metrics.read_text().splitlines())
                 if r.get("event") == "merge"]
    for r in results:
        assert r["k"] == ref.ideal_num_clusters
        assert r["merges"] == jax_pairs
        assert [row[0] for row in r["sweep"]] == [5, 4, 3]
        np.testing.assert_allclose(r["min_rissanen"], ref.min_rissanen,
                                   rtol=1e-8)
        np.testing.assert_allclose(r["means"], ref.means, rtol=1e-6, atol=1e-8)
        # The training envelope: each data block sketched once (by the
        # ranks of cluster index 0), merged over the world, on every rank.
        hold_envelope(r["envelope"], ref.envelope)
        assert r["envelope"] == results[0]["envelope"]
    _same_on_every_rank(results, "min_rissanen")


@pytest.mark.parametrize("mesh,diag", SHARDED32,
                         ids=[f"{m[0]}x{m[1]}-{'diag' if d else 'full'}"
                              for m, d in SHARDED32])
def test_sharded_kernel_hook_matches_single(world, mesh, diag):
    """fused_stats_cuda_sharded through real collectives (plain K5/K6 on
    the CPU) == JAX's unsharded float32 EM."""
    results = world[("k32", mesh, diag)]
    data, k, iters, chunk = INPUTS["k32"]
    ll = _same_on_every_rank(results)
    ref_s, ref_ll = _jax_single(data, k, iters, chunk, "float32", diag)
    np.testing.assert_allclose(ll, ref_ll, rtol=1e-5)
    ours = _full_state(results)
    np.testing.assert_allclose(ours["means"][:k], np.asarray(ref_s.means),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(ours["N"][:k], np.asarray(ref_s.N), rtol=1e-4,
                               atol=1e-3)


def test_sharded_kernel_hook_padded_clusters(world):
    """K = 3 over a cluster axis of 4: the all-masked shard contributes
    exactly nothing through the collective log-sum-exp."""
    results = world[("pad32", (1, 4))]
    data, k, iters, chunk = INPUTS["pad32"]
    ll = _same_on_every_rank(results)
    _, ref_ll = _jax_single(data, k, iters, chunk, "float32", True)
    np.testing.assert_allclose(ll, ref_ll, rtol=1e-5)
    ours = _full_state(results)
    assert ours["active"][:3].all() and not ours["active"][3:].any()
    assert ours["N"][3:].max() == 0.0


def test_allgather_host_and_barrier(world):
    for r, out in enumerate(world[("collectives",)]):
        assert (out["rank"], out["world"]) == (r, WORLD)
        assert out["ints"].dtype == np.int32
        np.testing.assert_array_equal(out["ints"], [[i, 10 * i]
                                                    for i in range(WORLD)])
        np.testing.assert_array_equal(
            out["floats"], np.arange(WORLD)[:, None, None] + np.full((2, 2), 0.5))
        assert out["objs"] == [{"rank": i, "x": [0.5] * i}
                               for i in range(WORLD)]


def test_fleet_on_a_mesh_is_solo_bit_identical_and_matches_jax(world):
    from cuda_gmm_mpi_tpu.tenancy import TenantSpec as JTenant
    from cuda_gmm_mpi_tpu.tenancy import fit_fleet as j_fit_fleet

    ref = j_fit_fleet([JTenant(*t) for t in INPUTS["fleet"]],
                      JConfig(mesh_shape=(2, 2), **FLEET_CFG))
    for mesh in [(4, 1), (2, 2)]:
        for rank, out in enumerate(world[("fleet", mesh)]):
            for name, *_ in INPUTS["fleet"]:
                r, j = out[name], ref[name].result
                assert r["bit_identical"], (mesh, rank, name)
                assert r["k"] == j.ideal_num_clusters
                assert [row[0] for row in r["sweep"]] == [
                    row[0] for row in j.sweep_log]
                for a, b in ((r["final_loglik"], j.final_loglik),
                             (r["min_rissanen"], j.min_rissanen),
                             (r["means"], j.means), (r["R"], j.state.R)):
                    b = np.asarray(b)
                    assert (np.abs(np.asarray(a) - b).max()
                            <= 1e-12 * np.abs(b).max()), (mesh, name)


# ------------------------------------------------------- in one process


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_chunk_events_pads_to_the_data_axis_like_jax(shards):
    data = np.random.default_rng(shards).normal(size=(700, 3))
    ours, theirs = chunk_events(data, 64, shards), j_chunk_events(data, 64, shards)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert ours[0].shape[0] % shards == 0


@pytest.mark.parametrize("k,padded,multiple", [
    (5, 8, 1), (5, 8, 2), (3, 4, 4), (9, 16, 4), (2, 6, 3), (1, 4, 2)])
def test_bucket_width_multiple_matches_jax(k, padded, multiple):
    assert (bucket_width(k, padded, multiple=multiple)
            == j_bucket_width(k, padded, multiple=multiple))


def test_pad_state_clusters_matches_jax(rng):
    from .test_torch_ops import make_state_np, to_jax

    s = make_state_np(rng, 3, 2, inactive=(1,))
    ours = state_to_numpy(pad_state_clusters(state_from_numpy(s), 4))
    theirs = j_pad(to_jax(s), 4)
    for name in FIELDS:
        np.testing.assert_array_equal(ours[name], np.asarray(getattr(theirs, name)))


def test_single_process_mesh():
    """Without a torch.distributed world the mesh is one rank; a shape that
    needs more ranks raises."""
    assert make_mesh().shape == (1, 1)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh((2, 2))
    cfg = GMMConfig(device="cpu", dtype="float64", mesh_shape=(1, 1))
    model = ShardedGMMModel(cfg)
    assert model.collective_backend == "none" and model.bucket_multiple == 1
    # The output pass on a gathered state is the single-device one.
    from cuda_gmm_mpi_tpu_torch import GMMModel
    from .test_torch_ops import make_state_np

    rng = np.random.default_rng(3)
    state = state_from_numpy(make_state_np(rng, 3, 2, inactive=(1,)))
    chunks = rng.normal(size=(2, 16, 2))
    np.testing.assert_array_equal(model.memberships(state, chunks),
                                  GMMModel(cfg).memberships(state, chunks))


def test_mesh_with_restarts_matches_one_process(world):
    """n_init > 1 on a (2, 2) mesh (the batched restart loop over each
    rank's events and clusters) picks the winner, K and merge pairs of one
    process's batched restarts, to its loglik within rtol 1e-9."""
    from cuda_gmm_mpi_tpu_torch import fit_gmm

    ref = fit_gmm(INPUTS["fit"], 5, 2, config=GMMConfig(
        device="cpu", min_iters=3, max_iters=3, chunk_size=128,
        dtype="float64", n_init=3, restart_batch_size=3))
    for r in world[("restarts", (2, 2))]:
        assert r["init_index"] == ref.init_index
        assert r["k"] == ref.ideal_num_clusters
        assert r["merges"] == [m[1] for m in ref.merges]
        np.testing.assert_allclose(r["final_loglik"], ref.final_loglik,
                                   rtol=1e-9)


# ------------------------------------------------------------- the CLI


def _numbers(path):
    return np.array([float(v) for v in re.findall(
        r"-?\d+\.\d+(?:[eE][-+]?\d+)?|-?\d+(?:[eE][-+]?\d+)", path.read_text())])


def test_torchrun_cli_on_a_mesh_matches_jax_cli(tmp_path, capsys):
    rng = np.random.default_rng(7)
    c = rng.normal(scale=10, size=(4, 5))
    x = np.concatenate([rng.normal(c[i], 1, (500, 5)) for i in range(4)])
    csv = tmp_path / "events.csv"
    csv.write_text("a,b,c,d,e\n" + "\n".join(
        ",".join(f"{v:.6f}" for v in r) for r in x))
    args = ["8", str(csv), None, "4", "--device=cpu", "--dtype=float64",
            "--min-iters=10", "--max-iters=10", "--mesh=2,2"]
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    ours = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={WORLD}", "-m", "cuda_gmm_mpi_tpu_torch.cli"]
        + [str(tmp_path / "t") if a is None else a for a in args] + ["-v"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert ours.returncode == 0, ours.stderr[-3000:]
    assert "collective backend: gloo" in ours.stdout
    assert ours.stdout.count("Final rissanen score") == 1  # rank 0 prints
    assert jax_main([str(tmp_path / "j") if a is None else a
                     for a in args]) == 0
    capsys.readouterr()
    for ext in (".summary", ".results"):
        a, b = _numbers(tmp_path / ("t" + ext)), _numbers(tmp_path / ("j" + ext))
        assert a.shape == b.shape, ext
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=ext)
    assert (tmp_path / "t.summary").read_text().count("Cluster #") == 4


# ------------------------------------------------------ the fused sweep


def _fused(world, key):
    """The ranks' results of a fused case, which must have ended in time."""
    results = world[("fused", key)]
    for r in results:
        assert "timed_out" not in r, f"case {key} outlived {FUSED_LIMIT_S} s"
    return results


def _hold_fused(r, ref, pairs=None):
    """tests/test_fused_sweep.py's mesh bars between a rank's fused fit
    and a reference fit (and the reference's merge pairs, when it has
    them)."""
    assert r["k"] == ref.ideal_num_clusters
    assert [row[0] for row in r["sweep"]] == [row[0] for row in ref.sweep_log]
    np.testing.assert_allclose(r["min_rissanen"], ref.min_rissanen,
                               rtol=1e-9)
    np.testing.assert_allclose(r["means"], ref.means, rtol=1e-7, atol=1e-9)
    if pairs is not None:
        assert r["merges"] == pairs


@pytest.fixture(scope="module")
def fused_one_process():
    from cuda_gmm_mpi_tpu_torch import fit_gmm

    return fit_gmm(INPUTS["fused"], FUSED_K0, FUSED_TARGET, config=GMMConfig(
        device="cpu", fused_sweep=True, **FUSED_CFG))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_fused_sweep_on_a_mesh_matches_jax_and_one_process(
        world, mesh, fused_one_process):
    """The fused sweep on every mesh layout: K1/K2 per rank on a data-only
    mesh, K5/K6 (their plain versions here) and the gathered order
    reduction on a cluster-sharded one."""
    ref = j_fit_gmm(INPUTS["fused"], FUSED_K0, FUSED_TARGET, config=JConfig(
        fused_sweep=True, mesh_shape=mesh, **FUSED_CFG))
    pairs = [m[1] for m in fused_one_process.merges]
    assert len(pairs) == FUSED_K0 - FUSED_TARGET
    for r in _fused(world, mesh):
        assert not [w for w in r["warnings"] if "fused_sweep disabled" in w]
        _hold_fused(r, ref)
        _hold_fused(r, fused_one_process, pairs)


def test_fused_sweep_on_a_mesh_checkpoints_the_whole_state_and_resumes(
        world, world_dir):
    """Each completed K is a fused checkpoint that holds the whole model
    (the cluster shards gathered), and a second fit on the same directory
    resumes from it to the uninterrupted answer (tests/test_fused_sweep.py
    :78-110)."""
    from cuda_gmm_mpi_tpu_torch.utils.checkpoint import SweepCheckpointer

    first, resumed = _fused(world, "ck"), _fused(world, "resume")
    restored = SweepCheckpointer(str(world_dir / "fused_ck"),
                                 allow_world_change=True).restore()
    assert restored is not None and "fused_log" in restored
    assert restored["state"].means.shape[1] == 3
    assert restored["state"].means.shape[0] >= FUSED_K0
    for a, b in zip(first, resumed):
        assert a["restored"] == [None]
        assert b["restored"] and b["restored"][0] is not None
        assert b["k"] == a["k"] and b["sweep"][-1][0] == a["sweep"][-1][0]
        np.testing.assert_allclose(b["min_rissanen"], a["min_rissanen"],
                                   rtol=1e-9)


def test_fused_sweep_on_a_mesh_profiles_per_k(world):
    for r in _fused(world, "profile"):
        assert r["e_step"] > 0.0 and r["fused_report"]


def test_stop_asked_of_one_rank_stops_every_rank_after_the_same_k(world):
    """Rank 3 alone asks for a stop (a deadline already past): the stop is
    agreed over the world at the first per-K emission, so all four ranks
    stop after that K, each with its checkpoint written, and the resumed
    fit (from that checkpoint, step 0) equals the uninterrupted one."""
    stops = _fused(world, "stop")
    assert [(s["stopped"], s["step"], s["checkpointed"]) for s in stops] == [
        ("PreemptedError", 0, True)] * WORLD
    assert {s["reason"] for s in stops} == {"deadline"}
    for r, ref in zip(_fused(world, "stop_resume"), _fused(world, "ck")):
        assert r["restored"] == [0]
        assert r["k"] == ref["k"] and r["merges"] == ref["merges"]
        assert [row[0] for row in r["sweep"]] == [row[0]
                                                  for row in ref["sweep"]]
        np.testing.assert_allclose(r["min_rissanen"], ref["min_rissanen"],
                                   rtol=1e-9)
