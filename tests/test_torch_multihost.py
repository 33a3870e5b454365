"""The port's mesh path made whole, on the CPU, against the JAX package.

One gloo world of 2 CPU ranks (tests/torch_mesh_worker.py, which imports
no jax) runs every library case of this file once; the CLI cases start
their ranks as processes of their own (``--coordinator file://...``), each
with a timeout, so a hung rank fails its test instead of the suite.
Ported from tests/test_multihost.py and tests/test_preemption.py:

- restarts on a mesh: ``fit_gmm(n_init=4)`` on a (2, 1) mesh (K3 + one
  all_reduce + K4 per iteration on the card; their plain versions here)
  against the JAX package's ``fit_gmm(n_init=4, mesh_shape=(2, 1))`` at
  float64: the same winning init, K and merge pairs, loglik rtol 1e-9; and
  on a (1, 2) mesh (the lanes of the cluster-sharded loop) against the
  port's one-process restart fit;
- ``host_slice``/``host_chunk_bounds`` and the global moments against the
  JAX functions over worlds 1-3 and ragged N, exactly;
- preempt and resume on 2 ranks: a stop armed on ONE rank stops both at
  the same step and iteration, and the resumed fit equals the
  uninterrupted one;
- the ``.results`` parts: assembled through the shared filesystem and
  through the byte gather; the CLI with ``--part-dir`` on (2, 1) and
  (1, 2) meshes byte-identical to the JAX CLI's files;
- liveness: a rank wedged by ``rank_hang`` makes its peer exit 75 within
  ``--peer-timeout`` plus the grace.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from cuda_gmm_mpi_tpu.cli import main as jax_main
from cuda_gmm_mpi_tpu.config import GMMConfig as JConfig
from cuda_gmm_mpi_tpu.models import fit_gmm as j_fit_gmm
from cuda_gmm_mpi_tpu.parallel import distributed as j_dist
from cuda_gmm_mpi_tpu.io import native as j_native
from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm
from cuda_gmm_mpi_tpu_torch.io import native, write_bin
from cuda_gmm_mpi_tpu_torch.parallel import distributed

from .test_torch_cli import native_library, use_native_library  # noqa: F401
from .torch_mesh_worker import run_cases, spawn_world

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
RESTARTS = dict(min_iters=3, max_iters=3, chunk_size=128, dtype="float64",
                n_init=4, restart_batch_size=4)
SUPERVISED = dict(min_iters=6, max_iters=6, chunk_size=128, dtype="float64",
                  preempt_poll_iters=1, sweep_k_buckets="off",
                  mesh_shape=(2, 1))


def _blobs(seed, n, d=3, k=4, spread=6.0):
    rng = np.random.default_rng(seed)
    c = rng.normal(scale=spread, size=(k, d))
    return np.concatenate([rng.normal(c[i], 1, (n // k, d)) for i in range(k)])


RESTART_DATA = _blobs(0, 600)
SUP_DATA = _blobs(1, 700)
MOMENT_DATA = np.random.default_rng(2).normal(size=(1001, 4)) * 3 + 5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """{case key: [rank 0 result, rank 1 result]} from one world."""
    tmp = tmp_path_factory.mktemp("multihost")
    ck = str(tmp / "ck")
    payloads = [b"rank zero\n" * 3, b"one\n" * 11]
    cases = {
        "restarts21": ("fit_case", dict(data=RESTART_DATA, k0=6, target=2,
                                        mesh_shape=(2, 1), **RESTARTS)),
        "restarts12": ("fit_case", dict(data=RESTART_DATA, k0=6, target=2,
                                        mesh_shape=(1, 2), **RESTARTS)),
        "moments": ("moments_case", dict(data=MOMENT_DATA, chunk=64,
                                         data_axis=WORLD)),
        "uninterrupted": ("supervised_fit_case", dict(
            data=SUP_DATA, k0=5, target=2, **SUPERVISED)),
        "preempt": ("supervised_fit_case", dict(
            data=SUP_DATA, k0=5, target=2, checkpoint_dir=ck,
            faults_spec={"preempt": {"iter": 3}}, only_rank=1,
            **SUPERVISED)),
        "resume": ("supervised_fit_case", dict(
            data=SUP_DATA, k0=5, target=2, checkpoint_dir=ck, **SUPERVISED)),
        "shared": ("assemble_case", dict(tmp_dir=str(tmp / "a"),
                                         payloads=payloads, shared=True)),
        "gather": ("assemble_case", dict(tmp_dir=str(tmp / "b"),
                                         payloads=payloads, shared=False)),
    }
    keys = list(cases)
    ranks = spawn_world(run_cases, WORLD, tmp / "world",
                        [cases[k] for k in keys])
    out = {k: [r[i] for r in ranks] for i, k in enumerate(keys)}
    out["payloads"] = payloads
    return out


def test_mesh_restarts_match_jax(world, tmp_path):
    """n_init = 4 on a (2, 1) mesh against the JAX package's batched
    restarts on the same mesh (2 of the 8 fake devices)."""
    metrics = tmp_path / "jax.jsonl"
    ref = j_fit_gmm(RESTART_DATA, 6, 2, config=JConfig(
        mesh_shape=(2, 1), metrics_file=str(metrics), **RESTARTS))
    jax_pairs = [tuple(r["pair"]) for r in map(json.loads,
                                               metrics.read_text().splitlines())
                 if r.get("event") == "merge" and r.get("init") == ref.init_index]
    for pid, r in enumerate(world["restarts21"]):
        assert r["host_range"] == j_dist.host_chunk_bounds(
            RESTART_DATA.shape[0], 128, 2, pid, 2)[:2]
        assert r["init_index"] == ref.init_index
        assert r["k"] == ref.ideal_num_clusters
        assert r["merges"] == jax_pairs
        np.testing.assert_allclose(r["final_loglik"], ref.final_loglik,
                                   rtol=1e-9)
        np.testing.assert_allclose(r["means"], ref.means, rtol=1e-7,
                                   atol=1e-9)


def test_cluster_sharded_mesh_restarts_match_one_process(world):
    """n_init = 4 on a (1, 2) mesh: each lane runs the mesh's own loop; the
    same fit as one process's batched restarts."""
    ref = fit_gmm(RESTART_DATA, 6, 2, config=GMMConfig(device="cpu",
                                                         **RESTARTS))
    for r in world["restarts12"]:
        assert r["init_index"] == ref.init_index
        assert r["k"] == ref.ideal_num_clusters
        assert r["merges"] == [m[1] for m in ref.merges]
        np.testing.assert_allclose(r["final_loglik"], ref.final_loglik,
                                   rtol=1e-9)
        assert r["host_range"] == (0, RESTART_DATA.shape[0])


@pytest.mark.parametrize("world_size", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 127, 1000, 1001, 4099])
def test_host_bounds_and_moments_match_jax(world_size, n):
    """Each rank's slice and the moments from every slice's partials,
    against the JAX package's functions: exactly."""
    data = MOMENT_DATA[:min(n, MOMENT_DATA.shape[0])]
    if n > data.shape[0]:
        data = np.concatenate([data] * (n // data.shape[0] + 1))[:n]
    chunk = 64
    parts = []
    for pid in range(world_size):
        assert distributed.host_slice(n, pid, world_size) == \
            j_dist.host_slice(n, pid, world_size)
        ours = distributed.host_chunk_bounds(n, chunk, world_size, pid,
                                             world_size)
        assert ours == j_dist.host_chunk_bounds(n, chunk, world_size, pid,
                                                world_size)
        start, stop, num = ours
        parts.append(distributed.moment_parts(data[start:stop], chunk, num))
    mean, var = distributed.reduce_moment_parts(np.concatenate(parts))
    total = sum(p.shape[0] for p in parts)
    j_mean, j_var = j_dist.global_moments(data, chunk, total)
    np.testing.assert_array_equal(mean, j_mean)
    np.testing.assert_array_equal(var, j_var)


def test_moments_over_the_process_group_match_jax(world):
    """The same through one all_reduce in the 2-rank world."""
    n = MOMENT_DATA.shape[0]
    j_mean, j_var = j_dist.global_moments(
        MOMENT_DATA, 64, 2 * j_dist.host_chunk_bounds(n, 64, 2, 0, 2)[2])
    for pid, r in enumerate(world["moments"]):
        assert r["bounds"] == j_dist.host_chunk_bounds(n, 64, 2, pid, 2)
        np.testing.assert_array_equal(r["mean"], j_mean)
        np.testing.assert_array_equal(r["var"], j_var)


def test_stop_on_one_rank_stops_every_rank_and_resumes(world):
    """A preempt armed on rank 1 only: both ranks stop at the same step
    and iteration (exit 75 in the CLI), and the resumed fit equals the
    uninterrupted one."""
    stops = world["preempt"]
    assert [s["stopped"] for s in stops] == ["PreemptedError"] * 2
    assert stops[0]["step"] == stops[1]["step"] == 0
    assert stops[0]["em_iter"] == stops[1]["em_iter"] == 3
    assert stops[1]["reason"] == "preempt_injected"
    assert stops[0]["reason"] == "preempt_injected"
    for resumed, ref in zip(world["resume"], world["uninterrupted"]):
        assert resumed["k"] == ref["k"]
        assert resumed["merges"] == ref["merges"]
        assert resumed["final_loglik"] == ref["final_loglik"]
        np.testing.assert_array_equal(resumed["means"], ref["means"])


@pytest.mark.parametrize("case", ["shared", "gather"])
def test_results_parts_assemble_in_rank_order(world, case):
    """The shared-filesystem path and the byte gather (rounds of 7 bytes)
    both give the parts in rank order, and leave no part behind."""
    r0, r1 = world[case]
    assert r0["out"] == b"".join(world["payloads"])
    assert r0["left"] == [] and r1["left"] == []


# ------------------------------------------------------------- the CLI


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
                + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
                **extra)


def run_ranks(world, args, tmp, *, env=None, timeout=240):
    """The port's CLI on ``world`` ranks, each a process of its own; returns
    [(rc, stdout, stderr)] in rank order. A rank that outlives
    ``timeout`` is killed and fails the test."""
    store = tmp / f"store{time.monotonic_ns()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cuda_gmm_mpi_tpu_torch.cli", *args,
         f"--coordinator=file://{store}", f"--num-processes={world}",
         f"--process-id={r}"], cwd=tmp, env=env or _env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.fixture(scope="module")
def bin_file(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    x = _blobs(7, 2000, d=3, spread=10.0).astype(np.float32)
    write_bin(str(tmp / "events.bin"), x)
    return tmp, str(tmp / "events.bin")


@pytest.fixture(scope="module")
def jax_cli_files(bin_file):
    """The JAX CLI's .summary and .results on the BIN file, one process,
    written through the native library: built under the port's lock first,
    and a JAX loader that latched 'unavailable' in this worker (it met a
    library another worker was still building) tries again, as
    ``native_library`` does. A worker whose JAX CLI fell back to the Python
    writer would differ from the ranks' native writer on last-digit ties."""
    import contextlib
    import io

    tmp, infile = bin_file
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(io.StringIO()):
        use_native_library(mp)
        assert jax_main(["6", infile, str(tmp / "j"), "2", *CLI_ARGS]) == 0
        assert j_native.available()
    return {ext: (tmp / f"j{ext}").read_bytes()
            for ext in (".summary", ".results")}


CLI_ARGS = ["--device=cpu", "--dtype=float64", "--min-iters=5",
            "--max-iters=5", "--chunk-size=256"]


@pytest.mark.parametrize("mesh", ["2,1", "1,2"])
def test_cli_part_dir_results_byte_identical_to_jax_cli(bin_file, mesh,
                                                        jax_cli_files,
                                                        native_library):  # noqa: F811
    """Each rank reads its rows, writes the memberships of its own rows as
    a part in --part-dir, and rank 0 assembles them: the .summary and
    .results bytes of the JAX CLI in one process (both through the native
    writer)."""
    assert j_native.available() and native.available()
    tmp, infile = bin_file
    out = tmp / f"t{mesh[0]}"
    ranks = run_ranks(2, ["6", infile, str(out), "2", *CLI_ARGS,
                          f"--mesh={mesh}", f"--part-dir={tmp / 'parts'}"],
                      tmp)
    assert [r[0] for r in ranks] == [0, 0], ranks[0][2][-3000:]
    for ext, want in jax_cli_files.items():
        assert (tmp / f"t{mesh[0]}{ext}").read_bytes() == want, ext
    assert not list((tmp / "parts").glob("*.part*"))


def test_hung_rank_makes_its_peer_exit_75(bin_file):
    """rank_hang wedges rank 1 at EM iteration 3: rank 0 waits in the next
    collective, its watchdog finds rank 1's heartbeat stale after
    --peer-timeout and forces exit 75 after the grace (min(timeout, 30 s)),
    with no hang."""
    tmp, infile = bin_file
    env = _env(GMM_FAULTS=json.dumps({"rank_hang": {"rank": 1, "iter": 3}}))
    store = tmp / "store_hang"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cuda_gmm_mpi_tpu_torch.cli", "6", infile,
         str(tmp / "h"), "2", *CLI_ARGS, f"--checkpoint-dir={tmp / 'ckh'}",
         "--preempt-poll-iters=1", "--peer-timeout=2",
         f"--coordinator=file://{store}", "--num-processes=2",
         f"--process-id={r}"], cwd=tmp, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        t0 = time.monotonic()
        _, err = procs[0].communicate(timeout=120)
        waited = time.monotonic() - t0
        assert procs[0].returncode == 75, err[-3000:]
        assert "heartbeat stale" in err and "forcing exit 75" in err
        assert procs[1].poll() is None  # still wedged
        assert waited < 60
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
