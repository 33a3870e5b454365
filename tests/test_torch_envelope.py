"""The port's training envelope against the JAX package's, on the CPU at
float64: ``GMMResult.envelope`` of the fused sweep and of two batched
restarts equals the JAX fit's (the host sweep's is held in
tests/test_torch_observability.py, on its observed fit): ``num_events``,
the occupancy and the sketch's counts and buckets exactly, its moments
(mean, M2, min, max) to rtol 1e-9 (the two packages' log evidence differ
in the last bits). ``envelope=False`` gives None; the port's sketch
module is the JAX package's (one merge and one drift comparison).

Shapes are those of tests/test_torch_health.py: 2000 x 5 events, K 8 -> 4,
10 iterations, one torch thread.
"""

import numpy as np
import pytest

from cuda_gmm_mpi_tpu.telemetry import sketch as j_sketch
from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm
from cuda_gmm_mpi_tpu_torch.telemetry import sketch as t_sketch

from .test_torch_health import (  # noqa: F401  (fixture)
    FIT, blob_data, both_fits, one_torch_thread,
)

MOMENTS = ("mean", "m2", "min", "max")


def hold_envelope(port, jax):
    """The port's envelope against the JAX package's (module docstring)."""
    assert port is not None and jax is not None
    assert set(port) == set(jax)
    for key in ("version", "k", "num_events", "occupancy"):
        assert port[key] == jax[key], key
    ps, js = port["score"], jax["score"]
    assert set(ps) == set(js)
    for key in ("bounds", "count", "buckets"):
        assert ps[key] == js[key], key
    for key in MOMENTS:
        assert ps[key] == pytest.approx(js[key], rel=1e-9), key
    assert sum(port["occupancy"]) == port["num_events"] == ps["count"]


@pytest.mark.parametrize("path,cfg", [
    ("fused", dict(fused_sweep=True)),
    ("n_init", dict(n_init=2, restart_batch_size=2)),
])
def test_envelope_equals_jax(tmp_path, path, cfg):
    jr, tr, _, te = both_fits(tmp_path, {}, **cfg)
    assert tr.ideal_num_clusters == jr.ideal_num_clusters
    hold_envelope(tr.envelope, jr.envelope)
    assert tr.envelope["num_events"] == 2000
    summaries = [r for r in te if r["event"] == "run_summary"]
    if path == "fused":
        # The fused sweep's run_summary carries it; the batched restarts'
        # per-init summaries do not (nor do the JAX package's).
        assert summaries[-1]["envelope"] == tr.envelope
    else:
        assert all("envelope" not in s for s in summaries)


def test_envelope_off_is_none():
    res = fit_gmm(blob_data(), 6, 4, config=GMMConfig(envelope=False, **FIT))
    assert res.envelope is None


def test_sketch_module_is_the_jax_package_s():
    rng = np.random.default_rng(3)
    parts = [rng.normal(-8.0, 2.0, size=n) for n in (100, 257, 31)]
    occs = [np.bincount(rng.integers(0, 4, p.size), minlength=4)
            for p in parts]
    out = []
    for sk_mod in (j_sketch, t_sketch):
        envs = [sk_mod.make_envelope(sk_mod.StreamSketch().update(p), occ,
                                     k=4, num_events=p.size)
                for p, occ in zip(parts, occs)]
        merged = sk_mod.merge_envelopes(envs + [None])
        window = sk_mod.StreamSketch().update(parts[0] + 1.0)
        out.append((merged, sk_mod.compare_to_envelope(
            merged, window, [10, 20, 30, 40])))
    assert out[0] == out[1]
    assert out[1][0]["num_events"] == 388
