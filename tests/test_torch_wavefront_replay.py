"""Each iteration of the port's wavefront body against kajo_tpu's, run on
the same lane state (``tests/_wavefront_divergence.py``): the scene of
``test_torch_wavefront_stream.py`` (``random_spheres_scene(400, seed=21,
extent=15, n_lights=3)``, 32 x 24, 4 spp, depth 2, key 7), streamed
(threshold 64: the plain K5/K6 against the V4 kernels in interpret mode)
and dense (threshold 1000).

The JAX side runs in subprocesses with the XLA CPU instruction set capped
at SSE4.2, so XLA fuses no multiply-add, and the port is handed kajo_tpu's
camera basis (the float32 inverses of proj @ view differ between LAPACK
builds). Then no lane of any iteration may diverge: every discrete state
(sample, depth, previous object, flags) equal, every float state within
1e-3 of kajo_tpu's relative to the lane's largest component. When a lane
does diverge, the report names the first operation of the body whose
result differs there."""

import json
import os
import subprocess
import sys

import pytest
from torch_port import REPO

CASES = {"streamed": 64, "dense": 1000}


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    out = tmp_path_factory.mktemp("wavefront_replay")
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    script = os.path.join(REPO, "tests", "_wavefront_divergence.py")
    procs = {
        c: subprocess.Popen([sys.executable, script, "--threshold", str(t), "--config", "nee", "--share-camera",
                             "--json", str(out / f"{c}.json")],
                            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c, t in CASES.items()
    }
    logs = {}
    for c, p in procs.items():
        logs[c], _ = p.communicate(timeout=600)
        assert p.returncode == 0, logs[c][-3000:]
    return {c: (json.loads((out / f"{c}.json").read_text()), logs[c]) for c in CASES}


@pytest.mark.parametrize("case", CASES)
def test_replayed_iterations_match_jax(case, reports):
    report, log = reports[case]
    print(log)  # shown by pytest -rP
    assert report["iters"] >= 3
    assert len(report["replay"]) == report["iters"]
    for it, lanes, ops, gap in report["replay"]:
        assert not lanes, f"iteration {it}: {len(lanes)} lanes diverge; first operation that differs: {ops}"
        assert gap <= 1e-3, (it, gap)
