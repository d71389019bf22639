"""Multi-process rendering of the port (``kajo_tpu_torch.parallel.multihost``)
and the CLI's ``--shard`` and ``--shard-objects``, on the CPU.

As ``tests/test_multihost.py`` checks kajo_tpu: ``initialize`` without a
cluster's environment is a no-op, and two processes that join one gloo group
(``tests/_torch_multihost_worker.py``, a ``file://`` address in ``tmp_path``,
no port) render through ``render_distributed`` what one process renders
unsharded, bit for bit (the wavefront on a dense scene, lanes keyed by their
global id); the CLI's ``--shard`` in that group prints the rate per rank
and writes a profile trace per rank. The module's ``main`` and the CLI's
sharded flags run alone, as a group of one process.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist
from torch_port import DATA, REPO

from kajo_tpu.utils.image import load_png
from kajo_tpu_torch.models.wavefront import render_pass_fast
from kajo_tpu_torch.ops.rng import CounterKey
from kajo_tpu_torch.parallel import multihost
from kajo_tpu_torch.scene import parser

W, H, SPP = 24, 18, 4
CAUSTICS = os.path.join(DATA, "caustics.json")
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def test_initialize_without_environment_is_a_noop(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    multihost.initialize()
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """The two ranks of tests/_torch_multihost_worker.py -> (their output
    directory, each rank's (stdout, stderr))."""
    tmp_path = tmp_path_factory.mktemp("multihost")
    worker = os.path.join(REPO, "tests", "_torch_multihost_worker.py")
    procs = [
        subprocess.Popen([sys.executable, worker, str(r), "2", str(tmp_path / "store"), CAUSTICS, str(W), str(H),
                          str(SPP), str(tmp_path)], env=ENV, cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for r in range(2)
    ]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    return tmp_path, outs


def test_two_process_render_matches_single(two_processes):
    tmp_path, outs = two_processes
    got = np.load(tmp_path / "mh.npy")
    # render_distributed's pass p takes the seed of key.fold_in(p)
    scene = parser.load(CAUSTICS, W / H, "cpu")
    want = render_pass_fast(scene, CounterKey(0).fold_in(0).seed(), W, H, SPP).numpy()
    np.testing.assert_array_equal(got, want)
    assert "2 processes on cpu" in outs[0][0] and "samples/s" in outs[0][0]
    png = load_png(str(tmp_path / "mh.png"))
    assert png.shape == (H, W, 4) and png[..., :3].mean() > 0


def test_two_process_cli_rate_per_rank_and_traces(two_processes):
    """The CLI's --shard over the two ranks: rank 0 prints the pass with
    the rate per rank and the trace's place; each rank writes its own
    trace, which parses and holds the port's operations."""
    tmp_path, outs = two_processes
    err0, err1 = outs[0][1], outs[1][1]
    assert "pass 1:" in err0 and "[2 ranks x " in err0 and "/rank]" in err0, err0[-2000:]
    assert f"profile trace in {tmp_path / 'prof'}" in err0
    assert "pass 1:" not in err1 and "profile trace in" not in err1
    assert sorted(os.listdir(tmp_path / "prof")) == ["trace.rank0.json", "trace.rank1.json"]
    for r in range(2):
        events = json.loads((tmp_path / "prof" / f"trace.rank{r}.json").read_text())["traceEvents"]
        assert any(e.get("cat") == "cpu_op" and e["name"] == "aten::where" for e in events)
    assert load_png(str(tmp_path / "cli.png")).shape == (H, W, 4)


def _run(module, args):
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True, timeout=300,
                          cwd=REPO, env=ENV)


def test_main_alone_is_a_group_of_one(tmp_path):
    out = tmp_path / "one.png"
    r = _run("kajo_tpu_torch.parallel.multihost", [CAUSTICS, "--device", "cpu", "--width", "16", "--height", "12",
                                                    "--spp", "4", "--passes", "1", "--out", str(out)])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "1 processes on cpu" in r.stdout
    assert load_png(str(out)).shape == (12, 16, 4)


def test_cli_shard_and_shard_objects_alone(tmp_path):
    """--shard (the wavefront on the CPU) and --shard-objects render one pass
    a batch as a group of one, a PNG of finite values with a positive mean,
    and --shard equals the unsharded CLI's image."""
    args = ["--device", "cpu", "-w", "16", "-h", "12", "--spp", "4", "--passes", "2", "--depth", "2"]
    images = {}
    for flag in ("--shard", "--shard-objects", None):
        out = tmp_path / f"{flag}.png"
        scene = ["--procedural", "40"] if flag == "--shard-objects" else [CAUSTICS]
        r = _run("kajo_tpu_torch.cli", [*args, *scene, *([flag] if flag else []), "-o", str(out)])
        assert r.returncode == 0, r.stderr[-3000:]
        assert "samples/s" in r.stderr
        if flag:
            assert "pass 1:" in r.stderr and "pass 2:" in r.stderr, r.stderr  # one pass a batch
        img = load_png(str(out)).astype(np.float64)
        assert img.shape == (12, 16, 4) and np.isfinite(img).all() and img[..., :3].mean() > 0
        images[flag] = img
    np.testing.assert_array_equal(images["--shard"], images[None])

