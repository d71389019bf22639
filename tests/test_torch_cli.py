"""Port CLI end to end on the CPU, engine selection, and the port's
independence from jax."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_port import DATA, REPO

from kajo_tpu.utils.image import load_png
from kajo_tpu_torch import cli
from kajo_tpu_torch.models.engine import select_engine
from kajo_tpu_torch.ops import megakernel
from kajo_tpu_torch.scene import parser
from kajo_tpu_torch.scene.procedural import random_spheres_scene

CAUSTICS = os.path.join(DATA, "caustics.json")


def run_cli(args):
    return subprocess.run(
        [sys.executable, "-m", "kajo_tpu_torch.cli", *args],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"),  # one thread per test process, as in torch_port
    )


def test_render_and_save_on_cpu(tmp_path):
    out = tmp_path / "out.png"
    r = run_cli(["--device", "cpu", "-w", "16", "-h", "12", "--spp", "4", "--passes", "2",
                 CAUSTICS, "-o", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    img = load_png(str(out)).astype(np.float64)
    assert img.shape == (12, 16, 4)
    assert np.isfinite(img).all() and img[..., :3].mean() > 0
    assert "samples/s" in r.stderr


def test_checkpoint_resume_and_mismatch(tmp_path):
    out, ck = tmp_path / "c.png", tmp_path / "state.npz"
    base = ["--device", "cpu", "-w", "12", "-h", "8", "--spp", "4", "-o", str(out),
            "--checkpoint", str(ck), CAUSTICS]
    assert cli.main([*base, "--passes", "2"]) == 0
    assert int(np.load(ck)["passes"]) == 2
    assert cli.main([*base, "--passes", "1", "--resume"]) == 0
    assert int(np.load(ck)["passes"]) == 3
    # a different seed is a different render: the checkpoint is refused
    r = run_cli([*base, "--passes", "1", "--resume", "--seed", "9"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "does not match" in r.stderr and "resumed" not in r.stderr
    assert int(np.load(ck)["passes"]) == 1


def test_cuda_device_without_gpu_exits_nonzero(tmp_path):
    out = tmp_path / "never.png"
    r = run_cli(["--device", "cuda", "-w", "8", "-h", "8", "--passes", "1", CAUSTICS, "-o", str(out)])
    assert r.returncode != 0
    assert "CUDA" in r.stderr
    assert not out.exists()


def test_builtin_scene_keeps_kernel_launches_at_zero(tmp_path):
    before = megakernel.kernel_launches
    assert cli.main(["--device", "cpu", "-w", "8", "-h", "6", "--spp", "1", "--passes", "1",
                     "-o", str(tmp_path / "b.png")]) == 0
    assert megakernel.kernel_launches == before == 0


def test_gl_renderer_raises(tmp_path, capsys):
    """-r gl renders the GL estimator through the wavefront; the megakernel,
    which has no GL estimator, still refuses it."""
    with pytest.raises(ValueError, match="gl_semantics"):
        cli.main(["--device", "cpu", "-r", "gl", "--engine", "mega", "-w", "8", "-h", "6", "--passes", "1",
                  CAUSTICS, "-o", str(tmp_path / "g.png")])
    assert cli.main(["--device", "cpu", "-r", "gl", "-w", "8", "-h", "6", "--passes", "1", CAUSTICS,
                     "-o", str(tmp_path / "g.png")]) == 0
    assert "engine: fast" in capsys.readouterr().err


@pytest.mark.parametrize("engine,unknown", [("parity", "integrator-engine")], ids=["parity-integrator"])
def test_unported_engines_name_their_slice(engine, unknown):
    """``parity`` is selected when asked for and never by ``auto``; an
    unknown engine raises. (The name dates from when ``parity`` was the
    last unported engine and had to name its slice; it is kept so that the
    test's history reads on.)"""
    scene = parser.load(CAUSTICS, 1.0, device="cpu")
    assert select_engine(scene) == "fast"
    assert select_engine(scene, engine) == engine
    with pytest.raises(ValueError, match="unknown engine"):
        select_engine(scene, unknown)


def test_cpu_renderer_runs_the_parity_engine(tmp_path):
    """-r cpu renders with the parity engine, one pass per batch, launching
    no kernel."""
    out = tmp_path / "p.png"
    r = run_cli(["--device", "cpu", "-r", "cpu", "-w", "16", "-h", "12", "--spp", "4", "--passes", "2",
                 "--batch", "4", CAUSTICS, "-o", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "engine: parity on cpu" in r.stderr and "pass 1:" in r.stderr and "pass 2:" in r.stderr
    img = load_png(str(out)).astype(np.float64)
    assert img.shape == (12, 16, 4) and np.isfinite(img).all() and img[..., :3].mean() > 0


def test_auto_engine_on_the_cpu_is_fast():
    """The reference's rule: mega only on the accelerator, so a CPU scene
    the megakernel takes runs the wavefront; an explicit mega still runs
    the megakernel's plain version there."""
    scene = parser.load(CAUSTICS, 1.0, device="cpu")
    assert scene.device.type == "cpu" and megakernel.supports(scene)
    assert select_engine(scene) == "fast"
    assert select_engine(scene, "mega") == "mega"


def test_auto_engine_takes_fast_above_the_megakernel():
    small = parser.load(CAUSTICS, 1.0, device="cpu")
    assert select_engine(small, "fast") == "fast"
    big = random_spheres_scene(600, seed=1, extent=10.0, device="cpu")
    assert select_engine(big) == "fast"
    with pytest.raises(ValueError, match="fast engine"):
        select_engine(big, "mega")


def test_procedural_big_scene_through_the_cli(tmp_path):
    """--procedural 1200 streams (above 1024 spheres): the fast engine, the
    plain K5/K6 on the CPU, batches of 8 passes, a finite image."""
    out = tmp_path / "p.png"
    r = run_cli(["--device", "cpu", "--procedural", "1200", "-w", "16", "-h", "12", "--spp", "4", "--depth", "2",
                 "--passes", "2", "-o", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "engine: fast on cpu" in r.stderr and "pass 2:" in r.stderr and "one-light" not in r.stderr
    img = load_png(str(out)).astype(np.float64)
    assert img.shape == (12, 16, 4) and np.isfinite(img).all() and img[..., :3].mean() > 0
    r = run_cli(["--device", "cpu", "--procedural", "5", CAUSTICS, "-o", str(out)])
    assert r.returncode == 2 and "not both" in r.stderr


@pytest.mark.parametrize("shard", [False, True], ids=["one-process", "shard"])
def test_profile_writes_a_chrome_trace(tmp_path, capsys, shard):
    """--profile DIR records the render loop and writes a Chrome trace JSON
    that parses and holds the port's operations (on the CPU: no CUDA
    events); under --shard, one file per rank with the rank in its name,
    and no rate per rank in a group of one."""
    prof = tmp_path / "prof"
    args = ["--device", "cpu", "-w", "16", "-h", "12", "--spp", "4", "--passes", "2", "--depth", "2", CAUSTICS,
            "-o", str(tmp_path / "p.png"), "--profile", str(prof)]
    assert cli.main(args + (["--shard"] if shard else [])) == 0
    err = capsys.readouterr().err
    assert f"profile trace in {prof}" in err and "pass 2:" in err and "ranks x" not in err
    name = "trace.rank0.json" if shard else "trace.json"
    assert sorted(os.listdir(prof)) == [name]
    events = json.loads((prof / name).read_text())["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert {"aten::where", "aten::mul"} <= ops, sorted(ops)[:20]
    assert not any(e.get("cat") in ("kernel", "gpu_memcpy") for e in events)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import kajo_tpu_torch.cli, kajo_tpu_torch.ops.megakernel, kajo_tpu_torch.models.engine\n"
        "import kajo_tpu_torch.scene.parser, kajo_tpu_torch.scene.testscene\n"
        "import kajo_tpu_torch.models.wavefront, kajo_tpu_torch.ops.stream_trace, kajo_tpu_torch.scene.procedural\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if m.startswith('jax'))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
