"""Hold the megakernel K1 of this checkout against the K1 of other checkouts
on one CUDA GPU: ptxas' register report of each, their sums bit for bit, and
their times in one process.

    python3 tools/torch_k1_ab.py OTHER_ROOT [OTHER_ROOT ...]

An OTHER_ROOT is the root of another checkout (for example a parent commit
unpacked with ``git archive``, or a copy of this one whose
``kajo_tpu_torch/csrc/`` was edited to a variant) holding
``kajo_tpu_torch/csrc/megakernel.cu`` and the headers it includes. Every K1
is built at once with this checkout's nvcc flags into ``build/k1_ab/``, fed
the same packed scene and parameters (this checkout's ``prepare_pass``) and
compared bit for bit on the cases of chip_smoke.py's phase 3, at the
gradient path's shape (``build_test_scene`` 128x96, 16 spp, max_depth 4),
on K2's two-wave cases of phase 11 (caustics 16x12 at 144 spp, max_depth
3, and 8x6 at 81 spp, max_depth 100) and at the timing shapes. It is timed
with CUDA events in the order of the others, this, this, the others
reversed, REPS launches each, at ``build_test_scene`` 128x96, 192x144,
256x192, 320x240, 384x288 and 512x384, 16 spp, max_depth 4, and caustics
384x288, 16 spp (the sweep that places K1's threshold between a thread a
sample and a thread a lane) and at caustics 512x384, 16 spp (the main
path's shape). The last line is a JSON summary; the exit code is 1 if
one differs from this checkout's in a bit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

REPS = 100


def build(source: Path, name: str) -> tuple[ctypes.CDLL, list[str]]:
    """nvcc ``source`` into build/k1_ab/<name>.so -> (library, ptxas lines)."""
    from kajo_tpu_torch.ops import _nvcc

    out = ROOT / "build" / "k1_ab" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-o", str(out), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines() if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(str(out)), report


def launch(lib: ctypes.CDLL, ps, seed: int):
    import torch

    out = torch.empty((3, ps.n_lanes), dtype=torch.float32, device=ps.packed.device)
    params = ps.params(seed)
    fn = lib.kajo_megakernel
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    err = fn(ps.packed.data_ptr(), out.data_ptr(), ctypes.addressof(params), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"kajo_megakernel launch failed: CUDA error {err}")
    return out


def main(argv) -> int:
    import torch

    import chip_smoke
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.ops.megakernel import prepare_pass
    from kajo_tpu_torch.scene import parser
    from kajo_tpu_torch.scene.testscene import build_test_scene, build_two_light_scene

    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    sys.stdout.reconfigure(line_buffering=True)
    card = chip_smoke.nvidia_smi()
    print(f"card: {card}")
    others = [str(Path(a)) for a in argv]
    sources = {"this": ROOT / "kajo_tpu_torch" / "csrc" / "megakernel.cu"}
    sources.update((o, Path(o).resolve() / "kajo_tpu_torch" / "csrc" / "megakernel.cu") for o in others)
    names = [f"k1_{i}" for i in range(len(sources))]
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources.values(), names)))
    for name, (_, report) in built.items():
        for line in report:
            print(f"ptxas {name}: {line}")
    libs = {name: lib for name, (lib, _) in built.items()}

    dev = torch.device("cuda")
    caustics = str(ROOT / "data" / "caustics.json")
    d4 = RenderConfig(max_depth=4)
    cases = [  # (label, scene, w, h, spp, config, timed)
        ("caustics 64x48 4spp", parser.load(caustics, 64 / 48, dev), 64, 48, 4, RenderConfig(), False),
        ("scaled.json 64x48 4spp", parser.load(str(ROOT / "data" / "scaled.json"), 64 / 48, dev), 64, 48, 4,
         RenderConfig(), False),
        ("two-light one_light_nee 64x48 4spp", build_two_light_scene(64 / 48, dev), 64, 48, 4,
         RenderConfig(one_light_nee=True), False),
        ("caustics full_mis 64x48 4spp", parser.load(caustics, 64 / 48, dev), 64, 48, 4, RenderConfig(full_mis=True),
         False),
        ("caustics 16x12 144spp depth 3 (two waves)", parser.load(caustics, 16 / 12, dev), 16, 12, 144,
         RenderConfig(max_depth=3), False),
        ("caustics 8x6 81spp depth 100 (two waves)", parser.load(caustics, 8 / 6, dev), 8, 6, 81,
         RenderConfig(max_depth=100), False),
        ("build_test_scene 128x96 16spp depth 4 (the gradient path's)", build_test_scene(128 / 96, dev), 128, 96, 16,
         d4, True),
        ("build_test_scene 192x144 16spp depth 4", build_test_scene(192 / 144, dev), 192, 144, 16, d4, True),
        ("build_test_scene 256x192 16spp depth 4", build_test_scene(256 / 192, dev), 256, 192, 16, d4, True),
        ("build_test_scene 320x240 16spp depth 4", build_test_scene(320 / 240, dev), 320, 240, 16, d4, True),
        ("build_test_scene 384x288 16spp depth 4", build_test_scene(384 / 288, dev), 384, 288, 16, d4, True),
        ("build_test_scene 512x384 16spp depth 4", build_test_scene(512 / 384, dev), 512, 384, 16, d4, True),
        ("caustics 384x288 16spp", parser.load(caustics, 384 / 288, dev), 384, 288, 16, RenderConfig(), True),
        ("caustics 512x384 16spp (the main path's)", parser.load(caustics, 512 / 384, dev), 512, 384, 16,
         RenderConfig(), True),
    ]
    same_all = True
    passes = []
    for label, scene, w, h, spp, cfg, is_timed in cases:
        ps = prepare_pass(scene, w, h, spp, cfg)
        a = launch(libs["this"], ps, 99)
        for o in others:
            b = launch(libs[o], ps, 99)
            torch.cuda.synchronize()
            same = torch.equal(a.view(torch.int32), b.view(torch.int32))
            same_all &= same
            print(f"{label}: this K1 == {o}'s (bits) {same}, max |diff| {(a - b).abs().max().item():.3e}")
        if is_timed:
            passes.append((label, ps))

    ms = {}
    order = [*others, "this", "this", *others[::-1]]
    for label, ps in passes:
        times = {name: [] for name in sources}
        for name in order:
            times[name].append(chip_smoke.timed(lambda n=name: launch(libs[n], ps, 99), REPS))
        ms[label] = times
        print(f"timing {label} on {card}, {REPS} launches each, order {', '.join(order)}: "
              + "; ".join(f"{n} " + ", ".join(f"{t:.4f}" for t in v) + " ms" for n, v in times.items()))
        for o in others:
            print(f"{label}: this / {o} {min(times['this']) / min(times[o]):.4f} (best of each)")
    print(json.dumps({"card": card, "bit_equal": same_all, "ms": ms,
                      "ptxas": {n: r for n, (_, r) in built.items()}}))
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
