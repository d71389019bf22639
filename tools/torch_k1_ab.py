"""Hold the megakernel K1 of this checkout against the K1 of other checkouts
on one CUDA GPU: ptxas' register report of each, their sums bit for bit, and
their times in one process.

    python3 tools/torch_k1_ab.py OTHER_ROOT [OTHER_ROOT ...]

An OTHER_ROOT is the root of another checkout (for example a parent commit
unpacked with ``git archive``) holding ``kajo_tpu_torch/csrc/megakernel.cu``
and the headers it includes. Every K1 is built at once with this checkout's
nvcc flags into ``build/k1_ab/``, fed the same packed scene and parameters
(this checkout's ``prepare_pass``) on the cases of chip_smoke.py's phase 3
and on caustics at 512x384, 16 spp (the main path's shape), and timed there
with CUDA events in the order of the others, this, this, the others
reversed, 100 launches each. The last line is a JSON summary; the exit code
is 1 if one differs from this checkout's in a bit.
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
    from kajo_tpu_torch.scene.testscene import build_two_light_scene

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
    cases = [
        ("caustics 64x48 4spp", parser.load(caustics, 64 / 48, dev), 64, 48, 4, RenderConfig()),
        ("scaled.json 64x48 4spp", parser.load(str(ROOT / "data" / "scaled.json"), 64 / 48, dev), 64, 48, 4,
         RenderConfig()),
        ("two-light one_light_nee 64x48 4spp", build_two_light_scene(64 / 48, dev), 64, 48, 4,
         RenderConfig(one_light_nee=True)),
        ("caustics full_mis 64x48 4spp", parser.load(caustics, 64 / 48, dev), 64, 48, 4, RenderConfig(full_mis=True)),
        ("caustics 512x384 16spp", parser.load(caustics, 512 / 384, dev), 512, 384, 16, RenderConfig()),
    ]
    same_all = True
    for label, scene, w, h, spp, cfg in cases:
        ps = prepare_pass(scene, w, h, spp, cfg)
        a = launch(libs["this"], ps, 99)
        for o in others:
            b = launch(libs[o], ps, 99)
            torch.cuda.synchronize()
            same = torch.equal(a.view(torch.int32), b.view(torch.int32))
            same_all &= same
            print(f"{label}: this K1 == {o}'s (bits) {same}, max |diff| {(a - b).abs().max().item():.3e}")

    ms = {name: [] for name in sources}
    order = [*others, "this", "this", *others[::-1]]
    for name in order:
        ms[name].append(chip_smoke.timed(lambda n=name: launch(libs[n], ps, 99), REPS))
    print(f"timing caustics 512x384 16spp on {card}, {REPS} launches each, order {', '.join(order)}: "
          + "; ".join(f"{n} " + ", ".join(f"{t:.4f}" for t in v) + " ms" for n, v in ms.items()))
    print(json.dumps({"card": card, "bit_equal": same_all, "ms": ms,
                      "ptxas": {n: r for n, (_, r) in built.items()}}))
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
