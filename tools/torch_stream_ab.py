"""Hold the streaming trace K5/K6 of this checkout against the K5/K6 of other
checkouts on one CUDA GPU: ptxas' register report of each, their results
bit for bit, and their times in one process.

    python3 tools/torch_stream_ab.py OTHER_ROOT [OTHER_ROOT ...]

An OTHER_ROOT is the root of another checkout (for example a parent commit
unpacked with ``git archive``) holding ``kajo_tpu_torch/csrc/stream_trace.cu``
and the headers it includes. Every K5/K6 library is built at once with this
checkout's nvcc flags into ``build/stream_ab/``. The inputs are the K5 and
K6 calls of one wavefront pass of config 5 (``random_spheres_scene(100_000,
seed=0, extent=60)``, 128x96, 4 spp, depth 2, one-light NEE, rigid),
recorded with this checkout's ``chip_smoke.record_stream_calls``; every
library runs each call, and each call is timed with CUDA events in the
order of the others, this, this, the others reversed, 20 launches each.
The last line is a JSON summary; the exit code is 1 if a result differs
from this checkout's in a bit.
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

REPS = 20


def build(source: Path, name: str) -> tuple[ctypes.CDLL, list[str]]:
    """nvcc ``source`` into build/stream_ab/<name>.so -> (library, ptxas lines)."""
    from kajo_tpu_torch.ops import _nvcc

    out = ROOT / "build" / "stream_ab" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-o", str(out), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
              if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return ctypes.CDLL(str(out)), report


def launch(lib: ctypes.CDLL, kind: str, args):
    """One K5 (kind "nearest") or K6 ("occluded") launch of ``lib`` on a
    recorded call's arguments -> the final t [N] (the bound for K6)."""
    import torch

    if kind == "nearest":
        rigid, o, d, bound, packed, boxes = args
        last = torch.empty((o.shape[0],), dtype=torch.int32, device=o.device)  # the winners
        fn = lib.kajo_stream_nearest
    else:
        rigid, o, d, bound, last, packed, boxes = args  # last: the excluded rows
        fn = lib.kajo_stream_occluded
    t_out = torch.empty((o.shape[0],), dtype=torch.float32, device=o.device)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(o.data_ptr(), d.data_ptr(), bound.data_ptr(), packed.data_ptr(), boxes.data_ptr(), t_out.data_ptr(),
             last.data_ptr(), o.shape[0], packed.shape[0] // 128, int(rigid), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    return (t_out, last) if kind == "nearest" else (t_out,)


def main(argv) -> int:
    import torch

    import chip_smoke
    from kajo_tpu_torch.models import wavefront
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.scene.procedural import random_spheres_scene

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
    sources = {"this": ROOT / "kajo_tpu_torch" / "csrc" / "stream_trace.cu"}
    sources.update((o, Path(o).resolve() / "kajo_tpu_torch" / "csrc" / "stream_trace.cu") for o in others)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources.values(), [f"st_{i}" for i in range(len(sources))])))
    for name, (_, report) in built.items():
        for line in report:
            print(f"ptxas {name}: {line}")
    libs = {name: lib for name, (lib, _) in built.items()}

    w, h, spp = chip_smoke.BIG_W, chip_smoke.BIG_H, chip_smoke.BIG_SPP
    scene = random_spheres_scene(chip_smoke.BIG_N, seed=0, extent=60.0, aspect_ratio=w / h, device=torch.device("cuda"))
    config = RenderConfig(max_depth=chip_smoke.BIG_D, one_light_nee=True)
    _, calls = chip_smoke.record_stream_calls(lambda: wavefront.render_pass_fast(scene, 5, w, h, spp, config))
    same_all = True
    ms = {name: {} for name in sources}
    order = [*others, "this", "this", *others[::-1]]
    for i, (kind, args) in enumerate(calls):
        want = launch(libs["this"], kind, args)
        for o in others:
            got = launch(libs[o], kind, args)
            torch.cuda.synchronize()
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(want, got))
            same_all &= same
            print(f"call {i} {kind} ({args[1].shape[0]} rays): this == {o}'s (bits) {same}")
        for name in order:
            ms[name].setdefault(f"{i} {kind}", []).append(
                chip_smoke.timed(lambda n=name, k=kind, a=args: launch(libs[n], k, a), REPS))
        print(f"timing call {i} {kind} on {card}, {REPS} launches each, order {', '.join(order)}: "
              + "; ".join(f"{n} " + ", ".join(f"{t:.4f}" for t in v[f'{i} {kind}']) + " ms" for n, v in ms.items()))
    print(json.dumps({"card": card, "bit_equal": same_all, "ms": ms, "ptxas": {n: r for n, (_, r) in built.items()}}))
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
