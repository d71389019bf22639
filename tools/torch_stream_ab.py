"""Hold the streaming trace K5/K6 of this checkout against the K5/K6 of other
checkouts on one CUDA GPU: ptxas' register report of each, their results
bit for bit, and their times in one process.

    python3 tools/torch_stream_ab.py OTHER_ROOT [OTHER_ROOT ...]

An OTHER_ROOT is the root of another checkout (for example a parent commit
unpacked with ``git archive``). Its ``kajo_tpu_torch`` package is imported
under another name, and each checkout's K5/K6 run through that checkout's
own wrappers (``ops/stream_trace.py:launch_nearest``, ``launch_occluded``),
which build ``csrc/stream_trace.cu`` into the checkout's ``build/kernels/``,
so whatever a wrapper does around its launch is timed with it. The inputs are the K5 and K6 calls of one wavefront pass of config 5
(``random_spheres_scene(100_000, seed=0, extent=60)``, 128x96, 4 spp, depth
2, one-light NEE), rigid and with ``scale_jitter=0.5``, recorded with this
checkout's ``chip_smoke.record_stream_calls``; every checkout runs each
call (K5 and K6 on the recorded rays, boxes and packed scene, and the
recorded superblocks if its wrapper takes them), and each call is timed with
CUDA events in the order of the others, this, this, the others reversed,
REPS launches each. The last line is a JSON summary; the exit code is 1 if
a result differs from this checkout's in a bit.
"""

from __future__ import annotations

import importlib
import importlib.util
import inspect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

REPS = 20


def load_package(root: Path, alias: str):
    """Import ``root/kajo_tpu_torch`` as the package ``alias`` -> its
    ``ops.stream_trace`` module (the package's imports are relative)."""
    pkg = root / "kajo_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.ops.stream_trace")


def ptxas_report(st) -> list[str]:
    """The register lines of the build log of ``st``'s stream_trace.cu."""
    from_nvcc = importlib.import_module(st.__name__.rsplit(".", 1)[0] + "._nvcc")
    log = from_nvcc.library_path("stream_trace.cu").with_suffix(".log").read_text()
    return [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def launch(st, kind: str, args):
    """One K5 ("nearest") or K6 ("occluded") call through ``st``'s wrapper
    -> its outputs as a tuple. Each gets as many of the recorded arguments
    (K5: rigid, o, d, bound, packed, boxes; K6: rigid, o, d, cut, excl,
    packed, boxes; then the superblocks) as its wrapper takes."""
    fn = st.launch_nearest if kind == "nearest" else st.launch_occluded
    out = fn(*args[:len(inspect.signature(fn).parameters)])
    return tuple(out) if kind == "nearest" else (out,)


def main(argv) -> int:
    import torch

    import chip_smoke
    from kajo_tpu_torch.models import wavefront
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.ops import stream_trace
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
    mods = {"this": stream_trace}
    mods.update((o, load_package(Path(o).resolve(), f"kajo_ab_{i}")) for i, o in enumerate(others))

    w, h, spp = chip_smoke.BIG_W, chip_smoke.BIG_H, chip_smoke.BIG_SPP
    config = RenderConfig(max_depth=chip_smoke.BIG_D, one_light_nee=True)
    same_all = True
    ms = {name: {} for name in mods}
    order = [*others, "this", "this", *others[::-1]]
    for jitter in (0.0, 0.5):
        label = "rigid" if jitter == 0.0 else f"scale_jitter={jitter}"
        scene = random_spheres_scene(chip_smoke.BIG_N, seed=0, extent=60.0, aspect_ratio=w / h, scale_jitter=jitter,
                                     device=torch.device("cuda"))
        _, calls = chip_smoke.record_stream_calls(lambda: wavefront.render_pass_fast(scene, 5, w, h, spp, config))
        for i, (kind, args) in enumerate(calls):
            if kind not in ("nearest", "occluded"):
                continue
            key = f"{label} {i} {kind}"
            want = launch(stream_trace, kind, args)
            for o in others:
                got = launch(mods[o], kind, args)
                torch.cuda.synchronize()
                same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(want, got))
                same_all &= same
                print(f"{key} ({args[1].shape[0]} rays): this == {o}'s (bits) {same}")
            for name in order:
                ms[name].setdefault(key, []).append(
                    chip_smoke.timed(lambda n=name, k=kind, a=args: launch(mods[n], k, a), REPS))
            print(f"timing {key} on {card}, {REPS} launches each, order {', '.join(order)}: "
                  + "; ".join(f"{n} " + ", ".join(f"{t:.4f}" for t in v[key]) + " ms" for n, v in ms.items()))
            for o in others:
                print(f"{key}: this / {o} {min(ms['this'][key]) / min(ms[o][key]):.4f} (best of each)")
    ptxas = {}
    for name, st in mods.items():
        ptxas[name] = ptxas_report(st)
        for line in ptxas[name]:
            print(f"ptxas {name}: {' '.join(line.split())}")
    print(json.dumps({"card": card, "bit_equal": same_all, "ms": ms, "ptxas": ptxas}))
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
