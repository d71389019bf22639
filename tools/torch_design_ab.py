"""Hold the nearest-hit design kernels K7 (V1, in its three block orders),
K8 (V2) and K9 (V3) of this checkout against those of other checkouts on
one CUDA GPU: ptxas' register report of each, their results bit for bit,
and their times in one process.

    python3 tools/torch_design_ab.py OTHER_ROOT [OTHER_ROOT ...]
        [--designs v1 v1-frustum v1-near-far v2 v3]

An OTHER_ROOT is the root of another checkout (a parent commit unpacked with
``git archive``, or a copy of ``kajo_tpu_torch/`` with a constant edited).
As in ``tools/torch_stream_ab.py``, its ``kajo_tpu_torch`` is imported under
another name and each checkout's kernel runs through that checkout's own
wrapper (``launch_nearest_v1``, ``launch_nearest_v2``,
``launch_nearest_v3``), building its ``csrc/`` into its own
``build/kernels/`` (all builds started together).
The inputs are the nearest-hit calls of one wavefront pass of config 5
(``random_spheres_scene(100_000, seed=0, extent=60)``, 128x96, 4 spp, depth
2, one-light NEE) under each design, rigid and with ``scale_jitter=0.5``,
recorded with this checkout's ``chip_smoke.record_stream_calls`` (K8's
calls carry the host-built candidate lists, so every checkout gets the same
ones, as K7's calls carry their frustum or near-to-far lists). Every
checkout runs each call, and for K7 also the call's busiest tile alone (the
tile whose vote admitted the most blocks in this checkout's plain version,
its rays and list row), the tail a call waits for; each is timed with CUDA
events in the order of the others, this, this, the others reversed, REPS
launches each. The last line is a JSON summary; the exit code is 1 if a
result differs from this checkout's in a bit.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

REPS = 10
# the source of each design's kernel, by the kind of call it records
SOURCES = {"v1": "stream_trace_v1.cu", "v2": "stream_trace_v2.cu", "v3": "stream_trace_v3.cu"}
DESIGNS = ("v1", "v1-frustum", "v1-near-far", "v2", "v3")


def nvcc_of(st):
    """The ``ops._nvcc`` module beside ``st`` (a checkout's stream_trace)."""
    return importlib.import_module(st.__name__.rsplit(".", 1)[0] + "._nvcc")


def ptxas_report(st, source: str) -> list[str]:
    """The register lines of the build log of ``st``'s csrc/<source>."""
    log = nvcc_of(st).library_path(source).with_suffix(".log").read_text()
    return [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def one_tile(call, tile: int):
    """A recorded K7 call cut to one of its tiles: that tile's rays and,
    for a listed order, its row of the lists."""
    from kajo_tpu_torch.ops.stream_trace import V1_TILE

    rigid, o, d, bound, packed, boxes, order = call
    rays = slice(tile * V1_TILE, (tile + 1) * V1_TILE)
    if order is not None:
        order = tuple(x[tile : tile + 1].contiguous() for x in order)
    return (rigid, *(x[rays].contiguous() for x in (o, d, bound)), packed, boxes, order)


def main(argv) -> int:
    import torch

    import chip_smoke
    from kajo_tpu_torch.models import wavefront
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.ops import stream_trace
    from kajo_tpu_torch.scene.procedural import random_spheres_scene
    from torch_stream_ab import load_package

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--designs", nargs="+", default=["v2", "v3"], choices=DESIGNS)
    parser.add_argument("others", nargs="+", metavar="OTHER_ROOT")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    sys.stdout.reconfigure(line_buffering=True)
    card = chip_smoke.nvidia_smi()
    print(f"card: {card}")
    others = [str(Path(a)) for a in args.others]
    mods = {"this": stream_trace}
    mods.update((o, load_package(Path(o).resolve(), f"kajo_ab_{i}")) for i, o in enumerate(others))
    sources = sorted({SOURCES[d[:2]] for d in args.designs})
    builds = [(st, source) for st in mods.values() for source in sources]
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda b: nvcc_of(b[0]).load_library(b[1]), builds))

    w, h, spp = chip_smoke.BIG_W, chip_smoke.BIG_H, chip_smoke.BIG_SPP
    config = RenderConfig(max_depth=chip_smoke.BIG_D, one_light_nee=True)
    same_all = True
    ms = {name: {} for name in mods}
    order = [*others, "this", "this", *others[::-1]]

    def hold(key, a, kind) -> bool:
        """Each checkout's kernel on the inputs ``a``: bits against this
        checkout's, then the times in turn -> whether all were equal."""
        run = {name: (lambda st=st: getattr(st, f"launch_nearest_{kind}")(*a)) for name, st in mods.items()}
        want, all_same = run["this"](), True
        for o in others:
            got = run[o]()
            torch.cuda.synchronize()
            same = all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(want, got))
            all_same &= same
            print(f"{key} ({a[1].shape[0]} rays): this == {o}'s (bits) {same}")
        for name in order:
            ms[name].setdefault(key, []).append(chip_smoke.timed(run[name], REPS))
        print(f"timing {key} on {card}, {REPS} launches each, order {', '.join(order)}: "
              + "; ".join(f"{n} " + ", ".join(f"{t:.4f}" for t in v[key]) + " ms" for n, v in ms.items()))
        for o in others:
            print(f"{key}: this / {o} {min(ms['this'][key]) / min(ms[o][key]):.4f} (best of each)")
        return all_same

    for jitter in (0.0, 0.5):
        label = "rigid" if jitter == 0.0 else f"scale_jitter={jitter}"
        scene = random_spheres_scene(chip_smoke.BIG_N, seed=0, extent=60.0, aspect_ratio=w / h, scale_jitter=jitter,
                                     device=torch.device("cuda"))
        for design in args.designs:
            with stream_trace.nearest_design(design):
                _, calls = chip_smoke.record_stream_calls(
                    lambda: wavefront.render_pass_fast(scene, 5, w, h, spp, config))
            kind = design[:2]
            calls = [a for k, a in calls if k == kind]
            for i, call in enumerate(calls):
                cases = [(f"{label} {design} call {i}", call)]
                if kind == "v1":  # and the call's busiest tile alone: the tail the call waits for
                    with stream_trace.counting_scans() as scans:
                        stream_trace.nearest_v1_plain(*call)
                    tiles = scans["tiles"]
                    busiest = int(tiles.argmax())
                    cases.append((f"{label} {design} call {i} tile {busiest} alone ({int(tiles[busiest])} of "
                                  f"{tiles.float().mean().item():.1f} blocks on average)", one_tile(call, busiest)))
                for key, a in cases:
                    same_all &= hold(key, a, kind)
    ptxas = {}
    for name, st in mods.items():
        ptxas[name] = [line for source in sources for line in ptxas_report(st, source)]
        for line in ptxas[name]:
            print(f"ptxas {name}: {' '.join(line.split())}")
    print(json.dumps({"card": card, "bit_equal": same_all, "ms": ms, "ptxas": ptxas}))
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
