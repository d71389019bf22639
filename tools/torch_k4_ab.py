"""Hold the sphere geometry gradient kernel K4 of this checkout against the K4
of other checkouts on one CUDA GPU: ptxas' register and spill report of
each, the largest gap between their tables against chip_smoke.py's phase-11
bar, and their times in one process.

    python3 tools/torch_k4_ab.py OTHER_ROOT [OTHER_ROOT ...]

An OTHER_ROOT is the root of another checkout (for example a parent commit
unpacked with ``git archive``) holding ``kajo_tpu_torch/csrc/megakernel_geom.cu``
and the headers it includes. Every K4 is built at once with this checkout's
nvcc flags into ``build/k4_ab/`` and fed the same packed scene, cotangent and
parameters (this checkout's ``prepare_pass``): at the gradient path's shape
(``build_test_scene`` 128x96, 16 spp, max_depth 4) and on the 64x48, 4 spp
cases of phase 11 that run K4. Each kernel writes its per-CTA tables into a
zeroed buffer with room for a grid of one CTA per 32 lanes or (lane, sample)
items, summed over the CTAs. The bar
is phase 11's: max|this - other| <= 1e-4 max|other| + 1e-7 per field (cx, cy,
cz together, then r²), and on the mirror cluster, whose gradients span many
decades, per sphere. At the gradient path's shape each is timed with CUDA
events, launch and sum, in the order of the others, this, this, the others
reversed, REPS launches each. The last line is a JSON summary; the exit code
is 1 if a table is outside the bar.
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

REPS = 10
BAR = (1e-4, 1e-7)  # chip_smoke.FIELD_BAR and ROW_BAR


def build(source: Path, name: str) -> tuple[ctypes.CDLL, list[str]]:
    """nvcc ``source`` into build/k4_ab/<name>.so -> (library, ptxas lines)."""
    from kajo_tpu_torch.ops import _nvcc

    out = ROOT / "build" / "k4_ab" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-o", str(out), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines() if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(str(out)), report


def launch(lib: ctypes.CDLL, ps, g, seed: int, n_rows: int):
    """One K4 launch of ``lib`` -> the [S, 4] table (the CTAs' tables summed;
    rows past the kernel's grid stay 0)."""
    import torch

    out = torch.zeros((n_rows, ps.n_spheres, 4), dtype=torch.float32, device=ps.packed.device)
    params = ps.params(seed)
    fn = lib.kajo_geometry_grads
    fn.argtypes = [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    err = fn(ps.packed.data_ptr(), g.data_ptr(), out.data_ptr(), ctypes.addressof(params),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"kajo_geometry_grads launch failed: CUDA error {err}")
    return out.sum(0)


def gap(label: str, name: str, a, b, per_row: bool) -> float:
    """Largest |a - b| over the phase-11 limit built from b (<= 1 passes)."""
    worst = 0.0
    for cols in (slice(0, 3), slice(3, 4)):
        x, y = a[:, cols], b[:, cols]
        scale = y.abs().amax(1, keepdim=True) if per_row else y.abs().max()
        worst = max(worst, ((x - y).abs() / (BAR[0] * scale + BAR[1])).max().item())
    print(f"{label}: this vs {name}: max |diff| {(a - b).abs().max().item():.3e}, max|{name}| "
          f"{b.abs().max().item():.4g}, largest gap / bar {worst:.3e} (<= 1{', per sphere' if per_row else ''})")
    return worst


def main(argv) -> int:
    import torch

    import chip_smoke
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.ops.megakernel import prepare_pass
    from kajo_tpu_torch.ops.megakernel_grad import cotangent_lanes
    from kajo_tpu_torch.scene import parser
    from kajo_tpu_torch.scene.procedural import random_spheres_scene
    from kajo_tpu_torch.scene.testscene import build_mirror_cluster, build_test_scene, build_two_light_scene

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
    sources = {"this": ROOT / "kajo_tpu_torch" / "csrc" / "megakernel_geom.cu"}
    sources.update((o, Path(o).resolve() / "kajo_tpu_torch" / "csrc" / "megakernel_geom.cu") for o in others)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources.values(), [f"k4_{i}" for i in range(len(sources))])))
    for name, (_, report) in built.items():
        for line in report:
            print(f"ptxas {name}: {line}")
    libs = {name: lib for name, (lib, _) in built.items()}

    dev = torch.device("cuda")
    w, h = chip_smoke.GRAD_W, chip_smoke.GRAD_H
    caustics = str(ROOT / "data" / "caustics.json")
    cfg = RenderConfig(max_depth=chip_smoke.GRAD_D)
    main_label = (f"build_test_scene {chip_smoke.INV_W}x{chip_smoke.INV_H} {chip_smoke.INV_SPP}spp depth "
                  f"{chip_smoke.INV_D}")
    cases = [  # (label, scene, width, height, spp, config): phase 11's K4 cases
        (main_label, build_test_scene(chip_smoke.INV_W / chip_smoke.INV_H, dev), chip_smoke.INV_W, chip_smoke.INV_H,
         chip_smoke.INV_SPP, RenderConfig(max_depth=chip_smoke.INV_D)),
        ("caustics 64x48", parser.load(caustics, w / h, dev), w, h, 4, cfg),
        ("scaled.json 64x48", parser.load(str(ROOT / "data" / "scaled.json"), w / h, dev), w, h, 4, cfg),
        ("two-light one_light_nee 64x48", build_two_light_scene(w / h, dev), w, h, 4,
         RenderConfig(max_depth=chip_smoke.GRAD_D, one_light_nee=True)),
        ("caustics full_mis 64x48", parser.load(caustics, w / h, dev), w, h, 4,
         RenderConfig(max_depth=chip_smoke.GRAD_D, full_mis=True)),
        ("random_spheres_scene(200) 64x48", random_spheres_scene(200, seed=5, extent=12.0, n_lights=2,
                                                                 aspect_ratio=w / h, device=dev), w, h, 4, cfg),
        ("mirror cluster 64x48 depth 20", build_mirror_cluster(w / h, dev), w, h, 4, RenderConfig(max_depth=20)),
    ]
    worst_all = 0.0
    gaps = {}
    for label, scene, cw, ch, spp, config in cases:
        ps = prepare_pass(scene, cw, ch, spp, config)
        g = cotangent_lanes(ps, torch.rand((ch, cw, 3), generator=torch.Generator().manual_seed(0)).to(dev))
        # room for any grid of one CTA per 32 or more lanes or (lane, sample) items
        rows = -(-ps.n_lanes * ps.eff // 32)
        a = launch(libs["this"], ps, g, 2024, rows)
        for o in others:
            b = launch(libs[o], ps, g, 2024, rows)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(a).all())
            worst = gap(label, o, a, b, per_row=label.startswith("mirror"))
            gaps[f"{label} vs {o}"] = worst
            if not finite:
                print(f"{label}: this table is not finite")
                worst = float("inf")
            worst_all = max(worst_all, worst)
        if label == main_label:
            timing = (ps, g, rows)

    ps, g, rows = timing
    ms = {name: [] for name in sources}
    order = [*others, "this", "this", *others[::-1]]
    for name in order:
        ms[name].append(chip_smoke.timed(lambda n=name: launch(libs[n], ps, g, 5, rows), REPS))
    print(f"timing {main_label} on {card}, {REPS} launches each (launch and sum), order {', '.join(order)}: "
          + "; ".join(f"{n} " + ", ".join(f"{t:.4f}" for t in v) + " ms" for n, v in ms.items()))
    for o in others:
        print(f"this / {o}: {min(ms['this']) / min(ms[o]):.4f} (best of each)")
    ok = worst_all <= 1.0
    print(json.dumps({"card": card, "within_bar": ok, "gap_over_bar": gaps, "ms": ms,
                      "ptxas": {n: r for n, (_, r) in built.items()}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
