"""Hold the forward-mode kernel K2 and the material-gradient kernel K3 of this
checkout against those of other checkouts on one CUDA GPU: ptxas' register
and spill report of each, how far their outputs part, and their times in
one process.

    python3 tools/torch_grad_ab.py [--case TEXT] OTHER_ROOT [OTHER_ROOT ...]

An OTHER_ROOT is the root of another checkout (for example a parent commit
unpacked with ``git archive``) holding ``kajo_tpu_torch/csrc/megakernel_jvp.cu``,
``megakernel_grad.cu`` and the headers they include; only ``csrc/`` is read.
Every kernel is built at once with this checkout's nvcc flags into
``build/grad_ab/`` and fed the same packed scene, tangent, cotangent and
parameters (this checkout's ``prepare_pass``), at the gradient path's shape
(``build_test_scene`` 128x96, 16 spp, max_depth 4), at the main path's
(caustics 512x384, 16 spp, ``RenderConfig()``), at 256x192 and 192x144
between them and on chip_smoke.py's 64x48, 4 spp cases of phase 11. K2: its image must equal this checkout's K1 bit for
bit, and the tangents of two K2 may part by a relative L2 gap of at most
1e-4 (chip_smoke.TANGENT_BAR). K3: each writes its per-CTA tables into one
zeroed buffer with room for a CTA per 32 (lane, sample) items, summed over
the CTAs; two tables may part by at most 1e-4 max|other| + 1e-7 per field
(chip_smoke.FIELD_BAR). At the four timing shapes each kernel is timed with
CUDA events over REPS launches into its preallocated buffer, in the order
of the others, this, this, the others reversed. ``--case TEXT`` runs only
the cases whose label holds TEXT (for example ``mirror`` or ``two waves``,
phase 11's K2 cases whose samples go through two waves of the log). Every
kernel is synchronised after its launch, so a fault names its kernel and
checkout (with ``CUDA_LAUNCH_BLOCKING=1`` also the launch). The last line
is a JSON summary; the exit code is 1 if an output is outside its bar.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

REPS = 20
SOURCES = {"K2": ("megakernel_jvp.cu", "kajo_megakernel_jvp"), "K3": ("megakernel_grad.cu", "kajo_material_grads")}


def build(source: Path, name: str) -> tuple[ctypes.CDLL, list[str]]:
    """nvcc ``source`` into build/grad_ab/<name>.so -> (library, ptxas lines)."""
    from kajo_tpu_torch.ops import _nvcc

    out = ROOT / "build" / "grad_ab" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-o", str(out), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines() if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(str(out)), report


def call(lib: ctypes.CDLL, symbol: str, tensors, params) -> None:
    import torch

    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * (len(tensors) + 2)
    fn.restype = ctypes.c_int
    err = fn(*(t.data_ptr() for t in tensors), ctypes.addressof(params), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")


@dataclasses.dataclass
class Case:
    """One pass's inputs, shared by every checkout's kernels, and the
    output buffers each kernel writes."""

    label: str
    ps: object  # MegaPass (K2's, regen_threshold as configured)
    ps3: object  # K3's: regen_threshold 0, as material_grads passes it
    packed_dot: object
    g: object

    def k2(self, lib, out) -> None:
        call(lib, SOURCES["K2"][1], (self.ps.packed, self.packed_dot, out), self.ps.params(2024))

    def k3(self, lib, out) -> None:
        call(lib, SOURCES["K3"][1], (self.ps3.packed, self.g, out), self.ps3.params(2024))


def make_case(label, scene, w, h, spp, config):
    import torch

    from kajo_tpu_torch.ops import megakernel
    from kajo_tpu_torch.ops.megakernel_grad import cotangent_lanes

    tan = megakernel.scene_zero_tangent(scene)
    tan.sphere_transform[0, 0, 3] = 1.0
    tan.sphere_transform[1, 0, 3] = 1.0
    tan.sphere_radius[1] = 1.0
    tan.materials.diffuse[0, 1] = 1.0
    ps, packed_dot = megakernel.prepare_pass_jvp(scene, tan, w, h, spp, config)
    ps3 = megakernel.prepare_pass(scene, w, h, spp, dataclasses.replace(config, regen_threshold=0.0))
    g = cotangent_lanes(ps, torch.rand((h, w, 3), generator=torch.Generator().manual_seed(0)).to(scene.device))
    return Case(label, ps, ps3, packed_dot, g)


def main(argv) -> int:
    import torch

    import chip_smoke
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.ops import megakernel
    from kajo_tpu_torch.scene import parser
    from kajo_tpu_torch.scene.procedural import random_spheres_scene
    from kajo_tpu_torch.scene.testscene import build_mirror_cluster, build_test_scene, build_two_light_scene

    only = None
    if argv[:1] == ["--case"]:
        only, argv = argv[1], argv[2:]
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
    roots = {"this": ROOT, **{o: Path(o).resolve() for o in others}}
    jobs = [(k, name, root / "kajo_tpu_torch" / "csrc" / SOURCES[k][0])
            for k in SOURCES for name, root in roots.items()]

    def build_job(job):
        k, name, source = job
        try:
            return build(source, f"{k}_{list(roots).index(name)}")
        except RuntimeError as err:
            return None, [f"build failed: {err}"]

    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(build_job, jobs))
    libs = {}
    ptxas = {}
    for (k, name, _), (lib, report) in zip(jobs, built):
        libs[k, name] = lib
        ptxas[f"{k} {name}"] = report
        for line in report:
            print(f"ptxas {k} {name}: {line}")
    if libs["K2", "this"] is None or libs["K3", "this"] is None:
        return 1
    failed = [n for n in others if libs["K2", n] is None or libs["K3", n] is None]
    for n in failed:  # a checkout whose kernels do not build is reported and left out
        print(f"{n}: left out, a kernel did not build")
        others.remove(n)
        del roots[n]

    dev = torch.device("cuda")
    gw, gh, gspp = chip_smoke.GRAD_W, chip_smoke.GRAD_H, chip_smoke.GRAD_SPP
    caustics = str(ROOT / "data" / "caustics.json")
    cfg = RenderConfig(max_depth=chip_smoke.GRAD_D)
    grad_label = (f"build_test_scene {chip_smoke.INV_W}x{chip_smoke.INV_H} {chip_smoke.INV_SPP}spp depth "
                  f"{chip_smoke.INV_D}")
    main_label = f"caustics {chip_smoke.MAIN_W}x{chip_smoke.MAIN_H} {chip_smoke.MAIN_SPP}spp"
    cases = [
        make_case(grad_label, build_test_scene(chip_smoke.INV_W / chip_smoke.INV_H, dev), chip_smoke.INV_W,
                  chip_smoke.INV_H, chip_smoke.INV_SPP, RenderConfig(max_depth=chip_smoke.INV_D)),
        make_case(main_label, parser.load(caustics, chip_smoke.MAIN_W / chip_smoke.MAIN_H, dev), chip_smoke.MAIN_W,
                  chip_smoke.MAIN_H, chip_smoke.MAIN_SPP, RenderConfig()),
        make_case(f"build_test_scene 256x192 {chip_smoke.INV_SPP}spp depth {chip_smoke.INV_D}",
                  build_test_scene(256 / 192, dev), 256, 192, chip_smoke.INV_SPP,
                  RenderConfig(max_depth=chip_smoke.INV_D)),
        make_case(f"build_test_scene 192x144 {chip_smoke.INV_SPP}spp depth {chip_smoke.INV_D}",
                  build_test_scene(192 / 144, dev), 192, 144, chip_smoke.INV_SPP,
                  RenderConfig(max_depth=chip_smoke.INV_D)),
        make_case("caustics 64x48", parser.load(caustics, gw / gh, dev), gw, gh, gspp, cfg),
        make_case("scaled.json 64x48", parser.load(str(ROOT / "data" / "scaled.json"), gw / gh, dev), gw, gh, gspp,
                  cfg),
        make_case("two-light one_light_nee 64x48", build_two_light_scene(gw / gh, dev), gw, gh, gspp,
                  RenderConfig(max_depth=chip_smoke.GRAD_D, one_light_nee=True)),
        make_case("caustics full_mis 64x48", parser.load(caustics, gw / gh, dev), gw, gh, gspp,
                  RenderConfig(max_depth=chip_smoke.GRAD_D, full_mis=True)),
        make_case("random_spheres_scene(40) K=43 64x48", random_spheres_scene(
            40, seed=11, extent=10.0, n_lights=2, aspect_ratio=gw / gh, device=dev), gw, gh, gspp, cfg),
        make_case("mirror cluster 64x48 depth 20", build_mirror_cluster(gw / gh, dev), gw, gh, gspp,
                  RenderConfig(max_depth=20)),
        make_case("caustics 16x12 256spp (K2 in two waves)", parser.load(caustics, 16 / 12, dev), 16, 12, 256,
                  RenderConfig(max_depth=chip_smoke.GRAD_D)),
        make_case("caustics 16x12 144spp depth 3 (K2 in two waves)", parser.load(caustics, 16 / 12, dev), 16, 12, 144,
                  RenderConfig(max_depth=chip_smoke.GRAD_D)),
        make_case("caustics 8x6 81spp depth 100 (K2 in two waves)", parser.load(caustics, 8 / 6, dev), 8, 6, 81,
                  RenderConfig(max_depth=100)),
    ]
    timing = cases[:4]
    if only is not None:
        cases = [c for c in cases if only in c.label]
        timing = [c for c in timing if any(c is x for x in cases)]
    ok = True
    gaps = {}
    outs = {}
    for case in cases:
        ps = case.ps
        k1 = megakernel.launch_kernel(ps, 2024)
        rows = -(-ps.n_lanes * ps.eff // 32) + 1
        k3_rows = ps.n_planes + ps.n_spheres + 1
        for name in roots:
            o2 = torch.empty((2, 3, ps.n_lanes), dtype=torch.float32, device=dev)
            o3 = torch.zeros((rows, k3_rows, 9), dtype=torch.float32, device=dev)
            for k, run, o in (("K2", case.k2, o2), ("K3", case.k3, o3)):
                try:  # a fault names its kernel and checkout
                    run(libs[k, name], o)
                    torch.cuda.synchronize()
                except (RuntimeError, torch.AcceleratorError) as err:
                    print(f"{case.label}: {k} of {name} failed: {err}")
                    raise
            outs[case.label, name] = (o2, o3)
        this2, this3 = outs[case.label, "this"]
        for name in roots:
            o2, o3 = outs[case.label, name]
            same = torch.equal(o2[0].view(torch.int32), k1.view(torch.int32))
            finite = bool(torch.isfinite(o2).all() and torch.isfinite(o3).all())
            line = f"{case.label} {name}: K2 image == K1's (bits) {same}"
            ok &= same and finite
            if name != "this":
                gap = chip_smoke.rel_l2(this2[1], o2[1])
                a, b = this3.sum(0), o3.sum(0)
                field = 0.0
                for cols in (slice(0, 3), slice(3, 6), slice(6, 9)):
                    x, y = a[:-1, cols], b[:-1, cols]
                    lim = chip_smoke.FIELD_BAR[0] * y.abs().max() + chip_smoke.FIELD_BAR[1]
                    field = max(field, ((x - y).abs().max() / lim).item())
                y = b[-1, :3]
                lim = chip_smoke.FIELD_BAR[0] * y.abs().max() + chip_smoke.FIELD_BAR[1]
                field = max(field, ((a[-1, :3] - y).abs().max() / lim).item())
                gaps[f"{case.label} vs {name}"] = {"K2_tangent_rel_l2": gap, "K3_gap_over_bar": field}
                ok &= gap <= chip_smoke.TANGENT_BAR and field <= 1.0
                line += (f"; this vs {name}: K2 tangent relative L2 {gap:.3e} (<= {chip_smoke.TANGENT_BAR}), "
                         f"K3 largest gap / bar {field:.3e} (<= 1)")
            print(line + f"; finite={finite}")

    ms = {}
    order = [*others, "this", "this", *others[::-1]]
    for case in timing:
        for k in SOURCES:
            o2, o3 = outs[case.label, "this"]
            bufs = {name: outs[case.label, name][0 if k == "K2" else 1] for name in roots}
            run = case.k2 if k == "K2" else case.k3
            times = {name: [] for name in roots}
            for name in order:
                times[name].append(chip_smoke.timed(lambda n=name: run(libs[k, n], bufs[n]), REPS))
            ms[f"{k} {case.label}"] = times
            print(f"timing {k} {case.label} on {card}, {REPS} launches each, order {', '.join(order)}: "
                  + "; ".join(f"{n} " + ", ".join(f"{t:.4f}" for t in v) + " ms" for n, v in times.items()))
            for o in others:
                print(f"{k} {case.label}: this / {o}: {min(times['this']) / min(times[o]):.4f} (best of each)")
    print(json.dumps({"card": card, "within_bars": ok, "gaps": gaps, "ms": ms, "ptxas": ptxas}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
