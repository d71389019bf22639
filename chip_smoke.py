"""Smoke run of the PyTorch port's paths on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
the CUDA toolkit and PyTorch with CUDA. Phases, each of which ends the run
with a non-zero exit when it fails:

1. print the card (nvidia-smi name and power limit, torch's device name);
2. build every CUDA source of kajo_tpu_torch/csrc/, one nvcc each, all
   started together (print ptxas' report);
3. hold the megakernel (K1) against its plain PyTorch version on the card,
   same seed, at 64x48, 4 spp: caustics (rigid record), scaled.json (general
   record), the two-light scene with one-light NEE, and full MIS. Bars:
   tone-mapped MAD <= 5e-4 and mean relative gap <= 1%;
4. render the C++ golden's configuration with K1 (caustics, 32x24, 16 spp,
   10 passes): tone-mapped MAD < 0.1, mean relative gap < 0.25;
5. drive the main path, the CLI's main() at 512x384, 16 spp, 4 passes on
   data/caustics.json, counting K1's launches from 0: one per pass, and a
   PNG that decodes to finite values with a positive mean;
6. time K1 and its plain version at the main path's shape with CUDA events
   and hold their sums equal bit for bit there; print K1's regime there (a
   thread a lane, or a thread a (lane, sample) under its sample plan) and
   ptxas' registers and spills of each of its instantiations; and hold the
   plan constants of ops/megakernel.py equal to those K1 and K2 were built
   with;
7. the big-scene configuration (random_spheres_scene(100_000, seed=0,
   extent=60), 128x96, 4 spp, depth 2, one-light NEE), rigid and with
   scale_jitter=0.5: record every K5 (nearest hit) and K6 (occlusion) call
   of one wavefront pass, from the primary rays of the 128x96 x 4 lanes on,
   and hold each kernel against its plain version on those inputs: the same
   winner on every ray, t equal to the bit, the same occlusion on every ray;
   per K5 call, print the blocks a scan must test (those each ray enters
   below its final answer, via blocks_entered): per ray, the bound's count;
   and the union over the rays that decide a block together: per 128-ray
   CTA (the previous K5's group) and per 4-ray warp (K5's), in the call's
   order, and per 4 rays in an order sorted by direction octant and origin
   Morton cell (sorted_order, the order K5 does not take): what the
   warp-level cull removes; per K6 call the same for the blocks K6 must
   test (each ray's blocks entered below its cut, or, once occluded, up to
   the block of its first occluder, via first_occluder_block), per 128-ray
   CTA (the previous K6's group) and per 4-ray warp (K6's);
8. drive the big-scene path, the CLI's main() with --procedural 100000 -w
   128 -h 96 --spp 4 --depth 2 --passes 8, counting K5's and K6's launches
   from 0: both must launch, and the PNG must decode to finite values with
   a positive mean;
9. hold one wavefront pass with K5/K6 against the same pass with their
   plain versions on the card (bars as in phase 3);
10. time K5 and K6 per call with CUDA events over the recorded calls, their
   plain versions, the wavefront pass, and passes/s in batches of 8; print
   the pass's iterations and rays traced; profile one pass with
   torch.profiler (device busy share, K5/K6 share, the costliest device
   operations);
11. hold the gradient kernels against their plain versions (autodiff of the
   plain walk) on the card, for K2 (forward mode), K3 (material gradients)
   and K4 (sphere geometry): at the gradient path's own shape,
   build_test_scene 128x96, 16 spp, max_depth 4 (timing the plain versions
   there); at 64x48, 4 spp, max_depth 3 on caustics (rigid), scaled.json
   (general), the two-light scene with one-light NEE and caustics with full
   MIS; random_spheres_scene(40, seed=11, extent=10, n_lights=2) (K = 43)
   for K3, a 200-sphere field for K4, K4's slot rule on the mirror
   cluster at max_depth 20, and K2 on caustics at 16x12, 144 spp (its
   samples in two waves of 72) and at 8x6, 81 spp, max_depth 100 (a
   100 KB CTA of 41 threads, two waves). Bars: K1's sums equal its plain
   version's bit for bit wherever K2 is held (K1 there takes a thread a
   (lane, sample)), K2's image equals K1's
   bit for bit and its tangent is within a relative L2 gap of 1e-4; every
   field of K3 and K4 within 1e-4 max|plain| + 1e-7, and on the mirror
   cluster, whose
   gradients span many decades, every sphere's entries within 1e-4 of the
   sum of their own terms (K2 per sphere and direction); all finite; and
   K3 and K4 give the same bits when called twice on the same inputs (their
   tables are exact sums, csrc/exact_sum.cuh). Print how K4's largest
   gradient on the cluster grows with max_depth;
12. drive the gradient path, ``kajo_tpu_torch.inverse_rendering.main`` at
   128x96, 16 spp, max_depth 4, 100 steps, counting launches from 0: engine
   mega (sphere transform and albedos) must launch 2 K1 + 2 K3 + 2 K4 per
   step, engine mega-fwd (the sphere's 3 translation scalars) 6 K2 per step
   (plus the 3 K1 renders of the target and the two PNGs); every loss
   finite; the sphere's offset, and under mega the ground's albedo error,
   smaller at the end than at the start; ms per step and the share of
   K1/K3/K4 in a mega step and of K2 in a mega-fwd step (CUDA events), K1's
   regime at that shape, and
   K2/K3/K4 per launch at that shape with their bounds, registers and
   spills: these go to the kernels line, with the shape;
13. time K2, K3 and K4 per launch with CUDA events at the main render
   path's shape, caustics 512x384, 16 spp, with their bounds, registers and
   spills, and hold K2
   there (image equal to K1's, tangent gap <= 1e-4); the plain K3 and K4
   are not run there: their reverse-mode graphs would hold ~2,000 saved
   tensors of 0.79 MB per iteration over ~80 iterations, more than the
   card's memory;
14. the nearest-hit designs (stream_trace.nearest_design): for config 5,
   rigid and scale_jitter=0.5, and each of v1, v1-frustum, v1-near-far (K7
   in packed, frustum and near-to-far block order), v2 (K8) and v3 (K9),
   record every nearest-hit call of one wavefront pass under the design and
   hold the kernel against its plain version on each: the same winner on
   every ray, t equal to the bit; print how many rays' winners differ from
   K5's on the same inputs and the largest origin norm among them (a
   report: the designs' tile votes differ from K5's per-ray cull only for
   rays far outside the scene), the (ray, block) pairs the plain version
   scanned and the (ray, sphere) pairs among them with a discriminant >= 0
   (stream_trace.counting_scans: the design's own bound);
15. drive the big-scene path under each design, the CLI's main() as in
   phase 8 inside nearest_design(...), counting launches from 0: the
   design's kernel must launch, K5 not at all, K6 (shadow rays of the rigid
   scene) too; the PNG as in phase 8; and one pass under each design, rigid
   and scale_jitter=0.5, within the bars of phase 3 of the K5 pass with the
   same seed;
16. print ptxas' registers and spills of each K7, K8 and K9 entry; time
   each design's kernel per call with CUDA events (20 launches) on the
   recorded rigid calls of phase 14, beside K5 on the same call, its host-
   side lists (5 runs) and its plain version (1 run, phase 14), with its own
   bound (the pairs of phase 14) and K5's on the same call, and for K7 and
   K8 what each tile's vote admitted in phase 14 (mean, most, and the tiles
   above 4x the mean: the tail that one CTA or cluster walks alone); and a
   pass and 8 passes in a batch under each design;
17. the parity engine (models/integrator.py, plain PyTorch on the card,
   tracing through the dense trace or K5): a pass on the card against the
   same pass on the CPU, whose counter key gives the same stream (caustics,
   scaled.json and the two-light scene with one-light NEE at 64x48, 4 spp;
   phase 3's bars; the share of pixels that differ printed); the C++ golden
   as in phase 4; the CLI's main() with -r cpu at 512x384, 16 spp, 2
   passes: engine parity, K1 launched no time, the PNG as in phase 5, and a
   pass timed with CUDA events; a parity pass of config 5 (rigid), which
   must launch K5, timed, and its device busy share under torch.profiler;
18. the boundary terms (diff/edges.py) on engine mega: silhouette_loss_grads
   (the flat-lit sphere of tests/test_edges.py) and shadow_silhouette_grads
   (its out-of-frame occluder) at 32x32, n_edge 256 and 4, on the card
   against the CPU with the same key, under a ramp and a random cotangent:
   a relative L2 gap <= 1e-3 per output and no entry of another sign;
   kajo_tpu_torch.silhouette_recovery.main at its own size (64x64, 16 spp,
   60 steps), counting launches from 0: 2 K1, 2 K3 and 2 K4 a step, and
   the position error below half its start; the cast-shadow recovery of
   tests/test_edges.py (25 steps, shadow_edges) on engine mega: the error
   below its start of 0.3; ms per step and the boundary terms' share of a
   step, and the device busy share of the terms under torch.profiler; and
   phase 12's configuration for 10 steps with and without edge_gradients
   on three seeds, and for 100 steps with it, its losses and offsets
   printed beside phase 12's (a report: no bar);
19. the budget engine (models/wavefront.py render_pass_budget, engine jax;
   plain PyTorch on the card, through the dense trace or K5/K6 and the
   nearest hit's VJP): (a) the budget pass equal to the fast pass bit for
   bit on every pixel whose lane completed its samples (build_test_scene
   128x96, 16 spp, depth 4; the share of lanes that did not printed); (b)
   one budget loss's gradients in sphere_transform, sphere_radius and
   diffuse on the card against the CPU (64x48, 4 spp, depth 3; phase 18's
   bars); (c) every radius's gradient of random_spheres_scene(2000) at
   32x24, 4 spp, depth 2 through K5 and the VJP against the dense trace's
   (rtol 0.1 on the entries above 1e-3 of the largest; K5 must launch);
   (d) one budget-loss gradient in the radii at config 5 (rigid), timed,
   with K5's and K6's launches (both non-zero) and the gradient finite and
   non-zero; (e) kajo_tpu_torch.inverse_rendering.main --engine jax at
   phase 12's configuration for JAX_STEPS steps, counting launches from 0:
   K1 3 (the target and the two PNGs), K2-K5 none; every loss finite and
   the sphere's offset smaller at the end; ms per step, and the device busy
   share of a budget pass under torch.profiler; (f) the same steps again: the
   same losses and tensors to the bit; (g) the cast-shadow recovery of
   tests/test_edges.py on engine jax (shadow_edges, SHADOW_STEPS steps):
   error below kajo_tpu's bar of 0.12; (h) K3's diffuse gradient on
   scaled.json against engine jax's, 6 seeds each with the JAX test's
   streams (tests/test_megakernel_grad.py: atol 0.25 max|jax|); (i) the
   drift of (e)'s losses beside phase 18d's engine mega runs (a report);
20. distribution (kajo_tpu_torch/parallel/, no kernel of its own): (a) at
   world size 1 over NCCL, K1 sharded at caustics 512x384, 16 spp equal to
   the K1 pass bit for bit with one K1 launch, the wavefront sharded at
   build_test_scene 128x96, 16 spp, depth 4 equal to render_pass_fast bit
   for bit, and the object-sharded wavefront on config 5 within phase 3's
   bars of the wavefront with one lane a pixel (its layout), with its K5
   launches; K1 on the rank's lane block and K5 on its first DIST_HELD
   calls on the rank's shard held against their plain versions bit for
   bit, timed and bounded; (b) the same on 2 spawned processes sharing the
   card over gloo with CUDA tensors (each rank's K5 on 50,000 spheres),
   each rank's K1/K5 launches and ms a pass printed; (c) the CLI's --shard
   (caustics 512x384, 16 spp, 4 passes: 4 K1 launches) and --shard-objects
   (--procedural 100000 -w 128 -h 96 --spp 4 --depth 2, 2 passes: K5
   launches), each a PNG of finite values with a positive mean, samples/s
   printed; (d) torchrun --nproc_per_node 1 -m
   kajo_tpu_torch.parallel.multihost data/caustics.json to a PNG; (e) three
   InverseRenderer(mesh=...) steps at 64x48, 4 spp, depth 4 whose loss and
   gradients equal the unsharded parity loss's bit for bit;
21. the CLI's --profile: (a) the main path of phase 5 for 8 passes (two
   batches of 4) under --profile: exactly 8 K1 launches, by the counter and
   by kernel name in the Chrome trace, the PNG as in phase 5, and the
   device busy share of the profiled loop (the union of the kernels' and
   copies' intervals over the span of the trace's events) and of each
   batch (up to the end of its image's copy to the host), the first with
   its warm-up and the second in steady state; (b) the big-scene path of
   phase 8 for 2 passes under --profile: K5 and K6 in the trace by name,
   as many as their counters say; (c) save_png of a K1 image at 512x384,
   its tone map and its encoder: host ms, medians of 5 (a report).

Every PNG is read back through kajo_tpu_torch.utils.image.load_png.

Each kernel's bound is the larger of the bytes it must move over 3.35 TB/s
and the FP32 operations it must do over 67 TFLOP/s (the H100 SXM's published
peaks), counted on this run's data. A sphere test's ray-independent part
(cx²+cy²+cz²-r², 6 operations of the rigid record) counts once per sphere,
the rest once per ray and sphere; for K7-K9 its roots (OPS_RIGID_ROOTS,
OPS_GENERAL_ROOTS) count only where the discriminant is >= 0, as the
function needs them nowhere else (K1-K6's bounds still charge every test
its roots). K1 counts the ray-object tests of its
pass and its shading, at one FP32 operation per float operation of
csrc/megakernel.cu (transcendentals one each, integer work and compares
none): per sample its camera ray (OPS_CAMERA), per path vertex its hit
point and deferred MIS weight (OPS_VERTEX), per miss its background term
(OPS_MISS), per hit its roulette, lottery, reflection and emission term
(OPS_HIT), per vertex that continues its BSDF's sample, pdf and f cos
(OPS_LAMBERT, OPS_PHONG, OPS_MIRROR, OPS_TRANSMIT), and per NEE light
sampled its light sample, solid angle, pdfs, weight and term (OPS_NEE),
the vertices counted by the plain walk's stats (its bound from the tests
alone is printed beside it); K2 counts K1's tests plus the tangent
operations of the winner's test per path ray (2 per test operation); K3
two walks per sample,
and its bytes the packed scene, the cotangent and one (K+1) x 9 table (the
function's least work, whatever the design's per-CTA tables).
K4 counts the function's least work, whatever the design: one walk of each
sample on values (its ray-object tests), plus, per path ray and sphere the
sample tracks (at most 8 non-light ones and the lights it hits; lights
flagged only by an NEE term are not counted), the tangent operations of the
four directions cx, cy, cz, r², each: the winner's test (2 per test
operation) and the shading of a diffuse vertex (OPS_SHADE_TANGENT, and
OPS_NEE_TANGENT per NEE light sampled), counted from csrc/walk.cuh's bounce
at one to three FP32 operations per Dual operation; no value work counted
twice. Its bytes are the packed scene, the cotangent and the [S, 4] table.
K5/K6 count, per ray, the 128-sphere blocks it needs: those whose box it
enters below its final answer (K5: its hit or its bound; K6: its cut, or,
once occluded, the first block holding an occluder); their bytes are the
boxes, the records of the blocks some ray needs, o and d of the rays with a
positive bound, and the bound in and the results out. K7-K9 count the
(ray, block) pairs their own function scans, which their tile votes
decide (their plain versions count them), at the same operations per
test, and their bytes the boxes, the records of the blocks scanned, the
rays and the results; K5's bound on the same call is printed beside it.

Every line is flushed as it is printed, and a phase that stalls for
STALL_S seconds dumps the Python stack of every thread and ends the run.

Phases 17 to 21 run no kernel of their own and add nothing to the kernels
line. The last two lines are the kernels' JSON record and {"ok": true,
"device": ...}. Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import io
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from kajo_tpu_torch.utils.image import load_png

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"
MAD_BAR, REL_BAR = 5e-4, 0.01
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_OPS_PER_S = 67e12      # H100 SXM FP32 outside the tensor cores, published
# FP32 operations of one ray-object test as the kernels write it (compares
# and selects not counted): per ray and object, and, for the rigid sphere,
# the ray-independent cx²+cy²+cz²-r² once per sphere
OPS_PLANE, OPS_SPHERE_RIGID, OPS_SPHERE_GENERAL = 14, 25, 63
OPS_SPHERE_RIGID_ONCE = 6
# of a sphere test's operations, those of its roots (square root, q, the
# divisions, min and max, det scaling), which an answer needs only where the
# discriminant is >= 0 (csrc/stream_trace.cuh rigid_roots, general_roots)
OPS_RIGID_ROOTS, OPS_GENERAL_ROOTS = 7, 9
# FP32 tangent operations per path vertex and direction of K4's function
# (csrc/walk.cuh bounce; a Dual product 3, a sum 1, a quotient 3, a product
# or quotient by a float 1): a diffuse vertex's hit point, deferred MIS
# weight, coin scalings, reflection, tangent frame, continuation and f cos
# (~151), and per NEE light sampled its sample point, solid angle, pdfs,
# f cos, weight and term (~134)
OPS_SHADE_TANGENT, OPS_NEE_TANGENT = 150, 130
# FP32 operations of K1's shading (csrc/megakernel.cu walk, one per float
# operation): per camera ray, path vertex, miss, hit, continuation by each
# BSDF and NEE light sampled (see the module docstring)
OPS_CAMERA, OPS_VERTEX, OPS_MISS, OPS_HIT = 35, 8, 6, 46
OPS_LAMBERT, OPS_PHONG, OPS_MIRROR, OPS_TRANSMIT, OPS_NEE = 69, 96, 13, 36, 92
# no phase runs this long; a stall dumps every thread's stack and ends the run
STALL_S = 600
BIG_W, BIG_H, BIG_SPP, BIG_D, BIG_N = 128, 96, 4, 2, 100_000  # BASELINE.md config 5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def tm(x: torch.Tensor) -> torch.Tensor:
    return x[..., :3].clamp(0, 1) ** (1 / 2.2)


def compare(label: str, got: torch.Tensor, want: torch.Tensor, mad_bar=MAD_BAR, rel_bar=REL_BAR) -> float:
    """Print and check finiteness, tone-mapped MAD and mean relative gap;
    returns the largest absolute difference."""
    finite = bool(torch.isfinite(got).all())
    mad = (tm(got) - tm(want)).abs().mean().item()
    rel = abs(got[..., :3].mean().item() / want[..., :3].mean().item() - 1)
    max_abs = (got - want).abs().max().item()
    ok = finite and mad <= mad_bar and rel <= rel_bar
    print(f"{label}: finite={finite} tm_mad={mad:.3e} (<= {mad_bar}) mean_rel={rel:.3e} (<= {rel_bar}) "
          f"max_abs_err={max_abs:.3e} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(label)
    return max_abs


def bound(n_bytes: float, n_ops: float):
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def timed(fn, reps: int) -> float:
    """ms per call of fn() over reps calls, with CUDA events."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_device(fn) -> dict:
    """Run fn() once under torch.profiler -> host wall ms, device busy ms
    (the union of the intervals of every kernel and copy on the card), and
    device ms and launches per kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, per_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    busy_us, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy_us += t - max(s, end)
            end = t
    return dict(wall_ms=wall_ms, busy_ms=busy_us / 1e3, per_name=per_name)


def report_profile(label: str, card: str, prof: dict) -> None:
    """Print a profile_device record: wall, device busy share and launches."""
    launches = sum(n for _, n in prof["per_name"].values())
    print(f"profile {label} on {card}: wall {prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.2f} ms "
          f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), {launches} device launches and copies")


def blocks_entered(o, d, t_final, boxes, rays_per_chunk=4096) -> torch.Tensor:
    """Per ray and packed block, whether the ray enters the block's box
    below ``t_final`` (the slab test of csrc/stream_trace.cu) -> bool [N, B]:
    the blocks any block-culled scan of these boxes must test."""
    from kajo_tpu_torch.ops.stream_trace import _slab

    out = []
    for r0 in range(0, o.shape[0], rays_per_chunk):
        rays = slice(r0, r0 + rays_per_chunk)
        t_enter, entered = _slab(o[rays], d[rays], boxes)
        out.append(entered & (t_enter * boxes[:, 6] < t_final[rays, None]))
    return torch.cat(out)


def first_occluder_block(rigid, o, d, t_cut, excl, packed, boxes) -> torch.Tensor:
    """Per ray, the first packed block (in scan order) that holds a sphere
    other than ``excl`` hit strictly below the ray's live cut -> int64 [N],
    -1 for a ray nothing occludes: the plain K6 scan, keeping the block."""
    from kajo_tpu_torch.ops import stream_trace as st

    first = torch.full(t_cut.shape, -1, dtype=torch.int64, device=t_cut.device)
    t_best = t_cut.clone()

    def visit(rays, blk, t, valid, entered, t_enter_det):
        may = entered & (t_enter_det < t_best[rays])
        cols = torch.arange(blk * st.BLOCK, (blk + 1) * st.BLOCK, dtype=torch.int32, device=t.device)
        hit = may & (valid & (t < t_best[rays][:, None]) & (cols[None, :] != excl[rays][:, None])).any(1)
        first[rays] = torch.where(hit & (first[rays] < 0), blk, first[rays])
        t_best[rays] = torch.where(hit, 0.0, t_best[rays])

    st._block_scan(rigid, o, d, packed, boxes, visit)
    return first


# the stream trace's kernel wrappers, by the kind a recorded call carries
LAUNCHERS = {"nearest": "launch_nearest", "occluded": "launch_occluded", "v1": "launch_nearest_v1",
             "v2": "launch_nearest_v2", "v3": "launch_nearest_v3"}


def record_stream_calls(fn):
    """Run fn() with every launch of the stream trace's kernels (K5, K6 and
    the designs K7-K9) recorded -> (fn's result, [(kind, args)]) in call
    order; the kernels still run."""
    from kajo_tpu_torch.ops import stream_trace as st

    calls, saved = [], {kind: getattr(st, name) for kind, name in LAUNCHERS.items()}
    for kind, name in LAUNCHERS.items():
        setattr(st, name, lambda *args, _k=kind, _f=saved[kind]: (calls.append((_k, args)), _f(*args))[1])
    try:
        return fn(), calls
    finally:
        for kind, name in LAUNCHERS.items():
            setattr(st, name, saved[kind])


@contextlib.contextmanager
def plain_stream_trace():
    """Route the CUDA trace's K5/K6 calls to their plain versions on the card."""
    from kajo_tpu_torch.ops import stream_trace as st

    nearest, occluded = st.launch_nearest, st.launch_occluded
    st.launch_nearest, st.launch_occluded = st.nearest_sphere_plain, st.occluded_sphere_plain
    try:
        yield
    finally:
        st.launch_nearest, st.launch_occluded = nearest, occluded


def kernel_vs_plain(kind, args):
    """Launch the kernel and its plain version (the same arguments) on one
    recorded call -> (kernel out, plain out, plain winners or None, equal
    to the bit)."""
    from kajo_tpu_torch.ops import stream_trace as st

    if kind == "nearest":
        (t_k, i_k), (t_p, i_p) = st.launch_nearest(*args), st.nearest_sphere_plain(*args)
        torch.cuda.synchronize()
        return t_k, t_p, i_p, torch.equal(i_k, i_p) and torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    t_k, t_p = st.launch_occluded(*args), st.occluded_sphere_plain(*args)
    torch.cuda.synchronize()
    return t_k, t_p, None, torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))


def occluded_needed(args) -> torch.Tensor:
    """The blocks one K6 call must test per ray -> bool [N, B]: an
    unoccluded ray every block it enters below its cut, an occluded one the
    block of its first occluder."""
    rigid, o, d, bound_, excl, packed, boxes = args[:7]
    first = first_occluder_block(rigid, o, d, bound_, excl, packed, boxes)
    needed = blocks_entered(o, d, bound_, boxes) & (first < 0)[:, None]
    rows = torch.nonzero(first >= 0).squeeze(1)
    needed[rows, first[rows]] = True
    return needed & (bound_ > 0)[:, None]


def call_bound(kind, args, t_final):
    """(bytes, FP32 operations) one K5/K6 call must move and do on these
    inputs; see the module docstring."""
    if kind == "nearest":
        rigid, o, d, bound_, packed, boxes = args[:6]
        needed = blocks_entered(o, d, t_final, boxes)
        per_live_ray, per_ray = 24, 4 + 4 + 4  # o, d; bound in, t and idx out
    else:
        rigid, o, d, bound_, excl, packed, boxes = args[:7]
        needed = occluded_needed(args)
        per_live_ray, per_ray = 24 + 4, 4 + 4  # o, d, excl; cut in, bound out
    live = bound_ > 0
    needed &= live[:, None]
    touched = int(needed.any(0).sum())  # blocks some ray needs
    fields = packed.shape[1]
    n_bytes = (boxes.numel() * 4 if bool(live.any()) else 0) + touched * 128 * fields * 4
    n_bytes += int(live.sum()) * per_live_ray + o.shape[0] * per_ray
    if rigid:
        n_ops = float(needed.sum()) * 128 * OPS_SPHERE_RIGID + touched * 128 * OPS_SPHERE_RIGID_ONCE
    else:
        n_ops = float(needed.sum()) * 128 * OPS_SPHERE_GENERAL
    return n_bytes, n_ops


def union_per_group(needed: torch.Tensor, order: torch.Tensor, group: int) -> float:
    """Mean over groups of ``group`` consecutive rays of ``order`` of the
    number of blocks some ray of the group needs (``needed`` [N, B])."""
    sel = needed[order]
    pad = -sel.shape[0] % group
    sel = torch.cat([sel, sel.new_zeros((pad, sel.shape[1]))])
    return float(sel.view(-1, group, sel.shape[1]).any(1).sum(1).float().mean())


def sorted_order(o, d, boxes) -> torch.Tensor:
    """The rays stable-sorted by direction octant, then by the Morton cell
    (10 bits an axis) of the origin in the scene's box: a coherent order
    that K5 does not take (PERF.md, section 6), kept to show why."""
    from kajo_tpu_torch.ops.stream_trace import _expand_bits10

    lo, hi = boxes[:, 0:3].amin(0), boxes[:, 3:6].amax(0)
    e = _expand_bits10(torch.clamp((o - lo) / torch.clamp_min(hi - lo, 1e-20) * 1023.0, 0.0, 1023.0).long())
    neg = (d < 0).long()
    key = (((neg[:, 0] << 2) | (neg[:, 1] << 1) | neg[:, 2]) << 30) | (e[:, 0] << 2) | (e[:, 1] << 1) | e[:, 2]
    return torch.argsort(key, stable=True)


def blocks_scanned(args, t_final) -> str:
    """The blocks a K5 call's scan must test, per ray and per group of rays
    that decide a block together (see phase 7)."""
    o, d, bound_, boxes = args[1], args[2], args[3], args[5]
    needed = blocks_entered(o, d, t_final, boxes) & (bound_ > 0)[:, None]
    given = torch.arange(o.shape[0], device=o.device)
    return (f"per ray {needed.sum(1).float().mean().item():.2f} (the bound's count); in the call's order per 128-ray "
            f"CTA (the previous K5's group) {union_per_group(needed, given, 128):.2f}, per 4-ray warp (K5's) "
            f"{union_per_group(needed, given, 4):.2f}; per 4 rays sorted by octant and origin cell "
            f"{union_per_group(needed, sorted_order(o, d, boxes), 4):.2f}; of {boxes.shape[0]} blocks")


def occluded_blocks_scanned(args) -> str:
    """The blocks a K6 call must test, per ray and per group of rays that
    decide a block together (see phase 7)."""
    needed = occluded_needed(args)
    given = torch.arange(needed.shape[0], device=needed.device)
    return (f"per ray {needed.sum(1).float().mean().item():.2f} (the bound's count); in the call's order per 128-ray "
            f"CTA (the previous K6's group) {union_per_group(needed, given, 128):.2f}, per 4-ray warp (K6's) "
            f"{union_per_group(needed, given, 4):.2f}; of {needed.shape[1]} blocks")


def ptxas_entries(source: str, entry: str) -> list:
    """[(mangled name, registers, bytes of spill stores)] of each kernel
    entry of csrc/<source> whose mangled name holds ``entry``."""
    from kajo_tpu_torch.ops import _nvcc

    rows, current = {}, ""
    for line in _nvcc.library_path(source).with_suffix(".log").read_text().splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            current = m.group(1)
        if entry not in current:
            continue
        regs, spills = rows.get(current, (0, 0))
        m = re.search(r"(\d+) bytes spill stores", line)
        spills = max(spills, int(m.group(1))) if m else spills
        m = re.search(r"Used (\d+) registers", line)
        regs = max(regs, int(m.group(1))) if m else regs
        rows[current] = (regs, spills)
    return [(name, *v) for name, v in rows.items()]


def ptxas_usage(source: str, entry: str) -> tuple:
    """(most registers, most bytes of spill stores) over the kernel entries
    of csrc/<source> whose mangled name holds ``entry``, from ptxas' report."""
    rows = ptxas_entries(source, entry)
    return max((r for _, r, _ in rows), default=0), max((sp for _, _, sp in rows), default=0)


def k1_regime(ps) -> str:
    """K1's regime for a pass (megakernel.k1_plan, the kernel's rule)."""
    from kajo_tpu_torch.ops import megakernel

    plan = megakernel.k1_plan(ps.n_lanes, ps.eff, ps.config.max_depth)
    if plan is None:
        return f"a thread a lane ({ps.n_lanes} lanes)"
    return (f"a thread a (lane, sample) ({ps.n_lanes} lanes x {ps.eff} samples): CTAs of {plan.lanes_per_cta} "
            f"lane(s) x {plan.wave} thread(s), {plan.waves} wave(s), {plan.shared} B of shared memory")


def k1_bound(ps, stats: dict):
    """K1's bound on one pass's data (its ray-object tests and its shading,
    see the module docstring), and the bound of its tests alone -> ((ms,
    by), (ms, by), bytes, operations)."""
    per_ray = ps.n_planes * OPS_PLANE + ps.n_spheres * (OPS_SPHERE_RIGID if ps.rigid else OPS_SPHERE_GENERAL)
    once = ps.n_spheres * OPS_SPHERE_RIGID_ONCE if ps.rigid else 0
    tests = (stats["rays"] + stats["shadow_rays"]) * per_ray + once
    shading = (ps.n_lanes * ps.eff * OPS_CAMERA + stats["rays"] * OPS_VERTEX
               + (stats["rays"] - stats["hits"]) * OPS_MISS + stats["hits"] * OPS_HIT
               + stats["lambert"] * OPS_LAMBERT + stats["phong"] * OPS_PHONG + stats["mirror"] * OPS_MIRROR
               + stats["transmit"] * OPS_TRANSMIT + stats["shadow_rays"] * OPS_NEE)
    n_bytes = ps.packed.numel() * 4 + 12 * ps.n_lanes
    print(f"K1 bound: {stats['rays']} path rays ({stats['hits']} hits; {stats['lambert']} lambert, "
          f"{stats['phong']} phong, {stats['mirror']} mirror, {stats['transmit']} transmit) + "
          f"{stats['shadow_rays']} shadow rays x {per_ray} FP32 ops of ray-object tests + {once} = {tests:.4g}, "
          f"shading {shading:.4g} FP32 ops")
    return bound(n_bytes, tests + shading), bound(n_bytes, tests), n_bytes, tests + shading


def megakernel_phases(dev, card: str) -> dict:
    """Phases 3-6 (K1) -> K1's record for the kernels line."""
    from kajo_tpu_torch import cli
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.ops import megakernel
    from kajo_tpu_torch.scene import parser
    from kajo_tpu_torch.scene.testscene import build_two_light_scene

    caustics = str(ROOT / "data" / "caustics.json")
    # 3. K1 vs plain on the card
    cases = [
        ("caustics 64x48 4spp", parser.load(caustics, 64 / 48, dev), RenderConfig()),
        ("scaled.json 64x48 4spp", parser.load(str(ROOT / "data" / "scaled.json"), 64 / 48, dev), RenderConfig()),
        ("two-light one_light_nee 64x48 4spp", build_two_light_scene(64 / 48, dev), RenderConfig(one_light_nee=True)),
        ("caustics full_mis 64x48 4spp", parser.load(caustics, 64 / 48, dev), RenderConfig(full_mis=True)),
    ]
    for label, scene, config in cases:
        got = megakernel.render_pass_megakernel(scene, 2024, 64, 48, 4, config)
        want = megakernel.render_pass_megakernel_plain(scene, 2024, 64, 48, 4, config)
        torch.cuda.synchronize()
        compare(label, got, want)

    # 4. golden
    scene = parser.load(caustics, 32 / 24, dev)
    img = (megakernel.render_passes_megakernel(scene, 17, 0, 32, 24, 16, 10) / 10).cpu()
    golden = torch.from_numpy(
        np.fromfile(ROOT / "tests" / "goldens" / "caustics_32x24.raw", np.float32).reshape(24, 32, 4)
    )
    compare("golden caustics 32x24 16spp 10 passes vs C++ reference", img, golden, 0.1, 0.25)

    # 5. the main path, through the CLI
    OUT.mkdir(parents=True, exist_ok=True)
    png = OUT / "caustics_512x384.png"
    passes = 4
    megakernel.kernel_launches = 0
    rc = cli.main(["-w", "512", "-h", "384", "--spp", "16", "--passes", str(passes), caustics, "-o", str(png)])
    mega_launches = megakernel.kernel_launches
    print(f"main path: cli rc={rc}, kernel launches {mega_launches} for {passes} passes")
    if rc != 0 or mega_launches != passes:
        fail("the CLI's main path did not run one kernel launch per pass")
    pixels = load_png(str(png)).astype(np.float64)
    print(f"png {png.relative_to(ROOT)}: shape {pixels.shape}, mean {pixels[..., :3].mean():.2f}")
    if pixels.shape != (384, 512, 4) or not np.isfinite(pixels).all() or not pixels[..., :3].mean() > 0:
        fail("the main path's PNG")

    # 6. K1 timing and comparison at the main path's shape
    w, h, spp = 512, 384, 16
    ps = megakernel.prepare_pass(parser.load(caustics, w / h, dev), w, h, spp, RenderConfig())
    seed = 99
    k1_stats = {}
    plain = megakernel.trace_lanes_plain(ps, seed, k1_stats)  # warm-up, counting the rays
    kern = megakernel.launch_kernel(ps, seed)
    torch.cuda.synchronize()
    plain_ms = timed(lambda: megakernel.trace_lanes_plain(ps, seed), 1)
    ms = timed(lambda: megakernel.launch_kernel(ps, seed), 20)
    ms2 = timed(lambda: megakernel.launch_kernel(ps, seed), 20)
    plain_ms2 = timed(lambda: megakernel.trace_lanes_plain(ps, seed), 1)
    samples = w * h * ps.eff
    print(f"timing caustics {w}x{h} {spp}spp on {card}: kernel {ms:.3f} / {ms2:.3f} ms per pass "
          f"({samples / (min(ms, ms2) / 1e3):.4g} samples/s), plain PyTorch {plain_ms:.1f} / {plain_ms2:.1f} ms "
          f"({samples / (min(plain_ms, plain_ms2) / 1e3):.4g} samples/s)")
    k1_max_abs = compare(
        f"kernel vs plain caustics {w}x{h} {spp}spp",
        kern.T.reshape(h, w, 3) / ps.divisor,
        plain.T.reshape(h, w, 3) / ps.divisor,
    )
    k1_bits = torch.equal(kern.view(torch.int32), plain.view(torch.int32))
    print(f"kernel vs plain caustics {w}x{h} {spp}spp: sums equal bit for bit {k1_bits}")
    if not k1_bits:
        fail(f"K1 against its plain version at caustics {w}x{h} {spp}spp (bits)")
    for source, resident, floats in (("megakernel.cu", megakernel.K1_RESIDENT_THREADS, megakernel.K1_FLOATS),
                                     ("megakernel_jvp.cu", megakernel.JVP_RESIDENT_THREADS, megakernel.JVP_FLOATS)):
        built = megakernel.built_plan_constants(source)
        mirror = (megakernel.PLAN_MAX_THREADS, megakernel.PLAN_SHARED_LIMIT, resident, *floats)
        print(f"plan constants of {source}: built {built}, ops/megakernel.py {mirror}")
        if built != mirror:
            fail(f"ops/megakernel.py's plan constants against {source}'s")
    (b_ms, by), (t_ms, t_by), n_bytes, n_ops = k1_bound(ps, k1_stats)
    k1_usage = ptxas_entries("megakernel.cu", "megakernel_")
    print(f"K1 at caustics {w}x{h} {spp}spp: {k1_regime(ps)}; bound {b_ms:.5f} ms ({by}: {n_bytes:.4g} B, "
          f"{n_ops:.4g} FP32 ops), {min(ms, ms2) / b_ms:.0f}x; the tests alone {t_ms:.5f} ms ({t_by}), "
          f"{min(ms, ms2) / t_ms:.0f}x")
    for name, regs, spills in k1_usage:
        print(f"K1 ptxas {name}: {regs} registers, {spills} B spill stores")

    return {
        "name": "megakernel",
        "route": "cuda",
        "source": "kajo_tpu_torch/csrc/megakernel.cu",
        "replaces": "kajo_tpu/ops/pallas/megakernel.py:297",
        "launches": mega_launches,
        "max_abs_err": k1_max_abs,
        "ms": min(ms, ms2),
        "plain_ms": min(plain_ms, plain_ms2),
        "bound_ms": b_ms,
        "bound_by": by,
        "library_ms": None,  # no single PyTorch call computes a path-traced pass
        "tests_bound_ms": t_ms,  # the bound of its ray-object tests alone
        **dict(zip(("registers", "spills"), ptxas_usage("megakernel.cu", "megakernel_"))),
    }


def hold_stream_calls(dev, jitter: float):
    """Phase 7 for one scene: record every K5/K6 call of one config-5 pass
    and hold each against its plain version -> (scene, calls, kernel
    results, the largest |kernel - plain| per kind)."""
    from kajo_tpu_torch.models import wavefront
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.ops import geometry
    from kajo_tpu_torch.scene.procedural import random_spheres_scene

    big_cfg = RenderConfig(max_depth=BIG_D, one_light_nee=True)
    label = "rigid" if jitter == 0.0 else f"scale_jitter={jitter}"
    t0 = time.time()
    scene = random_spheres_scene(BIG_N, seed=0, extent=60.0, aspect_ratio=BIG_W / BIG_H, scale_jitter=jitter,
                                 device=dev)
    prep = geometry.prepare_scene(scene)
    torch.cuda.synchronize()
    print(f"config 5 {label}: {BIG_N} spheres built and packed in {time.time() - t0:.1f} s: "
          f"packed {tuple(prep.stream_packed.shape)}, {prep.stream_boxes.shape[0]} blocks")
    t0 = time.time()
    _, calls = record_stream_calls(lambda: wavefront.render_pass_fast(scene, 5, BIG_W, BIG_H, BIG_SPP, big_cfg))
    torch.cuda.synchronize()
    print(f"config 5 {label}: one pass with {len(calls)} K5/K6 calls recorded in {time.time() - t0:.1f} s")
    # rigid scenes take shadows from K6; non-rigid ones from K5
    kinds = [k for k, _ in calls]
    if not ({"nearest", "occluded"} if jitter == 0.0 else {"nearest"}) <= set(kinds):
        fail(f"config 5 {label}: the pass did not launch its kernels ({kinds})")
    worst = {"nearest": 0.0, "occluded": 0.0}
    results = []
    for i, (kind, args) in enumerate(calls):
        t0 = time.time()
        out_k, out_p, idx, ok = kernel_vs_plain(kind, args)
        diff = (out_k - out_p).abs().max().item()
        worst[kind] = max(worst[kind], diff)
        extra = f", {int((idx >= 0).sum())} hits" if idx is not None else f", {int((out_p == 0).sum())} zero bounds"
        print(f"config 5 {label} call {i} {kind}: {args[1].shape[0]} rays{extra}; kernel == plain on every ray "
              f"(bits): {ok}, max |diff| {diff:.3e} ({time.time() - t0:.1f} s)")
        if not ok:
            fail(f"config 5 {label}: {kind} kernel and plain version differ on call {i}")
        if kind == "nearest":
            print(f"config 5 {label} call {i} blocks scanned: {blocks_scanned(args, out_p)}")
        else:
            print(f"config 5 {label} call {i} blocks scanned: {occluded_blocks_scanned(args)}")
        results.append(out_k)
    return scene, calls, results, worst


def big_scene_phases(dev, card: str):
    """Phases 7-10 (K5, K6) -> (their records for the kernels line, the
    config-5 scenes by label)."""
    from kajo_tpu_torch import cli
    from kajo_tpu_torch.models import wavefront
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.ops import geometry, megakernel
    from kajo_tpu_torch.ops import stream_trace as st

    # 7. K5/K6 vs plain on every call of one big-scene wavefront pass
    recorded = {}
    for jitter in (0.0, 0.5):
        recorded["rigid" if jitter == 0.0 else f"scale_jitter={jitter}"] = hold_stream_calls(dev, jitter)

    big_cfg = RenderConfig(max_depth=BIG_D, one_light_nee=True)

    # 8. the big-scene path, through the CLI
    OUT.mkdir(parents=True, exist_ok=True)
    png = OUT / f"procedural_{BIG_N}_{BIG_W}x{BIG_H}.png"
    st.nearest_launches = st.occluded_launches = 0
    megakernel.kernel_launches = 0
    err = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["--procedural", str(BIG_N), "-w", str(BIG_W), "-h", str(BIG_H), "--spp", str(BIG_SPP),
                       "--depth", str(BIG_D), "--passes", "8", "-o", str(png)])
    cli_s = time.time() - t0
    k5_launches, k6_launches = st.nearest_launches, st.occluded_launches
    sys.stderr.write(err.getvalue())
    rates = re.findall(r"([0-9.]+[KMG]?) samples/s", err.getvalue())
    print(f"big-scene path: cli rc={rc} in {cli_s:.1f} s (scene build included), engine line "
          f"{[ln for ln in err.getvalue().splitlines() if ln.startswith('engine')]}, CLI samples/s {rates}, "
          f"K5 launches {k5_launches}, K6 launches {k6_launches}, K1 launches {megakernel.kernel_launches}")
    if rc != 0 or k5_launches == 0 or k6_launches == 0 or "engine: fast" not in err.getvalue():
        fail("the big-scene path did not run through engine fast with K5 and K6")
    pixels = load_png(str(png)).astype(np.float64)
    print(f"png {png.relative_to(ROOT)}: shape {pixels.shape}, mean {pixels[..., :3].mean():.2f}")
    if pixels.shape != (BIG_H, BIG_W, 4) or not np.isfinite(pixels).all() or not pixels[..., :3].mean() > 0:
        fail("the big-scene path's PNG")

    # 9. one wavefront pass with K5/K6 against the same pass with the plain versions
    scene = recorded["rigid"][0]
    got = wavefront.render_pass_fast(scene, 7, BIG_W, BIG_H, BIG_SPP, big_cfg)
    with plain_stream_trace():
        want = wavefront.render_pass_fast(scene, 7, BIG_W, BIG_H, BIG_SPP, big_cfg)
    torch.cuda.synchronize()
    compare(f"wavefront pass K5/K6 vs plain, config 5 {BIG_W}x{BIG_H} {BIG_SPP}spp", got, want)

    # 10. timing on the recorded rigid calls, the pass, and batches of 8
    _, calls, results, _ = recorded["rigid"]
    stream_rows = {}
    for kind, launch, plain_fn in (
        ("nearest", st.launch_nearest, st.nearest_sphere_plain),
        ("occluded", st.launch_occluded, st.occluded_sphere_plain),
    ):
        sel = [(args, out) for (k, args), out in zip(calls, results) if k == kind]
        k_ms = [timed(lambda a=args: launch(*a), 20) for args, _ in sel]
        p_ms = [timed(lambda a=args: plain_fn(*a), 1) for args, _ in sel]
        bounds = [call_bound(kind, args, out) for args, out in sel]
        b_ms = [bound(b, o) for b, o in bounds]
        for i, ((args, _), km, pm, (bm, by)) in enumerate(zip(sel, k_ms, p_ms, b_ms)):
            print(f"timing {kind} call {i} ({args[1].shape[0]} rays) on {card}: kernel {km:.4f} ms, "
                  f"plain {pm:.2f} ms, bound {bm:.6f} ms ({by}: {bounds[i][0]:.4g} B, {bounds[i][1]:.4g} FP32 ops), "
                  f"{km / bm:.0f}x the bound")
        n_calls = len(sel)
        mean_b = sum(b for b, _ in b_ms) / n_calls
        by = bound(sum(b for b, _ in bounds), sum(o for _, o in bounds))[1]
        stream_rows[kind] = dict(ms=sum(k_ms) / n_calls, plain_ms=sum(p_ms) / n_calls, bound_ms=mean_b, bound_by=by,
                                 calls_per_pass=n_calls)
        print(f"{kind}: {n_calls} calls per pass; mean per call kernel {stream_rows[kind]['ms']:.4f} ms, "
              f"plain {stream_rows[kind]['plain_ms']:.2f} ms, bound {mean_b:.6f} ms ({by})")

    pass_ms = []
    for _ in range(3):
        t0 = time.time()
        wavefront.render_pass_fast(scene, 11, BIG_W, BIG_H, BIG_SPP, big_cfg)
        torch.cuda.synchronize()
        pass_ms.append((time.time() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.time()
    wavefront.render_passes_fast(scene, 0, 8, BIG_W, BIG_H, BIG_SPP, 8, big_cfg)
    torch.cuda.synchronize()
    batch_s = time.time() - t0
    _, iters, rays = wavefront.render_pass_fast_stats(scene, 11, BIG_W, BIG_H, BIG_SPP, big_cfg)
    big_samples = BIG_W * BIG_H * BIG_SPP
    print(f"timing config 5 wavefront pass on {card}: {', '.join(f'{x:.1f}' for x in pass_ms)} ms "
          f"(host clock, scene prepared each pass); 8 passes in {batch_s * 1e3:.1f} ms = "
          f"{8 * big_samples / batch_s:.4g} samples/s; iterations {iters}, rays traced {rays:.0f}")
    prep_ms = timed(lambda: geometry.prepare_scene(scene), 3)
    prof = profile_device(lambda: wavefront.render_pass_fast(scene, 11, BIG_W, BIG_H, BIG_SPP, big_cfg))
    per_name = prof["per_name"]
    stream_ms = sum(ms for name, (ms, _) in per_name.items() if "nearest_kernel" in name or "occluded_kernel" in name)
    n_kernels = sum(n for _, n in per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"profile config 5 pass on {card}: wall {prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.2f} ms "
          f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), {n_kernels} device operations, K5+K6 {stream_ms:.2f} ms; "
          f"prepare_scene {prep_ms:.2f} ms (CUDA events); top: "
          + "; ".join(f"{name[:60]} {ms:.2f} ms x{n}" for name, (ms, n) in top))

    # no single PyTorch call computes a nearest-sphere or any-hit trace
    worst = {k: max(v[3][k] for v in recorded.values()) for k in ("nearest", "occluded")}
    scenes = {label: v[0] for label, v in recorded.items()}
    return [
        {
            "name": f"stream_{kind}",
            "route": "cuda",
            "source": "kajo_tpu_torch/csrc/stream_trace.cu",
            "replaces": "kajo_tpu/ops/pallas/stream_trace.py:967",
            "launches": launches,
            "max_abs_err": worst[kind],
            **{k: stream_rows[kind][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            **dict(zip(("registers", "spills"), ptxas_usage("stream_trace.cu", f"{kind}_kernel"))),
        }
        for kind, launches in (("nearest", k5_launches), ("occluded", k6_launches))
    ], scenes


GRAD_W, GRAD_H, GRAD_SPP, GRAD_D = 64, 48, 4, 3
MAIN_W, MAIN_H, MAIN_SPP = 512, 384, 16  # the main path's shape: caustics, RenderConfig()
INV_W, INV_H, INV_SPP, INV_D, INV_STEPS = 128, 96, 16, 4, 100  # BASELINE.md config 4's size
TANGENT_BAR = 1e-4  # K2: relative L2 gap of the tangent image
FIELD_BAR = (1e-4, 1e-7)  # K3/K4: max|kernel - plain| <= a max|plain| + b per field
# K4 on the mirror cluster, per sphere and entry: |kernel - plain| <= a
# sum|terms| + b, the terms being the lanes' g . d(sum)/dp (see hold_rows)
ROW_BAR = (1e-4, 1e-7)
CLUSTER_DEPTHS = (3, 6, 10, 20)  # K4's largest gradient on the mirror cluster per depth


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def hold_rows(label: str, scene, seed: int, g, w, h, spp, config, got: dict, want: dict) -> float:
    """K4 against its plain version sphere by sphere, for a scene whose
    gradients span many decades (a max over the field would hide the small
    rows): each entry's error on the scale of its own terms, sum over lanes
    of |g . d(lane's sum)/dp|, the lanes' tangents launched by K2 (one launch
    per sphere and direction: cx, cy, cz and the radius). Returns the largest
    |kernel - plain|."""
    from kajo_tpu_torch.ops import megakernel, megakernel_grad

    S = scene.num_spheres
    terms = torch.zeros((S, 4), dtype=torch.float32, device=g.device)
    for j in range(S):
        for p in range(4):
            tan = megakernel.scene_zero_tangent(scene)
            if p < 3:
                tan.sphere_transform[j, p, 3] = 1.0
            else:
                tan.sphere_radius[j] = 1.0
            ps, packed_dot = megakernel.prepare_pass_jvp(scene, tan, w, h, spp, config)
            _, sums_dot = megakernel.launch_kernel_jvp(ps, packed_dot, seed)
            terms[j, p] = (megakernel_grad.cotangent_lanes(ps, g) * sums_dot).abs().sum()
    worst = 0.0
    for k, scale in (("center", terms[:, :3]), ("radius", terms[:, 3])):
        err = (got[k] - want[k]).abs()
        lim = ROW_BAR[0] * scale + ROW_BAR[1]
        finite = bool(torch.isfinite(got[k]).all())
        rows = want[k].reshape(S, -1)
        row_gap = (got[k] - want[k]).reshape(S, -1).norm(dim=1) / rows.norm(dim=1).clamp_min(1e-30)
        print(f"{label} {k}, per sphere: max |kernel - plain| / limit {(err / lim).max().item():.3e} (<= 1; limit "
              f"{ROW_BAR[0]} sum|terms| + {ROW_BAR[1]}); the rows' max|plain| "
              f"{rows.abs().amax(1).min().item():.3g} .. {rows.abs().amax(1).max().item():.3g}, relative L2 gap "
              f"per row {row_gap.min().item():.2e} .. {row_gap.max().item():.2e}; finite={finite}")
        if not (finite and bool((err <= lim).all())):
            fail(f"{label} {k}: sphere rows {torch.nonzero((err > lim).reshape(S, -1).any(1)).flatten().tolist()}")
        worst = max(worst, err.max().item())
    return worst


def hold_fields(label: str, got: dict, want: dict) -> float:
    """Check every field of a gradient dictionary against the plain one;
    returns the largest |kernel - plain|."""
    worst = 0.0
    for k in want:
        err = (got[k] - want[k]).abs().max().item()
        lim = FIELD_BAR[0] * want[k].abs().max().item() + FIELD_BAR[1]
        finite = bool(torch.isfinite(got[k]).all())
        print(f"{label} {k}: max|kernel - plain| {err:.3e} (<= {lim:.3e}), "
              f"max|plain| {want[k].abs().max().item():.4g}, "
              f"finite={finite}")
        if not (finite and err <= lim):
            fail(f"{label} {k}")
        worst = max(worst, err)
    return worst


def hold_repeat(label: str, got: dict, again: dict) -> None:
    """Check that a gradient kernel gave the same bits twice on the same
    inputs (its tables are exact sums, csrc/exact_sum.cuh)."""
    torch.cuda.synchronize()
    same = all(torch.equal(got[k].view(torch.int32), again[k].view(torch.int32)) for k in got)
    print(f"{label}: the same inputs twice give the same bits {same}")
    if not same:
        fail(f"{label}: two calls on the same inputs differ")


def inverse_run(engine: str, card: str) -> dict:
    """Phase 12 for one engine: the entry point, launches counted from 0 ->
    its summary and the launch counts."""
    from kajo_tpu_torch import inverse_rendering
    from kajo_tpu_torch.ops import megakernel, megakernel_geom, megakernel_grad

    OUT.mkdir(parents=True, exist_ok=True)
    summary = OUT / f"inverse_{engine}.json"
    megakernel.kernel_launches = megakernel.jvp_launches = 0
    megakernel_grad.kernel_launches = megakernel_geom.kernel_launches = 0
    t0 = time.time()
    rc = inverse_rendering.main(["--engine", engine, "-w", str(INV_W), "-h", str(INV_H), "--spp", str(INV_SPP),
                                 "--depth", str(INV_D), "--steps", str(INV_STEPS),
                                 "--out-prefix", str(OUT / f"inverse_{engine}"), "--summary", str(summary)])
    counts = dict(K1=megakernel.kernel_launches, K2=megakernel.jvp_launches, K3=megakernel_grad.kernel_launches,
                  K4=megakernel_geom.kernel_launches)
    rec = json.loads(summary.read_text())
    losses = np.asarray(rec["losses"])
    print(f"gradient path, engine {engine}: rc={rc} in {time.time() - t0:.1f} s; launches {counts}; "
          f"{rec['ms_per_step']:.3f} ms per step (CUDA events) on {card}; loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
          f"sphere offset {rec['offset'][0]:.4f} -> {rec['offset'][1]:.4f}; "
          f"ground albedo error {rec['albedo_error'][0]:.4f} -> {rec['albedo_error'][1]:.4f}")
    extra = 3  # K1 renders of the target and of the start and recovered PNGs
    want = (dict(K1=2 * INV_STEPS + extra, K2=0, K3=2 * INV_STEPS, K4=2 * INV_STEPS) if engine == "mega"
            else dict(K1=extra, K2=6 * INV_STEPS, K3=0, K4=0))
    if rc != 0 or counts != want:
        fail(f"engine {engine}: launches {counts}, want {want} (rc {rc})")
    if not np.isfinite(losses).all() or not rec["offset"][1] < rec["offset"][0]:
        fail(f"engine {engine}: a loss is not finite or the sphere's offset did not shrink")
    if engine == "mega" and not rec["albedo_error"][1] < rec["albedo_error"][0]:
        fail("engine mega: the ground's albedo error did not shrink")
    return dict(rec, launches=counts)


def walk_counts(ps, seed: int):
    """The plain walk's path and shadow rays, and per lane and sample its
    path rays and the distinct spheres it hits (at most TRACK_SLOTS + L)
    -> (stats, Σ rays x spheres hit over lanes and samples)."""
    from kajo_tpu_torch.ops import megakernel, megakernel_geom

    stats, log = {}, []
    megakernel.trace_lanes_plain(ps, seed, stats, hit_log=log)
    n, eff, P = ps.n_lanes, ps.eff, ps.n_planes
    rays = torch.zeros((n, eff), dtype=torch.int64, device=ps.packed.device)
    lanes = torch.arange(n, device=ps.packed.device)
    for sample, _, active in log:
        rays[lanes[active], sample[active]] += 1
    hit = torch.zeros((n, eff, max(ps.n_spheres, 1)), dtype=torch.bool, device=ps.packed.device)
    for sample, obj, active in log:
        m = active & (obj >= P)
        hit[lanes[m], sample[m], (obj - P)[m]] = True
    n_hit = hit.sum(-1).clamp_max(megakernel_geom.TRACK_SLOTS + ps.n_lights)
    return stats, float((rays * n_hit).sum())


def grad_bounds(ps, seed: int) -> dict:
    """Each gradient kernel's bound on this pass's data -> {K: (ms, what
    bounds it, bytes, FP32 operations)}; see the module docstring."""
    stats, rays_x_spheres = walk_counts(ps, seed)
    per_ray = ps.n_planes * OPS_PLANE + ps.n_spheres * (OPS_SPHERE_RIGID if ps.rigid else OPS_SPHERE_GENERAL)
    per_test = OPS_SPHERE_RIGID if ps.rigid else OPS_SPHERE_GENERAL
    once = ps.n_spheres * OPS_SPHERE_RIGID_ONCE if ps.rigid else 0
    walk_ops = (stats["rays"] + stats["shadow_rays"]) * per_ray
    lanes_b = 4 * ps.n_lanes
    fpb = ps.packed.numel() * 4
    nee_lights = (1 if ps.one_light else ps.n_lights) if ps.nee_on else 0
    k4_tangent = 2 * per_test + OPS_SHADE_TANGENT + nee_lights * OPS_NEE_TANGENT  # per direction
    ops = {
        "K2": walk_ops + stats["rays"] * 2 * per_test + once,
        "K3": 2 * walk_ops + once,
        # one walk on values + the four directions' tangent operations per
        # path ray and tracked sphere (the function's, not a design's)
        "K4": walk_ops + 4 * rays_x_spheres * k4_tangent + once,
    }
    bytes_ = {
        "K2": 2 * fpb + 6 * lanes_b,
        "K3": fpb + 3 * lanes_b + (ps.n_planes + ps.n_spheres + 1) * 9 * 4,
        "K4": fpb + 3 * lanes_b + ps.n_spheres * 4 * 4,
    }
    print(f"gradient walks at {ps.width}x{ps.height} {ps.spp}spp depth {ps.config.max_depth}: {stats['rays']} path + "
          f"{stats['shadow_rays']} shadow rays per walk set, {rays_x_spheres:.0f} path rays x tracked spheres, "
          f"{per_ray} FP32 ops per ray, K4 {k4_tangent} tangent ops per direction, path ray and tracked sphere")
    return {k: (*bound(bytes_[k], ops[k]), bytes_[k], ops[k]) for k in ops}


# each gradient kernel's source and the name of its entry, for ptxas' report
GRAD_ENTRIES = {"K2": ("megakernel_jvp.cu", "megakernel_jvp"), "K3": ("megakernel_grad.cu", "material_grads"),
                "K4": ("megakernel_geom.cu", "geometry_grads")}


def gradient_phases(dev, card: str) -> list:
    """Phases 11-13 (K2, K3, K4) -> their records for the kernels line."""
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.ops import _nvcc, megakernel, megakernel_geom, megakernel_grad
    from kajo_tpu_torch.scene import parser
    from kajo_tpu_torch.scene.procedural import random_spheres_scene
    from kajo_tpu_torch.scene.testscene import build_mirror_cluster, build_test_scene, build_two_light_scene

    # 11. K2, K3, K4 against their plain versions on the card
    gw, gh, gspp = GRAD_W, GRAD_H, GRAD_SPP
    caustics = str(ROOT / "data" / "caustics.json")
    cfg = RenderConfig(max_depth=GRAD_D)
    inv_cfg = RenderConfig(max_depth=INV_D)
    inv_label = f"build_test_scene (the gradient path's) {INV_W}x{INV_H} {INV_SPP}spp depth {INV_D}"
    cluster = build_mirror_cluster(gw / gh, dev)
    cases = [  # (label, scene, width, height, spp, config, kernels)
        ("caustics", parser.load(caustics, gw / gh, dev), gw, gh, gspp, cfg, "234"),
        ("scaled.json", parser.load(str(ROOT / "data" / "scaled.json"), gw / gh, dev), gw, gh, gspp, cfg, "234"),
        ("two-light one_light_nee", build_two_light_scene(gw / gh, dev), gw, gh, gspp,
         RenderConfig(max_depth=GRAD_D, one_light_nee=True), "234"),
        ("caustics full_mis", parser.load(caustics, gw / gh, dev), gw, gh, gspp,
         RenderConfig(max_depth=GRAD_D, full_mis=True), "234"),
        ("random_spheres_scene(40) K=43", random_spheres_scene(40, seed=11, extent=10.0, n_lights=2,
                                                               aspect_ratio=gw / gh, device=dev), gw, gh, gspp, cfg, "3"),
        ("random_spheres_scene(200)", random_spheres_scene(200, seed=5, extent=12.0, n_lights=2, aspect_ratio=gw / gh,
                                                           device=dev), gw, gh, gspp, cfg, "4"),
        ("mirror cluster", cluster, gw, gh, gspp, RenderConfig(max_depth=20), "4"),
        ("caustics, K2 in two waves", parser.load(caustics, 16 / 12, dev), 16, 12, 144, cfg, "2"),
        ("caustics, K2 at depth 100", parser.load(caustics, 8 / 6, dev), 8, 6, 81, RenderConfig(max_depth=100),
         "2"),
        (inv_label, build_test_scene(INV_W / INV_H, dev), INV_W, INV_H, INV_SPP, inv_cfg, "234"),
    ]
    worst = {"K2": 0.0, "K3": 0.0, "K4": 0.0}
    plain_ms = {}  # at the gradient path's shape
    for label, scene, w, h, spp, config, kernels in cases:
        main_shape = label == inv_label
        if not main_shape:
            label = f"{label} {w}x{h} {spp}spp depth {config.max_depth}"
        g = torch.rand((h, w, 3), generator=torch.Generator().manual_seed(0)).to(dev)
        if "2" in kernels:
            tan = megakernel.scene_zero_tangent(scene)
            tan.sphere_transform[0, 0, 3] = 1.0
            tan.sphere_transform[1, 0, 3] = 1.0
            tan.sphere_radius[1] = 1.0
            tan.materials.diffuse[0, 1] = 1.0
            ps, packed_dot = megakernel.prepare_pass_jvp(scene, tan, w, h, spp, config)
            k1 = megakernel.launch_kernel(ps, 2024)
            sums, sums_dot = megakernel.launch_kernel_jvp(ps, packed_dot, 2024)
            k1_plain = megakernel.trace_lanes_plain(ps, 2024)
            torch.cuda.synchronize()
            k1_same = torch.equal(k1.view(torch.int32), k1_plain.view(torch.int32))
            print(f"K1 {label}: sums == its plain version's (bits) {k1_same}; {k1_regime(ps)}")
            if not k1_same:
                fail(f"K1 {label}")
            t0 = time.time()
            want, want_dot = megakernel.trace_lanes_plain_jvp(ps, packed_dot, 2024)
            torch.cuda.synchronize()
            if main_shape:
                plain_ms["K2"] = (time.time() - t0) * 1e3
            same = torch.equal(sums.view(torch.int32), k1.view(torch.int32))
            gap = rel_l2(sums_dot, want_dot)
            finite = bool(torch.isfinite(sums_dot).all())
            plan = megakernel.jvp_plan(ps.n_lanes, ps.eff, config.max_depth)
            print(f"K2 {label}: image == K1's (bits) {same}; tangent relative L2 gap {gap:.3e} (<= {TANGENT_BAR}); "
                  f"finite={finite}; plan: {plan.per_block} sample(s) a thread, CTAs of {plan.lanes_per_cta} "
                  f"lane(s) x {plan.wave} thread(s), {plan.waves} wave(s), {plan.shared} B of shared memory")
            if not (same and gap <= TANGENT_BAR and finite):
                fail(f"K2 {label}")
            worst["K2"] = max(worst["K2"], (sums_dot - want_dot).abs().max().item())
        if "3" in kernels:
            got = megakernel_grad.material_grads(scene, 2024, g, w, h, spp, config)
            hold_repeat(f"K3 {label}", got, megakernel_grad.material_grads(scene, 2024, g, w, h, spp, config))
            t0 = time.time()
            want = megakernel_grad.material_grads_plain(scene, 2024, g, w, h, spp, config)
            torch.cuda.synchronize()
            if main_shape:
                plain_ms["K3"] = (time.time() - t0) * 1e3
            worst["K3"] = max(worst["K3"], hold_fields(f"K3 {label}", got, want))
        if "4" in kernels:
            got = megakernel_geom.geometry_grads(scene, 2024, g, w, h, spp, config)
            hold_repeat(f"K4 {label}", got, megakernel_geom.geometry_grads(scene, 2024, g, w, h, spp, config))
            t0 = time.time()
            want = megakernel_geom.geometry_grads_plain(scene, 2024, g, w, h, spp, config)
            torch.cuda.synchronize()
            if main_shape:
                plain_ms["K4"] = (time.time() - t0) * 1e3
            if scene is cluster:
                worst["K4"] = max(worst["K4"], hold_rows(f"K4 {label}", scene, 2024, g, w, h, spp, config, got, want))
            else:
                worst["K4"] = max(worst["K4"], hold_fields(f"K4 {label}", got, want))
        if main_shape:
            print(f"plain versions at {inv_label} on {card}: "
                  + ", ".join(f"{k} {v:.1f} ms" for k, v in plain_ms.items()))
    # how the mirror cluster's gradients grow with the depth of its mirror chains
    g = torch.rand((gh, gw, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    growth = {d: megakernel_geom.geometry_grads(cluster, 2024, g, gw, gh, gspp, RenderConfig(max_depth=d))["center"]
              .abs().max().item() for d in CLUSTER_DEPTHS}
    print(f"K4 mirror cluster {gw}x{gh} {gspp}spp, max|centre gradient| per max_depth: "
          + ", ".join(f"{d}: {v:.3g}" for d, v in growth.items()))

    # 12. the gradient path through its entry point
    runs = {engine: inverse_run(engine, card) for engine in ("mega", "mega-fwd")}
    scene = build_test_scene(INV_W / INV_H, dev)
    ps = megakernel.prepare_pass(scene, INV_W, INV_H, INV_SPP, inv_cfg)
    ps3 = megakernel.prepare_pass(scene, INV_W, INV_H, INV_SPP, dataclasses.replace(inv_cfg, regen_threshold=0.0))
    gl = megakernel_grad.cotangent_lanes(ps, torch.rand((INV_H, INV_W, 3), device=dev))
    tan = megakernel.scene_zero_tangent(scene)
    tan.sphere_transform[1, 0, 3] = 1.0
    ps2, packed_dot = megakernel.prepare_pass_jvp(scene, tan, INV_W, INV_H, INV_SPP, inv_cfg)
    share = {
        "K1": timed(lambda: megakernel.launch_kernel(ps, 5), 20),
        "K3": timed(lambda: megakernel_grad.launch_kernel(ps3, gl, 5), 20),
        "K4": timed(lambda: megakernel_geom.launch_kernel(ps, gl, 5), 10),
    }
    k2_ms = timed(lambda: megakernel.launch_kernel_jvp(ps2, packed_dot, 5), 20)
    step_ms, fwd_ms = runs["mega"]["ms_per_step"], runs["mega-fwd"]["ms_per_step"]
    print(f"engine mega step at {INV_W}x{INV_H} {INV_SPP}spp depth {INV_D} on {card}: {step_ms:.3f} ms; per launch "
          + ", ".join(f"{k} {v:.4f} ms (2 per step: {100 * 2 * v / step_ms:.1f}%)" for k, v in share.items())
          + f"; engine mega-fwd step {fwd_ms:.3f} ms, K2 {k2_ms:.4f} ms per launch (6 per step: "
          f"{100 * 6 * k2_ms / fwd_ms:.1f}%)")
    print(f"K1 at {inv_label}: {k1_regime(ps)}; "
          + "; ".join(f"{name} {regs} registers, {spills} B spill stores"
                      for name, regs, spills in ptxas_entries("megakernel.cu", "megakernel_")))
    ms = {"K2": k2_ms, "K3": share["K3"], "K4": share["K4"]}
    usage = {k: ptxas_usage(source, entry) for k, (source, entry) in GRAD_ENTRIES.items()}
    bounds = grad_bounds(ps, 5)
    for k in ("K2", "K3", "K4"):
        b_ms, by, n_bytes, n_ops = bounds[k]
        print(f"timing {k} {inv_label} on {card}: kernel {ms[k]:.4f} ms per launch, plain {plain_ms[k]:.1f} ms, "
              f"bound {b_ms:.5f} ms ({by}: {n_bytes:.4g} B, {n_ops:.4g} FP32 ops), {ms[k] / b_ms:.0f}x the bound; "
              f"{usage[k][0]} registers, {usage[k][1]} B spill stores")

    # 13. K2, K3, K4 at the main render path's shape
    w, h, spp = MAIN_W, MAIN_H, MAIN_SPP
    config = RenderConfig()
    scene = parser.load(caustics, w / h, dev)
    tan = megakernel.scene_zero_tangent(scene)
    tan.sphere_transform[0, 0, 3] = 1.0
    ps, packed_dot = megakernel.prepare_pass_jvp(scene, tan, w, h, spp, config)
    ps3 = megakernel.prepare_pass(scene, w, h, spp, dataclasses.replace(config, regen_threshold=0.0))
    gl = megakernel_grad.cotangent_lanes(ps, torch.rand((h, w, 3), generator=torch.Generator().manual_seed(1)).to(dev))
    seed = 99
    big_ms = {
        "K2": min(timed(lambda: megakernel.launch_kernel_jvp(ps, packed_dot, seed), 10) for _ in range(2)),
        "K3": min(timed(lambda: megakernel_grad.launch_kernel(ps3, gl, seed), 10) for _ in range(2)),
        "K4": min(timed(lambda: megakernel_geom.launch_kernel(ps, gl, seed), 3) for _ in range(2)),
    }
    k1 = megakernel.launch_kernel(ps, seed)
    sums, sums_dot = megakernel.launch_kernel_jvp(ps, packed_dot, seed)
    torch.cuda.synchronize()
    t0 = time.time()
    _, want_dot = megakernel.trace_lanes_plain_jvp(ps, packed_dot, seed)
    torch.cuda.synchronize()
    k2_plain_ms = (time.time() - t0) * 1e3
    same = torch.equal(sums.view(torch.int32), k1.view(torch.int32))
    gap = rel_l2(sums_dot, want_dot)
    print(f"K2 caustics {w}x{h} {spp}spp: image == K1's (bits) {same}; tangent relative L2 gap {gap:.3e} "
          f"(<= {TANGENT_BAR}) against the plain version ({k2_plain_ms:.1f} ms)")
    if not (same and gap <= TANGENT_BAR and bool(torch.isfinite(sums_dot).all())):
        fail(f"K2 at caustics {w}x{h} {spp}spp")
    big_bounds = grad_bounds(ps, seed)
    for k in ("K2", "K3", "K4"):
        b_ms, by, n_bytes, n_ops = big_bounds[k]
        print(f"timing {k} caustics {w}x{h} {spp}spp on {card}: kernel {big_ms[k]:.4f} ms per launch, bound "
              f"{b_ms:.5f} ms ({by}: {n_bytes:.4g} B, {n_ops:.4g} FP32 ops), {big_ms[k] / b_ms:.0f}x the bound; "
              f"{usage[k][0]} registers, {usage[k][1]} B spill stores"
              + (f", plain {k2_plain_ms:.1f} ms" if k == "K2" else
                 " (the plain version's reverse-mode graph at this size would not fit in the card's memory)"))
    for source in ("megakernel_jvp.cu", "megakernel_grad.cu", "megakernel_geom.cu"):
        for line in _nvcc.library_path(source).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {source}:", line.strip())

    meta = {
        "K2": ("megakernel_jvp", "kajo_tpu_torch/csrc/megakernel_jvp.cu", "kajo_tpu/ops/pallas/megakernel.py:939",
               runs["mega-fwd"]["launches"]["K2"]),
        "K3": ("material_grads", "kajo_tpu_torch/csrc/megakernel_grad.cu", "kajo_tpu/ops/pallas/megakernel_grad.py:841",
               runs["mega"]["launches"]["K3"]),
        "K4": ("geometry_grads", "kajo_tpu_torch/csrc/megakernel_geom.cu", "kajo_tpu/ops/pallas/megakernel_geom.py:923",
               runs["mega"]["launches"]["K4"]),
    }
    return [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "shape": inv_label,  # ms, plain_ms and bound_ms: the gradient path's launches
            "launches": launches,
            "max_abs_err": worst[k],
            "ms": ms[k],
            "plain_ms": plain_ms[k],
            "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1],
            "library_ms": None,  # no PyTorch call computes a gradient pass
            "registers": usage[k][0],
            "spills": usage[k][1],
        }
        for k, (name, source, replaces, launches) in meta.items()
    ]


DESIGNS = ("v1", "v1-frustum", "v1-near-far", "v2", "v3")  # K7 in three orders, K8, K9
DESIGN_KERNELS = {  # kernel name, source, the TPU kernel it replaces, what its entries' mangled names hold
    "v1": ("stream_nearest_v1", "kajo_tpu_torch/csrc/stream_trace_v1.cu", "kajo_tpu/ops/pallas/stream_trace.py:141",
           "nearest_v1"),
    "v2": ("stream_nearest_v2", "kajo_tpu_torch/csrc/stream_trace_v2.cu", "kajo_tpu/ops/pallas/stream_trace.py:516",
           "nearest_v2"),
    "v3": ("stream_nearest_v3", "kajo_tpu_torch/csrc/stream_trace_v3.cu", "kajo_tpu/ops/pallas/stream_trace.py:757",
           "v3_"),
}


def design_bound(args, scans):
    """(bytes, FP32 operations) one call of a nearest-hit design must move
    and do: the (ray, 128-sphere block) pairs its function scans, as its
    plain version counted them (``counting_scans``), each test at K5's
    operations without its roots, and the roots only on the (ray, sphere)
    pairs whose discriminant is >= 0; the boxes, the records of the blocks
    scanned, o, d and the bound in, t and row out."""
    rigid, o, packed, boxes = args[0], args[1], args[4], args[5]
    touched, tests, roots = len(scans["blocks"]), scans["pairs"] * 128, int(scans["roots"])
    n_bytes = boxes.numel() * 4 + touched * 128 * packed.shape[1] * 4 + o.shape[0] * (24 + 4 + 8)
    if rigid:
        n_ops = (tests * (OPS_SPHERE_RIGID - OPS_RIGID_ROOTS) + roots * OPS_RIGID_ROOTS
                 + touched * 128 * OPS_SPHERE_RIGID_ONCE)
    else:
        n_ops = tests * (OPS_SPHERE_GENERAL - OPS_GENERAL_ROOTS) + roots * OPS_GENERAL_ROOTS
    return n_bytes, n_ops


def hold_design_calls(scene, label: str, design: str) -> list:
    """Phase 14 for one scene and design: record every nearest-hit call of
    one config-5 pass under the design, hold the kernel against its plain
    version on each (same winner on every ray, t to the bit) and count the
    rays whose winner differs from K5's on the same inputs -> per call
    {args, t (the kernel's), t5 (K5's), plain_ms, max_abs, scans (what the
    plain version scanned, for the design's own bound)}."""
    from kajo_tpu_torch.models import wavefront
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.ops import stream_trace as st

    kind = design[:2]
    big_cfg = RenderConfig(max_depth=BIG_D, one_light_nee=True)
    with st.nearest_design(design):
        _, calls = record_stream_calls(lambda: wavefront.render_pass_fast(scene, 5, BIG_W, BIG_H, BIG_SPP, big_cfg))
    kinds = [k for k, _ in calls]
    if kind not in kinds or "nearest" in kinds:
        fail(f"config 5 {label} under {design}: nearest-hit calls went to {kinds}")
    launch, plain = getattr(st, f"launch_nearest_{kind}"), getattr(st, f"nearest_{kind}_plain")
    out = []
    for i, (k, args) in enumerate(calls):
        if k != kind:
            continue
        t_k, i_k = launch(*args)
        torch.cuda.synchronize()
        t0 = time.time()
        with st.counting_scans() as scans:
            t_p, i_p = plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        t_5, i_5 = st.launch_nearest(*args[:6])
        torch.cuda.synchronize()
        ok = torch.equal(i_k, i_p) and torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
        differ = i_k != i_5
        far = args[1][differ].norm(dim=1).max().item() if bool(differ.any()) else 0.0
        max_abs = (t_k - t_p).abs().max().item()
        print(f"config 5 {label} {design} call {i}: {args[1].shape[0]} rays, {int((i_p >= 0).sum())} hits; kernel == "
              f"plain on every ray (bits): {ok} (plain {plain_ms:.0f} ms); winners unlike K5's on {int(differ.sum())} "
              f"rays, largest origin norm among them {far:.4g}; {scans['pairs']} (ray, block) pairs scanned, "
              f"{int(scans['roots'])} (ray, sphere) pairs with discr >= 0")
        if not ok:
            fail(f"config 5 {label} {design}: kernel and plain version differ on call {i}")
        out.append(dict(args=args, t=t_k, t5=t_5, plain_ms=plain_ms, max_abs=max_abs, scans=scans))
    return out


def design_phases(dev, card: str, scenes: dict) -> list:
    """Phases 14-16 (K7, K8, K9) -> their records for the kernels line."""
    from kajo_tpu_torch import cli
    from kajo_tpu_torch.models import wavefront
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.ops import stream_trace as st

    big_cfg = RenderConfig(max_depth=BIG_D, one_light_nee=True)

    # 14. every nearest-hit call of a config-5 pass under each design, kernel vs plain
    t0 = time.time()
    held = {(label, design): hold_design_calls(scene, label, design) for label, scene in scenes.items()
            for design in DESIGNS}
    print(f"phase 14: {time.time() - t0:.1f} s")

    # 15. the big-scene path through the CLI under each design (K5 first and last, as the
    # yardstick), launches counted from 0
    t0 = time.time()
    OUT.mkdir(parents=True, exist_ok=True)
    launches = {}
    counters = {"v4": "nearest_launches", "v1": "nearest_v1_launches", "v2": "nearest_v2_launches",
                "v3": "nearest_v3_launches"}
    for design in ("v4", *DESIGNS, "v4"):
        png = OUT / f"procedural_{BIG_N}_{design}.png"
        for c in (*counters.values(), "occluded_launches"):
            setattr(st, c, 0)
        err = io.StringIO()
        with st.nearest_design(design), contextlib.redirect_stderr(err):
            rc = cli.main(["--procedural", str(BIG_N), "-w", str(BIG_W), "-h", str(BIG_H), "--spp", str(BIG_SPP),
                           "--depth", str(BIG_D), "--passes", "8", "-o", str(png)])
        counts = {c: getattr(st, c) for c in (*counters.values(), "occluded_launches")}
        own = counters[design[:2]]
        launches[design] = counts[own]
        rates = re.findall(r"([0-9.]+[KMG]?) samples/s", err.getvalue())
        print(f"design {design}: cli rc={rc}, launches {counts}, CLI samples/s {rates}")
        alone = all(n == 0 for c, n in counts.items() if c not in (own, "occluded_launches"))
        if rc != 0 or counts[own] == 0 or not alone or counts["occluded_launches"] == 0:
            sys.stderr.write(err.getvalue())
            fail(f"the big-scene path under {design} did not run its kernel (and K6) alone")
        pixels = load_png(str(png)).astype(np.float64)
        print(f"png {png.relative_to(ROOT)}: shape {pixels.shape}, mean {pixels[..., :3].mean():.2f}")
        if pixels.shape != (BIG_H, BIG_W, 4) or not np.isfinite(pixels).all() or not pixels[..., :3].mean() > 0:
            fail(f"the big-scene path's PNG under {design}")
    for label, scene in scenes.items():
        want = wavefront.render_pass_fast(scene, 7, BIG_W, BIG_H, BIG_SPP, big_cfg)
        for design in DESIGNS:
            with st.nearest_design(design):
                got = wavefront.render_pass_fast(scene, 7, BIG_W, BIG_H, BIG_SPP, big_cfg)
            torch.cuda.synchronize()
            compare(f"wavefront pass {design} vs K5, config 5 {label}", got, want)
    print(f"phase 15: {time.time() - t0:.1f} s")

    # 16. per call on the recorded rigid calls: kernel (CUDA events), host lists, plain; its own bound and K5's
    t0 = time.time()
    scene = scenes["rigid"]
    for kind, (_, source, _, entry) in DESIGN_KERNELS.items():
        for mangled, regs, spills in ptxas_entries(Path(source).name, entry):
            print(f"ptxas {kind} {mangled}: {regs} registers, {spills} bytes spill stores")
    stats = {}
    for design in DESIGNS:
        kind = design[:2]
        launch = getattr(st, f"launch_nearest_{kind}")
        rows = held[("rigid", design)]
        per = []
        for i, row in enumerate(rows):
            args = row["args"]
            k_ms = timed(lambda a=args: launch(*a), 20)
            k5_ms = timed(lambda a=args, sb=st.v2_superblocks(args[5]): st.launch_nearest(*a[:6], sb), 20)
            has_lists = design in ("v1-frustum", "v1-near-far", "v2")
            l_ms = timed(lambda a=args: st.design_lists(design, *a[1:4], a[5]), 5) if has_lists else 0.0
            n_bytes, n_ops = design_bound(args, row["scans"])
            b_ms, by = bound(n_bytes, n_ops)
            b5_ms, by5 = bound(*call_bound("nearest", args[:6], row["t5"]))
            per.append((k_ms, l_ms, row["plain_ms"], b_ms, b5_ms, n_bytes, n_ops))
            kept = ""
            if has_lists:  # the recorded call's lists: (..., lists, counts)
                lists, counts = args[6][-2:]
                kept = f" (the lists keep {counts.float().mean().item():.1f} of {lists.shape[1]} per tile on average)"
            tiles = row["scans"]["tiles"].float()  # what each tile's vote admitted (K7, K8), from the plain scan
            if tiles.dim():
                mean = tiles.mean().item()
                kept += (f"; the votes admit {mean:.1f} a tile on average, at most {tiles.max().item():.0f}, "
                         f"{int((tiles > 4 * mean).sum())} of {tiles.numel()} tiles above 4x the mean")
            print(f"timing {design} call {i} ({args[1].shape[0]} rays) on {card}: kernel {k_ms:.4f} ms, host lists "
                  f"{l_ms:.4f} ms{kept}, plain {row['plain_ms']:.0f} ms, K5 {k5_ms:.4f} ms; own bound {b_ms:.6f} ms "
                  f"({by}: {row['scans']['pairs']} (ray, block) pairs, {int(row['scans']['roots'])} with roots, "
                  f"{n_ops:.4g} FP32 ops), {k_ms / b_ms:.1f}x it; "
                  f"K5's bound {b5_ms:.6f} ms ({by5}), {k_ms / b5_ms:.0f}x it")
        mean = [sum(x[j] for x in per) / len(per) for j in range(5)]
        by = bound(sum(x[5] for x in per), sum(x[6] for x in per))[1]
        stats[design] = dict(ms=mean[0], lists_ms=mean[1], plain_ms=mean[2], bound_ms=mean[3], k5_bound_ms=mean[4],
                             bound_by=by, calls_per_pass=len(per))
        print(f"{design}: {len(per)} calls per pass; mean per call kernel {mean[0]:.4f} ms, host lists "
              f"{mean[1]:.4f} ms, plain {mean[2]:.0f} ms, own bound {mean[3]:.6f} ms ({by}), {mean[0] / mean[3]:.1f}x; "
              f"K5's bound {mean[4]:.6f} ms, {mean[0] / mean[4]:.0f}x")
    # a pass and a batch of 8 under each design, K5 first and last
    for design in ("v4", *DESIGNS, "v4"):
        pass_ms = []
        with st.nearest_design(design):
            for _ in range(3):
                t1 = time.time()
                wavefront.render_pass_fast(scene, 11, BIG_W, BIG_H, BIG_SPP, big_cfg)
                torch.cuda.synchronize()
                pass_ms.append((time.time() - t1) * 1e3)
            t1 = time.time()
            wavefront.render_passes_fast(scene, 0, 8, BIG_W, BIG_H, BIG_SPP, 8, big_cfg)
            torch.cuda.synchronize()
            batch_s = time.time() - t1
        print(f"timing config 5 pass under {design} on {card}: {', '.join(f'{x:.1f}' for x in pass_ms)} ms "
              f"(host clock); 8 passes in {batch_s * 1e3:.1f} ms = "
              f"{8 * BIG_W * BIG_H * BIG_SPP / batch_s:.4g} samples/s")
    print(f"phase 16: {time.time() - t0:.1f} s")

    records = []
    for kind, (name, source, replaces, entry) in DESIGN_KERNELS.items():
        own = [d for d in DESIGNS if d[:2] == kind]
        row = stats[kind]
        records.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            # launches: the CLI runs of phase 15 under this kernel's designs
            "launches": sum(launches[d] for d in own),
            "max_abs_err": max(r["max_abs"] for label in scenes for d in own for r in held[(label, d)]),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,  # no single PyTorch call computes a nearest-sphere trace
            "k5_bound_ms": row["k5_bound_ms"],
            "lists_ms": row["lists_ms"],
            **dict(zip(("registers", "spills"), ptxas_usage(Path(source).name, entry))),
            **({"orders": {d: {k: stats[d][k] for k in ("ms", "lists_ms", "plain_ms", "bound_ms")} for d in own}}
               if len(own) > 1 else {}),
        })
    return records


EDGE_W = EDGE_H = 32  # tests/test_edges.py's size
EDGE_GRAD_BAR = 1e-3  # phase 18: relative L2 gap of the boundary gradients, card vs CPU


def parity_phases(dev, card: str, scenes: dict) -> None:
    """Phase 17: the parity engine (models/integrator.py), which runs no
    kernel of its own."""
    from kajo_tpu_torch import cli
    from kajo_tpu_torch.models.integrator import RenderConfig, render_image, render_pass
    from kajo_tpu_torch.ops import megakernel
    from kajo_tpu_torch.ops import stream_trace as st
    from kajo_tpu_torch.scene import parser
    from kajo_tpu_torch.scene.testscene import build_two_light_scene

    caustics = str(ROOT / "data" / "caustics.json")
    cpu = torch.device("cpu")
    # 17a. a parity pass on the card against the same pass (the same counter stream) on the CPU
    cases = [
        ("caustics", lambda d: parser.load(caustics, 64 / 48, d), RenderConfig()),
        ("scaled.json", lambda d: parser.load(str(ROOT / "data" / "scaled.json"), 64 / 48, d), RenderConfig()),
        ("two-light one_light_nee", lambda d: build_two_light_scene(64 / 48, d), RenderConfig(one_light_nee=True)),
    ]
    for label, load, config in cases:
        got = render_pass(load(dev), 2024, 64, 48, 4, config).cpu()
        want = render_pass(load(cpu), 2024, 64, 48, 4, config)
        rel = ((got - want).abs() / want.abs().clamp_min(1.0)).amax(-1)
        print(f"parity {label} 64x48 4spp card vs CPU: share of pixels beyond 1e-5 relative "
              f"{float((rel > 1e-5).float().mean()):.4f}, beyond 1e-3 {float((rel > 1e-3).float().mean()):.4f}")
        compare(f"parity {label} 64x48 4spp card vs CPU", got, want)

    # 17b. the C++ golden, through the engine that mirrors the reference's CPU backend
    img = render_image(parser.load(caustics, 32 / 24, dev), 32, 24, 16, 17, passes=10).cpu()
    golden = torch.from_numpy(
        np.fromfile(ROOT / "tests" / "goldens" / "caustics_32x24.raw", np.float32).reshape(24, 32, 4)
    )
    compare("parity golden caustics 32x24 16spp 10 passes vs C++ reference", img, golden, 0.1, 0.25)

    # 17c. -r cpu through the CLI: the parity engine, and no K1
    OUT.mkdir(parents=True, exist_ok=True)
    w, h, spp = MAIN_W, MAIN_H, MAIN_SPP
    png = OUT / f"parity_caustics_{w}x{h}.png"
    megakernel.kernel_launches = 0
    err = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["-r", "cpu", "-w", str(w), "-h", str(h), "--spp", str(spp), "--passes", "2", caustics,
                       "-o", str(png)])
    sys.stderr.write(err.getvalue())
    engine_lines = [ln for ln in err.getvalue().splitlines() if ln.startswith("engine")]
    print(f"parity path: cli -r cpu rc={rc} in {time.time() - t0:.1f} s, {engine_lines}, "
          f"K1 launches {megakernel.kernel_launches}")
    if rc != 0 or engine_lines != [f"engine: parity on {dev}"] or megakernel.kernel_launches != 0:
        fail("-r cpu did not run the parity engine (or launched K1)")
    pixels = load_png(str(png)).astype(np.float64)
    print(f"png {png.relative_to(ROOT)}: shape {pixels.shape}, mean {pixels[..., :3].mean():.2f}")
    if pixels.shape != (h, w, 4) or not np.isfinite(pixels).all() or not pixels[..., :3].mean() > 0:
        fail("the parity path's PNG")
    scene = parser.load(caustics, w / h, dev)
    render_pass(scene, 3, w, h, spp)
    ms = timed(lambda: render_pass(scene, 3, w, h, spp), 3)
    print(f"timing parity pass caustics {w}x{h} {spp}spp on {card}: {ms:.1f} ms per pass "
          f"({w * h * spp / (ms / 1e3):.4g} samples/s; K1's pass is in phase 6)")

    # 17d. config 5 through the parity engine: its traces go through K5
    cfg = RenderConfig(max_depth=BIG_D, one_light_nee=True)
    scene = scenes["rigid"]
    st.nearest_launches = st.occluded_launches = 0
    img = render_pass(scene, 5, BIG_W, BIG_H, BIG_SPP, cfg)
    torch.cuda.synchronize()
    k5, k6 = st.nearest_launches, st.occluded_launches
    finite = bool(torch.isfinite(img).all())
    print(f"parity pass config 5 rigid {BIG_W}x{BIG_H} {BIG_SPP}spp depth {BIG_D}: K5 launches {k5}, K6 launches "
          f"{k6}, finite {finite}, mean {img[..., :3].mean().item():.4g}")
    if k5 == 0 or not finite:
        fail("the parity engine's config-5 pass did not trace through K5")
    ms = timed(lambda: render_pass(scene, 5, BIG_W, BIG_H, BIG_SPP, cfg), 3)
    print(f"timing parity pass config 5 rigid {BIG_W}x{BIG_H} {BIG_SPP}spp depth {BIG_D} on {card}: {ms:.1f} ms "
          f"per pass ({BIG_W * BIG_H * BIG_SPP / (ms / 1e3):.4g} samples/s)")
    report_profile(f"parity pass config 5 rigid {BIG_W}x{BIG_H} {BIG_SPP}spp depth {BIG_D}", card,
                   profile_device(lambda: render_pass(scene, 5, BIG_W, BIG_H, BIG_SPP, cfg)))


def hold_grads(label: str, got, want, names=("centre", "radius")) -> None:
    """Gradients, card against CPU: relative L2 gap per output and no entry
    of another sign (among entries above 1% of the largest)."""
    for name, g, w in zip(names, got, want):
        g, w = g.cpu(), w.cpu()
        gap = rel_l2(g, w)
        big = w.abs() > 0.01 * w.abs().max()
        flips = int((torch.sign(g[big]) != torch.sign(w[big])).sum())
        ok = bool(torch.isfinite(g).all()) and gap <= EDGE_GRAD_BAR and flips == 0 and float(w.abs().max()) > 0
        values = f"card {g.flatten().tolist()} CPU {w.flatten().tolist()}; " if g.numel() <= 8 else ""
        print(f"{label} {name}: {values}relative L2 gap {gap:.3e} (<= {EDGE_GRAD_BAR}), sign flips {flips} "
              f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"{label} {name} gradient, card against CPU")


def edge_phases(dev, card: str) -> None:
    """Phase 18: the boundary terms (diff/edges.py) on engine mega."""
    from kajo_tpu_torch import inverse_rendering, silhouette_recovery
    from kajo_tpu_torch.diff import edges
    from kajo_tpu_torch.diff.inverse import InverseRenderer
    from kajo_tpu_torch.models.integrator import RenderConfig, render_image
    from kajo_tpu_torch.ops import megakernel, megakernel_geom, megakernel_grad
    from kajo_tpu_torch.ops.rng import CounterKey
    from kajo_tpu_torch.scene.testscene import build_shadow_scene, build_silhouette_scene

    cpu = torch.device("cpu")
    w, h = EDGE_W, EDGE_H
    ramp = (torch.arange(w, dtype=torch.float32) / w)[None, :, None].expand(h, w, 3).contiguous()
    noise = torch.from_numpy(np.random.default_rng(4).normal(size=(h, w, 3)).astype(np.float32))
    # 18a. both gradient functions on the card against the CPU, the same key
    cases = ((edges.silhouette_loss_grads, lambda d: build_silhouette_scene(0.3, -0.2, device=d),
              RenderConfig(max_depth=2), 256),
             (edges.shadow_silhouette_grads, lambda d: build_shadow_scene(2.0, d), RenderConfig(max_depth=1), 4))
    for cot_label, cot in (("ramp", ramp), ("random", noise)):
        for fn, scene_of, cfg, n in cases:
            hold_grads(f"{fn.__name__} {cot_label} {w}x{h} n_edge {n}",
                       fn(scene_of(dev), CounterKey(1), cot.to(dev), w, h, cfg, n),
                       fn(scene_of(cpu), CounterKey(1), cot, w, h, cfg, n))

    # 18b. the silhouette recovery at its own size on engine mega, launches counted from 0
    OUT.mkdir(parents=True, exist_ok=True)
    summary = OUT / "silhouette.json"
    megakernel.kernel_launches = megakernel_grad.kernel_launches = megakernel_geom.kernel_launches = 0
    t0 = time.time()
    rc = silhouette_recovery.main(["--out-prefix", str(OUT / "silhouette"), "--summary", str(summary)])
    counts = dict(K1=megakernel.kernel_launches, K3=megakernel_grad.kernel_launches,
                  K4=megakernel_geom.kernel_launches)
    rec = json.loads(summary.read_text())
    steps, errors = rec["steps"], rec["errors"]
    print(f"silhouette recovery: rc={rc} in {time.time() - t0:.1f} s, engine {rec['engine']}, launches {counts}; "
          f"position error by step {errors}; {rec['ms_per_step']:.3f} ms per step (CUDA events) on {card}")
    want = dict(K1=2 * steps, K3=2 * steps, K4=2 * steps)
    if rc != 0 or rec["engine"] != "mega" or counts != want:
        fail(f"the silhouette recovery: launches {counts}, want {want} (rc {rc})")
    if not errors[-1][1] < 0.5 * errors[0][1]:
        fail("the silhouette recovery's position error did not fall below half its start")
    size = rec["size"]
    scene = build_silhouette_scene(*silhouette_recovery.START, silhouette_recovery.BACKGROUND, dev)
    cot = torch.rand((size, size, 4), device=dev)
    edge_ms = timed(lambda: edges.silhouette_loss_grads(scene, CounterKey(2), cot, size, size,
                                                        RenderConfig(max_depth=2), rec["n_edge"]), 5)
    print(f"silhouette recovery step on {card}: the boundary term {edge_ms:.3f} ms of {rec['ms_per_step']:.3f} "
          f"({100 * edge_ms / rec['ms_per_step']:.1f}%)")

    # 18c. recover an out-of-frame occluder from its cast shadow, on engine mega
    cfg = RenderConfig(max_depth=1)
    target = render_image(build_shadow_scene(2.0, dev), w, h, 16, 7, passes=2, config=cfg)
    inv = InverseRenderer(build_shadow_scene(2.3, dev), target, w, h, spp=16, config=cfg,
                          param_spec=("sphere_transform",), shadow_edges=True, n_shadow_edge=8, n_edge=64,
                          learning_rate=3e-2, engine="mega", seed=9)
    trail = []
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    for i in range(25):
        inv.step()
        if (i + 1) % 5 == 0:
            trail.append(abs(float(inv.params["sphere_transform"].detach()[0, 0, 3]) - 2.0))
    ev1.record()
    torch.cuda.synchronize()
    shadow_ms = ev0.elapsed_time(ev1) / 25
    scene = build_shadow_scene(2.3, dev)
    cot = torch.rand((h, w, 4), device=dev)
    term_ms = timed(lambda: (edges.silhouette_loss_grads(scene, CounterKey(2), cot, w, h, cfg, 64),
                             edges.shadow_silhouette_grads(scene, CounterKey(3), cot, w, h, cfg, 8)), 5)
    print(f"cast-shadow recovery on engine mega: |x - 2| from 0.3 by 5 steps {trail} (kajo_tpu's test reaches "
          f"< 0.12 on engine jax); {shadow_ms:.3f} ms per step (CUDA events) on {card}, the boundary terms "
          f"{term_ms:.3f} ms of it ({100 * term_ms / shadow_ms:.1f}%)")
    if not trail[-1] < 0.3:
        fail("the cast-shadow recovery's error did not fall below its start")
    report_profile(f"the boundary terms of a cast-shadow step {w}x{h}", card,
                   profile_device(lambda: (edges.silhouette_loss_grads(scene, CounterKey(2), cot, w, h, cfg, 64),
                                           edges.shadow_silhouette_grads(scene, CounterKey(3), cot, w, h, cfg, 8))))

    # 18d. phase 12's configuration with and without the boundary term (a report: no bar): 10 steps on
    # three seeds of the steps' renders, and the full 100 steps with the term beside phase 12's run
    def fit(steps: int, seed: int, edged: bool) -> dict:
        name = f"inverse_mega_s{seed}_n{steps}_edges{int(edged)}"
        rc = inverse_rendering.main(["--engine", "mega", "-w", str(INV_W), "-h", str(INV_H), "--spp", str(INV_SPP),
                                     "--depth", str(INV_D), "--steps", str(steps), "--seed", str(seed),
                                     "--print-every", str(steps), "--out-prefix", str(OUT / name),
                                     "--summary", str(OUT / f"{name}.json")] + (["--edge-gradients"] if edged else []))
        if rc != 0:
            fail(f"phase 12's configuration, {steps} steps, seed {seed}, edge_gradients={edged}")
        rec = json.loads((OUT / f"{name}.json").read_text())
        print(f"phase 12's configuration, {steps} steps, seed {seed}, edge_gradients={edged}: losses "
              + " ".join(f"{x:.6f}" for x in (rec["losses"] if steps <= 10 else rec["losses"][::10] + rec["losses"][-1:]))
              + f"; sphere offset {rec['offset'][0]:.4f} -> {rec['offset'][1]:.4f}; "
              f"{rec['ms_per_step']:.3f} ms per step")
        return rec

    runs = {(seed, edged): fit(10, seed, edged) for seed in (7, 11, 13) for edged in (False, True)}
    phase12 = json.loads((OUT / "inverse_mega.json").read_text())
    print("phase 12's first 10 losses (100-step schedule): " + " ".join(f"{x:.6f}" for x in phase12["losses"][:10]))
    full = fit(INV_STEPS, 7, True)
    print(f"{INV_STEPS} steps, seed 7: loss at the end {phase12['losses'][-1]:.6f} without the term (phase 12), "
          f"{full['losses'][-1]:.6f} with it; sphere offset {phase12['offset'][1]:.4f} / {full['offset'][1]:.4f}")
    with_ms, without_ms = runs[7, True]["ms_per_step"], runs[7, False]["ms_per_step"]
    print(f"edge term's share of a step at {INV_W}x{INV_H} {INV_SPP}spp depth {INV_D} on {card}: "
          f"{with_ms - without_ms:.3f} of {with_ms:.3f} ms ({100 * (with_ms - without_ms) / with_ms:.1f}%)")


# phase 19's steps at phase 12's configuration, the entry point's run (19e)
# and its repeat (19f), and of the cast-shadow recovery (19g). Cut from the
# 20, 5 and 25 steps first asked for (and 19i's 10-step runs on two more
# seeds dropped): an engine jax step takes 7-13 s on the card (host-bound),
# and the whole script must end within 1200 s
JAX_STEPS, SHADOW_STEPS = 3, 8
YARD_W, YARD_H, YARD_SPP, YARD_SEEDS = 16, 12, 4, 6  # phase 19h: tests/test_megakernel_grad.py's size


def jax_fit(name: str, steps: int, seed: int) -> dict:
    """``inverse_rendering.main --engine jax`` at phase 12's configuration ->
    its summary."""
    from kajo_tpu_torch import inverse_rendering

    OUT.mkdir(parents=True, exist_ok=True)
    rc = inverse_rendering.main(["--engine", "jax", "-w", str(INV_W), "-h", str(INV_H), "--spp", str(INV_SPP),
                                 "--depth", str(INV_D), "--steps", str(steps), "--seed", str(seed),
                                 "--print-every", str(max(steps // 4, 1)), "--out-prefix", str(OUT / name),
                                 "--summary", str(OUT / f"{name}.json")])
    if rc != 0:
        fail(f"engine jax at phase 12's configuration, {steps} steps, seed {seed}: rc {rc}")
    return json.loads((OUT / f"{name}.json").read_text())


def budget_phases(dev, card: str, scenes: dict) -> None:
    """Phase 19: engine jax, the differentiable budget engine (plain PyTorch
    on the card, tracing through the dense trace, or K5/K6 and the nearest
    hit's VJP), which runs no kernel of its own."""
    from kajo_tpu_torch.diff.inverse import InverseRenderer, apply_params, extract_params, render_loss
    from kajo_tpu_torch.models import wavefront
    from kajo_tpu_torch.models.integrator import RenderConfig, render_image
    from kajo_tpu_torch.ops import geometry, megakernel, megakernel_geom, megakernel_grad
    from kajo_tpu_torch.ops import stream_trace as st
    from kajo_tpu_torch.scene import parser
    from kajo_tpu_torch.scene.procedural import random_spheres_scene
    from kajo_tpu_torch.scene.testscene import build_shadow_scene, build_test_scene

    cpu = torch.device("cpu")
    t0 = time.time()
    # 19a. the budget pass against the fast pass: one lane a pixel, the same body and seed
    w, h, spp, cfg = INV_W, INV_H, INV_SPP, RenderConfig(max_depth=INV_D)
    scene, passes = build_test_scene(w / h, dev), {}
    ms_fast = timed(lambda: passes.update(fast=wavefront.render_pass_fast(scene, 19, w, h, spp, cfg)), 1)
    ms_budget = timed(lambda: passes.update(budget=wavefront.render_pass_budget(scene, 19, w, h, spp, cfg)), 1)
    fast, budget = passes["fast"].reshape(-1, 4), passes["budget"].reshape(-1, 4)
    grid = int(spp**0.5)
    _, completed = wavefront.render_lanes_budget(geometry.prepare_scene(scene), torch.arange(w * h, device=dev),
                                                 torch.tensor(19, device=dev), w, h, grid * grid, grid, cfg,
                                                 wavefront.BUDGET_ITERS_PER_SAMPLE * grid * grid)
    done = completed == grid * grid
    same = bool(torch.equal(budget[done], fast[done]))
    print(f"budget pass vs fast pass build_test_scene {w}x{h} {spp}spp depth {INV_D}: equal bit for bit on the "
          f"{int(done.sum())} pixels whose lane completed its samples: {same}; lanes that did not: "
          f"{int((~done).sum())} of {w * h} ({100 * float((~done).float().mean()):.4f}%)")
    if not same or not bool(done.any()):
        fail("the budget pass differs from the fast pass on a completed pixel")
    print(f"timing budget pass build_test_scene {w}x{h} {spp}spp depth {INV_D} on {card}: {ms_budget:.1f} ms "
          f"({4 * spp} iterations, no gradient), fast pass {ms_fast:.1f} ms")

    # 19b. one budget loss's gradients, card against CPU, the same seeds
    spec = ("sphere_transform", "sphere_radius", "diffuse")
    target = torch.from_numpy(np.random.default_rng(19).uniform(0.0, 1.0, (48, 64, 4)).astype(np.float32))

    def loss_grads(d):
        s = build_test_scene(64 / 48, d)
        leaves = {k: v.requires_grad_(True) for k, v in extract_params(s, spec).items()}
        loss = render_loss(leaves, s, target.to(d), 1, 2, 64, 48, 4, RenderConfig(max_depth=3), loss_clip=1.0)
        return loss.detach(), torch.autograd.grad(loss, list(leaves.values()))

    (loss_card, g_card), (loss_cpu, g_cpu) = loss_grads(dev), loss_grads(cpu)
    print(f"budget loss build_test_scene 64x48 4spp depth 3: card {loss_card.item():.8g}, CPU {loss_cpu.item():.8g}")
    hold_grads("budget loss gradient 64x48 4spp depth 3 card vs CPU", g_card, g_cpu, spec)

    # 19c. every radius's gradient through K5 and the nearest hit's VJP against the dense trace's
    field = random_spheres_scene(2000, seed=21, extent=15.0, n_lights=2, aspect_ratio=32 / 24, device=dev)

    def radius_grad():
        r = field.sphere_radius.clone().requires_grad_(True)
        img = wavefront.render_pass_budget(apply_params(field, {"sphere_radius": r}), 11, 32, 24, 4,
                                           RenderConfig(max_depth=2))
        return torch.autograd.grad(img[..., :3].mean(), [r])[0]

    st.nearest_launches = st.occluded_launches = 0
    g_stream = radius_grad()
    torch.cuda.synchronize()
    k5, k6 = st.nearest_launches, st.occluded_launches
    before, geometry.STREAM_THRESHOLD = geometry.STREAM_THRESHOLD, 10**9
    try:
        g_dense = radius_grad()
    finally:
        geometry.STREAM_THRESHOLD = before
    big = g_dense.abs() > 1e-3 * g_dense.abs().max()
    worst = float(((g_stream[big] - g_dense[big]).abs() / g_dense[big].abs()).max())
    cos = float((g_stream * g_dense).sum() / (g_stream.norm() * g_dense.norm()).clamp_min(1e-30))
    ok = (bool(torch.isfinite(g_stream).all()) and float(g_dense.abs().max()) > 0 and worst <= 0.1 and k5 > 0)
    print(f"radius gradient random_spheres_scene(2000) 32x24 4spp depth 2, streamed (K5 {k5}, K6 {k6} launches) "
          f"vs dense: {int(big.sum())} entries above 1e-3 of the largest, largest relative gap {worst:.3e} "
          f"(<= 0.1), cosine {cos:.7f} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("the streamed radius gradient against the dense one")

    # 19d. config 5: one budget-loss gradient with respect to the radii through K5/K6
    scene5, cfg5 = scenes["rigid"], RenderConfig(max_depth=BIG_D, one_light_nee=True)
    target5 = wavefront.render_pass_fast(scene5, 1, BIG_W, BIG_H, BIG_SPP, cfg5)

    def grad5():
        r = scene5.sphere_radius.clone().requires_grad_(True)
        loss = render_loss({"sphere_radius": r}, scene5, target5, 2, 3, BIG_W, BIG_H, BIG_SPP, cfg5)
        return torch.autograd.grad(loss, [r])[0]

    st.nearest_launches = st.occluded_launches = 0
    ms5 = timed(lambda: passes.update(g5=grad5()), 1)
    g5, k5, k6 = passes["g5"], st.nearest_launches, st.occluded_launches
    iters = 4 * BIG_SPP
    finite, nonzero = bool(torch.isfinite(g5).all()), int(torch.count_nonzero(g5))
    print(f"budget-loss radius gradient config 5 rigid {BIG_W}x{BIG_H} {BIG_SPP}spp depth {BIG_D}: K5 launches {k5} "
          f"(2 renders x {iters} iterations, each run again in the backward: {4 * iters}), K6 launches {k6}; "
          f"finite {finite}, {nonzero} of {g5.numel()} radii with a gradient, largest {g5.abs().max().item():.4g}; "
          f"{ms5:.1f} ms (CUDA events) on {card}")
    if k5 == 0 or k6 == 0 or not finite or nonzero == 0:
        fail("the config-5 budget gradient")
    print(f"phase 19a-d: {time.time() - t0:.1f} s")

    # 19e. the entry point on engine jax, launches counted from 0
    t0 = time.time()
    megakernel.kernel_launches = megakernel.jvp_launches = 0
    megakernel_grad.kernel_launches = megakernel_geom.kernel_launches = st.nearest_launches = 0
    rec = jax_fit("inverse_jax", JAX_STEPS, 7)
    counts = dict(K1=megakernel.kernel_launches, K2=megakernel.jvp_launches, K3=megakernel_grad.kernel_launches,
                  K4=megakernel_geom.kernel_launches, K5=st.nearest_launches)
    losses = np.asarray(rec["losses"])
    print(f"gradient path, engine jax: {JAX_STEPS} steps in {time.time() - t0:.1f} s; launches {counts}; "
          f"{rec['ms_per_step']:.3f} ms per step (CUDA events) on {card}; loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
          f"sphere offset {rec['offset'][0]:.4f} -> {rec['offset'][1]:.4f}; "
          f"ground albedo error {rec['albedo_error'][0]:.4f} -> {rec['albedo_error'][1]:.4f}")
    if counts != dict(K1=3, K2=0, K3=0, K4=0, K5=0):
        fail(f"engine jax: launches {counts}, want K1 3 (the target and two PNGs) and no other")
    if not np.isfinite(losses).all() or not rec["offset"][1] < rec["offset"][0]:
        fail("engine jax: a loss is not finite or the sphere's offset did not shrink")
    # a step's trace holds ~370k device events, whose processing takes minutes: profile a budget pass
    report_profile(f"a budget pass without a gradient {w}x{h} {spp}spp depth {INV_D}", card,
                   profile_device(lambda: wavefront.render_pass_budget(scene, 19, w, h, spp, cfg)))

    # 19f. the same steps again: the same losses and tensors, to the bit
    t0 = time.time()
    again = jax_fit("inverse_jax_again", JAX_STEPS, 7)
    same = rec["losses"] == again["losses"] and rec["tensors"] == again["tensors"]
    print(f"engine jax, {JAX_STEPS} steps twice: the same losses and tensors to the bit {same} "
          f"({' '.join(f'{x:.9g}' for x in rec['losses'])}); {time.time() - t0:.1f} s")
    if not same:
        fail("engine jax's steps did not repeat bit for bit")

    # 19g. recover an out-of-frame occluder from its cast shadow, on engine jax
    t0 = time.time()
    cfg1, ew, eh = RenderConfig(max_depth=1), EDGE_W, EDGE_H
    target = render_image(build_shadow_scene(2.0, dev), ew, eh, 16, 7, passes=2, config=cfg1)
    inv = InverseRenderer(build_shadow_scene(2.3, dev), target, ew, eh, spp=16, config=cfg1,
                          param_spec=("sphere_transform",), shadow_edges=True, n_shadow_edge=8, n_edge=64,
                          learning_rate=3e-2, engine="jax", seed=9)
    trail = []
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    for i in range(SHADOW_STEPS):
        inv.step()
        if (i + 1) % 2 == 0:
            trail.append(abs(float(inv.params["sphere_transform"].detach()[0, 0, 3]) - 2.0))
    ev1.record()
    torch.cuda.synchronize()
    print(f"cast-shadow recovery on engine jax: |x - 2| from 0.3 by 2 steps {trail} (bar < 0.12, kajo_tpu's test's "
          f"after 25 steps); {ev0.elapsed_time(ev1) / SHADOW_STEPS:.3f} ms per step (CUDA events) on {card}; "
          f"{time.time() - t0:.1f} s")
    if not trail[-1] < 0.12:
        fail("the cast-shadow recovery on engine jax")

    # 19h. K3's diffuse gradient against engine jax's, independent seeds (statistical)
    t0 = time.time()
    yw, yh, cfg3 = YARD_W, YARD_H, RenderConfig(max_depth=3)
    scaled = parser.load(str(ROOT / "data" / "scaled.json"), yw / yh, dev)
    cot = torch.full((yh, yw, 3), 1.0 / (yh * yw * 3), device=dev)
    megakernel_grad.kernel_launches = 0
    # the JAX test's streams: seed_from_key(PRNGKey(n)) is the u32 seed 2 n
    kern = torch.stack([megakernel_grad.material_grads(scaled, 2 * (100 + i), cot, yw, yh, YARD_SPP, cfg3)["diffuse"]
                        for i in range(YARD_SEEDS)]).mean(0)
    k3 = megakernel_grad.kernel_launches

    def budget_diffuse(seed):
        diffuse = scaled.materials.diffuse.clone().requires_grad_(True)
        img = wavefront.render_pass_budget(apply_params(scaled, {"diffuse": diffuse}), seed, yw, yh, YARD_SPP, cfg3)
        return torch.autograd.grad(img[..., :3].mean(), [diffuse])[0][:, :3]

    ref = torch.stack([budget_diffuse(2 * (200 + i)) for i in range(YARD_SEEDS)]).mean(0)
    scale = float(ref.abs().max())
    worst = float((kern - ref).abs().max())
    ok = scale > 0 and worst <= 0.25 * scale and k3 == YARD_SEEDS
    print(f"K3 ({k3} launches) vs engine jax, diffuse gradient scaled.json {yw}x{yh} {YARD_SPP}spp depth 3, "
          f"{YARD_SEEDS} seeds each: largest gap {worst:.4g} (<= 0.25 x {scale:.4g}) {'ok' if ok else 'FAILED'}; "
          f"{time.time() - t0:.1f} s")
    if not ok:
        fail("K3's diffuse gradient against engine jax's")

    # 19i. the drift of phase 12's configuration on engine jax (19e's run, seed 7) beside phase 18d's mega runs
    n = len(rec["losses"])
    mega = {seed: [json.loads((OUT / f"inverse_mega_s{seed}_n10_edges{e}.json").read_text())["losses"]
                   for e in (0, 1)] for seed in (7, 11, 13)}
    print(f"phase 12's configuration, seed 7: engine jax losses " + " ".join(f"{x:.6f}" for x in rec["losses"])
          + f"; sphere offset {rec['offset'][0]:.4f} -> {rec['offset'][1]:.4f} after {n} steps; engine mega "
          f"(10-step runs) without / with the edge term at step {n}, seeds 7, 11, 13: "
          + ", ".join(f"{m[0][n - 1]:.6f} / {m[1][n - 1]:.6f}" for m in mega.values())
          + "; at step 10: " + ", ".join(f"{m[0][-1]:.6f} / {m[1][-1]:.6f}" for m in mega.values()))


DIST_SEED = 5  # the pass seed of phase 20's renders
DIST_HELD = 3  # K5 calls of an object-sharded pass held against the plain K5 per rank


def shard_checks(mesh, card: str, refs: dict | None = None) -> dict:
    """Phases 20a/20b on one rank of ``mesh``: K1 sharded at the main path's
    shape (caustics 512x384, 16 spp; one K1 launch a rank), the wavefront
    sharded at build_test_scene 128x96, 16 spp, depth 4 (bits), and the
    object-sharded wavefront on config 5 (the rank's K5 on its shard, the
    MAD bar against the one-lane-a-pixel wavefront). ``refs`` None (world
    size 1): the unsharded passes are rendered here and returned; else the
    images are held against them -> the images (on the CPU) and counts."""
    from kajo_tpu_torch.models import wavefront
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.ops import megakernel
    from kajo_tpu_torch.ops import stream_trace as st
    from kajo_tpu_torch.parallel import objshard, render
    from kajo_tpu_torch.scene import parser
    from kajo_tpu_torch.scene.procedural import random_spheres_scene
    from kajo_tpu_torch.scene.testscene import build_test_scene

    dev, tag = mesh.device, f"rank {mesh.rank} of {mesh.size} ({'gloo' if refs else 'NCCL'})"
    out, counts = {}, {}
    cfg = RenderConfig()
    caustics = parser.load(str(ROOT / "data" / "caustics.json"), MAIN_W / MAIN_H, dev)
    megakernel.kernel_launches = 0
    out["mega"] = render.render_pass_megakernel_sharded(caustics, DIST_SEED, MAIN_W, MAIN_H, MAIN_SPP, cfg, mesh)
    torch.cuda.synchronize()
    counts["k1"] = megakernel.kernel_launches
    ms = timed(lambda: render.render_pass_megakernel_sharded(caustics, DIST_SEED, MAIN_W, MAIN_H, MAIN_SPP, cfg,
                                                             mesh), 5)
    want = refs["mega"].to(dev) if refs else megakernel.render_pass_megakernel(caustics, DIST_SEED, MAIN_W, MAIN_H,
                                                                               MAIN_SPP, cfg)
    same = torch.equal(out["mega"], want)
    lo, hi, _ = render.lane_block(MAIN_W * MAIN_H, mesh)
    print(f"20 {tag}: K1 sharded caustics {MAIN_W}x{MAIN_H} {MAIN_SPP}spp, lanes [{lo}, {hi}): K1 launches "
          f"{counts['k1']}, {ms:.3f} ms a pass (CUDA events, gather included) on {card}; equals the unsharded K1 "
          f"pass bit for bit: {same}")
    if counts["k1"] != 1 or not same:
        fail(f"20 {tag}: the K1-sharded pass")
    # K1 at the rank's lane block: against its plain version, timed, bounded
    n = MAIN_W * MAIN_H
    ps = megakernel.prepare_pass(caustics, MAIN_W, MAIN_H, MAIN_SPP, cfg, min(lo, n), min(hi, n))
    stats = {}
    plain_ms = timed(lambda: stats.update(sums=megakernel.trace_lanes_plain(ps, DIST_SEED, stats)), 1)
    kern = megakernel.launch_kernel(ps, DIST_SEED)
    k_ms = timed(lambda: megakernel.launch_kernel(ps, DIST_SEED), 20)
    bits = torch.equal(kern.view(torch.int32), stats.pop("sums").view(torch.int32))
    (b_ms, by), _, _, _ = k1_bound(ps, stats)
    counts.update(k1_ms=k_ms, k1_plain_ms=plain_ms, k1_bound_ms=b_ms, k1_bound_by=by, k1_lanes=ps.n_lanes)
    print(f"20 {tag}: K1 on its block of {ps.n_lanes} lanes: {k_ms:.4f} ms a launch (CUDA events), plain "
          f"{plain_ms:.1f} ms, bound {b_ms:.5f} ms ({by}), {k_ms / b_ms:.0f}x; sums equal the plain version's bit "
          f"for bit: {bits}")
    if not bits:
        fail(f"20 {tag}: K1 on a lane block against its plain version")

    scene = build_test_scene(INV_W / INV_H, dev)
    fcfg = RenderConfig(max_depth=INV_D)
    out["fast"] = render.render_pass_fast_sharded(scene, DIST_SEED, INV_W, INV_H, INV_SPP, fcfg, mesh)
    ms = timed(lambda: render.render_pass_fast_sharded(scene, DIST_SEED, INV_W, INV_H, INV_SPP, fcfg, mesh), 1)
    want = refs["fast"].to(dev) if refs else wavefront.render_pass_fast(scene, DIST_SEED, INV_W, INV_H, INV_SPP, fcfg)
    same = torch.equal(out["fast"], want)
    print(f"20 {tag}: wavefront sharded build_test_scene {INV_W}x{INV_H} {INV_SPP}spp depth {INV_D}: "
          f"{ms:.1f} ms a pass on {card}; equals render_pass_fast bit for bit: {same}")
    if not same:
        fail(f"20 {tag}: the lane-sharded wavefront")

    big = random_spheres_scene(BIG_N, seed=0, extent=60.0, aspect_ratio=BIG_W / BIG_H, device=dev)
    bcfg = RenderConfig(max_depth=BIG_D, one_light_nee=True)
    objshard.render_pass_fast_objsharded(big, DIST_SEED, BIG_W, BIG_H, BIG_SPP, bcfg, mesh)  # warm-up
    st.nearest_launches = st.occluded_launches = 0
    calls = []
    ms = timed(lambda: calls.extend(record_stream_calls(lambda: out.update(
        obj=objshard.render_pass_fast_objsharded(big, DIST_SEED, BIG_W, BIG_H, BIG_SPP, bcfg, mesh)))[1]), 1)
    counts["k5"], counts["k6"], counts["obj_ms"] = st.nearest_launches, st.occluded_launches, ms
    # K5 on the rank's shard: its first DIST_HELD calls (the primary rays'
    # nearest hit and shadow rays, then the first bounce) held, timed, bounded
    rows = []
    for i, (kind, args) in enumerate(calls[:DIST_HELD]):
        t_k, t_p, idx, ok = kernel_vs_plain(kind, args)
        k_ms = timed(lambda a=args: st.launch_nearest(*a), 20)
        p_ms = timed(lambda a=args: st.nearest_sphere_plain(*a), 1)
        b_ms, by = bound(*call_bound(kind, args, t_k))
        rows.append((k_ms, p_ms, b_ms, by))
        print(f"20 {tag}: K5 call {i} on the shard ({args[1].shape[0]} rays, {args[4].shape[0]} packed rows, "
              f"{int((idx >= 0).sum())} hits): kernel == plain on every ray (bits) {ok}; {k_ms:.4f} ms (CUDA "
              f"events), plain {p_ms:.1f} ms, bound {b_ms:.6f} ms ({by}), {k_ms / b_ms:.0f}x")
        if kind != "nearest" or not ok:
            fail(f"20 {tag}: K5 on the shard against its plain version (call {i}, {kind})")
    counts.update(k5_ms=sum(r[0] for r in rows) / len(rows), k5_plain_ms=sum(r[1] for r in rows) / len(rows),
                  k5_bound_ms=sum(r[2] for r in rows) / len(rows), k5_bound_by=rows[0][3])
    if refs:
        want = refs["fast1"].to(dev)
    else:
        want = out["fast1"] = render.render_pass_fast_sharded(big, DIST_SEED, BIG_W, BIG_H, BIG_SPP, bcfg, mesh)
    differ = int((out["obj"] != want).any(-1).sum())
    print(f"20 {tag}: object-sharded config 5 ({BIG_N} spheres, {-(-BIG_N // mesh.size)} a rank): K5 launches {counts['k5']}, "
          f"K6 {counts['k6']}, {ms:.1f} ms a pass on {card}; {differ} of {BIG_W * BIG_H} pixels differ from the "
          f"wavefront with one lane a pixel (K5 on the whole scene, K6 for shadows)")
    compare(f"20 {tag}: object-sharded vs the one-lane-a-pixel wavefront, config 5", out["obj"], want)
    if counts["k5"] == 0:
        fail(f"20 {tag}: the object-sharded pass launched no K5")
    if not refs:
        lanes4 = wavefront.render_pass_fast(big, DIST_SEED, BIG_W, BIG_H, BIG_SPP, bcfg)
        mad = (tm(out["obj"]) - tm(lanes4)).abs().mean().item()
        print(f"20 {tag}: against render_pass_fast (LANE_MULT lanes a pixel, other streams; a report): "
              f"tone-mapped MAD {mad:.3e}")
    return {k: v.cpu() for k, v in out.items()}, counts


def dist_rows(c: dict) -> str:
    """Phase 20's K1-at-a-block and K5-at-a-shard numbers of one rank."""
    return (f"K1 on {c['k1_lanes']} lanes {c['k1_ms']:.4f} ms a launch (plain {c['k1_plain_ms']:.1f}, bound "
            f"{c['k1_bound_ms']:.5f} {c['k1_bound_by']}); K5 on the shard {c['k5_ms']:.4f} ms a call over the first "
            f"{DIST_HELD} (plain {c['k5_plain_ms']:.1f}, bound {c['k5_bound_ms']:.6f} {c['k5_bound_by']})")


def _two_rank_worker(rank: int, world: int, store: str, refs_path: str, out_path: str) -> None:
    """Phase 20b's process: one rank of a gloo group whose ranks share the
    card (NCCL refuses that), collectives on CUDA tensors."""
    import torch.distributed as dist

    from kajo_tpu_torch.parallel import render

    sys.stdout.reconfigure(line_buffering=True)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        mesh = render.make_mesh(device="cuda")
        _, counts = shard_checks(mesh, nvidia_smi(), torch.load(refs_path))
        Path(out_path).write_text(json.dumps(counts))
    finally:
        dist.destroy_process_group()


def distribution_phases(dev, card: str) -> None:
    """Phase 20: distribution (kajo_tpu_torch/parallel/), no kernel of its
    own: K1, K5 and K6 behind torch.distributed."""
    import multiprocessing

    import torch.distributed as dist

    from kajo_tpu_torch import cli
    from kajo_tpu_torch.diff import inverse
    from kajo_tpu_torch.inverse_rendering import GROUND, GROUND_ALBEDO, SHIFT, SPHERE
    from kajo_tpu_torch.models.integrator import RenderConfig, render_pass
    from kajo_tpu_torch.ops import megakernel
    from kajo_tpu_torch.ops import stream_trace as st
    from kajo_tpu_torch.ops.rng import pass_seed
    from kajo_tpu_torch.parallel import render
    from kajo_tpu_torch.scene.testscene import build_test_scene

    OUT.mkdir(parents=True, exist_ok=True)
    # 20a. world size 1 over NCCL
    t0 = time.time()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        refs, counts = shard_checks(render.make_mesh(device=dev), card)
    finally:
        dist.destroy_process_group()
    print(f"phase 20a: {time.time() - t0:.1f} s")

    # 20b. two processes on the one card over gloo, CUDA tensors
    t0 = time.time()
    refs_path, store = OUT / "dist_refs.pt", OUT / "dist_store"
    store.unlink(missing_ok=True)
    torch.save(refs, refs_path)
    ctx = multiprocessing.get_context("spawn")
    outs = [OUT / f"dist_rank{r}.json" for r in range(2)]
    for p in outs:
        p.unlink(missing_ok=True)
    procs = [ctx.Process(target=_two_rank_worker, args=(r, 2, str(store), str(refs_path), str(outs[r])))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if any(p.exitcode != 0 for p in procs) or not all(p.exists() for p in outs):
        fail(f"20b: the two-process run on one card (exit codes {[p.exitcode for p in procs]})")
    for r, p in enumerate(outs):
        c = json.loads(p.read_text())
        print(f"20b rank {r} of 2 (gloo, one card): K1 launches {c['k1']}, K5 launches {c['k5']} (K6 {c['k6']}) "
              f"and {c['obj_ms']:.1f} ms a config-5 object-sharded pass on {card}; {dist_rows(c)}")
    print(f"20a world 1 (NCCL): K5 launches {counts['k5']} (K6 {counts['k6']}) and {counts['obj_ms']:.1f} ms a "
          f"config-5 object-sharded pass on {card}; {dist_rows(counts)}")
    print(f"phase 20b: {time.time() - t0:.1f} s")

    # 20c. the CLI's --shard and --shard-objects, as a group of one
    t0 = time.time()
    caustics = str(ROOT / "data" / "caustics.json")
    runs = (
        ("--shard", ["-w", str(MAIN_W), "-h", str(MAIN_H), "--spp", str(MAIN_SPP), "--passes", "4", caustics],
         (MAIN_H, MAIN_W)),
        ("--shard-objects", ["--procedural", str(BIG_N), "-w", str(BIG_W), "-h", str(BIG_H), "--spp", str(BIG_SPP),
                             "--depth", str(BIG_D), "--passes", "2"], (BIG_H, BIG_W)),
    )
    for flag, args, shape in runs:
        png = OUT / f"cli{flag}.png"
        megakernel.kernel_launches = st.nearest_launches = st.occluded_launches = 0
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main([flag, *args, "-o", str(png)])
        launches = dict(k1=megakernel.kernel_launches, k5=st.nearest_launches, k6=st.occluded_launches)
        rates = re.findall(r"([0-9.]+[KMG]?) samples/s", err.getvalue())
        engine = [ln for ln in err.getvalue().splitlines() if ln.startswith("engine")]
        pixels = load_png(str(png)).astype(np.float64) if png.exists() else np.zeros(0)
        print(f"20c cli {flag}: rc={rc}, {engine}, launches {launches}, samples/s per pass {rates} on {card}; png "
              f"shape {pixels.shape}, mean {pixels[..., :3].mean() if pixels.size else float('nan'):.2f}")
        ran = launches["k1"] == 4 if flag == "--shard" else launches["k5"] > 0
        if rc != 0 or not ran or pixels.shape[:2] != shape or not np.isfinite(pixels).all() \
                or not pixels[..., :3].mean() > 0:
            fail(f"20c: the CLI with {flag}")
    print(f"phase 20c: {time.time() - t0:.1f} s")

    # 20d. multihost under torchrun
    t0 = time.time()
    png = OUT / "multihost.png"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "kajo_tpu_torch.parallel.multihost", caustics, "--out", str(png)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    pixels = load_png(str(png)).astype(np.float64) if png.exists() else np.zeros(0)
    print(f"20d torchrun --nproc_per_node 1 -m kajo_tpu_torch.parallel.multihost: rc={proc.returncode}, "
          f"{proc.stdout.strip().splitlines()[-1:] } on {card}, png shape {pixels.shape} ({time.time() - t0:.1f} s)")
    if proc.returncode != 0 or "samples/s" not in proc.stdout or pixels.shape[:2] != (480, 640) \
            or not np.isfinite(pixels).all() or not pixels[..., :3].mean() > 0:
        print(proc.stderr[-3000:])
        fail("20d: multihost under torchrun")

    # 20e. InverseRenderer(mesh=...): three steps, gradients bit-equal to the
    # unsharded parity loss's
    t0 = time.time()
    w, h, spp, cfg = 64, 48, 4, RenderConfig(max_depth=INV_D)
    truth = build_test_scene(w / h, dev)
    target = megakernel.render_pass_megakernel(truth, 123, w, h, 64, cfg)
    st_wrong = truth.sphere_transform.clone()
    for r, c, delta in SHIFT:
        st_wrong[SPHERE, r, c] += delta
    diffuse = truth.materials.diffuse.clone()
    diffuse[GROUND, :3] = torch.tensor(GROUND_ALBEDO, device=dev)
    wrong = inverse.apply_params(truth, {"sphere_transform": st_wrong, "diffuse": diffuse})
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        inv = inverse.InverseRenderer(wrong, target, w, h, spp=spp, config=cfg, learning_rate=2e-2, loss_clip=1.0,
                                      mesh=render.make_mesh(device=dev), param_spec=("sphere_transform", "diffuse"),
                                      seed=7)
        megakernel.kernel_launches = 0
        for i in range(3):
            s1, s2 = pass_seed(7, 2 * i), pass_seed(7, 2 * i + 1)
            loss, grads = inv.loss_and_grad(inv.params, s1, s2)
            leaves = {k: v.detach().requires_grad_(True) for k, v in inv.params.items()}
            want = inverse.render_loss(leaves, wrong, inv.target, s1, s2, w, h, spp, cfg, loss_clip=1.0,
                                       render=lambda s, seed: render_pass(s, seed, w, h, spp, cfg))
            want_g = torch.autograd.grad(want, list(leaves.values()))
            same = torch.equal(loss, want.detach()) and all(torch.equal(grads[k], g) for k, g in zip(leaves, want_g))
            step_ms = timed(inv.step, 1)
            print(f"20e step {i}: loss {float(loss):.6f}, gradients and loss equal the unsharded parity loss's "
                  f"bit for bit: {same}; {step_ms:.1f} ms a step (CUDA events) on {card}")
            if not same or not torch.isfinite(loss):
                fail("20e: InverseRenderer(mesh=...)'s gradients against the unsharded parity loss's")
        print(f"20e: engine {inv.engine}, K1 launches in the steps {megakernel.kernel_launches} (the parity engine "
              f"runs no kernel; the target is K1's)")
        if inv.engine != "jax":
            fail("20e: InverseRenderer(mesh=...) took another engine than jax")
    finally:
        dist.destroy_process_group()
    print(f"phase 20e: {time.time() - t0:.1f} s")


# K1, K5 and K6 by their entry names in a profiler trace (csrc/megakernel.cu,
# csrc/stream_trace.cu): K1 launches one of its two entries a pass
TRACE_KERNELS = {"K1": re.compile(r"\bmegakernel_(lanes|items)\b"), "K5": re.compile(r"\bnearest_kernel\b"),
                 "K6": re.compile(r"\boccluded_kernel\b")}


def _busy_us(intervals, lo: float = float("-inf"), hi: float = float("inf")) -> float:
    """The length of the union of the (start, end) intervals, clipped to
    [lo, hi]."""
    busy, end = 0.0, lo
    for s, t in sorted(intervals):
        s, t = max(s, end), min(t, hi)
        if t > s:
            busy += t - s
            end = t
    return busy


def read_trace(path: Path, k1_per_batch: int = 0) -> dict:
    """A Chrome trace of the CLI's --profile -> launches per kernel of
    TRACE_KERNELS, device ms per kernel name, the device busy ms (the union
    of the intervals of every kernel and copy on the card) and the window
    ms (the span of every event in the trace). With k1_per_batch, also the
    (window ms, busy ms) of each batch of that many K1 launches: from the
    end of the previous batch's last copy to the host (the trace's first
    event for the first batch) to the end of its own."""
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    per_name = {}
    for e in device:
        per_name[e["name"]] = per_name.get(e["name"], 0.0) + e["dur"] / 1e3
    launches = {k: sum(1 for e in device if e["cat"] == "kernel" and pat.search(e["name"]))
                for k, pat in TRACE_KERNELS.items()}
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    first = min(e["ts"] for e in events)
    window_us = max(e["ts"] + e["dur"] for e in events) - first
    batches = []
    if k1_per_batch:
        k1 = sorted(e["ts"] for e in device if e["cat"] == "kernel" and TRACE_KERNELS["K1"].search(e["name"]))
        to_host = sorted(e["ts"] + e["dur"] for e in device if e["cat"] == "gpu_memcpy" and "DtoH" in e["name"])
        nexts = k1[k1_per_batch::k1_per_batch] + [float("inf")]
        lo = first
        for nxt in nexts:
            hi = max((t for t in to_host if lo < t < nxt), default=None)
            if hi is None:
                break
            batches.append(((hi - lo) / 1e3, _busy_us(intervals, lo, hi) / 1e3))
            lo = hi
    return dict(launches=launches, per_name=per_name, busy_ms=_busy_us(intervals) / 1e3,
                window_ms=window_us / 1e3, batches=batches)


def median_ms(fn, reps: int = 5) -> float:
    """The median host ms of reps calls of fn() (host work, no device)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


PROFILE_PASSES, PROFILE_BATCH = 8, 4  # two of the CLI's batches: the first with its warm-up, then steady state


def profile_phases(dev, card: str) -> None:
    """Phase 21: the CLI's --profile through K1, K5 and K6, and the host's
    PNG save after the loop."""
    from kajo_tpu_torch import cli
    from kajo_tpu_torch.ops import megakernel
    from kajo_tpu_torch.ops import stream_trace as st
    from kajo_tpu_torch.scene import parser
    from kajo_tpu_torch.utils import image

    OUT.mkdir(parents=True, exist_ok=True)
    caustics = str(ROOT / "data" / "caustics.json")

    # 21a. the CLI main path under --profile: K1 by name in the trace, and
    # the busy share of each batch
    prof_dir, png = OUT / "profile_main", OUT / "profile_main.png"
    megakernel.kernel_launches = 0
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["-w", str(MAIN_W), "-h", str(MAIN_H), "--spp", str(MAIN_SPP), "--passes", str(PROFILE_PASSES),
                       "--batch", str(PROFILE_BATCH), caustics, "-o", str(png), "--profile", str(prof_dir)])
    cli_s = time.perf_counter() - t0
    sys.stderr.write(err.getvalue())
    trace_path = prof_dir / "trace.json"
    if rc != 0 or not trace_path.exists():
        fail(f"21a: the profiled main path (rc={rc}) wrote no {trace_path.relative_to(ROOT)}")
    tr = read_trace(trace_path, PROFILE_BATCH)
    pixels = load_png(str(png)).astype(np.float64) if png.exists() else np.zeros(0)
    top = sorted(tr["per_name"].items(), key=lambda kv: -kv[1])[:4]
    print(f"21a cli --profile (caustics {MAIN_W}x{MAIN_H}, {MAIN_SPP} spp, {PROFILE_PASSES} passes in batches of "
          f"{PROFILE_BATCH}) on {card}: rc={rc} in {cli_s:.2f} s, K1 launches {megakernel.kernel_launches} "
          f"(counter), {tr['launches']['K1']} (trace, by name); trace {trace_path.stat().st_size} B, window "
          f"{tr['window_ms']:.3f} ms, device busy {tr['busy_ms']:.3f} ms "
          f"({100 * tr['busy_ms'] / tr['window_ms']:.1f}%); device ms by name "
          f"{[(name[:40], round(ms, 3)) for name, ms in top]}")
    batch_samples = PROFILE_BATCH * MAIN_W * MAIN_H * MAIN_SPP
    for i, (window, busy) in enumerate(tr["batches"]):
        print(f"21a batch {i + 1} ({'first, with its warm-up' if i == 0 else 'steady state'}) on {card}: window "
              f"{window:.3f} ms, device busy {busy:.3f} ms ({100 * busy / window:.1f}%, host share "
              f"{100 - 100 * busy / window:.1f}%), {batch_samples / window / 1e6:.3f} G samples/s")
    print(f"21a png {png.relative_to(ROOT)}: shape {pixels.shape}, mean "
          f"{pixels[..., :3].mean() if pixels.size else float('nan'):.2f}")
    if megakernel.kernel_launches != PROFILE_PASSES or tr["launches"]["K1"] != PROFILE_PASSES \
            or f"profile trace in {prof_dir}" not in err.getvalue():
        fail(f"21a: the profiled main path's trace does not hold {PROFILE_PASSES} K1 launches")
    if len(tr["batches"]) != PROFILE_PASSES // PROFILE_BATCH:
        fail(f"21a: {len(tr['batches'])} batches found in the trace, not {PROFILE_PASSES // PROFILE_BATCH}")
    if pixels.shape != (MAIN_H, MAIN_W, 4) or not np.isfinite(pixels).all() or not pixels[..., :3].mean() > 0:
        fail("21a: the profiled main path's PNG")

    # 21b. the big scene under --profile: K5 and K6 by name in the trace
    prof_dir, png = OUT / "profile_big", OUT / "profile_big.png"
    st.nearest_launches = st.occluded_launches = 0
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["--procedural", str(BIG_N), "-w", str(BIG_W), "-h", str(BIG_H), "--spp", str(BIG_SPP),
                       "--depth", str(BIG_D), "--passes", "2", "-o", str(png), "--profile", str(prof_dir)])
    cli_s = time.perf_counter() - t0
    trace_path = prof_dir / "trace.json"
    if rc != 0 or not trace_path.exists():
        sys.stderr.write(err.getvalue())
        fail(f"21b: the profiled big scene (rc={rc}) wrote no {trace_path.relative_to(ROOT)}")
    tr = read_trace(trace_path)
    counted = dict(K5=st.nearest_launches, K6=st.occluded_launches)
    print(f"21b cli --procedural {BIG_N} --profile ({BIG_W}x{BIG_H}, {BIG_SPP} spp, depth {BIG_D}, 2 passes) on "
          f"{card}: rc={rc} in {cli_s:.2f} s (scene build included), launches {counted} (counters), "
          f"{ {k: tr['launches'][k] for k in counted} } (trace, by name); window {tr['window_ms']:.3f} ms, "
          f"device busy {tr['busy_ms']:.3f} ms ({100 * tr['busy_ms'] / tr['window_ms']:.1f}%)")
    if not all(counted[k] > 0 and tr["launches"][k] == counted[k] for k in counted):
        sys.stderr.write(err.getvalue())
        fail("21b: the big scene's trace does not hold K5 and K6 as launched")

    # 21c. the PNG the CLI saves after its loop, at the main path's size
    # (median of 5 each): the whole save, its tone map, its encoder
    scene = parser.load(caustics, MAIN_W / MAIN_H, dev)
    hdr = (megakernel.render_passes_megakernel(scene, 5, 0, MAIN_W, MAIN_H, MAIN_SPP, 4) / 4).cpu().numpy()
    out = OUT / "save.png"
    rgba8 = image.tonemap(hdr)
    t_save = median_ms(lambda: image.save_png(str(out), hdr))
    t_tonemap = median_ms(lambda: image.tonemap(hdr))
    t_encode = median_ms(lambda: image.encode_png(rgba8))
    back = load_png(str(out))
    print(f"21c save_png at {MAIN_W}x{MAIN_H} on {card}'s host: {t_save:.3f} ms (tone map {t_tonemap:.3f} ms, "
          f"encoder {t_encode:.3f} ms; medians of 5); read back equal: {np.array_equal(back, rgba8)}")
    if not np.array_equal(back, rgba8):
        fail("21c: the saved PNG does not read back as its tone map")


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)
    if not torch.cuda.is_available():
        print("error: chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from kajo_tpu_torch.ops import _nvcc

    dev = torch.device("cuda")
    card = nvidia_smi()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 2. build every kernel, one nvcc per source, all started together
    sources = ("megakernel.cu", "stream_trace.cu", "megakernel_jvp.cu", "megakernel_grad.cu", "megakernel_geom.cu",
               "stream_trace_v1.cu", "stream_trace_v2.cu", "stream_trace_v3.cu")
    t0 = time.time()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_nvcc.load_library, sources))
    print(f"built {len(sources)} kernels in {time.time() - t0:.1f} s")
    for source in sources:
        print("built", _nvcc.library_path(source).relative_to(ROOT))
        for line in _nvcc.library_path(source).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("ptxas:", line.strip())

    faulthandler.dump_traceback_later(STALL_S, exit=True)
    t0 = time.time()
    k1 = megakernel_phases(dev, card)
    print(f"phases 3-6: {time.time() - t0:.1f} s")
    faulthandler.dump_traceback_later(STALL_S, exit=True)  # restart the clock for the big scene
    t0 = time.time()
    stream_rows, scenes = big_scene_phases(dev, card)
    kernels = [k1, *stream_rows]
    print(f"phases 7-10: {time.time() - t0:.1f} s")
    faulthandler.dump_traceback_later(STALL_S, exit=True)
    t0 = time.time()
    kernels += gradient_phases(dev, card)
    print(f"phases 11-13: {time.time() - t0:.1f} s")
    faulthandler.dump_traceback_later(STALL_S, exit=True)
    kernels += design_phases(dev, card, scenes)
    faulthandler.dump_traceback_later(STALL_S, exit=True)
    t0 = time.time()
    parity_phases(dev, card, scenes)
    print(f"phase 17: {time.time() - t0:.1f} s")
    faulthandler.dump_traceback_later(STALL_S, exit=True)
    t0 = time.time()
    edge_phases(dev, card)
    print(f"phase 18: {time.time() - t0:.1f} s")
    faulthandler.dump_traceback_later(STALL_S, exit=True)
    t0 = time.time()
    budget_phases(dev, card, scenes)
    print(f"phase 19: {time.time() - t0:.1f} s")
    faulthandler.dump_traceback_later(STALL_S, exit=True)
    t0 = time.time()
    distribution_phases(dev, card)
    print(f"phase 20: {time.time() - t0:.1f} s")
    faulthandler.dump_traceback_later(STALL_S, exit=True)
    t0 = time.time()
    profile_phases(dev, card)
    print(f"phase 21: {time.time() - t0:.1f} s")
    faulthandler.cancel_dump_traceback_later()

    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "kajo_tpu"))
    if bad:
        fail(f"modules of jax or kajo_tpu were imported: {bad[:10]}")
    record = {"kernels": kernels}
    print(json.dumps(record))
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
