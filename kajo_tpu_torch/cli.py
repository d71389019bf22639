"""Command-line renderer, port of ``kajo_tpu/cli.py``.

    python -m kajo_tpu_torch.cli [-w W] [-h H] [--spp N] [--passes N] [SCENE.json]
    python -m kajo_tpu_torch.cli --procedural 100000 -w 128 -h 96 --spp 4 --depth 2

Renders on ``--device`` (default ``cuda``) with engine ``--engine`` (default
``auto``: the fused megakernel of ``ops/megakernel.py`` for scenes of up to
512 objects, else the regenerating wavefront of ``models/wavefront.py``,
which traces scenes above 1024 spheres through the streaming kernels of
``ops/stream_trace.py``; ``-r cpu`` or ``--engine parity``: the fixed-depth
scan of ``models/integrator.py``, the reference CPU backend's estimator, one
pass per batch). On a GPU the CUDA kernels run; with ``--device cpu`` their
plain PyTorch versions. ``--device cuda`` on a machine without a
GPU exits non-zero; it never renders on the CPU instead. No scene file
renders the built-in test scene; ``--procedural N`` the N-sphere field of
``scene/procedural.py``. Per batch of passes it prints elapsed time,
samples/pixel and samples/s; it saves the PNG at the end, optionally every N
passes, and can checkpoint and resume the progressive accumulation.

Pass p uses the u32 seed ``ops.rng.pass_seed(--seed, p)``, so a resumed or
batched render traces the same passes as an uninterrupted one.

``--shard`` splits each pass's lanes over the ranks of a process group
(``parallel/render.py``: K1, the wavefront or the parity engine on each
rank's lanes); ``--shard-objects`` splits the spheres (``parallel/objshard.py``,
the wavefront). Both run one pass a batch, under ``torchrun`` (one rank a
card on CUDA, PyTorch's default backends) or alone, as a group of one
process; rank 0 prints and saves. A caller whose ranks share a card
initialises a gloo group before calling :func:`main`, which then renders
in it. samples/s counts the samples rendered, whatever the world size; a
group of several ranks also prints the rate per rank, ``[N ranks x
R/rank]``.

``--profile DIR`` records the render loop, from the engine's choice to the
last pass, with ``torch.profiler`` (the CPU, and the CUDA kernels on a GPU,
under their kernel names) and writes it to DIR as a Chrome trace JSON,
``trace.json``, or ``trace.rank<R>.json`` on each rank of a sharded render.
Open it in Perfetto (ui.perfetto.dev) or chrome://tracing.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kajo-torch",
        description="path tracer on PyTorch + a CUDA megakernel",
        add_help=False,
    )
    p.add_argument("--help", action="help", help="show this help")
    p.add_argument("-w", dest="width", type=int, default=640, help="image width (640)")
    p.add_argument("-h", dest="height", type=int, default=480, help="image height (480)")
    p.add_argument(
        "-r",
        dest="renderer",
        default="torch",
        choices=["torch", "cpu", "gl"],
        help="renderer backend (torch; cpu selects the parity engine, the reference CPU "
        "backend's estimator; gl renders the GL backend's estimator through the wavefront)",
    )
    p.add_argument("scene", nargs="?", default=None, help="scene JSON (default: built-in test scene)")
    p.add_argument(
        "--procedural",
        type=int,
        default=0,
        metavar="N",
        help="render the N-sphere procedural field instead of a scene file (the big-scene config)",
    )
    p.add_argument(
        "--scale-jitter",
        type=float,
        default=0.0,
        help="with --procedural: per-sphere rotations and uniform scales in [1/(1+j), 1+j] "
        "(the non-rigid sphere record)",
    )
    p.add_argument("--device", default="cuda", help="torch device to render on (cuda)")
    p.add_argument(
        "--engine",
        default="auto",
        choices=["auto", "mega", "fast", "parity"],
        help="auto = mega where the megakernel takes the scene, else fast; mega = the fused "
        "megakernel; fast = the regenerating wavefront; parity = the fixed-depth scan (-r cpu)",
    )
    p.add_argument("--spp", type=int, default=32, help="samples/pixel/pass (32, kajo default)")
    p.add_argument(
        "--batch",
        type=int,
        default=0,
        help="passes summed on the device per host readback (0 = auto: 8 for streamed "
        "scenes on the fast engine, else 4; the parity engine always 1)",
    )
    p.add_argument("--passes", type=int, default=8, help="progressive passes (8; 0 = run until Ctrl-C)")
    p.add_argument("--depth", type=int, default=8, help="max path depth (8)")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--epsilon", type=float, default=1e-3, help="secondary-ray surface offset")
    p.add_argument("--full-mis", action="store_true", help="unbiased full balance-heuristic MIS")
    p.add_argument(
        "--regen-threshold",
        type=float,
        default=None,
        help="cull lanes when throughput max drops below this (the reference GL "
        "backend's biased occupancy trick; default 0 = exact)",
    )
    p.add_argument("--exact-spp", action="store_true", help="disable kajo's 25/32 spp quirk")
    p.add_argument(
        "--one-light-nee",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="sample ONE uniformly chosen light per vertex (x L) instead of every light; "
        "default on for --procedural >= 10000, off otherwise",
    )
    p.add_argument("--no-direct", action="store_true", help="disable NEE (pure BSDF path tracing)")
    p.add_argument("-o", "--out", default="out.png", help="output PNG (out.png)")
    p.add_argument("--save-every", type=int, default=0, help="also save PNG every N passes")
    p.add_argument("--checkpoint", default=None, help="progressive-state checkpoint file (.npz)")
    p.add_argument("--resume", action="store_true", help="resume from --checkpoint if present")
    p.add_argument("--preview", action="store_true", help="live ANSI preview in the terminal")
    p.add_argument("--shard", action="store_true", help="split each pass's lanes over the process group's ranks")
    p.add_argument(
        "--shard-objects",
        action="store_true",
        help="split the spheres over the process group's ranks instead of the lanes (each rank stores and "
        "traces its shard; nearest hits reduced over the group), for scenes too big for one device",
    )
    p.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="write a torch.profiler trace of the render loop (CPU, and CUDA kernels on a GPU) to DIR as a Chrome "
        "trace JSON (trace.json; trace.rank<R>.json per rank when sharded); with --passes 0 it keeps every "
        "event until Ctrl-C",
    )
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(
            f"error: --device {args.device} but PyTorch sees no CUDA device; "
            "pass --device cpu to render with the plain PyTorch version",
            file=sys.stderr,
        )
        return 2
    if args.shard and args.shard_objects:
        print("error: give --shard or --shard-objects, not both", file=sys.stderr)
        return 2
    mesh = None
    if args.shard or args.shard_objects:
        import torch.distributed as dist

        from .parallel.multihost import ensure_group
        from .parallel.render import make_mesh

        created = ensure_group()
        try:
            mesh = make_mesh(device=device)
            return _render(args, mesh.device, mesh)
        finally:
            if created:
                dist.destroy_process_group()
    return _render(args, device, mesh)


def _render(args, device, mesh) -> int:
    """The render of ``main``; ``mesh`` (a ``parallel.render.Mesh`` or None)
    shards each pass, one pass a batch, and only its rank 0 prints and
    saves."""
    from .models.engine import render_pass_engine, select_engine
    from .models.integrator import RenderConfig
    from .models.wavefront import render_passes_fast
    from .ops.geometry import STREAM_THRESHOLD
    from .ops.megakernel import render_passes_megakernel
    from .ops.rng import pass_seed
    from .scene import parser
    from .scene.procedural import random_spheres_scene
    from .scene.testscene import build_test_scene
    from .utils.format import format_si
    from .utils.image import save_png
    from .utils.keys import CTRL_S, ESC, key_poller

    lead = mesh is None or mesh.rank == 0

    if args.procedural > 0 and args.scene:
        print("error: give either a scene file or --procedural, not both", file=sys.stderr)
        return 2
    if args.procedural > 0:
        scene = random_spheres_scene(
            args.procedural,
            seed=args.seed,
            aspect_ratio=args.width / args.height,
            scale_jitter=args.scale_jitter,
            device=device,
        )
    elif args.scene:
        scene = parser.load(args.scene, args.width / args.height, device)
    else:
        # the reference hardcodes a 4:3 projection for its built-in scene
        scene = build_test_scene(4.0 / 3.0, device)

    regen = args.regen_threshold
    if regen is None:
        regen = 0.01 if args.renderer == "gl" else 0.0
    one_light = args.one_light_nee
    if one_light is None:
        # big-scene default: one shadow ray per vertex instead of one per light
        one_light = args.procedural >= 10_000
        if one_light:
            print("one-light NEE enabled for the big-scene config (--no-one-light-nee for all lights)",
                  file=sys.stderr)
    config = RenderConfig(
        max_depth=args.depth,
        surface_epsilon=args.epsilon,
        direct_lighting=not args.no_direct,
        full_mis=args.full_mis,
        kajo_spp_quirk=not args.exact_spp,
        regen_threshold=regen,
        one_light_nee=one_light,
        gl_semantics=args.renderer == "gl",
    )
    grid = max(int(args.spp**0.5), 1)
    eff_spp = grid * grid

    # fields a checkpoint must match to be blended into this run's
    # accumulation (a different scene/seed/config is a different render)
    ck_meta = dict(
        scene=(
            f"<procedural:{args.procedural}:{args.scale_jitter}>"
            if args.procedural > 0
            else str(args.scene or "<builtin>")
        ),
        width=args.width,
        height=args.height,
        spp=args.spp,
        seed=args.seed,
        config=repr(config),
    )
    total = np.zeros((args.height, args.width, 4), np.float32)
    start_pass = 0
    if args.resume and args.checkpoint:
        try:
            ck = np.load(args.checkpoint)
            mismatched = [k for k, v in ck_meta.items() if k in ck and str(ck[k]) != str(v)]
            if mismatched:
                print(
                    f"checkpoint {args.checkpoint} does not match this run "
                    f"({', '.join(f'{k}: {ck[k]} != {ck_meta[k]}' for k in mismatched)}); "
                    "starting fresh",
                    file=sys.stderr,
                )
            else:
                total = ck["total"]
                start_pass = int(ck["passes"])
                print(f"resumed from {args.checkpoint} at pass {start_pass}", file=sys.stderr)
        except FileNotFoundError:
            pass

    requested = args.engine
    if requested == "auto" and args.renderer == "cpu":
        requested = "parity"
    elif requested == "auto" and args.renderer == "gl":
        requested = "fast"  # the megakernel has no GL estimator
    if args.shard_objects:
        if requested not in ("auto", "fast"):
            print(f"error: --shard-objects renders with the wavefront (engine fast), not {requested}", file=sys.stderr)
            return 2
        requested = "fast"
    engine = select_engine(scene, requested)
    if lead:
        sharding = " (objects sharded)" if args.shard_objects else " (lanes sharded)" if args.shard else ""
        ranks = f" x {mesh.size} ranks" if mesh is not None else ""
        print(f"engine: {engine}{sharding} on {device}{ranks}", file=sys.stderr)
    profiler = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        # acc_events: one start-stop cycle, so no warning that a cycle's end clears the events
        profiler = profile(activities=activities, acc_events=True)
        profiler.start()
    n_passes = args.passes if args.passes > 0 else 1 << 30
    if engine == "parity" or mesh is not None:
        batch = 1  # one scan per pass, as the JAX CLI runs it
    elif args.batch > 0:
        batch = args.batch
    else:
        batch = 8 if engine == "fast" and scene.num_spheres > STREAM_THRESHOLD else 4
    t0 = time.time()
    done = start_pass
    first = True
    last_save_bucket = start_pass // args.save_every if args.save_every else 0

    # ranks of a sharded render must run the same passes: no keys past one rank
    poller = key_poller() if mesh is None or mesh.size == 1 else contextlib.nullcontext(lambda: ())
    try:
        with poller as poll_keys:
            p = start_pass
            while p < start_pass + n_passes:
                t_pass = time.time()
                nb = min(batch, start_pass + n_passes - p)
                if args.shard_objects:
                    from .parallel.objshard import render_pass_fast_objsharded

                    pass_img = render_pass_fast_objsharded(
                        scene, pass_seed(args.seed, p), args.width, args.height, args.spp, config, mesh
                    )
                elif args.shard:
                    from .parallel.render import render_pass_sharded_engine

                    pass_img = render_pass_sharded_engine(
                        engine, scene, pass_seed(args.seed, p), args.width, args.height, args.spp, config, mesh
                    )
                elif nb > 1:
                    render_passes = render_passes_megakernel if engine == "mega" else render_passes_fast
                    pass_img = render_passes(scene, args.seed, p, args.width, args.height, args.spp, nb, config)
                else:
                    pass_img = render_pass_engine(
                        engine, scene, pass_seed(args.seed, p), args.width, args.height, args.spp, config
                    )
                total += pass_img.cpu().numpy()
                done = p + nb
                p = done
                if not lead:
                    continue
                pass_samples = nb * args.width * args.height * eff_spp
                now = time.time()
                rate = pass_samples / max(now - t_pass, 1e-9)
                per_rank = (
                    f" [{mesh.size} ranks x {format_si(rate / mesh.size)}/rank]"
                    if mesh is not None and mesh.size > 1
                    else ""
                )
                print(
                    f"pass {done}: {args.width}x{args.height}, {now - t0:.1f}s, "
                    f"{done * eff_spp} samples/pixel, {format_si(rate)} samples/s"
                    + per_rank
                    + (" (incl. warm-up)" if first else ""),
                    file=sys.stderr,
                )
                first = False
                if args.preview:
                    from .utils.preview import show

                    show(
                        total / done,
                        f"pass {done}  {args.width}x{args.height}  {now - t0:.1f}s  "
                        f"{done * eff_spp} spp  {format_si(rate)} samples/s",
                    )
                # bucket-based periodic save: a batch advances several passes
                if args.save_every and done // args.save_every > last_save_bucket:
                    last_save_bucket = done // args.save_every
                    save_png(args.out, total / done)
                if args.checkpoint:
                    np.savez(args.checkpoint, total=total, passes=done, **ck_meta)
                # interactive keys: s / Ctrl-S saves, ESC ends the render
                pressed = poll_keys()
                if any(c in ("s", "S", CTRL_S) for c in pressed):
                    save_png(args.out, total / done)
                    print(f"saved {args.out} (keypress)", file=sys.stderr)
                if ESC in pressed:
                    print("ESC: stopping", file=sys.stderr)
                    break
    except KeyboardInterrupt:
        print("interrupted, saving", file=sys.stderr)
    finally:
        if profiler is not None:
            profiler.stop()

    if profiler is not None:
        os.makedirs(args.profile, exist_ok=True)
        name = "trace.json" if mesh is None else f"trace.rank{mesh.rank}.json"
        profiler.export_chrome_trace(os.path.join(args.profile, name))
        if lead:
            print(f"profile trace in {args.profile}", file=sys.stderr)
    if done > 0 and lead:
        save_png(args.out, total / done)
        print(f"saved {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
