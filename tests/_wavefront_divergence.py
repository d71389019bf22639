"""Where the port's wavefront and kajo_tpu's part ways, iteration by
iteration.

    python tests/_wavefront_divergence.py [--threshold 64|1000] [--config nee|one-light|gl] [--share-camera]

The scene of ``tests/test_torch_wavefront_stream.py``:
``random_spheres_scene(400, seed=21, extent=15, n_lights=3)``, 32 x 24,
4 spp, depth 2, key 7. ``--threshold 64`` streams it in both packages (the
plain K5/K6 in the port, the V4 kernels in Pallas interpret mode in
kajo_tpu); ``--threshold 1000`` takes the dense trace in both, the control.

Both packages build the same lane layout and initial state. Each iteration
then runs two ways:

* free-running: each package advances its own state; the report counts the
  lanes whose discrete state (sample, depth, previous object, flags) differs
  and the largest relative gap of the float state where it does not;
* replayed: the port's body runs on kajo_tpu's state of that iteration, so
  any lane whose discrete result differs diverged inside this one
  iteration. For the first such lane, every operation of the two bodies
  (trace, light_visible, the samplers, BSDFs and lights, the PCG4D
  uniforms) is recorded in call order, and the first operation whose result
  at that lane differs in a discrete output (a hit object, a visibility, a
  coin) is named, with the float gap of every earlier operation.

kajo_tpu's body runs op by op here (not jitted), so XLA fuses no
multiply-add into an FMA; the test runs the jitted pass, which may.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from jax.experimental.pallas import tpu as pltpu  # noqa: E402
from torch_port import to_port  # noqa: E402

import kajo_tpu.models.wavefront as jwf  # noqa: E402
from kajo_tpu.models.integrator import RenderConfig as JaxRenderConfig  # noqa: E402
from kajo_tpu.ops import bsdf as jbsdf  # noqa: E402
from kajo_tpu.ops import geometry as jgeo  # noqa: E402
from kajo_tpu.ops import lights as jlights  # noqa: E402
from kajo_tpu.ops import sampling as jsampling  # noqa: E402
from kajo_tpu.ops.rng import seed_from_key  # noqa: E402
from kajo_tpu.scene.procedural import random_spheres_scene as jax_random_spheres_scene  # noqa: E402
from kajo_tpu_torch.models import wavefront as twf  # noqa: E402
from kajo_tpu_torch.models.integrator import RenderConfig  # noqa: E402
from kajo_tpu_torch.ops import bsdf as tbsdf  # noqa: E402
from kajo_tpu_torch.ops import geometry as tgeo  # noqa: E402
from kajo_tpu_torch.ops import lights as tlights  # noqa: E402
from kajo_tpu_torch.ops import sampling as tsampling  # noqa: E402

W, H, SPP, DEPTH, KEY = 32, 24, 4, 2, 7
CONFIGS = {"nee": {}, "one-light": {"one_light_nee": True}, "gl": {"gl_semantics": True, "regen_threshold": 0.01}}
DISCRETE = ("sample", "depth", "prev_obj", "emit", "mis_pending", "pend_delta")
FLOATS = ("o", "d", "throughput", "radiance", "r_cur", "pend_pdf_b", "pend_fcos", "prev_pos")
# operations recorded in both bodies: (module of kajo_tpu, module of the port, names)
RECORDED = (
    (jsampling, tsampling, ("flip_coin",)),
    (jbsdf, tbsdf, ("lambert_sample", "phong_sample", "reflector_sample", "transmission_sample", "lambert_pdf",
                    "phong_pdf", "lambert_eval_cos", "phong_eval_cos", "reflector_eval_cos",
                    "transmission_eval_abscos")),
    (jlights, tlights, ("sample", "pdf")),
)
HIT_FIELDS = ("t", "obj", "position", "normal", "tangent", "binormal")
# a float result further apart than this (relative) counts as a divergence
FLOAT_TOL = 1e-3
# more iterations than any pass of this scene takes
MAX_ITERS = 64


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _outputs(out):
    """A recorded result -> [(field name, numpy array)]."""
    if hasattr(out, "obj") and hasattr(out, "normal"):
        return [(f, _np(getattr(out, f))) for f in HIT_FIELDS]
    if isinstance(out, (tuple, list)):
        return [(str(i), _np(v)) for i, v in enumerate(out)]
    return [("", _np(out))]


@contextlib.contextmanager
def recording(log, patches):
    """Wrap each (owner, name) of ``patches`` so its calls append (name,
    outputs) to ``log``; the owners are restored on exit."""
    saved = []
    for owner, name, label in patches:
        fn = getattr(owner, name)

        def wrapper(*args, _fn=fn, _label=label, **kw):
            out = _fn(*args, **kw)
            log.append((_label, _outputs(out)))
            return out

        saved.append((owner, name, fn))
        setattr(owner, name, wrapper)
    try:
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def _patches(side):
    """(owner, attribute, label) of every recorded operation of one package."""
    wf, geo = (jwf, jgeo) if side == "jax" else (twf, tgeo)
    out = [(wf, "uniforms4", "uniforms4"), (wf, "generate_rays", "generate_rays"),
           (wf, "light_visible", "light_visible"), (geo, "trace", "trace")]
    if side == "torch":
        out.append((wf, "trace", "trace"))
    for jmod, tmod, names in RECORDED:
        mod = jmod if side == "jax" else tmod
        out += [(mod, n, f"{mod.__name__.rsplit('.', 1)[1]}.{n}") for n in names]
    return out


def _lane_rows(arr, lane, n):
    """The rows of ``arr`` that belong to ``lane``: [n, ...] or [n * k, ...]
    (k values per lane, lane-major)."""
    if arr.ndim == 0 or arr.shape[0] % n:
        return None
    k = arr.shape[0] // n
    return arr[lane * k : (lane + 1) * k]


def _gap(a, b):
    """(discrete mismatch, largest gap relative to the largest component) of
    two arrays of one lane; a float array with inf or nan in different
    places is a discrete mismatch."""
    if a.dtype.kind in "biu" or b.dtype.kind in "biu":
        return bool((a.astype(np.int64) != b.astype(np.int64)).any()), 0.0
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    if (np.isfinite(a64) != np.isfinite(b64)).any():
        return True, 0.0
    fin = np.isfinite(b64)
    if not fin.any():
        return False, 0.0
    return False, float(np.abs(a64[fin] - b64[fin]).max() / max(np.abs(b64[fin]).max(), 1e-30))


def name_divergence(jlog, tlog, lane, n):
    """Walk the two bodies' recorded operations in call order at ``lane`` ->
    (lines of the walk, the first operation whose result differs there: in
    a discrete output, else by more than FLOAT_TOL; None if none does)."""
    lines, first_discrete, first_float = [], None, None
    if [name for name, _ in jlog] != [name for name, _ in tlog]:
        lines.append(f"    the bodies called different operations: {len(jlog)} vs {len(tlog)} calls")
    for i, ((name, jout), (_, tout)) in enumerate(zip(jlog, tlog)):
        parts, bad, worst = [], False, 0.0
        for (field, ja), (_, ta) in zip(jout, tout):
            jr, tr = _lane_rows(ja, lane, n), _lane_rows(ta, lane, n)
            if jr is None or tr is None or jr.shape != tr.shape:
                continue
            mismatch, gap = _gap(tr, jr)
            if mismatch:
                bad = True
                parts.append(f"{field or 'out'} {jr.ravel()[:6].tolist()} vs port {tr.ravel()[:6].tolist()}")
            elif gap > 0:
                worst = max(worst, gap)
                parts.append(f"{field or 'out'} rel {gap:.2e}")
        if parts:
            lines.append(f"    call {i:3d} {name}: " + "; ".join(parts) + ("  <-- discrete" if bad else ""))
        if bad and first_discrete is None:
            first_discrete = name
        if worst > FLOAT_TOL and first_float is None:
            first_float = name
    return lines, first_discrete or first_float


def to_torch_state(jstate):
    out = {}
    for k, v in jstate.items():
        a = np.asarray(v)
        if k == "iters":
            out[k] = int(a)
        elif a.dtype.kind in "iu":
            out[k] = torch.from_numpy(a.astype(np.int64))
        else:
            out[k] = torch.from_numpy(a.copy())
    return out


def diverged_lanes(jstate, tstate):
    """Lanes whose discrete state differs or whose float state differs by
    more than FLOAT_TOL (relative to the lane's largest component of the
    field) -> (bool [n], the largest float gap on the other lanes, its
    field)."""
    differ = np.zeros(np.asarray(jstate["sample"]).shape[0], bool)
    for k in DISCRETE:
        differ |= np.asarray(jstate[k]).astype(np.int64) != _np(tstate[k]).astype(np.int64)
    gaps = {}
    for k in FLOATS:
        j, t = np.asarray(jstate[k]).astype(np.float64), _np(tstate[k]).astype(np.float64)
        j, t = j.reshape(j.shape[0], -1), t.reshape(t.shape[0], -1)
        gaps[k] = np.abs(j - t).max(1) / np.maximum(np.abs(j).max(1), 1e-6)
        differ |= gaps[k] > FLOAT_TOL
    worst = max(((float(g[~differ].max(initial=0.0)), k) for k, g in gaps.items()), default=(0.0, ""))
    return differ, worst


def run(threshold: int, config_name: str, share_camera: bool = False, verbose: bool = True) -> dict:
    """Step both wavefronts -> {"iters", "free": [lanes apart per
    iteration], "replay": [(iteration, diverged lanes, {first differing
    operation: lanes}, largest float gap of the others)], "radiance_gap"}."""
    config = CONFIGS[config_name]
    js = jax_random_spheres_scene(400, seed=21, extent=15.0, n_lights=3)
    old = (jgeo.STREAM_THRESHOLD, jgeo.FORCE_STREAM, tgeo.STREAM_THRESHOLD)
    jgeo.STREAM_THRESHOLD, jgeo.FORCE_STREAM, tgeo.STREAM_THRESHOLD = threshold, True, threshold
    try:
        return _run(js, config, config_name, threshold, verbose, share_camera)
    finally:
        jgeo.STREAM_THRESHOLD, jgeo.FORCE_STREAM, tgeo.STREAM_THRESHOLD = old


def _run(js, config, config_name, threshold, verbose, share_camera):
    say = print if verbose else (lambda *a, **k: None)
    key = jax.random.PRNGKey(KEY)
    seed = int(seed_from_key(key))
    jprep = jgeo.prepare_scene(js)
    tprep = tgeo.prepare_scene(to_port(js))
    if share_camera:
        c = jprep.camera
        basis = tgeo.CameraBasis(*(torch.from_numpy(np.array(x)) for x in (c.origin, c.p1, c.du, c.dv)))
        tprep = dataclasses.replace(tprep, camera=basis)
    streamed = tprep.stream_packed is not None
    assert streamed == (jprep.stream_packed is not None)
    grid = max(int(SPP**0.5), 1)
    eff = grid * grid
    lane, pix, s_lo, s_hi, _ = twf.lane_layout(tprep, W, H, eff)
    n = lane.shape[0]
    jcfg, tcfg = JaxRenderConfig(max_depth=DEPTH, **config), RenderConfig(max_depth=DEPTH, **config)
    jlane = jnp.asarray(lane.numpy().astype(np.uint32))
    jpix = jnp.asarray(pix.numpy().astype(np.uint32)) if streamed else None
    jlo = jnp.asarray(s_lo.numpy().astype(np.int32)) if streamed else None
    jhi = jnp.asarray(s_hi.numpy().astype(np.int32)) if streamed else None
    jstate, jcond, jbody = jwf._make_loop(jprep, jlane, seed_from_key(key), W, H, eff, grid, jcfg, jgeo.trace, jpix,
                                          sample_lo=jlo, sample_hi=jhi)
    tstate, tcond, tbody = twf._make_loop(tprep, lane, torch.tensor(seed, dtype=torch.int64), W, H, eff, grid, tcfg,
                                          pix, s_lo, s_hi)
    say(f"{'streamed' if streamed else 'dense'} (threshold {threshold}), {config_name}: {n} lanes")
    free = tstate
    report = {"iters": 0, "free": [], "replay": []}
    for it in range(MAX_ITERS):
        if not bool(jcond(jstate)):
            break
        differ, worst = diverged_lanes(jstate, free)
        report["free"].append(int(differ.sum()))
        say(f"iter {it}: free-running: {int(differ.sum())} lanes differ; the others within {worst[0]:.1e} "
            f"(largest in {worst[1] or '-'})")
        jlog, tlog = [], []
        # the JAX body's trace_fn is bound when the loop is built: build it
        # inside the recording, so trace_fn is the recorded geometry.trace
        # and light_visible keeps its any-hit path
        with pltpu.force_tpu_interpret_mode(), recording(jlog, _patches("jax")):
            _, _, jbody_rec = jwf._make_loop(jprep, jlane, seed_from_key(key), W, H, eff, grid, jcfg, jgeo.trace,
                                             jpix, sample_lo=jlo, sample_hi=jhi)
            del jlog[:]  # the initial camera rays of the rebuilt loop
            jnext = jbody_rec(jstate)
        with recording(tlog, _patches("torch")):
            tnext = tbody(to_torch_state(jstate))
        differ, worst = diverged_lanes(jnext, tnext)
        lanes = np.flatnonzero(differ)
        ops = collections.Counter(name_divergence(jlog, tlog, int(ln), n)[1] for ln in lanes)
        report["replay"].append((it, [int(x) for x in lanes], dict(ops), worst[0]))
        say(f"iter {it}: replayed on kajo_tpu's state: {lanes.size} lanes diverge in this iteration "
            f"(first operation that differs: {dict(ops) or '-'}); the others within {worst[0]:.1e} "
            f"(largest in {worst[1] or '-'})")
        if lanes.size:
            lines, op = name_divergence(jlog, tlog, int(lanes[0]), n)
            say(f"  lane {int(lanes[0])}, first at {op}:")
            for line in lines:
                say(line)
        jstate = jnext
        free = tbody(free)
        report["iters"] = it + 1
    rad_j, rad_t = np.asarray(jstate["radiance"], np.float64), _np(free["radiance"]).astype(np.float64)
    report["radiance_gap"] = float(np.abs(rad_j - rad_t).max() / max(np.abs(rad_j).max(), 1e-30))
    say(f"after {report['iters']} iterations: largest radiance gap {report['radiance_gap']:.2e} "
        f"(relative to the largest radiance)")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threshold", type=int, default=64)
    ap.add_argument("--config", choices=sorted(CONFIGS), default="nee")
    ap.add_argument("--share-camera", action="store_true",
                    help="give the port kajo_tpu's camera basis (its 4x4 inverse rounds differently)")
    ap.add_argument("--json", help="write the report here")
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    report = run(args.threshold, args.config, share_camera=args.share_camera)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
