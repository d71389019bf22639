"""The progressive render of a procedural sphere field: the job of
``progressive.py`` on a scene that the port's generator builds from the
run's seed, as the CLI's ``--procedural`` builds it, rendered through the
engine the port picks for it (engine ``fast``, the streamed wavefront with
K5/K6, above 1,024 spheres on the card).

Request ``i`` is batch ``i`` of ``batch_passes`` passes, read back and added
to the host's float32 sum, its latency read from the device's clock, as in
``progressive.py``. The job also reads the port's counters of the
wavefront's loop and of K5/K6 (:data:`COUNTERS`); it resolves them before
anything else in its set-up and stops at once, with an error, on a port
that lacks them.

After the window the plain reference (``benchmark/reference/field.py``)
builds the field again from the seed and renders, for each checked batch,
``check_tiles`` whole 64x64 screen tiles drawn from the seed and the
batch's index (every lane of their pixels); ``benchmark/check.py``'s
``gaps`` compare those pixels of the host's sums. With ``--trace 1`` it
also renders the first checked batch's first pass on a fixed sample of
the image (every 4th pixel column and row, all their lanes) and counts
each K5/K6 call's (ray, block) pairs (``extra["stream_pass"]``), from
which the roofline metrics count the kernels' work.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from benchmark.check import gaps
from benchmark.harness import HERE, ROOT, load_json, load_module, resolve

_progressive = load_module(HERE / "jobs" / "progressive.py")
WARMUP_FIRST_PASS = _progressive.WARMUP_FIRST_PASS
M64 = 0xFFFFFFFFFFFFFFFF
SAMPLE_STRIDE = 4  # the roofline's sample: every 4th pixel column and row

COUNTERS = {
    "iterations": "kajo_tpu_torch.models.wavefront:iterations",
    "flag_reads": "kajo_tpu_torch.models.wavefront:flag_reads",
    "prepare_seconds": "kajo_tpu_torch.models.wavefront:prepare_seconds",
    "k5_launches": "kajo_tpu_torch.ops.stream_trace:nearest_launches",
    "k6_launches": "kajo_tpu_torch.ops.stream_trace:occluded_launches",
}


def draw_tiles(seed: int, batch: int, n_tiles: int, count: int) -> list:
    """The screen tiles checked in batch ``batch`` of a run seeded with
    ``seed``: ``count`` of the image's ``n_tiles``, without repeats."""
    rng = np.random.default_rng([seed & M64, batch, 0x54494C45])  # "TILE"
    return sorted(int(t) for t in rng.choice(n_tiles, size=min(count, n_tiles), replace=False))


def sample_pixels(width: int, height: int) -> np.ndarray:
    """The roofline's fixed sample: every SAMPLE_STRIDE-th pixel column and
    row, in image order."""
    ys, xs = np.meshgrid(np.arange(0, height, SAMPLE_STRIDE), np.arange(0, width, SAMPLE_STRIDE), indexing="ij")
    return (ys * width + xs).ravel()


class Job(_progressive.Job):
    def __init__(self, cell):
        super().__init__(cell)
        self.field = load_json(self.scene_path)
        if self.field.get("kind") != "procedural" or float(self.field.get("scale_jitter", 0)):
            raise ValueError(f"the field job takes a procedural rigid field, not {self.field}")
        self.check_tiles = int(cell.traffic.get("check_tiles", 1))

    def field_args(self) -> tuple:
        """(spheres, scene seed, extent, lights, aspect) of the field, as the
        CLI's ``--procedural`` passes them to ``random_spheres_scene``."""
        f = self.field
        return int(f["n_spheres"]), self.seed & M64, float(f["extent"]), int(f["n_lights"]), self.width / self.height

    def setup(self):
        missing = []
        for name, target in COUNTERS.items():
            try:
                resolve(target)
            except (AttributeError, ImportError):
                missing.append(f"{name} ({target})")
        if missing:
            raise RuntimeError("this cell reads counters the port does not have: " + ", ".join(missing))

        import torch

        import kajo_tpu_torch
        from kajo_tpu_torch.models.engine import select_engine
        from kajo_tpu_torch.models.integrator import RenderConfig
        from kajo_tpu_torch.scene.procedural import random_spheres_scene

        if ROOT not in Path(kajo_tpu_torch.__file__).resolve().parents:
            raise RuntimeError(f"the port imported from {kajo_tpu_torch.__file__}, not from the checkout {ROOT}")
        self.torch = torch
        self.device = torch.device(self.cell.device)
        self.cuda = self.device.type == "cuda"
        self.device_name = torch.cuda.get_device_name(self.device) if self.cuda else "cpu"
        n, seed, extent, lights, aspect = self.field_args()
        self.scene = random_spheres_scene(n, seed=seed, extent=extent, n_lights=lights, aspect_ratio=aspect,
                                          device=self.device)
        self.engine = select_engine(self.scene, self.cell.engine or self.cell.workload["engine"])
        spec = load_json(HERE / "engines" / f"{self.engine}.json")
        entry = resolve(spec["entry"])
        self.entry = self.cell.wrap_entry(entry) if self.cell.wrap_entry else entry
        self.counter_names = {**spec.get("counters", {}), **COUNTERS}
        self.config = RenderConfig(**self.estimator)
        self.total = np.zeros((self.height, self.width, 4), np.float32)
        scratch = np.zeros_like(self.total)
        t0, i = None, 0
        while t0 is None or time.perf_counter() - t0 < float(self.cell.traffic["warmup_s"]):
            scratch += self._render(WARMUP_FIRST_PASS + i * self.batch).cpu().numpy()
            i += 1
            t0 = t0 or time.perf_counter()  # from the end of the first batch, which loads the kernels
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def reference_field(self, dtype=None):
        """The reference's prepared field on the run's device."""
        import torch

        from benchmark.reference import field

        n, seed, extent, lights, aspect = self.field_args()
        arrays = field.field_arrays(n, seed, extent, lights, aspect)
        return field.prepare(arrays, self.cell.device, dtype or torch.float32)

    def tiles_of(self, batch: int) -> list:
        from benchmark.reference import field

        return draw_tiles(self.seed, batch, field.n_tiles(self.width, self.height), self.check_tiles)

    def check(self) -> list:
        """The readings of each checked batch the window reached, on its
        checked tiles."""
        from benchmark.reference import field
        from benchmark.reference.rng import pass_seed

        self.checked = [k for k in self.checked if k in self.kept]
        fl = self.reference_field()
        est = field.Estimator(**self.estimator)
        w, h = self.width, self.height
        readings = []
        for k in self.checked:
            before, after = self.kept[k]
            px = field.tile_pixels(w, h, self.tiles_of(k))
            lanes = field.pixel_lanes(w, h, px)
            ref = field.render_batch(fl, self.seed, k * self.batch, self.batch, w, h, self.spp, est,
                                     lanes).cpu().numpy()
            start = np.zeros_like(ref) if k == 0 else before.reshape(-1, 4)[px]
            readings.append(gaps(after.reshape(-1, 4)[px], start, ref))
        if self.cell.trace and self.checked:
            px = sample_pixels(w, h)
            tally = []
            field.pass_pixels(fl, pass_seed(self.seed, self.checked[0] * self.batch), w, h, self.spp, est,
                              field.pixel_lanes(w, h, px), tally)
            self.extra["stream_pass"] = {"calls": tally, "scale": w * h / len(px), "passes": 1}
        return readings
