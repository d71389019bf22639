"""The progressive render: a viewer that asks for batches of passes, reads
each batch's image back to the host and adds it to its running sum, one
batch after another.

Request ``i`` is batch ``i``: passes ``i * B`` .. ``i * B + B - 1`` of the
render seeded with ``--seed`` (pass ``p`` has the port's seed
``pass_seed(seed, p)``), through the engine's batch entry
(``benchmark/engines/<engine>.json``; the engine is the port's
``select_engine`` of the workload's request), then ``.cpu()`` and a float32
``+=`` on the host, as the port's CLI runs its loop. Its latency is read
from the device's clock: a CUDA event recorded when the batch is submitted
and one recorded once its image is in the host's sum (the stream is idle
at both, so each stamps the moment the host reaches it).

The traffic file sets B (``batch_passes``), the warm-up (a batch, then
batches for ``warmup_s`` seconds, of passes far from the window's) and the
batches whose results are checked (``check_batches``: for each [lo, hi),
one batch drawn from the seed; [0, 1) is the window's first, whose sum
starts from zero). Before and after each checked batch the host's sum is
copied, outside its latency.

After the window the plain reference (``benchmark/reference/``) parses the
scene file itself and renders the checked batches' passes on the same
device; ``benchmark/check.py`` compares. With ``--trace 1`` the reference
also counts the first checked batch's rays, from which the roofline
metrics count K1's work (``extra["k1_pass"]``).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from benchmark.check import gaps
from benchmark.harness import HERE, ROOT, load_json, resolve

WARMUP_FIRST_PASS = 1 << 30  # warm-up passes lie far from the window's


class Job:
    def __init__(self, cell):
        self.cell = cell
        cfg = cell.config
        self.width, self.height, self.spp = int(cfg["width"]), int(cfg["height"]), int(cfg["spp"])
        self.eff = max(int(self.spp**0.5), 1) ** 2
        self.batch = int(cell.traffic["batch_passes"])
        self.seed = int(cell.seed)
        self.scene_path = HERE / cfg["scene"]
        self.estimator = {"max_depth": int(cfg["max_depth"]), **cfg["estimator"]}
        rng = np.random.default_rng([self.seed & 0xFFFFFFFFFFFFFFFF, 0x434845434B])  # "CHECK"
        self.checked = sorted({lo if hi - lo == 1 else int(rng.integers(lo, hi))
                               for lo, hi in cell.traffic["check_batches"]})
        self.kept = {}  # batch -> (host sum before, host sum after)
        self.events = []
        self.host_ms = []
        self.extra = {}

    def setup(self):
        import torch

        import kajo_tpu_torch
        from kajo_tpu_torch.models.engine import select_engine
        from kajo_tpu_torch.models.integrator import RenderConfig
        from kajo_tpu_torch.scene import parser

        if ROOT not in Path(kajo_tpu_torch.__file__).resolve().parents:
            raise RuntimeError(f"the port imported from {kajo_tpu_torch.__file__}, not from the checkout {ROOT}")
        self.torch = torch
        self.device = torch.device(self.cell.device)
        self.cuda = self.device.type == "cuda"
        self.device_name = torch.cuda.get_device_name(self.device) if self.cuda else "cpu"
        self.scene = parser.load(str(self.scene_path), self.width / self.height, self.device)
        self.engine = select_engine(self.scene, self.cell.engine or self.cell.workload["engine"])
        spec = load_json(HERE / "engines" / f"{self.engine}.json")
        entry = resolve(spec["entry"])
        self.entry = self.cell.wrap_entry(entry) if self.cell.wrap_entry else entry
        self.counter_names = spec.get("counters", {})
        self.config = RenderConfig(**self.estimator)
        self.total = np.zeros((self.height, self.width, 4), np.float32)
        scratch = np.zeros_like(self.total)
        t0, i = None, 0
        while t0 is None or time.perf_counter() - t0 < float(self.cell.traffic["warmup_s"]):
            scratch += self._render(WARMUP_FIRST_PASS + i * self.batch).cpu().numpy()
            i += 1
            t0 = t0 or time.perf_counter()  # from the end of the first batch, which loads the kernel
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _render(self, first_pass: int):
        return self.entry(self.scene, self.seed, first_pass, self.width, self.height, self.spp, self.batch,
                          self.config)

    def counters(self) -> dict:
        return {name: resolve(target) for name, target in self.counter_names.items()}

    def request(self, i: int, span):
        """Batch ``i`` -> (samples, passes)."""
        snap = i in self.checked
        before = self.total.copy() if snap else None
        if self.cuda:
            start = self.torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        with span("wrapper"):
            img = self._render(i * self.batch)
        with span("copy"):
            host = img.cpu().numpy()
        with span("host_sum"):
            self.total += host
        if self.cuda:
            end = self.torch.cuda.Event(enable_timing=True)
            end.record()
            self.events.append((start, end))
        else:
            self.host_ms.append((time.perf_counter() - t0) * 1e3)
        if snap:
            self.kept[i] = (before, self.total.copy())
        return self.batch * self.width * self.height * self.eff, self.batch

    def latencies_ms(self) -> list:
        if not self.cuda:
            return self.host_ms
        self.torch.cuda.synchronize(self.device)
        return [s.elapsed_time(e) for s, e in self.events]

    def release(self):
        self.scene = self.entry = self.events = None
        if self.cuda:
            self.torch.cuda.empty_cache()

    def check(self) -> list:
        """The readings of each checked batch the window reached."""
        from benchmark.reference import scene as ref_scene
        from benchmark.reference import walk

        self.checked = [k for k in self.checked if k in self.kept]
        rs = ref_scene.load_packed(self.scene_path, self.width / self.height, self.device)
        est = walk.Estimator(**self.estimator)
        readings = []
        for k in self.checked:
            before, after = self.kept[k]
            stats = {} if self.cell.trace and not readings else None
            ref = walk.batch_image(rs, self.seed, k * self.batch, self.batch, self.width, self.height, self.spp, est,
                                   stats=stats).cpu().numpy()
            readings.append(gaps(after, np.zeros_like(ref) if k == 0 else before, ref))
            if stats is not None:
                self.extra["k1_pass"] = {
                    "n_lanes": self.width * self.height,
                    "eff": self.eff,
                    "n_planes": rs.n_planes,
                    "n_spheres": rs.n_spheres,
                    "rigid": rs.rigid,
                    "packed_floats": int(rs.packed.numel()),
                    "stats": stats,
                    "passes": self.batch,
                }
        return readings

