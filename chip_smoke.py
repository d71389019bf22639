"""Smoke run of the PyTorch port's main path on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
the CUDA toolkit and PyTorch with CUDA. Phases, each of which ends the run
with a non-zero exit when it fails:

1. print the card (nvidia-smi name and power limit, torch's device name);
2. build the CUDA megakernel from kajo_tpu_torch/csrc/ (print ptxas' report);
3. hold the kernel against its plain PyTorch version on the card, same seed,
   at 64x48, 4 spp: caustics (rigid record), scaled.json (general record),
   the two-light scene with one-light NEE, and full MIS. Bars: tone-mapped
   MAD <= 5e-4 and mean relative gap <= 1%;
4. render the C++ golden's configuration with the kernel (caustics, 32x24,
   16 spp, 10 passes): tone-mapped MAD < 0.1, mean relative gap < 0.25;
5. drive the main path, the CLI's main() at 512x384, 16 spp, 4 passes on
   data/caustics.json, counting the kernel's launches from 0: one per pass,
   and a PNG that decodes to finite values with a positive mean;
6. time the kernel and the plain version at the main path's shape with CUDA
   events and compare their images there.

The last two lines are the kernels' JSON record and {"ok": true, "device":
...}. Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"
MAD_BAR, REL_BAR = 5e-4, 0.01


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


def read_png(path: Path) -> np.ndarray:
    """Decode an 8-bit RGBA PNG (any filter) without third-party packages."""
    data = path.read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path} is not a PNG")
    pos, idat, w = 8, b"", 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 6):
                fail(f"{path}: not 8-bit RGBA")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw, stride = zlib.decompress(idat), 4 * w
    rows, prev = [], [0] * stride
    for y in range(h):
        f = raw[y * (stride + 1)]
        line = raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)]
        if f == 0:
            out = list(line)
        elif f == 2:
            out = [(v + b) & 0xFF for v, b in zip(line, prev)]
        elif f in (1, 3, 4):
            out = [0] * stride
            for x in range(stride):
                a = out[x - 4] if x >= 4 else 0
                b = prev[x]
                c = prev[x - 4] if x >= 4 else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) // 2
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                out[x] = (line[x] + pred) & 0xFF
        else:
            fail(f"{path}: unknown PNG filter {f}")
        rows.append(out)
        prev = out
    return np.array(rows, np.uint8).reshape(h, w, 4)


def main() -> int:
    if not torch.cuda.is_available():
        print("error: chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from kajo_tpu_torch import cli
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.ops import _nvcc, megakernel
    from kajo_tpu_torch.scene import parser
    from kajo_tpu_torch.scene.testscene import build_two_light_scene

    dev = torch.device("cuda")
    caustics = str(ROOT / "data" / "caustics.json")
    card = nvidia_smi()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 2. build
    megakernel_lib = "megakernel.cu"
    _nvcc.load_library(megakernel_lib)
    log = _nvcc.library_path(megakernel_lib).with_suffix(".log")
    print("built", _nvcc.library_path(megakernel_lib).relative_to(ROOT))
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())

    # 3. kernel vs plain on the card
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
    launches = megakernel.kernel_launches
    print(f"main path: cli rc={rc}, kernel launches {launches} for {passes} passes")
    if rc != 0 or launches != passes:
        fail("the CLI's main path did not run one kernel launch per pass")
    pixels = read_png(png).astype(np.float64)
    print(f"png {png.relative_to(ROOT)}: shape {pixels.shape}, mean {pixels[..., :3].mean():.2f}")
    if pixels.shape != (384, 512, 4) or not np.isfinite(pixels).all() or not pixels[..., :3].mean() > 0:
        fail("the main path's PNG")

    # 6. timing and comparison at the main path's shape
    w, h, spp = 512, 384, 16
    ps = megakernel.prepare_pass(parser.load(caustics, w / h, dev), w, h, spp, RenderConfig())
    seed = 99
    plain = megakernel.trace_lanes_plain(ps, seed)  # warm-up
    kern = megakernel.launch_kernel(ps, seed)
    torch.cuda.synchronize()

    def timed(fn, reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn(ps, seed)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    plain_ms = timed(megakernel.trace_lanes_plain, 1)
    ms = timed(megakernel.launch_kernel, 20)
    ms2 = timed(megakernel.launch_kernel, 20)
    plain_ms2 = timed(megakernel.trace_lanes_plain, 1)
    samples = w * h * ps.eff
    print(f"timing caustics {w}x{h} {spp}spp on {card}: kernel {ms:.3f} / {ms2:.3f} ms per pass "
          f"({samples / (min(ms, ms2) / 1e3):.4g} samples/s), plain PyTorch {plain_ms:.1f} / {plain_ms2:.1f} ms "
          f"({samples / (min(plain_ms, plain_ms2) / 1e3):.4g} samples/s)")
    max_abs = compare(
        f"kernel vs plain caustics {w}x{h} {spp}spp",
        kern.T.reshape(h, w, 3) / ps.divisor,
        plain.T.reshape(h, w, 3) / ps.divisor,
    )

    if "jax" in sys.modules:
        fail("jax was imported")
    record = {
        "kernels": [
            {
                "name": "megakernel",
                "route": "cuda",
                "source": "kajo_tpu_torch/csrc/megakernel.cu",
                "replaces": "kajo_tpu/ops/pallas/megakernel.py:297",
                "launches": launches,
                "max_abs_err": max_abs,
                "ms": min(ms, ms2),
                "plain_ms": min(plain_ms, plain_ms2),
            }
        ]
    }
    print(json.dumps(record))
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
