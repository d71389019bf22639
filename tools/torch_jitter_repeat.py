"""Run the scale_jitter=0.5 part of chip_smoke.py's phase 7 several times on
one CUDA GPU, each run in a fresh process under a time limit.

    python3 tools/torch_jitter_repeat.py

Five runs; each builds random_spheres_scene(100_000, seed=0, extent=60,
scale_jitter=0.5) on the card, records every K5 call of one wavefront pass
(128x96, 4 spp, depth 2, one-light NEE) and holds each against its plain
version, bit for bit. A run that outlives RUN_LIMIT_S is reported as a stall,
with the Python stack of every thread at that moment (faulthandler), so the
report shows whether it waited on the card or on the host. The last line is
a JSON summary: per run, the exit code and the seconds it took.
"""

from __future__ import annotations

import faulthandler
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RUNS = 5
RUN_LIMIT_S = 180.0  # ~7x a run's time on an H100


def child() -> int:
    sys.path.insert(0, str(ROOT))
    sys.stdout.reconfigure(line_buffering=True)
    faulthandler.dump_traceback_later(RUN_LIMIT_S, exit=True)
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    chip_smoke.hold_stream_calls(torch.device("cuda"), 0.5)
    return 0


def main() -> int:
    if sys.argv[1:] == ["--child"]:
        return child()
    runs = []
    for i in range(RUNS):
        t0 = time.time()
        try:
            proc = subprocess.run([sys.executable, __file__, "--child"], capture_output=True, text=True,
                                  timeout=RUN_LIMIT_S + 60)
            rc, out = proc.returncode, proc.stdout + proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out = "killed", "".join(x.decode() if isinstance(x, bytes) else x for x in (e.stdout, e.stderr) if x)
        seconds = time.time() - t0
        runs.append({"run": i, "rc": rc, "s": round(seconds, 1)})
        print(f"run {i}: rc={rc} in {seconds:.1f} s")
        lines = out.splitlines()
        for line in lines if rc != 0 else lines[-3:]:
            print(f"  {line}")
    print(json.dumps({"jitter_runs": runs}))
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
