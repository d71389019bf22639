"""One process of the two-process render of ``tests/test_torch_multihost.py``.

    python tests/_torch_multihost_worker.py RANK WORLD STORE SCENE W H SPP OUT_DIR

Joins the group through ``kajo_tpu_torch.parallel.multihost.initialize``
with a ``file://`` address (no port), at one PyTorch thread; renders SCENE
through ``render_distributed`` (rank 0 saves the image to OUT_DIR/mh.npy,
the others check they got None), then runs the module's ``main`` on the
same group (rank 0 writes OUT_DIR/mh.png), and the CLI's ``--shard`` with
``--profile OUT_DIR/prof`` on it too (rank 0 writes OUT_DIR/cli.png; each
rank its trace).
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kajo_tpu_torch import cli  # noqa: E402
from kajo_tpu_torch.parallel import multihost  # noqa: E402
from kajo_tpu_torch.scene import parser  # noqa: E402


def main():
    rank, world, store, scene_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    w, h, spp, out_dir = int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]), sys.argv[8]
    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", world, rank)
    multihost.initialize()  # joined already: a no-op
    scene = parser.load(scene_path, w / h, "cpu")
    img = multihost.render_distributed(scene, w, h, spp, 0, passes=1)
    if rank == 0:
        np.save(os.path.join(out_dir, "mh.npy"), img)
    elif img is not None:
        raise SystemExit(f"rank {rank} got an image")
    multihost.main([scene_path, "--device", "cpu", "--width", str(w), "--height", str(h), "--spp", str(spp),
                    "--passes", "1", "--out", os.path.join(out_dir, "mh.png")])
    rc = cli.main(["--device", "cpu", "--shard", "-w", str(w), "-h", str(h), "--spp", str(spp), "--depth", "2",
                   "--passes", "1", scene_path, "-o", os.path.join(out_dir, "cli.png"),
                   "--profile", os.path.join(out_dir, "prof")])
    if rc != 0:
        raise SystemExit(f"rank {rank}: the CLI returned {rc}")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
