"""One rank of the gloo process group of ``tests/test_torch_parallel.py``.

    python tests/_torch_parallel_worker.py RANK WORLD STORE IN.npz OUT_DIR

Joins a group of WORLD CPU processes through a ``FileStore`` at STORE (no
port), runs every check of the sharded paths of ``kajo_tpu_torch.parallel``
on it at one PyTorch thread, and writes what rank 0 saw to
OUT_DIR/results.npz: each sharded image beside its unsharded twin, and for
the parity pass the image drawn from the JAX package's uniforms in IN.npz
(a table of ``jax.random`` draws by fold path, made by the test, so this
process imports no JAX).
"""

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kajo_tpu_torch.diff import inverse  # noqa: E402
from kajo_tpu_torch.models.integrator import RenderConfig, render_pass  # noqa: E402
from kajo_tpu_torch.models.wavefront import render_pass_fast  # noqa: E402
from kajo_tpu_torch.ops import geometry, megakernel  # noqa: E402
from kajo_tpu_torch.ops.rng import CounterKey  # noqa: E402
from kajo_tpu_torch.parallel import objshard, render  # noqa: E402
from kajo_tpu_torch.scene import parser  # noqa: E402
from kajo_tpu_torch.scene.procedural import random_spheres_scene  # noqa: E402
from kajo_tpu_torch.scene.testscene import build_test_scene  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
CFG = RenderConfig(max_depth=2)
SPP = 4
# the sizes: 16x12 (192 lanes, which 2 and 3 divide), 13x7 (91 lanes: the
# last block pads) and 2x1 (a block of pad lanes only)
SIZES = ((16, 12), (13, 7), (2, 1))


class TableKey:
    """A key whose draws are looked up by fold path in a table of arrays
    (``"4/0/7919/1"``: the key folded with 0, 7919, 1)."""

    def __init__(self, table, path=()):
        self.table, self.path = table, path

    def fold_in(self, i):
        return TableKey(self.table, self.path + (i,))

    def uniform(self, shape, device):
        a = self.table["/".join(map(str, self.path))]
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a).to(device)


def main():
    rank, world, store, inp, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    mesh = render.make_mesh()
    one, _ = dist.new_subgroups(group_size=1)
    mesh1 = render.make_mesh(group=one)
    pair = dist.new_group([0, 1])  # every rank makes it; ranks 0 and 1 use it
    mesh2 = render.make_mesh(group=pair) if rank < 2 else None
    table = dict(np.load(inp))
    obj_seed = int(table.pop("obj_seed"))
    res = {}
    t0 = time.time()

    def keep(name, x):
        if rank == 0:
            res[name] = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    # K1 (its plain twin on the CPU) and the wavefront, lane-sharded
    spheres = parser.load(os.path.join(DATA, "caustics.json"), 4 / 3, "cpu")
    dense = build_test_scene(4 / 3, "cpu")
    for w, h in SIZES:
        keep(f"mega/{w}x{h}", render.render_pass_megakernel_sharded(spheres, 11, w, h, SPP, CFG, mesh))
        keep(f"fast/{w}x{h}", render.render_pass_fast_sharded(dense, 7, w, h, SPP, CFG, mesh))
        if rank == 0:
            keep(f"mega/{w}x{h}/whole", megakernel.render_pass_megakernel(spheres, 11, w, h, SPP, CFG))
            keep(f"fast/{w}x{h}/whole", render_pass_fast(dense, 7, w, h, SPP, CFG))
    # world sizes 2 and 1 at the size that pads
    for world_n, m in ((2, mesh2), (1, mesh1 if rank == 0 else None)):
        if m is not None:
            keep(f"mega/13x7/world{world_n}", render.render_pass_megakernel_sharded(spheres, 11, 13, 7, SPP, CFG, m))
            keep(f"fast/13x7/world{world_n}", render.render_pass_fast_sharded(dense, 7, 13, 7, SPP, CFG, m))
    keep("launches/mega", megakernel.kernel_launches)

    # the parity engine: world 3 against world 1 and the unsharded pass with a
    # counter key; and with the JAX package's draws
    keep("parity", render.render_pass_sharded(dense, CounterKey(3), 16, 12, SPP, CFG, mesh))
    if rank == 0:
        keep("parity/world1", render.render_pass_sharded(dense, CounterKey(3), 16, 12, SPP, CFG, mesh1))
        keep("parity/whole", render_pass(dense, CounterKey(3), 16, 12, SPP, CFG))
    keep("parity/jax-draws", render.render_pass_sharded(dense, TableKey(table), 16, 12, SPP, CFG, mesh))
    keep("engine/parity", render.render_pass_sharded_engine("parity", dense, 3, 16, 12, SPP, CFG, mesh))
    keep("engine/auto", render.render_pass_sharded_engine("auto", dense, 7, 16, 12, SPP, CFG, mesh))
    keep("image", render.render_image_sharded(dense, 16, 12, SPP, CounterKey(3), 2, CFG, mesh))
    if rank == 0:
        keep("image/whole", (render_pass(dense, CounterKey(3).fold_in(0), 16, 12, SPP, CFG)
                             + render_pass(dense, CounterKey(3).fold_in(1), 16, 12, SPP, CFG)) / 2)

    # the object-sharded wavefront: 67 spheres (3 does not divide them), a
    # non-rigid field, and a streamed shard (the plain K5 on each rank)
    scenes = {
        "rigid": random_spheres_scene(67, seed=21, extent=12.0, n_lights=2, aspect_ratio=16 / 12, device="cpu"),
        "jitter": random_spheres_scene(31, seed=22, extent=10.0, n_lights=1, aspect_ratio=16 / 12,
                                       scale_jitter=0.5, device="cpu"),
    }
    for name, scene in scenes.items():
        keep(f"obj/{name}", objshard.render_pass_fast_objsharded(scene, obj_seed, 16, 12, SPP, CFG, mesh))
        if rank == 0:
            keep(f"obj/{name}/whole", render_pass_fast(scene, obj_seed, 16, 12, SPP, CFG))
    threshold = geometry.STREAM_THRESHOLD
    geometry.STREAM_THRESHOLD = 16
    try:
        keep("obj/streamed", objshard.render_pass_fast_objsharded(scenes["rigid"], obj_seed, 16, 12, SPP, CFG, mesh))
        if rank == 0:
            keep("obj/streamed/whole", render.render_pass_fast_sharded(scenes["rigid"], obj_seed, 16, 12, SPP, CFG, mesh1))
        local, _ = objshard.shard_prep(geometry.prepare_scene(scenes["rigid"]), mesh)
        keep("obj/streamed/shard-packed", local.stream_packed is not None)
    finally:
        geometry.STREAM_THRESHOLD = threshold

    # gradients: render_loss under the mesh against the unsharded parity loss
    scene = dense
    params = inverse.extract_params(scene, ("diffuse", "sphere_transform"))
    target = render_pass(scene, CounterKey(9), 16, 12, SPP, CFG)

    def grads_of(mesh_arg, render_fn=None):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = inverse.render_loss(leaves, scene, target, 5, 6, 16, 12, SPP, CFG, mesh=mesh_arg, render=render_fn)
        g = torch.autograd.grad(loss, list(leaves.values()))
        return loss, dict(zip(leaves, g))

    loss, g = grads_of(mesh)
    keep("grad/loss", loss)
    for k, v in g.items():
        keep(f"grad/{k}", v)
    if rank == 0:
        loss1, g1 = grads_of(None, lambda s, seed: render_pass(s, seed, 16, 12, SPP, CFG))
        keep("grad/loss/whole", loss1)
        for k, v in g1.items():
            keep(f"grad/{k}/whole", v)

    # three Adam steps of InverseRenderer(mesh=...): the same parameters on
    # every rank
    inv = inverse.InverseRenderer(scene, target, 16, 12, spp=SPP, config=CFG, mesh=mesh,
                                  param_spec=("diffuse",), seed=3)
    losses = [inv.step() for _ in range(3)]
    flat = inv.params["diffuse"].detach().reshape(-1)
    every = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(every, flat)
    keep("inverse/engine", inv.engine)
    keep("inverse/losses", np.array(losses))
    keep("inverse/params", torch.stack(every))

    keep("seconds", time.time() - t0)
    dist.barrier()
    if rank == 0:
        np.savez(os.path.join(out_dir, "results.npz"), **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
