"""The port stands alone: no module of kajo_tpu_torch, and not
chip_smoke.py, imports jax or anything of kajo_tpu; and its scene loaders
put scenes on the CUDA device unless given ``device="cpu"``, raising where
there is none."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port import DATA, REPO

from kajo_tpu_torch.scene import parser, procedural, testscene, types

PORT = Path(REPO) / "kajo_tpu_torch"


def _imported_modules(path: Path):
    """Absolute module names a source file imports (relative imports stay
    inside its own package)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "kajo_tpu")


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [Path(REPO) / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_source_imports_nothing_of_jax_or_kajo_tpu(path):
    bad = [m for m in _imported_modules(path) if _foreign(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_imported_port_loads_nothing_of_jax_or_kajo_tpu():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__") for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'kajo_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('kajo_tpu_torch')]))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.split()[-1]) >= len(modules) - 1


LOADERS = {
    "parser.load": lambda **kw: parser.load(os.path.join(DATA, "caustics.json"), 1.0, **kw),
    "parser.loads": lambda **kw: parser.loads('{"objects": [{"type": "sphere", "radius": 1}]}', 1.0, **kw),
    "make_scene": lambda **kw: types.make_scene(types.Camera.default(), np.zeros(4, np.float32), [], [], **kw),
    "scene_from_numpy": lambda **kw: types.scene_from_numpy(
        dict(
            camera=dict(transform=np.eye(4), projection=np.eye(4)), background=np.zeros(4), plane_transform=np.zeros((0, 4, 4)),
            sphere_transform=np.eye(4)[None], sphere_radius=np.ones(1),
            materials={k: np.zeros((1, 4)) if k not in ("specular_exponent", "refractive_index") else np.ones(1)
                       for k in ("ambient", "diffuse", "specular", "emission", "transparency", "specular_exponent",
                                 "refractive_index")},
            light_indices=(),
        ),
        **kw,
    ),
    "build_test_scene": lambda **kw: testscene.build_test_scene(**kw),
    "build_two_light_scene": lambda **kw: testscene.build_two_light_scene(**kw),
    "random_spheres_scene": lambda **kw: procedural.random_spheres_scene(20, **kw),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loaders_default_to_cuda(name):
    load = LOADERS[name]
    assert load(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert load().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load()
