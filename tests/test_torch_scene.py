"""Port scene model, parser and scene packing against kajo_tpu (exact arrays;
packed records at float32 tolerance)."""

import dataclasses

import numpy as np
import pytest
import torch
from torch_port import DATA, jax_scene, to_port

from kajo_tpu.ops.geometry import prepare_scene as jax_prepare_scene
from kajo_tpu.ops.pallas.megakernel import _pack_scene as jax_pack_scene
from kajo_tpu.scene import parser as jax_parser
from kajo_tpu.scene.testscene import build_test_scene as jax_build_test_scene
from kajo_tpu_torch.ops.geometry import prepare_scene
from kajo_tpu_torch.ops.megakernel import pack_scene, supports
from kajo_tpu_torch.scene import parser
from kajo_tpu_torch.scene.testscene import build_test_scene

ASPECT = 32 / 24


def _both(name):
    if name == "testscene":
        return jax_build_test_scene(ASPECT), build_test_scene(ASPECT, device="cpu")
    return jax_scene(name, ASPECT), parser.load(f"{DATA}/{name}", ASPECT, device="cpu")


def _leaves(scene):
    """Flat {path: numpy array} of a scene of either package."""
    out = {}

    def walk(prefix, obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                walk(prefix + f.name + ".", v)
            elif f.name not in ("light_indices", "rigid_spheres"):
                out[prefix + f.name] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    walk("", scene)
    return out


@pytest.mark.parametrize("name", ["caustics.json", "scaled.json", "testscene"])
def test_scene_arrays_equal_jax(name):
    js, ts = _both(name)
    assert ts.light_indices == js.light_indices
    assert ts.rigid_spheres == js.rigid_spheres
    assert (ts.num_planes, ts.num_spheres, ts.num_lights) == (js.num_planes, js.num_spheres, js.num_lights)
    a, b = _leaves(js), _leaves(ts)
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].dtype == np.float32, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _caustics_nonrigid():
    """caustics.json with its glass ball scaled (a general record)."""
    js = jax_scene("caustics.json", ASPECT)
    st = np.array(js.sphere_transform)
    st[0] = st[0] @ np.diag(np.array([1.3, 0.8, 1.1, 1.0], np.float32))
    return dataclasses.replace(js, sphere_transform=st, rigid_spheres=False)


@pytest.mark.parametrize("name", ["caustics.json", "scaled.json", "testscene", "caustics-nonrigid"])
def test_pack_scene_matches_jax(name):
    if name == "caustics-nonrigid":
        js = _caustics_nonrigid()
        ts = to_port(js)
    else:
        js, ts = _both(name)
    want = np.asarray(jax_pack_scene(jax_prepare_scene(js)))[0]
    got = pack_scene(prepare_scene(ts)).numpy()
    assert got.shape == want.shape
    assert prepare_scene(ts).rigid == js.rigid_spheres
    # inverses/determinants: float32 on both sides, LAPACK routes may differ
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_scene_from_numpy():
    js = jax_scene("scaled.json", ASPECT)
    ts = to_port(js)
    assert ts.device.type == "cpu" and not ts.rigid_spheres
    assert supports(ts)
    np.testing.assert_array_equal(ts.materials.emission.numpy(), np.asarray(js.materials.emission))
    assert ts.light_indices == js.light_indices


@pytest.mark.parametrize(
    "text",
    ["scale(.5)", "translate(1, 2)", "rotate(30, 0, 1, 0) scale(2, 1.2, .8)", "lookat(-5, -2.5, 5, 0, 0, 0, 0, -1, 0)"],
)
def test_transform_dsl_matches_jax(text):
    # scale(.5) is scale(.5, 0, 0): missing components are zero, as in the reference
    np.testing.assert_array_equal(parser.parse_transform(text), jax_parser.parse_transform(text))


@pytest.mark.parametrize("text", ["#fff", "#568", "#fa4411", "rgb(24, 24, 22)", "rgba(1, .5, .25, .5)"])
def test_color_dsl_matches_jax(text):
    # gamma 2.2 on all four components, unclamped
    np.testing.assert_array_equal(parser.parse_color(text), jax_parser.parse_color(text))
