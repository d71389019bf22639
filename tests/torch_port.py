"""Shared helpers of the tests that hold the PyTorch port (``kajo_tpu_torch``)
against the JAX package (``kajo_tpu``): one scene handed to both packages,
the JAX megakernel run as its own tests run it on the CPU (Pallas interpret
mode), and the image metrics of the comparisons."""

import dataclasses
import os

import jax
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from kajo_tpu.models.integrator import RenderConfig as JaxRenderConfig
from kajo_tpu.ops.pallas import megakernel as jax_megakernel
from kajo_tpu.ops.rng import seed_from_key
from kajo_tpu.scene import parser as jax_parser
from kajo_tpu.scene.types import Camera as JaxCamera
from kajo_tpu.scene.types import make_scene as jax_make_scene
from kajo_tpu_torch.scene.testscene import two_light_scene_parts
from kajo_tpu_torch.scene.types import scene_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
GOLDENS = os.path.join(REPO, "tests", "goldens")

# the tests run one process per core (pytest-xdist): one intra-op thread
# each keeps PyTorch's thread pools from oversubscribing the cores
torch.set_num_threads(1)


def to_port(jax_scene, device="cpu"):
    """The port's Scene holding the same arrays as a kajo_tpu Scene."""
    return scene_from_numpy(dataclasses.asdict(jax.tree.map(np.asarray, jax_scene)), device)


def jax_scene(name, aspect):
    """An in-repo scene file loaded by the JAX package's parser."""
    return jax_parser.load(os.path.join(DATA, name), aspect)


def jax_two_light_scene(aspect=1.5):
    view, projection, background, planes, spheres = two_light_scene_parts(aspect)
    return jax_make_scene(JaxCamera(view, projection), background, planes, spheres)


def jax_pass(scene, key_int, w, h, spp, **config):
    """The JAX megakernel pass in interpret mode -> (image, u32 seed): the
    port takes the same seed as a plain integer."""
    key = jax.random.PRNGKey(key_int)
    with pltpu.force_tpu_interpret_mode():
        img = jax_megakernel.render_pass_megakernel(scene, key, w, h, spp, JaxRenderConfig(**config))
    return np.asarray(img), int(seed_from_key(key))


def tm(x):
    """Clamp and gamma, as the image is displayed."""
    return np.clip(x[..., :3], 0, 1) ** (1 / 2.2)


def tm_mad(a, b):
    return float(np.abs(tm(a) - tm(b)).mean())


def mean_rel(a, b):
    return float(abs(a[..., :3].mean() - b[..., :3].mean()) / b[..., :3].mean())
