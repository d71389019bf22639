"""How the forward-mode kernel K2 and the material-gradient kernel K3 cover
their (lane, sample) items, checked on the CPU without the card.

K2 (``csrc/megakernel_jvp.cu``) walks one item per thread and keeps K1's
summation order: each item logs its radiance terms, and one thread per lane
and channel adds its samples' logs in (sample, term) order, a CTA's worth of
samples (a wave) at a time. Its log holds 2 max_depth + 1 terms per item
(``megakernel.jvp_plan``). Here:

* the plain walk (``trace_lanes_plain(term_log=...)``) never hands a sample
  more terms than that bound, on caustics, ``scaled.json``, the two-light
  scene and the mirror cluster at max_depth 3, 8 and 20 (full MIS with NEE:
  an NEE sum and an emission term at every scattering vertex);
* the combine, emulated in PyTorch on those logs (waves of the plan, then
  samples, then terms), equals the plain walk's running sum bit for bit,
  with one wave and with several;
* K2's plan and K3's grid (``megakernel_grad.n_ctas``, ``item_at``) reach
  every (lane, sample) item exactly once, for odd lane counts.

K1 (``csrc/megakernel.cu``) takes the same plan below its own threshold,
with its own shared-byte rule (value logs only): its plan reaches every
item once, and the combine of its value logs, emulated, equals the plain
walk's running sum bit for bit, in one wave and in several; where the
lanes fill the card, a lane has one sample, or no log fits, it takes a
thread a lane.
"""

import os
from collections import Counter

import pytest
import torch
from torch_port import DATA

from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops import megakernel, megakernel_grad
from kajo_tpu_torch.scene import parser
from kajo_tpu_torch.scene.testscene import build_mirror_cluster, build_two_light_scene

W, H = 8, 6


def _scene(name, w=W, h=H):
    if name == "two-light":
        return build_two_light_scene(w / h, "cpu")
    if name == "mirror-cluster":
        return build_mirror_cluster(w / h, "cpu")
    return parser.load(os.path.join(DATA, name), w / h, "cpu")


def _logged_walk(scene, w, h, spp, config, seed):
    """The plain walk with its term log -> (sums [3, n], per (lane, sample)
    term counts [n, eff], the terms [n, eff, most, 3] in the order taken)."""
    ps = megakernel.prepare_pass(scene, w, h, spp, config)
    log = []
    with torch.no_grad():
        sums = megakernel.trace_lanes_plain(ps, seed, term_log=log)
    n, eff = ps.n_lanes, ps.eff
    lanes = torch.arange(n)
    counts = torch.zeros((n, eff), dtype=torch.int64)
    for sample, mask, _ in log:
        counts[lanes[mask], sample[mask]] += 1
    terms = torch.zeros((n, eff, max(int(counts.max()), 1), 3))
    counts.zero_()
    for sample, mask, term in log:
        at = counts[lanes[mask], sample[mask]]
        terms[lanes[mask], sample[mask], at] = torch.stack(term, 1)[mask]
        counts[lanes[mask], sample[mask]] += 1
    return sums, counts, terms


@pytest.mark.parametrize("max_depth", [3, 8, 20])
@pytest.mark.parametrize("name", ["caustics.json", "scaled.json", "two-light", "mirror-cluster"])
def test_terms_per_sample_within_the_log(name, max_depth):
    config = RenderConfig(max_depth=max_depth, full_mis=True)
    _, counts, _ = _logged_walk(_scene(name), W, H, 4, config, seed=7)
    assert megakernel.sample_terms(max_depth) == 2 * max_depth + 1
    assert int(counts.min()) >= 1 and int(counts.max()) <= megakernel.sample_terms(max_depth)


def _combine(plan, counts, terms):
    """K2's sums as its kernel forms them, emulated lane by lane: the
    lane's first block sums its samples' terms, then, wave by wave, each
    later block's logged terms continue that sum in (sample, term) order."""
    n = counts.shape[0]
    acc = torch.zeros((n, 3))
    for wave in range(plan.waves):
        for j in range(plan.wave):
            block = wave * plan.wave + j
            if block >= plan.blocks:
                break
            samples = range(block * plan.per_block, min((block + 1) * plan.per_block, plan.eff))
            own = torch.zeros((n, 3))
            for sample in samples:
                assert int(counts[:, sample].max()) <= plan.log_terms or block == 0
                for k in range(int(counts[:, sample].max())):
                    m = (counts[:, sample] > k)[:, None]
                    if block == 0:
                        own = torch.where(m, own + terms[:, sample, k], own)
                    else:
                        acc = torch.where(m, acc + terms[:, sample, k], acc)
            if block == 0:
                acc = own
    return acc


@pytest.mark.parametrize(
    "name,w,h,spp,config,per_block",
    [
        ("caustics.json", W, H, 16, RenderConfig(max_depth=3), None),
        ("two-light", W, H, 4, RenderConfig(max_depth=8, full_mis=True), None),
        ("mirror-cluster", 4, 3, 4, RenderConfig(max_depth=20), None),
        ("scaled.json", 3, 2, 144, RenderConfig(max_depth=3), None),  # two waves of 72 samples
        ("caustics.json", 3, 2, 81, RenderConfig(max_depth=100), None),  # a 64-thread log: two waves of 41
        ("caustics.json", W, H, 16, RenderConfig(max_depth=3, full_mis=True), 16),  # a thread a lane
    ],
    ids=["caustics-16spp", "two-light-full-mis", "mirror-cluster-depth20", "scaled-two-waves", "deep-two-waves",
         "a-thread-a-lane"],
)
def test_combine_in_waves_is_the_running_sum(name, w, h, spp, config, per_block):
    sums, counts, terms = _logged_walk(_scene(name, w, h), w, h, spp, config, seed=11)
    n, eff = counts.shape
    plan = megakernel.jvp_plan(n, eff, config.max_depth)
    if per_block is not None:  # the plan of an image whose lanes fill the card: no log
        plan = megakernel.jvp_plan(megakernel.JVP_RESIDENT_THREADS, eff, config.max_depth)
        assert (plan.per_block, plan.blocks, plan.log_terms) == (per_block, 1, 0)
    if spp > 64:
        assert plan.waves == 2
    acc = _combine(plan, counts, terms)
    assert torch.equal(acc.T.contiguous().view(torch.int32), sums.contiguous().view(torch.int32))


@pytest.mark.parametrize("eff", [1, 16, 64])
@pytest.mark.parametrize("max_depth", [4, 100])
def test_jvp_plan_reaches_every_sample_once(eff, max_depth):
    for n_lanes in (1, 77, 1001, 67_584):
        plan = megakernel.jvp_plan(n_lanes, eff, max_depth)
        assert plan.threads <= megakernel.PLAN_MAX_THREADS and plan.shared <= megakernel.PLAN_SHARED_LIMIT
        assert plan.wave * plan.waves >= plan.blocks and plan.wave * (plan.waves - 1) < plan.blocks
        assert plan.per_block == (1 if n_lanes < megakernel.JVP_RESIDENT_THREADS else eff)
        assert plan.log_terms == (2 * max_depth + 1 if plan.blocks > 1 else 0)
        seen = torch.zeros((n_lanes, eff), dtype=torch.int64)
        cta, wave, thread = torch.meshgrid(torch.arange(plan.n_ctas(n_lanes)), torch.arange(plan.waves),
                                           torch.arange(plan.threads), indexing="ij")
        lane, block = plan.item(cta, wave, thread)
        for k in range(plan.per_block):  # the block's samples
            sample = block * plan.per_block + k
            walks = (lane < n_lanes) & (sample < eff)
            seen.index_put_((lane[walks], sample[walks]), torch.ones(()).long(), accumulate=True)
        assert bool((seen == 1).all())


def test_jvp_plan_per_shape():
    """One sample a thread at the gradient path's shape and at 256x192,
    one lane a thread at the main path's (whose lanes fill the card), and
    no log there."""
    for n_lanes in (128 * 96, 256 * 192):
        plan = megakernel.jvp_plan(n_lanes, 16, 4)
        assert (plan.per_block, plan.blocks, plan.lanes_per_cta, plan.threads) == (1, 16, 8, 128)
    main = megakernel.jvp_plan(512 * 384, 16, 8)
    assert (main.per_block, main.blocks, main.log_terms, main.threads) == (16, 1, 0, 128)


def test_jvp_plan_refuses_a_log_that_cannot_fit():
    assert megakernel.jvp_plan(1, 16, 9682).threads == 1
    with pytest.raises(ValueError, match="max_depth"):
        megakernel.jvp_plan(1, 16, 9683)


@pytest.mark.parametrize("eff", [1, 16, 64])
def test_grad_grid_reaches_every_item_once(eff):
    for n_lanes in (1, 77, 1001, 12_289, 40_001):
        n_ctas = megakernel_grad.n_ctas(n_lanes, eff)
        items = megakernel_grad.n_items(n_lanes, eff)
        chunks = -(-items // megakernel_grad.ITEMS_PER_CTA)
        assert n_ctas == (chunks if chunks <= megakernel_grad.MAX_CTAS else megakernel_grad.RESIDENT_CTAS)
        # CTA b, thread t walks items b * 128 + t, then every grid's worth on
        stride = n_ctas * megakernel_grad.ITEMS_PER_CTA
        walked = torch.arange(items)
        assert int(((walked % stride) // megakernel_grad.ITEMS_PER_CTA).max()) < n_ctas
        lane, sample = megakernel_grad.item_at(walked, eff)
        keep = lane < n_lanes
        key = lane[keep] * eff + sample[keep]
        assert key.numel() == n_lanes * eff and torch.equal(torch.sort(key).values, torch.arange(n_lanes * eff))
        # a warp walks one sample of 32 adjacent lanes
        first = walked[: min(items, 32)]
        assert set(megakernel_grad.item_at(first, eff)[1].tolist()) == {0}


@pytest.mark.parametrize(
    "name,w,h,spp,config",
    [
        ("caustics.json", W, H, 16, RenderConfig(max_depth=3)),
        ("scaled.json", 3, 2, 144, RenderConfig(max_depth=3)),  # two waves of 72 samples
        ("caustics.json", 3, 2, 81, RenderConfig(max_depth=100)),  # a 64-thread log: two waves of 41
    ],
    ids=["one-wave", "two-waves", "deep-two-waves"],
)
def test_k1_combine_is_the_running_sum(name, w, h, spp, config):
    sums, counts, terms = _logged_walk(_scene(name, w, h), w, h, spp, config, seed=13)
    n, eff = counts.shape
    plan = megakernel.k1_plan(n, eff, config.max_depth)
    assert plan.per_block == 1 and plan.waves == (2 if spp > 64 else 1)
    assert plan.thread_floats == 4 and plan.lane_floats == 3
    acc = _combine(plan, counts, terms)
    assert torch.equal(acc.T.contiguous().view(torch.int32), sums.contiguous().view(torch.int32))


@pytest.mark.parametrize("eff", [4, 16, 81])
@pytest.mark.parametrize("max_depth", [4, 100])
def test_k1_plan_reaches_every_sample_once(eff, max_depth):
    for n_lanes in (1, 77, 1001, 12_289):
        plan = megakernel.k1_plan(n_lanes, eff, max_depth)
        assert plan.threads <= megakernel.PLAN_MAX_THREADS and plan.shared <= megakernel.PLAN_SHARED_LIMIT
        assert (plan.per_block, plan.blocks, plan.log_terms) == (1, eff, 2 * max_depth + 1)
        assert plan.wave * plan.waves >= plan.blocks and plan.wave * (plan.waves - 1) < plan.blocks
        seen = torch.zeros((n_lanes, eff), dtype=torch.int64)
        cta, wave, thread = torch.meshgrid(torch.arange(plan.n_ctas(n_lanes)), torch.arange(plan.waves),
                                           torch.arange(plan.threads), indexing="ij")
        lane, sample = plan.item(cta, wave, thread)
        walks = (lane < n_lanes) & (sample < eff)
        seen.index_put_((lane[walks], sample[walks]), torch.ones(()).long(), accumulate=True)
        assert bool((seen == 1).all())


def test_k1_plan_per_shape():
    """A thread a sample at the gradient path's shape, with smaller logs
    than K2's; a thread a lane (no plan) where the lanes fill the card, a
    lane has one sample, or not even one thread's log fits."""
    plan = megakernel.k1_plan(128 * 96, 16, 4)
    assert (plan.per_block, plan.blocks, plan.lanes_per_cta, plan.threads) == (1, 16, 8, 128)
    assert plan.shared == 4 * (128 * (3 * 9 + 4) + 3 * 8) < megakernel.jvp_plan(128 * 96, 16, 4).shared
    assert megakernel.k1_plan(megakernel.K1_RESIDENT_THREADS, 16, 4) is None
    assert megakernel.k1_plan(512 * 384, 16, 4) is None
    assert megakernel.k1_plan(77, 1, 4) is None
    assert megakernel.k1_plan(1, 16, 9683).threads == 1
    assert megakernel.k1_plan(1, 16, 9684) is None



@pytest.mark.parametrize("w,h", [(128, 96), (192, 144), (256, 192), (320, 240), (384, 288), (512, 384)])
def test_k1_regime_at_the_sweep_shapes(w, h):
    """The shapes of the sweep that placed K1's threshold (16 spp,
    max_depth 4): a thread a (lane, sample) up to 320x240, in one wave of
    CTAs of 8 lanes x 16 samples; a thread a lane from 384x288 on."""
    plan = megakernel.k1_plan(w * h, 16, 4)
    if w * h <= 320 * 240:
        assert (plan.per_block, plan.lanes_per_cta, plan.wave, plan.waves) == (1, 8, 16, 1)
    else:
        assert plan is None
