"""Shared settings of the benchmark's CPU tests: small configurations of
the benchmark's cells, one PyTorch thread."""

import pytest
import torch

from benchmark import harness

torch.set_num_threads(1)

SMALL = {"width": 8, "height": 6, "spp": 4}


def small_cell(name: str, seed: int = 2**31 + 5, seconds: float = 1.5, trace: bool = False, **overrides):
    """The cell ``name`` at a small size on the CPU, engine ``mega`` (the
    plain K1), checking the window's first two batches."""
    entry = {w["name"]: w for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]}[name]
    cfg = harness.load_json(harness.HERE / "configs" / f"{entry['config']}.json")
    cfg.update(SMALL)
    cell = harness.load_cell(name, seed, seconds, trace, "cpu", config=cfg, engine="mega", **overrides)
    cell.traffic = dict(cell.traffic, check_batches=[[0, 1], [1, 2]], warmup_s=0.0)
    return cell


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
