"""% of K1's roofline: the least time a pass could take on the card (the
larger of its bytes over the memory bandwidth and its FP32 operations over
the FP32 rate, counted from the plain reference walk's counts of the first
checked batch; ``benchmark/bounds.py``) over ``k1_ms_per_pass``. The peaks
are the card's published ones (``benchmark/peaks.json``), at its full power
limit; the run prints the card's limit beside them."""

from benchmark import bounds
from benchmark.harness import HERE, load_module


def read(record):
    shape = record.extra.get("k1_pass")
    peak = bounds.peaks(record.device_name)
    if shape is None or peak is None:
        return None
    ms = load_module(HERE / "metrics" / "k1_ms_per_pass.py").read(record)
    if ms is None:
        return None
    n_bytes, n_ops = bounds.k1_work(shape, shape["stats"], shape["passes"])
    bound, _ = bounds.bound_ms(n_bytes, n_ops, peak)
    return 100.0 * bound / ms
