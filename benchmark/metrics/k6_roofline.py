"""% of K6's roofline: the least time a pass's K6 calls could take on the
card (``benchmark/bounds_stream.py``, from the reference's counts on the
first checked batch's first pass) over ``k6_ms_per_pass``, at the card's
published peaks (``benchmark/peaks.json``)."""

from benchmark import bounds, bounds_stream
from benchmark.harness import HERE, load_module


def read(record):
    stream_pass = record.extra.get("stream_pass")
    peak = bounds.peaks(record.device_name)
    if stream_pass is None or peak is None:
        return None
    ms = load_module(HERE / "metrics" / "k6_ms_per_pass.py").read(record)
    bound = bounds_stream.pass_bound_ms(stream_pass, "occluded", peak)
    if ms is None or bound is None:
        return None
    return 100.0 * bound / ms
