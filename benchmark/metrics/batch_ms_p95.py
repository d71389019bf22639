"""ms: the 95th percentile over every batch of the window of the time from
the batch's submission to its image being in the host's sum (each read by
CUDA events on the device's clock)."""

from benchmark.stats import percentile


def read(record):
    lat = [r.latency_ms for r in record.requests if r.latency_ms is not None]
    return percentile(lat, 95) if lat else None
