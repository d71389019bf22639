"""samples/s: the samples of every pass completed and summed on the host
in the window, over the window's whole length (host clock, first
submission to the last batch's host sum)."""


def read(record):
    if not record.requests or record.window_s <= 0:
        return None
    return sum(r.work for r in record.requests) / record.window_s
