"""% of the profiled slice in which no kernel, copy or memset runs on the
card."""


def read(record):
    sl = record.slice
    if sl is None or sl.window_s <= 0 or sl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
