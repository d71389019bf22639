"""Iterations of the wavefront's loop a pass (its body's runs, each one
K5 and one K6 call on a streamed scene), from the port's counter
``iterations`` over the window's passes."""


def read(record):
    iterations, passes = record.counters.get("iterations"), record.counters.get("passes")
    if iterations is None or not passes:
        return None
    return iterations / passes
