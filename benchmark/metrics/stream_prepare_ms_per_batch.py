"""ms a batch the host spends preparing the streamed scene in the batch
entry (``render_passes_fast``'s ``prepare_scene``: the inverses, the
light table, the Morton sort and block packing of the spheres), from the
port's counter ``prepare_seconds`` over the window's batches."""


def read(record):
    seconds = record.counters.get("prepare_seconds")
    if seconds is None or not record.requests:
        return None
    return 1e3 * seconds / len(record.requests)
