"""ms a pass in the pass wrapper: the host's time inside the engine's batch
entry (``render_passes_megakernel``: ``prepare_pass``, ``pack_scene``, the
launches and ``_image``), summed over the window's batches outside the
profiled slice (all of them where the window has none), over their passes."""


def read(record):
    reqs = [r for r in record.requests if not r.traced] or record.requests
    passes = sum(r.passes for r in reqs)
    if not passes:
        return None
    return 1e3 * sum(r.spans.get("wrapper", 0.0) for r in reqs) / passes
