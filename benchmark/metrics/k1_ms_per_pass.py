"""ms a pass of kernel K1 (``kajo_tpu_torch/csrc/megakernel.cu``): the
device time of its kernels in the profiled slice, over the slice's passes."""

import re

KERNELS = re.compile(r"\bmegakernel_(lanes|items)\b")


def read(record):
    sl = record.slice
    if sl is None:
        return None
    seconds = sum(s for name, s in sl.device_s.items() if KERNELS.search(name))
    passes = sum(r.passes for r in record.requests if r.traced)
    if seconds <= 0 or not passes:
        return None
    return 1e3 * seconds / passes
