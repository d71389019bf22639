"""Entry point: ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, from the root of a checkout. See
``benchmark/harness.py``."""

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (its start time
    from /proc, to a clock tick), or now where /proc has none."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return now - (time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return now


def _steady_host() -> None:
    """One thread for the math libraries and one core for the process (the
    last the process may use): a run's host work then meets less of the
    host's other load and no migration between cores."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    try:
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    except (AttributeError, OSError):
        pass


if __name__ == "__main__":
    started = _process_start()
    _steady_host()
    # the checkout's root in place of this folder, whose modules are the
    # package's and not top-level ones
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from benchmark.harness import main

    sys.exit(main(sys.argv[1:], started))
