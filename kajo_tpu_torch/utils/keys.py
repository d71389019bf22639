"""Non-blocking terminal key polling for the progressive render loop (port
of ``kajo_tpu/utils/keys.py``).

ESC stops the render (the accumulation is still saved on the way out) and
s / Ctrl-S saves the current accumulation. The controlling terminal is put
in cbreak mode and stdin is drained between passes. When stdin is not a TTY
(pipes, CI), ``poll()`` always returns [] and scripted runs are unaffected.
"""

from __future__ import annotations

import contextlib
import os
import select
import sys

ESC = "\x1b"
CTRL_S = "\x13"


@contextlib.contextmanager
def key_poller():
    """Yield ``poll() -> list[str]`` of the keys pressed since the last call;
    restore the terminal on exit."""
    fd = None
    old = None
    if sys.stdin is not None and sys.stdin.isatty():
        import termios
        import tty

        try:
            fd = sys.stdin.fileno()
            old = termios.tcgetattr(fd)
            tty.setcbreak(fd)
        except (OSError, termios.error):
            fd = None

    def poll():
        if fd is None:
            return []
        chars = []
        try:
            while select.select([fd], [], [], 0)[0]:
                c = os.read(fd, 1)
                if not c:
                    break
                chars.append(c.decode(errors="ignore"))
        except OSError:
            pass
        return chars

    try:
        yield poll
    finally:
        if fd is not None and old is not None:
            import termios

            termios.tcsetattr(fd, termios.TCSADRAIN, old)
