"""Raw-mode terminal backend (`euler_tpu/render/terminal.py`).

Python equivalent of the reference's misc/terminal.c: raw mode with
non-blocking single-byte reads (VMIN=VTIME=0, terminal.c:77-78), atexit
restoration + cursor re-show (terminal.c:61-62), window-size query
(terminal.c:108-117) and SIGWINCH registration (terminal.c:119-125).
"""

from __future__ import annotations

import atexit
import os
import signal
import sys
import termios

from euler_tpu_torch.render.ansi import T_CLEAR, T_REPOSITION, T_SHOW_CURSOR

_orig_attrs = None
_fd = None


def _write(data: bytes):
    os.write(sys.stdout.fileno(), data)


def clear_screen_now():
    _write(T_CLEAR + T_REPOSITION)


def show_cursor_now():
    _write(T_SHOW_CURSOR)


def enable_raw_mode(fd: int | None = None):
    global _orig_attrs, _fd
    _fd = sys.stdin.fileno() if fd is None else fd
    _orig_attrs = termios.tcgetattr(_fd)
    atexit.register(disable_raw_mode)
    atexit.register(show_cursor_now)
    raw = termios.tcgetattr(_fd)
    # mirror terminal.c:69-78
    raw[0] &= ~(termios.BRKINT | termios.ICRNL | termios.INPCK
                | termios.ISTRIP | termios.IXON)        # iflag
    raw[1] &= ~termios.OPOST                            # oflag
    raw[2] |= termios.CS8                               # cflag
    raw[3] &= ~(termios.ECHO | termios.ICANON | termios.IEXTEN
                | termios.ISIG)                         # lflag
    raw[6][termios.VMIN] = 0
    raw[6][termios.VTIME] = 0
    termios.tcsetattr(_fd, termios.TCSAFLUSH, raw)


def disable_raw_mode():
    if _orig_attrs is not None and _fd is not None:
        termios.tcsetattr(_fd, termios.TCSAFLUSH, _orig_attrs)


def read_key() -> str:
    """Non-blocking 1-byte read (main.c:961-963)."""
    try:
        data = os.read(sys.stdin.fileno(), 1)
    except (BlockingIOError, InterruptedError):
        return ""
    return data.decode(errors="ignore") if data else ""


def get_window_size():
    """(rows, cols) of the output terminal (terminal.c:108-117)."""
    try:
        size = os.get_terminal_size(sys.stdout.fileno())
        if size.lines > 0 and size.columns > 0:
            return size.lines, size.columns
    except OSError:
        pass
    return 24, 80


def set_window_size_handler(fn):
    signal.signal(signal.SIGWINCH, fn)
