"""Terminal capability detection (reference: src/terminal/detect.zig).

Probes the controlling TTY with escape sequences: DA1 for sixel, a Kitty
APC query, and XTVERSION for iTerm2/WezTerm identification. All probes
degrade gracefully to "unsupported" on non-TTY stdio or timeouts.

Copied from zignal_tpu/terminal/detect.py.
"""

from __future__ import annotations

import dataclasses
import os
import select
import sys

__all__ = ["TerminalSupport", "detect_terminal_support", "cell_size"]


@dataclasses.dataclass
class TerminalSupport:
    is_tty: bool = False
    sixel: bool = False
    kitty: bool = False
    iterm2: bool = False
    truecolor: bool = False


def _query(seq: bytes, terminator: bytes, timeout: float = 0.15) -> bytes:
    """Write an escape probe to the TTY and read the reply."""
    try:
        import termios
        import tty as tty_mod

        fd = sys.stdin.fileno()
        if not os.isatty(fd):
            return b""
        old = termios.tcgetattr(fd)
        try:
            tty_mod.setcbreak(fd)
            os.write(sys.stdout.fileno(), seq)
            sys.stdout.flush()
            out = bytearray()
            while True:
                r, _, _ = select.select([fd], [], [], timeout)
                if not r:
                    break
                chunk = os.read(fd, 256)
                out.extend(chunk)
                if terminator in out:
                    break
            return bytes(out)
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
    except Exception:
        return b""


def detect_terminal_support() -> TerminalSupport:
    sup = TerminalSupport()
    try:
        sup.is_tty = sys.stdout.isatty() and sys.stdin.isatty()
    except Exception:
        return sup
    if not sup.is_tty:
        return sup

    sup.truecolor = os.environ.get("COLORTERM", "") in ("truecolor", "24bit")

    term = os.environ.get("TERM", "")
    program = os.environ.get("TERM_PROGRAM", "")
    if "kitty" in term or program.lower() == "kitty" or os.environ.get("KITTY_WINDOW_ID"):
        sup.kitty = True
    if program in ("iTerm.app", "WezTerm"):
        sup.iterm2 = True

    # DA1 probe: reply like ESC [ ? 62;4;... c — attribute 4 means sixel
    reply = _query(b"\x1b[c", b"c")
    if reply.startswith(b"\x1b[?"):
        attrs = reply[3:-1].split(b";")
        if b"4" in attrs:
            sup.sixel = True

    if not sup.kitty:
        # Kitty graphics query: APC G...; terminator ESC \
        reply = _query(b"\x1b_Gi=31,s=1,v=1,a=q,t=d,f=24;AAAA\x1b\\\x1b[c", b"c")
        if b"\x1b_G" in reply:
            sup.kitty = True
    return sup


def cell_size() -> tuple:
    """Terminal cell size in pixels (width, height), best effort."""
    try:
        import fcntl
        import struct
        import termios

        buf = fcntl.ioctl(sys.stdout.fileno(), termios.TIOCGWINSZ,
                          struct.pack("HHHH", 0, 0, 0, 0))
        rows, cols, xpix, ypix = struct.unpack("HHHH", buf)
        if rows and cols and xpix and ypix:
            return (xpix // cols, ypix // rows)
    except Exception:
        pass
    return (8, 16)
