"""Terminal graphics: capability detection and sixel / kitty / iTerm2 /
SGR / braille renderers (reference: src/terminal/).

Copied from zignal_tpu/terminal/: host numpy and strings, but for the
kitty and iTerm2 scaling, which is the port's ``Image.resize`` on the
image's device.
"""

from .detect import TerminalSupport, detect_terminal_support
from .display import DisplayFormat, format_image
from .iterm2 import iterm2_from_image
from .kitty import kitty_from_image
from .sixel import sixel_from_image

__all__ = [
    "TerminalSupport", "detect_terminal_support", "DisplayFormat",
    "format_image", "sixel_from_image", "kitty_from_image",
    "iterm2_from_image",
]
