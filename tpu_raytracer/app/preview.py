"""Live terminal frame display: ANSI truecolor half-block preview.

The reference presents every frame to a window via the blit pass
(src/state.rs:222, src/passes/blit.rs:112). Headless on an accelerator host, the
closest faithful analogue is drawing the letterboxed LDR into the
terminal: each character cell shows two vertical pixels via the upper
half block (U+2580) with 24-bit foreground (top) and background (bottom)
colors. Redraws in place with cursor-up so the loop "presents" at frame
rate without scrolling.
"""

from __future__ import annotations

import sys

import numpy as np

_RESET = "\x1b[0m"


def downsample(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Box-filter downsample [h,w,3] -> [out_h,out_w,3] (pure numpy)."""
    h, w = img.shape[:2]
    ys = (np.linspace(0, h, out_h + 1)).astype(np.int64)
    xs = (np.linspace(0, w, out_w + 1)).astype(np.int64)
    csum = np.cumsum(np.cumsum(img.astype(np.float64), 0), 1)
    csum = np.pad(csum, ((1, 0), (1, 0), (0, 0)))
    a = csum[ys[1:][:, None], xs[1:][None, :]]
    b = csum[ys[:-1][:, None], xs[:-1][None, :]]
    c = csum[ys[1:][:, None], xs[:-1][None, :]]
    d = csum[ys[:-1][:, None], xs[1:][None, :]]
    area = ((ys[1:] - ys[:-1])[:, None] * (xs[1:] - xs[:-1])[None, :])
    return ((a + b - c - d) / np.maximum(area, 1)[..., None]).astype(
        np.float32)


def render_ansi(img: np.ndarray, cols: int = 100) -> str:
    """[h,w,3] float LDR (0..1) -> ANSI half-block string.

    Character cells are ~2:1 tall, so a cell covers a 1x2 pixel pair:
    rows = cols * (h/w) / 2, preserving aspect like the blit letterbox.
    """
    h, w = img.shape[:2]
    rows = max(1, int(round(cols * (h / w) / 2)))
    small = downsample(np.clip(img, 0.0, 1.0), cols, rows * 2)
    rgb = (small * 255.0 + 0.5).astype(np.uint8)
    top = rgb[0::2]
    bot = rgb[1::2]
    lines = []
    for y in range(rows):
        run = []
        prev = None
        for x in range(cols):
            tr, tg, tb = top[y, x]
            br, bg, bb = bot[y, x]
            key = (tr, tg, tb, br, bg, bb)
            if key != prev:
                run.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                           f"\x1b[48;2;{br};{bg};{bb}m")
                prev = key
            run.append("▀")
        lines.append("".join(run) + _RESET)
    return "\n".join(lines)


class TerminalPresenter:
    """Present frames in place (the swapchain-present stand-in)."""

    def __init__(self, cols: int = 100, stream=None):
        self.cols = max(2, int(cols))
        self.stream = stream if stream is not None else sys.stdout
        self._last_rows = 0

    def present(self, img: np.ndarray, status: str = "") -> None:
        frame = render_ansi(img, self.cols)
        if status:
            frame += "\n\x1b[2K" + status  # the window-title telemetry line
        rows = frame.count("\n") + 1
        out = []
        if self._last_rows:
            out.append(f"\x1b[{self._last_rows}F")  # cursor to redraw origin
        out.append(frame + "\n")
        self.stream.write("".join(out))
        self.stream.flush()
        self._last_rows = rows
