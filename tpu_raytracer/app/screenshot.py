"""Asynchronous screenshot sidecar.

Mirrors the reference's background saver thread (state.rs:40-45 spawn,
screenshot.rs worker): the render loop hands a frame to a queue and keeps
rendering; a daemon thread converts and writes
`output/screenshot_<timestamp>.png`. Denoising (the OIDN analogue,
ops/denoise.py) runs ON DEVICE before the handoff - the host thread only
does the u8 convert (native multithreaded) + PNG encode (native zlib).

The reference's GPU->CPU readback depad step (state.rs:232-268) has no
analogue here: `jax.device_get` hands back dense rows already.
"""

from __future__ import annotations

import datetime
import os
import queue
import threading
import functools
import time

import jax
import numpy as np


class ScreenshotSaver:
    """Daemon worker; `submit` is non-blocking (drops if the queue is full,
    matching the reference's one-in-flight staging buffer)."""

    def __init__(self, out_dir: str = "output", max_pending: int = 2):
        self.out_dir = out_dir
        self.queue: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.saved = 0
        self.thread.start()

    def submit(self, img, label: str = "screenshot") -> bool:
        """img: [H, W, 3] float linear HDR in [0,1] (numpy or device array).

        Returns False if the queue is full (frame dropped).
        """
        try:
            self.queue.put_nowait((np.asarray(img), label))
            return True
        except queue.Full:
            return False

    def _worker(self):
        from ..runtime import native

        while True:
            img, label = self.queue.get()
            t0 = time.time()
            u8 = native.linear_to_srgb_u8(img)
            ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S_%f")
            path = os.path.join(self.out_dir, f"{label}_{ts}.png")
            native.write_png(path, u8)
            self.saved += 1
            print(f"saved {path} in {time.time() - t0:.3f}s")
            self.queue.task_done()

    def flush(self, timeout: float = 30.0):
        deadline = time.time() + timeout
        while not self.queue.empty() and time.time() < deadline:
            time.sleep(0.05)
        self.queue.join()


def denoised_screenshot(gb_rows, hdr_flat, width: int, height: int,
                        iterations: int = 4):
    """Device-side denoise for the screenshot path (config 5).

    Takes the PACKED G-buffer rows (state["gb"]) and returns [H, W, 3]
    denoised linear HDR (still on device). The whole unpack + a-trous
    chain is ONE jitted dispatch: run eagerly, the 4K denoiser was
    dozens of unfused per-op dispatches, each materializing 33 MB+
    intermediates, inside config 5's timed frame - same bug class as the
    eager refit.

    Frames that the pipeline renders in row bands (pipeline.auto_bands)
    route through the bit-identical sequential row-band a-trous
    (ops/denoise.atrous_denoise_banded), like the frame pipeline."""
    from ..render.pipeline import auto_bands

    n_bands = auto_bands(width, height)
    if n_bands > 1 and height % n_bands == 0:
        from ..ops import denoise

        gb_img = _unpack_img_jit(gb_rows, hdr_flat, width, height)
        return denoise.atrous_denoise_banded(
            gb_img["hdr"], gb_img["albedo"], gb_img["octn"], gb_img["pos"],
            iterations, n_bands)
    return _denoised_jit(gb_rows, hdr_flat, width, height, iterations)


@functools.partial(jax.jit, static_argnames=("width", "height"))
def _unpack_img_jit(gb_rows, hdr_flat, width, height):
    from ..ops import gbuffer

    gb = gbuffer.unpack_gb(gb_rows)
    return {"hdr": hdr_flat.reshape(height, width, 3),
            "albedo": gb["albedo"].reshape(height, width, 3),
            "octn": gb["oct_normal"].reshape(height, width, 2),
            "pos": gb["pos"].reshape(height, width, 3)}


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "iterations"))
def _denoised_jit(gb_rows, hdr_flat, width, height, iterations):
    from ..ops import denoise, gbuffer

    gb = gbuffer.unpack_gb(gb_rows)
    hdr = hdr_flat.reshape(height, width, 3)
    albedo = gb["albedo"].reshape(height, width, 3)
    octn = gb["oct_normal"].reshape(height, width, 2)
    pos = gb["pos"].reshape(height, width, 3)
    return denoise.atrous_denoise(hdr, albedo, octn, pos, iterations)
