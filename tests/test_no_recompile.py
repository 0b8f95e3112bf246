"""Steady-state frames must not trigger XLA compiles.

The eager-refit finding: per-frame device work whose trace closes over
freshly-computed arrays re-traces per call and XLA recompiles
identically-shaped programs EVERY frame (~0.4 s/frame on CPU).
tests/test_refit.py
pins the refit path specifically; this pins the WHOLE per-frame loop of
each bench config shape (bench.py): after warmup, rendering more frames
must compile nothing.
"""

import logging

import numpy as np

import jax
import jax.numpy as jnp

from tpu_raytracer.models import scenes
from tpu_raytracer.ops import refit as refit_ops
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import pipeline, renderer
from tpu_raytracer.utils.math3d import rotation_y, scale, translation

W = H = 32


class _CompileLog(logging.Handler):
    def __init__(self):
        super().__init__()
        self.compiles = []

    def emit(self, record):
        msg = record.getMessage()
        if "ompiling" in msg:          # "Compiling <fn> ..." / "compiling"
            self.compiles.append(msg)


def _assert_no_steady_state_compiles(frame_fn, warmup=2, measured=2):
    handler = _CompileLog()
    logger = logging.getLogger("jax")
    old_level = logger.level
    jax.config.update("jax_log_compiles", True)
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG)
    try:
        for i in range(warmup):
            frame_fn(i)
        handler.compiles.clear()
        for i in range(warmup, warmup + measured):
            frame_fn(i)
        assert not handler.compiles, (
            "steady-state frames recompiled:\n  "
            + "\n  ".join(m[:200] for m in handler.compiles))
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old_level)
        jax.config.update("jax_log_compiles", False)


def test_headline_loop_is_compile_free():
    scene = scenes.create_cornell_box()
    cam = camera_mod.CameraController()
    box = {"state": pipeline.init_state(W, H)}

    def frame(i):
        uniform = renderer.camera_to_device(
            cam.uniform(1.0, i, scene.num_lights))
        ldr, hdr, box["state"], aux = pipeline.render_frame(
            scene, uniform, jnp.uint32(i), box["state"], W, H,
            static_ok=i > 0)
        jax.block_until_ready(ldr)

    _assert_no_steady_state_compiles(frame)


def test_config4_refit_motion_loop_is_compile_free():
    """The shape that carried the r4 bug: per-frame changed-instance
    refit + camera motion + accumulation reset (bench.py --config 4)."""
    box = {"scene": scenes.create_cornell_box(),
           "state": pipeline.init_state(W, H)}
    base = np.asarray(box["scene"].inst_transform)
    cam = camera_mod.CameraController()

    def frame(i):
        cam.press("d")
        cam.update(1.0 / 60.0)
        cam.release("d")
        tf = base.copy()
        crystal = (translation([0.4, -0.5 + 0.02 * (i % 8), 0.3])
                   @ rotation_y(0.1 * i) @ scale(0.5))
        tf[6] = crystal[:3, :4]
        box["scene"] = refit_ops.update_instances(
            box["scene"], jnp.asarray(tf), changed=(6,))
        uniform = renderer.camera_to_device(
            cam.uniform(1.0, 0, box["scene"].num_lights))
        ldr, hdr, box["state"], aux = pipeline.render_frame(
            box["scene"], uniform, jnp.uint32(0), box["state"], W, H,
            static_ok=False)
        jax.block_until_ready(ldr)

    _assert_no_steady_state_compiles(frame)


def test_progressive_loop_is_compile_free():
    scene = scenes.create_cornell_box_diffuse()
    cam = camera_mod.CameraController()
    box = {"accum": renderer.make_accum(W, H)}

    def frame(i):
        uniform = renderer.camera_to_device(
            cam.uniform(1.0, i, scene.num_lights))
        box["accum"], rad = renderer.render_progressive(
            scene, uniform, jnp.uint32(i), box["accum"], W, H)
        jax.block_until_ready(box["accum"])

    _assert_no_steady_state_compiles(frame)
