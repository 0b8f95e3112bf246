"""Golden-image regression: Cornell box at fixed camera/seed vs stored
reference render (SURVEY.md §4.2 - stands in for 'bit-comparable radiance').

Regenerate DELIBERATELY (never to paper over a diff) with:
    python scripts/regen_golden.py
"""

import os

import numpy as np
import jax.numpy as jnp

from tpu_raytracer.models import scenes
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import pipeline, renderer
from tpu_raytracer.utils.image import psnr

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "cornell_64_f8_ldr.npy")


def test_cornell_golden_psnr():
    w = h = 64
    scene = scenes.create_cornell_box()
    cam = camera_mod.CameraController()
    state = pipeline.init_state(w, h)
    for frame in range(8):
        uniform = renderer.camera_to_device(
            cam.uniform(1.0, frame, scene.num_lights))
        ldr, hdr, state, aux = pipeline.render_frame(
            scene, uniform, jnp.uint32(frame), state, w, h)
    got = np.asarray(ldr, np.float32)
    want = np.load(GOLDEN).astype(np.float32)
    p = psnr(got, want)
    # identical math -> near-lossless (f16 golden quantization ~ 70 dB);
    # anything below 45 dB means the renderer's output actually changed
    assert p > 45.0, f"PSNR vs golden = {p:.1f} dB"


GOLDEN_RESTIR = os.path.join(os.path.dirname(__file__), "golden",
                             "restir_48_f4_ldr.npy")


def test_restir_stress_golden_psnr():
    """100-light hsv-grid stress scene (scenes.rs): pins many-light NEE
    sampling, light-pick RNG order and reservoir merges that the Cornell
    golden never exercises."""
    w = h = 48
    scene = scenes.create_restir_scene()
    cam = camera_mod.CameraController()
    state = pipeline.init_state(w, h)
    for frame in range(4):
        uniform = renderer.camera_to_device(
            cam.uniform(1.0, frame, scene.num_lights))
        ldr, hdr, state, aux = pipeline.render_frame(
            scene, uniform, jnp.uint32(frame), state, w, h)
    got = np.asarray(ldr, np.float32)
    want = np.load(GOLDEN_RESTIR).astype(np.float32)
    p = psnr(got, want)
    assert p > 45.0, f"PSNR vs restir golden = {p:.1f} dB"


def _render_frames(w, h, frames):
    scene = scenes.create_cornell_box()
    cam = camera_mod.CameraController()
    state = pipeline.init_state(w, h)
    for frame in range(frames):
        uniform = renderer.camera_to_device(
            cam.uniform(1.0, frame, scene.num_lights))
        ldr, hdr, state, aux = pipeline.render_frame(
            scene, uniform, jnp.uint32(frame), state, w, h)
    return np.asarray(ldr, np.float32)


def test_last_skip_full_pipeline(trace_env):
    """TPU_RT_LAST_SKIP=0 (always-dual final bounce trace, the
    pre-routing behavior) must be bit-identical to the default
    shadow-only routing: the routed-away bounce result is never read."""
    trace_env.setenv("TPU_RT_LAST_SKIP", "0")
    want = _render_frames(48, 48, 2)
    trace_env.delenv("TPU_RT_LAST_SKIP")
    got = _render_frames(48, 48, 2)
    assert float(np.abs(got - want).max()) == 0.0


def test_gather_t_full_pipeline(trace_env):
    """TPU_RT_GATHER_T=1 (column-major gather outputs on neighbor reads)
    is bit-identical at the op level; this pins the whole frame too."""
    trace_env.setenv("TPU_RT_GATHER_T", "1")
    got = _render_frames(48, 48, 2)
    trace_env.delenv("TPU_RT_GATHER_T")
    want = _render_frames(48, 48, 2)
    assert float(np.abs(got - want).max()) == 0.0
