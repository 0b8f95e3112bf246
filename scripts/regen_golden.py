"""Regenerate tests/golden/cornell_64_f8_ldr.npy DELIBERATELY.

Run on the CPU backend (the golden test runs on the CPU; chip_smoke.py
compares the GPU against the same file):

    python scripts/regen_golden.py

Only run this after an INTENTIONAL change to the radiance math or RNG
consumption order (CLAUDE.md invariants). Record the reason in the commit
message. History of deliberate regenerations:
  - r3: refreshed for the V3-of-planes post pass (float-op reorder,
    49.6 dB vs the r2 golden - above the gate but eating margin) and to
    add the second golden (restir stress scene). No RNG-order change.
  - (r3 interim: the tap-batching experiment regenerated it while
    batched taps were the default, then reverted to the r2 golden when
    measurement put the sequential reference-exact order back as the
    default.)
"""

import sys

sys.path.insert(0, ".")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp


def _render(scene, w, h, frames):
    from tpu_raytracer.render import camera as camera_mod
    from tpu_raytracer.render import pipeline, renderer

    cam = camera_mod.CameraController()
    state = pipeline.init_state(w, h)
    for frame in range(frames):
        uniform = renderer.camera_to_device(
            cam.uniform(w / h, frame, scene.num_lights))
        ldr, hdr, state, aux = pipeline.render_frame(
            scene, uniform, jnp.uint32(frame), state, w, h)
    return np.asarray(ldr, np.float16)


def main():
    from tpu_raytracer.models import scenes

    out = _render(scenes.create_cornell_box(), 64, 64, 8)
    np.save("tests/golden/cornell_64_f8_ldr.npy", out)
    print("wrote tests/golden/cornell_64_f8_ldr.npy",
          out.shape, out.dtype, float(out.mean()))

    # second golden: the 100-light ReSTIR stress scene (scenes.rs hsv
    # grid) - pins many-light NEE sampling + reservoir paths Cornell
    # doesn't reach
    out = _render(scenes.create_restir_scene(), 48, 48, 4)
    np.save("tests/golden/restir_48_f4_ldr.npy", out)
    print("wrote tests/golden/restir_48_f4_ldr.npy",
          out.shape, out.dtype, float(out.mean()))


if __name__ == "__main__":
    main()
