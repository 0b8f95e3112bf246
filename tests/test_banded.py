"""render_frame_banded == render_frame, bit-exact.

The sequential row-band path renders frames past one program's budget
(render/pipeline.auto_bands) as band programs; it must change NOTHING
about the image. Unlike the mesh path there is no halo
policy: every pass reads through full-resolution views and every RNG
stream keys on band-invariant global pixel indices, so equality is exact,
not approximate - including across frames (state carry), under motion
(reprojection crossing band borders), and with replay dedup enabled.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_raytracer.models import scenes
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import pipeline, renderer


def _frames(render, w, h, n_frames):
    scene = scenes.create_cornell_box()
    cam = camera_mod.CameraController()
    state = pipeline.init_state(w, h)
    out = []
    for i in range(n_frames):
        if i == 2:
            cam.press("d")
            cam.update(1.0 / 30.0)   # motion frame: reprojection crosses
            cam.release("d")         # band borders
        uniform = renderer.camera_to_device(
            cam.uniform(w / h, i, scene.num_lights))
        static_ok = i in (1, 3)      # exercise replay dedup on both paths
        ldr, hdr, state, aux = render(
            scene, uniform, jnp.uint32(i), state, w, h, static_ok)
        out.append((np.asarray(ldr), np.asarray(hdr), float(aux["rays"])))
    return out


@pytest.mark.parametrize("n_bands", [2, 4])
def test_banded_matches_whole_frame(n_bands):
    w = h = 32

    def whole(scene, uniform, fc, state, w, h, static_ok):
        return pipeline.render_frame(scene, uniform, fc, state, w, h,
                                     static_ok=static_ok)

    def banded(scene, uniform, fc, state, w, h, static_ok):
        return pipeline.render_frame_banded(scene, uniform, fc, state, w, h,
                                            n_bands, static_ok=static_ok)

    a = _frames(whole, w, h, 4)
    b = _frames(banded, w, h, 4)
    for i, ((la, ha, ra), (lb, hb, rb)) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(la, lb, err_msg=f"ldr frame {i}")
        np.testing.assert_array_equal(ha, hb, err_msg=f"hdr frame {i}")
        assert ra == rb, f"ray count frame {i}"


def test_auto_bands():
    assert pipeline.auto_bands(512, 512) == 1
    assert pipeline.auto_bands(1920, 1080) == 1
    assert pipeline.auto_bands(3840, 2160) == 1     # true 4K: one program
    k = pipeline.auto_bands(8192, 8192)
    assert k > 1 and 8192 % k == 0
    assert 8192 * (8192 // k) <= pipeline._BAND_RAY_BUDGET
