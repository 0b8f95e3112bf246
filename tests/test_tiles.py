"""Multi-device screen-tile sharding: tiled pipeline == single-device pipeline.

Runs on 8 virtual CPU devices (conftest). This is the framework's
distributed-correctness test: halo exchange (ppermute), band addressing,
all_gather display assembly, psum telemetry.
"""

import numpy as np
import jax
import jax.numpy as jnp

from tpu_raytracer.models import scenes
from tpu_raytracer.parallel import tiles
from tpu_raytracer.render import camera as camera_mod
from tpu_raytracer.render import pipeline, renderer


def test_tiled_matches_single_chip():
    # small on purpose: one-core host serializes the 8 device threads
    # (see CLAUDE.md); validity is size-independent
    assert len(jax.devices()) == 8
    scene = scenes.create_cornell_box()
    mesh = tiles.make_mesh()
    w = h = 32

    cam = camera_mod.CameraController()
    state = tiles.shard_state(pipeline.init_state(w, h), mesh)
    scene_r = tiles.replicate(scene, mesh)
    render = tiles.make_render_frame_tiled(mesh, w, h)
    for frame in range(2):
        uniform = tiles.replicate(
            renderer.camera_to_device(cam.uniform(1.0, frame, scene.num_lights)),
            mesh)
        ldr, _hdr, state, aux = render(scene_r, uniform, jnp.uint32(frame),
                                       state)
    tiled = np.asarray(ldr)

    cam1 = camera_mod.CameraController()
    state1 = pipeline.init_state(w, h)
    for frame in range(2):
        uniform1 = renderer.camera_to_device(
            cam1.uniform(1.0, frame, scene.num_lights))
        ldr1, _, state1, aux1 = pipeline.render_frame(
            scene, uniform1, jnp.uint32(frame), state1, w, h)
    single = np.asarray(ldr1)

    assert np.isnan(tiled).sum() == 0
    # identical modulo float reassociation across the halo boundary
    assert np.abs(tiled - single).max() < 1e-5
    assert float(aux["rays"]) > 0
    assert abs(float(aux["rays"]) - float(aux1["rays"])) < 1e-3


def test_tiled_matches_single_chip_full_halo():
    """Bands TALLER than the halo (band_h=16 >= DEFAULT_HALO=16 > disk
    radius 10): spatial ReSTIR taps genuinely cross band borders through
    exchanged halo rows instead of being clamped away (VERDICT r1 weak #3).
    Narrow (w=16) to keep the one-core 8-thread run fast."""
    scene = scenes.create_cornell_box()
    mesh = tiles.make_mesh()
    w, h = 16, 128
    assert h // 8 >= tiles.DEFAULT_HALO

    cam = camera_mod.CameraController()
    state = tiles.shard_state(pipeline.init_state(w, h), mesh)
    scene_r = tiles.replicate(scene, mesh)
    render = tiles.make_render_frame_tiled(mesh, w, h)
    for frame in range(2):
        uniform = tiles.replicate(
            renderer.camera_to_device(
                cam.uniform(w / h, frame, scene.num_lights)), mesh)
        ldr, _hdr, state, aux = render(scene_r, uniform, jnp.uint32(frame),
                                       state)
    tiled = np.asarray(ldr)

    cam1 = camera_mod.CameraController()
    state1 = pipeline.init_state(w, h)
    for frame in range(2):
        uniform1 = renderer.camera_to_device(
            cam1.uniform(w / h, frame, scene.num_lights))
        ldr1, _, state1, aux1 = pipeline.render_frame(
            scene, uniform1, jnp.uint32(frame), state1, w, h)
    single = np.asarray(ldr1)

    assert np.isnan(tiled).sum() == 0
    assert np.abs(tiled - single).max() < 1e-5
    assert abs(float(aux["rays"]) - float(aux1["rays"])) < 1e-3


def test_tiled_matches_single_chip_with_motion():
    """Camera motion exercises temporal reprojection across band borders
    (the halo path); results must still match one device.

    Kept small: this box exposes ONE cpu core, the 8 virtual device threads
    serialize, and XLA aborts cross-device collectives whose participants
    stagger by more than 40 s - frames must stay well under that.
    """
    scene = scenes.create_cornell_box_diffuse()
    mesh = tiles.make_mesh()
    w = h = 32

    def run(tiled: bool):
        cam = camera_mod.CameraController()
        if tiled:
            state = tiles.shard_state(pipeline.init_state(w, h), mesh)
            scene_r = tiles.replicate(scene, mesh)
            render = tiles.make_render_frame_tiled(mesh, w, h)
        else:
            state = pipeline.init_state(w, h)
        frame_count = 0
        for i in range(4):
            if i == 2:          # move: resets accumulation (state.rs:151)
                cam.press("w")
                cam.update(0.05)
                cam.release("w")
                frame_count = 0
            uniform = renderer.camera_to_device(
                cam.uniform(1.0, frame_count, scene.num_lights))
            if tiled:
                uniform = tiles.replicate(uniform, mesh)
                ldr, _hdr, state, aux = render(scene_r, uniform,
                                               jnp.uint32(frame_count), state)
            else:
                ldr, _, state, aux = pipeline.render_frame(
                    scene, uniform, jnp.uint32(frame_count), state, w, h)
            frame_count += 1
        return np.asarray(ldr)

    tiled = run(True)
    single = run(False)
    assert np.isnan(tiled).sum() == 0
    assert np.abs(tiled - single).max() < 1e-5


def test_short_band_halo_clamp_warns():
    """band_h < halo silently dropped spatial taps in r2 (VERDICT r2 weak
    #8); the clamp must now WARN so a many-device/short-image run is
    diagnosable."""
    import warnings as _warnings

    mesh = tiles.make_mesh()
    n = mesh.devices.size
    h = 8 * n                       # band_h = 8 < DEFAULT_HALO = 16
    with _warnings.catch_warnings(record=True) as rec:
        _warnings.simplefilter("always")
        tiles.make_render_frame_tiled(mesh, 32, h)
    assert any("halo" in str(w.message) for w in rec), (
        [str(w.message) for w in rec])


def test_read_cols_x2_matches_two_reads():
    """BandView.read_cols_x2 (one slice-2 gather for the bilinear
    x-pair) must agree with two independent read_cols calls on every
    texel it reports valid - including gx = -1, gx = width-1, and rows
    outside coverage."""
    from tpu_raytracer.parallel import views as views_mod

    rng = np.random.default_rng(7)
    w, hgt = 13, 9
    data = jnp.asarray(rng.standard_normal((hgt * w, 3)).astype(np.float32))
    view = views_mod.trivial_view(data, w, hgt)

    gy = jnp.asarray(np.concatenate([
        rng.integers(-2, hgt + 2, 200), [0, hgt - 1, hgt - 1, 0]]
    ).astype(np.int32))
    gx = jnp.asarray(np.concatenate([
        rng.integers(-2, w + 2, 200), [-1, w - 1, 0, w - 2]]
    ).astype(np.int32))

    c0, c1, v0, v1 = view.read_cols_x2(gy, gx)
    r0, rv0 = view.read_cols(gy, gx)
    r1, rv1 = view.read_cols(gy, gx + 1)

    np.testing.assert_array_equal(np.asarray(v0), np.asarray(rv0))
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(rv1))
    for k in range(3):
        a, b = np.asarray(c0[k]), np.asarray(r0[k])
        np.testing.assert_array_equal(a[np.asarray(v0)], b[np.asarray(v0)])
        a, b = np.asarray(c1[k]), np.asarray(r1[k])
        np.testing.assert_array_equal(a[np.asarray(v1)], b[np.asarray(v1)])


def test_gather_t_mode_bit_identical(trace_env):
    """TPU_RT_GATHER_T=1 (column-major gather output instead of gather +
    explicit transpose) must be bit-identical for both view classes."""
    from tpu_raytracer.parallel import views as views_mod

    rng = np.random.default_rng(9)
    w, hgt = 11, 7
    a = jnp.asarray(rng.standard_normal((hgt * w, 5)).astype(np.float32))
    b = jnp.asarray(rng.standard_normal((hgt * w, 3)).astype(np.float32))
    gy = jnp.asarray(rng.integers(-2, hgt + 2, 150).astype(np.int32))
    gx = jnp.asarray(rng.integers(-2, w + 2, 150).astype(np.int32))

    view = views_mod.trivial_view(a, w, hgt)
    pview = views_mod.trivial_pair_view(a, b, w, hgt)
    ref, rv = view.read_cols(gy, gx)
    pref, prv = pview.read_cols(gy, gx)

    trace_env.setenv("TPU_RT_GATHER_T", "1")
    got, gv = view.read_cols(gy, gx)
    pgot, pgv = pview.read_cols(gy, gx)
    np.testing.assert_array_equal(np.asarray(rv), np.asarray(gv))
    for k in range(5):
        np.testing.assert_array_equal(np.asarray(ref[k]), np.asarray(got[k]))
    for k in range(8):
        np.testing.assert_array_equal(np.asarray(pref[k]),
                                      np.asarray(pgot[k]))


def test_denoised_screenshot_on_sharded_state():
    """Multi-device screenshot path: denoised_screenshot consumes the
    band-SHARDED state["gb"] plus the replicated hdr exactly as the app
    does under --tiles (app/interactive.py K-key / auto-shot). GSPMD must
    produce the same image as the one-device pipeline's screenshot."""
    from tpu_raytracer.app.screenshot import denoised_screenshot

    scene = scenes.create_cornell_box()
    mesh = tiles.make_mesh()
    w = h = 32

    cam = camera_mod.CameraController()
    state = tiles.shard_state(pipeline.init_state(w, h), mesh)
    scene_r = tiles.replicate(scene, mesh)
    render = tiles.make_render_frame_tiled(mesh, w, h)
    uniform = tiles.replicate(
        renderer.camera_to_device(cam.uniform(1.0, 0, scene.num_lights)),
        mesh)
    ldr, hdr, state, _ = render(scene_r, uniform, jnp.uint32(0), state)
    den_tiled = np.asarray(denoised_screenshot(state["gb"], hdr, w, h))

    cam1 = camera_mod.CameraController()
    state1 = pipeline.init_state(w, h)
    uniform1 = renderer.camera_to_device(
        cam1.uniform(1.0, 0, scene.num_lights))
    ldr1, hdr1, state1, _ = pipeline.render_frame(
        scene, uniform1, jnp.uint32(0), state1, w, h)
    den_single = np.asarray(denoised_screenshot(state1["gb"], hdr1, w, h))

    assert np.isnan(den_tiled).sum() == 0
    assert np.abs(den_tiled - den_single).max() < 1e-5
