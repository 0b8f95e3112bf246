"""Interactive render loop: the reference app's event loop, headless.

Replicates main.rs / state.rs behavior headlessly (terminal keys instead of
winit):
  - continuous rendering with per-frame dt (main.rs:97 poll mode),
  - WASD move / arrow rotate / Space up / Z down (camera.rs:58-111; Z
    stands in for LShift - terminals can't see modifier state),
  - J toggles pause (state.rs:133-135), K queues an async screenshot
    (state.rs:136-138), Q quits, keys 0-4 switch the debug G-buffer
    visualization (renderer.rs:407-508),
  - camera motion resets the accumulation counter (state.rs:151-152),
  - fps / resolution / accumulated-sample telemetry, printed where the
    reference updates the window title (main.rs:81-95),
  - auto-screenshot when the accumulation counter reaches target_spp
    (state.rs:206-215), via the async saver thread,
  - checkpoint save on exit and resume on start (--checkpoint).
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from ..models import scenes as scene_catalog
from ..ops import gbuffer as gbuffer_ops
from ..render import camera as camera_mod
from ..render import checkpoint, pipeline, renderer
from ..utils import math3d
from ..utils.config import RenderConfig
from .screenshot import ScreenshotSaver, denoised_screenshot


def load_scene(name: str):
    catalog = {
        "cornell": scene_catalog.create_cornell_box,
        "cornell_diffuse": scene_catalog.create_cornell_box_diffuse,
        "restir": scene_catalog.create_restir_scene,
        "bunny": scene_catalog.create_bunny_scene,
        "avocado": scene_catalog.create_avocado_scene,
        "helmet": scene_catalog.create_damaged_helmet_scene,
        "vrm": scene_catalog.create_multi_material_model_scene,
        "truffle": scene_catalog.create_chocolate_truffle_scene,
        "knot": scene_catalog.create_dense_knot_scene,
        "gallery": scene_catalog.create_instancing_gallery_scene,
    }
    if name in catalog:
        return catalog[name]()
    if name.endswith((".gltf", ".glb")):
        return scene_catalog.create_gltf_scene(name)
    raise ValueError(f"unknown scene '{name}'")


def debug_view(gb, hdr, mode: int, width: int, height: int):
    """G-buffer visualization modes (renderer.rs:407-508).

    1: position (float, through tonemap like the reference's post copy),
    2: normal-texture contents (oct.x, oct.y, uv.x), 3: albedo (direct),
    4: motion. Returns [n,3] display-ready values.
    """
    from ..ops.post import resolve_tonemap

    if mode == 1:
        v = resolve_tonemap(jnp.abs(gb["pos"]))
    elif mode == 2:
        v = resolve_tonemap(jnp.abs(jnp.concatenate(
            [gb["oct_normal"], gb["uv"][:, :1]], axis=-1)))
    elif mode == 4:
        m = jnp.abs(gb["motion"]) * 10.0
        v = resolve_tonemap(jnp.concatenate(
            [m, jnp.zeros((m.shape[0], 1))], axis=-1))
    else:  # 3: albedo, skips post entirely (renderer.rs:486-508)
        return gb["albedo"]
    return v


class _RawTerminal:
    """Non-blocking single-key reads; no-op when stdin isn't a tty."""

    def __init__(self):
        self.enabled = sys.stdin.isatty()
        self._saved = None

    def __enter__(self):
        if self.enabled:
            import termios
            import tty

            self._saved = termios.tcgetattr(sys.stdin)
            tty.setcbreak(sys.stdin.fileno())
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            import termios

            termios.tcsetattr(sys.stdin, termios.TCSADRAIN, self._saved)

    def poll_keys(self) -> list:
        keys = []
        if not self.enabled:
            return keys
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == "\x1b":  # arrow escape sequences
                seq = sys.stdin.read(2) if select.select(
                    [sys.stdin], [], [], 0)[0] else ""
                keys.append({"[A": "up", "[B": "down", "[C": "right",
                             "[D": "left"}.get(seq, "esc"))
            else:
                keys.append(ch.lower())
        return keys


def run(cfg: RenderConfig) -> dict:
    """Run the interactive loop; returns final telemetry."""
    w, h = cfg.width, cfg.height
    scene = load_scene(cfg.scene)
    cam = camera_mod.CameraController()
    state = pipeline.init_state(w, h)
    frame_count = 0

    # --tiles N: row-band device-mesh pipeline (parallel/tiles.py); the
    # tiled render has the same call shape as pipeline.render_frame.
    if cfg.tiles > 1:
        from ..parallel import tiles

        devs = jax.devices()
        if len(devs) < cfg.tiles:
            raise ValueError(f"--tiles {cfg.tiles} needs {cfg.tiles} "
                             f"devices, have {len(devs)}")
        mesh = tiles.make_mesh(devs[:cfg.tiles])
        render_fn = tiles.make_render_frame_tiled(mesh, w, h, cfg.halo)
        scene = tiles.replicate(scene, mesh)
        state = tiles.shard_state(state, mesh)
    else:
        render_fn = pipeline.frame_renderer(w, h)

    if cfg.checkpoint and os.path.exists(cfg.checkpoint):
        st, frame_count, cam_state = checkpoint.load(cfg.checkpoint)
        state = {k: jnp.asarray(v) for k, v in st.items()}
        cam.position = cam_state["position"]
        cam.yaw, cam.pitch = cam_state["yaw"], cam_state["pitch"]
        cam.prev_view_proj = cam_state["prev_view_proj"]
        print(f"resumed from {cfg.checkpoint} at frame {frame_count}")

    saver = ScreenshotSaver(cfg.out_dir)
    presenter = None
    if cfg.preview and sys.stdout.isatty():
        from .preview import TerminalPresenter

        presenter = TerminalPresenter(cols=cfg.preview_cols)
    paused = False
    debug_mode = cfg.debug_mode
    screenshot_requested = False
    auto_shot_done = False
    total_frames = 0
    fps_window_t0, fps_window_n = time.time(), 0
    fps = 0.0
    last_t = time.time()
    telemetry = {}
    status_line = ""
    last_present = 0.0

    # movement keys are momentary in a real app; in cbreak mode we apply
    # each keypress as a fixed-duration press
    key_impulse = 1.0 / 30.0

    with _RawTerminal() as term:
        while cfg.max_frames == 0 or total_frames < cfg.max_frames:
            now = time.time()
            dt = now - last_t
            last_t = now

            pressed = term.poll_keys()
            for k in pressed:
                if k == "q":
                    cfg.max_frames = total_frames  # exit
                elif k == "j":
                    paused = not paused            # state.rs:133-135
                elif k == "k":
                    screenshot_requested = True    # state.rs:136-138
                elif k in "01234":
                    debug_mode = int(k)
                elif k in ("w", "a", "s", "d", "left", "right", "up", "down",
                           " ", "z"):
                    key = {" ": "space", "z": "shift"}.get(k, k)
                    cam.press(key)

            if paused and not screenshot_requested:
                # state.rs:147-149: skip everything while paused
                time.sleep(0.01)
                for k in list(cam.keys):
                    cam.release(k)
                continue

            moved = cam.update(dt if cam.keys else 0.0)
            for k in list(cam.keys):
                cam.release(k)
            if moved:
                frame_count = 0                    # state.rs:151-152
                auto_shot_done = False

            uniform = renderer.camera_to_device(
                cam.uniform(w / h, frame_count, scene.num_lights))
            # dedup eligibility: same camera as last frame, scene untouched
            ldr, hdr, state, aux = render_fn(
                scene, uniform, jnp.uint32(frame_count), state,
                static_ok=frame_count > 0)

            if debug_mode != 0:
                gb = gbuffer_ops.unpack_gb(state["gb"])
                ldr = debug_view(gb, hdr, debug_mode, w, h)

            frame_count += 1
            total_frames += 1
            fps_window_n += 1

            # live display (blit/present analogue), throttled to spare the
            # host<->device link at high frame rates
            if presenter is not None and now - last_present >= 0.25:
                img = np.asarray(jnp.clip(ldr, 0.0, 1.0)).reshape(h, w, 3)
                presenter.present(img, status_line)
                last_present = now

            hit_target = (cfg.target_spp > 0 and frame_count >= cfg.target_spp
                          and not auto_shot_done)
            if screenshot_requested or hit_target:
                if cfg.denoise:
                    img = denoised_screenshot(state["gb"], hdr, w, h,
                                              cfg.denoise_iterations)
                else:
                    img = jnp.clip(ldr.reshape(h, w, 3), 0.0, 1.0) ** 2.2
                saver.submit(np.asarray(img))
                screenshot_requested = False
                if hit_target:
                    auto_shot_done = True

            if now - fps_window_t0 >= 1.0:        # main.rs:81-95 telemetry
                fps = fps_window_n / (now - fps_window_t0)
                fps_window_t0, fps_window_n = now, 0
                telemetry = {"fps": fps, "res": f"{w}x{h}",
                             "samples": frame_count,
                             "mrays_per_s": float(aux["rays"]) * fps / 1e6}
                line = (f"FPS {fps:6.2f} | {w}x{h} | samples {frame_count}"
                        f" | {telemetry['mrays_per_s']:.1f} Mrays/s"
                        f" | mode {debug_mode}{' | PAUSED' if paused else ''}")
                status_line = line
                if presenter is None:
                    print(line, flush=True)

    if cfg.checkpoint:
        checkpoint.save(cfg.checkpoint, jax.device_get(state), frame_count,
                        {"position": cam.position, "yaw": cam.yaw,
                         "pitch": cam.pitch,
                         "prev_view_proj": cam.prev_view_proj})
        print(f"checkpointed to {cfg.checkpoint}")
    saver.flush()
    if total_frames:
        # one sync at exit: the last frame's health for callers (smoke)
        img = np.asarray(ldr)
        telemetry.update(frames=total_frames,
                         ldr_finite=bool(np.isfinite(img).all()),
                         ldr_mean=float(img.mean()))
    return telemetry


def letterbox(img: np.ndarray, out_w: int, out_h: int,
              clear=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Aspect-correct letterboxed blit (blit.wgsl + renderer.rs:381-397;
    blue clear color from blit.rs:119)."""
    h, w = img.shape[:2]
    scale = min(out_w / w, out_h / h)
    nw, nh = int(w * scale), int(h * scale)
    # nearest-texel resize (the blit samples one texel per pixel)
    ys = np.minimum((np.arange(nh) + 0.5) * h / nh, h - 1).astype(int)
    xs = np.minimum((np.arange(nw) + 0.5) * w / nw, w - 1).astype(int)
    resized = (np.clip(img, 0, 1)[ys][:, xs] * 255).astype(np.uint8)
    out = np.zeros((out_h, out_w, 3), np.uint8)
    out[:] = (np.asarray(clear) * 255).astype(np.uint8)
    y0 = (out_h - nh) // 2
    x0 = (out_w - nw) // 2
    out[y0:y0 + nh, x0:x0 + nw] = resized[:, :, :3]
    return out
