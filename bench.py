"""Benchmarks on the GPU.

Default mode prints ONE JSON headline line: Cornell Box ReSTIR at
512x512, exactly-counted Mrays/s and fps.

`--config N` (1..7) runs the BASELINE.md benchmark configs:
  1 Cornell diffuse-only, fixed camera, 512x512, 1 spp progressive
  2 Cornell ReSTIR accumulated to 1024 spp (measured wall-clock)
  3 dense-mesh scene (bunny-class, 15.4k tris)
  4 interactive fly-through at 1080p with per-frame instance refit and
    accumulation reset
  5 true 3840x2160 render with the a-trous denoiser, plus its PSNR
  6 dense textured mesh (~100k-tri procedural knot .glb through the real
    loader + full texture stack; DamagedHelmet-class workload)
  7 instanced gallery (100 instances of one mesh, 512k world tris)

`--traces` times one trace call per intersector route (sweep kernel,
XLA sweep, BVH walk) on bench scenes; `--tiles N` runs the headline
row-band-sharded over N devices.

Every line names the device (platform, device_kind, count) and the
card's name and power limit as nvidia-smi reports them. With no GPU the
run fails; it never falls back to the CPU.
"""

import argparse
import json
import subprocess
import sys
import time

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp


def card_info() -> str:
    """'<name>, <power limit>' of the first card, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def require_gpu() -> dict:
    """The device block every result line carries; raises without a GPU."""
    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX backend is {jax.default_backend()!r}")
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": card_info()}


def peak_bytes() -> int:
    return int(jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0))


def _measure_restir(scene, width, height, warmup, measured, move=False,
                    refit_transforms=None, refit_changed=None):
    from tpu_raytracer.ops import refit as refit_ops
    from tpu_raytracer.render import camera as camera_mod
    from tpu_raytracer.render import pipeline, renderer

    render = pipeline.frame_renderer(width, height)
    cam = camera_mod.CameraController()
    state = pipeline.init_state(width, height)
    ray_counts = []               # device scalars; converted AFTER the clock
    t_start = time.perf_counter()
    first_s = t0 = None
    frame_count = 0
    for i in range(warmup + measured):
        if move:
            cam.press("d")
            cam.update(1.0 / 60.0)
            cam.release("d")
            frame_count = 0       # accumulation reset on motion
        if refit_transforms is not None:
            scene = refit_ops.update_instances(
                scene, refit_transforms(i, scene), changed=refit_changed)
        # replay-dedup eligibility: world unchanged since the last frame
        static_ok = (i > 0) and not move and refit_transforms is None
        uniform = renderer.camera_to_device(
            cam.uniform(width / height, frame_count, scene.num_lights))
        ldr, hdr, state, aux = render(
            scene, uniform, jnp.uint32(frame_count), state,
            static_ok=static_ok)
        frame_count += 1
        if i == 0:
            jax.block_until_ready(ldr)
            first_s = time.perf_counter() - t_start
        if i == warmup - 1:
            jax.block_until_ready(ldr)
            t0 = time.perf_counter()
        elif i >= warmup:
            # the exact per-frame ray counter stays a device scalar: a
            # float() here would sync every frame and stop frames from
            # pipelining
            ray_counts.append(aux["rays"])
    jax.block_until_ready((ldr, state))
    dt = time.perf_counter() - t0
    img = np.asarray(ldr)
    if not np.isfinite(img).all() or img.mean() <= 0.0:
        raise RuntimeError(f"bad frame: finite={np.isfinite(img).all()} "
                           f"mean={img.mean()}")
    total_rays = sum(float(x) for x in ray_counts)
    ms = dt / measured * 1e3
    return {"fps": measured / dt, "mrays_per_s": total_rays / dt / 1e6,
            "ms_per_frame": ms,
            # first frame = compile + one run (warm or cold cache)
            "compile_s": first_s - ms / 1e3,
            "peak_bytes_in_use": peak_bytes()}


def headline():
    from tpu_raytracer.models import scenes

    r = _measure_restir(scenes.create_cornell_box(), 512, 512, 2, 8)
    return {"metric": "cornell_restir_512x512_mrays_per_s",
            "value": r["mrays_per_s"], "unit": "Mrays/s", "detail": r}


def headline_tiled(n_tiles: int):
    """The Cornell ReSTIR frame row-band-sharded over the first N
    devices (parallel/tiles.py)."""
    from tpu_raytracer.models import scenes
    from tpu_raytracer.parallel import tiles
    from tpu_raytracer.render import camera as camera_mod
    from tpu_raytracer.render import pipeline, renderer

    devs = jax.devices()
    if len(devs) < n_tiles:
        raise SystemExit(f"--tiles {n_tiles} needs {n_tiles} devices, "
                         f"have {len(devs)}")
    mesh = tiles.make_mesh(devs[:n_tiles])
    w = h = 512
    scene = tiles.replicate(scenes.create_cornell_box(), mesh)
    cam = camera_mod.CameraController()
    state = tiles.shard_state(pipeline.init_state(w, h), mesh)
    render = tiles.make_render_frame_tiled(mesh, w, h)
    warmup, measured = 2, 8
    rays, t0 = [], None
    for i in range(warmup + measured):
        uniform = tiles.replicate(renderer.camera_to_device(
            cam.uniform(1.0, i, scene.num_lights)), mesh)
        ldr, hdr, state, aux = render(scene, uniform, jnp.uint32(i), state,
                                      static_ok=i > 0)
        if i == warmup - 1:
            jax.block_until_ready(ldr)
            t0 = time.perf_counter()
        elif i >= warmup:
            rays.append(aux["rays"])
    jax.block_until_ready(ldr)
    dt = time.perf_counter() - t0
    return {"metric": f"cornell_restir_512x512_mrays_per_s_{n_tiles}tiles",
            "value": sum(float(x) for x in rays) / dt / 1e6,
            "unit": "Mrays/s",
            "detail": {"fps": measured / dt, "tiles": n_tiles}}


def _config5():
    from tpu_raytracer.app.screenshot import denoised_screenshot
    from tpu_raytracer.models import scenes
    from tpu_raytracer.ops.post import resolve_tonemap
    from tpu_raytracer.render import camera as camera_mod
    from tpu_raytracer.render import pipeline, renderer
    from tpu_raytracer.utils.image import psnr

    scene = scenes.create_cornell_box()
    w, h = 3840, 2160
    render = pipeline.frame_renderer(w, h)
    cam = camera_mod.CameraController()
    state = pipeline.init_state(w, h)

    def frame(f, state, static_ok):
        uniform = renderer.camera_to_device(
            cam.uniform(w / h, f, scene.num_lights))
        return render(scene, uniform, jnp.uint32(f), state,
                      static_ok=static_ok)

    t_start = time.perf_counter()
    ldr, hdr, state, aux = frame(0, state, False)
    jax.block_until_ready(ldr)
    first_s = time.perf_counter() - t_start
    # warm the static_ok frame + the denoiser so the timed frame measures
    # steady-state work, not compiles
    ldr, hdr, state, aux = frame(1, state, True)
    jax.block_until_ready(denoised_screenshot(state["gb"], hdr, w, h))
    t0 = time.perf_counter()
    ldr, hdr, state, aux = frame(2, state, True)
    den_img = jax.block_until_ready(
        denoised_screenshot(state["gb"], hdr, w, h))
    dt = time.perf_counter() - t0
    den = np.asarray(resolve_tonemap(den_img))
    # quality: PSNR of the 3-spp denoised image vs a 32-frame progressive
    # accumulation of the same scene, both tonemapped
    for f in range(3, 32):
        ldr, hdr, state, _ = frame(f, state, True)
    ref = np.asarray(resolve_tonemap(state["accum"].reshape(h, w, 3)))
    return {"config": 5, "resolution": f"{w}x{h}",
            "bands": pipeline.auto_bands(w, h),
            "s_per_denoised_frame": dt,
            "denoised_psnr_vs_32spp": float(psnr(den, ref)),
            "first_frame_s": first_s, "peak_bytes_in_use": peak_bytes()}


def config(n: int):
    from tpu_raytracer.models import scenes

    if n == 1:
        from tpu_raytracer.render import camera as camera_mod
        from tpu_raytracer.render import renderer

        scene = scenes.create_cornell_box_diffuse()
        w = h = 512
        cam = camera_mod.CameraController()
        accum = renderer.make_accum(w, h)
        frames = 34
        for f in range(frames):
            uniform = renderer.camera_to_device(
                cam.uniform(1.0, f, scene.num_lights))
            accum, rad = renderer.render_progressive(
                scene, uniform, jnp.uint32(f), accum, w, h)
            if f == 1:
                jax.block_until_ready(accum)
                t0 = time.perf_counter()
        jax.block_until_ready(accum)
        dt = time.perf_counter() - t0
        return {"config": 1, "fps_1spp_progressive": (frames - 2) / dt,
                "resolution": "512x512", "peak_bytes_in_use": peak_bytes()}
    if n == 2:
        r = _measure_restir(scenes.create_cornell_box(), 512, 512, 2, 1024)
        return {"config": 2, "measured_s_to_1024spp": 1024 / r["fps"], **r}
    if n == 3:
        scene = scenes.create_bunny_scene()
        r = _measure_restir(scene, 512, 512, 2, 8)
        return {"config": 3, "tris": scene.num_triangles, **r}
    if n == 4:
        from tpu_raytracer.utils.math3d import rotation_y, scale, translation

        scene = scenes.create_cornell_box()
        base = np.asarray(scene.inst_transform)

        def wobble(i, s):
            tf = base.copy()
            crystal = (translation([0.4, -0.5 + 0.02 * (i % 8), 0.3])
                       @ rotation_y(0.1 * i) @ scale(0.5))
            tf[6] = crystal[:3, :4]
            return jnp.asarray(tf)

        # only the crystal (instance 6) moves - the refit is restricted
        # to its triangle range (TLAS-update economics, builder.rs:454)
        r = _measure_restir(scene, 1920, 1080, 2, 6, move=True,
                            refit_transforms=wobble, refit_changed=(6,))
        return {"config": 4, "resolution": "1920x1080", **r}
    if n == 5:
        return _config5()
    if n == 6:
        # ~100k-tri procedural knot .glb -> glTF loader -> full texture
        # stack; role-equivalent to the reference's DamagedHelmet runs
        # (src/scene/scenes.rs:334-347)
        scene = scenes.create_dense_knot_scene()
        r = _measure_restir(scene, 512, 512, 2, 4)
        return {"config": 6, "tris": scene.num_triangles, **r}
    if n == 7:
        # shared-BLAS two-level instancing: 100 instances of one mesh,
        # one object-space block + per-instance inverse affines
        # (src/scene/builder.rs:181-189 economics)
        scene = scenes.create_instancing_gallery_scene()
        r = _measure_restir(scene, 512, 512, 2, 4)
        return {"config": 7, "tris": scene.num_triangles,
                "instanced": bool(scene.instanced), **r}
    raise SystemExit(f"unknown config {n}")


def _time_call(fn, reps=5):
    jax.block_until_ready(fn())               # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def _bench_rays(scene, n, seed=0):
    """n rays: half camera-like (from the front, toward the scene), half
    random bounces from points inside the scene bounds."""
    rng = np.random.default_rng(seed)
    v = np.asarray(scene.tri_planes[0]).T[:scene.num_triangles]
    lo, hi = v.min(0), v.max(0)
    h = n // 2
    o_cam = np.tile(((lo + hi) / 2 + [0, 0, 2.5 * (hi - lo).max()]),
                    (h, 1)).astype(np.float32)
    tgt = rng.uniform(lo, hi, (h, 3))
    o_b = rng.uniform(lo, hi, (n - h, 3))
    d = np.concatenate([tgt - o_cam, rng.normal(size=(n - h, 3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (jnp.asarray(np.concatenate([o_cam, o_b]), jnp.float32),
            jnp.asarray(d, jnp.float32))


def traces(sizes=("cornell", "bunny", "knot", "gallery_flat"),
           rays=(262_144, 524_288)):
    """Per-call ms of every route on bench scenes. The sweep kernel and
    the XLA sweep exist for every flattened scene; the BVH walk too."""
    from tpu_raytracer.models import scenes
    from tpu_raytracer.ops import sweep_kernel, trace_api, traversal

    makers = {"cornell": scenes.create_cornell_box,
              "bunny": scenes.create_bunny_scene,
              "knot": scenes.create_dense_knot_scene,
              "gallery_flat": lambda: scenes.create_instancing_gallery_scene(
                  instancing="off")}
    out = []
    for name in sizes:
        s = makers[name]()
        for n in rays:
            o, d = _bench_rays(s, n)
            row = {"scene": name, "tris": s.num_triangles, "rays": n}
            routes = {
                "kernel": lambda: sweep_kernel.trace_sweep(
                    s.tri_planes, o, d, 1e-3, 1e30)["t"],
                "kernel_any": lambda: sweep_kernel.trace_sweep(
                    s.tri_planes, o, d, 1e-3, 1e30, any_hit=True)["tri"],
                "bvh": lambda: traversal.trace(
                    s.bvh_rec, s.bvh_skip, s.bvh_tri, o, d, 1e-3,
                    1e30)["t"],
            }
            if s.num_triangles <= 20_000:
                routes["xla"] = lambda: jax.jit(
                    trace_api._trace_brute_xla)(s.tri_planes, o, d, 1e-3,
                                                1e30)["t"]
            for k, fn in routes.items():
                row[f"{k}_ms"] = _time_call(fn)
            out.append(row)
            print(json.dumps(row), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=0,
                    help="BASELINE config 1-7; default: the headline")
    ap.add_argument("--tiles", type=int, default=0,
                    help="run the headline sharded over N devices")
    ap.add_argument("--traces", action="store_true",
                    help="time one trace call per intersector route")
    args = ap.parse_args()
    device = require_gpu()
    print(f"# {device['card']}", file=sys.stderr)
    if args.traces:
        result = {"traces": traces()}
    elif args.tiles:
        result = headline_tiled(args.tiles)
    elif args.config:
        result = config(args.config)
    else:
        result = headline()
    result["device"] = device
    print(json.dumps(result))
