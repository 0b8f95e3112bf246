"""Smoke test of the ray tracer on a GPU, in one process.

    python chip_smoke.py             # the phases below, on one card
    python chip_smoke.py --cards 4   # only the row-band mesh over 4 cards

Phases (one card): devices, intersect, gather, golden, app, bench. Each
prints one line; a failed phase prints its error and the script goes on
to the next, then exits 1. On success the last line is exactly
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
With no GPU the devices phase fails and nothing else runs.
"""

import argparse
import json
import os
import sys
import time
import traceback

# the CPU backend holds the plain intersection reference beside the GPU
_plat = os.environ.get("JAX_PLATFORMS", "")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

N_RAYS = 262_144          # camera rays, and as many bounce rays
N_REF = 16_384            # rays checked against the CPU reference
ID_AGREE = 0.9999         # share of rays whose triangle id must agree
# t tolerance, relative to max(t, 1): t is a difference of products of
# scene-scale terms (|o - v0| ~ 1 unit here), so two correct roundings
# differ by ~1e-7 of the scene scale - a bounce ray's t of 1e-3 carries
# errors of ~1e-4 of itself.
T_REL = 1e-5
# The golden was rendered on the CPU; tests/test_golden.py holds the CPU
# to 45 dB. On the GPU two of the 4096 primary rays take the other side
# of a triangle edge (FMA-contracted arithmetic), and ReSTIR reuse spreads
# that to ~1% of pixels by frame 8: 43.68 dB on an H100 with the mean
# radiance equal to 2e-4. The bar leaves ~3.7 dB of that margin.
GOLDEN_DB = 40.0


def log(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def phase_devices(n_cards):
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"no GPU: JAX backend is {jax.default_backend()!r}")
    if len(jax.devices()) < n_cards:
        raise RuntimeError(f"need {n_cards} GPUs, JAX sees "
                           f"{len(jax.devices())}")
    import bench

    card = bench.card_info()
    print(f"card: {card}", flush=True)
    d = jax.devices()[0]
    log("devices", platform=d.platform, kind=d.device_kind,
        count=len(jax.devices()), card=card,
        cache_dir=jax.config.jax_compilation_cache_dir)


def _rays(scene, seed=0):
    """N_RAYS camera rays at 512x512 plus N_RAYS bounce rays that leave
    the camera rays' hit points in uniformly random directions."""
    from tpu_raytracer.ops import gbuffer, trace_api
    from tpu_raytracer.render import camera as camera_mod
    from tpu_raytracer.render import renderer

    cam = camera_mod.CameraController()
    u = renderer.camera_to_device(cam.uniform(1.0, 0, scene.num_lights))
    o, d = gbuffer.generate_primary_rays(u, 512, 512)
    hit = trace_api.scene_trace(scene, o, d, 1e-3, 1e3)
    t = jnp.where(hit["tri"] >= 0, hit["t"], 1.0)
    ob = o + d * (t - 1e-3)[:, None]
    db = jax.random.normal(jax.random.PRNGKey(seed), d.shape)
    db = db / jnp.linalg.norm(db, axis=1, keepdims=True)
    return jnp.concatenate([o, ob]), jnp.concatenate([d, db])


def _compare(name, got, want):
    """Closest-hit agreement under the smoke's tolerance; returns counts."""
    gt, gi = np.asarray(got["t"]), np.asarray(got["tri"])
    wt, wi = np.asarray(want["t"]), np.asarray(want["tri"])
    same = gi == wi
    both = same & (wi >= 0)
    rel = np.abs(gt - wt) / np.maximum(np.abs(wt), 1.0)
    t_bad = int((rel[both] > T_REL).sum())
    diff = ~same
    both_hit = diff & (gi >= 0) & (wi >= 0)
    ties = int((rel[both_hit] <= T_REL).sum())
    flips = int((diff & ~both_hit).sum())
    counts = {"rays": int(gi.size), "id_agree": float(same.mean()),
              "id_differ": int(diff.sum()), "ties": ties,
              "hit_miss_flips": flips, "t_outside_tol": t_bad,
              "max_rel_t": float(rel[both].max(initial=0.0))}
    ok = (same.mean() >= ID_AGREE and t_bad == 0
          and ties == int(both_hit.sum()))
    if not ok:
        raise AssertionError(f"{name}: {counts}")
    return counts


def phase_intersect():
    from tpu_raytracer.models import scenes
    from tpu_raytracer.ops import sweep_kernel, trace_api

    cpu = jax.devices("cpu")[0]
    # runs where its (committed) inputs live: the CPU or the card
    sweep_xla = jax.jit(trace_api._trace_brute_xla)
    out = {}
    for name, make in (("cornell", scenes.create_cornell_box),
                       ("bunny", scenes.create_bunny_scene)):
        scene = make()
        o, d = _rays(scene)
        sub = np.random.default_rng(1).choice(o.shape[0], N_REF,
                                              replace=False)
        o_c, d_c = (jax.device_put(np.asarray(x)[sub], cpu) for x in (o, d))
        planes_c = jax.device_put(np.asarray(scene.tri_planes), cpu)
        ref = sweep_xla(planes_c, o_c, d_c, 1e-3, 1e30)
        t0 = time.perf_counter()
        got = jax.block_until_ready(
            trace_api.scene_trace(scene, o, d, 1e-3, 1e30))
        any_hit = trace_api.scene_occluded(scene, o, d, 1e-3, 1e30)
        sec = time.perf_counter() - t0
        got_sub = {k: np.asarray(v)[sub] for k, v in got.items()}
        row = {"tris": scene.num_triangles,
               "padded": int(scene.tri_planes.shape[2]),
               "closest_vs_cpu": _compare(f"{name} closest", got_sub, ref)}
        occ = np.asarray(any_hit)[sub]
        occ_agree = float((occ == (np.asarray(ref["tri"]) >= 0)).mean())
        if occ_agree < ID_AGREE:
            raise AssertionError(f"{name} any-hit agreement {occ_agree}")
        row["any_hit_agree_vs_cpu"] = occ_agree
        # the sweep kernel against the plain XLA sweep, both on the card,
        # over all rays
        kc = sweep_kernel.trace_sweep(scene.tri_planes, o, d, 1e-3, 1e30)
        xc = sweep_xla(scene.tri_planes, o, d, 1e-3, 1e30)
        row["kernel_vs_xla_on_card"] = _compare(f"{name} kernel vs xla",
                                                kc, xc)
        ka = sweep_kernel.trace_sweep(scene.tri_planes, o, d, 1e-3, 1e30,
                                      any_hit=True)
        row["kernel_any_agree_vs_xla"] = float(
            ((np.asarray(ka["tri"]) >= 0)
             == (np.asarray(xc["tri"]) >= 0)).mean())
        if row["kernel_any_agree_vs_xla"] != 1.0:
            raise AssertionError(f"{name} kernel any-hit flags differ")
        row["first_calls_s"] = sec
        out[name] = row
    log("intersect", **out)


def phase_gather():
    from tpu_raytracer.ops.hit import fetch_cols

    rng = np.random.default_rng(2)
    table = jnp.asarray(rng.standard_normal((1408, 35)).astype(np.float32)
                        * 1e3)
    idx = jnp.asarray(rng.integers(0, 1408, N_RAYS).astype(np.int32))
    got = np.stack([np.asarray(c) for c in jax.jit(fetch_cols)(table, idx)],
                   axis=1)
    want = np.asarray(table)[np.asarray(idx)]
    n_bad = int((got != want).sum())
    if n_bad:
        raise AssertionError(f"fetch_cols differs from table[idx] in "
                             f"{n_bad} values (TF32?)")
    log("gather", rows=int(idx.size), cols=35, exact=True)


def phase_golden():
    from tpu_raytracer.models import scenes
    from tpu_raytracer.render import camera as camera_mod
    from tpu_raytracer.render import pipeline, renderer
    from tpu_raytracer.utils.image import psnr

    w = h = 64
    scene = scenes.create_cornell_box()
    cam = camera_mod.CameraController()
    state = pipeline.init_state(w, h)
    for frame in range(8):
        uniform = renderer.camera_to_device(
            cam.uniform(1.0, frame, scene.num_lights))
        ldr, hdr, state, aux = pipeline.render_frame(
            scene, uniform, jnp.uint32(frame), state, w, h)
    want = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests", "golden", "cornell_64_f8_ldr.npy"))
    p = float(psnr(np.asarray(ldr, np.float32), want.astype(np.float32)))
    log("golden", psnr_db=p, bar_db=GOLDEN_DB)
    if not p > GOLDEN_DB:
        raise AssertionError(f"golden PSNR {p:.2f} dB <= {GOLDEN_DB} dB")


def phase_app():
    from tpu_raytracer.app import interactive
    from tpu_raytracer.utils.config import parse_args

    t0 = time.perf_counter()
    tel = interactive.run(parse_args(
        ["--scale=1280x720", "--scene", "cornell", "--max-frames", "12",
         "--no-preview"]))
    log("app", seconds=time.perf_counter() - t0, **tel)
    if tel.get("frames") != 12 or not tel["ldr_finite"] \
            or not tel["ldr_mean"] > 0.0:
        raise AssertionError(f"app frames bad: {tel}")


def phase_bench():
    import bench

    r = bench.headline()
    log("bench", card=bench.card_info(), **r)


def run_cards4(w=1280, h=720):
    """The row-band mesh over 4 cards at 1280x720 vs the single-card
    pipeline: a static frame, then a moving-camera frame."""
    from tpu_raytracer.models import scenes
    from tpu_raytracer.parallel import tiles
    from tpu_raytracer.render import camera as camera_mod
    from tpu_raytracer.render import pipeline, renderer

    scene = scenes.create_cornell_box()
    mesh = tiles.make_mesh(jax.devices()[:4])
    render = tiles.make_render_frame_tiled(mesh, w, h)
    scene_r = tiles.replicate(scene, mesh)
    state_t = tiles.shard_state(pipeline.init_state(w, h), mesh)
    state_1 = pipeline.init_state(w, h)
    cam = camera_mod.CameraController()
    rows = []
    for step, moving in enumerate((False, True)):
        if moving:
            cam.press("w")
            cam.update(0.08)
            cam.release("w")
        u = renderer.camera_to_device(cam.uniform(w / h, 0,
                                                  scene.num_lights))
        times = []
        for _ in range(2):       # compile, then one timed frame each
            st_t = jax.tree_util.tree_map(jnp.copy, state_t)
            st_1 = jax.tree_util.tree_map(jnp.copy, state_1)
            t0 = time.perf_counter()
            ldr_t, _, new_t, aux = jax.block_until_ready(render(
                scene_r, tiles.replicate(u, mesh), jnp.uint32(0), st_t))
            t1 = time.perf_counter()
            ldr_1, _, new_1, _ = jax.block_until_ready(pipeline.render_frame(
                scene, u, jnp.uint32(0), st_1, w, h))
            times.append((t1 - t0, time.perf_counter() - t1))
        state_t, state_1 = new_t, new_1
        a, b = np.asarray(ldr_t), np.asarray(ldr_1)
        diff = float(np.abs(a - b).max())
        row = {"frame": "moving" if moving else "static",
               "max_abs_diff": diff, "finite": bool(np.isfinite(a).all()),
               "mean": float(a.mean()), "ms_4cards": times[1][0] * 1e3,
               "ms_1card": times[1][1] * 1e3,
               "rays": float(aux["rays"])}
        rows.append(row)
        if not (diff < 1e-5 and row["finite"] and row["mean"] > 0):
            raise AssertionError(f"4-card frame differs: {row}")
    log("cards4", resolution=f"{w}x{h}", band_rows=h // 4, frames=rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()
    try:
        phase_devices(args.cards)
    except Exception:
        traceback.print_exc()
        return 1
    phases = ([run_cards4] if args.cards == 4 else
              [phase_intersect, phase_gather, phase_golden, phase_app,
               phase_bench])
    failed = []
    for fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failed.append(fn.__name__)
        print(f"# {fn.__name__}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    if failed:
        print(f"FAILED: {failed}", flush=True)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
