"""Render configuration + CLI flags.

The reference's "config system" is one hand-parsed CLI flag (`--scale=WxH`,
main.rs:107-122), compile-time feature gates, and edit-the-source scene
selection (state.rs:51-58, renderer.rs:410). This replaces all of that with
a real dataclass + argparse surface while keeping `--scale=WxH` working
verbatim.
"""

from __future__ import annotations

import argparse
import dataclasses


@dataclasses.dataclass
class RenderConfig:
    scene: str = "cornell"          # models/scenes.py catalog name or .gltf path
    width: int = 1280               # reference default 1280x720 (main.rs:122)
    height: int = 720
    target_spp: int = 0             # auto-screenshot at N accumulated frames
                                    # (state.rs:206-215 TARGET_SPP; 0 = off)
    denoise: bool = False           # screenshot denoiser (ai-denoise feature)
    denoise_iterations: int = 4
    debug_mode: int = 0             # 0 shaded | 1 pos | 2 normal | 3 albedo
                                    # | 4 motion (renderer.rs:407-508)
    tiles: int = 1                  # device-mesh row bands (1 = one device)
    halo: int = 16
    checkpoint: str = ""            # resume path ("" = fresh)
    out_dir: str = "output"
    max_frames: int = 0             # 0 = run until quit
    preview: bool = True            # live ANSI frame display (blit analogue;
                                    # auto-disabled when stdout isn't a tty)
    preview_cols: int = 100


def parse_args(argv=None) -> RenderConfig:
    cfg = RenderConfig()
    ap = argparse.ArgumentParser(description="tpu_raytracer")
    ap.add_argument("--scale", type=str, default=None,
                    help="WxH render resolution (reference flag)")
    ap.add_argument("--scene", type=str, default=cfg.scene,
                    help="catalog name (cornell, cornell_diffuse, restir, "
                         "bunny, knot, gallery, avocado, helmet, vrm, "
                         "truffle) or a .gltf/.glb path")
    ap.add_argument("--target-spp", type=int, default=cfg.target_spp)
    ap.add_argument("--denoise", action="store_true")
    ap.add_argument("--denoise-iterations", type=int,
                    default=cfg.denoise_iterations)
    ap.add_argument("--debug-mode", type=int, default=cfg.debug_mode)
    ap.add_argument("--tiles", type=int, default=cfg.tiles)
    ap.add_argument("--halo", type=int, default=cfg.halo)
    ap.add_argument("--checkpoint", type=str, default=cfg.checkpoint)
    ap.add_argument("--out-dir", type=str, default=cfg.out_dir)
    ap.add_argument("--max-frames", type=int, default=cfg.max_frames)
    ap.add_argument("--no-preview", dest="preview", action="store_false")
    ap.add_argument("--preview-cols", type=int, default=cfg.preview_cols)
    args = ap.parse_args(argv)

    if args.scale:
        # main.rs:107-122: "--scale=WxH", fall back to default on parse error
        try:
            w, h = args.scale.lower().split("x")
            cfg.width, cfg.height = int(w), int(h)
        except ValueError:
            print(f"invalid --scale '{args.scale}', using "
                  f"{cfg.width}x{cfg.height}")
    for name in ("scene", "target_spp", "denoise", "denoise_iterations",
                 "debug_mode", "tiles", "halo", "checkpoint", "out_dir",
                 "max_frames", "preview", "preview_cols"):
        setattr(cfg, name, getattr(args, name))
    return cfg
