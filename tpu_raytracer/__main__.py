"""`python -m tpu_raytracer` - the interactive app entry point (main.rs)."""

import os

from .app import interactive
from .utils.config import parse_args


def main():
    # App-only G-buffer reuse on static frames: bit-identical image. It
    # stays out of the bench, whose headline counts traced rays and would
    # under-report a frame that skips its primary sweep (ROADMAP D4).
    os.environ.setdefault("TPU_RT_GB_REUSE", "1")
    cfg = parse_args()
    interactive.run(cfg)


if __name__ == "__main__":
    main()
