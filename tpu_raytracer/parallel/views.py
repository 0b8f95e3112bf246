"""Band/halo views: the addressing layer that makes every render op work
identically on one device or on a row-band-sharded device mesh.

The screen is sharded across devices as horizontal row bands (row-major
flat arrays split on the leading axis = contiguous bands). Ops that read
NEIGHBOR pixels (temporal reprojection, spatial ReSTIR, post stencils,
history bilinear taps) read through a `BandView`: a flat array covering
rows [y0 - halo, y0 + band_h + halo) of the full image plus the global
geometry needed to mask out-of-coverage reads.

One device is the trivial view (y0 = 0, halo = 0, band = full height), so
there is exactly ONE implementation of every pass. Out-of-halo reads (e.g.
reprojection farther than the halo under fast motion) are reported invalid
and the caller drops reuse for that lane - the documented halo-clamp
policy (SURVEY.md §2.3 sequence-parallel analogue).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


def _transpose_cols(rows):
    """[R, C] -> list of C dense [R] columns via one tiled transpose."""
    rt = rows.T
    return [rt[k] for k in range(rows.shape[-1])]


def _gather_cols(data, idx):
    """rows data[idx] de-interleaved: list of C dense [R] columns.

    Default: one native row gather + ONE [R, C] -> [C, R] transpose.
    Under TPU_RT_GATHER_T=1 the gather is asked for a COLUMN-MAJOR output
    directly (offset dims placed before the batch dim) - bit-identical;
    which is faster on the GPU is not measured yet (ROADMAP D3)."""
    import os

    c = data.shape[-1]
    if os.environ.get("TPU_RT_GATHER_T", "0") == "1":
        out = jax.lax.gather(
            data, idx[:, None],
            jax.lax.GatherDimensionNumbers(
                offset_dims=(0,), collapsed_slice_dims=(0,),
                start_index_map=(0,)),
            slice_sizes=(1, c))                        # [C, R]
        return [out[k] for k in range(c)]
    return _transpose_cols(data[idx])


def _band_index(view, gy, gx):
    """Shared band addressing: global (gy, gx) -> (flat idx, valid).

    THE one owner of the coverage/clamping arithmetic for every view
    type - a halo-policy change here changes packed-row and column reads
    of both view classes together."""
    local_row = gy - view.y0 + view.halo
    in_cover = (local_row >= 0) & (local_row < view.band_h + 2 * view.halo)
    in_image = (gy >= 0) & (gy < view.height) & (gx >= 0) & (gx < view.width)
    idx = (jnp.clip(local_row, 0, view.band_h + 2 * view.halo - 1)
           * view.width + jnp.clip(gx, 0, view.width - 1))
    return idx, in_cover & in_image


@partial(jax.tree_util.register_dataclass,
         data_fields=["data", "y0"],
         meta_fields=["width", "height", "band_h", "halo"])
@dataclasses.dataclass
class BandView:
    """Flat neighbor-readable view of one image-space array.

    data: [(band_h + 2*halo) * width, ...] flat rows (top halo first).
    y0:   global row index of the band's first (non-halo) row (traced).
    """
    data: jax.Array
    y0: jax.Array
    width: int
    height: int
    band_h: int
    halo: int

    def read(self, gy, gx):
        """Gather at global pixel coords (gy, gx) [R] int32.

        Returns (values, valid): valid is False where the read falls outside
        the view's coverage or outside the image.
        """
        idx, valid = _band_index(self, gy, gx)
        return self.data[idx], valid

    def read_cols(self, gy, gx):
        """`read`, de-interleaved: (list of C dense [R] columns, valid).

        One [R, C] -> [C, R] transpose after the gather, then free
        major-dim slices instead of per-column slices of the row-major
        gather result."""
        idx, valid = _band_index(self, gy, gx)
        return _gather_cols(self.data, idx), valid

    def read_cols_x2(self, gy, gx):
        """Columns of the TWO horizontally-adjacent texels (gy, gx) and
        (gy, gx+1) in ONE visited row per lane.

        Horizontally-adjacent texels are adjacent flat rows; a pair-packed
        copy of the view ([self | x+1] rows, one dense roll + concat)
        turns the x-pair into ONE single-row gather where two `read_cols`
        calls visit two rows. This is the bilinear history read's x-pair
        (post.wgsl:180-228 analogue) with half the visited rows. The
        packing is a dense pre-pass rather than a multi-row slice gather
        (slice_sizes=(2, C)), which XLA may lower as a per-lane loop.

        Returns (cols0, cols1, valid0, valid1). Edge semantics match two
        independent reads exactly: the 2-texel window anchors at
        clip(gx, 0, width-2) and per-texel offsets into the window
        re-select the right column block, so every texel the masks report
        VALID carries the value read() would return (a texel whose own gx
        is outside the image stays masked, as read() reports it).
        """
        if self.width < 2:
            c0, v0 = self.read_cols(gy, gx)
            c1, v1 = self.read_cols(gy, gx + 1)
            return c0, c1, v0, v1
        _, valid0 = _band_index(self, gy, gx)
        _, valid1 = _band_index(self, gy, gx + 1)
        c = self.data.shape[-1]
        cover_rows = self.band_h + 2 * self.halo
        local_row = jnp.clip(gy - self.y0 + self.halo, 0, cover_rows - 1)
        base = jnp.clip(gx, 0, self.width - 2)
        start = local_row * self.width + base
        off0 = jnp.clip(gx - base, 0, 1)      # 1 only when gx == width-1
        off1 = jnp.clip(gx + 1 - base, 0, 1)  # 0 only when gx == -1
        # row r -> [row r | row r+1]; the roll wrap (last flat row -> row 0)
        # is never selected: base <= width-2 keeps r+1 inside the same
        # image row, and the cover clamp keeps r inside the band.
        pair = jnp.concatenate(
            [self.data, jnp.roll(self.data, -1, axis=0)], axis=-1)
        flat = _gather_cols(pair, start)                 # 2C dense [R]s
        cols0 = [jnp.where(off0 == 1, flat[c + k], flat[k])
                 for k in range(c)]
        cols1 = [jnp.where(off1 == 0, flat[k], flat[c + k])
                 for k in range(c)]
        return cols0, cols1, valid0, valid1

    def read_cols_quad(self, gy, gx):
        """Columns of the full 2x2 bilinear footprint {(gy, gx), (gy, gx+1),
        (gy+1, gx), (gy+1, gx+1)} in ONE gather.

        Overlapping-quad packing (PERF.md follow-up to read_cols_x2): a
        per-call packed copy of the view holds every pixel's quad
        [(y,x), (y,x+1), (y+1,x), (y+1,x+1)] as one 4C-wide row (built by
        three dense rolls - 4x the row width, no gathers), so the whole
        bilinear footprint is ONE visited row per lane where read_cols_x2
        pays two. Anchors clamp to (cover_rows-2, width-2) and per-corner
        offsets re-select within the quad, exactly like read_cols_x2's
        x-window: every corner the masks report VALID carries the value
        read() would return.

        Returns (c00, c10, c01, c11, v00, v10, v01, v11) - cXY is the
        column list of corner (gy+Y, gx+X), matching the (x-pair, y-row)
        order of two read_cols_x2 calls at gy and gy+1.
        """
        cover_rows = self.band_h + 2 * self.halo
        if self.width < 2 or cover_rows < 2:
            c00, c10, v00, v10 = self.read_cols_x2(gy, gx)
            c01, c11, v01, v11 = self.read_cols_x2(gy + 1, gx)
            return c00, c10, c01, c11, v00, v10, v01, v11
        _, v00 = _band_index(self, gy, gx)
        _, v10 = _band_index(self, gy, gx + 1)
        _, v01 = _band_index(self, gy + 1, gx)
        _, v11 = _band_index(self, gy + 1, gx + 1)
        c = self.data.shape[-1]
        w = self.width
        # row (y, x) -> [self | x+1 | y+1 | y+1,x+1]; roll wraps only ever
        # land in corners the anchor clamp keeps un-selected or the valid
        # masks report invalid.
        quad = jnp.concatenate([
            self.data,
            jnp.roll(self.data, -1, axis=0),
            jnp.roll(self.data, -w, axis=0),
            jnp.roll(self.data, -(w + 1), axis=0),
        ], axis=-1)                                    # [N, 4C]
        local = gy - self.y0 + self.halo
        ly = jnp.clip(local, 0, cover_rows - 2)
        bx = jnp.clip(gx, 0, self.width - 2)
        offy0 = jnp.clip(local - ly, 0, 1)      # 1 only at the bottom edge
        offy1 = jnp.clip(local + 1 - ly, 0, 1)  # 0 only above the top edge
        offx0 = jnp.clip(gx - bx, 0, 1)         # 1 only when gx == width-1
        offx1 = jnp.clip(gx + 1 - bx, 0, 1)     # 0 only when gx == -1
        cols = _gather_cols(quad, ly * w + bx)  # 4C dense [R]s

        def corner(offx, offy):
            top = [jnp.where(offx == 1, cols[c + k], cols[k])
                   for k in range(c)]
            bot = [jnp.where(offx == 1, cols[3 * c + k], cols[2 * c + k])
                   for k in range(c)]
            return [jnp.where(offy == 1, b, t) for t, b in zip(top, bot)]

        return (corner(offx0, offy0), corner(offx1, offy0),
                corner(offx0, offy1), corner(offx1, offy1),
                v00, v10, v01, v11)

    def as_2d(self):
        """[(band_h + 2*halo), width, ...] image-shaped view."""
        trailing = self.data.shape[1:]
        return self.data.reshape(self.band_h + 2 * self.halo, self.width, *trailing)


def trivial_view(flat, width: int, height: int) -> BandView:
    """One-device view: the full image, no halo."""
    return BandView(data=flat, y0=jnp.int32(0), width=width, height=height,
                    band_h=height, halo=0)


@partial(jax.tree_util.register_dataclass,
         data_fields=["a", "b", "y0"],
         meta_fields=["width", "height", "band_h", "halo"])
@dataclasses.dataclass
class PairBandView:
    """BandView over TWO flat arrays whose reads concatenate row-wise.

    Equivalent to a BandView over `concatenate([a, b], -1)` WITHOUT
    materializing the concatenation - at 4K the combined
    G-buffer+reservoir copies alone are ~6 GB of device memory; per tap
    this costs a second row gather instead (the right trade only for
    huge frames, pipeline._LAZY_VIEW_RAYS)."""
    a: jax.Array
    b: jax.Array
    y0: jax.Array
    width: int
    height: int
    band_h: int
    halo: int

    def read(self, gy, gx):
        idx, valid = _band_index(self, gy, gx)
        return jnp.concatenate([self.a[idx], self.b[idx]], axis=-1), valid

    def read_cols(self, gy, gx):
        """As BandView.read_cols; the two row gathers transpose separately,
        so the column lists concatenate for free (no [R, Ca+Cb] copy)."""
        idx, valid = _band_index(self, gy, gx)
        return _gather_cols(self.a, idx) + _gather_cols(self.b, idx), valid


def trivial_pair_view(a, b, width: int, height: int) -> PairBandView:
    return PairBandView(a=a, b=b, y0=jnp.int32(0), width=width,
                        height=height, band_h=height, halo=0)


def halo_exchange(flat_local, width: int, band_h: int, halo: int,
                  axis_name: str, y0) -> BandView:
    """Build a BandView from a band-local flat array inside shard_map.

    Exchanges `halo` boundary rows with the neighboring devices on the
    `axis_name` mesh axis via two `ppermute` shifts (the ring/halo
    pattern standing in for sequence parallelism; SURVEY.md §2.3). Edge
    devices receive zeros - masked out by BandView coverage checks anyway.
    """
    n = jax.lax.psum(1, axis_name)
    trailing = flat_local.shape[1:]
    img = flat_local.reshape(band_h, width, *trailing)

    if halo == 0 or n == 1:
        return BandView(data=flat_local, y0=y0, width=width,
                        height=band_h * n, band_h=band_h, halo=0)

    top_rows = img[:halo]        # sent downward (to device d-1's bottom halo)
    bottom_rows = img[-halo:]    # sent upward   (to device d+1's top halo)
    down_perm = [(i, i + 1) for i in range(n - 1)]
    up_perm = [(i + 1, i) for i in range(n - 1)]
    from_above = jax.lax.ppermute(bottom_rows, axis_name, down_perm)
    from_below = jax.lax.ppermute(top_rows, axis_name, up_perm)
    ext = jnp.concatenate([from_above, img, from_below], axis=0)
    return BandView(data=ext.reshape(-1, *trailing), y0=y0, width=width,
                    height=band_h * n, band_h=band_h, halo=halo)


def gb_views(gb: dict, make_view) -> dict:
    """Lift a G-buffer dict of flat arrays to a dict of BandViews."""
    return {k: make_view(v) for k, v in gb.items()}
