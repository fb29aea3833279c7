"""Tile binning: triangle slots -> sorted per-tile work lists, pure XLA.

The GPU's rasterizer front-end distributes triangles to screen tiles in
hardware; here it becomes sort-based dataflow (SURVEY.md §7 "hard parts" #1):

1. per-slot tile bbox from the clamped screen bbox
2. expansion to (tile, slot) pairs WITHOUT scatter: an exclusive-cumsum of
   per-slot tile counts + searchsorted turns "repeat each slot count_i times"
   into a gather
3. one stable sort by tile id groups pairs per tile (stability preserves
   draw order -> depth-tie semantics match the sequential reference)
4. searchsorted against the sorted tile ids yields per-tile [start, end)

Everything is static-shaped: the pair buffer has a fixed capacity and a
sentinel tile id (== num_tiles) floats invalid/overflow pairs to the end.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from arctic_tpu.ops.raster import TriSetup

Array = jnp.ndarray


class BinnedPairs(NamedTuple):
    sorted_slot: Array  # (pair_cap,) i32 slot id per pair, grouped by tile
    tile_start: Array  # (num_tiles + 1,) i32 segment offsets into sorted_slot
    total_pairs: Array  # i32 scalar — actual pairs generated (for overflow checks)


def _tile_footprints(
    setup: TriSetup,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    tile_row0=0,
    rect=None,
):
    """Per-slot tile bbox + pair counts: (counts, tx0, ty0, w).

    ``rect`` (rx0, ry0, rx1, ry1) — traced inclusive GLOBAL tile coords —
    intersects every slot's tile bbox (sun-frustum shadow culling,
    ops/cull.py): pairs for tiles outside the rect are never generated, and
    in-rect tiles receive exactly the same pair list in the same order.
    An empty rect (rx1 < rx0) culls everything.
    """
    x0, y0, x1, y1 = setup.bbox
    valid = setup.valid

    tx0 = jnp.clip((x0 / tile_w).astype(jnp.int32), 0, tiles_x - 1)
    # bbox is exclusive at x1/y1 in pixel terms; a bbox ending exactly on a
    # tile boundary doesn't cover the next tile's pixel centers.
    tx1 = jnp.clip(((x1 - 1e-3) / tile_w).astype(jnp.int32), 0, tiles_x - 1)
    ty0 = jnp.maximum((y0 / tile_h).astype(jnp.int32) - tile_row0, 0)
    ty1 = jnp.minimum(
        ((y1 - 1e-3) / tile_h).astype(jnp.int32) - tile_row0, tiles_y - 1
    )

    if rect is not None:
        rx0, ry0, rx1, ry1 = rect
        tx0 = jnp.maximum(tx0, rx0)
        tx1 = jnp.minimum(tx1, rx1)
        ty0 = jnp.maximum(ty0, ry0 - tile_row0)
        ty1 = jnp.minimum(ty1, ry1 - tile_row0)
        valid = valid & (tx1 >= tx0)
        tx0 = jnp.minimum(tx0, tiles_x - 1)  # empty-rect clamp for meta bits

    in_rows = ty1 >= ty0
    valid = valid & in_rows
    ty0 = jnp.clip(ty0, 0, tiles_y - 1)
    ty1 = jnp.clip(ty1, 0, tiles_y - 1)

    w = jnp.where(valid, tx1 - tx0 + 1, 1)
    h = jnp.where(valid, ty1 - ty0 + 1, 1)
    counts = jnp.where(valid, w * h, 0)
    return counts, tx0, ty0, w


def count_pairs(
    setup: TriSetup,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    tile_row0=0,
    rect=None,
) -> Array:
    """Total (tile, triangle) pairs this frame would generate (i32 scalar).

    Sort-free — used by pipeline.autotune_pair_caps to size the pair buffer
    to the scene instead of the worst-case formula."""
    counts, _, _, _ = _tile_footprints(
        setup, tiles_x, tiles_y, tile_w, tile_h, tile_row0, rect
    )
    return jnp.sum(counts, dtype=jnp.int32)


def bin_triangles(
    setup: TriSetup,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    pair_capacity: int,
    tile_row0=0,
    rect=None,
) -> BinnedPairs:
    """Bin into the tile window rows [tile_row0, tile_row0 + tiles_y).

    ``tile_row0`` may be traced (device's slice offset under shard_map);
    tile ids in the output are window-local. ``rect`` culls tiles outside
    an inclusive global tile rect (see _tile_footprints).
    """
    num_tiles = tiles_x * tiles_y
    counts, tx0, ty0, w = _tile_footprints(
        setup, tiles_x, tiles_y, tile_w, tile_h, tile_row0, rect
    )

    # Expansion without per-pair binary search: pair -> slot is a TWO-LEVEL
    # run-length decode. Level 1 scatters only per GROUP of slots (one
    # update per G slots instead of one per slot): group ends -> cummax
    # recovers each pair's group and the
    # group's first pair position. Level 2 resolves the slot within the
    # group from ONE dense 128-lane row per group (consecutive pairs repeat
    # rows, so the gather runs at cache speed): lanes [0:G) carry the
    # group's local-inclusive-cumsum (two lane reduces give
    # slot = #{local cums <= off} and the slot's local start) and lanes
    # [G:2G) the packed bbox META of the group's G slots, resolved by a
    # lane one-hot at slot_local — G = 64 so both halves share one row and
    # one gather.
    G = 64
    cap = setup.capacity
    cum = jnp.cumsum(counts, dtype=jnp.int32)  # inclusive
    total = cum[-1]
    pos = jnp.arange(pair_capacity, dtype=jnp.int32)
    cap_pad = (cap + G - 1) // G * G
    if cap_pad != cap:  # pad with empty slots (cum stays flat)
        cum = jnp.concatenate(
            [cum, jnp.broadcast_to(total, (cap_pad - cap,))]
        )
    n_groups = cap_pad // G

    cum_g = cum[G - 1 :: G]  # (n_groups,) inclusive pair count per group end
    pos_bits = max(int(pair_capacity - 1).bit_length(), 1)
    if n_groups.bit_length() + pos_bits <= 31:
        # One scan recovers BOTH maxima: pack (group << pos_bits) | pos into
        # a single non-negative i32 — monotone in scatter order, so cummax
        # of the packed value carries the latest (group, pos) pair.
        # Scatter packs the PAIR position of each group end with its group
        # id; positions are the scatter targets themselves.
        m0 = jnp.full(pair_capacity + 1, -1, jnp.int32)
        at = jnp.clip(cum_g, 0, pair_capacity)
        m0 = m0.at[at].max(
            (jnp.arange(n_groups, dtype=jnp.int32) << pos_bits) | at
        )
        mm = jax.lax.cummax(m0[:pair_capacity])
        group = (mm >> pos_bits) + 1  # arithmetic shift: -1 -> 0
        gbase = jnp.where(mm < 0, 0, mm & ((1 << pos_bits) - 1))
    else:  # huge buffers: fall back to two scans
        m0 = jnp.full(pair_capacity + 1, -1, jnp.int32)
        m0 = m0.at[jnp.clip(cum_g, 0, pair_capacity)].max(
            jnp.arange(n_groups, dtype=jnp.int32)
        )
        mm = m0[:pair_capacity]
        group = jax.lax.cummax(mm) + 1  # group containing pair `pos`
        gbase = jax.lax.cummax(jnp.where(mm >= 0, pos, 0))  # group's first pair
    off = pos - gbase  # pair offset within the group

    # Combined group rows: lanes [0:G) local cumsum, [G:2G) packed bbox
    # meta (tx0: 9 bits, ty0: 13 bits, w: 9 bits — up to 16k x 256k px).
    assert tiles_x <= 512 and tiles_y <= 8192
    meta = tx0 | (ty0 << 9) | (w << 22)
    if cap_pad != cap:
        meta = jnp.concatenate([meta, jnp.zeros((cap_pad - cap,), meta.dtype)])
    gstart = jnp.concatenate([jnp.zeros(1, jnp.int32), cum_g[:-1]])
    loc = cum.reshape(n_groups, G) - gstart[:, None]
    combined = jnp.concatenate([loc, meta.reshape(n_groups, G)], axis=1)
    group_c = jnp.minimum(group, n_groups - 1)
    row = combined[group_c]  # (pair_cap, 2G) — consecutive pairs repeat rows
    locr = row[:, :G]
    le = locr <= off[:, None]
    # locr is a non-decreasing cumsum, so `le` is a prefix mask: the meta
    # lane to select (lane slot_local = popcount(le)) is the FIRST 0 lane —
    # expressible as le[k-1] & ~le[k] WITHOUT the popcount, which breaks the
    # reduce -> one-hot dependency and lets XLA fuse all three lane reduces
    # into ONE pass over the (cap, 128) rows.
    le_sh = jnp.concatenate([jnp.ones_like(le[:, :1]), le[:, :-1]], axis=1)
    sel = le_sh & ~le  # one-hot at lane slot_local (all-zero iff le all-1s)
    slot_local = jnp.sum(le, axis=1, dtype=jnp.int32)
    start_local = jnp.max(jnp.where(le, locr, 0), axis=1)
    slot = group_c * G + slot_local
    k = off - start_local
    # slot_local of a valid pair is < G (its group's total exceeds off), so
    # `sel` always hits a real meta lane there; invalid pairs may select
    # nothing (m = 0, matching the old lane_g == G no-match) and are masked
    # by `ok`.
    m = jnp.sum(jnp.where(sel, row[:, G:], 0), axis=1, dtype=jnp.int32)
    ok = (pos < total) & (slot < setup.capacity)
    slot_c = jnp.minimum(slot, setup.capacity - 1)
    mtx0 = m & 0x1FF
    mty0 = (m >> 9) & 0x1FFF
    mw = jnp.maximum(m >> 22, 1)
    tile = (mty0 + k // mw) * tiles_x + (mtx0 + k % mw)
    tile = jnp.where(ok, tile, num_tiles)

    bits_s = max(int(setup.capacity - 1).bit_length(), 1)
    if num_tiles.bit_length() + bits_s <= 31:
        # Single-array sort of (tile << bits_s | slot): pairs are emitted in
        # slot-ascending order, so the stable-by-tile sort's within-tile
        # order IS slot-ascending — the packed key reproduces it exactly
        # while sorting one array instead of three (XLA adds an iota
        # operand for stability).
        packed = (tile << bits_s) | slot_c
        sp = jax.lax.sort(packed)
        sorted_tile = sp >> bits_s
        sorted_slot = sp & ((1 << bits_s) - 1)
    else:  # huge scenes: keep the stable 2-key form
        sorted_tile, sorted_slot = jax.lax.sort(
            (tile, slot_c), num_keys=1, is_stable=True
        )
    tile_start = _tile_starts(sorted_tile, num_tiles)
    return BinnedPairs(sorted_slot=sorted_slot, tile_start=tile_start, total_pairs=total)


def _tile_starts(sorted_tile: Array, num_tiles: int) -> Array:
    """searchsorted(sorted_tile, arange(num_tiles + 1), 'left'), two-level.

    The flat jnp.searchsorted lowers to a log2(pair_cap)-iteration while
    loop of dependent gather+compare rounds. Two levels cut the serial
    depth: a coarse searchsorted over the 128-strided row heads (a tiny
    array, log2(cap / 128) rounds), then ONE dense (Q, 128) row gather +
    lane reduce resolves the exact offset. Correctness: with r =
    max(coarse - 1, 0), every element before row r is < t, so
    first_index(>= t) = 128 * r + #(row_r < t) (the count saturating to
    128 lands exactly at row `coarse`'s head).
    """
    cap = sorted_tile.shape[0]
    if cap % 128 != 0:  # tiny test buffers: keep the flat form
        return jnp.searchsorted(
            sorted_tile, jnp.arange(num_tiles + 1, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
    view = sorted_tile.reshape(cap // 128, 128)
    t = jnp.arange(num_tiles + 1, dtype=jnp.int32)
    # coarse[t] = #{row heads < t}: the queries are EVERY tile id in order,
    # so searchsorted collapses to a histogram + exclusive cumsum (head
    # values are in [0, num_tiles]) instead of a log2(rows)-iteration
    # while loop.
    hist = jnp.zeros(num_tiles + 1, jnp.int32).at[view[:, 0]].add(
        1, mode="drop", indices_are_sorted=True
    )
    coarse = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(hist)])[
        : num_tiles + 1
    ]
    r = jnp.maximum(coarse - 1, 0)
    rows = view[r]  # (Q, 128) — dense row gather from a <=2 MB table
    cnt = jnp.sum((rows < t[:, None]).astype(jnp.int32), axis=1)
    return 128 * r + cnt
