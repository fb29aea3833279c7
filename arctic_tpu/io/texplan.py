"""Host-side texture material-group planning from rendered row masks.

The opt-in grouped-tile gather (ops.sampling.tile_tap_resolve_grouped)
routes each 128-px row through its touched material groups: rows touching
one group pay one group-table gather, two groups pay two (dual-claim), more
fall back to the full-table gather. The grouping therefore sets the cost —
and the bench scene assigns materials round-robin across objects, so
grouping by material ID mixes many rows. This module plans groups from
rendered row co-occurrence (pipeline.measure_tex_row_masks over a camera
path) with a simulated-annealing swap search under a relative cost model:

    cost ~ 128 * (W_GROUP * (uniform + 2 * dual rows) + W_FALLBACK * fallback)

The weights are an assumption of the design (a full-table gather row costs
several group-table rows), not a measurement on the GPU. Rebuild buffers
with the planned groups via build_buffers(..., tex_groups=plan).
"""

from __future__ import annotations

import numpy as np

W_GROUP = 1.0
W_FALLBACK = 5.5


def _touch_stats(masks: np.ndarray, gsets: list[int]):
    """(uniform, dual, many) row counts for group bitsets over (F, R) masks."""
    covered = masks != 0
    touched = np.stack([(masks & gs) != 0 for gs in gsets], axis=-1)
    cnt = touched.sum(-1)
    uni = int(((cnt <= 1) & covered).sum())
    dual = int((cnt == 2).sum())
    many = int((cnt >= 3).sum())
    return uni, dual, many


def _cost(uni, dual, many, n_frames):
    return (
        128.0 * (W_GROUP * (uni + 2 * dual) + W_FALLBACK * many) / n_frames
    )


def plan_material_groups(
    masks: np.ndarray,
    mat_rows: list[int],
    env_rows: int,
    budget_rows: int,
    iters: int = 12000,
    seed: int = 0,
):
    """Anneal a material -> group partition minimizing the dual-claim cost.

    masks: (F, R) int bitmasks from pipeline.measure_tex_row_masks;
    mat_rows: tile rows per material; env_rows / budget_rows: the env-copy
    size and per-group row budget (a group + env must stay under it).
    Returns (groups list-of-lists, modeled cost per frame in W_GROUP
    row-units).
    """
    m = len(mat_rows)
    masks = masks.astype(np.int64)
    nf = masks.shape[0]

    # Greedy seed: heaviest co-occurrence first, into the best-fitting group.
    flat = masks.reshape(-1)
    flat = flat[flat != 0]
    c = np.zeros((m, m), np.int64)
    for a in range(m):
        ba = (flat >> a) & 1
        for b in range(a + 1, m):
            c[a, b] = c[b, a] = int((ba & ((flat >> b) & 1)).sum())
    cap_rows = budget_rows - env_rows
    groups: list[list[int]] = []
    rows_of: list[int] = []
    for mi in np.argsort(-c.sum(1)):
        mi = int(mi)
        best, best_s = None, -1
        for gi, g in enumerate(groups):
            if rows_of[gi] + mat_rows[mi] > cap_rows:
                continue
            s = sum(c[mi, o] for o in g)
            if s > best_s:
                best, best_s = gi, s
        if best is None:
            groups.append([mi])
            rows_of.append(mat_rows[mi])
        else:
            groups[best].append(mi)
            rows_of[best] += mat_rows[mi]

    g_n = len(groups)
    assign = np.zeros(m, np.int64)
    for gi, g in enumerate(groups):
        for mi in g:
            assign[mi] = gi

    def gsets_of(a):
        gs = [0] * g_n
        for mi, gi in enumerate(a):
            gs[gi] |= 1 << mi
        return [np.int64(x) for x in gs]

    def score(a):
        return _cost(*_touch_stats(masks, gsets_of(a)), nf)

    def rows_by_group(a):
        out = [0] * g_n
        for mi, gi in enumerate(a):
            out[gi] += mat_rows[mi]
        return out

    rng = np.random.default_rng(seed)
    cur = assign.copy()
    s = score(cur)
    best, best_s = cur.copy(), s
    t0, t1 = max(s * 0.05, 0.01), 0.002
    for it in range(iters):
        t = t0 * (t1 / t0) ** (it / max(iters - 1, 1))
        a, b = rng.integers(0, m, 2)
        if cur[a] == cur[b]:
            continue
        nxt = cur.copy()
        nxt[a], nxt[b] = cur[b], cur[a]
        rg = rows_by_group(nxt)
        if max(rg) > cap_rows:
            continue
        s2 = score(nxt)
        if s2 < s or rng.random() < np.exp((s - s2) / t):
            cur, s = nxt, s2
            if s < best_s:
                best, best_s = cur.copy(), s
    plan = [
        sorted(int(mi) for mi in np.where(best == gi)[0]) for gi in range(g_n)
    ]
    return [g for g in plan if g], best_s
