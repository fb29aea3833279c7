"""Search texture material groupings OFFLINE against dumped row masks.

Input: an .npz with ``masks``, the (F, R) per-128-px-row material bitmasks
of pipeline.measure_tex_row_masks over fly-through frames. Evaluates
grouping strategies for the grouped-tile gather (RenderConfig.tex_group_caps)
with io.texplan's relative cost model:

    cost = 128 px/row * (uniform_rows * W_GROUP + fallback_rows * W_FALLBACK)

Strategies:

  contiguous   materials grouped by id (what group_tile_atlas does today)
  greedy       seed groups with the heaviest co-occurrence edges, grow by
               max marginal co-occurrence
  anneal       simulated annealing over assignments (swap moves), objective
               = total mixed rows over the dump
  pairs        additionally route rows that mix exactly TWO groups ADJACENT
               in layout order through the concatenated pair slice —
               annealing then also optimizes the group ORDER

Usage: python tools/plan_tex_groups.py texrows.npz [--mats-per-group N]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from arctic_tpu.io.texplan import W_FALLBACK, W_GROUP  # noqa: E402
M = 24


def mixing(masks, group_of):
    """(uniform_rows, mixed_rows) over all dumped rows for an assignment."""
    gsets = [np.int64(0)] * (int(group_of.max()) + 1)
    for m, g in enumerate(group_of):
        gsets[g] |= np.int64(1) << m
    covered = masks != 0
    n_cov = int(covered.sum())
    mixed = np.zeros(masks.shape, bool)
    within = np.zeros(masks.shape, bool)
    for g, gs in enumerate(gsets):
        within |= (masks & ~gs) == 0
    mixed = covered & ~within
    return n_cov - int(mixed.sum()), int(mixed.sum()), mixed


def pair_routable(masks, group_of, order):
    """Rows mixing exactly two groups ADJACENT in ``order``."""
    g_n = int(group_of.max()) + 1
    gsets = [np.int64(0)] * g_n
    for m, g in enumerate(group_of):
        gsets[g] |= np.int64(1) << m
    pos = np.empty(g_n, np.int64)
    for i, g in enumerate(order):
        pos[g] = i
    touched = np.zeros(masks.shape + (g_n,), bool)
    for g, gs in enumerate(gsets):
        touched[..., g] = (masks & gs) != 0
    cnt = touched.sum(-1)
    # position min/max of touched groups
    posb = np.where(touched, pos[None, None, :], np.int64(1 << 30))
    pmin = posb.min(-1)
    posb2 = np.where(touched, pos[None, None, :], -1)
    pmax = posb2.max(-1)
    return (cnt == 2) & (pmax - pmin == 1)


def modeled_cost(masks, group_of, rows_per_frame, order=None, pairs=False):
    uni, mix, mixed_mask = mixing(masks, group_of)
    n_frames = masks.shape[0]
    pairr = 0
    if pairs and order is not None:
        pr = pair_routable(masks, group_of, order) & mixed_mask
        pairr = int(pr.sum())
        mix -= pairr
        uni += pairr  # pair slices are fast-tier too
    per_frame_rows = masks[0].size
    uni_f = uni / n_frames
    mix_f = mix / n_frames
    return (uni_f * 128 * W_GROUP + mix_f * 128 * W_FALLBACK), mix / (
        n_frames * 1.0
    )


def cooc(masks):
    c = np.zeros((M, M), np.int64)
    flat = masks.reshape(-1)
    flat = flat[flat != 0]
    for a in range(M):
        ba = (flat >> a) & 1
        for b in range(a + 1, M):
            c[a, b] = c[b, a] = int((ba & ((flat >> b) & 1)).sum())
    return c


def greedy(masks, k):
    """Partition into groups of size <= k by descending co-occurrence."""
    c = cooc(masks)
    g_n = -(-M // k)
    group_of = np.full(M, -1, np.int64)
    # Seed with the k heaviest-degree mats spread across groups? Simpler:
    # repeatedly pick the unassigned mat with max total co-occurrence to a
    # non-full group (or start a new one).
    groups = [[] for _ in range(g_n)]
    degree = c.sum(1)
    for m in np.argsort(-degree):
        best, best_s = None, -1
        for gi, g in enumerate(groups):
            if len(g) >= k:
                continue
            s = sum(c[m, o] for o in g)
            if s > best_s or (best is None):
                best, best_s = gi, s
        groups[best].append(int(m))
        group_of[m] = best
    return group_of


def anneal(masks, group_of, k, iters=20000, seed=0):
    rng = np.random.default_rng(seed)
    cur = group_of.copy()
    g_n = int(cur.max()) + 1

    def score(a):
        _, mix, _ = mixing(masks, a)
        return mix

    s = score(cur)
    best, best_s = cur.copy(), s
    t0, t1 = s * 0.02 + 1, 0.5
    for it in range(iters):
        t = t0 * (t1 / t0) ** (it / iters)
        a, b = rng.integers(0, M, 2)
        if cur[a] == cur[b]:
            continue
        nxt = cur.copy()
        nxt[a], nxt[b] = cur[b], cur[a]
        s2 = score(nxt)
        if s2 < s or rng.random() < np.exp((s - s2) / t):
            cur, s = nxt, s2
            if s < best_s:
                best, best_s = cur.copy(), s
    return best


def order_anneal(masks, group_of, iters=4000, seed=1):
    """Optimize group ORDER for adjacent-pair routing."""
    rng = np.random.default_rng(seed)
    g_n = int(group_of.max()) + 1
    cur = np.arange(g_n)
    _, _, mixed_mask = mixing(masks, group_of)

    def score(o):
        pr = pair_routable(masks, group_of, o) & mixed_mask
        return -int(pr.sum())

    s = score(cur)
    best, best_s = cur.copy(), s
    for it in range(iters):
        a, b = rng.integers(0, g_n, 2)
        if a == b:
            continue
        nxt = cur.copy()
        nxt[a], nxt[b] = cur[b], cur[a]
        s2 = score(nxt)
        if s2 <= s:
            cur, s = nxt, s2
            if s < best_s:
                best, best_s = cur.copy(), s
    return best


def main():
    path = sys.argv[1]
    k = 3
    for i, a in enumerate(sys.argv):
        if a == "--mats-per-group" and i + 1 < len(sys.argv):
            k = int(sys.argv[i + 1])
    masks = np.load(path)["masks"].astype(np.int64)
    print(f"{masks.shape[0]} frames x {masks.shape[1]} rows, k={k}/group")

    g_n = -(-M // k)
    contig = np.minimum(np.arange(M) // k, g_n - 1)
    for name, asg in (("contiguous", contig), ("greedy", greedy(masks, k))):
        ms, mixf = modeled_cost(masks, asg, masks.shape[1])
        print(f"{name:11s}: modeled cost {ms:10.0f}, mixed {mixf:8.0f} rows/frame")

    ann = anneal(masks, greedy(masks, k), k)
    ms, mixf = modeled_cost(masks, ann, masks.shape[1])
    print(f"{'anneal':11s}: modeled cost {ms:10.0f}, mixed {mixf:8.0f} rows/frame")
    print("anneal groups:", [list(np.where(ann == g)[0]) for g in range(g_n)])

    order = order_anneal(masks, ann)
    ms, mixf = modeled_cost(masks, ann, masks.shape[1], order=order, pairs=True)
    print(
        f"{'+pairs':11s}: modeled cost {ms:10.0f}, mixed {mixf:8.0f} rows/frame "
        f"(order {list(order)})"
    )


if __name__ == "__main__":
    main()
