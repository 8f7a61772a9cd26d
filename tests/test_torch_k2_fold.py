"""The fold that the culled K2 (`csrc/k2_record.cu`, k2_record_kernel_culled)
relies on, held against a replay of its `test_sphere`'s sequential update.

The brute-force loop and the parent's culled loop visit rows in ascending
order and update (winner, runner-up) by `test_sphere`: strict < for the
winner, and a row that ties the winner's t never becomes the runner-up.  The
culled kernel instead gives each live cluster's rows to one thread of the
warp, which runs that same update over the cluster alone and folds the
cluster's (w, r) into its lane's two 64-bit keys (t's bits ranked like the
floats, then the row) with atomicMin, in whatever order the warp's threads
reach them, after a read of the winner key that may be stale.  Here the
rows are split into clusters and folded in shuffled orders, with stale
reads, and the keys must end as the sequential replay's (winner, runner-up)
on every case: random t lists with planted exact ties, t_max and t_min
entries and NaN.
"""

import numpy as np
import pytest

T_MIN, T_MAX = np.float32(0.001), np.float32(1e30)
NO_HIT = (1 << 64) - 1


def sequential(ts):
    """test_sphere's update over the rows in order -> (bidx, bidx2), -1 for
    none: the parent's loop (t_min < t < t_max are hits, NaN none)."""
    bt = bt2 = T_MAX
    bidx = bidx2 = -1
    for i, tn in enumerate(ts):
        if not tn > T_MIN:
            continue
        if tn < bt:
            bt2, bidx2 = bt, bidx
            bt, bidx = tn, i
        elif tn < bt2 and tn != bt:
            bt2, bidx2 = tn, i
    return bidx, bidx2


def hit_key(t, row):
    """The kernel's hit_key: t's float32 bits in an order that ranks like
    the floats, then the row."""
    u = int(np.float32(t).view(np.uint32))
    k = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return k << 32 | row


def key_t(key):
    """The kernel's key_t: hit_key's t, bit for bit."""
    k = key >> 32
    u = (k & 0x7FFFFFFF) if k & 0x80000000 else (~k & 0xFFFFFFFF)
    return np.uint32(u).view(np.float32)


def cluster_result(ts, lo, hi):
    """One pair's thread: test_sphere over rows [lo, hi) -> (w, r) keys of
    global rows, None for none."""
    w, r = sequential(ts[lo:hi])
    return (None if w < 0 else hit_key(ts[lo + w], lo + w),
            None if r < 0 else hit_key(ts[lo + r], lo + r))


def fold(state, history, w, r, rng, stale):
    """The kernel's fold of one cluster's (w, r) into state = [W, R]; the
    winner key is read from a value it held (`history`, stale reads), as
    the volatile read before the atomic may be."""
    old = history[rng.integers(len(history))] if stale else state[0]
    if w < old:
        old = state[0]  # atomicMin returns the value it met
        if w < old:
            state[0] = w
            history.append(w)
    lo, hi = min(w, old), max(w, old)
    cand = hi if (hi >> 32) != (lo >> 32) else NO_HIT
    if r is not None:
        cand = min(cand, r)
    state[1] = min(state[1], cand)


def folded(ts, size, rng, stale):
    """The rows in clusters of `size`, folded in a shuffled order ->
    (bidx, bidx2)."""
    results = [cluster_result(ts, lo, min(lo + size, len(ts)))
               for lo in range(0, len(ts), size)]
    state, history = [NO_HIT, NO_HIT], [NO_HIT]
    for k in rng.permutation(len(results)):
        w, r = results[k]
        if w is not None:
            fold(state, history, w, r, rng, stale)
    w = -1 if state[0] == NO_HIT else state[0] & 0xFFFFFFFF
    r = -1 if state[1] == NO_HIT else state[1] & 0xFFFFFFFF
    return w, r


def t_list(rng, n, distinct):
    """n float32 roots from a pool of `distinct` values (so exact ties are
    planted), with t_max, t_min, values beyond t_max, below t_min and NaN
    mixed in."""
    pool = rng.uniform(0.5, 50.0, distinct).astype(np.float32)
    ts = pool[rng.integers(distinct, size=n)]
    special = np.array([T_MAX, T_MIN, np.float32(2e30), np.float32(-3.0),
                        np.float32(np.nan), np.float32(0.0)], np.float32)
    pick = rng.random(n) < 0.15
    ts[pick] = special[rng.integers(len(special), size=int(pick.sum()))]
    return ts


@pytest.mark.parametrize("distinct", [2, 5, 40])
@pytest.mark.parametrize("size", [1, 3, 12, 64])
@pytest.mark.parametrize("stale", [False, True])
def test_folded_clusters_give_the_sequential_winner_and_runner_up(
        distinct, size, stale):
    """Random t lists of 1-200 rows, ties planted from a pool of `distinct`
    values: every shuffled fold of the clusters gives the replay's (winner,
    runner-up) rows."""
    rng = np.random.default_rng(1000 * distinct + 10 * size + stale)
    for _ in range(150):
        ts = t_list(rng, int(rng.integers(1, 201)), distinct)
        want = sequential(ts)
        for _ in range(3):
            assert folded(ts, size, rng, stale) == want, ts.tolist()


def test_a_tie_with_the_winner_is_never_the_runner_up():
    """Rows (5, 3, 5, 7, 3): the winner is row 1 (the first 3); row 4 ties
    it and is passed over, so the runner-up is row 0 (the first 5), in the
    replay and in every fold at every cluster size."""
    ts = np.array([5.0, 3.0, 5.0, 7.0, 3.0], np.float32)
    assert sequential(ts) == (1, 0)
    rng = np.random.default_rng(0)
    for size in (1, 2, 3, 5):
        for _ in range(20):
            assert folded(ts, size, rng, stale=True) == (1, 0)


def test_no_runner_up_when_every_hit_ties():
    """All hits at one t: a winner (the first row) and no runner-up."""
    ts = np.array([np.nan, 4.0, 4.0, T_MAX, 4.0], np.float32)
    assert sequential(ts) == (1, -1)
    rng = np.random.default_rng(1)
    for size in (1, 2, 4):
        assert folded(ts, size, rng, stale=True) == (1, -1)


def test_hit_keys_rank_like_the_floats_and_give_t_back():
    """hit_key orders by t, then by row, and key_t returns t's bits."""
    rng = np.random.default_rng(2)
    ts = np.concatenate([rng.uniform(-100, 100, 500).astype(np.float32),
                         np.array([T_MIN, T_MAX, 1e-30, 3e38, -1e-30],
                                  np.float32)])
    rows = rng.integers(0, 1 << 20, ts.size)
    keys = [hit_key(t, int(r)) for t, r in zip(ts, rows)]
    for t, k in zip(ts, keys):
        assert key_t(k).view(np.uint32) == np.float32(t).view(np.uint32)
    order = sorted(range(ts.size), key=lambda i: keys[i])
    want = sorted(range(ts.size), key=lambda i: (float(ts[i]), int(rows[i])))
    assert order == want
