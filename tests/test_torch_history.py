"""Parity of the port's dedup history and its merge with the JAX package,
bitwise: the plain `merge_rows` against `merge_rows_xla` and the Pallas
kernel in interpret mode, and `History.insert` / `contains` /
`dup_source` over inserts that overflow capacity (eviction).

The port's CUDA merge kernel cannot run here (no card); `chip_smoke.py`
holds it against the plain version on the card.  On CPU tensors the
kernel's wrapper takes the plain version, which these tests check too.
What a block of the kernel does (its multiway search for its window of
`pos_new`, the slot marks, the running count) is modelled here in plain
torch, `block_merge`, and held bitwise to `merge_rows`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uptune_tpu.driver.history import History as JHistory
from uptune_tpu.driver.history import dup_source as j_dup_source
from uptune_tpu.ops import dedup as jdedup

from uptune_tpu_torch.driver.history import History as THistory
from uptune_tpu_torch.driver.history import dup_source as t_dup_source
from uptune_tpu_torch.driver.history import unique_mask as t_unique_mask
from uptune_tpu_torch.ops import dedup as tdedup

from test_torch_ops import N, T, assert_bitwise

HIST_FIELDS = ("h0", "h1", "qor", "n", "age", "step", "dropped")


def _mk(rng, cap, b, n_live, sent_batch=8):
    """A sorted history with n_live live rows, a sorted batch with forced
    history collisions and sentinel rows, and the merge positions (the
    fixture of tests/test_batched.py::TestPallasDedupMerge)."""
    h0 = np.sort(rng.randint(0, 2**31, n_live).astype(np.uint32))
    h0 = np.concatenate([h0, np.full(cap - n_live, 0xFFFFFFFF, np.uint32)])
    h1 = rng.randint(0, 2**32, cap).astype(np.uint32)
    q = rng.randn(cap).astype(np.float32)
    q[n_live:] = np.inf
    age = np.concatenate([rng.randint(0, 50, n_live),
                          np.full(cap - n_live, -1)]).astype(np.int32)
    h0s = rng.randint(0, 2**31, b).astype(np.uint32)
    if n_live and b > 4:
        h0s[:3] = h0[:3]
    if sent_batch and b > sent_batch:
        h0s[-sent_batch:] = 0xFFFFFFFF
    h0s = np.sort(h0s)
    hist = (h0, h1, q, age)
    new = (h0s, rng.randint(0, 2**32, b).astype(np.uint32),
           rng.randn(b).astype(np.float32), np.full(b, 50, np.int32))
    pos = (np.arange(b) + np.searchsorted(h0, h0s, side="right")).astype(
        np.int32)
    return hist, new, pos


def _t_rows(rows):
    return (T(rows[0], torch.int64), T(rows[1], torch.int64),
            T(rows[2], torch.float32), T(rows[3], torch.int32))


def _j_rows(rows):
    return tuple(jnp.asarray(a) for a in rows)


@pytest.mark.parametrize("cap,b,n_live", [
    (2048, 300, 1500),   # mid-fill, collisions, sentinel rows
    (2048, 2048, 2000),  # full-tile batch, near-full history
])
def test_merge_rows_matches_xla_and_pallas(cap, b, n_live):
    hist, new, pos = _mk(np.random.RandomState(cap + b), cap, b, n_live)
    out_t = tdedup.merge_rows(_t_rows(hist), _t_rows(new), T(pos))
    outx = jdedup.merge_rows_xla(_j_rows(hist), _j_rows(new),
                                 jnp.asarray(pos))
    outp = jdedup.merge_rows_pallas(_j_rows(hist), _j_rows(new),
                                    jnp.asarray(pos), interpret=True)
    for name, x, p, t in zip(("h0", "h1", "qor", "age"), outx, outp, out_t):
        assert_bitwise(x, N(t), name + " vs xla")
        assert_bitwise(p, N(t), name + " vs pallas")


def test_merge_rows_beyond_the_tpu_tile():
    """b = 3000 > 2048: the Pallas kernel's shape gate sent such merges to
    the XLA fallback; the port takes any b."""
    cap, b = 4096, 3000
    hist, new, pos = _mk(np.random.RandomState(5), cap, b, 2500)
    out_t = tdedup.merge_rows(_t_rows(hist), _t_rows(new), T(pos))
    outx = jdedup.merge_rows_xla(_j_rows(hist), _j_rows(new),
                                 jnp.asarray(pos))
    for name, x, t in zip(("h0", "h1", "qor", "age"), outx, out_t):
        assert_bitwise(x, N(t), name)
    # the wrapper routes CPU tensors to the plain version
    out_w = tdedup.merge_rows_kernel(_t_rows(hist), _t_rows(new), T(pos))
    for a, c in zip(out_t, out_w):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32
                           else a,
                           c.view(torch.int32) if c.dtype == torch.float32
                           else c)


def test_merge_history_keeps_qor_bits():
    """inf, -0.0 and a NaN payload survive the merge bit for bit."""
    cap, b = 64, 6
    hist, new, pos = _mk(np.random.RandomState(9), cap, b, 40, sent_batch=0)
    qbits = np.array([0x7FC01234, 0x80000000, 0x7F800000, 0, 1, 2],
                     np.uint32)
    new = (new[0], new[1], qbits.view(np.float32), new[3])
    out_t = tdedup.merge_history(_t_rows(hist), _t_rows(new))
    outx = jdedup.merge_history(_j_rows(hist), _j_rows(new), impl="xla")
    for name, x, t in zip(("h0", "h1", "qor", "age"), outx, out_t):
        assert_bitwise(x, N(t), name)
    got = set(N(out_t[2]).view(np.uint32).tolist())
    assert {0x7FC01234, 0x80000000} <= got


def test_merge_kernel_wrapper_checks_its_inputs():
    cap, b = 64, 6
    hist, new, pos = _mk(np.random.RandomState(1), cap, b, 40)
    with pytest.raises(ValueError, match="CUDA"):
        tdedup.merge_rows_cuda(_t_rows(hist), _t_rows(new), T(pos))
    assert tdedup.MERGE_KERNEL.launches == 0


def test_merge_kernel_wrapper_takes_any_batch_size():
    """The kernel keeps no more of `pos_new` in a block than the block's
    own rows, so the wrapper has no batch limit: b above the 58,112 rows
    that once filled a block's shared memory gets as far as the device
    check, and the CPU route merges it."""
    assert not hasattr(tdedup, "MAX_BATCH")
    cap, b = 64, 60000
    hist, new, pos = _mk(np.random.RandomState(2), cap, b, 40)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tdedup.merge_rows_cuda(_t_rows(hist), _t_rows(new), T(pos))
    out = tdedup.merge_rows_kernel(_t_rows(hist), _t_rows(new), T(pos))
    assert_rows_equal(out, block_merge(_t_rows(hist), _t_rows(new), T(pos),
                                       128))


# -- the merge kernel's block algorithm, in plain torch ------------------------------
def multiway_lower_bound(pos, p0, ways):
    """#{i : pos[i] < p0} as one warp of the kernel finds it: each round
    probes `ways` evenly spaced entries of the range the answer can still
    lie in and keeps one gap.  -> (the count, the rounds taken)."""
    lo, hi, rounds = 0, len(pos), 0
    while lo < hi:
        n = hi - lo
        step = -(-n // ways)
        probes = lo + (np.arange(ways) + 1) * step - 1
        below = np.zeros(ways, bool)
        ok = probes < hi
        below[ok] = pos[probes[ok]] < p0
        cnt = int(below.sum())
        assert below[:cnt].all()            # a prefix: pos is increasing
        nxt = lo + (cnt + 1) * step - 1
        lo += cnt * step
        hi = min(hi, nxt)
        rounds += 1
    return lo, rounds


def block_merge(hist, new, pos_new, rows, ways=128):
    """The merge as the kernel's blocks do it, `rows` output rows a block:
    the block's window of `pos_new` starts at lo = #{pos_new < p0} and
    holds at most `rows` entries; entry i marks slot[pos_new[i] - p0] =
    i + 1; a marked row comes from new row slot - 1, any other from
    history row p - (lo + the marks before it)."""
    cap, b = hist[0].shape[0], new[0].shape[0]
    pos = pos_new.numpy().astype(np.int64)
    out = tuple(torch.empty_like(h) for h in hist)
    both = tuple(torch.cat([n, h]) for h, n in zip(hist, new))
    for p0 in range(0, cap, rows):
        lo, _ = multiway_lower_bound(pos, p0, ways)
        assert lo == np.searchsorted(pos, p0, side="left")
        slot = np.zeros(rows, np.int64)
        i = lo + np.arange(rows)
        i = i[i < b]                        # thread t reads pos_new[lo + t]
        i = i[pos[i] - p0 < rows]
        assert (pos[i] >= p0).all()
        slot[pos[i] - p0] = i + 1
        is_new = slot != 0
        before = np.cumsum(is_new) - is_new
        p = p0 + np.arange(rows)
        src_hist = p - (lo + before)
        live = p < cap
        assert ((src_hist >= 0) & (src_hist < cap))[live & ~is_new].all()
        src = torch.from_numpy(np.where(is_new, slot - 1, b + src_hist)[live])
        for o, rows_both in zip(out, both):
            o[p0:p0 + int(live.sum())] = rows_both[src]
    return out


def assert_rows_equal(got, want):
    for name, g, w in zip(("h0", "h1", "qor", "age"), got, want):
        assert_bitwise(N(w), N(g), name)


def _edge(case):
    """(hist, new, pos) of one edge of the merge, as numpy rows."""
    rng = np.random.RandomState(len(case))
    if case == "empty_batch":
        return _mk(rng, 300, 0, 200)
    if case == "one_row":
        hist, new, _ = _mk(rng, 300, 1, 200, sent_batch=0)
        new = (np.array([hist[0][77]], np.uint32),) + new[1:]   # an equal h0
        pos = np.array([np.searchsorted(hist[0], new[0][0], side="right")],
                       np.int32)
        return hist, new, pos
    if case == "past_cap_truncated":        # a full history: most rows drop
        return _mk(rng, 300, 250, 300)
    if case == "batch_larger_than_cap":
        return _mk(rng, 300, 1000, 260)
    if case == "cap_not_a_multiple_of_rows":
        return _mk(rng, 515, 130, 400)
    cap, b = 256, 256
    hist, new, _ = _mk(rng, cap, b, cap, sent_batch=0)
    if case == "new_before_history":
        h0s, h0 = np.sort(new[0] % 1000), np.sort(hist[0] % 1000 + 5000)
    elif case == "new_after_history":
        h0s, h0 = np.sort(new[0] % 1000 + 5000), np.sort(hist[0] % 1000)
    else:
        assert case == "equal_h0_old_first"
        h0 = np.sort(hist[0] % 7)           # long runs of equal h0
        h0s = np.sort(new[0] % 7)
    h0, h0s = h0.astype(np.uint32), h0s.astype(np.uint32)
    pos = (np.arange(b) + np.searchsorted(h0, h0s, side="right")).astype(
        np.int32)
    return (h0,) + hist[1:], (h0s,) + new[1:], pos


@pytest.mark.parametrize("rows", [4, 128, 256])
@pytest.mark.parametrize("case", [
    "empty_batch", "one_row", "new_before_history", "new_after_history",
    "past_cap_truncated", "equal_h0_old_first", "batch_larger_than_cap",
    "cap_not_a_multiple_of_rows"])
def test_block_merge_matches_merge_rows(case, rows):
    hist, new, pos = _edge(case)
    want = tdedup.merge_rows(_t_rows(hist), _t_rows(new), T(pos))
    got = block_merge(_t_rows(hist), _t_rows(new), T(pos), rows)
    assert_rows_equal(got, want)
    if case == "equal_h0_old_first":        # old rows before new on equal h0
        age, h0 = N(want[3]), N(want[0])
        for v in np.unique(h0):
            run = age[h0 == v]
            assert (np.diff((run == 50).astype(int)) >= 0).all()
    if case == "new_before_history":
        assert (N(want[3]) == 50).all()
    if case == "new_after_history":
        assert (N(want[3]) != 50).all()


@pytest.mark.parametrize("b,ways,rounds", [
    (0, 128, 0), (1, 128, 1), (128, 128, 1), (129, 128, 2), (6040, 128, 2),
    (6040, 32, 3), (16384, 128, 2), (70000, 128, 3), (1000, 2, 10)])
def test_multiway_search_is_a_lower_bound(b, ways, rounds):
    """The search gives numpy's left searchsorted for every target, in at
    most ceil(log_ways(b + 1)) rounds (two at the flagship's b = 6040)."""
    rng = np.random.RandomState(b + ways)
    pos = np.cumsum(rng.randint(1, 4, b)).astype(np.int64)
    worst = 0
    targets = np.unique(np.concatenate([
        [0, 1, int(pos[-1]) + 5 if b else 3], rng.choice(pos, min(b, 200)),
        rng.choice(pos, min(b, 200)) + 1])) if b else np.array([0, 3])
    for p0 in targets:
        lo, took = multiway_lower_bound(pos, int(p0), ways)
        assert lo == np.searchsorted(pos, p0, side="left")
        worst = max(worst, took)
    assert worst <= rounds


def test_history_insert_contains_with_eviction():
    """Five inserts of 600 rows (~480 valid) into a 2048-row history:
    eviction runs, and the whole HistState plus every contains() answer
    and dup_source() stay bitwise equal."""
    cap = 2048
    hj, ht = JHistory(cap, "xla"), THistory(cap, device="cpu")
    stj, stt = hj.init(), ht.init()
    ins_j = jax.jit(hj.insert)
    rng = np.random.RandomState(17)
    for _ in range(5):
        hashes = rng.randint(0, 2**31, (600, 2)).astype(np.uint32)
        # re-propose some known rows, and some in-batch duplicates
        hashes[:40] = np.asarray(stj.h0[:40:1]).astype(np.uint32)[:, None]
        hashes[:40, 1] = np.asarray(stj.h1[:40])
        hashes[100:120] = hashes[200:220]
        qor = rng.randn(600).astype(np.float32)
        valid = rng.rand(600) > 0.2
        fj, qj = hj.contains(stj, jnp.asarray(hashes))
        ft, qt = ht.contains(stt, T(hashes))
        assert_bitwise(fj, N(ft), "found")
        assert_bitwise(qj, N(qt), "known_qor")
        assert_bitwise(j_dup_source(jnp.asarray(hashes)),
                       N(t_dup_source(T(hashes))), "dup_source")
        stj = ins_j(stj, jnp.asarray(hashes), jnp.asarray(qor),
                    jnp.asarray(valid))
        stt = ht.insert(stt, T(hashes), T(qor), T(valid))
        for name, a, c in zip(HIST_FIELDS, stj, stt):
            assert_bitwise(a, N(c), name)
    assert int(stt.dropped) > 0
    assert int(stt.n) == cap
    h0 = N(stt.h0)
    assert (np.diff(h0) >= 0).all()


def test_dup_source_and_unique_mask():
    """Many duplicates, including h0 ties with distinct h1 and hashes
    above 2^31 (an int32 view would order those first)."""
    rng = np.random.RandomState(3)
    base = rng.randint(0, 2**32, (50, 2)).astype(np.uint32)
    base[:10, 0] = 0xFFFFFFF0          # shared h0, distinct h1
    hashes = base[rng.randint(0, 50, 700)]
    src_j = np.asarray(j_dup_source(jnp.asarray(hashes)))
    src_t = N(t_dup_source(T(hashes)))
    assert_bitwise(src_j, src_t, "dup_source")
    assert src_t.dtype == np.int32
    first = N(t_unique_mask(T(hashes)))
    assert first.sum() == len({tuple(r) for r in hashes.tolist()})
    assert (src_t <= np.arange(700)).all()
