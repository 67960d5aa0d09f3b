"""Parity of the port's feature screen (`uptune_tpu_torch/surrogate/
screen.py`) with the JAX package's, on the CPU.

`lane_sensitivity` and `build_screen` are host numpy in both packages and
must agree bitwise.  `archive_rows` rebuilds an archive's rows through
each package's own `Space` (the port on CPU tensors): read from an
archive the JAX Tuner wrote, the screens built from it have equal lane
indices, block widths and flip weights, and scores and lane weights
within 1e-12 (the snapped numeric lanes go through each package's
codec transcendentals, a few ulps apart; the sensitivities are float64
sums over them).
"""
import json

import numpy as np
import pytest

from uptune_tpu.driver import Tuner as JTuner
from uptune_tpu.surrogate import screen as jscreen
from uptune_tpu.surrogate.manager import SurrogateManager as JManager

from uptune_tpu_torch.space import params as TP
from uptune_tpu_torch.space.spec import Space as TSpace
from uptune_tpu_torch.surrogate import screen as tscreen
from uptune_tpu_torch.surrogate.manager import SurrogateManager as TManager

from test_torch_driver import _spaces, objective
from test_torch_driver import untraced_planes  # noqa: F401 (autouse)

SCORE_ATOL = 1e-12


@pytest.fixture(scope="module")
def spaces():
    return _spaces()


@pytest.fixture(scope="module")
def archive(tmp_path_factory, spaces):
    """An archive of 120 evaluations the JAX Tuner wrote (one arm)."""
    path = tmp_path_factory.mktemp("screen") / "jax.jsonl"
    t = JTuner(spaces[0], objective, technique="UniformGreedyMutation10",
               seed=2, capacity=1024, archive=str(path))
    t.run(test_limit=120)
    t.close()
    return str(path)


def sources(space_t, seed=0, n=60):
    """Seeded (surrogate features, QoR) sources over a space's full
    surrogate representation, with failed rows."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        f = rs.rand(n, space_t.n_surrogate_features)
        q = f[:, 0] * 3.0 - f[:, -2] + 0.1 * rs.randn(n)
        q[rs.randint(0, n, 4)] = np.inf
        out.append((f.astype(np.float32), q))
    return out


def assert_screens_equal(sj, st, exact=True):
    np.testing.assert_array_equal(st.idx, sj.idx)
    assert (st.n_cont, st.n_cat) == (sj.n_cont, sj.n_cat)
    np.testing.assert_array_equal(st.cat_weight, sj.cat_weight)
    if exact:
        np.testing.assert_array_equal(st.scores, sj.scores)
        np.testing.assert_array_equal(st.lane_weight, sj.lane_weight)
    else:
        np.testing.assert_allclose(st.scores, sj.scores, rtol=0,
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(st.lane_weight, sj.lane_weight, rtol=0,
                                   atol=SCORE_ATOL)


def test_lane_sensitivity_bitwise():
    rs = np.random.RandomState(3)
    f = rs.rand(80, 9).astype(np.float32)
    f[:, 4] = 0.5                                   # a dead lane
    q = f[:, 1] - 2 * f[:, 7] + 0.05 * rs.randn(80)
    q[[5, 9]] = np.nan
    np.testing.assert_array_equal(tscreen.lane_sensitivity(f, q),
                                  jscreen.lane_sensitivity(f, q))
    np.testing.assert_array_equal(tscreen.lane_sensitivity(f[:3], q[:3]),
                                  np.zeros(9))


@pytest.mark.parametrize("top", [(2, 1), (16, 24)])
def test_build_screen_bitwise(spaces, top):
    sj, st = spaces
    src = sources(st)
    assert_screens_equal(jscreen.build_screen(sj, src, *top),
                         tscreen.build_screen(st, src, *top))
    with pytest.raises(ValueError, match="at least one source"):
        tscreen.build_screen(st, [])


def test_screen_from_a_jax_archive(spaces, archive):
    sj, st = spaces
    fj, qj = jscreen.archive_rows(sj, archive)
    ft, qt = tscreen.archive_rows(st, archive)
    assert ft.shape == fj.shape and len(qt) == 120
    np.testing.assert_array_equal(qt, qj)
    # one-hot block and perm positions exact, snapped numerics to ulps
    nc = st.n_cont_features - st.perm_sizes[0]
    np.testing.assert_array_equal(ft[:, nc:], fj[:, nc:])
    np.testing.assert_allclose(ft[:, :nc], fj[:, :nc], rtol=0, atol=1e-6)
    screen_j = jscreen.screen_from_archives(sj, [archive], 3, 1)
    screen_t = tscreen.screen_from_archives(st, [archive], 3, 1)
    assert_screens_equal(screen_j, screen_t, exact=False)
    assert screen_t.n_cont == 3 and screen_t.n_cat == 1


def test_short_missing_or_empty_archives_give_none(spaces, archive,
                                                   tmp_path):
    sj, st = spaces
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    short = tmp_path / "short.jsonl"
    with open(archive) as f:
        short.write_text("".join(f.readlines()[:4]))   # header + 3 rows
    paths = [str(tmp_path / "missing.jsonl"), str(empty), str(short)]
    assert tscreen.screen_from_archives(st, paths) is None
    assert jscreen.screen_from_archives(sj, paths) is None
    # the manager warns with the JAX package's text and runs unscreened
    with pytest.warns(UserWarning) as wj:
        JManager(sj, "gp", screen={"archives": paths})
    with pytest.warns(UserWarning) as wt:
        m = TManager(st, "gp", screen={"archives": paths}, device="cpu")
    assert [str(w.message) for w in wt] == [str(w.message) for w in wj]
    assert "running UNSCREENED" in str(wt[0].message)
    assert m.screen is None and m._n_cont == st.n_cont_features


def test_a_mismatched_space_raises(archive):
    other = TSpace([TP.FloatParam("x0", 0.0, 1.0)])
    with pytest.raises(ValueError, match="recorded for a different space"):
        tscreen.archive_rows(other, archive)


def test_rows_short_on_perm_blocks_are_skipped(spaces, archive, tmp_path):
    sj, st = spaces
    lines = open(archive).read().splitlines()
    bad = json.loads(lines[1])
    bad["perms"] = []
    path = tmp_path / "torn.jsonl"
    path.write_text("\n".join(lines[:1] + [json.dumps(bad)] + lines[2:10]
                              + ["{not json"]) + "\n")
    ft, qt = tscreen.archive_rows(st, str(path))
    fj, qj = jscreen.archive_rows(sj, str(path))
    assert len(qt) == len(qj) == 8
    np.testing.assert_array_equal(qt, qj)
