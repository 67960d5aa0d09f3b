"""The port's results store (uptune_tpu_torch/store/) against the JAX
package's: the same keys, and a store directory written by either
package read by the other with hits on the same configs."""
import sys

import pytest

from uptune_tpu.space import params as JP
from uptune_tpu.space.spec import Space as JSpace
from uptune_tpu.store import ResultStore as JStore
from uptune_tpu.store import keys as jk

from uptune_tpu_torch.space import params as TP
from uptune_tpu_torch.space.spec import Space as TSpace
from uptune_tpu_torch.store import ResultStore as TStore
from uptune_tpu_torch.store import keys as tk
from uptune_tpu_torch.store import open_store

CONFIGS = [
    {"x": 1, "y": 2.5, "e": "-O2"},
    {"y": 2.5, "x": 1, "e": "-O2"},          # key order does not matter
    {"x": -0.0, "flag": True, "none": None},
    {"perm": (3, 1, 2), "nested": [[1, 2], (3,)], "big": 2 ** 40},
    {"f": 0.1 + 0.2, "s": "a b", "u": "é"},
]


def _specs(P):
    return [P.IntParam("x", 0, 9), P.FloatParam("y", 0.0, 4.0),
            P.EnumParam("e", ("-O1", "-O2", "-O3"))]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_canon_config_and_trial_key_equal(cfg):
    assert jk.canon_config(cfg) == tk.canon_config(cfg)
    assert jk.trial_key("abc", cfg) == tk.trial_key("abc", cfg)


@pytest.mark.parametrize("stage,extra_env", [
    (0, None), (1, {"CFLAGS": "-O3"}), (0, {"PYTHONPATH": "/elsewhere"})])
def test_eval_signature_and_scope_equal(tmp_path, stage, extra_env):
    prog = tmp_path / "prog.py"
    prog.write_text("print(1)\n")
    tpl = tmp_path / "prog.tpl"
    tpl.write_text("x = 1\n")
    cmd = [sys.executable, str(prog), "--flag"]
    sj = jk.eval_signature(cmd, stage, [str(tpl)], extra_env)
    st = tk.eval_signature(cmd, stage, [str(tpl)], extra_env)
    assert sj == st
    # the interpreter collapses to "python" and the program to its
    # content hash: the same scope from the same space in each package
    assert '"python"' in st and "file:prog.py:" in st
    sig_j = JSpace(_specs(JP)).signature()
    sig_t = TSpace(_specs(TP)).signature()
    assert sig_j == sig_t
    assert jk.scope_id(sig_j, sj) == tk.scope_id(sig_t, st)


ROWS = [({"x": i, "y": 0.5 * i, "e": "-O2"}, float(10 - i)) for i in range(6)]


@pytest.mark.parametrize("writer,reader", [(JStore, TStore),
                                           (TStore, JStore)])
def test_store_read_across_packages(tmp_path, writer, reader):
    """Rows recorded (with unit vectors, a failure, a re-record) by one
    package's store are served by the other's: the same hits and
    misses, the same scope rows and best."""
    prog = tmp_path / "prog.py"
    prog.write_text("print(1)\n")
    cmd = [sys.executable, str(prog)]
    sig = TSpace(_specs(TP)).signature()
    base = str(tmp_path / "store")
    w = writer(base, sig, cmd)
    for i, (cfg, q) in enumerate(ROWS):
        w.record(cfg, q, 0.25 * i, u=[0.1 * i, 0.5, 0.25], perms=[])
    w.record({"x": 9, "y": 4.0, "e": "-O3"}, None, 1.0)    # a failure
    assert w.record(ROWS[0][0], 99.0) is None              # kept: finite
    w.close()
    r = reader(base, sig, cmd)
    assert r.scope == w.scope and len(r) == len(ROWS) + 1
    for cfg, q in ROWS:
        row = r.lookup(cfg)
        assert row is not None and row["qor"] == q and row["cfg"] == cfg
    assert r.lookup({"x": 9, "y": 4.0, "e": "-O3"}) is None
    assert r.lookup({"x": 8, "y": 0.0, "e": "-O1"}) is None
    assert sorted(x["qor"] for x in r.scope_rows()) == sorted(
        q for _, q in ROWS)
    assert r.best_row("min")["cfg"] == ROWS[-1][0]
    assert r.best_row("max")["cfg"] == ROWS[0][0]
    assert r.lookup(ROWS[2][0])["u"] == [0.2, 0.5, 0.25]
    # another program's scope sees nothing of it
    other = tmp_path / "other.py"
    other.write_text("print(2)\n")
    assert reader(base, sig, [sys.executable, str(other)]).lookup(
        ROWS[0][0]) is None
    r.close()


def test_sibling_rows_are_fresh_across_packages(tmp_path):
    """Two instances, one of each package, on one directory: a refresh
    brings the other's appends as fresh foreign rows."""
    prog = tmp_path / "prog.py"
    prog.write_text("print(1)\n")
    cmd = [sys.executable, str(prog)]
    sig = TSpace(_specs(TP)).signature()
    base = str(tmp_path / "store")
    a, b = JStore(base, sig, cmd), TStore(base, sig, cmd)
    a.record(ROWS[1][0], ROWS[1][1])
    assert b.refresh() == 1
    assert [r["cfg"] for r in b.pop_fresh_rows()] == [ROWS[1][0]]
    b.record(ROWS[2][0], ROWS[2][1])
    assert a.refresh() == 1 and a.lookup(ROWS[2][0])["qor"] == ROWS[2][1]
    a.close()
    b.close()


def test_open_store_refuses_a_store_server(tmp_path):
    """A tcp:// base is no longer refused: it opens a `RemoteStore` on
    the store server (item 7), a directory a `ResultStore`."""
    from uptune_tpu_torch.store.remote import RemoteStore
    from uptune_tpu_torch.store.server import StoreServer
    sig = TSpace(_specs(TP)).signature()
    srv = StoreServer("127.0.0.1", 0, str(tmp_path / "srv")).start()
    try:
        rt = open_store(f"tcp://127.0.0.1:{srv.port}", sig, ["prog"])
        try:
            assert isinstance(rt, RemoteStore) and rt.connected and bool(rt)
        finally:
            rt.close()
    finally:
        srv.stop()
    st = open_store(str(tmp_path / "s"), sig, ["prog"])
    assert isinstance(st, TStore) and bool(st)
    st.close()
