"""`ut-torch-stats` (`uptune_tpu_torch/utils/stats.py`) against the JAX
package's `ut-stats`, on the CPU, and tests/test_stats.py's bodies on
the port.

The archive is a real tune of the port's `Tuner` on the CPU (the
portfolio, so several techniques).  Both tools read it and print the
same bytes: the text report, `--json`, `--csv`, and the cross-run
comparison over two archives (text and `--csv`), in process and through
each package's `python -m` entry.
"""
import inspect
import os
import subprocess
import sys

import pytest

import test_stats as ref
import uptune_tpu.utils
from uptune_tpu.utils import stats as jstats
from uptune_tpu_torch.driver import Tuner
from uptune_tpu_torch.space.params import FloatParam
from uptune_tpu_torch.space.spec import Space
from uptune_tpu_torch.utils import stats as tstats

import test_torch_ops  # noqa: F401  (each worker's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tune(path, seed, limit):
    space = Space([FloatParam(f"x{i}", -2.0, 2.0) for i in range(3)])

    def obj(cfgs):
        return [sum(c[f"x{i}"] ** 2 for i in range(3)) for c in cfgs]

    t = Tuner(space, obj, seed=seed, archive=str(path), device="cpu")
    t.run(test_limit=limit)
    t.close()
    return str(path)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """test_stats.py's tune (3 floats, 200 trials) by the port's Tuner."""
    return _tune(tmp_path_factory.mktemp("arch") / "ut.archive.jsonl", 0,
                 200)


@pytest.fixture(scope="module")
def second(tmp_path_factory):
    return _tune(tmp_path_factory.mktemp("arch2") / "ut.archive.jsonl", 1,
                 60)


def run_main(mod, argv, capsys):
    rc = mod.main(argv)
    cap = capsys.readouterr()
    return rc, cap.out


@pytest.mark.parametrize("flags", [[], ["--json"], ["--sense", "max"]])
def test_report_bytes_equal(archive, flags, capsys):
    assert run_main(tstats, [archive] + flags, capsys) == run_main(
        jstats, [archive] + flags, capsys)


@pytest.mark.parametrize("multi", [False, True])
def test_csv_bytes_equal(archive, second, multi, tmp_path, capsys):
    arcs = [archive, second] if multi else [archive]
    outs = []
    for mod, name in ((jstats, "j.csv"), (tstats, "t.csv")):
        rc, text = run_main(mod, arcs + ["--csv", str(tmp_path / name)],
                            capsys)
        outs.append((rc, text, (tmp_path / name).read_bytes()))
    assert outs[0] == outs[1]
    assert outs[0][0] == 0 and outs[0][2].count(b"\n") > 1


def test_report_counts_every_row(archive):
    rows = tstats.load_archive(archive)
    rep = tstats.technique_report(rows)
    assert sum(st["evals"] for st in rep.values()) == len(rows) >= 200
    assert len(rep) >= 2


def test_entry_points_print_the_same(archive, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = []
    for pkg in ("uptune_tpu", "uptune_tpu_torch"):
        csv = tmp_path / f"{pkg}.csv"
        r = subprocess.run([sys.executable, "-m", f"{pkg}.utils.stats",
                            archive, "--csv", str(csv)], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        outs.append((r.stdout, csv.read_bytes()))
    assert outs[0] == outs[1]


# -- the reference's bodies on the port ---------------------------------------
def cpu_tuner(*args, **kw):
    return Tuner(*args, device="cpu", **kw)


PORT_NAMES = dict({n: getattr(tstats, n) for n in (
    "ArchiveTail", "convergence", "follow", "load_archive", "main",
    "render_table", "technique_report", "write_csv")},
    Tuner=cpu_tuner, Space=Space, FloatParam=FloatParam)
REF_CASES = ([(c, n) for c in ("TestLoadAndReport",
                               "TestConvergenceAndOutputs", "TestFollow",
                               "TestCompareMode")
              for n, _ in inspect.getmembers(getattr(ref, c),
                                             inspect.isfunction)
              if n.startswith("test_")]
             + [(None, n) for n, _ in inspect.getmembers(
                 ref, inspect.isfunction) if n.startswith("test_")])


@pytest.mark.parametrize("cls,name", REF_CASES)
def test_reference_body_on_the_port(cls, name, monkeypatch, request):
    for attr, value in PORT_NAMES.items():
        monkeypatch.setattr(ref, attr, value)
    monkeypatch.setattr(uptune_tpu.utils, "stats", tstats)
    monkeypatch.setitem(sys.modules, "uptune_tpu.utils.stats", tstats)
    case = (getattr(ref, name) if cls is None
            else getattr(getattr(ref, cls)(), name))
    case(**{p: request.getfixturevalue(p)
            for p in inspect.signature(case).parameters})
