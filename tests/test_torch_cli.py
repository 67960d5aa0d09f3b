"""The port's command line (`python -m uptune_tpu_torch.cli`, `ut-torch`)
on the CPU (`--device cpu`): the unchanged samples tune under it, its
listings equal the JAX package's `ut`, the switches it does not have yet
are refused with code 2, it never falls back to the CPU on its own, and
an archive written by either CLI resumes under the other.  A traced,
journaled run through the CLI is tests/test_torch_obs_e2e.py's."""
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import uptune_tpu_torch
from uptune_tpu.exec.space_io import stage_spaces as j_stage_spaces
from uptune_tpu.techniques.base import (all_technique_names,
                                        is_experimental)

from uptune_tpu_torch import cli
from uptune_tpu_torch.api import session as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(
    uptune_tpu_torch.__file__)))
SAMPLES = os.path.join(REPO, "samples")
ROSEN = os.path.join(SAMPLES, "rosenbrock", "rosenbrock.py")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for v in ("UT_BEFORE_RUN_PROFILE", "UT_TUNE_START", "BEST",
              "UT_WORK_DIR") + cli.OBS_ENV:
        monkeypatch.delenv(v, raising=False)
    TS.reset_settings()
    yield
    TS.reset_settings()


def _run(pkg, args, cwd):
    env = {k: v for k, v in os.environ.items()
           if k not in ("UT_BEFORE_RUN_PROFILE", "UT_TUNE_START", "BEST",
                        "UT_WORK_DIR")}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-m", f"{pkg}.cli"] + args,
                          capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=300)


def _last_json(out):
    return json.loads(out.stdout.strip().splitlines()[-1])


def _archive(path):
    return [json.loads(x) for x in open(path)][1:]


def test_rosenbrock_sample_tunes_and_applies_best(tmp_path):
    """The unchanged sample (its child imports the JAX package) tunes
    through the port's CLI on the CPU: 40 told trials of distinct
    configurations, best.json equal to the printed result and no worse
    than the default; --apply-best runs the program on that best."""
    shutil.copy(ROSEN, tmp_path / "rosenbrock.py")
    out = _run("uptune_tpu_torch", ["rosenbrock.py", "-pf", "4",
                                    "--test-limit", "40", "--seed", "0",
                                    "--device", "cpu"], str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    last = _last_json(out)
    default = json.load(open(tmp_path / "ut.default_qor.json"))["qor"]
    assert math.isfinite(last["best_qor"]) and last["best_qor"] <= default
    assert last["evals"] == 40
    rows = _archive(tmp_path / "ut.archive.jsonl")
    assert len(rows) == 40
    assert len({json.dumps(r["cfg"], sort_keys=True) for r in rows}) == 40
    best = json.load(open(tmp_path / "best.json"))
    assert best == {"config": last["best_config"], "qor": last["best_qor"]}
    applied = _run("uptune_tpu_torch", ["rosenbrock.py", "--apply-best"],
                   str(tmp_path))
    assert applied.returncode == 0, applied.stderr[-2000:]
    assert applied.stdout.split() == ["rosenbrock:", repr(last["best_qor"])]


def test_archives_resume_across_clis(tmp_path):
    """The JAX CLI tunes 16 trials; the port's resumes its archive to 24
    (building no archived configuration again); the JAX CLI then resumes
    the port's rows at 24 with the same evals and best as the port."""
    shutil.copy(ROSEN, tmp_path / "rosenbrock.py")
    base = ["rosenbrock.py", "-pf", "2", "--seed", "4", "--store", "off"]
    j1 = _run("uptune_tpu", base + ["--test-limit", "16"], str(tmp_path))
    assert j1.returncode == 0, j1.stderr[-2000:]
    first = _archive(tmp_path / "ut.archive.jsonl")
    assert len(first) == 16
    t = _run("uptune_tpu_torch", base + ["--test-limit", "24", "--resume",
                                         "--device", "cpu"], str(tmp_path))
    assert t.returncode == 0, t.stderr[-2000:]
    rows = _archive(tmp_path / "ut.archive.jsonl")
    assert rows[:16] == first and len(rows) == 24
    assert len({json.dumps(r["cfg"], sort_keys=True) for r in rows}) == 24
    lt = _last_json(t)
    assert lt["evals"] == 24
    assert lt["best_qor"] <= _last_json(j1)["best_qor"]
    # the tuner keeps its best in float32, as the JAX one does
    assert lt["best_qor"] == float(np.float32(min(
        r["qor"] for r in rows if r["qor"] is not None)))
    j2 = _run("uptune_tpu", base + ["--test-limit", "24", "--resume"],
              str(tmp_path))
    assert j2.returncode == 0, j2.stderr[-2000:]
    assert _last_json(j2) == lt
    assert len(_archive(tmp_path / "ut.archive.jsonl")) == 24


def test_list_techniques_equals_the_reference(capsys):
    assert cli.main(["--list-techniques"]) == 0
    want = [f"{n}  [experimental]" if is_experimental(n) else n
            for n in all_technique_names()]
    assert capsys.readouterr().out.splitlines() == want


def test_print_search_space_size_equals_the_reference(tmp_path, capsys):
    shutil.copy(os.path.join(SAMPLES, "hash", "single_stage.py"),
                tmp_path / "prog.py")
    assert cli.main([str(tmp_path / "prog.py"),
                     "--print-search-space-size"]) == 0
    got = capsys.readouterr().out.splitlines()
    params = json.load(open(tmp_path / "ut.params.json"))
    want = []
    for s, space in enumerate(j_stage_spaces(params)):
        size = space.search_space_size()
        want.append(f"stage {s}: log10(size) = "
                    f"{math.log10(size) if size else 0:.2f}")
    assert got[-len(want):] == want


@pytest.mark.parametrize("sub", ["store"])
def test_subcommands_are_refused(sub, capsys):
    """No subcommand is refused any more: the last one, the store server
    (item 7), dispatches to the port's module, whose parser's `--help`
    names it and exits 0."""
    assert cli.REFUSED_SUBCOMMANDS == {}
    assert cli.SUBCOMMANDS[sub] == ("uptune_tpu_torch.store.server", "main")
    with pytest.raises(SystemExit) as e:
        cli.main([sub, "--help"])
    assert e.value.code == 0
    out, err = capsys.readouterr()
    assert out.startswith(f"usage: ut-torch {sub}")
    assert "ROADMAP Queue 1 item" not in err


@pytest.mark.parametrize("sub,module", [
    ("route", "uptune_tpu_torch.serve.router"),
    ("hub", "uptune_tpu_torch.obs.hub"),
    ("top", "uptune_tpu_torch.obs.top")])
def test_subcommands_dispatch(sub, module, capsys):
    """`ut-torch route|hub|top` reach the port's modules (the serving
    plane's router, the fleet hub, the dashboard): their parser's
    `--help` names the subcommand and exits 0."""
    assert cli.SUBCOMMANDS[sub] == (module, "main")
    with pytest.raises(SystemExit) as e:
        cli.main([sub, "--help"])
    assert e.value.code == 0
    assert capsys.readouterr().out.startswith(f"usage: ut-torch {sub}")


def test_top_and_hub_wait_for_the_serving_plane():
    """`top` and `hub` read and serve the serving plane's wire, and
    `route` is its router: they came with the rest of it (item 6b).
    With the store server (item 7) the port's subcommands are the JAX
    package's, each at the same relative module path."""
    import uptune_tpu.cli as jcli
    assert set(cli.SUBCOMMANDS) == set(jcli.SUBCOMMANDS)
    for sub, (mod, attr) in cli.SUBCOMMANDS.items():
        assert (mod.replace("uptune_tpu_torch.", "uptune_tpu."), attr) \
            == jcli.SUBCOMMANDS[sub]
    assert cli.REFUSED_SUBCOMMANDS == {}


def test_report_subcommand_renders_a_journal(tmp_path, capsys):
    """`ut-torch report` is the port's obs/report.py."""
    from uptune_tpu_torch import obs
    path = str(tmp_path / "j.jsonl")
    obs.journal.start(path)
    obs.journal.emit_row({"ev": "step", "step": 1, "arm": "a",
                          "evaluated": 1, "withdrawn": False,
                          "new_best": True, "best": 1.0, "evals": 1,
                          "gid0": 0, "qors": [1.0]})
    obs.journal.stop()
    assert cli.main(["report", path, "--format", "md", "-o", "-"]) == 0
    assert capsys.readouterr().out.startswith("# ut report")


@pytest.mark.parametrize("flag", ["--trace", "--journal",
                                  "--metrics-interval", "--metrics-rotate",
                                  "--telemetry", "--device-trace"])
def test_observability_flags_are_refused(flag, capsys):
    """None of the JAX package's observability flags is refused any
    more: each parses, as `off` or as a request, and the run goes on."""
    numeric = flag in ("--metrics-interval", "--metrics-rotate")
    for value in ("0" if numeric else "off", "1"):
        args = cli.build_parser().parse_args(["prog.py", flag, value])
        assert cli.refused(args) is None
        assert cli.main(["--list-techniques", flag, value]) == 0
    assert "refused" not in capsys.readouterr().err


@pytest.mark.parametrize("var", cli.OBS_ENV)
def test_observability_variables_are_refused(var, monkeypatch, capsys):
    monkeypatch.setenv(var, "1")
    assert cli.main(["--list-techniques"]) == 2
    err = capsys.readouterr().err
    assert var in err and "traces nothing" in err
    monkeypatch.setenv(var, "off")
    assert cli.main(["--list-techniques"]) == 0


@pytest.mark.parametrize("var", ["UT_TRACE", "UT_JOURNAL", "UT_TELEMETRY",
                                 "UT_DEVICE_TRACE"])
def test_observability_variables_are_taken(var, monkeypatch, capsys):
    monkeypatch.setenv(var, "1")
    assert var not in cli.OBS_ENV
    assert cli.main(["--list-techniques"]) == 0
    assert "refused" not in capsys.readouterr().err


def test_store_server_is_refused(tmp_path, capsys):
    """`--store tcp://HOST:PORT` is no longer refused: it reaches the
    controller, whose trials are recorded into the port's store server
    (`ut-torch store`).  A malformed address or mode still exits 2."""
    from uptune_tpu_torch.store.server import StoreServer
    prog = tmp_path / "prog.py"
    prog.write_text("print(1)\n")
    assert cli.main([str(prog), "--store", "sideways"]) == 2
    assert cli.main([str(prog), "--store", "tcp://127.0.0.1:nan"]) == 2
    assert "not a number" in capsys.readouterr().err
    shutil.copy(ROSEN, tmp_path / "rosenbrock.py")
    srv = StoreServer("127.0.0.1", 0, str(tmp_path / "srv")).start()
    try:
        rc = cli.main([str(tmp_path / "rosenbrock.py"), "--store",
                       f"tcp://127.0.0.1:{srv.port}", "--device", "cpu",
                       "--test-limit", "6", "-pf", "2"])
        assert rc == 0
        assert "refused" not in capsys.readouterr().err
        with srv._lock:
            assert srv.recorded >= 5 and srv.append_errors == 0
    finally:
        srv.stop()


def test_no_card_without_device_cpu_fails(tmp_path, capsys):
    """The port runs on the card by default and never falls back: on a
    host without one, a tune without --device cpu exits non-zero before
    its analysis run."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    shutil.copy(ROSEN, tmp_path / "rosenbrock.py")
    rc = cli.main([str(tmp_path / "rosenbrock.py"), "--test-limit", "2"])
    assert rc != 0
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "ut.params.json").exists()


def test_parser_matches_the_reference_but_device():
    """Every option of the JAX package's `ut` is an option of the port's,
    with the same defaults but --device's."""
    from uptune_tpu import cli as jcli
    jp, tp = jcli.build_parser(), cli.build_parser()
    jopts = {a.dest: a.default for a in jp._actions}
    topts = {a.dest: a.default for a in tp._actions}
    assert set(jopts) == set(topts)
    diff = {k for k in jopts if jopts[k] != topts[k]}
    assert diff == {"device"} and topts["device"] == "cuda"
    ns = tp.parse_args(["p.py", "--compile-cache-dir", "d", "-pf", "3"])
    assert ns.compile_cache_dir == "d" and ns.parallel_factor == 3


def test_seed_configuration_and_print_params(tmp_path, capsys):
    """--seed-configuration takes a config or a list of them (a
    malformed file is exit code 2, not a traceback), as the JAX CLI's;
    --print-params prints the analysed records."""
    prog = tmp_path / "prog.py"
    prog.write_text("import uptune_tpu_torch as ut\n"
                    "x = ut.tune(40, (0, 100), name='x')\n"
                    "ut.target(float(x), 'min')\n")
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    notlist = tmp_path / "notlist.json"
    notlist.write_text(json.dumps([1, 2]))
    for f in (bad, notlist):
        assert cli.main([str(prog), "--device", "cpu",
                         "--seed-configuration", str(f)]) == 2
    assert cli.main([str(prog), "--print-params"]) == 0
    out = capsys.readouterr().out
    assert json.loads(out[out.index("["):]) == [[
        {"name": "x", "type": "int", "default": 40, "lo": 0, "hi": 100}]]
