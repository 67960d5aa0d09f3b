"""The port's observability plane (`uptune_tpu_torch/obs/`) held to the
reference's own contracts: every test body of tests/test_obs.py,
test_obs_distributed.py and test_quality.py that exercises the plane
alone is run here with the reference module's `obs`, `flight`, `merge`,
`sidecar`, `journal`, `quality` and `report` names pointed at the port's
modules, and `top` and the serving plane's cases (TestTop, TestTopJson,
TestServeHealth) with the JAX package's modules they import pointed at
the port's (test_torch_serve's `point_at_port`, servers on the CPU).  The
cases that need the JAX driver are not run here; the port's
counterparts of the driver and pool cases are in
tests/test_torch_obs_e2e.py, of test_device.py in
tests/test_torch_obs_device.py, of the fleet's in
tests/test_torch_fleet.py."""
import inspect
import sys

import pytest

import test_obs as ref_obs
import test_obs_distributed as ref_dist
import test_quality as ref_quality

from uptune_tpu_torch import obs
from uptune_tpu_torch.obs import (flight, journal, merge, quality, report,
                                  sidecar, top)

from test_torch_serve import point_at_port

# the reference test modules' names for the plane, and the port's
PORT = {"obs": obs, "flight": flight, "merge": merge, "sidecar": sidecar,
        "journal": journal, "quality": quality, "obs_report": report,
        "top": top, "QualityConfig": quality.QualityConfig,
        "SessionQuality": quality.SessionQuality}
MODULES = {"test_obs": ref_obs, "test_obs_distributed": ref_dist,
           "test_quality": ref_quality}

CASES = {
    "test_obs": {
        "TestCore": ["test_disabled_path_records_nothing",
                     "test_span_event_metrics_roundtrip",
                     "test_ring_wraps_and_counts_drops",
                     "test_concurrent_writers_lose_nothing",
                     "test_enable_cycle_isolates_runs"],
        "TestExport": ["test_trace_schema_roundtrip",
                       "test_validate_rejects_malformed",
                       "test_committed_example_trace_validates",
                       "test_text_summary_mentions_spans_and_drops"],
    },
    "test_obs_distributed": {
        "TestCoreAdditions": ["test_span_ids_unique_and_pid_tagged",
                              "test_emit_at_places_events_on_explicit_ts",
                              "test_emit_at_disabled_is_inert"],
        "TestSidecar": ["test_dump_read_roundtrip_and_merge_alignment",
                        "test_read_tolerates_garbage_and_torn_tails",
                        "test_merge_into_disabled_or_missing_is_zero",
                        "test_maybe_init_child_env_gate"],
        "TestFlightRecorder": [
            "test_timeline_rows_lose_nothing_under_concurrency",
            "test_rotation_caps_the_file",
            "test_finish_settles_recorder_not_legacy_row",
            "test_window_snapshot_cursor_math"],
        "TestPrometheus": ["test_exposition_families",
                           "test_name_sanitization"],
        "TestMerge": ["test_merge_aligns_clocks_and_namespaces_pids",
                      "test_merge_accepts_sidecar_shards",
                      "test_client_server_joins_annotated",
                      "test_cli_merge_and_validate",
                      "test_committed_merged_artifact_is_valid"],
        "TestExitFlush": ["test_flush_all_writes_trace_and_final_row"],
        "TestTop": ["test_render_shows_vitals_and_rates",
                    "test_render_missing_families_degrade_to_dash",
                    "test_rates_fall_back_to_poll_diffs",
                    "test_once_over_metrics_file",
                    "test_ut_cli_dispatches_top"],
    },
    "test_quality": {
        "TestJournal": ["test_disabled_is_noop",
                        "test_round_trip_header_and_rows",
                        "test_torn_tail_tolerated_lenient_rejected_strict",
                        "test_strict_rejects_unknown_kind",
                        "test_sink_sees_rows_before_serialization",
                        "test_buffered_rows_flush_on_stop"],
        "TestQualityMonitor": [
            name for name, _ in inspect.getmembers(
                ref_quality.TestQualityMonitor, inspect.isfunction)
            if name.startswith("test_")],
        "TestCommittedExamples": ["test_journal_example_schema_valid",
                                  "test_report_renders_from_committed_journal"],
        "TestServeHealth": ["test_health_op_per_session_and_rollup",
                            "test_failing_session_and_bad_threshold",
                            "test_local_session_health_and_journal_rows"],
        "TestTopJson": ["test_json_once_frame", "test_json_requires_once",
                        "test_search_panel_renders"],
    },
}
PARAMS = [(m, c, n) for m, classes in CASES.items()
          for c, names in classes.items() for n in names]


@pytest.fixture
def port_plane(monkeypatch):
    """Point the reference test modules at the port's plane (and the JAX
    package's modules their bodies import at the port's, the servers on
    the CPU), reset it around the case, and close any journal the case
    left open."""
    point_at_port(monkeypatch, [])
    monkeypatch.setitem(sys.modules, "uptune_tpu.obs.top", top)
    for mod in MODULES.values():
        for name, value in PORT.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, value)
    obs.reset()
    yield
    journal.stop()
    obs.reset()


@pytest.mark.parametrize("module,cls,name", PARAMS,
                         ids=[f"{m}::{c}::{n}" for m, c, n in PARAMS])
def test_reference_contract(port_plane, module, cls, name, request):
    case = getattr(getattr(MODULES[module], cls)(), name)
    kwargs = {p: request.getfixturevalue(p)
              for p in inspect.signature(case).parameters}
    case(**kwargs)


def test_the_cases_cover_every_plane_only_reference_test():
    """Every reference test class left out above needs the JAX driver,
    its worker pool or its trace guard (the port's counterparts are in
    tests/test_torch_obs_e2e.py), or is the slow-marked subprocess pair;
    the classes run here are run whole (TestCore, TestExport, TestTop,
    ...), so a new reference case of theirs shows up as a missing one."""
    left_out = {"TestStructural", "TestGuardMerge", "TestSubprocessE2E",
                "TestDriverJournal", "TestFeatureInterm"}
    for module, mod in MODULES.items():
        for cname, klass in inspect.getmembers(mod, inspect.isclass):
            if not cname.startswith("Test") or klass.__module__ != module:
                continue
            tests = {n for n, _ in inspect.getmembers(klass,
                                                      inspect.isfunction)
                     if n.startswith("test_")}
            if cname in left_out:
                assert cname not in CASES[module]
                continue
            assert set(CASES[module][cname]) == tests, (module, cname)


def test_public_names_equal_the_reference():
    """`obs.__all__` is the reference's, and each module the plane ports
    exports the reference module's names (device.py adds `set_cost`)."""
    import uptune_tpu.obs as jobs
    assert sorted(obs.__all__) == sorted(jobs.__all__)
    import importlib
    for name in ("core", "metrics", "export", "journal", "quality",
                 "faults", "flight", "sidecar", "ship", "merge", "report",
                 "device"):
        ref = importlib.import_module(f"uptune_tpu.obs.{name}")
        mine = importlib.import_module(f"uptune_tpu_torch.obs.{name}")
        want = set(getattr(ref, "__all__", ())) or {
            n for n in vars(ref) if not n.startswith("_")
            and callable(getattr(ref, n))
            and getattr(getattr(ref, n), "__module__", "") == ref.__name__}
        missing = {n for n in want if not hasattr(mine, n)}
        assert not missing, (name, missing)
