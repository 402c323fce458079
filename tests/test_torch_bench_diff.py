"""The port's regression gate (``raft_tpu_torch.tools.bench_diff``) against
``tools/bench_diff.py``: every case of ``tests/test_bench_diff.py`` run
through both, with equal tables, regressions and exit codes; and a port
bench row diffed against a JAX bench row from the same small call, with no
row ``added`` or ``removed``."""

import json

import pytest

import raft_tpu_torch.tools.bench_diff as port_diff
import tools.bench_diff as jax_diff
from _torch_bench import rows


def _combined(p50, eps, extra=None):
    doc = {
        "metric": "commit_p50_latency", "value": p50, "unit": "us",
        "p99_us": p50 * 2, "entries_per_sec": eps,
        "configs": {
            "c2_batched": {"p50_us": p50, "p99_us": p50 * 2,
                           "entries_per_sec": eps},
            "attribution": {"wall_us_per_tick": 5000.0},
        },
    }
    if extra:
        doc["configs"].update(extra)
    return doc


def _legs(p50, eps):
    return {"c2_batched": {"p50_us": p50, "entries_per_sec": eps}}


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


# each case: (mod, tmp_path) -> a comparable result
def case_json_lines_stdout(mod, tmp_path):
    lines = [
        json.dumps({"leg": "c2_batched", "p50_us": 2.0,
                    "entries_per_sec": 1e6}),
        json.dumps({"leg": "overload", "goodput_eps": 12.0}),
        json.dumps(_combined(2.0, 1e6)),
    ]
    return mod.load_bench(_write(tmp_path, "run.json",
                                 "\n".join(lines) + "\n"))


def case_legs_only_no_combined(mod, tmp_path):
    return mod.load_bench(_write(tmp_path, "killed.json", json.dumps(
        {"leg": "c2_batched", "p50_us": 3.0})))


def case_wrapper_with_parsed(mod, tmp_path):
    return mod.load_bench(_write(tmp_path, "BENCH_r99.json", json.dumps({
        "n": 1, "cmd": "python bench.py", "rc": 0,
        "tail": "noise\n", "parsed": _combined(2.5, 9e5)})))


def case_wrapper_parsed_null_falls_back_to_tail(mod, tmp_path):
    tail = ("WARNING: noise\n"
            + json.dumps({"leg": "c4_slow", "p50_us": 7.0}) + "\n")
    return mod.load_bench(_write(tmp_path, "BENCH_rkill.json", json.dumps({
        "n": 1, "cmd": "x", "rc": 124, "tail": tail, "parsed": None})))


def case_not_a_bench_artifact(mod, tmp_path):
    p = _write(tmp_path, "junk.json", "not json at all")
    with pytest.raises(ValueError) as ex:
        mod.load_bench(p)
    return str(ex.value).replace(p, "<path>")


def case_real_repo_artifact_loads(mod, tmp_path):
    from pathlib import Path

    artifact = Path(__file__).resolve().parent.parent / "BENCH_r04.json"
    return mod.load_bench(str(artifact))


def _compare(mod, old, new, threshold=0.10):
    deltas, reg = mod.compare_runs(old, new, threshold)
    as_tuples = [(d.leg, d.metric, d.old, d.new, d.change, d.status,
                  d.gated) for d in deltas]
    return (as_tuples, [(d.leg, d.metric, d.status) for d in reg],
            mod.format_table(deltas, threshold))


def case_no_regression_within_threshold(mod, tmp_path):
    return _compare(mod, _legs(2.0, 1e6), _legs(2.1, 0.96e6))


def case_latency_regression_gates(mod, tmp_path):
    return _compare(mod, _legs(2.0, 1e6), _legs(2.5, 1e6))


def case_throughput_regression_gates_down(mod, tmp_path):
    return (_compare(mod, _legs(2.0, 1e6), _legs(2.0, 0.7e6)),
            _compare(mod, _legs(2.0, 1e6), _legs(1.0, 2e6)))


def case_added_removed_skipped_never_gate(mod, tmp_path):
    old = {"a": {"p50_us": 1.0}, "gone": {"p50_us": 1.0},
           "skip": {"p50_us": 1.0}}
    new = {"a": {"p50_us": 1.0}, "fresh": {"p50_us": 9.0},
           "skip": {"skipped": "deadline"}}
    return _compare(mod, old, new)


def case_ungated_metrics_ignored(mod, tmp_path):
    return _compare(mod, {"x": {"mystery_number": 1.0}},
                    {"x": {"mystery_number": 100.0}})


def case_macro_leg_gates(mod, tmp_path):
    old = {"macro_wire": {"e2e_p50_ms": 10.0, "e2e_p99_ms": 20.0,
                          "wire_goodput_ratio": 0.85, "shed_rate": 0.0}}
    worse = {"macro_wire": {"e2e_p50_ms": 15.0, "e2e_p99_ms": 30.0,
                            "wire_goodput_ratio": 0.60, "shed_rate": 0.9}}
    better = {"macro_wire": {"e2e_p50_ms": 5.0, "e2e_p99_ms": 9.0,
                             "wire_goodput_ratio": 1.0, "shed_rate": 0.0}}
    return _compare(mod, old, worse), _compare(mod, old, better)


def case_wire_trace_leg_gates(mod, tmp_path):
    old = {"macro_wire_traced": {
        "tracing_overhead_ratio": 0.97, "pump_coverage": 0.99,
        "coalesce_batch_p99": 15.0, "queue_age_p99_us": 1500.0}}
    worse = {"macro_wire_traced": {
        "tracing_overhead_ratio": 0.80, "pump_coverage": 0.60,
        "coalesce_batch_p99": 64.0, "queue_age_p99_us": 9000.0}}
    return _compare(mod, old, worse), _compare(mod, worse, old)


def case_format_table_mentions_threshold(mod, tmp_path):
    return _compare(mod, _legs(2.0, 1e6), _legs(2.5, 1e6))[2]


def _cli(mod, tmp_path, capsys, old_doc, new_doc, *flags):
    old = _write(tmp_path, "old.json", json.dumps(old_doc))
    new = _write(tmp_path, "new.json", json.dumps(new_doc))
    rc = mod.main([old, new, *flags])
    return rc, capsys.readouterr().out


def case_cli_exit_zero_clean(mod, tmp_path, capsys):
    return _cli(mod, tmp_path, capsys, _combined(2.0, 1e6),
                _combined(2.05, 1e6))


def case_cli_exit_one_on_regression(mod, tmp_path, capsys):
    return _cli(mod, tmp_path, capsys, _combined(2.0, 1e6),
                _combined(3.0, 1e6))


def case_cli_threshold_flag(mod, tmp_path, capsys):
    return (_cli(mod, tmp_path, capsys, _combined(2.0, 1e6),
                 _combined(2.4, 1e6)),
            _cli(mod, tmp_path, capsys, _combined(2.0, 1e6),
                 _combined(2.4, 1e6), "--threshold", "0.5"))


def case_newly_recompiling_leg_gates_and_is_named(mod, tmp_path):
    return _compare(mod, {"steady": {"compile_count": 0,
                                     "mem_high_water_bytes": 1000}},
                    {"steady": {"compile_count": 2,
                                "mem_high_water_bytes": 1000}})


def case_mem_high_water_gates_down(mod, tmp_path):
    old = {"steady": {"compile_count": 4, "mem_high_water_bytes": 1000}}
    worse = {"steady": {"compile_count": 4, "mem_high_water_bytes": 1500}}
    better = {"steady": {"compile_count": 0, "mem_high_water_bytes": 800}}
    return _compare(mod, old, worse), _compare(mod, old, better)


def case_old_artifact_without_columns_does_not_gate(mod, tmp_path):
    return _compare(mod, {"steady": {"p50_us": 2.0}},
                    {"steady": {"p50_us": 2.0, "compile_count": 7,
                                "mem_high_water_bytes": 123456}})


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")
         and not k.startswith("case_cli_")]
CLI_CASES = [v for k, v in sorted(globals().items())
             if k.startswith("case_cli_")]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_case_equal_through_both(case, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = case(jax_diff, tmp_path / "jax")
    got = case(port_diff, tmp_path / "port")
    assert got == want


@pytest.mark.parametrize("case", CLI_CASES, ids=lambda c: c.__name__[5:])
def test_cli_case_equal_through_both(case, tmp_path, capsys):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = case(jax_diff, tmp_path / "jax", capsys)
    got = case(port_diff, tmp_path / "port", capsys)
    assert got == want


def test_cli_exit_codes_hold_on_the_port(tmp_path, capsys):
    """The port's exit codes themselves: 0 clean, 1 on a regression."""
    (tmp_path / "a").mkdir()
    assert case_cli_exit_zero_clean(port_diff, tmp_path / "a",
                                    capsys)[0] == 0
    assert case_cli_exit_one_on_regression(port_diff, tmp_path / "a",
                                           capsys)[0] == 1


def test_gated_metrics_are_jax_s():
    assert port_diff.GATED_METRICS == jax_diff.GATED_METRICS


@pytest.mark.parametrize("leg", ["c2_batched", "c4_slow", "c2_batch4096",
                                 "c1_loopback"])
def test_port_row_diffs_against_jax_row(leg):
    """A port row and a JAX row of one small call diff leg by leg: no leg
    and no row comes out ``added`` or ``removed`` in either gate."""
    j, t = rows(leg)
    for mod in (jax_diff, port_diff):
        jl = mod._flatten_legs({"configs": {leg: j}})
        tl = mod._flatten_legs({"configs": {leg: t}})
        deltas, _ = mod.compare_runs(jl, tl, 0.10)
        assert deltas
        assert not {d.status for d in deltas} & {"added", "removed"}
