"""Parity of the port's diagnostics (``diagnostics/invariants.py``,
``auditor.py``, ``slo.py``, ``explain.py``, and the tracing, command
tracer and flight recorder they read) with the JAX package's.

Each case runs one reference test on both packages
(``test_torch_edge.run_case``): the reference's assertions hold on both,
and the call results, call errors and hub counters must be EQUAL. The
cases are every test of ``tests/test_diagnostics.py`` (13),
``tests/test_invariants.py`` (4), ``tests/test_slo.py`` (14),
``tests/test_explain.py`` (18) and ``tests/test_trace_dump.py`` (14 tests,
19 cases: its two parametrised ones once per value; ``tools/trace_dump.py``
renders what each package's ``MeshTraceStore`` stitched). Tolerance:
exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import importlib
import inspect

import pytest

from test_torch_edge import run_case


def reference_cases(module: str):
    """Every test of ``tests/<module>.py`` as ``(test, fixtures)``: ``test``
    is ``name`` or ``Class::name``; a parametrised test gives one case a
    value, passed as the fixture of its argument."""
    mod = importlib.import_module(module)
    fns = []
    for name, obj in vars(mod).items():
        if name.startswith("test_") and callable(obj):
            fns.append((name, obj))
        elif name.startswith("Test") and inspect.isclass(obj):
            fns += [(f"{name}::{m}", f) for m, f in vars(obj).items() if m.startswith("test_")]
    out = []
    for test, fn in fns:
        marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
        if not marks:
            out.append(pytest.param(test, {}, id=test))
            continue
        (mark,) = marks
        for i, value in enumerate(mark.args[1]):
            out.append(pytest.param(test, {mark.args[0]: value}, id=f"{test}[{i}]"))
    return out


#: the reference modules and how many cases each gives
MODULES = {"test_diagnostics": 13, "test_invariants": 4, "test_slo": 14, "test_explain": 18,
           "test_trace_dump": 19}


def test_reference_case_counts():
    assert {m: len(reference_cases(m)) for m in MODULES} == MODULES


@pytest.mark.parametrize("module", MODULES)
def test_case_ids_are_unique(module):
    ids = [p.id for p in reference_cases(module)]
    assert len(ids) == len(set(ids))


@pytest.mark.parametrize("test,fixtures", reference_cases("test_diagnostics"))
def test_diagnostics_case(test, fixtures):
    run_case("test_diagnostics", test, pipeline=True, **fixtures)


@pytest.mark.parametrize("test,fixtures", reference_cases("test_invariants"))
def test_invariants_case(test, fixtures):
    run_case("test_invariants", test, **fixtures)


@pytest.mark.parametrize("test,fixtures", reference_cases("test_slo"))
def test_slo_case(test, fixtures, monkeypatch):
    run_case("test_slo", test, monkeypatch=monkeypatch, **fixtures)


@pytest.mark.parametrize("test,fixtures", reference_cases("test_explain"))
def test_explain_case(test, fixtures):
    run_case("test_explain", test, **fixtures)


@pytest.mark.parametrize("test,fixtures", reference_cases("test_trace_dump"))
def test_trace_dump_case(test, fixtures, tmp_path, monkeypatch, capsys):
    run_case("test_trace_dump", test, tmp_path=tmp_path, monkeypatch=monkeypatch, capsys=capsys,
             **fixtures)
