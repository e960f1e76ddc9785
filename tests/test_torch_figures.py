"""The port's figure scripts against the reference's on the CPU.

Each script runs its ``--smoke`` grid once in each package (module-scoped
fixtures; the reference's four grids take ~11 s) and the CSV rows are
held row by row:

* the same row names, in the same order, and four columns each;
* the feasibility column exact;
* Fig. 5's baseline rows (the legacy host loop, host numpy in both
  packages) exact in the derived column;
* the LLHR rows' derived column within ROADMAP section 3's P2 notes:
  rtol 1e-3 at U 4 and 5 (Figs. 2 and 4), latency within rtol 1e-3 at
  U 6 (Figs. 3 and 5), plus one unit of the printed last digit.

The wall column is each package's own.  The scripts' default device is
the card (``tests/test_torch_port_guard.py`` holds that); here they run
with ``--device cpu``.
"""
import contextlib
import importlib
import io

import pytest

pytest.importorskip("torch")

SCRIPTS = ("fig2_latency_power", "fig3_latency_memory", "fig4_min_power",
           "fig5_request_scaling")
#: the LLHR rows' derived column (latency, or Fig. 4's power at U 4)
RTOL = 1e-3


def rows(module, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        importlib.import_module(f"benchmarks.{module}").main(argv)
    return [line.split(",") for line in out.getvalue().splitlines()]


@pytest.fixture(scope="module")
def reference_rows():
    return {s: rows(s, ["--smoke"]) for s in SCRIPTS}


@pytest.fixture(scope="module")
def port_rows():
    return {s: rows(f"torch_{s}", ["--smoke", "--device", "cpu"])
            for s in SCRIPTS}


def last_digit(text):
    """One unit of the last printed digit of a derived value."""
    return 10.0 ** -len(text.split(".")[1]) if "." in text else 1.0


@pytest.mark.parametrize("script", SCRIPTS)
def test_smoke_rows_match_the_reference(script, reference_rows, port_rows):
    ref, got = reference_rows[script], port_rows[script]
    assert [r[0] for r in got] == [r[0] for r in ref]
    assert all(len(r) == 4 for r in got) and len(got) >= 2
    for r, g in zip(ref, got):
        assert g[3] == r[3], r[0]                      # feasibility
        if "/heuristic/" in r[0] or "/random/" in r[0]:
            assert g[2] == r[2], r[0]                  # host numpy rows
        else:
            a, b = float(g[2]), float(r[2])
            assert abs(a - b) <= RTOL * abs(b) + last_digit(r[2]), \
                (r[0], a, b)
        assert float(g[1]) > 0.0


def test_smoke_rows_show_the_paper_trends(port_rows):
    """The smoke rows' trends, as the reference's rows show them: Fig. 2's
    latency falls from 40 to 120 mW, Fig. 4's power falls from 10 to
    20 MHz, and Fig. 5's LLHR is under both baselines at each request
    count."""
    derived = {r[0]: float(r[2]) for s in SCRIPTS for r in port_rows[s]}
    assert derived["fig2/bw=10MHz/uavs=4/pmax=120mW"] < \
        derived["fig2/bw=10MHz/uavs=4/pmax=40mW"]
    assert derived["fig4/lenet/uavs=4/bw=20MHz"] < \
        derived["fig4/lenet/uavs=4/bw=10MHz"]
    for rq in (2, 8):
        llhr = derived[f"fig5/llhr/requests={rq}"]
        assert llhr < derived[f"fig5/heuristic/requests={rq}"]
        assert llhr < derived[f"fig5/random/requests={rq}"]


def test_run_planner_matches_the_reference():
    """``torch_common.run_planner``, the figures' scalar oracle: the
    baselines' plans exact (host numpy in both packages), LLHR's
    latency within rtol 1e-3 after 60 P2 steps at U 4."""
    from benchmarks import common as jc
    from benchmarks import torch_common as tc
    from repro.core import RadioParams as JParams
    from repro_torch.core.channel import RadioParams as TParams
    for kind in ("heuristic", "random"):
        ref, _ = jc.run_planner(kind, "alexnet", 6, 4, JParams(), t=1)
        got, _ = tc.run_planner(kind, "alexnet", 6, 4, TParams(), t=1,
                                device="cpu")
        assert got.total_latency == ref.total_latency and \
            got.total_power == ref.total_power
        assert [s.assign for s in got.placements] == \
            [s.assign for s in ref.placements]
    ref, _ = jc.run_planner("llhr", "lenet", 4, 2, JParams())
    got, wall = tc.run_planner("llhr", "lenet", 4, 2, TParams(),
                               device="cpu")
    assert got.total_latency == pytest.approx(ref.total_latency, rel=1e-3)
    assert wall > 0.0
