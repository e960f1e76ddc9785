"""``examples/torch_serve_swarm.py`` on the CPU against the reference's
``examples/serve_swarm.py``, in all three modes.

* The LM mode, given the reference's own chip and interconnect constants
  on the command line (``repro.core.pipeline_opt.V5E_MACS`` /
  ``V5E_HBM_BYTES``, ``repro.core.channel.ICIParams()``'s link rate, hop
  latency and torus; its cross-host rate the planner never reads), prints the
  reference's parameter count and ``StagePlan`` line, and its plan equals
  the reference's ``plan_pipeline`` field for field; it serves every
  request.  Without a card and without the chip's figures it refuses.
* ``--chaos``: the reference's failure events and recovery line (mode,
  unrecovered, MTTR, generation churn, no build after the first refresh).
* ``--stream``: the reference's window-by-window admissions, services and
  sheds, and its closing report.
"""
import contextlib
import dataclasses
import io
import os
import sys

import pytest

pytest.importorskip("torch")

from repro.configs.base import (DECODE_32K, ArchConfig,  # noqa: E402
                                AttentionConfig)
from repro.core import channel as jch  # noqa: E402
from repro.core import pipeline_opt as jpo  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "examples", "torch_serve_swarm.py")
REF = os.path.join(ROOT, "examples", "serve_swarm.py")
#: the reference's constants, on the port example's command line
ICI = jch.ICIParams()
REF_CONSTANTS = ["--chip-macs", repr(jpo.V5E_MACS),
                 "--chip-hbm-bytes", repr(float(jpo.V5E_HBM_BYTES)),
                 "--link-bytes", repr(ICI.link_bw_bytes),
                 "--hop-latency-s", repr(ICI.hop_latency_s),
                 "--torus", *map(str, ICI.torus)]


def run(path, argv):
    """An example's ``main`` with ``argv`` (the reference's reads
    ``sys.argv``); returns its result and stdout."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out, old = io.StringIO(), sys.argv
    sys.argv = [path] + argv
    try:
        with contextlib.redirect_stdout(out):
            result = mod.main(argv) if path == PORT else mod.main()
    finally:
        sys.argv = old
    return result, out.getvalue().splitlines()


def lines(text, *prefixes):
    return [line for line in text if line.startswith(prefixes)]


def test_lm_mode_plans_as_the_reference_and_serves():
    got, out = run(PORT, ["--device", "cpu"] + REF_CONSTANTS)
    _, ref_out = run(REF, [])
    keep = ("serving ", "LLHR decode placement:")
    assert lines(out, *keep) == lines(ref_out, *keep)
    assert len(lines(out, *keep)) == 2
    cfg = ArchConfig(
        name="serve-lm", family="dense", n_layers=4, d_model=256,
        d_ff=768, vocab_size=2048,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=64),
        tie_embeddings=True, remat="none", dtype="float32")
    want = jpo.plan_pipeline(cfg, DECODE_32K, n_stages=2, chips_per_stage=8)
    assert dataclasses.astuple(got["plan"]) == dataclasses.astuple(want)
    assert got["chip"].macs_per_s == jpo.V5E_MACS
    assert got["ici"].torus == ICI.torus
    assert got["completed"] == 8 and got["tokens"] > 0
    assert got["prefill_calls"] >= 2 and got["decode_steps"] >= 11
    assert lines(out, "planner constants:")[0].count(
        "given on the command line") == 3


def test_lm_mode_on_the_cpu_needs_the_chip():
    with pytest.raises(SystemExit, match="--chip-macs"):
        run(PORT, ["--device", "cpu"])


def test_chaos_mode_matches_the_reference():
    got, out = run(PORT, ["--device", "cpu", "--chaos"])
    _, ref_out = run(REF, ["--chaos"])
    keep = ("events:", "recovered:", "chaos run recovered")
    assert lines(out, *keep) == lines(ref_out, *keep)
    assert len(lines(out, *keep)) == 3
    assert got["events"] == [("failure", ["uav2"])]
    assert got["retraces"] == 0 and got["mode"] == "nominal"


def test_stream_mode_matches_the_reference():
    got, out = run(PORT, ["--device", "cpu", "--stream"])
    _, ref_out = run(REF, ["--stream"])
    keep = ("  window ", "stream: hit_rate", "stream demo recovered")
    assert lines(out, *keep) == lines(ref_out, *keep)
    assert len(lines(out, "  window ")) == 5
    assert got["report"]["device_failures"] == 1
    assert got["rollout_builds"] >= 1
