"""The port's ``plan_pipeline`` against the reference's over the whole
grid, on the CPU: every LM config at each shape it supports, at 2, 4, 6
and 8 stages of 1, 8 and 32 chips, under both objectives.  This file
holds the training shape; ``test_torch_pipeline_prefill_plans.py`` and
``test_torch_pipeline_decode_plans.py`` the prefill and the two decode
shapes, through ``check_plans`` here.  Every
``StagePlan`` field is ``==`` the reference's, and an infeasible case
raises the reference's message.  The reference's chip and interconnect
constants are given to both sides (``test_torch_pipeline.py`` says why);
the grid's invariants (blocks summing to the layer count plus embedding
and head, one hop between consecutive stages on the bottleneck
objective, the bottleneck the largest stage latency) are held too.

The grid is in files of its own because it is the slow part of the
planner's tests: the torus search spends up to its node budget on each
plan.
"""
import dataclasses
import itertools

import pytest

pytest.importorskip("torch")

from repro.configs import registry as jreg  # noqa: E402
from repro.core import channel as jch  # noqa: E402
from repro.core import pipeline_opt as jpo  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core import pipeline_opt as tpo  # noqa: E402

CHIP = tpo.ChipParams("reference chip", jpo.V5E_MACS, jpo.V5E_HBM_BYTES)
J_ICI = jch.ICIChannel()
T_ICI = tch.ICIChannel(tch.ICIParams(**dataclasses.asdict(J_ICI.params)))


def cells(kinds):
    """(arch, shape) of every LM config at each supported shape of a kind
    in ``kinds``."""
    return [(a, s) for a in sorted(jreg.LM_ARCHS)
            for s in jreg.get_arch(a).supported_shapes
            if jreg.get_shape(s).kind in kinds]


def plan_or_error(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return str(e)


def check_plans(arch, shape):
    t_cfg, j_cfg = treg.get_arch(arch), jreg.get_arch(arch)
    t_sh, j_sh = treg.get_shape(shape), jreg.get_shape(shape)
    n_plans = 0
    for n, cps, obj in itertools.product((2, 4, 6, 8), (1, 8, 32),
                                         ("bottleneck", "latency")):
        want = plan_or_error(jpo.plan_pipeline, j_cfg, j_sh, n, cps,
                             objective=obj)
        got = plan_or_error(tpo.plan_pipeline, t_cfg, t_sh, n, cps,
                            chip=CHIP, ici=T_ICI, objective=obj)
        if isinstance(want, str):
            assert got == want
            assert "no feasible" in got
            continue
        n_plans += 1
        assert dataclasses.astuple(got) == dataclasses.astuple(want), \
            (n, cps, obj)
        assert got.blocks_per_stage == want.blocks_per_stage
        assert sum(got.blocks_per_stage) == \
            t_cfg.n_layers + 2 + t_cfg.enc_layers
        assert got.bottleneck_s == max(got.stage_latency_s)
        if obj == "bottleneck":
            assert got.n_stages == n
            for a, b in zip(got.stage_coords[:-1], got.stage_coords[1:]):
                assert T_ICI.hops(a, b) == 1
        else:
            assert got.n_stages <= n
    assert n_plans > 0


@pytest.mark.parametrize("arch,shape", cells(("train",)))
def test_plans_match_the_reference(arch, shape):
    check_plans(arch, shape)
