"""The port's ``plan_pipeline`` against the reference's at the prefill
shape (``prefill_32k``): every LM config, at 2, 4, 6 and 8 stages of 1, 8
and 32 chips, under both objectives, held as
``test_torch_pipeline_plans.py`` holds the training shape (the grid is
split in three files so that they run side by side).
"""
import pytest

pytest.importorskip("torch")

from test_torch_pipeline_plans import cells, check_plans  # noqa: E402


@pytest.mark.parametrize("arch,shape", cells(("prefill",)))
def test_prefill_plans_match_the_reference(arch, shape):
    check_plans(arch, shape)
