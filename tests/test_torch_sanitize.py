"""The port's sanitizer (``repro_torch.debug``) against the reference's
(``repro.debug``).

The re-build audit is the reference's retrace audit restated on a
``PlanFnCache`` with builders: a key new in the block may build once, a
key that existed and builds again (after its eviction) must raise
``RetraceAuditError`` ("re-traced").  NaN debugging checks every aten
op's floating output: a NaN-producing function raises
``FloatingPointError`` in both packages, but a NaN that a ``where``
masks before the output fires only here (the reference checks jit
outputs alone).  Every setting is restored after the block, also when it
raises.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.debug import sanitized as j_sanitized  # noqa: E402
from repro.runtime.scenario_engine import \
    PlanFnCache as JPlanFnCache  # noqa: E402
from repro_torch.debug import RetraceAuditError, sanitized  # noqa: E402
from repro_torch.runtime.scenario_engine import PlanFnCache  # noqa: E402


def _builder():
    return lambda x: x * 2.0


class TestRebuildAudit:
    def test_no_rebuild_passes(self):
        cache = PlanFnCache()
        fn = cache.get(("k",), _builder)
        fn(torch.ones(3))                    # built outside the block
        with sanitized(cache, debug_nans=False):
            cache.get(("k",), _builder)(torch.ones(3))
            cache.get(("k",), _builder)(2.0 * torch.ones(3))
        assert cache.builds == {("k",): 1}

    def test_new_key_may_build_once(self):
        cache = PlanFnCache()
        with sanitized(cache, debug_nans=False):
            cache.get(("fresh",), _builder)(torch.ones(3))

    def test_existing_key_rebuild_raises(self):
        cache = PlanFnCache(maxsize=1)
        cache.get(("k",), _builder)
        with pytest.raises(RetraceAuditError, match="re-traced"):
            with sanitized(cache, debug_nans=False):
                cache.get(("other",), _builder)   # evicts k
                cache.get(("k",), _builder)       # k builds again

    def test_new_key_building_twice_raises(self):
        cache = PlanFnCache(maxsize=1)
        with pytest.raises(RetraceAuditError, match="fresh"):
            with sanitized(cache, debug_nans=False):
                cache.get(("fresh",), _builder)
                cache.get(("other",), _builder)
                cache.get(("fresh",), _builder)   # a second build

    def test_max_traces_per_new_key_widens_the_budget(self):
        cache = PlanFnCache(maxsize=1)
        with sanitized(cache, debug_nans=False, max_traces_per_new_key=2):
            cache.get(("fresh",), _builder)
            cache.get(("other",), _builder)
            cache.get(("fresh",), _builder)

    def test_inner_exception_propagates_untouched(self):
        cache = PlanFnCache(maxsize=1)
        cache.get(("k",), _builder)
        with pytest.raises(ValueError, match="boom"):
            with sanitized(cache, debug_nans=False):
                cache.get(("other",), _builder)
                cache.get(("k",), _builder)      # would fail the audit...
                raise ValueError("boom")         # ...but the error wins

    def test_audit_can_be_disabled(self):
        cache = PlanFnCache(maxsize=1)
        cache.get(("k",), _builder)
        with sanitized(cache, debug_nans=False, retrace_audit=False):
            cache.get(("other",), _builder)
            cache.get(("k",), _builder)

    def test_default_cache_is_the_process_wide_one(self):
        from repro_torch.runtime.scenario_engine import PLAN_FN_CACHE
        with sanitized(debug_nans=False) as audited:
            assert audited == (PLAN_FN_CACHE,)


class TestDebugNans:
    def test_anomaly_mode_set_inside_and_restored(self):
        before = (torch.is_anomaly_enabled(),
                  torch.is_anomaly_check_nan_enabled())
        with sanitized(PlanFnCache()):
            assert torch.is_anomaly_enabled()
            assert torch.is_anomaly_check_nan_enabled()
        assert (torch.is_anomaly_enabled(),
                torch.is_anomaly_check_nan_enabled()) == before

    def test_state_restored_after_a_block_that_raises(self):
        before = torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError):
            with sanitized(PlanFnCache()):
                raise RuntimeError
        assert torch.is_anomaly_enabled() == before
        # the NaN check left with the block
        z = torch.zeros(())
        assert torch.isnan(z / z)

    def test_nan_producing_function_raises_in_both_packages(self):
        with pytest.raises(FloatingPointError, match="aten.div"):
            with sanitized(PlanFnCache()):
                z = torch.zeros(())
                z / z
        with pytest.raises(FloatingPointError):
            with j_sanitized(JPlanFnCache()):
                jax.jit(lambda x: x / x)(jnp.zeros(()))

    def test_clean_numerics_pass(self):
        with sanitized(PlanFnCache()):
            out = torch.log1p(torch.ones(4))
        np.testing.assert_allclose(out.numpy(), math.log(2.0), rtol=1e-6)

    def test_a_masked_nan_fires_here_and_not_in_the_reference(self):
        """``where(x > 0, x, inf - inf)``: the output holds no NaN, but
        the subtraction makes one.  The reference's debug_nans checks jit
        outputs only and passes; the port stops at the op."""
        def masked_j(x):
            return jnp.where(x > 0, x, x * jnp.inf - x * jnp.inf)
        with j_sanitized(JPlanFnCache()):
            out = jax.jit(masked_j)(jnp.ones(3))
        assert bool(jnp.all(out == 1.0))

        def masked_t(x):
            return torch.where(x > 0, x, x * math.inf - x * math.inf)
        assert torch.equal(masked_t(torch.ones(3)), torch.ones(3))
        with pytest.raises(FloatingPointError, match="aten.sub"):
            with sanitized(PlanFnCache()):
                masked_t(torch.ones(3))

    def test_a_nan_in_the_backward_raises(self):
        x = torch.zeros(3, requires_grad=True)
        with pytest.raises((FloatingPointError, RuntimeError)):
            with sanitized(PlanFnCache()):
                y = torch.sqrt(x) * 0.0     # d sqrt at 0 is inf; inf * 0
                y.sum().backward()

    def test_meta_tensors_pass_unchecked(self):
        with sanitized(PlanFnCache()):
            z = torch.zeros(3, device="meta")
            assert (z / z).shape == (3,)
