"""The port's RG-LRU (Griffin / RecurrentGemma) against the reference, on
the CPU.

* the RG-LRU scan kernel's plain version (``rglru_ref``, the sequential
  float32 recurrence) against the reference's Pallas ``rglru_scan`` in
  interpret mode (bitwise: the same products and sums in the same order)
  and its ``rglru_ref`` (an associative scan: the reference's kernel-test
  tolerance, ``5 TOL`` atol and ``10 TOL`` rtol), at the reference's
  kernel-test grid, float32 and bfloat16, ``h0`` nonzero;
* the block's pieces: ``jax.nn.softplus``, the gates, ``causal_conv1d``
  and its decode step;
* ``rglru_block_apply``: prefill, then 8 decode steps carrying the state,
  against the reference within rtol 1e-5 (float32);
* ``ops.linear_recurrence`` on CPU tensors takes the plain version and
  counts no launch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru_scan.ref import rglru_ref as j_rglru_ref  # noqa
from repro.kernels.rglru_scan.rglru_scan import \
    rglru_scan as j_rglru_scan  # noqa: E402
from repro.models import recurrent as j_rec  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import linear_recurrence  # noqa
from repro_torch.kernels.rglru_scan.ref import rglru_ref  # noqa: E402
from repro_torch.models import recurrent as t_rec  # noqa: E402

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": 2e-5, "bf16": 2e-2}     # tests/test_kernels.py TOL
RTOL = dict(atol=1e-5, rtol=1e-5)


def both(x, dt):
    """numpy float32 -> (torch, jax) tensors of the dtype ``dt``."""
    t_dt, j_dt = DTYPES[dt]
    return torch.as_tensor(x).to(t_dt), jnp.asarray(x).astype(j_dt)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,t,w,block", [(2, 64, 256, 128), (1, 128, 128, 64),
                                         (3, 32, 384, 128)])
def test_rglru_scan_plain_matches_pallas_and_ref(b, t, w, block, dt):
    rng = np.random.default_rng(b * t + w)
    at, aj = both(1.0 / (1.0 + np.exp(-rng.normal(size=(b, t, w))))
                  .astype(np.float32), dt)
    bt, bj = both((rng.normal(size=(b, t, w)) * 0.1).astype(np.float32), dt)
    ht, hj = both(rng.normal(size=(b, w)).astype(np.float32), dt)
    h, hT = rglru_ref(at, bt, ht)
    assert h.dtype == hT.dtype == DTYPES[dt][0]
    ph, phT = j_rglru_scan(aj, bj, hj, block_w=block, interpret=True)
    np.testing.assert_array_equal(f32(h), f32(ph))
    np.testing.assert_array_equal(f32(hT), f32(phT))
    rh, rhT = j_rglru_ref(aj, bj, hj)
    tol = dict(atol=TOL[dt] * 5, rtol=TOL[dt] * 10)
    np.testing.assert_allclose(f32(h), f32(rh), **tol)
    np.testing.assert_allclose(f32(hT), f32(rhT), **tol)


def test_linear_recurrence_on_cpu_takes_the_plain_version_without_counting():
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.random((2, 5, 3)), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=(2, 5, 3)), dtype=torch.float32)
    h0 = torch.zeros((2, 3))
    kernels.reset_launch_counts()
    h, hT = linear_recurrence(a, b, h0)
    assert torch.equal(h[:, -1], hT)
    assert torch.equal(h[:, 0], b[:, 0])          # a_0 * 0 + b_0
    assert kernels.launch_counts()["rglru_scan"] == 0


# ---------------------------------------------------------------------------
# the block's pieces and the block
# ---------------------------------------------------------------------------


def _params(seed, d=24, width=32, conv=4):
    """The reference's ``rglru_init`` with its zero biases replaced by
    draws, as numpy, and the same as port tensors."""
    p = {k: np.array(v) for k, v in
         j_rec.rglru_init(jax.random.PRNGKey(seed), d, width, conv).items()}
    rng = np.random.default_rng(seed)
    p["b_a"] = rng.normal(0, 0.3, width).astype(np.float32)
    p["b_i"] = rng.normal(0, 0.3, width).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.as_tensor(v) for k, v in p.items()})


def test_softplus_matches_jax():
    z = np.concatenate([np.linspace(-30, 30, 121),
                        [-1e-3, 0.0, 1e-3, 88.0]]).astype(np.float32)
    np.testing.assert_allclose(
        t_rec._softplus(torch.as_tensor(z)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(z))), rtol=1e-6, atol=1e-7)


def test_gates_and_conv_match_reference():
    jp, tp = _params(0)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    ja, jb = j_rec._rglru_gates(jp, jnp.asarray(x))
    ta, tb = t_rec._rglru_gates(tp, torch.as_tensor(x))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **RTOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **RTOL)
    assert 0.0 < float(ta.min()) and float(ta.max()) < 1.0
    np.testing.assert_allclose(
        t_rec.causal_conv1d(tp["conv_w"], torch.as_tensor(x)).numpy(),
        np.asarray(j_rec.causal_conv1d(jp["conv_w"], jnp.asarray(x))),
        **RTOL)
    buf = rng.normal(size=(2, 3, 32)).astype(np.float32)
    got = t_rec.causal_conv1d_step(tp["conv_w"], torch.as_tensor(x[:, 0]),
                                   torch.as_tensor(buf))
    want = j_rec.causal_conv1d_step(jp["conv_w"], jnp.asarray(x[:, 0]),
                                    jnp.asarray(buf))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **RTOL)


@pytest.mark.parametrize("s", [3, 13])
def test_rglru_block_prefill_and_decode_match_reference(s):
    """Prefill (3 tokens: exactly the conv history; 13) from a nonzero
    state, then 8 decode steps, each feeding its state to the next, on
    both sides; outputs and states within rtol 1e-5 (the scan's
    sequential sums against the associative scan)."""
    jp, tp = _params(1)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, s, 24)).astype(np.float32)
    h0 = rng.normal(size=(2, 32)).astype(np.float32)
    jstate = dict(j_rec.rglru_block_state(2, 32, 4, jnp.float32, False),
                  h=jnp.asarray(h0))
    tstate = dict(t_rec.rglru_block_state(2, 32, 4, torch.float32, "cpu"),
                  h=torch.as_tensor(h0))
    jy, jst = j_rec.rglru_block_apply(jp, jnp.asarray(x), jstate)
    ty, tst = t_rec.rglru_block_apply(tp, torch.as_tensor(x), tstate,
                                      decode=False)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **RTOL)
    for i in range(8):
        for k in ("h", "conv"):
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       **RTOL)
        xd = rng.normal(size=(2, 1, 24)).astype(np.float32)
        jy, jst = j_rec.rglru_block_apply(jp, jnp.asarray(xd),
                                          dict(jst, decode=True))
        ty, tst = t_rec.rglru_block_apply(tp, torch.as_tensor(xd), tst,
                                          decode=True)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **RTOL)
