"""The expert GEMM's backward against the reference, on the CPU.

The reference has no backward kernel: XLA differentiates its
``jnp.einsum("becd,edf->becf")`` over the dispatch buffer [B, E, cap, d]
(``repro/models/moe.py``).  The port's buffer is [E, B * cap, d], so the
same products are held here through that layout change:

* the backward kernels' plain versions (``moe_matmul_dx_ref``: dy w^T,
  ``moe_matmul_dw_ref``: x^T dy) against ``jax.vjp`` of the reference's
  einsum, float32 and bfloat16, at ragged C, D and F, and C 0 (dX empty,
  dW zeros), within the reference's kernel-test tolerance with the
  contraction of each product (``TOL sqrt(K)`` atol, ``10 TOL`` rtol);
* ``ExpertGemm`` (``ops.expert_gemm`` under grad) gives those gradients
  for a random cotangent and for ``y.sum()``'s broadcast one (stride 0,
  copied contiguous first); its backward runs dX only when x needs a
  gradient and dW only when w does; without grad ``expert_gemm`` is the
  serving call (no graph); on CPU tensors nothing is counted as a launch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.moe_matmul import ops  # noqa: E402
from repro_torch.kernels.moe_matmul.ref import (  # noqa: E402
    moe_matmul_dw_ref, moe_matmul_dx_ref, moe_matmul_ref)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": 2e-5, "bf16": 2e-2}     # tests/test_kernels.py TOL
#: (B, E, cap, D, F): the reference's buffer [B, E, cap, D] against
#: w [E, D, F]; ragged C = B cap, D and F not multiples of 8, and cap 0
SHAPES = [(1, 4, 64, 96, 160), (2, 8, 16, 128, 64), (1, 2, 97, 100, 36),
          (3, 3, 5, 24, 40), (2, 3, 0, 16, 8)]


def _operands(shape, seed):
    b, e, cap, d, f = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, e, cap, d)).astype(np.float32)
    w = (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32)
    dy = rng.normal(size=(b, e, cap, f)).astype(np.float32)
    return x, w, dy


def _port(x, dt):
    """The reference's [B, E, cap, n] -> the port's [E, B cap, n]."""
    b, e, cap, n = x.shape
    return torch.as_tensor(np.ascontiguousarray(
        x.transpose(1, 0, 2, 3).reshape(e, b * cap, n))).to(DTYPES[dt][0])


def _from_port(t, b):
    e, c, n = t.shape
    return t.float().numpy().reshape(e, b, c // b if b else 0,
                                     n).transpose(1, 0, 2, 3)


def _ref_vjp(x, w, dy, dt):
    j_dt = DTYPES[dt][1]
    y, vjp = jax.vjp(lambda xx, ww: jnp.einsum("becd,edf->becf", xx, ww),
                     jnp.asarray(x).astype(j_dt), jnp.asarray(w).astype(j_dt))
    dx, dw = vjp(jnp.asarray(dy).astype(j_dt))
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(dx.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _tol(dt, k):
    return dict(atol=TOL[dt] * max(k, 1) ** 0.5, rtol=TOL[dt] * 10)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_plain_versions_match_reference_vjp(shape, dt):
    b, e, cap, d, f = shape
    x, w, dy = _operands(shape, sum(shape))
    _, rdx, rdw = _ref_vjp(x, w, dy, dt)
    tx, tdy = _port(x, dt), _port(dy, dt)
    tw = torch.as_tensor(w).to(DTYPES[dt][0])
    dx = moe_matmul_dx_ref(tdy, tw)
    dw = moe_matmul_dw_ref(tx, tdy)
    assert dx.dtype == dw.dtype == DTYPES[dt][0]
    assert dx.shape == (e, b * cap, d) and dw.shape == (e, d, f)
    np.testing.assert_allclose(_from_port(dx, b), rdx, **_tol(dt, f))
    np.testing.assert_allclose(dw.float().numpy(), rdw, **_tol(dt, b * cap))
    if cap == 0:
        assert dx.numel() == 0 and not dw.any()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("shape", SHAPES[:3] + SHAPES[4:])
def test_expert_gemm_function_gradients_match_reference_vjp(shape, broadcast,
                                                            dt):
    """A random cotangent, or ``y.sum()``'s stride-0 ones."""
    b, e, cap, d, f = shape
    x, w, dy = _operands(shape, 7 + sum(shape))
    if broadcast:
        dy = np.ones_like(dy)
    ry, rdx, rdw = _ref_vjp(x, w, dy, dt)
    tx = _port(x, dt).requires_grad_()
    tw = torch.as_tensor(w).to(DTYPES[dt][0]).requires_grad_()
    y = ops.expert_gemm(tx, tw)
    assert type(y.grad_fn).__name__ == "ExpertGemmBackward"
    np.testing.assert_allclose(_from_port(y.detach(), b), ry, **_tol(dt, d))
    if broadcast:
        y.sum().backward()
    else:
        y.backward(_port(dy, dt))
    np.testing.assert_allclose(_from_port(tx.grad, b), rdx, **_tol(dt, f))
    np.testing.assert_allclose(tw.grad.float().numpy(), rdw,
                               **_tol(dt, b * cap))


@pytest.mark.parametrize("needs", ["x", "w", "both"])
def test_expert_gemm_backward_runs_only_the_products_needed(needs,
                                                            monkeypatch):
    calls = []
    fwd, fdx, fdw = ops._TRAIN_BY_DEVICE["cpu"]
    monkeypatch.setitem(ops._TRAIN_BY_DEVICE, "cpu", (
        fwd, lambda *a: calls.append("dx") or fdx(*a),
        lambda *a: calls.append("dw") or fdw(*a)))
    x, w, dy = _operands((1, 2, 8, 16, 24), 3)
    tx, tw = _port(x, "f32"), torch.as_tensor(w)
    tx.requires_grad_(needs in ("x", "both"))
    tw.requires_grad_(needs in ("w", "both"))
    ops.expert_gemm(tx, tw).backward(_port(dy, "f32"))
    assert calls == {"x": ["dx"], "w": ["dw"], "both": ["dx", "dw"]}[needs]
    assert (tx.grad is None) == (needs == "w")
    assert (tw.grad is None) == (needs == "x")


def test_expert_gemm_without_grad_is_the_serving_call():
    x, w, _ = _operands((1, 3, 10, 12, 20), 5)
    tx = _port(x, "f32").requires_grad_()
    tw = torch.as_tensor(w).requires_grad_()
    with torch.no_grad():
        y = ops.expert_gemm(tx, tw)
    assert y.grad_fn is None
    assert torch.equal(y, moe_matmul_ref(tx.detach(), tw.detach()))
    # under grad the Function's forward gives the same values
    assert torch.equal(ops.expert_gemm(tx, tw).detach(), y)


def test_cpu_backward_counts_no_launch():
    kernels.reset_launch_counts()
    x, w, dy = _operands((2, 2, 6, 8, 16), 11)
    tx = _port(x, "f32").requires_grad_()
    tw = torch.as_tensor(w).requires_grad_()
    ops.expert_gemm(tx, tw).backward(_port(dy, "f32"))
    counts = kernels.launch_counts()
    assert counts["moe_matmul"] == counts["moe_matmul_dx"] == \
        counts["moe_matmul_dw"] == 0
