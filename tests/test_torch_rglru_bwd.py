"""The RG-LRU recurrence's backward against the reference, on the CPU.

The reference has no backward kernel: XLA differentiates its
``jax.lax.associative_scan`` (``repro/kernels/rglru_scan/ref.py``'s
``rglru_ref``, the scan of ``repro/models/recurrent.py::rglru_seq``).

* ``rglru_bwd_ref`` (the reverse scan, one FMA rounded once a step) and
  ``LinearRecurrence`` (``ops.linear_recurrence`` under grad) against
  ``jax.vjp`` of the reference's associative scan in float32, with and
  without a gradient of the last state, h0 nonzero, at T 1, ragged W and
  the reference's kernel-test grid, within the tolerance class of
  ``tests/test_torch_recurrent.py`` (the sums run in another order:
  ``5 TOL`` atol, ``10 TOL`` rtol at TOL 2e-5);
* ``rglru_bwd_ref`` follows its stated recurrence bitwise (a sequential
  float64 walk rounded the same way) and takes bfloat16 a, h and dh;
* the Function's backward gets no dhT when hT is unused, and zeros for
  dh when only hT is used;
* ``rglru_seq``'s float32 route under grad equals the serving call
  bitwise (float32 and bfloat16 activations), and its gradients match
  ``jax.vjp`` of the reference's ``rglru_seq``;
* on CPU tensors nothing is counted as a launch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru_scan.ref import rglru_ref as j_rglru_ref  # noqa
from repro.models import recurrent as j_rec  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.rglru_scan import ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (fma_f32,  # noqa: E402
                                                rglru_bwd_ref, rglru_ref)
from repro_torch.models import recurrent as t_rec  # noqa: E402

TOL = 2e-5                        # tests/test_kernels.py TOL, float32
SCAN_TOL = dict(atol=TOL * 5, rtol=TOL * 10)
#: (B, T, W): the reference's kernel-test grid, T 1, a ragged W
SHAPES = [(2, 64, 256), (1, 128, 128), (3, 32, 384), (2, 1, 8),
          (1, 37, 100)]


def _operands(shape, seed):
    b, t, w = shape
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.normal(size=(b, t, w))))).astype(
        np.float32)
    bb = (rng.normal(size=(b, t, w)) * 0.1).astype(np.float32)
    h0 = rng.normal(size=(b, w)).astype(np.float32)
    dh = rng.normal(size=(b, t, w)).astype(np.float32)
    dhT = rng.normal(size=(b, w)).astype(np.float32)
    return a, bb, h0, dh, dhT


@jax.jit
def _vjp(a, bb, h0, dh, dhT):
    (h, _), vjp = jax.vjp(j_rglru_ref, a, bb, h0)
    return h, vjp((dh, dhT))


def _ref_vjp(a, bb, h0, dh, dhT):
    """jax.vjp of the reference's associative scan: (h, (da, db, dh0))."""
    h, grads = _vjp(a, bb, h0, dh, np.zeros_like(h0) if dhT is None else dhT)
    return np.asarray(h), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("last", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_reference_vjp(shape, last):
    a, bb, h0, dh, dhT = _operands(shape, sum(shape))
    dhT = dhT if last else None
    rh, want = _ref_vjp(a, bb, h0, dh, dhT)
    ta, tb, th0 = (torch.as_tensor(v) for v in (a, bb, h0))
    h, _ = rglru_ref(ta, tb, th0)
    np.testing.assert_allclose(h.numpy(), rh, **SCAN_TOL)
    got = rglru_bwd_ref(ta, h, th0, torch.as_tensor(dh),
                        None if dhT is None else torch.as_tensor(dhT))
    for name, g, w in zip(("da", "db", "dh0"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **SCAN_TOL, err_msg=name)


@pytest.mark.parametrize("last", [True, False])
@pytest.mark.parametrize("shape", SHAPES[1:4])
def test_linear_recurrence_gradients_match_reference_vjp(shape, last):
    """Gradients of a, b and h0 through the Function: the loss reads every
    h_t, and hT too when ``last``."""
    a, bb, h0, dh, dhT = _operands(shape, 3 + sum(shape))
    _, want = _ref_vjp(a, bb, h0, dh, dhT if last else None)
    ta, tb, th0 = (torch.as_tensor(v).requires_grad_() for v in (a, bb, h0))
    h, hT = ops.linear_recurrence(ta, tb, th0)
    assert type(h.grad_fn).__name__ == "LinearRecurrenceBackward"
    loss = (h * torch.as_tensor(dh)).sum()
    if last:
        loss = loss + (hT * torch.as_tensor(dhT)).sum()
    loss.backward()
    for name, t, w in zip(("a", "b", "h0"), (ta, tb, th0), want):
        np.testing.assert_allclose(t.grad.numpy(), w, **SCAN_TOL,
                                   err_msg=name)


def _walk(a, h, h0, dh, dhT):
    """The stated recurrence, one channel at a time in float64, each step
    rounded as a float32 FMA and a float32 product are."""
    b, t, w = a.shape
    f = np.float32
    da, db, dh0 = (np.zeros_like(a), np.zeros_like(a), np.zeros_like(h0))
    for i in range(b):
        for j in range(w):
            lam = f(0.0) if dhT is None else dhT[i, j]
            for s in range(t - 1, -1, -1):
                lam = f(dh[i, s, j] + lam) if s == t - 1 else \
                    f(np.float64(a[i, s + 1, j]) * np.float64(lam)
                      + np.float64(dh[i, s, j]))
                db[i, s, j] = lam
                prev = h[i, s - 1, j] if s else h0[i, j]
                da[i, s, j] = f(lam * prev)
            dh0[i, j] = f(a[i, 0, j] * lam) if t else lam
    return da, db, dh0


@pytest.mark.parametrize("last", [True, False])
@pytest.mark.parametrize("shape", [(2, 5, 3), (1, 1, 4), (1, 0, 2)])
def test_plain_backward_is_the_stated_recurrence(shape, last):
    """The float64 sum of a float32 product and a float32 addend rounds to
    the exact FMA's float32 value unless it lands on a tie of float32,
    which these draws do not hit; ``fma_f32`` is exact always."""
    a, _, h0, dh, dhT = _operands(shape, 9)
    h = np.random.default_rng(1).normal(size=a.shape).astype(np.float32)
    dhT = dhT if last else None
    got = rglru_bwd_ref(*(None if v is None else torch.as_tensor(v)
                          for v in (a, h, h0, dh, dhT)))
    for g, w in zip(got, _walk(a, h, h0, dh, dhT)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_plain_backward_in_bfloat16_rounds_its_float32_result():
    a, _, h0, dh, dhT = _operands((2, 9, 6), 4)
    bf = torch.bfloat16
    ta, tdh = torch.as_tensor(a).to(bf), torch.as_tensor(dh).to(bf)
    th = torch.as_tensor(np.random.default_rng(2).normal(
        size=a.shape).astype(np.float32)).to(bf)
    th0, tdhT = torch.as_tensor(h0).to(bf), torch.as_tensor(dhT).to(bf)
    da, db, dh0 = rglru_bwd_ref(ta, th, th0, tdh, tdhT)
    assert da.dtype == db.dtype == dh0.dtype == bf
    wda, wdb, wdh0 = rglru_bwd_ref(ta.float(), th.float(), th0.float(),
                                   tdh.float(), tdhT.float())
    for g, w in ((da, wda), (db, wdb), (dh0, wdh0)):
        assert torch.equal(g, w.to(bf))


def test_backward_gets_no_last_state_gradient_when_hT_is_unused(monkeypatch):
    seen = []
    fwd, bwd = ops._TRAIN_BY_DEVICE["cpu"]
    monkeypatch.setitem(ops._TRAIN_BY_DEVICE, "cpu", (
        fwd, lambda *args: seen.append(args[3:]) or bwd(*args)))
    a, bb, h0, dh, _ = _operands((1, 6, 4), 5)
    ta, tb, th0 = (torch.as_tensor(v).requires_grad_() for v in (a, bb, h0))
    h, hT = ops.linear_recurrence(ta, tb, th0)
    h.sum().backward()
    assert seen[-1][1] is None and torch.equal(seen[-1][0],
                                               torch.ones_like(h))
    h, hT = ops.linear_recurrence(ta, tb, th0)
    hT.sum().backward()
    assert not seen[-1][0].any() and torch.equal(seen[-1][1],
                                                 torch.ones_like(hT))


def _block_params(seed, d=24, width=32, conv=4):
    p = {k: np.array(v) for k, v in
         j_rec.rglru_init(jax.random.PRNGKey(seed), d, width, conv).items()}
    rng = np.random.default_rng(seed)
    p["b_a"] = rng.normal(0, 0.3, width).astype(np.float32)
    p["b_i"] = rng.normal(0, 0.3, width).astype(np.float32)
    return p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_seq_under_grad_equals_the_serving_call(dtype):
    """Under grad ``rglru_seq`` runs the recurrence on float32 a, b, h0 and
    casts h back: bitwise the serving call's values."""
    p = {k: torch.as_tensor(v) for k, v in _block_params(1).items()}
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.normal(size=(2, 11, 32)).astype(np.float32)
                        ).to(dtype)
    h0 = torch.as_tensor(rng.normal(size=(2, 32)).astype(np.float32)
                         ).to(dtype)
    with torch.no_grad():
        want = t_rec.rglru_seq(p, x, h0)
    xg = x.clone().requires_grad_()
    got = t_rec.rglru_seq(p, xg, h0)
    assert got[0].requires_grad
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype
        assert torch.equal(g.detach(), w)


def test_rglru_seq_gradients_match_reference():
    """Gradients of the input and of every RG-LRU parameter through the
    gates and the recurrence, float32, against ``jax.vjp`` of the
    reference's ``rglru_seq``."""
    pn = _block_params(2)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 13, 32)).astype(np.float32)
    h0 = rng.normal(size=(2, 32)).astype(np.float32)
    dh = rng.normal(size=(2, 13, 32)).astype(np.float32)
    keys = ("w_a", "w_i", "b_a", "b_i", "log_lambda")
    @jax.jit
    def ref(xx, *ps):
        (h, _), vjp = jax.vjp(
            lambda xx, *ps: j_rec.rglru_seq(dict(pn, **dict(zip(keys, ps))),
                                            xx, jnp.asarray(h0)), xx, *ps)
        return h, vjp((jnp.asarray(dh), jnp.zeros((2, 32), jnp.float32)))
    jh, want = ref(jnp.asarray(x), *(jnp.asarray(pn[k]) for k in keys))
    p = {k: torch.as_tensor(v).requires_grad_(k in keys)
         for k, v in pn.items()}
    tx = torch.as_tensor(x).requires_grad_()
    h, _ = t_rec.rglru_seq(p, tx, torch.as_tensor(h0))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh),
                               **SCAN_TOL)
    (h * torch.as_tensor(dh)).sum().backward()
    for name, t, w in zip(("x",) + keys, [tx] + [p[k] for k in keys], want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_cpu_backward_counts_no_launch():
    kernels.reset_launch_counts()
    a, bb, h0, dh, _ = _operands((1, 5, 3), 12)
    ta, tb, th0 = (torch.as_tensor(v).requires_grad_() for v in (a, bb, h0))
    h, _ = ops.linear_recurrence(ta, tb, th0)
    h.sum().backward()
    counts = kernels.launch_counts()
    assert counts["rglru_scan"] == counts["rglru_scan_bwd"] == 0


def test_fma_f32_is_the_backward_step():
    """The plain backward's step is ``fma_f32``: a[t+1] lambda + dh[t]."""
    a, _, h0, dh, dhT = _operands((1, 2, 5), 13)
    h = np.zeros_like(a)
    _, db, _ = rglru_bwd_ref(*(torch.as_tensor(v)
                               for v in (a, h, h0, dh, dhT)))
    lam1 = torch.as_tensor(dh[:, 1] + dhT)
    assert torch.equal(db[:, 1], lam1)
    assert torch.equal(db[:, 0], fma_f32(torch.as_tensor(a[:, 1]), lam1,
                                         torch.as_tensor(dh[:, 0])))
