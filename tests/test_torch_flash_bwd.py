"""The flash-attention backward's plain version and the autograd Function
against the reference's gradient, on the CPU.

The reference has no attention backward of its own: XLA differentiates
its jnp attention.  So the oracle is ``jax.vjp`` of the reference's
``attention_ref`` (square cases) and of its model attention's ``_sdpa``
(keys of their own length, as whisper's cross-attention), on the same
seeded numpy inputs.  Checked, in float32 within atol 1e-5 + rtol 1e-4:

* ``attention_fwd_ref``'s output and log-sum-exp, and
  ``attention_bwd_ref``'s dq, dk, dv: causal, sliding window, softcap,
  GQA (the group's sum explicit), Sk != Sq without a mask, ragged S (1,
  37, 65);
* ``ops.mha`` under grad, which goes through ``FlashAttention`` (the CPU
  entry of its dispatch table: the plain versions), with the output's
  gradient arriving as a transposed view;
* one model-level case: the reduced minicpm-2b's loss and every gradient
  at S 1,024, where the reference's attention takes its query-chunked
  ``jax.checkpoint`` path.

Also: under ``no_grad`` ``mha`` makes today's serving call, and the bare
kernel wrappers refuse to run under grad.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as j_attention_ref  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models.transformer import TransformerLM as JLM  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_fwd_ref)
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)

#: (B, H, KV, Sq, Sk, D, causal, window, cap)
CASES = [
    (2, 4, 4, 16, 16, 16, True, 0, 0.0),       # causal MHA
    (1, 4, 2, 37, 37, 16, True, 0, 0.0),       # GQA, ragged S
    (1, 4, 2, 40, 40, 32, True, 8, 0.0),       # sliding window
    (2, 4, 4, 33, 33, 16, True, 0, 5.0),       # softcap
    (1, 8, 2, 65, 65, 16, True, 16, 3.0),      # GQA, window and cap
    (1, 4, 4, 24, 24, 16, False, 0, 0.0),      # non-causal (encoder)
    (2, 6, 6, 7, 29, 16, False, 0, 0.0),       # cross: Sq 7 over Sk 29
    (1, 4, 2, 1, 13, 16, False, 0, 0.0),       # cross: one query
    (1, 2, 1, 1, 1, 16, True, 0, 0.0),         # S 1
]
IDS = ["causal", "gqa-ragged", "window", "cap", "gqa-window-cap",
       "noncausal", "cross", "cross-1", "s1"]


def _inputs(case, seed):
    b, h, kv, s, sk, d = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k = rng.normal(size=(b, kv, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, kv, sk, d)).astype(np.float32)
    do = rng.normal(size=(b, h, s, d)).astype(np.float32)
    return q, k, v, do


def _j_attention(case):
    """The reference's attention as a function of head-major q, k, v."""
    b, h, kv, s, sk, d, causal, window, cap = case
    if s == sk:
        return lambda q, k, v: j_attention_ref(q, k, v, causal=causal,
                                               window=window, cap=cap)

    def cross(q, k, v):
        qg = jnp.moveaxis(q, 1, 2).reshape(b, s, kv, h // kv, d)
        q_pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
        k_pos = jnp.broadcast_to(jnp.arange(sk)[None], (b, sk))
        out = j_attn._sdpa(qg, jnp.moveaxis(k, 1, 2), jnp.moveaxis(v, 1, 2),
                           q_pos, k_pos, causal, window, cap,
                           1.0 / np.sqrt(d))
        return jnp.moveaxis(out, 2, 1)
    return cross


def _j_grads(case, q, k, v, do):
    fn = _j_attention(case)
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _j_lse(case, q, k):
    b, h, kv, s, sk, d, causal, window, cap = case
    kr = np.repeat(k, h // kv, axis=1)
    logits = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                       kr.astype(np.float64)) / np.sqrt(d)
    if cap:
        logits = np.tanh(logits / cap) * cap
    qp, kp = np.arange(s)[:, None], np.arange(sk)[None, :]
    ok = np.ones((s, sk), bool)
    if causal:
        ok &= qp >= kp
    if window:
        ok &= qp - kp < window
    logits = np.where(ok, logits, -np.inf)
    m = logits.max(-1, keepdims=True)
    return (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case):
    causal, window, cap = case[6:]
    q, k, v, do = _inputs(case, 1)
    want_o, want = _j_grads(case, q, k, v, do)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = attention_fwd_ref(tq, tk, tv, causal=causal, window=window,
                               cap=cap)
    np.testing.assert_allclose(o.numpy(), want_o, **TOL)
    np.testing.assert_allclose(lse.numpy(), _j_lse(case, q, k), **TOL)
    got = attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal,
                            window=window, cap=cap)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_function_matches_jax_vjp(case, monkeypatch):
    """``mha`` (model layout) under grad: the Function's CPU entries run,
    once forward and once backward; its gradients are the reference's."""
    causal, window, cap = case[6:]
    q, k, v, do = _inputs(case, 2)
    want_o, want = _j_grads(case, q, k, v, do)
    calls = []
    fwd, bwd = ops._TRAIN_BY_DEVICE["cpu"]

    def count(fn, what):
        def wrapped(*a, **kw):
            calls.append(what)
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setitem(ops._TRAIN_BY_DEVICE, "cpu",
                        (count(fwd, "fwd"), count(bwd, "bwd")))
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    out = ops.mha(tq, tk, tv, causal=causal, window=window, cap=cap)
    np.testing.assert_allclose(out.transpose(1, 2).detach().numpy(), want_o,
                               **TOL)
    # the output's gradient arrives as a strided view (grad of a transpose)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(do).transpose(1, 2))
    assert calls == ["fwd", "bwd"]
    for name, g, w in zip("qkv", grads, want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), w, **TOL,
                                   err_msg=f"d{name}")


def test_no_grad_makes_the_serving_call(monkeypatch):
    """Without a gradient wanted, ``mha`` calls the serving entry, once,
    and the training table not at all."""
    case = CASES[1]
    q, k, v, _ = _inputs(case, 3)
    calls = []
    serve = ops._BY_DEVICE["cpu"]
    monkeypatch.setitem(ops._BY_DEVICE, "cpu",
                        lambda *a, **kw: calls.append("serve")
                        or serve(*a, **kw))
    monkeypatch.setitem(ops._TRAIN_BY_DEVICE, "cpu", None)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    with torch.no_grad():
        ops.mha(tq, tk, tv)
    ops.mha(tq.detach(), tk.detach(), tv.detach())
    assert calls == ["serve", "serve"]


@pytest.mark.parametrize("case", [CASES[1], CASES[6]],
                         ids=["gqa-ragged", "cross"])
def test_broadcast_output_gradient_is_copied_contiguous(case, monkeypatch):
    """``out.sum()`` hands ``FlashAttention.backward`` a dO whose strides
    are all 0 (a broadcast view, which no TMA tensor map describes): the
    Function copies it contiguous before the backward runs, and the
    gradients equal those from a dO of ones with strides of their own."""
    causal, window, cap = case[6:]
    q, k, v, _ = _inputs(case, 4)
    strides = []
    fwd, bwd = ops._TRAIN_BY_DEVICE["cpu"]

    def record(*a, **kw):
        strides.append(a[5].stride())
        return bwd(*a, **kw)
    monkeypatch.setitem(ops._TRAIN_BY_DEVICE, "cpu", (fwd, record))

    def grads(loss):
        tq, tk, tv = (torch.from_numpy(x).transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        out = ops.mha(tq, tk, tv, causal=causal, window=window, cap=cap)
        return torch.autograd.grad(loss(out), (tq, tk, tv))
    by_sum = grads(lambda out: out.sum())
    by_ones = grads(lambda out: (out * torch.ones_like(out)).sum())
    b, h, _, s, _, d = case[:6]
    assert len(strides) == 2 and strides[0] == (h * s * d, s * d, d, 1), \
        strides
    for name, a, b in zip("qkv", by_sum, by_ones):
        torch.testing.assert_close(a, b, **TOL, msg=lambda m: f"d{name} {m}")


def _wrapper_calls():
    from repro_torch.kernels.decode_attention.decode_attention import \
        decode_attention
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import mlstm_chunk
    from repro_torch.kernels.moe_matmul.moe_matmul import moe_matmul
    from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan
    x = torch.zeros((1, 2, 4, 16), requires_grad=True)
    s = torch.zeros((1, 2, 4))
    return {
        "flash_attention": lambda: flash_attention(x, x, x),
        "decode_attention": lambda: decode_attention(
            x, x, x, torch.zeros(1, dtype=torch.int32)),
        "moe_matmul": lambda: moe_matmul(x[0], x[0].transpose(1, 2)),
        "rglru_scan": lambda: rglru_scan(x[0], x[0], x[0, :, 0]),
        "mlstm_chunk": lambda: mlstm_chunk(x, x, x, s, s, x, x[..., 0],
                                           s[..., 0], 0.25),
    }


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "moe_matmul", "rglru_scan",
                                  "mlstm_chunk"])
def test_kernel_wrappers_refuse_grad(name):
    """A wrapper whose output would carry no gradient raises under grad,
    naming the ROADMAP item; under ``no_grad`` it gets past the refusal
    (here, to the device check)."""
    call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match="ROADMAP queue 1 item 14"):
        call()
    with torch.no_grad():
        with pytest.raises((ValueError, RuntimeError)) as err:
            call()
    assert "ROADMAP" not in str(err.value)


# ---------------------------------------------------------------------------
# model level: the reference's query-chunked attention at S 1,024
# ---------------------------------------------------------------------------


def test_model_gradients_at_s1024_match_reference():
    """Reduced minicpm-2b at S 1,024 (two of the reference's 512-query
    chunks, each under ``jax.checkpoint``): loss and every gradient
    leaf."""
    tcfg = get_arch("minicpm-2b").reduced()
    jcfg = j_get_arch("minicpm-2b").reduced()
    tcfg = dataclasses.replace(tcfg, n_layers=2)
    jcfg = dataclasses.replace(jcfg, n_layers=2)
    jm = JLM(jcfg)
    rng = np.random.default_rng(7)
    # the zero norm scales drawn, so their gradients count
    arrays = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(0, 0.3, size=a.shape).astype(np.float32)
                         if "scale" in jax.tree_util.keystr(path)
                         else np.asarray(a)), jm.init(jax.random.PRNGKey(7)))
    toks = rng.integers(0, tcfg.vocab_size, size=(1, 1025)).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    jl, jg = jax.value_and_grad(
        lambda p: jm.train_loss(p, jnp.asarray(tokens), jnp.asarray(labels))
    )(jax.tree.map(jnp.asarray, arrays))
    tm = TransformerLM(tcfg, device="cpu")
    params = lm_params_from_arrays(tcfg, arrays, "cpu", torch.float32)
    for p in leaves(params):
        p.requires_grad_(True)
    loss = tm.train_loss(params, torch.from_numpy(tokens).long(),
                         torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    want = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, jg), "cpu",
                                 torch.float32)
    for p, w in zip(leaves(params), leaves(want)):
        np.testing.assert_allclose(p.grad.numpy(), w.numpy(), **TOL)
