"""The precision design of the flash-attention backward's ``wgmma`` route,
on the CPU.

On the card the bfloat16 route (``csrc/flash_attention_bwd.cu``) runs
its products on the bf16 tensor cores: S = Q K^T and dP = dO V^T of bf16
operands exactly (fp32 sums), and the two products with a float32 operand
(dV += P^T dO, dK += dS^T Q; dQ += dS K) with P and dS as a bf16 high
part plus the bf16 rounding of what it leaves, two products summed in
float32.  P = 2^(z - lse log2 e) with z the logit in log2 units.  The
dK / dV kernel walks a block of keys over the group's heads and their
query tiles of 64, the dQ kernel a block of queries over key tiles of 64.
``_emulate`` repeats that order and rounding on the CPU in float32; it is
a test aid, and no path runs it.

* With the split, dq, dk and dv (rounded to bf16, as the kernel writes
  them) hold against the port's plain version ``attention_bwd_ref`` on
  the same o and lse within ``ATTN_BF16_ROUNDING`` (atol 1e-3, rtol
  1e-2), and against ``jax.vjp`` of the reference's attention within
  ``ATTN_TOL``'s bfloat16 band (atol 2e-2, rtol 2e-1), the card's gates
  (``chip_smoke.py``): causal, window, cap 50, GQA, Sk != Sq, ragged S 1
  and 65, at D 16, 32, 64, 128 and 256.
* With one bf16 rounding of P, or of dS, instead (the other split), the
  same cases are measured against ``ATTN_BF16_ROUNDING``: either single
  rounding breaks that gate (P moves dv up to ~6x past it, dS moves dq
  and dk up to ~4x), the reason both products carry the low half.

Shapes are reduced (B 1-2, H 2-8, S up to 200); the tests take a few
seconds on one CPU core, JAX's start-up aside.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import \
    attention_ref as j_attention_ref  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_fwd_ref)

ROUNDING = dict(atol=1e-3, rtol=1e-2)    # chip_smoke.ATTN_BF16_ROUNDING
BAND = dict(atol=2e-2, rtol=2e-1)        # chip_smoke.ATTN_TOL["bfloat16"]
LOG2E = 1.4426950408889634
BT = 64                                  # streamed tile rows, both kernels

#: (B, H, KV, Sq, Sk, D, causal, window, cap)
CASES = [
    (1, 4, 4, 130, 130, 64, True, 0, 0.0),      # causal, two key blocks
    (1, 8, 2, 200, 200, 128, True, 48, 0.0),    # GQA 4, window
    (1, 4, 2, 150, 150, 256, True, 0, 50.0),    # gemma2: D 256, cap 50
    (1, 4, 2, 96, 96, 32, True, 24, 50.0),      # window and cap
    (2, 4, 4, 37, 150, 64, False, 0, 0.0),      # Sk != Sq, no mask
    (1, 2, 2, 150, 37, 16, False, 0, 0.0),      # Sq > Sk
    (1, 4, 2, 65, 65, 64, True, 0, 0.0),        # ragged 65
    (1, 4, 2, 1, 1, 64, True, 0, 0.0),          # S 1
    (1, 2, 2, 1, 65, 16, False, 0, 0.0),        # one query over 65 keys
]
IDS = ["causal", "gqa-window-d128", "cap-d256", "window-cap-d32",
       "cross", "cross-long-q-d16", "ragged65", "s1", "one-query"]


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _parts(x, split):
    """x as the bf16 A operands the kernel feeds the tensor cores: a high
    part and the rounding of the rest, or one rounding."""
    hi = _bf16(x)
    return (hi, _bf16(x - hi)) if split else (hi,)


def _tiles(d):
    """(keys a dK / dV block, query rows a dQ block) at head dim d."""
    return (64, 64) if d == 256 else (128, 128)


def _mask(s, sk, causal, window):
    qp = torch.arange(s)[:, None]
    kp = torch.arange(sk)[None, :]
    ok = torch.ones((s, sk), dtype=torch.bool)
    if causal:
        ok &= qp >= kp
    if window:
        ok &= qp - kp < window
    return ok


def _p_ds(s, dp, l2, delta, ok, scale, cap):
    """P and dS of raw scores s (fp32 sums of bf16 products) in the
    kernel's log2 units, 0 where ``ok`` is False."""
    if cap:
        t = torch.tanh(s * (scale / cap))
        z, d = cap * LOG2E * t, 1.0 - t * t
    else:
        z, d = s * (scale * LOG2E), 1.0
    p = torch.where(ok, torch.exp2(z - l2), torch.zeros(()))
    return p, p * (dp - delta) * (d * scale)


def _emulate(q, k, v, o, lse, do, causal, window, cap, split_p, split_ds):
    """The wgmma route's arithmetic over head-major float32 tensors of
    bf16 values -> (dq, dk, dv) rounded to bf16 (as float32); P and dS
    as bf16 hi + lo pairs, or each as one rounding."""
    b, h, s, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    keys, rows = _tiles(d)
    ok = _mask(s, sk, causal, window)
    delta = (do * o).sum(-1)                       # the pre-pass
    l2 = lse * LOG2E
    qg, dog = q.view(b, kv, g, s, d), do.view(b, kv, g, s, d)
    l2g, deltag = l2.view(b, kv, g, s), delta.view(b, kv, g, s)

    # dK / dV: a block of keys, keys as rows, over heads, then query tiles
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, sk, keys):
        ks = slice(k0, min(k0 + keys, sk))
        kt, vt = k[:, :, ks], v[:, :, ks]
        acc_k, acc_v = torch.zeros_like(kt), torch.zeros_like(vt)
        for gi in range(g):
            for q0 in range(0, s, BT):
                qs = slice(q0, min(q0 + BT, s))
                qt, dot = qg[:, :, gi, qs], dog[:, :, gi, qs]
                p, ds = _p_ds(kt @ qt.transpose(-1, -2),
                              vt @ dot.transpose(-1, -2),
                              l2g[:, :, gi, None, qs],
                              deltag[:, :, gi, None, qs], ok[qs, ks].T,
                              scale, cap)
                for part in _parts(p, split_p):
                    acc_v = acc_v + part @ dot
                for part in _parts(ds, split_ds):
                    acc_k = acc_k + part @ qt
        dk[:, :, ks], dv[:, :, ks] = acc_k, acc_v

    # dQ: a block of queries over key tiles
    kr = k[:, :, None].expand(b, kv, g, sk, d).reshape(b, h, sk, d)
    vr = v[:, :, None].expand(b, kv, g, sk, d).reshape(b, h, sk, d)
    dq = torch.zeros_like(q)
    for q0 in range(0, s, rows):
        qs = slice(q0, min(q0 + rows, s))
        acc = torch.zeros_like(q[:, :, qs])
        for k0 in range(0, sk, BT):
            ks = slice(k0, min(k0 + BT, sk))
            _, ds = _p_ds(q[:, :, qs] @ kr[:, :, ks].transpose(-1, -2),
                          do[:, :, qs] @ vr[:, :, ks].transpose(-1, -2),
                          l2[:, :, qs, None], delta[:, :, qs, None],
                          ok[qs, ks], scale, cap)
            for part in _parts(ds, split_ds):
                acc = acc + part @ kr[:, :, ks]
        dq[:, :, qs] = acc
    return _bf16(dq), _bf16(dk), _bf16(dv)


def _inputs(case, seed):
    """Seeded bf16 q, k, v, dO (head-major), the forward's bf16 o and its
    float32 lse from the plain version."""
    b, h, kv, s, sk, d, causal, window, cap = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.as_tensor(rng.normal(size=shape),
                                   dtype=torch.float32).to(torch.bfloat16)
                   for shape in ((b, h, s, d), (b, kv, sk, d),
                                 (b, kv, sk, d), (b, h, s, d)))
    o, lse = attention_fwd_ref(q, k, v, causal=causal, window=window,
                               cap=cap)
    return q, k, v, do, o, lse


def _j_grads(case, q, k, v, do):
    """``jax.vjp`` of the reference's attention (``attention_ref``, or its
    model attention's ``_sdpa`` for keys of their own length)."""
    b, h, kv, s, sk, d, causal, window, cap = case
    if s == sk:
        def fn(q, k, v):
            return j_attention_ref(q, k, v, causal=causal, window=window,
                                   cap=cap)
    else:
        def fn(q, k, v):
            qg = jnp.moveaxis(q, 1, 2).reshape(b, s, kv, h // kv, d)
            q_pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
            k_pos = jnp.broadcast_to(jnp.arange(sk)[None], (b, sk))
            out = j_attn._sdpa(qg, jnp.moveaxis(k, 1, 2),
                               jnp.moveaxis(v, 1, 2), q_pos, k_pos, causal,
                               window, cap, 1.0 / np.sqrt(d))
            return jnp.moveaxis(out, 2, 1)
    arrays = [jnp.asarray(t.float().numpy()) for t in (q, k, v)]
    _, vjp = jax.vjp(fn, *arrays)
    return [np.asarray(g) for g in vjp(jnp.asarray(do.float().numpy()))]


def _excess(got, want, tol):
    """The largest |got - want| / (atol + rtol |want|): at most 1 inside
    the gate."""
    return float(((got - want).abs()
                  / (tol["atol"] + tol["rtol"] * want.abs())).max())


@functools.lru_cache(maxsize=None)
def _run(case, split_p=True, split_ds=True, seed=0):
    causal, window, cap = case[6:]
    q, k, v, do, o, lse = _inputs(case, seed)
    got = _emulate(q.float(), k.float(), v.float(), o.float(), lse,
                   do.float(), causal, window, cap, split_p, split_ds)
    plain = attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                              window=window, cap=cap)
    return (q, k, v, do), got, [t.float() for t in plain]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_route_holds_against_the_plain_version(case):
    _, got, plain = _run(case)
    for name, g, p in zip("qkv", got, plain):
        assert g.shape == p.shape, name
        torch.testing.assert_close(g, p, **ROUNDING,
                                   msg=lambda m: f"d{name}: {m}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_route_holds_against_jax_vjp(case):
    (q, k, v, do), got, _ = _run(case)
    want = _j_grads(case, q, k, v, do)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, **BAND, err_msg=f"d{name}")


@pytest.mark.parametrize("single", ["P", "dS"])
def test_single_rounding_breaks_the_rounding_gate(single):
    """One bf16 rounding of P (dV's operand) or of dS (dK's and dQ's), the
    other still split: each gradient's excess over ``ATTN_BF16_ROUNDING``
    at every case, beside the split's.  The split stays inside the gate
    everywhere; either single rounding goes past it (P: dv, up to ~6x;
    dS: dq and dk, up to ~4x), by far more than the split's worst."""
    split, alone = [], []
    for case in CASES:
        for kw, out in (({}, split), ({f"split_{single.lower()}": False},
                                      alone)):
            _, got, plain = _run(case, **kw)
            out.append([_excess(g, p, ROUNDING) for g, p in zip(got, plain)])
    worst_split = max(max(row) for row in split)
    moved = [2] if single == "P" else [0, 1]     # of (dq, dk, dv)
    worst_alone = max(row[i] for row in alone for i in moved)
    assert worst_split <= 1.0, split
    assert worst_alone > 2.0 and worst_alone > 3 * worst_split, alone
