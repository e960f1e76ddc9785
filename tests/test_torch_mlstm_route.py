"""The precision design of the chunkwise mLSTM kernel's ``wgmma`` route,
on the CPU.

On the card the bfloat16 prefill route (``csrc/mlstm_chunk.cu``) runs its
products on the bf16 tensor cores in chunks of 64 steps: q k^T of bf16
operands exactly, and the three products with a float32 operand (q C
with the state C, sw V with the weighted scores sw, and the C update
with the decayed values exp(a_s - mx_L) v_s) as a bf16 high part plus
the bf16 rounding of what it leaves, two products summed in float32.
``_emulate`` repeats that rounding on the CPU in float32; it is a test
aid, and no served path runs it.

* With the split, h (rounded to bf16, as the kernel writes it) and the
  float32 state hold against the port's plain version from a nonzero
  state, at S on both sides of the chunk edges, and h against the
  reference's sequential ``mlstm_ref`` from the zero state, within the
  card's gates (``chip_smoke.py``): h within atol 1e-3, rtol 1e-2, the
  state within atol 5e-4, rtol 1e-3.
* With one bf16 rounding of each float32 operand instead, h and C both
  break those gates (about 4.9x and 6.3x at B 1, S 300, H 2, D 256):
  the reason for the split.

Shapes are reduced (B 1, H 2, D 256, S up to 300); the tests take about
2.5 s on one CPU core, JAX's start-up aside.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mlstm_chunk.ref import mlstm_ref as j_mlstm_ref  # noqa
from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (  # noqa: E402
    CHUNK, mlstm_route)
from repro_torch.kernels.mlstm_chunk.ref import (log_sigmoid,  # noqa: E402
                                                 mlstm_chunk_ref)

H_TOL = dict(atol=1e-3, rtol=1e-2)        # chip_smoke.MLSTM_BF16_TOL
STATE_TOL = dict(atol=5e-4, rtol=1e-3)    # chip_smoke.MLSTM_TOL
B, H, D = 1, 2, 256


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _parts(x, split):
    """x as the bf16 operands the kernel feeds the tensor cores: a high
    part and the rounding of the rest, or one rounding."""
    hi = _bf16(x)
    return (hi, _bf16(x - hi)) if split else (hi,)


def _emulate(q, k, v, ip, fp, C, n, m, scale, split):
    """The wgmma route's arithmetic over q, k, v [B, S, H, D] (bf16
    values in float32) from the state (C, n, m) -> (h, C, n, m) in
    float32, chunk by chunk in ``mlstm_chunk_math``'s order."""
    s, chunk, hs = q.shape[1], CHUNK["wgmma"], []
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(c0 + chunk, s))
        qc, kc, vc = q[:, sl], k[:, sl], v[:, sl]
        l = qc.shape[1]
        b = torch.cumsum(log_sigmoid(fp[:, sl]), dim=1)
        a = ip[:, sl] - b
        mx = torch.maximum(m[:, None], torch.cummax(a, dim=1).values)
        isc = scale * torch.exp(m[:, None] - mx)
        causal = torch.tril(torch.ones((l, l), dtype=torch.bool))
        w = torch.where(causal[None, :, :, None],
                        torch.exp(a[:, None] - mx[:, :, None]),
                        torch.zeros(()))
        sw = torch.einsum("bthd,bshd->btsh", qc, kc) * scale * w
        inter = sum(torch.einsum("bthd,bhdv->bthv", qc, p)
                    for p in _parts(C, split))
        intra = sum(torch.einsum("btsh,bshv->bthv", p, vc)
                    for p in _parts(sw, split))
        den = torch.maximum(
            torch.abs(sw.sum(dim=2)
                      + torch.einsum("bthd,bhd->bth", qc, n) * isc),
            torch.exp(-(b + mx)))
        hs.append((inter * isc[..., None] + intra) / den[..., None])
        mx_e = mx[:, -1]
        dec = torch.exp(a - mx_e[:, None])
        carry = torch.exp(m - mx_e)
        C = carry[..., None, None] * C + sum(
            torch.einsum("bshd,bshv->bhdv", kc, p)
            for p in _parts(vc * dec[..., None], split))
        n = carry[..., None] * n + torch.einsum("bshd,bsh->bhd", kc, dec)
        m = b[:, -1] + mx_e
    return torch.cat(hs, dim=1), C, n, m


def _inputs(seed, s, zero_state=False):
    """The reference kernel test's distributions: q, k, v ~ 0.5 N(0, 1)
    in bf16, i ~ N(0, 1), f ~ N(3, 1); a nonzero state (C, n ~ 0.1 N(0,
    1), m ~ N(0, 1)) or the zero state."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.normal(0, 0.5, (B, s, H, D))
                               .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    ip = torch.as_tensor(rng.normal(size=(B, s, H)).astype(np.float32))
    fp = torch.as_tensor((rng.normal(size=(B, s, H)) + 3.0)
                         .astype(np.float32))
    if zero_state:
        state = (torch.zeros((B, H, D, D)), torch.zeros((B, H, D)),
                 torch.full((B, H), -1e30))
    else:
        state = tuple(torch.as_tensor(x.astype(np.float32)) for x in (
            rng.normal(0, 0.1, (B, H, D, D)), rng.normal(0, 0.1, (B, H, D)),
            rng.normal(size=(B, H))))
    return (q, k, v, ip, fp), state


def _share(got, want, atol, rtol):
    """The largest |got - want| as a share of atol + rtol |want|."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _route(operands, state, split):
    q, k, v, ip, fp = operands
    h, C, n, m = _emulate(q.float(), k.float(), v.float(), ip, fp, *state,
                          1.0 / math.sqrt(D), split)
    return h.to(torch.bfloat16), C, n, m


@pytest.mark.parametrize("s", [63, 64, 65, 129, 300])
def test_split_rounding_holds_against_the_plain_version(s):
    """bf16 prefill takes the wgmma route; with its hi + lo operands h
    and the state hold the card's gates against the plain version."""
    operands, state = _inputs(s, s)
    assert mlstm_route(torch.bfloat16, s) == "wgmma"
    got = _route(operands, state, split=True)
    want = mlstm_chunk_ref(*operands, *state, 1.0 / math.sqrt(D))
    torch.testing.assert_close(got[0].float(), want[0].float(), **H_TOL)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, **STATE_TOL)


def test_split_rounding_holds_against_the_reference_recurrence():
    """From the zero state, h against the reference's sequential
    ``mlstm_ref`` (q pre-scaled on its side) on the same bf16 values."""
    operands, state = _inputs(7, 300, zero_state=True)
    got = _route(operands, state, split=True)[0]
    q, k, v, ip, fp = (x.float().numpy() for x in operands)
    bhsd = (lambda x: jnp.asarray(np.moveaxis(x, 2, 1)))   # noqa: E731
    ref = np.asarray(j_mlstm_ref(bhsd(q / math.sqrt(D)), bhsd(k), bhsd(v),
                                 bhsd(ip), bhsd(fp)))
    want = torch.as_tensor(np.array(np.moveaxis(ref, 1, 2)))
    torch.testing.assert_close(got.float(), want, **H_TOL)


def test_one_bf16_rounding_breaks_both_gates():
    """One bf16 rounding of C, sw and the decayed values in place of the
    hi + lo pair: h and C leave the gates by several times their width."""
    operands, state = _inputs(300, 300)
    want = mlstm_chunk_ref(*operands, *state, 1.0 / math.sqrt(D))
    split = _route(operands, state, split=True)
    single = _route(operands, state, split=False)
    h_split = _share(split[0].float(), want[0].float(), **H_TOL)
    c_split = _share(split[1], want[1], **STATE_TOL)
    h_single = _share(single[0].float(), want[0].float(), **H_TOL)
    c_single = _share(single[1], want[1], **STATE_TOL)
    assert h_split <= 1.0 and c_split <= 1.0
    assert h_single > 2.0 and c_single > 2.0, (h_single, c_single)
