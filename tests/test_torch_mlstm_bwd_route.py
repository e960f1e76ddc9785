"""The precision design of the mLSTM chunk backward's ``wgmma`` route, on
the CPU.

On the card the bfloat16 backward (``csrc/mlstm_chunk_bwd.cu``) runs every
product on the bf16 tensor cores in chunks of 64 steps.  The products of
bf16 inputs (q k^T, dh v^T, and q, k, v or dh against a state) are exact.
Six operands are float32, and each goes in as a bf16 high part plus the
bf16 rounding of what it leaves, two products summed in float32:

* ``C``: the chunk-start states C_c, in the states walk's q C_c and in
  dq's dh C_c^T (the workspace holds them as bf16 hi and lo planes);
* ``dC``: the state gradients dC_{c+1}, in dk's v dC^T and dv's k dC
  (planes too);
* ``deck``: the decayed keys exp(a_s - mx_L) k_s of the state recompute
  C <- carry C + (dec o k)^T v;
* ``gq``: q with scale inter_t / den_t folded into its rows, in the
  gradient walk dC <- carry dC + (coef / den o q)^T dh;
* ``ds``: scale (dsw o w), in dq's ds k and dk's ds^T q;
* ``swd``: sw with 1 / den_t folded into its rows, in dv's (sw / den)^T dh.

Row scalings of exact products go on the float32 accumulators after the
product (dq's scale inter / den, dk's and dv's decay).  ``_emulate_bwd``
repeats that arithmetic on the CPU in float32, in the kernel's order of
passes (states walk, per-chunk denominators, gradient walk, per-chunk
gradients); it is a test aid, and no trained path runs it.

* With the six splits every gradient holds within the card's gate
  (``chip_smoke.MLSTM_BWD_SHARE``: 1e-4 of its largest magnitude, rtol
  1e-2 for the bf16 dq, dk, dv and 1e-4 for the float32 ones) against
  the port's plain backward at the kernel's chunks, at B 1, H 2, D 256,
  S 300: a random and a zero initial state, free final-state seeds, input
  gates 3 below and 4 above (each normaliser branch at most steps) and an
  m0 that holds every chunk's max.
* With one bf16 rounding of any one of the six instead, some gradient
  leaves the gate by more than twice its width: the reason for each
  split (an operand whose single rounding held would not be split).

The file takes about 5 s on one CPU core.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (  # noqa: E402
    BWD_CHUNK, mlstm_bwd_route)
from repro_torch.kernels.mlstm_chunk.ref import (  # noqa: E402
    log_sigmoid, m0_holds_max, mlstm_chunk_bwd_ref, raw_normaliser)

SHARE = 1e-4                      # chip_smoke.MLSTM_BWD_SHARE
NAMES = ("dq", "dk", "dv", "di", "df", "dC0", "dn0", "dm0")
SPLITS = ("C", "dC", "deck", "gq", "ds", "swd")
B, H, D, S = 1, 2, 256, 300


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _parts(x, split):
    """x as the bf16 operands the kernel feeds the tensor cores: a high
    part and the rounding of the rest, or one rounding."""
    hi = _bf16(x)
    return (hi, _bf16(x - hi)) if split else (hi,)


def _gates(ip, fp, m0, cuts):
    """Each chunk's gate terms, m carried from chunk to chunk."""
    out, m = [], m0
    for sl in cuts:
        b = torch.cumsum(log_sigmoid(fp[:, sl]), dim=1)
        a = ip[:, sl] - b
        mx = torch.maximum(m[:, None], torch.cummax(a, dim=1).values)
        l = a.shape[1]
        causal = torch.tril(torch.ones((l, l), dtype=torch.bool))[
            None, :, :, None]
        w = torch.where(causal, torch.exp(a[:, None] - mx[:, :, None]),
                        torch.zeros(()))
        out.append(dict(a=a, m=m, inter=torch.exp(m[:, None] - mx),
                        dec=torch.exp(a - mx[:, -1:]),
                        carry=torch.exp(m - mx[:, -1]), w=w, causal=causal,
                        floor=torch.exp(-(b + mx)),
                        held=m >= a.max(dim=1).values))
        m = b[:, -1] + mx[:, -1]
    return out


def _emulate_bwd(q, k, v, ip, fp, C0, n0, m0, scale, dh, dC1, dn1, dm1,
                 split=SPLITS):
    """The wgmma route's arithmetic over q, k, v, dh [B, S, H, D] (bf16
    values in float32) with the operands in ``split`` as hi + lo pairs and
    the others rounded once -> (dq, dk, dv rounded to bf16; di, df, dC0,
    dn0, dm0), float32."""
    cuts = [slice(c0, min(c0 + BWD_CHUNK, q.shape[1]))
            for c0 in range(0, q.shape[1], BWD_CHUNK)]
    gs = _gates(ip, fp, m0, cuts)
    # the states walk: C_c as stored, n_c, dh_t . q_t C_c
    C, n, Cst, ns, es = C0, n0, [], [], []
    for sl, g in zip(cuts, gs):
        parts = _parts(C, "C" in split)
        Cst.append(sum(parts))
        ns.append(n)
        qc = sum(torch.einsum("bthd,bhdv->bthv", q[:, sl], p) for p in parts)
        es.append(torch.einsum("bthv,bthv->bth", qc, dh[:, sl]))
        C = g["carry"][..., None, None] * C + sum(
            torch.einsum("bshd,bshv->bhdv", p, v[:, sl])
            for p in _parts(k[:, sl] * g["dec"][..., None], "deck" in split))
        n = g["carry"][..., None] * n + torch.einsum("bshd,bsh->bhd",
                                                     k[:, sl], g["dec"])
    C1, n1 = C, n
    # per chunk: den, dden_raw, the exp branch's db, dm's inter share
    for sl, g, nc, e in zip(cuts, gs, ns, es):
        g["G"] = torch.einsum("bthv,bshv->btsh", dh[:, sl], v[:, sl])
        g["sw"] = torch.einsum("bthd,bshd->btsh", q[:, sl], k[:, sl]) * \
            scale * g["w"]
        deni = torch.einsum("bthd,bhd->bth", q[:, sl], nc) * scale * \
            g["inter"]
        draw = g["sw"].sum(dim=2) + deni
        den = torch.maximum(draw.abs(), g["floor"])
        einter = scale * g["inter"] * e
        hdh = ((g["sw"] * g["G"]).sum(dim=2) + einter) / den
        raw = draw.abs() >= g["floor"]
        g["den"], g["ddr"] = den, torch.where(raw, -torch.sign(draw) * hdh /
                                              den, torch.zeros(()))
        g["dbm"] = torch.where(raw, torch.zeros(()), hdh)
        g["dmi"] = (einter / den + deni * g["ddr"]).sum(dim=1)
    # the gradient walk: dC_{c+1} as stored, dn_{c+1}, <dC_{c+1}, C_c>
    dC = torch.zeros_like(C0) if dC1 is None else dC1
    dn = torch.zeros_like(n0) if dn1 is None else dn1
    for c in reversed(range(len(cuts))):
        sl, g = cuts[c], gs[c]
        g["dC"], g["dn"] = sum(_parts(dC, "dC" in split)), dn
        g["dmp"] = (dC * Cst[c]).sum((-2, -1)) + (dn * ns[c]).sum(-1)
        coef = scale * g["inter"]
        dC = g["carry"][..., None, None] * dC + sum(
            torch.einsum("bthd,bthv->bhdv", p, dh[:, sl])
            for p in _parts(q[:, sl] * (coef / g["den"])[..., None],
                            "gq" in split))
        dn = g["carry"][..., None] * dn + torch.einsum(
            "bth,bthd->bhd", coef * g["ddr"], q[:, sl])
    # the residual of mx_L's gradient, and where it goes chunk by chunk
    r = None
    if any(t is not None for t in (dC1, dn1, dm1)):
        r = torch.zeros_like(m0) if dm1 is None else dm1
        if dC1 is not None:
            r = r - (dC1 * C1).sum((-2, -1))
        if dn1 is not None:
            r = r - (dn1 * n1).sum(-1)
    zero = torch.zeros_like(m0)
    for g in reversed(gs):
        g["r"] = zero if r is None else r           # at the chunk's end
        r = None if r is None else torch.where(g["held"], r, zero)
        g["dm"] = g["dmi"] + g["carry"] * g["dmp"] + torch.where(
            g["held"], g["r"], zero)                # m_c's gradient
    # per chunk: dq, dk, dv and the gates
    outs = []
    for c, (sl, g) in enumerate(zip(cuts, gs)):
        qc, kc, vc, dhc = q[:, sl], k[:, sl], v[:, sl], dh[:, sl]
        den, ddr = g["den"], g["ddr"]
        dsw = torch.where(g["causal"], g["G"] / den[:, :, None] +
                          ddr[:, :, None], torch.zeros(()))
        ds = _parts(scale * dsw * g["w"], "ds" in split)
        dq = sum(torch.einsum("btsh,bshd->bthd", p, kc) for p in ds) + \
            (scale * g["inter"])[..., None] * (
                torch.einsum("bthv,bhdv->bthd", dhc, Cst[c]) /
                den[..., None] + ddr[..., None] * ns[c][:, None])
        dk = sum(torch.einsum("btsh,bthd->bshd", p, qc) for p in ds) + \
            g["dec"][..., None] * (torch.einsum("bshv,bhdv->bshd", vc,
                                                g["dC"]) + g["dn"][:, None])
        kdc = torch.einsum("bshd,bhdv->bshv", kc, g["dC"])
        dv = sum(torch.einsum("btsh,bthv->bshv", p, dhc) for p in _parts(
            g["sw"] / den[:, :, None], "swd" in split)) + \
            g["dec"][..., None] * kdc
        da = (dsw * g["sw"]).sum(dim=1) + g["dec"] * (
            (vc * kdc).sum(-1) + torch.einsum("bshd,bhd->bsh", kc, g["dn"]))
        top = torch.max(g["a"], dim=1)
        first = torch.arange(g["a"].shape[1])[None, :, None] == \
            top.indices[:, None]
        da = da + torch.where(first & ~g["held"][:, None], g["r"][:, None],
                              torch.zeros(()))
        db = g["dbm"] - da
        last = gs[c + 1]["dm"] if c + 1 < len(cuts) else \
            (zero if dm1 is None else dm1)
        db[:, -1] = db[:, -1] + last
        dlf = torch.flip(torch.cumsum(torch.flip(db, [1]), dim=1), [1])
        outs.append((dq, dk, dv, da, dlf * torch.sigmoid(-fp[:, sl])))
    dq, dk, dv, di, df = (torch.cat(xs, dim=1) for xs in zip(*outs))
    return _bf16(dq), _bf16(dk), _bf16(dv), di, df, dC, dn, gs[0]["dm"]


def _inputs(seed, state="random", final=True, ibias=0.0):
    """chip_smoke's backward cases at B 1, H 2, D 256, S 300: q, k, v ~
    0.5 N(0, 1) and dh ~ N(0, 1) in bf16, i ~ N(ibias, 1), f ~ N(3, 1); a
    random state (C, n ~ 0.1 N(0, 1), m ~ N(0, 1)), the zero state or a
    ``held`` one (m0 24 up, input gates 3 down: m0 holds every chunk's
    max); the final state's gradients ~ N(0, 1), each drawn on its own,
    or none."""
    rng = np.random.default_rng(seed)

    def f32(*shape, loc=0.0, sd=1.0):
        return torch.as_tensor(rng.normal(loc, sd, shape).astype(np.float32))
    q, k, v = (_bf16(f32(B, S, H, D, sd=0.5)) for _ in range(3))
    ip, fp = f32(B, S, H, loc=ibias), f32(B, S, H, loc=3.0)
    C0, n0, m0 = f32(B, H, D, D, sd=0.1), f32(B, H, D, sd=0.1), f32(B, H)
    if state == "zero":
        C0, n0, m0 = C0 * 0, n0 * 0, torch.full_like(m0, -1e30)
    elif state == "held":
        ip, m0 = ip - 3.0, m0 + 24.0
    dh = _bf16(f32(B, S, H, D))
    seeds = (f32(B, H, D, D), f32(B, H, D), f32(B, H)) if final else \
        (None,) * 3
    return (q, k, v, ip, fp, C0, n0, m0), dh, seeds


def _share(got, want):
    """The largest gap of each gradient as a share of the card's gate."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        atol = SHARE * float(w.abs().max())
        rtol = 1e-2 if name in ("dq", "dk", "dv") else 1e-4
        gap = (g.double() - w.double()).abs()
        width = atol + rtol * w.double().abs()
        out[name] = float(torch.where(gap == 0, torch.zeros(()),
                                      gap / width).max())
    return out


CASES = {"random": dict(), "zero": dict(state="zero", final=False),
         "low_gates": dict(ibias=-3.0), "high_gates": dict(ibias=4.0),
         "held": dict(state="held")}


@pytest.mark.parametrize("case", list(CASES))
def test_split_route_holds_the_gate(case):
    """bf16 takes the wgmma route; with its six hi + lo operands every
    gradient holds the card's gate against the plain backward."""
    args, dh, seeds = _inputs(7, **CASES[case])
    scale = 1.0 / math.sqrt(D)
    assert mlstm_bwd_route(torch.bfloat16, S, D) == "wgmma"
    if case in ("low_gates", "high_gates"):
        share = float(raw_normaliser(*args, scale, chunk=BWD_CHUNK).float()
                      .mean())
        assert share < 0.2 if case == "low_gates" else share > 0.8, share
    if case == "held":
        assert bool(m0_holds_max(*args, scale, chunk=BWD_CHUNK).all())
    got = _emulate_bwd(*args, scale, dh, *seeds)
    want = mlstm_chunk_bwd_ref(*args, scale, dh, *seeds, chunk=BWD_CHUNK)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(
            g, w.float(), atol=SHARE * float(w.abs().max()),
            rtol=1e-2 if name in ("dq", "dk", "dv") else 1e-4,
            msg=lambda m: f"{case} {name}: {m}")


@pytest.mark.parametrize("operand", SPLITS)
def test_one_rounding_of_each_split_operand_breaks_the_gate(operand):
    """One bf16 rounding of ``operand`` in place of its hi + lo pair, the
    other five split: some gradient leaves the gate by more than twice its
    width, where the full split stays inside it."""
    args, dh, seeds = _inputs(7)
    scale = 1.0 / math.sqrt(D)
    want = mlstm_chunk_bwd_ref(*args, scale, dh, *seeds, chunk=BWD_CHUNK)
    split = _share(_emulate_bwd(*args, scale, dh, *seeds), want)
    single = _share(_emulate_bwd(*args, scale, dh, *seeds, split=tuple(
        o for o in SPLITS if o != operand)), want)
    assert max(split.values()) <= 1.0, split
    assert max(single.values()) > 2.0, (operand, single)
