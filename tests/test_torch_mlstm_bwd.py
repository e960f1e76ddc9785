"""The mLSTM chunk's backward against the reference, on the CPU.

The reference has no backward kernel: XLA differentiates its
``models/recurrent.py::mlstm_chunk_math`` under ``mlstm_seq``'s scan over
chunks.  The port's plain backward ``mlstm_chunk_bwd_ref`` holds the
stabiliser mx constant but for the final state's residual dm1 - <dC1,
C1> - <dn1, n1>, routed to the max that sets mx, and carries m live
across chunks (``ref.py``).  Most tests here seed the final state as a
downstream that reads its represented value does (dm1 = <dC1, C1> +
<dn1, n1>, the residual 0); the free-seed tests draw dm1 on its own, so
the residual's routing decides them.

* ``MlstmChunk`` (``ops.mlstm`` under grad) against ``jax.grad`` of the
  reference's ``mlstm_chunk_math`` chained over the same chunks: B 2,
  H 2, D 16 and 32, S 1, 7, 64, 100, 300 and 512 (two chunks), zero and
  nonzero initial states (dC0, dn0, dm0 too), dh with and without the
  final state's gradients, and inputs on either normaliser branch, each
  leaf within atol 1e-4 + 1e-4 of its largest value, rtol 1e-4;
* ``mlstm_seq``'s gradients (params, x and the state) against
  ``jax.grad`` of the reference's ``mlstm_seq``, the same tolerance; at S
  300 the witness decides: the port within 2x the gap between the
  reference's own chunkwise ``mlstm_seq`` and its sequential
  ``mlstm_seq_ref``, where that is larger;
* ``mlstm_chunk_bwd_ref`` against ``torch.autograd`` of
  ``mlstm_chunk_ref`` within 1e-5 (and 1e-5 of each leaf's largest
  value), and at
  chunks 32, 64 and 256 against each other within 1e-4;
* many short chunks (chunk 4 at S 16 and 37, strong forget gates): the
  gradient that crosses chunk boundaries through m1 = b_L + mx_L is
  large there, and the plain backward matches ``jax.grad`` of the chained
  reference, so a backward that dropped it would not;
* free final-state seeds (dm1 ~ N(0, 1), and dC1 or dn1 alone): the
  Function and the plain backward at chunks 4 and 64 against ``jax.grad``
  of the chained reference, with initial states whose m0 holds the max
  over a chunk's a_s (the residual goes to dm0 and back across chunks)
  and states where it does not (to da at the argmax);
* under grad ``mlstm_seq`` returns the serving call's values bitwise, and
  on CPU tensors nothing counts as a launch.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import recurrent as j_rec  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ops  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ref import (  # noqa: E402
    m0_holds_max, mlstm_chunk_bwd_ref, mlstm_chunk_ref, model_chunk,
    raw_normaliser)
from repro_torch.models import recurrent as t_rec  # noqa: E402

NAMES = ("q", "k", "v", "i_pre", "f_pre", "C0", "n0", "m0")
#: each leaf within atol 1e-4 plus 1e-4 of its largest value, and rtol
#: 1e-4: float32 sums in another order than XLA's autodiff takes them (a
#: leaf that is zero up to rounding, as df at S 1 from the zero state,
#: where m_0 = i_0, sits under the absolute part)
LEAF = 1e-4


def _operands(seed, b, s, h, d, state, ibias=0.0, fbias=3.0):
    """q, k, v ~ 0.5 N(0, 1), i ~ N(ibias, 1), f ~ N(fbias, 1), a zero
    (m -1e30) or random state, dh ~ N(0, 1), dC1, dn1 ~ N(0, 1), numpy
    float32."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    q, k, v = (rng.normal(0, 0.5, (b, s, h, d)).astype(f32)
               for _ in range(3))
    ip = (rng.normal(size=(b, s, h)) + ibias).astype(f32)
    fp = (rng.normal(size=(b, s, h)) + fbias).astype(f32)
    if state == "zero":
        st = (np.zeros((b, h, d, d), f32), np.zeros((b, h, d), f32),
              np.full((b, h), -1e30, f32))
    else:
        st = (rng.normal(0, 0.1, (b, h, d, d)).astype(f32),
              rng.normal(0, 0.1, (b, h, d)).astype(f32),
              rng.normal(size=(b, h)).astype(f32))
    dh = rng.normal(size=(b, s, h, d)).astype(f32)
    dC1 = rng.normal(size=(b, h, d, d)).astype(f32)
    dn1 = rng.normal(size=(b, h, d)).astype(f32)
    return (q, k, v, ip, fp) + st, dh, dC1, dn1


def _j_chain(args, l, scale):
    """The reference's ``mlstm_chunk_math`` over chunks of ``l`` (the last
    ragged), carrying the state: (h, C1, n1, m1)."""
    q, k, v, ip, fp, C, n, m = args
    s, hs = q.shape[1], []
    for c0 in range(0, s, l):
        sl = slice(c0, min(c0 + l, s))
        h, C, n, m = j_rec.mlstm_chunk_math(q[:, sl], k[:, sl], v[:, sl],
                                            ip[:, sl], fp[:, sl], C, n, m,
                                            scale)
        hs.append(h)
    return jnp.concatenate(hs, axis=1), C, n, m


def _j_grads(args, dh, dC1, dn1, l, scale, final):
    """``jax.grad`` of sum(h dh) (+ sum(C1 dC1) + sum(n1 dn1) + sum(m1
    dm1) with dm1 the represented value's, when ``final``) through the
    chained reference; returns (the 8 gradients, dm1 or None)."""
    args = tuple(map(jnp.asarray, args))
    dm1 = None
    if final:
        _, C1, n1, _ = _j_chain(args, l, scale)
        dm1 = np.array(jnp.sum(C1 * dC1, axis=(-2, -1))
                       + jnp.sum(n1 * dn1, axis=-1))

    def loss(*a):
        h, C1, n1, m1 = _j_chain(a, l, scale)
        out = jnp.sum(h * dh)
        if final:
            out = out + jnp.sum(C1 * dC1) + jnp.sum(n1 * dn1) + \
                jnp.sum(m1 * dm1)
        return out
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(8))))(*args)
    return [np.asarray(g) for g in grads], dm1


def _held(got, want, share=LEAF, what=""):
    for name, g, w in zip(NAMES, got, want):
        g = g.detach().float().numpy() if torch.is_tensor(g) else g
        w = w.detach().float().numpy() if torch.is_tensor(w) else w
        np.testing.assert_allclose(g, w, atol=share * (1 + np.abs(w).max()),
                                   rtol=1e-4, err_msg=f"{what} d{name}")


CASES = [(1, 16, "zero"), (7, 16, "random"), (64, 32, "random"),
         (100, 16, "zero"), (300, 16, "random"), (512, 16, "random")]


@pytest.mark.parametrize("final", [True, False], ids=["final", "h_only"])
@pytest.mark.parametrize("s,d,state", CASES)
def test_function_gradients_match_reference_grad(s, d, state, final):
    """Gradients of every input through ``ops.mlstm`` under grad (the CPU
    takes the plain forward and backward at the model's chunks) against
    ``jax.grad`` of the chained reference at the same chunks."""
    b, h = 2, 2
    args, dh, dC1, dn1 = _operands(s + d, b, s, h, d, state)
    scale = 1.0 / math.sqrt(d)
    want, dm1 = _j_grads(args, dh, dC1, dn1, model_chunk(s), scale, final)
    leaves = [torch.as_tensor(a).requires_grad_() for a in args]
    kernels.reset_launch_counts()
    hh, C1, n1, m1 = ops.mlstm(*leaves, scale)
    assert type(hh.grad_fn).__name__ == "MlstmChunkBackward"
    loss = (hh * torch.as_tensor(dh)).sum()
    if final:
        loss = loss + (C1 * torch.as_tensor(dC1)).sum() + \
            (n1 * torch.as_tensor(dn1)).sum() + \
            (m1 * torch.as_tensor(dm1)).sum()
    loss.backward()
    assert not any(kernels.launch_counts().values())
    _held([t.grad for t in leaves], want, what=f"S {s}")


@pytest.mark.parametrize("ibias,branch", [(-3.0, "exp"), (4.0, "raw")])
def test_function_gradients_on_each_normaliser_branch(ibias, branch):
    """Input gates drawn low: exp(-m_t) is the normaliser at most steps
    (its gradient goes to db_t); drawn high: |den_raw| is (to dq, dk and
    the state through dden_raw).  Both against ``jax.grad``."""
    b, s, h, d = 2, 64, 2, 16
    args, dh, dC1, dn1 = _operands(3, b, s, h, d, "random", ibias)
    scale = 1.0 / math.sqrt(d)
    share = float(raw_normaliser(*map(torch.as_tensor, args), scale)
                  .float().mean())
    assert (share < 0.2) if branch == "exp" else (share > 0.8)
    want, dm1 = _j_grads(args, dh, dC1, dn1, s, scale, True)
    leaves = [torch.as_tensor(a).requires_grad_() for a in args]
    hh, C1, n1, m1 = ops.mlstm(*leaves, scale)
    ((hh * torch.as_tensor(dh)).sum() + (C1 * torch.as_tensor(dC1)).sum()
     + (n1 * torch.as_tensor(dn1)).sum()
     + (m1 * torch.as_tensor(dm1)).sum()).backward()
    _held([t.grad for t in leaves], want, what=branch)


@pytest.mark.parametrize("s", [16, 37])
def test_m_carries_the_forget_gates_across_short_chunks(s):
    """Chunks of 4 under strong forget gates (f ~ N(-1, 1)): the gradient
    reaching each chunk's gates through the next chunk's m1 = b_L + mx_L
    (dm1 into db_L, dm0 back a chunk) is a large part of df.  The plain
    backward at chunk 4 matches ``jax.grad`` of the reference chained at
    chunk 4, the final state's gradients seeded."""
    b, h, d = 2, 2, 16
    args, dh, dC1, dn1 = _operands(s, b, s, h, d, "random", fbias=-1.0)
    scale = 1.0 / math.sqrt(d)
    want, dm1 = _j_grads(args, dh, dC1, dn1, 4, scale, True)
    t = [torch.as_tensor(a) for a in args]
    got = mlstm_chunk_bwd_ref(*t, scale, torch.as_tensor(dh),
                              torch.as_tensor(dC1), torch.as_tensor(dn1),
                              torch.as_tensor(dm1), chunk=4)
    order = (0, 1, 2, 3, 4, 5, 6, 7)
    _held([got[i] for i in order], want, what=f"chunk 4, S {s}")
    # the crossing term is no rounding: one chunk of S differs from chunks
    # of 4 only by rounding, and the cross-chunk share of df is large
    one = mlstm_chunk_bwd_ref(*t, scale, torch.as_tensor(dh),
                              torch.as_tensor(dC1), torch.as_tensor(dn1),
                              torch.as_tensor(dm1), chunk=s)
    np.testing.assert_allclose(got[4].numpy(), one[4].numpy(),
                               atol=LEAF * (1 + float(one[4].abs().max())),
                               rtol=1e-4)


def _autograd(t, scale, dh, dC1, dn1, chunk):
    """torch.autograd of ``mlstm_chunk_ref`` with the represented value's
    dm1: (the 8 gradients, dm1)."""
    leaves = [a.clone().requires_grad_() for a in t]
    hh, C1, n1, m1 = mlstm_chunk_ref(*leaves, scale, chunk=chunk)
    dm1 = ((dC1 * C1).sum((-2, -1)) + (dn1 * n1).sum(-1)).detach()
    ((hh * dh).sum() + (C1 * dC1).sum() + (n1 * dn1).sum()
     + (m1 * dm1).sum()).backward()
    return [a.grad for a in leaves], dm1


@pytest.mark.parametrize("s,chunk,state", [(37, 8, "random"),
                                           (100, 32, "zero"),
                                           (130, 64, "random")])
def test_plain_backward_matches_autograd_of_the_plain_forward(s, chunk,
                                                              state):
    b, h, d = 2, 2, 16
    args, dh, dC1, dn1 = _operands(7 * s, b, s, h, d, state)
    t = [torch.as_tensor(a) for a in args]
    dh, dC1, dn1 = map(torch.as_tensor, (dh, dC1, dn1))
    scale = 1.0 / math.sqrt(d)
    want, dm1 = _autograd(t, scale, dh, dC1, dn1, chunk)
    got = mlstm_chunk_bwd_ref(*t, scale, dh, dC1, dn1, dm1, chunk=chunk)
    assert got[0].dtype == torch.float32
    _held(got, want, share=1e-5, what=f"chunk {chunk}")


def test_plain_backward_at_chunks_32_64_256_agree():
    b, s, h, d = 2, 300, 2, 16
    args, dh, dC1, dn1 = _operands(11, b, s, h, d, "random")
    t = [torch.as_tensor(a) for a in args]
    dh, dC1, dn1 = map(torch.as_tensor, (dh, dC1, dn1))
    scale = 1.0 / math.sqrt(d)
    _, C1, n1, _ = mlstm_chunk_ref(*t, scale)
    dm1 = (dC1 * C1).sum((-2, -1)) + (dn1 * n1).sum(-1)
    sides = [mlstm_chunk_bwd_ref(*t, scale, dh, dC1, dn1, dm1, chunk=c)
             for c in (32, 64, 256)]
    for other in sides[1:]:
        _held(other, sides[0], what="chunks")


def test_plain_backward_takes_bfloat16_and_returns_its_dtype():
    b, s, h, d = 1, 20, 2, 16
    args, dh, _, _ = _operands(5, b, s, h, d, "random")
    t = [torch.as_tensor(a) for a in args]
    bf = [x.to(torch.bfloat16) for x in t[:3]]
    got = mlstm_chunk_bwd_ref(*bf, *t[3:], 0.25,
                              torch.as_tensor(dh).to(torch.bfloat16))
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + \
        [torch.float32] * 5
    want = mlstm_chunk_bwd_ref(*[x.float() for x in bf], *t[3:], 0.25,
                               torch.as_tensor(dh).to(torch.bfloat16)
                               .float())
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))


def _params(seed, d, h, hd):
    p = {k: np.array(v) for k, v in
         j_rec.mlstm_init(jax.random.PRNGKey(seed), d, h, hd).items()}
    return p


def _seq_grads(seq, p, x, st, dy):
    def loss(p, x, st):
        y, _ = seq(p, x, st)
        return jnp.sum(y * dy)
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jax.tree.map(jnp.asarray, st))
    return jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("s", [1, 37, 64, 300])
def test_mlstm_seq_gradients_match_reference(s):
    """Params, x and a nonzero state: the port's ``mlstm_seq`` under grad
    against ``jax.grad`` of the reference's.  At S 300 (one chunk of 300)
    each leaf may also sit within 2x the reference's own gap between its
    chunkwise ``mlstm_seq`` and its sequential ``mlstm_seq_ref``."""
    d, h, hd = 64, 4, 16
    p = _params(1, d, h, hd)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, d)).astype(np.float32)
    dy = rng.normal(size=(2, s, d)).astype(np.float32)
    st = {"C": rng.normal(0, 0.1, (2, h, hd, hd)).astype(np.float32),
          "n": rng.normal(0, 0.1, (2, h, hd)).astype(np.float32),
          "m": rng.normal(size=(2, h)).astype(np.float32)}
    jp, jx, jst = _seq_grads(j_rec.mlstm_seq, p, x, st, dy)
    witness = None
    if s == 300:
        witness = _seq_grads(j_rec.mlstm_seq_ref, p, x, st, dy)
    tp = {k: torch.as_tensor(v).requires_grad_() for k, v in p.items()}
    tx = torch.as_tensor(x).requires_grad_()
    tst = {k: torch.as_tensor(v).requires_grad_() for k, v in st.items()}
    y, _ = t_rec.mlstm_seq(tp, tx, tst)
    (y * torch.as_tensor(dy)).sum().backward()
    pairs = [(f"p.{k}", tp[k].grad, jp[k], witness and witness[0][k])
             for k in p] + [("x", tx.grad, jx, witness and witness[1])] + \
        [(f"state.{k}", tst[k].grad, jst[k], witness and witness[2][k])
         for k in st]
    for name, g, w, wit in pairs:
        g = g.numpy()
        atol = LEAF * (1 + np.abs(w).max())
        if wit is not None:
            atol = max(atol, 2 * float(np.abs(wit - w).max()))
        np.testing.assert_allclose(g, w, atol=atol, rtol=1e-4,
                                   err_msg=f"S {s} d{name}")


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mlstm_seq_under_grad_returns_the_serving_values(dt):
    d, h, hd, s = 64, 4, 16, 40
    p = {k: torch.as_tensor(v).to(dt) for k, v in
         _params(2, d, h, hd).items()}
    x = torch.as_tensor(np.random.default_rng(4).normal(
        size=(2, s, d)).astype(np.float32)).to(dt)
    st = t_rec.mlstm_state(2, h, hd, "cpu")
    with torch.no_grad():
        y0, s0 = t_rec.mlstm_seq(p, x, st)
    y1, s1 = t_rec.mlstm_seq(p, x.clone().requires_grad_(), st)
    assert y1.requires_grad and torch.equal(y0, y1.detach())
    for k in ("C", "n", "m"):
        assert torch.equal(s0[k], s1[k].detach())


def _held_chunks(args, l):
    """Per chunk of ``l``, whether its starting m0 holds the max over its
    a_s (the residual of mx_L's gradient then goes to dm0)."""
    return m0_holds_max(*map(torch.as_tensor, args), 1.0, chunk=l)


def _free_seeds(seed, b, h, d, which):
    """dC1, dn1 ~ N(0, 1) where ``which`` names them, dm1 ~ N(0, 1) drawn
    on its own (not the represented value's)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    dC1 = rng.normal(size=(b, h, d, d)).astype(f32) if "C" in which else None
    dn1 = rng.normal(size=(b, h, d)).astype(f32) if "n" in which else None
    dm1 = rng.normal(size=(b, h)).astype(f32) if "m" in which else None
    return dC1, dn1, dm1


def _j_free_grads(args, dh, seeds, l, scale):
    """``jax.grad`` of sum(h dh) + sum(C1 dC1) + sum(n1 dn1) + sum(m1 dm1)
    (each term where its seed is given) through the reference chained
    over chunks of ``l``."""
    args = tuple(map(jnp.asarray, args))

    def loss(*a):
        out = _j_chain(a, l, scale)
        total = jnp.sum(out[0] * dh)
        for x, g in zip(out[1:], seeds):
            if g is not None:
                total = total + jnp.sum(x * g)
        return total
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(8))))(*args)
    return [np.asarray(g) for g in grads]


#: (S, D, initial state, m0 offset, input-gate offset, which seeds): m0
#: raised 6 above gates lowered 3 holds the max in every chunk of the
#: case (the residual reaches dm0); a zero state never does (m0 -1e30)
FREE_CASES = [(1, 16, "random", 6.0, -3.0, "Cnm"),
              (7, 16, "random", 6.0, -3.0, "Cnm"),
              (7, 16, "random", 0.0, 0.0, "m"),
              (64, 32, "zero", 0.0, 0.0, "Cnm"),
              (100, 16, "random", 0.0, 0.0, "C"),
              (300, 16, "random", 0.0, 0.0, "nm"),
              (512, 16, "random", 0.0, 0.0, "Cnm")]


@pytest.mark.parametrize("s,d,state,mbias,ibias,which", FREE_CASES)
def test_function_gradients_with_free_final_state_seeds(s, d, state, mbias,
                                                        ibias, which):
    """``ops.mlstm`` under grad (the plain forward and backward at the
    model's chunks on the CPU) with the final state's seeds drawn freely,
    against ``jax.grad`` of the chained reference at the same chunks."""
    b, h = 2, 2
    args, dh, _, _ = _operands(5 * s + d, b, s, h, d, state, ibias)
    args = args[:7] + (args[7] + np.float32(mbias),)
    seeds = _free_seeds(s, b, h, d, which)
    scale = 1.0 / math.sqrt(d)
    l = model_chunk(s)
    if mbias:
        assert bool(_held_chunks(args, l).all())
    want = _j_free_grads(args, dh, seeds, l, scale)
    leaves = [torch.as_tensor(a).requires_grad_() for a in args]
    out = ops.mlstm(*leaves, scale)
    loss = (out[0] * torch.as_tensor(dh)).sum()
    for x, g in zip(out[1:], seeds):
        if g is not None:
            loss = loss + (x * torch.as_tensor(g)).sum()
    loss.backward()
    _held([t.grad for t in leaves], want, what=f"S {s} seeds {which}")


@pytest.mark.parametrize("s,mbias,held", [(16, 6.0, "all"), (37, 2.0, "some"),
                                          (37, 0.0, "some")])
def test_residual_crosses_short_chunks_while_m0_holds(s, mbias, held):
    """Chunks of 4 with free seeds: while m0 holds each chunk's max the
    residual dm1 - <dC1, C1> - <dn1, n1> passes back chunk by chunk to
    dm0; where a chunk's a_s holds it, it stops at that chunk's da.  The
    plain backward at chunk 4 against ``jax.grad`` of the reference
    chained at 4, and at one chunk of S against the same."""
    b, h, d = 2, 2, 16
    args, dh, _, _ = _operands(3 * s, b, s, h, d, "random", -3.0)
    args = args[:7] + (args[7] + np.float32(mbias),)
    kept = _held_chunks(args, 4)
    assert bool(kept.all()) if held == "all" else \
        bool(kept.any() and not kept.all())
    seeds = _free_seeds(s + 1, b, h, d, "Cnm")
    scale = 1.0 / math.sqrt(d)
    t = [torch.as_tensor(a) for a in args]
    tseeds = [torch.as_tensor(g) for g in seeds]
    for l in (4, s):
        want = _j_free_grads(args, dh, seeds, l, scale)
        got = mlstm_chunk_bwd_ref(*t, scale, torch.as_tensor(dh), *tseeds,
                                  chunk=l)
        _held(got, want, what=f"chunk {l}, S {s}")


@pytest.mark.parametrize("s,chunk,state", [(37, 8, "random"),
                                           (130, 64, "zero")])
def test_plain_backward_with_free_seeds_matches_autograd(s, chunk, state):
    """The plain backward against ``torch.autograd`` of the plain forward
    (which differentiates through cummax and max) with free seeds."""
    b, h, d = 2, 2, 16
    args, dh, _, _ = _operands(9 * s, b, s, h, d, state)
    t = [torch.as_tensor(a) for a in args]
    seeds = [torch.as_tensor(g) for g in _free_seeds(s, b, h, d, "Cnm")]
    scale = 1.0 / math.sqrt(d)
    leaves = [a.clone().requires_grad_() for a in t]
    out = mlstm_chunk_ref(*leaves, scale, chunk=chunk)
    loss = (out[0] * torch.as_tensor(dh)).sum()
    for x, g in zip(out[1:], seeds):
        loss = loss + (x * g).sum()
    loss.backward()
    got = mlstm_chunk_bwd_ref(*t, scale, torch.as_tensor(dh), *seeds,
                              chunk=chunk)
    _held(got, [a.grad for a in leaves], share=1e-5, what=f"chunk {chunk}")


def test_plain_backward_with_free_seeds_is_the_same_at_any_chunks():
    b, s, h, d = 2, 300, 2, 16
    args, dh, _, _ = _operands(13, b, s, h, d, "random", -3.0)
    args = args[:7] + (args[7] + np.float32(4.0),)
    t = [torch.as_tensor(a) for a in args]
    seeds = [torch.as_tensor(g) for g in _free_seeds(2, b, h, d, "Cnm")]
    scale = 1.0 / math.sqrt(d)
    sides = [mlstm_chunk_bwd_ref(*t, scale, torch.as_tensor(dh), *seeds,
                                 chunk=c) for c in (32, 64, 256)]
    for other in sides[1:]:
        _held(other, sides[0], what="chunks")
