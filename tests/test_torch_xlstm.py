"""The port's xLSTM cells against the reference, on the CPU.

* the chunkwise mLSTM kernel's plain version (``mlstm_chunk_ref``, the
  reference's ``mlstm_chunk_math`` chunk by chunk from a given state)
  against the reference's Pallas ``mlstm_chunk`` in interpret mode (zero
  state, q pre-scaled on its side) and its ``mlstm_ref`` (the sequential
  recurrence), at the reference's kernel-test grid, within its atol
  5e-4, rtol 1e-3; ragged S (37, 100: the Pallas kernel asks
  S % chunk == 0) against ``mlstm_ref`` only;
* one call equal to two calls with the state carried across, within
  1e-5, and the plain version at another chunk length within 1e-4;
* ``mlstm_seq`` (y and the state C, n, m) against the reference's at S
  in {1, 37, 64, 300} from a nonzero state, within atol 1e-4 (the
  reference's own chunkwise-vs-sequential bound,
  ``tests/test_models.py``) and rtol 1e-4: at S = 300, |y| reaches 15
  and the float32 gap 3.0e-4, while the reference's own chunkwise form
  lies 1.9e-4 from its sequential oracle there (ROADMAP section 3);
* ``slstm_seq``: a 12-token prefill, then 8 single-token steps carrying
  the state, against the reference: float32 within 1e-5; bfloat16 within
  4 bf16 ulps of the largest value (a flipped rounding of ``h`` feeds
  the recurrence; ROADMAP section 3);
* ``ops.mlstm`` on CPU tensors takes the plain version and counts no
  launch.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mlstm_chunk.mlstm_chunk import \
    mlstm_chunk as j_mlstm_chunk  # noqa: E402
from repro.kernels.mlstm_chunk.ref import mlstm_ref as j_mlstm_ref  # noqa
from repro.models import recurrent as j_rec  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ops import mlstm  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ref import (log_sigmoid,  # noqa: E402
                                                 mlstm_chunk_ref,
                                                 model_chunk)
from repro_torch.models import recurrent as t_rec  # noqa: E402

KERNEL_TOL = dict(atol=5e-4, rtol=1e-3)      # tests/test_kernels.py


def _cell_inputs(seed, b, h, s, d):
    """The reference kernel test's distributions, [B, S, H, D] numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 0.5, (b, s, h, d)).astype(np.float32)
               for _ in range(3))
    ip = rng.normal(size=(b, s, h)).astype(np.float32)
    fp = (rng.normal(size=(b, s, h)) + 3.0).astype(np.float32)
    return q, k, v, ip, fp


def _zero_state(b, h, d):
    return (torch.zeros((b, h, d, d)), torch.zeros((b, h, d)),
            torch.full((b, h), -1e30))


def _random_state(rng, b, h, d):
    return (rng.normal(0, 0.1, (b, h, d, d)).astype(np.float32),
            rng.normal(0, 0.1, (b, h, d)).astype(np.float32),
            rng.normal(size=(b, h)).astype(np.float32))


def _bhsd(x):
    """[B, S, H, ...] numpy -> the reference kernel's [B, H, S, ...]."""
    return jnp.asarray(np.moveaxis(x, 2, 1))


def _plain(q, k, v, ip, fp, state, **kw):
    d = q.shape[-1]
    return mlstm_chunk_ref(*(torch.as_tensor(a) for a in (q, k, v, ip, fp)),
                           *state, 1.0 / math.sqrt(d), **kw)


@pytest.mark.parametrize("b,h,s,d,chunk", [(2, 3, 128, 32, 16),
                                           (1, 2, 64, 64, 64),
                                           (2, 1, 256, 32, 128)])
def test_mlstm_chunk_plain_matches_pallas_and_ref(b, h, s, d, chunk):
    q, k, v, ip, fp = _cell_inputs(b * s + d, b, h, s, d)
    got, C, n, m = _plain(q, k, v, ip, fp, _zero_state(b, h, d))
    assert got.shape == (b, s, h, d) and C.shape == (b, h, d, d)
    assert got.dtype == C.dtype == torch.float32
    qs = _bhsd(q) * (1.0 / math.sqrt(d))
    args = (qs, _bhsd(k), _bhsd(v), _bhsd(ip), _bhsd(fp))
    pallas = np.asarray(j_mlstm_chunk(*args, chunk=chunk, interpret=True))
    ref = np.asarray(j_mlstm_ref(*args))
    got = np.moveaxis(got.numpy(), 2, 1)
    np.testing.assert_allclose(got, pallas, **KERNEL_TOL)
    np.testing.assert_allclose(got, ref, **KERNEL_TOL)


@pytest.mark.parametrize("s", [37, 100])
def test_mlstm_chunk_plain_ragged_s_matches_ref(s):
    b, h, d = 2, 2, 32
    q, k, v, ip, fp = _cell_inputs(s, b, h, s, d)
    got = _plain(q, k, v, ip, fp, _zero_state(b, h, d))[0]
    qs = _bhsd(q) * (1.0 / math.sqrt(d))
    ref = np.asarray(j_mlstm_ref(qs, _bhsd(k), _bhsd(v), _bhsd(ip),
                                 _bhsd(fp)))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 2, 1), ref,
                               **KERNEL_TOL)
    assert model_chunk(s) == s            # one odd-sized chunk


def test_one_call_equals_two_calls_carrying_the_state():
    """S = 96 in one call (one chunk of 96) against 37 then 59 steps, the
    first call's final state fed to the second; and the plain version
    at chunks of 16 (the last ragged) within 1e-4."""
    b, h, s, d = 2, 3, 96, 16
    q, k, v, ip, fp = _cell_inputs(5, b, h, s, d)
    state = tuple(torch.as_tensor(a) for a in
                  _random_state(np.random.default_rng(6), b, h, d))
    one = _plain(q, k, v, ip, fp, state)
    cut = 37
    first = _plain(*(a[:, :cut] for a in (q, k, v, ip, fp)), state)
    second = _plain(*(a[:, cut:] for a in (q, k, v, ip, fp)), first[1:])
    torch.testing.assert_close(torch.cat([first[0], second[0]], dim=1),
                               one[0], atol=1e-5, rtol=1e-5)
    for a, b_ in zip(second[1:], one[1:]):
        torch.testing.assert_close(a, b_, atol=1e-5, rtol=1e-5)
    other = _plain(q, k, v, ip, fp, state, chunk=16)
    for a, b_ in zip(other, one):
        torch.testing.assert_close(a, b_, atol=1e-4, rtol=1e-4)


def test_log_sigmoid_matches_the_reference_form():
    z = np.concatenate([np.linspace(-40, 40, 161),
                        [-1e-3, 0.0, 1e-3, 88.0]]).astype(np.float32)
    want = -jax.nn.softplus(-jnp.asarray(z))
    np.testing.assert_allclose(log_sigmoid(torch.as_tensor(z)).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-7)


def test_mlstm_on_cpu_takes_the_plain_version_without_counting():
    b, h, s, d = 1, 2, 5, 16
    q, k, v, ip, fp = (torch.as_tensor(a)
                       for a in _cell_inputs(7, b, h, s, d))
    state = _zero_state(b, h, d)
    kernels.reset_launch_counts()
    got = mlstm(q, k, v, ip, fp, *state, 0.25)
    want = mlstm_chunk_ref(q, k, v, ip, fp, *state, 0.25)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert kernels.launch_counts()["mlstm_chunk"] == 0


# ---------------------------------------------------------------------------
# the cells inside the model's layout
# ---------------------------------------------------------------------------


def _params(init, seed, d, h, hd, dtype=torch.float32, perturb=()):
    p = {k: np.array(v) for k, v in
         init(jax.random.PRNGKey(seed), d, h, hd).items()}
    rng = np.random.default_rng(seed)
    for name in perturb:
        p[name] = rng.normal(0, 0.3, p[name].shape).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.as_tensor(v).to(dtype) for k, v in p.items()})


@pytest.mark.parametrize("s", [1, 37, 64, 300])
def test_mlstm_seq_matches_reference(s):
    """From a nonzero state; S = 1 is a decode step, 300 one odd-sized
    chunk in the reference's rule, 64 one even chunk."""
    d, h, hd = 64, 4, 16
    jp, tp = _params(j_rec.mlstm_init, 1, d, h, hd)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, d)).astype(np.float32)
    C0, n0, m0 = _random_state(rng, 2, h, hd)
    jy, jst = j_rec.mlstm_seq(jp, jnp.asarray(x),
                              {"C": jnp.asarray(C0), "n": jnp.asarray(n0),
                               "m": jnp.asarray(m0)})
    ty, tst = t_rec.mlstm_seq(tp, torch.as_tensor(x),
                              {"C": torch.as_tensor(C0),
                               "n": torch.as_tensor(n0),
                               "m": torch.as_tensor(m0)})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    for k in ("C", "n", "m"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   atol=1e-4, rtol=1e-4)


def test_mlstm_state_is_the_reference_zero_state():
    want = j_rec.mlstm_state(2, 3, 16)
    got = t_rec.mlstm_state(2, 3, 16, "cpu")
    for k in ("C", "n", "m"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _bf16_ulp(x):
    """One bfloat16 ulp (8 significant bits) at |x|."""
    x = max(float(np.abs(x).max()), 2.0 ** -126)
    return 2.0 ** (math.floor(math.log2(x)) - 7)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_slstm_prefill_and_decode_match_reference(dt):
    """A 12-token prefill from the zero state, then 8 single-token steps,
    each step's state fed to the next on both sides: y and every state
    leaf (c, n, m float32, h in the compute dtype)."""
    t_dt, j_dt = {"f32": (torch.float32, jnp.float32),
                  "bf16": (torch.bfloat16, jnp.bfloat16)}[dt]
    d, h, hd = 64, 4, 16
    jp, tp = _params(j_rec.slstm_init, 2, d, h, hd, t_dt, perturb=("b",))
    jst = j_rec.slstm_state(2, h, hd, j_dt)
    tst = t_rec.slstm_state(2, h, hd, t_dt, "cpu")
    rng = np.random.default_rng(3)
    for i in range(9):
        x = rng.normal(size=(2, 12 if i == 0 else 1, d)).astype(np.float32)
        jy, jst = j_rec.slstm_seq(jp, jnp.asarray(x).astype(j_dt), jst)
        ty, tst = t_rec.slstm_seq(tp, torch.as_tensor(x).to(t_dt), tst)
        assert ty.dtype == tst["h"].dtype == t_dt
        assert tst["c"].dtype == tst["n"].dtype == tst["m"].dtype == \
            torch.float32
        pairs = [(ty, jy)] + [(tst[k], jst[k]) for k in ("c", "n", "h", "m")]
        for got, want in pairs:
            want = np.asarray(want.astype(jnp.float32))
            atol = 1e-5 if dt == "f32" else 4 * _bf16_ulp(want)
            np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                                       rtol=1e-5 if dt == "f32" else 0)
