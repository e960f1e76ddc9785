"""The port's attention kernels' plain versions and layout wrappers
against the reference, on the CPU.

* ``flash_attention``'s plain version (``attention_ref``) against the
  reference's Pallas ``flash_attention`` in interpret mode (64-row
  blocks, so several q and kv blocks) and its ``attention_ref``, over the
  reference's kernel-test grid plus ragged S (1, 77, 100; the last two
  against ``attention_ref`` only, see the test);
* ``decode_attention``'s plain version (``decode_ref``) likewise, with
  pos holding 0 and S - 1 (a ragged cache of 200 slots against
  ``decode_ref`` only);
* ``ops.mha`` / ``ops.decode_mha`` (the model layouts) against the
  reference's ``ops.py`` with ``use_kernel=False``;
* a key length of its own (Sk != Sq, no mask): the port's model-level
  ``attention(kv=..., causal=False)`` (projections, then the plain
  flash) against the reference's ``models/attention.py::attention`` on
  the same external K/V, and ``cross_decode_attention`` (the decode
  path's one query over every slot) against the same; the non-causal
  Sk = Sq grid case at whisper's 6 heads against the Pallas kernel in
  interpret mode; the wrapper, the plain version and ``mha`` raising on a
  causal mask or a window with Sk != Sq.

Tolerances are the reference's kernel-test ``TOL``: float32 atol 2e-5,
rtol 2e-4; bfloat16 atol 2e-2, rtol 2e-1 (one bf16 ulp of rounding).
Inputs are drawn with numpy and cast to the dtype in both frameworks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import ops as j_dops  # noqa: E402
from repro.kernels.decode_attention.decode_attention import \
    decode_attention as j_decode  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_ref as j_decode_ref  # noqa: E402
from repro.kernels.flash_attention import ops as j_fops  # noqa: E402
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as j_attention_ref  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.decode_attention import ops as t_dops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_fops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_ref  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": dict(atol=2e-5, rtol=2e-4), "bf16": dict(atol=2e-2, rtol=2e-1)}


def both(x, dt):
    """numpy float32 -> (torch, jax) tensors of the dtype ``dt``."""
    t_dt, j_dt = DTYPES[dt]
    return torch.as_tensor(x).to(t_dt), jnp.asarray(x).astype(j_dt)


def close(got_t, want_j, dt):
    np.testing.assert_allclose(got_t.to(torch.float32).numpy(),
                               np.asarray(want_j, np.float32), **TOL[dt])


FLASH_GRID = [(1, 2, 2, 128, 32, True, 0, 0.0),
              (2, 4, 2, 256, 64, True, 0, 50.0),
              (1, 2, 1, 256, 32, True, 64, 0.0),
              (1, 2, 2, 128, 64, False, 0, 0.0),
              (1, 8, 4, 384, 128, True, 128, 30.0),
              # ragged S: one token, and S not a multiple of the block
              (1, 4, 2, 1, 32, True, 0, 50.0),
              (2, 4, 2, 77, 32, True, 16, 50.0),
              (1, 2, 1, 100, 64, False, 48, 0.0),
              # non-causal at whisper's heads, several q and kv blocks
              (2, 6, 6, 192, 64, False, 0, 0.0)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,kv,s,d,causal,window,cap", FLASH_GRID)
def test_flash_plain_matches_reference_kernel_and_ref(b, h, kv, s, d, causal,
                                                      window, cap, dt):
    rng = np.random.default_rng(s * 7 + d)
    (tq, jq), (tk, jk), (tv, jv) = (both(rng.normal(size=(b, n, s, d))
                                         .astype(np.float32), dt)
                                    for n in (h, kv, kv))
    kw = dict(causal=causal, window=window, cap=cap)
    got = attention_ref(tq, tk, tv, **kw)
    assert got.dtype == DTYPES[dt][0] and got.shape == (b, h, s, d)
    close(got, j_attention_ref(jq, jk, jv, **kw), dt)
    if s > 64 and s % 64:
        # the reference kernel's last block then reaches past S; in
        # interpret mode those value rows read as NaN, which its mask
        # (on the logits only) does not remove: held against the ref only
        return
    close(got, j_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True,
                       **kw), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,kv,g,s,d,cap", [(2, 2, 4, 512, 64, 0.0),
                                            (1, 4, 1, 1024, 32, 50.0),
                                            (3, 1, 8, 256, 128, 0.0),
                                            (3, 2, 2, 200, 32, 50.0)])
def test_decode_plain_matches_reference_kernel_and_ref(b, kv, g, s, d, cap,
                                                       dt):
    rng = np.random.default_rng(s + g)
    (tq, jq) = both(rng.normal(size=(b, kv, g, d)).astype(np.float32), dt)
    (tk, jk), (tv, jv) = (both(rng.normal(size=(b, kv, s, d))
                               .astype(np.float32), dt) for _ in range(2))
    pos = rng.integers(1, s, size=b).astype(np.int32)
    pos[0] = 0
    pos[-1] = s - 1
    tp, jp = torch.as_tensor(pos), jnp.asarray(pos)
    got = decode_ref(tq, tk, tv, tp, cap=cap)
    assert got.dtype == DTYPES[dt][0] and got.shape == (b, kv, g, d)
    close(got, j_decode_ref(jq, jk, jv, jp, cap=cap), dt)
    if s % 128:
        return          # ragged last block: NaN rows, as for flash above
    close(got, j_decode(jq, jk, jv, jp, cap=cap, block_k=128,
                        interpret=True), dt)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (8, 50.0)])
def test_mha_layout_matches_reference_ops(window, cap):
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 20, n, 32)).astype(np.float32)
               for n in (4, 2, 2))
    got = t_fops.mha(*(torch.as_tensor(x) for x in (q, k, v)),
                     window=window, cap=cap)
    want = j_fops.mha(*(jnp.asarray(x) for x in (q, k, v)), window=window,
                      cap=cap, use_kernel=False)
    assert got.shape == (2, 20, 4, 32)
    close(got, want, "f32")


@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_decode_mha_layout_matches_reference_ops(cap):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(3, 1, 6, 32)).astype(np.float32)
    kc, vc = (rng.normal(size=(3, 40, 2, 32)).astype(np.float32)
              for _ in range(2))
    pos = np.array([0, 17, 39], np.int32)
    got = t_dops.decode_mha(*(torch.as_tensor(x) for x in (q, kc, vc, pos)),
                            cap=cap)
    want = j_dops.decode_mha(*(jnp.asarray(x) for x in (q, kc, vc, pos)),
                             cap=cap, use_kernel=False)
    assert got.shape == (3, 1, 6, 32)
    close(got, want, "f32")


def test_cpu_attention_leaves_the_kernel_counters_alone():
    kernels.reset_launch_counts()
    x = torch.zeros((1, 4, 2, 32))
    t_fops.mha(x, x, x)
    t_dops.decode_mha(x[:, :1], x, x, torch.zeros(1, dtype=torch.int32))
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == counts["decode_attention"] == 0


def _cross_params(rng, d, h, kv, hd):
    """A cross-attention layer's projections (with biases) as numpy."""
    return {"wq": rng.normal(0, d ** -0.5, size=(d, h, hd)),
            "wk": rng.normal(0, d ** -0.5, size=(d, kv, hd)),
            "wv": rng.normal(0, d ** -0.5, size=(d, kv, hd)),
            "wo": rng.normal(0, (h * hd) ** -0.5, size=(h, hd, d)),
            "bq": rng.normal(0, 0.3, size=(h, hd)),
            "bk": rng.normal(0, 0.3, size=(kv, hd)),
            "bv": rng.normal(0, 0.3, size=(kv, hd))}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("sq,sk", [(1, 1), (1, 37), (12, 16), (63, 1),
                                   (65, 100)])
def test_cross_attention_matches_reference_model_path(sq, sk, dt):
    """Queries from x [B, Sq, d] over external K/V [B, Sk, KV, Dh] (no
    mask, no rotation: whisper's cross-attention), through the plain
    flash, against the reference's ``attention(kv=..., causal=False)``."""
    b, d, h, kv, hd = 2, 32, 4, 2, 16
    rng = np.random.default_rng(sq * 101 + sk)
    p = {k: v.astype(np.float32) for k, v in
         _cross_params(rng, d, h, kv, hd).items()}
    x = rng.normal(size=(b, sq, d)).astype(np.float32)
    xk, xv = (rng.normal(size=(b, sk, kv, hd)).astype(np.float32)
              for _ in range(2))
    pos = np.tile(np.arange(sq, dtype=np.int32), (b, 1))
    kv_pos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    (tx, jx), (tk, jk), (tv, jv) = (both(a, dt) for a in (x, xk, xv))
    got, gk, gv = t_attn.attention(tp, tx, torch.as_tensor(pos),
                                   causal=False, theta=0.0, kv=(tk, tv))
    want = j_attn.attention({k: jnp.asarray(v) for k, v in p.items()}, jx,
                            jnp.asarray(pos), n_heads=h, causal=False,
                            theta=0.0, kv=(jk, jv),
                            kv_pos=jnp.asarray(kv_pos))
    assert got.shape == (b, sq, d) and gk is tk and gv is tv
    close(got, want, dt)
    if sq == 1:
        # one decode step over the same kept K/V: every slot valid
        close(t_attn.cross_decode_attention(tp, tx, (tk, tv)), want, dt)


def test_key_length_of_its_own_needs_no_mask():
    """Sk != Sq is taken without a mask and refused with a causal mask or
    a window, by the plain version, ``mha`` and the CUDA wrapper (which
    checks before it looks for a card); Sk = 0 is refused too."""
    q = torch.zeros((1, 2, 5, 16))
    k = torch.zeros((1, 1, 7, 16))
    assert attention_ref(q, k, k, causal=False).shape == (1, 2, 5, 16)
    for kw in (dict(causal=True), dict(causal=False, window=4)):
        with pytest.raises(ValueError, match="7 keys for 5 queries"):
            attention_ref(q, k, k, **kw)
        with pytest.raises(ValueError, match="7 keys for 5 queries"):
            flash_attention(q, k, k, **kw)
        with pytest.raises(ValueError, match="7 keys for 5 queries"):
            t_fops.mha(q.transpose(1, 2), k.transpose(1, 2),
                       k.transpose(1, 2), **kw)
    with pytest.raises(ValueError, match="0 keys for 5 queries"):
        attention_ref(q, k[:, :, :0], k[:, :, :0], causal=False)
