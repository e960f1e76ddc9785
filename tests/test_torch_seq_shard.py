"""The reference's two sequence-sharded layouts, on the CPU: flash
attention at a query-row offset, decode attention with its log-sum-exp,
and the LMs under ``attn_seq_shard`` and ``seq_shard_kv`` run position by
position on meshes of CPU entries.

* The plain flash versions at query offsets 0, c and 3c (rows ``[off, off
  + c)`` of a sequence of 4c, against the keys ``[0, off + c)``) against
  those rows of the reference's attention over the whole sequence
  (``repro.models.attention._sdpa``, masks by position), causal with and
  without a window and a softcap; the backward (``attention_bwd_ref``
  and ``mha`` under grad) against ``jax.vjp`` of the whole with the rows'
  cotangent; offset 0 bitwise the call without one.
* ``decode_mha(return_lse=True)`` on a cache cut into 4 blocks (each
  block's bound ``min(pos, size - 1) - j L``, blocks wholly past ``pos``
  among them, and a rolling cache the position has wrapped), the blocks
  merged by their log-sum-exps in float32, against the reference's
  ``decode_ref`` over the whole cache within 1e-6; a row with no valid
  slot gives 0 and ``-inf``, never NaN.
* Reduced LMs under meshes of CPU entries, against the port unsharded
  (1e-5, float32) and the reference jitted under the same mesh and rules
  (one 8-device subprocess for the module: logits 1e-4, loss 1e-5
  relative, gradients 1e-4 of the leaf's largest): minicpm-2b with 6
  heads on (1, 4) and (2, 4) (train and prefill under ``attn_seq_shard``,
  the prefill also under ``seq_shard_kv``, decode under ``seq_shard_kv``),
  qwen2-vl-2b under ``attn_seq_shard`` with its 8 patch embeddings in
  front (a position holds patch rows only), gemma2-9b and
  recurrentgemma-9b under ``seq_shard_kv`` with a cache longer than
  their window (rolling buffers split over ``model``); one
  ``make_train_step`` step and ``ContinuousBatcher`` (ragged prompts,
  a prefill whose rows ``model`` does not divide) against the same
  unsharded.

Inputs are numpy-seeded; the reference's parameters reach the port
through ``convert.lm_params_from_arrays``.
"""
import dataclasses
import functools
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ref import \
    decode_ref as j_decode_ref  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro_torch.configs.base import ServeConfig, TrainConfig  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import (lm_params_from_arrays,  # noqa: E402
                                 train_state_from_arrays)
from repro_torch.kernels.decode_attention.ops import decode_mha  # noqa
from repro_torch.kernels.flash_attention.ops import mha  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_fwd_ref, attention_ref, check_key_length)
from repro_torch.kernels.work import kept_pairs  # noqa: E402
from repro_torch.models.transformer import (ShardedCache,  # noqa: E402
                                            TransformerLM)
from repro_torch.parallel.sharding import make_mesh, use_mesh_rules  # noqa
from repro_torch.runtime.serve_loop import (ContinuousBatcher,  # noqa
                                            Request)
from repro_torch.runtime.train_loop import make_train_step  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

CPU = torch.device("cpu")
PORT_TOL = dict(atol=1e-5, rtol=1e-5)
REF_LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
REF_LOSS_RTOL = 1e-5
REF_GRAD_SHARE = 1e-4
ATTN_TOL = dict(atol=2e-6, rtol=1e-5)
B, STEPS = 4, 2
ROWS = dict(attn_seq_shard=True)
KV = dict(seq_shard_kv=True)
ROWS_KV = dict(attn_seq_shard=True, seq_shard_kv=True)
#: name -> (arch, heads (None: the reduced config's), mesh, prompt rows,
#: cache, rules of the training loss (None: not trained), of the prefill,
#: of the decode steps)
CASES = {
    "minicpm6-d1m4": ("minicpm-2b", 6, (1, 4), 12, 24, ROWS, ROWS_KV, KV),
    "minicpm6-d2m4": ("minicpm-2b", 6, (2, 4), 12, 24, ROWS, ROWS_KV, KV),
    "qwen2vl-d2m4": ("qwen2-vl-2b", None, (2, 4), 12, 24, ROWS, ROWS_KV, KV),
    "gemma2-d1m4": ("gemma2-9b", None, (1, 4), 40, 48, None, KV, KV),
    "recurrentgemma-d2m4": ("recurrentgemma-9b", None, (2, 4), 40, 48, None,
                            KV, KV),
}
TRAINED = [c for c, v in CASES.items() if v[5] is not None]

SCRIPT = textwrap.dedent('''
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.parallel.sharding import use_mesh_rules
    from repro.configs.registry import get_arch
    from repro.models.transformer import TransformerLM
    from repro.runtime import train_loop as j_train

    CASES, B, STEPS = {cases}, {b}, {steps}
    ZERO = ("scale", "bias", "bq", "bk", "bv", "b_a", "b_i")
    mesh_of = lambda shape: jax.make_mesh(
        shape, ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {{}}
    for c, (name, (arch, heads, shape, s, cache, train, pre, dec)) in \\
            enumerate(sorted(CASES.items())):
        cfg = get_arch(arch).reduced()
        if heads:
            cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
                cfg.attention, n_heads=heads, n_kv_heads=heads))
        model = TransformerLM(cfg)
        rng = np.random.default_rng(c)

        def draw(tree):
            if isinstance(tree, dict):
                return {{k: (rng.normal(0, 0.3, size=v.shape).astype(
                    np.float32) if k in ZERO else draw(v))
                    for k, v in tree.items()}}
            if isinstance(tree, list):
                return [draw(v) for v in tree]
            return np.asarray(tree)
        params = draw(jax.tree.map(np.asarray,
                                   jax.jit(model.init)(jax.random.PRNGKey(c))))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{{name}}/p" + jax.tree_util.keystr(path)] = leaf
        toks = rng.integers(0, cfg.vocab_size, size=(B, s + 1)).astype(
            np.int32)
        dec_toks = rng.integers(0, cfg.vocab_size, size=(STEPS, B)).astype(
            np.int32)
        out[f"{{name}}/toks"], out[f"{{name}}/dec"] = toks, dec_toks
        kw = {{}}
        if cfg.vision_tokens:
            patches = rng.normal(size=(B, cfg.vision_tokens, cfg.d_model)) \\
                .astype(np.float32)
            out[f"{{name}}/patches"] = patches
            kw["extra_embeds"] = jnp.asarray(patches)
        jp = jax.tree.map(jnp.asarray, params)
        mesh = mesh_of(shape)
        with use_mesh_rules(mesh, **pre):
            logits, kv = jax.jit(
                lambda p, t, e=None: model.prefill(p, t, cache,
                                                   extra_embeds=e))(
                jp, jnp.asarray(toks[:, :s]), kw.get("extra_embeds"))
        out[f"{{name}}/logits0"] = np.asarray(logits)
        start = s + cfg.vision_tokens
        with use_mesh_rules(mesh, **dec):
            step = jax.jit(model.decode_step)
            for i in range(STEPS):
                logits, kv = step(jp, jnp.asarray(dec_toks[i][:, None]),
                                  jnp.full((B, 1), start + i, jnp.int32), kv)
                out[f"{{name}}/logits{{i + 1}}"] = np.asarray(logits)
        if train is not None:
            batch = {{"tokens": jnp.asarray(toks[:, :-1]),
                     "labels": jnp.asarray(toks[:, 1:])}}
            if cfg.vision_tokens:
                batch["patch_embeds"] = kw["extra_embeds"]
            with use_mesh_rules(mesh, **train):
                loss, g = jax.jit(jax.value_and_grad(
                    lambda p, b: j_train._loss_fn(model, cfg, p, b)))(
                    jp, batch)
            out[f"{{name}}/loss"] = np.asarray(loss)
            for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
                out[f"{{name}}/g" + jax.tree_util.keystr(path)] = \\
                    np.asarray(leaf)
    np.savez(sys.argv[1], **out)
    print("SEQ_SHARD_OK")
''').format(cases=repr(CASES), b=B, steps=STEPS)


# ---------------------------------------------------------------------------
# the kernels' plain versions at a query offset and with the lse
# ---------------------------------------------------------------------------


def _qkv(seed, b, h, kv, s, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, n, d)).astype(np.float32)
            for n in (h, kv, kv)]


def _whole_ref(q, k, v, window, cap):
    """The reference's masked attention over the whole sequence (its
    ``_sdpa``, positions by index), [B, S, H, D]."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    pos = jnp.broadcast_to(jnp.arange(s), (b, s))
    return j_attn._sdpa(q.reshape(b, s, kv, h // kv, d), k, v, pos, pos,
                        True, window, cap, 1.0 / math.sqrt(d))


@pytest.mark.parametrize("block", [0, 1, 3])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 0.0), (0, 3.0),
                                        (7, 2.0)])
def test_flash_plain_at_an_offset_is_rows_of_the_whole(block, window, cap):
    b, h, kv, c, d = 2, 4, 2, 6, 16
    q, k, v = _qkv(block + window, b, h, kv, 4 * c, d)
    off, end = block * c, (block + 1) * c
    want = np.asarray(_whole_ref(*map(jnp.asarray, (q, k, v)), window,
                                 cap))[:, off:end]
    qt, kt, vt = (torch.as_tensor(t) for t in (q, k, v))
    got = mha(qt[:, off:end], kt[:, :end], vt[:, :end], window=window,
              cap=cap, q_offset=off)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    heads = [t.transpose(1, 2) for t in (qt[:, off:end], kt[:, :end],
                                         vt[:, :end])]
    np.testing.assert_allclose(
        attention_ref(*heads, window=window, cap=cap,
                      q_offset=off).transpose(1, 2).numpy(), want,
        **ATTN_TOL)


@pytest.mark.parametrize("block", [0, 1, 3])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 3.0)])
def test_flash_plain_backward_at_an_offset_is_the_whole_gradient(block,
                                                                 window,
                                                                 cap):
    """dq of the block's rows and dk, dv of every key, from the rows'
    output gradient alone: ``attention_bwd_ref`` at the offset (on the
    forward's o and lse there) and ``mha`` under grad, against
    ``jax.vjp`` of the reference's whole-sequence attention; keys past
    the block's last position get zeros."""
    b, h, kv, c, d = 2, 4, 2, 6, 16
    s = 4 * c
    q, k, v = _qkv(10 + block, b, h, kv, s, d)
    do = np.random.default_rng(block).normal(size=(b, c, h, d)).astype(
        np.float32)
    off, end = block * c, (block + 1) * c
    cot = np.zeros((b, s, h, d), np.float32)
    cot[:, off:end] = do
    _, vjp = jax.vjp(lambda a, bb, cc: _whole_ref(a, bb, cc, window, cap),
                     *map(jnp.asarray, (q, k, v)))
    wq, wk, wv = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    # every key at an offset (Sk = Sq at offset 0)
    keys = s if off else end
    qt = torch.as_tensor(q[:, off:end]).transpose(1, 2)
    kt, vt = (torch.as_tensor(t[:, :keys]).transpose(1, 2) for t in (k, v))
    kw = dict(window=window, cap=cap, q_offset=off)
    o, lse = attention_fwd_ref(qt, kt, vt, **kw)
    dq, dk, dv = attention_bwd_ref(qt, kt, vt, o, lse,
                                   torch.as_tensor(do).transpose(1, 2), **kw)
    np.testing.assert_allclose(dq.transpose(1, 2).numpy(), wq[:, off:end],
                               **ATTN_TOL)
    np.testing.assert_allclose(dk.transpose(1, 2).numpy(), wk[:, :keys],
                               **ATTN_TOL)
    np.testing.assert_allclose(dv.transpose(1, 2).numpy(), wv[:, :keys],
                               **ATTN_TOL)
    assert not dk[:, :, end:].any() and not dv[:, :, end:].any()
    leaves_ = [torch.as_tensor(t).requires_grad_(True)
               for t in (q[:, off:end], k[:, :end], v[:, :end])]
    mha(*leaves_, **kw).backward(torch.as_tensor(do))
    for g, w in zip((t.grad for t in leaves_), (wq[:, off:end],
                                                 wk[:, :end], wv[:, :end])):
        np.testing.assert_allclose(g.numpy(), w, **ATTN_TOL)


def test_offset_zero_is_bitwise_the_call_without_one():
    q, k, v = (torch.as_tensor(t) for t in _qkv(3, 2, 4, 2, 20, 16))
    kw = dict(window=6, cap=3.0)
    assert torch.equal(mha(q, k, v, **kw), mha(q, k, v, q_offset=0, **kw))
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    o, lse = attention_fwd_ref(*heads, **kw)
    o0, lse0 = attention_fwd_ref(*heads, q_offset=0, **kw)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    do = torch.ones_like(o)
    for a, b in zip(attention_bwd_ref(*heads, o, lse, do, **kw),
                    attention_bwd_ref(*heads, o, lse, do, q_offset=0, **kw)):
        assert torch.equal(a, b)


def test_an_offset_needs_a_mask_and_its_keys():
    check_key_length("f", 6, 24, True, 0, 18)
    with pytest.raises(ValueError, match="offset"):
        check_key_length("f", 6, 24, False, 0, 18)
    with pytest.raises(ValueError, match="keys"):
        check_key_length("f", 6, 20, True, 0, 18)
    with pytest.raises(ValueError, match="keys"):
        check_key_length("f", 6, 24, True, 0, 0)     # Sk = Sq at offset 0
    with pytest.raises(ValueError):
        mha(*(torch.zeros(1, n, 2, 16) for n in (6, 20, 20)), q_offset=18)


@pytest.mark.parametrize("sq,sk,causal,window,off", [
    (6, 24, True, 0, 18), (6, 24, True, 5, 18), (7, 30, True, 40, 3),
    (5, 12, False, 4, 6), (16, 16, True, 0, 0), (9, 9, False, 3, 0)])
def test_kept_pairs_at_an_offset(sq, sk, causal, window, off):
    brute = sum((not causal or off + i >= j) and
                (not window or off + i - j < window)
                for i in range(sq) for j in range(sk))
    assert kept_pairs(sq, sk, causal, window, off) == brute


def _merged(q, k, v, pos, n, cap, rolling):
    """``decode_mha(return_lse=True)`` on each of ``n`` slot blocks of the
    cache, merged by the log-sum-exps in float32."""
    size = k.shape[1]
    blk = size // n
    bound = torch.clamp(pos, max=size - 1) if rolling else pos
    outs, lses = [], []
    for j in range(n):
        o, lse = decode_mha(q, k[:, j * blk:(j + 1) * blk],
                            v[:, j * blk:(j + 1) * blk],
                            (bound - j * blk).to(torch.int32), cap=cap,
                            return_lse=True)
        outs.append(o.float())
        lses.append(lse)
    top = torch.stack(lses).amax(0)
    w = [torch.exp(lse - top) for lse in lses]
    num = sum(o * wj[:, None, :, None] for o, wj in zip(outs, w))
    return (num / sum(w)[:, None, :, None]).to(q.dtype), lses


@pytest.mark.parametrize("g,cap", [(1, 0.0), (2, 3.0), (4, 0.0)])
@pytest.mark.parametrize("rolling", [False, True])
def test_decode_blocks_merged_by_lse_are_the_whole_decode(g, cap, rolling):
    b, kv, size, d, n = 4, 2, 24, 16, 4
    rng = np.random.default_rng(g + 10 * rolling)
    q = rng.normal(size=(b, 1, kv * g, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, size, kv, d)).astype(np.float32)
            for _ in range(2))
    pos = np.array([0, 5, 13, 23] if not rolling else [30, 47, 24, 99],
                   np.int32)
    got, lses = _merged(*(torch.as_tensor(t) for t in (q, k, v, pos)), n,
                        cap, rolling)
    last = np.minimum(pos, size - 1)
    want = j_decode_ref(jnp.asarray(q[:, 0].reshape(b, kv, g, d)),
                        jnp.asarray(k.transpose(0, 2, 1, 3)),
                        jnp.asarray(v.transpose(0, 2, 1, 3)),
                        jnp.asarray(last), cap=cap)
    np.testing.assert_allclose(got[:, 0].numpy(),
                               np.asarray(want).reshape(b, kv * g, d),
                               atol=1e-6, rtol=1e-6)
    if not rolling:                 # blocks wholly past pos: -inf
        assert bool(torch.isneginf(lses[3][0]).all())
        assert bool(torch.isneginf(lses[1][1]).all())


def test_empty_decode_rows_give_zero_and_minus_inf():
    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.normal(size=(3, 1, 4, 16)).astype(np.float32))
    k, v = (torch.as_tensor(rng.normal(size=(3, 8, 2, 16)).astype(
        np.float32)) for _ in range(2))
    pos = torch.tensor([-1, 3, -8], dtype=torch.int32)
    o, lse = decode_mha(q, k, v, pos, return_lse=True)
    assert not torch.isnan(o).any() and not torch.isnan(lse).any()
    assert not o[0].any() and not o[2].any() and o[1].abs().sum() > 0
    assert bool(torch.isneginf(lse[[0, 2]]).all())
    assert bool(torch.isfinite(lse[1]).all())
    assert torch.equal(decode_mha(q, k, v, pos), o)


# ---------------------------------------------------------------------------
# the LMs under the sequence layouts, on meshes of CPU entries
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("seq_shard") / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", SCRIPT, path], env=env,
                         capture_output=True, text=True, timeout=900)
    assert "SEQ_SHARD_OK" in out.stdout, out.stdout + out.stderr[-4000:]
    with np.load(path) as z:
        return dict(z)


def _tree(ref, prefix):
    """A reference tree back from its flattened ``keystr`` keys (a quoted
    part is a dict key, a bare one a list index)."""
    tree = {}
    for key, v in ref.items():
        if not key.startswith(prefix + "["):
            continue
        parts = [p if p.startswith("'") else int(p)
                 for p in key[len(prefix) + 1:-1].split("][")]
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return _lists(tree)


def _lists(tree):
    """Quoted keys unquoted, dicts keyed 0..n-1 back to lists."""
    if not isinstance(tree, dict):
        return tree
    tree = {(k.strip("'") if isinstance(k, str) else k): _lists(v)
            for k, v in tree.items()}
    if tree and all(isinstance(k, int) for k in tree):
        return [tree[i] for i in range(len(tree))]
    return tree


def _cfg(case):
    arch, heads = CASES[case][:2]
    cfg = get_arch(arch).reduced()
    if heads:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, n_heads=heads, n_kv_heads=heads))
    return cfg


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros(v) for v in tree]
    return np.zeros_like(tree)


_REF = []


@pytest.fixture(autouse=True)
def _keep_ref(ref):
    if not _REF:
        _REF.append(ref)


def _serve(model, params, toks, dec, s, cache, extra, pre, dec_rules, mesh):
    """A prefill and the decode steps (under ``mesh`` with the rules, or
    without one): each call's logits, and the last cache."""
    start = s + (extra.shape[1] if extra is not None else 0)
    with torch.no_grad():
        with use_mesh_rules(mesh, **pre):
            logits, kv = model.prefill(params, toks[:, :s], cache,
                                       extra_embeds=extra)
        out = [logits]
        for i in range(STEPS):
            pos = torch.full((B, 1), start + i, dtype=torch.int32)
            with use_mesh_rules(mesh, **dec_rules):
                logits, kv = model.decode_step(params, dec[i][:, None], pos,
                                               kv)
            out.append(logits)
    return out, kv


def _loss_and_grads(model, params, tokens, labels, extra, mesh, rules):
    for p in leaves(params):
        p.grad = None
    with use_mesh_rules(mesh, **rules):
        loss = model.train_loss(params, tokens, labels, extra_embeds=extra)
    loss.backward()
    grads = [p.grad.clone() for p in leaves(params)]
    for p in leaves(params):
        p.grad = None
    return loss.detach(), grads


@functools.lru_cache(maxsize=None)
def _runs(case):
    ref = _REF[0]
    _, _, shape, s, cache, train, pre, dec_rules = CASES[case]
    cfg = _cfg(case)
    model = TransformerLM(cfg, CPU)
    params = lm_params_from_arrays(cfg, _tree(ref, f"{case}/p"), CPU)
    for p in leaves(params):
        p.requires_grad_(True)
    toks = torch.as_tensor(ref[f"{case}/toks"]).long()
    dec = torch.as_tensor(ref[f"{case}/dec"]).long()
    extra = torch.as_tensor(ref[f"{case}/patches"]) \
        if cfg.vision_tokens else None
    mesh = make_mesh(shape, ("data", "model"), [CPU] * 8)
    out = {"paths": [p for p, _ in leaves_with_paths(params)]}
    out["plain_logits"], _ = _serve(model, params, toks, dec, s, cache,
                                    extra, {}, {}, None)
    with use_mesh_rules(mesh, **pre):
        out["sp_prefill"] = model.spmd("prefill", B)
    with use_mesh_rules(mesh, **dec_rules):
        out["sp_decode"] = model.spmd("decode", B)
    out["logits"], out["cache"] = _serve(model, params, toks, dec, s, cache,
                                         extra, pre, dec_rules, mesh)
    if train is not None:
        tokens, labels = toks[:, :-1], toks[:, 1:]
        out["plain_loss"], out["plain_grads"] = _loss_and_grads(
            model, params, tokens, labels, extra, None, {})
        out["loss"], out["grads"] = _loss_and_grads(
            model, params, tokens, labels, extra, mesh, train)
        with use_mesh_rules(mesh, **train):
            out["sp_train"] = model.spmd("train", B)
        arrays = _tree(ref, f"{case}/p")
        batch = {"tokens": tokens, "labels": labels}
        if extra is not None:
            batch["patch_embeds"] = extra
        for side, m in (("plain_step", None), ("step", mesh)):
            state = train_state_from_arrays(cfg, {"params": arrays, "opt": {
                "m": _zeros(arrays), "v": _zeros(arrays),
                "step": np.int32(0)}}, CPU)
            step = make_train_step(model, cfg, TrainConfig())
            with use_mesh_rules(m, **train):
                out[side] = step(state, batch)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_the_layouts_run_position_by_position(case):
    run = _runs(case)
    n = math.prod(CASES[case][2])
    pre, dec = run["sp_prefill"], run["sp_decode"]
    assert pre.n == dec.n == n and pre.seq_kv and dec.seq_kv
    assert pre.seq_rows == (CASES[case][5] is not None)
    assert not dec.seq_rows
    if "sp_train" in run:
        assert run["sp_train"].seq_rows and not run["sp_train"].seq_kv
    assert isinstance(run["cache"], ShardedCache)
    size = CASES[case][4]
    for blocks in run["cache"].blocks:
        for st in blocks:
            if "k" in st:       # by slots: a quarter of the cache or window
                assert st["k"].shape[1] in (size // 4, 32 // 4)
                assert st["k"].shape[2] == _cfg(case).attention.n_kv_heads


@pytest.mark.parametrize("case", list(CASES))
def test_serving_logits_match_the_unsharded_port(case):
    run = _runs(case)
    for got, want in zip(run["logits"], run["plain_logits"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **PORT_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_serving_logits_match_the_reference_under_the_mesh(ref, case):
    run = _runs(case)
    for i, got in enumerate(run["logits"]):
        np.testing.assert_allclose(got.numpy(), ref[f"{case}/logits{i}"],
                                   **REF_LOGITS_TOL)


@pytest.mark.parametrize("case", TRAINED)
def test_loss_and_gradients_match_the_unsharded_port(case):
    run = _runs(case)
    np.testing.assert_allclose(run["loss"].item(), run["plain_loss"].item(),
                               **PORT_TOL)
    for path, g, w in zip(run["paths"], run["grads"], run["plain_grads"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **PORT_TOL,
                                   err_msg=path)


@pytest.mark.parametrize("case", TRAINED)
def test_loss_and_gradients_match_the_reference_under_the_mesh(ref, case):
    run = _runs(case)
    cfg = _cfg(case)
    np.testing.assert_allclose(run["loss"].item(), float(ref[f"{case}/loss"]),
                               rtol=REF_LOSS_RTOL, atol=0)
    want = leaves(lm_params_from_arrays(cfg, _tree(ref, f"{case}/g"), CPU,
                                        dtype=torch.float32))
    assert len(want) == len(run["grads"])
    for path, g, w in zip(run["paths"], run["grads"], want):
        w = w.numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=REF_GRAD_SHARE * max(np.abs(w).max(), 1e-30), err_msg=path)


@pytest.mark.parametrize("case", TRAINED)
def test_train_step_matches_the_unsharded_port(case):
    (plain, pm), (state, m) = _runs(case)["plain_step"], _runs(case)["step"]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(m[k].item(), pm[k].item(), **PORT_TOL)
    assert int(state["opt"]["step"]) == int(plain["opt"]["step"]) == 1
    for (path, a), b in zip(leaves_with_paths(
            {"params": state["params"], "m": state["opt"]["m"],
             "v": state["opt"]["v"]}),
            leaves({"params": plain["params"], "m": plain["opt"]["m"],
                    "v": plain["opt"]["v"]})):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   **PORT_TOL, err_msg=path)


@pytest.mark.parametrize("arch,heads,shape", [
    ("minicpm-2b", 6, (2, 4)), ("gemma2-9b", None, (1, 4))])
def test_the_batcher_serves_the_sequence_layouts(arch, heads, shape):
    """Ragged prompts (left-padded to 7 rows: a prefill ``model`` does not
    divide, padded at the end inside the model) under both rules at
    once: the prefill by rows with the cache by slots (gemma2's local
    layers' a rolling buffer), decode by slots, the weights held once for
    each layout; the tokens are the unsharded batcher's."""
    cfg = get_arch(arch).reduced()
    if heads:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, n_heads=heads, n_kv_heads=heads))
    model = TransformerLM(cfg, CPU)
    params = model.init(torch.Generator().manual_seed(4))

    def serve():
        batcher = ContinuousBatcher(model, cfg, ServeConfig(max_batch=4,
                                                            max_seq=48),
                                    params)
        for i in range(5):
            batcher.submit(Request(i, [3 + i, 5, 7 + i, 9][:2 + i % 3] +
                                   [11] * (i % 2) * 4, 5))
        return sorted((r.rid, tuple(r.out)) for r in batcher.run()), batcher
    plain, _ = serve()
    with use_mesh_rules(make_mesh(shape, ("data", "model"), [CPU] * 8),
                        **ROWS_KV):
        got, batcher = serve()
    assert got == plain
    assert {rows for _, rows in batcher._held} == {True, False}
