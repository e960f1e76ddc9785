"""whisper-tiny and xlstm-350m under the reference's sequence-sharded
rules, on the CPU: the reduced models run position by position on meshes
of CPU entries whose ``model`` axis does not divide their heads (3 heads
here), against the port unsharded and the reference jitted under the same
mesh and rules.

* whisper: training and prefill under ``attn_seq_shard`` (the decoder's
  rows and the encoder's frames over ``model``; 18 frames on a model axis
  of 4 padded to 20, the keys cut back to 18), prefill and decode under
  ``seq_shard_kv`` (the self cache by slots; the cross cache by slots
  where ``model`` divides the frames, held whole where it divides neither
  the frames nor the heads, and by heads on a model axis of 3, whose
  decode splits the heads).
* xLSTM: training and prefill with the rows over ``model``, each
  position's recurrence starting from the state its predecessor hands on
  (a prefill whose rows ``model`` does not divide stops the state at the
  last real row); decode on the state split along its widest trailing
  dimension (the mLSTM's key rows through the decode step's key-block
  mode, the sLSTM's ``head_dim``).
* Each against the unsharded port (float32, 1e-5 on logits, loss,
  gradients and final states) and against the reference under the same
  mesh and rules (one 8-device subprocess: logits 1e-4, loss 1e-5
  relative, gradients 1e-4 of the leaf's largest); one
  ``make_train_step`` step and ``ContinuousBatcher`` against the same
  unsharded.
* The pieces: the plain key-block decode step over 4 blocks merged
  against the whole step within 1e-6; the row-block hand-off of the
  mLSTM's plain version at chunk boundaries and of the sLSTM bitwise the
  whole sequence; the mLSTM plain version's dC0, dn0, dm0 against
  ``jax.vjp`` of the reference's ``mlstm_seq`` with respect to its state,
  from a non-zero state; the layouts' gaps.

Inputs are numpy-seeded; the reference's parameters reach the port
through ``convert``.
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

from repro.models import recurrent as j_rec  # noqa: E402
from repro_torch.configs.base import (MULTI_POD_MESH, SHAPES_BY_NAME,  # noqa
                                      SINGLE_POD_MESH, ServeConfig,
                                      TrainConfig)
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import (lm_params_from_arrays,  # noqa: E402
                                 train_state_from_arrays,
                                 whisper_params_from_arrays)
from repro_torch.kernels.mlstm_chunk.ref import (  # noqa: E402
    chunk_math, decode_block_merge, mlstm_chunk_ref, mlstm_decode_block_ref)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402
from repro_torch.models.transformer import (MISSING_LAYOUT,  # noqa: E402
                                            ShardedCache, mesh_layout_gap)
from repro_torch.models.whisper import cross_layout  # noqa: E402
from repro_torch.parallel.sharding import make_mesh, use_mesh_rules  # noqa
from repro_torch.runtime.serve_loop import (ContinuousBatcher,  # noqa
                                            Request)
from repro_torch.runtime.train_loop import make_train_step  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

CPU = torch.device("cpu")
#: against the unsharded port: 1e-5 of the largest value of the tensor
#: (float32 sums in another order: the mLSTM's plain version at chunks of
#: each position's rows, the decode step's partial sums over the key
#: blocks, the positions' gradient partials)
PORT_SHARE = 1e-5
ZERO_GRAD_SHARE = 1e-3
REF_LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
REF_LOSS_RTOL = 1e-5
REF_GRAD_SHARE = 1e-4
B, STEPS, HEADS = 4, 2, 3
#: the training rows (the prompt rows of a case may be fewer, and need
#: not split over ``model``: the prefill pads them)
TRAIN_ROWS = 16
ROWS = dict(attn_seq_shard=True)
KV = dict(seq_shard_kv=True)
ROWS_KV = dict(attn_seq_shard=True, seq_shard_kv=True)
#: name -> (arch, encoder frames (0: none), mesh, prompt rows, cache,
#: rules of the training loss (None: not trained), of the prefill, of the
#: decode steps)
CASES = {
    "whisper-d1m2-f16": ("whisper-tiny", 16, (1, 2), 12, 24, ROWS, ROWS_KV,
                         KV),
    "whisper-d2m4-f18": ("whisper-tiny", 18, (2, 4), 10, 24, ROWS, ROWS_KV,
                         KV),
    "whisper-d1m3-heads": ("whisper-tiny", 16, (1, 3), 12, 24, None, {},
                           KV),
    "xlstm-d1m2": ("xlstm-350m", 0, (1, 2), 16, 24, ROWS, ROWS_KV, KV),
    "xlstm-d2m4": ("xlstm-350m", 0, (2, 4), 14, 24, ROWS, ROWS_KV, KV),
}
TRAINED = [c for c, v in CASES.items() if v[5] is not None]

SCRIPT = textwrap.dedent('''
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.parallel.sharding import use_mesh_rules
    from repro.configs.registry import get_arch
    from repro.models import build_model
    from repro.runtime import train_loop as j_train

    CASES, B, STEPS, HEADS, T = {cases}, {b}, {steps}, {heads}, {t}
    ZERO = ("scale", "bias", "bq", "bk", "bv")
    mesh_of = lambda shape: jax.make_mesh(
        shape, ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {{}}
    for c, (name, (arch, frames, shape, s, cache, train, pre, dec)) in \\
            enumerate(sorted(CASES.items())):
        cfg = get_arch(arch).reduced()
        cfg = dataclasses.replace(cfg, d_model=16 * HEADS,
                                  attention=dataclasses.replace(
                                      cfg.attention, n_heads=HEADS,
                                      n_kv_heads=HEADS))
        if frames:
            cfg = dataclasses.replace(cfg, enc_seq=frames)
        model = build_model(cfg)
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
        toks = rng.integers(0, cfg.vocab_size, size=(B, max(s, T) + 1)
                            ).astype(np.int32)
        dec_toks = rng.integers(0, cfg.vocab_size, size=(STEPS, B)).astype(
            np.int32)
        out[f"{{name}}/toks"], out[f"{{name}}/dec"] = toks, dec_toks
        fr = None
        if frames:
            fr = rng.normal(size=(B, frames, cfg.d_model)).astype(np.float32)
            out[f"{{name}}/frames"] = fr
        jp = jax.tree.map(jnp.asarray, params)
        mesh = mesh_of(shape)
        with use_mesh_rules(mesh, **pre):
            if frames:
                logits, kv = jax.jit(lambda p, t, f: model.prefill(
                    p, t, f, cache))(jp, jnp.asarray(toks[:, :s]),
                                     jnp.asarray(fr))
            else:
                logits, kv = jax.jit(lambda p, t: model.prefill(
                    p, t, cache))(jp, jnp.asarray(toks[:, :s]))
        out[f"{{name}}/logits0"] = np.asarray(logits)
        with use_mesh_rules(mesh, **dec):
            step = jax.jit(model.decode_step)
            for i in range(STEPS):
                logits, kv = step(jp, jnp.asarray(dec_toks[i][:, None]),
                                  jnp.full((B, 1), s + i, jnp.int32), kv)
                out[f"{{name}}/logits{{i + 1}}"] = np.asarray(logits)
        if train is not None:
            batch = {{"tokens": jnp.asarray(toks[:, :T]),
                     "labels": jnp.asarray(toks[:, 1:T + 1])}}
            if frames:
                batch["frames"] = jnp.asarray(fr)
            with use_mesh_rules(mesh, **train):
                loss, g = jax.jit(jax.value_and_grad(
                    lambda p, b: j_train._loss_fn(model, cfg, p, b)))(
                    jp, batch)
            out[f"{{name}}/loss"] = np.asarray(loss)
            for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
                out[f"{{name}}/g" + jax.tree_util.keystr(path)] = \\
                    np.asarray(leaf)
    np.savez(sys.argv[1], **out)
    print("SEQ_FAMILIES_OK")
''').format(cases=repr(CASES), b=B, steps=STEPS, heads=HEADS,
           t=TRAIN_ROWS)


def _reduced(arch, frames=0):
    """The reduced config with ``HEADS`` heads of width 16 (``model``
    axes of 2 and 4 do not divide them)."""
    cfg = get_arch(arch).reduced()
    cfg = dataclasses.replace(cfg, d_model=16 * HEADS,
                              attention=dataclasses.replace(
                                  cfg.attention, n_heads=HEADS,
                                  n_kv_heads=HEADS))
    return dataclasses.replace(cfg, enc_seq=frames) if frames else cfg


# ---------------------------------------------------------------------------
# the pieces: the key-block decode step, the hand-off, the state gradient
# ---------------------------------------------------------------------------


def _f(rng, *shape):
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("d,blocks", [(16, 4), (64, 4), (64, 8)])
def test_key_block_decode_merged_is_the_whole_step(d, blocks):
    """The plain key-block decode step on ``blocks`` blocks of the key
    rows, the partial numerators and denominators summed and divided once
    (``decode_block_merge``), against the one-step chunk over the whole
    state within 1e-6; the blocks' C1 and n1 are the whole step's rows;
    m1 is the whole step's."""
    rng = np.random.default_rng(d + blocks)
    b, h = 3, 2
    q, k, v = (_f(rng, b, 1, h, d) for _ in range(3))
    ip, fp = _f(rng, b, 1, h), _f(rng, b, 1, h)
    C0, n0, m0 = _f(rng, b, h, d, d), _f(rng, b, h, d), _f(rng, b, h)
    scale = 1.0 / math.sqrt(d)
    want_h, C1, n1, m1 = chunk_math(q, k, v, ip, fp, C0, n0, m0, scale)
    c = d // blocks
    num = den = 0
    for j in range(blocks):
        rows = slice(j * c, (j + 1) * c)
        nb, db, Cb, nb1, mb = mlstm_decode_block_ref(
            q[..., rows], k[..., rows], v, ip, fp, C0[:, :, rows],
            n0[:, :, rows], m0, scale)
        num, den = num + nb, den + db
        torch.testing.assert_close(Cb, C1[:, :, rows], atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(nb1, n1[:, :, rows], atol=1e-6,
                                   rtol=1e-6)
        torch.testing.assert_close(mb, m1, atol=0, rtol=0)
    got = decode_block_merge(num, den, m1)
    torch.testing.assert_close(got, want_h, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("chunk,block", [(32, 64), (64, 128), (16, 48)])
def test_mlstm_handed_on_at_chunk_boundaries_is_bitwise_the_whole(chunk,
                                                                  block):
    """The mLSTM's plain version over row blocks that start at chunk
    boundaries, each from the state the block before it stopped at, is
    bitwise one call over the whole sequence at the same chunks: the
    outputs and the final state."""
    rng = np.random.default_rng(chunk)
    b, h, d, s = 2, 2, 16, 3 * block
    q, k, v = (_f(rng, b, s, h, d) for _ in range(3))
    ip, fp = _f(rng, b, s, h), _f(rng, b, s, h) + 2.0
    state = (_f(rng, b, h, d, d), _f(rng, b, h, d), _f(rng, b, h))
    want = mlstm_chunk_ref(q, k, v, ip, fp, *state, 0.25, chunk=chunk)
    hs, st = [], state
    for lo in range(0, s, block):
        rows = slice(lo, lo + block)
        out, *st = mlstm_chunk_ref(q[:, rows], k[:, rows], v[:, rows],
                                   ip[:, rows], fp[:, rows], *st, 0.25,
                                   chunk=chunk)
        hs.append(out)
    assert torch.equal(torch.cat(hs, dim=1), want[0])
    for a, w in zip(st, want[1:]):
        assert torch.equal(a, w)


def test_slstm_handed_on_is_bitwise_the_whole():
    """The sLSTM's step loop over row blocks, each from the state the
    block before it stopped at, is bitwise the loop over the whole
    sequence."""
    g = torch.Generator().manual_seed(0)
    p = rec.slstm_init(32, 2, 16, g, torch.float32)
    x = _f(np.random.default_rng(1), 2, 24, 32)
    st0 = rec.slstm_state(2, 2, 16, torch.float32, CPU)
    y, want = rec.slstm_seq(p, x, st0)
    ys, st = [], st0
    for lo in range(0, 24, 8):
        yb, st = rec.slstm_seq(p, x[:, lo:lo + 8], st)
        ys.append(yb)
    assert torch.equal(torch.cat(ys, dim=1), y)
    for name in want:
        assert torch.equal(st[name], want[name])


@pytest.mark.parametrize("s", [37, 300, 512])
def test_mlstm_initial_state_gradient_matches_jax(s):
    """dC0, dn0 and dm0 of the port's ``mlstm_seq`` (its autograd
    Function on the CPU: the plain forward and backward at the reference's
    chunks) from a non-zero state, with cotangents on y and on the final
    state, against ``jax.vjp`` of the reference's ``mlstm_seq`` with
    respect to its state (one chunk at S 37 and 300, two of 256 at
    512)."""
    rng = np.random.default_rng(s)
    b, h, d, dm = 2, 2, 16, 32
    jp = j_rec.mlstm_init(jax.random.PRNGKey(s), dm, h, d)
    jp = jax.tree.map(lambda t: np.asarray(t, np.float32), jp)
    x = rng.normal(size=(b, s, dm)).astype(np.float32)
    state = {"C": rng.normal(size=(b, h, d, d)).astype(np.float32),
             "n": rng.normal(size=(b, h, d)).astype(np.float32),
             "m": rng.normal(size=(b, h)).astype(np.float32)}
    cot_y = rng.normal(size=(b, s, dm)).astype(np.float32)
    cot = {"C": rng.normal(size=(b, h, d, d)).astype(np.float32),
           "n": rng.normal(size=(b, h, d)).astype(np.float32),
           "m": rng.normal(size=(b, h)).astype(np.float32)}
    fn = jax.jit(lambda st: j_rec.mlstm_seq(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x), st))
    out, vjp = jax.vjp(fn, jax.tree.map(jnp.asarray, state))
    (want,) = vjp((jnp.asarray(cot_y), jax.tree.map(jnp.asarray, cot)))
    tp = {k: torch.as_tensor(v) for k, v in jp.items()}
    ts = {k: torch.as_tensor(v).requires_grad_() for k, v in state.items()}
    y, fin = rec.mlstm_seq(tp, torch.as_tensor(x), ts)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out[0]),
                               atol=1e-4, rtol=1e-4)
    torch.autograd.backward([y] + [fin[k] for k in ("C", "n", "m")],
                            [torch.as_tensor(cot_y)] +
                            [torch.as_tensor(cot[k]) for k in ("C", "n",
                                                               "m")])
    for k in ("C", "n", "m"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(ts[k].grad.numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["whisper-tiny", "xlstm-350m"])
@pytest.mark.parametrize("mesh_cfg", [SINGLE_POD_MESH, MULTI_POD_MESH])
def test_registry_cells_have_no_gap_under_the_dry_runs_flags(arch,
                                                             mesh_cfg):
    """Every supported shape of the two configs on the reference's (16,
    16) and (2, 16, 16) meshes, under the flags the reference's dry run
    picks (``attn_seq_shard`` where ``model`` does not divide the heads,
    but in decode; ``seq_shard_kv`` for prefill and decode where it does
    not divide the KV heads or the context is 256k or longer;
    ``kv_batch_shard`` where the batch splits), runs the port's sharded
    program."""
    cfg = get_arch(arch)
    mesh = make_mesh(mesh_cfg.shape, mesh_cfg.axes,
                     ["meta"] * mesh_cfg.n_devices)
    n_batch = math.prod(mesh_cfg.shape[:-1])
    for name in cfg.supported_shapes:
        shape = SHAPES_BY_NAME[name]
        rules = dict(
            seq_shard_kv=shape.kind != "train" and (
                shape.seq_len >= 262144 or
                cfg.attention.n_kv_heads % mesh.shape["model"] != 0),
            attn_seq_shard=cfg.attention.n_heads % mesh_cfg.shape[-1] != 0
            and shape.kind != "decode",
            kv_batch_shard=shape.global_batch % n_batch == 0 and
            shape.global_batch > 1)
        with use_mesh_rules(mesh, **rules):
            assert mesh_layout_gap(cfg, mesh, shape.kind,
                                   shape.global_batch) is None, name


@pytest.mark.parametrize("arch,kind,rules,gap", [
    ("whisper-tiny", "train", ROWS, "audio_heads"),
    ("whisper-tiny", "prefill", ROWS_KV, "audio_heads"),
    ("whisper-tiny", "decode", {}, "audio_heads"),
    ("whisper-tiny", "decode", KV, None),
    ("xlstm-350m", "train", ROWS, "ssm_heads"),
    ("xlstm-350m", "decode", KV, "ssm_heads"),
])
def test_heads_over_model_are_the_open_gap(arch, kind, rules, gap):
    """Where ``model`` divides the heads (4 of the reduced config's 4 on
    a model axis of 2) the rules put the heads on ``model``: a layout
    the port does not run yet (``MISSING_LAYOUT``, ROADMAP item 25.5),
    but for whisper's decode under ``seq_shard_kv``, which the existing
    pieces cover (the self cache by slots, the heads' q gathered)."""
    cfg = get_arch(arch).reduced()
    mesh = make_mesh((1, 2), ("data", "model"), [CPU] * 2)
    with use_mesh_rules(mesh, **rules):
        assert mesh_layout_gap(cfg, mesh, kind, 4) == gap
    if gap:
        assert "25.5" in MISSING_LAYOUT[gap]


# ---------------------------------------------------------------------------
# the reduced models under meshes of CPU entries
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("seq_families") / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", SCRIPT, path], env=env,
                         capture_output=True, text=True, timeout=900)
    assert "SEQ_FAMILIES_OK" in out.stdout, out.stdout + out.stderr[-4000:]
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
    if not isinstance(tree, dict):
        return tree
    tree = {(k.strip("'") if isinstance(k, str) else k): _lists(v)
            for k, v in tree.items()}
    if tree and all(isinstance(k, int) for k in tree):
        return [tree[i] for i in range(len(tree))]
    return tree


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros(v) for v in tree]
    return np.zeros_like(tree)


def _cfg(case):
    return _reduced(CASES[case][0], CASES[case][1])


def _convert(cfg, arrays, dtype=None):
    conv = whisper_params_from_arrays if cfg.family == "audio" \
        else lm_params_from_arrays
    return conv(cfg, arrays, CPU, dtype)


def _close(got, want, what="", share=PORT_SHARE, floor=0.0):
    """``got`` within ``share`` of ``want``'s largest value, or of
    ``floor`` where that is larger."""
    want = want.numpy() if hasattr(want, "numpy") else want
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0,
        atol=share * max(np.abs(want).max(), floor, 1e-30), err_msg=what)


def _floor(grads):
    """``ZERO_GRAD_SHARE`` of the largest gradient of the model: the
    limit's floor for a leaf whose gradient is zero in exact arithmetic
    (whisper's key biases: the softmax ignores a shift of a row's scores
    by a constant), which holds float32 noise only."""
    return ZERO_GRAD_SHARE * max(float(np.abs(np.asarray(g)).max())
                                 for g in grads)


_REF = []


@pytest.fixture
def _keep_ref(ref):
    if not _REF:
        _REF.append(ref)


def _prefill(model, params, toks, frames, cache):
    if frames is not None:
        return model.prefill(params, toks, frames, cache)
    return model.prefill(params, toks, cache)


def _serve(model, params, toks, dec, s, cache, frames, pre, dec_rules,
           mesh):
    """A prefill and the decode steps (under ``mesh`` with the rules, or
    without one): each call's logits, and the prefill's and the last
    caches."""
    with torch.no_grad():
        with use_mesh_rules(mesh, **pre):
            logits, kv = _prefill(model, params, toks[:, :s], frames, cache)
        first = kv
        out = [logits]
        for i in range(STEPS):
            pos = torch.full((B, 1), s + i, dtype=torch.int32)
            with use_mesh_rules(mesh, **dec_rules):
                logits, kv = model.decode_step(params, dec[i][:, None], pos,
                                               kv)
            out.append(logits)
    return out, first, kv


def _loss_and_grads(model, params, tokens, labels, frames, mesh, rules):
    for p in leaves(params):
        p.grad = None
    with use_mesh_rules(mesh, **rules):
        if frames is not None:
            loss = model.train_loss(params, tokens, labels, frames)
        else:
            loss = model.train_loss(params, tokens, labels)
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for p in leaves(params)]
    for p in leaves(params):
        p.grad = None
    return loss.detach(), grads


@functools.lru_cache(maxsize=None)
def _runs(case):
    ref = _REF[0]
    _, frames_n, shape, s, cache, train, pre, dec_rules = CASES[case]
    cfg = _cfg(case)
    model = build_model(cfg, CPU)
    params = _convert(cfg, _tree(ref, f"{case}/p"))
    for p in leaves(params):
        p.requires_grad_(True)
    toks = torch.as_tensor(ref[f"{case}/toks"]).long()
    dec = torch.as_tensor(ref[f"{case}/dec"]).long()
    frames = torch.as_tensor(ref[f"{case}/frames"]) if frames_n else None
    mesh = make_mesh(shape, ("data", "model"), [CPU] * 8)
    out = {"paths": [p for p, _ in leaves_with_paths(params)]}
    out["plain_logits"], out["plain_first"], _ = _serve(
        model, params, toks, dec, s, cache, frames, {}, {}, None)
    with use_mesh_rules(mesh, **pre):
        out["sp_prefill"] = model.spmd("prefill", B)
    with use_mesh_rules(mesh, **dec_rules):
        out["sp_decode"] = model.spmd("decode", B)
    out["logits"], out["first"], out["cache"] = _serve(
        model, params, toks, dec, s, cache, frames, pre, dec_rules, mesh)
    if train is not None:
        tokens, labels = toks[:, :TRAIN_ROWS], toks[:, 1:TRAIN_ROWS + 1]
        out["plain_loss"], out["plain_grads"] = _loss_and_grads(
            model, params, tokens, labels, frames, None, {})
        out["loss"], out["grads"] = _loss_and_grads(
            model, params, tokens, labels, frames, mesh, train)
        arrays = _tree(ref, f"{case}/p")
        batch = {"tokens": tokens, "labels": labels}
        if frames is not None:
            batch["frames"] = frames
        for side, m in (("plain_step", None), ("step", mesh)):
            state = train_state_from_arrays(cfg, {"params": arrays, "opt": {
                "m": _zeros(arrays), "v": _zeros(arrays),
                "step": np.int32(0)}}, CPU)
            step = make_train_step(model, cfg, TrainConfig())
            with use_mesh_rules(m, **train):
                out[side] = step(state, batch)
    return out


@pytest.mark.usefixtures("_keep_ref")
@pytest.mark.parametrize("case", list(CASES))
def test_the_layouts_run_position_by_position(case):
    """The prefill and decode run the sharded program (the prefill under
    ``model`` 3, whose rules put whisper's heads on it, runs whole), the
    cache a ``ShardedCache`` of the layouts ``cache_shardings`` gives:
    whisper's self cache by slots and its cross cache by slots, heads or
    whole; an xLSTM state's key rows or ``head_dim`` by blocks."""
    run = _runs(case)
    arch, frames, shape, s, cache = CASES[case][:5]
    n_model = shape[1]
    sp = run["sp_decode"]
    assert sp is not None and sp.n == math.prod(shape) and sp.seq_kv
    assert isinstance(run["cache"], ShardedCache)
    if CASES[case][6]:
        assert run["sp_prefill"].seq_rows and isinstance(run["first"],
                                                         ShardedCache)
    else:
        assert run["sp_prefill"] is None
    for blocks in run["cache"].blocks:
        for st in blocks:
            if arch == "whisper-tiny":
                assert st["k"].shape[1] == cache // n_model
                layout = cross_layout(_cfg(case), sp)
                want = {"slots": (frames // n_model, HEADS),
                        "heads": (frames, HEADS // n_model),
                        "whole": (frames, HEADS)}[layout]
                assert tuple(st["cross_k"].shape[1:3]) == want
            elif "C" in st:
                assert st["C"].shape[2:] == (16 // n_model, 16)
                assert st["n"].shape[2] == 16 // n_model
                assert st["m"].shape[1] == HEADS
            else:
                assert {t.shape[2] for t in st.values()} == {16 // n_model}
    layouts = {c: cross_layout(_cfg(c), _runs(c)["sp_decode"])
               for c in CASES if CASES[c][0] == "whisper-tiny"}
    if case == "whisper-d1m3-heads":
        assert set(layouts.values()) == {"slots", "heads", "whole"}


@pytest.mark.usefixtures("_keep_ref")
@pytest.mark.parametrize("case", list(CASES))
def test_serving_logits_match_the_unsharded_port(case):
    run = _runs(case)
    for got, want in zip(run["logits"], run["plain_logits"]):
        _close(got, want)


@pytest.mark.usefixtures("_keep_ref")
@pytest.mark.parametrize("case", [c for c in CASES
                                  if CASES[c][0] == "xlstm-350m"])
def test_prefill_final_states_match_the_unsharded_port(case):
    """The prefill's state blocks, assembled, are the unsharded prefill's
    final state (the last real row's, where the rows were padded)."""
    run = _runs(case)
    sp = run["sp_prefill"]
    for i, whole in enumerate(run["plain_first"]):
        for name, t in whole.items():
            for k in range(sp.n):
                rows = sp.block(t, (sp.batch_entry(),), k, copy=False)
                want = rec.state_block(sp, k, rows)
                got = run["first"].blocks[k][i][name]
                _close(got, want, name)


@pytest.mark.usefixtures("_keep_ref")
@pytest.mark.parametrize("case", list(CASES))
def test_serving_logits_match_the_reference_under_the_mesh(ref, case):
    run = _runs(case)
    for i, got in enumerate(run["logits"]):
        np.testing.assert_allclose(got.numpy(), ref[f"{case}/logits{i}"],
                                   **REF_LOGITS_TOL)


@pytest.mark.usefixtures("_keep_ref")
@pytest.mark.parametrize("case", TRAINED)
def test_loss_and_gradients_match_the_unsharded_port(case):
    run = _runs(case)
    np.testing.assert_allclose(run["loss"].item(), run["plain_loss"].item(),
                               rtol=PORT_SHARE, atol=0)
    floor = _floor(run["plain_grads"])
    for path, g, w in zip(run["paths"], run["grads"], run["plain_grads"]):
        _close(g, w, path, floor=floor)


@pytest.mark.usefixtures("_keep_ref")
@pytest.mark.parametrize("case", TRAINED)
def test_loss_and_gradients_match_the_reference_under_the_mesh(ref, case):
    run = _runs(case)
    cfg = _cfg(case)
    np.testing.assert_allclose(run["loss"].item(), float(ref[f"{case}/loss"]),
                               rtol=REF_LOSS_RTOL, atol=0)
    want = leaves(_convert(cfg, _tree(ref, f"{case}/g"), torch.float32))
    assert len(want) == len(run["grads"])
    floor = _floor(want)
    for path, g, w in zip(run["paths"], run["grads"], want):
        _close(g, w, path, REF_GRAD_SHARE, floor)


@pytest.mark.usefixtures("_keep_ref")
@pytest.mark.parametrize("case", TRAINED)
def test_train_step_matches_the_unsharded_port(case):
    (plain, pm), (state, m) = _runs(case)["plain_step"], _runs(case)["step"]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(m[k].item(), pm[k].item(),
                                   rtol=PORT_SHARE, atol=0)
    assert int(state["opt"]["step"]) == int(plain["opt"]["step"]) == 1
    for tree in ("params", "m", "v"):
        got = state["params"] if tree == "params" else state["opt"][tree]
        want = plain["params"] if tree == "params" else plain["opt"][tree]
        want = [t.detach() for t in leaves(want)]
        floor = _floor(want)
        for (path, a), w in zip(leaves_with_paths(got), want):
            _close(a.detach(), w, tree + path, floor=floor)


@pytest.mark.parametrize("arch,frames,shape", [
    ("whisper-tiny", 16, (2, 4)), ("xlstm-350m", 0, (2, 4))])
def test_the_batcher_serves_the_families_under_a_mesh(arch, frames, shape):
    """Ragged prompts (left-padded to 7 rows: a prefill ``model`` does not
    divide, padded at the end inside the model; whisper's frames a
    request each, a filler row's zeros) under both rules at once, the
    weights held once for each layout; the tokens are the unsharded
    batcher's."""
    cfg = _reduced(arch, frames)
    model = build_model(cfg, CPU)
    params = model.init(torch.Generator().manual_seed(4))
    rng = np.random.default_rng(4)
    extra = [torch.as_tensor(rng.normal(size=(frames, cfg.d_model)).astype(
        np.float32)) if frames else None for _ in range(5)]

    def serve():
        batcher = ContinuousBatcher(model, cfg, ServeConfig(max_batch=3,
                                                            max_seq=48),
                                    params)
        for i in range(5):
            batcher.submit(Request(i, [3 + i, 5, 7 + i, 9][:2 + i % 3] +
                                   [11] * (i % 2) * 4, 5, extra=extra[i]))
        return sorted((r.rid, tuple(r.out)) for r in batcher.run()), batcher
    plain, _ = serve()
    with use_mesh_rules(make_mesh(shape, ("data", "model"), [CPU] * 8),
                        **ROWS_KV):
        got, batcher = serve()
    assert got == plain
    assert batcher.filler_rows > 0
    assert {rows for _, rows in batcher._held} == {True, False}


@pytest.mark.parametrize("shape,s", [((1, 2), 16), ((2, 4), 14)])
def test_xlstm_prefill_at_chunk_boundaries_is_bitwise_the_unsharded(
        monkeypatch, shape, s):
    """With the mLSTM's plain version at chunks of 4 on both sides (every
    position's row block, 8 or 4 rows, starts at a chunk boundary) the
    sharded prefill's final state is bitwise the unsharded prefill's: the
    hand-off is the recurrence itself, the padded rows (14 on a model
    axis of 4) left out of it.  The logits, through products over fewer
    rows a call, within ``PORT_SHARE``."""
    from repro_torch.kernels.mlstm_chunk import ops
    monkeypatch.setitem(ops._BY_DEVICE, "cpu",
                        functools.partial(mlstm_chunk_ref, chunk=4))
    cfg = _reduced("xlstm-350m")
    model = build_model(cfg, CPU)
    params = model.init(torch.Generator().manual_seed(7))
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, s)))
    mesh = make_mesh(shape, ("data", "model"), [CPU] * 8)
    with torch.no_grad():
        want, whole = model.prefill(params, toks, 24)
        with use_mesh_rules(mesh, **ROWS_KV):
            got, cache = model.prefill(params, toks, 24)
    _close(got, want)
    sp = cache.sp
    for i, st in enumerate(whole):
        for name, t in st.items():
            for k in range(sp.n):
                rows = sp.block(t, (sp.batch_entry(),), k, copy=False)
                assert torch.equal(cache.blocks[k][i][name],
                                   rec.state_block(sp, k, rows)), name
