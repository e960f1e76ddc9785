"""The LMs under the reference's FSDP x TP rules, run position by
position on meshes of CPU entries, against the port unsharded and the
reference jitted under the same mesh.

Four reduced configs (gemma2-9b: alternating local / global attention,
softcaps, KV 2; minicpm-2b: KV = heads; recurrentgemma-9b: RG-LRU
width-parallel, KV 2; granite-moe: expert-parallel MoE, KV 2) under the
(data, model) meshes (1, 2), (2, 2), (1, 4) and (2, 4), so the KV heads
are split over ``model`` on 2 and projected on two positions each on 4.
Each runs a prefill of B 4 x S 12 into a cache of 16, 2 decode steps on
numpy-seeded tokens, the training loss with every parameter's gradient,
and one ``make_train_step`` step.  Held:

* against the port unsharded, within atol / rtol 1e-5 in float32: the
  logits, the loss, every gradient and every parameter and moment after
  the step.  The sharded program takes the MoE's load-balancing loss
  over each data shard's tokens and averages it over the shards, as the
  reference's expert-parallel path does, so its unsharded counterpart
  is the data shards' mean: the loss and gradients of each shard's rows
  run alone, and the step with one microbatch a data shard;
* against the reference jitted under the same mesh (one 8-device
  subprocess writes every result into one ``.npz``): the logits within
  1e-4, the loss within 1e-5 relative, every gradient within 1e-4 of
  its leaf's largest value.

Inputs are numpy-seeded; the reference's initial parameters (its zero
leaves drawn so that each counts) reach the port through
``convert.lm_params_from_arrays``.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import (lm_params_from_arrays,  # noqa: E402
                                 train_state_from_arrays)
from repro_torch.models.transformer import (ShardedCache,  # noqa: E402
                                            TransformerLM)
from repro_torch.parallel.sharding import make_mesh, use_mesh_rules  # noqa
from repro_torch.runtime.train_loop import make_train_step  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

CPU = torch.device("cpu")
ARCHS = ("gemma2-9b", "minicpm-2b", "recurrentgemma-9b",
         "granite-moe-1b-a400m")
MESHES = {"d1m2": (1, 2), "d2m2": (2, 2), "d1m4": (1, 4), "d2m4": (2, 4)}
B, S, CACHE, STEPS = 4, 12, 16, 2
PORT_TOL = dict(atol=1e-5, rtol=1e-5)
REF_LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
REF_LOSS_RTOL = 1e-5
REF_GRAD_SHARE = 1e-4
CASES = [(a, m) for a in ARCHS for m in MESHES]

SCRIPT = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.parallel.sharding import use_mesh_rules
    from repro.configs.registry import get_arch
    from repro.models.transformer import TransformerLM
    from repro.runtime import train_loop as j_train

    ARCHS, MESHES, B, S, CACHE, STEPS = {archs}, {meshes}, {b}, {s}, \\
        {cache}, {steps}
    ZERO = ("scale", "bias", "bq", "bk", "bv", "b_a", "b_i")
    mesh_of = lambda shape: jax.make_mesh(
        shape, ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {{}}
    for a, arch in enumerate(ARCHS):
        cfg = get_arch(arch).reduced()
        model = TransformerLM(cfg)
        rng = np.random.default_rng(a)

        def draw(tree):
            if isinstance(tree, dict):
                return {{k: (rng.normal(0, 0.3, size=v.shape).astype(
                    np.float32) if k in ZERO else draw(v))
                    for k, v in tree.items()}}
            if isinstance(tree, list):
                return [draw(v) for v in tree]
            return np.asarray(tree)
        params = draw(jax.tree.map(np.asarray,
                                   jax.jit(model.init)(jax.random.PRNGKey(a))))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{{arch}}/p" + jax.tree_util.keystr(path)] = leaf
        toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(
            np.int32)
        dec = rng.integers(0, cfg.vocab_size, size=(STEPS, B)).astype(
            np.int32)
        out[f"{{arch}}/toks"], out[f"{{arch}}/dec"] = toks, dec
        jp = jax.tree.map(jnp.asarray, params)
        batch = {{"tokens": jnp.asarray(toks[:, :-1]),
                 "labels": jnp.asarray(toks[:, 1:])}}
        for name, shape in MESHES.items():
            key = f"{{arch}}/{{name}}"
            with use_mesh_rules(mesh_of(shape)):
                logits, cache = jax.jit(model.prefill, static_argnums=2)(
                    jp, jnp.asarray(toks[:, :S]), CACHE)
                out[key + "/logits0"] = np.asarray(logits)
                step = jax.jit(model.decode_step)
                for i in range(STEPS):
                    logits, cache = step(jp, jnp.asarray(dec[i][:, None]),
                                         jnp.full((B, 1), S + i, jnp.int32),
                                         cache)
                    out[key + f"/logits{{i + 1}}"] = np.asarray(logits)
                loss, g = jax.jit(jax.value_and_grad(
                    lambda p, b: j_train._loss_fn(model, cfg, p, b)))(
                    jp, batch)
            out[key + "/loss"] = np.asarray(loss)
            for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
                out[key + "/g" + jax.tree_util.keystr(path)] = \\
                    np.asarray(leaf)
    np.savez(sys.argv[1], **out)
    print("TP_FSDP_OK")
''').format(archs=repr(ARCHS), meshes=repr(MESHES), b=B, s=S, cache=CACHE,
            steps=STEPS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp_fsdp") / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", SCRIPT, path], env=env,
                         capture_output=True, text=True, timeout=900)
    assert "TP_FSDP_OK" in out.stdout, out.stdout + out.stderr[-4000:]
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
    return _lists(_unquote(tree))


def _unquote(tree):
    if not isinstance(tree, dict):
        return tree
    return {(k.strip("'") if isinstance(k, str) else k): _unquote(v)
            for k, v in tree.items()}


def _lists(tree):
    """Dicts keyed 0..n-1 by list indices back to lists."""
    if not isinstance(tree, dict):
        return tree
    tree = {k: _lists(v) for k, v in tree.items()}
    if tree and all(isinstance(k, int) for k in tree):
        return [tree[i] for i in range(len(tree))]
    return tree


def _port_grads(cfg, ref, key):
    """The reference's gradient tree for ``key`` laid out as the port's
    parameters."""
    return lm_params_from_arrays(cfg, _tree(ref, key + "/g"), CPU,
                                 dtype=torch.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _setup(ref, arch):
    cfg = get_arch(arch).reduced()
    model = TransformerLM(cfg, CPU)
    arrays = _tree(ref, f"{arch}/p")
    return cfg, model, arrays


def _serve(model, params, toks, dec):
    """Prefill then the decode steps: the logits of each call."""
    logits, cache = model.prefill(params, toks[:, :S], CACHE)
    out = [logits]
    for i in range(STEPS):
        pos = torch.full((B, 1), S + i, dtype=torch.int32)
        logits, cache = model.decode_step(params, dec[i][:, None], pos,
                                          cache)
        out.append(logits)
    return out, cache


def _loss_and_grads(model, params, tokens, labels, n_shards=1):
    """The loss and every gradient; with ``n_shards`` the data shards'
    mean (each shard's rows run alone)."""
    for p in leaves(params):
        p.grad = None
    rows = tokens.shape[0] // n_shards
    loss = sum(model.train_loss(params, tokens[i * rows:(i + 1) * rows],
                                labels[i * rows:(i + 1) * rows])
               for i in range(n_shards)) / n_shards
    loss.backward()
    grads = [p.grad.clone() for p in leaves(params)]
    for p in leaves(params):
        p.grad = None
    return loss.detach(), grads


@functools.lru_cache(maxsize=None)
def _runs(arch, mesh_name):
    """Everything a case holds, run once: the unsharded port's and the
    sharded port's logits, loss, gradients and state after a step."""
    ref = _REF[0]
    cfg, model, arrays = _setup(ref, arch)
    shape = MESHES[mesh_name]
    toks, dec = _t(ref[f"{arch}/toks"]).long(), _t(ref[f"{arch}/dec"]).long()
    tokens, labels = toks[:, :-1], toks[:, 1:]
    params = lm_params_from_arrays(cfg, arrays, CPU)
    for p in leaves(params):
        p.requires_grad_(True)
    mesh = make_mesh(shape, ("data", "model"), [CPU] * 8)
    out = {}
    with torch.no_grad():
        out["plain_logits"], _ = _serve(model, params, toks, dec)
        with use_mesh_rules(mesh):
            out["logits"], out["cache"] = _serve(model, params, toks, dec)
    out["plain_loss"], out["plain_grads"] = _loss_and_grads(
        model, params, tokens, labels, n_shards=shape[0])
    with use_mesh_rules(mesh):
        out["loss"], out["grads"] = _loss_and_grads(model, params, tokens,
                                                    labels)
    out["paths"] = [p for p, _ in leaves_with_paths(params)]
    batch = {"tokens": tokens, "labels": labels}
    states = []
    for mb, rules in ((shape[0], False), (1, True)):
        state = _state(cfg, arrays)
        step = make_train_step(model, cfg, TrainConfig(microbatches=mb))
        if rules:
            with use_mesh_rules(mesh):
                state, metrics = step(state, batch)
        else:
            state, metrics = step(state, batch)
        states.append((state, metrics))
    out["plain_state"], out["state"] = states[0], states[1]
    return out


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros(v) for v in tree]
    return np.zeros_like(tree)


def _state(cfg, arrays):
    zeros = _zeros(arrays)
    return train_state_from_arrays(cfg, {"params": arrays, "opt": {
        "m": zeros, "v": zeros, "step": np.int32(0)}}, CPU)


_REF = []


@pytest.fixture(autouse=True)
def _keep_ref(ref):
    if not _REF:
        _REF.append(ref)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_serving_logits_match_the_unsharded_port(arch, mesh):
    run = _runs(arch, mesh)
    assert isinstance(run["cache"], ShardedCache)
    assert len(run["cache"].blocks) == int(np.prod(MESHES[mesh]))
    for got, want in zip(run["logits"], run["plain_logits"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **PORT_TOL)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_loss_and_gradients_match_the_unsharded_port(arch, mesh):
    run = _runs(arch, mesh)
    np.testing.assert_allclose(run["loss"].item(), run["plain_loss"].item(),
                               **PORT_TOL)
    for path, g, w in zip(run["paths"], run["grads"], run["plain_grads"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **PORT_TOL,
                                   err_msg=path)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_train_step_matches_the_unsharded_port(arch, mesh):
    (plain, pm), (state, m) = _runs(arch, mesh)["plain_state"], \
        _runs(arch, mesh)["state"]
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


@pytest.mark.parametrize("arch,mesh", CASES)
def test_logits_match_the_reference_under_the_mesh(ref, arch, mesh):
    run = _runs(arch, mesh)
    for i, got in enumerate(run["logits"]):
        np.testing.assert_allclose(got.numpy(),
                                   ref[f"{arch}/{mesh}/logits{i}"],
                                   **REF_LOGITS_TOL)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_loss_and_gradients_match_the_reference_under_the_mesh(ref, arch,
                                                               mesh):
    run = _runs(arch, mesh)
    cfg = get_arch(arch).reduced()
    np.testing.assert_allclose(run["loss"].item(),
                               float(ref[f"{arch}/{mesh}/loss"]),
                               rtol=REF_LOSS_RTOL, atol=0)
    want = leaves(_port_grads(cfg, ref, f"{arch}/{mesh}"))
    assert len(want) == len(run["grads"])
    for path, g, w in zip(run["paths"], run["grads"], want):
        w = w.numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=REF_GRAD_SHARE * max(np.abs(w).max(), 1e-30), err_msg=path)


def test_the_sharded_path_is_taken_and_refused_where_it_should_be():
    cfg = get_arch("minicpm-2b").reduced()
    model = TransformerLM(cfg, CPU)
    mesh = make_mesh((2, 2), ("data", "model"), [CPU] * 4)
    assert model.spmd("train", 4) is None          # no mesh current
    with use_mesh_rules(mesh):
        assert model.spmd("train", 4).n == 4
        with pytest.raises(ValueError, match="do not split"):
            model.spmd("train", 3)                 # rows do not split
    with use_mesh_rules(mesh, attn_seq_shard=True):
        # the rows over model: a prefill's and a training loss's; decode,
        # one token a row, keeps the head split
        for kind in ("prefill", "train"):
            sp = model.spmd(kind, 4)
            assert sp.n == 4 and sp.seq_rows and not sp.seq_kv
        assert not model.spmd("decode", 4).seq_rows
    with use_mesh_rules(mesh, seq_shard_kv=True):
        assert not model.spmd("train", 4).seq_kv
        for kind in ("prefill", "decode"):
            sp = model.spmd(kind, 4)
            assert sp.n == 4 and sp.seq_kv and not sp.seq_rows
    wide = TransformerLM(dataclasses.replace(
        cfg, attention=dataclasses.replace(cfg.attention, n_heads=6,
                                           n_kv_heads=6)), CPU)
    with use_mesh_rules(mesh):
        assert wide.spmd("train", 4) is not None
    wide_mesh = make_mesh((1, 4), ("data", "model"), [CPU] * 4)
    with use_mesh_rules(wide_mesh):
        assert wide.spmd("train", 4) is None       # 6 heads on 4
        assert wide.spmd("decode", 4) is None
    with use_mesh_rules(wide_mesh, attn_seq_shard=True, seq_shard_kv=True):
        assert wide.spmd("train", 4).seq_rows
        assert wide.spmd("prefill", 4).seq_rows
    with use_mesh_rules(wide_mesh, seq_shard_kv=True):
        assert wide.spmd("decode", 4).seq_kv
        assert wide.spmd("prefill", 4) is None     # heads, and no rows


def test_the_batcher_serves_a_mesh_with_weights_held_once():
    from repro_torch.configs.base import ServeConfig
    from repro_torch.runtime.serve_loop import ContinuousBatcher, Request
    cfg = get_arch("gemma2-9b").reduced()
    model = TransformerLM(cfg, CPU)
    params = model.init(torch.Generator().manual_seed(0))

    def serve():
        batcher = ContinuousBatcher(model, cfg, ServeConfig(max_batch=4,
                                                            max_seq=64),
                                    params)
        for i in range(6):
            batcher.submit(Request(i, [3 + i, 5, 7 + i, 9], 5))
        return sorted((r.rid, tuple(r.out)) for r in batcher.run()), batcher
    plain, _ = serve()
    with use_mesh_rules(make_mesh((2, 2), ("data", "model"), [CPU] * 4)):
        got, batcher = serve()
    assert got == plain
    assert batcher._held


def test_the_batcher_pads_a_batch_the_data_shards_do_not_split():
    """Three requests on a (2, 2) mesh run as four rows (one filler row)
    through the sharded program, and give the unsharded tokens."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.runtime.serve_loop import ContinuousBatcher, Request
    cfg = get_arch("gemma2-9b").reduced()
    model = TransformerLM(cfg, CPU)
    params = model.init(torch.Generator().manual_seed(0))

    def serve():
        batcher = ContinuousBatcher(model, cfg, ServeConfig(max_batch=3,
                                                            max_seq=64),
                                    params)
        for i in range(3):
            batcher.submit(Request(i, [4 + i, 6, 8 + 2 * i], 4))
        return sorted((r.rid, tuple(r.out)) for r in batcher.run()), batcher
    plain, unpadded = serve()
    with use_mesh_rules(make_mesh((2, 2), ("data", "model"), [CPU] * 4)):
        got, batcher = serve()
    assert got == plain
    assert (unpadded.filler_rows, batcher.filler_rows) == (0, 1)
    assert batcher._held


def test_a_whole_cache_is_split_for_a_sharded_decode_step():
    cfg = get_arch("recurrentgemma-9b").reduced()
    model = TransformerLM(cfg, CPU)
    params = model.init(torch.Generator().manual_seed(1))
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)))
    with torch.no_grad():
        _, cache = model.prefill(params, toks, CACHE)
        pos = torch.full((B, 1), S, dtype=torch.int32)
        want, _ = model.decode_step(params, toks[:, -1:], pos,
                                    [dict(c) for c in cache])
        with use_mesh_rules(make_mesh((2, 4), ("data", "model"), [CPU] * 8)):
            got, held = model.decode_step(params, toks[:, -1:], pos, cache)
    assert isinstance(held, ShardedCache)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **PORT_TOL)


#: reduced configs whose vocabulary, d_ff or RG-LRU width ``model`` does
#: not divide (minicpm-2b's 122,753 ids at 4, as phase 51 runs it): those
#: layers run whole on every position, the rest split
WHOLE_CASES = {
    "vocab": ("minicpm-2b", dict(vocab_size=250), (2, 4)),
    "d_ff": ("minicpm-2b", dict(d_ff=130), (2, 4)),
    "rglru_width": ("recurrentgemma-9b", dict(rglru_width=66), (1, 4)),
}


@pytest.mark.parametrize("case", list(WHOLE_CASES))
def test_layers_the_mesh_does_not_split_run_whole(case):
    arch, over, shape = WHOLE_CASES[case]
    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    model = TransformerLM(cfg, CPU)
    params = model.init(torch.Generator().manual_seed(3))
    for p in leaves(params):
        p.requires_grad_(True)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, S + 1)))
    plain_loss, plain_grads = _loss_and_grads(model, params, toks[:, :-1],
                                              toks[:, 1:], shape[0])
    with torch.no_grad():
        want, _ = model.prefill(params, toks[:, :S], CACHE)
    mesh = make_mesh(shape, ("data", "model"), [CPU] * 8)
    with use_mesh_rules(mesh):
        assert model.spmd("train", 4) is not None
        loss, grads = _loss_and_grads(model, params, toks[:, :-1],
                                      toks[:, 1:])
        with torch.no_grad():
            got, _ = model.prefill(params, toks[:, :S], CACHE)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **PORT_TOL)
    np.testing.assert_allclose(loss.item(), plain_loss.item(), **PORT_TOL)
    for (path, _), g, w in zip(leaves_with_paths(params), grads, plain_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **PORT_TOL,
                                   err_msg=path)
