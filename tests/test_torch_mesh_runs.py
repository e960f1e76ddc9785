"""The port's sharded runs against the reference's on a forced 8-device
CPU mesh, on the CPU.

The reference's side runs once, in a subprocess (``XLA_FLAGS`` must name
the device count before jax starts; this process keeps its one device),
and writes its inputs and results into one ``.npz``.  The port runs the
same inputs over meshes of CPU entries.  Held:

* ``pipelined_forward`` on ``tests/test_pipeline.py``'s blocks (7
  blocks of tanh(x W + b), d 16, B 8) at its boundaries ``[0,2,3,5,7]``
  with 4 microbatches and ``[0,2,4,6,7]`` with 2, within the reference
  test's 1e-5, and bitwise equal to the same blocks run microbatch by
  microbatch with no pipeline; a stage with no block passes its input
  on; a batch the microbatches do not divide is refused;
* ``psum_compressed`` under ``shard_map`` over an axis of 4, two steps
  of error feedback, a stacked leaf scaled as one (``groups``): each
  shard's int8 payload and the int32 payload sums exact, the
  dequantised sum and the new errors within 1e-6;
* ``moe_apply_expert_parallel`` at (data 1, model 4) and (data 2,
  model 2), GLU and not, at capacity factor 0.5 (picks are dropped):
  ``y`` and the aux loss within atol / rtol 1e-5 in float32, and the
  gradients of a seeded projection of ``y`` and of the aux loss with
  respect to x, the router and the experts against ``jax.grad`` of the
  reference;
* the reduced olmoe (capacity factor 1.0, so picks are dropped) under
  ``use_mesh_rules`` of a (data 2, model 2) mesh: prefill and 2 decode
  steps' logits within 1e-4 of the reference's.

The reference runs each of these under ``jax.jit``: eagerly, its
``shard_map``s run op by op, and the expert-parallel cases alone take
minutes on a CPU (under ``jax.jit``, seconds).  Its meshes have ``Auto``
axes, which its sharding constraints need.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models.moe import (capacity, moe_apply,  # noqa: E402
                                    moe_apply_expert_parallel)
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.optim.grad_compress import (compress_tree,  # noqa: E402
                                             psum_compressed)
from repro_torch.parallel.pipeline import (pipelined_forward,  # noqa: E402
                                           stage_params)
from repro_torch.parallel.sharding import make_mesh, use_mesh_rules  # noqa
from repro_torch.tree import leaves  # noqa: E402

CPU = torch.device("cpu")
PIPE_CASES = {"llhr": ([0, 2, 3, 5, 7], 4), "uniform": ([0, 2, 4, 6, 7], 2)}
#: (mesh shape, glu, act) of the expert-parallel cases
MOE_CASES = {"d1m4": ((1, 4), True, "silu"), "d2m2": ((2, 2), True, "silu"),
             "d2m2_noglu": ((2, 2), False, "gelu")}
MOE_DIMS = dict(b=4, s=6, d=16, e=8, f=12, k=2, cf=0.5)
COMPRESS_SHARDS = 4
LM_MESH, LM_CF, LM_STEPS = (2, 2), 1.0, 2

SCRIPT = textwrap.dedent('''
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.parallel.pipeline import pipelined_forward, stage_params
    from repro.parallel.sharding import shard_map_compat, use_mesh_rules
    from repro.optim.grad_compress import compress_tree, psum_compressed
    from repro.models.moe import moe_apply_expert_parallel
    from repro.configs.registry import get_arch
    from repro.models.transformer import TransformerLM

    PIPE_CASES, MOE_CASES, MOE_DIMS = {pipe}, {moe}, {dims}
    # the reference's sharding constraints and shard_maps take Auto axes
    mesh_of = lambda shape, axes: jax.make_mesh(
        shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    SHARDS, LM_MESH, LM_CF, LM_STEPS = {shards}, {lm_mesh}, {lm_cf}, {steps}
    out = {{}}

    # --- pipeline: tests/test_pipeline.py's blocks, numpy-seeded
    rng = np.random.default_rng(0)
    blocks = [{{"w": (rng.normal(size=(16, 16)) * 0.3).astype(np.float32),
               "b": (rng.normal(size=(16,)) * 0.1).astype(np.float32)}}
              for _ in range(7)]
    x = rng.normal(size=(8, 16)).astype(np.float32)
    for i, bl in enumerate(blocks):
        out[f"pipe_w{{i}}"], out[f"pipe_b{{i}}"] = bl["w"], bl["b"]
    out["pipe_x"] = x
    jblocks = jax.tree.map(jnp.asarray, blocks)
    mesh = mesh_of((4,), ("stage",))
    fn = lambda p, h: jnp.tanh(h @ p["w"] + p["b"])
    for name, (bounds, n_micro) in PIPE_CASES.items():
        y = pipelined_forward(fn, stage_params(jblocks, bounds),
                              jnp.asarray(x), mesh, n_micro=n_micro)
        out[f"pipe_{{name}}"] = np.asarray(y)

    # --- psum_compressed over an axis of SHARDS, two steps
    shapes = {{"a": (3, 5, 6), "b": (7,), "c": (4, 4)}}
    mesh = mesh_of((SHARDS,), ("data",))

    def step(g, e):
        g = jax.tree.map(lambda t: t[0], g)
        e = jax.tree.map(lambda t: t[0], e)
        deq, new_e = psum_compressed(g, e, "data")
        qs, _, _ = compress_tree(g, e)
        summed = jax.tree.map(
            lambda q: jax.lax.psum(q.astype(jnp.int32), "data"), qs)
        return jax.tree.map(lambda t: t[None], (deq, new_e, summed, qs))

    run = jax.jit(shard_map_compat(step, mesh, (P("data"), P("data")),
                                   P("data")))
    err = {{k: np.zeros((SHARDS,) + s, np.float32) for k, s in shapes.items()}}
    for st in range(2):
        g = {{k: (rng.normal(size=(SHARDS,) + s) * (1 + 3 * st)).astype(
            np.float32) for k, s in shapes.items()}}
        for k in shapes:
            out[f"gc{{st}}_g_{{k}}"], out[f"gc{{st}}_e_{{k}}"] = g[k], err[k]
        deq, new_e, summed, qs = run(jax.tree.map(jnp.asarray, g),
                                     jax.tree.map(jnp.asarray, err))
        for k in shapes:
            out[f"gc{{st}}_deq_{{k}}"] = np.asarray(deq[k])
            out[f"gc{{st}}_newe_{{k}}"] = np.asarray(new_e[k])
            out[f"gc{{st}}_sum_{{k}}"] = np.asarray(summed[k])
            out[f"gc{{st}}_q_{{k}}"] = np.asarray(qs[k])
        err = {{k: np.asarray(v) for k, v in new_e.items()}}

    # --- expert-parallel MoE, outputs and gradients
    d, e, f, k = MOE_DIMS["d"], MOE_DIMS["e"], MOE_DIMS["f"], MOE_DIMS["k"]
    for name, (shape, glu, act) in MOE_CASES.items():
        p = {{"router": rng.normal(size=(d, e)) * 0.5,
             "w_in": rng.normal(size=(e, d, f)) / 4,
             "w_out": rng.normal(size=(e, f, d)) / 3.5}}
        if glu:
            p["w_gate"] = rng.normal(size=(e, d, f)) / 4
        p = {{n: v.astype(np.float32) for n, v in p.items()}}
        x = rng.normal(size=(MOE_DIMS["b"], MOE_DIMS["s"], d)).astype(
            np.float32)
        ct = rng.normal(size=x.shape).astype(np.float32)
        for n, v in p.items():
            out[f"moe_{{name}}_p_{{n}}"] = v
        out[f"moe_{{name}}_x"], out[f"moe_{{name}}_ct"] = x, ct
        mesh = mesh_of(shape, ("data", "model"))

        def fwd(p, x):
            return moe_apply_expert_parallel(
                p, x, top_k=k, act=act, glu=glu, mesh=mesh,
                capacity_factor=MOE_DIMS["cf"])

        jp, jx = jax.tree.map(jnp.asarray, p), jnp.asarray(x)
        y, aux = jax.jit(fwd)(jp, jx)
        out[f"moe_{{name}}_y"], out[f"moe_{{name}}_aux"] = (
            np.asarray(y), np.asarray(aux))
        for what, loss in (
                ("y", lambda p, x: jnp.sum(fwd(p, x)[0] * ct)),
                ("aux", lambda p, x: fwd(p, x)[1])):
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jx)
            out[f"moe_{{name}}_d{{what}}_x"] = np.asarray(gx)
            for n, v in gp.items():
                out[f"moe_{{name}}_d{{what}}_{{n}}"] = np.asarray(v)

    # --- the reduced olmoe under a mesh: prefill and decode logits
    cfg = get_arch("olmoe-1b-7b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=LM_CF))
    model = TransformerLM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["lm_p" + jax.tree_util.keystr(path)] = np.asarray(leaf)
    toks = rng.integers(0, cfg.vocab_size, size=(4, 12)).astype(np.int32)
    out["lm_toks"] = toks
    mesh = mesh_of(LM_MESH, ("data", "model"))
    with use_mesh_rules(mesh):
        prefill = jax.jit(model.prefill, static_argnums=2)
        decode = jax.jit(model.decode_step)
        logits, cache = prefill(params, jnp.asarray(toks), 16)
        out["lm_logits0"] = np.asarray(logits)
        for i in range(LM_STEPS):
            nxt = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
            pos = np.full((4, 1), 12 + i, np.int32)
            logits, cache = decode(params, jnp.asarray(nxt[:, None]),
                                   jnp.asarray(pos), cache)
            out[f"lm_logits{{i + 1}}"] = np.asarray(logits)
    np.savez(sys.argv[1], **out)
    print("MESH_RUNS_OK")
''').format(pipe=repr(PIPE_CASES), moe=repr(MOE_CASES),
            dims=repr(MOE_DIMS), shards=COMPRESS_SHARDS,
            lm_mesh=repr(LM_MESH), lm_cf=LM_CF, steps=LM_STEPS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_runs") / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", SCRIPT, path], env=env,
                         capture_output=True, text=True, timeout=600)
    assert "MESH_RUNS_OK" in out.stdout, out.stdout + out.stderr
    with np.load(path) as z:
        return dict(z)


def t(x):
    return torch.as_tensor(np.asarray(x))


def cpus(shape, axes):
    return make_mesh(shape, axes, [CPU] * int(np.prod(shape)))


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


def _block(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _pipe_blocks(ref):
    return [{"w": t(ref[f"pipe_w{i}"]), "b": t(ref[f"pipe_b{i}"])}
            for i in range(7)]


def _unpipelined(blocks, x, n_micro):
    outs = []
    for m in x.chunk(n_micro):
        for p in blocks:
            m = _block(p, m)
        outs.append(m)
    return torch.cat(outs)


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_pipelined_forward_matches_reference(ref, case):
    bounds, n_micro = PIPE_CASES[case]
    blocks, x = _pipe_blocks(ref), t(ref["pipe_x"])
    seen = []

    def block_fn(p, h):
        seen.append((id(p["w"]), h.shape[0]))
        return _block(p, h)

    y = pipelined_forward(block_fn, stage_params(blocks, bounds), x,
                          cpus((4,), ("stage",)), n_micro=n_micro)
    np.testing.assert_allclose(y.numpy(), ref[f"pipe_{case}"], atol=1e-5,
                               rtol=0)
    assert torch.equal(y, _unpipelined(blocks, x, n_micro))
    # every block ran once a microbatch, on microbatch rows only
    assert sorted(seen) == sorted((id(p["w"]), 8 // n_micro)
                                  for p in blocks for _ in range(n_micro))


def test_pipeline_schedule_and_refusals():
    """Stage s runs microbatch t - s at tick t; a stage with no block
    hands its input on; a batch that the microbatches do not divide and
    a stage count other than the mesh axis's are refused."""
    blocks = [{"w": torch.eye(3) * (i + 2), "b": torch.zeros(3)}
              for i in range(3)]
    order = []

    def block_fn(p, h):
        blk = int(p["w"][0, 0]) - 2
        # block b's input is (micro + 1) times the blocks before it
        order.append((blk, int(h[0, 0]) // (1, 2, 6)[blk] - 1))
        return h @ p["w"]

    x = torch.arange(4, dtype=torch.float32)[:, None].expand(4, 3) + 1
    per_stage = stage_params(blocks, [0, 1, 1, 3])
    assert [len(s) for s in per_stage] == [1, 0, 2]
    y = pipelined_forward(block_fn, per_stage, x, cpus((3,), ("stage",)),
                          n_micro=4)
    assert torch.equal(y, x * 24)
    # (block, microbatch) by tick, stage 0 first within a tick; stage 1
    # (no block) hands micro t - 1 on at tick t
    assert order == [(0, 0), (0, 1), (0, 2), (1, 0), (2, 0), (0, 3), (1, 1),
                     (2, 1), (1, 2), (2, 2), (1, 3), (2, 3)]
    with pytest.raises(ValueError, match="microbatches"):
        pipelined_forward(block_fn, per_stage, x, cpus((3,), ("stage",)),
                          n_micro=3)
    with pytest.raises(ValueError, match="stages"):
        pipelined_forward(block_fn, per_stage, x, cpus((4,), ("stage",)))
    with pytest.raises(ValueError, match="mesh of cpu"):
        pipelined_forward(block_fn, per_stage, x.to("meta"),
                          cpus((3,), ("stage",)), n_micro=4)


# ---------------------------------------------------------------------------
# int8 all-reduce
# ---------------------------------------------------------------------------


def _shard_tree(ref, key, i):
    """Shard i's tree in the port's layout: the stacked ``a`` as a list of
    its 3 layers."""
    return {"a": [t(ref[f"{key}_a"][i][j]) for j in range(3)],
            "b": t(ref[f"{key}_b"][i]), "c": t(ref[f"{key}_c"][i])}


GROUPS = [[0, 1, 2], [3], [4]]


def test_psum_compressed_matches_reference(ref):
    n = COMPRESS_SHARDS
    errs = [_shard_tree(ref, "gc0_e", i) for i in range(n)]
    for st in range(2):
        grads = [_shard_tree(ref, f"gc{st}_g", i) for i in range(n)]
        if st == 0:
            for i in range(n):
                assert all(not e.any() for e in leaves(errs[i]))
        deq, new_e = psum_compressed(grads, errs, GROUPS)
        for i in range(n):
            qs = leaves(compress_tree(grads[i], errs[i], GROUPS)[0])
            want_q = leaves(_shard_tree(ref, f"gc{st}_q", i))
            assert all(torch.equal(a.to(torch.int32), b.to(torch.int32))
                       for a, b in zip(qs, want_q))
            for got, want in ((deq[i], _shard_tree(ref, f"gc{st}_deq", i)),
                              (new_e[i],
                               _shard_tree(ref, f"gc{st}_newe", i))):
                for a, b in zip(leaves(got), leaves(want)):
                    np.testing.assert_allclose(a.numpy(), b.numpy(),
                                               atol=1e-6, rtol=1e-6)
        summed = [sum(leaves(compress_tree(g, e, GROUPS)[0])[j].to(
            torch.int32) for g, e in zip(grads, errs)) for j in range(5)]
        want_sum = leaves(_shard_tree(ref, f"gc{st}_sum", 0))
        assert all(torch.equal(a, b.to(torch.int32))
                   for a, b in zip(summed, want_sum))
        # every shard holds the same sum
        assert all(torch.equal(a, b) for i in range(1, n)
                   for a, b in zip(leaves(deq[0]), leaves(deq[i])))
        errs = new_e


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------


MOE_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_expert_parallel_matches_reference(ref, case):
    shape, glu, act = MOE_CASES[case]
    dims = MOE_DIMS
    names = ["router", "w_in", "w_out"] + (["w_gate"] if glu else [])
    p = {n: t(ref[f"moe_{case}_p_{n}"]).requires_grad_() for n in names}
    x = t(ref[f"moe_{case}_x"]).requires_grad_()
    mesh = cpus(shape, ("data", "model"))

    def fwd():
        return moe_apply_expert_parallel(p, x, top_k=dims["k"], act=act,
                                         glu=glu, mesh=mesh,
                                         capacity_factor=dims["cf"])

    y, aux = fwd()
    np.testing.assert_allclose(y.detach().numpy(), ref[f"moe_{case}_y"],
                               **MOE_TOL)
    np.testing.assert_allclose(aux.item(), float(ref[f"moe_{case}_aux"]),
                               **MOE_TOL)
    ct = t(ref[f"moe_{case}_ct"])
    for what, loss in (("y", lambda: (fwd()[0] * ct).sum()),
                       ("aux", lambda: fwd()[1])):
        wrt = [x] + [p[n] for n in names]
        grads = torch.autograd.grad(loss(), wrt, allow_unused=True)
        for n, g, a in zip(["x"] + names, grads, wrt):
            g = torch.zeros_like(a) if g is None else g  # aux: the router's
            np.testing.assert_allclose(g.numpy(),
                                       ref[f"moe_{case}_d{what}_{n}"],
                                       **MOE_TOL, err_msg=f"d{what}/d{n}")
    # the capacity binds: the data shard's T = B_loc S tokens at cf 0.5
    # keep fewer picks than moe_apply's per-sequence slots would
    b_loc = dims["b"] // shape[0]
    assert capacity(b_loc * dims["s"], dims["k"], dims["e"], dims["cf"]) * \
        dims["e"] < b_loc * dims["s"] * dims["k"]
    with torch.no_grad():
        y_plain, _ = moe_apply(p, x, top_k=dims["k"], act=act, glu=glu,
                               capacity_factor=dims["cf"])
    assert not torch.allclose(y_plain, y, **MOE_TOL)


def test_moe_expert_parallel_launches_the_expert_gemm_per_shard(ref,
                                                                monkeypatch):
    """Each mesh position launches the grouped GEMM three times over its
    [E / |model|, cap, d] buffer (counted here through the CPU entry)."""
    from repro_torch.kernels.moe_matmul import ops as mops
    shapes = []
    plain = mops._BY_DEVICE["cpu"]
    monkeypatch.setitem(mops._BY_DEVICE, "cpu",
                        lambda a, w: shapes.append(tuple(a.shape)) or
                        plain(a, w))
    case = "d2m2"
    p = {n: t(ref[f"moe_{case}_p_{n}"])
         for n in ("router", "w_in", "w_out", "w_gate")}
    moe_apply_expert_parallel(p, t(ref[f"moe_{case}_x"]), top_k=2,
                              act="silu", glu=True,
                              mesh=cpus((2, 2), ("data", "model")),
                              capacity_factor=MOE_DIMS["cf"])
    cap = capacity(2 * MOE_DIMS["s"], 2, MOE_DIMS["e"], MOE_DIMS["cf"])
    assert shapes == [(4, cap, 16), (4, cap, 16), (4, cap, 12)] * 4


# ---------------------------------------------------------------------------
# the reduced olmoe under a mesh
# ---------------------------------------------------------------------------


def _lm_arrays(ref):
    """The reference's parameter tree back from its flattened keys."""
    tree = {}
    for key, v in ref.items():
        if not key.startswith("lm_p["):
            continue
        parts = [p.strip("'") for p in key[len("lm_p["):-1].split("][")]
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def test_reduced_olmoe_prefill_under_mesh_matches_reference(ref):
    cfg = get_arch("olmoe-1b-7b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=LM_CF))
    model = TransformerLM(cfg, device="cpu")
    params = lm_params_from_arrays(cfg, _lm_arrays(ref), "cpu")
    toks = t(ref["lm_toks"])
    mesh = cpus(LM_MESH, ("data", "model"))
    kernels.reset_launch_counts()
    with use_mesh_rules(mesh):
        logits, cache = model.prefill(params, toks, 16)
        got = [logits]
        for i in range(LM_STEPS):
            nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
            pos = torch.full((4, 1), 12 + i, dtype=torch.int32)
            logits, cache = model.decode_step(params, nxt, pos, cache)
            got.append(logits)
    assert kernels.launch_counts()["moe_matmul"] == 0    # the CPU path
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), ref[f"lm_logits{i}"],
                                   atol=1e-4, rtol=1e-4)
    # without the mesh the per-sequence capacity drops other picks
    plain, _ = model.prefill(params, toks, 16)
    assert not torch.allclose(plain, got[0], atol=1e-4, rtol=1e-4)
