"""The port's named meshes and sharding rules against the reference, on
the CPU, in-process.

The reference's side runs on ``jax.sharding.AbstractMesh``es, which need
no devices; the port's meshes are entries of the CPU named as often as
the shape needs.  Held exactly:

* ``default_rules`` for the meshes (16, 16) ``data, model``, (2, 16, 16)
  ``pod, data, model`` and (2, 4) ``data, model`` over all 16
  combinations of its four flags;
* ``_spec_for`` for every leaf of every LM config in the registry at its
  full widths (the reference's shapes from ``jax.eval_shape``, stacked
  leaves without their layer dimension), on both production meshes, with
  and without FSDP and model sharding;
* ``param_shardings`` and ``cache_shardings`` on the reduced configs'
  trees (the parameter tree as ``init`` shapes it, carried across by
  ``lm_params_from_arrays``, whose layer mapping the reference's stacked
  period slots are mapped by; each model's zeroed decode cache);
* ``batch_spec``, ``logical_spec`` / ``current_mesh`` under
  ``use_mesh_rules``, and ``sc`` returning its input inside and outside
  a mesh context.

Also the port's own pieces: the ``Mesh`` (shape, row-major positions,
one device repeated), ``launch.mesh``'s constructors (the visible CUDA
devices by default: without a card they raise), the shard runner's
blocks and their reassembly, and the collectives' fixed order.
"""
import dataclasses
import itertools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs.registry import LM_ARCHS  # noqa: E402
from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.parallel import param_sharding as j_ps  # noqa: E402
from repro.parallel import sharding as j_sh  # noqa: E402
from repro_torch.configs.base import MeshConfig  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import (lm_params_from_arrays,  # noqa: E402
                                 whisper_params_from_arrays)
from repro_torch.launch import mesh as t_launch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.parallel import param_sharding as t_ps  # noqa: E402
from repro_torch.parallel import sharding as t_sh  # noqa: E402
from repro_torch.parallel.sharding import P  # noqa: E402

CPU = torch.device("cpu")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "pod": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
REDUCED_MESHES = {"2x4": ((2, 4), ("data", "model")),
                  "pod": ((2, 2, 2), ("pod", "data", "model")),
                  "4x16": ((4, 16), ("data", "model"))}
FLAGS = list(itertools.product([False, True], repeat=4))


def meshes(shape, axes):
    """(reference AbstractMesh, port Mesh of CPU entries) of one shape."""
    n = int(np.prod(shape))
    return (AbstractMesh(shape, axes),
            t_sh.make_mesh(shape, axes, [CPU] * n))


def spec_tree(tree):
    """A tree of shardings (either package's) -> the same nest of dicts
    and lists with each leaf its spec as a plain tuple."""
    if isinstance(tree, dict):
        return {k: spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [spec_tree(v) for v in tree]
    return tuple(tree.spec)


def unstack(tree, spec=True):
    """A stacked reference tree of specs (or shapes) without each leaf's
    leading entry, a None for a spec."""
    if isinstance(tree, dict):
        return {k: unstack(v, spec) for k, v in tree.items()}
    assert tree[0] is None or not spec
    return tree[1:]


def ref_layers(tree, n_full, spec=True):
    """The reference's ``blocks`` (period slots, stacked) and ``rem``
    spec (or shape) trees -> one tree a layer in layer order, as
    ``lm_params_from_arrays`` lays the layers out."""
    blocks = tree["blocks"]
    slots = [unstack(blocks[f"b{i}"], spec) for i in range(len(blocks))]
    return [slots[i] for _ in range(n_full) for i in range(len(slots))] + \
        list(tree.get("rem", []))


# ---------------------------------------------------------------------------
# default_rules, batch_spec, the mesh context
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", FLAGS,
                         ids=["".join("1" if f else "0" for f in fl)
                              for fl in FLAGS])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_default_rules_match_reference(mesh, flags):
    jm, tm = meshes(*MESHES[mesh])
    kw = dict(zip(("seq_shard_kv", "fsdp", "attn_seq_shard",
                   "kv_batch_shard"), flags))
    want = {k: tuple(v) for k, v in j_sh.default_rules(jm, **kw).items()}
    got = t_sh.default_rules(tm, **kw)
    assert {k: tuple(v) for k, v in got.items()} == want
    assert all(isinstance(v, P) for v in got.values())


@pytest.mark.parametrize("shape,axes", [((16, 16), ("data", "model")),
                                        ((2, 16, 16), ("pod", "data",
                                                       "model")),
                                        ((2, 4), ("data", "model")),
                                        ((4,), ("model",)),
                                        ((4,), ("stage",))])
def test_batch_spec_matches_reference(shape, axes):
    jm, tm = meshes(shape, axes)
    assert tuple(t_sh.batch_spec(tm)) == tuple(j_sh.batch_spec(jm))
    assert tuple(t_sh.named_sharding(tm, "data", None).spec) == \
        ("data", None)


def test_mesh_rules_context_is_scoped_and_thread_local():
    jm, tm = meshes((2, 4), ("data", "model"))
    x = torch.ones(4, 3, 8)
    assert t_sh.current_mesh() is None and t_sh.logical_spec("w_df") is None
    assert t_sh.sc(x, "act_btd") is x
    seen = []
    with t_sh.use_mesh_rules(tm, fsdp=False), \
            j_sh.use_mesh_rules(jm, fsdp=False):
        assert t_sh.current_mesh() is tm
        for name in ("act_btd", "w_df", "moe_ecd", "kv_bskd"):
            assert tuple(t_sh.logical_spec(name)) == \
                tuple(j_sh.logical_spec(name))
        assert t_sh.logical_spec("no such name") is None
        assert t_sh.sc(x, "act_btd") is x and t_sh.sc(x, "w_df") is x
        worker = threading.Thread(
            target=lambda: seen.append(t_sh.current_mesh()))
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
        with t_sh.use_mesh_rules(None):
            assert t_sh.current_mesh() is None
        assert t_sh.current_mesh() is tm
        rules = {"act_btd": P("data")}
        with t_sh.use_mesh_rules(tm, rules):
            assert t_sh.logical_spec("act_btd") == P("data")
            assert t_sh.logical_spec("w_df") is None
    assert seen == [None]
    assert t_sh.current_mesh() is None


# ---------------------------------------------------------------------------
# leaf specs at full width, and on the reduced trees
# ---------------------------------------------------------------------------


def _ref_leaves(arch):
    """(names on the path, unstacked shape, stacked?) of every leaf of the
    reference's full-width parameter tree, from ``jax.eval_shape``."""
    jm = j_build_model(j_get_arch(arch))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = j_ps._path_names(path)
        stacked = "blocks" in names
        out.append((names, tuple(leaf.shape[1:] if stacked else leaf.shape)))
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_spec_for_every_leaf_at_full_width(arch):
    leaves = _ref_leaves(arch)
    assert leaves
    for mesh in ("16x16", "pod"):
        jm, tm = meshes(*MESHES[mesh])
        for fsdp, model_shard in itertools.product([True, False], repeat=2):
            for names, shape in leaves:
                name = names[-1] if names else ""
                moe = "moe" in names
                want = j_ps._spec_for(name, shape, jm, fsdp, moe,
                                      model_shard)
                got = t_ps._spec_for(name, shape, tm, fsdp, moe,
                                     model_shard)
                assert got == want, (arch, mesh, names, shape)


def _reduced_pair(arch):
    """(reference model, its parameter tree as numpy zeros of the
    shapes ``init`` gives, port model, the same tree carried across) for
    the reduced ``arch``: the rules read names and shapes only."""
    tcfg, jcfg = get_arch(arch).reduced(), j_get_arch(arch).reduced()
    jm = j_build_model(jcfg)
    arrays = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                          jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    conv = whisper_params_from_arrays if tcfg.family == "audio" \
        else lm_params_from_arrays
    return jm, arrays, build_model(tcfg, device="cpu"), \
        conv(tcfg, arrays, "cpu")


def _ref_cache_layers(tree, n_full, spec=True):
    if "layers" in tree:              # whisper: {"self": {k, v}, cross_*}
        return [{"k": lay["self"]["k"], "v": lay["self"]["v"],
                 "cross_k": lay["cross_k"], "cross_v": lay["cross_v"]}
                for lay in tree["layers"]]
    return ref_layers(tree, n_full, spec)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_and_cache_shardings_on_reduced_trees(arch):
    jmodel, arrays, tmodel, tparams = _reduced_pair(arch)
    audio = "blocks" not in arrays
    n_full = 0 if audio else \
        len(np.asarray(arrays["blocks"]["b0"]["ln1"]["scale"]))
    jcache = jmodel.init_cache(4, 16)
    tcache = tmodel.init_cache(4, 16)
    for mesh in REDUCED_MESHES:
        jm, tm = meshes(*REDUCED_MESHES[mesh])
        for fsdp, model_shard in itertools.product([True, False], repeat=2):
            want = spec_tree(j_ps.param_shardings(jm, arrays, fsdp,
                                                  model_shard))
            if not audio:
                want = {**{k: v for k, v in want.items()
                           if k not in ("blocks", "rem")},
                        "layers": ref_layers(want, n_full)}
            got = spec_tree(t_ps.param_shardings(tm, tparams, fsdp,
                                                 model_shard))
            assert got == want, (mesh, fsdp, model_shard)
        for seq_shard in (False, True):
            want = _ref_cache_layers(spec_tree(j_ps.cache_shardings(
                jm, jcache, seq_shard)), n_full)
            got = spec_tree(t_ps.cache_shardings(tm, tcache, seq_shard))
            assert got == want, (mesh, seq_shard)
    # the caches the rules read have the reference's shapes, layer for
    # layer
    jshapes = _ref_cache_layers(_shapes(jcache), n_full, spec=False)
    assert [{k: tuple(t.shape) for k, t in lay.items()}
            for lay in tcache] == jshapes


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_rules_read_shapes_only():
    """A tree of ``meta`` tensors gets the specs of the same tree on the
    CPU: the rules read names, shapes and ranks."""
    _, _, _, tparams = _reduced_pair("olmoe-1b-7b")
    _, tm = meshes((2, 4), ("data", "model"))
    meta = t_sh_tree_to(tparams, "meta")
    assert spec_tree(t_ps.param_shardings(tm, meta)) == \
        spec_tree(t_ps.param_shardings(tm, tparams))


def t_sh_tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: t_sh_tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [t_sh_tree_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# the port's meshes, shard runner and collectives
# ---------------------------------------------------------------------------


def test_mesh_shape_positions_and_repeated_device():
    m = t_sh.make_mesh((2, 4), ("data", "model"), [CPU] * 8)
    assert list(m.shape.items()) == [("data", 2), ("model", 4)]
    assert m.devices.size == 8 and m.axis_names == ("data", "model")
    assert m.positions() == [(i, j) for i in range(2) for j in range(4)]
    assert m.index((1, 3)) == {"data": 1, "model": 3}
    assert all(d == CPU for d in m.devices.flat)
    assert m == t_sh.Mesh(np.array([[CPU] * 4] * 2, dtype=object),
                          ("data", "model"))
    assert m != t_sh.make_mesh((4, 2), ("data", "model"), [CPU] * 8)
    assert t_sh.mesh_signature(m) == ("mesh", ("data", "model"), (2, 4),
                                      "cpu", (-1,) * 8)
    # the fleet mesh keeps its signature
    assert t_sh.mesh_signature(t_sh.fleet_mesh([CPU] * 3)) == \
        ("mesh", "traj", 3, "cpu", (-1, -1, -1))
    with pytest.raises(ValueError, match="3 device"):
        t_sh.make_mesh((2, 2), ("data", "model"), [CPU] * 3)
    with pytest.raises(ValueError):
        t_sh.Mesh(np.array([CPU] * 4, dtype=object), ("data", "model"))
    with pytest.raises(ValueError, match="unsupported"):
        t_sh.make_mesh((1,), ("data",), [torch.device("mps")])
    # the dry run lays its meshes over meta entries
    assert dict(t_sh.make_mesh((2, 2), ("data", "model"),
                               [torch.device("meta")] * 4).shape) == \
        {"data": 2, "model": 2}


def test_launch_meshes_take_explicit_devices():
    prod = t_launch.make_production_mesh(devices=[CPU] * 256)
    assert dict(prod.shape) == {"data": 16, "model": 16}
    pod = t_launch.make_production_mesh(multi_pod=True, devices=[CPU] * 512)
    assert dict(pod.shape) == {"pod": 2, "data": 16, "model": 16}
    cfg = t_launch.mesh_from_config(MeshConfig((2, 4), ("data", "model")),
                                    devices=[CPU] * 8)
    assert dict(cfg.shape) == {"data": 2, "model": 4}
    host = t_launch.make_host_mesh(n_model=2, devices=[CPU] * 6)
    assert dict(host.shape) == {"data": 3, "model": 2}
    assert dict(t_launch.make_host_mesh(devices=[CPU]).shape) == \
        {"data": 1, "model": 1}


def test_launch_meshes_default_to_the_card(monkeypatch):
    """With no devices named a mesh is the visible CUDA devices: without
    a card every constructor raises, none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (t_launch.make_production_mesh,
                 lambda: t_launch.mesh_from_config(MeshConfig()),
                 t_launch.make_host_mesh,
                 lambda: t_sh.make_mesh((2,), ("data",))):
        with pytest.raises(ValueError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sh.Mesh(np.array([torch.device("cuda", 0)], dtype=object),
                  ("data",))


SPECS = [P("data", None, "model"), P(("data", "model")), P(None, None, None),
         P("model", "data"), P(), P(None, "data"), P(None, ("model", "data"))]


@pytest.mark.parametrize("spec", SPECS, ids=[str(tuple(s)) for s in SPECS])
def test_shard_blocks_reassemble(spec):
    m = t_sh.make_mesh((2, 4), ("data", "model"), [CPU] * 8)
    x = torch.arange(8 * 8 * 4, dtype=torch.float32).reshape(8, 8, 4)
    blocks = np.empty(m.devices.shape, dtype=object)
    for pos in m.positions():
        blocks[pos] = t_sh.shard_of(x, m, spec, pos)
        assert blocks[pos].is_contiguous()
    assert torch.equal(t_sh.assemble(blocks, m, spec), x)
    # a dimension split over (a1, a2) is cut row-major, a1 outermost
    if tuple(spec) == (("data", "model"),):
        assert torch.equal(blocks[1, 2], x[6:7])


def test_shard_map_compat_blocks_index_and_specs():
    m = t_sh.make_mesh((2, 4), ("data", "model"), [CPU] * 8)
    x = torch.arange(4 * 8, dtype=torch.float32).reshape(4, 8)
    calls = []

    def f(index, xs):
        calls.append(dict(index))
        return xs + 100 * index["model"], xs.sum()

    y, s = t_sh.shard_map_compat(f, m, [P("data", "model")],
                                 (P("data", "model"), P()))(x)
    assert calls == [m.index(p) for p in m.positions()]
    want = x + 100 * torch.arange(4).repeat_interleave(2)[None, :]
    assert torch.equal(y, want)
    assert float(s) == float(x[:2, :2].sum())
    raw = t_sh.shard_map_compat(f, m, [P("data", "model")], None)(x)
    assert raw.shape == (2, 4) and torch.equal(raw[1, 3][0], x[2:, 6:] + 300)
    with pytest.raises(ValueError, match="split"):
        t_sh.shard_map_compat(f, m, [P("model", None)], None)(x[:3])
    with pytest.raises(ValueError, match="mesh of cpu"):
        t_sh.shard_map_compat(f, m, [P()], None)(x.to("meta"))


def test_collectives_in_fixed_order():
    rng = np.random.default_rng(0)
    vals = [torch.as_tensor(rng.normal(size=(5,)).astype(np.float32) * 1e4
                            ** i) for i in range(4)]
    total = vals[0]
    for v in vals[1:]:
        total = total + v
    got = t_sh.psum(vals)
    assert len(got) == 4 and all(torch.equal(g, total) for g in got)
    assert all(torch.equal(g, torch.stack(vals).max(0).values)
               for g in t_sh.pmax(vals))
    assert all(torch.equal(g, total / 4) for g in t_sh.pmean(vals))
    ring = t_sh.ppermute(vals, [(i, (i + 1) % 4) for i in range(4)])
    assert all(torch.equal(ring[(i + 1) % 4], vals[i]) for i in range(4))
    part = t_sh.ppermute(vals, [(0, 1)])
    assert torch.equal(part[1], vals[0]) and not part[0].any()


def test_collective_over_one_axis_of_a_mesh():
    m = t_sh.make_mesh((2, 3), ("data", "model"), [CPU] * 6)
    assert t_sh.groups_along(m, "model") == [[(0, 0), (0, 1), (0, 2)],
                                             [(1, 0), (1, 1), (1, 2)]]
    assert t_sh.groups_along(m, "data") == [[(0, j), (1, j)]
                                            for j in range(3)]
    blocks = np.empty((2, 3), dtype=object)
    for i, j in m.positions():
        blocks[i, j] = torch.tensor([10.0 * i + j])
    over_model = t_sh.collective(blocks, m, "model", t_sh.psum)
    assert [float(over_model[i, j]) for i, j in m.positions()] == \
        [3.0] * 3 + [33.0] * 3
    over_all = t_sh.collective(blocks, m, m.axis_names, t_sh.pmean)
    assert {float(v) for v in over_all.flat} == {36.0 / 6}


def test_named_sharding_is_a_frozen_record():
    _, tm = meshes((2, 4), ("data", "model"))
    ns = t_sh.NamedSharding(tm, P("data", None))
    assert ns == t_sh.named_sharding(tm, "data", None)
    with pytest.raises(dataclasses.FrozenInstanceError):
        ns.spec = P()
    assert hash(ns) == hash(t_sh.named_sharding(tm, "data", None))
