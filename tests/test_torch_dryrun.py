"""The port's dry run (``launch.dryrun``, ``launch.specs``) on the CPU.

* The reduced dense, MoE, griffin, xLSTM, whisper and VLM models run a
  training step, a prefill and a decode step on ``meta`` and on the CPU
  under the op profiler: the same aten products, traffic, kernel calls
  and kernel work (the ``meta`` entries stand for the plain versions).
* ``model_flops`` in the records is the reference's for every LM arch x
  supported shape.
* ``input_specs`` at a (2, 4) mesh matches the reference's
  ``input_specs`` over 8 CPU devices in keys, shapes, dtypes and specs
  for every LM arch x supported shape (the reference's stacked layers
  taken one a layer, as the port holds them), and the per-device argument
  bytes equal the sum of the reference's ``shard_shape`` bytes.  The
  reference's side runs in one subprocess that sets the device count
  before importing ``jax``.
* An unsupported shape gives the reference's skip record, a failing cell
  ``ok: False``, and the CLI exits 1 on it.
* One full-size cell of each kind runs on ``meta`` in under 30 s.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs.base import (ALL_SHAPES, SHAPES_BY_NAME,  # noqa: E402
                                      MeshConfig, TrainConfig)
from repro_torch.configs.registry import LM_ARCHS, get_arch  # noqa: E402
from repro_torch.device import MetaGenerator  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.op_analysis import OpProfiler  # noqa: E402
from repro_torch.launch.specs import (argument_bytes,  # noqa: E402
                                      input_specs)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import mrope_bands  # noqa: E402
from repro_torch.parallel.sharding import make_mesh  # noqa: E402
from repro_torch.runtime.train_loop import (init_state,  # noqa: E402
                                            make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("minicpm-2b", "olmoe-1b-7b", "recurrentgemma-9b", "xlstm-350m",
            "whisper-tiny", "qwen2-vl-2b")
B, S = 4, 24
CELLS = [(a, s.name) for a in LM_ARCHS for s in ALL_SHAPES
         if get_arch(a).supports(s)]


# ---------------------------------------------------------------------------
# the reduced models on meta and on the CPU
# ---------------------------------------------------------------------------


def _program(arch, kind, device):
    """(program, its inputs) of ``kind`` for the reduced ``arch`` on
    ``device``: seeded CPU parameters, or their ``meta`` shapes."""
    cfg = get_arch(arch).reduced()
    dev = torch.device(device)
    gen = MetaGenerator() if dev.type == "meta" else \
        torch.Generator().manual_seed(0)
    model = build_model(cfg, device=dev)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size, (B, S)),
                           dtype=torch.int32).to(dev)
    extra = {}
    if cfg.family == "vlm":
        extra["patch_embeds"] = torch.as_tensor(rng.normal(
            size=(B, cfg.vision_tokens, cfg.d_model)),
            dtype=torch.float32).to(dev)
    if cfg.family == "audio":
        extra["frames"] = torch.as_tensor(rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)), dtype=torch.float32).to(dev)
    if kind == "train":
        tcfg = TrainConfig(microbatches=2)
        state = init_state(model, gen, tcfg)
        step = make_train_step(model, cfg, tcfg)
        batch = {"tokens": toks, "labels": toks, **extra}
        return (lambda: step(state, batch)[1]), (state, batch)
    params = model.init(gen)
    if kind == "prefill":
        def prefill():
            with torch.no_grad():
                if cfg.family == "audio":
                    return model.prefill(params, toks, extra["frames"],
                                         S + 8)
                kw = {}
                if cfg.family == "vlm":
                    kw["extra_embeds"] = extra["patch_embeds"]
                return model.prefill(params, toks, S + 8, **kw)
        return prefill, (params, toks, extra)
    cache = model.init_cache(B, S + 8)
    pos = torch.full((B, 1), S, dtype=torch.int32, device=dev)

    def decode():
        with torch.no_grad():
            return model.decode_step(params, toks[:, :1], pos, cache)
    return decode, (params, cache, toks, pos)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_counts_equal_the_cpus(arch, kind):
    counts, launches = {}, {}
    for device in ("cpu", "meta"):
        program, inputs = _program(arch, kind, device)
        # M-RoPE's bands are made once a process and device: cold on both
        # sides, whichever qwen2-vl runs came before in this process
        mrope_bands.cache_clear()
        kernels.reset_launch_counts()
        with OpProfiler(None if device == "cpu" else "meta") as prof:
            prof.arguments(inputs)
            program()
        counts[device] = prof.profile.counts()
        launches[device] = kernels.launch_counts()
    assert counts["meta"] == counts["cpu"]
    assert counts["meta"]["dot_flops"] > 0 and counts["meta"]["kernels"]
    # the CPU takes the plain versions and meta launches nothing: the
    # kernel calls are in the profile, and no launch counter moves
    assert not any(launches["cpu"].values())
    assert not any(launches["meta"].values())
    assert all(r["calls"] > 0 for routes in counts["meta"]["kernels"].values()
               for r in routes.values())


def test_model_flops_in_records_are_the_references():
    from repro.configs.registry import get_arch as j_get_arch
    from repro.core.cost_model import model_flops as j_model_flops
    from repro_torch.core.cost_model import model_flops
    for arch, shape in CELLS:
        sh = SHAPES_BY_NAME[shape]
        assert model_flops(get_arch(arch), sh) == \
            j_model_flops(j_get_arch(arch), sh), (arch, shape)
    rec = dryrun.run_cell("gemma2-9b", "long_500k", dryrun.CARD_MESH,
                          verbose=False)
    assert rec["roofline"]["model_flops"] == j_model_flops(
        j_get_arch("gemma2-9b"), SHAPES_BY_NAME["long_500k"])


# ---------------------------------------------------------------------------
# input_specs against the reference's
# ---------------------------------------------------------------------------

SPECS_SCRIPT = textwrap.dedent('''
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from repro.configs.base import ALL_SHAPES, TrainConfig
    from repro.configs.registry import LM_ARCHS, get_arch
    from repro.launch.specs import input_specs
    from repro.models import build_model

    mesh = jax.make_mesh((2, 4), ("data", "model"))

    def spec(e):
        return None if e is None else (list(e) if isinstance(e, tuple)
                                       else e)

    def leaf(x, sh):
        return [list(x.shape), str(x.dtype), [spec(e) for e in sh.spec],
                int(np.prod(sh.shard_shape(x.shape))) * x.dtype.itemsize]

    def walk(x, sh):
        if isinstance(x, dict):
            return {k: walk(v, sh[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v, s) for v, s in zip(x, sh)]
        return leaf(x, sh)

    out = {}
    for arch in LM_ARCHS:
        cfg = get_arch(arch)
        for shape in ALL_SHAPES:
            if not cfg.supports(shape):
                continue
            local_b = max(1, shape.global_batch // 2)
            tcfg = TrainConfig(microbatches=min(8, local_b)
                               if shape.kind == "train" else 1)
            structs, shards = input_specs(cfg, shape, mesh,
                                          build_model(cfg), tcfg)
            out[f"{arch}/{shape.name}"] = walk(structs, shards)

    from repro.launch import dryrun
    out["skip"] = dryrun.lower_cell("minicpm-2b", "long_500k",
                                    dryrun.SINGLE_POD_MESH)[2]
    print(json.dumps(out))
''')


@pytest.fixture(scope="module")
def reference_specs():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", SPECS_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _unstack(tree):
    """A stacked reference subtree without each leaf's layer dimension
    (its spec's leading None; its bytes a layer)."""
    if isinstance(tree, dict):
        return {k: _unstack(v) for k, v in tree.items()}
    shape, dtype, spec, nbytes = tree
    assert spec[0] is None
    return [shape[1:], dtype, spec[1:], nbytes // shape[0]]


def _per_layer(tree):
    """The reference's ``blocks`` (period slots, stacked) and ``rem`` ->
    the port's one tree a layer in layer order; other keys as they are;
    whisper's cache (``{"layers": [{"self": ...}]}``) as the port's."""
    if isinstance(tree, dict) and "blocks" in tree:
        blocks = tree["blocks"]
        n_full = blocks["b0"][next(iter(blocks["b0"]))]
        while isinstance(n_full, dict):
            n_full = n_full[next(iter(n_full))]
        n_full = n_full[0][0]
        slots = [_unstack(blocks[f"b{i}"]) for i in range(len(blocks))]
        layers = [slots[i] for _ in range(n_full)
                  for i in range(len(slots))] + list(tree.get("rem", []))
        rest = {k: v for k, v in tree.items() if k not in ("blocks", "rem")}
        return rest, layers
    return tree, None


def _port_tree(x, sh):
    from repro_torch.parallel.sharding import PartitionSpec
    from repro_torch.launch.specs import shard_bytes
    if isinstance(x, dict):
        return {k: _port_tree(v, sh[k]) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not isinstance(x, PartitionSpec):
        return [_port_tree(v, s) for v, s in zip(x, sh)]
    spec = [list(e) if isinstance(e, tuple) else e for e in sh.spec]
    return [list(x.shape), str(x.dtype).replace("torch.", ""), spec,
            shard_bytes(x, sh)]


def _reference_as_port(tree, kind):
    def params(t):
        rest, layers = _per_layer(t)
        return rest if layers is None else {**rest, "layers": layers}
    if kind == "train":
        st = tree["state"]
        return {"state": {"params": params(st["params"]),
                          "opt": {"m": params(st["opt"]["m"]),
                                  "v": params(st["opt"]["v"]),
                                  "step": st["opt"]["step"]}},
                "batch": tree["batch"]}
    out = dict(tree, params=params(tree["params"]))
    if "cache" in tree:
        cache = tree["cache"]
        if "layers" in cache:            # whisper
            out["cache"] = [{"k": lay["self"]["k"], "v": lay["self"]["v"],
                             "cross_k": lay["cross_k"],
                             "cross_v": lay["cross_v"]}
                            for lay in cache["layers"]]
        else:
            out["cache"] = _per_layer(cache)[1]
    return out


def _leaves(tree):
    """The [shape, dtype, spec, bytes] leaves of a JSON tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif len(tree) == 4 and isinstance(tree[1], str):
        yield tree
    else:
        for v in tree:
            yield from _leaves(v)


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in CELLS])
def test_input_specs_match_the_references(cell, reference_specs):
    arch, shape_name = cell.split("/")
    cfg, shape = get_arch(arch), SHAPES_BY_NAME[shape_name]
    mesh = make_mesh((2, 4), ("data", "model"), [torch.device("meta")] * 8)
    local_b = max(1, shape.global_batch // 2)
    tcfg = TrainConfig(microbatches=min(8, local_b)
                       if shape.kind == "train" else 1)
    inputs, shards = input_specs(cfg, shape, mesh,
                                 build_model(cfg, device="meta"), tcfg)
    got = _port_tree(inputs, shards)
    ref = reference_specs[cell]
    want = _reference_as_port(ref, shape.kind)
    assert got == want
    assert argument_bytes(inputs, shards) == \
        sum(leaf[3] for leaf in _leaves(ref))


# ---------------------------------------------------------------------------
# records, failures, the CLI, full-size cells
# ---------------------------------------------------------------------------


def test_unsupported_shape_gives_the_references_skip_record(reference_specs):
    rec = dryrun.run_cell("minicpm-2b", "long_500k", dryrun.CARD_MESH,
                          verbose=False)
    assert rec["skipped"] is True
    assert rec["reason"] == reference_specs["skip"]["reason"]
    assert "ok" not in rec


def test_a_failing_cell_is_recorded_and_the_cli_exits_1(monkeypatch,
                                                        tmp_path, capsys):
    def broken(*a, **k):
        raise RuntimeError("no such program")
    monkeypatch.setattr(dryrun, "input_specs", broken)
    rec = dryrun.run_cell("gemma2-9b", "decode_32k", dryrun.CARD_MESH,
                          verbose=False)
    assert rec["ok"] is False and "no such program" in rec["error"]
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "gemma2-9b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert exc.value.code == 1
    assert "1 failed of 1 cells" in capsys.readouterr().out
    with open(tmp_path / "gemma2-9b_decode_32k_card.json") as fh:
        assert json.load(fh)["ok"] is False


@pytest.mark.parametrize("arch,shape", [("gemma2-9b", "decode_32k"),
                                        ("olmoe-1b-7b", "prefill_32k"),
                                        ("whisper-tiny", "train_4k")])
def test_full_size_cells_run_on_meta(arch, shape, tmp_path):
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, dryrun.CARD_MESH, str(tmp_path),
                          verbose=False)
    assert time.perf_counter() - t0 < 30
    assert rec["ok"] is True, rec.get("traceback")
    mem, roof = rec["memory"], rec["roofline"]
    assert mem["total_bytes_per_device"] == mem["argument_size_in_bytes"] \
        + mem["output_size_in_bytes"] + mem["temp_size_in_bytes"] \
        - mem["alias_size_in_bytes"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert roof["n_chips"] == 1 and roof["collective_s"] == 0.0
    assert roof["step_s"] == max(roof["compute_s"], roof["memory_s"])
    assert rec["kernels"] and "launches" not in rec
    assert all(r["calls"] > 0 for routes in rec["kernels"].values()
               for r in routes.values())
    with open(tmp_path / f"{arch}_{shape}_card.json") as fh:
        assert json.load(fh)["roofline"] == roof


def _moe_with_12_heads(monkeypatch):
    """granite-moe-1b-a400m given 12 heads (which a model axis of 16 does
    not divide) and 2 layers: a cell whose rules ask for a layout the
    port does not run yet (``attn_seq_shard_moe``, ROADMAP item 25.4; no
    registry cell has one)."""
    import dataclasses
    real = dryrun.get_arch

    def get(name):
        cfg = real(name)
        if name == "granite-moe-1b-a400m":
            cfg = dataclasses.replace(cfg, n_layers=2, attention=(
                dataclasses.replace(cfg.attention, n_heads=12,
                                    n_kv_heads=4)))
        return cfg
    monkeypatch.setattr(dryrun, "get_arch", get)


def test_a_mesh_cell_splits_evenly_with_no_collective_term(monkeypatch):
    """A cell with a layout gap that stays open (a MoE model under
    ``attn_seq_shard``) splits its unsharded program evenly, with no
    collective term; xlstm-350m's decode cell, which waited for item 25.3,
    runs one position's program, its collectives charged, its record
    naming the chain (1 in decode: no hand-off)."""
    _moe_with_12_heads(monkeypatch)
    multi = MeshConfig((2, 16, 16), ("pod", "data", "model"))
    rec = dryrun.run_cell("granite-moe-1b-a400m", "prefill_32k", multi,
                          verbose=False)
    card = dryrun.run_cell("granite-moe-1b-a400m", "prefill_32k",
                           dryrun.CARD_MESH, verbose=False)
    assert rec["split"] == "even" and rec["collective_reason"]
    assert rec["layout_gap"] == "attn_seq_shard_moe"
    assert "25.4" in rec["collective_reason"]
    assert rec["roofline"]["collective_s"] is None
    assert rec["roofline"]["flops_dev"] * 512 == \
        pytest.approx(card["roofline"]["flops_dev"])
    assert rec["memory"]["temp_size_in_bytes"] * 512 == \
        pytest.approx(card["memory"]["temp_size_in_bytes"])
    # the arguments' own blocks (FSDP-only weights under the rows' rules)
    assert rec["memory"]["argument_size_in_bytes"] < \
        card["memory"]["argument_size_in_bytes"]
    xl = dryrun.run_cell("xlstm-350m", "decode_32k", multi, verbose=False)
    assert xl["ok"] is True, xl.get("traceback")
    assert xl["split"] == "position" and "collective_reason" not in xl
    assert xl["roofline"]["collective_s"] > 0 and xl["chain"] == 1
