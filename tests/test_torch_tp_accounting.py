"""The sharded program's collectives, held exactly, and the dry run on
the reference's meshes (``launch.dryrun``'s one-position split).

* The reduced minicpm-2b (remat full) at (data 2, model 2): one
  training loss and its backward charge per position exactly the bytes
  and counts by kind that ``closed_form`` writes out from the rules:
  each weight all-gathered over ``data`` at each use in the forward and
  again in the recompute, its gradient reduce-scattered once; the
  vocab-parallel embedding's, the attention's and the MLP's ``psum``
  over ``model`` in the forward and the recompute, identities in the
  backward; the ``pbroadcast``s where a replicated activation enters a
  head-, column- or vocab-parallel product, and the norm scales' over
  ``data``, all-reduced in the backward; the cross-entropy's ``pmax``,
  two ``psum``s and the loss's ``pmean``.  The CPU run of all four
  positions charges four times that; the one-position program on a mesh
  of ``meta`` entries charges it once, with the same kernel calls and
  dot FLOPs a position.
* The dry run of gemma2-9b ``train_4k`` and olmoe-1b-7b ``prefill_32k``
  and ``decode_32k`` at (16, 16) and (2, 16, 16): ``"split":
  "position"``, a collective term, per-device dot FLOPs times the
  devices equal to the unsharded program's plus the work a position
  repeats (the K/V projections of KV heads held on two positions, the
  MoE router on every ``model`` position), the argument bytes the specs'
  exact figures; the multi-pod train cell's gradient reduction crosses
  pods; whisper-tiny and xlstm-350m keep the even split with a reason
  naming their family's layout; gemma2-9b ``prefill_32k``
  (``seq_shard_kv``) and minicpm-2b ``train_4k`` (``attn_seq_shard``)
  run one position, the last along ``model``, with a collective term.
* Under the sequence layouts (the 6-head minicpm-2b at (1, 4) and
  (2, 4): training and prefill by rows, prefill and decode with the
  cache by slots) the positions differ, so the one position the dry run
  reports is held to its own share: all positions' dot FLOPs, kernel
  calls and collectives less the other positions' own programs are
  exactly the last position's program's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import (MULTI_POD_MESH,  # noqa: E402
                                      SHAPES_BY_NAME, SINGLE_POD_MESH)
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.device import MetaGenerator  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.op_analysis import OpProfiler  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.parallel.sharding import make_mesh, use_mesh_rules  # noqa
from repro_torch.tree import leaves  # noqa: E402

MESH, B, S = (2, 2), 4, 12
F32 = 4
#: argument bytes a device of each dry-run cell, the specs' exact figures
#: (``launch.specs.argument_bytes``, as the unsharded cells have them)
ARGUMENT_BYTES = {
    ("gemma2-9b", "train_4k", "single"): 874489860,
    ("gemma2-9b", "train_4k", "multi"): 874227716,
    ("olmoe-1b-7b", "prefill_32k", "single"): 1619083264,
    ("olmoe-1b-7b", "prefill_32k", "multi"): 1618952192,
    ("olmoe-1b-7b", "decode_32k", "single"): 3766304832,
    ("olmoe-1b-7b", "decode_32k", "multi"): 2692562976,
}
MESHES = {"single": SINGLE_POD_MESH, "multi": MULTI_POD_MESH}


def _cfg():
    return dataclasses.replace(get_arch("minicpm-2b").reduced(),
                               remat="full")


def closed_form(cfg, mesh=MESH, b_global=B, s=S):
    """Per-position collective bytes and counts by kind of one sharded
    training loss and its backward under ``default_rules``."""
    n_data, n_model = mesh
    a = cfg.attention
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    b = b_global // n_data
    act = b * s * d * F32                # a [B_loc, S, d] block
    tok = b * s * F32                    # a [B_loc, S] float32 block
    table = cfg.vocab_size // n_model * d * F32
    layer_weights = ([d * a.n_heads // n_model * hd * F32] +
                     [d * a.n_kv_heads // n_model * hd * F32] * 2 +
                     [a.n_heads // n_model * hd * d * F32] +
                     [d * cfg.d_ff // n_model * F32] * 3)
    passes = 2 if cfg.remat != "none" else 1
    out = {"all-gather": [0, 0], "all-reduce": [0, 0],
           "reduce-scatter": [0, 0]}

    def add(kind, nbytes, times=1):
        out[kind][0] += nbytes * times
        out[kind][1] += times

    # forward: the table gathered for the lookup and for the tied head
    for _ in range(2):
        add("all-gather", table)
        add("reduce-scatter", table)                     # its backward
    add("all-reduce", 2 * act)                           # lookup psum
    for w in layer_weights:
        add("all-gather", w, passes * L)                 # fwd + recompute
        add("reduce-scatter", w, L)                      # backward
    add("all-reduce", 2 * act, 2 * passes * L)           # attn, mlp psum
    add("all-reduce", 2 * tok, 3)                        # pmax, 2 psums
    add("all-reduce", 2 * F32)                           # the loss pmean
    # backward: pbroadcast into heads, MLP columns, vocab slices; the
    # norm scales over data (ln1, ln2 a layer, the final norm)
    add("all-reduce", 2 * act, 2 * L + 1)
    add("all-reduce", 2 * d * F32, 2 * L + 1)
    return {k: tuple(v) for k, v in out.items()}


def _charges(device, cfg):
    model = TransformerLM(cfg, device)
    if device.type == "meta":
        params = model.init(MetaGenerator())
    else:
        params = model.init(torch.Generator().manual_seed(0))
    for p in leaves(params):
        p.requires_grad_(True)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S + 1)))
    toks = toks.to(device)
    mesh = make_mesh(MESH, ("data", "model"), [device] * 4)
    with use_mesh_rules(mesh), OpProfiler(device.type) as prof:
        model.train_loss(params, toks[:, :-1], toks[:, 1:]).backward()
    p = prof.profile
    return p, {k: (p.coll_bytes[k], p.coll_count[k]) for k in p.coll_bytes}


@pytest.fixture(scope="module")
def runs():
    return {dev: _charges(torch.device(dev), _cfg()) for dev in
            ("cpu", "meta")}


def test_one_position_charges_the_closed_form(runs):
    assert runs["meta"][1] == closed_form(_cfg())


def test_every_position_charges_the_closed_form(runs):
    want = closed_form(_cfg())
    assert runs["cpu"][1] == {k: (4 * v[0], 4 * v[1])
                              for k, v in want.items()}


def test_one_position_does_a_position_of_the_work(runs):
    cpu, meta = runs["cpu"][0], runs["meta"][0]
    assert meta.dot_flops * 4 == cpu.dot_flops
    assert {n: {r: {k: v * 4 for k, v in c.items()}
                for r, c in routes.items()}
            for n, routes in meta.kernel_calls().items()} == \
        cpu.kernel_calls()
    assert meta.collectives.pod_bytes == cpu.collectives.pod_bytes == 0


def test_the_closed_form_moves_with_the_rules():
    """Without remat the layers' forward collectives run once."""
    cfg = _cfg()
    plain = closed_form(dataclasses.replace(cfg, remat="none"))
    full = closed_form(cfg)
    per_layer = 7
    assert full["all-gather"][1] - plain["all-gather"][1] == \
        per_layer * cfg.n_layers
    assert full["reduce-scatter"] == plain["reduce-scatter"]
    got = _charges(torch.device("meta"), dataclasses.replace(
        cfg, remat="none"))[1]
    assert got == plain


# ---------------------------------------------------------------------------
# the dry run on the reference's meshes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cells():
    out = {}
    for arch, shape in (("gemma2-9b", "train_4k"),
                        ("olmoe-1b-7b", "prefill_32k"),
                        ("olmoe-1b-7b", "decode_32k")):
        out[arch, shape, "card"] = dryrun.run_cell(
            arch, shape, dryrun.CARD_MESH, verbose=False)
        for name, mc in MESHES.items():
            out[arch, shape, name] = dryrun.run_cell(arch, shape, mc,
                                                     verbose=False)
    return out


def repeated_dot_flops(arch, shape_name, n_model):
    """The dot FLOPs the sharded program repeats over a whole step: the
    K/V projections of a KV head every position reading it computes
    (n_model / KV positions a head where ``model`` exceeds the KV heads)
    and the router, which each of the n_model positions runs on its data
    shard's tokens; a training step runs each product four times
    (forward, recompute, and the backward's two)."""
    cfg, shape = get_arch(arch), SHAPES_BY_NAME[shape_name]
    a = cfg.attention
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    passes = 4 if shape.kind == "train" else 1
    extra = 0
    copies = max(1, n_model // a.n_kv_heads)
    extra += (copies - 1) * passes * 2 * 2 * tokens * cfg.d_model * \
        a.n_kv_heads * cfg.head_dim * cfg.n_layers
    if cfg.moe.enabled:
        extra += (n_model - 1) * passes * 2 * tokens * cfg.d_model * \
            cfg.moe.n_experts * cfg.n_layers
    return extra


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", [("gemma2-9b", "train_4k"),
                                        ("olmoe-1b-7b", "prefill_32k"),
                                        ("olmoe-1b-7b", "decode_32k")])
def test_mesh_cells_run_one_position(cells, arch, shape, mesh):
    rec, card = cells[arch, shape, mesh], cells[arch, shape, "card"]
    assert rec["ok"] is True, rec.get("traceback")
    assert rec["split"] == "position" and "collective_reason" not in rec
    roof = rec["roofline"]
    assert roof["collective_s"] is not None and roof["collective_s"] > 0
    assert roof["coll_bytes_by_kind"]["all-gather"] > 0
    n = MESHES[mesh].n_devices
    assert rec["counts"]["dot_flops"] * n == card["counts"]["dot_flops"] + \
        repeated_dot_flops(arch, shape, MESHES[mesh].shape[-1])
    assert rec["memory"]["argument_size_in_bytes"] == \
        ARGUMENT_BYTES[arch, shape, mesh]
    mem = rec["memory"]
    assert mem["total_bytes_per_device"] == mem["argument_size_in_bytes"] \
        + mem["output_size_in_bytes"] + mem["temp_size_in_bytes"] \
        - mem["alias_size_in_bytes"]
    assert 0 < mem["temp_size_in_bytes"] < card["memory"][
        "temp_size_in_bytes"]


def test_the_multi_pod_train_cell_reduces_gradients_across_pods(cells):
    roof = cells["gemma2-9b", "train_4k", "multi"]["roofline"]
    single = cells["gemma2-9b", "train_4k", "single"]["roofline"]
    assert roof["pod_bytes_dev"] > 0 and single["pod_bytes_dev"] == 0
    assert any("[pod]" in e for e in roof["schedule"])
    assert len(roof["schedule"]) <= 2000


def test_cells_outside_the_slice_keep_the_even_split(monkeypatch):
    """whisper-tiny's and xlstm-350m's decode cells run one position's
    program (item 25.3): no reason, a collective term, the xLSTM's record
    naming its chain; the even split stays where a layout gap is open (a
    MoE model whose heads ``model`` does not divide, under
    ``attn_seq_shard``: item 25.4)."""
    import dataclasses
    for arch in ("whisper-tiny", "xlstm-350m"):
        rec = dryrun.run_cell(arch, "decode_32k", SINGLE_POD_MESH,
                              verbose=False)
        assert rec["ok"] is True, rec.get("traceback")
        assert rec["split"] == "position" and "layout_gap" not in rec
        assert "collective_reason" not in rec
        assert rec["roofline"]["collective_s"] > 0
        assert ("chain" in rec) == (arch == "xlstm-350m")
    real = dryrun.get_arch

    def get(name):
        cfg = real(name)
        if name == "granite-moe-1b-a400m":
            cfg = dataclasses.replace(cfg, n_layers=2, attention=(
                dataclasses.replace(cfg.attention, n_heads=12,
                                    n_kv_heads=4)))
        return cfg
    monkeypatch.setattr(dryrun, "get_arch", get)
    rec = dryrun.run_cell("granite-moe-1b-a400m", "prefill_32k",
                          SINGLE_POD_MESH, verbose=False)
    assert rec["split"] == "even" and \
        rec["layout_gap"] == "attn_seq_shard_moe"
    assert "ROADMAP" in rec["collective_reason"]
    assert rec["roofline"]["collective_s"] is None
    last = {"data": 0, "model": 15}
    for arch, shape, flag in (("gemma2-9b", "prefill_32k", "seq_shard_kv"),
                              ("minicpm-2b", "train_4k", "attn_seq_shard")):
        rec = dryrun.run_cell(arch, shape, SINGLE_POD_MESH, verbose=False)
        assert rec["ok"] is True, rec.get("traceback")
        assert rec["split"] == "position" and rec[flag] is True
        assert rec["position"] == last and "collective_reason" not in rec
        assert rec["roofline"]["collective_s"] > 0
        assert rec["roofline"]["coll_bytes_by_kind"]["all-gather"] > 0


# ---------------------------------------------------------------------------
# one position's program under the sequence layouts
# ---------------------------------------------------------------------------

#: a program kind -> the rules it runs under (``attn_seq_shard``: rows
#: over ``model``; ``seq_shard_kv``: the cache's slots over it)
SEQ_RULES = {"train": dict(attn_seq_shard=True),
             "prefill": dict(attn_seq_shard=True, seq_shard_kv=True),
             "decode": dict(seq_shard_kv=True)}


def _seq_profile(kind, shape, one):
    """What one ``kind`` program of minicpm-2b reduced to 6 heads (which
    do not divide a ``model`` of 4) charges on a mesh of ``meta``
    entries: every position's (``one`` False) or the one at index
    ``one`` along ``model``."""
    cfg = get_arch("minicpm-2b").reduced()
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, n_heads=6, n_kv_heads=6))
    meta = torch.device("meta")
    model = TransformerLM(cfg, meta)
    params = model.init(MetaGenerator())
    toks = torch.zeros((B, S + 1), dtype=torch.long, device=meta)
    mesh = make_mesh(shape, ("data", "model"), [meta] * int(np.prod(shape)))
    with torch.no_grad():
        _, cache = model.prefill(params, toks[:, :S], 2 * S)
    with use_mesh_rules(mesh, one_position=one, **SEQ_RULES[kind]), \
            OpProfiler("meta") as prof:
        if kind == "train":
            for p in leaves(params):
                p.requires_grad_(True)
            model.train_loss(params, toks[:, :-1], toks[:, 1:]).backward()
        elif kind == "prefill":
            with torch.no_grad():
                model.prefill(params, toks[:, :S], 2 * S)
        else:
            pos = torch.full((B, 1), S, dtype=torch.int32, device=meta)
            with torch.no_grad():
                model.decode_step(params, toks[:, S:S + 1], pos, cache)
    return prof.profile


def _share(p):
    """The figures one position's program must repeat: dot FLOPs,
    kernel calls with their work, collective bytes and counts by kind."""
    return {"dot": p.dot_flops, "kernels": p.kernel_calls(),
            "coll_bytes": dict(p.coll_bytes),
            "coll_count": dict(p.coll_count)}


def _added(a, b):
    if isinstance(a, dict):
        return {k: _added(a.get(k, 0), b.get(k, 0)) for k in {*a, *b}}
    return a + b


@pytest.mark.parametrize("shape", [(1, 4), (2, 4)])
@pytest.mark.parametrize("kind", list(SEQ_RULES))
def test_the_last_position_is_its_share_of_every_position(kind, shape):
    """The dry run reports the last position along ``model`` as a
    device's own: all positions' run less the other positions' own runs
    (each along ``model``, times the data positions, which are alike) is
    exactly the last position's run, whose rows under ``attn_seq_shard``
    attend to the most keys."""
    n_data, n_model = shape
    every = _share(_seq_profile(kind, shape, False))
    own = [_share(_seq_profile(kind, shape, m)) for m in range(n_model)]
    rest = own[0]
    for o in own[1:-1]:
        rest = _added(rest, o)
    scale = lambda t: {k: scale(v) for k, v in t.items()} \
        if isinstance(t, dict) else t * n_data  # noqa: E731
    assert _added(scale(rest), scale(own[-1])) == every
    assert own[-1]["coll_bytes"] and own[-1]["kernels"]
    if SEQ_RULES[kind].get("attn_seq_shard"):
        flash = [o["kernels"]["flash_attention"] for o in own]
        assert flash[-1] != flash[0]
    else:
        assert own[-1] == own[0]
