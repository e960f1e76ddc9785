"""Dry run: every (arch x shape x mesh) cell's program run shape-only on
``meta`` under the op profiler, its memory per device and its roofline
terms on the H100 SXM's constants (the reference's ``launch/dryrun.py``,
which lowers and compiles each cell against ``ShapeDtypeStruct``s).

Usage:
  python -m repro_torch.launch.dryrun --arch minicpm-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh card|single|multi|all]
  python -m repro_torch.launch.dryrun --all --out reports/torch_dryrun

The program is the port's own: ``make_train_step``'s step, ``prefill`` or
``decode_step`` of the model built on ``meta``, every kernel through its
``meta`` entry (outputs' shapes, no arithmetic).  ``--mesh card`` (the
default) is one H100 running the whole cell, the program the card would
run.  Under the reference's (16, 16) and (2, 16, 16) meshes the
arguments are exact (each input's block under its sharding,
``launch.specs``).  Where the reference's rules for the cell give the
port's sharded program (``models.transformer.mesh_layout_gap``: the
dense, MoE, VLM and hybrid LMs with heads over ``model``, the dense,
VLM, xLSTM and whisper ones with their rows over it under
``attn_seq_shard``, and for prefill and decode KV caches by heads or,
under ``seq_shard_kv``, by slots, an xLSTM's decode state by key rows
and ``head_dim``), the model runs under ``use_mesh_rules`` on a mesh of
``meta`` entries, which runs one position's program (``"split":
"position"``, and ``"position"`` names it: the last along ``model``,
whose row block attends to the whole K/V prefix and, for an xLSTM,
receives its recurrent state from its predecessor, a collective-permute
charged in each layer): its memory, FLOPs, bytes and collective bytes
are that device's own, its pod bytes those of its groups that cross
pods.  An xLSTM cell's record names its ``"chain"``: the positions
along ``model`` that run one after another, each waiting for its
predecessor's state (|model| under ``attn_seq_shard``, 1 in decode),
which a device's roofline terms do not show.  Cells with a layout the
port does not run yet (``MISSING_LAYOUT``) run the unsharded program,
split evenly over the devices (``"split": "even"``), with no collective
term and a reason that names the layout they wait for.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import (ALL_SHAPES, MULTI_POD_MESH,
                                      SHAPES_BY_NAME, SINGLE_POD_MESH,
                                      MeshConfig, TrainConfig)
from repro_torch.configs.registry import LM_ARCHS, get_arch
from repro_torch.core.cost_model import model_flops
from repro_torch.launch.op_analysis import OpProfiler, _tensors
from repro_torch.launch.roofline import build_roofline
from repro_torch.launch.specs import argument_bytes, input_specs
from repro_torch.models import build_model
from repro_torch.models.transformer import MISSING_LAYOUT, mesh_layout_gap
from repro_torch.parallel.sharding import Spmd, make_mesh, use_mesh_rules
from repro_torch.runtime.train_loop import make_train_step

META = torch.device("meta")
#: one H100: the whole cell on one card
CARD_MESH = MeshConfig((1, 1), ("data", "model"))
MESHES = {"card": [CARD_MESH], "single": [SINGLE_POD_MESH],
          "multi": [MULTI_POD_MESH],
          "all": [CARD_MESH, SINGLE_POD_MESH, MULTI_POD_MESH]}


def collective_reason(gap: str) -> str:
    """Why a mesh cell splits its unsharded program evenly: the layout
    it needs that the port does not run yet, and its ROADMAP item."""
    item = MISSING_LAYOUT.get(gap, "ROADMAP queue 1 item 25")
    return (f"the cell needs the {gap} layout, which the port's sharded "
            f"program does not run yet ({item}); the unsharded program is "
            f"split evenly and its collective bytes are unknown")


def mesh_name(mesh_cfg: MeshConfig) -> str:
    return "card" if mesh_cfg == CARD_MESH else \
        "x".join(map(str, mesh_cfg.shape))


def cell_program(arch: str, shape_name: str, mesh_cfg: MeshConfig):
    """Build one cell: (program, inputs, shardings, meta) with the
    reference's ``lower_cell`` choices (microbatches, ``seq_shard_kv``,
    ``attn_seq``, ``kv_batch``), or (None, None, None, skip record)."""
    cfg = get_arch(arch)
    shape = SHAPES_BY_NAME[shape_name]
    if not cfg.supports(shape):
        return None, None, None, {"skipped": True,
                                  "reason": "unsupported shape "
                                  "(DESIGN.md §Arch-applicability)"}
    model = build_model(cfg, device=META)
    mesh = make_mesh(mesh_cfg.shape, mesh_cfg.axes,
                     [META] * mesh_cfg.n_devices)
    n_batch_shards = int(np.prod(
        [mesh_cfg.shape[i] for i, a in enumerate(mesh_cfg.axes)
         if a in ("pod", "data")]))
    local_b = max(1, shape.global_batch // n_batch_shards)
    mb = min(8, local_b) if shape.kind == "train" else 1
    tcfg = TrainConfig(microbatches=mb)
    seq_kv = (shape.kind in ("decode", "prefill") and
              (shape.seq_len >= 262144 or
               cfg.attention.n_kv_heads % mesh.shape["model"] != 0))
    attn_seq = (cfg.attention.n_heads % mesh_cfg.shape[-1] != 0
                and shape.kind != "decode")
    kv_batch = (shape.global_batch % n_batch_shards == 0
                and shape.global_batch > 1)
    inputs, shards = input_specs(cfg, shape, mesh, model, tcfg)
    rules = dict(seq_shard_kv=seq_kv, attn_seq_shard=attn_seq,
                 kv_batch_shard=kv_batch)
    gap = None
    if mesh_cfg.n_devices > 1:
        with use_mesh_rules(mesh, **rules):
            gap = mesh_layout_gap(cfg, mesh, shape.kind, shape.global_batch)
    if shape.kind == "train":
        step = make_train_step(model, cfg, tcfg)

        def program():
            return step(inputs["state"], inputs["batch"])
    elif shape.kind == "prefill":
        def program():
            batch = inputs["batch"]
            with torch.no_grad():
                if cfg.family == "audio":
                    return model.prefill(inputs["params"], batch["tokens"],
                                         batch["frames"], shape.seq_len)
                kw = {}
                if cfg.family == "vlm":
                    kw["extra_embeds"] = batch["patch_embeds"]
                return model.prefill(inputs["params"], batch["tokens"],
                                     shape.seq_len, **kw)
    else:
        def program():
            with torch.no_grad():
                return model.decode_step(inputs["params"], inputs["tokens"],
                                         inputs["pos"], inputs["cache"])
    if mesh_cfg.n_devices > 1 and gap is None:
        whole = program

        def program():
            with use_mesh_rules(mesh, **rules):
                return whole()
    meta = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh_cfg),
            "n_chips": mesh_cfg.n_devices, "kind": shape.kind,
            "microbatches": mb, "seq_shard_kv": bool(seq_kv),
            "attn_seq_shard": bool(attn_seq), "kv_batch_shard": kv_batch}
    if mesh_cfg.n_devices > 1:
        meta["split"] = "even" if gap else "position"
        if gap:
            meta["layout_gap"] = gap
        else:
            meta["position"] = mesh.index(Spmd(mesh).positions[0])
            if cfg.family == "ssm":
                # the positions along model that run one after another,
                # each waiting for its predecessor's recurrent state
                meta["chain"] = mesh_cfg.shape[-1] if attn_seq else 1
    return program, inputs, shards, meta


def storage_bytes(tree) -> int:
    """Bytes of the storages ``tree``'s tensors hold, each storage once."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def run_program(program, inputs, n_chips: int = 1):
    """Run ``program()`` under an ``OpProfiler`` of the inputs' device:
    (profiler, memory record per device).  ``inputs`` are the program's
    arguments: storages first seen there are not the block's; output
    leaves on an argument's storage are aliases.  With ``n_chips`` > 1
    everything but the arguments is split evenly (1 for one position's
    program: its counts are a device's own)."""
    args = _tensors(inputs)
    arg_refs = {t.untyped_storage()._cdata for t in args}
    with OpProfiler(args[0].device.type) as prof:
        prof.arguments(inputs)
        out = program()
    _, out_new = prof.live_bytes(out)
    alias = sum(st.nbytes() for key, st in {
        t.untyped_storage()._cdata: t.untyped_storage()
        for t in _tensors(out)}.items() if key in arg_refs)
    del out
    peak = prof.profile.peak_bytes
    mem = {"output_size_in_bytes": (out_new + alias) / n_chips,
           "temp_size_in_bytes": (peak - out_new) / n_chips,
           "alias_size_in_bytes": alias / n_chips}
    return prof, mem


def run_cell(arch: str, shape_name: str, mesh_cfg: MeshConfig,
             out_dir: Optional[str] = None, verbose: bool = True) -> dict:
    t0 = time.time()
    record = {"arch": arch, "shape": shape_name,
              "mesh": mesh_name(mesh_cfg)}
    try:
        program, inputs, shards, meta = cell_program(arch, shape_name,
                                                     mesh_cfg)
        record.update(meta)
        if meta.get("skipped"):
            if verbose:
                print(f"[dryrun] SKIP {arch}/{shape_name}: {meta['reason']}")
            return record
        n = mesh_cfg.n_devices
        per = 1 if meta.get("split") == "position" else n
        args = argument_bytes(inputs, shards)
        t1 = time.time()
        prof, mem = run_program(program, inputs, per)
        trace_s = time.time() - t1
        mem["argument_size_in_bytes"] = args
        mem["total_bytes_per_device"] = (
            args + mem["output_size_in_bytes"] + mem["temp_size_in_bytes"]
            - mem["alias_size_in_bytes"])
        cfg, shape = get_arch(arch), SHAPES_BY_NAME[shape_name]
        roof = build_roofline(prof.profile, model_flops(cfg, shape), n,
                              collectives=meta.get("split") != "even",
                              devices_counted=per)
        record.update({
            "ok": True, "trace_s": round(trace_s, 3),
            "setup_s": round(t1 - t0, 3), "memory": mem,
            "roofline": roof.to_dict(),
            "counts": {"dot_flops": prof.profile.dot_flops,
                       "traffic_bytes": prof.profile.traffic_bytes,
                       "kernel_bytes": prof.profile.kernel_bytes,
                       "peak_bytes": prof.profile.peak_bytes},
            "kernels": prof.profile.kernel_calls()})
        if meta.get("split") == "even":
            record["collective_reason"] = collective_reason(
                meta["layout_gap"])
        if verbose:
            tb = mem["total_bytes_per_device"]
            r = record["roofline"]
            coll = "n/a" if r["collective_s"] is None else \
                f"{r['collective_s'] * 1e3:.2f}ms"
            print(f"[dryrun] OK {arch}/{shape_name}/{record['mesh']} "
                  f"mem={tb / 2 ** 30:.2f}GiB/dev "
                  f"compute={r['compute_s'] * 1e3:.2f}ms "
                  f"memory={r['memory_s'] * 1e3:.2f}ms coll={coll} "
                  f"bottleneck={r['bottleneck']} "
                  f"useful={r['useful_ratio']:.2f} "
                  f"frac={r['roofline_fraction']:.3f} "
                  f"(trace {trace_s:.1f}s)")
        del program, inputs, shards, prof
        gc.collect()
    except Exception as e:
        record.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()})
        if verbose:
            print(f"[dryrun] FAIL {arch}/{shape_name}/{record['mesh']}: "
                  f"{record['error']}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}_{shape_name}_{record['mesh']}.json".replace("/", "-")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="card", choices=list(MESHES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="reports/torch_dryrun")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(LM_ARCHS)
    shapes = [args.shape] if args.shape else [s.name for s in ALL_SHAPES]
    if not args.all and not args.arch:
        ap.error("pass --all or --arch")

    results = []
    for arch in archs:
        for shape in shapes:
            for mc in MESHES[args.mesh]:
                results.append(run_cell(arch, shape, mc, args.out))
    ok = sum(1 for r in results if r.get("ok"))
    skip = sum(1 for r in results if r.get("skipped"))
    fail = sum(1 for r in results if r.get("ok") is False)
    print(f"[dryrun] done: {ok} ok, {skip} skipped, {fail} failed "
          f"of {len(results)} cells")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
