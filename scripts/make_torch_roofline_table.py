"""Render the PyTorch port's dry-run records as markdown roofline tables.

    PYTHONPATH=src python3 scripts/make_torch_roofline_table.py \
        [reports/torch_dryrun]

Reads the JSON records ``python -m repro_torch.launch.dryrun`` writes, and
prints one table a mesh (the card, (16, 16), (2, 16, 16)) in the columns
of ``scripts/make_roofline_table.py``: memory a device, the compute,
memory and collective terms on the H100 SXM's constants, the bottleneck,
MODEL_FLOPS and the useful ratio; the card's cells again as one row an
arch; the mesh cells that run one position's program as one row a cell,
both meshes side by side; then the planner kernels' work a call and
arithmetic intensity from ``kernels.work.KERNEL_WORK``.  Every
figure is a prediction from the counted program, not a measurement.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCHS = ["minicpm-2b", "gemma2-9b", "phi4-mini-3.8b", "qwen1.5-4b",
         "xlstm-350m", "recurrentgemma-9b", "whisper-tiny", "qwen2-vl-2b",
         "granite-moe-1b-a400m", "olmoe-1b-7b"]
MESHES = (("card", "one H100 SXM5 80GB (the whole cell on one card)"),
          ("16x16", "single-pod 16x16 (256 cards; a position's program, or "
                    "the unsharded one split evenly)"),
          ("2x16x16", "multi-pod 2x16x16 (512 cards; a position's program, "
                      "or the unsharded one split evenly)"))
CARD_BYTES = 80e9


def load(dir_):
    recs = {}
    if not os.path.isdir(dir_):
        return recs
    for f in sorted(os.listdir(dir_)):
        if not f.endswith(".json"):
            continue
        with open(os.path.join(dir_, f)) as fh:
            r = json.load(fh)
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def fmt_s(x):
    if x is None:
        return "n/a"
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x * 1e3:.1f}ms"


def table(recs, mesh):
    rows = ["| arch | shape | mem/dev | compute | memory | collective | "
            "bottleneck | MODEL_FLOPS | useful | note |",
            "|" + "---|" * 10]
    for arch in ARCHS:
        for shape in ORDER:
            r = recs.get((arch, shape, mesh))
            if r is None:
                continue
            if r.get("skipped"):
                rows.append(f"| {arch} | {shape} | — | — | — | — | — | — |"
                            f" — | N/A: full attention (DESIGN.md) |")
                continue
            if not r.get("ok"):
                rows.append(f"| {arch} | {shape} | FAIL | | | | | | | "
                            f"{r.get('error', '')[:40]} |")
                continue
            ro = r["roofline"]
            mem = r["memory"]["total_bytes_per_device"]
            note = "over 80 GB" if mem > CARD_BYTES else ""
            if r.get("split") == "even":
                note = "; ".join(x for x in (note, "collective unknown")
                                 if x)
            rows.append(
                f"| {arch} | {shape} | {mem / 2 ** 30:.1f}GiB "
                f"| {fmt_s(ro['compute_s'])} | {fmt_s(ro['memory_s'])} "
                f"| {fmt_s(ro['collective_s'])} | {ro['bottleneck']} "
                f"| {ro['model_flops']:.2e} | {ro['useful_ratio']:.2f} "
                f"| {note} |")
    return "\n".join(rows)


def card_summary(recs):
    """The card's cells as one row an arch, a column a shape: memory a
    device, the compute (C) and memory (M) terms, the useful ratio (u);
    "—" where the arch does not take the shape."""
    rows = ["| arch | " + " | ".join(ORDER) + " |",
            "|" + "---|" * (len(ORDER) + 1)]
    for arch in ARCHS:
        cells = []
        for shape in ORDER:
            r = recs.get((arch, shape, "card"))
            if r is None or r.get("skipped"):
                cells.append("—")
            elif not r.get("ok"):
                cells.append("FAIL")
            else:
                ro = r["roofline"]
                mem = r["memory"]["total_bytes_per_device"] / 2 ** 30
                cells.append(f"{mem:.1f} GiB · C {fmt_s(ro['compute_s'])} · "
                             f"M {fmt_s(ro['memory_s'])} · u "
                             f"{ro['useful_ratio']:.2f}")
        rows.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def position_summary(recs):
    """The mesh cells that ran one position's program (``"split":
    "position"``), a row a cell: under each mesh the memory a device and
    the compute (C), memory (M) and collective (X) terms, with the pod
    bytes a device where a group crosses pods, and an xLSTM cell's chain
    (the positions along ``model`` that wait on each other's recurrent
    state, which a device's terms do not show)."""
    cells = sorted({(a, s) for a, s, m in recs
                    if recs[a, s, m].get("split") == "position"},
                   key=lambda c: (ARCHS.index(c[0]), ORDER.index(c[1])))
    rows = ["| arch | shape | (16, 16) | (2, 16, 16) |", "|---|---|---|---|"]
    for arch, shape in cells:
        out = []
        for mesh in ("16x16", "2x16x16"):
            r = recs.get((arch, shape, mesh))
            if r is None or r.get("split") != "position":
                out.append("—")
                continue
            ro = r["roofline"]
            mem = r["memory"]["total_bytes_per_device"] / 2 ** 30
            pod = ro.get("pod_bytes_dev") or 0.0
            out.append(f"{mem:.1f} GiB · C {fmt_s(ro['compute_s'])} · M "
                       f"{fmt_s(ro['memory_s'])} · X "
                       f"{fmt_s(ro['collective_s'])}"
                       + (f" (pod {pod / 1e9:.2f} GB)" if pod else "")
                       + (f" · chain {r['chain']}" if r.get("chain", 1) > 1
                          else ""))
        rows.append(f"| {arch} | {shape} | " + " | ".join(out) + " |")
    return "\n".join(rows)


def planner_kernel_table(B=64, M=8, L=12, S=8, U=16):
    """The two planner kernels' work a call from ``KERNEL_WORK`` at the
    reference's bench default shape: GFLOP a call, arithmetic intensity
    (operations a byte) and the bound on the H100 SXM."""
    import torch
    from repro_torch.kernels.work import KERNEL_WORK
    from repro_torch.launch.roofline import kernel_bound

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    works = {
        "link_geometry": KERNEL_WORK["link_geometry"](
            meta(B, U, 2), meta(B, U), None),
        "tropical_dp": KERNEL_WORK["tropical_dp"](
            meta(B, U, U), meta(B, M, dtype=torch.int64),
            meta(B, U, dtype=torch.bool), meta(S, dtype=torch.int64),
            meta(S + 1, dtype=torch.int64), meta(L), meta(),
            meta(L, L, S), meta(L, L, S)),
    }
    rows = ["| kernel | shape | GFLOP/call | AI (flop/byte) | bound µs | "
            "source |", "|---|---|---|---|---|---|"]
    shape = f"B {B}, M {M}, L {L}, S {S}, U {U}"
    for name, w in works.items():
        bound = kernel_bound(w)
        rows.append(f"| {name} | {shape} | {w.flops / 1e9:.4f} "
                    f"| {w.flops / w.bytes:.2f} | {bound.bound_s * 1e6:.3f} "
                    f"({bound.bound_by}) | KERNEL_WORK (analytic) |")
    return "\n".join(rows)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dir_ = argv[0] if argv else "reports/torch_dryrun"
    recs = load(dir_)
    n_ok = sum(1 for r in recs.values() if r.get("ok"))
    n_skip = sum(1 for r in recs.values() if r.get("skipped"))
    n_fail = sum(1 for r in recs.values()
                 if r.get("ok") is False and not r.get("skipped"))
    print(f"<!-- {n_ok} ok / {n_skip} skipped / {n_fail} failed -->\n")
    for mesh, label in MESHES:
        if not any(k[2] == mesh for k in recs):
            continue
        print(f"### Mesh {label}\n")
        print(table(recs, mesh))
        print()
    if any(k[2] == "card" for k in recs):
        print("### One H100, a row an arch\n")
        print(card_summary(recs))
        print()
    if any(r.get("split") == "position" for r in recs.values()):
        print("### A position's program on the reference's meshes\n")
        print(position_summary(recs))
        print()
    print("### Planner kernels (KERNEL_WORK)\n")
    print(planner_kernel_table())
    print()


if __name__ == "__main__":
    main()
