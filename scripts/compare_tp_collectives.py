"""The collectives of one training loss and its backward under a (data 2,
model 2) mesh, the port's sharded program beside the reference's
compiled one, per device and by kind.

The port's side: the reduced minicpm-2b (remat full) run as one
position's program on a mesh of ``meta`` entries under the op profiler,
which charges every collective the program and its backward make
(``launch.roofline.CollectiveStats``).  The reference's side: the same
config's ``value_and_grad`` of its training loss jitted under
``use_mesh_rules`` on 4 forced host devices, compiled, and its HLO read
by the reference's ``launch/roofline.py::parse_collectives`` (run in a
subprocess: the device count must be set before jax starts), the
parameters and rows laid out by its ``param_shardings`` and batch spec
as its dry run lays them.  Both
count per device with the reference's accounting (an all-reduce 2x its
result's bytes, a reduce-scatter its result's bytes times the group,
the others 1x).  A record, not a gate: GSPMD picks its own collectives.

  PYTHONPATH=src python3 scripts/compare_tp_collectives.py [--out FILE]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

B, S, MESH = 4, 12, (2, 2)

REFERENCE = textwrap.dedent('''
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.registry import get_arch
    from repro.launch.roofline import parse_collectives
    from repro.models.transformer import TransformerLM
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.parallel.param_sharding import param_shardings
    from repro.parallel.sharding import use_mesh_rules
    from repro.runtime import train_loop as j_train
    B, S, MESH = {b}, {s}, {mesh}
    cfg = dataclasses.replace(get_arch("minicpm-2b").reduced(), remat="full")
    model = TransformerLM(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1))
    batch = {{"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)}}
    mesh = jax.make_mesh(MESH, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rows = NamedSharding(mesh, P("data", None))
    with use_mesh_rules(mesh):
        fn = jax.jit(jax.value_and_grad(
            lambda p, b: j_train._loss_fn(model, cfg, p, b)),
            in_shardings=(param_shardings(mesh, params),
                          {{"tokens": rows, "labels": rows}}))
        hlo = fn.lower(params, batch).compile().as_text()
    st = parse_collectives(hlo)
    print(json.dumps({{"bytes_by_kind": st.bytes_by_kind,
                      "count_by_kind": st.count_by_kind}}))
''').format(b=B, s=S, mesh=MESH)


def port_side() -> dict:
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.device import MetaGenerator
    from repro_torch.launch.op_analysis import OpProfiler
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.parallel.sharding import make_mesh, use_mesh_rules
    from repro_torch.tree import leaves
    meta = torch.device("meta")
    cfg = dataclasses.replace(get_arch("minicpm-2b").reduced(), remat="full")
    model = TransformerLM(cfg, meta)
    params = model.init(MetaGenerator())
    for p in leaves(params):
        p.requires_grad_(True)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 1))).to(meta)
    mesh = make_mesh(MESH, ("data", "model"), [meta] * (MESH[0] * MESH[1]))
    with use_mesh_rules(mesh), OpProfiler("meta") as prof:
        model.train_loss(params, toks[:, :-1], toks[:, 1:]).backward()
    st = prof.profile.collectives
    return {"bytes_by_kind": st.bytes_by_kind,
            "count_by_kind": st.count_by_kind}


def reference_side() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    out = subprocess.run([sys.executable, "-c", REFERENCE], env=env,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rec = {"config": "minicpm-2b reduced, remat full",
           "batch": [B, S], "mesh": list(MESH),
           "port": port_side(), "reference": reference_side()}
    text = json.dumps(rec, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)


if __name__ == "__main__":
    main()
