"""The port does all that the JAX package does: an AST walk of every
module under ``src/repro/`` against its counterpart under
``src/repro_torch/`` (the same path).

Every public function, class, method, dataclass field, upper-case
constant and parameter of the reference must have its counterpart in the
port's module of the same path, or match one entry of ``EXEMPT`` (a
``fnmatch`` pattern over ``module::name`` or ``module::name(param)``)
with the reason it is not ported.  Every entry must still cover a gap:
an exemption that no longer matches anything (the name was ported) fails
the test, so the table never hides a name the port has.
"""
import ast
import fnmatch
import functools
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..", "src")
REF, PORT = os.path.join(ROOT, "repro"), os.path.join(ROOT, "repro_torch")

PALLAS = "Pallas only: the CUDA kernels pick their own tiles"
GENERATOR = "the port draws from a torch.Generator (generator=), not a key"
UNREAD = "unread in the reference: a caller who set it would get no effect"
DEVICE = "the device picks the path: CUDA launches the kernel, the CPU " \
    "takes its plain version"
#: (pattern, why it is exempt)
EXEMPT = [
    ("kernels/*(interpret)", PALLAS),
    ("kernels/*(block_*)", PALLAS),
    ("kernels/*::DEFAULT_BLOCK*", PALLAS),
    ("kernels/__init__.py::default_backend", PALLAS),
    ("kernels/__init__.py::resolve_interpret", PALLAS),
    ("kernels/autotune.py::<module>", "Pallas block sizes by backend"),
    ("*(key)", GENERATOR),
    ("*(use_kernel)", DEVICE),
    ("*(use_kernels)", DEVICE),
    ("launch/hlo_analysis.py::<module>",
     "its counterpart is launch/op_analysis.py (torch has no HLO)"),
    ("*.trace_count", "its counterpart is build_count"),
    ("core/rollout.py::make_rollout_fn(on_trace)",
     "its counterpart is build_count"),
    ("core/pipeline_opt.py::V5E_*", "TPU v5e constants"),
    ("core/batch.py::solve_chain_dp_batched_unrolled",
     "a JAX compile-time baseline (ROADMAP §1)"),
    ("core/rollout.py::make_rollout_fn(mesh)",
     "the port shards the rollout in FleetRollout.run(mesh=)"),
    ("parallel/sharding.py::fleet_mesh(axis)",
     "the port shards the rollout in FleetRollout.run(mesh=); a fleet mesh "
     "is a tuple of devices with the one axis FLEET_AXIS"),
    ("launch/dryrun.py::lower_cell",
     "its counterpart is the op profiler's run (dryrun.cell_program)"),
    ("launch/roofline.py::parse_collectives",
     "its counterpart is the collective record the host collectives "
     "charge (roofline.CollectiveStats)"),
    ("launch/roofline.py::build_roofline(compiled)",
     "the roofline reads the op profiler's OpProfile"),
    ("launch/roofline.py::build_roofline(hlo_text)",
     "the roofline reads the op profiler's OpProfile"),
    ("launch/roofline.py::build_roofline(pod_group_stride)",
     "each collective's charge records whether its group crosses pod"),
    ("kernels/*::NEG_INF",
     "the Pallas kernels' mask value; each CUDA kernel holds its own"),
    ("kernels/mlstm_chunk/mlstm_chunk.py::NEG_BIG",
     "the port's is kernels/mlstm_chunk/ref.py::NEG_BIG"),
    ("kernels/*(scale)",
     "the kernels take 1 / sqrt(D), as every reference caller does"),
    ("kernels/mlstm_chunk/mlstm_chunk.py::DEFAULT_CHUNK",
     "the chunk length is the route's (mlstm_chunk.CHUNK)"),
    ("kernels/mlstm_chunk/*(chunk)",
     "the chunk length is the route's (mlstm_chunk.CHUNK)"),
    ("models/recurrent.py::mlstm_seq(chunk)",
     "the chunk length is the route's (mlstm_chunk.CHUNK)"),
    ("models/recurrent.py::mlstm_chunk_math",
     "its counterpart is kernels/mlstm_chunk/ref.py::chunk_math"),
    ("models/attention.py::*(n_heads)",
     "the heads are read from the weights' shapes"),
    ("models/attention.py::attention(q_chunk)",
     "the reference's jnp query chunking; the flash kernel tiles queries"),
    ("models/attention.py::attention(kv_pos)",
     "cross-attention takes no mask (ROADMAP §1)"),
    ("models/recurrent.py::rglru_block_state(decode)",
     "the port passes decode to rglru_block_apply, not in the state"),
    ("optim/grad_compress.py::psum_compressed(axis)",
     "the port's takes the shards' values along the axis"),
    ("runtime/serve_loop.py::make_decode_step(cfg)",
     "the port's decode step reads nothing from the config"),
    ("core/power.py::exhaustive_refine(bits)", UNREAD),
    ("core/power.py::min_power_for_placement(bits_per_link)", UNREAD),
    ("configs/base.py::ServeConfig.kv_block", UNREAD),
    ("configs/base.py::ServeConfig.decode_steps", UNREAD),
]


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return [n for n in names if n not in ("self", "cls")]


def _public(name: str) -> bool:
    return not name.startswith("_")


def api(path: str) -> dict:
    """qualified name -> parameters (functions and methods) or None."""
    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                _public(node.name):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out[node.name] = None
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (_public(sub.name) or sub.name == "__init__"):
                    out[f"{node.name}.{sub.name}"] = _params(sub)
                elif isinstance(sub, ast.AnnAssign) and \
                        isinstance(sub.target, ast.Name) and \
                        _public(sub.target.id):
                    out[f"{node.name}.{sub.target.id}"] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            out.update({t.id: None for t in targets
                        if isinstance(t, ast.Name) and _public(t.id)
                        and t.id.isupper()})
    return out


def modules() -> list:
    return sorted(os.path.relpath(os.path.join(d, f), REF)
                  for d, _, files in os.walk(REF) for f in files
                  if f.endswith(".py"))


@functools.lru_cache(maxsize=None)
def gaps() -> tuple:
    """Every reference name (``module::name`` or ``module::name(param)``)
    without a counterpart in the port's module of the same path."""
    out = []
    for rel in modules():
        port_path = os.path.join(PORT, rel)
        if not os.path.exists(port_path):
            out.append(f"{rel}::<module>")
            continue
        ref, port = api(os.path.join(REF, rel)), api(port_path)
        for name, params in ref.items():
            if name not in port:
                out.append(f"{rel}::{name}")
                continue
            for prm in params or ():
                if prm not in (port[name] or ()):
                    out.append(f"{rel}::{name}({prm})")
    return tuple(out)


def _exempt(gap: str):
    return next((why for pat, why in EXEMPT if fnmatch.fnmatch(gap, pat)),
                None)


def test_the_walk_reads_the_reference():
    assert len(modules()) > 60
    names = api(os.path.join(REF, "core", "planner.py"))
    assert "act_scale" in names["LLHRPlanner.plan"]
    assert "LLHRPlanner.radius" in names


@pytest.mark.parametrize("module", modules())
def test_every_reference_name_has_its_counterpart(module):
    missing = [g for g in gaps() if g.startswith(module + "::")
               and _exempt(g) is None]
    assert not missing, f"not in the port and not exempt: {missing}"


@pytest.mark.parametrize("pattern", [p for p, _ in EXEMPT])
def test_each_exemption_still_covers_a_gap(pattern):
    assert any(fnmatch.fnmatch(g, pattern) for g in gaps()), \
        f"{pattern} covers nothing the port lacks: take it out"


def test_exemptions_say_why():
    assert all(why and len(why) > 10 for _, why in EXEMPT)
    assert len({p for p, _ in EXEMPT}) == len(EXEMPT)
