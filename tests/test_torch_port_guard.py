"""Guards of the PyTorch port's boundaries.

* No module under ``src/repro_torch``, nor ``chip_smoke.py``, nor the
  port's scripts ``benchmarks/torch_*.py`` and ``examples/torch_*.py``
  imports ``jax`` or anything of ``repro`` (an AST scan, so a lazy import
  inside a function is caught too).
* Entry points built without ``device=`` run on CUDA or raise; they never
  fall back to the CPU (the engine, the rollout, the planner, the
  baselines, ``SwarmSim``, the batched chain-DP wrappers,
  ``solve_positions_legacy``, the figure scripts, ``PeriodicReplanner``
  over a default engine and a rollout-backed ``StreamingGateway`` among
  them).
* A CPU tensor given to a kernel dispatcher (link geometry, the chain
  DP, conv2d, prefill and decode attention, the expert GEMM,
  the RG-LRU scan, the mLSTM chunk) takes the plain version and leaves
  the kernel's launch counter alone; a tensor on another device raises.
* The LM serving path (``TransformerLM``, ``WhisperLM``, ``build_model``,
  ``ContinuousBatcher``) runs on CUDA or raises; ``TransformerLM`` on
  family ``audio`` raises naming ``WhisperLM``, an unknown block kind
  raises.
* ``examples/torch_serve_swarm.py`` defaults to the card in all three
  modes, and a fleet mesh of CUDA devices raises without CUDA: neither
  falls back to the CPU.
"""
import dataclasses
import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs.lenet import LENET  # noqa: E402
from repro_torch.core.channel import RadioChannel, RadioParams  # noqa: E402
from repro_torch.core.cost_model import cnn_cost  # noqa: E402
from repro_torch.core.planner import LLHRPlanner  # noqa: E402
from repro_torch.core.rollout import RolloutSpec, make_plan_fn  # noqa: E402
from repro_torch.core.swarm import make_devices  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.conv2d.ops import conv2d  # noqa: E402
from repro_torch.kernels.conv2d.ref import conv2d_ref  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_mha  # noqa: E402
from repro_torch.kernels.flash_attention.ops import mha  # noqa: E402
from repro_torch.kernels.link_geometry.ops import \
    fused_link_geometry  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.tropical_dp.ops import chain_dp  # noqa: E402
from repro_torch.launch.op_analysis import OpProfiler  # noqa: E402
from repro_torch.configs.base import ServeConfig  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.blocks import block_def  # noqa: E402
from repro_torch.models.cnn import init_cnn  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.models.whisper import WhisperLM  # noqa: E402
from repro_torch.runtime.serve_loop import ContinuousBatcher  # noqa: E402
from repro_torch.runtime.fleet_rollout import FleetRollout  # noqa: E402
from repro_torch.runtime.scenario_engine import ScenarioEngine  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "repro")
NO_LAUNCHES = {"link_geometry": 0, "tropical_dp": 0, "tropical_dp_step": 0,
               "conv2d": 0, "flash_attention": 0, "flash_attention_bwd": 0,
               "decode_attention": 0, "moe_matmul": 0, "moe_matmul_dx": 0,
               "moe_matmul_dw": 0, "rglru_scan": 0, "rglru_scan_bwd": 0,
               "mlstm_chunk": 0, "mlstm_chunk_bwd": 0,
               "mlstm_decode_block": 0}


EXAMPLE = os.path.join(ROOT, "examples", "torch_uav_swarm_sim.py")
FIGURES = ("torch_fig2_latency_power", "torch_fig3_latency_memory",
           "torch_fig4_min_power", "torch_fig5_request_scaling")


#: the port's scripts under ``scripts/`` (the reference's stay out: its
#: ``make_roofline_table.py``, and ``compare_figure_rows.py``, which reads
#: both packages' CSVs)
PORT_SCRIPTS = ("profile_torch_", "probe_", "time_xlstm_train_step",
                "make_torch_roofline_table")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for sub in ("benchmarks", "examples"):
        out += [os.path.join(ROOT, sub, f)
                for f in os.listdir(os.path.join(ROOT, sub))
                if f.startswith("torch_") and f.endswith(".py")]
    out += [os.path.join(ROOT, "scripts", f)
            for f in os.listdir(os.path.join(ROOT, "scripts"))
            if f.startswith(PORT_SCRIPTS) and f.endswith(".py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_scan_covers_the_package_and_chip_smoke():
    files = _port_files()
    assert os.path.join(ROOT, "chip_smoke.py") in files
    assert EXAMPLE in files and os.path.isfile(EXAMPLE)
    for name in FIGURES + ("torch_common",):
        assert os.path.join(ROOT, "benchmarks", name + ".py") in files
    for name in ("torch_quickstart", "torch_scenario_planning",
                 "torch_serve_swarm", "torch_train_lm"):
        assert os.path.join(ROOT, "examples", name + ".py") in files
    assert any(f.endswith(os.path.join("core", "rollout.py")) for f in files)
    for sub in (("parallel", "__init__.py"), ("parallel", "sharding.py"),
                ("core", "pipeline_opt.py"), ("tree.py",),
                ("data", "pipeline.py"), ("optim", "adamw.py"),
                ("optim", "schedules.py"), ("optim", "grad_compress.py"),
                ("runtime", "train_loop.py"), ("runtime", "checkpoint.py")):
        assert os.path.join(ROOT, "src", "repro_torch", *sub) in files
    assert any(f.endswith(os.path.join("models", "cnn.py")) for f in files)
    for name in ("make_torch_roofline_table", "time_xlstm_train_step",
                 "profile_torch_lm", "probe_rglru_bwd"):
        assert os.path.join(ROOT, "scripts", name + ".py") in files
    for sub in (("launch", "roofline.py"), ("launch", "op_analysis.py"),
                ("launch", "specs.py"), ("launch", "dryrun.py"),
                ("debug", "__init__.py"), ("debug", "sanitize.py")):
        assert os.path.join(ROOT, "src", "repro_torch", *sub) in files
    assert os.path.join(ROOT, "scripts", "make_roofline_table.py") \
        not in files
    assert len(files) >= 20


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert bad == [], f"{os.path.relpath(path, ROOT)} imports {bad}"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _problem():
    return RadioChannel(), make_devices(4), cnn_cost(LENET)


def test_engine_without_device_raises(monkeypatch):
    _no_cuda(monkeypatch)
    ch, devs, mc = _problem()
    with pytest.raises(RuntimeError, match="CUDA"):
        ScenarioEngine(ch, devs, mc)


def test_fleet_rollout_without_device_raises(monkeypatch):
    _no_cuda(monkeypatch)
    ch, devs, mc = _problem()
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetRollout(ch, devs, mc, RolloutSpec(frames=2))


def test_make_plan_fn_without_device_raises(monkeypatch):
    _no_cuda(monkeypatch)
    ch, devs, mc = _problem()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_plan_fn(params=ch.params,
                     compute=[l.flops for l in mc.layers],
                     memory=[l.weight_bytes for l in mc.layers],
                     act_bits=[l.act_bits for l in mc.layers],
                     input_bits=mc.input_bits,
                     mem_cap=[d.mem_cap for d in devs],
                     compute_cap=[d.compute_cap for d in devs],
                     throughput=[d.throughput for d in devs],
                     order=(0, 1, 2, 3))


def test_cpu_tensors_take_the_plain_path_without_counting():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    pos = torch.as_tensor(rng.uniform(0, 80, (2, 4, 2)), dtype=torch.float32)
    dist, th, rate = fused_link_geometry(pos, RadioParams())
    assert dist.shape == th.shape == rate.shape == (2, 4, 4)
    args, L = _chain_args()
    assign, latency = chain_dp(*args)
    assert assign.shape == (2, 3, L) and latency.shape == (2, 3)
    assert assign.dtype == torch.int32
    assert kernels.launch_counts() == NO_LAUNCHES


def test_cpu_engine_plans_without_counting():
    kernels.reset_launch_counts()
    ch, devs, mc = _problem()
    from repro_torch.runtime.scenario_engine import ScenarioGenerator
    batch = ScenarioGenerator(np.arange(8.0).reshape(4, 2) * 10.0,
                              pos_sigma_m=2.0, seed=1).draw(3)
    plan = ScenarioEngine(ch, devs, mc, device="cpu").plan_batch(batch)
    assert plan.assign.shape == (3, len(mc.layers))
    assert kernels.launch_counts() == NO_LAUNCHES


def test_planner_without_device_raises(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        LLHRPlanner(RadioChannel())


def test_swarm_sim_and_baselines_without_device_raise(monkeypatch):
    from repro_torch.core.baselines import HeuristicPlanner, RandomPlanner
    from repro_torch.core.swarm import SwarmSim
    planner = LLHRPlanner(RadioChannel(), device="cpu")
    _no_cuda(monkeypatch)
    ch, devs, mc = _problem()
    with pytest.raises(RuntimeError, match="CUDA"):
        SwarmSim(mc, devs, planner)
    for cls in (HeuristicPlanner, RandomPlanner):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(ch)
    assert SwarmSim(mc, devs, planner, device="cpu").device.type == "cpu"


def test_batched_chain_dp_wrappers_without_device_raise(monkeypatch):
    from repro_torch.core.batch import (solve_chain_dp_batched,
                                        solve_chain_dp_multisource)
    _no_cuda(monkeypatch)
    ch, devs, mc = _problem()
    U = len(devs)
    rate = np.full((2, U, U), 1e6)
    rate[:, np.arange(U), np.arange(U)] = np.inf
    args = ([x.flops for x in mc.layers], [x.weight_bytes for x in mc.layers],
            [x.act_bits for x in mc.layers], mc.input_bits,
            [d.mem_cap for d in devs], [d.compute_cap for d in devs],
            [d.throughput for d in devs], rate)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_chain_dp_batched(*args, np.zeros(2, int))
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_chain_dp_multisource(*args, np.zeros((2, 3), int))
    kernels.reset_launch_counts()
    assign, lat = solve_chain_dp_multisource(*args, np.zeros((2, 3), int),
                                             device="cpu")
    assert assign.shape == (2, 3, len(mc.layers)) and np.isfinite(lat).all()
    assert kernels.launch_counts() == NO_LAUNCHES


def test_solve_positions_legacy_without_device_raises(monkeypatch):
    from repro_torch.core.positions import solve_positions_legacy
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_positions_legacy(4, RadioChannel(), steps=2)
    assert solve_positions_legacy(4, RadioChannel(), steps=2,
                                  device="cpu").positions.shape == (4, 2)


def test_init_cnn_without_device_raises(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cnn(LENET, torch.Generator().manual_seed(0))


def test_cpu_conv2d_takes_the_plain_path_without_counting():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(2, 9, 9, 3)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(3, 3, 3, 5)), dtype=torch.float32)
    b = torch.zeros(5)
    y = conv2d(x, w, b, stride=2, padding=1)
    assert y.shape == (2, 5, 5, 5) and y.device.type == "cpu"
    torch.testing.assert_close(y, conv2d_ref(x, w, b, stride=2, padding=1),
                               atol=5e-4, rtol=1e-3)
    assert kernels.launch_counts()["conv2d"] == 0


def test_launch_counts_cover_every_kernel():
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == NO_LAUNCHES


def test_cpu_attention_takes_the_plain_path_without_counting():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(2)
    q = torch.as_tensor(rng.normal(size=(2, 9, 4, 16)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(2, 9, 2, 16)), dtype=torch.float32)
    assert mha(q, k, k, window=4, cap=50.0).shape == (2, 9, 4, 16)
    pos = torch.tensor([0, 8], dtype=torch.int32)
    assert decode_mha(q[:, :1], k, k, pos, cap=50.0).shape == (2, 1, 4, 16)
    assert kernels.launch_counts() == NO_LAUNCHES


@pytest.mark.parametrize("arch,reduced", [
    ("gemma2-9b", True), ("olmoe-1b-7b", False),
    ("granite-moe-1b-a400m", False), ("recurrentgemma-9b", False),
    ("xlstm-350m", False), ("whisper-tiny", False), ("whisper-tiny", True),
    ("qwen2-vl-2b", False), ("qwen2-vl-2b", True)])
def test_lm_entry_points_without_device_raise(monkeypatch, arch, reduced):
    """Every served family defaults to the card (the full MoE, griffin,
    whisper and VLM configs too: the check comes before any parameter
    exists); whisper's model is ``WhisperLM``."""
    _no_cuda(monkeypatch)
    cfg = get_arch(arch).reduced() if reduced else get_arch(arch)
    lm = WhisperLM if cfg.family == "audio" else TransformerLM
    with pytest.raises(RuntimeError, match="CUDA"):
        lm(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatcher(lm(cfg), cfg, ServeConfig(), params={})
    cpu = build_model(cfg, device="cpu")
    assert isinstance(cpu, lm)
    assert ContinuousBatcher(cpu, cfg, ServeConfig(), {}).device == \
        torch.device("cpu")


@pytest.mark.parametrize("arch", ["whisper-tiny", "phi4-mini-3.8b"])
def test_transformer_lm_refuses_family_audio(arch):
    """Family ``audio`` is ``WhisperLM``'s: ``TransformerLM`` raises
    ``ValueError`` naming it, as the reference's does."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), family="audio")
    with pytest.raises(ValueError, match="WhisperLM"):
        TransformerLM(cfg, device="cpu")


def test_xlstm_model_alternates_slstm_and_mlstm_blocks():
    cfg = get_arch("xlstm-350m").reduced()
    lm = TransformerLM(cfg, device="cpu")
    assert lm.kinds == ["slstm", "mlstm", "slstm", "mlstm"]
    assert lm.blocks == [block_def(k) for k in lm.kinds]
    full = TransformerLM(get_arch("xlstm-350m"), device="cpu")
    assert full.kinds == ["slstm", "mlstm"] * 12


def test_block_def_rejects_an_unknown_kind():
    with pytest.raises(KeyError, match="unknown block kind 'lstm'"):
        block_def("lstm")


class OtherDevice(torch.Tensor):
    """A tensor that names a device no dispatch table has (``mps``) and
    runs no op: what a dispatcher must refuse before any work."""

    @staticmethod
    def __new__(cls, like):
        return torch.Tensor._make_wrapper_subclass(
            cls, like.shape, dtype=like.dtype, device="mps")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} ran on an unsupported device")


def test_mlstm_dispatch_raises_on_an_unsupported_device():
    """The CPU takes the plain version without counting; ``meta`` takes
    the meta entry (shapes; no launch counted, and an op profiler records
    the call on the card's route); a device with no entry in the
    dispatch table raises before any work."""
    b, s, h, d = 1, 3, 2, 16
    q = torch.zeros((b, s, h, d))
    gates = torch.zeros((b, s, h))
    state = (torch.zeros((b, h, d, d)), torch.zeros((b, h, d)),
             torch.full((b, h), -1e30))
    kernels.reset_launch_counts()
    out, C, n, m = mlstm_ops.mlstm(q, q, q, gates, gates, *state, 0.25)
    assert out.shape == q.shape and C.shape == (b, h, d, d)
    assert kernels.launch_counts() == NO_LAUNCHES
    meta = q.to("meta")
    with OpProfiler() as prof:
        out = mlstm_ops.mlstm(meta, meta, meta, gates.to("meta"),
                              gates.to("meta"),
                              *(t.to("meta") for t in state), 0.25)
    assert [t.shape for t in out] == [q.shape, (b, h, d, d), (b, h, d),
                                      (b, h)]
    assert all(t.device.type == "meta" for t in out)
    assert kernels.launch_counts() == NO_LAUNCHES
    assert prof.profile.kernels["mlstm_chunk"]["simt"]["calls"] == 1
    other = OtherDevice(q)
    with pytest.raises(ValueError, match="mlstm: unsupported device mps"):
        mlstm_ops.mlstm(other, other, other, gates, gates, *state, 0.25)


def _chain_args():
    """CPU operands of the chain DP: 2 scenarios, 3 source slots, the
    small problem's tables; and its layer count."""
    from repro_torch.core.batch import chain_dp_tables
    ch, devs, mc = _problem()
    U = len(devs)
    t = chain_dp_tables([x.flops for x in mc.layers],
                        [x.weight_bytes for x in mc.layers],
                        [x.act_bits for x in mc.layers], mc.input_bits,
                        [d.mem_cap for d in devs],
                        [d.compute_cap for d in devs],
                        [d.throughput for d in devs], order=tuple(range(U)),
                        device=torch.device("cpu"))
    rate = torch.full((2, U, U), 1e6)
    rate[:, torch.arange(U), torch.arange(U)] = float("inf")
    args = (rate, torch.zeros((2, 3), dtype=torch.int64),
            torch.ones((2, U), dtype=torch.bool), t.order_arr, t.prev_dev,
            t.bits_in, t.input_bits, t.ct, t.ok)
    return args, len(mc.layers)


def test_chain_dp_dispatch_raises_on_an_unsupported_device():
    """The chain DP's dispatcher: CPU tensors take ``chain_dp_ref``
    without counting a launch on either route; ``meta`` takes the meta
    entry (no launch counted; an op profiler records the call on the
    ``fused`` route); a device with no entry in the dispatch table raises
    before any work."""
    args, L = _chain_args()
    kernels.reset_launch_counts()
    assign, latency = chain_dp(*args)
    assert assign.shape == (2, 3, L) and latency.shape == (2, 3)
    assert kernels.launch_counts() == NO_LAUNCHES
    assert kernels.route_counts()["tropical_dp"] == {"fused": 0, "step": 0}
    with OpProfiler() as prof:
        assign, latency = chain_dp(*(a.to("meta") for a in args))
    assert assign.shape == (2, 3, L) and assign.device.type == "meta"
    assert kernels.launch_counts() == NO_LAUNCHES
    assert kernels.route_counts()["tropical_dp"] == {"fused": 0, "step": 0}
    assert prof.profile.kernels["tropical_dp"]["fused"]["calls"] == 1
    with pytest.raises(ValueError, match="chain_dp: unsupported device mps"):
        chain_dp(OtherDevice(args[0]), *args[1:])


@pytest.mark.parametrize("script", FIGURES)
def test_figure_scripts_default_to_the_card(monkeypatch, script):
    """A figure script run without ``--device`` raises without CUDA
    before it prints a row; ``--device cpu`` is the only way to the
    plain path."""
    import contextlib
    import importlib
    import io
    _no_cuda(monkeypatch)
    mod = importlib.import_module(f"benchmarks.{script}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--smoke"])
    assert out.getvalue() == ""


def test_serving_layers_without_device_raise(monkeypatch):
    """``PeriodicReplanner`` over a default engine and a rollout-backed
    ``StreamingGateway`` cannot be built without CUDA unless their engine
    and rollout were built for the CPU; built so, they run there."""
    from repro_torch.core.positions import hex_init
    from repro_torch.runtime.gateway import GatewayConfig, StreamingGateway
    from repro_torch.runtime.scenario_engine import (PlanFnCache,
                                                     ScenarioGenerator)
    from repro_torch.runtime.serve_loop import PeriodicReplanner
    _no_cuda(monkeypatch)
    ch, devs, mc = _problem()
    base = hex_init(4, 40.0, jitter=0.5, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        PeriodicReplanner(ScenarioEngine(ch, devs, mc),
                          ScenarioGenerator(base))
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingGateway(FleetRollout(ch, devs, mc, RolloutSpec(frames=2)),
                         base)
    cache = PlanFnCache()
    rp = PeriodicReplanner(ScenarioEngine(ch, devs, mc, plan_cache=cache,
                                          device="cpu"),
                           ScenarioGenerator(base), n_scenarios=2)
    assert rp.tick(0) and np.isfinite(rp.nominal_latency)
    gw = StreamingGateway(FleetRollout(ch, devs, mc, RolloutSpec(frames=2),
                                       plan_cache=cache, device="cpu"),
                          base, GatewayConfig(window_frames=2))
    try:
        gw.submit(0, 10.0)
        assert gw.serve(None, n_windows=1)["served"] == 1
    finally:
        gw.close()
    assert kernels.launch_counts() == NO_LAUNCHES


def test_cpu_training_takes_the_plain_path_without_counting():
    """A loss and its gradient on CPU tensors go through the flash
    Function's plain versions: no kernel counter moves."""
    cfg = get_arch("minicpm-2b").reduced()
    lm = build_model(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    for t in (params["embed"]["table"], params["layers"][0]["attn"]["wq"]):
        t.requires_grad_(True)
    toks = torch.zeros((1, 6), dtype=torch.long)
    kernels.reset_launch_counts()
    lm.train_loss(params, toks, toks).backward()
    assert params["layers"][0]["attn"]["wq"].grad is not None
    assert kernels.launch_counts() == NO_LAUNCHES


def test_cpu_xlstm_training_takes_the_plain_path_without_counting():
    """xLSTM's loss and gradient on CPU tensors go through the mLSTM
    Function's plain versions (and the sLSTM's torch loop): every mLSTM
    weight gets a gradient, no kernel counter moves."""
    cfg = get_arch("xlstm-350m").reduced()
    lm = build_model(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    cells = [p["cell"] for p, k in zip(params["layers"], lm.kinds)
             if k == "mlstm"]
    for c in cells:
        c["wq"].requires_grad_(True)
    toks = torch.zeros((1, 6), dtype=torch.long)
    kernels.reset_launch_counts()
    lm.train_loss(params, toks, toks).backward()
    assert cells and all(c["wq"].grad is not None for c in cells)
    assert kernels.launch_counts() == NO_LAUNCHES


def test_train_example_defaults_to_the_card(monkeypatch):
    """``examples/torch_train_lm.py`` without ``--device`` raises without
    CUDA before it prints a line."""
    import contextlib
    import importlib.util
    import io
    _no_cuda(monkeypatch)
    path = os.path.join(ROOT, "examples", "torch_train_lm.py")
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--steps", "1"])
    assert out.getvalue() == ""


@pytest.mark.parametrize("mode", [[], ["--chaos"], ["--stream"]])
def test_serve_swarm_example_defaults_to_the_card(monkeypatch, mode):
    """``examples/torch_serve_swarm.py`` without ``--device`` raises
    without CUDA before it prints a line, in every mode."""
    import contextlib
    import importlib.util
    import io
    _no_cuda(monkeypatch)
    path = os.path.join(ROOT, "examples", "torch_serve_swarm.py")
    spec = importlib.util.spec_from_file_location("torch_serve_swarm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            pytest.raises(RuntimeError, match="CUDA"):
        mod.main(mode)
    assert out.getvalue() == ""


def test_cuda_mesh_without_cuda_raises(monkeypatch):
    """A rollout sharded over CUDA devices cannot be built without CUDA,
    even on a CPU engine: the mesh never falls back."""
    from repro_torch.parallel.sharding import fleet_mesh
    _no_cuda(monkeypatch)
    ch, devs, mc = _problem()
    with pytest.raises(ValueError, match="CUDA device"):
        FleetRollout(ch, devs, mc, RolloutSpec(frames=2), device="cpu",
                     mesh_devices=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetRollout(ch, devs, mc, RolloutSpec(frames=2), device="cpu",
                     mesh_devices=[torch.device("cuda", 0)] * 2)
    with pytest.raises(ValueError, match="CUDA device"):
        fleet_mesh()
