"""The port's op profiler (``launch.op_analysis``) against graphs with
known costs and against the reference's HLO profiler
(``repro.launch.hlo_analysis``) on the same shapes; the kernels' ``meta``
entries against their plain versions.

The reference's side runs in one subprocess that sets the fake device
count before importing ``jax`` (its psum case needs 4 devices): the dot
FLOPs of one matmul, a 10-step scan and a 3 x 5 nested scan, the traffic
of ``x * 2 + 1`` on a 1024^2 float32, and the all-reduce a ``psum`` over
4 devices compiles to.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.launch.op_analysis import OpProfiler, profile  # noqa: E402
from repro_torch.kernels.work import KERNEL_WORK  # noqa: E402
from repro_torch.launch.roofline import build_roofline  # noqa: E402
from repro_torch.parallel import sharding as t_sh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

SCRIPT = textwrap.dedent('''
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.launch.hlo_analysis import profile
    from repro.parallel.sharding import shard_map_compat

    def text(fn, *args):
        return jax.jit(fn).lower(*args).compile().as_text()

    out = {}
    a, b = jnp.zeros((128, 256)), jnp.zeros((256, 512))
    out["matmul"] = profile(text(lambda a, b: a @ b, a, b)).dot_flops

    def scan(w, x):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=10)[0]
    out["scan"] = profile(text(scan, jnp.zeros((64, 64)),
                               jnp.zeros((8, 64)))).dot_flops

    def nested(w, x):
        def outer(c, _):
            def inner(ci, _):
                return ci @ w, None
            return jax.lax.scan(inner, c, None, length=5)[0], None
        return jax.lax.scan(outer, x, None, length=3)[0]
    out["nested"] = profile(text(nested, jnp.zeros((32, 32)),
                                 jnp.zeros((4, 32)))).dot_flops
    out["traffic"] = profile(text(lambda x: x * 2.0 + 1.0,
                                  jnp.zeros((1024, 1024)))).traffic_bytes

    mesh = jax.make_mesh((4,), ("data",), axis_types=(
        jax.sharding.AxisType.Auto,))
    fn = shard_map_compat(lambda x: jax.lax.psum(x, "data"), mesh,
                          (P("data"),), P())
    prof = profile(text(fn, jnp.zeros((4 * 96,))))
    out["coll_bytes"], out["coll_count"] = prof.coll_bytes, prof.coll_count
    print(json.dumps(out))
''')


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _matmul():
    a, b = torch.zeros(128, 256), torch.zeros(256, 512)
    return profile(lambda: a @ b)


def _scan():
    w, x = torch.zeros(64, 64), torch.zeros(8, 64)

    def fn():
        c = x
        for _ in range(10):
            c = torch.tanh(c @ w)
        return c
    return profile(fn)


def _nested():
    w, x = torch.zeros(32, 32), torch.zeros(4, 32)

    def fn():
        c = x
        for _ in range(3):
            for _ in range(5):
                c = c @ w
        return c
    return profile(fn)


@pytest.mark.parametrize("case,run,want", [
    ("matmul", _matmul, 2 * 128 * 256 * 512),
    ("scan", _scan, 10 * 2 * 8 * 64 * 64),
    ("nested", _nested, 3 * 5 * 2 * 4 * 32 * 32)])
def test_dot_flops_exact_and_as_the_reference_counts(case, run, want,
                                                     reference):
    prof = run()
    assert prof.dot_flops == want
    assert prof.flops_by_class["fp32"] == want
    assert prof.dot_flops == pytest.approx(reference[case], rel=0.05)


def test_elementwise_traffic(reference):
    x = torch.zeros(1024, 1024)
    prof = profile(lambda: x * 2.0 + 1.0)
    assert prof.traffic_bytes == 16_777_216     # two ops, 4 MB in + out
    assert 4e6 < prof.traffic_bytes < 5e7
    assert 4e6 < reference["traffic"] < 5e7
    assert prof.dot_flops == 0


def test_psum_charged_as_the_references_all_reduce(reference):
    mesh = t_sh.make_mesh((4,), ("data",), [CPU] * 4)
    x = torch.zeros(4 * 96)

    def run():
        blocks = t_sh.run_shards(lambda idx, xs: xs, mesh, [t_sh.P("data")],
                                 x)
        return t_sh.collective(blocks, mesh, "data", t_sh.psum)
    prof = profile(run)
    roof = build_roofline(prof, 0.0, 4)
    assert roof.coll_bytes_by_kind == reference["coll_bytes"]
    assert roof.coll_count_by_kind == reference["coll_count"]
    assert roof.coll_bytes_dev == 2 * 96 * 4 and roof.pod_bytes_dev == 0
    # the host's adds and copies inside the collective are not counted
    assert prof.traffic_bytes == 0
    # over a (2, 2) mesh's both axes one group of 4: the same all-reduce
    pod = t_sh.make_mesh((2, 2), ("pod", "data"), [CPU] * 4)
    prof = profile(lambda: t_sh.collective(
        t_sh.run_shards(lambda idx, xs: xs, pod, [t_sh.P(("pod", "data"))],
                        x), pod, ("pod", "data"), t_sh.pmax))
    assert prof.coll_bytes == {"all-reduce": 4 * 2 * 96 * 4}
    assert prof.coll_count == {"all-reduce": 4}


def test_pmean_and_ppermute_kinds():
    vals = [torch.ones(10) for _ in range(3)]
    prof = profile(lambda: (t_sh.pmean(vals),
                            t_sh.ppermute(vals, [(0, 1), (1, 2)])))
    assert prof.coll_count == {"all-reduce": 3, "collective-permute": 3}
    assert prof.coll_bytes == {"all-reduce": 3 * 80.0,
                               "collective-permute": 3 * 40.0}


def test_peak_tracks_the_blocks_storages_only():
    arg = torch.empty(1024, device="meta")      # an argument: not counted

    def fn():
        x = torch.empty(1024, device="meta")    # 4 KB
        y = x * 2                               # 8 KB live
        del x
        z = y + arg                             # 8 KB again
        v = z.view(32, 32)                      # a view: no storage
        return v
    with OpProfiler("meta") as prof:
        prof.arguments(arg)
        out = fn()
    assert prof.profile.peak_bytes == 8192
    assert prof.live_bytes(out) == (4096, 4096)
    # ops on the host are not the meta program's
    with OpProfiler("meta") as prof:
        torch.ones(100) * 3
        torch.ones(10, device="meta") * 3
    assert prof.profile.traffic_bytes == 40 + 80
    assert prof.profile.peak_bytes == 80


# ---------------------------------------------------------------------------
# the kernels' meta entries
# ---------------------------------------------------------------------------


def _mlstm_operands(rng, b, s, h, d):
    f = lambda *shape: torch.as_tensor(  # noqa: E731
        rng.normal(size=shape), dtype=torch.float32)
    return (f(b, s, h, d), f(b, s, h, d), f(b, s, h, d), f(b, s, h),
            f(b, s, h), f(b, h, d, d), f(b, h, d), f(b, h))


def _entries():
    """(name, plain, meta entry, operands, kwargs, its kernel's
    ``KERNEL_WORK`` name, the card's route) of every meta entry, at small
    shapes."""
    import importlib
    from repro_torch.core.channel import RadioParams

    def mod(k):
        return importlib.import_module(f"repro_torch.kernels.{k}")
    cv, cvr = mod("conv2d.conv2d"), mod("conv2d.ref")
    da, dar = mod("decode_attention.decode_attention"), \
        mod("decode_attention.ref")
    fa, far = mod("flash_attention.flash_attention"), \
        mod("flash_attention.ref")
    lg, lgr = mod("link_geometry.link_geometry"), mod("link_geometry.ref")
    ml, mlr = mod("mlstm_chunk.mlstm_chunk"), mod("mlstm_chunk.ref")
    mm, mmr = mod("moe_matmul.moe_matmul"), mod("moe_matmul.ref")
    rg, rgr = mod("rglru_scan.rglru_scan"), mod("rglru_scan.ref")
    td, tdr = mod("tropical_dp.tropical_dp"), mod("tropical_dp.ref")
    from test_torch_port_guard import _chain_args
    rng = np.random.default_rng(0)
    f = lambda *shape: torch.as_tensor(  # noqa: E731
        rng.normal(size=shape), dtype=torch.float32)
    params = RadioParams()
    q, k = f(2, 4, 9, 16), f(2, 2, 9, 16)
    o, lse = far.attention_fwd_ref(q, k, k)
    ml_args = _mlstm_operands(rng, 2, 5, 2, 16)
    a = torch.sigmoid(f(2, 7, 8))
    h, _ = rgr.rglru_ref(a, f(2, 7, 8), f(2, 8))
    return [
        ("link_geometry", lgr.link_geometry_ref, lg.link_geometry_meta,
         (f(2, 5, 2) * 50, torch.ones(2, 5, dtype=torch.bool), None),
         dict(params=params), "link_geometry", None),
        ("tropical_dp", tdr.chain_dp_ref, td.tropical_dp_chain_meta,
         _chain_args()[0], {}, "tropical_dp", "fused"),
        ("conv2d", cvr.matmul_ref, cv.matmul_bias_act_meta,
         (f(10, 12), f(12, 6), f(6)), {}, "conv2d", "wgmma"),
        ("flash_attention", far.attention_ref, fa.flash_attention_meta,
         (q, k, k), dict(causal=True, window=4, cap=50.0),
         "flash_attention", "simt"),
        ("flash_attention_lse", far.attention_fwd_ref,
         lambda *t, **kw: fa.flash_attention_meta(*t, with_lse=True, **kw),
         (q, k, k), {}, "flash_attention", "simt"),
        ("flash_attention_bwd", far.attention_bwd_ref,
         fa.flash_attention_bwd_meta, (q, k, k, o, lse, f(2, 4, 9, 16)), {},
         "flash_attention_bwd", "simt"),
        ("decode_attention", dar.decode_ref, da.decode_attention_meta,
         (f(2, 2, 2, 16), k, k, torch.tensor([3, 8], dtype=torch.int32)),
         dict(cap=30.0), "decode_attention", None),
        ("moe_matmul", mmr.moe_matmul_ref, mm.moe_matmul_meta,
         (f(3, 5, 8), f(3, 8, 16)), {}, "moe_matmul", "simt"),
        ("moe_matmul_dx", mmr.moe_matmul_dx_ref, mm.moe_matmul_dx_meta,
         (f(3, 5, 16), f(3, 8, 16)), {}, "moe_matmul_dx", "simt"),
        ("moe_matmul_dw", mmr.moe_matmul_dw_ref, mm.moe_matmul_dw_meta,
         (f(3, 5, 8), f(3, 5, 16)), {}, "moe_matmul_dw", "simt"),
        ("rglru_scan", rgr.rglru_ref, rg.rglru_scan_meta,
         (a, f(2, 7, 8), f(2, 8)), {}, "rglru_scan", "tma"),
        ("rglru_scan_bwd", rgr.rglru_bwd_ref, rg.rglru_scan_bwd_meta,
         (a, h, f(2, 8), f(2, 7, 8), f(2, 8)), {}, "rglru_scan_bwd",
         "tma"),
        ("mlstm_chunk", mlr.mlstm_chunk_ref, ml.mlstm_chunk_meta,
         ml_args + (0.25,), {}, "mlstm_chunk", "simt"),
        ("mlstm_chunk_bwd", mlr.mlstm_chunk_bwd_ref, ml.mlstm_chunk_bwd_meta,
         ml_args + (0.25, f(2, 5, 2, 16)), {}, "mlstm_chunk_bwd",
         "simt"),
        ("mlstm_decode_block", mlr.mlstm_decode_block_ref,
         ml.mlstm_decode_block_meta,
         (f(2, 1, 2, 4), f(2, 1, 2, 4), f(2, 1, 2, 16), f(2, 1, 2),
          f(2, 1, 2), f(2, 2, 4, 16), f(2, 2, 4), f(2, 2), 0.25), {},
         "mlstm_decode_block", "decode_block"),
    ]


ENTRIES = [e[0] for e in _entries()]


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if isinstance(x, tuple):
        return tuple(_to_meta(v) for v in x)
    return x


def _specs(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in outs]


@pytest.mark.parametrize("name", ENTRIES)
def test_meta_entry_shapes_dtypes_and_launch(name):
    """Each ``meta`` entry's outputs have the plain version's shapes and
    dtypes and lie on ``meta`` (no arithmetic); it launches nothing, so
    no launch counter moves (they count the card's launches only); the
    route the card takes for these operands is its ``KERNEL_WORK``'s."""
    _, plain, meta_fn, args, kw, kernel, route = \
        next(e for e in _entries() if e[0] == name)
    want = plain(*args, **kw)
    kernels.reset_launch_counts()
    got = meta_fn(*_to_meta(args), **kw)
    assert _specs(got) == _specs(want)
    assert all(t.device.type == "meta" for t in
               (got if isinstance(got, tuple) else (got,)))
    assert not any(kernels.launch_counts().values())
    assert not any(c for routes in kernels.route_counts().values()
                   for c in routes.values())
    work_kw = {k: v for k, v in kw.items() if k != "params"}
    assert KERNEL_WORK[kernel](*_to_meta(args), **work_kw).route == route


def test_mlstm_backward_workspace_matches_the_launchers_layout():
    """The backward's meta workspace is ``bwd_workspace_bytes``, the
    launcher's layout transcribed: the sections at a ragged shape on
    each route, summed by hand."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import \
        bwd_workspace_bytes
    b, s, h, d = 2, 100, 3, 96          # NC 2; NT 2 (wgmma), 3 (simt)
    bh, nc = b * h, 2
    r4 = lambda n: -(-n // 4) * 4       # noqa: E731
    common = [bh * s] * 5 + [bh * nc] * 4 + [bh * nc * d] * 2
    wg = common + [bh * nc * 4, bh * 4, bh * nc * 4 * 64] + \
        [bh * nc * 128 * 128 // 2] * 4
    simt = common + [bh * nc * 9, bh * 9] + [bh * nc * d * d] * 2
    assert bwd_workspace_bytes(b, s, h, d, "wgmma") == \
        4 * sum(r4(n) for n in wg)
    assert bwd_workspace_bytes(b, s, h, d, "simt") == \
        4 * sum(r4(n) for n in simt)


def _public_calls(device):
    """name -> a public entry's call on seeded operands on ``device``
    (the training ones through their autograd Functions' backward)."""
    from repro_torch.core.channel import RadioParams
    from repro_torch.kernels.conv2d.ops import conv2d
    from repro_torch.kernels.decode_attention.ops import decode_mha
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.link_geometry.ops import fused_link_geometry
    from repro_torch.kernels.mlstm_chunk.ops import mlstm
    from repro_torch.kernels.moe_matmul.ops import expert_gemm
    from repro_torch.kernels.rglru_scan.ops import linear_recurrence
    from repro_torch.kernels.tropical_dp.ops import chain_dp
    from test_torch_port_guard import _chain_args
    rng = np.random.default_rng(1)

    def f(*shape, grad=False, fn=None):
        t = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
        t = (t if fn is None else fn(t)).to(device)
        return t.requires_grad_(grad)

    def backward(fn, *ts):
        def run():
            out = fn(*ts)
            out = out if isinstance(out, tuple) else (out,)
            sum(o.float().sum() for o in out).backward()
        return run
    params = RadioParams()
    pos = f(2, 5, 2, fn=lambda t: t * 50)
    chain = [t.to(device) for t in _chain_args()[0]]
    conv = (f(2, 9, 9, 3), f(3, 3, 3, 5), f(5))
    attn = (f(2, 9, 4, 16), f(2, 9, 2, 16), f(2, 9, 2, 16))
    dec = (f(2, 1, 4, 16), f(2, 9, 2, 16), f(2, 9, 2, 16),
           torch.tensor([3, 8], dtype=torch.int32, device=device))
    qk = (f(2, 9, 4, 16, grad=True), f(2, 9, 2, 16, grad=True))
    xw = (f(3, 5, 8, grad=True), f(3, 8, 16, grad=True))
    rec = (f(2, 7, 8, grad=True, fn=torch.sigmoid), f(2, 7, 8, grad=True),
           f(2, 8, grad=True))
    ml = tuple(t.to(device).requires_grad_()
               for t in _mlstm_operands(rng, 2, 5, 2, 16))
    return {
        "link_geometry": lambda: fused_link_geometry(pos, params),
        "chain_dp": lambda: chain_dp(*chain),
        "conv2d": lambda: conv2d(*conv, stride=2, padding=1),
        "mha": lambda: mha(*attn, window=4),
        "mha_train": backward(lambda q, k: mha(q, k, k), *qk),
        "decode_mha": lambda: decode_mha(*dec),
        "expert_gemm_train": backward(expert_gemm, *xw),
        "linear_recurrence_train": backward(linear_recurrence, *rec),
        "mlstm_train": backward(lambda *t: mlstm(*t, 0.25)[0], *ml),
    }


@pytest.mark.parametrize("name", list(_public_calls(CPU)))
def test_public_entries_count_their_kernels_alike_on_cpu_and_meta(name):
    """Inside a kernel's public entry (its autograd Function's passes
    included) nothing but the kernel call is counted, so the CPU's plain
    version and the ``meta`` entry give the same counts: the calls by
    name and route with their ``KERNEL_WORK``, and the ops around them."""
    cpu = profile(_public_calls(CPU)[name])
    meta = profile(_public_calls(torch.device("meta"))[name], device="meta")
    assert cpu.kernels, name
    assert meta.counts() == cpu.counts()


def test_kernel_work_is_what_the_profile_records():
    from repro_torch.kernels.moe_matmul.ops import expert_gemm
    x, w = torch.zeros(3, 5, 8), torch.zeros(3, 8, 16)
    prof = profile(lambda: expert_gemm(x, w))
    work = KERNEL_WORK["moe_matmul"](x, w)
    assert prof.kernel_calls() == {"moe_matmul": {"simt": {
        "calls": 1, "flops": work.flops, "bytes": work.bytes}}}
    assert prof.flops_by_class["fp32"] == work.flops and \
        prof.kernel_bytes == work.bytes
    assert prof.dot_flops == 0 and prof.traffic_bytes == 0


def test_charge_counts_nothing_without_a_profiler(monkeypatch):
    """With no profiler active a kernel call's charge returns at once:
    no work is counted (a raising work function goes uncalled)."""
    def boom(*args, **kwargs):
        raise AssertionError("work counted with no profiler")
    monkeypatch.setitem(KERNEL_WORK, "moe_matmul", boom)
    from repro_torch.kernels.moe_matmul.ops import expert_gemm
    assert not kernels.PROFILERS
    expert_gemm(torch.ones(1, 2, 4), torch.ones(1, 4, 3))
    with pytest.raises(AssertionError, match="no profiler"):
        profile(lambda: expert_gemm(torch.ones(1, 2, 4),
                                    torch.ones(1, 4, 3)))
