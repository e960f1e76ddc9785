"""The port's kernel build and launch plumbing, on the CPU.

``nvcc`` and the card are absent here, so these tests hold what runs
before a build or a launch: the wrappers reject what their kernels do not
take before touching ``nvcc``, a build is keyed by the source's content
and the shared headers', a missing ``nvcc`` raises, a nonzero launcher
return raises with the CUDA error string, and the two-route kernels
count their launches by route.  The fused chain DP's route, launch plan
and shared-memory layout follow from the shapes alone.
"""
import ctypes

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.channel import RadioParams  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv2d.conv2d import matmul_bias_act  # noqa: E402
from repro_torch.kernels.link_geometry.link_geometry import (  # noqa: E402
    link_geometry, radio_constants)
from repro_torch.kernels.tropical_dp import tropical_dp as tdp  # noqa: E402
from repro_torch.kernels.tropical_dp.tropical_dp import \
    tropical_dp_step  # noqa: E402


def test_sources_are_the_ported_kernels():
    """The planner's two kernels, the CNN path's conv GEMM, the LM
    serving path's two attention kernels, the MoE expert GEMM, the
    RG-LRU scan, the mLSTM chunk and training's backward kernels: flash
    attention's, the expert GEMM's, the RG-LRU scan's and the mLSTM
    chunk's."""
    assert _build.sources() == ("conv2d", "decode_attention",
                                "flash_attention", "flash_attention_bwd",
                                "link_geometry", "mlstm_chunk",
                                "mlstm_chunk_bwd", "moe_matmul",
                                "moe_matmul_bwd", "rglru_scan",
                                "rglru_scan_bwd", "tropical_dp")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_artifact_is_keyed_by_source_content(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build._artifact("k")
    assert _build._artifact("k") == first
    src.write_text("// two\n")
    assert _build._artifact("k") != first
    assert first.parent == tmp_path / "out" and first.suffix == ".so"


def test_artifact_is_keyed_by_shared_headers(tmp_path, monkeypatch):
    """An edit to a ``csrc/*.cuh`` header rebuilds every kernel (each may
    include it); the header is no source of its own."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "j.cu").write_text('#include "h.cuh"\n// j\n')
    alone = {n: _build._artifact(n) for n in "jk"}
    hdr = tmp_path / "h.cuh"
    hdr.write_text("// one\n")
    first = {n: _build._artifact(n) for n in "jk"}
    assert all(first[n] != alone[n] for n in "jk")
    hdr.write_text("// two\n")
    assert all(_build._artifact(n) != first[n] for n in "jk")
    hdr.write_text("// one\n")
    assert {n: _build._artifact(n) for n in "jk"} == first
    assert _build.sources() == ("j", "k")


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_built_library_is_reused_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    (tmp_path / "k.cu").write_text("// k\n")
    (tmp_path / "out").mkdir()
    _build._artifact("k").write_bytes(b"")
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("rebuilt"))
    assert _build.build(["k"]) == {}


def test_failed_launch_raises_with_the_cuda_error_string():
    class Lib:
        repro_cuda_error_string = staticmethod(
            lambda err: b"invalid configuration argument")

    _build.check_launch(Lib, "k", 0)
    with pytest.raises(RuntimeError, match="invalid configuration"):
        _build.check_launch(Lib, "k", 9)


def test_radio_constants_follow_the_reference_formula():
    c = radio_constants(RadioParams())
    p = RadioParams()
    assert (c["h0"], c["noise"], c["p_max"], c["bandwidth"]) == \
        (p.h0, p.noise_watts, p.p_max_watts, p.bandwidth_hz)
    # float32 arguments must stay finite and positive
    assert all(0 < ctypes.c_float(v).value < float("inf")
               for v in c.values())


def test_wrappers_reject_cpu_tensors_before_building():
    pos = torch.zeros((2, 4, 2))
    with pytest.raises(ValueError, match="CUDA float32"):
        link_geometry(pos, torch.ones((2, 4)), None, params=RadioParams())
    dp = torch.zeros((2, 1, 3, 5))
    with pytest.raises(ValueError, match="CUDA"):
        tropical_dp_step(dp, torch.zeros((2, 3, 4, 5)), torch.zeros(2, 1, 4),
                         torch.zeros(3, 4), torch.ones(3, 4))
    with pytest.raises(ValueError, match="CUDA float32"):
        matmul_bias_act(torch.zeros((3, 4)), torch.zeros((4, 5)),
                        torch.zeros(5))


def test_rejections_do_not_count_launches():
    before = (link_geometry.launches, tropical_dp_step.launches,
              matmul_bias_act.launches)
    with pytest.raises(ValueError):
        link_geometry(torch.zeros((1, 2, 2)), torch.ones((1, 2)), None,
                      params=RadioParams())
    with pytest.raises(ValueError):
        tropical_dp_step(torch.zeros((1, 1, 2, 3)), torch.zeros((1, 2, 2, 3)),
                         torch.zeros(1, 1, 2), torch.zeros(2, 2),
                         torch.ones(2, 2))
    with pytest.raises(ValueError):
        matmul_bias_act(torch.zeros((3, 4)), torch.zeros((5, 5)),
                        torch.zeros(5))
    assert (link_geometry.launches, tropical_dp_step.launches,
            matmul_bias_act.launches) == before


def _attn(b=1, h=4, kv=2, s=8, d=32, dtype=torch.float32):
    return (torch.zeros((b, h, s, d), dtype=dtype),
            torch.zeros((b, kv, s, d), dtype=dtype),
            torch.zeros((b, kv, s, d), dtype=dtype))


@pytest.mark.parametrize("case", ["cpu", "head_dim", "dtype", "heads",
                                  "rank"])
def test_flash_attention_rejects_before_building(case):
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    q, k, v = {"cpu": lambda: _attn(), "head_dim": lambda: _attn(d=48),
               "dtype": lambda: _attn(dtype=torch.float16),
               "heads": lambda: _attn(h=3, kv=2),
               "rank": lambda: (torch.zeros((4, 8, 32)),) + _attn()[1:]}[
        case]()
    before = flash_attention.launches
    with pytest.raises(ValueError, match="flash_attention"):
        flash_attention(q, k, v)
    assert flash_attention.launches == before


@pytest.mark.parametrize("case", ["pointer", "stride"])
def test_flash_attention_rejects_bf16_tma_misalignment(case, monkeypatch):
    """The bfloat16 route reads q, k, v by TMA: a data pointer off 16
    bytes, or a (b, head, s) stride off 8 elements, is refused before a
    build, whatever else the operands are."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    monkeypatch.setattr(_build, "load",
                        lambda name: pytest.fail("built before rejecting"))
    q, k, v = _attn(dtype=torch.bfloat16)
    if case == "pointer":
        q = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(
            q.shape)
    else:
        q = torch.zeros(q.shape[:-1] + (q.shape[-1] + 4,),
                        dtype=torch.bfloat16)[..., :q.shape[-1]]
    before = (flash_attention.launches,
              dict(flash_attention.launches_by_route))
    with pytest.raises(ValueError, match="TMA"):
        flash_attention(q, k, v)
    assert (flash_attention.launches,
            flash_attention.launches_by_route) == before


@pytest.mark.parametrize("case", ["pointer", "stride", "broadcast"])
@pytest.mark.parametrize("operand", ["q", "k", "v", "do"])
def test_flash_attention_bwd_rejects_bf16_tma_misalignment(operand, case,
                                                           monkeypatch):
    """The bfloat16 backward (``wgmma`` route) reads q, k, v and dO by
    TMA: a data pointer off 16 bytes, a (b, head, s) stride off 8
    elements or a stride of 0 (a broadcast view, as ``out.sum()``'s
    gradient) is refused before a build, and nothing is counted."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        bwd_route, flash_attention_bwd)
    monkeypatch.setattr(_build, "load",
                        lambda name: pytest.fail("built before rejecting"))
    q, k, v = _attn(dtype=torch.bfloat16)
    ops_ = {"q": q, "k": k, "v": v, "do": torch.zeros_like(q)}
    t = ops_[operand]
    if case == "pointer":
        t = torch.zeros(t.numel() + 4, dtype=torch.bfloat16)[4:].view(
            t.shape)
    elif case == "stride":
        t = torch.zeros(t.shape[:-1] + (t.shape[-1] + 4,),
                        dtype=torch.bfloat16)[..., :t.shape[-1]]
    else:
        t = torch.zeros((), dtype=torch.bfloat16).expand(t.shape)
    ops_[operand] = t
    assert bwd_route(torch.bfloat16) == "wgmma"
    before = (flash_attention_bwd.launches,
              dict(flash_attention_bwd.launches_by_route))
    with pytest.raises(ValueError, match="TMA"):
        flash_attention_bwd(ops_["q"], ops_["k"], ops_["v"],
                            torch.zeros_like(q),
                            torch.zeros(q.shape[:3]), ops_["do"])
    assert (flash_attention_bwd.launches,
            flash_attention_bwd.launches_by_route) == before


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "simt")])
def test_flash_attention_bwd_route_follows_dtype(dtype, route):
    """The backward takes ``wgmma`` for bfloat16 and the SIMT kernel for
    float32 (``wgmma`` has no float32 input).  Only the ``wgmma`` route
    reads by TMA: a q 4 elements off its allocation (8 bytes in bf16, 16
    in float32) is refused as TMA-unreadable in bf16, and reaches the
    device check (a CPU tensor) in float32."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        BWD_ROUTES, bwd_route, flash_attention_bwd)
    assert bwd_route(dtype) == route and route in BWD_ROUTES
    q, k, v = _attn(dtype=dtype)
    off = torch.zeros(q.numel() + 4, dtype=dtype)[4:].view(q.shape)
    with pytest.raises(ValueError, match="TMA" if route == "wgmma"
                       else "must be a CUDA"):
        flash_attention_bwd(off, k, v, q, torch.zeros(q.shape[:3]), q)


@pytest.mark.parametrize("operand", ["x", "w"])
def test_moe_matmul_rejects_bf16_tma_misalignment(operand, monkeypatch):
    """With D and F multiples of 8 the bfloat16 expert GEMM reads x and w
    by TMA: a data pointer off 16 bytes is refused before a build."""
    from repro_torch.kernels.moe_matmul.moe_matmul import moe_matmul
    monkeypatch.setattr(_build, "load",
                        lambda name: pytest.fail("built before rejecting"))
    shapes = {"x": (2, 3, 16), "w": (2, 16, 8)}
    x, w = (torch.zeros(shapes[n], dtype=torch.bfloat16) for n in "xw")
    if operand == "x":
        x = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(
            x.shape)
    else:
        w = torch.zeros(w.numel() + 1, dtype=torch.bfloat16)[1:].view(
            w.shape)
    before = (moe_matmul.launches, dict(moe_matmul.launches_by_route))
    with pytest.raises(ValueError, match="TMA"):
        moe_matmul(x, w)
    assert (moe_matmul.launches, moe_matmul.launches_by_route) == before


def _no_build(monkeypatch):
    for name in ("load", "launcher"):
        monkeypatch.setattr(_build, name, lambda *a: pytest.fail(
            "built before rejecting"))


_BF = torch.bfloat16


def _moe_bwd_args(which, case):
    """The two operands of a bad ``moe_matmul_dx(dy [E, C, F], w [E, D,
    F])`` or ``moe_matmul_dw(x [E, C, D], dy [E, C, F])`` call (D 16,
    F 8), and the message it raises with."""
    shapes = {"dx": [(2, 3, 8), (2, 16, 8)], "dw": [(2, 3, 16), (2, 3, 8)]}
    dtypes = [torch.float32, torch.float32]
    match = "contiguous CUDA"
    if case == "shape":
        shapes[which][1] = (2, 16, 9) if which == "dx" else (2, 4, 8)
        match = "want"
    elif case == "experts":
        shapes[which] = [(65536, 1, 1), (65536, 1, 1)]
        match = "at most 65535"
    elif case == "float64":
        dtypes = [torch.float64, torch.float64]
    elif case in ("mixed", "tma"):
        dtypes = [torch.float32, _BF] if case == "mixed" else [_BF, _BF]
        match = "contiguous CUDA" if case == "mixed" else "TMA"
    first, second = (torch.zeros(s, dtype=d)
                     for s, d in zip(shapes[which], dtypes))
    if case == "strided":
        first = torch.zeros(first.shape[::-1]).permute(2, 1, 0)
    elif case == "tma":
        first = torch.zeros(first.numel() + 1, dtype=_BF)[1:].view(
            first.shape)
    return first, second, match


@pytest.mark.parametrize("case", ["shape", "experts", "cpu", "float64",
                                  "mixed", "strided", "tma"])
@pytest.mark.parametrize("which", ["dx", "dw"])
def test_moe_matmul_bwd_wrappers_reject_before_building(which, case,
                                                        monkeypatch):
    """``moe_matmul_dx(dy, w)`` and ``moe_matmul_dw(x, dy)`` take the
    forward's checks: shapes, at most 65,535 experts, contiguous CUDA
    float32 or bfloat16 of one dtype, and bfloat16 data on 16 bytes where
    D and F are multiples of 8; each refusal comes before a build and
    counts nothing."""
    from repro_torch.kernels.moe_matmul import moe_matmul as mm
    _no_build(monkeypatch)
    first, second, match = _moe_bwd_args(which, case)
    fn = mm.moe_matmul_dx if which == "dx" else mm.moe_matmul_dw
    before = (fn.launches, dict(fn.launches_by_route))
    with pytest.raises(ValueError, match=match):
        fn(first, second)
    assert (fn.launches, fn.launches_by_route) == before


@pytest.mark.parametrize("dtype,d,f,route", [
    (_BF, 1024, 512, "wgmma"), (_BF, 512, 1024, "wgmma"),
    (_BF, 16, 8, "wgmma"), (_BF, 200, 72, "wgmma"), (_BF, 100, 36, "simt"),
    (_BF, 16, 36, "simt"), (_BF, 36, 16, "simt"),
    (torch.float32, 1024, 512, "simt"), (torch.float32, 16, 8, "simt")])
@pytest.mark.parametrize("which", ["dx", "dw"])
def test_moe_matmul_bwd_route_follows_dtype_and_widths(which, dtype, d, f,
                                                       route, monkeypatch):
    """dX and dW take ``wgmma`` for bfloat16 with D and F multiples of 8
    and the SIMT kernel for float32 or D or F off 8, the forward's rule.
    Only the ``wgmma`` route reads by TMA: a first operand one element
    off its allocation is refused as TMA-unreadable there, and reaches
    the device check (a CPU tensor) on ``simt``."""
    from repro_torch.kernels.moe_matmul import moe_matmul as mm
    assert mm.bwd_route(dtype, d, f) == route and route in mm.BWD_ROUTES
    _no_build(monkeypatch)
    first = (2, 3, f) if which == "dx" else (2, 3, d)
    second = (2, d, f) if which == "dx" else (2, 3, f)
    n = torch.Size(first).numel()
    off = torch.zeros(n + 1, dtype=dtype)[1:].view(first)
    fn = mm.moe_matmul_dx if which == "dx" else mm.moe_matmul_dw
    with pytest.raises(ValueError, match="TMA" if route == "wgmma"
                       else "contiguous CUDA"):
        fn(off, torch.zeros(second, dtype=dtype))


@pytest.mark.parametrize("case", ["shape", "dhT", "batch", "cpu", "dtype",
                                  "strided"])
def test_rglru_scan_bwd_rejects_before_building(case, monkeypatch):
    """``rglru_scan_bwd(a, h, h0, dh, dhT)``: a, h, dh [B, T, W] of one
    dtype and h0, dhT [B, W] of one dtype, contiguous CUDA float32 or
    bfloat16, B at most 65,535; each refusal comes before a build and
    counts nothing."""
    from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan_bwd
    _no_build(monkeypatch)
    a, h0 = torch.zeros((2, 5, 8)), torch.zeros((2, 8))
    args = {"a": a, "h": a, "h0": h0, "dh": a, "dhT": h0}
    match = "contiguous CUDA"
    if case == "shape":
        args["dh"], match = torch.zeros((2, 4, 8)), "want"
    elif case == "dhT":
        args["dhT"], match = torch.zeros((2, 7)), "want"
    elif case == "batch":
        a = torch.zeros((65536, 1, 1))
        args = dict(a=a, h=a, h0=torch.zeros((65536, 1)), dh=a, dhT=None)
        match = "at most 65535"
    elif case == "dtype":
        args["h"] = a.to(_BF)
    elif case == "strided":
        args["dh"] = torch.zeros((2, 8, 5)).transpose(1, 2)
    before = (rglru_scan_bwd.launches,
              dict(rglru_scan_bwd.launches_by_route))
    with pytest.raises(ValueError, match=match):
        rglru_scan_bwd(**args)
    assert (rglru_scan_bwd.launches,
            rglru_scan_bwd.launches_by_route) == before


def test_route_counts_reset_with_the_launch_counts():
    """The expert GEMM, prefill attention and its backward, the conv GEMM,
    the RG-LRU scan, the mLSTM chunk, the chain DP and the expert GEMM's,
    RG-LRU scan's and mLSTM chunk's backward kernels count launches by
    route beside their totals; one reset clears both."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_bwd)
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (
        mlstm_chunk, mlstm_chunk_bwd, mlstm_decode_block)
    from repro_torch.kernels.moe_matmul.moe_matmul import (
        moe_matmul, moe_matmul_dw, moe_matmul_dx)
    from repro_torch.kernels.rglru_scan.rglru_scan import (rglru_scan,
                                                           rglru_scan_bwd)
    saved = [(f, f.launches, dict(f.launches_by_route))
             for f in (flash_attention, flash_attention_bwd, moe_matmul,
                       matmul_bias_act, rglru_scan, mlstm_chunk,
                       tdp.tropical_dp_chain, moe_matmul_dx, moe_matmul_dw,
                       rglru_scan_bwd, mlstm_chunk_bwd, mlstm_decode_block)]
    try:
        mlstm_decode_block.launches = 3
        mlstm_decode_block.launches_by_route["decode_block"] = 3
        mlstm_chunk_bwd.launches = 13
        mlstm_chunk_bwd.launches_by_route.update(wgmma=12, simt=1)
        moe_matmul_dx.launches = 73
        moe_matmul_dx.launches_by_route.update(wgmma=72, simt=1)
        moe_matmul_dw.launches = 71
        moe_matmul_dw.launches_by_route.update(wgmma=70, simt=1)
        rglru_scan_bwd.launches = 6
        rglru_scan_bwd.launches_by_route.update(tma=5, simt=1)
        moe_matmul.launches = 3
        moe_matmul.launches_by_route.update(wgmma=2, simt=1)
        flash_attention.launches_by_route["wgmma"] = 5
        flash_attention_bwd.launches = 9
        flash_attention_bwd.launches_by_route.update(simt=7, wgmma=2)
        matmul_bias_act.launches = 4
        matmul_bias_act.launches_by_route.update(wgmma=3, simt=1)
        rglru_scan.launches = 27
        rglru_scan.launches_by_route.update(tma=26, simt=1)
        mlstm_chunk.launches = 25
        mlstm_chunk.launches_by_route.update(wgmma=12, decode=12, simt=1)
        tdp.tropical_dp_chain.launches = 32
        tdp.tropical_dp_chain.launches_by_route.update(fused=32, step=11)
        counts = kernels.route_counts()
        assert counts == {"flash_attention": {"simt": 0, "wgmma": 5},
                          "flash_attention_bwd": {"simt": 7, "wgmma": 2},
                          "moe_matmul": {"simt": 1, "wgmma": 2},
                          "conv2d": {"simt": 1, "wgmma": 3},
                          "rglru_scan": {"simt": 1, "tma": 26},
                          "mlstm_chunk": {"simt": 1, "wgmma": 12,
                                          "decode": 12},
                          "tropical_dp": {"fused": 32, "step": 11},
                          "moe_matmul_dx": {"simt": 1, "wgmma": 72},
                          "moe_matmul_dw": {"simt": 1, "wgmma": 70},
                          "rglru_scan_bwd": {"simt": 1, "tma": 5},
                          "mlstm_chunk_bwd": {"simt": 1, "wgmma": 12},
                          "mlstm_decode_block": {"decode_block": 3}}
        kernels.reset_launch_counts()
        assert kernels.route_counts() == {
            "flash_attention": {"simt": 0, "wgmma": 0},
            "flash_attention_bwd": {"simt": 0, "wgmma": 0},
            "moe_matmul": {"simt": 0, "wgmma": 0},
            "conv2d": {"simt": 0, "wgmma": 0},
            "rglru_scan": {"simt": 0, "tma": 0},
            "mlstm_chunk": {"simt": 0, "wgmma": 0, "decode": 0},
            "tropical_dp": {"fused": 0, "step": 0},
            "moe_matmul_dx": {"simt": 0, "wgmma": 0},
            "moe_matmul_dw": {"simt": 0, "wgmma": 0},
            "rglru_scan_bwd": {"simt": 0, "tma": 0},
            "mlstm_chunk_bwd": {"simt": 0, "wgmma": 0},
            "mlstm_decode_block": {"decode_block": 0}}
        assert kernels.launch_counts()["moe_matmul"] == 0
        assert kernels.launch_counts()["moe_matmul_dx"] == 0
        assert kernels.launch_counts()["moe_matmul_dw"] == 0
        assert kernels.launch_counts()["rglru_scan_bwd"] == 0
        assert kernels.launch_counts()["flash_attention_bwd"] == 0
        assert kernels.launch_counts()["conv2d"] == 0
        assert kernels.launch_counts()["rglru_scan"] == 0
        assert kernels.launch_counts()["mlstm_chunk"] == 0
        assert kernels.launch_counts()["mlstm_chunk_bwd"] == 0
        assert kernels.launch_counts()["mlstm_decode_block"] == 0
        assert kernels.launch_counts()["tropical_dp"] == 0
    finally:
        for f, n, routes in saved:
            f.launches = n
            f.launches_by_route.update(routes)


@pytest.mark.parametrize("k,route", [(4, "wgmma"), (364, "wgmma"),
                                     (2400, "wgmma"), (3456, "wgmma"),
                                     (1, "simt"), (17, "simt"),
                                     (363, "simt"), (2401, "simt"),
                                     (0, "simt")])
def test_conv_gemm_route_follows_k(k, route):
    """The conv GEMM takes the wgmma (3xTF32) route where TMA can read x's
    rows (K a multiple of 4), the SIMT route otherwise: by shape, decided
    before any build."""
    from repro_torch.kernels.conv2d.conv2d import gemm_route
    assert gemm_route(k) == route


def test_conv_tile_n_at_alexnets_conv_layers():
    """128-column tiles where they fill a wave of 132 SMs (conv2), 96 at
    conv1's 96 channels, 64 where 128 x 128 tiles would not (conv3-5 at
    a batch of 32: 129 and 86 tiles)."""
    from repro_torch.kernels.conv2d.conv2d import conv_tile_n
    layers = {"conv1": (96800, 96), "conv2": (23328, 256),
              "conv3": (5408, 384), "conv4": (5408, 384),
              "conv5": (5408, 256)}
    want = {"conv1": 96, "conv2": 128, "conv3": 64, "conv4": 64,
            "conv5": 64}
    assert {n: conv_tile_n(m, c, 132) for n, (m, c) in layers.items()} \
        == want
    assert conv_tile_n(1, 33, 132) == 64 and conv_tile_n(1, 257, 132) == 64
    assert conv_tile_n(10 ** 6, 257, 132) == 128


@pytest.mark.parametrize("k", [4, 2400])
def test_matmul_bias_act_rejects_tma_misalignment(k, monkeypatch):
    """With K a multiple of 4 the conv GEMM reads x by TMA: x whose data is
    off 16 bytes is refused before a build and counts no launch."""
    monkeypatch.setattr(_build, "load",
                        lambda name: pytest.fail("built before rejecting"))
    x = torch.zeros(3 * k + 1)[1:].view(3, k)
    before = (matmul_bias_act.launches,
              dict(matmul_bias_act.launches_by_route))
    with pytest.raises(ValueError, match="TMA"):
        matmul_bias_act(x, torch.zeros((k, 5)), torch.zeros(5))
    assert (matmul_bias_act.launches,
            matmul_bias_act.launches_by_route) == before


def test_matmul_bias_act_simt_route_takes_any_alignment(monkeypatch):
    """K not a multiple of 4 goes to the SIMT route, which reads x with
    plain loads: an x off 16 bytes is not refused for alignment (here it
    is refused only for lying on the CPU), and nothing is built."""
    monkeypatch.setattr(_build, "load",
                        lambda name: pytest.fail("built before rejecting"))
    x = torch.zeros(3 * 17 + 1)[1:].view(3, 17)
    before = dict(matmul_bias_act.launches_by_route)
    with pytest.raises(ValueError, match="CUDA float32"):
        matmul_bias_act(x, torch.zeros((17, 5)), torch.zeros(5))
    assert matmul_bias_act.launches_by_route == before


@pytest.mark.parametrize("b,kv,s", [(8, 8, 4096), (8, 1, 2048),
                                    (1, 8, 8192), (8, 16, 2048),
                                    (3, 2, 37), (1, 1, 1), (2, 2, 48),
                                    (64, 8, 100), (1, 1, 10 ** 7)])
def test_decode_splits_cover_the_cache(b, kv, s):
    """The splits [j L, min((j + 1) L, S)) cover [0, S) exactly, each
    non-empty; none shorter than MIN_SPLIT unless the whole cache is; the
    grid's y extent holds them."""
    from repro_torch.kernels.decode_attention.decode_attention import (
        MAX_SPLITS, MIN_SPLIT, decode_splits)
    n, length = decode_splits(b, kv, s, 132)
    assert 1 <= n <= MAX_SPLITS
    bounds = [(j * length, min((j + 1) * length, s)) for j in range(n)]
    assert bounds[0][0] == 0 and bounds[-1][1] == s
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))
    assert length >= MIN_SPLIT or n == 1


@pytest.mark.parametrize("name,b,kv,s", [("gemma2-9b", 8, 8, 4096),
                                         ("recurrentgemma-9b", 8, 1, 2048)])
def test_decode_splits_fill_two_waves(name, b, kv, s):
    """At the served decode shapes the (B KV) x splits blocks fill at
    least two waves of an H100's 132 SMs."""
    from repro_torch.kernels.decode_attention.decode_attention import \
        decode_splits
    n, _ = decode_splits(b, kv, s, 132)
    assert b * kv * n >= 2 * 132


@pytest.mark.parametrize("case", ["cpu", "group", "head_dim", "pos"])
def test_decode_attention_rejects_before_building(case):
    from repro_torch.kernels.decode_attention.decode_attention import \
        decode_attention
    g, d = {"group": (17, 32), "head_dim": (2, 24)}.get(case, (2, 32))
    q = torch.zeros((2, 2, g, d))
    k = torch.zeros((2, 2, 16, d))
    pos = torch.zeros(2, dtype=torch.int64 if case == "pos" else torch.int32)
    before = decode_attention.launches
    with pytest.raises(ValueError, match="decode_attention"):
        decode_attention(q, k, k, pos)
    assert decode_attention.launches == before


@pytest.mark.parametrize("case", ["cpu", "rank", "inner", "dtype", "mixed"])
def test_moe_matmul_rejects_before_building(case):
    from repro_torch.kernels.moe_matmul.moe_matmul import moe_matmul
    x, w = {"cpu": lambda: (torch.zeros((2, 3, 4)), torch.zeros((2, 4, 5))),
            "rank": lambda: (torch.zeros((3, 4)), torch.zeros((2, 4, 5))),
            "inner": lambda: (torch.zeros((2, 3, 4)), torch.zeros((2, 6, 5))),
            "dtype": lambda: (torch.zeros((2, 3, 4), dtype=torch.float16),
                              torch.zeros((2, 4, 5), dtype=torch.float16)),
            "mixed": lambda: (torch.zeros((2, 3, 4)),
                              torch.zeros((2, 4, 5), dtype=torch.bfloat16)),
            }[case]()
    before = moe_matmul.launches
    with pytest.raises(ValueError, match="moe_matmul"):
        moe_matmul(x, w)
    assert moe_matmul.launches == before


@pytest.mark.parametrize("case", ["cpu", "shape", "h0", "dtype"])
def test_rglru_scan_rejects_before_building(case):
    from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan
    a = torch.zeros((2, 5, 8))
    b, h0 = torch.zeros((2, 5, 8)), torch.zeros((2, 8))
    if case == "shape":
        b = torch.zeros((2, 4, 8))
    elif case == "h0":
        h0 = torch.zeros((2, 7))
    elif case == "dtype":
        a = b = torch.zeros((2, 5, 8), dtype=torch.float64)
    before = rglru_scan.launches
    with pytest.raises(ValueError, match="rglru_scan"):
        rglru_scan(a, b, h0)
    assert rglru_scan.launches == before


@pytest.mark.parametrize("case", ["cpu", "shape", "state", "head_dim",
                                  "dtype", "empty"])
def test_mlstm_chunk_rejects_before_building(case, monkeypatch):
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import mlstm_chunk
    monkeypatch.setattr(_build, "load",
                        lambda name: pytest.fail("built before rejecting"))
    b, s, h, d = 2, 5, 2, 16
    if case == "head_dim":
        d = 24
    elif case == "empty":
        s = 0
    dt = torch.float16 if case == "dtype" else torch.float32
    q = torch.zeros((b, s, h, d), dtype=dt)
    k = torch.zeros((b, s + 1, h, d)) if case == "shape" else q
    gates = torch.zeros((b, s, h))
    C0 = torch.zeros((b, h, d, d + (case == "state")))
    before = mlstm_chunk.launches
    with pytest.raises(ValueError, match="mlstm_chunk"):
        mlstm_chunk(q, k, q, gates, gates, C0, torch.zeros((b, h, d)),
                    torch.zeros((b, h)), 0.25)
    assert mlstm_chunk.launches == before


@pytest.mark.parametrize("case", ["cpu", "shape", "dh", "state", "dC1",
                                  "head_dim", "dtype", "dh_dtype", "empty",
                                  "rows"])
def test_mlstm_chunk_bwd_rejects_before_building(case, monkeypatch):
    """The backward wrapper checks shapes (the final state's gradients'
    too), dtypes, the head dim, S >= 1, B x H within its grid and the
    device before it builds, sizes its workspace or counts a launch."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import mlstm_chunk_bwd
    _no_build(monkeypatch)
    b, s, h, d = 2, 5, 2, 16
    if case == "head_dim":
        d = 24
    elif case == "empty":
        s = 0
    elif case == "rows":
        b, h = 16385, 4
    dt = torch.float16 if case == "dtype" else torch.float32
    q = torch.zeros((b, s, h, d), dtype=dt)
    k = torch.zeros((b, s + 1, h, d)) if case == "shape" else q
    dh = {"dh": torch.zeros((b, s, h, d + 1)),
          "dh_dtype": torch.zeros((b, s, h, d), dtype=torch.bfloat16)}.get(
        case, q)
    gates = torch.zeros((b, s, h))
    C0 = torch.zeros((b, h, d, d + (case == "state")))
    dC1 = torch.zeros((b, h, d + 1, d)) if case == "dC1" else None
    before = (mlstm_chunk_bwd.launches,
              dict(mlstm_chunk_bwd.launches_by_route))
    with pytest.raises(ValueError, match="mlstm_chunk_bwd"):
        mlstm_chunk_bwd(q, k, q, gates, gates, C0, torch.zeros((b, h, d)),
                        torch.zeros((b, h)), 0.25, dh, dC1)
    assert (mlstm_chunk_bwd.launches,
            mlstm_chunk_bwd.launches_by_route) == before


def test_mlstm_backward_routes_and_chunk():
    """The backward has two routes, ``simt`` and ``wgmma`` (the launcher's
    codes 0 and 1), and its own chunk length."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (BWD_CHUNK,
                                                            BWD_ROUTES)
    assert BWD_ROUTES == ("simt", "wgmma") and BWD_CHUNK == 64


@pytest.mark.parametrize("d", [16, 256])
@pytest.mark.parametrize("s", [1, 37, 4096])
@pytest.mark.parametrize("dtype,route", [(torch.float32, "simt"),
                                         (torch.bfloat16, "wgmma")])
def test_mlstm_bwd_route_follows_dtype_and_shape(dtype, route, s, d):
    """The backward takes the tensor-core route for bfloat16 at every S
    (one step and a ragged chunk included: TMA zero-pads them) and every
    head dim (under 64 too), the SIMT route for float32: from the dtype
    and shape alone."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import mlstm_bwd_route
    assert mlstm_bwd_route(dtype, s, d) == route


def _mlstm_bwd_call(dtype, off=None):
    """A small backward call's arguments (B 1, S 5, H 2, D 16, CPU
    tensors), the operand named ``off`` viewed one element past its
    allocation's start: off 16 bytes."""
    b, s, h, d = 1, 5, 2, 16
    ops = {}
    for name in ("q", "k", "v", "dh"):
        t = torch.zeros(b * s * h * d + 1, dtype=dtype)
        ops[name] = t[1:].view(b, s, h, d) if name == off else \
            t[:-1].view(b, s, h, d)
    gates = torch.zeros((b, s, h))
    return (ops["q"], ops["k"], ops["v"], gates, gates,
            torch.zeros((b, h, d, d)), torch.zeros((b, h, d)),
            torch.zeros((b, h)), 0.25, ops["dh"])


@pytest.mark.parametrize("operand", ["q", "k", "v", "dh"])
def test_mlstm_chunk_bwd_rejects_tma_misalignment(operand, monkeypatch):
    """bfloat16 takes the wgmma route, which reads q, k, v and dh by TMA:
    any of them off 16 bytes is refused before a build and counts no
    launch."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import mlstm_chunk_bwd
    _no_build(monkeypatch)
    before = (mlstm_chunk_bwd.launches,
              dict(mlstm_chunk_bwd.launches_by_route))
    with pytest.raises(ValueError, match="TMA"):
        mlstm_chunk_bwd(*_mlstm_bwd_call(torch.bfloat16, operand))
    assert (mlstm_chunk_bwd.launches,
            mlstm_chunk_bwd.launches_by_route) == before


@pytest.mark.parametrize("operand", ["q", "dh"])
def test_mlstm_chunk_bwd_simt_takes_any_alignment(operand, monkeypatch):
    """The simt route (float32) reads q, k, v, dh with plain loads: data
    off 16 bytes is not refused for alignment (here only for lying on the
    CPU), and nothing is built."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import mlstm_chunk_bwd
    _no_build(monkeypatch)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        mlstm_chunk_bwd(*_mlstm_bwd_call(torch.float32, operand))


@pytest.mark.parametrize("dtype,s,route", [
    (torch.bfloat16, 2, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 910, "wgmma"), (torch.bfloat16, 1, "decode"),
    (torch.float32, 1, "decode"), (torch.float32, 2, "simt"),
    (torch.float32, 1024, "simt")])
def test_mlstm_route_follows_dtype_and_s(dtype, s, route):
    """One step takes the streaming decode route in either dtype; longer
    bfloat16 runs the tensor-core route, longer float32 the SIMT one:
    from the dtype and S alone.  Each route has its own chunk length."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (CHUNK,
                                                            mlstm_route)
    assert mlstm_route(dtype, s) == route
    assert CHUNK == {"simt": 32, "wgmma": 64, "decode": 1}


@pytest.mark.parametrize("dtype,t,w,route", [
    (torch.bfloat16, 1345, 4096, "tma"), (torch.bfloat16, 5, 8, "tma"),
    (torch.bfloat16, 37, 100, "simt"), (torch.bfloat16, 37, 102, "simt"),
    (torch.float32, 37, 100, "tma"), (torch.float32, 37, 4, "tma"),
    (torch.float32, 37, 102, "simt"), (torch.float32, 37, 1, "simt"),
    (torch.bfloat16, 0, 4096, "simt")])
def test_rglru_route_follows_the_row_bytes(dtype, t, w, route):
    """The scan reads a and b by TMA where a row of W elements is a
    multiple of 16 bytes (and there is a step to read), else by plain
    loads: from the dtype and shape alone."""
    from repro_torch.kernels.rglru_scan.rglru_scan import rglru_route
    assert rglru_route(dtype, t, w) == route


@pytest.mark.parametrize("operand", ["q", "k", "v"])
def test_mlstm_chunk_rejects_tma_misalignment(operand, monkeypatch):
    """bfloat16 with S > 1 takes the wgmma route, which reads q, k, v by
    TMA: data off 16 bytes is refused before a build and counts no
    launch."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import mlstm_chunk
    monkeypatch.setattr(_build, "load",
                        lambda name: pytest.fail("built before rejecting"))
    b, s, h, d = 1, 5, 2, 16
    ops = {n: torch.zeros((b, s, h, d), dtype=torch.bfloat16) for n in "qkv"}
    ops[operand] = torch.zeros(b * s * h * d + 1,
                               dtype=torch.bfloat16)[1:].view(b, s, h, d)
    gates = torch.zeros((b, s, h))
    before = (mlstm_chunk.launches, dict(mlstm_chunk.launches_by_route))
    with pytest.raises(ValueError, match="TMA"):
        mlstm_chunk(ops["q"], ops["k"], ops["v"], gates, gates,
                    torch.zeros((b, h, d, d)), torch.zeros((b, h, d)),
                    torch.zeros((b, h)), 0.25)
    assert (mlstm_chunk.launches, mlstm_chunk.launches_by_route) == before


@pytest.mark.parametrize("dtype,s", [(torch.bfloat16, 1),
                                     (torch.float32, 5)])
def test_mlstm_chunk_other_routes_take_any_alignment(dtype, s,
                                                     monkeypatch):
    """The decode and SIMT routes read q, k, v with plain loads: data off
    16 bytes is not refused for alignment (here only for lying on the
    CPU), and nothing is built."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import mlstm_chunk
    monkeypatch.setattr(_build, "load",
                        lambda name: pytest.fail("built before rejecting"))
    b, h, d = 1, 2, 16
    q = torch.zeros(b * s * h * d + 1, dtype=dtype)[1:].view(b, s, h, d)
    gates = torch.zeros((b, s, h))
    with pytest.raises(ValueError, match="contiguous CUDA"):
        mlstm_chunk(q, q, q, gates, gates, torch.zeros((b, h, d, d)),
                    torch.zeros((b, h, d)), torch.zeros((b, h)), 0.25)


@pytest.mark.parametrize("operand", ["a", "b"])
def test_rglru_scan_rejects_tma_misalignment(operand, monkeypatch):
    """Where the scan takes the TMA route (W 8 in bfloat16: 16-byte
    rows), a or b whose data is off 16 bytes is refused before a build
    and counts no launch."""
    from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan
    monkeypatch.setattr(_build, "load",
                        lambda name: pytest.fail("built before rejecting"))
    ops = {n: torch.zeros((2, 5, 8), dtype=torch.bfloat16) for n in "ab"}
    ops[operand] = torch.zeros(81, dtype=torch.bfloat16)[1:].view(2, 5, 8)
    before = (rglru_scan.launches, dict(rglru_scan.launches_by_route))
    with pytest.raises(ValueError, match="TMA"):
        rglru_scan(ops["a"], ops["b"], torch.zeros((2, 8),
                                                   dtype=torch.bfloat16))
    assert (rglru_scan.launches, rglru_scan.launches_by_route) == before


def test_rglru_scan_simt_route_takes_any_alignment(monkeypatch):
    """W 100 in bfloat16 (200-byte rows) takes the SIMT route, which reads
    with plain loads: a off 16 bytes is not refused for alignment (here
    only for lying on the CPU), and nothing is built."""
    from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan
    monkeypatch.setattr(_build, "load",
                        lambda name: pytest.fail("built before rejecting"))
    a = torch.zeros(1001, dtype=torch.bfloat16)[1:].view(2, 5, 100)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        rglru_scan(a, torch.zeros((2, 5, 100), dtype=torch.bfloat16),
                   torch.zeros((2, 100), dtype=torch.bfloat16))


@pytest.mark.parametrize("w", [100, 256, 4096])
@pytest.mark.parametrize("t", [0, 1, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_bwd_route_follows_dtype_t_and_w(dtype, t, w,
                                                    monkeypatch):
    """The reverse scan takes the forward's route: ``tma`` where a row of
    W elements is a multiple of 16 bytes and T > 0, else ``simt`` (W 100
    in bfloat16: 200-byte rows; T 0: dh0 = dhT).  Only ``tma`` reads by
    TMA: an ``a`` one element off its allocation is refused as
    TMA-unreadable there, and reaches the device check (a CPU tensor) on
    ``simt``; nothing is built."""
    from repro_torch.kernels.rglru_scan import rglru_scan as rs
    want = "simt" if t == 0 or (dtype, w) == (_BF, 100) else "tma"
    assert rs.rglru_route(dtype, t, w) == want and want in rs.BWD_ROUTES
    _no_build(monkeypatch)
    a = torch.empty(t * w + 1, dtype=dtype)[1:].view(1, t, w)
    other = torch.zeros((), dtype=dtype).expand(1, t, w)
    h0 = torch.zeros((1, w), dtype=dtype)
    with pytest.raises(ValueError, match="TMA" if want == "tma"
                       else "contiguous CUDA"):
        rs.rglru_scan_bwd(a, other, h0, other, None)


@pytest.mark.parametrize("operand", ["a", "h", "dh"])
def test_rglru_scan_bwd_rejects_tma_misalignment(operand, monkeypatch):
    """On the ``tma`` route (W 8 in bfloat16: 16-byte rows) a, h or dh
    whose data is off 16 bytes is refused with a ValueError before a
    build, and counts no launch."""
    from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan_bwd
    _no_build(monkeypatch)
    ops = {n: torch.zeros((2, 5, 8), dtype=_BF) for n in ("a", "h", "dh")}
    ops[operand] = torch.zeros(81, dtype=_BF)[1:].view(2, 5, 8)
    before = (rglru_scan_bwd.launches,
              dict(rglru_scan_bwd.launches_by_route))
    with pytest.raises(ValueError, match="TMA"):
        rglru_scan_bwd(ops["a"], ops["h"], torch.zeros((2, 8), dtype=_BF),
                       ops["dh"], torch.zeros((2, 8), dtype=_BF))
    assert (rglru_scan_bwd.launches,
            rglru_scan_bwd.launches_by_route) == before


def test_rglru_scan_bwd_simt_route_takes_any_alignment(monkeypatch):
    """W 100 in bfloat16 takes the ``simt`` route, which reads with plain
    loads: a, h and dh off 16 bytes are not refused for alignment (here
    only for lying on the CPU), and nothing is built."""
    from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan_bwd
    _no_build(monkeypatch)
    off = torch.zeros(1001, dtype=_BF)[1:].view(2, 5, 100)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        rglru_scan_bwd(off, off, torch.zeros((2, 100), dtype=_BF), off)


def test_linear_recurrence_hands_the_reverse_scan_an_aligned_dh(
        monkeypatch):
    """A gradient of h that arrives as a contiguous view off 16 bytes (a
    slice of a larger gradient) reaches the reverse scan as an aligned
    copy, as the ``tma`` route reads it; the gradients are the reverse
    scan's of the same values."""
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref
    arrived, handed = [], []
    aligned, (fwd, bwd) = ops._aligned, ops._TRAIN_BY_DEVICE["cpu"]

    def spy_aligned(t):
        arrived.append(t.data_ptr() % 16)
        return aligned(t)

    def spy_bwd(a, h, h0, dh, dhT):
        handed.append((dh.data_ptr() % 16, dh.is_contiguous()))
        return bwd(a, h, h0, dh, dhT)
    monkeypatch.setattr(ops, "_aligned", spy_aligned)
    monkeypatch.setitem(ops._TRAIN_BY_DEVICE, "cpu", (fwd, spy_bwd))
    gen = torch.Generator().manual_seed(0)
    a = torch.rand((2, 5, 8), generator=gen).requires_grad_()
    b = torch.randn((2, 5, 8), generator=gen).requires_grad_()
    h0 = torch.randn((2, 8), generator=gen)
    weight = torch.randn(81, generator=gen)
    for shift in (1, 0):
        h, _ = ops.linear_recurrence(a, b, h0)
        # h's gradient is a view of the concatenation's at `shift`
        flat = torch.cat([torch.zeros(shift), h.reshape(-1),
                          torch.zeros(1 - shift)])
        (flat * weight).sum().backward()
        dh = weight[shift:shift + 80].reshape(2, 5, 8)
        da, db, _ = rglru_bwd_ref(a.detach(), h.detach(), h0, dh)
        assert torch.equal(a.grad, da) and torch.equal(b.grad, db)
        a.grad, b.grad = None, None
    assert arrived == [4, 0]
    assert handed == [(0, True), (0, True)]


def _chain_operands(B=2, U=4, M=3, L=5, device="cpu"):
    """Well-formed operands of ``tropical_dp_chain`` (on the CPU, which it
    refuses)."""
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    return dict(rate=torch.ones((B, U, U), **f32),
                sources=torch.zeros((B, M), **i64),
                active=torch.ones((B, U), dtype=torch.bool, device=device),
                order=torch.arange(U, **i64),
                prev_dev=torch.arange(U + 1, **i64),
                bits_in=torch.ones(L, **f32),
                input_bits=torch.ones((), **f32),
                ct=torch.zeros((L, L, U), **f32),
                ok=torch.ones((L, L, U), **f32))


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"), ("rate_rank", "rate"), ("rate_square", "rate"),
    ("sources_dtype", "sources"), ("active_dtype", "active"),
    ("order_len", "order"), ("prev_dev_len", "prev_dev"),
    ("bits_in_len", "bits_in"), ("input_bits_shape", "input_bits"),
    ("ok_shape", "ok"), ("ct_strides", "contiguous"),
    ("meta_device", "CUDA")])
def test_chain_dp_rejects_before_building(case, match, monkeypatch):
    """The fused chain-DP wrapper refuses what its kernel does not take
    (CPU tensors, wrong ranks, shapes, dtypes, strides) with a
    ``ValueError`` before a build, and counts no launch on either
    route."""
    monkeypatch.setattr(_build, "load",
                        lambda name: pytest.fail("built before rejecting"))
    ops = _chain_operands(device="meta" if case == "meta_device" else "cpu")
    B, U, M, L = 2, 4, 3, 5
    bad = {"rate_rank": ("rate", torch.ones((B, U))),
           "rate_square": ("rate", torch.ones((B, U, U + 1))),
           "sources_dtype": ("sources", torch.zeros((B, M),
                                                    dtype=torch.int32)),
           "active_dtype": ("active", torch.ones((B, U))),
           "order_len": ("order", torch.arange(U - 1)),
           "prev_dev_len": ("prev_dev", torch.arange(U)),
           "bits_in_len": ("bits_in", torch.ones(L + 1)),
           "input_bits_shape": ("input_bits", torch.ones(1)),
           "ok_shape": ("ok", torch.ones((L - 1, L, U))),
           "ct_strides": ("ct", torch.zeros((L, L, U)).transpose(0, 1))}
    if case in bad:
        ops[bad[case][0]] = bad[case][1]
    chain = tdp.tropical_dp_chain
    before = (chain.launches, dict(chain.launches_by_route),
              tropical_dp_step.launches)
    with pytest.raises(ValueError, match=match):
        chain(**ops)
    assert (chain.launches, chain.launches_by_route,
            tropical_dp_step.launches) == before


def test_chain_dp_takes_strided_sources_without_a_copy(monkeypatch):
    """``sources`` may be any strided int64 view (the rollout's
    ``arange(U).expand(B, U)``): it is not refused for its strides (here
    only for lying on the CPU)."""
    monkeypatch.setattr(_build, "load",
                        lambda name: pytest.fail("built before rejecting"))
    ops = _chain_operands(M=4)
    ops["sources"] = torch.arange(4).expand(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tdp.tropical_dp_chain(**ops)


@pytest.mark.parametrize("L,S,route", [
    (11, 8, "fused"), (7, 8, "fused"), (11, 32, "fused"), (7, 32, "fused"),
    (11, 58, "fused"), (11, 59, "step"), (11, 80, "step"), (1, 1, "fused"),
    (57, 8, "fused"), (58, 8, "step"), (257, 1, "step"), (2, 255, "step")])
def test_chain_route_follows_the_shapes(L, S, route):
    """``fused`` wherever one slot's tables and the staged operands fit in
    one block's 227 KB (AlexNet and LeNet at U 8 and 32: the rollout,
    ``plan_batch_multi`` and the U 32 bench; up to U 58 at L 11, L 57 at
    U 8), ``step`` beyond it or beyond 8-bit parents (L > 256, S > 255):
    from the shapes alone (here U = S, a device order over every UAV)."""
    assert tdp.chain_route(L, S, S) == route
    fits = tdp.chain_smem_bytes(L, S, S, 1) <= tdp.SMEM_BUDGET
    assert (route == "fused") == (fits and L <= 256 and S <= 255)


@pytest.mark.parametrize("M,L,S,plan", [
    (4, 11, 8, (4, 128)),           # the rollout: RQ 4 slots, AlexNet, U 8
    (8, 11, 8, (8, 256)),           # plan_batch_multi: every UAV a slot
    (1, 11, 8, (1, 128)),           # plan_batch: one source
    (4, 7, 8, (4, 128)),            # LeNet
    (32, 11, 32, (8, 1024)),        # U 32: slot tiles of 8
    (3, 40, 6, (3, 128)),           # a 40-layer chain
    (64, 11, 40, (6, 960))])
def test_chain_plan_at_the_planners_shapes(M, L, S, plan):
    """Slots a block and threads: ``LANES`` (4) threads for every output
    of the block's slots, in whole warps, 128 to 1,024 of them, and the
    block's tables within its shared memory."""
    mt, threads, smem = tdp.chain_plan(M, L, S, S)
    assert (mt, threads) == plan and tdp.LANES == 4
    assert threads % 32 == 0 and 4 * mt * S <= threads <= 1024
    assert smem == tdp.chain_smem_bytes(L, S, S, mt) <= tdp.SMEM_BUDGET


@pytest.mark.parametrize("L,S,U,slots", [(11, 8, 8, 4), (11, 8, 8, 8),
                                         (7, 5, 6, 3), (11, 32, 32, 2),
                                         (40, 6, 6, 3)])
def test_chain_smem_layout_matches_the_kernel(L, S, U, slots):
    """The fused kernel's shared memory, as its launcher lays it out
    (``ChainSmem``; a launch whose total differs is refused): tr
    [S][L][S+1] float32, ct and ok [L][L][S] float32, rates [U][U]
    float32, bits_in and input_bits [L+1] float32, order [S] and prev_dev
    [S+1] int64, sources [slots] int64, active [U] uint8, dp
    [slots][L+1][S+1] float32, mn [slots][L][S] float32, s0b [slots][L][S]
    uint8, pa and ps [slots][L][S+1] uint8, each padded to 16 bytes.  At
    the rollout's shape (L 11, S 8, 4 slots) tr takes 3,168 B and each
    slot's dp table 432 B."""
    sizes = {"tr": 4 * S * L * (S + 1), "ct": 4 * L * L * S,
             "ok": 4 * L * L * S, "rate": 4 * U * U, "bits": 4 * (L + 1),
             "order": 8 * S, "prev": 8 * (S + 1), "src": 8 * slots,
             "act": U, "dp": 4 * slots * (L + 1) * (S + 1),
             "mn": 4 * slots * L * S, "s0b": slots * L * S,
             "pa": slots * L * (S + 1), "ps": slots * L * (S + 1)}
    total = tdp.chain_smem_bytes(L, S, U, slots)
    assert total == sum((n + 15) // 16 * 16 for n in sizes.values())
    if (L, S, U, slots) == (11, 8, 8, 4):
        assert sizes["tr"] == 3168 and sizes["dp"] == 4 * 432
        assert total == 15696
