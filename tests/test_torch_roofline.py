"""The port's roofline module on the H100 SXM's constants: each kernel's
``KERNEL_WORK`` (``kernels.work``) at PERF.md section 6's shapes gives
that table's bound through ``kernel_bound`` (to 0.01 us), the
reference's ``TestRooflineTerms`` cases restated on the
H100's peaks, the class-split compute term, and the one source of the
card's constants (``core.pipeline_opt`` and ``chip_smoke.py`` read them
from here).  No JAX: the work functions read shapes and dtypes, so the
operands are ``meta`` tensors."""
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.work import KERNEL_WORK, kept_pairs  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.roofline import Roofline, kernel_bound  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32, BF16 = torch.float32, torch.bfloat16


def meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def mlstm_args(b, s, h, d, dtype):
    q = meta(b, s, h, d, dtype=dtype)
    return (q, q, q, meta(b, s, h), meta(b, s, h), meta(b, h, d, d),
            meta(b, h, d), meta(b, h), d ** -0.5)


def conv2_operands():
    """AlexNet's conv2 GEMM at the CNN path's 32 images, K as served."""
    m, k, n = 32 * 27 * 27, 5 * 5 * 96, 256
    return meta(m, k), meta(k, n), meta(n)


#: PERF.md section 6's bound column, us, and the call it was taken at
BOUNDS = {
    "link_geometry": (0.066, lambda: (meta(256, 8, 2), meta(256, 8),
                                      None)),
    "chain_dp_fused": (0.049, lambda: (
        meta(256, 8, 8), meta(256, 4, dtype=torch.int64),
        meta(256, 8, dtype=torch.bool), meta(8, dtype=torch.int64),
        meta(9, dtype=torch.int64), meta(11), meta(), meta(11, 11, 8),
        meta(11, 11, 8))),
    "conv2d": (173.73, conv2_operands),
    "flash_attention": (278.07, lambda: (
        meta(8, 16, 2048, 256, dtype=BF16),
        meta(8, 8, 2048, 256, dtype=BF16),
        meta(8, 8, 2048, 256, dtype=BF16))),
    "decode_attention": (80.17, lambda: (
        meta(8, 8, 2, 256, dtype=BF16), meta(8, 8, 4096, 256, dtype=BF16),
        meta(8, 8, 4096, 256, dtype=BF16), meta(8, dtype=torch.int32))),
    "decode_attention_g16": (5.05, lambda: (
        meta(8, 1, 16, 256, dtype=BF16), meta(8, 1, 2048, 256, dtype=BF16),
        meta(8, 1, 2048, 256, dtype=BF16), meta(8, dtype=torch.int32))),
    "moe_matmul": (310.51, lambda: (meta(64, 1144, 2048, dtype=BF16),
                                    meta(64, 2048, 1024, dtype=BF16))),
    "moe_matmul_decode": (81.07, lambda: (meta(64, 8, 2048, dtype=BF16),
                                          meta(64, 2048, 1024, dtype=BF16))),
    "rglru_scan": (78.98, lambda: (meta(8, 1345, 4096, dtype=BF16),
                                   meta(8, 1345, 4096, dtype=BF16),
                                   meta(8, 4096, dtype=BF16))),
    "mlstm_chunk": (22.90, lambda: mlstm_args(8, 910, 4, 256, BF16)),
    "flash_attention_bwd": (195.47, lambda: (
        meta(1, 36, 4096, 64, dtype=BF16),) * 3 + (
        meta(1, 36, 4096, 64, dtype=BF16), meta(1, 36, 4096),
        meta(1, 36, 4096, 64, dtype=BF16))),
    "moe_matmul_dx": (47.58, lambda: (meta(32, 1280, 512, dtype=BF16),
                                      meta(32, 1024, 512, dtype=BF16))),
    "moe_matmul_dw": (47.58, lambda: (meta(32, 1280, 1024, dtype=BF16),
                                      meta(32, 1280, 512, dtype=BF16))),
    "rglru_scan_bwd": (100.18, lambda: (
        meta(1, 4096, 4096), meta(1, 4096, 4096), meta(1, 4096),
        meta(1, 4096, 4096), meta(1, 4096))),
    "mlstm_chunk_bwd": (18.24, lambda: mlstm_args(1, 4096, 4, 256, BF16)
                        + (meta(1, 4096, 4, 256, dtype=BF16),)),
}
KWARGS = {"flash_attention": dict(causal=True, cap=50.0),
          "flash_attention_bwd": dict(causal=True),
          "decode_attention": dict(cap=50.0)}
NAMES = {"chain_dp_fused": "tropical_dp",
         "decode_attention_g16": "decode_attention",
         "moe_matmul_decode": "moe_matmul"}


@pytest.mark.parametrize("row", list(BOUNDS))
def test_kernel_work_gives_the_kernel_tables_bound(row):
    us, operands = BOUNDS[row]
    name = NAMES.get(row, row)
    work = KERNEL_WORK[name](*operands(), **KWARGS.get(name, {}))
    bound = kernel_bound(work)
    assert bound.bound_s * 1e6 == pytest.approx(us, abs=0.005)
    assert bound.bound_by in ("bytes", "operations")


def test_kernel_work_covers_every_counted_kernel():
    from repro_torch import kernels
    assert set(KERNEL_WORK) == set(kernels.launch_counts())


def test_bounds_by_class_and_route():
    """Each work carries the route the card's launcher takes, and its
    class follows it: bf16 tensor cores on ``wgmma``, TF32 for the conv
    GEMM's 3xTF32, fp32 elsewhere; the conv GEMM's SIMT route (K off 4)
    counts its products once; a kernel with one route has none."""
    def peak_route(name, *args):
        work = KERNEL_WORK[name](*args)
        return work.peak, work.route
    assert peak_route("conv2d", *conv2_operands()) == ("tf32", "wgmma")
    simt = KERNEL_WORK["conv2d"](meta(64, 363), meta(363, 96), meta(96))
    assert (simt.peak, simt.route) == ("fp32", "simt")
    assert simt.flops == 2 * 64 * 363 * 96
    q = meta(2, 4, 64, 64)
    assert peak_route("flash_attention", q, q, q) == ("fp32", "simt")
    qb = meta(2, 4, 64, 64, dtype=BF16)
    assert peak_route("flash_attention", qb, qb, qb) == ("bf16", "wgmma")
    assert peak_route("moe_matmul", meta(4, 8, 100, dtype=BF16),
                      meta(4, 100, 36, dtype=BF16)) == ("fp32", "simt")
    assert peak_route("mlstm_chunk", *mlstm_args(1, 1, 2, 64, BF16)) == \
        ("fp32", "decode")
    assert peak_route("rglru_scan", meta(2, 8, 64), meta(2, 8, 64),
                      meta(2, 64)) == ("fp32", "tma")
    g16 = BOUNDS["decode_attention_g16"][1]()
    assert peak_route("decode_attention", *g16) == ("bf16", None)
    assert peak_route("tropical_dp", *BOUNDS["chain_dp_fused"][1]()) == \
        ("fp32", "fused")


@pytest.mark.parametrize("sq,sk,causal,window", [
    (1, 1, True, 0), (7, 7, True, 0), (7, 7, True, 3), (7, 7, True, 7),
    (7, 7, True, 20), (7, 7, False, 3), (7, 7, False, 9), (5, 9, False, 0),
    (300, 300, True, 64)])
def test_kept_pairs_is_the_masks_count(sq, sk, causal, window):
    want = 0
    for q in range(sq):
        lo = max(0, q - window + 1) if window else 0
        hi = min(q, sk - 1) if causal else sk - 1
        want += max(0, hi - lo + 1)
    assert kept_pairs(sq, sk, causal, window) == want


class TestRooflineTerms:
    """The reference's cases on the H100 SXM's constants."""

    def test_bottleneck_selection(self):
        r = Roofline(flops_dev=989e12, bytes_dev=0, coll_bytes_dev=0,
                     pod_bytes_dev=0, n_chips=1, model_flops=989e12)
        assert r.bottleneck == "compute"
        assert r.compute_s == pytest.approx(1.0)
        assert r.roofline_fraction == pytest.approx(1.0)

    def test_pod_bytes_use_the_pod_bandwidth(self):
        r = Roofline(flops_dev=0, bytes_dev=0, coll_bytes_dev=50e9,
                     pod_bytes_dev=50e9, n_chips=512, model_flops=1.0)
        assert r.collective_s == pytest.approx(1.0)   # all bytes on DCN

    def test_nvlink_bytes(self):
        r = Roofline(flops_dev=0, bytes_dev=3.35e12, coll_bytes_dev=900e9,
                     pod_bytes_dev=0, n_chips=8, model_flops=1.0)
        assert r.collective_s == pytest.approx(2.0)
        assert r.memory_s == pytest.approx(1.0)
        assert r.bottleneck == "collective" and r.step_s == \
            pytest.approx(2.0)

    def test_useful_ratio(self):
        r = Roofline(flops_dev=2.0, bytes_dev=0, coll_bytes_dev=0,
                     pod_bytes_dev=0, n_chips=10, model_flops=10.0)
        assert r.useful_ratio == pytest.approx(0.5)

    def test_compute_sums_the_classes(self):
        r = Roofline(flops_dev=989e12 + 67e12 + 495e12, bytes_dev=0,
                     coll_bytes_dev=0, pod_bytes_dev=0, n_chips=1,
                     model_flops=989e12,
                     flops_by_class={"bf16": 989e12, "fp32": 67e12,
                                     "tf32": 495e12})
        assert r.compute_s == pytest.approx(3.0)
        assert r.roofline_fraction == pytest.approx(1 / 3)

    def test_unknown_collective_term(self):
        r = Roofline(flops_dev=0, bytes_dev=3.35e12, coll_bytes_dev=None,
                     pod_bytes_dev=None, n_chips=256, model_flops=1.0)
        assert r.collective_s is None and r.bottleneck == "memory"
        assert r.to_dict()["collective_s"] is None


def test_the_cards_constants_have_one_source():
    from repro_torch.core import pipeline_opt
    assert (rl.BF16_FLOPS, rl.TF32_FLOPS, rl.FP32_FLOPS, rl.HBM_BW,
            rl.NVLINK_BW, rl.POD_BW) == (989e12, 495e12, 67e12, 3.35e12,
                                         450e9, 50e9)
    assert pipeline_opt.H100_SXM_BF16_FLOPS is rl.BF16_FLOPS
    assert pipeline_opt.H100_SXM_NVLINK_BYTES_ONE_WAY is rl.NVLINK_BW
    sys.path.insert(0, ROOT)
    import chip_smoke
    assert chip_smoke.KERNEL_WORK is KERNEL_WORK
    assert (chip_smoke.HBM_BYTES_PER_S, chip_smoke.BF16_OPS_PER_S,
            chip_smoke.FP32_OPS_PER_S, chip_smoke.TF32_OPS_PER_S) == \
        (rl.HBM_BW, rl.BF16_FLOPS, rl.FP32_FLOPS, rl.TF32_FLOPS)
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        src = fh.read()
    for literal in ("989e12", "3.35e12", "67e12", "495e12"):
        assert literal not in src, literal
