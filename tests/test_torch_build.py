"""The port's kernel build and launch plumbing, on the CPU.

``nvcc`` and the card are absent here, so these tests hold what runs
before a build or a launch: the wrappers reject what their kernels do not
take before touching ``nvcc``, a build is keyed by the source's content,
a missing ``nvcc`` raises, and a nonzero launcher return raises with the
CUDA error string.
"""
import ctypes

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.channel import RadioParams  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv2d.conv2d import matmul_bias_act  # noqa: E402
from repro_torch.kernels.link_geometry.link_geometry import (  # noqa: E402
    link_geometry, radio_constants)
from repro_torch.kernels.tropical_dp.tropical_dp import \
    tropical_dp_step  # noqa: E402


def test_sources_are_the_two_main_path_kernels():
    """The planner's two kernels and the CNN path's conv GEMM."""
    assert _build.sources() == ("conv2d", "link_geometry", "tropical_dp")
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
