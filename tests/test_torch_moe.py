"""The port's MoE layer against the reference, on the CPU.

* the grouped expert GEMM's plain version (``moe_matmul_ref``) against
  the reference's Pallas ``moe_matmul`` in interpret mode (32 x 64 x 32
  blocks, so several blocks on every axis) and its ``moe_matmul_ref``,
  at the reference's kernel-test grid, float32 and bfloat16, with the
  reference's tolerance (``TOL * sqrt(D)`` atol, ``10 TOL`` rtol);
* ``moe_route`` / ``moe_apply`` against the reference's ``moe_apply``
  for the reduced granite-moe and olmoe (8 experts, top-2) at the
  drop-free capacity factor and at 1.0 and 0.5, where picks are dropped:
  the expert indices and their order, the positions in the experts and
  ``keep`` exactly equal, ``y`` within atol / rtol 1e-5 and the aux loss
  within 1e-6;
* forced exact ties among the router probabilities (integer-valued
  activations and router weights): the picks and their order equal
  ``jax.lax.top_k``'s (descending, ties to the lower expert);
* ``ops.expert_gemm`` on CPU tensors takes the plain version and counts
  no launch.

The reference's routing is read from its own run: ``jax.lax.top_k``'s
result and the positions its ``take_along_axis`` gathers are recorded
through proxies of the ``jax`` and ``jnp`` names of ``repro.models.moe``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.kernels.moe_matmul.moe_matmul import \
    moe_matmul as j_moe_matmul  # noqa: E402
from repro.kernels.moe_matmul.ref import \
    moe_matmul_ref as j_moe_matmul_ref  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels.moe_matmul.ops import expert_gemm  # noqa: E402
from repro_torch.kernels.moe_matmul.ref import moe_matmul_ref  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": 2e-5, "bf16": 2e-2}     # tests/test_kernels.py TOL


def both(x, dt):
    """numpy float32 -> (torch, jax) tensors of the dtype ``dt``."""
    t_dt, j_dt = DTYPES[dt]
    return torch.as_tensor(x).to(t_dt), jnp.asarray(x).astype(j_dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("e,c,d,f", [(4, 64, 96, 160), (8, 32, 128, 64),
                                     (2, 128, 64, 256)])
def test_moe_matmul_plain_matches_pallas_and_ref(e, c, d, f, dt):
    rng = np.random.default_rng(e * c + f)
    xt, xj = both(rng.normal(size=(e, c, d)).astype(np.float32), dt)
    wt, wj = both(rng.normal(size=(e, d, f)).astype(np.float32), dt)
    got = moe_matmul_ref(xt, wt)
    assert got.dtype == DTYPES[dt][0] and got.shape == (e, c, f)
    tol = dict(atol=TOL[dt] * d ** 0.5, rtol=TOL[dt] * 10)
    for want in (j_moe_matmul(xj, wj, block_c=32, block_f=64, block_d=32,
                              interpret=True),
                 j_moe_matmul_ref(xj, wj)):
        np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                   np.asarray(want, np.float32), **tol)


def test_expert_gemm_on_cpu_takes_the_plain_version_without_counting():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(3, 5, 7)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(3, 7, 4)), dtype=torch.float32)
    kernels.reset_launch_counts()
    assert torch.equal(expert_gemm(x, w), moe_matmul_ref(x, w))
    assert kernels.launch_counts()["moe_matmul"] == 0


# ---------------------------------------------------------------------------
# the layer against the reference
# ---------------------------------------------------------------------------


class _Recorder:
    """Proxies of ``repro.models.moe``'s ``jax`` and ``jnp`` that record
    the reference's own top-k, positions and capacity."""

    def __init__(self):
        self.rec = {}
        rec = self.rec

        class Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            @staticmethod
            def top_k(x, k):
                out = jax.lax.top_k(x, k)
                rec["gate"], rec["idx"] = out
                return out

        class Jax:
            lax = Lax()

            def __getattr__(self, name):
                return getattr(jax, name)

        class Jnp:
            def __getattr__(self, name):
                return getattr(jnp, name)

            @staticmethod
            def take_along_axis(*args, **kw):
                out = jnp.take_along_axis(*args, **kw)
                rec["pos"] = out[..., 0]
                return out

            @staticmethod
            def zeros(shape, dtype=None):
                rec["buf_shape"] = tuple(shape)
                return jnp.zeros(shape, dtype)

        self.jax, self.jnp = Jax(), Jnp()


def _moe_case(arch, seed, s=16, b=2):
    """Reference MoE params (from its ``moe_init``) and an input x
    [B, S, d], as numpy, for the reduced ``arch``."""
    cfg = j_get_arch(arch).reduced()
    m = cfg.moe
    p = j_moe.moe_init(jax.random.PRNGKey(seed), cfg.d_model, m.n_experts,
                       m.d_expert, cfg.glu)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return cfg, {k: np.asarray(v) for k, v in p.items()}, x


def _both_moe(monkeypatch, cfg, p, x, cf):
    """Run the reference's ``moe_apply`` (recording its routing) and the
    port's ``moe_route`` / ``moe_apply`` on the same numpy inputs."""
    r = _Recorder()
    monkeypatch.setattr(j_moe, "jax", r.jax)
    monkeypatch.setattr(j_moe, "jnp", r.jnp)
    kw = dict(top_k=cfg.moe.top_k, act=cfg.act, glu=cfg.glu,
              capacity_factor=cf)
    jy, jaux = j_moe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), **kw)
    monkeypatch.undo()
    tp = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    tx = torch.as_tensor(x)
    route = t_moe.moe_route(tp, tx, top_k=cfg.moe.top_k, capacity_factor=cf)
    ty, taux = t_moe.moe_apply(tp, tx, **kw)
    return r.rec, (np.asarray(jy), float(jaux)), route, (ty, float(taux))


def _check_routing(rec, route, n_experts):
    # the reference's buffer is [B, E * cap, d]: the same capacity
    assert rec["buf_shape"][1] == n_experts * route["cap"]
    np.testing.assert_array_equal(route["idx"].numpy(), np.asarray(rec["idx"]))
    np.testing.assert_array_equal(route["pos"].numpy(), np.asarray(rec["pos"]))
    keep = np.asarray(rec["pos"]) < route["cap"]
    np.testing.assert_array_equal(route["keep"].numpy(), keep)
    np.testing.assert_allclose(
        route["gate"].numpy(), np.asarray(rec["gate"]) / np.maximum(
            np.asarray(rec["gate"]).sum(-1, keepdims=True), 1e-9),
        atol=1e-6, rtol=1e-6)
    return keep


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "olmoe-1b-7b"])
@pytest.mark.parametrize("cf", ["drop-free", 1.0, 0.5])
def test_moe_apply_matches_reference(monkeypatch, arch, cf):
    """At the drop-free factor (E / k = 4) every pick is kept; at 1.0 and
    0.5 the 2 x 16 tokens' 32 picks a sequence over 8 experts overflow
    capacities of 4 and 2, so some are dropped."""
    cfg, p, x = _moe_case(arch, seed=3)
    tcfg = get_arch(arch).reduced()
    factor = cfg.moe.capacity_factor if cf == "drop-free" else cf
    assert tcfg.moe.capacity_factor == cfg.moe.capacity_factor
    rec, (jy, jaux), route, (ty, taux) = _both_moe(monkeypatch, cfg, p, x,
                                                   factor)
    keep = _check_routing(rec, route, cfg.moe.n_experts)
    assert route["cap"] == t_moe.capacity(16, 2, 8, factor) == \
        max(1, math.ceil(16 * 2 * factor / 8))
    if cf == "drop-free":
        assert keep.all()
    else:
        assert not keep.all()
    np.testing.assert_allclose(ty.numpy(), jy, atol=1e-5, rtol=1e-5)
    assert abs(taux - jaux) <= 1e-6


def test_forced_ties_are_picked_as_jax_top_k(monkeypatch):
    """Activations and router weights in {0, 1}: the logits are small
    integers, so many router probabilities are exactly equal; the picks
    and their order still equal the reference's (``jax.lax.top_k``)."""
    cfg, p, _ = _moe_case("olmoe-1b-7b", seed=5)
    rng = np.random.default_rng(5)
    p["router"] = (rng.random(p["router"].shape) < 0.3).astype(np.float32)
    x = (rng.random((2, 16, cfg.d_model)) < 0.1).astype(np.float32)
    rec, (jy, _), route, (ty, _) = _both_moe(monkeypatch, cfg, p, x, 1.0)
    probs = torch.softmax(torch.as_tensor(x) @ torch.as_tensor(p["router"]),
                          -1)
    # ties decide picks: a selected probability equals another one
    sel = torch.gather(probs, -1, route["idx"])
    n_equal = (probs[..., None, :] == sel[..., None]).sum(-1)
    assert int((n_equal > 1).sum()) >= 8
    _check_routing(rec, route, cfg.moe.n_experts)
    np.testing.assert_allclose(ty.numpy(), jy, atol=1e-5, rtol=1e-5)


def test_moe_route_orders_like_jax_top_k_on_tied_probabilities():
    """The stable descending sort on rows with ties at and inside the
    top-k boundary, against ``jax.lax.top_k`` directly."""
    rng = np.random.default_rng(9)
    logits = rng.integers(0, 3, size=(3, 5, 8)).astype(np.float32)
    router = np.eye(8, dtype=np.float32)
    route = t_moe.moe_route({"router": torch.as_tensor(router)},
                            torch.as_tensor(logits), top_k=3,
                            capacity_factor=1.0)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    _, want = jax.lax.top_k(probs, 3)
    np.testing.assert_array_equal(route["idx"].numpy(), np.asarray(want))
