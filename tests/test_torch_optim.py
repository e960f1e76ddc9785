"""The port's optimiser and data stream against the reference's, on the
CPU, on the same seeded numpy inputs.

* ``wsd``, ``cosine`` and ``constant`` at every step of a 40-step run
  (warmup, stable, decay, past the end): equal to the reference's float32
  values (``cosine`` within two ulps where XLA's float32 ``cos`` and
  torch's differ by one, ROADMAP section 3, and equal elsewhere);
* ``global_norm`` and ``clip_by_global_norm`` (under and over the clip)
  within rtol 1e-6 (float32 sums in another order);
* ``adamw_update``: 3 steps from the same parameters, gradients and
  zero moments, parameters and moments leaf by leaf within rtol 1e-6
  (the bias corrections ``1 - b ** step`` in float32, the reference's
  operation order), the step counter exact;
* ``compress`` / ``decompress`` and the tree forms with error feedback
  over 3 rounds: int8 payloads equal, scales and residuals within 1 ulp,
  ``round`` half to even on exact halves;
* ``lm_data`` / ``SyntheticLM`` batches bitwise (with and without the
  prefetch thread, two hosts), ``image_batches`` bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.data import pipeline as j_data  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import grad_compress as j_gc  # noqa: E402
from repro.optim import schedules as j_sched  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data import pipeline as t_data  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.optim import grad_compress as t_gc  # noqa: E402
from repro_torch.optim import schedules as t_sched  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

SCHEDULE_ARGS = {
    "wsd": dict(peak_lr=3e-4, total_steps=40, warmup_steps=5,
                decay_frac=0.25),
    "wsd-floor": dict(peak_lr=1e-3, total_steps=33, warmup_steps=0,
                      decay_frac=0.1, floor=1e-5),
    "cosine": dict(peak_lr=3e-4, total_steps=40, warmup_steps=5),
    "cosine-nowarm": dict(peak_lr=1e-3, total_steps=17, warmup_steps=0,
                          floor_frac=0.2),
    "constant": dict(peak_lr=3e-4, warmup_steps=5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULE_ARGS))
def test_schedules_equal_reference(name):
    kind = name.split("-")[0]
    kw = SCHEDULE_ARGS[name]
    steps = np.arange(0, 45, dtype=np.int32)
    want = np.asarray([np.float32(j_sched.SCHEDULES[kind](
        jnp.asarray(s), **kw)) for s in steps])
    got = np.asarray([t_sched.SCHEDULES[kind](
        torch.tensor(int(s), dtype=torch.int32), **kw).item()
        for s in steps], np.float32)
    if kind == "cosine":
        # XLA's float32 cos and torch's differ by one ulp at some angles,
        # two after the schedule's products (ROADMAP section 3): within two
        # ulps, and exact where the two cos agree
        np.testing.assert_array_max_ulp(got, want, maxulp=2)
        prog = np.clip((steps.astype(np.float32) - kw["warmup_steps"])
                       / max(kw["total_steps"] - kw["warmup_steps"], 1),
                       0, 1).astype(np.float32)
        same_cos = np.asarray(jnp.cos(jnp.pi * jnp.asarray(prog))) == \
            torch.cos(np.pi * torch.from_numpy(prog)).numpy()
        np.testing.assert_array_equal(got[same_cos], want[same_cos])
    else:
        np.testing.assert_array_equal(got, want)


def _tree(seed, scale=1.0):
    """A nested dict / list of float32 arrays, as a parameter tree."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (scale * rng.normal(size=shape)).astype(np.float32)
    return {"embed": {"table": a(16, 8)}, "final_norm": {"scale": a(8)},
            "layers": [{"w": a(8, 4, 2), "b": a(4)}, {"w": a(8, 4, 2),
                                                      "b": a(4)}]}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_t(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _close(got, want, **tol):
    got_l, want_l = leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("scale,max_norm", [(1.0, 1.0), (1e-3, 1.0),
                                            (3.0, 0.5)])
def test_global_norm_and_clip_match_reference(scale, max_norm):
    g = _tree(1, scale)
    want_g, want_n = j_adamw.clip_by_global_norm(_j(g), max_norm)
    got_g, got_n = t_adamw.clip_by_global_norm(_t(g), max_norm)
    np.testing.assert_allclose(got_n.item(), float(want_n), rtol=1e-6)
    np.testing.assert_allclose(t_adamw.global_norm(_t(g)).item(),
                               float(j_adamw.global_norm(_j(g))), rtol=1e-6)
    _close(got_g, want_g, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("wd,lr", [(0.1, 3e-4), (0.0, 1e-2), (0.5, 1.0)])
def test_adamw_three_steps_match_reference(wd, lr):
    p = _tree(2)
    jp, tp = _j(p), _t(p)
    jo, to = j_adamw.init_opt_state(jp), t_adamw.init_opt_state(tp)
    assert to["step"].dtype == torch.int32 and int(to["step"]) == 0
    for i in range(3):
        g = _tree(10 + i, 0.1)
        jp, jo = j_adamw.adamw_update(jp, _j(g), jo, lr=jnp.float32(lr),
                                      weight_decay=wd)
        tp, to = t_adamw.adamw_update(tp, _t(g), to,
                                      lr=torch.tensor(lr), weight_decay=wd)
        assert int(to["step"]) == int(jo["step"]) == i + 1
        _close(tp, jp, rtol=1e-6, atol=1e-7)
        _close(to["m"], jo["m"], rtol=1e-6, atol=1e-9)
        _close(to["v"], jo["v"], rtol=1e-6, atol=1e-12)


def test_adamw_is_not_torch_optim_adamw():
    """The reference's formula (decay inside the step, after eps) differs
    from ``torch.optim.AdamW``'s (decay first): the port keeps the
    reference's."""
    p = torch.ones(4)
    g = torch.full((4,), 0.5)
    tp, _ = t_adamw.adamw_update({"w": p.clone()}, {"w": g},
                                 t_adamw.init_opt_state({"w": p}),
                                 lr=torch.tensor(0.1), weight_decay=0.5)
    # step 1: m_hat = g, v_hat = g^2: p - lr (g / (|g| + eps) + wd p)
    want = 1.0 - 0.1 * (0.5 / (0.5 + 1e-8) + 0.5 * 1.0)
    np.testing.assert_allclose(tp["w"].numpy(), np.full(4, want, np.float32),
                               rtol=1e-7)
    ref = p.clone().requires_grad_()
    opt = torch.optim.AdamW([ref], lr=0.1, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.5)
    ref.grad = g.clone()
    opt.step()
    assert not torch.equal(ref.detach(), tp["w"])


def test_compress_rounds_half_to_even():
    g = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0])
    q, scale, err = t_gc.compress(g, torch.zeros(6))
    assert scale.item() == pytest.approx(1.0)
    assert q.tolist() == [0, 2, 2, 0, -2, 127]
    jq, _, _ = j_gc.compress(jnp.asarray(g.numpy()), jnp.zeros(6))
    assert q.tolist() == np.asarray(jq).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_tree_with_error_feedback_matches_reference(seed):
    je = j_gc.init_error(_j(_tree(seed)))
    te = t_gc.init_error(_t(_tree(seed)))
    for i in range(3):
        g = _tree(100 * seed + i, 10.0 ** (i - 1))
        jq, js, je = j_gc.compress_tree(_j(g), je)
        tq, ts, te = t_gc.compress_tree(_t(g), te)
        for a, b in zip(leaves(tq), jax.tree.leaves(jq)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _close(ts, js, rtol=1.2e-7, atol=0)
        _close(te, je, rtol=0, atol=1e-6 * 10.0 ** (i - 1))
        _close(t_gc.decompress_tree(tq, ts), j_gc.decompress_tree(jq, js),
               rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("batch,seq,seed,hosts", [(4, 32, 0, 1),
                                                  (3, 17, 5, 2),
                                                  (2, 128, 1, 1)])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_lm_data_is_the_reference_stream(batch, seq, seed, hosts, prefetch):
    arch = "minicpm-2b"
    its = []
    for host in range(hosts):
        j_it = j_data.lm_data(j_get_arch(arch).reduced(), batch, seq,
                              seed=seed, host_id=host, n_hosts=hosts,
                              prefetch=prefetch)
        t_it = t_data.lm_data(get_arch(arch).reduced(), batch, seq,
                              seed=seed, host_id=host, n_hosts=hosts,
                              prefetch=prefetch)
        its.append((j_it, t_it))
    for _ in range(3):
        for j_it, t_it in its:
            want, got = next(j_it), next(t_it)
            assert set(got) == {"tokens", "labels"}
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_image_batches_are_the_reference_stream():
    j_it = j_data.image_batches(8, 3, 5, 4, seed=3)
    t_it = t_data.image_batches(8, 3, 5, 4, seed=3)
    for _ in range(3):
        want, got = next(j_it), next(t_it)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch,n_layers", [("gemma2-9b", 4),
                                           ("gemma2-9b", 5),
                                           ("minicpm-2b", 3),
                                           ("xlstm-350m", 4),
                                           ("xlstm-350m", 5)])
def test_grouped_compression_is_the_reference_on_stacked_leaves(arch,
                                                                n_layers):
    """The reference compresses a stacked leaf (every layer of a period
    slot) with one scale; ``compress_tree`` with
    ``TransformerLM.stacked_groups`` gives the same payloads and
    residuals on the port's per-layer leaves (gemma2's and xLSTM's
    period of 2, with and without a ``rem`` layer)."""
    import dataclasses
    from repro.models.transformer import TransformerLM as JLM
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.models.transformer import TransformerLM
    tcfg = dataclasses.replace(get_arch(arch).reduced(), n_layers=n_layers)
    jcfg = dataclasses.replace(j_get_arch(arch).reduced(), n_layers=n_layers)
    rng = np.random.default_rng(n_layers)
    grads = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * 10.0 ** rng.uniform(-3, 1))
        .astype(np.float32), jax.tree.map(np.asarray,
                                          JLM(jcfg).init(jax.random.PRNGKey(0))))
    jq, _, je = j_gc.compress_tree(_j(grads), jax.tree.map(jnp.zeros_like,
                                                           _j(grads)))
    tg = lm_params_from_arrays(tcfg, grads, "cpu", torch.float32)
    groups = TransformerLM(tcfg, "cpu").stacked_groups(tg)
    assert sorted(i for g in groups for i in g) == list(range(len(leaves(tg))))
    tq, _, te = t_gc.compress_tree(tg, t_gc.init_error(tg), groups)

    def port_layout(tree):
        return lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, tree),
                                     "cpu", torch.float32)
    for a, b in zip(leaves(tq), leaves(port_layout(jq))):
        np.testing.assert_array_equal(a.float().numpy(), b.numpy())
    for a, b in zip(leaves(te), leaves(port_layout(je))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
