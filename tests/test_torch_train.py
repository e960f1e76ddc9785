"""The port's LM training path against the reference, on the CPU (the
flash-attention Function's plain versions), in float32.

* ``train_loss`` and every gradient leaf (``jax.value_and_grad`` of the
  reference's ``_loss_fn``, the trees carried across with
  ``train_state_from_arrays``) for the reduced minicpm-2b, gemma2-9b
  (softcaps, the window), phi4-mini, qwen1.5-4b (qkv bias), qwen2-vl-2b
  with 8 patch embeddings in front (loss on the text positions),
  whisper-tiny (the encoder's and the cross-attention's non-causal
  calls), granite-moe and olmoe (the expert GEMM's Function, the aux
  loss at the reference's weight; also at capacity factors 1.0 and 0.5,
  where picks drop), recurrentgemma (the RG-LRU's Function) and
  xlstm-350m (the mLSTM chunk's Function, the sLSTM through torch's
  autograd of its loop), within atol 1e-5 + rtol 1e-4 (xLSTM's gradient
  leaves within 1e-4 of their largest value: the reference's own
  chunkwise-vs-sequential spread passes the elementwise limit); a
  masked loss too; ``MoEConfig`` field by field;
* 3 ``make_train_step`` steps from the same state and batches
  (microbatches 1 and 2, ``grad_compress`` off and on, ``wsd`` and
  ``cosine``): each step's loss, grad norm and lr, then every parameter
  and moment within a tolerance scaled by the learning rate
  (``STEP_TOL``), the step counter exact;
* ``remat="full"`` gives the loss and gradients of ``remat="none"``
  bitwise (the same operations, recomputed);
* ``make_train_step`` refuses microbatches that do not divide the batch
  (the reference raises too) and batch leaves of other leading sizes,
  and agrees with the reference where mb divides B;
* ``train_loop`` over ``lm_data`` lowers the loss; its history holds
  Python floats;
* checkpoints: a round trip bitwise, a torn write (no ``COMMIT``) never
  restored, a corrupted leaf refused by its CRC, ``prune``, the async
  writer's host copy taken at ``save``; and the port writes what the
  reference's ``restore`` reads and the other way round, bitwise, with
  the same manifest paths.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.runtime import checkpoint as j_ckpt  # noqa: E402
from repro.runtime import train_loop as j_train  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import train_state_from_arrays  # noqa: E402
from repro_torch.data.pipeline import lm_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402
from repro_torch.runtime.train_loop import (batch_to,  # noqa: E402
                                            loss_fn, make_train_step,
                                            train_loop)
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)
#: parameters after 3 AdamW steps: an update is ~lr a step in size, and
#: where a gradient sits near zero float32 reordering can move
#: m / sqrt(v) by O(1); atol 0.05 lr a step bounds that, rtol for the rest
STEP_TOL = lambda lr: dict(atol=0.05 * lr * 3, rtol=1e-5)  # noqa: E731
MOMENT_TOL = dict(atol=1e-6, rtol=1e-3)
#: with grad_compress an int8 payload element can round the other way
#: (g + e within float32 noise of a half step): that gradient element
#: moves by the scale, its update by up to ~lr a step, its moments and
#: residual by up to the scale, and error feedback carries the flip into
#: the later steps.  So at most ``FLIP_SHARE`` of a leaf's elements (or
#: ``FLIP_COUNT``, for small leaves) may leave the tolerances above, all
#: within ``flip_tol`` (ROADMAP section 3)
FLIP_SHARE = 1e-2
FLIP_COUNT = 4
#: xLSTM's gradients carry float32 rounding far above the other families'
#: (h = num / den, den often exp(-m_t)): the reference's own chunkwise
#: ``mlstm_seq`` against its sequential ``mlstm_seq_ref`` moves leaves
#: past ``TOL``'s elementwise limit on this test's setup
#: (``test_xlstm_reference_own_gradient_spread_needs_the_leaf_scale``).
#: Such a leaf is held within this share of its largest value (rtol
#: ``TOL``'s); the loss keeps ``TOL`` (ROADMAP section 3)
LEAF_SCALED = {"xlstm-350m": 1e-4}


def flip_tol(key, lr):
    return dict(atol=lr * 3 if key == "params" else 1e-2, rtol=1e-3)
ARCHS = ["minicpm-2b", "gemma2-9b", "phi4-mini-3.8b", "qwen1.5-4b",
         "qwen2-vl-2b", "whisper-tiny", "granite-moe-1b-a400m",
         "olmoe-1b-7b", "recurrentgemma-9b", "xlstm-350m"]
#: leaves the reference initialises to zero: drawn so each counts
_ZERO_LEAVES = ("scale", "bias", "bq", "bk", "bv", "b_a", "b_i")


def _cfgs(arch, **overrides):
    return (dataclasses.replace(get_arch(arch).reduced(), **overrides),
            dataclasses.replace(j_get_arch(arch).reduced(), **overrides))


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: (rng.normal(0, 0.3, size=v.shape).astype(np.float32)
                        if k in _ZERO_LEAVES else walk(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return np.asarray(tree)
    return walk(jax.tree.map(np.asarray, params))


def _batch(cfg, b, s, seed):
    """tokens, labels (and patch embeddings or frames) as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(
            size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _setup(arch, seed=0, **overrides):
    """(port cfg, ref cfg, ref model, port model, ref state arrays)."""
    tcfg, jcfg = _cfgs(arch, **overrides)
    jm = j_build_model(jcfg)
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(seed)), seed)
    zeros = jax.tree.map(np.zeros_like, params)
    arrays = {"params": params, "opt": {"m": zeros, "v": zeros,
                                        "step": np.int32(0)}}
    return tcfg, jcfg, jm, build_model(tcfg, "cpu"), arrays


def _port_grads(tcfg, tm, state, batch):
    loss = loss_fn(tm, tcfg, state["params"], batch_to(batch, "cpu"))
    loss.backward()
    return loss.item(), [p.grad for p in leaves(state["params"])]


def _ref_grads(jcfg, jm, params, batch):
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, b: j_train._loss_fn(jm, jcfg, p, b)))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    return float(loss), jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    tcfg, jcfg, jm, tm, arrays = _setup(arch)
    batch = _batch(tcfg, 2, 12, 1)
    jl, jg = _ref_grads(jcfg, jm, arrays["params"], batch)
    state = train_state_from_arrays(tcfg, arrays, "cpu")
    tl, tg = _port_grads(tcfg, tm, state, batch)
    np.testing.assert_allclose(tl, jl, **TOL)
    want = train_state_from_arrays(
        tcfg, {"params": jg, "opt": arrays["opt"]}, "cpu")["params"]
    paths = [p for p, _ in leaves_with_paths(want)]
    assert len(tg) == len(paths)
    for path, g, w in zip(paths, tg, leaves(want)):
        w = w.detach().numpy()
        tol = dict(TOL, atol=LEAF_SCALED[arch] * np.abs(w).max()) \
            if arch in LEAF_SCALED else TOL
        np.testing.assert_allclose(g.numpy(), w, **tol, err_msg=path)


def test_xlstm_reference_own_gradient_spread_needs_the_leaf_scale():
    """The witness behind ``LEAF_SCALED``: the reference's xlstm-350m
    gradients with its chunkwise ``mlstm_seq`` and with its sequential
    ``mlstm_seq_ref`` (the same function) differ past ``TOL``'s
    elementwise limit at seed 1, and within the leaf-scaled one."""
    from repro.models import recurrent as j_rec
    tcfg, jcfg, jm, tm, arrays = _setup("xlstm-350m", 1)
    batch = _batch(tcfg, 2, 12, 2)
    _, chunked = _ref_grads(jcfg, jm, arrays["params"], batch)
    orig = j_rec.mlstm_seq
    j_rec.mlstm_seq = j_rec.mlstm_seq_ref
    try:
        _, seq = _ref_grads(jcfg, jm, arrays["params"], batch)
    finally:
        j_rec.mlstm_seq = orig
    over = 0.0
    for a, b in zip(jax.tree.leaves(chunked), jax.tree.leaves(seq)):
        gap = np.abs(a - b)
        over = max(over, float((gap / (TOL["atol"] + TOL["rtol"] *
                                       np.abs(a))).max()))
        assert gap.max() <= LEAF_SCALED["xlstm-350m"] * np.abs(a).max()
    assert over > 1.0


@pytest.mark.parametrize("arch,cf", [("granite-moe-1b-a400m", 1.0),
                                     ("granite-moe-1b-a400m", 0.5),
                                     ("olmoe-1b-7b", 0.5)])
def test_moe_gradients_match_reference_when_picks_drop(arch, cf,
                                                      monkeypatch):
    """At capacity factors under the reduced configs' drop-free E / k some
    picks pass their expert's capacity: the combine reads a clamped slot
    with weight 0 and empty slots read the appended zero row; the loss
    (with the aux term) and every gradient still match the reference's."""
    tcfg, jcfg = _cfgs(arch)
    tcfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=cf)) for c in (tcfg, jcfg))
    jm = j_build_model(jcfg)
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(7)), 7)
    zeros = jax.tree.map(np.zeros_like, params)
    arrays = {"params": params, "opt": {"m": zeros, "v": zeros,
                                        "step": np.int32(0)}}
    batch = _batch(tcfg, 2, 12, 8)
    jl, jg = _ref_grads(jcfg, jm, params, batch)
    state = train_state_from_arrays(tcfg, arrays, "cpu")
    kept = []
    route = moe_mod.moe_route

    def recorded(*a, **kw):
        r = route(*a, **kw)
        kept.append(r["keep"])
        return r
    monkeypatch.setattr(moe_mod, "moe_route", recorded)
    tl, tg = _port_grads(tcfg, build_model(tcfg, "cpu"), state, batch)
    assert len(kept) == tcfg.n_layers and not all(k.all() for k in kept)
    np.testing.assert_allclose(tl, jl, **TOL)
    want = train_state_from_arrays(
        tcfg, {"params": jg, "opt": arrays["opt"]}, "cpu")["params"]
    for (path, w), g in zip(leaves_with_paths(want), tg):
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), **TOL,
                                   err_msg=path)


def test_moe_loss_adds_the_weighted_aux_term():
    """The MoE loss is the cross-entropy plus ``aux_loss_weight`` times the
    layers' mean load-balancing loss: the reference's, at its weight and
    at 0 (the cross-entropy alone), and the two differ."""
    got, want = [], []
    for weight in (0.01, 0.0):
        tcfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, aux_loss_weight=weight))
            for c in _cfgs("granite-moe-1b-a400m"))
        jm = j_build_model(jcfg)
        params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(2)), 2)
        batch = _batch(tcfg, 2, 12, 3)
        want.append(float(jm.train_loss(
            jax.tree.map(jnp.asarray, params), jnp.asarray(batch["tokens"]),
            jnp.asarray(batch["labels"]))))
        zeros = jax.tree.map(np.zeros_like, params)
        state = train_state_from_arrays(
            tcfg, {"params": params, "opt": {"m": zeros, "v": zeros,
                                             "step": np.int32(0)}}, "cpu")
        got.append(build_model(tcfg, "cpu").train_loss(
            state["params"], torch.from_numpy(batch["tokens"]).long(),
            torch.from_numpy(batch["labels"]).long()).item())
    np.testing.assert_allclose(got, want, **TOL)
    assert got[0] > got[1]


def test_moe_config_fields_match_reference():
    """``MoEConfig``'s fields and defaults, ``router_jitter`` and
    ``aux_loss_weight`` among them, equal the reference's; every MoE
    config's values too."""
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro_torch.configs.base import MoEConfig
    assert [(f.name, f.default) for f in dataclasses.fields(MoEConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(JMoEConfig)]
    for arch in ("granite-moe-1b-a400m", "olmoe-1b-7b"):
        assert dataclasses.asdict(get_arch(arch).moe) == \
            dataclasses.asdict(j_get_arch(arch).moe)


def test_masked_loss_matches_reference():
    tcfg, jcfg, jm, tm, arrays = _setup("minicpm-2b", 3)
    batch = _batch(tcfg, 2, 12, 4)
    mask = (np.random.default_rng(5).random((2, 12)) < 0.6).astype(
        np.float32)
    want = float(jm.train_loss(jax.tree.map(jnp.asarray, arrays["params"]),
                               jnp.asarray(batch["tokens"]),
                               jnp.asarray(batch["labels"]),
                               mask=jnp.asarray(mask)))
    state = train_state_from_arrays(tcfg, arrays, "cpu")
    got = tm.train_loss(state["params"], torch.from_numpy(batch["tokens"]),
                        torch.from_numpy(batch["labels"]),
                        mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), want, **TOL)


STEP_CASES = [
    ("minicpm-2b", 1, False, "wsd"),
    ("minicpm-2b", 2, False, "cosine"),
    ("minicpm-2b", 2, True, "wsd"),
    ("gemma2-9b", 2, False, "wsd"),
    ("gemma2-9b", 1, True, "cosine"),
    ("qwen2-vl-2b", 2, False, "wsd"),
    ("whisper-tiny", 2, True, "wsd"),
    ("granite-moe-1b-a400m", 2, True, "wsd"),
    ("recurrentgemma-9b", 2, True, "cosine"),
    ("xlstm-350m", 2, False, "wsd"),
]


@pytest.mark.parametrize("arch,mb,compress,schedule", STEP_CASES)
def test_three_train_steps_match_reference(arch, mb, compress, schedule):
    tcfg, jcfg, jm, tm, arrays = _setup(arch, 2)
    kw = dict(steps=3, lr=1e-3, warmup_steps=1, microbatches=mb,
              grad_compress=compress, schedule=schedule)
    j_tc, t_tc = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = j_train.init_state(
        type("M", (), {"init": lambda self, k: jax.tree.map(
            jnp.asarray, arrays["params"])})(), None, j_tc)
    jstep = jax.jit(j_train.make_train_step(jm, jcfg, j_tc))
    if compress:
        arrays = dict(arrays, err=jax.tree.map(np.zeros_like,
                                               arrays["params"]))
    state = train_state_from_arrays(tcfg, arrays, "cpu")
    tstep = make_train_step(tm, tcfg, t_tc)
    for i in range(3):
        batch = _batch(tcfg, 4, 10, 10 + i)
        jstate, jm_ = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, tm_ = tstep(state, batch)
        np.testing.assert_allclose(tm_["loss"].item(), float(jm_["loss"]),
                                   **TOL)
        np.testing.assert_allclose(tm_["grad_norm"].item(),
                                   float(jm_["grad_norm"]), rtol=1e-4)
        assert tm_["lr"].item() == float(jm_["lr"])
        assert int(tm_["step"]) == int(jm_["step"]) == i + 1
    want = train_state_from_arrays(
        tcfg, {"params": jax.tree.map(np.asarray, jstate["params"]),
               "opt": {k: jax.tree.map(np.asarray, jstate["opt"][k])
                       for k in ("m", "v", "step")},
               "err": (jax.tree.map(np.asarray, jstate["err"])
                       if compress else None)}, "cpu")
    for key in ("params", "m", "v") + (("err",) if compress else ()):
        got_t = state["opt"][key] if key in "mv" else state[key]
        want_t = want["opt"][key] if key in "mv" else want[key]
        tol = STEP_TOL(kw["lr"]) if key == "params" else MOMENT_TOL
        for (path, g), w in zip(leaves_with_paths(got_t), leaves(want_t)):
            g, w = g.detach().numpy(), w.detach().numpy()
            if compress:
                off = ~np.isclose(g, w, **tol)
                assert off.mean() <= FLIP_SHARE or off.sum() <= FLIP_COUNT, \
                    f"{key}{path}: {off.sum()}"
                tol = flip_tol(key, kw["lr"])
            np.testing.assert_allclose(g, w, **tol, err_msg=f"{key}{path}")


@pytest.mark.parametrize("arch", ["minicpm-2b", "gemma2-9b",
                                  "granite-moe-1b-a400m",
                                  "recurrentgemma-9b", "xlstm-350m"])
def test_remat_equals_no_remat(arch):
    tcfg, jcfg, jm, tm, arrays = _setup(arch, 4)
    batch = _batch(tcfg, 2, 12, 6)
    got = []
    for remat in ("none", "full"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        state = train_state_from_arrays(cfg, arrays, "cpu")
        got.append(_port_grads(cfg, build_model(cfg, "cpu"), state, batch))
    assert got[0][0] == got[1][0]
    for a, b in zip(got[0][1], got[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("b,mb", [(3, 2), (5, 2), (4, 3)])
def test_microbatches_that_do_not_divide_the_batch_are_refused(b, mb):
    """The reference reshapes the batch to (mb, b // mb, ...) and so raises
    when mb does not divide it; the port raises ``ValueError`` rather than
    train on the first mb * (b // mb) rows."""
    tcfg, jcfg, jm, tm, arrays = _setup("minicpm-2b", 2)
    kw = dict(steps=1, lr=1e-3, warmup_steps=1, microbatches=mb)
    batch = _batch(tcfg, b, 6, 1)
    jstate = j_train.init_state(
        type("M", (), {"init": lambda self, k: jax.tree.map(
            jnp.asarray, arrays["params"])})(), None, JTrainConfig(**kw))
    with pytest.raises(TypeError, match="cannot reshape"):
        j_train.make_train_step(jm, jcfg, JTrainConfig(**kw))(
            jstate, jax.tree.map(jnp.asarray, batch))
    state = train_state_from_arrays(tcfg, arrays, "cpu")
    before = [p.detach().clone() for p in leaves(state["params"])]
    with pytest.raises(ValueError, match=f"microbatches={mb} does not "
                                         f"divide the batch of {b}"):
        make_train_step(tm, tcfg, TrainConfig(**kw))(state, batch)
    assert all(torch.equal(p, q) for p, q in
               zip(leaves(state["params"]), before))


def test_microbatch_leaves_of_other_lengths_are_refused():
    """Batch leaves that disagree on their leading size cannot be split
    into the same microbatches: ``ValueError`` naming the sizes."""
    tcfg, _, _, tm, arrays = _setup("minicpm-2b", 2)
    batch = _batch(tcfg, 4, 6, 1)
    batch["labels"] = batch["labels"][:2]
    state = train_state_from_arrays(tcfg, arrays, "cpu")
    step = make_train_step(tm, tcfg, TrainConfig(steps=1, microbatches=2))
    with pytest.raises(ValueError, match="disagree on their leading size"):
        step(state, batch)


def test_dividing_microbatches_agree_with_the_reference():
    """Where mb divides B (B 6 at mb 2 and 3), one step's loss, grad norm
    and parameters match the reference's, as at B 4."""
    tcfg, jcfg, jm, tm, arrays = _setup("minicpm-2b", 2)
    for mb in (2, 3):
        kw = dict(steps=1, lr=1e-3, warmup_steps=1, microbatches=mb)
        batch = _batch(tcfg, 6, 6, 3)
        jstate = j_train.init_state(
            type("M", (), {"init": lambda self, k: jax.tree.map(
                jnp.asarray, arrays["params"])})(), None, JTrainConfig(**kw))
        jstate, jmet = jax.jit(j_train.make_train_step(
            jm, jcfg, JTrainConfig(**kw)))(jstate,
                                          jax.tree.map(jnp.asarray, batch))
        state = train_state_from_arrays(tcfg, arrays, "cpu")
        state, tmet = make_train_step(tm, tcfg, TrainConfig(**kw))(state,
                                                                   batch)
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                                   **TOL)
        np.testing.assert_allclose(tmet["grad_norm"].item(),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        want = train_state_from_arrays(
            tcfg, {"params": jax.tree.map(np.asarray, jstate["params"]),
                   "opt": arrays["opt"]}, "cpu")["params"]
        for (path, g), w in zip(leaves_with_paths(state["params"]),
                                leaves(want)):
            np.testing.assert_allclose(g.detach().numpy(),
                                       w.detach().numpy(),
                                       **STEP_TOL(kw["lr"]), err_msg=path)


def test_train_loop_lowers_the_loss():
    cfg = dataclasses.replace(get_arch("minicpm-2b").reduced(), n_layers=2)
    tcfg = TrainConfig(steps=12, lr=3e-3, warmup_steps=2, microbatches=2)
    seen = []
    state, hist = train_loop(build_model(cfg, "cpu"), cfg, tcfg,
                             iter(lm_data(cfg, 4, 32, prefetch=0)),
                             generator=torch.Generator().manual_seed(0),
                             hooks=[lambda s, st, m: seen.append(s)])
    assert seen == list(range(12)) and len(hist) == 12
    assert all(isinstance(v, float) for h in hist for v in h.values())
    assert hist[-1]["step"] == 12.0
    assert np.mean([h["loss"] for h in hist[-3:]]) < \
        np.mean([h["loss"] for h in hist[:3]])
    # resuming from the state runs no further step
    _, more = train_loop(build_model(cfg, "cpu"), cfg, tcfg, iter(()),
                         state=state)
    assert more == []


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _whisper_state():
    tcfg, jcfg, jm, tm, arrays = _setup("whisper-tiny", 5)
    rng = np.random.default_rng(9)
    arrays["opt"]["m"] = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        arrays["params"])
    arrays["opt"]["step"] = np.int32(7)
    return tcfg, arrays


def _equal_trees(got, want):
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach())


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    tcfg, arrays = _whisper_state()
    state = train_state_from_arrays(tcfg, arrays, "cpu")
    ckpt.save(str(tmp_path), 7, state)
    assert ckpt.latest_step(str(tmp_path)) == 7
    back = ckpt.restore(str(tmp_path), 7, state)
    _equal_trees(back, state)
    assert back["opt"]["step"].dtype == torch.int32


def test_torn_write_is_never_restored(tmp_path):
    tree = {"a": torch.arange(4.0)}
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 2, tree)
    os.remove(tmp_path / "step_00000002" / "COMMIT")
    os.makedirs(tmp_path / "step_00000003.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.latest_step(str(tmp_path / "missing")) is None


def test_crc_mismatch_is_refused(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(2)]}
    d = ckpt.save(str(tmp_path), 3, tree)
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    entry = next(e for e in manifest["leaves"] if e["path"] == "['a']")
    arr = np.load(os.path.join(d, entry["file"]))
    arr[0, 0] += 1.0
    np.save(os.path.join(d, entry["file"]), arr)
    with pytest.raises(IOError, match="checksum mismatch for \\['a'\\]"):
        ckpt.restore(str(tmp_path), 3, tree)
    back = ckpt.restore(str(tmp_path), 3, tree, verify=False)
    assert back["a"][0, 0].item() == 1.0
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), 3, {"a": torch.zeros(3, 2),
                                        "b": [torch.ones(2)]}, verify=False)


def test_prune_and_async_checkpointer_copy_at_save(tmp_path):
    w = torch.zeros(3)
    writer = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        w.fill_(float(step))
        writer.save(step, {"w": w})
        w.fill_(-1.0)                  # an in-place update after save()
    writer.close()
    steps = sorted(os.listdir(tmp_path))
    assert steps == ["step_00000002", "step_00000003"]
    back = ckpt.restore(str(tmp_path), 3, {"w": w})
    assert back["w"].tolist() == [3.0, 3.0, 3.0]


def test_the_reference_reads_what_the_port_writes(tmp_path):
    tcfg, arrays = _whisper_state()
    state = train_state_from_arrays(tcfg, arrays, "cpu")
    ckpt.save(str(tmp_path), 7, state)
    like = {"params": jax.tree.map(jnp.asarray, arrays["params"]),
            "opt": {"m": jax.tree.map(jnp.asarray, arrays["opt"]["m"]),
                    "v": jax.tree.map(jnp.asarray, arrays["opt"]["v"]),
                    "step": jnp.int32(0)}}
    back = j_ckpt.restore(str(tmp_path), 7, like)
    got = jax.tree.leaves(back)
    want = [t.detach().numpy() for t in leaves(state)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_the_port_reads_what_the_reference_writes(tmp_path):
    tcfg, arrays = _whisper_state()
    tree = {"params": arrays["params"], "opt": arrays["opt"]}
    j_ckpt.save(str(tmp_path / "ref"), 7, jax.tree.map(jnp.asarray, tree))
    ckpt.save(str(tmp_path / "port"), 7,
              train_state_from_arrays(tcfg, arrays, "cpu"))
    manifests = [json.load(open(tmp_path / w / "step_00000007" /
                                "manifest.json")) for w in ("ref", "port")]
    assert manifests[0] == manifests[1]
    like = train_state_from_arrays(tcfg, arrays, "cpu")
    back = ckpt.restore(str(tmp_path / "ref"), 7, like)
    _equal_trees(back, like)


def test_run_configs_and_cells_match_reference():
    """``TrainConfig``, ``MeshConfig`` (both pod meshes), ``RunConfig``
    (its ``serve`` on the port's fields) and ``iter_cells`` equal the
    reference's, field by field; ``remat`` is ``full`` at full width and
    ``none`` reduced."""
    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro_torch.configs import base as tbase
    from repro_torch.configs import registry as treg
    for name in ("TrainConfig", "MeshConfig"):
        assert dataclasses.asdict(getattr(tbase, name)()) == \
            dataclasses.asdict(getattr(jbase, name)())
    # the port's ServeConfig keeps the fields its batcher reads
    t, j = tbase.RunConfig(), jbase.RunConfig()
    assert (t.arch, t.shape) == (j.arch, j.shape) == ("minicpm-2b",
                                                      "train_4k")
    assert dataclasses.asdict(t.mesh) == dataclasses.asdict(j.mesh)
    assert dataclasses.asdict(t.train) == dataclasses.asdict(j.train)
    assert all(getattr(j.serve, k) == v
               for k, v in dataclasses.asdict(t.serve).items())
    for name in ("SINGLE_POD_MESH", "MULTI_POD_MESH"):
        t, j = getattr(tbase, name), getattr(jbase, name)
        assert (t.shape, t.axes, t.n_devices, t.multi_pod) == \
            (j.shape, j.axes, j.n_devices, j.multi_pod)
    got = [(c.name, s.name, ok) for c, s, ok in treg.iter_cells()]
    want = [(c.name, s.name, ok) for c, s, ok in jreg.iter_cells()]
    assert got == want and len(got) == 40
    for arch in treg.LM_ARCHS:
        assert get_arch(arch).remat == j_get_arch(arch).remat == "full"
        assert get_arch(arch).reduced().remat == "none"
