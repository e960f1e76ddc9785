"""The port's whisper-tiny (``models.whisper.WhisperLM``) against the
reference, on the CPU (plain attention path).

* layers: ``sinusoid_at`` at positions up to 1,499, each value within
  1e-6 + pos 2^-22 (the two frameworks' float32 ``exp`` give frequencies
  an ulp or two apart, which the angle pos x frequency carries: 1.2e-4
  at position 1,499, d 384) and ``layernorm`` with random scale and
  bias (1e-5);
* ``encode`` within 1e-5 on the reduced config at its 16 frames and at a
  ragged 37;
* ``prefill`` logits and the decode cache (self K/V, cross K/V), then 8
  ``decode_step``s' logits within atol / rtol 1e-4 (the tolerance
  ``tests/test_torch_lm.py`` holds: float32 sums in another order), at
  both frame counts;
* decoding token t from a prefill of the first t tokens equals the full
  prefill's logits at t (the reference's ``tests/test_models.py``
  check, here within 1e-4);
* ``build_model`` dispatches family ``audio`` to ``WhisperLM``,
  ``make_prefill_step``'s audio branch passes the frames, and
  ``whisper_params_from_arrays`` keeps norms and biases in float32.

Parameters come from the reference's ``WhisperLM.init`` with its zero
biases and unit scales replaced by numpy draws, so every leaf counts,
and are carried across with ``whisper_params_from_arrays``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import whisper as j_whisper  # noqa: E402
from repro.runtime.serve_loop import \
    make_prefill_step as j_make_prefill_step  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import whisper_params_from_arrays  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import whisper as t_whisper  # noqa: E402
from repro_torch.runtime.serve_loop import (decode_start,  # noqa: E402
                                            make_decode_step,
                                            make_prefill_step)

TOL = dict(atol=1e-4, rtol=1e-4)
ENC_TOL = dict(atol=1e-5, rtol=1e-5)
#: the reduced config's frames, and a count that is no multiple of 8
FRAMES = [16, 37]
ARCH = "whisper-tiny"
#: leaves the reference initialises to zero or one
_CONST_LEAVES = ("scale", "bias", "bq", "bk", "bv")


def t(x):
    return torch.as_tensor(np.asarray(x))


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: (rng.normal(0, 0.3, size=np.shape(v)).astype(
                np.float32) + (1.0 if k == "scale" else 0.0)
                if k in _CONST_LEAVES else walk(v))
                for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return np.asarray(tree)
    return walk(params)


def _pair(seed=0, **overrides):
    """(reference model, its params, port model, port params) for the
    reduced whisper-tiny, the same parameters in both."""
    jcfg = dataclasses.replace(j_get_arch(ARCH).reduced(), **overrides)
    tcfg = dataclasses.replace(get_arch(ARCH).reduced(), **overrides)
    jm = j_whisper.WhisperLM(jcfg)
    arrays = _perturbed(jm.init(jax.random.PRNGKey(seed)), seed)
    return (jm, jax.tree.map(jnp.asarray, arrays),
            t_whisper.WhisperLM(tcfg, device="cpu"),
            whisper_params_from_arrays(tcfg, arrays, "cpu"))


def _frames(cfg, b, n, seed):
    return np.random.default_rng(seed).normal(
        size=(b, n, cfg.d_model)).astype(np.float32)


def _check_cache(got, want):
    """Port cache (one flat dict a layer) against the reference's
    ``{"layers": [{"self": {k, v}, "cross_k", "cross_v"}]}``."""
    assert len(got) == len(want["layers"])
    for g, w in zip(got, want["layers"]):
        for name, ref in (("k", w["self"]["k"]), ("v", w["self"]["v"]),
                          ("cross_k", w["cross_k"]),
                          ("cross_v", w["cross_v"])):
            assert g[name].shape == ref.shape, name
            np.testing.assert_allclose(g[name].numpy(), np.asarray(ref),
                                       **TOL)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [64, 384])
def test_sinusoid_matches_reference(d):
    pos = np.array([[0, 1, 2, 447], [1499, 7, 300, 1000]], np.int32)
    want = j_whisper.sinusoid_at(jnp.asarray(pos), d)
    got = t_whisper.sinusoid_at(t(pos), d)
    assert got.shape == (2, 4, d) and got.dtype == torch.float32
    gap = np.abs(got.numpy() - np.asarray(want))
    assert (gap <= 1e-6 + pos[..., None] * 2.0 ** -22).all(), gap.max()
    assert gap[0, :3].max() <= 1e-6


def test_layernorm_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 24)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=24).astype(np.float32),
         "bias": rng.normal(size=24).astype(np.float32)}
    want = j_layers.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x))
    got = t_layers.layernorm({k: t(v) for k, v in p.items()}, t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENC_TOL)
    init = t_layers.layernorm_init(24, "cpu")
    assert init["scale"].dtype == init["bias"].dtype == torch.float32
    assert bool((init["scale"] == 1).all()) and bool((init["bias"] == 0).all())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_frames", FRAMES)
def test_encode_matches_reference(n_frames):
    jm, jp, tm, tp = _pair()
    frames = _frames(tm.cfg, 2, n_frames, 1)
    want = jm.encode(jp, jnp.asarray(frames))
    got = tm.encode(tp, t(frames))
    assert got.shape == (2, n_frames, tm.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENC_TOL)


@pytest.mark.parametrize("n_frames", FRAMES)
def test_prefill_and_decode_match_reference(n_frames):
    jm, jp, tm, tp = _pair(seed=1)
    b, s, cache_len = 2, 12, 24
    rng = np.random.default_rng(n_frames)
    frames = _frames(tm.cfg, b, n_frames, 2)
    toks = rng.integers(0, tm.cfg.vocab_size, size=(b, s)).astype(np.int32)
    j_prefill = jax.jit(jm.prefill, static_argnums=3)
    j_decode = jax.jit(jm.decode_step)
    jl, jc = j_prefill(jp, jnp.asarray(toks), jnp.asarray(frames), cache_len)
    tl, tc = tm.prefill(tp, t(toks), t(frames), cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_cache(tc, jc)
    assert tc[0]["cross_k"].shape == (b, n_frames, 4, 16)
    for i in range(8):
        nxt = rng.integers(0, tm.cfg.vocab_size, size=(b, 1)).astype(np.int32)
        pos = np.full((b, 1), s + i, np.int32)
        jl, jc = j_decode(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
        tl, tc = tm.decode_step(tp, t(nxt), t(pos), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_cache(tc, jc)


def test_decode_matches_prefill():
    """Token t decoded from a prefill of tokens < t equals the full
    prefill's last logits (the reference's ``test_models.py`` check)."""
    _, _, tm, tp = _pair(seed=2)
    b, s, cache_len = 2, 12, 24
    rng = np.random.default_rng(3)
    frames = t(_frames(tm.cfg, b, tm.cfg.enc_seq, 4))
    toks = t(rng.integers(0, tm.cfg.vocab_size, size=(b, s)).astype(np.int32))
    _, cache = tm.prefill(tp, toks[:, :s - 1], frames, cache_len)
    pos = torch.full((b, 1), s - 1, dtype=torch.int32)
    got, _ = tm.decode_step(tp, toks[:, s - 1:], pos, cache)
    want, _ = tm.prefill(tp, toks, frames, cache_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("n_frames", FRAMES)
def test_decode_start_ignores_the_frames(n_frames):
    """The frames take no decoder position: after a prefill step of all
    but the last token, decoding it at ``decode_start`` (S - 1, whatever
    the frame count) gives the full prefill step's logits."""
    _, _, tm, tp = _pair(seed=6, enc_seq=n_frames)
    b, s = 2, 9
    rng = np.random.default_rng(7)
    frames = t(_frames(tm.cfg, b, n_frames, 8))
    toks = t(rng.integers(0, tm.cfg.vocab_size, size=(b, s)).astype(np.int32))
    start = decode_start(tm.cfg, toks[:, :s - 1], frames)
    assert start == s - 1
    step = make_prefill_step(tm, tm.cfg, 16)
    _, cache = step(tp, toks[:, :s - 1], frames)
    pos = torch.full((b, 1), start, dtype=torch.int32)
    got, _ = tm.decode_step(tp, toks[:, s - 1:], pos, cache)
    want, _ = step(tp, toks, frames)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_init_cache_layout():
    tm = t_whisper.WhisperLM(get_arch(ARCH).reduced(), device="cpu")
    cache = tm.init_cache(3, 20)
    assert len(cache) == tm.cfg.n_layers
    assert {k: tuple(v.shape) for k, v in cache[0].items()} == {
        "k": (3, 20, 4, 16), "v": (3, 20, 4, 16),
        "cross_k": (3, 16, 4, 16), "cross_v": (3, 16, 4, 16)}
    jcache = j_whisper.WhisperLM(j_get_arch(ARCH).reduced()).init_cache(3, 20)
    assert tuple(jcache["layers"][0]["cross_k"].shape) == (3, 16, 4, 16)


# ---------------------------------------------------------------------------
# entry points and parameters
# ---------------------------------------------------------------------------


def test_build_model_dispatches_audio_to_whisper():
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg, device="cpu")
    assert isinstance(model, t_whisper.WhisperLM) and model.cfg == cfg
    p = model.init(torch.Generator().manual_seed(0))
    assert len(p["enc"]) == cfg.enc_layers == 2
    assert len(p["dec"]) == cfg.n_layers == 4
    assert set(p["dec"][0]) == {"ln1", "ln2", "attn", "mlp", "ln_x", "xattn"}
    assert set(p["enc"][0]) == {"ln1", "ln2", "attn", "mlp"}
    with pytest.raises(ValueError, match="family 'audio'"):
        t_whisper.WhisperLM(get_arch("phi4-mini-3.8b").reduced(),
                            device="cpu")


def test_prefill_step_passes_frames_and_decode_step_is_greedy():
    """``make_prefill_step``'s audio branch: ``extra`` is the frames, the
    result the reference's step's; the decode step returns the argmax
    and counts no launch on the CPU."""
    jm, jp, tm, tp = _pair(seed=3)
    rng = np.random.default_rng(5)
    frames = _frames(tm.cfg, 2, 37, 6)
    toks = rng.integers(0, tm.cfg.vocab_size, size=(2, 9)).astype(np.int32)
    kernels.reset_launch_counts()
    tl, tc = make_prefill_step(tm, tm.cfg, 16)(tp, t(toks), t(frames))
    jl, _ = j_make_prefill_step(jm, jm.cfg, 16)(jp, jnp.asarray(toks),
                                                jnp.asarray(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt = torch.argmax(tl, -1).to(torch.int32)[:, None]
    pos = torch.full((2, 1), 9, dtype=torch.int32)
    got, _ = make_decode_step(tm)(tp, tc, nxt, pos, None)
    logits, _ = tm.decode_step(tp, nxt, pos, tm.prefill(tp, t(toks),
                                                        t(frames), 16)[1])
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.argmax(logits, -1).to(torch.int32))
    assert set(kernels.launch_counts().values()) == {0}


def test_params_keep_norms_and_biases_float32():
    """At bfloat16 the matrices are held in bfloat16, the layer-norm
    scales and biases and the qkv biases in float32; a tree with the
    wrong layer count raises."""
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="bfloat16")
    arrays = jax.tree.map(
        np.asarray, j_whisper.WhisperLM(j_get_arch(ARCH).reduced()).init(
            jax.random.PRNGKey(0)))
    p = whisper_params_from_arrays(cfg, arrays, "cpu")
    lay = p["dec"][1]
    assert lay["xattn"]["wq"].dtype == lay["mlp"]["w_in"].dtype == \
        p["embed"]["table"].dtype == torch.bfloat16
    assert lay["ln_x"]["bias"].dtype == lay["ln1"]["scale"].dtype == \
        lay["xattn"]["bk"].dtype == p["enc_norm"]["bias"].dtype == \
        torch.float32
    np.testing.assert_array_equal(
        p["enc"][0]["attn"]["wk"].float().numpy(),
        torch.tensor(arrays["enc"][0]["attn"]["wk"]).to(torch.bfloat16)
        .float().numpy())
    with pytest.raises(ValueError, match="decoder layers"):
        whisper_params_from_arrays(
            dataclasses.replace(cfg, n_layers=3), arrays, "cpu")
