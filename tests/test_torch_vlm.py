"""The port's qwen2-vl (family ``vlm``: M-RoPE and prepended patch
embeddings) against the reference, on the CPU (plain attention path).

* ``apply_rope`` with M-RoPE sections (4, 2, 2) at D 16 and (16, 24, 24)
  at D 128, t / h / w positions that differ, within 1e-6 (and a 3-axis
  pos without sections reads axis 0, as the reference);
* the reduced qwen2-vl-2b's ``prefill`` with 8 patch embeddings in front
  of the prompt (logits and the decode cache) and 8 ``decode_step``s
  within atol / rtol 1e-4, and decode-matches-prefill;
* text-only ``ContinuousBatcher`` token ids equal to the reference
  batcher's;
* the port's whisper-tiny and qwen2-vl-2b configs, full and
  ``reduced()``, equal to the reference's field by field.

Parameters are the reference's ``init`` with its zero biases and norm
scales replaced by numpy draws, carried across with
``lm_params_from_arrays`` (the qkv biases stay float32).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ServeConfig as JServeConfig  # noqa: E402
from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models.transformer import TransformerLM as JLM  # noqa: E402
from repro.runtime.serve_loop import ContinuousBatcher as JBatcher  # noqa
from repro.runtime.serve_loop import Request as JRequest  # noqa: E402
from repro.runtime.serve_loop import \
    make_prefill_step as j_make_prefill_step  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs.base import ServeConfig  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.runtime.serve_loop import (ContinuousBatcher,  # noqa: E402
                                            Request, decode_start,
                                            make_prefill_step)

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "qwen2-vl-2b"
_ZERO_LEAVES = ("scale", "bq", "bk", "bv")


def t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections,d", [((4, 2, 2), 16),
                                        ((16, 24, 24), 128)])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_mrope_matches_reference(sections, d, theta):
    """t, h and w positions drawn apart, so each band reads its own
    axis."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, 7, 3, d)).astype(np.float32)
    pos = rng.integers(0, 64, size=(2, 7, 3)).astype(np.int32)
    pos[..., 1] += 100
    pos[..., 2] += 200
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                               sections)
    got = t_layers.apply_rope(t(x), t(pos), theta, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    # each frequency reads the axis of its section
    ends = np.cumsum(sections)
    band = t_layers.mrope_bands(d // 2, sections, 3).numpy()
    assert band.tolist() == [int(np.searchsorted(ends, i, side="right"))
                             for i in range(d // 2)]
    # and differs from rotating by the t positions alone
    plain = t_layers.apply_rope(t(x), t(pos[..., 0]), theta)
    assert not torch.allclose(got, plain, atol=1e-3)


def test_three_axis_pos_without_sections_takes_axis_0():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 5, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 50, size=(1, 5, 3)).astype(np.int32)
    got = t_layers.apply_rope(t(x), t(pos), 1e4)
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(
        got.numpy(), t_layers.apply_rope(t(x), t(pos[..., 0]), 1e4).numpy())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _pair(seed=0, **overrides):
    """(port cfg, reference model, its params, port model, port params)
    for the reduced qwen2-vl-2b, the same parameters in both."""
    tcfg = dataclasses.replace(get_arch(ARCH).reduced(), **overrides)
    jcfg = dataclasses.replace(j_get_arch(ARCH).reduced(), **overrides)
    jm = JLM(jcfg)
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: (rng.normal(0, 0.3, size=np.shape(v)).astype(
                np.float32) if k in _ZERO_LEAVES else walk(v))
                for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return np.asarray(tree)

    arrays = walk(jm.init(jax.random.PRNGKey(seed)))
    return (tcfg, jm, jax.tree.map(jnp.asarray, arrays),
            TransformerLM(tcfg, device="cpu"),
            lm_params_from_arrays(tcfg, arrays, "cpu"))


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    patches = rng.normal(size=(b, cfg.vision_tokens,
                               cfg.d_model)).astype(np.float32)
    return toks, patches


def _j_layers(cache):
    blocks = cache["blocks"]["b0"]
    return [{k: np.asarray(v[j]) for k, v in blocks.items()}
            for j in range(len(np.asarray(blocks["k"])))]


def test_prefill_with_patches_and_decode_match_reference():
    """8 patch embeddings in front of a 12-token prompt (cache 28), then
    8 decode steps at positions 20..27."""
    tcfg, jm, jp, tm, tp = _pair(seed=0)
    b, s, cache_len = 2, 12, 28
    toks, patches = _inputs(tcfg, b, s, 1)
    assert tcfg.attention.mrope_sections == (4, 2, 2)
    assert tcfg.vision_tokens == 8
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        jp, jnp.asarray(toks), cache_len, extra_embeds=jnp.asarray(patches))
    tl, tc = make_prefill_step(tm, tcfg, cache_len)(tp, t(toks), t(patches))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for g, w in zip(tc, _j_layers(jc)):
        for k in ("k", "v"):
            np.testing.assert_allclose(g[k].numpy(), w[k], **TOL)
    assert tc[0]["k"].shape == (b, cache_len, 2, 16)
    rng = np.random.default_rng(2)
    j_decode = jax.jit(jm.decode_step)
    for i in range(8):
        nxt = rng.integers(0, tcfg.vocab_size, size=(b, 1)).astype(np.int32)
        pos = np.full((b, 1), tcfg.vision_tokens + s + i, np.int32)
        jl, jc = j_decode(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
        tl, tc = tm.decode_step(tp, t(nxt), t(pos), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for g, w in zip(tc, _j_layers(jc)):
        np.testing.assert_allclose(g["k"].numpy(), w["k"], **TOL)


def test_prefill_step_vlm_branch_matches_reference_step():
    tcfg, jm, jp, tm, tp = _pair(seed=3)
    toks, patches = _inputs(tcfg, 2, 9, 4)
    got, _ = make_prefill_step(tm, tcfg, 24)(tp, t(toks), t(patches))
    want, _ = j_make_prefill_step(jm, jm.cfg, 24)(
        jp, jnp.asarray(toks), jnp.asarray(patches))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    text, _ = make_prefill_step(tm, tcfg, 24)(tp, t(toks))
    j_text, _ = j_make_prefill_step(jm, jm.cfg, 24)(jp, jnp.asarray(toks))
    np.testing.assert_allclose(text.numpy(), np.asarray(j_text), **TOL)


def test_decode_matches_prefill_with_patches():
    """Decoding the last token at position vision_tokens + S - 1 equals
    the full prefill's last logits (the reference's test_models check)."""
    tcfg, _, _, tm, tp = _pair(seed=5)
    b, s, cache_len = 2, 12, 24
    toks, patches = (t(a) for a in _inputs(tcfg, b, s, 6))
    _, cache = tm.prefill(tp, toks[:, :s - 1], cache_len,
                          extra_embeds=patches)
    pos = torch.full((b, 1), tcfg.vision_tokens + s - 1, dtype=torch.int32)
    got, _ = tm.decode_step(tp, toks[:, s - 1:], pos, cache)
    want, _ = tm.prefill(tp, toks, cache_len, extra_embeds=patches)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("with_patches", [True, False],
                         ids=["patches", "text"])
def test_decode_start_is_where_the_prefill_ends(with_patches):
    """``decode_start`` after a prefill step of all but the last token
    is the position at which decoding that token gives the full prefill
    step's logits: S + 8 with the patch embeddings, S without."""
    tcfg, _, _, tm, tp = _pair(seed=8)
    b, s, cache_len = 2, 10, 24
    toks, patches = (t(a) for a in _inputs(tcfg, b, s, 9))
    extra = patches if with_patches else None
    start = decode_start(tcfg, toks[:, :s - 1], extra)
    assert start == s - 1 + (tcfg.vision_tokens if with_patches else 0)
    step = make_prefill_step(tm, tcfg, cache_len)
    _, cache = step(tp, toks[:, :s - 1], extra)
    pos = torch.full((b, 1), start, dtype=torch.int32)
    got, _ = tm.decode_step(tp, toks[:, s - 1:], pos, cache)
    want, _ = step(tp, toks, extra)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def _requests(cls, vocab):
    rng = np.random.default_rng(7)
    return [cls(rid=i, prompt=[int(x) for x in rng.integers(
        2, vocab, size=int(rng.integers(4, 14)))], max_new=m)
        for i, m in enumerate((5, 9, 3, 7, 6))]


def test_text_only_continuous_batcher_tokens_equal_reference():
    """Untied head (a tied random table makes greedy decoding echo the
    last token); no launch is counted on the CPU."""
    tcfg, jm, jp, tm, tp = _pair(seed=1, tie_embeddings=False)
    scfg = dict(max_batch=2, max_seq=64)
    jb = JBatcher(jm, jm.cfg, JServeConfig(**scfg), jp)
    tb = ContinuousBatcher(tm, tcfg, ServeConfig(**scfg), tp)
    for r in _requests(JRequest, tcfg.vocab_size):
        jb.submit(r)
    for r in _requests(Request, tcfg.vocab_size):
        tb.submit(r)
    kernels.reset_launch_counts()
    jdone = {r.rid: r.out for r in jb.run()}
    tdone = {r.rid: r.out for r in tb.run()}
    assert tdone == jdone
    assert {k: len(v) for k, v in tdone.items()} == \
        {0: 5, 1: 9, 2: 3, 3: 7, 4: 6}
    assert len({x for v in tdone.values() for x in v}) > 10
    assert set(kernels.launch_counts().values()) == {0}


def test_full_width_vlm_holds_biases_float32():
    """At the full config's bfloat16 (a 1-layer slice) the matrices are
    bfloat16, the qkv biases and norm scales float32, and the prefill
    with 256 patch embeddings fills the cache from position 0."""
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=1, vocab_size=64)
    lm = build_model(cfg, device="cpu")
    assert isinstance(lm, TransformerLM)
    p = lm.init(torch.Generator().manual_seed(0))
    lay = p["layers"][0]
    assert lay["attn"]["wq"].dtype == torch.bfloat16
    assert lay["attn"]["bq"].dtype == lay["attn"]["bk"].dtype == \
        lay["ln1"]["scale"].dtype == torch.float32
    assert lay["attn"]["wk"].shape == (1536, 2, 128)
    patches = torch.zeros((1, cfg.vision_tokens, cfg.d_model))
    logits, cache = lm.prefill(p, torch.zeros((1, 3), dtype=torch.int32),
                               cfg.vision_tokens + 8, extra_embeds=patches)
    assert logits.shape == (1, 64) and logits.dtype == torch.bfloat16
    assert cache[0]["k"].shape == (1, 264, 2, 128)
    jcfg = dataclasses.replace(j_get_arch(ARCH), n_layers=1, vocab_size=64)
    arrays = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(0)))
    got = lm_params_from_arrays(cfg, arrays, "cpu")
    assert got["layers"][0]["attn"]["bv"].dtype == torch.float32
    assert got["layers"][0]["attn"]["wv"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-2b"])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_configs_equal_the_reference(arch, reduced):
    """The port's copies, and their reduced forms (M-RoPE sections
    (4, 2, 2), 2 encoder layers over 16 frames, 8 vision tokens), carry
    the reference's values in every field the port keeps."""
    tc, jc = get_arch(arch), j_get_arch(arch)
    if reduced:
        tc, jc = tc.reduced(), jc.reduced()
    for f in dataclasses.fields(tc):
        if f.name in ("attention", "moe"):
            for g in dataclasses.fields(getattr(tc, f.name)):
                assert getattr(getattr(tc, f.name), g.name) == \
                    getattr(getattr(jc, f.name), g.name), (f.name, g.name)
        else:
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.head_dim == jc.head_dim
