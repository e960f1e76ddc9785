"""The port's LM serving path against the reference, on the CPU (plain
attention path).

* layers: ``rmsnorm`` (random scale), rotary embeddings at theta 1e4 and
  1e6, the tanh-approximate GELU, ``softcap``, the gated MLPs, and
  gemma's embedding scale rounded to bfloat16 (59.75, not 59.87);
* ``TransformerLM.prefill`` logits and cache, then 8 ``decode_step``s'
  logits and the final cache, against the reference for the reduced
  gemma2-9b (also with an odd layer count, so one layer is ``rem``),
  phi4-mini, qwen1.5-4b (qkv bias), minicpm-2b, the MoE granite-moe and
  olmoe, griffin's recurrentgemma (RG-LRU state in the cache, one
  ``rem`` layer) and xlstm (sLSTM and mLSTM states in the cache, the
  mLSTM cell through the chunkwise plain version) in float32, within
  atol / rtol 1e-4 (float32 sums in another order through 4 layers);
* a reduced gemma2-9b and a reduced recurrentgemma-9b with a 40-token
  prompt, window 32 and cache 48: the prefill's window mask and rolling
  cache and the decode's ``pos`` mapping on the rolling buffer all bite;
* ``ContinuousBatcher.run`` over 5 requests at ``max_batch=2`` with
  differing ``max_new``: token ids equal to the reference batcher's;
* ``lm_params_from_arrays`` interleaves ``b0`` / ``b1`` and appends
  ``rem``, and carries xLSTM's cell leaves across unchanged.

Parameters come from the reference's ``init`` with its zero norm scales
and biases replaced by numpy draws, so every leaf matters, and are
carried across with ``lm_params_from_arrays``.
"""
import dataclasses
import math

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
from repro_torch import kernels  # noqa: E402
from repro_torch.configs.base import ServeConfig  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.runtime.serve_loop import (ContinuousBatcher,  # noqa: E402
                                            Request)

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["gemma2-9b", "phi4-mini-3.8b", "qwen1.5-4b", "minicpm-2b",
         "granite-moe-1b-a400m", "olmoe-1b-7b", "recurrentgemma-9b",
         "xlstm-350m"]


def t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_configs_equal_the_reference(arch, reduced):
    """The port's copies of the dense configs, and their reduced forms,
    carry the reference's values in every field the port keeps."""
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
    from repro.core.cost_model import _block_kinds as j_kinds
    from repro_torch.core.cost_model import _block_kinds as t_kinds
    assert t_kinds(tc) == j_kinds(jc)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32) * 3
    scale = rng.normal(size=24).astype(np.float32)
    want = j_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = t_layers.rmsnorm({"scale": t(scale)}, t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, size=(2, 7)).astype(np.int32)
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = t_layers.apply_rope(t(x), t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(t_layers.rope_freqs(16, theta).numpy(),
                               np.asarray(j_layers.rope_freqs(16, theta)),
                               rtol=1e-6)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_gated_mlp_matches_reference(act):
    """GeGLU takes the tanh-approximate GELU (``jax.nn.gelu``'s default)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    p = {k: (rng.normal(size=s) / 4).astype(np.float32) for k, s in
         (("w_in", (16, 40)), ("w_gate", (16, 40)), ("w_out", (40, 16)))}
    want = j_layers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act, True)
    got = t_layers.mlp({k: t(v) for k, v in p.items()}, t(x), act, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    z = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(t_layers._ACT[act](t(z)).numpy(),
                               np.asarray(j_layers._ACT[act](jnp.asarray(z))),
                               atol=1e-6)


def test_softcap_matches_reference():
    z = np.linspace(-300, 300, 61).astype(np.float32)
    for cap in (0.0, 30.0, 50.0):
        np.testing.assert_allclose(
            t_layers.softcap(t(z), cap).numpy(),
            np.asarray(j_layers.softcap(jnp.asarray(z), cap)), atol=1e-5)


def test_gemma_embedding_scale_is_rounded_to_bfloat16():
    cfg = get_arch("gemma2-9b")
    lm = TransformerLM(cfg, device="cpu")
    want = float(jnp.asarray(math.sqrt(cfg.d_model), jnp.bfloat16))
    assert lm.embed_scale == want == 59.75
    assert TransformerLM(cfg.reduced(), device="cpu").embed_scale == 8.0
    assert TransformerLM(get_arch("phi4-mini-3.8b"),
                         device="cpu").embed_scale is None
    # applied in the compute dtype, as the reference multiplies
    rng = np.random.default_rng(3)
    table = rng.normal(size=(11, cfg.d_model)).astype(np.float32)
    toks = np.array([[1, 5, 10]], np.int32)
    params = {"embed": {"table": t(table).to(torch.bfloat16)}}
    got = lm._embed(params, t(toks))
    jlm = JLM(j_get_arch("gemma2-9b"))
    want = jlm._embed({"embed": {"table": jnp.asarray(table)}},
                      jnp.asarray(toks), None)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


#: leaves the reference initialises to zero (``b``: the sLSTM gate bias)
_ZERO_LEAVES = ("scale", "bq", "bk", "bv", "b_a", "b_i", "b")


def _perturbed(params, seed):
    """The reference's params as numpy, zero norm scales and biases
    replaced by draws so each of them counts."""
    rng = np.random.default_rng(seed)
    arrays = jax.tree.map(np.asarray, params)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: (rng.normal(0, 0.3, size=v.shape).astype(np.float32)
                        if k in _ZERO_LEAVES else walk(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree
    return walk(arrays)


def _pair(arch, seed=0, **overrides):
    """(port cfg, reference model, reference params, port model, port
    params) for the reduced ``arch``, the same parameters in both."""
    tcfg = dataclasses.replace(get_arch(arch).reduced(), **overrides)
    jcfg = dataclasses.replace(j_get_arch(arch).reduced(), **overrides)
    jm = JLM(jcfg)
    arrays = _perturbed(jm.init(jax.random.PRNGKey(seed)), seed)
    jparams = jax.tree.map(jnp.asarray, arrays)
    tm = TransformerLM(tcfg, device="cpu")
    return tcfg, jm, jparams, tm, lm_params_from_arrays(tcfg, arrays, "cpu")


def _j_cache_layers(jm, cache):
    """The reference's per-period-slot cache -> one state per layer
    ({"k", "v"}, {"h", "conv"} for an RG-LRU layer, {"C", "n", "m"} or
    {"c", "n", "h", "m"} for an xLSTM layer)."""
    blocks = cache["blocks"]
    n = len(np.asarray(next(iter(blocks["b0"].values()))))
    out = [{k: np.asarray(v[j]) for k, v in blocks[f"b{i}"].items()}
           for j in range(n) for i in range(len(blocks))]
    return out + [{k: np.asarray(v) for k, v in r.items()}
                  for r in cache["rem"]]


def _check_cache(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].shape == w[k].shape
            np.testing.assert_allclose(g[k].numpy(), w[k], **TOL)


def _serve_both(arch, b, s, cache_len, steps, seed=0, **overrides):
    tcfg, jm, jp, tm, tp = _pair(arch, seed, **overrides)
    rng = np.random.default_rng(seed + 10)
    toks = rng.integers(0, tcfg.vocab_size, size=(b, s)).astype(np.int32)
    j_prefill = jax.jit(jm.prefill, static_argnums=2)
    j_decode = jax.jit(jm.decode_step)
    jl, jc = j_prefill(jp, jnp.asarray(toks), cache_len)
    tl, tc = tm.prefill(tp, t(toks), cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_cache(tc, _j_cache_layers(jm, jc))
    for i in range(steps):
        nxt = rng.integers(0, tcfg.vocab_size, size=(b, 1)).astype(np.int32)
        pos = np.full((b, 1), s + i, np.int32)
        jl, jc = j_decode(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
        tl, tc = tm.decode_step(tp, t(nxt), t(pos), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_cache(tc, _j_cache_layers(jm, jc))
    return tm, tc


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    _serve_both(arch, b=2, s=12, cache_len=24, steps=8)


def test_odd_layer_count_runs_the_rem_layer():
    """3 gemma2 layers: one full period (local, global) and one ``rem``
    local layer after it."""
    tm, _ = _serve_both("gemma2-9b", b=2, s=10, cache_len=20, steps=3,
                        n_layers=3)
    assert tm.kinds == ["attn_local", "attn_full", "attn_local"]


def test_window_and_rolling_cache_match_reference():
    """Window 32 < the 40-token prompt: local layers mask by the window
    in prefill and keep a rolling 32-slot cache (rolled by 40 % 32);
    global layers a flat 48-slot one; 8 decode steps wrap the rolling
    buffer further (slots ``pos % 32``, valid ``<= min(pos, 31)``)."""
    tm, cache = _serve_both("gemma2-9b", b=2, s=40, cache_len=48, steps=8)
    assert tm.cfg.attention.window == 32
    assert [c["k"].shape[1] for c in cache] == [32, 48, 32, 48]


def test_griffin_window_and_rolling_cache_match_reference():
    """The same for the reduced recurrentgemma (RG-LRU, RG-LRU, local
    attention, then an RG-LRU ``rem`` layer): the RG-LRU state carries
    across the prompt while the local layer's 32-slot cache rolls."""
    tm, cache = _serve_both("recurrentgemma-9b", b=2, s=40, cache_len=48,
                            steps=8)
    assert tm.kinds == ["rglru", "rglru", "attn_local", "rglru"]
    assert tm.cfg.attention.window == 32
    assert cache[2]["k"].shape[1] == 32
    assert [tuple(cache[i]["conv"].shape) for i in (0, 1, 3)] == \
        [(2, 3, 64)] * 3


def _requests(cls, vocab):
    rng = np.random.default_rng(7)
    return [cls(rid=i, prompt=[int(x) for x in rng.integers(
        2, vocab, size=int(rng.integers(4, 14)))], max_new=m)
        for i, m in enumerate((5, 9, 3, 7, 6))]


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen1.5-4b",
                                  "granite-moe-1b-a400m", "olmoe-1b-7b",
                                  "recurrentgemma-9b", "xlstm-350m"])
def test_continuous_batcher_tokens_equal_reference(arch):
    """Untied heads: with a tied random table greedy decoding only echoes
    the last token, which would test little."""
    tcfg, jm, jp, tm, tp = _pair(arch, seed=1, tie_embeddings=False)
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


def test_lm_params_interleave_period_slots_and_append_rem():
    jcfg = dataclasses.replace(j_get_arch("gemma2-9b").reduced(), n_layers=5)
    tcfg = dataclasses.replace(get_arch("gemma2-9b").reduced(), n_layers=5)
    arrays = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(3)))
    got = lm_params_from_arrays(tcfg, arrays, "cpu")
    wq = [lay["attn"]["wq"].numpy() for lay in got["layers"]]
    b0, b1 = (arrays["blocks"][f"b{i}"]["attn"]["wq"] for i in (0, 1))
    want = [b0[0], b1[0], b0[1], b1[1], arrays["rem"][0]["attn"]["wq"]]
    assert len(wq) == 5
    for g, w in zip(wq, want):
        np.testing.assert_array_equal(g, w)
    assert "ln1p" in got["layers"][0] and got["embed"]["table"].shape == \
        (tcfg.vocab_size, tcfg.d_model)


def test_lm_params_carry_the_xlstm_cells():
    """xLSTM's period of 2: ``b0`` the sLSTM layers, ``b1`` the mLSTM;
    every cell leaf keeps the reference's shape and values."""
    jcfg = j_get_arch("xlstm-350m").reduced()
    tcfg = get_arch("xlstm-350m").reduced()
    arrays = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(4)))
    got = lm_params_from_arrays(tcfg, arrays, "cpu")
    assert TransformerLM(tcfg, device="cpu").kinds == \
        ["slstm", "mlstm", "slstm", "mlstm"]
    for j, lay in enumerate(got["layers"]):
        src = arrays["blocks"][f"b{j % 2}"]["cell"]
        assert set(lay["cell"]) == set(src)
        for name, a in src.items():
            np.testing.assert_array_equal(lay["cell"][name].numpy(),
                                          a[j // 2])
    assert set(got["layers"][0]["cell"]) == {"w_in", "r", "b", "wo"}
    assert set(got["layers"][1]["cell"]) == {"wq", "wk", "wv", "wo",
                                             "w_if", "b_if"}
    assert "mlp" in got["layers"][0]          # the reduced d_ff of 128


def test_full_width_weights_are_bfloat16_and_norms_float32():
    """At the full configs' bfloat16 the matrices are held in bfloat16,
    the norm scales and biases in float32 (a 1-layer qwen1.5 slice)."""
    cfg = dataclasses.replace(get_arch("qwen1.5-4b"), n_layers=1,
                              vocab_size=64)
    lm = build_model(cfg, device="cpu")
    p = lm.init(torch.Generator().manual_seed(0))
    lay = p["layers"][0]
    assert lay["attn"]["wq"].dtype == lay["mlp"]["w_in"].dtype == \
        p["embed"]["table"].dtype == p["head"]["w"].dtype == torch.bfloat16
    assert lay["ln1"]["scale"].dtype == lay["attn"]["bq"].dtype == \
        torch.float32
    assert lay["attn"]["wq"].shape == (2560, 20, 128)
    logits, cache = lm.prefill(p, torch.zeros((1, 3), dtype=torch.int32), 8)
    assert logits.shape == (1, 64) and logits.dtype == torch.bfloat16
    assert cache[0]["k"].shape == (1, 8, 20, 128)


def test_sampling_is_reproducible_from_the_seed():
    """Temperature > 0 draws from a generator seeded with ``seed``: the
    same seed gives the same tokens, another seed other tokens (not the
    reference's bits: a different generator)."""
    tcfg, _, _, tm, tp = _pair("phi4-mini-3.8b", seed=2,
                               tie_embeddings=False)
    scfg = ServeConfig(max_batch=2, max_seq=64, temperature=1.0)

    def run(seed):
        bat = ContinuousBatcher(tm, tcfg, scfg, tp, seed=seed)
        for r in _requests(Request, tcfg.vocab_size):
            bat.submit(r)
        return {r.rid: r.out for r in bat.run()}

    assert run(0) == run(0) != run(1)
