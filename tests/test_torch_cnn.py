"""The port's conv2d op and CNN against the reference on the CPU.

* ``_im2col`` equals the reference's patch matrix bit for bit, (KH, KW, C)
  feature order included, at 3x3, 5x5 and 11x11 filters; the padded patch
  matrix the GEMM takes is ``_im2col``'s bit for bit plus zero columns up
  to a multiple of 4 features, and the GEMM only ever sees such a K.
* ``conv2d`` (im2col + the GEMM's plain version) against the reference's
  ``conv2d`` (its Pallas kernel in interpret mode) and against both
  packages' ``conv2d_ref``; ``matmul_ref`` against the reference's,
  ragged shapes included.  Tolerance atol 5e-4, rtol 1e-3: the
  reference's own conv tolerance (``tests/test_kernels.py``), for float32
  sums taken in another order.
* LeNet and AlexNet ``forward`` against the reference's ``forward`` with
  the same parameters (carried by ``cnn_params_from_arrays``), same
  tolerance.
* ``distributed_forward`` equals ``forward`` bit for bit, with the
  reference's hand-off counts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.alexnet import ALEXNET  # noqa: E402
from repro.configs.lenet import LENET  # noqa: E402
from repro.kernels.conv2d import ops as j_ops  # noqa: E402
from repro.kernels.conv2d import ref as j_ref  # noqa: E402
from repro.models import cnn as j_cnn  # noqa: E402
from repro_torch.configs.alexnet import ALEXNET as T_ALEXNET  # noqa: E402
from repro_torch.configs.lenet import LENET as T_LENET  # noqa: E402
from repro_torch.convert import cnn_params_from_arrays  # noqa: E402
from repro_torch.kernels.conv2d import ops as t_ops  # noqa: E402
from repro_torch.kernels.conv2d import ref as t_ref  # noqa: E402
from repro_torch.models import cnn as t_cnn  # noqa: E402

TOL = dict(atol=5e-4, rtol=1e-3)
CFGS = {"lenet": (LENET, T_LENET, 2), "alexnet": (ALEXNET, T_ALEXNET, 1)}
#: n, hw, cin, cout, k, stride, pad: the reference's kernel-test shapes
#: and AlexNet's conv1
CONV_SHAPES = [(2, 16, 3, 8, 5, 2, 2), (1, 28, 6, 16, 5, 1, 0),
               (2, 13, 256, 384, 3, 1, 1), (1, 227, 3, 96, 11, 4, 0)]


def conv_inputs(seed, n, hw, cin, cout, k):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, hw, hw, cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout)) * 0.1).astype(np.float32)
    b = rng.normal(size=cout).astype(np.float32)
    return x, w, b


def t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("n,hw,cin,cout,k,stride,pad", [
    (2, 16, 3, 8, 5, 2, 2), (2, 13, 5, 4, 3, 1, 1), (1, 40, 3, 4, 11, 4, 0)])
def test_im2col_matches_reference_bitwise(n, hw, cin, cout, k, stride, pad):
    x, _, _ = conv_inputs(0, n, hw, cin, cout, k)
    jp, jshape = j_ops._im2col(jnp.asarray(x), k, k, stride, pad)
    tp, tshape = t_ops._im2col(t(x), k, k, stride, pad)
    assert tuple(tshape) == tuple(jshape)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("n,hw,cin,cout,k,stride,pad", CONV_SHAPES)
def test_conv2d_matches_reference_kernel_and_oracle(n, hw, cin, cout, k,
                                                    stride, pad):
    x, w, b = conv_inputs(1, n, hw, cin, cout, k)
    got = t_ops.conv2d(t(x), t(w), t(b), stride=stride, padding=pad).numpy()
    j_kernel = j_ops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            stride=stride, padding=pad, interpret=True)
    j_oracle = j_ref.conv2d_ref(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), stride=stride, padding=pad)
    t_oracle = t_ref.conv2d_ref(t(x), t(w), t(b), stride=stride,
                                padding=pad).numpy()
    np.testing.assert_allclose(got, np.asarray(j_kernel), **TOL)
    np.testing.assert_allclose(got, np.asarray(j_oracle), **TOL)
    np.testing.assert_allclose(t_oracle, np.asarray(j_oracle), **TOL)


#: n, hw, cin, cout, k, stride, pad with K = k * k * cin not a multiple of
#: 4: AlexNet's conv1 filter (K 363) on a smaller image, and two other
#: ragged channel counts (K 45 and 175)
RAGGED_K = [(1, 40, 3, 16, 11, 4, 0), (2, 15, 5, 8, 3, 1, 1),
            (1, 20, 7, 6, 5, 2, 2)]


@pytest.mark.parametrize("n,hw,cin,cout,k,stride,pad",
                         RAGGED_K + [(2, 13, 4, 8, 3, 1, 1)])
def test_padded_patches_are_im2col_plus_zero_columns(n, hw, cin, cout, k,
                                                     stride, pad):
    x, _, _ = conv_inputs(4, n, hw, cin, cout, k)
    got, shape = t_ops._im2col_padded(t(x), k, k, stride, pad)
    want, want_shape = t_ops._im2col(t(x), k, k, stride, pad)
    kk = k * k * cin
    assert shape == want_shape and got.is_contiguous()
    assert got.shape == (want.shape[0], kk + (-kk) % 4)
    assert torch.equal(got[:, :kk], want)
    assert not got[:, kk:].any()


@pytest.mark.parametrize("n,hw,cin,cout,k,stride,pad", RAGGED_K)
def test_conv2d_pads_k_and_matches_reference_kernel(n, hw, cin, cout, k,
                                                    stride, pad,
                                                    monkeypatch):
    """``conv2d`` hands its GEMM a K padded to a multiple of 4 (zero
    patch columns, zero filter rows) on the CPU as on the card, and still
    equals the reference's ``conv2d`` (Pallas in interpret mode)."""
    seen = []

    def gemm(xm, wm, b, *, relu):
        seen.append((xm.shape, wm.shape))
        return t_ref.matmul_ref(xm, wm, b, relu=relu)

    monkeypatch.setitem(t_ops._BY_DEVICE, "cpu", gemm)
    x, w, b = conv_inputs(5, n, hw, cin, cout, k)
    got = t_ops.conv2d(t(x), t(w), t(b), stride=stride, padding=pad).numpy()
    want = j_ops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        stride=stride, padding=pad, interpret=True)
    kk = k * k * cin
    (xs, ws), = seen
    assert xs[1] == ws[0] == kk + (-kk) % 4 and xs[1] % 4 == 0
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("relu", [True, False])
def test_conv2d_without_relu_keeps_negatives(relu):
    x, w, b = conv_inputs(2, 2, 12, 4, 6, 3)
    got = t_ops.conv2d(t(x), t(w), t(b), stride=1, padding=1,
                       relu=relu).numpy()
    want = j_ref.conv2d_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            stride=1, padding=1, relu=relu)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert (got < 0).any() != relu


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (1, 363, 96),
                                   (67, 17, 5), (130, 2400, 33)])
def test_matmul_ref_matches_reference(m, k, n, relu):
    rng = np.random.default_rng(m * 7 + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    got = t_ref.matmul_ref(t(x), t(w), t(b), relu=relu).numpy()
    want = j_ref.matmul_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            relu=relu)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def carried_params(jcfg):
    params = j_cnn.init_cnn(jax.random.PRNGKey(0), jcfg)
    arrays = [{k: np.asarray(v) for k, v in p.items()} for p in params]
    return params, cnn_params_from_arrays(arrays, device="cpu")


@pytest.fixture(scope="module", params=sorted(CFGS))
def model(request):
    jcfg, tcfg, n = CFGS[request.param]
    jparams, tparams = carried_params(jcfg)
    x = np.random.default_rng(3).normal(
        size=(n, jcfg.input_hw, jcfg.input_hw, jcfg.input_channels)
    ).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, x


def test_forward_matches_reference(model):
    jcfg, tcfg, jparams, tparams, x = model
    want = np.asarray(j_cnn.forward(jcfg, jparams, jnp.asarray(x)))
    got = t_cnn.forward(tcfg, tparams, t(x)).numpy()
    assert got.shape == want.shape == (x.shape[0],
                                       jcfg.layers[-1].out_features)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n_dev", [2, 3, 5])
def test_distributed_forward_is_bitwise_forward(model, n_dev):
    jcfg, tcfg, jparams, tparams, x = model
    assign = [j % n_dev for j in range(len(tcfg.layers))]
    y0 = t_cnn.forward(tcfg, tparams, t(x))
    y1, transfers = t_cnn.distributed_forward(tcfg, tparams, t(x), assign)
    assert torch.equal(y0, y1)
    _, j_transfers = j_cnn.distributed_forward(jcfg, jparams,
                                               jnp.asarray(x), assign)
    assert transfers == j_transfers > 0


@pytest.mark.parametrize("name", sorted(CFGS))
def test_init_cnn_matches_reference_shapes_and_law(name):
    jcfg, tcfg, _ = CFGS[name]
    jparams = j_cnn.init_cnn(jax.random.PRNGKey(0), jcfg)
    tparams = t_cnn.init_cnn(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    again = t_cnn.init_cnn(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert len(tparams) == len(jparams)
    for jp, tp, tp2, spec in zip(jparams, tparams, again, tcfg.layers):
        assert sorted(tp) == sorted(jp)
        for k in tp:
            assert tuple(tp[k].shape) == tuple(jp[k].shape)
            assert tp[k].dtype == torch.float32
            assert torch.equal(tp[k], tp2[k])          # seeded
        if tp:
            fan_in = int(np.prod(tp["w"].shape[:-1]))
            assert float(tp["w"].abs().max()) <= 2.0 / np.sqrt(fan_in) + 1e-7
            assert float(tp["b"].abs().max()) == 0.0


def test_layer_shapes_match_the_reference_activations(model):
    """``layer_shapes`` (which sizes ``init_cnn`` and the smoke script's
    conv GEMMs) against the reference's activations, layer by layer."""
    jcfg, tcfg, jparams, _, x = model
    shapes = t_cnn.layer_shapes(tcfg, x.shape[0])
    assert len(shapes) == len(jcfg.layers)
    h = jnp.asarray(x)
    for i, (x_shape, y_shape) in enumerate(shapes):
        assert x_shape == (tuple(h.shape) if jcfg.layers[i].kind != "fc"
                           else (h.shape[0], int(np.prod(h.shape[1:]))))
        h = j_cnn.apply_layers(jcfg, jparams, h, i, i + 1)
        assert y_shape == tuple(h.shape)
