"""The module system (rangeclip/nn.py): naming, variable collections,
key derivation and the normalization layers against numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rangeclip import nn


class Pair(nn.Module):
    width: int

    @nn.compact
    def __call__(self, x):
        x = nn.Dense(self.width)(x)
        return nn.Dense(self.width, use_bias=False)(x)


class Tower(nn.Module):
    width: int = 4

    def setup(self):
        self.head = Pair(self.width)
        self.scale = self.param("scale", nn.initializers.ones, (self.width,))

    def __call__(self, x):
        return self.head(x) * self.scale

    def twice(self, x):
        return self.head(self.head(x))


def test_parameter_tree_names_and_method_dispatch():
    x = jnp.ones((2, 4))
    v = Tower().init(jax.random.key(0), x)
    assert set(v) == {"params"}
    p = v["params"]
    assert set(p) == {"head", "scale"}
    assert set(p["head"]) == {"Dense_0", "Dense_1"}
    assert set(p["head"]["Dense_0"]) == {"kernel", "bias"}
    assert set(p["head"]["Dense_1"]) == {"kernel"}
    # a second method reuses the same parameters
    y = Tower().apply(v, x, method=Tower.twice)
    k0 = p["head"]["Dense_0"]
    h = (x @ k0["kernel"] + k0["bias"]) @ p["head"]["Dense_1"]["kernel"]
    h = (h @ k0["kernel"] + k0["bias"]) @ p["head"]["Dense_1"]["kernel"]
    np.testing.assert_allclose(np.asarray(y), np.asarray(h), rtol=1e-6)


def test_init_keys_depend_on_path_and_seed_only():
    x = jnp.ones((1, 4))
    a = Tower().init(jax.random.key(0), x)["params"]
    b = Tower().init(jax.random.key(0), x)["params"]
    c = Tower().init(jax.random.key(1), x)["params"]
    k = lambda t: np.asarray(t["head"]["Dense_0"]["kernel"])  # noqa: E731
    np.testing.assert_array_equal(k(a), k(b))
    assert not np.array_equal(k(a), k(c))
    assert not np.array_equal(k(a), np.asarray(
        a["head"]["Dense_1"]["kernel"]))
    with pytest.raises(RuntimeError, match="unbound"):
        Pair(3)(x)
    with pytest.raises(KeyError, match="missing"):
        Tower().apply({"params": {}}, x)


class Norm(nn.Module):
    @nn.compact
    def __call__(self, x, train):
        return nn.BatchNorm(use_running_average=not train, momentum=0.9,
                            name="bn")(x)


def test_batch_norm_statistics_and_running_update():
    x = jax.random.normal(jax.random.key(2), (3, 5, 5, 4)) * 2 + 1
    v = Norm().init(jax.random.key(0), x, True)
    assert set(v) == {"params", "batch_stats"}
    with pytest.raises(ValueError, match="immutable"):
        Norm().apply(v, x, True)
    y, upd = Norm().apply(v, x, True, mutable=["batch_stats"])
    xn = np.asarray(x, np.float64)
    mean, var = xn.mean((0, 1, 2)), xn.var((0, 1, 2))
    np.testing.assert_allclose(np.asarray(y), (xn - mean) / np.sqrt(var + 1e-5),
                               rtol=1e-4, atol=1e-5)
    bs = upd["batch_stats"]["bn"]
    np.testing.assert_allclose(np.asarray(bs["mean"]), 0.1 * mean, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(bs["var"]), 0.9 + 0.1 * var,
                               rtol=1e-5)
    # the caller's variables are not touched; eval uses the running stats
    np.testing.assert_array_equal(np.asarray(v["batch_stats"]["bn"]["mean"]),
                                  np.zeros(4))
    y_eval = Norm().apply(v, x, False)
    np.testing.assert_allclose(np.asarray(y_eval), xn / np.sqrt(1 + 1e-5),
                               rtol=1e-5)


def test_group_and_layer_norm_match_numpy():
    x = jax.random.normal(jax.random.key(3), (2, 3, 3, 8)) * 3 - 1
    xn = np.asarray(x, np.float64)
    g = nn.GroupNorm(num_groups=4, epsilon=1e-5)
    y = g.apply(g.init(jax.random.key(0), x), x)
    grouped = xn.reshape(2, 3, 3, 4, 2)
    m = grouped.mean((1, 2, 4), keepdims=True)
    s = grouped.var((1, 2, 4), keepdims=True)
    want = ((grouped - m) / np.sqrt(s + 1e-5)).reshape(xn.shape)
    np.testing.assert_allclose(np.asarray(y), want, rtol=1e-4, atol=1e-5)
    ln = nn.LayerNorm()
    y = ln.apply(ln.init(jax.random.key(0), x), x)
    want = (xn - xn.mean(-1, keepdims=True)) / np.sqrt(
        xn.var(-1, keepdims=True) + 1e-6)
    np.testing.assert_allclose(np.asarray(y), want, rtol=1e-4, atol=1e-5)


class Drop(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.Dropout(rate=0.5)(x)


def test_dropout_needs_and_follows_its_key():
    x = jnp.ones((64,))
    with pytest.raises(ValueError, match="rngs"):
        Drop().apply({}, x)
    a = Drop().apply({}, x, rngs={"dropout": jax.random.key(0)})
    b = Drop().apply({}, x, rngs={"dropout": jax.random.key(0)})
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert set(np.unique(np.asarray(a))) <= {0.0, 2.0}


def test_conv_and_pooling_shapes_and_values():
    x = jax.random.normal(jax.random.key(4), (1, 6, 6, 3))
    conv = nn.Conv(5, (3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)],
                   use_bias=False)
    v = conv.init(jax.random.key(0), x)
    assert v["params"]["kernel"].shape == (3, 3, 3, 5)
    want = jax.lax.conv_general_dilated(
        x, v["params"]["kernel"], (2, 2), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(np.asarray(conv.apply(v, x)),
                               np.asarray(want), rtol=1e-6)
    mp = nn.max_pool(x, (2, 2), strides=(2, 2))
    np.testing.assert_array_equal(
        np.asarray(mp), np.asarray(x).reshape(1, 3, 2, 3, 2, 3).max((2, 4)))
    ap = nn.avg_pool(x, (3, 3), strides=(3, 3))
    np.testing.assert_allclose(
        np.asarray(ap), np.asarray(x).reshape(1, 2, 3, 2, 3, 3).mean((2, 4)),
        rtol=1e-6)
