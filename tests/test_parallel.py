"""Sharding correctness on the 8-virtual-device CPU mesh.

The numbers must not depend on the layout: a class-sharded ('model' axis)
text table and a fully replicated one must produce identical predictions and
losses, and a data-sharded batch must match the single-device result.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from rangeclip.losses.hybrid import HybridLossConfig
from rangeclip.models.depth_unet import (
    DepthUNet,
    DepthUNetConfig,
    build_candidate_mask,
)
from rangeclip.parallel.mesh import (
    make_mesh,
    replicate,
    shard_batch,
    shard_class_tables,
    shard_state,
)
from rangeclip.training.optim import make_optimizer
from rangeclip.training.state import create_train_state
from rangeclip.training.train_step import make_train_step

CFG = DepthUNetConfig(
    encoder_filters=(8, 16, 16, 16, 32), embedding_dim=32, use_batch_norm=True
)
B, H, W, C, D = 4, 32, 32, 64, 32


def _batch(rng, A=2):
    return {
        "depth": rng.standard_normal((A, B, H, W, 1)).astype(np.float32),
        "segmentation": rng.integers(0, 16, size=(A, B, H, W)).astype(np.int32),
        "object_label": np.ones((A, B), np.int32),
        "image_embeddings": rng.standard_normal((A, B, D)).astype(np.float32),
        "sample_valid": np.ones((A, B), np.float32),
    }


def test_class_sharded_predict_matches_replicated():
    mesh = make_mesh(n_data=2, n_model=2)
    model = DepthUNet(CFG)
    depth = jnp.asarray(
        np.random.default_rng(0).standard_normal((B, H, W, 1)), jnp.float32
    )
    variables = model.init(jax.random.key(0), depth, train=False)
    text = jax.random.normal(jax.random.key(1), (C, D), jnp.float32)
    seg = jax.random.randint(jax.random.key(2), (B, H, W), 0, 16)
    cand = build_candidate_mask(jax.random.key(3), seg, C, 20)

    @jax.jit
    def predict(variables, depth, text, cand):
        return model.apply(
            variables, depth, text, cand, 5, method=DepthUNet.predict,
        )[0]

    baseline = np.asarray(predict(variables, depth, text, cand))

    with jax.sharding.set_mesh(mesh):
        v_sh = replicate(mesh, variables)
        depth_sh = jax.device_put(depth, NamedSharding(mesh, P("data")))
        text_sh = jax.device_put(text, NamedSharding(mesh, P("model", None)))
        cand_sh = replicate(mesh, cand)
        sharded = np.asarray(predict(v_sh, depth_sh, text_sh, cand_sh))

    np.testing.assert_array_equal(baseline, sharded)


def test_train_step_layout_invariance():
    rng = np.random.default_rng(1)
    batch_np = _batch(rng)
    text_np = rng.standard_normal((C, D)).astype(np.float32)
    med_np = np.zeros((C, C), bool)

    model = DepthUNet(CFG)
    opt = make_optimizer(1e-4)
    step = make_train_step(model, opt, HybridLossConfig(), accum_steps=2)

    def run(mesh):
        state = create_train_state(jax.random.key(0), CFG, opt, (B, H, W, 1))
        with jax.sharding.set_mesh(mesh):
            state = shard_state(mesh, state)
            batch = shard_batch(mesh, dict(batch_np), batch_axis=1)
            text, med, hard = shard_class_tables(
                mesh, jnp.asarray(text_np), jnp.asarray(med_np),
                jnp.asarray(med_np), shard_classes=(mesh.shape["model"] > 1),
            )
            new_state, info = step(
                state, batch, jax.random.key(7), jnp.float32(1e-3),
                jnp.float32(0.25), jnp.float32(0.5), text, med, hard,
            )
            return float(info["total_loss"]), jax.device_get(
                new_state.params["log_temperature_text"]
            )

    loss_1x1 = run(make_mesh(n_data=1, n_model=1))
    loss_4x2 = run(make_mesh(n_data=4, n_model=2))
    np.testing.assert_allclose(loss_1x1[0], loss_4x2[0], rtol=2e-4)
    np.testing.assert_allclose(loss_1x1[1], loss_4x2[1], rtol=1e-5)
    # spatial (image-height) sharding — GSPMD inserts the conv halo
    # exchanges; the result must match the unsharded layouts
    loss_2x2x2 = run(make_mesh(n_data=2, n_model=2, n_spatial=2))
    np.testing.assert_allclose(loss_1x1[0], loss_2x2x2[0], rtol=2e-4)
    np.testing.assert_allclose(loss_1x1[1], loss_2x2x2[1], rtol=1e-5)


def test_data_parallel_gradients_match_single_device():
    rng = np.random.default_rng(2)
    batch_np = _batch(rng)
    text_np = rng.standard_normal((C, D)).astype(np.float32)
    med_np = np.zeros((C, C), bool)

    import optax

    model = DepthUNet(CFG)
    # SGD(1.0): the param delta IS the (negative) gradient, so cross-layout
    # comparison is linear — Adam's sign normalization would amplify
    # reduction-order noise on near-zero gradient elements.
    opt = optax.sgd(1.0)
    step = make_train_step(model, opt, HybridLossConfig(), accum_steps=2)

    def params_after(mesh):
        state = create_train_state(jax.random.key(0), CFG, opt, (B, H, W, 1))
        with jax.sharding.set_mesh(mesh):
            state = shard_state(mesh, state)
            batch = shard_batch(mesh, dict(batch_np), batch_axis=1)
            text = replicate(mesh, jnp.asarray(text_np))
            med = replicate(mesh, jnp.asarray(med_np))
            new_state, _ = step(
                state, batch, jax.random.key(7), jnp.float32(1e-3),
                jnp.float32(0.25), jnp.float32(0.5), text, med, med,
            )
        return jax.device_get(new_state.params)

    p1 = params_after(make_mesh(n_data=1, n_model=1))
    p4 = params_after(make_mesh(n_data=4, n_model=1))
    flat1 = jax.tree.leaves(p1)
    flat4 = jax.tree.leaves(p4)
    for a, b in zip(flat1, flat4):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-6)


def test_sharded_predict_matches_single_device():
    """Data x class sharded predict (parallel/predict.py) is bit-identical
    to single-device predict_folded over the full table: per-shard folded
    scoring + local top-k with values + all_gather('model') + two-key
    (-value, id) sort reproduce the global ascending-id tie-break."""
    from rangeclip.models.depth_unet import (
        DepthUNet, DepthUNetConfig, predict_folded,
    )
    from rangeclip.parallel.mesh import make_mesh
    from rangeclip.parallel.predict import (
        make_sharded_predict, pad_class_table, shard_predict_inputs,
    )

    cfg = DepthUNetConfig(
        encoder_filters=(8, 16, 16, 16, 32), embedding_dim=32,
        use_batch_norm=True,
    )
    model = DepthUNet(cfg)
    B, H, W, C, K = 4, 32, 32, 100, 5
    x = jax.random.normal(jax.random.key(1), (B, H, W, 1))
    vars_ = model.init(jax.random.key(0), x, train=False)
    table = jax.random.normal(jax.random.key(2), (C, 32))

    want = predict_folded(model, vars_, x, table, top_k=K)
    assert want.shape == (B, H, W, K)

    for n_data, n_model in ((2, 2), (4, 1), (1, 4)):
        mesh = make_mesh(n_data=n_data, n_model=n_model)
        padded, ids = pad_class_table(table, n_model)
        fn = make_sharded_predict(model, mesh, top_k=K)
        with jax.sharding.set_mesh(mesh):
            xd, td, idsd = shard_predict_inputs(mesh, x, padded, ids)
            got = jax.device_get(fn(vars_, xd, td, idsd))
        np.testing.assert_array_equal(
            got, np.asarray(want),
            err_msg=f"mesh data={n_data} model={n_model}",
        )


def test_sharded_predict_default_path_matches_single_device():
    """The 'default' (unfolded) sharded formulation — the auto dispatch for
    per-shard slot counts past the folded crossover — is bit-identical to
    single-device DepthUNet.predict over the full table."""
    from rangeclip.models.depth_unet import DepthUNet, DepthUNetConfig
    from rangeclip.parallel.mesh import make_mesh
    from rangeclip.parallel.predict import (
        make_sharded_predict, pad_class_table, shard_predict_inputs,
    )

    cfg = DepthUNetConfig(
        encoder_filters=(8, 16, 16, 16, 32), embedding_dim=32,
        use_batch_norm=True,
    )
    model = DepthUNet(cfg)
    B, H, W, C, K = 4, 32, 32, 100, 5
    x = jax.random.normal(jax.random.key(1), (B, H, W, 1))
    vars_ = model.init(jax.random.key(0), x, train=False)
    table = jax.random.normal(jax.random.key(2), (C, 32))

    want, _, _ = model.apply(
        vars_, x, table, jnp.ones((C,), bool), K,
        method=DepthUNet.predict, return_embeddings=False,
    )

    for n_data, n_model in ((2, 2), (1, 4)):
        mesh = make_mesh(n_data=n_data, n_model=n_model)
        padded, ids = pad_class_table(table, n_model)
        fn = make_sharded_predict(model, mesh, top_k=K,
                                  predict_path="default")
        with jax.sharding.set_mesh(mesh):
            xd, td, idsd = shard_predict_inputs(mesh, x, padded, ids)
            got = jax.device_get(fn(vars_, xd, td, idsd))
        np.testing.assert_array_equal(
            got, np.asarray(want),
            err_msg=f"mesh data={n_data} model={n_model}",
        )


def test_ddp_parity_matches_per_shard_simulation():
    """ddp_parity=True is the reference-exact DDP semantics: each device
    computes the full hybrid loss on its LOCAL batch shard (per-replica BN
    statistics, per-replica loss normalizations, per-rank RNG streams) and
    gradients are pmean'd (train_util.py:338).  Oracle: an explicit Python
    loop over shards running the very same microbatch loss on each slice,
    merging exactly as documented."""
    import optax

    from rangeclip.training.train_step import make_microbatch_loss

    rng = np.random.default_rng(3)
    A = 2
    batch_np = _batch(rng, A=A)
    text_np = rng.standard_normal((C, D)).astype(np.float32)
    med_np = np.zeros((C, C), bool)

    model = DepthUNet(CFG)
    opt = optax.sgd(1.0)
    n_shards = 2
    mesh = make_mesh(n_data=n_shards, n_model=1)
    step = make_train_step(
        model, opt, HybridLossConfig(), accum_steps=A,
        ddp_parity=True, mesh=mesh,
    )
    state = create_train_state(jax.random.key(0), CFG, opt, (B, H, W, 1))
    step_rng, lr = jax.random.key(7), jnp.float32(1e-3)
    with jax.sharding.set_mesh(mesh):
        state_sh = shard_state(mesh, state)
        batch = shard_batch(mesh, dict(batch_np), batch_axis=1)
        text = replicate(mesh, jnp.asarray(text_np))
        med = replicate(mesh, jnp.asarray(med_np))
        new_state, info = step(
            state_sh, batch, step_rng, lr,
            jnp.float32(0.25), jnp.float32(0.5), text, med, med,
        )
    got_params = jax.device_get(new_state.params)
    got_stats = jax.device_get(new_state.batch_stats)
    got_loss = float(info["total_loss"])

    # --- oracle: explicit per-shard DDP ---------------------------------
    mb_loss = make_microbatch_loss(model, HybridLossConfig())
    gfn = jax.value_and_grad(mb_loss, has_aux=True)
    state0 = create_train_state(jax.random.key(0), CFG, opt, (B, H, W, 1))
    params, stats = state0.params, state0.batch_stats
    mean_over = lambda trees: jax.tree.map(
        lambda *xs: sum(xs) / len(xs), *trees)
    grads_acc = jax.tree.map(jnp.zeros_like, params)
    loss_acc = 0.0
    shard = B // n_shards
    for idx in range(A):
        mb_rng = jax.random.fold_in(step_rng, idx)
        per_shard = []
        for r in range(n_shards):
            sl = slice(r * shard, (r + 1) * shard)
            mb = {k: jnp.asarray(v[idx][sl]) for k, v in batch_np.items()}
            rank_rng = jax.random.fold_in(mb_rng, r)
            (loss, (_, nstats)), grads = gfn(
                params, stats, mb, rank_rng,
                jnp.float32(0.25), jnp.float32(0.5),
                jnp.asarray(text_np), jnp.asarray(med_np),
                jnp.asarray(med_np),
            )
            per_shard.append((loss, nstats, grads))
        loss_acc += float(mean_over([p[0] for p in per_shard]))
        stats = mean_over([p[1] for p in per_shard])
        grads_acc = jax.tree.map(
            jnp.add, grads_acc, mean_over([p[2] for p in per_shard]))
    grads = jax.tree.map(lambda g: g / A, grads_acc)
    # SGD(1.0) scaled by lr, exactly as the train step applies updates.
    want_params = jax.tree.map(lambda p, g: p - 1e-3 * g, params, grads)

    np.testing.assert_allclose(got_loss, loss_acc / A, rtol=2e-5)
    for a, b in zip(jax.tree.leaves(got_params),
                    jax.tree.leaves(jax.device_get(want_params))):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-6)
    for a, b in zip(jax.tree.leaves(got_stats),
                    jax.tree.leaves(jax.device_get(stats))):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-7)


def test_ddp_parity_rejects_model_sharded_mesh():
    import optax

    mesh = make_mesh(n_data=2, n_model=2)
    with pytest.raises(ValueError, match="data-parallel only"):
        make_train_step(
            DepthUNet(CFG), optax.sgd(1.0), HybridLossConfig(),
            accum_steps=2, ddp_parity=True, mesh=mesh,
        )
    with pytest.raises(ValueError, match="requires the mesh"):
        make_train_step(
            DepthUNet(CFG), optax.sgd(1.0), HybridLossConfig(),
            accum_steps=2, ddp_parity=True,
        )


def test_host_local_rows_reassembles_spatially_sharded_arrays():
    """_host_local_rows must reassemble this host's batch rows even when
    non-batch dims are sharded too (the 'spatial' H axis of the 2x2x2
    layout) — a data-sharded-only assumption would drop H halves."""
    from rangeclip.evals.validate import _host_local_rows

    mesh = make_mesh(n_data=2, n_model=2, n_spatial=2)
    want = np.arange(4 * 8 * 6, dtype=np.int32).reshape(4, 8, 6)
    arr = jax.device_put(
        want, NamedSharding(mesh, P("data", "spatial", None))
    )
    np.testing.assert_array_equal(_host_local_rows(arr), want)

    # batch-dim-only sharding (replicated elsewhere) still round-trips
    arr2 = jax.device_put(want, NamedSharding(mesh, P("data", None, None)))
    np.testing.assert_array_equal(_host_local_rows(arr2), want)

    # fully-replicated arrays fetch whole
    arr3 = jax.device_put(want, NamedSharding(mesh, P(None, None, None)))
    np.testing.assert_array_equal(_host_local_rows(arr3), want)


def _run_sharded_step(model_cfg, batch_np, text_np, C_, mesh_dims,
                      loss_keys=(
                          "total_loss", "text_contrastive_loss",
                          "smoothness_loss", "image_contrastive_loss")):
    """One accumulation-window train step on a fresh state over the given
    mesh.  Returns (loss dict, params-L1 scalar)."""
    model = DepthUNet(model_cfg)
    opt = make_optimizer(1e-4)
    n_data, n_spatial, n_model = mesh_dims
    mesh = make_mesh(n_data=n_data, n_spatial=n_spatial, n_model=n_model)
    Bl = batch_np["depth"].shape[1]
    state = create_train_state(jax.random.key(0), model_cfg, opt,
                               (Bl,) + batch_np["depth"].shape[2:])
    state = shard_state(mesh, state)
    batch = shard_batch(mesh, dict(batch_np), batch_axis=1)
    text, med, hard = shard_class_tables(
        mesh, jnp.asarray(text_np), jnp.zeros((C_, C_), bool),
        jnp.zeros((C_, C_), bool), shard_classes=(n_model > 1),
    )
    step = make_train_step(
        model, opt, HybridLossConfig(),
        accum_steps=batch_np["depth"].shape[0], mesh=mesh,
    )
    new_state, info = step(
        state, batch, jax.random.key(7), jnp.float32(1e-3),
        jnp.float32(0.25), jnp.float32(0.5), text, med, hard,
    )
    jax.block_until_ready(new_state)
    pnorm = float(jax.device_get(sum(
        jnp.sum(jnp.abs(x.astype(jnp.float32)))
        for x in jax.tree.leaves(new_state.params))))
    return {k: float(info[k]) for k in loss_keys}, pnorm


def test_spatial_sharded_predict_matches_single_device():
    """'spatial' (image-height) sharded predict — the serving answer for
    resolutions whose activation footprint exceeds one device — matches single-device DepthUNet.predict bit-for-bit: GSPMD
    partitions the UNet forward (conv halo exchanges over 'spatial'),
    scoring + the exact cross-'model' top-k merge run per shard."""
    from rangeclip.models.depth_unet import DepthUNet, DepthUNetConfig
    from rangeclip.parallel.mesh import make_mesh
    from rangeclip.parallel.predict import (
        make_sharded_predict, pad_class_table, shard_predict_inputs,
    )

    cfg = DepthUNetConfig(
        encoder_filters=(8, 16, 16, 16, 32), embedding_dim=32,
        use_batch_norm=True,
    )
    model = DepthUNet(cfg)
    B, H, W, C, K = 4, 32, 32, 100, 5
    x = jax.random.normal(jax.random.key(1), (B, H, W, 1))
    vars_ = model.init(jax.random.key(0), x, train=False)
    table = jax.random.normal(jax.random.key(2), (C, 32))

    want, _, _ = model.apply(
        vars_, x, table, jnp.ones((C,), bool), K,
        method=DepthUNet.predict, return_embeddings=False,
    )

    for n_data, n_spatial, n_model in ((2, 2, 2), (1, 2, 1), (1, 4, 2)):
        mesh = make_mesh(n_data=n_data, n_spatial=n_spatial,
                         n_model=n_model)
        padded, ids = pad_class_table(table, n_model)
        fn = make_sharded_predict(model, mesh, top_k=K)
        with jax.sharding.set_mesh(mesh):
            xd, td, idsd = shard_predict_inputs(mesh, x, padded, ids)
            got = jax.device_get(fn(vars_, xd, td, idsd))
        np.testing.assert_array_equal(
            got, np.asarray(want),
            err_msg=f"mesh data={n_data} spatial={n_spatial} model={n_model}",
        )

    # the folded formulation cannot spatially shard — explicit error
    with pytest.raises(ValueError, match="folded"):
        make_sharded_predict(
            model, make_mesh(n_data=2, n_spatial=2), top_k=K,
            predict_path="folded")


def test_model_sharded_unfolded_predict_large_C_matches_single_device():
    """The 'model' axis (predict arm) exercised at the
    NYUv2-transfer scale where it actually pays — C=2048 >> embedding
    dim, the regime where folding loses (folded_is_profitable is False
    even for the per-shard slice) and the [N, S] score field is the
    memory problem.  The auto dispatch must take the UNFOLDED per-shard
    formulation, and the data x model sharded labels must be
    bit-identical to single-device DepthUNet.predict over the full
    2048-row table.  Match: model.py:164-165 einsum + SURVEY §5 scaling
    concern (a); BASELINE.json config #4."""
    from rangeclip.models.depth_unet import folded_is_profitable
    from rangeclip.parallel.predict import (
        make_sharded_predict, pad_class_table, shard_predict_inputs,
    )

    model = DepthUNet(CFG)
    C_big, K = 2048, 5
    x = jax.random.normal(jax.random.key(1), (B, H, W, 1))
    vars_ = model.init(jax.random.key(0), x, train=False)
    table = jax.random.normal(jax.random.key(2), (C_big, 32))

    want, _, _ = model.apply(
        vars_, x, table, jnp.ones((C_big,), bool), K,
        method=DepthUNet.predict, return_embeddings=False,
    )

    for n_data, n_model in ((2, 4), (4, 2)):
        # the regime claim: even the per-shard slice is past the folded
        # crossover, so 'auto' resolves to the unfolded path
        assert not folded_is_profitable(C_big // n_model, 32)
        mesh = make_mesh(n_data=n_data, n_model=n_model)
        padded, ids = pad_class_table(table, n_model)
        fn = make_sharded_predict(model, mesh, top_k=K, predict_path="auto")
        with jax.sharding.set_mesh(mesh):
            xd, td, idsd = shard_predict_inputs(mesh, x, padded, ids)
            got = jax.device_get(fn(vars_, xd, td, idsd))
        np.testing.assert_array_equal(
            got, np.asarray(want),
            err_msg=f"C=2048 mesh data={n_data} model={n_model}",
        )


def test_model_sharded_packed_ce_train_step_large_C():
    """The bf16 train step under the data x model mesh at C=2048 (class
    table and [C, C] similarity matrices sharded over 'model') matches the
    single-device step."""
    cfg = DepthUNetConfig(
        encoder_filters=(8, 16, 16, 16, 32), embedding_dim=128,
        use_batch_norm=True, dtype=jnp.bfloat16,
    )
    Bb, Hh, Ww, Cc = 8, 16, 16, 2048
    rng = np.random.default_rng(17)
    batch_np = {
        "depth": rng.standard_normal((2, Bb, Hh, Ww, 1)).astype(np.float32),
        "segmentation": rng.integers(0, Cc, size=(2, Bb, Hh, Ww)).astype(
            np.int32) % 64,  # bounded label diversity
        "object_label": np.ones((2, Bb), np.int32),
        "image_embeddings": rng.standard_normal((2, Bb, 128)).astype(
            np.float32),
        "sample_valid": np.ones((2, Bb), np.float32),
    }
    text_np = rng.standard_normal((Cc, 128)).astype(np.float32)

    ref, pn_ref = _run_sharded_step(cfg, batch_np, text_np, Cc, (1, 1, 1))
    ker, pn_k = _run_sharded_step(cfg, batch_np, text_np, Cc, (2, 1, 2))
    for k in ref:
        np.testing.assert_allclose(ker[k], ref[k], rtol=5e-3, atol=1e-5,
                                   err_msg=f"C=2048 sharded {k}")
    np.testing.assert_allclose(pn_k, pn_ref, rtol=1e-3)
