"""Multi-chip inference: data-parallel + class-sharded predict.

The training mesh (mesh.py) scales the LOSS over devices; this module
scales `predict` — the serving path — with the same two axes:

  * 'data': the batch dimension.  Each device runs the full UNet forward
    and scores only its batch shard; no cross-device communication at
    all on this axis.
  * 'model': the candidate-table rows (class axis).  Each device folds
    ONLY its [S/p, D] slice of the table into the output conv
    (depth_unet.predict_folded with ``candidate_ids``), selects a local
    top-k WITH values, and the per-pixel winners are merged exactly via
    one k-sized ``all_gather`` over 'model' + a two-key sort.  This
    scales the reference's predict (model.py:119-175) past one device's
    memory: the [N, S] score field never exists anywhere in full, only
    [N, S/p] slices.

Merge exactness: every shard's candidate ids are an ascending contiguous
block, local selection tie-breaks to the smallest id (lax.top_k over
ascending slots), and the merge sorts gathered (value,
id) pairs by (-value, id) — two-key ``lax.sort`` — so cross-shard ties
also resolve to the smallest global id.  The merge is therefore exact: on
the CPU the composite is BIT-IDENTICAL to single-device `predict_folded`
over the full table
(tests/test_parallel.py::test_sharded_predict_matches_single_device).  On
the GPU a slice's matmul may round a score differently from the
whole-table matmul, so two labels whose fp32 scores lie within rounding of
a tie may swap (``chip_smoke.py --four`` bounds that).

The UNet forward is deliberately recomputed in every 'model' column
(parameters are replicated): for the class counts where sharding the
table matters (NYUv2-transfer C in the thousands), scoring dominates the
forward, and duplicating the forward costs less than all-gathering the
[B, h, w, D] feature field across columns would.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rangeclip.models.depth_unet import (
    NEG_INF,
    DepthUNet,
    folded_is_profitable,
    predict_folded,
    resize_nearest,
)
from rangeclip.utils.math import l2_normalize


def pad_class_table(
    table: jax.Array, n_model: int, quantum: int = 8
) -> Tuple[jax.Array, jax.Array]:
    """Pad a [C, D] candidate table so the class axis splits evenly over
    ``n_model`` shards of a ``quantum`` multiple each, and build the
    matching [C_pad] global-id vector (-1 on pad rows).

    Returns (padded_table, ids).
    """
    C = table.shape[0]
    per = -(-C // n_model)
    per = -(-per // quantum) * quantum
    total = per * n_model
    ids = jnp.arange(C, dtype=jnp.int32)
    if total != C:
        table = jnp.pad(table, ((0, total - C), (0, 0)))
        ids = jnp.pad(ids, (0, total - C), constant_values=-1)
    return table, ids


def _score_field_topk(
    field: jax.Array,
    table_slice: jax.Array,
    ids_slice: jax.Array,
    top_k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Score an UN-normalized [B, h, w, D] field against a table SLICE
    whose rows carry global ``ids_slice``: local top-k WITH values (f32
    cosine logits — comparable across class shards, the per-pixel norm is
    shard-invariant).  Returns native-res (idx, val)."""
    text = l2_normalize(table_slice.astype(jnp.float32), axis=-1)
    fieldn = l2_normalize(field.astype(jnp.float32), axis=-1)
    logits = jnp.einsum("bhwd,cd->bhwc", fieldn, text,
                        preferred_element_type=jnp.float32)
    logits = jnp.where(ids_slice[None, None, None, :] >= 0, logits, NEG_INF)
    val, slot = jax.lax.top_k(logits, top_k)
    idx = jnp.take(ids_slice, slot, axis=0)
    return idx, val


def _local_default_topk(
    model: DepthUNet,
    variables,
    depth: jax.Array,
    table_slice: jax.Array,
    ids_slice: jax.Array,
    top_k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Default-formulation local scoring (mirrors ``DepthUNet.predict``'s
    scoring tail, but over a table SLICE): run the UNet on the local batch
    shard, then :func:`_score_field_topk`."""
    field = model.apply(variables, depth, normalize=False,
                        method=DepthUNet.native_field)
    return _score_field_topk(field, table_slice, ids_slice, top_k)


def make_sharded_predict(
    model: DepthUNet,
    mesh: Mesh,
    top_k: int = 5,
    predict_path: str = "auto",
):
    """Build a jitted ``fn(variables, depth, table, ids) -> topk`` over the
    mesh: batch sharded on 'data', table rows on 'model' (pad with
    :func:`pad_class_table` first), params replicated.

    ``predict_path`` picks the per-shard scoring formulation — 'folded'
    (`predict_folded`), 'default' (embedding field + slot matmul), or
    'auto': `folded_is_profitable` on the PER-SHARD slot count, decided at
    trace time from the table slice's static shape (so a C=2048 table
    served with model_parallel=1 takes the default path, the same
    crossover the single-device CLIs dispatch on).

    A non-trivial 'spatial' mesh axis additionally shards the image
    height — the serving answer when one device cannot hold the
    activation footprint (the 512^2 MiT stretch config; SURVEY §5's
    "spatial sharding of feature maps if resolution grows").  There the
    UNet forward runs OUTSIDE the shard_map so GSPMD inserts the conv
    halo exchanges over 'spatial', and only the scoring/top-k/merge runs
    per-shard; the formulation is always 'default' — at the class counts
    where spatial sharding matters, folding loses anyway (S >~ 1.5x D,
    the measured folded-head crossover), and the folded contraction would
    put a conv inside the shard_map where no halo exists.

    ``depth`` is [B, H, W, 1] with B divisible by the 'data' axis size
    (and H by 2x the 'spatial' size when that axis is used);
    returns [B, H, W, top_k] global label ids, equal to the single-device
    path of the same formulation up to the rounding of near-tied scores
    (see the module docstring).
    """
    n_model = dict(mesh.shape).get("model", 1)
    n_spatial = dict(mesh.shape).get("spatial", 1)
    if n_spatial > 1:
        if predict_path == "folded":
            raise ValueError(
                "predict_path='folded' cannot spatially shard (the folded "
                "conv would need halo exchange inside shard_map); use "
                "'default' or 'auto'")
        return _make_spatial_sharded_predict(model, mesh, top_k)

    def local_predict(variables, depth, table_slice, ids_slice):
        fold = predict_path == "folded" or (
            predict_path == "auto"
            and folded_is_profitable(table_slice.shape[0],
                                     table_slice.shape[1])
        )
        if fold:
            idx, val = predict_folded(
                model, variables, depth, table_slice,
                candidate_ids=ids_slice, top_k=top_k, want_values=True,
                upsample=False,
            )
        else:
            idx, val = _local_default_topk(
                model, variables, depth, table_slice, ids_slice, top_k,
            )
        if n_model > 1:
            # [B, h, w, P*k] candidate winners per pixel; one small
            # collective per predict call
            val = jax.lax.all_gather(val, "model", axis=-1, tiled=True)
            idx = jax.lax.all_gather(idx, "model", axis=-1, tiled=True)
            # exact merge: ascending (-value, id) == (value desc, id asc),
            # the same order lax.top_k over the full ascending table yields
            _, idx = jax.lax.sort((-val, idx), dimension=-1, num_keys=2)
            idx = idx[..., :top_k]
        _, h, w, _ = depth.shape
        if (h, w) != idx.shape[1:3]:
            idx = resize_nearest(idx, (h, w))
        return idx

    fn = jax.shard_map(
        local_predict,
        mesh=mesh,
        in_specs=(P(), P("data"), P("model", None), P("model")),
        out_specs=P("data"),
        check_vma=False,
    )
    return jax.jit(fn)


def _make_spatial_sharded_predict(model: DepthUNet, mesh: Mesh, top_k: int):
    """data x spatial x model predict: GSPMD-partitioned UNet forward
    (conv halos over 'spatial' inserted automatically), per-shard scoring
    + exact cross-'model' top-k merge inside shard_map, nearest upsample
    of the merged labels back in GSPMD-land."""
    n_model = dict(mesh.shape).get("model", 1)
    field_spec = NamedSharding(mesh, P("data", "spatial", None, None))

    def local_score(field, table_slice, ids_slice):
        idx, val = _score_field_topk(field, table_slice, ids_slice, top_k)
        if n_model > 1:
            val = jax.lax.all_gather(val, "model", axis=-1, tiled=True)
            idx = jax.lax.all_gather(idx, "model", axis=-1, tiled=True)
            _, idx = jax.lax.sort((-val, idx), dimension=-1, num_keys=2)
            idx = idx[..., :top_k]
        return idx

    score = jax.shard_map(
        local_score,
        mesh=mesh,
        in_specs=(P("data", "spatial", None, None), P("model", None),
                  P("model")),
        out_specs=P("data", "spatial", None, None),
        check_vma=False,
    )

    def predict(variables, depth, table, ids):
        _, H, W, _ = depth.shape
        field = model.apply(variables, depth, normalize=False,
                            method=DepthUNet.native_field)
        field = jax.lax.with_sharding_constraint(field, field_spec)
        idx = score(field, table, ids)
        if idx.shape[1:3] != (H, W):
            idx = resize_nearest(idx, (H, W))
        return idx

    def with_mesh(variables, depth, table, ids):
        with jax.sharding.set_mesh(mesh):
            return jax.jit(predict)(variables, depth, table, ids)

    return with_mesh


def shard_predict_inputs(mesh: Mesh, depth, table, ids):
    """Place predict inputs on the mesh (batch over 'data', table rows
    over 'model'; image height over 'spatial' when that axis is
    non-trivial)."""
    n_spatial = dict(mesh.shape).get("spatial", 1)
    dspec = P("data", "spatial") if n_spatial > 1 else P("data")
    depth = jax.device_put(depth, NamedSharding(mesh, dspec))
    table = jax.device_put(table, NamedSharding(mesh, P("model", None)))
    ids = jax.device_put(ids, NamedSharding(mesh, P("model")))
    return depth, table, ids
