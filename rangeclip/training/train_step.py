"""The compiled training step: gradient accumulation + Adam update, one XLA
program.

Reference hot loop: train_util.py:279-345 — per microbatch forward (AMP),
area-embedding preparation, hybrid loss, backward with loss/accum_steps;
every ``accumulation_steps`` (=8) microbatches one optimizer step.

Design:
  * the whole accumulation window is ONE jitted step — a ``lax.scan`` over
    the microbatch axis runs 8 forward/backward passes on-device and sums
    gradients, then a single Adam update fires.  No host round-trips, no
    GradScaler (bf16 needs none), no per-microbatch dispatch overhead;
  * BatchNorm statistics update through the scan carry, replicating the
    reference's 8 BN updates per optimizer step;
  * the learning rate and curriculum percentages are traced scalars —
    epoch-level schedule changes never recompile;
  * under a ``jax.sharding.Mesh`` the same step runs data-parallel: the
    trainer shards the batch over the 'data' axis and XLA inserts the psum
    for gradients (DDP-allreduce equivalent); a 'model' axis can shard the
    class dimension of the text table, with the softmax logsumexp
    reduction becoming an all-reduce automatically.

BatchNorm under the mesh — precise semantics: this step is jitted over the
whole mesh WITHOUT an axis name, so BN's batch statistics are ordinary
``jnp.mean`` reductions over the full (global) batch axis; XLA lowers them
to all-reduces over the 'data'-sharded dimension.  That is exactly
sync-BN over the global batch — NOT the reference's per-replica DDP BN
(each torch rank normalizes with its local microbatch statistics).  The
global-batch variant is deterministic, has no per-replica stat drift,
and remains the default.

``ddp_parity=True`` opts into the reference-exact multi-device semantics
instead: the per-microbatch loss+grad runs inside ``jax.shard_map`` over
the 'data' axis, so each device computes the FULL hybrid loss on its
local batch shard exactly as one torch DDP rank does — per-replica BN
statistics (local mean/var), per-replica loss normalizations (the
image-contrast InfoNCE pairs each rank's local items only, matching
dataloader.py:205-306 running per-process), then a ``pmean`` of the
gradients (DDP's allreduce, train_util.py:338).  Running BN stats are
pmean-merged across replicas after each update — the one deliberate
divergence from torch DDP, which lets per-rank stats drift and
checkpoints rank 0's (a pmean merge is deterministic and
layout-invariant; documented in PARITY.md).  Proven equivalent to a
manual per-shard DDP simulation in tests/test_parallel.py.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from rangeclip.losses.hybrid import (
    HybridLossConfig,
    compute_hybrid_loss,
    pixel_sampling_key,
)
from rangeclip.losses.infonce import (
    sample_pixel_multiplicities_multinomial,
)
from rangeclip.losses.pooling import per_item_masked_pooling
from rangeclip.models.depth_unet import DepthUNet
from rangeclip.training.state import TrainState


def make_microbatch_loss(
    model: DepthUNet,
    loss_config: HybridLossConfig = HybridLossConfig(),
    native_losses: bool = True,
) -> Callable:
    """One microbatch's hybrid loss — the function whose value_and_grad the
    train step accumulates.  Exposed so the DDP-parity test can build the
    per-shard oracle from the exact same pieces.

    Signature: (params, batch_stats, mb, rng, pct_medium, pct_hard,
    text_table, medium_matrix, hard_matrix) -> (total, (info, new_stats)).
    """
    use_image_loss = loss_config.w_image > 0

    def microbatch_loss(params, batch_stats, mb, rng, pct_m, pct_h,
                        text_table, medium_matrix, hard_matrix):
        fwd = DepthUNet.forward_native if native_losses else None
        (pixel_emb, temp_t, temp_i), updated = model.apply(
            {"params": params, "batch_stats": batch_stats},
            mb["depth"],
            train=True,
            mutable=["batch_stats"],
            **({"method": fwd} if fwd else {}),
        )
        H = mb["depth"].shape[1]
        ups = H // pixel_emb.shape[1]
        assert H == ups * pixel_emb.shape[1], (H, pixel_emb.shape)
        area_emb = image_emb = None
        if use_image_loss:
            # Area embeddings come from the differentiable pixel field
            # (dataloader.py:287-304); CLIP crop embeddings are precomputed
            # and constant (stop_gradient is implicit — they are inputs).
            area_emb = per_item_masked_pooling(
                pixel_emb, mb["segmentation"], mb["object_label"],
                upsample=ups,
            )
            image_emb = mb["image_embeddings"]
        total, info = compute_hybrid_loss(
            rng,
            pixel_emb,
            mb["segmentation"],
            text_table,
            medium_matrix,
            hard_matrix,
            temperature_text=temp_t,
            temperature_image=temp_i,
            pct_medium=pct_m,
            pct_hard=pct_h,
            area_embeddings=area_emb,
            image_embeddings=image_emb,
            area_valid=mb["sample_valid"] if use_image_loss else None,
            sample_weight=mb.get("sample_valid"),
            config=loss_config,
            label_upsample=ups,
            precomputed_pixels=(
                (mb["_pixel_weights"], mb["_pixel_labels"])
                if "_pixel_weights" in mb else None
            ),
        )
        return total, (info, updated["batch_stats"])

    return microbatch_loss


def make_train_step(
    model: DepthUNet,
    optimizer: optax.GradientTransformation,
    loss_config: HybridLossConfig = HybridLossConfig(),
    accum_steps: int = 8,
    donate: bool = True,
    native_losses: bool = True,
    hoist_sampling: bool = True,
    ddp_parity: bool = False,
    mesh: Optional[Mesh] = None,
) -> Callable:
    """Build the jitted train step.

    The returned function has signature
      step(state, batch, rng, lr, pct_medium, pct_hard,
           text_table, medium_matrix, hard_matrix) -> (state, loss_info)

    ``batch`` is a dict with a leading accumulation axis A == accum_steps:
      depth          [A, B, H, W, 1] float32
      segmentation   [A, B, H, W]    int32
      object_label   [A, B]          int32
      image_embeddings [A, B, D]     float32 (frozen CLIP crop embeddings;
                                     zeros when the image loss is disabled)
      sample_valid   [A, B]          float32

    ``native_losses=True`` (default) evaluates every loss term at the
    decoder's NATIVE resolution (H/2): the full-res field is a nearest x2
    upsample, and CE / TV / area pooling all commute with that upsample
    exactly (hybrid.py label_upsample) — identical losses and gradients
    with ~4x less memory traffic.
    ``native_losses=False`` is the literal full-resolution formulation for
    parity runs.

    ``ddp_parity=True`` (requires ``mesh``, DP-only) reproduces torch
    DDP's multi-device semantics exactly — per-replica BN statistics and
    per-replica loss computation over each device's local batch shard,
    gradients pmean'd — instead of the default global-batch formulation.
    See the module docstring for the precise contract.
    """
    # Hoisting applies to the multinomial sampler only (the histogram
    # scatter has no grad path to trip on, and the gather sampler needs
    # the forward's field); ``hoist_sampling=False`` keeps the sampler
    # inline for the bit-identity test.  Under ddp_parity the sampler must
    # run inside the per-rank shard_map (each rank draws from its own
    # stream over its own shard), so the global hoist is disabled.
    hoist_multinomial = (hoist_sampling
                         and not ddp_parity
                         and loss_config.pixel_sampler == "multinomial")

    microbatch_loss = make_microbatch_loss(model, loss_config, native_losses)
    local_grad_fn = jax.value_and_grad(microbatch_loss, has_aux=True)
    grad_fn = local_grad_fn

    if ddp_parity:
        if mesh is None:
            raise ValueError("ddp_parity=True requires the mesh")
        for axis, size in mesh.shape.items():
            if axis != "data" and size > 1:
                raise ValueError(
                    "ddp_parity is the reference's DDP (data-parallel only) "
                    f"semantics; mesh axis {axis!r} has size {size} > 1")

        def local_grad(params, batch_stats, mb, mb_rng, pct_m, pct_h,
                       text, medm, hardm):
            # Independent per-rank RNG streams, like torch DDP's per-rank
            # seeding: pixel/contrast draws on rank r are decorrelated from
            # rank 0's instead of replaying the same realization per shard.
            mb_rng = jax.random.fold_in(mb_rng, jax.lax.axis_index("data"))
            (loss, (info, new_stats)), grads = local_grad_fn(
                params, batch_stats, mb, mb_rng, pct_m, pct_h,
                text, medm, hardm,
            )
            # DDP's gradient allreduce (train_util.py:338).  Loss/info are
            # pmean'd for logging (torch logs rank 0's local loss; the mean
            # is deterministic).  Running BN stats are pmean-merged — the
            # documented divergence from torch's drifting per-rank stats.
            pmean = lambda t: jax.tree.map(
                lambda x: jax.lax.pmean(x, "data"), t)
            return (pmean(loss), (pmean(info), pmean(new_stats))), pmean(grads)

        grad_fn = jax.shard_map(
            local_grad,
            # the abstract mesh: shard_map under jit must agree with the
            # jax.sharding.set_mesh context the trainer establishes
            mesh=mesh.abstract_mesh,
            in_specs=(P(), P(), P("data"), P(), P(), P(), P(), P(), P()),
            out_specs=((P(), (P(), P())), P()),
            check_vma=False,
        )

    def train_step(
        state: TrainState,
        batch: Dict[str, jax.Array],
        rng: jax.Array,
        lr: jax.Array,
        pct_medium: jax.Array,
        pct_hard: jax.Array,
        text_table: jax.Array,
        medium_matrix: jax.Array,
        hard_matrix: jax.Array,
    ) -> Tuple[TrainState, Dict[str, jax.Array]]:
        zero_grads = jax.tree.map(jnp.zeros_like, state.params)

        if hoist_multinomial and loss_config.w_text > 0:
            # Hoist the multinomial pixel sampler out of the grad'd scan
            # body; the key derivation matches the in-loss sampler exactly
            # (pixel_sampling_key), so hoisted and inline sampling are
            # bit-identical (tested).  The histogram sampler stays the
            # default; see HybridLossConfig.
            H = batch["depth"].shape[2]
            if native_losses:
                field = jax.eval_shape(
                    lambda p, bs, d: model.apply(
                        {"params": p, "batch_stats": bs}, d, train=True,
                        mutable=["batch_stats"],
                        method=DepthUNet.forward_native,
                    )[0][0],
                    state.params, state.batch_stats, batch["depth"][0],
                )
                hoist_ups = H // field.shape[1]
            else:
                hoist_ups = 1

            def sample_mb(idx):
                mb_rng = jax.random.fold_in(rng, idx)
                return sample_pixel_multiplicities_multinomial(
                    pixel_sampling_key(mb_rng),
                    batch["segmentation"][idx],
                    loss_config.percent_image_sampling,
                    slots=hoist_ups,
                )

            # unrolled, NOT lax.map: lax.map is a scan, and binomial's
            # while_loops run badly inside a scan
            per_mb = [sample_mb(i) for i in range(accum_steps)]
            pw = jnp.stack([w for w, _ in per_mb])
            pl = jnp.stack([l for _, l in per_mb])
            batch = dict(batch, _pixel_weights=pw, _pixel_labels=pl)

        def scan_body(carry, mb_with_idx):
            grads_acc, batch_stats, info_acc = carry
            mb, idx = mb_with_idx
            mb_rng = jax.random.fold_in(rng, idx)
            (loss, (info, new_stats)), grads = grad_fn(
                state.params, batch_stats, mb, mb_rng, pct_medium, pct_hard,
                text_table, medium_matrix, hard_matrix,
            )
            grads_acc = jax.tree.map(jnp.add, grads_acc, grads)
            info_acc = jax.tree.map(jnp.add, info_acc, info)
            return (grads_acc, new_stats, info_acc), None

        zero_info = {
            "total_loss": jnp.float32(0.0),
            "text_contrastive_loss": jnp.float32(0.0),
            "image_contrastive_loss": jnp.float32(0.0),
            "smoothness_loss": jnp.float32(0.0),
            "temperature_text": jnp.float32(0.0),
            "temperature_image": jnp.float32(0.0),
            "W_text": jnp.float32(0.0),
            "W_image": jnp.float32(0.0),
            "W_smooth": jnp.float32(0.0),
        }
        idxs = jnp.arange(accum_steps)
        (grads, batch_stats, info_sum), _ = jax.lax.scan(
            scan_body, (zero_grads, state.batch_stats, zero_info), (batch, idxs)
        )
        # Mean gradient over microbatches == reference's sum of loss/accum
        # gradients (train_util.py:337-338).
        grads = jax.tree.map(lambda g: g / accum_steps, grads)
        info = jax.tree.map(lambda x: x / accum_steps, info_sum)

        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        updates = jax.tree.map(lambda u: u * lr, updates)
        params = optax.apply_updates(state.params, updates)

        new_state = TrainState(
            step=state.step + 1,
            params=params,
            batch_stats=batch_stats,
            opt_state=opt_state,
        )
        info["learning_rate"] = jnp.asarray(lr, jnp.float32)
        info["grad_norm"] = optax.global_norm(grads)
        return new_state, info

    jitted = jax.jit(train_step, donate_argnums=(0,) if donate else ())
    if mesh is None:
        return jitted

    # ddp_parity's shard_map binds mesh axes by name through the
    # context mesh; the step establishes it itself so callers (trainer,
    # tests) need no set_mesh of their own.  Re-entering an already-set
    # identical mesh is a no-op.
    def with_mesh(*args, **kwargs):
        with jax.sharding.set_mesh(mesh):
            return jitted(*args, **kwargs)

    return with_mesh
