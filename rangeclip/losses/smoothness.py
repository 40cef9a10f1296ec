"""Total-variation smoothness regularizer.

Reference: model.py:329-334 — L1 distance between horizontally and
vertically adjacent pixel embeddings (torch F.l1_loss => mean reduction),
summed over the two directions.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def total_variation_loss(
    pixel_embeddings: jax.Array,
    upsample: int = 1,
    sample_weight: jax.Array = None,
) -> jax.Array:
    """pixel_embeddings: [B, H, W, D] (NHWC).

    ``sample_weight``: optional [B] 0/1 weights excluding padded batch
    items (fixed-shape final batches pad with sample_valid=0 duplicates).
    Implemented as TV(x * w) * B/sum(w): zero items contribute zero
    variation and zero gradient, and the rescale makes the value the exact
    reference TV of the valid sub-batch.  With all-ones weights both the
    multiply (x*1) and the rescale (*1.0) are bitwise identities, so the
    weighted path is BIT-IDENTICAL to the unweighted one on full batches.
    Weights are assumed 0/1 (a fractional weight would scale the field
    inside the |.|, not the loss).

    Differences/abs run in the input dtype (halving memory traffic under
    the bf16 policy — this term is bandwidth-bound); the mean accumulates in
    fp32 either way.  fp32 inputs -> bit-identical to the fp32 reference.

    ``upsample=s`` computes the EXACT TV of the nearest xs upsample of the
    input without materializing it: inside an sxs block all differences are
    zero, and each native cross-boundary difference appears s times per
    direction, so
      mean_full_h = mean_native_h * (W - 1) / (s*W - 1)   (W native width)
    and symmetrically for the vertical term.  Used by the native-resolution
    training mode (hybrid.py label_upsample).

    The BACKWARD is a hand-derived custom VJP: XLA's autodiff of the
    two-direction mean|diff| materializes four sign fields (two bf16
    [B, H, W-1, D]-sized tuples) and then re-reads them for the shifted
    adds.  The analytic gradient
      dx = gh * (pad_r(sign(dh)) - pad_l(sign(dh)))
         + gv * (pad_d(sign(dv)) - pad_u(sign(dv)))
    is one fused elementwise pass: read x at the four neighbor offsets,
    write the gradient once.  Same math as XLA's autodiff of jnp.abs
    (including the +1-at-ties convention), verified elementwise-equal in
    tests/test_losses.py.
    """
    if sample_weight is not None:
        scale = pixel_embeddings.shape[0] / jnp.maximum(
            jnp.sum(sample_weight.astype(jnp.float32)), 1.0
        )
        w = sample_weight.astype(pixel_embeddings.dtype)
        pixel_embeddings = pixel_embeddings * w[:, None, None, None]
        return _tv(pixel_embeddings, int(upsample)) * scale
    return _tv(pixel_embeddings, int(upsample))


def _tv_value(x: jax.Array, upsample: int) -> jax.Array:
    tv_h = jnp.mean(jnp.abs(x[:, :, :-1, :] - x[:, :, 1:, :]),
                    dtype=jnp.float32)
    tv_v = jnp.mean(jnp.abs(x[:, :-1, :, :] - x[:, 1:, :, :]),
                    dtype=jnp.float32)
    if upsample > 1:
        H, W = x.shape[1], x.shape[2]
        tv_h = tv_h * ((W - 1) / (upsample * W - 1))
        tv_v = tv_v * ((H - 1) / (upsample * H - 1))
    return tv_h + tv_v


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _tv(x: jax.Array, upsample: int) -> jax.Array:
    return _tv_value(x, upsample)


def _tv_fwd(x, upsample):
    return _tv_value(x, upsample), x


def _tv_bwd(upsample, x, g):
    B, H, W, D = x.shape
    s = upsample
    gh = g / (B * H * (W - 1) * D)
    gv = g / (B * (H - 1) * W * D)
    if s > 1:
        gh = gh * ((W - 1) / (s * W - 1))
        gv = gv * ((H - 1) / (s * H - 1))
    # JAX's d|u|/du convention is u >= 0 ? +1 : -1 (+1 at exact ties, where
    # torch's sign-based backward gives 0) — kept so this VJP is elementwise
    # IDENTICAL to XLA's autodiff of the forward; ties are measure-zero on
    # real embeddings.
    #
    # Everything stays in the INPUT dtype: the forward differences run in
    # x.dtype (see the class docstring), so the exact-match slope is the
    # sign of the x.dtype difference — and ±1 is exact in bf16.  XLA
    # materializes sh/sv (each feeds two pads), so under the bf16 policy
    # this halves the two sign fields' memory writes AND drops an f32 copy
    # of x the train step would otherwise carry as a loop residual.  gh/gv
    # stay f32 scalars (they carry the 1/N scale); the combine promotes
    # elementwise.
    def slope(u):
        one = jnp.asarray(1, u.dtype)
        return jnp.where(u >= 0, one, -one)

    sh = slope(x[:, :, :-1, :] - x[:, :, 1:, :])  # [B, H, W-1, D], x.dtype
    sv = slope(x[:, :-1, :, :] - x[:, 1:, :, :])  # [B, H-1, W, D], x.dtype
    no = (0, 0)
    grad = (
        gh * (jnp.pad(sh, (no, no, (0, 1), no))
              - jnp.pad(sh, (no, no, (1, 0), no)))
        + gv * (jnp.pad(sv, (no, (0, 1), no, no))
                - jnp.pad(sv, (no, (1, 0), no, no)))
    )
    return (grad.astype(x.dtype),)


_tv.defvjp(_tv_fwd, _tv_bwd)
