"""rangeclip — an open-vocabulary depth segmentation framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the DepthCLIP
("RangeCLIP") research framework: a ResNet-UNet+ASPP maps single-channel depth
maps to per-pixel embeddings in CLIP's joint text/image embedding space,
trained with a hybrid InfoNCE (pixel-text + area-image) + total-variation loss
with curriculum-scheduled hard-negative distractors, and evaluated with
equivalence-aware top-k pixel accuracy and mIoU.

Design stance:
  * NHWC layout everywhere, bfloat16 compute policy optional,
    fp32 parameters.
  * All randomness goes through explicit ``jax.random`` keys.
  * Every data-dependent shape in the reference (variable foreground pixels,
    variable contrast sets, variable candidate sets) is reformulated as a
    fixed-capacity masked computation so each step compiles exactly once.
  * Data parallelism via ``jax.sharding.Mesh``: XLA inserts the gradient
    all-reduce (replacing torch DDP); the class axis of the contrastive
    head can additionally be sharded ("model" axis) for large
    open-vocabulary label tables.
  * One XLA formulation per operation on every platform; no hand-written
    kernels.

Reference behavior is documented per-module with ``file:line`` citations into
the upstream repo snapshot (see SURVEY.md).
"""

__version__ = "0.1.0"

__all__ = ["DepthUNet", "DepthUNetConfig", "__version__"]


def __getattr__(name):
    # Lazy re-exports so importing subpackages stays cheap.
    if name in ("DepthUNet", "DepthUNetConfig"):
        from rangeclip.models import depth_unet

        return getattr(depth_unet, name)
    raise AttributeError(f"module 'rangeclip' has no attribute {name!r}")
