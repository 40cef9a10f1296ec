"""Mesh construction + sharding placement helpers.

Design (scaling-book recipe): pick a mesh, annotate input/param shardings,
let XLA insert the collectives.

  * 'data': batch dimension of every batch array — DP.  XLA inserts the
    gradient all-reduce (DDP equivalent, train_util.py:174 + NCCL) and makes
    BatchNorm statistics global (sync-BN; documented divergence from the
    reference's per-replica BN — identical on one device).
  * 'model': class dimension of the text-embedding table, the [C, C]
    similarity/equivalence matrices, and therefore the [N, C] contrastive
    logits — TP for large label tables (NYUv2 transfer with hundreds to
    thousands of classes).  The softmax logsumexp and the scatter updates
    reduce over 'model' via an all-reduce, inserted by GSPMD.
  * 'spatial': the image-height dimension of the depth maps and every
    feature map under them — SP for resolutions whose activation footprint
    exceeds one device (SURVEY section 5's "spatial sharding of feature maps
    if resolution grows").  GSPMD inserts the convolution halo exchanges
    (collective-permute of 1-row boundaries per conv) automatically; BN
    statistics already reduce over (B, H, W) so they simply include a
    'spatial' all-reduce.

Parameters and optimizer state are replicated (the model is a ~15M-param
CNN — replication is the right layout; its gradients are all-reduced once
per accumulation window).  The mesh follows the algorithm alone: on GPUs
the collectives go to NCCL, and every device reaches every other at the
same rate, so devices are laid out in ``jax.devices()`` order.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    n_spatial: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_data is None:
        n_data = len(devices) // (n_model * n_spatial)
    total = n_data * n_model * n_spatial
    assert 0 < total <= len(devices), (
        f"mesh data={n_data} x spatial={n_spatial} x model={n_model} does "
        f"not fit {len(devices)} devices (model*spatial alone may exceed "
        "the device count)"
    )
    procs = sorted({d.process_index for d in devices})
    if len(procs) > 1:
        # Multi-process (the reference's multi-GPU torchrun, train.py:15-19):
        # the grid must give every process an equal, whole number of 'data'
        # rows, laid out process-major, so that each process's addressable
        # shards of a 'data'-sharded batch are exactly its own loader's
        # contiguous block (shard_batch assembles per-process local batches
        # with jax.make_array_from_process_local_data).
        nproc = len(procs)
        assert total % nproc == 0 and (total // nproc) % (n_spatial * n_model) == 0, (
            f"mesh of {total} devices cannot give {nproc} processes whole "
            f"'data' rows of {n_spatial * n_model} devices each"
        )
        per_proc = total // nproc
        by_proc = {p: [] for p in procs}
        for d in devices:
            by_proc[d.process_index].append(d)
        assert all(len(v) >= per_proc for v in by_proc.values()), (
            f"uneven local device counts {[len(by_proc[p]) for p in procs]} "
            f"cannot supply {per_proc} mesh devices per process"
        )
        sel = [d for p in procs for d in by_proc[p][:per_proc]]
    else:
        sel = list(devices[:total])
    grid = np.asarray(sel).reshape(n_data, n_spatial, n_model)
    return Mesh(grid, ("data", "spatial", "model"))


def mesh_process_count(mesh: Mesh) -> int:
    """Number of distinct processes whose devices participate in ``mesh``."""
    return len({d.process_index for d in mesh.devices.flat})


def shard_batch(mesh: Mesh, batch: Dict[str, Any], batch_axis: int = 0
                ) -> Dict[str, Any]:
    """Place batch arrays with the batch dim sharded over 'data' and, when
    the mesh has a non-trivial 'spatial' axis, the image height sharded
    over 'spatial' (rank-4+ arrays only: depth [.., B, H, W, 1] and
    segmentation [.., B, H, W]).

    Works for both [B, ...] and accumulation-major [A, B, ...] layouts
    (pass batch_axis=1 for the latter).

    Single process: a plain ``device_put``.  Multi-process (the reference's
    DDP, one loader shard per rank): every process passes its own LOCAL
    batch and the global array is assembled with
    ``jax.make_array_from_process_local_data`` — the global batch dim is
    ``local * process_count`` with process p's rows at block p (the
    process-major 'data' axis ``make_mesh`` guarantees).  ``device_put``
    cannot do this: it asserts the same value on every process.
    """
    n_spatial = dict(mesh.shape).get("spatial", 1)
    nproc = mesh_process_count(mesh)
    out = {}
    for k, v in batch.items():
        ndim = np.ndim(v)
        spec = [None] * ndim
        if ndim > batch_axis:
            spec[batch_axis] = "data"
        if n_spatial > 1 and ndim >= batch_axis + 3:
            spec[batch_axis + 1] = "spatial"  # the H dim of [B, H, W, ...]
        sharding = NamedSharding(mesh, P(*spec))
        if nproc > 1 and ndim > batch_axis:
            gshape = list(np.shape(v))
            gshape[batch_axis] *= nproc
            out[k] = jax.make_array_from_process_local_data(
                sharding, np.asarray(v), tuple(gshape)
            )
        else:
            out[k] = jax.device_put(v, sharding)
    return out


def replicate(mesh: Mesh, tree):
    return jax.device_put(tree, NamedSharding(mesh, P()))


def shard_state(mesh: Mesh, state):
    """Replicate the train state across the mesh (params/opt-state are small
    for this model family; replication is the chosen layout)."""
    return replicate(mesh, state)


def shard_class_tables(
    mesh: Mesh,
    text_table,
    medium_matrix,
    hard_matrix,
    shard_classes: bool = False,
):
    """Place the frozen class tables.

    With ``shard_classes`` the class axis is split over 'model' (column
    sharding of the [C, D] table and both [C, C] matrices' second axis);
    otherwise everything is replicated (the reference's broadcast,
    train_util.py:230-240, is exactly replicated sharding here).
    """
    if shard_classes and mesh.shape["model"] > 1:
        text = jax.device_put(text_table, NamedSharding(mesh, P("model", None)))
        med = jax.device_put(medium_matrix, NamedSharding(mesh, P(None, "model")))
        hard = jax.device_put(hard_matrix, NamedSharding(mesh, P(None, "model")))
    else:
        text = replicate(mesh, text_table)
        med = replicate(mesh, medium_matrix)
        hard = replicate(mesh, hard_matrix)
    return text, med, hard
