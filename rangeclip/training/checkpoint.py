"""Checkpointing of the train state as one ``.npz`` file per step.

Reference: model.py:368-393 — dict checkpoints {train_step, encoder,
decoder, log_temperature_text, log_temperature_image, optimizer} with
defaults injected for missing temperatures on restore; filename template
``checkpoints/depth_segmentation_model-{step}`` (train_util.py:552-556).

Layout: ``<checkpoint_dir>/<step>/state.npz``, one array per pytree leaf,
keyed by the leaf's path (``params/depth_encoder/conv1/conv/kernel``,
``opt_state/0/mu/...``).  Saving gathers every leaf to host numpy (across
processes in a multi-process run) and process 0 writes; restoring reads
the file on every process, so a checkpoint saved under any device layout
restores under any other — the reference's
``torch.load(map_location='cpu')`` portability (model.py:368-371).

Reference bugs deliberately NOT replicated (SURVEY.md section 7):
  * ``restore_depth_encoder`` is called but never defined
    (train_util.py:158) — here encoder-only restore exists and works;
  * the reference rebuilds the optimizer after restoring it
    (train_util.py:163-166), silently discarding optimizer state — here
    restore returns the restored optimizer state intact.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import multihost_utils

from rangeclip.training.state import TrainState

_FILE = "state.npz"


def _key_part(entry) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    return str(entry)


def _leaf_key(path) -> str:
    return "/".join(_key_part(e) for e in path)


def _to_host(x) -> np.ndarray:
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        x = multihost_utils.process_allgather(x, tiled=True)
    x = np.asarray(jax.device_get(x))
    # npz has no bfloat16; float32 holds it exactly and restore casts back
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _nested(flat: dict, prefix: str) -> dict:
    """``{'params/a/b': v}`` -> ``{'a': {'b': v}}`` for keys under prefix."""
    out: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(value)
    return out


class CheckpointManager:
    def __init__(self, checkpoint_dir: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(checkpoint_dir)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), _FILE)

    def steps(self) -> list:
        return sorted(
            int(d) for d in os.listdir(self.directory)
            if d.isdigit() and os.path.exists(self._path(int(d))))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState) -> None:
        """Collective in a multi-process run: every process must call it."""
        leaves = jax.tree_util.tree_flatten_with_path(state)[0]
        arrays = {_leaf_key(path): _to_host(leaf) for path, leaf in leaves}
        step = int(arrays["step"])
        if jax.process_index() == 0:
            step_dir = os.path.join(self.directory, str(step))
            os.makedirs(step_dir, exist_ok=True)
            tmp = os.path.join(step_dir, _FILE + ".tmp.npz")
            np.savez(tmp, **arrays)
            os.replace(tmp, self._path(step))
            if self.max_to_keep:
                for old in self.steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)))
        if jax.process_count() > 1:
            multihost_utils.sync_global_devices(f"checkpoint_save_{step}")

    def _load(self, step: Optional[int]) -> dict:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint found in {self.directory}")
        with np.load(self._path(step)) as f:
            return {k: f[k] for k in f.files}

    def restore(self, template: TrainState, step: Optional[int] = None) -> TrainState:
        """Restore into the structure of ``template``: each leaf takes the
        template leaf's dtype and, for device arrays, its sharding."""
        flat = self._load(step)
        leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
        restored = []
        for path, leaf in leaves:
            key = _leaf_key(path)
            if key not in flat:
                raise KeyError(f"checkpoint in {self.directory} has no {key!r}")
            value = flat[key].astype(np.result_type(leaf))
            if value.shape != np.shape(leaf):
                raise ValueError(f"{key}: checkpoint shape {value.shape} != "
                                 f"template shape {np.shape(leaf)}")
            if isinstance(leaf, jax.Array):
                value = jax.make_array_from_callback(
                    value.shape, leaf.sharding, lambda idx, v=value: v[idx])
            restored.append(value)
        return jax.tree_util.tree_unflatten(treedef, restored)

    def restore_weights(self, step: Optional[int] = None):
        """Template-free restore of just (params, batch_stats, step).

        Works for a checkpoint saved under ANY optimizer configuration —
        weight decay, frozen-encoder ``multi_transform``, etc. — because no
        opt_state template has to match.  For consumers that discard
        optimizer state anyway (inference, export to the reference's .pth
        format).
        """
        flat = self._load(step)
        return (_nested(flat, "params"), _nested(flat, "batch_stats"),
                int(flat["step"]))

    def restore_encoder_params(self, template: TrainState,
                               step: Optional[int] = None):
        """Encoder-only restore (the working version of the reference's
        missing ``restore_depth_encoder``; encoder.py:144-156 capability).

        Returns (params, batch_stats) with the encoder subtrees replaced —
        the BN running statistics matter as much as the weights for a
        frozen-encoder finetune, where the encoder always runs on them
        (model.py:397 eval-mode encoder).  Template-free on the optimizer
        side: the source run's optimizer structure need not match this
        run's (e.g. a plain-Adam pretrain restored into a frozen-encoder
        multi_transform finetune).
        """
        params, batch_stats, _ = self.restore_weights(step)
        new_params = dict(template.params)
        new_params["depth_encoder"] = params["depth_encoder"]
        new_stats = dict(template.batch_stats)
        if "depth_encoder" in batch_stats:
            new_stats["depth_encoder"] = batch_stats["depth_encoder"]
        return new_params, new_stats

    def close(self) -> None:
        pass
