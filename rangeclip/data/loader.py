"""Deterministic splits + sharded, prefetching batch loader.

Reference: dataloader.py:95-140 —
  * deterministic 60/20/20 split with ``random.seed(42)`` + shuffle — the
    exact same index permutation is reproduced here (python's Mersenne
    shuffle, so checkpoints trained against the reference's split remain
    comparable);
  * DistributedSampler per split + per-epoch reshuffle (train_util.py:273);
  * n_train_steps = ceil(n/batch) * n_epoch (:137-138).

Loader design: a background thread pipelines host-side decode +
transform ahead of the device; each host reads only its shard (the
DistributedSampler equivalent: pad indices to a multiple of the shard count,
then round-robin).  Batches are fixed-shape; a final ragged batch is padded
by repeating its first sample with ``sample_valid = 0`` so jit never sees a
new shape (the reference instead lets torch emit a ragged last batch).

Workers are OS processes by default (the torch ``num_workers`` process
semantics, dataloader.py:116-135): PNG decode + the numpy transforms hold
the GIL, so a thread pool cannot scale past ~1 core no matter the worker
count, while the compiled train step consumes ~280 maps/s and one core
decodes ~39 maps/s (measured, 480x640 -> 256^2) — feeding the chip needs
real multi-core decode.  (The dev machine here has a single core, so both
modes measure the same on it; the pool is persistent across epochs either
way.)  Each sample's RNG is derived from its (seed, epoch, shard, position)
alone, so thread, process, and serial execution produce bit-identical
batches in any completion order.  Workers use a forkserver (clean helper
process — never fork()ing the JAX-threaded parent); unpicklable datasets
fall back to threads automatically.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import random
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_WORKER_DATASET = None


def _init_worker(dataset, env: Dict[str, str]) -> None:
    """Pool initializer: receives the dataset plus the parent's relevant
    env (e.g. the RANGECLIP_NATIVE toggle).  Forkserver workers descend
    from a helper whose environment froze at first pool creation, so env
    the parent sets later must be shipped explicitly."""
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    os.environ.update(env)


def _accepts_rng(dataset) -> bool:
    """Signature inspection, cached per dataset object (also per worker
    process) — a try/except TypeError around the call would misclassify
    TypeErrors raised INSIDE __getitem__ as 'no rng kwarg' and silently
    retry without the deterministic RNG, masking the real error and
    breaking batch reproducibility."""
    cached = getattr(dataset, "_rng_kwarg_ok", None)
    if cached is None:
        import inspect

        try:
            cached = "rng" in inspect.signature(
                dataset.__getitem__).parameters
        except (TypeError, ValueError):  # builtins without a signature
            cached = False
        try:
            dataset._rng_kwarg_ok = cached
        except Exception:  # frozen/slotted datasets: re-inspect each time
            pass
    return cached


def _fetch_with(dataset, args):
    """One sample with a deterministic per-position RNG, so worker count and
    completion order never change the data (the reference's per-worker torch
    seeds are order-dependent)."""
    i, seed, epoch, shard_id, position = args
    if _accepts_rng(dataset):
        rng = np.random.default_rng((seed, epoch, shard_id, position))
        return dataset.__getitem__(i, rng=rng)
    return dataset[i]


def _fetch_in_worker(args):
    return _fetch_with(_WORKER_DATASET, args)


def deterministic_split(
    n: int, seed: int = 42
) -> Tuple[List[int], List[int], List[int]]:
    """60/20/20 split identical to the reference (dataloader.py:95-109)."""
    indices = list(range(n))
    random.Random(seed).shuffle(indices)
    split1 = int(0.6 * n)
    split2 = int(0.8 * n)
    return indices[:split1], indices[split1:split2], indices[split2:]


def _shard_indices(
    indices: Sequence[int], epoch: int, shard_id: int, num_shards: int, shuffle: bool,
    seed: int = 0,
) -> List[int]:
    """DistributedSampler semantics: shuffle(seed+epoch), pad to a multiple
    of num_shards by wrapping, take every num_shards-th element."""
    idx = list(indices)
    if shuffle:
        g = np.random.default_rng(seed + epoch)
        idx = [idx[i] for i in g.permutation(len(idx))]
    if num_shards > 1 and len(idx) > 0:
        total = -(-len(idx) // num_shards) * num_shards
        # Modular wrap: repeat the list however many times the pad needs
        # (a single doubling under-fills when num_shards > 2*len(idx),
        # giving ragged shard lengths -> multi-host step-count skew).
        idx = [idx[i % len(idx)] for i in range(total)]
        idx = idx[shard_id::num_shards]
    return idx


class ShardedBatchLoader:
    """Iterates fixed-shape batches of a dataset subset with prefetch.

    Yields dicts of stacked numpy arrays with an extra ``sample_valid``
    [B] float32 mask (0 marks padding in the final ragged batch).
    """

    def __init__(
        self,
        dataset,
        indices: Sequence[int],
        batch_size: int,
        shard_id: int = 0,
        num_shards: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
        num_workers: int = 4,
        use_processes: Optional[bool] = None,
    ):
        self.dataset = dataset
        self.indices = list(indices)
        self.batch_size = batch_size
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = max(1, num_workers)
        self.use_processes = use_processes
        self.epoch = 0
        self._pool = None
        self._fetch_fn = None
        self._pool_workers = 0

    def set_epoch(self, epoch: int) -> None:
        """Per-epoch reshuffle hook (train_util.py:273)."""
        self.epoch = epoch

    def close(self) -> None:
        """Release the worker pool (also runs at GC)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
            self._fetch_fn = None
            self._pool_workers = 0

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def __len__(self) -> int:
        n = len(_shard_indices(self.indices, self.epoch, self.shard_id,
                               self.num_shards, False))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _want_processes(self) -> bool:
        if self.num_workers <= 1:
            return False
        if self.use_processes is not None:
            return self.use_processes
        try:  # workers receive the dataset once, by pickle, at pool start
            pickle.dumps(self.dataset)
            return True
        except Exception:
            return False

    def _make_pool(self):
        """Lazily create (and then reuse across epochs) the worker pool —
        process startup would otherwise tax every ``__iter__``.  Workers
        receive the dataset once at creation; datasets are immutable."""
        if self.num_workers <= 1:
            return None, None
        if self._pool is not None and self._pool_workers == self.num_workers:
            return self._pool, self._fetch_fn
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if self._want_processes():
            # forkserver, not fork: by the time the pool is first used the
            # parent has live non-Python threads (XLA/PJRT pools, backend
            # RPC); fork() would copy the address space with their mutexes
            # held and a worker could deadlock on first malloc/log call.
            # forkserver workers descend from a clean helper process; the
            # dataset reaches them once, by pickle, via the initializer.
            methods = multiprocessing.get_all_start_methods()
            ctx = multiprocessing.get_context(
                "forkserver" if "forkserver" in methods else "spawn")
            passthrough = {
                k: v for k, v in os.environ.items()
                if k.startswith("RANGECLIP_")
            }
            # workers only decode and resize on the host; a worker that
            # touched an accelerator would reserve most of its memory
            passthrough["JAX_PLATFORMS"] = "cpu"
            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=ctx,
                initializer=_init_worker,
                initargs=(self.dataset, passthrough),
            )
            self._fetch_fn = _fetch_in_worker
        else:
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers)

            def fetch(args, dataset=self.dataset):
                return _fetch_with(dataset, args)

            self._fetch_fn = fetch
        self._pool_workers = self.num_workers
        return self._pool, self._fetch_fn

    def _make_batch(self, batch_indices: List[int], batch_start: int,
                    pool, fetch_fn) -> Dict[str, np.ndarray]:
        n_real = len(batch_indices)
        padded = batch_indices + [batch_indices[0]] * (self.batch_size - n_real)
        args = [
            (i, self.seed, self.epoch, self.shard_id, p)
            for i, p in zip(padded,
                            range(batch_start, batch_start + self.batch_size))
        ]
        if pool is not None:
            samples = list(pool.map(fetch_fn, args))
        else:
            samples = [_fetch_with(self.dataset, a) for a in args]
        batch = {
            k: np.stack([s[k] for s in samples], axis=0) for k in samples[0]
        }
        valid = np.zeros((self.batch_size,), np.float32)
        valid[:n_real] = 1.0
        batch["sample_valid"] = valid
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = _shard_indices(self.indices, self.epoch, self.shard_id,
                             self.num_shards, self.shuffle, self.seed)
        batches: List[List[int]] = [
            idx[i : i + self.batch_size] for i in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        error: List[BaseException] = []
        pool, fetch_fn = self._make_pool()

        def _put(item) -> bool:
            # bounded puts so an abandoned iteration (consumer gone, queue
            # full) can't pin the producer thread forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for bi, b in enumerate(batches):
                    if stop.is_set():
                        return
                    if not _put(self._make_batch(b, bi * self.batch_size,
                                                 pool, fetch_fn)):
                        return
            except BaseException as e:  # re-raised in the consumer — a
                error.append(e)         # swallowed decode error would end
            finally:                    # the epoch early and silently
                _put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            t.join()
            if error:
                raise RuntimeError(
                    "dataloader producer failed while building a batch"
                ) from error[0]
        finally:
            stop.set()


def setup_dataloaders(
    metadata_file: str,
    labels_file: str,
    resize_shape: Tuple[int, int],
    batch_size: int,
    n_epoch: int,
    shard_id: int = 0,
    num_shards: int = 1,
    seed: int = 42,
):
    """Build train/val/test loaders + labels (dataloader.py:11-140).

    Returns (train_loader, val_loader, test_loader, n_train_steps, labels).
    """
    from rangeclip.data.dataset import ImageDepthTextDataset

    dataset = ImageDepthTextDataset(
        metadata_file=metadata_file, labels_path=labels_file, resize_shape=resize_shape
    )
    train_idx, val_idx, test_idx = deterministic_split(len(dataset), seed=seed)

    train_loader = ShardedBatchLoader(
        dataset, train_idx, batch_size, shard_id, num_shards, shuffle=True,
        drop_last=True,
    )
    val_loader = ShardedBatchLoader(
        dataset, val_idx, batch_size, shard_id, num_shards, shuffle=False
    )
    test_loader = ShardedBatchLoader(
        dataset, test_idx, batch_size, shard_id, num_shards, shuffle=False
    )
    n_train_steps = -(-len(train_idx) // batch_size) * n_epoch
    return train_loader, val_loader, test_loader, n_train_steps, dataset.labels
