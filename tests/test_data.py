"""Data layer: transforms vs torch oracles, splits, loader, labels,
synthetic on-disk round trip."""

import os
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as TF

from rangeclip.data.transforms import (
    depth_transform,
    segmentation_transform,
    lower_median_np,
)
from rangeclip.data.loader import (
    ShardedBatchLoader,
    deterministic_split,
)
from rangeclip.data.labels import (
    build_equivalence_class_map,
    build_equivalence_tensor,
    build_similarity_matrices,
)
from rangeclip.data.synthetic import (
    SyntheticDepthSegDataset,
    write_synthetic_dataset,
)


def test_lower_median_matches_torch():
    rng = np.random.default_rng(0)
    for n in (9, 10, 100, 101):
        x = rng.standard_normal(n).astype(np.float32)
        assert lower_median_np(x) == float(torch.median(torch.from_numpy(x)))


def test_depth_transform_matches_torch_pipeline():
    """nearest resize + /median with zero-guard (dataloader.py:23-61)."""
    rng = np.random.default_rng(1)
    depth = (rng.uniform(100, 5000, size=(37, 53))).astype(np.float32)

    got = depth_transform(depth, (24, 24))

    t = torch.from_numpy(depth)[None, None]
    resized = TF.interpolate(t, size=(24, 24), mode="nearest")
    med = resized.median()
    want = (resized / med).squeeze().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)

    # zero-median guard
    zeros = np.zeros((16, 16), np.float32)
    np.testing.assert_array_equal(depth_transform(zeros, (8, 8)), 0.0)


def test_segmentation_transform_matches_torch():
    rng = np.random.default_rng(2)
    seg = rng.integers(0, 20, size=(31, 45))
    got = segmentation_transform(seg, (17, 13))
    t = torch.from_numpy(seg).float()[None, None]
    want = TF.interpolate(t, size=(17, 13), mode="nearest").long().squeeze().numpy()
    np.testing.assert_array_equal(got, want)


def test_deterministic_split_matches_reference_permutation():
    """Must reproduce random.seed(42) + shuffle exactly
    (dataloader.py:95-109)."""
    import random as _random

    n = 100
    train, val, test = deterministic_split(n, seed=42)
    indices = list(range(n))
    _random.Random(42).shuffle(indices)
    assert train == indices[:60]
    assert val == indices[60:80]
    assert test == indices[80:]
    assert sorted(train + val + test) == list(range(n))


def test_sharded_loader_partitions_and_pads():
    ds = SyntheticDepthSegDataset(n_samples=10, resize_shape=(16, 16),
                                  num_classes=8)
    loaders = [
        ShardedBatchLoader(ds, list(range(10)), batch_size=2, shard_id=i,
                           num_shards=2, shuffle=True, seed=0)
        for i in range(2)
    ]
    for l in loaders:
        l.set_epoch(3)
    batches = [list(l) for l in loaders]
    assert len(batches[0]) == len(batches[1]) == 3  # ceil(10/2 shards /2)
    for bs in batches:
        for b in bs:
            assert b["depth"].shape == (2, 16, 16, 1)
            assert b["segmentation"].dtype == np.int32
            assert set(b) >= {"depth", "image", "segmentation", "object_bbox",
                              "object_label", "sample_valid"}

    # ragged final batch is padded with sample_valid=0
    l3 = ShardedBatchLoader(ds, list(range(5)), batch_size=3)
    got = list(l3)
    assert got[-1]["sample_valid"].tolist() == [1.0, 1.0, 0.0]

    # drop_last drops it
    l4 = ShardedBatchLoader(ds, list(range(5)), batch_size=3, drop_last=True)
    assert len(list(l4)) == 1


def test_sharded_loader_surfaces_producer_errors():
    """A decode failure inside the prefetch thread must raise in the
    consumer, not silently end the epoch early (which would desync
    multi-host lockstep or truncate training with no error)."""

    class Exploding(SyntheticDepthSegDataset):
        def __getitem__(self, i, rng=None):
            if i == 3:
                raise OSError("corrupt png")
            return super().__getitem__(i, rng=rng)

    ds = Exploding(n_samples=6, resize_shape=(8, 8), num_classes=4)
    loader = ShardedBatchLoader(ds, list(range(6)), batch_size=2)
    with pytest.raises(RuntimeError, match="producer failed"):
        list(loader)


def test_sharded_loader_abandoned_iteration_stops_producer():
    """Breaking out of iteration mid-epoch (trainer max_steps) must release
    the producer thread instead of leaving it blocked on a full queue."""
    import threading

    before = threading.active_count()
    ds = SyntheticDepthSegDataset(n_samples=30, resize_shape=(8, 8),
                                  num_classes=4)
    for _ in range(3):
        it = iter(ShardedBatchLoader(ds, list(range(30)), batch_size=2,
                                     prefetch=1))
        next(it)
        it.close()  # GeneratorExit mid-epoch
    time.sleep(1.0)  # bounded puts poll at 0.2s
    assert threading.active_count() <= before + 1


def test_shard_indices_wraps_modularly_for_many_shards():
    """More shards than 2x the index list: the pad must wrap the list
    modularly (DistributedSampler semantics) so every shard gets exactly
    ceil(n/num_shards) indices — a single doubling under-fills and skews
    multi-host step counts."""
    from rangeclip.data.loader import _shard_indices

    indices = [7, 8, 9]
    num_shards = 8
    shards = [
        _shard_indices(indices, epoch=0, shard_id=s, num_shards=num_shards,
                       shuffle=False)
        for s in range(num_shards)
    ]
    assert all(len(s) == 1 for s in shards)
    flat = [i for s in shards for i in s]
    assert flat == [indices[i % 3] for i in range(8)]


def test_similarity_sets_keep_lowest_similarity_members():
    """Hard/medium sets sort ascending by similarity before the [:50] cut
    (reference generate_label_similarity_sets.py:58-59); same sets are
    untruncated (:50-52)."""
    from rangeclip.setup_tools.similarity_sets import (
        similarity_sets_from_matrix,
    )

    C = 6
    sim = np.full((C, C), 0.0, np.float32)
    np.fill_diagonal(sim, 1.0)
    # label 0's hard band [0.8, 0.85): labels 1..4 with descending sims
    sim[0, 1], sim[0, 2], sim[0, 3], sim[0, 4] = 0.84, 0.83, 0.82, 0.81
    sim[1, 0], sim[2, 0], sim[3, 0], sim[4, 0] = 0.84, 0.83, 0.82, 0.81
    same, medium, hard = similarity_sets_from_matrix(sim, max_per_set=2)
    # kept members are the two LOWEST-similarity ones, ascending order
    assert hard[0] == [4, 3]
    assert medium[0] == []


def test_label_structures():
    eq = {1: {1, 2}, 2: {1, 2}, 3: {3}}
    t = build_equivalence_tensor(eq, 5)
    assert t[1, 2] and t[2, 1] and t[3, 3] and not t[1, 3]
    cmap = build_equivalence_class_map(t)
    assert cmap[1] == 1 and cmap[2] == 1 and cmap[3] == 3
    assert cmap[0] == 0 and cmap[4] == 4  # untouched rows map to themselves

    sets = {"medium": [[], [3], [4]], "hard": [[], [], [3]]}
    med, hard = build_similarity_matrices(sets, 5)
    assert med[1, 3] and med[2, 4] and hard[2, 3]
    assert not med[0].any() and not hard[0].any()


def test_synthetic_on_disk_roundtrip(tmp_path):
    from rangeclip.data.dataset import ImageDepthTextDataset
    from rangeclip.data.labels import (
        load_candidate_labels,
        load_equivalence_dict,
        load_label_similarity_sets,
    )

    paths = write_synthetic_dataset(str(tmp_path), n_samples=4, shape=(32, 32),
                                    num_classes=6)
    ds = ImageDepthTextDataset(paths["metadata"], paths["labels"], (32, 32))
    assert len(ds) == 4
    assert len(ds.labels) == 6  # dummy + 5

    sample = ds.__getitem__(0, rng=np.random.default_rng(0))
    assert sample["depth"].shape == (32, 32, 1)
    assert sample["image"].shape == (32, 32, 3)
    assert sample["segmentation"].shape == (32, 32)
    x0, y0, x1, y1 = sample["object_bbox"]
    assert 0 <= x0 < x1 <= 32 and 0 <= y0 < y1 <= 32
    assert 0 <= sample["object_label"] < 6

    eq = load_equivalence_dict(paths["similarity"])
    assert all(i in members for i, members in eq.items())
    sets = load_label_similarity_sets(paths["similarity"], 6)
    assert len(sets["medium"]) == 6 and len(sets["hard"]) == 6

    # determinism given the same rng seed
    s2 = ds.__getitem__(0, rng=np.random.default_rng(0))
    np.testing.assert_array_equal(sample["object_bbox"], s2["object_bbox"])


def test_loader_deterministic_across_worker_counts(tmp_path):
    from rangeclip.data.loader import ShardedBatchLoader
    from rangeclip.data.synthetic import write_synthetic_dataset
    from rangeclip.data.dataset import ImageDepthTextDataset

    data = write_synthetic_dataset(str(tmp_path / "d"), n_samples=10,
                                   shape=(16, 16), num_classes=6)
    ds = ImageDepthTextDataset(metadata_file=data["metadata"],
                               labels_path=data["labels"],
                               resize_shape=(16, 16))

    def batches(num_workers, use_processes=None):
        loader = ShardedBatchLoader(ds, list(range(10)), batch_size=4,
                                    shuffle=True, num_workers=num_workers,
                                    use_processes=use_processes)
        loader.set_epoch(3)
        out = list(loader)
        loader.close()
        return out

    a = batches(1)
    # process pool (the default on fork platforms) and the thread fallback
    # must both be bit-identical to serial execution
    for b in (batches(4, use_processes=True), batches(4, use_processes=False)):
        assert len(a) == len(b)
        for ba, bb in zip(a, b):
            for k in ba:
                np.testing.assert_array_equal(ba[k], bb[k])


def test_synthetic_depth_identifies_label(tmp_path):
    """The consistent generator's label->depth mapping survives median
    normalization AND the on-disk int-mm PNG roundtrip: a nearest-plane
    classifier on the NORMALIZED depth recovers the segmentation across
    samples (the property convergence runs rely on — the dataset-level
    plane table + floor-anchored median make depth->label decodable on
    held-out scenes; synthetic.py learnability contract)."""
    from rangeclip.data.dataset import ImageDepthTextDataset
    from rangeclip.data.synthetic import SyntheticDepthSegDataset

    C = 64
    ds = SyntheticDepthSegDataset(6, (48, 48), C, seed=3)
    planes = ds.depth_planes / ds.depth_planes[ds.floor_label]

    def nearest_plane_acc(item):
        d = item["depth"][..., 0]
        pred = np.abs(d[..., None] - planes[None, None, 1:]).argmin(-1) + 1
        return (pred == item["segmentation"]).mean()

    in_mem = np.mean([nearest_plane_acc(ds[i]) for i in range(6)])
    assert in_mem > 0.98, in_mem

    paths = write_synthetic_dataset(str(tmp_path), n_samples=6,
                                    shape=(48, 48), num_classes=C, seed=3)
    disk = ImageDepthTextDataset(paths["metadata"], paths["labels"], (48, 48))
    on_disk = np.mean([
        nearest_plane_acc(disk.__getitem__(i, rng=np.random.default_rng(i)))
        for i in range(6)
    ])
    assert on_disk > 0.98, on_disk

    # the floor plane pins the median: > half the pixels are floor
    frac_floor = np.mean(ds[0]["segmentation"] == ds.floor_label)
    assert frac_floor > 0.5
