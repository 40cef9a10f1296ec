"""Setup CLI dispatcher: every subcommand end-to-end on tiny fixtures."""

import csv
import os

import numpy as np
import pytest
from PIL import Image

from rangeclip.cli import setup as setup_cli


@pytest.fixture()
def fixtures(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "void/image").mkdir(parents=True)
    (tmp_path / "void/depth").mkdir(parents=True)
    for i in range(4):
        Image.fromarray(
            rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
        ).save(tmp_path / f"void/image/{i:03d}.png")
        Image.fromarray(
            rng.integers(0, 5000, (16, 16)).astype(np.int32), mode="I"
        ).save(tmp_path / f"void/depth/{i:03d}.png")

    (tmp_path / "dets").mkdir()
    (tmp_path / "dets/img0.txt").write_text(
        "1 0.5 0.5 0.4 0.4 0.9\n2 0.52 0.52 0.4 0.4 0.8\n"
        "3 0.1 0.1 0.1 0.1 0.7\n"
    )

    (tmp_path / "raw_labels.txt").write_text("Chair\nchair \nTable\nlamp\n")
    (tmp_path / "labelpngs").mkdir()
    Image.fromarray(
        rng.integers(1, 5, (8, 8)).astype(np.int32), mode="I"
    ).save(tmp_path / "labelpngs/a.png")

    labels_csv = tmp_path / "candidate_labels.csv"
    with open(labels_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "label"])
        for i, name in enumerate(["chair", "table", "lamp"], start=1):
            w.writerow([i, name])

    meta = tmp_path / "meta.csv"
    with open(meta, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["image", "depth", "object_id"])
        w.writeheader()
        for k in range(8):
            w.writerow({"image": f"i{k}.png", "depth": f"d{k}.png",
                        "object_id": str(1 if k < 5 else 2)})
    return tmp_path


def test_similarity_sets(fixtures):
    out = fixtures / "sim.csv"
    setup_cli.main([
        "similarity-sets", "--labels_path", str(fixtures / "candidate_labels.csv"),
        "--output_csv", str(out), "--embedding_dim", "32",
    ])
    rows = list(csv.DictReader(open(out)))
    assert rows[0]["label"] == "unavailable"
    assert len(rows) == 4  # dummy + 3 labels


def test_cleanup_and_void_and_prune(fixtures):
    setup_cli.main([
        "cleanup-labels", "--raw_labels", str(fixtures / "raw_labels.txt"),
        "--label_png_glob", str(fixtures / "labelpngs/*.png"),
        "--output_dir", str(fixtures / "clean"),
        "--labels_csv", str(fixtures / "clean.csv"),
        "--frequency_csv", str(fixtures / "freq.csv"),
    ])
    assert os.path.exists(fixtures / "clean.csv")

    setup_cli.main([
        "void-train-files", "--image_dir", str(fixtures / "void/image"),
        "--depth_dir", str(fixtures / "void/depth"),
        "--image_list_out", str(fixtures / "img.txt"),
        "--depth_list_out", str(fixtures / "dep.txt"),
    ])
    assert len(open(fixtures / "img.txt").readlines()) == 4

    setup_cli.main([
        "remove-small", "--metadata_csv", str(fixtures / "meta.csv"),
        "--output_csv", str(fixtures / "pruned.csv"), "--min_count", "4",
    ])
    assert len(list(csv.DictReader(open(fixtures / "pruned.csv")))) == 5


def test_pseudo_gt_nms(fixtures):
    setup_cli.main([
        "pseudo-gt", "--detections_glob", str(fixtures / "dets/*.txt"),
        "--output_dir", str(fixtures / "nms"),
    ])
    lines = open(fixtures / "nms/img0.txt").read().strip().splitlines()
    kept_classes = [int(l.split()[0]) for l in lines]
    assert kept_classes == [1, 3]  # overlapping class-2 box suppressed


def test_nyu_labeled_mat_layouts(tmp_path):
    """load_nyu_labeled_mat normalizes BOTH storage layouts to sample-first
    [N, H, W(, 3)] (v7.3/h5py arrives MATLAB-transposed [N, 3, W, H]; the
    scipy path arrives sample-LAST [H, W, 3, N]), and the nyu-labeled CLI
    writes one correctly-oriented patch triplet per labeled object."""
    h5py = pytest.importorskip("h5py")
    from rangeclip.setup_tools.nyu import load_nyu_labeled_mat

    N, H, W = 2, 12, 10
    rng = np.random.default_rng(3)
    images = rng.integers(0, 255, (N, H, W, 3)).astype(np.uint8)
    depths = rng.random((N, H, W)).astype(np.float32)
    labels = np.zeros((N, H, W), np.uint16)
    labels[0, 2:6, 3:8] = 7
    labels[1, 1:4, 1:4] = 2

    mat = tmp_path / "labeled.mat"
    with h5py.File(mat, "w") as f:  # MATLAB v7.3 layout as h5py reads it
        f["images"] = images.transpose(0, 3, 2, 1)  # [N, 3, W, H]
        f["depths"] = depths.transpose(0, 2, 1)     # [N, W, H]
        f["labels"] = labels.transpose(0, 2, 1)

    data = load_nyu_labeled_mat(str(mat))
    np.testing.assert_array_equal(data["images"], images)
    np.testing.assert_array_equal(data["labels"], labels)

    out = tmp_path / "patches"
    setup_cli.main([
        "nyu-labeled", "--mat_path", str(mat), "--output_dir", str(out),
        "--patch_size", "8",
    ])
    import pandas as pd

    meta = pd.read_csv(out / "metadata.csv")
    assert sorted(meta["object_id"]) == [2, 7]
    for name in meta["image"]:
        assert Image.open(out / name).size == (8, 8)

    try:
        from scipy.io import savemat
    except ImportError:
        return
    mat2 = tmp_path / "labeled_v5.mat"
    savemat(str(mat2), {
        "images": images.transpose(1, 2, 3, 0),  # [H, W, 3, N]
        "depths": depths.transpose(1, 2, 0),
        "labels": labels.transpose(1, 2, 0),
    })
    data2 = load_nyu_labeled_mat(str(mat2))
    np.testing.assert_array_equal(data2["images"], images)
    np.testing.assert_array_equal(data2["labels"], labels)


def test_pseudo_gt_ultralytics_adapter(tmp_path, monkeypatch):
    """Stub-detector oracle for the YOLO-World adapter (reference
    setup/generate_pseudo_ground_truth.py:83-147): a fake ultralytics
    module verifies weights loading, set_classes wiring, xywhn/conf/cls
    extraction, and that the downstream cross-class NMS suppresses the
    overlapping lower-confidence box — end to end through the CLI."""
    import sys
    import types

    import numpy as np
    from PIL import Image

    class _Box:
        def __init__(self, cls, xywhn, conf):
            self.cls = cls
            self.xywhn = [xywhn]
            self.conf = [conf]

    class _Result:
        def __init__(self, boxes):
            self.boxes = boxes

    calls = {}

    class _YOLO:
        def __init__(self, weights):
            calls["weights"] = weights

        def set_classes(self, names):
            calls["classes"] = list(names)

        def predict(self, source, **kwargs):
            calls.setdefault("predicted", []).extend(source)
            assert kwargs.get("save_txt") is False
            # two near-identical boxes (IoU 1.0, different class) + one
            # disjoint box: cross-class NMS must keep the higher-conf of
            # the pair regardless of class
            return [_Result([
                _Box(2.0, [0.5, 0.5, 0.2, 0.2], 0.70),
                _Box(5.0, [0.5, 0.5, 0.2, 0.2], 0.90),
                _Box(1.0, [0.1, 0.1, 0.05, 0.05], 0.40),
            ])]

    fake = types.ModuleType("ultralytics")
    fake.YOLO = _YOLO
    monkeypatch.setitem(sys.modules, "ultralytics", fake)

    img = tmp_path / "scene0.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(img)
    classes = tmp_path / "cats.json"
    classes.write_text(
        '{"categories": [{"name": "chair"}, {"name": "table"}]}')

    setup_cli.main([
        "pseudo-gt", "--images_glob", str(tmp_path / "*.png"),
        "--yolo_weights", "local-yolo.pt",
        "--classes_json", str(classes),
        "--output_dir", str(tmp_path / "out"),
    ])
    assert calls["weights"] == "local-yolo.pt"
    assert calls["classes"] == ["chair", "table"]
    assert calls["predicted"] == [str(img)]

    from rangeclip.setup_tools.pseudo_ground_truth import (
        read_detection_file,
    )

    dets = read_detection_file(str(tmp_path / "out/scene0.txt"))
    # conf-desc order, overlapping cls-2 box suppressed by the cls-5 one
    assert [int(c) for c in dets[:, 0]] == [5, 1]
    np.testing.assert_allclose(dets[0, 1:5], [0.5, 0.5, 0.2, 0.2])
    np.testing.assert_allclose(dets[:, 5], [0.9, 0.4])


def test_pseudo_gt_requires_exactly_one_source(fixtures):
    import pytest

    with pytest.raises(SystemExit, match="exactly one"):
        setup_cli.main(["pseudo-gt", "--output_dir", "x"])
    with pytest.raises(SystemExit, match="exactly one"):
        setup_cli.main([
            "pseudo-gt", "--detections_glob", "a/*.txt",
            "--images_glob", "b/*.png", "--output_dir", "x",
        ])
