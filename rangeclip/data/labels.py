"""Label structures: candidate labels, equivalence sets, similarity sets.

Reference: datasets.py:28-37 (label CSV contract), dataloader.py:147-202
(equivalence dict/tensor, similarity sets, equivalence class map).

All structures are built once at startup as numpy arrays; the [C, C] boolean
similarity matrices are the array reformulation of the reference's
per-label python lists (they let the loss select distractor pools with a
single matmul instead of set unions).
"""

from __future__ import annotations

import ast
import csv
from typing import Dict, List, Sequence, Set

import numpy as np

DUMMY_LABEL = "unavailable"


def read_csv_rows(path: str) -> List[Dict[str, str]]:
    """CSV with a header row -> one {column: string} dict per row."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def load_candidate_labels(labels_path: str) -> List[str]:
    """Load the label CSV; index 0 becomes the dummy 'unavailable' class.

    Contract (datasets.py:28-37): CSV columns [label, index]; indices must be
    1-based, consecutive, sorted.
    """
    rows = sorted(read_csv_rows(labels_path), key=lambda r: int(r["index"]))
    labels = [r["label"] for r in rows]
    actual = [int(r["index"]) for r in rows]
    expected = list(range(1, len(labels) + 1))
    assert actual == expected, (
        f"Indices in {labels_path} must be 1-based, consecutive, and sorted. "
        f"Found: {actual}"
    )
    return [DUMMY_LABEL] + labels


def load_equivalence_dict(csv_path: str) -> Dict[int, Set[int]]:
    """CSV columns [index, same] -> {index: set(same) | {index}}
    (dataloader.py:147-155)."""
    equivalence: Dict[int, Set[int]] = {}
    for row in read_csv_rows(csv_path):
        idx = int(row["index"])
        same = set(ast.literal_eval(row["same"]))
        same.add(idx)
        equivalence[idx] = same
    return equivalence


def build_equivalence_tensor(
    equivalence_dict: Dict[int, Set[int]], num_classes: int
) -> np.ndarray:
    """[C, C] bool lookup: equivalence[gt, pred] (dataloader.py:159-165)."""
    lookup = np.zeros((num_classes, num_classes), dtype=bool)
    for gt, equivalents in equivalence_dict.items():
        for pred in equivalents:
            lookup[gt, pred] = True
    return lookup


def load_label_similarity_sets(path: str, num_classes: int) -> Dict[str, List[List[int]]]:
    """CSV columns [index, medium, hard] -> per-class distractor lists
    (dataloader.py:170-183)."""
    medium: List[List[int]] = [[] for _ in range(num_classes)]
    hard: List[List[int]] = [[] for _ in range(num_classes)]
    for row in read_csv_rows(path):
        idx = int(row["index"])
        medium[idx] = ast.literal_eval(row["medium"])
        hard[idx] = ast.literal_eval(row["hard"])
    return {"medium": medium, "hard": hard}


def build_similarity_matrices(
    similarity_sets: Dict[str, Sequence[Sequence[int]]], num_classes: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-class lists -> [C, C] bool matrices (row l = similarity set of l).

    Array replacement for the python set unions in model.py:241-247.
    """
    medium = np.zeros((num_classes, num_classes), dtype=bool)
    hard = np.zeros((num_classes, num_classes), dtype=bool)
    for l, members in enumerate(similarity_sets["medium"]):
        for m in members:
            if 0 <= m < num_classes:
                medium[l, m] = True
    for l, members in enumerate(similarity_sets["hard"]):
        for m in members:
            if 0 <= m < num_classes:
                hard[l, m] = True
    return medium, hard


def build_equivalence_class_map(equivalence_tensor: np.ndarray) -> np.ndarray:
    """label -> smallest index of its equivalence class (dataloader.py:191-202).

    Labels with empty rows map to themselves.
    """
    C = equivalence_tensor.shape[0]
    out = np.arange(C, dtype=np.int64)
    any_row = equivalence_tensor.any(axis=1)
    first = equivalence_tensor.argmax(axis=1)
    out[any_row] = first[any_row]
    return out
