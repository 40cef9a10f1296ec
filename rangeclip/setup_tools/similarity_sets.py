"""Label similarity-set generation from CLIP text self-similarity.

Reference: setup/depth_unet/generate_label_similarity_sets.py —
  * embed every candidate label with the CLIP text tower and compute the
    [C, C] cosine self-similarity (:17-25);
  * thresholds: same >= 0.9, hard in [0.8, 0.85), medium in [0.75, 0.8)
    (:27-32); at most 50 entries per set (:58-59);
  * writes label_similarity_sets.csv with columns
    [index, label, same, medium, hard] — the single source for both the
    equivalence sets and the curriculum distractors.

The embedding pass runs wherever the provider runs (the accelerator for the
real CLIP tower).  Similarity is one [C, D] x [D, C] matmul.
"""

from __future__ import annotations

import csv
from typing import List, Sequence

import numpy as np


def similarity_sets_from_matrix(
    sim: np.ndarray,
    same_threshold: float = 0.9,
    hard_range=(0.8, 0.85),
    medium_range=(0.75, 0.8),
    max_per_set: int = 50,
):
    """-> (same, medium, hard) lists per label index.

    Truncation order matches the reference exactly
    (generate_label_similarity_sets.py:58-59): hard/medium sets are sorted
    ascending by similarity before the ``[:max_per_set]`` cut — the kept 50
    are the *lowest*-similarity members — while ``same`` sets are untruncated
    and stay in index order (:50-52).
    """
    C = sim.shape[0]
    same: List[List[int]] = []
    medium: List[List[int]] = []
    hard: List[List[int]] = []
    for i in range(C):
        row = sim[i].copy()
        row[i] = -np.inf  # exclude self

        def lowest_first(lo: float, hi: float) -> List[int]:
            js = np.where((row >= lo) & (row < hi))[0]
            order = np.argsort(row[js], kind="stable")
            return [int(j) for j in js[order][:max_per_set]]

        same.append([int(j) for j in np.where(row >= same_threshold)[0]])
        hard.append(lowest_first(*hard_range))
        medium.append(lowest_first(*medium_range))
    return same, medium, hard


def generate_label_similarity_sets(
    labels: Sequence[str],
    text_provider,
    output_csv: str,
    same_threshold: float = 0.9,
    hard_range=(0.8, 0.85),
    medium_range=(0.75, 0.8),
    max_per_set: int = 50,
) -> str:
    """Embed labels, threshold the cosine self-similarity, write the CSV.

    ``labels`` should include the index-0 dummy so indices in the CSV align
    with the runtime label space.
    """
    emb = np.asarray(text_provider(list(labels)), np.float32)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    sim = emb @ emb.T

    same, medium, hard = similarity_sets_from_matrix(
        sim, same_threshold, hard_range, medium_range, max_per_set
    )
    with open(output_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "label", "same", "medium", "hard"])
        for i, label in enumerate(labels):
            w.writerow([i, label, str(same[i]), str(medium[i]), str(hard[i])])
    return output_csv
