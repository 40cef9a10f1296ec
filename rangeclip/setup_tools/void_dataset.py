"""VOID dataset path-list plumbing.

Reference: setup/setup_dataset.py + setup/generate_image_depth_train_files.py
— builds newline-delimited train-file lists pairing image/depth paths by
directory traversal, the input format of the shared data utilities.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from rangeclip.utils.depth_io import read_paths, write_paths


def pair_image_depth_paths(
    image_dir: str, depth_dir: str, extensions=(".png", ".jpg")
) -> List[Tuple[str, str]]:
    """Pairs files with matching stems across image/depth directories."""
    def stems(d):
        return {
            os.path.splitext(f)[0]: os.path.join(d, f)
            for f in sorted(os.listdir(d))
            if os.path.splitext(f)[1].lower() in extensions
        }

    img, dep = stems(image_dir), stems(depth_dir)
    common = sorted(set(img) & set(dep))
    return [(img[s], dep[s]) for s in common]


def generate_image_depth_train_files(
    image_dir: str,
    depth_dir: str,
    image_list_out: str,
    depth_list_out: str,
) -> int:
    """Write paired path-list files; returns the pair count."""
    pairs = pair_image_depth_paths(image_dir, depth_dir)
    write_paths(image_list_out, [p[0] for p in pairs])
    write_paths(depth_list_out, [p[1] for p in pairs])
    return len(pairs)


def subsample_path_lists(
    image_list: str, depth_list: str, every_n: int,
    image_out: Optional[str] = None, depth_out: Optional[str] = None,
) -> int:
    """Keep every n-th pair (dataset thinning)."""
    imgs, deps = read_paths(image_list), read_paths(depth_list)
    assert len(imgs) == len(deps)
    imgs, deps = imgs[::every_n], deps[::every_n]
    write_paths(image_out or image_list, imgs)
    write_paths(depth_out or depth_list, deps)
    return len(imgs)
