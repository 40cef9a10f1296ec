"""Offline data-prep CLI — the reference's ``setup/`` script surface as one
dispatcher (setup/*.py, see SURVEY.md §2.2).

Subcommands:
  similarity-sets   CLIP text self-similarity -> label_similarity_sets.csv
                    (setup/depth_unet/generate_label_similarity_sets.py)
  cleanup-labels    dedupe/lowercase labels, remap label PNGs, frequency CSV
                    (setup/sunrgbd/cleanup_labels.py)
  void-train-files  paired image/depth path lists
                    (setup/generate_image_depth_train_files.py)
  nyu-crops         random crops from NYUv2 .h5 scenes + metadata.csv
                    (setup/nyu_depth_v2/generate_random_cropped_patches.py)
  nyu-labeled       per-object crops from the labeled NYUv2 .mat
                    (setup/nyu_depth_v2/generate_cropped_patches_nyu.py)
  combine-metadata  merge metadata CSVs (setup/nyu_depth_v2/combine_csv_files.py)
  remove-small      prune classes with < N patches (setup/remove_small_classes.py)
  pseudo-gt         cross-class NMS over detection files -> cls x y w h conf
                    txt (setup/generate_pseudo_ground_truth.py).  Detections
                    come from any detector dump (--detections_glob), or run
                    the reference's own YOLO-World detection stage here with
                    --images_glob when ultralytics + local weights are
                    available (this framework makes no network calls to
                    fetch them)
"""

from __future__ import annotations

import argparse
import csv
import glob
import os


def cmd_similarity_sets(args) -> None:
    from rangeclip.data.labels import load_candidate_labels
    from rangeclip.models.clip.provider import get_text_provider
    from rangeclip.setup_tools.similarity_sets import (
        generate_label_similarity_sets,
    )

    labels = load_candidate_labels(args.labels_path)
    provider = get_text_provider(
        args.clip_checkpoint_path, args.clip_vocab_path, args.clip_merges_path,
        dim=args.embedding_dim,
    )
    out = generate_label_similarity_sets(
        labels, provider, args.output_csv,
        same_threshold=args.same_threshold,
        hard_range=(args.hard_low, args.hard_high),
        medium_range=(args.medium_low, args.medium_high),
        max_per_set=args.max_per_set,
    )
    print(f"Wrote {out}")


def cmd_cleanup_labels(args) -> None:
    from rangeclip.setup_tools.label_cleanup import cleanup_labels

    with open(args.raw_labels) as f:
        raw = [line.strip() for line in f if line.strip()]
    pngs = sorted(glob.glob(args.label_png_glob))
    clean = cleanup_labels(raw, pngs, args.output_dir, args.labels_csv,
                           args.frequency_csv)
    print(f"{len(clean)} clean labels; {len(pngs)} PNGs remapped to "
          f"{args.output_dir}")


def cmd_void_train_files(args) -> None:
    from rangeclip.setup_tools.void_dataset import (
        generate_image_depth_train_files,
    )

    n = generate_image_depth_train_files(
        args.image_dir, args.depth_dir, args.image_list_out, args.depth_list_out
    )
    print(f"{n} image/depth pairs listed")


def cmd_nyu_crops(args) -> None:
    from rangeclip.setup_tools.nyu import generate_random_cropped_patches_h5

    paths = sorted(glob.glob(args.h5_glob))
    out = generate_random_cropped_patches_h5(
        paths, args.output_dir, n_patches_per_image=args.n_patches,
        min_size=args.min_size, seed=args.seed,
    )
    print(f"Wrote {out} from {len(paths)} scenes")


def cmd_nyu_labeled(args) -> None:
    from rangeclip.setup_tools.nyu import (
        generate_labeled_patches,
        load_nyu_labeled_mat,
    )

    data = load_nyu_labeled_mat(args.mat_path)
    out = generate_labeled_patches(
        data["images"], data["depths"], data["labels"], args.output_dir,
        patch_size=(args.patch_size, args.patch_size),
        bbox_padding=args.bbox_padding,
    )
    print(f"Wrote {out} from {data['images'].shape[0]} labeled scenes")


def cmd_combine_metadata(args) -> None:
    from rangeclip.setup_tools.nyu import combine_metadata_csvs

    out = combine_metadata_csvs(args.inputs, args.output_csv)
    print(f"Wrote {out}")


def cmd_remove_small(args) -> None:
    from rangeclip.setup_tools.patches import (
        remove_small_classes,
        write_metadata_csv,
    )

    with open(args.metadata_csv) as f:
        rows = list(csv.DictReader(f))
    kept = remove_small_classes(rows, args.min_count)
    write_metadata_csv(kept, args.output_csv)
    print(f"{len(rows)} -> {len(kept)} rows (min_count={args.min_count})")


def cmd_pseudo_gt(args) -> None:
    from rangeclip.setup_tools.pseudo_ground_truth import (
        cross_class_nms,
        generate_pseudo_ground_truth,
        read_detection_file,
        ultralytics_detect_fn,
        write_detection_file,
    )

    if bool(args.detections_glob) == bool(args.images_glob):
        raise SystemExit(
            "pseudo-gt needs exactly one of --detections_glob (NMS over "
            "existing detector dumps) or --images_glob (run YOLO-World "
            "detection here)")

    if args.images_glob:
        class_names = None
        if args.classes_json:
            from rangeclip.utils.depth_io import load_vild_categories

            class_names = load_vild_categories(args.classes_json)
        detect_fn = ultralytics_detect_fn(args.yolo_weights, class_names)
        outs = generate_pseudo_ground_truth(
            sorted(glob.glob(args.images_glob)), detect_fn,
            args.output_dir, iou_threshold=args.iou_threshold,
        )
        print(f"YOLO-World detection + NMS over {len(outs)} images "
              f"-> {args.output_dir}")
        return

    os.makedirs(args.output_dir, exist_ok=True)
    n = 0
    for path in sorted(glob.glob(args.detections_glob)):
        dets = read_detection_file(path)
        kept = cross_class_nms(dets, iou_threshold=args.iou_threshold)
        write_detection_file(
            os.path.join(args.output_dir, os.path.basename(path)), kept
        )
        n += 1
    print(f"NMS over {n} detection files -> {args.output_dir}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("similarity-sets")
    s.add_argument("--labels_path", required=True)
    s.add_argument("--output_csv", required=True)
    s.add_argument("--clip_checkpoint_path", default=None)
    s.add_argument("--clip_vocab_path", default=None)
    s.add_argument("--clip_merges_path", default=None)
    s.add_argument("--embedding_dim", type=int, default=512)
    s.add_argument("--same_threshold", type=float, default=0.9)
    s.add_argument("--hard_low", type=float, default=0.8)
    s.add_argument("--hard_high", type=float, default=0.85)
    s.add_argument("--medium_low", type=float, default=0.75)
    s.add_argument("--medium_high", type=float, default=0.8)
    s.add_argument("--max_per_set", type=int, default=50)
    s.set_defaults(fn=cmd_similarity_sets)

    c = sub.add_parser("cleanup-labels")
    c.add_argument("--raw_labels", required=True,
                   help="text file, one raw label per line (1-based order)")
    c.add_argument("--label_png_glob", required=True)
    c.add_argument("--output_dir", required=True)
    c.add_argument("--labels_csv", required=True)
    c.add_argument("--frequency_csv", required=True)
    c.set_defaults(fn=cmd_cleanup_labels)

    v = sub.add_parser("void-train-files")
    v.add_argument("--image_dir", required=True)
    v.add_argument("--depth_dir", required=True)
    v.add_argument("--image_list_out", required=True)
    v.add_argument("--depth_list_out", required=True)
    v.set_defaults(fn=cmd_void_train_files)

    n = sub.add_parser("nyu-crops")
    n.add_argument("--h5_glob", required=True)
    n.add_argument("--output_dir", required=True)
    n.add_argument("--n_patches", type=int, default=8)
    n.add_argument("--min_size", type=int, default=32)
    n.add_argument("--seed", type=int, default=0)
    n.set_defaults(fn=cmd_nyu_crops)

    nl = sub.add_parser("nyu-labeled",
                        help="per-object labeled crops from the NYUv2 "
                        "labeled .mat (generate_cropped_patches_nyu.py)")
    nl.add_argument("--mat_path", required=True)
    nl.add_argument("--output_dir", required=True)
    nl.add_argument("--patch_size", type=int, default=128)
    nl.add_argument("--bbox_padding", type=int, default=20)
    nl.set_defaults(fn=cmd_nyu_labeled)

    m = sub.add_parser("combine-metadata")
    m.add_argument("--inputs", nargs="+", required=True)
    m.add_argument("--output_csv", required=True)
    m.set_defaults(fn=cmd_combine_metadata)

    r = sub.add_parser("remove-small")
    r.add_argument("--metadata_csv", required=True)
    r.add_argument("--output_csv", required=True)
    r.add_argument("--min_count", type=int, default=80)
    r.set_defaults(fn=cmd_remove_small)

    p = sub.add_parser("pseudo-gt")
    p.add_argument("--detections_glob", default=None,
                   help="existing detector dumps to NMS (cls x y w h conf "
                        "txts); alternative to running detection here")
    p.add_argument("--images_glob", default=None,
                   help="run the DETECTION stage itself over these images "
                        "with ultralytics YOLO-World (reference "
                        "setup/generate_pseudo_ground_truth.py:83-147); "
                        "requires ultralytics + local --yolo_weights")
    p.add_argument("--yolo_weights", default="yolov8x-worldv2.pt",
                   help="local YOLO-World .pt for --images_glob")
    p.add_argument("--classes_json", default=None,
                   help="ViLD-format categories JSON for open-vocabulary "
                        "detection (model.set_classes; reference :93-95)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--iou_threshold", type=float, default=0.5)
    p.set_defaults(fn=cmd_pseudo_gt)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
