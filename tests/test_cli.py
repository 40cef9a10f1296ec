"""CLI surface smoke tests: train -> validate -> infer -> benchmark
robustness, chained through the argv entry points the way a user runs them."""

import glob
import os

import numpy as np
import pytest

from rangeclip.data.synthetic import write_synthetic_dataset

RES = 32
EDIM = 32


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data = write_synthetic_dataset(
        str(root / "data"), n_samples=12, shape=(RES, RES), num_classes=8
    )
    return {"root": root, **data}


def _data_flags(ws):
    return [
        "--labeled_metadata_path", ws["metadata"],
        "--labels_path", ws["labels"],
        "--equivalence_dict_path", ws["similarity"],
    ]


@pytest.mark.slow
def test_cli_train_then_validate_then_infer(workspace):
    from rangeclip.cli import benchmark as bench_cli
    from rangeclip.cli import infer as infer_cli
    from rangeclip.cli import train as train_cli
    from rangeclip.cli import validate as validate_cli

    ws = workspace
    ckpt = str(ws["root"] / "ckpt")
    import rangeclip.training.trainer as trainer_mod
    from rangeclip.models.depth_unet import DepthUNetConfig

    orig = DepthUNetConfig

    def small_cfg(**kw):
        kw["encoder_filters"] = (8, 16, 16, 16, 32)
        return orig(**kw)

    trainer_mod.DepthUNetConfig = small_cfg
    try:
        train_cli.main(_data_flags(ws) + [
            "--checkpoint_path", ckpt, "--unet_architecture", "resnet",
            "--batch_size", "2", "--n_height", str(RES), "--n_width", str(RES),
            "--learning_rates", "1e-3", "--learning_schedule", "1",
            "--accumulation_steps", "2", "--embedding_dim", str(EDIM),
            "--n_step_per_summary", "2", "--n_step_per_checkpoint", "2",
            "--validation_start_step", "2", "--max_steps", "2",
        ])
    finally:
        trainer_mod.DepthUNetConfig = orig

    ckpt_dir = os.path.join(ckpt, "checkpoints")
    assert os.path.isdir(ckpt_dir)
    assert os.path.exists(os.path.join(ckpt, "results.txt"))

    # validate CLI restores the checkpoint and reruns metrics; the small
    # encoder patch must match what training used
    from rangeclip.models import depth_unet as du_mod

    du_orig = du_mod.DepthUNetConfig
    du_mod.DepthUNetConfig = small_cfg
    try:
        validate_cli.main(_data_flags(ws) + [
            "--checkpoint_dir", ckpt_dir, "--batch_size", "2",
            "--n_height", str(RES), "--n_width", str(RES),
            "--embedding_dim", str(EDIM),
        ])
    finally:
        du_mod.DepthUNetConfig = du_orig

    # infer CLI streams depth PNGs through the checkpointed model
    out_dir = str(ws["root"] / "out")
    depth_glob = os.path.join(os.path.dirname(ws["metadata"]), "depth_*.png")
    du_mod.DepthUNetConfig = small_cfg
    try:
        infer_cli.main([
            "--checkpoint_dir", ckpt_dir, "--depth_glob", depth_glob,
            "--labels_path", ws["labels"], "--output_dir", out_dir,
            "--batch_size", "4", "--height", str(RES), "--width", str(RES),
            "--embedding_dim", str(EDIM),
        ])
    finally:
        du_mod.DepthUNetConfig = du_orig

    labels_out = glob.glob(os.path.join(out_dir, "*_labels.png"))
    topk_out = glob.glob(os.path.join(out_dir, "*_topk.npy"))
    assert len(labels_out) == 12 and len(topk_out) == 12
    topk = np.load(topk_out[0])
    assert topk.shape == (RES, RES, 5)

    # a corrupt input must fail the CLI (producer error propagates through
    # the pipeline threads) rather than hanging the queue handoff
    bad_dir = ws["root"] / "bad"
    bad_dir.mkdir()
    (bad_dir / "depth_bad.png").write_bytes(b"not a png")
    du_mod.DepthUNetConfig = small_cfg
    try:
        with pytest.raises(Exception):
            infer_cli.main([
                "--checkpoint_dir", ckpt_dir,
                "--depth_glob", str(bad_dir / "depth_*.png"),
                "--labels_path", ws["labels"],
                "--output_dir", str(ws["root"] / "out_bad"),
                "--batch_size", "4", "--height", str(RES),
                "--width", str(RES), "--embedding_dim", str(EDIM),
            ])
    finally:
        du_mod.DepthUNetConfig = du_orig

    # robustness benchmark over the trained checkpoint
    du_mod.DepthUNetConfig = small_cfg
    try:
        bench_cli.main(["robustness"] + _data_flags(ws) + [
            "--checkpoint_dir", ckpt_dir, "--batch_size", "2",
            "--n_height", str(RES), "--n_width", str(RES),
            "--embedding_dim", str(EDIM), "--brightness_levels", "1.0",
        ])
    finally:
        du_mod.DepthUNetConfig = du_orig


def test_cli_train_rejects_mismatched_schedule(workspace):
    from rangeclip.cli import train as train_cli

    with pytest.raises(AssertionError, match="learning rates and schedule"):
        train_cli.main(_data_flags(workspace) + [
            "--checkpoint_path", str(workspace["root"] / "x"),
            "--unet_architecture", "resnet",
            "--learning_rates", "1e-3", "1e-4", "--learning_schedule", "1",
        ])


def test_cli_convert_roundtrip(tmp_path):
    """convert: checkpoint -> reference .pth -> checkpoint preserves every weight,
    BN statistic, and the train step."""
    pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from rangeclip.cli import convert as convert_cli
    from rangeclip.models.depth_unet import DepthUNetConfig
    from rangeclip.training.checkpoint import CheckpointManager
    from rangeclip.training.optim import make_optimizer
    from rangeclip.training.state import create_train_state

    cfg = DepthUNetConfig(encoder_filters=(8, 16, 16, 16, 32),
                          embedding_dim=EDIM, use_batch_norm=True)
    state = create_train_state(
        jax.random.key(3), cfg, make_optimizer(0.0), (1, RES, RES, 1)
    ).replace(step=jnp.int32(7))
    src = str(tmp_path / "src" / "checkpoints")
    mgr = CheckpointManager(src)
    mgr.save(state)
    mgr.close()

    model_flags = [
        "--embedding_dim", str(EDIM),
        "--encoder_filters", "8", "16", "16", "16", "32",
        "--n_height", str(RES), "--n_width", str(RES),
    ]
    pth = str(tmp_path / "exported.pth")
    convert_cli.main(["--checkpoint_dir", src, "--to_pth", pth] + model_flags)
    convert_cli.main(["--from_pth", pth,
                      "--checkpoint_path", str(tmp_path / "imported")]
                     + model_flags)

    template = create_train_state(
        jax.random.key(4), cfg, make_optimizer(0.0), (1, RES, RES, 1))
    back = CheckpointManager(
        str(tmp_path / "imported" / "checkpoints")).restore(template)
    assert int(back.step) == 7
    for a, b in zip(jax.tree.leaves(state.params),
                    jax.tree.leaves(back.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(state.batch_stats),
                    jax.tree.leaves(back.batch_stats)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cli_convert_exports_any_optimizer_config(tmp_path):
    """Export must not depend on the training run's optimizer structure:
    a weight-decay + frozen-encoder checkpoint (multi_transform-wrapped
    opt_state) exports via the raw weights-only restore."""
    pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp
    import torch

    from rangeclip.cli import convert as convert_cli
    from rangeclip.models.depth_unet import DepthUNetConfig
    from rangeclip.training.checkpoint import CheckpointManager
    from rangeclip.training.optim import make_optimizer
    from rangeclip.training.state import create_train_state

    cfg = DepthUNetConfig(encoder_filters=(8, 16, 16, 16, 32),
                          embedding_dim=EDIM, use_batch_norm=True)
    state = create_train_state(
        jax.random.key(3), cfg,
        make_optimizer(1e-4, freeze_encoder=True), (1, RES, RES, 1)
    ).replace(step=jnp.int32(5))
    src = str(tmp_path / "src" / "checkpoints")
    mgr = CheckpointManager(src)
    mgr.save(state)
    mgr.close()

    pth = str(tmp_path / "exported.pth")
    convert_cli.main(["--checkpoint_dir", src, "--to_pth", pth])
    ckpt = torch.load(pth, map_location="cpu", weights_only=False)
    assert ckpt["train_step"] == 5
    assert "encoder" in ckpt and "decoder" in ckpt


def test_cli_export_stablehlo_roundtrip(workspace, tmp_path):
    """export: serialize the predict program (jax.export StableHLO),
    deserialize, and require bit-identical labels vs the live function
    (--verify does the comparison in-process).  Covers both signatures:
    text table as runtime input, and baked in from a labels CSV."""
    import json

    from rangeclip.cli import export as export_cli

    small = ["--encoder_filters", "8", "16", "16", "16", "32",
             "--embedding_dim", str(EDIM), "--batch_size", "2",
             "--height", str(RES), "--width", str(RES), "--top_k", "3"]

    out = str(tmp_path / "open_vocab.stablehlo")
    export_cli.main([
        "--init_random", "--num_classes", "12", "--text_as_input",
        "--output", out, "--portable", "--verify",
    ] + small)
    assert os.path.getsize(out) > 0
    with open(out + ".json") as f:
        sidecar = json.load(f)
    assert sidecar["num_classes"] == 12 and sidecar["text_as_input"]
    assert sorted(p.lower() for p in sidecar["platforms"]) == ["cpu", "cuda"]
    assert sidecar["inputs"][1]["shape"] == [12, EDIM]

    baked = str(tmp_path / "baked.stablehlo")
    export_cli.main([
        "--init_random", "--labels_path", workspace["labels"],
        "--output", baked, "--verify",
    ] + small)
    with open(baked + ".json") as f:
        sidecar = json.load(f)
    assert not sidecar["text_as_input"]
    assert len(sidecar["inputs"]) == 1


def test_cli_convert_rejects_mismatched_model(tmp_path):
    pytest.importorskip("torch")
    import jax
    from rangeclip.cli import convert as convert_cli
    from rangeclip.models.torch_interop import save_reference_checkpoint
    from rangeclip.models.depth_unet import DepthUNet, DepthUNetConfig

    cfg = DepthUNetConfig(encoder_filters=(8, 16, 16, 16, 32),
                          embedding_dim=EDIM, use_batch_norm=True)
    variables = DepthUNet(cfg).init(
        jax.random.key(0), np.zeros((1, RES, RES, 1), np.float32), train=False)
    pth = str(tmp_path / "m.pth")
    save_reference_checkpoint(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"]), pth, train_step=1)

    with pytest.raises(SystemExit, match="mismatch|does not match"):
        convert_cli.main([
            "--from_pth", pth, "--checkpoint_path", str(tmp_path / "out"),
            "--embedding_dim", str(EDIM),
            "--encoder_filters", "8", "16", "16", "16", "64",  # wrong widths
            "--n_height", str(RES), "--n_width", str(RES),
        ])
