"""Inference server: engine micro-batching + HTTP surface."""

import argparse
import http.client
import io
import json
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import jax

from rangeclip.data.synthetic import write_synthetic_dataset


@pytest.mark.slow
def test_serve_end_to_end(tmp_path):
    from rangeclip.cli import serve as serve_mod
    from rangeclip.models.depth_unet import DepthUNetConfig
    from rangeclip.training.checkpoint import CheckpointManager
    from rangeclip.training.optim import make_optimizer
    from rangeclip.training.state import create_train_state

    data = write_synthetic_dataset(str(tmp_path / "d"), n_samples=4,
                                   shape=(32, 32), num_classes=8)
    cfg = DepthUNetConfig(
        encoder_filters=(8, 16, 16, 16, 32), embedding_dim=32,
        use_batch_norm=True,
    )
    state = create_train_state(jax.random.key(0), cfg, make_optimizer(0.0),
                               (2, 32, 32, 1))
    ckpt_dir = str(tmp_path / "ckpt")
    CheckpointManager(ckpt_dir).save(state)

    from rangeclip.models import depth_unet as du_mod

    du_orig = du_mod.DepthUNetConfig

    def small_cfg(**kw):
        kw["encoder_filters"] = (8, 16, 16, 16, 32)
        return du_orig(**kw)

    du_mod.DepthUNetConfig = small_cfg
    try:
        args = argparse.Namespace(
            checkpoint_dir=ckpt_dir, labels_path=data["labels"],
            batch_size=2, height=32, width=32, top_k=5, embedding_dim=32,
            unet_architecture="resnet", bf16=False,
            predict_path="folded",
            clip_checkpoint_path=None, clip_vocab_path=None,
            clip_merges_path=None,
        )
        predict, variables, labels = serve_mod.build_engine(args)
    finally:
        du_mod.DepthUNetConfig = du_orig

    engine = serve_mod.Engine(predict, variables, 2, (32, 32))
    server = ThreadingHTTPServer(
        ("127.0.0.1", 0), serve_mod.make_handler(engine, labels, (32, 32))
    )
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]

    def request(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()

    status, body = request("GET", "/healthz")
    assert status == 200 and json.loads(body)["num_classes"] == 8

    # npy depth upload -> JSON segmentation
    depth = np.random.default_rng(0).random((48, 64)).astype(np.float32) * 5
    buf = io.BytesIO()
    np.save(buf, depth)
    status, body = request("POST", "/segment", buf.getvalue())
    out = json.loads(body)
    assert status == 200 and out["shape"] == [32, 32]
    assert all(name for name in out["classes_present"].values())

    # raw path returns a 32x32 int32 map
    status, body = request("POST", "/segment?raw=1", buf.getvalue())
    assert status == 200 and len(body) == 32 * 32 * 4

    # concurrent clients exercise the micro-batcher
    results = []

    def hit():
        results.append(request("POST", "/segment?raw=1", buf.getvalue())[0])

    threads = [threading.Thread(target=hit) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == [200] * 6

    # malformed body -> 400 with an error message, server stays up
    status, body = request("POST", "/segment", b"garbage")
    assert status == 400 and "error" in json.loads(body)
    assert request("GET", "/stats")[0] == 200

    server.shutdown()


@pytest.mark.slow
def test_serve_engine_data_parallel(tmp_path):
    """--data_parallel engine: batch sharded over 'data', table over
    'model' (parallel/predict.py), same submit/response contract."""
    from rangeclip.cli import serve as serve_mod
    from rangeclip.models.depth_unet import DepthUNetConfig
    from rangeclip.training.checkpoint import CheckpointManager
    from rangeclip.training.optim import make_optimizer
    from rangeclip.training.state import create_train_state

    data = write_synthetic_dataset(str(tmp_path / "d"), n_samples=4,
                                   shape=(32, 32), num_classes=8)
    cfg = DepthUNetConfig(
        encoder_filters=(8, 16, 16, 16, 32), embedding_dim=32,
        use_batch_norm=True,
    )
    state = create_train_state(jax.random.key(0), cfg, make_optimizer(0.0),
                               (4, 32, 32, 1))
    ckpt_dir = str(tmp_path / "ckpt")
    CheckpointManager(ckpt_dir).save(state)

    from rangeclip.models import depth_unet as du_mod

    du_orig = du_mod.DepthUNetConfig

    def small_cfg(**kw):
        kw["encoder_filters"] = (8, 16, 16, 16, 32)
        return du_orig(**kw)

    du_mod.DepthUNetConfig = small_cfg
    try:
        args = argparse.Namespace(
            checkpoint_dir=ckpt_dir, labels_path=data["labels"],
            batch_size=4, height=32, width=32, top_k=3, embedding_dim=32,
            unet_architecture="resnet", bf16=False,
            predict_path="auto", data_parallel=True, model_parallel=2,
            clip_checkpoint_path=None, clip_vocab_path=None,
            clip_merges_path=None,
        )
        predict, variables, labels = serve_mod.build_engine(args)
        args_single = argparse.Namespace(**{**vars(args),
                                            "data_parallel": False,
                                            "model_parallel": 1})
        predict_1, variables_1, _ = serve_mod.build_engine(args_single)
    finally:
        du_mod.DepthUNetConfig = du_orig

    engine = serve_mod.Engine(predict, variables, 4, (32, 32))
    rng = np.random.default_rng(0)
    depth = rng.standard_normal((32, 32)).astype(np.float32)
    topk = engine.submit(depth)
    assert topk.shape == (32, 32, 3)
    assert (topk >= 0).all() and (topk < len(labels)).all()

    # The sharded predict path must return IDENTICAL labels to the
    # single-device engine built from the same checkpoint (exact
    # cross-shard top-k merge; same scoring formulation, fp32).
    engine_1 = serve_mod.Engine(predict_1, variables_1, 4, (32, 32))
    np.testing.assert_array_equal(topk, engine_1.submit(depth))
