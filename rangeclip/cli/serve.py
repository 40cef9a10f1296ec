"""Segmentation inference server.

Serves the fused forward+score+top-k program over HTTP for production
deployment (the BASELINE.json streaming-inference config as a daemon
rather than a batch CLI):

  POST /segment     body: 16-bit depth PNG (or float32 .npy)
                    -> JSON {labels: [[top-1 ids]], topk: shape, names: {...}}
  POST /segment?raw=1  -> raw int32 top-1 label map bytes
  GET  /healthz     -> {"status": "ok", "device": ..., "resolution": ...}
  GET  /stats       -> request count + latency percentiles

Design: a single device worker thread owns the jitted predict function and
consumes a bounded queue (requests batch up to --batch_size per device
dispatch — the fixed-shape batch is padded, so the program never
recompiles); HTTP threads only decode/encode.  Depth preprocessing is the
training transform (nearest resize + lower-median normalize, C++ fast path
when built).
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def build_engine(args):
    import jax
    import jax.numpy as jnp

    from rangeclip.data.labels import load_candidate_labels
    from rangeclip.models.clip.provider import get_text_provider
    from rangeclip.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
        folded_is_profitable,
    )
    from rangeclip.training.checkpoint import CheckpointManager
    from rangeclip.training.optim import make_optimizer
    from rangeclip.training.state import create_train_state

    labels = load_candidate_labels(args.labels_path)
    num_classes = len(labels)
    text_provider = get_text_provider(
        args.clip_checkpoint_path, args.clip_vocab_path, args.clip_merges_path,
        dim=args.embedding_dim,
    )
    text_table = jnp.asarray(text_provider(labels), jnp.float32)

    cfg = DepthUNetConfig(
        unet_type=args.unet_architecture, embedding_dim=args.embedding_dim,
        use_batch_norm=True,
        dtype=jnp.bfloat16 if args.bf16 else None,
    )
    model = DepthUNet(cfg)
    template = create_train_state(
        jax.random.key(0), cfg, make_optimizer(0.0),
        (args.batch_size, args.height, args.width, 1),
    )
    state = CheckpointManager(args.checkpoint_dir).restore(template)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    candidate_mask = jnp.ones((num_classes,), bool)

    if getattr(args, "data_parallel", False) and jax.device_count() > 1:
        # Multi-chip serving (parallel/predict.py): batch sharded over
        # 'data', candidate-table rows over 'model' (--model_parallel),
        # exact cross-shard top-k merge — the single-device path's labels,
        # up to the rounding of near-tied scores.
        # --predict_path dispatches per SHARD: 'auto' applies
        # folded_is_profitable to the per-shard slot count (inside
        # make_sharded_predict), so large tables served with a small
        # 'model' degree fall back to the default scoring path exactly
        # like the single-device CLIs.
        from rangeclip.parallel.mesh import make_mesh, replicate
        from rangeclip.parallel.predict import (
            make_sharded_predict,
            pad_class_table,
            shard_predict_inputs,
        )

        n_model = max(1, getattr(args, "model_parallel", 1))
        if n_model > jax.device_count():
            raise SystemExit(
                f"--model_parallel {n_model} exceeds the device count "
                f"{jax.device_count()}"
            )
        n_data = jax.device_count() // n_model
        if args.batch_size % n_data:
            raise SystemExit(
                f"--batch_size {args.batch_size} must divide by the data-"
                f"parallel degree {n_data} (devices={jax.device_count()}, "
                f"--model_parallel {n_model})"
            )
        mesh = make_mesh(n_data=n_data, n_model=n_model)
        table, ids = pad_class_table(text_table, n_model)
        variables = replicate(mesh, variables)
        sharded = make_sharded_predict(model, mesh, top_k=args.top_k,
                                       predict_path=args.predict_path)
        warm = jnp.zeros(
            (args.batch_size, args.height, args.width, 1), jnp.float32
        )
        # table/ids are request-invariant: committed to their mesh
        # placement ONCE here; re-placing a committed array with the same
        # sharding below is a no-op.
        _, table, ids = shard_predict_inputs(mesh, warm, table, ids)

        def predict(variables, depth):
            # single host->shards transfer of the request batch (no
            # intermediate device-0 hop)
            depth_in, table_in, ids_in = shard_predict_inputs(
                mesh, depth, table, ids
            )
            return sharded(variables, depth_in, table_in, ids_in)
        jax.block_until_ready(predict(variables, warm))
        return predict, variables, labels

    @jax.jit
    def predict(variables, depth):
        if args.predict_path == "folded" or (
            args.predict_path == "auto"
            and folded_is_profitable(num_classes, args.embedding_dim)
        ):
            # folded head (predict_folded): identical ranking, faster
            # while the candidate count stays under ~1.5x the embedding
            # dim (folded_is_profitable); bf16 near-ties may round
            # differently
            from rangeclip.models.depth_unet import predict_folded

            return predict_folded(model, variables, depth, text_table,
                                  top_k=args.top_k)
        topk, _, _ = model.apply(
            variables, depth, text_table, candidate_mask, args.top_k,
            method=DepthUNet.predict, return_embeddings=False,
        )
        return topk

    # warm the program once so the first request does not pay the compile
    warm = jnp.zeros((args.batch_size, args.height, args.width, 1), jnp.float32)
    jax.block_until_ready(predict(variables, warm))
    return predict, variables, labels


class Engine:
    """Device worker: drains the queue, micro-batches up to batch_size."""

    def __init__(self, predict, variables, batch_size, size):
        self.predict = predict
        self.variables = variables
        self.batch_size = batch_size
        self.size = size
        self.queue: "queue.Queue" = queue.Queue(maxsize=64)
        self.latencies = []
        self.count = 0
        threading.Thread(target=self._worker, daemon=True).start()

    def submit(self, depth_hw: np.ndarray) -> np.ndarray:
        done = threading.Event()
        slot = {}
        self.queue.put((depth_hw, slot, done))
        done.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["topk"]

    def _complete(self, dev_topk, items, t0):
        try:
            topk = np.asarray(dev_topk)  # device fetch
            for i, (_, slot, done) in enumerate(items):
                slot["topk"] = topk[i]
                done.set()
        except Exception as e:  # surface device errors to the client
            for _, slot, done in items:
                slot["error"] = str(e)
                done.set()
        dt = time.perf_counter() - t0
        self.count += len(items)
        self.latencies.append(dt)
        if len(self.latencies) > 1000:
            del self.latencies[:500]

    def _worker(self):
        # One batch in flight: batch N's device-to-host fetch happens
        # after batch N+1's async dispatch, so under sustained load the
        # copy overlaps the next batch's compute.  When the queue is idle
        # (2 ms poll) the pending batch completes immediately, keeping
        # light-load latency unchanged.
        pending = None  # (device topk, items, t0)
        while True:
            first = None
            if pending is None:
                first = self.queue.get()
            else:
                try:
                    first = self.queue.get(timeout=0.002)
                except queue.Empty:
                    pass
            if first is None:
                self._complete(*pending)
                pending = None
                continue
            items = [first]
            while len(items) < self.batch_size:
                try:
                    items.append(self.queue.get_nowait())
                except queue.Empty:
                    break
            t0 = time.perf_counter()
            try:
                batch = np.zeros(
                    (self.batch_size, *self.size, 1), np.float32
                )
                for i, (d, _, _) in enumerate(items):
                    batch[i, :, :, 0] = d
                dev_topk = self.predict(self.variables, batch)  # async
            except Exception as e:
                for _, slot, done in items:
                    slot["error"] = str(e)
                    done.set()
                continue  # the pending batch is unaffected
            if pending is not None:
                self._complete(*pending)
            pending = (dev_topk, items, t0)


def make_handler(engine: Engine, labels, size):
    from PIL import Image

    from rangeclip.data.transforms import depth_transform

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                import jax

                self._send(200, json.dumps({
                    "status": "ok",
                    "device": str(jax.devices()[0]),
                    "resolution": list(size),
                    "num_classes": len(labels),
                }).encode())
            elif self.path.startswith("/stats"):
                lat = sorted(engine.latencies) or [0.0]
                self._send(200, json.dumps({
                    "requests": engine.count,
                    "p50_ms": round(1e3 * lat[len(lat) // 2], 2),
                    "p95_ms": round(1e3 * lat[int(len(lat) * 0.95)], 2),
                }).encode())
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            if not self.path.startswith("/segment"):
                self._send(404, b'{"error": "not found"}')
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                if raw[:6] == b"\x93NUMPY":
                    depth = np.load(io.BytesIO(raw)).astype(np.float32)
                else:
                    depth = np.asarray(
                        Image.open(io.BytesIO(raw)).convert("I"), np.float32
                    )
                depth = depth_transform(depth, size)
                topk = engine.submit(depth)
                top1 = topk[:, :, 0].astype(np.int32)
                if "raw=1" in (self.path.split("?", 1) + [""])[1]:
                    self._send(200, top1.tobytes(),
                               "application/octet-stream")
                    return
                present = [int(c) for c in np.unique(top1)]
                self._send(200, json.dumps({
                    "shape": list(top1.shape),
                    "top1": top1.tolist(),
                    "classes_present": {
                        str(c): labels[c] for c in present if c < len(labels)
                    },
                }).encode())
            except Exception as e:
                self._send(400, json.dumps({"error": str(e)}).encode())

    return Handler


def main(argv=None) -> None:
    from rangeclip.utils.platform import enable_compilation_cache
    enable_compilation_cache()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint_dir", required=True)
    parser.add_argument("--labels_path", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8477)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--width", type=int, default=256)
    # The /segment responses only ever expose the top-1 label map, and the
    # top-1 of a top-k scoring is the same argmax — so k=1 is the default:
    # the scoring kernel runs 1 selection pass instead of 5 and the
    # device->host fetch shrinks 5x.  Raise it if the API grows a
    # full-top-k response.
    parser.add_argument("--top_k", type=int, default=1)
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard request batches over all devices "
                        "(parallel/predict.py); requires batch_size "
                        "divisible by devices/model_parallel")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="with --data_parallel: shard the candidate "
                        "table over this many devices per batch shard "
                        "(exact cross-shard top-k merge)")
    parser.add_argument("--predict_path",
                        choices=("auto", "folded", "default"),
                        default="auto",
                        help="'folded' contracts the output conv with the "
                        "text table (same ranking, faster for small "
                        "candidate counts); 'default' is the "
                        "reference-parity scoring order; 'auto' folds "
                        "while the class count stays under the measured "
                        "~1.5x-embedding-dim crossover")
    parser.add_argument("--embedding_dim", type=int, default=512)
    parser.add_argument("--unet_architecture", default="resnet")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--clip_checkpoint_path", default=None)
    parser.add_argument("--clip_vocab_path", default=None)
    parser.add_argument("--clip_merges_path", default=None)
    args = parser.parse_args(argv)

    predict, variables, labels = build_engine(args)
    engine = Engine(predict, variables, args.batch_size,
                    (args.height, args.width))
    class Server(ThreadingHTTPServer):
        # Default listen backlog (5) drops connections under bursty
        # clients; the bounded engine queue is the real admission control.
        request_queue_size = 128

    server = Server(
        (args.host, args.port),
        make_handler(engine, labels, (args.height, args.width)),
    )
    print(f"Serving on http://{args.host}:{args.port} "
          f"(batch {args.batch_size} @ {args.height}x{args.width})")
    server.serve_forever()


if __name__ == "__main__":
    main()
