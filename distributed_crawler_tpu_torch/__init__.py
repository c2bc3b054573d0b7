"""PyTorch/CUDA port of the device half of distributed_crawler_tpu.

The JAX package (`distributed_crawler_tpu`) is the reference this package is
held against; nothing here imports it, or JAX.  Layout mirrors the reference
so each module has an obvious counterpart:

- `ops/` — bucketing/packing (`padding.py`) and attention (`attention.py`,
  whose CUDA kernel lives in `csrc/flash_attention.cu`, built by
  `kernels.py`);
- `models/encoder.py` — the E5/XLM-R `EmbedderClassifier`, dense path;
  `models/from_jax.py` loads the reference's param tree into it;
- `models/whisper.py` — Whisper ASR (log-mel, audio encoder, KV-cached
  greedy decode);
- `models/clustering.py` — k-means (`assign`, `update`, k-means++,
  `fit`);
- `inference/` — tokenizer, `InferenceEngine`, `TPUWorker`, `ASRPipeline`;
- `media/` — the audio chunker and `ASRWorker`;
- `cluster/` — online spherical k-means (`ClusterEngine`) and
  `ClusterWorker`, the consumer of the embedding stream;
- `bus/` — `RecordBatch`, the in-memory bus the workers serve from, and
  the gRPC bus between processes (`bus/grpc_bus.py`, wire-compatible with
  the reference's);
- `utils/` — metrics registry, span tracing, structured logging, device
  timeline, FLOP counts;
- `cli.py`, `config/`, `state/` — the command line of the device modes
  (``python -m distributed_crawler_tpu_torch.cli --mode tpu-worker``),
  its config precedence and the workers' results sink.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(`device.resolve_device`).
"""
