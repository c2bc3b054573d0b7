#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout.  It imports nothing of JAX and nothing of
the JAX package, and fails (exit code != 0, no result printed) when no CUDA
device is visible or when the port's package is not beside it.  Phases, one
JSON line each:

1. device — name, count, torch/CUDA versions, name and power limit;
2. build — nvcc builds every kernel from `distributed_crawler_tpu_torch/
   csrc`, with the compiler's register/shared-memory report;
3. kernel — each kernel against its plain PyTorch version on the card:
   buckets 32-1024, head dims 8-256 (16/32/64 at every bucket; 8, 25, 48,
   80, 128 and 256, and TinyBERT-4L-312D's fused QKV view of 12 heads of
   26), bf16 and f32, padded, packed, fully masked and unmasked rows,
   whole key tiles masked, 8 segments per row, rows not 16-byte aligned;
   each case names the path `choose_path` sends it to (sm90, mma_sync,
   simt) and checks that path's launch count;
4. slice — E5-small at full width (batch 256, random weights from
   ``--seed``) served end to end: RecordBatches published on the in-memory
   bus, through `TPUWorker` (packed, coalescing), results collected from
   the results topic and checked; packed against unpacked; a few rows
   against the same weights in f32 on the CPU; 12 kernel launches per
   device dispatch, every one on the sm90 path;
5. times — per bucket at E5-small batch 256, for the padded shape and the
   packed shape the slice runs: the sm90 kernel, the mma.sync kernel, its
   plain version, `scaled_dot_product_attention` (timed only; the port
   never calls it) and the least time the card could take (bytes, tensor
   operations or exponentials); f32 through the simt kernel (3xTF32: its
   operations bound is three TF32 products, beside the FP32 figure of PRs
   up to 8 as ``bound_fp32_ms``), also at Whisper-small's [B, 1500, 12,
   64], B = 1/2/4/8, beside SDPA in f32; the mma_sync kernel at
   TinyBERT-4L-312D's shape (12 heads of 26, padded and packed); the
   engine's batch time per bucket; the slice's posts/s and p50 batch
   latency;
6. slice.xlmr — a synthetic XLM-R-base classification checkpoint at the
   published widths (HF key names, ``model.safetensors`` in F32, values
   from ``--seed``) written to a temporary directory and served int8
   (``pretrained_dir``, ``quantize="int8"``) through `TPUWorker` as in
   phase 4, the tokenizer falling back to `HashingTokenizer` with its
   warning: 12 sm90 launches per dispatch at head dim 64; int8 and
   ``int8_static`` (calibrated on the card) against bf16 on the same
   weights by minimum cosine (> 0.98, > 0.97); layer 0's four int8
   products against an int32 matmul on the CPU, exactly; the engine and
   forward times per bucket for bf16, int8 and int8_static, the int8
   projections' parts (quantize, int8 product, dequantize) beside the bf16
   products they replace, and the sm90 kernel at XLM-R-base's shape.
7. slice.asr — a synthetic Whisper-small checkpoint at the published
   widths (HF key names, ``model.safetensors`` in F32, values from
   ``--seed``) served bf16 through ``ASRPipeline.from_pretrained`` (window
   buckets 1/2/4/8, each warmed up) and `ASRWorker` (coalescing 2): 12
   generated WAV files of 2-75 s (one 48 kHz stereo) and one file that is
   not a WAV, in 4 AudioBatchMessages on the in-memory bus.  Checks: one
   transcript per file with ceil(duration / 30 s) windows, the non-WAV
   file an error transcript; the tokens equal to `transcribe_files` on the
   dispatch group with the most windows (its windows batched as served;
   phase 11's ``transcribe`` holds every file's tokens against
   `transcribe_files` too) and the writeback rows equal to the published
   messages; 12 sm90 launches per encoder dispatch; the f32 model on the
   card (SIMT kernel) against the CPU on one window; the bf16 greedy tokens
   against the argmax of a plain-attention run's teacher-forced logits,
   near-ties counted.  Times per window bucket (log-mel, encoder,
   cross-K/V, decode in all and per step, achieved TFLOP/s), the sm90
   kernel at [B, 1500, 12, 64] beside its plain version, SDPA and its
   bound, and windows/s and audio-seconds per second through the worker.
8. slice.cluster — E5-large at full width (vocab 250037, hidden 1024, 12
   of its 24 layers for the script's budget, 16 heads of 64, batch 256,
   bf16, random weights from
   ``--seed``) through `TPUWorker` (packed, coalescing 4, embeddings
   published), the in-memory bus and `ClusterWorker` at the CLI's streaming
   defaults (k 16, buckets 64/256, a checkpoint every 8 batches, coalescing
   4): 2048 synthetic posts in 8 RecordBatches.  Checks: one assignment row
   per post with 0 <= cluster < 16; 12 sm90 launches per dispatch; a valid
   ClusterUpdateMessage on ``TOPIC_CLUSTERS``; the served stream replayed
   through a CPU engine loaded from the card engine's state after its first
   step (assignments equal off near-ties, centroids within 1e-4); a stop,
   then a new worker on the same store resumes at the same step, and a
   republished batch is rewritten without being folded again; 32 posts in
   f32 on the CPU against the served bf16 embeddings (minimum cosine
   >= 0.99, labels equal off near-ties); one `fit` step at 65,536 x 1024 x
   k 8 on the card against the CPU.  Times: the cluster step per bucket
   (device by CUDA-graph replay, and the host's share: JSON encode and
   decode, `_extract`, dispatch), `fit` at 1,048,576 x 1024 x k 8 x 25
   iterations, the E5-large forward per bucket, the sm90 kernel at
   E5-large's shape, and posts/s through both workers.
9. slice.moe — Switch-MoE at XLM-R-base width (vocab 250002, hidden 768,
   12 heads of 64, 8 experts of 3072 in every layer, capacity factor
   1.25, 8 labels; ``bench.py``'s MoE configuration at the published
   vocabulary), its depth cut to 6 of 12 layers, added to the engine's
   registry as a deployment adds one, bf16 weights from ``--seed``: 1024
   synthetic posts through `TPUWorker` (packed, coalescing 4) once in each
   of dense, capacity and int8 dispatch on the same weights.  Checks: one
   result per post and 6 sm90 launches per dispatch (one per layer); dense bf16 on the card against f32 on the
   CPU on 32 posts (minimum cosine >= 0.99; the router's choices equal
   off a 1e-3 near-tie margin on the same layer inputs, and counted
   free-running); capacity against dense on the same [256, bucket]
   layouts (capacity factor 8: embeddings within 2e-2; 1.25: the share of
   real tokens dropped per bucket, kept tokens within 2e-2 of dense); one
   served capacity dispatch replayed in f32 on the CPU from the arrays the
   worker dispatched (layer by layer on the card's inputs, and end to end
   over the segments no routing difference touches: minimum cosine >=
   0.99); int8 and ``int8_static`` against bf16 layer by layer on the same
   inputs (MoE outputs > 0.98 / > 0.97; int8's attention > 0.98;
   int8_static's attention against the CPU's, its cosine to bf16
   reported), end to end reported; layer 0's int8 expert products equal
   to an int32 matmul on the CPU; capacity with int8 refused before any
   weight is read.  Times per bucket: each dispatch's forward, FLOPs,
   achieved TFLOP/s and peak memory, XLM-R-base's dense-MLP forward at the
   same depth beside them, layer 0's MoE against the dense MLP (one
   host-timed batch and event loops of 50 ms or one call per bucket);
   posts/s per dispatch.
10. slice.ops — the workers' operations layer at full width: E5-small
   (phase 4's configuration, its engine on the worker's registry) through
   `TPUWorker` with every knob on (``metrics_port``, heartbeats and span
   export every 0.5 s, SLO budgets of 0.001 ms so they breach,
   ``profile_on_slow_ms`` 0.001 so the first slow batch starts a
   torch.profiler capture, ``stall_warn_s`` 30), its result frames folded
   by `ClusterWorker` (k 16, buckets 64/256, its own metrics port), then
   Whisper-small at the published widths (random weights from ``--seed``,
   no checkpoint file) through `ASRWorker` on two generated one-window
   WAVs.  Checks: /healthz; /metrics parsed (``tpu_engine_mfu``,
   ``tpu_engine_bucket_flops`` for every served (bucket, path),
   ``slo_breach_total{slo="batch_p95"}`` >= 1); /status (8 batches);
   /costs (one analytic row per served (bucket, path) with the analytic
   FLOPs, this card's peak); /traces (every batch); /clusters; every
   heartbeat's device memory within the card, an idle beat's within
   64 MiB of ``memory_allocated``; span batches covering every batch; the
   automatic capture's chrome trace naming ``flash_fwd_sm90_kernel`` and a
   /profile capture answering 200; ``stop()`` announcing and ``kill()``
   silent; 12 sm90 launches per dispatch; ``0 < mfu <= 1`` and
   ``mfu_busy <= 1.05`` on the text, cluster and ASR paths; the stall
   watchdog on a step that spins the card with ``torch.cuda._sleep`` (one
   stall counted, exit code 17 at the seam, a ``stall_exit`` bundle).
   Times: posts/s with every knob on against every knob off (alternating,
   five runs each, each run's time inside the engine and the longest wait
   between result frames), MFU per path, the meter's achieved FLOP/s per bucket
   against phase 4's CUDA-event forward, the host cost of one heartbeat
   and one span export.
11. slice.cli — the CLI's device modes (`distributed_crawler_tpu_torch/
   cli.py`) at full width, from its flags and defaults: `_build_tpu_worker`
   (E5-small, buckets 64-512, batch 256, the in-memory bus) serving eight
   batches of 256 posts, its JSONL writeback against the same engine's
   unpacked results (2e-2; labels off a 5e-2 margin); ``python3 -m
   distributed_crawler_tpu_torch.cli --mode tpu-worker`` as a process of
   its own (start to /healthz, /status, /metrics, /costs and /logs, SIGTERM
   giving 130 and a postmortem bundle with a ``logs`` section), which
   where ``grpc`` imports also hosts the broker (``--bus-serve``): the same
   batches published into it through `RemoteBus`, its rows checked as
   before, one heartbeat's card memory read back (a ``cli.grpc`` line
   says which) and the process's own attention launches and dispatches
   read from its /metrics (``attention_kernel_launches_total{path}``);
   ``mode=transcribe`` over phase 7's checkpoint and three of its WAVs
   (the two shortest and the 48 kHz stereo one, plus a non-WAV file
   named ``.wav``) against phase 7's `transcribe_files`; ``mode=cluster`` on 2048 text rows through E5-large
   (k 8, 25 iterations) against `fit` on the same engine's `embed`, and on
   4096 x 1024 embedding rows (seconds split into reading, fitting and
   writing); `_build_asr_worker` and `_build_cluster_worker` at the CLI's
   defaults on one audio batch and on step 1's result stream; and step 6,
   the transcript re-entry: `_build_asr_worker` with ``--infer --bus-serve
   --object-store file://...`` and `_build_tpu_worker` on its broker with
   the same object store, phase 7's four shortest WAVs and its non-WAV
   file in one audio batch, then one of them again.  Checks: one
   transcript per ref read back from the object store; each successful
   transcript's post ``media:<id>`` in ``<storage-root>/<crawl>/smoke/
   posts/posts.jsonl`` equal to the port's `Post(...).to_json()`, none
   for the error file; one result row per re-entered post in the object
   store, within 2e-2 of `engine.run` on the same texts (labels off a
   5e-2 margin); the redelivery stored twice and shipped once; a
   ``media.reentry`` span on each transcript's trace; then ``mode=
   transcribe --infer --bus-address`` into the same broker over two of
   the files, one result row per file (``media:<relpath>``).  Every
   attention launch on sm90: 12 per E5-small or Whisper dispatch, 24 per
   E5-large dispatch.
12. slice.tinybert (run after phase 5) — TinyBERT-4L-312D's published
   widths (huawei-noah/TinyBERT_General_4L_312D: vocab 30522, hidden 312,
   4 layers, 12 heads of 26, MLP 1200), bf16, 8 labels, random weights
   from ``--seed``, `HashingTokenizer`, registered in the engine's
   registry at run time: 2048 synthetic posts through `TPUWorker` at phase
   4's settings.  Checks: one result per post; 4 mma_sync launches per
   dispatch and none elsewhere (head dim 26 and the fused QKV view's
   52-byte head stride are beyond TMA); packed against unpacked within
   2e-2; 32 posts against the same weights in f32 on the CPU (2e-2 / 5e-2,
   labels equal off a 5e-2 near-tie margin).  Times: posts/s, the forward
   per bucket.
13. slice.train (run last) — ``--mode train-head`` through the CLI's
   `main` at XLM-R-base's published widths (phase 6's synthetic HF
   checkpoint, kept for this phase, as ``inference.pretrained_dir``,
   values from ``--seed``, `HashingTokenizer`): 512 posts of 4 classes
   with token-disjoint vocabularies, 8-200 words each, string labels,
   written as the posts and labels JSONL files.  Head scope (20 epochs,
   the CLI's defaults): the feature pass launches `simt` only (12 per
   batch of 32), the loss ends below ln 4, the encoder is saved
   unchanged, ``labels.json`` holds the vocabulary; card f32 features
   against the CPU's on the shortest post of each bucket the feature pass
   uses, in batches of 32 rows as it runs them.  LoRA scope (rank 8, 2 epochs, on the
   first 128 posts): no kernel launch, the merged checkpoint moves the
   kernels and serves.  Full scope (2 epochs on the first 128,
   ``--train-grad-accum 2``, ``--train-state-dir``): stopped after epoch 1
   and resumed, against an uninterrupted run through the CLI's own
   examples, starting weights and full-scope training in the script's
   process (per-epoch losses, weights; `uninterrupted_full_run`), no
   kernel launch; one full step on the card against the CPU from the
   same params and batch (loss, per-leaf gradient cosine).  Serving:
   `_build_tpu_worker` with ``--head-checkpoint`` and
   ``--infer-param-dtype bfloat16`` over 512 held-out posts (12 sm90
   launches per dispatch, nothing else; a row per post with its label
   name; labels equal to the f32 trainer model's off a 5e-2 margin;
   accuracy >= 0.6).  Times: the feature pass (posts/s; by CUDA-graph
   replay of each batch's call, per bucket and summed: `simt`, its plain
   version and SDPA in f32, beside the bound summed over the same calls;
   one batch per bucket held against the plain version), ms per step and
   tokens/s of each scope at batch 16, the full step's TFLOP/s against the
   FP32 and TF32 peaks, peak memory per CLI run, checkpoint bytes and
   seconds (the CLI's own writes and reads), CLI start to the summary
   line, serving posts/s, and the phase's seconds by part.  Its sizes
   are cut for the script's budget (it trained 1024 posts, 256 in the
   LoRA and full scopes, checked 64 features on the CPU and served 2048
   before phase 17 ran the crawl leg).
14. slice.bus (run after phase 11) — the bus's durability and
   partitioning between the CLI's processes (``grpc`` required), phase
   11's eight batches of 256 posts, E5-small at full width behind it.
   (a) A ``--mode bus --bus-spool-dir`` broker (``--bus-max-attempts 2``)
   and a ``--mode tpu-worker --bus-spool-dir`` worker; the batches
   published through ``RemoteBus(outbox=OutboxConfig(...))``; the broker
   SIGKILLed once 2 batches are committed and 2 more are queued or in
   flight, the other 4 published into the outage (buffered, not raised),
   and a new broker started over the same spool and address after 3 s.
   Checks: one writeback row per post, within 2e-2 of phase 11's engine
   (labels equal off a 5e-2 margin); the worker's ``bus_outbox_depth`` 0
   and ``resilience_circuit_state{target="bus"}`` 0, the script's outbox
   empty; 12 sm90 launches per dispatch and none elsewhere, read from the
   worker's /metrics.  (b) A poison frame the worker rejects on every
   delivery: on the broker's ``/dlq`` with 2 attempts and
   ``max_attempts``; listed and inspected by ``python -m
   distributed_crawler_tpu_torch.bus.dlq --spool-dir`` with the broker
   down; ``--replay`` through a new broker generation marks it replayed
   and it is dead-lettered again.  (c) Two broker shards and a worker
   with ``--bus-shard-addresses``; the batches (4 owned by each shard)
   through a `PartitionedBus` with an outbox per shard; shard 0 SIGKILLed
   after 4 are committed: shard 1's share is committed while shard 0's
   parks in its outbox, and after shard 0's restart its parked batches
   are committed in publish order; one row per post as in (a); the
   worker's ``/shards`` names both shards, breakers closed and outboxes
   empty at the end.  Times: the outage, restart to the first batch
   committed, restart to the last row, batches redelivered, posts/s of
   each run beside phase 11's over gRPC.
15. slice.orchestrator (run after phase 14) — ``--mode orchestrator``
   (``grpc`` required) hosting the broker with ``--bus-spool-dir``,
   ``--journal-dir``, ``--max-depth 2``, ``--cluster-serve``, 8 seed
   URLs, ``--infer-backpressure-high 4 --infer-backpressure-low 2`` and
   one alert rule (``fleet_worker_queue_length > 2``), over a ``--mode
   tpu-worker`` (E5-small, phase 11's flags, ``--telemetry-interval 1``)
   and a ``--mode cluster-worker`` (k 16), each a process of its own on
   the card.  Two stand-in crawl workers in this process answer the work
   queue as the reference's crawl `Worker` does on the bus (heartbeats
   with ``worker_type="crawl"``, one `ResultMessage` per item with 4
   children of a seeded tree above depth 2: 8 + 32 + 128 = 168 pages),
   crawling a page at once, and store 24 posts per page (phase 4's texts,
   4,032 in all) through one shared `InferenceBridge` at the CLI's
   defaults (256-post batches, 50 ms deadline); their spans and the
   bridge's go to the collector on the spans topic.  Run A: depth 2's
   posts reach the broker while the tpu-worker is SIGSTOPped; it runs to
   take them in and is stopped again once its next heartbeat, a queue of
   at least 4 batches, has reached the orchestrator, until the valve has
   engaged and the rule fired; then it drains, and depth 2's results are
   sent once the valve has released.  Checks: the crawl completes (every
   page fetched, applied once by the journal's replay, one result row per
   post); the valve engages and releases (``/status``
   ``backpressure_active``, the orchestrator's log); the tpu-worker on
   ``/cluster`` with card memory above 0; ``/dtraces`` with its spans
   moved by the fleet's clock offset and traces joining the
   orchestrator's dispatch span to a crawl worker's; the rule fires and
   resolves, its `AlertMessage`s read off the alerts topic; ``/tenants``
   charging ``default`` chip seconds; a folded cluster guide.  Run B: the
   orchestrator SIGKILLed with 24 results applied and depth 1's other 16
   held (sent into the outage), restarted 3 s later over the same journal
   and spool: ``resumed``, then the same checks of the crawl.  12 sm90
   launches per dispatch and none elsewhere, read from the worker's
   /metrics.  Times: the worker's posts/s over run A's held burst, the
   valve's engaged seconds and the hold's steps, restart to completion,
   the phase's seconds; crawl seconds, pages/s and posts/s end to end,
   which the 5 s distribute tick and the holds set.  Run C
   (slice.random_walk), over the same tpu-worker: ``--mode orchestrator
   --sampling random-walk`` with 8 seed URLs of a seeded `SimNetwork`
   (each seed names 3 channels of its own, one username that does not
   exist and one chat that is not a supergroup), the port's own
   `CrawlWorker` in this process on a pool of one `SimTelegramClient`
   (rate limits off) and a `CompositeStateManager` on a SQLite graph file
   behind an `InferenceBridge`.  The walk stores channel data and no posts
   (the reference's rule), so its next channels, the page buffer's rows,
   are then crawled (channel sampling, 64 posts each) by a `CrawlWorker`
   in this process behind an `InferenceBridge` on a broker the script
   hosts at the phase's address, into the tpu-worker.  Checks: the
   orchestrator exits 0 with metadata ``completed`` and every page
   fetched; each follow-on item a success with its 64 posts; in the
   walk's graph file, per seed, exactly one
   primary edge (forward or walkback), skipped edges for its other new
   channels and one page-buffer row on the primary destination whose
   ``sequence_id`` follows the forward/walkback rule; ``seed_channels``
   holding the network's chat ids of the seeds and the channels found;
   ``invalid_channels`` holding both bad usernames with their reasons;
   the walk's bridge shipping no post; every stored post committed once by
   the tpu-worker, 384 finite floats each; 12 sm90 launches per dispatch
   over run C.  Run D (slice.tandem_walk), over the same tpu-worker: the
   tandem random walk as the reference deploys it, two pods coupled only
   by one SQLite graph file.  Run C's network drawn anew plus a ninth seed
   naming a username that t.me shows as valid but the network does not
   hold (crawling it raises TDLib400Error, so the 400-replacement runs);
   a t.me stand-in on loopback (`http.server`, the fixtures' pages by what
   the network holds) counting its requests; the validator pod, ``--mode
   launch --validate-only`` as a CLI process started at the walk's start
   (the reference's poll intervals, the rate limit off, walkback rate 0);
   the crawler pod, `modes.runner.launch` in this process on run C's pool
   with ``tandem_crawl``, a 15 s ``max_crawl_duration_s`` and a 0.25 s
   page-buffer poll, the seeds in the graph's seed pool.  Once every batch
   completes the validator is stopped by SIGTERM; the channels the walk
   stepped to and fetched are then crawled by a `CrawlWorker` in this
   process behind an `InferenceBridge`, on a broker this script hosts at
   the phase's address.  Checks: the validator exits 130 and made no
   ``access_events`` row; launch's metadata ``completed`` and no batch
   left incomplete; every pending edge's final status the one its page
   gives (the first edge to a name; a later one from the caches: duplicate
   or cached_invalid), read from triggers the script adds to the graph
   file, and one stand-in request per name; every primary forward edge to
   a valid name, neither bad name a primary destination,
   ``invalid_channels`` holding both and the 400 name (``tdlib_400``); the
   400 name's edge gone and a replacement from its source; every
   page-buffer row left on a forward edge's chain or a walkback's new one;
   a forced walkback; no post stored by the walk; every post of the
   follow-on crawl committed once by the tpu-worker as 384 finite floats;
   12 sm90 launches per dispatch over run D.
16. slice.autoscaler (after phase 15, on its machinery) — ``--mode
   orchestrator --autoscaler`` with phase 15's crawl, spool, journal and
   rule, ``--autoscaler-eval-interval 1`` and one pool ``tpu`` of one to
   two E5-small ``tpu-worker`` children of the CLI on the card (phase
   11's flags, ``--telemetry-interval 1``, ``--dump-dir`` per worker id),
   scaled up by the rule, down once ``fleet_worker_queue_length`` has
   averaged under 1 for 10 s (5 s cooldowns).  No worker is started by
   this script: the autoscaler's growth to its minimum spawns
   ``tpu-auto-1``.  Depth 2's posts wait until all of depth 2 is
   dispatched; then ``tpu-auto-1`` is SIGSTOPped while half of them reach
   the broker, takes them in and reports its backlog (phase 15's fill),
   and stays stopped while the rule fires, the autoscaler decides ``up``
   and spawns ``tpu-auto-2``, until that child's first heartbeat; the
   other half then goes, both children drain the burst, the fleet holds
   its headroom, the autoscaler decides ``down`` and retires
   ``tpu-auto-2`` by SIGTERM; depth 2's results go after that, the crawl
   completes and the orchestrator's teardown SIGTERMs ``tpu-auto-1``.
   Checks: every page fetched and applied once and one result row per
   post, none twice, across the retirement; ``/autoscaler`` with decisions
   ``up`` (1 to 2) then ``down`` (2 to 1), desired and actual back at 1,
   no actuation back-off or spawn churn; ``autoscaler_decisions_total``
   up and down at 1 on ``/metrics``; both children retired with exit code
   130 (the orchestrator's log); the retired child offline, not stale, on
   ``/cluster``; both children's card memory on ``/cluster``; each
   child's SIGTERM bundle with 12 sm90 launches per dispatch, none on
   another path, and dispatches past its warm-up.  Times: the rule firing
   to ``up``, ``up`` to the new child's first heartbeat (its start-up on
   the card), each child's and the pair's posts/s over the burst beside
   phase 15's single worker, the drain to ``down``, ``down`` to the
   child's exit, the phase's seconds.

17. slice.loadgen (after phase 16) — the load and chaos gate: ``python -m
   distributed_crawler_tpu_torch.loadgen --scenario <file> --dump-bundle
   <dir>`` as a subprocess on six of the port's scenario files, each with
   its ``engine`` block replaced by E5-small at the port's `EngineConfig`
   defaults (8 labels, batch 256, buckets 32-512, full width and depth)
   and everything else the scenario's own but for flash-crowd's forcing
   queue-wait SLO (150 ms, not 40: E5-small's dispatch is not the tiny
   model's): ``kill-worker`` (gRPC, the worker killed at 1.5 s and
   restarted at 3 s, the burn alerts and ``forbid_lock_cycles``),
   ``flash-crowd`` (the gate's in-process autoscaler under a step to 80
   batches/s of 24 posts), ``asr-steady`` (the gate's tiny f32 Whisper,
   transcripts re-entering E5-small), ``cluster-steady`` (E5-small
   embeddings into `ClusterWorker`), and with the crawl leg (the port's
   `SimNetwork`, connection pool, channel crawl and `CrawlWorker` feeding
   E5-small through an `InferenceBridge`) ``steady-state`` and
   ``kill-orchestrator`` (gRPC, the orchestrator down from 1.2 to 2.4 s,
   then resumed from its journal). Each scenario runs alone but ASR with
   cluster, which run as a pair (`LOADGEN_GROUPS`). Checks: each verdict
   ``pass`` with ``lost`` and ``duplicates`` 0; ``kill-worker`` 2 worker
   generations and a clean lock-witness summary; ``flash-crowd`` an ``up``
   decision in its fault window; ``asr-steady`` every transcript embedded;
   ``cluster-steady`` one assignment per embedded post; ``steady-state`` a
   trace across 2 processes and no scale event; ``kill-orchestrator`` 2
   orchestrator generations, resumed, both pages fetched once, and the kill
   and resume flight events; each run's bundle with sm90 launches (and simt
   for the ASR run's Whisper), none on another path. Times: each run's
   seconds, its verdict's goodput and tail p95s, its sm90 launches, the
   flash crowd's time to converge, and the crawl's pages and seconds until
   fetched (from the bundle's flight events).

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and,
last, ``{"ok": true, "device": {...}}``.  Any failed phase raises and exits
non-zero before that line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "distributed_crawler_tpu_torch"

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# memory bytes/s, f32 FLOP/s outside the tensor cores, and (set in main()
# from the port's `utils/costmodel.PEAK_BF16_FLOPS`, its one home) dense
# bf16 tensor-core FLOP/s.  The card's own power limit is printed beside
# every time.
H100_BYTES_PER_S = 3.35e12
H100_SXM_NAME = "NVIDIA H100 80GB HBM3"
H100_PEAK_FLOPS = {"float32": 67e12}
# Dense TF32 tensor-core FLOP/s of one H100 SXM (NVIDIA data sheet: 989.4
# with sparsity).  The f32 kernel forms each product as three TF32
# products (3xTF32), so its operations bound is 3 x its FLOPs at this rate;
# the f32 rows also give the FP32 figure (H100_PEAK_FLOPS["float32"]) that
# PRs up to 8 used, as ``bound_fp32_ms``.
H100_TF32_FLOPS = 494.7e12
# Exponentials per second in the special function units of one H100 SXM:
# the figure the FlashAttention-3 paper gives (Shah et al. 2024, section
# 3.1: 3.9 TFLOPS of exponential against 989 TFLOPS of bf16 matmul).
H100_EXP_PER_S = 3.9e12

# Kernel against plain version on the card: f32 sums are taken in another
# order (online softmax over key tiles, exp2 with a folded log2(e)); bf16
# rounds p before the PV product relative to a running max, not the final
# one, and rounds the output to bf16 (2^-8 relative).
TOLERANCE = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}

# E5-small's attention shape: 12 heads of 32.
E5_HEADS, E5_HEAD_DIM, BATCH = 12, 32, 256
# TinyBERT-4L-312D's attention: 12 heads of 26 (huawei-noah/
# TinyBERT_General_4L_312D: hidden 312).
TINYBERT_MODEL, TINYBERT_HEADS, TINYBERT_HEAD_DIM = "tinybert_4l_312d", 12, 26
MAIN_BUCKETS = (32, 64, 128, 256, 512)
# Words per synthetic post, one span per bucket: with CLS and SEP a post
# of span i lands in MAIN_BUCKETS[i].
SPANS = ((1, 30), (31, 62), (63, 126), (127, 254), (255, 510))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Fail(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Fail(what)


# -- phase 3 ----------------------------------------------------------------
def _qkv(torch, b, l, h, d, dtype, gen, device, offset=0):
    """q, k, v as strided views of one [b, l, 3, h, d] projection, the
    layout the encoder hands the kernel; ``offset`` elements in front of it
    break the 16-byte alignment of its rows."""
    n = b * l * 3 * h * d
    flat = torch.randn((n + offset,), generator=gen, dtype=torch.float32)
    proj = flat.to(device=device, dtype=dtype)[offset:].view(b, l, 3, h, d)
    return proj[:, :, 0], proj[:, :, 1], proj[:, :, 2]


def _padded_mask(torch, b, l, gen, device, full_rows=(), min_len=1):
    lens = torch.randint(min_len, l + 1, (b,), generator=gen)
    mask = torch.arange(l)[None, :] < lens[:, None]
    for r in full_rows:
        mask[r] = False
    return mask.to(device)


def _packed_segments(torch, b, l, gen, device):
    """Segment ids 1..S laid out contiguously per row, padding 0."""
    seg = torch.zeros((b, l), dtype=torch.int32)
    for r in range(b):
        off, s = 0, 1
        while off < l and s <= 8:
            n = int(torch.randint(1, max(2, l // 3), (1,), generator=gen))
            if off + n > l or torch.rand((1,), generator=gen).item() < 0.1:
                break
            seg[r, off:off + n] = s
            off, s = off + n, s + 1
    return seg.to(device)


def _segments(torch, b, l, n_seg, gen, device):
    """Exactly ``n_seg`` contiguous segments per row at random cuts, then
    padding (segment id 0)."""
    seg = torch.zeros((b, l), dtype=torch.int32)
    for r in range(b):
        cuts = sorted(torch.randperm(l - 1, generator=gen)[:n_seg] + 1)
        bounds = [0] + [int(c) for c in cuts]
        for s in range(n_seg):
            seg[r, bounds[s]:bounds[s + 1]] = s + 1
    return seg.to(device)


def _expected_path(torch, d, dtype, layout):
    if dtype == torch.float32:
        return "simt"
    return ("sm90" if d in (32, 64) and layout in ("aligned", "tinybert")
            else "mma_sync")


def phase_kernel(torch, attention, device, gen):
    cases = []
    for l in (32, 64, 128, 256, 512, 1024):
        for d, dtype in ((32, torch.bfloat16), (64, torch.bfloat16),
                         (32, torch.float32), (64, torch.float32)):
            cases.append((l, d, dtype))
    cases.append((128, 16, torch.float32))
    cases.append((100, 16, torch.bfloat16))  # ragged: L not a tile multiple
    # K/V rows not 16-byte aligned: TMA cannot address them, so bf16 goes
    # to the mma.sync kernel, which stages them with plain loads.
    cases += [(200, 32, torch.bfloat16, "unaligned"),
              (70, 64, torch.float32, "unaligned")]
    # Every head dim up to 256 (rounded up to 16/32/64/128/256 in shared
    # memory; an odd one puts some heads' rows of the fused view on 2-byte
    # boundaries, which take plain 2-byte copies), and TinyBERT-4L-312D's
    # fused QKV view (12 heads of 26: a head stride of 52 bytes).
    for dtype in (torch.bfloat16, torch.float32):
        cases += [(200, d, dtype) for d in (8, 25, 48, 80, 128, 256)]
        cases += [(512, 26, dtype, "tinybert"), (128, 26, dtype, "tinybert")]
    results = []
    worst = dict.fromkeys(attention.PATHS, 0.0)
    for l, d, dtype, *layout in cases:
        layout = (layout or ["aligned"])[0]
        b, h = (2, 4) if l >= 1024 else (3, 4)
        if layout == "tinybert":
            h = TINYBERT_HEADS
        q, k, v = _qkv(torch, b, l, h, d, dtype, gen, device,
                       offset=1 if layout == "unaligned" else 0)
        mask = _padded_mask(torch, b, l, gen, device, full_rows=(b - 1,))
        seg = _packed_segments(torch, b, l, gen, device)
        kinds = [("padded", {"kv_mask": mask}),
                 ("packed", {"kv_mask": seg > 0, "segment_ids": seg}),
                 ("unmasked", {})]
        if l == 512 and (dtype == torch.bfloat16 or layout == "tinybert"):
            # Whole key tiles masked in the middle of every row (not a
            # prefix mask), and packed rows of exactly 8 segments.
            holes = mask.clone()
            holes[:, 64:192] = False
            seg8 = _segments(torch, b, l, 8, gen, device)
            kinds += [("tile_holes", {"kv_mask": holes}),
                      ("packed8", {"kv_mask": seg8 > 0, "segment_ids": seg8})]
        path = _expected_path(torch, d, dtype, layout)
        check(attention.choose_path(q, k, v) == path,
              f"choose_path L={l} d={d} {dtype} {layout}: "
              f"{attention.choose_path(q, k, v)}, expected {path}")
        for kind, kw in kinds:
            before = attention.flash_attention.launches_by_path[path]
            out = attention.flash_attention(q, k, v, **kw)
            ref = attention.attend(q, k, v, **kw)
            torch.cuda.synchronize()
            check(attention.flash_attention.launches_by_path[path]
                  == before + 1, f"no {path} launch counted")
            name = str(dtype).replace("torch.", "")
            atol, rtol = TOLERANCE[name]
            err = (out.float() - ref.float()).abs().max().item()
            ok = bool(torch.allclose(out.float(), ref.float(),
                                     atol=atol, rtol=rtol))
            zeros_ok = True
            if kind == "padded":
                zeros_ok = bool((out[b - 1] == 0).all().item())
            check(out.dtype == q.dtype and out.shape == q.shape,
                  f"kernel output {out.dtype} {tuple(out.shape)}")
            check(bool(torch.isfinite(out.float()).all().item()),
                  f"non-finite kernel output L={l} d={d} {name} {kind}")
            check(ok, f"kernel disagrees with plain: L={l} d={d} {name} "
                      f"{kind} {path} max_abs_err={err} tol=({atol}, {rtol})")
            check(zeros_ok, f"fully masked row not zero: L={l} d={d} {name}")
            worst[path] = max(worst[path], err)
            results.append({"L": l, "head_dim": d, "dtype": name,
                            "rows": kind, "layout": layout, "path": path,
                            "max_abs_err": err,
                            "atol": atol, "rtol": rtol})
    emit("kernel", name="flash_attention", cases=len(results),
         max_abs_err=worst, results=results)
    return worst


# -- phase 5: kernel times --------------------------------------------------
def attention_bound_ms(pairs, b, l, h, d, dtype_name, elem_bytes, has_seg,
                       has_mask=True):
    """The least time of one call, by resource, in ms: bytes (q, k, v and
    out once each, the int32 mask and segment ids where given) over the
    memory rate; the score and PV products of the allowed (query, key)
    pairs over the peak for the type; one exponential per allowed pair
    over the special function units' rate."""
    io_bytes = (4 * b * l * h * d * elem_bytes
                + b * l * 4 * (int(has_mask) + int(has_seg)))
    flops = 4.0 * h * d * pairs
    ops_s = (flops / H100_PEAK_FLOPS[dtype_name] if dtype_name == "bfloat16"
             else 3 * flops / H100_TF32_FLOPS)
    return {"bytes": io_bytes / H100_BYTES_PER_S * 1e3,
            "operations": ops_s * 1e3,
            "exponentials": h * pairs / H100_EXP_PER_S * 1e3}


def fp32_bound_ms(parts, pairs, h, d):
    """The f32 bound by the yardstick of PRs up to 8: the products at
    FP32's 67 TFLOP/s outside the tensor cores."""
    return max(parts["bytes"], parts["exponentials"],
               4.0 * h * d * pairs / H100_PEAK_FLOPS["float32"] * 1e3)


def bound_of(parts):
    """(bound ms, the resource that sets it): the largest part."""
    by = max(parts, key=parts.get)
    return parts[by], by


def _packed_shape(torch, bucket, gen_np, device):
    """BATCH rows of ``bucket`` tokens packed by the port's own
    ``pack_rows`` from the slice's length mix (`synthetic_posts`: words
    uniform in the bucket's span, plus CLS and SEP)."""
    from distributed_crawler_tpu_torch.ops.padding import pack_rows

    lo, hi = SPANS[MAIN_BUCKETS.index(bucket)]
    seqs = []
    while True:
        seqs += [[5] * (int(n) + 2)
                 for n in gen_np.integers(lo, hi + 1, size=BATCH)]
        packed = pack_rows(seqs, bucket)
        if packed.n_rows >= BATCH:
            break
    mask = torch.from_numpy(packed.mask[:BATCH]).to(device)
    seg = torch.from_numpy(packed.segment_ids[:BATCH]).to(device)
    return mask, seg


def _tile_counts(attention, mask, seg):
    """(warpgroup tiles the sm90 kernel computes, candidate tiles): the
    first from `key_tile_plan`, the second what it would compute without
    skipping (every candidate tile, both warpgroups)."""
    b, l = mask.shape
    plan = attention.key_tile_plan(mask, seg, b, l)
    done = sum(bin(bits).count("1") for tiles in plan for _, bits in tiles)
    cand = 0
    t = b * l
    for q0 in range(0, t, attention.SM90_BLOCK_M):
        q1 = min(q0 + attention.SM90_BLOCK_M, t)
        keys = ((q1 - 1) // l + 1 - q0 // l) * l
        n_wg = -(-(q1 - q0) // attention.SM90_WG_ROWS)
        cand += n_wg * -(-keys // attention.SM90_BLOCK_N)
    return done, cand


def _time_bucket(torch, F, attention, q, k, v, mask, seg, err_tag):
    """Every path's time, the plain version's and SDPA's, on one input
    (``mask`` None: no mask, every pair allowed)."""
    from distributed_crawler_tpu_torch.utils import cudatime

    kw = {"kv_mask": mask.to(torch.int32)} if mask is not None else {}
    if seg is not None:
        kw["segment_ids"] = seg
    ref = attention.attend(q, k, v, kv_mask=mask, segment_ids=seg)
    path = attention.choose_path(q, k, v)
    paths = [path] + (["mma_sync"] if path == "sm90" else [])
    times, errs = {}, {}
    atol, rtol = TOLERANCE[str(q.dtype).replace("torch.", "")]
    for p in paths:
        out = attention.flash_attention(q, k, v, path=p, **kw)
        torch.cuda.synchronize()
        errs[p] = (out.float() - ref.float()).abs().max().item()
        check(bool(torch.allclose(out.float(), ref.float(), atol=atol,
                                  rtol=rtol)),
              f"{p} kernel disagrees at {err_tag}: {errs[p]}")
        del out
    del ref
    for p in paths:
        times[p] = cudatime.graph_time_ms(lambda: attention.flash_attention(
            q, k, v, path=p, **kw))
    # The same call issued from Python, wrapper included.
    times["eager"] = cudatime.event_time_ms(lambda: attention.flash_attention(
        q, k, v, **kw))
    times["plain"] = cudatime.event_time_ms(lambda: attention.attend(
        q, k, v, kv_mask=mask, segment_ids=seg), min_iters=3, max_iters=20)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    allow = attention._allowed_mask(mask, seg)
    times["sdpa"] = cudatime.graph_time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allow))
    b, l = q.shape[:2]
    pairs = (int(allow.expand(b, 1, l, l).sum().item()) if allow is not None
             else b * l * l)
    return times, errs, pairs


def phase_kernel_times(torch, np, attention, device, gen, seed, smi):
    """Per bucket at E5-small batch 256: the padded shape (each row's
    length in the top half of its bucket, as serving sees it) and the
    packed shape the slice runs; bf16 through the sm90 and the mma.sync
    kernels, f32 (padded) through the SIMT kernel."""
    import torch.nn.functional as F

    gen_np = np.random.default_rng(seed)
    rows = []
    for l in MAIN_BUCKETS:
        q, k, v = _qkv(torch, BATCH, l, E5_HEADS, E5_HEAD_DIM,
                       torch.bfloat16, gen, device)
        lo = l // 2 + 1 if l > 32 else 1
        padded = (_padded_mask(torch, BATCH, l, gen, device, min_len=lo), None)
        packed = _packed_shape(torch, l, gen_np, device)
        for shape, (mask, seg) in (("padded", padded), ("packed", packed)):
            times, errs, pairs = _time_bucket(
                torch, F, attention, q, k, v, mask, seg, f"{shape} L={l}")
            parts = attention_bound_ms(pairs, BATCH, l, E5_HEADS, E5_HEAD_DIM,
                                       "bfloat16", 2, seg is not None)
            tiles, cand = _tile_counts(attention, mask, seg)
            row = {"bucket": l, "shape": shape, "batch": BATCH,
                   "heads": E5_HEADS, "head_dim": E5_HEAD_DIM,
                   "dtype": "bfloat16", "max_abs_err": errs,
                   "ms": times["sm90"], "mma_sync_ms": times["mma_sync"],
                   "eager_ms": times["eager"],
                   "plain_ms": times["plain"], "library_ms": times["sdpa"],
                   "bound_ms": bound_of(parts)[0],
                   "bound_by": bound_of(parts)[1], "bound_parts_ms": parts,
                   "allowed_pairs": pairs, "sm90_wg_tiles": tiles,
                   "sm90_wg_tiles_without_skipping": cand, "card": smi}
            rows.append(row)
            emit("times.kernel", name="flash_attention", **row)
        # f32 through the SIMT kernel, padded shape.
        mask = padded[0]
        qf, kf, vf = (x.float() for x in (q, k, v))
        times, errs, pairs = _time_bucket(torch, F, attention, qf, kf, vf,
                                          mask, None, f"f32 L={l}")
        parts = attention_bound_ms(pairs, BATCH, l, E5_HEADS, E5_HEAD_DIM,
                                   "float32", 4, False)
        row = {"bucket": l, "shape": "padded", "batch": BATCH,
               "heads": E5_HEADS, "head_dim": E5_HEAD_DIM, "dtype": "float32",
               "max_abs_err": errs, "ms": times["simt"],
               "eager_ms": times["eager"],
               "plain_ms": times["plain"], "library_ms": times["sdpa"],
               "bound_ms": bound_of(parts)[0], "bound_by": bound_of(parts)[1],
               "bound_parts_ms": parts,
               "bound_fp32_ms": fp32_bound_ms(parts, pairs, E5_HEADS,
                                              E5_HEAD_DIM),
               "allowed_pairs": pairs, "card": smi}
        rows.append(row)
        emit("times.kernel", name="flash_attention", **row)
        del q, k, v, qf, kf, vf
        torch.cuda.empty_cache()
    rows += tinybert_kernel_times(torch, F, attention, device, gen, gen_np,
                                  smi)
    for tiny in (False, True):
        f32 = whisper_f32_kernel_times(torch, F, attention, device, gen, smi,
                                       tiny=tiny)
        parts = {p: sum(r["bound_parts_ms"][p] for r in f32)
                 for p in f32[0]["bound_parts_ms"]}
        emit("times.kernel.sum", name="flash_attention",
             model=f32[0]["model"],
             at=f"{f32[0]['heads']} heads of {f32[0]['head_dim']} over "
                f"{f32[0]['seq']} tokens, f32, no mask: one call at each "
                f"of batch {', '.join(str(r['batch']) for r in f32)}, summed",
             ms=sum(r["ms"] for r in f32),
             plain_ms=sum(r["plain_ms"] for r in f32),
             library_ms=sum(r["library_ms"] for r in f32),
             bound_parts_ms=parts, bound_ms=bound_of(parts)[0],
             bound_by=bound_of(parts)[1],
             bound_fp32_ms=sum(r["bound_fp32_ms"] for r in f32),
             max_abs_err=max(r["max_abs_err"]["simt"] for r in f32),
             card=smi)
        rows += f32
    return rows


def tinybert_kernel_times(torch, F, attention, device, gen, gen_np, smi):
    """The mma_sync kernel at TinyBERT-4L-312D's shape per bucket: batch
    256, the fused QKV view of 12 heads of 26, padded and packed as in
    phase 4, beside its plain version, SDPA and the bound."""
    rows = []
    for l in MAIN_BUCKETS:
        q, k, v = _qkv(torch, BATCH, l, TINYBERT_HEADS, TINYBERT_HEAD_DIM,
                       torch.bfloat16, gen, device)
        check(attention.choose_path(q, k, v) == "mma_sync",
              f"TinyBERT shape L={l} goes to "
              f"{attention.choose_path(q, k, v)}")
        lo = l // 2 + 1 if l > 32 else 1
        padded = (_padded_mask(torch, BATCH, l, gen, device, min_len=lo), None)
        packed = _packed_shape(torch, l, gen_np, device)
        for shape, (mask, seg) in (("padded", padded), ("packed", packed)):
            times, errs, pairs = _time_bucket(
                torch, F, attention, q, k, v, mask, seg,
                f"TinyBERT {shape} L={l}")
            parts = attention_bound_ms(pairs, BATCH, l, TINYBERT_HEADS,
                                       TINYBERT_HEAD_DIM, "bfloat16", 2,
                                       seg is not None)
            row = {"model": TINYBERT_MODEL, "bucket": l, "shape": shape,
                   "batch": BATCH, "heads": TINYBERT_HEADS,
                   "head_dim": TINYBERT_HEAD_DIM, "dtype": "bfloat16",
                   "max_abs_err": errs, "ms": times["mma_sync"],
                   "eager_ms": times["eager"], "plain_ms": times["plain"],
                   "library_ms": times["sdpa"],
                   "bound_ms": bound_of(parts)[0],
                   "bound_by": bound_of(parts)[1], "bound_parts_ms": parts,
                   "allowed_pairs": pairs, "card": smi}
            rows.append(row)
            emit("times.kernel", name="flash_attention", **row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


# The load gate's ASR Whisper (`models/whisper.WHISPER_TEST`, f32): its
# encoder attends over 16 audio frames with 4 heads of 8, in dispatch
# groups of 1, 2 or 4 windows (the gate's window buckets).
WHISPER_TEST_SHAPE = (16, 4, 8)
WHISPER_TEST_BATCHES = (1, 2, 4)


def whisper_f32_kernel_times(torch, F, attention, device, gen, smi,
                             tiny=False):
    """The f32 (3xTF32) kernel at Whisper-small's encoder shape
    [B, 1500, 12, 64], B = 1/2/4/8, or with ``tiny`` at the load gate's
    Whisper's [B, 16, 4, 8], B = 1/2/4; no mask, beside its plain version,
    SDPA in f32 and the bound."""
    ctx, heads, head_dim = (WHISPER_TEST_SHAPE if tiny else
                            (WHISPER_CTX, WHISPER_HEADS, WHISPER_HEAD_DIM))
    rows = []
    for b in WHISPER_TEST_BATCHES if tiny else ASR_BUCKETS:
        q, k, v = (torch.randn((b, ctx, heads, head_dim),
                               generator=gen).to(device) for _ in range(3))
        times, errs, pairs = _time_bucket(torch, F, attention, q, k, v, None,
                                          None, f"whisper f32 {ctx} B={b}")
        parts = attention_bound_ms(pairs, b, ctx, heads, head_dim,
                                   "float32", 4, False, has_mask=False)
        row = {"model": "whisper_test" if tiny else "whisper_small",
               "batch": b, "seq": ctx, "heads": heads, "head_dim": head_dim,
               "dtype": "float32", "mask": None, "max_abs_err": errs,
               "ms": times["simt"], "eager_ms": times["eager"],
               "plain_ms": times["plain"], "library_ms": times["sdpa"],
               "bound_ms": bound_of(parts)[0], "bound_by": bound_of(parts)[1],
               "bound_parts_ms": parts,
               "bound_fp32_ms": fp32_bound_ms(parts, pairs, heads, head_dim),
               "allowed_pairs": pairs, "card": smi}
        rows.append(row)
        emit("times.kernel", name="flash_attention", **row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


# -- phase 4: the slice -----------------------------------------------------
_LETTERS = "abcdefghijklmnopqrstuvwxyz"


def synthetic_posts(np, rng, n, start):
    """Posts whose token counts (words + CLS + SEP) spread over all five
    buckets: each word is 3-8 lowercase letters, so it hashes to one id."""
    letters = np.array(list(_LETTERS))
    posts = []
    for i in range(n):
        lo, hi = SPANS[int(rng.integers(len(SPANS)))]
        n_words = int(rng.integers(lo, hi + 1))
        sizes = rng.integers(3, 9, size=n_words)
        chars = letters[rng.integers(0, 26, size=int(sizes.sum()))]
        cuts = np.cumsum(sizes)[:-1]
        words = ["".join(w) for w in np.split(chars, cuts)]
        posts.append({"post_uid": f"p{start + i}", "channel_name": "smoke",
                      "description": " ".join(words)})
    return posts


def serve_batches(np, engine, batches, path="sm90"):
    """The main path: RecordBatches published on the in-memory bus, served
    by `TPUWorker` (packed, coalescing 4), results collected from the
    results topic.  The kernel counts are set to 0 just before and read
    just after; every launch must be on ``path``."""
    from distributed_crawler_tpu_torch.bus import (
        TOPIC_INFERENCE_BATCHES,
        TOPIC_INFERENCE_RESULTS,
        InMemoryBus,
    )
    from distributed_crawler_tpu_torch.inference.worker import (
        TPUWorker,
        TPUWorkerConfig,
    )
    from distributed_crawler_tpu_torch.ops import attention
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    bus = InMemoryBus(sync=False)
    got = []
    bus.subscribe(TOPIC_INFERENCE_RESULTS, got.append)
    worker = TPUWorker(bus, engine, cfg=TPUWorkerConfig(
        worker_id="chip-smoke", pack=True, coalesce_batches=4),
        registry=MetricsRegistry())
    worker.start()
    bus.start()

    attention.flash_attention.launches = 0
    by_path = attention.flash_attention.launches_by_path
    for p in by_path:
        by_path[p] = 0
    dispatches0 = engine.m_latency.count
    lat_n0 = len(engine.m_latency.window())
    t_start = time.perf_counter()
    try:
        for b in batches:
            bus.publish(TOPIC_INFERENCE_BATCHES, b.to_dict())
        deadline = time.monotonic() + 600
        while len(got) < len(batches) and time.monotonic() < deadline:
            time.sleep(0.005)
        t_end = time.perf_counter()
        check(worker.drain(timeout_s=60.0), "worker did not drain")
    finally:
        worker.stop()
        bus.close()
    launches = attention.flash_attention.launches
    launches_by_path = dict(by_path)
    dispatches = engine.m_latency.count - dispatches0
    latencies = sorted(engine.m_latency.window()[lat_n0:])
    n_layers = engine.ecfg.n_layers
    check(len(got) == len(batches),
          f"{len(got)} result frames for {len(batches)} batches")
    check(dispatches > 0, "no device dispatch on the main path")
    check(launches == n_layers * dispatches,
          f"{launches} kernel launches for {dispatches} dispatches "
          f"(expected {n_layers} per dispatch)")
    check(launches_by_path == {p: launches if p == path else 0
                               for p in launches_by_path},
          f"launches by path {launches_by_path}: every one should be {path}")
    status = worker.get_status()
    check(status["processed_batches"] == len(batches)
          and status["error_batches"] == 0, f"worker status {status}")
    emb, scores, labels = check_results(np, engine.ecfg, batches, got)
    return {"emb": emb, "scores": scores, "labels": labels,
            "launches": launches, "launches_by_path": launches_by_path,
            "dispatches": dispatches, "seconds": t_end - t_start,
            "posts_per_s": emb.shape[0] / (t_end - t_start),
            "p50_ms": (latencies[len(latencies) // 2] * 1e3
                       if latencies else None),
            "latencies": len(latencies),
            "coalesced_groups": worker.m_coalesce.count,
            "result_frames": len(got)}


def check_results(np, ecfg, batches, got):
    """Every batch's results present, in order: unit-norm embeddings,
    scores summing to 1, each label the top score."""
    from distributed_crawler_tpu_torch.bus import RecordBatch

    by_id = {}
    for frame in got:
        rb = RecordBatch.from_dict(frame)
        check(rb.batch_id not in by_id, f"duplicate frame {rb.batch_id}")
        by_id[rb.batch_id] = rb
    emb, scores, labels = [], [], []
    for b in batches:
        rb = by_id.get(b.batch_id)
        check(rb is not None, f"no result frame for batch {b.batch_id}")
        check(len(rb.results) == len(b.records),
              f"{len(rb.results)} results for {len(b.records)} records")
        check([r["post_uid"] for r in rb.records]
              == [r["post_uid"] for r in b.records], "records reordered")
        for r in rb.results:
            emb.append(r["embedding"])
            scores.append(r["scores"])
            labels.append(r["label"])
    emb = np.asarray(emb, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels)
    n_posts = emb.shape[0]
    check(emb.shape == (n_posts, ecfg.hidden), f"embeddings {emb.shape}")
    check(bool(np.isfinite(emb).all()), "non-finite embeddings")
    norms = np.linalg.norm(emb, axis=1)
    check(bool(np.allclose(norms, 1.0, atol=1e-3)),
          f"embedding norms in [{norms.min()}, {norms.max()}]")
    check(scores.shape == (n_posts, ecfg.n_labels), f"scores {scores.shape}")
    check(bool(np.allclose(scores.sum(axis=1), 1.0, atol=1e-5)),
          "scores do not sum to 1")
    check(bool(((labels >= 0) & (labels < ecfg.n_labels)).all()),
          "labels out of range")
    check(bool((labels == scores.argmax(axis=1)).all()),
          "label is not the top score")
    return emb, scores, labels


def check_packed_vs_unpacked(np, engine, batches, served):
    """The same token lists unpacked, against the packed results: within
    2e-2, and equal labels where the top score is clear."""
    from distributed_crawler_tpu_torch.ops.padding import bucket_for

    texts = [t for b in batches for t in b.texts()]
    toks = engine.tokenizer.encode_batch(texts)
    check({bucket_for(len(t), engine.bucket_spec) for t in toks}
          == set(MAIN_BUCKETS), "posts do not cover all five buckets")
    unpacked = engine.run_tokenized(toks, pack=False)
    u_emb = np.asarray([r["embedding"] for r in unpacked])
    u_scores = np.asarray([r["scores"] for r in unpacked])
    emb_err = float(np.abs(u_emb - served["emb"]).max())
    score_err = float(np.abs(u_scores - served["scores"]).max())
    # bf16 activations through 12 layers: packing changes the key tiles
    # and the GEMM row blocks each sequence meets, so sums round in another
    # order; the embedding is unit-norm with entries ~0.05.
    pack_tol = 2e-2
    check(emb_err <= pack_tol and score_err <= pack_tol,
          f"packed vs unpacked: emb {emb_err}, scores {score_err}, "
          f"tol {pack_tol}")
    top2 = np.sort(u_scores, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * pack_tol
    check(bool((served["labels"][clear]
                == u_scores.argmax(axis=1)[clear]).all()),
          "packed and unpacked labels differ where the top score is clear")
    return toks, u_emb, {"emb_max_abs_err": emb_err,
                         "scores_max_abs_err": score_err, "tol": pack_tol}


def time_engine(torch, engine, smi, quick=False, **tags):
    """Engine batch time per bucket, unpacked, a full batch of one bucket:
    the host clock around run_tokenized, its stage spans (host time of
    each stage), and the model's forward alone timed with CUDA events.
    ``quick`` (an engine already warm at every bucket): no warm-up call,
    one host-timed call, and CUDA-event loops of at least 50 ms or one
    call, where the default warms up, times three calls and loops for at
    least 200 ms and three calls."""
    reps, min_total_s, min_iters = (1, 0.05, 1) if quick else (3, 0.2, 3)
    from distributed_crawler_tpu_torch.ops.padding import pack_batch
    from distributed_crawler_tpu_torch.utils import cudatime, trace
    from distributed_crawler_tpu_torch.utils.costmodel import (
        encoder_forward_flops,
    )

    rows = []
    for bucket in MAIN_BUCKETS:
        n_tok = bucket - 1
        batch_toks = [[5 + (j % 1000)] * n_tok for j in range(BATCH)]
        if not quick:
            engine.run_tokenized(batch_toks)
            torch.cuda.synchronize()
        trace.TRACER.reset()
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.run_tokenized(batch_toks)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        stages = {}
        for s in trace.TRACER.spans():
            if s.name.startswith("engine.") and \
                    s.name != "engine.run_tokenized":
                stages[s.name] = stages.get(s.name, 0.0) \
                    + s.duration_s * 1e3 / reps
        ids, mask = pack_batch(batch_toks, engine.bucket_spec)
        ids_d = torch.from_numpy(ids).to(engine.device)
        mask_d = torch.from_numpy(mask).to(engine.device)
        with torch.inference_mode():
            forward_ms = cudatime.event_time_ms(
                lambda: engine.model(ids_d, mask_d),
                min_total_s=min_total_s, min_iters=min_iters, max_iters=20)
        flops = encoder_forward_flops(engine.ecfg, BATCH, bucket)
        row = {**tags, "bucket": bucket, "batch": BATCH, "batch_ms": ms,
               "forward_ms": forward_ms, "host_stage_ms": stages,
               "model_tflop_per_s": flops / (ms * 1e-3) / 1e12, "card": smi}
        rows.append(row)
        emit("times.engine", **row)
    return rows


def phase_slice(torch, np, seed, smi):
    from distributed_crawler_tpu_torch.bus import RecordBatch
    from distributed_crawler_tpu_torch.inference.engine import (
        EngineConfig,
        InferenceEngine,
    )
    from distributed_crawler_tpu_torch.models.encoder import (
        EmbedderClassifier,
    )
    from distributed_crawler_tpu_torch.ops.padding import pack_batch
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    t0 = time.perf_counter()
    cfg = EngineConfig(model="e5_small", batch_size=BATCH, seed=seed)
    engine = InferenceEngine(cfg, registry=MetricsRegistry())
    ecfg = engine.ecfg
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    check((ecfg.vocab_size, ecfg.hidden, ecfg.n_layers, ecfg.n_heads,
           ecfg.mlp_dim, ecfg.n_labels) == (250037, 384, 12, 12, 1536, 8),
          f"not E5-small's full width: {ecfg}")
    check(engine.bucket_spec.lengths == MAIN_BUCKETS,
          f"buckets {engine.bucket_spec.lengths}")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.warmup()  # both paths, every bucket
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    emit("slice.setup", model=cfg.model, batch=BATCH,
         buckets=list(MAIN_BUCKETS), engine_init_s=build_s,
         warmup_s=warm_s, programs=engine.compile_cache_stats())

    rng = np.random.default_rng(seed)
    n_batches = 8
    batches = [RecordBatch.from_records(
        synthetic_posts(np, rng, BATCH, i * BATCH), crawl_id="smoke")
        for i in range(n_batches)]
    served = serve_batches(np, engine, batches)
    emb, scores = served["emb"], served["scores"]
    n_posts = emb.shape[0]
    toks, _, pack_err = check_packed_vs_unpacked(np, engine, batches, served)

    # A few rows against the same weights in f32 on the CPU (plain
    # attention): the card's bf16 path against an f32 reference.
    pick = [int(i) for i in rng.choice(n_posts, size=8, replace=False)]
    cpu_model = EmbedderClassifier(replace(ecfg, dtype="float32"))
    state = {k: v.float().cpu() for k, v in engine.model.state_dict().items()}
    cpu_model.load_state_dict(state)
    cpu_model.eval()
    ids, mask = pack_batch([toks[i] for i in pick],
                           engine.bucket_spec)
    with torch.inference_mode():
        c_emb, c_logits = cpu_model(torch.from_numpy(ids),
                                    torch.from_numpy(mask))
    c_scores = torch.softmax(c_logits.double(), dim=-1).numpy()
    cpu_emb_err = float(np.abs(c_emb.double().numpy() - emb[pick]).max())
    cpu_score_err = float(np.abs(c_scores - scores[pick]).max())
    cos = float(np.min(np.sum(c_emb.double().numpy() * emb[pick], axis=1)))
    cpu_tol_emb, cpu_tol_scores = 2e-2, 5e-2
    check(cpu_emb_err <= cpu_tol_emb and cpu_score_err <= cpu_tol_scores,
          f"card bf16 vs CPU f32: emb {cpu_emb_err} (tol {cpu_tol_emb}), "
          f"scores {cpu_score_err} (tol {cpu_tol_scores})")
    emit("slice", records=n_posts, batches=n_batches,
         result_frames=served["result_frames"],
         dispatches=served["dispatches"], kernel_launches=served["launches"],
         kernel_launches_by_path=served["launches_by_path"],
         launches_per_dispatch=served["launches"] / served["dispatches"],
         coalesced_groups=served["coalesced_groups"],
         packed_vs_unpacked=pack_err,
         card_bf16_vs_cpu_f32={"rows": len(pick),
                               "emb_max_abs_err": cpu_emb_err,
                               "scores_max_abs_err": cpu_score_err,
                               "min_cosine": cos,
                               "tol_emb": cpu_tol_emb,
                               "tol_scores": cpu_tol_scores})
    emit("times.slice", model=cfg.model, posts=n_posts,
         seconds=served["seconds"], posts_per_s=served["posts_per_s"],
         p50_batch_latency_ms=served["p50_ms"],
         dispatch_latencies=served["latencies"], card=smi)
    engine_rows = time_engine(torch, engine, smi, model=cfg.model)
    return {"launches": served["launches_by_path"],
            "dispatches": served["dispatches"], "engine_rows": engine_rows,
            "posts_per_s": served["posts_per_s"]}


# -- phase 12: TinyBERT-4L-312D's widths (head dim 26) on the card --------
# A post whose f32 top-two scores are within this is a near-tie: bf16 may
# rank either first.
TINYBERT_NEAR_TIE = 5e-2
TINYBERT_CPU_POSTS = 32


def tinybert_config():
    """huawei-noah/TinyBERT_General_4L_312D's published widths; bf16."""
    from distributed_crawler_tpu_torch.models.encoder import EncoderConfig

    return EncoderConfig(vocab_size=30522, hidden=312, n_layers=4,
                         n_heads=12, mlp_dim=1200, max_len=512)


def phase_tinybert(torch, np, seed, smi):
    """TinyBERT-4L-312D's widths (random weights from ``seed``,
    `HashingTokenizer`) registered as a deployment registers a model, and
    2048 posts served through `TPUWorker` as in phase 4: every attention
    launch on the mma_sync kernel (its head dim of 26 and the fused QKV
    view's 52-byte head stride are beyond TMA), 4 per dispatch; packed
    against unpacked; 32 posts on the card in bf16 against the same weights
    in f32 on the CPU; posts/s and the forward per bucket."""
    from distributed_crawler_tpu_torch.bus import RecordBatch
    from distributed_crawler_tpu_torch.inference import engine as engine_mod
    from distributed_crawler_tpu_torch.ops.padding import pack_batch
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    engine_mod.MODEL_REGISTRY[TINYBERT_MODEL] = tinybert_config()
    t0 = time.perf_counter()
    engine = engine_mod.InferenceEngine(engine_mod.EngineConfig(
        model=TINYBERT_MODEL, batch_size=BATCH, seed=seed),
        registry=MetricsRegistry())
    ecfg = engine.ecfg
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    check((ecfg.vocab_size, ecfg.hidden, ecfg.n_layers, ecfg.n_heads,
           ecfg.mlp_dim, ecfg.n_labels, ecfg.dtype, ecfg.head_dim)
          == (30522, 312, 4, 12, 1200, 8, "bfloat16", 26),
          f"not TinyBERT-4L-312D's width: {ecfg}")
    check(engine.bucket_spec.lengths == MAIN_BUCKETS,
          f"buckets {engine.bucket_spec.lengths}")
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    emit("slice.tinybert.setup", model=TINYBERT_MODEL, batch=BATCH,
         buckets=list(MAIN_BUCKETS), engine_init_s=init_s,
         warmup_s=time.perf_counter() - t0)

    rng = np.random.default_rng(seed + 12)
    batches = [RecordBatch.from_records(
        synthetic_posts(np, rng, BATCH, i * BATCH), crawl_id="smoke-tiny")
        for i in range(8)]
    served = serve_batches(np, engine, batches, path="mma_sync")
    toks, _, pack_err = check_packed_vs_unpacked(np, engine, batches, served)

    # Posts on the card in bf16 against the same weights in f32 on the
    # CPU (plain attention), at phase 4's tolerances.
    n_posts = served["emb"].shape[0]
    pick = [int(i) for i in rng.choice(n_posts, size=TINYBERT_CPU_POSTS,
                                       replace=False)]
    cpu_model = _cpu_twin(torch, engine)
    ids, mask = pack_batch([toks[i] for i in pick], engine.bucket_spec)
    with torch.inference_mode():
        c_emb, c_logits = cpu_model(torch.from_numpy(ids),
                                    torch.from_numpy(mask))
    c_emb = c_emb.double().numpy()
    c_scores = torch.softmax(c_logits.double(), dim=-1).numpy()
    emb_err = float(np.abs(c_emb - served["emb"][pick]).max())
    score_err = float(np.abs(c_scores - served["scores"][pick]).max())
    tol_emb, tol_scores = 2e-2, 5e-2
    check(emb_err <= tol_emb and score_err <= tol_scores,
          f"TinyBERT card bf16 vs CPU f32: emb {emb_err} (tol {tol_emb}), "
          f"scores {score_err} (tol {tol_scores})")
    clear = _top2_gap(np, -c_scores) > TINYBERT_NEAR_TIE
    check(bool((served["labels"][pick][clear]
                == c_scores.argmax(axis=1)[clear]).all()),
          "TinyBERT labels differ from the CPU's where the top score is "
          "clear")
    emit("slice.tinybert", records=n_posts, batches=len(batches),
         dispatches=served["dispatches"], kernel_launches=served["launches"],
         kernel_launches_by_path=served["launches_by_path"],
         launches_per_dispatch=served["launches"] / served["dispatches"],
         packed_vs_unpacked=pack_err,
         card_bf16_vs_cpu_f32={"posts": len(pick), "emb_max_abs_err": emb_err,
                               "scores_max_abs_err": score_err,
                               "tol_emb": tol_emb, "tol_scores": tol_scores,
                               "labels_compared": int(clear.sum()),
                               "near_tie": TINYBERT_NEAR_TIE})
    emit("times.slice", model=TINYBERT_MODEL, posts=n_posts,
         seconds=served["seconds"], posts_per_s=served["posts_per_s"],
         p50_batch_latency_ms=served["p50_ms"], card=smi)
    time_engine(torch, engine, smi, model=TINYBERT_MODEL)
    del engine, cpu_model
    torch.cuda.empty_cache()
    return {"launches": served["launches_by_path"],
            "posts_per_s": served["posts_per_s"]}


# -- phase 6: XLM-R-base from a local HF checkpoint, int8 -------------------
# BASELINE config #3's published widths (xlm-roberta-base's config.json),
# with a 4-way classification head.
XLMR_HF_CONFIG = {
    "architectures": ["XLMRobertaForSequenceClassification"],
    "model_type": "xlm-roberta", "vocab_size": 250002, "hidden_size": 768,
    "num_hidden_layers": 12, "num_attention_heads": 12,
    "intermediate_size": 3072, "max_position_embeddings": 514,
    "type_vocab_size": 1, "layer_norm_eps": 1e-5, "hidden_act": "gelu",
    "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2,
    "id2label": {str(i): f"LABEL_{i}" for i in range(4)},
}
XLMR_HEADS, XLMR_HEAD_DIM, XLMR_LABELS = 12, 64, 4


def write_safetensors(path, tensors):
    """A ``.safetensors`` file of F32 tensors: the u64 header length, the
    JSON header (padded to 8 bytes, as the format's writer pads it), then
    each tensor's bytes in order."""
    header, off = {}, 0
    for name, a in tensors:
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [off, off + a.nbytes]}
        off += a.nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for _, a in tensors:
            f.write(a.astype("<f4", copy=False).tobytes())


def xlmr_state(np, seed):
    """HF ``XLMRobertaForSequenceClassification`` key names and shapes,
    values from ``default_rng(seed)`` at std 0.02 (LayerNorm scales
    around 1)."""
    rng = np.random.default_rng(seed)
    c = XLMR_HF_CONFIG
    h, ff = c["hidden_size"], c["intermediate_size"]

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def ln(prefix):
        return [(f"{prefix}.weight", 1 + w(h)), (f"{prefix}.bias", w(h))]

    e = "roberta.embeddings"
    out = [(f"{e}.word_embeddings.weight", w(c["vocab_size"], h)),
           (f"{e}.position_embeddings.weight",
            w(c["max_position_embeddings"], h)),
           (f"{e}.token_type_embeddings.weight", w(c["type_vocab_size"], h))]
    out += ln(f"{e}.LayerNorm")
    for i in range(c["num_hidden_layers"]):
        b = f"roberta.encoder.layer.{i}"
        for proj in ("query", "key", "value"):
            out += [(f"{b}.attention.self.{proj}.weight", w(h, h)),
                    (f"{b}.attention.self.{proj}.bias", w(h))]
        out += [(f"{b}.attention.output.dense.weight", w(h, h)),
                (f"{b}.attention.output.dense.bias", w(h))]
        out += ln(f"{b}.attention.output.LayerNorm")
        out += [(f"{b}.intermediate.dense.weight", w(ff, h)),
                (f"{b}.intermediate.dense.bias", w(ff)),
                (f"{b}.output.dense.weight", w(h, ff)),
                (f"{b}.output.dense.bias", w(h))]
        out += ln(f"{b}.output.LayerNorm")
    out += [("classifier.dense.weight", w(h, h)),
            ("classifier.dense.bias", w(h)),
            ("classifier.out_proj.weight", w(XLMR_LABELS, h)),
            ("classifier.out_proj.bias", w(XLMR_LABELS))]
    return out


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _cosines(np, a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1)
                                    * np.linalg.norm(b, axis=1))


def _min_cosine(np, a, b):
    return float(_cosines(np, a, b).min())


def check_int8_products(torch, engine, gen):
    """Layer 0's four int8 products on the card against an int32 matmul
    on the CPU, on 64 rows of quantized activations: exactly equal."""
    from distributed_crawler_tpu_torch.ops.quant import (
        int8_matmul,
        quantize_activations,
    )

    layer = engine.model.encoder.layers[0]
    out = {}
    for name, mod in (("qkv", layer.attn.qkv),
                      ("attn_out", layer.attn.attn_out),
                      ("mlp_up", layer.mlp.mlp_up),
                      ("mlp_down", layer.mlp.mlp_down)):
        w_q = mod.kernel_q
        x = torch.randn((64, w_q.shape[1]), generator=gen).to(
            device=engine.device, dtype=torch.bfloat16)
        x_q, _ = quantize_activations(x)
        acc = int8_matmul(x_q, w_q)
        torch.cuda.synchronize()
        want = x_q.cpu().to(torch.int32) @ w_q.cpu().to(torch.int32).t()
        check(acc.dtype == torch.int32 and torch.equal(acc.cpu(), want),
              f"int8 product {name}: card and CPU int32 matmul differ")
        out[name] = {"m": 64, "k": int(w_q.shape[1]), "n": int(w_q.shape[0]),
                     "equal": True}
    return out


def time_int8_parts(torch, engine, smi):
    """The int8 projections' parts at each bucket, summed over one layer's
    four projections (layer 0's weights) and times 12 layers: the dynamic
    per-token quantization, the int8 products, the dequantization, and
    the bf16 products (with their bias adds) they replace."""
    import torch.nn.functional as F

    from distributed_crawler_tpu_torch.ops.quant import (
        dequantize,
        int8_matmul,
        quantize_activations,
    )
    from distributed_crawler_tpu_torch.utils import cudatime

    layer = engine.model.encoder.layers[0]
    mods = (layer.attn.qkv, layer.attn.attn_out, layer.mlp.mlp_up,
            layer.mlp.mlp_down)
    n_layers = engine.ecfg.n_layers
    rows = []
    for bucket in MAIN_BUCKETS:
        m = BATCH * bucket
        xs = [torch.randn((m, mod.kernel_q.shape[1]), device=engine.device,
                          dtype=torch.bfloat16) for mod in mods]
        quant = [quantize_activations(x) for x in xs]
        accs = [int8_matmul(xq, mod.kernel_q)
                for (xq, _), mod in zip(quant, mods)]
        w16 = [mod.kernel_q.to(torch.bfloat16) for mod in mods]
        b16 = [mod.bias.reshape(-1).to(torch.bfloat16) for mod in mods]
        parts = {
            "quantize": lambda: [quantize_activations(x) for x in xs],
            "int8_matmul": lambda: [int8_matmul(xq, mod.kernel_q)
                                    for (xq, _), mod in zip(quant, mods)],
            "dequantize": lambda: [
                dequantize(acc, a, mod.scale.reshape(-1),
                           mod.bias.reshape(-1), torch.bfloat16)
                for acc, (_, a), mod in zip(accs, quant, mods)],
            "bf16_dense": lambda: [F.linear(x, w) + b
                                   for x, w, b in zip(xs, w16, b16)],
        }
        row = {"bucket": bucket, "card": smi}
        for name, fn in parts.items():
            row[f"{name}_ms_per_forward"] = cudatime.event_time_ms(
                fn, min_iters=3, max_iters=20) * n_layers
        rows.append(row)
        del xs, quant, accs, w16, b16, parts
        torch.cuda.empty_cache()
    emit("times.int8_parts", model="xlmr_base", rows=rows)
    return rows


def write_xlmr_checkpoint(np, ckpt, seed):
    """Phase 6's synthetic XLM-R-base checkpoint (``config.json`` and
    ``model.safetensors``) in ``ckpt``; phase 13 trains from the same
    files."""
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(XLMR_HF_CONFIG, f)
    write_safetensors(os.path.join(ckpt, "model.safetensors"),
                      xlmr_state(np, seed))


def phase_xlmr(torch, np, attention, device, gen, seed, smi, ckpt_dir):
    """XLM-R-base served int8 from a local HF checkpoint (written to
    ``ckpt_dir``) through `TPUWorker`; int8 and int8_static against bf16
    on the same weights; the int8 products against the CPU; times."""
    import contextlib

    from distributed_crawler_tpu_torch.bus import RecordBatch
    from distributed_crawler_tpu_torch.inference import engine as engine_mod
    from distributed_crawler_tpu_torch.inference.tokenizer import (
        HashingTokenizer,
    )
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    EngineConfig = engine_mod.EngineConfig
    InferenceEngine = engine_mod.InferenceEngine
    with contextlib.nullcontext(ckpt_dir) as ckpt:
        t0 = time.perf_counter()
        write_xlmr_checkpoint(np, ckpt, seed)
        write_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(os.path.join(ckpt, "model.safetensors"))

        def make(**kw):
            t = time.perf_counter()
            eng = InferenceEngine(EngineConfig(
                model="xlmr_base", pretrained_dir=ckpt, batch_size=BATCH,
                seed=seed, **kw), registry=MetricsRegistry())
            return eng, time.perf_counter() - t

        records = _Records()
        logger = logging.getLogger(engine_mod.__name__)
        logger.addHandler(records)
        try:
            engine, init_s = make(quantize="int8")
        finally:
            logger.removeHandler(records)
        ecfg = engine.ecfg
        check(engine.device.type == "cuda", f"engine on {engine.device}")
        check((ecfg.vocab_size, ecfg.hidden, ecfg.n_layers, ecfg.n_heads,
               ecfg.mlp_dim) == (250002, 768, 12, 12, 3072)
              and ecfg.n_labels == XLMR_LABELS,
              f"not XLM-R-base's full width with 4 labels: {ecfg}")
        check(ecfg.head_dim == XLMR_HEAD_DIM, f"head dim {ecfg.head_dim}")
        check(ecfg.quant == "int8", f"ecfg.quant {ecfg.quant!r}")
        check(isinstance(engine.tokenizer, HashingTokenizer)
              and any("falling back to HashingTokenizer" in m
                      for m in records.messages),
              f"tokenizer {type(engine.tokenizer).__name__}, warnings "
              f"{records.messages}")
        check(engine.bucket_spec.lengths == MAIN_BUCKETS,
              f"buckets {engine.bucket_spec.lengths}")
        t0 = time.perf_counter()
        engine.warmup()
        torch.cuda.synchronize()
        emit("slice.xlmr.setup", checkpoint_bytes=ckpt_bytes,
             checkpoint_write_s=write_s, engine_init_s=init_s,
             warmup_s=time.perf_counter() - t0, quant=ecfg.quant,
             tokenizer=type(engine.tokenizer).__name__,
             tokenizer_warning=records.messages[-1][:200])

        rng = np.random.default_rng(seed + 1)
        batches = [RecordBatch.from_records(
            synthetic_posts(np, rng, BATCH, i * BATCH), crawl_id="smoke-xlmr")
            for i in range(8)]
        served = serve_batches(np, engine, batches)
        toks, u_emb, pack_err = check_packed_vs_unpacked(np, engine, batches,
                                                         served)
        products = check_int8_products(torch, engine, gen)

        bf16, bf16_init_s = make()
        check(bf16.ecfg.quant == "none", f"bf16 engine {bf16.ecfg.quant}")
        f_emb = np.asarray([r["embedding"]
                            for r in bf16.run_tokenized(toks)])
        cos_int8 = _min_cosine(np, u_emb, f_emb)
        check(cos_int8 > 0.98, f"int8 vs bf16 minimum cosine {cos_int8}")

        static, static_init_s = make(quantize="int8_static")
        check(static.ecfg.quant == "int8_static",
              f"static engine {static.ecfg.quant}")
        s_emb = np.asarray([r["embedding"]
                            for r in static.run_tokenized(toks[:BATCH])])
        cos_static = _min_cosine(np, s_emb, f_emb[:BATCH])
        check(cos_static > 0.97,
              f"int8_static vs bf16 minimum cosine {cos_static}")
    n_posts = served["emb"].shape[0]
    emit("slice.xlmr", records=n_posts, batches=len(batches),
         result_frames=served["result_frames"],
         dispatches=served["dispatches"], kernel_launches=served["launches"],
         kernel_launches_by_path=served["launches_by_path"],
         launches_per_dispatch=served["launches"] / served["dispatches"],
         head_dim=ecfg.head_dim, coalesced_groups=served["coalesced_groups"],
         packed_vs_unpacked=pack_err, int8_products=products,
         int8_vs_bf16={"posts": len(toks), "min_cosine": cos_int8,
                       "bound": 0.98},
         int8_static_vs_bf16={"posts": BATCH, "min_cosine": cos_static,
                              "bound": 0.97},
         engine_init_s={"int8": init_s, "bf16": bf16_init_s,
                        "int8_static": static_init_s})
    emit("times.slice", model="xlmr_base", quant="int8", posts=n_posts,
         seconds=served["seconds"], posts_per_s=served["posts_per_s"],
         p50_batch_latency_ms=served["p50_ms"],
         dispatch_latencies=served["latencies"], card=smi)
    for eng, quant in ((bf16, "none"), (engine, "int8"),
                       (static, "int8_static")):
        time_engine(torch, eng, smi, model="xlmr_base", quant=quant)
    time_int8_parts(torch, engine, smi)
    del engine, bf16, static
    torch.cuda.empty_cache()
    rows = model_kernel_times(torch, attention, device, gen, smi,
                              "xlmr_base", XLMR_HEADS, XLMR_HEAD_DIM)
    emit("times.kernel.sum", name="flash_attention", model="xlmr_base",
         at="batch 256, 12 heads of 64, bf16, serving padding: one call at "
            "each of buckets 32-512, summed",
         ms=sum(r["ms"] for r in rows),
         mma_sync_ms=sum(r["mma_sync_ms"] for r in rows),
         plain_ms=sum(r["plain_ms"] for r in rows),
         library_ms=sum(r["library_ms"] for r in rows),
         bound_parts_ms={p: sum(r["bound_parts_ms"][p] for r in rows)
                         for p in rows[0]["bound_parts_ms"]}, card=smi)
    return {"launches": served["launches_by_path"],
            "dispatches": served["dispatches"], "kernel_rows": rows}


def model_kernel_times(torch, attention, device, gen, smi, model, heads,
                       head_dim):
    """The sm90 kernel at a model's shape (batch 256, ``heads`` heads of
    ``head_dim``, bf16, serving padding) per bucket, beside its bound, the
    plain version and SDPA."""
    import torch.nn.functional as F

    rows = []
    for l in MAIN_BUCKETS:
        q, k, v = _qkv(torch, BATCH, l, heads, head_dim, torch.bfloat16, gen,
                       device)
        check(attention.choose_path(q, k, v) == "sm90",
              f"{model} shape L={l} goes to "
              f"{attention.choose_path(q, k, v)}")
        lo = l // 2 + 1 if l > 32 else 1
        mask = _padded_mask(torch, BATCH, l, gen, device, min_len=lo)
        times, errs, pairs = _time_bucket(torch, F, attention, q, k, v, mask,
                                          None, f"{model} padded L={l}")
        parts = attention_bound_ms(pairs, BATCH, l, heads, head_dim,
                                   "bfloat16", 2, False)
        row = {"model": model, "bucket": l, "shape": "padded",
               "batch": BATCH, "heads": heads, "head_dim": head_dim,
               "dtype": "bfloat16",
               "max_abs_err": errs, "ms": times["sm90"],
               "mma_sync_ms": times["mma_sync"], "eager_ms": times["eager"],
               "plain_ms": times["plain"], "library_ms": times["sdpa"],
               "bound_ms": bound_of(parts)[0], "bound_by": bound_of(parts)[1],
               "bound_parts_ms": parts, "allowed_pairs": pairs, "card": smi}
        rows.append(row)
        emit("times.kernel", name="flash_attention", **row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


# -- phase 7: Whisper-small ASR from a local HF checkpoint ------------------
# openai/whisper-small's published config.json: the fields the converter
# reads, and the special tokens of the multilingual vocabulary.
WHISPER_HF_CONFIG = {
    "architectures": ["WhisperForConditionalGeneration"],
    "model_type": "whisper", "vocab_size": 51865, "num_mel_bins": 80,
    "d_model": 768, "encoder_layers": 12, "encoder_attention_heads": 12,
    "encoder_ffn_dim": 3072, "decoder_layers": 12,
    "decoder_attention_heads": 12, "decoder_ffn_dim": 3072,
    "max_source_positions": 1500, "max_target_positions": 448,
    "activation_function": "gelu", "scale_embedding": False,
    "bos_token_id": 50257, "eos_token_id": 50257, "pad_token_id": 50257,
    "decoder_start_token_id": 50258,
}
ASR_BUCKETS = (1, 2, 4, 8)
# WAV files sent through the worker: one decode step costs about 10 ms of
# host time on the card's machine, so every dispatch takes 4-5 s whatever
# its bucket; 8 files (about 15 windows) keep the phase near a minute.
ASR_FILES = 8
WHISPER_HEADS, WHISPER_HEAD_DIM, WHISPER_CTX = 12, 64, 1500
# Card f32 (cuBLAS without TF32, the SIMT attention kernel) against the CPU
# in f32, through 12 layers: sums in another order.
ASR_F32_TOL = 2e-3
# A greedy token of the kernel run may differ from the argmax of the plain
# run's teacher-forced logits only where that run's top-2 margin is below
# this: the two runs' bf16 encoder outputs differ by bf16 roundings, which
# move the f32 logits by a few hundredths at most.
ASR_NEAR_TIE = 0.1
# Decode steps under torch.profiler (every step launches the same ~650
# kernels): at 32 steps the profiled call took about 24 s on an H100's
# host, of which the steps themselves take under half a second.
ASR_PROFILE_STEPS = 8
# The decode length of a bucket no served dispatch used, timed alone (the
# served ones decode the full 448 tokens; per step, the short decode reads
# a shorter cache).
ASR_TIMING_LEN = 64


def whisper_state(np, seed):
    """HF ``WhisperForConditionalGeneration`` key names and shapes (the
    ``model.`` prefix; the output projection is tied, so not stored),
    values from ``default_rng(seed)`` at std 0.02, LayerNorm scales around
    1."""
    rng = np.random.default_rng(seed)
    c = WHISPER_HF_CONFIG
    d, ff, mels = c["d_model"], c["encoder_ffn_dim"], c["num_mel_bins"]

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def ln(prefix):
        return [(f"{prefix}.weight", 1 + w(d)), (f"{prefix}.bias", w(d))]

    def attn(prefix):
        out = [(f"{prefix}.k_proj.weight", w(d, d))]
        for proj in ("v_proj", "q_proj", "out_proj"):
            out += [(f"{prefix}.{proj}.weight", w(d, d)),
                    (f"{prefix}.{proj}.bias", w(d))]
        return out

    def mlp(prefix):
        return [(f"{prefix}.fc1.weight", w(ff, d)),
                (f"{prefix}.fc1.bias", w(ff)),
                (f"{prefix}.fc2.weight", w(d, ff)),
                (f"{prefix}.fc2.bias", w(d))]

    e = "model.encoder"
    out = [(f"{e}.conv1.weight", w(d, mels, 3)), (f"{e}.conv1.bias", w(d)),
           (f"{e}.conv2.weight", w(d, d, 3)), (f"{e}.conv2.bias", w(d)),
           (f"{e}.embed_positions.weight",
            w(c["max_source_positions"], d))]
    for i in range(c["encoder_layers"]):
        b = f"{e}.layers.{i}"
        out += attn(f"{b}.self_attn") + ln(f"{b}.self_attn_layer_norm")
        out += mlp(b) + ln(f"{b}.final_layer_norm")
    out += ln(f"{e}.layer_norm")
    dd = "model.decoder"
    out += [(f"{dd}.embed_tokens.weight", w(c["vocab_size"], d)),
            (f"{dd}.embed_positions.weight",
             w(c["max_target_positions"], d))]
    for i in range(c["decoder_layers"]):
        b = f"{dd}.layers.{i}"
        out += attn(f"{b}.self_attn") + ln(f"{b}.self_attn_layer_norm")
        out += attn(f"{b}.encoder_attn") + ln(f"{b}.encoder_attn_layer_norm")
        out += mlp(b) + ln(f"{b}.final_layer_norm")
    out += ln(f"{dd}.layer_norm")
    return out


def write_audio_traffic(np, root, seed):
    """ASR_FILES PCM16 WAV files from ``seed`` (a modulated tone and
    noise), durations spread over 2-75 s, one of them 48 kHz stereo; and
    one file that is not a WAV.  Returns [(path, seconds at 16 kHz, or
    None)]."""
    import wave

    rng = np.random.default_rng(seed)
    files = []
    for i in range(ASR_FILES):
        seconds = 2.0 + 73.0 * (i + rng.random()) / ASR_FILES
        rate, channels = (48_000, 2) if i == 5 else (16_000, 1)
        n = int(seconds * rate)
        t = np.arange(n) / rate
        f0 = 120.0 + 200.0 * rng.random()
        sig = (0.2 * np.sin(2 * np.pi * f0 * t)
               * (1 + 0.5 * np.sin(2 * np.pi * 3.0 * t))
               + 0.03 * rng.standard_normal(n))
        pcm = (np.clip(sig, -1, 1) * 32767).astype(np.int16)
        if channels == 2:
            pcm = np.stack([pcm, pcm // 2], axis=1)
        path = os.path.join(root, f"voice_{i:02d}.wav")
        with wave.open(path, "wb") as wf:
            wf.setnchannels(channels)
            wf.setsampwidth(2)
            wf.setframerate(rate)
            wf.writeframes(pcm.tobytes())
        files.append((path, round(n * 16_000 / rate) / 16_000))
    bad = os.path.join(root, "video_04.mp4")
    with open(bad, "wb") as f:
        f.write(b"\x00\x00\x00\x18ftypmp42" + bytes(rng.integers(
            0, 256, 4096, dtype=np.uint8)))
    files.insert(4, (bad, None))
    return files


class DictProvider:
    """``put_text`` / ``get_text`` / ``list_dir`` / ``save_json`` /
    ``load_json`` over a dict: the writeback and checkpoint target of the
    ASR and cluster slices (JSON goes through a text round trip, as it
    would through a file)."""

    def __init__(self):
        self.files = {}

    def put_text(self, rel, text):
        self.files[rel] = text

    def get_text(self, rel):
        return self.files.get(rel)

    def save_json(self, rel, data):
        self.files[rel] = json.dumps(data)

    def load_json(self, rel):
        text = self.files.get(rel)
        return json.loads(text) if text is not None else None

    def list_dir(self, rel):
        prefix = rel.rstrip("/") + "/"
        return sorted(k[len(prefix):] for k in self.files
                      if k.startswith(prefix))


def serve_audio(pipeline, msgs):
    """The ASR main path: AudioBatchMessages published on the in-memory
    bus, served by `ASRWorker` (coalescing 2), transcripts collected from
    the transcripts topic.  The kernel counts are set to 0 just before
    and read just after."""
    from distributed_crawler_tpu_torch.bus import (
        TOPIC_MEDIA_BATCHES,
        TOPIC_TRANSCRIPTS,
        InMemoryBus,
    )
    from distributed_crawler_tpu_torch.media.worker import (
        ASRWorker,
        ASRWorkerConfig,
    )
    from distributed_crawler_tpu_torch.ops import attention
    from distributed_crawler_tpu_torch.utils import trace
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    bus = InMemoryBus(sync=False)
    got = []
    bus.subscribe(TOPIC_TRANSCRIPTS, got.append)
    provider = DictProvider()
    worker = ASRWorker(bus, pipeline, provider=provider,
                       cfg=ASRWorkerConfig(worker_id="chip-smoke-asr",
                                           coalesce_batches=2),
                       registry=MetricsRegistry())
    n_refs = sum(len(m.refs) for m in msgs)
    pipeline.timeline.reset()
    trace.TRACER.reset()
    worker.start()
    bus.start()
    attention.flash_attention.launches = 0
    by_path = attention.flash_attention.launches_by_path
    for p in by_path:
        by_path[p] = 0
    t_start = time.perf_counter()
    try:
        for m in msgs:
            bus.publish(TOPIC_MEDIA_BATCHES, m.to_dict())
        deadline = time.monotonic() + 600
        while len(got) < n_refs and time.monotonic() < deadline:
            time.sleep(0.005)
        t_end = time.perf_counter()
        check(worker.drain(timeout_s=60.0), "asr worker did not drain")
    finally:
        worker.stop()
        bus.close()
    launches = dict(by_path)
    dispatches = pipeline.timeline.snapshot()["batches_total"]
    # The dispatch groups, in order, from the worker's spans.
    groups = []
    for s in trace.TRACER.spans():
        if s.name == "asr_worker.coalesce":
            groups.append(list(s.attrs["batch_ids"]))
        elif s.name == "asr_worker.process":
            groups.append([s.attrs["batch"]])
    status = worker.get_status()
    check(status["processed_batches"] == len(msgs)
          and status["error_batches"] == 0, f"asr worker status {status}")
    return {"transcripts": got, "provider": provider, "launches": launches,
            "dispatches": dispatches, "groups": groups,
            "seconds": t_end - t_start,
            "coalesced_groups": worker.m_coalesce.count}


def check_transcripts(np, pipeline, msgs, files, served):
    """Coverage (one transcript per file, ceil(duration / 30 s) windows,
    the non-WAV file an explicit error) and consistency (the tokens
    `transcribe_files` gives for each dispatch group's files; the
    writeback rows equal to the published messages)."""
    from distributed_crawler_tpu_torch.bus import TranscriptMessage
    from distributed_crawler_tpu_torch.media.worker import iter_transcripts

    seconds = dict(files)
    by_media = {}
    for d in served["transcripts"]:
        t = TranscriptMessage.from_dict(d)
        check(t.media_id not in by_media, f"duplicate transcript {t.media_id}")
        by_media[t.media_id] = t
    refs = [r for m in msgs for r in m.refs]
    check(set(by_media) == {r.media_id for r in refs},
          f"{len(by_media)} transcripts for {len(refs)} files")
    windows = 0
    for r in refs:
        t, dur = by_media[r.media_id], seconds[r.path]
        if dur is None:
            check(bool(t.error) and t.windows == 0 and not t.tokens,
                  f"{r.path}: no error transcript ({t.error!r})")
            continue
        want = int(np.ceil(dur * 16_000 / pipeline.window_samples))
        check(not t.error and t.windows == want,
              f"{r.path}: {t.windows} windows for {dur} s (want {want}), "
              f"error {t.error!r}")
        check(len(t.tokens) > 0 and all(
            0 <= x < pipeline.model.cfg.n_vocab for x in t.tokens),
            f"{r.path}: tokens out of range")
        windows += t.windows
    # The same files through `transcribe_files` in one call, so every
    # window meets the same batch as when served: the dispatch group with
    # the most windows (ties: the first), since each re-transcribed window
    # decodes its full 448 tokens (all groups took 27.9 s on the card).
    by_id = {m.batch_id: m for m in msgs}
    check(sorted(b for g in served["groups"] for b in g) == sorted(by_id),
          f"dispatch groups {served['groups']}")

    def group_windows(group):
        return sum(by_media[r.media_id].windows
                   for b in group for r in by_id[b].refs)

    widest = max(served["groups"], key=group_windows)
    t0 = time.perf_counter()
    for group in [widest]:
        g_refs = [r for b in group for r in by_id[b].refs]
        again = pipeline.transcribe_files([r.path for r in g_refs])
        for r, res in zip(g_refs, again):
            t = by_media[r.media_id]
            check(res.tokens == t.tokens and res.windows == t.windows
                  and bool(res.error) == bool(t.error),
                  f"{r.path}: served tokens differ from transcribe_files")
    emit("times.asr_retranscription", groups=len(served["groups"]),
         group=widest, windows=group_windows(widest),
         seconds=time.perf_counter() - t0)
    rows = {}
    for m in msgs:
        for row in iter_transcripts(served["provider"], m.crawl_id):
            rows[row["media_id"]] = row
    check(set(rows) == set(by_media), "writeback rows missing")
    for media, t in by_media.items():
        row = rows[media]
        check(row["tokens"] == t.tokens and row["windows"] == t.windows
              and row["error"] == t.error and row["batch_id"] == t.batch_id
              and row["trace_id"] == t.trace_id,
              f"{media}: writeback row differs from the published message")
    return windows


def check_asr_against_cpu(torch, wh, cfg, tree, mel, device):
    """The f32 model on the card (cuBLAS without TF32, the SIMT attention
    kernel) against the port on the CPU in f32, on one window: the encoder
    output and the teacher-forced logits."""
    from distributed_crawler_tpu_torch.models.from_jax import (
        load_whisper_params,
    )
    from distributed_crawler_tpu_torch.ops import attention

    cfg = replace(cfg, dtype="float32")
    cpu = load_whisper_params(wh.Whisper(cfg), tree).eval()
    card = load_whisper_params(wh.Whisper(cfg), tree).to(device).eval()
    tokens = torch.tensor([[cfg.sot_token, cfg.transcribe_token,
                            cfg.no_timestamps_token, 440, 1000, 220, 50]])
    before = attention.flash_attention.launches_by_path["simt"]
    with torch.inference_mode():
        xa_cpu = cpu.encode(mel)
        logits_cpu = cpu.decode_teacher(tokens, xa_cpu)
        xa = card.encode(mel.to(device))
        logits = card.decode_teacher(tokens.to(device), xa)
    torch.cuda.synchronize()
    simt = attention.flash_attention.launches_by_path["simt"] - before
    enc_err = (xa.cpu() - xa_cpu).abs().max().item()
    logit_err = (logits.cpu() - logits_cpu).abs().max().item()
    check(simt == cfg.n_audio_layer, f"{simt} simt launches in the f32 "
          f"encoder (expected {cfg.n_audio_layer})")
    check(enc_err <= ASR_F32_TOL and logit_err <= ASR_F32_TOL,
          f"card f32 vs CPU f32: encoder {enc_err}, logits {logit_err}, "
          f"tol {ASR_F32_TOL}")
    del card
    torch.cuda.empty_cache()
    return {"encoder_max_abs_err": enc_err, "logits_max_abs_err": logit_err,
            "tol": ASR_F32_TOL, "simt_launches": simt,
            "tokens": int(tokens.shape[1])}


def check_kernel_vs_plain_tokens(torch, wh, model, mel):
    """Greedy tokens of the bf16 model (encoder attention on the sm90
    kernel) against the same model with the encoder's attention in plain
    PyTorch (the reference's formula, `_attend`): every decoded token must
    be the argmax of the plain run's teacher-forced logits, except where
    their top-2 margin is below ASR_NEAR_TIE (counted)."""
    cfg = model.cfg
    tokens = wh.greedy_decode(model, mel)
    layers = model.encoder.layers
    with torch.inference_mode():
        kernel_logits = model.decode_teacher(tokens, model.encode(mel))
        for layer in layers:
            layer.attn.kernel = False
        try:
            plain_logits = model.decode_teacher(tokens, model.encode(mel))
        finally:
            for layer in layers:
                layer.attn.kernel = True
    toks = tokens.long().cpu()
    plain = plain_logits[:, :-1].float().cpu()
    top2 = plain.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    nxt = toks[:, 1:]
    # Steps the argmax decided: not the forced prompt, not after EOT.
    decoded = torch.ones_like(nxt, dtype=torch.bool)
    decoded[:, :2] = False
    ended = torch.cumsum((nxt == cfg.eot_token).int(), dim=1) > 0
    decoded[:, 1:] &= ~ended[:, :-1]
    differ = decoded & (nxt != plain.argmax(dim=-1))
    near = decoded & (margin < ASR_NEAR_TIE)
    check(not bool((differ & ~near).any()),
          f"kernel tokens differ from the plain run's argmax at "
          f"{int((differ & ~near).sum())} steps with margin >= "
          f"{ASR_NEAR_TIE}")
    return {"rows": int(toks.shape[0]), "decoded_steps": int(decoded.sum()),
            "differing_steps": int(differ.sum()), "near_ties": int(near.sum()),
            "near_tie_threshold": ASR_NEAR_TIE,
            "teacher_logits_max_abs_diff": (
                kernel_logits.float() - plain_logits.float()).abs().max()
            .item()}


def dispatch_ms_by_bucket():
    """Host ms of every ASR dispatch since the tracer was reset (the
    ``asr.transcribe`` spans: audio to the card, `transcribe_features`,
    tokens back), by bucket."""
    from distributed_crawler_tpu_torch.utils import trace

    out = {}
    for s in trace.TRACER.spans():
        if s.name == "asr.transcribe":
            out.setdefault(int(s.attrs["bucket"]), []).append(
                s.duration_s * 1e3)
    return out


def profile_decode(torch, model, mel, steps=ASR_PROFILE_STEPS):
    """Decode steps at one bucket, under `torch.profiler`: the kernels the
    card ran per step and their summed device time, against the same steps'
    wall time without the profiler (the device's busy share of a decode
    step).  None where the profiler recorded no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, b = model.cfg, mel.shape[0]
    with torch.inference_mode():
        cache, cross = model.decode_init(b, model.encode(mel))
        tok = torch.full((b, 1), cfg.sot_token, device=mel.device)

        def run():
            for pos in range(steps):
                model.decode_step(tok, pos, cache, cross)
            torch.cuda.synchronize()

        run()
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        return None
    device_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    return {"steps": steps, "bucket": b, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms / steps,
            "device_ops_per_step": len(device) / steps,
            "device_busy_share": device_ms / wall_ms}


def time_asr(torch, wh, attention, pipeline, smi, served_ms):
    """Per window bucket: log-mel, encoder and cross-K/V by CUDA events;
    one whole dispatch by the host clock — the median of the served
    dispatches of that bucket (``served_ms``), or one `transcribe_features`
    call of ASR_TIMING_LEN tokens where none was served — and its decode
    share (the dispatch less those three) in all and per step; the
    achieved TFLOP/s by
    `whisper_forward_flops`; the sm90 kernel at [B, 1500, 12, 64] beside
    its plain version, SDPA and its bound."""
    import torch.nn.functional as F

    from distributed_crawler_tpu_torch.utils import cudatime
    from distributed_crawler_tpu_torch.utils.costmodel import (
        whisper_forward_flops,
    )

    model, cfg, dev = pipeline.model, pipeline.model.cfg, pipeline.device
    rows, kernel_rows = [], []
    gen = torch.Generator().manual_seed(7)
    for b in ASR_BUCKETS:
        audio = (torch.randn((b, pipeline.window_samples), generator=gen)
                 * 0.1).to(dev)
        with torch.inference_mode():
            mel = wh.log_mel_spectrogram(audio, n_mels=cfg.n_mels)
            xa = model.encode(mel)
            mel_ms = cudatime.event_time_ms(
                lambda: wh.log_mel_spectrogram(audio, n_mels=cfg.n_mels),
                min_iters=3, max_iters=20)
            enc_ms = cudatime.event_time_ms(lambda: model.encode(mel),
                                            min_iters=3, max_iters=10)
            kv_ms = cudatime.event_time_ms(
                lambda: model.decoder.cross_kv(xa), min_iters=3,
                max_iters=20)
            served = sorted(served_ms.get(b, []))
            length = pipeline.max_len if served else ASR_TIMING_LEN
            if served:
                total_ms = served[len(served) // 2]
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = wh.transcribe_features(model, audio, max_len=length)
                torch.cuda.synchronize()
                total_ms = (time.perf_counter() - t0) * 1e3
                check(tuple(out.shape) == (b, length),
                      f"tokens {tuple(out.shape)}")
        profile = profile_decode(torch, model, mel) if b == max(
            ASR_BUCKETS) else None
        steps = length - 1
        decode_ms = total_ms - mel_ms - enc_ms - kv_ms
        flops = whisper_forward_flops(cfg, b, length)
        row = {"bucket": b, "log_mel_ms": mel_ms, "encoder_ms": enc_ms,
               "cross_kv_ms": kv_ms, "dispatch_ms": total_ms,
               "served_dispatches": len(served),
               "decode_ms": decode_ms, "decode_steps": steps,
               "decode_ms_per_step": decode_ms / steps,
               "model_tflop": flops / 1e12,
               "achieved_tflop_per_s": flops / (total_ms * 1e-3) / 1e12,
               "decode_profile": profile, "card": smi}
        rows.append(row)
        emit("times.asr", **row)
        # The encoder's attention alone, at its shape.
        q, k, v = (torch.randn((b, WHISPER_CTX, WHISPER_HEADS,
                                WHISPER_HEAD_DIM), generator=gen).to(
            device=dev, dtype=torch.bfloat16) for _ in range(3))
        check(attention.choose_path(q, k, v) == "sm90",
              f"Whisper shape B={b} goes to {attention.choose_path(q, k, v)}")
        times, errs, pairs = _time_bucket(torch, F, attention, q, k, v, None,
                                          None, f"whisper B={b}")
        parts = attention_bound_ms(pairs, b, WHISPER_CTX, WHISPER_HEADS,
                                   WHISPER_HEAD_DIM, "bfloat16", 2, False,
                                   has_mask=False)
        krow = {"model": "whisper_small", "batch": b, "seq": WHISPER_CTX,
                "heads": WHISPER_HEADS, "head_dim": WHISPER_HEAD_DIM,
                "dtype": "bfloat16", "mask": None, "max_abs_err": errs,
                "ms": times["sm90"], "mma_sync_ms": times["mma_sync"],
                "eager_ms": times["eager"], "plain_ms": times["plain"],
                "library_ms": times["sdpa"], "bound_ms": bound_of(parts)[0],
                "bound_by": bound_of(parts)[1], "bound_parts_ms": parts,
                "allowed_pairs": pairs, "card": smi}
        kernel_rows.append(krow)
        emit("times.kernel", name="flash_attention", **krow)
        del q, k, v, audio, mel, xa
        torch.cuda.empty_cache()
    return rows, kernel_rows


def phase_asr(torch, np, attention, device, seed, smi, work):
    """Whisper-small from a synthetic HF checkpoint at the published widths,
    served bf16 through `ASRPipeline.from_pretrained` and `ASRWorker`.  The
    checkpoint and the WAV tree stay under ``work`` for phase 11."""
    from distributed_crawler_tpu_torch.bus import AudioBatchMessage, AudioRef
    from distributed_crawler_tpu_torch.inference.asr import ASRPipeline
    from distributed_crawler_tpu_torch.models import whisper as wh
    from distributed_crawler_tpu_torch.models.hf_convert import (
        load_hf_whisper,
    )
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    root = os.path.join(work, "asr")
    ckpt = os.path.join(root, "ckpt")
    os.makedirs(ckpt)
    t0 = time.perf_counter()
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(WHISPER_HF_CONFIG, f)
    write_safetensors(os.path.join(ckpt, "model.safetensors"),
                      whisper_state(np, seed))
    write_s = time.perf_counter() - t0
    ckpt_bytes = os.path.getsize(os.path.join(ckpt, "model.safetensors"))
    media = os.path.join(root, "media")
    os.makedirs(media)
    files = write_audio_traffic(np, media, seed)

    t0 = time.perf_counter()
    pipeline = ASRPipeline.from_pretrained(ckpt, batch_size=8,
                                           registry=MetricsRegistry())
    init_s = time.perf_counter() - t0
    cfg = pipeline.model.cfg
    check(pipeline.device.type == "cuda",
          f"pipeline on {pipeline.device}")
    check(cfg == wh.WHISPER_SMALL, f"not whisper-small's widths: {cfg}")
    check(pipeline.window_buckets == ASR_BUCKETS,
          f"window buckets {pipeline.window_buckets}")
    check(pipeline.max_len == cfg.n_text_ctx == 448,
          f"decode length {pipeline.max_len}")
    check(pipeline.detokenize is None, "a detokenizer without files")
    t0 = time.perf_counter()
    pipeline.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    emit("slice.asr.setup", checkpoint_bytes=ckpt_bytes,
         checkpoint_write_s=write_s, pipeline_init_s=init_s,
         warmup_s=warm_s, programs=pipeline.compile_cache_stats(),
         files=[[os.path.basename(p), s] for p, s in files])

    paths = [p for p, _ in files]
    cuts = (0, 2, 5, 7, len(paths))  # 4 batches of 2-3 files
    msgs = [AudioBatchMessage.new(
        [AudioRef(media_id=f"m{i:02d}", path=paths[i],
                  channel_name="smoke") for i in range(lo, hi)],
        crawl_id="smoke-asr") for lo, hi in zip(cuts, cuts[1:])]
    served = serve_audio(pipeline, msgs)
    launches, dispatches = served["launches"], served["dispatches"]
    check(dispatches > 0, "no encoder dispatch on the ASR path")
    check(launches == {"sm90": cfg.n_audio_layer * dispatches,
                       "mma_sync": 0, "simt": 0},
          f"launches by path {launches} for {dispatches} dispatches: "
          f"expected {cfg.n_audio_layer} sm90 per dispatch")
    windows = check_transcripts(np, pipeline, msgs, files, served)
    audio_s = sum(s for _, s in files if s is not None)
    window0 = pipeline.chunker.chunk_files([paths[0]]).windows[:1]
    two = pipeline.chunker.chunk_files(paths[-1:]).windows[:2]
    served_ms = dispatch_ms_by_bucket()
    transcribe = expected_cli_transcripts(pipeline, media, files)
    _, tree = load_hf_whisper(ckpt)
    mel0 = wh.log_mel_spectrogram(torch.from_numpy(window0),
                                  n_mels=cfg.n_mels)
    vs_cpu = check_asr_against_cpu(torch, wh, cfg, tree, mel0, device)
    del tree
    mel2 = wh.log_mel_spectrogram(torch.from_numpy(two).to(device),
                                  n_mels=cfg.n_mels)
    vs_plain = check_kernel_vs_plain_tokens(torch, wh, pipeline.model, mel2)
    emit("slice.asr", files=len(files), batches=len(msgs),
         transcripts=len(served["transcripts"]), windows=windows,
         dispatches=dispatches, dispatch_groups=served["groups"],
         coalesced_groups=served["coalesced_groups"],
         kernel_launches_by_path=launches,
         launches_per_dispatch=launches["sm90"] / dispatches,
         card_f32_vs_cpu_f32=vs_cpu, kernel_vs_plain_tokens=vs_plain)
    emit("times.slice", model="whisper_small", windows=windows,
         audio_seconds=audio_s, seconds=served["seconds"],
         windows_per_s=windows / served["seconds"],
         audio_s_per_wall_s=audio_s / served["seconds"], card=smi)
    _, kernel_rows = time_asr(torch, wh, attention, pipeline, smi,
                              served_ms)
    emit("times.kernel.sum", name="flash_attention", model="whisper_small",
         at="12 heads of 64 over 1500 tokens, bf16, no mask: one call at "
            "each of batch 1, 2, 4, 8, summed",
         ms=sum(r["ms"] for r in kernel_rows),
         mma_sync_ms=sum(r["mma_sync_ms"] for r in kernel_rows),
         plain_ms=sum(r["plain_ms"] for r in kernel_rows),
         library_ms=sum(r["library_ms"] for r in kernel_rows),
         bound_parts_ms={p: sum(r["bound_parts_ms"][p] for r in kernel_rows)
                         for p in kernel_rows[0]["bound_parts_ms"]},
         max_abs_err=max(r["max_abs_err"]["sm90"] for r in kernel_rows),
         card=smi)
    del pipeline
    torch.cuda.empty_cache()
    return {"launches": launches, "dispatches": dispatches,
            "kernel_rows": kernel_rows, "ckpt": ckpt, "media": media,
            "transcribe": transcribe, "files": files}


def expected_cli_transcripts(pipeline, media, files):
    """What ``mode=transcribe`` must write for its input (phase 11): a
    tree of copies of phase 7's two shortest WAVs and its 48 kHz stereo
    WAV, plus a copy of the non-WAV file under a ``.wav`` name (one
    dispatch; the whole tree took two), in the order the CLI walks them,
    through `transcribe_files` on this pipeline (the CLI's defaults:
    batch 8, window buckets 1/2/4/8)."""
    tree = os.path.join(os.path.dirname(media), "transcribe_in")
    os.makedirs(tree)
    wavs = sorted((sec, p) for p, sec in files if sec is not None)
    chosen = [p for _, p in wavs[:2]] + [os.path.join(media,
                                                      "voice_05.wav")]
    for p in chosen:
        shutil.copyfile(p, os.path.join(tree, os.path.basename(p)))
    bad = next(p for p, sec in files if sec is None)
    with open(bad, "rb") as src, \
            open(os.path.join(tree, "not_a_wav.wav"), "wb") as dst:
        dst.write(src.read())
    paths = sorted(os.path.join(tree, n) for n in os.listdir(tree))
    t0 = time.perf_counter()
    results = pipeline.transcribe_files(paths)
    return {"seconds": time.perf_counter() - t0, "input": tree,
            "audio_seconds": sum(sec for p, sec in files if p in chosen),
            "rows": [{"path": os.path.relpath(r.path, tree),
                      "tokens": r.tokens, "windows": r.windows,
                      "error": r.error} for r in results]}


# -- phase 8: E5-large embeddings clustered on the card ---------------------
# E5-large's attention shape: 16 heads of 64.
E5L_HEADS, E5L_HEAD_DIM = 16, 64
# The ClusterWorker at the CLI's streaming defaults (`mode=cluster-worker`):
# k 16, row buckets 64/256, a checkpoint every 8 batches, coalescing 4.
CLUSTER_K, CLUSTER_BUCKETS, CLUSTER_CKPT_EVERY = 16, (64, 256), 8
# `mode=cluster`'s batch fit (k 8, 25 iterations) over the north star's
# 1M posts; the card-against-CPU step check at 65,536 rows.
FIT_K, FIT_ITERS, FIT_N, FIT_CHECK_N, FIT_DIM = 8, 25, 1 << 20, 65536, 1024
# Bounds, set before the first run on the card (PERF.md, PR 5).  E5-large
# bf16 on the card against f32 on the CPU from the same weights: the
# embeddings' minimum cosine, and labels equal where the CPU's top-2 score
# gap exceeds the margin.  The k-means step on the card against the CPU:
# assignments equal where the top-2 score gap exceeds the tie margin (the
# ties are counted), centroids within 1e-4, one-hot sums within 1e-5 of
# their largest entry.
E5L_MIN_COSINE, E5L_LABEL_MARGIN = 0.99, 0.05
CLUSTER_TIE_MARGIN, CLUSTER_CENTROID_TOL, CLUSTER_SUM_RTOL = 1e-4, 1e-4, 1e-5


def _top2_gap(np, scores):
    s = np.sort(scores, axis=1)
    return s[:, 1] - s[:, 0]


def _unit_rows(np, x):
    return (x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True),
                           1e-12)).astype(np.float32)


def unit_mixture(np, rng, centers, n):
    """``n`` unit vectors around seeded unit ``centers`` (noise of norm
    about 0.75 before renormalising: cosine about 0.8 to the centre)."""
    d = centers.shape[1]
    ids = rng.integers(0, len(centers), size=n)
    noise = rng.standard_normal((n, d), dtype=np.float32)
    return _unit_rows(np, centers[ids] + noise * np.float32(0.75 / d ** 0.5))


def recording_cluster_engine(cfg, registry):
    """A `ClusterEngine` that keeps each observe's input and assignments and
    its state after the first one (the seeds plus one step), for the CPU
    replay."""
    from distributed_crawler_tpu_torch.cluster import ClusterEngine

    class Recording(ClusterEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.calls = []
            self.first_state = None

        def observe(self, vectors):
            out = super().observe(vectors)
            self.calls.append((vectors, out))
            if self.first_state is None:
                self.first_state = self.state_dict()
            return out

    return Recording(cfg, registry=registry)


def serve_and_cluster(np, engine, batches, provider):
    """The cluster main path: RecordBatches published on the in-memory bus,
    embedded by `TPUWorker` (packed, coalescing 4, embeddings published),
    their result frames folded by `ClusterWorker` at the CLI's streaming
    defaults.  The kernel counts are set to 0 just before and read just
    after.  The cluster worker is left running for the resume check."""
    from distributed_crawler_tpu_torch.bus import (
        TOPIC_CLUSTERS,
        TOPIC_INFERENCE_BATCHES,
        TOPIC_INFERENCE_RESULTS,
        InMemoryBus,
    )
    from distributed_crawler_tpu_torch.cluster import (
        ClusterEngineConfig,
        ClusterWorker,
        ClusterWorkerConfig,
    )
    from distributed_crawler_tpu_torch.inference.worker import (
        TPUWorker,
        TPUWorkerConfig,
    )
    from distributed_crawler_tpu_torch.ops import attention
    from distributed_crawler_tpu_torch.utils import trace
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    bus = InMemoryBus(sync=False)
    results, updates = [], []
    bus.subscribe(TOPIC_INFERENCE_RESULTS, results.append)
    bus.subscribe(TOPIC_CLUSTERS, updates.append)
    tpu = TPUWorker(bus, engine, cfg=TPUWorkerConfig(
        worker_id="chip-smoke-e5l", pack=True, coalesce_batches=4,
        publish_embeddings=True), registry=MetricsRegistry())
    ccfg = ClusterWorkerConfig(worker_id="chip-smoke-cluster", k=CLUSTER_K,
                               buckets=CLUSTER_BUCKETS,
                               checkpoint_every_batches=CLUSTER_CKPT_EVERY,
                               coalesce_batches=4)
    cengine = recording_cluster_engine(
        ClusterEngineConfig(k=ccfg.k, buckets=ccfg.buckets, seed=ccfg.seed),
        MetricsRegistry())
    check(cengine.device.type == "cuda", f"cluster engine on "
                                         f"{cengine.device}")
    cw = ClusterWorker(bus, engine=cengine, provider=provider, cfg=ccfg,
                       registry=MetricsRegistry())
    check(not cw.resumed, "a fresh provider resumed a checkpoint")
    trace.TRACER.reset()
    cw.start()
    tpu.start()
    bus.start()
    attention.flash_attention.launches = 0
    by_path = attention.flash_attention.launches_by_path
    for p in by_path:
        by_path[p] = 0
    dispatches0 = engine.m_latency.count
    t_start = time.perf_counter()
    try:
        for b in batches:
            bus.publish(TOPIC_INFERENCE_BATCHES, b.to_dict())
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            st = cw.get_status()
            if st["processed_batches"] + st["error_batches"] >= len(batches):
                break
            time.sleep(0.005)
        t_end = time.perf_counter()
        check(tpu.drain(timeout_s=60.0), "tpu worker did not drain")
        check(cw.drain(timeout_s=60.0), "cluster worker did not drain")
    finally:
        tpu.stop()
        bus.close()
    launches = attention.flash_attention.launches
    launches_by_path = dict(by_path)
    dispatches = engine.m_latency.count - dispatches0
    n_layers = engine.ecfg.n_layers
    check(dispatches > 0, "no device dispatch on the cluster path")
    check(launches == n_layers * dispatches,
          f"{launches} kernel launches for {dispatches} dispatches "
          f"(expected {n_layers} per dispatch)")
    check(launches_by_path == {"sm90": launches, "mma_sync": 0, "simt": 0},
          f"launches by path {launches_by_path}: every one should be sm90")
    status = cw.get_status()
    check(status["processed_batches"] == len(batches)
          and status["error_batches"] == 0 and status["skipped_batches"] == 0,
          f"cluster worker status {status}")
    groups, process_ms = [], []
    for s in trace.TRACER.spans():
        if s.name == "cluster_worker.process":
            groups.append(list(s.attrs.get("batch_ids")
                               or [s.attrs.get("batch")]))
            process_ms.append(s.duration_s * 1e3)
    return {"results": results, "updates": updates, "worker": cw,
            "engine": cengine, "launches": launches_by_path,
            "dispatches": dispatches, "seconds": t_end - t_start,
            "groups": groups, "process_ms": process_ms,
            "device": cengine.timeline.snapshot()}


def check_assignment_rows(provider, batches, crawl_id):
    """Every post has exactly one assignment row, with 0 <= cluster < k."""
    from distributed_crawler_tpu_torch.cluster import iter_assignments

    rows = list(iter_assignments(provider, crawl_id))
    uids = [r["post_uid"] for r in rows]
    want = [r["post_uid"] for b in batches for r in b.records]
    check(len(uids) == len(set(uids)) == len(want)
          and set(uids) == set(want),
          f"{len(uids)} assignment rows ({len(set(uids))} posts) for "
          f"{len(want)} posts")
    check(all(0 <= int(r["cluster"]) < CLUSTER_K for r in rows),
          "cluster id out of range")
    sizes = [0] * CLUSTER_K
    for r in rows:
        sizes[int(r["cluster"])] += 1
    return sizes


def check_updates(updates):
    """At least one valid ClusterUpdateMessage on TOPIC_CLUSTERS."""
    from distributed_crawler_tpu_torch.bus import ClusterUpdateMessage

    check(len(updates) >= 1, "no ClusterUpdateMessage on TOPIC_CLUSTERS")
    for u in updates:
        msg = ClusterUpdateMessage.from_dict(u)
        msg.validate()
        check(msg.k == CLUSTER_K and sum(msg.sizes) == msg.vectors,
              f"cluster update k={msg.k} sizes sum {sum(msg.sizes)} for "
              f"{msg.vectors} vectors")
    return ClusterUpdateMessage.from_dict(updates[-1]).to_dict()


def replay_on_cpu(np, card_engine):
    """The served stream through a CPU engine loaded from the card
    engine's state after its first observe, chunk by chunk as the engine
    steps: assignments equal where the top-2 score gap exceeds the tie
    margin, centroids within the tolerance after every chunk."""
    from distributed_crawler_tpu_torch.cluster import (
        ClusterEngine,
        ClusterEngineConfig,
    )
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    cfg = card_engine.cfg
    cpu = ClusterEngine(ClusterEngineConfig(k=cfg.k, buckets=cfg.buckets,
                                            spherical=cfg.spherical),
                        registry=MetricsRegistry(), device="cpu")
    cpu.load_state(card_engine.first_state)
    cap = max(cfg.buckets)
    compared = ties = differ = 0
    worst = 0.0
    for vectors, card_out in card_engine.calls[1:]:
        x = np.asarray(vectors, np.float32)
        for off in range(0, len(x), cap):
            chunk = x[off:off + cap]
            c = cpu.centroids.numpy()
            xn = _unit_rows(np, chunk)
            decided = _top2_gap(
                np, -2.0 * xn @ c.T + np.sum(c * c, axis=1)[None, :]) \
                > CLUSTER_TIE_MARGIN
            got = np.asarray(cpu.observe(chunk))
            want = np.asarray(card_out[off:off + cap])
            compared += int(decided.sum())
            ties += int((~decided).sum())
            differ += int((got[decided] != want[decided]).sum())
    worst = float(np.abs(cpu.centroids.numpy()
                         - card_engine.centroids.cpu().numpy()).max())
    counts_equal = bool(np.array_equal(cpu.counts.numpy(),
                                       card_engine.counts.cpu().numpy()))
    check(differ == 0, f"{differ} of {compared} decided assignments differ "
                       f"between the card and the CPU replay")
    check(worst <= CLUSTER_CENTROID_TOL,
          f"card vs CPU centroids {worst} > {CLUSTER_CENTROID_TOL}")
    check(cpu.step == card_engine.step
          and cpu.vectors == card_engine.vectors,
          f"replay at step {cpu.step} ({cpu.vectors} vectors), the card at "
          f"{card_engine.step} ({card_engine.vectors})")
    return {"observes": len(card_engine.calls), "replayed_chunks":
            cpu.step - card_engine.first_state["step"],
            "assignments_compared": compared, "near_ties": ties,
            "tie_margin": CLUSTER_TIE_MARGIN, "differ": differ,
            "centroids_max_abs_err": worst, "tol": CLUSTER_CENTROID_TOL,
            "counts_equal": counts_equal}


def check_resume(torch, cw, provider, frame):
    """Stop the worker (a final checkpoint); a new worker on the same
    provider resumes at the same step; a republished served batch is
    reassigned and rewritten but not folded again."""
    from distributed_crawler_tpu_torch.bus import (
        TOPIC_INFERENCE_RESULTS,
        InMemoryBus,
        RecordBatch,
    )
    from distributed_crawler_tpu_torch.cluster import ClusterWorker
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    cw.stop()
    step, vectors = cw.engine.step, cw.engine.vectors
    centroids = cw.engine.centroids.cpu()
    bus = InMemoryBus(sync=True)
    cw2 = ClusterWorker(bus, provider=provider, cfg=cw.cfg,
                        registry=MetricsRegistry())
    check(cw2.resumed and cw2.engine.step == step
          and cw2.engine.vectors == vectors,
          f"resumed at step {cw2.engine.step} ({cw2.engine.vectors} "
          f"vectors), stopped at {step} ({vectors})")
    check(torch.equal(cw2.engine.centroids.cpu(), centroids),
          "resumed centroids differ from the stopped worker's")
    check(frame["batch_id"] in cw2._folded, "folded window not resumed")
    rel = (f"{cw.cfg.storage_prefix}/{frame['crawl_id']}/batches/"
           f"{frame['batch_id']}.jsonl")
    old = provider.files.pop(rel)
    cw2.start()
    try:
        bus.publish(TOPIC_INFERENCE_RESULTS, frame)
        check(cw2.drain(timeout_s=60.0), "resumed worker did not drain")
    finally:
        cw2.stop()
    new = provider.get_text(rel)
    check(new is not None, "republished batch not rewritten")
    rows = [json.loads(ln) for ln in new.splitlines()]
    vecs, _ = ClusterWorker._extract(RecordBatch.from_dict(frame))
    check([r["cluster"] for r in rows] == cw2.engine.assign_only(vecs),
          "rewritten rows are not the current centroids' assignments")
    check(cw2.engine.step == step and cw2.engine.vectors == vectors,
          f"republished batch folded again: step {step} -> "
          f"{cw2.engine.step}")
    old_rows = [json.loads(ln) for ln in old.splitlines()]
    moved = sum(a["cluster"] != b["cluster"] for a, b in zip(old_rows, rows))
    return {"resumed_step": step, "vectors": vectors, "rows_rewritten":
            len(rows), "rows_moved_since_fold": moved,
            "step_after_republish": cw2.engine.step}


def check_e5_large_vs_cpu(torch, np, engine, texts, emb, scores, rng):
    """32 posts through E5-large in f32 on the CPU from the card's weights,
    bucketed as the engine buckets them, against the served bf16 results:
    the embeddings' minimum cosine, and the labels off near-ties."""
    from distributed_crawler_tpu_torch.models.encoder import (
        EmbedderClassifier,
    )
    from distributed_crawler_tpu_torch.ops.padding import (
        group_by_bucket,
        pack_batch,
    )

    pick = sorted(int(i) for i in rng.choice(len(texts), size=32,
                                             replace=False))
    toks = engine.tokenizer.encode_batch([texts[i] for i in pick])
    t0 = time.perf_counter()
    cpu_model = EmbedderClassifier(replace(engine.ecfg, dtype="float32"))
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in
                               engine.model.state_dict().items()})
    cpu_model.eval()
    c_emb = np.zeros((len(pick), engine.ecfg.hidden))
    c_scores = np.zeros((len(pick), engine.ecfg.n_labels))
    with torch.inference_mode():
        for _, idx in sorted(group_by_bucket(toks,
                                             engine.bucket_spec).items()):
            ids, mask = pack_batch([toks[i] for i in idx],
                                   engine.bucket_spec)
            e, logits = cpu_model(torch.from_numpy(ids),
                                  torch.from_numpy(mask))
            c_emb[idx] = e.double().numpy()
            c_scores[idx] = torch.softmax(logits.double(), dim=-1).numpy()
    cpu_s = time.perf_counter() - t0
    del cpu_model
    cos = _min_cosine(np, c_emb, emb[pick])
    clear = _top2_gap(np, -c_scores) > E5L_LABEL_MARGIN
    labels_differ = int((c_scores.argmax(axis=1)[clear]
                         != scores[pick].argmax(axis=1)[clear]).sum())
    check(cos >= E5L_MIN_COSINE,
          f"E5-large card bf16 vs CPU f32: min cosine {cos} < "
          f"{E5L_MIN_COSINE}")
    check(labels_differ == 0, f"{labels_differ} labels differ off near-ties")
    return {"posts": len(pick), "buckets": sorted(
        group_by_bucket(toks, engine.bucket_spec)), "min_cosine": cos,
        "bound": E5L_MIN_COSINE, "emb_max_abs_err": float(
            np.abs(c_emb - emb[pick]).max()),
        "scores_max_abs_err": float(np.abs(c_scores - scores[pick]).max()),
        "labels_compared": int(clear.sum()), "label_margin": E5L_LABEL_MARGIN,
        "labels_differ": labels_differ, "cpu_seconds": cpu_s}


def check_fit_step(torch, np, device, seed):
    """One `fit` step (assign + update) on the card against the CPU at
    N 65,536, D 1024, k 8, from the same centroids: assignments equal off
    near-ties, the update (on the card's assignments) within its
    tolerance; and the step's time on the card beside its bound."""
    from distributed_crawler_tpu_torch.models import clustering
    from distributed_crawler_tpu_torch.utils import cudatime

    rng = np.random.default_rng(seed + 8)
    centers = _unit_rows(np, rng.standard_normal((32, FIT_DIM)))
    x = unit_mixture(np, rng, centers, FIT_CHECK_N)
    c = x[:FIT_K].copy()
    xd, cd = torch.from_numpy(x).to(device), torch.from_numpy(c).to(device)
    a_card = clustering.assign(xd, cd)
    sums_card, counts_card = clustering.update(xd, a_card, FIT_K)
    a_card = a_card.cpu()
    xc, cc = torch.from_numpy(x), torch.from_numpy(c)
    decided = _top2_gap(np, clustering._pairwise_neg_scores(xc, cc).numpy()) \
        > CLUSTER_TIE_MARGIN
    a_cpu = clustering.assign(xc, cc).numpy()
    differ = int((a_card.numpy()[decided] != a_cpu[decided]).sum())
    sums_cpu, counts_cpu = clustering.update(xc, a_card, FIT_K)
    sum_err = float((sums_card.cpu() - sums_cpu).abs().max()
                    / sums_cpu.abs().max())
    check(differ == 0, f"fit step: {differ} decided assignments differ")
    check(torch.equal(counts_card.cpu(), counts_cpu), "fit step counts")
    check(sum_err <= CLUSTER_SUM_RTOL,
          f"fit step sums: {sum_err} > {CLUSTER_SUM_RTOL} of the largest")
    ms = cudatime.event_time_ms(lambda: clustering.update(
        xd, clustering.assign(xd, cd), FIT_K))
    return {"n": FIT_CHECK_N, "dim": FIT_DIM, "k": FIT_K,
            "assignments_compared": int(decided.sum()),
            "near_ties": int((~decided).sum()), "differ": differ,
            "sums_rel_err": sum_err, "tol": CLUSTER_SUM_RTOL, "step_ms": ms,
            "step_bytes_bound_ms": FIT_CHECK_N * FIT_DIM * 4
            / H100_BYTES_PER_S * 1e3}


def time_fit(torch, np, device, seed, smi):
    """`fit` at N 1,048,576 x D 1024 x k 8 x 25 iterations on the card
    (synthetic unit vectors from a seeded numpy mixture, 4.3 GB of f32):
    the whole fit by the host clock (the first call and a second one), the
    Lloyd iterations by CUDA events, beside the bytes bound of one
    iteration."""
    from distributed_crawler_tpu_torch.models import clustering

    rng = np.random.default_rng(seed + 9)
    t0 = time.perf_counter()
    centers = torch.from_numpy(_unit_rows(
        np, rng.standard_normal((32, FIT_DIM)))).to(device)
    ids = torch.from_numpy(rng.integers(0, 32, size=FIT_N)).to(device)
    # The noise as seeded numpy bytes (uniform int8, standard deviation
    # about 73.9), scaled on the card to the same norm as `unit_mixture`'s:
    # numpy's normal draws would take about 25 s for 1G values.
    noise = torch.frombuffer(bytearray(rng.bytes(FIT_N * FIT_DIM)),
                             dtype=torch.int8).to(device)
    x = centers[ids] + noise.view(FIT_N, FIT_DIM).float() \
        * (0.75 / (73.9 * FIT_DIM ** 0.5))
    del noise, ids
    x = clustering.l2_normalize(x)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    fit_s = []
    for _ in range(2):  # the first call, then again
        t0 = time.perf_counter()
        res = clustering.fit(x, FIT_K, iters=FIT_ITERS,
                             generator=torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device)
    t0 = time.perf_counter()
    seeds = clustering.kmeans_plus_plus_init(
        x, FIT_K, torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lloyd_ms = {}
    for iters in (0, FIT_ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = clustering._lloyd(x, seeds, FIT_K, iters)
        end.record()
        end.synchronize()
        lloyd_ms[iters] = start.elapsed_time(end)
        if iters == 0:
            inertia0 = out.inertia.item()
    counts = torch.bincount(res.assignments.long(), minlength=FIT_K)
    check(bool(torch.isfinite(res.centroids).all().item()),
          "fit centroids not finite")
    check(res.centroids.shape == (FIT_K, FIT_DIM)
          and int(counts.sum().item()) == FIT_N
          and counts.numel() == FIT_K, "fit assignments out of range")
    rerun_err = (out.centroids - res.centroids).abs().max().item()
    check(rerun_err <= 1e-5,
          f"fit is not its seeds plus the Lloyd iterations: {rerun_err}")
    inertia = res.inertia.item()
    check(inertia <= inertia0 * (1 + 1e-5),
          f"fit inertia {inertia} above its seeds' {inertia0}")
    per_iter = (lloyd_ms[FIT_ITERS] - lloyd_ms[0]) / FIT_ITERS
    read_ms = FIT_N * FIT_DIM * 4 / H100_BYTES_PER_S * 1e3
    row = {"n": FIT_N, "dim": FIT_DIM, "k": FIT_K, "iters": FIT_ITERS,
           "data_setup_s": data_s, "fit_first_s": fit_s[0],
           "fit_s": fit_s[1], "init_s": init_s,
           "lloyd_ms": lloyd_ms[FIT_ITERS], "final_assign_ms": lloyd_ms[0],
           "iter_ms": per_iter,
           "iter_bound_ms_one_read": read_ms,
           "iter_bound_ms_two_reads": 2 * read_ms,
           "iter_operations_bound_ms": 4.0 * FIT_N * FIT_DIM * FIT_K
           / H100_PEAK_FLOPS["float32"] * 1e3,
           "inertia": inertia, "inertia_at_seeds": inertia0,
           "rerun_centroids_max_abs_err": rerun_err,
           "sizes": counts.tolist(), "peak_gb": peak / 1e9, "card": smi}
    emit("times.fit", **row)
    del x, res, out, seeds
    torch.cuda.empty_cache()
    return row


def time_cluster_step(torch, np, state, frame, smi):
    """The cluster step per bucket (64, 256), for the rows of one served
    result frame: the host's share (the bus's JSON encode and decode,
    `RecordBatch.from_dict`, `_extract`, the float matrix, then
    `_dispatch_chunk`: pad, copy in, step, read back) against the step's
    device time (`cluster_step` replayed in a CUDA graph, and issued from
    Python)."""
    from distributed_crawler_tpu_torch.bus import RecordBatch
    from distributed_crawler_tpu_torch.bus.inmemory import serialize_payload
    from distributed_crawler_tpu_torch.cluster import (
        ClusterEngine,
        ClusterEngineConfig,
        ClusterWorker,
        cluster_step,
    )
    from distributed_crawler_tpu_torch.utils import cudatime
    from distributed_crawler_tpu_torch.utils.costmodel import (
        kmeans_step_flops,
    )
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    def host_ms(fn, reps=5):
        out, times = None, []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, sorted(times)[len(times) // 2]

    eng = ClusterEngine(ClusterEngineConfig(k=CLUSTER_K,
                                            buckets=CLUSTER_BUCKETS),
                        registry=MetricsRegistry())
    eng.load_state(state)
    k, d = eng.cfg.k, eng.dim
    rows = []
    for bucket in CLUSTER_BUCKETS:
        sub = dict(frame, records=frame["records"][:bucket],
                   results=frame["results"][:bucket])
        raw, encode_ms = host_ms(lambda: serialize_payload(sub))
        payload, decode_ms = host_ms(lambda: json.loads(raw.decode("utf-8")))
        batch, from_dict_ms = host_ms(lambda: RecordBatch.from_dict(payload))
        (vecs, _), extract_ms = host_ms(lambda: ClusterWorker._extract(batch))
        x, matrix_ms = host_ms(lambda: np.asarray(vecs, dtype=np.float32))
        _, dispatch_ms = host_ms(lambda: eng._dispatch_chunk(
            eng.centroids, eng.counts, x), reps=20)
        xd = torch.from_numpy(x).to(eng.device)
        md = torch.ones((bucket,), dtype=torch.float32, device=eng.device)
        fn = lambda: cluster_step(eng.centroids, eng.counts, xd, md, k,  # noqa: E731
                                  True)
        device_ms = cudatime.graph_time_ms(fn)
        eager_ms = cudatime.event_time_ms(fn)
        io_bytes = 4 * (bucket * d + bucket + 2 * k * d + 2 * k + bucket + 1)
        parts = {"bytes": io_bytes / H100_BYTES_PER_S * 1e3,
                 "operations": kmeans_step_flops(k, d, bucket)
                 / H100_PEAK_FLOPS["float32"] * 1e3}
        row = {"bucket": bucket, "dim": d, "k": k,
               "frame_bytes": len(raw), "json_encode_ms": encode_ms,
               "json_decode_ms": decode_ms, "from_dict_ms": from_dict_ms,
               "extract_ms": extract_ms, "matrix_ms": matrix_ms,
               "dispatch_ms": dispatch_ms, "device_ms": device_ms,
               "eager_ms": eager_ms, "bound_ms": bound_of(parts)[0],
               "bound_by": bound_of(parts)[1], "bound_parts_ms": parts,
               "host_ms": encode_ms + decode_ms + from_dict_ms + extract_ms
               + matrix_ms + dispatch_ms, "card": smi}
        rows.append(row)
        emit("times.cluster_step", **row)
    return rows


E5_LARGE_MODEL = "e5_large_12l"
E5_LARGE_LAYERS = 12


def phase_cluster(torch, np, attention, device, gen, seed, smi):
    """E5-large at full width through `TPUWorker`, the bus and
    `ClusterWorker` (BASELINE config #5); checks against the CPU, crash
    recovery; times."""
    from distributed_crawler_tpu_torch.bus import RecordBatch
    from distributed_crawler_tpu_torch.inference.engine import (
        EngineConfig,
        InferenceEngine,
    )
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    from distributed_crawler_tpu_torch.inference import engine as engine_mod

    t0 = time.perf_counter()
    # E5-large's widths at E5_LARGE_LAYERS of its 24 layers (the script's
    # budget; every check holds at any depth).
    engine_mod.MODEL_REGISTRY[E5_LARGE_MODEL] = replace(
        engine_mod.MODEL_REGISTRY["e5_large"], n_layers=E5_LARGE_LAYERS)
    cfg = EngineConfig(model=E5_LARGE_MODEL, batch_size=BATCH, seed=seed)
    engine = InferenceEngine(cfg, registry=MetricsRegistry())
    ecfg = engine.ecfg
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    check((ecfg.vocab_size, ecfg.hidden, ecfg.n_layers, ecfg.n_heads,
           ecfg.mlp_dim, ecfg.dtype) == (250037, 1024, E5_LARGE_LAYERS, 16,
                                         4096, "bfloat16"),
          f"not E5-large's full width at {E5_LARGE_LAYERS} layers: {ecfg}")
    check(engine.bucket_spec.lengths == MAIN_BUCKETS,
          f"buckets {engine.bucket_spec.lengths}")
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    emit("slice.cluster.setup", model=cfg.model, batch=BATCH,
         buckets=list(MAIN_BUCKETS), engine_init_s=init_s, warmup_s=warm_s,
         cluster={"k": CLUSTER_K, "buckets": list(CLUSTER_BUCKETS),
                  "checkpoint_every_batches": CLUSTER_CKPT_EVERY,
                  "coalesce_batches": 4})

    rng = np.random.default_rng(seed + 5)
    n_batches = 8
    batches = [RecordBatch.from_records(
        synthetic_posts(np, rng, BATCH, i * BATCH), crawl_id="smoke-e5l")
        for i in range(n_batches)]
    provider = DictProvider()
    served = serve_and_cluster(np, engine, batches, provider)
    emb, scores, _ = check_results(np, ecfg, batches, served["results"])
    sizes = check_assignment_rows(provider, batches, "smoke-e5l")
    update = check_updates(served["updates"])
    replay = replay_on_cpu(np, served["engine"])
    cengine = served["engine"]
    first_state = cengine.first_state
    frame = next(f for f in served["results"]
                 if f["batch_id"] == batches[0].batch_id)
    resume = check_resume(torch, served["worker"], provider, frame)
    texts = [t for b in batches for t in b.texts()]
    vs_cpu = check_e5_large_vs_cpu(torch, np, engine, texts, emb, scores,
                                   rng)
    fit_step = check_fit_step(torch, np, device, seed)
    n_posts = emb.shape[0]
    emit("slice.cluster", posts=n_posts, batches=n_batches,
         result_frames=len(served["results"]),
         dispatches=served["dispatches"],
         kernel_launches_by_path=served["launches"],
         launches_per_dispatch=served["launches"]["sm90"]
         / served["dispatches"],
         cluster_group_batches=[len(g) for g in served["groups"]],
         cluster_sizes=sizes,
         cluster_steps=cengine.step, last_update=update,
         card_vs_cpu_replay=replay, resume=resume,
         e5_large_card_bf16_vs_cpu_f32=vs_cpu, fit_step=fit_step)
    process_ms = served["process_ms"]
    emit("times.slice", model="e5_large+cluster", posts=n_posts,
         seconds=served["seconds"], posts_per_s=n_posts / served["seconds"],
         cluster_process_ms=process_ms,
         cluster_device_timeline=served["device"], card=smi)
    time_cluster_step(torch, np, first_state, frame, smi)
    time_fit(torch, np, device, seed, smi)
    time_engine(torch, engine, smi, model=cfg.model)
    del engine
    torch.cuda.empty_cache()
    rows = model_kernel_times(torch, attention, device, gen, smi, "e5_large",
                              E5L_HEADS, E5L_HEAD_DIM)
    emit("times.kernel.sum", name="flash_attention", model="e5_large",
         at="16 heads of 64, batch 256, bf16, serving padding: one call at "
            "each of buckets 32-512, summed",
         ms=sum(r["ms"] for r in rows),
         mma_sync_ms=sum(r["mma_sync_ms"] for r in rows),
         plain_ms=sum(r["plain_ms"] for r in rows),
         library_ms=sum(r["library_ms"] for r in rows),
         bound_parts_ms={p: sum(r["bound_parts_ms"][p] for r in rows)
                         for p in rows[0]["bound_parts_ms"]},
         max_abs_err=max(r["max_abs_err"]["sm90"] for r in rows), card=smi)
    return {"launches": served["launches"],
            "dispatches": served["dispatches"], "kernel_rows": rows}


# -- phase 9: Switch-MoE at XLM-R-base width with 8 experts ------------------
# `bench.py`'s MoE configuration (`_measure_moe`): XLM-R-base's widths, 8
# experts, capacity factor 1.25, at the published vocabulary.  No preset
# has experts: a deployment adds the entry to the registry, as here.
MOE_MODEL = "xlmr_base_moe8"
MOE_EXPERTS, MOE_CF = 8, 1.25
# Depth cut to 6 of XLM-R-base's 12 layers (widths the published ones) to
# keep the script inside its time budget; the dense yardstick is cut alike.
MOE_LAYERS = 6
MOE_YARDSTICK = "xlmr_base_6l"
# A token whose f32 top-1 router probability leads the second by less
# than this is a near-tie: bf16 rounding may pick either expert.
MOE_NEAR_TIE = 1e-3
MOE_DISPATCHES = ("dense", "capacity", "int8")
# Served per dispatch: 4 batches of 256 posts, one coalesced group (the
# served runs took 17.5 s at 8 batches; every check reads these posts).
MOE_SERVED_BATCHES = 4


def moe_config():
    from distributed_crawler_tpu_torch.models.encoder import XLMR_BASE

    return replace(XLMR_BASE, n_layers=MOE_LAYERS, n_experts=MOE_EXPERTS,
                   moe_capacity_factor=MOE_CF)


def _moe_inputs(model):
    """Forward hooks that keep each layer's MoE input, its mask, and which
    tokens got an expert's output (capacity dispatch drops the rest)."""
    got = []
    hooks = [layer.moe.register_forward_hook(
        lambda mod, args, out: got.append(
            (args[0], args[1], (out != 0).any(-1))))
        for layer in model.encoder.layers]
    return got, hooks


def _routes(torch, layers, inputs):
    """(top, margin) per layer of each layer's router on its input: the
    expert chosen and the f32 lead of the top-1 probability."""
    out = []
    with torch.inference_mode():
        for layer, (x, *_) in zip(layers, inputs):
            probs, top = layer.moe.route(x)
            top2 = probs.topk(2, dim=-1).values
            out.append((top.cpu(), (top2[..., 0] - top2[..., 1]).cpu()))
    return out


def _run_with_inputs(torch, model, arrays, device, **kw):
    """One forward with the MoE inputs recorded: (emb, inputs)."""
    inputs, hooks = _moe_inputs(model)
    try:
        with torch.inference_mode():
            t = [torch.from_numpy(a).to(device) for a in arrays]
            extra = dict(zip(("segment_ids", "positions"), t[2:]))
            emb, _ = model(t[0], t[1], **extra, **kw)
    finally:
        for h in hooks:
            h.remove()
    return emb, inputs


def _cpu_twin(torch, engine):
    """The engine's model in f32 on the CPU, from its state."""
    from distributed_crawler_tpu_torch.models.encoder import (
        EmbedderClassifier,
    )

    model = EmbedderClassifier(replace(engine.ecfg, dtype="float32"))
    model.load_state_dict({k: v.float().cpu()
                           for k, v in engine.model.state_dict().items()})
    return model.eval()


def check_moe_dense_vs_cpu(torch, np, engine, toks, rng):
    """32 posts in bf16 on the card against f32 on the CPU, each bucket's
    posts in one batch: minimum cosine of the embeddings; the router's
    choices token by token, on the same layer inputs (the card's, which
    must agree off near-ties) and free-running (each side its own
    inputs: counted, not held)."""
    from distributed_crawler_tpu_torch.ops.padding import (
        BucketSpec,
        bucket_for,
        pack_batch,
    )

    cpu = _cpu_twin(torch, engine)
    pick = [int(i) for i in rng.choice(len(toks), size=32, replace=False)]
    by_bucket = {}
    for i in pick:
        by_bucket.setdefault(bucket_for(len(toks[i]), engine.bucket_spec),
                             []).append(i)
    cos, real = [], 0
    same = {"decided": 0, "near_ties": 0, "differ_off_ties": 0}
    free = {"decided": 0, "near_ties": 0, "differ": 0, "differ_off_ties": 0}
    for bucket, idx in sorted(by_bucket.items()):
        ids, mask = pack_batch([toks[i] for i in idx], BucketSpec((bucket,)))
        g_emb, g_in = _run_with_inputs(torch, engine.model, (ids, mask),
                                       engine.device)
        c_emb, c_in = _run_with_inputs(torch, cpu, (ids, mask), "cpu")
        cos.append(_min_cosine(np, g_emb.float().cpu().numpy(),
                               c_emb.numpy()))
        real_t = torch.from_numpy(mask)
        real += int(real_t.sum())
        g_routes = _routes(torch, engine.model.encoder.layers, g_in)
        c_routes = _routes(torch, cpu.encoder.layers, c_in)
        same_in = [(x.float().cpu(),) for x, *_ in g_in]
        s_routes = _routes(torch, cpu.encoder.layers, same_in)
        for (gt, _), (ct, cm), (st, sm) in zip(g_routes, c_routes, s_routes):
            tie = (sm < MOE_NEAR_TIE) & real_t
            off = ~(sm < MOE_NEAR_TIE) & real_t
            same["decided"] += int(real_t.sum())
            same["near_ties"] += int(tie.sum())
            same["differ_off_ties"] += int(((gt != st) & off).sum())
            ctie = (cm < MOE_NEAR_TIE) & real_t
            diff = (gt != ct) & real_t
            free["decided"] += int(real_t.sum())
            free["near_ties"] += int(ctie.sum())
            free["differ"] += int(diff.sum())
            free["differ_off_ties"] += int((diff & ~ctie).sum())
    out = {"posts": len(pick), "real_tokens": real, "min_cosine": min(cos),
           "bound": 0.99, "near_tie_margin": MOE_NEAR_TIE,
           "router_same_inputs": same, "router_free_running": free}
    emit("slice.moe.dense_vs_cpu", **out)
    check(out["min_cosine"] >= 0.99, f"MoE dense: card bf16 vs CPU f32 "
                                     f"minimum cosine {out['min_cosine']}")
    check(same["differ_off_ties"] == 0,
          f"MoE router on the same inputs: {same['differ_off_ties']} tokens "
          f"pick another expert off a {MOE_NEAR_TIE} margin")
    del cpu
    return out


def check_capacity_vs_dense(torch, np, dense, capacity, toks):
    """Capacity against dense dispatch on the same [256, bucket] layout
    on the card, per bucket: at capacity factor 8 (nothing overflows) the
    embeddings within 2e-2; at 1.25, each layer's MoE on the dense
    forward's own layer inputs: the share of real tokens dropped, and
    every kept token's output within 2e-2 of dense dispatch's."""
    from distributed_crawler_tpu_torch.models.encoder import (
        EmbedderClassifier,
    )
    from distributed_crawler_tpu_torch.ops.padding import (
        BucketSpec,
        bucket_for,
        pack_batch,
    )

    tol = 2e-2
    roomy = EmbedderClassifier(
        replace(capacity.ecfg, moe_capacity_factor=8.0),
        embed_dtype=capacity.model.encoder.embed_tokens.dtype)
    roomy.load_state_dict(capacity.model.state_dict())
    roomy = roomy.to(capacity.device).eval()
    rows = []
    for bucket in MAIN_BUCKETS:
        chunk = [t for t in toks
                 if bucket_for(len(t), dense.bucket_spec) == bucket][:BATCH]
        ids, mask = pack_batch(chunk, BucketSpec((bucket,)),
                               batch_pad_to=BATCH)
        d_emb, inputs = _run_with_inputs(torch, dense.model, (ids, mask),
                                         dense.device)
        r_emb, _ = _run_with_inputs(torch, roomy, (ids, mask),
                                    dense.device)
        roomy_err = float((r_emb.float() - d_emb.float()).abs().max())
        dropped = real = 0
        kept_err = 0.0
        with torch.inference_mode():
            for layer_d, layer_c, (x, m, _) in zip(
                    dense.model.encoder.layers,
                    capacity.model.encoder.layers, inputs):
                d_out = layer_d.moe(x, m).float()
                c_out = layer_c.moe(x, m).float()
                real_t = m.bool()
                kept = c_out.abs().amax(-1) > 0
                dropped += int((real_t & ~kept).sum())
                real += int(real_t.sum())
                sel = real_t & kept
                kept_err = max(kept_err, float(
                    (c_out[sel] - d_out[sel]).abs().max()))
        row = {"bucket": bucket, "rows": len(chunk),
               "cf8_emb_max_abs_err": roomy_err, "real_token_layers": real,
               "dropped": dropped, "dropped_share": dropped / real,
               "kept_max_abs_err": kept_err, "tol": tol}
        emit("slice.moe.capacity_vs_dense", **row)
        check(roomy_err <= tol, f"capacity factor 8 vs dense at {bucket}: "
                                f"{roomy_err} > {tol}")
        check(kept_err <= tol, f"capacity vs dense kept tokens at {bucket}: "
                               f"{kept_err} > {tol}")
        rows.append(row)
        del inputs
    del roomy
    torch.cuda.empty_cache()
    return rows


class _DispatchRecorder:
    """While active, keeps each of the engine's dispatches: the host
    arrays it placed, its keywords and its host outputs."""

    def __init__(self, np, engine):
        self.np, self.engine, self.dispatches = np, engine, []
        self._arrays = None

    def __enter__(self):
        eng, place, dispatch = self.engine, self.engine._place, \
            self.engine._dispatch

        def recording_place(arrays):
            self._arrays = [self.np.array(a) for a in arrays]
            return place(arrays)

        def recording_dispatch(placed, **kw):
            out = dispatch(placed, **kw)
            self.dispatches.append((self._arrays, kw, out))
            return out

        eng._place, eng._dispatch = recording_place, recording_dispatch
        return self

    def __exit__(self, *exc):
        del self.engine._place, self.engine._dispatch


def _segments_used(np, arrays):
    seg = arrays[2]
    return int(sum(len(np.unique(r[r > 0])) for r in seg))


def replay_capacity_on_cpu(torch, np, engine, recorder):
    """One served capacity dispatch again in f32 on the CPU, from the exact
    arrays the worker dispatched (of the smallest bucket, the one with the
    most segments).

    - Layer by layer on the card's own layer inputs: the CPU's router
      agrees off near-ties, and every real token that both sides route
      alike and keep carries the card's expert output (cosine >= 0.99).
    - End to end, each side from its own inputs: bf16 drift moves some
      routes past any fixed margin, and a token routed or dropped
      otherwise at any layer changes its segment's pooled embedding (past
      capacity it also moves its group's queue).  The minimum cosine
      against the served embeddings is held over the segments no such
      token touches and reported over all."""
    arrays, kw, (emb, _, event) = min(
        recorder.dispatches,
        key=lambda d: (d[0][0].shape[1], -_segments_used(np, d[0])))
    if event is not None:
        event.synchronize()
    served = emb.float().numpy()
    n_seg, hid = served.shape[1], served.shape[2]
    served = served.reshape(-1, hid)
    cpu = _cpu_twin(torch, engine)
    c_emb, c_in = _run_with_inputs(torch, cpu, arrays, "cpu", **kw)
    g_emb, g_in = _run_with_inputs(torch, engine.model, arrays,
                                   engine.device, **kw)
    c_emb = c_emb.numpy().reshape(-1, hid)
    real_t = torch.from_numpy(arrays[1]).bool()

    forced = {"decided": 0, "near_ties": 0, "near_tie_flips": 0,
              "differ_off_ties": 0, "drop_differs": 0, "compared": 0,
              "min_cosine": 1.0}
    with torch.inference_mode():
        for c_layer, g_layer, (x, m, g_kept) in zip(
                cpu.encoder.layers, engine.model.encoder.layers, g_in):
            g_out = g_layer.moe(x, m).float().cpu()
            _, g_top = g_layer.moe.route(x)
            xc, mc = x.float().cpu(), m.cpu()
            c_out = c_layer.moe(xc, mc)
            probs, c_top = c_layer.moe.route(xc)
            top2 = probs.topk(2, dim=-1).values
            tie = (top2[..., 0] - top2[..., 1]) < MOE_NEAR_TIE
            flip = (g_top.cpu() != c_top) & real_t
            drop_diff = (g_kept.cpu() != (c_out != 0).any(-1)) & real_t
            ok = real_t & ~flip & ~drop_diff & g_kept.cpu()
            forced["decided"] += int(real_t.sum())
            forced["near_ties"] += int((tie & real_t).sum())
            forced["near_tie_flips"] += int((flip & tie).sum())
            forced["differ_off_ties"] += int((flip & ~tie).sum())
            forced["drop_differs"] += int(drop_diff.sum())
            forced["compared"] += int(ok.sum())
            cos = torch.nn.functional.cosine_similarity(
                g_out[ok], c_out[ok], dim=-1)
            forced["min_cosine"] = min(forced["min_cosine"],
                                       float(cos.min()))

    touched = torch.zeros_like(real_t)
    free = {"decided": 0, "near_ties": 0, "differ": 0,
            "differ_off_ties": 0, "drop_differs": 0, "dropped_card": 0}
    for (gt, _), (ct, cm), (_, _, g_kept), (_, _, c_kept) in zip(
            _routes(torch, engine.model.encoder.layers, g_in),
            _routes(torch, cpu.encoder.layers, c_in), g_in, c_in):
        g_kept = g_kept.cpu()
        tie = (cm < MOE_NEAR_TIE) & real_t
        diff = (gt != ct) & real_t
        drop_diff = (g_kept != c_kept) & real_t
        touched |= diff | drop_diff
        free["decided"] += int(real_t.sum())
        free["near_ties"] += int(tie.sum())
        free["differ"] += int(diff.sum())
        free["differ_off_ties"] += int((diff & ~tie).sum())
        free["drop_differs"] += int(drop_diff.sum())
        free["dropped_card"] += int((real_t & ~g_kept).sum())
    seg = arrays[2]
    rows, cols = np.nonzero(touched.numpy() & (seg > 0))
    touched_seg = np.zeros(served.shape[0], bool)
    touched_seg[rows * n_seg + seg[rows, cols] - 1] = True
    used = np.linalg.norm(c_emb, axis=1) > 0
    clean = used & ~touched_seg
    rerun_err = float(np.abs(g_emb.float().cpu().numpy().reshape(
        served.shape) - served).max())
    out = {"bucket": int(arrays[0].shape[1]),
           "rows": int(arrays[0].shape[0]), "segments": int(used.sum()),
           "layer_by_layer_on_card_inputs": forced,
           "end_to_end": {
               "router": free, "untouched_segments": int(clean.sum()),
               "min_cosine_untouched": _min_cosine(np, served[clean],
                                                   c_emb[clean]),
               "min_cosine_all": _min_cosine(np, served[used],
                                             c_emb[used])},
           "bound": 0.99, "card_rerun_max_abs_err": rerun_err}
    emit("slice.moe.capacity_replay", **out)
    check(forced["differ_off_ties"] == 0,
          f"capacity replay: {forced['differ_off_ties']} tokens routed "
          f"otherwise off a {MOE_NEAR_TIE} margin on the same inputs")
    check(forced["min_cosine"] >= 0.99,
          f"capacity replay: expert outputs on the card's inputs, minimum "
          f"cosine {forced['min_cosine']}")
    check(clean.sum() >= 10,
          f"capacity replay: only {clean.sum()} of {used.sum()} segments "
          f"untouched by a routing difference")
    check(out["end_to_end"]["min_cosine_untouched"] >= 0.99,
          f"capacity replay: card vs CPU f32 minimum cosine "
          f"{out['end_to_end']['min_cosine_untouched']} over untouched "
          f"segments")
    del cpu
    return out


# A quantized layer on the card against the same layer on the CPU, both
# bf16 with the same int8 accumulators: bf16 rounding (2^-8 relative) of
# the outputs and of the attention's softmax; per-post cosine.
QUANT_CARD_VS_CPU = 0.999


def check_quantized_vs_bf16(torch, np, bf16, quantized, toks, bound,
                            served=None):
    """A quantized MoE engine against bf16 dense dispatch on the same
    weights, per bucket on the same [256, bucket] layout:

    - layer by layer on the bf16 forward's own inputs: each post's MoE
      output (the int8 experts, dynamic in both modes; both f32 routers
      pick the same experts on the same input), cosine > ``bound``; its
      attention output (the int8 projections), cosine > ``bound`` under
      dynamic scales.  Under ``int8_static`` the attention's cosine is
      reported, not held: the reference calibrates on full-length
      sequences, so a short post's attention output overflows the
      calibrated ``attn_out`` scale and clips (ROADMAP Queue 3).  What is
      held there is the card's quantized attention against the same
      layer on the CPU, at the shortest bucket (> QUANT_CARD_VS_CPU);
    - end to end: int8 noise in the router's input moves routes, and a
      token sent to another expert carries another MLP's output, so the
      embeddings' cosines are reported (minimum, percentiles) with the
      posts no routing difference touches counted apart; ``served``
      (each engine's served embeddings) adds the served posts' minimum."""
    import copy

    from distributed_crawler_tpu_torch.ops.padding import (
        BucketSpec,
        bucket_for,
        pack_batch,
    )

    def cos_min(a, b, real):
        """Minimum over posts of the cosine between two [L, H] outputs
        of a post's real tokens, each taken as one vector (a per-token
        cosine would single out tokens whose output is near zero)."""
        real = real.to(a.device)
        keep = real[..., None].float()
        a = (a.float() * keep).flatten(1)
        b = (b.float().to(a.device) * keep).flatten(1)
        return float(torch.nn.functional.cosine_similarity(
            a, b, dim=-1)[real.any(1)].min())

    static = quantized.ecfg.quant == "int8_static"
    forced = {"tokens": 0, "routes_differ": 0, "min_cosine": 1.0,
              "attention_min_cosine": 1.0, "over": "posts",
              "attention_card_vs_cpu_min_cosine": 1.0,
              "attention_card_vs_cpu_bucket": MAIN_BUCKETS[0]}
    cos_all, cos_clean = [], []
    with torch.inference_mode():
        for bucket in MAIN_BUCKETS:
            chunk = [t for t in toks
                     if bucket_for(len(t), bf16.bucket_spec) == bucket][:BATCH]
            ids, mask = pack_batch(chunk, BucketSpec((bucket,)),
                                   batch_pad_to=BATCH)
            layer_in = []
            hooks = [layer.register_forward_pre_hook(
                lambda mod, args: layer_in.append(args[0]))
                for layer in bf16.model.encoder.layers]
            try:
                b_emb, b_in = _run_with_inputs(torch, bf16.model,
                                               (ids, mask), bf16.device)
            finally:
                for h in hooks:
                    h.remove()
            q_emb, q_in = _run_with_inputs(torch, quantized.model,
                                           (ids, mask), quantized.device)
            real_t = torch.from_numpy(mask).to(bf16.device)
            touched = torch.zeros_like(real_t)
            for b_layer, q_layer, (x, m, _), (xq, _, _), xa in zip(
                    bf16.model.encoder.layers,
                    quantized.model.encoder.layers, b_in, q_in, layer_in):
                q_attn = q_layer.attn(xa, m)
                forced["attention_min_cosine"] = min(
                    forced["attention_min_cosine"],
                    cos_min(q_attn, b_layer.attn(xa, m), real_t))
                if bucket == MAIN_BUCKETS[0]:
                    cpu_attn = copy.deepcopy(q_layer.attn).cpu()
                    forced["attention_card_vs_cpu_min_cosine"] = min(
                        forced["attention_card_vs_cpu_min_cosine"],
                        cos_min(cpu_attn(xa.cpu(), m.cpu()), q_attn,
                                real_t))
                _, b_top = b_layer.moe.route(x)
                _, q_top = q_layer.moe.route(x)
                forced["routes_differ"] += int(((b_top != q_top)
                                                & real_t).sum())
                forced["tokens"] += int(real_t.sum())
                forced["min_cosine"] = min(
                    forced["min_cosine"],
                    cos_min(q_layer.moe(x, m), b_layer.moe(x, m), real_t))
                touched |= (q_layer.moe.route(xq)[1] != b_top) & real_t
            n = len(chunk)
            cos = _cosines(np, q_emb.float().cpu().numpy()[:n],
                           b_emb.float().cpu().numpy()[:n])
            cos_all.extend(cos.tolist())
            cos_clean.extend(cos[~touched.any(1).cpu().numpy()[:n]].tolist())
            del b_in, q_in, layer_in
    torch.cuda.empty_cache()
    cos_all = np.asarray(cos_all)
    out = {"posts": int(cos_all.size), "bound": bound,
           "card_vs_cpu_bound": QUANT_CARD_VS_CPU,
           "attention_vs_bf16_held": not static,
           "layer_by_layer_on_bf16_inputs": forced,
           "end_to_end": {
               "min_cosine": float(cos_all.min()),
               "p1_cosine": float(np.percentile(cos_all, 1)),
               "median_cosine": float(np.median(cos_all)),
               "posts_untouched_by_routing": len(cos_clean),
               "min_cosine_untouched": (float(min(cos_clean))
                                        if cos_clean else None)}}
    if served is not None:
        out["end_to_end"]["served_posts"] = int(served[0].shape[0])
        out["end_to_end"]["served_min_cosine"] = _min_cosine(np, *served)
    emit("slice.moe.quantized_vs_bf16", quant=quantized.ecfg.quant, **out)
    check(forced["routes_differ"] == 0,
          "the same layer input routed otherwise by the two models")
    check(forced["min_cosine"] > bound,
          f"{quantized.ecfg.quant} vs bf16 on the same inputs: MoE outputs' "
          f"minimum cosine {forced['min_cosine']}")
    check(static or forced["attention_min_cosine"] > bound,
          f"{quantized.ecfg.quant} vs bf16 on the same inputs: attention's "
          f"minimum cosine {forced['attention_min_cosine']}")
    check(forced["attention_card_vs_cpu_min_cosine"] > QUANT_CARD_VS_CPU,
          f"{quantized.ecfg.quant} attention, card vs CPU: minimum cosine "
          f"{forced['attention_card_vs_cpu_min_cosine']}")
    return out


def check_moe_int8_products(torch, engine, gen):
    """Layer 0's int8 expert products on the card against an int32 matmul
    on the CPU, on 64 rows of quantized activations: exactly equal."""
    from distributed_crawler_tpu_torch.ops.quant import (
        int8_matmul,
        quantize_activations,
    )

    moe = engine.model.encoder.layers[0].moe
    e, m, h = moe.experts_up_q.shape
    weights = [("experts_up", moe.experts_up_q.reshape(e * m, h))]
    weights += [(f"experts_down[{i}]", moe.experts_down_q[i])
                for i in range(e)]
    out = {}
    for name, w_q in weights:
        x = torch.randn((64, w_q.shape[1]), generator=gen).to(
            device=engine.device, dtype=torch.bfloat16)
        x_q, _ = quantize_activations(x)
        acc = int8_matmul(x_q, w_q)
        torch.cuda.synchronize()
        want = x_q.cpu().to(torch.int32) @ w_q.cpu().to(torch.int32).t()
        check(acc.dtype == torch.int32 and torch.equal(acc.cpu(), want),
              f"int8 product {name}: card and CPU int32 matmul differ")
        out[name] = {"m": 64, "k": int(w_q.shape[1]), "n": int(w_q.shape[0]),
                     "equal": True}
    return out


def check_capacity_int8_refused(engine_mod):
    """``capacity`` with ``quantize`` raises ValueError before any weight
    is read or drawn."""
    def no_weights(*a, **k):
        raise Fail("weights were loaded before the config was refused")

    saved = engine_mod.random_tree, engine_mod._load_pretrained
    engine_mod.random_tree = engine_mod._load_pretrained = no_weights
    try:
        engine_mod.InferenceEngine(engine_mod.EngineConfig(
            model=MOE_MODEL, moe_dispatch="capacity", quantize="int8"))
    except ValueError as e:
        return str(e)
    finally:
        engine_mod.random_tree, engine_mod._load_pretrained = saved
    raise Fail("capacity dispatch with int8 was not refused")


# Phase 9's layer timings: CUDA-event loops of at least 50 ms or one call
# (its forwards use `time_engine`'s ``quick`` timing, alike): the int8
# engine's forward at bucket 512 takes seconds, and phase 4's three-call
# loops and warm-ups made `time_moe` 28.3 s.
MOE_TIME_MIN_S, MOE_TIME_MIN_ITERS = 0.05, 1


def time_moe(torch, engines, yardstick, smi):
    """Per bucket at batch 256: each dispatch's forward (from
    `time_engine`) with its MoE FLOP count, achieved TFLOP/s and peak
    device memory; XLM-R-base's dense-MLP forward at the same depth beside
    it; layer 0's MoE alone against the dense MLP."""
    from distributed_crawler_tpu_torch.utils import cudatime
    from distributed_crawler_tpu_torch.utils.costmodel import (
        encoder_forward_flops,
        moe_forward_flops,
    )

    forward = {name: {r["bucket"]: r for r in time_engine(
        torch, eng, smi, quick=True, model=MOE_MODEL, dispatch=name)}
        for name, eng in engines.items()}
    yardstick.warmup(pack=False)
    base = {r["bucket"]: r for r in time_engine(
        torch, yardstick, smi, quick=True, model=MOE_YARDSTICK,
        dispatch="dense_mlp")}
    rows = []
    for bucket in MAIN_BUCKETS:
        row = {"bucket": bucket, "batch": BATCH, "card": smi,
               "xlmr_base_forward_ms": base[bucket]["forward_ms"],
               "xlmr_base_tflop_per_s": encoder_forward_flops(
                   yardstick.ecfg, BATCH, bucket)
               / (base[bucket]["forward_ms"] * 1e-3) / 1e12}
        ids = torch.full((BATCH, bucket), 5, dtype=torch.int32,
                         device=yardstick.device)
        mask = torch.ones_like(ids)
        x = torch.randn((BATCH, bucket, yardstick.ecfg.hidden),
                        device=yardstick.device, dtype=torch.bfloat16)
        with torch.inference_mode():
            row["mlp_layer_ms"] = cudatime.event_time_ms(
                lambda: yardstick.model.encoder.layers[0].mlp(x),
                min_total_s=MOE_TIME_MIN_S, min_iters=MOE_TIME_MIN_ITERS,
                max_iters=20)
            for name, eng in engines.items():
                flops = moe_forward_flops(eng.ecfg, BATCH, bucket,
                                          eng.ecfg.moe_dispatch)
                ms = forward[name][bucket]["forward_ms"]
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                eng.model(ids, mask)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                moe = eng.model.encoder.layers[0].moe
                layer_ms = cudatime.event_time_ms(
                    lambda: moe(x, mask), min_total_s=MOE_TIME_MIN_S,
                    min_iters=MOE_TIME_MIN_ITERS, max_iters=20)
                row[name] = {
                    "forward_ms": ms,
                    "batch_ms": forward[name][bucket]["batch_ms"],
                    "forward_over_xlmr_base": ms / row[
                        "xlmr_base_forward_ms"],
                    "flops": flops, "tflop_per_s": flops / (ms * 1e-3) / 1e12,
                    "peak_memory_gb": peak / 1e9,
                    "forward_extra_memory_gb": (peak - resident) / 1e9,
                    "moe_layer_ms": layer_ms,
                    "moe_layer_over_mlp": layer_ms / row["mlp_layer_ms"]}
        rows.append(row)
        emit("times.moe", model=MOE_MODEL, **row)
        del ids, mask, x
        torch.cuda.empty_cache()
    return rows


def phase_moe(torch, np, device, gen, seed, smi):
    """Switch-MoE at XLM-R-base width with 8 experts, served through
    `TPUWorker` in dense, capacity and int8 dispatch on the same seeded
    bf16 weights; the checks of each dispatch; times."""
    from distributed_crawler_tpu_torch.bus import RecordBatch
    from distributed_crawler_tpu_torch.inference import engine as engine_mod
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    refused = check_capacity_int8_refused(engine_mod)
    engine_mod.MODEL_REGISTRY[MOE_MODEL] = moe_config()
    engine_mod.MODEL_REGISTRY[MOE_YARDSTICK] = replace(
        engine_mod.MODEL_REGISTRY["xlmr_base"], n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    ecfg0 = engine_mod.EngineConfig(model=MOE_MODEL).encoder_config()
    tree = engine_mod.random_tree(ecfg0, seed)
    tree_s = time.perf_counter() - t0

    def make(model=MOE_MODEL, params=tree, **kw):
        t = time.perf_counter()
        eng = engine_mod.InferenceEngine(engine_mod.EngineConfig(
            model=model, batch_size=BATCH, seed=seed,
            param_dtype="bfloat16", **kw), params=params,
            registry=MetricsRegistry())
        check(eng.device.type == "cuda", f"engine on {eng.device}")
        return eng, time.perf_counter() - t

    engines, init_s = {}, {}
    for name, kw in (("dense", {"moe_dispatch": "dense"}),
                     ("capacity", {"moe_dispatch": "capacity"}),
                     ("int8", {"moe_dispatch": "dense",
                               "quantize": "int8"})):
        engines[name], init_s[name] = make(**kw)
    ecfg = engines["dense"].ecfg
    check((ecfg.vocab_size, ecfg.hidden, ecfg.n_layers, ecfg.n_heads,
           ecfg.mlp_dim, ecfg.n_experts, ecfg.moe_capacity_factor,
           ecfg.n_labels, ecfg.dtype) == (250002, 768, MOE_LAYERS, 12, 3072,
                                          8, 1.25, 8, "bfloat16"),
          f"not XLM-R-base's width with 8 experts: {ecfg}")
    check([e.ecfg.moe_dispatch for e in engines.values()]
          == ["dense", "capacity", "dense"]
          and engines["int8"].ecfg.quant == "int8",
          "dispatch or quantization not applied")
    t0 = time.perf_counter()
    for eng in engines.values():
        eng.warmup()
    torch.cuda.synchronize()
    emit("slice.moe.setup", model=MOE_MODEL, batch=BATCH,
         buckets=list(MAIN_BUCKETS), experts=MOE_EXPERTS,
         capacity_factor=MOE_CF, random_tree_s=tree_s, engine_init_s=init_s,
         warmup_s=time.perf_counter() - t0, capacity_int8_refused=refused)

    rng = np.random.default_rng(seed + 9)
    batches = [RecordBatch.from_records(
        synthetic_posts(np, rng, BATCH, i * BATCH), crawl_id="smoke-moe")
        for i in range(MOE_SERVED_BATCHES)]
    served = {}
    t_served = time.perf_counter()
    for name, eng in engines.items():
        if name == "capacity":
            with _DispatchRecorder(np, eng) as recorder:
                served[name] = serve_batches(np, eng, batches)
        else:
            served[name] = serve_batches(np, eng, batches)
        torch.cuda.empty_cache()
    served_s = time.perf_counter() - t_served
    texts = [t for b in batches for t in b.texts()]
    toks = engines["dense"].tokenizer.encode_batch(texts)

    vs_cpu = check_moe_dense_vs_cpu(torch, np, engines["dense"], toks, rng)
    cap_rows = check_capacity_vs_dense(torch, np, engines["dense"],
                                       engines["capacity"], toks)
    replay = replay_capacity_on_cpu(torch, np, engines["capacity"], recorder)
    recorder.dispatches.clear()
    int8_vs = check_quantized_vs_bf16(
        torch, np, engines["dense"], engines["int8"], toks, 0.98,
        served=(served["int8"]["emb"], served["dense"]["emb"]))
    products = check_moe_int8_products(torch, engines["int8"], gen)
    static, init_s["int8_static"] = make(moe_dispatch="dense",
                                         quantize="int8_static")
    check(static.ecfg.quant == "int8_static", "int8_static not applied")
    static_vs = check_quantized_vs_bf16(torch, np, engines["dense"], static,
                                        toks, 0.97)
    del static
    torch.cuda.empty_cache()

    launches = {p: sum(s["launches_by_path"][p] for s in served.values())
                for p in served["dense"]["launches_by_path"]}
    dispatches = sum(s["dispatches"] for s in served.values())
    emit("slice.moe", records=len(texts), batches=len(batches),
         served={name: {"result_frames": s["result_frames"],
                        "dispatches": s["dispatches"],
                        "kernel_launches_by_path": s["launches_by_path"],
                        "launches_per_dispatch":
                            s["launches"] / s["dispatches"],
                        "coalesced_groups": s["coalesced_groups"]}
                 for name, s in served.items()},
         dense_card_bf16_vs_cpu_f32=vs_cpu, capacity_vs_dense=cap_rows,
         capacity_replay_on_cpu=replay,
         int8_vs_bf16=int8_vs, int8_static_vs_bf16=static_vs,
         int8_products=products, engine_init_s=init_s)
    for name, s in served.items():
        emit("times.slice", model=MOE_MODEL, dispatch=name,
             posts=s["emb"].shape[0], seconds=s["seconds"],
             posts_per_s=s["posts_per_s"],
             p50_batch_latency_ms=s["p50_ms"],
             dispatch_latencies=s["latencies"], card=smi)
    yardstick, _ = make(model=MOE_YARDSTICK,
                        params=engine_mod.random_tree(
                            engine_mod.EngineConfig(
                                model=MOE_YARDSTICK).encoder_config(), seed))
    t_time = time.perf_counter()
    time_moe(torch, engines, yardstick, smi)
    emit("times.moe_phase", served_s=served_s,
         time_moe_s=time.perf_counter() - t_time, card=smi)
    del engines, yardstick
    torch.cuda.empty_cache()
    return {"launches": launches, "dispatches": dispatches}


# -- phase 10: the workers' operations layer --------------------------------
OPS_BEAT_S = 0.5            # heartbeat and span-export interval
OPS_MEMORY_TOL = 64 << 20   # heartbeat device memory vs memory_allocated
OPS_MFU_BUSY_MAX = 1.05     # the meter's dt is host-measured
OPS_ASR_SECONDS = (7.0, 19.0)  # two WAVs of one 30 s window each
# The spin runs well past stall_exit_s: the clock that calibrates it may
# still be ramping, so the spin can come out shorter than asked.
OPS_SPIN_S, OPS_SPIN_WARN_S, OPS_SPIN_EXIT_S = 1.0, 0.1, 0.3
OPS_PAIRS = 5               # knobs-on/knobs-off run pairs


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class StatusTap:
    """Status messages on ``TOPIC_WORKER_STATUS``, each with
    ``torch.cuda.memory_allocated()`` read as it arrives: on a synchronous
    bus that is the heartbeat thread, right after its snapshot."""

    def __init__(self, torch):
        self.torch = torch
        self.rows = []

    def __call__(self, d):
        self.rows.append((d, self.torch.cuda.memory_allocated()))

    def of(self, worker_id, start=0):
        return [(d, m) for d, m in self.rows[start:]
                if d["worker_id"] == worker_id]

    def wait_beat(self, worker_id, timeout_s=30.0):
        """The next heartbeat of ``worker_id`` from now on."""
        start = len(self.rows)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            got = [r for r in self.of(worker_id, start)
                   if r[0]["message_type"] == "heartbeat"]
            if got:
                return got[0]
            time.sleep(0.01)
        raise Fail(f"no heartbeat from {worker_id} in {timeout_s} s")


def check_beats(tap, worker_id, idle_beat, worker_type):
    """Every heartbeat's device list within the card; the idle beat's
    ``bytes_in_use`` within OPS_MEMORY_TOL of memory_allocated."""
    beats = [(d, m) for d, m in tap.of(worker_id)
             if d["message_type"] == "heartbeat"]
    check(beats, f"no heartbeats from {worker_id}")
    worst = 0
    for d, mem in beats:
        check(d["worker_type"] == worker_type,
              f"{worker_id} beats as {d['worker_type']}")
        devs = d["resource_usage"].get("device_memory") or []
        check(devs, f"{worker_id}: a heartbeat without device memory")
        for dev in devs:
            check(0 < dev["bytes_in_use"] <= dev["bytes_limit"],
                  f"{worker_id}: device memory {dev}")
        worst = max(worst, abs(devs[0]["bytes_in_use"] - mem))
    d, mem = idle_beat
    diff = abs(d["resource_usage"]["device_memory"][0]["bytes_in_use"] - mem)
    check(diff <= OPS_MEMORY_TOL,
          f"{worker_id}: heartbeat memory off memory_allocated by {diff} B")
    return {"beats": len(beats), "idle_memory_diff_bytes": diff,
            "max_memory_diff_bytes": worst,
            "bytes_in_use": d["resource_usage"]["device_memory"][0][
                "bytes_in_use"],
            "bytes_limit": d["resource_usage"]["device_memory"][0][
                "bytes_limit"]}


def check_efficiency(name, eff, peak_source):
    check(eff and 0 < eff["mfu"] <= 1
          and eff["mfu_busy"] <= OPS_MFU_BUSY_MAX,
          f"{name}: efficiency {eff}")
    check(eff["peak_source"] == peak_source,
          f"{name}: peak {eff['peak_source']} for {peak_source}")
    return {k: eff[k] for k in ("mfu", "mfu_busy", "achieved_flops_per_s",
                                "goodput_tokens_per_s", "batches",
                                "window_s", "peak_source")}


def ops_tpu_config(knobs, worker_id, **extra):
    """The text worker's operations knobs: all on, or all off."""
    from distributed_crawler_tpu_torch.inference.worker import (
        TPUWorkerConfig,
    )

    on = dict(metrics_port=free_port(), heartbeat_s=OPS_BEAT_S,
              span_export_interval_s=OPS_BEAT_S, slo_batch_p95_ms=0.001,
              slo_queue_wait_ms=0.001, slo_batch_age_ms=0.001,
              stall_warn_s=30.0)
    off = dict(metrics_port=0, heartbeat_s=3600.0, span_export_interval_s=0,
               stall_warn_s=0.0)
    return TPUWorkerConfig(worker_id=worker_id, pack=True, coalesce_batches=4,
                           **(on if knobs else off), **extra)


def run_text(engine, bus, worker, batches, results):
    """Publish ``batches`` and wait for their result frames; returns the
    seconds from the first publish to the last frame."""
    from distributed_crawler_tpu_torch.bus import TOPIC_INFERENCE_BATCHES

    n0 = len(results)
    t0 = time.perf_counter()
    for b in batches:
        bus.publish(TOPIC_INFERENCE_BATCHES, b.to_dict())
    deadline = time.monotonic() + 300
    while len(results) < n0 + len(batches) and time.monotonic() < deadline:
        time.sleep(0.002)
    seconds = time.perf_counter() - t0
    check(worker.drain(timeout_s=60.0), "tpu worker did not drain")
    check(len(results) == n0 + len(batches),
          f"{len(results) - n0} result frames for {len(batches)} batches")
    return seconds


class SpinningEngine:
    """A stub engine whose step spins the card with ``torch.cuda._sleep``
    and then waits for it, as a wedged device step would hold the feed
    thread."""

    def __init__(self, torch, seconds):
        import types

        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda._sleep(10_000_000)   # let the clock ramp up first
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        self.cycles = int(10_000_000 / start.elapsed_time(end)
                          * seconds * 1e3)
        self.torch = torch
        self.cfg = types.SimpleNamespace(model="spin")
        self.tokenizer = types.SimpleNamespace(
            encode_batch=lambda texts: [[1, 2]] * len(texts))

    def run_tokenized(self, toks, pack=False):
        self.torch.cuda._sleep(self.cycles)
        self.torch.cuda.synchronize()
        return [{"embedding": [0.0], "label": 0, "scores": [1.0]}
                for _ in toks]

    def run(self, texts, pack=False):
        return self.run_tokenized([[1]] * len(texts), pack=pack)


def check_stall_watchdog(torch, dump):
    """A step that really spins the card past stall_warn_s and
    stall_exit_s: the watchdog counts one stall, writes the ``stall_exit``
    bundle, and reaches the exit seam with code 17 while the feed thread
    waits on the card."""
    from distributed_crawler_tpu_torch.bus import InMemoryBus, RecordBatch
    from distributed_crawler_tpu_torch.inference.worker import (
        STALL_EXIT_CODE,
        TPUWorker,
        TPUWorkerConfig,
    )
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    engine = SpinningEngine(torch, OPS_SPIN_S)
    bus = InMemoryBus(sync=True)
    worker = TPUWorker(bus, engine, cfg=TPUWorkerConfig(
        worker_id="smoke-ops-stall", heartbeat_s=3600.0,
        span_export_interval_s=0, stall_warn_s=OPS_SPIN_WARN_S,
        stall_exit_s=OPS_SPIN_EXIT_S), registry=MetricsRegistry())
    codes = []
    worker._exit_fn = codes.append
    before = set(os.listdir(dump))
    for i in range(2):
        worker._handle_payload(RecordBatch.from_records(
            [{"post_uid": f"spin{i}", "description": "x"}],
            crawl_id="smoke-ops").to_dict())
    t0 = time.perf_counter()
    worker.start()
    try:
        check(worker.drain(timeout_s=60.0), "stall worker did not drain")
    finally:
        worker.stop()
        bus.close()
    took = time.perf_counter() - t0
    bundles = sorted(n for n in set(os.listdir(dump)) - before
                     if n.startswith("postmortem_") and "stall_exit" in n)
    check(took >= OPS_SPIN_EXIT_S,
          f"the spinning step took {took} s, not past stall_exit_s")
    check(worker.m_stalls.value == 1,
          f"{worker.m_stalls.value} stalls counted")
    check(codes == [STALL_EXIT_CODE] == [17], f"exit codes {codes}")
    check(len(bundles) == 1, f"stall_exit bundles {bundles}")
    with open(os.path.join(dump, bundles[0])) as f:
        kinds = {e["kind"] for e in json.load(f)["flight"]}
    check("device_stall" in kinds, f"bundle events {sorted(kinds)}")
    return {"step_s": took, "stalls": worker.m_stalls.value,
            "exit_codes": codes, "bundle": bundles[0]}


def check_profile(dump, url, before):
    """The automatic capture (the first capture directory not in
    ``before``) has a chrome trace naming the sm90 kernel; a /profile
    capture answers 200, or 409 while an automatic one runs (then once
    more after it ends)."""
    from distributed_crawler_tpu_torch.utils import profiling

    def new_dirs():
        return sorted((n for n in os.listdir(dump)
                       if n.startswith("profile_") and n not in before),
                      key=lambda n: int(n.rsplit("_", 1)[1]))

    deadline = time.monotonic() + 120
    while (not new_dirs() or profiling.PROFILER.active) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    check(new_dirs(), "no automatic profiler capture")
    auto = new_dirs()[0]
    with open(os.path.join(dump, auto, profiling.TRACE_FILE)) as f:
        events = json.load(f).get("traceEvents", [])
    sm90 = [e for e in events
            if "flash_fwd_sm90_kernel" in str(e.get("name", ""))]
    check(sm90, f"{auto}: no flash_fwd_sm90_kernel among {len(events)} "
                f"events")
    codes = []
    for _ in range(2):
        code, body = http_get(url + "/profile?seconds=0.3")
        codes.append(code)
        if code != 409:
            break
        while profiling.PROFILER.active and time.monotonic() < deadline:
            time.sleep(0.05)
    check(codes[-1] == 200 and json.loads(body)["ok"],
          f"/profile answered {codes}: {body[:200]!r}")
    return {"auto_capture": auto, "events": len(events),
            "sm90_kernel_events": len(sm90), "profile_route": codes,
            "captures": profiling.PROFILER.captures}


def check_text_http(engine, url, batches, served_keys):
    """The text worker's routes: /healthz, /metrics (parsed), /status,
    /costs, /traces."""
    from distributed_crawler_tpu_torch.utils.costmodel import (
        encoder_forward_flops,
    )
    from distributed_crawler_tpu_torch.utils.exposition import (
        parse_exposition,
    )

    code, body = http_get(url + "/healthz")
    check(code == 200 and body == b"ok\n", f"/healthz {code} {body!r}")
    code, body = http_get(url + "/metrics")
    check(code == 200, f"/metrics {code}")
    samples = parse_exposition(body.decode())
    names = {s.name for s in samples}
    check("tpu_engine_mfu" in names, "tpu_engine_mfu not on /metrics")
    flops = {(int(s.labels["bucket"]), s.labels["path"]): s.value
             for s in samples
             if s.name == "tpu_engine_bucket_flops" and s.labels}
    check(set(flops) == served_keys,
          f"bucket FLOPs for {sorted(flops)}, served {sorted(served_keys)}")
    breaches = [s.value for s in samples if s.name == "slo_breach_total"
                and s.labels == {"slo": "batch_p95"}]
    check(breaches and breaches[0] >= 1, f"slo_breach_total {breaches}")
    code, body = http_get(url + "/status")
    status = json.loads(body)
    check(code == 200 and status["processed_batches"] == len(batches),
          f"/status {code} {status}")
    code, body = http_get(url + "/costs")
    costs = json.loads(body)
    check(code == 200, f"/costs {code}")
    rows = {(r["bucket"], r["path"]): r for r in costs["costs"]}
    check(set(rows) == served_keys,
          f"cost rows {sorted(rows)}, served {sorted(served_keys)}")
    for (bucket, _), r in rows.items():
        want = encoder_forward_flops(engine.ecfg, BATCH, bucket)
        check(r["source"] == "analytic" and r["flops"] == want
              and flops[(bucket, r["path"])] == want,
              f"cost row {r} against {want}")
    code, body = http_get(url + "/traces")
    check(code == 200, f"/traces {code}")
    traced = {t["trace_id"] for t in json.loads(body)["traces"]}
    missing = [b.trace_id for b in batches if b.trace_id not in traced]
    check(not missing, f"/traces lacks batches {missing}")
    return {"metrics_samples": len(samples), "bucket_flops": len(flops),
            "slo_breach_batch_p95": breaches[0], "cost_rows": len(rows),
            "traces": len(traced), "efficiency": costs["efficiency"]}


def per_bucket_meter(engine, engine_rows):
    """The meter's achieved FLOP/s per text bucket (summed FLOPs over
    summed dispatch-to-readback seconds of that bucket's records) against
    the CUDA-event forward time `time_engine` measured at the bucket."""
    from distributed_crawler_tpu_torch.utils.costmodel import (
        encoder_forward_flops,
    )

    forward = {r["bucket"]: r["forward_ms"] for r in engine_rows}
    out = []
    for bucket in MAIN_BUCKETS:
        flops = encoder_forward_flops(engine.ecfg, BATCH, bucket)
        recs = [r for r in engine.meter._records if r[2] == flops]
        if not recs:
            continue
        meter = sum(r[2] for r in recs) / sum(r[1] for r in recs)
        event = flops / (forward[bucket] * 1e-3)
        out.append({"bucket": bucket, "records": len(recs),
                    "meter_flop_per_s": meter,
                    "meter_ms_per_batch": sum(r[1] for r in recs)
                    / len(recs) * 1e3,
                    "cuda_event_forward_ms": forward[bucket],
                    "cuda_event_flop_per_s": event,
                    "meter_over_event": meter / event})
    return out


def heartbeat_cost(worker, probe, reps=20):
    """Host ms of one heartbeat's work (SLO tick, telemetry snapshot,
    queue sample, breach and tenant maps, registry self-sample, the
    message's JSON), and of one span export by ``probe`` (an exporter made
    before the served run, so it ships that whole run), on the calling
    thread."""
    from distributed_crawler_tpu_torch.bus import StatusMessage

    t0 = time.perf_counter()
    for _ in range(reps):
        worker._slo.evaluate()
        msg = StatusMessage.new(worker.cfg.worker_id, "heartbeat", "idle",
                                worker_type="tpu")
        msg.resource_usage = worker._telemetry.snapshot()
        msg.resource_usage["queue"] = {"depth_time_weighted":
                                       worker._depth.sample()}
        msg.resource_usage["slo_breaches"] = worker._slo.snapshot()
        msg.resource_usage["tenants"] = worker._tenant_ledger().snapshot()
        worker._ts_sampler.sample()
        json.dumps(msg.to_dict())
    beat_ms = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    spans, _ = probe.collect()
    json.dumps([s.to_dict() for s in spans])
    return {"heartbeat_host_ms": beat_ms, "span_export_host_ms":
            (time.perf_counter() - t0) * 1e3, "spans_exported": len(spans)}


def knobs_on_off(engine, reg, batches):
    """posts/s of the same engine and traffic through a `TPUWorker` with
    every operations knob on against every knob off, in OPS_PAIRS
    alternating pairs.  Each run also splits its wall time into the feed
    thread's time inside ``engine.run_tokenized`` (spans) and the rest,
    and keeps the longest wait between two result frames, so a slow run
    shows whether the engine or something beside it took the time."""
    import statistics

    from distributed_crawler_tpu_torch.bus import (
        TOPIC_INFERENCE_RESULTS,
        InMemoryBus,
    )
    from distributed_crawler_tpu_torch.inference.worker import TPUWorker
    from distributed_crawler_tpu_torch.utils import trace

    runs = []
    for i in range(2 * OPS_PAIRS):
        knobs = i % 2 == 0
        rbus = InMemoryBus(sync=True)
        arrivals = []
        rbus.subscribe(TOPIC_INFERENCE_RESULTS,
                       lambda _d, a=arrivals: a.append(time.perf_counter()))
        worker = TPUWorker(rbus, engine, cfg=ops_tpu_config(
            knobs, f"smoke-ops-{'on' if knobs else 'off'}",
            profile_on_slow_ms=60_000.0 if knobs else 0.0), registry=reg)
        worker.start()
        engine.meter.reset()
        wall0 = time.time()
        try:
            t0 = time.perf_counter()
            seconds = run_text(engine, rbus, worker, batches, arrivals)
            eff = engine.efficiency_snapshot()
        finally:
            worker.stop()
        engine_s = sum(sp.duration_s for sp in trace.TRACER.spans()
                       if sp.name == "engine.run_tokenized"
                       and sp.start_wall >= wall0)
        gaps = [b - a for a, b in zip([t0] + arrivals, arrivals)]
        runs.append({"knobs": "on" if knobs else "off", "seconds": seconds,
                     "posts_per_s": len(batches) * BATCH / seconds,
                     "engine_s": engine_s, "outside_engine_s":
                     seconds - engine_s, "max_frame_gap_s": max(gaps),
                     "mfu": eff["mfu"], "mfu_busy": eff["mfu_busy"]})
    rates = {k: [r["posts_per_s"] for r in runs if r["knobs"] == k]
             for k in ("on", "off")}
    return {"runs": runs, "pairs": OPS_PAIRS, "posts_per_s_median": {
        k: statistics.median(v) for k, v in rates.items()},
        "posts_per_s_range": {k: [min(v), max(v)]
                              for k, v in rates.items()},
        "slowest_run": min(runs, key=lambda r: r["posts_per_s"])}


def ops_asr(torch, np, bus, tap, seed, dump, peak_source):
    """Whisper-small at the published widths (random weights from the
    seed, no checkpoint file) through `ASRWorker` with heartbeats and span
    export on: two generated WAVs of one window each."""
    import wave

    from distributed_crawler_tpu_torch.bus import (
        TOPIC_TRANSCRIPTS,
        AudioBatchMessage,
        AudioRef,
    )
    from distributed_crawler_tpu_torch.inference.asr import ASRPipeline
    from distributed_crawler_tpu_torch.media.worker import (
        ASRWorker,
        ASRWorkerConfig,
    )
    from distributed_crawler_tpu_torch.models import whisper as wh
    from distributed_crawler_tpu_torch.models.hf_convert import (
        convert_whisper,
        whisper_config_from_hf,
    )
    from distributed_crawler_tpu_torch.ops import attention
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    t0 = time.perf_counter()
    cfg = whisper_config_from_hf(WHISPER_HF_CONFIG)
    check(cfg == wh.WHISPER_SMALL, f"not whisper-small's widths: {cfg}")
    tree = {"params": convert_whisper(dict(whisper_state(np, seed)), cfg)}
    pipeline = ASRPipeline(wh.Whisper(cfg), tree, batch_size=8,
                           registry=MetricsRegistry())
    del tree
    pipeline.warmup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 10)
    msgs = []
    for i, seconds in enumerate(OPS_ASR_SECONDS):
        n = int(seconds * 16_000)
        pcm = (0.2 * np.sin(2 * np.pi * (150 + 100 * i) * np.arange(n)
                            / 16_000) + 0.03 * rng.standard_normal(n))
        path = os.path.join(dump, f"ops_voice_{i}.wav")
        with wave.open(path, "wb") as wf:
            wf.setnchannels(1)
            wf.setsampwidth(2)
            wf.setframerate(16_000)
            wf.writeframes((np.clip(pcm, -1, 1) * 32767).astype(
                np.int16).tobytes())
        msgs.append(AudioBatchMessage.new(
            [AudioRef(media_id=f"ops{i}", path=path, channel_name="smoke")],
            crawl_id="smoke-ops"))
    transcripts = []
    bus.subscribe(TOPIC_TRANSCRIPTS, transcripts.append)
    worker = ASRWorker(bus, pipeline, cfg=ASRWorkerConfig(
        worker_id="smoke-ops-asr", heartbeat_s=OPS_BEAT_S,
        span_export_interval_s=OPS_BEAT_S, slo_asr_batch_p95_ms=0.001),
        registry=MetricsRegistry())
    for m in msgs:
        worker._handle_payload(m.to_dict())
    attention.flash_attention.launches = 0
    by_path = attention.flash_attention.launches_by_path
    for p in by_path:
        by_path[p] = 0
    dispatches0 = pipeline.timeline.snapshot().get("batches_total", 0)
    t0 = time.perf_counter()
    worker.start()
    try:
        check(worker.drain(timeout_s=300.0), "asr worker did not drain")
        seconds = time.perf_counter() - t0
        launches = dict(by_path)
        eff = pipeline.efficiency_snapshot()
        idle = tap.wait_beat("smoke-ops-asr")
    finally:
        worker.stop()
    dispatches = pipeline.timeline.snapshot()["batches_total"] - dispatches0
    check(len(transcripts) == len(msgs)
          and all(t["windows"] == 1 and not t["error"] for t in transcripts),
          f"transcripts {[(t['media_id'], t['windows'], t['error']) for t in transcripts]}")
    check(launches == {"sm90": cfg.n_audio_layer * dispatches,
                       "mma_sync": 0, "simt": 0},
          f"asr launches {launches} for {dispatches} dispatches")
    return {"setup_s": setup_s, "seconds": seconds, "dispatches": dispatches,
            "launches": launches,
            "efficiency": check_efficiency("asr", eff, peak_source),
            "beats": check_beats(tap, "smoke-ops-asr", idle, "asr"),
            "costs": pipeline.cost_snapshot()["costs"]}


def phase_ops(torch, np, seed, smi, engine_rows):
    """E5-small served through `TPUWorker` with every operations knob on,
    its embeddings folded by `ClusterWorker`, and Whisper-small through
    `ASRWorker`, with heartbeats, span export, the metrics routes, SLO
    budgets, the profiler and the stall watchdog checked on the card."""
    import tempfile

    from distributed_crawler_tpu_torch.bus import (
        TOPIC_INFERENCE_RESULTS,
        TOPIC_SPANS,
        TOPIC_WORKER_STATUS,
        InMemoryBus,
        RecordBatch,
    )
    from distributed_crawler_tpu_torch.cluster import (
        ClusterWorker,
        ClusterWorkerConfig,
    )
    from distributed_crawler_tpu_torch.inference.engine import (
        EngineConfig,
        InferenceEngine,
    )
    from distributed_crawler_tpu_torch.inference.worker import TPUWorker
    from distributed_crawler_tpu_torch.ops import attention
    from distributed_crawler_tpu_torch.utils import flight, profiling, trace
    from distributed_crawler_tpu_torch.utils.costmodel import (
        peak_flops,
    )
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    t_phase = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    peak_source = peak_flops(kind, "cuda")[1]
    check(peak_source != "unknown", f"no bf16 peak for {kind!r}")
    dump = tempfile.mkdtemp(prefix="dct_ops_")
    profiling.configure(dump_dir=dump)
    flight.RECORDER.reset()
    flight.configure(dump_dir=dump)
    trace.TRACER.reset()
    # The first profiler session of a process pays the profiler's own
    # start-up: take it here, so the automatic capture starts at once.
    t0 = time.perf_counter()
    first = profiling.capture(0.05)
    check(first["ok"], f"profiler warmup capture: {first}")
    profiler_warmup_s = time.perf_counter() - t0
    captured_before = set(os.listdir(dump))

    t0 = time.perf_counter()
    reg = MetricsRegistry()
    engine = InferenceEngine(EngineConfig(model="e5_small", batch_size=BATCH,
                                          seed=seed), registry=reg)
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    check((engine.ecfg.vocab_size, engine.ecfg.hidden,
           engine.ecfg.n_layers) == (250037, 384, 12),
          f"not E5-small's full width: {engine.ecfg}")
    bus = InMemoryBus(sync=True)
    tap = StatusTap(torch)
    bus.subscribe(TOPIC_WORKER_STATUS, tap)
    span_batches, results = [], []
    bus.subscribe(TOPIC_SPANS, span_batches.append)
    bus.subscribe(TOPIC_INFERENCE_RESULTS, results.append)
    cw = ClusterWorker(bus, provider=DictProvider(), cfg=ClusterWorkerConfig(
        worker_id="smoke-ops-cluster", k=CLUSTER_K, buckets=CLUSTER_BUCKETS,
        metrics_port=free_port(), heartbeat_s=OPS_BEAT_S,
        span_export_interval_s=OPS_BEAT_S), registry=MetricsRegistry())
    check(cw.engine.device.type == "cuda", f"cluster on {cw.engine.device}")
    tpu = TPUWorker(bus, engine, cfg=ops_tpu_config(
        True, "smoke-ops-tpu", profile_on_slow_ms=0.001), registry=reg)
    tpu_url = f"http://127.0.0.1:{tpu.cfg.metrics_port}"
    cluster_url = f"http://127.0.0.1:{cw.cfg.metrics_port}"
    cw.start()
    tpu.warmup()
    torch.cuda.synchronize()
    tpu.start()
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(seed + 10)
    batches = [RecordBatch.from_records(
        synthetic_posts(np, rng, BATCH, i * BATCH), crawl_id="smoke-ops")
        for i in range(8)]
    attention.flash_attention.launches = 0
    by_path = attention.flash_attention.launches_by_path
    for p in by_path:
        by_path[p] = 0
    dispatches0 = engine.m_latency.count
    probe = trace.SpanExporter(name_prefixes=("tpu_worker.", "engine."))
    try:
        auto_s = run_text(engine, bus, tpu, batches, results)
        launches = dict(by_path)
        dispatches = engine.m_latency.count - dispatches0
        text_eff = engine.efficiency_snapshot()
        deadline = time.monotonic() + 120
        while cw.get_status()["processed_batches"] < len(batches) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        check(cw.drain(timeout_s=60.0), "cluster worker did not drain")
        cluster_eff = cw.engine.efficiency_snapshot()
        served = {(s.attrs["bucket"], "packed" if s.attrs.get("packed")
                   else "unpacked") for s in trace.TRACER.spans()
                  if s.name == "engine.compute"}
        idle_tpu = tap.wait_beat("smoke-ops-tpu")
        idle_cluster = tap.wait_beat("smoke-ops-cluster")
        http = check_text_http(engine, tpu_url, batches, served)
        code, body = http_get(cluster_url + "/clusters")
        clusters = json.loads(body)
        check(code == 200 and clusters["k"] == CLUSTER_K
              and clusters["vectors"] == len(batches) * BATCH,
              f"/clusters {code} {str(clusters)[:300]}")
        profile = check_profile(dump, tpu_url, captured_before)
        beat_cost = heartbeat_cost(tpu, probe)
    finally:
        tpu.stop()
    check(launches == {"sm90": engine.ecfg.n_layers * dispatches,
                       "mma_sync": 0, "simt": 0},
          f"launches {launches} for {dispatches} dispatches (12 each, sm90)")
    stops = [d for d, _ in tap.of("smoke-ops-tpu")
             if d["message_type"] == "worker_stopping"]
    check(len(stops) == 1 and stops[0]["status"] == "offline",
          f"stop() announced {stops}")
    # Right after a beat, so that none is being built when kill() stops
    # the heartbeat thread (a beat under way is published, kill or not).
    tap.wait_beat("smoke-ops-cluster")
    n_cluster = len(tap.of("smoke-ops-cluster"))
    cw.kill()
    cw.stop()   # after kill(): silent, closes the metrics server
    check(len(tap.of("smoke-ops-cluster")) == n_cluster,
          "kill() published a status")
    shipped = {s["trace_id"] for m in span_batches
               if m["worker_id"] == "smoke-ops-tpu" for s in m["spans"]}
    missing = [b.trace_id for b in batches if b.trace_id not in shipped]
    check(not missing, f"span batches lack batches {missing}")
    beats = {"tpu": check_beats(tap, "smoke-ops-tpu", idle_tpu, "tpu"),
             "cluster": check_beats(tap, "smoke-ops-cluster", idle_cluster,
                                    "cluster")}
    efficiency = {"text": check_efficiency("text", text_eff, peak_source),
                  "cluster": check_efficiency("cluster", cluster_eff,
                                              peak_source)}
    emit("slice.ops", setup_s=setup_s, profiler_warmup_s=profiler_warmup_s,
         posts=len(batches) * BATCH,
         dispatches=dispatches, kernel_launches_by_path=launches,
         launches_per_dispatch=launches["sm90"] / dispatches,
         served=sorted(served), http=http, clusters_vectors=clusters[
             "vectors"], profile=profile, heartbeats=beats,
         span_batches=len(span_batches), stop_announced=True,
         kill_silent=True, card=smi)

    asr = ops_asr(torch, np, bus, tap, seed, dump, peak_source)
    beats["asr"] = asr["beats"]
    efficiency["asr"] = asr["efficiency"]
    stall = check_stall_watchdog(torch, dump)
    emit("slice.ops.asr", dispatches=asr["dispatches"],
         kernel_launches_by_path=asr["launches"], seconds=asr["seconds"],
         setup_s=asr["setup_s"], heartbeats=asr["beats"], card=smi)
    emit("slice.ops.watchdog", **stall, card=smi)

    runs = knobs_on_off(engine, reg, batches)
    meter = per_bucket_meter(engine, engine_rows)
    profiling.configure(dump_dir="")
    flight.configure(dump_dir="")
    emit("times.ops", auto_capture_run={
        "seconds": auto_s, "posts_per_s": len(batches) * BATCH / auto_s},
        **runs, efficiency=efficiency, meter_by_bucket=meter,
        **beat_cost, phase_s=time.perf_counter() - t_phase, card=smi)
    return {"launches": {p: launches[p] + asr["launches"][p]
                         for p in attention.PATHS}}


# -- phase 11: the CLI's device modes ----------------------------------------
# Step 1's tolerances are phase 4's: served (packed) embeddings against the
# same engine's unpacked `embed` within 2e-2; labels equal where the top-2
# score gap exceeds 5e-2.
CLI_EMB_TOL, CLI_LABEL_MARGIN = 2e-2, 5e-2
CLI_BATCHES = 8
CLI_CLUSTER_K, CLI_CLUSTER_ITERS, CLI_CLUSTER_POSTS = 8, 25, 2048
CLI_EMB_ROWS, CLI_EMB_DIM = 4096, 1024
# The cluster result against the port's `fit` on the same rows.
CLI_INERTIA_RTOL = 1e-4


def zero_launches(attention):
    attention.flash_attention.launches = 0
    for p in attention.flash_attention.launches_by_path:
        attention.flash_attention.launches_by_path[p] = 0


def read_launches(attention):
    return dict(attention.flash_attention.launches_by_path)


def check_sm90_only(launches, per_dispatch, dispatches, what):
    check(dispatches > 0, f"{what}: no device dispatch")
    check(launches == {"sm90": per_dispatch * dispatches, "mma_sync": 0,
                       "simt": 0},
          f"{what}: launches by path {launches} for {dispatches} "
          f"dispatches (expected {per_dispatch} sm90 per dispatch)")


def cli_resolve(argv):
    from distributed_crawler_tpu_torch import cli

    return cli.resolve_config(cli.build_parser().parse_args(argv), env={})


def cli_main(argv, env=None):
    """``cli.main(argv)`` with its summary line captured; returns (rc,
    the last stdout line as JSON or None, seconds)."""
    import contextlib
    import io

    from distributed_crawler_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv, env=env or {})
    seconds = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), seconds


def result_rows(store, crawl_id, batches):
    """The tpu-worker's JSONL writeback, one file per batch, in batch
    order."""
    rows = []
    for b in batches:
        path = os.path.join(store, "inference", crawl_id, "batches",
                            f"{b.batch_id}.jsonl")
        check(os.path.exists(path), f"no results file for {b.batch_id}")
        with open(path, encoding="utf-8") as f:
            got = [json.loads(line) for line in f]
        check([r["post_uid"] for r in got]
              == [r["post_uid"] for r in b.records],
              f"batch {b.batch_id}: rows {len(got)} for "
              f"{len(b.records)} posts, or out of order")
        rows += got
    return rows


def check_rows_against(np, rows, want):
    """Rows against the engine's unpacked results on the same texts."""
    emb = np.asarray([r["embedding"] for r in rows], np.float64)
    w_emb = np.asarray([r["embedding"] for r in want], np.float64)
    err = float(np.abs(emb - w_emb).max())
    check(err <= CLI_EMB_TOL, f"embeddings off the engine's by {err}")
    scores = np.asarray([r["scores"] for r in want])
    top2 = np.sort(scores, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > CLI_LABEL_MARGIN
    labels = np.asarray([r["label"] for r in rows])
    w_labels = np.asarray([r["label"] for r in want])
    check(bool((labels[clear] == w_labels[clear]).all()),
          "labels differ where the top score is clear")
    return {"rows": len(rows), "emb_max_abs_err": err, "tol": CLI_EMB_TOL,
            "labels_compared": int(clear.sum()),
            "label_margin": CLI_LABEL_MARGIN}


def cli_tpu_worker(torch, np, attention, work, seed, smi, phase4_posts_s):
    """Step 1: `_build_tpu_worker` from the CLI's defaults, eight batches
    of 256 posts on its in-memory bus, the JSONL writeback checked."""
    from distributed_crawler_tpu_torch import cli
    from distributed_crawler_tpu_torch.bus import (
        TOPIC_INFERENCE_BATCHES,
        TOPIC_INFERENCE_RESULTS,
        RecordBatch,
    )

    store = os.path.join(work, "cli_tpu")
    cfg, r = cli_resolve(["--mode", "tpu-worker", "--infer-batch-size",
                          str(BATCH), "--storage-root", store,
                          "--crawl-id", "smoke-cli",
                          "--worker-id", "chip-smoke-cli"])
    t0 = time.perf_counter()
    worker = cli._build_tpu_worker(cfg, r)
    build_s = time.perf_counter() - t0
    engine = worker.engine
    ecfg = engine.ecfg
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    check((ecfg.vocab_size, ecfg.hidden, ecfg.n_layers, ecfg.n_heads)
          == (250037, 384, 12, 12), f"not E5-small's full width: {ecfg}")
    check(engine.bucket_spec.lengths == (64, 128, 256, 512)
          and engine.cfg.batch_size == BATCH,
          f"not the CLI's defaults: {engine.cfg}")
    t0 = time.perf_counter()
    worker.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    frames = []
    worker.bus.subscribe(TOPIC_INFERENCE_RESULTS, frames.append)
    rng = np.random.default_rng(seed + 11)
    batches = [RecordBatch.from_records(
        synthetic_posts(np, rng, BATCH, i * BATCH), crawl_id="smoke-cli")
        for i in range(CLI_BATCHES)]
    worker.start()
    zero_launches(attention)
    d0 = engine.m_latency.count
    t_start = time.perf_counter()
    try:
        for b in batches:
            worker.bus.publish(TOPIC_INFERENCE_BATCHES, b.to_dict())
        deadline = time.monotonic() + 600
        while len(frames) < len(batches) and time.monotonic() < deadline:
            time.sleep(0.005)
        t_end = time.perf_counter()
        check(worker.drain(timeout_s=60.0), "cli tpu-worker did not drain")
    finally:
        worker.stop()
        worker.bus.close()
    launches = read_launches(attention)
    dispatches = engine.m_latency.count - d0
    check_sm90_only(launches, ecfg.n_layers, dispatches, "cli tpu-worker")
    check(len(frames) == len(batches), f"{len(frames)} result frames")
    rows = result_rows(store, "smoke-cli", batches)
    texts = [t for b in batches for t in b.texts()]
    want = engine.run(texts)
    vs_engine = check_rows_against(np, rows, want)
    n_posts = len(rows)
    posts_s = n_posts / (t_end - t_start)
    emit("cli.tpu_worker", posts=n_posts, batches=len(batches),
         dispatches=dispatches, kernel_launches_by_path=launches,
         launches_per_dispatch=launches["sm90"] / dispatches,
         vs_engine_embed=vs_engine, build_s=build_s, warmup_s=warm_s)
    emit("times.cli", step="tpu-worker", posts=n_posts,
         seconds=t_end - t_start, posts_per_s=posts_s,
         phase4_posts_per_s=phase4_posts_s, card=smi)
    return {"launches": launches, "batches": batches, "want": want,
            "frames": frames, "warmup_s": warm_s, "posts_per_s": posts_s,
            "n_layers": ecfg.n_layers}


def wait_http_200(url, proc, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        check(proc.poll() is None, f"the CLI process exited {proc.returncode}")
        try:
            if http_get(url)[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise Fail(f"{url} did not answer 200 in {timeout_s} s")


def proc_counts(url):
    """A CLI process's attention launches by path and its engine's
    dispatches, read from its /metrics: both live in its memory only."""
    code, body = http_get(url + "/metrics")
    check(code == 200, f"/metrics answered {code}")
    launches = dict.fromkeys(KERNEL_SOURCES, 0)
    dispatches = 0
    for line in body.decode().splitlines():
        name, _, value = line.rpartition(" ")
        if name.startswith('attention_kernel_launches_total{path="'):
            launches[name.split('"')[1]] = int(float(value))
        elif name == "tpu_inference_batch_seconds_count":
            dispatches = int(float(value))
    return launches, dispatches


def cli_process(np, work, tpu, smi):
    """Step 2: ``python3 -m distributed_crawler_tpu_torch.cli --mode
    tpu-worker`` as a process of its own.  Where ``grpc`` imports, the
    process also hosts the broker (``--bus-serve``): a `RemoteBus` here
    publishes step 1's batches into it and reads its heartbeats, the only
    way out of the process; the routes, /logs and the SIGTERM bundle are
    checked either way."""
    import glob
    import signal

    try:
        import grpc  # noqa: F401
        grpc_ok = True
    except ImportError:
        grpc_ok = False
    emit("cli.grpc", available=grpc_ok,
         runs=("the worker process hosts the broker; batches and "
               "heartbeats over RemoteBus" if grpc_ok else
               "not run: no grpc on this machine, so no batch is published "
               "into the worker process and no heartbeat is read"))
    store = os.path.join(work, "cli_proc")
    dump = os.path.join(work, "cli_dump")
    port = free_port()
    argv = [sys.executable, "-m", f"{PACKAGE}.cli", "--mode", "tpu-worker",
            "--metrics-port", str(port), "--dump-dir", dump,
            "--storage-root", store, "--crawl-id", "smoke-cli",
            "--worker-id", "chip-smoke-proc", "--log-json",
            # Clamped to 1 s with a WARNING: the process warns, so its
            # /logs and bundle carry a record.
            "--telemetry-interval", "0.5"]
    bus_address = ""
    if grpc_ok:
        bus_address = f"127.0.0.1:{free_port()}"
        argv += ["--bus-serve", "--bus-address", bus_address]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [env.get("PYTHONPATH", "")] if p])
    log_path = os.path.join(work, "cli_process.log")
    url = f"http://127.0.0.1:{port}"
    out = {"grpc": grpc_ok}
    with open(log_path, "w", encoding="utf-8") as log:
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            wait_http_200(url + "/healthz", proc, 600)
            out["start_to_healthz_s"] = time.perf_counter() - t0
            for route in ("/status", "/metrics", "/costs", "/logs"):
                code, body = http_get(url + route)
                check(code == 200, f"{route} answered {code}")
            logs = json.loads(http_get(url + "/logs")[1])["records"]
            check(any("clamped" in r["message"] for r in logs),
                  f"/logs without the clamp warning: {logs}")
            warm_launches, d0 = proc_counts(url)
            check(warm_launches["sm90"] > 0
                  and warm_launches["mma_sync"] == warm_launches["simt"] == 0,
                  f"the process's warmup launches by path {warm_launches}")
            launches = dict.fromkeys(KERNEL_SOURCES, 0)
            if grpc_ok:
                out.update(cli_process_bus(np, bus_address, store, tpu))
                after, d1 = proc_counts(url)
                launches = {p: after[p] - warm_launches[p] for p in after}
                check_sm90_only(launches, tpu["n_layers"], d1 - d0,
                                "cli process over gRPC")
                out.update(dispatches=d1 - d0)
            out.update(warmup_launches_by_path=warm_launches,
                       kernel_launches_by_path=launches)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log_path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    check(rc == 130, f"SIGTERM gave exit code {rc}: {lines[-20:]}")
    warm = [json.loads(ln)["warmup_s"] for ln in lines
            if ln.startswith("{") and '"warmup done"' in ln]
    check(len(warm) == 1, "no 'warmup done' line from the process")
    bundles = glob.glob(os.path.join(dump, "postmortem_*_sigterm.json"))
    check(len(bundles) == 1, f"sigterm bundles {bundles}")
    with open(bundles[0], encoding="utf-8") as f:
        bundle = json.load(f)
    records = bundle.get("logs", {}).get("records", [])
    check(any("clamped" in r["message"] for r in records),
          "the sigterm bundle has no logs section with the warning")
    out.update(rc=rc, warmup_s=warm[0], bundle_log_records=len(records),
               bundle_keys=sorted(bundle))
    emit("cli.process", **out)
    emit("times.cli", step="process", start_to_healthz_s=out[
        "start_to_healthz_s"], warmup_s=warm[0],
        grpc_posts_per_s=out.get("posts_per_s"), card=smi)
    return out


def cli_process_bus(np, bus_address, store, tpu):
    """Step 2 over gRPC: step 1's batches published into the process;
    its rows checked as in step 1, and one heartbeat's card memory."""
    from distributed_crawler_tpu_torch.bus import (
        TOPIC_INFERENCE_BATCHES,
        TOPIC_WORKER_STATUS,
    )
    from distributed_crawler_tpu_torch.bus.grpc_bus import RemoteBus

    beats = []
    tap = RemoteBus(bus_address)
    producer = RemoteBus(bus_address)
    batches = tpu["batches"]
    try:
        tap.subscribe(TOPIC_WORKER_STATUS, beats.append)
        t0 = time.perf_counter()
        for b in batches:
            producer.publish(TOPIC_INFERENCE_BATCHES, b.to_dict())
        last = os.path.join(store, "inference", "smoke-cli", "batches")
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline and len(
                [n for n in (os.listdir(last) if os.path.isdir(last)
                             else []) if n.endswith(".jsonl")]) \
                < len(batches):
            time.sleep(0.01)
        seconds = time.perf_counter() - t0
        rows = result_rows(store, "smoke-cli", batches)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not any(
                b.get("resource_usage", {}).get("device_memory")
                for b in beats if b.get("message_type") == "heartbeat"):
            time.sleep(0.05)
    finally:
        producer.close()
        tap.close()
    heart = [b for b in beats if b.get("message_type") == "heartbeat"
             and b.get("resource_usage", {}).get("device_memory")]
    check(heart, f"no heartbeat with card memory in {len(beats)} messages")
    dev = heart[-1]["resource_usage"]["device_memory"][0]
    check(0 < dev["bytes_in_use"] <= dev["bytes_limit"],
          f"heartbeat device memory {dev}")
    vs_engine = check_rows_against(np, rows, tpu["want"])
    return {"posts_per_s": len(rows) / seconds, "grpc_seconds": seconds,
            "vs_step1_engine": vs_engine, "heartbeats": len(heart),
            "heartbeat_device_memory": dev}


class _CountCalls:
    """Count calls of a method while installed (the dispatches of an
    engine built inside ``cli.main``)."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.orig = getattr(owner, name)
        self.calls = 0

    def __enter__(self):
        orig = self.orig

        def counted(*a, **k):
            self.calls += 1
            return orig(*a, **k)

        setattr(self.owner, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)
        return False


def cli_transcribe(attention, work, asr, smi):
    """Step 3: ``main(["--mode", "transcribe", ...])`` over three of phase
    7's WAVs and its non-WAV file, with its checkpoint, against phase 7's
    `transcribe_files`."""
    from distributed_crawler_tpu_torch.inference.asr import ASRPipeline
    from distributed_crawler_tpu_torch.models.whisper import WHISPER_SMALL

    out_path = os.path.join(work, "transcripts.jsonl")
    zero_launches(attention)
    with _CountCalls(ASRPipeline, "transcribe_audio") as dispatches:
        rc, summary, wall = cli_main([
            "--mode", "transcribe", "--transcribe-input",
            asr["transcribe"]["input"],
            "--asr-pretrained-dir", asr["ckpt"], "--transcribe-output",
            out_path, "--storage-root", os.path.join(work, "cli_asr")])
    launches = read_launches(attention)
    check(rc == 0, f"transcribe exited {rc}")
    check_sm90_only(launches, WHISPER_SMALL.n_audio_layer, dispatches.calls,
                    "cli transcribe")
    with open(out_path, encoding="utf-8") as f:
        rows = [json.loads(line) for line in f]
    want = asr["transcribe"]["rows"]
    check([r["path"] for r in rows] == [w["path"] for w in want],
          f"transcript paths {[r['path'] for r in rows]}")
    for r, w in zip(rows, want):
        check(r["tokens"] == w["tokens"] and r["windows"] == w["windows"]
              and bool(r["error"]) == bool(w["error"]),
              f"{r['path']}: CLI row differs from transcribe_files")
    bad = [r for r in rows if r["path"] == "not_a_wav.wav"]
    check(len(bad) == 1 and bad[0]["error"] and not bad[0]["tokens"],
          f"the non-WAV file's row {bad}")
    check(summary == {"transcribed": len(rows) - 1, "failed": 1,
                      "output": out_path}, f"summary {summary}")
    audio_s = asr["transcribe"]["audio_seconds"]
    windows = sum(r["windows"] for r in rows)
    emit("cli.transcribe", rows=len(rows), windows=windows,
         dispatches=dispatches.calls, kernel_launches_by_path=launches)
    emit("times.cli", step="transcribe", wall_s=wall, audio_seconds=audio_s,
         audio_s_per_wall_s=audio_s / wall,
         phase7_transcribe_files_s=asr["transcribe"]["seconds"], card=smi)
    return {"launches": launches}


def cli_cluster_text(torch, np, attention, work, seed, smi):
    """Step 4, text rows: ``mode=cluster`` with ``--infer-model e5-large``
    against the port's `fit` on the same engine's `embed`."""
    from distributed_crawler_tpu_torch import cli
    from distributed_crawler_tpu_torch.models.clustering import fit

    rng = np.random.default_rng(seed + 12)
    posts = synthetic_posts(np, rng, CLI_CLUSTER_POSTS, 0)
    inp = os.path.join(work, "cluster_text.jsonl")
    out_path = os.path.join(work, "cluster_text.json")
    with open(inp, "w", encoding="utf-8") as f:
        for p in posts:
            f.write(json.dumps(p) + "\n")
    engines = []
    orig = cli._make_engine

    def capture(*a, **k):
        # The dispatch count so far: the latency histogram is the
        # registry's, shared with every engine on it.
        engine = orig(*a, **k)
        engines.append((engine, engine.m_latency.count))
        return engine

    cli._make_engine = capture
    zero_launches(attention)
    try:
        rc, summary, wall = cli_main([
            "--mode", "cluster", "--cluster-input", inp, "--cluster-output",
            out_path, "--infer-model", "e5-large", "--cluster-k",
            str(CLI_CLUSTER_K), "--cluster-iters", str(CLI_CLUSTER_ITERS)])
    finally:
        cli._make_engine = orig
    launches = read_launches(attention)
    check(rc == 0 and len(engines) == 1, f"cluster (text) exited {rc}")
    engine, d0 = engines[0]
    ecfg = engine.ecfg
    check((ecfg.hidden, ecfg.n_layers, ecfg.n_heads) == (1024, 24, 16),
          f"not E5-large's widths: {ecfg}")
    dispatches = engine.m_latency.count - d0
    check_sm90_only(launches, ecfg.n_layers, dispatches, "cli cluster")
    with open(out_path, encoding="utf-8") as f:
        result = json.load(f)
    x = engine.embed([p["description"] for p in posts])
    ref = fit(torch.as_tensor(x, device=engine.device), CLI_CLUSTER_K,
              iters=CLI_CLUSTER_ITERS)
    got = [a["cluster"] for a in result["assignments"]]
    check([a["post_uid"] for a in result["assignments"]]
          == [p["post_uid"] for p in posts], "assignment rows")
    check(got == ref.assignments.cpu().tolist(),
          "assignments differ from fit on the same engine's embed")
    rel = abs(result["inertia"] - float(ref.inertia)) / float(ref.inertia)
    check(rel <= CLI_INERTIA_RTOL, f"inertia off fit's by {rel}")
    emit("cli.cluster", rows="text", posts=len(posts), k=CLI_CLUSTER_K,
         dispatches=dispatches, kernel_launches_by_path=launches,
         inertia=result["inertia"], inertia_rel_err=rel,
         cluster_sizes=result["cluster_sizes"])
    emit("times.cli", step="cluster.text", wall_s=wall,
         seconds=summary["seconds"], card=smi)
    del engine, engines
    torch.cuda.empty_cache()
    return {"launches": launches}


def cli_cluster_embeddings(torch, np, device, work, seed, smi):
    """Step 4, embedding rows: 4096 x 1024 seeded unit vectors as the
    worker writes them (float32 through JSON); the seconds split into
    reading, `fit` and writing."""
    from distributed_crawler_tpu_torch.models.clustering import fit

    rng = np.random.default_rng(seed + 13)
    x = rng.standard_normal((CLI_EMB_ROWS, CLI_EMB_DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    inp = os.path.join(work, "cluster_emb.jsonl")
    out_path = os.path.join(work, "cluster_emb.json")
    t0 = time.perf_counter()
    with open(inp, "w", encoding="utf-8") as f:
        for i, row in enumerate(x):
            f.write(json.dumps({"post_uid": f"e{i}",
                                "embedding": row.tolist()}) + "\n")
    gen_s = time.perf_counter() - t0
    # The card's peak during the call, above what earlier phases still
    # hold: the mode's own memory (the rows on the card, fit's temporaries).
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rc, summary, wall = cli_main([
        "--mode", "cluster", "--cluster-input", inp, "--cluster-output",
        out_path, "--cluster-k", str(CLI_CLUSTER_K), "--cluster-iters",
        str(CLI_CLUSTER_ITERS)])
    peak = torch.cuda.max_memory_allocated() - base
    check(rc == 0, f"cluster (embeddings) exited {rc}")
    with open(out_path, encoding="utf-8") as f:
        result = json.load(f)
    ref = fit(torch.as_tensor(x, device=device), CLI_CLUSTER_K,
              iters=CLI_CLUSTER_ITERS)
    got = [a["cluster"] for a in result["assignments"]]
    check(len(got) == CLI_EMB_ROWS and sum(result["cluster_sizes"])
          == CLI_EMB_ROWS, "assignment rows")
    check(got == ref.assignments.cpu().tolist(),
          "assignments differ from fit on the same rows")
    rel = abs(result["inertia"] - float(ref.inertia)) / float(ref.inertia)
    check(rel <= CLI_INERTIA_RTOL, f"inertia off fit's by {rel}")
    emit("cli.cluster", rows="embedding", n=CLI_EMB_ROWS, dim=CLI_EMB_DIM,
         k=CLI_CLUSTER_K, inertia=result["inertia"], inertia_rel_err=rel,
         input_bytes=os.path.getsize(inp))
    emit("times.cli", step="cluster.embeddings", wall_s=wall,
         seconds=summary["seconds"], input_write_s=gen_s,
         input_bytes=os.path.getsize(inp), peak_memory_above_base_bytes=peak,
         base_memory_bytes=base, card=smi)


def cli_asr_and_cluster_workers(np, attention, work, asr, tpu, smi):
    """Step 5: `_build_asr_worker` and `_build_cluster_worker` from the
    CLI's defaults, each serving one stream on its in-memory bus."""
    from distributed_crawler_tpu_torch import cli
    from distributed_crawler_tpu_torch.bus import (
        TOPIC_INFERENCE_RESULTS,
        TOPIC_MEDIA_BATCHES,
        TOPIC_TRANSCRIPTS,
        AudioBatchMessage,
        AudioRef,
    )
    from distributed_crawler_tpu_torch.cluster.worker import (
        iter_assignments,
    )
    from distributed_crawler_tpu_torch.media.worker import iter_transcripts
    from distributed_crawler_tpu_torch.models.whisper import WHISPER_SMALL
    from distributed_crawler_tpu_torch.state import LocalStorageProvider

    store = os.path.join(work, "cli_workers")
    cfg, r = cli_resolve(["--mode", "asr-worker", "--asr-pretrained-dir",
                          asr["ckpt"], "--storage-root", store,
                          "--crawl-id", "smoke-cli-asr"])
    worker, bridge = cli._build_asr_worker(cfg, r)
    check(bridge is None, "asr-worker without --infer built a bridge")
    check(worker.pipeline.device.type == "cuda"
          and worker.pipeline.window_buckets == ASR_BUCKETS,
          f"asr-worker pipeline {worker.pipeline.window_buckets}")
    shortest = sorted((sec, p) for p, sec in asr["files"]
                      if sec is not None)[:2]
    msg = AudioBatchMessage.new(
        [AudioRef(media_id=f"cli{i}", path=p, channel_name="smoke")
         for i, (_, p) in enumerate(shortest)], crawl_id="smoke-cli-asr")
    got = []
    worker.bus.subscribe(TOPIC_TRANSCRIPTS, got.append)
    worker.warmup()
    worker.start()
    zero_launches(attention)
    d0 = worker.pipeline.timeline.snapshot().get("batches_total", 0)
    t0 = time.perf_counter()
    try:
        worker.bus.publish(TOPIC_MEDIA_BATCHES, msg.to_dict())
        deadline = time.monotonic() + 300
        while len(got) < len(msg.refs) and time.monotonic() < deadline:
            time.sleep(0.01)
        asr_s = time.perf_counter() - t0
        check(worker.drain(timeout_s=60.0), "asr-worker did not drain")
    finally:
        worker.stop()
        worker.bus.close()
    launches = read_launches(attention)
    dispatches = worker.pipeline.timeline.snapshot().get(
        "batches_total", 0) - d0
    check_sm90_only(launches, WHISPER_SMALL.n_audio_layer, dispatches,
                    "cli asr-worker")
    rows = list(iter_transcripts(LocalStorageProvider(store),
                                 "smoke-cli-asr"))
    check(sorted(r["media_id"] for r in rows)
          == sorted(ref.media_id for ref in msg.refs) and len(got) == 2,
          f"transcripts {[r.get('media_id') for r in rows]}")

    cfg, r = cli_resolve(["--mode", "cluster-worker", "--storage-root",
                          store])
    cworker = cli._build_cluster_worker(cfg, r)
    check(cworker.engine.cfg.k == 16
          and tuple(cworker.engine.cfg.buckets) == (64, 256)
          and cworker.engine.device.type == "cuda",
          f"cluster-worker engine {cworker.engine.cfg}")
    cworker.warmup()
    cworker.start()
    posts = [rec["post_uid"] for b in tpu["batches"] for rec in b.records]
    sink = LocalStorageProvider(store)
    t0 = time.perf_counter()
    try:
        for frame in tpu["frames"]:
            cworker.bus.publish(TOPIC_INFERENCE_RESULTS, frame)
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and len(
                list(iter_assignments(sink, "smoke-cli"))) < len(posts):
            time.sleep(0.05)
        cluster_s = time.perf_counter() - t0
        check(cworker.drain(timeout_s=60.0), "cluster-worker did not drain")
    finally:
        cworker.stop()
        cworker.bus.close()
    assigned = list(iter_assignments(sink, "smoke-cli"))
    check(sorted(a["post_uid"] for a in assigned) == sorted(posts)
          and all(0 <= a["cluster"] < 16 for a in assigned),
          f"{len(assigned)} assignment rows for {len(posts)} posts")
    emit("cli.workers", asr_transcripts=len(rows),
         asr_dispatches=dispatches, kernel_launches_by_path=launches,
         cluster_assignments=len(assigned))
    emit("times.cli", step="asr-worker+cluster-worker", asr_s=asr_s,
         cluster_s=cluster_s, card=smi)
    return {"launches": launches}


def store_rows(provider, prefix, crawl_id):
    """Every row of a crawl's per-batch JSONL files under ``prefix``
    (``inference`` or ``asr``), read through a storage provider."""
    base = f"{prefix}/{crawl_id}/batches"
    rows = []
    for name in provider.list_dir(base):
        if name.endswith(".jsonl"):
            text = provider.get_text(f"{base}/{name}") or ""
            rows += [json.loads(line) for line in text.splitlines() if line]
    return rows


def wait_for(pred, what, timeout_s=300.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.02)


def check_asr_and_text(launches, asr_dispatches, text_dispatches, what):
    """Every launch on sm90: 12 per Whisper-small encoder dispatch and 12
    per E5-small text dispatch, and at least one of each."""
    check(asr_dispatches > 0 and text_dispatches > 0,
          f"{what}: {asr_dispatches} ASR and {text_dispatches} text "
          f"dispatches")
    check(launches == {"sm90": 12 * (asr_dispatches + text_dispatches),
                       "mma_sync": 0, "simt": 0},
          f"{what}: launches by path {launches} for {asr_dispatches} ASR "
          f"and {text_dispatches} text dispatches")


def reentered_post(transcript):
    """The post the re-entry stores for one transcript row."""
    from distributed_crawler_tpu_torch.datamodel import Post

    return Post(post_uid=f"media:{transcript['media_id']}",
                channel_id=transcript["channel_name"],
                channel_name=transcript["channel_name"],
                platform_name="telegram", post_type=["audio_transcript"],
                description=transcript["text"] or " ".join(
                    str(t) for t in transcript["tokens"]))


def cli_reentry(np, attention, work, asr, smi):
    """Step 6: the transcript re-entry.  `_build_asr_worker` with
    ``--infer --bus-serve`` and `_build_tpu_worker` on its broker, both
    with ``--object-store file://``: phase 7's four shortest WAVs and its
    non-WAV file in one audio batch, then one of them again; then
    ``mode=transcribe --infer --bus-address`` over two of the files."""
    import shutil

    from distributed_crawler_tpu_torch import cli
    from distributed_crawler_tpu_torch.bus import (
        TOPIC_MEDIA_BATCHES,
        TOPIC_TRANSCRIPTS,
        AudioBatchMessage,
        AudioRef,
    )
    from distributed_crawler_tpu_torch.inference.asr import ASRPipeline
    from distributed_crawler_tpu_torch.inference.bridge import (
        InferenceBridge,
    )
    from distributed_crawler_tpu_torch.media.worker import iter_transcripts
    from distributed_crawler_tpu_torch.models.whisper import WHISPER_SMALL
    from distributed_crawler_tpu_torch.state.objectstore import (
        LocalFSObjectClient,
        ObjectStorageProvider,
        make_object_client,
    )
    from distributed_crawler_tpu_torch.utils import trace

    crawl = "smoke-reentry"
    store = os.path.join(work, "cli_reentry")
    objects = os.path.join(work, "objstore")
    sink = ["--object-store", f"file://{objects}", "--storage-root", store,
            "--crawl-id", crawl]
    address = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    cfg, r = cli_resolve(["--mode", "asr-worker", "--asr-pretrained-dir",
                          asr["ckpt"], "--infer", "--bus-serve",
                          "--bus-address", address] + sink)
    asr_worker, bridge = cli._build_asr_worker(cfg, r)
    cfg, r = cli_resolve(["--mode", "tpu-worker", "--bus-address",
                          address] + sink)
    tpu_worker = cli._build_tpu_worker(cfg, r)
    engine = tpu_worker.engine
    check(isinstance(bridge, InferenceBridge)
          and bridge._bus is asr_worker.bus
          and (bridge._acc.batch_size, bridge._acc.deadline_s)
          == (256, 0.05), "asr-worker --infer: no bridge on its bus")
    for w in (asr_worker, tpu_worker):
        check(isinstance(w.provider, ObjectStorageProvider)
              and isinstance(w.provider.client, LocalFSObjectClient),
              f"{w.cfg.worker_id}: results sink {w.provider}")
    check(engine.device.type == "cuda" and engine.ecfg.hidden == 384
          and engine.ecfg.n_layers == 12
          and WHISPER_SMALL.n_audio_layer == 12, f"tpu-worker {engine.ecfg}")
    asr_worker.warmup()
    tpu_worker.warmup()
    build_s = time.perf_counter() - t0
    transcripts = []
    asr_worker.bus.subscribe(TOPIC_TRANSCRIPTS, transcripts.append)
    reader = ObjectStorageProvider(make_object_client(f"file://{objects}"))
    wavs = sorted((sec, p) for p, sec in asr["files"] if sec is not None)
    bad = [p for p, sec in asr["files"] if sec is None]
    refs = [AudioRef(media_id=f"re{i}", path=p, channel_name="smoke")
            for i, (_, p) in enumerate(wavs[:4])]
    refs.append(AudioRef(media_id="re-bad", path=bad[0],
                         channel_name="smoke"))
    ok_ids = [ref.media_id for ref in refs[:4]]
    tpu_worker.start()
    asr_worker.start()
    try:
        zero_launches(attention)
        d0 = engine.m_latency.count
        with _CountCalls(ASRPipeline, "transcribe_audio") as asr_calls:
            t_pub = time.perf_counter()
            asr_worker.bus.publish(TOPIC_MEDIA_BATCHES, AudioBatchMessage.new(
                refs, crawl_id=crawl).to_dict())
            wait_for(lambda: {f"media:{m}" for m in ok_ids} <= {
                row["post_uid"] for row in store_rows(reader, "inference",
                                                      crawl)},
                "the re-entered result rows")
            loop_s = time.perf_counter() - t_pub
            # A redelivered transcript: stored again, not shipped again.
            asr_worker.bus.publish(TOPIC_MEDIA_BATCHES, AudioBatchMessage.new(
                refs[:1], crawl_id=crawl).to_dict())
            wait_for(lambda: bridge.posts_deduped == 1
                     and len(transcripts) == len(refs) + 1,
                     "the redelivered transcript")
            check(asr_worker.drain(timeout_s=60.0)
                  and tpu_worker.drain(timeout_s=60.0), "did not drain")
        launches = read_launches(attention)
        asr_dispatches = asr_calls.calls
        text_dispatches = engine.m_latency.count - d0
        check_asr_and_text(launches, asr_dispatches, text_dispatches,
                           "cli re-entry")
        rows = store_rows(reader, "inference", crawl)
        trows = list(iter_transcripts(reader, crawl))
        spans = [s for s in trace.TRACER.spans() if s.name == "media.reentry"]

        # transcribe --infer --bus-address over two of the files.
        media = os.path.join(work, "reentry_media")
        os.makedirs(os.path.join(media, "chan_r"), exist_ok=True)
        shutil.copy(wavs[0][1], os.path.join(media, "chan_r", "a.wav"))
        shutil.copy(wavs[1][1], os.path.join(media, "b.wav"))
        zero_launches(attention)
        d1 = engine.m_latency.count
        with _CountCalls(ASRPipeline, "transcribe_audio") as tr_calls:
            rc, summary, tr_wall = cli_main([
                "--mode", "transcribe", "--transcribe-input", media,
                "--asr-pretrained-dir", asr["ckpt"], "--infer",
                "--bus-address", address, "--crawl-id", crawl,
                "--transcribe-output", os.path.join(work, "reentry.jsonl")])
        check(rc == 0 and summary["transcribed"] == 2,
              f"transcribe --infer exited {rc}: {summary}")
        tr_ids = {"media:chan_r/a.wav", "media:b.wav"}
        wait_for(lambda: tr_ids <= {row["post_uid"] for row in store_rows(
            reader, "inference", crawl)}, "transcribe --infer's rows")
        check(tpu_worker.drain(timeout_s=60.0), "tpu-worker did not drain")
        tr_launches = read_launches(attention)
        tr_text = engine.m_latency.count - d1
        check_asr_and_text(tr_launches, tr_calls.calls, tr_text,
                           "transcribe --infer")
    finally:
        tpu_worker.stop()
        tpu_worker.bus.close()
        asr_worker.stop()
        bridge.close()
        asr_worker.bus.close()

    # One transcript per ref in the object store, the redelivery included.
    check(sorted(t["media_id"] for t in trows)
          == sorted([ref.media_id for ref in refs] + [refs[0].media_id]),
          f"transcripts {[t['media_id'] for t in trows]}")
    by_id = {t["media_id"]: t for t in trows}
    check(by_id["re-bad"]["error"] and all(not by_id[m]["error"]
                                           for m in ok_ids),
          "transcript errors")
    # Each successful transcript's post in the crawl's posts.jsonl, in
    # the order the transcripts arrived, none for the error file.  The
    # redelivery's post is stored again (its tokens may differ: another
    # bucket, other bf16 roundings) but not shipped: the first one is.
    posts_path = os.path.join(store, crawl, "smoke", "posts", "posts.jsonl")
    with open(posts_path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    stored = [t for t in transcripts
              if not t["error"] and (t["text"] or t["tokens"])]
    check(lines == [reentered_post(t).to_json() for t in stored],
          f"posts.jsonl: {len(lines)} lines, not the re-entry's posts")
    check(sorted(t["media_id"] for t in stored)
          == sorted(ok_ids + ok_ids[:1]), "stored transcripts")
    check(bridge.posts_deduped == 1 and bridge.posts_bridged == 4,
          f"bridge bridged {bridge.posts_bridged}, deduped "
          f"{bridge.posts_deduped}")
    shipped = {}
    for t in stored:
        shipped.setdefault(f"media:{t['media_id']}", reentered_post(t))
    # One result row per re-entered post, against the engine.
    mine = sorted((row for row in rows if row["post_uid"].startswith(
        "media:re")), key=lambda row: row["post_uid"])
    check([row["post_uid"] for row in mine] == sorted(shipped),
          f"result rows {[row['post_uid'] for row in mine]}")
    texts = [shipped[row["post_uid"]].description for row in mine]
    vs_engine = check_rows_against(np, mine, engine.run(texts))
    trace_ids = {t["trace_id"] for t in transcripts
                 if t["media_id"] in ok_ids}
    check(trace_ids and trace_ids <= {s.trace_id for s in spans},
          "no media.reentry span on a transcript's trace")
    tr_rows = [row for row in store_rows(reader, "inference", crawl)
               if row["post_uid"] in tr_ids]
    check(sorted(row["post_uid"] for row in tr_rows) == sorted(tr_ids),
          f"transcribe --infer rows {[row['post_uid'] for row in tr_rows]}")
    written = sum(os.path.getsize(os.path.join(d, n))
                  for d, _, names in os.walk(objects) for n in names)
    emit("cli.reentry", transcripts=len(trows), posts_lines=len(lines),
         result_rows=len(mine), vs_engine_run=vs_engine,
         asr_dispatches=asr_dispatches, text_dispatches=text_dispatches,
         kernel_launches_by_path=launches,
         bridge_batches=bridge.batches_published,
         posts_deduped=bridge.posts_deduped,
         reentry_spans=len(spans), transcribe_infer_rows=len(tr_rows),
         transcribe_infer_asr_dispatches=tr_calls.calls,
         transcribe_infer_text_dispatches=tr_text,
         transcribe_infer_launches_by_path=tr_launches)
    emit("times.cli", step="reentry", publish_to_last_row_s=loop_s,
         asr_dispatches=asr_dispatches, text_dispatches=text_dispatches,
         bridge_batches=bridge.batches_published,
         object_store_bytes=written, build_and_warmup_s=build_s,
         transcribe_infer_wall_s=tr_wall,
         step_s=time.perf_counter() - t0, card=smi)
    return {"launches": {p: launches[p] + tr_launches[p]
                         for p in attention.PATHS}}


def phase_cli(torch, np, attention, device, work, seed, smi, e5, asr):
    """Phase 11: the CLI's device modes on the card, at full width."""
    t0 = time.perf_counter()
    tpu = cli_tpu_worker(torch, np, attention, work, seed, smi,
                         e5["posts_per_s"])
    proc = cli_process(np, work, tpu, smi)
    tr = cli_transcribe(attention, work, asr, smi)
    text = cli_cluster_text(torch, np, attention, work, seed, smi)
    cli_cluster_embeddings(torch, np, device, work, seed, smi)
    workers = cli_asr_and_cluster_workers(np, attention, work, asr, tpu, smi)
    reentry = cli_reentry(np, attention, work, asr, smi)
    launches = {p: tpu["launches"][p] + proc["kernel_launches_by_path"][p]
                + sum(step["launches"][p]
                      for step in (tr, text, workers, reentry))
                for p in attention.PATHS}
    emit("slice.cli", seconds=time.perf_counter() - t0,
         kernel_launches_by_path=launches, grpc=proc["grpc"])
    return {"launches": launches, "tpu": tpu,
            "grpc_posts_per_s": proc.get("posts_per_s")}

# Phase 14 (slice.bus): the bus's durability and partitioning through the
# CLI's processes, E5-small at full width behind them.  The outage lasts at
# least this long; the broker dead-letters a frame after this many
# deliveries.
BUS_OUTAGE_S = 3.0
BUS_MAX_ATTEMPTS = 2
BUS_DEADLINE_S = 120.0


def cli_argv(*args):
    return [sys.executable, "-m", f"{PACKAGE}.cli", *args]


def cli_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [env.get("PYTHONPATH", "")] if p])
    return env


class Procs:
    """The phase's processes, each logging to a file: stopped (SIGTERM,
    then SIGKILL past a deadline) when the phase ends, however it ends."""

    def __init__(self, work):
        self.work = work
        self.live = []

    def start(self, name, *args, env=None):
        log = open(os.path.join(self.work, f"{name}.log"), "a",
                   encoding="utf-8")
        proc = subprocess.Popen(cli_argv(*args), cwd=ROOT,
                                env={**cli_env(), **(env or {})},
                                stdout=log, stderr=subprocess.STDOUT)
        log.close()
        proc.name = name
        self.live.append(proc)
        return proc

    def kill(self, proc):
        """SIGKILL: the broker's death, with no drain and no flush."""
        proc.kill()
        proc.wait(timeout=30)
        self.live.remove(proc)

    def stop(self, proc, want_rc=130):
        import signal

        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        self.live.remove(proc)
        check(rc == want_rc, f"{proc.name} exited {rc} on SIGTERM: "
              f"{self.tail(proc.name)}")

    def tail(self, name, n=20):
        with open(os.path.join(self.work, f"{name}.log"),
                  encoding="utf-8", errors="replace") as f:
            return f.read().splitlines()[-n:]

    def close(self):
        for proc in list(self.live):
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        self.live.clear()


def poll_until(pred, what, timeout_s=BUS_DEADLINE_S, procs=(), poll_s=0.02):
    """Poll ``pred`` until it holds; fails on the deadline or as soon as
    one of ``procs`` has exited."""
    deadline = time.monotonic() + timeout_s
    while True:
        for p in procs:
            check(p.poll() is None, f"{p.name} exited {p.returncode} "
                  f"while waiting for {what}")
        value = pred()
        if value:
            return value
        if time.monotonic() > deadline:
            raise Fail(f"{what}: not within {timeout_s} s")
        time.sleep(poll_s)


def metric_lines(url):
    """``name{labels} -> value`` of a process's /metrics."""
    code, body = http_get(url + "/metrics")
    check(code == 200, f"{url}/metrics answered {code}")
    out = {}
    for line in body.decode().splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def json_route(url, route):
    """A route's JSON body, or None while it does not answer 200."""
    try:
        code, body = http_get(url + route)
    except OSError:  # not listening yet
        return None
    return json.loads(body) if code == 200 else None


def written(store, crawl_id, batch_ids):
    """The batch ids whose writeback file exists."""
    base = os.path.join(store, "inference", crawl_id, "batches")
    return [b for b in batch_ids
            if os.path.exists(os.path.join(base, f"{b}.jsonl"))]


def bus_worker_argv(name, store, metrics_port, spool, *bus):
    return ("--mode", "tpu-worker", "--storage-root", store,
            "--worker-id", name, "--metrics-port", str(metrics_port),
            "--bus-spool-dir", spool, "--telemetry-interval", "1",
            "--no-publish-embeddings", "--log-json", *bus)


def broker_argv(address, spool, metrics_port):
    return ("--mode", "bus", "--bus-address", address, "--bus-spool-dir",
            spool, "--metrics-port", str(metrics_port), "--bus-max-attempts",
            str(BUS_MAX_ATTEMPTS))


def worker_ready(url, proc):
    """Warm (its /healthz answers after warmup) and quiet: the launches
    and dispatches the served run is counted from."""
    wait_http_200(url + "/healthz", proc, 600)
    return proc_counts(url)


def check_worker_outbox(url, target, what):
    """The process's outbox drained and its breaker on ``target`` closed:
    ``bus_outbox_depth`` 0 on every publisher and
    ``resilience_circuit_state{target}`` 0."""
    def settled():
        m = metric_lines(url)
        depth = {k: v for k, v in m.items()
                 if k.startswith("bus_outbox_depth{")}
        state = m.get(f'resilience_circuit_state{{target="{target}"}}')
        return (depth and not any(depth.values()) and state == 0.0
                and {"depth": depth, "circuit_state": state})

    return poll_until(settled, f"{what}: outbox drained, breaker closed",
                      timeout_s=60.0)


def bus_broker_restart(np, procs, work, tpu, smi):
    """(a) A worker and a durable broker; 8 batches published through a
    `RemoteBus` with an outbox; the broker SIGKILLed with 2 or more batches
    queued or in flight, the rest published into the outage, and the
    broker restarted over its spool after BUS_OUTAGE_S."""
    from distributed_crawler_tpu_torch.bus import TOPIC_INFERENCE_BATCHES
    from distributed_crawler_tpu_torch.bus.grpc_bus import RemoteBus
    from distributed_crawler_tpu_torch.bus.outbox import OutboxConfig

    spool = os.path.join(work, "b")
    store = os.path.join(work, "store_a")
    address = f"127.0.0.1:{free_port()}"
    m_broker, m_worker = free_port(), free_port()
    broker = procs.start("broker", *broker_argv(address, spool, m_broker))
    worker = procs.start("worker", *bus_worker_argv(
        "w14", store, m_worker, os.path.join(work, "w"),
        "--bus-address", address))
    url = f"http://127.0.0.1:{m_worker}"
    burl = f"http://127.0.0.1:{m_broker}"
    warm_launches, d0 = worker_ready(url, worker)
    poll_until(lambda: json_route(burl, "/dlq"), "the broker's /dlq",
               procs=[broker])
    batches = tpu["batches"]
    ids = [b.batch_id for b in batches]
    crawl = batches[0].crawl_id
    pub = RemoteBus(address, outbox=OutboxConfig(
        dir=os.path.join(work, "p")))
    try:
        t0 = time.perf_counter()
        for b in batches[:2]:
            pub.publish(TOPIC_INFERENCE_BATCHES, b.to_dict())
        poll_until(lambda: len(written(store, crawl, ids)) >= 2,
                   "2 batches committed", procs=[worker, broker])
        for b in batches[2:4]:
            pub.publish(TOPIC_INFERENCE_BATCHES, b.to_dict())
        poll_until(lambda: pub.outbox.depth() == 0,
                   "4 batches accepted by the broker", procs=[broker],
                   poll_s=0.002)
        procs.kill(broker)
        t_kill = time.perf_counter()
        committed_at_kill = written(store, crawl, ids)
        check(len(committed_at_kill) == 2,
              f"at the kill {committed_at_kill} of 4 published batches "
              f"were committed: 2 must be committed and 2 queued or in "
              f"flight")
        for b in batches[4:]:
            pub.publish(TOPIC_INFERENCE_BATCHES, b.to_dict())
        check(pub.outbox.depth() == 4,
              f"{pub.outbox.depth()} publishes buffered in the outage")
        time.sleep(max(0.0, t_kill + BUS_OUTAGE_S - time.perf_counter()))
        status0 = json_route(url, "/status")["processed_batches"]
        broker = procs.start("broker", *broker_argv(address, spool,
                                                    m_broker))
        t_restart = time.perf_counter()
        poll_until(lambda: json_route(url, "/status")["processed_batches"]
                   > status0, "a batch committed after the restart",
                   procs=[worker, broker])
        t_first = time.perf_counter()
        poll_until(lambda: len(written(store, crawl, ids)) == len(ids)
                   and pub.outbox.depth() == 0,
                   "every batch committed", procs=[worker, broker])
        t_last = time.perf_counter()
        rows = result_rows(store, crawl, batches)
        vs_engine = check_rows_against(np, rows, tpu["want"])
        check(len(rows) == len(ids) * BATCH, f"{len(rows)} rows")
        worker_bus = check_worker_outbox(url, "bus", "worker")
        check(pub.outbox.depth() == 0, "the script's outbox not drained")
        after, d1 = proc_counts(url)
        launches = {p: after[p] - warm_launches[p] for p in after}
        check_sm90_only(launches, tpu["n_layers"], d1 - d0,
                        "worker across the broker restart")
        status = json_route(url, "/status")
        check(status["error_batches"] == 0,
              f"worker batch errors {status['error_batches']}")
        poison_row, broker = bus_dead_letters(procs, pub, address, spool,
                                              burl, broker)
    finally:
        pub.close()
    procs.stop(worker)
    procs.stop(broker)
    return {"posts": len(rows), "batches": len(ids),
           "committed_at_kill": len(committed_at_kill),
           "outage_s": t_restart - t_kill,
           "restart_to_first_commit_s": t_first - t_restart,
           "restart_to_last_row_s": t_last - t_restart,
           "batches_processed": status["processed_batches"],
           "batches_redelivered": status["processed_batches"] - len(ids),
           "dispatches": d1 - d0, "kernel_launches_by_path": launches,
           "posts_per_s": len(rows) / (t_last - t0),
           "vs_engine": vs_engine, "worker_outbox": worker_bus,
           "dead_letters": poison_row}


def dlq_tool(*args):
    """``python -m distributed_crawler_tpu_torch.bus.dlq`` as an operator
    runs it: (exit code, stdout)."""
    out = subprocess.run(
        [sys.executable, "-m", f"{PACKAGE}.bus.dlq", *args], cwd=ROOT,
        env=cli_env(), capture_output=True, text=True, timeout=120)
    return out.returncode, out.stdout + out.stderr


def bus_dead_letters(procs, pub, address, spool, burl, broker):
    """(b) One poison frame the worker rejects on every delivery: on the
    broker's /dlq with its attempts and reason; listed by the DLQ tool
    from the spool while the broker is down; replayed through a new
    broker generation, marked replayed, and dead-lettered again (it
    re-entered delivery).  Returns (the report, the live broker)."""
    from distributed_crawler_tpu_torch.bus import TOPIC_INFERENCE_BATCHES

    topic = TOPIC_INFERENCE_BATCHES
    poison = {"batch_id": "smoke-bus-poison", "records": 7}

    def dead(body):
        return [e for e in (body or {}).get("topics", {}).get(
            topic, {}).get("entries", []) if e["reason"] == "max_attempts"]

    pub.publish(topic, poison)
    entries = poll_until(lambda: dead(json_route(burl, "/dlq")),
                         "the poison frame on /dlq", procs=[broker])
    check(len(entries) == 1 and entries[0]["attempts"] == BUS_MAX_ATTEMPTS,
          f"/dlq entries {entries}")
    fid = entries[0]["id"]
    procs.stop(broker)
    rc, listing = dlq_tool("--spool-dir", spool)
    check(rc == 0 and fid in listing and "max_attempts" in listing,
          f"the DLQ tool's listing ({rc}): {listing}")
    rc, inspect = dlq_tool("--spool-dir", spool, "--topic", topic,
                           "--inspect", fid)
    check(rc == 0 and '"records": 7' in inspect,
          f"the DLQ tool's entry ({rc}): {inspect}")
    m_broker = int(burl.rsplit(":", 1)[1])
    broker = procs.start("broker", *broker_argv(address, spool, m_broker))
    poll_until(lambda: json_route(burl, "/dlq"), "the broker's /dlq",
               procs=[broker])
    rc, out = dlq_tool("--spool-dir", spool, "--topic", topic, "--replay",
                       fid, "--bus-address", address)
    check(rc == 0 and "replayed 1 entry" in out, f"replay ({rc}): {out}")
    again = poll_until(
        lambda: [e for e in dead(json_route(burl, "/dlq")) if e["id"] != fid],
        "the replayed frame dead-lettered again", procs=[broker])
    rc, listed = dlq_tool("--spool-dir", spool, "--topic", topic, "--json")
    body = json.loads(listed.splitlines()[-1])
    marked = {e["id"]: e["replayed"] for e in body["topics"][topic]["entries"]}
    check(rc == 0 and marked.get(fid) is True
          and marked.get(again[0]["id"]) is False,
          f"replay marks {marked}")
    return {"id": fid, "attempts": entries[0]["attempts"],
            "reason": entries[0]["reason"], "listed_offline": True,
            "replayed": True, "dead_again_as": again[0]["id"]}, broker


def shard_batches(tpu, ring):
    """Phase 11's 8 batches under new ids, alternating shard 0 and shard 1
    of ``ring`` (4 each)."""
    picks = {sid: [] for sid in ring.shard_ids}
    i = 0
    while min(len(v) for v in picks.values()) < 4:
        bid = f"smoke-bus-c{i:03d}"
        sid = ring.shard_for(bid)
        if len(picks[sid]) < 4:
            picks[sid].append(bid)
        i += 1
    order = [picks[s][k] for k in range(4) for s in ring.shard_ids]
    return [replace(b, batch_id=bid)
            for b, bid in zip(tpu["batches"], order)]


def start_sharded(procs, work):
    """(c)'s processes, started at the phase's start so that the worker's
    warmup overlaps (a): two broker shards, each over its own spool, and a
    worker on both."""
    from distributed_crawler_tpu_torch.bus.partition import default_shard_ids

    sids = default_shard_ids(2)
    addrs = [f"127.0.0.1:{free_port()}" for _ in sids]
    ports = [free_port() for _ in sids]
    spools = [os.path.join(work, f"s{i}") for i in range(2)]
    shards = [procs.start(f"shard{i}", *broker_argv(addrs[i], spools[i],
                                                    ports[i]))
              for i in range(2)]
    store = os.path.join(work, "store_c")
    m_worker = free_port()
    worker = procs.start("worker_sharded", *bus_worker_argv(
        "w14s", store, m_worker, os.path.join(work, "w2"),
        "--bus-shard-addresses", ",".join(addrs), "--bus-shards", "2"))
    return {"sids": sids, "addrs": addrs, "ports": ports, "spools": spools,
            "shards": shards, "store": store, "worker": worker,
            "url": f"http://127.0.0.1:{m_worker}"}


def bus_partitioned(np, procs, work, tpu, smi, started):
    """(c) Two broker shards and a worker on both (`start_sharded`); 8
    batches (4 per shard) through a `PartitionedBus` with a durable outbox
    per shard; shard 0 SIGKILLed after the first 4 are committed, the rest
    published, shard 1's share committed while shard 0's parks, and shard
    0 restarted over its spool."""
    from distributed_crawler_tpu_torch.bus import TOPIC_INFERENCE_BATCHES
    from distributed_crawler_tpu_torch.bus.grpc_bus import RemoteBus
    from distributed_crawler_tpu_torch.bus.outbox import OutboxConfig
    from distributed_crawler_tpu_torch.bus.partition import (
        PartitionedBus,
        ShardMap,
    )

    sids, addrs, ports, spools, shards, store, worker, url = (
        started[k] for k in ("sids", "addrs", "ports", "spools", "shards",
                             "store", "worker", "url"))
    ring = ShardMap(sids)
    warm_launches, d0 = worker_ready(url, worker)
    batches = shard_batches(tpu, ring)
    ids = [b.batch_id for b in batches]
    crawl = batches[0].crawl_id
    owner = {b: ring.shard_for(b) for b in ids}
    pub = PartitionedBus(
        {sid: RemoteBus(a) for sid, a in zip(sids, addrs)}, ring,
        outbox=lambda sid: OutboxConfig(dir=os.path.join(work, "p2", sid)),
        name="chip-smoke")
    try:
        t0 = time.perf_counter()
        for b in batches[:4]:
            pub.publish(TOPIC_INFERENCE_BATCHES, b.to_dict())
        poll_until(lambda: len(written(store, crawl, ids)) == 4,
                   "the first 4 batches committed",
                   procs=[worker] + shards)
        procs.kill(shards[0])
        t_kill = time.perf_counter()
        for b in batches[4:]:
            pub.publish(TOPIC_INFERENCE_BATCHES, b.to_dict())
        live = [b for b in ids[4:] if owner[b] == sids[1]]
        parked = [b for b in ids[4:] if owner[b] == sids[0]]
        poll_until(lambda: set(live) <= set(written(store, crawl, ids)),
                   "shard 1's share committed while shard 0 is down",
                   procs=[worker, shards[1]])
        t_live = time.perf_counter()
        check(not set(parked) & set(written(store, crawl, ids)),
              "shard 0's share was committed while shard 0 was down")
        depth0 = pub._outboxes[sids[0]].depth()
        check(depth0 == len(parked),
              f"{depth0} frames parked in shard 0's outbox, "
              f"{len(parked)} expected")
        time.sleep(max(0.0, t_kill + BUS_OUTAGE_S - time.perf_counter()))
        during = json_route(url, "/shards")
        shards[0] = procs.start("shard0", *broker_argv(addrs[0], spools[0],
                                                       ports[0]))
        t_restart = time.perf_counter()
        poll_until(lambda: len(written(store, crawl, ids)) == len(ids)
                   and pub.outbox_depth() == 0,
                   "every batch committed", procs=[worker] + shards)
        t_last = time.perf_counter()
    finally:
        pub.close()
    base = os.path.join(store, "inference", crawl, "batches")
    mtimes = [os.stat(os.path.join(base, f"{b}.jsonl")).st_mtime_ns
              for b in parked]
    check(mtimes == sorted(mtimes),
          f"shard 0's parked batches committed out of order: {mtimes}")
    rows = result_rows(store, crawl, batches)
    vs_engine = check_rows_against(np, rows, tpu["want"])

    def shards_settled():
        body = json_route(url, "/shards")
        rows_ = (body or {}).get("shards", {})
        return (sorted(rows_) == sids and all(
            r["breaker"] == "closed" and r["outbox_depth"] == 0
            for r in rows_.values()) and body)

    final = poll_until(shards_settled, "the worker's /shards settled",
                       timeout_s=60.0, procs=[worker])
    check(during is not None and sorted(during["shards"]) == sids,
          f"/shards during the outage: {during}")
    after, d1 = proc_counts(url)
    launches = {p: after[p] - warm_launches[p] for p in after}
    check_sm90_only(launches, tpu["n_layers"], d1 - d0,
                    "worker on the sharded bus")
    status = json_route(url, "/status")
    procs.stop(worker)
    for p in shards:
        procs.stop(p)
    return {"posts": len(rows), "batches": len(ids),
            "by_shard": {sid: sum(1 for b in ids if owner[b] == sid)
                         for sid in sids},
            "parked": len(parked), "outage_s": t_restart - t_kill,
            "kill_to_live_share_s": t_live - t_kill,
            "restart_to_last_row_s": t_last - t_restart,
            "batches_processed": status["processed_batches"],
            "batches_redelivered": status["processed_batches"] - len(ids),
            "dispatches": d1 - d0, "kernel_launches_by_path": launches,
            "posts_per_s": len(rows) / (t_last - t0),
            "shards_during_outage": {
                sid: {k: r[k] for k in ("breaker", "outbox_depth")}
                for sid, r in during["shards"].items()},
            "shards_after": {
                sid: {k: r[k] for k in ("breaker", "outbox_depth",
                                        "routed_frames")}
                for sid, r in final["shards"].items()},
            "vs_engine": vs_engine}


def phase_bus(np, attention, work, tpu, grpc_posts_s, smi):
    """Phase 14: the durable and the partitioned bus between the CLI's
    processes, E5-small behind them."""
    try:
        import grpc  # noqa: F401
    except ImportError:
        raise Fail("phase 14 needs grpc, and 'import grpc' failed") from None
    t0 = time.perf_counter()
    root = os.path.join(work, "bus")
    os.makedirs(root)
    procs = Procs(root)
    # The script's own publishers retry through every outage by design:
    # their per-attempt warnings are expected, and the report counts them.
    quiet = {name: logging.getLogger(name).level
             for name in ("dct.torch.resilience", "dct.torch.bus.outbox")}
    for name in quiet:
        logging.getLogger(name).setLevel(logging.ERROR)
    try:
        started = start_sharded(procs, root)
        single = bus_broker_restart(np, procs, root, tpu, smi)
        sharded = bus_partitioned(np, procs, root, tpu, smi, started)
    except BaseException:
        for name in ("broker", "worker", "shard0", "shard1",
                     "worker_sharded"):
            if os.path.exists(os.path.join(root, f"{name}.log")):
                print(f"--- {name}.log", *procs.tail(name, 40), sep="\n",
                      file=sys.stderr)
        raise
    finally:
        procs.close()
        for name, level in quiet.items():
            logging.getLogger(name).setLevel(level)
    launches = {p: single["kernel_launches_by_path"][p]
                + sharded["kernel_launches_by_path"][p]
                for p in attention.PATHS}
    seconds = time.perf_counter() - t0
    emit("bus.broker_restart", **single)
    emit("bus.partitioned", **sharded)
    emit("times.bus", outage_s=single["outage_s"],
         restart_to_first_commit_s=single["restart_to_first_commit_s"],
         restart_to_last_row_s=single["restart_to_last_row_s"],
         batches_redelivered=single["batches_redelivered"],
         posts_per_s=single["posts_per_s"],
         sharded_outage_s=sharded["outage_s"],
         sharded_restart_to_last_row_s=sharded["restart_to_last_row_s"],
         sharded_posts_per_s=sharded["posts_per_s"],
         phase11_grpc_posts_per_s=grpc_posts_s, card=smi)
    emit("slice.bus", seconds=seconds, kernel_launches_by_path=launches)
    return {"launches": launches}


# Phase 13 (slice.train): train-head at XLM-R-base's published widths.
TRAIN_LABELS = ("news", "politics", "sports", "tech")
# Sizes cut for the script's budget (1024, 2048 and 256 before phase 17
# ran the crawl leg; every check holds at these sizes).
TRAIN_POSTS, TRAIN_SERVE_POSTS = 512, 512
# The LoRA and full scopes train on the first TRAIN_SCOPE_POSTS of them.
TRAIN_SCOPE_POSTS = 128
TRAIN_WORDS = (8, 200)          # words per post
TRAIN_VOCAB = 64                # words per class
TRAIN_STEP_BATCH = 16
# Card f32 features (3xTF32 attention, f32 products without TF32) against
# the same encoder's on the CPU: max abs, min cosine (6.8e-6 and 1 - 2e-12
# on an H100).
TRAIN_FEATURE_TOL = (1e-4, 0.999999)
# One full step, card against CPU from the same params and batch.
TRAIN_STEP_LOSS_RTOL, TRAIN_STEP_GRAD_COS = 1e-4, 0.999
# Resumed against uninterrupted full fine-tune on the card (the embedding
# backward sums with atomics, so not bit-equal): per-epoch loss relative,
# and the largest weight difference as a share of the largest weight
# movement of the uninterrupted run.
TRAIN_RESUME_LOSS_RTOL, TRAIN_RESUME_PARAM_SHARE = 1e-4, 1e-2
TRAIN_SERVE_MARGIN = 5e-2
TRAIN_MIN_ACCURACY = 0.6        # 4 classes: chance is 0.25


def train_vocab(np, seed):
    """TRAIN_VOCAB words per class, 3-8 letters behind the class's own
    prefix, so no token is shared between classes."""
    rng = np.random.default_rng(seed + 130)
    letters = np.array(list(_LETTERS))
    return [[f"c{c}" + "".join(letters[rng.integers(0, 26,
                                                   int(rng.integers(3, 9)))])
             for _ in range(TRAIN_VOCAB)] for c in range(len(TRAIN_LABELS))]


def train_posts(np, rng, vocab, n, start):
    """(records, class ids): each post one class's words, 8-200 of them."""
    records, labels = [], []
    for i in range(n):
        c = int(rng.integers(len(vocab)))
        words = rng.choice(vocab[c], size=int(rng.integers(
            TRAIN_WORDS[0], TRAIN_WORDS[1] + 1)))
        records.append({"post_uid": f"t{start + i}", "channel_name": "smoke",
                        "description": " ".join(words)})
        labels.append(c)
    return records, labels


def peak_memory(torch, fn):
    """(fn(), the peak memory allocated while it ran above what was
    allocated before: earlier phases may leave tensors on the card, and a
    collection first frees what an earlier run left to the collector)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


def train_run(torch, attention, argv, env):
    """One ``train-head`` through the CLI: (summary, seconds from start to
    the summary line, launches by path, its peak memory)."""
    zero_launches(attention)
    (rc, summary, seconds), peak = peak_memory(
        torch, lambda: cli_main(argv, env))
    check(rc == 0 and summary is not None,
          f"train-head {' '.join(argv[-8:])} exited {rc}")
    check(np_isfinite(summary["final_loss"]),
          f"train-head loss {summary['final_loss']}")
    return summary, seconds, read_launches(attention), peak


def uninterrupted_full_run(argv, env, device=None):
    """The uninterrupted full-scope run a resumed one is held against, in
    this process, through the CLI's own steps from the same flags and
    environment: its examples (`cli._train_examples`), starting weights
    (`cli._train_weights`), tokens and full-scope training
    (`cli._train_full`), with no train state, checkpoint or summary
    written.  Returns (params tree, per-epoch losses, seconds)."""
    from distributed_crawler_tpu_torch import cli

    t0 = time.perf_counter()
    cfg, r = cli.resolve_config(cli.build_parser().parse_args(argv),
                                env=env)
    examples = cli._train_examples(r.get_str("train.posts_file"),
                                   r.get_str("train.labels_file"))
    check(examples is not None, "train-head examples did not read")
    texts, labels, n_labels, _ = examples
    weights = cli._train_weights(cfg, r, n_labels, device=device)
    params, history = cli._train_full(
        weights, r, weights[2].encode_batch(texts), labels,
        epochs=r.get_int("train.epochs", 20))
    del weights
    return params["params"], [h["loss"] for h in history], \
        time.perf_counter() - t0


def np_isfinite(x):
    import math

    return math.isfinite(float(x))


# Kernel-name fragments -> what a training step spends its device time on.
STEP_KERNEL_KINDS = (
    ("products", ("gemm", "cutlass", "xmma", "cublas", "matmul", "dot")),
    ("optimizer", ("adam", "multi_tensor", "foreach")),
    ("softmax", ("softmax",)),
    ("layer_norm", ("layer_norm", "layernorm")),
    ("embedding", ("embedding", "index", "scatter", "gather")),
    ("reductions", ("reduce", "norm", "sum")),
)


def profile_train_step(torch, call, steps=1):
    """``steps`` steps under `torch.profiler`: the device time per step by
    kind of kernel (`STEP_KERNEL_KINDS`, the rest "elementwise/other"), the
    kernels per step, the ten longest kernels, and the busy share against
    the same steps' wall time without the profiler.  None where the
    profiler recorded no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        for _ in range(steps):
            call()
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    # Kernels only: a user annotation (``Optimizer.step#AdamW.step``) also
    # lies on the device's timeline and spans kernels counted already.
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and "#" not in e.name]
    if not device:
        return None
    kinds, names = {}, {}
    for e in device:
        us = e.time_range.elapsed_us()
        low = e.name.lower()
        kind = next((k for k, frags in STEP_KERNEL_KINDS
                     if any(f in low for f in frags)), "elementwise/other")
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3 / steps
        names[e.name[:80]] = names.get(e.name[:80], 0.0) + us / 1e3 / steps
    device_ms = sum(kinds.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / (wall_ms / steps),
            "kernels_per_step": len(device) / steps,
            "ms_by_kind": kinds, "top_kernels_ms": dict(top)}


def train_step_times(torch, np, tm, lora_mod, fcfg, tree, ids, mask,
                     labels, device, smi):
    """ms per step of each scope at batch 16 on the dataset's [16, L]
    rows, tokens/s, and the full step's FLOP rate."""
    from distributed_crawler_tpu_torch.utils import cudatime
    from distributed_crawler_tpu_torch.utils.costmodel import forward_flops

    b = TRAIN_STEP_BATCH
    ids, mask, labels = ids[:b], mask[:b], labels[:b]
    seq = ids.shape[1]
    real = int(mask.sum())
    tc = tm.TrainConfig(warmup_steps=10)
    rows = []
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((b, fcfg.hidden), generator=gen).to(device)
    y = torch.as_tensor(labels, dtype=torch.long, device=device)
    steps = (
        ("head", lambda: tm.HeadStep(fcfg, tc, tree["params"]["cls_head"],
                                     device),
         lambda st: st(x, y), 1),
        ("lora", lambda: lora_mod.LoraStep(
            fcfg, tree, lora_mod.init_lora_params(gen, tree, 8), 16.0, tc,
            device), lambda st: st(ids, mask, labels), seq),
        ("full", lambda: tm.make_train_step(fcfg, tc, tree, device),
         lambda st: st(ids, mask, labels), seq))
    for scope, build, call, tokens in steps:
        def run():
            st = build()
            return st, cudatime.event_time_ms(
                lambda: call(st), min_total_s=0.5, min_iters=3,
                max_iters=50)

        t_scope = time.perf_counter()
        (st, ms), peak = peak_memory(torch, run)
        row = {"scope": scope, "batch": b, "seq": tokens, "ms": ms,
               "tokens_per_s": b * tokens / (ms * 1e-3),
               "real_tokens_per_s": (real if tokens > 1 else b)
               / (ms * 1e-3),
               "peak_mem_bytes": peak, "card": smi}
        if scope == "full":
            flops = 3 * forward_flops(fcfg, b, seq)
            rate = flops / (ms * 1e-3)
            row.update(flops_3x_forward=flops, tflop_per_s=rate / 1e12,
                       share_of_fp32_peak_67=rate / H100_PEAK_FLOPS[
                           "float32"],
                       share_of_tf32_peak_494_7=rate / H100_TF32_FLOPS)
        t_profile = time.perf_counter()
        if scope != "head":
            row["profile"] = profile_train_step(torch, lambda: call(st))
        row["build_and_time_s"] = t_profile - t_scope
        row["profile_s"] = time.perf_counter() - t_profile
        emit("times.train", step=f"{scope}_step", **row)
        rows.append(row)
        del st
        torch.cuda.empty_cache()
    return rows


def step_grads(tm, fcfg, tree, toks, labels, device):
    """One full step's (loss, per-leaf gradients) on ``device``, from
    ``tree`` and a batch of 4 posts cut to 64 tokens."""
    from distributed_crawler_tpu_torch.models.from_jax import (
        flatten_tree,
        flax_grads,
    )

    ids, mask, y = tm.prepare_finetune_arrays(
        fcfg, [t[:64] for t in toks[:4]], labels[:4], 1)
    st = tm.make_train_step(fcfg, tm.TrainConfig(warmup_steps=10), tree,
                            device)
    m = st.grads(ids, mask, y)
    return float(m["loss"]), flatten_tree(flax_grads(st.model)["params"])


def check_step_vs_cpu(torch, np, tm, fcfg, tree, toks, labels, device):
    """One full step's loss and gradients, card against CPU, from the same
    params and batch (`step_grads`)."""
    l_cpu, g_cpu = step_grads(tm, fcfg, tree, toks, labels, "cpu")
    l_card, g_card = step_grads(tm, fcfg, tree, toks, labels, device)
    torch.cuda.empty_cache()
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    check(rel <= TRAIN_STEP_LOSS_RTOL,
          f"full step loss card {l_card} vs cpu {l_cpu} ({rel:.3g} rel)")
    worst, worst_leaf = 1.0, None
    for path, gc in g_cpu.items():
        # Per-leaf cosine in f64, on the card (278M gradients).
        a = torch.from_numpy(gc).to(device, torch.float64).ravel()
        b = torch.from_numpy(g_card[path]).to(device, torch.float64).ravel()
        na, nb = float(a.norm()), float(b.norm())
        if na == 0 and nb == 0:
            continue
        cos = float(a @ b) / (na * nb) if na and nb else 0.0
        if cos < worst:
            worst, worst_leaf = cos, path
    check(worst >= TRAIN_STEP_GRAD_COS,
          f"full step gradient cosine {worst} at {worst_leaf}")
    return {"loss_cpu": l_cpu, "loss_card": l_card, "loss_rel": rel,
            "min_grad_cosine": worst, "min_leaf": worst_leaf,
            "leaves": len(g_cpu), "tol": [TRAIN_STEP_LOSS_RTOL,
                                          TRAIN_STEP_GRAD_COS]}


def check_features(torch, np, tm, attention, fcfg, tree, toks, buckets,
                   device, smi):
    """Card f32 features against the CPU's on the shortest post of each
    bucket the feature pass uses, in its batches of 32 rows (padding rows
    included); then the feature pass over every post timed, with its simt
    kernels' device time."""
    from distributed_crawler_tpu_torch.models.encoder import Classifier
    from distributed_crawler_tpu_torch.models.from_jax import (
        load_flax_params,
    )
    from distributed_crawler_tpu_torch.ops.padding import (
        BucketSpec,
        bucket_for,
    )

    spec = BucketSpec(tuple(sorted(buckets)))
    shortest = {}
    for t in toks:
        b = bucket_for(len(t), spec)
        if b not in shortest or len(t) < len(shortest[b]):
            shortest[b] = t
    sample = [shortest[b] for b in sorted(shortest)]
    parts = {}
    t_part = time.perf_counter()
    cpu = tm.encode_cls_features(fcfg, tree, sample, batch_size=32,
                                 buckets=buckets, device="cpu")
    parts["cpu_features_s"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    with torch.device(device):
        model = Classifier(fcfg)
    load_flax_params(model, tree)
    enc = model.encoder
    card = tm.cls_features(enc, sample, 32, buckets)
    err = float(np.abs(card - cpu).max())
    cos = _min_cosine(np, card, cpu)
    check(err <= TRAIN_FEATURE_TOL[0] and cos >= TRAIN_FEATURE_TOL[1],
          f"card features off the CPU's: max abs {err}, min cosine {cos}")
    tm.cls_features(enc, toks, 32, buckets)            # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tm.cls_features(enc, toks, 32, buckets)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del enc, model
    torch.cuda.empty_cache()
    parts["card_features_s"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    simt, per_bucket = feature_pass_simt_ms(torch, attention, fcfg, toks,
                                            buckets, device)
    parts["simt_timing_s"] = time.perf_counter() - t_part
    row = {"posts": len(toks), "seconds": seconds, "parts": parts,
           "posts_per_s": len(toks) / seconds, "simt_ms": simt["ms"],
           "simt_calls": simt["calls"], "simt_plain_ms": simt["plain_ms"],
           "simt_library_ms": simt["library_ms"],
           "simt_bound_ms": simt["bound_ms"],
           "simt_bound_by": simt["bound_by"],
           "simt_bound_parts_ms": simt["bound_parts_ms"],
           "simt_max_abs_err": simt["max_abs_err"], "card": smi}
    emit("times.train", step="feature_pass", **row)
    for r in per_bucket:
        emit("times.train", step="feature_pass_simt_bucket", card=smi, **r)
    return {"max_abs_err": err, "min_cosine": cos,
            "tol": list(TRAIN_FEATURE_TOL), "buckets": sorted(shortest),
            "tokens": [len(t) for t in sample]}, row


def feature_pass_simt_ms(torch, attention, fcfg, toks, buckets, device):
    """The device time of the feature pass's attention, each batch's call
    at its shape and padding mask ([32, bucket, 12, 64] f32) timed by
    CUDA-graph replay and multiplied by the layers: the `simt` kernel, its
    plain version and SDPA in f32, beside the least time the card could
    take (`attention_bound_ms` summed part by part over the same calls).
    One batch per bucket is held against the plain version first.
    Returns the totals and one row per bucket."""
    import torch.nn.functional as F

    from distributed_crawler_tpu_torch.ops.padding import (
        BucketSpec,
        bucket_for,
        pack_batch,
    )
    from distributed_crawler_tpu_torch.utils import cudatime

    spec = BucketSpec(tuple(sorted(buckets)))
    groups = {}
    for i, t in enumerate(toks):
        groups.setdefault(bucket_for(len(t), spec), []).append(i)
    gen = torch.Generator(device=device).manual_seed(0)
    atol, rtol = TOLERANCE["float32"]
    heads, d, layers = fcfg.n_heads, fcfg.head_dim, fcfg.n_layers
    rows = []
    for bucket, idx in sorted(groups.items()):
        shape = (32, bucket, heads, d)
        q, k, v = (torch.randn(shape, generator=gen, device=device)
                   for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row = {"bucket": bucket, "batches": 0, "calls": 0, "ms": 0.0,
               "plain_ms": 0.0, "library_ms": 0.0,
               "bound_parts_ms": dict.fromkeys(
                   ("bytes", "operations", "exponentials"), 0.0),
               "allowed_pairs": 0, "max_abs_err": None}
        for start in range(0, len(idx), 32):
            _, mask = pack_batch([toks[i] for i in idx[start:start + 32]],
                                 BucketSpec((bucket,)), batch_pad_to=32)
            m = torch.as_tensor(mask, device=device)
            allow = attention._allowed_mask(m, None)
            if row["max_abs_err"] is None:
                out = attention.flash_attention(q, k, v, m)
                ref = attention.attend(q, k, v, kv_mask=m)
                torch.cuda.synchronize()
                row["max_abs_err"] = (out - ref).abs().max().item()
                check(bool(torch.allclose(out, ref, atol=atol, rtol=rtol)),
                      f"simt disagrees at the feature pass's [32, {bucket}, "
                      f"{heads}, {d}]: {row['max_abs_err']}")
                del out, ref
            times = {
                "ms": cudatime.graph_time_ms(
                    lambda: attention.flash_attention(q, k, v, m), calls=10,
                    min_total_s=0.02),
                "plain_ms": cudatime.graph_time_ms(
                    lambda: attention.attend(q, k, v, kv_mask=m), calls=5,
                    min_total_s=0.02),
                "library_ms": cudatime.graph_time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=allow), calls=10,
                    min_total_s=0.02)}
            pairs = int(allow.expand(32, 1, bucket, bucket).sum().item())
            parts = attention_bound_ms(pairs, 32, bucket, heads, d,
                                       "float32", 4, False)
            for key, ms in times.items():
                row[key] += ms * layers
            for key, ms in parts.items():
                row["bound_parts_ms"][key] += ms * layers
            row["allowed_pairs"] += pairs * layers
            row["batches"] += 1
            row["calls"] += layers
        row["bound_ms"], row["bound_by"] = bound_of(row["bound_parts_ms"])
        row["us_per_call"] = row["ms"] / row["calls"] * 1e3
        row["bound_us_per_call"] = row["bound_ms"] / row["calls"] * 1e3
        rows.append(row)
        del q, k, v, qt, kt, vt
    total = {key: sum(r[key] for r in rows)
             for key in ("ms", "plain_ms", "library_ms", "calls")}
    parts = {p: sum(r["bound_parts_ms"][p] for r in rows)
             for p in rows[0]["bound_parts_ms"]}
    total["bound_ms"], total["bound_by"] = bound_of(parts)
    total["bound_parts_ms"] = parts
    total["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return total, rows


def f32_labels(torch, np, tm, fcfg, params, texts, tokenizer, device):
    """The f32 trainer model's scores on ``texts`` (plain attention)."""
    from distributed_crawler_tpu_torch.models.encoder import Classifier
    from distributed_crawler_tpu_torch.models.from_jax import (
        load_flax_params,
    )
    from distributed_crawler_tpu_torch.ops.padding import (
        BucketSpec,
        pack_batch,
    )

    with torch.device(device):
        model = Classifier(tm.train_config(fcfg, attention="xla"))
    load_flax_params(model, params)
    model = model.eval()
    toks = tokenizer.encode_batch(texts)
    scores = np.zeros((len(toks), fcfg.n_labels), np.float64)
    with torch.no_grad(), tm.full_f32():
        for start in range(0, len(toks), 64):
            chunk = toks[start:start + 64]
            ids, mask = pack_batch(chunk, BucketSpec(MAIN_BUCKETS))
            logits = model(torch.as_tensor(ids, dtype=torch.long,
                                           device=device),
                           torch.as_tensor(mask, device=device))
            scores[start:start + len(chunk)] = torch.softmax(
                logits, -1).cpu().numpy()
    del model
    torch.cuda.empty_cache()
    return scores


def serve_trained(torch, np, tm, attention, fcfg, ckpt, vocab_names,
                  records, true_labels, root, device, smi):
    """`_build_tpu_worker` with --head-checkpoint and bf16 weights serving
    the held-out posts: one row per post with its label name, sm90 only,
    labels against the f32 trainer model's off a margin, accuracy."""
    from distributed_crawler_tpu_torch import cli
    from distributed_crawler_tpu_torch.bus import (
        TOPIC_INFERENCE_BATCHES,
        TOPIC_INFERENCE_RESULTS,
        RecordBatch,
    )
    from distributed_crawler_tpu_torch.inference.checkpoint import (
        latest_step_dir,
        load_params,
    )

    store = os.path.join(root, "serve")
    cfg, r = cli_resolve(["--mode", "tpu-worker", "--infer-model",
                          "xlmr_base", "--infer-batch-size", str(BATCH),
                          "--infer-param-dtype", "bfloat16",
                          "--head-checkpoint", ckpt, "--storage-root", store,
                          "--crawl-id", "smoke-train",
                          "--worker-id", "chip-smoke-train"])
    t0 = time.perf_counter()
    worker = cli._build_tpu_worker(cfg, r)
    build_s = time.perf_counter() - t0
    engine = worker.engine
    ecfg = engine.ecfg
    check(engine.device.type == "cuda" and ecfg.dtype == "bfloat16"
          and ecfg.n_labels == len(vocab_names)
          and engine.label_names == list(vocab_names),
          f"served engine {ecfg} labels {engine.label_names}")
    t0 = time.perf_counter()
    worker.warmup()
    warmup_s = time.perf_counter() - t0
    frames = []
    worker.bus.subscribe(TOPIC_INFERENCE_RESULTS, frames.append)
    batches = [RecordBatch.from_records(records[i:i + BATCH],
                                        crawl_id="smoke-train")
               for i in range(0, len(records), BATCH)]
    worker.start()
    zero_launches(attention)
    d0 = engine.m_latency.count
    t_start = time.perf_counter()
    try:
        for b in batches:
            worker.bus.publish(TOPIC_INFERENCE_BATCHES, b.to_dict())
        deadline = time.monotonic() + 600
        while len(frames) < len(batches) and time.monotonic() < deadline:
            time.sleep(0.005)
        t_end = time.perf_counter()
        check(worker.drain(timeout_s=60.0), "trained worker did not drain")
    finally:
        worker.stop()
        worker.bus.close()
    launches = read_launches(attention)
    dispatches = engine.m_latency.count - d0
    check_sm90_only(launches, ecfg.n_layers, dispatches, "trained worker")
    rows = result_rows(store, "smoke-train", batches)
    check(len(rows) == len(records), f"{len(rows)} rows")
    check(all(r.get("label_name") == vocab_names[r["label"]]
              for r in rows), "a row without its label name")
    texts = [t for b in batches for t in b.texts()]
    tokenizer = engine.tokenizer
    del worker, engine
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = load_params(latest_step_dir(ckpt))
    scores = f32_labels(torch, np, tm, fcfg, params, texts, tokenizer,
                        device)
    f32_s = time.perf_counter() - t0
    top2 = np.sort(scores, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > TRAIN_SERVE_MARGIN
    served = np.asarray([r["label"] for r in rows])
    want = scores.argmax(1)
    agree = bool((served[clear] == want[clear]).all())
    check(agree, f"served labels differ from the f32 model's on "
                 f"{int((served[clear] != want[clear]).sum())} clear posts")
    acc = float((served == np.asarray(true_labels)).mean())
    check(acc >= TRAIN_MIN_ACCURACY, f"held-out accuracy {acc}")
    posts_s = len(rows) / (t_end - t_start)
    emit("times.train", step="serve", posts=len(rows),
         seconds=t_end - t_start, posts_per_s=posts_s, build_s=build_s,
         warmup_s=warmup_s, f32_labels_s=f32_s, card=smi)
    return {"launches": launches, "dispatches": dispatches,
            "rows": len(rows), "accuracy": acc,
            "labels_compared": int(clear.sum()),
            "label_margin": TRAIN_SERVE_MARGIN}


class _CheckpointTimer:
    """Wall seconds of each call of the checkpoint module's readers and
    writers while installed, as (function, path, seconds): the CLI's own
    calls (it imports them at call time), nested ones included."""

    NAMES = ("save_params", "load_params", "save_train_state",
             "load_train_state")

    def __init__(self, ck):
        self.ck = ck
        self.calls = []
        self.orig = {n: getattr(ck, n) for n in self.NAMES}

    def __enter__(self):
        for name, fn in self.orig.items():
            def timed(path, *a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                out = _fn(path, *a, **kw)
                self.calls.append((_name, os.path.abspath(path),
                                   time.perf_counter() - t0))
                return out
            setattr(self.ck, name, timed)
        return self

    def seconds(self, name, path, count=1):
        """The last of the ``count`` calls of ``name`` on a path under
        ``path``."""
        root = os.path.abspath(path)
        found = [t for n, p, t in self.calls if n == name
                 and (p == root or p.startswith(root + os.sep))]
        check(len(found) == count,
              f"{name}({path}): {len(found)} calls of {self.calls}")
        return found[-1]

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ck, name, fn)


def phase_train(torch, np, attention, device, seed, smi, hf):
    """Phase 13: train-head (head, LoRA, full) on the card through the
    CLI at XLM-R-base's published widths, from phase 6's checkpoint in
    ``hf`` (`write_xlmr_checkpoint`), and the checkpoint served."""
    import math

    from distributed_crawler_tpu_torch.inference import checkpoint as ck
    from distributed_crawler_tpu_torch.inference.engine import (
        EngineConfig,
        InferenceEngine,
    )
    from distributed_crawler_tpu_torch.inference.tokenizer import (
        HashingTokenizer,
    )
    from distributed_crawler_tpu_torch.models import lora as lora_mod
    from distributed_crawler_tpu_torch.models import train as tm
    from distributed_crawler_tpu_torch.models.from_jax import (
        flatten_tree,
        nest_tree,
    )
    from distributed_crawler_tpu_torch.models.hf_convert import (
        load_hf_encoder,
    )
    from distributed_crawler_tpu_torch.ops.padding import (
        BucketSpec,
        bucket_for,
    )
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    t_phase = time.perf_counter()
    laps = {}
    t_lap = [t_phase]

    def lap(name):
        """The seconds since the previous lap, under ``name``."""
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    work = tempfile.TemporaryDirectory(prefix="train_")
    root = work.name
    ecfg, tree = load_hf_encoder(hf, arch="embedder_classifier",
                                 n_labels=None)
    fcfg = replace(ecfg, dtype="float32")
    check((fcfg.vocab_size, fcfg.hidden, fcfg.n_layers, fcfg.n_heads,
           fcfg.mlp_dim, fcfg.n_labels) == (250002, 768, 12, 12, 3072, 4),
          f"not XLM-R-base's published widths: {fcfg}")

    vocab = train_vocab(np, seed)
    records, labels = train_posts(np, np.random.default_rng(seed + 131),
                                  vocab, TRAIN_POSTS, 0)
    posts_file = os.path.join(root, "posts.jsonl")
    labels_file = os.path.join(root, "labels.jsonl")
    for n, (pf, lf) in ((TRAIN_POSTS, (posts_file, labels_file)),
                        (TRAIN_SCOPE_POSTS, (posts_file + ".scope",
                                             labels_file + ".scope"))):
        with open(pf, "w") as f, open(lf, "w") as g:
            for rec, c in zip(records[:n], labels[:n]):
                f.write(json.dumps({"post_uid": rec["post_uid"],
                                    "all_text": rec["description"]}) + "\n")
                g.write(json.dumps({"post_uid": rec["post_uid"],
                                    "label": TRAIN_LABELS[c]}) + "\n")
    names = sorted(TRAIN_LABELS)
    label_ids = [names.index(TRAIN_LABELS[c]) for c in labels]
    tokenizer = HashingTokenizer(fcfg.vocab_size)
    toks = tokenizer.encode_batch([r["description"] for r in records])
    buckets = tuple(cli_resolve(["--mode", "train-head"])[0]
                    .inference.bucket_sizes)
    env = {"CRAWLER_INFERENCE_PRETRAINED_DIR": hf}
    base = ["--mode", "train-head", "--infer-model", "xlmr_base",
            "--train-posts", posts_file, "--train-labels", labels_file,
            "--storage-root", os.path.join(root, "store")]
    scope = base[:4] + ["--train-posts", posts_file + ".scope",
                        "--train-labels", labels_file + ".scope"] + base[8:]
    emit("train.data", posts=len(records), classes=len(names),
         tokens_min=min(map(len, toks)), tokens_max=max(map(len, toks)),
         setup_s=time.perf_counter() - t_phase)
    main_launches = dict.fromkeys(attention.PATHS, 0)
    lap("setup")

    # (a) head scope: 20 epochs at the CLI's defaults.
    ckpt_head = os.path.join(root, "ckpt_head")
    head, head_s, launches, head_mem = train_run(
        torch, attention, base + ["--head-checkpoint", ckpt_head], env)
    spec = BucketSpec(buckets)
    per_bucket = {}
    for t in toks:
        b = bucket_for(len(t), spec)
        per_bucket[b] = per_bucket.get(b, 0) + 1
    batch = min(32, max(8, len(toks)))
    want_simt = fcfg.n_layers * sum(-(-n // batch)
                                    for n in per_bucket.values())
    check(launches == {"sm90": 0, "mma_sync": 0, "simt": want_simt},
          f"head scope launches {launches}, expected {want_simt} simt")
    main_launches["simt"] += launches["simt"]
    check(head["trained_examples"] == TRAIN_POSTS and head["n_labels"] == 4
          and head["final_loss"] < math.log(4),
          f"head scope summary {head}")
    saved = flatten_tree(ck.load_params(head["checkpoint"])["params"]
                         ["encoder"])
    base_enc = flatten_tree(tree["params"]["encoder"])
    enc_same = saved.keys() == base_enc.keys() and all(
        np.array_equal(v, base_enc[k]) for k, v in saved.items())
    check(enc_same, "head scope changed the frozen encoder")
    with open(os.path.join(ckpt_head, "labels.json")) as f:
        check(json.load(f)["labels"] == names, "labels.json vocabulary")
    emit("train.head", summary=head, seconds=head_s,
         kernel_launches_by_path=launches, peak_mem_bytes=head_mem,
         card=smi)
    lap("head")
    features, feature_row = check_features(
        torch, np, tm, attention, fcfg, tree, toks, buckets, device, smi)
    emit("train.features", **features)
    lap("features")

    # (b) LoRA scope: rank 8, 2 epochs; no kernel launches.
    ckpt_lora = os.path.join(root, "ckpt_lora")
    lora, lora_s, launches, lora_mem = train_run(
        torch, attention, scope + ["--head-checkpoint", ckpt_lora,
                                  "--train-scope", "lora",
                                  "--train-lora-rank", "8",
                                  "--train-epochs", "2"], env)
    check(launches == dict.fromkeys(attention.PATHS, 0),
          f"lora scope launched {launches}")
    merged = ck.load_params(lora["checkpoint"])
    moved = not np.allclose(
        merged["params"]["encoder"]["layers_0"]["attn"]["qkv/kernel"],
        tree["params"]["encoder"]["layers_0"]["attn"]["qkv/kernel"])
    check(moved, "lora scope left the encoder's kernels as they were")
    eng = InferenceEngine(EngineConfig(
        model="xlmr_base", checkpoint_dir=ckpt_lora, param_dtype="bfloat16",
        batch_size=64, buckets=MAIN_BUCKETS), registry=MetricsRegistry())
    held, held_labels = train_posts(np, np.random.default_rng(seed + 132),
                                    vocab, TRAIN_SERVE_POSTS, 10_000)
    out = eng.run([r["description"] for r in held[:64]])
    check(len(out) == 64 and all(
        r["label_name"] == names[r["label"]]
        and np.isfinite(r["scores"]).all() for r in out),
        "the LoRA checkpoint did not serve")
    del eng
    torch.cuda.empty_cache()
    emit("train.lora", summary=lora, seconds=lora_s,
         kernel_launches_by_path=launches, peak_mem_bytes=lora_mem,
         served=len(out), card=smi)
    lap("lora")

    # (c) full scope: 2 epochs with --train-grad-accum 2, stopped after
    # epoch 1 and resumed, against an uninterrupted run of the CLI's own
    # training in this process (no train state or checkpoint written).
    # The checkpoint's write and read seconds are the CLI's own calls.
    full = ["--train-scope", "full", "--train-grad-accum", "2"]
    sd1 = os.path.join(root, "state1")
    ckpt_full = os.path.join(root, "ckpt_full")
    runs = {}
    ck_timer = _CheckpointTimer(ck)
    for name, argv in (
            ("first_epoch", full + ["--train-epochs", "1",
                                    "--train-state-dir", sd1,
                                    "--head-checkpoint", ckpt_full]),
            ("resumed", full + ["--train-epochs", "2",
                                "--train-state-dir", sd1,
                                "--head-checkpoint", ckpt_full])):
        with ck_timer:
            summary, seconds, launches, mem = train_run(
                torch, attention, scope + argv, env)
        check(launches == dict.fromkeys(attention.PATHS, 0),
              f"full scope ({name}) launched {launches}")
        runs[name] = {"summary": summary, "seconds": seconds,
                      "peak_mem_bytes": mem}
    check(sorted(os.listdir(sd1)) == ["epoch_1"], f"state dir {sd1}: "
          f"{sorted(os.listdir(sd1))}")
    lap("full_cli")
    zero_launches(attention)
    (straight_tree, straight_losses, straight_s), straight_mem = \
        peak_memory(torch, lambda: uninterrupted_full_run(
            scope + full + ["--train-epochs", "2", "--head-checkpoint",
                           os.path.join(root, "unused")], env))
    launches = read_launches(attention)
    check(launches == dict.fromkeys(attention.PATHS, 0),
          f"full scope (straight) launched {launches}")
    runs["straight"] = {"seconds": straight_s, "in_process": True,
                        "peak_mem_bytes": straight_mem}
    hist = {"straight": straight_losses}
    with open(os.path.join(sd1, "epoch_1", "history.json")) as f:
        hist["resumed"] = [h["loss"] for h in json.load(f)["history"]]
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(hist["resumed"], hist["straight"]))
    check(len(hist["resumed"]) == 2 and loss_rel <= TRAIN_RESUME_LOSS_RTOL,
          f"resumed losses {hist['resumed']} vs {hist['straight']}")
    with ck_timer:
        resumed = flatten_tree(ck.load_params(
            runs["resumed"]["summary"]["checkpoint"])["params"])
    straight = flatten_tree(straight_tree)
    del straight_tree
    start = flatten_tree(tree["params"])
    diff = max(float(np.abs(resumed[k] - straight[k]).max())
               for k in straight)
    movement = max(float(np.abs(straight[k] - start[k]).max())
                   for k in straight)
    check(movement > 0 and diff <= TRAIN_RESUME_PARAM_SHARE * movement,
          f"resumed weights off the uninterrupted run's by {diff} "
          f"(largest movement {movement})")
    # Each run wrote its epoch's train state (the resumed run's is
    # timed), the resumed run read the first's and wrote its checkpoint,
    # and this script read that checkpoint.
    resumed_ckpt = runs["resumed"]["summary"]["checkpoint"]
    times = {"params_write_s": ck_timer.seconds("save_params", resumed_ckpt),
             "params_read_s": ck_timer.seconds("load_params", resumed_ckpt),
             "train_state_write_s": ck_timer.seconds("save_train_state",
                                                     sd1, count=2),
             "train_state_read_s": ck_timer.seconds("load_train_state",
                                                    sd1)}
    state_bytes = os.path.getsize(os.path.join(sd1, "epoch_1",
                                               ck.PARAMS_FILE))
    params_bytes = os.path.getsize(os.path.join(resumed_ckpt,
                                                ck.PARAMS_FILE))
    emit("train.full", runs=runs, loss_history=hist, loss_max_rel=loss_rel,
         weights_max_abs_diff=diff, largest_movement=movement,
         tol=[TRAIN_RESUME_LOSS_RTOL, TRAIN_RESUME_PARAM_SHARE], card=smi)
    emit("times.train", step="checkpoint", params_bytes=params_bytes,
         train_state_bytes=state_bytes, **times, card=smi)
    del resumed, straight, merged, saved
    lap("full_straight_and_checks")

    step_cpu = check_step_vs_cpu(torch, np, tm, fcfg, tree, toks, label_ids,
                                 device)
    emit("train.step_vs_cpu", **step_cpu)
    lap("step_vs_cpu")
    ids, mask, y = tm.prepare_finetune_arrays(fcfg, toks, label_ids, 1)
    step_rows = train_step_times(torch, np, tm, lora_mod, fcfg, tree, ids,
                                 mask, y, device, smi)
    lap("step_times")

    # (d) the head checkpoint served in bf16 through the CLI's worker.
    served = serve_trained(torch, np, tm, attention, fcfg, ckpt_head, names,
                           held, [names.index(TRAIN_LABELS[c])
                                  for c in held_labels], root, device, smi)
    main_launches["sm90"] += served["launches"]["sm90"]
    emit("train.serve", **served)
    emit("times.train", step="cli", head_s=head_s, lora_s=lora_s,
         full_s={k: v["seconds"] for k, v in runs.items()},
         peak_mem_bytes={"head": head_mem, "lora": lora_mem,
                         **{f"full_{k}": v["peak_mem_bytes"]
                            for k, v in runs.items()}},
         card=smi)
    work.cleanup()
    lap("serve")
    emit("times.train", step="parts", seconds=laps, card=smi)
    emit("slice.train", seconds=time.perf_counter() - t_phase,
         kernel_launches_by_path=main_launches,
         feature_posts_per_s=feature_row["posts_per_s"],
         step_ms={r["scope"]: r["ms"] for r in step_rows})
    return {"launches": main_launches}


# Phase 15 (slice.orchestrator): the orchestrator over the card's workers.
ORCH_SEEDS, ORCH_FANOUT, ORCH_MAX_DEPTH = 8, 4, 2
ORCH_PAGES = 8 + 32 + 128            # the crawl graph: a tree of fan-out 4
ORCH_DEPTH2 = ORCH_SEEDS * ORCH_FANOUT ** 2
ORCH_POSTS_PER_PAGE = 24
ORCH_VALVE = (4, 2)                  # --infer-backpressure-high / -low
# A threshold rule on the fleet's queue depth as the heartbeats report
# it (the orchestrator's ``fleet_worker_queue_length{worker_id}`` gauge,
# sampled into the store on each watchtower tick).  The ``fleet_queue_depth``
# series is each worker's 60 s time-weighted mean, which a backlog of a
# few seconds never lifts over 2.
ORCH_RULE = {"name": "deep_queue", "kind": "threshold",
             "series": "fleet_worker_queue_length", "op": ">", "value": 2}
# The stand-ins crawl a page at once: its posts go to the bridge, then its
# result to the orchestrator.  A `Hold` keeps some back so that the crawl
# stands where a check needs it, whatever the card's rate: in run A depth
# 2's posts until the tpu-worker is stopped, and their results until the
# valve has released; in run B all but ORCH_B_FREE of depth 1's results
# until the orchestrator is killed.
ORCH_B_FREE = 16
# The valve's backlog in run A (`hold_backlog`): the tpu-worker is stopped
# (SIGSTOP) while depth 2's 3,072 posts reach the broker in the CLI's
# 256-post batches, runs ORCH_FILL_S to take them in (its feed loop takes
# 4 batches to a dispatch and the rest queue), stops past its next
# heartbeat's time, and runs until that heartbeat reaches the orchestrator.
# Stopped again there, the backlog it reported stands until the valve has
# engaged and the rule fired; then it runs on and drains.
ORCH_BEAT_S = 1.0                    # the workers' --telemetry-interval
ORCH_FILL_S = 0.5
ORCH_HOLD_S = 30.0                   # six distribute ticks
ORCH_KILL_OUTAGE_S = 3.0
ORCH_OFFSET_TOL = 0.05   # s: the fleet's estimate between two reads
ORCH_DEADLINE_S = 300.0

def orch_graph(np, seed):
    """Seeded channel names: 8 seeds, each page with 4 children down to
    depth 2 (a tree: 168 distinct pages)."""
    rng = np.random.default_rng(seed + 15)
    seeds = [f"ch{int(x):06x}" for x in rng.integers(0, 1 << 24,
                                                     ORCH_SEEDS)]
    check(len(set(seeds)) == ORCH_SEEDS, "seed names collide")
    return seeds


def orch_children(url):
    return [f"{url}x{i}" for i in range(ORCH_FANOUT)]


def orch_posts(np, url, seed):
    """A page's 24 posts, their texts made as phase 4's are; uids from the
    page, so a page crawled twice stores the same posts."""
    from distributed_crawler_tpu_torch.datamodel.post import Post

    rng = np.random.default_rng([seed, *url.encode()])
    rows = synthetic_posts(np, rng, ORCH_POSTS_PER_PAGE, 0)
    return [Post(post_uid=f"{url}:{i}", channel_name=url,
                 description=r["description"]) for i, r in enumerate(rows)]


class Hold:
    """Lets the first ``free`` stand-in pages of one gate through, ``n``
    more on each `admit(n)`, and the rest once the script calls `release`
    (or the deadline passes)."""

    def __init__(self, free=0):
        import threading

        self.free = free
        self.cond = threading.Condition()
        self.opened = False
        self.arrived = 0

    def wait(self):
        with self.cond:
            self.arrived += 1
            n = self.arrived
            self.cond.wait_for(lambda: self.opened or n <= self.free,
                               ORCH_DEADLINE_S)

    def admit(self, n):
        with self.cond:
            self.free += n
            self.cond.notify_all()

    def release(self):
        with self.cond:
            self.opened = True
            self.cond.notify_all()


class StandInCrawler:
    """A crawl worker on the bus, as the reference's `Worker` is there
    (`distributed_crawler_tpu/worker/worker.py:250-300`): heartbeats with
    ``worker_type="crawl"`` (busy with the item's id while crawling), one
    `ResultMessage` per `WorkQueueMessage` with the page's 4 children
    while above the crawl's max depth, and the page's posts stored through
    the shared `InferenceBridge`.  It fetches nothing and crawls a page at
    once, but for the run's ``holds`` ({("posts" or "results", depth):
    `Hold`}): the script's own load, not a feature of the port."""

    def __init__(self, np, worker_id, address, bridge, seed, work, holds):
        import concurrent.futures
        import threading

        from distributed_crawler_tpu_torch.bus.grpc_bus import RemoteBus
        from distributed_crawler_tpu_torch.bus.messages import (
            TOPIC_WORK_QUEUE,
        )
        from distributed_crawler_tpu_torch.bus.outbox import OutboxConfig

        self.np, self.worker_id, self.bridge, self.seed = \
            np, worker_id, bridge, seed
        self.holds = holds
        self.bus = RemoteBus(address, outbox=OutboxConfig(
            dir=os.path.join(work, f"outbox_{worker_id}")))
        self.pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=128, thread_name_prefix=worker_id)
        self.lock = threading.Lock()
        self.busy = {}
        self.done = self.errors = 0
        self.items = []
        self.stop_beat = threading.Event()
        self.t0 = time.monotonic()
        self.beat("worker_started")
        self.beater = threading.Thread(target=self._beat_loop, daemon=True)
        self.beater.start()
        self.bus.subscribe(TOPIC_WORK_QUEUE, self._on_work)

    def beat(self, message_type="heartbeat"):
        from distributed_crawler_tpu_torch.bus.messages import (
            TOPIC_WORKER_STATUS,
            StatusMessage,
        )

        with self.lock:
            current = next(iter(self.busy), None)
            n, err = self.done, self.errors
        msg = StatusMessage.new(
            self.worker_id, message_type, "busy" if current else "idle",
            tasks_processed=n, tasks_success=n - err, tasks_error=err,
            uptime_s=time.monotonic() - self.t0, worker_type="crawl")
        msg.current_work = current
        self.bus.publish(TOPIC_WORKER_STATUS, msg.to_dict())

    def _beat_loop(self):
        while not self.stop_beat.wait(ORCH_BEAT_S):
            try:
                self.beat()
            except Exception as e:  # the broker may be down (run B)
                logging.getLogger("chip_smoke").debug("beat: %s", e)

    def _on_work(self, payload):
        from distributed_crawler_tpu_torch.bus.messages import (
            WorkQueueMessage,
        )

        msg = WorkQueueMessage.from_dict(payload)
        item = msg.work_item
        with self.lock:
            self.busy[item.id] = item.url
            self.items.append(item.id)
        self.pool.submit(self._crawl, item)

    def _hold(self, kind, depth):
        hold = self.holds.get((kind, depth))
        if hold is not None:
            hold.wait()

    def _crawl(self, item):
        from distributed_crawler_tpu_torch.bus import codec
        from distributed_crawler_tpu_torch.bus.messages import (
            STATUS_SUCCESS,
            TOPIC_RESULTS,
            DiscoveredPage,
            ResultMessage,
            WorkResult,
        )
        from distributed_crawler_tpu_torch.utils import trace

        t0 = time.monotonic()
        with trace.span("crawl_worker.process", trace_id=item.trace_id,
                        work_item=item.id, url=item.url, depth=item.depth):
            self._hold("posts", item.depth)
            posts = orch_posts(self.np, item.url, self.seed)
            for p in posts:
                self.bridge.store_post(item.url, p)
            self._hold("results", item.depth)
            found = [] if item.depth >= item.config.max_depth else [
                DiscoveredPage(url=u, parent_id=item.parent_id,
                               depth=item.depth + 1, platform=item.platform)
                for u in orch_children(item.url)]
            wr = WorkResult(work_item_id=item.id, worker_id=self.worker_id,
                            status=STATUS_SUCCESS, processed_url=item.url,
                            message_count=len(posts),
                            processing_time_s=time.monotonic() - t0,
                            completed_at=codec.utcnow())
            self.bus.publish(TOPIC_RESULTS, ResultMessage.new(
                wr, found, trace_id=item.trace_id).to_dict())
        with self.lock:
            self.busy.pop(item.id, None)
            self.done += 1

    def close(self):
        self.stop_beat.set()
        self.beater.join(timeout=5)
        self.pool.shutdown(wait=True)
        try:
            self.beat("worker_stopping")
        finally:
            self.bus.close()


def orch_argv(address, metrics_port, store, spool, journal, crawl_id,
              seeds, dump, extra=("--cluster-serve",
                                  "--infer-backpressure-high",
                                  str(ORCH_VALVE[0]),
                                  "--infer-backpressure-low",
                                  str(ORCH_VALVE[1]))):
    """Phase 15's orchestrator; ``extra`` (phase 15's clustering stage
    and valve by default) is phase 16's autoscaler instead."""
    rules = json.dumps([ORCH_RULE])
    return ("--mode", "orchestrator", "--bus-address", address,
            "--metrics-port", str(metrics_port), "--storage-root", store,
            "--crawl-id", crawl_id, "--bus-spool-dir", spool,
            "--journal-dir", journal, "--max-depth", str(ORCH_MAX_DEPTH),
            "--urls", ",".join(seeds), "--skip-media", *extra,
            "--alert-rules", rules, "--dump-dir", dump, "--log-json")


class StatusWatch:
    """Polls the orchestrator's /status every 50 ms on a thread: the
    valve's engaged time and transitions, the highest inference backlog,
    and the last body seen."""

    def __init__(self, url):
        import threading

        self.url = url
        self.last = None
        self.engaged_s = 0.0
        self.transitions = []
        self.max_backlog = 0
        self.seen_resumed = False
        self.on = False
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        prev_t, prev_on = None, False
        while not self._stop.wait(0.05):
            body = json_route(self.url, "/status")
            if body is None:
                continue
            now = time.monotonic()
            on = bool(body.get("backpressure_active"))
            if prev_t is not None and prev_on:
                self.engaged_s += now - prev_t
            if on != prev_on:
                self.transitions.append((round(now, 3), on,
                                         body.get("inference_backlog")))
            prev_t, prev_on = now, on
            self.on = on
            self.max_backlog = max(self.max_backlog,
                                   body.get("inference_backlog") or 0)
            self.seen_resumed |= bool(body.get("resumed"))
            self.last = body

    def close(self):
        self._stop.set()
        self._t.join(timeout=5)


def orch_rows(store, crawl_id):
    """Every result row the tpu-worker committed for ``crawl_id``."""
    base = os.path.join(store, "inference", crawl_id, "batches")
    rows = []
    for name in sorted(os.listdir(base)) if os.path.isdir(base) else []:
        if name.endswith(".tmp"):
            continue   # a file the worker is writing (renamed when done)
        with open(os.path.join(base, name), encoding="utf-8") as f:
            rows += [json.loads(line) for line in f]
    return rows


ORCH_ROUTES = ("/cluster", "/dtraces", "/alerts", "/tenants")


def orch_run(np, procs, work, tag, address, store, seed, holds, act,
             extra=None):
    """One crawl: an orchestrator process over the running workers (or,
    with phase 16's ``extra`` flags, over the children its autoscaler
    spawns), two stand-ins and their shared bridge in this process.
    ``act(run)`` steers it once the stand-ins are up (`hold_backlog`,
    `kill_and_resume`, `autoscale_burst`); the crawl then runs to
    completion."""
    import types

    from distributed_crawler_tpu_torch.bus.grpc_bus import RemoteBus
    from distributed_crawler_tpu_torch.bus.messages import (
        TOPIC_ALERTS,
        TOPIC_SPANS,
        SpanBatchMessage,
    )
    from distributed_crawler_tpu_torch.bus.outbox import OutboxConfig
    from distributed_crawler_tpu_torch.config.crawler import InferenceConfig
    from distributed_crawler_tpu_torch.inference.bridge import InferenceBridge
    from distributed_crawler_tpu_torch.orchestrator.journal import (
        CrawlJournal,
    )
    from distributed_crawler_tpu_torch.state.interface import StateConfig
    from distributed_crawler_tpu_torch.state.local import LocalStateManager
    from distributed_crawler_tpu_torch.utils import trace

    crawl_id = f"orch-{tag}"
    root = os.path.join(work, tag)
    os.makedirs(root)
    journal = os.path.join(root, "journal")
    state = os.path.join(root, "state")
    m_orch = free_port()
    ourl = f"http://127.0.0.1:{m_orch}"
    argv = orch_argv(address, m_orch, state, os.path.join(root, "spool"),
                     journal, crawl_id, orch_graph(np, seed),
                     os.path.join(root, "dump"),
                     **({} if extra is None else {"extra": extra}))
    run = types.SimpleNamespace(tag=tag, argv=argv, procs=procs, ourl=ourl,
                                holds=holds, names=[f"orch_{tag}"],
                                out={"crawl_id": crawl_id},
                                restarted_at=None)
    t0 = time.perf_counter()
    # The autoscaler's children inherit the orchestrator's log. Unbuffered,
    # every line of every process is one append, so no two run together.
    run.orch = procs.start(run.names[-1], *argv, env=None if extra is None
                           else {"PYTHONUNBUFFERED": "1"})
    poll_until(lambda: json_route(ourl, "/status"),
               "the orchestrator's /status", procs=[run.orch], timeout_s=120)
    run.watch = StatusWatch(ourl)
    # A crawl worker's bridge at the CLI's defaults: 256-post batches,
    # a partial one shipped 50 ms after its first post.
    infer = InferenceConfig()
    run.bridge_bus = RemoteBus(address, outbox=OutboxConfig(
        dir=os.path.join(root, "outbox_bridge")))
    run.bridge = InferenceBridge(
        LocalStateManager(StateConfig(
            storage_root=os.path.join(root, "posts"), crawl_id=crawl_id)),
        run.bridge_bus, crawl_id=crawl_id, batch_size=infer.batch_size,
        deadline_s=infer.batch_deadline_ms / 1000.0)
    alerts_bus = RemoteBus(address)
    run.alerts = []
    alerts_bus.subscribe(TOPIC_ALERTS, run.alerts.append)
    # The stand-ins' spans (and the bridge's batch dispatch spans) go to
    # the collector as a worker's do.
    exporter = trace.SpanExporter(name_prefixes=("crawl_worker.",
                                                 "orchestrator.dispatch"))
    crawlers = [StandInCrawler(np, f"crawl-{tag}{i}", address, run.bridge,
                               seed, root, holds) for i in range(2)]
    routes = {}
    try:
        act(run)
        deadline = time.monotonic() + ORCH_DEADLINE_S
        last_poll = 0.0
        while run.orch.poll() is None:
            check(time.monotonic() < deadline,
                  f"{tag}: the crawl did not complete in "
                  f"{ORCH_DEADLINE_S} s: {run.watch.last}")
            if time.monotonic() - last_poll >= 0.5:
                last_poll = time.monotonic()
                spans, dropped = exporter.collect()
                if spans:
                    run.bridge_bus.publish(TOPIC_SPANS, SpanBatchMessage.new(
                        "crawl-stand-ins", [s.to_dict() for s in spans],
                        dropped).to_dict())
                # The last poll in which every route answered.
                got = {route: json_route(ourl, route)
                       for route in ORCH_ROUTES}
                if all(body is not None for body in got.values()):
                    routes = got
            time.sleep(0.02)
        t_done = time.perf_counter()
        procs.live.remove(run.orch)
        check(run.orch.returncode == 0, f"{tag}: the orchestrator exited "
              f"{run.orch.returncode}: {procs.tail(run.orch.name)}")
    finally:
        for hold in holds.values():
            hold.release()
        run.watch.close()
        for c in crawlers:
            c.close()
        run.bridge.close()
        run.bridge_bus.close()
        alerts_bus.close()
    log, broken = [], []
    for name in run.names:
        with open(os.path.join(procs.work, f"{name}.log"),
                  encoding="utf-8", errors="replace") as f:
            for ln in f:
                try:
                    rec = json.loads(ln) if ln.startswith("{") else None
                except ValueError:
                    rec = None
                if isinstance(rec, dict):
                    log.append(rec)
                elif '"logger"' in ln:
                    broken.append(ln)  # a record another line cut into
    with open(os.path.join(state, crawl_id, "state.json"),
              encoding="utf-8") as f:
        layers = json.load(f)["layers"]
    out = run.out
    out.update(
        crawl_s=t_done - t0, watch=run.watch, routes=routes,
        alerts=run.alerts, log=log, broken_log_lines=broken, layers=layers,
        journal=CrawlJournal(journal).replay(),
        rows=orch_rows(store, crawl_id),
        bridge={"batches": run.bridge.batches_published,
                "posts": run.bridge.posts_bridged,
                "deduped": run.bridge.posts_deduped},
        items_taken=sum(len(c.items) for c in crawlers))
    if run.restarted_at is not None:
        out["restart_to_completion_s"] = t_done - run.restarted_at
    return out


def alert_states(alerts):
    return [a["state"] for a in alerts if a.get("rule") == ORCH_RULE["name"]]


def hold_backlog(run, tpu, tpu_id):
    """Run A: depth 2's posts held at a stopped tpu-worker until the
    orchestrator's valve has engaged and its rule fired on them; then the
    worker drains and the valve releases (see ORCH_FILL_S)."""
    import signal

    posts, results = run.holds[("posts", 2)], run.holds[("results", 2)]
    total = ORCH_PAGES * ORCH_POSTS_PER_PAGE

    def tpu_row():
        body = json_route(run.ourl, "/cluster") or {}
        return body.get("workers", {}).get(tpu_id) or {}

    poll_until(lambda: posts.arrived >= ORCH_DEPTH2,
               "run A: depth 2 dispatched", procs=[run.orch],
               timeout_s=ORCH_DEADLINE_S)
    rec = {}
    b0 = run.bridge.batches_published
    tpu.send_signal(signal.SIGSTOP)
    t_stop = time.monotonic()
    try:
        posts.release()
        poll_until(lambda: run.bridge.posts_bridged >= total,
                   "run A: depth 2's posts bridged", timeout_s=60)
        # Past the bridge's 50 ms deadline, so its flush thread has shipped
        # the last partial batch; then into the broker.
        time.sleep(0.2)
        run.bridge.flush()
        check(run.bridge_bus.outbox.drain(timeout_s=60),
              "run A: the bridge's outbox did not drain into the broker")
        rec["batches_held"] = run.bridge.batches_published - b0
        tpu.send_signal(signal.SIGCONT)
        time.sleep(ORCH_FILL_S)
        tpu.send_signal(signal.SIGSTOP)
        time.sleep(ORCH_BEAT_S + 0.2)
        seen = tpu_row().get("heartbeats", 0)
        tpu.send_signal(signal.SIGCONT)
        row = poll_until(
            lambda: (lambda r: r if r.get("heartbeats", 0) > seen
                     else None)(tpu_row()),
            "run A: the tpu-worker's heartbeat after its fill",
            timeout_s=10 * ORCH_BEAT_S, poll_s=0.002)
        tpu.send_signal(signal.SIGSTOP)
        rec["reported_queue"] = row["queue_length"]
        check(row["queue_length"] >= ORCH_VALVE[0],
              f"run A: the held tpu-worker reported a queue of "
              f"{row['queue_length']} batches, under the valve's "
              f"{ORCH_VALVE[0]} ({rec['batches_held']} held)")
        t_held = time.monotonic()
        poll_until(lambda: run.watch.on
                   and "firing" in alert_states(run.alerts),
                   "run A: the valve engaged and the rule fired on the "
                   "held backlog", procs=[run.orch], timeout_s=ORCH_HOLD_S)
        rec["engaged_after_s"] = time.monotonic() - t_held
    finally:
        tpu.send_signal(signal.SIGCONT)
    rec["worker_stopped_s"] = time.monotonic() - t_stop
    t_go = time.monotonic()
    poll_until(lambda: not run.watch.on
               and "resolved" in alert_states(run.alerts),
               "run A: the valve released and the rule resolved as the "
               "worker drained", procs=[run.orch, tpu], timeout_s=ORCH_HOLD_S)
    rec["released_after_s"] = time.monotonic() - t_go
    results.release()
    run.out["hold"] = rec


def kill_and_resume(run):
    """Run B: SIGKILL the orchestrator once ORCH_B_FREE of depth 1's
    results are applied and the others held, let them go into the outage,
    and restart it over the same journal and spool after
    ORCH_KILL_OUTAGE_S."""
    want = ORCH_SEEDS + ORCH_B_FREE
    poll_until(lambda: (run.watch.last or {}).get("work_stats", {}).get(
        "completed_items", 0) >= want, f"run B: {want} results applied",
        procs=[run.orch], timeout_s=ORCH_DEADLINE_S, poll_s=0.005)
    run.procs.kill(run.orch)
    applied = run.watch.last["work_stats"]["completed_items"]
    check(applied == want, f"run B: {applied} results applied at the kill, "
          f"not {want}")
    run.out["applied_at_kill"] = applied
    run.holds[("results", 1)].release()
    time.sleep(ORCH_KILL_OUTAGE_S)
    run.names.append(f"orch_{run.tag}_restart")
    run.orch = run.procs.start(run.names[-1], *run.argv)
    run.restarted_at = time.perf_counter()


def commit_rate(store, crawl_id):
    """The tpu-worker's commits of one crawl, grouped into bursts (files
    written less than 2 s apart): the largest burst's rows over the time
    from its first writeback to its last (a lower bound on the worker's
    rate: the first file's batch was already processed)."""
    base = os.path.join(store, "inference", crawl_id, "batches")
    files = []
    for name in os.listdir(base):
        path = os.path.join(base, name)
        with open(path, encoding="utf-8") as f:
            files.append((os.path.getmtime(path), sum(1 for _ in f)))
    files.sort()
    bursts = [[files[0]]]
    for prev, cur in zip(files, files[1:]):
        if cur[0] - prev[0] > 2.0:
            bursts.append([])
        bursts[-1].append(cur)
    big = max(bursts, key=lambda b: sum(r for _, r in b))
    span = big[-1][0] - big[0][0]
    rows = sum(r for _, r in big)
    return {"files": len(files), "bursts": len(bursts),
            "largest_burst": {"files": len(big), "rows": rows,
                              "first_to_last_s": span,
                              "posts_per_s": rows / span if span else None}}


def check_crawl(np, run, seed, what):
    """168 pages fetched and applied once; 4,032 posts, one row each."""
    final = run["watch"].last or {}
    check(final.get("crawl_completed") is True, f"{what}: last /status "
          f"{final}")
    stats = final["work_stats"]
    check(stats["completed_items"] == ORCH_PAGES and stats["error_items"]
          == 0, f"{what}: work stats {stats}")
    pages = [p for layer in run["layers"] for p in layer["pages"]]
    by_depth = [len(layer["pages"]) for layer in run["layers"]]
    check(by_depth == [ORCH_SEEDS, ORCH_SEEDS * ORCH_FANOUT,
                       ORCH_SEEDS * ORCH_FANOUT ** 2]
          and all(p["status"] == "fetched" for p in pages)
          and len({p["url"] for p in pages}) == ORCH_PAGES,
          f"{what}: pages by depth {by_depth}, statuses "
          f"{sorted({p['status'] for p in pages})}")
    rec = run["journal"]
    check(rec.completed_items == ORCH_PAGES and rec.error_items == 0
          and len(rec.applied_results) == ORCH_PAGES
          and not rec.active_work and rec.crawl_completed,
          f"{what}: the journal's replay {rec.to_debug_dict()}")
    uids = [r["post_uid"] for r in run["rows"]]
    want = {f"{p['url']}:{i}" for p in pages
            for i in range(ORCH_POSTS_PER_PAGE)}
    check(len(uids) == len(want) == ORCH_PAGES * ORCH_POSTS_PER_PAGE
          and set(uids) == want,
          f"{what}: {len(uids)} result rows ({len(set(uids))} posts) for "
          f"{len(want)} posts")
    emb_ok = all(len(r["embedding"]) == 384 and np.isfinite(
        r["embedding"]).all() for r in run["rows"][:64])
    check(emb_ok, f"{what}: result embeddings not 384 finite floats")
    return {"pages": len(pages), "pages_by_depth": by_depth,
            "applied": len(rec.applied_results), "rows": len(uids),
            "journal_events_replayed": rec.events_replayed}


def check_surfaces(run, tpu_id):
    """Run A's routes: the valve, /cluster, /dtraces, the alert, /tenants
    and the cluster guide."""
    watch, routes = run["watch"], run["routes"]
    flips = [on for _, on, _ in watch.transitions]
    check(True in flips and False in flips[flips.index(True):],
          f"the valve: /status transitions {watch.transitions}")
    msgs = [r.get("message", "") for r in run["log"]]
    engaged = sum("inference backlog high" in m for m in msgs)
    released = sum("inference backlog drained" in m for m in msgs)
    check(engaged >= 1 and released >= 1,
          f"the valve's log lines: {engaged} engaged, {released} released")
    cluster = routes.get("/cluster") or {}
    row = cluster.get("workers", {}).get(tpu_id) or {}
    mem = sum(d.get("bytes_in_use", 0) for d in
              row.get("telemetry", {}).get("device_memory", []))
    check(row.get("worker_type") == "tpu" and mem > 0,
          f"/cluster: {tpu_id} {row.get('worker_type')}, card memory {mem}")
    # The collector moves a batch's span walls by the fleet's estimate at
    # the time it folds the batch; the two routes are read in one poll.
    offset = row["clock_offset_s"]
    dtraces = routes.get("/dtraces") or {}
    traces = dtraces.get("traces", [])
    applied = dtraces.get("workers", {}).get(tpu_id, {}).get(
        "applied_offset_s")
    tpu_spans = [s for t in traces for s in t["spans"]
                 if s.get("process") == tpu_id]
    check(tpu_spans and applied is not None
          and abs(applied - offset) <= ORCH_OFFSET_TOL
          and all(isinstance(s.get("clock_offset_s"), float)
                  for s in tpu_spans),
          f"/dtraces: {len(tpu_spans)} spans of {tpu_id}, the last batch "
          f"moved by {applied} s against the fleet's offset {offset} s")
    joined = [t for t in traces
              if any(s["name"] == "orchestrator.dispatch"
                     and s["process"] == "orchestrator" for s in t["spans"])
              and any(s["process"] == "crawl-stand-ins"
                      for s in t["spans"])]
    check(joined, "/dtraces: no trace joins the orchestrator's dispatch "
          "span and a crawl worker's")
    states = alert_states(run["alerts"])
    check("firing" in states and "resolved" in states[states.index(
        "firing"):], f"the alert on TOPIC_ALERTS: {states}")
    body = routes.get("/alerts") or {}
    rule = next((a for a in body.get("alerts", [])
                 if a["rule"] == ORCH_RULE["name"]), {})
    check(rule.get("fired_count", 0) >= 1, f"/alerts: {rule}")
    chip_s = ((routes.get("/tenants") or {}).get("tenants", {})
              .get("default", {}).get("spend", {}).get("chip_seconds", 0))
    check(chip_s > 0, f"/tenants: default chip seconds {chip_s}")
    guide = (watch.last or {}).get("cluster_guide") or {}
    check(guide.get("step", 0) >= 1, f"/status cluster_guide {guide}")
    return {"valve_transitions": watch.transitions,
            "valve_log_engaged": engaged, "valve_log_released": released,
            "tpu_card_memory_bytes": mem, "tpu_clock_offset_s": offset,
            "tpu_applied_offset_s": applied,
            "tpu_queue_history": row.get("history", []),
            "dtraces": len(traces), "tpu_spans": len(tpu_spans),
            "joined_traces": len(joined), "alert_states": states,
            "alert_fired_count": rule["fired_count"],
            "tenant_default_chip_s": chip_s, "cluster_guide": guide}


# Phase 15's run C (slice.random_walk): the random walk's distributed step
# through the port's CrawlWorker over a SQLite graph, then a channel crawl
# of the channels it stepped to, whose posts reach the card's tpu-worker.
WALK_SEEDS = 8
WALK_KIDS = 3               # channels each seed names that exist
WALK_POSTS = 64             # posts of each channel the walk can step to
WALK_GHOST = "walkghost"    # a username that does not exist
WALK_PRIVATE = "walkprivate"  # a chat that is not a supergroup


def walk_network(np, seed):
    """The seeded network: 8 seeds, each naming its own 3 channels (in
    mentions and t.me links), the missing username and the private chat,
    over 4 posts; each named channel holds 64 posts of phase 4's texts,
    which name no channel."""
    from distributed_crawler_tpu_torch.clients import SimNetwork, TLMessage

    rng = np.random.default_rng(seed + 18)
    seeds = [f"rw{int(x):06x}" for x in rng.integers(0, 1 << 24,
                                                     WALK_SEEDS)]
    check(len(set(seeds)) == WALK_SEEDS, "walk seed names collide")

    def msg(body, i):
        return TLMessage(content={"@type": "messageText",
                                  "text": {"text": body, "entities": []}},
                         date=1700000000 + 60 * i,
                         view_count=int(rng.integers(1, 500)))

    net = SimNetwork()
    kids = {}
    for s in seeds:
        kids[s] = [f"{s}k{i}" for i in range(WALK_KIDS)]
        names = kids[s] + [WALK_GHOST, WALK_PRIVATE]
        net.add_channel(s, messages=[msg(f"post {i} " + " ".join(
            (f"@{n}" if (i + j) % 2 else f"t.me/{n}")
            for j, n in enumerate(names)), i) for i in range(4)],
            member_count=1000)
        for k in kids[s]:
            rows = synthetic_posts(np, rng, WALK_POSTS, 0)
            net.add_channel(k, messages=[msg(r["description"], i)
                                         for i, r in enumerate(rows)],
                            member_count=1000)
    net.add_channel(WALK_PRIVATE, messages=[msg("private", 0)],
                    is_supergroup=False)
    return net, seeds, kids


def walk_pool(net):
    """One pooled `SimTelegramClient` without proactive waits (the
    reference's limits pace phase 17's crawl leg: one search per 10 s)."""
    from distributed_crawler_tpu_torch.clients import (
        ConnectionPool,
        SimTelegramClient,
    )
    from distributed_crawler_tpu_torch.config.crawler import (
        TelegramRateLimitConfig,
    )
    from distributed_crawler_tpu_torch.crawl import runner as crawl_runner

    crawl_runner.shutdown_connection_pool()
    crawl_runner.init_connection_pool(ConnectionPool.for_testing(
        {"conn0": SimTelegramClient(net, conn_id="conn0")},
        rate_limit=TelegramRateLimitConfig(
            get_chat_history_rate=0, search_public_chat_rate=0,
            get_supergroup_info_rate=0, get_message_server_hit_rate=0,
            get_chat_history_jitter_ms=0, search_public_chat_jitter_ms=0,
            get_supergroup_info_jitter_ms=0,
            get_message_server_hit_jitter_ms=0)))


def walk_crawl(procs, root, address, store, tag, urls, *flags):
    """One ``--mode orchestrator`` crawl of ``urls``, hosting the broker at
    phase 15's address, the port's `CrawlWorker` in this process taking
    its items, its `CompositeStateManager` (a SQLite graph file under the
    run's root) behind an `InferenceBridge` at the CLI's defaults into the
    tpu-worker.  Returns the run's paths, seconds and bridge counts."""
    from distributed_crawler_tpu_torch.bus.grpc_bus import RemoteBus
    from distributed_crawler_tpu_torch.config.crawler import (
        CrawlerConfig,
        InferenceConfig,
    )
    from distributed_crawler_tpu_torch.inference.bridge import InferenceBridge
    from distributed_crawler_tpu_torch.state import (
        CompositeStateManager,
        StateConfig,
    )
    from distributed_crawler_tpu_torch.worker import CrawlWorker

    crawl_id = f"orch-{tag}"
    run = os.path.join(root, tag)
    os.makedirs(run)
    state, wrk = os.path.join(run, "state"), os.path.join(run, "wrk")
    m_orch = free_port()
    ourl = f"http://127.0.0.1:{m_orch}"
    t0 = time.perf_counter()
    orch = procs.start(
        f"orch_{tag}", "--mode", "orchestrator", "--bus-address", address,
        "--metrics-port", str(m_orch), "--storage-root", state,
        "--crawl-id", crawl_id, "--journal-dir",
        os.path.join(run, "journal"), "--urls", ",".join(urls),
        "--skip-media", "--log-json", *flags)
    poll_until(lambda: json_route(ourl, "/status"),
               f"{tag}: the orchestrator's /status", procs=[orch],
               timeout_s=120)
    infer = InferenceConfig()
    bus = RemoteBus(address)
    bridge = InferenceBridge(
        CompositeStateManager(StateConfig(
            crawl_id=crawl_id, crawl_execution_id="e1", storage_root=wrk)),
        bus, crawl_id=crawl_id, batch_size=infer.batch_size,
        deadline_s=infer.batch_deadline_ms / 1000.0)
    worker = CrawlWorker(f"crawl-{tag}", CrawlerConfig(
        crawl_id=crawl_id, platform="telegram", skip_media_download=True),
        bus, bridge)
    try:
        worker.start()
        try:
            rc = orch.wait(timeout=ORCH_DEADLINE_S)
        except subprocess.TimeoutExpired:
            raise Fail(f"{tag}: the crawl did not complete in "
                       f"{ORCH_DEADLINE_S} s: {procs.tail(orch.name)}")
        crawl_s = time.perf_counter() - t0
        procs.live.remove(orch)
        check(rc == 0, f"{tag}: the orchestrator exited {rc}: "
              f"{procs.tail(orch.name)}")
    finally:
        worker.stop()   # closes the bridge: the rest is shipped
        bus.close()
    with open(os.path.join(state, crawl_id, "state.json"),
              encoding="utf-8") as f:
        layers = json.load(f)["layers"]
    with open(os.path.join(state, crawl_id, "metadata.json"),
              encoding="utf-8") as f:
        status = json.load(f)["status"]
    pages = [p for layer in layers for p in layer["pages"]]
    check(status == "completed" and [p["url"] for p in pages] == list(urls)
          and all(p["status"] == "fetched" for p in pages),
          f"{tag}: metadata {status}, pages "
          f"{[(p['url'], p['status']) for p in pages]}")
    stored = []
    base = os.path.join(wrk, crawl_id)
    for ch in sorted(os.listdir(base)) if os.path.isdir(base) else []:
        path = os.path.join(base, ch, "posts", "posts.jsonl")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                stored += [json.loads(ln)["post_uid"] for ln in f]
    return {"crawl_id": crawl_id, "crawl_s": crawl_s, "pages": pages,
            "graph": os.path.join(wrk, "graph.db"), "stored": stored,
            "orch_graph": os.path.isfile(os.path.join(state,
                                                      "graph.sqlite")),
            "bridge": {"batches": bridge.batches_published,
                       "posts": bridge.posts_bridged}}


def walk_rows(path):
    """The walk's graph file, read with sqlite3 alone."""
    import sqlite3

    con = sqlite3.connect(path)
    try:
        q = con.execute
        return {
            "edges": q("SELECT destination_channel, source_channel, "
                       "walkback, skipped, sequence_id FROM edge_records "
                       "ORDER BY edge_id").fetchall(),
            "buffer": q("SELECT url, parent_id, depth, sequence_id FROM "
                        "page_buffer").fetchall(),
            "seeds": dict(q("SELECT channel_username, chat_id FROM "
                            "seed_channels").fetchall()),
            "crawled": {r[0] for r in q(
                "SELECT channel_username FROM seed_channels WHERE "
                "last_crawled_at IS NOT NULL").fetchall()},
            "invalid": dict(q("SELECT channel_username, reason FROM "
                              "invalid_channels").fetchall())}
    finally:
        con.close()


def check_walk(rows, net, seeds, kids, pages):
    """Per seed: one primary edge, skipped edges for its other new
    channels, one page-buffer row on the primary destination whose
    sequence id follows the forward/walkback rule; the chat ids and the
    invalid marks."""
    ids = {p["url"]: p["id"] for p in pages}
    primaries = {}
    for s in seeds:
        mine = [e for e in rows["edges"] if e[1] == s]
        primary = [e for e in mine if not e[3]]
        check(len(primary) == 1, f"walk {s}: primary edges {primary}")
        dest, _, walkback, _, seq = primary[0]
        new = set(kids[s])
        if walkback:
            want = sorted(new)   # no new channel is taken on a walkback
            check(dest not in new and dest != s,
                  f"walk {s}: walked back to {dest}")
        else:
            want = sorted(new - {dest})
            check(dest in new, f"walk {s}: stepped forward to {dest}")
        skipped = sorted(e[0] for e in mine if e[3])
        check(skipped == want and not any(e[2] for e in mine if e[3]),
              f"walk {s}: skipped edges {skipped}, expected {want}")
        buf = [b for b in rows["buffer"] if b[1] == ids[s]]
        check(len(buf) == 1 and buf[0][0] == dest and buf[0][2] == 1
              and (buf[0][3] != seq and len(buf[0][3]) == 36 if walkback
                   else buf[0][3] == seq),
              f"walk {s}: page-buffer rows {buf} for the primary edge "
              f"{primary[0]}")
        primaries[s] = (dest, bool(walkback))
    check(len(rows["buffer"]) == len(seeds),
          f"walk: {len(rows['buffer'])} page-buffer rows for {len(seeds)} "
          "seeds")
    found = set(seeds) | {k for s in seeds for k in kids[s]}
    want_ids = {n: net.channels[n].chat_id for n in found}
    check(rows["seeds"] == want_ids and rows["crawled"] == set(seeds),
          f"walk: seed_channels {rows['seeds']} (crawled "
          f"{sorted(rows['crawled'])}), expected the chat ids {want_ids}")
    check(rows["invalid"] == {WALK_GHOST: "not_found",
                              WALK_PRIVATE: "not_supergroup"},
          f"walk: invalid_channels {rows['invalid']}")
    return primaries


def walk_run(np, procs, root, address, store, url, seed):
    """Run C: the walk's step over the seeds, then a channel crawl of the
    channels it stepped to in this process (the walk's orchestrator has
    exited, so the script hosts the bus); 12 sm90 launches per dispatch
    of the tpu-worker over both."""
    from distributed_crawler_tpu_torch.crawl import runner as crawl_runner

    net, seeds, kids = walk_network(np, seed)
    before, d0 = proc_counts(url)
    walk_pool(net)
    try:
        walk = walk_crawl(procs, root, address, store, "C", seeds,
                          "--sampling", "random-walk")
        rows = walk_rows(walk["graph"])
        primaries = check_walk(rows, net, seeds, kids, walk["pages"])
        check(walk["stored"] == [] and walk["bridge"]["posts"] == 0
              and walk["orch_graph"],
              f"run C: the walk stored {len(walk['stored'])} posts and "
              f"bridged {walk['bridge']['posts']} (a random walk stores "
              f"none); the orchestrator's graph file {walk['orch_graph']}")
        nxt = [b[0] for b in rows["buffer"]]
        with PhaseBroker(address):
            crawl = follow_on_crawl(np, os.path.join(root, "C2"), address,
                                    store, nxt, "orch-C2", "C")
    finally:
        crawl_runner.shutdown_connection_pool()
    after, d1 = proc_counts(url)
    launches = {p: after[p] - before[p] for p in after}
    check_sm90_only(launches, 12, d1 - d0, "run C's tpu-worker")
    forward = sum(1 for _, back in primaries.values() if not back)
    return {
        "seeds": len(seeds), "edges": len(rows["edges"]),
        "edges_primary": len(seeds), "edges_forward": forward,
        "edges_walkback": len(seeds) - forward,
        "edges_skipped": sum(1 for e in rows["edges"] if e[3]),
        "page_buffer_rows": len(rows["buffer"]),
        "invalid_marks": len(rows["invalid"]),
        "seed_channel_chat_ids": len(rows["seeds"]),
        "walk_crawl_s": walk["crawl_s"], "walk_posts": len(walk["stored"]),
        "next_pages": len(nxt), "posts": crawl["follow_on_posts"],
        "posts_committed": crawl["follow_on_commits"],
        "crawl_s": crawl["follow_on_s"],
        "bridge_batches": crawl["bridge_batches"],
        "dispatches": d1 - d0, "kernel_launches_by_path": launches}


# Phase 15's run D (slice.tandem_walk): the tandem random walk, the
# reference's two-pod deployment.  The crawler pod is `modes.runner.launch`
# in this process; the validator pod is ``--mode launch --validate-only``,
# a CLI process that validates the crawler's pending edges against a t.me
# stand-in on loopback; they share one SQLite graph file and nothing else.
# The channels the walk stepped to are then crawled into the tpu-worker.
TANDEM_FOUR_SEED = "rwfourseed"   # a seed naming the 400 name and the ghost
TANDEM_FOUR = "rwfourhundred"     # valid on t.me, unknown to the network
TANDEM_WINDOW_S = 15.0            # the walk's max_crawl_duration_s
TANDEM_POLL_S = 0.25              # the walk's page-buffer poll
TANDEM_FIXTURES = {"valid": "valid-channel.html",
                   "not_supergroup": "not-a-supergroup.html",
                   "not_found": "username-not-occupied.html"}
# The final status (and reason) an edge gets from each page: the first
# edge to a name from the page, a later one from the validator's caches.
TANDEM_FIRST = {"valid": ("valid", ""),
                "not_supergroup": ("not_channel", "not_supergroup"),
                "not_found": ("invalid", "not_found")}
TANDEM_LATER = {"valid": ("duplicate", ""),
                "not_supergroup": ("invalid", "cached_invalid"),
                "not_found": ("invalid", "cached_invalid")}
# The script's own record of every pending edge's statuses: triggers on
# the shared graph file, which the port never reads.
TANDEM_EDGE_LOG = """
CREATE TABLE smoke_edge_log (n INTEGER PRIMARY KEY AUTOINCREMENT,
    pending_id INTEGER, channel TEXT, status TEXT, reason TEXT);
CREATE TRIGGER smoke_edge_new AFTER INSERT ON pending_edges BEGIN
    INSERT INTO smoke_edge_log (pending_id, channel, status, reason)
    VALUES (NEW.pending_id, NEW.destination_channel, 'inserted', '');
END;
CREATE TRIGGER smoke_edge_final AFTER UPDATE OF validation_status
    ON pending_edges WHEN NEW.validation_status NOT IN ('pending',
    'validating') BEGIN
    INSERT INTO smoke_edge_log (pending_id, channel, status, reason)
    VALUES (NEW.pending_id, NEW.destination_channel,
            NEW.validation_status, NEW.validation_reason);
END;
"""


def tandem_page(net, name):
    """The class of t.me's page for ``name``, rendered from the network:
    the 400 name shows as a valid channel."""
    ch = net.channels.get(name)
    if name == TANDEM_FOUR or (ch is not None and ch.is_supergroup):
        return "valid"
    return "not_supergroup" if ch is not None else "not_found"


class TmeStandIn:
    """t.me on loopback (`http.server`): each username's page from the
    fixtures, by `tandem_page`; the requests counted per username."""

    def __init__(self, net):
        import http.server
        import threading

        fixtures = os.path.join(ROOT, "tests", "fixtures", "telegram-html")
        bodies = {}
        for cls, name in TANDEM_FIXTURES.items():
            with open(os.path.join(fixtures, name), "rb") as f:
                bodies[cls] = f.read()
        self.requests = {}
        lock = threading.Lock()
        stand_in = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                name = self.path.strip("/")
                with lock:
                    stand_in.requests[name] = \
                        stand_in.requests.get(name, 0) + 1
                body = bodies[tandem_page(net, name)]
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="tme-stand-in", daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def tandem_rows(path):
    """The shared graph file after the walk, read with sqlite3 alone."""
    import sqlite3

    con = sqlite3.connect(path)
    try:
        q = con.execute
        return {
            "edges": q("SELECT destination_channel, source_channel, "
                       "walkback, skipped, sequence_id FROM edge_records "
                       "ORDER BY edge_id").fetchall(),
            "buffer": q("SELECT url, parent_id, depth, sequence_id FROM "
                        "page_buffer").fetchall(),
            "batches": [r[0] for r in q("SELECT status FROM "
                                        "pending_edge_batches")],
            "log": q("SELECT pending_id, channel, status, reason FROM "
                     "smoke_edge_log ORDER BY n").fetchall(),
            "invalid": dict(q("SELECT channel_username, reason FROM "
                              "invalid_channels").fetchall()),
            "crawled": {r[0] for r in q(
                "SELECT channel_username FROM seed_channels WHERE "
                "last_crawled_at IS NOT NULL").fetchall()},
            "events": q("SELECT COUNT(*) FROM access_events").fetchone()[0]}
    finally:
        con.close()


def check_tandem(rows, net, seeds, kids, requests):
    """Every check of run D on the graph file and the stand-in; returns
    the edges' final statuses and the walkbacks by kind."""
    first_seen, finals, inserted = {}, {}, set()
    for pid, name, status, reason in rows["log"]:
        if status == "inserted":
            inserted.add(pid)
            continue
        cls = tandem_page(net, name)
        want = (TANDEM_LATER if name in first_seen else TANDEM_FIRST)[cls]
        first_seen.setdefault(name, pid)
        check((status, reason) == want,
              f"run D: edge {pid} to {name} ({cls} page) ended "
              f"{status}/{reason}, expected {want}")
        finals[pid] = status
    check(inserted and set(finals) == inserted,
          f"run D: {len(inserted)} pending edges, {len(finals)} with a "
          f"final status")
    check(sum(requests.values()) <= len(inserted)
          and requests == {n: 1 for n in first_seen},
          f"run D: stand-in requests {requests} for {len(inserted)} edges "
          f"to {sorted(first_seen)}")
    valid = {n for n in first_seen if tandem_page(net, n) == "valid"}
    primary = [e for e in rows["edges"] if not e[3]]
    forward = [e for e in primary if not e[2]]
    check(all(e[0] in valid for e in forward)
          and not any(e[0] in (WALK_GHOST, WALK_PRIVATE) for e in primary),
          f"run D: primary edges {primary}, valid names {sorted(valid)}")
    check(rows["invalid"] == {WALK_GHOST: "not_found",
                              WALK_PRIVATE: "not_supergroup",
                              TANDEM_FOUR: "tdlib_400"},
          f"run D: invalid_channels {rows['invalid']}")
    # The 400 name: its edge gone, a promoted sibling or a walkback from
    # its source in its place.
    replaced = [e for e in rows["edges"] if e[1] == TANDEM_FOUR_SEED
                and not e[3]]
    check(not any(e[0] == TANDEM_FOUR for e in rows["edges"])
          and replaced and rows["invalid"].get(TANDEM_FOUR) == "tdlib_400",
          f"run D: edges from {TANDEM_FOUR_SEED}: {replaced}")
    all_kids = {k for s in seeds for k in kids[s]}
    for url, _, depth, seq in rows["buffer"]:
        if depth == 0:
            continue   # a seed the window left uncrawled
        fwd = [e for e in forward if e[0] == url and e[4] == seq]
        back = [e for e in primary if e[0] == url and e[2]
                and e[4] != seq and len(seq) == 36]
        check(fwd or back, f"run D: page-buffer row {url} {seq} follows "
              "neither a forward edge's chain nor a walkback's new chain")
    forced = [e for e in primary if e[2] and e[1] in all_kids]
    check(forced, f"run D: no forced walkback in {primary}")
    decided = [e for e in primary if e[2] and e[1] in seeds]
    return finals, forced, decided, replaced


def tandem_network(np, seed):
    """Run C's network drawn anew (8 seeds, each naming its own 3
    channels, the missing username and the private chat) and a ninth seed
    naming the 400 name and the missing username."""
    from distributed_crawler_tpu_torch.clients import TLMessage

    net, seeds, kids = walk_network(np, seed)
    net.add_channel(TANDEM_FOUR_SEED, messages=[TLMessage(
        content={"@type": "messageText", "text": {
            "text": f"see @{TANDEM_FOUR} and t.me/{WALK_GHOST}",
            "entities": []}}, date=1700000000, view_count=3)],
        member_count=1000)
    return net, seeds, kids


def tandem_pods(procs, net, seeds, run, crawl_id):
    """The two pods on one graph file: the validator process started at
    the walk's start, `launch` in this process on run C's pool, then the
    validator stopped once every batch completed.  Returns the graph's
    rows, the stand-in's requests, the pages crawled and the seconds."""
    import sqlite3
    import threading

    from distributed_crawler_tpu_torch.config.crawler import CrawlerConfig
    from distributed_crawler_tpu_torch.crawl import runner as crawl_runner
    from distributed_crawler_tpu_torch.modes.runner import launch
    from distributed_crawler_tpu_torch.state import (
        CompositeStateManager,
        SqlConfig,
        StateConfig,
    )

    graph = os.path.join(run, "validator", "graph.sqlite")
    crawler_root = os.path.join(run, "crawler")
    sm = CompositeStateManager(StateConfig(
        crawl_id=crawl_id, crawl_execution_id=crawl_id,
        storage_root=crawler_root, sampling_method="random-walk",
        sql=SqlConfig(url=graph)))
    # The deployment's seed pool: the crawler's walkbacks draw from it.
    for s in seeds:
        sm.upsert_seed_channel_chat_id(s, net.channels[s].chat_id)
    con = sqlite3.connect(graph)
    con.executescript(TANDEM_EDGE_LOG)
    con.close()
    stand_in = TmeStandIn(net)
    pages, started = [], {}

    def counted(client, page, *a, **kw):
        pages.append(page.url)
        return crawl_runner.run_for_channel(client, page, *a, **kw)

    walk_pool(net)
    crawl_runner.set_run_for_channel_fn(counted)
    try:
        t0 = time.perf_counter()
        validator = procs.start(
            "validator", "--mode", "launch", "--validate-only",
            "--crawl-id", crawl_id, "--storage-root",
            os.path.dirname(graph), "--validator-base-url", stand_in.url,
            "--validator-request-rate", "60000",
            "--validator-request-jitter-ms", "0", "--walkback-rate", "0",
            "--log-json", env={"NO_PROXY": "127.0.0.1,localhost",
                               "no_proxy": "127.0.0.1,localhost"})

        def watch():
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and validator.poll() is None:
                if any("starting validation loop" in ln
                       for ln in procs.tail("validator", 200)):
                    started["s"] = time.perf_counter() - t0
                    return
                time.sleep(0.05)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        try:
            launch(seeds, CrawlerConfig(
                crawl_id=crawl_id, storage_root=crawler_root,
                platform="telegram", sampling_method="random-walk",
                tandem_crawl=True, concurrency=2, skip_media_download=True,
                max_crawl_duration_s=TANDEM_WINDOW_S), sm=sm,
                layerless_poll_s=TANDEM_POLL_S)
        finally:
            sm.close()   # the caller's manager: its close saves metadata
        walk_s = time.perf_counter() - t0
        poll_until(lambda: sm.count_incomplete_batches(crawl_id) == 0,
                   "run D: the validator completing every batch",
                   timeout_s=60, procs=[validator], poll_s=0.1)
        drain_s = time.perf_counter() - t0 - walk_s
        watcher.join(timeout=10)
        procs.stop(validator)   # SIGTERM: 130
    finally:
        crawl_runner.set_run_for_channel_fn(None)
        stand_in.close()
    with open(os.path.join(crawler_root, crawl_id, "metadata.json"),
              encoding="utf-8") as f:
        status = json.load(f)["status"]
    check(status == "completed", f"run D: launch left metadata {status}")
    check("s" in started, "run D: the validator never logged its start")
    posted = [os.path.join(dp, f) for dp, _, fs in os.walk(crawler_root)
              for f in fs if f == "posts.jsonl"]
    check(not posted, f"run D: the walk stored posts {posted}")
    return {"rows": tandem_rows(graph), "requests": stand_in.requests,
            "pages": pages, "walk_s": walk_s, "drain_s": drain_s,
            "startup_s": started["s"]}


class PhaseBroker:
    """The phase's bus hosted in this process at ``address`` (runs A-C's
    orchestrators host it while they run); the tpu-worker reconnects."""

    def __init__(self, address):
        from distributed_crawler_tpu_torch.bus.grpc_bus import GrpcBusServer
        from distributed_crawler_tpu_torch.bus.messages import (
            TOPIC_INFERENCE_BATCHES,
        )

        self.server = GrpcBusServer(address)
        self.server.enable_pull(TOPIC_INFERENCE_BATCHES)

    def __enter__(self):
        self.server.start()
        return self

    def __exit__(self, *exc):
        self.server.close()


def follow_on_crawl(np, wrk, address, store, channels, crawl_id, tag):
    """A walk's channels crawled (channel sampling) by a `CrawlWorker` in
    this process behind an `InferenceBridge` at the CLI's defaults on the
    phase's bus: each item a success with its 64 posts, and every stored
    post committed once by the tpu-worker as 384 finite floats."""
    from distributed_crawler_tpu_torch.bus.grpc_bus import RemoteBus
    from distributed_crawler_tpu_torch.bus.messages import (
        WorkItem,
        WorkItemConfig,
    )
    from distributed_crawler_tpu_torch.config.crawler import (
        CrawlerConfig,
        InferenceConfig,
    )
    from distributed_crawler_tpu_torch.crawl import runner as crawl_runner
    from distributed_crawler_tpu_torch.inference.bridge import InferenceBridge
    from distributed_crawler_tpu_torch.state import (
        CompositeStateManager,
        StateConfig,
    )
    from distributed_crawler_tpu_torch.state.datamodels import new_id
    from distributed_crawler_tpu_torch.worker import CrawlWorker

    t0 = time.perf_counter()
    infer = InferenceConfig()
    bus = RemoteBus(address)
    bridge = InferenceBridge(
        CompositeStateManager(StateConfig(
            crawl_id=crawl_id, crawl_execution_id="e1", storage_root=wrk)),
        bus, crawl_id=crawl_id, batch_size=infer.batch_size,
        deadline_s=infer.batch_deadline_ms / 1000.0)
    worker = CrawlWorker(f"crawl-{tag}", CrawlerConfig(
        crawl_id=crawl_id, platform="telegram", skip_media_download=True),
        bus, bridge)
    try:
        results = [worker.process_work_item(WorkItem.new(
            ch, 0, new_id(), crawl_id, "telegram", WorkItemConfig(
                sampling_method="channel", skip_media_download=True)))
            for ch in channels]
    finally:
        bridge.close()   # ships the rest
        bus.close()
        crawl_runner.shutdown_connection_pool()
    check(all(r.status == "success" and r.message_count == WALK_POSTS
              for r in results),
          f"run {tag}: follow-on results " + str([
              (r.processed_url, r.status, r.error, r.message_count)
              for r in results]))
    stored = []
    base = os.path.join(wrk, crawl_id)
    for ch in sorted(os.listdir(base)) if os.path.isdir(base) else []:
        path = os.path.join(base, ch, "posts", "posts.jsonl")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                stored += [json.loads(ln)["post_uid"] for ln in f]
    want = set(stored)
    check(len(stored) == len(want) == len(channels) * WALK_POSTS,
          f"run {tag}: {len(stored)} posts stored ({len(want)} distinct) "
          f"from {len(channels)} channels of {WALK_POSTS}")
    out = poll_until(lambda: (lambda r: len(r) >= len(want) and r)(
        orch_rows(store, crawl_id)),
        f"run {tag}: the tpu-worker's rows", timeout_s=120)
    uids = [r["post_uid"] for r in out]
    check(len(uids) == len(want) and set(uids) == want,
          f"run {tag}: {len(uids)} rows ({len(set(uids))} posts) for "
          f"{len(want)} stored posts")
    check(all(len(r["embedding"]) == 384 and np.isfinite(
        r["embedding"]).all() for r in out),
          f"run {tag}: result embeddings not 384 finite floats")
    return {"follow_on_channels": len(channels), "follow_on_posts": len(want),
            "follow_on_commits": len(uids),
            "follow_on_s": time.perf_counter() - t0,
            "bridge_batches": bridge.batches_published}


def tandem_run(np, procs, root, address, store, url, seed):
    """Run D: the tandem walk beside a validator process, then a crawl of
    the channels it stepped to into the tpu-worker; 12 sm90 launches per
    dispatch of the tpu-worker over both."""
    import collections

    t0 = time.perf_counter()
    net, seeds, kids = tandem_network(np, seed + 1)
    run = os.path.join(root, "D")
    before, d0 = proc_counts(url)
    # Hosted from the start: the tpu-worker reconnects during the walk.
    with PhaseBroker(address):
        pods = tandem_pods(procs, net, seeds + [TANDEM_FOUR_SEED], run,
                           "tandem-D")
        rows = pods["rows"]
        check(rows["batches"] and all(b == "completed"
                                      for b in rows["batches"]),
              f"run D: batches {collections.Counter(rows['batches'])}")
        check(rows["events"] == 0, f"run D: the validator made "
              f"{rows['events']} access_events rows")
        finals, forced, decided, replaced = check_tandem(
            rows, net, seeds, kids, pods["requests"])
        fetched = sorted(rows["crawled"] & {k for s in seeds
                                            for k in kids[s]})
        check(fetched, "run D: the walk fetched no channel it stepped to")
        follow = follow_on_crawl(np, os.path.join(run, "follow"), address,
                                 store, fetched, "tandem-D2", "D")
    after, d1 = proc_counts(url)
    launches = {p: after[p] - before[p] for p in after}
    check_sm90_only(launches, 12, d1 - d0, "run D's tpu-worker")
    return {
        "seeds": len(seeds) + 1, "pages_crawled": len(pods["pages"]),
        "channels_fetched": len(rows["crawled"]),
        "batches_closed": len(rows["batches"]),
        "batches_completed": rows["batches"].count("completed"),
        "pending_edges": len(finals),
        "edges_by_status": dict(collections.Counter(finals.values())),
        "walkbacks_forced": len(forced), "walkbacks_decided": len(decided),
        "replacements": len(replaced),
        "page_buffer_rows_left": len(rows["buffer"]),
        "http_requests": sum(pods["requests"].values()),
        "walk_s": pods["walk_s"], "window_s": TANDEM_WINDOW_S,
        "validator_startup_s": pods["startup_s"],
        "batches_drained_s": pods["drain_s"], **follow,
        "run_s": time.perf_counter() - t0, "dispatches": d1 - d0,
        "kernel_launches_by_path": launches}


def phase_orchestrator(np, attention, work, grpc_posts_s, seed, smi):
    """Phase 15: ``--mode orchestrator`` over a card ``tpu-worker`` and a
    ``cluster-worker``, two stand-in crawl workers, run A (the valve and
    the routes) and run B (a SIGKILL and a resume); then run C, the random
    walk's step through the port's `CrawlWorker` and a crawl of its next
    channels into the same ``tpu-worker``; then run D, the tandem walk
    beside a validator process and a crawl of the channels it stepped
    to."""
    try:
        import grpc  # noqa: F401
    except ImportError:
        raise Fail("phase 15 needs grpc, and 'import grpc' failed") from None
    t0 = time.perf_counter()
    root = os.path.join(work, "orch")
    os.makedirs(root)
    procs = Procs(root)
    quiet = {name: logging.getLogger(name).level
             for name in ("dct.torch.resilience", "dct.torch.bus.outbox",
                          "dct.torch.bus.grpc")}
    for name in quiet:
        logging.getLogger(name).setLevel(logging.ERROR)
    address = f"127.0.0.1:{free_port()}"
    store = os.path.join(root, "store")
    m_tpu, m_clu = free_port(), free_port()
    tpu_id, clu_id = "tpu-15", "cluster-15"
    url = f"http://127.0.0.1:{m_tpu}"
    try:
        # Phase 11's flags: the CLI's defaults (E5-small, batch 256), no
        # outbox; an unacked batch is redelivered after a broker restart.
        tpu = procs.start("tpu", "--mode", "tpu-worker", "--bus-address",
                          address, "--storage-root", store, "--worker-id",
                          tpu_id, "--metrics-port", str(m_tpu),
                          "--telemetry-interval", str(ORCH_BEAT_S),
                          "--log-json")
        clu = procs.start("cluster", "--mode", "cluster-worker",
                          "--bus-address", address, "--storage-root", store,
                          "--worker-id", clu_id, "--metrics-port",
                          str(m_clu), "--cluster-k", "16",
                          "--telemetry-interval", str(ORCH_BEAT_S),
                          "--log-json")
        warm, d0 = worker_ready(url, tpu)
        wait_http_200(f"http://127.0.0.1:{m_clu}/healthz", clu, 600)
        run_a = orch_run(np, procs, root, "A", address, store, seed,
                         {("posts", 2): Hold(), ("results", 2): Hold()},
                         lambda run: hold_backlog(run, tpu, tpu_id))
        crawl_a = check_crawl(np, run_a, seed, "run A")
        surfaces = check_surfaces(run_a, tpu_id)
        run_b = orch_run(np, procs, root, "B", address, store, seed + 1,
                         {("results", 1): Hold(ORCH_B_FREE)},
                         kill_and_resume)
        crawl_b = check_crawl(np, run_b, seed + 1, "run B")
        check(run_b["watch"].seen_resumed, "run B: /status never said "
              "resumed after the restart")
        after, d1 = proc_counts(url)
        launches = {p: after[p] - warm[p] for p in after}
        check_sm90_only(launches, 12, d1 - d0, "the orchestrated tpu-worker")
        t_walk = time.perf_counter()
        walk = walk_run(np, procs, root, address, store, url, seed)
        walk["seconds"] = time.perf_counter() - t_walk
        tandem = tandem_run(np, procs, root, address, store, url, seed)
        procs.stop(clu)
        procs.stop(tpu)
    except BaseException:
        for name in sorted(os.listdir(root)):
            if name.endswith(".log"):
                print(f"--- {name}", *procs.tail(name[:-4], 40), sep="\n",
                      file=sys.stderr)
        raise
    finally:
        procs.close()
        for name, level in quiet.items():
            logging.getLogger(name).setLevel(level)
    posts = ORCH_PAGES * ORCH_POSTS_PER_PAGE
    report = {}
    for tag, run, crawl in (("A", run_a, crawl_a), ("B", run_b, crawl_b)):
        report[tag] = {
            "crawl_s": run["crawl_s"],
            "pages_per_s": ORCH_PAGES / run["crawl_s"],
            "posts_per_s": posts / run["crawl_s"],
            "valve_engaged_s": run["watch"].engaged_s,
            "max_backlog": run["watch"].max_backlog,
            "restart_to_completion_s": run.get("restart_to_completion_s"),
            "applied_at_kill": run.get("applied_at_kill"),
            "items_taken": run["items_taken"], "bridge": run["bridge"],
            "tpu_commits": commit_rate(store, run["crawl_id"]),
            "hold": run.get("hold"), **crawl}
    seconds = time.perf_counter() - t0
    emit("orchestrator.run_a", **report["A"], **surfaces)
    emit("orchestrator.run_b", **report["B"],
         resumed=run_b["watch"].seen_resumed)
    # A crawl's seconds and rates are set by the 5 s distribute tick (a
    # layer waits for a dispatch tick and an advance tick) and, in run A,
    # by the valve's hold: not by the card.  The card's own rate is the
    # tpu-worker's over run A's held burst.
    emit("times.orchestrator", **{
        f"{k}_{tag.lower()}": v for tag in "AB" for k, v in report[tag].items()
        if k in ("crawl_s", "pages_per_s", "posts_per_s", "valve_engaged_s",
                 "restart_to_completion_s")},
        paced_by="the 5 s distribute tick and run A's hold",
        tpu_burst_posts_per_s=report["A"]["tpu_commits"]["largest_burst"][
            "posts_per_s"],
        hold_a=run_a["hold"],
        phase11_grpc_posts_per_s=grpc_posts_s, dispatches=d1 - d0,
        sm90_launches=launches["sm90"], prioritized_pages=surfaces[
            "cluster_guide"].get("prioritized_items"),
        phase_s=seconds, card=smi)
    emit("slice.random_walk", **walk, card=smi)
    emit("slice.tandem_walk", **tandem, card=smi)
    launches = {p: launches[p] + walk["kernel_launches_by_path"][p]
                + tandem["kernel_launches_by_path"][p] for p in launches}
    emit("slice.orchestrator", seconds=seconds,
         kernel_launches_by_path=launches)
    return {"launches": launches, "tpu_burst_posts_per_s": report["A"][
        "tpu_commits"]["largest_burst"]["posts_per_s"]}


# Phase 16 (slice.autoscaler): the orchestrator's autoscaler grows and
# shrinks a pool of E5-small tpu-worker children on the card.  One pool,
# `tpu`, of one to two children, scaled up by phase 15's rule.  The
# headroom series is the rule's own, ``fleet_worker_queue_length`` (each
# worker's last reported queue, sampled once per watchtower pass, every
# 5 s): a drained fleet reads 0 there within a pass, while the
# ``fleet_queue_depth`` series, a 60 s time-weighted mean, would hold the
# fleet up for a minute after it drained.  A 10 s stabilization window
# always holds two of its samples.
AUTO_POOL = {"pool": "tpu", "min_workers": 1, "max_workers": 2,
             "scale_up_alerts": [ORCH_RULE["name"]],
             "up_cooldown_s": 5.0, "down_cooldown_s": 5.0,
             "stabilization_s": 10.0,
             "headroom_series": "fleet_worker_queue_length",
             "headroom_below": 1.0}
AUTO_EVAL_S = 1.0
AUTO_CHILDREN = ("tpu-auto-1", "tpu-auto-2")
# Depth 2's pages whose posts reach the broker while tpu-auto-1 is stopped
# (its backlog, which fires the rule); the other 64 are held until
# tpu-auto-2's first heartbeat, so that both children take part of the
# burst.
AUTO_FIRST_PAGES = 64
AUTO_SIGTERM_RC = 130   # the CLI's graceful exit, as phase 11 checks it


def proc_stat(pid):
    """``/proc/<pid>/stat``'s fields after the command name (state,
    parent pid, ...), or None once the process is gone."""
    try:
        with open(f"/proc/{pid}/stat", encoding="utf-8") as f:
            return f.read().rsplit(")", 1)[1].split()
    except OSError:
        return None


def child_pid(parent, worker_id):
    """The pid of the autoscaler's child with ``worker_id``: a direct
    child of the orchestrator process ``parent`` whose command line runs
    that ``tpu-worker``. No other process on the machine matches."""
    want = f"--worker-id\0{worker_id}\0"
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        stat = proc_stat(name)
        if stat is None or int(stat[1]) != parent:
            continue
        try:
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
        except OSError:
            continue
        if want in cmd and "--mode\0tpu-worker\0" in cmd:
            return int(name)
    return None


def pid_exited(pid):
    """True once ``pid`` has exited (a zombie not yet reaped, or gone)."""
    stat = proc_stat(pid)
    return stat is None or stat[0] in ("Z", "X")


def auto_argv(store, children):
    """The orchestrator's flags for phase 16: the autoscaler and its pool;
    each child is a CLI ``tpu-worker`` at phase 11's flags with its own
    postmortem directory under ``children``."""
    return ("--autoscaler", "--autoscaler-eval-interval", str(AUTO_EVAL_S),
            "--autoscaler-pools", json.dumps([AUTO_POOL]),
            "--autoscaler-worker-args",
            f"--telemetry-interval {ORCH_BEAT_S} --storage-root {store} "
            f"--log-json --dump-dir {children}/{{worker_id}}")


def autoscale_burst(run):
    """Phase 16's sequence (see the module docstring): the burst on a
    stopped tpu-auto-1, the rule, ``up``, tpu-auto-2's first heartbeat,
    both children draining, headroom, ``down`` and tpu-auto-2's exit; then
    depth 2's results go."""
    import signal

    posts, results = run.holds[("posts", 2)], run.holds[("results", 2)]
    rec = run.out.setdefault("auto", {})
    one, two = AUTO_CHILDREN

    def row(wid):
        body = json_route(run.ourl, "/cluster") or {}
        return body.get("workers", {}).get(wid)

    def decisions(direction):
        body = json_route(run.ourl, "/autoscaler") or {}
        return [d for d in body.get("decisions", [])
                if d["direction"] == direction]

    t_spawned = time.time()
    poll_until(lambda: (row(one) or {}).get("heartbeats"),
               f"{one}'s first heartbeat (the pool grown to its minimum)",
               procs=[run.orch], timeout_s=ORCH_DEADLINE_S)
    rec["first_child_up_s"] = time.time() - t_spawned
    # Depth 0's posts wait for tpu-auto-1, as phase 15's reach a warm
    # worker: queued at the broker before it starts, they would be the
    # backlog of its first heartbeats and could fire the rule.
    run.holds[("posts", 0)].release()
    pid1 = poll_until(lambda: child_pid(run.orch.pid, one),
                      f"{one}'s pid (a child of the orchestrator)",
                      timeout_s=10)
    poll_until(lambda: posts.arrived >= ORCH_DEPTH2,
               "phase 16: depth 2 dispatched", procs=[run.orch],
               timeout_s=ORCH_DEADLINE_S)
    first = (ORCH_SEEDS + ORCH_SEEDS * ORCH_FANOUT + AUTO_FIRST_PAGES) \
        * ORCH_POSTS_PER_PAGE
    os.kill(pid1, signal.SIGSTOP)
    t_stop = time.monotonic()
    try:
        posts.admit(AUTO_FIRST_PAGES)
        poll_until(lambda: run.bridge.posts_bridged >= first,
                   "phase 16: the first half of depth 2 bridged",
                   timeout_s=60)
        time.sleep(0.2)
        run.bridge.flush()
        check(run.bridge_bus.outbox.drain(timeout_s=60),
              "phase 16: the bridge's outbox did not drain into the broker")
        # tpu-auto-1 takes the burst in, then reports it (hold_backlog's
        # fill, for a child of the orchestrator).
        os.kill(pid1, signal.SIGCONT)
        time.sleep(ORCH_FILL_S)
        os.kill(pid1, signal.SIGSTOP)
        time.sleep(ORCH_BEAT_S + 0.2)
        seen = (row(one) or {}).get("heartbeats", 0)
        os.kill(pid1, signal.SIGCONT)
        beat = poll_until(
            lambda: (lambda r: r if r and r["heartbeats"] > seen
                     else None)(row(one)),
            f"phase 16: {one}'s heartbeat after its fill",
            timeout_s=10 * ORCH_BEAT_S, poll_s=0.002)
        os.kill(pid1, signal.SIGSTOP)
        t_beat = time.time()
        rec["reported_queue"] = beat["queue_length"]
        check(beat["queue_length"] > ORCH_RULE["value"],
              f"phase 16: {one} reported a queue of {beat['queue_length']} "
              f"batches, not over the rule's {ORCH_RULE['value']}")
        fired = poll_until(
            lambda: [a for a in run.alerts if a.get("rule")
                     == ORCH_RULE["name"] and a.get("state") == "firing"
                     and a["at_wall"] >= t_beat],
            "phase 16: the rule fired on the held burst", procs=[run.orch],
            timeout_s=ORCH_HOLD_S)[0]
        up = poll_until(lambda: decisions("up"), "phase 16: the up decision",
                        procs=[run.orch], timeout_s=ORCH_HOLD_S)[0]
        rec["fired_to_up_s"] = up["at"] - fired["at_wall"]
        two_row = poll_until(lambda: (row(two) or {}).get("heartbeats"),
                             f"phase 16: {two}'s first heartbeat",
                             procs=[run.orch], timeout_s=120, poll_s=0.02)
        rec["up_to_first_heartbeat_s"] = time.time() - up["at"]
        check(two_row, f"{two} on /cluster")
    finally:
        os.kill(pid1, signal.SIGCONT)
    rec["first_child_stopped_s"] = time.monotonic() - t_stop
    rec["t_go"] = time.time()
    posts.release()
    # Both children commit: the burst drains (every batch the bridge
    # shipped processed, by the children's heartbeats), then both report
    # their card memory (read while both run).
    def processed():
        rows = [row(w) or {} for w in AUTO_CHILDREN]
        return sum(r.get("tasks", {}).get("processed", 0) for r in rows)

    poll_until(lambda: run.bridge.posts_bridged >= ORCH_PAGES
               * ORCH_POSTS_PER_PAGE and run.bridge_bus.outbox.drain(
                   timeout_s=0.0) and processed()
               >= run.bridge.batches_published,
               "phase 16: the burst committed", procs=[run.orch],
               timeout_s=ORCH_DEADLINE_S, poll_s=0.1)
    rec["drained_s"] = time.time() - rec["t_go"]

    def memory(wid):
        tel = (row(wid) or {}).get("telemetry") or {}
        return sum(d.get("bytes_in_use", 0)
                   for d in tel.get("device_memory", []))

    poll_until(lambda: all((row(w) or {}).get("telemetry")
                           for w in AUTO_CHILDREN),
        "phase 16: both children's telemetry on /cluster",
        procs=[run.orch], timeout_s=30)
    rec["card_memory_bytes"] = {w: memory(w) for w in AUTO_CHILDREN}
    pid2 = child_pid(run.orch.pid, two)
    check(pid2 is not None,
          f"phase 16: {two} is not a child of the orchestrator")
    t_drained = time.time()
    down = poll_until(lambda: decisions("down"),
                      "phase 16: the down decision (headroom held)",
                      procs=[run.orch], timeout_s=120)[0]
    rec["drained_to_down_s"] = down["at"] - t_drained
    poll_until(lambda: pid_exited(pid2),
               f"phase 16: {two} exited after the down decision",
               timeout_s=60, poll_s=0.01)
    rec["down_to_exit_s"] = time.time() - down["at"]
    retired = poll_until(
        lambda: (lambda r: r if r and r["status"] == "offline" else None)(
            row(two)),
        f"phase 16: {two} offline on /cluster", procs=[run.orch],
        timeout_s=30)
    cluster = json_route(run.ourl, "/cluster") or {}
    rec["retired_row"] = {"status": retired["status"],
                          "stale": retired["stale"],
                          "in_stale_list": two in cluster.get(
                              "fleet", {}).get("stale_workers", [])}
    # The down decision is logged before its actuation, which waits for the
    # child's exit; its ``actual_after`` follows.
    rec["autoscaler"] = poll_until(
        lambda: (lambda b: b if b and "actual_after" in b["decisions"][-1]
                 else None)(json_route(run.ourl, "/autoscaler")),
        "phase 16: the retirement's end on /autoscaler", procs=[run.orch],
        timeout_s=60)
    rec["metrics"] = {k: v for k, v in metric_lines(run.ourl).items()
                      if k.startswith("autoscaler_")}
    results.release()


def child_bundle(children, wid):
    """The child's postmortem bundle, written on SIGTERM."""
    import glob

    paths = glob.glob(os.path.join(children, wid,
                                   "postmortem_*_sigterm.json"))
    check(len(paths) == 1, f"{wid}: {len(paths)} SIGTERM bundles")
    with open(paths[0], encoding="utf-8") as f:
        return json.load(f)


def bundle_counts(bundle, wid):
    """Launches by path, dispatches (warm-up included) and first
    dispatches by bucket and path (the warm-up's) of a child's bundle."""
    launches = dict.fromkeys(KERNEL_SOURCES, 0)
    dispatches = warm = 0
    for line in bundle["metrics"].splitlines():
        name, _, value = line.rpartition(" ")
        if name.startswith('attention_kernel_launches_total{path="'):
            launches[name.split('"')[1]] = int(float(value))
        elif name == "tpu_inference_batch_seconds_count":
            dispatches = int(float(value))
        elif name.startswith("tpu_engine_compile_cache_misses_total{"):
            warm += int(float(value))
    check(dispatches - warm > 0, f"{wid}: no dispatch past its first "
          f"per bucket")
    check(launches == {"sm90": 12 * dispatches, "mma_sync": 0, "simt": 0},
          f"{wid}: launches by path {launches} for {dispatches} dispatches "
          f"(expected 12 sm90 per dispatch)")
    return launches, dispatches, warm


def burst_rates(bundles, t_go):
    """Each child's posts/s from its committed batches (the bundle's
    flight events) from the moment both ran to its last commit, and the
    pair's to the last commit of either."""
    out, total, last = {}, 0, t_go
    for wid, bundle in bundles.items():
        events = [e for e in bundle["flight"] if e.get("kind") == "batch"
                  and e.get("outcome") == "ok" and e["ts"] >= t_go]
        posts = sum(e["records"] for e in events)
        end = max((e["ts"] for e in events), default=t_go)
        out[wid] = {"batches": len(events), "posts": posts,
                    "posts_per_s": posts / (end - t_go) if end > t_go
                    else None}
        check(posts > 0, f"{wid} committed no post of the burst")
        total, last = total + posts, max(last, end)
    out["pair"] = {"posts": total, "seconds": last - t_go,
                   "posts_per_s": total / (last - t_go)}
    return out


def check_autoscaler(rec, log, broken):
    """/autoscaler, /metrics, the retirement's exit code and /cluster; the
    run log's spawns, retirements and spawn churn, none of them lost to a
    line that did not parse (``broken``)."""
    body = rec["autoscaler"] or {}
    pool = body.get("pools", {}).get("tpu", {})
    ds = body.get("decisions", [])
    check([(d["direction"], d["from"], d["to"], d["actual_before"],
            d["actual_after"]) for d in ds]
          == [("up", 1, 2, 1, 2), ("down", 2, 1, 2, 1)]
          and (pool.get("desired"), pool.get("actual")) == (1, 1),
          f"/autoscaler: decisions {ds}, pool {pool}")
    check(ds[0]["reason"] == ORCH_RULE["name"]
          and ds[1]["reason"] == "headroom",
          f"/autoscaler: reasons {[d['reason'] for d in ds]}")
    check(pool.get("actuation_backoff_s") == 0.0,
          f"/autoscaler: actuation backoff {pool.get('actuation_backoff_s')}")
    lost = [ln for ln in broken if "autoscaler" in ln]
    check(not lost, f"run log: the autoscaler's records cut into {lost}")
    churn = [r for r in log if r.get("logger") == "dct.autoscaler"
             and "keep dying" in r.get("message", "")]
    check(not churn, f"spawn churn: {churn}")
    m = rec["metrics"]
    for direction in ("up", "down"):
        key = (f'autoscaler_decisions_total{{direction="{direction}",'
               f'pool="tpu"}}')
        check(m.get(key) == 1.0, f"/metrics {key} = {m.get(key)}")
    spawned = [r["message"] for r in log
               if r.get("message", "").startswith("autoscaler spawned")]
    retired = [r["message"] for r in log
               if r.get("message", "").startswith("autoscaler retired")]
    two = AUTO_CHILDREN[1]
    check(len(spawned) == 2 and retired == [
        f"autoscaler retired worker {two} (rc={AUTO_SIGTERM_RC})",
        f"autoscaler retired worker {AUTO_CHILDREN[0]} "
        f"(rc={AUTO_SIGTERM_RC})"],
        f"spawns {spawned}, retirements {retired}")
    check(rec["retired_row"] == {"status": "offline", "stale": False,
                                 "in_stale_list": False},
          f"/cluster: the retired {two} {rec['retired_row']}")
    check(all(v > 0 for v in rec["card_memory_bytes"].values()),
          f"/cluster card memory {rec['card_memory_bytes']}")
    return {"decisions": ds, "spawned": spawned, "retired": retired}


def phase_autoscaler(np, work, grpc_posts_s, orch_burst_posts_s, seed, smi):
    """Phase 16: ``--mode orchestrator --autoscaler`` over its own
    E5-small ``tpu-worker`` children, two stand-in crawl workers, the
    burst that grows the pool and the headroom that shrinks it."""
    t0 = time.perf_counter()
    root = os.path.join(work, "auto")
    os.makedirs(root)
    procs = Procs(root)
    quiet = {name: logging.getLogger(name).level
             for name in ("dct.torch.resilience", "dct.torch.bus.outbox",
                          "dct.torch.bus.grpc")}
    for name in quiet:
        logging.getLogger(name).setLevel(logging.ERROR)
    address = f"127.0.0.1:{free_port()}"
    store = os.path.join(root, "store")
    children = os.path.join(root, "children")
    try:
        run = orch_run(np, procs, root, "P16", address, store, seed + 16,
                       {("posts", 0): Hold(), ("posts", 2): Hold(),
                        ("results", 2): Hold()},
                       autoscale_burst, extra=auto_argv(store, children))
        crawl = check_crawl(np, run, seed + 16, "phase 16")
        rec = run["auto"]
        surfaces = check_autoscaler(rec, run["log"],
                                    run["broken_log_lines"])
        bundles = {w: child_bundle(children, w) for w in AUTO_CHILDREN}
        counts = {w: bundle_counts(b, w) for w, b in bundles.items()}
        rates = burst_rates(bundles, rec["t_go"])
    except BaseException:
        for name in sorted(os.listdir(root)):
            if name.endswith(".log"):
                print(f"--- {name}", *procs.tail(name[:-4], 60), sep="\n",
                      file=sys.stderr)
        raise
    finally:
        procs.close()
        for name, level in quiet.items():
            logging.getLogger(name).setLevel(level)
    launches = {p: sum(c[0][p] for c in counts.values())
                for p in KERNEL_SOURCES}
    seconds = time.perf_counter() - t0
    emit("slice.autoscaler.run", **crawl, crawl_s=run["crawl_s"],
         bridge=run["bridge"], reported_queue=rec["reported_queue"],
         broken_log_lines=len(run["broken_log_lines"]),
         first_child_stopped_s=rec["first_child_stopped_s"],
         decisions=surfaces["decisions"], spawned=surfaces["spawned"],
         retired=surfaces["retired"], retired_row=rec["retired_row"],
         card_memory_bytes=rec["card_memory_bytes"],
         children={w: {"launches": c[0], "dispatches": c[1],
                       "first_dispatches": c[2]}
                   for w, c in counts.items()})
    emit("times.autoscaler",
         first_child_up_s=rec["first_child_up_s"],
         fired_to_up_s=rec["fired_to_up_s"],
         up_to_first_heartbeat_s=rec["up_to_first_heartbeat_s"],
         burst_drained_s=rec["drained_s"],
         drained_to_down_s=rec["drained_to_down_s"],
         down_to_exit_s=rec["down_to_exit_s"], burst=rates,
         phase15_tpu_burst_posts_per_s=orch_burst_posts_s,
         phase11_grpc_posts_per_s=grpc_posts_s, crawl_s=run["crawl_s"],
         phase_s=seconds, card=smi)
    emit("slice.autoscaler", seconds=seconds,
         kernel_launches_by_path=launches)
    return {"launches": launches}


# -- phase 17: the load and chaos gate ---------------------------------------
# The scenarios with a crawl leg (a "crawl" block): the port's SimNetwork,
# connection pool, channel crawl and CrawlWorker feed E5-small.
LOADGEN_CRAWL = ("steady-state", "kill-orchestrator")
# Run in this order, the scenarios of a group at once, one process each:
# the ASR and cluster gates leave the card idle most of their time and
# their budgets are wide, so they run as a pair; the fault scenarios run
# alone, their recovery timed, and so does steady-state.
LOADGEN_GROUPS = (("kill-worker",), ("flash-crowd",),
                  ("asr-steady", "cluster-steady"), ("steady-state",),
                  ("kill-orchestrator",))
LOADGEN_TIMEOUT_S = 300
# The one knob changed beside the engine block: flash-crowd's forcing
# queue-wait SLO, which exists only to make the step breach (its own
# description), is 40 ms for the tiny model's few-ms dispatch on a CPU.
# E5-small's batch p95 on the card is 10-30 ms (this phase's
# ``tail_batch_p95_ms``), so at 40 ms a Poisson bunch at the baseline rate
# breached in one of this script's first two full runs and scaled the
# fleet before the step, leaving no up decision for the fault window;
# 150 ms holds at the baseline while the step's waits reach seconds.  The
# CPU test gives it the same value.
LOADGEN_CARD_KNOBS = {"flash-crowd": {"worker": {"slo_queue_wait_ms": 150}}}


def loadgen_scenario(root, name):
    """The port's scenario file ``name`` with its engine block replaced by
    E5-small at the port's `EngineConfig` defaults and the knobs of
    `LOADGEN_CARD_KNOBS`; everything else is the scenario's own.  Returns
    the written file's path."""
    from distributed_crawler_tpu_torch.inference.engine import EngineConfig

    with open(os.path.join(ROOT, PACKAGE, "loadgen", "scenarios",
                           f"{name}.json"), encoding="utf-8") as f:
        scenario = json.load(f)
    cfg = EngineConfig()
    check((cfg.model, cfg.n_labels, cfg.batch_size, cfg.buckets)
          == ("e5_small", 8, BATCH, MAIN_BUCKETS),
          f"EngineConfig defaults {cfg}")
    scenario["engine"] = {"model": cfg.model, "n_labels": cfg.n_labels,
                          "batch_size": cfg.batch_size,
                          "buckets": list(cfg.buckets)}
    for block, knobs in LOADGEN_CARD_KNOBS.get(name, {}).items():
        scenario[block].update(knobs)
    path = os.path.join(root, f"{name}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(scenario, f)
    return path


def bundle_launches(bundle):
    """Launches by path from a bundle's metrics exposition."""
    launches = dict.fromkeys(KERNEL_SOURCES, 0)
    for line in bundle["metrics"].splitlines():
        name, _, value = line.rpartition(" ")
        if name.startswith('attention_kernel_launches_total{path="'):
            launches[name.split('"')[1]] = int(float(value))
    return launches


def run_loadgen(root, name):
    """One scenario through the port's entry point in its own process; its
    verdict (the last stdout line), its bundle and its seconds."""
    path = loadgen_scenario(root, name)
    dump = os.path.join(root, f"{name}-bundle")
    log = os.path.join(root, f"{name}.log")
    t0 = time.perf_counter()
    with open(log, "w", encoding="utf-8") as err:
        proc = subprocess.run(
            [sys.executable, "-m", f"{PACKAGE}.loadgen", "--scenario", path,
             "--dump-bundle", dump], cwd=ROOT, env=cli_env(),
            stdout=subprocess.PIPE, stderr=err, text=True,
            timeout=LOADGEN_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    verdict = json.loads(lines[-1]) if lines else {}
    if proc.returncode != 0 or verdict.get("status") != "pass":
        with open(log, encoding="utf-8") as f:
            print(f"--- {name}", *f.read().splitlines()[-60:], sep="\n",
                  file=sys.stderr)
        failed = {k: c for k, c in verdict.get("checks", {}).items()
                  if not c["ok"]}
        raise Fail(f"phase 17 {name}: exit {proc.returncode}, status "
                   f"{verdict.get('status')}, error {verdict.get('error')}, "
                   f"failed checks {json.dumps(failed)}")
    check(verdict["scenario"] == name, f"verdict of {verdict['scenario']}")
    check(verdict["lost"] == 0 and verdict["duplicates"] == 0,
          f"phase 17 {name}: lost {verdict['lost']}, duplicates "
          f"{verdict['duplicates']}")
    with open(verdict["bundle"], encoding="utf-8") as f:
        bundle = json.load(f)
    return verdict, bundle, seconds


def crawl_leg(bundle):
    """(the crawl's pages, the seconds from the run's start until the last
    of them was fetched) from a run's flight events: the crawl worker's
    ``work_start`` (its page's URL) and ``work_done`` events after the
    gate's ``loadgen_run_start``."""
    events = bundle["flight"]
    t0 = next(e["ts"] for e in events if e["kind"] == "loadgen_run_start")
    urls = {e["work_item"]: e["url"] for e in events
            if e["kind"] == "work_start"}
    done = [e for e in events if e["kind"] == "work_done"
            and e["status"] == "success"]
    check(done and all(e["work_item"] in urls for e in done),
          f"crawl leg: {len(done)} pages fetched, work items {sorted(urls)}")
    return len({urls[e["work_item"]] for e in done}), \
        max(e["ts"] for e in done) - t0


def check_kill_worker(v):
    check(v["worker_generations"] == 2,
          f"kill-worker: {v['worker_generations']} worker generations")
    witness = v["lockwitness"] or {}
    check(witness.get("new_cycles") == 0 and witness.get("cycles") == 0
          and witness.get("instrumented_sites", 0) > 0,
          f"kill-worker: lock witness {witness}")


def check_flash_crowd(v):
    up = v["checks"].get("scale_event_tpu_up_fault", {})
    check(up.get("ok") and up.get("value", 0) >= 1
          and v["autoscaler"]["fleet_sizes"]["max"] >= 2,
          f"flash-crowd: no up decision in the fault window ({up}, "
          f"{v['autoscaler']})")


def check_asr_steady(v):
    check(v["checks"]["reentered"]["ok"]
          and v["checks"]["reentered"]["value"] == 0
          and v["processed_media"] > 0
          and v["reentered_posts"] >= v["processed_media"],
          f"asr-steady: transcripts not all embedded "
          f"({v['checks']['reentered']}, {v['reentered_posts']} posts for "
          f"{v['processed_media']} media)")


def check_cluster_steady(v):
    check(v["cluster_lost"] == 0 and v["cluster_duplicates"] == 0
          and v["assigned_records"] == v["embedded_records"] > 0,
          f"cluster-steady: {v['assigned_records']} assignments for "
          f"{v['embedded_records']} embedded posts")


def check_steady_state(v):
    check(v["checks"]["dtrace_processes"]["ok"]
          and v["dtraces"]["multi_process"] >= 1,
          f"steady-state: no trace across 2 processes ({v['dtraces']}, "
          f"{v['checks']['dtrace_processes']})")
    check(v["autoscaler"]["decisions"] == 0
          and v["checks"]["scale_events"]["value"] == 0,
          f"steady-state: scale events {v['autoscaler']}")


def check_kill_orchestrator(v):
    o = v["orchestrator"]
    check(o["generations"] == 2 and o["resumed"] is True
          and o["pages_by_status"] == {"fetched": 2}
          and o["completed_items"] == 2,
          f"kill-orchestrator: orchestrator {o}")
    names = ("flight_orch_kill", "flight_orch_resume", "orch_pages_lost",
             "orch_result_duplicates")
    check(all(v["checks"][c]["ok"] for c in names),
          f"kill-orchestrator: checks "
          f"{json.dumps({c: v['checks'].get(c) for c in names})}")


LOADGEN_CHECKS = {"kill-worker": check_kill_worker,
                  "flash-crowd": check_flash_crowd,
                  "asr-steady": check_asr_steady,
                  "cluster-steady": check_cluster_steady,
                  "steady-state": check_steady_state,
                  "kill-orchestrator": check_kill_orchestrator}


def phase_loadgen(np, work, smi):
    """Phase 17: the gate's scenarios at E5-small through the port's
    loadgen entry point, one process each, by LOADGEN_GROUPS."""
    t0 = time.perf_counter()
    root = os.path.join(work, "loadgen")
    os.makedirs(root)
    runs = {}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for group in LOADGEN_GROUPS:
            runs.update(zip(group, pool.map(
                lambda n: run_loadgen(root, n), group)))
    for name, (v, _, _) in runs.items():
        LOADGEN_CHECKS[name](v)

    launches = dict.fromkeys(KERNEL_SOURCES, 0)
    per_run = {}
    for name, (v, bundle, seconds) in runs.items():
        got = bundle_launches(bundle)
        want_simt = name == "asr-steady"
        check(got["sm90"] > 0 and got["mma_sync"] == 0
              and (got["simt"] > 0) == want_simt,
              f"phase 17 {name}: launches by path {got} (sm90 for "
              f"E5-small{', simt for the f32 Whisper' if want_simt else ''})")
        per_run[name] = got
        for p in launches:
            launches[p] += got[p]
        goodput = next(v[k] for k in ("goodput_posts_per_s",
                                      "goodput_media_per_s",
                                      "goodput_vectors_per_s") if k in v)
        crawl = {}
        if name in LOADGEN_CRAWL:
            pages, fetched_s = crawl_leg(bundle)
            crawl = {"crawl_pages": pages, "crawl_fetched_s": fetched_s}
        emit("times.loadgen", scenario=name, seconds=seconds,
             verdict_duration_s=v["duration_s"], goodput=goodput,
             sm90_launches=got["sm90"], **crawl,
             tail_queue_wait_p95_ms=v.get("tail_queue_wait_p95_ms"),
             tail_batch_p95_ms=v.get("tail_batch_p95_ms"),
             tail_asr_batch_p95_ms=v.get("tail_asr_batch_p95_ms"),
             tail_batch_age_p95_ms=v.get("tail_batch_age_p95_ms"),
             converge_s=(v.get("autoscaler") or {}).get("converge_s"),
             fleet_sizes=(v.get("autoscaler") or {}).get("fleet_sizes"),
             fault_breaches=v["fault_breaches"],
             worker_generations=v["worker_generations"],
             orchestrator=v.get("orchestrator"), dtraces=v.get("dtraces"),
             card=smi)
    seconds = time.perf_counter() - t0
    emit("slice.loadgen", seconds=seconds, scenarios=list(runs),
         kernel_launches_by_path=per_run,
         lockwitness=runs["kill-worker"][0]["lockwitness"],
         checks={name: sorted(v["checks"]) for name, (v, _, _)
                 in runs.items()})
    return {"launches": launches}


KERNEL_SOURCES = {"sm90": "flash_attention_sm90.cu",
                  "mma_sync": "flash_attention.cu",
                  "simt": "flash_attention.cu"}


def kernel_entry(path, rows, worst, launches):
    """One kernel's entry of the ``kernels`` line: its times summed over
    one call at each bucket of the padded E5-small shape (bf16 for sm90 and
    mma_sync, f32 for simt), the bound summed part by part."""
    dtype = "float32" if path == "simt" else "bfloat16"
    mine = [r for r in rows if "model" not in r and r["shape"] == "padded"
            and r["dtype"] == dtype]
    key = "mma_sync_ms" if path == "mma_sync" else "ms"
    parts = {p: sum(r["bound_parts_ms"][p] for r in mine)
             for p in mine[0]["bound_parts_ms"]}
    bound_ms, bound_by = bound_of(parts)
    extra = ({"bound_fp32_ms": sum(r["bound_fp32_ms"] for r in mine)}
             if path == "simt" else {})
    return {
        "name": f"flash_attention_{path}",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/{KERNEL_SOURCES[path]}",
        "replaces": "distributed_crawler_tpu/ops/attention.py:107",
        "launches": launches[path],
        "max_abs_err": max([worst[path]] + [r["max_abs_err"][path]
                                            for r in mine]),
        "ms": sum(r[key] for r in mine),
        "plain_ms": sum(r["plain_ms"] for r in mine),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": sum(r["library_ms"] for r in mine),
        "at": f"E5-small, batch 256, {dtype}, serving padding: one call at "
              f"each of buckets 32-512, summed",
        **extra,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not os.path.isdir(os.path.join(ROOT, PACKAGE, "csrc")):
        print(f"chip_smoke.py: {PACKAGE}/ is not beside this script; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is visible", file=sys.stderr)
        return 2
    # Full f32 everywhere: no TF32 in products or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from distributed_crawler_tpu_torch import kernels
    from distributed_crawler_tpu_torch.ops import attention
    from distributed_crawler_tpu_torch.utils.costmodel import peak_flops

    H100_PEAK_FLOPS["bfloat16"] = peak_flops(H100_SXM_NAME, "cuda")[0]

    t_all = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    emit("device", kind=kind, count=count, torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi)
    print(smi, flush=True)

    builds = kernels.build()
    emit("build", kernels=[{
        "name": r.name, "seconds": r.seconds, "cached": r.cached,
        "library": os.path.relpath(r.path, ROOT),
        "ptxas": [ln.strip() for ln in r.log.splitlines()
                  if "registers" in ln or "spill" in ln or "smem" in ln
                  or "Compiling entry" in ln or "Performance Loss" in ln]}
        for r in builds])

    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(args.seed)
    # Phase 7's checkpoint and WAV tree, kept for phase 11.
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    seconds = {"build": time.perf_counter() - t_all}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        return out

    worst = timed("kernel", phase_kernel, torch, attention, device, gen)
    e5 = timed("slice", phase_slice, torch, np, args.seed, smi)
    rows = timed("kernel_times", phase_kernel_times, torch, np, attention,
                 device, gen, args.seed, smi)
    tiny = timed("tinybert", phase_tinybert, torch, np, args.seed, smi)
    # Phase 6's checkpoint, kept for phase 13.
    xlmr_ckpt = tempfile.TemporaryDirectory(prefix="xlmr_ckpt_")
    xlmr = timed("xlmr", phase_xlmr, torch, np, attention, device, gen,
                 args.seed, smi, xlmr_ckpt.name)
    asr = timed("asr", phase_asr, torch, np, attention, device, args.seed,
                smi, work.name)
    clus = timed("cluster", phase_cluster, torch, np, attention, device, gen,
                 args.seed, smi)
    moe = timed("moe", phase_moe, torch, np, device, gen, args.seed, smi)
    ops = timed("ops", phase_ops, torch, np, args.seed, smi,
                e5["engine_rows"])
    cli_ = timed("cli", phase_cli, torch, np, attention, device, work.name,
                 args.seed, smi, e5, asr)
    bus = timed("bus", phase_bus, np, attention, work.name, cli_["tpu"],
                cli_["grpc_posts_per_s"], smi)
    orch = timed("orchestrator", phase_orchestrator, np, attention,
                 work.name, cli_["grpc_posts_per_s"], args.seed, smi)
    auto = timed("autoscaler", phase_autoscaler, np, work.name,
                 cli_["grpc_posts_per_s"], orch["tpu_burst_posts_per_s"],
                 args.seed, smi)
    gate = timed("loadgen", phase_loadgen, np, work.name, smi)
    work.cleanup()
    train = timed("train", phase_train, torch, np, attention, device,
                  args.seed, smi, xlmr_ckpt.name)
    xlmr_ckpt.cleanup()
    emit("times.phases", seconds=seconds, card=smi)
    launches = {p: sum(ph["launches"][p]
                       for ph in (e5, tiny, xlmr, asr, clus, moe, ops, cli_,
                                  bus, orch, auto, gate, train))
                for p in attention.PATHS}
    print(json.dumps({"kernels": [
        kernel_entry(path, rows, worst, launches)
        for path in attention.PATHS]}), flush=True)
    emit("done", seconds=time.perf_counter() - t_all)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
