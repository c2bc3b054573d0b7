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
   same dispatch groups and the writeback rows equal to the published
   messages; 12 sm90 launches per encoder dispatch; the f32 model on the
   card (SIMT kernel) against the CPU on one window; the bf16 greedy tokens
   against the argmax of a plain-attention run's teacher-forced logits,
   near-ties counted.  Times per window bucket (log-mel, encoder,
   cross-K/V, decode in all and per step, achieved TFLOP/s), the sm90
   kernel at [B, 1500, 12, 64] beside its plain version, SDPA and its
   bound, and windows/s and audio-seconds per second through the worker.
8. slice.cluster — E5-large at full width (vocab 250037, hidden 1024, 24
   layers, 16 heads of 64, batch 256, bf16, random weights from
   ``--seed``) through `TPUWorker` (packed, coalescing 4, embeddings
   published), the in-memory bus and `ClusterWorker` at the CLI's streaming
   defaults (k 16, buckets 64/256, a checkpoint every 8 batches, coalescing
   4): 2048 synthetic posts in 8 RecordBatches.  Checks: one assignment row
   per post with 0 <= cluster < 16; 24 sm90 launches per dispatch; a valid
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
   registry as a deployment adds one, bf16 weights from ``--seed``: 2048
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
   same depth beside them, layer 0's MoE against the dense MLP; posts/s per
   dispatch.
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
   ten runs each, each run's time inside the engine and the longest wait
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
   read from its /metrics (``attention_kernel_launches_total{path}``); ``mode=transcribe`` over phase 7's checkpoint and WAV tree
   (plus a non-WAV file named ``.wav``) against phase 7's
   `transcribe_files`; ``mode=cluster`` on 2048 text rows through E5-large
   (k 8, 25 iterations) against `fit` on the same engine's `embed`, and on
   16,384 x 1024 embedding rows (seconds split into reading, fitting and
   writing); `_build_asr_worker` and `_build_cluster_worker` at the CLI's
   defaults on one audio batch and on step 1's result stream.  Every
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
   checkpoint as ``inference.pretrained_dir``, values from ``--seed``,
   `HashingTokenizer`): 1024 posts of 4 classes with token-disjoint
   vocabularies, 8-200 words each, string labels, written as the posts and
   labels JSONL files.  Head scope (20 epochs, the CLI's defaults): the
   feature pass launches `simt` only (12 per batch of 32), the loss ends
   below ln 4, the encoder is saved unchanged, ``labels.json`` holds the
   vocabulary; card f32 features against the CPU's on 64 posts.  LoRA
   scope (rank 8, 2 epochs): no kernel launch, the merged checkpoint
   moves the kernels and serves.  Full scope (2 epochs,
   ``--train-grad-accum 2``, ``--train-state-dir``): stopped after epoch 1
   and resumed, against an uninterrupted run through the CLI's own
   examples, engine and full-scope training in the script's process
   (per-epoch losses, weights; `uninterrupted_full_run`),
   no kernel launch; one full step on the card against the CPU from the
   same params and batch (loss, per-leaf gradient cosine).  Serving:
   `_build_tpu_worker` with ``--head-checkpoint`` and
   ``--infer-param-dtype bfloat16`` over 2048 held-out posts (12 sm90
   launches per dispatch, nothing else; a row per post with its label
   name; labels equal to the f32 trainer model's off a 5e-2 margin;
   accuracy >= 0.6).  Times: the feature pass (posts/s; by CUDA-graph
   replay of each batch's call, per bucket and summed: `simt`, its plain
   version and SDPA in f32, beside the bound summed over the same calls;
   one batch per bucket held against the plain version), ms per step and
   tokens/s of each scope at batch 16, the full step's TFLOP/s against the
   FP32 and TF32 peaks, peak memory per CLI run, checkpoint bytes and
   seconds, CLI start to the summary line, serving posts/s.
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

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and,
last, ``{"ok": true, "device": {...}}``.  Any failed phase raises and exits
non-zero before that line.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
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
    rows += whisper_f32_kernel_times(torch, F, attention, device, gen, smi)
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


def whisper_f32_kernel_times(torch, F, attention, device, gen, smi):
    """The f32 (3xTF32) kernel at Whisper-small's encoder shape
    [B, 1500, 12, 64], B = 1/2/4/8, no mask, beside its plain version,
    SDPA in f32 and the bound."""
    rows = []
    for b in ASR_BUCKETS:
        q, k, v = (torch.randn((b, WHISPER_CTX, WHISPER_HEADS,
                                WHISPER_HEAD_DIM), generator=gen).to(device)
                   for _ in range(3))
        times, errs, pairs = _time_bucket(torch, F, attention, q, k, v, None,
                                          None, f"whisper f32 B={b}")
        parts = attention_bound_ms(pairs, b, WHISPER_CTX, WHISPER_HEADS,
                                   WHISPER_HEAD_DIM, "float32", 4, False,
                                   has_mask=False)
        row = {"model": "whisper_small", "batch": b, "seq": WHISPER_CTX,
               "heads": WHISPER_HEADS, "head_dim": WHISPER_HEAD_DIM,
               "dtype": "float32", "mask": None, "max_abs_err": errs,
               "ms": times["simt"], "eager_ms": times["eager"],
               "plain_ms": times["plain"], "library_ms": times["sdpa"],
               "bound_ms": bound_of(parts)[0], "bound_by": bound_of(parts)[1],
               "bound_parts_ms": parts,
               "bound_fp32_ms": fp32_bound_ms(parts, pairs, WHISPER_HEADS,
                                              WHISPER_HEAD_DIM),
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


def time_engine(torch, engine, smi, **tags):
    """Engine batch time per bucket, unpacked, a full batch of one bucket:
    the host clock around run_tokenized, its stage spans (host time of
    each stage), and the model's forward alone timed with CUDA events."""
    from distributed_crawler_tpu_torch.ops.padding import pack_batch
    from distributed_crawler_tpu_torch.utils import cudatime, trace
    from distributed_crawler_tpu_torch.utils.costmodel import (
        encoder_forward_flops,
    )

    rows = []
    for bucket in MAIN_BUCKETS:
        n_tok = bucket - 1
        batch_toks = [[5 + (j % 1000)] * n_tok for j in range(BATCH)]
        engine.run_tokenized(batch_toks)
        torch.cuda.synchronize()
        reps = 3
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
                min_iters=3, max_iters=20)
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


def phase_xlmr(torch, np, attention, device, gen, seed, smi):
    """XLM-R-base served int8 from a local HF checkpoint through
    `TPUWorker`; int8 and int8_static against bf16 on the same weights;
    the int8 products against the CPU; times."""
    import tempfile

    from distributed_crawler_tpu_torch.bus import RecordBatch
    from distributed_crawler_tpu_torch.inference import engine as engine_mod
    from distributed_crawler_tpu_torch.inference.tokenizer import (
        HashingTokenizer,
    )
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    EngineConfig = engine_mod.EngineConfig
    InferenceEngine = engine_mod.InferenceEngine
    with tempfile.TemporaryDirectory(prefix="xlmr_ckpt_") as ckpt:
        t0 = time.perf_counter()
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump(XLMR_HF_CONFIG, f)
        write_safetensors(os.path.join(ckpt, "model.safetensors"),
                          xlmr_state(np, seed))
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
    # The same files through `transcribe_files`, one call per dispatch
    # group, so every window meets the same batch as when served.
    by_id = {m.batch_id: m for m in msgs}
    check(sorted(b for g in served["groups"] for b in g) == sorted(by_id),
          f"dispatch groups {served['groups']}")
    for group in served["groups"]:
        g_refs = [r for b in group for r in by_id[b].refs]
        again = pipeline.transcribe_files([r.path for r in g_refs])
        for r, res in zip(g_refs, again):
            t = by_media[r.media_id]
            check(res.tokens == t.tokens and res.windows == t.windows
                  and bool(res.error) == bool(t.error),
                  f"{r.path}: served tokens differ from transcribe_files")
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


def profile_decode(torch, model, mel, steps=32):
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
    call where none was served — and its decode share (the dispatch less
    those three) in all and per step; the achieved TFLOP/s by
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
            if served:
                total_ms = served[len(served) // 2]
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = wh.transcribe_features(model, audio,
                                             max_len=pipeline.max_len)
                torch.cuda.synchronize()
                total_ms = (time.perf_counter() - t0) * 1e3
                check(tuple(out.shape) == (b, pipeline.max_len),
                      f"tokens {tuple(out.shape)}")
        profile = profile_decode(torch, model, mel) if b == max(
            ASR_BUCKETS) else None
        steps = pipeline.max_len - 1
        decode_ms = total_ms - mel_ms - enc_ms - kv_ms
        flops = whisper_forward_flops(cfg, b, pipeline.max_len)
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
    """What ``mode=transcribe`` must write for this tree (phase 11): the
    WAV files plus a copy of the non-WAV file under a ``.wav`` name, in
    the order the CLI walks them, through `transcribe_files` on this
    pipeline (the CLI's defaults: batch 8, window buckets 1/2/4/8)."""
    bad = next(p for p, sec in files if sec is None)
    with open(bad, "rb") as src, \
            open(os.path.join(media, "not_a_wav.wav"), "wb") as dst:
        dst.write(src.read())
    paths = sorted(os.path.join(media, n) for n in os.listdir(media)
                   if n.endswith(".wav"))
    t0 = time.perf_counter()
    results = pipeline.transcribe_files(paths)
    return {"seconds": time.perf_counter() - t0,
            "rows": [{"path": os.path.relpath(r.path, media),
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

    t0 = time.perf_counter()
    cfg = EngineConfig(model="e5_large", batch_size=BATCH, seed=seed)
    engine = InferenceEngine(cfg, registry=MetricsRegistry())
    ecfg = engine.ecfg
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    check((ecfg.vocab_size, ecfg.hidden, ecfg.n_layers, ecfg.n_heads,
           ecfg.mlp_dim, ecfg.dtype) == (250037, 1024, 24, 16, 4096,
                                         "bfloat16"),
          f"not E5-large's full width: {ecfg}")
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
        torch, eng, smi, model=MOE_MODEL, dispatch=name)}
        for name, eng in engines.items()}
    base = {r["bucket"]: r for r in time_engine(
        torch, yardstick, smi, model=MOE_YARDSTICK, dispatch="dense_mlp")}
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
                min_iters=3, max_iters=20)
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
                    lambda: moe(x, mask), min_iters=3, max_iters=20)
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
        for i in range(8)]
    served = {}
    for name, eng in engines.items():
        if name == "capacity":
            with _DispatchRecorder(np, eng) as recorder:
                served[name] = serve_batches(np, eng, batches)
        else:
            served[name] = serve_batches(np, eng, batches)
        torch.cuda.empty_cache()
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
    time_moe(torch, engines, yardstick, smi)
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
OPS_PAIRS = 10              # knobs-on/knobs-off run pairs


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
CLI_EMB_ROWS, CLI_EMB_DIM = 16384, 1024
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
    """Steps 2 and 6: ``python3 -m distributed_crawler_tpu_torch.cli --mode
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
    """Step 6: step 1's batches published over gRPC into the process;
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
    """Step 3: ``main(["--mode", "transcribe", ...])`` over phase 7's WAV
    tree and checkpoint, against phase 7's `transcribe_files`."""
    from distributed_crawler_tpu_torch.inference.asr import ASRPipeline
    from distributed_crawler_tpu_torch.models.whisper import WHISPER_SMALL

    out_path = os.path.join(work, "transcripts.jsonl")
    zero_launches(attention)
    with _CountCalls(ASRPipeline, "transcribe_audio") as dispatches:
        rc, summary, wall = cli_main([
            "--mode", "transcribe", "--transcribe-input", asr["media"],
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
    audio_s = sum(sec for _, sec in asr["files"] if sec is not None)
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
    """Step 4, embedding rows: 16,384 x 1024 seeded unit vectors as the
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
    worker = cli._build_asr_worker(cfg, r)
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
    launches = {p: tpu["launches"][p] + proc["kernel_launches_by_path"][p]
                + sum(step["launches"][p] for step in (tr, text, workers))
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

    def start(self, name, *args):
        log = open(os.path.join(self.work, f"{name}.log"), "a",
                   encoding="utf-8")
        proc = subprocess.Popen(cli_argv(*args), cwd=ROOT, env=cli_env(),
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
TRAIN_POSTS, TRAIN_SERVE_POSTS, TRAIN_CPU_POSTS = 1024, 2048, 64
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
    environment: its examples (`cli._train_examples`), engine
    (`cli._make_engine`), tokens and full-scope training (`cli._train_full`),
    with no train state, checkpoint or summary written.  Returns (params
    tree, per-epoch losses, seconds)."""
    from distributed_crawler_tpu_torch import cli

    t0 = time.perf_counter()
    cfg, r = cli.resolve_config(cli.build_parser().parse_args(argv),
                                env=env)
    examples = cli._train_examples(r.get_str("train.posts_file"),
                                   r.get_str("train.labels_file"))
    check(examples is not None, "train-head examples did not read")
    texts, labels, n_labels, _ = examples
    engine = cli._make_engine(cfg, r, n_labels=n_labels, cast_params=False,
                              device=device)
    params, history = cli._train_full(
        engine, r, engine.tokenizer.encode_batch(texts), labels,
        epochs=r.get_int("train.epochs", 20))
    del engine
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


def profile_train_step(torch, call, steps=3):
    """A few steps under `torch.profiler`: the device time per step by
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
        if scope != "head":
            row["profile"] = profile_train_step(torch, lambda: call(st))
        emit("times.train", step=f"{scope}_step", **row)
        rows.append(row)
        del st
        torch.cuda.empty_cache()
    return rows


def check_step_vs_cpu(torch, np, tm, fcfg, tree, toks, labels, device):
    """One full step's loss and gradients, card against CPU, from the same
    params and a batch of 4 posts cut to 64 tokens."""
    from distributed_crawler_tpu_torch.models.from_jax import (
        flatten_tree,
        flax_grads,
    )

    ids, mask, y = tm.prepare_finetune_arrays(
        fcfg, [t[:64] for t in toks[:4]], labels[:4], 1)
    tc = tm.TrainConfig(warmup_steps=10)
    out = {}
    for name, dev in (("cpu", "cpu"), ("card", device)):
        st = tm.make_train_step(fcfg, tc, tree, dev)
        m = st.grads(ids, mask, y)
        out[name] = (float(m["loss"]),
                     flatten_tree(flax_grads(st.model)["params"]))
        del st
    torch.cuda.empty_cache()
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out["card"]
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    check(rel <= TRAIN_STEP_LOSS_RTOL,
          f"full step loss card {l_card} vs cpu {l_cpu} ({rel:.3g} rel)")
    worst, worst_leaf = 1.0, None
    for path, gc in g_cpu.items():
        a = gc.astype(np.float64).ravel()
        b = g_card[path].astype(np.float64).ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0 and nb == 0:
            continue
        cos = float(a @ b / (na * nb)) if na and nb else 0.0
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
    """Card f32 features against the CPU's on 64 posts; then the feature
    pass over every post timed, with its simt kernels' device time."""
    from distributed_crawler_tpu_torch.models.encoder import Classifier
    from distributed_crawler_tpu_torch.models.from_jax import (
        load_flax_params,
    )

    cpu = tm.encode_cls_features(fcfg, tree, toks[:TRAIN_CPU_POSTS],
                                 batch_size=32, buckets=buckets,
                                 device="cpu")
    model = Classifier(fcfg)
    load_flax_params(model, tree)
    enc = model.encoder.to(device)
    card = tm.cls_features(enc, toks[:TRAIN_CPU_POSTS], 32, buckets)
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
    simt, per_bucket = feature_pass_simt_ms(torch, attention, fcfg, toks,
                                            buckets, device)
    row = {"posts": len(toks), "seconds": seconds,
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
            "tol": list(TRAIN_FEATURE_TOL), "posts": TRAIN_CPU_POSTS}, row


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

    model = Classifier(tm.train_config(fcfg, attention="xla"))
    load_flax_params(model, params)
    model = model.to(device).eval()
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
    worker.warmup()
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
    params = load_params(latest_step_dir(ckpt))
    scores = f32_labels(torch, np, tm, fcfg, params, texts, tokenizer,
                        device)
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
         card=smi)
    return {"launches": launches, "dispatches": dispatches,
            "rows": len(rows), "accuracy": acc,
            "labels_compared": int(clear.sum()),
            "label_margin": TRAIN_SERVE_MARGIN}


def phase_train(torch, np, attention, device, seed, smi):
    """Phase 13: train-head (head, LoRA, full) on the card through the
    CLI at XLM-R-base's published widths, and the checkpoint served."""
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
    work = tempfile.TemporaryDirectory(prefix="train_")
    root = work.name
    hf = os.path.join(root, "xlmr")
    os.makedirs(hf)
    with open(os.path.join(hf, "config.json"), "w") as f:
        json.dump(XLMR_HF_CONFIG, f)
    write_safetensors(os.path.join(hf, "model.safetensors"),
                      xlmr_state(np, seed))
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
    with open(posts_file, "w") as f, open(labels_file, "w") as g:
        for rec, c in zip(records, labels):
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
    emit("train.data", posts=len(records), classes=len(names),
         tokens_min=min(map(len, toks)), tokens_max=max(map(len, toks)),
         setup_s=time.perf_counter() - t_phase)
    main_launches = dict.fromkeys(attention.PATHS, 0)

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
    features, feature_row = check_features(
        torch, np, tm, attention, fcfg, tree, toks, buckets, device, smi)
    emit("train.features", **features)

    # (b) LoRA scope: rank 8, 2 epochs; no kernel launches.
    ckpt_lora = os.path.join(root, "ckpt_lora")
    lora, lora_s, launches, lora_mem = train_run(
        torch, attention, base + ["--head-checkpoint", ckpt_lora,
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

    # (c) full scope: 2 epochs with --train-grad-accum 2, stopped after
    # epoch 1 and resumed, against an uninterrupted run of the CLI's own
    # training in this process (no train state or checkpoint written).
    full = ["--train-scope", "full", "--train-grad-accum", "2"]
    sd1 = os.path.join(root, "state1")
    ckpt_full = os.path.join(root, "ckpt_full")
    runs = {}
    for name, argv in (
            ("first_epoch", full + ["--train-epochs", "1",
                                    "--train-state-dir", sd1,
                                    "--head-checkpoint", ckpt_full]),
            ("resumed", full + ["--train-epochs", "2",
                                "--train-state-dir", sd1,
                                "--head-checkpoint", ckpt_full])):
        summary, seconds, launches, mem = train_run(
            torch, attention, base + argv, env)
        check(launches == dict.fromkeys(attention.PATHS, 0),
              f"full scope ({name}) launched {launches}")
        runs[name] = {"summary": summary, "seconds": seconds,
                      "peak_mem_bytes": mem}
    check(sorted(os.listdir(sd1)) == ["epoch_1"], f"state dir {sd1}: "
          f"{sorted(os.listdir(sd1))}")
    zero_launches(attention)
    (straight_tree, straight_losses, straight_s), straight_mem = \
        peak_memory(torch, lambda: uninterrupted_full_run(
            base + full + ["--train-epochs", "2", "--head-checkpoint",
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
    t0 = time.perf_counter()
    _, st_params, st_opt, _ = ck.load_train_state(
        ck.latest_train_state(sd1))
    state_read_s = time.perf_counter() - t0
    state_bytes = os.path.getsize(os.path.join(sd1, "epoch_1",
                                               ck.PARAMS_FILE))
    t0 = time.perf_counter()
    ck.save_train_state(os.path.join(root, "state3"), 0, st_params, st_opt,
                        [])
    state_write_s = time.perf_counter() - t0
    del st_params, st_opt
    t0 = time.perf_counter()
    params_bytes = ck.save_params(os.path.join(root, "copy"), {
        "params": nest_tree(resumed)})
    params_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck.load_params(os.path.join(root, "copy"))
    params_read_s = time.perf_counter() - t0
    emit("train.full", runs=runs, loss_history=hist, loss_max_rel=loss_rel,
         weights_max_abs_diff=diff, largest_movement=movement,
         tol=[TRAIN_RESUME_LOSS_RTOL, TRAIN_RESUME_PARAM_SHARE], card=smi)
    emit("times.train", step="checkpoint", params_bytes=params_bytes,
         params_write_s=params_write_s, params_read_s=params_read_s,
         train_state_bytes=state_bytes, train_state_write_s=state_write_s,
         train_state_read_s=state_read_s, card=smi)
    del resumed, straight, merged, saved

    step_cpu = check_step_vs_cpu(torch, np, tm, fcfg, tree, toks, label_ids,
                                 device)
    emit("train.step_vs_cpu", **step_cpu)
    ids, mask, y = tm.prepare_finetune_arrays(fcfg, toks, label_ids, 1)
    step_rows = train_step_times(torch, np, tm, lora_mod, fcfg, tree, ids,
                                 mask, y, device, smi)

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
    emit("slice.train", seconds=time.perf_counter() - t_phase,
         kernel_launches_by_path=main_launches,
         feature_posts_per_s=feature_row["posts_per_s"],
         step_ms={r["scope"]: r["ms"] for r in step_rows})
    return {"launches": main_launches}


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
    worst = phase_kernel(torch, attention, device, gen)
    e5 = phase_slice(torch, np, args.seed, smi)
    rows = phase_kernel_times(torch, np, attention, device, gen, args.seed,
                              smi)
    tiny = phase_tinybert(torch, np, args.seed, smi)
    xlmr = phase_xlmr(torch, np, attention, device, gen, args.seed, smi)
    asr = phase_asr(torch, np, attention, device, args.seed, smi,
                    work.name)
    clus = phase_cluster(torch, np, attention, device, gen, args.seed, smi)
    moe = phase_moe(torch, np, device, gen, args.seed, smi)
    ops = phase_ops(torch, np, args.seed, smi, e5["engine_rows"])
    cli_ = phase_cli(torch, np, attention, device, work.name, args.seed, smi,
                     e5, asr)
    bus = phase_bus(np, attention, work.name, cli_["tpu"],
                    cli_["grpc_posts_per_s"], smi)
    work.cleanup()
    train = phase_train(torch, np, attention, device, args.seed, smi)
    launches = {p: sum(ph["launches"][p]
                       for ph in (e5, tiny, xlmr, asr, clus, moe, ops, cli_,
                                  bus, train))
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
