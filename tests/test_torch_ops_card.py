"""The operations layer on the card: the heartbeat's device memory, a
torch.profiler capture that sees the sm90 attention kernel, and the stall
watchdog on a step that really keeps the card busy.

Every test here is marked ``gpu``: run them on the card's machine with
``python -m pytest tests/test_torch_ops_card.py -m gpu``.  They decide
inside the ``cuda`` fixture and skip without a card.  This file imports no
JAX, so it runs on that machine, which has none.
"""

import json
import time
import types

import pytest

torch = pytest.importorskip("torch")

from distributed_crawler_tpu_torch.bus import InMemoryBus  # noqa: E402
from distributed_crawler_tpu_torch.inference import worker as twork  # noqa: E402
from distributed_crawler_tpu_torch.ops.attention import (  # noqa: E402
    choose_path,
    flash_attention,
)
from distributed_crawler_tpu_torch.utils import flight  # noqa: E402
from distributed_crawler_tpu_torch.utils.metrics import (  # noqa: E402
    MetricsRegistry,
)
from distributed_crawler_tpu_torch.utils.profiling import (  # noqa: E402
    ProfileCapture,
)
from distributed_crawler_tpu_torch.utils.telemetry import (  # noqa: E402
    device_memory_stats,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_telemetry_reads_the_cards_memory(cuda):
    x = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    (row,) = [r for r in device_memory_stats() if r["device"] == "cuda:0"]
    assert row["bytes_in_use"] == torch.cuda.memory_allocated(0)
    assert (64 << 20) <= row["bytes_in_use"] <= row["bytes_limit"]
    assert row["bytes_limit"] == \
        torch.cuda.get_device_properties(0).total_memory
    assert row["peak_bytes_in_use"] >= row["bytes_in_use"]
    del x


@pytest.mark.gpu
def test_profiler_capture_names_the_sm90_kernel(cuda, tmp_path):
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn((8, 256, 3, 12, 32), generator=gen).to(
        device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert choose_path(q, k, v) == "sm90"
    flash_attention(q, k, v)  # builds the kernel
    torch.cuda.synchronize()
    cap = ProfileCapture(dump_dir=str(tmp_path))
    assert cap.capture_async(seconds=0.5, reason="test")
    deadline = time.monotonic() + 120
    while cap.captures < 1 and time.monotonic() < deadline:
        flash_attention(q, k, v)
        torch.cuda.synchronize()
    assert cap.captures == 1
    events = json.loads(
        (tmp_path.glob("profile_*").__next__() / "trace.json").read_text())
    names = {e.get("name", "") for e in events.get("traceEvents", [])}
    assert any("flash_fwd_sm90_kernel" in n for n in names)


def _cycles_per_ms(cuda):
    """The card's clock, from timing one torch.cuda._sleep."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(10_000_000)   # let the clock ramp up first
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


class SpinningEngine:
    """A stub engine whose step spins the card for ``seconds`` and then
    waits for it: the feed thread lets the GIL go while it waits."""

    def __init__(self, cycles):
        self.cfg = types.SimpleNamespace(model="spin")
        self.tokenizer = types.SimpleNamespace(
            encode_batch=lambda texts: [[1, 2]] * len(texts))
        self.cycles = cycles

    def run_tokenized(self, toks, pack=False):
        torch.cuda._sleep(self.cycles)
        torch.cuda.synchronize()
        return [{"embedding": [0.0], "label": 0, "scores": [1.0]}
                for _ in toks]

    def run(self, texts, pack=False):
        return self.run_tokenized([[1]] * len(texts), pack=pack)


def spin_stall(cuda, dump_dir, seconds=1.0, warn_s=0.1, exit_s=0.3):
    """One group of two batches through a TPUWorker over the spinning
    engine, the watchdog's exit recorded instead of taken.  Returns (exit
    codes, stall count, bundle paths, seconds the step took)."""
    engine = SpinningEngine(int(_cycles_per_ms(cuda) * seconds * 1e3))
    flight.RECORDER.reset()
    flight.configure(dump_dir=str(dump_dir))
    bus = InMemoryBus(sync=True)
    worker = twork.TPUWorker(bus, engine, cfg=twork.TPUWorkerConfig(
        worker_id="spin", heartbeat_s=3600, span_export_interval_s=0,
        stall_warn_s=warn_s, stall_exit_s=exit_s),
        registry=MetricsRegistry())
    codes = []
    worker._exit_fn = codes.append
    payloads = [{"batch_id": f"s{i}", "trace_id": f"trace_spin_{i}",
                 "records": [{"post_uid": f"p{i}", "description": "x"}]}
                for i in range(2)]
    try:
        for p in payloads:
            worker._handle_payload(p)
        t0 = time.perf_counter()
        worker.start()
        assert worker.drain(timeout_s=60)
        took = time.perf_counter() - t0
    finally:
        worker.stop()
        bus.close()
        flight.configure(dump_dir="")
    bundles = sorted(str(p) for p in dump_dir.glob("postmortem_*stall_exit*"))
    return codes, worker.m_stalls.value, bundles, took


@pytest.mark.gpu
def test_stall_watchdog_on_a_card_step(cuda, tmp_path):
    codes, stalls, bundles, took = spin_stall(cuda, tmp_path)
    assert took >= 0.3  # the step outlasted stall_exit_s on the card
    assert codes == [twork.STALL_EXIT_CODE] and stalls == 1
    assert len(bundles) == 1
    kinds = {e["kind"] for e in json.loads(open(bundles[0]).read())["flight"]}
    assert "device_stall" in kinds
    flight.RECORDER.reset()
