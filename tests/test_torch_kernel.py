"""The port's flash-attention kernel against its plain version.

Tests marked ``gpu`` need a CUDA card and run there with
``python -m pytest tests/test_torch_kernel.py -m gpu``; they decide inside
the ``cuda`` fixture, and skip on a machine without a card.  The rest run
on the CPU.  This file imports no JAX, so it also runs on the card's
machine, which has none.

Tolerances (kernel against plain, both on the card): f32 1e-4 abs/rel —
sums in another order (online softmax over key tiles, exp2 with a folded
log2(e)); bf16 2e-2 abs/rel — p is rounded to bf16 relative to a running
max before the PV product, and the output itself is bf16 (2^-8 relative).
"""

import pytest

torch = pytest.importorskip("torch")

from distributed_crawler_tpu_torch.ops import attention  # noqa: E402
from distributed_crawler_tpu_torch.ops.attention import (  # noqa: E402
    attend,
    flash_attention,
    mha,
)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are small, and the suite runs beside
    timing-sensitive tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(b, l, h, d, dtype, device, seed=0, offset=0):
    """q, k, v as views of one [b, l, 3, h, d] projection (the encoder's
    layout); ``offset`` elements in front break its rows' 16-byte
    alignment."""
    gen = torch.Generator().manual_seed(seed)
    flat = torch.randn((b * l * 3 * h * d + offset,), generator=gen)
    proj = flat.to(device=device, dtype=dtype)[offset:].view(b, l, 3, h, d)
    lens = torch.randint(1, l + 1, (b,), generator=gen)
    mask = torch.arange(l)[None, :] < lens[:, None]
    mask[-1] = False  # one fully masked row
    seg = torch.zeros((b, l), dtype=torch.int32)
    for r in range(b):
        cut = [0, l // 4, l // 2, l - l // 8]
        for s in range(3):
            seg[r, cut[s]:cut[s + 1]] = s + 1
    return (proj[:, :, 0], proj[:, :, 1], proj[:, :, 2], mask.to(device),
            seg.to(device))


class TestCPU:
    def test_flash_on_cpu_tensor_is_attend(self):
        q, k, v, mask, seg = _inputs(2, 40, 2, 16, torch.float32, "cpu")
        before = flash_attention.launches
        for kw in ({}, {"kv_mask": mask},
                   {"kv_mask": seg > 0, "segment_ids": seg}):
            out = flash_attention(q, k, v, **kw)
            assert torch.equal(out, attend(q, k, v, **kw))
            assert torch.equal(mha(q, k, v, **kw), out)
        assert flash_attention.launches == before  # nothing launched

    def test_fully_masked_row_is_zero(self):
        q, k, v, mask, _ = _inputs(2, 40, 2, 16, torch.float32, "cpu")
        out = attend(q, k, v, kv_mask=mask)
        assert torch.isfinite(out).all()
        assert torch.equal(out[-1], torch.zeros_like(out[-1]))

    def test_unsupported_device_raises(self):
        q = torch.zeros((1, 4, 1, 16), device="meta")
        with pytest.raises(RuntimeError):
            mha(q, q, q)
        with pytest.raises(RuntimeError):
            flash_attention(q, q, q)


@pytest.mark.gpu
class TestKernelOnCard:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", [16, 32, 64])
    @pytest.mark.parametrize("l, offset", [(8, 0), (32, 0), (100, 0),
                                           (128, 0), (75, 1)])
    def test_matches_plain(self, cuda, dtype, d, l, offset):
        q, k, v, mask, seg = _inputs(3, l, 2, d, dtype, cuda, seed=l + d,
                                     offset=offset)
        for kw in ({}, {"kv_mask": mask},
                   {"kv_mask": seg > 0, "segment_ids": seg}):
            before = flash_attention.launches
            out = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            assert flash_attention.launches == before + 1
            ref = attend(q, k, v, **kw)
            assert out.dtype == dtype and out.shape == q.shape
            torch.testing.assert_close(out.float(), ref.float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])
        out = flash_attention(q, k, v, kv_mask=mask)
        assert torch.equal(out[-1].float(),
                           torch.zeros_like(out[-1], dtype=torch.float32))

    def test_mha_on_card_launches_kernel(self, cuda):
        q, k, v, mask, _ = _inputs(2, 64, 2, 32, torch.bfloat16, cuda)
        before = flash_attention.launches
        mha(q, k, v, kv_mask=mask)
        assert flash_attention.launches == before + 1

    def test_wrapper_rejects(self, cuda):
        q, k, v, mask, _ = _inputs(1, 16, 2, 32, torch.float32, cuda)
        with pytest.raises(ValueError):
            flash_attention(q[..., :24], k[..., :24], v[..., :24])
        with pytest.raises(TypeError):
            flash_attention(q.half(), k.half(), v.half())
        with pytest.raises(ValueError):
            flash_attention(q, k.float().cpu(), v)
        with pytest.raises(ValueError):
            flash_attention(q, k, v, kv_mask=mask[:, :8])

    def test_engine_tiny_on_card_matches_cpu(self, cuda):
        """The tiny (f32) engine on the card against the same weights on
        the CPU: same labels, scores within the f32 kernel tolerance."""
        import numpy as np

        from distributed_crawler_tpu_torch.inference.engine import (
            EngineConfig,
            InferenceEngine,
        )
        from distributed_crawler_tpu_torch.utils.metrics import (
            MetricsRegistry,
        )

        cfg = EngineConfig(model="tiny", batch_size=4, buckets=(32, 64, 128))
        gpu = InferenceEngine(cfg, registry=MetricsRegistry())
        cpu = InferenceEngine(cfg, registry=MetricsRegistry(), device="cpu")
        texts = [" ".join(["w%d" % j for j in range(i * 7 + 1)])
                 for i in range(9)] + [""]
        for pack in (False, True):
            before = attention.flash_attention.launches
            a = gpu.run(texts, pack=pack)
            b = cpu.run(texts, pack=pack)
            assert attention.flash_attention.launches > before
            assert [r["label"] for r in a] == [r["label"] for r in b]
            np.testing.assert_allclose(
                [r["embedding"] for r in a], [r["embedding"] for r in b],
                atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(
                [r["scores"] for r in a], [r["scores"] for r in b],
                atol=1e-4, rtol=1e-4)
