"""The port's flash-attention kernel against its plain version.

Tests marked ``gpu`` need a CUDA card and run there with
``python -m pytest tests/test_torch_kernel.py -m gpu``; they decide inside
the ``cuda`` fixture, and skip on a machine without a card.  The rest run
on the CPU.  This file imports no JAX, so it also runs on the card's
machine, which has none.

Tolerances (kernel against plain, both on the card): f32 1e-4 abs/rel —
sums in another order (online softmax over key tiles, exp2 with a folded
log2(e)), and each product as three TF32 products (about 22 mantissa
bits); bf16 2e-2 abs/rel — p is rounded to bf16 relative to a running max
before the PV product, and the output itself is bf16 (2^-8 relative).
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


class TestNoBackward:
    """The kernels have no backward: operands that require grad while
    autograd records are refused rather than given an output without
    ``grad_fn``; the plain version (``attention="xla"``) differentiates."""

    def test_check_operands_refuses_grad_while_recording(self):
        q = torch.zeros((1, 8, 2, 16), requires_grad=True)
        k = torch.zeros((1, 8, 2, 16))
        with pytest.raises(RuntimeError, match="no backward"):
            attention.check_operands(q, k, k)
        with torch.no_grad():
            assert attention.check_operands(q, k, k) == "simt"
        assert attention.check_operands(q.detach(), k, k) == "simt"

    def test_mha_xla_gradients_equal_attends(self):
        gen = torch.Generator().manual_seed(11)
        base = [torch.randn((2, 16, 4, 8), generator=gen) for _ in range(3)]
        mask = torch.arange(16)[None, :] < torch.tensor([[16], [9]])
        grads = []
        for fn in (lambda q, k, v: mha(q, k, v, kv_mask=mask,
                                       attention="xla"),
                   lambda q, k, v: attend(q, k, v, mask)):
            qkv = [t.clone().requires_grad_(True) for t in base]
            (fn(*qkv) ** 2).sum().backward()
            grads.append([t.grad for t in qkv])
        for a, b in zip(*grads):
            assert torch.equal(a, b)

    @pytest.mark.gpu
    def test_flash_attention_refuses_grad_on_the_card(self, cuda):
        q = torch.randn((2, 64, 4, 64), device=cuda, requires_grad=True)
        k = torch.randn((2, 64, 4, 64), device=cuda)
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention(q, k, k)
        with torch.no_grad():
            out = flash_attention(q, k, k)
        torch.testing.assert_close(out, attend(q.detach(), k, k),
                                   atol=1e-4, rtol=1e-4)
        x = mha(q, k, k, attention="xla")
        assert x.grad_fn is not None


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
        wide = torch.zeros((1, 16, 2, 257), device=cuda)
        with pytest.raises(ValueError):  # above the kernels' 256
            flash_attention(wide, wide, wide)
        with pytest.raises(ValueError):  # head dim not contiguous
            flash_attention(q[..., ::2], k[..., ::2], v[..., ::2])
        with pytest.raises(TypeError):
            flash_attention(q.half(), k.half(), v.half())
        with pytest.raises(ValueError):
            flash_attention(q, k.float().cpu(), v)
        with pytest.raises(ValueError):
            flash_attention(q, k, v, kv_mask=mask[:, :8])

    def test_launches_by_path(self, cuda):
        """Each input moves the count of the path choose_path gives it."""
        for dtype, d, offset, path in (
                (torch.bfloat16, 32, 0, "sm90"),
                (torch.bfloat16, 64, 0, "sm90"),
                (torch.bfloat16, 32, 1, "mma_sync"),
                (torch.bfloat16, 16, 0, "mma_sync"),
                (torch.float32, 32, 0, "simt")):
            q, k, v, mask, _ = _inputs(2, 96, 2, d, dtype, cuda,
                                       offset=offset)
            assert attention.choose_path(q, k, v) == path
            before = dict(flash_attention.launches_by_path)
            flash_attention(q, k, v, kv_mask=mask)
            after = flash_attention.launches_by_path
            assert {p: after[p] - before[p] for p in after} == {
                p: int(p == path) for p in after}

    def test_path_argument(self, cuda):
        q, k, v, mask, _ = _inputs(2, 96, 2, 32, torch.bfloat16, cuda)
        ref = attend(q, k, v, kv_mask=mask)
        before = flash_attention.launches_by_path["mma_sync"]
        out = flash_attention(q, k, v, kv_mask=mask, path="mma_sync")
        torch.cuda.synchronize()
        assert flash_attention.launches_by_path["mma_sync"] == before + 1
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
        qu, ku, vu, _, _ = _inputs(2, 96, 2, 32, torch.bfloat16, cuda,
                                   offset=1)
        with pytest.raises(ValueError):
            flash_attention(qu, ku, vu, path="sm90")
        with pytest.raises(ValueError):
            flash_attention(q, k, v, path="simt")

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


def _holes(mask):
    """Whole key tiles masked in the middle of every row (not a prefix)."""
    holes = mask.clone()
    holes[:, 64:192] = False
    return holes


@pytest.mark.gpu
class TestSm90OnCard:
    """The Hopper kernel (`csrc/flash_attention_sm90.cu`), which takes bf16
    at head dims 32/64 with TMA-legal operands, against the plain version.
    Tolerance bf16 2e-2 abs/rel, as above."""

    @pytest.mark.parametrize("d", [32, 64])
    @pytest.mark.parametrize("l", [32, 64, 100, 128, 512, 1024])
    def test_matches_plain(self, cuda, l, d):
        b = 2 if l >= 512 else 5
        q, k, v, mask, seg = _inputs(b, l, 3, d, torch.bfloat16, cuda,
                                     seed=l * d)
        assert attention.choose_path(q, k, v) == "sm90"
        for kw in ({}, {"kv_mask": mask},
                   {"kv_mask": seg > 0, "segment_ids": seg},
                   {"kv_mask": _holes(mask)}):
            before = flash_attention.launches_by_path["sm90"]
            out = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            assert flash_attention.launches_by_path["sm90"] == before + 1
            ref = attend(q, k, v, **kw)
            assert out.dtype == torch.bfloat16 and out.shape == q.shape
            torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                       rtol=2e-2)
        out = flash_attention(q, k, v, kv_mask=mask)
        assert torch.equal(out[-1].float(),
                           torch.zeros_like(out[-1], dtype=torch.float32))

    @pytest.mark.parametrize("l", [32, 64, 128, 256, 512])
    def test_xlmr_base_shape(self, cuda, l):
        """XLM-R-base's attention: 12 heads of 64 in the fused-QKV layout,
        padded and packed rows, at the serving buckets."""
        b = 8
        q, k, v, mask, seg = _inputs(b, l, 12, 64, torch.bfloat16, cuda,
                                     seed=l + 64)
        assert attention.choose_path(q, k, v) == "sm90"
        for kw in ({"kv_mask": mask},
                   {"kv_mask": seg > 0, "segment_ids": seg}):
            before = flash_attention.launches_by_path["sm90"]
            out = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            assert flash_attention.launches_by_path["sm90"] == before + 1
            torch.testing.assert_close(out.float(),
                                       attend(q, k, v, **kw).float(),
                                       atol=2e-2, rtol=2e-2)

    @pytest.mark.parametrize("b", [1, 2, 4, 8])
    def test_whisper_encoder_shape(self, cuda, b):
        """The Whisper-small audio encoder's self-attention: 1500 tokens (not
        a multiple of the 64-key tile), 12 heads of 64, no mask, q/k/v each
        its own contiguous projection."""
        gen = torch.Generator().manual_seed(b)
        q, k, v = (torch.randn((b, 1500, 12, 64), generator=gen).to(
            device=cuda, dtype=torch.bfloat16) for _ in range(3))
        assert attention.choose_path(q, k, v) == "sm90"
        before = flash_attention.launches_by_path["sm90"]
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert flash_attention.launches_by_path["sm90"] == before + 1
        torch.testing.assert_close(out.float(), attend(q, k, v).float(),
                                   atol=2e-2, rtol=2e-2)

    @pytest.mark.parametrize("segments", [False, True])
    def test_skipped_tiles_change_nothing(self, cuda, segments):
        """Overwrite the K/V of every key that no block loads (per
        `key_tile_plan`): large finite values leave the output bitwise
        equal, and NaN in V, which any computed tile would carry into its
        rows (0 * NaN), leaves it equal too, so those tiles were skipped."""
        b, l = 3, 512
        q, k, v, _, _ = _inputs(b, l, 4, 32, torch.bfloat16, cuda, seed=7)
        lens = torch.tensor([100, 300, 200])
        mask = _holes(torch.arange(l)[None, :] < lens[:, None])
        seg = None
        if segments:
            seg = torch.zeros((b, l), dtype=torch.int32)
            seg[:, :40], seg[:, 40:300] = 1, 2
            seg = seg.to(cuda)
        mask = mask.to(cuda)
        kw = {"kv_mask": mask, "segment_ids": seg}
        plan = attention.key_tile_plan(mask, seg, b, l)
        loaded = torch.zeros(b * l, dtype=torch.bool)
        for tiles in plan:
            for k0, _ in tiles:
                loaded[k0:k0 + attention.SM90_BLOCK_N] = True
        skipped = (~loaded[:b * l]).view(b, l).to(cuda)
        assert skipped.any()
        base = flash_attention(q, k, v, **kw)
        for k_fill, v_fill in ((3.0e4, -3.0e4), (0.0, float("nan"))):
            kp, vp = k.clone(), v.clone()
            kp[skipped] = k_fill
            vp[skipped] = v_fill
            out = flash_attention(q, kp, vp, **kw)
            torch.cuda.synchronize()
            assert torch.equal(out, base)


@pytest.mark.gpu
class TestGenericRoutesOnCard:
    """The generic kernels of `csrc/flash_attention.cu` (``mma_sync``: bf16
    on wgmma fed by cp.async; ``simt``: f32 as 3xTF32) at every kind of
    head dim they take, against the plain version.  Tolerances as above."""

    KINDS = ("unmasked", "padded", "packed", "holes")

    @staticmethod
    def _kw(kind, mask, seg):
        return {"unmasked": {}, "padded": {"kv_mask": mask},
                "packed": {"kv_mask": seg > 0, "segment_ids": seg},
                "holes": {"kv_mask": _holes(mask)}}[kind]

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", [8, 25, 26, 48, 80, 128, 256])
    @pytest.mark.parametrize("l, offset", [(100, 0), (300, 0), (75, 1)])
    def test_head_dims_match_plain(self, cuda, dtype, d, l, offset):
        q, k, v, mask, seg = _inputs(3, l, 2, d, dtype, cuda, seed=l + d,
                                     offset=offset)
        path = "simt" if dtype == torch.float32 else "mma_sync"
        assert attention.choose_path(q, k, v) == path
        for kind in self.KINDS:
            kw = self._kw(kind, mask, seg)
            before = flash_attention.launches_by_path[path]
            out = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            assert flash_attention.launches_by_path[path] == before + 1
            assert out.dtype == dtype and out.shape == q.shape
            torch.testing.assert_close(out.float(),
                                       attend(q, k, v, **kw).float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])
        out = flash_attention(q, k, v, kv_mask=mask)
        assert torch.equal(out[-1].float(),
                           torch.zeros_like(out[-1], dtype=torch.float32))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("l", [32, 128, 512])
    def test_tinybert_view(self, cuda, dtype, l):
        """TinyBERT-4L-312D's fused QKV: 12 heads of 26, rows 52 bytes
        apart per head, so the copies are 4 bytes wide."""
        q, k, v, mask, seg = _inputs(4, l, 12, 26, dtype, cuda, seed=l)
        assert q.stride(2) == 26
        for kind in self.KINDS:
            kw = self._kw(kind, mask, seg)
            torch.testing.assert_close(
                flash_attention(q, k, v, **kw).float(),
                attend(q, k, v, **kw).float(), atol=TOL[dtype],
                rtol=TOL[dtype])

    def test_bf16_at_32_forced_to_mma_sync(self, cuda):
        q, k, v, mask, seg = _inputs(2, 512, 4, 64, torch.bfloat16, cuda)
        assert attention.choose_path(q, k, v) == "sm90"
        for kind in self.KINDS:
            kw = self._kw(kind, mask, seg)
            torch.testing.assert_close(
                flash_attention(q, k, v, path="mma_sync", **kw).float(),
                flash_attention(q, k, v, **kw).float(), atol=2e-2,
                rtol=2e-2)

    @pytest.mark.parametrize("dtype, d", [(torch.bfloat16, 26),
                                          (torch.bfloat16, 32),
                                          (torch.float32, 26),
                                          (torch.float32, 200)])
    @pytest.mark.parametrize("segments", [False, True])
    def test_skipped_tiles_change_nothing(self, cuda, dtype, d, segments):
        """As `TestSm90OnCard.test_skipped_tiles_change_nothing`, for the
        generic kernels (their tile width from `block_n`): large finite K/V
        and NaN in V at every key no block loads leave the output equal."""
        b, l = 3, 512
        q, k, v, _, _ = _inputs(b, l, 4, d, dtype, cuda, seed=7)
        path = "simt" if dtype == torch.float32 else "mma_sync"
        lens = torch.tensor([100, 300, 200])
        mask = _holes(torch.arange(l)[None, :] < lens[:, None]).to(cuda)
        seg = None
        if segments:
            seg = torch.zeros((b, l), dtype=torch.int32)
            seg[:, :40], seg[:, 40:300] = 1, 2
            seg = seg.to(cuda)
        kw = {"kv_mask": mask, "segment_ids": seg, "path": path}
        bn = attention.block_n(path, d)
        plan = attention.key_tile_plan(mask, seg, b, l, block_n=bn)
        loaded = torch.zeros(b * l, dtype=torch.bool)
        for tiles in plan:
            for k0, _ in tiles:
                loaded[k0:k0 + bn] = True
        skipped = (~loaded[:b * l]).view(b, l).to(cuda)
        assert skipped.any()
        base = flash_attention(q, k, v, **kw)
        for k_fill, v_fill in ((3.0e4, -3.0e4), (0.0, float("nan"))):
            kp, vp = k.clone(), v.clone()
            kp[skipped] = k_fill
            vp[skipped] = v_fill
            out = flash_attention(q, kp, vp, **kw)
            torch.cuda.synchronize()
            assert torch.equal(out, base)

    @pytest.mark.parametrize("param_dtype, tol_emb, tol_scores", [
        ("float32", 1e-4, 1e-4), ("bfloat16", 2e-2, 5e-2)])
    def test_tinybert_engine_on_card_matches_cpu(self, cuda, monkeypatch,
                                                 param_dtype, tol_emb,
                                                 tol_scores):
        """An engine at TinyBERT-4L-312D's widths (2 layers, vocab cut to
        1024) on the card against the same weights in f32 on the CPU
        (bf16: chip_smoke.py phase 4's tolerances): every attention launch
        on the generic route of its dtype."""
        import numpy as np

        from distributed_crawler_tpu_torch.inference import engine as em
        from distributed_crawler_tpu_torch.models.encoder import (
            EncoderConfig,
        )
        from distributed_crawler_tpu_torch.utils.metrics import (
            MetricsRegistry,
        )

        for dtype in ("float32", param_dtype):
            monkeypatch.setitem(em.MODEL_REGISTRY, f"tinybert_{dtype}",
                                EncoderConfig(
                                    vocab_size=1024, hidden=312, n_layers=2,
                                    n_heads=12, mlp_dim=1200, max_len=512,
                                    dtype=dtype))
        kw = dict(batch_size=4, buckets=(32, 64, 128))
        card = em.InferenceEngine(em.EngineConfig(
            model=f"tinybert_{param_dtype}", **kw),
            registry=MetricsRegistry())
        cpu = em.InferenceEngine(em.EngineConfig(model="tinybert_float32",
                                                 **kw),
                                 registry=MetricsRegistry(), device="cpu")
        cpu.model.load_state_dict({n: t.float().cpu() for n, t in
                                   card.model.state_dict().items()})
        texts = [" ".join(["w%d" % j for j in range(i * 9 + 1)])
                 for i in range(9)]
        path = "simt" if param_dtype == "float32" else "mma_sync"
        for pack in (False, True):
            before = dict(flash_attention.launches_by_path)
            a = card.run(texts, pack=pack)
            b = cpu.run(texts, pack=pack)
            after = flash_attention.launches_by_path
            assert after[path] > before[path]
            assert all(after[p] == before[p] for p in after if p != path)
            np.testing.assert_allclose(
                [r["embedding"] for r in a], [r["embedding"] for r in b],
                atol=tol_emb, rtol=tol_emb)
            np.testing.assert_allclose(
                [r["scores"] for r in a], [r["scores"] for r in b],
                atol=tol_scores, rtol=tol_scores)
