"""The attention wrapper's path choice and the sm90 kernel's tile-skip rule,
on the CPU.

`choose_path` decides from dtype and layout alone which CUDA kernel takes
the operands; it is a pure function, so it is tested here on CPU tensors.
`key_tile_plan` is the sm90 kernel's skip rule written in plain PyTorch:
which key tiles each query block (and each of its two warpgroups of 64
rows) computes.  Overwriting the K/V of every key a warpgroup skips with
large finite values must leave that warpgroup's output rows bitwise equal,
in the port's `attend` and in the JAX package's `attend` (same numpy inputs
from a seed): skipped keys are masked for those rows, so their
probabilities are exactly 0.
"""

import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import numpy as np  # noqa: E402

from distributed_crawler_tpu.ops.attention import (  # noqa: E402
    attend as jax_attend,
)
from distributed_crawler_tpu_torch.ops import attention  # noqa: E402
from distributed_crawler_tpu_torch.ops.attention import (  # noqa: E402
    SM90_BLOCK_M,
    SM90_BLOCK_N,
    SM90_WG_ROWS,
    attend,
    choose_path,
    flash_attention,
    key_tile_plan,
)

POISON = 3.0e4  # large and finite: q.k stays finite in f32 at head dim 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are small, and the suite runs beside
    timing-sensitive tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fused(b, l, h, d, dtype=torch.bfloat16, offset=0):
    """q, k, v as the encoder hands them over: views of one [b, l, 3, h, d]
    projection; ``offset`` elements in front break 16-byte alignment."""
    flat = torch.zeros(b * l * 3 * h * d + offset, dtype=dtype)
    proj = flat[offset:].view(b, l, 3, h, d)
    return proj[:, :, 0], proj[:, :, 1], proj[:, :, 2]


def _padded_token_stride(b, l, h, d, extra):
    """Rows of h*d values with ``extra`` elements between tokens."""
    base = torch.zeros(b, l, h * d + extra, dtype=torch.bfloat16)
    x = base[..., :h * d].unflatten(-1, (h, d))
    return x, x, x


class TestChoosePath:
    @pytest.mark.parametrize("make, path", [
        (lambda: _fused(2, 64, 12, 32), "sm90"),
        (lambda: _fused(2, 100, 4, 64), "sm90"),
        (lambda: _fused(1, 8, 1, 32), "sm90"),
        (lambda: _fused(2, 64, 4, 16), "mma_sync"),        # head dim 16
        (lambda: _fused(2, 64, 4, 32, offset=1), "mma_sync"),  # unaligned
        (lambda: _fused(2, 64, 4, 32, torch.float32), "simt"),
        (lambda: _fused(2, 64, 4, 64, torch.float32), "simt"),
        (lambda: _padded_token_stride(2, 16, 2, 32, 8), "sm90"),
        (lambda: _padded_token_stride(2, 16, 2, 32, 4), "mma_sync"),
    ], ids=["e5-small-qkv", "d64-ragged", "one-row", "d16", "unaligned",
            "f32-d32", "f32-d64", "token-stride-16B", "token-stride-8B"])
    def test_layouts(self, make, path):
        q, k, v = make()
        assert choose_path(q, k, v) == path

    def test_contiguous_bf16_takes_sm90(self):
        q = torch.zeros(3, 40, 2, 32, dtype=torch.bfloat16)
        assert choose_path(q, q.clone(), q.clone()) == "sm90"

    def test_rows_not_one_flat_axis(self):
        # Every other batch row: the batch stride is 2 L token strides, so
        # the tokens are not one flat [B*L] axis for TMA.
        q, k, v = _fused(4, 32, 2, 32)
        assert choose_path(q[::2], k[::2], v[::2]) == "mma_sync"
        # A BHLD tensor viewed as BLHD: the batch stride is H*L*D, not L
        # token strides; with one batch row the tokens are flat again.
        bhld = torch.zeros(2, 4, 32, 32, dtype=torch.bfloat16).transpose(1, 2)
        assert choose_path(bhld, bhld, bhld) == "mma_sync"
        assert choose_path(bhld[:1], bhld[:1], bhld[:1]) == "sm90"

    def test_any_operand_decides(self):
        q, k, v = _fused(2, 64, 4, 32)
        _, k_bad, _ = _fused(2, 64, 4, 32, offset=1)
        assert choose_path(q, k_bad, v) == "mma_sync"

    def test_cpu_launches_nothing(self):
        q, k, v = _fused(2, 64, 4, 32, torch.float32)
        before = dict(flash_attention.launches_by_path)
        flash_attention(q, k, v, path="sm90")  # a CPU tensor takes attend
        assert flash_attention.launches_by_path == before
        assert set(before) == set(attention.PATHS)


def _np_case(kind, seed):
    """(q, k, v, kv_mask, segment_ids) as numpy, f32, from a seed."""
    rng = np.random.default_rng(seed)
    b, l = {"padded": (3, 200), "packed": (2, 256), "short": (5, 32),
            "tiny": (9, 8), "holes": (2, 300), "wide_ids": (3, 96)}[kind]
    h, d = 2, 16
    q, k, v = (rng.normal(size=(b, l, h, d)).astype(np.float32)
               for _ in range(3))
    lens = rng.integers(1, l + 1, size=b)
    mask = np.arange(l)[None, :] < lens[:, None]
    seg = None
    if kind == "packed":
        seg = np.zeros((b, l), np.int32)
        for r in range(b):
            cuts = np.sort(rng.choice(np.arange(1, l), 8, replace=False))
            bounds = np.concatenate([[0], cuts])
            for s in range(8):
                seg[r, bounds[s]:bounds[s + 1]] = s + 1
        mask = seg > 0
    elif kind == "holes":
        mask[:, 64:192] = False
    elif kind == "wide_ids":
        # Segment ids outside [0, 32), negative ones and repeats.
        seg = rng.choice(np.array([-7, 5, 40, 1 << 20], np.int32),
                         size=(b, l))
        seg.sort(axis=1)
    elif kind == "tiny":
        mask[0] = False  # a fully masked row
    return q, k, v, mask, seg


CASES = ["padded", "packed", "short", "tiny", "holes", "wide_ids"]


def _skipped_keys(plan, b, l):
    """For each (query block, warpgroup): its query tokens and the flat
    key tokens it never loads."""
    t = b * l
    out = []
    for i, tiles in enumerate(plan):
        q0 = i * SM90_BLOCK_M
        for w in range(SM90_BLOCK_M // SM90_WG_ROWS):
            r0 = q0 + w * SM90_WG_ROWS
            if r0 >= t:
                continue
            rows = np.arange(r0, min(r0 + SM90_WG_ROWS, t))
            seen = np.zeros(t, bool)
            for k0, bits in tiles:
                if bits >> w & 1:
                    seen[k0:min(k0 + SM90_BLOCK_N, t)] = True
            out.append((rows, np.flatnonzero(~seen)))
    return out


def _poisoned(x, keys, l):
    y = x.copy()
    y[keys // l, keys % l] = POISON
    return y


class TestKeyTilePlan:
    @pytest.mark.parametrize("kind", CASES)
    def test_plan_is_exact(self, kind):
        """A listed tile has an allowed pair for the warpgroup, and every
        allowed pair lies in a tile listed for the query's warpgroup."""
        _, _, _, mask, seg = _np_case(kind, seed=CASES.index(kind))
        b, l = mask.shape
        t = b * l
        plan = key_tile_plan(torch.from_numpy(mask),
                             None if seg is None else torch.from_numpy(seg),
                             b, l)
        assert len(plan) == -(-t // SM90_BLOCK_M)
        flat_seg = (seg if seg is not None else np.zeros_like(mask,
                                                              np.int32))
        row = np.arange(t) // l
        tag = list(zip(row, flat_seg.reshape(-1)))
        valid = mask.reshape(-1)
        for rows, skipped in _skipped_keys(plan, b, l):
            q_tags = {tag[r] for r in rows}
            allowed_keys = {kk for kk in range(t)
                            if valid[kk] and tag[kk] in q_tags}
            assert not allowed_keys & set(skipped.tolist())
        for i, tiles in enumerate(plan):
            for k0, bits in tiles:
                for w in range(2):
                    if not bits >> w & 1:
                        continue
                    r0 = i * SM90_BLOCK_M + w * SM90_WG_ROWS
                    q_tags = {tag[r] for r in range(r0, min(r0 + 64, t))}
                    assert any(valid[kk] and tag[kk] in q_tags
                               for kk in range(k0, min(k0 + 64, t)))

    @pytest.mark.parametrize("kind", CASES)
    def test_poisoning_skipped_keys_changes_nothing(self, kind):
        q, k, v, mask, seg = _np_case(kind, seed=10 + CASES.index(kind))
        b, l = mask.shape
        tm, ts = torch.from_numpy(mask), (None if seg is None
                                          else torch.from_numpy(seg))
        plan = key_tile_plan(tm, ts, b, l)
        jseg = None if seg is None else jnp.asarray(seg)
        base = attend(*map(torch.from_numpy, (q, k, v)), tm,
                      segment_ids=ts).numpy().reshape(b * l, -1)
        jbase = np.asarray(jax_attend(*map(jnp.asarray, (q, k, v, mask)),
                                      segment_ids=jseg)).reshape(b * l, -1)
        np.testing.assert_allclose(base, jbase, atol=1e-5, rtol=1e-5)
        n_skipped = 0
        for rows, skipped in _skipped_keys(plan, b, l):
            n_skipped += skipped.size
            kp, vp = _poisoned(k, skipped, l), _poisoned(v, skipped, l)
            out = attend(*map(torch.from_numpy, (q, kp, vp)), tm,
                         segment_ids=ts).numpy().reshape(b * l, -1)
            jout = np.asarray(jax_attend(
                *map(jnp.asarray, (q, kp, vp, mask)),
                segment_ids=jseg)).reshape(b * l, -1)
            np.testing.assert_array_equal(out[rows], base[rows])
            np.testing.assert_array_equal(jout[rows], jbase[rows])
        assert n_skipped > 0  # the rule does skip keys in every case

    def test_short_rows_skip_other_sequences(self):
        """At L = 32 a block holds four sequences: each warpgroup computes
        only the one key tile of its own two."""
        b, l = 8, 32
        plan = key_tile_plan(torch.ones(b, l, dtype=torch.bool), None, b, l)
        assert plan == [[(0, 1), (64, 2)], [(128, 1), (192, 2)]]

    def test_padding_tiles_are_skipped(self):
        mask = torch.zeros(2, 512, dtype=torch.bool)
        mask[0, :100] = True
        mask[1, :300] = True
        plan = key_tile_plan(mask, None, 2, 512)
        assert [k0 for k0, _ in plan[0]] == [0, 64]
        assert [k0 for k0, _ in plan[4]] == [512 + 64 * j for j in range(5)]

    def test_no_allowed_key_lists_no_tile(self):
        mask = torch.zeros(1, 256, dtype=torch.bool)
        assert key_tile_plan(mask, None, 1, 256) == [[], []]


class TestAblationScript:
    def test_every_variant_applies_to_the_kernel_source(self):
        """ops/sm90_ablation.py times the kernel with one piece of work
        taken out per variant; a substitution that no longer matches the
        source must fail here, not silently time the unmodified kernel."""
        from distributed_crawler_tpu_torch.ops import sm90_ablation

        source = sm90_ablation.SOURCE.read_text()
        for name, subs in sm90_ablation.VARIANTS.items():
            changed = sm90_ablation.variant_source(name, source)
            assert (changed != source) == bool(subs), name
        with pytest.raises(ValueError):
            sm90_ablation.variant_source("no_exp", "no kernel here")
