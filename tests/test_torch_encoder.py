"""The port's encoder against the JAX package's, on the CPU.

`TINY_TEST` in f32: flax ``.init`` -> numpy -> `load_flax_params`, then
embeddings and logits against ``.apply``, unpacked and packed.  Tolerance
1e-5 abs / 1e-4 rel: f32 throughout; flax's LayerNorm takes the variance as
E[x²]-E[x]² where torch subtracts the mean first (~1e-6), and sums run in
another order.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from distributed_crawler_tpu.models import encoder as jenc  # noqa: E402
from distributed_crawler_tpu.ops.padding import pack_rows  # noqa: E402
from distributed_crawler_tpu_torch.models import encoder as tenc  # noqa: E402
from distributed_crawler_tpu_torch.models.from_jax import (  # noqa: E402
    flax_leaves,
    load_flax_params,
)

TOL = dict(atol=1e-5, rtol=1e-4)
N_SEG = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are small, and the suite runs beside
    timing-sensitive tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    cfg = dataclasses.replace(jenc.TINY_TEST, n_labels=3)
    jmodel = jenc.EmbedderClassifier(cfg)
    ids = jnp.zeros((1, 32), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(0), ids, jnp.ones((1, 32), bool))
    tmodel = tenc.EmbedderClassifier(dataclasses.replace(tenc.TINY_TEST,
                                                         n_labels=3))
    load_flax_params(tmodel, jax.tree.map(np.asarray, params))
    return jmodel, params, tmodel.eval()


def _batch(seed=0, b=5, l=32, vocab=1024):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, size=(b, l)).astype(np.int32)
    lens = rng.integers(1, l + 1, size=b)
    mask = np.arange(l)[None, :] < lens[:, None]
    ids[~mask] = 0
    return ids, mask


def _packed(seed=1):
    rng = np.random.default_rng(seed)
    seqs = [list(rng.integers(4, 1024, size=int(n)))
            for n in rng.integers(1, 20, size=11)]
    return seqs, pack_rows(seqs, 32, max_segments=N_SEG)


@pytest.mark.parametrize("name", ["E5_SMALL", "E5_BASE", "E5_LARGE",
                                  "XLMR_BASE", "TINY_TEST"])
def test_presets_equal_field_for_field(name):
    assert (dataclasses.asdict(getattr(tenc, name))
            == dataclasses.asdict(getattr(jenc, name)))
    assert ([f.name for f in dataclasses.fields(tenc.EncoderConfig)]
            == [f.name for f in dataclasses.fields(jenc.EncoderConfig)])


def test_unpacked_matches_flax(pair):
    jmodel, params, tmodel = pair
    ids, mask = _batch()
    jemb, jlog = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        temb, tlog = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), **TOL)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


def test_packed_matches_flax(pair):
    jmodel, params, tmodel = pair
    _, p = _packed()
    jemb, jlog = jmodel.apply(
        params, jnp.asarray(p.ids), jnp.asarray(p.mask),
        segment_ids=jnp.asarray(p.segment_ids),
        positions=jnp.asarray(p.positions), n_segments=N_SEG)
    with torch.inference_mode():
        temb, tlog = tmodel(
            torch.from_numpy(p.ids), torch.from_numpy(p.mask),
            segment_ids=torch.from_numpy(p.segment_ids),
            positions=torch.from_numpy(p.positions), n_segments=N_SEG)
    assert tuple(temb.shape) == (p.n_rows, N_SEG, 64)
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), **TOL)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


def test_packed_equals_unpacked_per_segment(pair):
    _, _, tmodel = pair
    seqs, p = _packed()
    with torch.inference_mode():
        pemb, plog = tmodel(
            torch.from_numpy(p.ids), torch.from_numpy(p.mask),
            segment_ids=torch.from_numpy(p.segment_ids),
            positions=torch.from_numpy(p.positions), n_segments=N_SEG)
        for r, slots in enumerate(p.assignments):
            for s, j in enumerate(slots):
                ids = np.asarray([seqs[j]], dtype=np.int32)
                uemb, ulog = tmodel(torch.from_numpy(ids),
                                    torch.ones(ids.shape, dtype=torch.bool))
                np.testing.assert_allclose(pemb[r, s].numpy(),
                                           uemb[0].numpy(), **TOL)
                np.testing.assert_allclose(plog[r, s].numpy(),
                                           ulog[0].numpy(), **TOL)
        # Empty slots come out zero.
        used = {(r, s) for r, slots in enumerate(p.assignments)
                for s in range(len(slots))}
        for r in range(p.n_rows):
            for s in range(N_SEG):
                if (r, s) not in used:
                    assert not pemb[r, s].any()


def test_pooling_helpers_match(pair):
    rng = np.random.default_rng(5)
    hidden = rng.normal(size=(3, 16, 8)).astype(np.float32)
    seg = np.zeros((3, 16), np.int32)
    seg[0, :5], seg[0, 5:9], seg[1, :16], seg[2, 3:7] = 1, 2, 1, 1
    mask = seg > 0
    th, tm, ts = (torch.from_numpy(x) for x in (hidden, mask, seg))
    jh, jm, js = (jnp.asarray(x) for x in (hidden, mask, seg))
    np.testing.assert_allclose(tenc.mean_pool(th, tm).numpy(),
                               np.asarray(jenc.mean_pool(jh, jm)), **TOL)
    np.testing.assert_allclose(
        tenc.l2_normalize(th).numpy(),
        np.asarray(jenc.l2_normalize(jh)), **TOL)
    np.testing.assert_allclose(
        tenc.segment_mean_pool(th, tm, ts, 4).numpy(),
        np.asarray(jenc.segment_mean_pool(jh, jm, js, 4)), **TOL)
    np.testing.assert_allclose(
        tenc.segment_first_token(th, tm, ts, 4).numpy(),
        np.asarray(jenc.segment_first_token(jh, jm, js, 4)), **TOL)


class TestLoader:
    def _tree(self, pair):
        _, params, _ = pair
        return jax.tree.map(np.asarray, params)

    def _fresh(self):
        return tenc.EmbedderClassifier(dataclasses.replace(tenc.TINY_TEST,
                                                           n_labels=3))

    def test_every_leaf_mapped_with_or_without_params_key(self, pair):
        tree = self._tree(pair)
        flat = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
        assert len(flat) == len(flax_leaves(self._fresh()))
        a = load_flax_params(self._fresh(), tree)
        b = load_flax_params(self._fresh(), tree["params"])
        for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                      b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)

    def test_qkv_layout(self, pair):
        """flax [h, 3, h] q/k/v-major -> nn.Linear [3h, h]: q's rows
        first, each the transpose of the flax slice."""
        tree = self._tree(pair)
        kernel = tree["params"]["encoder"]["layers_0"]["attn"]["qkv/kernel"]
        model = load_flax_params(self._fresh(), tree)
        w = model.encoder.layers[0].attn.qkv.weight.detach().numpy()
        h = kernel.shape[0]
        for t in range(3):
            np.testing.assert_array_equal(w[t * h:(t + 1) * h],
                                          kernel[:, t, :].T)

    def test_missing_leaf_raises(self, pair):
        tree = self._tree(pair)
        del tree["params"]["cls_head"]["head"]["bias"]
        with pytest.raises(ValueError, match="missing"):
            load_flax_params(self._fresh(), tree)

    def test_extra_leaf_raises(self, pair):
        tree = self._tree(pair)
        tree["params"]["encoder"]["extra"] = np.zeros(3, np.float32)
        with pytest.raises(ValueError, match="unknown"):
            load_flax_params(self._fresh(), tree)

    def test_misshaped_leaf_raises(self, pair):
        tree = self._tree(pair)
        enc = tree["params"]["encoder"]
        enc["layers_1"]["mlp"]["mlp_up"]["kernel"] = np.zeros((64, 64),
                                                              np.float32)
        with pytest.raises(ValueError, match="shape"):
            load_flax_params(self._fresh(), tree)


@pytest.mark.parametrize("change, err", [
    ({"n_experts": 4, "moe_dispatch": "capacity", "quant": "int8"},
     ValueError),
    ({"quant": "int8", "calibrate": True}, ValueError),
    ({"quant": "int8_static", "calibrate": True}, ValueError),
    ({"quant": "int4"}, ValueError),
])
def test_waiting_features_raise(change, err):
    """Configs the reference's ``validate()`` refuses raise here too:
    capacity dispatch with int8 experts, int8 with calibration, an unknown
    quant mode."""
    with pytest.raises(err):
        tenc.EmbedderClassifier(dataclasses.replace(tenc.TINY_TEST, **change))
    with pytest.raises(err):
        dataclasses.replace(jenc.TINY_TEST, **change).validate()


def test_remat_is_accepted_and_ignored(pair):
    """``remat`` only changes how the backward pass gets its activations:
    at inference the outputs are the same as without it."""
    _, params, tmodel = pair
    remat = tenc.EmbedderClassifier(
        dataclasses.replace(tenc.TINY_TEST, n_labels=3, remat=True))
    load_flax_params(remat, jax.tree.map(np.asarray, params))
    ids, mask = _batch(seed=3)
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        for a, b in zip(remat.eval()(ids_t, mask_t), tmodel(ids_t, mask_t)):
            assert torch.equal(a, b)
