"""The port's threshold and bitmap encoding (``parallel/compression.py``)
against the JAX package's, on the CPU, on seeded numpy inputs.

The message must be the reference's slot for slot (indices, values and
count, in ``jax.lax.top_k``'s order: descending score, ties by ascending
index) and the residual bit-equal, with the capacity saturated and not,
exact ties at the capacity's cut and at the threshold, zeros, and a
capacity equal to the size. The bitmap's lanes and residual are bit-equal
(sizes off 16 too), the decodes equal the reference's, and so do
``EncodingHandler``'s threshold over ten rounds and the decode of several
ranks' messages in rank order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import compression as jc
from deeplearning4j_tpu_torch.parallel import compression as tc


def bits(a) -> np.ndarray:
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(np.uint32) if a.dtype in (np.float32, np.int32) else a


def assert_same_message(grad, threshold, capacity):
    jm, jr = jc.threshold_encode(jnp.asarray(grad), jnp.asarray(threshold, jnp.float32),
                                 capacity)
    tm, tr = tc.threshold_encode(torch.from_numpy(grad), threshold, capacity)
    np.testing.assert_array_equal(tm.indices.numpy(), np.asarray(jm.indices))
    np.testing.assert_array_equal(bits(tm.values), bits(np.asarray(jm.values)))
    assert tm.indices.dtype == torch.int32 and tm.values.dtype == torch.float32
    assert int(tm.count) == int(jm.count)
    np.testing.assert_array_equal(bits(tr), bits(np.asarray(jr)))
    assert tuple(tr.shape) == grad.shape
    return tm


def tied(rng, n):
    """Values drawn from a few magnitudes, so many elements tie exactly, at
    the threshold (1e-3) and elsewhere."""
    levels = np.array([0.0, 5e-4, 1e-3, -1e-3, 2e-3, -2e-3, 3e-3], np.float32)
    return rng.choice(levels, n)


CASES = {
    "unsaturated": lambda rng: (rng.standard_normal(1000) * 1e-3).astype(np.float32),
    "saturated": lambda rng: (rng.standard_normal(4096) * 1e-2).astype(np.float32),
    "ties": lambda rng: tied(rng, 777),
    "zeros": lambda rng: np.zeros(400, np.float32),
    "matrix": lambda rng: (rng.standard_normal((17, 19)) * 1e-3).astype(np.float32),
}


@pytest.mark.parametrize("capacity", [1, 64, 300])
@pytest.mark.parametrize("case", sorted(CASES))
def test_threshold_encode_is_the_references_slot_for_slot(case, capacity):
    rng = np.random.default_rng(len(case) * 100 + capacity)
    assert_same_message(CASES[case](rng), 1e-3, capacity)


def test_ties_at_the_cut_keep_the_lowest_indices():
    """Twenty elements of one magnitude compete for the last five slots of
    eight: the reference keeps the lowest-index ones, and so does the
    port, in the reference's order."""
    g = np.full(64, 1e-4, np.float32)
    g[[3, 50]] = [5e-2, -6e-2]
    g[[9, 60]] = 3e-2
    tie = np.sort(np.random.default_rng(0).choice(
        [i for i in range(64) if i not in (3, 9, 50, 60)], 20, replace=False))
    g[tie] = np.where(np.arange(20) % 2, 2e-2, -2e-2).astype(np.float32)
    tm = assert_same_message(g, 1e-3, 8)
    assert tm.indices.tolist()[:4] == [50, 3, 9, 60]
    assert tm.indices.tolist()[4:] == tie[:4].tolist()


@pytest.mark.parametrize("threshold", [1e-3, 2e-3])
def test_elements_exactly_at_the_threshold_are_sent(threshold):
    g = tied(np.random.default_rng(3), 200)
    tm = assert_same_message(g, threshold, 200)
    assert int(tm.count) == int((np.abs(g) >= np.float32(threshold)).sum())


def test_capacity_equal_to_the_size_sends_everything_over_the_threshold():
    g = (np.random.default_rng(4).standard_normal(333) * 1e-3).astype(np.float32)
    tm = assert_same_message(g, 1e-3, 333)
    assert int(tm.count) == int((np.abs(g) >= np.float32(1e-3)).sum())


def test_threshold_decode_is_the_references():
    g = (np.random.default_rng(5).standard_normal(500) * 1e-3).astype(np.float32)
    jm, _ = jc.threshold_encode(jnp.asarray(g), jnp.asarray(1e-3, jnp.float32), 64)
    tm, tr = tc.threshold_encode(torch.from_numpy(g), 1e-3, 64)
    dec = tc.threshold_decode(tm, 500)
    np.testing.assert_array_equal(bits(dec), bits(np.asarray(jc.threshold_decode(jm, 500))))
    # nothing is lost: residual + decode == the input
    np.testing.assert_allclose((tr + dec).numpy(), g, rtol=0, atol=1e-9)


class _StackedMesh:
    """A stand-in mesh whose ``all_gather`` hands back the given ranks'
    rows, to hold the decode of several ranks' messages in one process."""

    def __init__(self, rows):
        self.rows = rows

    def all_gather(self, row):
        key = "indices" if row.dtype == torch.int32 else "values"
        return torch.stack([r[key] for r in self.rows])


def test_gather_and_decode_adds_the_ranks_in_rank_order():
    """Four ranks' messages overlapping in their indices: the dense sum is
    the reference's ``.at[].add`` over the gathered (n, K) messages, bit for
    bit, and reruns agree."""
    rng = np.random.default_rng(6)
    grads = (rng.standard_normal((4, 300)) * 1e-3).astype(np.float32)
    msgs = [tc.threshold_encode(torch.from_numpy(g), 1e-3, 40)[0] for g in grads]
    mesh = _StackedMesh([{"indices": m.indices, "values": m.values} for m in msgs])
    like = torch.zeros(300)
    got = tc.gather_and_decode(msgs[0], like, mesh)
    idx = np.stack([m.indices.numpy() for m in msgs])
    val = np.stack([m.values.numpy() for m in msgs])
    flat_idx = jnp.maximum(jnp.asarray(idx.reshape(-1)), 0)
    flat_val = jnp.where(jnp.asarray(idx.reshape(-1)) >= 0, jnp.asarray(val.reshape(-1)), 0.0)
    want = jnp.zeros((300,), jnp.float32).at[flat_idx].add(flat_val)
    np.testing.assert_array_equal(bits(got), bits(np.asarray(want)))
    assert torch.equal(got, tc.gather_and_decode(msgs[0], like, mesh))


@pytest.mark.parametrize("n", [16, 77, 100, 1])
def test_bitmap_lanes_residual_and_decode_are_the_references(n):
    rng = np.random.default_rng(n)
    g = np.concatenate([tied(rng, n // 2), (rng.standard_normal(n - n // 2) * 3e-3)
                        .astype(np.float32)])
    t = jnp.asarray(1e-3, jnp.float32)
    jp, jr = jc.bitmap_encode(jnp.asarray(g), t)
    tp, tr = tc.bitmap_encode(torch.from_numpy(g), 1e-3)
    assert tp.dtype == torch.int32 and tuple(tp.shape) == (-(-n // 16),)
    np.testing.assert_array_equal(tp.numpy().view(np.uint32), np.asarray(jp))
    np.testing.assert_array_equal(bits(tr), bits(np.asarray(jr)))
    np.testing.assert_array_equal(bits(tc.bitmap_decode(tp, 1e-3, n)),
                                  bits(np.asarray(jc.bitmap_decode(jp, t, n))))


def test_bitmap_lane_with_the_top_bit_set():
    """Code 2 in the last slot of a lane sets its bit 31: the int32 lane
    holds the reference's uint32 bits and decodes back."""
    g = np.full(16, -5e-3, np.float32)
    jp, _ = jc.bitmap_encode(jnp.asarray(g), jnp.asarray(1e-3, jnp.float32))
    tp, _ = tc.bitmap_encode(torch.from_numpy(g), 1e-3)
    assert int(np.asarray(jp)[0]) >= 2 ** 31
    np.testing.assert_array_equal(tp.numpy().view(np.uint32), np.asarray(jp))
    assert torch.equal(tc.bitmap_decode(tp, 1e-3, 16), torch.full((16,), -1e-3))


def test_encoding_handler_adapts_as_the_references():
    """Ten rounds of gradients that first saturate the capacity, then fall
    under the target: the same messages, residuals and thresholds."""
    rng = np.random.default_rng(7)
    jh = jc.EncodingHandler(size=512, threshold=1e-3, capacity=32)
    th = tc.EncodingHandler(size=512, threshold=1e-3, capacity=32)
    for r in range(10):
        scale = 1e-2 if r < 5 else 1e-5
        g = (rng.standard_normal(512) * scale).astype(np.float32)
        jm = jh.encode_update(jnp.asarray(g))
        tm = th.encode_update(torch.from_numpy(g))
        np.testing.assert_array_equal(tm.indices.numpy(), np.asarray(jm.indices))
        np.testing.assert_array_equal(bits(tm.values), bits(np.asarray(jm.values)))
        np.testing.assert_array_equal(bits(th.residual), bits(np.asarray(jh.residual)))
        assert th.threshold == jh.threshold and th.last_utilization == jh.last_utilization
    p = (rng.standard_normal(512)).astype(np.float32)
    np.testing.assert_array_equal(
        bits(th.apply_update(torch.from_numpy(p), tm)),
        bits(np.asarray(jh.apply_update(jnp.asarray(p), jm))))


def test_one_rank_compressed_allreduce_is_the_references():
    """``make_compressed_allreduce`` on a one-rank gloo group in this
    process against the reference's on one device."""
    from deeplearning4j_tpu.parallel.mesh import TrainingMesh as JMesh
    from deeplearning4j_tpu_torch.parallel import TrainingMesh

    rng = np.random.default_rng(8)
    g = (rng.standard_normal(256) * 1e-3).astype(np.float32)
    res = (rng.standard_normal(256) * 1e-4).astype(np.float32)
    jfn = jc.make_compressed_allreduce(JMesh(data=1, devices=jax.devices()[:1]), capacity=50)
    js, jr = jfn(jnp.asarray(g[None]), jnp.asarray(res[None]), jnp.asarray(1e-3, jnp.float32))
    tfn = tc.make_compressed_allreduce(TrainingMesh(1, device="cpu"), capacity=50)
    ts, tr = tfn(torch.from_numpy(g), torch.from_numpy(res), 1e-3)
    np.testing.assert_array_equal(bits(ts), bits(np.asarray(js)))
    np.testing.assert_array_equal(bits(tr), bits(np.asarray(jr)[0]))


def test_capacity_over_the_size_is_refused_as_the_reference_refuses_it():
    g = np.ones(10, np.float32)
    with pytest.raises(ValueError, match="top_k"):
        jc.threshold_encode(jnp.asarray(g), jnp.asarray(1e-3, jnp.float32), 11)
    with pytest.raises(ValueError, match="top_k"):
        tc.threshold_encode(torch.from_numpy(g), 1e-3, 11)
