"""The port's copies of the page store, sampler and batcher against the
reference's: the same graph and seeds give bit-identical neighbour reads,
embedding gathers, sampled batches, fused groups and padded groups."""
import numpy as np
import pytest

from repro.serve import batcher as jbatcher
from repro.store.blockdev import BlockDevice as JBlockDevice
from repro.store.graphstore import GraphStore as JGraphStore
from repro.store.sampler import sample_batch as j_sample_batch
from repro_torch.serve import batcher as tbatcher
from repro_torch.store import BlockDevice, GraphStore, sample_batch


def _graph(seed=0, n=400, e=3000, feat=24):
    """Power-law graph; the last 10 vids stay edge-less (isolated)."""
    rng = np.random.default_rng(seed)
    src = rng.zipf(1.4, e) % (n - 10)
    dst = rng.integers(0, n - 10, e)
    edges = np.stack([dst, src], axis=1).astype(np.int64)
    return edges, rng.standard_normal((n, feat)).astype(np.float32), n


def _stores(seed=0, h_threshold=8, cache_pages=None):
    edges, emb, n = _graph(seed)
    port = GraphStore(BlockDevice(), h_threshold=h_threshold)
    ref = JGraphStore(JBlockDevice(), h_threshold=h_threshold)
    for gs in (port, ref):
        if cache_pages:
            gs.attach_cache_pages(cache_pages)
        gs.update_graph(edges, emb)
    return port, ref, n


def _assert_batches_equal(b1, b2):
    np.testing.assert_array_equal(b1.node_vids, b2.node_vids)
    assert b1.num_targets == b2.num_targets
    assert len(b1.layers) == len(b2.layers)
    for l1, l2 in zip(b1.layers, b2.layers):
        assert l1.num_dst == l2.num_dst
        np.testing.assert_array_equal(l1.nbr, l2.nbr)
        np.testing.assert_array_equal(l1.mask, l2.mask)
    np.testing.assert_array_equal(b1.embeddings, b2.embeddings)


@pytest.mark.parametrize("seed,h_threshold", [(0, 8), (1, 4), (2, 64)])
def test_neighbor_and_embedding_reads_match_reference(seed, h_threshold):
    port, ref, n = _stores(seed, h_threshold)
    vids = list(range(n)) + [n + 3]
    for a, b in zip(port.get_neighbors_batch(vids),
                    ref.get_neighbors_batch(vids)):
        np.testing.assert_array_equal(a, b)
    ids = np.random.default_rng(seed).permutation(n)[:137]
    np.testing.assert_array_equal(port.get_embeds(ids), ref.get_embeds(ids))
    assert port.gmap == ref.gmap


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("fanouts", [[4, 3], [10, 10], [2]])
def test_sample_batch_matches_reference(seed, fanouts):
    port, ref, n = _stores(seed)
    targets = [3, 7, 11, n - 2]                 # n-2 is isolated
    _assert_batches_equal(
        sample_batch(port, targets, fanouts, rng=np.random.default_rng(seed),
                     pad_to=16),
        j_sample_batch(ref, targets, fanouts, rng=np.random.default_rng(seed),
                       pad_to=16))


@pytest.mark.parametrize("cache_pages", [None, 64])
def test_sample_group_and_pad_group_match_reference(cache_pages):
    port, ref, n = _stores(1, cache_pages=cache_pages)
    rng = np.random.default_rng(3)
    targets = [rng.integers(0, n, s) for s in (8, 3, 1, 8)]
    seeds = [11, 12, 13, 14]
    tb, ts = tbatcher.sample_group(port, targets, seeds, [5, 5])
    jb, js = jbatcher.sample_group(ref, targets, seeds, [5, 5])
    assert ts == js
    _assert_batches_equal(tb, jb)
    _assert_batches_equal(tbatcher.pad_group(tb, 32), jbatcher.pad_group(jb, 32))
    if cache_pages:
        assert port.cache.stats.snapshot() == ref.cache.stats.snapshot()


def test_unit_mutations_match_reference():
    port, ref, n = _stores(2, h_threshold=4)
    for gs in (port, ref):
        for u in range(20, 30):
            gs.add_edge(0, u)                   # promotes 0 to H-type
        gs.delete_edge(1, 2)
        gs.delete_vertex(5)
        gs.add_vertex(n, np.ones(24, np.float32))
        gs.add_edge(n, 3)
        gs.update_embed(7, np.full(24, 2.0, np.float32))
    assert port.gmap == ref.gmap
    _assert_batches_equal(
        sample_batch(port, [0, 3, 7, n], [4, 4], rng=np.random.default_rng(0)),
        j_sample_batch(ref, [0, 3, 7, n], [4, 4],
                       rng=np.random.default_rng(0)))


def test_bucket_ladder_and_split_match_reference():
    from repro.core.service import make_service_dfg as j_make
    from repro_torch.core.service import make_service_dfg as t_make
    xs = (1, 32, 33, 48, 49, 64, 97, 130, 5000)
    assert [tbatcher._bucket(x, 32) for x in xs] == \
        [jbatcher._bucket(x, 32) for x in xs]
    for model in ("gcn", "gin", "ngcf"):
        tp = tbatcher.split_service_dfg(t_make(model, 2, [5, 5]))
        jp = jbatcher.split_service_dfg(j_make(model, 2, [5, 5]))
        assert (tp.fanouts, tp.feed_refs) == (jp.fanouts, jp.feed_refs)
        assert tp.model.save() == jp.model.save()


def test_fingerprint_weights_matches_reference_and_hashes_tensors():
    import torch
    rng = np.random.default_rng(0)
    w = {"W0": rng.standard_normal((4, 3)).astype(np.float32),
         "b0": np.zeros(3, np.float32)}
    fp = tbatcher.fingerprint_weights(w)
    assert fp == jbatcher.fingerprint_weights(w)
    assert fp == tbatcher.fingerprint_weights(
        {k: torch.from_numpy(v) for k, v in w.items()})
