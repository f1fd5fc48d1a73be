"""Word2Vec in the PyTorch port (on the CPU) against the reference
package.

The host half is the reference's EXACTLY: the vocabulary, the Huffman
points, codes and masks, the subsampling (one draw from the same
``RandomState`` stream), the pairs and the per-epoch permutation, so
every step's batch (centers and context paths) and learning rate are
the reference's. Fed the reference's initial ``W_in`` draw, the port's
closed-form steps give the reference's vectors and epoch losses within
1e-5 relative (to the largest |W_in| and to the loss; seen: equal). A
reference model carried across gives its synonyms and transforms
EXACTLY. The reference's fits run on a one-device mesh
(``_one_device``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import word2vec as ref_w2v
from h2o3_tpu_torch.models import word2vec as port_w2v
from h2o3_tpu_torch.models.convert import word2vec_model_from_arrays

from test_torch_isofor import _one_device
from torch_threads import one_torch_thread  # noqa: F401 - autouse

W_REL = 1e-5
TOPICS = [["cat", "dog", "pet", "fur"], ["car", "road", "wheel", "drive"]]


def topic_words(n_sent=400, seed=0):
    """The reference test's two-topic corpus: six words of one topic a
    sentence, NA between sentences."""
    r = np.random.RandomState(seed)
    words = []
    for _ in range(n_sent):
        words += list(r.choice(TOPICS[r.randint(2)], 6)) + [None]
    return {"words": np.asarray(words, dtype=object)}


def zipf_words(n_sent=300, seed=1):
    """Zipf-distributed words over 300 types with two planted topics,
    sentences of 12 words; some rare words fall under min_word_freq."""
    r = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, 301)
    vocab = np.array([f"w{i}" for i in range(300)])
    words = []
    for s in range(n_sent):
        if s % 5 == 0:
            words += list(r.choice(TOPICS[s % 2], 12))
        else:
            words += list(r.choice(vocab, 12, p=p / p.sum()))
        words.append(None)
    return {"words": np.asarray(words, dtype=object)}


@pytest.fixture
def spied(monkeypatch):
    """Records every step's (centers, points, lr) in both packages and
    starts the port from the reference's W_in draw."""
    calls = {"ref": [], "port": []}
    ref_step, port_step = ref_w2v._sgd_step, port_w2v._sgd_step

    def ref_spy(W_in, W_out, c, pts, cds, m, lr):
        calls["ref"].append((np.asarray(c), np.asarray(pts),
                             np.float32(lr)))
        return ref_step(W_in, W_out, c, pts, cds, m, lr)

    def port_spy(W_in, W_out, c, pts, cds, m, lr):
        calls["port"].append((c.numpy().copy(), pts.numpy().copy(),
                              np.float32(lr)))
        return port_step(W_in, W_out, c, pts, cds, m, lr)

    def ref_draw(V, D, seed):
        key = jax.random.PRNGKey(abs(int(seed)) or 7)
        return torch.from_numpy(np.array(
            (jax.random.uniform(key, (V, D), jnp.float32) - 0.5) / D))

    monkeypatch.setattr(ref_w2v, "_sgd_step", ref_spy)
    monkeypatch.setattr(port_w2v, "_sgd_step", port_spy)
    monkeypatch.setattr(port_w2v, "draw_init_W_in", ref_draw)
    return calls


def _fit(cols, **kw):
    with _one_device():
        fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=["words"])
        m_r = ref_w2v.Word2VecEstimator(**kw).train(fr_r)
    fr_p = h2o3_tpu_torch.Frame.from_numpy(cols, device="cpu")
    m_p = h2o3_tpu_torch.Word2VecEstimator(**kw).train(fr_p)
    return m_r, fr_r, m_p, fr_p


@pytest.mark.parametrize("make,kw", [
    (zipf_words, dict(vec_size=16, epochs=2, min_word_freq=3, seed=3,
                      window_size=3, sent_sample_rate=0.01)),
    (zipf_words, dict(vec_size=8, epochs=1, batch_size=100, seed=-1)),
    (topic_words, dict(vec_size=16, epochs=3, min_word_freq=2,
                       window_size=3, sent_sample_rate=0.0, seed=42))])
def test_batches_exact_and_vectors_close(spied, make, kw):
    cols = make()
    m_r, _, m_p, _ = _fit(cols, **kw)
    assert m_p.vocab == m_r.vocab
    assert m_p.output["vocab_size"] == m_r.output["vocab_size"]
    assert len(spied["port"]) == len(spied["ref"]) == m_p.output["steps"]
    for (c_p, p_p, lr_p), (c_r, p_r, lr_r) in zip(spied["port"],
                                                  spied["ref"]):
        np.testing.assert_array_equal(c_p, c_r)
        np.testing.assert_array_equal(p_p, p_r)
        assert lr_p == lr_r
    scale = np.abs(m_r.vectors).max()
    assert np.abs(m_p.vectors - m_r.vectors).max() <= W_REL * scale
    np.testing.assert_allclose(m_p.output["epoch_loss"],
                               m_r.output["epoch_loss"], rtol=W_REL)


def test_huffman_exact():
    counts = np.array([50, 3, 3, 17, 1, 1, 9, 120, 2, 2, 2, 40])
    for a, b in zip(port_w2v._build_huffman(counts),
                    ref_w2v._build_huffman(counts)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_topics_separate_and_surface_matches_reference():
    """The reference test's corpus and parameters: each topic word's
    three nearest words hold two of its own topic; a model carried
    across from the reference's vectors gives its synonyms, transforms
    and word frame EXACTLY."""
    cols = topic_words()
    kw = dict(vec_size=16, epochs=10, min_word_freq=2, window_size=3,
              sent_sample_rate=0.0, seed=42)
    m_r, fr_r, m_p, fr_p = _fit(cols, **kw)
    assert m_p.output["vocab_size"] == 8
    for topic in TOPICS:
        for w in topic:
            syn = m_p.find_synonyms(w, count=3)
            assert len(syn) == 3 and sum(s in topic for s in syn) >= 2, w
    m_c = word2vec_model_from_arrays(dict(
        vectors=m_r.vectors, vocab=m_r.vocab, output=dict(m_r.output),
        params=dict(m_r.params)))
    for w in ("cat", "road", "nope"):
        assert m_c.find_synonyms(w, 5) == m_r.find_synonyms(w, 5)
    with _one_device():
        ref_none = m_r.transform(fr_r, "NONE")
        ref_avg = m_r.transform(fr_r, "AVERAGE")
        ref_wf = m_r.to_frame()
        ref_none = {n: ref_none.col(n).to_numpy() for n in ref_none.names}
        ref_avg = {n: ref_avg.col(n).to_numpy() for n in ref_avg.names}
        ref_words = ref_wf.col("Word").domain
    for agg, want in (("NONE", ref_none), ("AVERAGE", ref_avg)):
        got = m_c.transform(fr_p, agg)
        assert got.names == list(want)
        for n in got.names:
            np.testing.assert_array_equal(got.col(n).to_numpy(), want[n])
    assert m_p.transform(fr_p, "AVERAGE").nrows == 400
    wf = m_c.to_frame(device="cpu")
    assert wf.nrows == 8 and wf.ncols == 17
    assert wf.col("Word").domain == ref_words


def test_parameters():
    fr = h2o3_tpu_torch.Frame.from_numpy(
        {"words": np.asarray(["a", "b", None, "a"], dtype=object)},
        device="cpu")
    with pytest.raises(ValueError, match=">= 2 vocabulary words"):
        h2o3_tpu_torch.Word2VecEstimator().train(fr)
    with pytest.raises(ValueError, match="unknown Word2Vec params"):
        h2o3_tpu_torch.Word2VecEstimator(negative=5)
