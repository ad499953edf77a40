"""Parity of the port's place recognition (``place/``) with the JAX package
on the CPU.

``transform``: the same word for every descriptor (0 mismatches) and the
same distance, on the shipped 32k-word bank and on a small trained one, with
ties planted (duplicated words: the first one wins, as ``jnp.argmin``).
``bow_vector``: within 1e-6, with and without idf.  ``train_vocabulary``:
the same centroids for a seed.  ``_detect_simple`` and ``_detect_nbest``
on integer covisibility weights with ties and duplicated BoW rows: the same
slots, scores within 1e-5; the candidate sets do not flip (the gates compare
at 0.8x and 0.75x).  Common-word counts above 256 are exact (a bf16 product
would round 399 to 400).  ``KeyFrameDatabase``: add, erase and detect
against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.place import database as jdb
from orb_slam3_noted_tpu.place import vocab as jv
from orb_slam3_noted_tpu.place.pretrained import load_default_vocabulary as jax_vocabulary
from orb_slam3_noted_tpu_torch.place import database as tdb
from orb_slam3_noted_tpu_torch.place import vocab as tv
from orb_slam3_noted_tpu_torch.place.pretrained import load_default_vocabulary

CPU = torch.device("cpu")
BOW_ATOL = 1e-6
SCORE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """JAX in float32 as in use; torch on one thread (the test workers run
    side by side)."""
    prev, threads = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", False)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", prev)


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 descriptors as the port's int32 tensors holding the same bits."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def random_desc(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)


def flip_bits(rng, desc, n_flip):
    out = desc.copy()
    for i in range(len(out)):
        for b in rng.choice(256, size=n_flip, replace=False):
            out[i, b // 32] ^= np.uint32(1 << (b % 32))
    return out


@pytest.fixture(scope="module")
def shipped():
    vocab, idf = load_default_vocabulary()
    jvocab, jidf = jax_vocabulary()
    assert vocab is not None and vocab.shape == (32767, 8) and vocab.dtype == np.uint32
    np.testing.assert_array_equal(vocab, jvocab)
    np.testing.assert_array_equal(idf, jidf)
    return vocab, idf


def _compare_transform(vocab, desc, valid):
    wj, dj = (np.asarray(a) for a in jv.transform(jnp.asarray(vocab), jnp.asarray(desc),
                                                   jnp.asarray(valid)))
    wt, dt = tv.transform(_t(vocab), _t(desc), torch.from_numpy(valid))
    np.testing.assert_array_equal(wt.numpy(), wj)
    np.testing.assert_array_equal(dt.numpy(), dj)
    return wt.numpy(), dt.numpy()


def test_transform_shipped_vocabulary(shipped):
    """600 descriptors against 32,767 words: 200 near words (a few bits
    flipped), 200 equal to a word that also appears again later in the bank
    (a tie at distance 0), 200 random; 50 invalid."""
    vocab, _ = shipped
    rng = np.random.default_rng(0)
    vocab = vocab.copy()
    dup = rng.choice(np.arange(16000, dtype=np.int64), size=200, replace=False)
    vocab[dup + 16000] = vocab[dup]  # each of these words twice
    near = flip_bits(rng, vocab[rng.choice(32767, size=200, replace=False)], 6)
    desc = np.concatenate([near, vocab[dup], random_desc(rng, 200)])
    valid = rng.uniform(size=600) > 50 / 600
    word, dist = _compare_transform(vocab, desc, valid)
    tie = valid[200:400]
    np.testing.assert_array_equal(word[200:400][tie], dup[tie])  # the first of the two
    assert (dist[200:400] == 0).all() and (word[~valid] == -1).all()


def test_transform_trained_vocabulary_with_ties():
    """A small bank trained here, every word duplicated once: each
    descriptor's nearest distance is shared by at least two words."""
    rng = np.random.default_rng(1)
    vocab = jv.train_vocabulary(random_desc(rng, 1500), n_words=48, n_iters=3)
    vocab = np.concatenate([vocab, vocab[::-1]])
    desc = np.concatenate([flip_bits(rng, vocab[:40], 3), random_desc(rng, 160)])
    word, _ = _compare_transform(vocab, desc, np.ones(200, bool))
    assert (word < 48).all()


def test_train_vocabulary_same_centroids():
    rng = np.random.default_rng(2)
    desc = random_desc(rng, 1200)
    for seed in (0, 3):
        want = jv.train_vocabulary(desc, n_words=40, n_iters=4, seed=seed)
        got = tv.train_vocabulary(desc, n_words=40, n_iters=4, seed=seed, device=CPU)
        assert got.dtype == np.uint32 and got.shape == (40, 8)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_idf", [False, True])
def test_bow_vector(shipped, with_idf):
    vocab, idf = shipped
    rng = np.random.default_rng(3)
    word = rng.integers(-1, 32767, size=1200).astype(np.int32)
    word[:100] = 17  # a word counted 100 times
    jidf = jnp.asarray(idf) if with_idf else None
    want = np.asarray(jv.bow_vector(jnp.asarray(word), 32767, idf=jidf))
    got = tv.bow_vector(torch.from_numpy(word), 32767,
                        idf=torch.from_numpy(idf) if with_idf else None).numpy()
    np.testing.assert_allclose(got, want, atol=BOW_ATOL, rtol=0)
    assert abs(float(got.sum()) - 1.0) < 1e-5
    a, b = (np.roll(v, 5) for v in (want, got))
    np.testing.assert_allclose(float(tv.l1_score(torch.from_numpy(b), torch.from_numpy(got))),
                               float(jv.l1_score(jnp.asarray(a), jnp.asarray(want))), atol=1e-6)


def database_case(seed, KF=24, W=512):
    """BoW rows of KF keyframes over a W-word bank: rows 3 and 4 equal (a
    tie in every score), the query near row 3's words; covisibility weights
    are integers from a few values (ties in every top-10), symmetric."""
    rng = np.random.default_rng(seed)
    rows = []
    base = rng.integers(0, W, size=150)
    for k in range(KF):
        w = base.copy() if k < 8 else rng.integers(0, W, size=150)
        w[: 10 * k % 150] = rng.integers(0, W, size=10 * k % 150)
        rows.append(np.asarray(jv.bow_vector(jnp.asarray(w.astype(np.int32)), W)))
    bow = np.stack(rows)
    bow[4] = bow[3]
    q_words = base.copy()
    q_words[:20] = rng.integers(0, W, size=20)
    bow_q = np.asarray(jv.bow_vector(jnp.asarray(q_words.astype(np.int32)), W))
    c = rng.choice([0.0, 5.0, 10.0, 300.0], size=(KF, KF))
    covis = np.triu(c, 1) + np.triu(c, 1).T
    present = np.ones(KF, bool)
    present[[7, 20]] = False
    exclude = np.zeros(KF, bool)
    exclude[[1, 11]] = True
    return bow.astype(np.float32), present, bow_q, exclude, covis.astype(np.float32)


def _detect_both(case, n_best, covis=True):
    bow, present, bow_q, exclude, cv = case
    if covis:
        sj, cj = jdb._detect_nbest(jnp.asarray(bow), jnp.asarray(present), jnp.asarray(bow_q),
                                   jnp.asarray(exclude), jnp.asarray(cv), 0.75, n_best)
        st, ct = tdb._detect_nbest(*(torch.from_numpy(a) for a in case), 0.75, n_best)
    else:
        sj, cj = jdb._detect_simple(jnp.asarray(bow), jnp.asarray(present), jnp.asarray(bow_q),
                                    jnp.asarray(exclude), 0.75, n_best)
        st, ct = tdb._detect_simple(*(torch.from_numpy(a) for a in case[:4]), 0.75, n_best)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=SCORE_ATOL, rtol=0)
    return st.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detect_nbest(seed):
    slots = _detect_both(database_case(seed), 3)
    assert (slots >= 0).any()
    assert not set(slots.tolist()) & {1, 7, 11, 20}


@pytest.mark.parametrize("seed", [0, 1])
def test_detect_simple(seed):
    slots = list(_detect_both(database_case(seed), 5, covis=False))
    assert slots[0] >= 0
    # rows 3 and 4 tie: both or neither, the lower index first, as lax.top_k
    assert (3 in slots) == (4 in slots)
    if 3 in slots:
        assert slots.index(3) + 1 == slots.index(4)


def test_common_word_counts_above_256():
    """The 0.8x common-word gate at counts a bf16 product would round:
    the query has 500 words, row 0 shares all 500, row 1 400 (on the gate),
    row 2 399 (just below: bf16 would make it 400).  Only rows 0 and 1 are
    candidates, so with every group a singleton they come back, and row 2
    never does, whatever its score."""
    W, KF = 2048, 4
    q = np.zeros(W, np.float32)
    q[:500] = 1.0 / 500
    bow = np.zeros((KF, W), np.float32)
    for k, n in enumerate((500, 400, 399, 10)):
        bow[k, :n] = 1.0
        bow[k, 1500:1500 + (500 - n)] = 1.0
        bow[k] /= bow[k].sum()
    case = (bow, np.ones(KF, bool), q, np.zeros(KF, bool), np.zeros((KF, KF), np.float32))
    slots = _detect_both(case, 3)
    assert sorted(s for s in slots.tolist() if s >= 0) == [0, 1]


def test_keyframe_database_add_erase_detect(shipped):
    vocab, idf = shipped
    rng = np.random.default_rng(4)
    KF = 12
    jd = jdb.KeyFrameDatabase(vocab, KF, idf=idf)
    td = tdb.KeyFrameDatabase(vocab, KF, idf=idf, device=CPU)
    scenes = [random_desc(rng, 300) for _ in range(8)]
    for s, d in enumerate(scenes):
        valid = np.arange(300) < 280
        _, bj = jd.compute_bow(jnp.asarray(d), jnp.asarray(valid))
        wt, bt = td.compute_bow(_t(d), torch.from_numpy(valid))
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=BOW_ATOL, rtol=0)
        assert (wt.numpy()[280:] == -1).all()
        jd.add(s, bj)
        td.add(s, bt)
    jd.erase(2)
    td.erase(2)
    np.testing.assert_array_equal(td.present, jd.present)
    assert not bool(td.present_dev[2]) and float(td.bow_mat[2].abs().sum()) == 0.0
    q = flip_bits(rng, scenes[5], 8)
    _, bq_j = jd.compute_bow(jnp.asarray(q), jnp.ones(300, bool))
    _, bq_t = td.compute_bow(_t(q), torch.ones(300, dtype=torch.bool))
    covis = rng.choice([0.0, 20.0, 40.0], size=(KF, KF)).astype(np.float32)
    covis = np.triu(covis, 1) + np.triu(covis, 1).T
    for exclude in (np.zeros(KF, bool), np.arange(KF) == 5):
        for cv in (None, covis):
            want = jd.detect_candidates(bq_j, exclude, n_best=3, covis=cv)
            got = td.detect_candidates(bq_t, exclude, n_best=3,
                                       covis=None if cv is None else torch.from_numpy(cv))
            assert got[0] == want[0]
            np.testing.assert_allclose(got[1], want[1], atol=SCORE_ATOL)
            assert (5 in got[0]) == (not exclude[5])
