"""Keyframe database (port of :mod:`orb_slam3_noted_tpu.place.database`).

The word -> keyframe inverted file of the reference is a dense (KF_CAP, W)
matrix of BoW vectors on the facade's device.  A query is scored against
every stored keyframe at once, and the candidate policy
(``DetectNBestCandidates``: common-word gate, L1 score, accumulation over
covisibility groups, best N) runs on the device; only the <= ``n_best``
winning slots and scores come back to the host, in one copy.

Counts are float32 products of 0/1 matrices: exact below 2^24 with TF32 off
(the JAX package multiplies bf16 operands into float32; a bf16 product here
would round counts above 256).  Ties break as in XLA: the first extremum for
argmax, lowest index first for top-k (:func:`..ops.fast.topk_stable`).
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.ops.fast import topk_stable
from orb_slam3_noted_tpu_torch.place import vocab as V
from orb_slam3_noted_tpu_torch.utils.interop import set_scalar

NEG = -1e30


def _scores(bow_mat, alive, bow_q):
    """L1 scores of every row against the query, -1 where not alive."""
    scores = 1.0 - 0.5 * torch.sum(torch.abs(bow_mat - bow_q[None, :]), dim=-1)
    return torch.where(alive, scores, -1.0)


def _detect_nbest(bow_mat, present, bow_q, exclude, covis, min_rel_score: float, n_best: int):
    """The full ``DetectNBestCandidates`` policy on the device.

    1. common-word count against the query; candidates need 0.8x the max;
    2. L1 BoW score for the survivors;
    3. scores accumulated over each candidate's top-10 covisibility group;
    4. the best member of each of the ``n_best`` top groups (deduplicated).

    Returns (slots (n_best,) int32, -1 = none; scores (n_best,) float32).
    """
    KF = bow_mat.shape[0]
    dev = bow_mat.device
    alive = present & ~exclude
    scores = _scores(bow_mat, alive, bow_q)

    common = (bow_mat > 0).to(torch.float32) @ (bow_q > 0).to(torch.float32)
    common = torch.where(alive, common, 0.0)
    max_common = torch.amax(common)
    cand = alive & (common >= 0.8 * max_common) & (scores > 0) & (max_common >= 1)
    cand_scores = torch.where(cand, scores, 0.0)

    # top-10 covisibility group per row, itself included; a row's (row, col)
    # pairs are distinct, so a plain assignment is the reference's max-scatter
    eye = torch.eye(KF, dtype=torch.bool, device=dev)
    cv = torch.where(eye, 0.0, covis)
    top_v, top_i = topk_stable(cv, min(10, KF))
    rows = torch.arange(KF, device=dev)[:, None].expand_as(top_i)
    group = torch.zeros((KF, KF), dtype=torch.bool, device=dev)
    group[rows, top_i] = top_v > 0
    group = group | eye

    acc = group.to(torch.float32) @ cand_scores
    acc = torch.where(cand, acc, NEG)
    best_acc = torch.amax(acc)

    out_slots, out_scores = [], []
    acc_m = acc
    taken = torch.zeros(KF, dtype=torch.bool, device=dev)
    cols = torch.arange(KF, device=dev)
    for _ in range(n_best):
        g = torch.argmax(acc_m)  # the first maximum, as jnp.argmax
        members = torch.where(group[g] & ~taken, cand_scores, -1.0)
        s = torch.argmax(members)
        ok = (acc_m[g] > 0) & (acc_m[g] >= min_rel_score * best_acc) & (members[s] > 0)
        out_slots.append(torch.where(ok, s.to(torch.int32), -1))
        out_scores.append(torch.where(ok, members[s], -1.0))
        acc_m = torch.where(cols == g, NEG, acc_m)
        taken = taken | ((cols == s) & ok)
    return torch.stack(out_slots), torch.stack(out_scores)


def _detect_simple(bow_mat, present, bow_q, exclude, min_rel_score: float, n_best: int):
    """Best-score policy without group accumulation (no covisibility)."""
    scores = _scores(bow_mat, present & ~exclude, bow_q)
    top_s, top_i = topk_stable(scores, n_best)
    ok = (top_s > 0) & (top_s >= min_rel_score * top_s[0])
    return torch.where(ok, top_i.to(torch.int32), -1), torch.where(ok, top_s, -1.0)


class KeyFrameDatabase:
    """The (KF, W) BoW matrix on ``device`` (the card unless the caller names
    another), with a host mirror of which rows are present."""

    def __init__(self, vocab: np.ndarray, max_keyframes: int, idf: np.ndarray | None = None,
                 device=None):
        self.device = torch.device("cuda" if device is None else device)
        self.vocab = torch.from_numpy(np.ascontiguousarray(vocab, np.uint32).view(np.int32)).to(
            self.device)
        self.n_words = vocab.shape[0]
        self.bow_mat = torch.zeros((max_keyframes, self.n_words), dtype=torch.float32,
                                   device=self.device)
        self.present = np.zeros(max_keyframes, bool)
        self.present_dev = torch.zeros(max_keyframes, dtype=torch.bool, device=self.device)
        # idf word weights (DBoW2 keeps them in the vocabulary file)
        self.idf = (torch.from_numpy(np.asarray(idf, np.float32)).to(self.device)
                    if idf is not None else None)

    def compute_bow(self, desc: torch.Tensor, valid: torch.Tensor):
        """(words (N,), bow (W,)) of one frame's descriptors."""
        word, _ = V.transform(self.vocab, desc, valid)
        return word, V.bow_vector(word, self.n_words, idf=self.idf)

    def add(self, slot: int, bow: torch.Tensor):
        """Register or overwrite keyframe ``slot`` (reference ``add``)."""
        self.bow_mat[slot] = bow
        self.present[slot] = True
        set_scalar(self.present_dev, slot, True)

    def erase(self, slot: int):
        self.bow_mat[slot] = 0.0
        self.present[slot] = False
        set_scalar(self.present_dev, slot, False)

    def detect_candidates(self, bow_q: torch.Tensor, exclude_mask, n_best: int = 3,
                          min_rel_score: float = 0.75, covis: torch.Tensor | None = None):
        """Best-scoring non-excluded keyframes (loop, merge or relocalisation
        candidates).  With ``covis``, a (KF, KF) covisibility-weight matrix,
        the full ``DetectNBestCandidates`` policy runs, without it the best
        scores alone.  ``exclude_mask``: (KF,) bool, a tensor on the device
        or host values.  Returns (slots, scores) lists, possibly shorter
        than ``n_best``."""
        exclude = torch.as_tensor(exclude_mask, dtype=torch.bool).to(self.device)
        if covis is None:
            slots, scores = _detect_simple(self.bow_mat, self.present_dev, bow_q, exclude,
                                           float(min_rel_score), n_best)
        else:
            slots, scores = _detect_nbest(self.bow_mat, self.present_dev, bow_q, exclude,
                                          torch.as_tensor(covis, dtype=torch.float32,
                                                          device=self.device),
                                          float(min_rel_score), n_best)
        # one copy: slots are small integers, exact in float32
        both = torch.stack([slots.to(torch.float32), scores]).cpu().numpy()
        keep = both[0] >= 0
        return [int(s) for s in both[0][keep]], [float(s) for s in both[1][keep]]
