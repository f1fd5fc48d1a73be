"""Word2Vec — skip-gram with hierarchical softmax.

Reference: h2o3_tpu/models/word2vec.py (hex/word2vec/Word2Vec.java,
WordVectorTrainer.java, HBWTree.java). The input is one column of
words, sentences delimited by NA rows; the vocabulary keeps the words
seen ``min_word_freq`` times, frequent words are subsampled
(``sent_sample_rate``), every (center, context) pair within
``window_size`` trains one step of a mini-batch, and the learning rate
decays linearly.

The corpus is prepared on the host as the reference prepares it, with
numpy index arithmetic in place of its per-token loops: the vocabulary
(``np.unique``), the subsampling (one ``RandomState.rand`` draw for the
tokens whose keep probability is below 1, which are the reference's
draws in its order), the pairs in the reference's order, the Huffman
tree (``heapq``, the reference's EXACTLY), and a ``rng.permutation`` of
the pairs an epoch. So the batches are the reference's. The pairs and
the tree live on the device; a step (``_sgd_step``) gathers its rows,
forms the gradient in closed form and adds it into dense gradients of
W_in and W_out in an order that is the same on every run
(``_row_sums``), then takes the step. The loop is paced by the host: a
step is ~35 launches.

``W_in`` starts from ``draw_init_W_in`` (a ``torch.Generator`` seeded
like the reference's key; the tests feed the reference's draw in).

Not ported: a partitioned frame (ROADMAP A #12′). Its MOJO, native and
in the reference's layout, is ``Model.download_mojo``'s.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame, raw_columns
from h2o3_tpu_torch.models.model import Model, ModelBuilder, require_local


def _build_huffman(counts: np.ndarray):
    """Huffman tree over word counts: [V, Lmax] int32 points (internal
    node ids), [V, Lmax] int8 codes and [V, Lmax] bool path masks."""
    V = len(counts)
    heap = [(int(c), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent = np.zeros(2 * V - 1, dtype=np.int64)
    binary = np.zeros(2 * V - 1, dtype=np.int8)
    nxt = V
    while len(heap) > 1:
        c1, i1 = heapq.heappop(heap)
        c2, i2 = heapq.heappop(heap)
        parent[i1] = nxt
        parent[i2] = nxt
        binary[i2] = 1
        heapq.heappush(heap, (c1 + c2, nxt))
        nxt += 1
    root = nxt - 1
    paths, codes = [], []
    for wi in range(V):
        pt, cd = [], []
        node = wi
        while node != root:
            pt.append(parent[node] - V)   # internal node id in [0, V-1)
            cd.append(binary[node])
            node = parent[node]
        paths.append(pt[::-1])
        codes.append(cd[::-1])
    Lmax = max((len(p) for p in paths), default=1)
    P = np.zeros((V, Lmax), dtype=np.int32)
    C = np.zeros((V, Lmax), dtype=np.int8)
    M = np.zeros((V, Lmax), dtype=bool)
    for i, (pt, cd) in enumerate(zip(paths, codes)):
        P[i, : len(pt)] = pt
        C[i, : len(cd)] = cd
        M[i, : len(pt)] = True
    return P, C, M


def corpus(words: np.ndarray, p: dict, rng: np.random.RandomState):
    """The host half of a fit: (vocabulary, its counts, centers,
    contexts). ``rng`` draws the subsampling."""
    is_tok = np.fromiter((isinstance(w, str) for w in words), bool,
                         len(words))
    toks = words[is_tok]
    uniq, inv, counts = np.unique(toks.astype(object), return_inverse=True,
                                  return_counts=True)
    keep = counts >= int(p["min_word_freq"])
    vocab = [str(u) for u in uniq[keep]]
    vcount = counts[keep].astype(np.int64)
    if len(vocab) < 2:
        raise ValueError("word2vec needs >= 2 vocabulary words "
                         "(after min_word_freq)")
    ids = (np.cumsum(keep) - 1)[inv]
    ids[~keep[inv]] = -1
    sent = np.cumsum(~is_tok)[is_tok]       # NA rows end sentences
    ids, sent = ids[ids >= 0], sent[ids >= 0]
    samp = float(p["sent_sample_rate"])
    freq = vcount / vcount.sum()
    kp = (np.minimum(1.0, (np.sqrt(freq / samp) + 1) * samp / freq)
          if samp > 0 else np.ones_like(freq))[ids]
    kept = kp >= 1.0
    draw = ~kept
    kept[draw] = rng.rand(int(draw.sum())) < kp[draw]
    ids, sent = ids[kept], sent[kept]
    # pairs: each center with the window around it inside its sentence,
    # centers in order and their contexts left to right
    win = int(p["window_size"])
    n = len(ids)
    first = np.r_[True, sent[1:] != sent[:-1]] if n else np.zeros(0, bool)
    starts = np.flatnonzero(first)
    ends = np.r_[starts[1:], n]
    s_of = np.repeat(starts, ends - starts)
    e_of = np.repeat(ends, ends - starts)
    offs = np.r_[np.arange(-win, 0), np.arange(1, win + 1)]
    pos = np.repeat(np.arange(n), len(offs))
    j = pos + np.tile(offs, n)
    ok = (j >= s_of[pos]) & (j < e_of[pos])
    centers = ids[pos[ok]].astype(np.int32)
    contexts = ids[j[ok]].astype(np.int32)
    return vocab, vcount, centers, contexts


def draw_init_W_in(V: int, D: int, seed: int) -> torch.Tensor:
    """W_in's initial draw on the CPU: U(-0.5, 0.5) / D."""
    g = torch.Generator().manual_seed(abs(int(seed)) or 7)
    return (torch.rand((V, D), generator=g) - 0.5) / D


def _sgd_step(W_in, W_out, centers, points, codes, mask, lr: float):
    """One skip-gram hierarchical-softmax step, in place: the batch's
    mean loss (on the device)."""
    B = centers.shape[0]
    v = W_in[centers]                                   # [B, D]
    u = W_out[points]                                   # [B, L, D]
    dots = torch.einsum("bd,bld->bl", v, u)
    sgn = 1.0 - 2.0 * codes          # code 0: target 1, code 1: target 0
    z = sgn * dots
    loss = -torch.where(mask, torch.nn.functional.logsigmoid(z),
                        0.0).sum() / B
    gd = torch.where(mask, -sgn * torch.sigmoid(-z), 0.0) / B
    g_in = _row_sums(W_in, centers, torch.einsum("bl,bld->bd", gd, u))
    g_out = _row_sums(W_out, points.reshape(-1), (
        gd[:, :, None] * v[:, None, :]).reshape(-1, v.shape[1]))
    W_in.sub_(lr * g_in)
    W_out.sub_(lr * g_out)
    return loss


def _row_sums(like, idx, vals):
    """A zero tensor like ``like`` with the rows of ``vals`` added at
    ``idx``, in an order that is the same on every run: on the card
    ``index_put_(accumulate=True)`` sorts the indices and adds each
    index's rows in turn; on the CPU ``index_add_`` adds row by row."""
    out = torch.zeros_like(like)
    if out.device.type == "cuda":
        return out.index_put_((idx,), vals, accumulate=True)
    return out.index_add_(0, idx, vals)


class Word2VecModel(Model):
    algo = "word2vec"

    def __init__(self, params, output, vectors: np.ndarray,
                 vocab: List[str], device=None):
        super().__init__(params, output)
        self.vectors = vectors       # [V, D] float32
        self.vocab = vocab
        self.device = device
        self._index = {w: i for i, w in enumerate(vocab)}

    def find_synonyms(self, word: str, count: int = 20) -> Dict[str, float]:
        """Cosine-similarity neighbours (Word2VecModel.findSynonyms)."""
        if word not in self._index:
            return {}
        v = self.vectors[self._index[word]]
        norms = np.linalg.norm(self.vectors, axis=1) * \
            max(np.linalg.norm(v), 1e-12)
        sims = self.vectors @ v / np.maximum(norms, 1e-12)
        out = {}
        for i in np.argsort(-sims):
            if self.vocab[i] == word:
                continue
            out[self.vocab[i]] = float(sims[i])
            if len(out) >= count:
                break
        return out

    def transform(self, frame: Frame, aggregate_method: str = "NONE") -> Frame:
        """Embed a words column: NONE → a vector row a word (NaN for a
        word out of the vocabulary); AVERAGE → the mean vector of each
        NA-delimited sequence."""
        words = raw_columns(frame, [frame.names[0]])[frame.names[0]]
        D = self.vectors.shape[1]
        if aggregate_method.upper() == "NONE":
            out = np.full((len(words), D), np.nan, dtype=np.float32)
            j = np.array([self._index.get(w, -1) if isinstance(w, str)
                          else -1 for w in words], np.int64)
            out[j >= 0] = self.vectors[j[j >= 0]]
        else:  # AVERAGE
            rows, acc, cnt = [], np.zeros(D, np.float32), 0
            seen_tokens = False
            for w in words:
                if w is None or (isinstance(w, float) and np.isnan(w)):
                    rows.append(acc / cnt if cnt else np.full(D, np.nan))
                    acc, cnt, seen_tokens = np.zeros(D, np.float32), 0, False
                    continue
                seen_tokens = True
                j = self._index.get(w)
                if j is not None:
                    acc = acc + self.vectors[j]
                    cnt += 1
            if seen_tokens:   # flush only an unterminated trailing sentence
                rows.append(acc / cnt if cnt else np.full(D, np.nan))
            out = np.stack(rows)
        return Frame.from_numpy({f"C{i + 1}": out[:, i] for i in range(D)},
                                device=frame.device)

    def to_frame(self, device=None) -> Frame:
        """Word → vector frame (Word2VecModel.toFrame), on ``device`` (the
        training frame's by default)."""
        cols = {"Word": np.asarray(self.vocab, dtype=object)}
        for i in range(self.vectors.shape[1]):
            cols[f"V{i + 1}"] = self.vectors[:, i]
        return Frame.from_numpy(cols, categorical=["Word"],
                                device=device or self.device)

    def _score_raw(self, frame: Frame):
        raise NotImplementedError("use transform()/find_synonyms()")

    def model_performance(self, frame: Frame, mask_weights=None):
        return None


class Word2VecEstimator(ModelBuilder):
    """h2o-py H2OWord2vecEstimator surface."""

    algo = "word2vec"
    label = "Word2Vec"

    DEFAULTS = dict(
        vec_size=100, window_size=5, sent_sample_rate=1e-3, epochs=5,
        min_word_freq=5, init_learning_rate=0.025, seed=-1,
        batch_size=64, ignored_columns=None,
    )
    PORTED = frozenset(DEFAULTS)

    def resolve_x(self, frame, x, y):
        return list(frame.names)   # the words column is the input

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        require_local(frame, self.label)
        p = self.params
        dev = frame.device
        words = raw_columns(frame, [frame.names[0]])[frame.names[0]]
        rng = np.random.RandomState(int(p["seed"]) if int(p["seed"]) >= 0
                                    else 0xABCD)
        vocab, vcount, centers, contexts = corpus(words, p, rng)
        if not len(centers):
            raise ValueError("no training pairs (sentences too short?)")
        P, C, M = _build_huffman(vcount)
        V, D = len(vocab), int(p["vec_size"])
        W_in = draw_init_W_in(V, D, int(p["seed"])).to(
            dev, torch.float32).contiguous()
        W_out = torch.zeros((max(V - 1, 1), D), dtype=torch.float32,
                            device=dev)
        P_d = torch.from_numpy(P.astype(np.int64)).to(dev)
        C_d = torch.from_numpy(C.astype(np.float32)).to(dev)
        M_d = torch.from_numpy(M).to(dev)
        cen_d = torch.from_numpy(centers.astype(np.int64)).to(dev)
        ctx_d = torch.from_numpy(contexts.astype(np.int64)).to(dev)

        B = int(p["batch_size"])
        lr0 = float(p["init_learning_rate"])
        epochs = int(p["epochs"])
        n_pairs = len(centers)
        steps_total = max(epochs * ((n_pairs + B - 1) // B), 1)
        step = 0
        loss_hist = []
        for _ in range(epochs):
            perm = torch.from_numpy(rng.permutation(n_pairs)).to(dev)
            for s in range(0, n_pairs, B):
                idx = perm[s:s + B]
                if idx.shape[0] < B:    # the last batch wraps around
                    idx = torch.cat([idx, perm[:B - idx.shape[0]]])
                ctx = ctx_d[idx]
                loss = _sgd_step(W_in, W_out, cen_d[idx], P_d[ctx], C_d[ctx],
                                 M_d[ctx],
                                 lr0 * max(1.0 - step / steps_total, 1e-4))
                step += 1
            loss_hist.append(float(loss))

        output = {"category": "WordEmbedding", "response": None,
                  "names": list(frame.names), "domain": None,
                  "vocab_size": V, "vec_size": D,
                  "epoch_loss": loss_hist, "pairs": n_pairs, "steps": step}
        return Word2VecModel(p, output, W_in.cpu().numpy(), vocab, device=dev)
