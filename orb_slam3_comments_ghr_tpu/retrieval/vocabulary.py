"""Binary visual vocabulary: k-ary tree of 256-bit centroids.

JAX replacement for DBoW2::TemplatedVocabulary (reference:
Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h — k=10, L tree built with
binary k-medians, transform() descends by min Hamming, :136-163). Here the
tree is dense arrays (one (nodes, k, 8) uint32 centroid table per level);
`transform` descends ALL descriptors of a frame in parallel (host LUT
popcount, or the jitted `transform_device` descent for on-device use), and
the BoW vector is a dense (n_words,) tf-idf vector (TemplatedVocabulary's
default TF_IDF weighting).

Training is binary k-medians (majority-vote medians, Hamming assignment) on
a descriptor corpus — the same construction as DBoW2's create(); the
reference ships a pre-trained vocabulary file instead (stripped from this
fork), so we train our own on descriptors produced by the actual frontend
(scripts/train_vocab.py) — self-consistent with our rBRIEF pattern.
"""

from __future__ import annotations

import numpy as np

_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,8) x (M,8) -> (N,M) int Hamming via byte-LUT popcount."""
    x = a[:, None, :] ^ b[None, :, :]
    return _POPCNT8[x.view(np.uint8).reshape(x.shape[0], x.shape[1], 32)].sum(
        -1, dtype=np.int32
    )


def _majority(descs: np.ndarray) -> np.ndarray:
    """Bitwise majority vote (FORB::meanValue, DBoW2/FORB.cpp:40)."""
    bits = np.unpackbits(descs.view(np.uint8), axis=1)  # (N, 256)
    maj = (bits.sum(0) * 2 >= len(descs)).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmedians(descs: np.ndarray, k: int, rng, iters: int = 8):
    """Binary k-medians; returns (k, 8) centroids."""
    n = len(descs)
    if n <= k:
        out = np.zeros((k, 8), np.uint32)
        out[:n] = descs
        if n:
            out[n:] = descs[rng.integers(0, n, k - n)]
        return out
    cent = descs[rng.choice(n, k, replace=False)]
    for _ in range(iters):
        d = _hamming_np(descs, cent)
        assign = d.argmin(1)
        for j in range(k):
            sel = descs[assign == j]
            if len(sel):
                cent[j] = _majority(sel)
            else:
                cent[j] = descs[rng.integers(0, n)]
    return cent


class Vocabulary:
    """levels: list of (n_nodes_l, k, 8) uint32 arrays; words = k**L leaves.
    idf: (n_words,) per-word inverse document frequency (DBoW2 TF_IDF
    weighting, TemplatedVocabulary::setNodeWeights) — ones when trained
    without image grouping."""

    def __init__(self, levels: list[np.ndarray], k: int,
                 idf: np.ndarray | None = None):
        self.levels = levels
        self.k = k
        self.L = len(levels)
        self.n_words = k ** self.L
        self.idf = (np.ones(self.n_words, np.float32)
                    if idf is None else idf.astype(np.float32))
        self._device_tables = None
        self._transform_jit = None

    # ------------------------------------------------------------- training
    @staticmethod
    def train(descs: np.ndarray, k: int = 10, L: int = 3, seed: int = 0,
              image_ids: np.ndarray | None = None) -> "Vocabulary":
        """Build the tree level-by-level; when `image_ids` labels each corpus
        descriptor with its source image, per-word idf = log(N_images /
        N_images_containing_word) is computed from the corpus
        (TemplatedVocabulary::setNodeWeights semantics)."""
        rng = np.random.default_rng(seed)
        levels = []
        assign = np.zeros(len(descs), np.int64)
        n_nodes = 1
        for lvl in range(L):
            cents = np.zeros((n_nodes, k, 8), np.uint32)
            new_assign = np.zeros_like(assign)
            for node in range(n_nodes):
                sel = np.nonzero(assign == node)[0]
                sub = descs[sel] if len(sel) else descs[rng.integers(0, len(descs), k)]
                cents[node] = _kmedians(sub, k, rng)
                if len(sel):
                    d = _hamming_np(descs[sel], cents[node])
                    new_assign[sel] = node * k + d.argmin(1)
            levels.append(cents)
            assign = new_assign
            n_nodes *= k
        idf = None
        if image_ids is not None:
            image_ids = np.asarray(image_ids)
            n_img = len(np.unique(image_ids))
            # count images containing each word
            pair = np.unique(np.stack([assign, image_ids]), axis=1)
            ni = np.bincount(pair[0], minlength=k ** L).astype(np.float64)
            idf = np.log(n_img / np.maximum(ni, 1.0)).astype(np.float32)
            idf[ni == 0] = float(np.log(n_img))  # unseen words: max weight
        return Vocabulary(levels, k, idf)

    @staticmethod
    def random(k: int = 10, L: int = 3, seed: int = 0, n_train: int = 20000) -> "Vocabulary":
        """Train on uniform random descriptors — a serviceable covering of
        Hamming space when no corpus is available."""
        rng = np.random.default_rng(seed)
        descs = rng.integers(0, 2**32, (n_train, 8), dtype=np.uint32)
        return Vocabulary.train(descs, k, L, seed)

    # ----------------------------------------------------------- persistence
    def save(self, path: str):
        np.savez_compressed(
            path, k=self.k, L=self.L, idf=self.idf,
            **{f"level_{i}": lv for i, lv in enumerate(self.levels)},
        )

    @staticmethod
    def load(path: str) -> "Vocabulary":
        z = np.load(path)
        L = int(z["L"])
        idf = z["idf"] if "idf" in z.files else None
        return Vocabulary([z[f"level_{i}"] for i in range(L)], int(z["k"]), idf)

    # ------------------------------------------------------------ transform
    @property
    def mid_level(self) -> int:
        """Loop index whose update yields the ~`k^2`-node grouping used for
        BoW-guided matching — the reference's FeatureVector at nid_level
        (~100 groups for the stock ORB vocabulary; Frame.cc:995-1010)."""
        return min(1, self.L - 1)

    def transform(self, descs: np.ndarray, valid: np.ndarray):
        """Descend the tree for all descriptors at once (host numpy).

        Returns (word_id (N,), node_id (N,) mid-level node for BoW-guided
        matching)."""
        n = len(descs)
        node = np.zeros(n, np.int64)
        mid = np.zeros(n, np.int64)
        for lvl in range(self.L):
            cents = self.levels[lvl][node]          # (N, k, 8)
            x = (descs[:, None, :] ^ cents).view(np.uint8)
            d = _POPCNT8[x.reshape(n, self.k, 32)].sum(-1, dtype=np.int32)
            node = node * self.k + d.argmin(1)
            if lvl == self.mid_level:
                mid = node.copy()
        word = np.where(valid, node, -1)
        mid = np.where(valid, mid, -1)
        return word, mid

    def transform_device(self, descs, valid):
        """Jitted on-device tree descent: per level one gathered XOR-popcount
        argmin over the k children (SURVEY §2.2: batched descent as device
        ops). Inputs are (N,8) uint32 / (N,) bool device arrays; returns
        (word, mid) int32 device arrays."""
        import jax.numpy as jnp
        from ..ops.matching import popcount_rows
        if self._device_tables is None:
            self._device_tables = [jnp.asarray(lv) for lv in self.levels]
        node = jnp.zeros(descs.shape[0], jnp.int32)
        mid = jnp.zeros(descs.shape[0], jnp.int32)
        for lvl in range(self.L):
            cents = self._device_tables[lvl][node]          # (N, k, 8)
            d = popcount_rows(descs[:, None, :] ^ cents)    # (N, k)
            node = node * self.k + jnp.argmin(d, axis=1).astype(jnp.int32)
            if lvl == self.mid_level:
                mid = node
        word = jnp.where(valid, node, -1)
        mid = jnp.where(valid, mid, -1)
        return word, mid

    def transform_on_device(self, descs, valid):
        """PRODUCTION descent: one jitted device program (tree tables are
        compile-time constants riding HBM), one host fetch. Used by
        KeyFrameDatabase.add, relocalization and the track-reference-KF
        fallback — no host-NumPy descent on any pipeline path; the host
        `transform` remains for offline tooling (training, tests)."""
        import jax
        import jax.numpy as jnp

        if self._transform_jit is None:
            self._transform_jit = jax.jit(self.transform_device)
        w, m = self._transform_jit(jnp.asarray(descs), jnp.asarray(valid))
        w, m = jax.device_get((w, m))
        return np.asarray(w).astype(np.int64), np.asarray(m).astype(np.int64)

    def bow_vector(self, word_id: np.ndarray) -> np.ndarray:
        """L1-normalized dense tf-idf vector (n_words,) float32 (DBoW2
        TF_IDF + L1 norm, the stock ORB-vocabulary configuration)."""
        v = np.zeros(self.n_words, np.float32)
        w = word_id[word_id >= 0]
        np.add.at(v, w, 1.0)
        v *= self.idf
        s = v.sum()
        return v / s if s > 0 else v


def score_l1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """DBoW2 L1 score for L1-normalized vectors: s = sum_i min(a_i, b_i)
    (equivalent to 1 - 0.5|a-b|_1; ScoringObject.cpp L1Scoring). Broadcasts
    b over leading axes."""
    return np.minimum(a, b).sum(-1)


def score_l2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """DBoW2 L2 score: 1 - 0.5*|a/|a| - b/|b||_2 ~ dot for unit vectors
    (ScoringObject.cpp L2Scoring)."""
    an = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    bn = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return (an * bn).sum(-1)


def score_bhattacharyya(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """DBoW2 Bhattacharyya coefficient: sum_i sqrt(a_i b_i)."""
    return np.sqrt(np.maximum(a * b, 0.0)).sum(-1)


def score_dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """DBoW2 dot-product scoring."""
    return (a * b).sum(-1)


SCORING = {
    "l1": score_l1,
    "l2": score_l2,
    "bhattacharyya": score_bhattacharyya,
    "dot": score_dot,
}
