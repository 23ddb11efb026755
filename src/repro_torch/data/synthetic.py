"""Synthetic data: Zipf-distributed sparse Markov chains and token streams.

The paper's workload model (§II.B): "oftentimes the edges follow a Zipf
distribution".  ``MarkovGraphSampler`` builds a ground-truth random sparse
graph with Zipf edge probabilities and samples transition streams from it —
used by the parity and convergence tests (does MCPrioQ recover the true
edge ranking?).  ``token_stream`` is an LM token stream with learnable
bigram structure, what the n-gram drafter learns from.  numpy only: the
package's own copy of ``repro.data.synthetic.MarkovGraphSampler`` and
``token_stream``, same seeds, same streams.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class MarkovGraphSampler:
    num_nodes: int = 1000
    out_degree: int = 32
    zipf_s: float = 1.5
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.dsts = np.stack([
            rng.choice(self.num_nodes, size=self.out_degree, replace=False)
            for _ in range(self.num_nodes)
        ]).astype(np.int32)
        ranks = np.arange(1, self.out_degree + 1, dtype=np.float64)
        p = ranks ** (-self.zipf_s)
        self.probs = (p / p.sum()).astype(np.float64)
        # each node gets its own permutation of the Zipf weights
        self.perm = np.stack([rng.permutation(self.out_degree)
                              for _ in range(self.num_nodes)])
        self._rng = rng

    def true_probs(self, src: int) -> Tuple[np.ndarray, np.ndarray]:
        """(dsts, probs) in descending probability order for a node."""
        p = self.probs[np.argsort(self.perm[src])]
        order = np.argsort(-p, kind="stable")
        return self.dsts[src][order], p[order]

    def sample_transitions(self, batch: int) -> Tuple[np.ndarray, np.ndarray]:
        """(src[batch], dst[batch]) i.i.d. src, Zipf dst."""
        src = self._rng.integers(0, self.num_nodes, batch).astype(np.int32)
        choice = np.array([
            self._rng.choice(self.out_degree,
                             p=self.probs[np.argsort(self.perm[s])])
            for s in src
        ])
        dst = self.dsts[src, choice].astype(np.int32)
        return src, dst

    def sample_transitions_mixed(self, batch: int, new_frac: float,
                                 new_offset: int = 0
                                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch with a controlled fraction of guaranteed-new edges.

        ``round(new_frac * batch)`` items get dst ids beyond ``num_nodes``
        (so the edge cannot exist in any state warmed on this graph), each
        unique within the batch; the rest are ordinary graph transitions.
        ``new_offset`` shifts the injected id range so successive calls can
        produce disjoint new edges.
        """
        src, dst = self.sample_transitions(batch)
        n_new = int(round(new_frac * batch))
        if n_new:
            idx = self._rng.choice(batch, size=n_new, replace=False)
            dst[idx] = (self.num_nodes + new_offset
                        + np.arange(n_new)).astype(np.int32)
        return src, dst

    def sample_walks(self, batch: int, length: int) -> np.ndarray:
        """Random walks [batch, length] — visit sequences for the
        recommender example / token streams for the drafter."""
        out = np.empty((batch, length), np.int32)
        cur = self._rng.integers(0, self.num_nodes, batch)
        out[:, 0] = cur
        for t in range(1, length):
            nxt = np.empty(batch, np.int64)
            for i, s in enumerate(cur):
                c = self._rng.choice(self.out_degree,
                                     p=self.probs[np.argsort(self.perm[s])])
                nxt[i] = self.dsts[s, c]
            cur = nxt
            out[:, t] = cur
        return out


def token_stream(vocab_size: int, batch: int, seq_len: int, seed: int = 0
                 ) -> Iterator[dict]:
    """LM token stream with learnable bigram structure: a hidden table gives
    each token 4 likely successors, and 20 % of the tokens are uniform
    noise.  Yields ``{"tokens": int32[batch, seq_len], "targets": the same
    shifted by one}``."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab_size, (vocab_size, 4)).astype(np.int32)
    while True:
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab_size, batch)
        for t in range(1, seq_len + 1):
            pick = rng.integers(0, 4, batch)
            follow = succ[toks[:, t - 1], pick]
            noise = rng.integers(0, vocab_size, batch)
            use_noise = rng.random(batch) < 0.2
            toks[:, t] = np.where(use_noise, noise, follow)
        yield {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
        }
