"""The plain reference of the Y statistics' update over one chunk.

A chain's statistics hold its samples recorded so far ``n``, its running
mean ``avg`` and its running lagged products S_k = (1/N_k) sum_i Q_i
Q_{i-k}, where N_k = n - k counts the pairs of lag k, and a ring of its
last k_max samples, newest first, zeros where no sample was recorded yet
(statistics.cc:22-26).  ``record`` adds a block of samples one lag at a
time, by these definitions, in the precision of its inputs.
"""

from __future__ import annotations

import torch


def record(n, avg, ring, S_k, Y):
    """(n, avg [C], ring [C, K], S_k [C, K]) after recording the samples
    ``Y`` [T, C] in order, from the state ``n`` (a whole number), ``avg``,
    ``ring``, ``S_k`` before them."""
    T = Y.shape[0]
    C, K = ring.shape
    n_new = n + T
    avg_new = (n * avg + Y.sum(dim=0)) / n_new
    # hist[:, K - 1 - j] is the sample j before the block (the ring's
    # slot j), hist[:, K + t] the block's sample t
    hist = torch.cat([ring.flip(1), Y.T], dim=1)
    S_new = S_k.clone()
    for k in range(K):
        pairs = n_new - k
        if pairs <= 0:
            continue
        P = (Y.T * hist[:, K - k:K - k + T]).sum(dim=1)
        S_new[:, k] = (max(n - k, 0) * S_k[:, k] + P) / pairs
    ring_new = hist[:, K + T - 1 - torch.arange(K, device=Y.device)]
    return n_new, avg_new, ring_new, S_new
