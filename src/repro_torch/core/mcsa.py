"""Algorithm 2 — MCSA (Multiple-Choice Secretary Algorithm), "peak".

A numpy copy of `repro.core.mcsa.mcsa_topk`, the faithful port of the
paper's recursive pseudocode: k>1 splits the range at a Binomial(len, 1/2)
point and recurses (floor(k/2) left, k-floor(k/2) right); k==1 runs the
classic 1/e rule (observe floor(len/e), then take the first element
beating the observed max, falling back to the last observed max).  It
draws from the controller's numpy generator in the same order as the JAX
package, so both control planes lease the same slots.

`secretary_1e_stream` is the single-choice rule over a tensor of scores
(JAX's scan form), `topk_oracle` the offline optimum that the
competitive-ratio tests hold MCSA against.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch


def _one_choice(score: np.ndarray, L: int, R: int,
                picked: List[int]) -> None:
    """Classic 1/e-rule on score[L..R] inclusive (paper lines 7-25)."""
    ln = R - L + 1
    if ln <= 0:
        return
    n = int(ln / math.e)
    mx = score[L]
    mx_idx = L
    for i in range(L, L + n):                       # observation phase
        if score[i] > mx:
            mx, mx_idx = score[i], i
    for i in range(L + n, R + 1):                   # selection phase
        if score[i] > mx:
            picked.append(i)
            return
    picked.append(mx_idx)                           # fallback: observed max


def mcsa_topk(score: np.ndarray, k: int,
              rng: Optional[np.random.Generator] = None) -> List[int]:
    """Select (approximately top-)k indices from a streamed score array."""
    rng = rng or np.random.default_rng(0)
    score = np.asarray(score, dtype=float)
    picked: List[int] = []

    def rec(k: int, L: int, R: int) -> None:
        if R < L or k <= 0:
            return
        if k == 1:
            _one_choice(score, L, R, picked)
            return
        m = int(rng.binomial(R - L + 1, 0.5))       # line 4
        m = min(max(m, 1), R - L)                   # keep both halves nonempty
        rec(k // 2, L, L + m - 1)                   # line 5
        rec(k - k // 2, L + m, R)                   # line 6

    rec(k, 0, len(score) - 1)
    # dedupe while preserving order (the fallback may duplicate when
    # ranges degenerate)
    seen, out = set(), []
    for i in picked:
        if i not in seen:
            seen.add(i)
            out.append(i)
    return out[:k]


def secretary_1e_stream(scores) -> torch.Tensor:
    """Single-choice secretary over a score stream (the 1/e rule), as
    JAX's scan computes it in float32: observe the first max(n/e, 1),
    take the first later score beating their strict running max (a NaN
    never beats), else the observed max's first index (0 when no
    observed score is above -inf).  Returns the index, int32."""
    s = torch.as_tensor(scores).to(torch.float32)
    n_obs = max(int(s.shape[0] / math.e), 1)
    obs = s[:n_obs]
    obs = torch.where(obs.isnan(), -math.inf, obs)
    best = obs.max()
    hit = (obs == best) & (obs > -math.inf)
    best_idx = torch.where(hit.any(), hit.int().argmax(), 0)
    later = s[n_obs:] > best
    if not later.numel():
        return best_idx.to(torch.int32)
    return torch.where(later.any(), n_obs + later.int().argmax(),
                       best_idx).to(torch.int32)


def topk_oracle(score, k: int) -> List[int]:
    """Offline optimum (for competitive-ratio tests): numpy's argsort of
    the scores, reversed, as JAX's, so ties fall the same way."""
    if isinstance(score, torch.Tensor):
        score = score.detach().cpu().numpy()
    return list(np.argsort(score)[::-1][:k])
