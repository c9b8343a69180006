"""Beam ranking shared by the decoders (counterpart of
``chainermn_tpu/models/_decode_common.py``): one owner for the GNMT
length-penalty formula."""

from __future__ import annotations

import torch


def gnmt_ranking(scores, gen_len, alpha: float):
    """GNMT length-penalised ranking values ``score / ((5 + len) / 6) **
    alpha``: positive ``alpha`` counters the short-hypothesis bias of
    summed log-probabilities, negative favours short ones, 0 is the raw
    score."""
    return scores / ((5.0 + gen_len.float()) / 6.0) ** alpha


def rank_beams(seqs, scores, gen_len, alpha: float):
    """``(seqs [B, K, T], scores [B, K])`` ordered best-first under the
    penalised ranking (a stable sort: equal values keep their beam
    order, as ``jnp.argsort`` does); the returned scores stay raw."""
    order = torch.argsort(-gnmt_ranking(scores, gen_len, alpha), dim=1,
                          stable=True)
    return (torch.gather(seqs, 1, order[..., None].expand_as(seqs)),
            torch.gather(scores, 1, order))


__all__ = ["gnmt_ranking", "rank_beams"]
