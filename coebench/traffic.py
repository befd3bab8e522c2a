"""The one traffic generator: closed-loop rounds, read from a mix file.

A mix file (``coebench/mixes/<name>.json``) gives ``round_size`` requests a
round, the ``domains`` they go to (a list, or ``"all"`` for every domain of
the configuration), ``prompt_tokens`` random token ids a prompt, and with
``balanced`` true every domain the same count in each round (the remainder
to the first domains), in a shuffled order, so that every seed brings the
same work in another order. ``check_fraction`` of the requests are marked
for the comparison with the reference. Stream 0 is the warm round's, stream
1 the measured rounds'.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), stream])


def round_domains(mix: dict, domains: Sequence[str],
                  rng: np.random.Generator) -> List[str]:
    n = mix["round_size"]
    pool = list(domains) if mix["domains"] == "all" else list(mix["domains"])
    unknown = set(pool) - set(domains)
    if unknown:
        raise ValueError(f"mix {mix['name']!r} names domains "
                         f"{sorted(unknown)} the configuration lacks")
    if mix.get("balanced", False):
        out = [pool[i % len(pool)] for i in range(n)]
        rng.shuffle(out)
        return out
    return [pool[i] for i in rng.integers(0, len(pool), n)]


def rounds(mix: dict, domains: Sequence[str], vocab: int, seed: int,
           stream: int) -> Iterator[List[dict]]:
    """Endless rounds, each a list of ``{"domain", "tokens", "check"}``:
    ``tokens`` an int32 array of ``mix["prompt_tokens"]`` ids in
    [0, vocab)."""
    rng = _rng(seed, stream)
    s = mix["prompt_tokens"]
    while True:
        doms = round_domains(mix, domains, rng)
        tokens = rng.integers(0, vocab, (len(doms), s), dtype=np.int32)
        check = rng.random(len(doms)) < mix["check_fraction"]
        yield [{"domain": d, "tokens": tokens[i], "check": bool(check[i])}
               for i, d in enumerate(doms)]


def pick(candidates: Sequence[int], k: int, seed: int) -> List[int]:
    """``k`` of ``candidates`` (or all of them), drawn from the seed."""
    cands = sorted(candidates)
    if len(cands) <= k:
        return cands
    idx = _rng(seed, 2).choice(len(cands), k, replace=False)
    return sorted(cands[i] for i in idx)
