"""Token sampling and a simple autoregressive generation loop: the port of
``repro.models.sampling``. Random draws come from a ``torch.Generator``
(they are not the reference's ``jax.random`` draws; greedy decoding is
equal in both)."""
from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def sample_token(logits, gen=None, temperature: float = 0.0,
                 top_k: int = 0):
    """logits: [B, V] -> tokens [B] (int32)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def generate(params, prompt, cfg: ModelConfig, max_new_tokens: int,
             cache_width: int = 0, temperature: float = 0.0, gen=None):
    """Greedy/temperature generation; returns [B, max_new_tokens]: the
    prefill's token, then one decode step per further token."""
    b, s = prompt.shape
    width = cache_width or (s + max_new_tokens)
    logits, cache = transformer.prefill(params, prompt, cfg, width)
    tok = sample_token(logits, gen, temperature)
    out = [tok]
    for i in range(max_new_tokens - 1):
        logits, cache = transformer.decode_step(params, tok[:, None], s + i,
                                                cache, cfg)
        tok = sample_token(logits, gen, temperature)
        out.append(tok)
    return torch.stack(out, dim=1)
