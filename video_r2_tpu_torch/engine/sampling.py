"""Token sampling: greedy / temperature / top-k / top-p.

Port of ``video_r2_tpu/engine/sampling.py`` (HF order: temperature scale ->
top-k filter -> top-p filter -> sample). Random draws come from a caller's
``torch.Generator``; they cannot equal ``jax.random``'s, so only greedy
decoding is token-exact across the two packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class SamplingParams:
    do_sample: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0            # 0 = disabled
    max_new_tokens: int = 128
    eos_token_ids: tuple[int, ...] = ()
    pad_token_id: int = 0


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits per row, mask the rest."""
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens with cumulative
    probability >= p (a token is dropped when the cumulative probability
    before it is already >= p)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    thresh = torch.where(keep_sorted, sorted_logits,
                         torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, NEG_INF, logits)


def sample_token(logits: torch.Tensor, generator: torch.Generator | None,
                 sp: SamplingParams) -> torch.Tensor:
    """Next token ids [B] from logits [B, V]."""
    if not sp.do_sample:
        return torch.argmax(logits, dim=-1)
    scaled = logits.float() / max(sp.temperature, 1e-6)
    scaled = apply_top_k(scaled, sp.top_k)
    scaled = apply_top_p(scaled, sp.top_p)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_token_per_slot(logits: torch.Tensor, generator: torch.Generator | None,
                          temperature: torch.Tensor, top_p: torch.Tensor,
                          top_k: torch.Tensor, do_sample: torch.Tensor) -> torch.Tensor:
    """Per-slot sampling for continuous batching: logits [N, V], each slot
    with its own request's temperature / top_p / top_k / do_sample ([N]
    each), so greedy and sampled requests share one decode step."""
    greedy = torch.argmax(logits, dim=-1)
    filtered = filter_logits_per_slot(logits, temperature, top_p, top_k)
    sampled = torch.multinomial(torch.softmax(filtered, dim=-1), 1,
                                generator=generator)[:, 0]
    return torch.where(do_sample.to(logits.device), sampled, greedy)


def filter_logits_per_slot(logits: torch.Tensor, temperature: torch.Tensor,
                           top_p: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """The per-slot target distribution's logits: temperature, then top-k,
    then top-p over one descending sort (top-p cumulates over the k-filtered
    ranks). logits [N, V] or [N, K, V]; the per-slot [N] parameters
    broadcast over the middle axes."""
    V = logits.shape[-1]
    lead = (slice(None),) + (None,) * (logits.dim() - 1)
    temperature, top_p, top_k = (x.to(logits.device) for x in (temperature, top_p, top_k))
    scaled = logits.float() / torch.clamp(temperature.float(), min=1e-6)[lead]
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    ranks = torch.arange(V, device=logits.device)
    k = torch.where(top_k <= 0, V, torch.clamp(top_k, 1, V))
    in_k = ranks < k[lead]
    sorted_f = torch.where(in_k, sorted_logits, NEG_INF)
    probs = torch.softmax(sorted_f, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = ((cum - probs) < top_p.float()[lead]) & in_k
    thresh = torch.where(keep, sorted_f, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(scaled < thresh, NEG_INF, scaled)
