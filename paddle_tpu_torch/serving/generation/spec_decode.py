"""Host-side speculative-decoding accept/resample (Leviathan et al.); the
port's own copy of ``paddle_tpu/serving/generation/spec_decode.py``, with
the same RNG draws in the same order, so seeded sampled streams match the
reference token for token.

The engine's verify step hands this module, per lane, the target
model's logits over the ``[last_accepted, d_1..d_k]`` window
(``logits[i]`` is the target distribution for the token at position
``ctx + i + 1`` — the slot proposal ``d_{i+1}`` wants to fill) plus
the draft's proposed tokens and, for sampled requests, the draft
distributions they were drawn from. ``accept_tokens`` walks the
proposals left to right:

- **greedy** (temperature 0): a proposal is accepted iff it equals the
  target argmax; the first mismatch emits the target argmax instead
  and stops. The emitted stream is therefore EXACTLY the
  non-speculative greedy stream.
- **sampled**: standard accept-and-resample — accept ``d`` with
  probability ``min(1, p_t(d) / p_d(d))``; on rejection sample from
  the residual ``normalize(max(p_t - p_d, 0))`` and stop. The marginal
  distribution of every emitted token equals plain temperature
  sampling from the target model (the Leviathan et al. identity), so
  speculation changes latency, never the output law.

When every proposal survives, one BONUS token is selected from the
final window position's logits — the step that makes a fully-accepted
round emit ``k + 1`` tokens.

Pure numpy, no engine state: unit-testable for the distribution
identity in isolation.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["accept_tokens", "softmax"]


def softmax(logits: np.ndarray, temperature: float) -> np.ndarray:
    z = np.asarray(logits, np.float64) / float(temperature)
    z -= z.max(-1, keepdims=True)
    p = np.exp(z)
    return p / p.sum(-1, keepdims=True)


def _sample(p: np.ndarray, u: float) -> int:
    cdf = np.cumsum(p)
    return int(min(np.searchsorted(cdf, u * cdf[-1], side="right"),
                   p.shape[-1] - 1))


def accept_tokens(target_logits: np.ndarray,
                  draft_tokens: np.ndarray,
                  draft_probs: Optional[np.ndarray],
                  temperature: float,
                  rng: np.random.RandomState,
                  max_emit: int,
                  eos_token_id: Optional[int] = None
                  ) -> Tuple[List[int], int]:
    """Judge one lane's proposals against one verify window.

    target_logits: [k+1, vocab] — row ``i`` scores the token at window
    offset ``i + 1``; row ``k`` is the bonus position. draft_tokens:
    [k] proposed ids. draft_probs: [k, vocab] draft distributions
    (required when temperature > 0; ignored for greedy). ``max_emit``
    caps emissions to the lane's remaining token/page budget; hitting
    it (or ``eos_token_id``) stops the walk early.

    Returns ``(emitted_tokens, n_draft_accepted)`` —
    ``n_draft_accepted`` counts accepted PROPOSALS only (the
    acceptance-rate numerator; the bonus/resample token is excluded).
    """
    k = int(draft_tokens.shape[0])
    greedy = float(temperature) <= 0.0
    emitted: List[int] = []
    accepted = 0

    def stop(tok: int) -> bool:
        return (eos_token_id is not None and tok == eos_token_id) \
            or len(emitted) >= max_emit

    for i in range(k):
        if len(emitted) >= max_emit:
            return emitted, accepted
        d = int(draft_tokens[i])
        if greedy:
            t = int(np.asarray(target_logits[i]).argmax())
            if t == d:
                emitted.append(d)
                accepted += 1
                if stop(d):
                    return emitted, accepted
                continue
            emitted.append(t)        # greedy "resample": the argmax
            return emitted, accepted
        pt = softmax(target_logits[i], temperature)
        pd = np.asarray(draft_probs[i], np.float64)
        ratio = pt[d] / max(pd[d], 1e-300)
        if rng.random_sample() < min(1.0, ratio):
            emitted.append(d)
            accepted += 1
            if stop(d):
                return emitted, accepted
            continue
        residual = np.maximum(pt - pd, 0.0)
        total = residual.sum()
        if total <= 0.0:             # pt == pd exactly: resample pt
            residual, total = pt, 1.0
        emitted.append(_sample(residual / total, rng.random_sample()))
        return emitted, accepted

    # every proposal accepted: the bonus token from the final position
    if len(emitted) < max_emit:
        if greedy:
            emitted.append(int(np.asarray(target_logits[k]).argmax()))
        else:
            emitted.append(_sample(softmax(target_logits[k], temperature),
                                   rng.random_sample()))
    return emitted, accepted
