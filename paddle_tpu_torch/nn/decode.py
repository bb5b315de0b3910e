"""Beam-search decoding: the port of ``paddle_tpu/nn/decode.py``
(``BeamSearchDecoder`` and ``dynamic_decode``).

As the reference, the step loop runs on the host: each step calls the cell
(and the embedding and output functions) on the device, reads the
log-probabilities back and picks the beams in numpy; the paths are
recovered with ``nn.functional.gather_tree`` at the end.
"""
from __future__ import annotations

import numpy as np

from . import functional as F

__all__ = ["BeamSearchDecoder", "dynamic_decode"]


class BeamSearchDecoder:
    """Drives an RNN cell with beam search. ``embedding_fn`` maps token ids
    to embeddings, ``output_fn`` the cell's output to vocabulary logits
    (both the identity by default, as the reference's)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn or (lambda ids: ids)
        self.output_fn = output_fn or (lambda out: out)


def dynamic_decode(decoder, inits=None, max_step_num=32, **kwargs):
    """Beam search for at most ``max_step_num`` steps (fewer once every
    beam has ended). Returns ``(ids [B, T, beam], scores [B, beam])``."""
    from ..core.tensor import to_tensor
    from ..tensor.manipulation import transpose

    d = decoder
    if inits is None:
        raise ValueError(
            "dynamic_decode needs the cell's initial states: pass "
            "inits=cell.get_initial_states(batch_ref)")
    leaf = inits
    while isinstance(leaf, (tuple, list)):
        leaf = leaf[0]
    b, k, end = leaf.shape[0], d.beam_size, d.end_token

    def tile(s):
        # batch-major rows (b·K + k), the layout of the tokens
        if isinstance(s, (tuple, list)):
            return type(s)(tile(x) for x in s)
        return to_tensor(np.repeat(np.asarray(s.numpy()), k, axis=0))

    state = tile(inits)
    tokens = np.full((b, k), d.start_token, np.int64)
    # only beam 0 is live at the start, so that equal beams do not split
    log_probs = np.where(np.arange(k)[None, :] == 0, 0.0,
                         -1e9).astype(np.float32) * np.ones((b, 1), "f")
    finished = np.zeros((b, k), bool)
    all_tokens, all_parents = [], []
    for _ in range(int(max_step_num)):
        emb = d.embedding_fn(to_tensor(tokens.reshape(-1)))
        out, state = d.cell(emb, state)
        logp = np.asarray(F.log_softmax(d.output_fn(out), axis=-1)
                          .numpy()).reshape(b, k, -1)
        v = logp.shape[-1]
        # a finished beam extends with end_token only, at no cost
        mask = np.full((b, k, v), -1e9, np.float32)
        mask[:, :, end] = 0.0
        logp = np.where(finished[:, :, None], mask, logp)
        flat = (log_probs[:, :, None] + logp).reshape(b, k * v)
        top = np.argsort(-flat, axis=-1)[:, :k]
        log_probs = np.take_along_axis(flat, top, -1)
        parents = top // v
        tokens = (top % v).astype(np.int64)
        finished = np.take_along_axis(finished, parents, -1) | (tokens == end)
        all_tokens.append(tokens.copy())
        all_parents.append(parents.copy())

        def reindex(s):
            if isinstance(s, (tuple, list)):
                return type(s)(reindex(x) for x in s)
            trail = tuple(s.shape[1:])
            arr = s.numpy().reshape((b, k) + trail)
            idx = parents.reshape((b, k) + (1,) * len(trail))
            arr = np.take_along_axis(arr, idx, 1)
            return to_tensor(arr.reshape((b * k,) + trail))
        state = reindex(state)
        if finished.all():
            break
    full = F.gather_tree(to_tensor(np.stack(all_tokens)),
                         to_tensor(np.stack(all_parents)))
    return transpose(full, [1, 0, 2]), to_tensor(log_probs)
