"""Batched beam search for the joint CTC/attention transformer ASR.

Counterpart of ``speechbrain_tpu/decoders/seq2seq.py``
(``S2SBeamSearcher.search_device``/``finalize`` and
``S2STransformerBeamSearch`` on its KV-cache path with the deferred
``rows`` permutation).  The JAX ``lax.while_loop`` becomes a Python loop
with the same early exit (every batch item holds ``beam_size``
finished hypotheses).  Hypothesis bookkeeping is the same masked,
fixed-shape tensor code, so results match step for step.  Top-k breaks
ties toward the lower index, as ``jax.lax.top_k`` does.
"""

import numpy as np
import torch

from .ctc import CTCPrefixScorer

__all__ = ["S2SBeamSearcher", "S2STransformerBeamSearch"]

MINUS_INF = -1e20


def _topk(x, k):
    """Largest ``k`` along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class S2SBeamSearcher:
    """Batched beam search with masked fixed-shape bookkeeping.

    Subclasses provide ``reset_mem(n, enc_states)``,
    ``forward_step(inp_tokens, memory, enc_lens)`` -> (log_probs (n, V),
    memory) with ``memory["rows"]`` holding the predecessor map the
    next step applies, and ``ctc_forward_step(enc_states)``.
    Calling the searcher returns ``(hyps, top_scores)``.

    The decode settings are those the recipe serves with: scores
    length-normalized, no eos threshold, and with ``ctc_weight`` > 0 the
    CTC prefix scores computed for the attention's top 2 * beam tokens
    only (the JAX "partial" mode).  The JAX searcher's other options
    (LM fusion, eos threshold, coverage and attention-shift penalties,
    length rewarding, top-k output) are not ported yet.
    """

    def __init__(self, bos_index, eos_index, min_decode_ratio,
                 max_decode_ratio, beam_size, ctc_weight=0.0, blank_index=0):
        self.bos_index = bos_index
        self.eos_index = eos_index
        self.min_decode_ratio = min_decode_ratio
        self.max_decode_ratio = max_decode_ratio
        self.beam_size = beam_size
        self.ctc_weight = ctc_weight
        self.blank_index = blank_index
        self.minus_inf = MINUS_INF
        # attention scores are scaled once by (1 - ctc_weight)
        self.att_weight = 1.0 - ctc_weight

    def __call__(self, enc_states, wav_len):
        return self.finalize(*self.search_device(enc_states, wav_len))

    @torch.no_grad()
    def search_device(self, enc_states, wav_len):
        """Run the search on the states' device, until ``max_steps`` or
        until every batch item holds ``beam_size`` finished hypotheses.

        Returns the finalized store ``(seqs (B, beam, max_steps),
        lens (B, beam), scores (B, beam))``.
        """
        B, T = enc_states.shape[0], enc_states.shape[1]
        beam = self.beam_size
        n = B * beam
        dev = enc_states.device
        mi = self.minus_inf
        max_steps = max(1, int(T * self.max_decode_ratio))
        min_steps = int(T * self.min_decode_ratio)
        enc_lens_i = wav_len.repeat_interleave(beam)
        memory = self.reset_mem(n, enc_states)
        scorer = ctc_state = None
        if self.ctc_weight > 0:
            scorer = CTCPrefixScorer(
                self.ctc_forward_step(enc_states), wav_len, B, beam,
                self.blank_index, self.eos_index,
            )
            ctc_state = scorer.init_state()

        beam_scores = torch.full((B, beam), mi, device=dev)
        beam_scores[:, 0] = 0.0  # only beam 0 is alive at first
        inp = torch.full((n,), self.bos_index, dtype=torch.long, device=dev)
        finished = torch.zeros(n, dtype=torch.bool, device=dev)
        alived_seq = torch.full((n, max_steps), self.eos_index,
                                dtype=torch.long, device=dev)
        batch_idx = torch.arange(B, device=dev)[:, None]
        # finished-hypothesis store: first come (earliest eos, then beam
        # rank), at most beam per item; slot `beam` is a write sink
        store_seq = torch.zeros((B, beam + 1, max_steps), dtype=torch.long,
                                device=dev)
        store_len = torch.zeros((B, beam + 1), dtype=torch.long, device=dev)
        store_score = torch.full((B, beam + 1), mi, device=dev)
        store_count = torch.zeros(B, dtype=torch.long, device=dev)
        sel_scores = torch.zeros((B, beam), device=dev)

        def store(is_eos_bb, seqs_bb, lens, scores_bb):
            offs = torch.cumsum(is_eos_bb, dim=1) - is_eos_bb
            slot = store_count[:, None] + offs
            write = is_eos_bb.bool() & (slot < beam)
            slot_safe = torch.where(write, slot, beam)
            store_seq[batch_idx, slot_safe] = seqs_bb
            store_len[batch_idx, slot_safe] = lens
            store_score[batch_idx, slot_safe] = scores_bb
            store_count.copy_(
                torch.clamp(store_count + is_eos_bb.sum(dim=1), max=beam)
            )

        t = 0
        while t < max_steps:
            log_probs, memory = self.forward_step(inp, memory, enc_lens_i)
            log_probs = self.att_weight * log_probs.float()
            V = log_probs.shape[-1]
            if t < min_steps:
                log_probs[:, self.eos_index] = mi
            if scorer is not None:
                log_probs[:, self.blank_index] = mi
                # CTC-score only the attention's top 2*beam tokens
                K = min(2 * beam, V)
                cand_v, row_tokens = _topk(log_probs, K)
                ctc_scores, ctc_state = scorer.forward_step(
                    inp, ctc_state, candidates=row_tokens
                )
                row_scores = cand_v + self.ctc_weight * ctc_scores
            else:
                K = min(beam, V)
                row_scores, row_tokens = _topk(log_probs, K)
            # finished rows are out of the search
            row_scores = torch.where(finished[:, None], mi, row_scores)
            cand = (beam_scores.reshape(n, 1) + row_scores) / (t + 1)
            sel_scores, idx2 = _topk(cand.reshape(B, beam * K), beam)
            pred_beam = idx2 // K
            tokens = torch.gather(
                row_tokens.reshape(B, beam * K), 1, pred_beam * K + idx2 % K
            )
            rows = (batch_idx * beam + pred_beam).reshape(-1)
            tokens_flat = tokens.reshape(-1)
            beam_scores = sel_scores * (t + 1)  # raw running scores
            memory["rows"] = rows  # applied by the next step's cache update
            if scorer is not None:
                ctc_state = scorer.permute_mem(
                    ctc_state, (pred_beam * V + tokens).reshape(-1)
                )
            alived_seq = alived_seq[rows]
            alived_seq[:, t] = tokens_flat
            finished = finished[rows] | (tokens_flat == self.eos_index)
            is_eos_bb = (tokens_flat == self.eos_index).reshape(B, beam).long()
            store(
                is_eos_bb, alived_seq.reshape(B, beam, -1),
                torch.full((B, beam), t, dtype=torch.long, device=dev),
                sel_scores,
            )
            beam_scores = torch.where(is_eos_bb.bool(), mi, beam_scores)
            inp = tokens_flat
            t += 1
            if bool((store_count >= beam).all()):
                break
        # fill the remaining slots from the alive beams, scored by the
        # last step's selection scores
        store(
            torch.ones((B, beam), dtype=torch.long, device=dev),
            alived_seq.reshape(B, beam, -1),
            torch.full((B, beam), t, dtype=torch.long, device=dev),
            sel_scores,
        )
        return store_seq[:, :beam], store_len[:, :beam], store_score[:, :beam]

    def finalize(self, store_seq, store_len, store_score):
        """Host-side pick of the best stored hypothesis per item, cut at
        its first eos.  Returns ``(best_hyps, best_scores)``."""
        seqs = store_seq.cpu().numpy()
        lens = store_len.cpu().numpy()
        scores = store_score.float().cpu().numpy()
        best = np.argsort(-scores, axis=1, kind="stable")[:, 0]
        hyps = []
        for b, k in enumerate(best):
            hyp = []
            for tok in seqs[b, k, : lens[b, k]]:
                if tok == self.eos_index:
                    break
                hyp.append(int(tok))
            hyps.append(hyp)
        return hyps, scores[np.arange(len(best)), best]


class S2STransformerBeamSearch(S2SBeamSearcher):
    """Beam search over a KV-cached transformer decoder.

    Arguments
    ---------
    step_fn : (tokens (n,), caches, pos, enc_lens (n,), rows (n,)) ->
        (out (n, d), caches): one decoder step with the predecessor
        permutation ``rows`` fused into the self-cache update.
    cache_init_fn : (enc_states (B, T, d), max_steps) -> per-layer cache
        dicts {"skv", "ck", "cv"}.
    linear_fn : (n, d) -> (n, V) seq2seq logits.
    ctc_linear_fn : (B, T, d) -> (B, T, V) CTC logits.

    Cross-attention K/V are built once per batch item (not per beam)
    and never permuted: beams of one item share encoder states.  Each
    layer keeps two self-cache buffers, ``skv`` and ``alt``; every step
    writes the permuted and appended cache into ``alt`` and the two swap
    roles, so the search allocates no cache per step.  (The JAX searcher
    unrolls its loop by two for the same purpose; a Python loop needs
    only the swap.)
    """

    def __init__(self, step_fn, cache_init_fn, linear_fn, ctc_linear_fn=None,
                 **kwargs):
        super().__init__(**kwargs)
        self.step_fn = step_fn
        self.cache_init_fn = cache_init_fn
        self.linear_fn = linear_fn
        self.ctc_linear_fn = ctc_linear_fn

    def reset_mem(self, batch_size, enc_states):
        """Caches for ``batch_size`` = B * beam rows from the (B, T, d)
        encoder states, identity predecessors."""
        max_steps = max(1, int(enc_states.shape[1] * self.max_decode_ratio))
        group = batch_size // enc_states.shape[0]
        cache = self.cache_init_fn(enc_states, max_steps)
        cross = []
        for c in cache:
            cross.append({"ck": c.pop("ck"), "cv": c.pop("cv")})
            c["skv"] = c["skv"].repeat_interleave(group, dim=0)
            c["alt"] = torch.zeros_like(c["skv"])
        return {
            "cache": cache,
            "cross": cross,
            "len": 0,
            "rows": torch.arange(batch_size, device=enc_states.device),
        }

    def forward_step(self, inp_tokens, memory, enc_lens):
        """One decoder step; returns (log_probs (n, V) f32, memory)."""
        full = [{**dyn, **stat}
                for dyn, stat in zip(memory["cache"], memory["cross"])]
        out_t, cache = self.step_fn(
            inp_tokens, full, memory["len"], enc_lens, memory["rows"]
        )
        log_probs = torch.log_softmax(self.linear_fn(out_t).float(), dim=-1)
        new_mem = {
            "cache": [{"skv": c["skv"], "alt": c["alt"]} for c in cache],
            "cross": memory["cross"],
            "len": memory["len"] + 1,
            "rows": memory["rows"],
        }
        return log_probs, new_mem

    def ctc_forward_step(self, enc_states):
        """CTC log-probabilities (B, T, V) in float32."""
        return torch.log_softmax(self.ctc_linear_fn(enc_states).float(), -1)
