"""Autoregressive searches for seq2seq models: the batched beam search of
the joint CTC/attention transformer ASR (shallow fusion of a transformer
LM), and the greedy and beam searches of the attentional RNN decoder
(shallow fusion of an RNNLM).

Counterpart of ``speechbrain_tpu/decoders/seq2seq.py``
(``S2SBeamSearcher.search_device``/``finalize`` with all its options,
``S2STransformerBeamSearch`` on its KV-cache path with the deferred
``rows`` permutation and on its prefix-buffer path, its transformer-LM
step, ``S2SGreedySearcher``, ``S2SRNNGreedySearcher``,
``S2SRNNBeamSearcher``, ``S2SRNNBeamSearchLM``, and the helpers
``inflate_tensor``, ``mask_by_condition``, ``filter_seq2seq_output`` and
``batch_filter_seq2seq_output``).  The JAX ``lax.while_loop`` becomes a
Python loop with the same early exit (every batch item holds
``beam_size`` finished hypotheses).  Hypothesis bookkeeping is the same
masked, fixed-shape tensor code, so results match step for step.  Top-k
breaks ties toward the lower index, as ``jax.lax.top_k`` does.

The options that act on attention weights (``coverage_penalty``,
``using_max_attn_shift``, the CTC scorer's ``ctc_window_size``) read the
weights that ``forward_step`` returns: the RNN searchers return the
decoder's, the transformer searcher none (``None`` in JAX too).

Not ported: ``S2SRNNBeamSearchTransformerLM`` and the Whisper searchers.
"""

import numpy as np
import torch

from .ctc import CTCPrefixScorer

__all__ = [
    "S2SGreedySearcher",
    "S2SRNNGreedySearcher",
    "S2SBeamSearcher",
    "S2SRNNBeamSearcher",
    "S2SRNNBeamSearchLM",
    "S2STransformerBeamSearch",
    "inflate_tensor",
    "mask_by_condition",
    "filter_seq2seq_output",
    "batch_filter_seq2seq_output",
]

MINUS_INF = -1e20


def _topk(x, k):
    """Largest ``k`` along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(memory, rows):
    """Reorder every tensor entry's leading axis by ``rows``; scalars
    (and 0-d tensors) are left alone."""
    return {k: v[rows] if torch.is_tensor(v) and v.dim() >= 1 else v
            for k, v in memory.items()}


def _swap01(hs):
    """Layer-major (L, n, H) <-> row-major (n, L, H) hidden states (an
    LSTM's pair swapped part by part): the searchers keep them row-major
    so that the beam permutation reorders rows, not layers."""
    if isinstance(hs, tuple):
        return tuple(h.transpose(0, 1) for h in hs)
    return hs.transpose(0, 1)


class _RNNSteps:
    """The searcher hooks over an ``AttentionalRNNDecoder``'s callables
    (JAX ``S2SRNNGreedySearcher``/``S2SRNNBeamSearcher``'s arguments):

    embedding_fn : tokens (n,) -> (n, E).
    decoder_step_fn : (emb, hs, c, enc_states, enc_lens, attn_state) ->
        (dec_out, hs, c, w, attn_state): the decoder's ``forward_step``.
    linear_fn : (n, H) -> (n, V).
    dec_hidden_size : width of the zero initial context.
    attn_init_fn : enc_states (B, T, D) -> the attention's first state.
    rnn_init_fn : (n, dtype, device) -> the cell's zero state, layer-major
        ((L, n, H), or the LSTM's pair).

    The memory holds the cell state row-major, the context, the attention
    state and the (B, T, D) encoder states.  The encoder side is not
    tiled over the beams (JAX tiles it): the attention broadcasts each
    item's over its rows.  The beam search's predecessor map
    ``memory["rows"]`` is applied at the next step to every entry with
    one row a hypothesis; entries with one row an item (the encoder
    projection) are shared by its beams and stay."""

    def _init_rnn_hooks(self, embedding_fn, decoder_step_fn, linear_fn,
                        dec_hidden_size, attn_init_fn, rnn_init_fn):
        self.embedding_fn = embedding_fn
        self.decoder_step_fn = decoder_step_fn
        self.linear_fn = linear_fn
        self.dec_hidden_size = dec_hidden_size
        self.attn_init_fn = attn_init_fn
        self.rnn_init_fn = rnn_init_fn

    def reset_mem(self, batch_size, enc_states):
        """Zero cell state and context for ``batch_size`` rows, the
        attention's first state, the encoder states."""
        dtype, dev = enc_states.dtype, enc_states.device
        return {
            "hs": _swap01(self.rnn_init_fn(batch_size, dtype, dev)),
            "c": torch.zeros(batch_size, self.dec_hidden_size, dtype=dtype,
                             device=dev),
            "attn_state": self.attn_init_fn(enc_states),
            "enc": enc_states,
        }

    def _scores(self, logits):
        raise NotImplementedError

    def forward_step(self, inp_tokens, memory, enc_lens):
        """One decoder step: ``(scores (n, V) float32, memory, attention
        weights (n, T))``."""
        rows = memory.get("rows")
        hs, c, attn_state = memory["hs"], memory["c"], memory["attn_state"]
        if rows is not None:
            n = rows.shape[0]

            def take(v):
                return v[rows] if v.shape[0] == n else v

            hs = tuple(map(take, hs)) if isinstance(hs, tuple) else take(hs)
            c = c[rows]
            attn_state = {k: take(v) for k, v in attn_state.items()}
        dec_out, hs, c, w, attn_state = self.decoder_step_fn(
            self.embedding_fn(inp_tokens), _swap01(hs), c, memory["enc"],
            enc_lens, attn_state)
        scores = self._scores(self.linear_fn(dec_out).float())
        return scores, dict(memory, hs=_swap01(hs), c=c,
                            attn_state=attn_state), w


class S2SGreedySearcher:
    """Greedy decoding (JAX ``S2SGreedySearcher``): from bos, each step
    takes each row's argmax of ``forward_step``'s scores and adds its
    score, until every row has emitted eos or ``max_steps`` = max(1,
    int(T * max_decode_ratio)) steps (JAX runs all of them; a finished
    row only adds eos at score 0, so stopping early changes nothing).
    ``min_decode_ratio`` is stored and unused, as in JAX.  Subclasses
    provide ``reset_mem`` and ``forward_step`` as ``S2SBeamSearcher``'s.
    Calling it returns ``(hyps, scores (B,) numpy)``, each hypothesis cut
    before its first eos."""

    def __init__(self, bos_index, eos_index, min_decode_ratio,
                 max_decode_ratio):
        self.bos_index = bos_index
        self.eos_index = eos_index
        self.min_decode_ratio = min_decode_ratio
        self.max_decode_ratio = max_decode_ratio

    @torch.no_grad()
    def __call__(self, enc_states, wav_len):
        B, T = enc_states.shape[0], enc_states.shape[1]
        dev = enc_states.device
        memory = self.reset_mem(B, enc_states)
        inp = torch.full((B,), self.bos_index, dtype=torch.long, device=dev)
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        score = torch.zeros(B, device=dev)
        tokens = []
        for _ in range(max(1, int(T * self.max_decode_ratio))):
            log_probs, memory, _ = self.forward_step(inp, memory, wav_len)
            tok_score, token = log_probs.max(dim=-1)
            token = torch.where(finished, self.eos_index, token)
            score = score + torch.where(finished, 0.0, tok_score)
            finished = finished | (token == self.eos_index)
            tokens.append(token)
            inp = token
            if bool(finished.all()):
                break
        rows = torch.stack(tokens, 1).cpu().tolist()
        return ([filter_seq2seq_output(r, eos_id=self.eos_index)
                 for r in rows], score.cpu().numpy())


class S2SRNNGreedySearcher(_RNNSteps, S2SGreedySearcher):
    """Greedy search over an ``AttentionalRNNDecoder`` (JAX
    ``S2SRNNGreedySearcher``): the arguments of ``_RNNSteps``, then
    ``S2SGreedySearcher``'s.  ``linear_fn`` must give log-probs: as in
    JAX, its output is the step's scores as it is.

    Example
    -------
    >>> from speechbrain_tpu_torch.nnet.RNN import AttentionalRNNDecoder
    >>> dec = AttentionalRNNDecoder("gru", "content", hidden_size=8,
    ...     attn_dim=6, enc_dim=5, input_size=4).eval()
    >>> emb, lin = torch.nn.Embedding(10, 4), torch.nn.Linear(8, 10)
    >>> searcher = S2SRNNGreedySearcher(
    ...     emb, dec.forward_step, lambda h: torch.log_softmax(lin(h), -1),
    ...     8, dec.attn_init, dec.rnn.init_state, bos_index=1, eos_index=2,
    ...     min_decode_ratio=0.0, max_decode_ratio=1.0)
    >>> hyps, scores = searcher(torch.randn(2, 6, 5), torch.ones(2))
    >>> len(hyps), scores.shape
    (2, (2,))
    """

    def __init__(self, embedding_fn, decoder_step_fn, linear_fn,
                 dec_hidden_size, attn_init_fn, rnn_init_fn, **kwargs):
        super().__init__(**kwargs)
        self._init_rnn_hooks(embedding_fn, decoder_step_fn, linear_fn,
                             dec_hidden_size, attn_init_fn, rnn_init_fn)

    def _scores(self, logits):
        return logits


class S2SBeamSearcher:
    """Batched beam search with masked fixed-shape bookkeeping.

    Subclasses provide ``reset_mem(n, enc_states)``,
    ``forward_step(inp_tokens, memory, enc_lens)`` -> (log_probs (n, V),
    memory, attention weights (n, T) or None), where ``memory["rows"]``
    is the predecessor map that the search sets after each step and the
    next step applies,
    ``ctc_forward_step(enc_states)``, and, for LM fusion,
    ``reset_lm_mem(n)`` and ``lm_forward_step(inp_tokens, lm_memory)``.
    Calling the searcher returns ``finalize``'s result.

    Each step, as in JAX: the attention log-probs are scaled by
    ``1 - ctc_weight``; with ``using_max_attn_shift``, a row whose
    attention peak (argmax) moved more than ``max_attn_shift`` frames
    from its predecessor's (``peak <= prev + shift`` and strictly ``peak
    > prev - shift``; the first step's predecessor peak is 0) gets -inf
    everywhere; the eos column is -inf before ``min_steps`` and,
    with ``using_eos_threshold``, wherever eos scores below
    ``eos_threshold`` x the row's best; then ``lm_weight`` x the LM's
    log-probs are added; then, with ``ctc_weight`` > 0, the blank column
    is set to -inf and ``ctc_weight`` x the CTC prefix scores are added:
    in ``ctc_score_mode`` "full" (JAX's default and the recipe's) over the
    whole vocabulary, keeping each row's top ``beam`` tokens, in
    "partial" for the attention's top 2 * beam tokens only.  Scores are
    divided by the length with ``length_normalization``;
    ``length_rewarding`` x length is added to the finished hypotheses'
    scores only (the two cannot be combined).  ``coverage_penalty`` > 0
    subtracts ``coverage_penalty`` x (sum over all T frames, padding
    too, of max(coverage, 0.5) - T / 2), divided by t + 1 under length
    normalization, from the selection scores that are stored, not from
    the running ones; coverage sums the selected rows' attention, and at
    t = 0 it counts the first step's attention twice, once permuted
    twice (JAX's quirk, kept).  ``ctc_window_size`` > 0 restricts the
    CTC scorer to the step's attention window (``CTCPrefixScorer``).
    ``topk`` > 1 makes ``finalize`` also return the ``topk`` best
    hypotheses per item; ``return_log_probs`` is stored and unused, as in
    JAX.
    """

    def __init__(self, bos_index, eos_index, min_decode_ratio,
                 max_decode_ratio, beam_size, topk=1, return_log_probs=False,
                 using_eos_threshold=True, eos_threshold=1.5,
                 length_normalization=True, length_rewarding=0,
                 coverage_penalty=0.0, lm_weight=0.0, ctc_weight=0.0,
                 blank_index=0, ctc_score_mode="full", ctc_window_size=0,
                 using_max_attn_shift=False, max_attn_shift=60):
        if length_normalization and length_rewarding > 0:
            raise ValueError(
                "length normalization is not compatible with length rewarding"
            )
        if ctc_score_mode not in ("full", "partial"):
            raise ValueError(f"Unknown ctc_score_mode {ctc_score_mode}")
        self.bos_index = bos_index
        self.eos_index = eos_index
        self.min_decode_ratio = min_decode_ratio
        self.max_decode_ratio = max_decode_ratio
        self.beam_size = beam_size
        self.topk = topk
        self.return_log_probs = return_log_probs
        self.using_eos_threshold = using_eos_threshold
        self.eos_threshold = eos_threshold
        self.length_normalization = length_normalization
        self.length_rewarding = length_rewarding
        self.lm_weight = lm_weight
        self.ctc_weight = ctc_weight
        self.blank_index = blank_index
        self.ctc_score_mode = ctc_score_mode
        self.coverage_penalty = coverage_penalty
        self.ctc_window_size = ctc_window_size
        self.using_max_attn_shift = using_max_attn_shift
        self.max_attn_shift = max_attn_shift
        self.minus_inf = MINUS_INF
        # attention scores are scaled once by (1 - ctc_weight)
        self.att_weight = 1.0 - ctc_weight

    def __call__(self, enc_states, wav_len):
        return self.finalize(*self.search_device(enc_states, wav_len))

    def reset_lm_mem(self, n):
        """Initial LM memory for a fresh search."""
        return None

    def lm_forward_step(self, inp_tokens, memory):
        """One LM step: (log_probs (n, V), updated LM memory)."""
        raise NotImplementedError

    def _max_steps(self, T):
        return max(1, int(T * self.max_decode_ratio))

    _cur_max_steps = _device = None

    @torch.no_grad()
    def search_device(self, enc_states, wav_len, early_exit=True):
        """Run the search on the states' device, until ``max_steps`` or,
        with ``early_exit``, until every batch item holds ``beam_size``
        finished hypotheses (JAX's ``search_device`` takes the same flag;
        the later steps store nothing, so both give the same result).

        Returns the finalized store ``(seqs (B, beam, max_steps),
        lens (B, beam), scores (B, beam))``.
        """
        B, T = enc_states.shape[0], enc_states.shape[1]
        beam = self.beam_size
        n = B * beam
        dev = enc_states.device
        mi = self.minus_inf
        max_steps = self._max_steps(T)
        min_steps = int(T * self.min_decode_ratio)
        # fixed for this search; reset_lm_mem sizes its buffer by them
        self._cur_max_steps, self._device = max_steps, dev
        enc_lens_i = wav_len.repeat_interleave(beam)
        memory = self.reset_mem(n, enc_states)
        lm_memory = self.reset_lm_mem(n) if self.lm_weight > 0 else None
        scorer = ctc_state = None
        if self.ctc_weight > 0:
            scorer = CTCPrefixScorer(
                self.ctc_forward_step(enc_states), wav_len, B, beam,
                self.blank_index, self.eos_index,
                ctc_window_size=self.ctc_window_size,
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
        prev_attn_peak = torch.zeros(n, dtype=torch.long, device=dev)
        coverage = torch.zeros((n, T), device=dev)

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
            log_probs, memory, attn = self.forward_step(inp, memory,
                                                        enc_lens_i)
            log_probs = self.att_weight * log_probs.float()
            V = log_probs.shape[-1]
            if self.using_max_attn_shift and attn is not None:
                attn_peak = attn.argmax(dim=-1)
                ok = ((attn_peak <= prev_attn_peak + self.max_attn_shift)
                      & (attn_peak > prev_attn_peak - self.max_attn_shift))
                log_probs = torch.where(ok[:, None], log_probs, mi)
                prev_attn_peak = attn_peak
            if t < min_steps:
                log_probs[:, self.eos_index] = mi
            elif self.using_eos_threshold:
                eos_col = log_probs[:, self.eos_index]
                gate = eos_col > self.eos_threshold * log_probs.max(-1).values
                log_probs[:, self.eos_index] = torch.where(gate, eos_col, mi)
            if lm_memory is not None:
                lm_log_probs, lm_memory = self.lm_forward_step(inp, lm_memory)
                log_probs = log_probs + self.lm_weight * lm_log_probs.float()
            if scorer is not None:
                log_probs[:, self.blank_index] = mi
                if self.ctc_score_mode == "partial":
                    # CTC-score only the attention's top 2*beam tokens
                    K = min(2 * beam, V)
                    cand_v, row_tokens = _topk(log_probs, K)
                    ctc_scores, ctc_state = scorer.forward_step(
                        inp, ctc_state, candidates=row_tokens, attn=attn
                    )
                    row_scores = cand_v + self.ctc_weight * ctc_scores
                else:
                    ctc_scores, ctc_state = scorer.forward_step(
                        inp, ctc_state, attn=attn)
                    K = min(beam, V)
                    row_scores, row_tokens = _topk(
                        log_probs + self.ctc_weight * ctc_scores, K
                    )
            else:
                K = min(beam, V)
                row_scores, row_tokens = _topk(log_probs, K)
            # finished rows are out of the search
            row_scores = torch.where(finished[:, None], mi, row_scores)
            cand = beam_scores.reshape(n, 1) + row_scores
            if self.length_normalization:
                cand = cand / (t + 1)
            sel_scores, idx2 = _topk(cand.reshape(B, beam * K), beam)
            pred_beam = idx2 // K
            tokens = torch.gather(
                row_tokens.reshape(B, beam * K), 1, pred_beam * K + idx2 % K
            )
            rows = (batch_idx * beam + pred_beam).reshape(-1)
            tokens_flat = tokens.reshape(-1)
            # raw running scores
            beam_scores = (sel_scores * (t + 1) if self.length_normalization
                           else sel_scores)
            memory["rows"] = rows  # applied by the next step
            if lm_memory is not None:
                lm_memory = _gather_rows(lm_memory, rows)
            if scorer is not None:
                ctc_state = scorer.permute_mem(
                    ctc_state, (pred_beam * V + tokens).reshape(-1)
                )
            if self.using_max_attn_shift:
                prev_attn_peak = prev_attn_peak[rows]
            alived_seq = alived_seq[rows]
            alived_seq[:, t] = tokens_flat
            finished = finished[rows] | (tokens_flat == self.eos_index)
            if self.coverage_penalty > 0 and attn is not None:
                cur_attn = attn.float()[rows]
                coverage = coverage[rows] + cur_attn
                if t == 0:
                    coverage = coverage + cur_attn[rows]
                penalty = coverage.clamp(min=0.5).sum(-1) - T * 0.5
                if self.length_normalization:
                    penalty = penalty / (t + 1)
                sel_scores = sel_scores - (
                    self.coverage_penalty * penalty.reshape(B, beam))
            is_eos_bb = (tokens_flat == self.eos_index).reshape(B, beam).long()
            store(
                is_eos_bb, alived_seq.reshape(B, beam, -1),
                torch.full((B, beam), t, dtype=torch.long, device=dev),
                sel_scores + self.length_rewarding * (t + 1),
            )
            beam_scores = torch.where(is_eos_bb.bool(), mi, beam_scores)
            inp = tokens_flat
            t += 1
            if early_exit and bool((store_count >= beam).all()):
                break
        # fill the remaining slots from the alive beams, scored by the
        # last step's selection scores
        store(
            torch.ones((B, beam), dtype=torch.long, device=dev),
            alived_seq.reshape(B, beam, -1),
            torch.full((B, beam), t, dtype=torch.long, device=dev),
            sel_scores + self.length_rewarding * (t + 1),
        )
        return store_seq[:, :beam], store_len[:, :beam], store_score[:, :beam]

    def finalize(self, store_seq, store_len, store_score):
        """Host-side ranking of the stored hypotheses, each cut at its
        first eos.  Returns ``(best_hyps, best_scores (B,))``, or with
        ``topk`` > 1 ``(best_hyps, top_scores (B, topk), topk_hyps)``."""
        seqs = store_seq.cpu().numpy()
        lens = store_len.cpu().numpy()
        scores = store_score.float().cpu().numpy()
        order = np.argsort(-scores, axis=1, kind="stable")
        top_scores = np.take_along_axis(scores, order, axis=1)[:, : self.topk]

        def hyp(b, k):
            return filter_seq2seq_output(
                [int(tok) for tok in seqs[b, k, : lens[b, k]]],
                eos_id=self.eos_index,
            )

        best_hyps = [hyp(b, ks[0]) for b, ks in enumerate(order)]
        if self.topk > 1:
            topk_hyps = [[hyp(b, k) for k in ks[: self.topk]]
                         for b, ks in enumerate(order)]
            return best_hyps, top_scores, topk_hyps
        return best_hyps, top_scores[:, 0]


class S2STransformerBeamSearch(S2SBeamSearcher):
    """Beam search over a transformer decoder, KV-cached or over a
    prefix buffer, with optional transformer-LM shallow fusion.

    Arguments
    ---------
    linear_fn : (n, d) -> (n, V) seq2seq logits.
    step_fn : (tokens (n,), caches, pos, enc_lens (n,), rows (n,)) ->
        (out (n, d), caches): one decoder step with the predecessor
        permutation ``rows`` fused into the self-cache update.
    cache_init_fn : (enc_states (B, T, d), max_steps) -> per-layer cache
        dicts {"skv", "ck", "cv"}.
    decode_fn : (prefix (n, L), enc_states (n, T, d), enc_lens (n,)) ->
        (n, L, d): the buffer path, used when ``step_fn`` is None.
    ctc_linear_fn : (B, T, d) -> (B, T, V) CTC logits.
    lm_fn : (prefix (n, L)) -> (n, L, V) LM logits; fused at
        ``lm_weight``.
    temperature, temperature_lm : divide the decoder's and the LM's
        logits before their log-softmax.
    Other keyword arguments are ``S2SBeamSearcher``'s.

    KV-cache path: cross-attention K/V are built once per batch item
    (not per beam) and never permuted: beams of one item share encoder
    states.  Each layer keeps two self-cache buffers, ``skv`` and
    ``alt``; every step writes the permuted and appended cache into
    ``alt`` and the two swap roles, so the search allocates no cache per
    step.  (The JAX searcher unrolls its loop by two for the same
    purpose; a Python loop needs only the swap.)

    Buffer path and LM: each step reruns the decoder (the LM) over the
    whole prefix and reads its last position.  JAX keeps a fixed-size
    buffer and runs over all of it, because ``lax.while_loop`` needs
    fixed shapes; here only the written prefix ``buf[:, :len]`` is run.
    Under the causal mask the last written position never sees the
    later slots, so both compute the same function.
    """

    def __init__(self, linear_fn, step_fn=None, cache_init_fn=None,
                 decode_fn=None, ctc_linear_fn=None, lm_fn=None,
                 temperature=1.0, temperature_lm=1.0, **kwargs):
        super().__init__(**kwargs)
        if step_fn is None and decode_fn is None:
            raise ValueError("give step_fn and cache_init_fn, or decode_fn")
        self.step_fn = step_fn
        self.cache_init_fn = cache_init_fn
        self.decode_fn = decode_fn
        self.linear_fn = linear_fn
        self.ctc_linear_fn = ctc_linear_fn
        self.lm_fn = lm_fn
        self.temperature = temperature
        self.temperature_lm = temperature_lm

    def reset_mem(self, batch_size, enc_states):
        """Memory for ``batch_size`` = B * beam rows from the (B, T, d)
        encoder states, identity predecessors: per-layer caches
        (KV-cache path), or an empty prefix buffer and the beam-tiled
        states (buffer path)."""
        max_steps = self._max_steps(enc_states.shape[1])
        group = batch_size // enc_states.shape[0]
        rows = torch.arange(batch_size, device=enc_states.device)
        if self.step_fn is None:
            return {
                "buf": torch.zeros((batch_size, max_steps), dtype=torch.long,
                                   device=enc_states.device),
                "enc": enc_states.repeat_interleave(group, dim=0),
                "len": 0,
                "rows": rows,
            }
        cache = self.cache_init_fn(enc_states, max_steps)
        cross = []
        for c in cache:
            cross.append({"ck": c.pop("ck"), "cv": c.pop("cv")})
            c["skv"] = c["skv"].repeat_interleave(group, dim=0)
            c["alt"] = torch.zeros_like(c["skv"])
        return {"cache": cache, "cross": cross, "len": 0, "rows": rows}

    def forward_step(self, inp_tokens, memory, enc_lens):
        """One decoder step; returns (log_probs (n, V) f32, memory, None):
        no attention weights."""
        ln = memory["len"]
        if self.step_fn is None:
            buf = memory["buf"][memory["rows"]]
            buf[:, ln] = inp_tokens
            out_t = self.decode_fn(buf[:, : ln + 1], memory["enc"],
                                   enc_lens)[:, ln]
            new_mem = {**memory, "buf": buf, "len": ln + 1}
        else:
            full = [{**dyn, **stat}
                    for dyn, stat in zip(memory["cache"], memory["cross"])]
            out_t, cache = self.step_fn(inp_tokens, full, ln, enc_lens,
                                        memory["rows"])
            new_mem = {
                "cache": [{"skv": c["skv"], "alt": c["alt"]} for c in cache],
                "cross": memory["cross"],
                "len": ln + 1,
                "rows": memory["rows"],
            }
        logits = self.linear_fn(out_t).float()
        return (torch.log_softmax(logits / self.temperature, dim=-1), new_mem,
                None)

    def reset_lm_mem(self, n):
        """LM memory: a prefix buffer of ``max_steps + 1`` slots seeded
        with bos, its length, and how many steps have run (the first
        step's input is the bos already there, so it is not appended)."""
        return {
            "buf": torch.full((n, self._cur_max_steps + 1), self.bos_index,
                              dtype=torch.long, device=self._device),
            "len": 1,
            "calls": 0,
        }

    def lm_forward_step(self, inp_tokens, memory):
        """One LM step: (log_probs (n, V) f32, updated LM memory)."""
        buf, ln = memory["buf"], memory["len"]
        if memory["calls"] > 0:
            buf = buf.clone()
            buf[:, ln] = inp_tokens
            ln += 1
        logits = self.lm_fn(buf[:, :ln])[:, ln - 1].float()
        log_probs = torch.log_softmax(logits / self.temperature_lm, dim=-1)
        return log_probs, {"buf": buf, "len": ln,
                           "calls": memory["calls"] + 1}

    def ctc_forward_step(self, enc_states):
        """CTC log-probabilities (B, T, V) in float32."""
        return torch.log_softmax(self.ctc_linear_fn(enc_states).float(), -1)


class S2SRNNBeamSearcher(_RNNSteps, S2SBeamSearcher):
    """Beam search over an ``AttentionalRNNDecoder`` (JAX
    ``S2SRNNBeamSearcher``): the arguments of ``_RNNSteps``, then
    ``ctc_linear_fn`` ((B, T, D) -> CTC logits, for ``ctc_weight`` > 0),
    ``temperature`` (the decoder's logits are divided by it before their
    log-softmax) and ``S2SBeamSearcher``'s keywords, all of whose options
    apply: the step returns the decoder's attention weights.

    Example
    -------
    >>> from speechbrain_tpu_torch.nnet.RNN import AttentionalRNNDecoder
    >>> dec = AttentionalRNNDecoder("gru", "location", hidden_size=8,
    ...     attn_dim=6, enc_dim=5, input_size=4, kernel_size=2).eval()
    >>> emb, lin = torch.nn.Embedding(10, 4), torch.nn.Linear(8, 10)
    >>> searcher = S2SRNNBeamSearcher(
    ...     emb, dec.forward_step, lin, 8, dec.attn_init, dec.rnn.init_state,
    ...     temperature=1.25, bos_index=0, eos_index=0, min_decode_ratio=0.0,
    ...     max_decode_ratio=1.0, beam_size=3, coverage_penalty=1.5,
    ...     using_max_attn_shift=True, max_attn_shift=2)
    >>> hyps, scores = searcher(torch.randn(2, 6, 5), torch.ones(2))
    >>> len(hyps), scores.shape
    (2, (2,))
    """

    def __init__(self, embedding_fn, decoder_step_fn, linear_fn,
                 dec_hidden_size, attn_init_fn, rnn_init_fn,
                 ctc_linear_fn=None, temperature=1.0, **kwargs):
        super().__init__(**kwargs)
        self._init_rnn_hooks(embedding_fn, decoder_step_fn, linear_fn,
                             dec_hidden_size, attn_init_fn, rnn_init_fn)
        self.ctc_linear_fn = ctc_linear_fn
        self.temperature = temperature

    def _scores(self, logits):
        return torch.log_softmax(logits / self.temperature, dim=-1)

    def ctc_forward_step(self, enc_states):
        """CTC log-probabilities (B, T, V) in float32."""
        return torch.log_softmax(self.ctc_linear_fn(enc_states).float(), -1)


class S2SRNNBeamSearchLM(S2SRNNBeamSearcher):
    """``S2SRNNBeamSearcher`` with shallow fusion of a language model at
    ``lm_weight`` (JAX ``S2SRNNBeamSearchLM``):

    lm_step_fn : (tokens (n,), lm_memory) -> (log_probs (n, V), lm_memory):
        one LM step on the tokens that the search fed the decoder (bos
        first).
    lm_init_fn : n -> the first ``lm_memory``, every tensor's leading
        axis the n rows (the search reorders them by predecessor).

    With ``RNNLM.step`` the memory is the LSTM's (h, c), a fixed size:
    each step costs one token.  (The JAX recipe's step concatenates each
    token onto the prefix and reruns it whole, which JAX's device loop
    refuses: its carry changes shape.)
    """

    def __init__(self, lm_step_fn, lm_init_fn, **kwargs):
        super().__init__(**kwargs)
        self.lm_step_fn = lm_step_fn
        self.lm_init_fn = lm_init_fn

    def reset_lm_mem(self, n):
        """Initial LM memory for a fresh search."""
        return self.lm_init_fn(n)

    def lm_forward_step(self, inp_tokens, memory):
        """One LM step: (log_probs (n, V), updated LM memory)."""
        return self.lm_step_fn(inp_tokens, memory)


def inflate_tensor(tensor, times, dim):
    """Repeat-interleave along ``dim``.

    Example
    -------
    >>> inflate_tensor(torch.tensor([[1., 2.], [3., 4.]]), 2, dim=0).tolist()
    [[1.0, 2.0], [1.0, 2.0], [3.0, 4.0], [3.0, 4.0]]
    """
    return torch.repeat_interleave(tensor, times, dim=dim)


def mask_by_condition(tensor, cond, fill_value):
    """Keep values where ``cond`` is True, else ``fill_value``.

    Example
    -------
    >>> mask_by_condition(torch.tensor([[1., 2.], [3., 4.]]),
    ...     torch.tensor([[True, False], [True, True]]), 0).tolist()
    [[1.0, 0.0], [3.0, 4.0]]
    """
    return torch.where(cond, tensor, fill_value)


def filter_seq2seq_output(string_pred, eos_id=-1):
    """A predicted sequence up to its first eos (exclusive).

    Example
    -------
    >>> filter_seq2seq_output(['a', 'b', 'c', 'eos', 'e'], eos_id='eos')
    ['a', 'b', 'c']
    """
    if not isinstance(string_pred, list):
        raise ValueError("The input must be a list.")
    try:
        return string_pred[: string_pred.index(eos_id)]
    except ValueError:
        return string_pred


def batch_filter_seq2seq_output(prediction, eos_id=-1):
    """``filter_seq2seq_output`` of each sequence in a batch.

    Example
    -------
    >>> batch_filter_seq2seq_output([[1, 2, 3, -1], [4, -1, 5]])
    [[1, 2, 3], [4]]
    """
    return [filter_seq2seq_output(list(seq), eos_id=eos_id)
            for seq in prediction]
