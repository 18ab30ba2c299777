"""Transducer (RNN-T) decoding.

Counterpart of ``speechbrain_tpu/decoders/transducer.py``
(``TransducerBeamSearcher``), with the same constructor, the same
search rules and the same results:

- greedy (``beam_size`` 1): a loop over the frames that stays on the
  device (JAX's ``lax.scan``); every row steps the prediction network
  each frame and only the emitting rows keep the new output and state;
- the host lockstep beam search, the reference hypothesis loop run for
  all utterances at once (what ``__call__`` runs for ``beam_size`` > 1,
  and so the recipe's test search), with the optional LM fusion;
- the fixed-shape device beam search (no LM): masked hypothesis tensors
  stepped by one batched loop over the utterances, where JAX vmaps one
  ``lax.while_loop`` per utterance.

The prediction network and the joint are callables, as in JAX:
``decode_fn(tokens (n,) int or None, state, n) -> (pred_out (n, Hp),
state)`` (``None``: the start state, which the recipe computes from the
blank token) and ``joint_fn(enc (..., He), pred (..., Hp)) -> logits``.
A state is a tensor, ``None``, or a dict, list or tuple of them, each
leaf batch-leading.  No kernel of this repository runs here: the joint
and the prediction network are plain products in JAX too.
"""

import warnings

import numpy as np
import torch

__all__ = ["TransducerBeamSearcher"]

NEG = -1e30
# the device beam asks the host whether every row is done once every
# this many iterations; iterations on a row that is done change nothing
_DONE_CHECK_EVERY = 16


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (and the matching leaves
    of ``rest``); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    raise TypeError(f"state leaf of type {type(tree).__name__}")


def _tree_cat(trees):
    if len(trees) == 1:
        return trees[0]
    return _tree_map(lambda *xs: torch.cat(xs, 0), trees[0], *trees[1:])


def _tree_slice(tree, j):
    return _tree_map(lambda x: x[j:j + 1], tree)


def _rows_where(mask, new, old):
    """``torch.where`` of two trees on a mask over their leading axes."""
    def pick(n, o):
        return torch.where(mask.view(mask.shape + (1,) * (o.dim() - mask.dim())),
                           n, o)
    return _tree_map(pick, new, old)


def _take(tree, idx):
    """Entries ``idx`` (B,) or (B, M) of (B, N, ...) storage, per row."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    if idx.dim() == 2:
        rows = rows[:, None]
    return _tree_map(lambda x: x[rows, idx], tree)


def _top_k(x, k):
    """The k largest along the last axis, equal values in ascending index
    order (``jax.lax.top_k``'s order; ``torch.topk`` leaves it open)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


class TransducerBeamSearcher:
    """Transducer decoding interface.

    Arguments
    ---------
    decode_fn : pred_step_fn(tokens (n,) or None, state, n) ->
        (pred_out (n, Hp), state); tokens None = blank/start state.
    joint_fn : (enc_frames (..., He), pred_out (..., Hp)) -> logits
    blank_id : int
    beam_size : int (1 = greedy on the device)
    nbest : int
    lm_fn, lm_weight : optional shallow fusion (host beam only):
        ``lm_fn(tokens (n,), state or None) -> (log-probs (n, V), state)``,
        the tokens being each hypothesis's last (blank at the start).
    state_beam, expand_beam : pruning (reference defaults 2.3 / 2.3)
    max_expand_per_frame : int or None
        The starvation valve: after this many expansions on one frame
        with the beam not full, the frame is force-advanced (promoting
        the best hypotheses if the beam is empty), where the reference
        loop would never end.  Default (None) = 10 x beam_size;
        ``float("inf")`` turns it off.  ``forced_advance_count`` counts
        the frames so advanced in the last host beam search (0 on runs
        that follow the reference exactly), and the first one in a
        searcher's life raises a ``RuntimeWarning``.

    Example
    -------
    >>> emb = torch.eye(3)
    >>> def pred_step(tokens, state, n):
    ...     tok = torch.zeros(n, dtype=torch.long) if tokens is None else tokens
    ...     return emb[tok], None
    >>> search = TransducerBeamSearcher(pred_step, lambda e, p: e - 2 * p,
    ...     blank_id=0, beam_size=1)
    >>> enc = torch.tensor([[[0.0, 3.0, 0.0], [3.0, 0.0, 0.0],
    ...     [0.0, 0.0, 3.0]]])
    >>> search(enc)[0]
    [[1, 2]]
    """

    def __init__(self, decode_fn, joint_fn, blank_id, beam_size=4, nbest=5,
                 lm_fn=None, lm_weight=0.0, state_beam=2.3, expand_beam=2.3,
                 max_expand_per_frame=None):
        if max_expand_per_frame is None:
            max_expand_per_frame = 10 * beam_size
        self.max_expand_per_frame = max_expand_per_frame
        self.pred_step_fn = decode_fn
        self.joint_fn = joint_fn
        self.blank_id = blank_id
        self.beam_size = beam_size
        self.nbest = nbest
        self.lm_fn = lm_fn
        self.lm_weight = lm_weight
        self.state_beam = state_beam
        self.expand_beam = expand_beam
        self.forced_advance_count = 0
        self._warned_forced = False

    def __call__(self, enc_states, enc_lens=None):
        if self.beam_size == 1:
            return self.transducer_greedy_decode(enc_states, enc_lens)
        return self.transducer_beam_search_decode(enc_states, enc_lens)

    def _abs_lens(self, enc_states, enc_lens):
        """Frames per row, ``round(enc_lens * T)`` in float32 with half to
        even (``jnp.round``), as the device paths count them."""
        B, T = enc_states.shape[0], enc_states.shape[1]
        if enc_lens is None:
            return torch.full((B,), T, dtype=torch.long, device=enc_states.device)
        lens = torch.as_tensor(enc_lens).to(enc_states.device, torch.float32)
        return torch.round(lens * T).long()

    # ------------------------------------------------------------ greedy

    def transducer_greedy_decode(self, enc_states, enc_lens=None):
        """Greedy: (B, T, H) -> (hyps, scores numpy)."""
        tokens, scores = self.transducer_greedy_decode_device(enc_states,
                                                              enc_lens)
        hyps = [[t for t in row if t != self.blank_id]
                for row in tokens.tolist()]
        return hyps, scores.cpu().numpy()

    @torch.no_grad()
    def transducer_greedy_decode_device(self, enc_states, enc_lens=None):
        """Device-only greedy core: (B, T, H) -> (tokens (B, T) int64
        with blank at the frames that emit nothing, scores (B,) float32).
        No host sync: one loop over the frames."""
        B, T = enc_states.shape[0], enc_states.shape[1]
        abs_lens = self._abs_lens(enc_states, enc_lens)
        pred_out, state = self.pred_step_fn(None, None, B)
        score = torch.zeros(B, dtype=torch.float32, device=enc_states.device)
        tokens = []
        for t in range(T):
            logits = self.joint_fn(enc_states[:, t], pred_out)
            log_probs = torch.log_softmax(logits.float(), dim=-1)
            token = log_probs.argmax(-1)
            tok_lp = log_probs.amax(-1)
            valid = t < abs_lens
            emit = (token != self.blank_id) & valid
            # the prediction network steps every row; the emitting ones
            # keep its output and state
            new_pred_out, new_state = self.pred_step_fn(token, state, B)
            pred_out = _rows_where(emit, new_pred_out, pred_out)
            state = _rows_where(emit, new_state, state)
            score = score + torch.where(valid, tok_lp, 0.0)
            tokens.append(torch.where(emit, token, self.blank_id))
        if not tokens:
            return (torch.full((B, 0), self.blank_id, dtype=torch.long,
                               device=enc_states.device), score)
        return torch.stack(tokens, 1), score

    # ------------------------------------------------- fixed-shape beam

    @torch.no_grad()
    def transducer_beam_search_device(self, enc_states, enc_lens=None,
                                      max_symbols=100):
        """Beam search on fixed-shape tensors (no LM): the host lockstep
        loop's rules (length-normalised a_best, raw-score state_beam,
        the top-k-gated blank extension, expand_beam, the starvation
        valve) on masked hypothesis storage, one batched loop with a
        row's own frame, expansion and iteration counters.  A row whose
        loop condition is false is left as it is; the host asks whether
        every row is done once every ``_DONE_CHECK_EVERY`` iterations.

        Arguments
        ---------
        enc_states : (B, T, H) encoder states
        enc_lens : optional (B,) relative lengths
        max_symbols : int
            Token-buffer capacity per hypothesis; emissions beyond it
            are dropped (scores still accumulate, and the normalised
            score divides by the capped length).

        Returns
        -------
        (tokens (B, max_symbols) int64 padded with blank_id,
         lengths (B,) int64, norm_scores (B,) float32)
        """
        if self.lm_fn is not None and self.lm_weight > 0:
            raise NotImplementedError(
                "device beam path does not support LM fusion; use the "
                "host lockstep loop")
        c, cap = self._beam_device_init(enc_states, enc_lens, max_symbols)
        while bool(self._active(c, cap).any()):
            for _ in range(_DONE_CHECK_EVERY):
                c = self._beam_device_step(c, enc_states, cap)
        return self._beam_device_result(c)

    def _max_expand(self):
        return int(min(self.max_expand_per_frame, 1_000_000))

    def _beam_device_init(self, enc_states, enc_lens, U):
        """The loop's carry (per-row counters and the beam (K) and
        process (P) storage, process slot 0 holding the start entry) and
        the per-row iteration cap."""
        B, T = enc_states.shape[0], enc_states.shape[1]
        dev = enc_states.device
        K = self.beam_size
        max_expand = self._max_expand()
        P = K + max_expand * K  # the process set's worst case
        abs_len = self._abs_lens(enc_states, enc_lens)
        pred_out0, state0 = self.pred_step_fn(None, None, B)
        entry0 = {
            "tok": torch.full((B, U), self.blank_id, dtype=torch.long,
                              device=dev),
            "len": torch.zeros(B, dtype=torch.long, device=dev),
            "score": torch.zeros(B, dtype=torch.float32, device=dev),
            "pred_out": pred_out0,
            "state": state0,
        }

        def store(n):
            return _tree_map(
                lambda x: torch.zeros((B, n) + x.shape[1:], dtype=x.dtype,
                                      device=dev), entry0)

        proc = store(P)
        first = torch.arange(P, device=dev)[None, :] == 0
        proc = _rows_where(first.expand(B, P),
                           _tree_map(lambda x: x[:, None], entry0), proc)
        zeros = torch.zeros(B, dtype=torch.long, device=dev)
        carry = {
            "t": zeros, "done": abs_len <= 0, "nexp": zeros, "iter": zeros,
            "abs_len": abs_len,
            "beam": store(K),
            "beam_mask": torch.zeros(B, K, dtype=torch.bool, device=dev),
            "proc": proc, "proc_mask": first.expand(B, P).clone(),
        }
        return carry, T * (max_expand + 2) + 4

    @staticmethod
    def _active(c, cap):
        return ~c["done"] & (c["iter"] < cap)

    @staticmethod
    def _norm(st, mask):
        return torch.where(mask, st["score"] / (st["len"].float() + 1.0), NEG)

    def _advance_frame(self, c):
        """Frame boundary: promote if starved, move beam -> process."""
        K = self.beam_size
        starved = ~c["beam_mask"].any(1)
        _, top_idx = _top_k(self._norm(c["proc"], c["proc_mask"]), K)
        beam = _rows_where(starved, _take(c["proc"], top_idx), c["beam"])
        beam_mask = torch.where(starved[:, None],
                                c["proc_mask"].gather(1, top_idx), c["beam_mask"])
        t1 = c["t"] + 1
        done = t1 >= c["abs_len"]
        proc = _tree_map(lambda b, p: torch.cat([b, p[:, K:]], 1),
                         beam, c["proc"])
        proc_mask = torch.cat([beam_mask, torch.zeros_like(c["proc_mask"][:, K:])], 1)
        return {
            "t": t1, "done": done, "nexp": torch.zeros_like(c["nexp"]),
            "iter": c["iter"] + 1, "beam": beam,
            "beam_mask": beam_mask & done[:, None],
            "proc": proc, "proc_mask": proc_mask & ~done[:, None],
        }

    def _expand(self, c, a_idx, enc_states):
        """Pop process[a_idx], run the joint, add the blank extension to
        the beam and the accepted expansions to free process slots."""
        K = self.beam_size
        B, T = enc_states.shape[0], enc_states.shape[1]
        dev = enc_states.device
        rows = torch.arange(B, device=dev)
        a = _take(c["proc"], a_idx)
        proc_mask = c["proc_mask"].clone()
        proc_mask[rows, a_idx] = False
        enc_t = enc_states[rows, c["t"].clamp(max=T - 1)]
        lp = torch.log_softmax(self.joint_fn(enc_t, a["pred_out"]).float(), -1)
        top_lp, top_tok = _top_k(lp, K)
        is_blank = top_tok == self.blank_id
        blank_in_topk = is_blank.any(1)
        # the best non-blank over every token (the reference's top-1 or
        # top-2, which is exactly that)
        vocab = torch.arange(lp.shape[-1], device=dev)
        best_logp = lp.masked_fill(vocab == self.blank_id, NEG).amax(1)
        # blank extension: a_best + the blank score into the first free
        # beam slot (an expansion implies one is free)
        free_b = c["beam_mask"].to(torch.uint8).argmin(1)
        at_free = (torch.arange(K, device=dev)[None, :] == free_b[:, None]) \
            & blank_in_topk[:, None]
        blank_entry = dict(a, score=a["score"] + lp[:, self.blank_id])
        beam = _rows_where(at_free, _tree_map(lambda x: x[:, None], blank_entry),
                           c["beam"])
        beam_mask = c["beam_mask"] | at_free
        # non-blank expansions: one prediction-network step for the K
        # candidates of every row
        accept = ~is_blank & (top_lp >= best_logp[:, None] - self.expand_beam)
        state_k = _tree_map(
            lambda x: x[:, None].expand((B, K) + x.shape[1:]).reshape(
                (B * K,) + x.shape[1:]), a["state"])
        new_pred_out, new_state = self.pred_step_fn(top_tok.reshape(-1),
                                                    state_k, B * K)
        U = a["tok"].shape[1]
        at_len = torch.arange(U, device=dev)[None, None, :] == a["len"][:, None, None]
        cand = {
            "tok": torch.where(at_len, top_tok[..., None], a["tok"][:, None, :]),
            "len": torch.clamp(a["len"] + 1, max=U)[:, None].expand(B, K),
            "score": a["score"][:, None] + top_lp,
            "pred_out": new_pred_out.reshape((B, K) + new_pred_out.shape[1:]),
            "state": _tree_map(lambda x: x.reshape((B, K) + x.shape[1:]),
                               new_state),
        }
        # the accepted candidates, in rank order, go to the free process
        # slots in ascending order
        perm = torch.sort((~accept).to(torch.uint8), dim=1, stable=True).indices
        n_acc = accept.sum(1)
        free = ~proc_mask
        free_rank = free.long().cumsum(1) - 1
        takes = free & (free_rank < n_acc[:, None])
        src = perm.gather(1, free_rank.clamp(0, K - 1))
        proc = _rows_where(takes, _take(cand, src), c["proc"])
        return {
            "t": c["t"], "done": c["done"], "nexp": c["nexp"] + 1,
            "iter": c["iter"] + 1, "beam": beam, "beam_mask": beam_mask,
            "proc": proc, "proc_mask": proc_mask | takes,
        }

    def _beam_device_step(self, c, enc_states, cap):
        """One iteration for every row: JAX's ``body`` with both branches
        of its ``lax.cond`` computed and picked per row, applied only to
        the rows whose loop condition holds."""
        K = self.beam_size
        beam_n = c["beam_mask"].sum(1)
        proc_any = c["proc_mask"].any(1)
        forced = (c["nexp"] >= self._max_expand()) & (beam_n < K) & proc_any
        advance = (beam_n >= K) | ~proc_any | forced
        pnorm = self._norm(c["proc"], c["proc_mask"])
        a_idx = pnorm.argmax(1)
        a_raw = c["proc"]["score"].gather(1, a_idx[:, None])[:, 0]
        b_idx = self._norm(c["beam"], c["beam_mask"]).argmax(1)
        b_raw = c["beam"]["score"].gather(1, b_idx[:, None])[:, 0]
        advance = advance | (c["beam_mask"].any(1)
                             & (b_raw >= self.state_beam + a_raw))
        adv = self._advance_frame(c)
        exp = self._expand(c, a_idx, enc_states)
        active = self._active(c, cap)
        out = dict(c)
        for key in adv:
            out[key] = _rows_where(active & advance, adv[key],
                                   _rows_where(active & ~advance, exp[key],
                                               c[key]))
        return out

    def _beam_device_result(self, c):
        fnorm = self._norm(c["beam"], c["beam_mask"])
        best = fnorm.argmax(1)
        any_beam = c["beam_mask"].any(1)
        best_entry = _take({k: c["beam"][k] for k in ("tok", "len")}, best)
        tokens = torch.where(any_beam[:, None], best_entry["tok"], self.blank_id)
        length = torch.where(any_beam, best_entry["len"], 0)
        score = torch.where(any_beam, fnorm.gather(1, best[:, None])[:, 0], NEG)
        return tokens, length, score

    # ------------------------------------------------ host lockstep beam

    @torch.no_grad()
    def transducer_beam_search_decode(self, enc_states, enc_lens=None):
        """The reference beam search, batched lockstep across utterances.

        Per utterance, the reference hypothesis loop: length-normalised
        hypothesis selection, the state_beam early stop, the top-k-gated
        blank extension, expand_beam pruning.  Each lockstep round, every
        utterance still decoding contributes one chosen hypothesis; the
        joint evaluations (and the prediction-network expansions, and
        the LM steps) of a round go to the device as one batch each, and
        the log-probabilities come back to the host once a round.
        Returns ``(hyps, scores numpy)``: each utterance's best token list
        and its normalised score.
        """
        B, T = enc_states.shape[0], enc_states.shape[1]
        dev = enc_states.device
        if enc_lens is None:
            abs_lens = [T] * B
        else:
            abs_lens = [int(round(float(x) * T))
                        for x in torch.as_tensor(enc_lens).cpu().numpy()]

        def norm_key(x):
            # the reference divides by len(prediction) with the initial
            # blank counted -> +1 (the tokens are stored alone here)
            return x["logp_score"] / (len(x["prediction"]) + 1)

        self.forced_advance_count = 0
        pred_out0, state0 = self.pred_step_fn(None, None, 1)
        utts = []
        for b in range(B):
            hyp = {"prediction": [], "logp_score": 0.0, "pred_out": pred_out0,
                   "state": state0, "lm_state": None}
            utts.append({"b": b, "t": -1, "process": [], "beam": [hyp],
                         "done": False, "nexp": 0})

        def next_a_best(u):
            """Advance one utterance's control flow (frame boundaries,
            beam-filled / state_beam exits) to its next expansion point;
            returns the popped a_best hyp, or None when decoding ends."""
            while True:
                if u["done"]:
                    return None
                forced = (u["nexp"] >= self.max_expand_per_frame
                          and len(u["beam"]) < self.beam_size
                          and bool(u["process"]))
                advance = (len(u["beam"]) >= self.beam_size
                           or not u["process"] or forced)
                a_best = None
                if not advance:
                    a_best = max(u["process"], key=norm_key)
                    if u["beam"]:
                        b_best = max(u["beam"], key=norm_key)
                        if (b_best["logp_score"]
                                >= self.state_beam + a_best["logp_score"]):
                            advance = True
                if advance:
                    if forced or not u["beam"]:
                        # the valve fired: the frame advanced without a
                        # full beam of blank extensions
                        self.forced_advance_count += 1
                        if not self._warned_forced:
                            self._warned_forced = True
                            # stacklevel: the search's caller, past
                            # torch.no_grad's wrapper
                            warnings.warn(
                                "TransducerBeamSearcher: a frame was "
                                "force-advanced by max_expand_per_frame"
                                " (blank starvation — the reference "
                                "loop would not terminate here); "
                                "results may diverge from reference "
                                "semantics.  See "
                                "forced_advance_count for how often.",
                                RuntimeWarning, stacklevel=4)
                    if not u["beam"]:
                        # blank-starved frame: promote the best
                        # surviving hypotheses
                        u["beam"] = sorted(u["process"], key=norm_key,
                                           reverse=True)[:self.beam_size] \
                            or u["beam"]
                    u["t"] += 1
                    u["nexp"] = 0
                    if u["t"] >= abs_lens[u["b"]]:
                        u["done"] = True
                        return None
                    u["process"] = u["beam"]
                    u["beam"] = []
                    continue
                # by identity: hypotheses hold tensors, which == cannot
                # compare
                del u["process"][next(i for i, h in enumerate(u["process"])
                                      if h is a_best)]
                u["nexp"] += 1
                return a_best

        use_lm = self.lm_fn is not None and self.lm_weight > 0
        while True:
            chosen = []  # (utt_index, a_best_hyp)
            for b in range(B):
                h = next_a_best(utts[b])
                if h is not None:
                    chosen.append((b, h))
            if not chosen:
                break
            where = torch.tensor([[b, utts[b]["t"]] for b, _ in chosen],
                                 device=dev)
            enc_batch = enc_states[where[:, 0], where[:, 1]]
            pred_batch = torch.cat([h["pred_out"] for _, h in chosen], 0)
            logits = self.joint_fn(enc_batch, pred_batch)
            log_probs = torch.log_softmax(logits.float(), -1).cpu().numpy()
            expansions = []  # (utt_index, hyp, tok, chosen_row)
            for i, (b, a_best_hyp) in enumerate(chosen):
                lp = log_probs[i]
                order = np.argsort(-lp)
                best_logp = (lp[order[0]] if order[0] != self.blank_id
                             else lp[order[1]])
                # only the top-k candidates count; the blank extension
                # exists only when blank made the top-k
                for tok in order[:self.beam_size]:
                    tok = int(tok)
                    if tok == self.blank_id:
                        utts[b]["beam"].append({
                            "prediction": list(a_best_hyp["prediction"]),
                            "logp_score": a_best_hyp["logp_score"]
                            + float(lp[self.blank_id]),
                            "pred_out": a_best_hyp["pred_out"],
                            "state": a_best_hyp["state"],
                            "lm_state": a_best_hyp["lm_state"],
                        })
                        continue
                    if float(lp[tok]) < best_logp - self.expand_beam:
                        continue
                    expansions.append((b, a_best_hyp, tok, i))
            if not expansions:
                continue
            lm_scores_row, lm_state_row = {}, {}
            if use_lm:
                # one LM step per group and round, for the chosen rows
                # that expanded; rows without an LM state yet and rows
                # carrying one are batched apart
                rows = sorted({i for _, _, _, i in expansions})
                fresh = [i for i in rows if chosen[i][1]["lm_state"] is None]
                carry = [i for i in rows if i not in fresh]
                for grp in (fresh, carry):
                    if not grp:
                        continue
                    # the LM's start token is blank_id
                    lm_tokens = torch.tensor(
                        [(chosen[i][1]["prediction"] or [self.blank_id])[-1]
                         for i in grp], dtype=torch.long, device=dev)
                    lm_state_in = (None if grp is fresh else _tree_cat(
                        [chosen[i][1]["lm_state"] for i in grp]))
                    scores, new_lm_state = self.lm_fn(lm_tokens, lm_state_in)
                    scores = scores.float().cpu().numpy()
                    for j, i in enumerate(grp):
                        lm_scores_row[i] = scores[j]
                        lm_state_row[i] = _tree_slice(new_lm_state, j)
            tokens = torch.tensor([tok for _, _, tok, _ in expansions],
                                  dtype=torch.long, device=dev)
            states = _tree_cat([h["state"] for _, h, _, _ in expansions])
            pred_out, new_state = self.pred_step_fn(tokens, states,
                                                    len(expansions))
            for j, (b, a_best_hyp, tok, i) in enumerate(expansions):
                new_hyp = {
                    "prediction": a_best_hyp["prediction"] + [tok],
                    "logp_score": a_best_hyp["logp_score"]
                    + float(log_probs[i, tok]),
                    "pred_out": pred_out[j:j + 1],
                    "state": _tree_slice(new_state, j),
                    "lm_state": a_best_hyp["lm_state"],
                }
                if use_lm:
                    new_hyp["logp_score"] += self.lm_weight * float(
                        lm_scores_row[i][tok])
                    new_hyp["lm_state"] = lm_state_row[i]
                utts[b]["process"].append(new_hyp)

        nbest_hyps, nbest_scores = [], []
        for b in range(B):
            beam_hyps = sorted(utts[b]["beam"], key=norm_key, reverse=True)
            if not beam_hyps:  # fully starved utterance: empty hyp
                beam_hyps = [{"prediction": [], "logp_score": float("-inf")}]
            best = beam_hyps[:self.nbest]
            nbest_hyps.append(best[0]["prediction"])
            nbest_scores.append(norm_key(best[0]))
        return nbest_hyps, np.asarray(nbest_scores)
