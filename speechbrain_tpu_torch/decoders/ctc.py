"""CTC prefix scoring for joint CTC/attention beam search.

Counterpart of ``speechbrain_tpu/decoders/ctc.py`` (``CTCPrefixScorer``,
without the attention-window option).  The two time recursions are
linear in the log semiring; like the JAX package they run as parallel
prefix scans, here a Hillis-Steele scan of depth ceil(log2 T).
"""

import torch

__all__ = ["CTCPrefixScorer"]


def _semiring_scan(a, b):
    """Inclusive scan over dim 0 of (a1, b1) o (a2, b2) =
    (a1 + a2, logaddexp(b2, a2 + b1)), i.e. of r[t] = logaddexp(r[t-1]
    + a[t], b[t]) from r[-1] = -inf.  Returns the scanned (a, b)."""
    d = 1
    T = a.shape[0]
    while d < T:
        a, b = (
            torch.cat([a[:d], a[:-d] + a[d:]]),
            torch.cat([b[:d], torch.logaddexp(b[d:], a[d:] + b[:-d])]),
        )
        d *= 2
    return a, b


class CTCPrefixScorer:
    """Batched CTC prefix scores for every candidate token of every beam.

    Arguments
    ---------
    x : (batch, T, vocab) CTC log-probs of the encoder states.
    enc_lens : (batch,) relative lengths; frames past round(len * T)
        (round half to even) may emit blank only.
    batch_size, beam_size, blank_index, eos_index : int

    State is a dict of tensors threaded through ``forward_step`` and
    ``permute_mem``; ``init_state`` builds the first one.

    Example
    -------
    >>> x = torch.log_softmax(torch.randn(1, 6, 5), -1)
    >>> sc = CTCPrefixScorer(x, torch.ones(1), 1, 2, 0, 2)
    >>> s, st = sc.forward_step(torch.ones(2, dtype=torch.long), None)
    >>> s.shape
    torch.Size([2, 5])
    """

    def __init__(self, x, enc_lens, batch_size, beam_size, blank_index,
                 eos_index):
        self.blank_index = blank_index
        self.eos_index = eos_index
        self.batch_size = batch_size
        self.beam_size = beam_size
        self.minus_inf = -1e20
        x = x.float()
        T = x.shape[1]
        self.vocab_size = x.shape[-1]
        abs_lens = torch.round(enc_lens.float() * T).long()
        mask = torch.arange(T, device=x.device)[None, :] < abs_lens[:, None]
        pad_row = torch.full((self.vocab_size,), self.minus_inf,
                             device=x.device)
        pad_row[blank_index] = 0.0
        x = torch.where(mask[..., None], x, pad_row)
        self.x = x.repeat_interleave(beam_size, dim=0)  # (n, T, V)
        self.abs_lens = abs_lens.repeat_interleave(beam_size)
        self.T = T
        self.last_frame_index = (self.abs_lens - 1).clamp(0, T - 1)

    def init_state(self):
        """Lattice of the empty prefix: only the blank path is alive."""
        n = self.batch_size * self.beam_size
        r = torch.full((self.T, 2, n), self.minus_inf, device=self.x.device)
        r[:, 1, :] = torch.cumsum(self.x[:, :, self.blank_index], dim=1).T
        return {
            "r": r,
            "psi_prev": torch.zeros(n, device=self.x.device),
            "last_token": torch.full((n,), -1, dtype=torch.long,
                                     device=self.x.device),
            "step": 0,
        }

    def forward_step(self, inp_tokens, state, candidates=None):
        """Delta CTC scores (n, width) of extending each row's prefix by
        each candidate: the (n, K) ``candidates`` ("partial" mode) or
        every vocabulary entry ("full" mode)."""
        if state is None:
            state = self.init_state()
        n = self.batch_size * self.beam_size
        mi = self.minus_inf
        x = self.x
        r_prev = state["r"]  # (T, 2, n)
        psi_prev = state["psi_prev"]
        if candidates is not None:
            K = candidates.shape[1]
            xc = torch.gather(
                x, 2, candidates[:, None, :].expand(n, self.T, K)
            ).transpose(0, 1)  # (T, n, K)
            cand_ids = candidates
        else:
            xc = x.transpose(0, 1)  # (T, n, V)
            cand_ids = torch.arange(self.vocab_size, device=x.device).expand(
                n, self.vocab_size
            )
        width = cand_ids.shape[1]
        r_sum = torch.logaddexp(r_prev[:, 0], r_prev[:, 1])  # (T, n)
        phi = r_sum[:, :, None].expand(self.T, n, width)
        last = state["last_token"]
        same = cand_ids == last[:, None]  # candidate repeats the last token
        phi = torch.where(same[None], r_prev[:, 1][:, :, None], phi)
        xb = x.transpose(0, 1)[:, :, self.blank_index][:, :, None]  # (T, n, 1)

        # the prefix includes bos: recursion starts at max(1, step + 1)
        start = max(1, state["step"] + 1)
        t_idx = torch.arange(1, self.T, device=x.device).reshape(-1, 1, 1)
        bad = t_idx < start
        xc_t = torch.where(bad, mi, xc[1:])
        xb_t = torch.where(bad, mi, xb[1:].expand_as(xc[1:]))
        phix = phi[:-1] + xc[1:]  # phi[t-1] + x[t]
        b_nb = torch.where(bad, mi, phix)
        _, r_nbs_t = _semiring_scan(xc_t, b_nb)
        r_nb0 = torch.full((n, width), mi, device=x.device)
        r_nb_prev_t = torch.cat([r_nb0[None], r_nbs_t[:-1]])
        b_b = torch.where(bad, mi, r_nb_prev_t + xb[1:])
        _, r_bs_t = _semiring_scan(xb_t, b_b)
        psi0 = torch.logaddexp(r_nb0, r_nb0)
        psi = torch.logaddexp(
            psi0, torch.logsumexp(torch.where(bad, mi, phix), dim=0)
        )
        r_nbs = torch.cat([r_nb0[None], r_nbs_t])
        r_bs = torch.cat([r_nb0[None], r_bs_t])
        # eos: the prefix's total score at each row's last valid frame
        final_r_sum = r_sum[self.last_frame_index,
                            torch.arange(n, device=x.device)]
        psi = torch.where(cand_ids == self.eos_index, final_r_sum[:, None], psi)
        psi = torch.where(cand_ids == self.blank_index, mi, psi)
        scores = psi - psi_prev[:, None]
        new_state = {
            "r_all": torch.stack([r_nbs, r_bs], dim=1),  # (T, 2, n, width)
            "psi_all": psi,
            "cand_ids": cand_ids,
            "r": r_prev,
            "psi_prev": psi_prev,
            "last_token": last,
            "step": state["step"] + 1,
        }
        return scores, new_state

    def permute_mem(self, state, index):
        """Commit the chosen candidates: ``index`` (n,) is
        beam_offset * V + token per new row; selects each row's lattice
        for its token and reorders rows by predecessor beam."""
        V = self.vocab_size
        tokens = index % V
        beam_pred = index // V
        batch_idx = torch.arange(
            self.batch_size, device=index.device
        ).repeat_interleave(self.beam_size)
        rows = batch_idx * self.beam_size + beam_pred
        cand_ids = state["cand_ids"]
        pos = (cand_ids[rows] == tokens[:, None]).int().argmax(dim=1)
        return {
            "r": state["r_all"][:, :, rows, pos],  # (T, 2, n)
            "psi_prev": state["psi_all"][rows, pos],
            "last_token": tokens.long(),
            "step": state["step"],
        }
