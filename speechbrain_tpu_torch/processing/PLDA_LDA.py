"""PLDA/LDA speaker-verification backend, in torch float64.

Counterpart of ``speechbrain_tpu/processing/PLDA_LDA.py`` (numpy there):
the statistics containers ``StatObject_SB``, ``Ndx`` and ``Scores``,
``LDA``, ``PLDA`` with its EM training and ``fast_PLDA_scoring``, and the
helpers ``diff``, ``ismember`` and ``fa_model_loop``.  The statistics are
float64 tensors on the caller's device (the device of the ``stat1``
given, the CPU for arrays); the labels (``modelset``, ``segset``) and the
trial mask stay numpy arrays on the host, as bookkeeping.

Two loops of the JAX code are batched: the E-step's loop over speakers
inverts the (classes, r, r) precisions in one ``torch.linalg.inv``, and
the scoring's loop over (model, test) pairs is two quadratic forms and
one bilinear form over all pairs.  ``F`` is initialised from ``eigh``,
whose column signs may differ between LAPACK builds; the scores depend
on ``F`` only through ``F F^T``.
"""

import copy
import pickle

import numpy as np
import torch

__all__ = [
    "StatObject_SB",
    "Ndx",
    "Scores",
    "LDA",
    "PLDA",
    "fast_PLDA_scoring",
    "diff",
    "ismember",
    "fa_model_loop",
]


def _f64(x, device=None):
    if x is None:
        return torch.zeros(0, dtype=torch.float64, device=device)
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float64, device=device)


def _labels(x):
    return (np.asarray(x, dtype="<U100") if x is not None
            else np.empty(0, "<U100"))


class StatObject_SB:
    """Zero- and first-order statistics of segments: ``modelset`` and
    ``segset`` (string arrays), ``start``/``stop``, ``stat0`` (N, 1) and
    ``stat1`` (N, dim) float64 tensors, both on ``stat1``'s device.

    Example
    -------
    >>> st = StatObject_SB(modelset=["a", "a", "b"], segset=["1", "2", "3"],
    ...                    stat0=np.ones((3, 1)),
    ...                    stat1=np.array([[1.0, 0.0], [3.0, 2.0], [5.0, 4.0]]))
    >>> st.get_mean_stat1().tolist()
    [3.0, 2.0]
    >>> sums, counts = st.sum_stat_per_model()
    >>> sums.stat1.tolist(), counts.tolist()
    ([[4.0, 2.0], [5.0, 4.0]], [2.0, 1.0])
    """

    def __init__(self, modelset=None, segset=None, start=None, stop=None,
                 stat0=None, stat1=None):
        self.modelset = _labels(modelset)
        self.segset = _labels(segset)
        n = len(self.segset)
        self.start = start if start is not None else np.empty(n, dtype="|O")
        self.stop = stop if stop is not None else np.empty(n, dtype="|O")
        self.stat1 = _f64(stat1)
        self.stat0 = _f64(stat0, self.stat1.device)

    def save_stat_object(self, filename):
        """Pickle this stat object to disk."""
        with open(filename, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(filename):
        """A stat object pickled by ``save_stat_object``."""
        with open(filename, "rb") as f:
            return pickle.load(f)

    def _rows(self, mod_id):
        return torch.as_tensor(np.flatnonzero(self.modelset == mod_id),
                               device=self.stat1.device)

    def get_mean_stat1(self):
        """Mean of the first-order stats over segments."""
        return self.stat1.mean(0)

    def get_total_covariance_stat1(self):
        """Total (biased) covariance of the first-order stats."""
        C = self.stat1 - self.get_mean_stat1()
        return C.T @ C / self.stat1.shape[0]

    def get_model_stat0(self, mod_id):
        """Zero-order stats of one model id."""
        return self.stat0[self._rows(mod_id)]

    def get_model_stat1(self, mod_id):
        """First-order stats of one model id."""
        return self.stat1[self._rows(mod_id)]

    def sum_stat_per_model(self):
        """The stats summed over each model's (speaker's) segments, the
        models sorted, and the number of segments of each (a float64
        tensor)."""
        unique, inverse = np.unique(self.modelset, return_inverse=True)
        dev = self.stat1.device
        index = torch.as_tensor(inverse.reshape(-1), device=dev)
        sts = StatObject_SB()
        sts.modelset = unique
        sts.segset = unique
        sts.stat0 = torch.zeros(len(unique), self.stat0.shape[1],
                                dtype=torch.float64, device=dev).index_add_(
            0, index, self.stat0)
        sts.stat1 = torch.zeros(len(unique), self.stat1.shape[1],
                                dtype=torch.float64, device=dev).index_add_(
            0, index, self.stat1)
        counts = torch.bincount(index, minlength=len(unique)).to(
            torch.float64)
        sts.start = np.empty(len(unique), "|O")
        sts.stop = np.empty(len(unique), "|O")
        return sts, counts

    def center_stat1(self, mu):
        """Subtract mu from the first-order stats."""
        self.stat1 = self.stat1 - _f64(mu, self.stat1.device)

    def norm_stat1(self):
        """L2-normalize the first-order stats per segment."""
        norms = torch.linalg.vector_norm(self.stat1, dim=1, keepdim=True)
        self.stat1 = self.stat1 / norms.clamp(min=1e-12)

    def rotate_stat1(self, R):
        """Multiply the first-order stats by R on the right."""
        self.stat1 = self.stat1 @ _f64(R, self.stat1.device)

    def whiten_stat1(self, mu, sigma):
        """Center by mu, then whiten by sigma's eigendecomposition
        (eigenvalues in decreasing order, floored at 1e-12)."""
        eigvals, eigvecs = torch.linalg.eigh(_f64(sigma, self.stat1.device))
        eigvals, eigvecs = eigvals.flip(0), eigvecs.flip(1)
        W = eigvecs * (1.0 / torch.sqrt(eigvals.clamp(min=1e-12)))
        self.center_stat1(mu)
        self.stat1 = self.stat1 @ W


class Ndx:
    """Trial index: which (model, test segment) pairs to score.
    ``modelset``/``segset`` are the sorted unique ids, ``trialmask`` the
    (models, segments) boolean array.

    Example
    -------
    >>> ndx = Ndx(models=["m2", "m1", "m2"], testsegs=["t1", "t1", "t2"])
    >>> ndx.modelset.tolist(), ndx.trialmask.tolist()
    (['m1', 'm2'], [[True, False], [True, True]])
    """

    def __init__(self, models=None, testsegs=None):
        models, testsegs = _labels(models), _labels(testsegs)
        self.modelset = np.unique(models)
        self.segset = np.unique(testsegs)
        self.trialmask = np.zeros((len(self.modelset), len(self.segset)),
                                  dtype=bool)
        self.trialmask[np.searchsorted(self.modelset, models),
                       np.searchsorted(self.segset, testsegs)] = True


class Scores:
    """A score matrix aligned with an ``Ndx``: ``scoremat`` (models,
    segments) float64 tensor, ``scoremask`` the trials scored."""

    def __init__(self):
        self.modelset = np.empty(0, "<U100")
        self.segset = np.empty(0, "<U100")
        self.scoremask = np.array([], dtype=bool)
        self.scoremat = torch.zeros(0, dtype=torch.float64)


def _class_means(stat_server):
    """Each model's mean, the inverse index and the counts."""
    unique, inverse = np.unique(stat_server.modelset, return_inverse=True)
    x = stat_server.stat1
    index = torch.as_tensor(inverse.reshape(-1), device=x.device)
    counts = torch.bincount(index, minlength=len(unique)).to(torch.float64)
    sums = torch.zeros(len(unique), x.shape[1], dtype=torch.float64,
                       device=x.device).index_add_(0, index, x)
    return sums / counts[:, None], index, counts


class LDA:
    """Linear discriminant analysis over a stat object: the leading
    eigenvectors of ``(Sw + 1e-9 I)^-1 Sb``.

    Example
    -------
    >>> rng = np.random.default_rng(0)
    >>> x = rng.normal(size=(12, 3)) + np.repeat(np.eye(3) * 4, 4, 0)
    >>> st = StatObject_SB(modelset=np.repeat(["a", "b", "c"], 4),
    ...                    segset=[str(i) for i in range(12)],
    ...                    stat0=np.ones((12, 1)), stat1=x)
    >>> LDA().do_lda(st, reduced_dim=2).stat1.shape
    torch.Size([12, 2])
    """

    def __init__(self):
        self.transform_mat = None

    def do_lda(self, stat_server, reduced_dim=2):
        """Fit the projection; returns a copy of the stat object with its
        first-order stats projected."""
        x = stat_server.stat1
        dim = x.shape[1]
        means, index, counts = _class_means(stat_server)
        mu = stat_server.get_mean_stat1()
        within = x - means[index]
        Sw = within.T @ within / len(stat_server.segset)
        d = means - mu
        Sb = (d * counts[:, None]).T @ d / len(stat_server.segset)
        eye = torch.eye(dim, dtype=torch.float64, device=x.device)
        vals, vecs = torch.linalg.eig(torch.linalg.solve(Sw + 1e-9 * eye, Sb))
        order = torch.argsort(-vals.real)
        self.transform_mat = vecs.real[:, order[:reduced_dim]]
        out = copy.deepcopy(stat_server)
        out.rotate_stat1(self.transform_mat)
        return out


class PLDA:
    """PLDA with an EM-trained speaker subspace: ``x = mean + F h + eps``,
    ``eps ~ N(0, Sigma)``; ``plda(stat_server)`` fits ``mean``, ``F``
    (dim, rank) and ``Sigma`` (dim, dim) from speaker-labelled vectors.

    ``F`` starts as the ``min(rank_f, dim)`` leading eigenvectors of the
    total covariance and ``Sigma`` as that covariance; each of
    ``nb_iter`` iterations takes every speaker's posterior of ``h``
    (precision ``I + n_c F^T Sigma^-1 F``, all speakers in one batched
    inverse), then ``F`` from the accumulated moments and ``Sigma`` as
    the symmetrised residual covariance plus 1e-6 I.

    Example
    -------
    >>> rng = np.random.default_rng(0)
    >>> spk = np.repeat(np.arange(6), 5)
    >>> x = rng.normal(size=(6, 4))[spk] + 0.3 * rng.normal(size=(30, 4))
    >>> st = StatObject_SB(modelset=spk.astype(str),
    ...                    segset=[str(i) for i in range(30)],
    ...                    stat0=np.ones((30, 1)), stat1=x)
    >>> plda = PLDA(rank_f=2).plda(st)
    >>> tuple(plda.F.shape), tuple(plda.Sigma.shape)
    ((4, 2), (4, 4))
    """

    def __init__(self, mean=None, F=None, Sigma=None, rank_f=100, nb_iter=10,
                 scaling_factor=1.0):
        self.mean = mean
        self.F = F
        self.Sigma = Sigma
        self.rank_f = rank_f
        self.nb_iter = nb_iter
        self.scaling_factor = scaling_factor

    def plda(self, stat_server, output_file_name=None):
        """EM training on a stat object of speaker-labelled vectors."""
        x = stat_server.stat1
        vect_size = x.shape[1]
        self.mean = stat_server.get_mean_stat1()
        rank_f = min(self.rank_f, vect_size)
        sums, counts = stat_server.sum_stat_per_model()
        sums.stat0 = sums.stat0 * self.scaling_factor
        sums.stat1 = sums.stat1 * self.scaling_factor
        counts = counts * self.scaling_factor

        sigma_obs = stat_server.get_total_covariance_stat1()
        evals, evecs = torch.linalg.eigh(sigma_obs)
        idx = torch.argsort(evals, descending=True)
        self.F = evecs[:, idx[:rank_f]]
        self.Sigma = sigma_obs.clone()
        eye_r = torch.eye(rank_f, dtype=torch.float64, device=x.device)
        eye_d = torch.eye(vect_size, dtype=torch.float64, device=x.device)
        total = max(float(counts.sum()), 1.0)
        for _ in range(self.nb_iter):
            local_stat1 = sums.stat1 - counts[:, None] * self.mean[None, :]
            # E-step, every speaker at once
            FtS = self.F.T @ torch.linalg.inv(self.Sigma)  # (r, d)
            prec = eye_r + counts[:, None, None] * (FtS @ self.F)
            cov = torch.linalg.inv(prec)  # (classes, r, r)
            mu_h = (cov @ (local_stat1 @ FtS.T)[..., None])[..., 0]
            R_acc = ((counts[:, None, None] * cov).sum(0)
                     + (counts[:, None] * mu_h).T @ mu_h)
            T_acc = mu_h.T @ local_stat1  # (r, d)
            # M-step
            self.F = torch.linalg.solve(R_acc, T_acc).T
            resid = sigma_obs - self.F @ (T_acc / total)
            self.Sigma = 0.5 * (resid + resid.T) + 1e-6 * eye_d
        return self


def fast_PLDA_scoring(enroll, test, ndx, mu, F, Sigma, test_uncertainty=None,
                      Vtrans=None, p_known=0.0, scaling_factor=1.0,
                      check_missing=True):
    """The log-likelihood ratio of "same speaker" against "different
    speakers" for every trial of ``ndx``: enroll models by ``modelset``,
    test segments by ``segset``, centred on ``mu``; the same-speaker
    pair is Gaussian with covariance ``[[S, F F^T], [F F^T, S]]``,
    ``S = Sigma + F F^T``.  Returns ``Scores`` with a (models, segments)
    float64 ``scoremat``, 0 outside the trial mask.

    Example
    -------
    >>> rng = np.random.default_rng(0)
    >>> F = rng.normal(size=(3, 2)); Sigma = np.eye(3)
    >>> st = StatObject_SB(modelset=["a", "b"], segset=["a", "b"],
    ...                    stat0=np.ones((2, 1)), stat1=rng.normal(size=(2, 3)))
    >>> ndx = Ndx(models=["a", "b"], testsegs=["a", "b"])
    >>> s = fast_PLDA_scoring(st, st, ndx, np.zeros(3), F, Sigma)
    >>> s.scoremat.shape, float(s.scoremat[0, 1])
    (torch.Size([2, 2]), 0.0)
    """
    dev = enroll.stat1.device
    mu, F, Sigma = (_f64(a, dev) for a in (mu, F, Sigma))
    e_all = enroll.stat1 - mu
    t_all = test.stat1 - mu
    FFt = F @ F.T
    Sigma_tot = Sigma + FFt
    Sigma_same = torch.cat([torch.cat([Sigma_tot, FFt], 1),
                            torch.cat([FFt, Sigma_tot], 1)], 0)
    inv_tot = torch.linalg.inv(Sigma_tot)
    inv_same = torch.linalg.inv(Sigma_same)
    logdet_tot = torch.linalg.slogdet(Sigma_tot)[1]
    logdet_same = torch.linalg.slogdet(Sigma_same)[1]

    enroll_row = {m: i for i, m in enumerate(enroll.modelset)}
    test_row = {s: i for i, s in enumerate(test.segset)}
    e = e_all[torch.as_tensor([enroll_row[m] for m in ndx.modelset],
                              dtype=torch.long, device=dev)]
    t = t_all[torch.as_tensor([test_row[s] for s in ndx.segset],
                              dtype=torch.long, device=dev)]
    d = e.shape[1]
    A11, A12 = inv_same[:d, :d], inv_same[:d, d:]
    A21, A22 = inv_same[d:, :d], inv_same[d:, d:]
    # [e; t]^T inv_same [e; t] for every pair, its four blocks
    quad_same = (((e @ A11) * e).sum(1)[:, None] + e @ A12 @ t.T
                 + (t @ A21 @ e.T).T + ((t @ A22) * t).sum(1)[None, :])
    ll_same = -0.5 * (quad_same + logdet_same)
    ll_diff = -0.5 * (((e @ inv_tot) * e).sum(1)[:, None]
                      + ((t @ inv_tot) * t).sum(1)[None, :] + 2 * logdet_tot)
    mask = torch.as_tensor(ndx.trialmask, device=dev)
    scores = Scores()
    scores.modelset = ndx.modelset
    scores.segset = ndx.segset
    scores.scoremask = ndx.trialmask
    scores.scoremat = torch.where(mask, (ll_same - ll_diff) * scaling_factor,
                                  torch.zeros((), dtype=torch.float64,
                                              device=dev))
    return scores


def diff(list1, list2):
    """The items of list1 not in list2, sorted.

    Example
    -------
    >>> diff(["b", "a", "c"], ["c"])
    ['a', 'b']
    """
    c = [item for item in list1 if item not in list2]
    c.sort()
    return c


def ismember(list1, list2):
    """Elementwise membership of list1 in list2.

    Example
    -------
    >>> ismember(["a", "z"], ["a", "b"])
    [True, False]
    """
    return [item in list2 for item in list1]


def fa_model_loop(batch_start, mini_batch_indices, factor_analyser, stat0,
                  stat1, e_h, e_hh):
    """The factor analysis's E-step over segments: for each index of
    ``mini_batch_indices`` (rows ``idx + batch_start`` of ``stat0``/
    ``stat1``), the posterior mean ``e_h[idx]`` and second moment
    ``e_hh[idx]`` of the latent factor, written in place (tensors).  A
    2-d ``Sigma`` shares one posterior covariance per distinct
    ``stat0``; a 1-d one takes it per segment.

    Example
    -------
    >>> fa = PLDA(F=torch.eye(2, dtype=torch.float64),
    ...           Sigma=torch.eye(2, dtype=torch.float64))
    >>> e_h = torch.zeros(1, 2, dtype=torch.float64)
    >>> e_hh = torch.zeros(1, 2, 2, dtype=torch.float64)
    >>> fa_model_loop(0, [0], fa, torch.ones(1, 1, dtype=torch.float64),
    ...               torch.ones(1, 2, dtype=torch.float64), e_h, e_hh)
    >>> e_h.tolist()
    [[0.5, 0.5]]
    """
    F = _f64(factor_analyser.F, e_h.device)
    Sigma = _f64(factor_analyser.Sigma, e_h.device)
    rank = F.shape[1]
    eye = torch.eye(rank, dtype=torch.float64, device=F.device)
    if Sigma.dim() == 2:
        A = F.T @ F
        inv_lambda_unique = {float(sess): torch.linalg.inv(sess * A + eye)
                             for sess in torch.unique(stat0[:, 0])}
    for idx in mini_batch_indices:
        row = idx + batch_start
        if Sigma.dim() == 1:
            inv_lambda = torch.linalg.inv(eye + (F.T * stat0[row, :]) @ F)
        else:
            inv_lambda = inv_lambda_unique[float(stat0[row, 0])]
        aux = F.T @ stat1[row, :]
        e_h[idx] = aux @ inv_lambda
        e_hh[idx] = inv_lambda + torch.outer(e_h[idx], e_h[idx])
