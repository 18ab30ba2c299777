"""TIMIT seq2seq knowledge distillation end to end, on the port: the
teachers' ensemble posteriors (``save_teachers``) and the student
(``KD``, ``run_kd``).

Does what ``recipes/TIMIT/ASR/seq2seq_knowledge_distillation/
save_teachers.py`` and ``train_kd.py`` do with ``hparams/
save_teachers.yaml`` (``HPARAMS_SAVE_TEACHERS``) and ``hparams/
train_kd.yaml`` (``HPARAMS_KD``: ``timit_seq2seq.HPARAMS`` with
``kd_weight`` 0.5).  The teachers are ``timit_seq2seq`` runs
(``timit_seq2seq.run(..., overrides=TEACHERS[name])``); ``save_teachers``
restores each from its checkpoint with the lowest validation PER, runs
the train, valid and test sets through it in eval mode in loader order
(batches of ``batch_size``), stores for each utterance ``exp`` of its
CTC and attention log-probabilities rounded to float16, sums them over
the teachers in float32, divides by their number, rounds back to float16
and writes ``<output_folder>/ensemble_<split>.npz`` with the keys
``<utt>__ctc`` and ``<utt>__seq`` (each array as long as its batch's
padding: its length depends on the batch it was in).  ``run_kd`` trains
the student on the recipe's data with the teachers' arrays as
``teacher_ctc`` and ``teacher_seq``: the loss is ``(1 - kd_weight)`` x
the seq2seq recipe's loss + ``kd_weight`` x (``ctc_weight`` x
``ctc_loss_kd`` against the ensemble's greedy CTC path + (1 -
``ctc_weight``) x ``nll_loss_kd`` against its attention posteriors), the
teacher arrays cut to the student's frames and tokens.

The posteriors' folder is an argument of ``run_kd``: JAX's
``train_kd.yaml`` reads ``<save_folder>/teacher_posteriors`` while
``save_teachers.py`` writes to its own ``output_folder``, so the JAX
defaults do not meet.
"""

import os

import numpy as np
import torch

from ..core import Stage
from ..dataio.dataloader import SaveableDataLoader
from ..nnet.losses import ctc_loss_kd, nll_loss_kd
from . import timit_seq2seq
from .timit_ctc import dataio_prep

__all__ = ["HPARAMS_KD", "HPARAMS_SAVE_TEACHERS", "save_teachers",
           "teacher_posteriors", "KD", "build_kd", "run_kd"]

# seq2seq_knowledge_distillation/hparams/train_kd.yaml: train.yaml and
# the distillation's weight
HPARAMS_KD = dict(timit_seq2seq.HPARAMS, kd_weight=0.5)

# seq2seq_knowledge_distillation/hparams/save_teachers.yaml
HPARAMS_SAVE_TEACHERS = dict(seed=1234, batch_size=8, teachers=("tea0",))

SPLITS = ("train", "valid", "test")


@torch.no_grad()
def teacher_posteriors(brain, batch):
    """One batch through a teacher in eval mode (its normalization
    frozen, no dropout): ``(ctc log-probs, seq log-probs)`` as float32
    numpy arrays (B, T, C) and (B, U + 1, C), and the batch mask."""
    brain.modules.eval()
    dbatch = brain.prepare_batch(batch)
    ctc_logp, seq_logp, _ = brain.compute_forward(dbatch, Stage.TEST)
    return (ctc_logp.float().cpu().numpy(), seq_logp.float().cpu().numpy(),
            dbatch["batch_mask"].cpu().numpy())


def ensemble_arrays(teacher_outputs, n_teachers):
    """The ensemble's arrays of one split from its teachers' outputs:
    ``teacher_outputs`` yields ``(ids, ctc_logp, seq_logp, mask)`` per
    batch per teacher; each real row's ``exp`` is rounded to float16,
    summed over the teachers in float32, divided by ``n_teachers`` and
    rounded to float16 again (``save_teachers.py:97-120``).  Returns
    ``{"<utt>__ctc": ..., "<utt>__seq": ...}``."""
    store = {}
    for ids, ctc_logp, seq_logp, mask in teacher_outputs:
        for i, utt in enumerate(ids):
            if i >= len(mask) or mask[i] == 0:
                continue
            p_ctc = np.exp(ctc_logp[i]).astype(np.float16)
            p_seq = np.exp(seq_logp[i]).astype(np.float16)
            if utt in store:
                store[utt][0] += p_ctc.astype(np.float32)
                store[utt][1] += p_seq.astype(np.float32)
            else:
                store[utt] = [p_ctc.astype(np.float32),
                              p_seq.astype(np.float32)]
    arrays = {}
    for utt, (p_ctc, p_seq) in store.items():
        arrays[f"{utt}__ctc"] = (p_ctc / n_teachers).astype(np.float16)
        arrays[f"{utt}__seq"] = (p_seq / n_teachers).astype(np.float16)
    return arrays


def save_teachers(data_folder, output_folder, teachers, run_opts=None,
                  batch_size=HPARAMS_SAVE_TEACHERS["batch_size"]):
    """``save_teachers.py``'s ``main``: ``teachers`` lists ``(folder,
    overrides)`` pairs, each a trained ``timit_seq2seq`` run's output
    folder and the overrides of ``timit_seq2seq.HPARAMS`` it ran with
    (e.g. ``TEACHERS["tea3"]`` with toy dims).  Writes
    ``<output_folder>/ensemble_{train,valid,test}.npz`` (see the module)
    and returns their paths by split."""
    os.makedirs(output_folder, exist_ok=True)
    outputs = {split: [] for split in SPLITS}
    for folder, overrides in teachers:
        parts = timit_seq2seq.build(data_folder, folder, overrides, run_opts)
        brain = parts["brain"]
        brain.checkpointer.recover_if_possible(min_key="PER")
        for split in SPLITS:
            loader = SaveableDataLoader(parts["datasets"][split],
                                        batch_size=batch_size)
            for batch in loader:
                outputs[split].append(
                    (batch.id, *teacher_posteriors(brain, batch)))
        del brain, parts
    paths = {}
    for split in SPLITS:
        paths[split] = os.path.join(output_folder, f"ensemble_{split}.npz")
        np.savez_compressed(paths[split], **ensemble_arrays(
            outputs[split], len(teachers)))
    return paths


class KD(timit_seq2seq.ASR):
    """The student's ``ASR`` Brain of ``train_kd.py`` (l.36-187): the
    teacher's Brain whose ``compute_objectives`` also distils.  With
    ``w = kd_weight`` and ``c = ctc_weight``, the loss is ``(1 - w)`` x
    ``ground_truth_loss`` + ``w`` x (``c`` x ``ctc_loss_kd(ctc log-probs,
    teacher_ctc)`` (K3/K4 on the card; input lengths ``sig_lens *
    batch_mask``) + ``(1 - c)`` x ``nll_loss_kd(seq log-probs,
    teacher_seq)`` (lengths ``phn_encoded_eos_lens * batch_mask``)), the
    student's and the teacher's arrays cut to the fewer frames (CTC) and
    tokens (attention) of the two.  A batch also holds ``teacher_ctc``
    (B, T', C) and ``teacher_seq`` (B, U', C) float32 probabilities."""

    @staticmethod
    def make_datasets(hparams):
        """``timit_ctc.dataio_prep(seq2seq=True)``'s datasets with the
        ensemble's arrays of each utterance (``teacher_ctc``,
        ``teacher_seq``: float32) read from
        ``<teacher_posteriors_folder>/ensemble_<split>.npz``."""
        datasets, label_encoder = dataio_prep(hparams, seq2seq=True)
        for split, ds in datasets.items():
            store = np.load(os.path.join(
                hparams["teacher_posteriors_folder"],
                f"ensemble_{split}.npz"))
            ds.add_dynamic_item(
                lambda utt, store=store: (
                    store[f"{utt}__ctc"].astype(np.float32),
                    store[f"{utt}__seq"].astype(np.float32)),
                takes="id", provides=["teacher_ctc", "teacher_seq"])
            ds.set_output_keys(["id", "sig", "phn_encoded", "phn_encoded_bos",
                                "phn_encoded_eos", "teacher_ctc",
                                "teacher_seq"])
        return datasets, label_encoder

    def compute_objectives(self, predictions, batch, stage):
        """The blended loss; outside training, the search's PER."""
        ctc_logp, seq_logp, enc = predictions
        hp = self.hparams
        mask = batch["batch_mask"]
        loss_gt = self.ground_truth_loss(ctc_logp, seq_logp, batch)
        tea_ctc, tea_seq = batch["teacher_ctc"], batch["teacher_seq"]
        Tc = min(ctc_logp.shape[1], tea_ctc.shape[1])
        loss_ctc_kd = ctc_loss_kd(ctc_logp[:, :Tc], tea_ctc[:, :Tc],
                                  batch["sig_lens"] * mask,
                                  blank_index=hp.blank_index,
                                  use_kernels=self.use_kernels)
        Us = min(seq_logp.shape[1], tea_seq.shape[1])
        loss_seq_kd = nll_loss_kd(seq_logp[:, :Us], tea_seq[:, :Us],
                                  batch["phn_encoded_eos_lens"] * mask)
        loss_kd = (hp.ctc_weight * loss_ctc_kd
                   + (1 - hp.ctc_weight) * loss_seq_kd)
        self._score(enc, batch, stage)
        return (1 - hp.kd_weight) * loss_gt + hp.kd_weight * loss_kd


def build_kd(data_folder, output_folder, posteriors_folder, overrides=None,
             run_opts=None):
    """``timit_seq2seq.build`` for the student (``HPARAMS_KD``, the
    ``KD`` Brain) reading the ensemble's arrays from
    ``posteriors_folder`` (``save_teachers``' output folder)."""
    return timit_seq2seq.build(
        data_folder, output_folder,
        dict(overrides or {}, teacher_posteriors_folder=posteriors_folder),
        run_opts, hparams=HPARAMS_KD, brain_class=KD)


def run_kd(data_folder, output_folder, posteriors_folder, overrides=None,
           run_opts=None):
    """``train_kd.py``'s ``__main__`` (l.255-301): ``build_kd``, ``fit``
    (resuming from the latest checkpoint in ``<output_folder>/save``),
    ``evaluate`` on the test set at ``test_beam_size`` from the
    checkpoint with the lowest validation PER.  Returns the Brain."""
    parts = build_kd(data_folder, output_folder, posteriors_folder,
                     overrides, run_opts)
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.evaluate(parts["test_loader"], min_key="PER")
    return brain
