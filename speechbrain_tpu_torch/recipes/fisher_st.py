"""The Fisher-Callhome Spanish -> English speech translation recipes end
to end, on the port, and their tokenizer recipe.

Does what ``recipes/Fisher-Callhome-Spanish/ST/transformer/train.py``
does with ``hparams/transformer.yaml`` (``HPARAMS_TRANSFORMER``) or
``hparams/conformer.yaml`` (``HPARAMS_CONFORMER``): the manifests
``<data_folder>/{train,dev,test}.json`` (``{id: {wav, duration,
transcription, translation_0}}``, made outside the recipe; the repo has
no Fisher preparation, and ``write_synthetic_fisher`` writes such a
folder) -> a BPE ``SentencePiece`` of 500 pieces over the train
manifest's ``translation_0`` -> shuffled batches of 8 read from disk ->
``ST.fit``: Fbank (80 mels, 10 ms hop) -> global normalization -> the
conv front end -> ``TransformerST`` at d_model 256, 4 heads, 12 encoder
and 6 decoder layers, d_ffn 1024 (a transformer encoder with regularMHA,
or a conformer encoder with kernel 31 and RelPosMHAXL) with its ASR
decoder -> the loss (1 - w_asr) KL(translation) + w_asr w_ctc CTC(the
Spanish transcript, over ``ctc_lin`` of the encoder states) + w_asr
(1 - w_ctc) KL(the transcript, over ``asr_lin`` of the ASR decoder),
w_asr = w_ctc = 0.3, label smoothing 0.1; fp32, Adam under Noam (1e-3,
10000 warmup steps), clipped at 5 -> outside training the BLEU of the
teacher-forced argmax of the translation head -> keep the best BLEU ->
the test from the best checkpoint.  A killed run resumes from its latest
checkpoint when ``run`` is called again on the same output folder.

Properties of the JAX script that the port copies (ROADMAP Queue 3 pins
each):

- One tokenizer for both languages: it is trained on the English
  ``translation_0`` only and also encodes the Spanish transcripts.
- The BLEU's hypotheses are the argmax over the whole padded row of the
  teacher-forced translation decoder: positions past the eos and past the
  reference's length are decoded too (no search).

and one it does not: the JAX script appends each batch's references as
one segment (``[refs]``), so each batch's first hypothesis is held to all
of them and the others to none; the port holds each hypothesis to its
own reference.

``train_tokenizer`` does what ``recipes/Fisher-Callhome-Spanish/
Tokenizer/train.py`` does with ``train_bpe_1k.yaml`` (``TOKENIZER_BPE_1K``):
a BPE model of 1000 pieces on ``<data_folder>/train.json``'s
``translation_0``, in ``output_folder``.

``overrides`` replace any value of the dict, e.g. toy dims for the CPU::

    from speechbrain_tpu_torch.recipes import fisher_st
    brain = fisher_st.run("/data/fisher", "results/st_conformer",
                          run_opts={"device": "cpu"},
                          hparams=fisher_st.HPARAMS_CONFORMER,
                          overrides={"d_model": 32, ...})
"""

import json
import os
import wave

import numpy as np

from ..core import Stage
from ..dataio.dataio import read_audio
from ..dataio.dataset import DynamicItemDataset
from ..nnet.losses import ctc_loss, kldiv_loss
from ..st import ST_DEFAULTS, STBrain
from ..tokenizers.SentencePiece import SentencePiece
from ..utils.bleu import BLEUStats
from ..utils.checkpoints import Checkpointer
from ..utils.epoch_loop import EpochCounter
from ..utils.train_logger import FileTrainLogger
from .common import recipe_hparams
from .taigi_st import loaders

__all__ = ["HPARAMS_TRANSFORMER", "HPARAMS_CONFORMER", "TOKENIZER_BPE_1K",
           "teacher_forced_words", "ST", "make_datasets", "build", "run", "train_tokenizer",
           "write_synthetic_fisher"]

SAMPLERATE = 16000

# recipes/Fisher-Callhome-Spanish/ST/transformer/hparams/transformer.yaml
HPARAMS_TRANSFORMER = dict(
    ST_DEFAULTS,
    seed=8886,
    vocab_size=500,
    token_type="bpe",
    batch_size=8,
    number_of_epochs=50,
    lr_adam=0.001,
    n_warmup_steps=10000,
    precision="fp32",
    grad_accumulation_factor=1,
    label_smoothing=0.1,
    ctc_weight=0.3,
    asr_weight=0.3,
    d_model=256,
    nhead=4,
    num_encoder_layers=12,
    num_decoder_layers=6,
    d_ffn=1024,
    transformer_dropout=0.1,
    sorting="random",
    num_workers=0,
)
# hparams/conformer.yaml: the conformer encoder
HPARAMS_CONFORMER = dict(HPARAMS_TRANSFORMER, encoder_module="conformer",
                         attention_type="RelPosMHAXL", kernel_size=31)

# recipes/Fisher-Callhome-Spanish/Tokenizer/hparams/train_bpe_1k.yaml
TOKENIZER_BPE_1K = dict(
    token_type="bpe",
    token_output=1000,
    character_coverage=1.0,
    annotation_read="translation_0",
)


def teacher_forced_words(logp, batch, tokenizer, target):
    """The real rows' teacher-forced argmax of ``logp`` (every position of
    the padded row) and their references ``batch[target]`` (lengths
    ``batch[target + "_lens"]``), decoded to words by ``tokenizer``:
    ``(hyps, refs)``."""
    real = int(batch["batch_mask"].sum())
    hyp_ids = logp.argmax(-1)[:real].cpu().numpy()
    hyps = [tokenizer([h.tolist()], task="decode_from_list")[0]
            for h in hyp_ids]
    refs = tokenizer(batch[target][:real].cpu().numpy().tolist(),
                     batch[f"{target}_lens"][:real].cpu().numpy(),
                     task="decode")
    return hyps, refs


class ST(STBrain):
    """The Fisher script's ``ST`` Brain (``train.py:27-155``):
    ``STBrain``'s forward with both ASR heads, the three-term loss (see
    the module), and outside training the BLEU of the translation head's
    argmax over the real rows' whole padded rows, decoded by
    ``self.tokenizer`` to words, each against its reference.  The VALID
    stage logs and keeps the best BLEU."""

    TARGET = "trans_tokens"

    def on_stage_start(self, stage, epoch=None):
        """The normalization's epoch; a BLEU metric outside training."""
        super().on_stage_start(stage, epoch)
        if stage != Stage.TRAIN:
            self.bleu_metric = BLEUStats()

    def compute_objectives(self, predictions, batch, stage):
        """(1 - w_asr) KL(ST) + w_asr w_ctc CTC + w_asr (1 - w_ctc)
        KL(ASR), each ``batchmean``; outside training the BLEU."""
        st_logp, ctc_logp, asr_logp = predictions
        c = self.config
        w_asr, w_ctc = c["asr_weight"], c["ctc_weight"]
        mask = batch["batch_mask"]
        loss = (1 - w_asr) * kldiv_loss(
            st_logp, batch["trans_tokens_eos"],
            length=batch["trans_tokens_eos_lens"] * mask,
            label_smoothing=c["label_smoothing"], reduction="batchmean")
        if ctc_logp is not None:
            loss = loss + w_asr * w_ctc * ctc_loss(
                ctc_logp, batch["src_tokens"], batch["sig_lens"] * mask,
                batch["src_tokens_lens"] * mask,
                blank_index=c["blank_index"], reduction="batchmean",
                use_kernels=self.use_kernels)
        if asr_logp is not None:
            loss = loss + w_asr * (1 - w_ctc) * kldiv_loss(
                asr_logp, batch["src_tokens_eos"],
                length=batch["src_tokens_eos_lens"] * mask,
                label_smoothing=c["label_smoothing"], reduction="batchmean")
        if stage != Stage.TRAIN and hasattr(self, "bleu_metric"):
            hyps, refs = self.argmax_words(st_logp, batch)
            self.bleu_metric.append([str(i) for i in range(len(hyps))], hyps,
                                    [[r] for r in refs])
        return loss

    def argmax_words(self, st_logp, batch):
        """``teacher_forced_words`` of the translation."""
        return teacher_forced_words(st_logp, batch, self.tokenizer,
                                    self.TARGET)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """The recipe's logging and keep-best checkpoint."""
        if stage == Stage.TRAIN:
            return
        stats = {"loss": stage_loss,
                 "BLEU": self.bleu_metric.summarize("BLEU")}
        self.log_and_keep(stage, stage_loss, epoch, stats)


def make_datasets(hparams, tokenizer):
    """The train, valid and test datasets (``hparams["<split>_json"]``):
    ``sig``, ``translation_0`` as ``trans_tokens``/``_bos``/``_eos`` and
    ``transcription`` as ``src_tokens``/``_bos``/``_eos``, both through
    ``tokenizer`` (bos and eos at ``bos_index``/``eos_index``), with
    ``id``.  Returns a dict by split name."""
    def encode(text):
        tokens = tokenizer.sp.encode_as_ids(text)
        return (np.asarray(tokens, np.int64),
                np.asarray([hparams["bos_index"]] + tokens, np.int64),
                np.asarray(tokens + [hparams["eos_index"]], np.int64))

    out = {}
    for split in ("train", "valid", "test"):
        ds = DynamicItemDataset.from_json(hparams[f"{split}_json"])
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
        for key, prefix in (("translation_0", "trans"),
                            ("transcription", "src")):
            ds.add_dynamic_item(
                encode, takes=key,
                provides=[f"{prefix}_tokens", f"{prefix}_tokens_bos",
                          f"{prefix}_tokens_eos"])
        ds.set_output_keys(["id", "sig", "trans_tokens", "trans_tokens_bos",
                            "trans_tokens_eos", "src_tokens",
                            "src_tokens_bos", "src_tokens_eos"])
        out[split] = ds
    return out


def build(data_folder, output_folder, overrides=None, run_opts=None,
          hparams=HPARAMS_TRANSFORMER):
    """Everything ``run`` trains with, built as the script's ``__main__``
    builds it (``train.py:211-245``): the tokenizer (trained on the train
    manifest unless its model file exists), the loaders, and an ``ST``
    Brain with a ``Checkpointer`` on ``<output_folder>/save`` (the Noam
    schedule registered), a ``FileTrainLogger`` on ``<output_folder>/
    train_log.txt`` and the tokenizer.  The manifests are read from
    ``data_folder``.

    ``hparams`` is ``HPARAMS_TRANSFORMER`` or ``HPARAMS_CONFORMER``;
    ``overrides`` replace its values; ``run_opts`` are the ``Brain``'s
    (``device``: None for the CUDA card, "cpu" to ask for the CPU).
    Returns a dict with ``brain``, ``epoch_counter``, ``train_loader``,
    ``valid_loader``, ``test_loader``, ``tokenizer`` and ``hparams``."""
    hp = dict(hparams)
    for key, name in (("train_json", "train"), ("valid_json", "dev"),
                      ("test_json", "test")):
        hp[key] = os.path.join(data_folder, f"{name}.json")
    hp = recipe_hparams(hp, data_folder, output_folder, overrides)
    tokenizer = SentencePiece(
        model_dir=hp["save_folder"], vocab_size=hp["vocab_size"],
        annotation_train=hp["train_json"], annotation_read="translation_0",
        model_type=hp["token_type"], annotation_format="json")
    lds = loaders(hp, make_datasets(hp, tokenizer))
    epoch_counter = EpochCounter(hp["number_of_epochs"])
    brain = ST(hp, seed=hp["seed"], run_opts=run_opts,
               hparams=dict(hp, train_logger=FileTrainLogger(hp["train_log"]),
                            epoch_counter=epoch_counter),
               checkpointer=Checkpointer(hp["save_folder"]),
               tokenizer=tokenizer)
    return {"brain": brain, "epoch_counter": epoch_counter,
            "train_loader": lds["train"], "valid_loader": lds["valid"],
            "test_loader": lds["test"], "tokenizer": tokenizer,
            "hparams": hp}


def run(data_folder, output_folder, overrides=None, run_opts=None,
        hparams=HPARAMS_TRANSFORMER):
    """The script's ``__main__``: ``build``, ``fit`` (resuming from the
    latest checkpoint in ``<output_folder>/save``), then ``evaluate`` on
    the test set from the checkpoint with the best BLEU.  Arguments as for
    ``build``; returns the Brain (``brain.stage_stats`` holds the last
    VALID and TEST stats)."""
    parts = build(data_folder, output_folder, overrides, run_opts, hparams)
    brain = parts["brain"]
    brain.fit(parts["epoch_counter"], parts["train_loader"],
              parts["valid_loader"])
    brain.evaluate(parts["test_loader"], max_key="BLEU")
    return brain


def train_tokenizer(data_folder, output_folder, hparams=TOKENIZER_BPE_1K,
                    overrides=None):
    """``Tokenizer/train.py``: a ``SentencePiece`` of ``token_output``
    pieces of ``token_type`` on ``<data_folder>/train.json``'s
    ``annotation_read``, saved in ``output_folder`` (kept when its file
    exists).  Returns the tokenizer."""
    hp = dict(hparams, **(overrides or {}))
    return SentencePiece(
        model_dir=output_folder, vocab_size=hp["token_output"],
        annotation_train=os.path.join(data_folder, "train.json"),
        annotation_read=hp["annotation_read"], annotation_format="json",
        model_type=hp["token_type"],
        character_coverage=hp["character_coverage"])


_SPANISH = ("hola", "bueno", "pues", "sí", "no", "claro", "qué", "cómo",
            "está", "usted", "mi", "familia", "trabajo", "ciudad", "año",
            "mañana", "hablar", "teléfono", "niños", "español", "mucho",
            "verdad", "entonces", "también", "casa", "allá", "gente")
_ENGLISH = ("hello", "well", "so", "yes", "no", "sure", "what", "how",
            "is", "you", "my", "family", "work", "city", "year", "tomorrow",
            "talk", "phone", "children", "spanish", "a", "lot", "right",
            "then", "also", "house", "there", "people", "the", "of")


def write_synthetic_fisher(folder, counts, seconds=(2.0, 8.0),
                           n_words=(3, 12), seed=0):
    """Write the manifests the Fisher recipes read, with synthetic audio:
    ``counts`` maps 'train', 'dev' and 'test' to their numbers of
    utterances, each a 16 kHz 16-bit PCM WAV under ``wav/`` (noise plus
    two tones lasting ``seconds``, uniform), listed in ``<split>.json`` as
    ``{id: {wav, duration, transcription, translation_0}}`` with
    ``n_words`` (uniform) Spanish words (accented) and as many English
    ones.  Everything comes from ``seed``.

    Example
    -------
    >>> import tempfile
    >>> d = tempfile.mkdtemp()
    >>> write_synthetic_fisher(d, {"dev": 2}, seconds=(0.2, 0.3))
    >>> sorted(json.load(open(d + "/dev.json"))["dev-0000"])
    ['duration', 'transcription', 'translation_0', 'wav']
    """
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(folder, "wav"), exist_ok=True)
    for split, n in sorted(counts.items()):
        manifest = {}
        for i in range(n):
            utt = f"{split}-{i:04d}"
            path = os.path.join(folder, "wav", utt + ".wav")
            samples = int(rng.uniform(*seconds) * SAMPLERATE)
            t = np.arange(samples) / SAMPLERATE
            f1, f2 = rng.uniform(100, 3000, 2)
            sig = (0.05 * rng.standard_normal(samples)
                   + 0.2 * np.sin(2 * np.pi * f1 * t)
                   + 0.1 * np.sin(2 * np.pi * f2 * t))
            pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SAMPLERATE)
                w.writeframes(pcm.tobytes())
            k = int(rng.integers(n_words[0], n_words[1] + 1))
            manifest[utt] = {
                "wav": path,
                "duration": samples / SAMPLERATE,
                "transcription": " ".join(rng.choice(_SPANISH, k)),
                "translation_0": " ".join(rng.choice(_ENGLISH, k)),
            }
        with open(os.path.join(folder, f"{split}.json"), "w",
                  encoding="utf-8") as f:
            json.dump(manifest, f, indent=2, ensure_ascii=False)
