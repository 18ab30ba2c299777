#!/usr/bin/env python3
"""How well conditioned the ECAPA step's float32 gradients are, on the
CPU: the VoxCeleb ``SpeakerBrain`` at ``train_ecapa_tdnn.yaml``'s widths
(random weights from seed 0, the AAM head of 7205 classes, augmentation
off) on B 8 x 2 s of noise, once in float64 and once in float32, in eval
mode and in training mode (where the BatchNorms' batch statistics enter
the backward).  For each mode it prints the loss's relative difference
and the three gradients furthest from the float64 ones, each as
``max |g32 - g64| / max(max |g64|, 5 % of the largest gradient)``, the
measure ``tests/test_torch_cuda.py::test_ecapa_step_on_the_card_matches_the_cpu``
holds the card to.

    python3 tools/ecapa_precision_study.py   # ~1 min on 8 cores

Prints one JSON object: {mode: {"loss_rel": x, "worst": [[dev, name],
...]}}.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from speechbrain_tpu_torch.core import Stage  # noqa: E402
from speechbrain_tpu_torch.recipes.voxceleb_speaker import SpeakerBrain  # noqa: E402


def main():
    rng = np.random.default_rng(0)
    host = {"sig": (0.1 * rng.standard_normal((8, 32000))).astype(np.float32),
            "sig_lens": rng.uniform(0.5, 1.0, 8).astype(np.float32),
            "spk_id_encoded": rng.integers(0, 7205, 8)}
    out = {}
    for mode in ("eval", "train"):
        runs = []
        for dtype in (torch.float32, torch.float64):
            brain = SpeakerBrain({"augmentation": None},
                                 run_opts={"device": "cpu", "seed": 0})
            for name in ("embedding_model", "classifier"):
                brain.modules[name].to(dtype)
            brain.dtype = dtype
            brain.modules.train(mode == "train")
            batch = brain.prepare_batch(host)
            names, params = zip(*brain.modules.named_parameters())
            loss = brain.compute_objectives(
                brain.compute_forward(batch, Stage.TRAIN), batch, Stage.TRAIN)
            grads = torch.autograd.grad(loss, params)
            runs.append((float(loss.detach()), [g.double() for g in grads]))
        (l32, g32), (l64, g64) = runs
        G = max(float(g.abs().max()) for g in g64)
        worst = sorted(
            ([float((a - b).abs().max()) / max(float(b.abs().max()), 0.05 * G),
              n] for n, a, b in zip(names, g32, g64)), reverse=True)[:3]
        out[mode] = {"loss_rel": abs(l32 - l64) / abs(l64), "worst": worst}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
