#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s phases spend their wall time, on a CUDA card.

Runs ``chip_smoke.main`` with each of its module-level helpers (and
``ConformerASR.__init__``, ``asr.build_transformer_lm`` and
``asr._random_init``) wrapped in a timer, and every ``_profile`` call
timed whole beside the wall time it traced: the difference is
torch.profiler's collection of the events.  Arguments go to
``chip_smoke.py``:

    python3 tools/smoke_timing.py --phase serve,serve_lm

Prints what ``chip_smoke.py`` prints, then one line
``TIMING {"inclusive_s": {helper: seconds}, "calls": {helper: n},
"profiles": [{"total_s", "traced_s", "cpu"}]}``.
"""

import collections
import functools
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TOTAL = collections.defaultdict(float)
COUNT = collections.Counter()
PROFILES = []


def _timed(name, fn):
    @functools.wraps(fn)
    def wrap(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            TOTAL[name] += time.perf_counter() - t0
            COUNT[name] += 1
    return wrap


def _profile(profile):
    @functools.wraps(profile)
    def wrap(fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = profile(fn, *args, **kwargs)
        PROFILES.append({"total_s": time.perf_counter() - t0,
                         "traced_s": out["profiled_wall_ms"] / 1e3,
                         "cpu": kwargs.get("cpu", True)})
        return out
    return wrap


def main():
    import speechbrain_tpu_torch.asr as asr

    for name, obj in list(vars(chip_smoke).items()):
        if (callable(obj) and not isinstance(obj, type)
                and getattr(obj, "__module__", None) == "chip_smoke"
                and name not in ("main", "emit", "_profile")):
            setattr(chip_smoke, name, _timed(name, obj))
    chip_smoke._profile = _profile(chip_smoke._profile)
    for name in ("build_transformer_lm", "_random_init"):
        setattr(asr, name, _timed(f"asr.{name}", getattr(asr, name)))
    asr.ConformerASR.__init__ = _timed("ConformerASR.__init__",
                                       asr.ConformerASR.__init__)
    sys.argv = ["chip_smoke.py"] + sys.argv[1:]
    try:
        return chip_smoke.main()
    finally:
        print("TIMING " + json.dumps({
            "inclusive_s": dict(sorted(TOTAL.items(), key=lambda kv: -kv[1])),
            "calls": dict(COUNT), "profiles": PROFILES}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
