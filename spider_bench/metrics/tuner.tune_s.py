"""tuner.tune_s: host seconds the process spent tuning, in ``autotune``
under ``plan_for`` (``default_cache().stats.tune_s``); 0 where every plan
was found in the plan file.

None where the program keeps no such counter."""


def read(run):
    from repro_torch.tuner.cache import default_cache
    return getattr(default_cache().stats, "tune_s", None)
