"""frontend.lower_s: host seconds the process spent in repro_torch's
``lower_spec`` (the ahead-of-time transform) by the time the metrics are
read: every engine built in set-up, the tuner's candidates too.

None where the program keeps no such counter."""
from repro_torch.core.transform import lower_spec


def read(run):
    return getattr(lower_spec, "seconds", None)
