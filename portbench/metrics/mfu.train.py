"""Model FLOPs of the train steps of the traced run's untraced lead
(``flops.py``: every layer's forward, input gradient and weight gradient,
from each batch's own rulebooks) over the lead's time (to a synchronise)
and the card's bf16 peak, in %.  The lead, not the profiled stretch: the
profiler slows the host."""

from portbench.roofline import MFU_PEAK


def read(trace):
    f, t = trace.counts.get('lead_flops'), trace.counts.get('lead_s')
    if not f or not t:
        return None
    return 100.0 * f / (t * MFU_PEAK)
