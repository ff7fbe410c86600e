"""Model FLOPs of the rooms served in the traced run's untraced lead
(``flops.py``: the backbone's and point heads' forward, from each room's
own rulebooks; the refinement head's keyed convs are not counted) over
the lead's time and the card's bf16 peak, in %.  The lead, not the
profiled stretch: the profiler slows the host."""

from portbench.roofline import MFU_PEAK


def read(trace):
    f, t = trace.counts.get('lead_flops'), trace.counts.get('lead_s')
    if not f or not t:
        return None
    return 100.0 * f / (t * MFU_PEAK)
