"""Kernel launches on the card in the traced stretch, per train step."""


def read(trace):
    steps = trace.counts.get('steps')
    if not steps or not trace.launches:
        return None
    return len(trace.launches) / steps
