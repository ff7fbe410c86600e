"""Kernel launches on the card in the traced stretch, per served room."""


def read(trace):
    rooms = trace.counts.get('rooms')
    if not rooms or not trace.launches:
        return None
    return len(trace.launches) / rooms
