"""Device: the share of the traced window (the traced steps through their
final sync) in which no kernel, copy or memset ran on the card, in %."""


def read(r):
    window = r.trace.window_s()
    return 100.0 * (1.0 - r.trace.busy_s() / window) if window > 0 else None
