"""Device ms a step of the ``make_multi_step`` replays: the window's calls'
device time between CUDA events (each call one replay of K steps and their
refresh, the epoch's padded group one of fewer), summed, over the real steps
they stepped."""


def read(rec, ctx):
    ms = rec.device_ms.get("multi_step")
    return float(sum(ms)) / rec.attempted if ms and rec.attempted else None
