"""Device ms of one ``Predictor.replay`` (the request's graph) on
device-resident copies of the pool's requests, between CUDA events around a
run of replays."""


def read(rec, ctx):
    ms = rec.device_ms.get("forward")
    return ms[0] if ms else None
