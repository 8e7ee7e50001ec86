"""Rows scored in the window over the window's time; every answer is in host
memory when its request returns."""


def read(rec, ctx):
    return rec.examples / rec.window_s
