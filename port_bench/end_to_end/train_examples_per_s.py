"""Rows stepped in the window over the window's time; the window ends in a sync."""


def read(rec, ctx):
    return rec.examples / rec.window_s
