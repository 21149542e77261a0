"""Megapixels of supervised views through render, loss, backward and
update in the window, over the window's wall time (host clock, ending in a
synchronise). A batched step counts its B views."""


def read(run):
    return run["mpix"] / run["window_s"]
