"""Pairs of every batch returned to the host in the window, over the window."""


def read(win):
    return win.items / win.window_s
