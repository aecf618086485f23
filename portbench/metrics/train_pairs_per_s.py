"""Pairs of every training step in the window, over the window: from a
synchronised start to the synchronisation after the last step dispatched."""


def read(win):
    return win.items / win.window_s
