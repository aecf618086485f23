"""Tokens of every sequence scored in the window, over the window."""


def read(win):
    return win.items / win.window_s
