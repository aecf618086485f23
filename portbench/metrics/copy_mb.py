"""MB a unit that the program's own copies write (its `copy_bytes:<site>`
counts, / 1e6); None where it counts none."""

PREFIX = "copy_bytes:"


def read(win):
    sites = [v for k, v in win.trace.counts.items() if k.startswith(PREFIX)]
    return sum(sites) / 1e6 if sites else None
