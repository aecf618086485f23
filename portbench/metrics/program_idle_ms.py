"""The device's idle ms a unit whose middle falls inside one of the program's
spans on the main thread (the idle that the program's own host code opens;
the gaps under no span are the caller's); None where the program has no
span."""
from portbench import spans


def read(win):
    rows = {name: row for name, row in win.trace.spans.items() if name != spans.OUTSIDE}
    if not rows:
        return None
    return sum(row["self_idle_ms"] for row in rows.values())
