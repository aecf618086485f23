"""Kernel #1, the selective scan's forward (`csrc/selective_scan_fwd.cu`, its
chunk carries included): work at shape (B, K, L, D, R), frozen from
`chip_smoke.py::bytes_and_ops`."""
FUNCTION = "scan"
ORDER = 0
EVENTS = ("selective_scan_fwd_kernel", "carry_kernel")
N = 16


def rate(io: int) -> str:
    return "fp32"


def work(shape, io: int):
    """(bytes, operations, special-function calls) of one call; `io` bytes an
    element of its I/O tensors."""
    B, K, L, D, R = shape
    elems = B * K * L * D
    # dt: the low-rank (B, K, L, R), or at R = 0 the full (B, K, L, D)
    dt = B * K * L * (R or D)
    nbytes = io * (2 * elems + dt + 2 * B * K * L * N + K * D * R) + 4 * K * D * (N + 2)
    # per state: the exponent, the input term, two FMAs; the dt expansion and
    # softplus. Special functions: an exp per state, softplus' exp and log
    return nbytes, elems * (2 * R + 7 + 7 * N), elems * (N + 2)
