"""Kernel #2, the selective scan's backward (`csrc/selective_scan_bwd.cu`):
work at shape (B, K, L, D, R), frozen from `chip_smoke.py::bytes_and_ops`."""
FUNCTION = "scan_bwd"
ORDER = 0
EVENTS = ("selective_scan_bwd", "scan_bwd_reduce")
N = 16
# steps between the states the forward saves (`ops/scan_cuda.py`)
SAVE_EVERY = 8


def rate(io: int) -> str:
    return "fp32"


def work(shape, io: int):
    B, K, L, D, R = shape
    elems = B * K * L * D
    dt = B * K * L * (R or D)
    # also reads the states the forward saved every SAVE_EVERY steps
    nbytes = (io * (3 * elems + 2 * (dt + 2 * B * K * L * N) + 2 * K * D * R)
              + 4 * (elems * N // SAVE_EVERY + 2 * K * D * (N + 2)))
    # recompute (exp, 2 FMAs per state) and the adjoint (about 16 per state),
    # the dt expansion, its two gradients, softplus and its slope; an exp per
    # state, softplus' exp and log, the slope's reciprocal
    return nbytes, elems * (20 * N + 6 * R + 15), elems * (N + 3)
