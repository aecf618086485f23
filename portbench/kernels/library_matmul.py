"""cuBLAS's and CUTLASS's products, for the breakdown."""
FUNCTION = "library_matmul"
ORDER = 1
EVENTS = ("gemm", "cutlass", "cublas")
