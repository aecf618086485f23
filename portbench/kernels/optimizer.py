"""The optimizer's kernels: torch.optim.Adam's multi-tensor updates."""
FUNCTION = "optimizer"
ORDER = 2
EVENTS = ("adam", "multi_tensor")
