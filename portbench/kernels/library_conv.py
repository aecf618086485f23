"""cuDNN's convolutions (and PyTorch's own), for the breakdown: no work of a
kernel of the port."""
FUNCTION = "library_conv"
ORDER = 1
EVENTS = ("conv", "fprop", "dgrad", "wgrad", "cudnn")
