"""Rank-aware logging, spans and counts, trace capture, and the FLOP and
parameter counts (the counterpart of `fusionmamba_tpu/utils/`)."""
from .flops import count_params, flops_selective_scan, model_cost_report
from .logger import rank_log_level, setup_logger
from .profiling import trace

__all__ = ["count_params", "flops_selective_scan", "model_cost_report", "rank_log_level",
           "setup_logger", "trace"]
