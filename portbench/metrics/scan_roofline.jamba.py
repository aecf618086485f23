"""Kernel #1's least time at Jamba's shapes (K = 1, a full-rank dt, one call
a Mamba layer, its width expand x hidden) over its device time in the trace,
%. The calls come from the configuration's own keys."""
import collections

from portbench import readers


def read(win):
    cfg, mix = win.cell.config, win.cell.mix
    mamba = sum(i % cfg["attn_layer_period"] != cfg["attn_layer_offset"]
                for i in range(cfg["num_hidden_layers"]))
    shape = (mix["batch"], 1, mix["seq_len"], cfg["mamba_expand"] * cfg["hidden_size"], 0)
    return readers.roofline(win, {"scan": collections.Counter({shape: mamba})})
