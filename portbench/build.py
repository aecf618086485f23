"""The program's objects built from a configuration file's dict: the
system under test, which the benchmark drives through its own entries.

A configuration's maker is `makers/<model>.py`, found by the configuration
file's `model`: its `make(config, device)` builds the program's model on
the device, where the benchmark's weights then overwrite its parameters.
"""
from __future__ import annotations

from .harness import HERE, load_module


def maker(config: dict):
    """`makers/<config["model"]>.py` as a module."""
    path = HERE / "makers" / f"{config['model']}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no maker for model {config['model']!r}: "
                                f"portbench/makers/{path.name} does not exist")
    return load_module(path)


def model(config: dict, device):
    """The program's model of `config`, made on `device` by its maker."""
    return maker(config).make(config, device)
