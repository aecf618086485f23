"""What the A/B tools (`*_ab.py`) share: time kernels of several checkouts of
the port on one NVIDIA GPU, alternating them, and compare their outputs.

A tool names its shapes and, for each step whose device time it sums, the
calls the step makes at each shape of each kind it times. Its
`child(spec, ab)` runs in a process of its own with one tree's package on
the path (this module passed as `ab`): it builds that tree's kernels, times
them at each shape of `spec["shapes"]`, prints one JSON line a shape (its
"shape" and a device ms for each kind) and, where `spec["save"]` names a
file, saves its outputs there as {key: [tensors]}, the keys of fp32 outputs
starting with "fp32".

    python3 fusionmamba_torch/tools/_ab.py TOOL SPEC

runs TOOL's child (the module TOOL of this directory) on the JSON SPEC.
"""
from __future__ import annotations

import collections
import importlib
import json
import os
import subprocess
import sys
import tempfile

CAPTURES = 3


def device_ms(fn, reps=10, by_kernel=None):
    """The median over CAPTURES of the device time a call of `fn`
    (torch.profiler, `reps` calls a capture, every kernel and memset of the
    call); with a dict `by_kernel`, each kernel's device time a call (the
    median capture's) goes into it by name. None where the profiler saw no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    times = []
    for _ in range(CAPTURES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = collections.Counter()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.replace("(anonymous namespace)::", "")
                name = name.split("(")[0].split("<")[0].split(" ")[-1]
                names[name] += e.time_range.end - e.time_range.start
        if names:
            times.append((sum(names.values()) / 1e3 / reps, names))
    if not times:
        return None
    times.sort(key=lambda t: t[0])
    total, names = times[len(times) // 2]
    if by_kernel is not None:
        by_kernel.update({k: v / 1e3 / reps for k, v in names.items()})
    return total


def needs_card(tool: str) -> None:
    """Exit before any process starts where there is no card."""
    import torch

    if not torch.cuda.is_available():
        sys.exit(f"{tool}: no CUDA device")


def spawn(tool: str, tree: str, spec: dict, sources=None) -> subprocess.Popen:
    """Start TOOL's child on `tree` (its package first on the path; with
    `sources`, the tree builds only those of its kernel sources where its
    `cuda_lib` reads FM_CUDA_SOURCES)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    if sources:
        env["FM_CUDA_SOURCES"] = ",".join(sources)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), tool, json.dumps(spec)],
                            cwd=tree, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def lines(tree: str, proc: subprocess.Popen) -> list[dict]:
    """The JSON lines a child printed; exit where it failed."""
    out, err = proc.communicate()
    if proc.returncode != 0:
        sys.exit(f"{tree}: exit {proc.returncode}\n{err[-4000:]}")
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def by_shape(got: list[dict]) -> dict:
    return {str(ln["shape"]): ln for ln in got}


def step_sums(got: dict, calls: dict) -> dict:
    """{step: {kind: device ms}}: each step's calls a shape times the
    child's ms a call, summed over the shapes, for every kind the step
    calls."""
    return {name: {kind: sum(n * got[str(list(s))][kind] for s, n in c.items())
                   for kind, c in kinds.items() if c}
            for name, kinds in calls.items()}


def identical(saved: dict) -> dict:
    """Whether each tree's outputs, fp32 and not, all equal the first tree's
    bit for bit (and in dtype)."""
    import torch

    trees = list(saved)
    ref = torch.load(saved[trees[0]])
    same = {}
    for tree in trees:
        outs = torch.load(saved[tree])
        same[tree] = all(a.dtype == b.dtype and torch.equal(a, b)
                         for k in ref for a, b in zip(outs[k], ref[k]))
    return same


def rel_by_output(saved: dict) -> dict:
    """{tree: {output: its largest difference from the first tree's over the
    largest entry}}, each saved output (a shape's tensors) on its own."""
    import torch

    trees = list(saved)
    ref = torch.load(saved[trees[0]])
    out = {}
    for tree in trees:
        outs = torch.load(saved[tree])
        out[tree] = {k: max(float((a.float() - b.float()).abs().max()
                                  / b.float().abs().max().clamp_min(1e-30))
                            for a, b in zip(outs[k], ref[k])) for k in ref}
    return out


def diffs(saved: dict) -> tuple[dict, dict]:
    """Each tree's largest difference from the first tree's outputs: of the
    non-fp32 outputs over the largest entry (0 where there are none), and of
    the fp32 ones absolute (empty where no tree saved fp32 outputs)."""
    import torch

    trees = list(saved)
    ref = torch.load(saved[trees[0]])
    rel, abs32 = {}, {}
    for tree in trees:
        outs = torch.load(saved[tree])
        rel[tree] = max((float((a.float() - b.float()).abs().max()
                               / b.float().abs().max().clamp_min(1e-30))
                         for k in ref if not k.startswith("fp32")
                         for a, b in zip(outs[k], ref[k])), default=0.0)
        fp32 = [k for k in ref if k.startswith("fp32")]
        if fp32:
            abs32[tree] = max(float((a - b).abs().max()) for k in fp32
                              for a, b in zip(outs[k], ref[k]))
    return rel, abs32


def compare(tool: str, trees: list[str], shapes, calls: dict, rounds: int, spec: dict,
            sources=None) -> dict:
    """Run every tree's child `rounds` times, in the given order in even
    rounds and the reverse order in odd ones, each on `spec` with the
    shapes; print each child's lines with its tree and round. The first
    round saves the outputs. Returns {"step_device_ms": {tree: {step: {kind:
    [ms each round]}}}, "max_rel_diff_vs_first": ..., "bit_identical_to_first":
    ..., "rel_diff_by_output_vs_first": ..., and, where fp32 outputs were
    saved, "fp32_max_abs_diff_vs_first": ...}."""
    steps = {t: {name: {k: [] for k, c in kinds.items() if c} for name, kinds in calls.items()}
             for t in trees}
    with tempfile.TemporaryDirectory() as tmp:
        saved = {t: os.path.join(tmp, f"{i}.pt") for i, t in enumerate(trees)}
        for r in range(rounds):
            for tree in (trees if r % 2 == 0 else trees[::-1]):
                got = by_shape(lines(tree, spawn(tool, tree, {
                    **spec, "shapes": [list(s) for s in shapes],
                    "save": saved[tree] if r == 0 else None}, sources)))
                for s in shapes:
                    print(json.dumps({"tree": tree, "round": r, **got[str(list(s))]}),
                          flush=True)
                for name, kinds in step_sums(got, calls).items():
                    for k, ms in kinds.items():
                        steps[tree][name][k].append(ms)
        rel, abs32 = diffs(saved) if rounds else ({}, {})
        same = identical(saved) if rounds else {}
        by_output = rel_by_output(saved) if rounds else {}
    return {"step_device_ms": steps, "max_rel_diff_vs_first": rel,
            "bit_identical_to_first": same, "rel_diff_by_output_vs_first": by_output,
            **({"fp32_max_abs_diff_vs_first": abs32} if abs32 else {})}


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


if __name__ == "__main__":
    importlib.import_module(sys.argv[1]).child(json.loads(sys.argv[2]), sys.modules[__name__])
