"""Dataset and metric audit CLI of the port (the counterpart of
`tools/check_dataset.py`; reference `check_test_classes.py`,
`debug_data_distribution.py`, `debug_metrics_discrepancy.py`,
`test_macc.py`).

    python -m fusionmamba_torch.tools.check_dataset classes --dataset D [--split test]
        [--num_classes 9] [--limit 0]
    python -m fusionmamba_torch.tools.check_dataset dist --dataset D [--num_classes 9] [--limit 0]
    python -m fusionmamba_torch.tools.check_dataset macc

  classes  the label-class distribution of a split, in pixels of the
           dataset's items (256x256, the labels nearest-resized);
  dist     the training and test splits' distributions side by side;
  macc     the two mAcc definitions on a synthetic example.
The datasets are read through `data.FusionDataset` under
`FUSIONMAMBA_DATA_ROOT`, on the host.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..data import FusionDataset


def audit_classes(dataset: str, split: str, num_classes: int, limit: int) -> np.ndarray:
    """Pixels of each class over the first `limit` items (0: all), printed
    and returned."""
    ds = FusionDataset(split=split, dataset_name=dataset)
    counts = np.zeros(num_classes, np.int64)
    n = min(limit or len(ds), len(ds))
    for i in range(n):
        item = ds[i]
        if len(item) < 3:
            continue
        counts += np.bincount(np.clip(item[2].flatten(), 0, num_classes - 1),
                              minlength=num_classes)
    total = counts.sum()
    print(f"{dataset}/{split}: {n} samples")
    for c, cnt in enumerate(counts):
        print(f"  class {c}: {cnt} px ({100.0 * cnt / max(total, 1):.3f}%)")
    return counts


def macc_ab_check() -> dict:
    """The two mAcc definitions on a synthetic example (`test_macc.py:3-47`):
    present classes only against all classes, an absent one counted 0."""
    rng = np.random.default_rng(0)
    target = rng.integers(0, 3, (64, 64))     # classes 0..2 of 5 present
    pred = target.copy()
    pred[rng.uniform(size=target.shape) < 0.2] = 0
    accs_present, accs_all = [], []
    for c in range(5):
        t = target == c
        if t.sum() > 0:
            acc = np.logical_and(t, pred == c).sum() / t.sum()
            accs_present.append(acc)
            accs_all.append(acc)
        else:
            accs_all.append(0.0)
    out = {"present": float(np.mean(accs_present)), "all": float(np.mean(accs_all))}
    print(f"mAcc (present classes only): {out['present']:.4f}")
    print(f"mAcc (all classes, absent=0): {out['all']:.4f}")
    print("-> absent classes drag the all-classes variant down; the "
          "reference reports both (mfnet_segmentation_results.txt:3-4)")
    return out


def main(argv=None) -> dict:
    """Run the CLI; returns {"train"/"test"/<split>: counts} or the two mAcc
    values."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("classes")
    p1.add_argument("--dataset", required=True)
    p1.add_argument("--split", default="test")
    p1.add_argument("--num_classes", type=int, default=9)
    p1.add_argument("--limit", type=int, default=0)
    p2 = sub.add_parser("dist")
    p2.add_argument("--dataset", required=True)
    p2.add_argument("--num_classes", type=int, default=9)
    p2.add_argument("--limit", type=int, default=0)
    sub.add_parser("macc")
    args = ap.parse_args(argv)
    if args.cmd == "classes":
        return {args.split: audit_classes(args.dataset, args.split, args.num_classes,
                                          args.limit)}
    if args.cmd == "macc":
        return macc_ab_check()
    tr = audit_classes(args.dataset, "train", args.num_classes, args.limit)
    te = audit_classes(args.dataset, "test", args.num_classes, args.limit)
    tr_f, te_f = tr / max(tr.sum(), 1), te / max(te.sum(), 1)
    print("class | train% | test% | ratio")
    for c in range(args.num_classes):
        r = te_f[c] / tr_f[c] if tr_f[c] > 0 else float("inf")
        print(f"{c:5d} | {100 * tr_f[c]:6.3f} | {100 * te_f[c]:6.3f} | {r:.2f}")
    return {"train": tr, "test": te}


if __name__ == "__main__":
    main()
