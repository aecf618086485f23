"""PST900 improved-training entry point of the port (the counterpart of
`train_pst900_improved.py`):

    python -m fusionmamba_torch.train_pst900_improved [train_segmentation's flags,
        --precision auto|bf16|fp32 among them]

The improvements (class weights from the label counts, AdamW at 5e-5 with
the poly lr, the improved loss with Dice, the gradient clip) are
`train_segmentation`'s for `--dataset pst900`; this entry point only adds
that flag where it is not given."""
from __future__ import annotations

import sys

from . import train_segmentation


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--dataset" not in argv:
        argv += ["--dataset", "pst900"]
    return train_segmentation.main(argv)


if __name__ == "__main__":
    main()
