"""One rank of ``nmf_tpu_torch.examples.distributed`` for
``tests/test_torch_examples.py`` (not collected).

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tests/torch_example_ranks.py OUT_DIR

runs the example's ``main(["--device", "cpu"])`` on this rank (the
launcher's gloo group, a 2x2 mesh over four ranks) and writes every
figure it returned to ``OUT_DIR/rank<RANK>.npz``, keyed
``<section>.<figure>``.  The example leaves through
``nmf_tpu_torch.parallel.mesh.shutdown`` and the rank exits normally.
Imports torch, NumPy and ``nmf_tpu_torch`` only.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def main(argv) -> int:
    out = argv[1]
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from nmf_tpu_torch.examples import distributed

    figures = distributed.main(["--device", "cpu"])
    flat = {f"{sec}.{key}": np.asarray(v) for sec, d in figures.items() for key, v in d.items()}
    np.savez(os.path.join(out, f"rank{os.environ['RANK']}.npz"), **flat)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
