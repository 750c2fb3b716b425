"""What the examples share: the quick knob, the ``--device`` argument, the
section hook and the host copy of a result."""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

# the JAX examples' knob (examples/basic_usage.py:17): smaller sizes, the
# same code paths
QUICK_ENV = "NMF_TPU_EXAMPLE_QUICK"


def quick() -> bool:
    return bool(os.environ.get(QUICK_ENV))


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the solves run: cuda (default) or cpu")
    return ap


def sections(section):
    """``section``, or a hook whose sections do nothing around the work."""
    return section if section is not None else (lambda name: contextlib.nullcontext())


def host(t) -> np.ndarray:
    """A result tensor (or array) as an f32 NumPy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)
