"""Structured run metrics, counterpart of ``nmf_tpu.utils.metrics``.

Per-check KL cost, relative change, iterations/s and achieved TFLOP/s, as
human-readable lines and/or JSONL.  Results are read field by field with
NumPy; a CUDA tensor is brought to the host here, after the run.

The live per-check stream (``SolveConfig.live_metrics``): the solve loops
call :func:`emit_live` with ``(iteration, cost, rel_change)`` at each check,
the values JAX's loops emit, and it hands them to the handler that
:func:`set_live_handler` set (a line on stderr by default).  The port's
loops are eager, so emitting is a plain host call; its price is one read of
the cost and the relative change at each check, which a ``thresh == 0``
solve otherwise never makes (JAX's chunked live loop, ``run_live_chunked``,
makes the same trade).  Nothing it reads changes a bit of the solve.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import IO, List, Optional

import numpy as np

__all__ = [
    "CheckRecord",
    "RunReport",
    "MetricsLogger",
    "summarize_result",
    "flops_per_iter",
    "emit_live",
    "set_live_handler",
]


def _default_live_handler(iteration: int, cost: float, rel_change: float) -> None:
    sys.stderr.write(
        f"[nmf] iter {iteration:>6d}  cost {cost:.6e}  "
        f"rel_change {rel_change:.3e}  (live)\n"
    )
    sys.stderr.flush()


_live_handler = _default_live_handler


def set_live_handler(handler) -> None:
    """Replace the live-metrics sink (None restores the stderr default)."""
    global _live_handler
    _live_handler = handler if handler is not None else _default_live_handler


def emit_live(iteration, cost, rel_change) -> None:
    """The solve loops' call at each check of a ``live_metrics`` run."""
    _live_handler(int(iteration), float(cost), float(rel_change))


def _host(v) -> np.ndarray:
    """NumPy view of a result field (tensor on any device, or array)."""
    if hasattr(v, "detach"):
        v = v.detach().cpu()
    return np.asarray(v)


@dataclasses.dataclass
class CheckRecord:
    """One convergence-check point (every ``check_every`` iterations)."""

    iteration: int
    cost: float
    rel_change: float  # |prev - cost| / |cost| ; inf at the first check


@dataclasses.dataclass
class RunReport:
    """Whole-run summary."""

    m: int
    k: int
    n: int
    iterations: int
    converged: bool
    final_cost: float
    seconds: float
    iters_per_sec: float
    achieved_tflops: float
    checks: List[CheckRecord] = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        """RFC-8259-clean JSON: non-finite floats become null."""

        def clean(v):
            if isinstance(v, float) and not np.isfinite(v):
                return None
            if isinstance(v, dict):
                return {k: clean(x) for k, x in v.items()}
            if isinstance(v, list):
                return [clean(x) for x in v]
            return v

        return json.dumps(clean(dataclasses.asdict(self)))


def flops_per_iter(m: int, k: int, n: int) -> float:
    """Flops of one MU iteration: four M x N x K GEMMs."""
    return 8.0 * m * n * k


def summarize_result(
    result,
    x_shape,
    seconds: Optional[float] = None,
    check_every: Optional[int] = None,
    check_iterations: Optional[List[int]] = None,
) -> RunReport:
    """Build a RunReport from a SolveResult (reads its scalars on the host).

    Check ``i`` is labelled with iteration ``min((i+1)*check_every,
    iterations)``; ``check_iterations`` overrides the labels.
    """
    m, n = x_shape
    k = int(result.w.shape[1])
    iterations = int(_host(result.iterations))
    hist = _host(result.cost_history)[: int(_host(result.num_checks))]
    checks = []
    prev = float("inf")
    n_checks = len(hist)
    if check_every is None and n_checks:
        check_every = max(1, iterations // n_checks)
    for i, c in enumerate(hist):
        if check_iterations is not None and i < len(check_iterations):
            it = int(check_iterations[i])
        else:
            it = min((i + 1) * check_every, iterations) if n_checks else 0
        if not np.isfinite(prev) or float(c) == 0.0:
            rel = 0.0 if prev == float(c) else float("inf")
        else:
            rel = abs(prev - float(c)) / abs(float(c))
        checks.append(CheckRecord(iteration=it, cost=float(c), rel_change=rel))
        prev = float(c)
    secs = float(seconds) if seconds is not None else float("nan")
    ips = iterations / secs if seconds is not None and secs > 0 else float("nan")
    return RunReport(
        m=m,
        k=k,
        n=n,
        iterations=iterations,
        converged=bool(_host(result.converged)),
        final_cost=float(_host(result.cost)),
        seconds=secs,
        iters_per_sec=ips,
        achieved_tflops=(flops_per_iter(m, k, n) * ips / 1e12) if seconds else float("nan"),
        checks=checks,
    )


class MetricsLogger:
    """Emits check records and run summaries, human and/or JSONL.

    Usage::

        logger = MetricsLogger(verbose=True, jsonl_path="run.jsonl")
        with logger.timed() as t:
            res = solve(...)
            torch.cuda.synchronize()   # time the work, not its enqueue
        report = logger.report(res, x.shape, t.seconds)
    """

    def __init__(
        self,
        verbose: bool = True,
        stream: IO = sys.stderr,
        jsonl_path: Optional[str] = None,
    ):
        self.verbose = verbose
        self.stream = stream
        self.jsonl_path = jsonl_path

    class _Timer:
        def __enter__(self):
            self._t0 = time.perf_counter()
            self.seconds = None
            return self

        def __exit__(self, *exc):
            self.seconds = time.perf_counter() - self._t0
            return False

    def timed(self) -> "_Timer":
        return self._Timer()

    def report_raw(self, record: dict) -> None:
        """Emit a free-form record, for runs whose shape does not fit one
        ``SolveResult`` (the online learner's passes, a separation)."""
        if self.verbose:
            self.stream.write(f"[nmf] {json.dumps(record)}\n")
            self.stream.flush()
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def report(
        self,
        result,
        x_shape,
        seconds: Optional[float] = None,
        check_every: Optional[int] = None,
        check_iterations: Optional[List[int]] = None,
    ) -> RunReport:
        rep = summarize_result(
            result, x_shape, seconds, check_every, check_iterations
        )
        if self.verbose:
            for c in rep.checks:
                self.stream.write(
                    f"[nmf] iter {c.iteration:>6d}  cost {c.cost:.6e}  "
                    f"rel_change {c.rel_change:.3e}\n"
                )
            status = "converged" if rep.converged else "max_iter"
            self.stream.write(
                f"[nmf] done ({status}): {rep.iterations} iters"
                + (
                    f" in {rep.seconds:.3f} s "
                    f"({rep.iters_per_sec:.1f} it/s, "
                    f"{rep.achieved_tflops:.2f} TFLOP/s)"
                    if seconds
                    else ""
                )
                + f", final cost {rep.final_cost:.6e}\n"
            )
            self.stream.flush()
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(rep.to_json() + "\n")
        return rep
