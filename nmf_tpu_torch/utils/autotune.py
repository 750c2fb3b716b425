"""Per-shape backend selection: a measured rule table plus opt-in tuning.

Counterpart of ``nmf_tpu.utils.autotune``.  Whether the hand-written
kernels (K1-K3, ``backend="pallas"``) or the plain torch step (cuBLAS
GEMMs and elementwise ops, ``backend="jnp"``) is faster depends on the
shape, the precision policy and the card.

``backend="auto"`` applies :func:`rule_pick`, measurement-free, from the
card's row (:mod:`nmf_tpu_torch.utils.device`).  ``backend="autotune"``
measures both steps once per (card, dtypes, shape) via :func:`pick_backend`
and caches the winner in-process and on disk
(``~/.cache/nmf_tpu_torch/autotune.json``, or the path in
``NMF_TPU_TORCH_AUTOTUNE_CACHE``).  The file is the port's own: the JAX
package's keys name TPU device kinds.  Writes replace the file atomically,
and a file that does not parse is ignored.

:func:`resolve_backend` is the one resolution every entry point calls
(``solve``, ``solve_semi``, the H-only path and ``NMF``, the streamed solve
and transform per block width, the batched and selection solves,
``stage_timings``); it is a pure function of its arguments, so the CPU
tests can ask what the card would pick.  As JAX consults its rule only on
a TPU, the port consults it only for CUDA tensors: CPU tensors keep the
kernel wrappers' plain versions.  ``backend="pallas"`` always launches the
kernels (or raises), and per-row-block int8 X always takes the plain ops
(the kernels' scales are per column).  Each choice is counted in
:data:`CHOICES` under ``(entry, choice)``, and each measurement in
:data:`MEASURED`.

Timing (:func:`time_interleaved`) runs the steps users run, one Python call
an iteration, so the host's enqueue time counts: CUDA events around a loop
of ``iters`` steps, after a warm-up, the candidates in turns (ABBA) over
``repeats`` samples; the per-step median decides.  JAX's long/short
differencing worked around a TPU runtime whose ``block_until_ready`` did
not block; a CUDA event does.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import statistics
import tempfile
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from .device import chip_spec

__all__ = [
    "CHOICES",
    "MEASURED",
    "MIN_AUTOTUNE_ELEMENTS",
    "clear_cache",
    "pick_backend",
    "resolve_backend",
    "resolve_config",
    "rule_pick",
    "separates",
    "time_interleaved",
]

_cache: Dict[Tuple, str] = {}

# Below this many X elements the run is launch-bound; don't measure.
MIN_AUTOTUNE_ELEMENTS = 1 << 21  # ~2M (8 MB f32)
_REPEATS, _ITERS, _WARMUP = 5, 10, 2    # samples, steps a sample, warm-up steps

_CACHE_ENV = "NMF_TPU_TORCH_AUTOTUNE_CACHE"

# (entry, choice) -> resolutions made; measurements made by pick_backend
CHOICES: collections.Counter = collections.Counter()
MEASURED: Dict[str, int] = {"pick_backend": 0}


def _disk_path() -> str:
    return os.environ.get(_CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "nmf_tpu_torch", "autotune.json"
    )


def _disk_load() -> dict:
    try:
        with open(_disk_path()) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def _disk_store(key: str, choice: str) -> None:
    """Best-effort persistent record (atomic replace; concurrent writers may
    drop each other's newest entry, never corrupt the file)."""
    path = _disk_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        data = _disk_load()
        data[key] = choice
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", prefix=".tmp_at_")
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=0, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # the cache is an optimisation; never fail the solve over it


def _disk_key(kind: str, dtype: str, m: int, k: int, n: int) -> str:
    return f"{kind}|{dtype}|{m}x{k}x{n}"


def clear_cache(disk: bool = False) -> None:
    """Forget the in-process winners (and with ``disk`` the file)."""
    _cache.clear()
    if disk:
        try:
            os.unlink(_disk_path())
        except OSError:
            pass


def reset_counts() -> None:
    """Set :data:`CHOICES` and :data:`MEASURED` to 0."""
    CHOICES.clear()
    for key in MEASURED:
        MEASURED[key] = 0


def rule_pick(m: int, k: int, n: int, matmul_dtype: str = "bfloat16",
              x_dtype: str = "float32", state_dtype: str = "float32",
              members: int = 1, spec=None) -> str:
    """Measurement-free backend rule for a CUDA card: ``"pallas"`` (the
    kernels) or ``"jnp"`` (cuBLAS and elementwise ops).

    The rule leaves the kernels only where three sessions of
    ``chip_smoke.py --phases card,backend`` on the H100 separated (the
    loser's pooled median outside the winner's interquartile range,
    JAX's own test; ``backend_rule.py`` pools them): a 2-D step with f32
    GEMMs on f32 state (the ``float32`` policy, X in f32, bf16 or int8) at
    ``K >= spec.f32_jnp_min_k`` and ``M * N >= spec.f32_jnp_min_elements``
    (the flagship, 10240^2 K=256: K1/K2 at one block an SM), and a step
    over a member axis at ``K <= spec.batched_jnp_max_k`` under the
    ``float32`` and ``bfloat16`` policies on f32 X and state (config 4,
    128 x 513x2000, and 16 x 512x1024, K=32).  Everywhere else, and
    wherever the sessions did not separate or nothing was measured (bf16
    state under f32 GEMMs, f32 shapes below the flagship's size or rank,
    ``float32_fast`` or bf16/int8 X over a member axis), ``auto`` keeps the
    kernels:
    they are the route every check of ``chip_smoke.py`` has held.  JAX
    breaks a tie the other way (it prefers ``jnp`` for stability).

    Milliseconds a step, the median of each of three sessions (NVIDIA H100
    80GB HBM3, power limit 700.00 W; ``autotune._measure``; config 4 is
    128 x 513x2000 and "select 16" 16 x 512x1024, a member axis):

        shape                    kernels ms           plain ms              rule
        paper float32            0.108/0.165/0.094    0.188/0.270/0.169     pallas
        paper float32_fast       0.118/0.113/0.102    0.719/0.899/0.637     pallas
        paper bfloat16           0.125/0.139/0.098    0.334/0.414/0.305     pallas
        ismir float32            0.152/0.158/0.114    0.244/0.271/0.170     pallas
        ismir float32_fast       0.186/0.141/0.101    1.124/0.922/0.665     pallas
        ismir bfloat16           0.113/0.181/0.146    0.310/0.543/0.427     pallas
        reference float32        0.130/0.140/0.166    0.188/0.257/0.277     pallas
        reference float32_fast   0.187/0.180/0.142    1.011/1.074/0.677     pallas
        reference bfloat16       0.191/0.141/0.159    0.462/0.368/0.374     pallas
        flagship float32         6.606/6.558/6.561    6.172/6.144/6.137     jnp
        flagship float32_fast    5.829/5.860/5.834    20.187/20.240/20.193  pallas
        flagship bfloat16        5.510/5.509/5.492    7.219/7.250/7.242     pallas
        reference bfloat16 X     0.186/0.154/0.155    0.309/0.218/0.171     pallas
        reference int8 X         0.157/0.156/0.152    0.224/0.262/0.192     pallas
        flagship bfloat16 X      8.928/8.919/8.877    6.277/6.267/6.239     jnp
        flagship int8 X          9.019/9.015/8.979    6.793/6.793/6.764     jnp
        streamed block float32   1.027/1.018/1.009    1.639/1.634/1.629     pallas
        config 4 float32         4.314/4.311/4.292    3.331/3.330/3.324     jnp
        config 4 bfloat16        6.032/5.972/6.024    4.911/4.882/4.882     jnp
        select 16 float32        0.725/0.731/0.805    0.409/0.428/0.463     jnp

    ``matmul_dtype`` first, as in JAX; the X and state dtypes and the
    member count are the port's additions.  Ranks above the kernels'
    ceiling take the plain ops by the rank rule either way.
    """
    from ..ops.kernels import fused_mu

    if not fused_mu.supported(k):
        return "jnp"
    spec = chip_spec() if spec is None else spec
    f32_data = (x_dtype, state_dtype) == ("float32", "float32")
    if members > 1:
        if (f32_data and matmul_dtype in ("float32", "bfloat16")
                and spec.batched_jnp_max_k is not None and k <= spec.batched_jnp_max_k):
            return "jnp"
        return "pallas"
    f32_gemms = matmul_dtype == "float32" and state_dtype == "float32"
    if (f32_gemms and spec.f32_jnp_min_k is not None and k >= spec.f32_jnp_min_k
            and m * n >= spec.f32_jnp_min_elements):
        return "jnp"
    return "pallas"


def time_interleaved(fns: Dict[str, Callable[[], object]], repeats: int = _REPEATS,
                     iters: int = _ITERS, warmup: int = _WARMUP) -> Dict[str, List[float]]:
    """Milliseconds a call of each of ``fns`` (no-argument callables on the
    current CUDA device), ``repeats`` samples each: every sample is one
    loop of ``iters`` calls between two CUDA events, the candidates in
    turns, in reversed order on every other repeat (ABBA)."""
    names = list(fns)
    for name in names:
        for _ in range(warmup):
            fns[name]()
    torch.cuda.synchronize()
    out: Dict[str, List[float]] = {name: [] for name in names}
    for r in range(repeats):
        for name in (names if r % 2 == 0 else names[::-1]):
            fn = fns[name]
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            b.synchronize()
            out[name].append(a.elapsed_time(b) / iters)
    return out


def separates(winner: Sequence[float], loser: Sequence[float]) -> bool:
    """JAX's evidence test (``nmf_tpu/utils/device.py:68-74``): the loser's
    median lies outside the winner's interquartile range (samples pooled
    over sessions; lower is better)."""
    q1, _, q3 = statistics.quantiles(winner, n=4, method="inclusive")
    lo = statistics.median(loser)
    return lo > q3 or lo < q1


def _problem(config, m: int, k: int, n: int, members: int, dev: torch.device):
    """X, W and H of the shape in the config's dtypes, seeded on the card
    (int8 X: one problem, quantized per the policy)."""
    from ..models.solver import _DTYPES
    from ..ops.quant import quantize_policy

    prec = config.precision
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    lead = (members,) if members > 1 else ()
    x = torch.clamp_min(torch.rand(*lead, m, n, generator=g, device=dev), float(config.eps))
    sd = _DTYPES[prec.state_dtype]
    w = torch.rand(*lead, m, k, generator=g, device=dev).to(sd)
    h = torch.rand(*lead, k, n, generator=g, device=dev).to(sd)
    if prec.x_dtype == "int8":
        x = quantize_policy(x, config.eps, prec.x_quant_rows)
    else:
        x = x.to(_DTYPES[prec.x_dtype])
    return x, w, h


def _step_of(config, members: int):
    if members > 1:
        from ..parallel.batched import batched_step_cost

        return batched_step_cost(config)[0]
    from ..models.solver import resolve_step_fn

    return resolve_step_fn(config)


def _measure(config, m: int, k: int, n: int, members: int = 1,
             repeats: int = _REPEATS, iters: int = _ITERS) -> Tuple[List[float], List[float]]:
    """Milliseconds a step through the kernels and through the plain ops at
    this shape and policy on the current card: ``(pallas, jnp)`` samples
    (:func:`time_interleaved`).  Each candidate steps its own copy of the
    state, as a solve would."""
    dev = torch.device("cuda", torch.cuda.current_device())
    x, w, h = _problem(config, m, k, n, members, dev)
    fns = {}
    for backend in ("pallas", "jnp"):
        step = _step_of(dataclasses.replace(config, backend=backend), members)
        state = [w, h]

        def run(step=step, state=state):
            state[0], state[1] = step(state[0], state[1], x)

        fns[backend] = run
    t = time_interleaved(fns, repeats, iters)
    return t["pallas"], t["jnp"]


def pick_backend(config, m: int, k: int, n: int) -> str:
    """Measured pick: ``"pallas"`` or ``"jnp"`` for this shape on the
    current card (CUDA callers only).

    Below :data:`MIN_AUTOTUNE_ELEMENTS`, above the kernels' rank ceiling and
    for per-row-block int8 X the rule answers without measuring.  The
    winner (the lower median; the kernels on a tie) is cached per (card
    name, matmul/X/state dtypes, shape) in-process and on disk, so a shape
    is measured once per machine.
    """
    from ..ops.kernels import fused_mu

    prec = config.precision
    if (not fused_mu.supported(k) or m * n < MIN_AUTOTUNE_ELEMENTS
            or (prec.x_dtype == "int8" and prec.x_quant_rows)):
        return rule_pick(m, k, n, prec.matmul_dtype, prec.x_dtype, prec.state_dtype)
    kind = torch.cuda.get_device_name() if torch.cuda.is_available() else "unknown"
    # the winner depends on the memory traffic too, so the key carries the
    # X storage and state dtypes, not just the GEMM policy
    dtypes = (prec.matmul_dtype, prec.x_dtype, prec.state_dtype)
    key = (kind, *dtypes, m, k, n)
    if key in _cache:
        return _cache[key]
    dkey = _disk_key(kind, "/".join(dtypes), m, k, n)
    disk = _disk_load()
    if disk.get(dkey) in ("pallas", "jnp"):
        _cache[key] = disk[dkey]
        return disk[dkey]
    MEASURED["pick_backend"] += 1
    t_pallas, t_jnp = _measure(config, m, k, n)
    choice = "pallas" if statistics.median(t_pallas) <= statistics.median(t_jnp) else "jnp"
    _cache[key] = choice
    _disk_store(dkey, choice)
    return choice


def resolve_backend(config, m: int, k: int, n: int, device, entry: str = "solve",
                    members: int = 1) -> str:
    """``"pallas"`` or ``"jnp"`` for a KL MU step of shape (M, K, N) on
    ``device`` (a ``torch.device`` or its string), ``members`` problems at
    once; counted in :data:`CHOICES` under ``(entry, choice)``.

    ``pallas`` and ``jnp`` stand.  Per-row-block int8 X takes ``jnp`` (the
    kernels' scales are per column).  CPU tensors take ``pallas``: the
    wrappers' plain versions, today's route.  On CUDA ``auto`` takes
    :func:`rule_pick` and ``autotune`` :func:`pick_backend` (a member axis:
    the rule, as JAX's batched solves never measure).
    """
    prec = config.precision
    if config.backend in ("pallas", "jnp"):
        choice = config.backend
    elif prec.x_dtype == "int8" and prec.x_quant_rows:
        choice = "jnp"
    elif torch.device(device).type != "cuda":
        choice = "pallas"
    elif config.backend == "autotune" and members == 1:
        choice = pick_backend(config, m, k, n)
    else:
        choice = rule_pick(m, k, n, prec.matmul_dtype, prec.x_dtype, prec.state_dtype, members,
                           spec=chip_spec(device))
    CHOICES[(entry, choice)] += 1
    return choice


def resolve_config(config, m: int, k: int, n: int, device, entry: str = "solve",
                   members: int = 1):
    """``config`` with ``backend`` resolved by :func:`resolve_backend` for
    the KL MU family; the other families (plain ops on every device, as in
    JAX) and an explicit ``pallas`` or ``jnp`` come back as they are."""
    if config.backend not in ("auto", "autotune"):
        return config
    if config.beta != 1.0 or config.regularized or config.algorithm != "mu":
        return config
    choice = resolve_backend(config, m, k, n, device, entry, members)
    return dataclasses.replace(config, backend=choice)

