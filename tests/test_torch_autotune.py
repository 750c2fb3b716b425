"""The port's card table, backend rule and autotune cache
(``nmf_tpu_torch.utils.device``, ``utils.autotune``,
``ops.kernels.tile_sparse.preferred``), mirroring ``tests/test_device.py``.

No card here: ``resolve_backend`` is a pure function of its arguments, so
the tests ask it what the card would pick with ``device="cuda"``, and
``pick_backend``'s measurement is monkeypatched.  The rule table below is
the one three sessions of ``chip_smoke.py --phases card,backend`` on an
NVIDIA H100 80GB HBM3 (700 W) gave (PERF.md, "Backend rule").
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nmf_tpu.utils import autotune as jat  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.models import sparse_tiled as pst  # noqa: E402
from nmf_tpu_torch.ops.kernels import tile_sparse as pts  # noqa: E402
from nmf_tpu_torch.utils import autotune, device  # noqa: E402
from nmf_tpu_torch.utils.device import GENERIC, ChipSpec, chip_spec, chip_spec_for  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


def test_known_device_kind_resolves():
    spec = chip_spec_for(H100)
    assert spec.family == "h100" and spec.measured
    assert spec.bf16_tflops == 989.0 and spec.f32_tflops == 67.0
    assert spec.peak_tflops("bfloat16") == 989.0 and spec.peak_tflops("float32") == 67.0
    assert spec.peak_tflops("float32_fast") == pytest.approx(989.0 / 3)
    assert spec.sm_count == 132 and spec.smem_bytes == 228 * 1024
    assert spec.max_fused_k == 2048
    assert chip_spec_for(H100.lower()) is spec
    # the kernels' fixed launch plans are sized for this row
    from nmf_tpu_torch.ops.kernels import fused_mu

    assert fused_mu.TARGET_BLOCKS == 4 * spec.sm_count
    assert pts.SWEEP_BLOCKS == 2 * spec.sm_count


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "NVIDIA H200",
                                  "TPU v5 lite", "cpu", ""])
def test_unknown_device_falls_back_to_generic(kind):
    spec = chip_spec_for(kind)
    assert spec is GENERIC and spec.family == "generic" and not spec.measured
    assert spec.bf16_tflops is None and spec.f32_tflops is None
    assert spec.peak_tflops("bfloat16") is None and spec.peak_tflops("float32_fast") is None
    assert spec.sm_count is None and spec.smem_bytes is None
    assert spec.max_fused_k == 2048


def test_chip_spec_without_a_card_is_generic():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    for dev in (None, "cpu", "cuda", torch.device("cuda", 0)):
        assert chip_spec(dev) is GENERIC


def test_no_tpu_row_or_v5e_rule_carried_over():
    """The table's one row is the H100's; no field of JAX's v5e row (its
    VMEM budgets, tiles, ``fused_small_k``, ``fused_single_tile_n``)."""
    fields = {f.name for f in dataclasses.fields(ChipSpec)}
    assert not fields & {"vmem_words_f32", "vmem_words_bf16", "block_m", "block_n",
                         "fused_small_k", "fused_single_tile_n"}
    assert [spec.family for _, spec in device._TABLE] == ["h100"]


# (M, K, N, matmul, x, state, members) -> the H100 rule's choice: each shape
# that chip_smoke.py's backend phase measured (PERF.md "Backend rule")
RULE_TABLE = [
    ((512, 30, 3445, "float32", "float32", "float32", 1), "pallas"),        # paper
    ((512, 30, 3445, "float32_fast", "float32", "float32", 1), "pallas"),
    ((512, 30, 3445, "bfloat16", "float32", "float32", 1), "pallas"),
    ((1025, 32, 4000, "float32", "float32", "float32", 1), "pallas"),       # ismir
    ((1025, 32, 4000, "float32_fast", "float32", "float32", 1), "pallas"),
    ((1025, 32, 4000, "bfloat16", "float32", "float32", 1), "pallas"),
    ((4096, 128, 350, "float32", "float32", "float32", 1), "pallas"),       # reference
    ((4096, 128, 350, "float32_fast", "float32", "float32", 1), "pallas"),
    ((4096, 128, 350, "bfloat16", "float32", "float32", 1), "pallas"),
    ((4096, 128, 350, "float32", "bfloat16", "float32", 1), "pallas"),
    ((4096, 128, 350, "float32", "int8", "float32", 1), "pallas"),
    ((10240, 256, 10240, "float32", "float32", "float32", 1), "jnp"),       # flagship
    ((10240, 256, 10240, "float32_fast", "float32", "float32", 1), "pallas"),
    ((10240, 256, 10240, "bfloat16", "float32", "float32", 1), "pallas"),
    ((10240, 256, 10240, "float32", "bfloat16", "float32", 1), "jnp"),
    ((10240, 256, 10240, "float32", "int8", "float32", 1), "jnp"),
    ((1025, 32, 65408, "float32", "float32", "float32", 1), "pallas"),      # streamed block
    ((513, 32, 2000, "float32", "float32", "float32", 128), "jnp"),         # config 4
    ((513, 32, 2000, "bfloat16", "float32", "float32", 128), "jnp"),
    ((512, 32, 1024, "float32", "float32", "float32", 16), "jnp"),            # restarts
    # not measured: the kernels stay
    ((513, 32, 2000, "float32_fast", "float32", "float32", 128), "pallas"),
    ((513, 32, 2000, "float32", "bfloat16", "float32", 128), "pallas"),
    ((513, 64, 2000, "float32", "float32", "float32", 128), "pallas"),
    ((10240, 256, 10240, "float32", "float32", "bfloat16", 1), "pallas"),
    ((8192, 256, 8192, "float32", "float32", "float32", 1), "pallas"),
    ((10240, 128, 10240, "float32", "float32", "float32", 1), "pallas"),
]


@pytest.mark.parametrize("args,choice", RULE_TABLE,
                         ids=["x".join(map(str, a[:3])) + f"-{a[3]}-x{a[4]}-b{a[6]}"
                              for a, _ in RULE_TABLE])
def test_rule_pick_measured_table(args, choice):
    m, k, n, mm, xd, sd, members = args
    assert autotune.rule_pick(m, k, n, mm, xd, sd, members, spec=chip_spec_for(H100)) == choice
    # other cards take the H100's rule as their default
    assert autotune.rule_pick(m, k, n, mm, xd, sd, members) == choice


def test_rule_pick_signature_and_rank_rule():
    """JAX's positional order (``matmul_dtype`` fourth, bf16 by default);
    ranks above the kernels' ceiling take the plain ops by the rank rule,
    and a spec without rule fields keeps the kernels everywhere."""
    assert autotune.rule_pick(4096, 128, 350) == "pallas"
    assert autotune.rule_pick(4096, 2049, 350, "float32") == "jnp"
    bare = ChipSpec(family="bare", measured=False, bf16_tflops=None, f32_tflops=None)
    for args, _ in RULE_TABLE:
        m, k, n, mm, xd, sd, members = args
        assert autotune.rule_pick(m, k, n, mm, xd, sd, members, spec=bare) == "pallas"


def test_separates_is_jaxs_iqr_test():
    winner = [1.0, 1.1, 1.2, 1.3, 1.4, 1.0, 1.1, 1.2, 1.3, 1.4, 1.0, 1.1, 1.2, 1.3, 1.4]
    assert autotune.separates(winner, [w + 1.0 for w in winner])
    assert not autotune.separates(winner, [w + 0.05 for w in winner])
    assert autotune.separates(winner, [0.1] * 15)      # outside the range either way


# --- pick_backend's caches (tests/test_device.py's) ---------------------------------


@pytest.fixture
def disk_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv(autotune._CACHE_ENV, path)
    autotune.clear_cache()
    autotune.reset_counts()
    yield path
    autotune.clear_cache()


def _big_cfg(**kw):
    return pt.SolveConfig(backend="autotune", **kw)


M, K, N = 2048, 128, 1100            # above MIN_AUTOTUNE_ELEMENTS


def _kind():
    return torch.cuda.get_device_name() if torch.cuda.is_available() else "unknown"


def test_cache_names_are_the_ports_own():
    assert autotune._CACHE_ENV == "NMF_TPU_TORCH_AUTOTUNE_CACHE" != jat._CACHE_ENV
    assert autotune.MIN_AUTOTUNE_ELEMENTS == jat.MIN_AUTOTUNE_ELEMENTS
    assert autotune._disk_key("k", "a/b/c", 1, 2, 3) == jat._disk_key("k", "a/b/c", 1, 2, 3)


def test_default_disk_path(monkeypatch, tmp_path):
    monkeypatch.delenv(autotune._CACHE_ENV, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert autotune._disk_path() == str(tmp_path / ".cache" / "nmf_tpu_torch" / "autotune.json")


def test_disk_cache_hit_skips_measurement(disk_cache, monkeypatch):
    # the key carries the card's name and the dtype triple (matmul/x/state)
    key = autotune._disk_key(_kind(), "float32/float32/float32", M, K, N)
    with open(disk_cache, "w") as f:
        json.dump({key: "pallas"}, f)

    def boom(*a, **k):
        raise AssertionError("measured despite a disk cache hit")

    monkeypatch.setattr(autotune, "_measure", boom)
    assert autotune.pick_backend(_big_cfg(), M, K, N) == "pallas"
    assert autotune.pick_backend(_big_cfg(), M, K, N) == "pallas"   # memoized too
    assert autotune.MEASURED["pick_backend"] == 0


def test_measurement_persists_to_disk(disk_cache, monkeypatch):
    calls = []

    def fake(config, m, k, n, **kw):
        calls.append((config.precision.matmul_dtype, m, k, n))
        return [1.0, 1.1, 0.9], [2.0, 2.1, 1.9]     # the kernels faster

    monkeypatch.setattr(autotune, "_measure", fake)
    assert autotune.pick_backend(_big_cfg(), M, K, N) == "pallas"
    data = json.load(open(disk_cache))
    assert data == {autotune._disk_key(_kind(), "float32/float32/float32", M, K, N): "pallas"}
    assert autotune.MEASURED["pick_backend"] == 1
    # another dtype triple is another key: measured again
    bf = _big_cfg(precision=pt.Precision("bfloat16"))
    assert autotune.pick_backend(bf, M, K, N) == "pallas" and len(calls) == 2
    # a fresh process (cleared memory cache) reuses the stored winners
    autotune.clear_cache()
    monkeypatch.setattr(autotune, "_measure",
                        lambda *a, **k: pytest.fail("re-measured despite the disk cache"))
    assert autotune.pick_backend(_big_cfg(), M, K, N) == "pallas"
    assert autotune.pick_backend(bf, M, K, N) == "pallas"
    autotune.clear_cache(disk=True)
    assert not __import__("os").path.exists(disk_cache)


def test_corrupt_cache_is_ignored(disk_cache, monkeypatch):
    with open(disk_cache, "w") as f:
        f.write("{not json")
    monkeypatch.setattr(autotune, "_measure", lambda *a, **k: ([2.0] * 3, [1.0] * 3))
    assert autotune.pick_backend(_big_cfg(), M, K, N) == "jnp"
    assert json.load(open(disk_cache))             # rewritten clean


@pytest.mark.parametrize("case", ["small", "rank", "rowblock_int8"])
def test_rule_answers_without_measuring(disk_cache, monkeypatch, case):
    """Below MIN_AUTOTUNE_ELEMENTS, above the rank ceiling and for
    per-row-block int8 X the rule answers; nothing is measured or stored."""
    monkeypatch.setattr(autotune, "_measure", lambda *a, **k: pytest.fail("measured"))
    cfg, (m, k, n) = _big_cfg(), (M, K, N)
    if case == "small":
        m, n = 512, 512
    elif case == "rank":
        k = 4096
    else:
        cfg = _big_cfg(precision=pt.Precision(x_dtype="int8", x_quant_rows=32))
    want = autotune.rule_pick(m, k, n, "float32", cfg.precision.x_dtype)
    assert autotune.pick_backend(cfg, m, k, n) == want
    assert not __import__("os").path.exists(disk_cache)


# --- resolve_backend: one resolution at every entry point --------------------------

# (entry, config kwargs, (M, K, N), members) -> choice on the card
ENTRIES = [
    ("solve", {}, (4096, 128, 350), 1, "pallas"),
    ("solve", {}, (10240, 256, 10240), 1, "jnp"),
    ("solve", dict(precision=pt.Precision("bfloat16")), (10240, 256, 10240), 1, "pallas"),
    ("solve", dict(precision=pt.Precision("float32_fast")), (10240, 256, 10240), 1, "pallas"),
    ("semi", {}, (10240, 256, 10240), 1, "jnp"),
    ("semi", {}, (1025, 32, 4000), 1, "pallas"),
    ("h_only", {}, (10240, 256, 10240), 1, "jnp"),
    ("h_only", {}, (1025, 32, 4000), 1, "pallas"),
    ("streamed", {}, (1025, 32, 65408), 1, "pallas"),
    ("transform", {}, (1025, 32, 30592), 1, "pallas"),
    ("batched", {}, (513, 32, 2000), 128, "jnp"),
    ("batched", dict(precision=pt.Precision("bfloat16")), (513, 32, 2000), 128, "jnp"),
    ("selection", {}, (512, 32, 1024), 16, "jnp"),
    ("profiling", {}, (4096, 128, 350), 1, "pallas"),
    ("solve", dict(backend="pallas"), (10240, 256, 10240), 1, "pallas"),
    ("solve", dict(backend="jnp"), (4096, 128, 350), 1, "jnp"),
    ("batched", dict(backend="pallas"), (513, 32, 2000), 128, "pallas"),
    ("solve", dict(precision=pt.Precision(x_dtype="int8", x_quant_rows=32)), (4096, 128, 350), 1,
     "jnp"),
]


@pytest.mark.parametrize("entry,kw,shape,members,choice", ENTRIES)
def test_resolve_backend_on_the_card(entry, kw, shape, members, choice):
    autotune.reset_counts()
    cfg = pt.SolveConfig(**kw)
    assert autotune.resolve_backend(cfg, *shape, "cuda", entry, members) == choice
    assert autotune.CHOICES == {(entry, choice): 1}
    assert autotune.resolve_backend(cfg, *shape, torch.device("cuda", 0), entry, members) == choice


@pytest.mark.parametrize("entry,kw,shape,members,choice", ENTRIES)
def test_resolve_backend_on_the_cpu_keeps_the_wrappers(entry, kw, shape, members, choice):
    """CPU tensors keep today's route: ``pallas`` (the wrappers' plain
    versions) unless the config says ``jnp`` or X has per-row-block scales."""
    cfg = pt.SolveConfig(**kw)
    want = "jnp" if cfg.backend == "jnp" or cfg.precision.x_quant_rows else "pallas"
    assert autotune.resolve_backend(cfg, *shape, "cpu", entry, members) == want


def test_resolve_autotune_measures_on_the_card_only(disk_cache, monkeypatch):
    """``autotune`` on a CUDA device value runs pick_backend (a member axis:
    the rule); on the CPU it measures nothing."""
    monkeypatch.setattr(autotune, "_measure", lambda *a, **k: ([2.0] * 3, [1.0] * 3))
    cfg = pt.SolveConfig(backend="autotune")
    assert autotune.resolve_backend(cfg, 4096, 128, 1100, "cpu") == "pallas"
    assert autotune.MEASURED["pick_backend"] == 0
    assert autotune.resolve_backend(cfg, 4096, 128, 1100, "cuda") == "jnp"
    assert autotune.MEASURED["pick_backend"] == 1
    assert autotune.resolve_backend(cfg, 4096, 128, 1100, "cuda") == "jnp"
    assert autotune.MEASURED["pick_backend"] == 1
    assert autotune.resolve_backend(cfg, 513, 32, 2000, "cuda", "batched", 128) == "jnp"
    assert autotune.MEASURED["pick_backend"] == 1


def test_resolve_config_leaves_the_families_and_explicit_backends():
    for kw in (dict(beta=2.0), dict(algorithm="hals", beta=2.0), dict(l1_w=0.1)):
        cfg = pt.SolveConfig(**kw)
        assert autotune.resolve_config(cfg, 10240, 256, 10240, "cuda") is cfg
    cfg = pt.SolveConfig(backend="pallas")
    assert autotune.resolve_config(cfg, 10240, 256, 10240, "cuda") is cfg
    got = autotune.resolve_config(pt.SolveConfig(), 10240, 256, 10240, "cuda")
    assert got == pt.SolveConfig(backend="jnp")


def test_entry_points_resolve_on_the_cpu():
    """Each entry point resolves once for its shape (once a block width for
    the streamed paths), counted under its own name; on the CPU every
    choice is the wrappers' route."""
    rng = np.random.RandomState(0)
    x, w, h = rng.rand(40, 30).astype(np.float32), rng.rand(40, 4), rng.rand(4, 30)
    cfg = pt.SolveConfig(max_iter=2, check_every=2)
    autotune.reset_counts()
    pt.solve(x, w, h, cfg, device="cpu")
    pt.solve_semi(x, w, h, cfg, n_frozen=1, device="cpu")
    pt.solve_h_only(x, w, h, cfg, device="cpu")
    pt.solve_out_of_core(x, w, h, cfg, block_n=12, device="cpu")       # widths 12 and 6
    pt.transform_out_of_core(x, w, config=cfg, block_n=12, device="cpu")
    pt.solve_batched(np.stack([x, x]), np.stack([w, w]), np.stack([h, h]), cfg, device="cpu")
    pt.solve_restarts(x, config=cfg, w0s=np.stack([w, w]), h0s=np.stack([h, h]), device="cpu")
    from nmf_tpu_torch.utils import profiling

    profiling.stage_timings(x, w.astype(np.float32), h.astype(np.float32), repeats=1,
                            device="cpu")
    assert dict(autotune.CHOICES) == {
        ("solve", "pallas"): 1, ("semi", "pallas"): 1, ("h_only", "pallas"): 1,
        ("streamed", "pallas"): 2, ("transform", "pallas"): 2, ("batched", "pallas"): 1,
        ("selection", "pallas"): 1, ("profiling", "pallas"): 1}


# --- the tile-sparse rule ------------------------------------------------------------


@pytest.mark.parametrize("k", [8, 128, 256, 257, 384, 1024, 2048, 2049])
@pytest.mark.parametrize("policy", ["float32", "float32_fast", "bfloat16"])
def test_preferred_over_the_k_grid(k, policy):
    """K5 in every measured cell (K = 128, 256, 384 under the three
    policies) but f32 at K = 384, where the plain sweep won: the f32 sweeps
    above K = 256 take it; the rank ceiling and int8 tiles too.  bf16 tiles
    under f32 GEMMs were not measured and keep K5.  JAX's v5e rule (the
    scan under bfloat16 below K = 384) is not kept."""
    prec = pt.Precision(policy)
    want = k <= 2048 and not (policy == "float32" and k > 256)
    assert pts.preferred(k, 128, 128, prec) == want
    assert pts.preferred(k, 128, 128, pt.Precision(policy, x_dtype="bfloat16")) == (k <= 2048)
    assert not pts.preferred(k, 128, 128, pt.Precision(policy, x_dtype="int8"))


@pytest.mark.parametrize("backend,x_dtype,dev,route", [
    ("auto", "float32", "cuda", "k5"),
    ("autotune", "bfloat16", "cuda", "k5"),
    ("auto", "float32", "cpu", "k5"),
    ("auto", "int8", "cuda", "plain"),
    ("jnp", "float32", "cuda", "plain"),
    ("pallas", "float32", "cuda", "k5"),
])
def test_sweep_route_consults_preferred_on_the_card(backend, x_dtype, dev, route):
    cfg = pt.SolveConfig(backend=backend, precision=pt.Precision(x_dtype=x_dtype))
    autotune.reset_counts()
    assert pst.sweep_route(cfg, 128, (128, 128), dev) == route
    consulted = dev == "cuda" and backend in ("auto", "autotune") and x_dtype != "int8"
    assert sum(autotune.CHOICES.values()) == int(consulted)
    # above the ceiling the rule sends auto to the plain sweep
    if consulted:
        assert pst.sweep_route(cfg, 4096, (128, 128), dev) == "plain"


def test_public_names():
    for name in ("rule_pick", "pick_backend", "clear_cache"):
        assert name in autotune.__all__ and name in jat.__all__
    for name in ("ChipSpec", "GENERIC", "chip_spec", "chip_spec_for"):
        assert name in device.__all__
    assert "preferred" in pts.__all__
