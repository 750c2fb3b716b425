"""The port's serving artifacts (``nmf_tpu_torch.serving``) against nmf_tpu's
on the CPU.

The same seeded NumPy inputs are served through JAX's ``save_transform`` /
``load_transform`` (``platforms=("cpu",)``) and through the port's
(``device="cpu"``), one torch thread.  Tolerances, as
tests/test_torch_transform.py holds the H-only solve: H rtol 1e-4 / atol
1e-6, block costs relative 1e-5 (``bfloat16`` GEMMs and bf16 state:
tests/test_torch_nmf.py's limits); iterations and convergence exactly.  Bit
for bit where both sides run the port's own code on the same shapes
(padding, ``prefetch=False``, quantized against in-program int8,
``stream_bin`` against the in-memory call, ``serve`` against ``transform``
at one block).  Each refusal JAX makes before it compiles anything is held
to JAX's type and words, except where JAX's words name its own machinery
(Mosaic, ``jax.export``, ``shard_map``).  Mesh artifacts are served on a
2x2 and a 1x4 CPU mesh by one group of four gloo ranks
(``tests/torch_serving_ranks.py``) and held to JAX's single-device served
result; no JAX mesh program runs here.
"""

import dataclasses
import functools
import io
import json
import os
import pathlib
import subprocess
import sys
import warnings
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
from nmf_tpu import cli as jcli  # noqa: E402
from nmf_tpu import serving as js  # noqa: E402
from nmf_tpu.io import binio as jbin  # noqa: E402

import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch import cli  # noqa: E402
from nmf_tpu_torch import serving as ps  # noqa: E402
from nmf_tpu_torch.utils import autotune  # noqa: E402
from nmf_tpu_torch.utils.convert import config_from_dict, serving_from_jax  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_mesh as tm  # noqa: E402
import torch_serving_ranks as ranks  # noqa: E402

RTOL, ATOL, COST_RTOL = 1e-4, 1e-6, 1e-5
BF16_GEMM_RTOL, BF16_GEMM_COST_RTOL, BF16_FRO, BF16_COST_RTOL = 2e-2, 1e-4, 5e-2, 1e-3
M, K, NB = ranks.M, ranks.K, ranks.NB
EPS = ranks.EPS
HELPER = pathlib.Path(ranks.__file__)

# tests/test_serving.py's CONFIGS, JAX's every exportable family
CONFIGS = {
    "plain-kl": dict(max_iter=40, backend="jnp"),
    "thresh": dict(max_iter=200, thresh=1e-4, check_every=10, backend="jnp"),
    "beta-2": dict(max_iter=40, beta=2.0, backend="jnp"),
    "reg": dict(max_iter=40, l1_h=0.01, l2_h=0.1, backend="jnp"),
    "hals": dict(max_iter=40, beta=2.0, algorithm="hals", backend="jnp"),
    "accel": dict(max_iter=40, accelerate=True, backend="jnp"),
    "bf16-x": dict(max_iter=40, backend="jnp", precision=("bfloat16", "float32", "bfloat16")),
    "bf16-state": dict(max_iter=40, backend="jnp", precision=("bfloat16", "bfloat16", "float32")),
    "f32-fast": dict(max_iter=40, backend="jnp", precision=("float32_fast", "float32", "float32")),
    "int8-x": dict(max_iter=40, backend="jnp", precision=("float32", "float32", "int8")),
    "int8-rowblocks": dict(max_iter=40, backend="jnp",
                           precision=("float32", "float32", "int8", 16)),
}
# the KL MU configs, whose auto backend takes K1/K3 (their plain versions here)
KL_CONFIGS = ("plain-kl", "thresh", "accel", "bf16-x", "bf16-state", "f32-fast", "int8-x",
              "int8-rowblocks")


def _jcfg(name, **over):
    kw = dict(CONFIGS[name], **over)
    kw["precision"] = jt.Precision(*kw.get("precision", ()))
    return jt.SolveConfig(**kw)


def _pcfg(jcfg, **over):
    return dataclasses.replace(config_from_dict(dataclasses.asdict(jcfg)), **over)


@functools.lru_cache(maxsize=None)
def _problem():
    """(w, x, h0): tests/test_serving.py's problem (``RandomState(7)``)."""
    x, w, h0, _ = ranks.problem()
    return w, x, h0


def _mask(seed=11, x=None):
    shape = _problem()[1].shape if x is None else x.shape
    return (np.random.RandomState(seed).rand(*shape) > 0.3).astype(np.float32)


def _jax_t(tmp_path, jcfg, name="j.nmfz", **kw):
    path = str(tmp_path / name)
    js.save_transform(path, _problem()[0], kw.pop("n_block", NB), jcfg, platforms=("cpu",), **kw)
    return js.load_transform(path)


def _port_path(tmp_path, pcfg, name="p.nmfz", **kw):
    path = str(tmp_path / name)
    ps.save_transform(path, _problem()[0], kw.pop("n_block", NB), pcfg, platforms=("cpu",),
                      **kw)
    return path


def _port_t(tmp_path, pcfg, name="p.nmfz", **kw):
    return ps.load_transform(_port_path(tmp_path, pcfg, name, **kw), device="cpu")


def _hold(ours, theirs, prec=None):
    """A port ServingResult against a JAX one: H, costs, iterations,
    convergence.  Under ``bfloat16`` GEMMs and bf16 state (``prec``, a
    Precision of either package) tests/test_torch_nmf.py's limits: a
    last-ulp difference of W H flips the bf16 rounding of a Z entry and the
    flips compound (H rtol 2e-2 and costs 1e-4; bf16 state: H relative
    Frobenius 5e-2 and costs 1e-3)."""
    bf16_gemm = prec is not None and prec.matmul_dtype == "bfloat16"
    bf16_state = prec is not None and prec.state_dtype == "bfloat16"
    ref = np.asarray(theirs.h, np.float32)
    if bf16_state:
        assert np.linalg.norm(ours.h - ref) <= BF16_FRO * np.linalg.norm(ref)
    else:
        np.testing.assert_allclose(ours.h, ref, rtol=BF16_GEMM_RTOL if bf16_gemm else RTOL,
                                   atol=ATOL)
    np.testing.assert_array_equal(ours.block_iterations, np.asarray(theirs.block_iterations))
    np.testing.assert_array_equal(ours.block_converged, np.asarray(theirs.block_converged))
    cost_rtol = BF16_COST_RTOL if bf16_state else BF16_GEMM_COST_RTOL if bf16_gemm else COST_RTOL
    np.testing.assert_allclose(ours.block_costs, np.asarray(theirs.block_costs),
                               rtol=cost_rtol, atol=0)
    assert ours.h.dtype == np.float32 and ours.block_iterations.dtype == np.int32


def _refusal(fn):
    try:
        fn()
    except (ValueError, NotImplementedError, TypeError, RuntimeError) as e:
        return type(e).__name__, str(e)
    raise AssertionError("no refusal")


# --- every family, both packages ------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configs_match_jax(tmp_path, name):
    """Block-aligned serving of each JAX CONFIGS entry: the port's artifact
    against JAX's on the same W, X and h0."""
    w, x, h0 = _problem()
    jcfg = _jcfg(name)
    ours = _port_t(tmp_path, _pcfg(jcfg))(x, h0=h0)
    _hold(ours, _jax_t(tmp_path, jcfg)(x, h0=h0), jcfg.precision)
    assert ours.h.shape == (K, x.shape[1]) and ours.block_iterations.shape == (3,)


@pytest.mark.parametrize("name", sorted(set(CONFIGS) - {"thresh", "accel"}))
def test_ragged_tail_matches_jax(tmp_path, name):
    """A ragged tail block (5 real columns, 11 padded) through both
    packages: the padded block's cost counts the eps-clamped padding in
    both."""
    w, x, h0 = _problem()
    jcfg = _jcfg(name)
    n = ranks.N_CUT
    _hold(_port_t(tmp_path, _pcfg(jcfg))(x[:, :n], h0=h0[:, :n]),
          _jax_t(tmp_path, jcfg)(x[:, :n], h0=h0[:, :n]), jcfg.precision)


@pytest.mark.parametrize("name", KL_CONFIGS)
def test_auto_backend_matches_jax(tmp_path, name):
    """``backend="auto"`` stays in the port's meta and resolves at load on
    the serving device (the kernels' wrappers on the CPU, which take their
    plain versions), once, under the entry ``"serve"``; JAX pins ``auto``
    to ``jnp`` at export.  Both serve the same H."""
    w, x, h0 = _problem()
    jcfg = _jcfg(name, backend="auto")
    autotune.reset_counts()
    t = _port_t(tmp_path, _pcfg(jcfg))
    resolved = "jnp" if name == "int8-rowblocks" else "pallas"
    assert t.config.backend == "auto" and t.backend == resolved
    assert autotune.CHOICES == {("serve", resolved): 1}
    ours = t(x, h0=h0)
    t(x[:, :7], h0=h0[:, :7])
    assert autotune.CHOICES == {("serve", resolved): 1}     # never per call
    jax_t = _jax_t(tmp_path, jcfg)
    assert jax_t.config.backend == "jnp"
    _hold(ours, jax_t(x, h0=h0), jcfg.precision)


def test_auto_serves_solve_h_only_bits(tmp_path):
    """An ``auto`` artifact's block is ``solve_h_only`` at the resolved
    backend on the same block, bit for bit (the card check of this, with
    K1 and K3 launched, is chip_smoke.py phase 19a)."""
    w, x, h0 = _problem()
    pcfg = pt.SolveConfig(max_iter=30, check_every=10)
    t = _port_t(tmp_path, pcfg)
    res = t(x, h0=h0)
    for b in range(3):
        sl = slice(b * NB, (b + 1) * NB)
        ref = pt.solve_h_only(x[:, sl], w, h0[:, sl], dataclasses.replace(pcfg, backend=t.backend),
                              device="cpu")
        assert res.h[:, sl].tobytes() == ref.h.numpy().tobytes()
        assert np.float32(res.block_costs[b]) == np.float32(ref.cost)


# --- the calling contract ---------------------------------------------------


def test_padding_cannot_perturb_real_columns(tmp_path):
    w, x, h0 = _problem()
    t = _port_t(tmp_path, pt.SolveConfig(max_iter=30, backend="jnp"))
    n_cut = 2 * NB + 5
    full = t(x, h0=h0)
    cut = t(x[:, :n_cut], h0=h0[:, :n_cut])
    np.testing.assert_array_equal(cut.h, full.h[:, :n_cut])


def test_ragged_and_single_column(tmp_path):
    w, x, h0 = _problem()
    t = _port_t(tmp_path, pt.SolveConfig(max_iter=10, backend="jnp"))
    one = t(x[:, :1], h0=h0[:, :1])
    assert one.h.shape == (K, 1) and len(one.block_iterations) == 1
    _hold(one, _jax_t(tmp_path, jt.SolveConfig(max_iter=10, backend="jnp"))(x[:, :1],
                                                                           h0=h0[:, :1]))


@pytest.mark.parametrize("seed", [3, 2 ** 32 - 2])
def test_generated_h0_matches_jax(tmp_path, seed):
    """h0=None: block b starts from ``RandomState((seed + b) % 2**32)`` at
    its real width, clamped to eps, in both packages (the modulo wraps at
    the last seeds)."""
    w, x, _ = _problem()
    n = 2 * NB + 5
    t = _port_t(tmp_path, pt.SolveConfig(max_iter=10, backend="jnp"))
    _hold(t(x[:, :n], seed=seed),
          _jax_t(tmp_path, jt.SolveConfig(max_iter=10, backend="jnp"))(x[:, :n], seed=seed))
    h0 = np.concatenate([np.maximum(
        np.random.RandomState((seed + b) % 2 ** 32).rand(K, min(NB, n - b * NB))
        .astype(np.float32), np.float32(EPS)) for b in range(3)], axis=1)
    np.testing.assert_array_equal(t(x[:, :n], seed=seed).h, t(x[:, :n], h0=h0).h)


def test_shape_validation_is_jaxs(tmp_path):
    w, x, h0 = _problem()
    t = _port_t(tmp_path, pt.SolveConfig(max_iter=5, backend="jnp"))
    jx = _jax_t(tmp_path, jt.SolveConfig(max_iter=5, backend="jnp"))
    for args, kw in (((x[:-1],), {}), ((x,), dict(h0=h0[:, :-1])), ((x[:, :0],), {}),
                     ((x[0],), {})):
        assert _refusal(lambda: t(*args, **kw)) == _refusal(lambda: jx(*args, **kw))


def test_serving_result_aggregates():
    r = ps.ServingResult(h=np.zeros((2, 3), np.float32),
                         block_iterations=np.asarray([10, 20], np.int32),
                         block_costs=np.asarray([1.5, 2.5], np.float32),
                         block_converged=np.asarray([True, False]), n_block=2)
    assert (r.cost, r.iterations, r.converged) == (4.0, 20, False)
    assert [f.name for f in dataclasses.fields(ps.ServingResult)] == [
        f.name for f in dataclasses.fields(js.ServingResult)]


def test_attributes_are_jaxs(tmp_path):
    w, x, _ = _problem()
    cfg = jt.SolveConfig(max_iter=12, thresh=1e-3, backend="jnp")
    t, jx = _port_t(tmp_path, _pcfg(cfg)), _jax_t(tmp_path, cfg)
    for name in ("m", "k", "n_block", "masked", "quantized", "mesh_shape", "mesh"):
        assert getattr(t, name) == getattr(jx, name), name
    np.testing.assert_array_equal(t.w, jx.w)
    assert t.config == _pcfg(cfg) and t.platforms == ("cpu",)
    assert ps.FORMAT_VERSION == js.FORMAT_VERSION == 4
    assert set(js.__all__) == set(ps.__all__)


def test_public_names_are_jaxs():
    """All of nmf_tpu's public names have a counterpart (59 of 59)."""
    assert set(jt.__all__) <= set(pt.__all__)
    for name in ps.__all__:
        if name != "FORMAT_VERSION":
            assert getattr(pt, name) is getattr(ps, name)


# --- refusals ---------------------------------------------------------------

# case -> (arguments of export_transform after W, replaced by the port's own
# reason where JAX's words name its machinery: the port's phrase)
EXPORT_REFUSALS = {
    "live": (dict(n_block=NB, config=dict(live_metrics=True)), None),
    "n_block": (dict(n_block=0, config=dict()), None),
    "w_1d": (dict(n_block=NB, config=dict(), w_1d=True), None),
    "mesh_rows": (dict(n_block=NB, config=dict(), mesh_shape=(5, 1)), None),
    "mesh_cols": (dict(n_block=NB, config=dict(), mesh_shape=(1, 3)), None),
    "mesh_zero": (dict(n_block=NB, config=dict(), mesh_shape=(0, 2)), None),
    "masked_beta": (dict(n_block=NB, config=dict(beta=2.0), masked=True), None),
    "masked_hals": (dict(n_block=NB, config=dict(beta=2.0, algorithm="hals"), masked=True),
                    None),
    "quant_f32": (dict(n_block=NB, config=dict(), quantized_input=True), None),
    "quant_bf16": (dict(n_block=NB, config=dict(precision=("float32", "float32", "bfloat16")),
                        quantized_input=True), None),
    "pallas": (dict(n_block=NB, config=dict(backend="pallas")),
               "an artifact must serve on every platform it names"),
    "autotune": (dict(n_block=NB, config=dict(backend="autotune")),
                 "an artifact must serve on every platform it names"),
    "platforms": (dict(n_block=NB, config=dict(), platforms=()), "at least one serving target"),
    "mesh_int8": (dict(n_block=NB, config=dict(precision=("float32", "float32", "int8")),
                       mesh_shape=(4, 2)), "export with quantized_input=True instead"),
    "bad_config": (dict(n_block=NB, config=dict(check_every=0)), None),
}


@pytest.mark.parametrize("case", sorted(EXPORT_REFUSALS))
def test_export_refusals_are_jaxs(case):
    kw, own = EXPORT_REFUSALS[case]
    kw = dict(kw)
    w = _problem()[0]
    if kw.pop("w_1d", False):
        w = w[:, 0]
    cfg = dict(kw.pop("config"))
    prec = cfg.pop("precision", ())
    jcfg = jt.SolveConfig(precision=jt.Precision(*prec), **cfg)
    kw.setdefault("platforms", ("cpu",))
    theirs = _refusal(lambda: js.export_transform(w, config=jcfg, **kw))
    ours = _refusal(lambda: ps.export_transform(w, config=_pcfg(jcfg), **kw))
    if own is None:
        assert ours == theirs
    else:
        assert ours[0] == theirs[0] == "ValueError" and own in ours[1]


def test_platforms_are_the_ports(tmp_path):
    """The port serves on 'cuda' and 'cpu': names are lower-cased as JAX
    records them, anything else is refused, and a device type the artifact
    does not list is refused at load."""
    w = _problem()[0]
    e = ps.export_transform(w, NB, pt.SolveConfig(backend="jnp"), platforms=("CPU",))
    assert e.platforms == ("cpu",)
    assert ps.export_transform(w, NB).platforms == ("cuda", "cpu")
    with pytest.raises(ValueError, match="unknown serving platform 'tpu'"):
        ps.export_transform(w, NB, platforms=("tpu", "cpu"))
    path = str(tmp_path / "cuda_only.nmfz")
    ps.save_transform(path, w, NB, platforms=("cuda",))
    with pytest.raises(ValueError, match="serves on cuda, not on cpu"):
        ps.load_transform(path, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_no_card_raises(tmp_path):
    """No fallback: without a card the default device raises."""
    path = _port_path(tmp_path, pt.SolveConfig(backend="jnp"))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ps.load_transform(path)
    w, x, _ = _problem()
    jbin.write_matrix(x, tmp_path / "X.bin")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["serve", path, str(tmp_path / "X.bin"), "-o", str(tmp_path / "H.bin")])
    assert not (tmp_path / "H.bin").exists()


# --- the artifact's format --------------------------------------------------

# composition -> (config fields, export flags)
COMPOSITIONS = {
    "plain": (dict(), dict()),
    "bf16-x": (dict(precision=("float32", "float32", "bfloat16")), dict()),
    "int8-in-program": (dict(precision=("float32", "float32", "int8")), dict()),
    "masked": (dict(l1_h=0.01), dict(masked=True)),
    "quant-cols": (dict(precision=("float32", "float32", "int8")), dict(quantized_input=True)),
    "quant-rows": (dict(precision=("float32", "float32", "int8", 16)),
                   dict(quantized_input=True)),
    "masked-quant": (dict(precision=("float32", "float32", "int8")),
                     dict(masked=True, quantized_input=True)),
    "mesh": (dict(thresh=1e-3), dict(mesh_shape=(4, 2))),
    "mesh-masked": (dict(), dict(mesh_shape=(4, 2), masked=True)),
    "mesh-quant-cols": (dict(precision=("float32", "float32", "int8")),
                        dict(mesh_shape=(4, 2), quantized_input=True)),
    "mesh-quant-rows": (dict(precision=("float32", "float32", "int8", 4)),
                        dict(mesh_shape=(2, 4), quantized_input=True)),
    "mesh-masked-quant-rows": (dict(precision=("float32", "float32", "int8", 4)),
                               dict(mesh_shape=(2, 4), masked=True, quantized_input=True)),
}


def _composition(name, **over):
    cfg, flags = COMPOSITIONS[name]
    cfg = {"max_iter": 9, **cfg, **over}
    prec = cfg.pop("precision", ())
    return jt.SolveConfig(precision=jt.Precision(*prec), **cfg), dict(flags)


def _zip_json(path, member):
    with zipfile.ZipFile(path) as zf:
        return json.loads(zf.read(member))


@pytest.mark.parametrize("name", sorted(COMPOSITIONS))
def test_meta_and_signature_are_jaxs(tmp_path, name):
    """Both packages write the same meta for a composition, field by field
    (the lowest format version 1-4 among them), but the magic, the library
    version, the platforms and the backend (JAX pins ``auto`` to ``jnp``);
    the port's program.json inputs are the shapes and dtypes of JAX's
    program's ``in_avals``."""
    from jax import export as jax_export

    jcfg, flags = _composition(name)
    w = _problem()[0]
    jp, pp = str(tmp_path / "j.nmfz"), str(tmp_path / "p.nmfz")
    js.save_transform(jp, w, NB, jcfg, platforms=("cpu",), **flags)
    ps.save_transform(pp, w, NB, _pcfg(jcfg), platforms=("cpu",), **flags)
    jm, pm = _zip_json(jp, "meta.json"), _zip_json(pp, "meta.json")
    assert (jm["magic"], pm["magic"]) == ("nmf_tpu-serving", "nmf_tpu_torch-serving")
    assert set(jm) - {"jax_version"} == set(pm) - {"torch_version"}
    assert pm["torch_version"] == torch.__version__
    for key in set(jm) - {"magic", "jax_version", "platforms", "config"}:
        assert pm[key] == jm[key], key
    jc, pc = dict(jm["config"]), dict(pm["config"])
    assert (jc.pop("backend"), pc.pop("backend")) == ("jnp", "auto")
    assert pc == jc
    with zipfile.ZipFile(jp) as zf:
        avals = jax_export.deserialize(zf.read("program.bin")).in_avals
    prog = _zip_json(pp, "program.json")
    assert [(tuple(i["shape"]), i["dtype"]) for i in prog["inputs"]] == [
        (tuple(a.shape), str(a.dtype)) for a in avals]
    assert prog["entry"] == ("sharded_" if "mesh" in name else "") + (
        "masked_h_only" if flags.get("masked") else "h_only")
    with zipfile.ZipFile(pp) as zf:
        assert sorted(zf.namelist()) == ["meta.json", "program.json", "w.npy"]


def test_unknown_config_fields_warn_and_drop(tmp_path):
    w, x, h0 = _problem()
    path = _port_path(tmp_path, pt.SolveConfig(max_iter=10, backend="jnp"))
    with zipfile.ZipFile(path) as zf:
        members = {n: zf.read(n) for n in zf.namelist()}
    meta = json.loads(members["meta.json"])
    meta["config"]["some_future_knob"] = 42
    meta["config"]["precision"]["future_dtype"] = "fp4"
    members["meta.json"] = json.dumps(meta)
    doctored = str(tmp_path / "newer-writer.nmfz")
    with zipfile.ZipFile(doctored, "w") as zf:
        for n, b in members.items():
            zf.writestr(n, b)
    with pytest.warns(UserWarning, match="some_future_knob") as rec:
        t = ps.load_transform(doctored, device="cpu")
    assert any("future_dtype" in str(r.message) for r in rec)
    assert t.config.max_iter == 10
    assert t(x[:, :NB], h0=h0[:, :NB]).h.shape == (K, NB)


def _rewrite(src, dst, drop=(), **replace):
    with zipfile.ZipFile(src) as zf:
        members = {n: zf.read(n) for n in zf.namelist() if n not in drop}
    members.update(replace)
    with zipfile.ZipFile(dst, "w") as zf:
        for n, b in members.items():
            zf.writestr(n, b)
    return dst


def test_load_refusals_are_jaxs(tmp_path):
    """Not an artifact, a newer version, a truncated zip, a corrupt w.npy:
    JAX's checks and words (the port's magic and member names)."""
    empty_j, empty_p = str(tmp_path / "ej.nmfz"), str(tmp_path / "ep.nmfz")
    for p in (empty_j, empty_p):
        zipfile.ZipFile(p, "w").close()
    assert _refusal(lambda: ps.load_transform(empty_p, device="cpu")) == (
        "ValueError", f"{empty_p}: not an nmf_tpu_torch serving artifact")
    bogus = _rewrite(empty_p, str(tmp_path / "bogus.nmfz"),
                     **{"meta.json": '{"magic": "something-else"}'})
    with pytest.raises(ValueError, match="not an nmf_tpu_torch serving artifact"):
        ps.load_transform(bogus, device="cpu")
    for newer, magic, load in ((str(tmp_path / "nj.nmfz"), "nmf_tpu-serving", js.load_transform),
                               (str(tmp_path / "np.nmfz"), "nmf_tpu_torch-serving",
                                functools.partial(ps.load_transform, device="cpu"))):
        _rewrite(empty_p, newer, **{"meta.json": json.dumps(
            {"magic": magic, "format_version": ps.FORMAT_VERSION + 1})})
        with pytest.raises(ValueError, match="is newer than this library"):
            load(newer)
    w = _problem()[0]
    cfg = jt.SolveConfig(backend="jnp")
    jp, pp = str(tmp_path / "j.nmfz"), _port_path(tmp_path, _pcfg(cfg))
    js.save_transform(jp, w, NB, cfg, platforms=("cpu",))
    for drop in (("w.npy",), ("program.bin", "program.json", "w.npy")):
        tj = _rewrite(jp, str(tmp_path / "tj.nmfz"), drop=drop)
        tp = _rewrite(pp, str(tmp_path / "tp.nmfz"), drop=drop)
        theirs = _refusal(lambda: js.load_transform(tj))
        ours = _refusal(lambda: ps.load_transform(tp, device="cpu"))
        assert ours == (theirs[0], theirs[1].replace(tj, tp).replace("program.bin",
                                                                      "program.json"))
        assert "truncated artifact" in ours[1]
    bad = io.BytesIO()
    np.save(bad, np.zeros((M, K + 1), np.float32))
    tj = _rewrite(jp, str(tmp_path / "cj.nmfz"), **{"w.npy": bad.getvalue()})
    tp = _rewrite(pp, str(tmp_path / "cp.nmfz"), **{"w.npy": bad.getvalue()})
    theirs = _refusal(lambda: js.load_transform(tj))
    assert _refusal(lambda: ps.load_transform(tp, device="cpu")) == (
        theirs[0], theirs[1].replace(tj, tp))


# meta drift -> (the composition written, the meta fields rewritten)
DRIFTS = {
    "n_block": ("plain", dict(n_block=2 * NB)),
    "masked": ("plain", dict(masked=True)),
    "quantized": ("int8-in-program", dict(quantized_input=True, format_version=3)),
    "unmasked": ("masked", dict(masked=False)),
    "mesh": ("plain", dict(mesh_shape=[2, 2])),
    "m": ("plain", dict(m=M + 1)),
}


@pytest.mark.parametrize("case", sorted(DRIFTS))
def test_meta_program_drift_refused(tmp_path, case):
    """meta.json is held to program.json's own inputs and entry: a drifted
    n_block, masked or quantized_input flag (JAX's words, program.json for
    program.bin), or mesh shape fails at load."""
    comp, fields = DRIFTS[case]
    jcfg, flags = _composition(comp)
    w = _problem()[0]
    pp = str(tmp_path / "p.nmfz")
    ps.save_transform(pp, w, NB, _pcfg(jcfg), platforms=("cpu",), **flags)
    meta = dict(_zip_json(pp, "meta.json"), **fields)
    bad = _rewrite(pp, str(tmp_path / "bad.nmfz"), **{"meta.json": json.dumps(meta)})
    ours = _refusal(lambda: ps.load_transform(bad, device="cpu"))
    assert ours[0] == "ValueError" and "corrupt artifact" in ours[1]
    if case in ("n_block", "masked", "quantized"):
        jp = str(tmp_path / "j.nmfz")
        js.save_transform(jp, w, NB, jcfg, platforms=("cpu",), **flags)
        jmeta = dict(_zip_json(jp, "meta.json"), **fields)
        jbad = _rewrite(jp, str(tmp_path / "jbad.nmfz"), **{"meta.json": json.dumps(jmeta)})
        theirs = _refusal(lambda: js.load_transform(jbad))
        assert ours == (theirs[0], theirs[1].replace(jbad, bad).replace("program.bin",
                                                                         "program.json"))


def test_packages_refuse_each_others_artifacts(tmp_path):
    w = _problem()[0]
    jp = str(tmp_path / "j.nmfz")
    js.save_transform(jp, w, NB, jt.SolveConfig(backend="jnp"), platforms=("cpu",))
    pp = _port_path(tmp_path, pt.SolveConfig())
    with pytest.raises(ValueError, match="not an nmf_tpu serving artifact"):
        js.load_transform(pp)
    with pytest.raises(ValueError, match="JAX package's serving artifact.*serving_from_jax"):
        ps.load_transform(jp, device="cpu")


# --- streaming, prefetch ----------------------------------------------------


@pytest.mark.parametrize("n", [3 * NB, 2 * NB + 5])
def test_stream_bin_matches_in_memory(tmp_path, n):
    w, x, _ = _problem()
    x = x[:, :n]
    xp = str(tmp_path / "X.bin")
    jbin.write_matrix(x, xp)
    t = _port_t(tmp_path, pt.SolveConfig(max_iter=15, backend="jnp"))
    mem = t(x, seed=4)
    streamed = t.stream_bin(xp, seed=4)
    np.testing.assert_array_equal(streamed.h, mem.h)
    np.testing.assert_array_equal(streamed.block_iterations, mem.block_iterations)
    hp = str(tmp_path / "H.bin")
    disk = t.stream_bin(xp, out_path=hp, seed=4)
    assert disk.h is None and not os.path.exists(hp + ".part")
    assert jbin.read_matrix(hp).tobytes() == mem.h.tobytes()
    np.testing.assert_array_equal(disk.block_costs, streamed.block_costs)
    _hold(mem, _jax_t(tmp_path, jt.SolveConfig(max_iter=15, backend="jnp"))(x, seed=4))


def test_stream_bin_refusals_are_jaxs(tmp_path):
    w, x, _ = _problem()
    bad = str(tmp_path / "Xbad.bin")
    jbin.write_matrix(x[:-1], bad)
    t = _port_t(tmp_path, pt.SolveConfig(max_iter=5, backend="jnp"))
    jx = _jax_t(tmp_path, jt.SolveConfig(max_iter=5, backend="jnp"))
    assert _refusal(lambda: t.stream_bin(bad)) == _refusal(lambda: jx.stream_bin(bad))
    xp, mp = str(tmp_path / "X.bin"), str(tmp_path / "M.bin")
    jbin.write_matrix(x, xp)
    jbin.write_matrix(_mask(), mp)
    assert _refusal(lambda: t.stream_bin(xp, mask_path=mp)) == _refusal(
        lambda: jx.stream_bin(xp, mask_path=mp))


def test_stream_bin_failure_leaves_no_output(tmp_path):
    w, x, _ = _problem()
    xp = str(tmp_path / "X.bin")
    jbin.write_matrix(x, xp)
    data = open(xp, "rb").read()
    with open(xp, "wb") as f:
        f.write(data[: 8 + M * NB * 4])
    hp = str(tmp_path / "H.bin")
    t = _port_t(tmp_path, pt.SolveConfig(max_iter=5, backend="jnp"))
    with pytest.raises(ValueError):
        t.stream_bin(xp, out_path=hp)
    assert not os.path.exists(hp) and not os.path.exists(hp + ".part")


def test_stream_bin_failure_mid_stream_removes_part(tmp_path, monkeypatch):
    """A stream that dies after some blocks were written removes its
    ``.part`` and leaves no output."""
    w, x, _ = _problem()
    xp = str(tmp_path / "X.bin")
    jbin.write_matrix(x, xp)
    t = _port_t(tmp_path, pt.SolveConfig(max_iter=5, backend="jnp"))
    real = ps.BinColumnSource.columns

    def failing(self, j0, j1):
        if j0 >= 2 * NB:
            raise OSError("disk gone")
        return real(self, j0, j1)

    monkeypatch.setattr(ps.BinColumnSource, "columns", failing)
    hp = str(tmp_path / "H.bin")
    with pytest.raises(OSError, match="disk gone"):
        t.stream_bin(xp, out_path=hp, prefetch=False)
    assert not os.path.exists(hp) and not os.path.exists(hp + ".part")


@pytest.mark.parametrize("name", ["plain-kl", "accel", "int8-x"])
def test_no_prefetch_bit_identical(tmp_path, name):
    w, x, _ = _problem()
    xp = str(tmp_path / "X.bin")
    jbin.write_matrix(x, xp)
    t = _port_t(tmp_path, _pcfg(_jcfg(name, max_iter=10), backend="auto"))
    a, b = t(x, seed=1, prefetch=False), t(x, seed=1)
    assert a.h.tobytes() == b.h.tobytes() and a.block_costs.tobytes() == b.block_costs.tobytes()
    np.testing.assert_array_equal(t.stream_bin(xp, seed=1, prefetch=False).h,
                                  t.stream_bin(xp, seed=1).h)


def test_h0_list_input_accepted(tmp_path):
    w, x, _ = _problem()
    x = x[:, :NB]
    xp = str(tmp_path / "X1.bin")
    jbin.write_matrix(x, xp)
    t = _port_t(tmp_path, pt.SolveConfig(max_iter=5, backend="jnp"))
    h0 = [[0.5] * NB] * K
    np.testing.assert_array_equal(t(x, h0=h0).h, t.stream_bin(xp, h0=h0).h)


# --- masked, quantized ------------------------------------------------------


@pytest.mark.parametrize("n", [3 * NB, 2 * NB + 5])
def test_masked_matches_jax(tmp_path, n):
    w, x, h0 = _problem()
    mask = _mask()
    cfg = jt.SolveConfig(max_iter=25, backend="jnp", l1_h=0.01)
    t = _port_t(tmp_path, _pcfg(cfg), masked=True)
    assert t.masked and t.backend == "jnp"
    ours = t(x[:, :n], h0=h0[:, :n], mask=mask[:, :n])
    _hold(ours, _jax_t(tmp_path, cfg, masked=True)(x[:, :n], h0=h0[:, :n], mask=mask[:, :n]))


def test_masked_padding_fully_inert(tmp_path):
    w, x, h0 = _problem()
    mask = _mask(12)
    t = _port_t(tmp_path, pt.SolveConfig(max_iter=10, backend="jnp"), masked=True)
    n_cut = 2 * NB + 5
    res = t(x[:, :n_cut], h0=h0[:, :n_cut], mask=mask[:, :n_cut])
    for b in range(2):
        sl = slice(b * NB, (b + 1) * NB)
        np.testing.assert_array_equal(res.h[:, sl], t(x[:, sl], h0=h0[:, sl], mask=mask[:, sl]).h)


def test_masked_contract_is_jaxs(tmp_path):
    w, x, h0 = _problem()
    cfg = jt.SolveConfig(max_iter=5, backend="jnp")
    t, jx = _port_t(tmp_path, _pcfg(cfg), masked=True), _jax_t(tmp_path, cfg, masked=True)
    plain, jplain = _port_t(tmp_path, _pcfg(cfg), "q.nmfz"), _jax_t(tmp_path, cfg, "q.nmfz")
    for ours, theirs in (
        (lambda: t(x), lambda: jx(x)),
        (lambda: t(x, mask=np.ones((1, 1), np.float32)),
         lambda: jx(x, mask=np.ones((1, 1), np.float32))),
        (lambda: t.stream_bin("nope.bin"), lambda: jx.stream_bin("nope.bin")),
        (lambda: plain(x, mask=np.ones_like(x)), lambda: jplain(x, mask=np.ones_like(x))),
    ):
        assert _refusal(ours) == _refusal(theirs)


@pytest.mark.parametrize("name", ["int8-x", "int8-rowblocks"])
def test_quantized_bit_identical_to_in_program(tmp_path, name):
    """Quantized-input serving == in-program quantization, bit for bit, the
    ragged tail too; and within tolerance of JAX's quantized artifact."""
    w, x, h0 = _problem()
    jcfg = _jcfg(name)
    for backend in ("jnp", "auto"):
        pcfg = _pcfg(jcfg, backend=backend)
        plain = _port_t(tmp_path, pcfg, "plain.nmfz")
        tq = _port_t(tmp_path, pcfg, "quant.nmfz", quantized_input=True)
        assert tq.meta["format_version"] == 3 and tq.quantized
        for xs, h0s in ((x, h0), (x[:, :2 * NB + 5], h0[:, :2 * NB + 5])):
            ref, res = plain(xs, h0=h0s), tq(xs, h0=h0s)
            assert res.h.tobytes() == ref.h.tobytes()
            np.testing.assert_array_equal(res.block_costs, ref.block_costs)
            np.testing.assert_array_equal(res.block_iterations, ref.block_iterations)
    _hold(tq(x, h0=h0), _jax_t(tmp_path, jcfg, quantized_input=True)(x, h0=h0))


@pytest.mark.parametrize("name", ["int8-x", "int8-rowblocks"])
def test_masked_quantized_matches(tmp_path, name):
    """Masked x quantized-input (v4): NaN in the unobserved entries, the
    host's clamp, zeroing and quantization give the masked in-program-int8
    artifact's bits, and JAX's v4 result within tolerance; a weighted mask
    is refused with JAX's words."""
    w, x, h0 = _problem()
    jcfg = _jcfg(name)
    mask = _mask(7)
    xg = x.copy()
    xg[mask == 0] = np.nan
    plain = _port_t(tmp_path, _pcfg(jcfg), "plain.nmfz", masked=True)
    tq = _port_t(tmp_path, _pcfg(jcfg), "quant.nmfz", masked=True, quantized_input=True)
    assert tq.meta["format_version"] == 4
    jq = _jax_t(tmp_path, jcfg, masked=True, quantized_input=True)
    for xs, h0s, ms in ((xg, h0, mask), (xg[:, :NB + 5], h0[:, :NB + 5], mask[:, :NB + 5])):
        ref, res = plain(xs, h0=h0s, mask=ms), tq(xs, h0=h0s, mask=ms)
        assert res.h.tobytes() == ref.h.tobytes()
        np.testing.assert_array_equal(res.block_costs, ref.block_costs)
        _hold(res, jq(xs, h0=h0s, mask=ms))
    half = mask * 0.5
    assert _refusal(lambda: tq(x, mask=half)) == _refusal(lambda: jq(x, mask=half))


@pytest.mark.parametrize("quantized", [False, True])
def test_masked_stream_bin(tmp_path, quantized):
    w, x, _ = _problem()
    cfg = _jcfg("int8-x") if quantized else jt.SolveConfig(max_iter=20, backend="jnp")
    mask = _mask()
    t = _port_t(tmp_path, _pcfg(cfg), masked=True, quantized_input=quantized)
    xp, mp, out = str(tmp_path / "X.bin"), str(tmp_path / "mask.bin"), str(tmp_path / "H.bin")
    jbin.write_matrix(x, xp)
    jbin.write_matrix(mask, mp)
    streamed = t.stream_bin(xp, out_path=out, seed=3, mask_path=mp)
    in_mem = t(x, seed=3, mask=mask)
    assert jbin.read_matrix(out).tobytes() == in_mem.h.tobytes()
    np.testing.assert_array_equal(streamed.block_costs, in_mem.block_costs)
    short = str(tmp_path / "short.bin")
    jbin.write_matrix(mask[:, :-1], short)
    with pytest.raises(ValueError, match="must match X"):
        t.stream_bin(xp, mask_path=short)


# tests/serving_cases.py's fixed-seed cases that run on one device, plus two
SERVING_CASES = {
    "masked-quant-rowblock": dict(m=16, k=4, nb=8, n=20, iters=5, masked=True, quant=True,
                                  qrows=4, seed=11),
    "quant-ragged-tail": dict(m=12, k=3, nb=6, n=15, iters=4, masked=False, quant=True,
                              qrows=0, seed=12),
    "masked": dict(m=8, k=2, nb=4, n=10, iters=3, masked=True, quant=False, qrows=0, seed=13),
    "plain": dict(m=20, k=3, nb=7, n=30, iters=6, masked=False, quant=False, qrows=0, seed=14),
}


@pytest.mark.parametrize("case", sorted(SERVING_CASES))
def test_serving_composition_fixed_seed(tmp_path, case):
    """``serving_cases.run_serving_composition``'s discipline on the port:
    the artifact against the same composition with the quantization on the
    other side of the wire (bitwise), against the port's live H-only solve
    block by block, and against JAX's artifact."""
    c = SERVING_CASES[case]
    m, k, nb, n, iters = c["m"], c["k"], c["nb"], c["n"], c["iters"]
    rng = np.random.RandomState(c["seed"])
    x = (rng.rand(m, n) * float(10.0 ** rng.uniform(-1, 1))).astype(np.float32)
    h0 = np.maximum(rng.rand(k, n).astype(np.float32), np.float32(EPS))
    w = rng.rand(m, k).astype(np.float32) + 0.05
    mask = (rng.rand(m, n) > 0.3).astype(np.float32) if c["masked"] else None
    jcfg = jt.SolveConfig(max_iter=iters, check_every=max(1, iters), backend="jnp",
                          precision=jt.Precision(x_dtype="int8", x_quant_rows=c["qrows"])
                          if c["quant"] else jt.Precision())
    pcfg = _pcfg(jcfg)
    flags = dict(masked=c["masked"], quantized_input=c["quant"])
    pp, jp = str(tmp_path / "p.nmfz"), str(tmp_path / "j.nmfz")
    ps.save_transform(pp, w, nb, pcfg, platforms=("cpu",), **flags)
    res = ps.load_transform(pp, device="cpu")(x, h0=h0, mask=mask)
    if c["quant"]:
        rp = str(tmp_path / "r.nmfz")
        ps.save_transform(rp, w, nb, pcfg, platforms=("cpu",), masked=c["masked"])
        ref = ps.load_transform(rp, device="cpu")(x, h0=h0, mask=mask)
        assert res.h.tobytes() == ref.h.tobytes()
    for j0 in range(0, n, nb):
        j1 = min(j0 + nb, n)
        if c["masked"]:
            live = pt.solve_masked_h_only(x[:, j0:j1], w, h0[:, j0:j1], mask[:, j0:j1], pcfg,
                                          device="cpu")
        else:
            live = pt.solve_h_only(x[:, j0:j1], w, h0[:, j0:j1], pcfg, device="cpu")
        np.testing.assert_allclose(res.h[:, j0:j1], live.h.numpy(), rtol=0,
                                   atol=5e-5 * max(float(live.h.max()), 1e-6))
    js.save_transform(jp, w, nb, jcfg, platforms=("cpu",), **flags)
    _hold(res, js.load_transform(jp)(x, h0=h0, mask=mask))


# --- serving_from_jax -------------------------------------------------------


@pytest.mark.parametrize("name", ["plain", "masked", "quant-cols", "quant-rows",
                                  "masked-quant", "bf16-x"])
def test_serving_from_jax_serves_like_jax(tmp_path, name):
    """A JAX artifact carried across (meta.json and w.npy only) and served
    by the port matches JAX serving the original; the backend stays
    ``jnp``, the format version and flags JAX's."""
    jcfg, flags = _composition(name, max_iter=20, check_every=5)
    w, x, h0 = _problem()
    jp, pp = str(tmp_path / "j.nmfz"), str(tmp_path / "p.nmfz")
    js.save_transform(jp, w, NB, jcfg, platforms=("cpu",), **flags)
    serving_from_jax(jp, pp, platforms=("cpu",))
    jm, pm = _zip_json(jp, "meta.json"), _zip_json(pp, "meta.json")
    assert pm["config"] == jm["config"] and pm["config"]["backend"] == "jnp"
    for key in ("format_version", "m", "k", "n_block", "masked", "quantized_input",
                "mesh_shape"):
        assert pm[key] == jm[key], key
    t = ps.load_transform(pp, device="cpu")
    np.testing.assert_array_equal(t.w, w)
    mask = _mask() if flags.get("masked") else None
    n = 2 * NB + 5
    _hold(t(x[:, :n], h0=h0[:, :n], mask=None if mask is None else mask[:, :n]),
          js.load_transform(jp)(x[:, :n], h0=h0[:, :n],
                                mask=None if mask is None else mask[:, :n]))


def test_serving_from_jax_mesh_and_platforms(tmp_path):
    jcfg, flags = _composition("mesh-quant-rows")
    jp, pp = str(tmp_path / "j.nmfz"), str(tmp_path / "p.nmfz")
    js.save_transform(jp, _problem()[0], NB, jcfg, platforms=("cpu",), **flags)
    serving_from_jax(jp, pp)
    pm = _zip_json(pp, "meta.json")
    assert pm["mesh_shape"] == [2, 4] and pm["format_version"] == 4
    assert pm["platforms"] == ["cuda", "cpu"]
    assert _zip_json(pp, "program.json")["entry"] == "sharded_h_only"


def test_serving_from_jax_refusals(tmp_path):
    w = _problem()[0]
    jp = str(tmp_path / "j.nmfz")
    js.save_transform(jp, w, NB, jt.SolveConfig(backend="jnp"), platforms=("cpu",))
    out = str(tmp_path / "out.nmfz")
    pp = _port_path(tmp_path, pt.SolveConfig())
    with pytest.raises(ValueError, match="not an nmf_tpu serving artifact"):
        serving_from_jax(pp, out)
    newer = _rewrite(jp, str(tmp_path / "n.nmfz"), **{"meta.json": json.dumps(
        dict(_zip_json(jp, "meta.json"), format_version=5))})
    with pytest.raises(ValueError, match="newer than this library"):
        serving_from_jax(newer, out)
    with pytest.raises(ValueError, match=r"truncated artifact \(missing \['w.npy'\]\)"):
        serving_from_jax(_rewrite(jp, str(tmp_path / "t.nmfz"), drop=("w.npy",)), out)
    bad = io.BytesIO()
    np.save(bad, np.zeros((M + 1, K), np.float32))
    with pytest.raises(ValueError, match="corrupt artifact"):
        serving_from_jax(_rewrite(jp, str(tmp_path / "c.nmfz"), **{"w.npy": bad.getvalue()}),
                         out)
    # program.bin is never read: a JAX artifact without it converts
    serving_from_jax(_rewrite(jp, str(tmp_path / "np.nmfz"), drop=("program.bin",)), out)
    assert ps.load_transform(out, device="cpu").m == M
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        serving_from_jax(jp, out)


# --- the CLI ----------------------------------------------------------------


def _files(tmp_path, mask=False):
    w, x, h0 = _problem()
    paths = {}
    for name, a in (("W", w), ("X", x), ("H0", h0), ("M", _mask())):
        paths[name] = str(tmp_path / f"{name}.bin")
        jbin.write_matrix(a, paths[name])
    return paths


def _jax_cli(args, cwd):
    here = os.getcwd()
    os.chdir(cwd)
    try:
        return jcli.main(args)
    finally:
        os.chdir(here)


def test_cli_export_serve_roundtrip(tmp_path):
    """export -> serve against transform: within tolerance over three
    blocks from one --h0, bit for bit at one block from the default h0 (the
    CLI transform's ``RandomState(seed)`` start)."""
    f = _files(tmp_path)
    ap = str(tmp_path / "m.nmfz")
    assert cli.main(["export", f["W"], "-o", ap, "--block-cols", str(NB), "--platforms", "cpu",
                     "--max-iter", "20", "-q"]) == 0
    hs, ht = str(tmp_path / "Hs.bin"), str(tmp_path / "Ht.bin")
    assert cli.main(["serve", ap, f["X"], "-o", hs, "--h0", f["H0"], "--device", "cpu",
                     "-q"]) == 0
    assert cli.main(["transform", f["X"], f["W"], "-o", ht, "--max-iter", "20", "--h0",
                     f["H0"], "--device", "cpu", "-q"]) == 0
    np.testing.assert_allclose(jbin.read_matrix(hs), jbin.read_matrix(ht), rtol=RTOL, atol=ATOL)
    x1 = str(tmp_path / "X1.bin")
    jbin.write_matrix(_problem()[1][:, :NB], x1)
    for backend in ("auto", "jnp"):
        ap1 = str(tmp_path / f"m_{backend}.nmfz")
        assert cli.main(["export", f["W"], "-o", ap1, "--block-cols", str(NB), "--platforms",
                         "cpu", "--max-iter", "20", "--backend", backend, "-q"]) == 0
        assert cli.main(["serve", ap1, x1, "-o", hs, "--device", "cpu", "-q"]) == 0
        assert cli.main(["transform", x1, f["W"], "-o", ht, "--max-iter", "20", "--backend",
                         backend, "--device", "cpu", "-q"]) == 0
        assert jbin.read_matrix(hs).tobytes() == jbin.read_matrix(ht).tobytes()


@pytest.mark.parametrize("extra", [[], ["--masked"], ["--x-dtype", "int8", "--quantized-input"],
                                   ["--beta", "2", "--algorithm", "hals"],
                                   ["--thresh", "1e-3", "--check-every", "5"]])
def test_cli_serve_matches_jax_cli(tmp_path, extra):
    """Both CLIs: export and serve the same files (default h0, three
    blocks), the H files within tolerance."""
    f = _files(tmp_path)
    for label, main in (("p", cli.main), ("j", lambda a: _jax_cli(a, tmp_path))):
        ap = str(tmp_path / f"{label}.nmfz")
        assert main(["export", f["W"], "-o", ap, "--block-cols", str(NB), "--platforms", "cpu",
                     "--max-iter", "30", "-q", *extra]) == 0
        srv = ["serve", ap, f["X"], "-o", str(tmp_path / f"H{label}.bin"), "-q"]
        if "--masked" in extra:
            srv += ["--mask", f["M"]]
        assert main(srv + (["--device", "cpu"] if label == "p" else [])) == 0
    np.testing.assert_allclose(jbin.read_matrix(tmp_path / "Hp.bin"),
                               jbin.read_matrix(tmp_path / "Hj.bin"), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("flags", [["--backend", "pallas"], ["--backend", "autotune"],
                                   ["--block-n", "64"], ["--platforms", ","],
                                   ["--out-of-core"], ["--checkpoint-dir", "ck"], ["--live"],
                                   ["--strict-compat"], ["--jsonl", "m.jsonl"],
                                   ["--quantized-input"], ["--masked", "--beta", "2"]])
def test_cli_export_refusals_exit_2(tmp_path, capsys, flags):
    """Each flag an artifact cannot carry exits 2 through both CLIs and
    writes nothing."""
    f = _files(tmp_path)
    out = str(tmp_path / "m.nmfz")
    assert cli.main(["export", f["W"], "-o", out, *flags]) == 2
    ours = capsys.readouterr().err
    assert not os.path.exists(out)
    jflags = ["--platforms", "cpu", *flags] if "--platforms" not in flags else flags
    assert _jax_cli(["export", f["W"], "-o", out, *jflags], tmp_path) == 2
    theirs = capsys.readouterr().err
    assert not os.path.exists(out)
    if flags[0] not in ("--backend", "--platforms"):
        assert ours == theirs


def test_cli_serve_out_of_core_and_no_prefetch(tmp_path):
    f = _files(tmp_path)
    ap = str(tmp_path / "m.nmfz")
    assert cli.main(["export", f["W"], "-o", ap, "--block-cols", str(NB), "--platforms", "cpu",
                     "--max-iter", "10", "-q"]) == 0
    outs = {}
    for label, extra in (("mem", []), ("ooc", ["--out-of-core"]),
                         ("serial", ["--no-prefetch"]),
                         ("ooc_serial", ["--out-of-core", "--no-prefetch"])):
        outs[label] = str(tmp_path / f"H_{label}.bin")
        assert cli.main(["serve", ap, f["X"], "-o", outs[label], "--device", "cpu", "-q",
                         *extra]) == 0
    first = open(outs["mem"], "rb").read()
    for label, path in outs.items():
        assert open(path, "rb").read() == first, label
    t = ps.load_transform(ap, device="cpu")
    assert jbin.read_matrix(outs["mem"]).tobytes() == t(_problem()[1], seed=0).h.tobytes()


def test_cli_masked_and_quantized_export_serve(tmp_path):
    f = _files(tmp_path)
    outs = {}
    for label, extra in (("plain", []), ("quant", ["--quantized-input"])):
        ap = str(tmp_path / f"{label}.nmfz")
        assert cli.main(["export", f["W"], "-o", ap, "--block-cols", str(NB), "--platforms",
                         "cpu", "--max-iter", "10", "--x-dtype", "int8", "--masked", "-q",
                         *extra]) == 0
        outs[label] = str(tmp_path / f"H_{label}.bin")
        assert cli.main(["serve", ap, f["X"], "-o", outs[label], "--mask", f["M"], "--h0",
                         f["H0"], "--device", "cpu", "-q"]) == 0
    assert open(outs["plain"], "rb").read() == open(outs["quant"], "rb").read()
    ref = jt.solve_masked_h_only(*(jbin.read_matrix(f[n]) for n in ("X", "W", "H0", "M")),
                                 jt.SolveConfig(max_iter=10, backend="jnp",
                                                precision=jt.Precision(x_dtype="int8")))
    np.testing.assert_allclose(jbin.read_matrix(outs["quant"]), np.asarray(ref.h), rtol=RTOL,
                               atol=ATOL)
    ooc = str(tmp_path / "H_ooc.bin")
    assert cli.main(["serve", str(tmp_path / "quant.nmfz"), f["X"], "-o", ooc, "--mask", f["M"],
                     "--out-of-core", "--device", "cpu", "-q"]) == 0
    t = ps.load_transform(str(tmp_path / "quant.nmfz"), device="cpu")
    assert jbin.read_matrix(ooc).tobytes() == t(_problem()[1], seed=0, mask=_mask()).h.tobytes()


def test_cli_info_describes_artifacts(tmp_path, capsys):
    w = _problem()[0]
    pp = str(tmp_path / "p.nmfz")
    ps.save_transform(pp, w, NB, pt.SolveConfig(max_iter=7, precision=pt.Precision(
        x_dtype="int8")), mesh_shape=(2, 2), masked=True, quantized_input=True)
    jp = str(tmp_path / "j.nmfz")
    js.save_transform(jp, w, NB, jt.SolveConfig(max_iter=7, backend="jnp"), platforms=("cpu",))
    npz = str(tmp_path / "a.npz")
    np.savez(npz, a=np.zeros(2))
    jbin.write_matrix(w, tmp_path / "W.bin")
    assert cli.main(["info", pp, jp, npz, str(tmp_path / "W.bin")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"{pp}: serving artifact v4 — W {M}x{K}, block {NB} cols, "
                               "platforms cuda,cpu, mesh 2x2, masked (serve needs --mask), "
                               "quantized-input (host int8 quantization), max_iter 7")
    assert f"torch {torch.__version__}" in lines[0] and "backend auto" in lines[0]
    assert "JAX package's serving artifact v1" in lines[1] and "serving_from_jax" in lines[1]
    assert lines[2] == f"{npz}: zip, but not an nmf_tpu_torch serving artifact"
    assert lines[3].startswith(f"{tmp_path / 'W.bin'}: {M}x{K} f32")


def test_cli_lists_every_jax_subcommand():
    def subs(parser):
        action = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
        return set(action.choices)

    assert subs(jcli.build_parser()) == subs(cli.build_parser()) == {
        "run", "transform", "separate", "select", "batch", "export", "serve", "gen", "info",
        "doctor"}


@pytest.mark.parametrize("sub", ["export", "serve", "info"])
def test_every_jax_flag_of_export_and_serve_is_known(sub):
    """Each flag of the JAX CLI's export, serve and info is in the port's
    (serve adds ``--device``); the defaults match but ``--platforms``."""
    def actions(parser):
        action = next(a for a in parser._actions if a.dest == "command")
        return {o: a for a in action.choices[sub]._actions for o in a.option_strings}

    theirs, ours = actions(jcli.build_parser()), actions(cli.build_parser())
    assert set(theirs) <= set(ours)
    for flag, a in theirs.items():
        want = "cuda,cpu" if flag == "--platforms" else a.default
        assert ours[flag].default == want, flag
    if sub == "serve":
        assert set(ours) - set(theirs) == {"--device"} and ours["--device"].default == "cuda"


# --- mesh artifacts: one group of four gloo ranks --------------------------


def _group(tmp_path_factory):
    """The output directory of the four-rank group, run once per pytest
    run whichever worker asks first."""
    import fcntl
    import shutil

    root = tm._shared_root(tmp_path_factory).parent / "torch_serving"
    root.mkdir(parents=True, exist_ok=True)
    out = root / "ranks"
    with open(root / "ranks.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (out / "done").exists():
            return out
        if (out / "failed").exists():
            pytest.fail((out / "failed").read_text())
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir()
        cmds = [[sys.executable, str(HELPER), str(i), "4", str(out / "store"), str(out)]
                for i in range(4)]
        try:
            tm._run_ranks(cmds, [out / f"rank{i}.log" for i in range(4)])
        except BaseException as e:
            (out / "failed").write_text(str(e))
            raise
        (out / "done").write_text("ok")
    return out


def _jax_single(case, tmp):
    """JAX's single-device served result of a mesh case (no JAX mesh)."""
    c = ranks.CASES[case]
    kw = ranks.config_kwargs(case)
    kw["precision"] = jt.Precision(**kw.get("precision", {}))
    path = os.path.join(tmp, f"{case}.nmfz")
    js.save_transform(path, _problem()[0], NB, jt.SolveConfig(**kw), platforms=("cpu",),
                      masked=bool(c.get("masked")), quantized_input=bool(c.get("quant")))
    x, h0, mask = ranks.call_inputs(case)
    seed = 2 if c.get("stream") else 0
    return js.load_transform(path)(x, h0=h0, mask=mask, seed=seed)


@pytest.mark.parametrize("case", sorted(set(ranks.CASES) - {"wrong_mesh"}))
def test_mesh_artifact_matches_jax_single_device(tmp_path_factory, case):
    """Each rank of the 2x2 or 1x4 mesh returns the whole result (H
    gathered over 'mc', the scalars replicated), held to JAX's
    single-device served result; ``prefetch=False`` gives the same bits, and
    ``stream_bin`` on the mesh writes the in-memory call's bytes once."""
    out = _group(tmp_path_factory)
    infos = [json.loads((out / f"{case}.r{i}.json").read_text()) for i in range(4)]
    assert all("error" not in i for i in infos), infos
    for key in ("block_costs", "block_iterations", "block_converged"):
        assert all(i[key] == infos[0][key] for i in infos), key
    assert infos[0]["mesh_shape"] == list(ranks.CASES[case]["mesh"])
    assert infos[0]["backend"] == "jnp"
    if case == "stream_bin":
        assert all(i["file_bitwise"] for i in infos)
        assert infos[0]["streamed_h_none"] and not infos[1]["streamed_h_none"]
    else:
        assert all(i["no_prefetch_bitwise"] for i in infos)
    h = np.load(out / f"{case}.npz")["h"]
    ours = ps.ServingResult(h=h, block_iterations=np.asarray(infos[0]["block_iterations"],
                                                             np.int32),
                            block_costs=np.asarray(infos[0]["block_costs"], np.float32),
                            block_converged=np.asarray(infos[0]["block_converged"]), n_block=NB)
    _hold(ours, _jax_single(case, str(tmp_path_factory.mktemp("jax_single"))),
          pt.Precision(**ranks.config_kwargs(case).get("precision", {})))


def test_mesh_artifact_refuses_the_wrong_mesh(tmp_path_factory):
    out = _group(tmp_path_factory)
    for i in range(4):
        assert json.loads((out / f"wrong_mesh.r{i}.json").read_text()) == {
            "error": "ValueError", "message": "artifact was exported for a 2x2 mesh, got 1x4"}


def test_cli_serve_mesh_under_torchrun(tmp_path_factory, tmp_path):
    """``export --mesh 2x2`` needs no process group; ``serve --mesh 2x2``
    on four gloo ranks under torch.distributed.run (rank 0 writes), in
    memory and ``--out-of-core``: the bytes of the rank group's in-process
    call of the same artifact and default h0."""
    out = _group(tmp_path_factory)
    f = _files(tmp_path)
    ap = str(tmp_path / "m.nmfz")
    assert cli.main(["export", f["W"], "-o", ap, "--block-cols", str(NB), "--mesh", "2x2",
                     "--platforms", "cpu", "--max-iter", "25", "-q"]) == 0
    assert _zip_json(ap, "meta.json")["config"] == _zip_json(out / "seeded.nmfz",
                                                             "meta.json")["config"]
    want = np.load(out / "seeded.npz")["h"].tobytes()
    for extra in ([], ["--out-of-core"]):
        tm._torchrun(["serve", ap, "X.bin", "-o", "Hm.bin", "--mesh", "2x2", "--device", "cpu",
                      "-q", *extra], tmp_path, 4)
        assert jbin.read_matrix(tmp_path / "Hm.bin").tobytes() == want
        os.unlink(tmp_path / "Hm.bin")
    proc = subprocess.run([sys.executable, "-m", "nmf_tpu_torch", "serve", ap, "X.bin", "-o",
                           "H1.bin", "--device", "cpu"], cwd=tmp_path, env=tm._env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "needs 4 devices, have 1" in proc.stderr


def test_chip_smoke_phase_19_reads_the_serve_launches():
    """``chip_smoke.py`` phase 19: a served call's counts (K1 each
    iteration and K3 each check of each block where ``auto`` resolved to the
    kernels, nothing else) and the kernels line's reader of them, without a
    card."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_for_serving_test",
                                                  tm.REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.PHASES[-2:] == ("serving", "examples")
    m, n, k, nb = smoke.SERVE_SHAPE
    assert (m, n, k, nb, smoke.SERVE_ITERS) == (2048, 16384, 128, 2048, 50)
    want = smoke._serve_want("pallas", n // nb, smoke.SERVE_ITERS, 1)
    assert (want["update_h"], want["kl_cost"], want["update_w"]) == (400, 8, 0)
    assert not any(v for key, v in want.items() if key not in ("update_h", "kl_cost"))
    assert not any(smoke._serve_want("jnp", 8, 50, 1).values())
    launches = {"serve auto float32": want, "serve jnp float32": smoke._serve_want("jnp", 8, 50, 1)}
    assert smoke._serve_launches(launches, "update_h")["auto float32"] == 400
    assert smoke._serve_launches(launches, "kl_cost") == {
        run[6:]: (8 if run == "serve auto float32" else 0) for run in smoke._SERVE_RUNS}
    assert not any(smoke._serve_launches(launches, "h_numerator").values())
    assert smoke._block_h0(k, 3, 2).tobytes() == np.maximum(
        np.random.RandomState(2).rand(k, 3).astype(np.float32), np.float32(EPS)).tobytes()
