"""The kernel build's source hash, and chip_smoke.py's and kernel_digest.py's readings.

``_build.library_path`` names the library by a hash of every source, header
and flag: a file the hash misses would let an edit to it load a stale
``libnmf_kernels.so`` on the card.  chip_smoke.py reads each kernel's Mode
from its mangled name (ptxas, cuobjdump) and which pass-1 instance a call
ran from the library's launches per Mode; these run on the CPU.
"""

import importlib.util
import pathlib
import re
import shutil

import pytest

pytest.importorskip("torch")

from nmf_tpu_torch.ops.kernels import _build  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "nmf_tpu_torch" / "csrc"
LISTED = (*_build._SOURCES, *_build._HEADERS)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_csrc_file_is_hashed():
    on_disk = {p.name for p in CSRC.iterdir() if p.is_file()}
    assert on_disk == {p.name for p in LISTED}
    assert all(p.is_file() and p.parent == CSRC for p in LISTED)
    assert len(set(LISTED)) == len(LISTED)


def test_every_include_is_a_hashed_header():
    headers = {p.name for p in _build._HEADERS}
    for src in LISTED:
        for name in re.findall(r'^#include "([^"]+)"', src.read_text(), re.M):
            assert name in headers, f"{src.name} includes {name}"


def _includers(header):
    return sorted(p.name for p in LISTED if f'#include "{header}"' in p.read_text())


def test_pass1_pieces_are_included_through_pass1():
    """K1/K2 (fused_mu.cuh, the kernels of fused_mu.cu's 2-D calls and of
    fused_mu_batched.cu's member axis) and K5 (tile_sparse.cu) share one
    pass 1: both include pass1.cuh, and only it includes the tensor-core and
    SIMT pieces."""
    assert _includers("mma_tile.cuh") == ["pass1.cuh"]
    assert _includers("simt_tile.cuh") == ["pass1.cuh"]
    assert _includers("pass1.cuh") == ["fused_mu.cuh", "tile_sparse.cu"]
    assert _includers("fused_mu.cuh") == ["fused_mu.cu", "fused_mu_batched.cu"]


@pytest.mark.parametrize("name", [p.name for p in LISTED])
def test_an_edit_to_any_listed_file_moves_the_library(tmp_path, monkeypatch, name):
    copies = {}
    for p in LISTED:
        copies[p.name] = tmp_path / p.name
        shutil.copy(p, copies[p.name])
    monkeypatch.setattr(_build, "_SOURCES", tuple(copies[p.name] for p in _build._SOURCES))
    monkeypatch.setattr(_build, "_HEADERS", tuple(copies[p.name] for p in _build._HEADERS))
    before = _build.library_path()
    assert before == _build.library_path()
    copies[name].write_text(copies[name].read_text() + "\n// edited\n")
    after = _build.library_path()
    assert after != before and after.parent.parent == before.parent.parent


def test_modes_follow_the_enum():
    """chip_smoke.MODES lists csrc/mu_tile.cuh's Mode in value order, BF16
    appended so the older Modes keep their numbers."""
    enum = re.search(r"enum class Mode \{([^}]*)\}", (CSRC / "mu_tile.cuh").read_text())
    assert tuple(v.strip() for v in enum.group(1).split(",")) == _chip_smoke().MODES
    assert _chip_smoke().MODES == ("F32", "ANY", "SPLIT3", "BF16")


@pytest.mark.parametrize(
    "name,label",
    [
        ("_ZN44_GLOBAL__N__73101337_11_fused_mu_cu_nmf_tile16h_update_partialILi16ELNS_4ModeE3EEEv"
         "NS_8OperandsEPfi", "h_update_partial<R=16,BF16>"),
        ("_ZN12_GLOBAL__N_116w_update_partialILi1ELNS_4ModeE0EEEvNS_8OperandsEPfi",
         "w_update_partial<R=1,F32>"),
        ("_ZN12_GLOBAL__N_116w_update_partialILi4ELNS_4ModeE2EEEvNS_8OperandsEPfi",
         "w_update_partial<R=4,SPLIT3>"),
        ("_ZN12_GLOBAL__N_110kl_partialILNS_4ModeE1EEEvNS_8OperandsEPf", "kl_partial<ANY>"),
        ("_ZN12_GLOBAL__N_18finalizeEPKviPKfS3_Pviiii", "finalize"),
        ("_ZN47_GLOBAL__N__e2f0a41c_14_tile_sparse_cu_e5cbc7d915h_sweep_partialILi16ELNS_4ModeE0EE"
         "EvNS_8OperandsENS_4PlanEPf", "h_sweep_partial<R=16,F32>"),
        ("_ZN47_GLOBAL__N__e2f0a41c_14_tile_sparse_cu_e5cbc7d915h_sweep_partialILi8ELNS_4ModeE3EEE"
         "vNS_8OperandsENS_4PlanEPf", "h_sweep_partial<R=8,BF16>"),
        ("_ZN47_GLOBAL__N__e2f0a41c_14_tile_sparse_cu_e5cbc7d915w_sweep_partialILi16ELNS_4ModeE1EE"
         "EvNS_8OperandsENS_4PlanEPf", "w_sweep_partial<R=16,ANY>"),
        ("_ZN12_GLOBAL__N_115w_sweep_partialILi2ELNS_4ModeE2EEEvNS_8OperandsENS_4PlanEPf",
         "w_sweep_partial<R=2,SPLIT3>"),
        ("_ZN12_GLOBAL__N_115w_sweep_partialILi4ELNS_4ModeE3EEEvNS_8OperandsENS_4PlanEPf",
         "w_sweep_partial<R=4,BF16>"),
        ("_ZN47_GLOBAL__N__e2f0a41c_14_tile_sparse_cu_e5cbc7d99sweep_sumILb1EEEvNS_4PlanEPKfPfii",
         "sweep_sum"),
    ],
)
def test_kernel_names_give_their_mode(name, label):
    """ptxas's and cuobjdump's (mangled) names, as phase 1 prints them."""
    assert _chip_smoke()._kernel_label(name) == label


@pytest.mark.parametrize(
    "counts,impl",
    [([0, 0, 0, 2], "mma.sync bf16"), ([2, 0, 0, 0], "simt"), ([0, 1, 0, 0], "simt"),
     ([0, 0, 3, 0], "mma.sync split3")],
)
def test_launch_counts_give_the_instance(counts, impl):
    """The library's pass-1 launches per Mode name the instance that ran."""
    assert _chip_smoke()._impl_of_counts(counts, "update_h") == impl


@pytest.mark.parametrize(
    "policy,impl",
    [("bfloat16", "mma.sync bf16"), ("float32_fast", "mma.sync split3"), ("float32", "simt")],
)
def test_each_gemm_policy_expects_its_instance(policy, impl):
    """The instance chip_smoke.py requires of K1/K2 under each GEMM policy:
    the tensor cores for both bf16 policies, SIMT for float32."""
    smoke = _chip_smoke()
    assert smoke.IMPL_OF_POLICY.get(policy, "simt") == impl
    assert set(smoke.MMA_MODES) == {"BF16", "SPLIT3"}


@pytest.mark.parametrize(
    "mode,counts,impl",
    [("float32", [200, 0, 0, 0], "simt"), ("bf16_tiles", [0, 1, 0, 0], "simt"),
     ("float32_fast", [0, 0, 200, 0], "mma.sync split3"),
     ("bfloat16", [0, 0, 0, 200], "mma.sync bf16"), ("bf16_state", [0, 0, 0, 1], "mma.sync bf16")],
)
def test_k5_launch_counts_give_the_instance(mode, counts, impl):
    """K5's pass-1 launches per Mode (``nmf_sweep_launches``) name the Mode
    each of phase 8's modes must run, and its instance."""
    smoke = _chip_smoke()
    ran = smoke._mode_of_counts(counts, "h_numerator")
    assert ran == smoke.K5_MODE[mode]
    assert smoke.IMPL.get(ran, "simt") == impl == smoke._impl_of_counts(counts, "h_numerator")


def test_k5_modes_cover_every_instance():
    """Phase 8's modes reach every Mode of K5, and each tiled solve's GEMM
    policy its K1/K2 instance."""
    smoke = _chip_smoke()
    assert set(smoke.K5_MODE) == set(smoke._k5_modes())
    assert set(smoke.K5_MODE.values()) == set(smoke.MODES)
    for policy in ("float32", "bfloat16", "float32_fast"):
        assert smoke.IMPL.get(smoke.K5_MODE[policy], "simt") == smoke.IMPL_OF_POLICY.get(policy, "simt")


@pytest.mark.parametrize("counts", [[0, 0, 0, 0], [1, 0, 0, 1]])
def test_no_or_several_instances_fail(counts):
    with pytest.raises(RuntimeError, match="pass-1 launches per Mode"):
        _chip_smoke()._impl_of_counts(counts, "update_w")


def test_launch_counters_are_bound():
    """The counters chip_smoke.py reads are exported with their C types."""
    assert _build._SIGNATURES["nmf_partial_launches"][0] == [_build._I, _build._I]
    assert _build._SIGNATURES["nmf_partial_info"][0] == [_build._I] * 3 + [_build._P]
    src = (CSRC / "fused_mu.cu").read_text()
    for name in ("nmf_partial_launches", "nmf_reset_partial_launches", "nmf_partial_info"):
        assert name in _build._SIGNATURES and re.search(rf"\b{name}\(", src)


def test_sweep_counters_are_bound():
    """K5's launch counters and instance info are exported with their C
    types, and the sweeps take the partial buffer and the chunk length."""
    assert _build._SIGNATURES["nmf_sweep_launches"][0] == [_build._I, _build._I]
    assert _build._SIGNATURES["nmf_sweep_info"][0] == [_build._I] * 3 + [_build._P]
    src = (CSRC / "tile_sparse.cu").read_text()
    for name in ("nmf_sweep_launches", "nmf_reset_sweep_launches", "nmf_sweep_info"):
        assert name in _build._SIGNATURES and re.search(rf"\b{name}\(", src)
    for name in ("nmf_h_sweep", "nmf_w_sweep"):
        args = _build._SIGNATURES[name][0]
        c_args = re.search(rf"int {name}\(([^)]*)\)", src).group(1).split(",")
        assert len(args) == len(c_args) == 23


def test_phase1_lists_every_pass1_kernel():
    """Phase 1 reads registers, shared memory and blocks an SM of K1's, K2's
    and K5's pass-1 kernels, each through its library query, and of K3's
    (``nmf_kl_info``)."""
    smoke = _chip_smoke()
    assert [k[0] for k in smoke.PASS1_KERNELS] == [
        "h_update_partial", "w_update_partial", "h_sweep_partial", "w_sweep_partial"]
    for _, _, query in smoke.PASS1_KERNELS:
        assert query in _build._SIGNATURES
    assert set(smoke.PASS1_OF.values()) == {k[0] for k in smoke.PASS1_KERNELS} | {"kl_partial"}


def test_phase1_lists_the_k3_instances():
    """Phase 1 lists K3's 15 instances (Modes F32, ANY and BF16 at every
    chunk width; no SPLIT3, whose cost takes the f32 recon) through
    ``nmf_kl_info``, and the result line gives them as K3's ``pass1``."""
    smoke = _chip_smoke()
    assert smoke.KL_MODES == ("F32", "ANY", "BF16")
    assert set(smoke.KL_MODES) <= set(smoke.MODES) and "SPLIT3" not in smoke.KL_MODES
    assert smoke.PASS1_OF["kl_cost"] == "kl_partial"
    assert "nmf_kl_info(MODES.index(mode), 16 * r, vals)" in (REPO / "chip_smoke.py").read_text()


@pytest.mark.parametrize(
    "name,label",
    [
        ("_ZN44_GLOBAL__N__73101337_11_fused_mu_cu_nmf_tile10kl_partialILi16ELNS_4ModeE3EEEvNS_8Ope"
         "randsEPfi", "kl_partial<R=16,BF16>"),
        ("_ZN12_GLOBAL__N_110kl_partialILi1ELNS_4ModeE0EEEvNS_8OperandsEPfi", "kl_partial<R=1,F32>"),
        ("_ZN12_GLOBAL__N_110kl_partialILi8ELNS_4ModeE1EEEvNS_8OperandsEPfi", "kl_partial<R=8,ANY>"),
        ("_ZN12_GLOBAL__N_18kl_finalEPKfiPf", "kl_final"),
    ],
)
def test_k3_kernel_names_give_their_mode(name, label):
    """K3's pass-1 instances, templated on the chunk width and the Mode, as
    ptxas and cuobjdump name them."""
    assert _chip_smoke()._kernel_label(name) == label


@pytest.mark.parametrize(
    "mode,want",
    [("float32", "F32"), ("bfloat16", "BF16"), ("float32_fast", "F32"), ("x_bfloat16", "ANY"),
     ("x_int8", "ANY"), ("float32_fast_x_bf16", "ANY"), ("float32_fast_bf16_state", "ANY"),
     ("bf16_full_state", "BF16")],
)
def test_k3_launch_counts_give_the_instance(mode, want):
    """The Mode each of phase 3's modes must run K3 in: BF16 under
    bfloat16 (bf16 state too), F32 on f32 operands under both f32
    policies, ANY for bf16 X, int8 X or bf16 state under f32 recon; the
    library's launches per Mode (``nmf_kl_launches``) name it."""
    import torch

    smoke = _chip_smoke()
    spec = smoke._modes().get(mode) or smoke._num_modes()[mode]
    w = torch.zeros((2, 2), dtype=spec.state)
    x = ((torch.zeros((2, 2), dtype=torch.uint8), torch.ones(2)) if spec.xform == "int8"
         else torch.zeros((2, 2), dtype=torch.bfloat16 if spec.xform == "bf16" else torch.float32))
    assert smoke.kl_mode_expected(spec.prec, w, x) == want
    counts = [int(m == want) * 8 for m in smoke.MODES]
    assert smoke._mode_of_counts(counts, "kl_cost") == want
    assert smoke.kl_instance(want, 128) == f"kl_partial<R=8,{want}>"
    assert smoke._kl_impl(smoke.kl_instance(want, 128)) == (
        "mma.sync bf16" if want == "BF16" else "simt")


@pytest.mark.parametrize(
    "name,label",
    [
        ("_ZN12_GLOBAL__N_116w_update_partialILi16ELNS_4ModeE3ELb0EEEvNS_8OperandsEPfiNS_7MembersE",
         "w_update_partial<R=16,BF16>"),
        ("_ZN12_GLOBAL__N_116w_update_partialILi16ELNS_4ModeE3ELb1EEEvNS_8OperandsEPfiNS_7MembersE",
         "w_update_partial<R=16,BF16,members>"),
        ("_ZN55_GLOBAL__N__1f2e3d4c_20_fused_mu_batched_cu_0a1b2c3d16h_update_partialILi1ELNS_4Mode"
         "E0ELb1EEEvNS_8OperandsEPfiNS_7MembersE", "h_update_partial<R=1,F32,members>"),
        ("_ZN12_GLOBAL__N_116w_update_partialILi2ELNS_4ModeE2ELb0EEEvNS_8OperandsEPfiNS_7MembersE",
         "w_update_partial<R=2,SPLIT3>"),
        ("_ZN12_GLOBAL__N_110kl_partialILi8ELNS_4ModeE1EEEvNS_8OperandsEPfiNS_7MembersE",
         "kl_partial<R=8,ANY>"),
    ],
)
def test_member_instances_are_told_apart(name, label):
    """K1/K2's pass-1 kernels, built for the 2-D call and for a member axis
    (their last template argument), carry the Mode either way and the
    member tag only on the member axis's instance, so that phase 1 lists
    the two apart; K3's one instance a Mode and width serves both."""
    smoke = _chip_smoke()
    assert smoke._kernel_label(name) == label
    assert smoke._label_mode(label) == label.split(",")[1].rstrip(">")


def _c_entries(path):
    """{name: number of parameters} of the extern "C" definitions of a source."""
    text = path.read_text()
    return {m.group(1): len(m.group(2).split(","))
            for m in re.finditer(r"^(?:int|void|const char\*) (nmf_\w+)\(([^)]*)\) \{", text, re.M)}


def test_each_unit_defines_its_entry_points():
    """fused_mu.cu defines K1/K2's 2-D entry points, K3's (2-D and
    batched), the launch counters and the instances' queries;
    fused_mu_batched.cu K1/K2's member-axis entry points and their
    instances' query (nmf_member_partial_info); each with the bound
    signature's parameters."""
    two_d, batched = _c_entries(CSRC / "fused_mu.cu"), _c_entries(CSRC / "fused_mu_batched.cu")
    assert {"nmf_h_update", "nmf_w_update", "nmf_kl_cost", "nmf_kl_cost_batched",
            "nmf_partial_info", "nmf_kl_info", "nmf_partial_launches",
            "nmf_kl_launches"} <= set(two_d)
    assert set(batched) == {"nmf_h_update_batched", "nmf_w_update_batched",
                            "nmf_member_partial_info"}
    assert not set(two_d) & set(batched)
    for name, n_args in {**two_d, **batched}.items():
        if name in ("nmf_tile", "nmf_max_chunk", "nmf_reset_partial_launches",
                    "nmf_reset_kl_launches"):
            continue
        assert len(_build._SIGNATURES[name][0]) == n_args, name
    assert _build._SIGNATURES["nmf_member_partial_info"] == _build._SIGNATURES["nmf_partial_info"]


def test_phase1_lists_the_member_instances_apart():
    """Phase 1 queries the member axis's K1/K2 instances through
    nmf_member_partial_info (K3 and K5 have none), and phase 7 holds the
    bfloat16 flagship's K1 and K2 to their plain versions."""
    smoke = _chip_smoke()
    text = (REPO / "chip_smoke.py").read_text()
    assert "lib.nmf_member_partial_info(h, mode_i, 16 * r, vals)" in text
    assert smoke.MEMBER_TAG == "members"
    assert smoke.FLAGSHIP_GATED == ("bfloat16",)


def test_k3_counters_are_bound():
    """K3's launch counters and instance info are exported with their C
    types."""
    assert _build._SIGNATURES["nmf_kl_launches"][0] == [_build._I]
    assert _build._SIGNATURES["nmf_reset_kl_launches"][0] == []
    assert _build._SIGNATURES["nmf_kl_info"][0] == [_build._I, _build._I, _build._P]
    src = (CSRC / "fused_mu.cu").read_text()
    for name in ("nmf_kl_launches", "nmf_reset_kl_launches", "nmf_kl_info"):
        assert re.search(rf"\b{name}\(", src)


def test_k3_entry_takes_the_split():
    """``nmf_kl_cost``'s C parameters match the bound signature: the chunk
    width, the splits and the tiles a split (``fused_mu.kl_split``) and a
    scratch for W and H rounded to bf16, beside K1's operands and modes."""
    args = _build._SIGNATURES["nmf_kl_cost"][0]
    src = (CSRC / "fused_mu.cu").read_text()
    c_args = [a.split()[-1].lstrip("*") for a in
              re.search(r"int nmf_kl_cost\(([^)]*)\)", src).group(1).split(",")]
    assert len(args) == len(c_args) == 19
    assert c_args[4:6] == ["partials", "scratch"]
    assert c_args[7:14] == ["m", "n", "k", "kc", "splits", "tiles_per_split", "eps"]
    assert args[:7] == [_build._P] * 7
    assert args[7:13] == [_build._I] * 6 and args[13] == _build._F


def test_recon_tile_is_gone():
    """K3 stages through the pass-1 pieces: the first K3's one-tile recon
    and its transposed W slice are gone from every source."""
    for path in LISTED:
        text = path.read_text()
        assert "recon_tile" not in text and "WS_STRIDE" not in text, path.name


def test_simt_modes_are_the_f32_gemm_modes():
    """Phase 1 holds F32 and ANY, the f32-GEMM Modes, to no HMMA."""
    smoke = _chip_smoke()
    assert smoke.SIMT_MODES == ("F32", "ANY")
    assert set(smoke.SIMT_MODES) | set(smoke.MMA_MODES) == set(smoke.MODES)


def test_coverage_has_rows_off_16_bytes():
    """Phase 2 checks a shape whose rows of W (K), H and X (N) all start off
    16 bytes: the SIMT pass 1's 4-byte copies."""
    assert any(k % 4 and n % 4 for _, n, k in _chip_smoke().COVERAGE_SHAPES)


def _digest_module():
    spec = importlib.util.spec_from_file_location("kernel_digest", REPO / "kernel_digest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "other,rc",
    [({"a": "1", "b": "2"}, 0), ({"a": "1", "b": "3"}, 1), ({"a": "1"}, 1)],
    ids=["equal", "differ", "unmatched"],
)
def test_kernel_digest_compare(tmp_path, other, rc):
    """kernel_digest.py --compare passes only where every check's digest is
    present in both files and equal."""
    import json

    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps({"card": "x", "digests": {"a": "1", "b": "2"}}))
    b.write_text(json.dumps({"card": "x", "digests": other}))
    assert _digest_module().main(["--compare", str(a), str(b)]) == rc


@pytest.mark.parametrize(
    "other,rc",
    [({"kl_cost 9x9x9": "3", "update_h 9x9x9": "1"}, 0),
     ({"kl_cost 9x9x9": "2", "update_h 9x9x9": "1", "flagship kl_cost [bfloat16]": "4"}, 0),
     ({"kl_cost 9x9x9": "2", "update_h 9x9x9": "5"}, 1),
     ({"kl_cost 9x9x9": "2"}, 1)],
    ids=["k3_differs", "k3_new_check", "k1_differs", "k1_unmatched"],
)
def test_kernel_digest_compare_allows_named_kernels(tmp_path, other, rc):
    """``--changed kl_cost`` lets K3's checks differ or be new, and still
    holds every other kernel's checks equal and present in both files."""
    import json

    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps({"card": "x", "digests": {"kl_cost 9x9x9": "2",
                                                      "update_h 9x9x9": "1"}}))
    b.write_text(json.dumps({"card": "x", "digests": other}))
    assert _digest_module().main(["--compare", str(a), str(b), "--changed", "kl_cost"]) == rc


@pytest.mark.parametrize("argv", [["sweep-per"], ["flagship"], ["kl"], ["graph"], ["accel"],
                                  ["batched"], ["tiled"], ["stream"], ["stop"]])
def test_probe_timings_needs_a_card(argv, capsys):
    """probe_timings.py measures on the card only: without one it exits 1
    and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    spec = importlib.util.spec_from_file_location("probe_timings", REPO / "probe_timings.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(argv) == 1
    assert capsys.readouterr().out == ""


def test_float32_fast_runs_on_every_storage():
    """chip_smoke.py holds the split3 kernels on the card with f32 and bf16
    state, f32, bf16 and int8 X: phase 3's modes, and phase 9a's numerators
    at float32_fast's own limits."""
    smoke = _chip_smoke()
    split = {(spec.state, spec.xform): spec for spec in smoke._modes().values()
             if spec.prec.matmul_dtype == "float32_fast"}
    import torch

    assert set(split) == {(torch.float32, "f32"), (torch.float32, "bf16"),
                          (torch.bfloat16, "int8")}
    num = smoke._num_modes()
    assert num["float32_fast_bf16_state"].limits == smoke.MODE_LIMITS["float32_fast"]
    assert num["float32_fast_x_bf16"].control.matmul_dtype == "float32"
