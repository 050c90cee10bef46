"""The kernel build table, the comparison entries of B1-B5 and
chip_smoke.py's tables, on the CPU.

The CUDA sources compile only on a machine with ``nvcc`` and a card, so
what runs here is what surrounds them: every entry of
``_build.KERNELS`` names a source that exists and a C function of that
source whose parameter count matches its ctypes argument list; the
build directory's hash moves with every source; every entry has a
launch count; production B1's, B2's, B3's, B4's and B5's libraries
hold no comparison entry; the comparison wrappers exist and take the
plain versions on CPU tensors, bit for bit; chip_smoke.py has the rows
its timing phase reads and parses the compiler's register report; and
the B2, B3 and B4 tile tools read production's tiles and refuse the
CPU.
"""

import functools
import importlib.util
import os
import re
import shutil

import numpy as np
import pytest
import torch

from flashpca_tpu_torch.kernels import _build
from flashpca_tpu_torch.kernels import packed_matvec as tpk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,src,entry", [
    ("matvec_ff_novl", "matvec_ff_novl.cu", "fp_matvec_ff_novl"),
    ("matvec_ff_novl_v1", "matvec_ff.cu", "fp_matvec_ff_novl_v1"),
    ("matvec_ff_novl_c4", "matvec_ff_novl_variants.cu",
     "fp_matvec_ff_novl_c4"),
    ("matvec_ff_novl_cr128", "matvec_ff_novl_variants.cu",
     "fp_matvec_ff_novl_cr128"),
    ("matvec_ff", "matvec_ff_v2.cu", "fp_matvec_ff"),
    ("matvec_ff_v1", "matvec_ff.cu", "fp_matvec_ff_v1"),
    ("crossprod", "crossprod_v2.cu", "fp_crossprod"),
    ("crossprod_v1", "crossprod.cu", "fp_crossprod_v1"),
    ("crossprod_tiled", "crossprod.cu", "fp_crossprod_tiled"),
    ("crossprod_ff", "crossprod_ff_v2.cu", "fp_crossprod_ff"),
    ("crossprod_ff_v1", "crossprod_ff.cu", "fp_crossprod_ff_v1"),
    ("matvec", "matvec_v2.cu", "fp_matvec"),
    ("matvec_v1", "matvec.cu", "fp_matvec_v1"),
    ("matvec_tiled", "matvec.cu", "fp_matvec_tiled"),
    ("crossprod_stacked", "crossprod_variants_v2.cu", "fp_crossprod_stacked"),
    ("crossprod_stacked_v1", "crossprod_variants.cu",
     "fp_crossprod_stacked_v1"),
    ("crossprod_nocomp", "crossprod_variants_v2.cu", "fp_crossprod_nocomp"),
    ("crossprod_nocomp_v1", "crossprod_variants.cu",
     "fp_crossprod_nocomp_v1"),
    ("crossprod_intsub", "crossprod_variants_v2.cu", "fp_crossprod_intsub"),
    ("crossprod_intsub_v1", "crossprod_variants.cu",
     "fp_crossprod_intsub_v1"),
    ("crossprod_split3", "crossprod_split3_v2.cu", "fp_crossprod_split3"),
    ("crossprod_split3_v1", "crossprod_split3.cu", "fp_crossprod_split3_v1"),
    ("crossprod_narrow", "crossprod_narrow.cu", "fp_crossprod_narrow"),
    ("matvec_narrow", "matvec_narrow.cu", "fp_matvec_narrow"),
])
def test_b5_entries_map_to_their_sources(name, src, entry):
    """B5's and (since their redesigns) B1's, B2's, B3's, B4's and V1's to
    V4's entries: the redesign in the new source, the first design (and
    B1's and B2's sweep tile entries) in the old one."""
    assert _build.KERNELS[name][:2] == (src, entry)


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_entry_exists_with_matching_arity(name):
    """The C entry is defined in its source, and takes as many
    parameters as its ctypes argument list passes."""
    src, entry, argtypes = _build.KERNELS[name]
    with open(os.path.join(_build.CSRC, src)) as fh:
        text = fh.read()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert m, f"{entry} not defined in {src}"
    assert len(m.group(1).split(",")) == len(argtypes)


@pytest.mark.parametrize("src", _build.sources() + list(_build.HEADERS))
def test_build_dir_hash_covers_each_source(src, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = _build._build_dir()
    with open(csrc / src, "a") as fh:
        fh.write("\n// edited\n")
    assert _build._build_dir() != before


def test_b5_is_built_from_its_new_source():
    assert {"matvec_ff_novl.cu", "matvec_ff_novl_variants.cu"} <= set(
        _build.sources())


def test_b1_is_built_from_its_new_source():
    assert {"crossprod_v2.cu", "crossprod.cu"} <= set(_build.sources())
    assert len(_build.sources()) == 16 and len(_build.KERNELS) == 24


def test_b3_is_built_from_its_new_source():
    assert {"crossprod_ff_v2.cu", "crossprod_ff.cu"} <= set(_build.sources())
    assert _build.KERNELS["crossprod_ff"][2] == _build.KERNELS[
        "crossprod_ff_v1"][2]


def test_b2_is_built_from_its_new_source():
    assert {"matvec_v2.cu", "matvec.cu"} <= set(_build.sources())
    assert _build.KERNELS["matvec"][2] == _build.KERNELS["matvec_v1"][2]
    assert tpk.B2_KERNELS == ("matvec_v1",)


def test_b4_is_built_from_its_new_source():
    assert {"matvec_ff_v2.cu", "matvec_ff.cu"} <= set(_build.sources())
    assert _build.KERNELS["matvec_ff"][2] == _build.KERNELS[
        "matvec_ff_v1"][2]
    assert len(_build.KERNELS["matvec_ff"][2]) == 10
    assert tpk.B4_KERNELS == ("matvec_ff_v1",)


def test_production_b4_library_holds_only_b4():
    """B4's source defines one C entry; the first designs of B4 and B5
    stay in matvec_ff.cu, and B5's production source is not B4's."""
    with open(os.path.join(_build.CSRC, "matvec_ff_v2.cu")) as fh:
        prod = fh.read()
    with open(os.path.join(_build.CSRC, "matvec_ff.cu")) as fh:
        first = fh.read()
    assert re.findall(r'extern "C" int (\w+)\(', prod) == ["fp_matvec_ff"]
    assert re.findall(r'extern "C" int (\w+)\(', first) == [
        "fp_matvec_ff_v1", "fp_matvec_ff_novl_v1"]
    assert "matvec_ff_novl" not in re.sub(r"//.*", "", prod)
    # the note names the TPU kernel it replaces, its bound and the fold
    # that keeps the first design's bits
    assert "packed_matvec.py::_matvec_ff_kernel\n" in prod
    assert "6*KC*p*n4 operations" in prod
    assert "constexpr int CR = 64;" in prod


def test_production_b2_library_holds_only_b2():
    """B2's source defines one C entry; the first design's and the
    sweep's tile entry stay in matvec.cu."""
    with open(os.path.join(_build.CSRC, "matvec_v2.cu")) as fh:
        prod = fh.read()
    with open(os.path.join(_build.CSRC, "matvec.cu")) as fh:
        first = fh.read()
    assert re.findall(r'extern "C" int (\w+)\(', prod) == ["fp_matvec"]
    assert re.findall(r'extern "C" int (\w+)\(', first) == [
        "fp_matvec_v1", "fp_matvec_tiled"]
    # the note names the TPU kernel it replaces, its bound and the fold
    # that keeps the first design's bits
    assert "packed_matvec.py::_matvec_kernel" in prod
    assert "2*KC*p*n4 operations" in prod
    assert "constexpr int CR = 64;" in prod


def test_production_b1_library_holds_only_b1():
    """B1's source defines one C entry; the first design's entries stay
    in crossprod.cu."""
    with open(os.path.join(_build.CSRC, "crossprod_v2.cu")) as fh:
        prod = fh.read()
    with open(os.path.join(_build.CSRC, "crossprod.cu")) as fh:
        first = fh.read()
    assert re.findall(r'extern "C" int (\w+)\(', prod) == ["fp_crossprod"]
    assert re.findall(r'extern "C" int (\w+)\(', first) == [
        "fp_crossprod_v1", "fp_crossprod_tiled"]
    # the note names the TPU kernel it replaces and its bound
    assert "packed_matvec.py::_crossprod_kernel" in prod
    assert "2*KC*p*n4 operations" in prod


@pytest.mark.parametrize("name, tpu", [
    ("crossprod_narrow", "_crossprod_kernel"),
    ("matvec_narrow", "_matvec_kernel")])
def test_one_column_libraries_hold_only_their_entry(name, tpu):
    """B1's and B2's one-column kernels: one C entry a source, launched
    by the operators (counted, never a comparison entry), B1's and B2's
    arguments; the note names the TPU kernel it serves, its byte bound,
    its budget a genotype and the sums it keeps (column 0 of kc 8)."""
    src, entry, argtypes = _build.KERNELS[name]
    with open(os.path.join(_build.CSRC, src)) as fh:
        text = fh.read()
    assert re.findall(r'extern "C" int (\w+)\(', text) == [entry]
    assert argtypes == _build.KERNELS[name.split("_")[0]][2]
    assert name in tpk.OPERATOR_KERNELS and name in tpk.launch_counts
    assert f"packed_matvec.py::{tpu} at one" in text
    assert "3.76 ms" in text and "Budget:" in text
    assert "column 0 of B" in text and "at kc 8" in text
    assert "--use_fast_math" not in text


def test_v1_and_v4_are_built_from_their_new_source():
    """The redesigns' source defines V1's, V2's and V4's entries and no
    other; the first designs keep theirs in crossprod_variants.cu, with
    B1's argument list; the note names the TPU kernels replaced, the
    bound and the bits kept."""
    assert {"crossprod_variants_v2.cu", "crossprod_variants.cu"} <= set(
        _build.sources())
    with open(os.path.join(_build.CSRC, "crossprod_variants_v2.cu")) as fh:
        new = fh.read()
    with open(os.path.join(_build.CSRC, "crossprod_variants.cu")) as fh:
        first = fh.read()
    assert re.findall(r'extern "C" int (\w+)\(', new) == [
        "fp_crossprod_stacked", "fp_crossprod_intsub", "fp_crossprod_nocomp"]
    assert re.findall(r'extern "C" int (\w+)\(', first) == [
        "fp_crossprod_stacked_v1", "fp_crossprod_intsub_v1",
        "fp_crossprod_nocomp_v1"]
    for name in ("crossprod_stacked", "crossprod_intsub", "crossprod_nocomp"):
        assert _build.KERNELS[name][2] == _build.KERNELS[name + "_v1"][2]
        assert _build.KERNELS[name][2] == _build.KERNELS["crossprod"][2]
    assert "kernel_sweep.py::_crossprod_kernel_stacked" in new
    assert "::_crossprod_kernel_intsub" in new
    assert "::_crossprod_kernel_nocomp" in new
    assert "2*KC*p*n4 operations" in new
    assert "--use_fast_math" not in " ".join(_build.NVCC_FLAGS)
    # B1's source is not the variants': both include B1's loop instead
    assert "crossprod_v2.cu" not in re.findall(r'#include "([^"]+)"', new)


def test_v2_and_v4_instantiate_b1s_own_loop():
    """B1's tile and chunk loop are one copy, b1_tile.cuh, which the
    build hash covers: B1 instantiates it with the cubic decode and the
    TwoSum fold, V2 at B1's own tile with the intsub decode, V4 without
    the fold; neither source holds a loop of its own."""
    assert "b1_tile.cuh" in _build.HEADERS
    texts = {}
    for src in ("crossprod_v2.cu", "crossprod_variants_v2.cu"):
        with open(os.path.join(_build.CSRC, src)) as fh:
            texts[src] = fh.read()
        assert "b1_tile.cuh" in re.findall(r'#include "([^"]+)"', texts[src])
    assert "b1::body<KC, Tile<KC>, false, true>" in texts["crossprod_v2.cu"]
    assert "using Tile = b1::Tile<KC>;" in texts["crossprod_v2.cu"]
    var = texts["crossprod_variants_v2.cu"]
    assert "b1::body<KC, b1::Tile<KC>, true, true>" in var
    assert "b1::body<KC, NocompTile<KC>, false, false>" in var
    assert "fp::two_sum" not in texts["crossprod_v2.cu"]
    with open(os.path.join(_build.CSRC, "b1_tile.cuh")) as fh:
        shared = fh.read()
    assert "fp::two_sum(s, acc[i][c], t, e);" in shared
    assert "struct Tile : LoopShape<KC, 2, KC == 24 ? 12 : KC == 32 ? 16 : 8," \
        in shared


def test_v3_is_built_from_its_new_source():
    """V3's redesign has a source of its own holding its one entry, which
    takes B1's arguments and, after x, the scratch panel; its first design
    keeps its entry, alone, in crossprod_split3.cu; the note names the
    TPU kernel replaced, the bound's three terms and the bits kept; the
    build hash covers the new source; the tile macro has a default at
    every KC."""
    assert {"crossprod_split3_v2.cu", "crossprod_split3.cu"} <= set(
        _build.sources())
    with open(os.path.join(_build.CSRC, "crossprod_split3_v2.cu")) as fh:
        new = fh.read()
    with open(os.path.join(_build.CSRC, "crossprod_split3.cu")) as fh:
        first = fh.read()
    assert re.findall(r'extern "C" int (\w+)\(', new) == [
        "fp_crossprod_split3"]
    assert re.findall(r'extern "C" int (\w+)\(', first) == [
        "fp_crossprod_split3_v1"]
    b1 = _build.KERNELS["crossprod"][2]
    assert _build.KERNELS["crossprod_split3_v1"][2] == b1
    assert _build.KERNELS["crossprod_split3"][2] == b1[:6] + [b1[0]] + b1[6:]
    assert "kernel_sweep.py::_crossprod_kernel_split3" in new
    assert "989 TFLOP/s" in new and "bit for bit" in new
    assert "mma.sync.aligned.m16n8k16" in new and "wgmma" not in new
    for kc in (8, 16, 24, 32):
        assert f"#ifndef CROSSPROD_SPLIT3_TILE_{kc}\n" in new
    assert "--use_fast_math" not in " ".join(_build.NVCC_FLAGS)
    assert "crossprod_split3_v2.cu" in _build.sources()


def test_variant_first_designs_are_counted_and_off_the_main_path():
    from flashpca_tpu_torch.kernels import crossprod_variants as cv

    assert tpk.VARIANT_FIRST_KERNELS == ("crossprod_stacked_v1",
                                         "crossprod_intsub_v1",
                                         "crossprod_nocomp_v1",
                                         "crossprod_split3_v1")
    assert set(cv.FIRST_DESIGNS) == set(tpk.VARIANT_FIRST_KERNELS)
    for first, (wrapper, plain) in cv.FIRST_DESIGNS.items():
        redesign = first.removesuffix("_v1")
        assert first in tpk.launch_counts
        assert first not in tpk.OPERATOR_KERNELS + tpk.SWEEP_KERNELS
        assert wrapper.__name__ == first + "_p"
        assert getattr(cv, first + "_p") is wrapper
        assert cv.VARIANTS[redesign][1] is plain
    cs = _chip_smoke()
    launches = dict.fromkeys(tpk.launch_counts, 0)
    for first in tpk.VARIANT_FIRST_KERNELS:
        with pytest.raises(AssertionError, match=first):
            cs.require_no_first_design(dict(launches, **{first: 1}),
                                       "wide path")


@pytest.mark.parametrize("k", [3, 16, 40])
@pytest.mark.parametrize("name", ["crossprod_stacked", "crossprod_stacked_v1",
                                  "crossprod_intsub", "crossprod_intsub_v1",
                                  "crossprod_nocomp", "crossprod_nocomp_v1",
                                  "crossprod_split3", "crossprod_split3_v1"])
def test_variant_wrappers_on_cpu_are_plain(novl_operands, name, k):
    """V1-V4 and their first designs take their plain versions on CPU
    tensors, bit for bit, and launch nothing."""
    from flashpca_tpu_torch.kernels import crossprod_variants as cv

    packed, _, rng = novl_operands
    p, nb = packed.shape
    mean = torch.from_numpy(rng.uniform(0.1, 1.9, p))
    invsd = torch.from_numpy(rng.uniform(0.5, 2.0, p))
    x = torch.from_numpy(rng.standard_normal((4 * nb, k)).astype(np.float32))
    plain = (cv.VARIANTS.get(name) or cv.FIRST_DESIGNS[name])[1]
    tpk.reset_launch_counts()
    z = getattr(cv, name + "_p")(packed, mean, invsd, x)
    assert torch.equal(z, plain(packed, mean, invsd, x))
    assert all(c == 0 for c in tpk.launch_counts.values())


def test_production_b3_library_holds_only_b3():
    """B3's source defines one C entry; its first design's stays in
    crossprod_ff.cu, alone there."""
    with open(os.path.join(_build.CSRC, "crossprod_ff_v2.cu")) as fh:
        prod = fh.read()
    with open(os.path.join(_build.CSRC, "crossprod_ff.cu")) as fh:
        first = fh.read()
    assert re.findall(r'extern "C" int (\w+)\(', prod) == ["fp_crossprod_ff"]
    assert re.findall(r'extern "C" int (\w+)\(', first) == [
        "fp_crossprod_ff_v1"]
    # the note names the TPU kernel it replaces and its bound
    assert "packed_matvec.py::_crossprod_ff_kernel" in prod
    assert "4*KC*p*n4 operations" in prod


def test_production_b5_library_holds_only_b5():
    """The comparison tiles are built into their own library: B5's
    source defines one C entry, and the variants' source includes it
    with that entry switched off."""
    with open(os.path.join(_build.CSRC, "matvec_ff_novl.cu")) as fh:
        prod = fh.read()
    with open(os.path.join(_build.CSRC, "matvec_ff_novl_variants.cu")) as fh:
        var = fh.read()
    assert re.findall(r'extern "C" int (\w+)\(', prod) == ["fp_matvec_ff_novl"]
    assert re.search(r"#ifndef MATVEC_FF_NOVL_NO_ENTRY\s+// B5\.", prod)
    assert var.index("#define MATVEC_FF_NOVL_NO_ENTRY") < var.index(
        '#include "matvec_ff_novl.cu"')


def test_launch_counts_cover_every_entry():
    assert set(tpk.launch_counts) == set(_build.KERNELS)
    for comparison in (tpk.NOVL_KERNELS, tpk.B1_KERNELS, tpk.B2_KERNELS,
                       tpk.B3_KERNELS, tpk.B4_KERNELS):
        assert set(comparison) <= set(tpk.launch_counts)
        assert not set(comparison) & set(tpk.OPERATOR_KERNELS)
    assert tpk.B1_KERNELS == ("crossprod_v1",)
    assert tpk.B3_KERNELS == ("crossprod_ff_v1",)
    assert tpk.B4_KERNELS == ("matvec_ff_v1",)


@pytest.fixture(scope="module")
def novl_operands():
    rng = np.random.default_rng(41)
    p, n = 133, 771                    # p % 64 != 0, nb % 64 != 0
    nb = (n + 3) // 4
    packed = torch.from_numpy(rng.integers(0, 256, (p, nb), dtype=np.uint8))
    lut6 = tpk.lut_rows(torch.from_numpy(rng.standard_normal((p, 4))),
                        torch.from_numpy(rng.standard_normal((p, 4)) * 1e-8))
    return packed, lut6, rng


@pytest.mark.parametrize("name", ("matvec_ff_novl",) + tpk.NOVL_KERNELS)
def test_novl_wrapper_exists_for_each_entry(name):
    """chip_smoke.time_novl reaches each entry through ``<name>_p``."""
    assert callable(getattr(tpk, name + "_p"))


@pytest.mark.parametrize("name", tpk.NOVL_KERNELS)
def test_novl_comparison_wrapper_on_cpu_is_plain(novl_operands, name):
    packed, lut6, rng = novl_operands
    v = torch.from_numpy(
        rng.standard_normal((packed.shape[0], 40)).astype(np.float32))
    tpk.reset_launch_counts()
    yh, yl = getattr(tpk, name + "_p")(packed, lut6, v)
    ph, pl = tpk.matvec_ff_novl_plain(packed, lut6, v)
    assert torch.equal(yh, ph) and torch.equal(yl, pl)
    assert all(c == 0 for c in tpk.launch_counts.values())


@pytest.mark.parametrize("k", [3, 16, 40])
@pytest.mark.parametrize("name", ("crossprod",) + tpk.B1_KERNELS)
def test_b1_wrappers_on_cpu_are_plain(novl_operands, name, k):
    """B1 and its first design take crossprod_plain on CPU tensors, bit
    for bit, and launch nothing."""
    packed, _, rng = novl_operands
    p, nb = packed.shape
    mean = torch.from_numpy(rng.uniform(0.1, 1.9, p))
    invsd = torch.from_numpy(rng.uniform(0.5, 2.0, p))
    x = torch.from_numpy(rng.standard_normal((4 * nb, k)).astype(np.float32))
    tpk.reset_launch_counts()
    z = getattr(tpk, name + "_p")(packed, mean, invsd, x)
    assert torch.equal(z, tpk.crossprod_plain(packed, mean, invsd, x))
    assert all(c == 0 for c in tpk.launch_counts.values())


@pytest.mark.parametrize("k", [3, 16, 24, 40])
@pytest.mark.parametrize("name", ("matvec",) + tpk.B2_KERNELS)
def test_b2_wrappers_on_cpu_are_plain(novl_operands, name, k):
    """B2 and its first design take matvec_plain on CPU tensors, bit for
    bit, and launch nothing."""
    packed, _, rng = novl_operands
    p = packed.shape[0]
    mean = torch.from_numpy(rng.uniform(0.1, 1.9, p))
    invsd = torch.from_numpy(rng.uniform(0.5, 2.0, p))
    v = torch.from_numpy(rng.standard_normal((p, k)).astype(np.float32))
    tpk.reset_launch_counts()
    y = getattr(tpk, name + "_p")(packed, mean, invsd, v)
    assert torch.equal(y, tpk.matvec_plain(packed, mean, invsd, v))
    assert all(c == 0 for c in tpk.launch_counts.values())


@pytest.mark.parametrize("k", [3, 16, 40])
@pytest.mark.parametrize("name", ("crossprod_ff",) + tpk.B3_KERNELS)
def test_b3_wrappers_on_cpu_are_plain(novl_operands, name, k):
    """B3 and its first design take crossprod_ff_plain on CPU tensors,
    both halves bit for bit, and launch nothing."""
    packed, lut6, rng = novl_operands
    x = torch.from_numpy(
        rng.standard_normal((4 * packed.shape[1], k)).astype(np.float32))
    tpk.reset_launch_counts()
    zh, zl = getattr(tpk, name + "_p")(packed, lut6, x)
    ph, pl = tpk.crossprod_ff_plain(packed, lut6, x)
    assert torch.equal(zh, ph) and torch.equal(zl, pl)
    assert all(c == 0 for c in tpk.launch_counts.values())


@pytest.mark.parametrize("k", [3, 16, 24, 40])
@pytest.mark.parametrize("name", ("matvec_ff",) + tpk.B4_KERNELS)
def test_b4_wrappers_on_cpu_are_plain(novl_operands, name, k):
    """B4 and its first design take matvec_ff_plain on CPU tensors, both
    halves bit for bit, and launch nothing."""
    packed, lut6, rng = novl_operands
    p = packed.shape[0]
    vh = torch.from_numpy(rng.standard_normal((p, k)).astype(np.float32))
    vl = torch.from_numpy(
        (rng.standard_normal((p, k)) * 1e-7).astype(np.float32))
    tpk.reset_launch_counts()
    yh, yl = getattr(tpk, name + "_p")(packed, lut6, vh, vl)
    ph, pl = tpk.matvec_ff_plain(packed, lut6, vh, vl)
    assert torch.equal(yh, ph) and torch.equal(yl, pl)
    assert all(c == 0 for c in tpk.launch_counts.values())


@pytest.mark.parametrize("name", ("crossprod", "crossprod_narrow")
                         + tpk.B1_KERNELS)
def test_chip_smoke_has_rows_for_b1_and_its_first_design(name):
    """The rows chip_smoke's timing phase reads for B1 and its first
    design, so the phase cannot KeyError on the card."""
    cs = _chip_smoke()
    assert cs.SOURCE[name] == ("flashpca_tpu_torch/kernels/csrc/"
                               + _build.KERNELS[name][0])
    assert os.path.exists(os.path.join(ROOT, cs.SOURCE[name]))
    assert cs.TPU_KERNEL[name] == "flashpca_tpu/kernels/packed_matvec.py:83"
    assert cs.DOTS[name] == 1


@pytest.mark.parametrize("name", ["crossprod_stacked", "crossprod_stacked_v1",
                                  "crossprod_nocomp", "crossprod_nocomp_v1"])
def test_chip_smoke_has_rows_for_v1_v4_and_their_first_designs(name):
    """The rows chip_smoke's sweep phase reads for V1, V4 and their first
    designs: sources, the TPU kernel replaced, one product a genotype
    (the bound), the float64 bar, and the sweep's launches."""
    cs = _chip_smoke()
    assert cs.SOURCE[name] == ("flashpca_tpu_torch/kernels/csrc/"
                               + _build.KERNELS[name][0])
    assert os.path.exists(os.path.join(ROOT, cs.SOURCE[name]))
    line = {"crossprod_stacked": 50, "crossprod_nocomp": 261}[
        name.removesuffix("_v1")]
    assert cs.TPU_KERNEL[name] == f".claude/skills/verify/kernel_sweep.py:{line}"
    assert cs.DOTS[name] == 1 and cs.F64_BAR[name] == 1e-5
    assert name in cs.SWEEP_PATH
    assert (name in cs.VARIANT_FIRSTS) == name.endswith("_v1")


@pytest.mark.parametrize("name", ["crossprod_intsub", "crossprod_intsub_v1",
                                  "crossprod_split3", "crossprod_split3_v1"])
def test_chip_smoke_has_rows_for_v2_v3_and_their_first_designs(name):
    """The rows chip_smoke's sweep phase reads for V2, V3 and their first
    designs: sources, the TPU kernel replaced, the float64 bar (V3's
    5e-5 for its dropped lo * lo term), V2's one float32 product a
    genotype (V3's bound is apart), and the sweep's launches."""
    cs = _chip_smoke()
    assert cs.SOURCE[name] == ("flashpca_tpu_torch/kernels/csrc/"
                               + _build.KERNELS[name][0])
    assert os.path.exists(os.path.join(ROOT, cs.SOURCE[name]))
    base = name.removesuffix("_v1")
    line = {"crossprod_intsub": 128, "crossprod_split3": 209}[base]
    assert cs.TPU_KERNEL[name] == f".claude/skills/verify/kernel_sweep.py:{line}"
    assert cs.F64_BAR[name] == (5e-5 if base == "crossprod_split3" else 1e-5)
    assert (cs.DOTS.get(name) == 1) == (base == "crossprod_intsub")
    assert name in cs.SWEEP_PATH
    assert (name in cs.VARIANT_FIRSTS) == name.endswith("_v1")


def test_chip_smoke_requires_variant_equal():
    """V1-V4 against their first designs: one ulp in any fails."""
    cs = _chip_smoke()
    z = torch.arange(8.0).reshape(4, 2)
    outs = {name: z.clone() for first in cs.VARIANT_FIRSTS
            for name in (first.removesuffix("_v1"), first)}
    assert len(outs) == 8
    cs.require_variant_equal(outs, "same")
    for name in outs:
        b = z.clone()
        b[1, 1] = torch.nextafter(b[1, 1], torch.tensor(99.0))
        with pytest.raises(AssertionError, match="not bit-equal"):
            cs.require_variant_equal(dict(outs, **{name: b}), "one ulp")


def test_chip_smoke_sweep_phase_rows_and_bit_equality(monkeypatch):
    """The sweep phase on the CPU with the tool's run stubbed: a row for
    each variant and for its first design (marked first, 0 launches on
    the main path, beside B1's time and the difference), V3's bound and
    its first design's from the work the function needs, each design's
    own CUDA-core count beside it (V3's from its SASS, the first
    design's 9 instructions a genotype), and a failure when a redesign is
    not bit-equal at the sweep's shape."""
    from flashpca_tpu_torch.kernels import crossprod_variants as cv
    from flashpca_tpu_torch.tools import kernel_sweep as ks

    cs = _chip_smoke()
    names = cs.VARIANTS + cs.VARIANT_FIRSTS
    ms = dict({"crossprod": 50.0}, **{nm: 40.0 + i
                                      for i, nm in enumerate(names)})

    def fake_run(p, nb, k, dev, equal=True):
        for nm in cs.SWEEP_PATH:
            tpk.launch_counts[nm] += 2
        data = ks.sweep_data(p, nb, k, "cpu")
        return ({"correctness": dict.fromkeys(names, 1e-7),
                 "first_designs_equal": {"crossprod_stacked_v1": True,
                                         "crossprod_intsub_v1": True,
                                         "crossprod_nocomp_v1": equal,
                                         "crossprod_split3_v1": True},
                 "variants": {"ms": ms, "minus_b1_ms": {
                     nm: t - 50.0 for nm, t in ms.items()
                     if nm != "crossprod"}}}, data)

    monkeypatch.setattr(cs, "sync", lambda: None)
    monkeypatch.setattr(ks, "run", fake_run)
    monkeypatch.setattr(ks, "event_ms", lambda fn, reps: 7.0)
    worst = dict.fromkeys(tpk.launch_counts, 1e-3)
    main = dict.fromkeys(tpk.launch_counts, 0)
    rows, out = cs.kernel_sweep("cpu", 64, 203, worst, 9.0, main, 2.5)
    assert [r["name"] for r in rows] == list(names)
    by = {r["name"]: r for r in rows}
    n4 = 4 * ((203 + 3) // 4)
    def own_ms(ops):
        return ops * 64 * n4 / cs.PEAK_FP32_INSTR * 1e3

    tensor = 3 * 2.0 * 16 * 64 * n4 / cs.PEAK_BF16_FLOPS * 1e3
    needed = 1.875 * 64 * n4 / cs.PEAK_FP32_INSTR * 1e3
    nbytes = 64 * (n4 // 4) + n4 * 16 * 4 + 3 * 64 * 4 + 64 * 16 * 4
    for name, own in (("crossprod_split3", 2.5), ("crossprod_split3_v1", 9)):
        assert by[name]["ops_per_genotype"] == 1.875
        assert by[name]["own_ops_per_genotype"] == own
        assert by[name]["own_ops_ms"] == pytest.approx(own_ms(own))
        assert by[name]["bound_ms"] == pytest.approx(
            max(tensor, needed, nbytes / cs.PEAK_BYTES_S * 1e3))
    assert "ops_per_genotype" not in by["crossprod_intsub"]
    for r in rows:
        assert r["launches"] == 2 and r["main_path_launches"] == 0
        assert r["ms"] == ms[r["name"]] and r["b1_ms"] == 50.0
        assert r["minus_b1_ms"] == ms[r["name"]] - 50.0
        assert r["plain_ms"] == 7.0 and r["library_ms"] == 9.0
        assert (r.get("design") == "first") == (r["name"] in cv.FIRST_DESIGNS)
        assert r["source"] == cs.SOURCE[r["name"]]
    assert out["launches"] == dict.fromkeys(cs.SWEEP_PATH, 2)
    monkeypatch.setattr(ks, "run", functools.partial(fake_run, equal=False))
    with pytest.raises(AssertionError, match="crossprod_nocomp_v1"):
        cs.kernel_sweep("cpu", 64, 203, worst, 9.0, main, 2.5)


def test_chip_smoke_names_v1_v4_instantiations_and_reads_them():
    """V1's and V4's symbols as ptxas and cuobjdump name them; the smoke
    reads their and B1's inner-loop mix, and requires no spill in the
    redesigns' source."""
    cs = _chip_smoke()
    pre = "_ZN47_GLOBAL__N__9a1b2c3d_24_crossprod_variants_v2_cu_1f2e3d4c4var2"
    for kern in ("nocomp_tile_kernel", "stacked_tile_kernel"):
        sym = f"{pre}{len(kern)}{kern}ILi16EEEvPKhPKfS5_S5_S5_Pfxxbb"
        assert cs.kernel_name(sym) == f"{kern}<16>"
        assert cs.sass_read(f"{kern}<16>")
    assert cs.sass_read("crossprod_tile_kernel<16>")
    assert cs.sass_read("matvec_kernel<16, 64>")
    assert not cs.sass_read("matvec_kernel<16, 32>")
    assert not cs.sass_read("crossprod_kernel<16, 256>")
    assert {"crossprod_v2.cu", "crossprod_variants_v2.cu"} <= set(
        cs.SASS_SOURCES)
    assert "crossprod_variants_v2.cu" in cs.NO_SPILL_SOURCES
    assert set(cs.SASS_SOURCES) | set(cs.NO_SPILL_SOURCES) <= set(
        _build.sources())


def test_chip_smoke_names_v2_v3_instantiations_and_reads_them():
    """V2's and V3's symbols as ptxas and cuobjdump name them (V3's with
    its aligned-bytes flag; its first design's kernel is not read), the
    smoke reads both inner loops, names the one V3's bound reads, and
    requires no spill in V3's source."""
    cs = _chip_smoke()
    pre = "_ZN47_GLOBAL__N__9a1b2c3d_24_crossprod_variants_v2_cu_1f2e3d4c4var2"
    sym = f"{pre}18intsub_tile_kernelILi16EEEvPKhPKfS5_S5_S5_Pfxxbb"
    assert cs.kernel_name(sym) == "intsub_tile_kernel<16>"
    assert cs.sass_read("intsub_tile_kernel<16>")
    pre = "_ZN45_GLOBAL__N__9a1b2c3d_21_crossprod_split3_v2_cu_1f2e3d4c2s3"
    sym = f"{pre}17split_tile_kernelILi16ELb1EEEvPKhPKfS6_S6_PKtPfxx"
    assert cs.kernel_name(sym) == "split_tile_kernel<16, 1>" == cs.SPLIT3_SASS
    assert cs.sass_read(cs.SPLIT3_SASS)
    assert not cs.sass_read("split_kernel<16>")
    assert not cs.sass_read("split_panel_kernel<16>")
    assert "crossprod_split3_v2.cu" in cs.SASS_SOURCES
    assert "crossprod_split3_v2.cu" in cs.NO_SPILL_SOURCES


def test_chip_smoke_reads_v3s_loop_by_its_hmma():
    """A function whose loops hold HMMA is read by them: the shortest
    loop with at least 90% of the most HMMA, not the FFMA-richer fold
    loop; its CUDA-core instructions a genotype are all but the HMMA over
    the genotypes the HMMA consume (8 a thread each, each feeding 3 kc /
    8 of them)."""
    cs = _chip_smoke()
    sym = "_ZN5_GLOBAL__N_117split_tile_kernelILi16ELb1EEEvPKh"
    lines = ["\tcode for sm_90a", f"\t\tFunction : {sym}",
             "        /*0000*/                   MOV R1, c[0x0][0x28] ;"]
    addr = 0x10
    for op in (["HMMA.16816.F32.BF16 R4, R8, R12, R4"] * 6
               + ["PRMT R9, R2, R3, R5", "LOP3.LUT R5, R6, 0x3030303, RZ, "
                  "0xc0, !PT", "IMAD R5, R5, 0x22, R7"]
               + ["FFMA R4, R5, R6, R4"] * 2):
        lines.append(f"        /*{addr:04x}*/                   {op} ;")
        addr += 0x10
    lines.append(f"        /*{addr:04x}*/              @P0  BRA 0x10 ;")
    addr += 0x10
    for _ in range(20):
        lines.append(f"        /*{addr:04x}*/                   "
                     "FFMA R4, R5, R6, R4 ;")
        addr += 0x10
    lines.append(f"        /*{addr:04x}*/              @!P1 BRA 0x0 ;")
    loop = cs.sass_hot_loops("\n".join(lines))["split_tile_kernel<16, 1>"]
    assert dict(loop) == {"HMMA": 6, "PRMT": 1, "LOP3": 1, "IMAD": 1,
                          "FFMA": 2, "BRA": 1}
    # 6 HMMA at kc=16: 6 x 64 / 48 = 8 genotypes; 6 other instructions
    assert cs.split3_ops_per_genotype(loop, 16) == 6 / 8


def test_v3s_bound_counts_the_work_its_function_needs():
    """V3's bound counts the pick (one byte permute a genotype: a 32-bit
    A register holds two genotypes, hi and lo one permute each) and the
    TwoSum fold every 128 samples (7 adds a column), not the shipped
    loop's selectors, addresses and loads; at the sweep's shape the
    tensor-core products bound it."""
    cs = _chip_smoke()
    assert cs.split3_needed_ops_per_genotype(16) == 1.875
    assert cs.split3_needed_ops_per_genotype(32) == 2.75
    p, n4 = 100_352, 501_760
    tensor = cs.SPLIT3_BF16_DOTS * 2.0 * 16 * p * n4 / cs.PEAK_BF16_FLOPS
    needed = 1.875 * p * n4 / cs.PEAK_FP32_INSTR
    assert tensor * 1e3 == pytest.approx(4.89, abs=0.01)
    assert needed * 1e3 == pytest.approx(2.82, abs=0.01)
    assert cs.SPLIT3_OPS_PER_GENOTYPE * p * n4 / cs.PEAK_FP32_INSTR > tensor


def test_chip_smoke_holds_v2s_loop_to_b1s():
    """The smoke fails unless V2's inner loop at kc 16 has B1's length
    and FFMA count (both instantiate b1_tile.cuh's loop)."""
    cs = _chip_smoke()
    assert cs.SAME_LOOP == ("crossprod_tile_kernel<16>",
                            "intsub_tile_kernel<16>")
    assert cs.sass_read(cs.SAME_LOOP[0]) and cs.sass_read(cs.SAME_LOOP[1])
    b1 = {"ffma": 1024, "instructions": 1605, "ffma_share": 0.638}
    cs.require_same_loop({cs.SAME_LOOP[0]: b1, cs.SAME_LOOP[1]: dict(b1)},
                         *cs.SAME_LOOP)
    for bad in ({cs.SAME_LOOP[0]: b1},
                {cs.SAME_LOOP[0]: b1,
                 cs.SAME_LOOP[1]: dict(b1, instructions=1606)},
                {cs.SAME_LOOP[0]: b1, cs.SAME_LOOP[1]: dict(b1, ffma=1023)}):
        with pytest.raises(AssertionError, match="intsub_tile_kernel<16>"):
            cs.require_same_loop(bad, *cs.SAME_LOOP)


def test_chip_smoke_names_b1s_instantiations():
    cs = _chip_smoke()
    sym = ("_ZN45_GLOBAL__N__9a1b2c3d_15_crossprod_v2_cu_1f2e3d4c2v2"
           "21crossprod_tile_kernelILi32EEEvPKhPKfS5_S5_S5_Pfxxbb")
    assert cs.kernel_name(sym) == "crossprod_tile_kernel<32>"


@pytest.mark.parametrize("name", ("crossprod_ff",) + tpk.B3_KERNELS)
def test_chip_smoke_has_rows_for_b3_and_its_first_design(name):
    """The rows chip_smoke's timing phase reads for B3 and its first
    design: sources, the TPU kernel replaced and two products a genotype
    (the bound)."""
    cs = _chip_smoke()
    assert cs.SOURCE[name] == ("flashpca_tpu_torch/kernels/csrc/"
                               + _build.KERNELS[name][0])
    assert os.path.exists(os.path.join(ROOT, cs.SOURCE[name]))
    assert cs.TPU_KERNEL[name] == "flashpca_tpu/kernels/packed_matvec.py:336"
    assert cs.DOTS[name] == 2


@pytest.mark.parametrize("name", ("matvec", "matvec_narrow")
                         + tpk.B2_KERNELS)
def test_chip_smoke_has_rows_for_b2_and_its_first_design(name):
    """The rows chip_smoke's timing phase reads for B2 and its first
    design: sources, the TPU kernel replaced and one product a genotype
    (the bound)."""
    cs = _chip_smoke()
    assert cs.SOURCE[name] == ("flashpca_tpu_torch/kernels/csrc/"
                               + _build.KERNELS[name][0])
    assert os.path.exists(os.path.join(ROOT, cs.SOURCE[name]))
    assert cs.TPU_KERNEL[name] == "flashpca_tpu/kernels/packed_matvec.py:122"
    assert cs.DOTS[name] == 1


def test_chip_smoke_names_b2s_instantiations():
    cs = _chip_smoke()
    sym = ("_ZN45_GLOBAL__N__9a1b2c3d_12_matvec_v2_cu_1f2e3d4c3mv2"
           "18matvec_tile_kernelILi16EEEvPKhPKfS5_S5_S5_Pfxxbb")
    assert cs.kernel_name(sym) == "matvec_tile_kernel<16>"
    sym = ("_ZN45_GLOBAL__N__9a1b2c3d_9_matvec_cu_1f2e3d4c"
           "13matvec_kernelILi24ELi64EEEvPKhPKfS4_S4_S4_Pfxx")
    assert cs.kernel_name(sym) == "matvec_kernel<24, 64>"


def test_chip_smoke_requires_b2_equal():
    """B2 against its first design and the tile entry at 64 rows a
    chunk: one ulp in either fails."""
    cs = _chip_smoke()
    y = torch.arange(8.0).reshape(4, 2)
    cs.require_b2_equal(y, y.clone(), y.clone(), "same")
    b = y.clone()
    b[2, 0] = torch.nextafter(b[2, 0], torch.tensor(99.0))
    for got in ((b, y), (y, b)):
        with pytest.raises(AssertionError, match="not bit-equal"):
            cs.require_b2_equal(y, *got, "one ulp")


@pytest.mark.parametrize("name", ("matvec_ff",) + tpk.B4_KERNELS)
def test_chip_smoke_has_rows_for_b4_and_its_first_design(name):
    """The rows chip_smoke's timing phase reads for B4 and its first
    design: sources, the TPU kernel replaced and three products a
    genotype (the bound)."""
    cs = _chip_smoke()
    assert cs.SOURCE[name] == ("flashpca_tpu_torch/kernels/csrc/"
                               + _build.KERNELS[name][0])
    assert os.path.exists(os.path.join(ROOT, cs.SOURCE[name]))
    assert cs.TPU_KERNEL[name] == "flashpca_tpu/kernels/packed_matvec.py:369"
    assert cs.DOTS[name] == 3


def test_chip_smoke_names_b4s_instantiations():
    """B4's and its first design's symbols, as ptxas and cuobjdump name
    them; the smoke reads the inner loop of both."""
    cs = _chip_smoke()
    sym = ("_ZN46_GLOBAL__N__9a1b2c3d_15_matvec_ff_v2_cu_1f2e3d4c4mff2"
           "21matvec_ff_tile_kernelILi24EEEvPKhPKfS5_S5_PfS6_xxbb")
    assert cs.kernel_name(sym) == "matvec_ff_tile_kernel<24>"
    sym = ("_ZN45_GLOBAL__N__9a1b2c3d_12_matvec_ff_cu_1f2e3d4c"
           "16matvec_ff_kernelILi24ELb1EEEvPKhPKfS4_S4_PfS5_xx")
    assert cs.kernel_name(sym) == "matvec_ff_kernel<24, 1>"


def test_chip_smoke_requires_b4_equal_on_both_halves():
    cs = _chip_smoke()
    a = torch.arange(8.0).reshape(4, 2)
    cs.require_b4_equal((a, a * 1e-8), (a.clone(), a * 1e-8), "same")
    b = a.clone()
    b[3, 1] = torch.nextafter(b[3, 1], torch.tensor(-9.0))
    for got in ((b, a * 1e-8), (a, b * 1e-8)):
        with pytest.raises(AssertionError, match="not bit-equal"):
            cs.require_b4_equal(got, (a, a * 1e-8), "one ulp")


def test_chip_smoke_runs_no_first_design_on_a_main_path():
    """A launch of B4's first design (or any other) on a main path
    fails the smoke; the production kernels' launches do not."""
    cs = _chip_smoke()
    launches = dict.fromkeys(tpk.launch_counts, 0)
    launches.update(dict.fromkeys(cs.WIDE_PATH, 5))
    cs.require_no_first_design(launches, "wide path")
    for first in tpk.B4_KERNELS + tpk.B2_KERNELS:
        with pytest.raises(AssertionError, match=first):
            cs.require_no_first_design(dict(launches, **{first: 1}),
                                       "wide path")


def test_chip_smoke_names_b3s_instantiations():
    cs = _chip_smoke()
    sym = ("_ZN45_GLOBAL__N__9a1b2c3d_18_crossprod_ff_v2_cu_1f2e3d4c3ff2"
           "24crossprod_ff_tile_kernelILi24EEEvPKhPKfS5_PfS6_xxbb")
    assert cs.kernel_name(sym) == "crossprod_ff_tile_kernel<24>"


def test_chip_smoke_requires_no_spills():
    cs = _chip_smoke()
    ok = [("k<8>", "Used 60 registers, 400 bytes cmem[0]; 0 bytes spill "
           "stores, 0 bytes spill loads")]
    cs.require_no_spills("crossprod_ff_v2.cu", ok)
    for bad in ([("k<32>", "Used 80 registers; 8 bytes spill stores, 4 "
                  "bytes spill loads")], [("k<32>", "Used 80 registers")],
                []):
        with pytest.raises(AssertionError):
            cs.require_no_spills("crossprod_ff_v2.cu", ok + bad
                                 if bad else bad)


def test_chip_smoke_requires_b3_equal_on_both_halves():
    cs = _chip_smoke()
    a = torch.arange(6.0).reshape(3, 2)
    cs.require_b3_equal((a, -a), (a.clone(), -a), "same")
    b = a.clone()
    b[1, 1] = torch.nextafter(b[1, 1], torch.tensor(9.0))
    for got in ((b, -a), (a, -b)):
        with pytest.raises(AssertionError, match="not bit-equal"):
            cs.require_b3_equal(got, (a, -a), "one ulp")


def test_chip_smoke_pairs_rows_with_first_designs():
    """A first-design row follows each current row whose first design
    was timed at its kc, with the current row's bound and library time
    and its own median time; other rows pass through unmarked."""
    cs = _chip_smoke()
    row = {"name": "crossprod_ff", "k": 20, "ms": 1.0, "bound_ms": 0.5,
           "library_ms": 2.0, "launches": 5}
    other = dict(row, name="matvec", k=16)
    launches = dict.fromkeys(tpk.launch_counts, 0)
    worst = dict.fromkeys(tpk.launch_counts, 0.0)
    out = cs.with_first_designs(
        [row, other], {"crossprod_ff": ("crossprod_ff_v1",
                                        {"crossprod_ff_v1/24": [3.0, 5.0]})},
        launches, worst)
    assert [(r["name"], r.get("design")) for r in out] == [
        ("crossprod_ff", "current"), ("crossprod_ff_v1", "first"),
        ("matvec", None)]
    first = out[1]
    assert first["ms"] == 4.0 and first["launches"] == 0
    assert (first["bound_ms"], first["library_ms"]) == (0.5, 2.0)
    assert first["source"].endswith("/crossprod_ff.cu")


def test_b3_tile_tool_reads_production_tiles():
    """The tool's production tiles are the source's defaults, and every
    tile it tries divides its KC."""
    from flashpca_tpu_torch.tools import b3_tiles

    prod = b3_tiles.production_tiles()
    assert prod == {8: (1, 8, 768), 16: (1, 8, 768), 24: (1, 12, 768),
                    32: (1, 16, 512)}
    for kc, tiles in b3_tiles.TILES.items():
        for r, c, tps in tiles:
            assert (r, c, tps) != prod[kc]
            assert kc % c == 0 and c % 4 == 0 and 128 % (32 * r) == 0
    src = b3_tiles.tile_source(32, (2, 8, 768)).splitlines()
    assert src[0] == "#define CROSSPROD_FF_TILE_32 2, 8, 768"
    assert src[1] == '#include "%s"' % os.path.join(_build.CSRC,
                                                    "crossprod_ff_v2.cu")
    # the tool reads each tile's registers under the kernel's own name
    sym = ("_ZN45_GLOBAL__N__9a1b2c3d_18_crossprod_ff_v2_cu_1f2e3d4c3ff2"
           "24crossprod_ff_tile_kernelILi24EEEvPKhPKfS5_PfS6_xxbb")
    log = [f"ptxas info    : Compiling entry function '{sym}' for 'sm_90a'",
           "ptxas info    : Used 80 registers, used 1 barriers"]
    assert dict(_build.ptxas_usage(log)) == {
        f"{b3_tiles.KERNEL}<24>": "Used 80 registers, used 1 barriers"}
    # the source only sets a default the definition overrides
    with open(os.path.join(_build.CSRC, "crossprod_ff_v2.cu")) as fh:
        assert "#ifndef CROSSPROD_FF_TILE_32\n" in fh.read()


def test_b3_tile_tool_counts_blocks_an_sm():
    """Production's kc=32 tile: 256 threads, 72 KB of shared memory,
    two blocks an SM at 127 registers; three at 80 (shared memory allows
    three), two past 85."""
    from flashpca_tpu_torch.tools import b3_tiles

    assert b3_tiles.occupancy(32, (1, 16, 512), 127) == (256, 73_728, 2)
    assert b3_tiles.occupancy(32, (1, 16, 768), 80) == (256, 73_728, 3)
    assert b3_tiles.occupancy(32, (1, 16, 768), 86)[2] == 2


def test_b2_tile_tool_reads_production_tiles():
    """The tool's production tiles are the source's defaults, and every
    tile it tries is a tile the source takes: C divides KC, 4 | C, a
    warp's 32 bytes divide TB, and one thread a row decodes the 64-row
    tables."""
    from flashpca_tpu_torch.tools import b2_tiles, b3_tiles

    prod = b3_tiles.production_tiles(b2_tiles.SOURCE, b2_tiles.MACRO)
    assert prod == {8: (8, 64, 640, 1), 16: (16, 128, 384, 1),
                    24: (12, 64, 384, 1), 32: (16, 64, 384, 1)}
    assert sorted(b2_tiles.TILES) == [16, 24, 32]
    for kc, tiles in b2_tiles.TILES.items():
        assert len(tiles) >= 2
        for c, tb, tps, ereg in tiles:
            assert (c, tb, tps, ereg) != prod[kc]
            assert kc % c == 0 and c % 4 == 0 and tb % 32 == 0
            assert tb * (kc // c) >= 64 and ereg in (0, 1)
    src = b3_tiles.tile_source(16, (16, 64, 384, 1), b2_tiles.SOURCE,
                               b2_tiles.MACRO)
    assert src.splitlines() == [
        "#define MATVEC_TILE_16 16, 64, 384, 1",
        '#include "%s"' % os.path.join(_build.CSRC, "matvec_v2.cu")]
    with open(os.path.join(_build.CSRC, "matvec_v2.cu")) as fh:
        assert "#ifndef MATVEC_TILE_16\n" in fh.read()


def test_b2_tile_tool_counts_blocks_and_waves():
    """Production's kc=16 tile: 128 threads, 58 KB of shared memory,
    three blocks an SM at the 168 registers its launch bounds leave, 2.47
    waves on the wide shape; the header's table says so."""
    from flashpca_tpu_torch.tools import b2_tiles
    from flashpca_tpu_torch.tools import b3_tiles as bt

    def occupancy(kc, tile, regs):
        return bt.wt_occupancy(kc, tile, regs, b2_tiles.stage_bytes)

    tile = (16, 128, 384, 1)
    assert bt.reg_cap(16, tile) == 168
    assert occupancy(16, tile, 166) == (128, 59_392, 3)
    assert bt.wt_grid(tile, 100_352, 125_440) == 980
    assert round(bt.waves(980, 3), 2) == 2.47
    # err beside the sum in shared memory: 16 KB more a block, four blocks
    assert occupancy(16, (8, 64, 512, 0), 60) == (128, 51_200, 4)
    with open(os.path.join(_build.CSRC, "matvec_v2.cu")) as fh:
        text = fh.read()
    for kc, (c, tb, tps, _) in bt.production_tiles(
            b2_tiles.SOURCE, b2_tiles.MACRO).items():
        cap = bt.reg_cap(kc, (c, tb, tps, 1))
        nt, smem, blocks = occupancy(kc, (c, tb, tps, 1), cap)
        row = (f"//     {kc:2d}  {c:2d} {tb:3d}    {nt:3d}    {tps}    "
               f"{cap:3d}       {smem // 1024}        {blocks:2d}")
        assert row in text, row


def test_b4_tile_tool_reads_production_tiles():
    """The tool's production tiles are the source's defaults, and every
    tile it tries is a tile the source takes: C divides KC, 4 | C and a
    warp's 32 bytes divide TB; it times the wide kc=24 and the tall
    bytes' kc=24 launches."""
    from flashpca_tpu_torch.tools import b3_tiles, b4_tiles

    prod = b3_tiles.production_tiles(b4_tiles.SOURCE, b4_tiles.MACRO)
    assert sorted(prod) == [8, 16, 24, 32]
    assert sorted(b4_tiles.TILES) == [16, 24, 32]
    assert {(lbl, kc) for lbl, _, _, kc in b4_tiles.SHAPES} >= {
        ("wide", 24), ("tall", 24)}
    for kc, tiles in list(b4_tiles.TILES.items()) + [
            (kc, [t]) for kc, t in prod.items()]:
        for c, tb, tps, ereg, u in tiles:
            assert kc % c == 0 and c % 4 == 0 and tb % 32 == 0
            assert ereg in (0, 1) and tps >= tb * (kc // c)
            assert 64 % u == 0
    for kc, tiles in b4_tiles.TILES.items():
        assert len(tiles) >= 2 and prod[kc] not in tiles
    src = b3_tiles.tile_source(24, (8, 64, 384, 0, 8), b4_tiles.SOURCE,
                               b4_tiles.MACRO)
    assert src.splitlines() == [
        "#define MATVEC_FF_TILE_24 8, 64, 384, 0, 8",
        '#include "%s"' % os.path.join(_build.CSRC, "matvec_ff_v2.cu")]
    with open(os.path.join(_build.CSRC, "matvec_ff_v2.cu")) as fh:
        assert "#ifndef MATVEC_FF_TILE_24\n" in fh.read()
    # the tool reads each tile's registers under the kernel's own name
    sym = ("_ZN46_GLOBAL__N__9a1b2c3d_15_matvec_ff_v2_cu_1f2e3d4c4mff2"
           "21matvec_ff_tile_kernelILi24EEEvPKhPKfS5_S5_PfS6_xxbb")
    log = [f"ptxas info    : Compiling entry function '{sym}' for 'sm_90a'",
           "ptxas info    : Used 126 registers, used 1 barriers"]
    assert dict(_build.ptxas_usage(log)) == {
        f"{b4_tiles.KERNEL}<24>": "Used 126 registers, used 1 barriers"}


def test_b4_tile_tool_counts_blocks_and_waves():
    """A kc=24 tile of 8 columns: 192 threads, 60 KB of shared memory
    with err in registers (84 KB beside the sum), two blocks an SM at the
    168 registers that 384 threads leave, 7.42 waves on the wide shape;
    the header's table says so for every production tile."""
    from flashpca_tpu_torch.tools import b4_tiles
    from flashpca_tpu_torch.tools import b3_tiles as bt

    def occupancy(kc, tile, regs):
        return bt.wt_occupancy(kc, tile, regs, b4_tiles.stage_bytes)

    def waves(kc, tile, regs, nb):
        return bt.waves(bt.wt_grid(tile, 0, nb),
                        occupancy(kc, tile, regs)[2])

    tile = (8, 64, 384, 1, 8)
    assert bt.reg_cap(24, tile) == 168
    assert occupancy(24, tile, 166) == (192, 61_440, 2)
    assert round(waves(24, tile, 166, 125_440), 2) == 7.42
    assert round(waves(24, tile, 166, 250_880), 2) == 14.85
    # three blocks fit the shared memory but not 166 registers
    assert occupancy(24, tile, 104) == (192, 61_440, 3)
    assert occupancy(24, (8, 64, 384, 0, 8), 104) == (192, 86_016, 2)
    with open(os.path.join(_build.CSRC, "matvec_ff_v2.cu")) as fh:
        text = fh.read()
    for kc, tile in bt.production_tiles(b4_tiles.SOURCE,
                                        b4_tiles.MACRO).items():
        c, tb, tps, _, u = tile
        cap = bt.reg_cap(kc, tile)
        nt, smem, blocks = occupancy(kc, tile, cap)
        row = (f"//     {kc:2d}  {c:2d} {tb:3d}  {u:2d}    {nt:3d}    {tps}"
               f"    {cap:3d}      {smem // 1024:3d}        {blocks:2d}      "
               f"{waves(kc, tile, cap, 125_440):.2f}  "
               f"{waves(kc, tile, cap, 250_880):5.2f}")
        assert row in text, row


def test_tile_trials_hold_each_tile_to_the_first_design(monkeypatch,
                                                        tmp_path, capsys):
    """The tile tools' shared loop on the CPU, with the build and the
    clock stubbed: production, the first design and a tile that gives
    the first design's sums are bit-equal, a tile that moves one bit is
    not, and each built tile's row carries its occupancy and waves."""
    from flashpca_tpu_torch.tools import b3_tiles as bt
    from flashpca_tpu_torch.tools import b4_tiles

    (tmp_path / "matvec_ff_v2.log").write_text("")
    usage = "Used 160 registers, used 1 barriers"
    good, bad = (8, 64, 384, 1, 16), (8, 64, 384, 1, 4)

    def off_by_one_bit(packed, lut6, vh, vl):
        yh, yl = tpk.matvec_ff_v1_p(packed, lut6, vh, vl)
        return yh, torch.nextafter(yl, torch.full_like(yl, np.inf))

    monkeypatch.setattr(_build, "build_all", lambda: str(tmp_path))
    monkeypatch.setattr(bt, "build_tiles", lambda *a: {
        (24, good): (tpk.matvec_ff_v1_p, usage),
        (24, bad): (off_by_one_bit, usage)})
    monkeypatch.setattr(bt, "event_ms", lambda fn, reps: (fn(), 1.5)[1])
    occupancy = functools.partial(bt.wt_occupancy,
                                  stage_bytes=b4_tiles.stage_bytes)
    rows = bt.run_tiles(
        torch.device("cpu"), b4_tiles.NAME, b4_tiles.MACRO, b4_tiles.KERNEL,
        {24: [good, bad, (4, 64, 768, 0, 16)]}, (("wide", 133, 193, 24),),
        bt.table_data, b4_tiles.panel,
        lambda fn, *args: (lambda: fn(*args[:-1])), occupancy, bt.wt_grid)
    prod = bt.production_tiles(b4_tiles.SOURCE, b4_tiles.MACRO)[24]
    assert [(r["tile"], r["bit_equal"], r["ms"]) for r in rows] == [
        ("production " + str(prod), True, [1.5, 1.5]),
        ("first design", True, [1.5, 1.5]), (str(good), True, [1.5, 1.5]),
        (str(bad), False, [1.5, 1.5])]
    out = capsys.readouterr().out
    assert "NOT bit-equal" in out.splitlines()[-1]
    assert (f"{str(good):28s} 1.50, 1.50 ms; 192 threads, 60 KB, 2 "
            f"blocks/SM, 0.02 waves ({usage})") in out


def test_variant_tile_tool_reads_production_tiles():
    """The tool's production tiles are the source's defaults for V4 and
    V1, and every tile it tries is one the source takes: C divides KC,
    4 | C, a warp's 32 row slots divide the block's rows (V4: B1's 128),
    SREG, WBUF and the unrolled planes U in range; it times the sweep's
    wide kc=16 launch."""
    from flashpca_tpu_torch.tools import b3_tiles, variant_tiles as vt

    nocomp = b3_tiles.production_tiles(vt.SOURCE, vt.NOCOMP[1])
    stacked = b3_tiles.production_tiles(vt.SOURCE, vt.STACKED[1])
    assert sorted(nocomp) == sorted(stacked) == [8, 16, 24, 32]
    assert vt.SHAPES == (("wide", 100_352, 125_440, 16),)
    for prod, tiles, flags in ((nocomp, vt.NOCOMP_TILES, (0, 1)),
                               (stacked, vt.STACKED_TILES, (1, 2))):
        for kc, ts in list(tiles.items()) + [(kc, [t])
                                             for kc, t in prod.items()]:
            for tile in ts:
                tm, (r, c, tps, flag), u = ((128, tile, 4) if len(tile) == 4
                                            else (tile[0], tile[1:5],
                                                  tile[5]))
                assert kc % c == 0 and c % 4 == 0 and tm % (32 * r) == 0
                assert flag in flags and tps % 32 == 0 and u in (1, 2, 4)
        for kc, ts in tiles.items():
            assert len(ts) >= 2 and prod[kc] not in ts
    assert all(len(t) == 6 for t in stacked.values())
    src = b3_tiles.tile_source(16, (64, 2, 4, 640, 1, 4), vt.SOURCE,
                               vt.STACKED[1])
    assert src.splitlines() == [
        "#define CROSSPROD_STACKED_TILE_16 64, 2, 4, 640, 1, 4",
        '#include "%s"' % os.path.join(_build.CSRC, vt.SOURCE)]
    with open(os.path.join(_build.CSRC, vt.SOURCE)) as fh:
        text = fh.read()
    assert "#ifndef CROSSPROD_STACKED_TILE_16\n" in text
    assert "#ifndef CROSSPROD_NOCOMP_TILE_16\n" in text
    assert [t["name"] for t in vt.trials()] == ["crossprod_nocomp",
                                                "crossprod_stacked",
                                                "crossprod_split3"]


def test_variant_tile_tool_reads_v3s_production_tiles():
    """V3's production tiles are its source's defaults at every KC, and
    every tile tried is one the source takes: whole fold units a stage,
    a block's threads staging whole rows, shared memory within an SM's
    227 KB for one block; the trial reads
    ptxas's line of the aligned-bytes instantiation."""
    from flashpca_tpu_torch.tools import b3_tiles, variant_tiles as vt

    prod = b3_tiles.production_tiles(vt.SPLIT3_SOURCE, vt.SPLIT3[1])
    assert sorted(prod) == [8, 16, 24, 32]
    assert _build.KERNELS[vt.SPLIT3[0]][0] == vt.SPLIT3_SOURCE
    for kc, ts in list(vt.SPLIT3_TILES.items()) + [(kc, [t]) for kc, t
                                                   in prod.items()]:
        for tile in ts:
            mt, nw, sb, tps = tile
            assert mt >= 1 and nw >= 1 and sb % 32 == 0 and tps % 32 == 0
            assert 32 * nw % (sb // 16) == 0    # threads cover whole rows
            nt, smem, blocks = vt.split3_occupancy(kc, tile, 128)
            assert nt == 32 * nw and smem + 1024 <= 233_472 and blocks >= 1
    assert len(vt.SPLIT3_TILES[16]) >= 2 and prod[16] not in vt.SPLIT3_TILES[16]
    assert b3_tiles.instantiation(vt.SPLIT3[2], 16) == "split_tile_kernel<16, 1>"
    assert b3_tiles.instantiation("nocomp_tile_kernel", 16) == (
        "nocomp_tile_kernel<16>")


def test_variant_tile_tool_counts_v3s_blocks_an_sm():
    """V3 at its kc=16 production tile (2, 4, 64, 384): 128 threads, 60
    KB of shared memory (two stages of a 128 x 80-byte byte tile and 256
    panel rows of 80 bytes), three blocks an SM at the 168 registers 384
    threads leave, 784 blocks of 128 rows on the sweep's shape; one M
    tile a warp halves the rows, four double them."""
    from flashpca_tpu_torch.tools import variant_tiles as vt

    assert vt.split3_occupancy(16, (2, 4, 64, 384), 168) == (128, 61_440, 3)
    assert vt.split3_occupancy(16, (2, 8, 128, 256), 168) == (256, 155_648, 1)
    assert vt.split3_occupancy(16, (2, 4, 32, 512), 128) == (128, 32_768, 4)
    assert vt.split3_grid((2, 4, 64, 384), 100_352, 125_440) == 784
    assert vt.split3_grid((1, 4, 64, 512), 100_352, 125_440) == 1568
    assert vt.split3_grid((4, 4, 64, 256), 100_352, 125_440) == 392


def test_variant_tile_tool_counts_blocks_an_sm():
    """V1 at (128, 2, 8, 384, 1, 4), kc=16: 128 threads, 72 KB of shared
    memory (two 14 KB stages, a 34 KB decoded tile, the rows' values and
    the sums), three blocks an SM at the 168 registers 384 threads leave;
    at 64 rows a block 44 KB, five blocks; V4 at (2, 8, 768, 0): 36 KB,
    six blocks at 80 registers; 784 blocks of 128 rows on the sweep's
    shape, 1,568 of 64."""
    from flashpca_tpu_torch.tools import variant_tiles as vt

    assert vt.stacked_occupancy(16, (128, 2, 8, 384, 1, 4), 168) == (
        128, 73_728, 3)
    assert vt.stacked_occupancy(16, (128, 2, 8, 256, 2, 4), 168) == (
        128, 108_544, 2)
    assert vt.stacked_occupancy(16, (64, 1, 8, 640, 1, 4), 96) == (
        128, 45_056, 5)
    assert vt.nocomp_occupancy(16, (2, 8, 768, 0), 80) == (128, 36_864, 6)
    assert vt.nocomp_occupancy(16, (2, 8, 768, 1), 80) == (128, 28_672, 6)
    assert vt.nocomp_occupancy(16, (2, 4, 1024, 0), 64) == (256, 36_864, 4)
    assert vt.nocomp_grid((2, 8, 768, 0), 100_352, 125_440) == 784
    assert vt.stacked_grid((64, 1, 8, 640, 1, 4), 100_352, 125_440) == 1568


def test_variant_tile_trials_hold_each_tile_to_the_first_design(
        monkeypatch, tmp_path):
    """The shared loop on V4's wrappers (kernels/crossprod_variants.py)
    on the CPU, with the build and the clock stubbed: production, the
    first design and a tile with the first design's sums are bit-equal,
    one that moves one bit is not."""
    from flashpca_tpu_torch.kernels import crossprod_variants as cv
    from flashpca_tpu_torch.tools import b3_tiles as bt
    from flashpca_tpu_torch.tools import variant_tiles as vt

    (tmp_path / "crossprod_variants_v2.log").write_text("")
    usage = "Used 72 registers, used 1 barriers"
    good, bad = (2, 8, 768, 1), (2, 4, 768, 0)

    def off_by_one_bit(*args):
        z = cv.crossprod_nocomp_v1_p(*args)
        return torch.nextafter(z, torch.full_like(z, np.inf))

    monkeypatch.setattr(_build, "build_all", lambda: str(tmp_path))
    monkeypatch.setattr(bt, "build_tiles", lambda *a: {
        (16, good): (cv.crossprod_nocomp_v1_p, usage),
        (16, bad): (off_by_one_bit, usage)})
    monkeypatch.setattr(bt, "event_ms", lambda fn, reps: (fn(), 2.5)[1])
    run = dict(vt.trials()[0], shapes=(("wide", 133, 70, 16),),
               tiles={16: [good, bad]},
               launcher=lambda fn, *args: (lambda: fn(*args[:-1])))
    rows = bt.run_tiles(torch.device("cpu"), **run)
    prod = bt.production_tiles(vt.SOURCE, vt.NOCOMP[1])[16]
    assert [(r["tile"], r["bit_equal"]) for r in rows] == [
        ("production " + str(prod), True), ("first design", True),
        (str(good), True), (str(bad), False)]


def test_variant_tile_tool_exits_nonzero_without_gpu(monkeypatch, capsys):
    from flashpca_tpu_torch.tools import variant_tiles

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert variant_tiles.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_b4_tile_tool_exits_nonzero_without_gpu(monkeypatch, capsys):
    from flashpca_tpu_torch.tools import b4_tiles

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert b4_tiles.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_narrow_tile_tool_exits_nonzero_without_gpu(monkeypatch, capsys):
    from flashpca_tpu_torch.tools import narrow_tiles

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert narrow_tiles.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_narrow_tile_tool_reads_production_tiles():
    """The one-column tool reads each production tile from its source's
    default, as the tile tools do, and tries other ones through
    ``run_tiles``: production the wrapper on the column, the first
    design kc 8 on the padded column."""
    from flashpca_tpu_torch.tools import b3_tiles, narrow_tiles

    runs = narrow_tiles.trials()
    assert [r["name"] for r in runs] == ["crossprod_narrow", "matvec_narrow"]
    for run in runs:
        prod = b3_tiles.production_tiles(_build.KERNELS[run["name"]][0],
                                         run["macro"])
        assert set(prod) == {1} and len(prod[1]) == 3
        assert set(run["tiles"]) == {1} and run["tiles"][1]
        assert prod[1] not in run["tiles"][1]
        assert (b3_tiles.instantiation(run["kernel"], 1)
                == f"{run['kernel']}<1>")
        assert callable(getattr(run["module"], run["name"] + "_p"))
        assert callable(getattr(run["module"], run["name"] + "_v1_p"))
        assert all(kc == 1 for *_, kc in run["shapes"])


def test_narrow_tile_trials_hold_each_tile_to_kc8(monkeypatch, tmp_path):
    """The shared loop on the one-column trials on the CPU, the launches
    and the build stubbed: production (the one-column chunk), the first
    design (kc 8 on the padded column, its column 0) and a tile with the
    same sums are bit-equal, one that moves one bit is not."""
    from flashpca_tpu_torch.tools import b3_tiles as bt
    from flashpca_tpu_torch.tools import narrow_tiles as nt

    (tmp_path / "crossprod_narrow.log").write_text("")
    usage = "Used 103 registers, used 1 barriers"
    good, bad = (2, 4, 768), (3, 4, 512)

    def narrow(packed, coeffs, x):
        return coeffs[0][:, None] * x.sum() + coeffs[1][:, None]

    def padded(packed, coeffs, x8, kc, name="crossprod"):
        return torch.cat([narrow(packed, coeffs, x8[:, 0].contiguous()),
                          torch.zeros((packed.shape[0], kc - 1))], dim=1)

    def off_by_one_bit(*args):
        z = nt.WRAPPERS.crossprod_narrow_p(*args)
        return torch.nextafter(z, torch.full_like(z, np.inf))

    monkeypatch.setattr(tpk, "_launch_crossprod_narrow", narrow)
    monkeypatch.setattr(tpk, "_launch_crossprod", padded)
    monkeypatch.setattr(_build, "build_all", lambda: str(tmp_path))
    monkeypatch.setattr(bt, "build_tiles", lambda *a: {
        (1, good): (nt.WRAPPERS.crossprod_narrow_p, usage),
        (1, bad): (off_by_one_bit, usage)})
    monkeypatch.setattr(bt, "event_ms", lambda fn, reps: (fn(), 2.5)[1])
    run = dict(nt.trials()[0], shapes=(("wide", 133, 70, 1),),
               tiles={1: [good, bad]},
               launcher=lambda fn, *args: (lambda: fn(*args[:-1])))
    rows = bt.run_tiles(torch.device("cpu"), **run)
    prod = bt.production_tiles("crossprod_narrow.cu",
                               "CROSSPROD_NARROW_TILE")[1]
    assert [(r["tile"], r["bit_equal"]) for r in rows] == [
        ("production " + str(prod), True), ("first design", True),
        (str(good), True), (str(bad), False)]


def test_narrow_tile_occupancy_counts():
    """The one-column tiles' threads, shared bytes and blocks an SM from
    the sources' layouts (B1: 2 KB tables a row slot and two stages of
    48-byte rows and x; B2: two stages of 64 rows' tables and bytes), and
    their grids at the wide shape."""
    from flashpca_tpu_torch.tools import narrow_tiles as nt

    assert nt.crossprod_occupancy(1, (2, 4, 512), 103) == (128, 41_984, 4)
    assert nt.crossprod_occupancy(1, (1, 2, 1024), 64) == (64, 11_264, 16)
    assert nt.crossprod_grid((2, 4, 512), 100_352, 125_440) == 392
    assert nt.matvec_occupancy(1, (2, 4, 512), 64) == (128, 40_960, 5)
    assert nt.matvec_occupancy(1, (4, 2, 384), 64) == (64, 40_960, 5)
    assert nt.matvec_grid((2, 4, 512), 100_352, 125_440) == 490


def test_b2_tile_tool_exits_nonzero_without_gpu(monkeypatch, capsys):
    from flashpca_tpu_torch.tools import b2_tiles

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert b2_tiles.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_b3_tile_tool_exits_nonzero_without_gpu(monkeypatch, capsys):
    from flashpca_tpu_torch.tools import b3_tiles

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert b3_tiles.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["matvec_ff_novl", "matvec_ff_novl_v1"])
def test_chip_smoke_has_rows_for_b5_and_its_first_design(name):
    cs = _chip_smoke()
    assert cs.SOURCE[name] == ("flashpca_tpu_torch/kernels/csrc/"
                               + _build.KERNELS[name][0])
    assert os.path.exists(os.path.join(ROOT, cs.SOURCE[name]))
    assert cs.TPU_KERNEL[name] == "flashpca_tpu/kernels/packed_matvec.py:415"
    assert cs.DOTS[name] == 2


def test_chip_smoke_sources_match_the_build_table():
    cs = _chip_smoke()
    for name, path in cs.SOURCE.items():
        assert path.endswith("/" + _build.KERNELS[name][0]), name
        assert name in cs.TPU_KERNEL


def test_chip_smoke_reads_registers_and_spills():
    """The -Xptxas -v lines of one instantiation: the spill line comes
    before the register line and is reported with it."""
    cs = _chip_smoke()
    sym = ("_ZN45_GLOBAL__N__9a1b2c3d_17_matvec_ff_novl_cu_1f2e3d4c21"
           "matvec_ff_novl_kernelILi32ELi8ELi64EEEvPKhPKfS4_PfS5_xxbb")
    log = [f"ptxas info    : Compiling entry function '{sym}' for 'sm_90a'",
           f"ptxas info    : Function properties for {sym}",
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
           "loads",
           "ptxas info    : Used 128 registers, used 1 barriers, 28672 "
           "bytes smem, 400 bytes cmem[0]"]
    assert list(cs.ptxas_usage(log)) == [(
        "matvec_ff_novl_kernel<32, 8, 64>",
        "Used 128 registers, used 1 barriers, 28672 bytes smem, 400 bytes "
        "cmem[0]; 8 bytes spill stores, 4 bytes spill loads")]


def test_chip_smoke_reads_the_inner_loop_mix():
    """The hot loop of a SASS listing: the backward branch with the most
    FFMA, counted from its target to the branch itself."""
    cs = _chip_smoke()
    sym = "_ZN5_GLOBAL__N_121matvec_ff_novl_kernelILi32ELi8ELi64EEEvPKh"
    sass = "\n".join([
        "\tcode for sm_90a",
        f"\t\tFunction : {sym}",
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;",
        "        /*0010*/                   LDS.U8 R2, [R3] ;",
        "                                                  /* 0x000fe2 */",
        "        /*0020*/                   FFMA R4, R5, R6, R4 ;",
        "        /*0030*/                   FFMA R7, R5, R6, R7 ;",
        "        /*0040*/                   SHF.R.U32.HI R8, RZ, 0x2, R2 ;",
        "        /*0050*/              @P0  BRA 0x10 ;",
        "        /*0060*/                   IADD3 R9, R9, 0x1, RZ ;",
        "        /*0070*/              @!P1 BRA 0x0 ;",
        "        /*0080*/                   EXIT ;"])
    mix = cs.sass_hot_loops(sass)
    assert list(mix) == ["matvec_ff_novl_kernel<32, 8, 64>"]
    c = mix["matvec_ff_novl_kernel<32, 8, 64>"]
    assert dict(c) == {"LDS": 1, "FFMA": 2, "SHF": 1, "BRA": 1}


def test_chip_smoke_reads_the_inner_loop_inside_a_decoding_loop():
    """B2's chunk loop holds the inner row loop and a few FFMA of its own
    (the next chunk's table decode): the inner loop is still the one
    read, as the shortest loop with at least 90% of the most FFMA."""
    cs = _chip_smoke()
    sym = "_ZN5_GLOBAL__N_118matvec_tile_kernelILi16EEEvPKh"
    body = [f"        /*{a:04x}*/                   FFMA R4, R5, R6, R4 ;"
            for a in range(0x20, 0xc0, 0x10)]
    sass = "\n".join([
        "\tcode for sm_90a",
        f"\t\tFunction : {sym}",
        "        /*0000*/                   LDG.E R2, [R3] ;",
        "        /*0010*/                   LDS.U8 R2, [R3] ;",
        *body,
        "        /*00c0*/              @P0  BRA 0x10 ;",
        "        /*00d0*/                   FFMA R7, R5, R6, R7 ;",
        "        /*00e0*/              @!P1 BRA 0x0 ;",
        "        /*00f0*/                   EXIT ;"])
    c = cs.sass_hot_loops(sass)["matvec_tile_kernel<16>"]
    assert dict(c) == {"LDS": 1, "FFMA": 10, "BRA": 1}


def test_tall_gram_seed_tool_draws_the_card_tests_inputs():
    """The seed sweep's bytes are the card test's ``_operands`` and its
    draws are seeded: the same seed gives the same v and tables."""
    from flashpca_tpu_torch.tools import tall_gram_seeds as tgs

    spec = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(ROOT, "tests", "test_torch_cuda.py"))
    card = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card)
    packed, mean, invsd, nb = card._operands(torch.device("cpu"), 771, 133)
    for got, want in zip(tgs.operands(771, 133), (packed, mean, invsd)):
        assert torch.equal(got, want)
    a, b = tgs.draws(133, 28, 12), tgs.draws(133, 28, 12)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], tgs.draws(133, 28, 13)[0])
    assert [tuple(t.shape) for t in a] == [(133, 28), (133, 4), (133, 4)]


def test_tall_gram_seed_tool_reads_a_case_on_the_cpu():
    """On the CPU both sides take the plain version, so every ratio is
    0; the float64 gram of the same tables sits within float32 rounding
    of the plain pair."""
    from flashpca_tpu_torch.tools import tall_gram_seeds as tgs

    r = tgs.case(torch.device("cpu"), 37, 101, 5, 3)
    assert (r["hi_ratio"], r["pair_rel"], r["b3_ratio"]) == (0.0, 0.0, 0.0)
    assert r["card_pair_err"] == r["plain_pair_err"]
    assert r["plain_pair_err"] <= 1e-5 * max(1.0, abs(r["z64"]))
    ratio, at = tgs.hi_ratio(
        torch.tensor([1.0, 2.0 + 2e-3 + 4e-4], dtype=torch.float64),
        torch.tensor([1.0, 2.0], dtype=torch.float64))
    assert at == 1 and abs(ratio - 1.0) < 1e-12


def test_tall_gram_seed_tool_exits_nonzero_without_gpu(monkeypatch,
                                                       capsys):
    from flashpca_tpu_torch.tools import tall_gram_seeds as tgs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tgs.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_tall_gram_f64_tool_takes_the_card_tests_cases_on_the_cpu(
        monkeypatch, capsys):
    """tools/tall_gram_f64.py reads the card test's cases (its
    parametrize values), its norm reading on the CPU (the plain gram)
    sits inside the smoke's GRAM_F64_BAR, and it exits 1 without a
    GPU."""
    from flashpca_tpu_torch.tools import tall_gram_f64 as tgf

    spec = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(ROOT, "tests", "test_torch_cuda.py"))
    card = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card)
    params = {m.args[0]: m.args[1] for m in
              card.test_tall_kernels_match_plain.pytestmark
              if m.name == "parametrize"}
    assert set(tgf.CASES) == {(p, n, k) for p, n in params["p,n"]
                              for k in params["k"]}
    r = tgf.readings(torch.device("cpu"), 133, 771, 5)
    assert 0.0 < r["norm_rel"] < 1.5e-7
    assert 0.0 < r["entry_of_column_max"] < 1e-6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tgf.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
