"""The kernel build table, B1's and B5's comparison entries and
chip_smoke.py's tables, on the CPU.

The CUDA sources compile only on a machine with ``nvcc`` and a card, so
what runs here is what surrounds them: every entry of
``_build.KERNELS`` names a source that exists and a C function of that
source whose parameter count matches its ctypes argument list; the
build directory's hash moves with every source; every entry has a
launch count; production B1's and B5's libraries hold no comparison
entry; B1's and B5's comparison wrappers exist and take the plain
versions on CPU tensors, bit for bit; and chip_smoke.py has the rows its timing phase reads and
parses the compiler's register report.
"""

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
    ("matvec_ff", "matvec_ff.cu", "fp_matvec_ff"),
    ("crossprod", "crossprod_v2.cu", "fp_crossprod"),
    ("crossprod_v1", "crossprod.cu", "fp_crossprod_v1"),
    ("crossprod_tiled", "crossprod.cu", "fp_crossprod_tiled"),
])
def test_b5_entries_map_to_their_sources(name, src, entry):
    """B5's and (since its redesign) B1's entries: production in the new
    source, the first design and the sweep's tile entry in the old one."""
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
    assert len(_build.sources()) == 9 and len(_build.KERNELS) == 15


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
    for comparison in (tpk.NOVL_KERNELS, tpk.B1_KERNELS):
        assert set(comparison) <= set(tpk.launch_counts)
        assert not set(comparison) & set(tpk.OPERATOR_KERNELS)
    assert tpk.B1_KERNELS == ("crossprod_v1",)


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


@pytest.mark.parametrize("name", ("crossprod",) + tpk.B1_KERNELS)
def test_chip_smoke_has_rows_for_b1_and_its_first_design(name):
    """The rows chip_smoke's timing phase reads for B1 and its first
    design, so the phase cannot KeyError on the card."""
    cs = _chip_smoke()
    assert cs.SOURCE[name] == ("flashpca_tpu_torch/kernels/csrc/"
                               + _build.KERNELS[name][0])
    assert os.path.exists(os.path.join(ROOT, cs.SOURCE[name]))
    assert cs.TPU_KERNEL[name] == "flashpca_tpu/kernels/packed_matvec.py:83"
    assert cs.DOTS[name] == 1


def test_chip_smoke_names_b1s_instantiations():
    cs = _chip_smoke()
    sym = ("_ZN45_GLOBAL__N__9a1b2c3d_15_crossprod_v2_cu_1f2e3d4c2v2"
           "21crossprod_tile_kernelILi32EEEvPKhPKfS5_S5_S5_Pfxxbb")
    assert cs.kernel_name(sym) == "crossprod_tile_kernel<32>"


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
