"""B3's thread tiles on one GPU: production B3 (crossprod_ff_v2.cu),
its first design and the same source built at other tiles, timed in
turns on the same inputs at the main paths' shapes.

    python -m flashpca_tpu_torch.tools.b3_tiles [--out FILE]

A tile is (R rows, C columns a thread, TPS threads an SM that
``__launch_bounds__`` asks for) at one KC; each one tried is one more
``nvcc`` (all started together) of a two-line source in
``kernels/build/tiles/`` that defines ``CROSSPROD_FF_TILE_<KC>`` as ``R,
C, TPS`` and includes crossprod_ff_v2.cu (nvcc would split a ``-D``
value at its commas), with its registers and spills (``-Xptxas -v``).
Every tile must give the first design's sums bit for bit
(``torch.equal`` of both halves).  The shapes are the wide headline's
(100,352 SNPs x 125,440 bytes) at kc=24 and the tall one's (50,176 x
250,880) at kc 24 and 32,
with random bytes and tables (the kernels' time does not depend on the
values).  Times are medians of CUDA-event times after a warm-up, each
tile timed once in order and once in reverse.  A tile that does not
build is reported and skipped.  The tool needs a GPU and exits 1
without one, or when a tile is not bit-equal.

The build, the check, the timing and the command line
(:func:`build_tiles`, :func:`run_tiles`, :func:`tool_main`) serve B2's,
B4's and V1/V3/V4's tile tools too, as do the occupancy counts of the W^T
tiles (:func:`reg_cap`, :func:`wt_occupancy`, :func:`wt_grid`,
:func:`waves`).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from ..kernels import _build
from ..kernels import packed_matvec as tpk

NAME, KERNEL = "crossprod_ff", "crossprod_ff_tile_kernel"
SOURCE, MACRO = "crossprod_ff_v2.cu", "CROSSPROD_FF_TILE"
# the tiles tried beside production's, by KC: (R, C, TPS)
TILES = {
    24: [(1, 12, 512), (1, 8, 768), (2, 8, 768), (2, 12, 384),
         (1, 24, 384)],
    32: [(1, 16, 768), (2, 8, 768), (2, 16, 384), (1, 32, 384),
         (1, 8, 1024)],
}
# (label, SNPs, packed bytes, kc): the main paths' B3 launches
SHAPES = (("wide", 100_352, 125_440, 24), ("tall", 50_176, 250_880, 24),
          ("tall", 50_176, 250_880, 32))
TM, CB, SMS = 128, 32, 132
SMEM_SM, SMEM_BLOCK_RESERVED = 233_472, 1024     # H100: 228 KB an SM


def say(msg: str) -> None:
    print(msg, flush=True)


def production_tiles(source=SOURCE, macro=MACRO):
    """{KC: tile} of the production build of ``source``, read from its
    defaults of ``<macro>_<KC>`` (B3's: (R, C, TPS))."""
    with open(os.path.join(_build.CSRC, source)) as fh:
        text = fh.read()
    return {int(kc): tuple(int(t) for t in vals.split(", "))
            for kc, vals in re.findall(
                rf"#define {macro}_(\d+) (\d+(?:, \d+)*)\n", text)}


def tile_source(kc, tile, source=SOURCE, macro=MACRO):
    """The source of ``source`` (crossprod_ff_v2.cu) built with ``tile``
    at ``kc``."""
    return (f"#define {macro}_{kc} {', '.join(map(str, tile))}\n"
            f'#include "{os.path.join(_build.CSRC, source)}"\n')


def blocks_an_sm(nt, smem, regs):
    """Blocks of ``nt`` threads and ``smem`` dynamic shared bytes with
    ``regs`` registers a thread that one SM holds: the least that
    threads, registers and shared memory allow."""
    by_regs = 65_536 // (nt * (-(-regs // 8) * 8))
    by_smem = SMEM_SM // (smem + SMEM_BLOCK_RESERVED)
    return min(2048 // nt, by_regs, by_smem, 32)


def occupancy(kc, tile, regs):
    """(threads a block, dynamic shared bytes, blocks an SM) of B3's
    ``tile`` at ``kc`` with ``regs`` registers a thread."""
    r, c, _ = tile
    nt = TM // r * (kc // c)
    smem = 2 * (TM * CB + 4 * CB * kc * 4) + 2 * TM * kc * 4
    return nt, smem, blocks_an_sm(nt, smem, regs)


def grid(tile, p, nb):
    """Blocks of a B3 launch over ``p`` SNPs: one per 128 rows."""
    return -(-p // TM)


def waves(blocks, per_sm):
    """Waves of a launch of ``blocks`` blocks at ``per_sm`` blocks an SM
    (132 SMs)."""
    return blocks / (SMS * per_sm)


def reg_cap(kc, tile):
    """The registers a thread that ``__launch_bounds__`` leaves a W^T
    tile (C, TB, TPS, ...) of B2 or B4 (TPS / threads a block blocks an
    SM; a multiple of 8, at most 255)."""
    c, tb, tps = tile[:3]
    nt = tb * (kc // c)
    return min(255, 65_536 // (nt * max(1, tps // nt)) // 8 * 8)


def wt_occupancy(kc, tile, regs, stage_bytes):
    """(threads a block, dynamic shared bytes, blocks an SM) of a W^T
    tile (C columns, TB bytes, TPS, EREG, ...) of B2 or B4 at ``kc`` with
    ``regs`` registers a thread: two ``cp.async`` stages of
    ``stage_bytes(kc, tile)`` each, and the running sum of each thread's
    4 samples x C columns beside them (the err too when EREG is 0)."""
    c, tb, _, ereg = tile[:4]
    nt = tb * (kc // c)
    smem = 2 * stage_bytes(kc, tile) + (1 if ereg else 2) * 4 * c * nt * 4
    return nt, smem, blocks_an_sm(nt, smem, regs)


def wt_grid(tile, p, nb):
    """Blocks of a B2 or B4 launch over ``nb`` packed bytes: one per TB."""
    return -(-nb // tile[1])


def instantiation(kernel, kc):
    """The ptxas name of ``kernel`` at ``kc``: ``kernel<kc>``, or
    ``kernel`` formatted with kc where it names more template arguments
    (V3's ``split_tile_kernel<{kc}, 1>``)."""
    return kernel.format(kc=kc) if "{kc}" in kernel else f"{kernel}<{kc}>"


def build_tiles(tiles, name=NAME, macro=MACRO, kernel=KERNEL):
    """Compile one library per (kc, tile) of the production source of
    ``_build.KERNELS[name]`` (by default B3's), all ``nvcc`` together;
    return {(kc, tile): (ctypes entry with that entry's argument types,
    "Used N registers ..." of ``kernel`` at that kc)} of the tiles that
    built."""
    source, entry, argtypes = _build.KERNELS[name]
    nvcc = _build._nvcc()
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for fname in (source,) + _build.HEADERS:
        with open(os.path.join(_build.CSRC, fname), "rb") as fh:
            h.update(fh.read())
    out_dir = os.path.join(_build.BUILD_ROOT, "tiles", h.hexdigest()[:16])
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for kc, tile in tiles:
        tag = f"kc{kc}_" + "_".join(map(str, tile))
        lib = os.path.join(out_dir, f"lib_{tag}.so")
        log = os.path.join(out_dir, f"{tag}.log")
        if os.path.exists(lib):
            procs[kc, tile] = (lib, log, None)
            continue
        src = os.path.join(out_dir, f"{tag}.cu")
        with open(src, "w") as fh:
            fh.write(tile_source(kc, tile, source, macro))
        with open(log, "w") as fh:
            procs[kc, tile] = (lib, log, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-o", lib, src], stdout=fh,
                stderr=subprocess.STDOUT))
    out = {}
    for (kc, tile), (lib, log, proc) in procs.items():
        if proc is not None and proc.wait() != 0:
            with open(log) as fh:
                say(f"   kc={kc} tile {tile}: nvcc failed, not timed\n"
                    + fh.read()[-2000:])
            continue
        fn = getattr(ctypes.CDLL(lib), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        with open(log) as fh:
            usage = dict(_build.ptxas_usage(fh))
        out[kc, tile] = (fn, usage.get(instantiation(kernel, kc), "?"))
    return out


def table_data(device, p, nb):
    """The packed bytes and two-float code tables of a B3 or B4 shape
    (random: the kernels' time does not depend on the values)."""
    g = torch.Generator(device=device).manual_seed(5)
    return (torch.randint(0, 256, (p, nb), generator=g, dtype=torch.uint8,
                          device=device),
            tpk.lut_rows(torch.randn((p, 4), generator=g, device=device),
                         torch.randn((p, 4), generator=g, device=device)
                         * 1e-8))


def panel(device, p, nb, kc):
    """B3's x (4 nb, kc)."""
    g = torch.Generator(device=device).manual_seed(6 + kc)
    return (torch.randn((4 * nb, kc), generator=g, device=device),)


def launcher(fn, packed, lut6, x, kc):
    """A thunk launching ``fn`` (a ctypes B3 entry) at ``kc``; returns
    (zh, zl)."""
    p, nb = packed.shape

    def run():
        zh = torch.empty((p, kc), dtype=torch.float32, device=packed.device)
        zl = torch.empty_like(zh)
        rc = fn(packed.data_ptr(), lut6.data_ptr(), x.data_ptr(),
                zh.data_ptr(), zl.data_ptr(), p, nb, kc,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"crossprod_ff tile launch failed: {rc}")
        return zh, zl
    return run


def event_ms(fn, reps):
    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def _outputs(r):
    return r if isinstance(r, tuple) else (r,)


def run_tiles(device, name, macro, kernel, tiles, shapes, data, panel,
              launcher, occupancy, grid, reps=3, module=tpk):
    """Build, check and time the ``tiles`` ({KC: [tile]}) of
    ``_build.KERNELS[name]``'s source beside production
    (``<module>.<name>_p``, by default of kernels/packed_matvec.py) and
    its first design (``<module>.<name>_v1_p``) at each of ``shapes``
    ((label, SNPs, packed bytes, kc)); return the readings (each row's
    ``bit_equal``: every output equal to the first design's).

    The wrappers take ``data(device, p, nb)`` (made once for the shapes
    that share it) and then ``panel(device, p, nb, kc)``;
    ``launcher(fn, *data, *panel, kc)`` gives a thunk of a tile's ctypes
    entry ``fn``; ``occupancy(kc, tile, regs)`` is (threads a block,
    dynamic shared bytes, blocks an SM) and ``grid(tile, p, nb)`` a
    launch's blocks."""
    prod = production_tiles(_build.KERNELS[name][0], macro)
    with open(os.path.join(_build.build_all(), _build.KERNELS[name][0]
                           .replace(".cu", ".log"))) as fh:
        prod_usage = dict(_build.ptxas_usage(fh))
    libs = build_tiles([(kc, t) for kc, ts in tiles.items() for t in ts],
                       name, macro, kernel)
    production = getattr(module, name + "_p")
    first = getattr(module, name + "_v1_p")
    rows = []
    shared = None
    for label, p, nb, kc in shapes:
        if shared is None or shared[0].shape != (p, nb):
            shared = None
            torch.cuda.empty_cache()
            shared = data(device, p, nb)
        args = shared + panel(device, p, nb, kc)
        fns = {"production " + str(prod[kc]): lambda: production(*args),
               "first design": lambda: first(*args)}
        for tile in tiles[kc]:
            if (kc, tile) in libs:
                fns[str(tile)] = launcher(libs[kc, tile][0], *args, kc)
        want = _outputs(fns["first design"]())
        equal = {}
        for tag, fn in fns.items():
            got = _outputs(fn())
            equal[tag] = all(torch.equal(a, b) for a, b in zip(got, want))
            del got
        del want
        times = {}
        for tag in list(fns) + list(fns)[::-1]:
            times.setdefault(tag, []).append(event_ms(fns[tag], reps))
        for tag, ts in times.items():
            if tag == "first design":
                tile, usage = None, ""
            elif tag.startswith("production"):
                tile, usage = prod[kc], prod_usage.get(
                    instantiation(kernel, kc), "?")
            else:
                tile = tuple(int(t) for t in tag.strip("()").split(","))
                usage = libs[kc, tile][1]
            occ = ""
            m = re.search(r"Used (\d+) registers", usage)
            if m:
                nt, smem, blocks = occupancy(kc, tile, int(m.group(1)))
                occ = (f"; {nt} threads, {smem // 1024} KB, {blocks} "
                       f"blocks/SM, {waves(grid(tile, p, nb), blocks):.2f} "
                       f"waves")
            say(f"   {label} kc={kc} {tag:28s} "
                + ", ".join(f"{t:.2f}" for t in ts) + f" ms{occ}"
                + (f" ({usage})" if usage else "")
                + ("" if equal[tag] else "; NOT bit-equal to the first "
                   "design"))
            rows.append({"shape": label, "p": p, "nbytes": nb, "kc": kc,
                         "tile": tag, "ms": ts, "ptxas": usage,
                         "bit_equal": equal[tag]})
        del args, fns
    return rows


def tool_main(argv, doc, tool, runs=None, **trials):
    """The command line of a tile tool (``doc`` its module note, ``tool``
    its name, ``trials`` the arguments of :func:`run_tiles` after the
    device, or ``runs`` a list of such, run in turn): ``--out FILE``;
    exits 1 without a GPU or when a tile's row is not ``bit_equal``."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--out", help="also write the readings to this JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device; the tile trials run on a GPU only",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(smi)
    rows = [row for run in (runs or [trials])
            for row in run_tiles(torch.device("cuda"), **run)]
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "rows": rows}, fh, indent=1)
    return 0 if all(r["bit_equal"] for r in rows) else 1


def main(argv=None) -> int:
    return tool_main(argv, __doc__, "b3_tiles", name=NAME, macro=MACRO,
                     kernel=KERNEL, tiles=TILES, shapes=SHAPES,
                     data=table_data, panel=panel, launcher=launcher,
                     occupancy=occupancy, grid=grid)


if __name__ == "__main__":
    sys.exit(main())
