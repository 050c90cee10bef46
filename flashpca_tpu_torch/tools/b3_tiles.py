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

SOURCE, KERNEL = "crossprod_ff_v2.cu", "crossprod_ff_tile_kernel"
MACRO, ENTRY = "CROSSPROD_FF_TILE", "fp_crossprod_ff"
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
TM, CB = 128, 32
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


def occupancy(kc, tile, regs):
    """(threads a block, dynamic shared bytes, blocks an SM) of ``tile``
    at ``kc`` with ``regs`` registers a thread: the least of the blocks
    that threads, registers and shared memory allow."""
    r, c, _ = tile
    nt = TM // r * (kc // c)
    smem = 2 * (TM * CB + 4 * CB * kc * 4) + 2 * TM * kc * 4
    by_regs = 65_536 // (nt * (-(-regs // 8) * 8))
    by_smem = SMEM_SM // (smem + SMEM_BLOCK_RESERVED)
    return nt, smem, min(2048 // nt, by_regs, by_smem, 32)


def build_tiles(tiles, source=SOURCE, macro=MACRO, entry=ENTRY,
                kernel=KERNEL, name="crossprod_ff"):
    """Compile one library per (kc, tile) of ``source`` (by default
    B3's), all ``nvcc`` together; return {(kc, tile): (ctypes entry
    ``entry`` with the argument types of ``_build.KERNELS[name]``, "Used
    N registers ..." of ``kernel`` at that kc)} of the tiles that
    built."""
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
        fn.argtypes = _build.KERNELS[name][2]
        fn.restype = ctypes.c_int
        with open(log) as fh:
            usage = dict(_build.ptxas_usage(fh))
        out[kc, tile] = (fn, usage.get(f"{kernel}<{kc}>", "?"))
    return out


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


def run(device, reps=3):
    """Build, check and time every tile; return the readings (each
    row's ``bit_equal``: both halves equal to the first design's)."""
    prod = production_tiles()
    with open(os.path.join(_build.build_all(),
                           SOURCE.replace(".cu", ".log"))) as fh:
        prod_usage = dict(_build.ptxas_usage(fh))
    libs = build_tiles([(kc, t) for kc, ts in TILES.items() for t in ts])
    rows = []
    data = None
    for label, p, nb, kc in SHAPES:
        if data is None or data[0].shape != (p, nb):
            data = None
            torch.cuda.empty_cache()
            g = torch.Generator(device=device).manual_seed(5)
            data = (torch.randint(0, 256, (p, nb), generator=g,
                                  dtype=torch.uint8, device=device),
                    tpk.lut_rows(
                        torch.randn((p, 4), generator=g, device=device),
                        torch.randn((p, 4), generator=g, device=device)
                        * 1e-8))
        packed, lut6 = data
        g = torch.Generator(device=device).manual_seed(6 + kc)
        x = torch.randn((4 * nb, kc), generator=g, device=device)
        fns = {"production " + str(prod[kc]):
               lambda: tpk.crossprod_ff_p(packed, lut6, x),
               "first design": lambda: tpk.crossprod_ff_v1_p(packed, lut6,
                                                            x)}
        for tile in TILES[kc]:
            if (kc, tile) in libs:
                fns[str(tile)] = launcher(libs[kc, tile][0], packed, lut6, x,
                                          kc)
        want = fns["first design"]()
        equal = {}
        for name, fn in fns.items():
            got = fn()
            equal[name] = (torch.equal(got[0], want[0])
                           and torch.equal(got[1], want[1]))
            del got
        times = {}
        for name in list(fns) + list(fns)[::-1]:
            times.setdefault(name, []).append(event_ms(fns[name], reps))
        for name, ts in times.items():
            if name == "first design":
                tile, usage = None, ""
            elif name.startswith("production"):
                tile, usage = prod[kc], prod_usage.get(f"{KERNEL}<{kc}>",
                                                       "?")
            else:
                tile = tuple(int(v) for v in name.strip("()").split(","))
                usage = libs[kc, tile][1]
            occ = ""
            m = re.search(r"Used (\d+) registers", usage)
            if m:
                nt, smem, blocks = occupancy(kc, tile, int(m.group(1)))
                occ = (f"; {nt} threads, {smem // 1024} KB, {blocks} "
                       f"blocks/SM")
            say(f"   {label} kc={kc} {name:26s} "
                + ", ".join(f"{t:.2f}" for t in ts) + f" ms{occ}"
                + (f" ({usage})" if usage else "")
                + ("" if equal[name] else "; NOT bit-equal to the first "
                   "design"))
            rows.append({"shape": label, "p": p, "nbytes": nb, "kc": kc,
                         "tile": name, "ms": ts, "ptxas": usage,
                         "bit_equal": equal[name]})
        del x
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the readings to this JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("b3_tiles: no CUDA device; the tile trials run on a GPU only",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(smi)
    rows = run(torch.device("cuda"))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "rows": rows}, fh, indent=1)
    return 0 if all(r["bit_equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
