"""B2's thread tiles on one GPU: production B2 (matvec_v2.cu), its first
design and the same source built at other tiles, timed in turns on the
same inputs at the main paths' shapes.

    python -m flashpca_tpu_torch.tools.b2_tiles [--out FILE]

A tile is (C columns a thread, TB bytes a block, TPS threads an SM that
``__launch_bounds__`` asks for, EREG: err in registers (1) or in shared
memory beside the running sum (0)) at one KC; each one tried is one
more ``nvcc`` (all started together, through ``b3_tiles.build_tiles``)
of a two-line source that defines ``MATVEC_TILE_<KC>`` as ``C, TB, TPS,
EREG`` and includes matvec_v2.cu, with its registers and spills
(``-Xptxas -v``).  Every tile must give the first design's sums bit for
bit (``torch.equal``).  The shapes are the wide headline's (100,352 SNPs
x 125,440 bytes) at kc 16 and 24 and the tall one's (50,176 x 250,880)
at kc 16, 24 and 32, with random bytes and coefficients (the kernels'
time does not depend on the values).  Times are medians of CUDA-event
times after a warm-up, each tile timed once in order and once in
reverse.  A tile that does not build is reported and skipped.  The tool
needs a GPU and exits 1 without one, or when a tile is not bit-equal.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import torch

from ..kernels import _build
from ..kernels import packed_matvec as tpk
from . import b3_tiles
from .b3_tiles import build_tiles, event_ms, say

SOURCE, KERNEL = "matvec_v2.cu", "matvec_tile_kernel"
MACRO, ENTRY = "MATVEC_TILE", "fp_matvec"
# the tiles tried beside production's, by KC: (C, TB, TPS, EREG)
TILES = {
    16: [(8, 64, 640, 1), (8, 64, 768, 1), (8, 64, 512, 0),
         (8, 128, 512, 1), (16, 64, 384, 1), (16, 64, 256, 0)],
    24: [(8, 64, 576, 1), (8, 64, 768, 1), (12, 64, 384, 0),
         (12, 64, 512, 1), (12, 128, 512, 1)],
    32: [(8, 64, 512, 1), (8, 64, 768, 1), (8, 64, 512, 0),
         (16, 64, 256, 0)],
}
# (label, SNPs, packed bytes, kc): the main paths' B2 launches
SHAPES = (("wide", 100_352, 125_440, 16), ("wide", 100_352, 125_440, 24),
          ("tall", 50_176, 250_880, 16), ("tall", 50_176, 250_880, 24),
          ("tall", 50_176, 250_880, 32))
CR, SMS = 64, 132
SMEM_SM, SMEM_BLOCK_RESERVED = 233_472, 1024     # H100: 228 KB an SM


def production_tiles():
    """{KC: (C, TB, TPS, EREG)} of the production build, read from the
    source's defaults."""
    return b3_tiles.production_tiles(SOURCE, MACRO)


def occupancy(kc, tile, regs):
    """(threads a block, dynamic shared bytes, blocks an SM) of ``tile``
    at ``kc`` with ``regs`` registers a thread: the least of the blocks
    that threads, registers and shared memory allow."""
    c, tb, _, ereg = tile
    nt = tb * (kc // c)
    stage = CR * tb + CR * kc * 4 + CR * 16
    smem = 2 * stage + (1 if ereg else 2) * 4 * c * nt * 4
    by_regs = 65_536 // (nt * (-(-regs // 8) * 8))
    by_smem = SMEM_SM // (smem + SMEM_BLOCK_RESERVED)
    return nt, smem, min(2048 // nt, by_regs, by_smem, 32)


def reg_cap(kc, tile):
    """The registers a thread that ``__launch_bounds__`` leaves ``tile``
    (TPS / threads a block blocks an SM; a multiple of 8, at most 255)."""
    c, tb, tps, _ = tile
    nt = tb * (kc // c)
    return min(255, 65_536 // (nt * max(1, tps // nt)) // 8 * 8)


def waves(kc, tile, regs, nbytes):
    """Blocks of a launch over ``nbytes`` packed bytes per (132 SMs x
    blocks an SM)."""
    blocks = -(-nbytes // tile[1])
    return blocks / (SMS * occupancy(kc, tile, regs)[2])


def launcher(fn, packed, coeffs, v, kc):
    """A thunk launching ``fn`` (a ctypes B2 entry) at ``kc``; returns
    y."""
    p, nb = packed.shape

    def run():
        y = torch.empty((4 * nb, kc), dtype=torch.float32,
                        device=packed.device)
        rc = fn(packed.data_ptr(), *(c.data_ptr() for c in coeffs),
                v.data_ptr(), y.data_ptr(), p, nb, kc,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"matvec tile launch failed: {rc}")
        return y
    return run


def run(device, reps=3):
    """Build, check and time every tile; return the readings (each
    row's ``bit_equal``: equal to the first design's)."""
    prod = production_tiles()
    with open(os.path.join(_build.build_all(),
                           SOURCE.replace(".cu", ".log"))) as fh:
        prod_usage = dict(_build.ptxas_usage(fh))
    libs = build_tiles([(kc, t) for kc, ts in TILES.items() for t in ts],
                       SOURCE, MACRO, ENTRY, KERNEL, "matvec")
    rows = []
    data = None
    for label, p, nb, kc in SHAPES:
        if data is None or data[0].shape != (p, nb):
            data = None
            torch.cuda.empty_cache()
            g = torch.Generator(device=device).manual_seed(5)
            packed = torch.randint(0, 256, (p, nb), generator=g,
                                   dtype=torch.uint8, device=device)
            mean = 0.1 + 1.8 * torch.rand(p, generator=g, device=device)
            invsd = 0.5 + 1.5 * torch.rand(p, generator=g, device=device)
            data = (packed, mean, invsd, tpk.coeff_rows(mean, invsd))
        packed, mean, invsd, coeffs = data
        g = torch.Generator(device=device).manual_seed(6 + kc)
        v = torch.randn((p, kc), generator=g, device=device)
        fns = {"production " + str(prod[kc]):
               lambda: tpk.matvec_p(packed, mean, invsd, v),
               "first design": lambda: tpk.matvec_v1_p(packed, mean, invsd,
                                                       v)}
        for tile in TILES[kc]:
            if (kc, tile) in libs:
                fns[str(tile)] = launcher(libs[kc, tile][0], packed, coeffs,
                                          v, kc)
        want = fns["first design"]()
        equal = {}
        for name, fn in fns.items():
            got = fn()
            equal[name] = torch.equal(got, want)
            del got
        del want
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
                tile = tuple(int(t) for t in name.strip("()").split(","))
                usage = libs[kc, tile][1]
            occ = ""
            m = re.search(r"Used (\d+) registers", usage)
            if m:
                regs = int(m.group(1))
                nt, smem, blocks = occupancy(kc, tile, regs)
                occ = (f"; {nt} threads, {smem // 1024} KB, {blocks} "
                       f"blocks/SM, {waves(kc, tile, regs, nb):.2f} waves")
            say(f"   {label} kc={kc} {name:28s} "
                + ", ".join(f"{t:.2f}" for t in ts) + f" ms{occ}"
                + (f" ({usage})" if usage else "")
                + ("" if equal[name] else "; NOT bit-equal to the first "
                   "design"))
            rows.append({"shape": label, "p": p, "nbytes": nb, "kc": kc,
                         "tile": name, "ms": ts, "ptxas": usage,
                         "bit_equal": equal[name]})
        del v
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the readings to this JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("b2_tiles: no CUDA device; the tile trials run on a GPU only",
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
