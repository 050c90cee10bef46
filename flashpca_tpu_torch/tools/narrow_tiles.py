"""B1 and B2 at one column on one GPU: the one-column kernels
(crossprod_narrow.cu, matvec_narrow.cu) beside B1 and B2 at kc 8 on the
zero-padded column, the path a one-column product took before them, and
the one-column sources built at other tiles, timed in turns on the same
inputs at the one-column products' shapes.

    python -m flashpca_tpu_torch.tools.narrow_tiles [--out FILE]

The shapes: the wide cell's 100,352 SNPs x 125,440 bytes (a solo SCCA
fit's products), a streamed wide block (8,559 SNPs), the tall cell's
100,352 x 250,880 (``TallPackedOperator``'s vector products) and a
streamed tall block (50,176 x 21,396 bytes, nb % 16 != 0: 4-byte
staging), with random bytes, coefficients and columns and a row of
missing calls in every 97 (the kernels' time does not depend on the
values). "production" is the wrappers' one-column chunk
(``_crossprod_chunk`` / ``_matvec_chunk`` at KC 1: the one-column
kernel), "first design" the same helper at kc 8 on the padded column
(its column 0; the padded copy and the coefficient rows made once,
untimed), which every tile must give bit for bit (``torch.equal``).
A tile is (R rows a lane, NW warps, TPS) for B1 and (G bytes a lane, NW
warps, TPS) for B2; each is one more ``nvcc`` of a two-line source that
defines ``<MACRO>_1`` and includes the production source. The build, the
check, the timing and the command line are ``b3_tiles.run_tiles`` and
``b3_tiles.tool_main``. The tool needs a GPU and exits 1 without one, or
when a kernel is not bit-equal.
"""

from __future__ import annotations

import sys
import types

import torch

from ..kernels import packed_matvec as tpk
from . import b2_tiles, b3_tiles

# the tiles tried beside production's: B1 (R, NW, TPS), B2 (G, NW, TPS)
CROSSPROD = ("crossprod_narrow", "CROSSPROD_NARROW_TILE",
             "crossprod_narrow_kernel")
CROSSPROD_TILES = {1: [(1, 4, 1024), (1, 2, 1024), (2, 2, 1024),
                       (2, 4, 768), (3, 4, 512)]}
MATVEC = ("matvec_narrow", "MATVEC_NARROW_TILE", "matvec_narrow_kernel")
MATVEC_TILES = {1: [(2, 2, 640), (4, 2, 384), (1, 4, 1024), (2, 8, 1024)]}
# (label, SNPs, packed bytes, kc)
SHAPES = (("wide", 100_352, 125_440, 1),
          ("streamed block", 8_559, 125_440, 1),
          ("tall", 100_352, 250_880, 1),
          ("streamed tall block", 50_176, 21_396, 1))
B1_BSTRIDE, B1_TABLE, CB = 48, 2048, 32      # crossprod_narrow.cu's b1n
B2_CR, B2_TW = 64, 16                        # matvec_narrow.cu's mvn

# ``run_tiles``' production (``<name>_p``) and first design
# (``<name>_v1_p``) of each kernel, on (packed, coefficient rows, column,
# padded column)
WRAPPERS = types.SimpleNamespace(
    crossprod_narrow_p=lambda pk, cf, x, x8:
        tpk._crossprod_chunk("crossprod", pk, cf, x, 0, 1, 1),
    crossprod_narrow_v1_p=lambda pk, cf, x, x8:
        tpk._crossprod_chunk("crossprod", pk, cf, x8, 0, 8, 8)[:, :1],
    matvec_narrow_p=lambda pk, cf, v, v8:
        tpk._matvec_chunk("matvec", pk, cf, v, 0, 1, 1),
    matvec_narrow_v1_p=lambda pk, cf, v, v8:
        tpk._matvec_chunk("matvec", pk, cf, v8, 0, 8, 8)[:, :1])


def data(device, p, nb):
    """B2's tile tool's bytes, every 97th row missing calls, and the
    coefficient rows of its means and inverse sds."""
    packed, mean, invsd = b2_tiles.data(device, p, nb)
    packed[::97] = 0x55
    return packed, tpk.coeff_rows(mean, invsd)


def crossprod_panel(device, p, nb, kc):
    """B1's column x (n4, 1) and its zero-padded (n4, 8) copy."""
    g = torch.Generator(device=device).manual_seed(6)
    x = torch.randn((4 * nb, 1), generator=g, device=device)
    return x, tpk._padded(x, 0, 1, 8)


def matvec_panel(device, p, nb, kc):
    """B2's column v (p, 1) and its zero-padded (p, 8) copy."""
    g = torch.Generator(device=device).manual_seed(7)
    v = torch.randn((p, 1), generator=g, device=device)
    return v, tpk._padded(v, 0, 1, 8)


def launcher(kind):
    """The thunk maker of a tile of ``kind`` (B1 "crossprod" or B2
    "matvec"): ``fn`` (its ctypes entry) on the column; returns (rows,
    1)."""
    def make(fn, packed, coeffs, col, pad, kc):
        p, nb = packed.shape
        rows = p if kind == "crossprod" else 4 * nb

        def run():
            out = torch.empty((rows, 1), dtype=torch.float32,
                              device=packed.device)
            rc = fn(packed.data_ptr(), *(c.data_ptr() for c in coeffs),
                    col.data_ptr(), out.data_ptr(), p, nb, 1,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{kind} narrow tile launch failed: {rc}")
            return out
        return run
    return make


def crossprod_occupancy(kc, tile, regs):
    """(threads a block, dynamic shared bytes, blocks an SM) of B1's
    one-column ``tile`` (R, NW, TPS): R * NW row tables of 2 KB, then two
    stages of TM = 32 R NW rows of a 32-byte chunk (48-byte rows) and
    4 x 32 floats of x."""
    r, nw, _ = tile
    nt, tm = 32 * nw, 32 * r * nw
    smem = r * nw * B1_TABLE + 2 * (tm * B1_BSTRIDE + 4 * CB * 4)
    return nt, smem, b3_tiles.blocks_an_sm(nt, smem, regs)


def crossprod_grid(tile, p, nb):
    """Blocks of a one-column B1 launch: one per 32 R NW rows."""
    return -(-p // (32 * tile[0] * tile[1]))


def matvec_occupancy(kc, tile, regs):
    """(threads a block, dynamic shared bytes, blocks an SM) of B2's
    one-column ``tile`` (G, NW, TPS): two stages of a 64-row chunk's
    tables (16 floats a row) and its TB = 32 G NW bytes a row."""
    g, nw, _ = tile
    nt, tb = 32 * nw, 32 * g * nw
    smem = 2 * (B2_CR * B2_TW * 4 + B2_CR * tb)
    return nt, smem, b3_tiles.blocks_an_sm(nt, smem, regs)


def matvec_grid(tile, p, nb):
    """Blocks of a one-column B2 launch: one per 32 G NW bytes."""
    return -(-nb // (32 * tile[0] * tile[1]))


def trials():
    """The two runs of ``b3_tiles.run_tiles``: B1's tiles, then B2's."""
    common = {"shapes": SHAPES, "data": data, "module": WRAPPERS}
    return [dict(common, name=name, macro=macro, kernel=kernel, tiles=tiles,
                 panel=panel, launcher=launcher(kind), occupancy=occupancy,
                 grid=grid)
            for kind, (name, macro, kernel), tiles, panel, occupancy, grid in (
                ("crossprod", CROSSPROD, CROSSPROD_TILES, crossprod_panel,
                 crossprod_occupancy, crossprod_grid),
                ("matvec", MATVEC, MATVEC_TILES, matvec_panel,
                 matvec_occupancy, matvec_grid))]


def main(argv=None) -> int:
    return b3_tiles.tool_main(argv, __doc__, "narrow_tiles", runs=trials())


if __name__ == "__main__":
    sys.exit(main())
