"""Kernel sweep on one GPU: B1 and B2 across their tile sizes, B1 across
panel widths, and B1's four measurement variants V1-V4, timed at a
biobank shape.

    python -m flashpca_tpu_torch.tools.kernel_sweep [p] [nbytes] [k]

Defaults 100,352 SNPs x 125,440 bytes (501,760 samples), k = 16: the wide
headline.  The steps, in this order:

1. correctness: each variant (kernels/crossprod_variants.py), and their
   first designs, against B1 on a 512-SNP slice at the full width, as a
   relative norm;
2. the tile sweep: B1 at 128/256/512 rows per block beside B2 at 32/64/
   128 SNP rows per chunk (ms and packed GB/s);
3. the k-scan: B1 at k in {8, 16, 32, 64};
4. V1-V4 against their first designs at the full shape, bit for bit
   (``torch.equal``);
5. B1, the four variants and their first designs timed at the full shape
   in turns, each printed beside B1 with the difference; for V4, B1's
   time less V4's is what the TwoSum compensation costs B1, and for V2,
   V2's less B1's what the integer-shifted decode costs it.

V1, V2 and V4 are built on B1's own design (crossprod_variants_v2.cu), so
each differs from B1 in the one thing it isolates, and V3 on a
tensor-core design of its own (crossprod_split3_v2.cu); their first
designs are timed for comparison and labelled so.
Times are the median of CUDA-event times after one warm-up run (in
step 5, the mean of two such medians: every kernel once in order, then
once in reverse).  The
packed bytes are random, drawn on the card from a ``torch.Generator``
seeded 0; ``mean``, ``invsd`` and the panels come from numpy's
``default_rng(0)`` in the order of the JAX sweep
(.claude/skills/verify/kernel_sweep.py).  Any p and nbytes work: the
kernels mask ragged edges.  The steps are functions of a device, so the
CPU tests can run the correctness and bit-equality steps on the plain
versions; the timed steps and ``main`` need a GPU and refuse the CPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..kernels import crossprod_variants as cv
from ..kernels import packed_matvec as tpk

DEFAULTS = (100_352, 125_440, 16)
K_SCAN = (8, 16, 32, 64)
CHECK_ROWS = 512
# the printed name of each kernel the sweep times
LABELS = {"crossprod": "B1",
          "crossprod_stacked": "V1 stacked",
          "crossprod_stacked_v1": "V1 stacked, first design",
          "crossprod_intsub": "V2 intsub",
          "crossprod_intsub_v1": "V2 intsub, first design",
          "crossprod_nocomp": "V4 nocomp",
          "crossprod_nocomp_v1": "V4 nocomp, first design",
          "crossprod_split3": "V3 split3",
          "crossprod_split3_v1": "V3 split3, first design"}


def say(msg: str) -> None:
    print(msg, flush=True)


def sweep_data(p, nbytes, k, device):
    """The sweep's operands on ``device``: packed (p, nbytes) uint8, mean
    and invsd (p,) float32, the permuted panel xp (4 nbytes, k), the SNP
    panel v (p, k), and the numpy generator for the k-scan's panels."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(0)
    packed = torch.randint(0, 256, (p, nbytes), generator=g,
                           dtype=torch.uint8, device=device)
    rng = np.random.default_rng(0)
    mean = rng.uniform(0.1, 1.9, p).astype(np.float32)
    invsd = rng.uniform(0.5, 2.0, p).astype(np.float32)
    xt = rng.standard_normal((4, k, nbytes)).astype(np.float32)
    vt = rng.standard_normal((k, p)).astype(np.float32)
    return {"packed": packed,
            "mean": torch.as_tensor(mean, device=device),
            "invsd": torch.as_tensor(invsd, device=device),
            "xp": planes_to_permuted(xt, device),
            "v": torch.as_tensor(np.ascontiguousarray(vt.T), device=device),
            "rng": rng}


def planes_to_permuted(xt, device):
    """(4, k, nbytes) plane-major panel (the JAX kernels' xt) -> the
    permuted (4 nbytes, k) panel: row s*nbytes + b holds sample 4b + s."""
    k = xt.shape[1]
    return torch.as_tensor(
        np.ascontiguousarray(xt.transpose(0, 2, 1).reshape(-1, k)),
        device=device)


def _variants():
    """{name: wrapper} of V1-V4, each followed by its first design: the
    sweep's order."""
    out = {}
    for name, (wrapper, _) in cv.VARIANTS.items():
        out[name] = wrapper
        if name + "_v1" in cv.FIRST_DESIGNS:
            out[name + "_v1"] = cv.FIRST_DESIGNS[name + "_v1"][0]
    return out


def correctness(data, rows=CHECK_ROWS):
    """{variant or first design: ||z - z_B1|| / ||z_B1||} on the first
    ``rows`` SNPs at the full width (plain versions on the CPU)."""
    pk = data["packed"][:rows]
    m, iv = data["mean"][:rows], data["invsd"][:rows]
    xp = data["xp"]
    ref = tpk.crossprod_p(pk, m, iv, xp).double()
    out = {}
    for name, wrapper in _variants().items():
        z = wrapper(pk, m, iv, xp).double()
        out[name] = float((z - ref).norm() / ref.norm())
        say(f"{LABELS[name]:24s} correctness vs B1 rel={out[name]:.2e}")
    return out


def first_designs_equal(data):
    """{first design: its redesign's z is its z bit for bit} at the full
    shape (``torch.equal``)."""
    pk, m, iv, xp = (data[key] for key in ("packed", "mean", "invsd", "xp"))
    out = {}
    for first, (wrapper, _) in cv.FIRST_DESIGNS.items():
        redesign = first.removesuffix("_v1")
        z = cv.VARIANTS[redesign][0](pk, m, iv, xp)
        out[first] = bool(torch.equal(z, wrapper(pk, m, iv, xp)))
        say(f"{LABELS[redesign]} bit-equal to its first design at the full "
            f"shape: {out[first]}")
        del z
    return out


def event_ms(fn, reps):
    """Median device time of ``fn()`` over ``reps`` runs (ms), after one
    warm-up run; needs a GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_sweep: timing needs a CUDA device")
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


def _gbs(data, ms):
    return data["packed"].numel() / 1e9 / (ms / 1e3)


def tile_sweep(data, reps=5):
    """B1 at each TILE_TM beside B2 at each TILE_CR (paired in order, as
    the JAX sweep's tile_p moved both kernels' SNP tile)."""
    pk, m, iv = data["packed"], data["mean"], data["invsd"]
    rows = []
    for tm, cr in zip(cv.TILE_TM, cv.TILE_CR):
        c_ms = event_ms(lambda: cv.crossprod_tiled_p(pk, m, iv, data["xp"],
                                                     tm), reps)
        m_ms = event_ms(lambda: cv.matvec_tiled_p(pk, m, iv, data["v"], cr),
                        reps)
        rows.append({"tm": tm, "crossprod_ms": c_ms,
                     "crossprod_gbs": _gbs(data, c_ms), "cr": cr,
                     "matvec_ms": m_ms, "matvec_gbs": _gbs(data, m_ms)})
        say(f"tile tm={tm:3d}: crossprod {c_ms:7.2f} ms "
            f"({_gbs(data, c_ms):5.1f} GB/s)  cr={cr:3d}: matvec "
            f"{m_ms:7.2f} ms ({_gbs(data, m_ms):5.1f} GB/s)")
    return rows


def k_scan(data, ks=K_SCAN, reps=5):
    """B1 (production) at each panel width in ``ks``; the panels are
    drawn from the sweep's generator after its own."""
    pk, m, iv = data["packed"], data["mean"], data["invsd"]
    rows = []
    for kk in ks:
        xt = data["rng"].standard_normal(
            (4, kk, pk.shape[1])).astype(np.float32)
        xp = planes_to_permuted(xt, pk.device)
        ms = event_ms(lambda: tpk.crossprod_p(pk, m, iv, xp), reps)
        rows.append({"k": kk, "ms": ms, "gbs": _gbs(data, ms)})
        say(f"k-scan k={kk:3d}: crossprod {ms:7.2f} ms "
            f"({_gbs(data, ms):5.1f} GB/s)")
        del xp
    return rows


def time_variants(data, reps=5):
    """B1, V1-V4 and their first designs at the full shape, timed
    in turns (each once in order, then once in reverse); returns {"ms":
    {kernel: mean of its two medians}, "turns": {kernel: [ms, ms]},
    "minus_b1_ms": {kernel: its ms less B1's}, "compensation_ms": B1's ms
    less V4's}."""
    pk, m, iv, xp = data["packed"], data["mean"], data["invsd"], data["xp"]
    fns = {"crossprod": lambda: tpk.crossprod_p(pk, m, iv, xp)}
    for name, wrapper in _variants().items():
        fns[name] = lambda w=wrapper: w(pk, m, iv, xp)
    turns = {}
    for name in list(fns) + list(fns)[::-1]:
        turns.setdefault(name, []).append(event_ms(fns[name], reps))
    ms = {name: float(np.mean(ts)) for name, ts in turns.items()}
    b1 = ms["crossprod"]
    for name, t in ms.items():
        say(f"{LABELS[name]:24s}: crossprod {t:7.2f} ms "
            f"({_gbs(data, t):5.1f} GB/s; turns "
            + ", ".join(f"{x:.2f}" for x in turns[name]) + ")"
            + ("" if name == "crossprod" else
               f"; B1 {b1:.2f} ms, difference {t - b1:+.2f} ms"))
    comp = b1 - ms["crossprod_nocomp"]
    say(f"B1 - V4 nocomp = {comp:+.2f} ms: what the compensation costs B1 "
        f"({comp / b1:+.1%} of B1)")
    return {"ms": ms, "turns": turns,
            "minus_b1_ms": {name: t - b1 for name, t in ms.items()
                            if name != "crossprod"},
            "compensation_ms": comp}


def run(p, nbytes, k, device, reps=5):
    """All five steps on ``device`` (a GPU); returns (their readings,
    the sweep's operands)."""
    say(f"sweep: p={p} nbytes={nbytes} k={k} packed "
        f"{p * nbytes / 1e9:.2f} GB on {torch.cuda.get_device_name(device)}")
    data = sweep_data(p, nbytes, k, device)
    out = {"p": p, "nbytes": nbytes, "k": k,
           "correctness": correctness(data),
           "tiles": tile_sweep(data, reps),
           "k_scan": k_scan(data, reps=reps),
           "first_designs_equal": first_designs_equal(data),
           "variants": time_variants(data, reps)}
    return out, data


def main(argv=None) -> int:
    args = [int(a) for a in (sys.argv[1:] if argv is None else argv)]
    p, nbytes, k = (args + list(DEFAULTS)[len(args):])[:3]
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device; the sweep times the kernels on "
              "a GPU only", file=sys.stderr)
        return 1
    out, _ = run(p, nbytes, k, torch.device("cuda"))
    return 0 if all(out["first_designs_equal"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
