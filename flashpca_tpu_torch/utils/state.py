"""Atomic .npz state writes shared by the checkpoint surfaces.

The write is atomic (tmp file + rename) and safe under concurrent
identical writes: in a multi-host SPMD run every process saves the same
replicated state, so on a shared filesystem the last rename wins with
identical content, and on host-local disks every host gets its own copy
for restart.  The tmp name carries a random token, not just the pid:
two HOSTS sharing a filesystem can share a pid, and a pid-only name
would let their writes interleave into one corrupt tmp file.
"""

from __future__ import annotations

import os
import uuid

import numpy as np


def atomic_savez(path, **arrays) -> None:
    """np.savez(path, **arrays) with the tmp+rename discipline above.

    The tmp name keeps the .npz suffix so ``np.savez`` writes exactly
    that path (it appends .npz otherwise).
    """
    tmp = f"{path}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp.npz"
    try:
        np.savez(tmp, **arrays)
        # flush to stable storage BEFORE the rename: a crash after
        # os.replace but before the page cache lands would otherwise
        # swap the only good checkpoint for a truncated file
        with open(tmp, "rb+") as fh:
            os.fsync(fh.fileno())
        os.replace(tmp, str(path))
    except BaseException:
        try:
            os.unlink(tmp)       # no orphaned tmp per failed attempt
        except OSError:
            pass
        raise
