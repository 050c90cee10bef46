"""``pca`` + ``check`` jobs on a sharded operator: the ``decomp`` jobs
and their judgement (kinds/decomp.py), each job's record adding its
operator's shard count (``shards``) and the bytes and copies its
products moved between cards (``xcard_bytes``, ``xcard_copies``: the
change of the operator's counters over the job, None where the program
has no such counter).
"""

from __future__ import annotations

from portbench import manifest

COUNTERS = ("xcard_bytes", "xcard_copies")


class Kind(manifest.kind("decomp")):
    def run(self, i: int, rec) -> dict:
        before = self._counters()
        job = super().run(i, rec)
        after = self._counters()
        job["shards"] = self.c.op.stats()["nshards"]
        for k in COUNTERS:
            job[k] = None if after[k] is None else after[k] - before[k]
        return job

    def _counters(self) -> dict:
        stats = self.c.op.stats()
        return {k: stats.get(k) for k in COUNTERS}
