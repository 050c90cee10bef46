"""MB copied between cards a pass over the genotypes: the jobs'
``xcard_bytes`` over their solver passes and check()'s one, None where
the program does not count them."""


def read(run):
    jobs = [j for j in run.jobs if j.get("xcard_bytes") is not None]
    passes = sum(j["n_ops"] + 1 for j in jobs)
    if not passes:
        return None
    return sum(j["xcard_bytes"] for j in jobs) / 1e6 / passes
