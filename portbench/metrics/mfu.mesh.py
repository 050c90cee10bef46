"""The products' least time over the traced window times the shard
count: the whole job's share of its cards' peaks, %."""

from portbench import readings


def read(run):
    shards = readings.mean_of(run, "shards")
    mfu = readings.mfu_pct(run)
    return None if mfu is None or not shards else mfu / shards
